"""Network render service (port of mitsuba_tpu/parallel/server.py; the
reference's `mtssrv`, src/mitsuba/mtssrv.cpp:90, and its TCP accept loop
:282-318).

A long-lived node that renders whole scenes on request, on its device
(the card unless it was made with device="cpu"):

    client --(scene XML + settings)--> server (render) --(image)--> client

The wire protocol is the JAX package's, byte for byte, so a client of
either package talks to a server of the other: an 8-byte handshake
(magic b"MTPU", then the protocol version as a little-endian uint32; a
mismatched version is answered with the server's and the connection
dropped, as the reference's handshake refuses it), then messages of a
length-prefixed JSON header (uint32 length) and a length-prefixed payload
(uint64). A rendered image travels as `np.save` bytes of float32.

The server's warm state is what the process has built: the kernels' CUDA
libraries, compiled and loaded once a process (ops/build.py's cache under
`_build/`), and the render glue's first-call costs. The reference's
`-ls` stdin mode (SSH tunnels) is `serve_pipe`, the same framing over any
pair of file objects.
"""
from __future__ import annotations

import io
import json
import socket
import socketserver
import struct
import threading

import numpy as np

# the reference's default port (include/mitsuba/mitsuba.h:44)
DEFAULT_PORT = 7554
MAGIC = b"MTPU"
PROTOCOL_VERSION = 1


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------

def _write_msg(wfile, header: dict, payload: bytes = b"") -> None:
    hb = json.dumps(header).encode()
    wfile.write(struct.pack("<I", len(hb)) + hb)
    wfile.write(struct.pack("<Q", len(payload)) + payload)
    wfile.flush()


def _read_exact(rfile, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = rfile.read(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        buf += chunk
    return buf


def _read_msg(rfile):
    (hlen,) = struct.unpack("<I", _read_exact(rfile, 4))
    header = json.loads(_read_exact(rfile, hlen))
    (plen,) = struct.unpack("<Q", _read_exact(rfile, 8))
    payload = _read_exact(rfile, plen) if plen else b""
    return header, payload


def _handshake_server(rfile, wfile) -> None:
    got = _read_exact(rfile, 8)
    magic, ver = got[:4], struct.unpack("<I", got[4:])[0]
    if magic != MAGIC:
        raise ConnectionError(f"bad magic {magic!r}")
    # answer with this version, then refuse a mismatch
    wfile.write(MAGIC + struct.pack("<I", PROTOCOL_VERSION))
    wfile.flush()
    if ver != PROTOCOL_VERSION:
        raise ConnectionError(f"protocol version mismatch: {ver}")


def _handshake_client(rfile, wfile) -> None:
    wfile.write(MAGIC + struct.pack("<I", PROTOCOL_VERSION))
    wfile.flush()
    got = _read_exact(rfile, 8)
    if got[:4] != MAGIC:
        raise ConnectionError(f"bad magic from server: {got[:4]!r}")
    ver = struct.unpack("<I", got[4:])[0]
    if ver != PROTOCOL_VERSION:
        raise ConnectionError(f"server protocol version {ver}, "
                              f"client {PROTOCOL_VERSION}")


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

def _render_request(header: dict, payload: bytes, device) -> np.ndarray:
    """Load the scene of the XML bytes on `device` and render it with the
    request's overrides, routed as the reference's server routes it:
    `volpath`, `volpath_simple` or a scene-level <medium> through
    `render_volpath`, everything else through `render`."""
    from mitsuba_tpu_torch.integrators.path import PathConfig, render
    from mitsuba_tpu_torch.io.xml import load_scene_string

    defines = header.get("defines", {})
    scene, cfg = load_scene_string(payload.decode(), params=defines,
                                   base_dir=header.get("base_dir", "."),
                                   device=device)
    depth = int(header.get("depth") or
                (cfg["maxDepth"] if cfg["maxDepth"] > 0 else 12))
    spp = int(header.get("spp") or cfg["sampleCount"])
    seed = int(header.get("seed", 0))
    pcfg = PathConfig(max_depth=depth, spp=spp, remat=False)
    if cfg["integrator"] in ("volpath", "volpath_simple") or "medium" in cfg:
        from mitsuba_tpu_torch.integrators.volpath import render_volpath
        from mitsuba_tpu_torch.media import no_medium

        img, _ = render_volpath(
            scene, cfg.get("medium", no_medium()), pcfg, seed=seed,
            mis=cfg["integrator"] != "volpath_simple",
        )
    else:
        img, _ = render(scene, pcfg, seed=seed)
    return img.detach().cpu().numpy().astype(np.float32)


def _ping(device) -> dict:
    import torch

    on_card = torch.device(device).type == "cuda"
    return {"status": "ok",
            "devices": torch.cuda.device_count() if on_card else 1,
            "backend": "cuda" if on_card else "cpu"}


def _serve_connection(rfile, wfile, device) -> None:
    """One session: handshake, then a command loop until quit or EOF."""
    _handshake_server(rfile, wfile)
    while True:
        try:
            header, payload = _read_msg(rfile)
        except ConnectionError:
            return
        cmd = header.get("cmd")
        if cmd == "ping":
            _write_msg(wfile, _ping(device))
        elif cmd == "render":
            try:
                img = _render_request(header, payload, device)
                buf = io.BytesIO()
                np.save(buf, img)
                _write_msg(wfile, {"status": "ok", "shape": list(img.shape)},
                           buf.getvalue())
            except Exception as e:  # a bad request: report, keep serving
                _write_msg(wfile, {"status": "error", "message": str(e)})
        elif cmd == "quit":
            _write_msg(wfile, {"status": "ok"})
            return
        else:
            _write_msg(wfile, {"status": "error",
                               "message": f"unknown command {cmd!r}"})


class RenderServer:
    """Threaded TCP render service (the mtssrv analogue), rendering on
    `device` (the card by default).

    >>> srv = RenderServer(port=0, device="cpu"); srv.start()
    >>> ... RenderClient("localhost", srv.port) ...
    >>> srv.stop()
    """

    def __init__(self, host: str = "0.0.0.0", port: int = DEFAULT_PORT,
                 device="cuda"):
        from mitsuba_tpu_torch.render.scene import check_device

        check_device(device)

        class _Handler(socketserver.StreamRequestHandler):
            def handle(self):
                try:
                    _serve_connection(self.rfile, self.wfile, device)
                except (ConnectionError, OSError):
                    pass

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self.device = device
        self._srv = _Server((host, port), _Handler)
        self.port = self._srv.server_address[1]
        self._thread = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._srv.serve_forever, daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def serve_forever(self) -> None:
        self._srv.serve_forever()


def serve_pipe(rfile, wfile, device="cuda") -> None:
    """Serve one session over any pair of streams: the reference's
    `mtssrv -ls` stdin mode for SSH tunnels (mtssrv.cpp:264-266)."""
    from mitsuba_tpu_torch.render.scene import check_device

    check_device(device)
    _serve_connection(rfile, wfile, device)


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------

class RenderClient:
    """Client of a RenderServer (of either package): submit scene XML,
    receive the HDR image."""

    def __init__(self, host: str = "localhost", port: int = DEFAULT_PORT,
                 timeout: float = 600.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._proc = None
        self._r = self._sock.makefile("rb")
        self._w = self._sock.makefile("wb")
        _handshake_client(self._r, self._w)

    @classmethod
    def over_pipe(cls, rfile, wfile, proc=None) -> "RenderClient":
        """Attach to a server speaking the protocol over any streams (the
        reference's Stream-polymorphic RemoteWorker: files, sockets and
        SSH carry the same protocol, sshstream.cpp, mtssrv -ls)."""
        self = cls.__new__(cls)
        self._sock = None
        self._proc = proc
        self._r = rfile
        self._w = wfile
        _handshake_client(self._r, self._w)
        return self

    @classmethod
    def over_ssh(cls, host: str = "",
                 remote_cmd=("python", "-m", "mitsuba_tpu_torch",
                             "--listen-stdio"),
                 ssh_cmd=None) -> "RenderClient":
        """Spawn `ssh host <remote_cmd>` and speak the protocol over its
        stdio (the reference's SSHStream: batch-mode ssh with the command
        appended). `host` may be user@host; ssh_cmd replaces the
        transport (ssh_cmd=() runs remote_cmd here)."""
        import subprocess

        if ssh_cmd is None:
            ssh_cmd = ("ssh", "-oBatchMode=yes", "-x", host)
        proc = subprocess.Popen(
            tuple(ssh_cmd) + tuple(remote_cmd),
            stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        try:
            return cls.over_pipe(proc.stdout, proc.stdin, proc=proc)
        except BaseException:
            proc.kill()
            proc.wait()
            raise

    def ping(self) -> dict:
        _write_msg(self._w, {"cmd": "ping"})
        header, _ = _read_msg(self._r)
        return header

    def render(self, scene_xml: str, spp: int | None = None,
               depth: int | None = None, seed: int = 0,
               defines: dict | None = None,
               base_dir: str = ".") -> np.ndarray:
        """base_dir: the directory, on the server, that relative mesh and
        texture paths resolve against (a shared or pre-staged file
        system; the reference ships dependent files over its stream)."""
        _write_msg(self._w, {
            "cmd": "render", "spp": spp, "depth": depth, "seed": seed,
            "defines": defines or {}, "base_dir": base_dir,
        }, scene_xml.encode())
        header, payload = _read_msg(self._r)
        if header.get("status") != "ok":
            raise RuntimeError(f"remote render failed: "
                               f"{header.get('message')}")
        return np.load(io.BytesIO(payload))

    def close(self) -> None:
        try:
            _write_msg(self._w, {"cmd": "quit"})
            _read_msg(self._r)
        except (ConnectionError, OSError):
            pass
        if self._sock is not None:
            self._sock.close()
        else:
            self._w.close()
            self._r.close()
        if self._proc is not None:
            self._proc.wait(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
