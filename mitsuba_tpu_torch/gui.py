"""Interactive progressive preview over HTTP (port of mitsuba_tpu/gui.py;
the reference's mtsgui, src/qtgui + libhw, a Qt viewport fed by
PreviewThread: VPL passes while the camera moves, then the integrator
accumulates, qtgui/preview.h:40).

With no display server the viewport is a browser page served by a
standard-library HTTP server:

  * a render thread accumulates progressive passes of the real
    integrator into a FilmCheckpoint on the scene's device (the card
    unless the scene lives on the CPU), after a one-frame VPL pass for
    instant feedback, the reference's warm start and refinement;
  * the page polls /frame.png (the latest accumulation, tonemapped, PNG
    by io/bitmap.py `write_png`) and /state (pass count, spp,
    generation);
  * dragging orbits the camera and the wheel dollies:
    /camera?yaw=&pitch=&dolly= rebuilds the camera's transform and
    restarts the accumulation, as PreviewThread restarts.

Run: python -m mitsuba_tpu_torch scene.xml --gui [--gui-port 8555]
"""
from __future__ import annotations

import dataclasses
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

_PAGE = """<!DOCTYPE html>
<html><head><title>mitsuba_tpu_torch preview</title><style>
body{background:#181818;color:#ccc;font:13px monospace;margin:14px}
#c{border:1px solid #444;image-rendering:pixelated;cursor:grab}
</style></head><body>
<div id="s">connecting...</div>
<canvas id="c"></canvas>
<script>
const c=document.getElementById('c'),s=document.getElementById('s');
let gen=0,drag=null;
async function state(){return (await fetch('/state')).json()}
async function loop(){
  try{
    const st=await state();
    c.width=st.width;c.height=st.height;
    s.textContent=`pass ${st.pass}  ${st.spp} spp  gen ${st.gen}`;
    const img=new Image();
    img.onload=()=>c.getContext('2d').drawImage(img,0,0);
    img.src='/frame.png?g='+st.gen+'_'+st.pass;
  }catch(e){s.textContent='disconnected'}
  setTimeout(loop,500)}
loop();
c.onmousedown=e=>{drag=[e.clientX,e.clientY]};
window.onmouseup=()=>{drag=null};
window.onmousemove=e=>{if(!drag)return;
  const dx=e.clientX-drag[0],dy=e.clientY-drag[1];drag=[e.clientX,e.clientY];
  fetch(`/camera?yaw=${dx*0.01}&pitch=${dy*0.01}`)};
c.onwheel=e=>{e.preventDefault();
  fetch(`/camera?dolly=${e.deltaY>0?1.1:0.9}`)};
</script></body></html>"""


class PreviewSession:
    """The render loop and the camera state the HTTP handlers share."""

    def __init__(self, scene, cfg, exposure_ev: float = 0.0,
                 vpl_first: bool = True):
        self.scene = scene
        self.cfg = cfg
        self.exposure = exposure_ev
        self.vpl_first = vpl_first
        self.lock = threading.Lock()
        self.png = b""
        self.pass_i = 0
        self.spp_total = 0
        self.gen = 0            # bumped on a camera change: restart
        self.stop = False
        # the orbit's state, from the camera's to_world
        m = scene.camera.to_world.detach().cpu().numpy()
        self.origin = m[:3, 3].copy()
        fwd = m[:3, :3] @ np.array([0.0, 0.0, 1.0])
        v0 = scene.geom.v0.detach().cpu().numpy()
        extent = float(np.linalg.norm(v0.max(0) - v0.min(0)))
        self.target = self.origin + fwd * max(extent * 0.5, 1e-3)
        self.up = np.array([0.0, 1.0, 0.0])

    # --- camera ------------------------------------------------------------
    def orbit(self, yaw: float = 0.0, pitch: float = 0.0,
              dolly: float = 1.0) -> None:
        from mitsuba_tpu_torch.core import transform as tf

        with self.lock:
            r = self.origin - self.target
            cy, sy = np.cos(yaw), np.sin(yaw)
            r = np.array([cy * r[0] + sy * r[2], r[1],
                          -sy * r[0] + cy * r[2]])
            # pitch about the camera's right axis
            right = np.cross(self.up, -r)
            rn = np.linalg.norm(right)
            if rn > 1e-9:
                right /= rn
                cp, sp = np.cos(pitch), np.sin(pitch)
                r = (r * cp + np.cross(right, r) * sp
                     + right * np.dot(right, r) * (1 - cp))
            self.origin = self.target + r * dolly
            cam = self.scene.camera
            new_to_world = tf.look_at(self.origin.tolist(),
                                      self.target.tolist(),
                                      self.up.tolist())
            self.scene = dataclasses.replace(
                self.scene, camera=dataclasses.replace(
                    cam, to_world=torch.as_tensor(
                        new_to_world, dtype=torch.float32,
                        device=cam.to_world.device)))
            self.gen += 1

    # --- render loop -------------------------------------------------------
    def _encode(self, img) -> bytes:
        from mitsuba_tpu_torch.io.bitmap import write_png
        from mitsuba_tpu_torch.utils.tonemap import tonemap

        arr = tonemap(img, exposure_ev=self.exposure)
        buf = io.BytesIO()
        write_png(buf, arr)
        return buf.getvalue()

    def run(self, max_passes: int = 10 ** 9) -> None:
        from mitsuba_tpu_torch.integrators.path import render
        from mitsuba_tpu_torch.render.preview import vpl_preview
        from mitsuba_tpu_torch.utils.checkpoint import FilmCheckpoint

        while not self.stop:
            with self.lock:
                gen = self.gen
                scene = self.scene
            fc = FilmCheckpoint(scene.height, scene.width)
            if self.vpl_first:
                try:
                    img = vpl_preview(scene)
                    with self.lock:
                        if self.gen == gen:
                            self.png = self._encode(img)
                            self.pass_i = 0
                except Exception:
                    pass        # the VPL warm start is best effort
            i = 0
            while not self.stop and i < max_passes:
                with self.lock:
                    if self.gen != gen:
                        break   # the camera moved: restart
                img, _ = render(scene, self.cfg, seed=7919 * gen + i)
                fc.add_pass(img, self.cfg.spp)
                png = self._encode(fc.image)
                with self.lock:
                    if self.gen != gen:
                        break
                    self.png = png
                    self.pass_i = i + 1
                    self.spp_total = fc.count
                i += 1
            else:
                # the pass budget is spent: idle until a camera change
                while not self.stop:
                    with self.lock:
                        if self.gen != gen:
                            break
                    time.sleep(0.05)


def serve(scene, cfg, port: int = 8555, max_passes: int = 10 ** 9,
          open_msg: bool = True):
    """Start the preview on 127.0.0.1:port (0: any free port) and its
    render thread; returns (httpd, session, thread), for callers (and
    tests) to drive and shut down: set session.stop, then
    httpd.shutdown() and join the thread."""
    session = PreviewSession(scene, cfg)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):           # quiet
            pass

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            u = urlparse(self.path)
            if u.path == "/":
                self._send(200, "text/html", _PAGE.encode())
            elif u.path == "/state":
                with session.lock:
                    st = dict(width=session.scene.width,
                              height=session.scene.height,
                              gen=session.gen, spp=session.spp_total)
                    st["pass"] = session.pass_i
                self._send(200, "application/json",
                           json.dumps(st).encode())
            elif u.path == "/frame.png":
                with session.lock:
                    png = session.png
                if not png:
                    self._send(503, "text/plain", b"no frame yet")
                else:
                    self._send(200, "image/png", png)
            elif u.path == "/camera":
                q = {k: float(v[0])
                     for k, v in parse_qs(u.query).items()}
                session.orbit(q.get("yaw", 0.0), q.get("pitch", 0.0),
                              q.get("dolly", 1.0))
                self._send(200, "application/json", b"{}")
            else:
                self._send(404, "text/plain", b"not found")

    httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    t = threading.Thread(target=session.run, args=(max_passes,),
                         daemon=True)
    t.start()
    if open_msg:
        print(f"preview at http://127.0.0.1:{httpd.server_address[1]}/",
              flush=True)
    return httpd, session, t
