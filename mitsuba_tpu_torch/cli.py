"""Command-line renderer (port of mitsuba_tpu/cli.py; the reference
`mitsuba` CLI's flag set, src/mitsuba/mitsuba.cpp:41-75).

    python -m mitsuba_tpu_torch scene.xml [scene2.xml ...]
        -o <path>      output file (default: scene name + .exr)
        -D key=value   scene parameter substitution ($key in the XML)
        -q             quiet
        -x             skip rendering when the output already exists
        -s <n>         seed
        -d <backend>   intersection backend: auto|brute|bvh
        -f <filter>    reconstruction filter override
        --cpu          render on the CPU (default: the card; without a
                       CUDA device the render raises)
        -j/-p/-c/-b/-r accepted for compatibility, no-ops

Routes, in the reference's order (cli.py:148-170): `volpath` and
`volpath_simple` integrators and a scene-level <medium> render through
`render_volpath`, or with --guided or an integrator's `guiding` through
`render_volpath_guided`; animated shapes under an open shutter (the
loader's "time_scenes") through `render_motion`; --guided or `guiding`
otherwise through `render_guided` (surface path guiding); everything
else through `render` (a subsurface scene fills its irradiance cache
there). Shapes' interior media are routed as the reference routes them:
by the integrator, never to `render_volpath_media`.

Other front ends, as the reference's (cli.py:75-87, :133-141):
--server [--port N] serves renders over TCP (parallel/server.py
`RenderServer`, port 7554 by default), --listen-stdio serves one session
over stdin/stdout (`serve_pipe`, for `RenderClient.over_ssh`), and
--gui [--gui-port N] serves the progressive preview of the first scene
in the browser (gui.py `serve`). Each renders on the card, or on the CPU
under --cpu.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="mitsuba_tpu_torch",
        description="differentiable renderer (PyTorch / CUDA port)")
    ap.add_argument("scenes", nargs="*", help="scene XML file(s)")
    ap.add_argument("--server", action="store_true",
                    help="run as a network render node (mtssrv analogue)")
    ap.add_argument("--port", type=int, default=None,
                    help="server listen port (default 7554)")
    ap.add_argument("--listen-stdio", action="store_true",
                    help="serve one session over stdin/stdout (mtssrv -ls, "
                    "for SSH tunnels)")
    ap.add_argument("--gui", action="store_true",
                    help="interactive progressive preview in the browser "
                    "(mtsgui analogue; an HTTP viewport)")
    ap.add_argument("--guided", action="store_true",
                    help="path-guided rendering (the surfaces' scatter "
                    "directions, or a medium's)")
    ap.add_argument("--gui-port", type=int, default=8555)
    ap.add_argument("--cpu", action="store_true",
                    help="render on the host CPU instead of the card")
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("-D", "--define", action="append", default=[],
                    metavar="KEY=VALUE")
    ap.add_argument("-q", "--quiet", action="store_true")
    ap.add_argument("-x", "--skip-existing", action="store_true")
    ap.add_argument("-s", "--seed", type=int, default=0)
    ap.add_argument("-d", "--backend", default="auto",
                    choices=["auto", "brute", "bvh"])
    ap.add_argument("-f", "--rfilter", default=None)
    ap.add_argument("--spp", type=int, default=None,
                    help="override sampleCount")
    ap.add_argument("--depth", type=int, default=None,
                    help="override maxDepth")
    ap.add_argument("--size", default=None, metavar="WxH")
    # accepted-for-parity no-ops
    ap.add_argument("-p", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("-c", default=None, help=argparse.SUPPRESS)
    ap.add_argument("-b", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("-r", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("-j", type=int, default=1, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    device = "cpu" if args.cpu else "cuda"
    if args.server or args.listen_stdio:
        from mitsuba_tpu_torch.parallel.server import (
            DEFAULT_PORT, RenderServer, serve_pipe,
        )

        if args.listen_stdio:
            serve_pipe(sys.stdin.buffer, sys.stdout.buffer, device=device)
            return 0
        srv = RenderServer(port=args.port or DEFAULT_PORT, device=device)
        if not args.quiet:
            print(f"mitsuba_tpu_torch render node listening on port "
                  f"{srv.port}", flush=True)
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
        return 0
    if not args.scenes:
        ap.error("scene XML file(s) required (or --server)")

    params = {}
    for d in args.define:
        if "=" not in d:
            ap.error(f"-D expects KEY=VALUE, got '{d}'")
        k, v = d.split("=", 1)
        params[k] = v

    import numpy as np

    from mitsuba_tpu_torch.core.spectrum import to_srgb
    from mitsuba_tpu_torch.integrators import PathConfig, render
    from mitsuba_tpu_torch.io import bitmap
    from mitsuba_tpu_torch.io.xml import load_scene
    from mitsuba_tpu_torch.render.sampler import PATTERNS

    rc = 0
    for scene_path in args.scenes:
        out = args.output or os.path.splitext(scene_path)[0] + ".exr"
        if args.skip_existing and os.path.exists(out):
            if not args.quiet:
                print(f"skipping {scene_path} ({out} exists)")
            continue
        t0 = time.time()
        if args.size:
            w, h = (int(x) for x in args.size.lower().split("x"))
            params.setdefault("width", w)
            params.setdefault("height", h)
        scene, cfg = load_scene(scene_path, params=params,
                                backend=args.backend, device=device)
        if args.size:
            scene = dataclasses.replace(scene, width=w, height=h)
        guided = args.guided or cfg.get("guiding")
        max_depth = args.depth or (cfg["maxDepth"] if cfg["maxDepth"] > 0
                                   else 12)
        pcfg = PathConfig(
            max_depth=max_depth,
            rr_depth=cfg.get("rrDepth", 10),
            spp=args.spp or cfg["sampleCount"],
            pattern=cfg["pattern"] if cfg["pattern"] in PATTERNS
            else "independent",
            remat=False,
            rfilter=args.rfilter or cfg.get("rfilter", "box"),
        )
        if args.gui:
            from mitsuba_tpu_torch.gui import serve

            httpd, session, thread = serve(scene, pcfg, port=args.gui_port)
            try:
                httpd.serve_forever()
            except KeyboardInterrupt:
                pass
            finally:
                session.stop = True
                httpd.server_close()
                thread.join(timeout=60)
            return 0
        if not args.quiet:
            print(
                f"rendering {scene_path}: {scene.width}x{scene.height} "
                f"spp={pcfg.spp} depth={pcfg.max_depth} "
                f"integrator={cfg['integrator']} filter={pcfg.rfilter} "
                f"backend={scene.geom.backend} device={scene.device}"
            )
        if cfg["integrator"] in ("volpath", "volpath_simple") \
                or "medium" in cfg:
            from mitsuba_tpu_torch.integrators.volpath import (
                render_volpath, render_volpath_guided,
            )
            from mitsuba_tpu_torch.media import no_medium

            vol_render = render_volpath_guided if guided else render_volpath
            img, aux = vol_render(
                scene, cfg.get("medium", no_medium()), pcfg, seed=args.seed,
                mis=cfg["integrator"] != "volpath_simple",
            )
        elif "time_scenes" in cfg:
            from mitsuba_tpu_torch.integrators.path import render_motion

            img, aux = render_motion(cfg["time_scenes"], pcfg,
                                     seed=args.seed)
        elif guided:
            from mitsuba_tpu_torch.integrators.path import render_guided

            img, aux = render_guided(scene, pcfg, seed=args.seed)
        else:
            img, aux = render(scene, pcfg, seed=args.seed)
        img = img.detach().cpu().numpy()
        ext = os.path.splitext(out)[1].lower()
        if ext == ".exr":
            bitmap.write_exr(out, img)
        elif ext == ".pfm":
            bitmap.write_pfm(out, img)
        elif ext == ".m":
            bitmap.write_mfilm(out, img)
        else:
            gamma = cfg.get("gamma", -1.0)
            if gamma == -1.0:
                ldr = to_srgb(img)
            else:
                ldr = np.clip(img, 0, 1) ** (1.0 / max(gamma, 1e-3))
            bitmap.write_image(out, (ldr * 255 + 0.5).astype(np.uint8))
        if not args.quiet:
            print(
                f"  wrote {out} ({time.time() - t0:.1f}s, "
                f"mean={img.mean():.4f}, avg path length "
                f"{float(aux['avg_path_length']):.2f})"
            )
    return rc


if __name__ == "__main__":
    sys.exit(main())
