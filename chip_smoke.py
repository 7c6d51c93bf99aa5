"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path (bench config 1: the Cornell box, 256x256 px,
16 spp, depth 5, through mitsuba_tpu_torch.integrators.path.render) in
phases, each printing one line:

  1. the card's name and power limit (as nvidia-smi reports them);
  2. the build of the intersector kernel from csrc/ (nvcc, sm_90a);
  3. the kernel against its plain PyTorch version on the card, at the
     main path's shape (1,048,576 camera rays and as many shadow rays);
  4. a 64x64 render gated against tests/goldens/bench_cfg1.npz;
  5. config-1 renders: one warm-up, three timed, with the kernel's launch
     count read around them.

Then a JSON line describing each kernel, and as the last line
{"ok": true, "device": {...}}. Any failure raises and the exit code is not
0; without a CUDA device the script exits 2 before doing anything. It
imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
W1, H1, SPP1, DEPTH1 = 256, 256, 16, 5     # bench config 1
# kernel vs plain: share of lanes whose ids must agree, and the tolerances
# of the float outputs on lanes whose prim agrees. The kernel and the plain
# version run the same IEEE float32 operations in the same order (no FMA
# contraction), so they should agree bit for bit; the tolerances leave
# room for nothing more than a last-ulp difference.
ID_AGREE_MIN = 0.9999
RTOL, ATOL_NORMAL = 1e-5, 1e-5
ATOL_NEAR_ZERO = 1e-6          # u, v, uv of rays at an edge are near 0
GOLDEN_REL_RMSE_MAX = 0.10     # bench.py validate_golden, 8x8 blocks
MEAN_BAND = (0.09, 0.21)       # bench.py expect_mean for config 1


def phase(tag, **kv):
    print(json.dumps({"phase": tag, **kv}), flush=True)


def cuda_ms(fn, reps=10):
    """Median of `reps` CUDA-event timings of fn(), after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def camera_lanes(scene, spp, seed=0):
    """The wavefront of render(): lane = pixel * spp + sample."""
    from mitsuba_tpu_torch.render.sampler import Sampler

    w, h = scene.width, scene.height
    lane = torch.arange(w * h * spp, dtype=torch.int32, device=scene.device)
    pixel_id, sample_id = lane // spp, lane % spp
    sampler = Sampler(seed, pixel_id, sample_id)
    off = sampler.next_2d()
    uv = torch.stack([((pixel_id % w).float() + off[:, 0]) / w,
                      ((pixel_id // w).float() + off[:, 1]) / h], dim=-1)
    return scene.camera.sample_ray(uv)


def kernel_inputs(scene):
    """Config-1 camera rays as bounce rays, and shadow rays from their
    first hits toward random points on the light."""
    from mitsuba_tpu_torch.core import math as m
    from mitsuba_tpu_torch.ops import intersect as ip

    ray = camera_lanes(scene, SPP1)
    n = ray.o.shape[0]
    table = ip.make_shading_table(scene.geom)
    mint, maxt = ray.mint.contiguous(), ray.maxt.contiguous()
    rec, _ = ip.closest_hit_shaded_and_any_ref(
        table, ray.o, ray.d, mint, maxt, ray.o, ray.d, mint,
        torch.full_like(maxt, -1.0))
    origin = torch.where(rec["valid"][:, None],
                         ray.at(torch.where(rec["valid"], rec["t"], 0.0)),
                         ray.o)
    light = int(scene.emitters.rec_prim[0])
    gen = torch.Generator(device=scene.device).manual_seed(0)
    u = torch.rand((n, 2), generator=gen, device=scene.device)
    su = torch.sqrt(1.0 - u[:, 0])
    g = scene.geom
    target = g.v0[light] + g.e1[light] * (1.0 - su)[:, None] \
        + g.e2[light] * (su * u[:, 1])[:, None]
    to_l = target - origin
    dist = torch.sqrt(m.dot(to_l, to_l))
    eps = m.EPSILON * torch.clamp(origin.abs().amax(dim=-1), min=1.0)
    return (table, ray.o.contiguous(), ray.d.contiguous(), mint, maxt,
            origin.contiguous(), (to_l / dist[:, None]).contiguous(),
            eps.contiguous(), (dist * (1.0 - 1e-3)).contiguous())


def compare_kernel(scene):
    from mitsuba_tpu_torch.ops import intersect as ip

    args = kernel_inputs(scene)
    rec_k, occ_k = ip.closest_hit_shaded_and_any(*args)
    rec_p, occ_p = ip.closest_hit_shaded_and_any_ref(*args)
    torch.cuda.synchronize()
    n = occ_k.shape[0]
    mism = {k: int((rec_k[k] != rec_p[k]).sum())
            for k in ("prim", "material_id", "emitter_id", "shape_id")}
    mism["occ"] = int((occ_k != occ_p).sum())
    same = rec_k["prim"] == rec_p["prim"]
    bad, max_err = {}, 0.0
    for k in ("t", "u", "v", "uv", "geo_n", "sh_n"):
        a, b = rec_k[k][same], rec_p[k][same]
        if k in ("geo_n", "sh_n"):
            ok = (a - b).abs() <= ATOL_NORMAL
        else:
            ok = torch.isclose(a, b, rtol=RTOL, atol=ATOL_NEAR_ZERO)
        bad[k] = int((~ok).sum())
        fin = torch.isfinite(b)
        if bool(fin.any()):
            max_err = max(max_err, float((a - b)[fin].abs().max()))
    ms = cuda_ms(lambda: ip.closest_hit_shaded_and_any(*args))
    plain_ms = cuda_ms(lambda: ip.closest_hit_shaded_and_any_ref(*args))
    phase("kernel_vs_plain", lanes=n, id_mismatches=mism,
          float_mismatches=bad, max_abs_err=max_err, ms=ms,
          plain_ms=plain_ms, hit_lanes=int(rec_p["valid"].sum()),
          occluded_lanes=int(occ_p.sum()))
    for k, c in mism.items():
        if c > (1.0 - ID_AGREE_MIN) * n:
            raise AssertionError(f"kernel vs plain: {c} lanes differ in {k}")
    for k, c in bad.items():
        if c:
            raise AssertionError(f"kernel vs plain: {c} lanes differ in {k}")
    return max_err, ms, plain_ms


def golden_gate(device):
    from mitsuba_tpu_torch.integrators.path import PathConfig, render
    from mitsuba_tpu_torch.render.scene import cornell_box

    ref = np.load(os.path.join(ROOT, "tests", "goldens",
                               "bench_cfg1.npz"))["mean"]
    img, _ = render(cornell_box(64, 64, device=device),
                    PathConfig(max_depth=5, spp=16), seed=0)
    img = img.cpu().numpy()

    def blocks(a, b=8):
        h, w, c = a.shape
        return a.reshape(h // b, b, w // b, b, c).mean(axis=(1, 3))

    rb, ib = blocks(ref), blocks(img)
    rel = float(np.sqrt(np.mean((ib - rb) ** 2)) / max(rb.mean(), 1e-9))
    phase("golden_64", rel_rmse=rel, limit=GOLDEN_REL_RMSE_MAX,
          mean=float(img.mean()), golden_mean=float(ref.mean()))
    if not rel <= GOLDEN_REL_RMSE_MAX:
        raise AssertionError(f"golden gate: rel RMSE {rel} > "
                             f"{GOLDEN_REL_RMSE_MAX}")


def config1(device):
    from mitsuba_tpu_torch.integrators.path import PathConfig, render
    from mitsuba_tpu_torch.ops import intersect as ip
    from mitsuba_tpu_torch.render.scene import cornell_box

    scene = cornell_box(W1, H1, device=device)
    cfg = PathConfig(max_depth=DEPTH1, spp=SPP1)
    render(scene, cfg, seed=0)                  # warm-up
    torch.cuda.synchronize()
    ip.LAUNCHES = 0
    secs, rays = [], []
    for seed in range(3):
        t0 = time.perf_counter()
        img, aux = render(scene, cfg, seed=seed)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        rays.append(int(aux["rays_traced"]))
    launches = ip.LAUNCHES
    mean = float(img.mean())
    phase("config1", width=W1, height=H1, spp=SPP1, depth=DEPTH1,
          seconds=secs, rays_traced=rays,
          mrays_per_s=[r / s / 1e6 for r, s in zip(rays, secs)],
          launches=launches, mean=mean)
    if launches != 3 * DEPTH1:
        raise AssertionError(f"{launches} kernel launches for 3 renders, "
                             f"expected {3 * DEPTH1}")
    if tuple(img.shape) != (H1, W1, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError("config-1 image is not finite or misshapen")
    if not MEAN_BAND[0] <= mean <= MEAN_BAND[1]:
        raise AssertionError(f"config-1 mean {mean} outside {MEAN_BAND}")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from mitsuba_tpu_torch.ops import intersect as ip
    from mitsuba_tpu_torch.render.scene import cornell_box

    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    phase("device", name=name, count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    log = ip.build()
    phase("build", seconds=time.perf_counter() - t0,
          ptxas=[ln.strip() for ln in log.splitlines() if "ptxas" in ln])

    max_err, ms, plain_ms = compare_kernel(
        cornell_box(W1, H1, device=device))
    golden_gate(device)
    launches = config1(device)

    print(json.dumps({"kernels": [{
        "name": "shaded_any",
        "route": "cuda",
        "source": "mitsuba_tpu_torch/csrc/intersect_brute.cu",
        "replaces": "mitsuba_tpu/ops/intersect_pallas.py:337",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
