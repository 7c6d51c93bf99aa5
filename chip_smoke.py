"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two main paths through
mitsuba_tpu_torch.integrators.path.render: bench config 1 (the Cornell
box, 256x256 px, 16 spp, depth 5, brute backend) and bench config 3 (the
101,762-triangle textured mesh under a sky, 512x512 px, 4 spp, depth 5,
cluster backend). Phases, each printing one JSON line:

  1. the card's name and power limit (as nvidia-smi reports them);
  2. the build of every kernel from csrc/ (one nvcc per source, all at
     once, sm_90a), with the compiler's ptxas lines;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes of its path: the brute kernel on 1,048,576 config-1 camera
     rays; the refine (S1), child-refine (S2, S3) and item kernels on the
     config-3 camera wavefront (coherent caps) and on a first diffuse
     bounce wavefront with its shadow rays (diffuse caps); the stream
     kernel on the bounce and shadow rows;
  4. 64x64 renders gated (8x8-block relative RMSE <= 0.10, as bench.py)
     against tests/goldens/bench_cfg1.npz and, for config 3, against
     tests/torch_goldens/bench_cfg3_sphere.npz: the committed
     tests/goldens/bench_cfg3.npz was rendered with the bunny mesh,
     which is absent, so both packages render its sphere fallback; the
     distance to the bunny golden is reported beside;
  5. config-1 renders and 6. config-3 renders: one warm-up, then timed
     renders with every launch count set to 0 just before and read just
     after.

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
W3, H3, SPP3, DEPTH3 = 512, 512, 4, 5      # bench config 3
TIMED1, TIMED3 = 3, 3                      # timed renders per config
# kernel vs plain: share of lanes whose ids must agree, and the tolerances
# of the float outputs on lanes whose ids agree. Each kernel and its plain
# version run the same IEEE float32 operations in the same order (no FMA
# contraction), so they should agree bit for bit; the tolerances leave
# room for nothing more than a last-ulp difference.
ID_AGREE_MIN = 0.9999
RTOL, ATOL_NORMAL = 1e-5, 1e-5
ATOL_NEAR_ZERO = 1e-6          # u, v, uv of rays at an edge are near 0
GOLDEN_REL_RMSE_MAX = 0.10     # bench.py validate_golden, 8x8 blocks
MEAN_BAND = {1: (0.09, 0.21), 3: (0.17, 0.41)}   # bench.py expect_mean
# a plain version slower than this on the full wavefront is compared and
# timed on its first PLAIN_CUT_ROWS rows instead (the phase says so)
PLAIN_FULL_MAX_S = 1.0
PLAIN_CUT_ROWS = 1024


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


def launch_counts():
    from mitsuba_tpu_torch.ops import exact as ep
    from mitsuba_tpu_torch.ops import intersect as ip
    from mitsuba_tpu_torch.ops import stream as sp

    return dict(shaded_any=ip.LAUNCHES, **ep.LAUNCHES, stream=sp.LAUNCHES)


def reset_launch_counts():
    from mitsuba_tpu_torch.ops import exact as ep
    from mitsuba_tpu_torch.ops import intersect as ip
    from mitsuba_tpu_torch.ops import stream as sp

    ip.LAUNCHES = 0
    sp.LAUNCHES = 0
    for k in ep.LAUNCHES:
        ep.LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# config 1: the brute kernel
# ---------------------------------------------------------------------------

def camera_lanes(scene, spp, seed=0):
    """The wavefront of render(): lane = pixel * spp + sample."""
    from mitsuba_tpu_torch.integrators.path import PathConfig, \
        camera_wavefront

    return camera_wavefront(scene, PathConfig(spp=spp), seed)[0]


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
    phase("kernel_vs_plain", kernel="shaded_any", lanes=n,
          id_mismatches=mism, float_mismatches=bad, max_abs_err=max_err,
          ms=ms, plain_ms=plain_ms, hit_lanes=int(rec_p["valid"].sum()),
          occluded_lanes=int(occ_p.sum()))
    for k, c in mism.items():
        if c > (1.0 - ID_AGREE_MIN) * n:
            raise AssertionError(f"kernel vs plain: {c} lanes differ in {k}")
    for k, c in bad.items():
        if c:
            raise AssertionError(f"kernel vs plain: {c} lanes differ in {k}")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms)


# ---------------------------------------------------------------------------
# config 3: the exact-cull kernels and the stream kernel
# ---------------------------------------------------------------------------

def cfg3_wavefronts(scene):
    """The config-3 camera wavefront (pixel-Morton lanes), a first diffuse
    bounce from its hits (cosine directions around the shading normal)
    and that bounce's shadow rays toward sampled sky directions, both
    sorted as path_trace sorts them."""
    from mitsuba_tpu_torch.core import math as m
    from mitsuba_tpu_torch.core import warp
    from mitsuba_tpu_torch.emitters import sample_direct
    from mitsuba_tpu_torch.integrators.path import (
        PathConfig, _bounce_order, _perm_ray, camera_wavefront,
    )
    from mitsuba_tpu_torch.render.intersect import ray_intersect
    from mitsuba_tpu_torch.render.records import Ray

    cam = camera_wavefront(scene, PathConfig(spp=SPP3), seed=0)[0]
    its = ray_intersect(scene.geom, cam, coherent=True)
    n = cam.o.shape[0]
    gen = torch.Generator(device=scene.device).manual_seed(0)
    u = torch.rand((n, 5), generator=gen, device=scene.device)
    wo = its.to_world(warp.square_to_cosine_hemisphere(u[:, 0:2]))
    eps = m.EPSILON * torch.clamp(its.p.abs().amax(dim=-1), min=1.0)
    ok = its.valid[:, None]
    bounce = Ray(o=torch.where(ok, its.p, cam.o),
                 d=torch.where(ok, wo, cam.d), mint=eps,
                 maxt=torch.where(its.valid, float("inf"), -1.0))
    ds = sample_direct(scene.emitters, scene.geom, its.p, u[:, 2], u[:, 3:5])
    shadow = Ray(o=its.p, d=ds.d, mint=eps,
                 maxt=torch.where(its.valid & ds.valid,
                                  ds.dist * (1.0 - 1e-3), -1.0))
    return (cam,
            _perm_ray(bounce, _bounce_order(scene.geom, bounce)),
            _perm_ray(shadow, _bounce_order(scene.geom, shadow)))


def query_rows(geom, ray):
    """The live 128-lane rows an exact query builds for `ray`."""
    from mitsuba_tpu_torch.ops.rows import pack_rays
    from mitsuba_tpu_torch.render.intersect import _cap_root_exit

    ray = _cap_root_exit(geom, ray)
    rays = pack_rays(ray.o, ray.d, ray.mint,
                     torch.clamp(ray.maxt, max=1e30))[0]
    return rays[(rays[:, 7] >= rays[:, 6]).any(dim=1)].contiguous()


def record_build(rays, ex, caps):
    """Run the exact build once, recording the arguments of each refine
    (S1) and child-refine (S2, S3) call."""
    from mitsuba_tpu_torch.ops import exact as ep

    calls = []
    orig = {k: getattr(ep, k) for k in ("refine", "child_refine")}

    def recorder(name):
        def call(*args):
            calls.append(args)
            return orig[name](*args)
        return call

    try:
        ep.refine = recorder("refine")
        ep.child_refine = recorder("child_refine")
        ids, blk_tn, _ovf = ep.build_exact_items(rays, ex, caps)
    finally:
        ep.refine, ep.child_refine = orig["refine"], orig["child_refine"]
    return calls, ids, blk_tn


def _cut(args, row_args, rows):
    return tuple(a[:rows].contiguous() if i in row_args else a
                 for i, a in enumerate(args))


def check_pair(name, stage, kern, plain, args, row_args, out_kind):
    """Hold kernel against plain version on args; time both. out_kind:
    'keys' (one float tensor), 'hit' ((t, u, v, prim)) or 'occ'."""
    n_rows = args[row_args[0]].shape[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = plain(*args)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    rows = n_rows
    if plain_s > PLAIN_FULL_MAX_S and n_rows > PLAIN_CUT_ROWS:
        rows = PLAIN_CUT_ROWS
        args = _cut(args, row_args, rows)
        ref = plain(*args)
    got = kern(*args)
    torch.cuda.synchronize()
    id_mism, float_mism, max_err, n = 0, 0, 0.0, 0
    if out_kind == "keys":
        n = ref.numel()
        ok = torch.isclose(got, ref, rtol=RTOL, atol=ATOL_NEAR_ZERO)
        float_mism = int((~ok).sum())
        fin = ref < 1e30
        if bool(fin.any()):
            max_err = float((got - ref)[fin].abs().max())
    elif out_kind == "occ":
        n = ref.numel()
        id_mism = int((got != ref).sum())
    else:
        n = ref[3].numel()
        id_mism = int((got[3] != ref[3]).sum())
        same = got[3] == ref[3]
        for a, b in zip(got[:3], ref[:3]):
            a, b = a[same], b[same]
            float_mism += int((~torch.isclose(
                a, b, rtol=RTOL, atol=ATOL_NEAR_ZERO)).sum())
            if a.numel():
                max_err = max(max_err, float((a - b).abs().max()))
    ms = cuda_ms(lambda: kern(*args))
    plain_ms = cuda_ms(lambda: plain(*args))
    res = dict(kernel=name, stage=stage, rows=rows, rows_of=n_rows,
               values=n, id_mismatches=id_mism,
               float_mismatches=float_mism, max_abs_err=max_err, ms=ms,
               plain_ms=plain_ms)
    phase("kernel_vs_plain", **res)
    if id_mism > (1.0 - ID_AGREE_MIN) * n:
        raise AssertionError(f"{name} ({stage}): {id_mism} ids differ")
    if float_mism:
        raise AssertionError(f"{name} ({stage}): {float_mism} floats differ")
    return res


def compare_cluster_kernels(scene):
    from mitsuba_tpu_torch.ops import exact as ep
    from mitsuba_tpu_torch.ops import stream as sp

    geom = scene.geom
    ex = geom.ex_tables
    dif, coh, _xl = geom.ex_caps
    cam, bounce, shadow = cfg3_wavefronts(scene)
    out = {}
    for wave, ray, caps in (("camera", cam, coh), ("bounce", bounce, dif)):
        rays = query_rows(geom, ray)
        calls, ids, blk_tn = record_build(rays, ex, caps)
        for stage, args in zip(("S1", "S2", "S3"), calls):
            if len(args) == 5:
                r = check_pair("refine", f"{wave} S1", ep.refine,
                               ep.refine_ref, args, (0, 1, 2), "keys")
            else:
                r = check_pair("child_refine", f"{wave} {stage}",
                               ep.child_refine, ep.child_refine_ref, args,
                               (0, 1, 2), "keys")
            out[(r["kernel"], wave, stage)] = r
        r = check_pair("items", f"{wave} closest", ep.items, ep.items_ref,
                       (ex["tri"], rays, ids, blk_tn, False), (1, 2, 3),
                       "hit")
        out[("items", wave, "closest")] = r
    rays = query_rows(geom, shadow)
    _calls, ids, blk_tn = record_build(rays, ex, dif)
    out[("items", "shadow", "any")] = check_pair(
        "items", "shadow any", ep.items, ep.items_ref,
        (ex["tri"], rays, ids, blk_tn, True), (1, 2, 3), "occ")
    st = geom.st_tables
    for wave, ray, any_hit in (("bounce", bounce, False),
                               ("shadow", shadow, True)):
        rays = query_rows(geom, ray)
        lids, ltns = sp.build_sc_lists(rays, st["sc_bmin"], st["sc_bmax"])
        out[("stream", wave, any_hit)] = check_pair(
            "stream", f"{wave} {'any' if any_hit else 'closest'}",
            sp.stream_rows, sp.stream_rows_ref,
            (rays, lids, ltns, st["sc_tri"], any_hit), (0, 1, 2),
            "occ" if any_hit else "hit")
    return out


# ---------------------------------------------------------------------------
# renders
# ---------------------------------------------------------------------------

def golden_gate(tag, scene, golden, also=None):
    """64x64, 16 spp, depth 5, seed 0 (bench.py validate_golden), gated
    on `golden` (a path under the repo); `also` is a second golden whose
    distance is reported, not gated."""
    from mitsuba_tpu_torch.integrators.path import PathConfig, render

    img, _ = render(scene, PathConfig(max_depth=5, spp=16), seed=0)
    img = img.cpu().numpy()

    def blocks(a, b=8):
        h, w, c = a.shape
        return a.reshape(h // b, b, w // b, b, c).mean(axis=(1, 3))

    def rel_rmse(path):
        ref = np.load(os.path.join(ROOT, path))["mean"]
        rb, ib = blocks(ref), blocks(img)
        return (float(np.sqrt(np.mean((ib - rb) ** 2))
                      / max(rb.mean(), 1e-9)), float(ref.mean()))

    rel, ref_mean = rel_rmse(golden)
    extra = {}
    if also is not None:
        extra = dict(zip(("also_rel_rmse", "also_mean"), rel_rmse(also)),
                     also=also)
    phase(tag, golden=golden, rel_rmse=rel, limit=GOLDEN_REL_RMSE_MAX,
          mean=float(img.mean()), golden_mean=ref_mean,
          finite=bool(np.isfinite(img).all()), **extra)
    if not rel <= GOLDEN_REL_RMSE_MAX or not np.isfinite(img).all():
        raise AssertionError(f"{tag}: rel RMSE {rel} > "
                             f"{GOLDEN_REL_RMSE_MAX}")


def device_profile(fn):
    """Device busy time (ms) of one call of fn under torch.profiler (the
    sum of its CUDA kernels' times), its wall time (ms), and the kernels
    taking the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.key, e.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    return dict(wall_ms=wall, device_busy_ms=busy,
                busy_share=busy / wall if wall else 0.0,
                kernels=sum(r[2] for r in rows),
                top=[dict(name=k[:80], ms=ms, calls=c)
                     for ms, k, c in rows[:12]])


def render_phase(tag, scene, cfg, band, need):
    """One warm-up render, then timed renders with every launch count set
    to 0 just before and read just after; then a profiled render."""
    from mitsuba_tpu_torch.integrators.path import render

    render(scene, cfg, seed=0)                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_timed = TIMED1 if tag == "config1" else TIMED3
    reset_launch_counts()
    secs, rays = [], []
    for seed in range(n_timed):
        t0 = time.perf_counter()
        img, aux = render(scene, cfg, seed=seed)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        rays.append(int(aux["rays_traced"]))
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = device_profile(lambda: render(scene, cfg, seed=0))
    mean = float(img.mean())
    phase(tag, width=scene.width, height=scene.height, spp=cfg.spp,
          depth=cfg.max_depth, seconds=secs, rays_traced=rays,
          mrays_per_s=[r / s / 1e6 for r, s in zip(rays, secs)],
          launches=launches, mean=mean, peak_mem_gib=peak, profile=prof)
    if tuple(img.shape) != (scene.height, scene.width, 3) \
            or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{tag} image is not finite or misshapen")
    if not band[0] < mean < band[1]:
        raise AssertionError(f"{tag} mean {mean} outside {band}")
    for k in need:
        if launches[k] < 1:
            raise AssertionError(f"{tag}: kernel {k} was never launched")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, ROOT)
    from mitsuba_tpu_torch.integrators.path import PathConfig
    from mitsuba_tpu_torch.ops import build as nv
    from mitsuba_tpu_torch.ops import exact as ep
    from mitsuba_tpu_torch.ops import intersect as ip
    from mitsuba_tpu_torch.ops import stream as sp
    from mitsuba_tpu_torch.render.scene import (
        cornell_box, textured_mesh_scene,
    )

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
    sources = [ip.SOURCE, ep.SOURCE, sp.SOURCE]
    logs = nv.build_all(sources)          # one nvcc per source, at once
    for mod in (ip, ep, sp):
        mod.build()                       # bind the built libraries
    phase("build", seconds=time.perf_counter() - t0,
          ptxas={os.path.basename(src): [
              ln.strip() for ln in log.splitlines() if "ptxas" in ln]
              for src, log in logs.items()})

    brute = compare_kernel(cornell_box(W1, H1, device=device))
    scene3 = textured_mesh_scene(W3, H3, device=device)
    cluster = compare_cluster_kernels(scene3)
    golden_gate("golden_64", cornell_box(64, 64, device=device),
                "tests/goldens/bench_cfg1.npz")
    # tests/goldens/bench_cfg3.npz holds the bunny mesh, which is absent;
    # both packages render the sphere that replaces it, whose golden is
    # the JAX package's own CPU render (tests/torch_goldens)
    golden_gate("golden_64_cfg3", textured_mesh_scene(64, 64, device=device),
                "tests/torch_goldens/bench_cfg3_sphere.npz",
                also="tests/goldens/bench_cfg3.npz")
    l1 = render_phase("config1", cornell_box(W1, H1, device=device),
                      PathConfig(max_depth=DEPTH1, spp=SPP1), MEAN_BAND[1],
                      ["shaded_any"])
    l3 = render_phase("config3", scene3,
                      PathConfig(max_depth=DEPTH3, spp=SPP3), MEAN_BAND[3],
                      ["refine", "child_refine", "items"])

    def entry(kname, source, replaces, launches, r):
        return {"name": kname, "route": "cuda",
                "source": f"mitsuba_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"]}

    print(json.dumps({"kernels": [
        entry("shaded_any", "intersect_brute.cu",
              "mitsuba_tpu/ops/intersect_pallas.py:337", l1["shaded_any"],
              brute),
        entry("refine", "exact.cu", "mitsuba_tpu/ops/exact_pallas.py:114",
              l3["refine"], cluster[("refine", "bounce", "S1")]),
        entry("child_refine", "exact.cu",
              "mitsuba_tpu/ops/exact_pallas.py:209", l3["child_refine"],
              cluster[("child_refine", "bounce", "S3")]),
        entry("items", "exact.cu", "mitsuba_tpu/ops/exact_pallas.py:531",
              l3["items"], cluster[("items", "bounce", "closest")]),
        entry("stream", "stream.cu",
              "mitsuba_tpu/ops/stream_pallas.py:176", l3["stream"],
              cluster[("stream", "bounce", False)]),
    ]}), flush=True)
    phase("total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
