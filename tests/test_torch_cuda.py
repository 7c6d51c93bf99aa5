"""The CUDA kernels on the card, against their plain versions.

Needs an NVIDIA GPU and nvcc; every test skips without a CUDA device.
This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Each kernel and its plain version run the same IEEE float32 operations in
the same order (nvcc --fmad=false, no fast math), so every field of every
lane must be equal: ids, occlusion, keys, t, u, v, normals and uv.
"""
import numpy as np
import pytest
import torch

from mitsuba_tpu_torch.ops import exact as ep
from mitsuba_tpu_torch.ops import intersect as ip
from mitsuba_tpu_torch.ops import stream as sp

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    ip.build()
    return torch.device("cuda", 0)


def _inputs(seed, n_tris, n, device):
    rng = np.random.default_rng(seed)
    v = rng.uniform(-1, 1, (n_tris, 3, 3)).astype(np.float32)
    v[:, :, 2] += np.linspace(0, 2, n_tris, dtype=np.float32)[:, None]
    v[5] = v[4]                                   # exact duplicate
    v[6, 2] = 0.5 * (v[6, 0] + v[6, 1])           # degenerate
    table = np.zeros((n_tris, ip.SHD_COLS), np.float32)
    table[:, 0:3] = v[:, 0]
    table[:, 3:6] = v[:, 1] - v[:, 0]
    table[:, 6:9] = v[:, 2] - v[:, 0]
    nrm = rng.normal(size=(n_tris, 9)).astype(np.float32)
    table[:, 9:18] = nrm
    table[:, 18:24] = rng.uniform(0, 1, (n_tris, 6))
    table[:, 24] = np.arange(n_tris) % 5
    table[:, 25] = np.where(np.arange(n_tris) % 7 == 0, 0, -1)
    table[:, 26] = np.arange(n_tris)

    def rays(k):
        r = np.random.default_rng(seed * 10 + k)
        o = r.uniform(-1, 1, (n, 3)).astype(np.float32)
        o[:, 2] -= 3.0
        tgt = r.uniform(-1, 1, (n, 3)).astype(np.float32)
        tgt[:, 2] += 1.0
        d = tgt - o
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        mint = np.full(n, 1e-4, np.float32)
        maxt = np.where(np.arange(n) % 11 == 0, -1.0,
                        r.uniform(1.0, 8.0, n)).astype(np.float32)
        return o, d, mint, maxt

    return [torch.from_numpy(np.ascontiguousarray(x)).to(device)
            for x in (table, *rays(1), *rays(2))]


@pytest.mark.parametrize("n_tris,n", [(32, 1000), (300, 70001)])
def test_kernel_matches_plain_version(cuda, n_tris, n):
    """T = 300 stages the table in three chunks; N = 70001 leaves a
    ragged last block."""
    args = _inputs(n_tris, n_tris, n, cuda)
    before = ip.LAUNCHES
    rec, occ = ip.closest_hit_shaded_and_any(*args)
    assert ip.LAUNCHES == before + 1
    ref, ref_occ = ip.closest_hit_shaded_and_any_ref(*args)
    torch.cuda.synchronize()
    for k in ("prim", "valid", "material_id", "emitter_id", "shape_id",
              "t", "u", "v"):
        assert torch.equal(rec[k], ref[k]), k
    assert torch.equal(occ, ref_occ)
    for k in ("geo_n", "sh_n", "uv"):
        assert torch.equal(rec[k], ref[k]), k
    prim = rec["prim"].cpu().numpy()
    assert (prim >= 0).mean() > 0.3 and not (prim == 5).any()
    assert not (prim == 6).any()
    assert 0 < int(occ.sum()) < n


@pytest.mark.parametrize("n_tris,n", [(32, 1000), (300, 70001)])
def test_split_kernels_match_plain_versions(cuda, n_tris, n):
    """#2 (shaded), #3 (any) and #4 (closest) against their plain
    versions, bit for bit, on the inputs of the fused kernel's test; #2
    equals #1's closest half."""
    args = _inputs(n_tris, n_tris, n, cuda)
    table, rays = args[0], args[1:5]
    tri = ip.make_tri_table(table[:, 0:3], table[:, 3:6], table[:, 6:9])
    before = dict(ip.SPLIT_LAUNCHES)
    rec = ip.closest_hit_shaded(table, *rays)
    occ = ip.any_hit(tri, *args[5:9])
    hit = ip.closest_hit(tri, *rays)
    assert ip.SPLIT_LAUNCHES == {k: v + 1 for k, v in before.items()}
    ref = ip.closest_hit_shaded_ref(table, *rays)
    ref_occ = ip.any_hit_ref(tri, *args[5:9])
    ref_hit = ip.closest_hit_ref(tri, *rays)
    fused, fused_occ = ip.closest_hit_shaded_and_any(*args)
    torch.cuda.synchronize()
    for k in ref:
        assert torch.equal(rec[k], ref[k]), k
        assert torch.equal(rec[k], fused[k]), k
    assert torch.equal(occ, ref_occ) and torch.equal(occ, fused_occ)
    for a, b in zip(hit, ref_hit):
        assert torch.equal(a, b)
    assert torch.equal(hit[3], rec["prim"])
    prim = rec["prim"].cpu().numpy()
    assert (prim >= 0).mean() > 0.3 and not (prim == 5).any()
    assert 0 < int(occ.sum()) < n


def _same_record(got, ref):
    """Every field of every lane, float32 fields by their bits (so -0.0
    differs from +0.0), with the reference's keys, dtypes and shapes."""
    assert list(got) == list(ref)
    for k in ref:
        a, b = got[k], ref[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), k


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["T1", "T32", "T64", "T65", "T300",
                                  "shadow_dead", "warps_dead", "still_dirs"])
def test_shaded_kernels_match_plain_versions_on_corner_cases(cuda, name,
                                                             seed):
    """#1 and #2 on tests/torch_brute_cases.py's inputs (whole warps and
    tiles dead, single live lanes, every shadow lane dead, shadow rays
    occluded by the first and by the last row, exact ties of duplicated
    rows within and across staging passes, |det| at 1e-9 and an ulp or
    two either side, zero and -0.0 direction components, T = 1 to 300, a
    ragged last warp): every field of every lane, bit for bit."""
    import torch_brute_cases as bc

    args = bc.cases(seed, device=cuda)[name]
    before, before_split = ip.LAUNCHES, ip.SPLIT_LAUNCHES["shaded"]
    rec, occ = ip.closest_hit_shaded_and_any(*args)
    alone = ip.closest_hit_shaded(*args[:5])
    assert ip.LAUNCHES == before + 1
    assert ip.SPLIT_LAUNCHES["shaded"] == before_split + 1
    ref, ref_occ = ip.closest_hit_shaded_and_any_ref(*args)
    torch.cuda.synchronize()
    _same_record(rec, ref)
    _same_record(alone, ref)
    assert occ.dtype == torch.bool and torch.equal(occ, ref_occ)
    if name == "shadow_dead":
        assert not bool(ref_occ.any())


@pytest.mark.parametrize("n_tris,n", [(32, 1_000_003), (300, 400_001)])
def test_shaded_kernels_stride_over_many_tiles(cuda, n_tris, n):
    """More lanes than the persistent grid holds at once: every block
    strides over several tiles (and, at T = 300, restages the table for
    each), with a dead lane in every 11 and a ragged end; bit for bit."""
    args = _inputs(n_tris + 1, n_tris, n, cuda)
    rec, occ = ip.closest_hit_shaded_and_any(*args)
    alone = ip.closest_hit_shaded(*args[:5])
    ref, ref_occ = ip.closest_hit_shaded_and_any_ref(*args)
    torch.cuda.synchronize()
    _same_record(rec, ref)
    _same_record(alone, ref)
    assert torch.equal(occ, ref_occ)


def test_shaded_kernels_keep_blocks_in_flight(cuda):
    """#1 and #2 hold at least four 256-thread blocks per SM (their launch
    bounds), without spilling registers."""
    for shadow in (False, True):
        info = ip.brute_info(shadow)
        assert info["blocks_per_sm"] >= 4, info
        assert info["local_bytes"] == 0, info


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["T1", "T32", "T64", "T65", "T300",
                                  "shadow_dead", "warps_dead", "still_dirs"])
def test_split_kernels_match_plain_versions_on_corner_cases(cuda, name,
                                                            seed):
    """#3 (any hit) on the shadow rays and #4 (closest, unshaded) on the
    bounce rays of tests/torch_brute_cases.py's inputs, over the (T, 9)
    table of the case's first 9 columns: every field of every lane, bit
    for bit, the outputs already bool."""
    import torch_brute_cases as bc

    args = bc.cases(seed, device=cuda)[name]
    tri = args[0][:, :9].contiguous()
    before = dict(ip.SPLIT_LAUNCHES)
    occ = ip.any_hit(tri, *args[5:9])
    hit = ip.closest_hit(tri, *args[1:5])
    assert ip.SPLIT_LAUNCHES["any"] == before["any"] + 1
    assert ip.SPLIT_LAUNCHES["closest"] == before["closest"] + 1
    ref_occ = ip.any_hit_ref(tri, *args[5:9])
    ref_hit = ip.closest_hit_ref(tri, *args[1:5])
    torch.cuda.synchronize()
    assert occ.dtype == torch.bool and torch.equal(occ, ref_occ)
    for a, b in zip(hit, ref_hit):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)
    # #1's halves on the same rays over the (T, 29) table agree
    rec, fused_occ = ip.closest_hit_shaded_and_any(*args)
    assert torch.equal(occ, fused_occ)
    assert torch.equal(hit[3], rec["prim"])
    if name == "shadow_dead":
        assert not bool(occ.any())


def _kernels_launched(fn):
    """The names of the CUDA kernels fn() launches (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()
            for _ in range(e.count)
            if getattr(e, "device_type", None) == DeviceType.CUDA]


def test_brute_wrappers_launch_their_kernel_alone(cuda):
    """Each brute wrapper launches one kernel a call, its instance of
    brute_kernel, and nothing around it (no cast, no re-pack)."""
    args = _inputs(3, 32, 5000, cuda)
    table, rays, shadow = args[0], args[1:5], args[5:9]
    tri = table[:, :9].contiguous()
    for call in (lambda: ip.closest_hit_shaded_and_any(*args),
                 lambda: ip.closest_hit_shaded(table, *rays),
                 lambda: ip.any_hit(tri, *shadow),
                 lambda: ip.closest_hit(tri, *rays)):
        call()                                     # built and warm
        names = _kernels_launched(call)
        assert len(names) == 1 and "brute_kernel" in names[0], names
    assert ip.any_hit(tri, *shadow).dtype == torch.bool
    assert ip.closest_hit(tri, *rays)[4].dtype == torch.bool


def test_brute_instances_keep_blocks_in_flight(cuda):
    """All four instances hold at least four 256-thread blocks per SM
    (their launch bounds), without spilling registers."""
    for name in ip.BRUTE_KERNELS:
        info = ip.brute_info(name)
        assert info["blocks_per_sm"] >= 4, (name, info)
        assert info["local_bytes"] == 0, (name, info)


def test_fog_render_on_the_card_goes_through_the_split_kernels(cuda):
    """A volumetric render of the Cornell box in fog: per bounce one
    launch each of #2 and #3, none of #1; the image as on the CPU."""
    from mitsuba_tpu_torch.integrators import PathConfig, render_volpath
    from mitsuba_tpu_torch.media import make_homogeneous
    from mitsuba_tpu_torch.render.scene import cornell_box

    cfg = PathConfig(max_depth=5, spp=4)
    med = make_homogeneous((0.0015,) * 3, (0.0003,) * 3, g=0.4)
    before, before_fused = dict(ip.SPLIT_LAUNCHES), ip.LAUNCHES
    img, _ = render_volpath(cornell_box(32, 32, device=cuda), med, cfg,
                            seed=3)
    torch.cuda.synchronize()
    assert ip.SPLIT_LAUNCHES["shaded"] == before["shaded"] + cfg.max_depth
    assert ip.SPLIT_LAUNCHES["any"] == before["any"] + cfg.max_depth
    assert ip.LAUNCHES == before_fused
    ref, _ = render_volpath(cornell_box(32, 32, device="cpu"), med, cfg,
                            seed=3)
    assert img.shape == ref.shape and bool(torch.isfinite(img).all())
    assert abs(float(img.mean()) - float(ref.mean())) <= 0.02 * float(
        ref.mean())


def test_kernel_rejects_mixed_devices(cuda):
    args = _inputs(1, 16, 64, cuda)
    with pytest.raises(ValueError):
        ip.closest_hit_shaded_and_any(args[0].cpu(), *args[1:])


def test_render_on_the_card_goes_through_the_kernel(cuda):
    from mitsuba_tpu_torch.integrators.path import PathConfig, render
    from mitsuba_tpu_torch.render.scene import cornell_box

    cfg = PathConfig(max_depth=5, spp=4)
    before = ip.LAUNCHES
    img, aux = render(cornell_box(32, 32, device=cuda), cfg, seed=3)
    torch.cuda.synchronize()
    assert ip.LAUNCHES == before + cfg.max_depth
    ref, aux_ref = render(cornell_box(32, 32, device="cpu"), cfg, seed=3)
    # the same lanes draw the same numbers; sin/cos/sqrt of the card may
    # differ from the CPU's in the last bit, which moves a few paths
    assert img.shape == ref.shape
    assert bool(torch.isfinite(img).all())
    assert abs(float(img.mean()) - float(ref.mean())) <= 0.01 * float(
        ref.mean())
    rays, rays_ref = int(aux["rays_traced"]), int(aux_ref["rays_traced"])
    assert abs(rays - rays_ref) <= 0.01 * rays_ref


# ---------------------------------------------------------------------------
# the cluster kernels (#5 refine, #6 child refine, #7 items, #10 stream)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cluster():
    """A 2,210-triangle cluster scene on the card and 1,000 rays (8 rows,
    the last ragged) from above toward it, every 7th lane dead."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    from mitsuba_tpu_torch.render.mesh import make_quad, make_sphere_mesh
    from mitsuba_tpu_torch.ops.rows import pack_rays
    from mitsuba_tpu_torch.render.intersect import build_geometry

    dev = torch.device("cuda", 0)
    ep.build()
    sp.build()
    geom = build_geometry(
        [(make_sphere_mesh([0, 0.8, 0], 0.8, 24, 48), 0, -1),
         (make_quad([-6, 0, -6], [-6, 0, 6], [6, 0, 6], [6, 0, -6]), 1, -1)],
        backend="cluster")
    rng = np.random.default_rng(0)
    n = 1000
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.2, 2.5, n)
    tgt = (rng.normal(size=(n, 3)) * 0.5).astype(np.float32)
    tgt[:, 1] += 0.8
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mint = np.full(n, 1e-4, np.float32)
    maxt = np.where(np.arange(n) % 7 == 0, -1.0, 1e30).astype(np.float32)
    rays = pack_rays(*[torch.from_numpy(x) for x in (o, d, mint, maxt)])[0]
    ex = {k: v.to(dev) for k, v in geom.ex_tables.items()}
    st = {k: v.to(dev) for k, v in geom.st_tables.items()}
    return dev, rays.to(dev), ex, st


def test_refine_kernel_matches_plain_version(cluster):
    dev, rays, ex, _st = cluster
    ids, tns = sp.build_sc_lists(rays, ex["b0_lo"], ex["b0_hi"])
    ids = ids[:, :128].contiguous()
    live = torch.clamp((tns < 3e38).sum(1), max=128).to(torch.int32)
    before = ep.LAUNCHES["refine"]
    got = ep.refine(rays, ids, live, ex["b0_lo"], ex["b0_hi"])
    assert ep.LAUNCHES["refine"] == before + 1
    ref = ep.refine_ref(rays, ids, live, ex["b0_lo"], ex["b0_hi"])
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert int((ref < 3e38).sum()) > 100


def test_child_refine_kernel_matches_plain_version(cluster):
    dev, rays, ex, _st = cluster
    r = rays.shape[0]
    gen = torch.Generator(device=dev).manual_seed(1)
    pids = torch.randint(0, ex["ct0"].shape[0], (r, 24), generator=gen,
                         device=dev, dtype=torch.int32)
    live = torch.randint(0, 25, (r,), generator=gen, device=dev,
                         dtype=torch.int32)
    before = ep.LAUNCHES["child_refine"]
    got = ep.child_refine(rays, pids, live, ex["ct0"])
    assert ep.LAUNCHES["child_refine"] == before + 1
    ref = ep.child_refine_ref(rays, pids, live, ex["ct0"])
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert int((ref < 3e38).sum()) > 100


@pytest.mark.parametrize("any_hit", [False, True])
def test_items_kernel_matches_plain_version(cluster, any_hit):
    dev, rays, ex, _st = cluster
    ids, blk_tn, _ovf = ep.build_exact_items(rays, ex, (128, 16, 32, 96))
    before = ep.LAUNCHES["items"]
    got = ep.items(ex["tri"], rays, ids, blk_tn, any_hit)
    assert ep.LAUNCHES["items"] == before + 1
    ref = ep.items_ref(ex["tri"], rays, ids, blk_tn, any_hit)
    torch.cuda.synchronize()
    if any_hit:
        assert torch.equal(got, ref) and 100 < int(ref.sum())
        return
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert int((ref[3] >= 0).sum()) > 100


@pytest.mark.parametrize("any_hit", [False, True])
def test_stream_kernel_matches_plain_version(cluster, any_hit):
    dev, rays, _ex, st = cluster
    ids, tns = sp.build_sc_lists(rays, st["sc_bmin"], st["sc_bmax"])
    before = sp.LAUNCHES
    got = sp.stream_rows(rays, ids, tns, st["sc_tri"], any_hit)
    assert sp.LAUNCHES == before + 1
    ref = sp.stream_rows_ref(rays, ids, tns, st["sc_tri"], any_hit)
    torch.cuda.synchronize()
    if any_hit:
        assert torch.equal(got, ref) and 100 < int(ref.sum())
        return
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert int((ref[3] >= 0).sum()) > 100


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("blm", [4, 16])
def test_l1_walk_kernels_match_plain_versions(cluster, any_hit, blm):
    """#8 (v6) and #9 (v6b, blm L1 blocks per step) on the L1 lists of
    the cluster rows at caps whose E2 (48) leaves dead slots in some rows,
    bit for bit."""
    dev, rays, ex, _st = cluster
    l1_ids, l1_keys, _ovf = ep.build_exact_l1(rays, ex, (128, 16, 48, 96))
    assert bool((l1_keys >= 3e38).any()) and bool((l1_keys < 3e38).any())
    before = dict(ep.LAUNCHES)
    got6 = ep.l1_items(ex["tri"], ex["ct0"], rays, l1_ids, l1_keys, any_hit)
    got6b = ep.l1_masked(ex["tri"], rays, l1_ids, l1_keys, any_hit, blm)
    assert ep.LAUNCHES["l1_items"] == before["l1_items"] + 1
    assert ep.LAUNCHES["l1_masked"] == before["l1_masked"] + 1
    ref6 = ep.l1_items_ref(ex["tri"], ex["ct0"], rays, l1_ids, l1_keys,
                           any_hit)
    ref6b = ep.l1_masked_ref(ex["tri"], rays, l1_ids, l1_keys, any_hit, blm)
    torch.cuda.synchronize()
    if any_hit:
        assert torch.equal(got6, ref6) and torch.equal(got6b, ref6b)
        assert 100 < int(ref6.sum())
        return
    for a, b in zip(got6 + got6b, ref6 + ref6b):
        assert torch.equal(a, b)
    assert int((ref6b[3] >= 0).sum()) > 100


@pytest.mark.parametrize("any_hit", [False, True])
def test_cluster_v1_kernel_matches_plain_version(cuda, any_hit):
    """#14 on 3,000 rays (3 tiles, the last ragged) against 12 spheres cut
    into 128-triangle clusters (more than one supercluster per list), bit
    for bit; the entry points launch it once per query."""
    from mitsuba_tpu_torch.ops import cluster as cp
    from mitsuba_tpu_torch.render.bvh import build_bvh
    from mitsuba_tpu_torch.render.clusters import cut_clusters
    from mitsuba_tpu_torch.render.mesh import make_sphere_mesh

    cp.build()
    spheres = [make_sphere_mesh([2.5 * i, 0.0, 0.0], 1.0, 12, 24)
               for i in range(12)]
    base = np.cumsum([0] + [s.vertices.shape[0] for s in spheres])
    v = np.concatenate([np.asarray(s.vertices, np.float32) for s in spheres])
    f = np.concatenate([np.asarray(s.faces, np.int64) + b
                        for s, b in zip(spheres, base)])
    bvh = build_bvh(v, f)
    tri = v[f[bvh.perm]]
    ct = cp.build_cluster_tables(
        tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0],
        cut_clusters(bvh.first, bvh.count, bvh.skip, tri.shape[0]))
    assert ct.n_super > 1
    tab = cp.table_dict(ct, cuda)
    o, d, mint, maxt = (x.to(cuda) for x in _scene_rays(
        3000, 7, [0.0, -1.0, -1.0], [27.5, 1.0, 1.0], [-2, -3, -3],
        [30, 3, 3]))
    if any_hit:
        maxt = torch.where(maxt > 0, 2.5, maxt)
    args, _n = cp.launch_args(tab, o, d, mint, maxt, any_hit)
    assert int(args[2].max()) > 1
    key = "cluster_any" if any_hit else "cluster_closest"
    before = cp.LAUNCHES[key]
    got = cp.cluster_rows(*args, rec=tab["rec"])
    assert cp.LAUNCHES[key] == before + 1
    ref = cp.cluster_rows_ref(*args)
    torch.cuda.synchronize()
    if any_hit:
        assert torch.equal(got, ref) and 100 < int(ref.sum())
        assert torch.equal(cp.cluster_any(tab, o, d, mint, maxt),
                           ref.reshape(-1)[:3000])
    else:
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        assert int((ref[3] >= 0).sum()) > 500
        res = cp.cluster_closest(tab, o, d, mint, maxt)
        assert torch.equal(res[3], ref[3].reshape(-1)[:3000])
    assert cp.LAUNCHES[key] == before + 2


def test_cluster_v1_kernel_keeps_rows_in_flight(cuda):
    """#14 holds at least 6 rows per SM, closest and any, with no spill
    (csrc/cluster.cu: 80 registers a thread at most)."""
    from mitsuba_tpu_torch.ops import cluster as cp

    cp.build()
    for any_hit in (False, True):
        info = cp.cluster_info(any_hit)
        assert info["rows_per_sm"] >= 6 and info["local_bytes"] == 0, info


def _fields_of(res):
    return [res] if isinstance(res, torch.Tensor) else list(res)


@pytest.mark.parametrize("variant", ["closest", "any", "closest inf",
                                     "any inf", "closest sentinel",
                                     "closest seed 1", "any seed 1"])
def test_cluster_v1_kernel_on_corner_cases(cuda, variant):
    """#14 on tests/torch_v1_cases.py's inputs: six superclusters, rows of
    one tile voting differently, dead and occluded rows, lists of length
    0 and C_s, ties within and across clusters, maxt = inf through
    launch_args, the miss sentinel; every field by its bits, one launch."""
    import torch_v1_cases as vc
    from mitsuba_tpu_torch.ops import cluster as cp

    cp.build()
    words = variant.split()
    any_hit = words[0] == "any"
    args = vc.args(seed=1 if "seed" in words else 0, any_hit=any_hit,
                   inf="inf" in words, sentinel="sentinel" in words,
                   device=cuda)
    key = "cluster_any" if any_hit else "cluster_closest"
    before = cp.LAUNCHES[key]
    got = cp.cluster_rows(*args)
    assert cp.LAUNCHES[key] == before + 1
    ref = cp.cluster_rows_ref(*args)
    torch.cuda.synchronize()
    for a, b in zip(_fields_of(got), _fields_of(ref)):
        assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                           else a, b.view(torch.int32)
                           if b.is_floating_point() else b)


def _cluster_render(dev, walk):
    """A 32x32 config-3 render on the card with the item walk `walk`, the
    launches of each exact-cull kernel in it, and the same on the CPU."""
    from mitsuba_tpu_torch.integrators.path import PathConfig, render
    from mitsuba_tpu_torch.render.scene import textured_mesh_scene

    cfg = PathConfig(max_depth=3, spp=2)
    before = dict(ep.LAUNCHES)
    img, _aux = render(textured_mesh_scene(32, 32, backend="cluster",
                                           device=dev, ex_walk=walk),
                       cfg, seed=3)
    torch.cuda.synchronize()
    ran = {k: ep.LAUNCHES[k] - before[k] for k in before}
    ref, _ = render(textured_mesh_scene(32, 32, backend="cluster",
                                        device="cpu", ex_walk=walk),
                    cfg, seed=3)
    return img, ref, ran


def test_cluster_render_on_the_card_goes_through_the_kernels(cluster):
    """The card's default walk is v6b: every exact query launches #9 and
    none #7 or #8."""
    img, ref, ran = _cluster_render(cluster[0], None)
    for k in ("refine", "child_refine", "l1_masked"):
        assert ran[k] > 0, k
    assert ran["items"] == 0 and ran["l1_items"] == 0
    assert img.shape == ref.shape and bool(torch.isfinite(img).all())
    # the same lanes draw the same numbers; transcendentals of the card
    # may differ from the CPU's in the last bit, which moves a few paths
    assert abs(float(img.mean()) - float(ref.mean())) <= 0.02 * float(
        ref.mean())


def test_cluster_render_with_the_v5_walk_goes_through_the_item_kernel(
        cluster):
    """ex_walk='v5' keeps #7 on the render path (and S3's child refine):
    no L1 walk launches."""
    img, ref, ran = _cluster_render(cluster[0], "v5")
    for k in ("refine", "child_refine", "items"):
        assert ran[k] > 0, k
    assert ran["l1_masked"] == 0 and ran["l1_items"] == 0
    assert img.shape == ref.shape and bool(torch.isfinite(img).all())
    assert abs(float(img.mean()) - float(ref.mean())) <= 0.02 * float(
        ref.mean())


# ---------------------------------------------------------------------------
# #7-#10 on the corner cases of their schedules (tests/torch_walk_cases.py)
# ---------------------------------------------------------------------------

def _same(got, ref):
    if isinstance(ref, torch.Tensor):
        return torch.equal(got, ref)
    return all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("e2,blm", [(32, 16), (32, 1), (384, 16),
                                    (768, 16)])
def test_v6b_kernel_matches_plain_version_on_corner_cases(cuda, e2, blm,
                                                          any_hit):
    """#9 at the coherent, diffuse and XL list widths (and one L1 block a
    step: half a staged chunk) on rows with whole warps dead, escaping
    or occluded in their first steps, a dead row, lists with dead slots
    in their last tested step, and planted exact ties across L1 blocks,
    clusters, sublanes and steps; bit for bit."""
    import torch_walk_cases as wc

    ep.build()
    tri, rays, ids, keys = wc.v6b_case(e2, any_hit, device=cuda)
    before = ep.LAUNCHES["l1_masked"]
    got = ep.l1_masked(tri, rays, ids, keys, any_hit, blm)
    assert ep.LAUNCHES["l1_masked"] == before + 1
    ref = ep.l1_masked_ref(tri, rays, ids, keys, any_hit, blm)
    torch.cuda.synchronize()
    assert _same(got, ref)
    if any_hit:
        assert 0 < int(ref.sum()) < int((rays[:, 6] <= rays[:, 7]).sum())
    elif blm > 1:
        # a copy wins a tie within a step at a lower sublane; one L1 block
        # a step puts every copy in a later step, where it never wins
        assert int((ref[3] >= wc.PRIM_COPY).sum()) > 0


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("e3", [96, 512, 1024])
def test_items_kernel_matches_plain_version_on_corner_cases(cuda, e3,
                                                            any_hit):
    """#7 at the coherent, diffuse and XL list widths on the same kinds of
    rows, with a copy of each K8 cluster listed after the next cluster of
    its original (exact ties across sublanes, clusters and steps) and
    dead slots past each row's live entries; bit for bit."""
    import torch_walk_cases as wc

    ep.build()
    tri, rays, ids, blk_tn = wc.items_case(e3, any_hit, device=cuda)
    before = ep.LAUNCHES["items"]
    got = ep.items(tri, rays, ids, blk_tn, any_hit)
    assert ep.LAUNCHES["items"] == before + 1
    ref = ep.items_ref(tri, rays, ids, blk_tn, any_hit)
    torch.cuda.synchronize()
    assert _same(got, ref)
    if any_hit:
        assert 0 < int(ref.sum()) < int((rays[:, 6] <= rays[:, 7]).sum())
    else:
        # a copy wins a tie within a step at a lower sublane
        assert int((ref[3] >= wc.PRIM_COPY).sum()) > 0


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("e2", [32, 384, 768])
def test_l1_items_kernel_matches_plain_version_on_corner_cases(cuda, e2,
                                                               any_hit):
    """#8 on #9's corner cases, the copied L1 blocks with child boxes of
    their own triangles: children that some lanes of a row admit and
    others do not, copies that tie their originals (and never win: the
    merge against the lane's best is strict); bit for bit."""
    import torch_walk_cases as wc

    ep.build()
    case = wc.l1_case(e2, any_hit, device=cuda)
    before = ep.LAUNCHES["l1_items"]
    got = ep.l1_items(*case, any_hit)
    assert ep.LAUNCHES["l1_items"] == before + 1
    ref = ep.l1_items_ref(*case, any_hit)
    torch.cuda.synchronize()
    assert _same(got, ref)
    rays = case[2]
    if any_hit:
        assert 0 < int(ref.sum()) < int((rays[:, 6] <= rays[:, 7]).sum())
    else:
        assert int((ref[3] >= 0).sum()) > 0


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("any_hit", [False, True])
def test_stream_kernel_matches_plain_version_on_corner_cases(cuda, any_hit,
                                                             seed):
    """#10 at K = 32 on the same kinds of rows, whose escaping lanes walk
    their lists to the end, over superclusters of clusters drawn from the
    whole table: exact ties across chunks, parities, sublanes, clusters
    and superclusters, and far clusters after near ones (hits under the
    looser cap dropped at the merge); bit for bit."""
    import torch_walk_cases as wc

    sp.build()
    rays, ids, tns, sc_tri = wc.stream_case(any_hit, seed, device=cuda)
    before = sp.LAUNCHES
    got = sp.stream_rows(rays, ids, tns, sc_tri, any_hit)
    assert sp.LAUNCHES == before + 1
    ref = sp.stream_rows_ref(rays, ids, tns, sc_tri, any_hit)
    torch.cuda.synchronize()
    assert _same(got, ref)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", [
    "refine E 128", "refine E 256", "child Ep 16", "child Ep 160",
    "child Ep 240", "child Ep 32", "child Ep 384", "child Ep 768",
    "child root"])
def test_refine_kernels_match_plain_versions_on_corner_cases(cuda, name,
                                                             seed):
    """#5 and #6 at every cap width and on the all-L2 root table, on rows
    with whole warps dead, a single live lane, zero and tiny direction
    components, negative keys and keys tied at -0.0 and +0.0 within and
    across warps, live prefixes of 0, 1 and the whole list with garbage
    ids past them: bit for bit, the zeros' signs included."""
    import torch_refine_cases as rc

    ep.build()
    kernel, args = rc.case(name, seed, device=cuda)
    before = ep.LAUNCHES[kernel]
    got = getattr(ep, kernel)(*args)
    assert ep.LAUNCHES[kernel] == before + 1
    ref = getattr(ep, f"{kernel}_ref")(*args)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    zero = ref == 0
    assert 0 < int((zero & torch.signbit(ref)).sum()) < int(zero.sum())


def test_refine_kernels_keep_rows_in_flight(cuda):
    """#5 and #6 hold at least 6 rows per SM (csrc/exact.cu
    RF_ROWS_PER_SM)."""
    ep.build()
    for child in (False, True):
        assert ep.refine_info(child)["rows_per_sm"] >= 6


def test_walk_kernels_keep_rows_in_flight(cuda):
    """#9, #8 and #7 hold at least 8 rows per SM at every list width of
    config 3 (csrc/exact.cu WALK_ROWS_PER_SM), #10 at least 4 (a config-3
    fallback launch of 512 rows in one wave)."""
    ep.build()
    sp.build()
    for e2, e3 in ((32, 96), (384, 512), (768, 1024)):
        for any_hit in (False, True):
            assert ep.l1_masked_info(e2, ep.V6B_BLM, any_hit)[
                "rows_per_sm"] >= 8
            assert ep.l1_items_info(e2, any_hit)["rows_per_sm"] >= 8
            assert ep.items_info(e3, any_hit)["rows_per_sm"] >= 8
    for any_hit in (False, True):
        assert sp.stream_info(32, any_hit)["rows_per_sm"] >= 4


# ---------------------------------------------------------------------------
# the BVH kernel (#11) and the work-list kernel (#12)
# ---------------------------------------------------------------------------

def _scene_rays(n, seed, lo, hi, eye_lo, eye_hi):
    """n rays from a box of eyes toward a box of targets; every 9th lane
    dead, every 13th axis-parallel."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(eye_lo, eye_hi, (n, 3)).astype(np.float32)
    d = rng.uniform(lo, hi, (n, 3)).astype(np.float32) - o
    d[::13, :2] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mint = np.full(n, 1e-4, np.float32)
    maxt = np.where(np.arange(n) % 9 == 0, -1.0, 1e30).astype(np.float32)
    return [torch.from_numpy(np.ascontiguousarray(x))
            for x in (o, d, mint, maxt)]


@pytest.mark.parametrize("any_hit", [False, True])
def test_bvh_kernel_matches_plain_version(cuda, any_hit):
    """4,097 rays (a ragged last block) against a 2,210-triangle BVH."""
    from mitsuba_tpu_torch.ops import bvh as bp
    from mitsuba_tpu_torch.render.mesh import make_quad, make_sphere_mesh
    from mitsuba_tpu_torch.render.intersect import build_geometry

    bp.build()
    geom = build_geometry(
        [(make_sphere_mesh([0, 0.8, 0], 0.8, 24, 48), 0, -1),
         (make_quad([-6, 0, -6], [-6, 0, 6], [6, 0, 6], [6, 0, -6]), 1, -1)],
        backend="bvh").to(cuda)
    rays = [x.to(cuda) for x in _scene_rays(4097, 5, -1.0, 1.0,
                                             [-3, 0.2, -3], [3, 3, 3])]
    key = "bvh_any" if any_hit else "bvh_closest"
    fn = bp.bvh_any if any_hit else bp.bvh_closest
    # the kernel's own clamp of the slab reciprocals, and the reference
    # walk's, which the instance walks use
    for rcp_eps in (bp.RCP_EPS, 1e-20):
        before = bp.LAUNCHES[key]
        got = fn(geom.bvh_packed, geom.tri_packed, *rays, rcp_eps=rcp_eps)
        assert bp.LAUNCHES[key] == before + 1
        ref = bp.walk_ref(geom.bvh_packed, geom.tri_packed, *rays, any_hit,
                          rcp_eps)
        torch.cuda.synchronize()
        if any_hit:
            assert torch.equal(got, ref) and 100 < int(ref.sum())
            continue
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        assert int(ref[4].sum()) > 1000


@pytest.mark.parametrize("instanced", [False, True])
@pytest.mark.parametrize("any_hit", [False, True])
def test_worklist_kernel_matches_plain_version(cuda, instanced, any_hit):
    """2,000 rays (16 rows, the first 4 dead) of a flat cluster scene, or
    of the instanced scene, through a list built with small beams so that
    the live rows overflow."""
    from mitsuba_tpu_torch.ops import worklist as wl
    from mitsuba_tpu_torch.ops.rows import pack_rays
    from mitsuba_tpu_torch.render.intersect import build_geometry
    from mitsuba_tpu_torch.render.mesh import make_quad, make_sphere_mesh
    from mitsuba_tpu_torch.render.scene import instanced_scene

    wl.build()
    if instanced:
        geom = instanced_scene(32, 32, 24, 48, device="cpu").geom
    else:
        geom = build_geometry(
            [(make_sphere_mesh([0, 0.8, 0], 0.8, 24, 48), 0, -1),
             (make_quad([-6, 0, -6], [-6, 0, 6], [6, 0, 6], [6, 0, -6]), 1,
              -1)], backend="cluster")
    tab = {k: v.to(cuda) for k, v in geom.wl_tables.items()}
    lo, hi = geom.bvh_min[0].numpy(), geom.bvh_max[0].numpy()
    o, d, mint, maxt = _scene_rays(2000, 6, lo, hi, lo - 2, hi + 2)
    # dead rows far above the scene, looking up: no candidates
    o[:512], d[:512], maxt[:512] = 100.0, torch.tensor([0.0, 0, 1]), -1.0
    rays = pack_rays(o, d, mint, maxt)[0].to(cuda)
    items, _total, ovf = wl.build_worklist(
        rays, tab["bmin"], tab["bmax"], tab["sc_bmin"], tab["sc_bmax"],
        rays.shape[0] * 8, 4, 2)
    seg = wl.row_segments(items, rays.shape[0])
    args = (items, seg, tab["tri"], tab["tri_start"], rays,
            tab.get("block_id"), tab.get("xform"), any_hit)
    key = "wl_any" if any_hit else "wl_closest"
    before = wl.LAUNCHES[key]
    got = wl.wl_rows(*args)
    assert wl.LAUNCHES[key] == before + 1
    ref = wl.wl_rows_ref(*args)
    torch.cuda.synchronize()
    assert bool(ovf.any()) and not bool(ovf.all())
    if any_hit:
        assert torch.equal(got, ref) and 50 < int(ref.sum())
        return
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert int((ref[3] >= 0).sum()) > 50


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("list_end", ["tail", "overflow"])
@pytest.mark.parametrize("k", [32, 8])
@pytest.mark.parametrize("instanced", [False, True])
def test_worklist_kernel_on_corner_cases(cuda, instanced, k, list_end,
                                         any_hit):
    """#12 on tests/torch_instanced_cases.py's rows (dead, occluded and
    sentinel warps, a dead row, a 540-slot row, planted ties within a
    block and across items), on the segments that end at the list's last
    used slot and on the untrimmed ones (a tail of 1,200 unused slots, or
    a list cut short at w_cap)."""
    from mitsuba_tpu_torch.ops import worklist as wl
    import torch_instanced_cases as ic

    wl.build()
    items, seg, tri, ts, rays, bid, xf, _total, full = ic.wl_case(
        instanced, k, list_end, device=cuda)
    key = "wl_any" if any_hit else "wl_closest"
    before = wl.LAUNCHES[key]
    got = wl.wl_rows(items, seg, tri, ts, rays, bid, xf, any_hit)
    got_full = wl.wl_rows(items, full, tri, ts, rays, bid, xf, any_hit)
    assert wl.LAUNCHES[key] == before + 2
    ref = wl.wl_rows_ref(items, seg, tri, ts, rays, bid, xf, any_hit)
    torch.cuda.synchronize()
    assert _same(got, ref) and _same(got_full, ref)


@pytest.mark.parametrize("any_hit", [False, True])
def test_worklist_kernel_on_a_whole_chunk(cuda, any_hit):
    """#12 on the whole list of the instanced scene's camera rays (64 x 64
    px, 2 spp: 64 rows, 1,600 of 3,072 slots used) at the render path's
    beams, its last row and that row's unused slots included, trimmed
    and untrimmed."""
    from mitsuba_tpu_torch.integrators.path import (
        PathConfig, camera_wavefront,
    )
    from mitsuba_tpu_torch.ops import worklist as wl
    from mitsuba_tpu_torch.ops.rows import pack_rays
    from mitsuba_tpu_torch.render.scene import instanced_scene

    wl.build()
    scene = instanced_scene(64, 64, 24, 48, device="cpu")
    tab = {k: v.to(cuda) for k, v in scene.geom.wl_tables.items()}
    ray = camera_wavefront(scene, PathConfig(spp=2), 0)[0]
    rays = pack_rays(ray.o, ray.d, ray.mint,
                     torch.clamp(ray.maxt, max=1e30))[0].to(cuda)
    items, total, _ovf = wl.build_worklist(
        rays, tab["bmin"], tab["bmax"], tab["sc_bmin"], tab["sc_bmax"],
        rays.shape[0] * wl.W_FACTOR, wl.L_SC, wl.BEAM_S2)
    full = wl.row_segments(items, rays.shape[0])
    seg = wl.row_segments(items, rays.shape[0], total)
    assert int(seg[-1]) == total < int(full[-1])
    args = (tab["tri"], tab["tri_start"], rays, tab["block_id"],
            tab["xform"], any_hit)
    got = wl.wl_rows(items, seg, *args)
    got_full = wl.wl_rows(items, full, *args)
    ref = wl.wl_rows_ref(items, seg, *args)
    torch.cuda.synchronize()
    assert _same(got, ref) and _same(got_full, ref)


def test_worklist_kernel_keeps_rows_in_flight(cuda):
    """#12 holds at least 8 rows per SM at K = 32, every body."""
    from mitsuba_tpu_torch.ops import worklist as wl

    wl.build()
    for any_hit in (False, True):
        for inst in (False, True):
            info = wl.wl_info(32, any_hit, inst)
            assert info["rows_per_sm"] >= 8, info


@pytest.mark.parametrize("rcp_eps", [1e-12, 1e-20])
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("name", ["leaves", "tail"])
def test_bvh_kernel_on_corner_cases(cuda, name, any_hit, rcp_eps):
    """#11 on tests/torch_instanced_cases.py's trees: equal t in two
    leaves, a leaf past the last triangle, zero direction components,
    and a few lanes walking the whole tree while the rest end within a
    few nodes; with the geometry's aligned tables and without them."""
    from mitsuba_tpu_torch.ops import bvh as bp
    import torch_instanced_cases as ic

    bp.build()
    nodes, tris, o, d, mint, maxt = ic.bvh_cases(device=cuda)[name]
    fn = bp.bvh_any if any_hit else bp.bvh_closest
    aligned = bp.align_tables(nodes, tris)
    got = fn(nodes, tris, o, d, mint, maxt, rcp_eps=rcp_eps,
             aligned=aligned)
    got2 = fn(nodes, tris, o, d, mint, maxt, rcp_eps=rcp_eps)
    ref = bp.walk_ref(nodes, tris, o, d, mint, maxt, any_hit, rcp_eps)
    torch.cuda.synchronize()
    assert _same(got, ref) and _same(got2, ref)
    hits = ref if any_hit else ref[4]
    assert 0 < int(hits.sum()) < hits.numel()


def test_bvh_kernel_keeps_walks_in_flight(cuda):
    """#11 holds at least 9 blocks of 128 walks per SM, without a
    spill."""
    from mitsuba_tpu_torch.ops import bvh as bp

    bp.build()
    for any_hit in (False, True):
        info = bp.bvh_info(any_hit)
        assert info["blocks_per_sm"] >= 9 and info["local_bytes"] == 0, info


def test_bvh_render_on_the_card_goes_through_the_kernel(cuda):
    from mitsuba_tpu_torch.integrators.path import PathConfig, render
    from mitsuba_tpu_torch.ops import bvh as bp
    from mitsuba_tpu_torch.render.scene import textured_mesh_scene

    cfg = PathConfig(max_depth=3, spp=2)
    before = dict(bp.LAUNCHES)
    img, aux = render(textured_mesh_scene(32, 32, device=cuda), cfg, seed=3)
    torch.cuda.synchronize()
    for k in ("bvh_closest", "bvh_any"):
        assert bp.LAUNCHES[k] == before[k] + cfg.max_depth, k
    ref, aux_ref = render(textured_mesh_scene(32, 32, device="cpu"), cfg,
                          seed=3)
    assert img.shape == ref.shape and bool(torch.isfinite(img).all())
    assert abs(float(img.mean()) - float(ref.mean())) <= 0.02 * float(
        ref.mean())


def test_instanced_render_on_the_card_goes_through_the_kernels(cuda):
    from mitsuba_tpu_torch.integrators.path import PathConfig, render
    from mitsuba_tpu_torch.ops import worklist as wl
    from mitsuba_tpu_torch.render.scene import instanced_scene

    cfg = PathConfig(max_depth=3, spp=4)
    before = dict(wl.LAUNCHES)
    scene = instanced_scene(32, 32, 10, 20, device="cpu")
    img, aux = render(scene.to(cuda), cfg, seed=3)
    torch.cuda.synchronize()
    for k in ("wl_closest", "wl_any"):
        assert wl.LAUNCHES[k] > before[k], k
    ref, aux_ref = render(scene, cfg, seed=3)
    assert img.shape == ref.shape and bool(torch.isfinite(img).all())
    assert abs(float(img.mean()) - float(ref.mean())) <= 0.02 * float(
        ref.mean())


# ---------------------------------------------------------------------------
# the work-list probe (#13) and the cost probes of csrc/probes.cu
# ---------------------------------------------------------------------------

def test_worklist_probe_kernel_matches_plain_version(cuda):
    """#13 on 2,000 rays (16 rows, the first 4 dead) of a flat cluster
    scene, through a list small enough that rows overflow; bit for bit,
    one launch; the entry point once per row chunk."""
    from mitsuba_tpu_torch.ops import worklist as wl
    from mitsuba_tpu_torch.ops.rows import pack_rays
    from mitsuba_tpu_torch.render.intersect import build_geometry
    from mitsuba_tpu_torch.render.mesh import make_quad, make_sphere_mesh

    wl.build()
    geom = build_geometry(
        [(make_sphere_mesh([0, 0.8, 0], 0.8, 24, 48), 0, -1),
         (make_quad([-6, 0, -6], [-6, 0, 6], [6, 0, 6], [6, 0, -6]), 1, -1)],
        backend="cluster")
    tab = {k: v.to(cuda) for k, v in geom.wl_tables.items()}
    lo, hi = geom.bvh_min[0].numpy(), geom.bvh_max[0].numpy()
    o, d, mint, maxt = _scene_rays(2000, 8, lo, hi, lo - 2, hi + 2)
    o[:512], d[:512], maxt[:512] = 100.0, torch.tensor([0.0, 0, 1]), -1.0
    rays = pack_rays(o, d, mint, maxt)[0].to(cuda)
    items, _total, ovf = wl.build_worklist(
        rays, tab["bmin"], tab["bmax"], tab["sc_bmin"], tab["sc_bmax"],
        rays.shape[0] * 8, 4, 2)
    seg = wl.row_segments(items, rays.shape[0])
    before = wl.LAUNCHES["wl_probe"]
    got = wl.wl_probe_rows(items, seg, tab["tri"], rays)
    assert wl.LAUNCHES["wl_probe"] == before + 1
    ref = wl.wl_probe_ref(items, seg, tab["tri"], rays)
    torch.cuda.synchronize()
    assert bool(ovf.any()) and torch.equal(got, ref)
    assert torch.unique(ref).numel() > 5
    acc, ovf2 = wl.wl_probe(tab, *(x.to(cuda) for x in (o, d, mint, maxt)))
    assert wl.LAUNCHES["wl_probe"] == before + 2
    assert acc.shape == (2000,) and ovf2.shape == (16,)


@pytest.mark.parametrize("list_end", ["tail", "overflow"])
@pytest.mark.parametrize("k", [32, 8])
def test_worklist_probe_kernel_on_corner_cases(cuda, k, list_end):
    """#13 on tests/torch_instanced_cases.py's flat lists (a dead row, a
    row with no valid item, a 540-slot row with an invalid slot, an
    unused tail, a list cut short), trimmed and untrimmed: bit for bit,
    one launch each; its instance of #12's walk keeps 8 rows per SM."""
    import torch_instanced_cases as ic
    from mitsuba_tpu_torch.ops import worklist as wl

    wl.build()
    items, seg, tri, _ts, rays, _b, _x, _total, full = ic.wl_case(
        False, k, list_end, device=cuda)
    before = wl.LAUNCHES["wl_probe"]
    got = wl.wl_probe_rows(items, seg, tri, rays)
    got_full = wl.wl_probe_rows(items, full, tri, rays)
    assert wl.LAUNCHES["wl_probe"] == before + 2
    ref = wl.wl_probe_ref(items, seg, tri, rays)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(got_full.view(torch.int32), ref.view(torch.int32))
    info = wl.wl_probe_info(k)
    assert info["rows_per_sm"] >= 8 and info["local_bytes"] == 0, info


def _probe_inputs(cuda, seed=0):
    rng = np.random.default_rng(seed)

    def t(x, dtype=np.float32):
        return torch.as_tensor(np.ascontiguousarray(x, dtype), device=cuda)
    return rng, t


def test_probe_floors_match_plain_versions(cuda):
    """The launch counter, the gated loop (gate on and off per item), the
    rotating staging at 8 and 32 KB and the grid loop with and without
    fetch, on 3 blocks: every block bit for bit with the plain version."""
    from mitsuba_tpu_torch.ops import probes as pr

    pr.build()
    rng, t = _probe_inputs(cuda)
    counter = torch.zeros(1, dtype=torch.int32, device=cuda)
    before = pr.LAUNCHES["count"]
    pr.count(counter, 17, blocks=3)
    assert int(counter) == 17 and pr.LAUNCHES["count"] == before + 17
    n = 301
    ids = t(rng.integers(0, 64, n), np.int32)
    flags = t(rng.integers(0, 2, n), np.int32)
    g = t(rng.standard_normal((64, 512, 16)))
    assert torch.equal(pr.gate(g, ids, flags, blocks=3),
                       pr.gate_ref(g, ids, flags).expand(3, 8, 128))
    for kb in (8, 32):
        g = t(rng.standard_normal((64, kb * 16, 16)))
        assert torch.equal(pr.rotate(g, ids, blocks=3),
                           pr.rotate_ref(g, ids).expand(3, 8, 128))
    tri = t(rng.standard_normal((2048, 4, 128)))
    gids = t(rng.integers(0, 2048, n), np.int32)
    for fetch in (False, True):
        assert torch.equal(pr.grid(tri, gids, fetch, blocks=3),
                           pr.grid_ref(tri, gids, fetch).expand(3, 8, 128))


def test_probe_fma_chains_match_plain_versions(cuda):
    """The FMA chain and V0 are fused multiply-adds: held bit for bit
    against fma32, which rounds each once."""
    from mitsuba_tpu_torch.ops import probes as pr

    rng, t = _probe_inputs(cuda, 1)
    a = t(rng.random((8, 128)) * 0.1 + 0.9)
    b = t(rng.random((8, 128)) * 1e-6)
    assert torch.equal(pr.fma(a, b, 16, 3, blocks=2),
                       pr.fma_ref(a, b, 16, 3).expand(2, 8, 128))
    rays = t(rng.random((8, 128)))
    assert torch.equal(pr.v0(rays, 3, blocks=2),
                       pr.v0_ref(rays, 3).expand(2, 8, 128))


def test_probe_mt_kernels_match_plain_versions(cuda):
    """The cluster test (128 and 32 triangles) and V1 bit for bit; V4's
    accepts bit for bit and its sums, like V2's, within TOLERANCE."""
    from mitsuba_tpu_torch.ops import probes as pr

    rng, t = _probe_inputs(cuda, 2)
    rays = t(rng.random((8, 128)))
    for k in (128, 32):
        tri = t(rng.random((k, 16)))
        got = pr.mt(tri, rays, 2, blocks=2)
        ref = pr.mt_ref(tri, rays, 2)
        for a, r in zip(got, ref):
            assert torch.equal(a, r.expand_as(a))
        assert int((ref[1] >= 0).sum()) > 10
    tri = t(rng.random((32, 16)))
    for add_u in (True, False):
        got = pr.v1(tri, rays, 2, add_u=add_u, blocks=2)
        ref = pr.v1_ref(tri, rays, 2, add_u)
        for a, r in zip(got, ref):
            assert torch.equal(a, r.expand_as(a))
    acc, hits = pr.v4(tri, rays, 2, blocks=2)
    acc_r, hits_r = pr.packed_ref(tri, rays, 2, True)
    assert torch.equal(hits, hits_r.expand_as(hits)) and int(hits_r.sum())
    assert pr.rel_err(acc[1], acc_r) <= pr.TOLERANCE["v4"]
    acc, hits = pr.v2(tri, rays, 2, blocks=2)
    acc_r, hits_r = pr.packed_ref(tri, rays, 2, False)
    same = hits[0] == hits_r
    assert float(same.float().mean()) >= 1 - pr.V2_HITS_DIFFER_MAX
    assert pr.rel_err(acc[0][same], acc_r[same]) <= pr.TOLERANCE["v2"]


@pytest.mark.parametrize("m,k,negative", [
    (512, 10, False), (4096, 10, False), (512, 128, False),
    # a ragged last tile of the spread kernels (mm_cuda's 32 rows,
    # mm_tf32's 64), also on rows whose products are all negative, where a
    # padded row's zero would win the maximum
    (8, 10, False), (16, 10, False), (24, 10, False), (48, 10, False),
    (528, 10, False), (4104, 10, False), (24, 10, True), (48, 10, True),
    (528, 10, True), (4104, 10, True), (48, 128, True)])
def test_probe_products_match_plain_versions(cuda, m, k, negative):
    """The (m, k) x (k, 128) products, 2 copies: on the float32 pipes bit
    for bit (k = 10), on the tensor cores (m a multiple of 16) within
    TOLERANCE."""
    from mitsuba_tpu_torch.ops import probes as pr

    rng, t = _probe_inputs(cuda, m + k)
    G, M = t(rng.standard_normal((m, k))), t(rng.standard_normal((k, 128)))
    if negative:
        G, M = -(G.abs() + 0.1), M.abs() + 0.1
    if k == 10:
        got = pr.mm_cuda(G, M, 3, blocks=2)
        for a, r in zip(got, pr.mm_cuda_ref(G, M, 3)):
            assert torch.equal(a, r.expand_as(a))
    for kind in ("tf32", "bf16") if m % 16 == 0 else ():
        got = pr.mm_tc(G, M, 3, kind, blocks=2)
        ref = pr.mm_tc_ref(G, M, 3, kind)
        assert not negative or bool((ref[1] < 0).all())
        for a, r in zip(got, ref):
            assert pr.rel_err(a, r.expand_as(a)) <= pr.TOLERANCE[f"mm_{kind}"]


def test_probe_products_at_8192_copies(cuda):
    """Each of 8,192 copies (a block each, two for the tensor-core
    kinds' halves) as the plain version."""
    from mitsuba_tpu_torch.ops import probes as pr

    rng, t = _probe_inputs(cuda, 8192)
    G, M = t(rng.standard_normal((4096, 10))), t(rng.standard_normal((10,
                                                                     128)))
    for a, r in zip(pr.mm_cuda(G, M, 2, blocks=8192), pr.mm_cuda_ref(G, M,
                                                                      2)):
        assert torch.equal(a, r.expand_as(a))
    for kind in ("tf32", "bf16"):
        for a, r in zip(pr.mm_tc(G, M, 2, kind, blocks=8192),
                        pr.mm_tc_ref(G, M, 2, kind)):
            assert pr.rel_err(a, r.expand_as(a)) <= pr.TOLERANCE[
                f"mm_{kind}"]


# one call of each spread product profiled in a process of its own: in a
# process that has run for minutes, torch.profiler may record no device
# event of so short a window
_ONE_KERNEL = """
import json, sys
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from mitsuba_tpu_torch.ops import probes as pr

dev = torch.device("cuda", 0)
gen = torch.Generator().manual_seed(64)
for m in (64, 4096):
    G = torch.randn(m, 10, generator=gen).to(dev)
    M = torch.randn(10, 128, generator=gen).to(dev)
    for kind, call in (("tf32", lambda: pr.mm_tc(G, M, 1, "tf32")),
                       ("bf16", lambda: pr.mm_tc(G, M, 1, "bf16")),
                       ("cuda", lambda: pr.mm_cuda(G, M, 1))):
        call()                          # the tickets' buffer, zeroed once
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        print(json.dumps([kind, m, [e.name for e in prof.events()
                                    if e.device_type == DeviceType.CUDA]]))
"""


# the kernel each spread product's call must launch, as the profiler
# names it
_SPREAD_KERNEL = {"cuda": "mm_cuda_kernel", "tf32": "mm_tc_kernel<Tf32",
                  "bf16": "mm_tc_kernel<Bf16"}


def test_probe_tf32_product_is_one_kernel(cuda):
    """One mm_tc(..., "tf32") call launches one kernel, mm_tc_kernel's
    TF32 instance (the padding and the TF32 rounding inside it), one
    mm_tc(..., "bf16") call its bf16 instance (the padding and the bf16
    rounding inside it: no conversion kernel), and mm_cuda one too (the
    profiler's device events of one call, in a fresh process), each over
    more than one block from m = 64: the blocks that ran, as the kernel
    counts them, are the plan's; each kernel is compiled for the plan's
    tiles."""
    import json
    import os
    import subprocess
    import sys

    from mitsuba_tpu_torch.ops import probes as pr

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for kind, k in (("cuda", 10), ("tf32", 10), ("tf32", 128), ("bf16", 10),
                    ("bf16", 128)):
        info = pr.mm_info(kind, k)
        assert (info["tile_rows"], info["halves"]) == (pr.TILE_ROWS[kind],
                                                       pr.HALVES[kind])
    run = subprocess.run(
        [sys.executable, "-c", _ONE_KERNEL], cwd=root, capture_output=True,
        text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root] + [p for p in [os.environ.get("PYTHONPATH")] if p])))
    assert run.returncode == 0, run.stderr[-2000:]
    seen = [json.loads(ln) for ln in run.stdout.splitlines()
            if ln.startswith("[")]
    assert len(seen) == 6
    for kind, m, kernels in seen:
        assert len(kernels) == 1 and _SPREAD_KERNEL[kind] in kernels[0], \
            (kind, m, kernels)
    rng, t = _probe_inputs(cuda, 64)
    for m in (64, 4096):
        G, M = t(rng.standard_normal((m, 10))), t(rng.standard_normal(
            (10, 128)))
        for kind, call in (("tf32", lambda: pr.mm_tc(G, M, 1, "tf32")),
                           ("bf16", lambda: pr.mm_tc(G, M, 1, "bf16")),
                           ("cuda", lambda: pr.mm_cuda(G, M, 1))):
            ran = pr.blocks_ran(call, cuda)[1]
            assert ran == pr.mm_plan(kind, m)["blocks"] and ran > 1


def _tf32_ties():
    """float32 values planted on TF32's rounding: the 13 dropped bits a
    tie (0x1000), one either side, none and all, in both signs, on bases
    where a tie carries into the exponent, among the subnormals and at
    the largest finite values."""
    bits = [((base | low) ^ sign)
            for base in (0x3F800000, 0x40490000, 0x3F801000, 0x00000000,
                         0x00400000, 0x3FFFE000, 0x7F7FE000, 0x0080A000)
            for low in (0x1000, 0x0FFF, 0x1001, 0x0000, 0x1FFF, 0x0001)
            for sign in (0, 0x80000000)]
    return np.array(bits, np.uint32).view(np.float32)


def test_probe_tf32_rounds_as_round_tf32(cuda):
    """mm_tf32's own rounding (cvt.rna in the kernel) on planted ties,
    each product one rounded input times a rounded 1: M's row of K = 1
    against G's ones (128 a call, in out_sum and out_max), then G's
    column against M's ones (8 a call, in out_sum); equal to round_tf32's
    values (a zero's sign aside: the padded depth adds +0)."""
    from mitsuba_tpu_torch.ops import probes as pr

    _, t = _probe_inputs(cuda)
    x = _tf32_ties()
    want = pr.round_tf32(torch.from_numpy(x.copy()))
    row = np.resize(x, 128)
    out_sum, out_max = pr.mm_tc(t(np.ones((64, 1))), t(row[None]), 1, "tf32")
    w = torch.from_numpy(np.resize(want.numpy(), 128)).to(cuda)
    assert torch.equal(out_sum[0], w.expand(8, 128))
    assert torch.equal(out_max[0], w)
    for i in range(0, len(x), 8):
        col = np.zeros((16, 1), np.float32)
        col[:8, 0] = np.resize(x[i:i + 8], 8)
        out_sum, _ = pr.mm_tc(t(col), t(np.ones((1, 128))), 1, "tf32")
        w = pr.round_tf32(torch.from_numpy(col[:8].copy())).to(cuda)
        assert torch.equal(out_sum[0], w.expand(8, 128))


def _bf16_ties():
    """float32 values planted on bf16's rounding: the 16 dropped bits a
    tie (0x8000), one either side, none and all, in both signs, on kept
    mantissas even and odd, where a tie carries into the exponent, among
    the subnormals and at the largest finite values."""
    bits = [((base | low) ^ sign)
            for base in (0x3F800000, 0x3F810000, 0x40490000, 0x3FFF0000,
                         0x00000000, 0x00010000, 0x00400000, 0x7F7E0000,
                         0x00800000)
            for low in (0x8000, 0x7FFF, 0x8001, 0x0000, 0xFFFF, 0x0001)
            for sign in (0, 0x80000000)]
    return np.array(bits, np.uint32).view(np.float32)


def test_probe_bf16_rounds_as_the_plain_version(cuda):
    """mm_bf16's own rounding (cvt.rn.bf16x2 in the kernel) on planted
    ties, each product one rounded input times a rounded 1: M's row of
    K = 1 against G's ones (128 a call, in out_sum and out_max), then G's
    column against M's ones (8 a call, in out_sum); equal to round_bf16's
    values, the plain version's conversion (a zero's sign aside: the
    padded depth adds +0)."""
    from mitsuba_tpu_torch.ops import probes as pr

    _, t = _probe_inputs(cuda)
    x = _bf16_ties()
    want = pr.round_bf16(torch.from_numpy(x.copy()))
    row = np.resize(x, 128)
    out_sum, out_max = pr.mm_tc(t(np.ones((64, 1))), t(row[None]), 1, "bf16")
    w = torch.from_numpy(np.resize(want.numpy(), 128)).to(cuda)
    assert torch.equal(out_sum[0], w.expand(8, 128))
    assert torch.equal(out_max[0], w)
    for i in range(0, len(x), 8):
        col = np.zeros((16, 1), np.float32)
        col[:8, 0] = np.resize(x[i:i + 8], 8)
        out_sum, _ = pr.mm_tc(t(col), t(np.ones((1, 128))), 1, "bf16")
        w = pr.round_bf16(torch.from_numpy(col[:8].copy())).to(cuda)
        assert torch.equal(out_sum[0], w.expand(8, 128))


@pytest.mark.parametrize("kb", [8, 32])
def test_probe_rotate_ring_matches_plain_version(cuda, kb):
    """rotate's bulk-copy ring bit for bit with rotate_ref at 8 and 32 KB
    blocks: no item, 1, S - 1, S, S + 1 (S the ring's stages), 33 and 65
    (the warp's ids past a chunk of 32) and 512 items, ids repeated (the
    same block in flight in several stages), on 1 and 8,192 copies; and
    the refusals of what the bulk copy cannot take."""
    from mitsuba_tpu_torch.ops import probes as pr

    rng, t = _probe_inputs(cuda, kb)
    g = t(rng.standard_normal((64, kb * 16, 16)))
    stages = pr.ring_stages(kb * 256)
    info = pr.rotate_info(kb * 256)
    assert info["stages"] == stages > 1 and info["local_bytes"] == 0, info
    assert info["smem_bytes"] <= 232448, info
    for n in sorted({0, 1, stages - 1, stages, stages + 1, 33, 65, 512}):
        ids = t(rng.integers(0, 64, n), np.int32)
        if n > 3:
            ids[1:4] = ids[0]                     # one block, 4 stages
        ref = pr.rotate_ref(g, ids)
        for blocks in (1, 8192):
            before = pr.LAUNCHES["rotate"]
            got = pr.rotate(g, ids, blocks=blocks)
            assert pr.LAUNCHES["rotate"] == before + 1
            assert torch.equal(got, ref.expand(blocks, 8, 128)), (n, blocks)
    flat = torch.zeros(64 * kb * 256 + 4, device=cuda)
    with pytest.raises(ValueError):
        pr.rotate(flat[1:1 + 64 * kb * 256].view(64, kb * 16, 16), ids)
    with pytest.raises(ValueError):
        pr.rotate(torch.zeros(64, kb * 16, 32, device=cuda)[..., :16], ids)


def _planted_probe(rng, shape, t):
    """Standard normal values, one in five scaled by 1e7: a sum taken in
    another order than the plain version's rounds otherwise."""
    x = rng.standard_normal(shape)
    x[rng.random(shape) < 0.2] *= 1e7
    return t(x)


def _probe_list(rng, n, blocks, t):
    """Drawn ids, the first repeated, the last block among them."""
    ids = rng.integers(0, blocks, n)
    if n > 3:
        ids[1:4] = ids[0]
    if n:
        ids[n // 2] = blocks - 1
    return t(ids, np.int32)


def test_probe_grid_ring_matches_plain_version(cuda):
    """grid on rotate's bulk-copy ring (`ring_kernel<GridRow0>`, G items a
    stage), fetch and no fetch, bit for bit with grid_ref at 0, 1, G - 1,
    G, G + 1, S G - 1, S G, S G + 1 and 512 items, ids repeated and the
    last block among them, on 1, 3 and 8,192 copies, one launch a call;
    its resources; and the refusal of a misaligned tri on the card."""
    from mitsuba_tpu_torch.ops import probes as pr

    rng, t = _probe_inputs(cuda, 27)
    info = pr.grid_info()
    g_, s_ = info["group"], info["stages"]
    assert (g_, s_) == (pr.GRID_GROUP, pr.grid_plan(0)["stages"]), info
    assert info["batch"] == g_ and info["local_bytes"] == 0, info
    assert info["smem_bytes"] <= 232448, info
    tri = _planted_probe(rng, (2048, 4, 128), t)
    for n in sorted({0, 1, g_ - 1, g_, g_ + 1, s_ * g_ - 1, s_ * g_,
                     s_ * g_ + 1, 512}):
        ids = _probe_list(rng, n, 2048, t)
        for fetch in (True, False):
            ref = pr.grid_ref(tri, ids, fetch)
            for blocks in (1, 3, 8192):
                before = pr.LAUNCHES["grid"]
                got = pr.grid(tri, ids, fetch, blocks=blocks)
                assert pr.LAUNCHES["grid"] == before + 1
                assert torch.equal(got, ref.expand(blocks, 8, 128)), (
                    n, fetch, blocks)
    flat = torch.zeros(2048 * 512 + 4, device=cuda)
    with pytest.raises(ValueError):
        pr.grid(flat[1:1 + 2048 * 512].view(2048, 4, 128), ids, True)


@pytest.mark.parametrize("form", ["open", "closed", "alternating", "drawn"])
def test_probe_gate_matches_plain_version(cuda, form):
    """gate's passes of 16 items (64 in flight, folded in item order) bit
    for bit with gate_ref at its pass, batch and chunk edges and 512
    items, every gate open, closed, alternating or drawn, planted rows,
    ids repeated and the last block among them, on 1, 3 and 8,192
    copies, one launch a call; and the refusals of a misaligned or
    float64 g on the card."""
    from mitsuba_tpu_torch.ops import probes as pr

    rng, t = _probe_inputs(cuda, 28)
    g = _planted_probe(rng, (64, 512, 16), t)
    for n in (0, 1, 15, 16, 17, 63, 64, 65, 511, 512, 513, 1100):
        ids = _probe_list(rng, n, 64, t)
        flags = {"open": np.ones(n), "closed": np.zeros(n),
                 "alternating": np.arange(n) % 2,
                 "drawn": rng.integers(-1, 2, n)}[form]
        flags = t(flags, np.int32)
        ref = pr.gate_ref(g, ids, flags)
        for blocks in (1, 3, 8192):
            before = pr.LAUNCHES["gate"]
            got = pr.gate(g, ids, flags, blocks=blocks)
            assert pr.LAUNCHES["gate"] == before + 1
            assert torch.equal(got, ref.expand(blocks, 8, 128)), (n, blocks)
    flat = torch.zeros(64 * 512 * 16 + 4, device=cuda)
    with pytest.raises(ValueError):
        pr.gate(flat[1:1 + 64 * 512 * 16].view(64, 512, 16), ids, flags)
    with pytest.raises(ValueError):
        pr.gate(g.double(), ids, flags)


@pytest.mark.parametrize("k", [512, 32768])
def test_probe_gathers_match_plain_version(cuda, k):
    """Both gathers equal table[idx]; an index outside the table reads
    NaN."""
    from mitsuba_tpu_torch.ops import probes as pr

    rng, t = _probe_inputs(cuda, k)
    table = t(rng.random(k))
    idx = rng.integers(0, k, 100_003).astype(np.int32)
    idx[:2] = (-1, k)
    idx = t(idx, np.int32)
    ref = pr.gather_ref(table, idx)
    for fn in (pr.gather_smem, pr.gather_global):
        got = fn(table, idx)
        assert torch.equal(got[2:], ref[2:]) and bool(got[:2].isnan().all())


def test_config2_on_the_card_goes_through_the_kernel(cuda):
    """Config 2: the fused kernel a bounce, the glass sphere merged after
    it; the image as on the CPU."""
    from mitsuba_tpu_torch.integrators.path import PathConfig, render
    from mitsuba_tpu_torch.render.scene import cornell_box_specular

    cfg = PathConfig(max_depth=5, spp=4)
    before = ip.LAUNCHES
    img, _ = render(cornell_box_specular(32, 32, device=cuda), cfg, seed=3)
    torch.cuda.synchronize()
    assert ip.LAUNCHES == before + cfg.max_depth
    ref, _ = render(cornell_box_specular(32, 32, device="cpu"), cfg, seed=3)
    assert img.shape == ref.shape and bool(torch.isfinite(img).all())
    # specular chains carry a last-bit difference into a whole path
    assert abs(float(img.mean()) - float(ref.mean())) <= 0.02 * float(
        ref.mean())


def _reflectance_grad(scene, cfg):
    import dataclasses

    from mitsuba_tpu_torch.integrators.path import render

    refl = scene.materials.reflectance.clone().requires_grad_(True)
    img, _ = render(dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, reflectance=refl)), cfg, seed=0)
    img.mean().backward()
    return refl.grad


@pytest.mark.parametrize("remat", [False, True])
def test_gradient_on_the_card_matches_the_cpu(cuda, remat):
    """The reflectance gradient on the card: #1 in the forward and, with a
    checkpoint a bounce, again in the backward's recompute; the gradient
    as on the CPU (the plain versions)."""
    from mitsuba_tpu_torch.integrators.path import PathConfig
    from mitsuba_tpu_torch.render.scene import cornell_box

    cfg = PathConfig(max_depth=4, spp=2, remat=remat)
    before = ip.LAUNCHES
    g = _reflectance_grad(cornell_box(16, 16, device=cuda), cfg)
    torch.cuda.synchronize()
    assert ip.LAUNCHES == before + cfg.max_depth * (2 if remat else 1)
    ref = _reflectance_grad(cornell_box(16, 16, device="cpu"), cfg)
    assert bool(torch.isfinite(g).all())
    assert float((g.cpu() - ref).abs().max()) <= 1e-3 * float(
        ref.abs().max())


def test_wrapper_refuses_a_ray_that_requires_grad_on_the_card(cuda):
    args = list(_inputs(1, 16, 64, cuda))
    args[1] = args[1].clone().requires_grad_(True)
    with pytest.raises(NotImplementedError):
        ip.closest_hit_shaded_and_any(*args)
    with torch.no_grad():
        ip.closest_hit_shaded_and_any(*args)


def test_cli_on_the_card_equals_the_library_render(cuda, tmp_path):
    """`python -m mitsuba_tpu_torch scenes/cornell.xml` without --cpu runs
    on the card, through #1, and writes the library render's bits."""
    import os

    from mitsuba_tpu_torch.cli import main
    from mitsuba_tpu_torch.integrators.path import PathConfig, render
    from mitsuba_tpu_torch.io.bitmap import read_exr
    from mitsuba_tpu_torch.io.xml import load_scene

    xml = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scenes", "cornell.xml")
    out = str(tmp_path / "cornell.exr")
    ip.LAUNCHES = 0
    assert main([xml, "-q", "-D", "depth=5", "-D", "spp=4", "-D", "width=32",
                 "-D", "height=32", "-o", out]) == 0
    assert ip.LAUNCHES == 5
    scene, cfg = load_scene(xml, params=dict(depth=5, spp=4, width=32,
                                             height=32))
    assert scene.device.type == "cuda" and scene.geom.backend == "brute"
    img, _ = render(scene, PathConfig(max_depth=5, spp=4, remat=False))
    assert np.array_equal(read_exr(out), img.cpu().numpy())


def test_config3_twin_on_the_card_equals_textured_mesh_scene(cuda, tmp_path):
    """tests/torch_xml_cases.py's XML twin of config 3 (101,760-triangle
    body as binary PLY) loads on the cluster backend under `auto` with
    config 3's tables, its two material rows in the other order."""
    import torch_xml_cases as xc

    from mitsuba_tpu_torch.io.xml import load_scene
    from mitsuba_tpu_torch.render.scene import textured_mesh_scene

    twin, _ = load_scene(xc.write_config3_twin(str(tmp_path)),
                         params=dict(depth=5, spp=4, width=64, height=64))
    ref = textured_mesh_scene(64, 64, backend="cluster", device=cuda)
    assert twin.geom.backend == "cluster" and twin.geom.n_tris == 101762
    assert set(xc.table_diffs(twin, ref)) <= {
        "geom.material_id", "geom.shade_pack", "materials.kind",
        "materials.reflectance", "materials.specular", "materials.exponent",
        "materials.tex_id"}
    assert xc.table_diffs(twin, xc.with_material_order(ref)) == []


@pytest.mark.parametrize("kind", ["grid", "flake", "guided", "tank",
                                  "tank_grid"])
def test_media_render_on_the_card_matches_the_cpu(cuda, kind):
    """Participating media on the card: a grid medium and an oriented
    Gaussian-flake medium in the Cornell box and guided volpath (one #2
    and one #3 launch a bounce, and per guided pass), and the volumetric
    tank's interior media (#2 for the bounce and once per crossing of the
    shadow walk, 5 a bounce, and no #3). The card's image against the
    CPU's: the same lanes, the mean within 2% (Woodcock decisions within
    an ulp may flip)."""
    import torch_media_cases as mc

    from mitsuba_tpu_torch.integrators import (
        PathConfig, render_volpath, render_volpath_guided,
        render_volpath_media,
    )
    from mitsuba_tpu_torch.media import make_heterogeneous, make_homogeneous
    from mitsuba_tpu_torch.render.scene import cornell_box

    cfg = PathConfig(max_depth=4, spp=4)
    if kind.startswith("tank"):
        dens = mc.noise_grid(16, 6) if kind == "tank_grid" else None

        def run(dev):
            return render_volpath_media(mc.tank_scene(16, dens, device=dev),
                                        cfg, seed=3)
        want = {"shaded": cfg.max_depth * 5, "any": 0}
    else:
        grid = mc.noise_grid(16, 5)
        if kind == "flake":
            med = make_heterogeneous(grid, mc.grid_to_box(grid.shape),
                                     (0.002,) * 3, (0.0008,) * 3,
                                     orientation=mc.fiber_field(16),
                                     flake_stddev=0.3)
        elif kind == "grid":
            med = make_heterogeneous(grid, mc.grid_to_box(grid.shape),
                                     (0.002,) * 3, (0.0008,) * 3, g=0.4)
        else:
            med = make_homogeneous((0.0015,) * 3, (0.0003,) * 3, g=0.4)
        fn = render_volpath_guided if kind == "guided" else render_volpath

        def run(dev):
            return fn(cornell_box(16, 16, device=dev), med, cfg, seed=3)
        passes = 2 if kind == "guided" else 1
        want = {"shaded": cfg.max_depth * passes,
                "any": cfg.max_depth * passes}
    before = dict(ip.SPLIT_LAUNCHES)
    img, _ = run(cuda)
    torch.cuda.synchronize()
    for k, n in want.items():
        assert ip.SPLIT_LAUNCHES[k] - before[k] == n, (k, ip.SPLIT_LAUNCHES)
    ref, _ = run("cpu")
    assert img.shape == ref.shape and bool(torch.isfinite(img).all())
    assert float(ref.mean()) > 0
    assert abs(float(img.mean()) - float(ref.mean())) <= 0.02 * float(
        ref.mean())


def test_bsdf_zoo_render_on_the_card_matches_the_cpu(cuda):
    """Every BSDF kind and option of the port (tests/torch_bsdf_cases.py's
    zoo) on the card: one #1 launch a bounce, the spheres merged after
    it; the image against the CPU's, lane for lane the same random
    numbers, the mean within 2% (an ulp of the libraries' sin, cos or pow
    may turn a sampled lobe)."""
    import torch_bsdf_cases as zc

    from mitsuba_tpu_torch.integrators import PathConfig, render

    cfg = PathConfig(max_depth=4, spp=2)
    mods = zc.port_modules()
    before = ip.LAUNCHES
    img, _ = render(zc.zoo_scene(mods, 16, device=cuda), cfg, seed=3)
    torch.cuda.synchronize()
    assert ip.LAUNCHES - before == cfg.max_depth
    ref, _ = render(zc.zoo_scene(mods, 16, device="cpu"), cfg, seed=3)
    assert img.shape == ref.shape and bool(torch.isfinite(img).all())
    assert float(ref.mean()) > 0
    assert abs(float(img.mean()) - float(ref.mean())) <= 0.02 * float(
        ref.mean())


def test_cli_renders_snow_on_the_card(cuda, tmp_path):
    """`python -m mitsuba_tpu_torch scenes/snow.xml` on the card at 64x64
    px with the file's ldsampler pattern and gaussian filter: the EXR is
    the library's render bit for bit, its mean within 5% of the CPU's."""
    import os

    from mitsuba_tpu_torch.cli import main
    from mitsuba_tpu_torch.integrators import PathConfig, render
    from mitsuba_tpu_torch.io import bitmap
    from mitsuba_tpu_torch.io.xml import load_scene

    xml = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scenes", "snow.xml")
    params = dict(depth=5, spp=4, width=64, height=64)
    out = str(tmp_path / "snow.exr")
    assert main(["-q", xml, *[a for k, v in params.items()
                              for a in ("-D", f"{k}={v}")], "-o", out]) == 0
    pc = PathConfig(max_depth=5, spp=4, pattern="ldsampler",
                    rfilter="gaussian", remat=False)
    img, _ = render(load_scene(xml, params=params, device=cuda)[0], pc)
    assert np.array_equal(bitmap.read_exr(out), img.cpu().numpy())
    ref, _ = render(load_scene(xml, params=params, device="cpu")[0], pc)
    assert abs(float(img.mean()) - float(ref.mean())) <= 0.05 * float(
        ref.mean())


def test_lights_scene_on_the_card_matches_the_cpu(cuda, tmp_path):
    """The lights file of tests/torch_light_cases.py (point, spot,
    directional, sphere and envmap lights, a bitmap floor) on the card:
    one #1 launch a bounce; the image's mean within 2% of the CPU's, lane
    for lane the same random numbers; its orthographic twin likewise."""
    import torch_light_cases as lc

    from mitsuba_tpu_torch.integrators import PathConfig, render
    from mitsuba_tpu_torch.io.xml import load_scene

    params = dict(depth=4, spp=2, width=24, height=24)
    cfg = PathConfig(max_depth=4, spp=2)
    for camera in ("perspective", "orthographic"):
        xml = lc.write_lights_scene(str(tmp_path), camera=camera)
        before = ip.LAUNCHES
        img, _ = render(load_scene(xml, params=params, device=cuda)[0], cfg)
        torch.cuda.synchronize()
        assert ip.LAUNCHES - before == cfg.max_depth
        ref, _ = render(load_scene(xml, params=params, device="cpu")[0], cfg)
        assert bool(torch.isfinite(img).all()) and float(ref.mean()) > 0
        assert abs(float(img.mean()) - float(ref.mean())) <= 0.02 * float(
            ref.mean())


@pytest.mark.parametrize("mode", ["none", "mip_filter", "aniso_filter"])
def test_mip_floor_on_the_card_matches_the_cpu(cuda, mode):
    """tests/test_mipmap.py's receding checker floor under each filter on
    the card (#1 a bounce): the image within 1e-3 of the CPU's largest
    pixel on 99% of pixels and its mean within 1%."""
    import torch_bsdf_cases as zc
    import torch_light_cases as lc

    from mitsuba_tpu_torch.integrators import PathConfig, render

    kw = {} if mode == "none" else {mode: True}
    cfg = PathConfig(max_depth=3, spp=2, **kw)
    mods = zc.port_modules()
    before = ip.LAUNCHES
    img, _ = render(lc.mip_floor(mods, 24, 24, device=cuda), cfg, seed=1)
    torch.cuda.synchronize()
    assert ip.LAUNCHES - before == cfg.max_depth
    ref, _ = render(lc.mip_floor(mods, 24, 24, device="cpu"), cfg, seed=1)
    d = (img.cpu() - ref).abs().amax(-1)
    assert float((d <= 1e-3 * float(ref.max())).float().mean()) >= 0.99
    assert abs(float(img.mean()) - float(ref.mean())) <= 0.01 * float(
        ref.mean())


@pytest.mark.parametrize("backend", ["brute", "bvh"])
def test_texel_gradient_on_the_card_matches_the_cpu(cuda, backend):
    """tests/test_grad.py:100's texel gradient on the card (#1, or #11 on
    bvh) within 1e-3 of the CPU's largest entry."""
    import dataclasses

    import torch_bsdf_cases as zc
    import torch_light_cases as lc

    from mitsuba_tpu_torch.integrators import PathConfig, render

    cfg = PathConfig(max_depth=2, spp=4)
    mods = zc.port_modules()

    def grad(device):
        scene = lc.grad_quad(mods, backend=backend, device=device)
        img = scene.textures.images[0].clone().requires_grad_(True)
        t = scene.textures
        scene = dataclasses.replace(scene, textures=dataclasses.replace(
            t, images=(img,)))
        render(scene, cfg, seed=5)[0].mean().backward()
        return img.grad

    g, ref = grad(cuda), grad("cpu")
    assert bool(torch.isfinite(g).all()) and float(ref.abs().max()) > 0
    assert float((g.cpu() - ref).abs().max()) <= 1e-3 * float(
        ref.abs().max())


def test_ptracer_on_the_card_matches_the_cpu_and_repeats(cuda):
    """The particle tracer on the card (#2 a bounce, #3 a bounce and once
    for the origins): two runs equal bit for bit, and the image within
    1e-4 relative of the CPU's on 99% of pixels (its exact splat adds in
    any order; the libraries' sqrt and sin may move a particle)."""
    from mitsuba_tpu_torch.integrators import PathConfig
    from mitsuba_tpu_torch.integrators.ptracer import ptracer_render
    from mitsuba_tpu_torch.render.scene import cornell_box

    cfg = PathConfig(max_depth=3)
    before = dict(ip.SPLIT_LAUNCHES)
    a, _ = ptracer_render(cornell_box(16, 16, device=cuda), cfg, 20_000, 7)
    torch.cuda.synchronize()
    assert ip.SPLIT_LAUNCHES["shaded"] - before["shaded"] == 3
    assert ip.SPLIT_LAUNCHES["any"] - before["any"] == 4
    b, _ = ptracer_render(cornell_box(16, 16, device=cuda), cfg, 20_000, 7)
    assert torch.equal(a, b)
    ref, _ = ptracer_render(cornell_box(16, 16, device="cpu"), cfg, 20_000,
                            7)
    ok = np.isclose(a.cpu().numpy(), ref.numpy(), rtol=1e-4, atol=1e-6)
    assert ok.mean() >= 0.99


@pytest.mark.parametrize("profile", ["dipole", "multipole", "adipole"])
def test_subsurface_slab_on_the_card_matches_the_cpu(cuda, profile):
    """tests/golden_scenes.py:144's slab under each profile on the card:
    the cache's direct NEE one #3 launch a sample (8), its indirect pass
    and the render one #1 launch a bounce (4 x 3 + 4); the cache within
    1e-4 of the CPU's largest point, the image's mean within 2%."""
    import torch_sss_cases as sc

    from mitsuba_tpu_torch.integrators import PathConfig, render
    from mitsuba_tpu_torch.subsurface.dipole import prepare_scene_irradiance

    cfg = PathConfig(max_depth=4, spp=2)
    mods = sc.port_modules()
    scene = sc.slab_scene(mods, 16, profile, n_points=64, device=cuda)
    before, split = ip.LAUNCHES, dict(ip.SPLIT_LAUNCHES)
    img, _ = render(scene, cfg, seed=3)
    torch.cuda.synchronize()
    assert ip.LAUNCHES - before == 4 * 3 + cfg.max_depth
    assert ip.SPLIT_LAUNCHES["any"] - split["any"] == 8
    cpu = sc.slab_scene(mods, 16, profile, n_points=64, device="cpu")
    ref, _ = render(cpu, cfg, seed=3)
    irr = prepare_scene_irradiance(scene, seed=3).irradiance.cpu()
    irr_ref = prepare_scene_irradiance(cpu, seed=3).irradiance
    assert float((irr - irr_ref).abs().max()) <= 1e-4 * float(irr_ref.max())
    assert bool(torch.isfinite(img).all()) and float(ref.mean()) > 0
    assert abs(float(img.mean()) - float(ref.mean())) <= 0.02 * float(
        ref.mean())


def test_guided_render_on_the_card_matches_the_cpu(cuda):
    """render_guided on the Cornell box on the card: one #1 launch a
    bounce in each pass; the learned mass within 1e-4 of the CPU's
    largest bin (index_add adds in atomic order on the card), the image's
    mean within 2%."""
    import dataclasses

    from mitsuba_tpu_torch.integrators import PathConfig, render
    from mitsuba_tpu_torch.integrators.guiding import scene_guide
    from mitsuba_tpu_torch.integrators.path import render_guided
    from mitsuba_tpu_torch.render.scene import cornell_box

    cfg = PathConfig(max_depth=3, spp=4)
    before = ip.LAUNCHES
    img, _ = render_guided(cornell_box(16, 16, device=cuda), cfg, seed=2,
                           res=6)
    torch.cuda.synchronize()
    assert ip.LAUNCHES - before == 2 * cfg.max_depth
    ref, _ = render_guided(cornell_box(16, 16, device="cpu"), cfg, seed=2,
                           res=6)
    assert bool(torch.isfinite(img).all()) and float(ref.mean()) > 0
    assert abs(float(img.mean()) - float(ref.mean())) <= 0.02 * float(
        ref.mean())
    half = dataclasses.replace(cfg, spp=2)
    masses = []
    for dev in (cuda, "cpu"):
        scene = cornell_box(16, 16, device=dev)
        masses.append(render(scene, half, seed=2, guide=scene_guide(
            scene, 6), learn_guide=True)[1]["guide"].mass.cpu())
    assert float(masses[1].max()) > 0
    assert float((masses[0] - masses[1]).abs().max()) <= 1e-4 * float(
        masses[1].max())


def test_motion_file_on_the_card_matches_the_cpu(cuda, tmp_path):
    """A scene file with an animatedinstance under an open shutter through
    the CLI on the card: render_motion's 4 bins, one #1 launch a bounce
    each; the EXR the library's image bit for bit, its mean within 2% of
    the CPU's."""
    import torch_sss_cases as sc

    from mitsuba_tpu_torch.cli import main
    from mitsuba_tpu_torch.core import track
    from mitsuba_tpu_torch.integrators import PathConfig
    from mitsuba_tpu_torch.integrators.path import render_motion
    from mitsuba_tpu_torch.io import bitmap
    from mitsuba_tpu_torch.io.xml import load_scene

    xml = sc.write_motion_xml(str(tmp_path), track)
    params = dict(depth=2, spp=2, width=24, height=24)
    out = str(tmp_path / "m.exr")
    before = ip.LAUNCHES
    assert main(["-q", xml, *[a for k, v in params.items()
                              for a in ("-D", f"{k}={v}")], "-o", out]) == 0
    assert ip.LAUNCHES - before == 4 * 2
    pc = PathConfig(max_depth=2, spp=2, remat=False)
    img, _ = render_motion(load_scene(xml, params=params,
                                      device=cuda)[1]["time_scenes"], pc)
    assert np.array_equal(bitmap.read_exr(out), img.cpu().numpy())
    ref, _ = render_motion(load_scene(xml, params=params,
                                      device="cpu")[1]["time_scenes"], pc)
    assert float(ref.mean()) > 0
    assert abs(float(img.mean()) - float(ref.mean())) <= 0.02 * float(
        ref.mean())


@pytest.mark.parametrize("backend", ["brute", "cluster"])
def test_path_options_on_the_card(cuda, backend):
    """hit_prediction renders the image without it bit for bit on the card
    (the bound is exact); sort_mode="octant" within 1e-6 of "full";
    strict_normals and skip_direct_emission within 2% of the CPU's mean."""
    from mitsuba_tpu_torch.integrators import PathConfig, render
    from mitsuba_tpu_torch.render.scene import cornell_box_specular

    def scene(dev):
        return cornell_box_specular(24, 24, backend=backend, device=dev)

    cfg = PathConfig(max_depth=3, spp=2)
    a, _ = render(scene(cuda), cfg)
    b, aux = render(scene(cuda), PathConfig(max_depth=3, spp=2,
                                            hit_prediction=True))
    assert torch.equal(a, b)
    assert 0.0 <= float(aux["pred_hit_frac"]) <= 1.0
    c, _ = render(scene(cuda), PathConfig(max_depth=3, spp=2,
                                          sort_rays=True, sort_mode="octant"))
    d, _ = render(scene(cuda), PathConfig(max_depth=3, spp=2,
                                          sort_rays=True))
    assert float((c - d).abs().max()) <= 1e-6
    for opt in ("strict_normals", "skip_direct_emission"):
        pc = PathConfig(max_depth=3, spp=2, **{opt: True})
        img, _ = render(scene(cuda), pc)
        ref, _ = render(scene("cpu"), pc)
        assert float(ref.mean()) > 0
        assert abs(float(img.mean()) - float(ref.mean())) <= 0.02 * float(
            ref.mean())


def _launches():
    from mitsuba_tpu_torch.ops import bvh as bp
    from mitsuba_tpu_torch.ops import exact as ep
    from mitsuba_tpu_torch.ops import stream as stp
    from mitsuba_tpu_torch.ops import worklist as wl

    return dict(shaded_any=ip.LAUNCHES, **ip.SPLIT_LAUNCHES, **ep.LAUNCHES,
                stream=stp.LAUNCHES, **bp.LAUNCHES, **wl.LAUNCHES)


# each gradient path off brute: its 32 x 32 scene, and the kernels it
# launches in the forward and again in the backward's recompute (the
# slab's #3 runs in its irradiance cache's direct samples, which no
# bounce's checkpoint holds: in the forward only)
GRAD_PATHS = {
    "bvh": ("mesh", "bvh_closest", "bvh_any"),
    "cluster": ("mesh", "child_refine", "l1_masked"),
    "instanced": ("instanced", "wl_closest", "wl_any"),
    "dipole": ("slab", "shaded_any"),
    "multipole": ("slab", "shaded_any"),
    "adipole": ("slab", "shaded_any"),
    "ptracer": ("ptracer", "shaded", "any"),
}


@pytest.mark.parametrize("path", sorted(GRAD_PATHS))
def test_gradient_paths_on_the_card(cuda, path):
    """tests/torch_grad_cases.py grad_checks on the card at 32 x 32 px, 4
    spp, depth 4, remat on: central differences within 2e-2, linearity in
    radiance within 1e-4, remat on against off within 1e-5 relative, the
    card's gradient within 1e-3 of the CPU's largest entry; the path's
    kernels launched in the forward and in the backward's recompute."""
    import torch_grad_cases as gc
    import torch_sss_cases as sc

    from mitsuba_tpu_torch.integrators import PathConfig
    from mitsuba_tpu_torch.render.scene import cornell_box, instanced_scene

    kind, *kernels = GRAD_PATHS[path]
    loss_fn, fd = gc.mean_l, {}
    if kind == "mesh":
        scene = gc.mesh_scene(gc.port_modules(), 32, path, device=cuda)
    elif kind == "instanced":
        scene = instanced_scene(32, 32, 16, 32, device=cuda)
    elif kind == "slab":
        scene = sc.slab_scene(sc.port_modules(), 32, path, n_points=64,
                              device=cuda)
        loss_fn = gc.cached_mean_l
        fd = dict(fd_table="subsurface", fd_field="sigma_tr", fd_eps=1e-3)
    else:
        scene = cornell_box(32, 32, device=cuda)
        loss_fn = gc.ptracer_mean(1 << 16)
    cfg = PathConfig(max_depth=4, spp=4, remat=True)
    entries = ([(0, c) for c in range(3)] if fd
               else [(0, 0), (1, 1), (1, 2)])
    out, bad = gc.grad_checks(loss_fn, scene, cfg, entries, **fd)
    assert not bad, (bad, out)
    before = _launches()
    refl = scene.materials.reflectance.clone().requires_grad_(True)
    loss = loss_fn(gc.with_field(scene, "materials", reflectance=refl), cfg)
    torch.cuda.synchronize()
    mid = _launches()
    loss.backward()
    torch.cuda.synchronize()
    after = _launches()
    for k in kernels:
        assert mid[k] > before[k] and after[k] > mid[k], (k, before, mid,
                                                           after)
    if kind == "slab":
        assert mid["any"] - before["any"] == 8 and after["any"] == mid["any"]


@pytest.mark.parametrize("profile", ["dipole", "multipole"])
def test_subsurface_gradient_peak_at_full_width(cuda, profile):
    """chip_smoke.py's grad_sss step: the slab at 512 x 512 x 16, depth 4,
    512 cache points, the cache inside the step; the gradient of the
    reflectance, radiance and sigma_tr finite and not zero, the step's
    peak under 40 GiB (the gather's backward recomputes a block of lanes,
    cut by the number of pole pairs, against a point chunk at a time):
    the dipole's one pole pair and the multipole's seven."""
    import torch_grad_cases as gc
    import torch_sss_cases as sc

    from mitsuba_tpu_torch.integrators import PathConfig

    scene = sc.slab_scene(sc.port_modules(), 512, profile, n_points=512,
                          device=cuda)
    cfg = PathConfig(max_depth=4, spp=16, remat=True)
    xs = {}
    for table, field in (("materials", "reflectance"),
                         ("emitters", "radiance"),
                         ("subsurface", "sigma_tr")):
        xs[field] = getattr(getattr(scene, table), field).clone() \
            .requires_grad_(True)
        scene = gc.with_field(scene, table, **{field: xs[field]})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gc.cached_mean_l(scene, cfg).backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for k, x in xs.items():
        assert bool(torch.isfinite(x.grad).all()), k
        assert float(x.grad.abs().max()) > 0, k
    assert peak < 40, peak


def test_spectral_furnace_on_the_card(cuda):
    """tests/test_spectral.py:83's furnace at n = 8 channels on the card,
    brute (16x16 px, 96 spp, depth 3, seed 11): one #1 launch a bounce,
    each channel within 5% of Le_c (1 + a_c + a_c^2)."""
    import torch_bsdf_cases as zc
    import torch_spectral_cases as sc

    from mitsuba_tpu_torch.integrators import PathConfig, render

    a, le = sc.furnace_colours()
    scene = sc.furnace(zc.port_modules(), a, le, device=cuda)
    before = ip.LAUNCHES
    img, _ = render(scene, PathConfig(max_depth=3, spp=96), seed=11)
    torch.cuda.synchronize()
    assert ip.LAUNCHES - before == 3
    assert img.shape == (16, 16, sc.N_CH)
    np.testing.assert_allclose(img.mean(dim=(0, 1)).cpu().numpy(),
                               sc.furnace_expected(a, le, 3), rtol=0.05)


def test_server_round_trip_on_the_card(cuda):
    """A RenderServer on the card: ping reports it, and scenes/cornell.xml
    at 64x64x4 comes back equal to the library's render on the card bit
    for bit, one #1 launch a bounce."""
    import os

    from mitsuba_tpu_torch.integrators import PathConfig, render
    from mitsuba_tpu_torch.io.xml import load_scene
    from mitsuba_tpu_torch.parallel.server import RenderClient, RenderServer

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scenes", "cornell.xml")
    defs = dict(depth=5, spp=4, width=64, height=64)
    srv = RenderServer("127.0.0.1", 0, device=cuda)
    srv.start()
    try:
        with RenderClient("127.0.0.1", srv.port) as c:
            info = c.ping()
            before = ip.LAUNCHES
            with open(path) as f:
                remote = c.render(f.read(), defines=defs,
                                  base_dir=os.path.dirname(path))
            launched = ip.LAUNCHES - before
    finally:
        srv.stop()
    assert info == {"status": "ok", "devices": torch.cuda.device_count(),
                    "backend": "cuda"}
    assert launched == 5
    scene, cfg = load_scene(path, params=defs, device=cuda)
    want, _ = render(scene, PathConfig(max_depth=cfg["maxDepth"],
                                       spp=cfg["sampleCount"], remat=False))
    assert np.array_equal(remote, want.cpu().numpy())


def test_sharded_render_world_one_on_the_card(cuda, tmp_path):
    """render_sharded over an NCCL group of this process alone equals
    render on the card bit for bit (the all-gather a copy)."""
    import torch.distributed as dist

    from mitsuba_tpu_torch.integrators import PathConfig, render
    from mitsuba_tpu_torch.parallel import make_mesh, render_sharded
    from mitsuba_tpu_torch.render.scene import cornell_box

    scene = cornell_box(64, 64, device=cuda)
    cfg = PathConfig(max_depth=5, spp=4, remat=False)
    want, aux = render(scene, cfg, seed=2)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        img, saux = render_sharded(scene, cfg, seed=2, mesh=make_mesh())
    finally:
        dist.destroy_process_group()
    assert torch.equal(img, want)
    assert int(saux["rays_traced"]) == int(aux["rays_traced"])
