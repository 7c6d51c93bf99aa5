"""The port's sharded render and training step (`mitsuba_tpu_torch/
parallel/`, `graft_entry.py`) over torch.distributed on the CPU: gloo
groups of 2 and 4 ranks, spawned by `parallel.mesh.run_group` (a file
rendezvous in a temporary directory), each rank running
tests/torch_parallel_cases.py `rank_checks`.

- `render_sharded` equals the port's `render` within the reference's
  rtol 2e-5 / atol 1e-7 (tests/test_parallel.py:16) on cornell_box(16,
  16) and on tests/test_parallel.py:57's small cluster scene with tiny
  exact-cull caps (Morton lanes, sorted bounces, the XL re-run); every
  rank returns the same image; at world size 1 bit for bit.
- The port's 4-rank image against the reference's `render_sharded` on a
  4-device mesh of the same scene, seed and spp (the reference on its
  kernel path, tests/torch_kernel_path.py): >= 99% of pixels within rtol
  1e-4 and the mean within 1e-3 (tests/test_torch_hetero.py
  assert_lanes_match).
- `training_step_sharded`'s new reflectance at 2 and 4 ranks within 1e-5
  of one process's step on all the lanes, and moved off the old one;
  the same at world size 1.
- `measure_scaling` at world sizes (1, 2) and a finite
  `scaling_efficiency`; `is_coordinator` on rank 0 only; a group of one
  joined by `init_multihost`;
  `dryrun_multichip(n)` on each group, and its refusal of a group with
  fewer ranks.
"""
import concurrent.futures

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from mitsuba_tpu.integrators.path import PathConfig as JaxPathConfig
from mitsuba_tpu.parallel import make_mesh as jax_make_mesh
from mitsuba_tpu.parallel import render_sharded as jax_render_sharded
from mitsuba_tpu.render.scene import cornell_box as jax_cornell_box
from mitsuba_tpu_torch.graft_entry import dryrun_multichip
from mitsuba_tpu_torch.integrators.path import PathConfig, render
from mitsuba_tpu_torch.parallel import (
    init_multihost, is_coordinator, make_mesh, pod_mesh, render_sharded,
    training_step_sharded,
)
from mitsuba_tpu_torch.parallel.mesh import run_group
from mitsuba_tpu_torch.parallel.scaling import (
    measure_scaling, scaling_efficiency,
)
from mitsuba_tpu_torch.render.scene import cornell_box
from tests import torch_parallel_cases as pc
from tests.test_torch_hetero import assert_lanes_match
from tests.torch_kernel_path import kernel_path

torch.set_num_threads(1)
WORLDS = (2, 4)


def _cfg(case):
    _, _, spp, depth, seed = pc.CASES[case]
    return PathConfig(max_depth=depth, spp=spp, remat=False), seed


def _train_cfg():
    return PathConfig(max_depth=pc.TRAIN["depth"], spp=pc.TRAIN["spp"],
                      remat=True)


@pytest.fixture(scope="module")
def groups():
    """{world size: each rank's rank_checks}, the two groups at once."""
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as ex:
        futs = {w: ex.submit(run_group, pc.rank_checks, w, ("cpu",))
                for w in WORLDS}
        return {w: f.result() for w, f in futs.items()}


@pytest.fixture(scope="module")
def singles():
    """The port's one-process renders of each case."""
    out = {}
    for case in pc.CASES:
        cfg, seed = _cfg(case)
        img, aux = render(pc.port_scene(pc.CASES[case], "cpu"), cfg,
                          seed=seed)
        out[case] = (img.numpy(), int(aux["rays_traced"]))
    return out


@pytest.fixture
def world_one(tmp_path):
    """A gloo group of this process alone, joined by init_multihost."""
    init_multihost(f"file://{tmp_path}/rdv", world_size=1, rank=0,
                   backend="gloo")
    try:
        assert is_coordinator() and pod_mesh()[1] == 1
        yield make_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(pc.CASES))
def test_sharded_matches_single(groups, singles, case, world):
    want, rays = singles[case]
    outs = groups[world]
    for out in outs:
        assert out["world"] == world and out["threads"] == 1
        assert np.array_equal(out[case][0], outs[0][case][0])
    np.testing.assert_allclose(outs[0][case][0], want, rtol=2e-5, atol=1e-7)
    assert outs[0][case][1] == rays


def test_world_one_equals_render_bit_for_bit(world_one, singles):
    for case in pc.CASES:
        cfg, seed = _cfg(case)
        img, aux = render_sharded(pc.port_scene(pc.CASES[case], "cpu"), cfg,
                                  seed=seed, mesh=world_one)
        assert np.array_equal(img.numpy(), singles[case][0]), case
        assert int(aux["rays_traced"]) == singles[case][1]
    scene, target, params = pc.training_inputs("cpu")
    new, loss = training_step_sharded(scene, _train_cfg(), target, params,
                                      pc.apply_reflectance,
                                      lr=pc.TRAIN["lr"], mesh=world_one)
    want, want_loss = pc.single_step(scene, _train_cfg(), target, params,
                                     pc.TRAIN["lr"])
    np.testing.assert_allclose(new["reflectance"].numpy(),
                               want["reflectance"].numpy(), rtol=0, atol=1e-5)
    assert abs(float(loss) - float(want_loss)) <= 1e-6 * float(want_loss)
    with pytest.raises(RuntimeError, match="need 2 ranks"):
        dryrun_multichip(2, device="cpu")


@pytest.fixture(scope="module")
def reference_image():
    """The reference's render_sharded of the cornell case on 4 devices,
    on its kernel path."""
    _, res, spp, depth, seed = pc.CASES["cornell"]
    jscene = jax_cornell_box(res, res)
    with pytest.MonkeyPatch.context() as mp:
        kernel_path(mp, jscene.geom)
        img, _ = jax_render_sharded(
            jscene, JaxPathConfig(max_depth=depth, spp=spp, remat=False),
            seed=seed, mesh=jax_make_mesh(jax.devices()[:4]))
    return np.asarray(img)


def test_four_ranks_match_reference_mesh(groups, reference_image):
    got = groups[4][0]["cornell"][0]
    assert got.shape == reference_image.shape and reference_image.mean() > 0
    assert_lanes_match(got.reshape(-1, 3), reference_image.reshape(-1, 3))


@pytest.mark.parametrize("world", WORLDS)
def test_training_step_matches_one_process(groups, world):
    scene, target, params = pc.training_inputs("cpu")
    want, want_loss = pc.single_step(scene, _train_cfg(), target, params,
                                     pc.TRAIN["lr"])
    old = params["reflectance"].numpy()
    for out in groups[world]:
        new, loss = out["train"]
        np.testing.assert_allclose(new, want["reflectance"].numpy(), rtol=0,
                                   atol=1e-5)
        assert np.abs(new - old).max() > 0
        assert np.isfinite(loss) and loss > 0
        assert abs(loss - float(want_loss)) <= 1e-6 * float(want_loss)


@pytest.mark.parametrize("world", WORLDS)
def test_coordinator_is_rank_zero(groups, world):
    assert [o["coordinator"] for o in groups[world]] \
        == [True] + [False] * (world - 1)


def test_scaling_harness_runs():
    res = measure_scaling(cornell_box(16, 16, device="cpu"),
                          PathConfig(max_depth=2, spp=2, remat=False),
                          world_sizes=(1, 2), rows_per_device=8, rounds=1,
                          device="cpu")
    assert set(res) == {1, 2} and all(v > 0 for v in res.values())
    eff = scaling_efficiency(res)
    assert eff[1] == 1.0 and np.isfinite(eff[2]) and eff[2] > 0


def test_lane_split_needs_divisible_lanes(world_one):
    # world 1 divides every lane count; the assertion reads the group
    img, _ = render_sharded(cornell_box(3, 5, device="cpu"),
                            PathConfig(max_depth=1, spp=1), mesh=world_one)
    assert img.shape == (5, 3, 3)
    with pytest.raises(AssertionError, match="divisible by device count 7"):
        render_sharded(cornell_box(3, 5, device="cpu"),
                       PathConfig(max_depth=1, spp=1),
                       mesh=(world_one[0], 7))
