"""Generate tests/torch_goldens/l1_walks.npz: outputs of the JAX package's
L1 item walks (mitsuba_tpu/ops/exact_pallas.py) in Pallas interpret mode on
the two rows of tests/test_torch_exact.py (`small_scene`, `small_rays`) at
caps (128, 16, 32, 96), with their inputs (`build_exact_l1`, interpreted):

  masked4_closest, masked4_any,   `_call_l1_masked` (v6b) at 4 and 16 L1
  masked16_closest, masked16_any  blocks per step;
  items_closest, items_any        `_call_l1_items` (v6) at the module's 8
                                  L1 blocks per grid step;

and the JAX package's camera hit records (`_ray_intersect_tri`) on the
config-3 slice scene of tests/test_torch_config3.py (`jax_scene`,
`_camera_rays`), as c3_<field>.

Interpreting v6b compiles blm * 8 unrolled Moller-Trumbore items per grid
step; on the CPU the closest mode's compile takes about 10 s at 4 blocks
and over ten minutes at 16, beyond a test's few seconds, so
tests/test_torch_l1_walk.py reads these stored outputs and interprets the
walks live at smaller steps:

    python scripts/gen_torch_l1_golden.py
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from mitsuba_tpu.ops import exact_pallas as jep
from mitsuba_tpu.ops.worklist_pallas import _pack_rays
from mitsuba_tpu.render import intersect as jri
from mitsuba_tpu.render.intersect import build_geometry
from test_torch_config3 import _camera_rays, jax_scene
from test_torch_exact import CAPS, small_rays, small_scene

BLMS = (4, 16)
C3_FIELDS = ("valid", "prim_id", "t", "p", "geo_n", "sh_n", "uv",
             "material_id", "shape_id")
OUT = os.path.join(ROOT, "tests", "torch_goldens", "l1_walks.npz")


def main():
    geom = build_geometry(small_scene(), backend="cluster")
    ex = geom.ex_tables
    rays = _pack_rays(*[jnp.asarray(x) for x in small_rays()])[0]
    l1_ids, l1_keys, ovf = jep.build_exact_l1(rays, ex, CAPS, interpret=True)
    outs = {}
    for any_hit, mode in ((False, "closest"), (True, "any")):
        outs[f"items_{mode}"] = jep._call_l1_items(
            ex["tri"], ex["ct0"], rays, l1_ids, l1_keys, any_hit,
            interpret=True)
        for blm in BLMS:
            outs[f"masked{blm}_{mode}"] = jep._call_l1_masked(
                ex["tri"], rays, l1_ids, l1_keys, any_hit, blm=blm,
                interpret=True)
    js = jax_scene()
    rec = jri._ray_intersect_tri(js.geom, _camera_rays(js, jnp)[0])
    outs.update({f"c3_{k}": getattr(rec, k) for k in C3_FIELDS})
    np.savez_compressed(OUT, l1_ids=np.asarray(l1_ids),
                        l1_keys=np.asarray(l1_keys), overflow=np.asarray(ovf),
                        blms=np.asarray(BLMS), bl=jep.BL,
                        **{k: np.asarray(v) for k, v in outs.items()})
    print("wrote", OUT)


if __name__ == "__main__":
    main()
