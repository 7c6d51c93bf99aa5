"""Run the JAX package's brute queries as its kernel path runs them, for
tests that hold the port's renders lane by lane.

On the CPU the reference's `ray_intersect` takes its own CPU queries,
whose shading frame differs from the kernel path's (ROADMAP C, "two
shading frames"); the port's brute backend builds the kernel path's
frame. `kernel_path(monkeypatch, geom)` makes the reference take its
kernel path, with the kernels' plain references in place of the Pallas
kernels (the CPU queries that tests/test_pallas_intersect.py holds them
to; interpret mode takes ~50 s to compile), as
tests/test_torch_bsdf_zoo.py does for the fused kernel.
"""
import jax

import mitsuba_tpu.render.intersect as jax_intersect
from mitsuba_tpu.ops import intersect_pallas
from mitsuba_tpu.render.records import Ray as JaxRay


def kernel_path(monkeypatch, geom):
    """Patch #1, #2 and #3's entry points for the scene geometry geom."""
    pallas = {"on": True}

    def plain(fn, o, d, mint, maxt):
        pallas["on"] = False
        try:
            # constants of a gradient, as the kernels' outputs are
            return jax.tree_util.tree_map(jax.lax.stop_gradient,
                                          fn(geom, JaxRay(o, d, mint, maxt)))
        finally:
            pallas["on"] = True

    def record(its):
        return dict(t=its.t, prim=its.prim_id, valid=its.valid,
                    geo_n=its.geo_n, sh_n=its.sh_n, uv=its.uv,
                    material_id=its.material_id,
                    emitter_id=its.emitter_id, shape_id=its.shape_id)

    def shaded(table, o, d, mint, maxt, interpret=False):
        return record(plain(jax_intersect._ray_intersect_tri, o, d, mint,
                            maxt))

    def any_hit(table, o, d, mint, maxt, interpret=False):
        return plain(jax_intersect._ray_test_tri, o, d, mint, maxt)

    def shaded_and_any(table, o, d, mint, maxt, so, sd, smint, smaxt,
                       interpret=False):
        return (shaded(table, o, d, mint, maxt),
                any_hit(table, so, sd, smint, smaxt))

    monkeypatch.setattr(jax_intersect, "_use_pallas", lambda: pallas["on"])
    monkeypatch.setattr(intersect_pallas, "closest_hit_shaded", shaded)
    monkeypatch.setattr(intersect_pallas, "any_hit", any_hit)
    monkeypatch.setattr(intersect_pallas, "closest_hit_shaded_and_any",
                        shaded_and_any)


def lanes(w, h, spp, xp):
    """(pixel_id, sample_id, px, py) of render's scanline lanes, in numpy
    (xp = jax.numpy) or torch: ids int32, px and py float32."""
    lane = xp.arange(w * h * spp)
    pid, sid = lane // spp, lane % spp
    if xp.__name__ == "torch":
        return (pid.to(xp.int32), sid.to(xp.int32),
                (pid % w).to(xp.float32), (pid // w).to(xp.float32))
    return (pid.astype(xp.int32), sid.astype(xp.int32),
            (pid % w).astype(xp.float32), (pid // w).astype(xp.float32))
