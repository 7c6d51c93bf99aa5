"""mitsuba_tpu_torch — the PyTorch / CUDA port of mitsuba_tpu.

The package mirrors the module paths of the JAX package (`mitsuba_tpu`),
which stays the reference it is tested against. It imports `torch` and
never `jax`. Scene tensors live on an explicit device and `render` runs
there; on a CUDA device the ray–triangle intersection goes through a
hand-written kernel (`csrc/intersect_brute.cu`, wrapped by
`ops/intersect.py`), on the CPU through that kernel's plain PyTorch
version.

The slice ported so far is bench config 1: the Cornell box on the brute
backend, traced by the wavefront MIS path tracer (lambertian BSDFs, area
lights, box filter, forward rendering only).
"""

__version__ = "0.1.0"
