"""Counter-based sample generation (port of mitsuba_tpu/render/sampler.py).

Reproduces `jax.random` bit for bit, so that a lane of the port draws the
same numbers as the same lane of the JAX package: keys are threefry2x32
pairs, a lane's key is `fold_in(fold_in(key(seed), lane), sample)` and
dimension k of that lane is drawn from `fold_in(lane_key, k)`. As in
jax 0.9 (`jax_threefry_partitionable=True`), `uniform(key, shape)` hashes
the counters `(0, i)` for i < prod(shape), xors the two output words and
maps the result into [0, 1) through the float mantissa.

uint32 arithmetic is emulated in int64 tensors (masked after every add
and shift), since PyTorch has no full uint32 arithmetic on all devices.
There is no global RNG: a `Sampler` is the explicit generator.

The single keys that media draw from (`jax.random.key`, `split`,
`key_data`, `wrap_key_data`; medium.py:322,574, volpath.py:76,419) are
pairs of Python ints, derived on the host with the same threefry, so a
Woodcock loop costs no device launch to step its key; `uniform_keys`
draws several such keys' counters on the device at once, and `uniform`
any shape per tensor key.

The pixel-sample patterns of the reference's sampler plugins
(src/samplers/: independent, stratified, ldsampler, halton, hammersley)
are `sample_position`, bit for bit with the JAX package's: the same
float32 sums in the same order and the same uint32 xors.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from mitsuba_tpu_torch.core.registry import register_plugin

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 with 20 rounds (jax/_src/prng.py
    _threefry2x32_lowering). All arguments are int64 tensors holding
    uint32 values; they broadcast. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def fold_in(k1, k2, data):
    """jax.random.fold_in: hash the seed pair (0, data) under the key."""
    return threefry2x32(k1, k2, torch.zeros_like(data), data & _MASK)


def _bits_to_unit_float(bits):
    """(bits >> 9) | 0x3F800000 reinterpreted as float32, minus 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(k1, k2, size, start: int = 0):
    """jax.random.uniform(key, (size,)) per key: (..., size) float32, or
    (...) for size 0 (a scalar draw). A tuple `size` is a shape: its
    counters run over the flattened shape, as jax's 2-D iota does
    (prng.py iota_2x32_shape), giving (..., *size). With `start`, the
    elements from flat index `start` on of a longer such draw."""
    if size == 0:
        counts = torch.zeros((), dtype=torch.int64, device=k1.device)
        b1, b2 = threefry2x32(k1, k2, counts, counts)
        return _bits_to_unit_float(b1 ^ b2)
    shape = tuple(size) if isinstance(size, (tuple, list)) else (size,)
    count = math.prod(shape)
    lo = torch.arange(start, start + count, dtype=torch.int64,
                      device=k1.device)
    b1, b2 = threefry2x32(k1[..., None], k2[..., None], 0, lo)
    return _bits_to_unit_float(b1 ^ b2).reshape(k1.shape + shape)


def key(seed: int):
    """jax.random.key(seed): the pair (0, seed) (seeds in [0, 2^31))."""
    if not 0 <= int(seed) < 2 ** 31:
        raise NotImplementedError(
            "seeds outside [0, 2^31) take another key derivation path "
            "in jax.random.key")
    return (0, int(seed))


def fold_in_key(k, data: int):
    """jax.random.fold_in of one host key and an int."""
    return threefry2x32(k[0], k[1], 0, int(data) & _MASK)


def split(k, n: int):
    """jax.random.split(k, n) under jax_threefry_partitionable: key i is
    the hash of the counter pair (0, i) (prng.py
    _threefry_split_foldlike); a list of n host keys."""
    return [threefry2x32(k[0], k[1], 0, i) for i in range(n)]


def key_data(keys) -> np.ndarray:
    """jax.random.key_data: a key, or a list of keys, as uint32 (..., 2)."""
    return np.asarray(keys, np.uint32)


def wrap_key_data(data):
    """jax.random.wrap_key_data: uint32 (2,) -> a key, (n, 2) -> a list."""
    a = np.asarray(data, np.uint32)
    if a.ndim == 1:
        return (int(a[0]), int(a[1]))
    return [(int(x), int(y)) for x, y in a.reshape(-1, 2)]


def uniform_keys(keys, n: int, device=None):
    """jax.random.uniform(k, (n,)) for each host key of `keys`, in one
    threefry pass over the (K, n) counters: (K, n) float32."""
    k1 = torch.tensor([k[0] for k in keys], dtype=torch.int64,
                      device=device)[:, None]
    k2 = torch.tensor([k[1] for k in keys], dtype=torch.int64,
                      device=device)[:, None]
    lo = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k1, k2, 0, lo)
    return _bits_to_unit_float(b1 ^ b2)


class Sampler:
    """Per-lane deterministic random stream with a host-side dimension
    counter; each `next_*` call consumes fresh dimensions in order."""

    def __init__(self, seed: int, lane_ids, sample_ids):
        """lane_ids: (N,) pixel/lane index; sample_ids: (N,) spp index."""
        if not 0 <= int(seed) < 2 ** 31:
            raise NotImplementedError(
                "seeds outside [0, 2^31) take another key derivation path "
                "in jax.random.key")
        lane = lane_ids.to(torch.int64) & _MASK
        sample = sample_ids.to(torch.int64) & _MASK
        k1 = torch.zeros_like(lane)
        k2 = torch.full_like(lane, int(seed))
        k1, k2 = fold_in(k1, k2, lane)
        self._k1, self._k2 = fold_in(k1, k2, sample)
        self._dim = 0

    def _dim_keys(self, d: int):
        """Keys of the next d dimensions, stacked: (d, N) each."""
        dims = torch.arange(self._dim + 1, self._dim + 1 + d,
                            dtype=torch.int64, device=self._k1.device)
        self._dim += d
        return fold_in(self._k1[None], self._k2[None], dims[:, None])

    def next_1d(self):
        k1, k2 = self._dim_keys(1)
        return uniform(k1[0], k2[0], 0)

    def next_2d(self):
        k1, k2 = self._dim_keys(1)
        return uniform(k1[0], k2[0], 2)

    def next_stacked_1d(self, d: int):
        """(d, N) uniforms consuming d dimensions."""
        return uniform(*self._dim_keys(d), 0)

    def next_stacked_2d(self, d: int):
        """(d, N, 2) uniforms consuming d dimensions."""
        return uniform(*self._dim_keys(d), 2)


def _radical_inverse(base: int, idx):
    """Van der Corput radical inverse of the int tensor idx in the given
    base, float32, digit by digit as the JAX package sums it."""
    inv_base = 1.0 / base
    inv32 = np.float32(inv_base)
    result = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
    frac = inv32
    i = idx.to(torch.int64)
    # 32 digits cover idx < base^32 (20 of base 3 cover any int32)
    for _ in range(32 if base == 2 else 20):
        result = result + (i % base).to(torch.float32) * float(frac)
        i = i // base
        frac = np.float32(frac * inv32)
    return result


def _sobol_dirs():
    dirs, v = [], 1 << 31
    for _ in range(32):
        dirs.append(v)
        v ^= v >> 1
    return dirs


_SOBOL_DIR = _sobol_dirs()


def _sobol_2d(idx):
    """The first two dimensions of the Sobol (0,2)-sequence (reference
    ldsampler): the base-2 radical inverse, and the xor of the direction
    numbers of idx's set bits as a uint32 (held in int64) over 2^32."""
    i = idx.to(torch.int64) & _MASK
    y = torch.zeros_like(i)
    for bit, v in enumerate(_SOBOL_DIR):
        y = y ^ (((i >> bit) & 1) * v)
    return torch.stack([_radical_inverse(2, idx),
                        y.to(torch.float32) * (1.0 / 4294967296.0)], -1)


PATTERNS = ("independent", "stratified", "ldsampler", "halton",
            "hammersley")


def sample_position(pattern: str, sample_ids, spp: int, rnd_2d):
    """Sub-pixel sample offset in [0, 1)^2 for each lane.

    sample_ids: (N,) index of the sample within its pixel; rnd_2d: (N, 2)
    uniforms for the jitter of the strata and the Cranley-Patterson
    rotation of the sequences.
    """
    if pattern == "independent":
        return rnd_2d
    if pattern == "stratified":
        res = math.ceil(np.sqrt(np.float32(spp)))   # float32, as in jnp
        sx = (sample_ids % res).to(torch.float32)
        sy = ((sample_ids // res) % res).to(torch.float32)
        return (torch.stack([sx, sy], -1) + rnd_2d) / res
    if pattern == "ldsampler":
        p = _sobol_2d(sample_ids)
    elif pattern == "halton":
        p = torch.stack([_radical_inverse(2, sample_ids),
                         _radical_inverse(3, sample_ids)], -1)
    elif pattern == "hammersley":
        p = torch.stack([sample_ids.to(torch.float32) / max(spp, 1),
                         _radical_inverse(2, sample_ids)], -1)
    else:
        raise ValueError(f"unknown sample pattern '{pattern}'")
    # a Cranley-Patterson rotation a lane keeps pixels decorrelated
    return torch.remainder(p + rnd_2d, 1.0)


for _name in PATTERNS:
    register_plugin("sampler", _name)(
        lambda props, _n=_name: {"pattern": _n,
                                 "spp": int(props.get("sampleCount", 4))})
