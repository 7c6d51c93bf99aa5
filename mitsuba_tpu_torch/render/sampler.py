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
"""
from __future__ import annotations

import torch

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


def uniform(k1, k2, size: int):
    """jax.random.uniform(key, (size,)) per key: (..., size) float32, or
    (...) for size 0 (a scalar draw)."""
    if size == 0:
        counts = torch.zeros((), dtype=torch.int64, device=k1.device)
        b1, b2 = threefry2x32(k1, k2, counts, counts)
        return _bits_to_unit_float(b1 ^ b2)
    hi = torch.zeros(size, dtype=torch.int64, device=k1.device)
    lo = torch.arange(size, dtype=torch.int64, device=k1.device)
    b1, b2 = threefry2x32(k1[..., None], k2[..., None], hi, lo)
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


def sample_position(pattern: str, sample_ids, spp: int, rnd_2d):
    """Sub-pixel sample offset in [0,1)^2 for each lane. Only the
    'independent' pattern is ported."""
    if pattern == "independent":
        return rnd_2d
    raise NotImplementedError(
        f"sample pattern '{pattern}' is not ported (only 'independent')")
