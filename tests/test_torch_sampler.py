"""The port's counter-based Sampler reproduces jax.random bit for bit.

Both samplers get the same lane and sample ids (numpy, fixed seed) and
must return float32 values with identical bits, call after call, so that
a lane of the port draws exactly what the same lane of the JAX package
draws. No tolerance: equality of bits is the contract.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.render.sampler import Sampler as JaxSampler
from mitsuba_tpu_torch.render.sampler import Sampler, sample_position

torch.set_num_threads(1)

# the dimension order the path tracer consumes: render's jitter, then the
# five stacked per-depth fields of path_trace, then one more scalar draw
_CALLS = (("next_2d", ()), ("next_stacked_1d", (5,)),
          ("next_stacked_2d", (5,)), ("next_stacked_2d", (5,)),
          ("next_stacked_1d", (5,)), ("next_stacked_1d", (5,)),
          ("next_1d", ()))


def _ids(seed, n=301):
    rng = np.random.default_rng(seed)
    lanes = rng.integers(0, 2 ** 31 - 1, size=n).astype(np.int32)
    samples = rng.integers(0, 4096, size=n).astype(np.int32)
    lanes[:3] = (0, 1, 2 ** 31 - 1)
    return lanes, samples


@pytest.mark.parametrize("seed", [0, 1, 12345, 2 ** 31 - 1])
def test_sampler_bitwise_equal(seed):
    lanes, samples = _ids(seed % 1000)
    ref = JaxSampler(seed, jnp.asarray(lanes), jnp.asarray(samples))
    port = Sampler(seed, torch.from_numpy(lanes), torch.from_numpy(samples))
    for name, args in _CALLS:
        a = np.asarray(getattr(ref, name)(*args))
        b = getattr(port, name)(*args).numpy()
        assert a.shape == b.shape, name
        assert b.dtype == np.float32
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                      err_msg=name)
        assert (b >= 0.0).all() and (b < 1.0).all()


# seeds at and above 2^31: jax.random.key keeps (0, seed) for them too,
# and the photon walks seed from `seed ^ 0x9E3779B9` and `seed ^ 0xBEEF1234`
HIGH_SEEDS = [2 ** 31, 0x9E3779B9, 0xBEEF1234, 2 ** 32 - 1]


@pytest.mark.parametrize("seed", HIGH_SEEDS)
def test_high_seed_keys_and_draws_equal(seed):
    import jax

    from mitsuba_tpu_torch.render.sampler import key, key_data

    np.testing.assert_array_equal(
        key_data(key(seed)), np.asarray(jax.random.key_data(
            jax.random.key(seed)), np.uint32))
    lanes, samples = _ids(seed % 997)
    ref = JaxSampler(seed, jnp.asarray(lanes), jnp.asarray(samples))
    port = Sampler(seed, torch.from_numpy(lanes), torch.from_numpy(samples))
    for name, args in _CALLS:
        a = np.asarray(getattr(ref, name)(*args))
        b = getattr(port, name)(*args).numpy()
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                      err_msg=name)


def test_unported_sampler_inputs_raise():
    from mitsuba_tpu_torch.render.sampler import key

    ids = torch.arange(4, dtype=torch.int32)
    # outside [0, 2^32) the port refuses the seed
    for seed in (2 ** 32, -1):
        with pytest.raises(NotImplementedError):
            Sampler(seed, ids, ids)
        with pytest.raises(NotImplementedError):
            key(seed)
    # the patterns are ported (tests/test_torch_film.py holds them bit for
    # bit); a name the reference does not know raises as it does there
    with pytest.raises(ValueError):
        sample_position("sobol", ids, 4, torch.zeros(4, 2))
