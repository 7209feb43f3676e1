"""noise_torch (the port's counter-hash noise) against the numpy oracle's
noise_np and the JAX engine's noise_jnp, and the port's own copy of
noise_np (its oracle's) against tuun_tpu's: bit-identical, including
seeds and uids with high bits set and indices near 2^31 and 2^32."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tuun_tpu.noisegen import noise_jnp, noise_np
from tuun_tpu_torch.noisegen import noise_np as port_noise_np
from tuun_tpu_torch.noisegen import noise_torch

torch.set_num_threads(1)

CASES = [(0, 0), (42, 7), (0xDEADBEEF, 0xFFFFFFFF), (2 ** 32 - 1, 2 ** 31 + 5),
         (0x80000000, 0x9E3779B9)]


def _indices():
    base = np.arange(4096, dtype=np.int64)
    return np.concatenate([base, base + 2 ** 31 - 2048,
                           base + 2 ** 32 - 4096])


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("seed,uid", CASES)
def test_noise_torch_bit_identical_to_numpy_and_jax(seed, uid):
    idx = _indices()
    want = noise_np(seed, uid, idx.astype(np.uint32))
    got = noise_torch(seed, uid, torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    jx = noise_jnp(jnp.uint32(seed), jnp.uint32(uid),
                   jnp.asarray(idx.astype(np.uint32)))
    np.testing.assert_array_equal(_bits(got), _bits(jx))


@pytest.mark.parametrize("seed,uid", CASES)
def test_port_noise_np_bit_identical_to_tuun_tpu(seed, uid):
    idx = _indices().astype(np.uint32)
    got = port_noise_np(seed, uid, idx)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(_bits(got), _bits(noise_np(seed, uid, idx)))


@pytest.mark.parametrize("seed,uid", CASES[:3])
def test_noise_torch_tensor_seed_matches_int_seed(seed, uid):
    idx = torch.from_numpy(_indices())
    a = noise_torch(seed, uid, idx)
    b = noise_torch(torch.tensor(seed, dtype=torch.int64), uid, idx)
    np.testing.assert_array_equal(_bits(a.numpy()), _bits(b.numpy()))


def test_noise_torch_range():
    y = noise_torch(3, 11, torch.arange(1 << 16))
    assert y.dtype == torch.float32
    assert float(y.min()) >= -1.0 and float(y.max()) < 1.0
