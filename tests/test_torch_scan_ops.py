"""The port's scan entry points (tuun_tpu_torch.engine.scan_ops) on the
CPU, where they take their plain PyTorch versions: held against the JAX
package's Pallas kernels in interpret mode, at tests/test_pallas.py's
shapes, and against float64 sequential references.  The CUDA kernels
behind the same entry points are checked on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import tuun_tpu.engine.pallas_ops as po
from tuun_tpu_torch.engine import scan_ops

torch.set_num_threads(1)
LANE = po.LANE


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _affine_reference(a, ff, live, h0):
    """float64 sequential recurrence (test_pallas.py's reference)."""
    n, J = a.shape
    h = h0.astype(np.float64).copy()
    ref = np.zeros((n, J))
    for i in range(n):
        if live[i]:
            y = ff[i] - np.dot(a[i], h)
            h = np.concatenate([[y], h[:-1]])
        ref[i] = h
    return ref, h


# Tolerances: the plain prefix sum (torch.cumsum, sequential) and the
# Pallas kernel (Hillis-Steele) round in different orders; at these sizes
# and unit-normal inputs both stay within 1e-5 relative / 1e-4 absolute of
# the float64 sum (test_pallas.py's bound).  The running max is exact.
@pytest.mark.parametrize("n", [LANE, 4 * LANE])
def test_prefix_sum_matches_pallas_and_f64(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n).astype(np.float32)
    got = scan_ops.prefix_sum_f32(t(x)).numpy()
    pallas = np.asarray(po.prefix_sum_f32(jnp.asarray(x), interpret=True))
    np.testing.assert_allclose(got, np.cumsum(x.astype(np.float64)),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n", [LANE, 4 * LANE])
def test_prefix_max_matches_pallas_bitwise(n):
    rng = np.random.default_rng(n + 1)
    x = rng.standard_normal(n).astype(np.float32)
    got = scan_ops.prefix_max_f32(t(x)).numpy()
    pallas = np.asarray(po.prefix_max_f32(jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, np.maximum.accumulate(x))


def test_prefix_multi_chunk_matches_pallas_grid_carry(monkeypatch):
    # The Pallas kernels carry across a sequential grid; force a tiny
    # chunk so interpret mode crosses tiles (test_pallas.py:36-48).
    monkeypatch.setattr(po, "PREFIX_CHUNK", 2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(8 * LANE).astype(np.float32)
    ps = np.asarray(po.prefix_sum_f32(jnp.asarray(x), interpret=True))
    pm = np.asarray(po.prefix_max_f32(jnp.asarray(x), interpret=True))
    np.testing.assert_allclose(scan_ops.prefix_sum_f32(t(x)).numpy(), ps,
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(scan_ops.prefix_max_f32(t(x)).numpy(), pm)


def test_prefix_max_neg_big_sentinel():
    # The reset edge scan feeds sentinel lanes; they must not leak past
    # real values.
    x = np.full(2 * LANE, -3.0e18, np.float32)
    x[5] = 7.0
    x[200] = 9.0
    got = scan_ops.prefix_max_f32(t(x)).numpy()
    pallas = np.asarray(po.prefix_max_f32(jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, np.maximum.accumulate(x))


@pytest.mark.parametrize("n", [1, 5, 100, 1000, 3 * LANE + 37])
def test_prefix_ragged_lengths_against_f64(n):
    # The JAX kernels take only multiples of 128; the port takes any n.
    rng = np.random.default_rng(n + 7)
    x = rng.standard_normal(n).astype(np.float32)
    np.testing.assert_allclose(scan_ops.prefix_sum_f32(t(x)).numpy(),
                               np.cumsum(x.astype(np.float64)),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(scan_ops.prefix_max_f32(t(x)).numpy(),
                                  np.maximum.accumulate(x))


def _affine_inputs(n, J, seed, live_frac=0.2):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((n, J)) * 0.3).astype(np.float32)
    ff = rng.standard_normal(n).astype(np.float32)
    live = rng.random(n) > live_frac
    h0 = rng.standard_normal(J).astype(np.float32)
    return a, ff, live, h0


# Tolerance 1e-4 (rtol and atol): float32 compositions of contracting
# random maps (|a| ~ 0.3) against the float64 recurrence, as
# test_pallas.py pins the Pallas kernel.
@pytest.mark.parametrize("n,J", [(LANE, 1), (2 * LANE, 2), (4 * LANE, 3)])
def test_affine_scan_matches_pallas_and_sequential(n, J):
    a, ff, live, h0 = _affine_inputs(n, J, n + J)
    hs, hist = scan_ops.affine_scan_f32(t(a), t(ff), t(live), t(h0))
    ref, h_end = _affine_reference(a, ff, live, h0)
    np.testing.assert_allclose(hs.numpy(), ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(hist.numpy(), h_end, rtol=1e-4, atol=1e-4)
    ph, phist = po.affine_scan_f32(jnp.asarray(a), jnp.asarray(ff),
                                   jnp.asarray(live), jnp.asarray(h0),
                                   interpret=True)
    np.testing.assert_allclose(hs.numpy(), np.asarray(ph), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(hist.numpy(), np.asarray(phist), rtol=1e-4,
                               atol=1e-4)


def test_affine_scan_multi_tile_matches_pallas(monkeypatch):
    monkeypatch.setattr(po, "AFFINE_CHUNK", 2)
    n, J = 4 * LANE, 2
    a, ff, _, _ = _affine_inputs(n, J, 9)
    live = np.ones(n, bool)
    h0 = np.array([0.5, -0.25], np.float32)
    hs, hist = scan_ops.affine_scan_f32(t(a), t(ff), t(live), t(h0))
    ph, phist = po.affine_scan_f32(jnp.asarray(a), jnp.asarray(ff),
                                   jnp.asarray(live), jnp.asarray(h0),
                                   interpret=True)
    np.testing.assert_allclose(hs.numpy(), np.asarray(ph), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(hist.numpy(), np.asarray(phist), rtol=1e-4,
                               atol=1e-4)


def test_affine_scan_all_dead_lanes_pass_history_through():
    n, J = LANE, 2
    a = np.full((n, J), 0.9, np.float32)
    ff = np.ones(n, np.float32)
    live = np.zeros(n, bool)
    h0 = np.array([3.0, -2.0], np.float32)
    hs, hist = scan_ops.affine_scan_f32(t(a), t(ff), t(live), t(h0))
    np.testing.assert_array_equal(hs.numpy(), np.broadcast_to(h0, (n, J)))
    np.testing.assert_array_equal(hist.numpy(), h0)


@pytest.mark.parametrize("n,J", [(1, 1), (5, 2), (300, 3), (1000, 8)])
def test_affine_scan_ragged_and_deep_against_f64(n, J):
    # Beyond the JAX kernel's domain (n % 128 == 0, J <= 4).
    a, ff, live, h0 = _affine_inputs(n, J, 100 + n + J)
    hs, hist = scan_ops.affine_scan_f32(t(a), t(ff), t(live), t(h0))
    ref, h_end = _affine_reference(a, ff, live, h0)
    np.testing.assert_allclose(hs.numpy(), ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(hist.numpy(), h_end, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fn", [scan_ops.prefix_sum_f32,
                                scan_ops.prefix_max_f32])
def test_prefix_wrappers_reject_bad_inputs(fn):
    with pytest.raises(ValueError):
        fn(torch.zeros(8, dtype=torch.float64))
    with pytest.raises(ValueError):
        fn(torch.zeros((2, 4)))
    with pytest.raises(ValueError):
        fn(torch.zeros(0))
    with pytest.raises(ValueError):
        fn(torch.zeros(16)[::2])  # not contiguous


def test_affine_wrapper_rejects_bad_inputs():
    n, J = 8, 2
    a, ff, live, h0 = (torch.zeros(n, J), torch.zeros(n),
                       torch.ones(n, dtype=torch.bool), torch.zeros(J))
    with pytest.raises(ValueError):
        scan_ops.affine_scan_f32(a.double(), ff, live, h0)
    with pytest.raises(ValueError):
        scan_ops.affine_scan_f32(a, ff[:4], live, h0)
    with pytest.raises(ValueError):
        scan_ops.affine_scan_f32(a, ff, live.float(), h0)
    with pytest.raises(ValueError):
        scan_ops.affine_scan_f32(a, ff, live, torch.zeros(3))
    with pytest.raises(NotImplementedError):
        scan_ops.affine_scan_f32(torch.zeros(n, 9), ff, live, torch.zeros(9))
