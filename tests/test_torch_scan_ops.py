"""The port's scan entry points (tuun_tpu_torch.engine.scan_ops) on the
CPU, where they take their plain PyTorch versions: held against the JAX
package's Pallas kernels in interpret mode, at tests/test_pallas.py's
shapes, and against float64 sequential references.  The CUDA kernels
behind the same entry points are checked on the card by chip_smoke.py.
"""

import re

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


# ---------------------------------------------------------------------------
# The CUDA prefix kernels' order of operations, modelled on the CPU.
# ---------------------------------------------------------------------------
#
# csrc/scan.cu scans each tile of kScanThreads x kScanItems lanes: each
# thread combines its kScanItems lanes in sequence, a shuffle Kogge-Stone
# scans the thread totals within each warp and then the warp totals, and
# each lane folds in its thread's exclusive prefix, to which the tile's
# carry from the look-back has been folded first.  The look-back's
# grouping is fixed: every kScanThreads-th tile is an anchor, and tile t's
# carry combines the inclusive prefix of the anchor at or before t - 1
# with the aggregates of the tiles after it up to t - 1, one word per
# thread: each warp's shuffle tree folds lane l + d into lane l, then the
# totals of the warps that hold words combine in order.  The bound below
# is chip_smoke.py's, applied to the kernel on the card.


def _scan_geometry():
    src = scan_ops.SOURCE.read_text()
    threads = int(re.search(r"kScanThreads = (\d+);", src).group(1))
    items = int(re.search(r"kScanItems = (\d+);", src).group(1))
    return threads, items


def _sum_op(a, b):
    return a + b


def _max_op(a, b):
    # MaxOp::combine: the later element wins when NaN or >= a non-NaN max.
    return torch.where(torch.isnan(b) | (~torch.isnan(a) & (b >= a)), b, a)


def _kogge_stone(v, combine):
    """Inclusive shuffle scan along the last axis, as __shfl_up_sync
    steps of 1, 2, 4, ... (lane i takes combine(lane i - d, lane i))."""
    d = 1
    while d < v.shape[-1]:
        nv = v.clone()
        nv[..., d:] = combine(v[..., :-d], v[..., d:])
        v = nv
        d *= 2
    return v


def _block_scan(v, combine):
    """block_exclusive_scan over [..., threads]: per-warp inclusive scans
    and the scanned warp totals (the block total is wt[..., -1])."""
    incl = _kogge_stone(v.reshape(*v.shape[:-1], -1, 32), combine)
    return incl, _kogge_stone(incl[..., 31], combine)


def _look_back_fold(words, n_words, combine):
    """look_back's combine of [..., threads] words of which the first
    n_words [...] are real: a shuffle tree per warp (lane l + d folded
    into lane l for d = 1, 2, 4, ...), then the warp totals in order."""
    v = words.reshape(*words.shape[:-1], -1, 32)
    d = 1
    while d < 32:
        nv = v.clone()
        nv[..., :-d] = combine(v[..., :-d], v[..., d:])
        v = nv
        d *= 2
    out = v[..., 0, 0]
    for w in range(1, v.shape[-2]):
        out = torch.where(n_words > 32 * w, combine(out, v[..., w, 0]), out)
    return out


def _tile_prefixes(total, combine, identity, threads):
    """Exclusive prefix of each tile (entry 0 unused) from the tile
    totals, in the look-back's fixed grouping, one anchor span at a time:
    word k of tile t in (a, a + threads] is anchor a's inclusive prefix
    (k = 0) or tile a + k's aggregate (0 < k < t - a)."""
    nb = total.shape[0]
    prefix = total.clone()
    incl_anchor = total[0]
    k = torch.arange(threads)
    for a in range(0, nb - 1, threads):
        ts = torch.arange(a + 1, min(a + threads, nb - 1) + 1)
        words = total[(a + k).clamp(max=nb - 1)].expand(len(ts), threads).clone()
        words[:, 0] = incl_anchor
        words[k[None, :] >= (ts - a)[:, None]] = identity
        prefix[ts] = _look_back_fold(words, ts - a, combine)
        if ts[-1] == a + threads:  # the next anchor's inclusive prefix
            incl_anchor = combine(prefix[a + threads], total[a + threads])
    return prefix


def _model_scan(x, combine, identity):
    threads, items = _scan_geometry()
    tile = threads * items
    n = x.shape[0]
    nb = -(-n // tile)
    xp = torch.full((nb * tile,), identity, dtype=torch.float32)
    xp[:n] = x
    v = xp.view(nb, threads, items)
    cols = [v[..., 0]]
    for k in range(1, items):
        cols.append(combine(cols[-1], v[..., k]))
    it = torch.stack(cols, -1)
    incl, wt = _block_scan(it[..., -1], combine)  # [nb, warps, 32], [nb, warps]
    excl = torch.empty_like(incl)
    excl[..., 1:] = incl[..., :-1]
    excl[:, 1:, 1:] = combine(wt[:, :-1, None], incl[:, 1:, :-1])
    excl[:, 1:, 0] = wt[:, :-1]
    excl = excl.reshape(nb, threads)
    fold = torch.ones(nb, threads, dtype=torch.bool)
    fold[0, 0] = False
    prefix = _tile_prefixes(wt[:, -1], combine, identity, threads)[:, None]
    carry = torch.where(torch.arange(threads) > 0, combine(prefix, excl), prefix)
    carry[0] = excl[0]
    out = torch.where(fold[..., None], combine(carry[..., None], it), it)
    return out.reshape(-1)[:n]


# One lane, one tile, one tile + 1, one anchor span + 1 tile (the last
# tile is the second anchor) and three anchors passed.
MODEL_SIZES = [1, "tile", "tile+1", "span+1", 3 * (1 << 20) + 37]


def _model_n(n):
    threads, items = _scan_geometry()
    tile = threads * items
    return {"tile": tile, "tile+1": tile + 1,
            "span+1": threads * tile + 1}.get(n, n)


@pytest.mark.parametrize("n", MODEL_SIZES)
def test_prefix_sum_kernel_order_within_bound(n):
    n = _model_n(n)
    rng = np.random.default_rng(11)
    x = rng.standard_normal(n).astype(np.float32)
    got = _model_scan(t(x), _sum_op, 0.0).double().numpy()
    ref = np.cumsum(x.astype(np.float64))
    bound = 16 * np.finfo(np.float32).eps * np.cumsum(np.abs(x).astype(np.float64))
    assert np.all(np.abs(got - ref) <= bound), float(np.max(np.abs(got - ref) / bound))


def _max_input(n, rng):
    """Ties, signed zeros, and a NaN: a first part of {-1, -0.5, -0, +0}
    (the running max is a zero whose sign each tie flips), then a rising
    ramp quantised to halves (ties all along), then a NaN near the end."""
    x = np.empty(n, np.float32)
    head = max(n // 3, 1)
    x[:head] = rng.choice(np.array([-1.0, -0.5, -0.0, 0.0], np.float32), head)
    x[head:] = np.round(2 * (rng.standard_normal(n - head)
                             + np.linspace(0, 40, n - head))) / 2
    if n > 8:
        x[n - n // 50 - 1] = np.nan
    return x


@pytest.mark.parametrize("n", MODEL_SIZES)
def test_prefix_max_kernel_order_bitwise_cummax(n):
    n = _model_n(n)
    x = t(_max_input(n, np.random.default_rng(12)))
    got = _model_scan(x, _max_op, float("-inf"))
    want = torch.cummax(x, 0).values
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_prefix_model_matches_plain_scan_exactly_on_integers():
    # Small integers sum exactly in any order: the model's indexing (tile,
    # warp and thread folds, anchors and aggregates) must then reproduce
    # cumsum exactly.
    threads, items = _scan_geometry()
    n = 300 * threads * items + 3
    x = torch.from_numpy(np.random.default_rng(13).integers(
        -8, 9, n).astype(np.float32))
    assert torch.equal(_model_scan(x, _sum_op, 0.0),
                       torch.cumsum(x.double(), 0).float())


# ---------------------------------------------------------------------------
# The prefix wrapper's persistent scratch (plain Python; no card needed).
# ---------------------------------------------------------------------------


def test_prefix_scratch_per_device_and_stream(monkeypatch):
    monkeypatch.setattr(scan_ops, "_scratch", {})
    made = []

    def alloc(device):
        made.append(device)
        return torch.zeros(8, dtype=torch.int64)

    a = scan_ops.prefix_scratch(0, 111, alloc)
    assert scan_ops.prefix_scratch(0, 111, alloc) is a  # kept, never regrown
    b = scan_ops.prefix_scratch(0, 222, alloc)  # another stream
    c = scan_ops.prefix_scratch(1, 111, alloc)  # another device
    assert b is not a and c is not a and c is not b
    assert scan_ops.prefix_scratch(1, 111, alloc) is c
    assert made == [0, 0, 1]
    assert set(scan_ops._scratch) == {(0, 111), (0, 222), (1, 111)}
    # A CPU tensor takes the plain version and touches no scratch.
    scan_ops.prefix_sum_f32(torch.ones(9000))
    scan_ops.prefix_max_f32(torch.ones(9000))
    assert len(made) == 3 and len(scan_ops._scratch) == 3


def test_prefix_scratch_sized_once_from_the_library(monkeypatch):
    # The buffer is the library's word count, whatever length the call
    # that made it scans; making one while a stream captures raises.
    monkeypatch.setattr(scan_ops, "_scratch_words", 37)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    made = []
    monkeypatch.setattr(torch, "zeros", lambda *a, **k: made.append((a, k)))
    scan_ops._zeroed_scratch(3)
    assert made == [((37,), {"dtype": torch.int64, "device": 3})]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="before capturing"):
        scan_ops._zeroed_scratch(3)
    assert len(made) == 1
