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
from tuun_tpu_torch.engine import kernels, lane_ops, scan_ops

torch.set_num_threads(1)
LANE = po.LANE


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _affine_reference(a, ff, live, h0):
    """float64 sequential recurrence (test_pallas.py's reference): (h [n,
    J], the history after each lane; the final history)."""
    n, J = a.shape
    h = h0.astype(np.float64).copy()
    ref = np.zeros((n, J))
    for i in range(n):
        if live[i]:
            y = ff[i] - np.dot(a[i], h)
            h = np.concatenate([[y], h[:-1]])
        ref[i] = h
    return ref, h


def _masked_y(h, live):
    """The affine scan's y from the Pallas contract's h: h[:, 0] on live
    lanes, 0 on dead ones."""
    return np.where(live, np.asarray(h)[..., 0], 0.0)


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
    y, hist = scan_ops.affine_scan_f32(t(a), t(ff), t(live), t(h0))
    ref, h_end = _affine_reference(a, ff, live, h0)
    np.testing.assert_allclose(y.numpy(), _masked_y(ref, live), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(hist.numpy(), h_end, rtol=1e-4, atol=1e-4)
    ph, phist = po.affine_scan_f32(jnp.asarray(a), jnp.asarray(ff),
                                   jnp.asarray(live), jnp.asarray(h0),
                                   interpret=True)
    np.testing.assert_allclose(y.numpy(), _masked_y(ph, live), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(hist.numpy(), np.asarray(phist), rtol=1e-4,
                               atol=1e-4)


def test_affine_scan_multi_tile_matches_pallas(monkeypatch):
    monkeypatch.setattr(po, "AFFINE_CHUNK", 2)
    n, J = 4 * LANE, 2
    a, ff, _, _ = _affine_inputs(n, J, 9)
    live = np.ones(n, bool)
    h0 = np.array([0.5, -0.25], np.float32)
    y, hist = scan_ops.affine_scan_f32(t(a), t(ff), t(live), t(h0))
    ph, phist = po.affine_scan_f32(jnp.asarray(a), jnp.asarray(ff),
                                   jnp.asarray(live), jnp.asarray(h0),
                                   interpret=True)
    np.testing.assert_allclose(y.numpy(), _masked_y(ph, live), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(hist.numpy(), np.asarray(phist), rtol=1e-4,
                               atol=1e-4)


def test_affine_scan_all_dead_lanes_pass_history_through():
    n, J = LANE, 2
    a = np.full((n, J), 0.9, np.float32)
    ff = np.ones(n, np.float32)
    live = np.zeros(n, bool)
    h0 = np.array([3.0, -2.0], np.float32)
    y, hist = scan_ops.affine_scan_f32(t(a), t(ff), t(live), t(h0))
    np.testing.assert_array_equal(y.numpy(), np.zeros(n, np.float32))
    np.testing.assert_array_equal(hist.numpy(), h0)


@pytest.mark.parametrize("n,J", [(1, 1), (5, 2), (300, 3), (1000, 8)])
def test_affine_scan_ragged_and_deep_against_f64(n, J):
    # Beyond the JAX kernel's domain (n % 128 == 0, J <= 4).
    a, ff, live, h0 = _affine_inputs(n, J, 100 + n + J)
    y, hist = scan_ops.affine_scan_f32(t(a), t(ff), t(live), t(h0))
    ref, h_end = _affine_reference(a, ff, live, h0)
    np.testing.assert_allclose(y.numpy(), _masked_y(ref, live), rtol=1e-4,
                               atol=1e-4)
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
    src = kernels.SOURCE.read_text()
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


# ---------------------------------------------------------------------------
# The CUDA affine scan's tiles, record tree and look-back, modelled on the
# CPU.
# ---------------------------------------------------------------------------
#
# csrc/scan.cu's affine_scan_pass runs a tile of W warps x G segments of S
# lanes a block.  Each segment's four threads build its map column by
# column (column c < J pushes the basis history e_c with ff = 0, column J
# pushes ff from a zero history, four partial sums a step), keeping the
# columns after each quarter of the segment as the quarters' maps.  Each
# warp scans its G segment maps (Kogge-Stone, inclusive), warp 0 scans the
# warp totals; the last is the tile's map.  The look-back reads a tree of
# records with fan F: record (l, k) is the map of tiles [k F^l, (k + 1)
# F^l), published by tile (k + 1) F^l - 1 (its map after the folds of its
# lower levels) unless no later tile reads it; tile t reads level l's
# records t_l - d_l .. t_l - 1 (d_l its base-F digit), folds them by a
# Blelloch up-sweep padded with identities in front, and applies the
# folds to h0, the highest level first.  A record's words carry the stamp
# of the call that wrote them; the block that draws the last tile resets
# the counter and advances the epoch.  Each thread's quarter enters with
# the tile's history with the warps' scanned total before it, the warp's
# scanned segment map before it and its quarter map applied in turn, and
# runs the recurrence over its S / 4 lanes.  The model runs the tiles as
# coroutines over a model of the scratch, in any order of finishing.


def _aff_constants():
    src = kernels.SOURCE.read_text()

    def get(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    seg, quad, heads = get("kAffSeg"), get("kAffQuad"), get("kAffHeadWords")
    warps = get("kAffWarps")
    assert seg * 32 // quad * warps == scan_ops.AFFINE_TILE
    return seg, quad, 32 // quad, get("kMaxJ") * (get("kMaxJ") + 1), heads, \
        warps


def _kernel_geometry(n):
    """(S, G, W, F) of the kernel for rows of n lanes."""
    seg, _, per_warp, _, _, warps = _aff_constants()
    return seg, per_warp, warps, scan_ops.affine_fan(n)


def _aff_scratch_words(records):
    """tuun_affine_scratch_words: the head, then a record of kAffRecord
    64-bit words a slot."""
    _, _, _, record, head, _ = _aff_constants()
    return head + 2 * record * records


def _compose(cur, prev):
    """cur after prev, batched: maps are (A [..., J, J], b [..., J])."""
    return cur[0] @ prev[0], (cur[0] @ prev[1][..., None])[..., 0] + cur[1]


def _identity(shape, J, dtype):
    return (np.broadcast_to(np.eye(J, dtype=dtype), shape + (J, J)).copy(),
            np.zeros(shape + (J,), dtype))


def _take(m, idx):
    return m[0][idx], m[1][idx]


def _apply(m, h):
    """m(h), each row's products added in order (aff_apply)."""
    A, b = m
    out = b.copy()
    for c in range(h.shape[-1]):
        out = out + A[..., :, c] * h[..., None, c]
    return out


def _kogge_stone_maps(m):
    """Inclusive scan along the second-last map axis: map s takes
    compose(s, s - d) for d = 1, 2, 4, ... (aff_scan)."""
    A, b = m
    n = A.shape[-3]
    d = 1
    while d < n:
        nA, nb_ = A.copy(), b.copy()
        nA[..., d:, :, :], nb_[..., d:, :] = _compose(
            (A[..., d:, :, :], b[..., d:, :]),
            (A[..., :-d, :, :], b[..., :-d, :]))
        A, b = nA, nb_
        d *= 2
    return A, b


def _up_sweep_fold(maps):
    """The fold of a list of maps (a power of two of them) by aff_fold's
    Blelloch up-sweep: map R = (2p + 2) d - 1 becomes R after R - d."""
    A = np.stack([m[0] for m in maps])
    b = np.stack([m[1] for m in maps])
    d = 1
    while d < len(maps):
        R = np.arange(2 * d - 1, len(maps), 2 * d)
        A[R], b[R] = _compose((A[R], b[R]), (A[R - d], b[R - d]))
        d *= 2
    return A[-1], b[-1]


def _affine_model(a, ff, live, h0, geom, order=None, dtype=np.float64,
                  scratch=None):
    """(y, hist, scratch) as affine_scan_pass computes them with geometry
    geom = (S lanes a segment, G segments a warp, W warps, F fan),
    finishing its steps in the order `order` picks (a function of the
    runnable tiles), in `dtype`.  Inputs with a leading row axis (a [B, n,
    J], ff and live [B, n], h0 [B, J]) model the voices x lanes form:
    global tile g is tile g % nbr of row g // nbr, one scratch for all
    rows.  `scratch` (counter, epoch, records) carries over from an
    earlier call, as the stream's buffer does."""
    rows = a.ndim == 3
    if not rows:
        a, ff, live, h0 = a[None], ff[None], live[None], h0[None]
    S, G, W, F = geom
    quarters = _aff_constants()[1]
    quarter = S // quarters
    segs = G * W
    tile = S * segs
    B, n, J = a.shape
    nbr = -(-n // tile)
    nb = B * nbr
    pad = nbr * tile - n
    a = np.concatenate([a, np.zeros((B, pad, J))], 1).astype(dtype)
    ff = np.concatenate([ff, np.zeros((B, pad))], 1).astype(dtype)
    live = np.concatenate([live, np.zeros((B, pad), bool)], 1)
    h0 = h0.astype(dtype)
    a4 = a.reshape(nb, segs, S, J)
    f3 = ff.reshape(nb, segs, S)
    l3 = live.reshape(nb, segs, S)

    # Column build: H[..., c, :] is column c's history; four partial sums.
    H = np.zeros((nb, segs, J + 1, J), dtype)
    H[..., :J, :] = np.eye(J, dtype=dtype)
    ck = []
    for i in range(S):
        p = np.zeros((nb, segs, J + 1, 4), dtype)
        p[..., J, 0] = f3[..., i]
        for j in range(J):
            p[..., j & 3] = p[..., j & 3] - a4[..., i, j][..., None] * H[..., j]
        y = (p[..., 0] + p[..., 1]) + (p[..., 2] + p[..., 3])
        shifted = np.concatenate([y[..., None], H[..., :-1]], axis=-1)
        H = np.where(l3[..., i, None, None], shifted, H)
        if (i + 1) % quarter == 0 and i + 1 < S:
            ck.append(H.copy())

    def as_map(h):  # columns -> (A, b): A[:, c] is column c
        return np.swapaxes(h[..., :J, :], -1, -2).copy(), h[..., J, :].copy()

    seg_maps = as_map(H)
    quarter_maps = [as_map(c) for c in ck]
    # Each warp's inclusive scan, then the warp totals'.
    wm = _kogge_stone_maps((seg_maps[0].reshape(nb, W, G, J, J),
                            seg_maps[1].reshape(nb, W, G, J)))
    totals = _kogge_stone_maps(_take(wm, (slice(None), slice(None), G - 1)))
    tile_maps = _take(totals, (slice(None), W - 1))

    # The look-back, each tile a coroutine over the model scratch.
    if scratch is None:
        scratch = {"counter": 0, "epoch": 0, "records": {}}
    per_row, c = 0, nbr  # the row's slots: nbr / F^l at each level l
    while c:
        per_row, c = per_row + c, c // F
    h_tile = np.zeros((nb, J), dtype)
    eye = _identity((), J, dtype)

    def run(g):
        # Yields True after a step that may unblock another tile, False
        # while it waits.
        r, t = divmod(g, nbr)
        if nbr == 1:
            h_tile[g] = h0[r]
            return
        if scratch["counter"] == nb - 1:  # the last draw readies the next call
            stamp = 2 * scratch["epoch"] + 1
            scratch["counter"], scratch["epoch"] = 0, scratch["epoch"] + 1
        else:
            stamp = 2 * scratch["epoch"] + 1
            scratch["counter"] += 1
        R = _take(tile_maps, g)
        chain, tl, off, count, level = True, t, 0, nbr, 0
        folds = {}
        while tl > 0 or chain:
            d = tl % F
            if chain and d != F - 1:
                chain = False
                if t + 1 < nbr:
                    scratch["records"][r * per_row + off + tl] = (R, stamp)
                    yield True
            if d > 0:
                slots = [r * per_row + off + tl - d + e for e in range(d)]
                while not all(scratch["records"].get(s_, (None, 0))[1]
                              == stamp for s_ in slots):
                    yield False
                P = 1
                while P < d:
                    P *= 2
                folds[level] = _up_sweep_fold(
                    [eye] * (P - d) + [scratch["records"][s_][0]
                                       for s_ in slots])
            if chain:
                R = _compose(R, folds[level])
            off += count
            count //= F
            tl //= F
            level += 1
        h = h0[r]
        for lv in reversed(range(level)):
            if (t // F ** lv) % F:
                h = _apply(folds[lv], h)
        h_tile[g] = h

    runnable = {g: run(g) for g in range(nb)}
    waiting = set()
    while runnable:
        ready = sorted(set(runnable) - waiting)
        g = order(ready) if order else ready[0]
        try:
            progressed = next(runnable[g])
        except StopIteration:
            del runnable[g]
            progressed = True
        if progressed:
            waiting.clear()
        else:
            waiting.add(g)

    # Each quarter's entering history, then its recurrence.
    h = np.broadcast_to(h_tile[:, None, None, None, :],
                        (nb, W, G, quarters, J)).copy()
    tA = totals[0][:, :-1, None, None]
    tb = totals[1][:, :-1, None, None]
    h[:, 1:] = _apply((tA, tb), h[:, 1:])
    sA = wm[0][:, :, :-1, None]
    sb = wm[1][:, :, :-1, None]
    h[:, :, 1:] = _apply((sA, sb), h[:, :, 1:])
    h = h.reshape(nb, segs, quarters, J)
    for q in range(1, quarters):
        h[:, :, q] = _apply(quarter_maps[q - 1], h[:, :, q])
    y = np.zeros((nb, segs, S), dtype)
    hist = np.zeros((B, J), dtype)
    for q in range(quarters):
        hv = h[:, :, q]
        for x in range(quarter):
            i = q * quarter + x
            yv = f3[..., i].copy()
            for j in range(J):
                yv = yv - a4[..., i, j] * hv[..., j]
            lv = l3[..., i]
            shifted = np.concatenate([yv[..., None], hv[..., :-1]], axis=-1)
            hv = np.where(lv[..., None], shifted, hv)
            y[..., i] = np.where(lv, yv, 0)
        # The quarter that holds lane n - 1 writes hist.
        last = n - 1 - (nbr - 1) * tile
        if last // quarter % quarters == q:
            hist = hv.reshape(B, nbr, segs, J)[:, -1, last // S].copy()
    y = y.reshape(B, nbr * tile)[:, :n]
    if not rows:
        y, hist = y[0], hist[0]
    return y, hist, scratch


def _stable_inputs(n, J, seed):
    """Time-varying all-pole sections near a stable one (real poles 0.9,
    0.8, 0.7, -0.6, ...), 20% dead lanes."""
    rng = np.random.default_rng(seed)
    base = np.poly([0.9, 0.8, 0.7, -0.6, 0.5, -0.4, 0.3, -0.2][:J])[1:]
    a = (base + 1e-3 * rng.standard_normal((n, J))).astype(np.float32)
    ff = rng.standard_normal(n).astype(np.float32)
    live = rng.random(n) > 0.2
    h0 = rng.standard_normal(J).astype(np.float32)
    return a, ff, live, h0


# The kernel's geometry at each length, and a small one (segments of 8
# lanes, two of them a warp, two warps: 32-lane tiles, fan 4) whose record
# tree reaches three levels in a few thousand lanes.
KERNEL_GEOMETRY = "kernel"
SMALL_GEOMETRY = (8, 2, 2, 4)


def _geometry(geom, n):
    return _kernel_geometry(n) if geom == KERNEL_GEOMETRY else geom


def _aff_lengths(geom):
    S, G, W, F = _geometry(geom, 1)
    tile = S * G * W
    # One lane, one tile, one tile + 1, a ragged tail; for the small
    # geometry a full fan group + 1 and three levels with a ragged tail.
    out = [1, tile, tile + 1, 3 * tile + 37]
    if geom == SMALL_GEOMETRY:
        out += [F * tile + 1, 2 * F * F * tile + 3 * tile + 5]
    return out


AFFINE_MODEL_CASES = [(J, geom, n) for J in (1, 2, 3, 5, 8)
                      for geom in (KERNEL_GEOMETRY, SMALL_GEOMETRY)
                      for n in _aff_lengths(geom)]


def _y_ref(a, ff, live, h0, dtype=torch.float64):
    y, hist = scan_ops.affine_y_ref(t(a).to(dtype), t(ff).to(dtype), t(live),
                                    t(h0).to(dtype))
    return y.numpy(), hist.numpy()


@pytest.mark.parametrize("J,geom,n", AFFINE_MODEL_CASES)
def test_affine_kernel_model_matches_reference(J, geom, n):
    # Tolerances: in float64 the model and the doubling reference differ
    # only by rounding (1e-9 of the output's scale).  The Pallas kernel
    # (interpret mode; n % 128 == 0 and J <= 3 only) composes in float32,
    # which these near-repeated poles amplify: y against its h[:, 0] on live
    # lanes and hist against its hist, within chip_smoke.py's per-J bounds
    # for a float32 kernel, as fractions of the scale.
    a, ff, live, h0 = _stable_inputs(n, J, 7 * J + n)
    y, hist, scratch = _affine_model(a, ff, live, h0, _geometry(geom, n))
    ry, rh = _y_ref(a, ff, live, h0)
    scale = max(1.0, float(np.abs(ry).max()))
    np.testing.assert_allclose(y, ry, rtol=0, atol=1e-9 * scale)
    np.testing.assert_allclose(hist, rh, rtol=0, atol=1e-9 * scale)
    assert scratch["counter"] == 0
    if J <= 3 and n % LANE == 0 and n <= 4096:
        ph, phist = po.affine_scan_f32(jnp.asarray(a), jnp.asarray(ff),
                                       jnp.asarray(live), jnp.asarray(h0),
                                       interpret=True)
        py = np.where(live, np.asarray(ph)[:, 0], 0)
        bound = {1: 1e-6, 2: 1e-5, 3: 1e-3}[J] * scale
        np.testing.assert_allclose(y, py, rtol=0, atol=bound)
        np.testing.assert_allclose(hist, np.asarray(phist), rtol=0,
                                   atol=bound)


@pytest.mark.parametrize("J", [2, 3])
def test_affine_kernel_grouping_independent_of_finish_order(J):
    # float32, so that any change of grouping would change bits: tiles
    # stepping in order, in reverse, and in two random orders, over three
    # levels of records and a ragged tail.
    S, G, W, F = SMALL_GEOMETRY
    n = 2 * F * F * S * G * W + 3 * S * G * W + 5
    a, ff, live, h0 = _stable_inputs(n, J, 5)
    rng = np.random.default_rng(1)
    orders = [None, max, lambda ts: ts[rng.integers(len(ts))],
              lambda ts: ts[-1 - rng.integers(min(len(ts), 3))]]
    outs = [_affine_model(a, ff, live, h0, SMALL_GEOMETRY, order,
                          np.float32)[:2] for order in orders]
    for y, hist in outs[1:]:
        assert y.tobytes() == outs[0][0].tobytes()
        assert hist.tobytes() == outs[0][1].tobytes()


@pytest.mark.parametrize("J", [1, 2, 8])
def test_affine_kernel_second_call_ignores_stale_records(J):
    # A second call on the same scratch (the next call on a stream, or a
    # graph's next replay) sees the counter the first one reset and a new
    # epoch: its tiles wait for this call's records, never the first's,
    # whatever order they finish in, and give the same bits.
    S, G, W, F = SMALL_GEOMETRY
    n = F * F * S * G * W + 7
    a, ff, live, h0 = _stable_inputs(n, J, 11)
    y1, hist1, scratch = _affine_model(a, ff, live, h0, SMALL_GEOMETRY,
                                       dtype=np.float32)
    assert scratch["counter"] == 0 and scratch["epoch"] == 1
    y2, hist2, scratch = _affine_model(a, ff, live, h0, SMALL_GEOMETRY, max,
                                       np.float32, scratch)
    assert scratch["counter"] == 0 and scratch["epoch"] == 2
    assert y1.tobytes() == y2.tobytes() and hist1.tobytes() == hist2.tobytes()


def test_affine_geometry_crossovers_match_reference():
    # The kernel's look-back fan changes past 65536 lanes and it needs a
    # look-back past one tile: the model at each side of both, J = 2.
    tile = scan_ops.AFFINE_TILE
    cross = [n for n in range(2, 1 << 18)
             if scan_ops.affine_fan(n) != scan_ops.affine_fan(n - 1)]
    assert cross == [(1 << 16) + 1]
    for n in [tile, tile + 1] + [c + k for c in cross for k in (-1, 0)]:
        a, ff, live, h0 = _stable_inputs(n, 2, n)
        y, hist, _ = _affine_model(a, ff, live, h0, _kernel_geometry(n))
        ry, rh = _y_ref(a, ff, live, h0)
        scale = max(1.0, float(np.abs(ry).max()))
        np.testing.assert_allclose(y, ry, rtol=0, atol=1e-9 * scale)
        np.testing.assert_allclose(hist, rh, rtol=0, atol=1e-9 * scale)


def test_affine_capacity_never_falls_as_n_grows():
    # Capture needs scratch for the most records a length takes: a warm-up
    # at the longest length must cover every shorter one.
    prev = 0
    for n in list(range(1, 5000, 7)) + list(range(60000, 140000, 97)):
        cap = scan_ops.affine_capacity(3, n)
        assert cap >= prev and cap >= 3 * scan_ops.affine_slots(
            n, scan_ops.affine_fan(n))
        prev = cap


def test_affine_scratch_words_hold_every_tile():
    # The scratch for `records` records: the head, then a record of
    # kMaxJ (kMaxJ + 1) 64-bit words each (A and b at any J up to 8), on
    # 8-byte boundaries; the slots a row takes, level by level.
    _, _, _, record, head, _ = _aff_constants()
    assert record == 72 and head % 2 == 0
    for records in (1, 2, 3, 1000):
        assert _aff_scratch_words(records) == head + 144 * records
    for J in range(1, scan_ops.MAX_J + 1):
        assert J * (J + 1) <= record
    assert scan_ops.affine_slots(1 << 16, 64) == 64 + 1
    assert scan_ops.affine_slots(1 << 20, 32) == 1024 + 32 + 1
    assert scan_ops.affine_slots(1024, 32) == 1


def test_affine_scratch_grows_by_a_new_buffer_and_keeps_the_old(monkeypatch):
    monkeypatch.setattr(scan_ops, "_affine_scratch", {})
    monkeypatch.setattr(scan_ops, "_affine_retired", [])
    made = []

    def alloc(device, records):
        made.append((device, records))
        return torch.zeros(4, dtype=torch.int32)

    # The first buffer holds the records of 2^20 lanes.
    first = scan_ops.affine_capacity(1, 1 << 20)
    buf, cap = scan_ops.affine_scratch(0, 7, 32, alloc)
    assert cap == first and made == [(0, first)]
    assert scan_ops.affine_scratch(0, 7, first, alloc) == (buf, cap)
    buf2, cap2 = scan_ops.affine_scratch(0, 7, first + 1, alloc)
    assert cap2 == 2 * first and buf2 is not buf
    assert scan_ops._affine_retired == [buf]  # kept, never freed
    buf3, cap3 = scan_ops.affine_scratch(0, 7, 5 * first, alloc)
    assert cap3 == 5 * first and scan_ops._affine_retired == [buf, buf2]
    other, _ = scan_ops.affine_scratch(0, 8, 2, alloc)  # another stream
    assert other is not buf3 and made[-1] == (0, first)
    assert set(scan_ops._affine_scratch) == {(0, 7), (0, 8)}
    # A CPU tensor takes the plain version and touches no scratch.
    a, ff, live, h0 = _stable_inputs(5000, 2, 3)
    scan_ops.affine_scan_f32(t(a), t(ff), t(live), t(h0))
    assert len(made) == 4


def test_affine_scratch_made_during_capture_raises(monkeypatch):
    monkeypatch.setattr(scan_ops, "_affine_scratch", {})

    class Lib:
        @staticmethod
        def tuun_affine_scratch_words(records):
            return _aff_scratch_words(records)

    monkeypatch.setattr(scan_ops, "load_library", lambda: Lib)
    made = []
    monkeypatch.setattr(torch, "zeros", lambda *a, **k: made.append((a, k)))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    scan_ops.affine_scratch(3, 9, 10)
    first = scan_ops.affine_capacity(1, 1 << 20)
    assert made == [((_aff_scratch_words(first),),
                     {"dtype": torch.int32, "device": 3})]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="before capturing"):
        scan_ops.affine_scratch(3, 9, 1 << 20)
    assert len(made) == 1


# -- first use from several threads ------------------------------------------


class _FakeFn:
    """A ctypes function of the fake library: argtypes/restype settable."""

    def __init__(self, value):
        self.value = value

    def __call__(self, *args):
        return self.value


class _FakeLib:
    """The three libraries' functions that their binds call or set."""

    def __init__(self):
        self.tuun_affine_max_j = _FakeFn(scan_ops.MAX_J)
        self.tuun_affine_deep_max_j = _FakeFn(scan_ops.MAX_DEEP_J)
        self.tuun_scan_tile = _FakeFn(4096)
        self.tuun_affine_tile = _FakeFn(scan_ops.AFFINE_TILE)
        self.tuun_affine_slots = lambda n, fan: scan_ops.affine_slots(n, fan)
        self.tuun_affine_deep_tile = _FakeFn(1024)
        self.tuun_scan_scratch_words = _FakeFn(64)
        self.tuun_affine_scratch_words = _FakeFn(16)
        self.tuun_affine_deep_scratch_words = _FakeFn(16)
        self.tuun_recurrence_max_j = _FakeFn(scan_ops.MAX_RECURRENCE_J)
        self.tuun_df_tile = _FakeFn(2048)
        self.tuun_df_scratch_words = _FakeFn(16)
        for name in ("tuun_prefix_sum_rows_f32", "tuun_prefix_max_rows_f32",
                     "tuun_affine_scan_rows_f32",
                     "tuun_affine_scan_deep_rows_f32",
                     "tuun_linear_recurrence_rows_f32",
                     "tuun_linear_recurrence_rows_f64",
                     "tuun_df_prefix_sum_rows_f32",
                     "tuun_interval_gate_rows_f32",
                     "tuun_interval_mask_rows"):
            setattr(self, name, _FakeFn(0))


def _race(fn, threads=16):
    """Runs fn in `threads` threads released together, under a short
    switch interval; returns their results."""
    import sys
    import threading
    start = threading.Barrier(threads)
    out = [None] * threads

    def run(i):
        start.wait(timeout=30)
        out[i] = fn()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=run, args=(i,)) for i in range(threads)]
        for t_ in ts:
            t_.start()
        for t_ in ts:
            t_.join(timeout=60)
        assert not any(t_.is_alive() for t_ in ts)
    finally:
        sys.setswitchinterval(old)
    return out


# (source, the wrapper's loader, the sources its first use builds, what
# its bind read from the library)
_LIBRARIES = {
    "scan": (kernels.SOURCE, scan_ops.load_library, kernels.FAST_SOURCES,
             lambda: (scan_ops._scan_tile, scan_ops._deep_tile) == (
                 4096, 1024)),
    "exact": (kernels.EXACT_SOURCE, scan_ops.load_exact_library,
              (kernels.EXACT_SOURCE,), lambda: scan_ops._df_tile == 2048),
    "lanes": (kernels.LANES_SOURCE, lane_ops.load_library,
              kernels.FAST_SOURCES, lambda: True),
}


@pytest.mark.parametrize("name", sorted(_LIBRARIES))
def test_load_library_builds_and_loads_once_under_a_race(monkeypatch, name):
    """Threads at first use (the audio thread, the prewarm, the bake and
    capture workers) get one library through kernels.library, built,
    loaded and bound once; the first use of csrc/scan.cu or
    csrc/lanes.cu builds both (every fast render needs both)."""
    import ctypes
    import time
    source, load, built, bound = _LIBRARIES[name]
    builds, loads = [], []

    def build(source):
        builds.append(source)
        time.sleep(0.05)  # an nvcc build takes seconds: widen the window
        return f"libtuun_{source.stem}_fake.so"

    def cdll(path):
        loads.append(path)
        return _FakeLib()
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels, "build_library", build)
    monkeypatch.setattr(ctypes, "CDLL", cdll)
    for tile in ("_scan_tile", "_scratch_words", "_deep_tile", "_df_tile"):
        monkeypatch.setattr(scan_ops, tile, 0)
    libs = _race(load)
    assert sorted(builds) == sorted(built)
    assert loads == [f"libtuun_{source.stem}_fake.so"]
    assert all(lib is libs[0] for lib in libs)
    assert kernels._libs == {source: libs[0]}
    assert bound()


def test_scratch_made_once_under_a_race(monkeypatch):
    """Each (device, stream) gets one prefix and one affine scratch
    buffer, whichever threads ask first: no thread launches on a buffer
    that the table then drops."""
    import time
    monkeypatch.setattr(scan_ops, "_scratch", {})
    monkeypatch.setattr(scan_ops, "_affine_scratch", {})
    monkeypatch.setattr(scan_ops, "_affine_retired", [])
    made = []

    def alloc(device, *records):
        time.sleep(0.01)
        made.append(object())
        return made[-1]
    prefix = _race(lambda: scan_ops.prefix_scratch(0, 7, alloc=alloc))
    assert len(made) == 1 and all(b is made[0] for b in prefix)
    made.clear()
    affine = _race(lambda: scan_ops.affine_scratch(0, 7, 3, alloc=alloc))
    assert len(made) == 1 and all(e[0] is made[0] for e in affine)
    assert scan_ops._affine_retired == []


# -- the scans under torch.func.vmap -----------------------------------------


def _vmap_case(entry):
    """(rows form's name, operands, in_dims) of a 5-voice batch for one
    single-voice entry point; h0 (where there is one) is shared."""
    g = torch.Generator().manual_seed(len(entry))
    B, n = 5, 300

    def feedback(J):
        a = 0.05 * torch.randn(B, n, J, generator=g)
        live = torch.rand(B, n, generator=g) < 0.9
        return (a, torch.randn(B, n, generator=g), live,
                torch.randn(J, generator=g)), (0, 0, 0, None)
    if entry in ("prefix_sum_f32", "prefix_max_f32"):
        return (entry.replace("_f32", "_rows_f32"),
                (torch.randn(B, n, generator=g),), (0,))
    if entry == "df_prefix_sum_f32":
        xh = torch.randn(B, n, generator=g)
        return "df_prefix_sum_rows_f32", (xh, 1e-8 * xh), (0, 0)
    if entry == "affine_scan_f32":
        return ("affine_scan_rows_f32", *feedback(2))
    if entry == "affine_scan_deep_f32":
        return ("affine_scan_deep_rows_f32", *feedback(12))
    return ("linear_recurrence_rows", *feedback(3))


@pytest.mark.parametrize("entry", (
    "prefix_sum_f32", "prefix_max_f32", "affine_scan_f32",
    "affine_scan_deep_f32", "linear_recurrence", "df_prefix_sum_f32"))
def test_vmap_calls_the_rows_form_once_and_registers_no_op(monkeypatch,
                                                           entry):
    """torch.func.vmap of each single-voice scan hands the whole batch to
    its rows form in one call (kernels.vmapped: an operand vmap does not
    batch is expanded to contiguous rows), with every warning an error
    (no loop over the voices), and registers no torch.library op."""
    import warnings
    rows_name, args, in_dims = _vmap_case(entry)
    rows_fn = getattr(scan_ops, rows_name)
    calls = []

    def counted(*xs):
        calls.append(tuple(x.shape for x in xs))
        assert all(x.is_contiguous() for x in xs)
        return rows_fn(*xs)
    monkeypatch.setattr(scan_ops, rows_name, counted)
    ops = set(torch._C._dispatch_get_all_op_names())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = torch.func.vmap(getattr(scan_ops, entry),
                              in_dims=in_dims)(*args)
    B = args[0].shape[0]
    laid = [x if d == 0 else x.expand(B, *x.shape).contiguous()
            for x, d in zip(args, in_dims)]
    assert calls == [tuple(x.shape for x in laid)]
    want = rows_fn(*laid)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)
    assert set(torch._C._dispatch_get_all_op_names()) == ops
    assert not [n for n in ops if n.startswith("tuun_tpu_torch::")]
