"""The linear recurrence's chain form (csrc/exact.cu, J <= 16), wide
form (17 <= J <= 95) and streamed form (96 <= J <= 4096) on the CPU.

  * The plain version (scan_ops.linear_recurrence_ref) on chip_smoke.py's
    dead-lane patterns (REC_PATTERNS, the ones phase 11 holds the kernel
    to on the card): against tuun_tpu's CFilter._feedback in float64,
    within 1e-12 of scale, and bit for bit a numpy loop in the oracle's
    float32 rounding, at J = 1, 2, 8, 16 (the chain form), 17, 24, 32,
    64 (the wide form) and 96, 128, 257 (the streamed form).
  * Its numpy twin (chip_smoke.recurrence_np, which phase 11 holds the
    kernel to past REC_PLAIN_MAX_J): bit for bit the plain version in
    both types, on the patterns as rows and on [1:] views.
  * The patterns' shapes: each reaches the bodies and stage ends it is
    there for, by chip_smoke.py's model of the kernel's staging.
  * That model (recurrence_stage_lanes, _head, _stages), held to
    exact.cu's constants, and a numpy model of the producer's fills from
    it: every lane staged once and where the chain reads it, bulk copies
    whole 16-byte grains aligned at both ends, the ring inside its budget;
    contiguous rows and their [1:] views take bulk copies, rows misaligned
    otherwise do not.
  * The wide form's model: its constants held to exact.cu's, its stages
    within its shared-memory budget and its windows within their buffers
    at every J it takes.  Its bits are held on the card (chip_smoke.py
    phase 11, REC_JS and REC_PATTERN_JS).
  * The streamed form's model (chip_smoke's REC_STREAM_* and
    recurrence_stream_*): its constants and layout held to exact.cu's;
    with the wide form's, a block's 227 KB holds every J from 17 to
    MAX_RECURRENCE_J in both types.
"""

import re

import numpy as np
import pytest
import torch

from test_torch_exact import _bits, _chip_smoke, _jax_feedback, \
    _numpy_recurrence, t
from tuun_tpu_torch.engine import scan_ops

smoke = _chip_smoke()
# The chain form's depths, then the wide form's: its first, J = 24, 32
# (an unrolled window) and 64 (a looped one); then the streamed form's:
# its first, a whole number of product slots, one product past them.
JS = (1, 2, 8, 16, 17, 24, 32, 64, 96, 128, 257)


def _inputs(J, n, dtype, pattern, seed=0, offset=0):
    torch_dtype = torch.float32 if dtype == np.float32 else torch.float64
    return tuple(x.numpy() for x in smoke.recurrence_input(
        torch, np, np.random.default_rng(seed), J, n, torch_dtype,
        offset=offset, device="cpu", dead=pattern))


@pytest.mark.parametrize("pattern", smoke.REC_PATTERNS)
@pytest.mark.parametrize("J", JS)
def test_plain_matches_jax_feedback_f64_on_live_patterns(J, pattern):
    a, ff, live, h0 = _inputs(J, 300, np.float64, pattern, seed=J)
    y, hist = scan_ops.linear_recurrence(t(a), t(ff), t(live), t(h0))
    wy, wh = _jax_feedback("exact", a, ff, live, h0)
    tol = 1e-12 * max(1.0, float(np.abs(wy).max()))
    assert np.abs(y.numpy() - wy).max() <= tol
    assert np.abs(hist.numpy() - wh).max() <= tol
    assert np.all(y.numpy()[~live] == 0)


@pytest.mark.parametrize("pattern", smoke.REC_PATTERNS)
@pytest.mark.parametrize("J", JS)
def test_plain_is_the_oracles_float32_loop_on_live_patterns(J, pattern):
    a, ff, live, h0 = _inputs(J, 300, np.float32, pattern, seed=J)
    y, hist = scan_ops.linear_recurrence(t(a), t(ff), t(live), t(h0))
    ry, rh = _numpy_recurrence(a, ff, live, h0, fused=False)
    assert np.array_equal(_bits(y.numpy()), _bits(ry))
    assert np.array_equal(_bits(hist.numpy()), _bits(rh))


def _source_constant(name):
    src = scan_ops.EXACT_SOURCE.read_text()
    return eval(re.search(rf"constexpr int {name} = ([^;]+);", src).group(1))


def _group_lanes(J):
    """exact.cu's rec_group_lanes(J), read from the source."""
    src = scan_ops.EXACT_SOURCE.read_text()
    m = re.search(r"int rec_group_lanes\(int J\) \{\s*return J <= (\d+) \? "
                  r"(\d+) : (\d+);", src)
    return int(m.group(2)) if J <= int(m.group(1)) else int(m.group(3))


def _bodies(live, stages, G):
    """Which of the chain's bodies each whole group of G lanes takes (all
    live, all dead, mixed), over the stages; and whether lanes past a
    stage's last whole group go one at a time."""
    seen = set()
    for st, length in stages:
        for i in range(0, length - G + 1, G):
            mask = live[st + i:st + i + G]
            seen.add("live" if mask.all() else "dead" if not mask.any()
                     else "mixed")
        if length % G:
            seen.add("single")
    return seen


@pytest.mark.parametrize("offset", [0, 1])
def test_live_patterns_have_their_shape(offset):
    n = smoke.REC_PATTERN_N
    item = 4
    dead = {p: ~_inputs(2, n, np.float32, p, offset=offset)[2]
            for p in smoke.REC_PATTERNS}
    assert not dead["live"].any() and dead["dead"].all()
    # "stride": one dead lane at each place of a 32-lane group.
    pos = np.flatnonzero(dead["stride"]) - offset
    assert set(pos % 32) == set(range(32))
    for J in (1, 2, 8, 16):
        S = smoke.recurrence_stage_lanes(J, item)
        stages = smoke.recurrence_stages(n, smoke.recurrence_head(offset), S)
        assert len(stages) > 4
        ends = [offset + st + ln for st, ln in stages]
        # "stage_ends": dead across the first stage's end (a view's head)
        # and the fourth's.
        d = ~_inputs(J, n, np.float32, "stage_ends", offset=offset)[2]
        assert d[[ends[0] - 1, ends[0], ends[3] - 1, ends[3]]].all()
        G = _group_lanes(J)
        live = {p: _inputs(J, n, np.float32, p, offset=offset)[2][offset:]
                for p in smoke.REC_PATTERNS}
        assert _bodies(live["live"], stages, G) <= {"live", "single"}
        assert _bodies(live["dead"], stages, G) <= {"dead", "single"}
        assert {"live", "mixed"} <= _bodies(live["stride"], stages, G)
        assert {"live", "dead"} <= _bodies(live["stage_ends"], stages, G)
        assert "single" in _bodies(live["mixed"], stages, G)


# ---------------------------------------------------------------------------
# The staging
# ---------------------------------------------------------------------------


def test_staging_model_has_the_sources_constants():
    for name in ("REC_STAGES", "REC_FIRST", "REC_BUDGET", "REC_MAX_STAGE",
                 "REC_GRAIN", "REC_REG_J"):
        key = "kRec" + "".join(w.title() for w in name[4:].split("_"))
        assert _source_constant(key) == getattr(smoke, name), key
    assert [_group_lanes(J) for J in (1, 4, 5, 16)] == [64, 64, 32, 32]


def test_stage_lanes_fill_the_budget():
    for item in (4, 8):
        for J in range(1, smoke.REC_REG_J + 1):
            S = smoke.recurrence_stage_lanes(J, item)
            lane_bytes = (J + 2) * item + 1
            assert S & (S - 1) == 0
            assert smoke.REC_FIRST <= S <= smoke.REC_MAX_STAGE
            assert smoke.REC_STAGES * S * lane_bytes <= smoke.REC_BUDGET
            assert S == smoke.REC_MAX_STAGE or \
                smoke.REC_STAGES * 2 * S * lane_bytes > smoke.REC_BUDGET


def _stage_model(n, J, item, a_addr, ff_addr, live_addr):
    """The producer's fills and the chain's reads as exact.cu makes them:
    returns (bulk, [(first lane, lanes)] of the stages); asserts every
    lane is staged once, at the index the chain reads it from, by bulk
    copies aligned at both ends where they are used, and that every
    stage past the head starts on a grain, where the chain's 16-byte
    loads of its whole groups are aligned."""
    S = smoke.recurrence_stage_lanes(J, item)
    head = smoke.recurrence_head(live_addr)
    # Past the head, a and ff take bulk copies where their lanes align
    # where the live bytes' do.
    bulk = (ff_addr + head * item) % 16 == 0 \
        and (a_addr + head * J * item) % 16 == 0
    stages = smoke.recurrence_stages(n, head, S)
    staged = np.zeros(n, int)
    for k, (st, length) in enumerate(stages):
        assert 1 <= length <= S
        assert (st - head) % 16 == 0 or (k == 0 and length == min(n, head))
        # The bulk span [st, b1): the stage's whole grains, where it
        # starts on one; the producer's loads stage the lanes past it.
        b1 = st + length // 16 * 16 if bulk and st >= head else st
        buf = np.full(S, -1)
        if b1 > st:
            m = b1 - st
            for addr, size in ((a_addr, J * item), (ff_addr, item),
                               (live_addr, 1)):
                assert (addr + st * size) % 16 == 0
                assert (m * size) % 16 == 0
            buf[:m] = np.arange(st, b1)
        buf[b1 - st:length] = np.arange(b1, st + length)
        assert np.array_equal(buf[:length], np.arange(st, st + length))
        if length >= 32:
            assert (st - head) % 16 == 0
        staged[st:st + length] += 1
    assert (staged == 1).all()
    return bulk, stages


# (rows, lanes a row, view offset): the staging's branches.  Whole grains
# and no head; a ragged tail; a [1:] view (a head of 15); a view shorter
# than its head; rows whose starts fall off the grain (a head of 8); a
# row long enough that stages stop doubling at S.
STAGING_CASES = {"whole grains": (1, 1024, 0), "ragged tail": (1, 4101, 0),
                 "view": (1, 4101, 1), "view inside its head": (1, 15, 1),
                 "rows": (3, 1000, 0), "rows of views": (3, 1000, 1),
                 "stages at S": (1, 1 << 17, 0)}


@pytest.mark.parametrize("case", STAGING_CASES)
def test_staging_model_on_rows_and_views(case):
    rows, n, off = STAGING_CASES[case]
    base = 1 << 20  # a fresh allocation (512-byte aligned)
    for item in (4, 8):
        for J in (1, 2, 3, 8, 16):
            for r in range(rows):
                lane, m = r * n + off, n - off
                bulk, stages = _stage_model(
                    m, J, item, base + lane * J * item,
                    2 * base + lane * item, 3 * base + lane)
                assert bulk
                head = smoke.recurrence_head(lane)
                assert stages[0][1] == min(m, head or smoke.REC_FIRST)


def test_staging_model_when_rows_do_not_align_alike():
    """ff four bytes off the live bytes' grain: no lane takes a bulk
    copy; the producer's loads stage every lane."""
    for n in (100, 1024, 4101):
        bulk, stages = _stage_model(n, 2, 4, 0, 4, 0)
        assert not bulk
        assert sum(length for _, length in stages) == n


# ---------------------------------------------------------------------------
# The wide form (REC_REG_J < J <= REC_WIDE_MAX_J)
# ---------------------------------------------------------------------------


def test_wide_form_has_the_sources_constants():
    for name in ("REC_WIDE_MAX_J", "REC_WIDE_BUDGET", "REC_WIDE_BUFS",
                 "REC_WIDE_PS", "REC_WIDE_UNROLLED_J"):
        key = "kRec" + "".join(w.title() for w in name[4:].split("_"))
        assert _source_constant(key) == getattr(smoke, name), key
    # The kernel picks a thread's share of a lane's J - 2 products by
    # depth.
    src = scan_ops.EXACT_SOURCE.read_text()
    # Unrolled windows of 16, 24 and 32 products (one slot), then a loop
    # with three slots.
    cases = re.findall(r"case (\d): TUUN_WIDE_ROW\((\d), (\d+) / V\)", src)
    assert [(int(c), int(s), int(w)) for c, s, w in cases] == \
        [(k, 1, 8 * k) for k in range(2, 5)]
    assert 8 * 4 + 2 == smoke.REC_WIDE_UNROLLED_J
    assert "default: TUUN_WIDE_ROW(3, 0);" in src
    assert [smoke.recurrence_wide_slots(J) for J in (17, 34, 35, 95)] \
        == [1, 1, 3, 3]
    assert smoke.recurrence_wide_slots(smoke.REC_WIDE_MAX_J) == 3


def test_wide_stages_fit_the_budget():
    """At every J of the wide form, both types: S a power of two from
    REC_FIRST to REC_MAX_STAGE whose shared memory fits the budget (and
    twice S does not), the budget within a block's 227 KB, a product
    buffer holding its window and the item dropped products go to."""
    for item in (4, 8):
        V = 16 // item
        for J in range(smoke.REC_REG_J + 1, smoke.REC_WIDE_MAX_J + 1):
            S = smoke.recurrence_stage_lanes(J, item)
            assert S & (S - 1) == 0
            assert smoke.REC_FIRST <= S <= smoke.REC_MAX_STAGE
            assert smoke.recurrence_wide_bytes(J, S, item) \
                <= smoke.REC_WIDE_BUDGET
            assert S == smoke.REC_MAX_STAGE or smoke.recurrence_wide_bytes(
                J, 2 * S, item) > smoke.REC_WIDE_BUDGET
            # A window holds the lane's J - 2 products after at most 7
            # zeros (V - 1 where a loop reads it), whole chunks, at least
            # the four register sets' where unrolled, and lies in the
            # buffer before the item dropped products go to.
            W, first, unrolled = smoke.recurrence_wide_window(J, item)
            assert 0 <= W - (J - 2) - first * V < (8 if unrolled else V)
            assert W % V == 0 and unrolled == (J <= smoke.REC_WIDE_UNROLLED_J)
            assert not unrolled or (first == 0 and W // V >= 4)
            assert W < smoke.REC_WIDE_PS
    assert smoke.REC_WIDE_BUDGET + 64 <= 232448
    assert smoke.REC_WIDE_PS % 4 == 0


# ---------------------------------------------------------------------------
# The plain version's numpy twin
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("J", [1, 2, 17, 96, 128, 257])
def test_numpy_twin_is_the_plain_version(J, dtype):
    """chip_smoke.recurrence_np, which phase 11 holds the kernel to past
    REC_PLAIN_MAX_J (the plain version takes ~10 us a lane and
    coefficient on the host), gives the plain version's bits: the
    patterns as the rows of one call, and a [1:] view alone."""
    rows = [_inputs(J, 200, dtype, p, seed=J, offset=1)
            for p in smoke.REC_PATTERNS]
    args = [np.stack([r[k][1:] if k < 3 else r[k] for r in rows])
            for k in range(4)]
    y, hist = scan_ops.linear_recurrence_rows(*map(t, args))
    ty, th = smoke.recurrence_np(np, *args)
    assert ty.dtype == dtype and th.dtype == dtype
    assert np.array_equal(_bits(y.numpy()), _bits(ty))
    assert np.array_equal(_bits(hist.numpy()), _bits(th))
    view = tuple(t(x) for x in rows[0])
    view = (view[0][1:], view[1][1:], view[2][1:], view[3])
    y1, h1 = scan_ops.linear_recurrence(*view)
    ty1, th1 = smoke.recurrence_np(np, *(x.numpy() for x in view))
    assert np.array_equal(_bits(y1.numpy()), _bits(ty1))
    assert np.array_equal(_bits(h1.numpy()), _bits(th1))


def test_phase_11_takes_the_twin_past_the_plain_depths():
    assert smoke.REC_PLAIN_MAX_J == smoke.REC_WIDE_MAX_J + 1
    assert {96, 128, 257, scan_ops.MAX_RECURRENCE_J} <= set(smoke.REC_JS)
    assert {96, 128, 257, scan_ops.MAX_RECURRENCE_J} <= \
        set(smoke.REC_PATTERN_JS)
    # The long one-step check keeps a's values within REC_LONG_VALUES.
    for J in smoke.REC_JS:
        n = min(smoke.REC_LONG_N, smoke.REC_LONG_VALUES // J + 5)
        assert n * J <= smoke.REC_LONG_VALUES + 5 * J
        assert n == smoke.REC_LONG_N or J > 257


# ---------------------------------------------------------------------------
# The streamed form (REC_WIDE_MAX_J < J <= MAX_RECURRENCE_J)
# ---------------------------------------------------------------------------

# A block's shared memory (the card's 227 KB) and what the kernel holds
# besides the dynamic part: the ring's 2 x REC_STAGES mbarriers.
BLOCK_SMEM = 232448
STATIC_SMEM = 2 * smoke.REC_STAGES * 8


def test_streamed_form_has_the_sources_constants():
    for name in ("REC_STREAM_BUDGET", "REC_STREAM_THREADS", "REC_STREAM_BUFS",
                 "REC_STREAM_MIN_BUFS", "REC_STREAM_ROW_BYTES",
                 "REC_STREAM_BARS"):
        key = "kRec" + "".join(w.title() for w in name[4:].split("_"))
        assert _source_constant(key) == getattr(smoke, name), key
    src = scan_ops.EXACT_SOURCE.read_text()
    # Past the wide form's depths the kernel takes the streamed form, with
    # its threads and its layout's bytes; the ring form is gone.
    assert "if (J > kRecWideMaxJ) {\n      rec_stream_row<T>(" in src
    assert "threads = kRecStreamThreads;" in src
    assert "smem = (size_t)rec_stream_bytes(J, rec_stream_stage_lanes(J, " \
        "sizeof(T)),\n                                    rec_stream_bufs(J, " \
        "sizeof(T))," in src
    for gone in ("rec_ring_row", "rec_tile_ring", "RecSmem", "rec_smem_bytes",
                 "kRecThreads", "kRecStagers", "kRecTile", "kRecSmemBudget"):
        assert not re.search(rf"\b{gone}\b", src), gone
    # The layout, term by term: mbarriers, two product buffers, the a
    # buffers, the stages' ff, y and live, the history of 2J + S.
    layout = re.search(r"constexpr int64_t rec_stream_bytes\(.*?\n}\n", src,
                       re.S).group(0)
    for term in ("kRecStreamBars", "2LL * rec_stream_window(J) * item",
                 "NA * rec_stream_block_bytes(J, item)",
                 "(int64_t)kRecStages * S * (2 * item + 1)",
                 "(int64_t)(2 * J + S) * item"):
        assert term in layout, term
    assert "return (J - 2 + 31) / 32 * 32;" in src
    assert "((int64_t)rec_stream_block_lanes(J, item) * J * item + 15) / 16 " \
        "* 16 +\n         32;" in src


def test_deep_layouts_fit_a_block_at_every_depth():
    """Every J from 17 to MAX_RECURRENCE_J, both types, in the form that
    takes it: stages of a power of two lanes from REC_FIRST to
    REC_MAX_STAGE, the largest that fits the form's budget; the budget,
    with the kernel's static mbarriers, within a block's 227 KB; the
    streamed form's a buffers a power of two from REC_STREAM_MIN_BUFS to
    REC_STREAM_BUFS, the most that fit, each holding a block's rows and
    the grains either side, and its product buffers whole 16-byte chunks
    of at least the lane's J - 2 products."""
    assert smoke.REC_WIDE_BUDGET + STATIC_SMEM <= BLOCK_SMEM
    assert smoke.REC_STREAM_BUDGET + STATIC_SMEM <= BLOCK_SMEM
    assert smoke.REC_STREAM_BARS >= 2 * smoke.REC_STREAM_BUFS * 8
    for item in (4, 8):
        for J in range(smoke.REC_REG_J + 1, scan_ops.MAX_RECURRENCE_J + 1):
            S = smoke.recurrence_stage_lanes(J, item)
            assert S & (S - 1) == 0
            assert smoke.REC_FIRST <= S <= smoke.REC_MAX_STAGE
            if J <= smoke.REC_WIDE_MAX_J:
                assert smoke.recurrence_wide_bytes(J, S, item) \
                    <= smoke.REC_WIDE_BUDGET
                continue
            bufs = smoke.recurrence_stream_bufs(J, item)
            assert bufs in (2, 4) and bufs >= smoke.REC_STREAM_MIN_BUFS
            size = smoke.recurrence_stream_bytes(J, S, bufs, item)
            assert size <= smoke.REC_STREAM_BUDGET, (J, item)
            assert S == smoke.REC_MAX_STAGE or smoke.recurrence_stream_bytes(
                J, 2 * S, bufs, item) > smoke.REC_STREAM_BUDGET
            assert bufs == smoke.REC_STREAM_BUFS or \
                smoke.recurrence_stream_bytes(J, smoke.REC_FIRST, 2 * bufs,
                                              item) > smoke.REC_STREAM_BUDGET
            lanes = smoke.recurrence_stream_block_lanes(J, item)
            rb = smoke.recurrence_stream_block_bytes(J, item)
            assert lanes >= 1 and rb % 16 == 0
            assert rb >= lanes * J * item + 30
            assert lanes == 1 or lanes * J * item <= smoke.REC_STREAM_ROW_BYTES
            W = smoke.recurrence_stream_window(J)
            assert W % 32 == 0 and J - 2 <= W < J - 2 + 32
            # Every region starts 16-byte aligned where the chain or a bulk
            # copy needs it: the products, the a buffers, ff, y, live.
            for off in (smoke.REC_STREAM_BARS,
                        smoke.REC_STREAM_BARS + 2 * W * item,
                        smoke.REC_STREAM_BARS + 2 * W * item + bufs * rb):
                assert off % 16 == 0
            assert (smoke.REC_STAGES * S * item) % 16 == 0
            assert (smoke.REC_STAGES * S) % 16 == 0
