"""The deep affine scan (scan_ops.affine_scan_deep_f32 and its rows form:
fast-mode IIR feedback with MAX_J < J <= MAX_DEEP_J) on the CPU, where it
takes its plain version, and a model of its CUDA kernel.

  * The plain version against tuun_tpu's fast CFilter._feedback (an
    associative scan of companion maps past the Pallas kernel's J = 4) on
    the same numpy-seeded inputs, with dead lanes and a carried history,
    and against the recurrence's plain version.
  * The rows form row by row, and torch.func.vmap of the single entry
    point, with warnings as errors (an op without a batching rule warns
    and loops over the voices).
  * Routing: fast mode's feedback at MAX_J < J <= MAX_DEEP_J reaches the
    deep form, J = MAX_DEEP_J + 1 the linear recurrence.
  * The CUDA kernel's order of operations (csrc/scan.cu's
    affine_deep_pass), modelled with numpy at the kernel's geometry and at
    a small one whose anchors a test can reach: segment maps built column
    by column, a Blelloch up-sweep, the look-back (the maps after the
    anchor applied in turn to its history), the down-sweep of histories,
    each segment's recurrence, the last tile's map applied for hist; in
    float32, a render in blocks of whole tiles gives the bits of one call
    over the same lanes.
  * The deep scratch's sizing, growth and keying, without a card.
"""

import re
import types
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tuun_tpu.engine.graph as jgraph
from tuun_tpu_torch import ir
from tuun_tpu_torch.engine import render, scan_ops

torch.set_num_threads(1)
CPU = "cpu"
DEEP_JS = (9, 12, 16)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _stable_inputs(n, J, seed, dead=0.1, B=None):
    """A stable J-deep all-pole section (real and complex poles of modulus
    0.2-0.9) with a per-lane jitter of 1e-3, unit normal ff, `dead` of the
    lanes dead and a dead run of 20, a random entering history; with B,
    B rows."""
    rng = np.random.default_rng(seed)
    poles = [0.9, 0.8, 0.5 + 0.3j, 0.5 - 0.3j, -0.6, 0.7j, -0.7j, 0.3, -0.4,
             0.2 + 0.5j, 0.2 - 0.5j, -0.85, 0.35, -0.45, 0.15, -0.2]
    base = np.real(np.poly(poles[:J]))[1:]
    lead = () if B is None else (B,)
    a = (base + 1e-3 * rng.standard_normal((*lead, n, J))).astype(np.float32)
    ff = rng.standard_normal((*lead, n)).astype(np.float32)
    live = rng.random((*lead, n)) > dead
    live[..., n // 3:n // 3 + 20] = False
    h0 = rng.standard_normal((*lead, J)).astype(np.float32)
    return a, ff, live, h0


def _scale(y):
    return max(1.0, float(np.abs(y).max()))


# -- the plain version against tuun_tpu and the recurrence -------------------


# Tolerance: tuun_tpu's associative scan composes float32 maps; the
# port's CPU path evaluates the same maps' doubling scan in float64.  On
# these sections (jittered coefficients, dead runs, a random entering
# history) tuun_tpu errs up to 8.1e-6 of the output's scale against the
# float64 recurrence at J = 9 (pole 0.9 beside -0.85 and -0.6 in 12 more)
# and 2.5e-6 at J = 12 and 16 (the float32 recurrence itself 2.6e-6);
# held at 2e-5.
@pytest.mark.parametrize("J", DEEP_JS)
@pytest.mark.parametrize("n", [1, 77, 600])
def test_deep_ref_matches_jax_fast_feedback(J, n):
    a, ff, live, h0 = _stable_inputs(n, J, 10 * J + n)
    y, hist = scan_ops.affine_scan_deep_f32(t(a), t(ff), t(live), t(h0))
    this = types.SimpleNamespace(
        J=J, cfg=types.SimpleNamespace(sequential_iir=False, pallas=False))
    jy, jhist = jgraph.CFilter._feedback(
        this, jnp.asarray(ff), [jnp.asarray(a[:, j]) for j in range(J)],
        jnp.asarray(h0), jnp.asarray(live))
    scale = _scale(np.asarray(jy))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                               atol=2e-5 * scale)
    np.testing.assert_allclose(hist.numpy(), np.asarray(jhist), rtol=0,
                               atol=2e-5 * scale)
    assert not y.numpy()[~live].any()


@pytest.mark.parametrize("J", DEEP_JS)
def test_deep_ref_matches_recurrence(J):
    """In float64 the composed maps and the recurrence's plain version
    (the reference's op order) differ by rounding only; in float32 the
    plain version stays within 2e-5 of scale of the float64 recurrence (it
    errs up to 7.5e-6 at J = 9, 2.5e-6 at 12 and 16).  The CPU entry
    point is the float64 result rounded to float32."""
    a, ff, live, h0 = _stable_inputs(1500, J, J)
    args64 = (t(a).double(), t(ff).double(), t(live), t(h0).double())
    ry, rh = scan_ops.linear_recurrence_ref(*args64)
    y64, h64 = scan_ops.affine_y_ref(*args64)
    scale = _scale(ry.numpy())
    np.testing.assert_allclose(y64.numpy(), ry.numpy(), rtol=0,
                               atol=1e-12 * scale)
    np.testing.assert_allclose(h64.numpy(), rh.numpy(), rtol=0,
                               atol=1e-12 * scale)
    y32, h32 = scan_ops.affine_y_ref(t(a), t(ff), t(live), t(h0))
    np.testing.assert_allclose(y32.numpy(), ry.numpy(), rtol=0,
                               atol=2e-5 * scale)
    np.testing.assert_allclose(h32.numpy(), rh.numpy(), rtol=0,
                               atol=2e-5 * scale)
    y, hist = scan_ops.affine_scan_deep_f32(t(a), t(ff), t(live), t(h0))
    assert torch.equal(y, y64.float()) and torch.equal(hist, h64.float())


def test_deep_all_dead_lanes_pass_history_through():
    J, n = 12, 50
    a = np.full((n, J), 0.05, np.float32)
    h0 = np.arange(J, dtype=np.float32)
    y, hist = scan_ops.affine_scan_deep_f32(
        t(a), t(np.ones(n, np.float32)), t(np.zeros(n, bool)), t(h0))
    assert not y.numpy().any()
    np.testing.assert_array_equal(hist.numpy(), h0)


@pytest.mark.parametrize("B,n,J", [(4, 300, 12), (3, 65, 16), (2, 1, 9)])
def test_deep_rows_row_by_row(B, n, J):
    """Row r of the rows form is the single form on row r (within 1 ulp
    of scale: the CPU's batched products may round per batch size)."""
    a, ff, live, h0 = _stable_inputs(n, J, B * n + J, B=B)
    y, hist = scan_ops.affine_scan_deep_rows_f32(t(a), t(ff), t(live), t(h0))
    assert y.shape == (B, n) and hist.shape == (B, J)
    for r in range(B):
        y1, h1 = scan_ops.affine_scan_deep_f32(t(a[r]), t(ff[r]), t(live[r]),
                                               t(h0[r]))
        tol = np.finfo(np.float32).eps * _scale(y1.numpy())
        np.testing.assert_allclose(y[r].numpy(), y1.numpy(), rtol=0, atol=tol)
        np.testing.assert_allclose(hist[r].numpy(), h1.numpy(), rtol=0,
                                   atol=tol)


def test_deep_vmap_takes_the_rows_form(monkeypatch):
    """torch.func.vmap of the single entry point hands the whole batch to
    the rows form once (an operand vmap does not batch is broadcast),
    with no loop over the voices: every warning is an error."""
    B, n, J = 5, 200, 12
    a, ff, live, h0 = _stable_inputs(n, J, 3, B=B)
    calls = []
    rows_fn = scan_ops.affine_scan_deep_rows_f32

    def counted(*args):
        calls.append(tuple(x.shape for x in args))
        return rows_fn(*args)
    monkeypatch.setattr(scan_ops, "affine_scan_deep_rows_f32", counted)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        y, hist = torch.func.vmap(scan_ops.affine_scan_deep_f32,
                                  in_dims=(0, 0, 0, None))(
            t(a), t(ff), t(live), t(h0[0]))
    assert calls == [((B, n, J), (B, n), (B, n), (B, J))]
    want_y, want_h = rows_fn(t(a), t(ff), t(live),
                             t(np.broadcast_to(h0[0], (B, J))))
    assert torch.equal(y, want_y) and torch.equal(hist, want_h)


def test_deep_wrappers_reject_bad_inputs():
    n = 8
    ff, live = torch.zeros(n), torch.ones(n, dtype=torch.bool)
    for J, other in ((scan_ops.MAX_J, "runs on affine_scan_f32"),
                     (scan_ops.MAX_DEEP_J + 1, "runs on linear_recurrence")):
        with pytest.raises(NotImplementedError, match=other):
            scan_ops.affine_scan_deep_f32(torch.zeros(n, J), ff, live,
                                          torch.zeros(J))
        with pytest.raises(NotImplementedError):
            scan_ops.affine_scan_deep_rows_f32(
                torch.zeros(2, n, J), torch.zeros(2, n),
                torch.ones(2, n, dtype=torch.bool), torch.zeros(2, J))
    J = 12
    a, h0 = torch.zeros(n, J), torch.zeros(J)
    with pytest.raises(ValueError):
        scan_ops.affine_scan_deep_f32(a.double(), ff, live, h0)
    with pytest.raises(ValueError):
        scan_ops.affine_scan_deep_f32(a, ff[:4], live, h0)
    with pytest.raises(ValueError):
        scan_ops.affine_scan_deep_f32(a, ff, live.float(), h0)
    with pytest.raises(ValueError):
        scan_ops.affine_scan_deep_f32(a, ff, live, torch.zeros(3))
    with pytest.raises(ValueError):
        scan_ops.affine_scan_deep_rows_f32(a, ff, live, h0)
    with pytest.raises(NotImplementedError, match="affine_scan_deep_f32"):
        scan_ops.affine_scan_f32(torch.zeros(n, 9), ff, live, torch.zeros(9))


# -- routing -----------------------------------------------------------------


def _deep_filter(J):
    """The ramp of test_torch_stream.py's _deep through J feedback
    coefficients of a stable section (the first J of _stable_inputs'
    poles, the rest at -0.5 + 0.05 k)."""
    poles = [0.9, 0.8, 0.5 + 0.3j, 0.5 - 0.3j, -0.6, 0.7j, -0.7j, 0.3, -0.4,
             0.2 + 0.5j, 0.2 - 0.5j, -0.85, 0.35, -0.45, 0.15, -0.2]
    poles += [-0.5 + 0.05 * k for k in range(J - len(poles))]
    a = np.real(np.poly(poles[:J]))[1:]
    inner = ir.Fin(ir.BinaryPointOp(ir.Operator.SUBTRACT, ir.Time(),
                                    ir.Const(40.0)), ir.Time())
    return ir.Filter(inner, (ir.Const(0.5), ir.Const(0.25)),
                     tuple(ir.Const(float(x)) for x in a))


@pytest.mark.parametrize("J,want", [
    (scan_ops.MAX_J, "affine"), (scan_ops.MAX_J + 1, "deep"),
    (scan_ops.MAX_DEEP_J, "deep"), (scan_ops.MAX_DEEP_J + 1, "rec")])
def test_fast_feedback_routes_by_depth(J, want, monkeypatch):
    """Fast mode's feedback: the affine scan up to MAX_J, its deep form up
    to MAX_DEEP_J, the linear recurrence beyond (one call a block); exact
    mode runs the recurrence at every depth."""
    calls = {"affine": 0, "deep": 0, "rec": 0}
    for key, name in (("affine", "affine_scan_f32"),
                      ("deep", "affine_scan_deep_f32"),
                      ("rec", "linear_recurrence")):
        fn = getattr(scan_ops, name)

        def wrapped(*a, _fn=fn, _key=key):
            calls[_key] += 1
            return _fn(*a)
        monkeypatch.setattr(scan_ops, name, wrapped)
    got = render(_deep_filter(J), 60, 1, precision="fast", block=16,
                 device=CPU)
    assert len(got) == 40 and np.isfinite(got).all()
    assert calls == {k: 3 if k == want else 0 for k in calls}
    render(_deep_filter(J), 60, 1, precision="exact", block=16, device=CPU)
    assert calls["rec"] == (6 if want == "rec" else 3)


# -- a model of the CUDA kernel's order of operations ------------------------


def _deep_geometry():
    """(segment lanes, segments a tile, anchor stride) of csrc/scan.cu."""
    src = scan_ops.SOURCE.read_text()

    def get(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert get("kDeepMaxJ") == scan_ops.MAX_DEEP_J
    return (get("kDeepSeg"), get("kDeepWarps") * get("kDeepSegsPerWarp"),
            get("kDeepAnchor"))


KERNEL_GEOMETRY = _deep_geometry()
# Tiles of 32 lanes, anchors every 4 tiles: a few hundred lanes reach
# look-backs over several records and a chain of anchors.
SMALL_GEOMETRY = (4, 8, 4)


def _deep_model(a, ff, live, h0, geom, dtype=np.float64):
    """(y, hist) as affine_deep_pass computes them, with geometry geom =
    (S lanes a segment, NS segments a tile, anchor stride G), in `dtype`.
    Tiles run in order: the kernel's grouping does not depend on which
    tile finishes first."""
    S, NS, G = geom
    tile = S * NS
    n, J = a.shape
    nbr = -(-n // tile)
    pad = nbr * tile - n
    a = np.concatenate([a, np.zeros((pad, J))]).astype(dtype)
    ff = np.concatenate([ff, np.zeros(pad)]).astype(dtype)
    live = np.concatenate([live, np.zeros(pad, bool)])
    h0 = h0.astype(dtype)
    nseg = nbr * NS
    # Segment maps, column by column: lane c < J pushes e_c with ff = 0,
    # lane J pushes ff from a zero history.  H[g, c] is lane c's history.
    H = np.zeros((nseg, J + 1, J), dtype)
    H[:, :J] = np.eye(J, dtype=dtype)
    for i in range(S):
        lanes = np.arange(nseg) * S + i
        f = np.zeros((nseg, J + 1), dtype)
        f[:, J] = ff[lanes]
        y = f - np.einsum("gcj,gj->gc", H, a[lanes])
        shifted = np.concatenate([y[..., None], H[..., :-1]], axis=-1)
        H = np.where(live[lanes, None, None], shifted, H)
    A = np.swapaxes(H[:, :J], 1, 2).copy()  # A[g][:, c] = column c
    b = H[:, J].copy()

    y = np.zeros(nbr * tile, dtype)
    records = {}
    hist = None
    for t_ in range(nbr):
        MA, Mb = A[t_ * NS:(t_ + 1) * NS].copy(), b[t_ * NS:(t_ + 1) * NS].copy()
        # Blelloch up-sweep: map R becomes "R after R - d"; the root is the
        # tile's map.
        d = 1
        while d < NS:
            R = np.arange(2 * d - 1, NS, 2 * d)
            L = R - d
            MA[R], Mb[R] = MA[R] @ MA[L], (MA[R] @ Mb[L][..., None])[..., 0] \
                + Mb[R]
            d *= 2
        h = h0
        if nbr > 1:
            anchor = t_ % G == 0
            if not anchor:
                records[t_] = (MA[-1], Mb[-1])
            if t_ > 0:
                # The anchor's exit history, then the maps of the tiles
                # after it, each in turn.
                first = (t_ - 1) // G * G
                h = records[first]
                for w in range(first + 1, t_):
                    h = records[w][0] @ h + records[w][1]
            if anchor:
                records[t_] = MA[-1] @ h + Mb[-1]
        # Down-sweep: the left child takes the parent's history, the right
        # child the left child's map applied to it.
        hv = np.zeros((NS, J), dtype)
        hv[-1] = h
        d = NS // 2
        while d >= 1:
            R = np.arange(2 * d - 1, NS, 2 * d)
            L = R - d
            hr = hv[R].copy()
            hv[L] = hr
            hv[R] = (MA[L] @ hr[..., None])[..., 0] + Mb[L]
            d //= 2
        # Each segment's recurrence in the reference's op order.
        for i in range(S):
            lanes = t_ * tile + np.arange(NS) * S + i
            yv = ff[lanes].copy()
            for j in range(J):
                yv = yv - a[lanes, j] * hv[:, j]
            lv = live[lanes]
            shifted = np.concatenate([yv[:, None], hv[:, :-1]], axis=-1)
            hv = np.where(lv[:, None], shifted, hv)
            y[lanes] = np.where(lv, yv, 0)
        if t_ == nbr - 1:  # the row's hist: the tile's map applied
            hist = MA[-1] @ h + Mb[-1]
    return y[:n], hist


def _model_lengths(geom):
    S, NS, G = geom
    tile = S * NS
    out = [1, tile, tile + 1, 3 * tile + 37]
    if geom == SMALL_GEOMETRY:
        out.append(3 * G * tile + 2 * tile + 5)
    return out


DEEP_MODEL_CASES = [(J, geom, n) for J in DEEP_JS
                    for geom in (KERNEL_GEOMETRY, SMALL_GEOMETRY)
                    for n in _model_lengths(geom)]


@pytest.mark.parametrize("J,geom,n", DEEP_MODEL_CASES)
def test_deep_kernel_model_matches_reference(J, geom, n):
    # In float64 the model and the doubling reference differ only by
    # rounding (1e-9 of the output's scale).
    a, ff, live, h0 = _stable_inputs(n, J, 7 * J + n)
    y, hist = _deep_model(a, ff, live, h0, geom)
    ry, rh = scan_ops.affine_y_ref(t(a).double(), t(ff).double(),
                                           t(live), t(h0).double())
    scale = _scale(ry.numpy())
    np.testing.assert_allclose(y, ry.numpy(), rtol=0, atol=1e-9 * scale)
    np.testing.assert_allclose(hist, rh.numpy(), rtol=0, atol=1e-9 * scale)


@pytest.mark.parametrize("J", DEEP_JS)
@pytest.mark.parametrize("geom", [KERNEL_GEOMETRY, SMALL_GEOMETRY])
def test_deep_kernel_model_blocks_match_one_call(J, geom):
    """In float32, blocks of whole tiles rendered one after another, each
    from the hist of the one before, give the bits of one call over all
    of them (a tracker's lookahead window): each tile enters with the
    same sequence of map products either way."""
    S, NS, G = geom
    tile = S * NS
    n = (G + 3) * tile  # past an anchor
    a, ff, live, h0 = _stable_inputs(n, J, 3 * J)
    y, hist = _deep_model(a, ff, live, h0, geom, np.float32)
    for block in (tile, 2 * tile):
        h, parts = h0, []
        for s in range(0, n, block):
            yb, h = _deep_model(a[s:s + block], ff[s:s + block],
                                live[s:s + block], h, geom, np.float32)
            parts.append(yb)
        assert np.concatenate(parts).tobytes() == y.tobytes()
        assert h.tobytes() == hist.tobytes()


@pytest.mark.parametrize("J", DEEP_JS)
def test_deep_kernel_model_in_float32_within_bound(J):
    """The model in float32 at the kernel's geometry, over 2^14 lanes
    (16 tiles, look-backs over up to 14 maps), against the float64
    recurrence: within 2e-5 of scale (it errs 4.4e-6 at J = 9, 1.3e-6 and
    1.8e-6 at 12 and 16), as the plain version is held; the float16
    control errs far past it."""
    n = 1 << 14
    a, ff, live, h0 = _stable_inputs(n, J, J + 1)
    y, hist = _deep_model(a, ff, live, h0, KERNEL_GEOMETRY, np.float32)
    ry, rh = scan_ops.linear_recurrence_ref(
        t(a).double(), t(ff).double(), t(live), t(h0).double())
    scale = _scale(ry.numpy())
    err = max(np.abs(y - ry.numpy()).max(), np.abs(hist - rh.numpy()).max())
    assert err <= 2e-5 * scale
    cy, _ = scan_ops.affine_y_ref(t(a).half(), t(ff).half(), t(live),
                                          t(h0).half())
    assert np.abs(cy.double().numpy() - ry.numpy()).max() > 1e-3 * scale


# -- the deep scratch, without a card -----------------------------------------


def _deep_record():
    """kDeepRecord: kDeepMaxJ + 1 columns of deep_col(kDeepMaxJ) floats."""
    J = scan_ops.MAX_DEEP_J
    col = (J + 3) // 4 * 4
    return (J + 1) * (col if (col // 4) % 2 else col + 4)


def _deep_scratch_words(tiles):
    """tuun_affine_deep_scratch_words: the affine scan's head and flags,
    then kDeepRecord floats a tile from a 4-word boundary."""
    return (2 + tiles + 3) // 4 * 4 + tiles * _deep_record()


def test_deep_records_hold_every_depth():
    rec = _deep_record()
    assert rec % 4 == 0  # records on 16-byte boundaries
    for J in range(scan_ops.MAX_J + 1, scan_ops.MAX_DEEP_J + 1):
        col = (J + 3) // 4 * 4
        col += 0 if (col // 4) % 2 else 4
        assert J <= col and (J + 1) * col <= rec
    for tiles in (1, 2, 3, 4, 5, 1024):
        off = (2 + tiles + 3) // 4 * 4
        assert off >= 2 + tiles and _deep_scratch_words(tiles) == \
            off + tiles * rec


def test_deep_scratch_grows_keyed_by_stream_and_owner(monkeypatch):
    monkeypatch.setattr(scan_ops, "_deep_scratch", {})
    monkeypatch.setattr(scan_ops, "_affine_retired", [])
    monkeypatch.setattr(scan_ops, "_owner_retired", {})
    monkeypatch.setattr(scan_ops, "_deep_tile", 1024)
    made = []

    def alloc(device, tiles):
        made.append((device, tiles))
        return torch.zeros(4, dtype=torch.int32)

    first = scan_ops.DEEP_SCRATCH_MIN_LANES // 1024
    buf, cap = scan_ops.deep_scratch(0, 7, 128, alloc)
    assert cap == first and made == [(0, first)]
    assert scan_ops.deep_scratch(0, 7, first, alloc) == (buf, cap)
    buf2, cap2 = scan_ops.deep_scratch(0, 7, first + 1, alloc)
    assert cap2 == 2 * first and scan_ops._affine_retired == [buf]
    other, _ = scan_ops.deep_scratch(0, 8, 2, alloc)  # another stream
    assert other is not buf2
    owner = object()
    with scan_ops.graph_scope(owner):
        mine, _ = scan_ops.deep_scratch(0, 7, 2, alloc)
        assert mine is not buf2
        scan_ops.deep_scratch(0, 7, 3 * first, alloc)
    assert set(scan_ops._deep_scratch) == {(0, 7), (0, 8), (0, 7, owner)}
    assert len(scan_ops._owner_retired[owner]) == 1
    scan_ops.release_scratch(owner)
    assert set(scan_ops._deep_scratch) == {(0, 7), (0, 8)}
    assert owner not in scan_ops._owner_retired
    # The affine scan's own table is untouched, and a CPU tensor takes
    # the plain version and touches no scratch.
    assert made[-1] == (0, 3 * first) and len(made) == 5
    a, ff, live, h0 = _stable_inputs(5000, 12, 3)
    scan_ops.affine_scan_deep_f32(t(a), t(ff), t(live), t(h0))
    assert len(made) == 5


def test_deep_scratch_made_during_capture_raises(monkeypatch):
    monkeypatch.setattr(scan_ops, "_deep_scratch", {})
    monkeypatch.setattr(scan_ops, "_deep_tile", 1024)

    class Lib:
        @staticmethod
        def tuun_affine_deep_scratch_words(tiles):
            return _deep_scratch_words(tiles)

    monkeypatch.setattr(scan_ops, "load_library", lambda: Lib)
    made = []
    monkeypatch.setattr(torch, "zeros", lambda *a, **k: made.append((a, k)))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    scan_ops.deep_scratch(3, 9, 10)
    first = scan_ops.DEEP_SCRATCH_MIN_LANES // 1024
    assert made == [((_deep_scratch_words(first),),
                     {"dtype": torch.int32, "device": 3})]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="before capturing"):
        scan_ops.deep_scratch(3, 9, 4 * first)
    assert len(made) == 1
