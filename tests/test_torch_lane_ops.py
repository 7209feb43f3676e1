"""The engine's interval gates (tuun_tpu_torch.engine.lane_ops, and
graph.py's _gate and _mask that call them on every device) on the CPU.

On a CPU tensor lane_ops runs its plain version over the operands as
csrc/lanes.cu's kernel reads them (pointer, row stride, lane mode or an
immediate), so these tests hold the layouts that its batched path
(kernels.vmapped into the rows forms) hands the kernel to the engine's
plain expression, torch.where((idx >= s) & (idx < e), a, b), bit for
bit: every operand form, with and without torch.func.vmap, at edge
intervals.  The kernel itself is held to the
same expression on the card by chip_smoke.py's lanes phase.
"""

import itertools

import pytest
import torch

from tuun_tpu_torch.engine import graph, kernels, lane_ops

torch.set_num_threads(1)

N = 37
IDX = torch.arange(N)
# One interval a row: the whole block, inside it, s < 0, e > n, s > e,
# empty, e = n, and both past the block.
STARTS = (0, 3, -5, 20, 25, 12, 30, N)
ENDS = (N, 30, 10, N + 9, 7, 12, N, N + 4)
B = len(STARTS)
# The bounds when vmap does not batch them: shared by every row.
SHARED_S, SHARED_E = -3, 29

# An operand's forms: a tensor of rows (batched [n] a voice), a lane
# vector every row shares, one value a row (batched 0-dim), one 0-dim
# tensor every row shares, an immediate.
FORMS = ("rows", "lanes", "row_scalar", "scalar", "immediate")


def _values(form, seed):
    g = torch.Generator().manual_seed(seed)
    if form == "rows":
        return torch.randn(B, N, generator=g), 0
    if form == "lanes":
        return torch.randn(N, generator=g), None
    if form == "row_scalar":
        return torch.randn(B, generator=g), 0
    if form == "scalar":
        return torch.randn((), generator=g), None
    return 0.75 + seed, None


def _row(x, dim, r):
    return x.select(dim, r) if dim is not None else x


def _bounds(batched_s, batched_e):
    s = (torch.tensor(STARTS), 0) if batched_s else (
        torch.tensor(SHARED_S), None)
    e = (torch.tensor(ENDS), 0) if batched_e else (torch.tensor(SHARED_E),
                                                   None)
    return s, e


def _expression(s, e, a, b):
    return torch.where((IDX >= s) & (IDX < e), a, b)


@pytest.mark.parametrize("vmapped", (True, False), ids=("vmap", "loop"))
@pytest.mark.parametrize("bounds", list(itertools.product((True, False),
                                                          repeat=2)),
                         ids=lambda p: f"s{'B' if p[0] else '1'}"
                         f"e{'B' if p[1] else '1'}")
@pytest.mark.parametrize("a_form,b_form", list(itertools.product(FORMS,
                                                                 FORMS)))
def test_gate_is_the_expression(a_form, b_form, bounds, vmapped):
    """interval_gate equals torch.where over the lane mask bit for bit,
    for each operand form and each end batched or shared, under vmap (the
    batching rule's rows) and voice by voice."""
    (s, ds), (e, de) = _bounds(*bounds)
    a, da = _values(a_form, 1)
    b, db = _values(b_form, 2)
    want = torch.stack([_expression(_row(s, ds, r), _row(e, de, r),
                                    _row(a, da, r), _row(b, db, r))
                        for r in range(B)])
    if vmapped:
        args = [(x, d) for x, d in ((s, ds), (e, de), (a, da), (b, db))]
        # A voice axis of its own where vmap batches no operand: the
        # gate then runs unbatched inside vmap, shared by every row.
        tensors = [torch.zeros(B)] + [x for x, d in args
                                      if isinstance(x, torch.Tensor)]
        dims = [0] + [d for x, d in args if isinstance(x, torch.Tensor)]

        def fn(_, *ts):
            it = iter(ts)
            vals = [next(it) if isinstance(x, torch.Tensor) else x
                    for x, _ in args]
            return lane_ops.interval_gate(IDX, *vals)
        got = torch.func.vmap(fn, in_dims=tuple(dims))(*tensors)
    else:
        got = torch.stack([lane_ops.interval_gate(
            IDX, _row(s, ds, r), _row(e, de, r), _row(a, da, r),
            _row(b, db, r)) for r in range(B)])
    assert got.dtype == torch.float32 and got.shape == (B, N)
    assert torch.equal(got, want)


@pytest.mark.parametrize("vmapped", (True, False), ids=("vmap", "loop"))
@pytest.mark.parametrize("bounds", [(True, True), (True, False),
                                    (False, True), (False, False)],
                         ids=("sBeB", "sBe1", "s1eB", "s1e1"))
def test_mask_is_the_expression(bounds, vmapped):
    (s, ds), (e, de) = _bounds(*bounds)
    want = torch.stack([(IDX >= _row(s, ds, r)) & (IDX < _row(e, de, r))
                        for r in range(B)])
    if vmapped and (ds is not None or de is not None):
        got = torch.func.vmap(
            lambda si, ei: lane_ops.interval_mask(IDX, si, ei),
            in_dims=(ds, de))(s, e)
    else:
        got = torch.stack([lane_ops.interval_mask(IDX, _row(s, ds, r),
                                                  _row(e, de, r))
                           for r in range(B)])
    assert got.dtype == torch.bool and torch.equal(got, want)


@pytest.mark.parametrize("se", list(zip(STARTS, ENDS)) + [(-9, -2),
                                                          (N, N)],
                         ids=str)
def test_edge_intervals_as_ints_and_tensors(se):
    """An end may be a Python int or a 0-dim int64 tensor: empty, s < 0,
    e > n, s > e and e = n select as the compares do."""
    s, e = se
    a = torch.randn(N)
    for sv, ev in ((s, e), (torch.tensor(s), torch.tensor(e)),
                   (s, torch.tensor(e))):
        want = _expression(s, e, a, -1.0)
        got = lane_ops.interval_gate(IDX, sv, ev, a, -1.0)
        assert torch.equal(got, want)
        assert torch.equal(lane_ops.interval_mask(IDX, sv, ev),
                           (IDX >= s) & (IDX < e))


@pytest.mark.parametrize("layout", ("bdim1", "strided", "misaligned",
                                    "expanded"))
def test_gate_under_vmap_reads_any_layout(layout):
    """Operands whose batch dimension is not the first, whose lanes are
    strided or start off a 16-byte boundary, or that are expanded along
    the lanes, select as the expression does."""
    g = torch.Generator().manual_seed(7)
    base = torch.randn(B, 2 * N + 1, generator=g)
    in_dim = 0
    if layout == "bdim1":
        a, in_dim = base[:, :N].t().contiguous(), 1
    elif layout == "strided":
        a = base[:, :2 * N:2]
    elif layout == "misaligned":
        a = base[:, 1:N + 1]
    else:
        a = base[:, :1].expand(B, N)
    s, e = torch.tensor(STARTS), torch.tensor(ENDS)
    got = torch.func.vmap(
        lambda si, ei, ai: lane_ops.interval_gate(IDX, si, ei, ai, 0.0),
        in_dims=(0, 0, in_dim))(s, e, a)
    rows = a.t() if in_dim == 1 else a
    want = torch.stack([_expression(s[r], e[r], rows[r], 0.0)
                        for r in range(B)])
    assert torch.equal(got, want)


def test_vmap_rule_reads_shared_operands_in_place(monkeypatch):
    """The batching rule hands an operand that vmap does not batch to the
    kernel as it is, with row stride 0 (never expanded to rows), a
    batched one with its own row stride; aligned lanes take the
    vector mode, misaligned ones not."""
    seen = []
    real = lane_ops._gate_rows

    def spy(rows, n, s, e, a, b, device, shape):
        seen.append((rows, n, s, e, a, b))
        return real(rows, n, s, e, a, b, device, shape)
    monkeypatch.setattr(lane_ops, "_gate_rows", spy)
    shared = torch.randn(N + 1)[:N]
    rows = torch.randn(B, N + 1)[:, 1:]
    s = torch.tensor(STARTS)
    torch.func.vmap(lambda si, bi: lane_ops.interval_gate(
        IDX, si, 40, shared, bi))(s, rows)
    [(nrows, n, bs, be, a, b)] = seen
    assert (nrows, n) == (B, N)
    assert bs[0].data_ptr() == s.data_ptr() and bs[1] == 1
    assert be == (None, 0, 40)
    assert a[0].data_ptr() == shared.data_ptr() and a[1:3] == (
        0, lane_ops.LANES_VEC)
    assert b[0].data_ptr() == rows.data_ptr() and b[1:3] == (
        N + 1, lane_ops.LANES)


def test_engine_helpers_are_the_expression_on_the_cpu():
    """graph.py's _gate and _mask, lane_ops on the CPU too, are the
    expression."""
    ctx = graph.Ctx(N, "cpu")
    a, b = torch.randn(N), torch.randn(N)
    for s, e in zip(STARTS, ENDS):
        st, et = torch.tensor(s), torch.tensor(e)
        m = (ctx.idx >= st) & (ctx.idx < et)
        assert torch.equal(graph._mask(ctx, st, et), m)
        assert torch.equal(graph._gate(ctx, st, et, a, b),
                           torch.where(m, a, b))
        assert torch.equal(graph._gate(ctx, st, et, a, 0.0),
                           torch.where(m, a, 0.0))


def test_refuses_other_dtypes_and_shapes():
    """The kernel takes float32 operands of shape () or [n] and int64
    ends; the plain version refuses what the kernel would."""
    with pytest.raises(ValueError, match="float32"):
        lane_ops.interval_gate(IDX, 0, N, torch.randn(N,
                                                      dtype=torch.float64),
                               0.0)
    with pytest.raises(ValueError, match="int64"):
        lane_ops.interval_gate(IDX, torch.tensor(0, dtype=torch.int32), N,
                               1.0, 0.0)
    with pytest.raises(ValueError, match="shape"):
        lane_ops.interval_gate(IDX, 0, N, torch.randn(N + 1), 0.0)


@pytest.mark.chip
def test_gate_refuses_other_dtypes_on_the_card():
    """On the card the helpers launch the kernel or raise: a float64
    operand is refused, not computed by a plain fallback."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    ctx = graph.Ctx(N, "cuda")
    with pytest.raises(ValueError, match="float32"):
        graph._gate(ctx, ctx.zero, ctx.end,
                    torch.ones(N, dtype=torch.float64, device="cuda"), 0.0)


def test_captures_count_gate_launches_without_a_scan_call():
    """A launch made while a graph captures is the capture's, counted at
    each replay (kernels.count_launches), and records no scan call, so
    no tuun.scan.* marker names it."""
    kernels.reset_launches()
    with kernels.graph_scope(object(), record=True) as rec:
        kernels.launched(lane_ops.GATE, 0)
        kernels.launched(lane_ops.MASK, 0)
        kernels.launched(lane_ops.GATE, 0)
    assert rec == [] and dict(rec.launches) == {"interval_gate": 2,
                                                "interval_mask": 1}
    assert kernels.launches["interval_gate"] == 0
    kernels.count_launches(rec.launches)
    assert kernels.launches["interval_gate"] == 2
    assert kernels.launches["interval_mask"] == 1
    kernels.reset_launches()


def test_group_render_on_the_cpu_takes_the_batched_path(monkeypatch):
    """A voice group that the Tracker renders on the CPU gates its lanes
    through lane_ops under vmap, into the rows forms once a call for all
    its voices: the path every render on the card takes (graph._gate
    and _mask have no device fork)."""
    from pathlib import Path

    import tuun_tpu_torch
    from tuun_tpu_torch import optimizer
    from tuun_tpu_torch.evaluator import Evaluator
    from tuun_tpu_torch.tracker import Tracker
    calls = []
    for name in ("interval_gate_rows", "interval_mask_rows"):
        def counted(idx, *xs, real=getattr(lane_ops, name)):
            calls.append(idx.shape[0])
            return real(idx, *xs)
        monkeypatch.setattr(lane_ops, name, counted)
    stdlib = Path(tuun_tpu_torch.__file__).resolve().parent / "stdlib" / "v0"
    ev = Evaluator(8000, 60, stdlib)
    tracker = Tracker(8000, 128, precision="fast", device="cpu")
    for i, f in enumerate((220, 330, 440)):
        w = ev.evaluate_source(f"sine(2*pi*{f}, 0) * 0.5 | fin(time - 0.1)",
                               opens=("std",)).waveform
        tracker.play(i, optimizer.optimize(w), start=0)
    y, status = tracker.render_block()
    assert status.voices - status.dispatches == 2  # one group of three
    assert calls and set(calls) == {3}
    assert float(abs(y).max()) > 0.1
