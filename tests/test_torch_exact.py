"""The port's exact precisions (exact and exact_df) on the CPU.

  * The linear recurrence's plain version (scan_ops.linear_recurrence_ref,
    the exact-mode IIR that the kernel in csrc/exact.cu runs on the card)
    against tuun_tpu's CFilter._feedback, a lax.scan, in both exact
    precisions, at every depth the engine renders; its rows form row by
    row; its batching rule.
  * chip_smoke.py's phase-11 gates at CPU scale, the twins of
    tests/test_bench_regression.py's fuzz, shape and long-render harness
    tests: the same functions the card runs, with device="cpu".
  * exact_df through the app: the port's Tracker against tuun_tpu's on a
    polyphonic score, the group path with warnings as errors, and a
    modify script that carries the df phase pair.
"""

import importlib.util
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_groups as ttg
import test_torch_modify as ttm
import tuun_tpu
import tuun_tpu_torch
from tuun_tpu import tracker as jtracker
from tuun_tpu.engine.graph import CFilter as JaxFilter
from tuun_tpu.engine.graph import EngineConfig as JaxConfig
from tuun_tpu_torch.engine import EngineConfig, scan_ops
from tuun_tpu_torch.tracker import Tracker

torch.set_num_threads(1)
CPU = "cpu"
REPO = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_tests", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# The linear recurrence's plain version
# ---------------------------------------------------------------------------


def _feedback_inputs(rng, J, n, dtype, lead=()):
    """A stable all-pole section with per-lane jitter, 10% dead lanes and a
    dead run, and a carried history."""
    roots = [0.9, 0.8, 0.5 + 0.3j, 0.5 - 0.3j, -0.6, 0.7j, -0.7j, 0.3, -0.4,
             0.2 + 0.5j, 0.2 - 0.5j, -0.85]
    if J in (1, 3):
        roots = {1: [0.5], 3: [0.896, 0.896, 0.801]}[J]
    base = np.real(np.poly(roots[:J]))[1:]
    a = (base + 1e-3 * rng.standard_normal((*lead, n, J))).astype(dtype)
    ff = rng.standard_normal((*lead, n)).astype(dtype)
    live = rng.random((*lead, n)) > 0.1
    live[..., n // 2:n // 2 + 7] = False
    h0 = rng.standard_normal((*lead, J)).astype(dtype)
    return a, ff, live, h0


def _jax_feedback(precision, a, ff, live, h0):
    """tuun_tpu's CFilter._feedback on the same inputs (its lax.scan in
    the inputs' dtype; x64 is on in the tests)."""
    node = JaxFilter.__new__(JaxFilter)
    node.cfg = JaxConfig(8000, precision, jit=False)
    node.J = a.shape[1]
    y, hist = node._feedback(jnp.asarray(ff), [jnp.asarray(a[:, j])
                                               for j in range(node.J)],
                             jnp.asarray(h0), jnp.asarray(live))
    return np.asarray(y), np.asarray(hist)


def _numpy_recurrence(a, ff, live, h0, fused):
    """The recurrence lane by lane in numpy float32: each product and
    difference rounded on its own (the oracle's order, oracle.py:330-337),
    or, with fused=True, each acc - a*h rounded once, as a fused
    multiply-add rounds it."""
    J = a.shape[1]
    h = [np.float32(x) for x in h0]
    y = np.zeros(len(ff), np.float32)
    for i in range(len(ff)):
        acc = np.float32(ff[i])
        for j in range(J):
            if fused:
                acc = np.float32(np.float64(acc)
                                 - np.float64(a[i, j]) * np.float64(h[j]))
            else:
                acc = np.float32(acc - np.float32(a[i, j] * h[j]))
        if live[i]:
            h = [acc] + h[:-1]
            y[i] = acc
    return y, np.array(h, np.float32)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32 if x.dtype == np.float32 else np.int64)


@pytest.mark.parametrize("precision", ["exact", "exact_df"])
@pytest.mark.parametrize("J", [1, 2, 3, 8, 9, 12])
def test_recurrence_ref_matches_jax_feedback_f64(J, precision):
    """float64 inputs: within 1e-12 of the output's scale of tuun_tpu's
    scan (x64 is on in the tests)."""
    rng = np.random.default_rng(J)
    a, ff, live, h0 = _feedback_inputs(rng, J, 300, np.float64)
    y, hist = scan_ops.linear_recurrence(t(a), t(ff), t(live), t(h0))
    wy, wh = _jax_feedback(precision, a, ff, live, h0)
    assert y.dtype == hist.dtype == torch.float64
    tol = 1e-12 * max(1.0, float(np.abs(wy).max()))
    assert np.abs(y.numpy() - wy).max() <= tol
    assert np.abs(hist.numpy() - wh).max() <= tol
    assert np.all(y.numpy()[~live] == 0)


@pytest.mark.parametrize("precision", ["exact", "exact_df"])
@pytest.mark.parametrize("J", [1, 2, 3, 8, 9, 12])
def test_recurrence_ref_matches_jax_feedback_f32(J, precision):
    """float32, the engine's type in both exact precisions.  The plain
    version has the oracle's rounding: bit for bit a numpy loop that
    rounds each product and difference on its own.  XLA's CPU backend
    contracts the scan body's `acc - a_row[j] * h[j]`
    (tuun_tpu/engine/graph.py:858) into a fused multiply-add: tuun_tpu's
    result is bit for bit the same loop with each of those rounded once.
    The one rounding per product between them is all that differs, and a
    filter amplifies it by its condition (up to 1.6e-5 of scale here, at
    J = 3's near-repeated poles), so the two are held to each other only
    within 1e-4 of scale."""
    rng = np.random.default_rng(J)
    a, ff, live, h0 = _feedback_inputs(rng, J, 300, np.float32)
    y, hist = scan_ops.linear_recurrence(t(a), t(ff), t(live), t(h0))
    assert y.dtype == hist.dtype == torch.float32
    ry, rh = _numpy_recurrence(a, ff, live, h0, fused=False)
    assert np.array_equal(_bits(y.numpy()), _bits(ry))
    assert np.array_equal(_bits(hist.numpy()), _bits(rh))
    wy, wh = _jax_feedback(precision, a, ff, live, h0)
    fy, fh = _numpy_recurrence(a, ff, live, h0, fused=True)
    assert np.array_equal(_bits(wy), _bits(fy))
    assert np.array_equal(_bits(wh), _bits(fh))
    tol = 1e-4 * max(1.0, float(np.abs(wy).max()))
    assert np.abs(y.numpy() - wy).max() <= tol


def test_recurrence_ref_carries_history_across_calls():
    """Two calls, the second from the first's history, give the bits of
    one call over both: the history the engine carries between blocks."""
    rng = np.random.default_rng(3)
    a, ff, live, h0 = (t(x) for x in _feedback_inputs(rng, 3, 200,
                                                       np.float32))
    y, hist = scan_ops.linear_recurrence(a, ff, live, h0)
    y1, h1 = scan_ops.linear_recurrence(a[:77].contiguous(), ff[:77],
                                        live[:77], h0)
    y2, h2 = scan_ops.linear_recurrence(a[77:].contiguous(), ff[77:],
                                        live[77:], h1)
    assert torch.equal(torch.cat([y1, y2]), y) and torch.equal(h2, hist)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_recurrence_rows_equal_row_by_row_calls(dtype):
    rng = np.random.default_rng(5)
    a, ff, live, h0 = (t(x) for x in _feedback_inputs(rng, 3, 150, dtype,
                                                       (4,)))
    live[2] = False  # a row with no live lane passes its history through
    y, hist = scan_ops.linear_recurrence_rows(a, ff, live, h0)
    for r in range(4):
        ys, hs = scan_ops.linear_recurrence(a[r], ff[r], live[r], h0[r])
        assert torch.equal(ys, y[r]) and torch.equal(hs, hist[r])
    assert torch.equal(hist[2], h0[2]) and not y[2].any()


def test_recurrence_under_vmap_takes_the_rows_form():
    rng = np.random.default_rng(6)
    a, ff, live, h0 = (t(x) for x in _feedback_inputs(rng, 2, 64,
                                                       np.float32, (3,)))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        y, hist = torch.func.vmap(scan_ops.linear_recurrence)(a, ff, live,
                                                               h0)
    want = scan_ops.linear_recurrence_rows(a, ff, live, h0)
    assert torch.equal(y, want[0]) and torch.equal(hist, want[1])


def test_recurrence_wrappers_check_their_inputs():
    a, ff, live, h0 = (torch.zeros(8, 2), torch.zeros(8),
                       torch.ones(8, dtype=torch.bool), torch.zeros(2))
    bad = [(a.double(), ff, live, h0), (a, ff[:7], live, h0),
           (a, ff, live.float(), h0), (a, ff, live, torch.zeros(3)),
           (torch.zeros(8, 0), ff, live, torch.zeros(0)),
           (a.t().contiguous().t(), ff, live, h0)]
    for args in bad:
        with pytest.raises(ValueError):
            scan_ops.linear_recurrence(*args)
    with pytest.raises(ValueError):
        scan_ops.linear_recurrence_rows(a, ff, live, h0)


def test_engine_config_accepts_both_exact_precisions():
    for precision, pd in (("exact", torch.float64),
                          ("exact_df", torch.float32)):
        cfg = EngineConfig(8000, precision, CPU)
        assert cfg.sequential_iir and cfg.phase_dtype == pd
        assert cfg.df_phase == (precision == "exact_df")
    with pytest.raises(ValueError):
        EngineConfig(8000, "exact_f64", CPU)


# ---------------------------------------------------------------------------
# chip_smoke.py's phase-11 gates at CPU scale
# ---------------------------------------------------------------------------


def test_fuzz_gate_on_cpu(capsys):
    """The fuzz gate with a small bank (4 structures x 2 const-jitter
    variants): fast, exact_df and exact renders of every case hold their
    gates against the oracle."""
    ok, fail, skip, failures = _chip_smoke().gate_fuzz(
        "cpu", seed0=5000, n_structs=4, n_variants=2)
    assert fail == 0, failures
    assert ok >= 4
    out = capsys.readouterr().out
    assert "# fuzz:" in out and "seeds 5000..5003" in out
    assert "2 const-jitter variants" in out
    assert "fast+exact_df+exact on cpu" in out


def test_shape_gate_on_cpu(capsys):
    """The four production-shape classes at CPU scale, both exact
    precisions, offline and in 1024-lane blocks, within SHAPE_TOL."""
    assert _chip_smoke().gate_shapes("cpu", n=1 << 13, sr=8000)
    out = capsys.readouterr().out
    assert "# fuzz_shapes: 16 ok / 0 fail" in out
    for cname in ("nco", "fm", "filter", "reset"):
        for prec in ("exact_df", "exact"):
            assert f"{cname}/offline/{prec}" in out
            assert f"{cname}/stream/{prec}" in out


def test_longrender_gate_on_cpu(capsys):
    """The 64-second score's machinery over its first 2 s: source through
    the evaluator and optimizer, exact_df against the native oracle."""
    cs = _chip_smoke()
    passed, row = cs.gate_longrender("cpu", n=2 * cs.EXACT_SR)
    assert passed, row
    assert "# longrender: PASS" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# exact_df through the app
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sync_interval", [1, 4])
def test_exact_df_tracker_matches_jax_tracker(sync_interval):
    """test_torch_groups.py's polyphonic score (an FM group, filtered saws,
    generic resets) in exact_df through both trackers, per-call path (fuse
    off) at sync_interval 1 and deferred sync at 4.  Per sample within
    1e-5: float32 sin and the last compensated bits of the phase sums
    differ, over up to 24 voices."""
    sr, block = ttg.SR, 128
    jt = jtracker.Tracker(sr, block, precision="exact_df", jit=True,
                          sync_interval=sync_interval)
    jt.fuse = False
    want, jst = ttg._run(jt, ttg._score(tuun_tpu, sr))
    jt.close()
    pt = Tracker(sr, block, precision="exact_df", device=CPU,
                 sync_interval=sync_interval)
    pt.fuse = False
    got, pst = ttg._run(pt, ttg._score(tuun_tpu_torch, sr))
    pt.close()
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert [s.voices for s in pst] == [s.voices for s in jst]
    assert max(s.dispatches for s in pst) < max(s.voices for s in pst)


@pytest.mark.parametrize("precision", ["exact", "exact_df"])
def test_exact_group_path_runs_without_vmap_fallback(precision):
    """The score's groups in both exact precisions through the tracker,
    every warning an error: the recurrence and the df prefix sum reach
    their rows forms through their batching rules."""
    tr = Tracker(ttg.SR, 128, precision=precision, device=CPU)
    tr.fuse = False
    calls = {"rec": 0, "df": 0}
    rec, df = scan_ops.linear_recurrence_rows, scan_ops.df_prefix_sum_rows_f32

    def count(key, fn):
        def wrapped(*a):
            calls[key] += 1
            return fn(*a)
        return wrapped
    scan_ops.linear_recurrence_rows = count("rec", rec)
    scan_ops.df_prefix_sum_rows_f32 = count("df", df)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            out, status = ttg._run(tr, ttg._score(tuun_tpu_torch, ttg.SR))
    finally:
        scan_ops.linear_recurrence_rows = rec
        scan_ops.df_prefix_sum_rows_f32 = df
        tr.close()
    assert np.isfinite(out).all()
    assert max(s.voices - s.dispatches for s in status) >= 6
    assert calls["rec"] > 0
    assert (calls["df"] > 0) == (precision == "exact_df")


def test_exact_df_modify_script_matches_jax_tracker():
    """test_torch_modify.py's script in exact_df: an FM group member's
    amplitude ramp splices its voice, whose sine carries its (hi, lo)
    phase pair through carry_state; a filter coefficient ramp; a stop."""
    jt = jtracker.Tracker(ttm.SCRIPT_SR, ttm.SCRIPT_BLOCK,
                          precision="exact_df", jit=False)
    want, jd = ttm._run_script(jt, tuun_tpu)
    jt.close()
    pt = Tracker(ttm.SCRIPT_SR, ttm.SCRIPT_BLOCK, precision="exact_df",
                 device=CPU, jit=False)  # per-call blocks, as JAX's eager
    got, pd = ttm._run_script(pt, tuun_tpu_torch)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert pd == jd
    ops = [op for op in pt.op_log if op[0] == "modify"]
    assert len(ops) == 3
    # The spliced FM voice kept a df pair as its sine's accumulator.
    fm1 = next(v for v in pt.active if v.id == "fm1")
    pairs = [leaf for leaf in _tuples(fm1.state)
             if isinstance(leaf, tuple) and len(leaf) == 2
             and all(isinstance(x, torch.Tensor) and x.dtype == torch.float32
                     and x.dim() == 0 for x in leaf)]
    assert pairs and any(float(p[1]) != 0.0 for p in pairs)
    pt.close()


def _tuples(tree):
    """Every tuple of a state tree, outermost first."""
    if isinstance(tree, tuple):
        yield tree
        for x in tree:
            yield from _tuples(x)


def test_session_and_repl_take_exact_df(tmp_path):
    """TuunSession and Repl pass exact_df through to their tracker: an
    FM program through a filter, installed in the port's session and in
    tuun_tpu's, the same blocks within 1e-5; the REPL plays and renders
    a program of its song."""
    import io

    import test_torch_repl as ttr
    from tuun_tpu.session import TuunSession as JaxSession
    from tuun_tpu_torch.repl import Repl
    from tuun_tpu_torch.session import TuunSession

    expr = "sine(2*pi*(220 + 30*$(5)), 0) * 0.5 | lpf(0.7, 300)"
    mixes = []
    for cls, kw in ((JaxSession, dict(jit=False)),
                    (TuunSession, dict(device=CPU))):
        s = cls(sample_rate=800, tempo=60, block_size=64,
                precision="exact_df", **kw)
        assert s.install(expr) == "waveform"
        assert s.tracker.cfg.precision == "exact_df"
        mixes.append(np.concatenate([np.asarray(s.process())
                                     for _ in range(6)]))
    assert mixes[1].any()
    np.testing.assert_allclose(mixes[1], mixes[0], rtol=0, atol=1e-5)

    src = tmp_path / "song.tuun"
    src.write_text(ttr.SONG)
    r = Repl(sample_rate=100, tempo=60, buffer_size=20,
             library_root=ttr.STDLIB, precision="exact_df", jit=False,
             out=io.StringIO(), device=CPU)
    r.dispatch(f"load {src}")
    r.dispatch("play A2")
    r.dispatch("render 1.0")
    assert r.tracker.cfg.precision == "exact_df"
    assert np.isfinite(r.rendered[-1]).all() and r.rendered[-1].any()
