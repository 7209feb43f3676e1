"""chip_smoke.py's launch-count logic on the CPU: the one-launch check
with a stand-in profiler, and phase 12's counts with stand-in checks.

check_one_launch reads the device kernels that torch.profiler saw for
phase 2's calls: more device work than one kernel a call fails at once,
fewer kernels than calls is returned as a short row (a profiler that
lost kernel records reads the same as a call that launched nothing).
check_launches_in_child runs the check in new child processes until one
sees every kernel, up to LAUNCH_ATTEMPTS, and fails if none does or if a
wrapper did not count its launch.

phase_tools counts the launches of phase 12's path from zero and fails
if one of TOOLS_KERNELS never launched; the launches of the recurrence's
bit check and of the deep times, made after the counts, are not the
path's.  The kernels line carries them as `tools_launches` (for the deep
affine scan, whose path phase 12 is, as `launches` too).
"""

import importlib.util
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

# Two calls of each kernel, as one_launch_calls lists them: (fn, args,
# kernel, tag); and the device names the profiler gives their kernels.
CALLS = [(None, (), "scan_single_pass", "SumOp"),
         (None, (), "affine_scan_pass", "<2,"),
         (None, (), "scan_single_pass", "SumOp"),
         (None, (), "affine_scan_pass", "<2,")]
SUM = "void (anonymous namespace)::scan_single_pass<SumOp, false>(float*)"
AFFINE = "void (anonymous namespace)::affine_scan_pass<2, false>(float*)"
ALL = [SUM, AFFINE, SUM, AFFINE]


@pytest.fixture
def smoke(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_launch_tests", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "one_launch_calls", lambda *a: CALLS)
    return mod


def _profiled(smoke, monkeypatch, names, counted=len(CALLS)):
    monkeypatch.setattr(smoke, "profile_calls",
                        lambda *a: (names, ["cudaLaunchKernel"] * counted,
                                    counted))
    return smoke.check_one_launch(None, None, None, None)


def test_one_launch_row_when_every_kernel_is_seen(smoke, monkeypatch):
    row = _profiled(smoke, monkeypatch, ALL)
    assert row["ok"] and row["short"] == {} and row["missing_calls"] == []
    assert (row["calls"], row["device_kernels"]) == (4, 4)


@pytest.mark.parametrize("names, missing", [
    ([AFFINE, SUM, AFFINE], [0]),
    ([SUM, AFFINE, SUM], [3]),
    ([SUM, SUM], [1, 3]),
    ([], [0, 1, 2, 3])])
def test_one_launch_short_count_is_returned(smoke, monkeypatch, names,
                                            missing):
    row = _profiled(smoke, monkeypatch, names)
    assert not row["ok"] and row["missing_calls"] == missing
    assert sum(w - s for s, w in row["short"].values()) == len(missing)


@pytest.mark.parametrize("names", [
    ALL + [SUM],
    ALL + ["Memset (Device)"],
    [SUM, AFFINE, SUM, "void other_kernel(float*)"]])
def test_one_launch_extra_device_work_fails(smoke, monkeypatch, names):
    with pytest.raises(smoke.SmokeFailure, match="more device work"):
        _profiled(smoke, monkeypatch, names)


def _children(smoke, monkeypatch, rows):
    """check_launches_in_child over a child that gives `rows` in turn;
    returns how many children ran."""
    ran = []

    def child(names):
        assert names == [smoke.LAUNCH_PROFILE]
        ran.append(1)
        return [rows[len(ran) - 1]]
    monkeypatch.setattr(smoke, "profile_in_child", child)
    smoke.check_launches_in_child()
    return len(ran)


def _row(ok, counted=4):
    return dict(ok=ok, calls=4, device_kernels=4 if ok else 3,
                host_launch_calls=4, wrapper_launches=counted,
                short={} if ok else {"scan_single_pass SumOp": [1, 2]},
                missing_calls=[] if ok else [0])


@pytest.mark.parametrize("shorts", [0, 1, 2])
def test_launch_child_is_run_again_after_a_short_count(smoke, monkeypatch,
                                                       shorts):
    rows = [_row(False)] * shorts + [_row(True)]
    assert _children(smoke, monkeypatch, rows) == shorts + 1


def test_launch_child_short_in_every_attempt_fails(smoke, monkeypatch):
    with pytest.raises(smoke.SmokeFailure, match="all 3 children"):
        _children(smoke, monkeypatch, [_row(False)] * smoke.LAUNCH_ATTEMPTS)


def test_launch_child_fails_when_a_wrapper_missed_its_count(smoke,
                                                           monkeypatch):
    with pytest.raises(smoke.SmokeFailure, match="wrappers counted 3"):
        _children(smoke, monkeypatch, [_row(False, counted=3), _row(True)])


# -- phase 12's counts ------------------------------------------------------


class _ScanOps:
    """A stand-in scan_ops: launches counted by name, reset to zero."""

    def __init__(self, smoke):
        self.launches = {k: 7 for k in smoke.EXACT_KERNELS
                         + smoke.SCAN_KERNELS + smoke.DEEP_KERNELS}

    def reset_launches(self):
        for k in self.launches:
            self.launches[k] = 0


def _tools(smoke, monkeypatch, path_kernels):
    """phase_tools with every check stood in: the path's checks launch
    `path_kernels` once each, the bit check and the times launch the
    recurrence 100 times.  Returns (counts, what ran in order)."""
    ops = _ScanOps(smoke)
    ran = []

    def path(name, kernels=()):
        def fn(*a, **k):
            ran.append(name)
            for kernel in kernels:
                ops.launches[kernel] += 1
        return fn
    monkeypatch.setattr(smoke, "deep_offline", path(
        "deep_offline", [k for k in path_kernels
                         if k in ("affine_scan_deep_f32",
                                  "linear_recurrence_f32")]))
    monkeypatch.setattr(smoke, "deep_session", path(
        "deep_session", [k for k in path_kernels
                         if k == "affine_scan_deep_rows_f32"]))
    monkeypatch.setattr(smoke, "tools_corpus", path("tools_corpus"))
    monkeypatch.setattr(smoke, "tools_profile", path(
        "tools_profile", [k for k in path_kernels
                          if k in ("prefix_sum_f32", "prefix_max_f32",
                                   "affine_scan_f32")]))
    monkeypatch.setattr(smoke, "tools_scope", path("tools_scope"))
    monkeypatch.setattr(smoke, "tools_spectra", path("tools_spectra"))
    after = path("after", ["linear_recurrence_f32"] * 100)
    monkeypatch.setattr(smoke, "deep_recurrence_bits", after)
    monkeypatch.setattr(smoke, "deep_times", after)
    counts = smoke.phase_tools(None, None, ops, Path("."))
    return counts, ran


def test_phase_tools_counts_only_its_path(smoke, monkeypatch):
    counts, ran = _tools(smoke, monkeypatch, smoke.TOOLS_KERNELS)
    assert ran == ["deep_offline", "deep_session", "tools_corpus",
                   "tools_profile", "tools_scope", "tools_spectra", "after",
                   "after"]
    assert {k for k, c in counts.items() if c} == set(smoke.TOOLS_KERNELS)
    assert all(counts[k] == 1 for k in smoke.TOOLS_KERNELS)


@pytest.mark.parametrize("missing", [
    "prefix_sum_f32", "prefix_max_f32", "affine_scan_f32",
    "affine_scan_deep_f32", "affine_scan_deep_rows_f32",
    "linear_recurrence_f32"])
def test_phase_tools_fails_when_a_kernel_never_launched(smoke, monkeypatch,
                                                        missing):
    kernels = [k for k in smoke.TOOLS_KERNELS if k != missing]
    with pytest.raises(smoke.SmokeFailure, match=missing):
        _tools(smoke, monkeypatch, kernels)


def test_deep_rows_carry_phase_12_launches(smoke):
    rows_of = {"affine_scan_deep_f32": (1, 1 << 16, 16),
               "affine_scan_deep_rows_f32": (4, 1024, 12)}
    results = {}
    for i, (k, (B, n, J)) in enumerate(rows_of.items()):
        main = dict(ms=1.0 + i, plain_ms=2.0, device_ms=0.5,
                    plain_device_ms=9.0, host_us=9.0, B=B, n=n, J=J,
                    err=1e-6, **smoke.deep_bound(B, n, J))
        other = dict(main, n=1000, ms=50.0, err=3e-6)
        results[k] = [other, main]
    tools = {k: 10 + i for i, k in enumerate(smoke.DEEP_KERNELS)}
    phases = {p: dict.fromkeys(smoke.DEEP_KERNELS, 0)
              for p in ("main", "session", "repl", "exact", "mesh")}
    rows = smoke.deep_kernel_rows(results, dict(phases, tools=tools))
    assert [r["name"] for r in rows] == list(smoke.DEEP_KERNELS)
    for r, (k, shape) in zip(rows, rows_of.items()):
        assert r["launches"] == r["tools_launches"] == tools[k]
        assert all(r[f"{p}_launches"] == 0 for p in phases)
        assert r["shape"] == list(shape) and r["max_abs_err"] == 3e-6
        assert r["ms"] < 50 and r["library_ms"] is None
        assert r["bound_by"] == "bytes"
        B, n, J = shape
        assert r["bound_ms"] == pytest.approx(
            B * n * (4 * J + 9) / smoke.HBM_BYTES_PER_S * 1e3)
        assert {"replaces", "source", "route", "plain_ms", "device_ms",
                "host_us"} <= set(r)


def test_exact_rows_carry_tools_launches(smoke):
    main = dict(ms=1.0, plain_ms=2.0, device_ms=0.5, host_us=9.0, B=1,
                n=8, bound_ms=0.1, bound_by="bytes", library_ms=None,
                err=0.0)
    results = {k: [main] for k in smoke.EXACT_KERNELS}
    counts = {k: i for i, k in enumerate(smoke.EXACT_KERNELS)}
    tools = {k: 10 + i for i, k in enumerate(smoke.EXACT_KERNELS)}
    mesh = {k: 20 + i for i, k in enumerate(smoke.EXACT_KERNELS)}
    rows = smoke.exact_kernel_rows(results, counts, tools, mesh)
    assert [r["tools_launches"] for r in rows] == \
        [tools[k] for k in smoke.EXACT_KERNELS]
    assert [r["mesh_launches"] for r in rows] == \
        [mesh[k] for k in smoke.EXACT_KERNELS]
    assert [r["exact_launches"] for r in rows] == \
        [counts[k] for k in smoke.EXACT_KERNELS]


# -- phase 13's counts ------------------------------------------------------


def _mesh(smoke, monkeypatch, meshed_kernels):
    """phase_mesh with its parts stood in: each meshed render (through
    `counted`) launches `meshed_kernels` once each, each meshless
    reference and M2's dryrun launch every rows kernel 100 times.
    Returns (counts, what ran in order)."""
    from tuun_tpu_torch import graft_entry
    ops = _ScanOps(smoke)
    ran = []

    def launch(kernels, times=1):
        for kernel in kernels:
            ops.launches[kernel] += times

    def part(name):
        def fn(torch, np, scan_ops, counts, device="cuda"):
            ran.append(name)
            launch(smoke.MESH_KERNELS, 100)  # a meshless reference
            smoke.counted(scan_ops, counts, launch, meshed_kernels)
        return fn
    for name in ("phase_m1", "phase_m3", "phase_mesh_exact"):
        monkeypatch.setattr(smoke, name, part(name))

    def dryrun(n, device="cuda"):
        ran.append("dryrun")
        launch(smoke.MESH_KERNELS, 100)
        return {}
    monkeypatch.setattr(graft_entry, "dryrun_multichip", dryrun)
    counts = smoke.phase_mesh(None, None, ops)
    return counts, ran


def test_phase_mesh_counts_only_its_meshed_renders(smoke, monkeypatch):
    counts, ran = _mesh(smoke, monkeypatch, smoke.MESH_KERNELS)
    assert ran == ["phase_m1", "phase_m3", "phase_mesh_exact", "dryrun"]
    assert {k for k, c in counts.items() if c} == set(smoke.MESH_KERNELS)
    assert all(counts[k] == 3 for k in smoke.MESH_KERNELS)


@pytest.mark.parametrize("missing", [
    "prefix_sum_rows_f32", "prefix_max_rows_f32", "affine_scan_rows_f32"])
def test_phase_mesh_fails_when_a_rows_kernel_never_launched(
        smoke, monkeypatch, missing):
    kernels = [k for k in smoke.MESH_KERNELS if k != missing]
    with pytest.raises(smoke.SmokeFailure, match=missing):
        _mesh(smoke, monkeypatch, kernels)


# -- the recurrence's times and phase 11's launches by length --------------


def test_rec_times_cover_the_main_path_shapes(smoke):
    shapes = {(B, n, J, dt) for B, n, J, dt in smoke.REC_TIMES}
    for dt in ("f32", "f64"):
        for J in (2, 3):
            assert {(1, 1 << 17, J, dt), (1, 65536, J, dt), (1, 1024, J, dt),
                    (8, 1024, J, dt)} <= shapes
    assert {(1, 1 << 17, J, "f32") for J in (9, 12, 16)} <= shapes
    # The wide form: J = 17, 24, 32, 64, and the streamed form: J = 96,
    # 128, 256, at the four shapes in f32; J = 17, 32 and 96 at 2^17 in
    # f64; J = 4096 at 1024 lanes in both.
    for J in (17, 24, 32, 64, 96, 128, 256):
        assert {(1, 1 << 17, J, "f32"), (1, 65536, J, "f32"),
                (1, 1024, J, "f32"), (8, 1024, J, "f32")} <= shapes
    assert {(1, 1 << 17, J, "f64") for J in (17, 32, 96)} <= shapes
    assert {(1, 1024, 4096, "f32"), (1, 1024, 4096, "f64")} <= shapes
    assert len(shapes) == len(smoke.REC_TIMES) == 52
    assert set(smoke.REC_TIMES_LIVE) == {"live", "mixed"}
    assert smoke.LIVE_BLOCK_N == 1024


@pytest.mark.parametrize("B, n, J, dt, chain_us", [
    (1, 1 << 17, 2, "f32", 794.2), (1, 1 << 17, 2, "f64", 1588.4),
    (8, 1024, 2, "f32", 6.2), (1, 1024, 2, "f64", 12.4),
    (1, 1 << 17, 9, "f32", 2648.0), (1, 1 << 17, 12, "f32", 3442.4),
    (1, 1 << 17, 16, "f32", 4501.1), (1, 1 << 17, 17, "f32", 4766.3),
    (1, 1 << 17, 24, "f32", 6619.8), (1, 1 << 17, 32, "f32", 8738.1),
    (1, 1 << 17, 64, "f32", 17211.5), (1, 65536, 64, "f32", 8605.7),
    (1, 1024, 17, "f32", 37.2), (8, 1024, 32, "f32", 68.3),
    (1, 1 << 17, 17, "f64", 9532.5), (1, 1 << 17, 32, "f64", 17476.3),
    (1, 1 << 17, 96, "f32", 25685.2), (1, 1 << 17, 128, "f32", 34158.3),
    (1, 1 << 17, 256, "f32", 68051.0), (1, 1 << 17, 96, "f64", 51370.4),
    (1, 1024, 4096, "f32", 8475.4), (1, 1024, 4096, "f64", 16950.8)])
def test_rec_bound_is_the_chain_model(smoke, B, n, J, dt, chain_us):
    """(J + 1) roundings a lane at 4 (f32) or 8 (f64) cycles and 1.98 GHz:
    PERF.md's chain models; rows run side by side.  The bytes and
    operations bounds lie far under it."""
    row = smoke.rec_bound(B, n, J, dt)
    assert row["chain_bound_ms"] * 1e3 == pytest.approx(chain_us, rel=1e-3)
    item = 4 if dt == "f32" else 8
    want = B * (n * ((J + 2) * item + 1) + 2 * J * item) \
        / smoke.HBM_BYTES_PER_S * 1e3
    assert row["bound_by"] == "bytes"
    assert row["bound_ms"] == pytest.approx(want)
    assert row["bound_ms"] < row["chain_bound_ms"] / 100


def test_one_step_check_rows_on_the_plain_version(smoke):
    import numpy as np
    import torch
    from tuun_tpu_torch.engine import scan_ops
    rng = np.random.default_rng(0)
    args = smoke.recurrence_input(torch, np, rng, 3, 300, torch.float32,
                                  B=3, device="cpu",
                                  dead=("live", "stride", "dead"))
    y, hist = scan_ops.linear_recurrence_rows(*args)
    assert smoke.recurrence_one_step_rows(torch, args, y, hist)
    y[1, 7] = y[1, 7] + 1
    assert not smoke.recurrence_one_step_rows(torch, args, y, hist)


class _Recording:
    """A stand-in scan_ops for LaunchLengths: launches count by entry,
    and inside `capture()` record into the thread's dict instead."""

    def __init__(self):
        import threading
        self._tls = threading.local()
        self._tls.recording = None
        self.launched = []

    def _recurrence_launch(self, a, ff, live, h0, rows, entry):
        self.launched.append(entry)
        return ff

    def _df_launch(self, xh, xl, rows, entry):
        self.launched.append(entry)
        return xh

    def count_launches(self, recorded):
        self.launched.append(("replay", len(recorded)))


def test_launch_lengths_count_eager_calls_and_replays(smoke):
    import torch
    ops = _Recording()
    rec = ("a", torch.zeros(2, 1024), None, None, 2,
           "linear_recurrence_rows_f32")
    df = (torch.zeros(65536), torch.zeros(65536), 1, "df_prefix_sum_f32")
    with smoke.LaunchLengths(ops) as lengths:
        ops._recurrence_launch(*rec)
        ops._recurrence_launch(*rec)
        ops._df_launch(*df)
        graph = {}
        ops._tls.recording = graph
        ops._df_launch(*df)  # captured: its replays count by entry
        graph["df_prefix_sum_f32"] = 1
        ops._tls.recording = None
        for _ in range(3):
            ops.count_launches(dict(graph))  # a graph keeps a copy
    assert lengths.table() == {
        "eager": [["linear_recurrence_rows_f32", 2, 1024, 2],
                  ["df_prefix_sum_f32", 1, 65536, 1]],
        "captured": [["df_prefix_sum_f32", 1, 65536, 1]],
        "replayed": {"df_prefix_sum_f32": 3}}
    # The wrappers ran, and the module is as it was.
    assert ops.launched.count("df_prefix_sum_f32") == 2
    assert ops.launched.count(("replay", 1)) == 3
    assert "_df_launch" not in vars(ops) or \
        ops._df_launch.__name__ == "_df_launch"


# -- phase 11's two-stream check of the df sum ------------------------------


class _Proc:
    def __init__(self, row, returncode=0):
        import json
        self.returncode = returncode
        self.stdout = "build ...\n" + json.dumps(row) + "\n"
        self.stderr = "a traceback" if returncode else ""


def _streams_child(smoke, monkeypatch, outcome):
    """df_streams_in_child over a child that times out (outcome None) or
    exits with the given (row, returncode)."""
    import subprocess
    seen = []

    class Sub:
        TimeoutExpired = subprocess.TimeoutExpired

        @staticmethod
        def run(argv, **kw):
            seen.append((argv[-1], kw["timeout"]))
            if outcome is None:
                raise subprocess.TimeoutExpired(argv, kw["timeout"])
            return _Proc(*outcome)
    monkeypatch.setattr(smoke, "subprocess", Sub)
    try:
        return smoke.df_streams_in_child()
    finally:
        assert seen == [("--df-streams", smoke.DF_STREAMS_TIMEOUT)]


def _streams_row(bad=0):
    return dict(ok=bad == 0, n=1 << 17, rows=16, tiles_a_grid=1024,
                resident_blocks=1056, calls=40, bad_calls=bad, both_ms=1.0,
                one_stream_ms=0.6, device="stand-in")


@pytest.mark.parametrize("outcome, match", [
    (None, "no answer from the child in 300 s"),
    ((_streams_row(bad=3),), "3 of 40 calls differ from the same call alone"),
    ((_streams_row(), 1), "exit 1: a traceback")])
def test_df_streams_check_fails_the_run(smoke, monkeypatch, outcome, match):
    """A hang (the child's timeout), a call whose bits differ, or a child
    that fails: each raises, so phase 11 fails and the run exits non-zero."""
    with pytest.raises(smoke.SmokeFailure, match=match):
        _streams_child(smoke, monkeypatch, outcome)


def test_df_streams_check_passes_when_every_call_matches(smoke, monkeypatch,
                                                          capsys):
    assert _streams_child(smoke, monkeypatch, (_streams_row(),))["ok"]
    assert "every call the bits of the same call alone" in \
        capsys.readouterr().out
