"""chip_smoke.py's one-launch check, on the CPU with a stand-in profiler.

check_one_launch reads the device kernels that torch.profiler saw for
phase 2's calls: more device work than one kernel a call fails at once,
fewer kernels than calls is returned as a short row (a profiler that
lost kernel records reads the same as a call that launched nothing).
check_launches_in_child runs the check in new child processes until one
sees every kernel, up to LAUNCH_ATTEMPTS, and fails if none does or if a
wrapper did not count its launch.
"""

import importlib.util
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

# Two calls of each kernel, as one_launch_calls lists them: (fn, args,
# kernel, tag); and the device names the profiler gives their kernels.
CALLS = [(None, (), "scan_single_pass", "SumOp"),
         (None, (), "affine_single_pass", "<2,"),
         (None, (), "scan_single_pass", "SumOp"),
         (None, (), "affine_single_pass", "<2,")]
SUM = "void (anonymous namespace)::scan_single_pass<SumOp, false>(float*)"
AFFINE = "void (anonymous namespace)::affine_single_pass<2, false>(float*)"
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
