"""Each configuration's plain reference against the port's Tracker mix
at a small voice count and block size on the CPU: every block of a run
from the first, not only a sample."""

import pytest

import harness
from tiny import TINY

SR = 44100


@pytest.mark.parametrize("config,tol", [("fm_vibrato", 1e-3),
                                        ("saw_lpf", 1e-4)])
def test_reference_holds_the_tracker_mix(config, tol):
    from tuun_tpu_torch.evaluator import Evaluator
    from tuun_tpu_torch.tracker import Tracker
    cfg = harness.load_json(harness.HERE / "configs" / f"{config}.json")
    voices = harness.draw_voices(cfg, 4, 4000000007)
    ev = Evaluator(SR, 90, harness.ROOT / "tuun_tpu_torch" / "stdlib" / "v0")
    n = 512
    t = Tracker(SR, n, precision=cfg["precision"], device="cpu",
                sync_interval=4)
    for i, w in enumerate(harness.compile_voices(cfg, voices, ev)):
        t.play(i, w, start=0)
    try:
        got = harness.pull_closed_loop(t, blocks=48)
    finally:
        t.close()
    assert t.window_opens > 0  # the windows served blocks too
    ref = harness.reference_module(config)
    starts = [got.start + i * n for i in range(48)]
    want = ref.mix_blocks(voices, starts, n, SR)
    err = harness.mix_error(got.mix, want)
    assert err < tol


@pytest.mark.parametrize("config", ["fm_vibrato", "saw_lpf"])
def test_reference_in_a_lower_precision_is_far_off(config):
    """The control (the reference in bfloat16, one step below fast
    mode's float32) in the program's place, at a live window's 4096
    lanes and a few voices, fails every limit of the configuration's
    cells."""
    cfg = harness.load_json(harness.HERE / "configs" / f"{config}.json")
    voices = harness.draw_voices(cfg, TINY["voices"], 4000000011)
    ref = harness.reference_module(config)
    starts = [0, 1 << 20, 1 << 26]
    want = ref.mix_blocks(voices, starts, 4096, SR)
    low = ref.mix_blocks(voices, starts, 4096, SR, precision=cfg["control"])
    err = harness.mix_error(low, want)
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cells = [w["name"] for w in bench["workloads"] if w["config"] == config]
    assert cells
    for name in cells:
        limit = harness.load_json(
            harness.HERE / "limits" / f"{name}.json")["mix_err"]
        assert not err <= limit, (name, err, limit)
