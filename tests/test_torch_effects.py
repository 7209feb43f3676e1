"""The port's EffectRunner (tuun_tpu_torch.effects) on the CPU: twins of
every test in tests/test_effects.py, each keeping its name.

Each test drives two runners with the same Actions: the port's, wired to
the port's Player and Tracker (device="cpu"), and tuun_tpu's, wired to
its own, both in exact mode at 100 Hz in 20-sample blocks as the
reference's tests run.  The reference's assertions hold on the port, and
every block the port renders equals tuun_tpu's within exact mode's
atol=1e-5 (test_torch_modify.py's exact-mode bound).
"""

from importlib import import_module
from pathlib import Path

import numpy as np
import pytest
import torch

import tuun_tpu
import tuun_tpu_torch

torch.set_num_threads(1)
EXACT_ATOL = 1e-5
PKGS = (tuun_tpu_torch, tuun_tpu)

SOURCE = '''open std;
#{sliders=["gain:0.5:0:1"]}
_ = 1 * gain | fin(time - 1);
#{level_db=0}
_ = fn(k, v) => (v * 2 | fin(time - 2), 1 | fin(time - 0.1));
bad = 1 +;
'''


class Side:
    """One package's runner, tracker and actions module."""

    def __init__(self, pkg, path):
        def mod(name):
            return import_module(f"{pkg.__name__}.{name}")
        self.A = mod("actions")
        stdlib = Path(pkg.__file__).resolve().parent / "stdlib" / "v0"
        state, message = self.A.AppState.from_source(path.read_text(), path)
        assert not message
        evaluator = mod("evaluator").Evaluator(100, 60, stdlib)
        kw = {"device": "cpu"} if pkg is tuun_tpu_torch else {}
        self.tracker = mod("tracker").Tracker(100, 20, precision="exact",
                                              jit=False, **kw)
        player = mod("player").Player(self.tracker, 60, 4)
        self.logs = []
        self.runner = mod("effects").EffectRunner(
            state, evaluator, player, log=self.logs.append)


class Pair:
    """The port's side and tuun_tpu's, driven in step."""

    def __init__(self, tmp_path, source=SOURCE):
        self.sides = []
        for pkg in PKGS:
            d = tmp_path / pkg.__name__
            d.mkdir()
            src = d / "set.tuun"
            # `bad` is intentionally broken at module level; drop it.
            src.write_text(source.replace("bad = 1 +;\n", ""))
            self.sides.append(Side(pkg, src))
        port = self.sides[0]
        self.A, self.runner, self.tracker, self.logs = (
            port.A, port.runner, port.tracker, port.logs)

    def dispatch(self, name, *args, **kw):
        """Dispatches actions.<name>(*args, **kw) on both sides; a keyword
        argument names a mode class of actions, built per side."""
        for side in self.sides:
            modes = {k: getattr(side.A, v)() for k, v in kw.items()}
            side.runner.dispatch(getattr(side.A, name)(*args, **modes))

    def both(self, fn):
        """Applies fn(side) to both sides."""
        for side in self.sides:
            fn(side)

    def render(self, blocks=1):
        """The port's mix of the next `blocks` blocks, held to tuun_tpu's."""
        mixes = []
        for side in self.sides:
            out = []
            for _ in range(blocks):
                y, _ = side.tracker.render_block()
                out.append(np.asarray(y))
            mixes.append(np.concatenate(out))
        np.testing.assert_allclose(mixes[0], mixes[1], rtol=0,
                                   atol=EXACT_ATOL)
        return mixes[0]


def test_play_program_reaches_tracker_and_mixes(tmp_path):
    p = Pair(tmp_path)
    p.dispatch("PlayProgram", 0)
    assert p.tracker.pending and \
        p.tracker.pending[0].id == tuun_tpu_torch.ids.WaveformId.program(0)
    mix = p.render()
    np.testing.assert_allclose(mix, 0.5, atol=1e-6)  # gain slider at 0.5
    assert any("Playing A1" in m for m in p.logs)


def test_toggle_playback_via_live_status_snapshot(tmp_path):
    p = Pair(tmp_path)
    p.dispatch("ToggleProgramPlayback", 0)
    p.render()
    # Voice active now: the toggle consults the live snapshot and stops.
    p.dispatch("ToggleProgramPlayback", 0)
    mix = p.render(blocks=3)
    # 50ms stop ramp at sr=100 = 5 samples; silence after.
    assert np.abs(mix[10:]).max() == 0.0


def test_evaluate_program_failure_keeps_mode_and_reports(tmp_path):
    p = Pair(tmp_path)
    p.both(lambda s: setattr(s.runner.state.programs.programs[0], "text",
                             "1 +"))
    p.dispatch("EnterEditMode")
    p.dispatch("EvaluateAndLeaveEditMode", mode_on_failure="Edit")
    state = p.runner.state
    assert isinstance(state.mode, p.A.Edit)
    assert "splice failed" in state.message or "expected" in state.message
    assert state.message == p.sides[1].runner.state.message


def test_evaluate_and_leave_edit_splices_and_saves(tmp_path):
    p = Pair(tmp_path)
    state = p.runner.state
    p.dispatch("EnterEditMode")
    # Type a change through the reducer, then evaluate-and-leave.
    p.dispatch("MoveCursorToStart")
    p.dispatch("InsertText", "0 * ")
    p.dispatch("EvaluateAndLeaveEditMode", mode_on_failure="Edit")
    assert isinstance(state.mode, p.A.Select)
    assert "0 * 1 * gain" in state.programs.source
    assert "0 * 1 * gain" in state.programs.input_path.read_text()
    assert state.programs.source == p.sides[1].runner.state.programs.source


def test_note_on_off_with_stored_release(tmp_path):
    p = Pair(tmp_path)
    p.dispatch("ToggleInstalledKeys", 1)
    assert p.runner.state.keys_program == 1
    p.dispatch("NoteOn", 69, 127)
    assert 69 in p.runner._note_offs
    mix = p.render()
    np.testing.assert_allclose(mix, 2.0, atol=1e-5)  # v=1.0 -> 1*2
    p.dispatch("NoteOff", 69)
    assert 69 not in p.runner._note_offs
    # The stored note_off (0.1s of 1.0) multiplies in as the terminator.
    mix = p.render(blocks=3)
    assert np.abs(mix[12:]).max() == 0.0  # silent after the release tail


def test_slider_update_ramps_live_voice(tmp_path):
    p = Pair(tmp_path)
    p.dispatch("PlayProgram", 0)
    p.render()
    p.dispatch("SetSliderNormalized", 0, 0, 1.0)
    mix = p.render(blocks=2)
    # Ramp completes within one buffer; settles at the new value 1.0.
    np.testing.assert_allclose(mix[-10:], 1.0, atol=1e-5)


def test_slider_fans_out_to_active_keys(tmp_path):
    src = '''open std;
#{sliders=["amp:0.5:0:1"]}
_ = fn(k, v) => (amp | fin(time - 2), 1 | fin(time - 0.1));
'''
    p = Pair(tmp_path, src)
    p.dispatch("ToggleInstalledKeys", 0)
    p.dispatch("NoteOn", 60, 127)
    mix = p.render()
    np.testing.assert_allclose(mix, 0.5, atol=1e-5)
    p.dispatch("SetSliderNormalized", 0, 0, 1.0)
    mix = p.render(blocks=2)
    np.testing.assert_allclose(mix[-10:], 1.0, atol=1e-5)


def test_set_level_db_scales_live_voice(tmp_path):
    p = Pair(tmp_path)
    p.dispatch("PlayProgram", 0)
    p.render()
    p.dispatch("SetLevelDb", 0, -20.0)
    mix = p.render()
    np.testing.assert_allclose(mix, 0.05, atol=1e-5)  # 0.5 * 10^(-1)


def test_dump_active_waveform(tmp_path):
    p = Pair(tmp_path)
    p.dispatch("DumpActiveWaveform")
    assert any("Fin(" in m or "Const" in m for m in p.logs)
    assert p.logs == p.sides[1].logs


def test_exit_sets_flag_and_persists(tmp_path):
    p = Pair(tmp_path)
    p.both(lambda s: setattr(s.runner.state.programs.programs[0], "text",
                             "0.25 | fin(time - 1)"))
    p.dispatch("Exit")
    assert p.runner.state.should_exit
    assert "0.25" in p.runner.state.programs.input_path.read_text()


def test_save_all_and_reload_keys(tmp_path):
    p = Pair(tmp_path)
    state = p.runner.state
    # Move a slider, save via the S key, then hand-edit the file and
    # reload via R -- the runner must pick up the disk contents.
    p.dispatch("SetSliderNormalized", 0, 0, 1.0)
    p.dispatch("SaveAll")
    saved = state.programs.input_path.read_text()
    assert '"gain:1:0:1"' in saved

    def hand_edit(side):
        path = side.runner.state.programs.input_path
        path.write_text(path.read_text().replace("1 * gain", "0.125 * gain"))
    p.both(hand_edit)
    p.dispatch("ReloadFile")
    assert "0.125 * gain" in state.programs.source
    p.dispatch("PlayProgram", 0)
    mix = p.render()
    np.testing.assert_allclose(mix, 0.125, atol=1e-5)


def test_keymap_save_reload_bindings(tmp_path):
    from tuun_tpu_torch import keymap
    p = Pair(tmp_path)
    A = p.A
    assert keymap.classify_key(p.runner.state, "S") == [A.SaveAll()]
    assert keymap.classify_key(p.runner.state, "R") == [A.ReloadFile()]
    assert keymap.classify_key(p.runner.state, "L") == [A.ReloadFile()]


def test_note_off_after_uninstall_does_not_crash(tmp_path):
    """A held key released after the instrument is uninstalled (or the
    file reloaded) must still splice its stored note-off, not crash on
    the missing keys program."""
    p = Pair(tmp_path)
    p.dispatch("ToggleInstalledKeys", 1)
    p.dispatch("NoteOn", 60, 127)
    p.dispatch("ToggleInstalledKeys", 1)  # uninstall, key still held
    assert p.runner.state.keys_program is None
    p.dispatch("NoteOff", 60)             # must not raise
    assert 60 not in p.runner._note_offs
    mix = p.render(blocks=3)
    assert np.abs(mix[12:]).max() == 0.0


@pytest.mark.parametrize("name", ["actions", "effects"])
def test_effects_module_is_the_reference_logic(name):
    """effects.py is tuun_tpu's with its docstring alone changed; the
    copies it drives are held verbatim by test_torch_frontend.py."""
    import ast
    texts = [(Path(pkg.__file__).parent / f"{name}.py").read_text()
             for pkg in PKGS]
    trees = [ast.parse(t) for t in texts]
    for tree in trees:
        if isinstance(tree.body[0], ast.Expr):  # the module docstring
            tree.body = tree.body[1:]
    assert ast.dump(trees[0]) == ast.dump(trees[1])
