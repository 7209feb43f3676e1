"""Faults planted underneath a run's timed path, each of which the
comparison has to catch: a state that never advances, half the voices
left out, an answer altered where it is produced.  (The exchange between
chips is no fault of a one-chip cell.)

Each `plant(name, patch)` sets attributes with `patch(obj, attr, value)`:
pytest's `monkeypatch.setattr` in the tests, plain `setattr` in a
process of its own (calibrate.py --fault)."""

from __future__ import annotations

import harness


def state_unchanged(patch) -> None:
    """From the window on (set-up done), no render's end state is ever
    adopted: every window renders from the states it was given."""
    from tuun_tpu_torch import tracker
    warm = harness._warm

    def then_break(*args, **kwargs):
        warm(*args, **kwargs)
        patch(tracker, "_set_state", lambda m, state: None)
    patch(harness, "_warm", then_break)


def half_the_voices(patch) -> None:
    """Every other voice is never played."""
    from tuun_tpu_torch.tracker import Tracker
    play = Tracker.play

    def half(self, wid, w, *a, **k):
        if wid % 2 == 0:
            play(self, wid, w, *a, **k)
    patch(Tracker, "play", half)


def altered_answer(patch) -> None:
    """Every block's mix comes out of render_block with its sign flipped
    (run_to_completion pulls its blocks through render_block too)."""
    from tuun_tpu_torch.tracker import Tracker
    render = Tracker.render_block

    def altered(self):
        y, status = render(self)
        return -y, status
    patch(Tracker, "render_block", altered)


FAULTS = {f.__name__: f for f in (state_unchanged, half_the_voices,
                                  altered_answer)}


def plant(name: str, patch=setattr) -> None:
    FAULTS[name](patch)
