"""offline_x_realtime: seconds of mixed audio on the host at the end of the
window over the window's wall seconds, every block of the window counted
(host clock)."""


def read(run):
    return run.audio_s / run.wall_s
