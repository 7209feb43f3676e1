"""capture.capture_s: the seconds of every session-step capture of the
set-up (the fused step's and the windows' CUDA graphs), summed from the
tracker's own Tracker.capture_seconds.  Nothing on the CPU captures."""


def read(run):
    if not run.capture_seconds:
        return None
    return sum(run.capture_seconds)
