"""setup_s: seconds from the process's start to the first timed block:
loading, the front end, the kernels' build where the checkout has none,
the CUDA context, the captures and the warm-up (host clock)."""


def read(run):
    return run.setup_s
