"""frontend.compile_s: seconds the port's front end took to turn every
voice's source into optimized IR (evaluator.py, optimizer.py), on the
harness's clock around it."""


def read(run):
    return run.frontend_s
