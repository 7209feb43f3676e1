"""The port's own front end (tuun_tpu_torch's copy of tuun_tpu's
pure-Python modules) held equal to tuun_tpu's, and the port's
independence from the JAX package.

  * No module of the port, and not chip_smoke.py, imports jax,
    tuun_tpu or matplotlib (an AST walk).
  * Over a corpus -- every binding of the stdlib, the programs of
    examples/*.tuun, and the expressions of test_torch_engine.py and
    test_torch_cli.py -- the two packages' parser, evaluator and optimizer
    give structurally equal trees (class names and fields, recursively),
    their numpy oracles render bit-identical samples and their native
    oracles report equal lengths.
  * The library's entry points default to the card.
"""

import ast
import enum
import functools
import re
import subprocess
import sys
import types
from importlib import import_module
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_cli
import test_torch_engine
import tuun_tpu
import tuun_tpu_torch
from tuun_tpu_torch.engine import EngineConfig, render
from tuun_tpu_torch.tracker import Tracker

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "tuun_tpu_torch"
PKGS = (tuun_tpu, tuun_tpu_torch)
SR = 8000
RENDER_N = 400
LENGTH_CAP = 10 * SR


# -- the port imports neither jax nor tuun_tpu --------------------------


def _forbidden(name: str) -> bool:
    # matplotlib too: the card's machine has none (tools/scope.py writes
    # its PNG with numpy and the standard library).
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "tuun_tpu", "matplotlib")


PORT_FILES = sorted(str(p.relative_to(REPO)) for p in PORT.rglob("*.py")) + [
    "chip_smoke.py"]


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_file_imports_no_jax_nor_tuun_tpu(rel):
    tree = ast.parse((REPO / rel).read_text(), rel)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__"):
            bad += [a.value for a in node.args
                    if isinstance(a, ast.Constant) and isinstance(a.value, str)
                    and _forbidden(a.value)]
    assert not bad, f"{rel} imports {bad}"


def test_import_walk_covers_the_live_session():
    for rel in ("tuun_tpu_torch/session.py", "tuun_tpu_torch/player.py",
                "tuun_tpu_torch/tools/web_demo.py"):
        assert rel in PORT_FILES


@pytest.mark.parametrize("name", [
    "repl", "effects", "audio", "prewarm", "printer", "actions", "keymap",
    "launchkey", "midi", "tui", "tools/midi_probe"])
def test_import_walk_covers_the_repl(name):
    assert f"tuun_tpu_torch/{name}.py" in PORT_FILES


@pytest.mark.parametrize("name", [
    "web_checker", "profile", "scope", "spectra", "sweep"])
def test_import_walk_covers_the_tools(name):
    assert f"tuun_tpu_torch/tools/{name}.py" in PORT_FILES


@pytest.mark.parametrize("name", ["parallel", "graft_entry"])
def test_import_walk_covers_the_mesh(name):
    assert f"tuun_tpu_torch/{name}.py" in PORT_FILES


def test_repl_modules_load_neither_jax_nor_tuun_tpu():
    """The REPL's modules import in a fresh process, as `python -m
    tuun_tpu_torch.repl` starts, with neither jax nor tuun_tpu loaded."""
    code = ("import sys\n"
            "import tuun_tpu_torch.repl, tuun_tpu_torch.audio, "
            "tuun_tpu_torch.prewarm, tuun_tpu_torch.printer, "
            "tuun_tpu_torch.tui, tuun_tpu_torch.tools.midi_probe\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] in ('jax', 'jaxlib', 'tuun_tpu')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_port_package_owns_its_stdlib():
    from tuun_tpu_torch import cli
    assert cli.DEFAULT_LIBRARY == PORT / "stdlib" / "v0"
    sources = sorted((Path(tuun_tpu.__file__).parent / "stdlib" / "v0").glob(
        "*.tuun"))
    assert [f.name for f in sources] == STDLIB_FILES
    for src in sources:
        assert (cli.DEFAULT_LIBRARY / src.name).read_text() == \
            src.read_text(), src.name


# -- structural equality ------------------------------------------------


def _float_bits(x) -> bytes:
    return np.float64(x).tobytes()


def same(x, y, path="value", seen=None):
    """Asserts that x (built by tuun_tpu) and y (built by the port) have
    the same class names and fields, recursively; floats bit for bit."""
    seen = set() if seen is None else seen
    assert type(x).__name__ == type(y).__name__, \
        f"{path}: {type(x).__name__} != {type(y).__name__}"
    if x is None or isinstance(x, (bool, int, str, bytes)):
        assert x == y, f"{path}: {x!r} != {y!r}"
        return
    if isinstance(x, float):
        assert _float_bits(x) == _float_bits(y), f"{path}: {x!r} != {y!r}"
        return
    if isinstance(x, (np.ndarray, np.generic)):
        assert x.dtype == y.dtype and np.shape(x) == np.shape(y), path
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes(), path
        return
    if isinstance(x, enum.Enum):
        assert x.name == y.name, f"{path}: {x} != {y}"
        return
    if isinstance(x, (list, tuple)):
        assert len(x) == len(y), f"{path}: length {len(x)} != {len(y)}"
        for i, (a, b) in enumerate(zip(x, y)):
            same(a, b, f"{path}[{i}]", seen)
        return
    if isinstance(x, dict):
        assert list(x) == list(y), f"{path}: keys differ"
        for k in x:
            same(x[k], y[k], f"{path}[{k!r}]", seen)
        return
    if isinstance(x, functools.partial):
        same(x.func, y.func, f"{path}.func", seen)
        same(x.args, y.args, f"{path}.args", seen)
        return
    if isinstance(x, (types.FunctionType, types.BuiltinFunctionType,
                      types.MethodType)):
        assert x.__qualname__ == y.__qualname__, f"{path}: {x} != {y}"
        return
    if (id(x), id(y)) in seen:
        return
    seen.add((id(x), id(y)))
    mod_x, mod_y = type(x).__module__, type(y).__module__
    assert mod_x.replace("tuun_tpu.", "tuun_tpu_torch.", 1) == mod_y, \
        f"{path}: {mod_x} vs {mod_y}"
    fields = []
    for cls in type(x).__mro__:
        fields += [s for s in getattr(cls, "__slots__", ()) if s != "__dict__"]
    fields += list(getattr(x, "__dict__", {}))
    for f in dict.fromkeys(fields):
        assert hasattr(x, f) == hasattr(y, f), f"{path}.{f}: present in one"
        if hasattr(x, f):
            same(getattr(x, f), getattr(y, f), f"{path}.{f}", seen)


def _mods(pkg, *names):
    return [import_module(f"{pkg.__name__}.{n}") for n in names]


def _evaluator(pkg):
    (ev,) = _mods(pkg, "evaluator")
    return ev.Evaluator(SR, 90, Path(pkg.__file__).parent / "stdlib" / "v0")


def _as_waveform(pkg, value):
    (expr,) = _mods(pkg, "expr")
    if isinstance(value, expr.ESeq):
        value = value.waveform
    return value.waveform if isinstance(value, expr.EWaveform) else None


def check_waveforms(w_ref, w):
    """Equal IR, optimized IR, oracle samples and native lengths."""
    same(w_ref, w, "ir")
    ref_opt = tuun_tpu.optimizer.optimize(w_ref)
    opt = tuun_tpu_torch.optimizer.optimize(w)
    same(ref_opt, opt, "optimized")
    want = tuun_tpu.oracle.render(ref_opt, RENDER_N, SR, seed=3)
    got = tuun_tpu_torch.oracle.render(opt, RENDER_N, SR, seed=3)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes(), "oracle renders differ"
    lengths = [import_module(f"{p.__name__}.native").NativeOracle(
        x, SR).length(LENGTH_CAP) for p, x in zip(PKGS, (ref_opt, opt))]
    assert lengths[0] == lengths[1], f"native lengths {lengths}"


for _p in PKGS:  # the front-end modules every check below uses
    _mods(_p, "optimizer", "oracle", "native")


STDLIB_FILES = sorted(p.name for p in
                      (PORT / "stdlib" / "v0").glob("*.tuun"))


@pytest.mark.parametrize("name", STDLIB_FILES)
def test_stdlib_module_parses_the_same(name):
    trees = []
    for pkg in PKGS:
        (parser,) = _mods(pkg, "parser")
        src = (Path(pkg.__file__).parent / "stdlib" / "v0" / name).read_text()
        trees.append(parser.parse_module(src))
    same(trees[0], trees[1], name)


def _std_bindings():
    (parser, expr) = _mods(tuun_tpu, "parser", "expr")
    src = (Path(tuun_tpu.__file__).parent / "stdlib" / "v0" /
           "std.tuun").read_text()
    return [b.binding.pattern.name for b in parser.parse_module(src)[0]
            if isinstance(b.binding, expr.BDef)]


STD_BINDINGS = _std_bindings()
CALL_ARGS = ("0.5", "110", "0.25", "0.1", "0.2")


def _evaluate(ev, text):
    """The value of `text`, or the error it raises."""
    try:
        return ev.evaluate_source(text, opens=("std",))
    except Exception as e:  # compared by class name and message below
        return e


@pytest.mark.parametrize("name", STD_BINDINGS)
def test_std_binding_evaluates_the_same(name):
    """The binding's value; for a function, also its value applied to
    len(positional) numbers, which for most instruments is a waveform (and
    for a few an error, which must be the same error)."""
    evs = [_evaluator(p) for p in PKGS]
    values = [_evaluate(ev, name) for ev in evs]
    same(values[0], values[1], name)
    text = name
    if type(values[0]).__name__ == "EFunction":
        text = f"{name}({', '.join(CALL_ARGS[:len(values[0].positional)])})"
        values = [_evaluate(ev, text) for ev in evs]
        if isinstance(values[0], Exception):
            assert type(values[1]).__name__ == type(values[0]).__name__
            assert str(values[1]) == str(values[0]), text
            return
        same(values[0], values[1], text)
    ws = [_as_waveform(p, v) for p, v in zip(PKGS, values)]
    assert (ws[0] is None) == (ws[1] is None), text
    if ws[0] is not None:
        check_waveforms(*ws)


ENGINE_TEXTS = ([t for t, _ in test_torch_engine.FAST_CASES]
                + test_torch_engine.CORPUS_TEXTS
                + [test_torch_engine.HANDOFF_TEXT]
                + [c[1] for c in test_torch_cli.CASES])


@pytest.mark.parametrize("text", ENGINE_TEXTS)
def test_test_expressions_evaluate_the_same(text):
    ws = [_as_waveform(p, _evaluator(p).evaluate_source(text, opens=("std",)))
          for p in PKGS]
    assert ws[0] is not None, text
    check_waveforms(*ws)


def _file_programs(pkg, path):
    """Every program of a source file, evaluated as the CLI does."""
    (eval_mod, expr, parser, programs, diagnostics) = _mods(
        pkg, "eval", "expr", "parser", "programs", "diagnostics")
    ev = _evaluator(pkg)
    ps, _ = programs.ProgramSet.from_source(path.read_text(), path)
    out = []
    for i, program in enumerate(ps.programs):
        if program.is_empty():
            continue
        bindings = [expr.SourceBinding(expr.BOpen(("__prelude",)))]
        bindings += ps.evaluation_bindings(i)
        tree = parser.parse_program(program.text,
                                    diagnostics.Source.program())
        out.append((ps.display_name(i), _as_waveform(
            pkg, eval_mod.evaluate(ev.resolve, bindings, tree))))
    return out


EXAMPLES = sorted(p.name for p in (REPO / "examples").glob("*.tuun"))


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_programs_evaluate_the_same(name):
    ref, port = (_file_programs(p, REPO / "examples" / name) for p in PKGS)
    assert [n for n, _ in ref] == [n for n, _ in port]
    assert ref, name
    for (label, w_ref), (_, w) in zip(ref, port):
        assert (w_ref is None) == (w is None), label
        if w_ref is not None:
            check_waveforms(w_ref, w)


# -- the entry points default to the card -------------------------------


def test_engine_config_defaults_to_the_card():
    assert EngineConfig(48000).device.type == "cuda"
    assert EngineConfig(48000, "fast", "cpu").device.type == "cpu"


def test_default_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    w = tuun_tpu_torch.ir.Const(1.0)
    with pytest.raises(RuntimeError, match="cuda"):
        render(w, 10, 10)
    with pytest.raises(RuntimeError, match="cuda"):
        Tracker(SR)
    got = render(w, 10, 10, device="cpu")
    np.testing.assert_array_equal(got, np.ones(10, np.float32))


# -- the copied metric series ---------------------------------------------


class _Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


@pytest.mark.parametrize("steps", [
    [(0.05, 1.0), (0.05, 3.0), (0.2, 5.0)],
    [(0.0, 2.0), (3.0, 4.0), (20.0, 8.0), (0.31, 1.0)],
    [(0.1 * k, float(k)) for k in range(30)]],
    ids=["one-bucket", "gaps", "ramp"])
def test_metric_series_the_same(steps):
    """The port's metric.py (the tracker's load and dispatch series)
    against tuun_tpu's, under one scripted clock: the same series and
    latest value after every step."""
    metrics = []
    for pkg in PKGS:
        clock = _Clock()
        m = import_module(f"{pkg.__name__}.metric").Metric(
            window_seconds=2.0, buckets=20, clock=clock)
        metrics.append((clock, m))
    for dt, value in steps:
        out = []
        for clock, m in metrics:
            clock.now += dt
            m.set(value)
            out.append((m.series(), m.latest()))
        same(out[0], out[1], "metric")


# -- modules the port copies verbatim -------------------------------------

# Each copied module of tuun_tpu that holds no front-end behaviour of its
# own, with the only edits its copy may have (besides _relative_reference).
COPIED = {
    "metric": (),
    "_threads": (('print(f"tuun_tpu: worker',
                  'print(f"tuun_tpu_torch: worker'),),
    "printer": (),
    "actions": (),
    "keymap": (),
    "launchkey": (),
    "midi": (),
    "tui": (),
    "tools/midi_probe": (("python -m tuun_tpu.tools.midi_probe",
                          "python -m tuun_tpu_torch.tools.midi_probe"),),
    "fuzzgen": (),
    "tools/spectra": (("python -m tuun_tpu.tools.spectra",
                       "python -m tuun_tpu_torch.tools.spectra"),),
    "tools/sweep": (("python -m tuun_tpu.tools.sweep",
                     "python -m tuun_tpu_torch.tools.sweep"),),
}


def _relative_reference(text: str) -> str:
    """The copies cite the reference's sources relative to its checkout
    (reference/src/...), not by a directory of the machine they were
    written on."""
    return re.sub(r"/\w+/reference/", "reference/", text)


@pytest.mark.parametrize("name", sorted(COPIED))
def test_copied_module_is_verbatim(name):
    text = (Path(tuun_tpu.__file__).parent / f"{name}.py").read_text()
    for old, new in COPIED[name]:
        assert old in text, (name, old)
        text = text.replace(old, new)
    assert (PORT / f"{name}.py").read_text() == _relative_reference(text)
