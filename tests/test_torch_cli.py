"""The port's batch CLI (tuun_tpu_torch.cli) -- the slice as a whole --
against the JAX package's CLI, both on the CPU in fast precision, and a
check that the port never loads jax or tuun_tpu."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tuun_tpu import cli as jax_cli
from tuun_tpu.wav import read_wav
from tuun_tpu_torch import cli as torch_cli

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
COMMON = ["--sample_rate", "8000", "--date_format", "", "--quiet"]

# Tolerances (fast precision on both sides): the filtered voice differs
# by the two engines' affine-scan rounding orders and float32 sin (1e-4
# absolute on unit-amplitude output); the capture voice has no
# transcendental or scan and must match exactly.
CASES = [
    ("filtered-saw", "sawtooth(110) * (1 + 0.5 * $(3)) | lpf(0.7, 800)"
     " | fin(time - 0.5)", (), 1e-4),
    ("capture", '(sawtooth(55) | capture("saw")) * 0.5 | fin(time - 0.3)',
     ("saw",), 2e-6),
]


@pytest.mark.parametrize("expr,stems,atol", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_cli_matches_jax_cli(tmp_path, expr, stems, atol):
    outs = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("torch", torch_cli.main, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        rc = main(["--expr", expr, "--render-out", str(d / "mix.wav"),
                   "-O", str(d), *COMMON, *extra])
        assert rc == 0, name
        outs[name] = d
    for f in ["mix"] + list(stems):
        want, sr_j = read_wav(outs["jax"] / f"{f}.wav")
        got, sr_t = read_wav(outs["torch"] / f"{f}.wav")
        assert sr_j == sr_t == 8000
        assert len(got) == len(want) > 0, f
        np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=f)


def test_cli_refuses_unported_options(capsys):
    # `--ui true` and `--precision exact_df` are ported (the REPL's and the
    # exact precisions' tests drive them); `--platform` is not: the port
    # takes `--device` in its place.
    with pytest.raises(SystemExit) as e:
        torch_cli.main(["--expr", "$5", "--platform", "cpu"])
    assert e.value.code == 2
    assert "--platform" in capsys.readouterr().err


# The exact precisions through both CLIs: exact_df (double-single phase)
# and exact (f64 phase), each with the sequential IIR, on an FM voice and
# a filtered reset.  The engines differ only in float32 sin and in the
# last compensated bits of the phase sums (another grouping of df_add;
# XLA's and torch's float64 sums): 2e-6 on unit-amplitude output.
EXACT_EXPR = ("sine(2*pi*(220 + 30*$(5)), 0) * 0.5 + sawtooth(110) "
              "| lpf(0.7, 800) | fin(time - 0.5)")


@pytest.mark.parametrize("precision", ["exact_df", "exact"])
def test_cli_exact_precisions_match_jax_cli(tmp_path, precision):
    outs = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("torch", torch_cli.main, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        rc = main(["--expr", EXACT_EXPR, "--render-out", str(d / "mix.wav"),
                   "-O", str(d), "--precision", precision, *COMMON, *extra])
        assert rc == 0, name
        outs[name] = d
    want, _ = read_wav(outs["jax"] / "mix.wav")
    got, sr = read_wav(outs["torch"] / "mix.wav")
    assert sr == 8000 and len(got) == len(want) == 4000
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


def test_cli_without_cuda_fails_loudly(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert torch_cli.main(["--expr", "$5", "--quiet"]) == 2
    assert "cuda" in capsys.readouterr().err


def test_port_never_imports_jax(tmp_path):
    code = ("import sys, tuun_tpu_torch.cli as c; "
            "rc = c.main(['--expr', '$5 * 0.5 | fin(time - 0.2)', "
            "'--device', 'cpu', '--sample_rate', '800', '--quiet', "
            f"'--render-out', {str(tmp_path / 'o.wav')!r}]); "
            "assert rc == 0; "
            "assert 'jax' not in sys.modules, 'jax was imported'; "
            "ref = [m for m in sys.modules if m.split('.')[0] == 'tuun_tpu']; "
            "assert not ref, ref")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    s, sr = read_wav(tmp_path / "o.wav")
    assert sr == 800 and len(s) == 160
