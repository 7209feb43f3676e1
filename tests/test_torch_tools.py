"""The port's tools against tuun_tpu's on the CPU.

  * web_checker: a copy of tuun_tpu's with the engine's device as its one
    change (WEB_CHECKER_EDITS lists every edit the copy may have); its
    helpers twinned on the same inputs, the repo's docs corpus checked
    with the same labels as tuun_tpu's, bad blocks failing the same way,
    and the port's fast render of every corpus example against tuun_tpu's
    within the checker's own per-class tolerance.
  * spectra and sweep: verbatim copies (test_torch_frontend.py's COPIED);
    here the instrument conformance targets of test_instruments.py
    rendered through the port, the measurements bit for bit tuun_tpu's,
    the sweep's table and WAVs the same.
  * scope: scope_views against the formulas of tuun_tpu's plot_scope, the
    numpy PNG writer's file decoded with zlib, and the CLI's views.
  * profile: the three groups of lines on the CPU, exact mode, and an
    expression that is no waveform.
  * chip_smoke.py's phase-12 checks (deep fast filters, the corpus,
    profile, scope, spectra) at CPU scale, the functions the card runs.
"""

import contextlib
import importlib.util
import io
import re
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import tuun_tpu
from test_corpus import REFERENCE, REFERENCE_DOCS
from tuun_tpu.tools import spectra as jspectra
from tuun_tpu.tools import sweep as jsweep
from tuun_tpu.tools import web_checker as jwc
from tuun_tpu_torch.tools import profile, scope, spectra, sweep
from tuun_tpu_torch.tools import web_checker as wc

torch.set_num_threads(1)
CPU = "cpu"
REPO = Path(__file__).resolve().parent.parent
CORPUS = [REPO / "web" / "index.html", *sorted((REPO / "docs").glob("*.md"))]

# tuun_tpu's web_checker -> the port's: the only edits the copy may have.
WEB_CHECKER_EDITS = (
    ("Usage: python -m tuun_tpu.tools.web_checker FILE...",
     "Usage: python -m tuun_tpu_torch.tools.web_checker [--device cpu] "
     "FILE...\n\nThe engine renders on the card unless --device cpu asks "
     "for the CPU."),
    ("import json\nimport sys\n",
     "import argparse\nimport json\nimport sys\n"),
    ("from ..engine import CompiledVoice, EngineConfig\n",
     "from ..engine import CompiledVoice, EngineConfig\n"
     "from ..engine.graph import check_device\n"),
    ("compile_check: bool = True, render_samples: int = 0):\n"
     "        prelude",
     "compile_check: bool = True, render_samples: int = 0,\n"
     "                 device=\"cuda\"):\n"
     "        prelude"),
    ("        self.cfg = EngineConfig(sample_rate, precision=\"fast\", "
     "jit=False,\n                                use_pallas=False)\n",
     "        self.device = device\n"
     "        self.cfg = EngineConfig(sample_rate, \"fast\", device)\n"
     "        check_device(self.cfg.device)\n"),
    ("# Beyond the reference: also compile the result through the TPU\n"
     "        # engine front-end (structure only, no execution).",
     "# Beyond the reference: also compile the result through the\n"
     "        # engine front-end (structure only, no execution)."),
    ("(fast\n        precision, jitted — on the TPU when one is attached)",
     "(fast\n        precision, on the card unless device=\"cpu\")"),
    ("            got = engine.render(wo, n, sr, precision=\"fast\", "
     "jit=True,\n                                block=1 << 15)\n",
     "            got = engine.render(wo, n, sr, precision=\"fast\",\n"
     "                                block=1 << 15, device=self.device)\n"),
    ("def check_files(paths, compile_check: bool = True,\n"
     "                render_samples: int = 0) -> CheckReport:\n"
     "    checker = Checker(compile_check=compile_check,\n"
     "                      render_samples=render_samples)\n",
     "def check_files(paths, compile_check: bool = True,\n"
     "                render_samples: int = 0, device=\"cuda\") -> "
     "CheckReport:\n"
     "    checker = Checker(compile_check=compile_check,\n"
     "                      render_samples=render_samples, device=device)\n"),
    ("    args = argv if argv is not None else sys.argv[1:]\n"
     "    if not args:\n"
     "        print(\"usage: web_checker FILE...\", file=sys.stderr)\n"
     "        return 2\n"
     "    report = check_files(args)\n",
     "    p = argparse.ArgumentParser(prog=\"web_checker\")\n"
     "    p.add_argument(\"files\", nargs=\"*\", metavar=\"FILE\")\n"
     "    p.add_argument(\"--device\", default=\"cuda\", "
     "choices=(\"cuda\", \"cpu\"))\n"
     "    args = p.parse_args(argv if argv is not None else sys.argv[1:])\n"
     "    if not args.files:\n"
     "        print(\"usage: web_checker [--device cpu] FILE...\", "
     "file=sys.stderr)\n"
     "        return 2\n"
     "    report = check_files(args.files, device=args.device)\n"),
)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_tool_tests", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# web_checker
# ---------------------------------------------------------------------------


def test_web_checker_is_tuun_tpu_s_with_a_device():
    text = (Path(tuun_tpu.__file__).parent / "tools" /
            "web_checker.py").read_text()
    for old, new in WEB_CHECKER_EDITS:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    assert (REPO / "tuun_tpu_torch" / "tools" /
            "web_checker.py").read_text() == text


BLOCKS = [
    '<tuun-synth expression="$440 * 0.5"></tuun-synth>',
    "<tuun-synth description='a > b' expression='sine(2*pi*220, 0)'/>",
    '<tuun-synth sliders="f: 100 .. 1000" open=\'["pm_synth"]\'>\n'
    '  <script type="text/tuun">\n    $440 // a comment\n    * 0.5\n'
    '  </script>\n</tuun-synth>',
    '<tuun-synth fn="x => x > 1">\n  harmonica(1.0, 440)\n</tuun-synth>',
    '<tuun-synth description="empty"></tuun-synth>',
    '<tuun-synth expression="unterminated',
    '<tuun-synth expression=\'a "quoted" b\'>body</tuun-synth>',
]
TEXTS = [path.read_text() for path in CORPUS] + [
    "no blocks here",
    "<tuun-synth unclosed\n" + BLOCKS[0],
    "\n\n".join(BLOCKS) + "\n<tuun-synth trailing",
]


@pytest.mark.parametrize("i", range(len(TEXTS)))
def test_find_blocks_twin(i):
    assert wc.find_blocks(TEXTS[i]) == jwc.find_blocks(TEXTS[i])


_CORPUS_BLOCKS = [b for text in TEXTS for _, b in jwc.find_blocks(text)]


@pytest.mark.parametrize("i", range(len(_CORPUS_BLOCKS + BLOCKS)))
def test_block_helpers_twin(i):
    block = (_CORPUS_BLOCKS + BLOCKS)[i]
    assert wc.extract_expression(block) == jwc.extract_expression(block)
    assert wc._find_tag_close(block) == jwc._find_tag_close(block)
    for name in ("expression", "description", "sliders", "open", "fn",
                 "missing"):
        assert wc._extract_attr(block, name) == jwc._extract_attr(block, name)
    expr = jwc.extract_expression(block) or block
    assert wc._strip_comments(expr) == jwc._strip_comments(expr)


class _Recorder:
    """Records, per checked block, the waveform the checker compiles and
    each fast render its render diff makes."""

    def __init__(self, mod, engine):
        self.mod, self.engine = mod, engine
        self.waves, self.renders = [], []

    def __enter__(self):
        self._saved = (self.mod.CompiledVoice, self.engine.render)
        compiled, render = self._saved

        def compiled_(w, cfg):
            self.waves.append(w)
            return compiled(w, cfg)

        def render_(*a, **k):
            out = render(*a, **k)
            self.renders.append(np.asarray(out))
            return out
        self.mod.CompiledVoice, self.engine.render = compiled_, render_
        return self

    def __exit__(self, *exc):
        self.mod.CompiledVoice, self.engine.render = self._saved


@pytest.fixture(scope="module")
def corpora():
    """The repo's corpus through both checkers at 4096 samples, each
    block's waveform and fast render recorded."""
    import tuun_tpu.engine as jengine
    import tuun_tpu_torch.engine as pengine
    with _Recorder(jwc, jengine) as jrec:
        jrep = jwc.check_files(CORPUS, render_samples=4096)
    with _Recorder(wc, pengine) as prec:
        prep = wc.check_files(CORPUS, render_samples=4096, device=CPU)
    return jrep, jrec, prep, prec


def test_corpus_labels_match_tuun_tpu(corpora):
    jrep, _, prep, _ = corpora
    assert (prep.ok, prep.skipped, prep.failed) == \
        (jrep.ok, jrep.skipped, jrep.failed)
    assert len(prep.ok) == 6 and not prep.failed


def test_render_diff_beside_tuun_tpu(corpora, monkeypatch):
    """Each corpus example's fast render on the CPU against tuun_tpu's
    fast render of the same example, through the port checker's own
    comparison with tuun_tpu's render in the oracle's place: within the
    example's class tolerance (_TOL)."""
    from tuun_tpu_torch import native, optimizer
    _, jrec, _, prec = corpora
    # Six examples, five waveforms: the piano keys block is a keys
    # instrument, which the checker evaluates but does not render.
    assert len(jrec.renders) == len(prec.renders) == len(prec.waves) == 5
    checker = wc.Checker(render_samples=4096, device=CPU)
    monkeypatch.setattr(native, "native_available", lambda: True)
    for w, want, got in zip(prec.waves, jrec.renders, prec.renders):
        monkeypatch.setattr(native, "render",
                            lambda wo, n, sr, want=want: want)
        assert checker._render_diff(w) == ""
        wo = optimizer.optimize(w)
        classes = checker._classify(wo)
        tol = max(wc.Checker._TOL[c]["median"] for c in classes)
        scale = max(float(np.abs(want).max()), 1e-6)
        m = min(len(got), len(want))
        assert float(np.median(np.abs(got[:m] - want[:m]))) <= tol * scale


@pytest.mark.parametrize("block, message", [
    ('<tuun-synth expression="1 +"></tuun-synth>', "parse error"),
    ('<tuun-synth expression="nosuchname(3)"></tuun-synth>',
     "evaluate error"),
    ('<tuun-synth expression="$440" open="[oops"></tuun-synth>',
     "open parsing error")])
def test_bad_block_fails_the_same_way(block, message):
    got = wc.Checker(device=CPU).check_block(block)
    assert got == jwc.Checker().check_block(block)
    assert got[0] == "fail" and got[2].startswith(message)


def test_checker_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="cuda"):
        wc.Checker()


def test_web_checker_main(capsys):
    assert wc.main(["--device", "cpu", str(CORPUS[0])]) == 0
    assert capsys.readouterr().out.strip().endswith(
        "6 ok, 0 skipped, 0 failed")
    assert wc.main([]) == 2


@pytest.mark.skipif(not REFERENCE_DOCS.is_dir(),
                    reason="reference docs not available")
def test_reference_docs_corpus():
    files = sorted(REFERENCE_DOCS.glob("**/*.md"))
    files += sorted(REFERENCE_DOCS.glob("**/*.html"))
    files += sorted((REFERENCE / "web").glob("*.html"))
    report = wc.check_files(files, device=CPU)
    assert not report.failed, report.failed
    assert len(report.ok) + len(report.skipped) >= 44
    assert len(report.ok) >= 43


@pytest.mark.skipif(not REFERENCE_DOCS.is_dir(),
                    reason="reference docs not available")
def test_corpus_render_diff_subset():
    from tuun_tpu_torch import native
    if not native.native_available():
        pytest.skip("native oracle unavailable")
    files = [REFERENCE_DOCS / "instruments.md", REFERENCE_DOCS / "index.md"]
    files = [f for f in files if f.exists()]
    assert files
    report = wc.check_files(files, render_samples=4096, device=CPU)
    assert not report.failed, report.failed
    assert len(report.ok) >= 5


# ---------------------------------------------------------------------------
# spectra and sweep
# ---------------------------------------------------------------------------


def _render_expr(text, seconds, opens=("std",), sr=8000):
    return _chip_smoke().tool_render(text, seconds, opens, sr, "exact", CPU)


def test_flute_instrument_targets():
    sr = 8000
    y = _render_expr("$546 | ADSR(0.32, 0.0, 1.0, 1.25, 0.18)", 2.2)
    assert len(y) == int(1.75 * sr)
    f0 = spectra.estimate_f0(y, sr)
    assert abs(f0 - 546) / 546 < 0.01, f0
    s = spectra.summarize_envelope(y, sr)
    assert 0.2 < s.attack_seconds < 0.45, s
    assert 1.6 < s.duration_seconds <= 1.8, s


def test_ukulele_instrument_targets():
    sr = 8000
    y = _render_expr("pm_ukulele(10, 0.41, 0.2)(2.0, 276)", 3.0,
                     opens=("std", "pm_synth"))
    f0 = spectra.estimate_f0(y, sr)
    assert abs(f0 - 276) / 276 < 0.02, f0
    s = spectra.summarize_envelope(y, sr)
    assert s.attack_seconds < 0.1, s
    assert s.decay_to_half_seconds is not None and \
        s.decay_to_half_seconds < 1.0, s


def _signal(seed, n=12000, sr=8000):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    f = rng.uniform(80, 900)
    env = np.minimum(1.0, t / rng.uniform(0.01, 0.3)) * np.exp(
        -t * rng.uniform(0.2, 3))
    x = env * (np.sin(2 * np.pi * f * t) + 0.3 * np.sin(4 * np.pi * f * t))
    return (x + 0.01 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("seed", range(4))
def test_spectra_measurements_bit_for_bit(seed):
    x, y = _signal(seed), _signal(seed + 10)
    assert spectra.estimate_f0(x, 8000) == jspectra.estimate_f0(x, 8000)
    assert vars(spectra.summarize_envelope(x, 8000)) == \
        vars(jspectra.summarize_envelope(x, 8000))
    assert spectra.spectral_correlation(x, y) == \
        jspectra.spectral_correlation(x, y)


def test_sweep_table_and_wavs_match(tmp_path, capsys):
    assert sweep.main(["--seconds", "0.5", "--out-dir",
                       str(tmp_path / "port")]) == 0
    port = capsys.readouterr().out
    assert jsweep.main(["--seconds", "0.5", "--out-dir",
                        str(tmp_path / "jax")]) == 0
    assert port == capsys.readouterr().out and port
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names and names == sorted(p.name for p in
                                     (tmp_path / "port").iterdir())
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()


# ---------------------------------------------------------------------------
# scope
# ---------------------------------------------------------------------------


def _png(path):
    """(width, height, inflated IDAT bytes) of a PNG."""
    data = Path(path).read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (size,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        chunks[kind] = chunks.get(kind, b"") + data[pos + 8:pos + 8 + size]
        pos += 12 + size
    w, h = struct.unpack(">II", chunks[b"IHDR"][:8])
    return w, h, zlib.decompress(chunks[b"IDAT"])


def test_scope_views_match_plot_scope_formulas():
    """The peak, the clip count and the spectrum's argmax frequency of
    scope_views against tuun_tpu's plot_scope formulas (np.hanning, rfft,
    rfftfreq on the first min(n, 2^15) samples)."""
    sr, n = 8000, 40000
    rng = np.random.default_rng(7)
    t = np.arange(n) / sr
    x = (1.3 * np.sin(2 * np.pi * 440 * t)
         + 0.05 * rng.standard_normal(n)).astype(np.float32)
    v = scope.scope_views(x, sr)
    assert v["peak"] == np.abs(x).max()
    assert int(v["clipped"].sum()) == int((np.abs(x) > 1.0).sum()) > 0
    m = 1 << 15
    mags = np.abs(np.fft.rfft(x[:m] * np.hanning(m)))
    freqs = np.fft.rfftfreq(m, 1.0 / sr)
    db = 20 * np.log10(np.maximum(mags, 1e-9))
    np.testing.assert_array_equal(v["db"], db)
    assert v["freqs"][np.argmax(v["db"])] == freqs[np.argmax(db)]
    assert abs(freqs[np.argmax(db)] - 440) < 1
    np.testing.assert_array_equal(v["t"], np.arange(n) / sr)
    assert scope.scope_views(x[:10], sr)["db"] is None


def test_scope_png_from_wav_and_expr(tmp_path, capsys):
    from tuun_tpu_torch.wav import write_wav_f32
    wav = tmp_path / "in.wav"
    t = np.arange(8000) / 8000.0
    write_wav_f32(wav, (1.2 * np.sin(2 * np.pi * 5 * t)).astype(np.float32),
                  8000)
    for i, args in enumerate((
            ["--wav", str(wav)],
            ["--expr", "(square(220) | lpf(0.7, 2000)) * 1.5",
             "--seconds", "0.2", "--device", "cpu"])):
        out = tmp_path / f"s{i}.png"
        assert scope.main([str(out), *args]) == 0
        w, h, raw = _png(out)
        assert (w, h) == (scope.WIDTH, 2 * scope.PANEL)
        assert len(raw) == h * (3 * w + 1)
        pixels = np.frombuffer(raw, np.uint8).reshape(h, 3 * w + 1)[:, 1:]
        red = (pixels.reshape(h, w, 3) == scope.CLIP).all(-1)
        assert red[:scope.PANEL].any() and not red[scope.PANEL:].any()
    assert capsys.readouterr().out.count("wrote") == 2


def test_scope_hud_panel(tmp_path):
    out = tmp_path / "hud.png"
    views = scope.plot_scope(np.zeros(100, np.float32), 100, str(out),
                             load_series=[0.1, 0.4], dispatch_series=[1, 2])
    w, h, _ = _png(out)
    assert (w, h) == (scope.WIDTH, 3 * scope.PANEL)
    assert views["peak"] == 0.0 and not views["clipped"].any()


def test_scope_tool_renders_png(tmp_path):
    # Twin of tests/test_cli.py's, through the port and with no
    # matplotlib.
    from tuun_tpu_torch.wav import write_wav_f32
    wav = tmp_path / "in.wav"
    t = np.arange(800) / 100.0
    write_wav_f32(wav, (1.2 * np.sin(2 * np.pi * 5 * t)).astype(np.float32),
                  100)
    out = tmp_path / "scope.png"
    rc = scope.main([str(out), "--wav", str(wav)])
    assert rc == 0 and out.stat().st_size > 1000


def test_scope_expr_defaults_to_the_card(tmp_path):
    with pytest.raises(RuntimeError, match="cuda"):
        scope.main([str(tmp_path / "x.png"), "--expr", "$440"])


# ---------------------------------------------------------------------------
# profile
# ---------------------------------------------------------------------------


def _profile(args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = profile.main(args)
    return rc, buf.getvalue()


@pytest.mark.parametrize("precision", ["fast", "exact"])
def test_profile_prints_its_three_groups(precision):
    # exact's plain recurrence is a loop over lanes: a shorter block.
    block = "4096" if precision == "fast" else "1024"
    rc, out = _profile(["--expr", "harmonica(1.0, 440)", "--device", "cpu",
                        "--block", block, "--blocks", "2", "--precision",
                        precision])
    assert rc == 0
    row = _chip_smoke().parse_profile(out)
    assert row["device"] == "cpu" and row["steady_ms"] > 0
    assert row["events"] > 0 and row["top"]
    assert row["launched"] == {} and row["profiler_saw"] == 0
    assert re.search(r"realtime@48000\)$", out, re.M)


def test_profile_x_realtime_at_its_sample_rate():
    rc, out = _profile(["--expr", "$440", "--device", "cpu", "--block",
                        "1024", "--blocks", "2", "--sample_rate", "8000"])
    row = _chip_smoke().parse_profile(out)
    assert rc == 0 and re.search(r"realtime@8000\)$", out, re.M)
    # The block's audio (1024 samples at 8 kHz) over its time, which is
    # printed to the microsecond.
    ms = row["steady_ms"]
    lo, hi = (1024 / 8000 / ((ms + d) / 1e3) for d in (5e-4, -5e-4))
    assert lo - 1 <= row["x_realtime"] <= hi + 1


@pytest.mark.parametrize("name, short", [
    ("void (anonymous namespace)::scan_single_pass<SumOp, false>(float*)",
     "scan_single_pass<SumOp, false>"),
    ("void (anonymous namespace)::affine_scan_pass<2, false>(float*)",
     "affine_scan_pass<2, false>"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::FillFunctor<float>, std::array<char*, 1ul> >(int, "
     "at::native::FillFunctor<float>, std::array<char*, 1ul>)",
     "vectorized_elementwise_kernel<4, FillFunctor<float>, array<char*, 1ul> "
     ">"),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD"),
    ("aten::add", "aten::add")])
def test_profile_short_kernel_names(name, short):
    assert profile.short_name(name) == short
    assert len(profile.short_name("void f<" + "x" * 200 + ">(int)")) == 72


def test_profile_rejects_a_non_waveform(capsys):
    assert profile.main(["--expr", "1", "--device", "cpu"]) == 1
    assert "did not evaluate to a waveform" in capsys.readouterr().err


def test_profile_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="cuda"):
        profile.main(["--expr", "$440"])


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 12 at CPU scale
# ---------------------------------------------------------------------------


def test_phase12_deep_filters_on_cpu(capsys):
    cs = _chip_smoke()
    from tuun_tpu_torch.engine import scan_ops
    rows = cs.deep_offline(CPU, n=4096, blocks=(4096, 1024))
    assert set(rows) == {f"J{J}/{b}" for J in cs.DEEP_JS
                         for b in (4096, 1024)}
    cs.deep_recurrence_bits(torch, scan_ops, CPU, n=1000)
    row = cs.deep_session(torch, scan_ops, CPU, session=(8000, 128, 0.1, 4))
    assert row["window_opens"] > 0
    out = capsys.readouterr().out
    assert "deep fast filters (4096 samples at 48000 Hz, cpu)" in out
    assert "linear_recurrence J=12 at 1000 lanes (cpu)" in out
    assert "deep session (4 J=12 voices, 128-sample blocks, " \
        "sync_interval 4, cpu)" in out


def test_phase12_tools_on_cpu(tmp_path, capsys):
    cs = _chip_smoke()
    row = cs.tools_corpus(CPU, render_samples=4096)
    assert row["ok"] == 6 and row["reference"] is None
    rows = cs.tools_profile(CPU, extra=["--block", "1024", "--blocks", "2"])
    assert len(rows) == 3
    assert cs.tools_scope(CPU, tmp_path, seconds=0.2)["clipped"] > 0
    spec = cs.tools_spectra(CPU, sr=8000)
    assert set(spec) == {"flute", "ukulele"}
    out = capsys.readouterr().out
    for line in ("corpus (4096 samples a block, cpu)",
                 "profile 'harmonica(1.0, 440)' (cpu)", "scope (cpu)",
                 "instruments (8000 Hz, cpu)"):
        assert line in out


def test_phase12_corpus_reads_a_reference_only_when_given(tmp_path):
    """The reference's pages come from --reference alone: a checkout with
    docs/ and web/ is checked, one without docs/ fails the phase."""
    import shutil
    cs = _chip_smoke()
    ref = tmp_path / "reference"
    (ref / "docs").mkdir(parents=True)
    (ref / "web").mkdir()
    (ref / "docs" / "tone.md").write_text(
        "# Tone\n\n<tuun-synth open='[\"std\"]' "
        "expression=\"$440 * 0.5 | lpf(0.7, 2000)\"></tuun-synth>\n")
    shutil.copy(REPO / "web" / "index.html", ref / "web" / "index.html")
    row = cs.tools_corpus(CPU, render_samples=1024, reference=ref)
    assert row["reference"] == {"ok": 7, "skipped": 0}
    with pytest.raises(cs.SmokeFailure, match="is not a directory"):
        cs.tools_corpus(CPU, render_samples=1024, reference=tmp_path / "no")


def test_kernel_symbols_name_the_sources_kernels():
    """profile's census and chip_smoke's one-launch check find the
    hand-written kernels by scan_ops.KERNEL_SYMBOLS: one entry for each
    counted wrapper, each a __global__ function of csrc/."""
    from tuun_tpu_torch.engine import scan_ops
    assert set(scan_ops.KERNEL_SYMBOLS) == set(scan_ops.launches)
    src = scan_ops.SOURCE.read_text() + scan_ops.EXACT_SOURCE.read_text()
    defined = set(re.findall(
        r"__global__ void (?:__launch_bounds__\(\w+\)\s+)?(\w+)\(", src))
    assert set(scan_ops.KERNEL_SYMBOLS.values()) <= defined, defined
