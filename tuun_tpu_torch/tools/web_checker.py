"""Docs-as-test-corpus checker.

Port of the reference's web_checker (src/misc/web_checker.rs): extracts
every `<tuun-synth>` expression from .md/.html files, parses and evaluates
it against the embedded standard modules, exactly the way the web runtime
would.  Documentation doubles as a conformance suite — pointing this at the
*reference's* docs directory validates language compatibility on the real
corpus.

Usage: python -m tuun_tpu_torch.tools.web_checker [--device cpu] FILE...

The engine renders on the card unless --device cpu asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from .. import builtins as builtins_mod
from .. import eval as eval_mod
from .. import parser
from ..engine import CompiledVoice, EngineConfig
from ..engine.graph import check_device
from ..expr import (BOpen, EFloat, ESeq, EWaveform, SourceBinding, TuunError,
                    definition)
from ..ids import MarkId
from ..sliders import append_slider_bindings

STDLIB = Path(__file__).resolve().parent.parent / "stdlib" / "v0"
EMBEDDED_MODULES = ("std", "env_minmax", "pm_synth")


@dataclass
class CheckReport:
    ok: List[str] = field(default_factory=list)
    skipped: List[str] = field(default_factory=list)
    failed: List[Tuple[str, str]] = field(default_factory=list)  # label, err


def _find_tag_close(html: str) -> Optional[int]:
    """Index of the opening tag's closing '>', skipping quoted attributes
    (which may contain '>' — e.g. slider fn sources)."""
    i = 0
    while i < len(html):
        c = html[i]
        if c in "\"'":
            j = html.find(c, i + 1)
            if j < 0:
                return None
            i = j + 1
        elif c == ">":
            return i
        else:
            i += 1
    return None


def _extract_attr(block: str, name: str) -> Optional[str]:
    for quote in ('"', "'"):
        pat = f"{name}={quote}"
        start = block.find(pat)
        if start >= 0:
            vs = start + len(pat)
            end = block.find(quote, vs)
            if end >= 0:
                return block[vs:end]
    return None


def _strip_comments(expression: str) -> str:
    out = []
    for line in expression.split("\n"):
        idx = line.find("//")
        out.append(line[:idx] if idx >= 0 else line)
    return "\n".join(out)


def find_blocks(text: str) -> List[Tuple[int, str]]:
    """All <tuun-synth> blocks as (line_number, block_text)."""
    blocks = []
    pos = 0
    while True:
        start = text.find("<tuun-synth", pos)
        if start < 0:
            break
        line = text.count("\n", 0, start) + 1
        rest = text[start:]
        self_close = rest.find("/>")
        close_tag = rest.find("</tuun-synth>")
        if self_close >= 0 and (close_tag < 0 or self_close < close_tag):
            end = start + self_close + 2
        elif close_tag >= 0:
            end = start + close_tag + len("</tuun-synth>")
        else:
            pos = start + len("<tuun-synth")
            continue
        blocks.append((line, text[start:end]))
        pos = end
    return blocks


def extract_expression(block: str) -> Optional[str]:
    expr = _extract_attr(block, "expression")
    if expr is not None:
        return expr
    tag_end = _find_tag_close(block)
    if tag_end is None:
        return None
    body = block[tag_end + 1:]
    if body.endswith("</tuun-synth>"):
        body = body[:-len("</tuun-synth>")]
    script_start = body.find("<script")
    if script_start >= 0:
        inner_start = body.find(">", script_start)
        inner_end = body.find("</script>", inner_start)
        if inner_start >= 0 and inner_end >= 0:
            body = body[inner_start + 1:inner_end]
    body = body.strip()
    return body or None


class Checker:
    def __init__(self, sample_rate: int = 44100, tempo: int = 120,
                 compile_check: bool = True, render_samples: int = 0,
                 device="cuda"):
        prelude: List[SourceBinding] = []
        prelude.append(definition("sample_rate", EFloat(float(sample_rate))))
        prelude.append(definition("tempo", EFloat(float(tempo))))
        builtins_mod.add_bindings(prelude)
        prelude.append(definition(
            "debug", builtins_mod.debug(lambda m: None)))
        self.prelude = prelude
        self.compile_check = compile_check
        self.render_samples = render_samples
        self.sample_rate = sample_rate
        self.device = device
        self.cfg = EngineConfig(sample_rate, "fast", device)
        check_device(self.cfg.device)
        self.modules: Dict[str, List[SourceBinding]] = {}
        for name in EMBEDDED_MODULES:
            content = (STDLIB / f"{name}.tuun").read_text()
            bindings, errors = parser.parse_module(content)
            if errors:
                raise errors[0]
            bindings.insert(0, SourceBinding(BOpen(("__prelude",))))
            self.modules[name] = bindings

    def resolve(self, path):
        if path == ("__prelude",):
            return self.prelude
        key = ".".join(path)
        if key in self.modules:
            return self.modules[key]
        raise TuunError(f"unknown module {key}")

    def check_block(self, block: str) -> Tuple[str, str, str]:
        """Returns (status in ok|skip|fail, label, message)."""
        description = _extract_attr(block, "description") or ""
        expression = extract_expression(block)
        if expression is None:
            return "skip", description, "no expression"
        expression = _strip_comments(expression)
        label = description or " ".join(expression.split())[:60]

        try:
            expr = parser.parse_program(expression)
        except TuunError as e:
            return "fail", label, f"parse error: {e}"

        sliders_attr = _extract_attr(block, "sliders")
        slider_configs = []
        if sliders_attr:
            try:
                slider_configs = parser.parse_sliders(sliders_attr)
            except TuunError as e:
                return "fail", label, f"slider parse error: {e}"

        open_attr = _extract_attr(block, "open") or "[]"
        try:
            opens = json.loads(open_attr)
        except json.JSONDecodeError as e:
            return "fail", label, f"open parsing error: {e}"

        bindings: List[SourceBinding] = [SourceBinding(BOpen(("__prelude",)))]
        for o in opens:
            bindings.append(SourceBinding(BOpen(tuple(o.split(".")))))
        # The checker binds sliders at normalized position 0.0, like the
        # reference (web_checker.rs:305-310).
        append_slider_bindings(slider_configs, [0.0] * len(slider_configs),
                               MarkId.slider, bindings)
        try:
            value = eval_mod.evaluate(self.resolve, bindings, expr)
        except TuunError as e:
            return "fail", label, f"evaluate error: {e}"
        except RecursionError:
            return "fail", label, "evaluate error: recursion limit"

        # Beyond the reference: also compile the result through the
        # engine front-end (structure only, no execution).
        if self.compile_check:
            w = None
            if isinstance(value, EWaveform):
                w = value.waveform
            elif isinstance(value, ESeq) and isinstance(value.waveform,
                                                        EWaveform):
                w = value.waveform.waveform
            if w is not None:
                try:
                    CompiledVoice(w, self.cfg)
                except Exception as e:
                    return "fail", label, f"engine compile error: {e}"
            if w is not None and self.render_samples:
                err = self._render_diff(w)
                if err:
                    return "fail", label, err
        return "ok", label, ""

    # Per-class render-diff tolerances, derived from the fast mode's
    # pinned deviation envelope (docs/design.md §3/§5) instead of one
    # blanket bound.  Classes compose by taking the loosest applicable
    # bound per metric.  The structural discriminator — which a blanket
    # %-of-samples rule cannot provide — is `max_run`: fast-mode
    # deviations are ISOLATED (a quantized reset edge shifts one sample;
    # a boundary rounds one sample; a filter smears an edge locally),
    # while a genuine engine bug (wrong segment boundary, bad state
    # carry) corrupts a CONTIGUOUS region, which trips the run bound at
    # any error fraction.
    #   median: median |err| / peak
    #   frac: fraction of samples off by >5% of peak (reset-edge class:
    #         edge density is signal-dependent, so a fraction, not a
    #         count); on top of frac, every class gets a per-boundary
    #         allowance of 2 samples per Fin/Append/Alt node (each f32
    #         cutoff comparison can round the adjacent sample differently
    #         than the f64 oracle)
    #   max_run: longest run of consecutive samples off by >5% of peak
    #   corr: min log-spectral correlation (m >= 256 and signal present)
    _TOL = {
        # constant-frequency NCO trees: phase exact by construction,
        # only f32 elementwise rounding + per-boundary cutoff rounding
        "nco": dict(median=1e-4, frac=0.0, max_run=2,
                    corr=0.999),
        # FM prefix-sum path: linear phase drift <= 1 ulp of the block
        # phase total per block (~2e-3 rad) -> small everywhere-errors,
        # never above 5% of peak away from boundaries
        "fm": dict(median=2e-3, frac=0.0, max_run=8,
                   corr=0.999),
        # IIR associative scan (f32) vs sequential f64: local smear
        "filter": dict(median=1e-3, frac=0.002, max_run=64,
                       corr=0.995),
        # Reset: trigger-sign quantization shifts individual edges by
        # one sample; edge density is signal-dependent (a 440 Hz saw has
        # 440 jitter candidates/s), hence a fraction + a short run bound
        "reset": dict(median=1e-3, frac=0.02, max_run=64,
                      corr=0.995),
    }

    @classmethod
    def _classify(cls, wo) -> list:
        from .. import ir
        classes = ["nco"]
        for x in wo.walk():
            if isinstance(x, ir.Sine) and not isinstance(x.frequency,
                                                         ir.Const):
                classes.append("fm")
            elif isinstance(x, ir.Filter):
                classes.append("filter")
            elif isinstance(x, ir.Reset):
                classes.append("reset")
        return sorted(set(classes))

    def _render_diff(self, w) -> str:
        """Renders the example through the production engine (fast
        precision, on the card unless device="cpu") and diffs
        it against the native per-sample oracle: the corpus-as-conformance
        idea (check-web-examples.sh) extended from parse/evaluate/compile
        to full rendering.  Noise-bearing trees compare statistically
        (amplitude + spectral shape); deterministic ones compare samples
        against the per-class tolerance table (_TOL) derived from the
        pinned fast-mode envelope (docs/design.md §3/§5)."""
        import numpy as np

        from .. import engine, ir, native, optimizer

        if not native.native_available():
            return ""  # no oracle to diff against (toolchain-less env)
        n = self.render_samples
        sr = self.sample_rate
        wo = optimizer.optimize(w)
        try:
            ref = native.render(wo, n, sr)
        except Exception as e:
            return f"oracle render error: {e}"
        try:
            got = engine.render(wo, n, sr, precision="fast",
                                block=1 << 15, device=self.device)
        except Exception as e:
            return f"engine render error: {e}"
        if abs(len(got) - len(ref)) > 1:
            return f"length mismatch: engine {len(got)} vs oracle {len(ref)}"
        m = min(len(got), len(ref))
        if m == 0:
            return ""
        a, b = np.asarray(got[:m]), np.asarray(ref[:m])
        if not np.all(np.isfinite(a)):
            return "non-finite engine samples"
        scale = max(float(np.abs(b).max()), 1e-6)
        if any(isinstance(x, ir.Noise) for x in wo.walk()):
            # PRNG streams differ sample-wise by design; amplitude and
            # spectral shape must still agree.
            ra = float(np.sqrt((a * a).mean()))
            rb = float(np.sqrt((b * b).mean()))
            if abs(ra - rb) > 0.1 * max(rb, 1e-3):
                return f"noise rms mismatch: {ra:.4f} vs {rb:.4f}"
            if m >= 256 and rb > 1e-4:
                F = np.abs(np.fft.rfft(b * np.hanning(m)))
                G = np.abs(np.fft.rfft(a * np.hanning(m)))
                corr = float(np.corrcoef(np.log1p(F), np.log1p(G))[0, 1])
                if corr < 0.95:
                    return f"noise spectral correlation {corr:.4f} too low"
            return ""
        classes = self._classify(wo)
        tol = {k: max(self._TOL[c][k] for c in classes)
               for k in ("median", "frac", "max_run", "corr")}
        tol["corr"] = min(self._TOL[c]["corr"] for c in classes)
        err = np.abs(a - b)
        if float(np.median(err)) > tol["median"] * scale:
            return (f"median error {float(np.median(err)):.5f} too large "
                    f"for class {'+'.join(classes)}")
        large = err > 0.05 * scale
        n_large = int(large.sum())
        # Boundary-rounding allowance: each Fin/Append/Alt cutoff
        # comparison can round the single adjacent sample differently
        # between f32 (fast) and f64 (oracle).
        boundaries = sum(isinstance(x, (ir.Fin, ir.Append, ir.Alt))
                         for x in wo.walk())
        allowed = 2 * boundaries + 2 + int(tol["frac"] * m)
        if n_large > allowed:
            return (f"{n_large} samples off by >5% of peak (allowed "
                    f"{allowed} for class {'+'.join(classes)}, "
                    f"{boundaries} boundaries)")
        if n_large:
            # Contiguity: fast-mode deviations are isolated; a corrupted
            # CONTIGUOUS region means a structural bug at any fraction.
            runs = np.diff(np.flatnonzero(np.diff(
                np.concatenate(([0], large.view(np.int8), [0])))))[::2]
            longest = int(runs.max()) if len(runs) else 0
            if longest > tol["max_run"]:
                return (f"contiguous mismatch run of {longest} samples "
                        f"(max {tol['max_run']} for class "
                        f"{'+'.join(classes)})")
        if m >= 256 and float(np.abs(b).max()) > 1e-4:
            F = np.abs(np.fft.rfft(b * np.hanning(m)))
            G = np.abs(np.fft.rfft(a * np.hanning(m)))
            corr = float(np.corrcoef(np.log1p(F), np.log1p(G))[0, 1])
            if corr < tol["corr"]:
                return (f"spectral correlation {corr:.4f} < {tol['corr']} "
                        f"for class {'+'.join(classes)}")
        return ""

    def check_file(self, path, report: CheckReport) -> None:
        text = Path(path).read_text()
        for line, block in find_blocks(text):
            status, label, message = self.check_block(block)
            tag = f"{path}:{line} {label}"
            if status == "ok":
                report.ok.append(tag)
            elif status == "skip":
                report.skipped.append(tag)
            else:
                report.failed.append((tag, message))


def check_files(paths, compile_check: bool = True,
                render_samples: int = 0, device="cuda") -> CheckReport:
    checker = Checker(compile_check=compile_check,
                      render_samples=render_samples, device=device)
    report = CheckReport()
    for p in paths:
        checker.check_file(p, report)
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="web_checker")
    p.add_argument("files", nargs="*", metavar="FILE")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv if argv is not None else sys.argv[1:])
    if not args.files:
        print("usage: web_checker [--device cpu] FILE...", file=sys.stderr)
        return 2
    report = check_files(args.files, device=args.device)
    for tag in report.skipped:
        print(f"[skip] {tag}")
    for tag, message in report.failed:
        print(f"[FAIL] {tag}: {message}")
    print(f"{len(report.ok)} ok, {len(report.skipped)} skipped, "
          f"{len(report.failed)} failed")
    return 1 if report.failed else 0


if __name__ == "__main__":
    sys.exit(main())
