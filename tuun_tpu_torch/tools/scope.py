"""Offline oscilloscope / spectrum plots — the renderer.rs analogue.

Port of tuun_tpu/tools/scope.py.  The reference's SDL2 renderer draws a
live-buffer oscilloscope with clipping colors, a realfft magnitude
spectrum, and HUD graphs of tracker_load / allocations (renderer.rs:154-215,
681-704).  This tool renders the same views to a PNG from a WAV file or a
Tuun expression.  `scope_views` computes what tuun_tpu's plot_scope draws;
`write_png` rasterises the views with numpy and writes the PNG with the
standard library (no plotting package), the title in a tEXt chunk.

Usage:
  python -m tuun_tpu_torch.tools.scope out.png --wav mix.wav
  python -m tuun_tpu_torch.tools.scope out.png --expr '$440 * Qw' \
      [--sample_rate 44100 --seconds 1.0 --device cpu]

The expression renders on the card unless --device cpu asks for the CPU.
"""

from __future__ import annotations

import argparse
import struct
import sys
import zlib
from typing import Optional, Sequence

import numpy as np

# Pixels of one panel (tuun_tpu's figure: 10 x 3 inches a panel at 100
# dpi).
WIDTH, PANEL = 1000, 300
MARGIN = 12
WHITE = (255, 255, 255)
TRACE = (31, 119, 180)
CLIP = (214, 39, 40)
GUIDE = (240, 170, 170)
AXIS = (200, 200, 200)
SERIES = ((31, 119, 180), (255, 127, 14))


def scope_views(samples: np.ndarray, sample_rate: int) -> dict:
    """What tuun_tpu's plot_scope draws: the time axis, the samples, the
    clip mask |x| > 1 and the peak; the Hann-windowed rfft of the first
    min(n, 2^15) samples in dB with its frequencies (None below 16
    samples)."""
    samples = np.asarray(samples, np.float32)
    if len(samples) == 0:
        samples = np.zeros(1, np.float32)
    views = {"t": np.arange(len(samples)) / sample_rate,
             "samples": samples,
             "clipped": np.abs(samples) > 1.0,
             "peak": float(np.abs(samples).max()),
             "freqs": None, "db": None}
    n = min(len(samples), 1 << 15)
    if n >= 16:
        window = np.hanning(n)
        mags = np.abs(np.fft.rfft(samples[:n] * window))
        views["freqs"] = np.fft.rfftfreq(n, 1.0 / sample_rate)
        views["db"] = 20 * np.log10(np.maximum(mags, 1e-9))
    return views


def _rows_of(values, lo, hi, height):
    """Pixel rows (0 at the top) of values on [lo, hi] in a panel."""
    span = max(hi - lo, 1e-12)
    inner = height - 2 * MARGIN
    frac = (np.asarray(values, np.float64) - lo) / span
    return np.clip(np.round(MARGIN + (1 - frac) * inner), 0,
                   height - 1).astype(np.int64)


def _vline(img, x, r0, r1, color):
    a, b = (r0, r1) if r0 <= r1 else (r1, r0)
    img[a:b + 1, x] = color


def _segment(img, x0, r0, x1, r1, color):
    """A 1-pixel line from (x0, r0) to (x1, r1), x0 <= x1: at each column
    a vertical run from the previous column's row to its own."""
    if x1 == x0:
        _vline(img, x0, r0, r1, color)
        return
    xs = np.arange(x0, x1 + 1)
    rs = np.round(r0 + (r1 - r0) * (xs - x0) / (x1 - x0)).astype(np.int64)
    prev = rs[0]
    for x, r in zip(xs, rs):
        _vline(img, x, prev, r, color)
        prev = r


def _polyline(img, xs, rows, color):
    """Joins consecutive points (x ascending) with line segments."""
    for k in range(1, len(xs)):
        _segment(img, xs[k - 1], rows[k - 1], xs[k], rows[k], color)
    if len(xs) == 1:
        _vline(img, xs[0], rows[0], rows[0], color)


def _scope_panel(views):
    width = WIDTH
    img = np.full((PANEL, width, 3), WHITE, np.uint8)
    y = views["samples"].astype(np.float64)
    lim = max(1.05, 1.05 * views["peak"])
    # Per pixel column: the min and max of its samples.
    cols = np.minimum((np.arange(len(y)) * width) // len(y), width - 1)
    lo = np.full(width, np.inf)
    hi = np.full(width, -np.inf)
    np.minimum.at(lo, cols, y)
    np.maximum.at(hi, cols, y)
    drawn = np.isfinite(lo)
    for r in _rows_of((1.0, -1.0), -lim, lim, PANEL):
        img[r, :] = GUIDE
    img[_rows_of(0.0, -lim, lim, PANEL), :] = AXIS
    xs = np.flatnonzero(drawn)
    top, bot = _rows_of(hi[xs], -lim, lim, PANEL), \
        _rows_of(lo[xs], -lim, lim, PANEL)
    for x, r0, r1 in zip(xs, top, bot):
        _vline(img, x, r0, r1, TRACE)
    # Each column's last sample joined to the next column's first.
    first = _rows_of(y[np.searchsorted(cols, xs, "left")], -lim, lim, PANEL)
    last = _rows_of(y[np.searchsorted(cols, xs, "right") - 1], -lim, lim,
                    PANEL)
    for k in range(1, len(xs)):
        _segment(img, xs[k - 1], last[k - 1], xs[k], first[k], TRACE)
    clipped = views["clipped"]
    if clipped.any():
        xs = cols[clipped]
        rs = _rows_of(y[clipped], -lim, lim, PANEL)
        img[rs, xs] = CLIP
        img[np.clip(rs + 1, 0, PANEL - 1), xs] = CLIP
    return img


def _spectrum_panel(views):
    width = WIDTH
    img = np.full((PANEL, width, 3), WHITE, np.uint8)
    if views["db"] is None:
        return img
    f, db = views["freqs"][1:], views["db"][1:]
    lf = np.log10(f)
    cols = np.clip(((lf - lf[0]) / max(lf[-1] - lf[0], 1e-12)
                    * (width - 1)).round().astype(np.int64), 0, width - 1)
    best = np.full(width, -np.inf)
    np.maximum.at(best, cols, db)
    xs = np.flatnonzero(np.isfinite(best))
    lo, hi = float(db.min()), float(db.max())
    _polyline(img, xs, _rows_of(best[xs], lo, hi, PANEL), TRACE)
    return img


def _hud_panel(series):
    width = WIDTH
    img = np.full((PANEL, width, 3), WHITE, np.uint8)
    present = [np.asarray(s, np.float64) for s in series if s]
    if not present:
        return img
    lo = min(0.0, min(float(s.min()) for s in present))
    hi = max(float(s.max()) for s in present)
    for s, color in zip(series, SERIES):
        if not s:
            continue
        s = np.asarray(s, np.float64)
        xs = (np.arange(len(s)) * (width - 1)) // max(len(s) - 1, 1)
        _polyline(img, xs, _rows_of(s, lo, hi, PANEL), color)
    return img


def raster(views: dict, load_series: Optional[Sequence[float]] = None,
           dispatch_series: Optional[Sequence[float]] = None) -> np.ndarray:
    """The panels stacked as an RGB image [rows * PANEL, WIDTH, 3]: the
    trace (each pixel column's min to max; clipped samples in red, the
    +-1 guides), the spectrum on a log-frequency axis, and the HUD's
    series when either is given."""
    panels = [_scope_panel(views), _spectrum_panel(views)]
    if load_series is not None or dispatch_series is not None:
        panels.append(_hud_panel((load_series, dispatch_series)))
    return np.concatenate(panels, axis=0)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(img: np.ndarray, out_path, title: str = "") -> None:
    """An 8-bit RGB PNG of img [H, W, 3] (filter 0 on every row), the
    title in a tEXt chunk."""
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          np.ascontiguousarray(img, np.uint8).reshape(h, -1)],
                         axis=1).tobytes()
    body = [_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))]
    if title:
        body.append(_chunk(b"tEXt", b"Title\0" + title.encode("latin-1",
                                                              "replace")))
    body.append(_chunk(b"IDAT", zlib.compress(raw, 6)))
    body.append(_chunk(b"IEND", b""))
    with open(out_path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + b"".join(body))


def plot_scope(samples: np.ndarray, sample_rate: int, out_path: str,
               load_series: Optional[Sequence[float]] = None,
               dispatch_series: Optional[Sequence[float]] = None,
               title: str = "") -> dict:
    """Writes an oscilloscope + spectrum (+ optional metric HUD) PNG and
    returns its views."""
    views = scope_views(samples, sample_rate)
    write_png(raster(views, load_series, dispatch_series), out_path,
              title or f"{len(views['samples'])} samples @ {sample_rate} Hz "
              f"(peak {views['peak']:.3f})")
    return views


def render_expr(text: str, sample_rate: int, tempo: int, seconds: float,
                device="cuda") -> Optional[np.ndarray]:
    """The expression's first `seconds` in fast mode on `device`, or None
    when it is not a waveform."""
    from pathlib import Path

    from .. import optimizer
    from ..engine.graph import render
    from ..evaluator import Evaluator
    from ..expr import ESeq, EWaveform

    lib = Path(__file__).resolve().parent.parent / "stdlib" / "v0"
    ev = Evaluator(sample_rate, tempo, lib)
    out = ev.evaluate_source(text, opens=("std",))
    if isinstance(out, ESeq):
        out = out.waveform
    if not isinstance(out, EWaveform):
        return None
    w = optimizer.optimize(out.waveform)
    return render(w, int(seconds * sample_rate), sample_rate,
                  precision="fast", device=device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("out", help="output PNG path")
    p.add_argument("--wav", help="input WAV file")
    p.add_argument("--expr", help="Tuun expression to render")
    p.add_argument("--sample_rate", type=int, default=44100)
    p.add_argument("--tempo", type=int, default=120)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    if args.wav:
        from ..wav import read_wav
        samples, sr = read_wav(args.wav)
    elif args.expr:
        sr = args.sample_rate
        samples = render_expr(args.expr, sr, args.tempo, args.seconds,
                              args.device)
        if samples is None:
            print("error: expression is not a waveform", file=sys.stderr)
            return 1
    else:
        print("error: provide --wav or --expr", file=sys.stderr)
        return 1

    plot_scope(np.asarray(samples, np.float32), sr, args.out,
               title=args.expr or args.wav)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
