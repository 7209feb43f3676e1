"""Terminal renderer — the live renderer.rs analogue.

The reference's SDL2 renderer paints, every audio callback: a
live-buffer oscilloscope with clipping drawn in a warning color
(renderer.rs:154-215), a realfft log-magnitude spectrum, and HUD graphs
of tracker_load / allocations (renderer.rs:681-704).  The TPU build has
no window or GPU surface; this module renders the same views as text —
braille-dot waveforms, eighth-block spectrum bars, sparkline HUDs — so
the live view runs anywhere a terminal does (the offline PNG
counterpart is tools/scope.py).

Everything here is a pure function from (samples, status) to strings;
the REPL's `view` command owns the repaint loop.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

# Braille cells pack 2 columns x 4 rows of dots starting at U+2800.
# Dot bit layout (Unicode standard):  col0: 0x01,0x02,0x04,0x40 (top to
# bottom), col1: 0x08,0x10,0x20,0x80.
_BRAILLE_BITS = ((0x01, 0x08), (0x02, 0x10), (0x04, 0x20), (0x40, 0x80))
_EIGHTHS = " ▁▂▃▄▅▆▇█"
_SPARKS = "▁▂▃▄▅▆▇█"
_RED = "\x1b[31m"
_DIM = "\x1b[2m"
_RESET = "\x1b[0m"


def braille_scope(samples: np.ndarray, width: int = 78, height: int = 8,
                  color: bool = False) -> List[str]:
    """Oscilloscope as `height` rows of braille cells, `width` cells
    wide.  Each pixel column (2 per cell) draws the vertical min..max
    run of its sample span — the same "envelope" drawing a windowed
    scope view uses, so any block size maps onto the fixed raster.
    Cells whose span clips (|y| > 1) are painted in the warning color
    when `color` (renderer.rs clip colors)."""
    samples = np.asarray(samples, np.float32).ravel()
    if samples.size == 0:
        samples = np.zeros(1, np.float32)
    px_w, px_h = width * 2, height * 4
    # Pixel-column envelope: split samples into px_w spans.
    bounds = np.linspace(0, samples.size, px_w + 1).astype(np.int64)
    grid = np.zeros((height, width), np.uint32)
    clip = np.zeros((height, width), bool)
    # Scale [-1.2, 1.2] onto the raster so clipping is visible.
    lo_v, hi_v = -1.2, 1.2
    for px in range(px_w):
        a, b = bounds[px], max(bounds[px + 1], bounds[px] + 1)
        span = samples[a:min(b, samples.size)]
        if span.size == 0:
            span = samples[-1:]
        mn, mx = float(span.min()), float(span.max())
        clipped = mx > 1.0 or mn < -1.0
        # Map value to pixel row (0 = top).
        def row_of(v):
            r = int((hi_v - v) / (hi_v - lo_v) * (px_h - 1))
            return min(max(r, 0), px_h - 1)
        r0, r1 = row_of(mx), row_of(mn)
        cell_col, dot_col = divmod(px, 2)
        for r in range(r0, r1 + 1):
            cell_row, dot_row = divmod(r, 4)
            grid[cell_row, cell_col] |= _BRAILLE_BITS[dot_row][dot_col]
            if clipped:
                clip[cell_row, cell_col] = True
    rows = []
    for ri in range(height):
        parts = []
        for ci in range(width):
            ch = chr(0x2800 + int(grid[ri, ci]))
            if color and clip[ri, ci] and grid[ri, ci]:
                parts.append(_RED + ch + _RESET)
            else:
                parts.append(ch)
        rows.append("".join(parts))
    return rows


def spectrum_bars(samples: np.ndarray, sample_rate: int, width: int = 78,
                  height: int = 6, floor_db: float = -72.0) -> List[str]:
    """Log-magnitude spectrum as eighth-block bars over log-spaced
    frequency bins, 20 Hz .. Nyquist (renderer.rs realfft view)."""
    samples = np.asarray(samples, np.float32).ravel()
    n = min(samples.size, 1 << 15)
    if n < 16:
        return [" " * width for _ in range(height)]
    window = np.hanning(n)
    mags = np.abs(np.fft.rfft(samples[:n] * window)) / (n / 2)
    freqs = np.fft.rfftfreq(n, 1.0 / sample_rate)
    nyq = sample_rate / 2.0
    lo = 20.0 if nyq > 40.0 else max(nyq / 100.0, 1e-3)
    edges = np.exp(np.linspace(math.log(lo), math.log(nyq), width + 1))
    db = np.full(width, floor_db)
    for i in range(width):
        sel = (freqs >= edges[i]) & (freqs < edges[i + 1])
        if sel.any():
            m = float(mags[sel].max())
            db[i] = 20.0 * math.log10(m) if m > 0 else floor_db
    # Column height in eighths of a cell.
    levels = np.clip((db - floor_db) / -floor_db, 0.0, 1.0)
    col_e = np.round(levels * height * 8).astype(int)
    rows = []
    for ri in range(height):          # top row first
        base = (height - 1 - ri) * 8
        rows.append("".join(
            _EIGHTHS[min(max(col_e[ci] - base, 0), 8)]
            for ci in range(width)))
    return rows


def sparkline(series: Sequence[float], width: int = 78,
              hi: Optional[float] = None) -> str:
    """HUD graph of a metric series (renderer.rs:681-704) as one line of
    block-height characters; the latest `width` points, right-aligned."""
    pts = [float(x) for x in series if x is not None][-width:]
    if not pts:
        return " " * width
    top = hi if hi is not None else max(max(pts), 1e-9)
    out = []
    for v in pts:
        k = int(min(max(v / top, 0.0), 1.0) * (len(_SPARKS) - 1))
        out.append(_SPARKS[k])
    return "".join(out).rjust(width)


def level_meter(rms: float, peak: float, width: int = 40,
                color: bool = False) -> str:
    """One voice's rms/peak as a bar: filled to rms, a marker at peak
    (the reference HUD's per-voice levels)."""
    def col(v):
        # -48 dB .. 0 dB window, linear in dB like the reference meters.
        if v <= 0:
            return 0
        db = 20.0 * math.log10(v)
        return int(min(max((db + 48.0) / 48.0, 0.0), 1.0) * (width - 1))
    r, p = col(rms), col(peak)
    bar = ["─"] * width
    for i in range(r + 1):
        bar[i] = "█"
    bar[p] = "▌" if p > r else bar[p]
    s = "".join(bar)
    if color and peak > 1.0:
        s = _RED + s + _RESET
    return s


@dataclass
class ProgramRow:
    """One program's line in the dashboard (the renderer.rs program
    list: name, text with the edit cursor, sliders, level — plus the
    playing marker the reference paints as the program color)."""

    name: str
    text: str
    selected: bool = False
    playing: bool = False
    pending: bool = False
    cursor: Optional[int] = None  # edit-mode cursor position in text
    sliders: Sequence[Tuple[str, float]] = field(default_factory=tuple)
    level_db: float = 0.0
    error: str = ""


def program_lines(rows: Sequence[ProgramRow], width: int = 78,
                  color: bool = False) -> List[str]:
    """The program list pane: selection cursor, play state, source text
    (with the edit cursor when editing), slider values, level."""
    lines = []
    for r in rows:
        marker = "►" if r.selected else " "
        play = "♪" if r.playing else ("…" if r.pending else " ")
        text = r.text
        if r.cursor is not None:
            c = min(max(r.cursor, 0), len(text))
            text = text[:c] + "│" + text[c:]
        body = " ".join(text.split())
        bits = []
        if r.sliders:
            bits.append(" ".join(f"{lab}={val:.3g}"
                                 for lab, val in r.sliders))
        if abs(r.level_db) > 1e-9:
            bits.append(f"{r.level_db:+.1f}dB")
        suffix = "  ".join(bits)
        head = f"{marker}{play} {r.name:>3} "
        room = width - len(head) - (len(suffix) + 2 if suffix else 0)
        line = head + body[:max(room, 8)]
        if suffix:
            pad = max(width - len(line) - len(suffix), 1)
            line = line + " " * pad + suffix
        if color and r.selected:
            line = "\x1b[1m" + line + _RESET
        lines.append(line)
        if r.error:
            err = f"      ! {r.error}"[:width]
            lines.append(_RED + err + _RESET if color else err)
    return lines


def beat_line(now: int, sample_rate: int, tempo: float,
              beats_per_measure: int) -> str:
    """The beat indicator (renderer.rs's per-beat circles): measure
    count plus one circle per beat, the current beat filled."""
    spb = sample_rate * 60.0 / max(tempo, 1e-9)
    beat = int(now / spb)
    in_measure = beat % beats_per_measure
    dots = " ".join("●" if i == in_measure else "○"
                    for i in range(beats_per_measure))
    return (f"measure {beat // beats_per_measure + 1:>4} "
            f"beat {in_measure + 1}/{beats_per_measure}  {dots}")


def dashboard_frame(samples: np.ndarray, sample_rate: int,
                    rows: Sequence[ProgramRow] = (),
                    levels: Optional[Sequence] = None,
                    load_series: Optional[Sequence[float]] = None,
                    dispatch_series: Optional[Sequence[float]] = None,
                    title: str = "", message: str = "",
                    beat: Optional[Tuple[int, float, int]] = None,
                    width: int = 78, color: bool = False) -> str:
    """The single live frame the reference renderer paints every
    callback (renderer.rs:127): program list + cursor + sliders, beat,
    oscilloscope, spectrum, per-voice levels, HUD sparklines, message.
    Pure string composition; the caller owns cursor control and
    repaint cadence (Repl.cmd_view)."""
    parts: List[str] = []
    if beat is not None:
        now, tempo, bpm = beat
        parts.append(beat_line(now, sample_rate, tempo, bpm))
    if rows:
        parts += program_lines(rows, width=width, color=color)
        parts.append(("─" * width) if not color
                     else _DIM + "─" * width + _RESET)
    parts.append(render_frame(samples, sample_rate, levels=levels,
                              load_series=load_series,
                              dispatch_series=dispatch_series,
                              title=title, width=width, color=color))
    if message:
        parts.append(message[:width * 2])
    return "\n".join(parts)


def render_frame(samples: np.ndarray, sample_rate: int,
                 levels: Optional[Sequence] = None,
                 load_series: Optional[Sequence[float]] = None,
                 dispatch_series: Optional[Sequence[float]] = None,
                 title: str = "", width: int = 78,
                 color: bool = False) -> str:
    """One full frame: title, oscilloscope, spectrum, optional level
    meters (id, rms, peak) and HUD sparklines. Pure string composition;
    the caller owns cursor control."""
    samples = np.asarray(samples, np.float32).ravel()
    peak = float(np.abs(samples).max()) if samples.size else 0.0
    head = title or f"{samples.size} samples @ {sample_rate} Hz"
    head = f"{head}  peak {peak:.3f}"
    if peak > 1.0:
        head += "  CLIP"
        if color:
            head = _RED + head + _RESET
    lines = [head[:width * 2]]
    # The scope draws only the latest ~2 samples/pixel-column tail (the
    # reference paints the current callback buffer at ~1 sample/px,
    # renderer.rs:154) — an arbitrarily long frame window would alias
    # to a solid envelope.
    scope_tail = samples[-(width * 2 * 2):]
    lines += braille_scope(scope_tail, width=width, color=color)
    lines.append(("─" * width) if not color
                 else _DIM + "─" * width + _RESET)
    lines += spectrum_bars(samples, sample_rate, width=width)
    if levels:
        for vid, rms, pk in levels:
            lines.append(f"{str(vid)[:12]:>12} {level_meter(rms, pk, max(width - 26, 10), color)}"
                         f" {20.0 * math.log10(max(rms, 1e-9)):+6.1f}dB")
    if load_series is not None:
        lines.append("load " + sparkline(load_series, width - 5, hi=1.0))
    if dispatch_series is not None:
        lines.append("disp " + sparkline(dispatch_series, width - 5))
    return "\n".join(lines)
