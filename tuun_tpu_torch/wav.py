"""Minimal WAV I/O: 32-bit float mono (the reference's capture format —
hound WavSpec { channels: 1, bits_per_sample: 32, sample_format: Float },
tracker.rs:217-222) plus 16-bit PCM reading for comparisons."""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Tuple

import numpy as np


def write_wav_f32(path, samples: np.ndarray, sample_rate: int) -> None:
    samples = np.asarray(samples, dtype="<f4")
    data = samples.tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 4 + 8 + 16 + 8 + len(data)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        # format 3 = IEEE float
        f.write(struct.pack("<IHHIIHH", 16, 3, 1, sample_rate,
                            sample_rate * 4, 4, 32))
        f.write(b"data")
        f.write(struct.pack("<I", len(data)))
        f.write(data)


def read_wav(path) -> Tuple[np.ndarray, int]:
    """Reads a mono or multi-channel WAV; returns (float32 samples of the
    first channel, sample_rate)."""
    raw = Path(path).read_bytes()
    assert raw[:4] == b"RIFF" and raw[8:12] == b"WAVE", "not a WAV file"
    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(raw):
        cid = raw[pos:pos + 4]
        size = struct.unpack("<I", raw[pos + 4:pos + 8])[0]
        body = raw[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)
    assert fmt is not None and data is not None, "missing fmt/data chunk"
    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == 3 and bits == 32:
        samples = np.frombuffer(data, dtype="<f4")
    elif audio_format == 1 and bits == 16:
        samples = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
    elif audio_format == 1 and bits == 32:
        samples = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported WAV format {audio_format}/{bits}")
    if channels > 1:
        samples = samples[::channels]
    return np.ascontiguousarray(samples, dtype=np.float32), sample_rate
