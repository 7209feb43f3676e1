"""Engine-backed precompute: bakes finite, non-dynamic subtrees to Fixed.

Port of tuun_tpu/engine/precompute.py: the oracle's classification
(generator.rs:868-1229, oracle.Oracle.precompute), with the baked
subtrees rendered through the block engine instead of a per-sample loop.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .. import ir, oracle
from .graph import CompiledVoice, EngineConfig

PRECOMPUTE_CAP_SECONDS = oracle.Oracle.PRECOMPUTE_CAP_SECONDS


class EnginePrecomputer(oracle.Oracle):
    """Oracle classification with engine-backed rendering of baked parts."""

    def __init__(self, sample_rate: int, seed: int = 0,
                 cfg: Optional[EngineConfig] = None):
        super().__init__(sample_rate, seed=seed)
        self.cfg = cfg or EngineConfig(sample_rate, precision="fast")

    def _generate_fixed(self, w: ir.Waveform) -> ir.Waveform:
        if isinstance(w, (ir.Fixed, ir.Const)):
            return w
        cap = self.sample_rate * PRECOMPUTE_CAP_SECONDS
        voice = CompiledVoice(w, self.cfg)
        P = voice.params(self.seed)
        state = voice.init(P)
        block = min(1 << 16, max(1024, cap))
        out = []
        total = 0
        while total < cap:
            n = min(block, cap - total)
            y, v, state, _ = voice.render_block(P, state, block, 0, n)
            v = int(v)
            out.append(y[:v].cpu().numpy())
            total += v
            if v < n:
                break
        samples = np.concatenate(out) if out else np.zeros(0, np.float32)
        return ir.Fixed(samples[:cap])


def precompute(w: ir.Waveform, sample_rate: int, seed: int = 0,
               cfg: Optional[EngineConfig] = None) -> ir.Waveform:
    return EnginePrecomputer(sample_rate, seed, cfg).precompute(w)
