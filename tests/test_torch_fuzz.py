"""Differential fuzzing of the port: twins of tests/test_fuzz.py's engine
lanes, over the same seed banks.

Each random tree comes from the port's fuzzgen (a verbatim copy of
tuun_tpu's, so one seed gives the same tree in both IRs).  The port's
render on the CPU (the kernels' plain versions) is held to the oracle at
test_fuzz.py's tolerance, and to tuun_tpu's render of the same form at
the same tolerance (at one block size, the middle of test_fuzz.py's three,
to keep the JAX side's eager renders within the file's time)."""

import random

import numpy as np
import pytest
import torch

from tuun_tpu import engine as jengine
from tuun_tpu import fuzzgen as jfuzzgen
from tuun_tpu import optimizer as joptimizer
from tuun_tpu import oracle
from tuun_tpu.engine.graph import CompiledVoice as JaxVoice
from tuun_tpu.engine.graph import EngineConfig as JaxConfig
from tuun_tpu_torch import fuzzgen, ir, optimizer
from tuun_tpu_torch.engine import render
from tuun_tpu_torch.engine.graph import CompiledVoice, EngineConfig

torch.set_num_threads(1)

SR = 4
CPU = "cpu"
ATOL, RTOL = 2e-4, 1e-3
# The block size at which each case is also held to tuun_tpu's render.
JAX_BLOCK = 8


def trees(seed, depth):
    """The seed's tree in the port's IR and in tuun_tpu's."""
    return (fuzzgen.random_waveform(random.Random(seed), depth),
            jfuzzgen.random_waveform(random.Random(seed), depth))


def skip_if_unusable(wj, n, seed, allow_undefined=False):
    """test_fuzz.py's skips: unstable filters and ill-conditioned trees
    (and, for exact_df's lane, programs the reference leaves undefined)."""
    try:
        ref = oracle.render(wj, n, SR, seed=seed)
    except AssertionError:
        if not allow_undefined:
            raise
        pytest.skip("reference-undefined: non-monotone Fin length under "
                    "windowed rendering")
    if not np.all(np.isfinite(ref)):
        pytest.skip("unstable filter / inf samples")
    if jfuzzgen.ill_conditioned(wj, n, SR, seed):
        pytest.skip("ill-conditioned: internal magnitudes amplify rounding")


def forms(w, wj):
    """(port form, tuun_tpu form) pairs: the tree, and its optimized form
    when it has no noise (noise streams key on node positions)."""
    if any(isinstance(x, ir.Noise) for x in w.walk()):
        return [(w, wj)]
    return [(w, wj), (optimizer.optimize(w), joptimizer.optimize(wj))]


def check_exact(precision, seed, depth=3, n=24, allow_undefined=False):
    w, wj = trees(seed, depth)
    skip_if_unusable(wj, n, seed, allow_undefined)
    for form, jform in forms(w, wj):
        for block in (3, 8, 32):
            try:
                ref = oracle.render(jform, n, SR, seed=seed, block=block)
            except AssertionError:
                if not allow_undefined:
                    raise
                pytest.skip("reference-undefined: non-monotone Fin length "
                            "under blockwise rendering")
            got = render(form, n, SR, precision=precision, seed=seed,
                         block=block, device=CPU)
            assert len(got) == len(ref), (
                f"seed={seed} block={block} len {len(got)} != {len(ref)}"
                f"\n{form}")
            np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL,
                                       err_msg=f"seed={seed} block={block}"
                                               f"\n{form}")
            if block == JAX_BLOCK:
                want = jengine.render(jform, n, SR, precision=precision,
                                      seed=seed, block=block, jit=False)
                assert len(got) == len(want)
                np.testing.assert_allclose(
                    got, np.asarray(want), atol=ATOL, rtol=RTOL,
                    err_msg=f"against tuun_tpu: seed={seed} block={block}"
                            f"\n{form}")


@pytest.mark.parametrize("seed", range(0, 40))
def test_fuzz_engine_vs_oracle(seed):
    """test_fuzz.py's lane of the same name: exact precision."""
    check_exact("exact", seed)


@pytest.mark.parametrize("seed", range(56, 72))
def test_fuzz_reloc_fast_path_vs_oracle(seed):
    """The opt-in relocatable fast path (reloc_fast=True) in exact
    precision against the oracle and tuun_tpu's, on trees that happen to
    be relocatable."""
    w, wj = trees(seed, 3)
    skip_if_unusable(wj, 24, seed)
    cv = CompiledVoice(w, EngineConfig(SR, "exact", CPU, reloc_fast=True))
    if not cv.relocatable:
        pytest.skip("tree not relocatable")
    jcv = JaxVoice(wj, JaxConfig(SR, "exact", seed=seed, jit=False,
                                 reloc_fast=True))
    outs = []
    for voice in (cv, jcv):
        P = voice.params(seed)
        st = voice.init(P)
        out = []
        for _ in range(4):
            y, v, st, _ = voice.render_block(P, st, 8)
            out.append(np.asarray(y)[:int(v)] if voice is jcv
                       else y[:int(v)].numpy())
            if int(v) < 8:
                break
        outs.append(np.concatenate(out))
    got, want = outs
    ref = oracle.render(wj, len(got), SR, seed=seed, block=8)
    m = min(len(got), len(ref))
    np.testing.assert_allclose(got[:m], ref[:m], atol=ATOL, rtol=RTOL,
                               err_msg=f"seed={seed}\n{w}")
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL,
                               err_msg=f"against tuun_tpu: seed={seed}\n{w}")


@pytest.mark.parametrize("seed", range(72, 96))
def test_fuzz_fast_precision_vs_exact(seed):
    """The fast precision against exact mode, statistically (reset edges
    may move by a sample, filters smear locally), as test_fuzz.py holds
    it; and each against tuun_tpu's render of the same precision."""
    w, wj = trees(seed, 3)
    n = 48
    skip_if_unusable(wj, n, seed)
    got = {p: render(w, n, SR, precision=p, seed=seed, block=16, device=CPU)
           for p in ("exact", "fast")}
    exact, fast = got["exact"], got["fast"]
    assert len(fast) == len(exact), f"seed={seed}\n{w}"
    if len(fast):
        err = np.abs(fast - exact)
        scale = max(1.0, float(np.abs(exact).max()))
        assert float(np.median(err)) < 1e-3 * scale, f"seed={seed}\n{w}"
        assert float(np.mean(err > 0.05 * scale)) < 0.1, f"seed={seed}\n{w}"
    for p, y in got.items():
        want = np.asarray(jengine.render(wj, n, SR, precision=p, seed=seed,
                                         block=16, jit=False))
        assert len(y) == len(want)
        if p == "exact":
            np.testing.assert_allclose(y, want, atol=ATOL, rtol=RTOL,
                                       err_msg=f"exact seed={seed}\n{w}")
        elif len(y):
            # Fast mode's f32 scans run in other groupings here and in
            # XLA: the same statistical gate as against exact mode.
            err = np.abs(y - want)
            scale = max(1.0, float(np.abs(want).max()))
            assert float(np.median(err)) < 1e-3 * scale, f"seed={seed}"
            assert float(np.mean(err > 0.05 * scale)) < 0.1, f"seed={seed}"


@pytest.mark.parametrize("seed", range(136, 168))
def test_fuzz_exact_df_vs_oracle(seed):
    """exact_df (double-single phase, the sequential IIR) against the
    oracle at the strict exact tolerances, and against tuun_tpu's
    exact_df."""
    check_exact("exact_df", seed, allow_undefined=True)
