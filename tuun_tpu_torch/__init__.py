"""tuun_tpu_torch: the PyTorch port of tuun-tpu, for CUDA cards.

A package of its own beside tuun_tpu (the JAX reference, unchanged).  It
imports torch and never jax, and nothing of tuun_tpu:
  * ids / ir / expr / diagnostics / parser / eval / optimizer /
    builtins / evaluator / sliders / programs -- the Tuun language's
                              front end and the Waveform IR, a copy of
                              tuun_tpu's pure-Python modules, held equal
                              to them by tests/test_torch_frontend.py
  * stdlib/v0              -- the language's standard library (std.tuun)
  * oracle / native / wav / noisegen
                           -- the sample-exact numpy and C++ oracles
                              (lengths, precompute classification), WAV
                              files, counter-hash noise
  * engine                 -- compiles Waveform IR into PyTorch
                              block-render programs; the cross-lane scans
                              are hand-written CUDA kernels (csrc/scan.cu)
  * tracker / player / cli -- the per-voice batch render path

Its entry points (EngineConfig, render, Tracker, the CLI) run on the
card unless the caller asks for device="cpu"; without a card a CUDA
request raises.
"""

__version__ = "0.1.0"
