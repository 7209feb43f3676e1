"""tuun_tpu_torch: the PyTorch port of tuun-tpu, for CUDA cards.

A second package beside tuun_tpu (the JAX reference, unchanged).  It
reuses tuun_tpu's pure-Python front end (ir, parser, evaluator,
optimizer, oracle, native, wav, ...) and never imports jax:
  * engine                 -- compiles Waveform IR into PyTorch
                              block-render programs; the cross-lane scans
                              are hand-written CUDA kernels (csrc/scan.cu)
  * tracker / player / cli -- the per-voice batch render path
"""

__version__ = "0.1.0"
