"""radio_mapper_tpu_torch — the TDOA pipeline in PyTorch with CUDA kernels.

A port of the flagship slice of :mod:`radio_mapper_tpu` (JAX/Pallas on a
TPU) to PyTorch on an NVIDIA H100: uint8 IQ decode → fused forward FFT +
spectral detection → all-pairs GCC-PHAT pair stage → sub-sample τ → LM
hyperbolic solve. The module layout mirrors the JAX package, so each
counterpart sits at the same path:

- :mod:`.ops.cuda.fft_detect` and :mod:`.ops.cuda.gcc_pair` wrap the two
  hand-written CUDA kernels (sources in ``csrc/``) and their plain PyTorch
  versions;
- :mod:`.models.pipeline` is the entry point (``TDOAPipeline``).

The package imports ``torch`` and numpy only; it never imports JAX.
"""
