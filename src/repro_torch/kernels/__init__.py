"""Hand-written Hopper kernels, each beside its plain PyTorch version.

  kd_loss — fused per-row distillation loss (CUDA C++, ``csrc/kd_loss.cu``).

``ops.py`` is the call site the loss code uses; ``ref.py`` holds the
PyTorch oracles the tests hold the kernels against.
"""
