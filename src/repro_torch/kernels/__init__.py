"""Hand-written Hopper kernels, each beside its plain PyTorch version.

  kd_loss         — fused per-row distillation loss (CUDA C++, ``csrc/kd_loss.cu``).
  flash_attention — causal / windowed GQA attention (``csrc/flash_attention.cu``).
  ssd_scan        — Mamba2 SSD chunked scan (``csrc/ssd_scan.cu``).

``ops.py`` is the call site the model and loss code use; ``ref.py`` holds
the PyTorch oracles the tests hold the kernels against.
"""
