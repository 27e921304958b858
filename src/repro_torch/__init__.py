"""PyTorch/CUDA port of the MDD model-exchange system.

Mirrors ``repro`` (the JAX reference) module for module: ``repro/x/y.py``
is ported as ``repro_torch/x/y.py``.  The market layers (event loop,
vault, discovery, ledger, continuum, faults, topology) are
framework-neutral copies; the cohort math is PyTorch; the fused
distillation loss is a hand-written CUDA kernel for Hopper
(:mod:`repro_torch.kernels.kd_loss`).  Entry points run on the GPU unless
the caller passes ``device="cpu"``.
"""
