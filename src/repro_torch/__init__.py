"""PyTorch/CUDA port of the MDD model-exchange system.

Mirrors ``repro`` (the JAX reference) module for module: ``repro/x/y.py``
is ported as ``repro_torch/x/y.py``.  The market layers (event loop,
vault, discovery, ledger, continuum, faults, topology) are
framework-neutral copies; the cohort math and the dense LLM serving path
(``launch/serve.py`` down to ``models/attention.py``) are PyTorch; the
fused distillation loss (:mod:`repro_torch.kernels.kd_loss`) and prefill
attention (:mod:`repro_torch.kernels.flash_attention`) are hand-written
CUDA kernels for Hopper.  Entry points run on the GPU unless the caller
asks for the CPU.
"""
