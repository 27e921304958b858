"""The call site the loss code uses for the kernels.

``kd_loss`` goes to :func:`repro_torch.kernels.kd_loss.kd_loss`, which
launches the CUDA kernel for CUDA tensors and takes the plain PyTorch
version for tensors on the CPU.
"""
from __future__ import annotations

from repro_torch.kernels import kd_loss as _kd


def kd_loss(student_logits, teacher_logits, labels, *, alpha=0.5,
            temperature=2.0):
    return _kd.kd_loss(student_logits, teacher_logits, labels, alpha=alpha,
                       temperature=temperature)
