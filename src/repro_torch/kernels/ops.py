"""The call sites the port's model and loss code use for the kernels.

Each forwards to the kernel's wrapper, which launches the CUDA kernel for
CUDA tensors and takes the plain PyTorch version for tensors on the CPU.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import kd_loss as _kd
from repro_torch.kernels import ssd_scan as _ssd


def flash_attention(q, k, v, *, causal=True, window=None):
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


def kd_loss(student_logits, teacher_logits, labels, *, alpha=0.5,
            temperature=2.0):
    return _kd.kd_loss(student_logits, teacher_logits, labels, alpha=alpha,
                       temperature=temperature)


def ssd_scan(x, dt, A, B_, C_, *, chunk=128):
    return _ssd.ssd_scan(x, dt, A, B_, C_, chunk=chunk)
