"""Loss functions: cross-entropy and the MDD distillation objective.

``distillation_loss`` is the plain PyTorch reference;
:func:`fused_distillation_loss` computes the same quantity through the
fused per-row kernel path (:mod:`repro_torch.kernels.kd_loss`), without
materialising either softmax on the forward pass.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def cross_entropy_rows(logits, labels):
    """Per-row negative log-likelihood. logits: (..., C); labels: (...)."""
    logits = logits.float()
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return torch.logsumexp(logits, -1) - gold


def cross_entropy_loss(logits, labels, *, mask=None):
    """Mean CE. logits: (..., C); labels: (...) int."""
    nll = cross_entropy_rows(logits, labels)
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def kd_kl_loss(student_logits, teacher_logits, temperature: float = 2.0, *,
               mask=None):
    """KL(teacher_T || student_T) * T^2 (Hinton scaling)."""
    t = temperature
    log_p_s = torch.log_softmax(student_logits.float() / t, -1)
    log_p_t = torch.log_softmax(teacher_logits.float() / t, -1)
    kl = (log_p_t.exp() * (log_p_t - log_p_s)).sum(-1)
    if mask is not None:
        kl = (kl * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    else:
        kl = kl.mean()
    return kl * (t * t)


def distillation_loss(student_logits, teacher_logits, labels, *,
                      alpha: float = 0.5, temperature: float = 2.0,
                      mask=None):
    """alpha * CE(student, labels) + (1-alpha) * T^2 KL(teacher || student).

    The MDD integration objective (paper §IV): the requester blends
    supervised signal from its own data with the discovered model's
    knowledge.
    """
    ce = cross_entropy_loss(student_logits, labels, mask=mask)
    kd = kd_kl_loss(student_logits, teacher_logits, temperature, mask=mask)
    return alpha * ce + (1.0 - alpha) * kd, {"ce": ce, "kd": kd}


class _FusedDistillation(torch.autograd.Function):
    """Forward through the per-row kernel; analytic backward in PyTorch."""

    @staticmethod
    def forward(ctx, student_logits, teacher_logits, labels, alpha,
                temperature):
        *lead, n, v = student_logits.shape
        rows = ops.kd_loss(student_logits.reshape(-1, v),
                           teacher_logits.reshape(-1, v), labels.reshape(-1),
                           alpha=alpha, temperature=temperature)
        ctx.save_for_backward(student_logits, teacher_logits, labels)
        ctx.alpha, ctx.temperature = alpha, temperature
        return rows.reshape(*lead, n).mean(-1)

    @staticmethod
    def backward(ctx, g):
        student_logits, teacher_logits, labels = ctx.saved_tensors
        alpha, temperature = ctx.alpha, ctx.temperature
        sl = student_logits.float()
        tl = teacher_logits.float()
        n, v = sl.shape[-2:]
        p1 = torch.softmax(sl, -1)
        onehot = torch.nn.functional.one_hot(labels.long(), v).float()
        p_t = torch.softmax(sl / temperature, -1)
        q_t = torch.softmax(tl / temperature, -1)
        # each group's mean is over its own n rows: scale by g/n per group
        ds = (alpha * (p1 - onehot)
              + (1.0 - alpha) * temperature * (p_t - q_t)) \
            * (g / n)[..., None, None]
        # the teacher is a constant (standard KD): zero cotangent; the
        # labels are integers and get none
        dt = (torch.zeros_like(teacher_logits)
              if ctx.needs_input_grad[1] else None)
        return ds.to(student_logits.dtype), dt, None, None, None


def fused_distillation_loss(student_logits, teacher_logits, labels,
                            alpha=0.5, temperature=2.0):
    """Mean distillation loss through the fused per-row kernel path.

    student/teacher: (..., n, V); labels: (..., n) int32.  Returns the
    mean over the n rows of each leading index, shape (...): a scalar for
    one party's (n, V) batch, one loss per party for a stacked cohort.
    All rows go through ONE kernel launch; the backward is the analytic
    gradient w.r.t. the student logits

        d/ds = [alpha (p1 - onehot) + (1-alpha) T (p_T - q_T)] * g / n

    (the reference's ``_fused_bwd``), so the gradient of a sum of
    per-party means steps each party exactly as its own mean would.
    """
    return _FusedDistillation.apply(student_logits, teacher_logits, labels,
                                    float(alpha), float(temperature))
