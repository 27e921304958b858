"""PyTorch oracles for the kernels (ground truth in tests)."""
from __future__ import annotations

import torch


def kd_loss_ref(student_logits, teacher_logits, labels, *, alpha=0.5,
                temperature=2.0):
    """Per-row fused distillation loss (no mean reduction).

    student/teacher: (N, V); labels: (N,) int.  Returns (N,) f32 losses:
      alpha * CE(student, label) + (1-alpha) * T^2 * KL(teacher_T || student_T)
    """
    sl = student_logits.float()
    tl = teacher_logits.float()
    t = temperature
    # CE at T=1
    logz_s1 = torch.logsumexp(sl, -1)
    gold = sl.gather(-1, labels.long()[:, None])[:, 0]
    ce = logz_s1 - gold
    # KL at temperature T
    log_ps = torch.log_softmax(sl / t, -1)
    log_pt = torch.log_softmax(tl / t, -1)
    kl = (log_pt.exp() * (log_pt - log_ps)).sum(-1)
    return alpha * ce + (1 - alpha) * (t * t) * kl
