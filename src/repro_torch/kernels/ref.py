"""PyTorch oracles for the kernels (ground truth in tests)."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_mask(S, causal, window, device):
    """(S, S) bool: key ``j`` is visible to query ``i``."""
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (j <= i)
    if window is not None:
        mask = mask & (i - j < window)
    return mask


def flash_attention_ref(q, k, v, *, causal=True, window=None):
    """q: (B,H,S,hd), k/v: (B,KV,S,hd) -> (B,H,S,hd). GQA by head broadcast.

    Dense softmax over the masked scores: a row with no visible key gets
    uniform weights here (the kernels write zeros); with a causal mask and
    ``window >= 1`` every row sees itself, so the two agree.
    """
    B, H, S, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    qg = q.reshape(B, KV, G, S, hd).float()
    scores = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) * (1.0 / math.sqrt(hd))
    mask = attention_mask(S, causal, window, q.device)
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", w, v.float())
    return out.reshape(B, H, S, hd).to(q.dtype)


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


def ssd_scan_ref(x, dt, A, B_, C_):
    """Sequential SSD reference: x (B,S,H,P), dt (B,S,H), A (H,), B_/C_ (B,S,N).

    Returns y (B,S,H,P) and the final state (B,H,P,N), both float32.  One
    step per token in a Python loop: slow, but unambiguous ground truth
    for the chunked plain version and the kernel.
    """
    x, dt, A, B_, C_ = (t.float() for t in (x, dt, A, B_, C_))
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    state = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t] * A[None, :])  # (B,H)
        state = state * decay[:, :, None, None] + torch.einsum(
            "bh,bn,bhp->bhpn", dt[:, t], B_[:, t], x[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", C_[:, t], state))
    return torch.stack(ys, dim=1), state
