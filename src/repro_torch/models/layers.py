"""Shared layer primitives: norms, embeddings, MLP variants, RoPE.

The port of ``repro.models.layers`` for the decoder families.  Parameter
names and layouts are the reference's: weights are ``(in, out)`` and are
applied as ``x @ w`` (the einsum ``...d,df->...f``), not ``nn.Linear``'s
``(out, in)``, so parameter trees interchange leaf for leaf.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common.types import (
    AXIS_EMBED,
    AXIS_FF,
    AXIS_VOCAB,
    ParamSpec,
)

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_spec(dim: int):
    return {"scale": ParamSpec((dim,), (AXIS_EMBED,), init="ones")}


def rmsnorm(params, x, eps: float = 1e-6):
    """RMS norm computed in float32, cast back to ``x``'s dtype."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dtype)


def silu(x):
    """``x * sigmoid(x)`` with ``sigmoid(x) = 1 / (1 + exp(-x))``, one op
    at a time in ``x``'s dtype: ``jax.nn.silu``'s order, so a bfloat16
    model rounds where the reference rounds (``F.silu`` rounds once and
    flips about a third of bf16 results by an ulp)."""
    return x * torch.reciprocal(1 + torch.exp(-x))


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embedding_spec(vocab: int, dim: int):
    return {"table": ParamSpec((vocab, dim), (AXIS_VOCAB, AXIS_EMBED), init="small")}


def embed(params, tokens):
    return params["table"][tokens.long()]


def unembed(params, x):
    # tied output head: logits = x @ table.T
    return x @ params["table"].T


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------


def mlp_spec(cfg_mlp_type: str, d_model: int, d_ff: int):
    if cfg_mlp_type == "swiglu":
        return {
            "wi_gate": ParamSpec((d_model, d_ff), (AXIS_EMBED, AXIS_FF)),
            "wi_up": ParamSpec((d_model, d_ff), (AXIS_EMBED, AXIS_FF)),
            "wo": ParamSpec((d_ff, d_model), (AXIS_FF, AXIS_EMBED)),
        }
    if cfg_mlp_type in ("squared_relu", "gelu"):
        return {
            "wi": ParamSpec((d_model, d_ff), (AXIS_EMBED, AXIS_FF)),
            "wo": ParamSpec((d_ff, d_model), (AXIS_FF, AXIS_EMBED)),
        }
    raise ValueError(f"unknown mlp type {cfg_mlp_type}")


def mlp_apply(mlp_type: str, params, x):
    if mlp_type == "swiglu":
        h = F.silu(x @ params["wi_gate"]) * (x @ params["wi_up"])
    elif mlp_type == "squared_relu":
        h = torch.relu(x @ params["wi"]).square()
    elif mlp_type == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ params["wi"], approximate="tanh")
    else:
        raise ValueError(mlp_type)
    return h @ params["wo"]


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim); positions: (..., seq).

    Half-split layout: the first and second halves of head_dim are the
    two rotated components (not interleaved pairs)."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, x.device)  # (hd/2,)
    angles = positions[..., :, None].float() * freqs  # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]  # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
