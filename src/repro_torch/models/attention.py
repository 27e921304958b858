"""Grouped-query attention with full / sliding-window causal masking and a
KV cache for decode (the port of ``repro.models.attention``).

Layouts, as in the reference:
  activations  (B, S, D)
  q            (B, S, H, hd)
  k, v         (B, S, KV, hd)
  cache.k/v    (B, T, KV, hd)   T = seq_len (full) or window (sliding)
  cache.pos    (B, T) int32     absolute position per slot, -1 = empty

Prefill attention (:func:`attend_full`) goes through
:func:`repro_torch.kernels.ops.flash_attention`: the CUDA kernel on the
card, its plain version on the host.  Decode keeps the reference's dense
scores over the cache in plain PyTorch.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.common.types import AXIS_EMBED, AXIS_HEADS, AXIS_KV, ParamSpec
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope

NEG_INF = -1e30


def attention_spec(cfg: ModelConfig):
    hd = cfg.resolved_head_dim
    spec = {
        "wq": ParamSpec((cfg.d_model, cfg.num_heads * hd), (AXIS_EMBED, AXIS_HEADS)),
        "wk": ParamSpec((cfg.d_model, cfg.num_kv_heads * hd), (AXIS_EMBED, AXIS_KV)),
        "wv": ParamSpec((cfg.d_model, cfg.num_kv_heads * hd), (AXIS_EMBED, AXIS_KV)),
        "wo": ParamSpec((cfg.num_heads * hd, cfg.d_model), (AXIS_HEADS, AXIS_EMBED)),
    }
    if cfg.qkv_bias:
        spec["bq"] = ParamSpec((cfg.num_heads * hd,), (AXIS_HEADS,), init="zeros")
        spec["bk"] = ParamSpec((cfg.num_kv_heads * hd,), (AXIS_KV,), init="zeros")
        spec["bv"] = ParamSpec((cfg.num_kv_heads * hd,), (AXIS_KV,), init="zeros")
    return spec


def _project_qkv(params, cfg: ModelConfig, x):
    hd = cfg.resolved_head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.reshape(*q.shape[:-1], cfg.num_heads, hd)
    k = k.reshape(*k.shape[:-1], cfg.num_kv_heads, hd)
    v = v.reshape(*v.shape[:-1], cfg.num_kv_heads, hd)
    return q, k, v


def _gqa_scores(q, k):
    """q: (B,S,H,hd), k: (B,T,KV,hd) -> scores (B,KV,G,S,T) in q's dtype,
    divided by sqrt(hd) rounded to that dtype, as the reference does."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    root = float(torch.tensor(math.sqrt(hd), dtype=torch.float32).to(q.dtype))
    return torch.einsum("bskgd,btkd->bkgst", qg, k) / root


def _gqa_out(weights, v, out_dtype):
    """weights: (B,KV,G,S,T), v: (B,T,KV,hd) -> (B,S,H*hd)."""
    B, KV, G, S, T = weights.shape
    hd = v.shape[-1]
    o = torch.einsum("bkgst,btkd->bskgd", weights, v)
    return o.reshape(B, S, KV * G * hd).to(out_dtype)


def attend_full(
    params,
    cfg: ModelConfig,
    x,
    positions,
    *,
    causal: bool = True,
    window: Optional[int] = None,
):
    """Self-attention over a contiguous sequence (prefill).

    ``positions`` rope q and k and must be ``arange(S)`` in every row, the
    positions the attention kernel masks by (``decoder_forward`` passes
    exactly that).  Returns ``(out (B,S,D), (k, v))`` with k roped.
    """
    q, k, v = _project_qkv(params, cfg, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    B, S, H, hd = q.shape
    out = ops.flash_attention(
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(), causal=causal, window=window)
    out = out.transpose(1, 2).reshape(B, S, H * hd)
    return out @ params["wo"], (k, v)


# ---------------------------------------------------------------------------
# KV cache (decode)
# ---------------------------------------------------------------------------


def _cache_len(cfg: ModelConfig, seq_len: int) -> int:
    return seq_len if cfg.sliding_window is None else min(cfg.sliding_window, seq_len)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype, device=None):
    """Cache for one attention layer. T = window size when sliding."""
    T = _cache_len(cfg, seq_len)
    hd = cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, T, cfg.num_kv_heads, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, T, cfg.num_kv_heads, hd), dtype=dtype, device=device),
        "pos": torch.full((batch, T), -1, dtype=torch.int32, device=device),
    }


def decode_step(params, cfg: ModelConfig, cache, x, pos: int):
    """One-token decode. x: (B,1,D); pos: the absolute position (an int).

    Returns ``(out (B,1,D), cache)``.  Unlike the reference, which returns
    a new cache, the cache's tensors are written in place (one slot per
    step), so a decode loop holds one cache, not two.
    """
    q, k, v = _project_qkv(params, cfg, x)
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    T = cache["k"].shape[1]
    slot = pos if cfg.sliding_window is None else pos % T
    if not 0 <= slot < T:
        raise ValueError(f"decode position {pos} does not fit the {T}-slot cache")
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    cache["pos"][:, slot] = pos
    cpos = cache["pos"]

    scores = _gqa_scores(q, cache["k"])  # (B,KV,G,1,T)
    valid = (cpos >= 0) & (cpos <= pos)
    if cfg.sliding_window is not None:
        valid = valid & (pos - cpos < cfg.sliding_window)
    scores = scores.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    weights = torch.softmax(scores.float(), dim=-1).to(x.dtype)
    out = _gqa_out(weights, cache["v"], x.dtype)
    return out @ params["wo"], cache


def fill_cache_from_prefill(cfg: ModelConfig, kv, positions, seq_len: int):
    """Build a decode cache from prefill K/V (already roped).

    kv: (k, v) each (B,S,KV,hd); keeps the trailing ``window`` slots when
    sliding-window attention is active.
    """
    k, v = kv
    S = k.shape[1]
    T = _cache_len(cfg, seq_len)
    if S >= T:
        k_t, v_t = k[:, S - T:], v[:, S - T:]
        pos_t = positions[:, S - T:]
    else:
        pad = T - S
        k_t = F.pad(k, (0, 0, 0, 0, 0, pad))
        v_t = F.pad(v, (0, 0, 0, 0, 0, pad))
        pos_t = F.pad(positions, (0, pad), value=-1)
    return {"k": k_t, "v": v_t, "pos": pos_t.to(torch.int32)}
