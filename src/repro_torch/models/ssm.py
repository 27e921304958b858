"""Mamba2 (SSD) block (the port of ``repro.models.ssm``).

Layouts, as in the reference:
  x_in    (B, S, D)
  x_ssm   (B, S, H, P)   H = ssm_heads, P = ssm_head_dim
  B_, C_  (B, S, N)      N = ssm_state (single group, broadcast over heads)
  dt      (B, S, H)
  state   (B, H, P, N)   float32 in every model dtype

The prefill's scan goes through :func:`repro_torch.kernels.ops.ssd_scan`:
the CUDA kernel on the card, its plain version (the port of
``ssd_chunked``) on the host.  Decode is the reference's one-token
recurrence in plain PyTorch, with the cache written in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common.types import AXIS_EMBED, AXIS_INNER, ParamSpec
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rmsnorm, silu


def mamba2_spec(cfg: ModelConfig):
    d, inner = cfg.d_model, cfg.ssm_inner
    n, h, w = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv_width
    conv_ch = inner + 2 * n
    return {
        "w_z": ParamSpec((d, inner), (AXIS_EMBED, AXIS_INNER)),
        "w_xbc": ParamSpec((d, conv_ch), (AXIS_EMBED, AXIS_INNER)),
        "w_dt": ParamSpec((d, h), (AXIS_EMBED, None)),
        "conv_w": ParamSpec((w, conv_ch), (None, AXIS_INNER), init="lecun"),
        "conv_b": ParamSpec((conv_ch,), (AXIS_INNER,), init="zeros"),
        "A_log": ParamSpec((h,), (None,), init="zeros"),
        "D": ParamSpec((h,), (None,), init="ones"),
        "dt_bias": ParamSpec((h,), (None,), init="zeros"),
        "norm_scale": ParamSpec((inner,), (AXIS_INNER,), init="ones"),
        "out_proj": ParamSpec((inner, d), (AXIS_INNER, AXIS_EMBED)),
    }


def _causal_conv(params, xbc):
    """Depthwise causal conv, width W. xbc: (B,S,C).  The W products are
    summed in the model dtype, in the reference's order."""
    w = params["conv_w"]  # (W, C)
    W = w.shape[0]
    S = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    out = sum(pad[:, i:i + S, :] * w[i][None, None, :] for i in range(W))
    return silu(out + params["conv_b"])


def _split_xbc(cfg: ModelConfig, xbc):
    inner, n = cfg.ssm_inner, cfg.ssm_state
    x = xbc[..., :inner]
    B_ = xbc[..., inner:inner + n]
    C_ = xbc[..., inner + n:]
    return x, B_, C_


def _dt_and_A(params, x_in):
    dt = F.softplus((x_in @ params["w_dt"]).float()
                    + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    return dt, A


def mamba2_apply(params, cfg: ModelConfig, x_in):
    """Full-sequence Mamba2 block.

    x_in: (B,S,D) -> (y (B,S,D), cache {"state", "conv"}); the cache entry
    lets a prefill hand off directly to :func:`mamba2_step` decode.
    """
    z = x_in @ params["w_z"]
    xbc_pre = x_in @ params["w_xbc"]
    w = cfg.ssm_conv_width
    conv_tail = F.pad(xbc_pre, (0, 0, w - 1, 0))[:, -(w - 1):, :]
    xbc = _causal_conv(params, xbc_pre)
    x, B_, C_ = _split_xbc(cfg, xbc)
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    x = x.reshape(*x.shape[:2], H, P).float().contiguous()
    dt, A = _dt_and_A(params, x_in)
    chunk = min(cfg.ssm_chunk, x.shape[1])
    y, state = ops.ssd_scan(x, dt.contiguous(), A, B_.float().contiguous(),
                            C_.float().contiguous(), chunk=chunk)
    y = y + params["D"].float()[None, None, :, None] * x
    # cast to the model dtype before the gate and the norm, as the reference
    y = y.reshape(*y.shape[:2], cfg.ssm_inner).to(x_in.dtype)
    y = rmsnorm({"scale": params["norm_scale"]}, y * silu(z))
    out = y @ params["out_proj"]
    return out, {"state": state, "conv": conv_tail}


# ---------------------------------------------------------------------------
# Decode (single-token recurrent step)
# ---------------------------------------------------------------------------


def mamba2_cache_init(cfg: ModelConfig, batch: int, dtype, device=None):
    conv_ch = cfg.ssm_inner + 2 * cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_ch),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                              cfg.ssm_state), dtype=torch.float32,
                             device=device),
    }


def mamba2_step(params, cfg: ModelConfig, cache, x_in):
    """Single-token step. x_in: (B,1,D) -> ((B,1,D), cache).

    Unlike the reference, which returns a new cache, the conv ring and the
    state are written into ``cache``'s tensors in place.
    """
    z = (x_in @ params["w_z"])[:, 0]
    xbc_t = (x_in @ params["w_xbc"])[:, 0]  # (B,C)
    # causal conv over the ring of the last W-1 inputs + the current one
    window = torch.cat([cache["conv"], xbc_t[:, None, :]], dim=1)  # (B,W,C)
    conv_out = silu(torch.einsum("bwc,wc->bc", window, params["conv_w"])
                      + params["conv_b"])
    cache["conv"].copy_(window[:, 1:])
    x, B_, C_ = _split_xbc(cfg, conv_out)
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    x = x.reshape(-1, H, P).float()
    dt, A = _dt_and_A(params, x_in)
    dt = dt[:, 0]  # (B,H)
    decay = torch.exp(dt * A[None, :])  # (B,H)
    state = cache["state"]
    state.mul_(decay[:, :, None, None]).add_(
        torch.einsum("bh,bn,bhp->bhpn", dt, B_.float(), x))
    y = torch.einsum("bn,bhpn->bhp", C_.float(), state)
    y = y + params["D"].float()[None, :, None] * x
    y = y.reshape(-1, cfg.ssm_inner).to(x_in.dtype)
    y = rmsnorm({"scale": params["norm_scale"]}, y * silu(z))
    out = (y @ params["out_proj"])[:, None, :]
    return out, cache
