"""Decoder-only model assembly, dense family (the port of
``repro.models.transformer``): stacked per-layer params, KV-cache prefill
and single-token decode.

The params keep the reference's layout, a leading layer axis on every
leaf of ``blocks``, so a reference tree converts as is; the layers run as
a Python loop over that axis (the reference scans).  The other families
of the reference raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.common.types import init_params, stack_specs
from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    embed,
    embedding_spec,
    mlp_apply,
    mlp_spec,
    rmsnorm,
    rmsnorm_spec,
    unembed,
)

# the ROADMAP item that ports each family the reference has and this
# module does not
_NOT_PORTED = {
    "hybrid": "A8b (Zamba2-2.7B hybrid serve)",
    "moe": "A8c (MoE family)",
    "ssm": "A8d (xLSTM family)",
    "vlm": "A8e (encoder-decoder and VLM families)",
    "audio": "A8e (encoder-decoder and VLM families)",
}


class Model(NamedTuple):
    cfg: ModelConfig
    param_specs: Callable[[], Any]
    init: Callable[..., Any]
    forward: Callable[..., Any]  # (params, batch) -> (logits, aux)
    prefill: Callable[..., Any]  # (params, batch) -> (logits, aux, cache)
    decode: Callable[..., Any]  # (params, cache, batch) -> (logits, cache)
    init_cache: Callable[..., Any]


def check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.is_moe:
        family = "moe" if cfg.is_moe else cfg.family
        item = _NOT_PORTED.get(family, "A8")
        raise NotImplementedError(
            f"the {family!r} family of {cfg.name} is not ported yet "
            f"(ROADMAP {item}); the port runs the dense family")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


def _attn_block_spec(cfg: ModelConfig):
    return {
        "ln1": rmsnorm_spec(cfg.d_model),
        "attn": attn.attention_spec(cfg),
        "ln2": rmsnorm_spec(cfg.d_model),
        "mlp": mlp_spec(cfg.mlp_type, cfg.d_model, cfg.d_ff),
    }


def decoder_param_specs(cfg: ModelConfig):
    check_family(cfg)
    return {
        "embed": embedding_spec(cfg.vocab_size, cfg.d_model),
        "final_norm": rmsnorm_spec(cfg.d_model),
        "blocks": stack_specs(_attn_block_spec(cfg), cfg.num_layers),
    }


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree: views, so writes reach the stack."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# Full sequence
# ---------------------------------------------------------------------------


def _attn_block_apply(p, cfg: ModelConfig, x, positions, *, window):
    h, kv = attn.attend_full(p["attn"], cfg, rmsnorm(p["ln1"], x), positions,
                             window=window)
    x = x + h
    x = x + mlp_apply(cfg.mlp_type, p["mlp"], rmsnorm(p["ln2"], x))
    return x, kv


def _zero_losses(device):
    return {"moe_aux": torch.zeros((), device=device),
            "moe_z": torch.zeros((), device=device)}


def decoder_forward(params, cfg: ModelConfig, batch, *, collect_cache=False,
                    last_logit_only=False):
    """Full-sequence forward. Returns (logits, aux) or (logits, aux, (kvs,
    positions)) with ``kvs`` one roped (k, v) pair per layer."""
    tokens = batch["tokens"]
    x = embed(params["embed"], tokens).to(_dtype(cfg))
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    kvs = []
    for i in range(cfg.num_layers):
        x, kv = _attn_block_apply(_layer(params["blocks"], i), cfg, x,
                                  positions, window=cfg.sliding_window)
        if collect_cache:
            kvs.append(kv)
    if last_logit_only:
        x = x[:, -1:]
    x = rmsnorm(params["final_norm"], x)
    logits = unembed(params["embed"], x)
    aux = _zero_losses(x.device)
    if collect_cache:
        return logits, aux, (kvs, positions)
    return logits, aux


# ---------------------------------------------------------------------------
# Cache init / prefill / decode
# ---------------------------------------------------------------------------


def decoder_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype, device=None):
    """An empty decode cache: every leaf stacked over the layers."""
    per = attn.init_cache(cfg, batch, seq_len, dtype, device)
    blocks = {"kv": {k: t.expand(cfg.num_layers, *t.shape).clone()
                     for k, t in per.items()}}
    return {"blocks": blocks, "pos": 0}


def decoder_prefill(params, cfg: ModelConfig, batch, cache_len=None):
    """Run the full sequence and return (last-token logits, aux, decode cache).

    ``cache_len`` sizes the decode KV cache (default ``2 * S``) and must
    exceed the prompt length, or the first decode step has no slot.  The
    cache's ``pos`` is a Python int, so decode never waits on the device
    to learn where it writes.
    """
    B, S = batch["tokens"].shape
    cache_len = 2 * S if cache_len is None else int(cache_len)
    if cache_len <= S:
        raise ValueError(f"cache_len {cache_len} leaves no room to decode "
                         f"past the {S}-token prompt")
    logits, aux, (kvs, positions) = decoder_forward(
        params, cfg, batch, collect_cache=True, last_logit_only=True)
    per_layer = [attn.fill_cache_from_prefill(cfg, kv, positions, cache_len)
                 for kv in kvs]
    kv = {name: torch.stack([c[name] for c in per_layer])
          for name in ("k", "v", "pos")}
    return logits, aux, {"blocks": {"kv": kv}, "pos": S}


def decoder_decode(params, cfg: ModelConfig, cache, batch):
    """One-token decode. batch: {"token": (B,1)}. Returns (logits, cache);
    the cache's tensors are updated in place and its ``pos`` advanced."""
    x = embed(params["embed"], batch["token"]).to(_dtype(cfg))
    pos = cache["pos"]
    for i in range(cfg.num_layers):
        p = _layer(params["blocks"], i)
        c = _layer(cache["blocks"], i)
        h, _ = attn.decode_step(p["attn"], cfg, c["kv"], rmsnorm(p["ln1"], x), pos)
        x = x + h
        x = x + mlp_apply(cfg.mlp_type, p["mlp"], rmsnorm(p["ln2"], x))
    x = rmsnorm(params["final_norm"], x)
    logits = unembed(params["embed"], x)
    return logits, {"blocks": cache["blocks"], "pos": pos + 1}


# ---------------------------------------------------------------------------
# Public constructor
# ---------------------------------------------------------------------------


def build_decoder_model(cfg: ModelConfig) -> Model:
    check_family(cfg)
    specs = functools.partial(decoder_param_specs, cfg)

    def init(generator: torch.Generator, dtype=None):
        """Random params on ``generator.device``, in the model dtype."""
        return init_params(specs(), generator, dtype=dtype or _dtype(cfg))

    return Model(
        cfg=cfg,
        param_specs=specs,
        init=init,
        forward=lambda params, batch: decoder_forward(params, cfg, batch),
        prefill=lambda params, batch, cache_len=None: decoder_prefill(
            params, cfg, batch, cache_len
        ),
        decode=lambda params, cache, batch: decoder_decode(params, cfg, cache, batch),
        init_cache=lambda batch, seq_len, dtype=None, device=None: decoder_cache(
            cfg, batch, seq_len, dtype or _dtype(cfg), device
        ),
    )
