"""Decoder-only model assembly, dense and hybrid families (the port of
``repro.models.transformer``): stacked per-layer params, KV-cache prefill
and single-token decode.

The stack is grouped into ``n_super`` super-blocks, as in the reference:

  dense          : 1 attention+MLP block per super-block (n_super = num_layers)
  hybrid (zamba2): ``attn_every`` Mamba2 blocks + one application of a
                   SHARED attention+MLP block (weights reused across
                   super-blocks, a separate KV cache per application)

The params keep the reference's layout, a leading super-block axis on
every leaf of ``blocks`` (and a second, ``attn_every``, axis on the
hybrid's Mamba2 stack), so a reference tree converts as is; the layers
run as a Python loop over those axes (the reference scans).  The other
families of the reference raise ``NotImplementedError`` naming their
ROADMAP item.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.common.types import init_params, stack_specs
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_lib
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
    if cfg.family not in ("dense", "hybrid") or cfg.is_moe:
        family = "moe" if cfg.is_moe else cfg.family
        item = _NOT_PORTED.get(family, "A8")
        raise NotImplementedError(
            f"the {family!r} family of {cfg.name} is not ported yet "
            f"(ROADMAP {item}); the port runs the dense and hybrid families")


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


def _super_block_spec(cfg: ModelConfig):
    if cfg.family == "hybrid":
        return {
            "mamba": stack_specs(
                {"ln": rmsnorm_spec(cfg.d_model),
                 "mixer": ssm_lib.mamba2_spec(cfg)},
                cfg.attn_every,
            )
        }
    return _attn_block_spec(cfg)


def _n_super(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid":
        if cfg.attn_every < 1 or cfg.num_layers % cfg.attn_every:
            raise ValueError(f"{cfg.name}: {cfg.num_layers} layers do not "
                             f"split into super-blocks of {cfg.attn_every}")
        return cfg.num_layers // cfg.attn_every
    return cfg.num_layers


def decoder_param_specs(cfg: ModelConfig):
    check_family(cfg)
    specs = {
        "embed": embedding_spec(cfg.vocab_size, cfg.d_model),
        "final_norm": rmsnorm_spec(cfg.d_model),
        "blocks": stack_specs(_super_block_spec(cfg), _n_super(cfg)),
    }
    if cfg.family == "hybrid":
        # the shared block is dense attention + MLP
        specs["shared_attn"] = _attn_block_spec(cfg.replace(num_experts=0))
    return specs


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


def _super_apply(cfg: ModelConfig, shared, p, x, positions, *, window,
                 collect: bool):
    """One super-block over the full sequence: ``(x, kv, ssm)`` with
    ``ssm`` the Mamba2 layers' cache entries (hybrid, when collecting)."""
    states = []
    if cfg.family == "hybrid":
        for m in range(cfg.attn_every):
            mp = _layer(p["mamba"], m)
            h, st = ssm_lib.mamba2_apply(mp["mixer"], cfg,
                                         rmsnorm(mp["ln"], x))
            x = x + h
            if collect:
                states.append(st)
        p = shared
    x, kv = _attn_block_apply(p, cfg, x, positions, window=window)
    return x, kv, states


def decoder_forward(params, cfg: ModelConfig, batch, *, collect_cache=False,
                    last_logit_only=False):
    """Full-sequence forward. Returns (logits, aux) or (logits, aux,
    (entries, positions)) with ``entries`` one ``(kv, ssm)`` per
    super-block: the roped (k, v) pair and, for the hybrid, its Mamba2
    layers' ``{"state", "conv"}`` entries."""
    tokens = batch["tokens"]
    x = embed(params["embed"], tokens).to(_dtype(cfg))
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    shared = params.get("shared_attn")
    entries = []
    for i in range(_n_super(cfg)):
        x, kv, states = _super_apply(cfg, shared, _layer(params["blocks"], i),
                                     x, positions, window=cfg.sliding_window,
                                     collect=collect_cache)
        if collect_cache:
            entries.append((kv, states))
    if last_logit_only:
        x = x[:, -1:]
    x = rmsnorm(params["final_norm"], x)
    logits = unembed(params["embed"], x)
    aux = _zero_losses(x.device)
    if collect_cache:
        return logits, aux, (entries, positions)
    return logits, aux


# ---------------------------------------------------------------------------
# Cache init / prefill / decode
# ---------------------------------------------------------------------------


def decoder_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype, device=None):
    """An empty decode cache: every leaf stacked over the super-blocks (and
    the hybrid's Mamba2 states also over ``attn_every``)."""
    n = _n_super(cfg)
    per = attn.init_cache(cfg, batch, seq_len, dtype, device)
    blocks = {"kv": {k: t.expand(n, *t.shape).clone() for k, t in per.items()}}
    if cfg.family == "hybrid":
        m = ssm_lib.mamba2_cache_init(cfg, batch, dtype, device)
        blocks["ssm"] = {k: t.expand(n, cfg.attn_every, *t.shape).clone()
                         for k, t in m.items()}
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
    logits, aux, (entries, positions) = decoder_forward(
        params, cfg, batch, collect_cache=True, last_logit_only=True)
    per_block = [attn.fill_cache_from_prefill(cfg, kv, positions, cache_len)
                 for kv, _ in entries]
    blocks = {"kv": {name: torch.stack([c[name] for c in per_block])
                     for name in ("k", "v", "pos")}}
    if cfg.family == "hybrid":
        blocks["ssm"] = {
            name: torch.stack([torch.stack([st[name] for st in states])
                               for _, states in entries])
            for name in ("conv", "state")}
    return logits, aux, {"blocks": blocks, "pos": S}


def decoder_decode(params, cfg: ModelConfig, cache, batch):
    """One-token decode. batch: {"token": (B,1)}. Returns (logits, cache);
    the cache's tensors are updated in place and its ``pos`` advanced.
    Each application of the hybrid's shared block reads and writes its
    own super-block's KV cache."""
    x = embed(params["embed"], batch["token"]).to(_dtype(cfg))
    pos = cache["pos"]
    shared = params.get("shared_attn")
    for i in range(_n_super(cfg)):
        p = _layer(params["blocks"], i)
        c = _layer(cache["blocks"], i)
        if cfg.family == "hybrid":
            for m in range(cfg.attn_every):
                mp = _layer(p["mamba"], m)
                h, _ = ssm_lib.mamba2_step(mp["mixer"], cfg, _layer(c["ssm"], m),
                                           rmsnorm(mp["ln"], x))
                x = x + h
            p = shared
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
