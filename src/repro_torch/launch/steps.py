"""Step functions for serving (the port of ``repro.launch.steps``'s
prefill and decode steps).  The train and distill steps, and the
reference's sharding-annotated abstract inputs, wait for a later slice
(ROADMAP A8f, A9).
"""
from __future__ import annotations

import torch

from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig, cache_len=None):
    """(params, batch) -> (last-token logits, cache).

    ``cache_len`` sizes the decode KV cache; pass prompt length + decode
    budget so generation never outgrows the cache (default: 2x prompt).
    """
    model = build_model(cfg)

    def prefill_step(params, batch):
        logits, _aux, cache = model.prefill(params, batch, cache_len=cache_len)
        return logits, cache

    return prefill_step, model


def make_serve_step(cfg: ModelConfig):
    """(params, cache, token) -> (next_token, logits, cache): one decode step."""
    model = build_model(cfg)

    def serve_step(params, cache, batch):
        logits, new_cache = model.decode(params, cache, batch)
        next_token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_token, logits, new_cache

    return serve_step, model
