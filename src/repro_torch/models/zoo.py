"""Model zoo dispatcher: ModelConfig -> Model (init/forward/prefill/decode)."""
from __future__ import annotations

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Model, build_decoder_model


def build_model(cfg: ModelConfig) -> Model:
    """The dense and hybrid decoders; every other family raises
    NotImplementedError naming its ROADMAP item."""
    return build_decoder_model(cfg)
