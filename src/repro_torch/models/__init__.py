"""Models of the port: the small per-party models over a leading party axis
(:mod:`.small`) and the LLM zoo's dense and hybrid decoders (:mod:`.zoo`)."""
from repro_torch.models.config import (
    INPUT_SHAPES,
    ModelConfig,
    ShapeConfig,
)
from repro_torch.models.zoo import build_model

__all__ = ["ModelConfig", "ShapeConfig", "INPUT_SHAPES", "build_model"]
