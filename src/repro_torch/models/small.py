"""Small models for the exchange cycle, over a leading party axis.

  LR   — logistic regression on feature vectors
  MLP  — one-hidden-layer classifier on the same feature space as LR
         (the cross-architecture exchange partner)

Parameters keep the reference's names and layouts (``w`` is (F, C),
``b`` is (C,); ``w1``/``b1``/``w2``/``b2``) so blobs interchange with
``repro.models.small``; the product is ``bf,fc->bc``.  Every leaf carries
a leading party axis k, and ``apply(params, x)`` takes x as (k, B, F)
(per-party batches) or (B, F) (one batch shared by every party) and
returns (k, B, C) logits.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch


class SmallModel(NamedTuple):
    name: str
    param_shapes: Callable[[], dict]  # name -> (shape, init)
    apply: Callable  # (params, x) -> logits
    num_classes: int

    def init(self, num_parties: int, generator: torch.Generator,
             device=None) -> dict:
        """Stacked params for ``num_parties`` parties: lecun-normal
        weights (std 1/sqrt(fan_in)), zero biases, drawn on the host from
        ``generator`` so every device starts from the same values."""
        params = {}
        for name, (shape, init) in self.param_shapes().items():
            full = (num_parties, *shape)
            if init == "zeros":
                value = torch.zeros(full)
            else:
                std = 1.0 / math.sqrt(shape[-2] if len(shape) >= 2
                                      else max(shape[-1], 1))
                value = std * torch.randn(full, generator=generator)
            params[name] = value.to(device)
        return params


def _bias(b):
    return b.unsqueeze(-2)  # (k, C) -> (k, 1, C), broadcast over the batch


def make_lr(num_features: int = 60, num_classes: int = 10) -> SmallModel:
    def shapes():
        return {"w": ((num_features, num_classes), "lecun"),
                "b": ((num_classes,), "zeros")}

    def apply(params, x):
        return torch.matmul(x, params["w"]) + _bias(params["b"])

    return SmallModel("lr", shapes, apply, num_classes)


def make_mlp(num_features: int = 60, num_classes: int = 10,
             hidden: int = 32) -> SmallModel:
    def shapes():
        return {"w1": ((num_features, hidden), "lecun"),
                "b1": ((hidden,), "zeros"),
                "w2": ((hidden, num_classes), "lecun"),
                "b2": ((num_classes,), "zeros")}

    def apply(params, x):
        h = torch.relu(torch.matmul(x, params["w1"]) + _bias(params["b1"]))
        return torch.matmul(h, params["w2"]) + _bias(params["b2"])

    return SmallModel("mlp", shapes, apply, num_classes)
