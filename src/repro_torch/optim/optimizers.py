"""Optimizers as pairs of pure functions over flat dicts of tensors.

  init(params, batch_shape=())    -> state
  update(grads, state, params)    -> (updates, state)

Updates are ADDED to params by ``apply_updates``.  ``batch_shape`` gives
the step counter a leading party axis for stacked cohorts, the layout of
the reference's vmapped optimizer state.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def apply_updates(params, updates):
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}


def sgd(lr, momentum: float = 0.0):
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params, batch_shape=()):
        device = next(iter(params.values())).device
        mom = ({k: torch.zeros_like(p) for k, p in params.items()}
               if momentum else ())
        return {"step": torch.zeros(batch_shape, dtype=torch.int32,
                                    device=device),
                "mom": mom}

    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        if momentum:
            mom = {k: momentum * m + grads[k] for k, m in state["mom"].items()}
            return ({k: -lr_t * m for k, m in mom.items()},
                    {"step": step, "mom": mom})
        return {k: -lr_t * g for k, g in grads.items()}, \
            {"step": step, "mom": ()}

    return Optimizer(init, update)
