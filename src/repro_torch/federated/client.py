"""Client-side local training: the SGD step on a stacked cohort."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.losses import cross_entropy_rows
from repro_torch.optim import apply_updates, sgd


class LocalTrainer:
    """SGD local trainer for a SmallModel-style apply fn.

    :meth:`step` updates every party of a stacked cohort at once: params
    carry a leading party axis k, the batch is (k, B, F) inputs and (k, B)
    labels, and each party descends its own mean cross-entropy.
    """

    def __init__(self, apply_fn: Callable, lr: float = 0.05,
                 momentum: float = 0.0):
        self.apply_fn = apply_fn
        self.opt = sgd(lr, momentum=momentum)

    def step(self, params, opt_state, x, y):
        """One SGD step per party; returns (params, opt_state, loss (k,))."""
        with torch.enable_grad():
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in params.items()}
            per_party = cross_entropy_rows(self.apply_fn(leaves, x), y).mean(-1)
            # parties share no parameters: the gradient of the sum is each
            # party's gradient of its own mean
            grads = torch.autograd.grad(per_party.sum(), list(leaves.values()))
        updates, opt_state = self.opt.update(dict(zip(leaves, grads)),
                                             opt_state, params)
        return apply_updates(params, updates), opt_state, per_party.detach()
