"""Carry weights and cohort state from the JAX reference into the port.

The reference initialises with ``jax.random``, which PyTorch cannot
reproduce, so a comparison between the two packages starts both from the
same values: the reference's params (a tree of numpy arrays, per party or
stacked along a party axis) or its ``PartyPopulation.export_state()``
dict, turned here into the port's tensors on a given device.  Only numpy
crosses the boundary; nothing here imports the reference.
"""
from __future__ import annotations

import copy

import numpy as np
import torch


def params_from_reference(tree, device) -> dict:
    """A (nested) dict of numpy arrays -> the same dict of tensors on
    ``device``, copied, dtypes kept (float32 params stay float32).
    Tensors already in the tree are moved to ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(params_from_reference(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return torch.tensor(np.asarray(tree), device=device)


def state_from_reference(snap: dict, device) -> dict:
    """The reference's ``PartyPopulation.export_state()`` -> a snapshot
    the port's ``PartyPopulation.restore_state`` installs, with params and
    opt state as tensors on ``device``."""
    return {
        "params": params_from_reference(snap["params"], device),
        "opt_state": params_from_reference(snap["opt_state"], device),
        "cursor": int(snap["cursor"]),
        "rng_state": copy.deepcopy(snap["rng_state"]),
        "num_parties": int(snap["num_parties"]),
        "party_ids": list(snap["party_ids"]),
    }
