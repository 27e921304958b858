"""Declarative parameter specification (the port of ``repro.common.types``).

Models declare their parameters as nested dicts of :class:`ParamSpec`
(shape + logical axes + initializer); :func:`init_params` materialises a
spec tree and :func:`stack_specs` prepends a ``layers`` axis, so a stacked
tree keeps the reference's layout leaf for leaf.

The initialisers draw from the reference's distributions (lecun, normal,
embed, small, zeros, ones), not its values: ``jax.random`` cannot be
reproduced in PyTorch, so a comparison carries the reference's weights
across with :mod:`repro_torch.convert`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

# Logical axis vocabulary (kept for parity with the reference's specs).
AXIS_VOCAB = "vocab"
AXIS_EMBED = "embed"
AXIS_FF = "ff"
AXIS_HEADS = "heads"
AXIS_KV = "kv_heads"
AXIS_EXPERTS = "experts"
AXIS_MOE_FF = "moe_ff"
AXIS_INNER = "inner"
AXIS_STATE = "state"
AXIS_LAYERS = "layers"
AXIS_CONV = "conv"


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declarative description of one parameter tensor."""

    shape: tuple
    axes: tuple  # one logical-axis name (or None) per dim; len == len(shape)
    init: str = "lecun"  # lecun | normal | zeros | ones | embed | small
    scale: float = 1.0
    dtype: Any = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(
                f"ParamSpec shape {self.shape} and axes {self.axes} rank mismatch"
            )


def _std(spec: ParamSpec) -> float:
    shape = spec.shape
    if spec.init in ("normal", "embed"):
        return spec.scale
    if spec.init == "small":
        return 0.02 * spec.scale
    if spec.init == "lecun":
        fan_in = shape[-2] if len(shape) >= 2 else max(shape[-1], 1)
        return spec.scale / math.sqrt(fan_in)
    raise ValueError(f"unknown init {spec.init!r}")


def _materialize(spec: ParamSpec, generator: torch.Generator, dtype):
    """One tensor, drawn straight in ``dtype`` on the generator's device
    (no float32 staging copy of a bf16 model)."""
    kw = {"dtype": dtype, "device": generator.device}
    if spec.init == "zeros":
        return torch.zeros(spec.shape, **kw)
    if spec.init == "ones":
        return torch.ones(spec.shape, **kw)
    std = _std(spec)
    return torch.randn(spec.shape, generator=generator, **kw).mul_(std)


def _leaves(tree, prefix=()):
    """(path, spec) pairs in sorted-key order, as ``jax.tree_util`` visits."""
    if isinstance(tree, ParamSpec):
        yield prefix, tree
        return
    for key in sorted(tree):
        yield from _leaves(tree[key], prefix + (key,))


def _map(tree, fn):
    if isinstance(tree, ParamSpec):
        return fn(tree)
    return {k: _map(v, fn) for k, v in tree.items()}


def init_params(spec_tree, generator: torch.Generator, dtype=None):
    """Materialise a spec tree on ``generator.device``; floating leaves are
    drawn in ``dtype`` when it is given, else in each spec's own dtype."""
    out: dict = {}
    for path, spec in _leaves(spec_tree):
        dt = spec.dtype
        if dtype is not None and dt.is_floating_point:
            dt = dtype
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _materialize(spec, generator, dt)
    return out


def stack_specs(spec_tree, n: int):
    """Prepend a stacked ``layers`` dim to every spec."""

    def stack(spec: ParamSpec):
        return ParamSpec(
            shape=(n,) + tuple(spec.shape),
            axes=(AXIS_LAYERS,) + tuple(spec.axes),
            init=spec.init,
            scale=spec.scale,
            dtype=spec.dtype,
        )

    return _map(spec_tree, stack)
