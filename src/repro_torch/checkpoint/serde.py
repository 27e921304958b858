"""Parameter (de)serialization: the vault's wire format, without JAX.

Byte-for-byte the same archives as ``repro.checkpoint.serde``:

* **Plain layout** — a non-empty nested dict of string keys (no ``/``)
  whose leaves are arrays of builtin numpy dtypes is stored as an npz
  keyed by '/'-joined paths, in *sorted key order* at every level (the
  order ``jax.tree_util.tree_flatten_with_path`` yields).  This is the
  form models travel in between vaults and learners, and
  :mod:`repro_torch.core.vault` and the continuum's verify memo hash
  these bytes, so they are load-bearing.
* **Structured layout** — anything else (lists, tuples, ``None``, empty
  dicts, keys containing ``/``, bare leaves, extension dtypes such as
  bfloat16) stores ``leaf<i>`` entries plus a ``__pytree__`` JSON treedef.

Leaves may be numpy arrays, numpy/python scalars or torch tensors on any
device; a tensor is copied to the host first.  A ``torch.bfloat16``
tensor is written exactly as an ``ml_dtypes.bfloat16`` array of the same
bits would be (raw bytes plus dtype name and shape).
"""
from __future__ import annotations

import io
import json
from typing import Any

import numpy as np
import torch

# Reserved npz entry holding the JSON treedef of a structured archive.
_SPEC_KEY = "__pytree__"

# torch dtypes numpy has no builtin twin for: written through the raw-bytes
# spec under the ml_dtypes name the reference records
_TORCH_EXT_DTYPES = {torch.bfloat16: "bfloat16"}


def _is_ext_tensor(node) -> bool:
    return isinstance(node, torch.Tensor) and node.dtype in _TORCH_EXT_DTYPES


def _as_numpy(node) -> np.ndarray:
    if isinstance(node, torch.Tensor):
        return node.detach().cpu().numpy()
    return np.asarray(node)


def _flatten(tree) -> dict:
    """'/'-joined path -> array, dict keys visited in sorted order."""
    flat = {}

    def walk(node, prefix):
        for k in sorted(node):
            key = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(node[k], dict):
                walk(node[k], key)
            else:
                flat[key] = _as_numpy(node[k])

    walk(tree, "")
    return flat


def _unflatten(flat: dict) -> Any:
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def _is_plain(tree) -> bool:
    """Whether ``tree`` round-trips exactly under the legacy path layout."""
    if not isinstance(tree, dict) or not tree:
        return False
    if _SPEC_KEY in tree:
        return False

    def ok(node) -> bool:
        if isinstance(node, dict):
            if not node:
                return False
            return all(
                isinstance(k, str) and "/" not in k and ok(v)
                for k, v in node.items()
            )
        if isinstance(node, (list, tuple)) or node is None:
            return False
        if _is_ext_tensor(node):
            return False
        arr = _as_numpy(node)
        return arr.dtype.isbuiltin == 1 and arr.dtype != object

    return ok(tree)


def _resolve_dtype(name: str) -> np.dtype:
    """Look up a dtype by name, falling back to ml_dtypes extensions."""
    try:
        return np.dtype(name)
    except TypeError:
        pass
    try:
        import ml_dtypes

        return np.dtype(getattr(ml_dtypes, name))
    except (ImportError, AttributeError) as exc:
        raise TypeError(f"cannot resolve archived dtype {name!r}") from exc


def _build_spec(node, leaves: list) -> dict:
    """Recursively describe ``node``, appending its leaves to ``leaves``."""
    if isinstance(node, dict):
        keys = list(node.keys())
        if not all(isinstance(k, str) for k in keys):
            raise TypeError("serde supports string dict keys only")
        return {
            "t": "dict",
            "k": keys,
            "c": [_build_spec(node[k], leaves) for k in keys],
        }
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return {"t": kind, "c": [_build_spec(v, leaves) for v in node]}
    if node is None:
        return {"t": "none"}
    idx = len(leaves)
    spec: dict = {"t": "leaf", "i": idx}
    if _is_ext_tensor(node):
        t = node.detach().cpu().contiguous()
        spec["d"] = _TORCH_EXT_DTYPES[t.dtype]
        spec["s"] = list(t.shape)
        raw = t.view(torch.int16).numpy().tobytes()
        leaves.append(np.frombuffer(raw, dtype=np.uint8))
        return spec
    arr = _as_numpy(node)
    if arr.dtype == object:
        raise TypeError(f"cannot serialize object-dtype leaf: {node!r}")
    if arr.dtype.isbuiltin != 1:
        # extension dtypes (ml_dtypes bfloat16) do not survive npz natively:
        # raw bytes plus dtype + shape; sized string dtypes record ``.str``
        dt = arr.dtype
        spec["d"] = dt.str if dt.kind in "SU" else dt.name
        spec["s"] = list(arr.shape)
        arr = np.frombuffer(arr.tobytes(), dtype=np.uint8)
    leaves.append(arr)
    return spec


def _apply_spec(spec: dict, leaves: dict):
    kind = spec["t"]
    if kind == "dict":
        return {
            k: _apply_spec(c, leaves)
            for k, c in zip(spec["k"], spec["c"])
        }
    if kind in ("list", "tuple"):
        seq = [_apply_spec(c, leaves) for c in spec["c"]]
        return seq if kind == "list" else tuple(seq)
    if kind == "none":
        return None
    arr = leaves[f"leaf{spec['i']}"]
    if "d" in spec:
        dtype = _resolve_dtype(spec["d"])
        arr = np.frombuffer(arr.tobytes(), dtype=dtype).reshape(spec["s"])
    return arr


def params_to_bytes(params) -> bytes:
    """Serialize a tree of arrays/tensors into a self-describing npz archive."""
    buf = io.BytesIO()
    if _is_plain(params):
        np.savez(buf, **_flatten(params))
        return buf.getvalue()
    leaves: list = []
    spec = _build_spec(params, leaves)
    entries = {f"leaf{i}": arr for i, arr in enumerate(leaves)}
    entries[_SPEC_KEY] = np.frombuffer(
        json.dumps(spec, sort_keys=True).encode("utf-8"), dtype=np.uint8
    )
    np.savez(buf, **entries)
    return buf.getvalue()


def params_from_bytes(data: bytes):
    """Restore a tree of numpy arrays serialized by :func:`params_to_bytes`."""
    with np.load(io.BytesIO(data)) as npz:
        flat = {k: npz[k] for k in npz.files}
    if _SPEC_KEY in flat:
        spec = json.loads(flat.pop(_SPEC_KEY).tobytes().decode("utf-8"))
        return _apply_spec(spec, flat)
    return _unflatten(flat)
