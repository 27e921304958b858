"""The port's serde writes the reference's bytes (the vault wire format)."""
import numpy as np
import pytest
import torch

from repro.checkpoint import serde as ref_serde
from repro_torch.checkpoint import serde

try:
    import ml_dtypes
except ImportError:  # pragma: no cover
    ml_dtypes = None


def _trees():
    """The trees of tests/test_serde.py, plain and structured."""
    trees = {
        "list_tuple": {
            "layers": [{"w": np.ones((2, 3), np.float32)},
                       {"w": np.zeros((3, 4), np.float32)}],
            "opt": ("sgd", np.asarray(0.1, np.float32)),
        },
        "opt_state": {
            "params": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "opt_state": {"step": np.asarray(3, np.int32), "mom": ()},
        },
        "none_empty_scalars": {"none": None, "empty": {},
                               "scalar_f32": np.float32(1.5),
                               "scalar_i32": np.asarray(7, np.int32)},
        "bare_leaf": np.arange(5, dtype=np.float32),
        "top_list": [np.ones(2, np.float32), (np.zeros(3, np.int32), None)],
        "empty_dict": {},
        "slash_keys": {"a/b": np.ones(3, np.float32),
                       "c": {"d/e/f": np.zeros(2)}},
        "reserved_key": {"__pytree__": np.ones(2, np.float32),
                         "x": np.zeros(1)},
        "mixed": {"f32": np.linspace(0, 1, 4, dtype=np.float32),
                  "i32": np.arange(4, dtype=np.int32),
                  "f64": np.linspace(0, 1, 3),
                  "u8": np.arange(3, dtype=np.uint8)},
        "plain_layer": {"layer": {"w": np.ones((2, 3), np.float32),
                                  "b": np.zeros(3, np.float32)}},
        "deterministic": {"a": [np.ones(2, np.float32), None],
                          "b": (np.zeros(1),)},
        # the exchange's wire format: LR / MLP params, keys out of order
        "lr": {"w": np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4),
               "b": np.arange(4, dtype=np.float32)},
        "mlp": {"w2": np.ones((5, 4), np.float32), "b1": np.zeros(5, np.float32),
                "w1": np.full((3, 5), 0.5, np.float32),
                "b2": np.arange(4, dtype=np.float32)},
    }
    if ml_dtypes is not None:
        trees["bf16"] = {"w": np.arange(6, dtype=ml_dtypes.bfloat16)
                         .reshape(2, 3), "b": np.ones(3, np.float32)}
    return trees


TREES = _trees()


def _same(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif a is None:
        assert b is None
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(TREES))
def test_bytes_identical_to_reference_and_round_trip(name):
    tree = TREES[name]
    blob = serde.params_to_bytes(tree)
    assert blob == ref_serde.params_to_bytes(tree)
    back = serde.params_from_bytes(blob)
    _same(back, ref_serde.params_from_bytes(blob))


def _as_tensors(tree):
    if isinstance(tree, dict):
        return {k: _as_tensors(v) for k, v in tree.items()}
    return torch.tensor(tree)


@pytest.mark.parametrize("name", ["lr", "mlp", "plain_layer", "mixed"])
def test_tensor_leaves_write_the_same_bytes_as_numpy(name):
    tree = TREES[name]
    assert serde.params_to_bytes(_as_tensors(tree)) == \
        ref_serde.params_to_bytes(tree)


@pytest.mark.skipif(ml_dtypes is None, reason="ml_dtypes not installed")
def test_torch_bfloat16_matches_ml_dtypes_archive():
    w = torch.linspace(-2, 2, 6).reshape(2, 3).to(torch.bfloat16)
    ref_w = w.float().numpy().astype(ml_dtypes.bfloat16)
    tree = {"w": w, "b": torch.ones(3)}
    ref_tree = {"w": ref_w, "b": np.ones(3, np.float32)}
    blob = serde.params_to_bytes(tree)
    assert blob == ref_serde.params_to_bytes(ref_tree)
    back = serde.params_from_bytes(blob)
    assert back["w"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(back["w"].astype(np.float32),
                                  w.float().numpy())


def test_party_rows_of_a_stack_serialize_like_standalone_arrays():
    """all_party_params hands out row views of one host stack; their bytes
    must equal those of the same values as fresh arrays."""
    stack = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    row = {"w": stack[1], "b": stack[0, 0]}
    fresh = {"w": stack[1].copy(), "b": stack[0, 0].copy()}
    assert serde.params_to_bytes(row) == ref_serde.params_to_bytes(fresh)
