"""The flash_attention function of the port against the JAX reference.

The reference's Pallas kernel runs in interpret mode and through its jnp
oracle; the port's plain version (what a CPU tensor takes, through
``kernels.ops``) and its torch oracle must match both at the tolerances of
tests/test_kernels.py: float32 2e-5, bfloat16 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.ref import flash_attention_ref as jax_flash_ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(B, H, KV, S, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, S, hd)).astype(np.float32)
    k = rng.normal(size=(B, KV, S, hd)).astype(np.float32)
    v = rng.normal(size=(B, KV, S, hd)).astype(np.float32)
    return q, k, v


def _jax(arrs, dtype):
    return [jnp.asarray(a).astype(jnp.dtype(dtype)) for a in arrs]


def _torch(arrs, dtype):
    return [torch.tensor(a).to(getattr(torch, dtype)) for a in arrs]


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _check_port(arrs, dtype, bq, bkv, **mask):
    """Port plain + oracle vs reference interpret kernel + oracle."""
    jq, jk, jv = _jax(arrs, dtype)
    interp = jax_flash(jq, jk, jv, block_q=bq, block_kv=bkv, interpret=True,
                       **mask)
    jref = jax_flash_ref(jq, jk, jv, **mask)
    tq, tk, tv = _torch(arrs, dtype)
    plain = ops.flash_attention(tq, tk, tv, **mask)
    oracle = flash_attention_ref(tq, tk, tv, **mask)
    assert plain.dtype == tq.dtype and plain.shape == tq.shape
    tol = TOL[dtype]
    for ref in (interp, jref):
        for out in (plain, oracle):
            np.testing.assert_allclose(_f32(out), _f32(ref), rtol=tol,
                                       atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,S,hd,bq,bkv", [
    (1, 4, 4, 128, 64, 64, 64),    # MHA
    (2, 8, 2, 128, 32, 32, 64),    # GQA 4:1, rectangular blocks
    (1, 2, 1, 256, 64, 128, 128),  # MQA
    (1, 4, 2, 64, 128, 64, 64),    # hd > block
])
def test_plain_flash_causal_matches_reference(B, H, KV, S, hd, bq, bkv,
                                              dtype):
    _check_port(_qkv(B, H, KV, S, hd, seed=S + hd), dtype, bq, bkv,
                causal=True)


@pytest.mark.parametrize("window", [16, 64])
def test_plain_flash_sliding_window_matches_reference(window):
    _check_port(_qkv(1, 4, 2, 128, 64, seed=1), "float32", 64, 64,
                causal=True, window=window)


def test_plain_flash_noncausal_matches_reference():
    _check_port(_qkv(1, 2, 2, 128, 64, seed=2), "float32", 64, 64,
                causal=False)


@pytest.mark.parametrize("S,hd,window", [(100, 80, None), (37, 64, 8),
                                         (1, 128, None)])
def test_plain_flash_takes_ragged_lengths(S, hd, window):
    """S that is no multiple of a tile, and Zamba2's head_dim 80: the
    reference kernel asserts divisibility, its oracle does not."""
    q, k, v = _qkv(2, 4, 2, S, hd, seed=S)
    jq, jk, jv = _jax((q, k, v), "float32")
    ref = jax_flash_ref(jq, jk, jv, causal=True, window=window)
    out = ops.flash_attention(*_torch((q, k, v), "float32"), causal=True,
                              window=window)
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=2e-5, atol=2e-5)


def test_rows_without_a_visible_key_are_zero():
    """window 0 hides every key: the kernel's function writes zeros (the
    Pallas kernel's alive/safe logic), where a dense softmax is uniform."""
    q, k, v = _torch(_qkv(1, 2, 1, 64, 64, seed=3), "float32")
    out = fa.flash_attention_plain(q, k, v, causal=True, window=0)
    assert torch.equal(out, torch.zeros_like(out))
    jq, jk, jv = _jax(_qkv(1, 2, 1, 64, 64, seed=3), "float32")
    interp = jax_flash(jq, jk, jv, causal=True, window=0, block_q=64,
                       block_kv=64, interpret=True)
    np.testing.assert_array_equal(np.asarray(interp), 0.0)


def test_cpu_tensors_take_the_plain_version_without_building():
    before = fa.launches
    q, k, v = _torch(_qkv(1, 4, 2, 16, 64, seed=4), "float32")
    out = fa.flash_attention(q, k, v, causal=True, window=5)
    assert torch.equal(out, fa.flash_attention_plain(q, k, v, causal=True,
                                                     window=5))
    assert fa.launches == before
    assert fa._lib is None


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v = _torch(_qkv(1, 4, 2, 16, 64, seed=5), "float32")
    with pytest.raises(TypeError, match="one dtype"):
        fa.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(TypeError):
        fa.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="split"):
        fa.flash_attention(q[:, :3], k, v)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k[:, :, :8], v[:, :, :8])
    with pytest.raises(ValueError):
        fa.flash_attention(q[0], k[0], v[0])
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, k, v, window=-1)
    with pytest.raises(ValueError, match="cpu or cuda"):
        m = [t.to("meta") for t in (q, k, v)]
        fa.flash_attention(*m)
