"""The ssd_scan function of the port against the JAX reference.

The reference's Pallas kernel runs in interpret mode, beside its
sequential oracle and the model's chunked jnp mirror ``ssd_chunked``; the
port's plain version (what a CPU tensor takes, through ``kernels.ops``)
and its torch oracle must match them at the tolerances of
tests/test_kernels.py:138: float32 1e-4, bfloat16 3e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import ssd_scan_ref as jax_ssd_ref
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ssd

TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _inputs(B, S, H, P, N, seed, dt_range=None):
    """x, post-softplus dt, negative A, B_, C_ as numpy float32."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    if dt_range is None:
        dt = np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(np.float32)
    else:
        dt = rng.uniform(*dt_range, size=(B, S, H)).astype(np.float32)
    A = (-np.exp(rng.normal(size=(H,)) * 0.5)).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _torch(arrs, dtype="float32"):
    x, *rest = (torch.tensor(a) for a in arrs)
    return [x.to(getattr(torch, dtype))] + rest


def _f32(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else t,
                      np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(_f32(a), _f32(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 64, 2, 16, 8, 16),
    (2, 128, 4, 32, 16, 32),
    (1, 32, 1, 8, 4, 32),   # single chunk
])
def test_plain_matches_reference_kernel_oracle_and_chunked(B, S, H, P, N,
                                                            chunk, dtype):
    arrs = _inputs(B, S, H, P, N, seed=7)
    x, dt, A, Bm, Cm = arrs
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    rest = [jnp.asarray(a) for a in (dt, A, Bm, Cm)]
    interp = jax_ssd_scan(jx, *rest, chunk=chunk, interpret=True)
    jref = jax_ssd_ref(jx.astype(jnp.float32), *rest)
    chunked = jax_ssd_chunked(jx.astype(jnp.float32), *rest, chunk)
    tx = _torch(arrs, dtype)
    y, state = ops.ssd_scan(*tx, chunk=chunk)
    oy, ostate = ref.ssd_scan_ref(*tx)
    assert y.dtype == tx[0].dtype and y.shape == tx[0].shape
    assert state.dtype == torch.float32 and state.shape == (B, H, P, N)
    tol = TOL[dtype]
    for ry, rs in (interp, jref, chunked):
        for my, ms in ((y, state), (oy, ostate)):
            _close(my, ry, tol)
            _close(ms, rs, tol)


@pytest.mark.parametrize("S,chunk", [(50, 16), (1000, 256), (7, 16)])
def test_ragged_length_matches_the_sequential_oracle(S, chunk):
    """S % chunk != 0: the plain version pads with dt = 0; the reference's
    chunked forms assert divisibility, so its oracle is the yardstick."""
    arrs = _inputs(2, S, 3, 8, 4, seed=S, dt_range=(0.001, 0.01))
    y, state = ssd.ssd_scan_plain(*_torch(arrs), chunk=chunk)
    ry, rs = jax_ssd_ref(*(jnp.asarray(a) for a in arrs))
    _close(y, ry, 1e-4)
    _close(state, rs, 1e-4)


def test_multi_chunk_carry_matters():
    """With per-chunk decay of order one the carried state's term is a
    visible part of y, and dropping it breaks the match."""
    arrs = _inputs(1, 256, 4, 16, 8, seed=3, dt_range=(0.001, 0.01))
    tx = _torch(arrs)
    y, _ = ssd.ssd_scan_plain(*tx, chunk=64)
    ry, _ = ref.ssd_scan_ref(*tx)
    _close(y, ry, 1e-4)
    # chunks run on their own (each from a zero state) lose the carry
    alone = torch.cat([ssd.ssd_scan_plain(*(t[:, i:i + 64] if t.dim() > 1
                                            else t for t in tx), chunk=64)[0]
                       for i in range(0, 256, 64)], dim=1)
    share = float((ry - alone).norm() / ry.norm())
    assert share > 0.1, share


def test_chunk_longer_than_the_sequence_is_cut_to_it():
    arrs = _inputs(1, 24, 2, 8, 4, seed=4)
    tx = _torch(arrs)
    a = ops.ssd_scan(*tx, chunk=256)
    b = ops.ssd_scan(*tx, chunk=24)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_port_oracle_matches_reference_oracle():
    arrs = _inputs(2, 40, 3, 8, 4, seed=5)
    y, state = ref.ssd_scan_ref(*_torch(arrs))
    ry, rs = jax_ssd_ref(*(jnp.asarray(a) for a in arrs))
    _close(y, ry, 1e-5)
    _close(state, rs, 1e-5)


def test_cpu_tensors_take_the_plain_version_without_building():
    before = ssd.launches
    tx = _torch(_inputs(1, 32, 2, 8, 4, seed=6))
    out = ops.ssd_scan(*tx, chunk=16)
    plain = ssd.ssd_scan_plain(*tx, chunk=16)
    assert all(torch.equal(u, v) for u, v in zip(out, plain))
    assert ssd.launches == before
    assert ssd._lib is None


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x, dt, A, Bm, Cm = _torch(_inputs(1, 16, 2, 8, 4, seed=8))
    with pytest.raises(TypeError, match="float32 or bfloat16 x"):
        ssd.ssd_scan(x.half(), dt, A, Bm, Cm, chunk=8)
    with pytest.raises(TypeError, match="float32 dt"):
        ssd.ssd_scan(x, dt.bfloat16(), A, Bm, Cm, chunk=8)
    with pytest.raises(ValueError, match="match"):
        ssd.ssd_scan(x, dt, A, Bm, Cm[:, :8], chunk=8)
    with pytest.raises(ValueError, match="match"):
        ssd.ssd_scan(x, dt, A[:1], Bm, Cm, chunk=8)
    with pytest.raises(ValueError, match="chunk"):
        ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        m = [t.to("meta") for t in (x, dt, A, Bm, Cm)]
        ssd.ssd_scan(*m, chunk=8)
