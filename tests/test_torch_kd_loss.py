"""The kd_loss function of the port against the JAX reference.

The reference's Pallas kernel runs in interpret mode and through its jnp
oracle; the port's plain version (what a CPU tensor takes) and its oracle
must match both at the tolerances of tests/test_kernels.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import losses as ref_losses
from repro.kernels import ops as ref_ops
from repro.kernels.ref import kd_loss_ref as jax_kd_loss_ref
from repro_torch.core import losses
from repro_torch.kernels import kd_loss as kd
from repro_torch.kernels import ops
from repro_torch.kernels.ref import kd_loss_ref

TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _inputs(n, v, seed, scale=2.0):
    rng = np.random.default_rng(seed)
    s = (scale * rng.normal(size=(n, v))).astype(np.float32)
    t = (scale * rng.normal(size=(n, v))).astype(np.float32)
    lab = rng.integers(0, v, size=n).astype(np.int32)
    return s, t, lab


def _jax(a, dtype):
    return jnp.asarray(a).astype(jnp.dtype(dtype))


def _torch(a, dtype):
    return torch.tensor(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,V,bn,bv", [
    (128, 1000, 64, 256),  # vocab not a multiple of block_v (tail tile)
    (64, 4096, 64, 1024),
    (128, 512, 128, 512),  # single vocab tile
])
def test_plain_kd_loss_matches_reference_kernel_and_oracle(N, V, bn, bv,
                                                           dtype):
    s, t, lab = _inputs(N, V, seed=N + V)
    js, jt = _jax(s, dtype), _jax(t, dtype)
    interp = ref_ops.kd_loss(js, jt, jnp.asarray(lab), alpha=0.3,
                             temperature=2.0, force="interpret",
                             block_n=bn, block_v=bv)
    jref = jax_kd_loss_ref(js, jt, jnp.asarray(lab), alpha=0.3,
                           temperature=2.0)
    ts, tt, tl = _torch(s, dtype), _torch(t, dtype), torch.tensor(lab)
    plain = ops.kd_loss(ts, tt, tl, alpha=0.3, temperature=2.0).numpy()
    oracle = kd_loss_ref(ts, tt, tl, alpha=0.3, temperature=2.0).numpy()
    tol = TOL[dtype]
    for ref in (np.asarray(interp), np.asarray(jref)):
        np.testing.assert_allclose(plain, ref, rtol=tol, atol=tol)
        np.testing.assert_allclose(oracle, ref, rtol=tol, atol=tol)
    np.testing.assert_allclose(plain, oracle, rtol=1e-5, atol=1e-5)


def test_teacher_equals_student_gives_alpha_ce():
    s, _, lab = _inputs(64, 512, seed=4, scale=1.0)
    ts, tl = torch.tensor(s), torch.tensor(lab)
    out = kd.kd_loss(ts, ts, tl, alpha=0.7, temperature=3.0).numpy()
    jref = ref_ops.kd_loss(jnp.asarray(s), jnp.asarray(s), jnp.asarray(lab),
                           alpha=0.7, temperature=3.0, force="interpret",
                           block_n=64, block_v=256)
    logz = np.log(np.exp(s.astype(np.float64)).sum(-1))
    ce = logz - s[np.arange(64), lab]
    np.testing.assert_allclose(out, 0.7 * ce, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out, np.asarray(jref), rtol=1e-4, atol=1e-4)


def test_kernel_mean_matches_distillation_loss():
    s, t, lab = _inputs(32, 257, seed=5, scale=1.0)
    ts, tt, tl = torch.tensor(s), torch.tensor(t), torch.tensor(lab)
    per_row = kd.kd_loss(ts, tt, tl, alpha=0.5, temperature=2.0)
    total, parts = losses.distillation_loss(ts, tt, tl, alpha=0.5,
                                            temperature=2.0)
    jtotal, jparts = ref_losses.distillation_loss(
        jnp.asarray(s), jnp.asarray(t), jnp.asarray(lab), alpha=0.5,
        temperature=2.0)
    np.testing.assert_allclose(float(per_row.mean()), float(total), rtol=1e-5)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    np.testing.assert_allclose(float(parts["ce"]), float(jparts["ce"]),
                               rtol=1e-5)
