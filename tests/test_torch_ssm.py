"""The port's Mamba2 block (``models/ssm.py``) against the JAX reference.

Each layer's params are drawn by the reference's initialiser and carried
across with ``convert``; inputs are made with numpy from a seed.  The
full-sequence block (through the scan's plain version) and the one-token
step match at float32 within 2e-4 for the output (tests/test_models.py:85)
and 1e-4 for the state (tests/test_kernels.py:138), and at bfloat16
within 3e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.types import init_params as jax_init_params
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import ssm as jax_ssm
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_reference
from repro_torch.models import ssm

ARCH = "zamba2_2_7b"
CPU = torch.device("cpu")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(_f32(a), _f32(b), rtol=tol, atol=tol)


def _configs(dtype="float32"):
    return (jax_smoke_config(ARCH).replace(dtype=dtype),
            get_smoke_config(ARCH).replace(dtype=dtype))


def _mixer_params(jcfg, seed):
    """A Mamba2 layer drawn by the reference's initialiser, with the
    zero-initialised dt_bias, A_log and conv_b given values so that they
    are tested and the carried state matters (per-chunk decay of order
    one)."""
    mp = jax_init_params(jax_ssm.mamba2_spec(jcfg), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    H, C = jcfg.ssm_heads, jcfg.ssm_inner + 2 * jcfg.ssm_state
    mp["dt_bias"] = jnp.asarray(rng.uniform(-6, -4, H), jnp.float32)
    mp["A_log"] = jnp.asarray(rng.normal(size=H) * 0.5, jnp.float32)
    mp["conv_b"] = jnp.asarray(rng.normal(size=C) * 0.1, jnp.float32)
    mp["D"] = jnp.asarray(rng.normal(size=H), jnp.float32)
    return mp


@pytest.mark.parametrize("S", [32, 2])  # two chunks; shorter than the conv
def test_mamba2_apply_and_cache_match_reference(S):
    jcfg, cfg = _configs()
    mp = _mixer_params(jcfg, seed=1)
    x = np.random.default_rng(2).normal(size=(2, S, jcfg.d_model)) \
        .astype(np.float32)
    ref, rcache = jax.jit(jax_ssm.mamba2_apply, static_argnums=1)(
        mp, jcfg, jnp.asarray(x))
    out, cache = ssm.mamba2_apply(params_from_reference(mp, CPU), cfg,
                                  torch.tensor(x))
    _close(out, ref, 2e-4)
    _close(cache["state"], rcache["state"], 1e-4)
    _close(cache["conv"], rcache["conv"], 1e-5)  # a matmul's output
    assert cache["state"].dtype == torch.float32
    assert tuple(cache["conv"].shape) == rcache["conv"].shape


def test_mamba2_step_matches_reference():
    jcfg, cfg = _configs()
    mp = _mixer_params(jcfg, seed=3)
    tp = params_from_reference(mp, CPU)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 16, jcfg.d_model)).astype(np.float32)
    _, jcache = jax_ssm.mamba2_apply(mp, jcfg, jnp.asarray(x))
    _, cache = ssm.mamba2_apply(tp, cfg, torch.tensor(x))
    jstep = jax.jit(jax_ssm.mamba2_step, static_argnums=1)
    for _ in range(4):
        xt = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
        ref, jcache = jstep(mp, jcfg, jcache, jnp.asarray(xt))
        out, same = ssm.mamba2_step(tp, cfg, cache, torch.tensor(xt))
        assert same is cache  # written in place
        _close(out, ref, 2e-4)
        _close(cache["state"], jcache["state"], 1e-4)
        _close(cache["conv"], jcache["conv"], 1e-5)  # a matmul's output


def test_mamba2_bf16_layer_matches_reference():
    """In bf16 the conv and the gates round where the reference rounds."""
    jcfg, cfg = _configs("bfloat16")
    mp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                _mixer_params(jcfg, seed=5))
    x = np.random.default_rng(6).normal(size=(2, 32, jcfg.d_model))
    jx = jnp.asarray(x, jnp.bfloat16)
    ref, rcache = jax.jit(jax_ssm.mamba2_apply, static_argnums=1)(mp, jcfg, jx)
    out, cache = ssm.mamba2_apply(params_from_reference(mp, CPU), cfg,
                                  torch.tensor(_f32(jx)).bfloat16())
    assert out.dtype == torch.bfloat16 and cache["state"].dtype == torch.float32
    _close(out, ref, 3e-2)
    _close(cache["state"], rcache["state"], 3e-2)
