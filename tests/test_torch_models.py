"""The port's dense decoder (Qwen2 family) against the JAX reference.

Weights are the reference's, carried across with ``convert``; inputs are
made with numpy from a seed.  Layers, prefill attention (against both the
reference's dense path and its ``attn_chunk`` online-softmax path) and
decode match at float32 within the tolerances of tests/test_models.py:
2e-4 for logits at float32 (:85), 3e-2 at bfloat16 (:145).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.types import init_params as jax_init_params
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as jax_attn
from repro.models import build_model as jax_build_model
from repro.models import layers as jax_layers
from repro_torch.common.types import ParamSpec, init_params
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_reference
from repro_torch.models import attention as attn
from repro_torch.models import build_model, layers
from repro_torch.models.config import ModelConfig

ARCH = "qwen2_1_5b"
CPU = torch.device("cpu")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(_f32(a), _f32(b), rtol=tol, atol=tol)


def _configs(dtype="float32", **kw):
    return (jax_smoke_config(ARCH).replace(dtype=dtype, **kw),
            get_smoke_config(ARCH).replace(dtype=dtype, **kw))


def _tokens(B, S, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


# -- layers ----------------------------------------------------------------------
def test_rmsnorm_embed_unembed_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    scale = rng.normal(size=(64,)).astype(np.float32)
    table = rng.normal(size=(50, 64)).astype(np.float32)
    toks = rng.integers(0, 50, (2, 5)).astype(np.int32)
    heads = rng.normal(size=(2, 5, 3, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5, dtype=np.int32) + 7, (2, 5))
    tx, tt = torch.tensor(x), torch.tensor(table)
    _close(layers.rmsnorm({"scale": torch.tensor(scale)}, tx),
           jax_layers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)),
           1e-5)
    _close(layers.embed({"table": tt}, torch.tensor(toks)),
           jax_layers.embed({"table": jnp.asarray(table)}, jnp.asarray(toks)),
           0)
    _close(layers.unembed({"table": tt}, tx),
           jax_layers.unembed({"table": jnp.asarray(table)}, jnp.asarray(x)),
           1e-5)
    _close(layers.apply_rope(torch.tensor(heads), torch.tensor(pos), 1e6),
           jax_layers.apply_rope(jnp.asarray(heads), jnp.asarray(pos), 1e6),
           1e-5)


@pytest.mark.parametrize("mlp_type", ["swiglu", "squared_relu", "gelu"])
def test_mlp_matches_reference(mlp_type):
    spec = jax_layers.mlp_spec(mlp_type, 32, 48)
    params = jax_init_params(spec, jax.random.PRNGKey(1))
    x = np.random.default_rng(1).normal(size=(2, 3, 32)).astype(np.float32)
    out = layers.mlp_apply(mlp_type, params_from_reference(params, CPU),
                           torch.tensor(x))
    _close(out, jax_layers.mlp_apply(mlp_type, params, jnp.asarray(x)), 1e-5)


# -- attention ---------------------------------------------------------------------
def _attn_params(jcfg):
    params = jax_init_params(jax_attn.attention_spec(jcfg),
                             jax.random.PRNGKey(2))
    # the reference zero-initialises the QKV bias; give it values to test
    rng = np.random.default_rng(2)
    for b in ("bq", "bk", "bv"):
        params[b] = jnp.asarray(rng.normal(size=params[b].shape), jnp.float32)
    return params


@pytest.mark.parametrize("window", [None, 24])
def test_attend_full_matches_dense_and_chunked_reference(window):
    jcfg, cfg = _configs(sliding_window=window)
    params = _attn_params(jcfg)
    B, S = 2, 64
    x = np.random.default_rng(3).normal(size=(B, S, jcfg.d_model)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    out, (k, v) = attn.attend_full(params_from_reference(params, CPU), cfg,
                                   torch.tensor(x), torch.tensor(pos),
                                   window=window)
    jattend = jax.jit(jax_attn.attend_full, static_argnums=1,
                      static_argnames="window")
    for chunk in (0, 16):  # dense scores, then _attend_chunked
        ref, (rk, rv) = jattend(
            params, jcfg.replace(attn_chunk=chunk), jnp.asarray(x),
            jnp.asarray(pos), window=window)
        _close(out, ref, 2e-5)
        _close(k, rk, 1e-5)
        _close(v, rv, 1e-5)


def test_decode_step_and_cache_match_reference():
    jcfg, cfg = _configs()
    params = _attn_params(jcfg)
    tparams = params_from_reference(params, CPU)
    B, S, T = 2, 12, 20
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    _, kv = jax_attn.attend_full(params, jcfg, jnp.asarray(x), jnp.asarray(pos))
    jcache = jax_attn.fill_cache_from_prefill(jcfg, kv, jnp.asarray(pos), T)
    _, tkv = attn.attend_full(tparams, cfg, torch.tensor(x), torch.tensor(pos))
    cache = attn.fill_cache_from_prefill(cfg, tkv, torch.tensor(pos), T)
    for name in ("k", "v", "pos"):
        _close(cache[name], jcache[name], 1e-5)
    jdecode = jax.jit(jax_attn.decode_step, static_argnums=1)
    for step in range(3):
        xt = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
        ref, jcache = jdecode(params, jcfg, jcache, jnp.asarray(xt), S + step)
        out, cache = attn.decode_step(tparams, cfg, cache, torch.tensor(xt),
                                      S + step)
        _close(out, ref, 2e-5)
        for name in ("k", "v", "pos"):
            _close(cache[name], jcache[name], 1e-5)


def test_decode_refuses_a_position_past_the_cache():
    _, cfg = _configs()
    cache = attn.init_cache(cfg, 1, 4, torch.float32)
    params = init_params(attn.attention_spec(cfg), torch.Generator())
    with pytest.raises(ValueError, match="4-slot"):
        attn.decode_step(params, cfg, cache, torch.zeros(1, 1, cfg.d_model), 4)


# -- the whole model ---------------------------------------------------------------
def _models(dtype, **kw):
    jcfg, cfg = _configs(dtype, **kw)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    return jmodel, model, jparams, params_from_reference(jparams, CPU)


@pytest.mark.parametrize("dtype,tol,window", [
    ("float32", 2e-4, None),
    ("float32", 2e-4, 8),   # ring-buffer cache: decode runs past the window
    ("bfloat16", 3e-2, None),
])
def test_prefill_and_decode_match_reference(dtype, tol, window):
    jmodel, model, jparams, params = _models(dtype, sliding_window=window)
    B, S, steps = 2, 16, 8
    toks = _tokens(B, S, model.cfg.vocab_size, seed=5)
    jprefill = jax.jit(jmodel.prefill, static_argnames="cache_len")
    jdecode = jax.jit(jmodel.decode)
    jlogits, _, jcache = jprefill(jparams, {"tokens": jnp.asarray(toks)},
                                  cache_len=S + steps)
    logits, _, cache = model.prefill(params, {"tokens": torch.tensor(toks)},
                                     cache_len=S + steps)
    _close(logits, jlogits, tol)
    for step in range(steps):
        jnext = np.asarray(jnp.argmax(jlogits[:, -1], -1), np.int32)
        nxt = torch.argmax(logits[:, -1], -1).to(torch.int32).numpy()
        if dtype == "float32":
            np.testing.assert_array_equal(nxt, jnext, err_msg=f"step {step}")
        # both continue from the reference's token so bf16 drift cannot fork
        jlogits, jcache = jdecode(jparams, jcache,
                                  {"token": jnp.asarray(jnext)[:, None]})
        logits, cache = model.decode(params, cache,
                                     {"token": torch.tensor(jnext)[:, None]})
        _close(logits, jlogits, tol)
    assert cache["pos"] == int(jcache["pos"]) == S + steps


def test_decode_equals_prefill_continuation():
    """Decoding token S+1 equals the forward over S+1 tokens (f32)."""
    _, cfg = _configs()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.tensor(_tokens(1, 17, cfg.vocab_size, seed=6))
    full, _ = model.forward(params, {"tokens": toks})
    _, _, cache = model.prefill(params, {"tokens": toks[:, :16]})
    dec, _ = model.decode(params, cache, {"token": toks[:, 16:17]})
    _close(dec[:, 0], full[:, 16], 2e-4)
    assert int(dec[0, 0].argmax()) == int(full[0, 16].argmax())


def test_init_cache_has_the_reference_s_layout():
    jcfg, cfg = _configs(sliding_window=6)
    ref = jax_build_model(jcfg).init_cache(2, 10)
    cache = build_model(cfg).init_cache(2, 10)
    assert cache["pos"] == int(ref["pos"]) == 0
    for name in ("k", "v", "pos"):
        mine, theirs = cache["blocks"]["kv"][name], ref["blocks"]["kv"][name]
        assert tuple(mine.shape) == theirs.shape
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    assert cache["blocks"]["kv"]["k"].dtype == torch.float32


def test_prefill_refuses_a_cache_with_no_room_to_decode():
    _, cfg = _configs()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="no room"):
        model.prefill(params, {"tokens": torch.zeros(1, 8, dtype=torch.int32)},
                      cache_len=8)


# -- params ------------------------------------------------------------------------
def test_reference_bf16_params_convert_bit_exactly():
    jmodel = jax_build_model(jax_smoke_config(ARCH))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_reference(jparams, CPU)
    ref_leaves = jax.tree_util.tree_leaves_with_path(jparams)
    shapes = build_model(get_smoke_config(ARCH)).init(
        torch.Generator().manual_seed(0))
    for path, leaf in ref_leaves:
        keys = [p.key for p in path]
        got, mine = params, shapes
        for key in keys:
            got, mine = got[key], mine[key]
        assert got.dtype == torch.bfloat16 == mine.dtype, keys
        assert tuple(got.shape) == leaf.shape == tuple(mine.shape), keys
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(leaf).view(np.int16))


def test_init_params_draws_the_reference_distributions():
    g = torch.Generator().manual_seed(0)
    spec = {"lecun": ParamSpec((4, 512, 256), (None, None, None)),
            "small": ParamSpec((1000, 64), (None, None), init="small"),
            "normal": ParamSpec((20000,), (None,), init="normal", scale=3.0),
            "zeros": ParamSpec((7,), (None,), init="zeros"),
            "ones": ParamSpec((7,), (None,), init="ones")}
    p = init_params(spec, g, dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in p.values())
    assert torch.equal(p["zeros"], torch.zeros(7, dtype=torch.bfloat16))
    assert torch.equal(p["ones"], torch.ones(7, dtype=torch.bfloat16))
    for name, std in (("lecun", 1 / 512 ** 0.5), ("small", 0.02),
                      ("normal", 3.0)):
        got = float(p[name].float().std())
        assert abs(got / std - 1) < 0.03, (name, got, std)
    again = init_params(spec, torch.Generator().manual_seed(0),
                        dtype=torch.bfloat16)
    assert all(torch.equal(p[k], again[k]) for k in p)


def test_full_config_is_the_reference_config():
    cfg, ref = get_config(ARCH), jax_config(ARCH)
    assert {f: getattr(cfg, f) for f in cfg.__dataclass_fields__} == \
        {f: getattr(ref, f) for f in ref.__dataclass_fields__}
    specs = build_model(cfg).param_specs()
    n = sum(int(np.prod(s.shape)) for s in _spec_leaves(specs))
    assert n == 1_543_714_304  # Qwen2-1.5B with a tied head


def _spec_leaves(tree):
    if isinstance(tree, ParamSpec):
        yield tree
        return
    for v in tree.values():
        yield from _spec_leaves(v)


def test_unported_families_and_archs_raise():
    base = dict(name="x", num_layers=2, d_model=64, num_heads=4,
                num_kv_heads=2, d_ff=128, vocab_size=64)
    for family, item in (("ssm", "A8d"), ("vlm", "A8e"), ("audio", "A8e")):
        with pytest.raises(NotImplementedError, match=item):
            build_model(ModelConfig(family=family, **base))
    with pytest.raises(NotImplementedError, match="A8c"):
        build_model(ModelConfig(family="moe", num_experts=4,
                                experts_per_token=2, **base))
    with pytest.raises(KeyError, match="A8"):
        get_config("xlstm_1_3b")
