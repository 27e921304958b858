"""The port's hybrid (Zamba2) decoder and its serving against the JAX
reference.

Weights are the reference's, carried across with ``convert``; inputs are
made with numpy from a seed.  The hybrid's prefill (two chunks of the
smoke config's 16 rows, two super-blocks, so two KV caches) and its
decode match at float32 within the tolerances of tests/test_models.py
(2e-4 for logits, :85; caches within the scan's 1e-4 of
tests/test_kernels.py) and at bfloat16 within 3e-2 (:145).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch import serve as jax_serve
from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.launch.steps import make_serve_step as jax_serve_step
from repro.models import build_model as jax_build_model
from repro_torch.common.types import ParamSpec
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_reference
from repro_torch.launch import serve
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import build_model

ARCH = "zamba2_2_7b"
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


def _models(dtype="float32"):
    jcfg, cfg = _configs(dtype)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    return jmodel, model, jparams, params_from_reference(jparams, CPU)


# -- the whole model ---------------------------------------------------------------
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 3e-2)])
def test_prefill_and_decode_match_reference(dtype, tol):
    jmodel, model, jparams, params = _models(dtype)
    B, S, steps = 2, 32, 8  # 2 chunks of 16; 2 super-blocks, 2 KV caches
    toks = _tokens(B, S, model.cfg.vocab_size, seed=5)
    jprefill = jax.jit(jmodel.prefill, static_argnames="cache_len")
    jdecode = jax.jit(jmodel.decode)
    jlogits, _, jcache = jprefill(jparams, {"tokens": jnp.asarray(toks)},
                                  cache_len=S + steps)
    logits, _, cache = model.prefill(params, {"tokens": torch.tensor(toks)},
                                     cache_len=S + steps)
    _close(logits, jlogits, tol)
    if dtype == "float32":
        _close_caches(cache, jcache)
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
    if dtype == "float32":
        _close_caches(cache, jcache)


def _close_caches(cache, jcache):
    for group, names in (("kv", ("k", "v", "pos")), ("ssm", ("conv", "state"))):
        for name in names:
            _close(cache["blocks"][group][name], jcache["blocks"][group][name],
                   1e-4)


def test_each_shared_block_application_keeps_its_own_kv_cache():
    """The two super-blocks' caches differ, and swapping them breaks the
    match: decode reads slice ``i`` in super-block ``i``."""
    _, model, _, params = _models()
    toks = torch.tensor(_tokens(1, 16, model.cfg.vocab_size, seed=7))
    _, _, cache = model.prefill(params, {"tokens": toks}, cache_len=24)
    kv = cache["blocks"]["kv"]
    assert not torch.equal(kv["k"][0], kv["k"][1])
    nxt = {"token": toks[:, -1:]}
    good, _ = model.decode(params, _clone(cache), nxt)
    swapped = _clone(cache)
    for name in ("k", "v"):
        swapped["blocks"]["kv"][name] = swapped["blocks"]["kv"][name].flip(0)
    bad, _ = model.decode(params, swapped, nxt)
    assert float((good - bad).abs().max()) > 1e-3


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def test_decode_equals_prefill_continuation():
    """Prefill 16 tokens, decode tokens 16..31 one at a time: each step's
    logits equal the forward's over 32 tokens (f32)."""
    _, cfg = _configs()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.tensor(_tokens(2, 32, cfg.vocab_size, seed=6))
    full, _ = model.forward(params, {"tokens": toks})
    _, _, cache = model.prefill(params, {"tokens": toks[:, :16]}, cache_len=40)
    for t in range(16, 32):
        dec, cache = model.decode(params, cache, {"token": toks[:, t:t + 1]})
        _close(dec[:, 0], full[:, t], 2e-4)
        assert torch.equal(dec[:, 0].argmax(-1), full[:, t].argmax(-1))


def test_init_cache_has_the_reference_s_layout():
    jcfg, cfg = _configs("bfloat16")
    ref = jax_build_model(jcfg).init_cache(2, 10)
    cache = build_model(cfg).init_cache(2, 10)
    assert cache["pos"] == int(ref["pos"]) == 0
    for group, names in (("kv", ("k", "v", "pos")), ("ssm", ("conv", "state"))):
        for name in names:
            mine, theirs = cache["blocks"][group][name], ref["blocks"][group][name]
            assert tuple(mine.shape) == theirs.shape, (group, name)
            assert str(mine.dtype)[6:] == str(theirs.dtype), (group, name)
            np.testing.assert_array_equal(_f32(mine), _f32(theirs))
    assert cache["blocks"]["ssm"]["state"].dtype == torch.float32
    assert cache["blocks"]["ssm"]["conv"].dtype == torch.bfloat16


# -- serving -------------------------------------------------------------------------
def test_run_slot_generates_the_reference_tokens():
    jcfg, cfg = _configs()
    bucket, max_new = 32, 8
    jprefill, jmodel = jax_prefill_step(jcfg, cache_len=bucket + max_new)
    jstep, _ = jax_serve_step(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    prefill, _ = make_prefill_step(cfg, cache_len=bucket + max_new)
    step, _ = make_serve_step(cfg)
    params = params_from_reference(jparams, CPU)
    prompts = serve.make_requests(cfg, 5, seed=1)
    ref_gen, ref_logits, _, _ = jax_serve.run_slot(
        jcfg, jax.jit(jprefill), jax.jit(jstep), jparams, prompts, bucket,
        max_new)
    gen, logits, _, _ = serve.run_slot(cfg, prefill, step, params, prompts,
                                       bucket, max_new)
    np.testing.assert_array_equal(gen, np.asarray(ref_gen))
    _close(logits, ref_logits, 2e-4)


def _shape(text):
    """Printed lines with token ids and times blanked out."""
    text = re.sub(r"\[[-0-9, ]*\]", "[...]", text)
    return re.sub(r"[0-9]+\.[0-9]+", "#", text)


def test_main_serves_zamba2_with_the_reference_s_lines(capsys):
    argv = ["--arch", ARCH, "--smoke", "--requests", "5", "--max-new", "4",
            "--max-batch", "4"]
    assert serve.main(argv + ["--device", "cpu"]) == 0
    mine = capsys.readouterr().out
    assert jax_serve.main(argv) == 0
    assert _shape(mine) == _shape(capsys.readouterr().out)
    assert "2 slot(s)" in mine


# -- params and config ---------------------------------------------------------------
def test_reference_bf16_params_convert_bit_exactly():
    jparams = jax_build_model(jax_smoke_config(ARCH)).init(
        jax.random.PRNGKey(0))
    params = params_from_reference(jparams, CPU)
    mine = build_model(get_smoke_config(ARCH)).init(
        torch.Generator().manual_seed(0))
    leaves = jax.tree_util.tree_leaves_with_path(jparams)
    assert {"shared_attn", "blocks"} <= set(params)
    assert params["blocks"]["mamba"]["mixer"]["w_xbc"].shape[:2] == (2, 2)
    for path, leaf in leaves:
        keys = [p.key for p in path]
        got, shape = params, mine
        for key in keys:
            got, shape = got[key], shape[key]
        assert got.dtype == torch.bfloat16 == shape.dtype, keys
        assert tuple(got.shape) == leaf.shape == tuple(shape.shape), keys
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(leaf).view(np.int16))
    assert len(leaves) == len(list(_leaves(mine)))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_full_config_is_the_reference_config():
    cfg, ref = get_config(ARCH), jax_config(ARCH)
    assert {f: getattr(cfg, f) for f in cfg.__dataclass_fields__} == \
        {f: getattr(ref, f) for f in ref.__dataclass_fields__}
    specs = build_model(cfg).param_specs()
    n = sum(int(np.prod(s.shape)) for s in _leaves(specs)
            if isinstance(s, ParamSpec))
    assert n == 2_340_750_240  # 54 Mamba2 layers, one shared block, tied head
    smoke, ref_smoke = get_smoke_config(ARCH), jax_smoke_config(ARCH)
    assert {f: getattr(smoke, f) for f in smoke.__dataclass_fields__} == \
        {f: getattr(ref_smoke, f) for f in ref_smoke.__dataclass_fields__}
