"""The port's serving loop against the JAX reference's ``launch/serve.py``.

Requests, padding and slot batching are the reference's; generated tokens
match the reference's ``run_slot`` from the same (converted) float32
params and prompts.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch import serve as jax_serve
from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.launch.steps import make_serve_step as jax_serve_step
from repro.runtime.serving import SlotQueue as JaxSlotQueue
from repro.runtime.serving import pick_bucket as jax_pick_bucket
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_reference
from repro_torch.launch import serve
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.runtime.serving import SlotQueue, pick_bucket

ARCH = "qwen2_1_5b"


def test_requests_and_padding_are_the_reference_s():
    for port_cfg, ref_cfg in ((get_config(ARCH), jax_config(ARCH)),
                              (get_smoke_config(ARCH), jax_smoke_config(ARCH))):
        mine = serve.make_requests(port_cfg, 16, seed=3)
        ref = jax_serve.make_requests(ref_cfg, 16, seed=3)
        assert len(mine) == len(ref)
        for a, b in zip(mine, ref):
            np.testing.assert_array_equal(a, b)
        batch = serve.pad_batch(port_cfg, mine[:8], 32)
        ref_batch = jax_serve.pad_batch(ref_cfg, ref[:8], 32)
        assert batch["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(batch["tokens"].numpy(),
                                      np.asarray(ref_batch["tokens"]))


def test_run_slot_generates_the_reference_tokens():
    jcfg = jax_smoke_config(ARCH).replace(dtype="float32")
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    bucket, max_new = 32, 8
    jprefill, jmodel = jax_prefill_step(jcfg, cache_len=bucket + max_new)
    jstep, _ = jax_serve_step(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    prefill, _ = make_prefill_step(cfg, cache_len=bucket + max_new)
    step, _ = make_serve_step(cfg)
    params = params_from_reference(jparams, torch.device("cpu"))
    prompts = serve.make_requests(cfg, 5, seed=1)
    ref_gen, ref_logits, _, _ = jax_serve.run_slot(
        jcfg, jax.jit(jprefill), jax.jit(jstep), jparams, prompts, bucket,
        max_new)
    gen, logits, t_prefill, t_decode = serve.run_slot(
        cfg, prefill, step, params, prompts, bucket, max_new)
    np.testing.assert_array_equal(gen, np.asarray(ref_gen))
    assert gen.shape == (5, max_new) and gen.dtype == np.int32
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               rtol=2e-4, atol=2e-4)
    assert t_prefill > 0 and t_decode > 0


def _shape(text):
    """Printed lines with token ids and times blanked out."""
    text = re.sub(r"\[[-0-9, ]*\]", "[...]", text)
    return re.sub(r"[0-9]+\.[0-9]+", "#", text)


def test_main_prints_the_reference_s_lines(capsys):
    argv = ["--arch", ARCH, "--smoke", "--requests", "10", "--max-new", "5",
            "--max-batch", "4"]
    assert serve.main(argv + ["--device", "cpu"]) == 0
    mine = capsys.readouterr().out
    assert jax_serve.main(argv) == 0
    ref = capsys.readouterr().out
    assert _shape(mine) == _shape(ref)
    assert "3 slot(s)" in mine


def test_main_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--smoke", "--requests", "1", "--max-new", "2"])


# -- SlotQueue --------------------------------------------------------------------
_ops = st.lists(
    st.one_of(
        st.tuples(st.just("add"), st.sampled_from(["a", "b"]),
                  st.integers(1, 80), st.integers(0, 2), st.integers(0, 3)),
        st.tuples(st.just("drain"), st.sampled_from(["a", "b"]),
                  st.sampled_from([16, 32, 64]))),
    max_size=40)


@settings(max_examples=60, deadline=None, database=None)
@given(buckets=st.sets(st.sampled_from([16, 32, 64]), min_size=1),
       max_batch=st.integers(1, 5), ops=_ops)
def test_slot_queue_matches_reference(buckets, max_batch, ops):
    mine = SlotQueue(buckets=sorted(buckets), max_batch=max_batch)
    ref = JaxSlotQueue(buckets=sorted(buckets), max_batch=max_batch)
    for i, op in enumerate(ops):
        if op[0] == "add":
            _, key, n, tier, bypass = op
            assert mine.add(key, n, i, tier, bypass) == \
                ref.add(key, n, i, tier, bypass)
        else:
            _, key, bucket = op
            assert mine.drain(key, bucket) == ref.drain(key, bucket)
        assert mine.pending() == ref.pending()
        assert len(mine) == len(ref)
        for key, bucket in ref.pending():
            assert mine.depth(key, bucket) == ref.depth(key, bucket)


@pytest.mark.parametrize("n", [0, 1, 16, 17, 32, 33, 100])
def test_pick_bucket_matches_reference(n):
    assert pick_bucket((16, 32), n) == jax_pick_bucket((16, 32), n)


def test_slot_queue_refuses_what_the_reference_refuses():
    with pytest.raises(ValueError):
        SlotQueue(buckets=(), max_batch=4)
    with pytest.raises(ValueError):
        SlotQueue(buckets=(16,), max_batch=0)
