"""The port's losses against the JAX reference.

``fused_distillation_loss`` (one kd_loss launch over every row, analytic
backward) is held to ``jax.value_and_grad`` of the reference's fused loss,
per party and over a flattened cohort, at 1e-5 in value and 1e-6 in the
student gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import losses as ref_losses
from repro_torch.core import losses


def _inputs(n, v, seed, scale=2.0):
    rng = np.random.default_rng(seed)
    s = (scale * rng.normal(size=(n, v))).astype(np.float32)
    t = (scale * rng.normal(size=(n, v))).astype(np.float32)
    lab = rng.integers(0, v, size=n).astype(np.int32)
    return s, t, lab


@pytest.mark.parametrize("B,V,alpha,temperature", [
    (32, 8, 0.5, 2.0),    # the exchange's batch and logit width
    (16, 10, 0.3, 3.0),
    (64, 257, 0.7, 1.0),
])
def test_fused_loss_value_and_grad_match_reference(B, V, alpha, temperature):
    s, t, lab = _inputs(B, V, seed=B * V)
    jval, jgrad = jax.value_and_grad(
        lambda x: ref_losses.fused_distillation_loss(
            x, jnp.asarray(t), jnp.asarray(lab), alpha, temperature)
    )(jnp.asarray(s))
    ts = torch.tensor(s, requires_grad=True)
    val = losses.fused_distillation_loss(ts, torch.tensor(t),
                                         torch.tensor(lab), alpha, temperature)
    val.backward()
    assert val.shape == ()
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jgrad), rtol=0,
                               atol=1e-6)


def test_flattened_cohort_steps_each_party_by_its_own_mean():
    """k parties' rows go through one launch; the gradient of the sum of
    per-party means must equal each party's own gradient (scale 1/B, not
    1/(k·B))."""
    k, B, V = 5, 32, 8
    s, t, lab = _inputs(k * B, V, seed=9)
    s, t, lab = s.reshape(k, B, V), t.reshape(k, B, V), lab.reshape(k, B)
    jvals, jgrads = jax.vmap(jax.value_and_grad(
        lambda x, tt, ll: ref_losses.fused_distillation_loss(
            x, tt, ll, 0.5, 2.0)))(jnp.asarray(s), jnp.asarray(t),
                                   jnp.asarray(lab))
    ts = torch.tensor(s, requires_grad=True)
    vals = losses.fused_distillation_loss(ts, torch.tensor(t),
                                          torch.tensor(lab), 0.5, 2.0)
    vals.sum().backward()
    assert vals.shape == (k,)
    np.testing.assert_allclose(vals.detach().numpy(), np.asarray(jvals),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jgrads), rtol=0,
                               atol=1e-6)


def test_fused_loss_teacher_gets_zero_gradient():
    s, t, lab = _inputs(8, 6, seed=1)
    ts = torch.tensor(s, requires_grad=True)
    tt = torch.tensor(t, requires_grad=True)
    losses.fused_distillation_loss(ts, tt, torch.tensor(lab)).backward()
    assert torch.count_nonzero(tt.grad) == 0
    assert torch.count_nonzero(ts.grad) > 0


def test_cross_entropy_matches_reference():
    s, _, lab = _inputs(3 * 16, 7, seed=2)
    mask = (np.arange(48) % 3 != 0).astype(np.float32)
    for m in (None, mask):
        ours = losses.cross_entropy_loss(
            torch.tensor(s), torch.tensor(lab),
            mask=None if m is None else torch.tensor(m))
        theirs = ref_losses.cross_entropy_loss(
            jnp.asarray(s), jnp.asarray(lab),
            mask=None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-6)


def test_masked_distillation_loss_matches_reference():
    s, t, lab = _inputs(24, 9, seed=3)
    mask = (np.arange(24) % 4 != 1).astype(np.float32)
    total, parts = losses.distillation_loss(
        torch.tensor(s), torch.tensor(t), torch.tensor(lab), alpha=0.4,
        temperature=1.5, mask=torch.tensor(mask))
    jtotal, jparts = ref_losses.distillation_loss(
        jnp.asarray(s), jnp.asarray(t), jnp.asarray(lab), alpha=0.4,
        temperature=1.5, mask=jnp.asarray(mask))
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    np.testing.assert_allclose(float(parts["kd"]), float(jparts["kd"]),
                               rtol=1e-5)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_steps_match_reference(momentum):
    from repro.optim import apply_updates as ref_apply, sgd as ref_sgd
    from repro_torch.optim import apply_updates, sgd

    rng = np.random.default_rng(7)
    params = {"w": rng.normal(size=(3, 4)).astype(np.float32),
              "b": np.zeros(4, np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    ref_opt, opt = ref_sgd(0.1, momentum=momentum), sgd(0.1, momentum=momentum)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v) for k, v in params.items()}
    js, ts = ref_opt.init(jp), opt.init(tp)
    for g in grads:
        ju, js = ref_opt.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                                jp)
        tu, ts = opt.update({k: torch.tensor(v) for k, v in g.items()}, ts, tp)
        jp, tp = ref_apply(jp, ju), apply_updates(tp, tu)
    assert int(ts["step"]) == int(js["step"]) == 3
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6)
