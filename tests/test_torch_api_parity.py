"""Calls that the reference accepts and the port must accept too.

``kernels.ops.ssd_scan`` without ``chunk`` (the reference's default 128),
and ``PartyPopulation``'s ``fused=`` / ``mesh=`` arguments and its public
``distill_step``, each against the reference on the same numpy inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.models import small as ref_small
from repro.runtime import population as ref_pop
from repro_torch.convert import state_from_reference
from repro_torch.kernels import ops
from repro_torch.models import small
from repro_torch.runtime import population as pop

SCAN_TOL = 1e-4  # tests/test_kernels.py:138, float32
POP_TOL = 1e-5   # tests/test_population_fused.py
N_PARTIES, N_PER, N_FEAT, N_CLASSES = 4, 32, 8, 5


def test_ssd_scan_default_chunk_matches_reference():
    """S 256 is two chunks of the default 128, so the carry is exercised."""
    rng = np.random.default_rng(0)
    B, S, H, P, N = 2, 256, 3, 16, 8
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.001, 0.01, size=(B, S, H)).astype(np.float32)
    A = (-np.exp(rng.normal(size=(H,)) * 0.5)).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    args = (x, dt, A, Bm, Cm)
    y, state = ops.ssd_scan(*(torch.tensor(a) for a in args))
    ry, rstate = ref_ops.ssd_scan(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=SCAN_TOL,
                               rtol=SCAN_TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(rstate),
                               atol=SCAN_TOL, rtol=SCAN_TOL)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(N_FEAT, N_CLASSES)).astype(np.float32)
    x = rng.normal(size=(N_PARTIES, N_PER, N_FEAT)).astype(np.float32)
    y = (x @ w).argmax(-1).astype(np.int32)
    return x, y


def _port(fused, seed=3):
    x, y = _data()
    return pop.PartyPopulation(small.make_lr(N_FEAT, N_CLASSES), x, y,
                               task="t", lr=0.1, batch_size=8, seed=seed,
                               fused=fused, mesh=None, device="cpu")


def test_fused_and_eager_populations_end_identically():
    a, b = _port(True), _port(False)
    la = a.train_epochs(2)
    lb = b.train_epochs(2, fused=True)
    la2 = a.train_epochs(1, fused=False)
    lb2 = b.train_epochs(1)
    assert (la, la2) == (lb, lb2)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])


def test_mesh_is_refused_until_it_is_ported():
    x, y = _data()
    with pytest.raises(NotImplementedError, match="A9"):
        pop.PartyPopulation(small.make_lr(N_FEAT, N_CLASSES), x, y, task="t",
                            mesh=object(), device="cpu")


@pytest.mark.parametrize("teacher_axis", [0, None])
@pytest.mark.parametrize("teacher_arch", ["lr", "mlp"])
def test_distill_step_matches_reference(teacher_axis, teacher_arch):
    x, y = _data()
    ref = ref_pop.PartyPopulation(ref_small.make_lr(N_FEAT, N_CLASSES), x, y,
                                  task="t", lr=0.1, batch_size=N_PER, seed=0)
    port = pop.PartyPopulation(small.make_lr(N_FEAT, N_CLASSES), x, y,
                               task="t", lr=0.1, batch_size=N_PER, seed=0,
                               device="cpu")
    port.restore_state(state_from_reference(ref.export_state(), "cpu"))
    t_ref = ref_pop.PartyPopulation(
        getattr(ref_small, f"make_{teacher_arch}")(N_FEAT, N_CLASSES), x, y,
        task="t", seed=7)
    t_apply_ref = t_ref.model.apply
    t_apply = getattr(small, f"make_{teacher_arch}")(N_FEAT,
                                                     N_CLASSES).apply
    if teacher_axis is None:
        teacher = {k: np.asarray(v) for k, v in t_ref.party_params(1).items()}
    else:
        teacher = {k: np.asarray(v) for k, v in t_ref.params.items()}

    r_params, r_opt = ref.params, ref._vinit(ref.params)
    p_params = port.params
    p_opt = port._opt.init(p_params, (N_PARTIES,))
    for _ in range(3):
        r_params, r_opt, r_loss = ref.distill_step(
            r_params, r_opt, jnp.asarray(x), jnp.asarray(y), teacher,
            teacher_apply=t_apply_ref, teacher_axis=teacher_axis, alpha=0.3,
            temperature=2.5)
        p_params, p_opt, p_loss = port.distill_step(
            p_params, p_opt, x, y, teacher, teacher_apply=t_apply,
            teacher_axis=teacher_axis, alpha=0.3, temperature=2.5)
        np.testing.assert_allclose(p_loss.numpy(), np.asarray(r_loss),
                                   atol=POP_TOL, rtol=0)
    for k in r_params:
        np.testing.assert_allclose(p_params[k].detach().numpy(),
                                   np.asarray(r_params[k]), atol=POP_TOL,
                                   rtol=0)
