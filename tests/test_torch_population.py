"""The port's PartyPopulation against the reference's (``mesh=None``).

Both start from the reference's ``export_state()`` carried across by
``repro_torch.convert``; the numpy RNG then gives both the same block
schedules, and losses and params must track within 1e-5 over several
epochs, evaluations exactly.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.checkpoint.serde import params_to_bytes as ref_params_to_bytes
from repro.models import small as ref_small
from repro.runtime import population as ref_pop
from repro_torch.checkpoint.serde import params_to_bytes
from repro_torch.convert import params_from_reference, state_from_reference
from repro_torch.models import small
from repro_torch.runtime import population as pop

N_PARTIES, N_PER, N_FEAT, N_CLASSES = 6, 64, 8, 4


def _data(seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(N_FEAT, N_CLASSES)).astype(np.float32)
    x = rng.normal(size=(N_PARTIES, N_PER, N_FEAT)).astype(np.float32)
    y = (x @ w).argmax(-1).astype(np.int32)
    ex = rng.normal(size=(128, N_FEAT)).astype(np.float32)
    ey = (ex @ w).argmax(-1).astype(np.int32)
    return x, y, ex, ey


X, Y, EX, EY = _data()


def _pair(arch="lr", seed=0):
    ref_model = getattr(ref_small, f"make_{arch}")(N_FEAT, N_CLASSES)
    model = getattr(small, f"make_{arch}")(N_FEAT, N_CLASSES)
    ids = [f"{arch}{i}" for i in range(N_PARTIES)]
    ref = ref_pop.PartyPopulation(ref_model, X, Y, task="t", lr=0.1,
                                  batch_size=16, seed=seed, party_ids=ids)
    port = pop.PartyPopulation(model, X, Y, task="t", lr=0.1, batch_size=16,
                               seed=seed, party_ids=ids, device="cpu")
    port.restore_state(state_from_reference(ref.export_state(), "cpu"))
    return ref, port


def _assert_params_close(ref, port, atol=1e-5):
    a = ref.export_state()["params"]
    b = port.export_state()["params"]
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(b[k], np.asarray(a[k]), atol=atol, rtol=0)


@pytest.mark.parametrize("arch", ["lr", "mlp"])
def test_train_epochs_tracks_reference(arch):
    ref, port = _pair(arch)
    for _ in range(3):
        np.testing.assert_allclose(port.train_epochs(1), ref.train_epochs(1),
                                   atol=1e-5)
        _assert_params_close(ref, port)
        np.testing.assert_array_equal(port.evaluate(EX, EY),
                                      ref.evaluate(EX, EY))
    s_ref, s_port = ref.export_state(), port.export_state()
    assert s_port["cursor"] == s_ref["cursor"] == 12
    np.testing.assert_array_equal(s_port["opt_state"]["step"],
                                  np.asarray(s_ref["opt_state"]["step"]))
    assert s_port["opt_state"]["mom"] == ()
    assert s_port["rng_state"] == s_ref["rng_state"]


def test_distill_from_tracks_reference():
    ref, port = _pair("lr")
    ref.train_epochs(1)
    port.train_epochs(1)
    teacher = ref.party_params(1)
    for _ in range(3):
        np.testing.assert_allclose(port.distill_from(teacher, epochs=1),
                                   ref.distill_from(teacher, epochs=1),
                                   atol=1e-5)
        _assert_params_close(ref, port)
    np.testing.assert_array_equal(port.evaluate(EX, EY), ref.evaluate(EX, EY))


def test_cross_arch_distill_batch_tracks_reference_and_leaves_rest():
    """LR students, MLP teachers; three students pad to a bucket of 4."""
    ref, port = _pair("lr")
    ref_t, port_t = _pair("mlp", seed=1)
    for p in (ref, port, ref_t, port_t):
        p.train_epochs(1)
    idx = [0, 2, 5]
    teachers = [ref_t.party_params(i) for i in (1, 3, 4)]
    before = port.export_state()["params"]
    for _ in range(3):
        lr_ref = ref.distill_batch(idx, ref_pop.stack_teachers(teachers),
                                   teacher_apply=ref_t.model.apply, epochs=1)
        lr_port = port.distill_batch(
            idx, pop.stack_teachers(teachers, "cpu"),
            teacher_apply=port_t.model.apply, epochs=1)
        np.testing.assert_allclose(lr_port, lr_ref, atol=1e-5)
        _assert_params_close(ref, port)
    after = port.export_state()["params"]
    for k in after:
        for i in (1, 3, 4):
            np.testing.assert_array_equal(after[k][i], before[k][i])
        assert not np.array_equal(after[k][0], before[k][0]) or k == "b"
    np.testing.assert_array_equal(port.evaluate(EX, EY), ref.evaluate(EX, EY))


def test_distill_batch_padding_never_leaks_into_loss():
    """A bucket's pad rows repeat the last party; the loss covers only the
    real students, so padding must not change it."""
    _, a = _pair("lr")
    _, b = _pair("lr")
    teachers = pop.stack_teachers([a.party_params(4)] * 3, "cpu")
    padded = a.distill_batch([0, 1, 2], teachers, epochs=2)
    unpadded = b.distill_batch([0, 1, 2], teachers, epochs=2, bucket=False)
    np.testing.assert_allclose(padded, unpadded, atol=1e-6)
    for k, v in a.params.items():
        np.testing.assert_allclose(v.numpy(), b.params[k].numpy(), atol=1e-6)


def test_bucket_rule_matches_reference():
    for k in range(1, 40):
        for cap in (k, k + 3, 64):
            assert pop._bucket(k, 1, cap) == ref_pop._bucket(k, 1, cap)


def test_published_params_bytes_and_cards_match_reference():
    ref, port = _pair("mlp")
    ref_rows = [jax.tree_util.tree_map(np.asarray, p)
                for p in ref.all_party_params()]
    rows = port.all_party_params()
    assert len(rows) == N_PARTIES
    for i, (r, p) in enumerate(zip(ref_rows, rows)):
        assert params_to_bytes(p) == ref_params_to_bytes(r)
        assert params_to_bytes(port.party_params(i)) == params_to_bytes(p)
        assert dataclasses.asdict(port.make_card(i, 0.25)) == \
            dataclasses.asdict(ref.make_card(i, 0.25))


def test_export_restore_round_trip_resumes_identically():
    _, a = _pair("lr")
    a.train_epochs(1)
    snap = a.export_state()
    _, b = _pair("lr")
    b.restore_state(state_from_reference(snap, "cpu"))
    assert a.train_epochs(2) == b.train_epochs(2)
    for k in a.params:
        assert np.array_equal(a.params[k].numpy(), b.params[k].numpy())


def test_params_from_reference_keeps_layout_and_dtype():
    ref, _ = _pair("mlp")
    host = jax.tree_util.tree_map(np.asarray, ref.party_params(2))
    out = params_from_reference(host, "cpu")
    assert sorted(out) == ["b1", "b2", "w1", "w2"]
    assert tuple(out["w1"].shape) == (N_FEAT, 32)
    for k in host:
        assert str(out[k].dtype) == "torch.float32"
        np.testing.assert_array_equal(out[k].numpy(), host[k])
