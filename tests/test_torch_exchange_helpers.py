"""The exchange's helpers in the port against the reference: cohort
splits and the verify-on-fetch hook, which evaluates on the device."""
import dataclasses

import numpy as np
import pytest

from repro.models import small as ref_small
from repro.runtime import exchange as ref_exchange
from repro.runtime import population as ref_population
from repro_torch.models import small
from repro_torch.runtime import exchange, population


def _data(n=6, f=10, c=5):
    rng = np.random.default_rng(0)
    w = rng.normal(size=(f, c)).astype(np.float32)
    x = rng.normal(size=(n, 32, f)).astype(np.float32)
    ex = rng.normal(size=(96, f)).astype(np.float32)
    return (x, (x @ w).argmax(-1).astype(np.int32)), \
        (ex, (ex @ w).argmax(-1).astype(np.int32))


def test_split_cohorts_matches_reference():
    for n in (1, 2, 3, 10, 64, 10_000):
        for frac in (0.0, 0.2, 0.5, 1.0):
            assert exchange.split_cohorts(n, frac) == \
                ref_exchange.split_cohorts(n, frac)
    with pytest.raises(ValueError):
        exchange.split_cohorts(4, 1.5)


def test_verifier_measures_what_the_reference_measures():
    (xa, ya), (ex, ey) = _data()
    ref_pop = ref_population.PartyPopulation(
        ref_small.make_mlp(10, 5), xa, ya, task="cx", seed=2)
    ref_pop.train_epochs(1)
    card = ref_pop.make_card(0, 0.0)
    params = {k: np.asarray(v) for k, v in ref_pop.party_params(3).items()}
    ref_verify = ref_exchange.make_verifier(
        {"mlp": ref_pop.model.apply}, ex, ey)
    verify = exchange.make_verifier(
        {"mlp": small.make_mlp(10, 5).apply}, ex, ey, "cpu")
    assert verify(params, card) == ref_verify(params, card)
    unknown = dataclasses.replace(card, arch="cnn")
    assert verify(params, unknown) is None


def test_run_exchange_refuses_cohorts_on_another_device():
    (xa, ya), (ex, ey) = _data()
    pop = population.PartyPopulation(small.make_lr(10, 5), xa, ya, task="cx",
                                     device="cpu")
    with pytest.raises(ValueError, match="lives on"):
        exchange.run_exchange([pop], ex, ey, device="meta")
