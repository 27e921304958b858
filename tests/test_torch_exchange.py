"""The port's run_exchange against the reference's, event for event.

Two cohorts (LR and MLP) x 2 cycles start from the reference's exported
state and run flat, over 2 regions, and under a FaultPlan with churn,
drops, corruption and byzantine publishers.  Each run must give the
reference's event log (label, time, payload), its cycle counts and
accuracies, distillation losses within 1e-5, and its ledger, conserved.
"""
import numpy as np
import pytest

from repro.core import continuum as ref_continuum
from repro.core import incentives as ref_incentives
from repro.models import small as ref_small
from repro.runtime import exchange as ref_exchange
from repro.runtime import faults as ref_faults
from repro.runtime import population as ref_population
from repro.runtime import topology as ref_topology
from repro_torch.convert import state_from_reference
from repro_torch.core import continuum, incentives
from repro_torch.models import small
from repro_torch.runtime import exchange, faults, population, topology

REF = dict(continuum=ref_continuum, incentives=ref_incentives,
           small=ref_small, exchange=ref_exchange, faults=ref_faults,
           population=ref_population, topology=ref_topology)
PORT = dict(continuum=continuum, incentives=incentives, small=small,
            exchange=exchange, faults=faults, population=population,
            topology=topology)
PLAN = dict(seed=1, churn=0.3, drop_prob=0.3, delay_prob=0.2,
            corrupt_prob=0.1, byzantine_frac=0.25, byzantine_inflation=0.5)
COUNTS = ("cohort", "cycle", "online", "published", "fetched", "denied",
          "misses", "cross_arch", "failed", "local_hits", "escalated",
          "teacher_fetches", "mean_acc", "best_acc")


N_LR, N_MLP = 5, 3


def _data(n_lr=N_LR, n_mlp=N_MLP, f=10, c=5, n=48):
    rng = np.random.default_rng(0)
    w = rng.normal(size=(f, c)).astype(np.float32)

    def data(k):
        x = rng.normal(size=(k, n, f)).astype(np.float32)
        return x, (x @ w).argmax(-1).astype(np.int32)

    (xa, ya), (xb, yb) = data(n_lr), data(n_mlp)
    ex = rng.normal(size=(96, f)).astype(np.float32)
    ey = (ex @ w).argmax(-1).astype(np.int32)
    return (xa, ya), (xb, yb), ex, ey


def _run(m, mode, start=None):
    (xa, ya), (xb, yb), ex, ey = _data()
    f, c = xa.shape[-1], 5
    kw = {} if m is REF else {"device": "cpu"}
    pops = [
        m["population"].PartyPopulation(
            m["small"].make_lr(f, c), xa, ya, task="cx", lr=0.2, seed=0,
            party_ids=[f"lr{i}" for i in range(len(xa))], **kw),
        m["population"].PartyPopulation(
            m["small"].make_mlp(f, c), xb, yb, task="cx", lr=0.2, seed=1,
            party_ids=[f"mlp{i}" for i in range(len(xb))], **kw),
    ]
    if start is not None:
        for p, snap in zip(pops, start):
            p.restore_state(state_from_reference(snap, "cpu"))
    exported = [p.export_state() for p in pops]
    ledger = m["incentives"].IncentiveLedger()
    if mode == "regions":
        cont = m["topology"].build_hierarchical_continuum(
            2, total_edges=4, ledger=ledger)
    else:
        plan = m["faults"].FaultPlan(**PLAN) if mode == "faults" else None
        cont = m["continuum"].Continuum(ledger=ledger, faults=plan)
        for e in range(2):
            cont.add_edge_server(f"edge{e:03d}")
    report = m["exchange"].run_exchange(
        pops, ex, ey, cfg=m["exchange"].ExchangeConfig(cycles=2),
        continuum=cont, **kw)
    return report, cont, exported


@pytest.mark.parametrize("mode", ["flat", "regions", "faults"])
def test_exchange_replays_the_reference(mode):
    ref_report, ref_cont, start = _run(REF, mode)
    report, cont, _ = _run(PORT, mode, start)

    ref_log = [(r.label, r.time, r.payload) for r in ref_cont.loop.log]
    log = [(r.label, r.time, r.payload) for r in cont.loop.log]
    assert log == ref_log
    assert len(report.cycles) == len(ref_report.cycles) == 4
    for ours, theirs in zip(report.cycles, ref_report.cycles):
        for field in COUNTS:
            assert getattr(ours, field) == getattr(theirs, field), field
        assert abs(ours.distill_loss - theirs.distill_loss) <= 1e-5
    assert report.total_fetches > 0
    assert report.ledger == ref_report.ledger
    assert report.faults == ref_report.faults
    assert report.topology == ref_report.topology
    assert report.traffic == ref_report.traffic
    cont.ledger.assert_conserved()
    if mode == "faults":
        assert report.faults["frauds_detected"] > 0
        sizes = {"lr": N_LR, "mlp": N_MLP}
        assert any(s.online < sizes[s.cohort] for s in report.cycles)
    if mode == "regions":
        assert report.topology["regions"] == 2
    else:
        assert report.total_cross_arch > 0
