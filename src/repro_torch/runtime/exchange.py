"""The model-exchange economy: incentive-gated, batched cross-architecture
distillation on the event-driven runtime.

This is the paper's model-centric design run end-to-end (§IV): trained
models are the commodity.  Each MDD cycle,

  1. the whole cohort trains locally (one batched update chain; device
     churn gates *communication*, not on-device learning), then every
     *online* party
  2. publishes its model — the card's *measured* accuracy mints the
     publish reward in the :class:`~repro_torch.core.incentives.IncentiveLedger`,
  3. queries discovery for a strictly better-performing teacher
     (``min_accuracy = own accuracy + min_gain``, same logit space),
     credit-gated: parties that cannot pay the fetch cost are refused,
  4. integrates the fetched teacher by distillation — all of a cohort's
     fetches are grouped by teacher architecture and driven through the
     bucket-padded
     :meth:`~repro_torch.runtime.population.PartyPopulation.distill_batch`, so
     each KD minibatch step of a whole cohort is ONE ``kd_loss`` kernel
     launch per teacher architecture.

Cohorts are :class:`PartyPopulation`\\ s and may have *different*
architectures (e.g. LR and MLP over the same feature/logit spaces), so
cross-architecture distillation — a student integrating a teacher whose
parameterization it does not share — is exercised on the hot path.

Everything runs as scheduled events on one :class:`EventLoop`: publishes
and fetches are Link-costed transfers, queries only see cards whose
transfers have completed, and the end-of-cycle distillation consumes
whatever teachers actually landed — asynchrony by construction.

This is the port of ``repro.runtime.exchange``: the market logic is the
reference's, line for line, so the same seeds give the same event log;
the cohorts' math runs on the device the cohorts were built on.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.continuum import Continuum, OutcomeStatus
from repro_torch.core.discovery import ModelQuery
from repro_torch.core.incentives import IncentiveLedger
from repro_torch.device import resolve_device
from repro_torch.runtime.faults import FaultPlan
from repro_torch.runtime.loop import EventLoop
from repro_torch.runtime.population import PartyPopulation, stack_teachers


@dataclasses.dataclass
class ExchangeConfig:
    """Knobs for one exchange run: cycle shape + distillation params."""

    cycles: int = 3
    cycle_len_s: float = 600.0  # simulated seconds per MDD cycle
    local_epochs: int = 1
    distill_epochs: int = 1
    min_gain: float = 0.02  # teacher must beat the student's accuracy by this
    alpha: float = 0.5
    temperature: float = 2.0
    top_k: int = 3


@dataclasses.dataclass
class CycleStats:
    """One cohort's bookkeeping for one exchange cycle."""

    cohort: str
    cycle: int
    online: int
    published: int
    fetched: int
    denied: int
    misses: int
    cross_arch: int  # fetched teachers whose arch differs from the cohort's
    mean_acc: float
    best_acc: float
    distill_loss: float
    teacher_fetches: Dict[str, int]  # teacher arch -> count
    # paid fetches that failed in flight (drop/corruption/fraud; refunded)
    failed: int = 0
    # hierarchical topologies only: how the cycle's successful fetches
    # resolved — served by the requester's region shard vs escalated to
    # the cloud index (flat continuums leave both at zero)
    local_hits: int = 0
    escalated: int = 0


class CohortExchangeActor:
    """Drives one :class:`PartyPopulation` through incentive-gated exchange
    cycles on the continuum's event loop.

    Math is batched (stacked train + per-teacher-arch distill);
    publishes, queries, payments, and transfers stay per-party scheduled
    events, staggered across the cycle window exactly like the single-party
    :class:`~repro_torch.runtime.actors.MDDPartyActor` chains.
    """

    def __init__(
        self,
        pop: PartyPopulation,
        continuum: Continuum,
        eval_x,
        eval_y,
        *,
        cfg: Optional[ExchangeConfig] = None,
        teacher_applies: Optional[Dict[str, Callable]] = None,
        availability=None,  # AvailabilityTrace over this cohort, or None
        on_cycle: Optional[Callable[[CycleStats], None]] = None,
    ):
        self.pop = pop
        self.continuum = continuum
        self.eval_x, self.eval_y = eval_x, eval_y
        self.cfg = cfg or ExchangeConfig()
        # arch name -> apply fn, for integrating cross-architecture teachers
        self.teacher_applies = dict(teacher_applies or {})
        self.teacher_applies.setdefault(pop.model.name, pop.model.apply)
        self.availability = availability
        self.on_cycle = on_cycle
        self.name = f"cohort:{pop.model.name}"
        self.stats: List[CycleStats] = []
        self._cycle = 0
        self._loop: Optional[EventLoop] = None
        # fetched teachers awaiting integration (party index -> (params,
        # card)); persists across cycles so a download that completes after
        # its cycle's distill event is integrated next cycle — or by
        # integrate_stragglers() at run end — never dropped (the requester
        # already paid for it)
        self._inbox: Dict[int, tuple] = {}

    def start(self, loop: EventLoop, at: float = 0.0):
        """Schedule this cohort's first cycle on the loop."""
        self._loop = loop
        loop.call_at(at, self._begin_cycle, label=f"{self.name} cycle0")

    # -- one cycle -----------------------------------------------------------
    def _online_indices(self) -> np.ndarray:
        if self.availability is None:
            return np.arange(self.pop.num_parties)
        avail = np.asarray(self.availability.available(self._cycle))
        return np.where(avail[: self.pop.num_parties])[0]

    def _begin_cycle(self, now: float):
        cfg = self.cfg
        cycle = self._cycle
        pop = self.pop
        cont = self.continuum

        # the whole cohort trains (one vmapped chain): availability gates
        # *communication* — an offline device keeps learning on its own
        # data, it just cannot publish or fetch until it is back online
        pop.train_epochs(cfg.local_epochs)
        accs = pop.evaluate(self.eval_x, self.eval_y)
        online = self._online_indices()

        # one bulk device->host export for the whole cohort (the cards
        # carry cycle-start accuracies, so they publish the cycle-start
        # weights those accuracies were measured on), then publishes
        # staggered across the first ~45% of the cycle; rewards mint when
        # the card lands in the cloud index
        exported = pop.all_party_params()
        for j, i in enumerate(online):
            def do_pub(_now, i=int(i)):
                cont.publish_async(pop.party_ids[i], exported[i],
                                   pop.make_card(i, accs[i]))

            self._loop.call_after(
                cfg.cycle_len_s * (0.02 + 0.43 * j / max(len(online), 1)),
                do_pub, label=f"{self.name} pub p{i}",
            )

        # credit-gated queries in the second half: each party asks for a
        # strictly better model in its own logit space
        teachers = self._inbox  # party index -> (params, card)
        counters = {"denied": 0, "misses": 0, "failed": 0,
                    "local_hits": 0, "escalated": 0}

        def make_query(i):
            return ModelQuery(
                task=pop.task,
                min_accuracy=float(accs[i]) + cfg.min_gain,
                exclude_owners=(pop.party_ids[i],),
                logit_dim=int(pop.model.num_classes),
            )

        for j, i in enumerate(online):
            def do_query(_now, i=int(i)):
                def completed(outcome, i=i):
                    if outcome.ok:
                        t_params, t_card, res = outcome.payload
                        local = getattr(res, "local", None)
                        if local is True:
                            counters["local_hits"] += 1
                        elif local is False:
                            counters["escalated"] += 1
                        teachers[i] = (t_params, t_card)
                    elif outcome.status is OutcomeStatus.MISS:
                        counters["misses"] += 1
                    elif outcome.status is OutcomeStatus.FAILED:
                        counters["failed"] += 1
                    else:  # credit-denied or membership-refused
                        counters["denied"] += 1

                cont.discover_and_fetch_async(
                    make_query(i), top_k=cfg.top_k,
                    requester=pop.party_ids[i], on_complete=completed,
                )

            self._loop.call_after(
                0.5 * cfg.cycle_len_s
                + 0.4 * cfg.cycle_len_s * j / max(len(online), 1),
                do_query, label=f"{self.name} query p{i}",
            )

        def end_cycle(now2: float):
            self._end_cycle(now2, cycle, online, accs, counters)

        self._loop.call_after(cfg.cycle_len_s, end_cycle,
                              label=f"{self.name} distill c{cycle}")

    def _integrate(self, teachers):
        """One batched KD chain per distinct teacher architecture.

        Returns ``(by_arch, mean_loss, n_integrated)``.
        """
        pop = self.pop
        cfg = self.cfg
        by_arch: Dict[str, List[int]] = {}
        for i, (_, card) in teachers.items():
            by_arch.setdefault(card.arch, []).append(i)

        loss_sum, loss_n = 0.0, 0
        for arch, idxs in sorted(by_arch.items()):
            t_apply = self.teacher_applies.get(arch)
            if t_apply is None:
                continue  # unknown architecture: cannot integrate
            idxs = sorted(idxs)
            t_stack = stack_teachers([teachers[i][0] for i in idxs],
                                     pop.device)
            loss = pop.distill_batch(
                idxs, t_stack, teacher_apply=t_apply,
                epochs=cfg.distill_epochs, alpha=cfg.alpha,
                temperature=cfg.temperature,
            )
            loss_sum += loss * len(idxs)
            loss_n += len(idxs)
        return by_arch, loss_sum / max(loss_n, 1), loss_n

    def integrate_stragglers(self):
        """Integrate paid-for teachers whose download landed after the last
        cycle's distill event (called once the loop is quiescent), folding
        them into the final cycle's stats so fetch accounting stays exact."""
        if not self._inbox or not self.stats:
            return
        teachers = dict(self._inbox)
        self._inbox.clear()
        by_arch, _, _ = self._integrate(teachers)
        last = self.stats[-1]
        last.fetched += len(teachers)
        last.cross_arch += sum(1 for _, c in teachers.values()
                               if c.arch != self.pop.model.name)
        for arch, idxs in by_arch.items():
            last.teacher_fetches[arch] = (
                last.teacher_fetches.get(arch, 0) + len(idxs)
            )

    def _end_cycle(self, now, cycle, online, accs, counters):
        """Integrate every teacher that landed this cycle."""
        pop = self.pop
        cfg = self.cfg
        # snapshot + clear in place: a download completing after this event
        # writes into the (shared) inbox and is integrated next cycle
        teachers = dict(self._inbox)
        self._inbox.clear()
        by_arch, mean_loss, _ = self._integrate(teachers)

        ledger = self.continuum.ledger
        if ledger is not None:
            ledger.assert_conserved()

        self.stats.append(CycleStats(
            cohort=pop.model.name,
            cycle=cycle,
            online=int(len(online)),
            published=int(len(online)),
            fetched=len(teachers),
            denied=int(counters["denied"]),
            misses=int(counters["misses"]),
            cross_arch=sum(1 for _, c in teachers.values()
                           if c.arch != pop.model.name),
            mean_acc=float(accs.mean()) if len(accs) else 0.0,
            best_acc=float(accs.max()) if len(accs) else 0.0,
            distill_loss=mean_loss,
            teacher_fetches={a: len(ix) for a, ix in sorted(by_arch.items())},
            failed=int(counters["failed"]),
            local_hits=int(counters["local_hits"]),
            escalated=int(counters["escalated"]),
        ))
        if self.on_cycle is not None:
            self.on_cycle(self.stats[-1])
        self._cycle += 1
        if self._cycle < cfg.cycles:
            self._loop.call_after(0.0, self._begin_cycle,
                                  label=f"{self.name} cycle{self._cycle}")


@dataclasses.dataclass
class ExchangeReport:
    """Aggregate outcome of :func:`run_exchange` across all cohorts."""

    cycles: List[CycleStats]
    ledger: Dict[str, float]
    sim_time_s: float
    events: int
    cards: int
    traffic: Dict
    faults: Dict = dataclasses.field(default_factory=dict)
    # hierarchical topologies: aggregated RegionStats + cache hit rate
    topology: Dict = dataclasses.field(default_factory=dict)

    @property
    def total_fetches(self) -> int:
        """Teachers actually integrated, summed over cycles."""
        return sum(c.fetched for c in self.cycles)

    @property
    def total_cross_arch(self) -> int:
        """Cross-architecture integrations, summed over cycles."""
        return sum(c.cross_arch for c in self.cycles)

    @property
    def total_failed(self) -> int:
        """Paid fetches that failed in flight (refunded), summed."""
        return sum(c.failed for c in self.cycles)

    @property
    def total_local_hits(self) -> int:
        """Fetches served by a region shard, summed over cycles."""
        return sum(c.local_hits for c in self.cycles)


def split_cohorts(n_parties: int, mlp_frac: float):
    """(n_lr, n_mlp) split shared by every heterogeneous-cohort builder
    (the exchange/chaos benchmarks and the trace replay scenarios).

    mlp_frac 0/1 are honoured (homogeneous runs); otherwise at least one
    MLP party so the heterogeneous path is exercised at any party count.
    """
    if not 0.0 <= mlp_frac <= 1.0:
        raise ValueError(f"mlp_frac must be in [0, 1], got {mlp_frac}")
    if mlp_frac <= 0.0 or n_parties < 2:
        n_mlp = 0
    elif mlp_frac >= 1.0:
        n_mlp = n_parties
    else:
        n_mlp = min(max(int(n_parties * mlp_frac), 1), n_parties - 1)
    return n_parties - n_mlp, n_mlp


def make_verifier(applies: Dict[str, Callable], eval_x, eval_y,
                  device=None):
    """Verify-on-fetch hook: re-measure a delivered model's accuracy.

    ``applies`` maps architecture name -> apply fn (the same table the
    exchange uses to integrate cross-architecture teachers).  The
    evaluation runs on ``device`` (the GPU unless the caller passes
    ``"cpu"``); unknown architectures return ``None`` (cannot
    verify).  This is the device-side defence the byzantine fault model
    is caught by: the card's *claimed* accuracy is checked against an
    actual evaluation on the public split before the model is trusted.

    The verifier itself is deliberately memo-free: an earlier revision
    cached verdicts by ``(model_id, version)``, which a tampered blob
    delivered under a replayed card would sail through.  Result caching
    lives in :class:`~repro_torch.core.continuum.Continuum`, keyed on the
    *content hash of the delivered params*, so only byte-identical
    payloads share a verdict (see ``Continuum._check_fraud``).
    """
    device = resolve_device(device)
    jx = torch.tensor(np.asarray(eval_x), device=device)
    jy = np.asarray(eval_y)

    def verify(params, card):
        apply = applies.get(card.arch)
        if apply is None:
            return None
        # one party: a party axis of 1 around the delivered numpy params
        p = {k: torch.tensor(np.asarray(v), device=device)[None]
             for k, v in params.items()}
        with torch.no_grad():
            preds = apply(p, jx)[0].argmax(-1).cpu().numpy()
        return float((preds == jy).mean())

    return verify


def run_exchange(
    cohorts: Sequence[PartyPopulation],
    eval_x,
    eval_y,
    *,
    cfg: Optional[ExchangeConfig] = None,
    ledger: Optional[IncentiveLedger] = None,
    continuum: Optional[Continuum] = None,
    edges: int = 8,
    regions: int = 0,
    availabilities: Optional[Sequence] = None,  # one trace per cohort
    on_cycle: Optional[Callable[[CycleStats], None]] = None,
    faults: Optional[FaultPlan] = None,
    device=None,
) -> ExchangeReport:
    """Run heterogeneous cohorts through incentive-gated exchange cycles.

    Builds (or reuses) one continuum + ledger shared by every cohort, wires
    every cohort's architecture into every other cohort's teacher table so
    cross-architecture fetches can be integrated, runs the event loop to
    quiescence, and returns the aggregate report.  Raises if the ledger
    ends non-conserved.

    ``regions > 0`` builds a hierarchical continuum instead of a flat one:
    ``edges`` edge servers distributed as evenly as possible over
    ``regions`` regions (every region gets at least one, so the effective
    total is ``max(edges, regions)``), region-first discovery, in-region
    caching, and fee sharing — the report's ``topology`` dict then
    carries the aggregated locality stats (queries, local hits,
    escalations, cache hit rate).

    With ``faults``, the continuum is built under the fault plan: transfers
    drop/delay/corrupt, stragglers slow down, byzantine publishers inflate
    their cards, and — when the plan has byzantines — a verify-on-fetch
    hook over the cohorts' own apply fns re-measures every delivered model
    so inflated cards are caught, refunded, and slashed.  If the plan has
    churn and no explicit ``availabilities`` are given, per-cohort traces
    are derived from the plan.

    ``device`` is where the cohorts live and the verifier evaluates: the
    GPU unless the caller passes ``"cpu"``; every cohort must be on it.
    """
    device = resolve_device(device)
    for pop in cohorts:
        if pop.device != device:
            raise ValueError(f"cohort {pop.model.name} lives on {pop.device}, "
                             f"the exchange runs on {device}")
    cfg = cfg or ExchangeConfig()
    applies = {pop.model.name: pop.model.apply for pop in cohorts}
    if continuum is None:
        ledger = ledger if ledger is not None else IncentiveLedger()
        if regions > 0:
            from repro_torch.runtime.topology import build_hierarchical_continuum

            continuum = build_hierarchical_continuum(
                regions, total_edges=max(edges, regions), ledger=ledger,
                faults=faults,
            )
        else:
            continuum = Continuum(ledger=ledger, faults=faults)
            for e in range(edges):
                continuum.add_edge_server(f"edge{e:03d}")
    elif ledger is not None and continuum.ledger is not ledger:
        raise ValueError("pass ledger or a continuum that already has one")
    elif faults is not None and continuum.faults is not faults:
        raise ValueError("pass faults or a continuum built with that plan")
    if faults is None:
        # a faults-built continuum passed without repeating faults= must
        # still drive churn: the continuum's plan is the plan
        faults = continuum.faults
    if (faults is not None and faults.byzantine_frac > 0
            and continuum.verifier is None):
        # byzantine containment is the feature's headline guarantee: a
        # caller-supplied faulted continuum gets the same verify-on-fetch
        # defence the self-built path wires (unless it brought its own)
        continuum.verifier = make_verifier(applies, eval_x, eval_y, device)
    if availabilities is None and faults is not None and faults.churn > 0:
        availabilities = [faults.cohort_availability(pop.num_parties, k)
                          for k, pop in enumerate(cohorts)]

    actors = []
    for k, pop in enumerate(cohorts):
        avail = availabilities[k] if availabilities is not None else None
        actor = CohortExchangeActor(
            pop, continuum, eval_x, eval_y, cfg=cfg,
            teacher_applies=applies, availability=avail, on_cycle=on_cycle,
        )
        actor.start(continuum.loop, at=0.0)
        actors.append(actor)
    continuum.loop.run_to_quiescence()
    for actor in actors:
        actor.integrate_stragglers()

    if continuum.ledger is not None:
        continuum.ledger.assert_conserved()
    all_stats = sorted(
        (s for a in actors for s in a.stats),
        key=lambda s: (s.cycle, s.cohort),
    )
    topo_report = {}
    if continuum.topology is not None:
        topo_report = continuum.topology.totals().as_dict()
        topo_report["regions"] = len(continuum.topology)
        topo_report["hit_rate"] = continuum.topology.hit_rate()
    return ExchangeReport(
        cycles=all_stats,
        ledger=(continuum.ledger.distribution()
                if continuum.ledger is not None else {}),
        sim_time_s=continuum.clock.now(),
        events=continuum.loop.events_processed,
        cards=len(continuum.discovery),
        traffic=continuum.traffic.as_dict(),
        faults=continuum.fault_stats.as_dict(),
        topology=topo_report,
    )
