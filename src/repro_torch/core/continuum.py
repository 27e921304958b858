"""Edge-to-cloud continuum topology + communication cost model.

The paper's architecture (Fig. 2) spans three tiers:

  device tier  — learning parties (train locally, request models)
  edge tier    — edge servers hosting model vaults
  cloud tier   — the discovery & distillation service (cards only)

This module models the tiers and their links, and accounts the bytes/latency
of every MDD exchange — which lets the benchmarks compare MDD's
model-transfer traffic against FL's per-round update traffic (the paper's
"expensive communication" argument, quantified).

Since the event-driven refactor, every exchange is a *scheduled event* on a
shared :class:`~repro_torch.runtime.loop.EventLoop`: a publish is a device->edge
blob transfer followed by an edge->cloud card transfer, and the card only
becomes discoverable when the card transfer completes in simulated time.
The completion times come from the :class:`Link` cost model.  The classic
synchronous methods (``publish``, ``discover_and_fetch``) remain as thin
wrappers that schedule the events and run the loop to quiescence, so
single-threaded callers observe exactly the old behaviour.

Chaos runtime: pass ``faults`` (a :class:`~repro_torch.runtime.faults.FaultPlan`)
and every transfer is subject to seeded drop/delay/corruption, stragglers
transfer slower, and byzantine publishers' cards are inflated before they
reach the vault.  Pass ``verifier`` (``(params, card) -> measured accuracy
or None``) to enable verify-on-fetch: the device re-evaluates every
delivered model, and a card whose claimed accuracy exceeds the measurement
by more than the plan's tolerance is treated as fraud — the requester is
refunded, the card is deregistered from discovery, and the publisher's
minted rewards are slashed (see ``IncentiveLedger.on_fraud``).  All fault
outcomes are deterministic functions of the plan seed, so faulted runs
stay replayable.
"""
from __future__ import annotations

import bisect
import dataclasses
import enum
import hashlib
import warnings
from typing import TYPE_CHECKING, Callable, Dict, List, Optional

from repro_torch.checkpoint.serde import params_to_bytes
from repro_torch.core.discovery import DiscoveryService
from repro_torch.core.incentives import IncentiveLedger
from repro_torch.core.vault import ModelVault
from repro_torch.runtime.clock import SimClock
from repro_torch.runtime.loop import EventLoop

if TYPE_CHECKING:  # import cycle: runtime.faults/topology import core modules
    from repro_torch.runtime.faults import FaultPlan
    from repro_torch.runtime.topology import RegionalTopology


@dataclasses.dataclass
class Link:
    """One network hop's cost model: fixed latency + bandwidth-limited time."""

    bandwidth_mbps: float
    latency_ms: float

    def transfer_time(self, nbytes: int) -> float:
        """Simulated seconds to move ``nbytes`` over this link."""
        return self.latency_ms / 1e3 + nbytes * 8 / (self.bandwidth_mbps * 1e6)


# default tier links (edge access vs metro vs backbone)
DEVICE_TO_EDGE = Link(bandwidth_mbps=50.0, latency_ms=10.0)
EDGE_TO_CLOUD = Link(bandwidth_mbps=500.0, latency_ms=40.0)
DEVICE_TO_CLOUD = Link(bandwidth_mbps=20.0, latency_ms=60.0)


@dataclasses.dataclass
class EdgeServer:
    """An edge-tier server: hosts one model vault plus its uplink."""

    server_id: str
    vault: ModelVault
    link_up: Link = dataclasses.field(default_factory=lambda: EDGE_TO_CLOUD)


@dataclasses.dataclass
class TrafficLog:
    """Byte/time accounting over every simulated transfer.

    ``cloud_egress_bytes`` counts only the bytes that cross the
    edge↔cloud backbone (in a hierarchical topology: the region↔cloud
    hop); ``intra_region_bytes`` counts bytes served inside a region —
    the two numbers are what the hierarchy benchmark compares against the
    flat topology.
    """

    uploads_bytes: int = 0
    downloads_bytes: int = 0
    card_bytes: int = 0
    total_time_s: float = 0.0
    cloud_egress_bytes: int = 0
    intra_region_bytes: int = 0
    # request-plane token traffic (prompt + generated tokens) served by the
    # serving tier; model blobs pulled for replicas count in the fields above
    serve_bytes: int = 0

    def as_dict(self):
        """Plain-dict view for benchmark/report JSON."""
        return dataclasses.asdict(self)


@dataclasses.dataclass
class FaultStats:
    """What the fault plan actually did to this continuum's transfers."""

    dropped_publishes: int = 0  # blob or card transfer lost in flight
    dropped_fetches: int = 0  # paid download lost in flight (refunded)
    corrupted_fetches: int = 0  # delivered blob failed integrity (refunded)
    delayed_transfers: int = 0
    frauds_detected: int = 0  # verify-on-fetch caught an inflated card
    refunds: int = 0
    # hierarchical topology only: transfers lost because the requester's
    # whole region subtree was partitioned (paid fetches are refunded)
    regional_outage_drops: int = 0

    def as_dict(self):
        """Plain-dict view for benchmark/report JSON."""
        return dataclasses.asdict(self)


def _stable_bucket(party_id: str, n: int) -> int:
    """PYTHONHASHSEED-independent assignment (builtin hash() is salted)."""
    digest = hashlib.sha256(party_id.encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "big") % n


# -- the unified request/outcome envelope -------------------------------------

class OutcomeStatus(enum.Enum):
    """How one scheduled continuum operation ended.

    ``OK``       the operation succeeded; ``Outcome.payload`` carries the
                 result (the final card for a publish, the ``(params, card,
                 hit)`` triple for a fetch, a prediction for a served query).
    ``MISS``     a query nothing anywhere could satisfy (not a failure:
                 nothing was paid, nothing needs refunding).
    ``DENIED``   refused by the credit gate before any bytes moved.
    ``REFUSED``  refused by the membership gate (the party had retired).
    ``FAILED``   a started transfer was lost — ``Outcome.reason`` is one of
                 ``{"drop", "corrupt", "fraud", "outage"}`` — and any
                 payment was refunded (``Outcome.fee`` records it).
    """

    OK = "ok"
    MISS = "miss"
    DENIED = "denied"
    REFUSED = "refused"
    FAILED = "failed"


@dataclasses.dataclass(frozen=True)
class Outcome:
    """One completion envelope for every async continuum operation.

    Replaces the legacy ``on_done``/``on_fail``/``on_denied`` callback
    sprawl: pass ``on_complete`` to :meth:`Continuum.publish_async`,
    :meth:`Continuum.discover_and_fetch_async`, or the serving tier
    (:mod:`repro_torch.runtime.serving`) and receive exactly one ``Outcome`` at
    completion time.  ``fee`` is the operation's settlement record —
    ``paid``/``fee``/``region_cut`` for a gated transfer, plus
    ``refunded`` when a failure reversed it, or ``minted`` for a publish
    reward; empty for ungated operations.
    """

    status: OutcomeStatus
    time: float  # simulated completion time
    payload: object = None
    reason: Optional[str] = None
    fee: Dict = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        """True when the operation succeeded (``status is OK``)."""
        return self.status is OutcomeStatus.OK


def _warn_legacy(method: str) -> None:
    warnings.warn(
        f"the on_done/on_fail/on_denied callbacks of {method} are "
        f"deprecated; pass on_complete=(lambda outcome: ...) and branch on "
        f"outcome.status instead",
        DeprecationWarning, stacklevel=4,
    )


def _publish_completion(on_complete, on_done, on_fail):
    """Normalize publish callbacks into one ``emit(status, now, ...)`` fn.

    With ``on_complete``, every completion builds an :class:`Outcome`.
    The legacy pair maps OK -> ``on_done(final_card, now)`` and
    REFUSED/FAILED -> ``on_fail(now)`` — exactly the old behaviour, plus
    a :class:`DeprecationWarning` at call time.
    """
    if on_complete is not None:
        if on_done is not None or on_fail is not None:
            raise ValueError("pass on_complete or the legacy "
                             "on_done/on_fail callbacks, not both")

        def emit(status, now, payload=None, reason=None, fee=None):
            on_complete(Outcome(status, now, payload, reason, fee or {}))

        return emit
    if on_done is not None or on_fail is not None:
        _warn_legacy("publish_async")

    def emit(status, now, payload=None, reason=None, fee=None):
        if status is OutcomeStatus.OK:
            if on_done is not None:
                on_done(payload, now)
        elif on_fail is not None:
            on_fail(now)

    return emit


def _fetch_completion(on_complete, on_done, on_denied, on_fail):
    """Normalize fetch callbacks into one ``emit(status, now, ...)`` fn.

    Legacy mapping (the pre-Outcome contract, preserved exactly):
    OK -> ``on_done(hit, now)``; MISS -> ``on_done(None, now)``;
    DENIED/REFUSED -> ``on_denied(now)`` if given else ``on_done(None,
    now)``; FAILED -> ``on_fail(reason, now)`` if given else
    ``on_done(None, now)``.
    """
    if on_complete is not None:
        if (on_done is not None or on_denied is not None
                or on_fail is not None):
            raise ValueError("pass on_complete or the legacy "
                             "on_done/on_denied/on_fail callbacks, not both")

        def emit(status, now, payload=None, reason=None, fee=None):
            on_complete(Outcome(status, now, payload, reason, fee or {}))

        return emit
    if on_done is not None or on_denied is not None or on_fail is not None:
        _warn_legacy("discover_and_fetch_async")

    def emit(status, now, payload=None, reason=None, fee=None):
        if status is OutcomeStatus.OK:
            if on_done is not None:
                on_done(payload, now)
        elif status is OutcomeStatus.FAILED and on_fail is not None:
            on_fail(reason, now)
        elif (status in (OutcomeStatus.DENIED, OutcomeStatus.REFUSED)
                and on_denied is not None):
            on_denied(now)
        elif on_done is not None:
            on_done(None, now)

    return emit


class Continuum:
    """The assembled edge-to-cloud system: vaults on edges, discovery in cloud.

    All state shares one simulated clock; pass ``loop`` (or ``clock``) to
    embed the continuum in a larger simulation, or let it create its own.

    Pass ``ledger`` to make the exchange an economy (paper §IV incentive
    mechanisms): publishes mint rewards proportional to the card's measured
    accuracy, and fetches are credit-gated — a requester that cannot pay is
    refused before any blob moves, and each paid fetch transfers credits
    requester -> publisher (+ service fee -> the cloud operator account).
    Without a ledger (or when callers omit ``requester``) behaviour is the
    classic ungated exchange.

    Pass ``faults``/``verifier`` to run under the chaos fault model (see
    module docstring).  ``verifier`` re-measures a delivered model's
    accuracy; returning ``None`` skips the check (e.g. unknown arch).

    Attach a :class:`~repro_torch.runtime.topology.RegionalTopology` (via
    :meth:`attach_topology` or
    :func:`~repro_torch.runtime.topology.build_hierarchical_continuum`) to run
    the hierarchical edge→region→cloud tiering: queries resolve at the
    requester's region shard first and escalate to the cloud index only on
    a miss, in-region fetches are costed by the intra-region link (the
    region operator earning a share of the service fee), escalated blobs
    are cached in-region on arrival, and regional outages from the fault
    plan partition the whole subtree.  Without a topology every path below
    behaves exactly as the flat continuum.
    """

    def __init__(self, clock: Optional[SimClock] = None,
                 loop: Optional[EventLoop] = None,
                 ledger: Optional[IncentiveLedger] = None,
                 faults: Optional["FaultPlan"] = None,
                 verifier: Optional[Callable] = None):
        if loop is not None and clock is not None and loop.clock is not clock:
            raise ValueError("pass either clock or loop (or a loop built on "
                             "that clock); a loop brings its own clock")
        self.loop = loop if loop is not None else EventLoop(clock or SimClock())
        self.clock = self.loop.clock
        self.edges: Dict[str, EdgeServer] = {}
        self._edge_order: List[str] = []  # sorted edge ids, kept incrementally
        self.discovery = DiscoveryService(clock=self.clock)
        self.traffic = TrafficLog()
        self.ledger = ledger
        self.denied_fetches = 0
        self.faults = faults
        self.verifier = verifier  # property: assignment resets the memo
        self.fault_stats = FaultStats()
        self.topology: Optional["RegionalTopology"] = None
        # the attached request plane (a ServingTier registers itself here
        # so snapshot_world can serialize in-flight serving state)
        self.serving = None
        # the attached scenario-dynamics engine (a ScenarioEngine registers
        # itself here so restored scenario events find their handler)
        self.scenario = None
        # task lifecycle: tasks retired from the market by the scenario
        # layer, plus a counter for publishes refused into them
        self.retired_tasks: set = set()
        self.task_refusals = 0
        # cards already slashed, by (model_id, version): concurrent in-flight
        # fetches of one fraudulent card must not slash the publisher twice
        self._frauded: set = set()
        # elastic membership: explicitly admitted / retired party ids, plus
        # a counter for operations refused because the party had retired
        self.members: set = set()
        self.retired: set = set()
        self.membership_refusals = 0

    def attach_topology(self, topology: "RegionalTopology") -> None:
        """Install the region tier; must happen before edges are added.

        Region operator accounts are registered with the ledger up front
        so they can collect fee shares without ever minting a stipend, and
        the topology's shards/caches are rebound to this continuum's clock
        (a topology built without one would otherwise score freshness
        against a private clock frozen at zero).
        """
        if self.edges:
            raise ValueError("attach the topology before adding edge servers")
        if topology.clock is not self.clock:
            topology.rebind_clock(self.clock)
        self.topology = topology
        if self.ledger is not None:
            for region in topology.regions.values():
                self.ledger.add_operator(region.operator)

    def add_edge_server(self, server_id: str,
                        link_up: Optional[Link] = None,
                        region: Optional[str] = None) -> EdgeServer:
        """Create an edge server + vault and index it for discovery.

        With a topology attached, ``region`` names the region the edge
        belongs to (required) and the edge's vault is indexed by both the
        region's discovery shard and the cloud index.
        """
        vault = ModelVault(vault_id=server_id, clock=self.clock)
        edge = EdgeServer(server_id, vault)
        if link_up is not None:
            edge.link_up = link_up
        self.edges[server_id] = edge
        bisect.insort(self._edge_order, server_id)
        self.discovery.attach_vault(vault)
        if self.topology is not None:
            if region is None:
                raise ValueError("a hierarchical continuum needs a region "
                                 "for every edge server")
            self.topology.register_edge(region, server_id, vault)
        return edge

    def nearest_edge(self, party_id: str) -> EdgeServer:
        """Deterministic assignment of a party to its closest edge server.

        Hierarchical topologies bucket the party onto its home region
        first, then onto an edge within that region.
        """
        if self.topology is not None:
            return self.edges[self.topology.edge_for(party_id)]
        return self.edges[self._edge_order[_stable_bucket(party_id,
                                                          len(self._edge_order))]]

    # -- scheduled operations ------------------------------------------------
    def publish_async(self, party_id: str, params, card,
                      on_done: Optional[Callable] = None,
                      on_fail: Optional[Callable] = None, *,
                      on_complete: Optional[Callable] = None):
        """Device -> edge vault upload; card -> cloud index.

        The blob is stored (hashed, signed, versioned) at initiation; the
        card becomes *discoverable* only when the simulated device->edge and
        edge->cloud transfers complete.  Returns the final card immediately;
        ``on_complete(outcome)`` fires at completion time with one
        :class:`Outcome` envelope — status ``OK`` (payload: the final
        card, ``fee["minted"]``: the minted reward), ``FAILED`` (reason
        ``"drop"``/``"outage"``), or ``REFUSED`` (membership gate).

        The legacy ``on_done(final_card, sim_time)`` / ``on_fail(sim_time)``
        pair is deprecated (it maps onto the same envelope and warns); a
        call may pass either style, never both.

        Under a fault plan the transfer can be dropped (the failure fires
        at the time the loss is noticed; nothing reaches the edge — the
        vault keeps its previous entry and the returned card is the
        *unstored* one) or delayed, stragglers upload slower, and a
        byzantine publisher's card is inflated before it is stored.

        With a hierarchical topology the card hops edge→region (becoming
        locally discoverable in the region's shard) and then region→cloud
        (becoming globally discoverable; rewards mint there), and an
        upload into a region that is dark under the plan's regional-outage
        schedule is lost exactly like a link drop.

        A retired party (see :meth:`retire_party`) is refused before any
        bytes move: nothing is stored, the outcome is ``REFUSED``, and the
        refusal is counted in ``membership_refusals``.
        """
        emit = _publish_completion(on_complete, on_done, on_fail)
        if party_id in self.retired:
            self.membership_refusals += 1

            def publish_refused(now: float):
                emit(OutcomeStatus.REFUSED, now, reason="retired")

            self.loop.call_after(
                0.0, publish_refused,
                label=f"publish-retired {card.model_id}",
                payload={"op": "publish_retired", "party": party_id,
                         "model": card.model_id},
            )
            return card
        if card.task in self.retired_tasks:
            # the task left the market (scenario retirement): nothing is
            # stored and nothing mints — the publisher learns via REFUSED
            self.task_refusals += 1

            def publish_task_refused(now: float):
                emit(OutcomeStatus.REFUSED, now, reason="task_retired")

            self.loop.call_after(
                0.0, publish_task_refused,
                label=f"publish-task-retired {card.model_id}",
                payload={"op": "publish_task_retired", "party": party_id,
                         "model": card.model_id, "task": card.task},
            )
            return card
        edge = self.nearest_edge(party_id)
        region = (self.topology.region_of(party_id)
                  if self.topology is not None else None)
        faults = self.faults
        if faults is not None and faults.is_byzantine(party_id):
            card = faults.inflate_card(card)
        now0 = self.clock.now()
        if (faults is not None and region is not None
                and faults.region_offline(region.region_id, now0)):
            # the whole subtree is partitioned: the blob leaves the device
            # and dies at the dark region's doorstep; the vault keeps its
            # previous entry and the upload time is wasted
            nbytes = len(params_to_bytes(params))
            blob_t = (DEVICE_TO_EDGE.transfer_time(nbytes)
                      * faults.slowdown(party_id))
            self.fault_stats.regional_outage_drops += 1
            region.stats.outage_drops += 1
            self.traffic.uploads_bytes += nbytes
            self.traffic.total_time_s += blob_t

            def publish_outage(now: float):
                emit(OutcomeStatus.FAILED, now, reason="outage")

            self.loop.call_after(
                blob_t, publish_outage,
                label=f"publish-outage {card.model_id}",
                payload={"op": "publish_outage", "party": party_id,
                         "model": card.model_id,
                         "region": region.region_id},
            )
            return card
        fault = (faults.link_fault("publish", party_id, card.model_id, now0)
                 if faults is not None else None)
        if fault is not None and fault.drop:
            # the upload is lost in flight: the vault must keep its previous
            # entry (if any) — this version never reached the edge.  The
            # device still wastes the upload time before noticing the loss.
            nbytes = len(params_to_bytes(params))
            blob_t = (DEVICE_TO_EDGE.transfer_time(nbytes)
                      * faults.slowdown(party_id))
            self.fault_stats.dropped_publishes += 1
            self.traffic.uploads_bytes += nbytes
            self.traffic.total_time_s += blob_t

            def publish_dropped(now: float):
                emit(OutcomeStatus.FAILED, now, reason="drop")

            self.loop.call_after(
                blob_t, publish_dropped,
                label=f"publish-drop {card.model_id}",
                payload={"op": "publish_drop", "party": party_id,
                         "model": card.model_id},
            )
            return card
        final = edge.vault.store(params, card)
        nbytes = edge.vault.blob_size(final.model_id)
        blob_t = DEVICE_TO_EDGE.transfer_time(nbytes)
        card_bytes = len(final.to_json().encode())
        if region is not None:
            region_card_t = region.link_local.transfer_time(card_bytes)
            card_t = region.link_up.transfer_time(card_bytes)
        else:
            region_card_t = 0.0
            card_t = edge.link_up.transfer_time(card_bytes)
        if faults is not None:
            slow = faults.slowdown(party_id)
            blob_t *= slow
            card_t *= slow
            region_card_t *= slow
            if fault.delay_factor != 1.0:
                self.fault_stats.delayed_transfers += 1
                blob_t *= fault.delay_factor
                card_t *= fault.delay_factor
                region_card_t *= fault.delay_factor
        self.traffic.uploads_bytes += nbytes
        self.traffic.card_bytes += card_bytes
        self.traffic.cloud_egress_bytes += card_bytes
        self.traffic.total_time_s += blob_t + region_card_t + card_t

        def card_arrived(now: float):
            self.discovery.register(final, edge.server_id)
            fee = {}
            if self.ledger is not None:
                minted = self.ledger.on_publish(
                    party_id, float(final.metrics.get("accuracy", 0.0))
                )
                fee = {"minted": minted}
            emit(OutcomeStatus.OK, now, payload=final, fee=fee)

        if region is not None:
            self.traffic.intra_region_bytes += card_bytes

            def card_at_region(now: float):
                # locally discoverable as soon as the region shard has it;
                # the cloud index (and the publish reward) lag one hop
                region.shard.register(final, edge.server_id)
                self.loop.call_after(
                    card_t, card_arrived,
                    label=f"card->cloud {final.model_id}",
                    payload={"op": "card", "model": final.model_id,
                             "nbytes": card_bytes,
                             "region": region.region_id},
                )

            def blob_arrived(now: float):
                self.loop.call_after(
                    region_card_t, card_at_region,
                    label=f"card->region {final.model_id}",
                    payload={"op": "card_region", "model": final.model_id,
                             "nbytes": card_bytes,
                             "region": region.region_id},
                )
        else:
            def blob_arrived(now: float):
                self.loop.call_after(
                    card_t, card_arrived,
                    label=f"card->cloud {final.model_id}",
                    payload={"op": "card", "model": final.model_id,
                             "nbytes": card_bytes},
                )

        self.loop.call_after(
            blob_t, blob_arrived,
            label=f"publish {final.model_id} -> {edge.server_id}",
            payload={"op": "publish", "party": party_id,
                     "model": final.model_id, "nbytes": nbytes,
                     "edge": edge.server_id},
        )
        return final

    def discover_and_fetch_async(self, query, on_done: Optional[Callable] = None,
                                 top_k: int = 3,
                                 requester: Optional[str] = None,
                                 on_denied: Optional[Callable] = None,
                                 on_fail: Optional[Callable] = None, *,
                                 on_complete: Optional[Callable] = None):
        """Query cloud (cards only) then fetch the winning blob, as events.

        ``on_complete(outcome)`` fires once at completion time with one
        :class:`Outcome` envelope: ``OK`` (payload: the ``(params, card,
        result)`` triple; ``fee``: the payment record), ``MISS`` (no card
        matched), ``DENIED`` (credit gate), ``REFUSED`` (membership gate),
        or ``FAILED`` (reason in {"drop", "corrupt", "fraud", "outage"};
        ``fee`` records the refund).  The legacy
        ``on_done``/``on_denied``/``on_fail`` triple is deprecated (it
        maps onto the same envelope and warns); a call may pass either
        style, never both.

        With a ledger and a ``requester``, the fetch is credit-gated: an
        account that cannot cover the fetch cost is refused before the
        query even runs, and a successful fetch pays the publisher through
        the ledger.

        Under a fault plan, a *paid* download can still fail: dropped or
        corrupted in flight, delivered but caught by verify-on-fetch with
        inflated claimed accuracy (fraud), or — hierarchical topologies
        only — lost because the requester's region subtree was dark when
        the download would have completed (outage).  In every failure case
        the requester is refunded.

        With a topology attached the query resolves against the
        requester's region shard first (a hit is served in-region over the
        cheap links, splitting the service fee with the region operator)
        and escalates to the cloud index only on a shard miss; an
        escalated blob is inserted into the region cache on delivery so
        later requesters in the region hit locally.  Anonymous fetches
        (no ``requester``) have no home region and resolve directly at
        the cloud index with flat costing.
        """
        emit = _fetch_completion(on_complete, on_done, on_denied, on_fail)

        def failed(reason: str, now: float, publisher: str,
                   region_operator: Optional[str] = None):
            gated = self.ledger is not None and requester is not None
            fee = {}
            if gated:
                self.ledger.on_refund(requester, publisher,
                                      region_operator=region_operator)
                self.fault_stats.refunds += 1
                fee = self.ledger.fee_record(region_operator, refunded=True)
            emit(OutcomeStatus.FAILED, now, reason=reason, fee=fee)

        def do_query(now: float):
            if requester is not None and requester in self.retired:
                # retired parties are out of the exchange entirely: refused
                # before the credit gate, counted separately from denials
                self.membership_refusals += 1
                emit(OutcomeStatus.REFUSED, now, reason="retired")
                return
            gated = self.ledger is not None and requester is not None
            if gated and not self.ledger.can_fetch(requester):
                self.ledger.on_denied(requester)
                self.denied_fetches += 1
                emit(OutcomeStatus.DENIED, now, reason="credit")
                return
            if self.topology is not None and requester is not None:
                self._regional_fetch(query, emit, top_k, requester,
                                     failed, now, gated)
                return
            results = self.discovery.query(query, top_k=top_k)
            if not results:
                emit(OutcomeStatus.MISS, now)
                return
            best = results[0]
            # fetch first, pay after: an integrity failure in the vault
            # must not leave the requester charged for an undelivered model
            params, card = self.discovery.fetch(best)
            fee = {}
            if gated:
                self.ledger.on_fetch(requester, best.card.owner)
                fee = self.ledger.fee_record(None)
            nbytes = self.edges[best.vault_id].vault.blob_size(card.model_id)
            dl_t, fault = self._fetch_fault(
                DEVICE_TO_EDGE.transfer_time(nbytes), requester, card, now)
            # flat topology: discovery and routing are cloud-mediated, so
            # every fetched blob is accounted as backbone egress — this is
            # the baseline the hierarchy benchmark measures reduction from
            self.traffic.downloads_bytes += nbytes
            self.traffic.cloud_egress_bytes += nbytes
            self.traffic.total_time_s += dl_t
            self._schedule_fetch_outcome(dl_t, params, card, best, fault,
                                         failed, requester, nbytes, emit,
                                         fee=fee)

        self.loop.call_after(0.0, do_query, label=f"query task={query.task}",
                             payload={"op": "query", "task": query.task,
                                      "requester": requester})

    # -- download outcome machinery (shared by flat + hierarchical paths) ----
    def _fetch_fault(self, dl_t: float, requester: Optional[str], card, now):
        """Apply the plan's slowdown/delay to a download; (dl_t, fault)."""
        if self.faults is None:
            return dl_t, None
        if requester is not None:
            dl_t *= self.faults.slowdown(requester)
        fault = self.faults.link_fault(
            "fetch", requester or "anon", card.model_id, card.version, now)
        if fault.delay_factor != 1.0:
            self.fault_stats.delayed_transfers += 1
            dl_t *= fault.delay_factor
        return dl_t, fault

    def _schedule_fetch_outcome(self, dl_t, params, card, hit, fault, failed,
                                requester, nbytes, emit, *,
                                fee=None, region=None, region_operator=None,
                                local=None):
        """Schedule one (already paid-for) download's outcome events.

        Shared by the flat and hierarchical fetch paths so refund/fault
        semantics cannot diverge between them: in-flight drop/corruption,
        delivery-time regional-outage loss, verify-on-fetch fraud,
        region-cache seeding of escalated blobs, then the ``OK`` emit
        (``fee`` is the payment record attached to it).  Event labels are
        identical in both topologies; regional payloads carry extra
        ``region``/``local`` keys.
        """
        extra = {} if region is None else {"region": region.region_id}
        if fault is not None and fault.drop:
            self.fault_stats.dropped_fetches += 1
            self.loop.call_after(
                dl_t,
                lambda now2: failed("drop", now2, card.owner,
                                    region_operator),
                label=f"fetch-drop {card.model_id}",
                payload={"op": "fetch_drop", "requester": requester,
                         "model": card.model_id, **extra},
            )
            return
        if fault is not None and fault.corrupt:
            # in-flight corruption: the device-side integrity check
            # rejects the delivered blob (content hash mismatch)
            self.fault_stats.corrupted_fetches += 1
            self.loop.call_after(
                dl_t,
                lambda now2: failed("corrupt", now2, card.owner,
                                    region_operator),
                label=f"fetch-corrupt {card.model_id}",
                payload={"op": "fetch_corrupt", "requester": requester,
                         "model": card.model_id, **extra},
            )
            return

        def delivered(now2: float):
            if (region is not None and self.faults is not None
                    and self.faults.region_offline(region.region_id, now2)):
                # the subtree went dark while the download was in flight:
                # every fetch through this region is lost, paid ones refund
                self.fault_stats.regional_outage_drops += 1
                region.stats.outage_drops += 1
                self.loop.call_after(
                    0.0,
                    lambda now3: failed("outage", now3, card.owner,
                                        region_operator),
                    label=f"fetch-outage {card.model_id}",
                    payload={"op": "fetch_outage", "requester": requester,
                             "model": card.model_id, **extra},
                )
                return
            fraud, claimed, measured = self._check_fraud(params, card)
            if fraud:
                self.loop.call_after(
                    0.0,
                    lambda now3: (self._punish_fraud(card),
                                  failed("fraud", now3, card.owner,
                                         region_operator)),
                    label=f"fraud {card.model_id}",
                    payload={"op": "fraud", "publisher": card.owner,
                             "model": card.model_id,
                             "claimed": claimed, "measured": measured,
                             **extra},
                )
                return
            if region is not None and local is False:
                region.cache_blob(params, card)
            emit(OutcomeStatus.OK, now2, payload=(params, card, hit),
                 fee=fee or {})

        payload = {"op": "fetch", "requester": requester,
                   "model": card.model_id, "nbytes": nbytes,
                   "edge": hit.vault_id, **extra}
        if local is not None:
            payload["local"] = local
        self.loop.call_after(
            dl_t, delivered,
            label=f"fetch {card.model_id} <- {hit.vault_id}",
            payload=payload,
        )

    # -- hierarchical fetch path ---------------------------------------------
    def _regional_fetch(self, query, emit, top_k, requester, failed,
                        now, gated):
        """Region-first resolution of one (already credit-gated) fetch.

        A region-shard hit is served from an in-region vault (or the
        region cache) over the intra-region links, with the service fee
        split between cloud and region operator; a miss escalates to the
        cloud index, pays the backbone, and caches the blob in-region on
        delivery.  ``local_hits``/``escalations`` count resolutions that
        scheduled an actual download (a query nothing anywhere can satisfy
        counts as ``cloud_misses`` instead).  Either way the download is
        subject to the fault plan (drops, corruption, delays,
        verify-on-fetch) plus the regional outage schedule — see
        :meth:`_schedule_fetch_outcome`.
        """
        from repro_torch.runtime.topology import RegionalHit

        region = self.topology.region_of(requester)
        region.stats.queries += 1
        results = region.shard.query(query, top_k=top_k)
        local = bool(results)
        if local:
            best = results[0]
            params, card = region.shard.fetch(best)
            region_operator = region.operator
            region.stats.local_hits += 1
        else:
            results = self.discovery.query(query, top_k=top_k)
            if not results:
                region.stats.cloud_misses += 1
                emit(OutcomeStatus.MISS, now)
                return
            best = results[0]
            params, card = self.discovery.fetch(best)
            region_operator = None
            region.stats.escalations += 1
        fee = {}
        if gated:
            self.ledger.on_fetch(requester, card.owner,
                                 region_operator=region_operator)
            fee = self.ledger.fee_record(region_operator)
        if best.vault_id in self.edges:
            nbytes = self.edges[best.vault_id].vault.blob_size(card.model_id)
        else:  # served from the region cache
            nbytes = region.cache.blob_size(card.model_id)
        if local:
            dl_t = (region.link_local.transfer_time(nbytes)
                    + DEVICE_TO_EDGE.transfer_time(nbytes))
            self.traffic.intra_region_bytes += nbytes
        else:
            # remote edge -> cloud -> region -> device: the blob pays the
            # backbone once, then rides the cheap tiers down
            dl_t = (region.link_up.transfer_time(nbytes)
                    + region.link_local.transfer_time(nbytes)
                    + DEVICE_TO_EDGE.transfer_time(nbytes))
            self.traffic.cloud_egress_bytes += nbytes
        dl_t, fault = self._fetch_fault(dl_t, requester, card, now)
        self.traffic.downloads_bytes += nbytes
        self.traffic.total_time_s += dl_t
        hit = RegionalHit(card=card, vault_id=best.vault_id,
                          score=best.score, region_id=region.region_id,
                          local=local)
        self._schedule_fetch_outcome(dl_t, params, card, hit, fault, failed,
                                     requester, nbytes, emit, fee=fee,
                                     region=region,
                                     region_operator=region_operator,
                                     local=local)

    # -- verify-on-fetch -----------------------------------------------------
    @property
    def verifier(self):
        """The verify-on-fetch hook: ``(params, card) -> accuracy or None``."""
        return self._verifier

    @verifier.setter
    def verifier(self, fn):
        # a new verifier means a new eval set / new measurement semantics:
        # memoized measurements from the old one are invalid
        self._verifier = fn
        self._verify_memo: Dict[tuple, Optional[float]] = {}

    def _check_fraud(self, params, card):
        """Re-evaluate a delivered model against its card's claim.

        Returns ``(fraud, claimed, measured)``; ``measured`` is ``None``
        when no verifier is wired or it cannot evaluate the architecture.

        Measurements are memoized on the *content hash of the delivered
        params* plus the card identity: discovery's top-k ranking
        concentrates fetches on a few popular teachers, so without the
        memo every delivery of the same blob re-runs the eval — the
        verify-on-fetch hotspot.  Because the key covers the delivered
        *bytes* (not just the card), a tampered blob replayed under a
        known card hashes differently and gets its own, honest
        measurement; swapping the ``verifier`` (new eval set) clears the
        memo.
        """
        claimed = float(card.metrics.get("accuracy", 0.0))
        if self._verifier is None:
            return False, claimed, None
        key = (hashlib.sha256(params_to_bytes(params)).hexdigest(),
               card.model_id, card.version, card.arch)
        if key in self._verify_memo:
            measured = self._verify_memo[key]
        else:
            measured = self._verifier(params, card)
            self._verify_memo[key] = measured
        if measured is None:
            return False, claimed, None
        tol = (self.faults.verify_tolerance if self.faults is not None
               else 0.05)
        return claimed - float(measured) > tol, claimed, float(measured)

    def verify_delivery(self, params, card):
        """Re-measure a delivered model before trusting it (public hook).

        The serving tier calls this before installing a replica; fetch
        paths call it internally at delivery time.  Returns ``(fraud,
        claimed, measured)`` — see :meth:`_check_fraud` for memoization
        semantics.  A caller that gets ``fraud=True`` should hand the card
        to :meth:`punish_fraud` and refund whoever paid.
        """
        return self._check_fraud(params, card)

    def punish_fraud(self, card) -> None:
        """Contain a card verify-on-fetch caught inflated (public hook).

        Deregisters it from the cloud index and every region shard and
        slashes its publisher once; safe to call from outside the fetch
        path (the serving tier uses it when a replica install catches an
        inflated card).
        """
        self._punish_fraud(card)

    def _punish_fraud(self, card):
        """Deregister the inflated card; slash its publisher once.

        In a hierarchical topology the card is purged from every region
        shard too (cached copies of a fraudulent model must not keep
        serving after the cloud index drops it).
        """
        self.fault_stats.frauds_detected += 1
        self.discovery.deregister(card.model_id)
        if self.topology is not None:
            self.topology.deregister_everywhere(card.model_id)
        key = (card.model_id, card.version)
        if key in self._frauded:
            return
        self._frauded.add(key)
        if self.ledger is not None:
            self.ledger.on_fraud(card.owner)

    # -- elastic membership --------------------------------------------------
    def _schedule_membership(self, op: str, fields: Dict, delay: float,
                             label: str) -> Dict:
        """Schedule a membership event with a *durable* payload.

        The payload carries everything needed to re-execute the event
        (``durable: "membership"``), so a snapshot taken while it is
        still pending can persist it and a restore can reschedule it via
        :meth:`membership_handler` — closures never need to survive the
        process boundary.
        """
        payload = {"op": op, "durable": "membership", **fields}
        self.loop.call_after(
            delay, lambda now: self.membership_handler(payload),
            label=label, payload=payload,
        )
        return payload

    def membership_handler(self, payload: Dict) -> None:
        """Execute one durable membership payload (also the restore path).

        Dispatches on ``payload["op"]``: ``admit`` / ``retire`` /
        ``add_region`` / ``drain_region``.  Pure function of the payload
        plus current world state, so replaying a restored frontier event
        has exactly the effect the pre-snapshot schedule would have had.
        """
        op = payload["op"]
        if op == "admit":
            self._apply_admit(payload["party"])
        elif op == "retire":
            self._apply_retire(payload["party"])
        elif op == "add_region":
            self._apply_add_region(payload["region"], payload["n_edges"])
        elif op == "drain_region":
            self._apply_drain_region(payload["region"])
        else:
            raise ValueError(f"unknown membership op {op!r}")

    def admit_party(self, party_id: str, delay: float = 0.0) -> None:
        """Schedule a party's admission to the exchange.

        At fire time the party's ledger account opens (minting the
        cold-start stipend) and the id joins ``members``.  Placement
        needs no bookkeeping — party→region→edge assignment is a pure
        sha256 function of the id and the current topology shape.
        Retired ids cannot be re-admitted: their balance was escrowed
        and their listings purged; a fresh identity must join instead.
        """
        if party_id in self.retired:
            raise ValueError(f"{party_id!r} was retired; re-admission is "
                             "not supported (join with a fresh identity)")
        self._schedule_membership("admit", {"party": party_id}, delay,
                                  f"admit {party_id}")

    def retire_party(self, party_id: str, delay: float = 0.0) -> None:
        """Schedule a party's retirement from the exchange.

        At fire time the party's listings are deregistered from the cloud
        index and every region shard (blobs stay in their vaults but stop
        being discoverable), its remaining balance escrows to its region
        operator (the cloud operator in a flat topology) — a zero-sum
        transfer, so ``sum(balances) == minted`` holds across the event —
        and future publishes/fetches by the id are refused.
        """
        if party_id in self.retired:
            raise ValueError(f"{party_id!r} is already retired")
        self._schedule_membership("retire", {"party": party_id}, delay,
                                  f"retire {party_id}")

    def add_region(self, region_id: str, n_edges: int = 1,
                   delay: float = 0.0) -> None:
        """Schedule a new region (with ``n_edges`` edge servers) to join.

        At fire time the region is added to the topology (re-homing the
        parties whose stable bucket lands on the grown region list), its
        operator account registers with the ledger, and edge servers
        ``edge:<region>:<ee>`` come up wired into both the region shard
        and the cloud index.
        """
        if self.topology is None:
            raise ValueError("add_region needs a hierarchical topology")
        if region_id in self.topology.regions:
            raise ValueError(f"region {region_id!r} already exists")
        if n_edges < 1:
            raise ValueError(f"a region needs at least one edge server, "
                             f"got {n_edges}")
        self._schedule_membership(
            "add_region", {"region": region_id, "n_edges": n_edges}, delay,
            f"add-region {region_id}",
        )

    def drain_region(self, region_id: str, delay: float = 0.0) -> None:
        """Schedule a region's drain (graceful decommission).

        At fire time every model the cloud index serves from the region's
        edge vaults migrates (``store_copy`` — identity preserved) to the
        owner's new home edge in the surviving topology and re-registers
        there; the region's edges and caches are torn down, its operator
        account's balance escrows to the cloud operator, and placement
        re-homes over the shrunk region list.  The last region cannot be
        drained.

        Existence is checked at *fire* time, not here: the membership
        plane is asynchronous, so the region may be created by an
        ``add_region`` event that is still pending when the drain is
        scheduled.
        """
        if self.topology is None:
            raise ValueError("drain_region needs a hierarchical topology")
        self._schedule_membership("drain_region", {"region": region_id},
                                  delay, f"drain-region {region_id}")

    def _apply_admit(self, party_id: str) -> None:
        if party_id in self.retired:  # retired after scheduling: refuse
            self.membership_refusals += 1
            return
        self.members.add(party_id)
        if self.ledger is not None:
            self.ledger.balance(party_id)  # opens account, mints stipend

    def _apply_retire(self, party_id: str) -> None:
        if party_id in self.retired:  # idempotent under event races
            return
        self.retired.add(party_id)
        self.members.discard(party_id)
        self.discovery.deregister_owner(party_id)
        if self.topology is not None:
            for rid in sorted(self.topology.regions):
                self.topology.regions[rid].shard.deregister_owner(party_id)
        if self.ledger is not None:
            if self.topology is not None:
                beneficiary = self.topology.region_of(party_id).operator
            else:
                beneficiary = self.ledger.operator
            self.ledger.on_retire(party_id, beneficiary)

    def _apply_add_region(self, region_id: str, n_edges: int) -> None:
        region = self.topology.add_region(region_id)
        if self.ledger is not None:
            self.ledger.add_operator(region.operator)
        for e in range(n_edges):
            self.add_edge_server(f"edge:{region_id}:{e:02d}",
                                 region=region_id)

    def _apply_drain_region(self, region_id: str) -> None:
        topo = self.topology
        region = topo.regions[region_id]
        doomed = sorted(region.edge_ids)
        doomed_set = set(doomed)
        # models the cloud index serves from this region's vaults must
        # survive the drain: pull their params out before teardown
        moves = []
        for card, vid in self.discovery.entries():
            if vid in doomed_set:
                params, _card = self.edges[vid].vault.fetch(card.model_id)
                moves.append((card, params))
        for vid in doomed:
            self.discovery.detach_vault(vid)
            del self.edges[vid]
            self._edge_order.remove(vid)
        if self.ledger is not None:
            self.ledger.on_retire(region.operator, self.ledger.operator)
        topo.remove_region(region_id)
        # re-home each surviving model onto its owner's new nearest edge;
        # store_copy preserves version/created_at so verify-on-fetch
        # memoization and freshness ranking see the same identity
        for card, params in moves:
            home = self.nearest_edge(card.owner)
            stored = home.vault.store_copy(params, card)
            self.discovery.register(stored, home.server_id)
            topo.region_of(card.owner).shard.register(stored,
                                                      home.server_id)

    # -- synchronous wrappers (classic API) ----------------------------------
    def publish(self, party_id: str, params, card):
        """Schedule a publish and run the event loop to quiescence."""
        final = self.publish_async(party_id, params, card)
        self.loop.run_to_quiescence()
        return final

    def discover_and_fetch(self, query, top_k: int = 3,
                           requester: Optional[str] = None):
        """Schedule discover+fetch and run the event loop to quiescence."""
        box = {}

        def done(outcome):
            box["hit"] = outcome.payload if outcome.ok else None

        self.discover_and_fetch_async(query, on_complete=done, top_k=top_k,
                                      requester=requester)
        self.loop.run_to_quiescence()
        return box.get("hit")

    # -- reporting -----------------------------------------------------------
    def timeline(self, last: Optional[int] = None):
        """The fired-event log (simulated-time timeline) as strings."""
        log = self.loop.log if last is None else self.loop.log[-last:]
        return [str(e) for e in log]
