"""Deterministic fault injection for the event-driven continuum runtime.

The paper pitches the model-centric design at exactly the populations the
happy-path runtime never exercises: intermittent devices, lossy links, and
untrusted peers.  A :class:`FaultPlan` closes that gap — it is a *seeded,
declarative* description of everything that can go wrong in a run:

  churn       parties flip on/offline following the same two-state Markov
              traces the heterogeneity layer uses
              (:func:`repro_torch.heterogeneity.availability.markov_trace`)
  link loss   any scheduled transfer (publish blob/card, fetch download)
              can be dropped, delayed, or corrupted in flight
  stragglers  a fraction of parties compute and transfer uniformly slower
  byzantine   a fraction of publishers inflate their ``ModelCard`` accuracy
              (caught by the continuum's verify-on-fetch re-evaluation)
  regional    whole region subtrees go dark for a slot at a time
  outages     (hierarchical topologies): publishes into a dark region are
              lost, and every fetch through it — including cache hits —
              drops and refunds

Every decision is a pure function of ``(plan, decision key)``: outcomes are
drawn by hashing the plan seed with stable string keys (party ids, model
ids, simulated timestamps), never from mutable RNG state.  Two runs with
the same plan therefore make identical fault decisions even if the caller
interleaves queries differently — which is what makes recorded traces
replayable byte-for-byte (:mod:`repro_torch.runtime.trace`).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional

from repro_torch.core.vault import ModelCard
from repro_torch.heterogeneity.availability import AvailabilityTrace, markov_trace

# resolution of the hashed uniform draws (53 bits = full float mantissa)
_U_DENOM = float(1 << 53)
# rows in the shared churn trace; party ids hash onto rows, so any number of
# parties shares one (seeded) Markov trace matrix
_CHURN_ROWS = 256


def _stable_u01(seed: int, *key) -> float:
    """Uniform [0, 1) draw from sha256(seed, key) — order-independent."""
    text = repr((int(seed),) + tuple(str(k) for k in key))
    digest = hashlib.sha256(text.encode("utf-8")).digest()
    return (int.from_bytes(digest[:8], "big") >> 11) / _U_DENOM


@dataclasses.dataclass(frozen=True)
class LinkFault:
    """Outcome of one transfer's fault draw."""

    drop: bool = False
    corrupt: bool = False
    delay_factor: float = 1.0  # >= 1; multiplies the Link transfer time

    @property
    def clean(self) -> bool:
        """True when the transfer proceeds unharmed and on time."""
        return not self.drop and not self.corrupt and self.delay_factor == 1.0


@dataclasses.dataclass
class FaultPlan:
    """Seeded description of churn, link faults, stragglers, and byzantines.

    All probabilities are per-decision: ``drop_prob`` applies to each
    transfer, ``byzantine_frac``/``straggler_frac`` to each party (decided
    once per party id, stable for the whole run).
    """

    seed: int = 0
    # -- churn (device on/offline) -------------------------------------------
    churn: float = 0.0  # target mean fraction of parties offline
    churn_horizon: int = 64  # Markov trace length (slots); wraps around
    slot_len_s: float = 60.0  # simulated seconds per availability slot
    # -- link faults (per transfer) ------------------------------------------
    drop_prob: float = 0.0
    delay_prob: float = 0.0
    max_delay_factor: float = 4.0  # delays drawn uniformly in [1, max]
    corrupt_prob: float = 0.0  # in-flight payload corruption (downloads)
    # -- stragglers (per party) ----------------------------------------------
    straggler_frac: float = 0.0
    straggler_slowdown: float = 8.0  # compute + link slowdown factor
    # -- byzantine publishers (per party) ------------------------------------
    byzantine_frac: float = 0.0
    byzantine_inflation: float = 0.3  # claimed = min(0.99, true + inflation)
    verify_tolerance: float = 0.1  # claimed - measured > tol => fraud
    # -- regional outages (per region, per slot; hierarchical topologies) ----
    region_outage_prob: float = 0.0  # P(a region is dark in a given slot)
    region_slot_len_s: float = 300.0  # outage slot length (simulated s)

    def __post_init__(self):
        for name in ("churn", "drop_prob", "delay_prob", "corrupt_prob",
                     "straggler_frac", "byzantine_frac",
                     "region_outage_prob"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if self.max_delay_factor < 1.0 or self.straggler_slowdown < 1.0:
            raise ValueError("delay/slowdown factors must be >= 1")
        if self.region_slot_len_s <= 0.0:
            raise ValueError("region_slot_len_s must be positive")
        self._churn_trace: Optional[AvailabilityTrace] = None

    # -- serialization (for trace recordings) --------------------------------
    def to_dict(self) -> Dict:
        """All plan fields as a JSON-able dict (trace recordings)."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    @staticmethod
    def from_dict(d: Dict) -> "FaultPlan":
        """Rebuild a plan from :meth:`to_dict` output (missing keys
        default, so old recordings stay replayable)."""
        return FaultPlan(**d)

    # -- per-party decisions (stable for the whole run) ----------------------
    def is_byzantine(self, party_id: str) -> bool:
        """Does this party inflate its published cards? (Stable per id.)"""
        return (self.byzantine_frac > 0.0
                and _stable_u01(self.seed, "byz", party_id)
                < self.byzantine_frac)

    def is_straggler(self, party_id: str) -> bool:
        """Is this party uniformly slow? (Stable per id.)"""
        return (self.straggler_frac > 0.0
                and _stable_u01(self.seed, "straggler", party_id)
                < self.straggler_frac)

    def slowdown(self, party_id: str) -> float:
        """Compute/link slowdown factor for a party (1.0 = full speed)."""
        return self.straggler_slowdown if self.is_straggler(party_id) else 1.0

    # -- churn ---------------------------------------------------------------
    def _trace(self) -> AvailabilityTrace:
        if self._churn_trace is None:
            self._churn_trace = markov_trace(
                _CHURN_ROWS, horizon=self.churn_horizon, seed=self.seed,
                avail_mean=min(max(1.0 - self.churn, 1e-3), 1.0 - 1e-3),
            )
        return self._churn_trace

    def party_online(self, party_id: str, now: float) -> bool:
        """Is ``party_id`` online at simulated time ``now`` under churn?"""
        if self.churn <= 0.0:
            return True
        trace = self._trace()
        row = int(_stable_u01(self.seed, "churn-row", party_id) * _CHURN_ROWS)
        slot = int(now // self.slot_len_s) % trace.matrix.shape[1]
        return bool(trace.matrix[row % _CHURN_ROWS, slot])

    def cohort_availability(self, num_parties: int,
                            cohort: int = 0) -> Optional[AvailabilityTrace]:
        """Per-cycle availability matrix for a :class:`PartyPopulation`.

        Returns ``None`` when the plan has no churn, so callers can fall
        back to always-on behaviour without special-casing.
        """
        if self.churn <= 0.0:
            return None
        sub_seed = int(_stable_u01(self.seed, "cohort", cohort) * 2**31)
        return markov_trace(
            num_parties, horizon=self.churn_horizon, seed=sub_seed,
            avail_mean=min(max(1.0 - self.churn, 1e-3), 1.0 - 1e-3),
        )

    # -- regional outages ----------------------------------------------------
    def region_offline(self, region_id: str, now: float) -> bool:
        """Is a whole region subtree partitioned at simulated time ``now``?

        Decided per ``(region, slot)`` by the same seeded-hash draw as
        every other fault, so outages are deterministic and independent of
        query order.  The continuum consults this at publish initiation
        (the upload dies at the dark region's doorstep) and at fetch
        delivery time (in-flight downloads through a dark region are lost
        and refunded).
        """
        if self.region_outage_prob <= 0.0:
            return False
        slot = int(now // self.region_slot_len_s)
        return (_stable_u01(self.seed, "region-outage", region_id, slot)
                < self.region_outage_prob)

    # -- link faults ---------------------------------------------------------
    def link_fault(self, kind: str, *key) -> LinkFault:
        """Fault draw for one transfer, keyed by (kind, ids, sim time)."""
        if _stable_u01(self.seed, "drop", kind, *key) < self.drop_prob:
            return LinkFault(drop=True)
        corrupt = (kind == "fetch"
                   and _stable_u01(self.seed, "corrupt", kind, *key)
                   < self.corrupt_prob)
        delay = 1.0
        if _stable_u01(self.seed, "delay?", kind, *key) < self.delay_prob:
            u = _stable_u01(self.seed, "delay", kind, *key)
            delay = 1.0 + u * (self.max_delay_factor - 1.0)
        return LinkFault(corrupt=corrupt, delay_factor=delay)

    # -- byzantine card inflation --------------------------------------------
    def inflate_card(self, card: ModelCard) -> ModelCard:
        """The byzantine publisher's attack: advertise inflated accuracy."""
        metrics = dict(card.metrics)
        true_acc = float(metrics.get("accuracy", 0.0))
        metrics["accuracy"] = min(0.99, true_acc + self.byzantine_inflation)
        return dataclasses.replace(card, metrics=metrics)
