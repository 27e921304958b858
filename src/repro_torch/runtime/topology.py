"""Hierarchical edge→region→cloud continuum topology.

The paper's architecture spans a *continuum*, not a two-point link: learning
parties sit behind edge servers, edge servers sit inside regional
aggregation points, and only the regions talk to the cloud backbone.  The
flat runtime collapses that into one cohort against a single
``"cloud"`` operator, so every discovery query and every fetched blob pays
full edge↔cloud cost.  This module restores the middle tier:

* a :class:`Region` groups a subset of edge servers and runs two pieces of
  region-local infrastructure — a **discovery shard** (a
  :class:`~repro_torch.core.discovery.DiscoveryService` over the region's own
  cards plus cached remote cards) and a **card/blob cache** (a
  :class:`~repro_torch.core.vault.ModelVault` holding copies of models fetched
  through the cloud), and
* a :class:`RegionalTopology` assigns parties and edges to regions with the
  same PYTHONHASHSEED-independent bucketing the flat continuum uses for
  party→edge placement, and aggregates locality statistics.

With a topology attached, :class:`~repro_torch.core.continuum.Continuum` resolves
queries *locally first*: a query that the requester's region shard can
satisfy is served from an in-region vault over the cheap intra-region link
and never touches the backbone; only a local miss escalates to the cloud
index, and the blob that comes back is inserted into the region cache so
the next requester in the region hits locally.  The region operator earns
a share of the service fee on every fetch it serves in-region — from its
edge vaults and its cache alike (see
:meth:`repro_torch.core.incentives.IncentiveLedger.on_fetch`) — which is what
pays for running the shard.

Cache copies are snapshots: a publisher's *new* version lands in the cloud
index immediately but a region cache keeps serving its copy until it is
evicted by a fraud deregistration — the usual staleness/locality trade of
hierarchical caching, measured (not hidden) by the freshness term in
discovery ranking.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.core.continuum import DEVICE_TO_EDGE, Link, _stable_bucket
from repro_torch.core.discovery import DiscoveryService
from repro_torch.core.vault import ModelVault
from repro_torch.runtime.clock import SimClock

# default tier links: the intra-region metro hop is an order of magnitude
# cheaper than the region<->cloud backbone hop
EDGE_TO_REGION = Link(bandwidth_mbps=200.0, latency_ms=15.0)
REGION_TO_CLOUD = Link(bandwidth_mbps=500.0, latency_ms=40.0)


@dataclasses.dataclass
class RegionalHit:
    """A discovery result resolved through the region tier.

    Drop-in for :class:`~repro_torch.core.discovery.DiscoveryResult` as the
    third element of a fetch hit, with the resolution path attached:
    ``local`` is True when the requester's region shard served the card
    (cache hit), False when the query escalated to the cloud index.
    """

    card: object
    vault_id: str
    score: float
    region_id: str
    local: bool


@dataclasses.dataclass
class RegionStats:
    """Locality counters for one region's discovery shard + cache.

    ``local_hits`` and ``escalations`` count resolutions that scheduled an
    actual (paid) download — served by the shard vs. by the cloud index;
    queries that nothing anywhere could satisfy count as ``cloud_misses``.
    """

    queries: int = 0  # queries first resolved against this shard
    local_hits: int = 0  # downloads served from an in-region vault/cache
    escalations: int = 0  # downloads served through the cloud index
    cloud_misses: int = 0  # shard miss and the cloud had nothing either
    cache_inserts: int = 0  # blobs cached after a cloud-path fetch
    # transfers (publish uploads + fetch downloads) lost to a dark subtree
    outage_drops: int = 0

    def as_dict(self) -> Dict:
        """Plain-dict view for benchmark/report JSON."""
        return dataclasses.asdict(self)


@dataclasses.dataclass
class RegionLoad:
    """One region's last *gossiped* serving-load report.

    The serving tier's placement review doubles as the gossip round: at
    every review each :class:`~repro_torch.runtime.serving.RegionServer`
    publishes its queue/slot occupancy as a ``load_report`` event and the
    applied report lands here (and in the tier's routing table).  Routing
    decisions between reviews therefore run on *stale-but-shared* load —
    the classic gossip trade — with a live admission check at the chosen
    target gating actual spillover (see ``ServingTier.spill_target``).

    ``models`` maps model id → queued + in-flight request count for that
    model on the region's server at report time.
    """

    time: float = 0.0
    queued: int = 0
    inflight: int = 0
    models: Dict[str, int] = dataclasses.field(default_factory=dict)

    def as_dict(self) -> Dict:
        """Plain-dict view (snapshot manifests, benchmark JSON)."""
        return dataclasses.asdict(self)


class Region:
    """One regional aggregation point: a discovery shard + a model cache.

    The shard indexes every card published through the region's edges plus
    every remote card cached after a cloud escalation; the cache vault
    holds the remote blobs themselves.  ``operator`` is the region's
    ledger account (``region:<id>``) — it collects the regional share of
    the service fee on every fetch the region serves locally.  ``load``
    is the region's last gossiped :class:`RegionLoad` serving report
    (zeroed until a serving tier's first placement review).
    """

    def __init__(self, region_id: str, clock: Optional[SimClock] = None,
                 link_up: Optional[Link] = None,
                 link_local: Optional[Link] = None):
        self.region_id = region_id
        self.link_up = link_up if link_up is not None else REGION_TO_CLOUD
        self.link_local = (link_local if link_local is not None
                           else EDGE_TO_REGION)
        self.shard = DiscoveryService(clock=clock)
        self.cache = ModelVault(vault_id=f"cache:{region_id}", clock=clock)
        self.shard.attach_vault(self.cache)
        self.edge_ids: List[str] = []
        self.operator = f"region:{region_id}"
        self.stats = RegionStats()
        self.load = RegionLoad()

    def cache_blob(self, params, card) -> None:
        """Insert a cloud-fetched model into the region cache + shard.

        The cached card keeps the remote publisher's identity — ``owner``,
        ``version``, and ``created_at`` are preserved, so the publisher is
        still the one paid on a later cache hit and verify-on-fetch verdict
        memoization stays keyed to the right blob.  Only the serving vault
        changes to the region cache.
        """
        stored = self.cache.store_copy(params, card)
        self.shard.register(stored, self.cache.vault_id)
        self.stats.cache_inserts += 1


class RegionalTopology:
    """The region tier: party→region→edge placement plus per-region infra.

    ``regions`` maps region id → :class:`Region`; parties bucket onto
    regions (and onto edges within their region) by the stable sha256
    bucketing the flat continuum already used, so placement is a pure
    function of the party id and the topology shape.
    """

    def __init__(self, n_regions: Optional[int] = None,
                 clock: Optional[SimClock] = None,
                 link_up: Optional[Link] = None,
                 link_local: Optional[Link] = None,
                 region_ids: Optional[Sequence[str]] = None):
        if (n_regions is None) == (region_ids is None):
            raise ValueError("pass exactly one of n_regions/region_ids")
        if region_ids is not None:
            ids = list(region_ids)
            if len(set(ids)) != len(ids):
                raise ValueError(f"duplicate region ids: {ids}")
        else:
            ids = [f"rg{r:03d}" for r in range(n_regions)]
        if not ids:
            raise ValueError("need at least one region")
        self.clock = clock
        self._link_up = link_up
        self._link_local = link_local
        self.regions: Dict[str, Region] = {}
        self._region_order: List[str] = []
        for rid in ids:
            self.regions[rid] = Region(rid, clock=clock, link_up=link_up,
                                       link_local=link_local)
            self._region_order.append(rid)
        self._region_order.sort()

    def rebind_clock(self, clock: SimClock) -> None:
        """Point every region's shard + cache at the continuum's clock.

        Region infrastructure must share the simulation clock or shard
        freshness ranking silently breaks (cards stamped by an advancing
        clock, scored against a frozen one).  Only legal while the
        topology is still empty — :meth:`Continuum.attach_topology` calls
        this before any edges or cards exist.
        """
        for region in self.regions.values():
            region.shard.set_clock(clock)
            region.cache.set_clock(clock)
        self.clock = clock

    def __len__(self) -> int:
        return len(self.regions)

    def region_ids(self) -> List[str]:
        """Sorted region ids — the deterministic placement order.

        The serving tier instantiates one :class:`RegionServer` per entry,
        so server iteration order is a pure function of the id set.
        """
        return list(self._region_order)

    def region_of(self, party_id: str) -> Region:
        """Deterministic assignment of a party to its home region."""
        idx = _stable_bucket(party_id, len(self._region_order))
        return self.regions[self._region_order[idx]]

    def edge_for(self, party_id: str) -> str:
        """The party's edge server: bucketed within its home region.

        The bucket is salted with the region id — parties that land in
        region ``r`` all satisfy ``hash(party) ≡ r (mod n_regions)``, so
        reusing the bare hash for the within-region bucket would pin them
        all onto ``r mod gcd(n_regions, n_edges)`` and leave the other
        edges idle.
        """
        region = self.region_of(party_id)
        if not region.edge_ids:
            raise LookupError(f"region {region.region_id} has no edge servers")
        idx = _stable_bucket(f"{region.region_id}/{party_id}",
                             len(region.edge_ids))
        return region.edge_ids[idx]

    def register_edge(self, region_id: str, server_id: str,
                      vault: ModelVault) -> Region:
        """Attach an edge server's vault to its region's discovery shard."""
        region = self.regions[region_id]
        region.edge_ids.append(server_id)
        region.edge_ids.sort()
        region.shard.attach_vault(vault)
        return region

    # -- elastic membership --------------------------------------------------
    def add_region(self, region_id: str) -> Region:
        """Grow the topology by one (empty) region.

        Placement is a pure function of the sorted region-id list, so
        adding a region deterministically re-homes the parties whose
        sha256 bucket lands on the grown list — the same ids always move,
        on every host, on every replay.  The new region shares the
        topology's clock and default links; the caller registers its
        operator account and edge servers.
        """
        if region_id in self.regions:
            raise ValueError(f"region {region_id!r} already exists")
        region = Region(region_id, clock=self.clock, link_up=self._link_up,
                        link_local=self._link_local)
        self.regions[region_id] = region
        bisect.insort(self._region_order, region_id)
        return region

    def remove_region(self, region_id: str) -> Region:
        """Drop a region from placement (the drain's final step).

        Returns the removed :class:`Region` so the caller can migrate or
        retire its contents; refuses to remove the last region (the
        topology would have nowhere to place anyone).
        """
        if region_id not in self.regions:
            raise KeyError(f"unknown region {region_id!r}")
        if len(self.regions) <= 1:
            raise ValueError("cannot remove the last region")
        region = self.regions.pop(region_id)
        self._region_order.remove(region_id)
        return region

    def deregister_everywhere(self, model_id: str) -> int:
        """Purge a card from every region shard (fraud containment).

        Returns how many shards actually held it.  The cloud index is
        deregistered separately by the continuum.
        """
        return sum(int(r.shard.deregister(model_id))
                   for r in self.regions.values())

    # -- aggregate reporting -------------------------------------------------
    def totals(self) -> RegionStats:
        """Sum of every region's locality counters."""
        agg = RegionStats()
        for r in self.regions.values():
            for f in dataclasses.fields(RegionStats):
                setattr(agg, f.name,
                        getattr(agg, f.name) + getattr(r.stats, f.name))
        return agg

    def hit_rate(self) -> float:
        """Fraction of scheduled downloads served in-region.

        Queries nothing anywhere could satisfy (``cloud_misses``) are not
        resolutions and do not enter the denominator.
        """
        t = self.totals()
        resolved = t.local_hits + t.escalations
        return t.local_hits / resolved if resolved else 0.0


def build_hierarchical_continuum(
    n_regions: int,
    edges_per_region: Optional[int] = None,
    *,
    total_edges: Optional[int] = None,
    ledger=None,
    faults=None,
    verifier=None,
    loop=None,
    clock=None,
    link_up: Optional[Link] = None,
    link_local: Optional[Link] = None,
    edge_link: Optional[Link] = None,
):
    """Assemble a :class:`~repro_torch.core.continuum.Continuum` with a region tier.

    Creates ``n_regions`` regions with edge ids ``edge:<region>:<ee>``,
    wires every edge vault into both its region shard and the cloud index,
    and registers every region operator account with the ledger (operators
    earn fee shares, never stipends).  Pass exactly one of
    ``edges_per_region`` (uniform) or ``total_edges`` (distributed as
    evenly as possible, earliest regions take the remainder; must be at
    least ``n_regions`` so every region has an edge).
    """
    from repro_torch.core.continuum import Continuum

    if (edges_per_region is None) == (total_edges is None):
        raise ValueError("pass exactly one of edges_per_region/total_edges")
    if edges_per_region is not None:
        counts = [edges_per_region] * n_regions
    else:
        if total_edges < n_regions:
            raise ValueError(f"total_edges={total_edges} leaves some of the "
                             f"{n_regions} regions without an edge server")
        base, extra = divmod(total_edges, n_regions)
        counts = [base + (1 if k < extra else 0) for k in range(n_regions)]
    cont = Continuum(clock=clock, loop=loop, ledger=ledger, faults=faults,
                     verifier=verifier)
    topo = RegionalTopology(n_regions, clock=cont.clock, link_up=link_up,
                            link_local=link_local)
    cont.attach_topology(topo)
    for rid, n_edges in zip(topo._region_order, counts):
        for e in range(n_edges):
            cont.add_edge_server(f"edge:{rid}:{e:02d}", link_up=edge_link,
                                 region=rid)
    return cont


__all__ = [
    "EDGE_TO_REGION", "REGION_TO_CLOUD", "DEVICE_TO_EDGE",
    "Region", "RegionLoad", "RegionStats", "RegionalHit",
    "RegionalTopology", "build_hierarchical_continuum",
]
