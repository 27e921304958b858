"""Model discovery service (paper §IV — "the key innovation").

Cloud-hosted registry over all vault cards.  Learners submit a
:class:`ModelQuery` describing the qualities they need ("a classifier for
task T with >=90% accuracy on class D"); the service matches, ranks, and
returns candidates WITHOUT involving any other learner — which is exactly
how the design sidesteps client heterogeneity.

Ranking = hard-constraint filter + weighted score over
(requested-class accuracies, overall accuracy, freshness, model size).

Scale: cards are held in a per-task inverted index whose buckets are kept
sorted by descending overall accuracy.  A query therefore (a) only touches
its task's bucket, (b) stops at the first card below ``min_accuracy``, and
(c) stops as soon as the current top-k floor exceeds the best score any
remaining (lower-accuracy) card could still reach — so query cost is
bounded by the qualifying prefix, not the registry size.  Freshness uses an
injected simulated clock (see :mod:`repro_torch.runtime.clock`), never
``time.time()``.
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.vault import ModelCard, ModelVault
from repro_torch.runtime.clock import SimClock

# Score decomposition bounds used for candidate pruning (see _score):
# beyond the 2*accuracy term, a card can gain at most 1.0 per requested
# class plus the 0.1 freshness cap; the size penalty only lowers the score.
_FRESHNESS_CAP = 0.1


@dataclasses.dataclass
class ModelQuery:
    """What a learner needs: task + quality constraints over model cards."""

    task: str
    min_accuracy: float = 0.0
    min_class_accuracy: Dict[int, float] = dataclasses.field(default_factory=dict)
    arch: Optional[str] = None  # constrain architecture family if set
    max_params: Optional[int] = None
    exclude_owners: Tuple[str, ...] = ()
    # cross-architecture distillation only needs the logit spaces to match
    # (paper §IV); cards advertising a different logit_dim are filtered out.
    # Cards that do not advertise one are assumed compatible.
    logit_dim: Optional[int] = None


@dataclasses.dataclass
class DiscoveryResult:
    """One ranked match: the card, the vault serving it, and its score."""

    card: ModelCard
    vault_id: str
    score: float


class DiscoveryService:
    """Registry + matchmaking over model cards (not blobs — cards only)."""

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self._cards: Dict[str, Tuple[ModelCard, str]] = {}
        # task -> list of (-accuracy, model_id), kept sorted (= accuracy desc)
        self._by_task: Dict[str, List[Tuple[float, str]]] = {}
        self._vaults: Dict[str, ModelVault] = {}
        self._clock = clock if clock is not None else SimClock()
        self.stats = {"queries": 0, "hits": 0, "fetches": 0, "scanned": 0}
        # model_id -> accumulated staleness penalty, subtracted from every
        # query score.  Penalties only ever *lower* a score, so the top-k
        # pruning bound (2*acc + bonus_cap) stays a valid upper bound.
        self._stale: Dict[str, float] = {}

    def __len__(self) -> int:
        return len(self._cards)

    def set_clock(self, clock: Callable[[], float]):
        """Rebind the freshness clock; only legal while nothing is indexed.

        Cards are scored against this clock's notion of "now" — rebinding
        after registration would score existing ``created_at`` stamps
        against a different timeline.
        """
        if self._cards:
            raise ValueError("cannot rebind the clock of a discovery "
                             "service that already indexed cards")
        self._clock = clock

    def attach_vault(self, vault: ModelVault):
        """Make a vault fetchable and index every card it already holds."""
        self._vaults[vault.vault_id] = vault
        for card in vault.cards():
            self.register(card, vault.vault_id)

    @staticmethod
    def _acc_key(card: ModelCard) -> Tuple[float, str]:
        return (-card.metrics.get("accuracy", 0.0), card.model_id)

    def register(self, card: ModelCard, vault_id: str):
        """Index a card (replacing any previous version of the model)."""
        if vault_id not in self._vaults:
            raise KeyError(f"unknown vault {vault_id}")
        prev = self._cards.get(card.model_id)
        if prev is not None:
            old_bucket = self._by_task[prev[0].task]
            old_key = self._acc_key(prev[0])
            i = bisect.bisect_left(old_bucket, old_key)
            if i < len(old_bucket) and old_bucket[i] == old_key:
                old_bucket.pop(i)
        self._cards[card.model_id] = (card, vault_id)
        bisect.insort(self._by_task.setdefault(card.task, []), self._acc_key(card))
        # a (re-)listed card is fresh: any staleness penalty is cleared
        # (restale() re-applies its penalty after registering)
        self._stale.pop(card.model_id, None)

    def deregister(self, model_id: str) -> bool:
        """Drop a card from the registry (e.g. caught advertising inflated
        metrics by verify-on-fetch).  Returns False if it was not listed."""
        prev = self._cards.pop(model_id, None)
        if prev is None:
            return False
        self._stale.pop(model_id, None)
        bucket = self._by_task[prev[0].task]
        key = self._acc_key(prev[0])
        i = bisect.bisect_left(bucket, key)
        if i < len(bucket) and bucket[i] == key:
            bucket.pop(i)
        return True

    def restale(self, model_id: str, accuracy: float,
                staleness: float = 0.0) -> Optional[ModelCard]:
        """Re-rank a card against a drifted world: honest accuracy + penalty.

        Concept drift makes a card's *claimed* accuracy stale; the scenario
        layer re-measures it on the current data and calls this with the
        new measurement.  The card re-registers under the re-measured
        accuracy (so the accuracy-sorted bucket — and the ``min_accuracy``
        early-exit — stay honest) and ``staleness`` accumulates as a score
        penalty that keeps demoting the card in ranking even against
        equally-accurate fresh cards.  Returns the re-indexed card, or
        ``None`` if the model was not listed.
        """
        prev = self._cards.get(model_id)
        if prev is None:
            return None
        card, vault_id = prev
        metrics = dict(card.metrics)
        metrics["accuracy"] = float(accuracy)
        restaled = dataclasses.replace(card, metrics=metrics)
        prior = self._stale.get(model_id, 0.0)  # register() clears it
        self.register(restaled, vault_id)
        if staleness:
            self._stale[model_id] = prior + float(staleness)
        return restaled

    def deregister_task(self, task: str) -> List[str]:
        """Drop every card listed under ``task`` (task retirement).

        A retired task leaves the market: its whole index bucket empties
        in one sweep.  Returns the model ids dropped, sorted.
        """
        doomed = sorted(mid for _neg, mid in self._by_task.get(task, ()))
        for mid in doomed:
            self.deregister(mid)
        self._by_task.pop(task, None)
        return doomed

    def deregister_owner(self, owner: str) -> List[str]:
        """Drop every card published by ``owner`` (party retirement).

        Returns the model ids dropped, sorted — retiring a party removes
        its listings from the market; the blobs stay in their vaults but
        are no longer discoverable.
        """
        doomed = sorted(mid for mid, (card, _vid) in self._cards.items()
                        if card.owner == owner)
        for mid in doomed:
            self.deregister(mid)
        return doomed

    def detach_vault(self, vault_id: str) -> List[str]:
        """Forget a vault and deregister every card it was serving.

        Region draining: the drained edges' vaults disappear, so every
        listing that pointed at them must leave the index (the continuum
        migrates the blobs and re-registers under the new serving vault).
        Returns the model ids dropped, sorted.
        """
        self._vaults.pop(vault_id, None)
        doomed = sorted(mid for mid, (_card, vid) in self._cards.items()
                        if vid == vault_id)
        for mid in doomed:
            self.deregister(mid)
        return doomed

    def lookup(self, model_id: str) -> Optional[Tuple[ModelCard, str]]:
        """The indexed ``(card, serving vault id)`` for one model, or None.

        Point lookup by id — no ranking, no stats.  The serving tier's
        placement reviewer uses this to locate a hot model's blob without
        re-running discovery.
        """
        return self._cards.get(model_id)

    def entries(self) -> List[Tuple[ModelCard, str]]:
        """Every indexed ``(card, serving vault id)``, model-id-sorted.

        The snapshot layer's export: together with the vault entries this
        is the full discoverable state of the index.
        """
        return [self._cards[mid] for mid in sorted(self._cards)]

    # -- matching -----------------------------------------------------------
    def _satisfies(self, card: ModelCard, q: ModelQuery) -> bool:
        if card.task != q.task:
            return False
        if q.arch and card.arch != q.arch:
            return False
        if card.owner in q.exclude_owners:
            return False
        m = card.metrics
        if m.get("accuracy", 0.0) < q.min_accuracy:
            return False
        if q.min_class_accuracy:  # skip the per-card dict rebuild otherwise
            per_class = {int(k): v
                         for k, v in m.get("per_class", {}).items()}
            for cls, need in q.min_class_accuracy.items():
                if per_class.get(int(cls), 0.0) < need:
                    return False
        if q.max_params is not None and card.num_params > q.max_params:
            return False
        if q.logit_dim is not None:
            card_dim = m.get("logit_dim")
            if card_dim is not None and int(card_dim) != q.logit_dim:
                return False
        return True

    def _score(self, card: ModelCard, q: ModelQuery) -> float:
        m = card.metrics
        score = 2.0 * m.get("accuracy", 0.0)
        if q.min_class_accuracy:  # skip the per-card dict rebuild otherwise
            per_class = {int(k): v
                         for k, v in m.get("per_class", {}).items()}
            for cls in q.min_class_accuracy:
                score += per_class.get(int(cls), 0.0)
        # freshness bonus (decays over ~1 day of simulated time)
        age = max(self._clock() - card.created_at, 0.0)
        score += _FRESHNESS_CAP * (1.0 / (1.0 + age / 86400))
        # prefer smaller models at equal quality (cheaper to transfer/distill)
        score -= 1e-9 * card.num_params
        # accumulated drift staleness (see restale): penalty-only, so the
        # query pruning bounds above remain valid upper bounds
        score -= self._stale.get(card.model_id, 0.0)
        return score

    def query(self, q: ModelQuery, top_k: int = 3) -> List[DiscoveryResult]:
        """Top-k matches for a query, best score first (see module doc)."""
        self.stats["queries"] += 1
        if top_k <= 0:
            return []
        bonus_cap = len(q.min_class_accuracy) * 1.0 + _FRESHNESS_CAP
        # min-heap of (score, -order) keeps the k best seen so far; -order
        # makes earlier-scanned cards win score ties (matching stable sort).
        best: List[Tuple[float, int, DiscoveryResult]] = []
        for order, (neg_acc, model_id) in enumerate(self._by_task.get(q.task, ())):
            acc = -neg_acc
            if acc < q.min_accuracy:
                break  # accuracy-sorted: no later card can qualify
            if len(best) == top_k and best[0][0] >= 2.0 * acc + bonus_cap:
                break  # top-k floor already beats any remaining card's bound
            self.stats["scanned"] += 1
            card, vault_id = self._cards[model_id]
            if not self._satisfies(card, q):
                continue
            res = DiscoveryResult(card, vault_id, self._score(card, q))
            item = (res.score, -order, res)
            if len(best) < top_k:
                heapq.heappush(best, item)
            elif item > best[0]:
                heapq.heapreplace(best, item)
        out = [r for _, _, r in sorted(best, key=lambda e: (-e[0], -e[1]))]
        if out:
            self.stats["hits"] += 1
        return out

    def fetch(self, result: DiscoveryResult):
        """Fetch + integrity-verify the winning model from its vault."""
        self.stats["fetches"] += 1
        vault = self._vaults[result.vault_id]
        return vault.fetch(result.card.model_id)
