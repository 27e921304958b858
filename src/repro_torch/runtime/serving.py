"""Bucketed slot batching for serving (part of ``repro.runtime.serving``).

Only :func:`pick_bucket` and :class:`SlotQueue` are ported, copied as they
are: ``launch/serve.py`` batches its requests through them.  The
request-driven tier around them (``RegionServer``, ``ServingTier``,
placement, spillover, SLA fees and the ``serving_microworld`` golden) is
ROADMAP A8g.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


def pick_bucket(buckets: Sequence[int], n: int) -> int:
    """The smallest bucket that fits ``n`` tokens, else the largest.

    Prompts longer than every bucket are **truncated** to the largest
    bucket by the batching engine — the slot's fixed shape is the hard
    ceiling on prefill, so the overflow tokens are dropped, not padded
    away.  The server counts each such request in
    ``ServerStats.truncated_prompts`` (surfaced by
    ``ServingReport.as_dict``) and serves/charges for the truncated
    length.
    """
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class SlotQueue:
    """Bucketed queues feeding fixed-shape prefill/decode slots.

    Requests are keyed by ``(model, padded-length bucket)`` so one slot is
    always a single model at a single shape — the precondition for real
    batched prefill (one compiled program per bucket, no recompiles).
    ``add`` returns the chosen bucket and the queue depth after insertion
    so the caller can flush a slot the moment it fills; ``drain`` pops at
    most ``max_batch`` requests in queue order.

    Ordering is FIFO within an SLA tier; a higher-tier item jumps ahead of
    lower-tier items at insertion, but any single queued item can be
    overtaken at most ``bypass_limit`` times — a bounded bypass count, so
    priority traffic reorders the queue without ever starving it.
    """

    def __init__(self, buckets: Sequence[int], max_batch: int):
        if not buckets:
            raise ValueError("need at least one prompt bucket")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.buckets = tuple(sorted(buckets))
        self.max_batch = max_batch
        # each entry is [item, tier, overtaken-count]
        self._queues: Dict[Tuple[str, int], List[List]] = {}

    def add(self, key: str, prompt_len: int, item, tier: int = 0,
            bypass_limit: int = 0) -> Tuple[int, int]:
        """Queue one item; returns ``(bucket, depth after insertion)``.

        ``tier`` orders the insertion point (higher jumps ahead of lower);
        ``bypass_limit`` caps how many times any one queued item may be
        overtaken.  The defaults are plain FIFO.
        """
        bucket = pick_bucket(self.buckets, prompt_len)
        q = self._queues.setdefault((key, bucket), [])
        q.append([item, tier, 0])
        i = len(q) - 1
        while i > 0 and tier > q[i - 1][1] and q[i - 1][2] < bypass_limit:
            q[i - 1][2] += 1
            q[i], q[i - 1] = q[i - 1], q[i]
            i -= 1
        return bucket, len(q)

    def depth(self, key: str, bucket: int) -> int:
        """How many items are queued under ``(key, bucket)``."""
        return len(self._queues.get((key, bucket), ()))

    def drain(self, key: str, bucket: int) -> List:
        """Pop up to ``max_batch`` items from one queue, in queue order."""
        q = self._queues.get((key, bucket))
        if not q:
            return []
        slot = q[:self.max_batch]
        rest = q[self.max_batch:]
        if rest:
            self._queues[(key, bucket)] = rest
        else:
            del self._queues[(key, bucket)]
        return [e[0] for e in slot]

    def pending(self) -> List[Tuple[str, int]]:
        """Sorted ``(key, bucket)`` pairs with queued items."""
        return sorted(k for k, q in self._queues.items() if q)

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())
