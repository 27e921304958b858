"""Deterministic discrete-event loop driving the continuum.

Events are ``(time, seq, callback)`` entries in a binary heap; ``seq`` is a
monotone counter so same-time events fire in schedule order, which makes the
whole simulation a pure function of its inputs (same seeds -> identical
event log).  Actors are scheduled objects that get woken at a simulated
time, do work (publish, query, train), and return when they want to wake
next.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable, Dict, List, Optional, Protocol, runtime_checkable

from repro_torch.runtime.clock import SimClock


@runtime_checkable
class Actor(Protocol):
    """Anything the event loop can wake.

    ``on_wake(now)`` performs the actor's next action and returns the delay
    (seconds of simulated time) until it wants to be woken again, or ``None``
    when the actor is finished.
    """

    def on_wake(self, now: float) -> Optional[float]:
        """Do the actor's next action; return the next wake delay."""
        ...


@dataclasses.dataclass(frozen=True)
class EventRecord:
    """One fired event, kept in the loop's log for timelines/debugging.

    ``payload`` is an optional dict of JSON-able structured data attached at
    schedule time (operation kind, party/model ids, byte counts, fault
    outcomes); :mod:`repro_torch.runtime.trace` serializes it canonically so a
    whole run can be recorded, replayed, and byte-compared.
    """

    time: float
    seq: int
    label: str
    payload: Optional[Dict] = None

    def __str__(self) -> str:
        return f"[t={self.time:10.3f}s #{self.seq:06d}] {self.label}"


class EventLoop:
    """Priority-queue event loop over a :class:`SimClock`."""

    def __init__(self, clock: Optional[SimClock] = None, keep_log: bool = True):
        self.clock = clock or SimClock()
        self._heap: List = []  # (time, seq, label, callback, payload)
        self._seq = 0
        self._cancelled: set = set()  # seqs of cancelled pending events
        self.keep_log = keep_log
        self.log: List[EventRecord] = []
        self.events_processed = 0

    # -- scheduling ----------------------------------------------------------
    def call_at(self, t: float, fn: Callable[[float], Any], label: str = "",
                payload: Optional[Dict] = None) -> int:
        """Schedule ``fn(now)`` at absolute simulated time ``t``.

        Returns a handle (the event's sequence number) accepted by
        :meth:`cancel`.
        """
        if t < self.clock.now():
            raise ValueError(
                f"cannot schedule in the past: {t} < {self.clock.now()}"
            )
        handle = self._seq
        heapq.heappush(self._heap, (t, handle, label, fn, payload))
        self._seq += 1
        return handle

    def call_after(self, delay: float, fn: Callable[[float], Any],
                   label: str = "", payload: Optional[Dict] = None) -> int:
        """Schedule ``fn(now)`` after ``delay`` simulated seconds.

        Returns a cancellation handle, as :meth:`call_at`.
        """
        return self.call_at(self.clock.now() + max(delay, 0.0), fn, label,
                            payload)

    def cancel(self, handle: int) -> None:
        """Cancel a pending event by its scheduling handle.

        Lazy removal: the entry stays in the heap but is skipped (and never
        logged) when it reaches the top.  Cancelling an event that already
        fired is a no-op — the handle is simply never seen again.  The
        serving tier uses this to collapse a slot's deadline-flush timer
        when the slot fills early.
        """
        self._cancelled.add(handle)

    def _skip_cancelled(self) -> None:
        while self._heap and self._heap[0][1] in self._cancelled:
            _, seq, _, _, _ = heapq.heappop(self._heap)
            self._cancelled.discard(seq)

    def add_actor(self, actor: Actor, start_at: float = 0.0,
                  label: str = "") -> None:
        """Schedule an actor's wake cycle starting at ``start_at``."""
        name = label or getattr(actor, "name", type(actor).__name__)

        def wake(now: float):
            delay = actor.on_wake(now)
            if delay is not None:
                self.call_after(delay, wake, label=name)

        self.call_at(start_at, wake, label=name)

    # -- snapshot/restore ----------------------------------------------------
    def frontier(self) -> List:
        """Pending (not yet fired) events as ``(t, seq, label, payload)``.

        Returned in firing order.  Callbacks are *not* included — they are
        closures; a snapshot can only persist events whose payload carries
        enough information to reconstruct the callback (see
        :mod:`repro_torch.runtime.snapshot`).  Cancelled-but-not-yet-skipped
        entries are excluded: they will never fire.
        """
        return [(t, seq, label, payload)
                for t, seq, label, _fn, payload in sorted(self._heap)
                if seq not in self._cancelled]

    def restore_event(self, t: float, seq: int, label: str,
                      fn: Callable[[float], Any],
                      payload: Optional[Dict] = None) -> None:
        """Re-insert a snapshotted pending event with its *original* seq.

        Unlike :meth:`call_at` this does not assign a fresh sequence
        number — byte-identical resume requires restored events to fire
        with the seq they were scheduled under before the snapshot.
        """
        heapq.heappush(self._heap, (t, seq, label, fn, payload))

    def restore_progress(self, seq: int, events_processed: int) -> None:
        """Restore the scheduling counters captured by a snapshot.

        ``seq`` is the next sequence number to assign; events scheduled
        after a restore must continue the pre-snapshot numbering or the
        resumed trace diverges from the uninterrupted run.
        """
        self._seq = seq
        self.events_processed = events_processed

    @property
    def next_seq(self) -> int:
        """The sequence number the next scheduled event would receive."""
        return self._seq

    # -- running -------------------------------------------------------------
    def step(self) -> bool:
        """Fire the single next event. Returns False when the queue is empty."""
        self._skip_cancelled()
        if not self._heap:
            return False
        t, seq, label, fn, payload = heapq.heappop(self._heap)
        self.clock.advance_to(t)
        if self.keep_log:
            self.log.append(EventRecord(t, seq, label, payload))
        self.events_processed += 1
        fn(t)
        return True

    def run_until(self, t_end: float) -> None:
        """Run every event scheduled at or before ``t_end``."""
        while True:
            self._skip_cancelled()
            if not self._heap or self._heap[0][0] > t_end:
                break
            self.step()
        if self.clock.now() < t_end:
            self.clock.advance_to(t_end)

    def run_to_quiescence(self, max_events: Optional[int] = None) -> int:
        """Drain the queue; returns the number of events fired."""
        fired = 0
        while self.step():
            fired += 1
            if max_events is not None and fired >= max_events:
                break
        return fired

    def __len__(self) -> int:
        return len(self._heap) - len(self._cancelled)
