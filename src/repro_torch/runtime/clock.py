"""Simulated clock for the discrete-event continuum runtime.

Every timestamp on the core MDD path (vault ``created_at``, discovery
freshness, link-transfer accounting) reads from a :class:`SimClock` instead
of ``time.time()``, so a run over 10k parties is (a) reproducible — the
clock only moves when the event loop moves it — and (b) free to simulate
hours of continuum activity in milliseconds of wall time.
"""
from __future__ import annotations


class SimClock:
    """Monotonic simulated time in seconds, advanced only by the event loop."""

    __slots__ = ("_now",)

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        """Current simulated time in seconds."""
        return self._now

    # Calling the clock is the injection protocol: anything that previously
    # called ``time.time()`` now calls ``clock()``.
    __call__ = now

    def advance_to(self, t: float) -> None:
        """Jump to absolute simulated time ``t`` (never backwards)."""
        if t < self._now:
            raise ValueError(f"clock cannot move backwards: {t} < {self._now}")
        self._now = t

    def advance(self, dt: float) -> float:
        """Move forward by ``dt`` seconds; returns the new time."""
        if dt < 0:
            raise ValueError(f"negative advance: {dt}")
        self._now += dt
        return self._now

    def __repr__(self) -> str:
        return f"SimClock(t={self._now:.6f})"
