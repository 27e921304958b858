"""Behavioural heterogeneity: per-client availability traces.

Clients flip between available/unavailable following a two-state Markov
process whose rates are drawn per client — matching the paper's "variable
availability patterns based on real-world trace" (BH case).  A client is
available when charging+idle+on-WiFi in the real trace; here the stationary
availability probability is drawn from a Beta distribution fitted loosely
to the FLASH trace statistics (most clients available 20-80% of the time,
with heavy tails).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class AvailabilityTrace:
    """Boolean availability matrix: (num_clients, horizon) per round."""

    matrix: np.ndarray  # bool (C, T)

    def available(self, round_idx: int) -> np.ndarray:
        return self.matrix[:, round_idx % self.matrix.shape[1]]

    @property
    def mean_availability(self) -> float:
        return float(self.matrix.mean())


def markov_trace(
    num_clients: int,
    horizon: int = 500,
    seed: int = 0,
    always_on: bool = False,
    avail_mean: float | None = None,
) -> AvailabilityTrace:
    """Two-state Markov availability traces, one row per client.

    ``avail_mean`` (if given) targets a mean stationary availability while
    keeping per-client heterogeneity: pi ~ Beta centred on ``avail_mean``.
    The fault-injection runtime uses this to dial a churn level (e.g. 30%
    of parties offline on average) into an otherwise FLASH-like trace.
    """
    rng = np.random.default_rng(seed)
    if always_on:
        return AvailabilityTrace(np.ones((num_clients, horizon), bool))
    if avail_mean is not None:
        if not 0.0 < avail_mean < 1.0:
            raise ValueError(f"avail_mean must be in (0, 1), got {avail_mean}")
        # concentration 6 keeps the heavy-tailed per-client spread
        pi = rng.beta(6.0 * avail_mean, 6.0 * (1.0 - avail_mean), num_clients)
    else:
        # stationary availability pi ~ Beta(2, 2.5); dwell ~ Geometric
        pi = rng.beta(2.0, 2.5, num_clients)
    dwell = rng.integers(3, 30, num_clients)  # mean rounds per state visit
    p_stay_on = 1 - 1 / dwell
    # choose p_off->on to match stationary pi: pi = p_on / (p_on + p_off_rate)
    p_go_on = (1 - p_stay_on) * pi / np.maximum(1 - pi, 1e-3)
    p_go_on = np.clip(p_go_on, 0.01, 0.99)
    mat = np.empty((num_clients, horizon), bool)
    state = rng.random(num_clients) < pi
    for t in range(horizon):
        mat[:, t] = state
        stay = rng.random(num_clients)
        state = np.where(state, stay < p_stay_on, stay < p_go_on)
    return AvailabilityTrace(mat)
