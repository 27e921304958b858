"""Discrete-event continuum runtime: clock, loop, cohorts, exchange."""
