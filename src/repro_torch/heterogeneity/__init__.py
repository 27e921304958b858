"""Behavioural heterogeneity: availability traces."""
