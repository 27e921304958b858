"""Small models over a leading party axis."""
