"""Client-side local training."""
