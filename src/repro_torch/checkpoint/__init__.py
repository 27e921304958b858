from repro_torch.checkpoint.serde import params_from_bytes, params_to_bytes

__all__ = ["params_to_bytes", "params_from_bytes"]
