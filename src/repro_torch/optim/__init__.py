from repro_torch.optim.optimizers import apply_updates, sgd

__all__ = ["apply_updates", "sgd"]
