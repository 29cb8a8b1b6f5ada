"""repro_torch.optim — the reference's optimizers and schedules over the
port's trees (functional init/update, fp32 moments)."""
from repro_torch.optim.optimizers import (
    Optimizer,
    sgd,
    adamw,
    apply_updates,
    clip_by_global_norm,
    chain,
)
from repro_torch.optim.schedules import constant, cosine_decay, linear_warmup_cosine

__all__ = [
    "Optimizer",
    "sgd",
    "adamw",
    "apply_updates",
    "clip_by_global_norm",
    "chain",
    "constant",
    "cosine_decay",
    "linear_warmup_cosine",
]
