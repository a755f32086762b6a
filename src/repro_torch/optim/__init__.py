"""Optimizers — port of ``repro/optim``."""
from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, accumulate_grads, adafactor, adamw, apply_updates,
    clip_by_global_norm, compress_grads_int8, constant_schedule,
    cosine_schedule, global_norm, init_error_state,
)
