"""Training: loss, optimizers, the train step, the collator."""

from .collator import CausalCollator, bucket_batches, example_length
from .loss import IGNORE_INDEX, causal_shift, masked_cross_entropy
from .optimizer import (
    Optimizer, adam8bit, adamw, apply_updates, global_norm, host_offload, make_optimizer,
    warmup_constant_schedule,
)
from .step import TrainState, init_train_state, loss_fn, make_eval_step, make_train_step

__all__ = [
    "CausalCollator", "bucket_batches", "example_length",
    "IGNORE_INDEX", "causal_shift", "masked_cross_entropy",
    "Optimizer", "adam8bit", "adamw", "apply_updates", "global_norm", "host_offload",
    "make_optimizer", "warmup_constant_schedule",
    "TrainState", "init_train_state", "loss_fn", "make_eval_step", "make_train_step",
]
