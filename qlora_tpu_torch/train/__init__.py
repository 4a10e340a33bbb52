"""Training: loss, optimizers, the train step, the collator, the datasets."""

from .collator import CausalCollator, bucket_batches, example_length
from .data import (
    ALPACA_PROMPT_DICT, HUB_DATASETS, extract_alpaca_example, format_example,
    load_dataset_by_name, load_local_dataset, make_dataset, split_train_eval,
)
from .loss import IGNORE_INDEX, causal_shift, masked_cross_entropy, shift_labels
from .optimizer import (
    Optimizer, adam8bit, adamw, apply_updates, global_norm, host_offload, make_optimizer,
    warmup_constant_schedule,
)
from .step import (
    TrainState, init_train_state, loss_fn, make_eval_step, make_train_step, sp_loss_fn,
)

__all__ = [
    "CausalCollator", "bucket_batches", "example_length",
    "ALPACA_PROMPT_DICT", "HUB_DATASETS", "extract_alpaca_example", "format_example",
    "load_dataset_by_name", "load_local_dataset", "make_dataset", "split_train_eval",
    "IGNORE_INDEX", "causal_shift", "masked_cross_entropy", "shift_labels",
    "Optimizer", "adam8bit", "adamw", "apply_updates", "global_norm", "host_offload",
    "make_optimizer", "warmup_constant_schedule",
    "TrainState", "init_train_state", "loss_fn", "make_eval_step", "make_train_step",
    "sp_loss_fn",
]
