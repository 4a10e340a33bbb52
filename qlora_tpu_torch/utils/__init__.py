"""Utilities: the bridge from the JAX package's trees, checkpoints, the
quantized store, HF import, the tokenizer wrapper and metrics logging."""

from .checkpoint import (
    get_last_checkpoint, load_checkpoint, load_pytree, mark_completed, save_checkpoint,
    save_pytree,
)
from .convert import (
    lora_from_numpy, lora_to_numpy, move_to, paged_cache_from_numpy, params_from_numpy, to_tensor,
)
from .hf_import import load_hf_model, read_hf_config, read_safetensors
from .metrics import MetricsLogger, StepTimer, maybe_profile
from .quantized_store import load_quantized, save_quantized
from .testing import FakeTokenizer
from .tokenizer import Tokenizer, load_tokenizer, resize_embeddings_mean_init

__all__ = ["lora_from_numpy", "lora_to_numpy", "move_to", "paged_cache_from_numpy",
           "params_from_numpy", "to_tensor",
           "get_last_checkpoint", "load_checkpoint", "load_pytree", "mark_completed",
           "save_checkpoint", "save_pytree",
           "load_hf_model", "read_hf_config", "read_safetensors",
           "MetricsLogger", "StepTimer", "maybe_profile",
           "load_quantized", "save_quantized", "FakeTokenizer",
           "Tokenizer", "load_tokenizer", "resize_embeddings_mean_init"]
