from .convert import (
    lora_from_numpy, lora_to_numpy, move_to, paged_cache_from_numpy, params_from_numpy, to_tensor,
)

__all__ = ["lora_from_numpy", "lora_to_numpy", "move_to", "paged_cache_from_numpy",
           "params_from_numpy", "to_tensor"]
