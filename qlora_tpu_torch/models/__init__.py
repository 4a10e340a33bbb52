from .config import ModelConfig, get_config
from .transformer import (
    forward,
    init_cache,
    init_lora_params,
    init_params,
    linear_dims,
    linear_names,
)

__all__ = [
    "ModelConfig", "get_config", "forward", "init_cache", "init_lora_params",
    "init_params", "linear_dims", "linear_names",
]
