"""LoRA adapters: peft's LoraConfig / init / forward term, in PyTorch.

Per block linear, ``y += (alpha/r) · x @ A @ B`` with A [K, r] He-uniform
(kaiming a=√5 over fan_in, i.e. bound 1/√K) and B [r, N] zero.  Adapters are
stored f32 and computed in bf16 with f32 accumulation, as in the JAX
package.  Dropout (a training knob) and merging into the base weight wait
for their slices.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from qlora_tpu_torch.ops import bf16_matmul


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    r: int = 64
    alpha: float = 16.0

    @property
    def scale(self) -> float:
        return self.alpha / self.r


def init_lora(in_dim: int, out_dim: int, r: int, generator: torch.Generator,
              device=None) -> dict:
    """One adapter: A ~ U(-1/√in_dim, 1/√in_dim), B = 0 (f32)."""
    bound = 1.0 / math.sqrt(in_dim)
    a = torch.empty((in_dim, r), dtype=torch.float32, device=device)
    a.uniform_(-bound, bound, generator=generator)
    return {"a": a, "b": torch.zeros((r, out_dim), dtype=torch.float32, device=device)}


def apply_lora(x: torch.Tensor, adapter: dict, scale: float) -> torch.Tensor:
    """(alpha/r)·x @ A @ B in bf16 compute; x [..., K] → [..., N]."""
    y = bf16_matmul(bf16_matmul(x, adapter["a"]), adapter["b"])
    return (y * scale).to(torch.bfloat16)


__all__ = ["LoraConfig", "init_lora", "apply_lora"]
