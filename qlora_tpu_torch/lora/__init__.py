"""LoRA adapters: peft's LoraConfig / init / forward term, in PyTorch.

Per block linear, ``y += (alpha/r) · x @ A @ B`` with A [K, r] He-uniform
(kaiming a=√5 over fan_in, i.e. bound 1/√K) and B [r, N] zero.  Adapters are
stored f32 and computed in bf16 with f32 accumulation, as in the JAX
package.  In training the adapter's input may pass through dropout;
``merge_lora`` folds a trained adapter into its base weight.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from qlora_tpu_torch.ops import bf16_matmul


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    r: int = 64
    alpha: float = 16.0
    dropout: float = 0.0

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


def apply_lora(x: torch.Tensor, adapter: dict, scale: float, dropout: float = 0.0,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(alpha/r)·dropout(x) @ A @ B in bf16 compute; x [..., K] → [..., N].

    Dropout acts only when ``dropout > 0`` and a generator is given: a
    Bernoulli(1 − p) keep mask on x, the kept values scaled by 1/(1 − p)."""
    if dropout > 0.0 and generator is not None:
        keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - dropout
        x = torch.where(keep, x / (1.0 - dropout), torch.zeros_like(x))
    y = bf16_matmul(bf16_matmul(x, adapter["a"]), adapter["b"])
    return (y * scale).to(torch.bfloat16)


def merge_lora(w: torch.Tensor, adapter: dict, scale: float) -> torch.Tensor:
    """W + (alpha/r)·A@B in f32, returned in w's dtype.  The caller
    re-quantizes the merged weight if it wants to."""
    delta = adapter["a"].float() @ adapter["b"].float()
    return (w.float() + scale * delta).to(w.dtype)


def count_lora_params(lora) -> int:
    """Number of adapter parameters in a per-layer list of adapters."""
    return sum(t.numel() for layer in lora for ad in layer.values() for t in ad.values())


def merge_lora_into_params(params: dict, lora: list, lcfg: LoraConfig,
                           requantize: bool = True) -> dict:
    """Fold every adapter into its base linear, layer by layer.

    Quantized linears are dequantized, merged, and re-quantized with their
    own block size, code and double-quant setting, or kept as a bf16
    ``DenseLinear`` when ``requantize`` is False.  Returns a new params
    dict; the inputs are untouched."""
    from qlora_tpu_torch.models.layers import DenseLinear, QLinear
    from qlora_tpu_torch.quant.blockwise import dequantize, quantize

    def one(lin, adapter):
        if isinstance(lin, QLinear):
            merged = merge_lora(dequantize(lin.qt, torch.float32), adapter, lcfg.scale)
            if requantize:
                return QLinear(qt=quantize(merged, block_size=lin.qt.block_size,
                                           quant_type=lin.qt.quant_type,
                                           double_quant=lin.qt.double_quant), bias=lin.bias)
            return DenseLinear(w=merged.to(torch.bfloat16), bias=lin.bias)
        return DenseLinear(w=merge_lora(lin.w.float(), adapter, lcfg.scale).to(lin.w.dtype),
                           bias=lin.bias)

    blocks = [dict(block, **{name: one(block[name], ad) for name, ad in layer.items()})
              for block, layer in zip(params["blocks"], lora)]
    return dict(params, blocks=blocks)


__all__ = ["LoraConfig", "init_lora", "apply_lora", "merge_lora", "count_lora_params",
           "merge_lora_into_params"]
