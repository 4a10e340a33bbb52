"""Transformer building blocks: norms, RoPE, attention, linear dispatch.

Plain functions over tensors.  The dtype policy is the JAX package's: norms
in f32, matrix products with bf16 operands and f32 accumulation, frozen base
weights NF4, FP4 or int8 (``bf16_matmul`` in ``ops`` holds the product's
policy).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from qlora_tpu_torch.ops import bf16_matmul, qmatmul
from qlora_tpu_torch.quant.blockwise import QuantizedTensor


@dataclasses.dataclass
class QLinear:
    """A linear layer whose weight is a frozen QuantizedTensor."""
    qt: QuantizedTensor
    bias: Optional[torch.Tensor] = None


@dataclasses.dataclass
class DenseLinear:
    """A plain (bf16/f32) linear layer, weight [K, N]."""
    w: torch.Tensor
    bias: Optional[torch.Tensor] = None


Linear = Union[QLinear, DenseLinear]


def lookup_embedding(emb: torch.Tensor, ids: torch.Tensor,
                     dtype=torch.bfloat16) -> torch.Tensor:
    return emb[ids.long()].to(dtype)


def apply_linear(lin: Linear, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W (+ bias); x [..., K] → [..., N] in bf16 (single device)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if isinstance(lin, QLinear):
        y = qmatmul(x2, lin.qt)
    else:
        y = bf16_matmul(x2, lin.w).to(torch.bfloat16)
    if lin.bias is not None:
        y = (y.float() + lin.bias.float()).to(torch.bfloat16)
    return y.reshape(*lead, y.shape[-1])


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """LLaMA RMSNorm in f32."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(torch.bfloat16)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """GPT-NeoX LayerNorm in f32."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(torch.bfloat16)


def rope_frequencies(head_dim: int, rotary_dim: int, theta: float,
                     positions: torch.Tensor):
    """cos/sin tables for positions [..., S] → [..., S, rotary_dim/2] f32."""
    exps = torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                        device=positions.device) / rotary_dim
    inv_freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                            device=positions.device), exps)
    angles = positions[..., None].float() * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rotary_dim: int) -> torch.Tensor:
    """Rotate the first `rotary_dim` features of x [..., S, H, hd]
    (half-split convention, as LLaMA and GPT-NeoX)."""
    rot, rest = x[..., :rotary_dim], x[..., rotary_dim:]
    half = rotary_dim // 2
    x1, x2 = rot[..., :half].float(), rot[..., half:].float()
    c = cos[..., None, :]
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
    if rest.shape[-1]:
        out = torch.cat([out, rest], dim=-1)
    return out


def _softmax_attend(logits, mask, v_f32, einsum_out):
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum(einsum_out, probs.to(torch.bfloat16).float(), v_f32)


def attention(q, k, v, mask) -> torch.Tensor:
    """Softmax attention, GQA-grouped, f32 softmax.

    q [B, S, H, hd]; k, v [B, T, KVH, hd]; mask [B, 1, S, T] bool
    (True = attend).  Returns [B, S, H, hd] bf16."""
    B, S, H, hd = q.shape
    KVH = k.shape[2]
    G = H // KVH
    qg = q.reshape(B, S, KVH, G, hd).to(torch.bfloat16).float()
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.to(torch.bfloat16).float())
    logits = logits * (1.0 / hd ** 0.5)
    out = _softmax_attend(logits, mask[:, :, None], v.to(torch.bfloat16).float(),
                          "bkgst,btkd->bskgd")
    return out.reshape(B, S, H, hd).to(torch.bfloat16)


def attention_kvmajor(q, k_buf, v_buf, mask) -> torch.Tensor:
    """:func:`attention` over the decode cache's [B, KVH, T, hd] layout.

    bf16 operands, f32 accumulation and probabilities rounded to bf16 —
    the TPU's semantics (the JAX package computes this in f32 on its CPU
    backend)."""
    B, S, H, hd = q.shape
    KVH = k_buf.shape[1]
    G = H // KVH
    qg = q.reshape(B, S, KVH, G, hd).to(torch.bfloat16).float()
    logits = torch.einsum("bskgd,bktd->bkgst", qg, k_buf.to(torch.bfloat16).float())
    logits = logits * (1.0 / hd ** 0.5)
    out = _softmax_attend(logits, mask[:, :, None], v_buf.to(torch.bfloat16).float(),
                          "bkgst,bktd->bskgd")
    return out.reshape(B, S, H, hd).to(torch.bfloat16)


def causal_mask(S: int, T: int, q_offset: int = 0, device=None) -> torch.Tensor:
    """[1, 1, S, T] causal mask; query i attends keys <= i + q_offset."""
    qi = torch.arange(S, device=device)[:, None] + q_offset
    kj = torch.arange(T, device=device)[None, :]
    return (kj <= qi)[None, None]
