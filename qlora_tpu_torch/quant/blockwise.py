"""Blockwise 4-bit (NF4/FP4) and int8 quantization with double-quantized
scales, in PyTorch.

The storage layout is the JAX package's, byte for byte:

* ``W[K, N]`` (used as ``y = x @ W``) is quantized in blocks of
  ``block_size`` along K, per output column:
  ``absmax[K//B, n] = max |W[bB:(b+1)B, n]|``.
* 4-bit codes pack two per byte, global split-half: byte ``(r, n)`` holds
  logical row ``r`` in the low nibble and row ``K/2 + r`` in the high one.
* int8 codes (``quant_type="int8"``, the ``--bits 8`` base and the per-column
  serving copy) are stored unpacked, int8 ``[K, N]``:
  ``round(W / absmax * 127)``, decoded as ``(code * (1/127)) * absmax``.
* Double quantization stores the f32 absmax as int8 with one f32 scale per
  column-aligned meta-block of 256 absmax rows, plus one f32 mean offset.

The mean offset is a float reduction whose last bit depends on summation
order, so double-quantized tensors made here may differ from JAX's by an
ulp in the offset (and hence ±1 in a few int8 codes); the packed nibbles and
a plain f32 absmax do not depend on it and are identical.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .codebooks import get_code

DEFAULT_BLOCK = 64
ABSMAX_BLOCK = 256  # double-quant meta-block, along K within each column


@dataclasses.dataclass
class QuantizedTensor:
    """A blockwise-quantized 2-D tensor (frozen base weight).

    ``packed`` uint8 [K//2, N] (4-bit) or int8 [K, N] (``quant_type``
    "int8"); ``absmax`` f32 [K//B, N] or, with double
    quant, int8 [K//B, N] with ``absmax_scale`` f32 [ceil(K//B/256), N] and
    ``absmax_offset`` a 0-dim f32 tensor.  ``shape`` is the logical (K, N).
    """

    packed: torch.Tensor
    absmax: torch.Tensor
    absmax_scale: Optional[torch.Tensor]
    absmax_offset: Optional[torch.Tensor]
    shape: tuple
    block_size: int = DEFAULT_BLOCK
    quant_type: str = "nf4"

    @property
    def double_quant(self) -> bool:
        return self.absmax_scale is not None

    @property
    def device(self) -> torch.device:
        return self.packed.device

    @property
    def nbytes(self) -> int:
        n = self.packed.numel() + self.absmax.numel() * self.absmax.element_size()
        if self.absmax_scale is not None:
            n += self.absmax_scale.numel() * 4 + 4
        return n

    def to(self, device) -> "QuantizedTensor":
        mv = lambda t: None if t is None else t.to(device)
        return dataclasses.replace(
            self, packed=mv(self.packed), absmax=mv(self.absmax),
            absmax_scale=mv(self.absmax_scale),
            absmax_offset=mv(self.absmax_offset))


def _encode(w_scaled: torch.Tensor, code) -> torch.Tensor:
    """Nearest-codebook index for values in [-1, 1]: the count of midpoints
    each value lies strictly above (the codebook is sorted)."""
    mids = (code[1:] + code[:-1]) * 0.5        # f32, as the JAX package
    idx = torch.zeros(w_scaled.shape, dtype=torch.uint8, device=w_scaled.device)
    for m in mids.tolist():                    # float32 values exactly
        idx += (w_scaled > m).to(torch.uint8)
    return idx


def double_quantize_absmax(absmax: torch.Tensor):
    """Quantize the f32 absmax ``[R, N]`` to int8 with column-aligned
    meta-blocks of 256 rows plus a global f32 mean offset.

    Returns (q int8 [R, N], scales f32 [ceil(R/256), N], offset 0-dim f32)."""
    R, N = absmax.shape
    am = absmax.to(torch.float32)
    pad = (-R) % ABSMAX_BLOCK
    offset = am.mean()
    centered = torch.nn.functional.pad(am - offset, (0, 0, 0, pad))
    blocks = centered.reshape(-1, ABSMAX_BLOCK, N)
    scales = blocks.abs().amax(dim=1)
    safe = torch.where(scales == 0, torch.ones_like(scales), scales)
    q = torch.clamp(torch.round(blocks / safe[:, None, :] * 127.0), -127, 127)
    return q.reshape(-1, N)[:R].to(torch.int8), scales, offset


def dequantize_absmax(q: torch.Tensor, scales: torch.Tensor,
                      offset: torch.Tensor, out_shape: tuple) -> torch.Tensor:
    """Inverse of :func:`double_quantize_absmax` → f32 absmax `out_shape`."""
    R, N = out_shape
    pad = (-R) % ABSMAX_BLOCK
    blocks = torch.nn.functional.pad(q.to(torch.float32), (0, 0, 0, pad)).reshape(
        -1, ABSMAX_BLOCK, N)
    # XLA compiles `q * (scales / 127) + offset` as one fused multiply-add
    # over `scales * (1/127)`, as the qmm kernels do.  The f64 product of
    # an int8 and an f32 is exact, so rounding the f64 sum once to f32
    # gives the fma's bits.
    meta = scales * (1.0 / 127.0)
    flat = (blocks.double() * meta[:, None, :].double() + offset.double()).float()
    return flat.reshape(-1, N)[:R]


def quantize(w: torch.Tensor, block_size: int = DEFAULT_BLOCK,
             quant_type: str = "nf4", double_quant: bool = True) -> QuantizedTensor:
    """Quantize a 2-D weight ``W[K, N]`` on its own device: ``quant_type``
    "nf4" or "fp4" to packed 4-bit nibbles, "int8" to unpacked linear int8
    codes with the same per-block absmax."""
    if w.ndim != 2:
        raise ValueError(f"quantize expects a 2-D weight, got shape {tuple(w.shape)}")
    K, N = w.shape
    if quant_type == "int8":
        if K % block_size != 0:
            raise ValueError(f"K={K} must be divisible by block_size={block_size}")
        blocks = w.to(torch.float32).reshape(K // block_size, block_size, N)
        absmax = blocks.abs().amax(dim=1)
        safe = torch.where(absmax == 0, torch.ones_like(absmax), absmax)
        codes = torch.clamp(torch.round(blocks / safe[:, None, :] * 127.0), -127, 127)
        codes = codes.reshape(K, N).to(torch.int8)
        if double_quant:
            q, sc, off = double_quantize_absmax(absmax)
            return QuantizedTensor(codes, q, sc, off, (K, N), block_size, "int8")
        return QuantizedTensor(codes, absmax, None, None, (K, N), block_size, "int8")
    if K % (2 * block_size) != 0:
        raise ValueError(f"K={K} must be divisible by 2*block_size={2 * block_size}")
    code = torch.as_tensor(get_code(quant_type), device=w.device)

    blocks = w.to(torch.float32).reshape(K // block_size, block_size, N)
    absmax = blocks.abs().amax(dim=1)                       # [K//B, N]
    safe = torch.where(absmax == 0, torch.ones_like(absmax), absmax)
    idx = _encode((blocks / safe[:, None, :]).reshape(K, N), code)
    half = K // 2
    packed = idx[:half] | (idx[half:] << 4)
    if double_quant:
        q, sc, off = double_quantize_absmax(absmax)
        return QuantizedTensor(packed, q, sc, off, (K, N), block_size, quant_type)
    return QuantizedTensor(packed, absmax, None, None, (K, N), block_size, quant_type)


def logical_k(qt: QuantizedTensor) -> int:
    """Leaf-derived logical contraction dim (4-bit packs 2 rows per byte,
    int8 stores one row per row)."""
    return qt.packed.shape[-2] * (1 if qt.quant_type == "int8" else 2)


def quantize_k_sharded(*args, **kwargs):
    raise NotImplementedError(
        "K-sharded storage belongs to the megatron tensor-parallel slice "
        "(ROADMAP queue A, parallelism)")


def local_chunk(*args, **kwargs):
    raise NotImplementedError(
        "K-sharded storage belongs to the megatron tensor-parallel slice "
        "(ROADMAP queue A, parallelism)")


def absmax_f32(qt: QuantizedTensor) -> torch.Tensor:
    """The per-block absmax as f32 [K//B, N], undoing double quant."""
    target = (logical_k(qt) // qt.block_size, qt.packed.shape[-1])
    if qt.double_quant:
        return dequantize_absmax(qt.absmax, qt.absmax_scale, qt.absmax_offset, target)
    return qt.absmax.to(torch.float32)


def unpack_indices(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [K//2, N] → uint8 code indices [K, N] (split-half layout)."""
    return torch.cat([packed & 0x0F, packed >> 4], dim=0)


def dequantize(qt: QuantizedTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Reconstruct ``W[K, N]`` in `dtype` (the plain reference path)."""
    K, N = logical_k(qt), qt.packed.shape[-1]
    if qt.quant_type == "int8":
        vals = qt.packed.to(torch.float32) * (1.0 / 127.0)
    else:
        code = torch.as_tensor(get_code(qt.quant_type), device=qt.device)
        vals = code[unpack_indices(qt.packed).long()]
    w = vals.reshape(K // qt.block_size, qt.block_size, N) * absmax_f32(qt)[:, None, :]
    return w.reshape(K, N).to(dtype)
