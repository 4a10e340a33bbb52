"""Fused NF4/FP4 dequantize + matmul, forward only.

``qmatmul(x, qt)`` dispatches on the device of its operands: a CUDA tensor
launches the hand-written kernel (``csrc/qmm_nf4_fwd.cu``; the int8-absmax
variant when ``qt.double_quant``, else the f32-absmax one) and raises if it
cannot; a CPU tensor takes :func:`qmatmul_plain`, which mirrors the JAX
package's ``impl="xla"`` path.  The kernel takes every shape ``quantize``
accepts: it has none of the TPU's tiling conditions.
"""

from __future__ import annotations

import ctypes

import torch

from qlora_tpu_torch.quant.blockwise import (
    ABSMAX_BLOCK, QuantizedTensor, dequantize, logical_k,
)
from qlora_tpu_torch.quant.codebooks import get_code

from . import _build


def bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with bf16 operands and f32 accumulation; f32 result.

    Written as an f32 product of bf16-rounded operands (exact products, f32
    sums), which computes the same function on the CPU and on the card."""
    return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()


def qmatmul_plain(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """dequantize, then bf16-rounded operands multiplied with f32
    accumulation, rounded to bf16: x [M, K] → [M, N]."""
    return bf16_matmul(x, dequantize(qt, torch.bfloat16)).to(torch.bfloat16)


_CODE_CACHE: dict = {}


def _code_on(quant_type: str, device: torch.device) -> torch.Tensor:
    key = (quant_type, device)
    if key not in _CODE_CACHE:
        _CODE_CACHE[key] = torch.as_tensor(get_code(quant_type), device=device)
    return _CODE_CACHE[key]


_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]


def _qmm_launch(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """Check the operands and launch the kernel: x [M, K] on the card →
    y [M, N] bf16.  The variant follows ``qt.double_quant``."""
    K, N = logical_k(qt), qt.packed.shape[-1]
    if x.ndim != 2 or x.shape[1] != K:
        raise ValueError(f"x {tuple(x.shape)} does not match a [M, {K}] input")
    dev = x.device
    for name, t in (("packed", qt.packed), ("absmax", qt.absmax)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")
    if qt.packed.dtype != torch.uint8 or qt.packed.ndim != 2:
        raise ValueError("packed must be uint8 [K/2, N]")
    nb = K // qt.block_size
    if K % qt.block_size or tuple(qt.absmax.shape) != (nb, N):
        raise ValueError(f"absmax {tuple(qt.absmax.shape)} is not [{nb}, {N}]")
    scale = offset = None
    if qt.double_quant:
        if qt.absmax.dtype != torch.int8 or qt.absmax_offset.numel() != 1:
            raise ValueError("double-quantized absmax must be int8 with one offset")
        if tuple(qt.absmax_scale.shape) != (-(-nb // ABSMAX_BLOCK), N):
            raise ValueError(f"absmax_scale {tuple(qt.absmax_scale.shape)} does not "
                             f"cover {nb} absmax rows of {N} columns")
        scale = qt.absmax_scale.to(dev, torch.float32).contiguous()
        offset = qt.absmax_offset.to(dev, torch.float32).reshape(1)
    elif qt.absmax.dtype != torch.float32:
        raise ValueError("plain absmax must be float32")
    x = x.to(torch.bfloat16).contiguous()
    M = x.shape[0]
    y = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    if M == 0:
        return y
    fn = _build.kernel("qmm_nf4_fwd", "qmm_nf4_fwd", _ARGTYPES)
    err = fn(x.data_ptr(), qt.packed.data_ptr(), qt.absmax.data_ptr(),
             None if scale is None else scale.data_ptr(),
             None if offset is None else offset.data_ptr(),
             _code_on(qt.quant_type, dev).data_ptr(), y.data_ptr(),
             M, K, N, qt.block_size, int(qt.double_quant), _build.stream_ptr(x))
    _build.check(err, "qmm_nf4_fwd")
    return y


def qmm_nf4_fwd_dq(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """The kernel with int8 double-quantized absmax (TPU _qmm_pallas_dq)."""
    if not qt.double_quant:
        raise ValueError("qmm_nf4_fwd_dq needs a double-quantized tensor")
    y = _qmm_launch(x, qt)
    qmm_nf4_fwd_dq.launches += 1
    return y


def qmm_nf4_fwd_f32(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """The kernel with f32 absmax (TPU _qmm_pallas)."""
    if qt.double_quant:
        raise ValueError("qmm_nf4_fwd_f32 needs an f32-absmax tensor")
    y = _qmm_launch(x, qt)
    qmm_nf4_fwd_f32.launches += 1
    return y


qmm_nf4_fwd_dq.launches = 0
qmm_nf4_fwd_f32.launches = 0


def qmatmul(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """``x @ dequant(qt)`` for 2-D x [M, K] → [M, N] (bf16 out, f32 accum)."""
    if x.is_cuda:
        return qmm_nf4_fwd_dq(x, qt) if qt.double_quant else qmm_nf4_fwd_f32(x, qt)
    if x.device.type != "cpu":
        raise ValueError(f"qmatmul runs on CUDA or the CPU, not {x.device}")
    return qmatmul_plain(x, qt)
