"""Fused NF4/FP4 dequantize + matmul, differentiable in its input.

``qmatmul(x, qt)`` dispatches on the device of its operands: a CUDA tensor
launches the hand-written kernels (``csrc/qmm_nf4_fwd.cu`` forward,
``csrc/qmm_nf4_bwd.cu`` backward; the int8-absmax variant when
``qt.double_quant``, else the f32-absmax one) and raises if it cannot; a CPU
tensor takes :func:`qmatmul_plain` and :func:`qmatmul_bwd_plain`, which
mirror the JAX package's ``impl="xla"`` path.  The kernels take every shape
``quantize`` accepts: they have none of the TPU's tiling conditions.

The quantized weight is frozen: the backward decodes it again, computes
``dx = g @ dequant(W)ᵀ`` and gives no leaf of the ``QuantizedTensor`` a
gradient.
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


def _check_quantized(qt: QuantizedTensor, dev: torch.device):
    """Check the stored tensors against the kernels' contract; returns
    (K, N, scale, offset), the last two None without double quant."""
    K, N = logical_k(qt), qt.packed.shape[-1]
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
    return K, N, scale, offset


def _launch(entry: str, a: torch.Tensor, qt: QuantizedTensor, outer: int,
            scale, offset) -> torch.Tensor:
    """Launch `entry` (``qmm_nf4_fwd`` or ``qmm_nf4_bwd``, which take the
    same argument list) on a [M, ·] → out [M, outer] bf16.  No rows, no
    launch."""
    K, N = logical_k(qt), qt.packed.shape[-1]
    a = a.to(torch.bfloat16).contiguous()
    if a.data_ptr() % 16:
        a = a.clone()                      # the kernels load rows 16 bytes at a time
    M = a.shape[0]
    out = torch.empty((M, outer), dtype=torch.bfloat16, device=a.device)
    if M == 0:
        return out
    fn = _build.kernel(entry, entry, _ARGTYPES)
    err = fn(a.data_ptr(), qt.packed.data_ptr(), qt.absmax.data_ptr(),
             None if scale is None else scale.data_ptr(),
             None if offset is None else offset.data_ptr(),
             _code_on(qt.quant_type, a.device).data_ptr(), out.data_ptr(),
             M, K, N, qt.block_size, int(qt.double_quant), _build.stream_ptr(a))
    _build.check(err, entry)
    return out


def _qmm_launch(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """Check the operands and launch the forward kernel: x [M, K] on the
    card → y [M, N] bf16.  The variant follows ``qt.double_quant``."""
    K = logical_k(qt)
    if x.ndim != 2 or x.shape[1] != K:
        raise ValueError(f"x {tuple(x.shape)} does not match a [M, {K}] input")
    K, N, scale, offset = _check_quantized(qt, x.device)
    return _launch("qmm_nf4_fwd", x, qt, N, scale, offset)


def qmm_nf4_fwd_dq(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """The kernel with int8 double-quantized absmax (TPU _qmm_pallas_dq)."""
    if not qt.double_quant:
        raise ValueError("qmm_nf4_fwd_dq needs a double-quantized tensor")
    y = _qmm_launch(x, qt)
    qmm_nf4_fwd_dq.launches += x.shape[0] > 0
    return y


def qmm_nf4_fwd_f32(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """The kernel with f32 absmax (TPU _qmm_pallas)."""
    if qt.double_quant:
        raise ValueError("qmm_nf4_fwd_f32 needs an f32-absmax tensor")
    y = _qmm_launch(x, qt)
    qmm_nf4_fwd_f32.launches += x.shape[0] > 0
    return y


qmm_nf4_fwd_dq.launches = 0
qmm_nf4_fwd_f32.launches = 0


def qmatmul_bwd_plain(g: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """The plain version of the backward: g [M, N] → dx [M, K] bf16, the
    bf16-rounded g times the transposed bf16 weight with f32 accumulation."""
    return bf16_matmul(g, dequantize(qt, torch.bfloat16).T).to(torch.bfloat16)


def qmm_nf4_bwd(g: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """The backward kernel (TPU _qmm_bwd_pallas): dx = g @ dequant(qt)ᵀ for
    g [M, N] on the card → [M, K] bf16.  Double-quantized absmax is decoded
    in the kernel with the forward's arithmetic."""
    N = qt.packed.shape[-1]
    if g.ndim != 2 or g.shape[1] != N:
        raise ValueError(f"g {tuple(g.shape)} does not match a [M, {N}] cotangent")
    K, N, scale, offset = _check_quantized(qt, g.device)
    dx = _launch("qmm_nf4_bwd", g, qt, K, scale, offset)
    qmm_nf4_bwd.launches += g.shape[0] > 0
    return dx


qmm_nf4_bwd.launches = 0


def _forward(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    if x.is_cuda:
        return qmm_nf4_fwd_dq(x, qt) if qt.double_quant else qmm_nf4_fwd_f32(x, qt)
    if x.device.type != "cpu":
        raise ValueError(f"qmatmul runs on CUDA or the CPU, not {x.device}")
    return qmatmul_plain(x, qt)


class _QMatmul(torch.autograd.Function):
    """``x @ dequant(qt)`` with the JAX package's vjp: a gradient for x
    only; the backward re-dequantizes the frozen weight."""

    @staticmethod
    def forward(ctx, x, qt):
        ctx.qt = qt
        ctx.x_dtype = x.dtype
        return _forward(x, qt)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None
        dx = qmm_nf4_bwd(g, ctx.qt) if g.is_cuda else qmatmul_bwd_plain(g, ctx.qt)
        return dx.to(ctx.x_dtype), None


def qmatmul(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """``x @ dequant(qt)`` for 2-D x [M, K] → [M, N] (bf16 out, f32 accum).

    Differentiable in x only.  An x that needs no gradient skips autograd
    altogether, so nothing is kept and no backward kernel is launched."""
    if x.requires_grad and torch.is_grad_enabled():
        return _QMatmul.apply(x, qt)
    return _forward(x, qt)
