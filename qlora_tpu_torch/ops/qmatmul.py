"""Fused dequantize + matmul over NF4/FP4 and int8 storage, differentiable
in its input.

``qmatmul(x, qt)`` dispatches on the device of its operands: a CUDA tensor
launches a hand-written kernel and raises if it cannot; a CPU tensor takes
the kernel's plain version.  Which kernel follows the storage and the
scoped ``default_impl``:

=====================  ==========================  ========================
storage                exact (default)             under ``"w8a8"``
=====================  ==========================  ========================
NF4 / FP4              ``qmm_nf4_fwd_dq`` / _f32   ``qmm_nf4_w8a8``
int8, per column       ``qmm_i8_fwd``              ``qmm_i8_direct``
int8, blockwise        ``qmm_i8_fwd``              ``qmm_i8_fwd``
=====================  ==========================  ========================

The exact kernels multiply bf16 operands with f32 accumulation.  For
NF4/FP4, three kernels by shape: up to ``DECODE_ROWS`` rows (decode) a
split-K weight-streaming kernel (``csrc/qmm_nf4_decode.cu``, counted in
``decode_launches``), more rows a warp-specialised wgmma kernel that
decodes each weight tile once for 128 or 256 rows
(``csrc/qmm_nf4_wgmma.cu``, ``wgmma_launches``) wherever ``tile_plan``
accepts the shape (K % 8 == 0), and the tile kernel of
``csrc/qmm_nf4_fwd.cu`` for the rest.  For int8 storage, forward and dx
alike, the same wgmma design (``csrc/qmm_i8_wgmma.cu``, ``wgmma_launches``)
above ``DECODE_ROWS`` rows wherever ``i8_tile_plan`` accepts the shape (a
row stride of the activation in multiples of 16 bytes), and the tile kernel
of ``csrc/qmm_i8.cu`` for the rest.  The two ``w8a8`` kernels
quantize each row of x to int8, multiply int8 by int8 into int32 on the
tensor cores and scale in the epilogue (``csrc/qmm_i8_direct.cu``): the
serving engines' decode path.  The kernels take every shape ``quantize``
accepts: they have none of the TPU's tiling conditions.

The quantized weight is frozen: the backward decodes it again, computes
``dx = g @ dequant(W)ᵀ`` exactly (``qmm_nf4_bwd``, ``qmm_i8_bwd``), also
under ``"w8a8"``, and gives no leaf of the ``QuantizedTensor`` a gradient.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import math
from typing import Optional

import torch

from qlora_tpu_torch.quant.blockwise import (
    ABSMAX_BLOCK, QuantizedTensor, absmax_f32, dequantize, logical_k, unpack_indices,
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
    want = torch.int8 if qt.quant_type == "int8" else torch.uint8
    if qt.packed.dtype != want or qt.packed.ndim != 2:
        raise ValueError(f"{qt.quant_type} codes must be a 2-D {want} tensor, got "
                         f"{qt.packed.dtype} {tuple(qt.packed.shape)}")
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


def _check_rows(a: torch.Tensor, width: int, what: str) -> None:
    if a.ndim != 2 or a.shape[1] != width:
        raise ValueError(f"{what} {tuple(a.shape)} does not match a [M, {width}] operand")


def _aligned(a: torch.Tensor) -> torch.Tensor:
    """`a` contiguous at a 16-byte address: the kernels load rows 16 bytes
    at a time."""
    a = a.contiguous()
    return a.clone() if a.data_ptr() % 16 else a


def _launch(lib: str, entry: str, a: torch.Tensor, qt: QuantizedTensor, outer: int,
            scale, offset) -> torch.Tensor:
    """Launch a bf16 kernel (``qmm_nf4_fwd``, ``qmm_nf4_bwd``, ``qmm_i8_fwd``
    or ``qmm_i8_bwd``, which take the same argument list) on a [M, ·] →
    out [M, outer] bf16.  No rows, no launch."""
    K, N = logical_k(qt), qt.packed.shape[-1]
    a = _aligned(a.to(torch.bfloat16))
    M = a.shape[0]
    out = torch.empty((M, outer), dtype=torch.bfloat16, device=a.device)
    if M == 0:
        return out
    fn = _build.kernel(lib, entry, _ARGTYPES)
    code = None if qt.quant_type == "int8" else _code_on(qt.quant_type, a.device).data_ptr()
    err = fn(a.data_ptr(), qt.packed.data_ptr(), qt.absmax.data_ptr(),
             None if scale is None else scale.data_ptr(),
             None if offset is None else offset.data_ptr(),
             code, out.data_ptr(),
             M, K, N, qt.block_size, int(qt.double_quant), _build.stream_ptr(a))
    _build.check(err, entry)
    return out


# The NF4 forward at decode rows: ``csrc/qmm_nf4_decode.cu`` splits K across
# the blocks of a thread-block cluster, each a strip of 128 columns and a run
# of whole units of packed rows; its plan depends on (K, N, block size) and
# the SM count, never on the rows, so a row's result does not depend on the
# batch.
DECODE_ROWS = 16
_DECODE_COLS = 128           # output columns of one block of the decode kernel
_DECODE_MAX_SPLITS = 16      # blocks of one cluster (the largest an H100 takes)
_DECODE_BLOCKS_PER_SM = 2


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """How ``qmm_nf4_decode`` cuts a [K/2, N] packed weight: ``strips`` of
    128 columns times ``splits`` runs of whole ``unit``s of packed rows, one
    block each; the splits of a strip are one cluster."""
    splits: int
    unit: int
    strips: int

    def split_rows(self, K: int) -> list:
        """[(r0, r1)] packed rows of each split, as the kernel computes them."""
        units = -(-(K // 2) // self.unit)
        return [(s * units // self.splits * self.unit,
                 min((s + 1) * units // self.splits * self.unit, K // 2))
                for s in range(self.splits)]


def decode_plan(K: int, N: int, block_size: int, sms: int) -> DecodePlan:
    """The decode kernel's split of an NF4 weight: about
    ``_DECODE_BLOCKS_PER_SM`` blocks per SM, at most one cluster of splits
    per strip.  A unit is the least multiple of 8 packed rows (one k-step)
    that holds whole absmax blocks (8 rows where that would exceed 512)."""
    unit = math.lcm(block_size, 8)
    unit = unit if unit <= 512 else 8
    units = -(-(K // 2) // unit)
    strips = -(-N // _DECODE_COLS)
    splits = min(units, _DECODE_MAX_SPLITS, -(-_DECODE_BLOCKS_PER_SM * sms // strips))
    return DecodePlan(splits, unit, strips)


_PLANS: dict = {}
_SMS: dict = {}


def _decode_launch(x: torch.Tensor, qt: QuantizedTensor, scale, offset) -> torch.Tensor:
    """Launch ``qmm_nf4_decode`` on checked operands: x [M, K] bf16 on the
    card → y [M, N] bf16.  It takes any M (groups of 16 rows); the dispatch
    sends it M <= ``DECODE_ROWS``."""
    K, N = logical_k(qt), qt.packed.shape[-1]
    x = _aligned(x.to(torch.bfloat16))
    M, dev = x.shape[0], x.device
    y = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    if M == 0:
        return y
    key = (K, N, qt.block_size, dev)
    plan = _PLANS.get(key)
    if plan is None:
        if dev not in _SMS:
            _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = _PLANS[key] = decode_plan(K, N, qt.block_size, _SMS[dev])
    fn = _build.kernel("qmm_nf4_decode", "qmm_nf4_decode", [_P] * 7 + [_I] * 7 + [_P])
    err = fn(x.data_ptr(), qt.packed.data_ptr(), qt.absmax.data_ptr(),
             None if scale is None else scale.data_ptr(),
             None if offset is None else offset.data_ptr(),
             _code_on(qt.quant_type, dev).data_ptr(), y.data_ptr(), M, K, N, qt.block_size,
             int(qt.double_quant), plan.splits, plan.unit, _build.stream_ptr(x))
    _build.check(err, "qmm_nf4_decode")
    return y


# The NF4 forward at prefill and training rows: ``csrc/qmm_nf4_wgmma.cu``, a
# warp-specialised kernel (two consumer warpgroups on wgmma, two producer
# warpgroups decoding the weight) over output tiles of 128 or 256 rows by 128
# columns.
_TILE_N, _TILE_KP = 128, 64
_TILE_STAGES = {128: 3, 256: 2}      # rows a CTA -> k-steps in the ring


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """How a wgmma kernel (``qmm_nf4_wgmma``, ``qmm_i8_wgmma_fwd`` or
    ``_bwd``) cuts its output [M, O]: one CTA per ``tm`` x ``tn`` output tile
    (``grid`` = (M tiles, O tiles), M fastest), each walking all ``steps``
    k-steps of ``tkp`` contraction rows (packed rows for NF4) through a ring
    of ``stages``; ``smem`` bytes of dynamic shared memory.  ``accepted``
    says whether the shape takes the kernel; ``reason`` says why not."""
    accepted: bool
    reason: str
    tm: int = 128
    tn: int = _TILE_N
    tkp: int = _TILE_KP
    stages: int = _TILE_STAGES[128]
    grid: tuple = (0, 0)
    steps: int = 0
    smem: int = 0

    def tiles(self, M: int, N: int) -> list:
        """[(m0, m1, n0, n1)] output rows and columns of each CTA, clipped to
        the edges, as the kernel masks them."""
        return [(bm * self.tm, min((bm + 1) * self.tm, M), bn * self.tn,
                 min((bn + 1) * self.tn, N))
                for bn in range(self.grid[1]) for bm in range(self.grid[0])]


def tile_smem(tm: int) -> int:
    """Dynamic shared memory of the wgmma kernel at ``tm`` rows a CTA: the
    ring (per k-step two x boxes [tm, 64] and two bf16 B tiles [64, 128]), the
    two producer warpgroups' packed bytes (two k-steps each), 1024 bytes of
    alignment and 1024 of barriers."""
    stage = 2 * tm * _TILE_KP * 2 + 2 * _TILE_KP * _TILE_N * 2
    return 1024 + _TILE_STAGES[tm] * stage + 4 * _TILE_KP * _TILE_N + 1024


def tile_plan(M: int, K: int, N: int, block_size: int, sms: int = 132) -> TilePlan:
    """The wgmma kernel's plan for x [M, K] @ W [K, N] on a card of ``sms``
    SMs (an H100 SXM has 132).  It takes every shape that ``quantize``
    accepts with K % 8 == 0: TMA reads x in boxes of [rows, 64 columns] and
    needs its row stride (2K bytes) in multiples of 16.  Ragged M, N and K/2
    are masked in the kernel (TMA zero-fills x past M and K; the weight rows
    past K/2 are decoded as zeros).  Other restrictions: none by shape; block
    sizes that are no multiple of 8 take a slower decode with each element's
    own absmax.  A CTA takes 256 rows where 128-row tiles would need more than
    one wave of CTAs (each decoded weight tile then serves twice the rows),
    else 128.  The dispatch sends it more than ``DECODE_ROWS`` rows only."""
    if K % 8:
        return TilePlan(False, f"K={K} is no multiple of 8: TMA needs a 16-byte row stride")
    if M <= 0 or N <= 0 or K % (2 * block_size):
        return TilePlan(False, f"no NF4 shape: M={M} K={K} N={N} block {block_size}")
    n_tiles = -(-N // _TILE_N)
    tm = 256 if -(-M // 128) * n_tiles > sms else 128
    return TilePlan(True, "", tm=tm, stages=_TILE_STAGES[tm], grid=(-(-M // tm), n_tiles),
                    steps=-(-(K // 2) // _TILE_KP), smem=tile_smem(tm))


_TILE_PLANS: dict = {}


def _plan_on(plan_fn, dev, *args) -> TilePlan:
    """``plan_fn(*args)`` (``tile_plan`` or ``i8_tile_plan``) for the card
    of ``dev``, cached per shape."""
    key = (plan_fn, args, dev)
    plan = _TILE_PLANS.get(key)
    if plan is None:
        if dev not in _SMS:
            _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = _TILE_PLANS[key] = plan_fn(*args, sms=_SMS[dev])
    return plan


def _wgmma_launch(x: torch.Tensor, qt: QuantizedTensor, scale, offset,
                  plan: TilePlan) -> torch.Tensor:
    """Launch ``qmm_nf4_wgmma`` on checked operands and an accepted plan:
    x [M, K] bf16 on the card → y [M, N] bf16."""
    K, N = logical_k(qt), qt.packed.shape[-1]
    x = _aligned(x.to(torch.bfloat16))
    M, dev = x.shape[0], x.device
    y = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    fn = _build.kernel("qmm_nf4_wgmma", "qmm_nf4_wgmma", [_P] * 7 + [_I] * 8 + [_P])
    err = fn(x.data_ptr(), qt.packed.data_ptr(), qt.absmax.data_ptr(),
             None if scale is None else scale.data_ptr(),
             None if offset is None else offset.data_ptr(),
             _code_on(qt.quant_type, dev).data_ptr(), y.data_ptr(), M, K, N, qt.block_size,
             int(qt.double_quant), plan.tm, plan.stages, plan.smem, _build.stream_ptr(x))
    _build.check(err, "qmm_nf4_wgmma")
    return y


def _qmm_launch(x: torch.Tensor, qt: QuantizedTensor) -> tuple:
    """Check the operands and launch the NF4 forward kernel that the shape
    takes: x [M, K] on the card → (y [M, N] bf16, which kernel): "decode"
    up to ``DECODE_ROWS`` rows, "wgmma" above where ``tile_plan`` accepts
    the shape, else "tile" (``qmm_nf4_fwd.cu``).  No rows, no launch
    ("none").  The variant follows ``qt.double_quant``."""
    if qt.quant_type == "int8":
        raise ValueError("the NF4 kernels do not read int8 storage")
    _check_rows(x, logical_k(qt), "x")
    K, N, scale, offset = _check_quantized(qt, x.device)
    M = x.shape[0]
    if M == 0:
        return torch.empty((0, N), dtype=torch.bfloat16, device=x.device), "none"
    if M <= DECODE_ROWS:
        return _decode_launch(x, qt, scale, offset), "decode"
    plan = _plan_on(tile_plan, x.device, M, K, N, qt.block_size)
    if plan.accepted:
        return _wgmma_launch(x, qt, scale, offset, plan), "wgmma"
    return _launch("qmm_nf4_fwd", "qmm_nf4_fwd", x, qt, N, scale, offset), "tile"


def _count(wrapper, took: str) -> None:
    wrapper.launches += took != "none"
    wrapper.decode_launches += took == "decode"
    wrapper.wgmma_launches += took == "wgmma"


def qmm_nf4_fwd_dq(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """The kernel with int8 double-quantized absmax (TPU _qmm_pallas_dq)."""
    if not qt.double_quant:
        raise ValueError("qmm_nf4_fwd_dq needs a double-quantized tensor")
    y, took = _qmm_launch(x, qt)
    _count(qmm_nf4_fwd_dq, took)
    return y


def qmm_nf4_fwd_f32(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """The kernel with f32 absmax (TPU _qmm_pallas)."""
    if qt.double_quant:
        raise ValueError("qmm_nf4_fwd_f32 needs an f32-absmax tensor")
    y, took = _qmm_launch(x, qt)
    _count(qmm_nf4_fwd_f32, took)
    return y


# launches: every call that ran a kernel; decode_launches: those of them
# that took the decode kernel; wgmma_launches: those that took the wgmma
# kernel (the rest took the tile kernel of qmm_nf4_fwd.cu)
qmm_nf4_fwd_dq.launches = qmm_nf4_fwd_dq.decode_launches = qmm_nf4_fwd_dq.wgmma_launches = 0
qmm_nf4_fwd_f32.launches = qmm_nf4_fwd_f32.decode_launches = qmm_nf4_fwd_f32.wgmma_launches = 0


def qmatmul_bwd_plain(g: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """The plain version of the backward: g [M, N] → dx [M, K] bf16, the
    bf16-rounded g times the transposed bf16 weight with f32 accumulation."""
    return bf16_matmul(g, dequantize(qt, torch.bfloat16).T).to(torch.bfloat16)


def qmm_nf4_bwd(g: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """The backward kernel (TPU _qmm_bwd_pallas): dx = g @ dequant(qt)ᵀ for
    g [M, N] on the card → [M, K] bf16.  Double-quantized absmax is decoded
    in the kernel with the forward's arithmetic."""
    if qt.quant_type == "int8":
        raise ValueError("the NF4 kernels do not read int8 storage")
    _check_rows(g, qt.packed.shape[-1], "g")
    K, N, scale, offset = _check_quantized(qt, g.device)
    dx = _launch("qmm_nf4_bwd", "qmm_nf4_bwd", g, qt, K, scale, offset)
    qmm_nf4_bwd.launches += g.shape[0] > 0
    return dx


qmm_nf4_bwd.launches = 0


# ---------------------------------------------------------------------------
# int8 storage, exact: the --bits 8 base (bf16 product of the decoded weight)
# ---------------------------------------------------------------------------

# ``dequantize`` decodes int8 storage as (code * (1/127)) * absmax rounded to
# bf16, which is the kernels' arithmetic: their plain versions are the
# generic ones.
qmm_i8_fwd_plain = qmatmul_plain
qmm_i8_bwd_plain = qmatmul_bwd_plain


def _check_int8(qt: QuantizedTensor, what: str) -> None:
    if qt.quant_type != "int8":
        raise ValueError(f"{what} reads int8 storage, not {qt.quant_type}")


# The int8 forward and dx at prefill and training rows: ``csrc/qmm_i8_wgmma.cu``,
# the NF4 wgmma kernel's pipeline over int8 codes, one TMA box of the
# activation and one decoded weight tile per k-step of 64 contraction rows,
# so the ring holds more k-steps than the NF4 kernel's.
_I8_STAGES = {128: 6, 256: 4}      # rows a CTA -> k-steps in the ring


def i8_tile_smem(tm: int) -> int:
    """Dynamic shared memory of the int8 wgmma kernel at ``tm`` rows a CTA:
    the ring (per k-step an activation box [tm, 64] and a bf16 B tile of
    64 x 128), the two producer warpgroups' codes (two k-steps each), 1024
    bytes of alignment and 1024 of barriers."""
    stage = tm * _TILE_KP * 2 + _TILE_KP * _TILE_N * 2
    return 1024 + _I8_STAGES[tm] * stage + 4 * _TILE_KP * _TILE_N + 1024


def i8_tile_plan(M: int, K: int, N: int, block_size: int, bwd: bool,
                 sms: int = 132) -> TilePlan:
    """The int8 wgmma kernel's plan on a card of ``sms`` SMs: the forward
    x [M, K] @ W [K, N] (output [M, N], contraction K) or, with ``bwd``, dx
    = g [M, N] @ Wᵀ (output [M, K], contraction N).  It refuses up to
    ``DECODE_ROWS`` rows (``qmm_i8.cu`` keeps them) and a contraction that
    is no multiple of 8: TMA reads the activation in boxes of [rows, 64
    columns] and needs its row stride in multiples of 16 bytes.  Ragged M,
    output and contraction are masked in the kernel; block sizes that are no
    multiple of 8 take a slower decode, and N % 8 != 0 forward byte loads.
    A CTA takes 256 rows where 128-row tiles would need more than one wave
    of CTAs, else 128."""
    C, O = (N, K) if bwd else (K, N)
    if M <= DECODE_ROWS:
        return TilePlan(False, f"M={M} rows: up to {DECODE_ROWS} stay on qmm_i8.cu")
    if C % 8:
        return TilePlan(False, f"{'N' if bwd else 'K'}={C} is no multiple of 8: TMA needs a "
                               "16-byte row stride")
    if K <= 0 or N <= 0 or block_size <= 0 or K % block_size:
        return TilePlan(False, f"no int8 shape: K={K} N={N} block {block_size}")
    o_tiles = -(-O // _TILE_N)
    tm = 256 if -(-M // 128) * o_tiles > sms else 128
    return TilePlan(True, "", tm=tm, stages=_I8_STAGES[tm], grid=(-(-M // tm), o_tiles),
                    steps=-(-C // _TILE_KP), smem=i8_tile_smem(tm))


def _i8_wgmma_launch(a: torch.Tensor, qt: QuantizedTensor, scale, offset, plan: TilePlan,
                     bwd: bool) -> torch.Tensor:
    """Launch ``qmm_i8_wgmma_fwd`` or ``_bwd`` on checked operands and an
    accepted plan: a [M, K] (x) or [M, N] (g) bf16 on the card → [M, N] or
    [M, K] bf16."""
    K, N = logical_k(qt), qt.packed.shape[-1]
    a = _aligned(a.to(torch.bfloat16))
    out = torch.empty((a.shape[0], K if bwd else N), dtype=torch.bfloat16, device=a.device)
    entry = "qmm_i8_wgmma_bwd" if bwd else "qmm_i8_wgmma_fwd"
    fn = _build.kernel("qmm_i8_wgmma", entry, [_P] * 7 + [_I] * 8 + [_P])
    err = fn(a.data_ptr(), qt.packed.data_ptr(), qt.absmax.data_ptr(),
             None if scale is None else scale.data_ptr(),
             None if offset is None else offset.data_ptr(), None, out.data_ptr(),
             a.shape[0], K, N, qt.block_size, int(qt.double_quant), plan.tm, plan.stages,
             plan.smem, _build.stream_ptr(a))
    _build.check(err, entry)
    return out


def _i8_launch(a: torch.Tensor, qt: QuantizedTensor, bwd: bool) -> tuple:
    """Check the operands and launch the int8 kernel that the shape takes:
    x [M, K] (forward) or g [M, N] (``bwd``) on the card → (the output
    bf16, which kernel): "wgmma" where ``i8_tile_plan`` accepts the shape,
    else "tile" (``qmm_i8.cu``).  No rows, no launch ("none")."""
    what = "qmm_i8_bwd" if bwd else "qmm_i8_fwd"
    _check_int8(qt, what)
    _check_rows(a, qt.packed.shape[-1] if bwd else logical_k(qt), "g" if bwd else "x")
    K, N, scale, offset = _check_quantized(qt, a.device)
    M = a.shape[0]
    if M == 0:
        return torch.empty((0, K if bwd else N), dtype=torch.bfloat16, device=a.device), "none"
    plan = _plan_on(i8_tile_plan, a.device, M, K, N, qt.block_size, bwd)
    if plan.accepted:
        return _i8_wgmma_launch(a, qt, scale, offset, plan, bwd), "wgmma"
    return _launch("qmm_i8", what, a, qt, K if bwd else N, scale, offset), "tile"


def qmm_i8_fwd(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """The forward kernel over int8 storage (TPU _qmm_pallas_i8): x [M, K]
    on the card → x @ dequant(qt) [M, N] bf16.  f32 or double-quantized
    absmax, decoded in the kernel."""
    y, took = _i8_launch(x, qt, bwd=False)
    qmm_i8_fwd.launches += took != "none"
    qmm_i8_fwd.wgmma_launches += took == "wgmma"
    return y


def qmm_i8_bwd(g: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """The backward kernel over int8 storage (TPU _qmm_bwd_pallas_i8):
    g [M, N] on the card → dx = g @ dequant(qt)ᵀ [M, K] bf16."""
    dx, took = _i8_launch(g, qt, bwd=True)
    qmm_i8_bwd.launches += took != "none"
    qmm_i8_bwd.wgmma_launches += took == "wgmma"
    return dx


# launches: every call that ran a kernel; wgmma_launches: those of them that
# took qmm_i8_wgmma.cu (the rest took the tile kernel of qmm_i8.cu)
qmm_i8_fwd.launches = qmm_i8_fwd.wgmma_launches = 0
qmm_i8_bwd.launches = qmm_i8_bwd.wgmma_launches = 0


# ---------------------------------------------------------------------------
# w8a8: int8 activations times int8 weights, the serving decode path
# ---------------------------------------------------------------------------


def quantize_rows(x: torch.Tensor):
    """Per-row int8 quantization of the activations, outside the kernels as
    in the JAX package: xs = max|x| / 127 (1 for a zero row) f32 [M, 1] and
    x8 = round(x / xs) int8 [M, K]."""
    xf = x.float()
    xs = xf.abs().amax(dim=1, keepdim=True) / 127.0
    xs = torch.where(xs == 0, torch.ones_like(xs), xs)
    return torch.round(xf / xs).to(torch.int8), xs


def w8a8_scales(qt: QuantizedTensor):
    """An NF4/FP4 tensor's per-block absmax folded into per-column int8
    scales: (ratio f32 [K/B, N] = absmax * (127 / col), s_out f32 [N] =
    col / 127), with col[n] the column's largest absmax (1 where 0)."""
    am = absmax_f32(qt)
    col = am.amax(dim=0)
    col = torch.where(col == 0, torch.ones_like(col), col)
    return (am * (127.0 / col)[None, :]).contiguous(), col / 127.0


def w8a8_codes(qt: QuantizedTensor, ratio: torch.Tensor) -> torch.Tensor:
    """The int8 weight the w8a8 kernel decodes from the nibbles:
    round(code[idx] * ratio[k / B, n]) int8 [K, N]."""
    K, N = logical_k(qt), qt.packed.shape[-1]
    vals = _code_on(qt.quant_type, qt.device)[unpack_indices(qt.packed).long()]
    w = vals.reshape(K // qt.block_size, qt.block_size, N) * ratio[:, None, :]
    return torch.round(w).reshape(K, N).to(torch.int8)


def int8_matmul_plain(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """x8 @ w8 as exact integers, returned f64: the products and their sum
    (at most K * 127² < 2^53) are exact in f64 on the CPU and on the card."""
    return x8.double() @ w8.double()


def _w8a8_epilogue(acc: torch.Tensor, s_out: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """float(acc) * s_out[n] rounded to bf16, then times bf16(xs[m]) rounded
    to bf16 again: the two roundings of the JAX package's epilogue."""
    y = (acc.float() * s_out.reshape(1, -1)).to(torch.bfloat16)
    return y * xs.to(torch.bfloat16)


def qmm_i8_direct_plain(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """The plain version of :func:`qmm_i8_direct`: rows of x quantized to
    int8, an exact integer product with the per-column int8 codes, scaled by
    xs[m] * (col[n] / 127)."""
    x8, xs = quantize_rows(x)
    s_out = absmax_f32(qt).reshape(-1) / 127.0
    return _w8a8_epilogue(int8_matmul_plain(x8, qt.packed), s_out, xs)


def qmm_nf4_w8a8_plain(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """The plain version of :func:`qmm_nf4_w8a8`: the nibbles decoded to
    per-column int8 codes, then as :func:`qmm_i8_direct_plain`."""
    x8, xs = quantize_rows(x)
    ratio, s_out = w8a8_scales(qt)
    return _w8a8_epilogue(int8_matmul_plain(x8, w8a8_codes(qt, ratio)), s_out, xs)


def _per_column(qt: QuantizedTensor) -> bool:
    return qt.quant_type == "int8" and qt.block_size == logical_k(qt)


def _launch_w8a8(entry: str, x8: torch.Tensor, qt: QuantizedTensor, ratio, s_out, xs):
    """Launch ``qmm_i8_direct`` or ``qmm_nf4_w8a8`` on x8 int8 [M, K].  With
    scales, y bf16 [M, N] as :func:`_w8a8_epilogue`; with ``s_out`` None, the
    int32 accumulators [M, N] (:func:`_w8a8_accumulators`)."""
    K, N = logical_k(qt), qt.packed.shape[-1]
    _check_rows(x8, K, "x8")
    if x8.dtype != torch.int8 or not x8.is_cuda:
        raise ValueError("x8 must be int8 on the card")
    _check_quantized(qt, x8.device)
    x8 = _aligned(x8)
    M = x8.shape[0]
    out = torch.empty((M, N), device=x8.device,
                      dtype=torch.int32 if s_out is None else torch.bfloat16)
    if M == 0:
        return out
    ptr = lambda t: None if t is None else t.data_ptr()
    if s_out is None:
        xs = None
    else:
        s_out = s_out.to(torch.float32).contiguous()
        xs = xs.to(torch.float32).contiguous()
    if entry == "qmm_i8_direct":
        fn = _build.kernel("qmm_i8_direct", entry, [_P, _P, _P, _P, _P, _I, _I, _I, _P])
        err = fn(x8.data_ptr(), qt.packed.data_ptr(), ptr(s_out), ptr(xs), out.data_ptr(),
                 M, K, N, _build.stream_ptr(x8))
    else:
        fn = _build.kernel("qmm_i8_direct", entry,
                           [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P])
        err = fn(x8.data_ptr(), qt.packed.data_ptr(), ratio.data_ptr(), ptr(s_out), ptr(xs),
                 _code_on(qt.quant_type, x8.device).data_ptr(), out.data_ptr(),
                 M, K, N, qt.block_size, _build.stream_ptr(x8))
    _build.check(err, entry)
    return out


def _w8a8_accumulators(x8: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """For the checks only: the int32 accumulators [M, N] that the w8a8 kernel
    of qt's storage sums for x8 int8 [M, K], before its epilogue.  No launch
    is counted."""
    if _per_column(qt):
        return _launch_w8a8("qmm_i8_direct", x8, qt, None, None, None)
    return _launch_w8a8("qmm_nf4_w8a8", x8, qt, w8a8_scales(qt)[0], None, None)


def qmm_i8_direct(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """The direct int8 kernel (TPU _qmm_pallas_i8_direct) over a per-column
    int8 tensor (``block_size == K``): x [M, K] on the card → [M, N] bf16,
    ``(x8 @ codes) * xs[m] * (col[n] / 127)`` with the int32 sum exact."""
    if not _per_column(qt):
        raise ValueError("qmm_i8_direct needs per-column int8 storage (block_size == K)")
    _check_rows(x, logical_k(qt), "x")
    x8, xs = quantize_rows(x)
    s_out = absmax_f32(qt).reshape(-1) / 127.0
    y = _launch_w8a8("qmm_i8_direct", x8, qt, None, s_out, xs)
    qmm_i8_direct.launches += x.shape[0] > 0
    return y


def qmm_nf4_w8a8(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """The w8a8 kernel over NF4/FP4 storage (TPU _qmm_pallas_w8a8): each
    nibble decoded in the kernel to ``round(code * absmax * 127 / col)``
    int8, then as :func:`qmm_i8_direct`.  Double quant is undone before the
    kernel, where the per-column scales are made."""
    if qt.quant_type == "int8":
        raise ValueError("qmm_nf4_w8a8 reads NF4/FP4 storage")
    _check_rows(x, logical_k(qt), "x")
    x8, xs = quantize_rows(x)
    ratio, s_out = w8a8_scales(qt)
    y = _launch_w8a8("qmm_nf4_w8a8", x8, qt, ratio, s_out, xs)
    qmm_nf4_w8a8.launches += x.shape[0] > 0
    return y


qmm_i8_direct.launches = 0
qmm_nf4_w8a8.launches = 0


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

_IMPL_OVERRIDE: list = [None]


def set_default_impl(impl: Optional[str]) -> None:
    """Choose the forward's arithmetic for every later ``qmatmul``: None is
    the exact bf16 product; "w8a8" opts the forward into the int8
    tensor-core kernels (serving only; the backward stays exact)."""
    if impl not in (None, "w8a8"):
        raise ValueError(f"impl={impl!r}: only 'w8a8' or None")
    _IMPL_OVERRIDE[0] = impl


@contextlib.contextmanager
def default_impl(impl: Optional[str]):
    """Scoped :func:`set_default_impl`: the serving engines wrap their decode
    steps in ``default_impl("w8a8")``."""
    prev = _IMPL_OVERRIDE[0]
    set_default_impl(impl)
    try:
        yield
    finally:
        _IMPL_OVERRIDE[0] = prev


def _forward(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"qmatmul runs on CUDA or the CPU, not {x.device}")
    cuda = x.is_cuda
    if _IMPL_OVERRIDE[0] == "w8a8":
        if _per_column(qt):
            return qmm_i8_direct(x, qt) if cuda else qmm_i8_direct_plain(x, qt)
        if qt.quant_type != "int8":
            return qmm_nf4_w8a8(x, qt) if cuda else qmm_nf4_w8a8_plain(x, qt)
    if not cuda:
        return qmatmul_plain(x, qt)
    if qt.quant_type == "int8":
        return qmm_i8_fwd(x, qt)
    return qmm_nf4_fwd_dq(x, qt) if qt.double_quant else qmm_nf4_fwd_f32(x, qt)


def _backward(g: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    if not g.is_cuda:
        return qmatmul_bwd_plain(g, qt)
    return qmm_i8_bwd(g, qt) if qt.quant_type == "int8" else qmm_nf4_bwd(g, qt)


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
        return _backward(g, ctx.qt).to(ctx.x_dtype), None


def qmatmul(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """``x @ dequant(qt)`` for 2-D x [M, K] → [M, N] (bf16 out, f32 accum).

    Differentiable in x only.  An x that needs no gradient skips autograd
    altogether, so nothing is kept and no backward kernel is launched."""
    if x.requires_grad and torch.is_grad_enabled():
        return _QMatmul.apply(x, qt)
    return _forward(x, qt)
