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
accepts the shape (K % 16 == 0), and the tile kernel of
``csrc/qmm_nf4_fwd.cu`` for the rest.  For int8 storage the forward takes
the same split-K design up to ``DECODE_ROWS`` rows
(``csrc/qmm_i8_decode.cu``, ``decode_launches``; ``i8_decode_plan``
takes every shape ``quantize`` makes);
forward and dx alike take the wgmma design (``csrc/qmm_i8_wgmma.cu``,
``wgmma_launches``) above ``DECODE_ROWS`` rows wherever ``i8_tile_plan``
accepts the shape (a row stride of the activation in multiples of 16
bytes); the tile kernel of ``csrc/qmm_i8.cu``, the decode kernels'
"before", takes the shapes the plans refuse.  The two ``w8a8`` kernels
quantize each row of x to int8, multiply int8 by int8 into int32 on the
tensor cores and scale in the epilogue: the serving engines' decode path.
Over per-column int8 storage up to ``I8_DIRECT_ROWS`` rows (decode steps and
verify chunks), wherever ``i8_direct_decode_plan`` (up to ``DECODE_ROWS``)
or ``i8_direct_verify_plan`` (above) accepts the shape (K % 32 and N % 16
both 0: every model linear and the padded lm_head), a split-K kernel on int8
mma.sync quantizes the rows itself (``csrc/qmm_i8_direct_decode.cu``,
``decode_launches``); over NF4/FP4 storage up to ``DECODE_ROWS`` rows,
wherever ``nf4_w8a8_decode_plan`` accepts the shape (K % 64, N % 16 and the
block size % 32 all 0: every model linear), the same design decodes the
nibbles to int8 codes in the stream and makes the per-column scales itself
(``csrc/qmm_nf4_w8a8_decode.cu``, ``decode_launches``).  More rows and
refused shapes take ``quantize_rows`` and the tile kernel of
``csrc/qmm_i8_direct.cu``, the decode kernels' "before".  Over NF4/FP4
storage above ``DECODE_ROWS`` rows (the w8a8 prefill), wherever
``w8a8_tile_plan`` accepts the shape
(K % 32, N % 8 and the block size % 8 all 0: every model linear), the w8a8
product runs an int8 wgmma kernel that decodes and transposes each weight
tile once for 128 or 256 rows (``csrc/qmm_nf4_w8a8_wgmma.cu``,
``wgmma_launches``).  The kernels take every shape ``quantize`` accepts:
they have none of the TPU's tiling conditions.

The quantized weight is frozen: the backward decodes it again, computes
``dx = g @ dequant(W)ᵀ`` exactly (``qmm_nf4_bwd``, ``qmm_i8_bwd``), also
under ``"w8a8"``, and gives no leaf of the ``QuantizedTensor`` a gradient.
The NF4/FP4 dx above ``DECODE_ROWS`` rows runs the same wgmma design, each
packed byte decoded once for both nibble planes (``csrc/qmm_nf4_bwd_wgmma.cu``,
``wgmma_launches``), wherever ``nf4_bwd_tile_plan`` accepts the shape (N %
8 == 0).  At 1 to ``DECODE_ROWS`` rows (a train step's micro-batch of 16
tokens or fewer) both dx run a split-N weight-streaming kernel: dx's columns
cut into strips of weight rows, the contraction N into splits that one
thread-block cluster adds in split order (``csrc/qmm_nf4_bwd_decode.cu``,
``csrc/qmm_i8_bwd_decode.cu``, ``decode_launches``), wherever
``nf4_bwd_decode_plan`` / ``i8_bwd_decode_plan`` accept the shape (N % 16 ==
0: every model linear).  The rest take ``csrc/qmm_nf4_bwd.cu`` and
``csrc/qmm_i8.cu``.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import math
from typing import Optional

import torch

from qlora_tpu_torch.quant.blockwise import (
    ABSMAX_BLOCK, QuantizedTensor, absmax_f32, dequantize, k_chunk, logical_k, unpack_indices,
)
from qlora_tpu_torch.quant.codebooks import get_code

from . import _build
from .tape import taped


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


# The int8 forward at decode rows: ``csrc/qmm_i8_decode.cu``, the same
# design over int8 codes (a k-step of 16 rows, each byte one weight).
_I8_DECODE_KSTEP = 16        # rows of a k-step of the int8 decode kernel
_I8_DECODE_MAX_UNIT = 1024


@dataclasses.dataclass(frozen=True)
class I8DecodePlan:
    """How ``qmm_i8_decode`` cuts an int8 weight [K, N]: ``strips`` of 128
    columns times ``splits`` runs of whole ``unit``s of rows, one block
    each; the splits of a strip are one cluster.  ``accepted`` says whether
    the shape takes the kernel; ``reason`` says why not."""
    accepted: bool
    reason: str
    splits: int = 0
    unit: int = 0
    strips: int = 0

    def split_rows(self, K: int) -> list:
        """[(r0, r1)] rows of W of each split, as the kernel computes them."""
        units = -(-K // self.unit)
        return [(s * units // self.splits * self.unit,
                 min((s + 1) * units // self.splits * self.unit, K))
                for s in range(self.splits)]


def i8_decode_plan(K: int, N: int, block_size: int, sms: int) -> I8DecodePlan:
    """The int8 decode kernel's split of a weight [K, N], as
    :func:`decode_plan`'s: about ``_DECODE_BLOCKS_PER_SM`` blocks per SM, at
    most one cluster of splits per strip.  A unit is the least multiple of
    16 rows (one k-step) that holds whole absmax blocks (16 rows where that
    would exceed 1024; a block size that is no multiple of 16 then takes the
    kernel's per-element absmax).  It depends on neither M nor the rows'
    values; it refuses only what is no int8 shape."""
    if K <= 0 or N <= 0 or block_size <= 0 or K % block_size:
        return I8DecodePlan(False, f"no int8 shape: K={K} N={N} block {block_size}")
    unit = math.lcm(block_size, _I8_DECODE_KSTEP)
    unit = unit if unit <= _I8_DECODE_MAX_UNIT else _I8_DECODE_KSTEP
    units = -(-K // unit)
    strips = -(-N // _DECODE_COLS)
    splits = min(units, _DECODE_MAX_SPLITS, -(-_DECODE_BLOCKS_PER_SM * sms // strips))
    return I8DecodePlan(True, "", splits, unit, strips)


_PLANS: dict = {}
_SMS: dict = {}


def _sms_on(dev) -> int:
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev]


def _decode_plan_on(qt: QuantizedTensor, dev):
    """The decode kernel's plan for qt's storage and shape on the card of
    ``dev``, cached per shape: :func:`i8_decode_plan` for int8 codes, else
    :func:`decode_plan`."""
    int8 = qt.quant_type == "int8"
    K, N = logical_k(qt), qt.packed.shape[-1]
    key = (int8, K, N, qt.block_size, dev)
    plan = _PLANS.get(key)
    if plan is None:
        plan_fn = i8_decode_plan if int8 else decode_plan
        plan = _PLANS[key] = plan_fn(K, N, qt.block_size, _sms_on(dev))
    return plan


def _decode_launch(x: torch.Tensor, qt: QuantizedTensor, scale, offset,
                   plan=None) -> torch.Tensor:
    """Launch the decode kernel of qt's storage (``qmm_nf4_decode``, or
    ``qmm_i8_decode`` on an accepted plan) on checked operands: x [M, K]
    bf16 on the card → y [M, N] bf16.  It takes any M (groups of 16 rows);
    the dispatch sends it M <= ``DECODE_ROWS``."""
    K, N = logical_k(qt), qt.packed.shape[-1]
    x = _aligned(x.to(torch.bfloat16))
    M, dev = x.shape[0], x.device
    y = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    if M == 0:
        return y
    plan = plan or _decode_plan_on(qt, dev)
    lib = "qmm_i8_decode" if qt.quant_type == "int8" else "qmm_nf4_decode"
    fn = _build.kernel(lib, lib, [_P] * 7 + [_I] * 7 + [_P])
    code = None if qt.quant_type == "int8" else _code_on(qt.quant_type, dev).data_ptr()
    err = fn(x.data_ptr(), qt.packed.data_ptr(), qt.absmax.data_ptr(),
             None if scale is None else scale.data_ptr(),
             None if offset is None else offset.data_ptr(),
             code, y.data_ptr(), M, K, N, qt.block_size,
             int(qt.double_quant), plan.splits, plan.unit, _build.stream_ptr(x))
    _build.check(err, lib)
    return y


# The NF4 forward at prefill and training rows: ``csrc/qmm_nf4_wgmma.cu``, a
# warp-specialised kernel (two consumer warpgroups on wgmma, two producer
# warpgroups decoding the weight) over output tiles of 128 or 256 rows by 128
# columns.
_TILE_N, _TILE_KP = 128, 64
_TILE_STAGES = {128: 3, 256: 2}      # rows a CTA -> k-steps in the ring
# the int8 forward and dx and the NF4 dx take one activation box and one B
# tile a k-step, so their rings hold more k-steps
_I8_STAGES = {128: 6, 256: 4}


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """How a wgmma kernel (``qmm_nf4_wgmma``, ``qmm_i8_wgmma_fwd`` or
    ``_bwd``; ``qmm_nf4_bwd_wgmma`` through :class:`SplitHalfPlan`) cuts its
    output [M, O]: one CTA per ``tm`` x ``tn`` output tile
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
    accepts with K % 16 == 0: TMA reads x in boxes of [rows, 64 columns] and
    needs its row stride (2K bytes) in multiples of 16, and the start of the
    high plane's boxes (column K/2) on a 16-byte boundary (at K/2 % 8 != 0
    the kernel faults with an illegal instruction).  Ragged M, N and K/2
    are masked in the kernel (TMA zero-fills x past M and K; the weight rows
    past K/2 are decoded as zeros).  Other restrictions: none by shape; block
    sizes that are no multiple of 8 take a slower decode with each element's
    own absmax.  A CTA takes 256 rows where 128-row tiles would need more than
    one wave of CTAs (each decoded weight tile then serves twice the rows),
    else 128.  The dispatch sends it more than ``DECODE_ROWS`` rows only."""
    if K % 8:
        return TilePlan(False, f"K={K} is no multiple of 8: TMA needs a 16-byte row stride")
    if K % 16:
        return TilePlan(False, f"K/2={K // 2} is no multiple of 8: TMA starts the high plane's "
                               "boxes of x at column K/2, on a 16-byte boundary")
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
        plan = _TILE_PLANS[key] = plan_fn(*args, sms=_sms_on(dev))
    return plan


def _wgmma_launch(lib: str, entry: str, a: torch.Tensor, qt: QuantizedTensor, outer: int,
                  scale, offset, plan: TilePlan) -> torch.Tensor:
    """Launch a wgmma kernel (``qmm_nf4_wgmma``, ``qmm_nf4_bwd_wgmma``,
    ``qmm_i8_wgmma_fwd`` or ``_bwd``, which take the same argument list) on
    checked operands and an accepted plan: a [M, ·] bf16 on the card → out
    [M, outer] bf16."""
    K, N = logical_k(qt), qt.packed.shape[-1]
    a = _aligned(a.to(torch.bfloat16))
    out = torch.empty((a.shape[0], outer), dtype=torch.bfloat16, device=a.device)
    fn = _build.kernel(lib, entry, [_P] * 7 + [_I] * 8 + [_P])
    code = None if qt.quant_type == "int8" else _code_on(qt.quant_type, a.device).data_ptr()
    err = fn(a.data_ptr(), qt.packed.data_ptr(), qt.absmax.data_ptr(),
             None if scale is None else scale.data_ptr(),
             None if offset is None else offset.data_ptr(), code, out.data_ptr(),
             a.shape[0], K, N, qt.block_size, int(qt.double_quant), plan.tm, plan.stages,
             plan.smem, _build.stream_ptr(a))
    _build.check(err, entry)
    return out


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
        return _wgmma_launch("qmm_nf4_wgmma", "qmm_nf4_wgmma", x, qt, N, scale, offset,
                             plan), "wgmma"
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


# The NF4 dx at training rows: ``csrc/qmm_nf4_bwd_wgmma.cu``, the int8 dx's
# pipeline (the ring of ``_I8_STAGES`` k-steps, each an activation box and
# one B tile of 128 dx columns by 64 n) over split-half planes: a CTA owns 64
# packed rows and writes the dx columns of both their nibbles, two runs of 64.


@dataclasses.dataclass(frozen=True)
class SplitHalfPlan(TilePlan):
    """``nf4_bwd_tile_plan``'s plan: CTA (bm, bp) owns the rows bm * tm ..
    of dx and the packed rows bp * tn/2 .. bp * tn/2 + tn/2 - 1, whose two
    nibble planes are two runs of tn/2 dx columns, at p and at K/2 + p."""

    def tiles(self, M: int, K: int) -> list:
        """[(m0, m1, k0, k1)] rows and dx columns of each CTA's low run, then
        its high run, clipped as the kernel masks them (both runs at packed
        row K/2): two entries a CTA."""
        half, K2 = self.tn // 2, K // 2
        out = []
        for bp in range(self.grid[1]):
            p0, p1 = bp * half, min((bp + 1) * half, K2)
            for bm in range(self.grid[0]):
                m0, m1 = bm * self.tm, min((bm + 1) * self.tm, M)
                out += [(m0, m1, p0, p1), (m0, m1, K2 + p0, K2 + p1)]
        return out


def nf4_bwd_tile_smem(tm: int) -> int:
    """Dynamic shared memory of the NF4 dx kernel at ``tm`` rows a CTA: the
    ring (per k-step a box of g [tm, 64] and a bf16 B tile of 128 x 64), the
    two producer warpgroups' packed bytes (two k-steps of 64 x 64 each), 1024
    bytes of alignment and 1024 of barriers."""
    stage = tm * _TILE_KP * 2 + _TILE_N * _TILE_KP * 2
    return 1024 + _I8_STAGES[tm] * stage + 4 * (_TILE_N // 2) * _TILE_KP + 1024


def nf4_bwd_tile_plan(M: int, K: int, N: int, block_size: int, sms: int = 132) -> TilePlan:
    """The NF4 dx kernel's plan for dx = g [M, N] @ dequant(W)ᵀ [N, K] on a
    card of ``sms`` SMs.  It refuses up to ``DECODE_ROWS`` rows (the dx
    decode kernel's) and N % 8 != 0 (TMA reads g in boxes of [rows, 64
    columns] and needs its row stride in multiples of 16 bytes):
    ``qmm_nf4_bwd.cu`` keeps the latter.  Its
    CTAs cover ceil((K/2) / 64) runs of packed rows; ragged M, N and K/2
    are masked in the kernel; block sizes that are no multiple of 4 take a
    slower decode.  A CTA takes 256 rows where 128-row tiles would need more
    than one wave of CTAs, else 128."""
    if M <= DECODE_ROWS:
        return TilePlan(False, f"M={M} rows: up to {DECODE_ROWS} take qmm_nf4_bwd_decode.cu")
    if N % 8:
        return TilePlan(False, f"N={N} is no multiple of 8: TMA needs a 16-byte row stride")
    if K <= 0 or N <= 0 or block_size <= 0 or K % (2 * block_size):
        return TilePlan(False, f"no NF4 shape: K={K} N={N} block {block_size}")
    o_tiles = -(-(K // 2) // (_TILE_N // 2))
    tm = 256 if -(-M // 128) * o_tiles > sms else 128
    return SplitHalfPlan(True, "", tm=tm, stages=_I8_STAGES[tm], grid=(-(-M // tm), o_tiles),
                         steps=-(-N // _TILE_KP), smem=nf4_bwd_tile_smem(tm))


# The dx at decode rows: ``csrc/qmm_nf4_bwd_decode.cu`` and
# ``csrc/qmm_i8_bwd_decode.cu`` cut dx's columns into strips of weight rows
# (32 packed rows for NF4, 64 dx columns; 64 rows of W for int8) and the
# contraction N into splits of whole 128-column k-steps, one block each; the
# splits of a strip are one cluster, which adds them in split order.  The
# plan depends on (K, N) and the SM count, never on the rows.
_BWD_DECODE_KSTEP = 128      # contraction columns of a k-step
_BWD_DECODE_PASS = 1024      # contraction columns of g a block stages at once
_NF4_BWD_STRIP = 32          # packed rows of a block of the NF4 dx decode kernel
_I8_BWD_STRIP = 64           # rows of W of a block of the int8 dx decode kernel


@dataclasses.dataclass(frozen=True)
class BwdDecodePlan:
    """How a dx decode kernel cuts dx = g [M, N] @ Wᵀ: ``strips`` of
    ``strip`` weight rows (packed rows for NF4, each two dx columns, one in
    each nibble plane: ``planes`` 2) times ``splits`` runs of whole
    128-column k-steps of N, one block each, staged ``cols`` columns at a
    time.  ``accepted`` says whether the shape takes the kernel; ``reason``
    says why not."""
    accepted: bool
    reason: str
    strip: int = 0
    planes: int = 1
    strips: int = 0
    splits: int = 0
    cols: int = 0

    def split_cols(self, N: int) -> list:
        """[(c0, c1)] contraction columns of each split, as the kernel
        computes them."""
        units = -(-N // _BWD_DECODE_KSTEP)
        return [(s * units // self.splits * _BWD_DECODE_KSTEP,
                 min((s + 1) * units // self.splits * _BWD_DECODE_KSTEP, N))
                for s in range(self.splits)]

    def strip_cols(self, K: int) -> list:
        """[[(k0, k1), ...]] the runs of dx columns each strip writes, clipped
        as the kernel masks them: NF4 a run in each plane (packed rows p0 ..
        p1 at p and at K/2 + p), int8 one."""
        rows = K // self.planes
        runs = []
        for i in range(self.strips):
            r0, r1 = i * self.strip, min((i + 1) * self.strip, rows)
            runs.append([(pl * rows + r0, pl * rows + r1) for pl in range(self.planes)])
        return runs

    def smem(self, M: int, block_size: int) -> int:
        """Dynamic shared memory of a block at M rows: g's rows of a pass
        (8 or 16, pitch cols / 2 + 4 words) and, where the block size is a
        multiple of the strip, the strip's absmax rows of the pass in f32,
        4 floats of padding after every 32 columns."""
        rows = 8 if M <= 8 else 16
        aligned = block_size % self.strip == 0
        am = self.planes * (self.cols + 4 * (self.cols // 32)) if aligned else 0
        return (rows * (self.cols // 2 + 4) + am) * 4


def _bwd_decode_plan(rows: int, N: int, strip: int, planes: int, sms: int) -> BwdDecodePlan:
    """As :func:`decode_plan`'s: about ``_DECODE_BLOCKS_PER_SM`` blocks per
    SM, at most one cluster of splits per strip; a split longer than
    ``_BWD_DECODE_PASS`` columns is staged in several passes."""
    strips = -(-rows // strip)
    units = -(-N // _BWD_DECODE_KSTEP)
    splits = min(units, _DECODE_MAX_SPLITS, -(-_DECODE_BLOCKS_PER_SM * sms // strips))
    cols = min(-(-units // splits) * _BWD_DECODE_KSTEP, _BWD_DECODE_PASS)
    return BwdDecodePlan(True, "", strip, planes, strips, splits, cols)


def nf4_bwd_decode_plan(K: int, N: int, block_size: int, sms: int) -> BwdDecodePlan:
    """The NF4 dx decode kernel's cut of dx = g [M <= 16, N] @ dequant(W)ᵀ
    on a card of ``sms`` SMs: strips of 32 packed rows (64 dx columns) times
    splits of the contraction.  It refuses, and ``qmm_nf4_bwd.cu`` keeps: N
    % 16 != 0 (a lane loads 16 bytes of a packed row, which needs the row
    stride in multiples of 16).  Ragged K/2 is masked in the kernel; block
    sizes that are no multiple of 32 take its per-element absmax.  Every
    model linear passes."""
    if K <= 0 or N <= 0 or block_size <= 0 or K % (2 * block_size):
        return BwdDecodePlan(False, f"no NF4 shape: K={K} N={N} block {block_size}")
    if N % 16:
        return BwdDecodePlan(False, f"N={N} is no multiple of 16: a lane loads 16 bytes of a "
                                    "packed row; qmm_nf4_bwd.cu keeps it")
    return _bwd_decode_plan(K // 2, N, _NF4_BWD_STRIP, 2, sms)


def i8_bwd_decode_plan(K: int, N: int, block_size: int, sms: int) -> BwdDecodePlan:
    """The int8 dx decode kernel's cut of dx = g [M <= 16, N] @ dequant(W)ᵀ
    on a card of ``sms`` SMs: strips of 64 rows of W times splits of the
    contraction.  It refuses, and ``qmm_i8.cu`` keeps: N % 16 != 0 (a lane
    loads 16 bytes of a row of W).  Ragged K is masked in the kernel; block
    sizes that are no multiple of 64 take its per-element absmax.  Every
    model linear passes."""
    if K <= 0 or N <= 0 or block_size <= 0 or K % block_size:
        return BwdDecodePlan(False, f"no int8 shape: K={K} N={N} block {block_size}")
    if N % 16:
        return BwdDecodePlan(False, f"N={N} is no multiple of 16: a lane loads 16 bytes of a "
                                    "row of W; qmm_i8.cu keeps it")
    return _bwd_decode_plan(K, N, _I8_BWD_STRIP, 1, sms)


def _bwd_decode_launch(g: torch.Tensor, qt: QuantizedTensor, scale, offset,
                       plan: BwdDecodePlan) -> torch.Tensor:
    """Launch the dx decode kernel of qt's storage (``qmm_nf4_bwd_decode`` or
    ``qmm_i8_bwd_decode``) on checked operands and an accepted plan: g [M,
    N] bf16 on the card → dx [M, K] bf16.  It takes any M (groups of 16
    rows); the dispatch sends it 1 .. ``DECODE_ROWS``."""
    K, N = logical_k(qt), qt.packed.shape[-1]
    g = _aligned(g.to(torch.bfloat16))
    M, dev = g.shape[0], g.device
    dx = torch.empty((M, K), dtype=torch.bfloat16, device=dev)
    lib = "qmm_i8_bwd_decode" if qt.quant_type == "int8" else "qmm_nf4_bwd_decode"
    fn = _build.kernel(lib, lib, [_P] * 7 + [_I] * 6 + [_P])
    code = None if qt.quant_type == "int8" else _code_on(qt.quant_type, dev).data_ptr()
    err = fn(g.data_ptr(), qt.packed.data_ptr(), qt.absmax.data_ptr(),
             None if scale is None else scale.data_ptr(),
             None if offset is None else offset.data_ptr(),
             code, dx.data_ptr(), M, K, N, qt.block_size, int(qt.double_quant), plan.splits,
             _build.stream_ptr(g))
    _build.check(err, lib)
    return dx


def _bwd_launch(g: torch.Tensor, qt: QuantizedTensor) -> tuple:
    """Check the operands and launch the dx kernel that the shape takes: g
    [M, N] on the card → (dx [M, K] bf16, which kernel): "decode" for 1 ..
    ``DECODE_ROWS`` rows where the storage's decode plan accepts the shape,
    "wgmma" above where its tile plan does, else "tile" (``qmm_nf4_bwd.cu``
    or ``qmm_i8.cu``).  No rows, no launch ("none")."""
    int8 = qt.quant_type == "int8"
    _check_rows(g, qt.packed.shape[-1], "g")
    K, N, scale, offset = _check_quantized(qt, g.device)
    M, dev = g.shape[0], g.device
    if M == 0:
        return torch.empty((0, K), dtype=torch.bfloat16, device=dev), "none"
    if M <= DECODE_ROWS:
        plan_fn = i8_bwd_decode_plan if int8 else nf4_bwd_decode_plan
        plan = _plan_on(plan_fn, dev, K, N, qt.block_size)
        if plan.accepted:
            return _bwd_decode_launch(g, qt, scale, offset, plan), "decode"
    if int8:      # (library, C entry) of the wgmma kernel and of the tile kernel
        plan = _plan_on(i8_tile_plan, dev, M, K, N, qt.block_size, True)
        wgmma, tile = ("qmm_i8_wgmma", "qmm_i8_wgmma_bwd"), ("qmm_i8", "qmm_i8_bwd")
    else:
        plan = _plan_on(nf4_bwd_tile_plan, dev, M, K, N, qt.block_size)
        wgmma, tile = ("qmm_nf4_bwd_wgmma",) * 2, ("qmm_nf4_bwd",) * 2
    if plan.accepted:
        return _wgmma_launch(*wgmma, g, qt, K, scale, offset, plan), "wgmma"
    return _launch(*tile, g, qt, K, scale, offset), "tile"


def qmm_nf4_bwd(g: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """The backward kernel (TPU _qmm_bwd_pallas): dx = g @ dequant(qt)ᵀ for
    g [M, N] on the card → [M, K] bf16.  Double-quantized absmax is decoded
    in the kernel with the forward's arithmetic.  Up to ``DECODE_ROWS`` rows,
    where ``nf4_bwd_decode_plan`` accepts the shape, the dx decode kernel
    (counted in ``decode_launches``); above, where ``nf4_bwd_tile_plan``
    accepts it, the wgmma kernel (``wgmma_launches``); else
    ``qmm_nf4_bwd.cu``."""
    if qt.quant_type == "int8":
        raise ValueError("the NF4 kernels do not read int8 storage")
    dx, took = _bwd_launch(g, qt)
    _count(qmm_nf4_bwd, took)
    return dx


# launches: every call that ran a kernel; decode_launches: those of them that
# took qmm_nf4_bwd_decode.cu; wgmma_launches: those that took
# qmm_nf4_bwd_wgmma.cu (the rest took qmm_nf4_bwd.cu)
qmm_nf4_bwd.launches = qmm_nf4_bwd.decode_launches = qmm_nf4_bwd.wgmma_launches = 0


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
# activation and one decoded weight tile per k-step of 64 contraction rows.


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
    ``DECODE_ROWS`` rows (the decode kernels keep them) and a contraction that
    is no multiple of 8: TMA reads the activation in boxes of [rows, 64
    columns] and needs its row stride in multiples of 16 bytes.  Ragged M,
    output and contraction are masked in the kernel; block sizes that are no
    multiple of 8 take a slower decode, and N % 8 != 0 forward byte loads.
    A CTA takes 256 rows where 128-row tiles would need more than one wave
    of CTAs, else 128."""
    C, O = (N, K) if bwd else (K, N)
    if M <= DECODE_ROWS:
        return TilePlan(False, f"M={M} rows: up to {DECODE_ROWS} take qmm_i8_decode.cu "
                               "forward and qmm_i8_bwd_decode.cu backward")
    if C % 8:
        return TilePlan(False, f"{'N' if bwd else 'K'}={C} is no multiple of 8: TMA needs a "
                               "16-byte row stride")
    if K <= 0 or N <= 0 or block_size <= 0 or K % block_size:
        return TilePlan(False, f"no int8 shape: K={K} N={N} block {block_size}")
    o_tiles = -(-O // _TILE_N)
    tm = 256 if -(-M // 128) * o_tiles > sms else 128
    return TilePlan(True, "", tm=tm, stages=_I8_STAGES[tm], grid=(-(-M // tm), o_tiles),
                    steps=-(-C // _TILE_KP), smem=i8_tile_smem(tm))


def _i8_launch(x: torch.Tensor, qt: QuantizedTensor) -> tuple:
    """Check the operands and launch the int8 forward kernel that the shape
    takes: x [M, K] on the card → (y [M, N] bf16, which kernel): "decode" up
    to ``DECODE_ROWS`` rows (a shape ``i8_decode_plan`` refuses raises),
    "wgmma" where ``i8_tile_plan`` accepts it, else "tile" (``qmm_i8.cu``).
    No rows, no launch ("none")."""
    _check_int8(qt, "qmm_i8_fwd")
    _check_rows(x, logical_k(qt), "x")
    K, N, scale, offset = _check_quantized(qt, x.device)
    M = x.shape[0]
    if M == 0:
        return torch.empty((0, N), dtype=torch.bfloat16, device=x.device), "none"
    if M <= DECODE_ROWS:
        plan = _decode_plan_on(qt, x.device)
        if not plan.accepted:
            raise ValueError(f"qmm_i8_fwd: {plan.reason}")
        return _decode_launch(x, qt, scale, offset, plan), "decode"
    plan = _plan_on(i8_tile_plan, x.device, M, K, N, qt.block_size, False)
    if plan.accepted:
        return _wgmma_launch("qmm_i8_wgmma", "qmm_i8_wgmma_fwd", x, qt, N, scale, offset,
                             plan), "wgmma"
    return _launch("qmm_i8", "qmm_i8_fwd", x, qt, N, scale, offset), "tile"


def qmm_i8_fwd(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """The forward kernel over int8 storage (TPU _qmm_pallas_i8): x [M, K]
    on the card → x @ dequant(qt) [M, N] bf16.  f32 or double-quantized
    absmax, decoded in the kernel.  Up to ``DECODE_ROWS`` rows the decode
    kernel (counted in ``decode_launches``), above the wgmma kernel
    (``wgmma_launches``)."""
    y, took = _i8_launch(x, qt)
    _count(qmm_i8_fwd, took)
    return y


def qmm_i8_bwd(g: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """The backward kernel over int8 storage (TPU _qmm_bwd_pallas_i8):
    g [M, N] on the card → dx = g @ dequant(qt)ᵀ [M, K] bf16.  Up to
    ``DECODE_ROWS`` rows, where ``i8_bwd_decode_plan`` accepts the shape,
    the dx decode kernel (counted in ``decode_launches``); above, where
    ``i8_tile_plan`` accepts it, the wgmma kernel (``wgmma_launches``); else
    ``qmm_i8.cu``."""
    _check_int8(qt, "qmm_i8_bwd")
    dx, took = _bwd_launch(g, qt)
    _count(qmm_i8_bwd, took)
    return dx


# launches: every call that ran a kernel; decode_launches: those of them
# that took qmm_i8_decode.cu (forward) or qmm_i8_bwd_decode.cu (dx);
# wgmma_launches: those that took qmm_i8_wgmma.cu (the rest took the tile
# kernel of qmm_i8.cu)
qmm_i8_fwd.launches = qmm_i8_fwd.decode_launches = qmm_i8_fwd.wgmma_launches = 0
qmm_i8_bwd.launches = qmm_i8_bwd.decode_launches = qmm_i8_bwd.wgmma_launches = 0


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
    # 127 / col as a tensor divided by a tensor: a true division, as JAX's
    # (a Python scalar over a tensor would be col.reciprocal() * 127)
    inv = torch.full_like(col, 127.0) / col
    return (am * inv[None, :]).contiguous(), col / 127.0


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


# The direct int8 forward at decode rows: ``csrc/qmm_i8_direct_decode.cu``,
# the int8 decode kernel's split-K cluster design on int8 mma.sync
# (m16n8k32), the rows of x quantized inside the kernel.
I8_DIRECT_ROWS = 64          # rows of x the kernel takes over per-column int8 storage
_I8_DIRECT_KSTEP = 32        # rows of a k-step: one m16n8k32's depth
_I8_DIRECT_MAX_ROWS = 4096   # rows of W a split up to 16 rows of x: its slice of x staged whole
_I8_DIRECT_WIDE_MAX_ROWS = 1536   # the same above 16 rows: x8 of 64 rows of it staged whole


@dataclasses.dataclass(frozen=True)
class I8DirectDecodePlan:
    """How ``qmm_i8_direct_decode`` cuts a per-column int8 weight [K, N]:
    ``strips`` of 128 columns times ``splits`` runs of whole 32-row
    k-steps, one block each; the splits of a strip are one cluster.
    ``accepted`` says whether the shape takes the kernel; ``reason`` says
    why not."""
    accepted: bool
    reason: str
    splits: int = 0
    strips: int = 0

    def split_rows(self, K: int) -> list:
        """[(r0, r1)] rows of W of each split, as the kernel computes them."""
        steps = K // _I8_DIRECT_KSTEP
        return [(s * steps // self.splits * _I8_DIRECT_KSTEP,
                 (s + 1) * steps // self.splits * _I8_DIRECT_KSTEP) for s in range(self.splits)]


def _i8_direct_plan(K: int, N: int, sms: int, max_rows: int) -> I8DirectDecodePlan:
    """The direct int8 kernel's split of a weight [K, N] on a card of
    ``sms`` SMs: about ``_DECODE_BLOCKS_PER_SM`` blocks per SM, more splits
    where a split would pass ``max_rows`` rows, at most one cluster of them;
    the refusals of :func:`i8_direct_decode_plan`."""
    if K <= 0 or N <= 0:
        return I8DirectDecodePlan(False, f"no int8 shape: K={K} N={N}")
    if K % _I8_DIRECT_KSTEP:
        return I8DirectDecodePlan(False, f"K={K} is no multiple of 32: a k-step is one "
                                         "m16n8k32's depth; qmm_i8_direct.cu keeps it")
    if N % 16:
        return I8DirectDecodePlan(False, f"N={N} is no multiple of 16: a lane streams 16 "
                                         "columns; qmm_i8_direct.cu keeps it")
    steps = K // _I8_DIRECT_KSTEP
    strips = -(-N // _DECODE_COLS)
    splits = min(steps, _DECODE_MAX_SPLITS,
                 max(-(-_DECODE_BLOCKS_PER_SM * sms // strips), -(-K // max_rows)))
    if -(-steps // splits) * _I8_DIRECT_KSTEP > max_rows:
        return I8DirectDecodePlan(False, f"K={K}: 16 splits of at most {max_rows} rows cannot "
                                         "cover it; qmm_i8_direct.cu keeps it")
    return I8DirectDecodePlan(True, "", splits, strips)


def i8_direct_decode_plan(K: int, N: int, sms: int) -> I8DirectDecodePlan:
    """The direct int8 decode kernel's split of a weight [K, N] on a card of
    ``sms`` SMs for 1 to ``DECODE_ROWS`` rows of x, as
    :func:`i8_decode_plan`'s: about ``_DECODE_BLOCKS_PER_SM`` blocks per SM,
    at most one cluster of splits per strip, more splits where a split would
    pass 4096 rows (whose slice of x a block stages whole).  It depends on
    neither M nor the rows' values.  It refuses, and ``qmm_i8_direct.cu``
    keeps: K % 32 != 0 (a k-step is one m16n8k32's depth), N % 16 != 0 (a
    lane streams 16 columns) and K past 16 splits of 4096 rows.  Every
    LLaMA-7B linear passes, and so does the lm_head padded to 32768
    columns."""
    return _i8_direct_plan(K, N, sms, _I8_DIRECT_MAX_ROWS)


def i8_direct_verify_plan(K: int, N: int, sms: int) -> I8DirectDecodePlan:
    """The same kernel's split for ``DECODE_ROWS`` + 1 to ``I8_DIRECT_ROWS``
    rows of x (verify chunks, wide decode batches): as
    :func:`i8_direct_decode_plan`'s, with splits of at most 1536 rows (x8 of
    64 rows of one is staged whole, and two blocks fit an SM).  It depends on
    neither M nor the rows' values, and refuses what
    :func:`i8_direct_decode_plan` refuses and K past 16 splits of 1536 rows.
    Since the sums are exact integers, the two plans' splits give the same
    bits."""
    return _i8_direct_plan(K, N, sms, _I8_DIRECT_WIDE_MAX_ROWS)


def _i8_direct_decode_launch(x: torch.Tensor, qt: QuantizedTensor, plan: I8DirectDecodePlan,
                             raw: bool = False, rows=None):
    """Launch ``qmm_i8_direct_decode`` on x [M <= 64, K] bf16 on the card
    (checked by the caller) over per-column int8 storage, on an accepted
    plan for M (:func:`i8_direct_decode_plan` up to ``DECODE_ROWS`` rows,
    :func:`i8_direct_verify_plan` above): y bf16 [M, N], or with ``raw`` the
    int32 accumulators [M, N].
    ``rows`` None: the kernel quantizes x's rows itself; "out": it also
    writes the x8 int8 [M, K] and xs f32 [M, 1] it made, and the call
    returns (y, x8, xs); a pair (x8, xs): it multiplies those instead of
    quantizing x."""
    K, N = logical_k(qt), qt.packed.shape[-1]
    x = _aligned(x.to(torch.bfloat16))
    M, dev = x.shape[0], x.device
    col = None
    if not raw:
        col = qt.absmax if not qt.double_quant else absmax_f32(qt)
        col = _aligned(col.reshape(-1).to(torch.float32))
    y = torch.empty((M, N), dtype=torch.int32 if raw else torch.bfloat16, device=dev)
    given, x8, xs = _row_buffers(rows, M, K, dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    fn = _build.kernel("qmm_i8_direct_decode", "qmm_i8_direct_decode",
                       [_P] * 6 + [_I] * 5 + [_P])
    err = fn(x.data_ptr(), qt.packed.data_ptr(), ptr(col), y.data_ptr(), ptr(x8), ptr(xs),
             M, K, N, plan.splits, int(given), _build.stream_ptr(x))
    _build.check(err, "qmm_i8_direct_decode")
    return (y, x8, xs.reshape(M, 1)) if rows == "out" else y


def _row_buffers(rows, M: int, K: int, dev) -> tuple:
    """(given, x8, xs) for a decode kernel that quantizes its rows itself:
    ``rows`` None: no buffers; "out": empty x8 int8 [M, K] and xs f32 [M]
    for the kernel to write; a pair (x8, xs): those, for it to read."""
    if isinstance(rows, tuple):
        return (True, _aligned(rows[0].to(dev, torch.int8)),
                rows[1].to(dev, torch.float32).reshape(-1).contiguous())
    if rows == "out":
        return (False, torch.empty((M, K), dtype=torch.int8, device=dev),
                torch.empty((M,), dtype=torch.float32, device=dev))
    return False, None, None


# The w8a8 forward over NF4/FP4 storage at decode rows:
# ``csrc/qmm_nf4_w8a8_decode.cu``, the direct decode kernel's design over
# packed nibbles (a k-step of 32 packed rows, each byte two codes of one
# column, one in each plane), the rows quantized and the per-column scales
# made inside the kernel.  Its plan is an :class:`I8DirectDecodePlan` over
# the K/2 packed rows.
_NF4_W8A8_MAX_ROWS = 2048    # packed rows a split: its two runs of x are staged whole


def nf4_w8a8_decode_plan(K: int, N: int, block_size: int, sms: int) -> I8DirectDecodePlan:
    """The NF4 w8a8 decode kernel's split of a packed weight [K/2, N] on a
    card of ``sms`` SMs, as :func:`i8_direct_decode_plan`'s over K/2 packed
    rows (``split_rows(K // 2)`` gives each split's packed rows): about
    ``_DECODE_BLOCKS_PER_SM`` blocks per SM, at most one cluster of splits
    per strip, more splits where a split would pass 2048 packed rows (whose
    two runs of x a block stages whole).  It depends on neither M nor the
    rows' values.  It refuses, and ``qmm_i8_direct.cu`` keeps: K % 64 != 0
    (whole k-steps of 32 packed rows), N % 16 != 0 (a lane streams 16
    columns), block sizes that are no multiple of 32 (a k-step must lie in
    one absmax block) and K past 16 splits of 2048 packed rows.  Every
    LLaMA-7B block linear passes."""
    if K <= 0 or N <= 0 or block_size <= 0 or K % (2 * block_size):
        return I8DirectDecodePlan(False, f"no NF4 shape: K={K} N={N} block {block_size}")
    if K % (2 * _I8_DIRECT_KSTEP):
        return I8DirectDecodePlan(False, f"K={K} is no multiple of 64: a k-step is 32 packed "
                                         "rows, one m16n8k32's depth in each plane; "
                                         "qmm_i8_direct.cu keeps it")
    if N % 16:
        return I8DirectDecodePlan(False, f"N={N} is no multiple of 16: a lane streams 16 "
                                         "columns; qmm_i8_direct.cu keeps it")
    if block_size % _I8_DIRECT_KSTEP:
        return I8DirectDecodePlan(False, f"block {block_size} is no multiple of 32: a k-step "
                                         "of 32 packed rows must lie in one absmax block; "
                                         "qmm_i8_direct.cu keeps it")
    steps = K // 2 // _I8_DIRECT_KSTEP
    strips = -(-N // _DECODE_COLS)
    longest = -(-(K // 2) // _NF4_W8A8_MAX_ROWS)
    splits = min(steps, _DECODE_MAX_SPLITS,
                 max(-(-_DECODE_BLOCKS_PER_SM * sms // strips), longest))
    if -(-steps // splits) * _I8_DIRECT_KSTEP > _NF4_W8A8_MAX_ROWS:
        return I8DirectDecodePlan(False, f"K={K}: 16 splits of at most 2048 packed rows cannot "
                                         "cover it; qmm_i8_direct.cu keeps it")
    return I8DirectDecodePlan(True, "", splits, strips)


def _nf4_w8a8_decode_launch(x: torch.Tensor, qt: QuantizedTensor, plan: I8DirectDecodePlan,
                            raw: bool = False, rows=None):
    """Launch ``qmm_nf4_w8a8_decode`` on x [M <= 16, K] bf16 on the card over
    NF4/FP4 storage (checked here), on an accepted plan: y bf16 [M, N], or
    with ``raw`` the int32 accumulators [M, N].  The kernel makes the
    per-column scales from the stored absmax itself.  ``rows`` None: it
    quantizes x's rows itself; "out": it also writes the x8 int8 [M, K] and
    xs f32 [M, 1] it made, and the call returns (y, x8, xs); a pair (x8,
    xs): it multiplies those instead of quantizing x."""
    K, N, scale, offset = _check_quantized(qt, x.device)
    x = _aligned(x.to(torch.bfloat16))
    M, dev = x.shape[0], x.device
    y = torch.empty((M, N), dtype=torch.int32 if raw else torch.bfloat16, device=dev)
    given, x8, xs = _row_buffers(rows, M, K, dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    fn = _build.kernel("qmm_nf4_w8a8_decode", "qmm_nf4_w8a8_decode", [_P] * 9 + [_I] * 8 + [_P])
    err = fn(x.data_ptr(), qt.packed.data_ptr(), qt.absmax.data_ptr(), ptr(scale), ptr(offset),
             _code_on(qt.quant_type, dev).data_ptr(), y.data_ptr(), ptr(x8), ptr(xs),
             M, K, N, qt.block_size, int(qt.double_quant), plan.splits, int(given), int(raw),
             _build.stream_ptr(x))
    _build.check(err, "qmm_nf4_w8a8_decode")
    return (y, x8, xs.reshape(M, 1)) if rows == "out" else y


# The w8a8 forward over NF4/FP4 storage above ``DECODE_ROWS`` rows:
# ``csrc/qmm_nf4_w8a8_wgmma.cu``, the NF4 wgmma kernel's pipeline on int8
# wgmma (x8 in two TMA boxes a k-step, the weight decoded to int8 codes and
# transposed into K-major B tiles by two producer warpgroups).
_W8A8_STAGES = {128: 6, 256: 4}       # rows a CTA -> k-steps in the ring


def w8a8_tile_smem(tm: int) -> int:
    """Dynamic shared memory of the w8a8 wgmma kernel at ``tm`` rows a CTA:
    the ring (per k-step two x8 boxes [tm, 64] and two int8 B tiles of 128
    columns by 64 k), the two producer warpgroups' packed bytes (two k-steps
    each), 1024 bytes of alignment and 1024 of barriers."""
    stage = 2 * tm * _TILE_KP + 2 * _TILE_N * _TILE_KP
    return 1024 + _W8A8_STAGES[tm] * stage + 4 * _TILE_KP * _TILE_N + 1024


def w8a8_tile_plan(M: int, K: int, N: int, block_size: int, sms: int = 132) -> TilePlan:
    """The w8a8 wgmma kernel's plan for x8 [M, K] @ w8 [K, N] decoded from
    NF4/FP4 nibbles, on a card of ``sms`` SMs.  It refuses, and
    ``qmm_i8_direct.cu`` keeps: up to ``DECODE_ROWS`` rows; K % 32 != 0 (TMA
    reads x8 in boxes of [rows, 64 bytes] from column kp and from K/2 + kp,
    and needs the high plane's start on a 16-byte boundary); N % 8 != 0 (a
    producer thread loads 8 packed bytes and two 16-byte runs of ratios a
    row); block sizes that are no multiple of 8 (a thread's 8 rows must lie
    in one block).  Every model linear passes.  Ragged M, N and K/2 are
    masked in the kernel.  A CTA takes 256 rows where 128-row tiles would
    need more than one wave of CTAs, else 128."""
    if M <= DECODE_ROWS:
        return TilePlan(False, f"M={M} rows: up to {DECODE_ROWS} stay on qmm_i8_direct.cu")
    if K % 32:
        return TilePlan(False, f"K={K} is no multiple of 32: TMA starts the high plane's boxes "
                               "of x8 at column K/2, on a 16-byte boundary")
    if N <= 0 or block_size <= 0 or K % (2 * block_size):
        return TilePlan(False, f"no NF4 shape: K={K} N={N} block {block_size}")
    if N % 8 or block_size % 8:
        return TilePlan(False, f"N={N}, block {block_size}: the producers take 8 columns and "
                               "8 rows of one block a thread; qmm_i8_direct.cu keeps the rest")
    n_tiles = -(-N // _TILE_N)
    tm = 256 if -(-M // 128) * n_tiles > sms else 128
    return TilePlan(True, "", tm=tm, stages=_W8A8_STAGES[tm], grid=(-(-M // tm), n_tiles),
                    steps=-(-(K // 2) // _TILE_KP), smem=w8a8_tile_smem(tm))


def _launch_w8a8(entry: str, x8: torch.Tensor, qt: QuantizedTensor, ratio, s_out, xs,
                 plan: Optional[TilePlan] = None):
    """Launch ``qmm_i8_direct``, ``qmm_nf4_w8a8`` (``qmm_i8_direct.cu``) or
    ``qmm_nf4_w8a8_wgmma`` (on an accepted ``plan``) on x8 int8 [M, K].  With
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
    stream = _build.stream_ptr(x8)
    if entry == "qmm_i8_direct":
        fn = _build.kernel("qmm_i8_direct", entry, [_P, _P, _P, _P, _P, _I, _I, _I, _P])
        err = fn(x8.data_ptr(), qt.packed.data_ptr(), ptr(s_out), ptr(xs), out.data_ptr(),
                 M, K, N, stream)
    elif entry == "qmm_nf4_w8a8":
        fn = _build.kernel("qmm_i8_direct", entry,
                           [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P])
        err = fn(x8.data_ptr(), qt.packed.data_ptr(), ratio.data_ptr(), ptr(s_out), ptr(xs),
                 _code_on(qt.quant_type, x8.device).data_ptr(), out.data_ptr(),
                 M, K, N, qt.block_size, stream)
    else:
        fn = _build.kernel("qmm_nf4_w8a8_wgmma", entry, [_P] * 7 + [_I] * 7 + [_P])
        err = fn(x8.data_ptr(), qt.packed.data_ptr(), ratio.data_ptr(), ptr(s_out), ptr(xs),
                 _code_on(qt.quant_type, x8.device).data_ptr(), out.data_ptr(),
                 M, K, N, qt.block_size, plan.tm, plan.stages, plan.smem, stream)
    _build.check(err, entry)
    return out


def _w8a8_nf4_entry(x8: torch.Tensor, qt: QuantizedTensor) -> tuple:
    """Which kernel takes an NF4/FP4 w8a8 product of x8's rows: (entry,
    plan) -- ``qmm_nf4_w8a8_wgmma`` where :func:`w8a8_tile_plan` accepts the
    shape, else ``qmm_nf4_w8a8`` (``qmm_i8_direct.cu``) with no plan."""
    K, N = logical_k(qt), qt.packed.shape[-1]
    plan = _plan_on(w8a8_tile_plan, x8.device, x8.shape[0], K, N, qt.block_size)
    return ("qmm_nf4_w8a8_wgmma", plan) if plan.accepted else ("qmm_nf4_w8a8", None)


def _w8a8_accumulators(x8: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """For the checks only: the int32 accumulators [M, N] that the w8a8 kernel
    of qt's storage and x8's rows sums for x8 int8 [M, K], before its
    epilogue.  No launch is counted."""
    if _per_column(qt):
        return _launch_w8a8("qmm_i8_direct", x8, qt, None, None, None)
    entry, plan = _w8a8_nf4_entry(x8, qt)
    return _launch_w8a8(entry, x8, qt, w8a8_scales(qt)[0], None, None, plan)


def _i8_direct_decode_plan_on(x: torch.Tensor, qt: QuantizedTensor):
    """The split-K kernel's plan for x's rows over qt's storage (per-column
    int8: :func:`i8_direct_decode_plan` up to ``DECODE_ROWS`` rows,
    :func:`i8_direct_verify_plan` up to ``I8_DIRECT_ROWS``; NF4/FP4:
    :func:`nf4_w8a8_decode_plan` up to ``DECODE_ROWS``), or None where they
    stay on ``qmm_i8_direct.cu``: no rows, more, or a shape the plan
    refuses."""
    M = x.shape[0]
    K, N = logical_k(qt), qt.packed.shape[-1]
    if qt.quant_type == "int8" and 0 < M <= I8_DIRECT_ROWS:
        fn = i8_direct_decode_plan if M <= DECODE_ROWS else i8_direct_verify_plan
        plan = _plan_on(fn, x.device, K, N)
    elif qt.quant_type != "int8" and 0 < M <= DECODE_ROWS:
        plan = _plan_on(nf4_w8a8_decode_plan, x.device, K, N, qt.block_size)
    else:
        return None
    return plan if plan.accepted else None


def _i8_direct_decode_outputs(x: torch.Tensor, qt: QuantizedTensor) -> tuple:
    """For the checks only: (int32 accumulators [M, N], x8 int8 [M, K], xs f32
    [M, 1]) as the direct split-K kernel makes them from x [M <= 64, K] on the
    card.  No launch is counted."""
    _check_quantized(qt, x.device)
    plan = _i8_direct_decode_plan_on(x, qt)
    if plan is None:
        raise ValueError(f"qmm_i8_direct_decode does not take x {tuple(x.shape)} @ "
                         f"{tuple(qt.packed.shape)}")
    return _i8_direct_decode_launch(x, qt, plan, raw=True, rows="out")


def _nf4_w8a8_decode_outputs(x: torch.Tensor, qt: QuantizedTensor) -> tuple:
    """For the checks only: (int32 accumulators [M, N], x8 int8 [M, K], xs f32
    [M, 1]) as the NF4 w8a8 decode kernel makes them from x [M <= 16, K] on
    the card.  No launch is counted."""
    plan = _i8_direct_decode_plan_on(x, qt)
    if qt.quant_type == "int8" or plan is None:
        raise ValueError(f"qmm_nf4_w8a8_decode does not take x {tuple(x.shape)} @ "
                         f"{qt.quant_type} {tuple(qt.packed.shape)} block {qt.block_size}")
    return _nf4_w8a8_decode_launch(x, qt, plan, raw=True, rows="out")


def qmm_i8_direct(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """The direct int8 kernel (TPU _qmm_pallas_i8_direct) over a per-column
    int8 tensor (``block_size == K``): x [M, K] on the card → [M, N] bf16,
    ``(x8 @ codes) * xs[m] * (col[n] / 127)`` with the int32 sum exact.  Up
    to ``I8_DIRECT_ROWS`` rows, where the plan for them
    (``i8_direct_decode_plan`` up to ``DECODE_ROWS``, ``i8_direct_verify_plan``
    above) accepts the shape, ``qmm_i8_direct_decode.cu`` quantizes the rows
    itself (counted in ``decode_launches``); else ``quantize_rows`` and
    ``qmm_i8_direct.cu``."""
    if not _per_column(qt):
        raise ValueError("qmm_i8_direct needs per-column int8 storage (block_size == K)")
    _check_rows(x, logical_k(qt), "x")
    plan = _i8_direct_decode_plan_on(x, qt)
    if plan is not None:
        _check_quantized(qt, x.device)
        y = _i8_direct_decode_launch(x, qt, plan)
    else:
        x8, xs = quantize_rows(x)
        s_out = absmax_f32(qt).reshape(-1) / 127.0
        y = _launch_w8a8("qmm_i8_direct", x8, qt, None, s_out, xs)
    qmm_i8_direct.launches += x.shape[0] > 0
    qmm_i8_direct.decode_launches += plan is not None
    return y


def qmm_nf4_w8a8(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """The w8a8 kernel over NF4/FP4 storage (TPU _qmm_pallas_w8a8): each
    nibble decoded in the kernel to ``round(code * absmax * 127 / col)``
    int8, then as :func:`qmm_i8_direct`.  Up to ``DECODE_ROWS`` rows, where
    ``nf4_w8a8_decode_plan`` accepts the shape, ``qmm_nf4_w8a8_decode.cu``
    quantizes the rows and makes the per-column scales itself, from the
    stored absmax (counted in ``decode_launches``).  Otherwise the rows are
    quantized and the scales made (double quant undone) by PyTorch ops before
    the kernel: above ``DECODE_ROWS`` rows, where ``w8a8_tile_plan`` accepts
    the shape, the int8 wgmma kernel (``wgmma_launches``); else
    ``qmm_i8_direct.cu``."""
    if qt.quant_type == "int8":
        raise ValueError("qmm_nf4_w8a8 reads NF4/FP4 storage")
    _check_rows(x, logical_k(qt), "x")
    decode = _i8_direct_decode_plan_on(x, qt)
    plan = None
    if decode is not None:
        y = _nf4_w8a8_decode_launch(x, qt, decode)
    else:
        x8, xs = quantize_rows(x)
        ratio, s_out = w8a8_scales(qt)
        entry, plan = _w8a8_nf4_entry(x8, qt)
        y = _launch_w8a8(entry, x8, qt, ratio, s_out, xs, plan)
    qmm_nf4_w8a8.launches += x.shape[0] > 0
    qmm_nf4_w8a8.decode_launches += decode is not None
    qmm_nf4_w8a8.wgmma_launches += plan is not None
    return y


# launches: every call that ran a kernel; decode_launches: those of them that
# took qmm_i8_direct_decode.cu (qmm_i8_direct, up to I8_DIRECT_ROWS rows) or
# qmm_nf4_w8a8_decode.cu (qmm_nf4_w8a8); wgmma_launches (qmm_nf4_w8a8): those
# that took qmm_nf4_w8a8_wgmma.cu (the rest of both took qmm_i8_direct.cu)
qmm_i8_direct.launches = qmm_i8_direct.decode_launches = 0
qmm_nf4_w8a8.launches = qmm_nf4_w8a8.decode_launches = qmm_nf4_w8a8.wgmma_launches = 0


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
    if qt.k_shards > 1:
        # the global view of a K-sharded tensor on the CPU, as the JAX
        # package computes it outside its kernels: dequantize chunk by
        # chunk, then one product (CUDA tensors split in ``qmatmul``)
        return qmatmul_plain(x, qt)
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


def qmatmul_forward(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """``x @ dequant(qt)`` by the forward's dispatch alone: no autograd, no
    tape (for callers that keep the product themselves)."""
    return _forward(x, qt)


def qmatmul_backward(g: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """``g @ dequant(qt)ᵀ`` by the backward's dispatch (the dx kernels)."""
    return _backward(g, qt)


class _QMatmul(torch.autograd.Function):
    """``x @ dequant(qt)`` with the JAX package's vjp: a gradient for x
    only; the backward re-dequantizes the frozen weight."""

    @staticmethod
    def forward(ctx, x, qt):
        ctx.qt = qt
        ctx.x_dtype = x.dtype
        return taped(_forward, x, qt)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None
        return _backward(g, ctx.qt).to(ctx.x_dtype), None


def qmatmul(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """``x @ dequant(qt)`` for 2-D x [M, K] → [M, N] (bf16 out, f32 accum).

    Differentiable in x only.  An x that needs no gradient skips autograd
    altogether, so nothing is kept and no backward kernel is launched.
    Inside a block checkpointed with ``remat="save_linear"`` the product is
    kept on the block's tape and read back when the block is recomputed
    (``ops/tape.py``).  A whole K-sharded tensor on the card runs as a sum
    over its chunks (:func:`qmatmul_k_chunks`)."""
    if qt.k_shards > 1 and x.is_cuda:
        return qmatmul_k_chunks(x, qt)
    if x.requires_grad and torch.is_grad_enabled():
        return _QMatmul.apply(x, qt)
    return taped(_forward, x, qt)


def qmatmul_k_chunks(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """``x @ dequant(qt)`` for a whole K-sharded tensor: each chunk's
    product on its own columns of x through :func:`qmatmul` (the kernels on
    the card; its backward too), the bf16 partials summed in f32 and
    rounded once."""
    Kc = x.shape[-1] // qt.k_shards
    y = sum(qmatmul(x[:, i * Kc:(i + 1) * Kc].contiguous(), k_chunk(qt, i)).float()
            for i in range(qt.k_shards))
    return y.to(torch.bfloat16)
