"""Flash attention with its backward: the no-cache (training, prefill)
attention of the model.

``flash_attention(q, k, v, kv_lengths, sm_scale, causal, window)`` and
``flash_attention_lse`` (which also returns the row statistics ``lse`` and
takes their cotangent) dispatch on the device of ``q``: a CUDA tensor
launches the hand-written kernels of ``csrc/flash_attention_wgmma.cu``
(:func:`flash_fwd` forward; :func:`flash_bwd_dq` and :func:`flash_bwd_dkv`
backward; TMA-fed ``wgmma``, the scores kept in registers) and raises if it
cannot; a CPU tensor takes :func:`flash_fwd_plain` and
:func:`flash_bwd_plain`, which repeat the kernels' arithmetic.  The kernels
take q, k, v and do by their strides (:func:`_tma_operand` copies only what
a tensor map cannot read) and launch from :func:`flash_plan`.  The WMMA
kernels of ``csrc/flash_attention.cu``, which they replaced, stay reachable
through the private ``_flash_*_before`` wrappers, for timing and tests only.

Layout, as the JAX package: ``q [B, H, Sq, D]``, ``k, v [B, KVH, Skv, D]``
with ``KVH | H`` (query head ``h`` reads kv head ``h // (H // KVH)``),
``kv_lengths [B]`` int32.  Key ``col`` is visible to query ``row`` when
``col < kv_lengths[b]`` and (causal) ``col <= row`` and (window)
``row - col < window``.  A row with no visible key gets ``o = 0`` and
``lse = 3e38``; its gradients are exactly 0.  ``lse = m + log l`` is in
nats and is stored ``[B, H, Sq]`` f32.  Operands are bf16, sums f32, and
the probabilities (and ``ds``) are rounded to bf16 before the products that
consume them, as the TPU kernels round them.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from . import _build
from .tape import taped

EMPTY_LSE = 3e38          # lse of a row with no visible key
HEAD_DIMS = (64, 128, 256)   # what the kernels are instantiated for


def _visible(Sq: int, Skv: int, kv_lengths: torch.Tensor, causal: bool,
             window: Optional[int]) -> torch.Tensor:
    """[B, 1, 1, Sq, Skv] bool: which key each query may attend."""
    dev = kv_lengths.device
    row = torch.arange(Sq, device=dev)[:, None]
    col = torch.arange(Skv, device=dev)[None, :]
    mask = (col < kv_lengths.to(torch.int64)[:, None, None]).expand(-1, Sq, -1)
    if causal:
        mask = mask & (col <= row)
    if window:
        mask = mask & (row - col < window)
    return mask[:, None, None]


def _grouped(q: torch.Tensor, KVH: int) -> torch.Tensor:
    """[B, H, S, D] → f32 [B, KVH, G, S, D] of the bf16-rounded values."""
    B, H, S, D = q.shape
    return q.to(torch.bfloat16).float().reshape(B, KVH, H // KVH, S, D)


def _scores(q, k, sm_scale):
    """bf16-rounded q kᵀ with f32 sums, scaled: [B, KVH, G, Sq, Skv]."""
    kf = k.to(torch.bfloat16).float()
    return torch.einsum("bkgqd,bksd->bkgqs", _grouped(q, k.shape[1]), kf) * sm_scale


def attention_reference(q, k, v, kv_lengths, sm_scale: float = 1.0, causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """The oracle: f32 softmax attention with the same masking, written with
    differentiable tensor ops (k, v may have fewer heads than q).  Masked
    scores are the JAX package's -0.7 * f32 max, so a row with no visible
    key attends every key evenly here, unlike the kernels' zero."""
    B, H, Sq, D = q.shape
    KVH, Skv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, KVH, H // KVH, Sq, D)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * sm_scale
    s = torch.where(_visible(Sq, Skv, kv_lengths, causal, window), s,
                    torch.full_like(s, -0.7 * torch.finfo(torch.float32).max))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(B, H, Sq, D).to(q.dtype)


def flash_fwd_plain(q, k, v, kv_lengths, sm_scale: float = 1.0, causal: bool = True,
                    window: Optional[int] = None):
    """The plain version of the forward kernel: (o bf16 [B, H, Sq, D],
    lse f32 [B, H, Sq])."""
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    vis = _visible(Sq, Skv, kv_lengths, causal, window)
    s = _scores(q, k, sm_scale)
    s = torch.where(vis, s, torch.full_like(s, float("-inf")))
    m = s.amax(-1, keepdim=True)
    empty = torch.isinf(m)
    p = torch.where(vis, torch.exp(s - torch.where(empty, torch.zeros_like(m), m)),
                    torch.zeros_like(s))
    l = p.sum(-1, keepdim=True)
    num = torch.einsum("bkgqs,bksd->bkgqd", p.to(torch.bfloat16).float(),
                       v.to(torch.bfloat16).float())
    o = torch.where(empty, torch.zeros_like(num), num / torch.where(empty, torch.ones_like(l), l))
    lse = torch.where(empty, torch.full_like(m, EMPTY_LSE),
                      m + torch.log(torch.where(empty, torch.ones_like(l), l)))
    return o.reshape(B, H, Sq, D).to(torch.bfloat16), lse.reshape(B, H, Sq)


def _di(o, do, dlse):
    """di = Σ o·do (− dlse): the row term of the softmax backward, f32."""
    di = (o.float() * do.float()).sum(-1)
    return di if dlse is None else di - dlse.float()


def flash_bwd_plain(q, k, v, kv_lengths, o, lse, do, sm_scale: float = 1.0,
                    causal: bool = True, window: Optional[int] = None, dlse=None):
    """The plain version of the two backward kernels, by the explicit
    formulas: p = exp(s − lse); dp = do vᵀ; ds = p (dp − di) sm_scale;
    dq = ds k; dk = dsᵀ q; dv = pᵀ do, each group of query heads summed in
    f32 into its kv head.  Returns (dq, dk, dv) in bf16."""
    B, H, Sq, D = q.shape
    KVH, Skv = k.shape[1], k.shape[2]
    G = H // KVH
    vis = _visible(Sq, Skv, kv_lengths, causal, window)
    lse_g = lse.float().reshape(B, KVH, G, Sq, 1)
    di = _di(o, do, dlse).reshape(B, KVH, G, Sq, 1)
    p = torch.where(vis, torch.exp(_scores(q, k, sm_scale) - lse_g),
                    torch.zeros((), device=q.device))
    dog = _grouped(do, KVH)
    kf, vf = k.to(torch.bfloat16).float(), v.to(torch.bfloat16).float()
    dp = torch.einsum("bkgqd,bksd->bkgqs", dog, vf)
    ds = (p * (dp - di) * sm_scale).to(torch.bfloat16).float()
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf).reshape(B, H, Sq, D)
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, _grouped(q, KVH))
    dv = torch.einsum("bkgqs,bkgqd->bksd", p.to(torch.bfloat16).float(), dog)
    return dq.to(torch.bfloat16), dk.to(torch.bfloat16), dv.to(torch.bfloat16)


# ---------------------------------------------------------------------------
# the plan of the wgmma kernels
# ---------------------------------------------------------------------------

# (query rows, keys, ring depth) of a tile, as csrc/flash_attention_wgmma.cu
# defines them: forward and dq, a CTA's query rows and a kv tile's keys; dk,
# dv, a step's query rows and a CTA's keys: 128 where each kv head has one
# query head, else DKV_FEW_KEYS (a CTA then walks each query tile once per
# query head of its group: fewer keys a CTA give twice the CTAs, and its two
# consumer warpgroups take alternate steps over the same 64 keys).  The
# choice depends on the heads only, never on B, so a batch row's dk and dv
# are summed in one order whatever rows share its call
FWD_TILE = (128, 64, 2)
DQ_TILE = (128, 64, 3)
DKV_TILE = (64, 128, 4)
DKV_FEW_KEYS = 64
# head dim 256 (WIDE_D): a warpgroup's 64 x 256 f32 accumulator takes 128
# registers a thread.  The forward keeps its tiles; dq takes kv tiles of 32
# keys (Q, dO and 3 stages then fit in 227 KB); a dk, dv CTA owns 64 keys and
# its two consumer warpgroups walk every step, one summing dV, the other dK
WIDE_D = 256
DQ_WIDE_TILE = (128, 32, 3)
DKV_WIDE_TILE = (64, 64, 2)
THREADS = 384             # two consumer warpgroups and a producer
BAR_BYTES = 256           # the mbarriers, after the tiles
SMEM_PER_BLOCK = 232448   # 227 KB, what an H100 block may use


def flash_smem(kernel: str, D: int, rows: int, cols: int, stages: int) -> int:
    """Dynamic shared memory of a kernel: 1024 bytes of alignment, its
    tiles (bf16), the ring, the barriers."""
    if kernel == "fwd":      # Q; a stage holds K and V
        return 1024 + rows * D * 2 + stages * 2 * cols * D * 2 + BAR_BYTES
    if kernel == "dq":       # Q and dO; a stage holds K and V
        return 1024 + 2 * rows * D * 2 + stages * 2 * cols * D * 2 + BAR_BYTES
    if kernel == "dkv":      # K and V; a stage holds Q, dO and their rows' lse, di
        return 1024 + 2 * cols * D * 2 + stages * (2 * rows * D * 2 + 2 * rows * 4) + BAR_BYTES
    raise ValueError(f"no kernel {kernel!r}")


def acc_regs(kernel: str, D: int, rows: int, cols: int) -> int:
    """f32 accumulator registers a consumer thread holds at once (a
    warpgroup's 64 x n wgmma accumulator is n / 2 a thread): forward O and
    S; dq dQ, S and dP; dk, dv both sums and S^T, dP^T, or at head dim 256
    one sum (its warpgroup's) and S^T, dP^T.  Of the 240 a consumer gets."""
    if kernel == "fwd":
        return D // 2 + cols // 2
    if kernel == "dq":
        return D // 2 + cols
    if kernel == "dkv":
        return (1 if D == WIDE_D else 2) * D // 2 + rows
    raise ValueError(f"no kernel {kernel!r}")


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    kernel: str        # "fwd", "dq" or "dkv"
    rows: int          # query rows of a tile
    cols: int          # keys of a tile
    stages: int        # tiles (dk, dv: steps) in the ring
    smem: int          # dynamic shared memory, bytes
    grid: tuple        # fwd, dq: (B * H, query tiles); dkv: (B * KVH, key tiles)
    threads: int = THREADS


def _tile_full(r0, rows, c0, cols, Sq, n, causal, window) -> bool:
    """Every (row, col) of the tile is visible: the kernel skips the mask."""
    return (c0 + cols <= n and r0 + rows <= Sq and (not causal or c0 + cols - 1 <= r0)
            and (not window or r0 + rows - 1 - c0 < window))


def _kv_tiles(r0, rows, Sq, n, causal, window, bk):
    """The kv tiles that query rows r0 .. r0 + rows - 1 can see: [first, last)."""
    hi = min(n, r0 + rows, Sq) if causal else n
    lo = max(0, r0 - window + 1) if window else 0
    return lo // bk, (-(-hi // bk) if hi > lo else lo // bk)


def _q_tiles(k0, keys, Sq, n, causal, window, bq):
    """The query tiles that can see a key of k0 .. k0 + keys - 1: [first, last)."""
    ce = min(k0 + keys, n)
    lo = k0 if causal else 0
    hi = min(Sq, ce - 1 + window) if window else Sq
    return lo // bq, (-(-hi // bq) if ce > k0 and hi > lo else lo // bq)


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """How the three wgmma kernels cover one call.  ``visits`` replays, with
    the kernels' own integer arithmetic, which tiles a CTA walks for a batch
    row of `kv_len` keys and which of them need the mask."""
    B: int
    H: int
    KVH: int
    Sq: int
    Skv: int
    D: int
    causal: bool
    window: int        # 0: no sliding window
    fwd: KernelPlan
    dq: KernelPlan
    dkv: KernelPlan

    def order(self, kernel: str) -> list:
        """(b, head, tile) of each CTA in launch order (x fastest): every
        (b, head) at the last query tile first (fwd, dq: causal rows grow
        with the tile), or at the first key tile (dkv: causal keys lose rows)."""
        kp = getattr(self, kernel)
        heads = self.KVH if kernel == "dkv" else self.H
        gx, gy = kp.grid
        return [(x // heads, x % heads, y if kernel == "dkv" else gy - 1 - y)
                for y in range(gy) for x in range(gx)]

    def visits(self, kernel: str, tile: int, kv_len: int) -> list:
        """[(tile, "full" or "masked")]: the kv tiles that query tile `tile`
        visits (fwd, dq), or the query tiles that key tile `tile` visits for
        each of the G query heads of its kv head in turn (dkv)."""
        kp = getattr(self, kernel)
        n = min(max(int(kv_len), 0), self.Skv)
        args = (self.Sq, n, self.causal, self.window)
        if kernel == "dkv":
            first, last = _q_tiles(tile * kp.cols, kp.cols, *args, kp.rows)
            spans = [(t * kp.rows, tile * kp.cols, t) for t in range(first, last)]
        else:
            first, last = _kv_tiles(tile * kp.rows, kp.rows, *args, kp.cols)
            spans = [(tile * kp.rows, t * kp.cols, t) for t in range(first, last)]
        return [(t, "full" if _tile_full(r0, kp.rows, c0, kp.cols, *args) else "masked")
                for r0, c0, t in spans]


def _check_head_dim(D: int) -> None:
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}: the kernels are instantiated for "
                         "these only (ROADMAP.md, queue B: other head dims)")


@functools.lru_cache(maxsize=256)
def flash_plan(B: int, H: int, KVH: int, Sq: int, Skv: int, D: int, causal: bool,
               window: Optional[int]) -> FlashPlan:
    """The tiles, rings, grids and shared memory of the three kernels for one
    shape (the lengths change only which tiles a CTA walks: ``visits``)."""
    _check_head_dim(D)
    window = min(int(window), Sq + Skv) if window else 0   # wider sees the same keys
    rows, keys, stages = DKV_TILE
    if H != KVH:
        keys = DKV_FEW_KEYS
    tiles = ((FWD_TILE, DQ_TILE, (rows, keys, stages)) if D != WIDE_D
             else (FWD_TILE, DQ_WIDE_TILE, DKV_WIDE_TILE))
    plans = {}
    for kernel, (rows, cols, stages) in zip(("fwd", "dq", "dkv"), tiles):
        grid = ((B * KVH, -(-Skv // cols)) if kernel == "dkv" else (B * H, -(-Sq // rows)))
        plans[kernel] = KernelPlan(kernel, rows, cols, stages,
                                   flash_smem(kernel, D, rows, cols, stages), grid)
    return FlashPlan(B, H, KVH, Sq, Skv, D, bool(causal), window, **plans)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_PLAN = [_I, _I, _I, _I, _P]                       # rows cols stages smem stream
_DIMS = [_I] * 6 + [ctypes.c_float, _I, _I]       # B H KVH Sq Skv D scale causal window
_WGMMA_ARGS = {"flash_wgmma_fwd": [_P] * 7 + _DIMS + _PLAN,      # ..., strides
               "flash_wgmma_bwd_dq": [_P] * 9 + _DIMS + _PLAN,
               "flash_wgmma_bwd_dkv": [_P] * 10 + _DIMS + _PLAN}
_STRIDES = {n: ctypes.c_longlong * (3 * n) for n in (4, 5, 6)}   # (b, h, s) of n operands
_TAIL = [_I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I, _P]   # B H KVH Sq Skv D scale causal window stream
_FWD_ARGS = [_P] * 6 + _TAIL
_DQ_ARGS = [_P] * 8 + _TAIL
_DKV_ARGS = [_P] * 9 + _TAIL


def _tma_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` in bf16, itself where a TMA map can read it (the last dim
    contiguous, every other stride of a dim longer than 1 a positive multiple
    of 8 elements, 16-byte aligned), else a fresh contiguous copy (a
    contiguous tensor at an odd offset stays misaligned).  The model's
    [B, S, H, D] → [B, H, S, D] views go in as they are."""
    if t.dtype != torch.bfloat16:
        t = t.to(torch.bfloat16)
    (sb, sh, ss, sd), (b, h, n, _) = t.stride(), t.shape
    ok = (sd == 1 and t.data_ptr() % 16 == 0 and (b == 1 or (sb > 0 and sb % 8 == 0))
          and (h == 1 or (sh > 0 and sh % 8 == 0)) and (n == 1 or (ss > 0 and ss % 8 == 0)))
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def _strides(t: torch.Tensor) -> tuple:
    """(b, h, s) strides of a [B, heads, S, D] operand, a contiguous one's
    where a dim has length 1 (its stride is never used)."""
    (sb, sh, ss, _), (b, h, n, d) = t.stride(), t.shape
    return (sb if b > 1 else h * n * d, sh if h > 1 else n * d, ss if n > 1 else d)


def _operands(q, k, v, kv_lengths, extra=(), prepare=_tma_operand):
    """Check shapes and devices; returns bf16 q, k, v (and `extra`), each as
    `prepare` leaves it, int32 lengths on the device and the dims."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: need "
                         "q [B, H, Sq, D] and k, v [B, KVH, Skv, D]")
    B, H, Sq, D = q.shape
    KVH, Skv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or KVH == 0 or H % KVH:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not pair up "
                         "(same B and D, KVH dividing H)")
    _check_head_dim(D)
    if tuple(kv_lengths.shape) != (B,):
        raise ValueError(f"kv_lengths must be [B] = [{B}], got {tuple(kv_lengths.shape)}")
    dev = q.device
    for t in (k, v, *extra):
        if t.device != dev:
            raise ValueError(f"every operand must be on {dev}")
    if extra and extra[0].shape != q.shape:
        raise ValueError(f"do {tuple(extra[0].shape)} must be shaped like q {tuple(q.shape)}")
    ts = [prepare(t) for t in (q, k, v, *extra)]
    lens = kv_lengths
    if lens.dtype != torch.int32 or lens.device != dev or not lens.is_contiguous():
        lens = lens.to(device=dev, dtype=torch.int32).contiguous()
    return ts, lens, (B, H, KVH, Sq, Skv, D)


def _row_stats(lse, di, dims):
    B, H, _, Sq, _, _ = dims
    for name, t in (("lse", lse), ("di", di)):
        if tuple(t.shape) != (B, H, Sq):
            raise ValueError(f"{name} must be [B, H, Sq] = {(B, H, Sq)}, got {tuple(t.shape)}")
    return [t if t.dtype == torch.float32 and t.is_contiguous() else t.float().contiguous()
            for t in (lse, di)]


def _launch(entry: str, tensors, strided, plan: FlashPlan, sm_scale, fn=None):
    """One wgmma kernel through its C entry (or `fn`, a build of the same
    entry from an edited source): the pointers of `tensors`, the strides of
    the [B, heads, S, D] operands in `strided`, the dims and the constants of
    its part of `plan`."""
    kp = {"flash_wgmma_fwd": plan.fwd, "flash_wgmma_bwd_dq": plan.dq,
          "flash_wgmma_bwd_dkv": plan.dkv}[entry]
    fn = fn or _build.kernel("flash_attention_wgmma", entry, _WGMMA_ARGS[entry])
    strides = _STRIDES[len(strided)](*(s for t in strided for s in _strides(t)))
    err = fn(*(t.data_ptr() for t in tensors), strides, plan.B, plan.H, plan.KVH, plan.Sq,
             plan.Skv, plan.D, float(sm_scale), int(plan.causal), plan.window, kp.rows, kp.cols,
             kp.stages, kp.smem, _build.stream_ptr(tensors[0]))
    _build.check(err, entry)


def _count(wrapper, D: int) -> None:
    """One launch of `wrapper`'s wgmma kernel; ``wide_launches`` counts those
    at head dim 256, which take the WIDE_D tiles."""
    wrapper.launches += 1
    wrapper.wgmma_launches += 1
    wrapper.wide_launches += D == WIDE_D


def flash_fwd(q, k, v, kv_lengths, sm_scale: float = 1.0, causal: bool = True,
              window: Optional[int] = None):
    """The forward kernel (TPU _flash_fwd) of ``csrc/flash_attention_wgmma.cu``:
    (o bf16 [B, H, Sq, D], a view of [B, Sq, H, D] memory; lse f32 [B, H, Sq])."""
    (q, k, v), lens, dims = _operands(q, k, v, kv_lengths)
    B, H, _, Sq, _, D = dims
    o = torch.empty((B, Sq, H, D), dtype=torch.bfloat16, device=q.device).transpose(1, 2)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if o.numel():
        _launch("flash_wgmma_fwd", (q, k, v, lens, o, lse), (q, k, v, o),
                flash_plan(*dims, causal, window), sm_scale)
        _count(flash_fwd, D)
    return o, lse


def flash_bwd_dq(q, k, v, kv_lengths, do, lse, di, sm_scale: float = 1.0,
                 causal: bool = True, window: Optional[int] = None):
    """The dq kernel (TPU _flash_bwd, first pallas_call): dq bf16, laid out
    like q."""
    (q, k, v, do), lens, dims = _operands(q, k, v, kv_lengths, (do,))
    lse, di = _row_stats(lse, di, dims)
    dq = torch.empty_like(q)
    if dq.numel():
        _launch("flash_wgmma_bwd_dq", (q, k, v, lens, do, lse, di, dq), (q, k, v, do, dq),
                flash_plan(*dims, causal, window), sm_scale)
        _count(flash_bwd_dq, dims[5])
    return dq


def flash_bwd_dkv(q, k, v, kv_lengths, do, lse, di, sm_scale: float = 1.0,
                  causal: bool = True, window: Optional[int] = None):
    """The dk, dv kernel (TPU _flash_bwd, second pallas_call): (dk, dv) bf16,
    laid out like k and v, each group of query heads summed inside the
    kernel."""
    (q, k, v, do), lens, dims = _operands(q, k, v, kv_lengths, (do,))
    lse, di = _row_stats(lse, di, dims)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel():
        _launch("flash_wgmma_bwd_dkv", (q, k, v, lens, do, lse, di, dk, dv),
                (q, k, v, do, dk, dv), flash_plan(*dims, causal, window),
                sm_scale)
        _count(flash_bwd_dkv, dims[5])
    return dk, dv


for _w in (flash_fwd, flash_bwd_dq, flash_bwd_dkv):
    _w.launches = 0
    _w.wgmma_launches = 0
    _w.wide_launches = 0


# ``csrc/flash_attention.cu``, the WMMA kernels that the wgmma kernels
# replaced, through their C entries: the "before" that chip_smoke.py, the
# sweep and the card's tests hold beside them.  Not on any path, not counted.

def _tail(dims, sm_scale, causal, window, t):
    return (*dims, float(sm_scale), int(bool(causal)), int(window) if window else 0,
            _build.stream_ptr(t))


def _contiguous(t):
    return t.to(torch.bfloat16).contiguous()


def _flash_fwd_before(q, k, v, kv_lengths, sm_scale: float = 1.0, causal: bool = True,
                      window: Optional[int] = None):
    (q, k, v), lens, dims = _operands(q, k, v, kv_lengths, prepare=_contiguous)
    B, H, _, Sq, _, _ = dims
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if o.numel():
        fn = _build.kernel("flash_attention", "flash_fwd", _FWD_ARGS)
        _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), o.data_ptr(),
                        lse.data_ptr(), *_tail(dims, sm_scale, causal, window, q)), "flash_fwd")
    return o, lse


def _flash_bwd_dq_before(q, k, v, kv_lengths, do, lse, di, sm_scale: float = 1.0,
                         causal: bool = True, window: Optional[int] = None):
    (q, k, v, do), lens, dims = _operands(q, k, v, kv_lengths, (do,), prepare=_contiguous)
    lse, di = _row_stats(lse, di, dims)
    dq = torch.empty_like(q)
    if dq.numel():
        fn = _build.kernel("flash_attention", "flash_bwd_dq", _DQ_ARGS)
        _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                        do.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
                        *_tail(dims, sm_scale, causal, window, q)), "flash_bwd_dq")
    return dq


def _flash_bwd_dkv_before(q, k, v, kv_lengths, do, lse, di, sm_scale: float = 1.0,
                          causal: bool = True, window: Optional[int] = None):
    (q, k, v, do), lens, dims = _operands(q, k, v, kv_lengths, (do,), prepare=_contiguous)
    lse, di = _row_stats(lse, di, dims)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel():
        fn = _build.kernel("flash_attention", "flash_bwd_dkv", _DKV_ARGS)
        _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                        do.data_ptr(), lse.data_ptr(), di.data_ptr(), dk.data_ptr(),
                        dv.data_ptr(), *_tail(dims, sm_scale, causal, window, q)),
                     "flash_bwd_dkv")
    return dk, dv


# ---------------------------------------------------------------------------
# the differentiable op
# ---------------------------------------------------------------------------


def _on_cpu(q) -> bool:
    if q.is_cuda:
        return False
    if q.device.type != "cpu":
        raise ValueError(f"flash attention runs on CUDA or the CPU, not {q.device}")
    return True


class _FlashAttention(torch.autograd.Function):
    """(o, lse) with the JAX package's vjp for q, k and v; one Function
    serves both public ops, since a cotangent for lse only shifts di."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lengths, sm_scale, causal, window):
        fwd = flash_fwd_plain if _on_cpu(q) else flash_fwd
        # under remat="save_linear" the recomputed block reads o and lse back
        o, lse = taped(fwd, q, k, v, kv_lengths, sm_scale, causal, window)
        ctx.save_for_backward(q, k, v, kv_lengths, o, lse)
        ctx.args = (sm_scale, causal, window)
        ctx.set_materialize_grads(False)
        return o.to(q.dtype), lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, kv_lengths, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        if _on_cpu(q):
            dq, dk, dv = flash_bwd_plain(q, k, v, kv_lengths, o, lse, do, *ctx.args, dlse=dlse)
        else:
            di = _di(o, do, dlse)
            dq = flash_bwd_dq(q, k, v, kv_lengths, do, lse, di, *ctx.args)
            dk, dv = flash_bwd_dkv(q, k, v, kv_lengths, do, lse, di, *ctx.args)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None


def flash_attention_lse(q, k, v, kv_lengths, sm_scale: float = 1.0, causal: bool = True,
                        window: Optional[int] = None):
    """Attention output and ``lse [B, H, Sq]`` (a row with no visible key
    holds 3e38: read it as −inf when merging).  Differentiable in q, k, v
    through both outputs."""
    return _FlashAttention.apply(q, k, v, kv_lengths, sm_scale, causal, window)


def flash_attention(q, k, v, kv_lengths, sm_scale: float = 1.0, causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Masked softmax attention, [B, H, Sq, D] like q."""
    return flash_attention_lse(q, k, v, kv_lengths, sm_scale, causal, window)[0]
