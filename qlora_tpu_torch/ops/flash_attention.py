"""Flash attention with its backward: the no-cache (training, prefill)
attention of the model.

``flash_attention(q, k, v, kv_lengths, sm_scale, causal, window)`` and
``flash_attention_lse`` (which also returns the row statistics ``lse`` and
takes their cotangent) dispatch on the device of ``q``: a CUDA tensor
launches the hand-written kernels of ``csrc/flash_attention.cu``
(:func:`flash_fwd` forward; :func:`flash_bwd_dq` and :func:`flash_bwd_dkv`
backward) and raises if it cannot; a CPU tensor takes
:func:`flash_fwd_plain` and :func:`flash_bwd_plain`, which repeat the
kernels' arithmetic.

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
from typing import Optional

import torch

from . import _build

EMPTY_LSE = 3e38          # lse of a row with no visible key
HEAD_DIMS = (64, 128)     # what csrc/flash_attention.cu is instantiated for


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
# the CUDA kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_TAIL = [_I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I, _P]   # B H KVH Sq Skv D scale causal window stream
_FWD_ARGS = [_P] * 6 + _TAIL
_DQ_ARGS = [_P] * 8 + _TAIL
_DKV_ARGS = [_P] * 9 + _TAIL


def _operands(q, k, v, kv_lengths, extra=()):
    """Check shapes and devices; returns contiguous bf16 q, k, v (and
    `extra`), int32 lengths on the device and the dims."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: need "
                         "q [B, H, Sq, D] and k, v [B, KVH, Skv, D]")
    B, H, Sq, D = q.shape
    KVH, Skv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or KVH == 0 or H % KVH:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not pair up "
                         "(same B and D, KVH dividing H)")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if tuple(kv_lengths.shape) != (B,):
        raise ValueError(f"kv_lengths must be [B] = [{B}], got {tuple(kv_lengths.shape)}")
    for t in (k, v, *extra):
        if t.device != q.device:
            raise ValueError(f"every operand must be on {q.device}")
    ts = [t.to(torch.bfloat16).contiguous() for t in (q, k, v, *extra)]
    lens = kv_lengths.to(device=q.device, dtype=torch.int32).contiguous()
    return ts, lens, (B, H, KVH, Sq, Skv, D)


def _row_stats(lse, di, dims):
    B, H, _, Sq, _, _ = dims
    for name, t in (("lse", lse), ("di", di)):
        if tuple(t.shape) != (B, H, Sq):
            raise ValueError(f"{name} must be [B, H, Sq] = {(B, H, Sq)}, got {tuple(t.shape)}")
    return lse.float().contiguous(), di.float().contiguous()


def _tail(dims, sm_scale, causal, window, t):
    return (*dims, float(sm_scale), int(bool(causal)), int(window) if window else 0,
            _build.stream_ptr(t))


def flash_fwd(q, k, v, kv_lengths, sm_scale: float = 1.0, causal: bool = True,
              window: Optional[int] = None):
    """The forward kernel (TPU _flash_fwd): (o bf16, lse f32 [B, H, Sq])."""
    (q, k, v), lens, dims = _operands(q, k, v, kv_lengths)
    B, H, _, Sq, _, _ = dims
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if o.numel():
        fn = _build.kernel("flash_attention", "flash_fwd", _FWD_ARGS)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), *_tail(dims, sm_scale, causal, window, q))
        _build.check(err, "flash_fwd")
        flash_fwd.launches += 1
    return o, lse


def flash_bwd_dq(q, k, v, kv_lengths, do, lse, di, sm_scale: float = 1.0,
                 causal: bool = True, window: Optional[int] = None):
    """The dq kernel (TPU _flash_bwd, first pallas_call): dq bf16 like q."""
    (q, k, v, do), lens, dims = _operands(q, k, v, kv_lengths, (do,))
    lse, di = _row_stats(lse, di, dims)
    dq = torch.empty_like(q)
    if dq.numel():
        fn = _build.kernel("flash_attention", "flash_bwd_dq", _DQ_ARGS)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
                 *_tail(dims, sm_scale, causal, window, q))
        _build.check(err, "flash_bwd_dq")
        flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, kv_lengths, do, lse, di, sm_scale: float = 1.0,
                  causal: bool = True, window: Optional[int] = None):
    """The dk, dv kernel (TPU _flash_bwd, second pallas_call): (dk, dv) bf16
    like k, each group of query heads summed inside the kernel."""
    (q, k, v, do), lens, dims = _operands(q, k, v, kv_lengths, (do,))
    lse, di = _row_stats(lse, di, dims)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel():
        fn = _build.kernel("flash_attention", "flash_bwd_dkv", _DKV_ARGS)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 *_tail(dims, sm_scale, causal, window, q))
        _build.check(err, "flash_bwd_dkv")
        flash_bwd_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


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
        o, lse = fwd(q, k, v, kv_lengths, sm_scale, causal, window)
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
