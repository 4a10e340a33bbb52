"""Fused attention over the paged KV pool, with the new tokens appended in
place: ``fused_paged_decode_attention`` (one token per sequence) and
``fused_paged_chunk_attention`` (a chunk of C tokens, the speculative verify
step).

The pool is page-major, ``[n_pages, KVH, page, hd]`` bf16 per layer, shared
by every sequence; ``tables[b]`` maps sequence b's logical pages to pool
pages.  A CUDA tensor launches a hand-written kernel and raises if it
cannot; a CPU tensor takes the plain version.  The decode step and every
chunk run the split-KV kernel of ``csrc/paged_attention_split.cu`` (cut by
:func:`paged_chunk_plan`, the decode as the chunk of one token; counted in
``split_launches``).  ``csrc/paged_attention.cu``, which it replaced, is
reached only through the private ``_paged_decode_before`` and
``_paged_chunk_before``, for timing and as a second reference.  Both
follow the TPU kernels' semantics, not the JAX package's jnp fallback:
masked logits are ``MASK``, the softmax is by ``exp`` from the row's
maximum (the new tokens' scores included), the pool probabilities are
rounded to bf16 for the value product while the chunk's own terms stay f32,
``l == 0`` divides by 1, and position ``pos`` is written to page
``tables[b, min(pos // page, pps - 1)]`` at offset ``pos % page`` (the
fallback does not clamp).  Unlike the JAX package, the kernels run at every
shape: there is no buffer-size or ``C > page`` fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import _build
from .decode_attention import MASK, AttentionPlan, _window, decode_attention_plan


def _gather(pages, tables):
    """pages [n_pages, KVH, page, hd] gathered by tables [B, pps] →
    [B, KVH, pps * page, hd]."""
    B, pps = tables.shape
    _, KVH, page, hd = pages.shape
    g = pages[tables.reshape(-1).long()].reshape(B, pps, KVH, page, hd)
    return g.permute(0, 2, 1, 3, 4).reshape(B, KVH, pps * page, hd)


def _append(k_pages, v_pages, new_k, new_v, lengths, tables):
    """Write new_k/new_v [B, C, KVH, hd] at positions lengths[b] + j, row by
    row and token by token (where the clamp maps two positions to one slot,
    the later one stays, as in the TPU kernel)."""
    page, pps = k_pages.shape[2], tables.shape[1]
    for b, n in enumerate(lengths.tolist()):
        for j in range(new_k.shape[1]):
            pos = n + j
            wp = int(tables[b, min(pos // page, pps - 1)])
            k_pages[wp, :, pos % page] = new_k[b, j].to(k_pages.dtype)
            v_pages[wp, :, pos % page] = new_v[b, j].to(v_pages.dtype)


def paged_chunk_plain(q, new_k, new_v, k_pages, v_pages, lengths, tables, *,
                      sm_scale: float = 1.0, sliding_window=None):
    """The plain PyTorch version of :func:`fused_paged_chunk_attention`, with
    the same arguments and results; the pools are updated in place."""
    B, C, H, hd = q.shape
    _, KVH, page, _ = k_pages.shape
    pps = tables.shape[1]
    T, G = page * pps, H // KVH
    dev = q.device
    lengths = lengths.to(device=dev, dtype=torch.int64)
    tables = tables.to(dev)
    k, v = _gather(k_pages, tables).float(), _gather(v_pages, tables).float()
    pos = torch.arange(T, device=dev)
    # the TPU kernel zeroes the values of pages past ceil(length / page)
    npg = (lengths + page - 1) // page
    v = torch.where(((pos // page)[None, :] < npg[:, None])[:, None, :, None], v,
                    torch.zeros_like(v))
    qg = q.to(torch.bfloat16).float().reshape(B, C, KVH, G, hd).permute(0, 2, 1, 3, 4)
    s = torch.einsum("bkcgd,bktd->bkcgt", qg, k) * sm_scale
    c = torch.arange(C, device=dev)
    valid = pos[None, None, :] < lengths[:, None, None]                 # [B, C, T]
    win = _window(sliding_window)
    if win:
        valid = valid & (pos[None, None, :] > (lengths[:, None] + c[None, :] - win)[..., None])
    valid = valid[:, None, :, None, :]
    s = torch.where(valid, s, torch.full_like(s, MASK))
    nkf = new_k.to(torch.bfloat16).float().permute(0, 2, 1, 3)          # [B, KVH, C, hd]
    nvf = new_v.to(torch.bfloat16).float().permute(0, 2, 1, 3)
    sc = torch.einsum("bkcgd,bkjd->bkcgj", qg, nkf) * sm_scale
    cvalid = c[None, :] <= c[:, None]                                     # [c, j]
    if win:
        cvalid = cvalid & ((c[:, None] - c[None, :]) < win)
    cvalid = cvalid[None, None, :, None, :]
    sc = torch.where(cvalid, sc, torch.full_like(sc, MASK))
    m = torch.maximum(s.amax(-1), sc.amax(-1))[..., None]
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    pc = torch.where(cvalid, torch.exp(sc - m), torch.zeros_like(sc))
    l = p.sum(-1) + pc.sum(-1)
    num = (torch.einsum("bkcgt,bktd->bkcgd", p.to(torch.bfloat16).float(), v)
           + torch.einsum("bkcgj,bkjd->bkcgd", pc, nvf))
    out = num / torch.where(l == 0, torch.ones_like(l), l)[..., None]
    out = out.permute(0, 2, 1, 3, 4).reshape(B, C, H, hd).to(q.dtype)
    _append(k_pages, v_pages, new_k, new_v, lengths, tables)
    return out, k_pages, v_pages


def paged_decode_plain(q, new_k, new_v, k_pages, v_pages, lengths, tables, *,
                       sm_scale: float = 1.0, sliding_window=None):
    """The plain PyTorch version of :func:`fused_paged_decode_attention`: the
    chunk of one token (the TPU decode kernel's arithmetic is the chunk
    kernel's at C = 1)."""
    out, _, _ = paged_chunk_plain(q[:, None], new_k[:, None], new_v[:, None], k_pages,
                                  v_pages, lengths, tables, sm_scale=sm_scale,
                                  sliding_window=sliding_window)
    return out[:, 0], k_pages, v_pages


def paged_attention_reference(q, k_pages, v_pages, lengths, tables, sm_scale=1.0,
                              sliding_window=None):
    """Oracle without the append: q [B, H, hd] attends each sequence's pool
    positions 0..lengths-1 (with a window, those >= lengths - window) in f32
    softmax; the pools are left as they are."""
    B, H, hd = q.shape
    KVH, page = k_pages.shape[1], k_pages.shape[2]
    T, G = page * tables.shape[1], H // KVH
    lengths = lengths.to(device=q.device, dtype=torch.int64)
    k, v = _gather(k_pages, tables).float(), _gather(v_pages, tables).float()
    qg = q.float().reshape(B, KVH, G, hd) * sm_scale
    s = torch.einsum("bkgd,bktd->bkgt", qg, k)
    pos = torch.arange(T, device=q.device)[None, :]
    mask = pos < lengths[:, None]
    if sliding_window is not None:
        mask = mask & (pos >= lengths[:, None] - sliding_window)
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, MASK))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgt,bktd->bkgd", p, v).reshape(B, H, hd).to(q.dtype)


_P = ctypes.c_void_p
_I = ctypes.c_int
_DECODE_ARGS = [_P] * 8 + [_I] * 6 + [ctypes.c_float, _I, _P]
_CHUNK_ARGS = [_P] * 8 + [_I] * 7 + [ctypes.c_float, _I, _P]
_SPLIT_ARGS = [_P] * 9 + [_I] * 7 + [ctypes.c_float, _I, _I, _I, _P]
_CHUNK_ROWS = 16          # query rows a CTA of the split kernel: one mma tile


def paged_chunk_plan(T: int, KVH: int, G: int, C: int, hd: int, window,
                     sms: int = 132) -> AttentionPlan:
    """The split chunk kernel's plan for pools of ``T`` = pages_per_seq *
    page positions a sequence, KVH kv heads of G query heads and chunks of C
    tokens (C = 1: the decode step), on a card of ``sms`` SMs: the keys a
    split and the splits of :func:`decode_attention_plan` (a sequence's rows
    see at most ``span`` pool keys, T or window - 1, their union), and
    ``mtiles`` CTA rows of 16 of the C * G query rows (row c * G + g) per kv
    head.  It depends on the capacity, the heads, C, hd and the window,
    never on the batch or the lengths, so a row's result does not depend on
    the other rows."""
    if C < 1 or G < 1 or C * G > 64:
        raise ValueError(f"C={C}, G={G}: the split kernel takes 1 <= C and C * G <= 64")
    plan = decode_attention_plan(T, KVH, 1, hd, window, sms)
    return dataclasses.replace(plan, mtiles=-(-C * G // _CHUNK_ROWS))


_CHUNK_PLANS: dict = {}


def _chunk_plan_on(T, KVH, G, C, hd, window, dev) -> AttentionPlan:
    key = (T, KVH, G, C, hd, _window(window), dev)
    plan = _CHUNK_PLANS.get(key)
    if plan is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = _CHUNK_PLANS[key] = paged_chunk_plan(T, KVH, G, C, hd, window, sms)
    return plan


def _checked(q, new_k, new_v, k_pages, v_pages, lengths, tables):
    """Check the operands ([B, C, H, hd] queries, [B, C, KVH, hd] new rows)
    against the kernels' contract; returns (q, new_k, new_v as contiguous
    bf16, lengths and tables int32 on the card, out [B, C, H, hd] bf16)."""
    B, C, H, hd = q.shape
    n_pages, KVH, page, _ = k_pages.shape
    dev = q.device
    if H % KVH or C * (H // KVH) > 64:
        raise ValueError(f"C={C}, H={H}, KVH={KVH}: need H a multiple of KVH and "
                         "C * H / KVH <= 64")
    if hd not in (64, 128, 256):
        raise ValueError(f"head_dim {hd} not in (64, 128, 256)")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if (t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != dev
                or tuple(t.shape) != (n_pages, KVH, page, hd) or t.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous bf16 [n_pages, KVH, page, hd] "
                             f"= {(n_pages, KVH, page, hd)} at a 16-byte address on {dev}")
    for name, t in (("new_k", new_k), ("new_v", new_v)):
        if tuple(t.shape) != (B, C, KVH, hd) or t.device != dev:
            raise ValueError(f"{name} must be [B, C, KVH, hd] = {(B, C, KVH, hd)} on {dev}")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be [B] = [{B}], got {tuple(lengths.shape)}")
    if tables.ndim != 2 or tables.shape[0] != B or tables.shape[1] < 1:
        raise ValueError(f"tables must be [B, pages_per_seq], got {tuple(tables.shape)}")
    aligned = lambda t: t.clone() if t.data_ptr() % 16 else t
    qb = aligned(q.to(torch.bfloat16).contiguous())
    nk = aligned(new_k.to(torch.bfloat16).contiguous())
    nv = aligned(new_v.to(torch.bfloat16).contiguous())
    lens = lengths.to(device=dev, dtype=torch.int32).contiguous()
    tabs = tables.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty((B, C, H, hd), dtype=torch.bfloat16, device=dev)
    return qb, nk, nv, lens, tabs, out


def _launch(entry, q, new_k, new_v, k_pages, v_pages, lengths, tables, sm_scale,
            sliding_window):
    """Check the operands and launch one of ``paged_attention.cu``'s two
    entries; returns out [B, C, H, hd] bf16."""
    B, C, H, hd = q.shape
    KVH, page = k_pages.shape[1], k_pages.shape[2]
    qb, nk, nv, lens, tabs, out = _checked(q, new_k, new_v, k_pages, v_pages, lengths, tables)
    ptrs = (qb.data_ptr(), nk.data_ptr(), nv.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), lens.data_ptr(), tabs.data_ptr(), out.data_ptr())
    shape = (B, KVH, H // KVH) if entry == "paged_decode_attention" else (B, C, KVH, H // KVH)
    fn = _build.kernel("paged_attention", entry,
                       _DECODE_ARGS if entry == "paged_decode_attention" else _CHUNK_ARGS)
    err = fn(*ptrs, *shape, page, tables.shape[1], hd, float(sm_scale),
             _window(sliding_window), _build.stream_ptr(q))
    _build.check(err, entry)
    return out


def _launch_split(q, new_k, new_v, k_pages, v_pages, lengths, tables, sm_scale,
                  sliding_window):
    """Check the operands and launch the split chunk kernel on its plan,
    with an f32 workspace of the splits' partials; returns out [B, C, H, hd]
    bf16."""
    B, C, H, hd = q.shape
    KVH, page = k_pages.shape[1], k_pages.shape[2]
    pps, G = tables.shape[1], H // KVH
    qb, nk, nv, lens, tabs, out = _checked(q, new_k, new_v, k_pages, v_pages, lengths, tables)
    plan = _chunk_plan_on(page * pps, KVH, G, C, hd, sliding_window, q.device)
    ws = torch.empty(B * KVH * plan.splits * C * G * (hd + 2), dtype=torch.float32,
                     device=q.device)
    fn = _build.kernel("paged_attention_split", "paged_chunk_attention_split", _SPLIT_ARGS)
    err = fn(qb.data_ptr(), nk.data_ptr(), nv.data_ptr(), k_pages.data_ptr(),
             v_pages.data_ptr(), lens.data_ptr(), tabs.data_ptr(), ws.data_ptr(),
             out.data_ptr(), B, C, KVH, G, page, pps, hd, float(sm_scale),
             _window(sliding_window), plan.keys, plan.splits, _build.stream_ptr(q))
    _build.check(err, "paged_chunk_attention_split")
    return out


def paged_decode_attention_cuda(q, new_k, new_v, k_pages, v_pages, lengths, tables, *,
                                sm_scale: float = 1.0, sliding_window=None):
    """Launch the split kernel on the chunk of one token; same contract as
    :func:`fused_paged_decode_attention`.  Its two launches, the splits and
    their merge with the append, count as one call in ``launches`` and
    ``split_launches``."""
    if q.ndim != 3:
        raise ValueError(f"q must be [B, H, hd], got {tuple(q.shape)}")
    out = _launch_split(q[:, None], new_k[:, None], new_v[:, None], k_pages, v_pages, lengths,
                        tables, sm_scale, sliding_window)
    paged_decode_attention_cuda.launches += 1
    paged_decode_attention_cuda.split_launches += 1
    return out[:, 0].to(q.dtype), k_pages, v_pages


def paged_chunk_attention_cuda(q, new_k, new_v, k_pages, v_pages, lengths, tables, *,
                               sm_scale: float = 1.0, sliding_window=None):
    """Launch the split kernel; same contract as
    :func:`fused_paged_chunk_attention`.  Its two launches, the splits and
    their merge with the append, count as one call in ``launches`` and
    ``split_launches``; a chunk of one token is the decode step's call."""
    if q.ndim != 4:
        raise ValueError(f"q must be [B, C, H, hd], got {tuple(q.shape)}")
    out = _launch_split(q, new_k, new_v, k_pages, v_pages, lengths, tables, sm_scale,
                        sliding_window)
    paged_chunk_attention_cuda.launches += 1
    paged_chunk_attention_cuda.split_launches += 1
    return out.to(q.dtype), k_pages, v_pages


# launches: every call; split_launches: those that took
# paged_attention_split.cu, which is every call (paged_attention.cu is
# reached only through the "befores" below, which count nothing)
paged_decode_attention_cuda.launches = paged_decode_attention_cuda.split_launches = 0
paged_chunk_attention_cuda.launches = paged_chunk_attention_cuda.split_launches = 0


def _paged_decode_before(q, new_k, new_v, k_pages, v_pages, lengths, tables, *,
                         sm_scale: float = 1.0, sliding_window=None):
    """The kernel the split kernel replaced at the decode step
    (``paged_attention.cu``'s decode entry: one CTA per (sequence, kv
    head)), for timing and as a second reference; same contract, not
    counted."""
    if q.ndim != 3:
        raise ValueError(f"q must be [B, H, hd], got {tuple(q.shape)}")
    out = _launch("paged_decode_attention", q[:, None], new_k[:, None], new_v[:, None],
                  k_pages, v_pages, lengths, tables, sm_scale, sliding_window)
    return out[:, 0].to(q.dtype), k_pages, v_pages


def _paged_chunk_before(q, new_k, new_v, k_pages, v_pages, lengths, tables, *,
                        sm_scale: float = 1.0, sliding_window=None):
    """The kernel the split kernel replaced at chunks (``paged_attention.cu``'s
    chunk entry: one CTA per (sequence, kv head)), for timing and as a second
    reference; same contract, not counted."""
    out = _launch("paged_chunk_attention", q, new_k, new_v, k_pages, v_pages, lengths, tables,
                  sm_scale, sliding_window)
    return out.to(q.dtype), k_pages, v_pages


def _dispatch(cuda_fn, plain_fn, q, *args, **kw):
    if q.is_cuda:
        return cuda_fn(q, *args, **kw)
    if q.device.type != "cpu":
        raise ValueError(f"paged attention runs on CUDA or the CPU, not {q.device}")
    return plain_fn(q, *args, **kw)


def fused_paged_decode_attention(q, new_k, new_v, k_pages, v_pages, lengths, tables, *,
                                 sm_scale: float = 1.0, sliding_window=None):
    """q [B, H, hd]; new_k/new_v [B, KVH, hd]; pools [n_pages, KVH, page, hd];
    lengths [B] int32, the tokens already in the pool; tables [B, pps] int32.
    Returns (out [B, H, hd], k_pages, v_pages) — the pools are the inputs,
    updated in place.  Preconditions, which the kernel does not check (a
    check would read the device on every call): every table entry is a page
    of the pool, and lengths[b] < pps * page (a violating row overwrites its
    own last page, never another sequence's)."""
    return _dispatch(paged_decode_attention_cuda, paged_decode_plain, q, new_k, new_v,
                     k_pages, v_pages, lengths, tables, sm_scale=sm_scale,
                     sliding_window=sliding_window)


def fused_paged_chunk_attention(q, new_k, new_v, k_pages, v_pages, lengths, tables, *,
                                sm_scale: float = 1.0, sliding_window=None):
    """The speculative verify chunk: q [B, C, H, hd]; new_k/new_v
    [B, C, KVH, hd]; the rest as :func:`fused_paged_decode_attention`.  Query
    c attends pool positions 0..lengths[b]-1 and chunk tokens 0..c; the chunk
    lands at lengths[b]..lengths[b]+C-1.  Returns (out [B, C, H, hd],
    k_pages, v_pages).  Precondition: lengths[b] + C <= pps * page.  On the
    card it runs ``csrc/paged_attention_split.cu``, as the decode step does."""
    return _dispatch(paged_chunk_attention_cuda, paged_chunk_plain, q, new_k, new_v,
                     k_pages, v_pages, lengths, tables, sm_scale=sm_scale,
                     sliding_window=sliding_window)
