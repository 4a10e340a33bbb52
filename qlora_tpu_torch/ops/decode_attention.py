"""Fused decode attention over the contiguous KV cache.

``fused_decode_attention`` appends each row's new token to the cache at
position ``lengths[b]``, in place, and attends each query head over its kv
head's valid prefix plus the new token.  A CUDA tensor launches the
hand-written split-KV kernel (``csrc/decode_attention_split.cu``, cut by
:func:`decode_attention_plan`) and raises if it cannot; a CPU tensor takes
:func:`decode_attention_plain`.  The kernel it replaced,
``csrc/decode_attention.cu``, is reached only through the private
``_decode_attention_before``, for timing and as a second reference.  Both follow the TPU
kernel's semantics: masked logits are ``MASK``, softmax is by ``exp`` from
the running max, the probabilities are rounded to bf16 for the value
product, and a row whose length is at or past the capacity T writes
nothing (the JAX package's jnp fallback would clamp the write instead).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from . import _build

MASK = -0.7 * float(np.finfo(np.float32).max)


def _window(sliding_window) -> int:
    return int(sliding_window) if sliding_window else 0


def decode_attention_plain(q, new_k, new_v, k_cache, v_cache, lengths, *,
                           sm_scale: float = 1.0, sliding_window=None):
    """The plain PyTorch version; same arguments and results as
    :func:`fused_decode_attention`, caches updated in place."""
    B, H, hd = q.shape
    KVH, T = k_cache.shape[1], k_cache.shape[2]
    G = H // KVH
    lengths = lengths.to(torch.int64)
    nk = new_k.to(k_cache.dtype)
    nv = new_v.to(v_cache.dtype)
    qg = q.to(torch.bfloat16).float().reshape(B, KVH, G, hd)
    s = torch.einsum("bkgd,bktd->bkgt", qg, k_cache.float()) * sm_scale
    pos = torch.arange(T, device=q.device)[None, :]
    valid = pos < lengths[:, None]
    win = _window(sliding_window)
    if win:
        valid &= pos > lengths[:, None] - win
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, MASK))
    s_new = (qg * nk.float()[:, :, None, :]).sum(-1) * sm_scale      # [B,KVH,G]
    m = torch.maximum(s.amax(-1), s_new)
    p = torch.exp(s - m[..., None])
    p_new = torch.exp(s_new - m)
    l = p.sum(-1) + p_new
    num = torch.einsum("bkgt,bktd->bkgd", p.to(torch.bfloat16).float(),
                       v_cache.float()) + p_new[..., None] * nv.float()[:, :, None, :]
    den = torch.where(l == 0, torch.ones_like(l), l)
    out = (num / den[..., None]).reshape(B, H, hd).to(q.dtype)
    rows = torch.nonzero(lengths < T).flatten()
    if rows.numel():
        k_cache[rows, :, lengths[rows]] = nk[rows]
        v_cache[rows, :, lengths[rows]] = nv[rows]
    return out, k_cache, v_cache


_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P]
_SPLIT_ARGTYPES = [_P] * 8 + [_I] * 5 + [ctypes.c_float, _I, _I, _I, _P]

# The split-KV kernel (``csrc/decode_attention_split.cu``): a CTA takes one
# split of a (row, kv head)'s keys for up to 16 query heads of its group, in
# chunks of ``_ATTN_CHUNK`` keys (16 a warp), and writes its partial to an
# f32 workspace; a second launch merges the splits in split order.
_ATTN_CHUNK = 64          # keys a chunk; keys a split are a multiple of it
_ATTN_MAX_SPLITS = 16     # CTAs a (row, kv head, 16 query heads)
_ATTN_MAX_KEYS = 512      # keys a split, beyond which a cache takes more splits
_ATTN_ROWS = 16           # query heads a CTA: one mma tile


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    """How ``decode_attention_split`` cuts a row's keys: ``splits`` CTAs
    per (row, kv head, ``_ATTN_ROWS`` query heads), split s taking ``keys``
    keys from the row's first visible one (a split past the row's last key
    has none and exits); ``mtiles`` CTAs of query heads per kv head (G > 16
    takes two)."""
    keys: int
    splits: int
    mtiles: int

    def split_keys(self, length: int, T: int, window) -> list:
        """[(k0, k1)] cache positions each split reads for a row that holds
        `length` tokens, as the kernel computes them (k0 >= k1: none)."""
        lo = max(0, length - window + 1) if window else 0
        hi = min(length, T)
        return [(lo + s * self.keys, min(lo + (s + 1) * self.keys, hi))
                for s in range(self.splits)]


def decode_attention_plan(T: int, KVH: int, G: int, hd: int, window, sms: int = 132
                          ) -> AttentionPlan:
    """The split kernel's plan for caches of capacity T with KVH kv heads of
    G query heads each, on a card of ``sms`` SMs.  A row sees at most
    ``span`` cached keys (T, or window - 1 with a sliding window); the
    splits are enough for the kv heads to fill the SMs (ceil(sms / KVH)),
    or for no split to take more than ``_ATTN_MAX_KEYS`` keys, at most 16
    and at most one per ``_ATTN_CHUNK`` keys of the span; the keys a split
    are then the span shared out, rounded up to whole chunks.  It depends on
    the capacity and the heads, never on the batch or the lengths, so a
    row's result does not depend on the other rows."""
    if hd not in (64, 128, 256):
        raise ValueError(f"head_dim {hd} not in (64, 128, 256)")
    if not 1 <= G <= 32 or KVH < 1 or T < 1:
        raise ValueError(f"T={T}, KVH={KVH}, G={G}: need T, KVH >= 1 and 1 <= G <= 32")
    win = _window(window)
    span = max(0, min(T, win - 1) if win else T)
    want = max(-(-sms // KVH), -(-span // _ATTN_MAX_KEYS))
    splits = max(1, min(want, _ATTN_MAX_SPLITS, -(-span // _ATTN_CHUNK)))
    keys = -(-max(span, 1) // splits)
    keys = -(-keys // _ATTN_CHUNK) * _ATTN_CHUNK
    return AttentionPlan(keys, max(1, -(-span // keys)), -(-G // _ATTN_ROWS))


_ATTN_PLANS: dict = {}


def _plan_on(T, KVH, G, hd, window, dev) -> AttentionPlan:
    key = (T, KVH, G, hd, _window(window), dev)
    plan = _ATTN_PLANS.get(key)
    if plan is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = _ATTN_PLANS[key] = decode_attention_plan(T, KVH, G, hd, window, sms)
    return plan


def _checked(q, new_k, new_v, k_cache, v_cache, lengths):
    """Check the operands against the kernels' contract; returns (q, new_k,
    new_v as contiguous bf16, lengths int32 on the card, out, B, KVH, G, T,
    hd)."""
    B, H, hd = q.shape
    KVH, T = k_cache.shape[1], k_cache.shape[2]
    if H % KVH or H // KVH > 32:
        raise ValueError(f"H={H}, KVH={KVH}: need H a multiple of KVH, G <= 32")
    if hd not in (64, 128, 256):
        raise ValueError(f"head_dim {hd} not in (64, 128, 256)")
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        if (c.dtype != torch.bfloat16 or not c.is_contiguous()
                or tuple(c.shape) != (B, KVH, T, hd) or c.device != q.device
                or c.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous bf16 [B, KVH, T, hd] at a 16-byte "
                             f"address on {q.device}")
    for name, t in (("new_k", new_k), ("new_v", new_v)):
        if tuple(t.shape) != (B, KVH, hd) or t.device != q.device:
            raise ValueError(f"{name} must be [B, KVH, hd] = {(B, KVH, hd)} on {q.device}")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be [B] = [{B}], got {tuple(lengths.shape)}")
    aligned = lambda t: t.clone() if t.data_ptr() % 16 else t
    qb = aligned(q.to(torch.bfloat16).contiguous())
    nk = aligned(new_k.to(torch.bfloat16).contiguous())
    nv = aligned(new_v.to(torch.bfloat16).contiguous())
    lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, H, hd), dtype=torch.bfloat16, device=q.device)
    return qb, nk, nv, lens, out, B, KVH, H // KVH, T, hd


def decode_attention_cuda(q, new_k, new_v, k_cache, v_cache, lengths, *,
                          sm_scale: float = 1.0, sliding_window=None):
    """Launch the split-KV kernel; same contract as
    :func:`fused_decode_attention`.  Its two launches (the splits, then
    their merge) count as one call in ``launches``."""
    qb, nk, nv, lens, out, B, KVH, G, T, hd = _checked(q, new_k, new_v, k_cache, v_cache,
                                                       lengths)
    plan = _plan_on(T, KVH, G, hd, sliding_window, q.device)
    ws = torch.empty(B * KVH * plan.splits * G * (hd + 2), dtype=torch.float32,
                     device=q.device)
    fn = _build.kernel("decode_attention_split", "decode_attention_split", _SPLIT_ARGTYPES)
    err = fn(qb.data_ptr(), nk.data_ptr(), nv.data_ptr(), k_cache.data_ptr(),
             v_cache.data_ptr(), lens.data_ptr(), ws.data_ptr(), out.data_ptr(),
             B, KVH, G, T, hd, float(sm_scale), _window(sliding_window), plan.keys,
             plan.splits, _build.stream_ptr(q))
    _build.check(err, "decode_attention_split")
    decode_attention_cuda.launches += 1
    return out.to(q.dtype), k_cache, v_cache


decode_attention_cuda.launches = 0


def _decode_attention_before(q, new_k, new_v, k_cache, v_cache, lengths, *,
                             sm_scale: float = 1.0, sliding_window=None):
    """The kernel the split kernel replaced (``csrc/decode_attention.cu``:
    one CTA per (row, kv head)), for timing and as a second reference; same
    contract, not counted."""
    qb, nk, nv, lens, out, B, KVH, G, T, hd = _checked(q, new_k, new_v, k_cache, v_cache,
                                                       lengths)
    fn = _build.kernel("decode_attention", "decode_attention", _ARGTYPES)
    err = fn(qb.data_ptr(), nk.data_ptr(), nv.data_ptr(), k_cache.data_ptr(),
             v_cache.data_ptr(), lens.data_ptr(), out.data_ptr(),
             B, KVH, G, T, hd, float(sm_scale), _window(sliding_window),
             _build.stream_ptr(q))
    _build.check(err, "decode_attention")
    return out.to(q.dtype), k_cache, v_cache


def fused_decode_attention(q, new_k, new_v, k_cache, v_cache, lengths, *,
                           sm_scale: float = 1.0, sliding_window=None):
    """q [B, H, hd]; new_k/new_v [B, KVH, hd]; caches [B, KVH, T, hd];
    lengths [B] int32, the tokens already cached.  Returns
    (out [B, H, hd], k_cache, v_cache) — the caches are the inputs, updated
    in place."""
    if q.is_cuda:
        return decode_attention_cuda(
            q, new_k, new_v, k_cache, v_cache, lengths,
            sm_scale=sm_scale, sliding_window=sliding_window)
    if q.device.type != "cpu":
        raise ValueError(f"decode attention runs on CUDA or the CPU, not {q.device}")
    return decode_attention_plain(
        q, new_k, new_v, k_cache, v_cache, lengths,
        sm_scale=sm_scale, sliding_window=sliding_window)
