"""Fused decode attention over the contiguous KV cache.

``fused_decode_attention`` appends each row's new token to the cache at
position ``lengths[b]``, in place, and attends each query head over its kv
head's valid prefix plus the new token.  A CUDA tensor launches the
hand-written kernel (``csrc/decode_attention.cu``) and raises if it cannot;
a CPU tensor takes :func:`decode_attention_plain`.  Both follow the TPU
kernel's semantics: masked logits are ``MASK``, softmax is by ``exp`` from
the running max, the probabilities are rounded to bf16 for the value
product, and a row whose length is at or past the capacity T writes
nothing (the JAX package's jnp fallback would clamp the write instead).
"""

from __future__ import annotations

import ctypes

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


def decode_attention_cuda(q, new_k, new_v, k_cache, v_cache, lengths, *,
                          sm_scale: float = 1.0, sliding_window=None):
    """Launch the CUDA kernel; same contract as :func:`fused_decode_attention`."""
    B, H, hd = q.shape
    KVH, T = k_cache.shape[1], k_cache.shape[2]
    if H % KVH or H // KVH > 32:
        raise ValueError(f"H={H}, KVH={KVH}: need H a multiple of KVH, G <= 32")
    if hd not in (64, 128, 256):
        raise ValueError(f"head_dim {hd} not in (64, 128, 256)")
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        if (c.dtype != torch.bfloat16 or not c.is_contiguous()
                or tuple(c.shape) != (B, KVH, T, hd) or c.device != q.device):
            raise ValueError(f"{name} must be contiguous bf16 [B, KVH, T, hd] on {q.device}")
    for name, t in (("new_k", new_k), ("new_v", new_v)):
        if tuple(t.shape) != (B, KVH, hd) or t.device != q.device:
            raise ValueError(f"{name} must be [B, KVH, hd] = {(B, KVH, hd)} on {q.device}")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be [B] = [{B}], got {tuple(lengths.shape)}")
    qb = q.to(torch.bfloat16).contiguous()
    nk = new_k.to(torch.bfloat16).contiguous()
    nv = new_v.to(torch.bfloat16).contiguous()
    lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, H, hd), dtype=torch.bfloat16, device=q.device)
    fn = _build.kernel("decode_attention", "decode_attention", _ARGTYPES)
    err = fn(qb.data_ptr(), nk.data_ptr(), nv.data_ptr(), k_cache.data_ptr(),
             v_cache.data_ptr(), lens.data_ptr(), out.data_ptr(),
             B, KVH, H // KVH, T, hd, float(sm_scale), _window(sliding_window),
             _build.stream_ptr(q))
    _build.check(err, "decode_attention")
    decode_attention_cuda.launches += 1
    return out.to(q.dtype), k_cache, v_cache


decode_attention_cuda.launches = 0


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
