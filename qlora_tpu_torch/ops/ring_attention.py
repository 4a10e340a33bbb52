"""Ring attention: attention over a sequence sharded across the ranks of an
``sp`` axis (the JAX package's ``ops/ring_attention.py``).

Each rank holds a contiguous shard of the sequence: its queries, keys and
values ``[B, H, S/sp, D]`` (k and v may have fewer heads: GQA).  The key
and value shards rotate around the ring (``TPMesh.rotate``: rank r sends to
r + 1 and receives from r - 1), so that at step i rank ``my`` holds the
shard of rank ``src = (my - i) mod n``; after n - 1 rotations every query
has seen every key.  Each step's attention is a chunk of its own, merged
into the running result by the log-sum-exp combine (:func:`_merge`).

Two routes, chosen by the JAX package's gate (head_dim % 64 == 0 and both
shards % 8 == 0 take the first):

* flash: each chunk runs the flash kernels of
  ``csrc/flash_attention_wgmma.cu`` (CUDA tensors) or their plain versions
  (CPU tensors).  Under causality the diagonal chunk (src == my) is causal,
  the earlier shards (src < my) are seen whole, and the later ones (src >
  my) are not seen at all: the rank knows `my` on the host and launches
  nothing for them (JAX launches them at kv length 0, whose sentinel lse
  merges as an empty partial, the same numbers), so rank s runs s + 1
  chunks.  The ring is one ``autograd.Function`` (:class:`_RingFlash`): its
  backward rotates the key and value shards again, with dk and dv
  accumulators that travel with their shards and arrive home after n
  rotations (f32, rounded to bf16 once at home: JAX sums the cotangents of
  its rotated bf16 blocks in bf16, which took dk twice as far from the
  single rank's on the CPU tests), and runs each chunk's dq and dk, dv
  kernels
  (``flash_bwd_dq``, ``flash_bwd_dkv``) on the MERGED lse and on
  di = Σ o·do of the merged output: the global softmax's p = exp(s − lse)
  and ds = p (dp − di) split by chunk, so the sum over chunks is the exact
  gradient (JAX reaches the same through the lse cotangent of each
  chunk).  Every rank makes the same rotations in the same order, forward
  and backward, whatever its causal work: one Function, so no rank's
  backward can skip a rotation that another waits for.  Under remat
  "save_linear" the ring's output is taped (``ops/tape.py``): the
  recomputed block makes no second round of rotations.
* plain: the online-softmax route (JAX's ``_ring_jnp``) in f32 torch ops,
  each rotation a differentiable :class:`_Rotate` whose backward is the
  inverse rotation.
"""

from __future__ import annotations

import torch

from .flash_attention import (
    EMPTY_LSE, _di, _on_cpu, flash_bwd_dkv, flash_bwd_dq, flash_bwd_plain, flash_fwd,
    flash_fwd_plain,
)
from .tape import taped

NEG = -1e30      # the plain route's masked score, as JAX's


def _flash_gate(q, k) -> bool:
    return q.shape[-1] % 64 == 0 and q.shape[2] % 8 == 0 and k.shape[2] % 8 == 0


def _chunks(my: int, n: int, causal: bool) -> list:
    """(step, src, chunk causal?) of each chunk this rank computes, in ring
    order: every step, or under causality steps 0..my (src = my, my − 1, .., 0)."""
    out = []
    for i in range(n):
        src = (my - i) % n
        if causal and src > my:
            continue
        out.append((i, src, causal and src == my))
    return out


def _merge(lse_run, o_run, lse_i, o_i):
    """LSE-combine two normalized partials (JAX's ``_merge``); −inf lse marks
    an empty partial.  f32."""
    m = torch.maximum(lse_run, lse_i)
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    a = torch.where(torch.isneginf(lse_run), torch.zeros_like(m), torch.exp(lse_run - m_safe))
    b = torch.where(torch.isneginf(lse_i), torch.zeros_like(m), torch.exp(lse_i - m_safe))
    denom = a + b
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    o_new = (a[..., None] * o_run + b[..., None] * o_i) / safe[..., None]
    lse_new = torch.where(denom == 0, torch.full_like(m, float("-inf")), m_safe + torch.log(safe))
    return lse_new, o_new


def _ring_forward(q, k, v, sp, sm_scale, causal):
    """The flash route's forward: (o like q's dtype, merged lse f32 [B, H, Sq])."""
    B, H, Sq, D = q.shape
    fwd = flash_fwd_plain if _on_cpu(q) else flash_fwd
    full = torch.full((B,), k.shape[2], dtype=torch.int32, device=q.device)
    todo = {i: c for i, src, c in _chunks(sp.rank, sp.size, causal)}
    lse_run = torch.full((B, H, Sq), float("-inf"), dtype=torch.float32, device=q.device)
    o_run = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)
    blk = (k, v)
    for i in range(sp.size):
        # the shard for the next step goes out while this one is attended
        rot = sp.rotate(blk) if i + 1 < sp.size else None
        if i in todo:
            o_i, lse_i = fwd(q, blk[0], blk[1], full, sm_scale, todo[i], None)
            lse_i = torch.where(lse_i > 1e37, torch.full_like(lse_i, float("-inf")), lse_i)
            lse_run, o_run = _merge(lse_run, o_run, lse_i, o_i.float())
        if rot is not None:
            blk = tuple(rot.wait())
    return o_run.to(q.dtype), lse_run


class _RingFlash(torch.autograd.Function):
    """The flash route as one differentiable op (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, sp, sm_scale, causal):
        o, lse = taped(_ring_forward, q, k, v, sp, sm_scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (sp, sm_scale, causal)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        sp, sm_scale, causal = ctx.args
        cpu = _on_cpu(q)
        B = q.shape[0]
        full = torch.full((B,), k.shape[2], dtype=torch.int32, device=q.device)
        do = do.to(torch.bfloat16)
        # an empty row (none here: the diagonal chunk sees its own key) keeps
        # the kernels' sentinel, so that its p is 0
        lse_k = torch.where(torch.isneginf(lse), torch.full_like(lse, EMPTY_LSE), lse)
        di = _di(o, do, None)
        todo = {i: c for i, src, c in _chunks(sp.rank, sp.size, causal)}
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        blk = (k, v)
        acc = (torch.zeros(k.shape, dtype=torch.float32, device=k.device),
               torch.zeros(v.shape, dtype=torch.float32, device=v.device))
        for i in range(sp.size):
            rot = sp.rotate(blk, tag=0) if i + 1 < sp.size else None
            if i in todo:
                kb, vb = blk
                if cpu:
                    dq_i, dk_i, dv_i = flash_bwd_plain(q, kb, vb, full, o, lse_k, do, sm_scale,
                                                       todo[i], None)
                else:
                    dq_i = flash_bwd_dq(q, kb, vb, full, do, lse_k, di, sm_scale, todo[i], None)
                    dk_i, dv_i = flash_bwd_dkv(q, kb, vb, full, do, lse_k, di, sm_scale,
                                               todo[i], None)
                dq += dq_i.float()
                acc = (acc[0] + dk_i.float(), acc[1] + dv_i.float())
            # the accumulators travel with their shards: after n rotations
            # each is back on the rank that owns its keys
            acc = tuple(sp.rotate(acc, tag=1).wait())
            if rot is not None:
                blk = tuple(rot.wait())
        dk, dv = acc
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


class _Rotate(torch.autograd.Function):
    """One rotation of the plain route, differentiable: the cotangents go
    back by the inverse rotation."""

    @staticmethod
    def forward(ctx, sp, *tensors):
        ctx.sp = sp
        return tuple(t.clone() for t in sp.rotate(tensors).wait())

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros_like(g) if g is None else g for g in grads]
        return (None, *ctx.sp.rotate(grads, shift=-1).wait())


def _ring_plain(q, k, v, sp, sm_scale, causal):
    """The online-softmax route (JAX's ``_ring_jnp``): f32 scores masked with
    NEG by global positions, a running (m, l, o) per query row."""
    B, H, Sq, D = q.shape
    KVH, Sk = k.shape[1], k.shape[2]
    G = H // KVH
    dev = q.device
    q_pos = sp.rank * Sq + torch.arange(Sq, device=dev)
    qf = q.float().reshape(B, KVH, G, Sq, D)
    m = torch.full((B, KVH, G, Sq, 1), float("-inf"), dtype=torch.float32, device=dev)
    l = torch.zeros((B, KVH, G, Sq, 1), dtype=torch.float32, device=dev)
    o = torch.zeros((B, KVH, G, Sq, D), dtype=torch.float32, device=dev)
    kb, vb = k, v
    for i in range(sp.size):
        src = (sp.rank - i) % sp.size
        s = torch.einsum("bkgqd,bksd->bkgqs", qf, kb.float()) * sm_scale
        if causal:
            k_pos = src * Sk + torch.arange(Sk, device=dev)
            s = torch.where(k_pos[None, :] <= q_pos[:, None], s, torch.full_like(s, NEG))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        o = alpha * o + torch.einsum("bkgqs,bksd->bkgqd", p, vb.float())
        m = m_new
        if i + 1 < sp.size:
            kb, vb = _Rotate.apply(sp, kb, vb)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    return (o / l_safe).reshape(B, H, Sq, D).to(q.dtype)


def ring_attention(q, k, v, sp, *, sm_scale: float = 1.0, causal: bool = True,
                   impl: str = "auto") -> torch.Tensor:
    """Attention of this rank's query shard over the whole sequence, whose
    shards lie on the ranks of `sp` (a ``TPMesh``; shard r holds positions
    r·S/sp ..).  q ``[B, H, Sq, D]``, k and v ``[B, KVH, Sk, D]``; returns
    ``[B, H, Sq, D]`` in q's dtype.  `impl`: "auto" (the gate of the module
    docstring), "flash" or "plain"."""
    if impl not in ("auto", "flash", "plain"):
        raise ValueError(f"impl={impl!r}: 'auto', 'flash' or 'plain'")
    if k.shape != v.shape or k.shape[0] != q.shape[0] or q.shape[1] % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: need "
                         "q [B, H, Sq, D] and k, v [B, KVH, Sk, D] with KVH dividing H")
    if impl == "flash" or (impl == "auto" and _flash_gate(q, k)):
        return _RingFlash.apply(q, k, v, sp, float(sm_scale), bool(causal))
    return _ring_plain(q, k, v, sp, float(sm_scale), bool(causal))
