"""Transformer building blocks: norms, RoPE, attention, linear dispatch.

Plain functions over tensors.  The dtype policy is the JAX package's: norms
in f32, matrix products with bf16 operands and f32 accumulation, frozen base
weights NF4, FP4 or int8 (``bf16_matmul`` in ``ops`` holds the product's
policy).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Union

import torch

from qlora_tpu_torch.ops import bf16_matmul, qmatmul
from qlora_tpu_torch.ops.qmatmul import qmatmul_backward, qmatmul_forward
from qlora_tpu_torch.ops.tape import taped
from qlora_tpu_torch.quant.blockwise import QuantizedTensor


@dataclasses.dataclass
class QLinear:
    """A linear layer whose weight is a frozen QuantizedTensor."""
    qt: QuantizedTensor
    bias: Optional[torch.Tensor] = None


@dataclasses.dataclass
class DenseLinear:
    """A plain (bf16/f32) linear layer, weight [K, N]."""
    w: torch.Tensor
    bias: Optional[torch.Tensor] = None


Linear = Union[QLinear, DenseLinear]

# When a tensor-parallel context is set (``tp_shard_context``), the params
# are this rank's shards and the collectives go through the axes' ``TPMesh``
# views (parallel/distributed.py).  The style is the JAX package's:
#   "gather"   every linear is column-parallel over tp: its input gets
#              ident-fwd/psum-bwd, its output columns are gathered
#              (all-gather forward, this rank's slice backward); with an
#              fsdp axis each linear's storage is further split over fsdp
#              along N and gathered just in time (ZeRO-3 for the frozen
#              weights), fsdp minor: rank (t, f) stores N-shard t·F + f;
#   "megatron" head-parallel attention and row-parallel output projections
#              over K-sharded storage, one all-reduce a sub-block
#              (parallel/megatron_step.py).
_SHARD_CTX: list = [(None, None, "gather")]
STYLES = ("gather", "megatron")


@contextlib.contextmanager
def tp_shard_context(tp, fsdp=None, style: str = "gather"):
    """Run the model sharded over `tp` (a ``TPMesh``, or None) and, under
    "gather", weight-gathered over `fsdp`."""
    if style not in STYLES:
        raise ValueError(f"style={style!r}: one of {STYLES}")
    if style == "megatron" and fsdp is not None:
        raise ValueError("the megatron style has no fsdp axis")
    _SHARD_CTX.append((tp, fsdp, style))
    try:
        yield
    finally:
        _SHARD_CTX.pop()


def megatron_axis():
    """The tp mesh when the Megatron style is in effect, else None."""
    tp, _fsdp, style = _SHARD_CTX[-1]
    return tp if style == "megatron" else None


# Megatron's conjugate operators.  The reduction is done in f32: a bf16
# partial is widened, summed over the ranks and rounded once by the caller.
# The forward collectives are kept on the tape of a block checkpointed with
# remat="save_linear" (ops/tape.py), so that the recomputed block makes
# none of them again.


class _IdentFwdPsumBwd(torch.autograd.Function):
    """Identity forward, all-reduce backward: on the (replicated) input of a
    column-parallel product, so that the ranks' partial input gradients sum
    to the whole one on every rank."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.float()).to(g.dtype), None


class _GatherColsFwdSliceBwd(torch.autograd.Function):
    """All-gather of the last dimension forward, this rank's slice backward
    (a gather's transpose would sum the replicated cotangents and scale
    every upstream gradient by tp)."""

    @staticmethod
    def forward(ctx, y, mesh):
        ctx.mesh, ctx.n = mesh, y.shape[-1]
        return taped(mesh.all_gather, y, -1)

    @staticmethod
    def backward(ctx, g):
        r = ctx.mesh.rank
        return g[..., r * ctx.n:(r + 1) * ctx.n].contiguous(), None


def _reduce_f32(y: torch.Tensor, mesh) -> torch.Tensor:
    return mesh.all_reduce(y.float()).to(y.dtype)


class _PsumFwdIdentBwd(torch.autograd.Function):
    """All-reduce forward (in f32, rounded once to bf16), identity backward:
    the row-parallel output's reducer; every rank receives the exact
    cotangent of the replicated output."""

    @staticmethod
    def forward(ctx, y, mesh):
        return taped(_reduce_f32, y, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def ident_fwd_psum_bwd(x: torch.Tensor, mesh) -> torch.Tensor:
    return _IdentFwdPsumBwd.apply(x, mesh)


def gather_cols_fwd_slice_bwd(y: torch.Tensor, mesh) -> torch.Tensor:
    return _GatherColsFwdSliceBwd.apply(y, mesh)


def psum_fwd_ident_bwd(y: torch.Tensor, mesh) -> torch.Tensor:
    return _PsumFwdIdentBwd.apply(y, mesh)


# fsdp: the just-in-time gather of a linear's storage


def _gather_last(tensors: list, fsdp) -> list:
    """Each tensor's fsdp shards concatenated along its last dimension, in
    one all-gather of their bytes (the shards of a tensor are the same shape
    on every rank; the bytes are moved as uint8, never cast)."""
    flat = [t.contiguous().view(torch.uint8).reshape(-1) for t in tensors]
    sizes = [f.numel() for f in flat]
    whole = fsdp.all_gather(torch.cat(flat), dim=0).reshape(fsdp.size, -1)
    out, at = [], 0
    for t, n in zip(tensors, sizes):
        parts = whole[:, at:at + n].reshape(fsdp.size, *t.shape[:-1], -1)
        parts = parts.view(t.dtype)                  # [F, ..., n_local]
        out.append(torch.cat(list(parts.unbind(0)), dim=-1))
        at += n
    return out


def fsdp_gather_qt(qt: QuantizedTensor, fsdp) -> QuantizedTensor:
    """This rank's tp column shard of a quantized tensor whose storage is
    split over fsdp along N (packed, absmax and the meta-scales alike; the
    column-aligned layout splits at any column)."""
    names = ["packed", "absmax"] + (["absmax_scale"] if qt.absmax_scale is not None else [])
    whole = _gather_last([getattr(qt, n) for n in names], fsdp)
    return dataclasses.replace(qt, shape=(qt.shape[0], qt.shape[1] * fsdp.size),
                               **dict(zip(names, whole)))


def _gathered_product(x, qt, fsdp):
    return qmatmul_forward(x, fsdp_gather_qt(qt, fsdp))


class _FsdpQMatmul(torch.autograd.Function):
    """``x @ dequant(gather(qt))`` over fsdp-split storage: the gathered
    weight lives only inside the forward and inside the backward, each
    gathering it again; the graph keeps the rank's own shard, so that the
    layers' gathered weights are never alive together.  The forward's
    gather and product are kept on a save_linear tape as one."""

    @staticmethod
    def forward(ctx, x, qt, fsdp):
        ctx.qt, ctx.fsdp, ctx.x_dtype = qt, fsdp, x.dtype
        return taped(_gathered_product, x.detach(), qt, fsdp)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        return (qmatmul_backward(g, fsdp_gather_qt(ctx.qt, ctx.fsdp)).to(ctx.x_dtype),
                None, None)


def fsdp_qmatmul(x: torch.Tensor, qt: QuantizedTensor, fsdp) -> torch.Tensor:
    if x.requires_grad and torch.is_grad_enabled():
        return _FsdpQMatmul.apply(x, qt, fsdp)
    return taped(_gathered_product, x, qt, fsdp)


def lookup_embedding(emb: torch.Tensor, ids: torch.Tensor,
                     dtype=torch.bfloat16) -> torch.Tensor:
    """Embedding rows, aware of the table's feature sharding: fsdp is a
    batch axis as well, so the table's fsdp columns are gathered before the
    lookup (each fsdp rank looks up rows of its own); the tp features are
    gathered after it, on the activations (forward; the backward takes this
    rank's slice, so that a trainable table's shard gets its gradient)."""
    tp, fsdp, _style = _SHARD_CTX[-1]
    if fsdp is not None:
        emb = _gather_last([emb], fsdp)[0]
    x = emb[ids.long()].to(dtype)
    if tp is not None:
        x = gather_cols_fwd_slice_bwd(x, tp)
    return x


def apply_linear(lin: Linear, x: torch.Tensor, tp_mode: str = "gather") -> torch.Tensor:
    """y = x @ W (+ bias); x [..., K] → [..., N] in bf16.

    tp_mode, under a tensor-parallel context only:
      "gather"      column-parallel, the input's gradient all-reduced and
                    the output gathered (every linear of the gather style,
                    the lm_head of either);
      "column"      column-parallel with no collective: the output stays
                    this rank's columns (the caller put ident-fwd/psum-bwd
                    on the sub-block's input);
      "row_partial" row-parallel with no collective: the input and the
                    weight are this rank's K-chunk and the output a partial
                    sum, which the caller reduces once with the LoRA
                    partial; the bias is divided by tp, so that the sum
                    carries it once.
    With an fsdp axis the linear's storage is gathered first (the product
    over gathered quantized storage keeps only the shard for its backward).
    """
    tp, fsdp, _style = _SHARD_CTX[-1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if tp is not None and tp_mode == "gather":
        x2 = ident_fwd_psum_bwd(x2, tp)
    bias = lin.bias
    if fsdp is not None and bias is not None:
        bias = _gather_last([bias], fsdp)[0]
    if isinstance(lin, QLinear):
        y = qmatmul(x2, lin.qt) if fsdp is None else fsdp_qmatmul(x2, lin.qt, fsdp)
    else:
        w = lin.w if fsdp is None else _gather_last([lin.w], fsdp)[0]
        y = bf16_matmul(x2, w).to(torch.bfloat16)
    if bias is not None:
        bias = bias.float()
        if tp is not None and tp_mode == "row_partial":
            bias = bias / tp.size
        y = (y.float() + bias).to(torch.bfloat16)
    if tp is not None and tp_mode == "gather":
        y = gather_cols_fwd_slice_bwd(y, tp)
    return y.reshape(*lead, y.shape[-1])


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """LLaMA RMSNorm in f32."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(torch.bfloat16)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """GPT-NeoX LayerNorm in f32."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(torch.bfloat16)


def rope_frequencies(head_dim: int, rotary_dim: int, theta: float,
                     positions: torch.Tensor):
    """cos/sin tables for positions [..., S] → [..., S, rotary_dim/2] f32."""
    exps = torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                        device=positions.device) / rotary_dim
    inv_freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                            device=positions.device), exps)
    angles = positions[..., None].float() * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rotary_dim: int) -> torch.Tensor:
    """Rotate the first `rotary_dim` features of x [..., S, H, hd]
    (half-split convention, as LLaMA and GPT-NeoX)."""
    rot, rest = x[..., :rotary_dim], x[..., rotary_dim:]
    half = rotary_dim // 2
    x1, x2 = rot[..., :half].float(), rot[..., half:].float()
    c = cos[..., None, :]
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
    if rest.shape[-1]:
        out = torch.cat([out, rest], dim=-1)
    return out


def _softmax_attend(logits, mask, v_f32, einsum_out):
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum(einsum_out, probs.to(torch.bfloat16).float(), v_f32)


def attention(q, k, v, mask) -> torch.Tensor:
    """Softmax attention, GQA-grouped, f32 softmax.

    q [B, S, H, hd]; k, v [B, T, KVH, hd]; mask [B, 1, S, T] bool
    (True = attend).  Returns [B, S, H, hd] bf16."""
    B, S, H, hd = q.shape
    KVH = k.shape[2]
    G = H // KVH
    qg = q.reshape(B, S, KVH, G, hd).to(torch.bfloat16).float()
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.to(torch.bfloat16).float())
    logits = logits * (1.0 / hd ** 0.5)
    out = _softmax_attend(logits, mask[:, :, None], v.to(torch.bfloat16).float(),
                          "bkgst,btkd->bskgd")
    return out.reshape(B, S, H, hd).to(torch.bfloat16)


def attention_kvmajor(q, k_buf, v_buf, mask) -> torch.Tensor:
    """:func:`attention` over the decode cache's [B, KVH, T, hd] layout.

    bf16 operands, f32 accumulation and probabilities rounded to bf16 —
    the TPU's semantics (the JAX package computes this in f32 on its CPU
    backend)."""
    B, S, H, hd = q.shape
    KVH = k_buf.shape[1]
    G = H // KVH
    qg = q.reshape(B, S, KVH, G, hd).to(torch.bfloat16).float()
    logits = torch.einsum("bskgd,bktd->bkgst", qg, k_buf.to(torch.bfloat16).float())
    logits = logits * (1.0 / hd ** 0.5)
    out = _softmax_attend(logits, mask[:, :, None], v_buf.to(torch.bfloat16).float(),
                          "bkgst,bktd->bskgd")
    return out.reshape(B, S, H, hd).to(torch.bfloat16)


def causal_mask(S: int, T: int, q_offset: int = 0, device=None) -> torch.Tensor:
    """[1, 1, S, T] causal mask; query i attends keys <= i + q_offset."""
    qi = torch.arange(S, device=device)[:, None] + q_offset
    kj = torch.arange(T, device=device)[None, :]
    return (kj <= qi)[None, None]
