"""The dp×fsdp×tp training step: LoRA finetuning over a mesh of ranks, one
process a rank (``parallel/distributed.py``), the JAX package's shard_map
step (``qlora_tpu/parallel/sharded_step.py``) with explicit collectives.

* tp axis: every linear is column-parallel (N-sharded); its input gets
  ident-fwd/psum-bwd and its output columns are gathered forward and
  sliced backward (``models/layers.py``, the "gather" style).
* fsdp axis: the frozen NF4 storage is further split over fsdp along N and
  gathered just in time, a linear at a time (ZeRO-3 for the base weights);
  fsdp is also a batch axis, and the optimizer state is split over it
  (ZeRO-1: each fsdp rank updates a flat chunk of every trainable tensor
  and the updates are gathered).
* dp axis: a batch axis; the gradients are all-reduced over (dp, fsdp)
  once a step.

The gradient arithmetic is JAX's: each micro-batch differentiates the
rank's LOCAL token-loss sum (no collective inside the differentiated
function), its gradients are divided by the GLOBAL token count (a scalar
all-reduced over the data axes), the micro-batches' gradients are summed and
divided by their number, and one all-reduce over the data axes sums the
ranks'.  None runs over tp: the conjugate operators keep the tp replicas'
gradients exact.  Under ZeRO-1 the gradients are clipped with the true
global norm before they are sliced, so that the optimizer's own clip, which
sees only its chunk, does nothing.

The ZeRO-1 layout is JAX's, byte for byte: each trainable tensor as JAX
stacks it (a LoRA tensor over its layers, ``[L, ...]``) is flattened and
zero-padded to n_shards × chunk, chunk a multiple of 256 (the 8-bit
optimizer's state block), and fsdp rank f holds chunk f.  The port's
per-layer LoRA leaves are concatenated in layer order to make JAX's stacked
leaf.  Checkpoints stay in the single-device layout
(:func:`opt_state_zero1_to_full`).

All the reductions of gradients and losses are in f32; each step's
all-reduces and all-gathers over several tensors move them in one
collective (the tensors concatenated).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from qlora_tpu_torch.lora import LoraConfig
from qlora_tpu_torch.models.config import ModelConfig
from qlora_tpu_torch.models.layers import DenseLinear, QLinear, tp_shard_context
from qlora_tpu_torch.parallel.distributed import ParallelMesh
from qlora_tpu_torch.parallel.megatron_step import shard_tree
from qlora_tpu_torch.train.optimizer import (
    STATE_BLOCK, Optimizer, apply_updates, global_norm, tree_leaves, tree_map, tree_unflatten,
)
from qlora_tpu_torch.train.step import TrainState, loss_fn

# chunk granularity of the ZeRO-1 layout; a multiple of the 8-bit
# optimizer's state block (256), so that every rank's chunk starts a block
_CHUNK_ALIGN = 256


# ---------------------------------------------------------------------------
# the model's shards
# ---------------------------------------------------------------------------


def _qt_spec(qt):
    return dataclasses.replace(qt, packed=1, absmax=1,
                               absmax_scale=None if qt.absmax_scale is None else 1,
                               absmax_offset=None)


def _linear_spec(lin):
    bias = None if lin.bias is None else 0
    if isinstance(lin, QLinear):
        return QLinear(qt=_qt_spec(lin.qt), bias=bias)
    return DenseLinear(w=1, bias=bias)


def _whole(tree):
    if isinstance(tree, dict):
        return {k: _whole(v) for k, v in tree.items()}
    return None


def sharded_param_specs(params: dict) -> dict:
    """The split dimension of every tensor of a params tree over the model
    axes ``("tp", "fsdp")``: each linear's columns (packed, absmax, meta
    scales, bias), the embedding's features and the lm_head's columns;
    norms whole (None)."""
    blocks = [{name: (_linear_spec(v) if isinstance(v, (QLinear, DenseLinear)) else _whole(v))
               for name, v in block.items()} for block in params["blocks"]]
    return {"embed": 1, "blocks": blocks, "final_norm": _whole(params["final_norm"]),
            "lm_head": _linear_spec(params["lm_head"])}


def shard_sharded_params(params: dict, tp_rank: int, fsdp_rank: int, tp: int, fsdp: int,
                         device=None) -> dict:
    """Rank (t, f)'s shard of a params tree on `device`: 1/(tp·fsdp) of
    every split tensor, N-shard t·F + f (storage split by tp, then fsdp, so
    that the fsdp gather reassembles each tp rank's contiguous columns)."""
    return shard_tree(params, sharded_param_specs(params), tp_rank * fsdp + fsdp_rank,
                      tp * fsdp, device)


# ---------------------------------------------------------------------------
# ZeRO-1: the flat-padded layout over fsdp
# ---------------------------------------------------------------------------


def _chunk_of(size: int, n_shards: int) -> int:
    return math.ceil(size / (n_shards * _CHUNK_ALIGN)) * _CHUNK_ALIGN


def _flat_pad(x: torch.Tensor, n_shards: int) -> torch.Tensor:
    """A tensor → 1-D, zero-padded to n_shards × chunk."""
    flat = x.reshape(-1)
    return torch.nn.functional.pad(flat, (0, n_shards * _chunk_of(flat.numel(), n_shards)
                                          - flat.numel()))


def _slice_leaf(x: torch.Tensor, n_shards: int, rank: int) -> torch.Tensor:
    chunk = _chunk_of(x.numel(), n_shards)
    return _flat_pad(x, n_shards)[rank * chunk:(rank + 1) * chunk]


class Zero1Layout:
    """The trainable tree's leaves grouped into JAX's leaves, in JAX's order.

    A per-layer list of dicts (the LoRA adapters) stacks each key over the
    layers, as JAX's trees hold them; JAX flattens dicts in sorted key
    order.  ``groups`` is a list of (key, [(index in ``tree_leaves``,
    shape), ...]) with the layers in order."""

    def __init__(self, trainable, n_shards: int):
        from qlora_tpu_torch.utils.checkpoint import _leaf_keys

        leaves = tree_leaves(trainable)
        groups: dict = {}
        for j, ((key, _layer), leaf) in enumerate(zip(_leaf_keys(trainable), leaves)):
            groups.setdefault(key, []).append((j, tuple(leaf.shape)))
        self.groups = [(k, groups[k]) for k in sorted(groups, key=lambda k: k.split("/"))]
        self.n_shards = n_shards
        self.n_leaves = len(leaves)

    def size(self, key_members) -> int:
        return sum(math.prod(s) for _, s in key_members)

    def stacked(self, trainable) -> dict:
        """{key: the layers' leaves flattened and concatenated} in JAX's order."""
        leaves = tree_leaves(trainable)
        return {k: torch.cat([leaves[j].reshape(-1) for j, _ in m]) for k, m in self.groups}

    def chunk(self, trainable, rank: int, dtype=torch.float32) -> dict:
        """Rank `rank`'s chunk of every stacked leaf."""
        return {k: _slice_leaf(v.to(dtype), self.n_shards, rank)
                for k, v in self.stacked(trainable).items()}

    def unstack(self, stacked: dict, dtype=None) -> list:
        """The inverse of :meth:`stacked` (each key's first `size` values,
        split into its layers): leaves in ``tree_leaves`` order."""
        out = [None] * self.n_leaves
        for k, members in self.groups:
            flat, at = stacked[k], 0
            for j, shape in members:
                n = math.prod(shape)
                t = flat[at:at + n].reshape(shape)
                out[j] = t if dtype is None else t.to(dtype)
                at += n
        return out


def _state_kind(opt_state) -> str:
    keys = set(opt_state) if isinstance(opt_state, dict) else set()
    if keys == {"count", "mu", "nu"}:
        return "adamw"
    if keys == {"count", "m_q", "m_s", "sv_q", "sv_s"}:
        return "adam8bit"
    raise ValueError(f"no ZeRO-1 layout for an optimizer state with keys {sorted(keys)}")


_ADAM8_PARTS = ("m_q", "m_s", "sv_q", "sv_s")


def opt_state_full_to_zero1(opt_state, trainable, optimizer: Optimizer, n_shards: int):
    """The single-device optimizer state of `trainable` → its flat-padded
    ZeRO-1 layout, the global view (every chunk: ``[n_shards × chunk]`` a
    leaf; JAX's ``opt_state_full_to_zero1``).  An 8-bit state's blocks line
    up across the conversion: a stacked leaf's codes and scales are its
    layers' in order, which needs each layer's leaf to hold a multiple of
    256 values (else ``ValueError``)."""
    lay = Zero1Layout(trainable, n_shards)
    kind = _state_kind(opt_state)
    if kind == "adamw":
        pad = lambda tree: {k: _flat_pad(v, n_shards) for k, v in lay.stacked(tree).items()}
        return {"count": opt_state["count"], "mu": pad(opt_state["mu"]),
                "nu": pad(opt_state["nu"])}
    _check_adam8_lines_up(lay)
    out = {"count": opt_state["count"]}
    for part in _ADAM8_PARTS:
        leaves = opt_state[part]
        parts = []
        for k, members in lay.groups:
            flat = torch.cat([leaves[j].reshape(-1) for j, _ in members])
            n = lay.size(members)
            chunk = _chunk_of(n, n_shards)
            total = n_shards * chunk // (STATE_BLOCK if part.endswith("_s") else 1)
            parts.append(torch.nn.functional.pad(flat, (0, total - flat.numel())))
        out[part] = parts
    return out


def _check_adam8_lines_up(lay: Zero1Layout) -> None:
    for k, members in lay.groups:
        per = math.prod(members[0][1])
        if len(members) > 1 and per % STATE_BLOCK:
            raise ValueError(
                f"adam8bit under ZeRO-1: {k!r} holds {per} values a layer, no multiple of "
                f"{STATE_BLOCK}: its stacked 8-bit blocks are not its layers' blocks")


def opt_state_zero1_to_full(opt_state, trainable, optimizer: Optimizer):
    """The flat-padded ZeRO-1 state (global view) → the single-device
    layout of `trainable` (JAX's ``opt_state_zero1_to_full``): each stacked
    leaf cut to its size and split into its layers."""
    kind = _state_kind(opt_state)
    lay = Zero1Layout(trainable, 1)
    if kind == "adamw":
        unflat = lambda d: tree_unflatten(trainable, lay.unstack(d, torch.float32))
        return {"count": opt_state["count"], "mu": unflat(opt_state["mu"]),
                "nu": unflat(opt_state["nu"])}
    _check_adam8_lines_up(lay)
    out = {"count": opt_state["count"]}
    for part in _ADAM8_PARTS:
        leaves = [None] * lay.n_leaves
        for (k, members), flat in zip(lay.groups, opt_state[part]):
            at = 0
            for j, shape in members:
                n = math.prod(shape)
                if part.endswith("_s"):
                    n = -(-n // STATE_BLOCK)
                leaves[j] = flat[at:at + n].clone()
                at += n
        out[part] = leaves
    return out


def zero1_chunk(state_global, n_shards: int, rank: int):
    """Rank `rank`'s chunk of every leaf of a global ZeRO-1 state (the
    step count is whole)."""
    return tree_map(lambda x: x.reshape(n_shards, -1)[rank].clone(), state_global)


def zero1_gather(state_chunk, fsdp):
    """Every fsdp rank's chunk of a ZeRO-1 state gathered into the global
    view, every leaf's bytes in one all-gather (collective over `fsdp`:
    every rank calls it)."""
    leaves = tree_leaves(state_chunk)
    raw = [t.detach().to(fsdp.device).contiguous().view(torch.uint8).reshape(-1)
           for t in leaves]
    whole = fsdp.all_gather(torch.cat(raw), dim=0).reshape(fsdp.size, -1)
    out, at = [], 0
    for t, r in zip(leaves, raw):
        out.append(whole[:, at:at + r.numel()].contiguous().view(t.dtype).reshape(-1)
                   .to(t.device))
        at += r.numel()
    return tree_unflatten(state_chunk, out)


def init_zero1_opt_state(trainable, optimizer: Optimizer, n_shards: int, rank: int):
    """Rank `rank`'s chunk of the optimizer state over the flat-padded
    trainable tree (JAX's ``init_zero1_opt_state`` is the global view, every
    rank's chunk).  Works for any elementwise optimizer: the chunks are
    whole 256-blocks of adam8bit's state."""
    return optimizer.init(Zero1Layout(trainable, n_shards).chunk(trainable, rank))


def init_sharded_train_state(trainable, optimizer: Optimizer, mesh: ParallelMesh,
                             opt_state=None, zero1: bool = True) -> TrainState:
    """Step 0 on this rank: the whole trainable tree on its device, and the
    optimizer state, when fsdp > 1, as this rank's ZeRO-1 chunk (made by
    the optimizer, or cut from `opt_state`, a single-device state to
    resume)."""
    dev = mesh.device
    trainable = tree_map(lambda t: t.detach().to(dev), trainable)
    F = mesh.shape["fsdp"]
    if zero1 and F > 1:
        fresh = init_zero1_opt_state(trainable, optimizer, F, mesh.fsdp.rank)
        if opt_state is None:
            opt_state = fresh
        else:
            z = opt_state_full_to_zero1(tree_map(lambda t: t.to(dev), opt_state),
                                        trainable, optimizer, F)
            opt_state = _like_placement(zero1_chunk(z, F, mesh.fsdp.rank), fresh)
    elif opt_state is None:
        opt_state = optimizer.init(trainable)
    else:
        opt_state = _like_placement(tree_map(lambda t: t.to(dev), opt_state),
                                    optimizer.init(trainable))
    return TrainState(step=0, trainable=trainable, opt_state=opt_state)


def _like_placement(tree, like):
    """`tree`'s tensors on the devices (pinned where pinned) and in the
    dtypes of `like`'s: a resumed state rests where a fresh one would."""
    def one(t, ref):
        out = t.to(device=ref.device, dtype=ref.dtype)
        return out.pin_memory() if ref.is_pinned() and not out.is_pinned() else out
    return tree_map(one, tree, like)


def full_opt_state(state: TrainState, optimizer: Optimizer, mesh: ParallelMesh):
    """The single-device layout of this rank's optimizer state (collective
    over fsdp when the state is ZeRO-1: every rank calls it)."""
    if mesh.shape["fsdp"] == 1:
        return state.opt_state
    glob = zero1_gather(state.opt_state, mesh.fsdp)
    return opt_state_zero1_to_full(glob, state.trainable, optimizer)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def _rows(batch: dict, rank: int, n: int, accum_steps: int) -> dict:
    """Data rank `rank`'s rows of a global batch ([B, S], or [accum, B, S])."""
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v)
        dim = 1 if accum_steps > 1 else 0
        B = v.shape[dim]
        if B % n:
            raise ValueError(f"the global batch of {B} rows does not split over {n} data ranks")
        out[k] = v.narrow(dim, rank * (B // n), B // n)
    return out


def _sum_scalars(values: list, mesh) -> list:
    """Each value summed over `mesh`, in one f32 all-reduce."""
    t = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=mesh.device).reshape(())
                     for v in values])
    return list(mesh.all_reduce(t).unbind(0))


def _all_reduce_flat(tensors: list, mesh) -> list:
    """Each f32 tensor summed over `mesh`, in one all-reduce of their
    concatenation."""
    if not tensors or mesh.size == 1:
        return tensors
    flat = mesh.all_reduce(torch.cat([t.reshape(-1) for t in tensors]))
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return out


def _gather_flat(chunks: list, mesh) -> list:
    """Each rank's equal-sized chunks gathered over `mesh` in one all-gather:
    for each chunk, [size × chunk] in rank order."""
    if mesh.size == 1:
        return chunks
    whole = mesh.all_gather(torch.cat([c.reshape(-1) for c in chunks]), dim=0)
    whole = whole.reshape(mesh.size, -1)
    out, at = [], 0
    for c in chunks:
        out.append(whole[:, at:at + c.numel()].reshape(-1))
        at += c.numel()
    return out


def local_grads(cfg, lcfg, trainable, frozen, batch, accum_steps, data, remat, generator,
                ctx, loss=None) -> tuple:
    """This rank's gradients of the global mean loss from its rows, before
    the reduction over the data ranks: each micro-batch's local token-loss
    sum differentiated, divided by the global token count, summed over the
    micro-batches and divided by their number (f32).  `loss(trainable,
    frozen, micro_batch, generator) -> (mean, n)` is the micro-batch's
    loss (by default :func:`loss_fn`'s, remat `remat`).  Returns (grads as a
    list in ``tree_leaves`` order, the global loss)."""
    if loss is None:
        loss = lambda tr, fr, mb, gen: loss_fn(tr, fr, mb, cfg, lcfg, gen, True, "lora", remat)
    dev = data.device
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(trainable)]
    micros = [batch] if accum_steps == 1 else [{k: v[i] for k, v in batch.items()}
                                              for i in range(accum_steps)]
    grads = None
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    n_sum = torch.zeros((), dtype=torch.float32, device=dev)
    for mb in micros:
        mb = {k: v.to(dev) for k, v in mb.items()}
        with ctx():
            mean, n = loss(tree_unflatten(trainable, leaves), frozen, mb, generator)
            lsum = mean * n                    # LOCAL token-loss sum: no collective
            g = torch.autograd.grad(lsum, leaves)
        lsum_g, n_g = _sum_scalars([lsum.detach(), n], data)
        denom = torch.clamp(n_g, min=1.0)
        g = [t.float() / denom for t in g]
        if grads is None:
            grads = g
        else:
            for a, b in zip(grads, g):
                a.add_(b)
        loss_sum = loss_sum + lsum_g
        n_sum = n_sum + n_g
    if accum_steps > 1:
        for t in grads:
            t.div_(accum_steps)
    return grads, loss_sum / torch.clamp(n_sum, min=1.0)


def make_sharded_train_step(cfg: ModelConfig, lcfg: LoraConfig, optimizer: Optimizer,
                            mesh: ParallelMesh, accum_steps: int = 1,
                            clip_norm: Optional[float] = 0.3, remat="save_linear",
                            zero1: bool = True):
    """Returns ``train_step(state, frozen, batch, generator=None) -> (state,
    metrics)`` for this rank of a ``(dp, fsdp, tp)`` mesh.

    `frozen` is this rank's model shard (:func:`shard_sharded_params`), the
    state from :func:`init_sharded_train_state`.  `batch` is the GLOBAL
    batch, as every rank reads it from the same seeded stream ([B, S], or
    [accum_steps, B, S]); data rank d·F + f takes its B/(dp·fsdp) rows.
    ``metrics`` holds the global ``loss`` and ``grad_norm`` (before
    clipping), the same on every rank.  With fsdp > 1 the optimizer updates
    this rank's ZeRO-1 chunk; `clip_norm` is the optimizer chain's clip,
    applied first with the true global norm."""
    T, F = mesh.shape["tp"], mesh.shape["fsdp"]
    use_zero1 = zero1 and F > 1
    tp = mesh.tp if T > 1 else None
    fsdp = mesh.fsdp if F > 1 else None

    def ctx():
        return tp_shard_context(tp, fsdp, "gather")

    def train_step(state: TrainState, frozen, batch, generator=None):
        rows = _rows(batch, mesh.data.rank, mesh.data.size, accum_steps)
        g_local, loss = local_grads(cfg, lcfg, state.trainable, frozen, rows, accum_steps,
                                    mesh.data, remat, generator, ctx)
        return update_step(state, g_local, loss, optimizer, mesh, mesh.data, use_zero1,
                           clip_norm)

    return train_step


def update_step(state: TrainState, g_local: list, loss, optimizer: Optimizer,
                mesh: ParallelMesh, data, use_zero1: bool, clip_norm) -> tuple:
    """The step after the local gradients: the one heavy collective (the
    partial gradients summed over the data axes `data`), the global norm,
    and the optimizer's update of the whole tree or, under ZeRO-1, of this
    rank's chunk (clipped first with the true global norm), the chunks'
    updates gathered over fsdp.  Returns (state, metrics)."""
    g_leaves = _all_reduce_flat(g_local, data)
    grads = tree_unflatten(state.trainable, g_leaves)
    with torch.no_grad():
        gnorm = global_norm(grads)
        params = state.trainable
        if use_zero1:
            if clip_norm is not None:
                scale = clip_norm / torch.clamp(gnorm, min=clip_norm)
                grads = tree_map(lambda g: g * scale, grads)
            lay = Zero1Layout(params, mesh.shape["fsdp"])
            rank = mesh.fsdp.rank
            upd, opt_state = optimizer.update(lay.chunk(grads, rank), state.opt_state,
                                              lay.chunk(params, rank))
            keys = [k for k, _ in lay.groups]
            whole = dict(zip(keys, _gather_flat([upd[k].float() for k in keys], mesh.fsdp)))
            updates = tree_unflatten(params, lay.unstack(whole))
        else:
            updates, opt_state = optimizer.update(grads, state.opt_state, params)
        del grads
        new = TrainState(step=state.step + 1, trainable=apply_updates(params, updates),
                         opt_state=opt_state)
    return new, {"loss": loss, "grad_norm": gnorm}


def make_sharded_eval_step(cfg: ModelConfig, lcfg: LoraConfig, mesh: ParallelMesh,
                           style: str = "gather"):
    """Returns ``eval_step(trainable, frozen, batch) -> (loss, n_valid)`` on
    this rank's shards: every rank runs the whole batch through the sharded
    forward (no dropout, no remat, no gradients) and gets the same numbers."""
    T, F = mesh.shape["tp"], mesh.shape["fsdp"]
    tp = mesh.tp if T > 1 else None
    fsdp = mesh.fsdp if F > 1 else None

    def eval_step(trainable, frozen, batch):
        b = {k: torch.as_tensor(v).to(mesh.device) for k, v in batch.items()}
        with torch.no_grad(), tp_shard_context(tp, fsdp, style):
            return loss_fn(trainable, frozen, b, cfg, lcfg, None, False, "lora")

    return eval_step
