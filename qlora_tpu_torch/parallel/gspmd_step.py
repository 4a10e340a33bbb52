"""GSPMD training over a ``(dp, fsdp, tp)`` mesh: the JAX package's
``make_train_step(mode=...)`` as XLA partitions it under the rules of
``parallel/mesh.py``, written out for one process a rank.

* The model's tensors shard over the joint model axis (fsdp·tp ranks,
  fsdp-major: ``mesh.model``), the adapters are whole on every rank, the
  optimizer's moments follow their tensor.  Every linear is column-parallel
  over the joint axis (``tp_shard_context(mesh.model)``: its input gets
  ident-fwd/psum-bwd, its output columns are gathered forward and sliced
  backward), and so are the embedding's features and the lm_head.  A rank
  therefore holds the exact gradient of its shards and of the whole tensors
  it holds: the gradients need no reduction over the model axis.
* The rows go over dp only (JAX's ``P("dp", None)``): unlike the gather
  style's step, fsdp is not a batch axis here.  The ranks' gradients are
  summed over dp once a step.
* The gradient arithmetic is the single device's (``sharded_step.
  local_grads``: each micro-batch's local token-loss sum divided by the
  global token count, the micro-batches' mean), as is the global norm: the
  squares of the sharded tensors summed over the model axis, those of the
  whole ones counted once.  With sharded tensors the gradients are clipped
  with that norm before the optimizer, whose own clip sees only this rank's
  shards and then does nothing.

``mode="full"`` trains every tensor of an unquantized model (the CLI's
``--full_finetune`` on a mesh), under remat "full" where "save_linear" is
asked for, as the single device's step; ``mode="lora"`` trains the
adapters over a frozen model sharded the same way (NF4 storage column
shards).  The optimizer's moments are f32, where JAX's full mode keeps
them in the parameters' bf16 (ROADMAP C7).
"""

from __future__ import annotations

from typing import Optional

import torch

from qlora_tpu_torch.lora import LoraConfig
from qlora_tpu_torch.models.config import ModelConfig
from qlora_tpu_torch.models.layers import tp_shard_context
from qlora_tpu_torch.parallel.distributed import ParallelMesh
from qlora_tpu_torch.parallel.megatron_step import shard_tree, spec_leaves
from qlora_tpu_torch.parallel.mesh import (
    MeshAxes, lora_specs, model_shard, opt_specs_like, param_specs,
)
from qlora_tpu_torch.parallel.sharded_step import _rows, local_grads
from qlora_tpu_torch.train.optimizer import (
    Optimizer, apply_updates, tree_leaves, tree_map, tree_unflatten,
)
from qlora_tpu_torch.train.step import TrainState, _check_mode, loss_fn


def trainable_specs(trainable, mode: str):
    """The spec tree of the trainable tree: the model's rules in mode
    "full", every adapter whole in mode "lora"."""
    _check_mode(mode)
    return param_specs(trainable) if mode == "full" else lora_specs(trainable)


def cut_state(trainable, opt_state, axes: MeshAxes, fsdp_rank: int, tp_rank: int, mode: str,
              device=None) -> tuple:
    """Rank (d, f, t)'s slice of a single-device trainable tree and of its
    optimizer state (None: the rank makes its own), on `device`."""
    specs = trainable_specs(trainable, mode)
    shard, size = model_shard(axes, fsdp_rank, tp_rank), axes.model
    mine = shard_tree(trainable, specs, shard, size, device)
    if opt_state is not None:
        ospecs = opt_specs_like(opt_state, trainable, specs)
        opt_state = (tree_map(lambda t: t.to(device) if device else t, opt_state)
                     if ospecs is None else shard_tree(opt_state, ospecs, shard, size, device))
    return mine, opt_state


def model_context(mesh: ParallelMesh):
    """The model sharded over the mesh's joint model axis (every linear
    column-parallel over it), as the GSPMD step and eval run it."""
    return tp_shard_context(mesh.model if mesh.model.size > 1 else None, None, "gather")


def make_gspmd_train_step(cfg: ModelConfig, lcfg: LoraConfig, optimizer: Optimizer,
                          mesh: ParallelMesh, mode: str = "lora", accum_steps: int = 1,
                          clip_norm: Optional[float] = 0.3, remat="save_linear"):
    """Returns ``train_step(state, frozen, batch, generator=None) -> (state,
    metrics)`` for this rank of a ``(dp, fsdp, tp)`` mesh.

    The state comes from ``init_sharded_train_state(trainable, optimizer,
    mesh, opt_state, zero1=False)`` on this rank's slice (:func:`cut_state`:
    the optimizer's state made on the rank's device, or the slice of a
    resumed one placed where a fresh one rests); `frozen` is this rank's
    slice of the frozen model (``parallel.mesh.shard_params``; ignored in mode
    "full").  `batch` is the GLOBAL batch, as every rank reads it ([B, S],
    or [accum_steps, B, S]); dp rank d takes its B/dp rows.  ``metrics``
    holds the global ``loss`` and ``grad_norm`` (before clipping), the same
    on every rank.  `clip_norm` is the optimizer chain's clip (None: the
    optimizer has none)."""
    _check_mode(mode)
    if mode == "full" and remat == "save_linear":
        remat = "full"
    if mesh.shape.get("sp", 1) > 1:
        raise ValueError("the GSPMD step has no sp axis")
    if mesh.model is None:
        raise ValueError("the GSPMD step needs the mesh's model axis "
                         "(make_parallel_mesh(..., model_axis=True))")

    def loss(tr, fr, mb, gen):
        return loss_fn(tr, fr, mb, cfg, lcfg, gen, True, mode, remat)

    def train_step(state: TrainState, frozen, batch, generator=None):
        rows = _rows(batch, mesh.dp.rank, mesh.dp.size, accum_steps)
        g_local, loss_v = local_grads(cfg, lcfg, state.trainable, frozen, rows, accum_steps,
                                      mesh.dp, remat, generator, lambda: model_context(mesh), loss)
        sharded = [s is not None for s in spec_leaves(state.trainable,
                                                      trainable_specs(state.trainable, mode))]
        return update_step(state, g_local, loss_v, optimizer, mesh, sharded, clip_norm)

    return train_step


_BUCKET_BYTES = 1 << 28       # the gradients' all-reduce over dp, a bucket at a time


def all_reduce_buckets(tensors: list, mesh) -> list:
    """Each f32 tensor summed over `mesh` in place, the tensors concatenated
    into all-reduces of up to _BUCKET_BYTES (a full model's gradients would
    otherwise be copied whole twice)."""
    if mesh.size == 1:
        return tensors
    bucket, size = [], 0

    def flush():
        flat = mesh.all_reduce(torch.cat([t.reshape(-1) for t in bucket]))
        at = 0
        for t in bucket:
            t.copy_(flat[at:at + t.numel()].view_as(t))
            at += t.numel()

    for t in tensors:
        bucket.append(t)
        size += t.numel() * t.element_size()
        if size >= _BUCKET_BYTES:
            flush()
            bucket, size = [], 0
    if bucket:
        flush()
    return tensors


def global_norm_sharded(grads: list, sharded: list, model) -> torch.Tensor:
    """sqrt(Σ g²) over the whole tensors and every rank's shards: the
    shards' squares summed over `model` (one all-reduce), each whole
    tensor's counted once."""
    dev = grads[0].device
    sq = lambda gs: (torch.stack([g.float().square().sum() for g in gs]).sum() if gs
                     else torch.zeros((), dtype=torch.float32, device=dev))
    total = sq([g for g, s in zip(grads, sharded) if not s])
    if any(sharded):
        total = total + model.all_reduce(sq([g for g, s in zip(grads, sharded) if s]))
    return total.sqrt()


def update_step(state: TrainState, g_local: list, loss, optimizer: Optimizer,
                mesh: ParallelMesh, sharded: list, clip_norm) -> tuple:
    """The step after the local gradients: their sum over dp (all-reduces
    of up to 256 MB), the global norm, the clip with it where tensors are
    sharded, and the optimizer's update of this rank's slice."""
    g_leaves = all_reduce_buckets(g_local, mesh.dp)
    with torch.no_grad():
        gnorm = global_norm_sharded(g_leaves, sharded, mesh.model)
        if clip_norm is not None and any(sharded):
            scale = clip_norm / torch.clamp(gnorm, min=clip_norm)
            g_leaves = [g * scale for g in g_leaves]
        grads = tree_unflatten(state.trainable, g_leaves)
        params = tree_map(lambda p: p.detach(), state.trainable)
        updates, opt_state = optimizer.update(grads, state.opt_state, params)
        del grads, g_leaves
        new = TrainState(step=state.step + 1, trainable=apply_updates(params, updates),
                         opt_state=opt_state)
    return new, {"loss": loss, "grad_norm": gnorm}


def make_gspmd_eval_step(cfg: ModelConfig, lcfg: LoraConfig, mesh: ParallelMesh,
                         mode: str = "lora"):
    """Returns ``eval_step(trainable, frozen, batch) -> (loss, n_valid)``:
    every rank runs the whole batch through the sharded forward (no
    dropout, no remat, no gradients) and gets the same numbers."""
    _check_mode(mode)

    def eval_step(trainable, frozen, batch):
        b = {k: torch.as_tensor(v).to(mesh.device) for k, v in batch.items()}
        with torch.no_grad(), model_context(mesh):
            return loss_fn(trainable, frozen, b, cfg, lcfg, None, False, mode)

    return eval_step


def gather_tree(tree, specs, model, device="cpu", keep: bool = True):
    """A tree of model-axis shards made whole on `device`, a tensor at a
    time: each split tensor gathered over `model` (collective: every rank
    of the axis calls it) and moved off the card before the next, so that
    no rank holds more than one whole tensor beside its shards (the
    checkpoint of a model past one card's memory).  A rank that does not
    `keep` takes part in the gathers and gets None."""
    leaves = tree_leaves(tree)
    dims = spec_leaves(tree, specs) if specs is not None else [None] * len(leaves)
    out = []
    with torch.no_grad():
        for t, d in zip(leaves, dims):
            if d is not None and model.size > 1:
                t = model.all_gather(t.detach().contiguous(), dim=d)
            if keep:
                out.append(t.detach().to(device))
    return tree_unflatten(tree, out) if keep else None
