"""The sequence-parallel training step: LoRA finetuning with the sequence
cut over the ``sp`` axis of a ``(dp, fsdp, tp, sp)`` mesh, one process a
rank (the JAX package's ``parallel/sp_step.py``).

Every per-token op (embedding, linears, norms, loss) runs on the rank's
contiguous shard of the sequence; attention runs through
``ops/ring_attention.py``, the key and value shards rotating around the sp
ranks.  A rank's activations are those of S/sp tokens, so the context a
card trains grows with the ring.

The batch's rows go over (dp, fsdp), as in the gather-style step
(``sharded_step.py``), and its columns over sp.  The labels are shifted
over the whole sequence before it is cut (``train.loss.shift_labels``), so
that each shard's last prediction counts.  The gradient arithmetic is
``sharded_step``'s: each micro-batch's LOCAL token-loss sum differentiated,
divided by the token count all-reduced over (dp, fsdp, sp), and one
all-reduce of the gradients over the same axes a step.  Weight sharding
composes as there: with fsdp or tp > 1 the frozen NF4 storage is N-sharded
over tp·fsdp and gathered a linear at a time (``tp_shard_context``, the
gather style: the ring needs every head on every rank, so the Megatron
style does not compose), and with fsdp > 1 the optimizer state is ZeRO-1,
clipped on the true global norm.  Full-length sequences only (no padding
mask: the CLI pads S to a multiple of sp with ignored labels at the end,
which causality keeps out of every real token's attention).
"""

from __future__ import annotations

from typing import Optional

import torch

from qlora_tpu_torch.lora import LoraConfig
from qlora_tpu_torch.models.config import ModelConfig
from qlora_tpu_torch.models.layers import tp_shard_context
from qlora_tpu_torch.parallel.distributed import ParallelMesh
from qlora_tpu_torch.parallel.sharded_step import _rows, local_grads, update_step
from qlora_tpu_torch.train.loss import shift_labels
from qlora_tpu_torch.train.optimizer import Optimizer
from qlora_tpu_torch.train.step import TrainState, sp_loss_fn


def sp_shard(batch: dict, mesh: ParallelMesh, accum_steps: int = 1) -> dict:
    """This rank's part of a GLOBAL batch ([B, S], or [accum, B, S]):
    ``input_ids`` and the globally shifted ``labels_shifted``, its data
    rank's rows and its sp rank's run of S/sp columns."""
    ids = torch.as_tensor(batch["input_ids"])
    labels = shift_labels(torch.as_tensor(batch["labels"]))
    rows = _rows({"input_ids": ids, "labels_shifted": labels}, mesh.data.rank, mesh.data.size,
                 accum_steps)
    S, n = ids.shape[-1], mesh.shape["sp"]
    if S % n:
        raise ValueError(f"a sequence of {S} does not split over sp={n} (pad it to a multiple)")
    return {k: v.narrow(-1, mesh.sp.rank * (S // n), S // n) for k, v in rows.items()}


def make_sp_train_step(cfg: ModelConfig, lcfg: LoraConfig, optimizer: Optimizer,
                       mesh: ParallelMesh, accum_steps: int = 1,
                       clip_norm: Optional[float] = 0.3, remat="full", zero1: bool = True):
    """Returns ``train_step(state, frozen, batch, generator=None) -> (state,
    metrics)`` for this rank of a ``(dp, fsdp, tp, sp)`` mesh.

    `frozen` is this rank's model shard (``shard_sharded_params`` at its
    (tp, fsdp) coordinates; the whole model when both are 1), the state from
    ``init_sharded_train_state``.  `batch` is the GLOBAL batch with
    ``input_ids`` and ``labels`` ([B, S], or [accum_steps, B, S]), S a
    multiple of sp; data rank d·F + f takes its B/(dp·fsdp) rows, sp rank s
    its S/sp columns.  ``metrics`` holds the global ``loss`` and
    ``grad_norm``, the same on every rank.  `remat` defaults to "full", as
    JAX's: the long-context path keeps the least activation memory.  (JAX
    refuses a weight-sharded mesh that lacks the fsdp or the tp axis; a
    ``ParallelMesh`` always has all four, of size 1 where unused.)"""
    T, F = mesh.shape["tp"], mesh.shape["fsdp"]
    use_zero1 = zero1 and F > 1
    tp = mesh.tp if T > 1 else None
    fsdp = mesh.fsdp if F > 1 else None

    def ctx():
        return tp_shard_context(tp, fsdp, "gather")

    def loss(trainable, frozen, mb, generator):
        return sp_loss_fn(trainable, frozen, mb, cfg, lcfg, mesh.sp, generator, remat)

    def train_step(state: TrainState, frozen, batch, generator=None):
        shard = sp_shard(batch, mesh, accum_steps)
        g_local, mean = local_grads(cfg, lcfg, state.trainable, frozen, shard, accum_steps,
                                    mesh.data_sp, remat, generator, ctx, loss)
        return update_step(state, g_local, mean, optimizer, mesh, mesh.data_sp, use_zero1,
                           clip_norm)

    return train_step
