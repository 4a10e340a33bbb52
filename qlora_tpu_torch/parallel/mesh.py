"""The partition rules of GSPMD training: the JAX package's
``parallel/mesh.py``, as cuts of a tree.

JAX places the model over a ``(dp, fsdp, tp)`` mesh with ``NamedSharding``s
and lets XLA partition the single-device step; the port runs one process a
rank, so each rule here says which slice of a tensor rank ``(d, f, t)``
holds, and :func:`shard_params` cuts it.

* Frozen or trainable model tensors shard their output features over the
  joint model axis ``MODEL_AXES = ("fsdp", "tp")``, fsdp-major: rank
  ``(d, f, t)`` holds N-shard ``f·T + t`` of fsdp·tp (the order of JAX's
  ``P(..., ("fsdp", "tp"))``; the gather style of ``sharded_step`` splits
  its storage the other way round, ``t·F + f``).  Covered: every linear's
  storage (NF4 ``packed``, ``absmax``, ``absmax_scale``; a dense ``w``) and
  bias, the embedding's features and the lm_head's columns.  Norms are
  whole on every rank, as is a quantized tensor's ``absmax_offset``.
* LoRA adapters are whole on every rank (``lora_shardings``).
* The optimizer's moments follow their parameter (``_opt_specs_like``); the
  step count is whole.

A spec tree mirrors its tree, with the split dimension of each tensor (an
int) or None where the tensor is whole.
"""

from __future__ import annotations

import dataclasses

from qlora_tpu_torch.parallel.megatron_step import shard_tree, spec_leaves
from qlora_tpu_torch.parallel.sharded_step import sharded_param_specs

MODEL_AXES = ("fsdp", "tp")     # the model's tensors shard over their product


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    dp: int = 1
    fsdp: int = 1
    tp: int = 1

    @property
    def model(self) -> int:
        """The number of shards of a model tensor (fsdp·tp)."""
        return self.fsdp * self.tp


def param_specs(params: dict) -> dict:
    """The split dimension of every tensor of a params tree (quantized or
    dense) over the model axes: each linear's columns, the embedding's
    features and the lm_head's columns; norms whole (JAX's
    ``param_shardings``)."""
    return sharded_param_specs(params)


def _whole(tree):
    if isinstance(tree, dict):
        return {k: _whole(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_whole(v) for v in tree)
    return None


def lora_specs(lora) -> list:
    """Every adapter tensor whole on every rank (JAX's ``lora_shardings``)."""
    return _whole(lora)


def model_shard(axes: MeshAxes, fsdp_rank: int, tp_rank: int) -> int:
    """The model shard of rank (d, f, t): f·T + t, of fsdp·tp."""
    return fsdp_rank * axes.tp + tp_rank


def shard_params(params: dict, axes: MeshAxes, fsdp_rank: int, tp_rank: int,
                 device=None) -> dict:
    """Rank (d, f, t)'s slice of a params tree on `device`: 1/(fsdp·tp) of
    every split tensor, N-shard f·T + t; norms whole."""
    return shard_tree(params, param_specs(params), model_shard(axes, fsdp_rank, tp_rank),
                      axes.model, device)


def opt_specs_like(opt_state, trainable, trainable_specs):
    """The spec tree of an optimizer state over `trainable` (of spec
    `trainable_specs`): AdamW's ``mu`` and ``nu`` follow the tree, the count
    is whole (JAX's ``_opt_specs_like``).  The state of a tree that is whole
    on every rank (the adapters) is whole, whatever the optimizer; a sharded
    tree needs an AdamW-family state (8-bit blocks do not follow a column
    shard: ValueError)."""
    if all(s is None for s in spec_leaves(trainable, trainable_specs)):
        return None
    if isinstance(opt_state, dict) and set(opt_state) == {"count", "mu", "nu"}:
        return {"count": None, "mu": trainable_specs, "nu": trainable_specs}
    raise ValueError("a sharded model's optimizer state follows its shards: an AdamW-family "
                     "optimizer only (8-bit blockwise state does not follow a column shard)")
