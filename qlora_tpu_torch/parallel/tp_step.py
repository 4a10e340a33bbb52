"""The dp×tp training step: :func:`make_sharded_train_step` on a mesh whose
fsdp axis has size 1 (the JAX package's ``parallel/tp_step.py``, kept there
for its callers)."""

from __future__ import annotations

from qlora_tpu_torch.parallel.sharded_step import make_sharded_train_step, sharded_param_specs


def tp_param_specs(params: dict) -> dict:
    """The gather style's specs, with the fsdp axis at size 1."""
    return sharded_param_specs(params)


def make_tp_train_step(cfg, lcfg, optimizer, mesh, accum_steps: int = 1, **kw):
    """The gather style's step on a ``(dp, 1, tp)`` mesh."""
    if mesh.shape["fsdp"] != 1:
        raise ValueError(f"a dp x tp mesh has fsdp 1, not {mesh.shape['fsdp']}")
    return make_sharded_train_step(cfg, lcfg, optimizer, mesh, accum_steps=accum_steps, **kw)
