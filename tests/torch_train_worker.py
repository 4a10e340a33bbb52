"""Rank functions of tests/test_torch_sharded_step.py and
tests/test_torch_megatron_train.py: each runs in a process of a 4-rank gloo
world on the CPU, started by ``parallel.distributed.run_ranks``, and
returns numpy arrays, numbers and lists.  Not collected by pytest; it
imports torch, numpy and the port only, so that a rank starts without JAX.

``world(mesh, cases)`` runs a list of ``(name, function name, kwargs)`` in
one world and returns ``{name: result}``: one world a test module, however
many cases, since each start of a world costs seconds.  Each case builds
its ``(dp, fsdp, tp)`` mesh over the world (``make_parallel_mesh``: every
case creates its groups on every rank, in the same order)."""

from __future__ import annotations

import torch

from qlora_tpu_torch.lora import LoraConfig
from qlora_tpu_torch.parallel import (
    full_opt_state, init_megatron_state, init_sharded_train_state, make_megatron_train_step,
    make_parallel_mesh, make_sharded_eval_step, make_sharded_train_step, make_tp_train_step,
    megatron_lora_specs, gather_megatron_tree, mesh_coords, shard_params, shard_sharded_params,
    zero1_gather,
)
from qlora_tpu_torch.train import make_optimizer
from qlora_tpu_torch.train.optimizer import Optimizer, tree_leaves, tree_map
from qlora_tpu_torch.utils.convert import lora_from_numpy, lora_to_numpy, params_from_numpy

torch.set_num_threads(1)


def sgd(lr: float) -> Optimizer:
    """Plain SGD with no clip: the update is -lr x the gradient (optax.sgd)."""
    return Optimizer(lambda params: {},
                     lambda grads, state, params: (tree_map(lambda g: -lr * g, grads), state))


def _optimizer(name, lr, offload=False):
    return sgd(lr) if name == "sgd" else make_optimizer(name, lr, total_steps=10,
                                                        offload_state=offload)


def _numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _whole_lora(state, mesh, style):
    if style == "megatron":
        return gather_megatron_tree(state.trainable, megatron_lora_specs(state.trainable),
                                    mesh.tp)
    return state.trainable


def train(world, cfg, lcfg_kw, params_np, lora_np, batch, shape, style="gather", accum=1,
          steps=3, opt="paged_adamw_32bit", lr=1e-3, clip_norm=0.3, remat="save_linear",
          via_tp_step=False, offload=False):
    """`steps` optimizer steps of the port's mesh step on every rank's shard
    of the JAX tree: each step's loss and grad norm, the trainable tree at
    the end (whole), the collectives of each step by axis, and under
    ZeRO-1 this rank's chunk sizes and the state's global view."""
    dp, fsdp, tp = shape
    mesh = make_parallel_mesh(world, dp, fsdp, tp)
    lcfg = LoraConfig(**lcfg_kw)
    params = params_from_numpy(params_np, cfg, "cpu")
    lora = lora_from_numpy(lora_np, "cpu")
    optimizer = _optimizer(opt, lr, offload)
    if style == "megatron":
        frozen = shard_params(params, mesh.tp.rank, tp, "cpu")
        state = init_megatron_state(lora, optimizer, mesh)
        step = make_megatron_train_step(cfg, lcfg, optimizer, mesh, accum_steps=accum,
                                        clip_norm=clip_norm, remat=remat)
    else:
        _, f, t = mesh_coords(world.rank, dp, fsdp, tp)
        frozen = shard_sharded_params(params, t, f, tp, fsdp, "cpu")
        state = init_sharded_train_state(lora, optimizer, mesh)
        make = make_tp_train_step if via_tp_step else make_sharded_train_step
        step = make(cfg, lcfg, optimizer, mesh, accum_steps=accum, clip_norm=clip_norm,
                    remat=remat)
    out = {"loss": [], "grad_norm": [], "collectives": [],
           "frozen_share": sum(t.numel() * t.element_size() for t in tree_leaves(frozen))
           / sum(t.numel() * t.element_size() for t in tree_leaves(params))}
    if fsdp > 1 and style == "gather" and opt != "sgd":
        out["chunk_sizes"] = [t.numel() for t in tree_leaves(state.opt_state)]
    base = mesh.collectives()
    for _ in range(steps):
        state, m = step(state, frozen, batch)
        now = mesh.collectives()
        out["collectives"].append({k: now[k] - base[k] for k in now})
        base = now
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    out["held_shapes"] = {n: {k: tuple(t.shape) for k, t in ad.items()}
                          for n, ad in state.trainable[0].items()}
    out["lora"] = lora_to_numpy(_whole_lora(state, mesh, style))
    if fsdp > 1 and style == "gather" and opt != "sgd":
        out["zero1_global"] = _numpy(zero1_gather(state.opt_state, mesh.fsdp))
        out["full_state"] = _numpy(full_opt_state(state, optimizer, mesh))
    return out


def eval_loss(world, cfg, lcfg_kw, params_np, lora_np, batch, shape, style="gather"):
    """The sharded eval step's (loss, n) on every rank: the whole batch."""
    dp, fsdp, tp = shape
    mesh = make_parallel_mesh(world, dp, fsdp, tp)
    params = params_from_numpy(params_np, cfg, "cpu")
    lora = lora_from_numpy(lora_np, "cpu")
    if style == "megatron":
        frozen = shard_params(params, mesh.tp.rank, tp, "cpu")
        lora = init_megatron_state(lora, sgd(0.0), mesh).trainable
    else:
        _, f, t = mesh_coords(world.rank, dp, fsdp, tp)
        frozen = shard_sharded_params(params, t, f, tp, fsdp, "cpu")
    loss, n = make_sharded_eval_step(cfg, LoraConfig(**lcfg_kw), mesh, style)(lora, frozen, batch)
    return float(loss), int(n)


def groups(world):
    """Each axis' (rank on the axis, size) on this rank, for every mesh of 4."""
    out = {}
    for shape in ((1, 2, 2), (2, 2, 1), (2, 1, 2), (4, 1, 1), (1, 4, 1), (1, 1, 4)):
        mesh = make_parallel_mesh(world, *shape)
        x = torch.tensor([float(world.rank)])
        out[shape] = {a: (mesh.axis(a).rank, mesh.axis(a).size,
                          mesh.axis(a).all_gather(x, dim=0).tolist())
                      for a in ("dp", "fsdp", "tp", "data")}
    return out


def world(mesh, cases):
    out = {}
    for name, fn, kw in cases:
        out[name] = globals()[fn](mesh, **kw)
    return out


def record_hook(event, ctx):
    """A ``cli.train(hook=...)`` probe: each event with its step, and each
    step's loss as this rank sees it."""
    rep = ctx["report"]
    rep["rank"] = ctx["mesh"].rank
    rep.setdefault("events", []).append((event, ctx["step"]))
    if event == "step":
        rep.setdefault("losses", []).append(float(ctx["metrics"]["loss"]))
