"""Rank functions of tests/test_torch_sharded_step.py,
tests/test_torch_megatron_train.py, tests/test_torch_zero1.py,
tests/test_torch_ring_attention.py, tests/test_torch_sp_step.py,
tests/test_torch_gspmd_step.py, tests/test_torch_multihost.py and
tests/test_torch_dryrun.py: each
runs in a process of a 4-rank gloo world on the CPU, started by
``parallel.distributed.run_ranks``, and returns numpy arrays, numbers and
lists.  Not collected by pytest; it imports torch, numpy and the port only,
so that a rank starts without JAX.

``world(mesh, cases)`` runs a list of ``(name, function name, kwargs)`` in
one world and returns ``{name: result}``: one world a test module, however
many cases, since each start of a world costs seconds.  Each case builds
its ``(dp, fsdp, tp)`` or ``(dp, fsdp, tp, sp)`` mesh over the world
(``make_parallel_mesh``: every case creates its groups on every rank, in
the same order)."""

from __future__ import annotations

import hashlib

import torch

from qlora_tpu_torch.lora import LoraConfig
from qlora_tpu_torch.ops import ring_attention
from qlora_tpu_torch.parallel import (
    full_opt_state, init_megatron_state, init_sharded_train_state, make_megatron_train_step,
    make_parallel_mesh, make_sharded_eval_step, make_sharded_train_step, make_sp_train_step,
    make_tp_train_step, megatron_lora_specs, gather_megatron_tree, mesh_coords, shard_params,
    shard_sharded_params, zero1_gather,
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
    ZeRO-1 this rank's chunk sizes and the state's global view.  `shape`
    is (dp, fsdp, tp), or (dp, fsdp, tp, sp) with the style "sp" (the
    sequence-parallel step)."""
    dp, fsdp, tp = shape[:3]
    mesh = make_parallel_mesh(world, *shape)
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
        _, f, t = mesh_coords(world.rank, *shape)
        frozen = shard_sharded_params(params, t, f, tp, fsdp, "cpu")
        state = init_sharded_train_state(lora, optimizer, mesh)
        make = (make_sp_train_step if style == "sp" else
                make_tp_train_step if via_tp_step else make_sharded_train_step)
        step = make(cfg, lcfg, optimizer, mesh, accum_steps=accum, clip_norm=clip_norm,
                    remat=remat)
    out = {"loss": [], "grad_norm": [], "collectives": [],
           "frozen_share": sum(t.numel() * t.element_size() for t in tree_leaves(frozen))
           / sum(t.numel() * t.element_size() for t in tree_leaves(params))}
    if fsdp > 1 and style != "megatron" and opt != "sgd":
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
    if fsdp > 1 and style != "megatron" and opt != "sgd":
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


def ring(world, q, k, v, do, shape, causal=True, impl="auto"):
    """``ring_attention`` over the sp axis of a ``(dp, fsdp, tp, sp)`` mesh
    on this rank's shard of the whole q, k, v (numpy f32, rounded to bf16
    here): its output and the gradients of q, k and v under the cotangent
    `do`, and the rotations the sp axis made."""
    mesh = make_parallel_mesh(world, *shape)
    n, r = mesh.sp.size, mesh.sp.rank
    cut = lambda x: x[:, :, r * (x.shape[2] // n):(r + 1) * (x.shape[2] // n)]
    leaf = lambda x: torch.tensor(cut(x)).to(torch.bfloat16).requires_grad_(True)
    qs, ks, vs = leaf(q), leaf(k), leaf(v)
    o = ring_attention(qs, ks, vs, mesh.sp, sm_scale=q.shape[-1] ** -0.5, causal=causal,
                       impl=impl)
    o.backward(torch.tensor(cut(do)).to(torch.bfloat16))
    f32 = lambda t: t.detach().float().numpy()
    return dict(o=f32(o), dq=f32(qs.grad), dk=f32(ks.grad), dv=f32(vs.grad),
                rotations=mesh.sp.collectives, sp_rank=r)


def rotations(world):
    """``TPMesh.rotate`` on the sp axis of (1, 1, 1, 4) and (1, 1, 2, 2):
    what each rank receives from a rotation by +1 and by -1 of tensors of
    three dtypes (a bf16 one of odd size: the packing pads it), two in
    flight at once, and the count."""
    out = {}
    for shape in ((1, 1, 1, 4), (1, 1, 2, 2)):
        mesh = make_parallel_mesh(world, *shape)
        mine = [torch.full((3,), world.rank, dtype=torch.bfloat16),
                torch.arange(5, dtype=torch.float32) + 10 * world.rank,
                torch.full((2, 2), world.rank, dtype=torch.int32)]
        fwd = mesh.sp.rotate(mine, shift=1, tag=0)
        back = mesh.sp.rotate(mine, shift=-1, tag=1)
        got = [[t.float().tolist() for t in rot.wait()] for rot in (fwd, back)]
        out[shape] = dict(got=got, count=mesh.sp.collectives,
                          shapes=[(tuple(t.shape), str(t.dtype)) for t in fwd.wait()])
    return out


def sp_groups(world):
    """Each axis' (rank on the axis, size, world ranks gathered in axis
    order) on this rank, for every (dp, fsdp, tp, sp) mesh of 4 with sp > 1."""
    out = {}
    for shape in ((1, 1, 1, 4), (2, 1, 1, 2), (1, 2, 1, 2), (1, 1, 2, 2)):
        mesh = make_parallel_mesh(world, *shape)
        x = torch.tensor([float(world.rank)])
        out[shape] = {a: (mesh.axis(a).rank, mesh.axis(a).size,
                          mesh.axis(a).all_gather(x, dim=0).tolist())
                      for a in ("dp", "fsdp", "tp", "sp", "data", "data_sp")}
    return out


def gspmd(world, cfg, lcfg_kw, params_np, lora_np, batch, shape, mode="full", accum=1, steps=3,
          opt="paged_adamw_32bit", lr=1e-3, clip_norm=0.3):
    """`steps` GSPMD steps (``parallel/gspmd_step.py``) on this rank's slice
    of the JAX tree (`params_np` the trainable model in mode "full", the
    frozen one in mode "lora"): each step's loss and grad norm, the
    gradients the optimizer got at the first step and the update it made at
    the second (the first moves nothing: the warmup starts at 0; this
    rank's slices, f32), the split dimension of each trainable tensor, the
    trainable tree at the end gathered whole (rank 0), a digest of the bytes
    of every tensor the rank holds (replicas compared across the ranks by
    the test), and the rank's trainable and optimizer bytes."""
    from qlora_tpu_torch.parallel import (
        MeshAxes, cut_state, gather_tree, make_gspmd_train_step,
    )
    from qlora_tpu_torch.parallel.gspmd_step import trainable_specs
    from qlora_tpu_torch.parallel.mesh import shard_params as gspmd_shard_params
    from qlora_tpu_torch.parallel.megatron_step import spec_leaves

    dp, fsdp, tp = shape
    mesh = make_parallel_mesh(world, dp, fsdp, tp, model_axis=True)
    _, f, t = mesh_coords(world.rank, dp, fsdp, tp)
    axes = MeshAxes(dp, fsdp, tp)
    lcfg = LoraConfig(**lcfg_kw)
    params = params_from_numpy(params_np, cfg, "cpu")
    seen = {}
    inner = _optimizer(opt, lr)

    def update(grads, state, params):
        upd, state = inner.update(grads, state, params)
        f32 = lambda tree: [x.detach().float().numpy().copy() for x in tree_leaves(tree)]
        if "grads" not in seen:
            seen["grads"] = f32(grads)
        elif "update" not in seen:
            seen["update"] = f32(upd)
        return upd, state

    optimizer = Optimizer(inner.init, update)
    if mode == "full":
        whole, frozen = params, None
    else:
        whole, frozen = lora_from_numpy(lora_np, "cpu"), gspmd_shard_params(params, axes, f, t)
    mine, _ = cut_state(whole, None, axes, f, t, mode)
    state = init_sharded_train_state(mine, optimizer, mesh, zero1=False)
    step = make_gspmd_train_step(cfg, lcfg, optimizer, mesh, mode=mode, accum_steps=accum,
                                 clip_norm=clip_norm)
    nbytes = lambda tree: sum(x.numel() * x.element_size() for x in tree_leaves(tree))
    specs = trainable_specs(state.trainable, mode)
    out = {"loss": [], "grad_norm": [], "trainable_bytes": nbytes(state.trainable),
           "trainable_numel": sum(x.numel() for x in tree_leaves(state.trainable)),
           "opt_bytes": nbytes(state.opt_state), "whole_bytes": nbytes(whole),
           "dims": spec_leaves(state.trainable, specs), "coords": (f, t)}
    for _ in range(steps):
        state, m = step(state, frozen, batch)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    out.update(seen)
    gathered = gather_tree(state.trainable, specs, mesh.model, keep=world.rank == 0)
    if world.rank == 0:
        out["whole"] = [x.float().numpy() for x in tree_leaves(gathered)]
    out["digests"] = [hashlib.sha1(x.detach().contiguous().view(torch.uint8).numpy()).hexdigest()
                      for x in tree_leaves(state.trainable)]
    return out


def multihost(world, local_batch, spans_of=(), **train_kw):
    """JAX's multi-host skeleton (tests/multihost_worker.py) on the port:
    the global mesh over every process's ranks (``make_global_mesh``), the
    global batch from this process's rows (``global_batch_from_local``),
    then :func:`train`'s steps on it; with it, whether ``make_global_mesh``
    warned for each shape of `spans_of` (fsdp×tp groups spanning processes),
    this rank's ``process_info`` and the global batch's sum."""
    import dataclasses as _dc
    import warnings

    from qlora_tpu_torch.parallel import (
        MeshAxes, global_batch_from_local, make_global_mesh, process_info,
    )

    mesh = make_global_mesh(world, MeshAxes(*train_kw["shape"]))
    batch = global_batch_from_local(mesh, local_batch)
    out = train(world, batch=batch, **train_kw)
    out["warned"] = {}
    for shape in spans_of:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            make_global_mesh(world, MeshAxes(*shape))
        out["warned"][shape] = any("span multiple processes" in str(w.message) for w in seen)
    out["info"] = _dc.asdict(process_info())
    out["batch_sum"] = int(batch["input_ids"].sum())
    out["rank"] = world.rank
    return out


def path_probe(event, name):
    """A ``dryrun_rank`` probe: what "end" returns is kept beside the path."""
    return (event, name) if event == "end" else None


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
