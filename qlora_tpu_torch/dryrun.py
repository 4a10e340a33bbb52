"""The multi-rank dry run: every parallel path of the port, one step each at
tiny shapes, in one world of n ranks (the JAX package's
``dryrun_multichip``, ``__graft_entry__.py``).

    python -m qlora_tpu_torch.dryrun 4 [--device cpu]

The paths, each over a mesh its rank function builds on the one world (the
groups of every mesh made in turn on every rank):

1. GSPMD: the LoRA step over NF4 storage sharded over fsdp·tp, the rows
   over dp (``parallel/gspmd_step.py``);
2. the dp×fsdp×tp step, 2 micro-batches a step, ZeRO-1 where fsdp > 1;
3. Megatron over (dp·fsdp, tp), re-packed row-parallel storage (tp > 1);
4. the ring over (n/2, sp 2), weights whole (n even), and the
   weight-sharded ring over (n/8, 2, 2, 2) with ZeRO-1 (n % 8 == 0);
5. tensor-parallel serving: a prefill and a decode step over the tp axis,
   the KV cache of KVH/tp heads (tp > 1);
6. ``PagedBatcher`` over the tp axis with the int8 decode copy and
   speculation (tp > 1): every request served, every page recycled.

The mesh factors n as JAX's does: tp 2 where n is even, fsdp 2 where
4 divides n, dp the rest.  Each path asserts what JAX's asserts (finite
positive losses, finite logits, requests and pages).  The ranks run over
NCCL, a card a rank, where the machine has n cards; on fewer cards as gloo
ranks sharing ``cuda:0``; with ``device="cpu"`` over gloo on the CPU (the
plain PyTorch path).
"""

from __future__ import annotations

import argparse
import math
import tempfile
import time
from typing import Callable, Optional

import torch

from qlora_tpu_torch import resolve_device


def _factor(n: int) -> tuple:
    tp = 2 if n % 2 == 0 else 1
    fsdp = 2 if n % 4 == 0 else 1
    return n // (tp * fsdp), fsdp, tp


def _config(model_shards: int):
    from qlora_tpu_torch.models.config import ModelConfig

    return ModelConfig(arch="llama", vocab_size=1024, hidden_size=256,
                       intermediate_size=128 * 4 * model_shards, num_layers=2, num_heads=4,
                       num_kv_heads=4)


def _batch(shape) -> dict:
    ids = torch.ones(shape, dtype=torch.int32)
    return {"input_ids": ids, "attention_mask": torch.ones_like(ids), "labels": ids}


def _check(ok: bool, msg: str) -> None:
    """A dry-run check: raises where it fails (the world ends with it)."""
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def _loss_ok(tag: str, m: dict) -> float:
    loss = float(m["loss"])
    _check(math.isfinite(loss) and loss > 0, f"{tag}: bad loss {loss}")
    return loss


def ranks_for(n: int, device) -> tuple:
    """(backend, devices) of the dry run's n ranks: NCCL with rank r on
    ``cuda:r`` where the machine has n cards, gloo ranks sharing
    ``cuda:0`` where it has fewer, gloo on the CPU for the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return "gloo", ["cpu"] * n
    if torch.cuda.device_count() >= n:
        return "nccl", [f"cuda:{r}" for r in range(n)]
    return "gloo", [f"cuda:{device.index or 0}"] * n


def dryrun_rank(world, n: int, probe: Optional[Callable] = None) -> list:
    """Every path on this rank of the world; rank 0's lines are what the dry
    run prints.  `probe(event, path)` (a module-level function), where
    given, is called with "start" before each path and "end" after it; what
    "end" returns is kept beside the path's line."""
    from qlora_tpu_torch.generate.paged import PagedBatcher
    from qlora_tpu_torch.generate.sampler import SamplingParams
    from qlora_tpu_torch.lora import LoraConfig
    from qlora_tpu_torch.models import init_lora_params, init_params
    from qlora_tpu_torch.models.transformer import init_cache
    from qlora_tpu_torch.parallel import (
        init_megatron_state, init_sharded_train_state, make_megatron_train_step,
        make_parallel_mesh, make_sharded_train_step, make_sp_train_step, mesh_coords,
        make_tp_forward_fn, requantize_row_parallel, shard_decode_params, shard_params,
        shard_sharded_params, shard_tp_cache, tree_to,
    )
    from qlora_tpu_torch.parallel.gspmd_step import (
        cut_state, make_gspmd_train_step,
    )
    from qlora_tpu_torch.parallel.mesh import MeshAxes
    from qlora_tpu_torch.parallel.mesh import shard_params as gspmd_shard_params
    from qlora_tpu_torch.train import make_optimizer

    dev = world.device
    if dev.type == "cpu":
        torch.set_num_threads(1)
    dp, fsdp, tp = _factor(n)
    cfg = _config(fsdp * tp)
    lcfg = LoraConfig(r=8, alpha=16)
    opt = make_optimizer("paged_adamw_32bit", 1e-4, total_steps=10)
    params = init_params(cfg, seed=0, quantized=True, device="cpu")
    fresh_lora = lambda: init_lora_params(cfg, lcfg, seed=1, device=dev)
    ACCUM, S = 2, 64
    lines = []

    def path(name, fn):
        if probe is not None:
            probe("start", name)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        line = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seen = probe("end", name) if probe is not None else None
        lines.append((name, line, time.perf_counter() - t0, seen))

    def gspmd():
        mesh = make_parallel_mesh(world, dp, fsdp, tp, model_axis=True)
        axes = MeshAxes(dp, fsdp, tp)
        _, f, t = mesh_coords(world.rank, dp, fsdp, tp)
        frozen = gspmd_shard_params(params, axes, f, t, dev)
        lora, _ = cut_state(fresh_lora(), None, axes, f, t, "lora", dev)
        state = init_sharded_train_state(lora, opt, mesh, zero1=False)
        step = make_gspmd_train_step(cfg, lcfg, opt, mesh, mode="lora")
        _, m = step(state, frozen, _batch((2 * dp, S)))
        return (f"GSPMD) on {n} devices: mesh={axes}, model shards {fsdp * tp} "
                f"(fsdp-major), loss={_loss_ok('GSPMD', m):.4f}")

    def sharded():
        mesh = make_parallel_mesh(world, dp, fsdp, tp)
        _, f, t = mesh_coords(world.rank, dp, fsdp, tp)
        frozen = shard_sharded_params(params, t, f, tp, fsdp, dev)
        state = init_sharded_train_state(fresh_lora(), opt, mesh)
        step = make_sharded_train_step(cfg, lcfg, opt, mesh, accum_steps=ACCUM)
        _, m = step(state, frozen, _batch((ACCUM, 2 * dp * fsdp, S)))
        return (f"shard_map dp={dp} fsdp={fsdp} tp={tp}, kernels per-shard, accum={ACCUM}, "
                f"zero1={fsdp > 1}): loss={_loss_ok('sharded', m):.4f}")

    def megatron():
        mesh = make_parallel_mesh(world, dp * fsdp, 1, tp)
        frozen = shard_params(requantize_row_parallel(params, tp), mesh.tp.rank, tp, dev)
        state = init_megatron_state(fresh_lora(), opt, mesh)
        step = make_megatron_train_step(cfg, lcfg, opt, mesh, accum_steps=ACCUM)
        _, m = step(state, frozen, _batch((ACCUM, 2 * dp * fsdp, S)))
        return (f"megatron dp={dp * fsdp} tp={tp}, row-parallel K-sharded NF4, "
                f"accum={ACCUM}): loss={_loss_ok('megatron', m):.4f}")

    def ring():
        sp = 2
        mesh = make_parallel_mesh(world, n // sp, 1, 1, sp)
        state = init_sharded_train_state(fresh_lora(), opt, mesh)
        step = make_sp_train_step(cfg, lcfg, opt, mesh)
        _, m = step(state, tree_to(params, dev), _batch((2 * (n // sp), S)))
        return f"ring-attention dp={n // sp} sp={sp}): loss={_loss_ok('ring', m):.4f}"

    def ring_sharded():
        mesh = make_parallel_mesh(world, n // 8, 2, 2, 2)
        _, f, t = mesh_coords(world.rank, n // 8, 2, 2, 2)
        frozen = shard_sharded_params(params, t, f, 2, 2, dev)
        state = init_sharded_train_state(fresh_lora(), opt, mesh)
        step = make_sp_train_step(cfg, lcfg, opt, mesh, clip_norm=0.3)
        _, m = step(state, frozen, _batch((2 * (n // 8) * 2, S)))
        return (f"weight-sharded ring dp={n // 8} fsdp=2 tp=2 sp=2, zero1): "
                f"loss={_loss_ok('weight-sharded ring', m):.4f}")

    def tp_serving():
        mesh = make_parallel_mesh(world, n // tp, 1, tp).tp
        p5 = shard_decode_params(params, mesh)
        cache = shard_tp_cache(init_cache(cfg, 2, 32, device=dev), mesh)
        fn = make_tp_forward_fn(cfg, lcfg, mesh)
        with torch.no_grad():
            logits, cache = fn(p5, None, torch.ones((2, 8), dtype=torch.int32, device=dev),
                               cache)                                        # prefill
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            logits, cache = fn(p5, None, tok, cache)                         # a decode step
        _check(bool(torch.isfinite(logits).all()), "tp serving: logits not finite")
        _check(cache["k"][0].shape[1] == cfg.num_kv_heads // tp,
               f"tp serving: a rank's cache holds {cache['k'][0].shape[1]} heads")
        return (f"tp serving tp={tp}, head-sharded KV): decode logit "
                f"max={float(logits.max()):.3f}")

    def paged():
        mesh = make_parallel_mesh(world, n // tp, 1, tp).tp
        pb = PagedBatcher(params, None, cfg, num_slots=4, n_pages=64, page_size=8,
                          max_pages_per_seq=8, prefill_buckets=(16,), eos_id=-1,
                          sparams=SamplingParams(temperature=0.0), tp_mesh=mesh,
                          decode_impl="int8", spec_draft_len=2, device=dev)
        free = pb.pool.n_free
        for i in range(3):
            pb.submit(list(range(4 + i, 10 + i)), max_new_tokens=6)
        done = pb.run_to_completion()
        _check(len(done) == 3 and all(len(r.generated) == 6 for r in done),
               "paged tp: requests unserved")
        _check(pb.pool.n_free == free, "paged tp: pages must fully recycle")
        _check(pb.pool.k_pages[0].shape[1] == cfg.num_kv_heads // tp,
               f"paged tp: a rank's pool holds {pb.pool.k_pages[0].shape[1]} heads")
        return (f"PagedBatcher engine tp={tp}, int8 chunk-local requant, SPECULATIVE verify "
                f"chunks, admission/decode/recycle): {sum(len(r.generated) for r in done)} "
                "tokens served")

    path("gspmd", gspmd)
    path("sharded", sharded)
    if tp > 1:
        path("megatron", megatron)
    if n % 2 == 0:
        path("ring", ring)
    if n % 8 == 0:
        path("ring-sharded", ring_sharded)
    if tp > 1:
        path("tp-serving", tp_serving)
        path("paged-tp", paged)
    return lines


def dryrun_multichip(n_devices: int, device=None, probe: Optional[Callable] = None,
                     verbose: bool = True) -> list:
    """Run :func:`dryrun_rank` in a world of `n_devices` ranks on `device`
    (CUDA unless named; see :func:`ranks_for`) and print rank 0's lines;
    returns every rank's (path, line, seconds, probe's report) lists."""
    from qlora_tpu_torch.parallel import run_ranks

    dev = resolve_device(device)
    backend, devices = ranks_for(n_devices, dev)
    with tempfile.TemporaryDirectory() as tmp:
        out = run_ranks(dryrun_rank, n_devices, n_devices, probe, backend=backend,
                        devices=devices, store_dir=tmp, timeout_s=1800)
    if verbose:
        for name, line, secs, _ in out[0]:
            print(f"dryrun_multichip OK ({line} [{secs:.2f} s; {backend} on "
                  f"{', '.join(sorted(set(devices)))}]", flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser("python -m qlora_tpu_torch.dryrun")
    p.add_argument("n_devices", type=int, nargs="?", default=8)
    p.add_argument("--device", default=None)
    a = p.parse_args(argv)
    dryrun_multichip(a.n_devices, a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
