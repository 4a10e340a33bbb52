"""Rank functions of tests/test_torch_tp_decode.py: each runs in a process
of a gloo world on the CPU, started by ``parallel.distributed.run_ranks``,
and returns numpy arrays and lists.  Not collected by pytest; it imports
torch, numpy and the port only, so that a rank starts without JAX.

``world(mesh, cases)`` runs a list of ``(name, function name, kwargs)`` in
one world and returns ``{name: result}``: one world a test module, however
many cases, since each start of a world costs seconds."""

from __future__ import annotations

import numpy as np
import torch

from qlora_tpu_torch.generate.paged import PagedBatcher, PagedPool
from qlora_tpu_torch.models.layers import (
    gather_cols_fwd_slice_bwd, ident_fwd_psum_bwd, psum_fwd_ident_bwd,
)
from qlora_tpu_torch.models.transformer import init_cache
from qlora_tpu_torch.parallel import (
    make_tp_forward_fn, shard_decode_params, shard_lora, shard_paged_cache, shard_tp_cache,
)
from qlora_tpu_torch.utils.convert import lora_from_numpy, params_from_numpy

torch.set_num_threads(1)


def _trees(cfg, params_np, lora_np):
    params = params_from_numpy(params_np, cfg, "cpu")
    lora = None if lora_np is None else lora_from_numpy(lora_np, "cpu")
    return params, lora


def forced_logits(mesh, cfg, lcfg, params_np, lora_np, ids, forced, cap):
    """Prefill ids [B, S] into a contiguous cache, then decode the forced
    tokens [B, n] one at a time: logits [B, 1 + n, V] (the prefill's last
    position, then each step's)."""
    params, lora = _trees(cfg, params_np, lora_np)
    p = shard_decode_params(params, mesh)
    lo = shard_lora(lora, mesh)
    fn = make_tp_forward_fn(cfg, lcfg, mesh)
    cache = shard_tp_cache(init_cache(cfg, ids.shape[0], cap, device="cpu"), mesh)
    with torch.no_grad():
        logits, cache = fn(p, lo, torch.as_tensor(ids), cache)
        outs = [logits[:, ids.shape[1] - 1]]
        for t in range(forced.shape[1]):
            logits, cache = fn(p, lo, torch.as_tensor(forced[:, t:t + 1]), cache)
            outs.append(logits[:, 0])
    assert cache["k"][0].shape[1] == cfg.num_kv_heads // mesh.size
    return torch.stack(outs, 1).numpy()


def paged_forced_logits(mesh, cfg, lcfg, params_np, lora_np, ids, forced, page):
    """As :func:`forced_logits`, the decode steps over a paged pool of this
    rank's heads: the prefill's KV written into pages, then one decode
    forward a forced token through the paged kernel's plain version."""
    params, lora = _trees(cfg, params_np, lora_np)
    p = shard_decode_params(params, mesh)
    lo = shard_lora(lora, mesh)
    B, S = ids.shape
    cap = S + forced.shape[1] + 1
    fn = make_tp_forward_fn(cfg, lcfg, mesh)
    paged_fn = make_tp_forward_fn(cfg, lcfg, mesh, paged=True)
    cache = shard_tp_cache(init_cache(cfg, B, S, device="cpu"), mesh)
    pps = -(-cap // page)
    pool = PagedPool(cfg, 1 + B * pps, page, pps, device="cpu")
    local = shard_paged_cache(pool.decode_cache([], []), mesh)
    pool.k_pages, pool.v_pages = local["k_pages"], local["v_pages"]
    with torch.no_grad():
        logits, cache = fn(p, lo, torch.as_tensor(ids), cache)
        outs = [logits[:, S - 1]]
        for b in range(B):
            pool.allocate(b + 1, cap)
            pool.write_prefill(b + 1, [k[b] for k in cache["k"]], [v[b] for v in cache["v"]])
        for t in range(forced.shape[1]):
            pc = pool.decode_cache(list(range(1, B + 1)), [S + t] * B)
            logits, pc = paged_fn(p, lo, torch.as_tensor(forced[:, t:t + 1]), pc)
            pool.update_from(pc)
            outs.append(logits[:, 0])
    return torch.stack(outs, 1).numpy(), int(pool.k_pages[0].shape[1])


def batcher(mesh, cfg, lcfg, params_np, lora_np, prompts, max_new, engine):
    """PagedBatcher(tp_mesh=mesh) on the prompts: each request's tokens, the
    free pages before and after, the pools' heads, and the engine's
    counters."""
    params, lora = _trees(cfg, params_np, lora_np)
    b = PagedBatcher(params, lora, cfg, lcfg, eos_id=-1, tp_mesh=mesh, device="cpu",
                     **engine)
    free0 = b.pool.n_free
    reqs = [b.submit(list(p), max_new_tokens=n) for p, n in zip(prompts, max_new)]
    b.run_to_completion()
    out = {"tokens": [r.generated for r in reqs], "free": (free0, b.pool.n_free),
           "pool_heads": int(b.pool.k_pages[0].shape[1]), "preemptions": b.preemptions,
           "steps_per_dispatch": b.steps_per_dispatch, "disagreements": mesh.disagreements,
           "admissions": [[(n, L) for uid, n, L in b.admission_log if uid == r.uid]
                          for r in reqs]}
    mesh.disagreements = 0
    if engine.get("spec_draft_len"):
        out["spec"] = (b.spec_tokens, b.spec_chunks)
    if engine.get("decode_impl") == "int8":
        wo = b.decode_params["blocks"][0]["wo"].qt
        out["wo8"] = (wo.quant_type, wo.k_shards, tuple(wo.packed.shape), wo.block_size)
        out["lm_head"] = type(b.decode_params["lm_head"]).__name__
    return out


def int8_budget(mesh, cfg, lcfg, params_np, ids):
    """One decode step's logits on the chunk-local int8 tree against the
    exact tensor-parallel path's on the same prefill: max |int8 - exact| /
    max |exact|."""
    params, _ = _trees(cfg, params_np, None)
    b = PagedBatcher(params, None, cfg, lcfg, num_slots=2, n_pages=16, page_size=8,
                     max_pages_per_seq=8, prefill_buckets=(16,), eos_id=-1, tp_mesh=mesh,
                     decode_impl="int8", prefill_impl="w8a8", device="cpu")
    p = shard_decode_params(params, mesh)
    exact = make_tp_forward_fn(cfg, lcfg, mesh)
    int8 = make_tp_forward_fn(cfg, lcfg, mesh, impl="w8a8")
    B, S = ids.shape
    with torch.no_grad():
        c1 = shard_tp_cache(init_cache(cfg, B, 32, device="cpu"), mesh)
        c2 = shard_tp_cache(init_cache(cfg, B, 32, device="cpu"), mesh)
        le, c1 = exact(p, None, torch.as_tensor(ids), c1)
        _, c2 = int8(b.decode_params, None, torch.as_tensor(ids), c2)
        tok = le[:, -1].argmax(-1)[:, None]
        le, _ = exact(p, None, tok, c1)
        la, _ = int8(b.decode_params, None, tok, c2)
    e, a = le[:, 0].numpy(), la[:, 0].numpy()
    return float(np.abs(a - e).max() / np.abs(e).max())


def conjugate_grads(mesh, x, w1, w2):
    """The three conjugate operators' gradients: a column-parallel product
    on x, its output gathered (one loss term) and fed through a
    row-parallel product reduced once (another); this rank's gradients of
    x, of its columns of w1 and of its rows of w2."""
    r, n = mesh.rank, w1.shape[1] // mesh.size
    x = torch.as_tensor(x).clone().requires_grad_(True)
    w1 = torch.as_tensor(w1)[:, r * n:(r + 1) * n].clone().requires_grad_(True)
    w2 = torch.as_tensor(w2)[r * n:(r + 1) * n].clone().requires_grad_(True)
    y = ident_fwd_psum_bwd(x, mesh) @ w1
    full = gather_cols_fwd_slice_bwd(y, mesh)
    out = psum_fwd_ident_bwd(torch.tanh(y) @ w2, mesh)
    loss = (full ** 2).sum() * 0.5 + (out * torch.linspace(-1, 1, out.shape[1])).sum()
    loss.backward()
    return loss.item(), x.grad.numpy(), w1.grad.numpy(), w2.grad.numpy()


def serve_tp_tokens(mesh, cfg, params_np, ids, max_new):
    """examples/serve_tp's rank function on the carried params."""
    from qlora_tpu_torch.examples.serve_tp import serve_rank

    params, _ = _trees(cfg, params_np, None)
    toks = serve_rank(mesh, params, cfg, list(ids), max_new, eos_id=-1)
    out = (toks, mesh.disagreements)
    mesh.disagreements = 0
    return out


def same_counts(mesh):
    """``TPMesh.same`` on a tensor that differs across the ranks, then on
    one that does not: (what each returned, the disagreements after
    each)."""
    a = mesh.same(torch.tensor([mesh.rank, 7]))
    n1 = mesh.disagreements
    b = mesh.same(torch.tensor([3, 7]))
    out = (a.tolist(), n1, b.tolist(), mesh.disagreements)
    mesh.disagreements = 0
    return out


def world(mesh, cases):
    return {name: globals()[fn](mesh, **kw) for name, fn, kw in cases}
