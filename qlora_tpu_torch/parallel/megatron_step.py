"""The Megatron block's partition rules: which dimension each tensor of a
params or LoRA tree splits over, and the storage its row-parallel linears
need.

* wq/wk/wv, w_gate/w_up (and GPT-NeoX's w_qkv, w_fc) are column-parallel:
  rank r holds columns r·N/tp.. of each; attention runs on its local heads.
* wo, w_down (w_out) are row-parallel over K-sharded storage
  (``quant.blockwise.quantize_k_sharded``): rank r holds K-chunk r, a
  self-contained tensor, and its partial products sum over the ranks once a
  sub-block.
* LoRA adapters shard with their base linear: B's columns for column
  linears, A's rows for row linears.
* The embedding splits its features (gathered after the lookup), the
  lm_head its columns (gathered after the product); norms are whole on
  every rank.

A spec tree mirrors its params tree with, in place of each tensor, the
dimension it splits over or None (whole on every rank); :func:`shard_tree`
cuts a tree down to one rank's shard, and :func:`shard_params` cuts a
params tree with each row-parallel linear quantized as the rank's K-chunk
alone.  Serving runs on these shards (``parallel/tp_decode.py``), and so
does the Megatron train step (:func:`make_megatron_train_step`): the LoRA
adapters and AdamW's moments sharded with their base linears
(:func:`init_megatron_state`), gathered whole for checkpoints
(:func:`gather_megatron_tree`).
"""

from __future__ import annotations

import dataclasses

import torch

from qlora_tpu_torch.models.layers import DenseLinear, QLinear
from qlora_tpu_torch.quant.blockwise import (
    QuantizedTensor, dequantize, k_chunk, quantize, quantize_k_sharded,
)

# row-parallel (K-sharded) linears of either architecture; every other block
# linear is column-parallel
ROW_PARALLEL = {"wo", "w_down", "w_out"}


def _check_packable(name: str, qt: QuantizedTensor, tp: int) -> None:
    K = qt.shape[0]
    if qt.quant_type != "int8" and K % (2 * qt.block_size * tp):
        raise ValueError(
            f"{name}: K={K} does not split into {tp} chunks of whole split-half "
            f"block pairs (K % {2 * qt.block_size * tp}); pad the intermediate "
            "dimension (load_hf_model's pad_intermediate_to)")


def requantize_row_parallel(params: dict, tp: int) -> dict:
    """Re-pack the row-parallel linears with shard-local split-half packing
    over `tp` K-chunks (one dequantize and quantize of each, at set-up), on
    the device they live on; a linear already K-sharded over `tp` chunks,
    and every other tensor, is shared as it is."""
    blocks = []
    for block in params["blocks"]:
        block = dict(block)
        for name in ROW_PARALLEL & set(block):
            lin = block[name]
            if not isinstance(lin, QLinear) or lin.qt.k_shards == tp:
                continue
            qt = lin.qt
            _check_packable(name, qt, tp)
            block[name] = QLinear(
                qt=quantize_k_sharded(dequantize(qt, torch.float32), tp, qt.block_size,
                                      qt.quant_type, qt.double_quant),
                bias=lin.bias)
        blocks.append(block)
    return dict(params, blocks=blocks)


def _qt_spec(qt: QuantizedTensor, row: bool) -> QuantizedTensor:
    d = 0 if row else 1
    return dataclasses.replace(
        qt, packed=d, absmax=d,
        absmax_scale=None if qt.absmax_scale is None else d,
        absmax_offset=None if (qt.absmax_offset is None or not row) else 0)


def _linear_spec(name: str, lin):
    row = name in ROW_PARALLEL
    bias = None if (lin.bias is None or row) else 0
    if isinstance(lin, QLinear):
        return QLinear(qt=_qt_spec(lin.qt, row), bias=bias)
    return DenseLinear(w=0 if row else 1, bias=bias)


def _whole(tree):
    if isinstance(tree, dict):
        return {k: _whole(v) for k, v in tree.items()}
    return None


def megatron_param_specs(params: dict) -> dict:
    """The split dimension of every tensor of a params tree (None: whole)."""
    blocks = [{name: (_linear_spec(name, v) if isinstance(v, (QLinear, DenseLinear))
                      else _whole(v)) for name, v in block.items()}
              for block in params["blocks"]]
    lm = params["lm_head"]
    return {
        "embed": 1,
        "blocks": blocks,
        "final_norm": _whole(params["final_norm"]),
        "lm_head": _linear_spec("lm_head", lm),
    }


def megatron_lora_specs(lora: list) -> list:
    """A's rows for row-parallel linears, B's columns for the others."""
    return [{name: ({"a": 0, "b": None} if name in ROW_PARALLEL else {"a": None, "b": 1})
             for name in layer} for layer in lora]


def _cut(t: torch.Tensor, dim, rank: int, size: int, device) -> torch.Tensor:
    """Rank `rank`'s even share of `t` along `dim` (all of it for None), a
    tensor of its own on `device`: nothing of the whole stays referenced."""
    if dim is not None:
        n = t.shape[dim]
        if n % size:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not divide {size}")
        t = t.narrow(dim, rank * (n // size), n // size)
    device = torch.device(device)
    if t.device == device:
        return t.clone(memory_format=torch.contiguous_format)
    # made whole where it lives, then moved: a strided copy across devices is
    # several times slower
    return t.contiguous().to(device)


def shard_tree(tree, specs, rank: int, size: int, device=None):
    """Cut a params, LoRA or cache tree down to rank `rank` of `size` by its
    spec tree, onto `device` (the tree's own where None).  A column shard
    of a quantized tensor is a quantized tensor of N/size columns; a row
    shard of K-sharded storage keeps its ``k_shards`` tag until
    ``local_chunk`` makes it self-contained (:func:`shard_params` does both)."""
    if isinstance(tree, torch.Tensor):
        return _cut(tree, specs, rank, size, device or tree.device)
    if tree is None:
        return None
    if isinstance(tree, QuantizedTensor):
        out = dataclasses.replace(
            tree, packed=shard_tree(tree.packed, specs.packed, rank, size, device),
            absmax=shard_tree(tree.absmax, specs.absmax, rank, size, device),
            absmax_scale=shard_tree(tree.absmax_scale, specs.absmax_scale, rank, size,
                                    device),
            absmax_offset=shard_tree(tree.absmax_offset, specs.absmax_offset, rank, size,
                                     device))
        if specs.packed == 1:
            out = dataclasses.replace(out, shape=(tree.shape[0], out.packed.shape[1]))
        return out
    if isinstance(tree, QLinear):
        return QLinear(qt=shard_tree(tree.qt, specs.qt, rank, size, device),
                       bias=shard_tree(tree.bias, specs.bias, rank, size, device))
    if isinstance(tree, DenseLinear):
        return DenseLinear(w=shard_tree(tree.w, specs.w, rank, size, device),
                           bias=shard_tree(tree.bias, specs.bias, rank, size, device))
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], rank, size, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if isinstance(specs, (list, tuple)):
            return type(tree)(shard_tree(v, s, rank, size, device)
                              for v, s in zip(tree, specs))
        return type(tree)(shard_tree(v, specs, rank, size, device) for v in tree)
    return tree


def _row_chunk(name: str, lin: QLinear, rank: int, size: int, device) -> QLinear:
    """Rank `rank`'s K-chunk of a row-parallel linear as a self-contained
    tensor of its own on `device`: taken as it is from K-sharded storage of
    `size` chunks (byte for byte), else its rows dequantized and quantized
    alone, which is chunk `rank` of ``quantize_k_sharded`` (computed where
    the weight lives)."""
    qt = lin.qt
    device = device or qt.device
    if qt.k_shards == size:
        chunk = k_chunk(qt, rank)
    else:
        _check_packable(name, qt, size)
        K = qt.shape[0]
        Kc = K // size
        chunk = quantize(dequantize(qt, torch.float32)[rank * Kc:(rank + 1) * Kc],
                         Kc if qt.block_size == K else qt.block_size, qt.quant_type,
                         qt.double_quant)
    whole = dataclasses.replace(chunk, packed=None, absmax=None, absmax_scale=None,
                                absmax_offset=None)
    bias = None if lin.bias is None else _cut(lin.bias, None, rank, size, device)
    return QLinear(qt=shard_tree(chunk, whole, 0, 1, device), bias=bias)


def shard_params(params: dict, rank: int, size: int, device=None) -> dict:
    """Rank `rank`'s shard of a params tree on `device`: the embedding, the
    lm_head and the column-parallel linears cut by the Megatron specs, each
    row-parallel linear as the rank's self-contained K-chunk, so that no
    rank quantizes more than its own rows.  Works from the whole tree where
    it lives: a parent cutting each rank's shard, or a rank its own."""
    specs = megatron_param_specs(params)
    blocks = [{name: (_row_chunk(name, v, rank, size, device)
                      if name in ROW_PARALLEL and isinstance(v, QLinear)
                      else shard_tree(v, spec[name], rank, size, device))
               for name, v in block.items()}
              for block, spec in zip(params["blocks"], specs["blocks"])]
    rest = {k: v for k, v in params.items() if k != "blocks"}
    return dict(shard_tree(rest, {k: specs[k] for k in rest}, rank, size, device),
                blocks=blocks)


def tree_to(tree, device):
    """A params, LoRA or cache tree with every tensor on `device` (tensors
    there already are kept, not copied)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, (QuantizedTensor, QLinear, DenseLinear)):
        return dataclasses.replace(tree, **{f.name: tree_to(getattr(tree, f.name), device)
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree


def spec_leaves(tree, specs) -> list:
    """The spec of each tensor of `tree` (dicts, lists and the linears'
    dataclasses; a None spec covers a whole subtree), in ``tree_leaves``
    order."""
    if isinstance(tree, torch.Tensor):
        return [specs]
    sub = lambda get: None if specs is None else get(specs)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [s for f in dataclasses.fields(tree)
                for s in spec_leaves(getattr(tree, f.name), sub(lambda sp: getattr(sp, f.name)))]
    if isinstance(tree, dict):
        return [s for k, v in tree.items() for s in spec_leaves(v, sub(lambda sp: sp[k]))]
    if isinstance(tree, (list, tuple)):
        return [s for i, v in enumerate(tree) for s in spec_leaves(v, sub(lambda sp: sp[i]))]
    return []


def _opt_specs_like(opt_state, lora_specs):
    """The split dimension of each tensor of an optimizer state whose
    moments follow the LoRA tree (AdamW's mu and nu); the count is whole.
    The 8-bit state's blocks do not follow the shards: ValueError, as the
    JAX CLI raises for adam8bit under Megatron."""
    if isinstance(opt_state, dict) and set(opt_state) == {"count", "mu", "nu"}:
        return {"count": None, "mu": lora_specs, "nu": lora_specs}
    raise ValueError("the Megatron step's optimizer state follows the tp-sharded adapters: "
                     "an AdamW-family optimizer only (adam8bit does not compose with "
                     "tp_style=megatron)")


def init_megatron_state(lora: list, optimizer, mesh, opt_state=None):
    """Step 0 on this rank of a (dp, tp) mesh: its shard of the whole LoRA
    tree by :func:`megatron_lora_specs` on its device, and the optimizer
    state over that shard (made by the optimizer, or cut from `opt_state`,
    a single-device state to resume)."""
    from qlora_tpu_torch.parallel.sharded_step import _like_placement
    from qlora_tpu_torch.train.step import TrainState

    specs = megatron_lora_specs(lora)
    t, T = mesh.tp.rank, mesh.shape["tp"]
    shard = shard_tree(lora, specs, t, T, mesh.device)
    fresh = optimizer.init(shard)
    if opt_state is not None:
        fresh = _like_placement(
            shard_tree(opt_state, _opt_specs_like(opt_state, specs), t, T, mesh.device), fresh)
    return TrainState(step=0, trainable=shard, opt_state=fresh)


def gather_megatron_tree(tree, specs, tp):
    """A tree of tp shards (the LoRA adapters, or AdamW's state) gathered
    whole along each tensor's split dimension, the split tensors' bytes in
    one all-gather (collective over `tp`: every rank calls it)."""
    from qlora_tpu_torch.train.optimizer import tree_leaves, tree_unflatten

    leaves = tree_leaves(tree)
    dims = spec_leaves(tree, specs)
    split = [j for j, d in enumerate(dims) if d is not None]
    if not split or tp.size == 1:
        return tree
    raw = [leaves[j].detach().to(tp.device).contiguous().view(torch.uint8).reshape(-1)
           for j in split]
    whole = tp.all_gather(torch.cat(raw), dim=0).reshape(tp.size, -1)
    out, at = list(leaves), 0
    for j, r in zip(split, raw):
        t = leaves[j]
        parts = whole[:, at:at + r.numel()].contiguous().view(t.dtype).reshape(tp.size, *t.shape)
        out[j] = torch.cat(list(parts.unbind(0)), dim=dims[j]).to(t.device)
        at += r.numel()
    return tree_unflatten(tree, out)


def make_megatron_train_step(cfg, lcfg, optimizer, mesh, accum_steps: int = 1,
                             clip_norm=0.3, remat="save_linear"):
    """Returns ``train_step(state, frozen, batch, generator=None) -> (state,
    metrics)`` for this rank of a (dp, tp) mesh (fsdp 1), the JAX package's
    Megatron step: head-parallel attention, row-parallel output projections
    over K-sharded storage, two all-reduces a block.

    `frozen` is this rank's shard (:func:`shard_params` of a tree whose
    row-parallel linears are re-packed by :func:`requantize_row_parallel`),
    the state from :func:`init_megatron_state`.  `batch` is the global
    batch; data rank d takes its B/dp rows.  The gradients are JAX's: the
    tp-sharded leaves (column linears' B, row linears' A) are exact on
    their rank and all-reduced over dp; the replicated halves (column A,
    row B) see only this rank's partial path and are all-reduced over dp
    and tp.  The global norm sums the sharded leaves' squares over tp;
    `clip_norm` clips with it before the optimizer, whose own clip, on the
    rank's shard, then does nothing."""
    from qlora_tpu_torch.models.layers import tp_shard_context
    from qlora_tpu_torch.parallel.sharded_step import _all_reduce_flat, _rows, local_grads
    from qlora_tpu_torch.train.optimizer import apply_updates, tree_map, tree_unflatten
    from qlora_tpu_torch.train.step import TrainState

    if mesh.shape["fsdp"] != 1:
        raise ValueError("tp_style=megatron requires mesh_fsdp=1 (compose fsdp via "
                         "tp_style=gather)")
    T = mesh.shape["tp"]
    if cfg.num_heads % T or cfg.num_kv_heads % T:
        raise ValueError(f"heads ({cfg.num_heads}/{cfg.num_kv_heads}) must divide tp={T}")

    def ctx():
        return tp_shard_context(mesh.tp, None, "megatron")

    def train_step(state, frozen, batch, generator=None):
        rows = _rows(batch, mesh.dp.rank, mesh.shape["dp"], accum_steps)
        g_local, loss = local_grads(cfg, lcfg, state.trainable, frozen, rows, accum_steps,
                                    mesh.dp, remat, generator, ctx)
        sharded = [s is not None for s in spec_leaves(state.trainable,
                                                       megatron_lora_specs(state.trainable))]
        sh = _all_reduce_flat([g for g, s in zip(g_local, sharded) if s], mesh.dp)
        rep = _all_reduce_flat([g for g, s in zip(g_local, sharded) if not s], mesh.world)
        it_sh, it_rep = iter(sh), iter(rep)
        g_leaves = [next(it_sh) if s else next(it_rep) for s in sharded]
        with torch.no_grad():
            sq = lambda gs: torch.stack([g.square().sum() for g in gs]).sum() if gs \
                else torch.zeros((), device=mesh.device)
            gnorm = torch.sqrt(mesh.tp.all_reduce(sq(sh)) + sq(rep))
            if clip_norm is not None:
                scale = clip_norm / torch.clamp(gnorm, min=clip_norm)
                g_leaves = [g * scale for g in g_leaves]
            grads = tree_unflatten(state.trainable, g_leaves)
            params = tree_map(lambda p: p.detach(), state.trainable)
            updates, opt_state = optimizer.update(grads, state.opt_state, params)
            del grads
            new = TrainState(step=state.step + 1, trainable=apply_updates(params, updates),
                             opt_state=opt_state)
        return new, {"loss": loss, "grad_norm": gnorm}

    return train_step
