"""Tensor-parallel serving: prefill and decode of a model too big for one
card, sharded Megatron-style over a tensor-parallel world.

The sharding is the training step's (``parallel/megatron_step.py``):
head-parallel attention and row-parallel output projections over K-sharded
NF4 storage, so a forward pays two all-reduces a block plus the embedding's
and the lm_head's gathers, and every quantized product runs its kernel on
the rank's own shard.  The KV cache splits over its heads: a rank's cache
memory is 1/tp of the whole.

Each rank is a process of its own (``parallel/distributed.py``) holding its
shard and running the same forward; the caller gives every rank the same
token ids.  A rank's shard is cut from the whole tree where that tree lives
(:func:`shard_decode_params`): a parent may cut every rank's shard and hand
each rank only its own, so that no rank holds the whole model.  Constraints: num_heads and num_kv_heads divide tp, and so do
the vocabulary (the lm_head's columns) and the hidden size.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from qlora_tpu_torch.lora import LoraConfig
from qlora_tpu_torch.models.config import ModelConfig
from qlora_tpu_torch.models.layers import tp_shard_context
from qlora_tpu_torch.parallel.distributed import TPMesh, init_process_group
from qlora_tpu_torch.parallel.megatron_step import (
    megatron_lora_specs, shard_params, shard_tree, tree_to,
)

# the split dimension of each entry of a contiguous cache (per layer
# [B, KVH, T, hd]: the heads) and of a paged one (per layer [n_pages, KVH,
# page, hd]); tables and lengths are whole on every rank
CACHE_SPECS = {"k": 1, "v": 1, "length": None}
PAGED_CACHE_SPECS = {"k_pages": 1, "v_pages": 1, "tables": None, "length": None}


def make_tp_mesh(tp: int, rank: int, *, backend: str, device, store_dir: str) -> TPMesh:
    """Join rank `rank` of a tensor-parallel world of `tp` ranks (the
    caller names the backend and the rank's device; the ranks meet through
    a ``FileStore`` in `store_dir`)."""
    return init_process_group(tp, rank, backend=backend, device=device, store_dir=store_dir)


# the key that marks a params tree as one rank's shard: (rank, size)
SHARD_KEY = "tp_shard"


def shard_decode_params(params: dict, mesh: TPMesh) -> dict:
    """Rank ``mesh.rank``'s shard of the whole params on ``mesh.device``
    (``megatron_step.shard_params``: each row-parallel linear the rank's
    K-chunk quantized alone), marked with :data:`SHARD_KEY`.  `mesh` needs
    only rank, size and device, so that a parent can cut the shard of a
    rank it has not started (:func:`cut_rank_shards`)."""
    shard = shard_params(params, mesh.rank, mesh.size, mesh.device)
    shard[SHARD_KEY] = (mesh.rank, mesh.size)
    return shard


def is_shard_of(params: dict, mesh: TPMesh) -> bool:
    """Whether `params` is this rank's shard already."""
    return params.get(SHARD_KEY) == (mesh.rank, mesh.size)


def shard_lora(lora: Optional[list], mesh: TPMesh) -> Optional[list]:
    """This rank's shard of a per-layer LoRA list."""
    if lora is None:
        return None
    return shard_tree(lora, megatron_lora_specs(lora), mesh.rank, mesh.size, mesh.device)


def rank_shards(params: dict, lora: Optional[list], mesh: TPMesh) -> tuple:
    """(params, lora) as this rank's shards on its device: taken as they
    are (moved there) when `params` carries this rank's shard mark, and
    `lora` is then its shard too; else cut from the whole trees."""
    if is_shard_of(params, mesh):
        return tree_to(params, mesh.device), tree_to(lora, mesh.device)
    return shard_decode_params(params, mesh), shard_lora(lora, mesh)


def cut_rank_shards(params: dict, lora: Optional[list], tp: int, device="cpu") -> list:
    """Every rank's (params, lora) shard, cut where the whole trees live and
    put on `device`: a parent's work, so that each rank is handed only its
    own (``run_ranks(per_rank=...)``) and never holds the whole model."""
    device = torch.device(device)
    views = [TPMesh(rank=r, size=tp, group=None, device=device, backend="") for r in range(tp)]
    return [(shard_decode_params(params, v), shard_lora(lora, v)) for v in views]


def shard_tp_cache(cache: dict, mesh: TPMesh) -> dict:
    """This rank's heads of a contiguous cache."""
    return shard_tree(cache, CACHE_SPECS, mesh.rank, mesh.size, mesh.device)


def shard_paged_cache(cache: dict, mesh: TPMesh) -> dict:
    """This rank's heads of a paged-pool cache dict."""
    return shard_tree(cache, PAGED_CACHE_SPECS, mesh.rank, mesh.size, mesh.device)


def check_tp_shapes(cfg: ModelConfig, tp: int) -> None:
    if cfg.num_heads % tp or cfg.num_kv_heads % tp:
        raise ValueError(f"heads ({cfg.num_heads}/{cfg.num_kv_heads}) must divide tp={tp}")


def make_tp_forward_fn(cfg: ModelConfig, lcfg: LoraConfig, mesh: TPMesh, paged: bool = False,
                       impl: Optional[str] = None):
    """``fn(params, lora, ids, cache) -> (logits, cache)`` on this rank's
    shards (from :func:`shard_decode_params`, :func:`shard_lora` and a
    sharded cache).

    Prefill (ids [B, S], positions from ``cache["length"]``) and decode
    (ids [B, 1]) alike, over the contiguous cache, or with ``paged=True``
    the paged one: S = 1 runs the paged decode kernel and S > 1 the paged
    chunk kernel (speculative verify) on the rank's local heads.
    ``impl="w8a8"`` runs the quantized products on the int8 kernels (the
    shard's linears requantized per column with
    ``generate/serve_int8.requantize_linear_int8``, as
    ``PagedBatcher(tp_mesh=..., decode_impl="int8")`` holds them).
    The logits are whole on every rank."""
    check_tp_shapes(cfg, mesh.size)
    from qlora_tpu_torch.models.transformer import forward
    from qlora_tpu_torch.ops import default_impl

    want = ("k_pages", "v_pages", "tables", "length") if paged else ("k", "v", "length")

    def fn(params, lora, ids, cache):
        if set(cache) != set(want):
            raise ValueError(f"a {'paged' if paged else 'contiguous'} cache has {want}, "
                             f"got {sorted(cache)}")
        ctx = default_impl(impl) if impl else contextlib.nullcontext()
        with tp_shard_context(mesh, style="megatron"), ctx:
            return forward(params, lora, ids.to(mesh.device), cfg, lcfg, cache=cache)

    return fn
