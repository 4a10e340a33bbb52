"""Tensor parallelism: one process a rank under ``torch.distributed``.

The serving half (ROADMAP A7a): the Megatron partition rules over K-sharded
NF4 storage (``megatron_step``), the process group of a world on one host
(``distributed``) and the tensor-parallel forward and caches
(``tp_decode``), which ``PagedBatcher(tp_mesh=...)`` serves through.  The
training half (data parallelism, ZeRO-1, the Megatron train step, ring
attention) waits for ROADMAP A7b.
"""

from .distributed import TPMesh, destroy_process_group, init_process_group, run_ranks
from .megatron_step import (
    ROW_PARALLEL,
    make_megatron_train_step,
    megatron_lora_specs,
    megatron_param_specs,
    requantize_row_parallel,
    shard_params,
    shard_tree,
    tree_to,
)
from .tp_decode import (
    CACHE_SPECS,
    PAGED_CACHE_SPECS,
    SHARD_KEY,
    cut_rank_shards,
    make_tp_forward_fn,
    make_tp_mesh,
    rank_shards,
    shard_decode_params,
    shard_lora,
    shard_paged_cache,
    shard_tp_cache,
)

__all__ = [
    "TPMesh", "destroy_process_group", "init_process_group", "run_ranks",
    "ROW_PARALLEL", "make_megatron_train_step", "megatron_lora_specs",
    "megatron_param_specs", "requantize_row_parallel", "shard_params", "shard_tree",
    "tree_to",
    "CACHE_SPECS", "PAGED_CACHE_SPECS", "SHARD_KEY", "cut_rank_shards", "make_tp_forward_fn",
    "make_tp_mesh",
    "rank_shards", "shard_decode_params", "shard_lora", "shard_paged_cache", "shard_tp_cache",
]
