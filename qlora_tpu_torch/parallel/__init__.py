"""Parallelism over several ranks: one process a rank under
``torch.distributed``.

* Serving (ROADMAP A7a): the Megatron partition rules over K-sharded NF4
  storage (``megatron_step``), the tensor-parallel forward and caches
  (``tp_decode``), which ``PagedBatcher(tp_mesh=...)`` serves through.
* Training (ROADMAP A7b): the dp×fsdp×tp step with fsdp weight gathering
  and ZeRO-1 optimizer state (``sharded_step``, ``tp_step``), the Megatron
  train step (``megatron_step``) and the sequence-parallel step over ring
  attention (``sp_step``, ``ops/ring_attention.py``), over a mesh of named
  axes (``distributed.make_parallel_mesh``).  GSPMD full finetuning and the
  multi-host ``initialize`` wait for A7b's items 2 and 3.
"""

from .distributed import (
    ParallelMesh, ProcessInfo, TPMesh, destroy_process_group, global_batch_from_local,
    init_process_group, initialize, make_global_mesh, make_parallel_mesh, mesh_coords,
    process_info, run_ranks,
)
from .gspmd_step import (
    cut_state, gather_tree, make_gspmd_eval_step, make_gspmd_train_step,
)
from .mesh import MODEL_AXES, MeshAxes
from .megatron_step import (
    ROW_PARALLEL,
    gather_megatron_tree,
    init_megatron_state,
    make_megatron_train_step,
    megatron_lora_specs,
    megatron_param_specs,
    requantize_row_parallel,
    shard_params,
    shard_tree,
    tree_to,
)
from .sharded_step import (
    Zero1Layout,
    full_opt_state,
    init_sharded_train_state,
    init_zero1_opt_state,
    make_sharded_eval_step,
    make_sharded_train_step,
    opt_state_full_to_zero1,
    opt_state_zero1_to_full,
    shard_sharded_params,
    sharded_param_specs,
    zero1_chunk,
    zero1_gather,
)
from .sp_step import make_sp_train_step
from .tp_step import make_tp_train_step, tp_param_specs
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
    "ParallelMesh", "ProcessInfo", "TPMesh", "destroy_process_group",
    "global_batch_from_local", "init_process_group", "initialize", "make_global_mesh",
    "make_parallel_mesh", "mesh_coords", "process_info", "run_ranks",
    "cut_state", "gather_tree", "make_gspmd_eval_step",
    "make_gspmd_train_step", "MODEL_AXES", "MeshAxes",
    "ROW_PARALLEL", "gather_megatron_tree", "init_megatron_state", "make_megatron_train_step",
    "megatron_lora_specs",
    "megatron_param_specs", "requantize_row_parallel", "shard_params", "shard_tree",
    "tree_to",
    "Zero1Layout", "full_opt_state", "init_sharded_train_state", "init_zero1_opt_state",
    "make_sharded_eval_step", "make_sharded_train_step", "opt_state_full_to_zero1",
    "opt_state_zero1_to_full", "shard_sharded_params", "sharded_param_specs", "zero1_chunk",
    "zero1_gather",
    "make_sp_train_step",
    "make_tp_train_step", "tp_param_specs",
    "CACHE_SPECS", "PAGED_CACHE_SPECS", "SHARD_KEY", "cut_rank_shards", "make_tp_forward_fn",
    "make_tp_mesh",
    "rank_shards", "shard_decode_params", "shard_lora", "shard_paged_cache", "shard_tp_cache",
]
