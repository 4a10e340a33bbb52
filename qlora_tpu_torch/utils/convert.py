"""Carry the JAX package's parameters into the port's layout.

The input is a nested dict of numpy arrays (the JAX tree with each leaf
passed through ``np.asarray``) or of CPU tensors (a file read by
``utils/checkpoint.read_arrays``): a ``QuantizedTensor`` as a dict of
``packed``, ``absmax``, ``absmax_scale``, ``absmax_offset`` plus its static
``shape``, ``block_size``, ``quant_type`` and ``k_shards`` (1 where absent;
a K-sharded tensor's offset is a vector, kept as it is); a ``QLinear`` as
``{"qt": ..., "bias": ...}``; a ``DenseLinear`` as ``{"w": ..., "bias": ...}``.
Block and LoRA leaves stacked over layers ``[L, ...]`` become per-layer
lists; ``lora_to_numpy`` goes the other way, so that an adapter trained
here can be set beside one trained there.  ``paged_cache_from_numpy``
carries a paged KV cache (per-layer page pools and the page tables) across.  Every byte is kept: bfloat16 arrays (numpy's ml_dtypes type) are
reinterpreted through their 16-bit pattern.
"""

from __future__ import annotations

import numpy as np
import torch

from qlora_tpu_torch.models.layers import DenseLinear, QLinear
from qlora_tpu_torch.quant.blockwise import QuantizedTensor


def to_tensor(a, device=None):
    """numpy array (any dtype, bfloat16 included) or tensor → a tensor of
    its own on `device`, bytes unchanged."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.to(device, copy=True)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _layer(a, i):
    if a is None:
        return None
    return a[i] if isinstance(a, torch.Tensor) else np.asarray(a)[i]


def _quantized(d: dict, i, device) -> QuantizedTensor:
    pick = (lambda a: a) if i is None else (lambda a: _layer(a, i))
    return QuantizedTensor(
        packed=to_tensor(pick(d["packed"]), device),
        absmax=to_tensor(pick(d["absmax"]), device),
        absmax_scale=to_tensor(pick(d.get("absmax_scale")), device),
        absmax_offset=to_tensor(pick(d.get("absmax_offset")), device),
        shape=tuple(d["shape"]), block_size=int(d["block_size"]),
        quant_type=str(d["quant_type"]), k_shards=int(d.get("k_shards", 1)))


def _linear(d: dict, i, device):
    pick = (lambda a: a) if i is None else (lambda a: _layer(a, i))
    bias = to_tensor(pick(d.get("bias")), device)
    if "qt" in d:
        return QLinear(qt=_quantized(d["qt"], i, device), bias=bias)
    return DenseLinear(w=to_tensor(pick(d["w"]), device), bias=bias)


def _block(tree, i, device):
    if isinstance(tree, dict):
        if "qt" in tree or "w" in tree:
            return _linear(tree, i, device)
        return {k: _block(v, i, device) for k, v in tree.items()}
    return to_tensor(tree if i is None else _layer(tree, i), device)


def params_from_numpy(tree: dict, cfg, device) -> dict:
    """The JAX params (as numpy) → the port's params on `device`."""
    blocks = tree["blocks"]
    if not isinstance(blocks, (list, tuple)):
        blocks = [_block(blocks, i, device) for i in range(cfg.num_layers)]
    else:
        blocks = [_block(b, None, device) for b in blocks]
    return {
        "embed": to_tensor(tree["embed"], device),
        "blocks": blocks,
        "final_norm": {k: to_tensor(v, device) for k, v in tree["final_norm"].items()},
        "lm_head": _linear(tree["lm_head"], None, device),
    }


def move_to(tree, device):
    """A params, LoRA or cache tree with every tensor moved to `device`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, QuantizedTensor):
        return tree.to(device)
    if isinstance(tree, QLinear):
        return QLinear(qt=tree.qt.to(device), bias=move_to(tree.bias, device))
    if isinstance(tree, DenseLinear):
        return DenseLinear(w=tree.w.to(device), bias=move_to(tree.bias, device))
    if isinstance(tree, dict):
        return {k: move_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(move_to(v, device) for v in tree)
    return tree


def lora_from_numpy(tree: dict, device) -> list:
    """Stacked LoRA {name: {"a": [L, K, r], "b": [L, r, N]}} → per-layer list."""
    L = next(iter(tree.values()))["a"].shape[0]
    return [{name: {k: to_tensor(np.asarray(ad[k])[i], device) for k in ("a", "b")}
             for name, ad in tree.items()} for i in range(L)]


def paged_cache_from_numpy(tree: dict, device) -> dict:
    """A JAX paged cache {"k_pages", "v_pages": per-layer [n_pages, KVH, page,
    hd] bf16, "tables": [B, pps], "length": [B]} (as numpy) → the port's,
    every pool byte kept."""
    return {"k_pages": [to_tensor(a, device) for a in tree["k_pages"]],
            "v_pages": [to_tensor(a, device) for a in tree["v_pages"]],
            "tables": to_tensor(np.asarray(tree["tables"], np.int32), device),
            "length": to_tensor(np.asarray(tree["length"], np.int32), device)}


def lora_to_numpy(lora: list) -> dict:
    """The reverse of :func:`lora_from_numpy`: a per-layer list of adapters
    → {name: {"a": [L, K, r], "b": [L, r, N]}} of f32 numpy arrays, the JAX
    package's stacked layout."""
    return {name: {k: np.stack([layer[name][k].detach().float().cpu().numpy()
                                for layer in lora]) for k in ("a", "b")}
            for name in lora[0]}
