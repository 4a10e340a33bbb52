"""On-disk format for quantized (or dense) model trees: ``model.npz`` plus
``qlora_tpu_config.json``, in the JAX package's layout, so that a store
written by either package loads in the other byte for byte.

``model.npz`` holds the params in JAX's stacked keys
(``utils/checkpoint.save_pytree``): ``blocks/<linear>/qt/{packed, absmax,
absmax_scale, absmax_offset}`` ``[L, ...]`` (the last two absent under f32
absmax) or ``blocks/<linear>/w``, ``bias`` leaves where the config has them,
the block norms, ``embed``, ``final_norm/...`` and ``lm_head/...``.  The json
holds ``format_version`` 1, the ``ModelConfig`` as a dict and ``quantized``;
the port adds ``quant_type``, which JAX's loader ignores.

:func:`load_quantized` reads the layout from the file: a linear is quantized
where ``qt/packed`` is stored, int8 codes by their dtype, the block size by
the absmax's rows, and a 4-bit code by ``quant_type`` (NF4 where a JAX-written
store does not say).
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

from qlora_tpu_torch import resolve_device
from qlora_tpu_torch.models.config import ModelConfig
from qlora_tpu_torch.models.layers import QLinear
from qlora_tpu_torch.utils.checkpoint import read_arrays, save_pytree
from qlora_tpu_torch.utils.convert import params_from_numpy

FORMAT_VERSION = 1
CONFIG_FILE = "qlora_tpu_config.json"
MODEL_FILE = "model.npz"


def save_quantized(path: str, params: dict, cfg: ModelConfig) -> None:
    os.makedirs(path, exist_ok=True)
    quantized = [v.qt for v in params["blocks"][0].values() if isinstance(v, QLinear)]
    meta = {
        "format_version": FORMAT_VERSION,
        "config": dataclasses.asdict(cfg),
        "quantized": bool(quantized),
    }
    if quantized:
        meta["quant_type"] = quantized[0].quant_type
    with open(os.path.join(path, CONFIG_FILE), "w") as f:
        json.dump(meta, f, indent=2)
    save_pytree(os.path.join(path, MODEL_FILE), params)


def _nest(arrays: dict) -> dict:
    """{"a/b/c": x} → {"a": {"b": {"c": x}}}."""
    tree: dict = {}
    for key, v in arrays.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def load_quantized(path: str, device=None):
    """Returns (params, cfg) from a directory written by either package's
    ``save_quantized``, the params on `device` (CUDA unless the caller names
    one)."""
    device = resolve_device(device)
    with open(os.path.join(path, CONFIG_FILE)) as f:
        meta = json.load(f)
    if meta["format_version"] != FORMAT_VERSION:
        raise ValueError(f"unsupported format version {meta['format_version']}")
    cfg = ModelConfig(**meta["config"])
    tree = _nest(read_arrays(os.path.join(path, MODEL_FILE)))
    for lin in tree["blocks"].values():
        qt = lin.get("qt") if isinstance(lin, dict) else None
        if qt is None:
            continue
        packed = qt["packed"]                            # [L, K/2 or K, N]
        int8 = packed.dtype == torch.int8
        K = packed.shape[1] * (1 if int8 else 2)
        qt.update(shape=(K, packed.shape[2]), block_size=K // qt["absmax"].shape[1],
                  quant_type="int8" if int8 else meta.get("quant_type", "nf4"))
    if "lm_head" not in tree:                            # tied, and no copy stored
        tree["lm_head"] = {"w": tree["embed"].T.contiguous()}
    return params_from_numpy(tree, cfg, device), cfg
