"""Adapter checkpoints with optimizer-state resume, in the JAX package's
files, so that a checkpoint written by either package loads in the other.

Layout (kept exactly):
* ``checkpoint-N/adapter_model/adapter_weights.npz``: the adapters;
* ``checkpoint-N/optimizer_state.npz``: the optimizer state;
* ``checkpoint-N/trainer_state.json``: ``step``, any ``meta`` keys and the
  optional ``data_state`` (the data iterator's position);
* ``output_dir/completed``: the sentinel a finished run touches.

An ``.npz`` holds a tree flattened to path keys (``a/b/c``) in the JAX
package's layout.  The port keeps layers as Python lists where JAX stacks
them along a leading axis, so a list of per-layer dicts (a LoRA tree,
``params["blocks"]``, the moments over them) is written stacked, ``[L, ...]``
under one key, and read back layer by layer.  bfloat16 leaves are stored as
their uint16 bit patterns under ``<key>__bf16`` (npz has no bfloat16).  The
optimizer states take optax's keys: ``adamw``'s ``{"count", "mu", "nu"}`` is
``1/0/count``, ``1/0/mu/...``, ``1/0/nu/...`` and ``1/2/count`` (the
schedule's count) of the chain clip → AdamW; ``adam8bit``'s is ``count``,
``m_q/...``, ``m_s/...``, ``sv_q/...`` and ``sv_s/...``, each leaf's codes
flattened.

The 8-bit state: JAX quantizes each *stacked* leaf in blocks of 256 along
its flattened ``[L, ...]``, the port each layer's leaf on its own.  Where a
layer's leaf holds a multiple of 256 values the blocks line up and the state
is the same numbers in both: it is written and read in JAX's keys, exactly.
Where it does not, the port writes that leaf layer by layer under
``<key>__layer<i>`` (JAX's loader finds no ``<key>`` and raises), and loading
such a leaf of JAX's raises a ``ValueError`` naming the optimizer: neither
package ever loads wrong values.

Loading casts each leaf to the dtype of the tree it is given and puts it on
that leaf's device (pinned again where the leaf was pinned: a host-offloaded
state stays on the host), as JAX's ``load_pytree`` casts to its skeleton's.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Optional

import numpy as np
import torch

from qlora_tpu_torch.train.optimizer import STATE_BLOCK, _is_dataclass, tree_leaves

CHECKPOINT_PREFIX = "checkpoint-"
ADAPTER_DIR = "adapter_model"
COMPLETED_SENTINEL = "completed"
BF16_SUFFIX = "__bf16"
LAYER_SUFFIX = "__layer"

_ADAMW = frozenset(("count", "mu", "nu"))
_ADAM8 = frozenset(("count", "m_q", "m_s", "sv_q", "sv_s"))
_ADAM8_PARTS = ("m_q", "m_s", "sv_q", "sv_s")
_ADAM8_NAME = "adam8bit / paged_adamw_8bit"


def _join(prefix: str, key) -> str:
    return f"{prefix}/{key}" if prefix else str(key)


def _is_layers(tree) -> bool:
    """A per-layer list (LoRA, ``params["blocks"]``): stacked in JAX's layout."""
    return isinstance(tree, (list, tuple)) and bool(tree) and all(
        isinstance(x, dict) for x in tree)


def _fields(tree):
    """A dataclass's fields that hold tensors (a QuantizedTensor's shape,
    block size and code name are not leaves, nor is a None bias)."""
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        if tree_leaves(v):
            yield f.name, v


# ---------------------------------------------------------------------------
# writing: a port tree → {JAX key: tensor, or a list of per-layer tensors}
# ---------------------------------------------------------------------------


def _named(tree, prefix: str, params):
    """(key, tensor or list of per-layer tensors) in JAX's layout and order."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif _is_dataclass(tree):
        for name, v in _fields(tree):
            yield from _named(v, _join(prefix, name), params)
    elif isinstance(tree, dict) and frozenset(tree) == _ADAMW:
        count = torch.tensor(tree["count"], dtype=torch.int32)
        yield _join(prefix, "1/0/count"), count
        yield from _named(tree["mu"], _join(prefix, "1/0/mu"), params)
        yield from _named(tree["nu"], _join(prefix, "1/0/nu"), params)
        yield _join(prefix, "1/2/count"), count
    elif isinstance(tree, dict) and frozenset(tree) == _ADAM8:
        yield from _named_adam8(tree, prefix, params)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], _join(prefix, k), params)
    elif _is_layers(tree):
        per = [dict(_named(layer, "", params)) for layer in tree]
        for k in per[0]:
            yield _join(prefix, k), [p[k] for p in per]
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named(v, _join(prefix, i), params)
    elif tree is not None:
        raise TypeError(f"cannot save a {type(tree).__name__} at {prefix!r}")


def _leaf_keys(tree, prefix: str = "", layer=None) -> list:
    """(JAX key, layer index or None) of each tensor of `tree`, in the order
    of ``train.optimizer.tree_leaves`` (the order of an 8-bit state's lists)."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, layer)]
    if _is_dataclass(tree):
        return [kl for f in dataclasses.fields(tree)
                for kl in _leaf_keys(getattr(tree, f.name), _join(prefix, f.name), layer)]
    if isinstance(tree, dict):
        return [kl for k, v in tree.items() for kl in _leaf_keys(v, _join(prefix, k), layer)]
    if _is_layers(tree):
        return [kl for i, v in enumerate(tree) for kl in _leaf_keys(v, prefix, i)]
    if isinstance(tree, (list, tuple)):
        return [kl for i, v in enumerate(tree) for kl in _leaf_keys(v, _join(prefix, i), layer)]
    return []


def _adam8_groups(params) -> dict:
    """JAX key → [(index in the state's lists, layer or None), ...]."""
    if params is None:
        raise ValueError(f"an {_ADAM8_NAME} state names its leaves after the trainable "
                         "tree: pass it as `params`")
    groups: dict = {}
    for j, (key, layer) in enumerate(_leaf_keys(params)):
        groups.setdefault(key, []).append((j, layer))
    return groups


def _lines_up(numel: int, n_layers: int) -> bool:
    """A stacked leaf's blocks of 256 are its layers' blocks."""
    return n_layers == 1 or numel % STATE_BLOCK == 0


def _named_adam8(state, prefix, params):
    groups = _adam8_groups(params)
    yield _join(prefix, "count"), torch.tensor(state["count"], dtype=torch.int32)
    for part in _ADAM8_PARTS:
        for key in sorted(groups):
            members = groups[key]
            if _lines_up(state["m_q"][members[0][0]].numel(), len(members)):
                yield _join(prefix, f"{part}/{key}"), torch.cat(
                    [state[part][j].detach().cpu() for j, _ in members])
            else:
                for j, layer in members:
                    yield _join(prefix, f"{part}/{key}{LAYER_SUFFIX}{layer}"), state[part][j]


def _numpy(t: torch.Tensor):
    """(array, is_bf16): bfloat16 as its uint16 bit patterns."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), True
    return t.numpy(), False


def save_pytree(path: str, tree: Any, params: Any = None) -> None:
    """Save a tree of tensors (LoRA, params, an optimizer state) as a
    path-keyed npz in the JAX package's layout.  ``params`` is the trainable
    tree an 8-bit optimizer state belongs to (it names the state's leaves)."""
    arrays = {}
    for key, v in _named(tree, "", params):
        t = torch.stack([x.detach().cpu() for x in v]) if isinstance(v, list) else v
        a, bf16 = _numpy(t)
        arrays[key + BF16_SUFFIX if bf16 else key] = a
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **arrays)


# ---------------------------------------------------------------------------
# reading: {JAX key: array} → a tree shaped as `like`
# ---------------------------------------------------------------------------


def read_arrays(path: str) -> dict:
    """Every array of an npz written by either package, as CPU tensors
    (``__bf16`` keys back to bfloat16 under their plain key)."""
    out = {}
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        for key in data.files:
            a = data[key]
            if key.endswith(BF16_SUFFIX):
                out[key[: -len(BF16_SUFFIX)]] = torch.from_numpy(
                    a.view(np.int16)).view(torch.bfloat16)
            else:
                out[key] = torch.from_numpy(a)
    return out


def _get(arrays: dict, key: str) -> torch.Tensor:
    if key not in arrays:
        raise KeyError(f"checkpoint missing leaf {key!r}")
    return arrays[key]


def _place(t: torch.Tensor, like: torch.Tensor, key: str) -> torch.Tensor:
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"leaf {key!r}: stored shape {tuple(t.shape)}, expected "
                         f"{tuple(like.shape)}")
    out = t.to(device=like.device, dtype=like.dtype, copy=True)
    return out.pin_memory() if like.is_pinned() and not out.is_pinned() else out


def _fill(like, arrays: dict, prefix: str, layer, params):
    if isinstance(like, torch.Tensor):
        t = _get(arrays, prefix)
        return _place(t if layer is None else t[layer], like, prefix)
    if _is_dataclass(like):
        return dataclasses.replace(like, **{
            name: _fill(v, arrays, _join(prefix, name), layer, params)
            for name, v in _fields(like)})
    if isinstance(like, dict) and frozenset(like) == _ADAMW:
        return {"count": int(_get(arrays, _join(prefix, "1/0/count"))),
                "mu": _fill(like["mu"], arrays, _join(prefix, "1/0/mu"), layer, params),
                "nu": _fill(like["nu"], arrays, _join(prefix, "1/0/nu"), layer, params)}
    if isinstance(like, dict) and frozenset(like) == _ADAM8:
        return _fill_adam8(like, arrays, prefix, params)
    if isinstance(like, dict):
        return {k: _fill(v, arrays, _join(prefix, k), layer, params) for k, v in like.items()}
    if _is_layers(like):
        return type(like)(_fill(v, arrays, prefix, i, params) for i, v in enumerate(like))
    if isinstance(like, (list, tuple)):
        return type(like)(_fill(v, arrays, _join(prefix, i), layer, params)
                          for i, v in enumerate(like))
    return like


def _fill_adam8(like, arrays, prefix, params):
    out = {"count": int(_get(arrays, _join(prefix, "count")))}
    for part in _ADAM8_PARTS:
        out[part] = list(like[part])
    for key, members in _adam8_groups(params).items():
        for j, layer in members:
            for part in _ADAM8_PARTS:
                k = _join(prefix, f"{part}/{key}")
                if f"{k}{LAYER_SUFFIX}{layer}" in arrays:        # the port's, per layer
                    k = f"{k}{LAYER_SUFFIX}{layer}"
                    t = arrays[k]
                elif layer is None:
                    t = _get(arrays, k)
                else:
                    n = like[part][j].numel()
                    if not _lines_up(like["m_q"][j].numel(), len(members)):
                        raise ValueError(
                            f"{_ADAM8_NAME} state: {k!r} was quantized in blocks of "
                            f"{STATE_BLOCK} across its {len(members)} layers, and a layer "
                            f"holds {like['m_q'][j].numel()} values, no multiple of "
                            f"{STATE_BLOCK}: the port's per-layer blocks cannot carry it "
                            "(start the optimizer afresh, or resume with the package that "
                            "wrote it)")
                    t = _get(arrays, k)[layer * n:(layer + 1) * n]
                out[part][j] = _place(t, like[part][j], k)
    return out


def load_pytree(path: str, like: Any, params: Any = None) -> Any:
    """Load arrays saved by either package's ``save_pytree`` into the
    structure of `like`, each leaf cast to its dtype and put on its device.
    ``params``: as in :func:`save_pytree`."""
    return _fill(like, read_arrays(path), "", None, params)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def save_checkpoint(
    output_dir: str,
    step: int,
    lora: Any,
    opt_state: Any = None,
    meta: Optional[dict] = None,
    data_state: Optional[dict] = None,
) -> str:
    """Write ``checkpoint-<step>`` under `output_dir`; returns its path."""
    ckpt = os.path.join(output_dir, f"{CHECKPOINT_PREFIX}{step}")
    adapter = os.path.join(ckpt, ADAPTER_DIR)
    os.makedirs(adapter, exist_ok=True)
    save_pytree(os.path.join(adapter, "adapter_weights.npz"), lora)
    if opt_state is not None:
        save_pytree(os.path.join(ckpt, "optimizer_state.npz"), opt_state, params=lora)
    info = {"step": step}
    if meta:
        info.update(meta)
    if data_state is not None:
        info["data_state"] = data_state
    with open(os.path.join(ckpt, "trainer_state.json"), "w") as f:
        json.dump(info, f, indent=2)
    return ckpt


def load_checkpoint(ckpt_dir: str, lora_like: Any, opt_state_like: Any = None):
    """Returns (lora, opt_state or None, trainer_state dict), each tensor on
    the device of its counterpart in the trees given."""
    lora = load_pytree(os.path.join(ckpt_dir, ADAPTER_DIR, "adapter_weights.npz"), lora_like)
    opt_state = None
    opt_path = os.path.join(ckpt_dir, "optimizer_state.npz")
    if opt_state_like is not None and os.path.exists(opt_path):
        opt_state = load_pytree(opt_path, opt_state_like, params=lora_like)
    state_path = os.path.join(ckpt_dir, "trainer_state.json")
    info = {}
    if os.path.exists(state_path):
        with open(state_path) as f:
            info = json.load(f)
    return lora, opt_state, info


def get_last_checkpoint(output_dir: str):
    """(checkpoint_dir or None, is_completed): the highest ``checkpoint-N``."""
    if not os.path.isdir(output_dir):
        return None, False
    if os.path.exists(os.path.join(output_dir, COMPLETED_SENTINEL)):
        return None, True
    best, best_step = None, -1
    for name in os.listdir(output_dir):
        m = re.fullmatch(rf"{CHECKPOINT_PREFIX}(\d+)", name)
        if m and int(m.group(1)) > best_step:
            best, best_step = os.path.join(output_dir, name), int(m.group(1))
    return best, False


def mark_completed(output_dir: str) -> None:
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, COMPLETED_SENTINEL), "a"):
        pass
