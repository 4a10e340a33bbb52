"""Optimizers: AdamW with the reference's hyperparameters, and 8-bit state.

An optimizer is a pair ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)`` over trees of tensors
(nested lists, tuples, dicts and dataclasses: the LoRA adapters, or a whole
model's parameters in full finetuning), in the manner of the optax chains
the JAX package builds, so that the two can be held against each other step
by step.  State tensors live on their parameter's device; the step count
and the learning rate are Python numbers.  ``adamw`` updates its moments in
place, leaf by leaf: the state handed to ``update`` is consumed, as the JAX
train step donates it, and a step holds one leaf's temporaries at a time.

* ``adamw``: clip the gradients to a global norm (0.3), then AdamW.
* ``adam8bit``: AdamW whose m and sqrt(v) are stored as int8 in blocks of
  256 with one f32 absmax scale each (sqrt(v) halves the relative error of
  linear int8 on the second moment's wide range).
* ``host_offload``: the "paged" optimizer made explicit: the state rests in
  pinned host memory between steps and is on the card only inside the
  update.
* Schedule: linear warmup from 0 over ``warmup_ratio`` of the steps, then
  constant.  It is read at the count *before* the increment, so the first
  step's learning rate is 0, as optax's is.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

STATE_BLOCK = 256


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


# ---------------------------------------------------------------------------
# trees of tensors
# ---------------------------------------------------------------------------


def _is_dataclass(tree) -> bool:
    return dataclasses.is_dataclass(tree) and not isinstance(tree, type)


def tree_leaves(tree) -> list:
    """The tensors of a tree, dicts in insertion order, dataclasses in the
    order of their fields."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if _is_dataclass(tree):
        return [t for f in dataclasses.fields(tree) for t in tree_leaves(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return []


def tree_map(fn, tree, *rest):
    """`fn` over the tensors of `tree` (and of trees of the same shape);
    anything that is not a tensor or a container is kept as it is."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if _is_dataclass(tree):
        return type(tree)(**{f.name: tree_map(fn, getattr(tree, f.name),
                                              *(getattr(r, f.name) for r in rest))
                             for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return tree


def tree_unflatten(like, leaves):
    """A tree shaped as `like` whose tensors are `leaves`, in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ g²) over every tensor of the tree, in f32 (0-dim)."""
    leaves = tree_leaves(tree)
    return torch.stack([g.float().square().sum() for g in leaves]).sum().sqrt()


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


# ---------------------------------------------------------------------------
# schedule, AdamW
# ---------------------------------------------------------------------------


def warmup_constant_schedule(lr: float, total_steps: int, warmup_ratio: float = 0.03):
    """count -> learning rate: 0 → lr linearly over the warmup, then lr."""
    warmup = max(1, int(total_steps * warmup_ratio))

    def schedule(count: int) -> float:
        if count >= warmup:
            return lr
        return lr * (count / warmup)

    return schedule


def _schedule(lr):
    return lr if callable(lr) else (lambda _: lr)


def adamw(lr, *, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0, max_grad_norm: float = 0.3) -> Optimizer:
    """The reference's chain: clip by global norm (scale by
    ``max_norm / max(norm, max_norm)``), then AdamW with the update
    ``-lr (m̂ / (sqrt(v̂) + eps) + weight_decay p)``."""
    schedule = _schedule(lr)

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"count": 0, "mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}

    def update(grads, state, params):
        step_lr = schedule(state["count"])
        count = state["count"] + 1
        norm = global_norm(grads)
        clip = max_grad_norm / torch.clamp(norm, min=max_grad_norm)
        bc1, bc2 = 1 - b1 ** count, 1 - b2 ** count
        updates = []
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["mu"]),
                              tree_leaves(state["nu"]), tree_leaves(params)):
            g = g.float() * clip
            torch.add(b1 * m, (1 - b1) * g, out=m)          # in place: the state is consumed
            torch.add(b2 * v, (1 - b2) * g * g, out=v)
            updates.append(-step_lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps)
                                       + weight_decay * p.float()))
        return tree_unflatten(grads, updates), {"count": count, "mu": state["mu"],
                                                "nu": state["nu"]}

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# 8-bit blockwise optimizer state
# ---------------------------------------------------------------------------


def _q8(x: torch.Tensor):
    """Blockwise int8 quantize of a flat f32 tensor (block 256):
    (q int8 [n], scale f32 [ceil(n / 256)])."""
    n = x.shape[0]
    xp = torch.nn.functional.pad(x, (0, (-n) % STATE_BLOCK)).reshape(-1, STATE_BLOCK)
    scale = xp.abs().amax(dim=1)
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(xp / safe[:, None] * 127.0), -127, 127).to(torch.int8)
    return q.reshape(-1)[:n], scale


def _dq8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    n = q.shape[0]
    qp = torch.nn.functional.pad(q, (0, (-n) % STATE_BLOCK)).reshape(-1, STATE_BLOCK).float()
    return (qp * (scale[:, None] / 127.0)).reshape(-1)[:n]


def adam8bit(lr, *, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
             weight_decay: float = 0.0, max_grad_norm: float = 0.3) -> Optimizer:
    """AdamW whose m and sqrt(v) rest in blockwise int8: dequantize, update,
    requantize on every step.  Its clip is ``min(1, max_norm / (norm + 1e-12))``."""
    schedule = _schedule(lr)

    def init(params):
        leaves = tree_leaves(params)
        zeros = lambda: [_q8(torch.zeros(p.numel(), dtype=torch.float32, device=p.device))
                         for p in leaves]
        # m and sqrt(v) get buffers of their own; each a list over the leaves
        m, sv = zeros(), zeros()
        return {"count": 0, "m_q": [q for q, _ in m], "m_s": [s for _, s in m],
                "sv_q": [q for q, _ in sv], "sv_s": [s for _, s in sv]}

    def update(grads, state, params):
        step_lr = schedule(state["count"])
        count = state["count"] + 1
        clip = torch.clamp(max_grad_norm / (global_norm(grads) + 1e-12), max=1.0)
        bc1, bc2 = 1 - b1 ** count, 1 - b2 ** count
        ups = []
        new = {"count": count, "m_q": [], "m_s": [], "sv_q": [], "sv_s": []}
        for g, p, mq, ms, svq, svs in zip(tree_leaves(grads), tree_leaves(params),
                                          state["m_q"], state["m_s"], state["sv_q"],
                                          state["sv_s"]):
            gf = g.reshape(-1).float() * clip
            sv = _dq8(svq, svs)
            m = b1 * _dq8(mq, ms) + (1 - b1) * gf
            v = b2 * (sv * sv) + (1 - b2) * gf * gf
            upd = -step_lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps)
                              + weight_decay * p.reshape(-1).float())
            ups.append(upd.reshape(g.shape).to(p.dtype))
            for key, t in zip(("m_q", "m_s", "sv_q", "sv_s"), (*_q8(m), *_q8(torch.sqrt(v)))):
                new[key].append(t)
        return tree_unflatten(grads, ups), new

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# host-offloaded ("paged") optimizer state
# ---------------------------------------------------------------------------


def host_offload(inner: Optimizer) -> Optimizer:
    """Keep `inner`'s state in host memory between steps (pinned when a
    CUDA device is present, so the copies can overlap) and on the
    gradients' device only inside the update.  Between steps the card
    holds no optimizer state; the step's high-water mark adds one
    transient copy of it.  The updates are those of `inner`."""

    def to_host(t):
        t = t.to("cpu")
        return t.pin_memory() if torch.cuda.is_available() and not t.is_pinned() else t

    def init(params):
        return tree_map(to_host, inner.init(params))

    def update(grads, state, params):
        dev = tree_leaves(grads)[0].device
        on_dev = tree_map(lambda t: t.to(dev, non_blocking=True), state)
        updates, new_state = inner.update(grads, on_dev, params)
        return updates, tree_map(to_host, new_state)

    return Optimizer(init, update)


def make_optimizer(name: str, lr, total_steps: int, *, warmup_ratio: float = 0.03,
                   weight_decay: float = 0.0, max_grad_norm: float = 0.3,
                   b2: float = 0.999, offload_state: bool = False) -> Optimizer:
    """By the reference's flag names: ``paged_adamw_32bit`` / ``adamw`` /
    ``adamw_torch``, or ``adam8bit`` / ``paged_adamw_8bit``.
    ``offload_state`` rests the state in host memory between steps."""
    sched = warmup_constant_schedule(lr, total_steps, warmup_ratio)
    if name in ("paged_adamw_32bit", "adamw", "adamw_torch"):
        opt = adamw(sched, weight_decay=weight_decay, max_grad_norm=max_grad_norm, b2=b2)
    elif name in ("adam8bit", "paged_adamw_8bit"):
        opt = adam8bit(sched, weight_decay=weight_decay, max_grad_norm=max_grad_norm, b2=b2)
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    return host_offload(opt) if offload_state else opt
