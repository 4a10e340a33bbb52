"""The QLoRA training and eval step: loss and gradients with respect to the
LoRA adapters only (or, with ``mode="full"``, every tensor of an unquantized
model), gradient accumulation over micro-batches, the optimizer update.

In ``mode="lora"`` the base model is frozen: its tensors do not require
gradients, the NF4 matmul gives its weight none, and the step never writes
to them.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from qlora_tpu_torch import resolve_device
from qlora_tpu_torch.lora import LoraConfig
from qlora_tpu_torch.models.config import ModelConfig
from qlora_tpu_torch.models.transformer import forward
from qlora_tpu_torch.train.loss import masked_cross_entropy
from qlora_tpu_torch.train.optimizer import (
    Optimizer, apply_updates, global_norm, tree_leaves, tree_map, tree_unflatten,
)


@dataclasses.dataclass
class TrainState:
    step: int
    trainable: Any            # the LoRA tree: a list over layers of {name: {"a", "b"}}, or
                              # in mode "full" the model's params (dense linears)
    opt_state: Any


def _check_mode(mode: str) -> None:
    if mode not in ("lora", "full"):
        raise ValueError(f"mode must be 'lora' or 'full', got {mode!r}")


def _on_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def loss_fn(trainable, frozen, batch, cfg, lcfg, generator=None, train=True, mode="lora",
            remat="full"):
    """Next-token loss of one micro-batch (tensors on the model's device):
    logits[:, t] predicts labels[:, t + 1].  Returns (loss, n_valid).  In
    mode "full" `trainable` is the whole model and `frozen` is ignored."""
    _check_mode(mode)
    params, lora = (frozen, trainable) if mode == "lora" else (trainable, None)
    logits, _ = forward(params, lora, batch["input_ids"], cfg, lcfg,
                        attn_mask=batch.get("attention_mask"),
                        generator=generator if train else None,
                        remat=remat if train else False)
    return masked_cross_entropy(logits[:, :-1], batch["labels"][:, 1:])


def sp_loss_fn(trainable, frozen, batch, cfg, lcfg, sp, generator=None, remat="full"):
    """The sequence-parallel variant of :func:`loss_fn` (LoRA): this rank's
    token-loss mean over its shard of the sequence, whose labels
    (``labels_shifted``, ``loss.shift_labels``) were shifted over the whole
    sequence before it was cut, so that the prediction at each shard's last
    position counts (a local shift would drop it).  Returns (loss, n_valid)
    of the shard; `sp` is the sequence axis' ``TPMesh``."""
    logits, _ = forward(frozen, trainable, batch["input_ids"], cfg, lcfg, generator=generator,
                        remat=remat, sp=sp)
    return masked_cross_entropy(logits, batch["labels_shifted"])


def make_train_step(cfg: ModelConfig, lcfg: LoraConfig, optimizer: Optimizer,
                    accum_steps: int = 1, mode: str = "lora", remat="save_linear",
                    device=None):
    """Returns ``train_step(state, frozen_params, batch, generator=None) ->
    (state, metrics)``, which runs on `device` (CUDA unless the caller names
    one; the state and the parameters must already be there).

    The batch's arrays (numpy or tensors) are [accum_steps, micro_bs, S]
    when ``accum_steps > 1``, else [bs, S].  Gradients are summed in f32
    over the micro-batches and divided by ``accum_steps``; the reported loss
    is Σ loss·n / max(Σ n, 1) over them.  ``metrics`` holds ``loss`` and
    ``grad_norm`` (of the gradients before clipping) as 0-dim tensors.
    ``generator`` feeds LoRA dropout when ``lcfg.dropout > 0``.

    ``mode``: "lora" trains the adapters over the frozen params; "full"
    trains every tensor of an unquantized model (``init_params(...,
    quantized=False)``: the embedding, the norms, each ``DenseLinear`` and
    the lm_head), ``state.trainable`` is that tree and ``frozen_params`` is
    ignored.  The state handed in is consumed (the optimizer updates its
    moments in place), as the JAX step donates it.

    ``remat``: ``"save_linear"`` (default, as JAX's) keeps each block
    linear's base matmul output and flash attention's output and recomputes
    the rest (``models/transformer.py: _check_remat``); ``"full"`` keeps only
    the layer boundaries and runs each block's forward again in the
    backward; False keeps everything.  Mode "full" runs "full" in place of
    "save_linear", as JAX does.  The gradients are the same under every
    policy."""
    _check_mode(mode)
    if mode == "full" and remat == "save_linear":
        remat = "full"
    device = resolve_device(device)

    def micro(leaves, like, frozen, mb, generator):
        trainable = tree_unflatten(like, leaves)
        loss, n = loss_fn(trainable, frozen, mb, cfg, lcfg, generator, True, mode, remat)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), n, grads

    def train_step(state: TrainState, frozen, batch, generator=None):
        batch = _on_device(batch, device)
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(state.trainable)]
        if accum_steps == 1:
            loss, _, grads = micro(leaves, state.trainable, frozen, batch, generator)
            grads = [g.float() for g in grads]
        else:
            # summed in place in f32: one micro-batch's gradients alive beside the sum
            grads = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
            loss_sum = torch.zeros((), dtype=torch.float32, device=device)
            n_sum = torch.zeros((), dtype=torch.int64, device=device)
            for i in range(accum_steps):
                mb = {k: v[i] for k, v in batch.items()}
                loss_i, n, g = micro(leaves, state.trainable, frozen, mb, generator)
                for a, b in zip(grads, g):
                    a.add_(b)
                del g
                loss_sum = loss_sum + loss_i * n
                n_sum = n_sum + n
            for g in grads:
                g.div_(accum_steps)
            loss = loss_sum / n_sum.clamp(min=1)
        grads = tree_unflatten(state.trainable, grads)
        with torch.no_grad():
            metrics = {"loss": loss, "grad_norm": global_norm(grads)}
            params = tree_map(lambda p: p.detach(), state.trainable)
            updates, opt_state = optimizer.update(grads, state.opt_state, params)
            del grads        # the f32 sum goes before the new parameters are made
            new_state = TrainState(step=state.step + 1,
                                   trainable=apply_updates(params, updates),
                                   opt_state=opt_state)
        return new_state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig, lcfg: LoraConfig, mode: str = "lora", device=None):
    """Returns ``eval_step(trainable, frozen, batch) -> (loss, n_valid)``:
    no dropout, no remat, no gradients (mode "full": `trainable` is the
    model, `frozen` ignored)."""
    _check_mode(mode)
    device = resolve_device(device)

    def eval_step(trainable, frozen, batch):
        with torch.no_grad():
            return loss_fn(trainable, frozen, _on_device(batch, device), cfg, lcfg,
                           None, False, mode)

    return eval_step


def init_train_state(trainable, optimizer: Optimizer, device=None) -> TrainState:
    """Step 0: the trainable tree moved to `device` (CUDA unless the caller
    names one) and the optimizer's state made there."""
    device = resolve_device(device)
    trainable = tree_map(lambda t: t.detach().to(device), trainable)
    return TrainState(step=0, trainable=trainable, opt_state=optimizer.init(trainable))
