"""Masked causal-LM cross-entropy.

Labels equal to ``IGNORE_INDEX`` (-100: the collator's source tokens and
padding) contribute nothing; the loss is the mean over the other positions.
"""

from __future__ import annotations

import torch

IGNORE_INDEX = -100


def causal_shift(ids: torch.Tensor, labels: torch.Tensor):
    """Next-token prediction alignment: logits[t] predicts labels[t+1]."""
    return ids[:, :-1], labels[:, 1:]


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    """Mean CE over positions where labels != IGNORE_INDEX.

    logits [B, S, V] (any float dtype; computed in f32), labels [B, S] int.
    Returns (loss, n_valid): a 0-dim f32 tensor and a 0-dim int64 tensor.
    With every label ignored the loss is 0, not NaN."""
    logits = logits.float()
    mask = labels != IGNORE_INDEX
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - ll) * mask
    n = mask.sum()
    return nll.sum() / n.clamp(min=1), n
