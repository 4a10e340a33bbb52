"""Speculative acceptance for prompt-lookup drafts: the pieces the paged
serving engine's verify chunks need.

``_target_probs`` is the distribution ``sample_token`` draws from;
``accept_and_resample`` is speculative rejection sampling with a point-mass
draft distribution (Leviathan et al.), so the emitted sequence is
distributed as ancestral sampling from the target whatever the drafts are.
Random numbers come from an explicit ``torch.Generator``; they differ from
``jax.random``'s, so only the structure of the result carries across.  The
single-stream ``generate_speculative`` and ``generate_stream_speculative``
are not ported yet (ROADMAP queue A5).
"""

from __future__ import annotations

from typing import Optional

import torch

from qlora_tpu_torch.generate.sampler import top_k_mask, top_p_mask, typical_p_mask


def _target_probs(logits: torch.Tensor, sparams) -> torch.Tensor:
    """Temperature / top-k / top-p / typical-p adjusted softmax of logits
    [..., V]: the per-step distribution ``sample_token`` draws from."""
    if sparams.temperature != 1.0:
        logits = logits / max(sparams.temperature, 1e-6)
    logits = top_k_mask(logits, sparams.top_k)
    logits = top_p_mask(logits, sparams.top_p)
    logits = typical_p_mask(logits, sparams.typical_p)
    return torch.softmax(logits, dim=-1)


def accept_and_resample(probs: torch.Tensor, drafts: torch.Tensor,
                        generator: Optional[torch.Generator] = None):
    """probs [B, k+1, V], the target distribution at each chunk position;
    drafts [B, k].  Draft i is accepted with probability probs[b, i, d_i];
    at the first rejection the replacement is drawn from the residual (p
    with the rejected draft's mass removed); if every draft is accepted the
    bonus token samples probs[:, k].  Returns (tokens [B, k+1] int32,
    n_acc [B]): tokens[b, :n_acc[b]] are emitted (n_acc = accepted + 1)."""
    B, k1, V = probs.shape
    k = k1 - 1
    dev = probs.device
    drafts = drafts.to(device=dev, dtype=torch.int64)
    u = torch.rand((B, k), generator=generator, device=dev)
    p_d = torch.gather(probs[:, :k], 2, drafts[..., None])[..., 0]
    j = torch.cumprod((u < p_d).to(torch.int64), dim=1).sum(1)        # accepted count
    rows = torch.arange(B, device=dev)
    pos = j.clamp(max=k)
    p_fin = probs[rows, pos]                                          # [B, V]
    d_rej = drafts[rows, j.clamp(max=k - 1)]
    residual = p_fin.scatter(1, d_rej[:, None], 0.0)
    p_fin = torch.where((j < k)[:, None], residual, p_fin)
    # zero-mass tokens stay unsampleable; an all-zero residual (leaked f32
    # mass) falls back to the target's argmax rather than a uniform draw
    alive = p_fin.sum(-1) > 0
    weights = torch.where(alive[:, None], p_fin, torch.ones_like(p_fin))
    drawn = torch.multinomial(weights, 1, generator=generator)[:, 0]
    fin = torch.where(alive, drawn, probs[rows, pos].argmax(-1))
    tokens = torch.cat([drafts, torch.zeros((B, 1), dtype=torch.int64, device=dev)], 1)
    tokens[rows, j] = fin
    return tokens.to(torch.int32), j + 1
