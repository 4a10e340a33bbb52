"""Token sampling: temperature / top-k / top-p / typical-p / repetition
penalty / n-gram bans, with HF semantics, as the JAX package's sampler.

Sampling draws from an explicit ``torch.Generator``; it gives other numbers
than ``jax.random`` from the same seed, so only the masks and the greedy
choice can be compared across the two packages.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class SamplingParams(NamedTuple):
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0            # 0 = disabled
    top_p: float = 1.0
    typical_p: float = 1.0
    repetition_penalty: float = 1.0
    no_repeat_ngram_size: int = 0


_NEG_INF = float("-inf")


def apply_repetition_penalty(logits: torch.Tensor, seen_mask: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """CTRL-style: seen tokens' positive logits /= p, negative ones *= p."""
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen_mask, penalized, logits)


def top_k_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    if k <= 0:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, _NEG_INF)


def top_p_mask(logits: torch.Tensor, p: float) -> torch.Tensor:
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    cutoff = cum - probs > p          # keep until the mass exceeds p (top-1 always)
    cutoff_logit = torch.where(cutoff, torch.full_like(sorted_logits, float("inf")),
                               sorted_logits).amin(dim=-1, keepdim=True)
    return logits.masked_fill(logits < cutoff_logit, _NEG_INF)


def typical_p_mask(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Typical decoding: keep tokens whose surprisal is closest to the
    entropy, up to cumulative probability p."""
    if p >= 1.0:
        return logits
    logp = torch.log_softmax(logits, dim=-1)
    probs = logp.exp()
    ent = -(probs * torch.where(probs > 0, logp, torch.zeros_like(logp))).sum(
        -1, keepdim=True)
    shift = (-logp - ent).abs()
    order = torch.argsort(shift, dim=-1, stable=True)
    sorted_probs = torch.gather(probs, -1, order)
    cum = torch.cumsum(sorted_probs, dim=-1)
    keep_sorted = (cum - sorted_probs) < p
    keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    return logits.masked_fill(~keep, _NEG_INF)


def ban_repeated_ngrams(logits: torch.Tensor, history: torch.Tensor,
                        cur_len: int, n: int) -> torch.Tensor:
    """Ban any token that would complete an n-gram already present in the
    first `cur_len` tokens of `history` [B, T]."""
    if n <= 0:
        return logits
    B, V = logits.shape
    T = history.shape[1]
    if T < n:
        return logits
    dev = history.device
    start = max(cur_len - (n - 1), 0)
    start = min(start, T - (n - 1))              # the slice is clamped to fit
    suffix = history[:, start:start + n - 1]                         # [B, n-1]
    starts = torch.arange(T - n + 1, device=dev)
    wins = history[:, starts[:, None] + torch.arange(n - 1, device=dev)[None, :]]
    match = (wins == suffix[:, None, :]).all(-1)
    match &= (starts[None, :] + n - 1 < cur_len) & (cur_len >= n - 1)
    banned = history[:, starts + n - 1].long()                       # [B, S]
    ban = torch.zeros((B, V), dtype=torch.int32, device=dev)
    ban.scatter_reduce_(1, banned, match.to(torch.int32), reduce="amax")
    return logits.masked_fill(ban.bool(), _NEG_INF)


def sample_token(logits: torch.Tensor, params: SamplingParams,
                 seen_mask: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Next token ids [B] from logits [B, V] f32."""
    if seen_mask is not None and params.repetition_penalty != 1.0:
        logits = apply_repetition_penalty(logits, seen_mask, params.repetition_penalty)
    if not params.do_sample:
        return torch.argmax(logits, dim=-1)
    if params.temperature != 1.0:
        logits = logits / max(params.temperature, 1e-6)
    logits = top_k_mask(logits, params.top_k)
    logits = top_p_mask(logits, params.top_p)
    logits = typical_p_mask(logits, params.typical_p)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
