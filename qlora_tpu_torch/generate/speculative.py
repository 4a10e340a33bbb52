"""Prompt-lookup speculative decoding, and the acceptance step the paged
serving engine's verify chunks share.

Single-stream decode reads every weight for one token of work.
Speculation verifies k drafted tokens in one forward, so a pass over the
weights can retire up to k + 1 tokens; greedy verification keeps a draft
only where it equals the model's own argmax, so the tokens are the greedy
rollout's.  Drafts come from the context itself: the latest earlier
occurrence of the trailing ``ngram`` tokens proposes the ``draft_len``
tokens that followed it (no draft model).

* :func:`generate_speculative`: the batch, drafts matched on the device,
  one verify chunk a loop step over the contiguous cache (the cached
  chunk's plain attention and the qmm kernels at B·(k + 1) rows), the
  cache rolled back to the verified prefix by its length alone.
* :func:`generate_stream_speculative`: one stream (B = 1), drafts matched
  on the host, tokens yielded as each chunk lands.
* ``_target_probs`` is the distribution ``sample_token`` draws from;
  ``accept_and_resample`` is speculative rejection sampling with a
  point-mass draft (Leviathan et al.), so a sampled run's sequence is
  distributed as ancestral sampling from the target whatever the drafts.

Random numbers come from an explicit ``torch.Generator``; they differ from
``jax.random``'s, so a sampled run carries across from the JAX package
only in distribution.  ``decode_impl="int8"`` runs the chunks on the int8
serving copy under ``default_impl("w8a8")``, as ``generate`` does.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from qlora_tpu_torch.generate.sampler import (
    SamplingParams, top_k_mask, top_p_mask, typical_p_mask,
)
from qlora_tpu_torch.lora import LoraConfig
from qlora_tpu_torch.models.config import ModelConfig
from qlora_tpu_torch.models.transformer import forward, init_cache


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


def _draw(probs: torch.Tensor, generator) -> torch.Tensor:
    """One token a row from probs [B, V] (zero-mass tokens never drawn)."""
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _greedy_accept(logits: torch.Tensor, drafts: torch.Tensor):
    """(tokens [B, k+1] int32, n_acc [B]): the argmax at each chunk position;
    draft i is confirmed iff it equals the argmax and every earlier draft
    was confirmed."""
    toks = logits.argmax(-1).to(torch.int32)
    acc = torch.cumprod((drafts == toks[:, :-1]).to(torch.int64), dim=1)
    return toks, 1 + acc.sum(1)


def _draft(ctx: torch.Tensor, cur: torch.Tensor, k: int, ngram: int) -> torch.Tensor:
    """ctx [B, C] (row b valid below cur[b]) → drafts [B, k]: the k tokens
    after the latest strictly-earlier occurrence of the trailing ngram.  No
    match reads from ``clip(ngram - 1, 0, C - k)``: a draft of whatever is
    there (verification makes it harmless), as the JAX package's matcher."""
    B, C = ctx.shape
    dev = ctx.device
    rows = torch.arange(B, device=dev)
    span = torch.arange(C - ngram + 1, device=dev)
    cur = cur.long()
    match = torch.ones((B, C - ngram + 1), dtype=torch.bool, device=dev)
    for g in range(ngram):
        last_g = ctx[rows, cur - ngram + g]
        match &= ctx[:, g:C - ngram + 1 + g] == last_g[:, None]
    match &= span[None, :] < (cur - ngram)[:, None]
    best = torch.where(match, span[None, :], -1).max(1).values
    start = torch.clamp(best + ngram, 0, C - k)
    return ctx.gather(1, start[:, None] + torch.arange(k, device=dev)[None, :])


def _spec_loop(params, lora, first_logits, cache, ctx, cur, generator=None, *,
               cfg: ModelConfig, lcfg: LoraConfig, max_new_tokens: int, eos_id: int,
               draft_len: int, ngram: int, decode_impl: Optional[str] = None,
               sparams: Optional[SamplingParams] = None):
    """ctx [B, C]: the prompts (row b valid below cur[b]); the cache holds
    the prefilled prompts with each row's length at cur.  Returns (out
    [B, max_new_tokens] int32, eos-padded; the number of verify chunks)."""
    from qlora_tpu_torch.generate.engine import _impl_ctx

    B, C = ctx.shape
    k, T = draft_len, max_new_tokens
    dev = ctx.device
    rows = torch.arange(B, device=dev)
    impl_ctx = _impl_ctx(decode_impl)
    sampled = sparams is not None and sparams.do_sample

    # the first token from the prefill logits (as decode_loop)
    t0 = (_draw(_target_probs(first_logits, sparams), generator) if sampled
          else first_logits.argmax(-1))
    out = torch.full((B, T), eos_id, dtype=torch.int32, device=dev)
    out[:, 0] = t0.to(torch.int32)
    done = (t0 == eos_id) | (T <= 1)
    n_out = torch.ones((B,), dtype=torch.int64, device=dev)
    # the pending token joins the context; the cache stays at the prompt (its
    # K/V is written by its own verify chunk)
    cur = cur.long()
    ctx[rows, cur] = t0.to(ctx.dtype)
    cur = cur + 1
    idx = torch.arange(k + 1, device=dev)
    chunks = 0
    while not bool(done.all()):
        pending = ctx[rows, cur - 1][:, None]
        drafts = _draft(ctx, cur, k, ngram)
        len_before = cache["length"]
        with impl_ctx():
            logits, cache = forward(params, lora, torch.cat([pending, drafts], 1), cfg, lcfg,
                                    cache=cache)
        # logits[:, i]: the model's distribution after inp[:, :i+1]
        if sampled:
            probs = _target_probs(logits.reshape(B * (k + 1), -1), sparams).reshape(
                B, k + 1, -1)
            toks, n_acc = accept_and_resample(probs, drafts, generator)
        else:
            toks, n_acc = _greedy_accept(logits, drafts)
        # cut at the first accepted eos (emitted, as decode_loop does), then
        # at the output budget
        eos_pos = torch.where((toks == eos_id) & (idx[None] < n_acc[:, None]), idx[None],
                              k + 1).min(1).values
        n_acc = torch.minimum(n_acc, eos_pos + 1)
        n_eff = torch.where(done, 0, torch.minimum(n_acc, T - n_out))
        wmask = idx[None] < n_eff[:, None]                          # [B, k+1]
        b, i = wmask.nonzero(as_tuple=True)
        out[b, n_out[b] + i] = toks[b, i]
        fits = cur[b] + i < C          # past a short max_len the context drops them, as JAX's
        ctx[b[fits], (cur[b] + i)[fits]] = toks[b, i][fits].to(ctx.dtype)
        done |= ((toks == eos_id) & wmask).any(1)
        n_out = n_out + n_eff
        cur = cur + n_eff
        done |= n_out >= T
        # roll the cache back to the verified prefix: the chunk wrote k + 1
        # positions, of which [pending, accepted drafts] are context; the
        # rest stay masked by the length until overwritten
        cache = dict(cache, length=(len_before + n_eff).to(torch.int32))
        chunks += 1
    return out, chunks


def _check_spec(sparams, decode_impl):
    if sparams is not None and sparams.do_sample and (
            sparams.repetition_penalty != 1.0 or sparams.no_repeat_ngram_size > 0):
        raise NotImplementedError(
            "repetition_penalty / no_repeat_ngram_size do not compose with speculative "
            "decoding (in-chunk history dependence); use generate()")
    if decode_impl not in (None, "int8"):
        raise ValueError(f"decode_impl={decode_impl!r}: only 'int8' or None")


def generate_speculative(params, lora, ids, lengths, cfg: ModelConfig,
                         lcfg: LoraConfig = LoraConfig(), *, max_new_tokens: int = 256,
                         eos_id: int = 2, max_len: Optional[int] = None, draft_len: int = 8,
                         ngram: int = 2, decode_impl: Optional[str] = None,
                         decode_params: Optional[dict] = None,
                         sparams: Optional[SamplingParams] = None,
                         generator: Optional[torch.Generator] = None,
                         with_stats: bool = False, device=None):
    """Generation with prompt-lookup speculation: tokens [B, max_new_tokens]
    int32, eos-padded; with ``with_stats`` a ``(tokens, {"chunks": n})``
    pair, n the verify chunks taken.

    Greedy runs equal greedy ``generate()`` up to kernel numerics: the
    verify chunk (plain attention over the cache, the qmm kernels at
    B·(k + 1) rows) and the decode step's kernels round in other orders, so
    an argmax decided by a near-tie may differ between the two.  Sampled
    runs (``sparams.do_sample``) accept each draft with the target's own
    probability of it and resample the first rejection from the residual
    (``accept_and_resample``): the sequence is distributed as ancestral
    sampling from the adjusted target.  ``repetition_penalty`` and
    ``no_repeat_ngram_size`` make the target depend on tokens inside the
    chunk, so a sampled run with either raises.  Runs on CUDA unless
    `device` names another device."""
    from qlora_tpu_torch.generate.engine import _decode_params, _inputs_on, prefill

    _check_spec(sparams, decode_impl)
    ids, lengths = _inputs_on(params, ids, lengths, device)
    B, S = ids.shape
    # room for the deepest overshoot: one whole chunk past the budget
    max_len = max_len or (S + max_new_tokens + draft_len + 1)
    with torch.inference_mode():
        cache = init_cache(cfg, B, max_len, device=ids.device)
        last_logits, cache = prefill(params, lora, ids, lengths, cfg, lcfg, cache=cache)
        dec_params = _decode_params(params, decode_impl, decode_params)
        # right-padded prompts; the pads past each length are never matched
        ctx = torch.zeros((B, max_len), dtype=torch.int64, device=ids.device)
        ctx[:, :S] = ids
        toks, chunks = _spec_loop(
            dec_params, lora, last_logits, cache, ctx, lengths, generator, cfg=cfg, lcfg=lcfg,
            max_new_tokens=max_new_tokens, eos_id=eos_id, draft_len=draft_len, ngram=ngram,
            decode_impl=decode_impl, sparams=sparams)
    if with_stats:
        return toks, {"chunks": chunks}
    return toks


def generate_stream_speculative(params, lora, ids, lengths, cfg: ModelConfig,
                                lcfg: LoraConfig = LoraConfig(), *, max_new_tokens: int = 256,
                                eos_id: int = 2, max_len: Optional[int] = None,
                                draft_len: int = 8, ngram: int = 2,
                                decode_impl: Optional[str] = None,
                                decode_params: Optional[dict] = None,
                                sparams: Optional[SamplingParams] = None,
                                generator: Optional[torch.Generator] = None,
                                device=None) -> Iterator[np.ndarray]:
    """Streaming prompt-lookup speculation for one stream (B = 1): yields
    [1] numpy token ids as each verify chunk lands, up to the first eos.
    The acceptance is :func:`generate_speculative`'s; drafts are matched on
    the host (zeros where nothing matches), which changes how many chunks
    run, never the greedy tokens."""
    from qlora_tpu_torch.generate.engine import _decode_params, _impl_ctx, _inputs_on, prefill

    ids, lengths = _inputs_on(params, ids, lengths, device)
    B, S = ids.shape
    if B != 1:
        raise ValueError(f"streaming speculation is single-stream (B = 1), got B = {B}")
    _check_spec(sparams, decode_impl)
    sampled = sparams is not None and sparams.do_sample
    k = draft_len
    dev = ids.device
    with torch.inference_mode():
        cache = init_cache(cfg, 1, max_len or (S + max_new_tokens + k + 1), device=dev)
        logits0, cache = prefill(params, lora, ids, lengths, cfg, lcfg, cache=cache)
        params = _decode_params(params, decode_impl, decode_params)
        t0 = int((_draw(_target_probs(logits0, sparams), generator) if sampled
                  else logits0.argmax(-1))[0])
    impl_ctx = _impl_ctx(decode_impl)
    # the context and the verified cache length live on the host
    ctx = ids[0, :int(lengths[0])].tolist()
    cur_len = len(ctx)

    def host_draft():
        if len(ctx) < ngram + 1:
            return [0] * k
        tail = ctx[-ngram:]
        for i in range(len(ctx) - ngram - 1, -1, -1):
            if ctx[i:i + ngram] == tail:
                return (ctx[i + ngram:i + ngram + k] + [0] * k)[:k]
        return [0] * k

    yield np.asarray([t0], np.int32)
    n_out = 1
    if t0 == eos_id or n_out >= max_new_tokens:
        return
    ctx.append(t0)
    while n_out < max_new_tokens:
        inp = torch.tensor([[ctx[-1], *host_draft()]], device=dev)
        with torch.inference_mode(), impl_ctx():
            cache = dict(cache, length=torch.full((1,), cur_len, dtype=torch.int32, device=dev))
            logits, cache = forward(params, lora, inp, cfg, lcfg, cache=cache)
            if sampled:
                toks, n_acc = accept_and_resample(_target_probs(logits[0], sparams)[None],
                                                  inp[:, 1:], generator)
            else:
                toks, n_acc = _greedy_accept(logits, inp[:, 1:])
        toks = toks[0].tolist()
        n = min(int(n_acc[0]), max_new_tokens - n_out)
        for i in range(n):
            yield np.asarray([toks[i]], np.int32)
            n_out += 1
            if toks[i] == eos_id:
                return
            ctx.append(toks[i])
        cur_len += n      # roll back to the verified prefix
