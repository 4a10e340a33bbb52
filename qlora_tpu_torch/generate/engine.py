"""Generation engine: prefill, then token-at-a-time decode with a KV cache.

* batch predict — :func:`generate` (prefill + :func:`decode_loop`)
* streaming     — :func:`generate_stream` (yields [B] token ids per step)

Both run under ``torch.inference_mode()`` and update the KV cache in place:
the decode-attention kernel appends each token into the cache it is given.
``decode_impl="int8"`` runs the token loop on a per-column int8 copy of the
weights (``serve_int8``) through the int8 tensor-core kernels, under
``default_impl("w8a8")``; the prefill stays on the exact path.  Beam,
contrastive and group search are later slices of the port and raise
``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import numpy as np
import torch

from qlora_tpu_torch import resolve_device
from qlora_tpu_torch.generate.sampler import (
    SamplingParams, ban_repeated_ngrams, sample_token,
)
from qlora_tpu_torch.lora import LoraConfig
from qlora_tpu_torch.models.config import ModelConfig
from qlora_tpu_torch.models.transformer import forward, init_cache
from qlora_tpu_torch.ops import default_impl


def _token_seen_mask(ids: torch.Tensor, lengths: torch.Tensor, vocab: int) -> torch.Tensor:
    """[B, S] right-padded ids → [B, V] bool: token appears in the prompt."""
    B, S = ids.shape
    valid = (torch.arange(S, device=ids.device)[None, :] < lengths[:, None]) & (ids >= 0)
    seen = torch.zeros((B, vocab), dtype=torch.int32, device=ids.device)
    seen.scatter_reduce_(1, ids.clamp(0, vocab - 1).long(), valid.to(torch.int32),
                         reduce="amax")
    return seen.bool()


def _mark_seen(seen: torch.Tensor, tok: torch.Tensor) -> None:
    """seen[b, tok[b]] = True for in-vocabulary tokens (one_hot semantics:
    an id outside [0, V) marks nothing)."""
    V = seen.shape[1]
    ok = (tok >= 0) & (tok < V)
    rows = torch.arange(seen.shape[0], device=seen.device)
    seen[rows[ok], tok[ok].long()] = True


def prefill(params, lora, ids, lengths, cfg, lcfg=LoraConfig(), *, cache):
    """Run the right-padded prompts ids [B, S] (true lengths [B]) through the
    model, filling the cache.  Returns (last_logits [B, V], cache with each
    row's length set)."""
    B, S = ids.shape
    positions = torch.arange(S, device=ids.device)[None, :].repeat(B, 1)
    logits, cache = forward(params, lora, ids, cfg, lcfg, cache=cache, positions=positions)
    lengths = lengths.to(device=ids.device, dtype=torch.int32)
    cache = dict(cache, length=lengths)
    last = logits[torch.arange(B, device=ids.device), lengths.long() - 1]
    return last, cache


def decode_loop(params, lora, first_logits, cache, prompt_seen, generator=None, *,
                cfg: ModelConfig, lcfg: LoraConfig, sparams: SamplingParams,
                max_new_tokens: int, eos_id: int, min_new_tokens: int = 0,
                decode_impl: Optional[str] = None):
    """Token-at-a-time decode.  Returns (tokens [B, max_new_tokens] int32,
    eos-padded after each row stops; cache).  Stops early once every row
    has emitted `eos_id`.

    With ``decode_impl="int8"``, `params` must be the requantized serving
    tree (``serve_int8.requantize_params_int8_unstacked``): every step runs
    under ``default_impl("w8a8")``."""
    impl_ctx = _impl_ctx(decode_impl)
    B, V = first_logits.shape
    dev = first_logits.device
    out = torch.full((B, max_new_tokens), eos_id, dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    seen = prompt_seen.clone()
    logits = first_logits
    t = 0
    while t < max_new_tokens and not bool(done.all()):
        if min_new_tokens > 0 and eos_id >= 0 and t < min_new_tokens:
            logits = logits.clone()
            logits[:, eos_id] = float("-inf")
        if sparams.no_repeat_ngram_size > 0:
            logits = ban_repeated_ngrams(logits, out, t, sparams.no_repeat_ngram_size)
        tok = sample_token(logits, sparams, seen, generator)
        tok = torch.where(done, torch.full_like(tok, eos_id), tok)
        out[:, t] = tok.to(torch.int32)
        done |= tok == eos_id
        _mark_seen(seen, tok)
        with impl_ctx():
            logits, cache = forward(params, lora, tok[:, None], cfg, lcfg, cache=cache)
        logits = logits[:, 0]
        t += 1
    return out, cache


def _impl_ctx(decode_impl):
    """The context each decode step's forward runs in."""
    if decode_impl:
        return lambda: default_impl("w8a8")
    return contextlib.nullcontext


def _check_search(num_beams, num_beam_groups, penalty_alpha, decode_impl):
    if decode_impl not in (None, "int8"):
        raise ValueError(f"decode_impl={decode_impl!r}: only 'int8' or None")
    searching = bool(penalty_alpha) or num_beam_groups > 1 or num_beams > 1
    if decode_impl is not None and searching:
        raise NotImplementedError(
            "decode_impl composes with greedy/sampled decode only; "
            "beam/contrastive search runs the exact bf16 path")
    if penalty_alpha:
        raise NotImplementedError("contrastive search is ROADMAP A4 (generation, the rest)")
    if searching:
        raise NotImplementedError("beam search is ROADMAP A4 (generation, the rest)")


def _decode_params(params, decode_impl, decode_params):
    """The tree the token loop runs on: `params`, or for ``"int8"`` the
    serving copy handed in, made here when there is none."""
    if decode_impl is None:
        return params
    if decode_params is None:
        from qlora_tpu_torch.generate.serve_int8 import requantize_params_int8_unstacked

        decode_params = requantize_params_int8_unstacked(params)
    return decode_params


def _inputs_on(params, ids, lengths, device):
    device = resolve_device(device)
    if params["embed"].device.type != device.type:
        raise ValueError(f"params live on {params['embed'].device}, not {device}")
    dev = params["embed"].device
    return (torch.as_tensor(ids, device=dev),
            torch.as_tensor(lengths, device=dev).to(torch.int32))


def generate(params, lora, ids, lengths, cfg: ModelConfig, lcfg: LoraConfig = LoraConfig(),
             *, max_new_tokens: int = 256, eos_id: int = 2,
             sparams: SamplingParams = SamplingParams(),
             generator: Optional[torch.Generator] = None, max_len: Optional[int] = None,
             min_new_tokens: int = 0, num_beams: int = 1, num_beam_groups: int = 1,
             penalty_alpha: Optional[float] = None, decode_impl: Optional[str] = None,
             decode_params: Optional[dict] = None, device=None) -> torch.Tensor:
    """Batch generation: new tokens [B, max_new_tokens] int32, eos-padded
    after each row stops.  ids [B, S] right-padded prompts, lengths [B].
    Runs on CUDA unless `device` names another device; `params` must live
    there.  ``decode_impl="int8"`` opts the token loop into the int8
    kernels; pass `decode_params` (a
    ``serve_int8.requantize_params_int8_unstacked`` tree) to reuse one
    serving copy across calls."""
    _check_search(num_beams, num_beam_groups, penalty_alpha, decode_impl)
    ids, lengths = _inputs_on(params, ids, lengths, device)
    B, S = ids.shape
    with torch.inference_mode():
        cache = init_cache(cfg, B, max_len or (S + max_new_tokens), device=ids.device)
        # the prompt pass stays exact whatever decode_impl says
        last_logits, cache = prefill(params, lora, ids, lengths, cfg, lcfg, cache=cache)
        dec_params = _decode_params(params, decode_impl, decode_params)
        seen = _token_seen_mask(ids, lengths, cfg.vocab_size)
        toks, _ = decode_loop(
            dec_params, lora, last_logits, cache, seen, generator, cfg=cfg, lcfg=lcfg,
            sparams=sparams, max_new_tokens=max_new_tokens, eos_id=eos_id,
            min_new_tokens=min_new_tokens, decode_impl=decode_impl)
    return toks


def generate_stream(params, lora, ids, lengths, cfg: ModelConfig,
                    lcfg: LoraConfig = LoraConfig(), *, max_new_tokens: int = 256,
                    eos_id: int = 2, sparams: SamplingParams = SamplingParams(),
                    generator: Optional[torch.Generator] = None,
                    max_len: Optional[int] = None, decode_impl: Optional[str] = None,
                    decode_params: Optional[dict] = None,
                    device=None) -> Iterator[np.ndarray]:
    """Streaming generation: yields [B] numpy token ids per step (eos for
    rows already stopped) until every row has stopped or max_new_tokens.
    `decode_impl` and `decode_params` as in :func:`generate`."""
    _check_search(1, 1, None, decode_impl)
    ids, lengths = _inputs_on(params, ids, lengths, device)
    B, S = ids.shape
    done = np.zeros((B,), bool)
    with torch.inference_mode():
        cache = init_cache(cfg, B, max_len or (S + max_new_tokens), device=ids.device)
        logits, cache = prefill(params, lora, ids, lengths, cfg, lcfg, cache=cache)
        params = _decode_params(params, decode_impl, decode_params)
        seen = _token_seen_mask(ids, lengths, cfg.vocab_size)
    impl_ctx = _impl_ctx(decode_impl)
    for _ in range(max_new_tokens):
        with torch.inference_mode(), impl_ctx():
            tok = sample_token(logits, sparams, seen, generator)
            _mark_seen(seen, tok)
            logits, cache = forward(params, lora, tok[:, None], cfg, lcfg, cache=cache)
            logits = logits[:, 0]
        tok_np = np.where(done, eos_id, tok.cpu().numpy()).astype(np.int32)
        yield tok_np
        done |= tok_np == eos_id
        if done.all():
            return
