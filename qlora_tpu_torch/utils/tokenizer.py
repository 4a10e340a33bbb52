"""Tokenizer wrapper: special-token repair and mean-initialized embedding
growth (a copy of the JAX package's, over the port's tensors).

* the slow (sentencepiece) tokenizer first, padding on the right;
* eos/bos/unk re-pointed at the model config's ids, the bos_token_id=1
  LLaMA fix included;
* pad with ``<unk>`` where the tokenizer has one (no vocabulary growth),
  else add ``[PAD]``, whose embedding rows :func:`resize_embeddings_mean_init`
  sets to the mean of the others.

``transformers`` is imported only inside :func:`load_tokenizer`: a run that
tokenizes with ``utils.testing.FakeTokenizer`` needs nothing of it.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

DEFAULT_PAD_TOKEN = "[PAD]"


class Tokenizer:
    """Thin adapter over an HF tokenizer exposing the collator protocol."""

    def __init__(self, hf_tokenizer, *, add_special_tokens: bool = False):
        self._tok = hf_tokenizer
        self._add_special = add_special_tokens

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text, add_special_tokens=self._add_special)

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return self._tok.decode(list(map(int, ids)), skip_special_tokens=skip_special_tokens)

    @property
    def bos_token_id(self) -> int:
        return self._tok.bos_token_id

    @property
    def eos_token_id(self) -> int:
        return self._tok.eos_token_id

    @property
    def pad_token_id(self) -> int:
        return self._tok.pad_token_id

    @property
    def vocab_size(self) -> int:
        return len(self._tok)


def load_tokenizer(
    name_or_path: str,
    *,
    model_vocab_size: Optional[int] = None,
    llama_special_token_fix: bool = True,
    use_fast: bool = False,
    config_eos_id: Optional[int] = None,
    config_bos_id: Optional[int] = None,
    config_pad_id: Optional[int] = None,
):
    """Load an HF tokenizer with the reference's repairs applied.

    The slow tokenizer is the default (fast and slow LLaMA tokenizers differ
    on added tokens and whitespace); where the checkpoint ships none, the
    fast one with a warning.  eos/bos/unk are re-pointed at the model
    config's ids where given; the pad is ``<unk>`` where there is one,
    else an added ``[PAD]``.

    Returns (Tokenizer, n_added_tokens)."""
    from transformers import AutoTokenizer

    try:
        tok = AutoTokenizer.from_pretrained(name_or_path, padding_side="right",
                                            use_fast=use_fast)
    except Exception as e:  # noqa: BLE001 — no slow class / no spm model
        if use_fast:
            raise
        logging.getLogger("qlora_tpu_torch").warning(
            "slow tokenizer unavailable for %s (%s); falling back to fast", name_or_path, e)
        tok = AutoTokenizer.from_pretrained(name_or_path, padding_side="right", use_fast=True)

    repairs = {}
    if config_eos_id is not None:
        repairs["eos_token"] = tok.convert_ids_to_tokens(config_eos_id)
    if config_bos_id is not None:
        repairs["bos_token"] = tok.convert_ids_to_tokens(config_bos_id)
    if config_pad_id is not None and config_pad_id != -1:
        repairs["unk_token"] = tok.convert_ids_to_tokens(config_pad_id)
    if repairs and llama_special_token_fix:
        tok.add_special_tokens({k: v for k, v in repairs.items() if v is not None})

    n_added = 0
    if tok.pad_token is None:
        if llama_special_token_fix and tok.unk_token is not None:
            tok.pad_token = tok.unk_token       # LLaMA: pad with <unk>, no resize
        else:
            n_added += tok.add_special_tokens({"pad_token": DEFAULT_PAD_TOKEN})
    if llama_special_token_fix and tok.bos_token_id is None:
        tok.add_special_tokens({"bos_token": "<s>"})
    return Tokenizer(tok), n_added


def resize_embeddings_mean_init(embed: torch.Tensor, lm_head_w: torch.Tensor, new_vocab: int):
    """Grow embed [V, D] and a dense lm_head weight [D, V] to `new_vocab`:
    each new row (column) is the f32 mean of the old ones, cast to the
    stored dtype."""
    V, D = embed.shape
    if new_vocab <= V:
        return embed, lm_head_w
    n_new = new_vocab - V
    in_mean = embed.float().mean(dim=0, keepdim=True)
    out_mean = lm_head_w.float().mean(dim=1, keepdim=True)
    new_embed = torch.cat([embed, in_mean.expand(n_new, D).to(embed.dtype)], dim=0)
    new_head = torch.cat([lm_head_w, out_mean.expand(D, n_new).to(lm_head_w.dtype)], dim=1)
    return new_embed, new_head
