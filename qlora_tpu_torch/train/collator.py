"""Causal-LM collator: input/output examples to fixed-length token batches.

* the source is tokenized as ``{bos}{input}``, the target as ``{output}{eos}``,
  each truncated on its own (``source_max_len``, ``target_max_len``);
* ``input_ids = source + target``; the labels hold -100 over the source
  unless ``train_on_source``;
* ``predict_with_generate`` emits the source alone;
* right padding to one fixed length; ``attention_mask`` is 1 on real tokens.

Everything here is numpy: the train step moves a batch to its device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, Sequence

import numpy as np

from qlora_tpu_torch.train.loss import IGNORE_INDEX


class TokenizerLike(Protocol):
    bos_token_id: int
    eos_token_id: int
    pad_token_id: int

    def encode(self, text: str) -> list[int]: ...


@dataclasses.dataclass
class CausalCollator:
    tokenizer: TokenizerLike
    source_max_len: int = 1024
    target_max_len: int = 256
    train_on_source: bool = False
    predict_with_generate: bool = False
    pad_to: Optional[int] = None     # fixed pad length (default: src + tgt max)

    def __call__(self, instances: Sequence[dict]) -> dict:
        tok = self.tokenizer
        srcs, tgts = [], []
        for ex in instances:
            s = tok.encode(ex["input"])[: self.source_max_len - 1]
            srcs.append([tok.bos_token_id] + s)
            t = tok.encode(ex["output"])[: self.target_max_len - 1]
            tgts.append(t + [tok.eos_token_id])

        if self.predict_with_generate:
            seqs = srcs
            labels = None
        else:
            seqs = [s + t for s, t in zip(srcs, tgts)]
            if self.train_on_source:
                labels = [list(seq) for seq in seqs]
            else:
                labels = [[IGNORE_INDEX] * len(s) + list(t) for s, t in zip(srcs, tgts)]

        maxlen = self.pad_to or (
            self.source_max_len + (0 if self.predict_with_generate else self.target_max_len))
        B = len(seqs)
        input_ids = np.full((B, maxlen), tok.pad_token_id, np.int32)
        attention_mask = np.zeros((B, maxlen), np.int32)
        out_labels = np.full((B, maxlen), IGNORE_INDEX, np.int32)
        for i, seq in enumerate(seqs):
            seq = seq[:maxlen]
            input_ids[i, : len(seq)] = seq
            attention_mask[i, : len(seq)] = 1
            if labels is not None:
                lab = labels[i][:maxlen]
                out_labels[i, : len(lab)] = lab

        batch = {"input_ids": input_ids, "attention_mask": attention_mask}
        if labels is not None:
            batch["labels"] = out_labels
        return batch


def example_length(tokenizer: TokenizerLike, ex: dict, with_target: bool = True) -> int:
    """Token count of one example, for length-grouped batching."""
    n = 1 + len(tokenizer.encode(ex["input"]))
    if with_target:
        n += len(tokenizer.encode(ex["output"])) + 1
    return n


def bucket_batches(lengths: list[int], batch_size: int, buckets: Sequence[int],
                   seed: int = 0, drop_last: bool = False):
    """Length-grouped batching with a fixed set of padded lengths: sort the
    indices by length, slice them into batches, give each batch the
    smallest bucket that holds its longest example, then shuffle the batch
    order.  Returns a list of (indices, bucket_len)."""
    rng = np.random.default_rng(seed)
    order = np.argsort(np.asarray(lengths), kind="stable")
    batches = []
    for i in range(0, len(order), batch_size):
        idx = order[i: i + batch_size]
        if drop_last and len(idx) < batch_size:
            continue
        mx = max(lengths[j] for j in idx)
        blen = next((b for b in sorted(buckets) if b >= mx), max(buckets))
        batches.append((idx.tolist(), blen))
    rng.shuffle(batches)
    return batches
