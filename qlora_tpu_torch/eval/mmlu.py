"""MMLU rank classification, as the JAX package scores it.

* each record is {subject, input, output} with output in {A, B, C, D};
* the collator masks the source; the prediction is the argmax over the
  logits of the four answer letters' first token ids at the position
  **before** the first label token (next-token prediction);
* metrics: per-subject accuracy, mean accuracy over subjects, and the
  masked loss over every label token.

The logits stay on the model's device: each batch gathers the four option
logits at each row's answer position and the masked loss there, and only
those few numbers reach the host (at LLaMA-7B and 2048 tokens a batch of
four holds 1 GB of f32 logits).

Data files: ``zero_shot_mmlu_{val,test}.json`` / ``five_shot_mmlu_{val,test}.json``
under ``data/mmlu/`` (JSON, columnar JSON or JSON lines).
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Optional

import numpy as np
import torch

from qlora_tpu_torch import resolve_device
from qlora_tpu_torch.lora import LoraConfig
from qlora_tpu_torch.models.config import ModelConfig
from qlora_tpu_torch.models.transformer import forward
from qlora_tpu_torch.train.collator import CausalCollator
from qlora_tpu_torch.train.loss import IGNORE_INDEX, masked_cross_entropy


def load_mmlu_file(path: str, max_samples: Optional[int] = None) -> list[dict]:
    """Records from a JSON list, a dict of columns, or JSON lines."""
    with open(path) as f:
        text = f.read()
    try:
        data = json.loads(text)
    except json.JSONDecodeError:
        data = [json.loads(ln) for ln in text.splitlines() if ln.strip()]
    if isinstance(data, dict):
        keys = list(data)
        n = len(data[keys[0]])
        data = [{k: data[k][i] for k in keys} for i in range(n)]
    return data[:max_samples] if max_samples else data


def abcd_token_ids(tokenizer) -> list[int]:
    """First token id of each of 'A'..'D'."""
    return [tokenizer.encode(c)[0] for c in "ABCD"]


def mmlu_batch(params, lora, cfg: ModelConfig, lcfg: LoraConfig, batch: dict,
               abcd: torch.Tensor):
    """One collated batch on the params' device: (mean loss over the label
    tokens, their count, option logits [B, 4] f32, has_label [B] bool), all
    still on the device.
    Row b's option logits are taken at the position before its first label."""
    dev = params["embed"].device
    ids = torch.as_tensor(batch["input_ids"], device=dev)
    labels = torch.as_tensor(batch["labels"], device=dev).long()
    with torch.no_grad():
        logits, _ = forward(params, lora, ids, cfg, lcfg,
                            attn_mask=torch.as_tensor(batch["attention_mask"], device=dev))
        loss, n = masked_cross_entropy(logits[:, :-1], labels[:, 1:])
        valid = labels != IGNORE_INDEX
        first = valid.int().argmax(dim=1)          # the first True (0 where there is none)
        rows = torch.arange(ids.shape[0], device=dev)
        options = logits[rows, (first - 1).clamp(min=0)][:, abcd].float()
    return loss, n, options, valid.any(dim=1)


def evaluate_mmlu(
    params,
    lora,
    cfg: ModelConfig,
    tokenizer,
    examples: list[dict],
    *,
    lcfg: LoraConfig = LoraConfig(),
    batch_size: int = 8,
    source_max_len: int = 2048,
    device=None,
) -> dict:
    """Returns {"mmlu_loss", "mmlu_eval_accuracy_<subject>": ...,
    "mmlu_eval_accuracy"}.  Runs on CUDA unless `device` names another
    device; `params` must live there."""
    device = resolve_device(device)
    if params["embed"].device.type != device.type:
        raise ValueError(f"params live on {params['embed'].device}, not {device}")
    collator = CausalCollator(tokenizer, source_max_len=source_max_len, target_max_len=16,
                              pad_to=source_max_len + 16)
    abcd = torch.tensor(abcd_token_ids(tokenizer), device=params["embed"].device)

    total_loss, total_n = 0.0, 0
    preds, refs, subjects = [], [], []
    for i in range(0, len(examples), batch_size):
        chunk = examples[i: i + batch_size]
        loss, n, options, has = mmlu_batch(params, lora, cfg, lcfg, collator(chunk), abcd)
        total_loss += float(loss) * int(n)
        total_n += int(n)
        picked = options.argmax(dim=-1).cpu().tolist()
        for ex, p, ok in zip(chunk, picked, has.cpu().tolist()):
            if not ok:
                continue
            preds.append(p)
            refs.append("ABCD".index(ex["output"].strip()[0]))
            subjects.append(ex.get("subject", "all"))

    by_subject = defaultdict(lambda: [0, 0])
    for p, r, s in zip(preds, refs, subjects):
        by_subject[s][0] += int(p == r)
        by_subject[s][1] += 1

    results = {"mmlu_loss": total_loss / max(total_n, 1)}
    accs = []
    for s, (c, n) in sorted(by_subject.items()):
        acc = c / n
        results[f"mmlu_eval_accuracy_{s}"] = acc
        accs.append(acc)
    results["mmlu_eval_accuracy"] = float(np.mean(accs)) if accs else 0.0
    return results
