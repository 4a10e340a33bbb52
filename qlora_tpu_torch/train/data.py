"""Instruction datasets: named hub datasets, the Alpaca prompt templates,
the per-format mapping to ``{input, output}``, local json/jsonl/csv/tsv
files and the seeded train/eval split (a copy of the JAX package's, so the
port imports nothing of it).

Local files and in-memory lists need nothing beyond the standard library
and numpy; only a hub name imports the ``datasets`` package, and only
when it is asked for.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Optional

import numpy as np

ALPACA_PROMPT_DICT = {
    "prompt_input": (
        "Below is an instruction that describes a task, paired with an input that provides further context. "
        "Write a response that appropriately completes the request.\n\n"
        "### Instruction:\n{instruction}\n\n### Input:\n{input}\n\n### Response: "
    ),
    "prompt_no_input": (
        "Below is an instruction that describes a task. "
        "Write a response that appropriately completes the request.\n\n"
        "### Instruction:\n{instruction}\n\n### Response: "
    ),
}

# dataset name → (hub id, format key)
HUB_DATASETS = {
    "alpaca": ("tatsu-lab/alpaca", "alpaca"),
    "alpaca-clean": ("yahma/alpaca-cleaned", "alpaca"),
    "chip2": ("laion/OIG", "chip2"),
    "self-instruct": ("yizhongw/self_instruct", "self-instruct"),
    "hh-rlhf": ("Anthropic/hh-rlhf", "hh-rlhf"),
    "longform": ("akoksal/LongForm", "longform"),
    "oasst1": ("timdettmers/openassistant-guanaco", "oasst1"),
}


def extract_alpaca_example(example: dict) -> dict:
    """Alpaca instruction/input/output → {input: prompt, output}."""
    if example.get("input", ""):
        prompt = ALPACA_PROMPT_DICT["prompt_input"].format(**example)
    else:
        prompt = ALPACA_PROMPT_DICT["prompt_no_input"].format(**example)
    return {"input": prompt, "output": example["output"]}


def format_example(example: dict, fmt: str) -> dict:
    """Map one example of format `fmt` to {input, output}."""
    if fmt == "alpaca":
        return extract_alpaca_example(example)
    if fmt == "chip2":
        user, bot = example["text"].split("\n<bot>: ", 1)
        return {"input": user.removeprefix("<human>: "), "output": bot}
    if fmt == "self-instruct":
        return {"input": example["prompt"], "output": example["completion"]}
    if fmt == "hh-rlhf":
        return {"input": "", "output": example["chosen"]}
    if fmt in ("oasst1", "guanaco"):
        return {"input": "", "output": example["text"]}
    if fmt == "longform":
        return {"input": example["input"], "output": example["output"]}
    if fmt == "input-output":
        return {"input": example.get("input", ""), "output": example["output"]}
    raise ValueError(f"unknown dataset format {fmt!r}")


def load_local_dataset(path: str) -> list[dict]:
    """A list of examples from a .json, .jsonl, .csv or .tsv file."""
    ext = os.path.splitext(path)[1]
    if ext == ".json":
        with open(path) as f:
            return json.load(f)
    if ext == ".jsonl":
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]
    if ext in (".csv", ".tsv"):
        delim = "," if ext == ".csv" else "\t"
        with open(path, newline="") as f:
            return list(csv.DictReader(f, delimiter=delim))
    raise ValueError(f"unsupported dataset file type: {path}")


def load_dataset_by_name(name: str, split: str = "train") -> tuple[list[dict], str]:
    """Returns (examples, format_key). `name` may be a registry key or a path;
    a registry key needs the ``datasets`` package and the network."""
    if os.path.exists(name):
        return load_local_dataset(name), "input-output"
    if name == "vicuna":
        raise NotImplementedError("vicuna dataset not supported (as in the reference)")
    if name not in HUB_DATASETS:
        raise ValueError(f"unknown dataset {name!r} (not a registry name or file path)")
    hub_id, fmt = HUB_DATASETS[name]
    try:
        import datasets  # only hub datasets need it
    except ImportError as e:
        raise ImportError(
            f"dataset {name!r} is on the hub ({hub_id}): it needs the `datasets` package "
            "and the network; pass a local .json/.jsonl/.csv/.tsv file instead") from e
    try:
        if name == "chip2":
            ds = datasets.load_dataset(hub_id, data_files="unified_chip2.jsonl")[split]
        elif name == "self-instruct":
            ds = datasets.load_dataset(hub_id, "self_instruct")[split]
        else:
            ds = datasets.load_dataset(hub_id)[split]
    except OSError as e:                 # offline: connection errors, no local copy
        raise RuntimeError(
            f"could not fetch {hub_id} for dataset {name!r} (no network or no local "
            "copy); pass a local .json/.jsonl/.csv/.tsv file instead") from e
    return list(ds), fmt


def split_train_eval(
    examples: list[dict],
    eval_size: float = 0.1,
    seed: int = 42,
    max_train: Optional[int] = None,
    max_eval: Optional[int] = None,
):
    """Seeded split: a permutation by ``np.random.default_rng(seed)``, the
    first ``eval_size`` (a share below 1, else a count) for eval."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(examples))
    n_eval = int(len(examples) * eval_size) if eval_size < 1 else int(eval_size)
    eval_idx, train_idx = idx[:n_eval], idx[n_eval:]
    train = [examples[i] for i in train_idx]
    evals = [examples[i] for i in eval_idx]
    if max_train:
        train = train[:max_train]
    if max_eval:
        evals = evals[:max_eval]
    return train, evals


def make_dataset(
    name: str,
    *,
    dataset_format: Optional[str] = None,
    do_eval: bool = False,
    eval_dataset_size: float = 0.1,
    max_train_samples: Optional[int] = None,
    max_eval_samples: Optional[int] = None,
    seed: int = 42,
):
    """Load → format → split.  Returns (train, eval or None).
    ``dataset_format`` overrides the registry's format key."""
    raw, fmt = load_dataset_by_name(name)
    fmt = dataset_format or fmt
    formatted = [format_example(ex, fmt) for ex in raw]
    if do_eval:
        return split_train_eval(
            formatted, eval_dataset_size, seed, max_train_samples, max_eval_samples
        )
    train = formatted[:max_train_samples] if max_train_samples else formatted
    return train, None
