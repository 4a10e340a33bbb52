"""The port's datasets and FakeTokenizer against the JAX package's
(``qlora_tpu_torch/train/data.py``, ``utils/testing.py``): every format,
the four file types, the seeded train/eval split's index lists, and a hub
name without the network.  Plain Python on both sides: held equal."""

import builtins
import json

import numpy as np
import pytest

from qlora_tpu.train import collator as jcollator
from qlora_tpu.train import data as jdata
from qlora_tpu.utils.testing import FakeTokenizer as JFakeTokenizer

from qlora_tpu_torch.train import CausalCollator, data
from qlora_tpu_torch.utils import FakeTokenizer

EXAMPLES = {
    "alpaca": [{"instruction": "Do X", "input": "with Y", "output": "done"},
               {"instruction": "Do Z", "input": "", "output": "ok"},
               {"instruction": "No input key", "output": "fine"}],
    "chip2": [{"text": "<human>: hi\n<bot>: hello"},
              {"text": "no prefix\n<bot>: a\n<bot>: b"}],
    "self-instruct": [{"prompt": "p", "completion": "c"}],
    "hh-rlhf": [{"chosen": "c", "rejected": "r"}],
    "oasst1": [{"text": "### Human: q### Assistant: a"}],
    "guanaco": [{"text": "t"}],
    "longform": [{"input": "i", "output": "o"}],
    "input-output": [{"input": "i", "output": "o"}, {"output": "only output"}],
}


def test_tables_are_jax_s():
    assert data.ALPACA_PROMPT_DICT == jdata.ALPACA_PROMPT_DICT
    assert data.HUB_DATASETS == jdata.HUB_DATASETS


@pytest.mark.parametrize("fmt", list(EXAMPLES))
def test_every_format_maps_as_jax_s(fmt):
    for ex in EXAMPLES[fmt]:
        assert data.format_example(ex, fmt) == jdata.format_example(ex, fmt)
    if fmt == "alpaca":
        assert data.extract_alpaca_example(EXAMPLES[fmt][0]) == \
            jdata.extract_alpaca_example(EXAMPLES[fmt][0])


def test_unknown_format_raises():
    with pytest.raises(ValueError, match="unknown dataset format"):
        data.format_example({"text": "t"}, "nope")


ROWS = [{"input": "a, \"quoted\"", "output": "b\tc"}, {"input": "", "output": "d"},
        {"input": "é ü 你好", "output": "x\ny"}]


def _write(path, ext):
    if ext == ".json":
        path.write_text(json.dumps(ROWS))
    elif ext == ".jsonl":
        path.write_text("\n".join(json.dumps(r) for r in ROWS) + "\n\n")
    else:
        import csv

        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, ["input", "output"], delimiter="," if ext == ".csv" else "\t")
            w.writeheader()
            w.writerows(ROWS)


@pytest.mark.parametrize("ext", [".json", ".jsonl", ".csv", ".tsv"])
def test_local_files_load_as_jax_s(tmp_path, ext):
    path = tmp_path / f"d{ext}"
    _write(path, ext)
    got = data.load_local_dataset(str(path))
    assert got == jdata.load_local_dataset(str(path)) == ROWS
    assert data.load_dataset_by_name(str(path)) == jdata.load_dataset_by_name(str(path))
    for kw in ({}, {"do_eval": True, "eval_dataset_size": 1}, {"max_train_samples": 2},
               {"dataset_format": "longform"}):
        assert data.make_dataset(str(path), **kw) == jdata.make_dataset(str(path), **kw)


def test_unsupported_file_type_raises(tmp_path):
    path = tmp_path / "d.parquet"
    path.write_text("")
    with pytest.raises(ValueError, match="unsupported dataset file type"):
        data.load_local_dataset(str(path))


@pytest.mark.parametrize("n,eval_size,seed,max_train,max_eval", [
    (100, 0.1, 42, None, None), (64, 8, 0, None, None), (7, 0.3, 1, 3, 1),
    (1000, 0.05, 123, 500, 20), (1, 0.1, 42, None, None), (33, 32, 5, None, None)])
def test_split_index_lists_are_jax_s(n, eval_size, seed, max_train, max_eval):
    ex = [{"input": str(i), "output": ""} for i in range(n)]
    got = data.split_train_eval(ex, eval_size, seed, max_train, max_eval)
    want = jdata.split_train_eval(ex, eval_size, seed, max_train, max_eval)
    assert [[int(e["input"]) for e in part] for part in got] == \
        [[int(e["input"]) for e in part] for part in want]


def test_hub_name_without_datasets_or_network_raises_clearly(monkeypatch):
    """A registry name needs ``datasets``: without it, an ImportError that
    says to pass a local file; nothing is downloaded."""
    real = builtins.__import__

    def no_datasets(name, *a, **kw):
        if name == "datasets":
            raise ImportError("No module named 'datasets'")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_datasets)
    with pytest.raises(ImportError, match="local .json"):
        data.load_dataset_by_name("alpaca")
    with pytest.raises(ValueError, match="unknown dataset"):
        data.load_dataset_by_name("no-such-dataset")
    with pytest.raises(NotImplementedError):
        data.load_dataset_by_name("vicuna")


def test_hub_fetch_failure_raises_clearly(monkeypatch):
    """With ``datasets`` present but no network, the fetch's error comes
    back naming the dataset and the way out."""
    import sys
    import types

    fake = types.ModuleType("datasets")

    def load_dataset(*a, **kw):
        raise ConnectionError("offline")

    fake.load_dataset = load_dataset
    monkeypatch.setitem(sys.modules, "datasets", fake)
    with pytest.raises(RuntimeError, match="tatsu-lab/alpaca"):
        data.load_dataset_by_name("alpaca")


TEXTS = ["", "abc", "é ü 你好", "### Human: q### Assistant: a\n\t"]


def test_fake_tokenizer_is_jax_s():
    t, j = FakeTokenizer(), JFakeTokenizer()
    assert (t.bos_token_id, t.eos_token_id, t.pad_token_id) == (1, 2, 0) == \
        (j.bos_token_id, j.eos_token_id, j.pad_token_id)
    for text in TEXTS:
        assert t.encode(text) == j.encode(text)
        assert t.decode(t.encode(text)) == text == j.decode(j.encode(text))
    ids = [0, 1, 2, 3 + ord("h"), 259, 300, 3 + ord("i"), 258]
    assert t.decode(ids) == j.decode(ids)
    assert t.decode([0, 1, 2, 259, 511]) == ""


def test_collated_alpaca_file_is_jax_s(tmp_path):
    """The train-data phase's pipeline at a small size: an alpaca .jsonl
    through ``make_dataset`` and the collator with FakeTokenizer, truncation
    and source masking both present; the batch equals JAX's."""
    rng = np.random.default_rng(0)
    words = ["alpha", "beta", "gamma", "delta", "é", "token"]
    rows = [{"instruction": " ".join(rng.choice(words, 8 + i)),
             "input": "" if i % 3 == 0 else " ".join(rng.choice(words, i)),
             "output": " ".join(rng.choice(words, 3 * i + 1))} for i in range(12)]
    path = tmp_path / "a.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in rows))
    kw = dict(dataset_format="alpaca", do_eval=True, eval_dataset_size=4)
    train, evals = data.make_dataset(str(path), **kw)
    assert (train, evals) == jdata.make_dataset(str(path), **kw)
    got = CausalCollator(FakeTokenizer(), source_max_len=160, target_max_len=32,
                         pad_to=192)(train)
    want = jcollator.CausalCollator(JFakeTokenizer(), source_max_len=160, target_max_len=32)(train)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k])[:, :192])
    assert (got["labels"] == -100).any() and (got["attention_mask"].sum(1) == 192).any()
