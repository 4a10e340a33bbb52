"""The port's collator against the JAX package's: the same instances through
both give the same numpy arrays, byte for byte (both are numpy code; the
port keeps its own copy)."""

import numpy as np
import pytest

from qlora_tpu.train.collator import CausalCollator as JCollator
from qlora_tpu.train.collator import bucket_batches as jbucket_batches
from qlora_tpu.train.collator import example_length as jexample_length

from qlora_tpu_torch.train import IGNORE_INDEX, CausalCollator, bucket_batches, example_length


class ByteTokenizer:
    """One token per byte, ids shifted past the special tokens."""
    bos_token_id, eos_token_id, pad_token_id = 1, 2, 0

    def encode(self, text):
        return [3 + b for b in text.encode()]


def _instances(n, seed):
    rng = np.random.default_rng(seed)
    word = lambda k: "".join(chr(97 + int(c)) for c in rng.integers(0, 26, size=k))
    return [{"input": word(int(rng.integers(1, 40))), "output": word(int(rng.integers(1, 30)))}
            for _ in range(n)]


@pytest.mark.parametrize("kw", [
    dict(source_max_len=16, target_max_len=8),
    dict(source_max_len=64, target_max_len=32, pad_to=128),
    dict(source_max_len=16, target_max_len=8, train_on_source=True),
    dict(source_max_len=16, target_max_len=8, predict_with_generate=True),
    dict(source_max_len=64, target_max_len=32, pad_to=24),        # cut by pad_to
])
def test_collator_matches_jax(kw):
    tok = ByteTokenizer()
    inst = _instances(6, seed=len(kw))
    want, got = JCollator(tok, **kw)(inst), CausalCollator(tok, **kw)(inst)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


def test_labels_mask_source_and_padding():
    tok = ByteTokenizer()
    b = CausalCollator(tok, source_max_len=8, target_max_len=8, pad_to=20)(
        [{"input": "abc", "output": "de"}, {"input": "abcdefghijkl", "output": "z"}])
    assert IGNORE_INDEX == -100
    np.testing.assert_array_equal(b["attention_mask"].sum(-1), [7, 10])
    # row 0: bos a b c | d e eos | padding
    np.testing.assert_array_equal(b["labels"][0, :4], [-100] * 4)
    np.testing.assert_array_equal(b["labels"][0, 4:7], [3 + ord("d"), 3 + ord("e"), 2])
    assert (b["labels"][0, 7:] == -100).all() and (b["input_ids"][0, 7:] == 0).all()
    # row 1: the source is cut to 8 tokens (bos + 7)
    assert (b["labels"][1, :8] == -100).all() and b["labels"][1, 9] == 2


def test_length_and_buckets_match_jax():
    tok = ByteTokenizer()
    inst = _instances(23, seed=4)
    lengths = [example_length(tok, ex) for ex in inst]
    assert lengths == [jexample_length(tok, ex) for ex in inst]
    assert [example_length(tok, ex, False) for ex in inst] == \
        [jexample_length(tok, ex, False) for ex in inst]
    for drop_last in (False, True):
        assert bucket_batches(lengths, 4, (16, 32, 64, 128), seed=3, drop_last=drop_last) == \
            jbucket_batches(lengths, 4, (16, 32, 64, 128), seed=3, drop_last=drop_last)
