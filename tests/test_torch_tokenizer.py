"""The port's tokenizer wrapper against the JAX package's
(``qlora_tpu_torch/utils/tokenizer.py``): ids, decoding, special ids and
added tokens over the offline byte-level GPT-2 fixture of
``tests/test_tokenizer.py`` (the same HF tokenizer underneath: held equal),
and the mean-initialized embedding growth against JAX's (f32 means in
another summation order: within 1e-6 relative before the cast, and the
stored bf16 rows within one bf16 ulp, 2^-8 relative)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from qlora_tpu.utils.tokenizer import load_tokenizer as jload_tokenizer  # noqa: E402
from qlora_tpu.utils.tokenizer import resize_embeddings_mean_init as jresize  # noqa: E402

from qlora_tpu_torch.utils import load_tokenizer, resize_embeddings_mean_init  # noqa: E402

TEXTS = [
    "### Human: What is the capital of France?### Assistant: Paris.",
    "A riddle:\n  what walks on four legs?\t(answer below)",
    "unicode: héllo wörld — ¿qué tal? 你好",
    "",
    "   leading and trailing spaces   ",
]


@pytest.fixture(scope="module")
def tok_dir(tmp_path_factory):
    from transformers.models.gpt2.tokenization_gpt2 import bytes_to_unicode

    d = tmp_path_factory.mktemp("tok")
    be = bytes_to_unicode()
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for b in sorted(be):
        vocab[be[b]] = len(vocab)
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n")
    tok = transformers.GPT2Tokenizer(str(d / "vocab.json"), str(d / "merges.txt"),
                                     unk_token="<unk>", bos_token="<s>", eos_token="</s>")
    tok.save_pretrained(str(d))
    return str(d)


CASES = {
    "default": {},
    "fast": {"use_fast": True},
    "config_ids": {"config_eos_id": 2, "config_bos_id": 1, "config_pad_id": 0},
    "nonstandard_eos": {"config_eos_id": 10},
    "pad_id_minus_one": {"config_pad_id": -1, "config_eos_id": 2},
    "no_fix": {"llama_special_token_fix": False},
}


@pytest.mark.parametrize("case", list(CASES))
def test_ids_decode_specials_and_added_tokens_are_jax_s(tok_dir, case):
    kw = CASES[case]
    mine, n_mine = load_tokenizer(tok_dir, **kw)
    theirs, n_theirs = jload_tokenizer(tok_dir, **kw)
    assert n_mine == n_theirs
    assert mine._tok.is_fast == theirs._tok.is_fast == bool(kw.get("use_fast"))
    for attr in ("bos_token_id", "eos_token_id", "pad_token_id", "vocab_size"):
        assert getattr(mine, attr) == getattr(theirs, attr), attr
    assert mine._tok.unk_token_id == theirs._tok.unk_token_id
    for text in TEXTS:
        ids = mine.encode(text)
        assert ids == theirs.encode(text)
        assert mine.decode(ids) == theirs.decode(ids)
        assert mine.decode(np.asarray(ids + [mine.eos_token_id]), skip_special_tokens=False) == \
            theirs.decode(ids + [theirs.eos_token_id], skip_special_tokens=False)


def test_the_repairs_take_the_config_ids(tok_dir):
    tok, n = load_tokenizer(tok_dir, config_eos_id=2, config_bos_id=1, config_pad_id=0)
    assert (tok.eos_token_id, tok.bos_token_id, tok.pad_token_id, n) == (2, 1, 0, 0)
    tok, n = load_tokenizer(tok_dir, config_eos_id=10)
    assert tok.eos_token_id == 10
    tok, n = load_tokenizer(tok_dir, llama_special_token_fix=False)
    assert n == 1 and tok.pad_token_id == tok.vocab_size - 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("V,D,new", [(50, 16, 53), (50, 16, 50), (50, 16, 40), (300, 64, 301)])
def test_resize_embeddings_mean_init_matches_jax(dtype, V, D, new):
    rng = np.random.default_rng(V + new)
    e = rng.normal(size=(V, D)).astype(np.float32)
    h = rng.normal(size=(D, V)).astype(np.float32)
    te, th = torch.from_numpy(e).to(dtype), torch.from_numpy(h).to(dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    je, jh = jresize(jnp.asarray(e, jdt), jnp.asarray(h, jdt), new)
    ge, gh = resize_embeddings_mean_init(te, th, new)
    assert ge.dtype == gh.dtype == dtype
    assert tuple(ge.shape) == je.shape == (max(V, new), D) and tuple(gh.shape) == jh.shape
    assert torch.equal(ge[:V], te) and torch.equal(gh[:, :V], th)
    ulp = 2.0 ** -8 if dtype == torch.bfloat16 else 1e-6
    for got, want in ((ge.float().numpy(), np.asarray(je, np.float32)),
                      (gh.float().numpy(), np.asarray(jh, np.float32))):
        np.testing.assert_allclose(got, want, rtol=ulp, atol=1e-7)
    if new > V:
        np.testing.assert_allclose(ge[V:].float().numpy(),
                                   np.repeat(te.float().mean(0, keepdim=True).to(dtype).float()
                                             .numpy(), new - V, axis=0))
