"""Port speculative decoding (``generate/speculative.py``) against the JAX
package's: the acceptance step first, then single-stream speculation.

``_target_probs`` is the same f32 arithmetic on the same numpy logits:
within 1e-6.  ``accept_and_resample`` draws from a ``torch.Generator``,
whose numbers differ from ``jax.random``'s, so its structure is checked:
point-mass targets give the greedy-exact answer, a token after a rejection
comes only from the residual, and the first emitted token is distributed
as the target (the JAX test's budget, total variation < 0.02 over 40k
draws)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qlora_tpu.generate.sampler import SamplingParams as JSamplingParams
from qlora_tpu.generate.speculative import _target_probs as jtarget_probs
from qlora_tpu.generate.speculative import generate_speculative as jgenerate_speculative
from qlora_tpu.models import get_config as jget_config
from qlora_tpu.models import init_params as jinit_params

from qlora_tpu_torch.generate import generate, generate_speculative, generate_stream_speculative
from qlora_tpu_torch.generate.sampler import SamplingParams
from qlora_tpu_torch.generate.speculative import _target_probs, accept_and_resample
from qlora_tpu_torch.models import forward, get_config
from test_torch_convert import bridge

torch.set_num_threads(2)


@pytest.mark.parametrize("kw", [
    dict(), dict(temperature=0.7), dict(top_k=5), dict(top_p=0.8),
    dict(typical_p=0.9, temperature=1.3),
])
def test_target_probs_match_jax(kw):
    x = np.random.default_rng(len(kw)).normal(size=(6, 64)).astype(np.float32) * 3
    want = np.asarray(jtarget_probs(jnp.asarray(x), JSamplingParams(do_sample=True, **kw)))
    got = _target_probs(torch.from_numpy(x), SamplingParams(do_sample=True, **kw)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert ((got > 0) == (want > 0)).all()


def test_point_mass_targets_are_greedy_exact():
    """With one-hot targets, drafts equal to the target are always accepted
    and the first wrong draft is replaced by the target's token."""
    V, k = 16, 4
    target = torch.tensor([[3, 5, 7, 9, 11], [3, 5, 2, 9, 11], [1, 1, 1, 1, 1]])
    probs = torch.nn.functional.one_hot(target, V).float()
    drafts = torch.tensor([[3, 5, 7, 9], [3, 5, 7, 9], [0, 1, 1, 1]])
    g = torch.Generator().manual_seed(0)
    toks, n_acc = accept_and_resample(probs, drafts, g)
    assert toks.dtype == torch.int32 and toks.shape == (3, k + 1)
    assert n_acc.tolist() == [5, 3, 1]
    for b, n in enumerate(n_acc.tolist()):
        assert toks[b, :n].tolist() == target[b, :n].tolist()


def test_resample_after_rejection_avoids_the_draft():
    """A rejected draft has its mass removed: the replacement is never the
    rejected token and only ever a token the target allows."""
    V, n = 8, 4000
    p = torch.tensor([0.0, 0.5, 0.0, 0.3, 0.2, 0.0, 0.0, 0.0])
    probs = p.expand(n, 2, V).contiguous()
    drafts = torch.full((n, 1), 1)
    toks, n_acc = accept_and_resample(probs, drafts, torch.Generator().manual_seed(1))
    rejected = n_acc == 1
    assert 0.4 < rejected.float().mean().item() < 0.6       # 1 - p(d)
    repl = toks[rejected, 0]
    assert set(repl.unique().tolist()) <= {3, 4}
    assert (toks[~rejected, 0] == 1).all()


def test_first_token_is_distributed_as_the_target():
    V, n = 8, 40000
    p = torch.tensor([0.30, 0.02, 0.18, 0.05, 0.20, 0.10, 0.05, 0.10])
    probs = p.expand(n, 2, V).contiguous()
    for d in (0, 1, 4):
        toks, n_acc = accept_and_resample(probs, torch.full((n, 1), d),
                                          torch.Generator().manual_seed(d))
        emp = torch.bincount(toks[:, 0].long(), minlength=V).float() / n
        assert 0.5 * (emp - p).abs().sum().item() < 0.02
        assert abs((n_acc == 2).float().mean().item() - p[d].item()) < 0.02


# ---------------------------------------------------------------------------
# single-stream speculation: generate_speculative, generate_stream_speculative
# ---------------------------------------------------------------------------
#
# Against JAX's on the debug models (weights carried across): tokens equal up
# to each row's first near-tie, a position whose top-2 logits, teacher-forced
# through the port's forward without a cache, lie within LOGIT_TIE (the
# largest |logit| difference between the packages on these models, 0.031
# and 0.016, rounded up: test_torch_search); the chunk count too where no
# row meets one (the chunks follow the tokens).  Exact ties of bf16 logits
# are common at these models' widths, so most rows stop early.  Within the port: greedy
# speculation equals greedy generate() up to a near-tie (the verify chunk's
# plain attention and the decode step's round in other orders), as
# tests/test_speculative.py holds JAX's.

LOGIT_TIE = 0.035
_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        jcfg = jget_config(arch)
        jparams = jinit_params(jax.random.PRNGKey(0), jcfg, quantized=True)
        cfg = get_config(arch)
        _MODELS[arch] = (jcfg, jparams, cfg, bridge(jparams, None, cfg)[0])
    return _MODELS[arch]


def _clear_upto(params, cfg, prompt, generated, margin):
    """Generated tokens before the first position whose top-2 logits
    (teacher-forced, no cache) lie within `margin`."""
    ids = torch.tensor([list(prompt) + list(generated)])
    with torch.inference_mode():
        logits = forward(params, None, ids, cfg)[0][0, len(prompt) - 1:-1].float()
    top2 = logits.topk(2, dim=-1).values
    ties = ((top2[:, 0] - top2[:, 1]) <= margin).nonzero()
    return int(ties[0]) if len(ties) else len(generated)


CLEAR_PHRASE = {"debug": [242, 262, 386, 486], "debug-neox": [429, 134, 56, 153]}


def _prompts(kind, vocab, arch="debug"):
    rng = np.random.default_rng(11)
    if kind == "clear":      # a phrase whose 16 greedy tokens have no near-tie
        return [(CLEAR_PHRASE[arch] * 6)[:20]]
    if kind == "repetitive":
        return [([7, 3, 9, 4] * 6)[:20]]
    if kind == "random":
        return [np.random.default_rng(3).integers(1, vocab, size=17).tolist()]
    return [rng.integers(1, vocab, size=9).tolist(), ([2, 8, 2, 8] * 4)[:14]]


def _batch(prompts):
    S = max(len(p) for p in prompts)
    ids = np.zeros((len(prompts), S), np.int32)
    for b, p in enumerate(prompts):
        ids[b, :len(p)] = p
    return ids, np.array([len(p) for p in prompts], np.int32)


SPEC_CASES = {   # prompts, new tokens, draft_len, ngram
    "clear": ("clear", 16, 4, 2),
    "repetitive": ("repetitive", 16, 4, 2),
    "random": ("random", 12, 6, 3),
    "padded-batch": ("padded", 10, 3, 2),
}


@pytest.mark.parametrize("arch", ["debug", "debug-neox"])
@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_generate_speculative_matches_jax(arch, case):
    jcfg, jparams, cfg, params = _model(arch)
    kind, n_new, k, ngram = SPEC_CASES[case]
    prompts = _prompts(kind, cfg.vocab_size, arch)
    ids, lengths = _batch(prompts)
    kw = dict(max_new_tokens=n_new, eos_id=-1 if kind == "clear" else 5, draft_len=k, ngram=ngram, with_stats=True)
    want, jstats = jgenerate_speculative(jparams, None, jnp.asarray(ids), jnp.asarray(lengths),
                                         jcfg, **kw)
    got, stats = generate_speculative(params, None, ids, lengths, cfg, device="cpu", **kw)
    want, got = np.asarray(want), got.numpy()
    assert got.shape == want.shape == (len(prompts), n_new) and got.dtype == np.int32
    clear = True
    for b, p in enumerate(prompts):
        upto = _clear_upto(params, cfg, p, want[b], LOGIT_TIE)
        np.testing.assert_array_equal(got[b, :upto], want[b, :upto])
        clear &= upto == n_new
    if clear:
        assert stats == jstats
    assert clear or kind != "clear"


def _assert_greedy_equiv(params, cfg, prompts, base, spec):
    """Rows equal, or the first difference at a near-tie (0.05, as
    tests/test_speculative.py)."""
    for b, p in enumerate(prompts):
        if (base[b] == spec[b]).all():
            continue
        d = int(np.argmax(base[b] != spec[b]))
        assert _clear_upto(params, cfg, p, base[b, :d + 1], 0.05) <= d, (b, base[b], spec[b])


@pytest.mark.parametrize("arch", ["debug", "debug-neox"])
@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_spec_matches_greedy(arch, case):
    """Counterparts of tests/test_speculative.py's repetitive, random and
    padded-batch cases: speculation changes how many forwards run, not the
    greedy tokens."""
    _, _, cfg, params = _model(arch)
    kind, n_new, k, ngram = SPEC_CASES[case]
    prompts = _prompts(kind, cfg.vocab_size, arch)
    ids, lengths = _batch(prompts)
    base = generate(params, None, ids, lengths, cfg, max_new_tokens=n_new, eos_id=5,
                    max_len=ids.shape[1] + n_new + k + 1, device="cpu").numpy()
    spec, stats = generate_speculative(params, None, ids, lengths, cfg, max_new_tokens=n_new,
                                       eos_id=5, draft_len=k, ngram=ngram, with_stats=True,
                                       device="cpu")
    _assert_greedy_equiv(params, cfg, prompts, base, spec.numpy())
    assert 1 <= stats["chunks"] <= n_new


def test_spec_accepts_drafts_on_repetitive_text():
    """A prompt that repeats a phrase whose continuation the model repeats
    too: chunks retire more than one token each."""
    _, _, cfg, params = _model("debug")
    prompt = ([7, 3, 9, 4] * 6)[:20]
    _, stats = generate_speculative(params, None, [prompt], [20], cfg, max_new_tokens=16,
                                    eos_id=-1, draft_len=4, with_stats=True, device="cpu")
    assert stats["chunks"] < 15


@pytest.mark.parametrize("arch", ["debug", "debug-neox"])
def test_spec_int8_runs(arch):
    """decode_impl="int8": the chunks on the int8 serving copy; the first
    tokens equal the int8 generate()'s (the first from the exact prefill)."""
    _, _, cfg, params = _model(arch)
    prompt = ([4, 9, 4, 9] * 5)[:16]
    i8 = generate(params, None, [prompt], [16], cfg, max_new_tokens=8, eos_id=-1,
                  decode_impl="int8", device="cpu")
    spec = generate_speculative(params, None, [prompt], [16], cfg, max_new_tokens=8, eos_id=-1,
                                draft_len=4, decode_impl="int8", device="cpu")
    assert spec.shape == i8.shape
    assert torch.equal(spec[0, :2], i8[0, :2])


@pytest.mark.parametrize("arch", ["debug", "debug-neox"])
def test_spec_sampled_reproducible_and_low_temp_matches_greedy(arch):
    _, _, cfg, params = _model(arch)
    prompt = ([6, 2, 9] * 6)[:15]
    kw = dict(max_new_tokens=12, eos_id=5, draft_len=4, device="cpu")
    sp = SamplingParams(do_sample=True, temperature=0.8, top_p=0.95)
    a, b = (generate_speculative(params, None, [prompt], [15], cfg, sparams=sp,
                                 generator=torch.Generator().manual_seed(7), **kw)
            for _ in range(2))
    assert torch.equal(a, b)
    cold = SamplingParams(do_sample=True, temperature=1e-4)
    c = generate_speculative(params, None, [prompt], [15], cfg, sparams=cold,
                             generator=torch.Generator().manual_seed(0), **kw)
    g = generate_speculative(params, None, [prompt], [15], cfg, **kw)
    assert torch.equal(c, g)


def test_spec_sampled_rejects_history_penalties():
    _, _, cfg, params = _model("debug")
    for sp in (SamplingParams(do_sample=True, repetition_penalty=1.3),
               SamplingParams(do_sample=True, no_repeat_ngram_size=2)):
        with pytest.raises(NotImplementedError, match="speculative"):
            generate_speculative(params, None, [[1, 2, 3]], [3], cfg, sparams=sp, device="cpu")
        with pytest.raises(NotImplementedError, match="speculative"):
            next(generate_stream_speculative(params, None, [[1, 2, 3]], [3], cfg, sparams=sp,
                                             device="cpu"))
    with pytest.raises(ValueError, match="only 'int8' or None"):
        generate_speculative(params, None, [[1, 2, 3]], [3], cfg, decode_impl="fp8",
                             device="cpu")
    with pytest.raises(ValueError, match="single-stream"):
        next(generate_stream_speculative(params, None, [[1, 2, 3], [1, 2, 3]], [3, 3], cfg,
                                         device="cpu"))


@pytest.mark.parametrize("arch", ["debug", "debug-neox"])
def test_stream_spec_matches_batch_spec(arch):
    """The stream's host-side drafts (zeros where nothing matches) and the
    batch's in-graph drafts go through the same chunked verify: greedy
    tokens equal bit for bit, the stream stopping at its eos."""
    _, _, cfg, params = _model(arch)
    prompt = ([5, 12, 7, 12] * 5)[:18]
    kw = dict(max_new_tokens=12, eos_id=3, draft_len=4, device="cpu")
    batch = generate_speculative(params, None, [prompt], [18], cfg, **kw).numpy()[0]
    streamed = [int(t[0]) for t in generate_stream_speculative(params, None, [prompt], [18],
                                                               cfg, **kw)]
    assert streamed == batch[:len(streamed)].tolist()
    if len(streamed) < 12:
        assert streamed[-1] == 3 and (batch[len(streamed):] == 3).all()
    for eos in (-1, int(batch[3])):       # to the budget, and cut at an eos inside a chunk
        kw["eos_id"] = eos
        b = generate_speculative(params, None, [prompt], [18], cfg, **kw).numpy()[0]
        s = [int(t[0]) for t in generate_stream_speculative(params, None, [prompt], [18], cfg,
                                                            **kw)]
        assert s == b[:len(s)].tolist() and (len(s) == 12 or s[-1] == eos)
