"""Port generation engine and sampler against the JAX package's.

* Teacher-forced decode (as tests/test_generate.py does): both engines
  prefill the same right-padded prompts, then consume the same token
  stream; logits agree within atol 0.1 (see test_torch_model for why) and
  on the argmax wherever the decision margin exceeds twice that.
* Sampling draws differ between jax.random and torch.Generator, so the
  sampler is compared on its masks and its greedy choice over the same
  numpy logits (exact: the same f32 operations on the same values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qlora_tpu.generate.engine import generate as jgenerate
from qlora_tpu.generate.engine import generate_stream as jgenerate_stream
from qlora_tpu.generate.engine import prefill as jprefill
from qlora_tpu.generate.serve_int8 import (
    requantize_params_int8_unstacked as jrequantize_unstacked,
)
from qlora_tpu.generate import sampler as jsampler
from qlora_tpu.models import forward as jforward
from qlora_tpu.models import get_config as jget_config
from qlora_tpu.models import init_params as jinit_params
from qlora_tpu.models.transformer import init_cache as jinit_cache
from qlora_tpu.models.unstack import unstack_cache, unstack_lora
from qlora_tpu.ops.qmatmul import default_impl as jdefault_impl

from qlora_tpu_torch.generate import (
    SamplingParams, apply_repetition_penalty, ban_repeated_ngrams, generate,
    generate_stream, prefill, sample_token, top_k_mask, top_p_mask, typical_p_mask,
)
from qlora_tpu_torch.lora import LoraConfig
from qlora_tpu_torch.models import forward, get_config, init_cache, init_params
from qlora_tpu_torch.ops import default_impl
from test_torch_convert import bridge, nonzero_lora

torch.set_num_threads(2)
ATOL = 0.1


@pytest.fixture(scope="module")
def model():
    jcfg = jget_config("debug")
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg)
    jlora, jlcfg = nonzero_lora(jcfg)
    cfg = get_config("debug")
    params, lora = bridge(jparams, jlora, cfg)
    return (jcfg, jparams, jlora, jlcfg), (cfg, params, lora,
                                           LoraConfig(r=jlcfg.r, alpha=jlcfg.alpha))


def test_teacher_forced_decode_matches_jax(model):
    (jcfg, jp, jl, jlc), (cfg, p, lo, lc) = model
    ids = np.array([[3, 17, 5, 9, 11], [4, 7, 0, 0, 0]], np.int32)
    lengths = np.array([5, 2], np.int32)
    T = 5 + 4
    jlog, jc = jprefill(jp, jl, jnp.asarray(ids), jnp.asarray(lengths), jcfg, jlc,
                        cache=jinit_cache(jcfg, 2, T))
    tlog, tc = prefill(p, lo, torch.from_numpy(ids), torch.from_numpy(lengths), cfg, lc,
                       cache=init_cache(cfg, 2, T, device="cpu"))
    for _ in range(4):
        ref = np.asarray(jlog, np.float32)
        np.testing.assert_allclose(tlog.numpy(), ref, atol=ATOL, rtol=0)
        top2 = np.sort(ref, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * ATOL
        want = ref.argmax(-1)
        np.testing.assert_array_equal(tlog.numpy().argmax(-1)[clear], want[clear])
        np.testing.assert_array_equal(tc["length"].numpy(), np.asarray(jc["length"]))
        tok = want.astype(np.int32)[:, None]        # teacher-force JAX's choice
        jlog, jc = jforward(jp, jl, jnp.asarray(tok), jcfg, jlc, cache=jc)
        tlog, tc = forward(p, lo, torch.from_numpy(tok), cfg, lc, cache=tc)
        jlog, tlog = jlog[:, 0], tlog[:, 0]


def test_generate_padding_stream_and_stops(model):
    _, (cfg, p, lo, lc) = model
    ids = torch.tensor([[3, 17, 5, 9], [4, 7, 0, 0]])
    lengths = torch.tensor([4, 2])
    kw = dict(max_new_tokens=4, eos_id=-1, device="cpu")
    toks = generate(p, lo, ids, lengths, cfg, lc, **kw)
    assert toks.shape == (2, 4) and toks.dtype == torch.int32
    solo = generate(p, lo, ids[1:, :2], lengths[1:], cfg, lc, **kw)
    assert torch.equal(toks[1], solo[0])           # padding does not leak
    stream = np.stack(list(generate_stream(p, lo, ids, lengths, cfg, lc, **kw)), 1)
    np.testing.assert_array_equal(stream, toks.numpy())
    # eos = row 0's first token: row 0 stops at once and pads with eos;
    # with min_new_tokens=2 it may not stop before its third token
    eos = int(toks[0, 0])
    stopped = generate(p, lo, ids, lengths, cfg, lc, max_new_tokens=4, eos_id=eos,
                       device="cpu")
    assert (stopped[0] == eos).all()
    held = generate(p, lo, ids, lengths, cfg, lc, max_new_tokens=4, eos_id=eos,
                    min_new_tokens=2, device="cpu")
    assert (held[:, :2] != eos).all()


def test_entry_points_need_a_device_or_cuda(model):
    _, (cfg, p, lo, lc) = model
    ids, lengths = torch.tensor([[3, 4]]), torch.tensor([2])
    if not torch.cuda.is_available():
        for call in (lambda: init_params(cfg, 0), lambda: init_cache(cfg, 1, 8),
                     lambda: generate(p, lo, ids, lengths, cfg, lc, max_new_tokens=1)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
    for kw in (dict(num_beams=2), dict(penalty_alpha=0.6),
               dict(decode_impl="int8", num_beams=2),
               dict(decode_impl="int8", penalty_alpha=0.6)):
        with pytest.raises(NotImplementedError):
            generate(p, lo, ids, lengths, cfg, lc, max_new_tokens=1, device="cpu", **kw)
    with pytest.raises(ValueError, match="only 'int8' or None"):
        generate(p, lo, ids, lengths, cfg, lc, max_new_tokens=1, device="cpu",
                 decode_impl="fp8")
    with pytest.raises(ValueError, match="only 'int8' or None"):
        next(generate_stream(p, lo, ids, lengths, cfg, lc, max_new_tokens=1, device="cpu",
                             decode_impl="fp8"))
    with pytest.raises(ValueError, match="params live on"):
        generate(p, lo, ids, lengths, cfg, lc, max_new_tokens=1, device="meta")


def test_int8_teacher_forced_decode_matches_jax(model):
    """The token loop's step on the int8 serving tree under
    ``default_impl("w8a8")``, fed the same tokens on both sides (JAX runs its
    int8 kernels in interpret mode).  Logits within atol 0.2 of JAX's, twice
    the exact path's: where the two packages' bf16 activations differ by an
    ulp, an int8 code of the row moves by a whole step (1/127 of the row's
    largest value), which the exact path does not have.  And within 5 % of
    the largest |logit| of the port's exact path, from which they must differ
    (the int8 path ran)."""
    (jcfg, jp, jl, jlc), (cfg, p, lo, lc) = model
    ids = np.array([[3, 1, 4, 1, 5], [4, 7, 0, 0, 0]], np.int32)
    lengths = np.array([5, 2], np.int32)
    jdec = jrequantize_unstacked(jp)
    dec, _ = bridge(jdec, None, cfg)
    jlog, jc = jprefill(jp, jl, jnp.asarray(ids), jnp.asarray(lengths), jcfg, jlc,
                        cache=jinit_cache(jcfg, 2, 8))
    tlog, tc = prefill(p, lo, torch.from_numpy(ids), torch.from_numpy(lengths), cfg, lc,
                       cache=init_cache(cfg, 2, 8, device="cpu"))
    jl_list, jc = unstack_lora(jl, jcfg.num_layers), unstack_cache(jc)
    for _ in range(3):
        tok = np.asarray(jlog, np.float32).argmax(-1).astype(np.int32)[:, None]
        with jdefault_impl("w8a8"):
            jlog, jc = jforward(jdec, jl_list, jnp.asarray(tok), jcfg, jlc, cache=jc)
        exact_cache = dict(tc, k=[t.clone() for t in tc["k"]], v=[t.clone() for t in tc["v"]])
        exact, _ = forward(p, lo, torch.from_numpy(tok), cfg, lc, cache=exact_cache)
        with default_impl("w8a8"):
            tlog, tc = forward(dec, lo, torch.from_numpy(tok), cfg, lc, cache=tc)
        jlog, tlog = jlog[:, 0], tlog[:, 0]
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog, np.float32), atol=2 * ATOL,
                                   rtol=0)
        d = (tlog - exact[:, 0]).abs().max().item()
        assert 0 < d < 0.05 * exact.abs().max().item()


def test_generate_int8_decode_matches_jax(model):
    """``generate(decode_impl="int8")`` against JAX's, with the serving tree
    built by JAX and carried across and with the one the port builds itself.
    As tests/test_generate.py bounds it (same prompt, no adapter): the first
    greedy steps agree with JAX's and with the exact path; a later near-tie
    may flip under the int8 path's logit noise."""
    (jcfg, jp, _, _), (cfg, p, _, _) = model
    ids = np.array([[3, 1, 4, 1, 5]], np.int32)
    lengths = np.array([5], np.int32)
    jdec = jrequantize_unstacked(jp)
    jkw = dict(max_new_tokens=6, eos_id=-1, decode_impl="int8", decode_params=jdec)
    want = np.asarray(jgenerate(jp, None, jnp.asarray(ids), jnp.asarray(lengths), jcfg, **jkw))
    dec, _ = bridge(jdec, None, cfg)
    assert dec["lm_head"].qt.quant_type == "int8" and dec["lm_head"].qt.packed.shape[1] == 1024
    kw = dict(max_new_tokens=6, eos_id=-1, device="cpu", decode_impl="int8")
    tids, tlen = torch.from_numpy(ids), torch.from_numpy(lengths)
    carried = generate(p, None, tids, tlen, cfg, decode_params=dec, **kw).numpy()
    own = generate(p, None, tids, tlen, cfg, **kw).numpy()            # requantizes itself
    exact = generate(p, None, tids, tlen, cfg, max_new_tokens=6, eos_id=-1,
                     device="cpu").numpy()
    assert carried.shape == want.shape == (1, 6)
    np.testing.assert_array_equal(carried, own)          # the same tree, byte for byte
    np.testing.assert_array_equal(carried[:, :2], want[:, :2])
    np.testing.assert_array_equal(carried[:, :2], exact[:, :2])
    assert ((carried >= 0) & (carried < cfg.vocab_size)).all()
    # streaming: the same serving copy reused through decode_params
    stream = np.stack(list(generate_stream(p, None, tids, tlen, cfg, decode_params=dec,
                                           **kw)), 1)
    np.testing.assert_array_equal(stream, carried)
    jstream = [int(t[0]) for t in jgenerate_stream(
        jp, None, jnp.asarray(ids), jnp.asarray(lengths), jcfg, max_new_tokens=2,
        eos_id=-1, decode_impl="int8", decode_params=jdec)]
    assert jstream == stream[0, :2].tolist()


@pytest.fixture(scope="module")
def model8():
    """The debug model over an int8-stored base (``--bits 8``: blockwise int8
    codes, double-quantized absmax) with a nonzero LoRA, made by JAX and
    carried across (``utils/convert.py: params_from_numpy``)."""
    jcfg = jget_config("debug")
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg, quant_type="int8")
    jlora, jlcfg = nonzero_lora(jcfg)
    cfg = get_config("debug")
    params, lora = bridge(jparams, jlora, cfg)
    assert params["blocks"][0]["wq"].qt.packed.dtype == torch.int8
    return (jcfg, jparams, jlora, jlcfg), (cfg, params, lora,
                                           LoraConfig(r=jlcfg.r, alpha=jlcfg.alpha))


def test_generate_over_int8_base_matches_jax(model8):
    """``generate()`` over the int8 base against JAX's (its int8 kernels in
    interpret mode): teacher-forced along JAX's tokens, the prefill's and
    every decode step's logits within ATOL of JAX's (bf16 activations
    rounded in other orders, as the NF4 base's test), and the greedy tokens
    equal to JAX's at every step up to a row's first near-tie, a step where
    JAX's top two logits lie within 2 * ATOL and that rounding may flip."""
    (jcfg, jp, jl, jlc), (cfg, p, lo, lc) = model8
    ids = np.array([[3, 17, 5, 9, 11], [4, 7, 0, 0, 0]], np.int32)
    lengths = np.array([5, 2], np.int32)
    new = 6
    want = np.asarray(jgenerate(jp, jl, jnp.asarray(ids), jnp.asarray(lengths), jcfg, jlc,
                                max_new_tokens=new, eos_id=-1))
    got = generate(p, lo, torch.from_numpy(ids), torch.from_numpy(lengths), cfg, lc,
                   max_new_tokens=new, eos_id=-1, device="cpu").numpy()
    assert got.shape == want.shape == (2, new)
    T = 5 + new
    jlog, jc = jprefill(jp, jl, jnp.asarray(ids), jnp.asarray(lengths), jcfg, jlc,
                        cache=jinit_cache(jcfg, 2, T))
    tlog, tc = prefill(p, lo, torch.from_numpy(ids), torch.from_numpy(lengths), cfg, lc,
                       cache=init_cache(cfg, 2, T, device="cpu"))
    tied, compared = np.zeros(2, bool), 0
    for step in range(new):
        ref = np.asarray(jlog, np.float32)
        np.testing.assert_allclose(tlog.numpy(), ref, atol=ATOL, rtol=0)
        top2 = np.sort(ref, axis=-1)[:, -2:]
        tied |= top2[:, 1] - top2[:, 0] <= 2 * ATOL
        np.testing.assert_array_equal(want[:, step], ref.argmax(-1))
        np.testing.assert_array_equal(got[~tied, step], want[~tied, step])
        compared += int((~tied).sum())
        tok = want[:, step:step + 1].astype(np.int32)          # teacher-force JAX's tokens
        jlog, jc = jforward(jp, jl, jnp.asarray(tok), jcfg, jlc, cache=jc)
        tlog, tc = forward(p, lo, torch.from_numpy(tok), cfg, lc, cache=tc)
        jlog, tlog = jlog[:, 0], tlog[:, 0]
    assert compared >= 2                                      # each row's first token at least


def _logits(seed=0, B=3, V=64):
    return np.random.default_rng(seed).normal(size=(B, V)).astype(np.float32) * 3


@pytest.mark.parametrize("k", [0, 1, 5])
@pytest.mark.parametrize("p", [1.0, 0.9, 0.3])
def test_sampler_masks_match_jax(k, p):
    x = _logits(k)
    np.testing.assert_array_equal(top_k_mask(torch.from_numpy(x), k).numpy(),
                                  np.asarray(jsampler.top_k_mask(jnp.asarray(x), k)))
    np.testing.assert_array_equal(top_p_mask(torch.from_numpy(x), p).numpy(),
                                  np.asarray(jsampler.top_p_mask(jnp.asarray(x), p)))
    t_typ = typical_p_mask(torch.from_numpy(x), p).numpy()
    j_typ = np.asarray(jsampler.typical_p_mask(jnp.asarray(x), p))
    np.testing.assert_array_equal(np.isfinite(t_typ), np.isfinite(j_typ))


def test_sampler_penalty_ngrams_and_choice():
    x = _logits(7)
    seen = np.zeros_like(x, bool)
    seen[:, ::3] = True
    np.testing.assert_allclose(
        apply_repetition_penalty(torch.from_numpy(x), torch.from_numpy(seen), 1.3).numpy(),
        np.asarray(jsampler.apply_repetition_penalty(jnp.asarray(x), jnp.asarray(seen), 1.3)),
        rtol=1e-6)
    hist = np.array([[1, 2, 3, 1, 2, 0, 0], [5, 5, 5, 5, 0, 0, 0], [1, 2, 1, 2, 1, 0, 0]],
                    np.int32)
    for cur in (2, 4, 5):
        got = ban_repeated_ngrams(torch.from_numpy(x), torch.from_numpy(hist), cur, 3)
        want = jsampler.ban_repeated_ngrams(jnp.asarray(x), jnp.asarray(hist), cur, 3)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    sp = SamplingParams(repetition_penalty=1.3)
    greedy = sample_token(torch.from_numpy(x), sp, torch.from_numpy(seen))
    np.testing.assert_array_equal(
        greedy.numpy(),
        np.asarray(jsampler.sample_token(jax.random.PRNGKey(0), jnp.asarray(x), sp,
                                         jnp.asarray(seen))))
    # sampling only ever draws tokens the masks keep
    sp = SamplingParams(do_sample=True, temperature=0.7, top_k=4, top_p=0.8)
    allowed = np.isfinite(top_p_mask(top_k_mask(torch.from_numpy(x / 0.7), 4), 0.8).numpy())
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        tok = sample_token(torch.from_numpy(x), sp, generator=g).numpy()
        assert allowed[np.arange(3), tok].all()
