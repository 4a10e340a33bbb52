"""Port model forward against the JAX package's, on ``debug`` (LLaMA) and
``debug-neox`` (GPT-NeoX), with a nonzero LoRA on every block linear; the
no-cache forward and the cached prefill with its decode steps also on the
other families the presets name: ``debug-gemma`` (GeGLU, (1 + w) RMSNorm,
scaled embeddings, head_dim 32, tied lm_head) and ``debug`` with the qkv
biases of Qwen2, the sliding window of Mistral (5 tokens) or tied
embeddings.

JAX parameters are carried across byte for byte.  Tolerance atol 0.1 on
logits of magnitude ~4: both sides compute the same bf16-rounded
activations with f32 accumulation, but in other summation orders, so an
activation may round one bf16 ulp apart (2^-8 relative, 0.03 at 4) and the
difference carries through two layers.  In the cached prefill the JAX
package's CPU backend computes attention in f32 while the port rounds the
probabilities to bf16, as on the TPU; that stays inside the same bound.
At S = 128 both packages take their flash attention without a cache (JAX:
the Pallas kernel in interpret mode), inside the same bound again."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qlora_tpu.models import forward as jforward
from qlora_tpu.models import get_config as jget_config
from qlora_tpu.models import init_params as jinit_params
from qlora_tpu.models.transformer import init_cache as jinit_cache

from qlora_tpu_torch.lora import (
    LoraConfig, apply_lora, count_lora_params, merge_lora, merge_lora_into_params,
)
from qlora_tpu_torch.models import forward, get_config, init_cache
from qlora_tpu_torch.models.layers import DenseLinear, QLinear
from qlora_tpu_torch.quant import dequantize
from test_torch_convert import bridge, nonzero_lora

torch.set_num_threads(2)
ATOL = 0.1


@pytest.fixture(scope="module", params=["debug", "debug-neox"])
def model(request):
    jcfg = jget_config(request.param)
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg)
    jlora, jlcfg = nonzero_lora(jcfg)
    cfg = get_config(request.param)
    params, lora = bridge(jparams, jlora, cfg)
    lcfg = LoraConfig(r=jlcfg.r, alpha=jlcfg.alpha)
    return (jcfg, jparams, jlora, jlcfg), (cfg, params, lora, lcfg)


# the other families: (preset, the fields changed on both packages' configs)
FAMILIES = {
    "debug-gemma": ("debug-gemma", {}),
    "qwen2-bias": ("debug", {"attention_bias": True}),
    "mistral-window5": ("debug", {"sliding_window": 5}),
    "tied": ("debug", {"tie_word_embeddings": True}),
}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    name, fields = FAMILIES[request.param]
    jcfg = dataclasses.replace(jget_config(name), **fields)
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg)
    jlora, jlcfg = nonzero_lora(jcfg)
    cfg = dataclasses.replace(get_config(name), **fields)
    params, lora = bridge(jparams, jlora, cfg)
    lcfg = LoraConfig(r=jlcfg.r, alpha=jlcfg.alpha)
    return (jcfg, jparams, jlora, jlcfg), (cfg, params, lora, lcfg)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j, np.float32), atol=ATOL, rtol=0)


def test_forward_no_cache(model):
    _no_cache(model)


def test_family_forward_no_cache(family):
    _no_cache(family)
    (_, jp, _, _), (cfg, p, _, _) = family
    head = p["blocks"][0]["wq"]
    assert (head.bias is not None) == cfg.attention_bias
    if cfg.tie_word_embeddings:        # the lm_head a copy of embed^T, as JAX makes it
        assert torch.equal(p["lm_head"].w, p["embed"].T)


def _no_cache(model):
    (jcfg, jp, jl, jlc), (cfg, p, lo, lc) = model
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.int32)
    mask[1, 9:] = 0                                     # right padding
    want, _ = jforward(jp, jl, jnp.asarray(ids), jcfg, jlc, attn_mask=jnp.asarray(mask))
    got, cache = forward(p, lo, torch.from_numpy(ids), cfg, lc,
                         attn_mask=torch.from_numpy(mask))
    assert cache is None and got.dtype == torch.float32
    assert got.shape == (2, 12, cfg.vocab_size)
    _close(got, want)


def test_cached_prefill_then_decode(model):
    """Prefill 12 tokens into a 128-slot cache (so JAX's decode runs its
    Pallas kernel), then 3 decode steps; logits and caches agree."""
    _prefill_then_decode(model)


def test_family_cached_prefill_then_decode(family):
    """The same on the other families, one decode step (the 5-token window
    slides past the first tokens within the 12; each JAX decode step runs
    its Pallas kernel in interpret mode, seconds a step)."""
    _prefill_then_decode(family, steps=1)


def _prefill_then_decode(model, steps=3):
    (jcfg, jp, jl, jlc), (cfg, p, lo, lc) = model
    rng = np.random.default_rng(1)
    ids = rng.integers(0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    jc = jinit_cache(jcfg, 2, 128)
    want, jc = jforward(jp, jl, jnp.asarray(ids), jcfg, jlc, cache=jc)
    tc = init_cache(cfg, 2, 128, device="cpu")
    got, tc = forward(p, lo, torch.from_numpy(ids), cfg, lc, cache=tc)
    _close(got, want)
    for _ in range(steps):
        tok = rng.integers(0, cfg.vocab_size, size=(2, 1)).astype(np.int32)
        want, jc = jforward(jp, jl, jnp.asarray(tok), jcfg, jlc, cache=jc)
        got, tc = forward(p, lo, torch.from_numpy(tok), cfg, lc, cache=tc)
        _close(got, want)
        np.testing.assert_array_equal(tc["length"].numpy(), np.asarray(jc["length"]))
    # cached K of the last layer: same bf16 values up to the rounding above
    np.testing.assert_allclose(tc["k"][-1].float().numpy(),
                               np.asarray(jc["k"][-1], np.float32), atol=ATOL)


def test_config_presets_match_jax():
    """The port keeps its own copy of the presets; every one must equal the
    JAX package's, field by field."""
    import dataclasses

    from qlora_tpu.models import config as jconfig
    from qlora_tpu_torch.models import config as tconfig

    assert sorted(tconfig.PRESETS) == sorted(jconfig.PRESETS)
    for name in jconfig.PRESETS:
        assert (dataclasses.asdict(tconfig.get_config(name))
                == dataclasses.asdict(jconfig.get_config(name))), name


@pytest.mark.parametrize("use_flash", ["auto", "always", "never"])
def test_forward_no_cache_flash_gate(model, use_flash):
    """S = 128, head_dim 64: "auto" and "always" go through flash attention
    on both sides, "never" through the plain softmax; right padding and a
    full row."""
    (jcfg, jp, jl, jlc), (cfg, p, lo, lc) = model
    ids = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(2, 128)).astype(np.int32)
    mask = np.ones((2, 128), np.int32)
    mask[1, 77:] = 0
    want, _ = jforward(jp, jl, jnp.asarray(ids), jcfg, jlc, attn_mask=jnp.asarray(mask),
                       use_flash=use_flash)
    got, cache = forward(p, lo, torch.from_numpy(ids), cfg, lc,
                         attn_mask=torch.from_numpy(mask), use_flash=use_flash)
    assert cache is None and got.shape == (2, 128, cfg.vocab_size)
    real = mask.astype(bool)                 # padded queries carry no meaning
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want, np.float32)[real],
                               atol=ATOL, rtol=0)


def test_flash_always_takes_any_length(model):
    """"always" at S = 12 (the TPU kernel needs 128-multiples): the port's
    flash path agrees with its own plain-softmax path."""
    _, (cfg, p, lo, lc) = model
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, size=(2, 12)))
    mask = torch.ones(2, 12, dtype=torch.int32)
    mask[0, 9:] = 0
    a, _ = forward(p, lo, ids, cfg, lc, attn_mask=mask, use_flash="always")
    b, _ = forward(p, lo, ids, cfg, lc, attn_mask=mask, use_flash="never")
    real = mask.bool()
    torch.testing.assert_close(a[real], b[real], atol=ATOL, rtol=0)


def test_lora_dropout_keeps_and_scales():
    """Of 200k entries a Bernoulli(0.75) mask keeps 75 % to within 1 %
    (5 sigma is 0.5 %); the kept ones are scaled by 1/0.75; without a
    generator, or at p = 0, nothing is dropped."""
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(400, 500, dtype=torch.bfloat16)
    eye = {"a": torch.eye(500), "b": torch.eye(500)}
    y = apply_lora(x, eye, 1.0, dropout=0.25, generator=gen).float()
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.75), rtol=1e-2, atol=0)
    y2 = apply_lora(x, eye, 1.0, dropout=0.25, generator=gen).float()
    assert not torch.equal(y2 != 0, kept)            # a fresh mask on every call
    assert (apply_lora(x, eye, 1.0, dropout=0.25).float() == 1).all()
    assert (apply_lora(x, eye, 1.0, dropout=0.0, generator=gen).float() == 1).all()
    assert LoraConfig().dropout == 0.0 and LoraConfig(r=8, alpha=16, dropout=0.1).scale == 2.0


def test_forward_dropout_masks_differ_by_linear_and_repeat_by_seed(model):
    _, (cfg, p, lo, lc) = model
    import dataclasses

    lcd = dataclasses.replace(lc, dropout=0.5)
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, size=(1, 8)))
    run = lambda seed: forward(p, lo, ids, cfg, lcd,
                               generator=torch.Generator().manual_seed(seed))[0]
    base, _ = forward(p, lo, ids, cfg, lc)
    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))
    assert not torch.equal(run(1), base)
    assert torch.equal(forward(p, lo, ids, cfg, lcd)[0], base)     # no generator: no dropout


@pytest.mark.parametrize("requantize", [True, False])
def test_merge_lora_into_params_matches_jax(model, requantize):
    """Merged weights against JAX's: f32 A@B in another order, then bf16 or
    NF4 again.  Kept dense: within one bf16 ulp (rtol 2^-7).  Requantized:
    the decoded weights within 2 % of the largest |weight| (a value that
    sits on a code boundary may take the neighbouring code; the mean
    difference stays below 1e-4 of the largest |weight|)."""
    from qlora_tpu.lora import merge_lora_into_params as jmerge
    from qlora_tpu.quant import dequantize as jdequantize

    (jcfg, jp, jl, jlc), (cfg, p, lo, lc) = model
    want = jmerge(jp, jl, jlc, requantize=requantize)
    got = merge_lora_into_params(p, lo, lc, requantize=requantize)
    assert got is not p and got["embed"] is p["embed"]
    for name in lo[0]:
        for i in range(cfg.num_layers):
            lin = got["blocks"][i][name]
            jlin = jax.tree_util.tree_map(lambda a: a[i], want["blocks"][name])
            assert p["blocks"][i][name] is not lin
            if requantize:
                assert isinstance(lin, QLinear)
                w = dequantize(lin.qt, torch.float32).numpy()
                jw = np.asarray(jdequantize(jlin.qt, jnp.float32))
                top = np.abs(jw).max()
                assert np.abs(w - jw).max() <= 0.02 * top
                assert np.abs(w - jw).mean() <= 1e-4 * top
            else:
                assert isinstance(lin, DenseLinear) and lin.w.dtype == torch.bfloat16
                np.testing.assert_allclose(lin.w.float().numpy(),
                                           np.asarray(jlin.w, np.float32), rtol=2 ** -7,
                                           atol=1e-6)
    # the merged dense model computes what base + adapter computed
    if not requantize:
        ids = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 12)))
        a, _ = forward(got, None, ids, cfg)
        b, _ = forward(p, lo, ids, cfg, lc)
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)
    assert count_lora_params(lo) == sum(int(np.prod(x.shape))
                                        for x in jax.tree_util.tree_leaves(jl))
    w = torch.randn(16, 8, generator=torch.Generator().manual_seed(0))
    ad = {"a": torch.ones(16, 2), "b": torch.ones(2, 8)}
    torch.testing.assert_close(merge_lora(w, ad, 0.5), w + 1.0)
