"""Port model forward against the JAX package's, on ``debug`` (LLaMA) and
``debug-neox`` (GPT-NeoX), with a nonzero LoRA on every block linear.

JAX parameters are carried across byte for byte.  Tolerance atol 0.1 on
logits of magnitude ~4: both sides compute the same bf16-rounded
activations with f32 accumulation, but in other summation orders, so an
activation may round one bf16 ulp apart (2^-8 relative, 0.03 at 4) and the
difference carries through two layers.  In the cached prefill the JAX
package's CPU backend computes attention in f32 while the port rounds the
probabilities to bf16, as on the TPU; that stays inside the same bound."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qlora_tpu.models import forward as jforward
from qlora_tpu.models import get_config as jget_config
from qlora_tpu.models import init_params as jinit_params
from qlora_tpu.models.transformer import init_cache as jinit_cache

from qlora_tpu_torch.lora import LoraConfig
from qlora_tpu_torch.models import forward, get_config, init_cache
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


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j, np.float32), atol=ATOL, rtol=0)


def test_forward_no_cache(model):
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
    (jcfg, jp, jl, jlc), (cfg, p, lo, lc) = model
    rng = np.random.default_rng(1)
    ids = rng.integers(0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    jc = jinit_cache(jcfg, 2, 128)
    want, jc = jforward(jp, jl, jnp.asarray(ids), jcfg, jlc, cache=jc)
    tc = init_cache(cfg, 2, 128, device="cpu")
    got, tc = forward(p, lo, torch.from_numpy(ids), cfg, lc, cache=tc)
    _close(got, want)
    for _ in range(3):
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
