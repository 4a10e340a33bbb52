"""The bridge from the JAX package's parameter trees to the port's.

``jax_to_numpy`` (used by every ``test_torch_*`` parity test) turns a JAX
params or LoRA tree into the nested numpy dict that
``qlora_tpu_torch.utils.convert`` reads; the tests here check that the
round trip keeps every byte."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from qlora_tpu.lora import LoraConfig as JLoraConfig
from qlora_tpu.models import get_config as jget_config
from qlora_tpu.models import init_params as jinit_params
from qlora_tpu.models.layers import DenseLinear as JDense
from qlora_tpu.models.layers import QLinear as JQLinear
from qlora_tpu.models.transformer import init_lora_params as jinit_lora
from qlora_tpu.quant.blockwise import QuantizedTensor as JQT

from qlora_tpu_torch.models.config import get_config
from qlora_tpu_torch.models.layers import DenseLinear, QLinear
from qlora_tpu_torch.utils.convert import (
    lora_from_numpy, lora_to_numpy, params_from_numpy, to_tensor,
)

torch.set_num_threads(2)


def jax_to_numpy(tree):
    """A JAX params/LoRA tree → nested dicts of numpy arrays (bytes kept)."""
    if tree is None:
        return None
    if isinstance(tree, JQT):
        return {
            "packed": np.asarray(tree.packed), "absmax": np.asarray(tree.absmax),
            "absmax_scale": jax_to_numpy(tree.absmax_scale),
            "absmax_offset": jax_to_numpy(tree.absmax_offset),
            "shape": tuple(tree.shape), "block_size": tree.block_size,
            "quant_type": tree.quant_type,
        }
    if isinstance(tree, JQLinear):
        return {"qt": jax_to_numpy(tree.qt), "bias": jax_to_numpy(tree.bias)}
    if isinstance(tree, JDense):
        return {"w": np.asarray(tree.w), "bias": jax_to_numpy(tree.bias)}
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):          # a per-layer list of blocks
        return [jax_to_numpy(v) for v in tree]
    return np.asarray(tree)


def bridge(jparams, jlora, cfg, device="cpu"):
    """JAX params (and LoRA) → the port's, on `device`."""
    p = params_from_numpy(jax_to_numpy(jparams), cfg, device)
    lo = None if jlora is None else lora_from_numpy(jax_to_numpy(jlora), device)
    return p, lo


def nonzero_lora(cfg, seed=1, r=8):
    """A JAX LoRA tree with B drawn nonzero, so the adapter term shows."""
    lcfg = JLoraConfig(r=r, alpha=16.0)
    lora = jinit_lora(jax.random.PRNGKey(seed), cfg, lcfg)
    rng = np.random.default_rng(seed)
    lora = {n: {"a": ad["a"],
                "b": jnp.asarray(rng.normal(size=ad["b"].shape) * 0.05, jnp.float32)}
            for n, ad in lora.items()}
    return lora, lcfg


def _as_np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    return t.numpy()


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def test_params_round_trip_keeps_bytes():
    jcfg = jget_config("debug-neox")
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg)
    lora, _ = nonzero_lora(jcfg)
    cfg = get_config("debug-neox")
    p, lo = bridge(jparams, lora, cfg)
    assert len(p["blocks"]) == cfg.num_layers == len(lo)
    np.testing.assert_array_equal(_as_np(p["embed"]), _bits(jparams["embed"]))
    for i in range(cfg.num_layers):
        jl = jparams["blocks"]["w_qkv"]
        tl = p["blocks"][i]["w_qkv"]
        assert isinstance(tl, QLinear)
        np.testing.assert_array_equal(tl.qt.packed.numpy(), np.asarray(jl.qt.packed[i]))
        np.testing.assert_array_equal(tl.qt.absmax.numpy(), np.asarray(jl.qt.absmax[i]))
        np.testing.assert_array_equal(tl.qt.absmax_scale.numpy(),
                                      np.asarray(jl.qt.absmax_scale[i]))
        assert tl.qt.absmax_offset.item() == float(jl.qt.absmax_offset[i])
        np.testing.assert_array_equal(tl.bias.numpy(), np.asarray(jl.bias[i]))
        np.testing.assert_array_equal(p["blocks"][i]["ln1"]["scale"].numpy(),
                                      np.asarray(jparams["blocks"]["ln1"]["scale"][i]))
        np.testing.assert_array_equal(lo[i]["wo"]["b"].numpy(),
                                      np.asarray(lora["wo"]["b"][i]))
    assert isinstance(p["lm_head"], DenseLinear)
    np.testing.assert_array_equal(_as_np(p["lm_head"].w), _bits(jparams["lm_head"].w))


def test_to_tensor_bfloat16_bits():
    x = jnp.asarray([1.0, -2.5, 3.140625, 1e-3], jnp.bfloat16)
    t = to_tensor(np.asarray(x))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.uint16).numpy(), np.asarray(x).view(np.uint16))


def test_lora_round_trip_to_the_stacked_layout():
    """Per-layer adapters go back to JAX's L-stacked arrays with every
    value kept, so an adapter trained by the port sets beside JAX's."""
    jcfg = jget_config("debug")
    lora, _ = nonzero_lora(jcfg)
    back = lora_to_numpy(lora_from_numpy(jax_to_numpy(lora), "cpu"))
    assert sorted(back) == sorted(lora)
    for name, ad in lora.items():
        for k in ("a", "b"):
            assert back[name][k].dtype == np.float32
            np.testing.assert_array_equal(back[name][k], np.asarray(ad[k]))
