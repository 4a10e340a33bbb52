"""The port's HF importer against the JAX package's and against
transformers' own forward (``qlora_tpu_torch/utils/hf_import.py``), on the
tiny LLaMA, GPT-NeoX, Mistral, Qwen2 and Gemma models of
``tests/test_hf_import.py``, which transformers builds from a config in the
test (no download).

Held: ``read_hf_config`` equal; a dense import bit for bit equal to JAX's;
a quantized import equal to JAX's in the packed nibbles and every dense
leaf, its double-quantized absmax as ROADMAP's double-quant note allows
(the mean offset is a float reduction whose last bit depends on summation
order: offsets within 1e-6 relative, meta-scales, a largest |absmax -
offset|, within 1e-6 of the offset, int8 absmax codes at most 1 apart); logits of the dense import against transformers' within the
JAX test's tolerances (0.15 LLaMA and NeoX, 0.2 the others); the
safetensors reader bit for bit equal to ``safe_open``; a ``.bin``
checkpoint read as the safetensors one; both padding options no-ops."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from qlora_tpu.utils.hf_import import load_hf_model as jload_hf_model  # noqa: E402
from qlora_tpu.utils.hf_import import read_hf_config as jread_hf_config  # noqa: E402

from qlora_tpu_torch.models import ModelConfig, forward  # noqa: E402
from qlora_tpu_torch.models.layers import QLinear  # noqa: E402
from qlora_tpu_torch.utils import (  # noqa: E402
    load_hf_model, params_from_numpy, read_hf_config, read_safetensors,
)
from test_torch_convert import jax_to_numpy  # noqa: E402

torch.set_num_threads(2)

FAMILIES = {
    "llama": (transformers.LlamaConfig, transformers.LlamaForCausalLM, 0.15, dict(
        vocab_size=256, hidden_size=256, intermediate_size=384, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
        rms_norm_eps=1e-5, tie_word_embeddings=False)),
    "neox": (transformers.GPTNeoXConfig, transformers.GPTNeoXForCausalLM, 0.15, dict(
        vocab_size=256, hidden_size=128, intermediate_size=512, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=128, rotary_pct=0.25,
        use_parallel_residual=True, layer_norm_eps=1e-5)),
    "mistral": (transformers.MistralConfig, transformers.MistralForCausalLM, 0.2, dict(
        vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
        sliding_window=8)),
    "qwen2": (transformers.Qwen2Config, transformers.Qwen2ForCausalLM, 0.2, dict(
        vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
        tie_word_embeddings=False)),
    "gemma": (transformers.GemmaConfig, transformers.GemmaForCausalLM, 0.2, dict(
        vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=64,
        max_position_embeddings=128, hidden_activation="gelu_pytorch_tanh")),
}
IDS = np.array([[1, 5, 9, 2, 7, 3, 11, 4, 13, 8, 6, 10]], dtype=np.int32)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    out = {}
    for seed, (name, (cfg_cls, model_cls, atol, kw)) in enumerate(FAMILIES.items()):
        d = tmp_path_factory.mktemp(f"hf_{name}")
        torch.manual_seed(seed)
        model = model_cls(cfg_cls(**kw)).eval()
        model.save_pretrained(d)
        out[name] = (str(d), model, atol)
    return out


def _as_port(jparams, cfg):
    return params_from_numpy(jax_to_numpy(jparams), cfg, "cpu")


def _bits(t):
    t = t.detach()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _walk(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _walk(getattr(tree, f.name), f"{prefix}/{f.name}")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}/{i}")


def _leaves(tree):
    return dict(_walk(tree))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_read_hf_config_is_jax_s(models, family):
    path = models[family][0]
    assert dataclasses.asdict(read_hf_config(path)) == dataclasses.asdict(jread_hf_config(path))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_dense_import_is_jax_s_bit_for_bit(models, family):
    path = models[family][0]
    params, cfg = load_hf_model(path, quantize_base=False, device="cpu")
    jparams, jcfg = jload_hf_model(path, quantize_base=False)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    mine, theirs = _leaves(params), _leaves(_as_port(jparams, cfg))
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        assert mine[k].dtype == theirs[k].dtype and mine[k].shape == theirs[k].shape, k
        assert torch.equal(_bits(mine[k]), _bits(theirs[k])), k


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("quant_type,double_quant", [("nf4", True), ("nf4", False),
                                                      ("int8", True)])
def test_quantized_import_is_jax_s(models, family, quant_type, double_quant):
    path = models[family][0]
    kw = dict(quantize_base=True, quant_type=quant_type, double_quant=double_quant)
    params, cfg = load_hf_model(path, device="cpu", **kw)
    jparams, _ = jload_hf_model(path, **kw)
    mine, theirs = _leaves(params), _leaves(_as_port(jparams, cfg))
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        a, b = mine[k], theirs[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if k.endswith("/absmax") and double_quant:
            assert (a.int() - b.int()).abs().max() <= 1, k
        elif k.endswith("/absmax_offset"):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, err_msg=k)
        elif k.endswith("/absmax_scale"):     # max |absmax - offset|: moves with the offset
            off = abs(float(mine[k.replace("_scale", "_offset")]))
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6 * off, err_msg=k)
        else:
            assert torch.equal(_bits(a), _bits(b)), k
    assert isinstance(params["blocks"][0]["wo"], QLinear)
    assert params["blocks"][0]["wo"].qt.quant_type == quant_type


def _logits(params, cfg):
    return forward(params, None, torch.from_numpy(IDS), cfg)[0].numpy()


def _hf_logits(model):
    with torch.no_grad():
        return model(torch.tensor(IDS, dtype=torch.long)).logits.float().numpy()


@pytest.mark.parametrize("family", list(FAMILIES))
def test_logits_match_transformers(models, family):
    """As the JAX test: max |logits - HF's| under its tolerance, and the
    argmax's HF logit within twice that of HF's maximum."""
    path, model, atol = models[family]
    params, cfg = load_hf_model(path, quantize_base=False, device="cpu")
    ours, ref = _logits(params, cfg), _hf_logits(model)
    assert np.abs(ours - ref).max() < atol
    pick = np.take_along_axis(ref, ours.argmax(-1)[..., None], axis=-1)[..., 0]
    assert (ref.max(-1) - pick < 2 * atol).all()


def test_safetensors_reader_is_safe_open_bit_for_bit(models, tmp_path):
    """Every tensor of every fixture's file, and a file of bf16, f16, int
    and bool tensors, equal to ``safe_open``'s."""
    from safetensors import safe_open
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(0)
    extra = {"bf16": torch.randn(3, 5, generator=g).to(torch.bfloat16),
             "f16": torch.randn(7, generator=g).to(torch.float16),
             "i64": torch.arange(6, dtype=torch.int64).reshape(2, 3),
             "i8": torch.tensor([-128, 0, 127], dtype=torch.int8),
             "u8": torch.tensor([0, 255], dtype=torch.uint8),
             "b": torch.tensor([True, False]), "scalar": torch.tensor(2.5)}
    save_file(extra, str(tmp_path / "x.safetensors"), metadata={"format": "pt"})
    files = [f"{path}/model.safetensors" for path, _, _ in models.values()]
    for f in files + [str(tmp_path / "x.safetensors")]:
        mine = read_safetensors(f)
        with safe_open(f, framework="pt") as h:
            assert sorted(mine) == sorted(h.keys())
            for k in h.keys():
                want = h.get_tensor(k)
                got = mine[k]
                assert tuple(got.shape) == tuple(want.shape), (f, k)
                if want.dtype == torch.bfloat16:
                    assert got.dtype == np.uint16
                    np.testing.assert_array_equal(got.view(np.int16),
                                                  want.view(torch.int16).numpy())
                else:
                    np.testing.assert_array_equal(got, want.numpy())


def test_bin_checkpoint_reads_as_the_safetensors_one(models, tmp_path):
    path, model, _ = models["llama"]
    d = tmp_path / "bin"
    model.save_pretrained(d, safe_serialization=False)
    assert not list(d.glob("*.safetensors")) and list(d.glob("pytorch_model*.bin"))
    a, cfg = load_hf_model(str(d), quantize_base=False, device="cpu")
    b, _ = load_hf_model(path, quantize_base=False, device="cpu")
    jb, _ = jload_hf_model(str(d), quantize_base=False)
    mine, other, theirs = _leaves(a), _leaves(b), _leaves(_as_port(jb, cfg))
    assert sorted(mine) == sorted(other) == sorted(theirs)
    for k in mine:
        assert torch.equal(_bits(mine[k]), _bits(other[k])), k
        assert torch.equal(_bits(mine[k]), _bits(theirs[k])), k


def test_no_weights_raises(tmp_path):
    (tmp_path / "config.json").write_text('{"model_type": "llama"}')
    with pytest.raises(FileNotFoundError, match="no safetensors"):
        load_hf_model(str(tmp_path), ModelConfig(
            arch="llama", vocab_size=8, hidden_size=8, intermediate_size=8, num_layers=1,
            num_heads=1, num_kv_heads=1), device="cpu")


def test_pad_intermediate_is_a_no_op(models):
    path, model, atol = models["llama"]
    params, cfg = load_hf_model(path, quantize_base=False, pad_intermediate_to=256, device="cpu")
    assert cfg.intermediate_size == 512
    assert params["blocks"][0]["w_down"].w.shape == (512, 256)
    base, bcfg = load_hf_model(path, quantize_base=False, device="cpu")
    assert np.abs(_logits(params, cfg) - _hf_logits(model)).max() < atol
    np.testing.assert_allclose(_logits(params, cfg), _logits(base, bcfg), atol=1e-5)


def test_pad_vocab_is_a_no_op(models):
    path, _, _ = models["llama"]
    params, cfg = load_hf_model(path, quantize_base=False, pad_vocab_to=384, device="cpu")
    assert cfg.vocab_size == 256
    assert params["lm_head"].w.shape[-1] == 384 and params["embed"].shape[0] == 384
    base, _ = load_hf_model(path, quantize_base=False, device="cpu")
    got, want = _logits(params, cfg), _logits(base, cfg)
    assert got.shape[-1] == cfg.vocab_size
    np.testing.assert_array_equal(got, want)
    jp, jcfg = jload_hf_model(path, quantize_base=False, pad_vocab_to=384)
    assert np.asarray(jp["lm_head"].w).shape == tuple(params["lm_head"].w.shape)


def test_load_hf_model_raises_without_a_device(models, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_hf_model(models["llama"][0])
