"""HF checkpoint importer: read tensors, quantize on load, the port's params.

Each weight is read from ``*.safetensors`` (or a torch ``pytorch_model*.bin``),
transposed to the ``[in, out]`` convention, quantized on the target device
one tensor at a time (``quant/blockwise.quantize``) and kept per layer, so the
16-bit model is never held on the device at once.

The safetensors reader is the file format itself, with no ``safetensors``
package: an 8-byte little-endian header length, a JSON header of each
tensor's dtype, shape and ``data_offsets``, then the raw bytes, mapped with
numpy (bf16 as its uint16 bit patterns).

Name maps cover the two families:
* LLaMA (also Mistral, Qwen2, Gemma): ``model.layers.{i}.self_attn.{q,k,v,o}_proj``,
  ``mlp.{gate,up,down}_proj``, ``{input,post_attention}_layernorm``,
  ``model.norm``, ``model.embed_tokens``, ``lm_head``;
* GPT-NeoX: ``gpt_neox.layers.{i}.attention.{query_key_value,dense}``,
  ``mlp.dense_{h_to_4h,4h_to_h}``, ``{input,post_attention}_layernorm``,
  ``final_layer_norm``, ``embed_in``, ``embed_out``.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from qlora_tpu_torch import resolve_device
from qlora_tpu_torch.models.config import ModelConfig
from qlora_tpu_torch.models.layers import DenseLinear, QLinear
from qlora_tpu_torch.quant.blockwise import quantize

# safetensors dtype names → numpy (BF16 kept as its bit patterns)
SAFETENSORS_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16, "BF16": np.uint16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8,
    "BOOL": np.bool_,
}


def read_hf_config(path: str) -> ModelConfig:
    with open(os.path.join(path, "config.json")) as f:
        c = json.load(f)
    mt = c.get("model_type")
    if mt in ("llama", "mistral", "qwen2", "gemma"):
        act = c.get("hidden_activation") or c.get("hidden_act", "silu")
        if act in ("gelu_pytorch_tanh", "gelu_new"):
            act = "gelu_tanh"
        return ModelConfig(
            arch="llama",
            vocab_size=c["vocab_size"],
            hidden_size=c["hidden_size"],
            intermediate_size=c["intermediate_size"],
            num_layers=c["num_hidden_layers"],
            num_heads=c["num_attention_heads"],
            num_kv_heads=c.get("num_key_value_heads", c["num_attention_heads"]),
            max_position_embeddings=c.get("max_position_embeddings", 2048),
            rope_theta=c.get("rope_theta", 10000.0),
            norm_eps=c.get("rms_norm_eps", 1e-5),
            tie_word_embeddings=c.get("tie_word_embeddings", mt == "gemma"),
            hidden_act=act,
            sliding_window=c.get("sliding_window"),
            attention_bias=c.get("attention_bias", mt == "qwen2"),
            head_dim_override=c.get("head_dim"),
            norm_plus_one=(mt == "gemma"),
            scale_embeddings=(mt == "gemma"),
        )
    if mt == "gpt_neox":
        return ModelConfig(
            arch="neox",
            vocab_size=c["vocab_size"],
            hidden_size=c["hidden_size"],
            intermediate_size=c.get("intermediate_size", 4 * c["hidden_size"]),
            num_layers=c["num_hidden_layers"],
            num_heads=c["num_attention_heads"],
            num_kv_heads=c["num_attention_heads"],
            max_position_embeddings=c.get("max_position_embeddings", 2048),
            rope_theta=c.get("rotary_emb_base", 10000.0),
            norm_eps=c.get("layer_norm_eps", 1e-5),
            rotary_pct=c.get("rotary_pct", 0.25),
            use_parallel_residual=c.get("use_parallel_residual", True),
            use_bias=True,
            tie_word_embeddings=c.get("tie_word_embeddings", False),
            hidden_act=c.get("hidden_act", "gelu"),
        )
    raise ValueError(f"unsupported model_type {mt!r}")


def read_safetensors(path: str) -> dict:
    """name → numpy array, memory-mapped from one ``.safetensors`` file
    (BF16 as uint16 bit patterns; nothing is read until an array is used)."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)
    out = {}
    for name, info in header.items():
        if info["dtype"] not in SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, which "
                             "the reader does not take")
        begin, end = info["data_offsets"]
        dt = np.dtype(SAFETENSORS_DTYPES[info["dtype"]]).newbyteorder("<")
        out[name] = data[begin:end].view(dt).reshape(info["shape"])
    return out


def _read_tensors(path: str) -> dict:
    """name → array (safetensors, memory-mapped) or tensor (a torch .bin)."""
    st_files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if st_files:
        tensors = {}
        for f in st_files:
            tensors.update(read_safetensors(f))
        return tensors
    bin_files = sorted(glob.glob(os.path.join(path, "pytorch_model*.bin")))
    if not bin_files:
        raise FileNotFoundError(f"no safetensors or .bin weights under {path}")
    tensors = {}
    for f in bin_files:
        tensors.update(torch.load(f, map_location="cpu", weights_only=True))
    return tensors


def _to_f32(a, device) -> torch.Tensor:
    """A stored tensor in f32 on `device` (bf16 bit patterns widened exactly)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    a = np.array(a)                       # out of the memory map
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).to(device).view(torch.bfloat16).float()
    return torch.from_numpy(a).to(device=device, dtype=torch.float32)


def _import_linear(tensors, wname, bname, quantize_base, qkw, device, pad_in=0, pad_out=0):
    w = _to_f32(tensors[wname], device).t()           # HF [out, in] → ours [in, out]
    bias = _to_f32(tensors[bname], device) if bname and bname in tensors else None
    if pad_in or pad_out:
        w = F.pad(w, (0, pad_out, 0, pad_in))
        if bias is not None and pad_out:
            bias = F.pad(bias, (0, pad_out))
    w = w.contiguous()
    if quantize_base:
        return QLinear(qt=quantize(w, **qkw), bias=bias)
    return DenseLinear(w=w.to(torch.bfloat16), bias=bias)


def load_hf_model(
    path: str,
    cfg: Optional[ModelConfig] = None,
    *,
    quantize_base: bool = True,
    quant_type: str = "nf4",
    double_quant: bool = True,
    pad_intermediate_to: Optional[int] = None,
    pad_vocab_to: Optional[int] = None,
    device=None,
) -> tuple[dict, ModelConfig]:
    """Import an HF checkpoint directory into the port's params on `device`
    (CUDA unless the caller names one).  Returns (params, cfg).

    pad_intermediate_to: round the MLP intermediate dim up to a multiple of
    this, zero-padding the weights (a no-op for SwiGLU/GELU MLPs);
    ``cfg.intermediate_size`` becomes the padded size.

    pad_vocab_to: round the vocabulary up to a multiple of this,
    zero-padding lm_head columns and embed rows.  ``forward`` cuts the
    logits back to ``cfg.vocab_size``, which is left unchanged."""
    device = resolve_device(device)
    cfg = cfg or read_hf_config(path)
    pad_inter = 0
    if pad_intermediate_to:
        tgt = -(-cfg.intermediate_size // pad_intermediate_to) * pad_intermediate_to
        pad_inter = tgt - cfg.intermediate_size
        if pad_inter:
            cfg = dataclasses.replace(cfg, intermediate_size=tgt)
    tensors = _read_tensors(path)
    qkw = {"quant_type": quant_type, "double_quant": double_quant}
    f32 = lambda name: _to_f32(tensors[name], device)

    blocks = []
    if cfg.arch == "llama":
        pre = "model.layers."
        lin_map = {
            "wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
            "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
            "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj", "w_down": "mlp.down_proj",
        }
        inter_pad = {"w_gate": (0, pad_inter), "w_up": (0, pad_inter), "w_down": (pad_inter, 0)}
        for i in range(cfg.num_layers):
            b = {name: _import_linear(
                    tensors, f"{pre}{i}.{hf}.weight",
                    f"{pre}{i}.{hf}.bias" if cfg.attention_bias else None,
                    quantize_base, qkw, device, *inter_pad.get(name, (0, 0)))
                 for name, hf in lin_map.items()}
            b["attn_norm"] = f32(f"{pre}{i}.input_layernorm.weight")
            b["mlp_norm"] = f32(f"{pre}{i}.post_attention_layernorm.weight")
            blocks.append(b)
        embed = f32("model.embed_tokens.weight")
        final_norm = {"scale": f32("model.norm.weight")}
        head_name = "lm_head.weight"
        if cfg.tie_word_embeddings or head_name not in tensors:
            head_w = embed.t()
        else:
            head_w = f32(head_name).t()
    else:
        pre = "gpt_neox.layers."
        lin_map = {
            "w_qkv": "attention.query_key_value", "wo": "attention.dense",
            "w_fc": "mlp.dense_h_to_4h", "w_out": "mlp.dense_4h_to_h",
        }
        inter_pad = {"w_fc": (0, pad_inter), "w_out": (pad_inter, 0)}
        for i in range(cfg.num_layers):
            b = {name: _import_linear(
                    tensors, f"{pre}{i}.{hf}.weight", f"{pre}{i}.{hf}.bias",
                    quantize_base, qkw, device, *inter_pad.get(name, (0, 0)))
                 for name, hf in lin_map.items()}
            for ln, hf in (("ln1", "input_layernorm"), ("ln2", "post_attention_layernorm")):
                b[ln] = {"scale": f32(f"{pre}{i}.{hf}.weight"), "bias": f32(f"{pre}{i}.{hf}.bias")}
            blocks.append(b)
        embed = f32("gpt_neox.embed_in.weight")
        final_norm = {"scale": f32("gpt_neox.final_layer_norm.weight"),
                      "bias": f32("gpt_neox.final_layer_norm.bias")}
        head_w = embed.t() if "embed_out.weight" not in tensors else f32("embed_out.weight").t()

    if pad_vocab_to:
        V = head_w.shape[1]
        pad_v = -(-V // pad_vocab_to) * pad_vocab_to - V
        if pad_v:
            head_w = F.pad(head_w, (0, pad_v))
            embed = F.pad(embed, (0, 0, 0, pad_v))

    params = {
        "embed": embed.to(torch.bfloat16),
        "blocks": blocks,
        "final_norm": final_norm,
        "lm_head": DenseLinear(w=head_w.to(torch.bfloat16).contiguous(), bias=None),
    }
    return params, cfg
