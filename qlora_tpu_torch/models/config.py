"""Model configurations for the supported families (a copy of the JAX
package's presets, so the port imports nothing of it).

LLaMA 1/2/3, Mistral, Qwen2, Gemma and Pythia/GPT-NeoX; ``debug`` and
``debug-neox`` are the tiny CPU-test shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str                      # "llama" | "neox"
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int              # < num_heads => GQA (Llama-2-70B)
    max_position_embeddings: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    rotary_pct: float = 1.0        # NeoX: rotary on first pct of head dims
    use_parallel_residual: bool = False  # NeoX: x + attn(ln1 x) + mlp(ln2 x)
    use_bias: bool = False         # NeoX: biases on dense layers
    tie_word_embeddings: bool = False
    hidden_act: str = "silu"       # llama: silu (SwiGLU); neox: gelu (plain MLP)
    sliding_window: Optional[int] = None   # Mistral-style local attention
    attention_bias: bool = False           # Qwen2-style qkv biases
    # Gemma-isms: explicit head_dim (≠ hidden/heads on 7B), zero-centered
    # RMSNorm weights multiplied as (1 + w), sqrt(hidden) embedding scaling
    head_dim_override: Optional[int] = None
    norm_plus_one: bool = False
    scale_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.hidden_size // self.num_heads


def llama_config(n_params: str, **kw) -> ModelConfig:
    """LLaMA-1/2 configs; sizes from the public architecture specs."""
    table = {
        # name: (hidden, intermediate, layers, heads, kv_heads, vocab, max_pos)
        "7b": (4096, 11008, 32, 32, 32, 32000, 2048),
        "13b": (5120, 13824, 40, 40, 40, 32000, 2048),
        "30b": (6656, 17920, 60, 52, 52, 32000, 2048),
        "65b": (8192, 22016, 80, 64, 64, 32000, 2048),
        "llama2-7b": (4096, 11008, 32, 32, 32, 32000, 4096),
        "llama2-13b": (5120, 13824, 40, 40, 40, 32000, 4096),
        "llama2-70b": (8192, 28672, 80, 64, 8, 32000, 4096),
        "llama3-8b": (4096, 14336, 32, 32, 8, 128256, 8192),
        "llama3-70b": (8192, 28672, 80, 64, 8, 128256, 8192),
        # tiny config for CPU tests
        "debug": (256, 512, 2, 4, 4, 512, 512),
    }
    h, inter, layers, heads, kv, vocab, maxpos = table[n_params]
    return ModelConfig(
        arch="llama", vocab_size=vocab, hidden_size=h, intermediate_size=inter,
        num_layers=layers, num_heads=heads, num_kv_heads=kv,
        max_position_embeddings=maxpos, norm_eps=1e-5 if "llama2" not in n_params else 1e-5,
        hidden_act="silu", **kw,
    )


def neox_config(name: str, **kw) -> ModelConfig:
    """Pythia / GPT-NeoX family configs."""
    table = {
        # name: (hidden, layers, heads, vocab)
        "pythia-70m": (512, 6, 8, 50304),
        "pythia-160m": (768, 12, 12, 50304),
        "pythia-410m": (1024, 24, 16, 50304),
        "pythia-1b": (2048, 16, 8, 50304),
        "pythia-1.4b": (2048, 24, 16, 50304),
        "pythia-2.8b": (2560, 32, 32, 50304),
        "pythia-6.9b": (4096, 32, 32, 50432),
        "pythia-12b": (5120, 36, 40, 50688),
        "debug-neox": (256, 2, 4, 512),
    }
    h, layers, heads, vocab = table[name]
    return ModelConfig(
        arch="neox", vocab_size=vocab, hidden_size=h, intermediate_size=4 * h,
        num_layers=layers, num_heads=heads, num_kv_heads=heads,
        max_position_embeddings=2048, rotary_pct=0.25,
        use_parallel_residual=True, use_bias=True, norm_eps=1e-5,
        hidden_act="gelu", **kw,
    )


def mistral_config(name: str = "7b", **kw) -> ModelConfig:
    """Mistral-7B family: LLaMA arch + GQA + sliding-window attention."""
    return ModelConfig(
        arch="llama", vocab_size=32000, hidden_size=4096,
        intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
        max_position_embeddings=32768, rope_theta=10000.0,
        sliding_window=4096, **kw,
    )


def qwen2_config(name: str, **kw) -> ModelConfig:
    """Qwen2 family: LLaMA arch + qkv biases + large vocab + high rope theta."""
    table = {
        "qwen2-0.5b": (896, 4864, 24, 14, 2, 151936),
        "qwen2-1.5b": (1536, 8960, 28, 12, 2, 151936),
        "qwen2-7b": (3584, 18944, 28, 28, 4, 152064),
    }
    h, inter, layers, heads, kv, vocab = table[name]
    return ModelConfig(
        arch="llama", vocab_size=vocab, hidden_size=h, intermediate_size=inter,
        num_layers=layers, num_heads=heads, num_kv_heads=kv,
        max_position_embeddings=32768, rope_theta=1000000.0,
        attention_bias=True, tie_word_embeddings=(name != "qwen2-7b"), **kw,
    )


def gemma_config(name: str, **kw) -> ModelConfig:
    """Gemma family: LLaMA-shaped blocks + GeGLU (gelu-tanh), (1+w) RMSNorm,
    sqrt(hidden) embedding scaling, explicit head_dim, tied lm_head."""
    table = {
        # name: (hidden, inter, layers, heads, kv, head_dim, vocab)
        "gemma-2b": (2048, 16384, 18, 8, 1, 256, 256000),
        "gemma-7b": (3072, 24576, 28, 16, 16, 256, 256000),
        "debug-gemma": (256, 512, 2, 4, 2, 32, 512),
    }
    h, inter, layers, heads, kv, hd, vocab = table[name]
    return ModelConfig(
        arch="llama", vocab_size=vocab, hidden_size=h, intermediate_size=inter,
        num_layers=layers, num_heads=heads, num_kv_heads=kv,
        max_position_embeddings=8192, rope_theta=10000.0, norm_eps=1e-6,
        hidden_act="gelu_tanh", head_dim_override=hd, norm_plus_one=True,
        scale_embeddings=True, tie_word_embeddings=True, **kw,
    )


# registry mapping HF-style model ids to configs (quantize-on-load, N4)
PRESETS = {
    "huggyllama/llama-7b": lambda: llama_config("7b"),
    "huggyllama/llama-13b": lambda: llama_config("13b"),
    "huggyllama/llama-30b": lambda: llama_config("30b"),
    "huggyllama/llama-65b": lambda: llama_config("65b"),
    "meta-llama/Llama-2-7b-hf": lambda: llama_config("llama2-7b"),
    "meta-llama/Llama-2-13b-hf": lambda: llama_config("llama2-13b"),
    "meta-llama/Llama-2-70b-hf": lambda: llama_config("llama2-70b"),
    "EleutherAI/pythia-70m": lambda: neox_config("pythia-70m"),
    "EleutherAI/pythia-160m": lambda: neox_config("pythia-160m"),
    "EleutherAI/pythia-410m": lambda: neox_config("pythia-410m"),
    "EleutherAI/pythia-1b": lambda: neox_config("pythia-1b"),
    "EleutherAI/pythia-1.4b": lambda: neox_config("pythia-1.4b"),
    "EleutherAI/pythia-2.8b": lambda: neox_config("pythia-2.8b"),
    "EleutherAI/pythia-6.9b": lambda: neox_config("pythia-6.9b"),
    "EleutherAI/pythia-12b": lambda: neox_config("pythia-12b"),
    "mistralai/Mistral-7B-v0.1": lambda: mistral_config(),
    "Qwen/Qwen2-0.5B": lambda: qwen2_config("qwen2-0.5b"),
    "Qwen/Qwen2-1.5B": lambda: qwen2_config("qwen2-1.5b"),
    "Qwen/Qwen2-7B": lambda: qwen2_config("qwen2-7b"),
    "meta-llama/Meta-Llama-3-8B": lambda: llama_config(
        "llama3-8b", rope_theta=500000.0),
    "meta-llama/Meta-Llama-3-70B": lambda: llama_config(
        "llama3-70b", rope_theta=500000.0),
    "google/gemma-2b": lambda: gemma_config("gemma-2b"),
    "google/gemma-7b": lambda: gemma_config("gemma-7b"),
    "debug-gemma": lambda: gemma_config("debug-gemma"),
}


def get_config(name: str) -> ModelConfig:
    if name in PRESETS:
        return PRESETS[name]()
    if name.startswith("debug"):
        return llama_config("debug") if "neox" not in name else neox_config("debug-neox")
    raise ValueError(f"unknown model {name!r}; known: {sorted(PRESETS)}")
