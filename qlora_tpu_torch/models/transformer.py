"""The decoder-only transformer: LLaMA family and GPT-NeoX (pythia) family.

One implementation driven by ModelConfig flags, as in the JAX package.
Layers are per-layer Python lists, looped in Python; every block linear is
a quantized ``QLinear`` (NF4, FP4 or int8) computed through ``qmatmul`` plus
its LoRA term.

Parameter layout:
  params = {
    "embed":      [V, D] bf16,
    "blocks":     [per-layer dict of QLinear/DenseLinear and norm tensors] * L,
    "final_norm": {"scale": [D], ("bias": [D])} f32,
    "lm_head":    DenseLinear [D, V] bf16 (the int8 serving copy: a QLinear
                  whose columns are padded; the logits are cut to V),
  }
  lora = [{"<linear name>": {"a": [K, r], "b": [r, N]} f32, ...}] * L
  cache = {"k": [[B, KVH, T, hd] bf16] * L, "v": [...] * L, "length": [B] int32}
  paged cache = {"k_pages": [[n_pages, KVH, page, hd] bf16] * L, "v_pages": [...] * L,
                 "tables": [B, pages_per_seq] int32 (shared by every layer),
                 "length": [B] int32}

Under a tensor-parallel context (``models/layers.tp_shard_context``) the
params, LoRA and caches are this rank's shards.  In the Megatron style
(``parallel/tp_decode.py``, ``parallel/megatron_step.py``) q/k/v and the
gate/up (w_qkv, w_fc) linears are column-parallel on the rank's heads and
columns, wo and w_down (w_out) row-parallel over K-sharded storage with one
all-reduce a sub-block.  In the gather style (``parallel/sharded_step.py``)
every rank runs every head: each linear computes its column shard and
gathers its output (its storage gathered over fsdp first), and the LoRA
adapters are whole.  The embedding's features and the lm_head's columns are
gathered in both.

Nothing on the no-cache path writes into a tensor in place, so autograd can
differentiate it with respect to the LoRA tensors; every other parameter is
frozen (``requires_grad`` False) and gets no gradient.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from qlora_tpu_torch import resolve_device
from qlora_tpu_torch.lora import LoraConfig, apply_lora, init_lora
from qlora_tpu_torch.models.config import ModelConfig
from qlora_tpu_torch.models.layers import (
    DenseLinear,
    QLinear,
    apply_linear,
    apply_rope,
    attention,
    attention_kvmajor,
    causal_mask,
    ident_fwd_psum_bwd,
    layer_norm,
    lookup_embedding,
    psum_fwd_ident_bwd,
    megatron_axis,
    rms_norm,
    rope_frequencies,
)
from qlora_tpu_torch.ops import (
    flash_attention, fused_decode_attention, fused_paged_chunk_attention,
    fused_paged_decode_attention, ring_attention,
)
from qlora_tpu_torch.ops.tape import Tape
from qlora_tpu_torch.quant.blockwise import quantize

LLAMA_LINEARS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
NEOX_LINEARS = ("w_qkv", "wo", "w_fc", "w_out")


def linear_names(cfg: ModelConfig):
    return LLAMA_LINEARS if cfg.arch == "llama" else NEOX_LINEARS


def linear_dims(cfg: ModelConfig) -> dict:
    """name → (in_dim, out_dim) for each block linear."""
    D, I = cfg.hidden_size, cfg.intermediate_size
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if cfg.arch == "llama":
        return {
            "wq": (D, H * hd), "wk": (D, KVH * hd), "wv": (D, KVH * hd),
            "wo": (H * hd, D),
            "w_gate": (D, I), "w_up": (D, I), "w_down": (I, D),
        }
    return {
        "w_qkv": (D, 3 * D), "wo": (D, D),
        "w_fc": (D, I), "w_out": (I, D),
    }


# stable per-linear ids, so that each adapter draws an independent dropout mask
_LINEAR_RNG_IDS = {
    name: i for i, name in enumerate(sorted(set(LLAMA_LINEARS + NEOX_LINEARS)))
}


def _block_linear(block, lora, name, x, lcfg: LoraConfig, seed=None, tp_mode="gather"):
    """Base linear plus its LoRA term.  `seed`, an int or None, is the
    block's dropout seed: each linear draws its mask from a generator seeded
    with it and the linear's id, so a recomputed block (remat) draws the
    same masks again.  Under a tensor-parallel world (`tp_mode` "column" or
    "row_partial") the adapter is sharded with its base linear (B's columns,
    or A's rows), so its term is this rank's columns or a partial sum, as
    the base product's (each rank's partial rounded to bf16 with its LoRA
    partial, as the JAX package's)."""
    y = apply_linear(block[name], x, tp_mode)
    if lora is not None and name in lora:
        gen = None
        if lcfg.dropout > 0 and seed is not None:
            gen = torch.Generator(device=x.device).manual_seed(
                seed * len(_LINEAR_RNG_IDS) + _LINEAR_RNG_IDS[name])
        y = y + apply_lora(x, lora[name], lcfg.scale, lcfg.dropout, gen)
    return y


def _nscale(cfg, scale):
    """RMSNorm weight as multiplied: gemma stores zero-centered (1 + w)."""
    return scale + 1.0 if cfg.norm_plus_one else scale


def _write_prefill(buf: torch.Tensor, new: torch.Tensor, starts) -> None:
    """Per-row contiguous update buf[b, :, p:p+S] = new[b], the start
    clamped so the slice fits (as ``dynamic_update_slice`` does)."""
    S, T = new.shape[2], buf.shape[2]
    for b, p in enumerate(starts):
        p = max(0, min(int(p), T - S))
        buf[b, :, p:p + S] = new[b]


def _attn(cfg, block, lora, lcfg, x, cos, sin, mask, cache_kv, pos, seed=None,
          flash_lengths=None, sp=None):
    """Attention sub-block; cache_kv None, (k_buf, v_buf) [B, KVH, T, hd] or
    the paged (k_pages, v_pages, tables), the buffers updated in place.
    flash_lengths: [B] valid-key lengths; when set (and there is no cache)
    attention goes through ``flash_attention``.  sp: the sequence-parallel
    axis (a ``TPMesh``): this rank's queries attend every rank's keys
    through ``ring_attention``."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    rotary_dim = int(cfg.rotary_pct * hd) // 2 * 2
    mesh = megatron_axis()
    col, row = ("column", "row_partial") if mesh is not None else ("gather", "gather")
    if mesh is not None:
        # one ident-fwd/psum-bwd for the sub-block's input; q, k and v then
        # run on this rank's heads (the head counts follow the shards' widths)
        x = ident_fwd_psum_bwd(x, mesh)
    if cfg.arch == "llama":
        q = _block_linear(block, lora, "wq", x, lcfg, seed, col).reshape(B, S, -1, hd)
        k = _block_linear(block, lora, "wk", x, lcfg, seed, col).reshape(B, S, -1, hd)
        v = _block_linear(block, lora, "wv", x, lcfg, seed, col).reshape(B, S, -1, hd)
    else:
        # HF NeoX packs qkv per head: [B, S, H, 3, hd] (a column shard is a
        # run of whole heads)
        qkv = _block_linear(block, lora, "w_qkv", x, lcfg, seed, col).reshape(
            B, S, -1, 3, hd)
        q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    q = apply_rope(q, cos, sin, rotary_dim)
    k = apply_rope(k, cos, sin, rotary_dim)

    if cache_kv is not None and len(cache_kv) == 3:
        # the paged pool: a decode token or a speculative verify chunk of S
        # tokens, appended at pos[:, 0].. and attended in one kernel
        k_pages, v_pages, tables = cache_kv
        kw = dict(sm_scale=1.0 / hd ** 0.5, sliding_window=cfg.sliding_window)
        lengths = pos[:, 0].to(torch.int32)
        if S == 1:
            o, _, _ = fused_paged_decode_attention(
                q[:, 0].to(torch.bfloat16), k[:, 0], v[:, 0], k_pages, v_pages, lengths,
                tables, **kw)
            attn_out = o[:, None]
        else:
            attn_out, _, _ = fused_paged_chunk_attention(
                q.to(torch.bfloat16), k, v, k_pages, v_pages, lengths, tables, **kw)
    elif cache_kv is not None:
        k_buf, v_buf = cache_kv
        if S == 1:
            o, _, _ = fused_decode_attention(
                q[:, 0].to(torch.bfloat16), k[:, 0], v[:, 0], k_buf, v_buf,
                pos[:, 0].to(torch.int32), sm_scale=1.0 / hd ** 0.5,
                sliding_window=cfg.sliding_window)
            attn_out = o[:, None]
        else:
            starts = pos[:, 0].tolist()
            _write_prefill(k_buf, k.transpose(1, 2).to(k_buf.dtype), starts)
            _write_prefill(v_buf, v.transpose(1, 2).to(v_buf.dtype), starts)
            attn_out = attention_kvmajor(q, k_buf, v_buf, mask)
    elif sp is not None:
        # causal over the global positions; the kv heads rotate unrepeated
        # (the chunks' kernels take GQA as they do)
        oh = ring_attention(
            q.transpose(1, 2).to(torch.bfloat16), k.transpose(1, 2).to(torch.bfloat16),
            v.transpose(1, 2).to(torch.bfloat16), sp, sm_scale=1.0 / hd ** 0.5, causal=True)
        attn_out = oh.transpose(1, 2)
    elif flash_lengths is not None:
        # GQA is handled inside the kernel (query head h reads kv head h // G)
        oh = flash_attention(
            q.transpose(1, 2).to(torch.bfloat16), k.transpose(1, 2).to(torch.bfloat16),
            v.transpose(1, 2).to(torch.bfloat16), flash_lengths,
            1.0 / hd ** 0.5, True, cfg.sliding_window)
        attn_out = oh.transpose(1, 2)
    else:
        attn_out = attention(q, k, v, mask)
    attn_out = attn_out.reshape(B, S, -1)      # [B, S, local heads * hd]
    out = _block_linear(block, lora, "wo", attn_out, lcfg, seed, row)
    return out if mesh is None else psum_fwd_ident_bwd(out, mesh)


def _mlp(cfg, block, lora, lcfg, x, seed=None):
    mesh = megatron_axis()
    col, row = ("column", "row_partial") if mesh is not None else ("gather", "gather")
    if mesh is not None:
        x = ident_fwd_psum_bwd(x, mesh)
    down = "w_down" if cfg.arch == "llama" else "w_out"
    if cfg.arch == "llama":
        g = _block_linear(block, lora, "w_gate", x, lcfg, seed, col)
        u = _block_linear(block, lora, "w_up", x, lcfg, seed, col)
        act = (F.gelu(g.float(), approximate="tanh") if cfg.hidden_act == "gelu_tanh"
               else F.silu(g.float()))
        h = (act * u.float()).to(torch.bfloat16)
    else:
        h = _block_linear(block, lora, "w_fc", x, lcfg, seed, col)
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h.float(), approximate="tanh").to(torch.bfloat16)
    out = _block_linear(block, lora, down, h, lcfg, seed, row)
    return out if mesh is None else psum_fwd_ident_bwd(out, mesh)


def block_forward(cfg, lcfg, x, block, lora, cos, sin, mask, cache_kv, pos, seed=None,
                  flash_lengths=None, sp=None):
    """One transformer block; returns x (the cache is updated in place)."""
    if cfg.arch == "llama":
        h = rms_norm(x, _nscale(cfg, block["attn_norm"]), cfg.norm_eps)
        x = x + _attn(cfg, block, lora, lcfg, h, cos, sin, mask, cache_kv, pos, seed,
                      flash_lengths, sp)
        h2 = rms_norm(x, _nscale(cfg, block["mlp_norm"]), cfg.norm_eps)
        return x + _mlp(cfg, block, lora, lcfg, h2, seed)
    h1 = layer_norm(x, block["ln1"]["scale"], block["ln1"]["bias"], cfg.norm_eps)
    a = _attn(cfg, block, lora, lcfg, h1, cos, sin, mask, cache_kv, pos, seed, flash_lengths,
              sp)
    if cfg.use_parallel_residual:
        h2 = layer_norm(x, block["ln2"]["scale"], block["ln2"]["bias"], cfg.norm_eps)
        return x + a + _mlp(cfg, block, lora, lcfg, h2, seed)
    x = x + a
    h2 = layer_norm(x, block["ln2"]["scale"], block["ln2"]["bias"], cfg.norm_eps)
    return x + _mlp(cfg, block, lora, lcfg, h2, seed)


def _check_remat(remat):
    """Per-layer gradient checkpointing, as the JAX package's ``_remat_wrap``:
    False, "full" (``True`` too) or "save_linear".

    "full" keeps only the layer boundaries: the backward runs each block's
    whole forward again, every NF4 matmul and attention kernel included
    (least memory).  "save_linear" also keeps, on the block's tape
    (``ops/tape.py``), the base matmul output of each block linear (JAX's
    ``linear_out``, before the LoRA term) and flash attention's o and lse
    (JAX's ``attn_out``; JAX keeps no lse, so its re-forward may run the
    kernel again): the recomputed forward runs the norms, RoPE, the gated
    activation, the residuals and the LoRA products, and no qmm or flash
    forward kernel.  The plain attention (no flash) is recomputed.  The
    gradients are the same under every policy."""
    if remat not in (False, True, "full", "save_linear"):
        raise ValueError(f"remat must be False, True, 'full' or 'save_linear', got {remat!r}")
    return "full" if remat is True else remat


def forward(
    params: dict,
    lora: Optional[list],
    ids: torch.Tensor,                       # [B, S] int
    cfg: ModelConfig,
    lcfg: LoraConfig = LoraConfig(),
    *,
    positions: Optional[torch.Tensor] = None,   # [B, S] (default arange)
    attn_mask: Optional[torch.Tensor] = None,   # [B, S] 1 = real (right padding)
    cache: Optional[dict] = None,
    use_flash: str = "auto",                    # "auto" | "never" | "always"
    generator: Optional[torch.Generator] = None,   # LoRA dropout (lcfg.dropout > 0)
    remat=False,                                # False | True / "full" | "save_linear"
    return_hidden: bool = False,
    sp=None,                                    # the sequence-parallel axis (a TPMesh)
):
    """Returns (logits [B, S, V] f32, cache or None).  The cache's K/V
    buffers are updated in place; the returned dict carries the new lengths.
    With ``return_hidden`` a third element: the post-final-norm hidden
    states [B, S, D] bf16 (HF's last_hidden_state; contrastive search reads
    them).

    Without a cache, attention goes through ``flash_attention`` when
    ``use_flash`` is "always", or "auto" at the JAX package's gate
    (S % 128 == 0 and head_dim % 64 == 0); otherwise it is the plain grouped
    softmax.  ``remat`` checkpoints each block when gradients are recorded.

    ``sp`` (the JAX package's ``sp_axis``): sequence-parallel training, `ids`
    being this rank's contiguous shard of the sequence (shard r holds
    positions r·S ..).  The RoPE positions are global, there is no mask (no
    padding: the loss masks the labels), and attention goes through
    ``ring_attention``, causal over the whole sequence.  A sliding window
    raises: JAX's ring has none, so under sp it would attend globally."""
    B, S = ids.shape
    dev = ids.device
    if sp is not None:
        if cache is not None:
            raise ValueError("sp is a training path: no cache")
        if cfg.sliding_window:
            raise ValueError(
                f"sliding_window={cfg.sliding_window} under sequence parallelism: the ring "
                "attends the whole sequence (JAX's ring has no window, ROADMAP C12)")
        positions = (sp.rank * S + torch.arange(S, device=dev))[None, :].repeat(B, 1)
    x = lookup_embedding(params["embed"], ids, torch.bfloat16)
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=torch.bfloat16, device=dev)

    if positions is None:
        base = torch.arange(S, device=dev)[None, :]
        positions = (cache["length"].to(dev)[:, None] + base) if cache is not None \
            else base.repeat(B, 1)
    positions = positions.to(dev)
    cos, sin = rope_frequencies(
        cfg.head_dim, int(cfg.rotary_pct * cfg.head_dim) // 2 * 2,
        cfg.rope_theta, positions)

    flash_lengths = None
    paged = cache is not None and "k_pages" in cache
    if sp is not None:
        mask = None                  # ring attention is causal over the global positions
    elif cache is not None:
        if S == 1 or paged:
            mask = None              # the decode and paged kernels mask by length
        else:
            T = cache["k"][0].shape[2]
            kj = torch.arange(T, device=dev)[None, None, None, :]
            pq = positions[:, None, :, None]
            mask = kj <= pq
            if cfg.sliding_window:
                mask = mask & (pq - kj < cfg.sliding_window)
    elif use_flash == "always" or (
            use_flash != "never" and S % 128 == 0 and cfg.head_dim % 64 == 0):
        mask = None                  # flash attention masks by length itself
        flash_lengths = (torch.full((B,), S, dtype=torch.int32, device=dev)
                         if attn_mask is None
                         else attn_mask.to(dev).sum(-1, dtype=torch.int32))
    else:
        mask = causal_mask(S, S, device=dev)
        if cfg.sliding_window:
            row = torch.arange(S, device=dev)[:, None]
            col = torch.arange(S, device=dev)[None, :]
            mask = mask & ((row - col) < cfg.sliding_window)[None, None]
        mask = mask.expand(B, 1, S, S)
        if attn_mask is not None:
            mask = mask & attn_mask.to(dev)[:, None, None, :].bool()

    seed0 = None
    if generator is not None and lcfg.dropout > 0:
        # one draw per forward; layer i's masks come from seed0 + i
        seed0 = int(torch.randint(0, 2 ** 40, (1,), generator=generator,
                                  device=generator.device).item())
    remat = _check_remat(remat)
    if cache is not None or not torch.is_grad_enabled():
        remat = False
    for i, block in enumerate(params["blocks"]):
        lora_l = None if lora is None else lora[i]
        if paged:
            cache_l = (cache["k_pages"][i], cache["v_pages"][i], cache["tables"])
        else:
            cache_l = None if cache is None else (cache["k"][i], cache["v"][i])
        seed = None if seed0 is None else seed0 + i

        def body(x, block=block, lora_l=lora_l, cache_l=cache_l, seed=seed):
            return block_forward(cfg, lcfg, x, block, lora_l, cos, sin, mask, cache_l,
                                 positions, seed, flash_lengths, sp)

        if remat == "save_linear":
            x = checkpoint(body, x, use_reentrant=False, context_fn=Tape().contexts)
        elif remat:
            x = checkpoint(body, x, use_reentrant=False)
        else:
            x = body(x)

    if cfg.arch == "llama":
        x = rms_norm(x, _nscale(cfg, params["final_norm"]["scale"]), cfg.norm_eps)
    else:
        x = layer_norm(x, params["final_norm"]["scale"], params["final_norm"]["bias"],
                       cfg.norm_eps)
    logits = apply_linear(params["lm_head"], x).float()[..., :cfg.vocab_size]
    new_cache = None
    if cache is not None:
        new_cache = dict(cache, length=(positions[:, -1] + 1).to(torch.int32))
    if return_hidden:
        return logits, new_cache, x
    return logits, new_cache


# ---------------------------------------------------------------------------
# initialization
# ---------------------------------------------------------------------------


def _init_linear(gen, in_dim, out_dim, use_bias, quantized, device,
                 quant_type="nf4", double_quant=True):
    w = torch.randn((in_dim, out_dim), generator=gen, device=device) * (in_dim ** -0.5)
    bias = torch.zeros((out_dim,), dtype=torch.float32, device=device) if use_bias else None
    if quantized:
        return QLinear(qt=quantize(w, quant_type=quant_type, double_quant=double_quant),
                       bias=bias)
    return DenseLinear(w=w.to(torch.bfloat16), bias=bias)


def init_params(cfg: ModelConfig, seed: int = 0, quantized: bool = True, device=None,
                quant_type: str = "nf4", double_quant: bool = True) -> dict:
    """Random-init model params from `seed`, made on `device` (CUDA unless
    the caller names one).  Weights ~ N(0, 1/in_dim), quantized there."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    D = cfg.hidden_size
    dims = linear_dims(cfg)
    blocks = []
    for _ in range(cfg.num_layers):
        block = {}
        for name, (di, do) in sorted(dims.items()):
            has_bias = cfg.use_bias or (cfg.attention_bias and name in ("wq", "wk", "wv"))
            block[name] = _init_linear(gen, di, do, has_bias, quantized, device,
                                       quant_type, double_quant)
        ones = lambda: torch.ones((D,), dtype=torch.float32, device=device)
        zeros = lambda: torch.zeros((D,), dtype=torch.float32, device=device)
        if cfg.arch == "llama":
            block["attn_norm"], block["mlp_norm"] = ones(), ones()
        else:
            block["ln1"] = {"scale": ones(), "bias": zeros()}
            block["ln2"] = {"scale": ones(), "bias": zeros()}
        blocks.append(block)
    if cfg.arch == "llama":
        final_norm = {"scale": torch.ones((D,), dtype=torch.float32, device=device)}
    else:
        final_norm = {"scale": torch.ones((D,), dtype=torch.float32, device=device),
                      "bias": torch.zeros((D,), dtype=torch.float32, device=device)}
    embed = torch.randn((cfg.vocab_size, D), generator=gen, device=device) * 0.02
    head = (embed.T if cfg.tie_word_embeddings else
            torch.randn((D, cfg.vocab_size), generator=gen, device=device) * D ** -0.5)
    return {
        "embed": embed.to(torch.bfloat16),
        "blocks": blocks,
        "final_norm": final_norm,
        "lm_head": DenseLinear(w=head.to(torch.bfloat16).contiguous()),
    }


def init_lora_params(cfg: ModelConfig, lcfg: LoraConfig, seed: int = 0,
                     device=None) -> list:
    """LoRA adapters for every block linear, one dict per layer (B = 0)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dims = linear_dims(cfg)
    return [{name: init_lora(di, do, lcfg.r, gen, device)
             for name, (di, do) in sorted(dims.items())}
            for _ in range(cfg.num_layers)]


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> dict:
    """Fixed-size KV cache, KV-head major: per layer [B, KVH, T, hd] bf16,
    each (row, kv head) stream a contiguous [T, hd] slab."""
    device = resolve_device(device)
    shape = (batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    return {
        "k": [torch.zeros(shape, dtype=torch.bfloat16, device=device)
              for _ in range(cfg.num_layers)],
        "v": [torch.zeros(shape, dtype=torch.bfloat16, device=device)
              for _ in range(cfg.num_layers)],
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
