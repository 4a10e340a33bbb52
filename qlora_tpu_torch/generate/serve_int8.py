"""Offline int8 requantization for decode serving.

A serving engine builds a per-column int8 copy of the frozen weights once,
at start-up, and runs its token loop on that copy under
``default_impl("w8a8")``: every block linear and the lm_head then go through
the direct int8 kernel (``ops.qmm_i8_direct``: int8 activations times int8
codes with an exact int32 sum).  The copy costs 8 bits per parameter of
device memory beside the NF4 tree and per-channel w8a8 noise on the decode
logits (``chip_smoke.py``'s parity-int8 phase bounds it against the exact
path); prefill and training stay on the exact path.
"""

from __future__ import annotations

import torch

from qlora_tpu_torch.models.layers import DenseLinear, QLinear
from qlora_tpu_torch.quant.blockwise import dequantize, quantize, quantize_k_sharded

LM_HEAD_PAD = 1024   # the int8 lm_head's columns are padded to a multiple of this


def requantize_linear_int8(lin: QLinear, k_shards: int = 1) -> QLinear:
    """One QLinear → per-column int8 QLinear (``block_size = K``), made on
    the device the weight lives on.

    ``k_shards > 1`` quantizes per column per K-chunk (``block_size`` K /
    k_shards, ``QuantizedTensor.k_shards`` set), so that a row-parallel
    rank runs its chunk through the direct int8 kernel and its partial is
    dequantized by its own chunk's column scales before the all-reduce."""
    w = dequantize(lin.qt, torch.float32)
    K = w.shape[0]
    if k_shards > 1:
        qt = quantize_k_sharded(w, k_shards, block_size=K // k_shards, quant_type="int8",
                                double_quant=False)
    else:
        qt = quantize(w, block_size=K, quant_type="int8", double_quant=False)
    return QLinear(qt=qt, bias=lin.bias)


def _int8_lm_head(params: dict):
    """Per-column int8 copy of a dense lm_head, its columns zero-padded to a
    multiple of 1024 (LLaMA's 32000 → 32768) and the bias with them.  The
    padded columns quantize to zero codes with their scale guarded to 1;
    ``forward`` cuts the logits back to ``vocab_size`` before sampling."""
    lm = params.get("lm_head")
    if not isinstance(lm, DenseLinear):
        return lm                      # already quantized, or absent
    w = lm.w.to(torch.float32)
    pad = (-w.shape[1]) % LM_HEAD_PAD
    if pad:
        w = torch.nn.functional.pad(w, (0, pad))
    qt = quantize(w, block_size=w.shape[0], quant_type="int8", double_quant=False)
    bias = lm.bias
    if bias is not None and pad:
        bias = torch.nn.functional.pad(bias, (0, pad))
    return QLinear(qt=qt, bias=bias)


def requantize_params_int8_unstacked(params: dict) -> dict:
    """Serving copy of the params with every QLinear, and the lm_head,
    per-column int8.  Built layer by layer, one f32 copy of one weight alive
    at a time; norms and the embedding are shared with the original tree."""
    blocks = [{name: requantize_linear_int8(v) if isinstance(v, QLinear) else v
               for name, v in block.items()} for block in params["blocks"]]
    return dict(params, blocks=blocks, lm_head=_int8_lm_head(params))


def requantize_params_int8(params: dict, row_parallel_k_shards: int = 1) -> dict:
    """As :func:`requantize_params_int8_unstacked` (the port's ``blocks`` is
    a per-layer list already, so the two build the same tree), or, with
    ``row_parallel_k_shards > 1``, the tensor-parallel serving copy: the
    row-parallel linears (wo, w_down, w_out) quantized per K-chunk and the
    lm_head left as it is (the tensor-parallel path shards the dense one)."""
    if row_parallel_k_shards == 1:
        return requantize_params_int8_unstacked(params)
    from qlora_tpu_torch.parallel.megatron_step import ROW_PARALLEL

    blocks = [{name: (requantize_linear_int8(
                   v, row_parallel_k_shards if name in ROW_PARALLEL else 1)
                   if isinstance(v, QLinear) else v)
               for name, v in block.items()} for block in params["blocks"]]
    return dict(params, blocks=blocks)
