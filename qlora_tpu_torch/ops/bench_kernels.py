"""Timing helpers: a ported kernel launched `reps` times on one stream.

The JAX package's ``qlora_tpu/ops/bench_kernels.py`` repeats a kernel's body
under an extra leading grid dimension inside one ``pallas_call``, because its
dispatch path adds a latency to every call.  On the card, CUDA events around
a run of launches time a kernel directly, so each counterpart here launches
the ported kernel itself `reps` times on the current stream and returns the
last output; the caller records an event before and after and divides by
`reps`.  The arguments are the JAX helpers' (their tile sizes aside, which
the CUDA kernels choose themselves).  On CPU tensors each runs the kernel's
plain version, once per repeat as well.
"""

from __future__ import annotations

import torch

from qlora_tpu_torch.quant.blockwise import QuantizedTensor

from .qmatmul import (
    _i8_direct_decode_launch, _i8_direct_decode_plan_on, _launch_w8a8, _w8a8_epilogue,
    int8_matmul_plain, qmatmul_bwd_plain, qmatmul_plain, qmm_nf4_bwd, qmm_nf4_fwd_f32,
)


def _f32_absmax_tensor(packed, am, shape, block_size, quant_type) -> QuantizedTensor:
    return QuantizedTensor(packed=packed, absmax=am.to(torch.float32).contiguous(),
                           absmax_scale=None, absmax_offset=None, shape=tuple(shape),
                           block_size=block_size, quant_type=quant_type)


def qmm_repeat(x, packed, am, shape, block_size, quant_type, reps=64):
    """y = x @ dequant(packed, am) with f32 absmax am [K/B, N], `reps` times
    through ``qmm_nf4_fwd_f32`` (the TPU kernel ``_qmm_pallas``)."""
    qt = _f32_absmax_tensor(packed, am, shape, block_size, quant_type)
    fn = qmm_nf4_fwd_f32 if x.is_cuda else qmatmul_plain
    for _ in range(reps):
        y = fn(x, qt)
    return y


def qmm_bwd_repeat(g, packed, am, shape, block_size, quant_type, reps=32):
    """dx = g @ dequant(packed, am)ᵀ, `reps` times through ``qmm_nf4_bwd``
    (the TPU kernel ``_qmm_bwd_pallas``)."""
    qt = _f32_absmax_tensor(packed, am, shape, block_size, quant_type)
    fn = qmm_nf4_bwd if g.is_cuda else qmatmul_bwd_plain
    for _ in range(reps):
        dx = fn(g, qt)
    return dx


def i8_direct_repeat(x8, w8, s_out, shape, reps=32):
    """(x8 @ w8) * s_out[n] rounded to bf16 for int8 x8 [M, K] and per-column
    int8 w8 [K, N], `reps` times through the kernel that ``qmm_i8_direct``'s
    dispatch takes for these rows (the TPU kernel ``_qmm_pallas_i8_direct``)
    with every row scale xs = 1: up to ``DECODE_ROWS`` rows of a shape its
    plan accepts ``qmm_i8_direct_decode.cu``, handed x8 and xs as its rows
    (it makes the column scales from the stored absmax, here s_out * 127, as
    col * (1/127)); else ``qmm_i8_direct.cu``."""
    K, N = shape
    s_out = s_out.reshape(-1).to(torch.float32)
    xs = torch.ones((x8.shape[0], 1), dtype=torch.float32, device=x8.device)
    if x8.is_cuda:
        qt = _f32_absmax_tensor(w8, (s_out * 127.0).reshape(1, N), shape, K, "int8")
        x = torch.empty((x8.shape[0], K), dtype=torch.bfloat16, device=x8.device)  # unread
        plan = _i8_direct_decode_plan_on(x, qt)
        if plan is not None:
            run = lambda: _i8_direct_decode_launch(x, qt, plan, rows=(x8, xs))
        else:
            run = lambda: _launch_w8a8("qmm_i8_direct", x8, qt, None, s_out, xs)
    else:
        run = lambda: _w8a8_epilogue(int8_matmul_plain(x8, w8), s_out, xs)
    for _ in range(reps):
        y = run()
    return y
