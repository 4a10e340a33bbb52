"""Port qmatmul (plain path) against the JAX package's qmatmul.

JAX-quantized weights are carried across byte for byte; x is made with
numpy from a seed.  JAX runs both ``impl="xla"`` (dequantize + dot) and
``impl="pallas"`` (the TPU kernel, in interpret mode on the CPU), at decode
rows (M <= 16, which the decode kernel takes on the card) and above.

Tolerance: both sides round the same bf16 operands and accumulate in f32,
so they differ only in summation order before the bf16 rounding of the
output — at most one bf16 ulp of the output (2^-7 relative) plus f32
reassociation noise: rtol 1e-2, atol 1e-2."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qlora_tpu.ops import qmatmul as jqmatmul
from qlora_tpu.quant import quantize as jquantize

from qlora_tpu_torch.ops import qmatmul, qmatmul_plain
from qlora_tpu_torch.ops.qmatmul import DECODE_ROWS, decode_plan
from qlora_tpu_torch.quant import QuantizedTensor

torch.set_num_threads(2)


def _carry(j) -> QuantizedTensor:
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))
    return QuantizedTensor(t(j.packed), t(j.absmax), t(j.absmax_scale),
                           t(j.absmax_offset), tuple(j.shape), j.block_size, j.quant_type)


@pytest.mark.parametrize("M", [1, 4, 8, 16, 40, 256])
@pytest.mark.parametrize("double_quant", [True, False])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_plain_matches_jax(M, double_quant, impl):
    K, N = 512, 256
    rng = np.random.default_rng(M)
    w = (rng.normal(size=(K, N)) * K ** -0.5).astype(np.float32)
    x = rng.normal(size=(M, K)).astype(np.float32)
    jqt = jquantize(jnp.asarray(w), double_quant=double_quant)
    want = np.asarray(jqmatmul(jnp.asarray(x, jnp.bfloat16), jqt, impl), np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = qmatmul(xt, _carry(jqt))
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2, atol=1e-2)
    # the CPU dispatch is the plain path itself
    assert torch.equal(got, qmatmul_plain(xt, _carry(jqt)))


def test_plain_at_shape_the_tpu_kernel_cannot_tile():
    """K/2 = 192 and N = 200 are not 128-tileable: JAX takes its xla path
    there, and the port computes the same function at any shape."""
    K, N, M = 384, 200, 7
    rng = np.random.default_rng(3)
    w = (rng.normal(size=(K, N)) * 0.05).astype(np.float32)
    x = rng.normal(size=(M, K)).astype(np.float32)
    jqt = jquantize(jnp.asarray(w))
    want = np.asarray(jqmatmul(jnp.asarray(x, jnp.bfloat16), jqt, "xla"), np.float32)
    got = qmatmul(torch.from_numpy(x), _carry(jqt)).float().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)


def test_kernel_wrapper_checks_operands_before_launch():
    """The wrappers validate shapes in Python before any pointer reaches
    the kernel; these checks run (and raise) on any device."""
    from qlora_tpu_torch.ops import qmm_nf4_fwd_dq, qmm_nf4_fwd_f32
    from qlora_tpu_torch.quant import quantize

    w = torch.from_numpy((np.random.default_rng(0).normal(size=(256, 64)) * 0.05)
                         .astype(np.float32))
    dq, plain = quantize(w), quantize(w, double_quant=False)
    x = torch.zeros(4, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="does not match"):
        qmm_nf4_fwd_dq(x[:, :128], dq)
    with pytest.raises(ValueError, match="needs an f32-absmax"):
        qmm_nf4_fwd_f32(x, dq)
    with pytest.raises(ValueError, match="needs a double-quantized"):
        qmm_nf4_fwd_dq(x, plain)
    bad = QuantizedTensor(plain.packed, plain.absmax[:2], None, None, plain.shape)
    with pytest.raises(ValueError, match="absmax"):
        qmm_nf4_fwd_f32(x, bad)


LLAMA_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096)]


@pytest.mark.parametrize("K,N,block_size", [(K, N, 64) for K, N in LLAMA_SHAPES] + [
    (384, 200, 64), (1024, 320, 32), (64 * 600, 96, 64), (256, 72, 4), (480, 50, 12),
    (4096, 4096, 128), (2 * 8192, 64, 8192),
], ids=str)
def test_decode_plan_covers_every_packed_row_once(K, N, block_size):
    """The decode kernel's split plan: splits of whole absmax blocks (where
    a block is a multiple of 8 packed rows and at most 512), in order,
    covering every packed row once, at most one cluster of 16 per strip of
    128 columns; at the LLaMA-7B shapes (blocks of 64) every SM of an H100
    gets a block."""
    plan = decode_plan(K, N, block_size, 132)
    rows = plan.split_rows(K)
    assert len(rows) == plan.splits and 1 <= plan.splits <= 16
    assert rows[0][0] == 0 and rows[-1][1] == K // 2
    assert all(a < b for a, b in rows)
    assert all(b == c for (_, b), (c, _) in zip(rows, rows[1:]))
    assert plan.unit % 8 == 0
    if block_size % 8 == 0 and block_size <= 512:
        assert all(a % block_size == 0 for a, _ in rows)
    assert plan.strips == -(-N // 128)
    if (K, N) in LLAMA_SHAPES and block_size == 64:   # the LLaMA-7B weights' blocks
        assert plan.strips * plan.splits >= 132


def test_decode_plan_does_not_depend_on_rows():
    """The plan takes no row count, so a row's sum runs in the same order
    in every batch; the dispatch sends up to DECODE_ROWS rows to it."""
    import inspect

    assert "M" not in inspect.signature(decode_plan).parameters and DECODE_ROWS == 16
    assert decode_plan(4096, 4096, 64, 132) == decode_plan(4096, 4096, 64, 132)
