"""Port qmatmul (plain path) against the JAX package's qmatmul.

JAX-quantized weights are carried across byte for byte; x is made with
numpy from a seed.  JAX runs both ``impl="xla"`` (dequantize + dot) and
``impl="pallas"`` (the TPU kernel, in interpret mode on the CPU).

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
from qlora_tpu_torch.quant import QuantizedTensor

torch.set_num_threads(2)


def _carry(j) -> QuantizedTensor:
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))
    return QuantizedTensor(t(j.packed), t(j.absmax), t(j.absmax_scale),
                           t(j.absmax_offset), tuple(j.shape), j.block_size, j.quant_type)


@pytest.mark.parametrize("M", [4, 40, 256])
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
