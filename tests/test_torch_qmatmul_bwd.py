"""Port qmatmul backward (plain path) against the JAX package's vjp.

JAX-quantized weights are carried across byte for byte; x and the cotangent
g are made with numpy from a seed and given to both in bf16.  JAX runs
``impl="pallas"`` (the TPU backward kernel, ``_qmm_bwd_pallas`` or, over
int8 storage, ``_qmm_bwd_pallas_i8``, in interpret mode on the CPU, where the
shape tiles) and ``impl="xla"`` (dequantize + dot).  The few-row cases (M =
1, 4, 16) are the rows the card's dx decode kernels take.

Tolerance: both sides multiply the same bf16 g with the same bf16 weight
and accumulate in f32, so dx differs only by summation order before its
rounding to bf16: rtol 1e-2, atol 1e-2, as the forward's test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qlora_tpu.ops import qmatmul as jqmatmul
from qlora_tpu.quant import dequantize as jdequantize
from qlora_tpu.quant import quantize as jquantize

from qlora_tpu_torch.ops import qmatmul, qmatmul_bwd_plain, qmm_nf4_bwd
from qlora_tpu_torch.quant import dequantize, quantize
from test_torch_qmatmul import _carry

torch.set_num_threads(2)


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


@pytest.mark.parametrize("shape", [(32, 256, 128), (16, 256, 384), (9, 512, 128),
                                   (16, 256, 256), (1, 256, 128), (4, 512, 256)])
@pytest.mark.parametrize("double_quant", [True, False])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_dx_matches_jax_vjp(shape, double_quant, impl):
    M, K, N = shape
    rng = np.random.default_rng(M + K + N)
    w = (rng.normal(size=(K, N)) * 0.05).astype(np.float32)
    x = rng.normal(size=(M, K)).astype(np.float32)
    g = rng.normal(size=(M, N)).astype(np.float32)
    jqt = jquantize(jnp.asarray(w), double_quant=double_quant)
    y, vjp = jax.vjp(lambda x_: jqmatmul(x_, jqt, impl), jnp.asarray(x, jnp.bfloat16))
    (want,) = vjp(jnp.asarray(g, jnp.bfloat16))
    xt = _bf16(x).requires_grad_()
    yt = qmatmul(xt, _carry(jqt))
    yt.backward(_bf16(g))
    assert xt.grad.dtype == torch.bfloat16 and xt.grad.shape == (M, K)
    np.testing.assert_allclose(xt.grad.float().numpy(), np.asarray(want, np.float32),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(yt.detach().float().numpy(), np.asarray(y, np.float32),
                               rtol=1e-2, atol=1e-2)
    # the CPU dispatch is the plain backward itself
    assert torch.equal(xt.grad, qmatmul_bwd_plain(_bf16(g), _carry(jqt)))


@pytest.mark.parametrize("M", [1, 4, 16])
@pytest.mark.parametrize("double_quant", [True, False])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_int8_dx_at_decode_rows_matches_jax_vjp(M, double_quant, impl):
    """dx over int8 storage at the rows of the card's int8 dx decode kernel,
    against JAX's vjp (``_qmm_bwd_pallas_i8`` in interpret mode)."""
    K, N = 256, 384
    rng = np.random.default_rng(100 + M)
    w = (rng.normal(size=(K, N)) * 0.05).astype(np.float32)
    x = rng.normal(size=(M, K)).astype(np.float32)
    g = rng.normal(size=(M, N)).astype(np.float32)
    jqt = jquantize(jnp.asarray(w), quant_type="int8", double_quant=double_quant)
    _, vjp = jax.vjp(lambda x_: jqmatmul(x_, jqt, impl), jnp.asarray(x, jnp.bfloat16))
    (want,) = vjp(jnp.asarray(g, jnp.bfloat16))
    xt = _bf16(x).requires_grad_()
    qmatmul(xt, _carry(jqt)).backward(_bf16(g))
    assert xt.grad.dtype == torch.bfloat16 and xt.grad.shape == (M, K)
    np.testing.assert_allclose(xt.grad.float().numpy(), np.asarray(want, np.float32),
                               rtol=1e-2, atol=1e-2)
    assert torch.equal(xt.grad, qmatmul_bwd_plain(_bf16(g), _carry(jqt)))


def test_dx_at_shape_the_tpu_kernel_cannot_tile():
    """K/2 = 192 and N = 200 do not tile on the TPU: JAX takes its xla path,
    the port computes the same function at any shape."""
    K, N, M = 384, 200, 7
    rng = np.random.default_rng(3)
    jqt = jquantize(jnp.asarray((rng.normal(size=(K, N)) * 0.05).astype(np.float32)))
    x, g = rng.normal(size=(M, K)).astype(np.float32), rng.normal(size=(M, N)).astype(np.float32)
    _, vjp = jax.vjp(lambda x_: jqmatmul(x_, jqt, "xla"), jnp.asarray(x, jnp.bfloat16))
    xt = _bf16(x).requires_grad_()
    qmatmul(xt, _carry(jqt)).backward(_bf16(g))
    np.testing.assert_allclose(xt.grad.float().numpy(),
                               np.asarray(vjp(jnp.asarray(g, jnp.bfloat16))[0], np.float32),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("double_quant", [True, False])
def test_no_gradient_reaches_the_quantized_weight(double_quant):
    """Every leaf of the QuantizedTensor stays without a gradient, even a
    float leaf that asks for one; only x gets one."""
    w = torch.from_numpy((np.random.default_rng(0).normal(size=(128, 128)) * 0.05)
                         .astype(np.float32))
    qt = quantize(w, double_quant=double_quant)
    floats = [t for t in (qt.absmax, qt.absmax_scale, qt.absmax_offset)
              if t is not None and t.is_floating_point()]
    for t in floats:
        t.requires_grad_()
    x = torch.randn(8, 128, generator=torch.Generator().manual_seed(1)).requires_grad_()
    qmatmul(x, qt).float().sum().backward()
    assert x.grad is not None and x.grad.shape == x.shape and x.grad.dtype == x.dtype
    assert all(t.grad is None for t in (qt.packed, qt.absmax, qt.absmax_scale,
                                        qt.absmax_offset) if t is not None)


def test_input_without_gradient_records_nothing():
    """The first layer's q/k/v linears see an input that needs no gradient:
    the output then carries no graph, so no backward can run for it."""
    qt = quantize(torch.randn(128, 64, generator=torch.Generator().manual_seed(2)))
    y = qmatmul(torch.randn(4, 128).to(torch.bfloat16), qt)
    assert not y.requires_grad and y.grad_fn is None
    before = qmm_nf4_bwd.launches
    x = torch.randn(4, 128).requires_grad_()
    with torch.no_grad():
        assert qmatmul(x, qt).grad_fn is None
    assert qmm_nf4_bwd.launches == before        # and the CPU path never counts a launch


@pytest.mark.parametrize("double_quant", [True, False])
def test_forward_and_backward_see_the_same_weight(double_quant):
    """An identity input reads the weight out of the forward, an identity
    cotangent out of the backward: both are the dequantized bf16 weight bit
    for bit, and that weight is JAX's."""
    rng = np.random.default_rng(5)
    K, N = 256, 192
    jqt = jquantize(jnp.asarray((rng.normal(size=(K, N)) * 0.05).astype(np.float32)),
                    double_quant=double_quant)
    qt = _carry(jqt)
    w = dequantize(qt, torch.bfloat16)
    x = torch.eye(K, dtype=torch.bfloat16).requires_grad_()
    y = qmatmul(x, qt)
    assert torch.equal(y.detach(), w)
    y.backward(torch.eye(K, N, dtype=torch.bfloat16))
    # dx = I[K, N] @ Wᵀ: its first N rows are Wᵀ's
    assert torch.equal(x.grad[:N], w.T.contiguous())
    assert torch.equal(qmatmul_bwd_plain(torch.eye(N, dtype=torch.bfloat16), qt), w.T)
    np.testing.assert_array_equal(w.view(torch.uint16).numpy(),
                                  np.asarray(jdequantize(jqt, jnp.bfloat16)).view(np.uint16))


def test_backward_wrapper_checks_operands_before_launch():
    qt = quantize(torch.randn(256, 64, generator=torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="does not match"):
        qmm_nf4_bwd(torch.zeros(4, 32, dtype=torch.bfloat16), qt)
