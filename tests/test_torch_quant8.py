"""int8 blockwise storage (``--bits 8``) and ``qmatmul`` over it, against the
JAX package's.

The same f32 weight, made with numpy from a seed, goes through both
``quantize`` functions.  The int8 codes and a plain f32 absmax are one
division, one multiplication and one rounding per element, no reduction but a
maximum: byte-identical.  Double quant centres the absmax on its mean, a float
sum whose last bit depends on summation order, so its offset is held within
2 ulp, the meta-scales within rel 1e-6 and the absmax codes within ±1, as in
``test_torch_quant``.  ``qmatmul`` (forward and dx) runs JAX's Pallas kernels
in interpret mode where K and N are multiples of 128 and its XLA path at
192 x 200; both sides multiply the same bf16 weight with f32 sums in another
order: within one bf16 ulp of the output's scale."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qlora_tpu.ops.qmatmul import qmatmul as jqmatmul
from qlora_tpu.quant import dequantize as jdequantize
from qlora_tpu.quant import quantize as jquantize
from qlora_tpu.quant.blockwise import logical_k as jlogical_k

from qlora_tpu_torch.models.layers import QLinear
from qlora_tpu_torch.ops import qmatmul, qmm_i8_bwd_plain, qmm_i8_fwd_plain
from qlora_tpu_torch.quant import dequantize, logical_k, quantize
from qlora_tpu_torch.utils.convert import params_from_numpy
from test_torch_convert import jax_to_numpy

torch.set_num_threads(2)


def _weight(K, N, seed, scale=0.05):
    return (np.random.default_rng(seed).normal(size=(K, N)) * scale).astype(np.float32)


def _carry(jqt):
    """A JAX QuantizedTensor through ``utils.convert`` (as a QLinear lm_head
    of an otherwise empty tree)."""
    tree = {"embed": np.zeros((1, 1), np.float32), "blocks": [], "final_norm": {},
            "lm_head": {"qt": jax_to_numpy(jqt), "bias": None}}
    lin = params_from_numpy(tree, None, "cpu")["lm_head"]
    assert isinstance(lin, QLinear)
    return lin.qt


@pytest.mark.parametrize("K,N,block_size", [(512, 96, 64), (192, 200, 64), (64 * 300, 8, 64),
                                            (256, 130, 256), (256, 48, 32)])
def test_quantize_int8_matches_jax(K, N, block_size):
    w = _weight(K, N, seed=K + N)
    w[:block_size, 0] = 0.0                                  # an all-zero block
    # per column (block_size == K, the serving copy) is never double-quantized:
    # one absmax row minus its own mean leaves nothing but rounding error
    for dq in (False, True) if block_size < K else (False,):
        j = jquantize(jnp.asarray(w), block_size=block_size, quant_type="int8",
                      double_quant=dq)
        t = quantize(torch.from_numpy(w), block_size=block_size, quant_type="int8",
                     double_quant=dq)
        assert t.packed.dtype == torch.int8 and tuple(t.packed.shape) == (K, N)
        assert t.quant_type == "int8" and t.shape == (K, N) and t.double_quant == dq
        assert logical_k(t) == K == jlogical_k(j)
        assert t.nbytes == K * N + t.absmax.numel() * (1 if dq else 4) + (
            t.absmax_scale.numel() * 4 + 4 if dq else 0)
        np.testing.assert_array_equal(t.packed.numpy(), np.asarray(j.packed))
        if not dq:
            np.testing.assert_array_equal(t.absmax.numpy(), np.asarray(j.absmax))
            continue
        joff = np.float32(j.absmax_offset)
        assert abs(t.absmax_offset.item() - joff) <= 2 * np.spacing(joff)
        np.testing.assert_allclose(t.absmax_scale.numpy(), np.asarray(j.absmax_scale),
                                   rtol=1e-6, atol=0)
        codes = t.absmax.numpy().astype(np.int32) - np.asarray(j.absmax).astype(np.int32)
        assert np.abs(codes).max() <= 1


@pytest.mark.parametrize("double_quant", [False, True])
def test_carried_int8_tensor_dequantizes_bit_exact(double_quant):
    w = _weight(64 * 300, 24, seed=5)
    j = jquantize(jnp.asarray(w), quant_type="int8", double_quant=double_quant)
    t = _carry(j)
    assert t.packed.dtype == torch.int8 and t.quant_type == "int8"
    np.testing.assert_array_equal(t.packed.numpy(), np.asarray(j.packed))
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jdequantize(j, dtype=jdt))
        got = dequantize(t, tdt)
        if tdt == torch.bfloat16:
            np.testing.assert_array_equal(got.view(torch.uint16).numpy(), want.view(np.uint16))
        else:
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("double_quant", [False, True])
def test_int8_round_trip_error(double_quant):
    """The JAX package's bar (tests/test_quant8.py): int8 is more than 4x
    closer than NF4 on a standard normal weight, mean error under 6e-3."""
    w = torch.from_numpy(_weight(256, 256, seed=0, scale=1.0))
    back = dequantize(quantize(w, quant_type="int8", double_quant=double_quant),
                      torch.float32)
    err8 = (back - w).abs().mean().item()
    back4 = dequantize(quantize(w, double_quant=double_quant), torch.float32)
    assert err8 < (back4 - w).abs().mean().item() / 4 and err8 < 6e-3


def _ulp_tol(ref):
    """One bf16 ulp (2^-8 relative, doubled for a value just above a power of
    two) of the output's largest value."""
    return 2.0 ** -7 * np.abs(ref).max()


@pytest.mark.parametrize("M,K,N,double_quant", [
    (32, 256, 384, False), (32, 256, 384, True), (5, 128, 128, True), (4, 192, 200, False),
    (4, 192, 200, True),
])
def test_int8_qmatmul_forward_and_dx_match_jax(M, K, N, double_quant):
    rng = np.random.default_rng(M + K + N)
    w, x = _weight(K, N, seed=1, scale=1.0), rng.normal(size=(M, K)).astype(np.float32)
    g = rng.normal(size=(M, N)).astype(np.float32)
    j = jquantize(jnp.asarray(w), quant_type="int8", double_quant=double_quant)
    t = _carry(j)
    jx = jnp.asarray(x, jnp.bfloat16)
    want, vjp = jax.vjp(lambda a: jqmatmul(a, j), jx)
    (want_dx,) = vjp(jnp.asarray(g, jnp.bfloat16))
    want, want_dx = np.asarray(want, np.float32), np.asarray(want_dx, np.float32)

    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    got = qmatmul(tx, t)
    got.backward(torch.from_numpy(g).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and tx.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0, atol=_ulp_tol(want))
    np.testing.assert_allclose(tx.grad.float().numpy(), want_dx, rtol=0,
                               atol=_ulp_tol(want_dx))
    # the plain versions are what the CPU path ran
    assert torch.equal(got.detach(), qmm_i8_fwd_plain(tx.detach(), t))
    assert torch.equal(tx.grad, qmm_i8_bwd_plain(torch.from_numpy(g), t))


def test_int8_identity_operands_read_out_the_decoded_weight():
    """An identity input reads the weight out of the forward, an identity
    cotangent out of the backward: both are ``dequantize``, bit for bit."""
    for dq in (False, True):
        qt = quantize(torch.from_numpy(_weight(128, 96, seed=3)), quant_type="int8",
                      double_quant=dq)
        w = dequantize(qt, torch.bfloat16)
        assert torch.equal(qmatmul(torch.eye(128, dtype=torch.bfloat16), qt), w)
        assert torch.equal(qmm_i8_bwd_plain(torch.eye(96, dtype=torch.bfloat16), qt), w.T)
