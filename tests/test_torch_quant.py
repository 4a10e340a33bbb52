"""Port storage (qlora_tpu_torch.quant) against the JAX package's.

The same f32 weight, made with numpy from a seed, goes through both
``quantize`` functions.  Packed nibbles and a plain f32 absmax do not depend
on any float reduction and must be byte-identical.  Double quant centres the
absmax on its mean, a float sum whose last bit depends on summation order,
so its offset is held within 2 ulp, the meta-scales within rel 1e-6 and the
int8 codes within ±1.  A tensor quantized by JAX and carried across
dequantizes bit-exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qlora_tpu.quant import dequantize as jdequantize
from qlora_tpu.quant import quantize as jquantize
from qlora_tpu.quant.codebooks import CODEBOOKS as JCODEBOOKS

from qlora_tpu_torch.quant import (
    CODEBOOKS, QuantizedTensor, dequantize, local_chunk, quantize, quantize_k_sharded,
)

torch.set_num_threads(2)


def _carry(jqt) -> QuantizedTensor:
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))
    return QuantizedTensor(t(jqt.packed), t(jqt.absmax), t(jqt.absmax_scale),
                           t(jqt.absmax_offset), tuple(jqt.shape), jqt.block_size,
                           jqt.quant_type)


def _weight(K, N, seed):
    return (np.random.default_rng(seed).normal(size=(K, N)) * 0.05).astype(np.float32)


SHAPES = [(512, 96), (256, 130), (64 * 300, 8)]   # the last: 2 meta-blocks per column


@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
@pytest.mark.parametrize("K,N", SHAPES)
def test_quantize_matches_jax(quant_type, K, N):
    w = _weight(K, N, seed=K + N)
    w[:64, 0] = 0.0                                       # an all-zero block
    for dq in (False, True):
        j = jquantize(jnp.asarray(w), quant_type=quant_type, double_quant=dq)
        t = quantize(torch.from_numpy(w), quant_type=quant_type, double_quant=dq)
        assert t.packed.dtype == torch.uint8 and t.shape == (K, N)
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


@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
@pytest.mark.parametrize("double_quant", [False, True])
def test_dequantize_of_carried_tensor_is_bit_exact(quant_type, double_quant):
    w = _weight(64 * 300, 24, seed=5)
    j = jquantize(jnp.asarray(w), quant_type=quant_type, double_quant=double_quant)
    t = _carry(j)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jdequantize(j, dtype=jdt))
        got = dequantize(t, tdt)
        if tdt == torch.bfloat16:
            np.testing.assert_array_equal(got.view(torch.uint16).numpy(),
                                          want.view(np.uint16))
        else:
            np.testing.assert_array_equal(got.numpy(), want)


def test_codebooks_match():
    for k in ("nf4", "fp4"):
        np.testing.assert_array_equal(CODEBOOKS[k], JCODEBOOKS[k])


def test_round_trip_error_and_rejections():
    w = torch.from_numpy(_weight(256, 64, seed=9))
    err = (dequantize(quantize(w), torch.float32) - w).abs().max().item()
    # the widest NF4 gap (0.7230 → 1.0) bounds the error at 0.14 · absmax
    assert err <= 0.14 * w.abs().max().item()
    with pytest.raises(ValueError):
        quantize(torch.zeros(96, 8))                     # K not a multiple of 128
    with pytest.raises(ValueError):
        quantize(torch.zeros(96, 8), quant_type="int8")  # K not a multiple of 64
    assert quantize(torch.zeros(64, 8), quant_type="int8").packed.dtype == torch.int8
    with pytest.raises(NotImplementedError):
        quantize_k_sharded(w, 2)
    with pytest.raises(NotImplementedError):
        local_chunk(None)
