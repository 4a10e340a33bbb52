"""Port timing helpers (``ops/bench_kernels.py``) against the JAX package's
repeat-grid helpers (Pallas in interpret mode) at a small shape, reps=2.

``qmm_repeat`` and ``qmm_bwd_repeat`` decode the same f32-absmax NF4 weight
and sum in f32 in another order: rtol 1e-2, atol 2e-2, the qmm kernels'
tolerance.  ``i8_direct_repeat`` is an exact int32 sum times one f32 scale
rounded to bf16 on both sides: equal bit for bit."""

import jax.numpy as jnp
import numpy as np
import torch

from qlora_tpu.ops.bench_kernels import i8_direct_repeat as ji8
from qlora_tpu.ops.bench_kernels import qmm_bwd_repeat as jbwd
from qlora_tpu.ops.bench_kernels import qmm_repeat as jqmm
from qlora_tpu.quant.blockwise import quantize as jquantize

from qlora_tpu_torch.ops.bench_kernels import i8_direct_repeat, qmm_bwd_repeat, qmm_repeat
from qlora_tpu_torch.utils import to_tensor

torch.set_num_threads(2)
K, N, M = 256, 256, 16


def _nf4():
    rng = np.random.default_rng(0)
    qt = jquantize(jnp.asarray(rng.normal(size=(K, N)) * K ** -0.5, jnp.float32),
                   double_quant=False)
    return qt, rng


def test_qmm_repeat_matches_jax():
    qt, rng = _nf4()
    x = jnp.asarray(rng.normal(size=(M, K)), jnp.bfloat16)
    want = jqmm(x, qt.packed, qt.absmax, (K, N), qt.block_size, "nf4", reps=2)
    got = qmm_repeat(to_tensor(np.asarray(x)), to_tensor(np.asarray(qt.packed)),
                     to_tensor(np.asarray(qt.absmax)), (K, N), qt.block_size, "nf4", reps=2)
    assert got.shape == (M, N) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=1e-2, atol=2e-2)


def test_qmm_bwd_repeat_matches_jax():
    qt, rng = _nf4()
    g = jnp.asarray(rng.normal(size=(M, N)), jnp.bfloat16)
    want = jbwd(g, qt.packed, qt.absmax, (K, N), qt.block_size, "nf4", reps=2, tk=128, tn=128)
    got = qmm_bwd_repeat(to_tensor(np.asarray(g)), to_tensor(np.asarray(qt.packed)),
                         to_tensor(np.asarray(qt.absmax)), (K, N), qt.block_size, "nf4", reps=2)
    assert got.shape == (M, K)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=1e-2, atol=2e-2)


def test_i8_direct_repeat_matches_jax():
    rng = np.random.default_rng(1)
    x8 = rng.integers(-127, 128, size=(M, K)).astype(np.int8)
    w8 = rng.integers(-127, 128, size=(K, N)).astype(np.int8)
    s_out = (rng.random(N) * 1e-3).astype(np.float32)[None, :]
    want = ji8(jnp.asarray(x8), jnp.asarray(w8), jnp.asarray(s_out), (K, N), reps=2,
               tk=128, tn=128)
    got = i8_direct_repeat(torch.from_numpy(x8), torch.from_numpy(w8),
                           torch.from_numpy(s_out), (K, N), reps=2)
    np.testing.assert_array_equal(got.view(torch.uint16).numpy(),
                                  np.asarray(want).view(np.uint16))
