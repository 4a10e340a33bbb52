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


def _kernel_constants():
    """TN, TKP, the rows a CTA and the ring's k-steps at each, as
    ``csrc/qmm_nf4_wgmma.cu`` defines them."""
    import re
    from pathlib import Path

    src = (Path(__file__).resolve().parent.parent / "qlora_tpu_torch" / "csrc"
           / "qmm_nf4_wgmma.cu").read_text()
    c = {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1)) for k in ("TN", "TKP")}
    per_mt = int(re.search(r"static constexpr int TM = (\d+) \* MT;", src).group(1))
    one, two = map(int, re.search(r"static constexpr int STAGES = MT == 1 \? (\d+) : (\d+);",
                                  src).groups())
    c["stages"] = {per_mt: one, 2 * per_mt: two}
    return c


TILE_SHAPES = [(M, K, N, 64) for M in (17, 40, 1024, 2048) for K, N in LLAMA_SHAPES] + [
    (37, 384, 200, 64), (300, 1024, 320, 32), (129, 64 * 600, 96, 64), (50, 256, 72, 4),
    (33, 480, 50, 12), (17, 192, 72, 32), (20, 64, 40, 2), (3000, 256, 2048, 64)]


@pytest.mark.parametrize("M,K,N,block_size", TILE_SHAPES, ids=str)
def test_tile_plan_covers_every_output_once(M, K, N, block_size):
    """The wgmma kernel's plan: CTAs of 128 or 256 rows by 128 columns,
    clipped at the ragged M and N edges, cover every output element exactly
    once, and the k-steps of 64 packed rows cover K/2 (the last one masked
    past K/2)."""
    from qlora_tpu_torch.ops.qmatmul import tile_plan

    plan = tile_plan(M, K, N, block_size)
    assert plan.accepted, plan.reason
    seen = torch.zeros(M, N, dtype=torch.int32)
    for m0, m1, n0, n1 in plan.tiles(M, N):
        assert m0 < m1 <= M and n0 < n1 <= N
        assert m1 - m0 <= plan.tm and n1 - n0 <= plan.tn
        seen[m0:m1, n0:n1] += 1
    assert (seen == 1).all()
    assert len(plan.tiles(M, N)) == plan.grid[0] * plan.grid[1]
    assert (plan.steps - 1) * plan.tkp < K // 2 <= plan.steps * plan.tkp


def test_tile_plan_matches_the_kernel_and_fits_shared_memory():
    """The plan's tile sizes and rings are the kernel's own constants, and its
    shared memory (the ring of x boxes and B tiles, the producers' staged
    packed bytes, 1024 bytes of alignment and 1024 of barriers) stays within
    the 227 KB a block of an H100 may use, at 128 and at 256 rows a CTA."""
    from qlora_tpu_torch.ops.qmatmul import tile_plan, tile_smem

    c = _kernel_constants()
    for M, tm in ((40, 128), (1024, 256)):
        plan = tile_plan(M, 4096, 4096, 64)
        assert (plan.tm, plan.tn, plan.tkp, plan.stages) == (tm, c["TN"], c["TKP"],
                                                             c["stages"][tm])
        stage = 2 * tm * c["TKP"] * 2 + 2 * c["TKP"] * c["TN"] * 2
        assert plan.smem == tile_smem(tm) == 1024 + plan.stages * stage + 4 * c["TKP"] * c["TN"] + 1024
        assert plan.smem + 16 * 4 <= 232448          # and the codebook's static 64 bytes


def test_tile_plan_takes_256_rows_past_one_wave():
    """A CTA takes 256 rows only where 128-row tiles would need more than one
    wave of CTAs on the card: the training and prefill rows of LLaMA-7B, not
    a verify chunk of 40 or 256 rows of a 4096-column weight."""
    from qlora_tpu_torch.ops.qmatmul import tile_plan

    assert [tile_plan(M, 4096, 4096, 64).tm for M in (40, 256, 1024, 2048)] == [128, 128, 256,
                                                                                  256]
    assert tile_plan(1024, 4096, 4096, 64, sms=512).tm == 128
    assert tile_plan(40, 4096, 11008, 64).tm == 128


MODELS = ["huggyllama/llama-7b", "huggyllama/llama-65b", "meta-llama/Llama-2-70b-hf",
          "EleutherAI/pythia-70m", "EleutherAI/pythia-12b", "mistralai/Mistral-7B-v0.1",
          "Qwen/Qwen2-0.5B", "Qwen/Qwen2-7B", "meta-llama/Meta-Llama-3-8B", "google/gemma-2b",
          "google/gemma-7b", "debug", "debug-neox", "debug-gemma"]


@pytest.mark.parametrize("name", MODELS)
def test_tile_plan_accepts_every_model_linear(name):
    """Every block linear and the lm_head of every configuration the port
    knows take the wgmma kernel above DECODE_ROWS rows: all have K % 8 == 0."""
    from qlora_tpu_torch.models.config import get_config
    from qlora_tpu_torch.models.transformer import linear_dims
    from qlora_tpu_torch.ops.qmatmul import tile_plan

    cfg = get_config(name)
    shapes = list(linear_dims(cfg).values()) + [(cfg.hidden_size, cfg.vocab_size)]
    for K, N in shapes:
        for M in (DECODE_ROWS + 1, 1024):
            plan = tile_plan(M, K, N, 64)
            assert plan.accepted, (name, K, N, plan.reason)


def test_tile_plan_refuses_k_not_multiple_of_8():
    """K % 8 != 0 (a 2K-byte row stride TMA cannot take): refused with the
    reason, and the dispatch sends such shapes to the tile kernel."""
    from qlora_tpu_torch.ops.qmatmul import tile_plan

    plan = tile_plan(20, 36, 40, 6)
    assert not plan.accepted and "multiple of 8" in plan.reason
    assert tile_plan(20, 40, 40, 4).accepted


def test_tile_sweep_edits_apply_to_the_sources():
    """Every ablation and mutant of ``ops/tile_sweep.py`` finds the text it
    replaces in the kernel source it edits (once), so the sweep and the
    mutants run on the card against the sources as they are; each set of
    mutants names the source it edits."""
    from qlora_tpu_torch.ops import tile_sweep

    for source, table in (("qmm_nf4_wgmma.cu", tile_sweep.WGMMA),
                          ("qmm_nf4_wgmma.cu", tile_sweep.MUTANTS),
                          ("qmm_nf4_fwd.cu", tile_sweep.TILE),
                          ("qmm_i8_wgmma.cu", tile_sweep.I8),
                          ("qmm_i8_wgmma.cu", tile_sweep.I8_MUTANTS)):
        text = (tile_sweep.CSRC / source).read_text()
        for name, edits in table.items():
            for old, new in edits:
                assert text.count(old) == 1, (source, name, old)
                assert old != new
    assert {k: v[0] for k, v in tile_sweep.MUTANT_SETS.items()} == {
        "nf4": "qmm_nf4_wgmma.cu", "int8": "qmm_i8_wgmma.cu"}
