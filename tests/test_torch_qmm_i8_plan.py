"""The int8 wgmma kernel's plan (``ops/qmatmul.py: i8_tile_plan``), on the
CPU: which shapes the forward and dx of int8 storage send to
``csrc/qmm_i8_wgmma.cu``, how its CTAs cover the output, and that the plan's
constants are the kernel's own.  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``)."""

import re
from pathlib import Path

import pytest
import torch

from qlora_tpu_torch.ops.qmatmul import DECODE_ROWS, i8_tile_plan, i8_tile_smem

LLAMA_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096)]
SMEM_PER_BLOCK = 232448            # 227 KB, what an H100 block may use


def _kernel_constants():
    """TN, TK, the rows a CTA and the ring's k-steps at each, as
    ``csrc/qmm_i8_wgmma.cu`` defines them."""
    src = (Path(__file__).resolve().parent.parent / "qlora_tpu_torch" / "csrc"
           / "qmm_i8_wgmma.cu").read_text()
    c = {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1)) for k in ("TN", "TK")}
    per_mt = int(re.search(r"static constexpr int TM = (\d+) \* MT;", src).group(1))
    one, two = map(int, re.search(r"static constexpr int STAGES = MT == 1 \? (\d+) : (\d+);",
                                  src).groups())
    c["stages"] = {per_mt: one, 2 * per_mt: two}
    return c


# the LLaMA-7B linears at a verify chunk's 40 rows, one past DECODE_ROWS, the
# train step's micro-batch and the prefill; ragged M, contractions that are no
# multiple of the 64-row k-step (192, 200), ragged N, block sizes 2, 12, 32, 64
# and K = 64 * 600 (three meta-blocks of absmax)
PLAN_SHAPES = [(M, K, N, 64) for M in (17, 40, 1024, 2048) for K, N in LLAMA_SHAPES] + [
    (37, 384, 200, 64), (300, 192, 72, 32), (37, 64 * 600, 200, 64), (300, 384, 72, 12),
    (50, 192, 200, 2), (129, 200, 72, 8), (3000, 256, 2048, 64), (17, 64, 40, 2)]


@pytest.mark.parametrize("bwd", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("M,K,N,block_size", PLAN_SHAPES, ids=str)
def test_i8_plan_covers_every_output_once(M, K, N, block_size, bwd):
    """CTAs of 128 or 256 rows by 128 output columns, clipped at the ragged
    edges, cover every element of the output ([M, N] forward, [M, K]
    backward) exactly once, and the k-steps of 64 cover the contraction (K
    forward, N backward; the last one masked past its end)."""
    plan = i8_tile_plan(M, K, N, block_size, bwd)
    assert plan.accepted, plan.reason
    C, O = (N, K) if bwd else (K, N)
    seen = torch.zeros(M, O, dtype=torch.int32)
    for m0, m1, o0, o1 in plan.tiles(M, O):
        assert m0 < m1 <= M and o0 < o1 <= O
        assert m1 - m0 <= plan.tm and o1 - o0 <= plan.tn
        seen[m0:m1, o0:o1] += 1
    assert (seen == 1).all()
    assert len(plan.tiles(M, O)) == plan.grid[0] * plan.grid[1]
    assert (plan.steps - 1) * plan.tkp < C <= plan.steps * plan.tkp


@pytest.mark.parametrize("bwd", [False, True], ids=["fwd", "bwd"])
def test_i8_plan_matches_the_kernel_and_fits_shared_memory(bwd):
    """The plan's tile sizes and rings are the kernel's own constants, and its
    shared memory (the ring of activation boxes and B tiles, the producers'
    staged codes, 1024 bytes of alignment and 1024 of barriers) stays within
    the 227 KB a block of an H100 may use, at 128 and at 256 rows a CTA."""
    c = _kernel_constants()
    for M, tm in ((40, 128), (1024, 256)):
        plan = i8_tile_plan(M, 4096, 4096, 64, bwd)
        assert (plan.tm, plan.tn, plan.tkp, plan.stages) == (tm, c["TN"], c["TK"],
                                                             c["stages"][tm])
        stage = tm * c["TK"] * 2 + c["TK"] * c["TN"] * 2
        assert plan.smem == i8_tile_smem(tm) == (1024 + plan.stages * stage
                                                 + 4 * c["TK"] * c["TN"] + 1024)
        assert plan.smem <= SMEM_PER_BLOCK


def test_i8_plan_takes_256_rows_past_one_wave():
    """A CTA takes 256 rows only where 128-row tiles would need more than one
    wave of CTAs on the card: the training and prefill rows of LLaMA-7B in
    both directions, not a verify chunk of 40 or 256 rows of a 4096-column
    output."""
    for bwd in (False, True):
        assert [i8_tile_plan(M, 4096, 4096, 64, bwd).tm for M in (40, 256, 1024, 2048)] == [
            128, 128, 256, 256]
        assert i8_tile_plan(1024, 4096, 4096, 64, bwd, sms=512).tm == 128
        assert i8_tile_plan(1024, 11008, 4096, 64, bwd).tm == 256
    assert i8_tile_plan(40, 4096, 11008, 64, False).tm == 128


MODELS = ["huggyllama/llama-7b", "huggyllama/llama-65b", "meta-llama/Llama-2-70b-hf",
          "EleutherAI/pythia-70m", "EleutherAI/pythia-12b", "mistralai/Mistral-7B-v0.1",
          "Qwen/Qwen2-0.5B", "Qwen/Qwen2-7B", "meta-llama/Meta-Llama-3-8B", "google/gemma-2b",
          "google/gemma-7b", "debug", "debug-neox", "debug-gemma"]


@pytest.mark.parametrize("name", MODELS)
def test_i8_plan_accepts_every_model_linear(name):
    """Every block linear and the lm_head of every configuration the port
    knows take the wgmma kernel above DECODE_ROWS rows, forward and
    backward: all have K % 8 == 0 and N % 8 == 0."""
    from qlora_tpu_torch.models.config import get_config
    from qlora_tpu_torch.models.transformer import linear_dims

    cfg = get_config(name)
    shapes = list(linear_dims(cfg).values()) + [(cfg.hidden_size, cfg.vocab_size)]
    for K, N in shapes:
        for M in (DECODE_ROWS + 1, 1024):
            for bwd in (False, True):
                plan = i8_tile_plan(M, K, N, 64, bwd)
                assert plan.accepted, (name, K, N, bwd, plan.reason)


def test_i8_plan_refuses_decode_rows_and_strides_tma_cannot_take():
    """Up to DECODE_ROWS rows stay on qmm_i8.cu; so does a contraction whose
    bf16 row stride is no multiple of 16 bytes (K % 8 != 0 forward, N % 8 !=
    0 backward), while the other direction of the same weight is taken."""
    assert DECODE_ROWS == 16
    for bwd in (False, True):
        plan = i8_tile_plan(DECODE_ROWS, 4096, 4096, 64, bwd)
        assert not plan.accepted and "16" in plan.reason
        assert i8_tile_plan(DECODE_ROWS + 1, 4096, 4096, 64, bwd).accepted
    plan = i8_tile_plan(20, 36, 40, 4, bwd=False)
    assert not plan.accepted and "K=36" in plan.reason and "multiple of 8" in plan.reason
    assert i8_tile_plan(20, 36, 40, 4, bwd=True).accepted
    plan = i8_tile_plan(20, 480, 50, 12, bwd=True)
    assert not plan.accepted and "N=50" in plan.reason and "multiple of 8" in plan.reason
    assert i8_tile_plan(20, 480, 50, 12, bwd=False).accepted
    assert not i8_tile_plan(40, 100, 64, 64, bwd=False).accepted      # K % block_size
