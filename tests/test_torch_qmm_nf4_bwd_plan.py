"""The NF4 dx kernel's plan (``ops/qmatmul.py: nf4_bwd_tile_plan``), on the
CPU: which backward shapes of NF4/FP4 storage go to
``csrc/qmm_nf4_bwd_wgmma.cu``, how its CTAs cover dx through the split-half
column map (two runs a CTA, at packed row p and at K/2 + p, masked at K/2),
that the plan's constants are the kernel's own, and that the dispatch
follows the plan.  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``)."""

import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from qlora_tpu_torch.ops import qmatmul_bwd_plain, qmm_nf4_bwd
from qlora_tpu_torch.ops.qmatmul import DECODE_ROWS, nf4_bwd_tile_plan, nf4_bwd_tile_smem
from qlora_tpu_torch.quant import absmax_f32, dequantize, quantize
from qlora_tpu_torch.quant.codebooks import get_code

LLAMA_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096)]
SMEM_PER_BLOCK = 232448            # 227 KB, what an H100 block may use


def _kernel_constants():
    """TN, TK, ROWS, the rows a CTA and the ring's k-steps at each, as
    ``csrc/qmm_nf4_bwd_wgmma.cu`` defines them."""
    src = (Path(__file__).resolve().parent.parent / "qlora_tpu_torch" / "csrc"
           / "qmm_nf4_bwd_wgmma.cu").read_text()
    c = {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
         for k in ("TN", "TK", "ROWS")}
    assert re.search(r"constexpr int TP = TN / 2;", src)
    per_mt = int(re.search(r"static constexpr int TM = (\d+) \* MT;", src).group(1))
    one, two = map(int, re.search(r"static constexpr int STAGES = MT == 1 \? (\d+) : (\d+);",
                                  src).groups())
    c["stages"] = {per_mt: one, 2 * per_mt: two}
    return c


# the LLaMA-7B linears at one past DECODE_ROWS, a verify chunk's 40 rows, the
# train step's micro-batch and the prefill's rows; then ragged shapes: K/2 %
# 64 != 0 (K = 320, B = 32: 32 columns into the last tile; K = 200, B = 2:
# K/2 % 8 != 0), ragged N and M, block 12, K = 64 * 600 (three meta-blocks of
# absmax), 3000 rows
PLAN_SHAPES = [(M, K, N, 64) for M in (17, 40, 1024, 2048) for K, N in LLAMA_SHAPES] + [
    (37, 320, 64, 32), (50, 200, 72, 2), (129, 384, 200, 64), (37, 64 * 600, 200, 64),
    (17, 480, 56, 12), (3000, 256, 2048, 64)]


@pytest.mark.parametrize("M,K,N,block_size", PLAN_SHAPES, ids=str)
def test_nf4_bwd_plan_covers_every_output_once(M, K, N, block_size):
    """Each CTA writes two runs of at most 64 dx columns, the same packed
    rows in both planes (p0 .. p1 at p and at K/2 + p, clipped at K/2);
    together the runs of all CTAs cover every element of dx [M, K] exactly
    once, and the k-steps of 64 cover the contraction N."""
    plan = nf4_bwd_tile_plan(M, K, N, block_size)
    assert plan.accepted, plan.reason
    K2 = K // 2
    seen = torch.zeros(M, K, dtype=torch.int32)
    tiles = plan.tiles(M, K)
    assert len(tiles) == 2 * plan.grid[0] * plan.grid[1]
    for (m0, m1, k0, k1), (hm0, hm1, h0, h1) in zip(tiles[::2], tiles[1::2]):
        assert (m0, m1) == (hm0, hm1) and 0 <= m0 < m1 <= M and m1 - m0 <= plan.tm
        assert 0 <= k0 < k1 <= K2 and k1 - k0 <= plan.tn // 2 and k0 % (plan.tn // 2) == 0
        assert (h0, h1) == (K2 + k0, K2 + k1)
        seen[m0:m1, k0:k1] += 1
        seen[m0:m1, h0:h1] += 1
    assert (seen == 1).all()
    assert plan.grid[1] == -(-K2 // (plan.tn // 2))
    assert (plan.steps - 1) * plan.tkp < N <= plan.steps * plan.tkp


def test_nf4_bwd_plan_matches_the_kernel_and_fits_shared_memory():
    """The plan's tile sizes and rings are the kernel's own constants, and its
    shared memory (the ring of g boxes and B tiles of 128 dx columns by 64
    n, the producers' staged packed bytes, 1024 bytes of alignment and 1024
    of barriers, and the codebook's static 64 bytes) stays within the 227 KB
    a block of an H100 may use, at 128 and at 256 rows a CTA."""
    c = _kernel_constants()
    assert (c["TN"] // 2) * c["TK"] // 8 // c["ROWS"] == 128    # one producer warpgroup
    for M, tm in ((40, 128), (1024, 256)):
        plan = nf4_bwd_tile_plan(M, 4096, 4096, 64)
        assert (plan.tm, plan.tn, plan.tkp, plan.stages) == (tm, c["TN"], c["TK"],
                                                             c["stages"][tm])
        stage = tm * c["TK"] * 2 + c["TN"] * c["TK"] * 2
        staged = 4 * (c["TN"] // 2) * c["TK"]
        assert plan.smem == nf4_bwd_tile_smem(tm) == 1024 + plan.stages * stage + staged + 1024
        assert plan.smem + 16 * 4 <= SMEM_PER_BLOCK


def test_nf4_bwd_plan_takes_256_rows_past_one_wave():
    """A CTA takes 256 rows only where 128-row tiles would need more than one
    wave of CTAs: the training and prefill rows of LLaMA-7B's linears (dx of
    4096 columns: 32 runs of packed rows; of 11008: 86), not a verify chunk
    of 40 rows or 256 rows of a 4096-column dx."""
    assert [nf4_bwd_tile_plan(M, 4096, 4096, 64).tm for M in (40, 256, 1024, 2048)] == [
        128, 128, 256, 256]
    assert nf4_bwd_tile_plan(1024, 4096, 4096, 64, sms=512).tm == 128
    plan = nf4_bwd_tile_plan(1024, 11008, 4096, 64)
    assert (plan.tm, plan.grid) == (256, (4, 86))
    assert nf4_bwd_tile_plan(40, 11008, 4096, 64).tm == 128


MODELS = ["huggyllama/llama-7b", "huggyllama/llama-65b", "meta-llama/Llama-2-70b-hf",
          "EleutherAI/pythia-70m", "EleutherAI/pythia-12b", "mistralai/Mistral-7B-v0.1",
          "Qwen/Qwen2-0.5B", "Qwen/Qwen2-7B", "meta-llama/Meta-Llama-3-8B", "google/gemma-2b",
          "google/gemma-7b", "debug", "debug-neox", "debug-gemma"]


@pytest.mark.parametrize("name", MODELS)
def test_nf4_bwd_plan_accepts_every_model_linear(name):
    """Every block linear and the lm_head of every configuration the port
    knows take the wgmma kernel for dx above DECODE_ROWS rows: all have
    N % 8 == 0."""
    from qlora_tpu_torch.models.config import get_config
    from qlora_tpu_torch.models.transformer import linear_dims

    cfg = get_config(name)
    shapes = list(linear_dims(cfg).values()) + [(cfg.hidden_size, cfg.vocab_size)]
    for K, N in shapes:
        for M in (DECODE_ROWS + 1, 1024):
            plan = nf4_bwd_tile_plan(M, K, N, 64)
            assert plan.accepted, (name, K, N, plan.reason)


def test_nf4_bwd_plan_refuses_decode_rows_and_n_not_multiple_of_8():
    """Up to DECODE_ROWS rows stay on qmm_nf4_bwd.cu, and so does an N whose
    bf16 row stride is no multiple of 16 bytes; K needs no such condition."""
    assert DECODE_ROWS == 16
    plan = nf4_bwd_tile_plan(DECODE_ROWS, 4096, 4096, 64)
    assert not plan.accepted and "16" in plan.reason
    assert nf4_bwd_tile_plan(DECODE_ROWS + 1, 4096, 4096, 64).accepted
    plan = nf4_bwd_tile_plan(20, 480, 50, 12)
    assert not plan.accepted and "N=50" in plan.reason and "multiple of 8" in plan.reason
    assert nf4_bwd_tile_plan(20, 36, 40, 2).accepted                  # K % 8 != 0 is fine
    assert not nf4_bwd_tile_plan(40, 192, 64, 64).accepted           # K % (2 * block)


@pytest.mark.parametrize("double_quant", [True, False])
def test_nf4_bwd_dispatch_follows_the_plan(monkeypatch, double_quant):
    """``qmm_nf4_bwd`` launches the wgmma kernel exactly where the plan
    accepts the shape (17 rows; not 16, not N % 8 != 0) and counts it in
    ``wgmma_launches``, else ``qmm_nf4_bwd.cu``; no rows, no launch.  The
    launchers are replaced by recording stand-ins (the kernels run only on
    the card), so this checks the dispatch on the CPU."""
    qm = importlib.import_module("qlora_tpu_torch.ops.qmatmul")
    calls = []

    def fake_wgmma(lib, entry, a, qt, outer, scale, offset, plan):
        calls.append((lib, plan.tm))
        return qmatmul_bwd_plain(a, qt)

    def fake_launch(lib, entry, a, qt, outer, scale, offset):
        calls.append((lib, None))
        return qmatmul_bwd_plain(a, qt)

    monkeypatch.setattr(qm, "_wgmma_launch", fake_wgmma)
    monkeypatch.setattr(qm, "_launch", fake_launch)
    monkeypatch.setitem(qm._SMS, torch.device("cpu"), 132)
    monkeypatch.setattr(qmm_nf4_bwd, "launches", 0)
    monkeypatch.setattr(qmm_nf4_bwd, "wgmma_launches", 0)
    gen = torch.Generator().manual_seed(9)
    cases = [(320, 64, 32, DECODE_ROWS, "qmm_nf4_bwd"),
             (320, 64, 32, DECODE_ROWS + 1, "qmm_nf4_bwd_wgmma"),
             (480, 50, 12, 20, "qmm_nf4_bwd"), (200, 72, 2, 300, "qmm_nf4_bwd_wgmma"),
             (4096, 64, 64, 1024, "qmm_nf4_bwd_wgmma")]
    for K, N, B, M, lib in cases:
        qt = quantize(torch.randn(K, N, generator=gen), block_size=B, double_quant=double_quant)
        g = torch.randn(M, N, generator=gen).to(torch.bfloat16)
        dx = qmm_nf4_bwd(g, qt)
        assert calls[-1][0] == lib and dx.shape == (M, K), (K, N, M)
        assert torch.equal(dx, qmatmul_bwd_plain(g, qt))
    assert (qmm_nf4_bwd.launches, qmm_nf4_bwd.wgmma_launches) == (5, 3)
    # 1024 rows of a 4096-column dx: 8 x 32 CTAs of 128 rows, more than a wave
    assert [tm for _, tm in calls] == [None, 128, None, 128, 256]
    qmm_nf4_bwd(torch.zeros(0, 64, dtype=torch.bfloat16), qt)
    assert (qmm_nf4_bwd.launches, qmm_nf4_bwd.wgmma_launches) == (5, 3)


@pytest.mark.parametrize("K,N,block_size", [(320, 64, 32), (200, 72, 2), (480, 56, 12),
                                            (64 * 260 * 2, 16, 64)], ids=str)
@pytest.mark.parametrize("double_quant", [True, False])
def test_split_half_runs_decode_dequantize_columns(K, N, block_size, double_quant):
    """The kernel's decode, written out in numpy over the plan's runs: a
    CTA's packed rows p0 .. p1, low nibbles with absmax rows p / B for the
    low run and high nibbles with absmax rows (K/2 + p) / B for the high
    run, each element one f32 product rounded once to bf16, give
    ``dequantize``'s weight bit for bit at every dx column (at K = 64 * 520
    the planes' absmax rows lie in different meta-blocks of 256)."""
    qt = quantize(torch.randn(K, N, generator=torch.Generator().manual_seed(K + N)),
                  block_size=block_size, double_quant=double_quant)
    plan = nf4_bwd_tile_plan(DECODE_ROWS + 1, K, N, block_size)
    packed = qt.packed.numpy()
    am = absmax_f32(qt).numpy()
    code = np.asarray(get_code(qt.quant_type), np.float32)
    K2, B = K // 2, block_size
    w = torch.zeros(K, N, dtype=torch.bfloat16)
    for _, _, k0, k1 in plan.tiles(DECODE_ROWS + 1, K)[::2]:
        p = np.arange(k0, k1)
        for nib, cols in ((packed[k0:k1] & 15, p), (packed[k0:k1] >> 4, K2 + p)):
            w[torch.from_numpy(cols)] = torch.from_numpy(code[nib] * am[cols // B]).to(
                torch.bfloat16)
    assert torch.equal(w, dequantize(qt, torch.bfloat16))
