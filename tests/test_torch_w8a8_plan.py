"""The w8a8 wgmma kernel's plan (``ops/qmatmul.py: w8a8_tile_plan``), on the
CPU: which NF4/FP4 w8a8 products go to ``csrc/qmm_nf4_w8a8_wgmma.cu``, how
its CTAs cover the output, that the plan's constants are the kernel's own,
the dispatch with the launchers replaced by recording stand-ins, and the
producers' transposed decode (packed bytes -> int8 codes in a K-major,
64-byte-swizzled B tile) written out in numpy against ``w8a8_codes``.  The
kernel itself runs only on the card (``tests/test_torch_cuda.py``).

Tolerances: the decode is integer-valued and held exactly; the plain
version against the JAX kernel to one bf16 ulp of the output's scale, as
tests/test_torch_serve_int8.py holds it (both sides sum the same int8
products exactly)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qlora_tpu.ops.qmatmul import _qmm_pallas_w8a8
from qlora_tpu.quant import absmax_f32 as jabsmax_f32
from qlora_tpu.quant import quantize as jquantize

from qlora_tpu_torch.ops import qmm_nf4_w8a8_plain
from qlora_tpu_torch.quant import quantize
from test_torch_quant import _carry
from test_torch_serve_int8 import _inputs, _ulp_tol, tq

SOURCE = (Path(__file__).resolve().parent.parent / "qlora_tpu_torch" / "csrc"
          / "qmm_nf4_w8a8_wgmma.cu")
LLAMA_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096)]
SMEM_PER_BLOCK = 232448            # 227 KB, what an H100 block may use
torch.set_num_threads(2)


def _kernel_constants():
    """TN, TKP, ROWS, the rows a CTA and the ring's k-steps at each, as the
    kernel source defines them."""
    src = SOURCE.read_text()
    c = {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
         for k in ("TN", "TKP", "ROWS", "THREADS")}
    per_mt = int(re.search(r"static constexpr int TM = (\d+) \* MT;", src).group(1))
    one, two = map(int, re.search(r"static constexpr int STAGES = MT == 1 \? (\d+) : (\d+);",
                                  src).groups())
    c["stages"] = {per_mt: one, 2 * per_mt: two}
    return c


# the LLaMA-7B linears at a chunk's 17 rows, parity-int8's 128-token prefill,
# serve-paged's commonest prefill (512) and a 4 x 512 group; ragged M, N 200
# and 72, K/2 no multiple of the 64-row k-step (192, 384), block sizes 8, 32
# and 64 (4 is refused), K = 64 * 600
PLAN_SHAPES = [(M, K, N, 64) for M in (17, 128, 512, 2048) for K, N in LLAMA_SHAPES] + [
    (37, 384, 200, 64), (300, 1024, 72, 32), (50, 256, 72, 8), (129, 192, 200, 32),
    (17, 64 * 600, 200, 64), (3000, 256, 2048, 64)]


@pytest.mark.parametrize("M,K,N,block_size", PLAN_SHAPES, ids=str)
def test_w8a8_plan_covers_every_output_once(M, K, N, block_size):
    """CTAs of 128 or 256 rows by 128 columns, clipped at the ragged edges,
    cover every element of y [M, N] exactly once, and the k-steps of 64
    packed rows cover K/2 (the last one masked past its end)."""
    plan = tq.w8a8_tile_plan(M, K, N, block_size)
    assert plan.accepted, plan.reason
    seen = torch.zeros(M, N, dtype=torch.int32)
    for m0, m1, n0, n1 in plan.tiles(M, N):
        assert m0 < m1 <= M and n0 < n1 <= N
        assert m1 - m0 <= plan.tm and n1 - n0 <= plan.tn
        seen[m0:m1, n0:n1] += 1
    assert (seen == 1).all()
    assert len(plan.tiles(M, N)) == plan.grid[0] * plan.grid[1]
    assert (plan.steps - 1) * plan.tkp < K // 2 <= plan.steps * plan.tkp


def test_w8a8_plan_matches_the_kernel_and_fits_shared_memory():
    """The plan's tiles and rings are the kernel's constants; its shared
    memory (per k-step two x8 boxes [tm, 64] and two int8 B tiles [128, 64],
    the producers' staged bytes, 1024 bytes of alignment and 1024 of
    barriers) stays within an H100 block's 227 KB at 128 and 256 rows; a
    producer warpgroup of 128 threads, 8 packed rows by 8 columns each,
    covers a k-step."""
    c = _kernel_constants()
    for M, tm in ((128, 128), (2048, 256)):
        plan = tq.w8a8_tile_plan(M, 4096, 4096, 64)
        assert (plan.tm, plan.tn, plan.tkp, plan.stages) == (tm, c["TN"], c["TKP"],
                                                             c["stages"][tm])
        stage = 2 * tm * c["TKP"] + 2 * c["TN"] * c["TKP"]
        assert plan.smem == tq.w8a8_tile_smem(tm) == (1024 + plan.stages * stage
                                                      + 4 * c["TKP"] * c["TN"] + 1024)
        assert plan.smem <= SMEM_PER_BLOCK
    assert c["TKP"] * c["TN"] == 128 * c["ROWS"] * 8 and c["THREADS"] == 512


def test_w8a8_plan_takes_256_rows_past_one_wave():
    """256-row CTAs only where 128-row tiles would need more than one wave:
    not at 128 or 512 rows of a 4096-column output, at 512 rows of 11008
    columns and at 2048 rows."""
    assert [tq.w8a8_tile_plan(M, 4096, 4096, 64).tm for M in (17, 128, 512, 2048)] == [
        128, 128, 128, 256]
    assert tq.w8a8_tile_plan(512, 4096, 11008, 64).tm == 256
    assert tq.w8a8_tile_plan(2048, 4096, 4096, 64, sms=1024).tm == 128


def test_w8a8_plan_refuses_decode_rows_and_k_tma_cannot_take():
    """Up to DECODE_ROWS rows stay on qmm_i8_direct.cu, and so do K % 32 !=
    0 (the high plane's x8 boxes start at column K/2, which TMA needs on a
    16-byte boundary) and N or block sizes that are no multiple of 8 (a
    producer thread takes 8 columns of 8 rows in one block), each with its
    reason; K % (2 B) != 0 is no NF4 shape."""
    assert tq.DECODE_ROWS == 16
    plan = tq.w8a8_tile_plan(16, 4096, 4096, 64)
    assert not plan.accepted and "16" in plan.reason and "qmm_i8_direct.cu" in plan.reason
    assert tq.w8a8_tile_plan(17, 4096, 4096, 64).accepted
    for K in (200, 48, 4096 + 16):
        plan = tq.w8a8_tile_plan(40, K, 64, 8)
        assert not plan.accepted and f"K={K}" in plan.reason and "32" in plan.reason
    plan = tq.w8a8_tile_plan(40, 96, 64, 64)
    assert not plan.accepted and "no NF4 shape" in plan.reason
    for N, B in ((50, 64), (36, 8), (72, 4), (200, 12)):
        plan = tq.w8a8_tile_plan(40, 1536, N, B)
        assert not plan.accepted and f"N={N}, block {B}" in plan.reason
    assert tq.w8a8_tile_plan(40, 1536, 72, 8).accepted


MODELS = ["huggyllama/llama-7b", "huggyllama/llama-65b", "meta-llama/Llama-2-70b-hf",
          "EleutherAI/pythia-70m", "EleutherAI/pythia-12b", "mistralai/Mistral-7B-v0.1",
          "Qwen/Qwen2-0.5B", "Qwen/Qwen2-7B", "meta-llama/Meta-Llama-3-8B", "google/gemma-2b",
          "google/gemma-7b", "debug", "debug-neox", "debug-gemma"]


@pytest.mark.parametrize("name", MODELS)
def test_w8a8_plan_accepts_every_model_linear(name):
    """Every block linear and the lm_head of every configuration the port
    knows take the wgmma kernel above DECODE_ROWS rows at the NF4 block size:
    all have K % 128 == 0."""
    from qlora_tpu_torch.models.config import get_config
    from qlora_tpu_torch.models.transformer import linear_dims

    cfg = get_config(name)
    for K, N in list(linear_dims(cfg).values()) + [(cfg.hidden_size, cfg.vocab_size)]:
        for M in (tq.DECODE_ROWS + 1, 512):
            plan = tq.w8a8_tile_plan(M, K, N, 64)
            assert plan.accepted, (name, K, N, plan.reason)


def test_w8a8_dispatch_with_recording_launchers(monkeypatch):
    """``qmm_nf4_w8a8`` and ``_w8a8_accumulators`` with the launcher replaced
    by a recording stand-in: up to DECODE_ROWS rows, K % 32 != 0 and N % 8
    != 0 go to
    qmm_i8_direct.cu's entry with no plan, more rows to the wgmma entry with
    the plan ``w8a8_tile_plan`` gives; only the wgmma launches add to
    ``wgmma_launches``, every call with rows to ``launches``, none without."""
    calls = []

    def launch(entry, x8, qt, ratio, s_out, xs, plan=None):
        calls.append((entry, x8.shape[0], s_out is None, plan))
        return torch.zeros(x8.shape[0], qt.packed.shape[-1])

    monkeypatch.setattr(tq, "_launch_w8a8", launch)
    monkeypatch.setitem(tq._SMS, torch.device("cpu"), 132)
    monkeypatch.setattr(tq, "_TILE_PLANS", {})
    rng = np.random.default_rng(3)
    qt = quantize(torch.from_numpy(rng.normal(size=(256, 72)).astype(np.float32)))
    odd = quantize(torch.from_numpy(rng.normal(size=(200, 24)).astype(np.float32)),
                   block_size=4)
    narrow = quantize(torch.from_numpy(rng.normal(size=(256, 36)).astype(np.float32)),
                      block_size=8)
    launches, wgmma = tq.qmm_nf4_w8a8.launches, tq.qmm_nf4_w8a8.wgmma_launches
    for M, q in ((4, qt), (16, qt), (17, qt), (300, qt), (40, odd), (40, narrow), (0, qt)):
        tq.qmm_nf4_w8a8(torch.from_numpy(rng.normal(size=(M, q.shape[0])).astype(np.float32)), q)
    tq._w8a8_accumulators(torch.zeros(130, 256, dtype=torch.int8), qt)
    assert [(e, m, raw) for e, m, raw, _ in calls] == [
        ("qmm_nf4_w8a8", 4, False), ("qmm_nf4_w8a8", 16, False),
        ("qmm_nf4_w8a8_wgmma", 17, False), ("qmm_nf4_w8a8_wgmma", 300, False),
        ("qmm_nf4_w8a8", 40, False), ("qmm_nf4_w8a8", 40, False), ("qmm_nf4_w8a8", 0, False),
        ("qmm_nf4_w8a8_wgmma", 130, True)]
    for e, m, _, plan in calls:
        assert (plan is None) == (e == "qmm_nf4_w8a8")
        if plan is not None:
            assert plan == tq.w8a8_tile_plan(m, 256, 72, 64)
    assert tq.qmm_nf4_w8a8.launches == launches + 6
    assert tq.qmm_nf4_w8a8.wgmma_launches == wgmma + 2


def _producer_tiles(packed, ratio, code, K, N, B, s, n0):
    """One k-step's two B tiles as the producers write them: thread pt of a
    warpgroup takes packed rows s * 64 + 8 (pt % 8) .. + 7 and columns n0 +
    8 (pt // 8) .. + 7; each code is the low byte of f32(code * ratio) + 1.5 *
    2^23 (f32 arithmetic, rounded to nearest even); the 8 codes of a column
    and plane go to bytes (pt % 8 & 1) * 8 .. of chunk ((pt % 8) >> 1) ^
    ((nl >> 1) & 3) of the plane's 64-byte row nl.  Returns the raw tiles
    [2, 128 * 64] and the 8-byte granule of each store, in the order a
    thread issues them."""
    K2 = K // 2
    tiles = np.zeros((2, 128 * 64), np.uint8)
    granules = {}
    for pt in range(128):
        rg, cg = pt & 7, pt >> 3
        for e in range(8):
            ec = e ^ (cg & 1)                      # odd column groups store in the other order
            nl, n = 8 * cg + ec, n0 + 8 * cg + ec
            at = nl * 64 + ((((rg >> 1) ^ (nl >> 1)) & 3) << 4) + ((rg & 1) << 3)
            granules.setdefault(e, {})[pt] = (at // 8) % 16
            for plane in range(2):
                for i in range(8):
                    r = s * 64 + 8 * rg + i
                    if r >= K2 or n >= N:
                        continue
                    nib = (int(packed[r, n]) >> (4 * plane)) & 15
                    p = np.float32(code[nib]) * np.float32(ratio[(plane * K2 + r) // B, n])
                    word = np.array([p + np.float32(12582912.0)], np.float32).view(np.uint32)
                    tiles[plane, at + i] = word[0] & 0xFF
    return tiles, granules


def _unswizzle(tile):
    """A plane's B tile [n][k], 64-byte rows of k, chunk c of row n at
    c ^ ((n >> 1) & 3), read back in logical order: [128, 64] bytes."""
    out = np.zeros((128, 64), np.uint8)
    for n in range(128):
        for k in range(64):
            out[n, k] = tile[n * 64 + (((k >> 4) ^ (n >> 1)) & 3) * 16 + (k & 15)]
    return out


@pytest.mark.parametrize("K,N,B,steps", [(256, 128, 64, (0, 1)), (384, 200, 64, (2,)),
                                         (192, 72, 32, (1,)), (256, 136, 8, (0, 1))])
@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
@pytest.mark.parametrize("double_quant", [True, False])
def test_producers_transposed_decode_is_w8a8_codes(K, N, B, steps, quant_type, double_quant):
    """The producers' decode and transposed K-major store, written out in
    numpy, read back through the swizzle, equal ``w8a8_codes`` in both
    planes (rows past K/2 and columns past N zero), and the 8-byte stores of
    each half-warp hit 16 distinct 8-byte granules of the 32 banks."""
    rng = np.random.default_rng(K + N + B)
    qt = quantize(torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32)), block_size=B,
                  quant_type=quant_type, double_quant=double_quant)
    ratio, _ = tq.w8a8_scales(qt)
    w8 = tq.w8a8_codes(qt, ratio).numpy().astype(np.int16)
    code = tq._code_on(quant_type, torch.device("cpu")).numpy()
    packed, ratio = qt.packed.numpy(), ratio.numpy()
    K2 = K // 2
    for n0 in range(0, N, 128):
        for s in steps:
            tiles, granules = _producer_tiles(packed, ratio, code, K, N, B, s, n0)
            for plane in range(2):
                got = _unswizzle(tiles[plane]).astype(np.int8).astype(np.int16)
                want = np.zeros((128, 64), np.int16)
                rows = np.arange(s * 64, min(s * 64 + 64, K2))
                cols = np.arange(n0, min(n0 + 128, N))
                want[:len(cols), :len(rows)] = w8[plane * K2 + rows][:, cols].T
                np.testing.assert_array_equal(got, want)
            for by_thread in granules.values():
                for half in range(0, 128, 16):
                    assert len({by_thread[pt] for pt in range(half, half + 16)}) == 16


@pytest.mark.parametrize("M,K,N,quant_type,dq", [(40, 256, 128, "nf4", True),
                                                 (48, 512, 256, "fp4", False)])
def test_nf4_w8a8_plain_matches_jax_kernel_above_16_rows(M, K, N, quant_type, dq):
    """At rows the wgmma kernel takes, the plain version (which the kernel
    equals bit for bit on the card) against the JAX kernel in interpret mode
    on the same bf16 rows and weight, as tests/test_torch_serve_int8.py
    compares them at decode rows."""
    w, x = _inputs(M, K, N, seed=K + M)
    j = jquantize(jnp.asarray(w), quant_type=quant_type, double_quant=dq)
    want = np.asarray(_qmm_pallas_w8a8(jnp.asarray(x), j.packed, jabsmax_f32(j), (K, N),
                                       j.block_size, j.quant_type), np.float32)
    t = _carry(j)
    assert tq.w8a8_tile_plan(M, K, N, t.block_size).accepted
    got = qmm_nf4_w8a8_plain(torch.from_numpy(x), t)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=_ulp_tol(want))


def test_tile_sweep_w8a8_edits_apply_to_the_source():
    """Every w8a8 variant and mutant of ``ops/tile_sweep.py`` finds the text
    it replaces in the kernel source, once."""
    from qlora_tpu_torch.ops import tile_sweep

    text = SOURCE.read_text()
    for table in (tile_sweep.W8A8, tile_sweep.W8A8_MUTANTS):
        for name, edits in table.items():
            for old, new in edits:
                assert text.count(old) == 1, (name, old)
                assert old != new
    assert tile_sweep.MUTANT_SETS["w8a8"][0] == SOURCE.name
