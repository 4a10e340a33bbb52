"""The int8 decode kernel's plan (``ops/qmatmul.py: i8_decode_plan``), on the
CPU: how ``csrc/qmm_i8_decode.cu`` splits K across the blocks of a cluster,
that the plan's constants are the kernel's own, that the dispatch sends the
forward's decode rows to it, and its fragment map (which code each lane
decodes into which mma register, and where each accumulator lands) written
out in numpy against ``dequantize`` and the plain version.  The kernel itself
runs only on the card (``tests/test_torch_cuda.py``)."""

import importlib
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from qlora_tpu_torch.ops import qmm_i8_bwd, qmm_i8_fwd, qmm_i8_fwd_plain
from qlora_tpu_torch.ops.qmatmul import DECODE_ROWS, i8_decode_plan
from qlora_tpu_torch.quant import absmax_f32, dequantize, quantize

qm = importlib.import_module("qlora_tpu_torch.ops.qmatmul")
SOURCE = Path(__file__).resolve().parent.parent / "qlora_tpu_torch" / "csrc" / "qmm_i8_decode.cu"
LLAMA_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096)]


def _constants():
    src = SOURCE.read_text()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
            for k in ("COLS", "TILES", "WARPS", "KSTEP", "DEPTH", "PASS_ROWS", "MAX_SPLITS")}


# the LLaMA-7B linears (and lm_head), block sizes 64 and 256, block sizes that
# are no multiple of the 16-row k-step (4, 8, 24: units of 16 or 48 rows),
# per-column storage (B = K: a unit past 1024 rows falls back to 16), ragged
# K and N, three meta-blocks of absmax, one strip
PLAN_SHAPES = [(K, N, 64) for K, N in LLAMA_SHAPES] + [(4096, 32000, 64), (2048, 320, 256), (256, 72, 4), (480, 56, 24),
                              (36, 40, 4), (4096, 4096, 4096), (64 * 600, 96, 64), (192, 200, 8)]


@pytest.mark.parametrize("K,N,block_size", PLAN_SHAPES, ids=str)
def test_i8_decode_plan_covers_k_once_in_whole_blocks(K, N, block_size):
    """The splits cover the rows of W once, in order, each a run of whole
    units (the last clipped at K); a unit is a multiple of the 16-row k-step
    and, where that stays within 1024 rows, of the block size; at most 16
    splits (one cluster) and no split without a unit."""
    plan = i8_decode_plan(K, N, block_size, 132)
    assert plan.accepted, plan.reason
    assert plan.unit % 16 == 0
    assert plan.unit % block_size == 0 or math.lcm(block_size, 16) > 1024
    assert 1 <= plan.splits <= 16 and plan.strips == -(-N // 128)
    spans = plan.split_rows(K)
    assert spans[0][0] == 0 and spans[-1][1] == K
    for (a0, a1), (b0, _) in zip(spans, spans[1:]):
        assert a1 == b0
    for r0, r1 in spans:
        assert r0 < r1 and r0 % plan.unit == 0 and (r1 % plan.unit == 0 or r1 == K)
    assert plan.splits <= -(-K // plan.unit)


def test_i8_decode_plan_fills_the_card_and_ignores_the_rows():
    """About two blocks an SM at LLaMA-7B's linears (9, 4 and 9 splits of 32,
    86 and 32 strips on 132 SMs); the plan is a function of (K, N, block
    size, SMs) only, and the dispatch hands the kernel the same plan at 1 to
    16 rows."""
    assert [i8_decode_plan(K, N, 64, 132).splits for K, N in LLAMA_SHAPES] == [9, 4, 9]
    assert i8_decode_plan(4096, 4096, 64, 264).splits == 16          # a cluster at most
    assert list(i8_decode_plan.__code__.co_varnames[:4]) == ["K", "N", "block_size", "sms"]


def test_i8_decode_plan_matches_the_kernel_and_fits_shared_memory():
    """The plan's constants are the kernel's, and the shared memory the C
    entry asks for (a pass of x, or the warps' and the block's partials)
    stays within the 200 KB it allows at every LLaMA shape and the longest
    pass."""
    c = _constants()
    assert c["COLS"] == qm._DECODE_COLS == 128 and c["MAX_SPLITS"] == qm._DECODE_MAX_SPLITS
    assert c["KSTEP"] == qm._I8_DECODE_KSTEP == 16 and c["TILES"] * 16 == c["COLS"]
    assert c["DEPTH"] == 1 and c["WARPS"] == 4
    for K, N in LLAMA_SHAPES + [(64 * 1100, 32)]:
        plan = i8_decode_plan(K, N, 64, 132)
        rows = min(-(-(-(-K // plan.unit)) // plan.splits) * plan.unit, c["PASS_ROWS"])
        pitch = -(-(rows // 2) // 32) * 32 + 4
        for mt in (1, 2):
            stage = mt * 8 * pitch * 4
            parts = ((c["WARPS"] - 1) * mt * c["TILES"] * 4 * 32 + mt * 8 * c["COLS"]) * 4
            assert max(stage, parts) <= 200 * 1024


def test_i8_decode_plan_refuses_what_is_no_int8_shape():
    plan = i8_decode_plan(100, 64, 64, 132)
    assert not plan.accepted and "K=100" in plan.reason
    assert not i8_decode_plan(0, 64, 64, 132).accepted
    assert i8_decode_plan(36, 40, 4, 132).accepted          # K % 16 != 0 is fine


def _recording(monkeypatch):
    """Replace the launchers by stand-ins that record which kernel ran and
    return the plain result; returns the record."""
    calls = []
    plain = qm.qmatmul_plain

    def decode(x, qt, scale, offset, plan=None):
        calls.append(("decode", x.shape[0], plan))
        return plain(x, qt)

    def wgmma(lib, entry, a, qt, outer, scale, offset, plan):
        calls.append(("wgmma", entry, a.shape[0]))
        return torch.zeros(a.shape[0], outer, dtype=torch.bfloat16)

    def tile(lib, entry, a, qt, outer, scale, offset):
        calls.append(("tile", entry, a.shape[0]))
        return torch.zeros(a.shape[0], outer, dtype=torch.bfloat16)

    monkeypatch.setattr(qm, "_decode_launch", decode)
    monkeypatch.setattr(qm, "_wgmma_launch", wgmma)
    monkeypatch.setattr(qm, "_launch", tile)
    monkeypatch.setitem(qm._SMS, torch.device("cpu"), 132)
    return calls


@pytest.mark.parametrize("double_quant", [True, False])
def test_i8_dispatch_sends_decode_rows_to_the_decode_kernel(monkeypatch, double_quant):
    """The forward takes the decode kernel at 1 to 16 rows, with one plan
    for all of them, and counts it in ``decode_launches``; 17 rows take the
    wgmma kernel; the dx at 16 rows takes qmm_i8.cu; no rows, no launch."""
    calls = _recording(monkeypatch)
    g = torch.Generator().manual_seed(3)
    qt = quantize(torch.randn(256, 72, generator=g), quant_type="int8",
                  double_quant=double_quant)
    n0 = (qmm_i8_fwd.launches, qmm_i8_fwd.decode_launches, qmm_i8_fwd.wgmma_launches,
          qmm_i8_bwd.launches, qmm_i8_bwd.wgmma_launches)
    for M in range(1, DECODE_ROWS + 1):
        x = torch.randn(M, 256, generator=g).to(torch.bfloat16)
        assert torch.equal(qmm_i8_fwd(x, qt), qmm_i8_fwd_plain(x, qt))
    plans = {c[2] for c in calls}
    assert [c[:2] for c in calls] == [("decode", M) for M in range(1, DECODE_ROWS + 1)]
    assert plans == {i8_decode_plan(256, 72, 64, 132)}
    qmm_i8_fwd(torch.zeros(DECODE_ROWS + 1, 256, dtype=torch.bfloat16), qt)
    qmm_i8_bwd(torch.zeros(DECODE_ROWS, 72, dtype=torch.bfloat16), qt)
    qmm_i8_fwd(torch.zeros(0, 256, dtype=torch.bfloat16), qt)
    assert calls[DECODE_ROWS:] == [("wgmma", "qmm_i8_wgmma_fwd", DECODE_ROWS + 1),
                                   ("tile", "qmm_i8_bwd", DECODE_ROWS)]
    assert (qmm_i8_fwd.launches, qmm_i8_fwd.decode_launches, qmm_i8_fwd.wgmma_launches,
            qmm_i8_bwd.launches, qmm_i8_bwd.wgmma_launches) == (
        n0[0] + DECODE_ROWS + 1, n0[1] + DECODE_ROWS, n0[2] + 1, n0[3] + 1, n0[4])


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _emulate(x, qt, sms=132):
    """The decode kernel's arithmetic written out lane by lane: per block
    (strip, split), each warp's k-steps of 16 rows; lane (g, t) decodes rows
    kb + (2t, 2t+1, 2t+8, 2t+9) of its 16 columns c = 16 g ..; tile i's A
    registers pair two k-rows of column c + 2i (A row g) and c + 2i + 1 (A
    row g + 8); x's bf16 pairs are the B registers; the m16n8k16 products
    are taken as f32 sums of exact products; warps add in warp order, splits
    in split order; one rounding to bf16."""
    K, N = qt.packed.shape
    M = x.shape[0]
    plan = i8_decode_plan(K, N, qt.block_size, sms)
    codes = qt.packed.numpy().astype(np.float32)
    am = absmax_f32(qt).numpy()
    xb = _bf16(x.float().numpy())
    r = np.float32(1.0 / 127.0)
    y = np.zeros((M, N), np.float32)
    for strip in range(plan.strips):
        cb = strip * 128
        total = np.zeros((M, 128), np.float32)
        for r0, r1 in plan.split_rows(K):
            nsteps = -(-(r1 - r0) // 16)                    # one pass: K <= 4096 here
            part = np.zeros((M, 128), np.float32)
            for wk in range(4):
                acc = np.zeros((M, 128), np.float32)
                for s in range(wk * nsteps // 4, (wk + 1) * nsteps // 4):
                    kb = r0 + 16 * s
                    A = np.zeros((8, 16, 16), np.float32)   # [tile i][A row][k]
                    cols = np.zeros((8, 16), np.int64)
                    for g in range(8):
                        c = cb + 16 * g
                        for t in range(4):
                            ro = (2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)
                            for i in range(8):
                                for q, arow in ((0, g), (1, g + 8)):
                                    n = c + 2 * i + q
                                    cols[i, arow] = n
                                    for h in range(4):
                                        row = kb + ro[h]
                                        if row < r1 and n < N:
                                            w = np.float32(codes[row, n] * r) * am[row // qt.block_size, n]
                                            A[i, arow, ro[h]] = w
                    A = _bf16(A)
                    Bx = np.zeros((16, M), np.float32)      # B [k][x row]: x pairs
                    ks = kb + np.arange(16)
                    Bx[ks < r1] = xb[:, ks[ks < r1]].T
                    for i in range(8):
                        D = (A[i].astype(np.float64) @ Bx.astype(np.float64)).astype(np.float32)
                        for arow in range(16):
                            if cols[i, arow] < N:
                                acc[:, cols[i, arow] - cb] += D[arow]
                part += acc                                  # warp order
            total += part                                    # split order
        n1 = min(cb + 128, N)
        y[:, cb:n1] = total[:, :n1 - cb]
    return torch.from_numpy(y).to(torch.bfloat16)


@pytest.mark.parametrize("K,N,block_size", [(192, 40, 64), (256, 72, 16), (96, 136, 32), (192, 40, 8)])
@pytest.mark.parametrize("double_quant", [True, False])
def test_i8_decode_fragment_map_reads_out_the_weight(K, N, block_size, double_quant):
    """The kernel's fragment map, emulated: rows of the identity read out
    ``dequantize``'s weight bit for bit (every (row, column) of W lands once,
    in the right column, decoded as dequantize does), and random rows agree
    with the plain version within one bf16 ulp plus f32 reassociation."""
    g = torch.Generator().manual_seed(K + N)
    qt = quantize(torch.randn(K, N, generator=g) * K ** -0.5, block_size=block_size,
                  quant_type="int8", double_quant=double_quant)
    ks = [0, 1, 7, 8, 15, 16, block_size - 1, block_size, K - 2, K - 1]
    eye = torch.zeros(len(ks), K, dtype=torch.bfloat16)
    eye[torch.arange(len(ks)), torch.tensor(ks)] = 1
    assert torch.equal(_emulate(eye, qt), dequantize(qt, torch.bfloat16)[ks])
    x = torch.randn(5, K, generator=g).to(torch.bfloat16)
    torch.testing.assert_close(_emulate(x, qt).float(), qmm_i8_fwd_plain(x, qt).float(),
                               rtol=1e-2, atol=2e-2)
