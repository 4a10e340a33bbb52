"""The dx decode kernels' plans (``ops/qmatmul.py: nf4_bwd_decode_plan``,
``i8_bwd_decode_plan``), on the CPU: how ``csrc/qmm_nf4_bwd_decode.cu`` and
``csrc/qmm_i8_bwd_decode.cu`` cut dx's columns into strips and the
contraction N into splits, that the plans' constants are the kernels' own,
that the dispatch sends 1 to 16 rows of dx to them wherever the plan accepts
the shape, and the kernels' maps (which weight each lane decodes into which
mma slot, which columns of g are the B fragment, where each accumulator
lands) written out in numpy against ``dequantize`` and the plain version.
The kernels themselves run only on the card (``tests/test_torch_cuda.py``).

Tolerance: the emulation sums the same exact bf16 products as the plain
version in another order before one rounding to bf16: rtol 1e-2, atol 1e-2,
the qmm tests' tolerance."""

import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from qlora_tpu_torch.models.config import PRESETS, get_config
from qlora_tpu_torch.models.transformer import linear_dims
from qlora_tpu_torch.ops import qmatmul_bwd_plain, qmm_i8_bwd, qmm_nf4_bwd
from qlora_tpu_torch.ops.qmatmul import DECODE_ROWS, i8_bwd_decode_plan, nf4_bwd_decode_plan
from qlora_tpu_torch.quant import absmax_f32, dequantize, logical_k, quantize
from qlora_tpu_torch.quant.codebooks import get_code

torch.set_num_threads(2)
qm = importlib.import_module("qlora_tpu_torch.ops.qmatmul")
CSRC = Path(__file__).resolve().parent.parent / "qlora_tpu_torch" / "csrc"
PLANS = {"nf4": nf4_bwd_decode_plan, "int8": i8_bwd_decode_plan}
SOURCES = {"nf4": "qmm_nf4_bwd_decode.cu", "int8": "qmm_i8_bwd_decode.cu"}
LLAMA_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096)]
# a tp-4 rank's shards of LLaMA-7B (PERF.md's kernel table, row 1): wq / wk /
# wv, w_gate / w_up with the MLP padded to 11264, wo's and w_down's K-chunks
TP_SHAPES = [(4096, 1024), (4096, 2816), (1024, 4096), (2816, 4096)]


def _constants(kind):
    src = (CSRC / SOURCES[kind]).read_text()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
            for k in ("STRIP", "WARPS", "KSTEP", "PASS_COLS", "MAX_SPLITS")}


def _preset_shapes():
    out = set()
    for name in sorted(PRESETS):
        cfg = get_config(name)
        out |= set(linear_dims(cfg).values()) | {(cfg.hidden_size, cfg.vocab_size)}
    return sorted(out) + TP_SHAPES


@pytest.mark.parametrize("kind", ["nf4", "int8"])
@pytest.mark.parametrize("K,N", _preset_shapes(), ids=str)
def test_bwd_decode_plan_covers_dx_and_the_contraction_once(kind, K, N):
    """For every linear of every preset (and the lm_heads, and a tp-4 rank's
    shards): the plan accepts the shape; the strips' runs of dx columns
    cover every column of dx exactly once (NF4: the same packed rows in both
    planes, at p and K/2 + p); every strip's splits cover the contraction N
    exactly once, in order, in whole 128-column k-steps; at most 16 splits
    a cluster, about two blocks an SM; the shared memory fits."""
    plan = PLANS[kind](K, N, 64, 132)
    assert plan.accepted, (K, N, plan.reason)
    c = _constants(kind)
    assert plan.strip == c["STRIP"] and plan.planes == (2 if kind == "nf4" else 1)
    seen = np.zeros(K, np.int64)
    runs = plan.strip_cols(K)
    assert len(runs) == plan.strips
    for strip in runs:
        assert len(strip) == plan.planes
        for k0, k1 in strip:
            assert 0 <= k0 < k1 <= K and k1 - k0 <= plan.strip
            seen[k0:k1] += 1
        if kind == "nf4":
            assert strip[1] == (strip[0][0] + K // 2, strip[0][1] + K // 2)
    assert (seen == 1).all()
    spans = plan.split_cols(N)
    assert 1 <= plan.splits == len(spans) <= c["MAX_SPLITS"]
    assert spans[0][0] == 0 and spans[-1][1] == N
    for (_, a1), (b0, _) in zip(spans, spans[1:]):
        assert a1 == b0
    assert all(c0 < c1 and c0 % c["KSTEP"] == 0 for c0, c1 in spans)
    assert plan.splits == min(-(-N // 128), 16, -(-2 * 132 // plan.strips))
    for M in (1, 8, 16):
        assert plan.smem(M, 64) <= 232448 // 2          # two blocks an SM at least


@pytest.mark.parametrize("kind", ["nf4", "int8"])
def test_bwd_decode_plan_matches_the_kernel(kind):
    """The plan's constants are the kernel's, and its shared memory is what
    the C entry asks for: g's rows of a pass (8 or 16 at a pitch of cols / 2
    + 4 words, 4 mod 32) and, where the block size is a multiple of the
    strip, the strip's absmax rows with 4 floats after every 32 columns;
    within the 200 KB the entry allows at every LLaMA shape."""
    c = _constants(kind)
    src = (CSRC / SOURCES[kind]).read_text()
    assert c["KSTEP"] == qm._BWD_DECODE_KSTEP and c["PASS_COLS"] == qm._BWD_DECODE_PASS
    assert c["MAX_SPLITS"] == qm._DECODE_MAX_SPLITS and c["WARPS"] == 4
    assert c["STRIP"] == (qm._NF4_BWD_STRIP if kind == "nf4" else qm._I8_BWD_STRIP)
    assert "const int pitch = cols / 2 + 4;" in src
    assert "int am_at(int j) { return j + 4 * (j >> 5); }" in src
    for K, N in LLAMA_SHAPES + [(256, 4096 * 9)]:
        plan = PLANS[kind](K, N, 64, 132)
        units = -(-N // 128)
        assert plan.cols == min(-(-units // plan.splits) * 128, c["PASS_COLS"])
        assert (plan.cols // 2 + 4) % 32 == 4
        for M, mt in ((4, 1), (16, 2)):
            am = plan.planes * (plan.cols + 4 * (plan.cols // 32))
            assert plan.smem(M, 64) == (mt * 8 * (plan.cols // 2 + 4) + am) * 4 <= 200 * 1024
            assert plan.smem(M, 12) == mt * 8 * (plan.cols // 2 + 4) * 4


def test_bwd_decode_plan_ignores_the_rows_and_fills_the_card():
    """About two blocks an SM at LLaMA-7B's linears (5, 5 and 2 splits of 64,
    64 and 172 strips on 132 SMs, both storages); a function of (K, N, the
    block size, SMs) only."""
    for plan_fn in PLANS.values():
        assert [plan_fn(K, N, 64, 132).splits for K, N in LLAMA_SHAPES] == [5, 5, 2]
        assert [plan_fn(K, N, 64, 132).strips for K, N in LLAMA_SHAPES] == [64, 64, 172]
        assert plan_fn(4096, 4096, 64, 1024).splits == 16           # a cluster at most
        assert list(plan_fn.__code__.co_varnames[:4]) == ["K", "N", "block_size", "sms"]


@pytest.mark.parametrize("kind", ["nf4", "int8"])
def test_bwd_decode_plan_refuses_only_what_it_says(kind):
    """Over a grid of shapes the plan refuses exactly two things, each with
    its reason: a shape ``quantize`` does not make, and N % 16 != 0 (a lane
    loads 16 bytes of a weight row); ragged K, N past a k-step and block
    sizes that are no multiple of the strip are accepted."""
    plan_fn = PLANS[kind]
    for K in (36, 64, 200, 320, 480, 1000, 4096):
        for N in (8, 16, 40, 48, 72, 200, 4112):
            for B in (2, 4, 12, 32, 64, 100):
                plan = plan_fn(K, N, B, 132)
                shape_ok = K % ((2 if kind == "nf4" else 1) * B) == 0
                assert plan.accepted == (shape_ok and N % 16 == 0), (K, N, B, plan.reason)
                if not shape_ok:
                    assert "no" in plan.reason and f"K={K}" in plan.reason
                elif N % 16:
                    assert f"N={N}" in plan.reason and "16" in plan.reason
                    assert ("qmm_nf4_bwd.cu" if kind == "nf4" else "qmm_i8.cu") in plan.reason
    assert not plan_fn(0, 64, 64, 132).accepted and not plan_fn(128, 0, 64, 132).accepted


@pytest.mark.parametrize("double_quant", [True, False])
@pytest.mark.parametrize("kind", ["nf4", "int8"])
def test_bwd_decode_dispatch_follows_the_plan(monkeypatch, kind, double_quant):
    """1 to DECODE_ROWS rows take the dx decode kernel with one plan for all
    of them, counted in ``decode_launches``; DECODE_ROWS + 1 rows take the
    wgmma kernel; a shape the plan refuses (N = 40) keeps the tile kernel at
    16 rows; no rows, no launch.  The launchers are replaced by recording
    stand-ins that return the plain result (the kernels run only on the
    card)."""
    calls = []

    def decode(g, qt, scale, offset, plan):
        calls.append(("decode", g.shape[0], plan))
        return qmatmul_bwd_plain(g, qt)

    def wgmma(lib, entry, a, qt, outer, scale, offset, plan):
        calls.append(("wgmma", entry, a.shape[0]))
        return qmatmul_bwd_plain(a, qt)

    def tile(lib, entry, a, qt, outer, scale, offset):
        calls.append(("tile", entry, a.shape[0]))
        return qmatmul_bwd_plain(a, qt)

    monkeypatch.setattr(qm, "_bwd_decode_launch", decode)
    monkeypatch.setattr(qm, "_wgmma_launch", wgmma)
    monkeypatch.setattr(qm, "_launch", tile)
    monkeypatch.setitem(qm._SMS, torch.device("cpu"), 132)
    wrapper = qmm_i8_bwd if kind == "int8" else qmm_nf4_bwd
    for attr in ("launches", "decode_launches", "wgmma_launches"):
        monkeypatch.setattr(wrapper, attr, 0)
    gen = torch.Generator().manual_seed(4)
    qt = quantize(torch.randn(256, 96, generator=gen), quant_type=kind,
                  double_quant=double_quant)
    for M in range(1, DECODE_ROWS + 2):
        g = torch.randn(M, 96, generator=gen).to(torch.bfloat16)
        assert torch.equal(wrapper(g, qt), qmatmul_bwd_plain(g, qt))
    assert [c[:2] for c in calls[:DECODE_ROWS]] == [("decode", M)
                                                   for M in range(1, DECODE_ROWS + 1)]
    assert {c[2] for c in calls[:DECODE_ROWS]} == {PLANS[kind](256, 96, 64, 132)}
    entry = "qmm_i8_wgmma_bwd" if kind == "int8" else "qmm_nf4_bwd_wgmma"
    assert calls[DECODE_ROWS] == ("wgmma", entry, DECODE_ROWS + 1)
    refused = quantize(torch.randn(256, 40, generator=gen), quant_type=kind,
                       double_quant=double_quant)
    wrapper(torch.zeros(DECODE_ROWS, 40, dtype=torch.bfloat16), refused)
    wrapper(torch.zeros(0, 96, dtype=torch.bfloat16), qt)
    assert calls[DECODE_ROWS + 1:] == [
        ("tile", "qmm_i8_bwd" if kind == "int8" else "qmm_nf4_bwd", DECODE_ROWS)]
    assert (wrapper.launches, wrapper.decode_launches, wrapper.wgmma_launches) == (
        DECODE_ROWS + 2, DECODE_ROWS, 1)


def _slot_columns(kb, h, t, v):
    """Lane t's four columns of k-tile v in half h of the k-step at kb, by
    contraction slot: byte j of its word v fills slot 2t + (j & 1) + 8 (j >> 1)."""
    return {2 * t + (j & 1) + 8 * (j >> 1): kb + 64 * h + 16 * t + 4 * v + j for j in range(4)}


def _lane_weights(qt):
    """Every weight as a lane decodes it, f32 [K, N] holding bf16 values: NF4
    code[nibble] * absmax of the nibble's own plane and row block (low
    nibble of packed row p: row p; high: K/2 + p), int8 (code * (1/127)) *
    absmax, each product one f32 rounding, then one rounding to bf16."""
    K, N = logical_k(qt), qt.packed.shape[-1]
    am = absmax_f32(qt).numpy()
    rows = np.arange(K)
    if qt.quant_type == "int8":
        w = (qt.packed.numpy().astype(np.float32) * np.float32(1 / 127)) * am[rows // qt.block_size]
    else:
        code = np.asarray(get_code(qt.quant_type), np.float32)
        packed = qt.packed.numpy()
        nib = np.concatenate([packed & 15, packed >> 4])
        w = code[nib] * am[rows // qt.block_size]
    return torch.from_numpy(w.astype(np.float32)).to(torch.bfloat16).float().numpy()


def _emulate(g, qt, plan):
    """The kernel written out in numpy: per block (strip, split), per warp,
    the passes' k-steps, each half's four k-tiles; the A tile [16 A rows, 16
    slots] gathered through the lane maps (NF4: A rows r / r + 8 the low /
    high nibble of packed row strip0 + 8 w + r; int8: row strip0 + 16 w + r
    and + 8), the B tile [16 slots, M] from g's columns at the same slots,
    each product tile's exact sum added into the accumulator of the k-tile's
    parity; the two parities added, the warps' partials placed at local
    columns 16 w + i, the splits added in split order, one rounding to
    bf16.  Returns (dx bf16, how often each weight was multiplied)."""
    K, N = logical_k(qt), qt.packed.shape[-1]
    M = g.shape[0]
    w = _lane_weights(qt)
    gb = g.to(torch.bfloat16).float().numpy()
    rows = K // plan.planes
    dx = np.zeros((M, K), np.float32)
    seen = np.zeros((K, N), np.int64)
    aligned = qt.block_size % plan.strip == 0
    for s_i, runs in enumerate(plan.strip_cols(K)):
        strip0 = s_i * plan.strip
        if aligned:    # the strip's rows share one absmax row in each plane
            blocks = {r // qt.block_size for r in range(strip0, min(strip0 + plan.strip, rows))}
            assert len(blocks) == 1
        total = np.zeros((M, 4 * 16), np.float32)
        for c0, c1 in plan.split_cols(N):
            part = np.zeros((M, 4 * 16), np.float32)
            for wk in range(4):
                if plan.planes == 2:
                    prow = [strip0 + 8 * wk + (i & 7) for i in range(16)]
                    dxc = [p if i < 8 else rows + p for i, p in enumerate(prow)]
                    ok = np.array([p < rows for p in prow])
                else:
                    dxc = [strip0 + 16 * wk + i for i in range(16)]
                    ok = np.array([k < K for k in dxc])
                dxc = np.minimum(dxc, K - 1)
                acc = np.zeros((2, 16, M), np.float32)
                for p0 in range(c0, c1, plan.cols):
                    p1 = min(p0 + plan.cols, c1)
                    for kb in range(p0, p1, 128):
                        for h in range(2):
                            for v in range(4):
                                slots = {}
                                for t in range(4):
                                    slots.update(_slot_columns(kb, h, t, v))
                                cols = np.array([slots[i] for i in range(16)])
                                # a B register pairs columns c, c + 1: g as it lies
                                assert all(cols[2 * t + 1] == cols[2 * t] + 1 and
                                           cols[2 * t + 8] == cols[2 * t] + 2 for t in range(4))
                                inb = cols < p1
                                cc = np.minimum(cols, N - 1)
                                a = np.where(ok[:, None] & inb[None, :], w[dxc][:, cc], 0)
                                b = np.where(inb[:, None], gb[:, cc].T, 0)
                                seen[np.ix_(dxc[ok], cols[inb])] += 1
                                acc[v & 1] += (a.astype(np.float64) @ b).astype(np.float32)
                part[:, 16 * wk:16 * wk + 16] = (acc[0] + acc[1]).T
            total += part
        for lc in range(4 * 16):
            wk, i = divmod(lc, 16)
            if plan.planes == 2:
                row = strip0 + 8 * wk + (i & 7)
                col, keep = (row if i < 8 else rows + row), row < rows
            else:
                col = strip0 + lc
                keep = col < K
            if keep:
                assert any(k0 <= col < k1 for k0, k1 in runs)
                dx[:, col] = total[:, lc]
    return torch.from_numpy(dx).to(torch.bfloat16), seen


EMULATED = [("nf4", 256, 384, 64, 4), ("nf4", 200, 48, 4, 4), ("nf4", 320, 2560, 32, 2),
            ("int8", 256, 384, 64, 4), ("int8", 200, 48, 4, 4), ("int8", 192, 2560, 12, 2)]


@pytest.mark.parametrize("M", [1, 5, 16])
@pytest.mark.parametrize("double_quant", [True, False])
@pytest.mark.parametrize("kind,K,N,block_size,sms", EMULATED, ids=str)
def test_kernel_maps_in_numpy_equal_the_plain_version(kind, K, N, block_size, sms, M,
                                                      double_quant):
    """The emulated kernel multiplies every weight exactly once, the weights
    its lanes decode are ``dequantize``'s bit for bit, and its dx equals
    ``qmatmul_bwd_plain`` within the stated tolerance: several splits (a
    small card), several passes (N = 2560: 1024 columns at a time), ragged
    strips (K = 200) and block sizes that are no multiple of the strip."""
    gen = torch.Generator().manual_seed(K + N + M)
    qt = quantize(torch.randn(K, N, generator=gen) * K ** -0.5, block_size=block_size,
                  quant_type=kind, double_quant=double_quant)
    plan = PLANS[kind](K, N, block_size, sms)
    assert plan.accepted
    assert np.array_equal(_lane_weights(qt), dequantize(qt, torch.bfloat16).float().numpy())
    g = torch.randn(M, N, generator=gen).to(torch.bfloat16)
    dx, seen = _emulate(g, qt, plan)
    assert (seen == 1).all()
    ref = qmatmul_bwd_plain(g, qt)
    np.testing.assert_allclose(dx.float().numpy(), ref.float().numpy(), rtol=1e-2, atol=1e-2)


def test_emulated_cases_take_several_splits_and_passes():
    """The emulated cases reach what they claim to: more than one split,
    more than one pass, a ragged last strip."""
    assert nf4_bwd_decode_plan(256, 384, 64, 4).splits == 2
    plan = nf4_bwd_decode_plan(320, 2560, 32, 2)
    (c0, c1), = plan.split_cols(2560)
    assert c1 - c0 > plan.cols == 1024
    assert nf4_bwd_decode_plan(200, 48, 4, 4).strip_cols(200)[-1] == [(96, 100), (196, 200)]
    assert i8_bwd_decode_plan(200, 48, 4, 4).strip_cols(200)[-1] == [(192, 200)]
