"""The NF4 w8a8 decode kernel's plan (``ops/qmatmul.py:
nf4_w8a8_decode_plan``), on the CPU: how ``csrc/qmm_nf4_w8a8_decode.cu``
splits the packed rows across the blocks of a cluster, that the plan's
constants and shared memory are the kernel's own, that ``qmm_nf4_w8a8`` sends
its decode rows to it without quantizing rows or making scales on the host,
what the wrapper hands the C entry, and the kernel's arithmetic written out
lane by lane in numpy: each split's row and column maxima merged over the
cluster, 127 / col by true division, the 8 packed rows a lane streams, the
prmt transposes of the packed bytes, each word's low and high nibbles made
int8 codes of the two planes with the rounder, the m16n8k32 fragment map for
both planes, the warps' and splits' int32 sums and the epilogue's two bf16
roundings.  The emulation is held bit for bit to ``qmm_nf4_w8a8_plain`` and
to the JAX package's ``_qmm_pallas_w8a8`` (interpret mode on the CPU), for
NF4 and FP4, double-quantized and f32 absmax.  The kernel itself runs only
on the card (``tests/test_torch_cuda.py``).

As for the direct decode kernel, PyTorch on the card divides a tensor by a
Python scalar (``amax / 127.0``, ``col / 127.0``) as a multiplication by the
f32 reciprocal, which the kernel copies, while the CPU and JAX divide: the
emulation takes either (``divide``).  ``127 / col`` is a true division on
every side: ``w8a8_scales`` divides a full tensor by col, as JAX does, and
the kernel uses ``__fdiv_rn``."""

import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from qlora_tpu.ops.qmatmul import default_impl as jdefault_impl
from qlora_tpu.ops.qmatmul import qmatmul as jqmatmul
from qlora_tpu.quant import absmax_f32 as jabsmax_f32
from qlora_tpu.quant import quantize as jquantize

from qlora_tpu_torch.ops import int8_matmul_plain, qmm_nf4_w8a8, qmm_nf4_w8a8_plain
from qlora_tpu_torch.ops import quantize_rows, w8a8_codes, w8a8_scales
from qlora_tpu_torch.ops.qmatmul import DECODE_ROWS, nf4_w8a8_decode_plan, w8a8_tile_plan
from qlora_tpu_torch.quant import absmax_f32, quantize
from qlora_tpu_torch.quant.codebooks import get_code
from test_torch_i8_direct_decode_plan import _bf16, _mma_m16n8k32, _transpose4
from test_torch_quant import _carry
from test_torch_serve_int8 import _inputs

torch.set_num_threads(2)
qm = importlib.import_module("qlora_tpu_torch.ops.qmatmul")
SOURCE = (Path(__file__).resolve().parent.parent / "qlora_tpu_torch" / "csrc"
          / "qmm_nf4_w8a8_decode.cu")
LLAMA_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096)]
R127 = np.float32(1) / np.float32(127)
ROUNDER = np.float32(12582912.0)


def _constants():
    src = SOURCE.read_text()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
            for k in ("COLS", "TILES", "WARPS", "KSTEP", "MAX_ROWS", "MAX_SPLITS", "MAX_M")}


# the LLaMA-7B linears, a ragged strip (N % 128 != 0), one strip, one k-step,
# a block of 128 and of 32, the longest K 16 splits cover, K past 9 splits
# of 2048 packed rows on 40 strips (more splits than two blocks an SM)
PLAN_SHAPES = [(K, N, 64) for K, N in LLAMA_SHAPES] + [
    (2048, 320, 64), (256, 48, 64), (64, 16, 32), (1024, 144, 128), (512, 96, 32),
    (64 * 1000, 32, 64), (65536, 5120, 64)]


@pytest.mark.parametrize("K,N,B", PLAN_SHAPES, ids=str)
def test_nf4_w8a8_decode_plan_covers_the_packed_rows_once(K, N, B):
    """The splits cover the K/2 packed rows once, in order, each a run of
    whole 32-row k-steps of at most 2048 packed rows; at most 16 splits (one
    cluster), at least one k-step each, and about two blocks an SM unless a
    split would pass 2048 packed rows.  Each k-step lies in one absmax block
    of each plane."""
    plan = nf4_w8a8_decode_plan(K, N, B, 132)
    assert plan.accepted, plan.reason
    assert 1 <= plan.splits <= 16 and plan.strips == -(-N // 128)
    spans = plan.split_rows(K // 2)
    assert spans[0][0] == 0 and spans[-1][1] == K // 2
    for (a0, a1), (b0, _) in zip(spans, spans[1:]):
        assert a1 == b0
    for r0, r1 in spans:
        assert r0 < r1 and r0 % 32 == 0 and r1 % 32 == 0 and r1 - r0 <= 2048
        for kb in range(r0, r1, 32):
            assert kb // B == (kb + 31) // B                    # low plane
            assert (K // 2 + kb) // B == (K // 2 + kb + 31) // B == K // (2 * B) + kb // B
    want = min(K // 64, 16, max(-(-264 // plan.strips), -(-(K // 2) // 2048)))
    assert plan.splits == want


def test_nf4_w8a8_decode_plan_fills_the_card_and_ignores_the_rows():
    """9, 4 and 9 splits of 32, 86 and 32 strips at LLaMA-7B's linears (about
    two blocks an SM on 132), 16 splits where two blocks an SM would leave
    splits past 2048 packed rows; a function of (K, N, B, SMs) only, never of
    the rows; every block linear of every configuration the port knows takes
    it at the NF4 block size."""
    from qlora_tpu_torch.models.config import get_config
    from qlora_tpu_torch.models.transformer import linear_dims
    from test_torch_w8a8_plan import MODELS

    assert [nf4_w8a8_decode_plan(K, N, 64, 132).splits for K, N in LLAMA_SHAPES] == [9, 4, 9]
    assert nf4_w8a8_decode_plan(65536, 5120, 64, 132).splits == 16      # 7 would pass 2048 rows
    assert nf4_w8a8_decode_plan(4096, 4096, 64, 264).splits == 16          # a cluster at most
    assert list(nf4_w8a8_decode_plan.__code__.co_varnames[:4]) == ["K", "N", "block_size", "sms"]
    assert nf4_w8a8_decode_plan.__code__.co_argcount == 4
    for name in MODELS:
        for K, N in linear_dims(get_config(name)).values():
            assert nf4_w8a8_decode_plan(K, N, 64, 132).accepted, (name, K, N)


def test_nf4_w8a8_decode_plan_refuses_with_reasons():
    """K % 64 != 0 (whole k-steps of 32 packed rows), N % 16 != 0 (a lane's
    16 columns), block sizes that are no multiple of 32 (a k-step in one
    absmax block) and K past 16 splits of 2048 packed rows stay on
    qmm_i8_direct.cu; K % 2B != 0 is no NF4 shape."""
    for K, N, B, why in ((200, 64, 4, "K=200"), (4096 + 32, 64, 16, "K=4128"),
                         (4096, 4104, 64, "N=4104"), (4096, 24, 64, "N=24"),
                         (4096, 64, 16, "block 16"), (4096, 64, 8, "block 8"),
                         (2 * 16 * 2048 + 64, 64, 32, "16 splits"), (96, 64, 64, "no NF4 shape"),
                         (0, 64, 64, "no NF4 shape")):
        plan = nf4_w8a8_decode_plan(K, N, B, 132)
        assert not plan.accepted and why in plan.reason, (K, N, B, plan.reason)
        assert "no NF4 shape" in why or "qmm_i8_direct.cu" in plan.reason
    assert nf4_w8a8_decode_plan(2 * 16 * 2048, 64, 64, 132).accepted


def test_nf4_w8a8_decode_plan_matches_the_kernel_and_fits_shared_memory():
    """The plan's constants are the kernel's, and the shared memory the C
    entry asks for (x8 of the longest split's two runs and its runs of x, or
    the warps' and the block's int32 partials) stays within the 200 KB it
    allows at every LLaMA shape and the longest split, at 1 to 16 rows; the
    kernel's static arrays (codebook, row and column maxima, col, 127 / col)
    fit beside it."""
    c = _constants()
    assert c["COLS"] == qm._DECODE_COLS == 128 and c["MAX_SPLITS"] == qm._DECODE_MAX_SPLITS
    assert c["KSTEP"] == qm._I8_DIRECT_KSTEP == 32 and c["TILES"] * 16 == c["COLS"]
    assert c["MAX_ROWS"] == qm._NF4_W8A8_MAX_ROWS == 2048
    assert c["MAX_M"] == DECODE_ROWS and c["WARPS"] * 32 == c["COLS"]
    static = 16 * 4 + 2 * c["MAX_M"] * 4 + 3 * c["COLS"] * 4
    for K, N in LLAMA_SHAPES + [(2 * 16 * 2048, 64)]:
        plan = nf4_w8a8_decode_plan(K, N, 64, 132)
        rows = -(-(K // 64) // plan.splits) * 32
        pitch = -(-(2 * rows // 4) // 32) * 32 + 4
        assert pitch % 32 == 4
        for M in range(1, 17):
            mt = 2 if M > 8 else 1
            stage = mt * 8 * pitch * 4 + M * 2 * rows * 2
            parts = ((c["WARPS"] - 1) * mt * c["TILES"] * 4 * 32 + M * c["COLS"]) * 4
            assert max(stage, parts) <= 200 * 1024 and max(stage, parts) + static <= 232448


def _recording(monkeypatch):
    """Replace the launchers by stand-ins that record which kernel ran and
    return the plain result; the host's row quantization and scales raise
    inside the decode stand-in's calls, so a decode call makes neither."""
    calls, host = [], {"quantize_rows": qm.quantize_rows, "w8a8_scales": qm.w8a8_scales}

    def decode(x, qt, plan, raw=False, rows=None):
        calls.append(("decode", x.shape[0], plan))
        return torch.zeros(x.shape[0], qt.packed.shape[-1], dtype=torch.bfloat16)

    def tile(entry, x8, qt, ratio, s_out, xs, plan=None):
        calls.append(("tile", entry, x8.shape[0]))
        return torch.zeros(x8.shape[0], qt.packed.shape[-1], dtype=torch.bfloat16)

    def counted(name):
        def f(*a):
            calls.append(("host", name))
            return host[name](*a)
        return f

    monkeypatch.setattr(qm, "_nf4_w8a8_decode_launch", decode)
    monkeypatch.setattr(qm, "_launch_w8a8", tile)
    for name in host:
        monkeypatch.setattr(qm, name, counted(name))
    monkeypatch.setitem(qm._SMS, torch.device("cpu"), 132)
    return calls


def test_nf4_w8a8_dispatch_sends_decode_rows_to_the_decode_kernel(monkeypatch):
    """``qmm_nf4_w8a8`` takes the decode kernel at 1 to 16 rows with one plan
    for all of them, quantizes no rows and makes no scales on the host, and
    counts it in ``decode_launches``; 17 rows take the wgmma kernel; shapes
    the plan refuses (N % 16, block size % 32, K % 64) and no rows stay on
    qmm_i8_direct.cu, after ``quantize_rows`` and ``w8a8_scales``."""
    calls = _recording(monkeypatch)
    g = torch.Generator().manual_seed(3)
    qt = quantize(torch.randn(256, 64, generator=g))
    n0 = (qmm_nf4_w8a8.launches, qmm_nf4_w8a8.decode_launches, qmm_nf4_w8a8.wgmma_launches)
    for M in range(1, DECODE_ROWS + 2):
        qmm_nf4_w8a8(torch.randn(M, 256, generator=g).to(torch.bfloat16), qt)
    assert calls[:DECODE_ROWS] == [("decode", M, nf4_w8a8_decode_plan(256, 64, 64, 132))
                                   for M in range(1, DECODE_ROWS + 1)]
    assert calls[DECODE_ROWS:] == [("host", "quantize_rows"), ("host", "w8a8_scales"),
                                   ("tile", "qmm_nf4_w8a8_wgmma", DECODE_ROWS + 1)]
    del calls[:]
    for K, N, B in ((256, 72, 64), (256, 64, 16), (224, 64, 16)):
        q = quantize(torch.randn(K, N, generator=g), block_size=B)
        qmm_nf4_w8a8(torch.randn(4, K, generator=g).to(torch.bfloat16), q)
    qmm_nf4_w8a8(torch.zeros(0, 256, dtype=torch.bfloat16), qt)
    assert [c for c in calls if c[0] == "tile"] == [("tile", "qmm_nf4_w8a8", 4)] * 3 + [
        ("tile", "qmm_nf4_w8a8", 0)]
    assert not [c for c in calls if c[0] == "decode"]
    assert (qmm_nf4_w8a8.launches, qmm_nf4_w8a8.decode_launches,
            qmm_nf4_w8a8.wgmma_launches) == (n0[0] + DECODE_ROWS + 4, n0[1] + DECODE_ROWS,
                                             n0[2] + 1)


@pytest.mark.parametrize("dq,rows", [(True, None), (False, "out"), (True, "given")])
def test_nf4_w8a8_decode_wrapper_hands_the_c_entry_its_arguments(monkeypatch, dq, rows):
    """What ``_nf4_w8a8_decode_launch`` passes the C entry: x, the packed
    bytes and the stored absmax (int8 with its meta-scales and offset, or
    f32 with none), the codebook, the shape, the block size, the plan's
    splits and the given / raw switches; x8 and xs only when written or
    given.  ``raw`` asks for the int32 accumulators."""
    seen = []

    def kernel(lib, entry, argtypes):
        assert (lib, entry) == ("qmm_nf4_w8a8_decode", "qmm_nf4_w8a8_decode")
        assert len(argtypes) == 18
        return lambda *a: seen.append(a) or 0

    monkeypatch.setattr(qm._build, "kernel", kernel)
    monkeypatch.setattr(qm._build, "stream_ptr", lambda t: 0)
    g = torch.Generator().manual_seed(5)
    qt = quantize(torch.randn(512, 96, generator=g), block_size=64, double_quant=dq)
    x = torch.randn(3, 512, generator=g).to(torch.bfloat16)
    plan = nf4_w8a8_decode_plan(512, 96, 64, 132)
    given = quantize_rows(x) if rows == "given" else rows
    out = qm._nf4_w8a8_decode_launch(x, qt, plan, raw=rows == "out", rows=given)
    (a,) = seen
    assert a[1] == qt.packed.data_ptr() and a[2] == qt.absmax.data_ptr()
    assert (a[3] is not None, a[4] is not None) == (dq, dq)
    assert a[5] == qm._code_on("nf4", torch.device("cpu")).data_ptr()
    assert (a[7] is None) == (a[8] is None) == (rows is None)
    assert a[9:] == (3, 512, 96, 64, int(dq), plan.splits, int(rows == "given"),
                     int(rows == "out"), 0)
    if rows == "out":
        y, x8, xs = out
        assert y.dtype == torch.int32 and x8.shape == (3, 512) and xs.shape == (3, 1)
    else:
        assert out.dtype == torch.bfloat16 and out.shape == (3, 96)


# ---------------------------------------------------------------------------
# the kernel's arithmetic, lane by lane
# ---------------------------------------------------------------------------

def _byte_perm(x, y, s):
    """__byte_perm over arrays of 32-bit words (x, y uint64 arrays; s a
    constant selector)."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(s >> (4 * n)) & 7] << np.uint64(8 * n) for n in range(4))


def _transpose4_np(w):
    """The kernel's transpose4 over arrays: four word arrays (rows) → four,
    word e holding byte e of each row in row order."""
    p0, p1 = _byte_perm(w[0], w[1], 0x5140), _byte_perm(w[0], w[1], 0x7362)
    p2, p3 = _byte_perm(w[2], w[3], 0x5140), _byte_perm(w[2], w[3], 0x7362)
    return [_byte_perm(p0, p2, 0x5410), _byte_perm(p0, p2, 0x7632),
            _byte_perm(p1, p3, 0x5410), _byte_perm(p1, p3, 0x7632)]


# the m16n8k32 fragment map as index arrays over lanes (g, t) = (lane / 4,
# lane % 4): A register r, byte e -> (row g + 8 (r % 2), k 16 (r / 2) + 4t +
# e); B register r, byte e -> (k 16 r + 4t + e, column g); D registers (g,
# 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
_LANE = np.arange(32)
_G, _T = _LANE >> 2, _LANE & 3
_A_ROW = np.array([[_G + 8 * (r & 1) for _ in range(4)] for r in range(4)])     # [r][e][lane]
_A_K = np.array([[16 * (r >> 1) + 4 * _T + e for e in range(4)] for r in range(4)])
_B_K = np.array([[16 * r + 4 * _T + e for e in range(4)] for r in range(2)])
_D = [(_G, 2 * _T), (_G, 2 * _T + 1), (_G + 8, 2 * _T), (_G + 8, 2 * _T + 1)]


def _s8(words, e):
    return ((words >> np.uint64(8 * e)) & np.uint64(0xFF)).astype(np.uint8).view(np.int8)


def _mma(a, b, acc):
    """mma.sync.m16n8k32.row.col.s32.s8.s8.s32 over the lanes at once: a
    four word arrays [32], b two; acc [32, 4] ints, added to in place."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for r in range(4):
        for e in range(4):
            A[_A_ROW[r][e], _A_K[r][e]] = _s8(a[r], e)
    for r in range(2):
        for e in range(4):
            B[_B_K[r][e], _G] = _s8(b[r], e)
    D = A @ B
    for q, (i, j) in enumerate(_D):
        acc[:, q] += D[i, j]


def test_vectorized_fragment_map_is_the_direct_kernels():
    """The lanes-at-once mma and transposes equal the direct decode kernel's
    lane-by-lane ones, which ``qmm_i8_direct_decode.cu`` matched bit for bit
    on the card."""
    rng = np.random.default_rng(0)
    a = [rng.integers(0, 2 ** 32, 32, dtype=np.uint64) for _ in range(4)]
    b = [rng.integers(0, 2 ** 32, 32, dtype=np.uint64) for _ in range(2)]
    acc = np.zeros((32, 4), np.int64)
    _mma(a, b, acc)
    want = np.zeros((32, 4), np.int64)
    _mma_m16n8k32([[int(a[r][ln]) for r in range(4)] for ln in range(32)],
                  [[int(b[r][ln]) for r in range(2)] for ln in range(32)], want)
    assert np.array_equal(acc, want)
    tr = _transpose4_np(a)
    for ln in range(32):
        assert [int(v[ln]) for v in tr] == _transpose4([int(w[ln]) for w in a])


def _codes4(words, ratio, code, hi):
    """codes4: each byte's low (or high) nibble looked up in the codebook,
    times the word's ratio in f32, plus 1.5 * 2^23 in f32; the low bytes
    packed in byte order."""
    out = np.zeros_like(words)
    for e in range(4):
        b = (words >> np.uint64(8 * e)) & np.uint64(0xFF)
        nib = (b >> np.uint64(4)) if hi else (b & np.uint64(15))
        p = code[nib.astype(np.int64)] * ratio                    # f32 products
        q = (p + ROUNDER).astype(np.float32).view(np.uint32).astype(np.uint64) & np.uint64(0xFF)
        out |= q << np.uint64(8 * e)
    return out


def _emulate(x, qt, divide: bool, sms=132):
    """``qmm_nf4_w8a8_decode.cu`` written out: per cluster (strip of 128
    columns) and block (split of packed rows [r0, r1)), each row's largest
    |x| over the split's two runs of x (bf16 bits without the sign) and each
    column's largest absmax over the split's absmax rows of both planes; the
    cluster's maxima over the splits; xs = amax / 127 (``divide``, the CPU)
    or amax * f32(1/127) (the card), 1 where 0, x8 = rint(x / xs); col (1
    where 0), 127 / col divided in f32; per warp its run of the split's
    k-steps; lane (g, t) streams packed rows 4t + h and 16 + 4t + h (h < 4)
    of its 16 columns c = 16g .., transposes each 4 x 4 block of bytes with
    prmt, and tile i takes columns c + 2i (A row g) and c + 2i + 1 (A row g
    + 8): each word's low nibbles made codes with the column's low-plane
    ratio absmax * (127 / col) against x8's low run, its high nibbles with
    the high-plane ratio against the high run; the warps add in warp order,
    the splits in split order; the epilogue rounds twice to bf16.  Returns
    (y bf16, x8, xs, int32 accumulators)."""
    K, N, B = qt.shape[0], qt.packed.shape[1], qt.block_size
    K2, M = K // 2, x.shape[0]
    MT = 2 if M > 8 else 1
    plan = nf4_w8a8_decode_plan(K, N, B, sms)
    assert plan.accepted, plan.reason
    packed = qt.packed.numpy()
    am = absmax_f32(qt).numpy()
    code = np.asarray(get_code(qt.quant_type), np.float32)
    bits = x.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16).astype(np.uint32)
    xf = (bits << 16).view(np.float32)
    spans = plan.split_rows(K2)
    runs = lambda a, r0, r1: np.concatenate([a[..., r0:r1], a[..., K2 + r0:K2 + r1]], -1)
    pmax = np.array([(runs(bits, r0, r1) & 0x7FFF).max(1) for r0, r1 in spans])
    amax = (pmax.max(0).astype(np.uint32) << 16).view(np.float32)
    xs = amax / np.float32(127) if divide else amax * R127
    xs = np.where(xs == 0, np.float32(1), xs).astype(np.float32)
    x8 = np.rint(xf / xs[:, None]).astype(np.int8)
    blocks = lambda r0, r1: np.arange(r0 // B, (r1 - 1) // B + 1)
    pcol = np.array([np.maximum(am[blocks(r0, r1)], am[K2 // B + blocks(r0, r1)]).max(0)
                     for r0, r1 in spans])
    col = pcol.max(0)
    col = np.where(col == 0, np.float32(1), col).astype(np.float32)
    inv = (np.float32(127) / col).astype(np.float32)
    ratio = (am * inv[None, :]).astype(np.float32)              # [K/B, N]
    x8u = x8.view(np.uint8)
    acc_out = np.zeros((M, N), np.int64)
    for strip in range(plan.strips):
        cb = strip * 128
        c = cb + 16 * _G                                        # each lane's first column
        live = c < N
        total = np.zeros((M, 128), np.int64)
        for r0, r1 in spans:
            nsteps = (r1 - r0) // 32
            xr = np.zeros((MT * 8, 2 * (r1 - r0)), np.uint8)
            xr[:M] = runs(x8u, r0, r1)
            xw = xr.view("<u4").astype(np.uint64)               # [row][word]: low run, high run
            red = []
            for wk in range(4):
                acc = np.zeros((MT, 8, 32, 4), np.int64)        # [mt][tile][lane][reg]
                for s in range(wk * nsteps // 4, (wk + 1) * nsteps // 4):
                    kb = r0 + 32 * s
                    rl = np.zeros((32, 16), np.float32)
                    rh = np.zeros((32, 16), np.float32)
                    cols = np.minimum(c[:, None] + np.arange(16)[None, :], N - 1)
                    rl[live] = ratio[kb // B][cols[live]]
                    rh[live] = ratio[K2 // B + kb // B][cols[live]]
                    rows = np.zeros((32, 8, 16), np.uint8)      # [lane][h][column]
                    for h in range(8):
                        r = kb + 4 * _T + (h & 3) + 16 * (h >> 2)
                        rows[live, h] = packed[r[live, None], cols[live]]
                    words = rows.view("<u4").astype(np.uint64)  # [lane][h][j]
                    tr = [[_transpose4_np([words[:, 4 * hh + r, j] for r in range(4)])
                           for j in range(4)] for hh in range(2)]
                    bl = [[xw[mt * 8 + _G, 8 * s + _T + 4 * q] for q in range(2)]
                          for mt in range(MT)]
                    bh = [[xw[mt * 8 + _G, (r1 - r0) // 4 + 8 * s + _T + 4 * q] for q in range(2)]
                          for mt in range(MT)]
                    for i in range(8):
                        j, e = i >> 1, 2 * (i & 1)
                        p = [tr[0][j][e], tr[0][j][e + 1], tr[1][j][e], tr[1][j][e + 1]]
                        for hi, ratios, bx in ((False, rl, bl), (True, rh, bh)):
                            a = [_codes4(p[r], ratios[:, 2 * i + (r & 1)], code, hi)
                                 for r in range(4)]
                            for mt in range(MT):
                                _mma(a, bx[mt], acc[mt, i])
                red.append(acc)
            acc = red[0] + red[1] + red[2] + red[3]              # warp order (exact in integers)
            part = np.zeros((MT * 8, 128), np.int64)
            for mt in range(MT):
                for h in range(2):
                    for i in range(0, 8, 2):
                        for q, (ii, reg) in enumerate(((i, h), (i, 2 + h), (i + 1, h),
                                                       (i + 1, 2 + h))):
                            part[mt * 8 + 2 * _T + h, 16 * _G + 2 * i + q] = acc[mt, ii, :, reg]
            total += part[:M]                                    # split order
        n1 = min(cb + 128, N)
        acc_out[:, cb:n1] = total[:, :n1 - cb]
    s_out = col / np.float32(127) if divide else col * R127
    scaled = _bf16(acc_out.astype(np.float32) * s_out.astype(np.float32)[None, :])
    y = torch.from_numpy(scaled * _bf16(xs)[:, None]).to(torch.bfloat16)
    return y, torch.from_numpy(x8), torch.from_numpy(xs[:, None]), acc_out


def _case(M, K, N, B, quant_type, dq, seed):
    """bf16 rows and a JAX-quantized weight carried across, with a zero row,
    a zero column, a row whose largest |x| lies in the last split's high run
    and a column whose largest absmax lies in the high plane of a later
    split."""
    w, x = _inputs(M, K, N, seed)
    if M == 1:                                      # one row: not the zero row
        x[0] = np.random.default_rng(seed).normal(size=K) * 0.1
    w[K - 5, 7 % N] = 3.0
    x[0, K - 7] = 2.5
    x = _bf16(x)
    j = jquantize(jnp.asarray(w), block_size=B, quant_type=quant_type, double_quant=dq)
    return x, j, _carry(j)


def _jax_w8a8(x, j):
    """The JAX package's ``qmatmul`` under ``default_impl("w8a8")``, jitted as
    its serving engines run it (``_qmm_pallas_w8a8`` in interpret mode; under
    jit XLA fuses the double-quant decode into one fma, as ``absmax_f32`` of
    the port computes it)."""
    with jdefault_impl("w8a8"):
        return np.asarray(jax.jit(jqmatmul)(jnp.asarray(x), j), np.float32)


# (M, K, N, block, quant type, double quant, SMs): one strip, two strips with
# a ragged one (N = 144 and 400), blocks of 32, 64 and 128; 132 SMs split K
# into single k-steps, fewer SMs give warps several k-steps and absmax blocks
EMULATED = [(1, 256, 128, 64, "nf4", True, 132), (4, 512, 256, 64, "fp4", False, 2),
            (8, 256, 384, 32, "nf4", False, 3), (9, 512, 128, 128, "fp4", True, 1),
            (16, 256, 256, 64, "nf4", True, 4)]


@pytest.mark.parametrize("M,K,N,B,quant_type,dq,sms", EMULATED, ids=str)
def test_nf4_w8a8_decode_emulation_matches_plain_and_jax(M, K, N, B, quant_type, dq, sms):
    """The emulated kernel, with the CPU's division, equals the plain version
    bit for bit (the rows' codes and scales, the integer sums against
    ``w8a8_codes``, the bf16 output); with the card's reciprocal it equals
    the card's arithmetic and the JAX package's ``qmatmul`` under
    ``default_impl("w8a8")`` (``_qmm_pallas_w8a8`` in interpret mode) jitted
    as its engines run it, bit for bit: under jit XLA too multiplies by
    f32(1/127) where a value is divided by the constant 127.  A zero row and
    a zero column stay 0."""
    x, j, qt = _case(M, K, N, B, quant_type, dq, seed=M + K + N)
    xt = torch.from_numpy(x)
    y, x8, xs, acc = _emulate(xt, qt, divide=True, sms=sms)
    rx8, rxs = quantize_rows(xt)
    assert torch.equal(x8, rx8) and torch.equal(xs, rxs)
    w8 = w8a8_codes(qt, w8a8_scales(qt)[0])
    assert np.array_equal(acc, int8_matmul_plain(rx8, w8).numpy().astype(np.int64))
    assert torch.equal(y, qmm_nf4_w8a8_plain(xt, qt))
    assert (M == 1 or (y[M - 1] == 0).all()) and (y[:, 3] == 0).all()
    yc, x8c, xsc, accc = _emulate(xt, qt, divide=False, sms=sms)
    ref, rx8c, rxsc = _card_plain(xt, qt)
    assert torch.equal(yc, ref) and torch.equal(x8c, rx8c) and torch.equal(xsc, rxsc)
    assert np.array_equal(accc, int8_matmul_plain(rx8c, w8).numpy().astype(np.int64))
    np.testing.assert_array_equal(yc.float().numpy(), _jax_w8a8(x, j))


@pytest.mark.parametrize("quant_type,dq", [("nf4", True), ("fp4", False)])
def test_nf4_w8a8_decode_emulation_at_every_decode_row_count(quant_type, dq):
    """At 1 to 16 rows (one and two B tiles) the emulated kernel equals the
    plain version bit for bit with the CPU's division; with the card's
    reciprocal it equals the card's arithmetic written with the port's
    pieces, and the rows whose scale differs between the two are those where
    amax / 127 and amax * f32(1/127) differ."""
    x, _, qt = _case(16, 256, 144, 64, quant_type, dq, seed=17)
    for M in range(1, DECODE_ROWS + 1):
        xt = torch.from_numpy(x[16 - M:])
        y, _, xs, _ = _emulate(xt, qt, divide=True, sms=3)
        assert torch.equal(y, qmm_nf4_w8a8_plain(xt, qt)), M
        yc, x8c, xsc, _ = _emulate(xt, qt, divide=False, sms=3)
        ref, rx8c, rxsc = _card_plain(xt, qt)
        assert torch.equal(yc, ref) and torch.equal(x8c, rx8c) and torch.equal(xsc, rxsc), M
        amax = xt.float().abs().amax(1).numpy()
        differs = (amax / np.float32(127)) != (amax * R127)
        assert np.array_equal((xsc != xs).numpy()[:, 0], differs & (amax != 0)), M


def _card_plain(x, qt):
    """qmm_nf4_w8a8_plain with the card's division by a Python scalar (a
    multiplication by f32(1/127)) for xs and s_out, written with the port's
    pieces; 127 / col stays a true division."""
    xf = x.float()
    xs = xf.abs().amax(dim=1, keepdim=True) * float(R127)
    xs = torch.where(xs == 0, torch.ones_like(xs), xs)
    x8 = torch.round(xf / xs).to(torch.int8)
    ratio, s_out = w8a8_scales(qt)
    col = absmax_f32(qt).amax(0)
    col = torch.where(col == 0, torch.ones_like(col), col)
    w8 = w8a8_codes(qt, ratio)
    y = qm._w8a8_epilogue(int8_matmul_plain(x8, w8), col * float(R127), xs)
    return y, x8, xs


def test_nf4_w8a8_decode_identity_rows_read_out_both_planes():
    """Rows of the identity (x8 = 127 at one k) read the int8 codes out
    through the emulated lanes: every (k, column) of both planes lands once,
    in its column, whatever its place in a k-step, a 4 x 4 block, a plane or
    a strip."""
    K, N = 256, 160
    qt = quantize(torch.randn(K, N, generator=torch.Generator().manual_seed(7)), block_size=64)
    w8 = w8a8_codes(qt, w8a8_scales(qt)[0]).numpy().astype(np.int64)
    for ks in ([0, 1, 3, 4, 15, 16, 17, 31], [32, 63, 127, 128, 129, 160, 200, 255]):
        eye = torch.zeros(len(ks), K, dtype=torch.bfloat16)
        eye[torch.arange(len(ks)), torch.tensor(ks)] = 1
        _, x8, _, acc = _emulate(eye, qt, divide=False, sms=2)
        assert (x8.abs().amax(1) == 127).all()
        assert np.array_equal(acc, 127 * w8[ks])


@pytest.mark.parametrize("quant_type,dq", [("nf4", True), ("nf4", False), ("fp4", True)])
def test_w8a8_scales_ratio_is_jaxs_true_division(quant_type, dq):
    """``w8a8_scales``' ratio equals the JAX kernel's ``am * (127.0 / col)``
    (jitted, as it runs) bit for bit, on a 7B-wide weight; PyTorch's
    reflected division of a Python scalar (``col.reciprocal() * 127``) would
    differ in the last bit of some entries, which is why the plain version
    divides a full tensor.  JAX's jitted ``col / 127.0`` is ``col *
    f32(1/127)``, the card's ``s_out`` and the kernel's; the CPU divides."""
    rng = np.random.default_rng(11)
    w = (rng.normal(size=(512, 4096)) * 0.02).astype(np.float32)
    w[:, 5] = 0
    j = jquantize(jnp.asarray(w), quant_type=quant_type, double_quant=dq)

    @jax.jit
    def scales(j):                     # the JAX kernel's lines, jitted as it is
        am = jabsmax_f32(j)
        col = jnp.max(am, axis=0)
        col = jnp.where(col == 0, 1.0, col)
        return am * (127.0 / col)[None, :], col / 127.0, am, col

    want, want_s, am, col = (np.array(a) for a in scales(j))
    ratio, s_out = w8a8_scales(_carry(j))
    np.testing.assert_array_equal(ratio.numpy(), want)
    np.testing.assert_array_equal(want_s, col * R127)
    np.testing.assert_array_equal(s_out.numpy(), col / np.float32(127))
    reflected = torch.from_numpy(am) * (127.0 / torch.from_numpy(col))[None, :]
    assert (reflected.numpy() != want).any()


def test_decode_sweep_and_mutant_edits_apply_to_the_source():
    """Every variant of ``decode_sweep.py``'s nf4w8a8 set and every mutant of
    ``tile_sweep.py``'s nf4w8a8 set finds the text it replaces in the kernel
    source, once."""
    from qlora_tpu_torch.ops import decode_sweep, tile_sweep

    text = SOURCE.read_text()
    for table in (decode_sweep.NF4_W8A8_VARIANTS, tile_sweep.NF4_W8A8_MUTANTS):
        for name, edits in table.items():
            for old, new in edits:
                assert text.count(old) == 1, (name, old)
                assert old != new
    assert tile_sweep.MUTANT_SETS["nf4w8a8"][0] == SOURCE.name
    assert "nf4w8a8" in decode_sweep.SETS
    assert len(tile_sweep.NF4_W8A8_MUTANTS) >= 2
