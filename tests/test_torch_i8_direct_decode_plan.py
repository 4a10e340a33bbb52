"""The direct int8 decode kernel's plan (``ops/qmatmul.py:
i8_direct_decode_plan``), on the CPU: how ``csrc/qmm_i8_direct_decode.cu``
splits K across the blocks of a cluster, that the plan's constants and shared
memory are the kernel's own, that ``qmm_i8_direct`` sends its decode rows to
it, and the kernel's arithmetic written out lane by lane in numpy (the rows'
maxima per split and over the cluster, the in-kernel row quantization, the
8 rows a lane streams, the prmt transposes into A registers, the m16n8k32
fragment map, the warps' and the splits' sums, the epilogue), equal bit for
bit to ``qmm_i8_direct_plain``.  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``).

One difference between the CPU and the card is written into the emulation
as a switch: PyTorch on the card divides a tensor by a Python scalar (``amax
/ 127.0``, ``col / 127.0``) as a multiplication by the f32 reciprocal, which
the kernel copies, while the CPU divides.  The emulation is held to the CPU's
plain version with the division and to the card's arithmetic, written with
the port's own pieces, with the reciprocal."""

import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qlora_tpu.ops.qmatmul import _qmm_pallas_i8_direct
from qlora_tpu.quant import absmax_f32 as jabsmax_f32
from qlora_tpu.quant import quantize as jquantize

from qlora_tpu_torch.ops import int8_matmul_plain, qmm_i8_direct, qmm_i8_direct_plain, quantize_rows
from qlora_tpu_torch.ops.qmatmul import DECODE_ROWS, i8_direct_decode_plan
from qlora_tpu_torch.quant import absmax_f32, quantize
from test_torch_quant import _carry
from test_torch_serve_int8 import _inputs, _ulp_tol

torch.set_num_threads(2)
qm = importlib.import_module("qlora_tpu_torch.ops.qmatmul")
SOURCE = (Path(__file__).resolve().parent.parent / "qlora_tpu_torch" / "csrc"
          / "qmm_i8_direct_decode.cu")
LLAMA_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096)]
LM_HEAD = (4096, 32768)
R127 = np.float32(1) / np.float32(127)


def _constants():
    src = SOURCE.read_text()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
            for k in ("COLS", "TILES", "WARPS", "KSTEP", "DEPTH", "MAX_ROWS", "MAX_SPLITS",
                      "MAX_M")}


# the LLaMA-7B linears and the padded lm_head, a ragged strip (N % 128 != 0),
# one strip, one k-step, K past 16 * 4096 rows' room at two blocks an SM
# (more splits), the 32000-column lm_head unpadded (N % 128 = 0 here too)
PLAN_SHAPES = LLAMA_SHAPES + [LM_HEAD, (4096, 32000), (2048, 320), (256, 48), (32, 16),
                              (64 * 600, 96), (1024, 144)]


@pytest.mark.parametrize("K,N", PLAN_SHAPES, ids=str)
def test_i8_direct_decode_plan_covers_k_once_in_whole_k_steps(K, N):
    """The splits cover the rows of W once, in order, each a run of whole
    32-row k-steps of at most 4096 rows; at most 16 splits (one cluster), at
    least one k-step each, and about two blocks an SM unless a split would
    pass 4096 rows."""
    plan = i8_direct_decode_plan(K, N, 132)
    assert plan.accepted, plan.reason
    assert 1 <= plan.splits <= 16 and plan.strips == -(-N // 128)
    spans = plan.split_rows(K)
    assert spans[0][0] == 0 and spans[-1][1] == K
    for (a0, a1), (b0, _) in zip(spans, spans[1:]):
        assert a1 == b0
    for r0, r1 in spans:
        assert r0 < r1 and r0 % 32 == 0 and r1 % 32 == 0 and r1 - r0 <= 4096
    want = min(K // 32, 16, max(-(-264 // plan.strips), -(-K // 4096)))
    assert plan.splits == want


def test_i8_direct_decode_plan_fills_the_card_and_ignores_the_rows():
    """9, 4 and 9 splits of 32, 86 and 32 strips at LLaMA-7B's linears, 2 of
    256 at the lm_head (about two blocks an SM on 132); 16 splits of 2400
    rows where two blocks an SM would leave splits past 4096 rows; the plan
    is a function of (K, N, SMs) only, never of the rows."""
    assert [i8_direct_decode_plan(K, N, 132).splits for K, N in LLAMA_SHAPES] == [9, 4, 9]
    assert i8_direct_decode_plan(*LM_HEAD, 132).splits == 2
    assert i8_direct_decode_plan(64 * 600, 96, 132).splits == 16
    assert i8_direct_decode_plan(4096, 4096, 264).splits == 16          # a cluster at most
    assert list(i8_direct_decode_plan.__code__.co_varnames[:3]) == ["K", "N", "sms"]
    assert i8_direct_decode_plan.__code__.co_argcount == 3


def test_i8_direct_decode_plan_refuses_with_reasons():
    """K % 32 != 0 (a k-step is one m16n8k32), N % 16 != 0 (a lane's 16
    columns) and K past 16 splits of 4096 rows stay on qmm_i8_direct.cu; the
    wrapper refuses storage that is not per-column int8."""
    for K, N, why in ((200, 328, "K=200"), (4096, 4104, "N=4104"), (4096, 24, "N=24"),
                      (16 * 4096 + 32, 64, "16 splits"), (0, 64, "no int8 shape")):
        plan = i8_direct_decode_plan(K, N, 132)
        assert not plan.accepted and why in plan.reason, (K, N, plan.reason)
        assert K == 0 or "qmm_i8_direct.cu" in plan.reason
    assert i8_direct_decode_plan(16 * 4096, 64, 132).accepted
    w = torch.randn(256, 64)
    with pytest.raises(ValueError, match="per-column"):
        qmm_i8_direct(torch.zeros(4, 256), quantize(w, quant_type="int8"))


def test_i8_direct_decode_plan_matches_the_kernel_and_fits_shared_memory():
    """The plan's constants are the kernel's, and the shared memory the C
    entry asks for (the row maxima and xs; x8 of the longest split and its
    slice of x; or the warps' and the block's int32 partials) stays within
    the 200 KB it allows at every LLaMA shape, the lm_head and the longest
    split, at 1 to 16 rows."""
    c = _constants()
    assert c["COLS"] == qm._DECODE_COLS == 128 and c["MAX_SPLITS"] == qm._DECODE_MAX_SPLITS
    assert c["KSTEP"] == qm._I8_DIRECT_KSTEP == 32 and c["TILES"] * 16 == c["COLS"]
    assert c["MAX_ROWS"] == qm._I8_DIRECT_MAX_ROWS == 4096
    assert c["MAX_M"] == DECODE_ROWS and c["DEPTH"] == 1 and c["WARPS"] == 4
    for K, N in LLAMA_SHAPES + [LM_HEAD, (16 * 4096, 64)]:
        plan = i8_direct_decode_plan(K, N, 132)
        rows = -(-(K // 32) // plan.splits) * 32
        pitch = -(-(rows // 4) // 32) * 32 + 4
        assert pitch % 32 == 4
        for M in range(1, 17):
            mt = 2 if M > 8 else 1
            stage = mt * 8 * pitch * 4 + M * rows * 2
            parts = ((c["WARPS"] - 1) * mt * c["TILES"] * 4 * 32 + M * c["COLS"]) * 4
            assert 2 * c["MAX_M"] * 4 + max(stage, parts) <= 200 * 1024


def _recording(monkeypatch):
    """Replace the launchers by stand-ins that record which kernel ran and
    return the plain result; returns the record."""
    calls = []

    def decode(x, qt, plan, raw=False, rows=None):
        calls.append(("decode", x.shape[0], plan))
        return qmm_i8_direct_plain(x, qt)

    def tile(entry, x8, qt, ratio, s_out, xs, plan=None):
        calls.append(("tile", entry, x8.shape[0]))
        return qm._w8a8_epilogue(int8_matmul_plain(x8, qt.packed), s_out, xs)

    monkeypatch.setattr(qm, "_i8_direct_decode_launch", decode)
    monkeypatch.setattr(qm, "_launch_w8a8", tile)
    monkeypatch.setitem(qm._SMS, torch.device("cpu"), 132)
    return calls


def test_i8_direct_dispatch_sends_decode_rows_to_the_decode_kernel(monkeypatch):
    """``qmm_i8_direct`` takes the decode kernel at 1 to 16 rows, with one
    plan for all of them, and counts it in ``decode_launches``; 17 rows, a
    shape the plan refuses (K = 200) and no rows stay on qmm_i8_direct.cu
    (no rows, no launch)."""
    calls = _recording(monkeypatch)
    g = torch.Generator().manual_seed(3)
    qt = quantize(torch.randn(256, 64, generator=g), block_size=256, quant_type="int8",
                  double_quant=False)
    n0 = (qmm_i8_direct.launches, qmm_i8_direct.decode_launches)
    for M in range(1, DECODE_ROWS + 2):
        x = torch.randn(M, 256, generator=g).to(torch.bfloat16)
        assert torch.equal(qmm_i8_direct(x, qt), qmm_i8_direct_plain(x, qt))
    ragged = quantize(torch.randn(200, 64, generator=g), block_size=200, quant_type="int8",
                      double_quant=False)
    qmm_i8_direct(torch.randn(4, 200, generator=g).to(torch.bfloat16), ragged)
    qmm_i8_direct(torch.zeros(0, 256, dtype=torch.bfloat16), qt)
    assert [c[:2] for c in calls[:DECODE_ROWS]] == [("decode", M)
                                                   for M in range(1, DECODE_ROWS + 1)]
    assert {c[2] for c in calls[:DECODE_ROWS]} == {i8_direct_decode_plan(256, 64, 132)}
    assert calls[DECODE_ROWS:] == [("tile", "qmm_i8_direct", DECODE_ROWS + 1),
                                   ("tile", "qmm_i8_direct", 4), ("tile", "qmm_i8_direct", 0)]
    assert (qmm_i8_direct.launches, qmm_i8_direct.decode_launches) == (
        n0[0] + DECODE_ROWS + 2, n0[1] + DECODE_ROWS)


# ---------------------------------------------------------------------------
# the kernel's arithmetic, lane by lane
# ---------------------------------------------------------------------------

def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _byte_perm(x, y, s):
    """__byte_perm(x, y, s): byte n of the result is byte (s >> 4n) & 7 of
    the eight bytes of x (0-3) and y (4-7)."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(s >> (4 * n)) & 7] << (8 * n) for n in range(4))


def _transpose4(w):
    """The kernel's transpose4: four words (rows) of four bytes (columns) →
    four words, word e holding byte e of each row in row order."""
    p0, p1 = _byte_perm(w[0], w[1], 0x5140), _byte_perm(w[0], w[1], 0x7362)
    p2, p3 = _byte_perm(w[2], w[3], 0x5140), _byte_perm(w[2], w[3], 0x7362)
    return [_byte_perm(p0, p2, 0x5410), _byte_perm(p0, p2, 0x7632),
            _byte_perm(p1, p3, 0x5410), _byte_perm(p1, p3, 0x7632)]


def _s8(word, byte):
    v = (int(word) >> (8 * byte)) & 0xFF
    return v - 256 if v > 127 else v


def _mma_m16n8k32(a, b, acc):
    """mma.sync.m16n8k32.row.col.s32.s8.s8.s32 by the PTX ISA's fragment
    layout for lanes (g, t) = (lane / 4, lane % 4): A register r holds row g
    + 8 (r % 2), k 16 (r / 2) + 4t .. + 3 (byte order); B register r holds
    column g, k 16 r + 4t .. + 3; D registers (g, 2t), (g, 2t + 1), (g + 8,
    2t), (g + 8, 2t + 1).  a [32][4], b [32][2] words; acc [32][4] ints, added
    to in place."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for r in range(4):
            for e in range(4):
                A[g + 8 * (r & 1), 16 * (r >> 1) + 4 * t + e] = _s8(a[lane][r], e)
        for r in range(2):
            for e in range(4):
                B[16 * r + 4 * t + e, g] = _s8(b[lane][r], e)
    D = A @ B
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        acc[lane] += [D[g, 2 * t], D[g, 2 * t + 1], D[g + 8, 2 * t], D[g + 8, 2 * t + 1]]


def _word(row_bytes, j):
    return int.from_bytes(bytes(row_bytes[4 * j:4 * j + 4]), "little")


def _emulate(x, qt, divide: bool, sms=132):
    """``qmm_i8_direct_decode.cu`` written out: per cluster (strip of 128
    columns) and block (split), each row's largest |x| over the split's slice
    (bf16 bits without the sign), the cluster's maximum over the splits, xs =
    amax / 127 (``divide``, the CPU) or amax * f32(1/127) (the card), 1 where
    0, x8 = rint(x / xs); per warp its run of the split's k-steps; lane (g,
    t) streams rows 4t + h and 16 + 4t + h (h < 4) of its 16 columns c = 16g
    .., transposes each 4 x 4 block of bytes with prmt, and tile i takes
    columns c + 2i (A row g) and c + 2i + 1 (A row g + 8); B is x8 as it
    lies; the warps add in warp order, the splits in split order; the
    epilogue rounds twice to bf16.  Returns (y bf16, x8, xs, int32
    accumulators)."""
    K, N = qt.packed.shape
    M = x.shape[0]
    MT = 2 if M > 8 else 1
    plan = i8_direct_decode_plan(K, N, sms)
    assert plan.accepted
    codes = qt.packed.numpy().view(np.uint8)
    col = absmax_f32(qt).numpy().reshape(-1)
    bits = x.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16).astype(np.uint32)
    xf = (bits << 16).view(np.float32)
    spans = plan.split_rows(K)
    # each split's row maxima, then the cluster's (every cluster alike)
    pmax = np.array([[(bits[m, r0:r1] & 0x7FFF).max() for m in range(M)] for r0, r1 in spans])
    amax = (pmax.max(0).astype(np.uint32) << 16).view(np.float32)
    xs = amax / np.float32(127) if divide else amax * R127
    xs = np.where(xs == 0, np.float32(1), xs).astype(np.float32)
    x8 = np.rint(xf / xs[:, None]).astype(np.int8)
    acc_out = np.zeros((M, N), np.int64)
    for strip in range(plan.strips):
        cb = strip * 128
        total = np.zeros((M, 128), np.int64)
        for r0, r1 in spans:
            nsteps = (r1 - r0) // 32
            xrows = np.zeros((MT * 8, r1 - r0), np.uint8)
            xrows[:M] = x8[:, r0:r1].view(np.uint8)
            red = []
            for wk in range(4):
                acc = np.zeros((MT, 8, 32, 4), np.int64)    # [mt][tile][lane][reg]
                for s in range(wk * nsteps // 4, (wk + 1) * nsteps // 4):
                    tr = np.zeros((32, 2, 4, 4), np.uint64)
                    for lane in range(32):
                        g, t = lane >> 2, lane & 3
                        c = cb + 16 * g
                        rows = [codes[r0 + 32 * s + 4 * t + (h & 3) + 16 * (h >> 2), c:c + 16]
                                if c < N else np.zeros(16, np.uint8) for h in range(8)]
                        for hh in range(2):
                            for j in range(4):
                                tr[lane, hh, j] = _transpose4([_word(rows[4 * hh + r], j)
                                                               for r in range(4)])
                    bx = [[[_word(xrows[mt * 8 + (lane >> 2)], 8 * s + (lane & 3) + 4 * q)
                            for q in range(2)] for lane in range(32)] for mt in range(MT)]
                    for i in range(8):
                        j, e = i >> 1, 2 * (i & 1)
                        a = [[tr[ln, 0, j, e], tr[ln, 0, j, e + 1], tr[ln, 1, j, e],
                              tr[ln, 1, j, e + 1]] for ln in range(32)]
                        for mt in range(MT):
                            _mma_m16n8k32(a, bx[mt], acc[mt, i])
                red.append(acc)
            acc = red[0] + red[1] + red[2] + red[3]          # warp order (exact in integers)
            part = np.zeros((MT * 8, 128), np.int64)
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for mt in range(MT):
                    for h in range(2):
                        for i in range(0, 8, 2):
                            part[mt * 8 + 2 * t + h, 16 * g + 2 * i:16 * g + 2 * i + 4] = [
                                acc[mt, i, lane, h], acc[mt, i, lane, 2 + h],
                                acc[mt, i + 1, lane, h], acc[mt, i + 1, lane, 2 + h]]
            total += part[:M]                                # split order
        n1 = min(cb + 128, N)
        acc_out[:, cb:n1] = total[:, :n1 - cb]
    s_out = col / np.float32(127) if divide else col * R127
    scaled = _bf16(acc_out.astype(np.float32) * s_out.astype(np.float32)[None, :])
    y = torch.from_numpy(scaled * _bf16(xs)[:, None]).to(torch.bfloat16)
    return y, torch.from_numpy(x8), torch.from_numpy(xs[:, None]), acc_out


def _card_plain(x, qt):
    """qmm_i8_direct_plain with the card's division by a Python scalar, a
    multiplication by f32(1/127), written with the port's pieces."""
    xf = x.float()
    xs = xf.abs().amax(dim=1, keepdim=True) * float(R127)
    xs = torch.where(xs == 0, torch.ones_like(xs), xs)
    x8 = torch.round(xf / xs).to(torch.int8)
    s_out = absmax_f32(qt).reshape(-1) * float(R127)
    return qm._w8a8_epilogue(int8_matmul_plain(x8, qt.packed), s_out, xs), x8, xs


# one strip with every lane live, 16 rows (two B tiles) over 8 splits, a
# ragged strip (N = 48: lanes of g >= 3 idle) at one k-step a split, a second
# strip of 16 columns with 9 rows
@pytest.mark.parametrize("M,K,N", [(5, 256, 128), (16, 512, 256), (3, 96, 48), (9, 1024, 144)],
                         ids=str)
def test_i8_direct_decode_fragment_map_and_row_quantization(M, K, N):
    """The emulated kernel equals ``qmm_i8_direct_plain`` bit for bit (the
    rows' codes and scales, the integer sums, the bf16 output), with the
    CPU's division; with the card's reciprocal it equals the card's
    arithmetic, and the rows whose scale differs between the two are those
    where amax / 127 and amax * f32(1/127) differ.  A zero row and a zero
    column stay 0; a row's largest |x| lies in a split other than the
    first."""
    g = torch.Generator().manual_seed(M * K + N)
    w = torch.randn(K, N, generator=g) * K ** -0.5
    w[:, N // 3] = 0
    qt = quantize(w, block_size=K, quant_type="int8", double_quant=False)
    x = torch.randn(M, K, generator=g).to(torch.bfloat16)
    x[0, K - 7] = 9.0                                 # row 0's max in the last split
    x[M - 1] = 0
    y, x8, xs, acc = _emulate(x, qt, divide=True)
    rx8, rxs = quantize_rows(x)
    assert torch.equal(x8, rx8) and torch.equal(xs, rxs)
    assert np.array_equal(acc, int8_matmul_plain(rx8, qt.packed).numpy().astype(np.int64))
    assert torch.equal(y, qmm_i8_direct_plain(x, qt))
    assert (y[M - 1] == 0).all() and (y[:, N // 3] == 0).all()
    yc, x8c, xsc, _ = _emulate(x, qt, divide=False)
    ref, rx8c, rxsc = _card_plain(x, qt)
    assert torch.equal(yc, ref) and torch.equal(x8c, rx8c) and torch.equal(xsc, rxsc)
    amax = x.float().abs().amax(1).numpy()
    differs = (amax / np.float32(127)) != (amax * R127)
    assert np.array_equal((xsc != xs).numpy()[:, 0], differs & (amax != 0))


def test_i8_direct_decode_transposes_and_fragments_place_every_code():
    """Rows of the identity (x8 = 127 at one k) read the int8 codes out through the emulated lanes: every (k, column) of W lands
    once, in its column, whatever its place in a k-step, a 4 x 4 block or a
    strip."""
    K, N = 128, 160
    g = torch.Generator().manual_seed(7)
    qt = quantize(torch.randn(K, N, generator=g), block_size=K, quant_type="int8",
                  double_quant=False)
    for ks in ([0, 1, 3, 4, 15, 16, 17, 31], [32, 63, 100, 127]):
        eye = torch.zeros(len(ks), K, dtype=torch.bfloat16)
        eye[torch.arange(len(ks)), torch.tensor(ks)] = 1
        _, x8, _, acc = _emulate(eye, qt, divide=False)
        assert (x8.abs().amax(1) == 127).all()
        assert np.array_equal(acc, 127 * qt.packed.numpy()[ks].astype(np.int64))


@pytest.mark.parametrize("M,K,N", [(4, 256, 384), (16, 512, 256)])
def test_i8_direct_plain_matches_jax_interpret(M, K, N):
    """``qmm_i8_direct_plain``, which the decode kernel is held to on the
    card, against the JAX package's ``_qmm_pallas_i8_direct`` (interpret mode
    on the CPU), at decode rows: one bf16 ulp of the output's scale, as
    ``tests/test_torch_serve_int8.py`` states."""
    w, x = _inputs(M, K, N, seed=K + M)
    j = jquantize(jnp.asarray(w), block_size=K, quant_type="int8", double_quant=False)
    want = np.asarray(_qmm_pallas_i8_direct(jnp.asarray(x), j.packed, jabsmax_f32(j), (K, N)),
                      np.float32)
    got = qmm_i8_direct_plain(torch.from_numpy(x), _carry(j))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=_ulp_tol(want))
    assert (got[M - 1] == 0).all() and (got[:, 3] == 0).all()


def test_decode_sweep_and_mutant_edits_apply_to_the_source():
    """Every variant of ``decode_sweep.py``'s w8a8 set and every mutant of
    ``tile_sweep.py``'s i8direct set finds the text it replaces in the
    kernel source, once; the plans the sweep tries are whole splits."""
    from qlora_tpu_torch.ops import decode_sweep, tile_sweep

    text = SOURCE.read_text()
    for table in (decode_sweep.W8A8_VARIANTS, tile_sweep.I8_DIRECT_MUTANTS):
        for name, edits in table.items():
            for old, new in edits:
                assert text.count(old) == 1, (name, old)
                assert old != new
    assert tile_sweep.MUTANT_SETS["i8direct"][0] == SOURCE.name
    assert "w8a8" in decode_sweep.SETS and LM_HEAD in decode_sweep.W8A8_SHAPES
