"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test takes the ``cuda`` fixture, which skips when no
CUDA device is present.  Run them on the H100 with
``python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest``
(``tests/conftest.py`` sets up JAX, which the port does not need).

Tolerances: the qmm kernels (the decode kernel up to DECODE_ROWS rows, the
wgmma kernel above, the tile kernel for shapes the wgmma kernel's plan
refuses) decode the same bf16 weights as the plain version and accumulate
in f32 in another order, so outputs differ by at most one bf16 ulp of the
output plus f32 reassociation: rtol 1e-2, atol 2e-2.  The decode and wgmma
kernels are also held bit for bit: rows of the identity read out
``dequantize``'s weight, two calls agree, and a row's result does not
depend on the other rows.  The decode attention kernel rounds
probabilities to bf16 against chunk-wise running maxima, so each
probability may land one ulp (2^-8 relative) apart and an output element
moves by up to 2^-8 of the attended values' scale, even where it cancels
to near 0: each element within 2e-2 of its
(row, head)'s largest |output|.  The planted cases make one key read too
many or too few at a window edge move the output by O(1).  Caches
byte-equal.

The qmm backward kernels (the wgmma kernel of ``qmm_nf4_bwd_wgmma.cu``
above DECODE_ROWS rows where N % 8 == 0, ``qmm_nf4_bwd.cu`` for the rest)
decode the weight with the forward's arithmetic and sum g·Wᵀ in f32 in
another order: rtol 1e-2, atol 2e-2, as the forward.  The wgmma kernel is
also held bit for bit: rows of the identity read out ``dequantize``'s
weight, two calls agree, a row's result does not depend on the other rows.  The flash kernels (the wgmma kernels of
``flash_attention_wgmma.cu``; ``flash_attention.cu``, which they replaced,
through its private wrappers) round the probabilities against tile-wise
running maxima where the plain version has the row's maximum, and sum in
another order: o within 2e-2 of its (row, head)'s largest |o|, lse within
1e-3, each gradient within 2e-2 of the largest |gradient| of its (batch,
head) slice; rows and keys that must get exactly 0 are checked for 0.  The
wgmma kernels are also held bit for bit across two calls and across batch
rows, and take the model's transposed views without copies.

The two w8a8 kernels sum int8 products in int32, which is exact, and their
epilogue is two f32 multiplications and two bf16 roundings that the plain
version makes in the same order: the raw accumulators and the bf16 outputs
are held equal bit for bit.  The int8-storage kernels (``--bits 8``: the
wgmma kernel above DECODE_ROWS rows, the tile kernel of ``qmm_i8.cu`` for
fewer rows and the shapes the wgmma kernel's plan refuses) decode the
weight as ``dequantize`` does and sum in f32 in another order: rtol 1e-2,
atol 2e-2 as the NF4 kernels, and an identity operand reads the decoded
weight out of the forward and the backward, bit for bit; the wgmma kernel
is also held deterministic and batch-invariant, bit for bit.

The direct int8 w8a8 forward up to DECODE_ROWS rows runs the split-K kernel
of ``qmm_i8_direct_decode.cu`` wherever ``i8_direct_decode_plan`` accepts the
shape (K % 32 == 0, N % 16 == 0): it quantizes the rows itself, and its x8,
xs, int32 accumulators and bf16 output are held bit for bit to the plain
version's on the card, across two calls and with each row alone;
``qmm_i8_direct.cu`` keeps more rows and the refused shapes.

The w8a8 forward over NF4 above DECODE_ROWS rows runs the int8 wgmma
kernel of ``qmm_nf4_w8a8_wgmma.cu`` wherever ``w8a8_tile_plan`` accepts the
shape (K % 32 == 0); up to DECODE_ROWS rows the split-K kernel of
``qmm_nf4_w8a8_decode.cu`` wherever ``nf4_w8a8_decode_plan`` accepts it (K %
64, N % 16 and the block size % 32 all 0), which quantizes the rows and
makes the per-column scales itself: its x8, xs, int32 accumulators and bf16
output are held bit for bit to the plain version's on the card, across two
calls and with each row alone; ``qmm_i8_direct.cu`` keeps the rest.  All
held bit for bit, accumulators and outputs, and the wgmma kernel across two
calls and batch rows.

The paged kernels have the decode kernel's arithmetic over a page table:
each output element within 2e-2 of its (row, head)'s largest |output|, the
pools byte-equal after the append (page 0 and untouched pages included).
The decode step and every chunk run the split kernel of
``paged_attention_split.cu``, also held bit for bit across two calls and with
each row alone; the decode and chunk entries of ``paged_attention.cu`` it
replaced are held to the same tolerance.  The chunk kernel at C = 1 is the
decode kernel, bit for bit."""

import importlib

import pytest
import torch

from chip_smoke import one_hot_cols, one_hot_rows, paged_case, plant_edges, plant_flash_edges
from qlora_tpu_torch.generate import generate
from qlora_tpu_torch.models import forward, get_config, init_params
from qlora_tpu_torch.ops import decode_attention_cuda, decode_attention_plain
from qlora_tpu_torch.ops import flash_attention_lse, flash_bwd_dkv, flash_bwd_dq, flash_bwd_plain
from qlora_tpu_torch.ops import flash_fwd, flash_fwd_plain
from qlora_tpu_torch.ops import qmatmul, qmatmul_bwd_plain, qmatmul_plain, qmm_nf4_bwd
from qlora_tpu_torch.ops import qmm_nf4_fwd_dq, qmm_nf4_fwd_f32
from qlora_tpu_torch.ops import default_impl, int8_matmul_plain, qmm_i8_bwd, qmm_i8_bwd_plain
from qlora_tpu_torch.ops import qmm_i8_direct, qmm_i8_direct_plain, qmm_i8_fwd, qmm_i8_fwd_plain
from qlora_tpu_torch.ops import qmm_nf4_w8a8, qmm_nf4_w8a8_plain, quantize_rows
from qlora_tpu_torch.ops import w8a8_codes, w8a8_scales
from qlora_tpu_torch.ops import paged_chunk_attention_cuda, paged_chunk_plain
from qlora_tpu_torch.ops import paged_decode_attention_cuda, paged_decode_plain
from qlora_tpu_torch.ops.qmatmul import DECODE_ROWS, _w8a8_accumulators, i8_tile_plan
from qlora_tpu_torch.ops.qmatmul import _i8_direct_decode_outputs, i8_direct_decode_plan
from qlora_tpu_torch.ops.qmatmul import _nf4_w8a8_decode_outputs, nf4_w8a8_decode_plan
from qlora_tpu_torch.ops.qmatmul import w8a8_tile_plan
from qlora_tpu_torch.generate.serve_int8 import requantize_params_int8_unstacked
from qlora_tpu_torch.quant import dequantize
from qlora_tpu_torch.quant import quantize
from qlora_tpu_torch.utils import move_to

pytestmark = pytest.mark.cuda
torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# decode rows (the decode kernel): LLaMA-7B's up projection, ragged N, block
# 32, three meta-blocks of absmax, block sizes that are no multiple of 8,
# splits longer than the 2048 packed rows staged at once
DECODE_CASES = [(M, K, N, B) for M in (1, 3, 8, 16) for K, N, B in (
    (4096, 11008, 64), (384, 200, 64), (1024, 320, 32), (64 * 600, 96, 64))] + [
    (5, 256, 72, 4), (16, 480, 50, 12), (4, 64 * 1100, 32, 64)]


# more than DECODE_ROWS rows (the wgmma kernel): rows of a verify chunk, one
# CTA's 128 and ragged edges of it, ragged N, block sizes 4, 12, 32 and 64,
# K/2 = 96 not a multiple of the 64-row k-step, three and six meta-blocks of
# absmax (quantize makes K/2 a multiple of the block size, so a block never
# straddles the planes)
WGMMA_CASES = [(M, 4096, 4096, 64) for M in (17, 40, 128)] + [
    (37, 384, 200, 64), (300, 1024, 72, 32), (2048, 4096, 11008, 64), (50, 256, 72, 4),
    (33, 480, 50, 12), (129, 192, 200, 32), (40, 64 * 600, 96, 64), (17, 64 * 1100, 72, 64)]


@pytest.mark.parametrize("M,K,N,block_size", [
    (1, 256, 64, 64), (4, 4096, 4096, 64), (37, 384, 200, 64),
    (300, 1024, 320, 32), (2048, 11008, 512, 64),
] + DECODE_CASES + WGMMA_CASES)
@pytest.mark.parametrize("double_quant", [True, False])
def test_qmm_kernel_matches_plain(cuda, M, K, N, block_size, double_quant):
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    w = torch.randn(K, N, device=cuda, generator=g) * K ** -0.5
    qt = quantize(w, block_size=block_size, double_quant=double_quant)
    x = torch.randn(M, K, device=cuda, generator=g).to(torch.bfloat16)
    wrapper = qmm_nf4_fwd_dq if double_quant else qmm_nf4_fwd_f32
    before = wrapper.launches, wrapper.decode_launches, wrapper.wgmma_launches
    y = qmatmul(x, qt)
    assert (wrapper.launches, wrapper.decode_launches, wrapper.wgmma_launches) == (
        before[0] + 1, before[1] + (M <= DECODE_ROWS), before[2] + (M > DECODE_ROWS))
    torch.testing.assert_close(y.float(), qmatmul_plain(x, qt).float(), rtol=1e-2, atol=2e-2)


def _decode_case(cuda, K, N, block_size, double_quant, M=16):
    g = torch.Generator(device=cuda).manual_seed(K + N + block_size)
    w = torch.randn(K, N, device=cuda, generator=g) * K ** -0.5
    qt = quantize(w, block_size=block_size, double_quant=double_quant)
    x = torch.randn(M, K, device=cuda, generator=g).to(torch.bfloat16)
    return qt, x, qmm_nf4_fwd_dq if double_quant else qmm_nf4_fwd_f32


@pytest.mark.parametrize("K,N,block_size", [(4096, 11008, 64), (64 * 600, 96, 64),
                                            (1024, 320, 32), (480, 50, 12)])
@pytest.mark.parametrize("double_quant", [True, False])
def test_decode_kernel_one_hot_rows_read_out_the_weight(cuda, K, N, block_size, double_quant):
    """16 rows of the identity, at k in both planes and on both sides of an
    absmax-block and (64 * 600) a meta-block edge, give the rows of
    ``dequantize``'s bf16 weight bit for bit: the kernel decodes the same
    weight, and its f32 sums of one product and zeros are exact."""
    qt, _, wrapper = _decode_case(cuda, K, N, block_size, double_quant)
    ks = one_hot_rows(K, block_size, 16)
    x = torch.zeros(16, K, device=cuda, dtype=torch.bfloat16)
    x[torch.arange(16), torch.tensor(ks)] = 1
    before = wrapper.decode_launches
    y = wrapper(x, qt)
    assert wrapper.decode_launches == before + 1
    assert torch.equal(y, dequantize(qt, torch.bfloat16)[ks])


@pytest.mark.parametrize("K,N,block_size", [(4096, 11008, 64), (11008, 4096, 64),
                                            (384, 200, 64)])
@pytest.mark.parametrize("double_quant", [True, False])
def test_decode_kernel_deterministic_and_batch_invariant(cuda, K, N, block_size, double_quant):
    """Two calls give the same bits, and each row alone gives its row of the
    16-row batch bit for bit: the split plan and the order of the sums do
    not depend on M."""
    qt, x, wrapper = _decode_case(cuda, K, N, block_size, double_quant)
    y = wrapper(x, qt)
    assert torch.equal(y, wrapper(x, qt))
    for i in range(x.shape[0]):
        assert torch.equal(wrapper(x[i:i + 1], qt)[0], y[i]), i
    for M in (3, 8):
        assert torch.equal(wrapper(x[:M], qt), y[:M]), M


@pytest.mark.parametrize("double_quant", [True, False])
def test_decode_dispatch_edge(cuda, double_quant):
    """DECODE_ROWS rows take the decode kernel, one more the tile kernel."""
    qt, x, wrapper = _decode_case(cuda, 1024, 320, 64, double_quant, M=DECODE_ROWS + 1)
    for M, took_decode in ((DECODE_ROWS, 1), (DECODE_ROWS + 1, 0)):
        before, decode_before = wrapper.launches, wrapper.decode_launches
        y = wrapper(x[:M], qt)
        assert (wrapper.launches, wrapper.decode_launches) == (before + 1,
                                                               decode_before + took_decode)
        torch.testing.assert_close(y.float(), qmatmul_plain(x[:M], qt).float(), rtol=1e-2,
                                   atol=2e-2)


WGMMA_EXACT = [(4096, 11008, 64), (11008, 4096, 64), (64 * 600, 96, 64), (384, 200, 64),
               (480, 50, 12), (256, 72, 4)]


@pytest.mark.parametrize("K,N,block_size", WGMMA_EXACT)
@pytest.mark.parametrize("double_quant", [True, False])
def test_wgmma_kernel_one_hot_rows_read_out_the_weight(cuda, K, N, block_size, double_quant):
    """40 rows of the identity (both planes, both sides of absmax-block and,
    at 64 * 600, meta-block edges) read out ``dequantize``'s bf16 weight bit
    for bit through the wgmma kernel: it decodes the same weight, and f32 sums
    of one product and zeros are exact."""
    qt, _, wrapper = _decode_case(cuda, K, N, block_size, double_quant)
    ks = one_hot_rows(K, block_size, 40)
    x = torch.zeros(len(ks), K, device=cuda, dtype=torch.bfloat16)
    x[torch.arange(len(ks)), torch.tensor(ks)] = 1
    before = wrapper.wgmma_launches
    y = wrapper(x, qt)
    assert wrapper.wgmma_launches == before + 1
    assert torch.equal(y, dequantize(qt, torch.bfloat16)[ks])


@pytest.mark.parametrize("K,N,block_size", WGMMA_EXACT[:4])
@pytest.mark.parametrize("double_quant", [True, False])
def test_wgmma_kernel_deterministic_and_batch_invariant(cuda, K, N, block_size, double_quant):
    """Two calls give the same bits, and a row gives the same bits in a batch
    of 300 (three CTAs of rows), of 40 and of 17: every output element is one
    CTA's sum over K in a fixed order, whatever the other rows."""
    qt, x, wrapper = _decode_case(cuda, K, N, block_size, double_quant, M=300)
    y = wrapper(x, qt)
    assert torch.equal(y, wrapper(x, qt))
    for lo, M in ((0, 40), (130, 17), (283, 17)):
        assert torch.equal(wrapper(x[lo:lo + M], qt), y[lo:lo + M]), (lo, M)


@pytest.mark.parametrize("double_quant", [True, False])
def test_wgmma_dispatch_edge(cuda, double_quant):
    """DECODE_ROWS rows take the decode kernel, one more the wgmma kernel;
    shapes ``tile_plan`` refuses (K % 8 != 0; K/2 % 8 != 0, where the wgmma
    kernel's high-plane box would start off a 16-byte boundary) take the
    tile kernel of qmm_nf4_fwd.cu, counted in neither."""
    from qlora_tpu_torch.ops.qmatmul import tile_plan

    cases = [(1024, 320, 64, DECODE_ROWS, (1, 0)), (1024, 320, 64, DECODE_ROWS + 1, (0, 1)),
             (36, 40, 6, DECODE_ROWS + 4, (0, 0)), (200, 72, 2, 50, (0, 0)),
             (216, 72, 4, 50, (0, 0)), (208, 72, 4, 50, (0, 1))]
    assert not tile_plan(DECODE_ROWS + 4, 36, 40, 6).accepted
    assert not tile_plan(50, 200, 72, 2).accepted
    for K, N, B, M, (took_decode, took_wgmma) in cases:
        qt, x, wrapper = _decode_case(cuda, K, N, B, double_quant, M=M)
        before = wrapper.launches, wrapper.decode_launches, wrapper.wgmma_launches
        y = wrapper(x, qt)
        assert (wrapper.launches, wrapper.decode_launches, wrapper.wgmma_launches) == (
            before[0] + 1, before[1] + took_decode, before[2] + took_wgmma), (K, M)
        torch.testing.assert_close(y.float(), qmatmul_plain(x, qt).float(), rtol=1e-2,
                                   atol=2e-2)


def test_qmm_rejects_bad_input(cuda):
    qt = quantize(torch.randn(256, 64, device=cuda))
    with pytest.raises(ValueError):
        qmm_nf4_fwd_dq(torch.zeros(4, 128, device=cuda, dtype=torch.bfloat16), qt)
    with pytest.raises(ValueError):
        qmm_nf4_fwd_f32(torch.zeros(4, 256, device=cuda, dtype=torch.bfloat16), qt)


# the split kernel's edges: G = 1, 4 and 8 at head dims 64, 128 and 256;
# windows of 1 (no cached key), 2 and 65 (one key past a 64-key chunk);
# lengths 0, 1, at the capacity and past it; T = 2048 (five splits of 448
# keys) and T = 100 (no multiple of a chunk); planted edges at every split
# boundary a length crosses
ATTN_SPLIT_CASES = [
    (2, 8, 8, 64, 300, [299, 0], None, False),
    (3, 16, 4, 128, 257, [1, 256, 257], 65, True),
    (2, 16, 2, 256, 100, [100, 37], None, True),
    (4, 32, 32, 128, 2048, [0, 511, 1500, 2047], None, False),
    (2, 32, 4, 128, 640, [639, 129], 1, False),
    (2, 32, 4, 128, 640, [640, 2], 2, True),
    (3, 24, 3, 64, 513, [448, 449, 513], None, True),
]


@pytest.mark.parametrize("B,H,KVH,hd,T,lens,window,planted", [
    (4, 32, 32, 128, 640, [0, 97, 383, 639], None, False),
    (2, 32, 8, 128, 300, [5, 299], 256, False),
    (3, 8, 2, 64, 130, [0, 129, 130], None, False),     # 130 == T: no write
    (2, 64, 2, 256, 70, [69, 3], 16, False),            # G = 32
    (4, 32, 8, 128, 640, [0, 97, 383, 639], 256, True),
    (3, 8, 2, 64, 130, [1, 64, 129], None, True),
] + ATTN_SPLIT_CASES)
def test_decode_kernel_matches_plain(cuda, B, H, KVH, hd, T, lens, window, planted):
    g = torch.Generator(device=cuda).manual_seed(T)
    mk = lambda *s: torch.randn(*s, device=cuda, generator=g).to(torch.bfloat16)
    q, nk, nv, kc, vc = mk(B, H, hd), mk(B, KVH, hd), mk(B, KVH, hd), \
        mk(B, KVH, T, hd), mk(B, KVH, T, hd)
    if planted:
        plant_edges(q, kc, lens, window)
    L = torch.tensor(lens, device=cuda, dtype=torch.int32)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    before = decode_attention_cuda.launches
    o1, _, _ = decode_attention_cuda(q, nk, nv, k1, v1, L, sm_scale=hd ** -0.5,
                                     sliding_window=window)
    o2, _, _ = decode_attention_plain(q, nk, nv, k2, v2, L, sm_scale=hd ** -0.5,
                                      sliding_window=window)
    assert decode_attention_cuda.launches == before + 1
    d = (o1.float() - o2.float()).abs()
    tol = 2e-2 * o2.float().abs().amax(-1, keepdim=True)
    assert (d <= tol).all(), f"max excess {(d - tol).max().item()}"
    assert torch.equal(k1, k2) and torch.equal(v1, v2)


def _attn_case(cuda, B, H, KVH, hd, T, lens, window, planted, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    mk = lambda *s: torch.randn(*s, device=cuda, generator=g).to(torch.bfloat16)
    q, nk, nv, kc, vc = mk(B, H, hd), mk(B, KVH, hd), mk(B, KVH, hd), \
        mk(B, KVH, T, hd), mk(B, KVH, T, hd)
    if planted:
        plant_edges(q, kc, lens, window)
    return q, nk, nv, kc, vc, torch.tensor(lens, device=cuda, dtype=torch.int32)


@pytest.mark.parametrize("B,H,KVH,hd,T,lens,window", [
    (4, 32, 32, 128, 640, [0, 97, 383, 639], None),
    (4, 32, 8, 128, 640, [0, 97, 383, 639], 256),
    (4, 32, 32, 128, 2048, [0, 511, 1500, 2047], None),
    (3, 64, 2, 256, 130, [129, 1, 130], None),         # G = 32: two CTAs of query heads
])
def test_decode_split_deterministic_and_row_invariant(cuda, B, H, KVH, hd, T, lens, window):
    """Two calls give the same bits, and each row alone gives its row of the
    batch bit for bit: the plan depends on T and the heads, not on B or the
    lengths, and the splits merge in a fixed order."""
    q, nk, nv, kc, vc, L = _attn_case(cuda, B, H, KVH, hd, T, lens, window, False, T + B)
    kw = dict(sm_scale=hd ** -0.5, sliding_window=window)
    o1, _, _ = decode_attention_cuda(q, nk, nv, kc, vc, L, **kw)
    o2, _, _ = decode_attention_cuda(q, nk, nv, kc, vc, L, **kw)
    assert torch.equal(o1, o2)
    for b in range(B):
        ob, _, _ = decode_attention_cuda(q[b:b + 1], nk[b:b + 1], nv[b:b + 1], kc[b:b + 1],
                                         vc[b:b + 1], L[b:b + 1], **kw)
        assert torch.equal(ob[0], o1[b]), b


@pytest.mark.parametrize("B,H,KVH,hd,T,lens,window,planted", [
    (4, 32, 32, 128, 640, [0, 97, 383, 639], None, False),
    (4, 32, 8, 128, 640, [0, 97, 383, 639], 256, True),
    (2, 64, 2, 256, 70, [69, 3], 16, False),
])
def test_decode_attention_before_still_matches_plain(cuda, B, H, KVH, hd, T, lens, window,
                                                     planted):
    """The kernel the split kernel replaced (decode_attention.cu, through its
    private wrapper, uncounted) holds the plain version as it did."""
    da = importlib.import_module("qlora_tpu_torch.ops.decode_attention")
    q, nk, nv, kc, vc, L = _attn_case(cuda, B, H, KVH, hd, T, lens, window, planted, T)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    before = decode_attention_cuda.launches
    o1, _, _ = da._decode_attention_before(q, nk, nv, k1, v1, L, sm_scale=hd ** -0.5,
                                           sliding_window=window)
    o2, _, _ = decode_attention_plain(q, nk, nv, k2, v2, L, sm_scale=hd ** -0.5,
                                      sliding_window=window)
    assert decode_attention_cuda.launches == before
    d = (o1.float() - o2.float()).abs()
    assert (d <= 2e-2 * o2.float().abs().amax(-1, keepdim=True)).all()
    assert torch.equal(k1, k2) and torch.equal(v1, v2)


def test_debug_model_card_matches_cpu(cuda):
    """The same weights through the kernels and through the plain path:
    logits within atol 0.1 (bf16 activations rounded in other orders, see
    tests/test_torch_model.py)."""
    cfg = get_config("debug")
    p_cpu = init_params(cfg, seed=0, device="cpu")
    p_gpu = move_to(p_cpu, cuda)
    ids = torch.tensor([[3, 17, 5, 9], [4, 7, 0, 0]])
    lengths = torch.tensor([4, 2])
    toks = generate(p_gpu, None, ids, lengths, cfg, max_new_tokens=4, eos_id=-1)
    assert toks.shape == (2, 4) and toks.is_cuda
    flash_before = flash_fwd.launches
    long_ids = torch.arange(128)[None] % cfg.vocab_size
    got, _ = forward(p_gpu, None, long_ids.to(cuda), cfg)        # "auto" takes the kernel
    assert flash_fwd.launches == flash_before + cfg.num_layers
    want, _ = forward(p_cpu, None, long_ids, cfg)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0.1)
    got, _ = forward(p_gpu, None, ids.to(cuda), cfg, use_flash="never")
    want, _ = forward(p_cpu, None, ids, cfg)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0.1)


# more than DECODE_ROWS rows of NF4 dx (qmm_nf4_bwd_wgmma.cu): one past the
# edge, 256-row CTAs (1024 and 2048 rows), K/2 % 64 != 0 (K = 320: 32 columns
# into the last run; K = 200: K/2 % 8 != 0, scalar stores; K = 36), block
# sizes 2 (each element's own absmax), 4, 12, 32 and 64, ragged N, the planes
# in different meta-blocks of absmax (K = 64 * 520); N = 50 sends the shape to
# qmm_nf4_bwd.cu (a row stride TMA cannot take)
NF4_BWD_WGMMA_CASES = [
    (17, 4096, 4096, 64), (40, 320, 64, 32), (50, 200, 72, 2), (33, 480, 56, 12),
    (2048, 4096, 11008, 64), (1024, 11008, 4096, 64), (17, 64 * 520, 64, 64),
    (300, 256, 72, 4), (20, 36, 40, 2), (33, 480, 50, 12)]


@pytest.mark.parametrize("M,K,N,block_size", [
    (1, 256, 64, 64), (1024, 4096, 4096, 64), (37, 384, 200, 64),
    (300, 1024, 320, 32), (130, 11008, 512, 64), (16, 64 * 600, 96, 64),
] + NF4_BWD_WGMMA_CASES)
@pytest.mark.parametrize("double_quant", [True, False])
def test_qmm_bwd_kernel_matches_plain(cuda, M, K, N, block_size, double_quant):
    """dx through autograd: the wgmma kernel above DECODE_ROWS rows where N %
    8 == 0, else qmm_nf4_bwd.cu, within the tolerance of the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(M + K + N)
    w = torch.randn(K, N, device=cuda, generator=gen) * K ** -0.5
    qt = quantize(w, block_size=block_size, double_quant=double_quant)
    g = torch.randn(M, N, device=cuda, generator=gen).to(torch.bfloat16)
    x = torch.randn(M, K, device=cuda, generator=gen).to(torch.bfloat16).requires_grad_()
    before = qmm_nf4_bwd.launches, qmm_nf4_bwd.wgmma_launches
    qmatmul(x, qt).backward(g)
    assert (qmm_nf4_bwd.launches, qmm_nf4_bwd.wgmma_launches) == (
        before[0] + 1, before[1] + (M > DECODE_ROWS and N % 8 == 0))
    assert x.grad.dtype == torch.bfloat16 and x.grad.shape == (M, K)
    torch.testing.assert_close(x.grad.float(), qmatmul_bwd_plain(g, qt).float(),
                               rtol=1e-2, atol=2e-2)


def test_qmm_bwd_sees_the_forward_weight(cuda):
    """An identity cotangent reads the decoded weight out of the backward
    kernel, an identity input out of the forward one: both must be the
    plain dequantize, bit for bit, with int8 and with f32 absmax."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    for dq in (True, False):
        K, N = 64 * 260 * 2, 64                       # two meta-blocks of absmax rows
        qt = quantize(torch.randn(K, N, device=cuda, generator=gen), double_quant=dq)
        w = dequantize(qt, torch.bfloat16)
        eye_n = torch.eye(N, device=cuda, dtype=torch.bfloat16)
        assert torch.equal(qmm_nf4_bwd(eye_n, qt), w.T.contiguous())
        qt2 = quantize(torch.randn(256, 192, device=cuda, generator=gen), double_quant=dq)
        eye_k = torch.eye(256, device=cuda, dtype=torch.bfloat16)
        assert torch.equal(qmatmul(eye_k, qt2), dequantize(qt2, torch.bfloat16))
        assert torch.equal(qmm_nf4_bwd(torch.eye(192, device=cuda, dtype=torch.bfloat16), qt2),
                           dequantize(qt2, torch.bfloat16).T.contiguous())


def _nf4_bwd_case(cuda, M, K, N, block_size, double_quant):
    gen = torch.Generator(device=cuda).manual_seed(M + K + N + block_size)
    w = torch.randn(K, N, device=cuda, generator=gen) * K ** -0.5
    qt = quantize(w, block_size=block_size, double_quant=double_quant)
    return qt, torch.randn(M, N, device=cuda, generator=gen).to(torch.bfloat16)


# the LLaMA shapes, the planes in different meta-blocks (K = 64 * 520), K/2 %
# 64 != 0 with blocks of 32 (K = 320), 12 (K = 480, no multiple of 8) and 2
# (K = 200, no multiple of 4: each element's own absmax; K/2 % 8 != 0)
NF4_BWD_EXACT = [(4096, 11008, 64), (11008, 4096, 64), (64 * 520, 64, 64), (320, 64, 32),
                 (480, 56, 12), (200, 72, 2)]


@pytest.mark.parametrize("K,N,block_size", NF4_BWD_EXACT)
@pytest.mark.parametrize("double_quant", [True, False])
def test_nf4_bwd_wgmma_identity_reads_out_the_weight(cuda, K, N, block_size, double_quant):
    """Rows of the identity as g read ``dequantize``'s bf16 weight out of the
    wgmma kernel bit for bit, as rows of dx: every column of dx, low and
    high plane, both sides of the absmax-block and meta-block edges.  It
    decodes the same weight, and f32 sums of one product and zeros are
    exact."""
    qt, _ = _nf4_bwd_case(cuda, 40, K, N, block_size, double_quant)
    w = dequantize(qt, torch.bfloat16)
    cs = one_hot_cols(N, 40)
    g = torch.zeros(len(cs), N, device=cuda, dtype=torch.bfloat16)
    g[torch.arange(len(cs)), torch.tensor(cs)] = 1
    before = qmm_nf4_bwd.wgmma_launches
    dx = qmm_nf4_bwd(g, qt)
    assert qmm_nf4_bwd.wgmma_launches == before + (len(cs) > DECODE_ROWS)
    assert torch.equal(dx, w[:, cs].T.contiguous())


@pytest.mark.parametrize("K,N,block_size", NF4_BWD_EXACT)
@pytest.mark.parametrize("double_quant", [True, False])
def test_nf4_bwd_wgmma_deterministic_and_batch_invariant(cuda, K, N, block_size, double_quant):
    """Two calls give the same bits, and a row gives the same bits in a batch
    of 2048 (256-row CTAs at the LLaMA shapes), of 300, of 40 and of 17:
    every element of dx is one CTA's sum over n in ascending order, whatever
    the other rows."""
    qt, g = _nf4_bwd_case(cuda, 2048, K, N, block_size, double_quant)
    dx = qmm_nf4_bwd(g, qt)
    assert torch.equal(dx, qmm_nf4_bwd(g, qt))
    for lo, M in ((0, 17), (1000, 40), (130, 300), (2048 - 17, 17)):
        assert torch.equal(qmm_nf4_bwd(g[lo:lo + M], qt), dx[lo:lo + M]), (lo, M)


@pytest.mark.parametrize("double_quant", [True, False])
def test_nf4_bwd_wgmma_dispatch_edge(cuda, double_quant):
    """DECODE_ROWS rows take qmm_nf4_bwd.cu, one more the wgmma kernel; an N
    whose row stride TMA cannot take (N % 8 != 0) takes qmm_nf4_bwd.cu."""
    for K, N, B, M, took in ((320, 64, 32, DECODE_ROWS, 0), (320, 64, 32, DECODE_ROWS + 1, 1),
                             (480, 50, 12, 40, 0), (480, 56, 12, 40, 1)):
        qt, g = _nf4_bwd_case(cuda, M, K, N, B, double_quant)
        before = qmm_nf4_bwd.launches, qmm_nf4_bwd.wgmma_launches
        dx = qmm_nf4_bwd(g, qt)
        assert (qmm_nf4_bwd.launches, qmm_nf4_bwd.wgmma_launches) == (before[0] + 1,
                                                                      before[1] + took), (K, N, M)
        torch.testing.assert_close(dx.float(), qmatmul_bwd_plain(g, qt).float(), rtol=1e-2,
                                   atol=2e-2)


def test_qmm_no_backward_launch_without_input_grad(cuda):
    qt = quantize(torch.randn(256, 64, device=cuda))
    x = torch.randn(8, 256, device=cuda).to(torch.bfloat16)
    before = qmm_nf4_bwd.launches
    y = qmatmul(x, qt)
    assert not y.requires_grad and qmm_nf4_bwd.launches == before


FLASH_CASES = [   # B, H, KVH, D, S, lens, causal, window, planted, the model's transposed views
    (2, 32, 32, 128, 512, [512, 300], True, None, False, False),
    (2, 32, 8, 128, 512, [512, 300], True, 256, False, False),    # GQA G=4, sliding window
    (2, 8, 8, 128, 600, [600, 77], True, None, False, False),     # S not a multiple of 64
    (3, 4, 2, 64, 200, [200, 0, 1], True, 64, False, False),      # a row of length 0, D=64
    (2, 4, 4, 64, 130, [130, 65], False, None, False, False),     # not causal
    (2, 8, 2, 128, 384, [384, 200], True, 100, True, False),      # planted edges
    (2, 4, 4, 64, 192, [192, 131], True, None, True, False),
    (2, 8, 4, 128, 256, [256, 100], True, None, False, False),    # GQA G=2
    (3, 4, 2, 128, 200, [200, 1, 63], True, 1, False, False),     # window 1, lengths 1 and 63
    (3, 4, 4, 64, 130, [64, 65, 63], False, None, False, False),  # lengths at a tile edge
    (3, 4, 4, 128, 200, [65, 64, 1], True, None, False, False),
    (2, 8, 2, 128, 384, [384, 200], True, 100, True, True),       # [B, S, H, D] memory
    (2, 4, 2, 64, 50, [50, 17], True, None, False, True),         # S shorter than a tile
    # head dim 256 (the Gemma presets): its own dq and dk, dv tiles
    (2, 16, 16, 256, 512, [512, 300], True, None, False, False),  # gemma-7b's train shape
    (2, 8, 1, 256, 512, [512, 300], True, 256, True, False),      # gemma-2b's MQA, planted
    (2, 4, 4, 256, 600, [600, 77], True, None, False, True),      # S % 64 != 0, [B, S, H, D]
    (3, 4, 2, 256, 200, [200, 0, 1], True, 64, False, False),     # a row of length 0
    (2, 4, 4, 256, 130, [130, 65], False, None, False, False),    # not causal
    (3, 4, 2, 256, 200, [65, 64, 1], True, 1, False, False),      # window 1, tile edges
]


def _slice_tol(ref):
    return 2e-2 * ref.float().abs().amax((-2, -1), keepdim=True).clamp_min(1e-6)


def _flash_inputs(cuda, B, H, KVH, D, S, lens, window, planted, transposed, seed):
    """q, k, v, do bf16 [B, heads, S, D] (transposed: views of [B, S, heads,
    D] memory, as the model hands them over), the lengths and the scale."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    if transposed:
        mk = lambda b, h, s, d: torch.randn(b, s, h, d, device=cuda, generator=gen).to(
            torch.bfloat16).transpose(1, 2)
    else:
        mk = lambda *s: torch.randn(*s, device=cuda, generator=gen).to(torch.bfloat16)
    q, k, v, do = mk(B, H, S, D), mk(B, KVH, S, D), mk(B, KVH, S, D), mk(B, H, S, D)
    if planted:
        plant_flash_edges(q, k, v, lens, window)
    return q, k, v, do, torch.tensor(lens, device=cuda, dtype=torch.int32), D ** -0.5


def _flash_counts():
    return tuple((w.launches, w.wgmma_launches) for w in (flash_fwd, flash_bwd_dq, flash_bwd_dkv))


def _wide_counts():
    return tuple(w.wide_launches for w in (flash_fwd, flash_bwd_dq, flash_bwd_dkv))


@pytest.mark.parametrize("B,H,KVH,D,S,lens,causal,window,planted,transposed", FLASH_CASES)
def test_flash_kernels_match_plain(cuda, B, H, KVH, D, S, lens, causal, window, planted,
                                   transposed):
    q, k, v, do, L, sm = _flash_inputs(cuda, B, H, KVH, D, S, lens, window, planted,
                                       transposed, S + H)
    gen = torch.Generator(device=cuda).manual_seed(S)
    n0, w0 = _flash_counts(), _wide_counts()
    o, lse = flash_fwd(q, k, v, L, sm, causal, window)
    o2, lse2 = flash_fwd_plain(q, k, v, L, sm, causal, window)
    d = (o.float() - o2.float()).abs()
    tol = 2e-2 * o2.float().abs().amax(-1, keepdim=True)
    assert (d <= tol).all(), f"o: max excess {(d - tol).max().item()}"
    torch.testing.assert_close(lse, lse2, rtol=1e-3, atol=1e-3)
    empty = torch.tensor(lens, device=cuda) == 0
    assert (o[empty] == 0).all() and (lse[empty] == 3e38).all()
    # the backward kernels on the plain forward's residuals, with an lse cotangent
    dlse = torch.randn(B, H, S, device=cuda, generator=gen) * 0.1
    di = (o2.float() * do.float()).sum(-1) - dlse
    dq = flash_bwd_dq(q, k, v, L, do, lse2, di, sm, causal, window)
    dk, dv = flash_bwd_dkv(q, k, v, L, do, lse2, di, sm, causal, window)
    # each call launched its wgmma kernel once, at head dim 256 the WIDE_D tiles'
    assert _flash_counts() == tuple((n + 1, w + 1) for n, w in n0)
    assert _wide_counts() == tuple(w + (D == 256) for w in w0)
    rq, rk, rv = flash_bwd_plain(q, k, v, L, o2, lse2, do, sm, causal, window, dlse=dlse)
    for name, got, ref in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
        d = (got.float() - ref.float()).abs()
        assert (d <= _slice_tol(ref)).all(), f"{name}: max excess {(d - _slice_tol(ref)).max()}"
    for b, n in enumerate(lens):       # keys past the length get exactly nothing
        assert (dk[b, :, n:] == 0).all() and (dv[b, :, n:] == 0).all()
    assert (dq[empty] == 0).all()
    if transposed:                     # outputs in the inputs' layout: no copies around
        assert o.transpose(1, 2).is_contiguous() and dq.stride() == q.stride()
        assert dk.stride() == k.stride() and dv.stride() == v.stride()


@pytest.mark.parametrize("B,H,KVH,D,S,lens,causal,window", [
    (3, 8, 2, 128, 384, [384, 200, 77], True, 100),
    (3, 4, 4, 64, 200, [130, 200, 1], False, None),
    (3, 32, 32, 128, 512, [512, 300, 0], True, None),
    (3, 8, 1, 256, 384, [384, 200, 77], True, 100),
    (3, 16, 16, 256, 512, [512, 300, 0], True, None),
])
def test_flash_wgmma_deterministic_and_row_invariant(cuda, B, H, KVH, D, S, lens, causal,
                                                     window):
    """Two calls give the same bits for o, lse, dq, dk and dv (no atomics,
    one order of summation), and a batch row's results do not depend on the
    other rows: the middle row alone gives its bits again."""
    q, k, v, do, L, sm = _flash_inputs(cuda, B, H, KVH, D, S, lens, window, False, False, 5)

    def run(q, k, v, do, L):
        o, lse = flash_fwd(q, k, v, L, sm, causal, window)
        di = (o.float() * do.float()).sum(-1)
        dq = flash_bwd_dq(q, k, v, L, do, lse, di, sm, causal, window)
        return (o, lse, dq, *flash_bwd_dkv(q, k, v, L, do, lse, di, sm, causal, window))

    first, second = run(q, k, v, do, L), run(q, k, v, do, L)
    alone = run(*(t[1:2].clone() for t in (q, k, v, do, L)))
    for name, a, b, c in zip(("o", "lse", "dq", "dk", "dv"), first, second, alone):
        assert torch.equal(a, b), f"{name} differs between two calls"
        assert torch.equal(a[1:2], c), f"{name} of row 1 depends on the other rows"


@pytest.mark.parametrize("B,H,KVH,D,S,lens,causal,window,planted,transposed",
                         [FLASH_CASES[i] for i in (1, 3, 4, 5)])
def test_flash_before_kernels_still_match_plain(cuda, B, H, KVH, D, S, lens, causal, window,
                                                planted, transposed):
    """``csrc/flash_attention.cu``, the WMMA kernels the wgmma kernels
    replaced, through their private wrappers (the "before" that
    chip_smoke.py times): still within the same tolerances, uncounted."""
    fa = importlib.import_module("qlora_tpu_torch.ops.flash_attention")
    q, k, v, do, L, sm = _flash_inputs(cuda, B, H, KVH, D, S, lens, window, planted,
                                       transposed, S + H)
    n0 = _flash_counts()
    o, lse = fa._flash_fwd_before(q, k, v, L, sm, causal, window)
    o2, lse2 = flash_fwd_plain(q, k, v, L, sm, causal, window)
    d = (o.float() - o2.float()).abs()
    assert (d <= 2e-2 * o2.float().abs().amax(-1, keepdim=True)).all()
    torch.testing.assert_close(lse, lse2, rtol=1e-3, atol=1e-3)
    dlse = torch.randn(B, H, S, device=cuda, generator=torch.Generator(device=cuda).manual_seed(
        S)) * 0.1
    di = (o2.float() * do.float()).sum(-1) - dlse
    dq = fa._flash_bwd_dq_before(q, k, v, L, do, lse2, di, sm, causal, window)
    dk, dv = fa._flash_bwd_dkv_before(q, k, v, L, do, lse2, di, sm, causal, window)
    rq, rk, rv = flash_bwd_plain(q, k, v, L, o2, lse2, do, sm, causal, window, dlse=dlse)
    for got, ref in ((dq, rq), (dk, rk), (dv, rv)):
        assert ((got.float() - ref.float()).abs() <= _slice_tol(ref)).all()
    assert _flash_counts() == n0


def test_flash_autograd_launches_all_three(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    mk = lambda *s: torch.randn(*s, device=cuda, generator=gen).to(torch.bfloat16)
    q, k, v = (t.requires_grad_() for t in (mk(1, 4, 128, 64), mk(1, 2, 128, 64),
                                             mk(1, 2, 128, 64)))
    L = torch.tensor([100], device=cuda, dtype=torch.int32)
    n0 = (flash_fwd.launches, flash_bwd_dq.launches, flash_bwd_dkv.launches)
    o, lse = flash_attention_lse(q, k, v, L, 0.125, True, None)
    (o.float().square().sum() + lse[:, :, :100].sum()).backward()
    assert (flash_fwd.launches, flash_bwd_dq.launches, flash_bwd_dkv.launches) == \
        tuple(n + 1 for n in n0)
    qc, kc, vc = (t.detach().cpu().requires_grad_() for t in (q, k, v))
    oc, lsec = flash_attention_lse(qc, kc, vc, L.cpu(), 0.125, True, None)
    (oc.float().square().sum() + lsec[:, :, :100].sum()).backward()
    for got, ref in ((q.grad, qc.grad), (k.grad, kc.grad), (v.grad, vc.grad)):
        d = (got.float().cpu() - ref.float()).abs()
        assert (d <= _slice_tol(ref)).all()


def test_flash_rejects_bad_input(cuda):
    q = torch.zeros(1, 4, 64, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        flash_fwd(q, q, q, torch.tensor([64], device=cuda))
    q = torch.zeros(1, 4, 64, 192, device=cuda, dtype=torch.bfloat16)   # 192 % 64 == 0
    with pytest.raises(ValueError, match="head_dim 192"):
        flash_fwd(q, q, q, torch.tensor([64], device=cuda))
    q = torch.zeros(1, 4, 64, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="pair up"):
        flash_fwd(q, q[:, :3], q[:, :3], torch.tensor([64], device=cuda))


# ---------------------------------------------------------------------------
# the int8 family
# ---------------------------------------------------------------------------

I8_SHAPES = [   # M, K, N
    (1, 256, 64), (4, 4096, 4096), (5, 200, 328), (37, 384, 200), (300, 1024, 320),
    (130, 11008, 512), (16, 1000, 24), (4, 4096, 32768),
]


@pytest.mark.parametrize("M,K,N", I8_SHAPES)
def test_i8_direct_kernel_equals_plain(cuda, M, K, N):
    gen = torch.Generator(device=cuda).manual_seed(M + K + N)
    w = torch.randn(K, N, device=cuda, generator=gen) * K ** -0.5
    w[:, N // 2] = 0                                   # a zero column, scale guarded to 1
    qt = quantize(w, block_size=K, quant_type="int8", double_quant=False)
    x = torch.randn(M, K, device=cuda, generator=gen).to(torch.bfloat16)
    x[M - 1] = 0                                       # a zero row
    before, decode = qmm_i8_direct.launches, qmm_i8_direct.decode_launches
    with default_impl("w8a8"):
        y = qmatmul(x, qt)
    assert qmm_i8_direct.launches == before + 1
    # up to DECODE_ROWS rows of an accepted shape: qmm_i8_direct_decode.cu
    took = M <= DECODE_ROWS and i8_direct_decode_plan(K, N, 132).accepted
    assert qmm_i8_direct.decode_launches == decode + took
    x8, xs = quantize_rows(x)
    acc = _w8a8_accumulators(x8, qt)                   # qmm_i8_direct.cu, the before
    assert acc.dtype == torch.int32
    assert torch.equal(acc, int8_matmul_plain(x8, qt.packed).to(torch.int32))
    if took:
        got = _i8_direct_decode_outputs(x, qt)
        assert torch.equal(got[0], acc) and torch.equal(got[1], x8) and torch.equal(got[2], xs)
    assert torch.equal(y, qmm_i8_direct_plain(x, qt))
    assert (y[M - 1] == 0).all() and (y[:, N // 2] == 0).all()


# qmm_i8_direct_decode.cu: the LLaMA-7B linears and the padded lm_head, one
# strip, a ragged strip (N = 144), one k-step (K = 32), double-quantized
# per-column storage; then shapes it refuses, which stay on qmm_i8_direct.cu
I8_DIRECT_DECODE_SHAPES = [(4096, 4096, False), (4096, 11008, False), (11008, 4096, False),
                           (4096, 32768, False), (256, 64, False), (1024, 144, False),
                           (32, 16, False), (512, 96, True)]
_I8_DIRECT_QT: dict = {}


def _i8_direct_qt(cuda, K, N, dq):
    """A per-column int8 weight of [K, N] (one per shape, made once), with a
    zero column."""
    if (K, N, dq) not in _I8_DIRECT_QT:
        gen = torch.Generator(device=cuda).manual_seed(K + N + dq)
        w = torch.randn(K, N, device=cuda, generator=gen) * K ** -0.5
        w[:, N // 2] = 0
        _I8_DIRECT_QT.clear()
        _I8_DIRECT_QT[K, N, dq] = quantize(w, block_size=K, quant_type="int8", double_quant=dq)
    return _I8_DIRECT_QT[K, N, dq]


@pytest.mark.parametrize("K,N,dq", I8_DIRECT_DECODE_SHAPES)
def test_i8_direct_decode_kernel_equals_plain(cuda, K, N, dq):
    """At 1 to 16 rows the decode kernel took the call, and its x8 and xs
    equal ``quantize_rows``' on the card, its int32 accumulators the exact
    integer product and its bf16 output ``qmm_i8_direct_plain``'s, bit for
    bit; rows of another scale and a zero row included."""
    qt = _i8_direct_qt(cuda, K, N, dq)
    gen = torch.Generator(device=cuda).manual_seed(K * 3 + N)
    for M in range(1, DECODE_ROWS + 1):
        x = torch.randn(M, K, device=cuda, generator=gen).to(torch.bfloat16)
        x[0, K // 3:] *= 50                            # row 0's max in a later split
        if M > 2:
            x[M - 1] = 0
        n = qmm_i8_direct.decode_launches
        y = qmm_i8_direct(x, qt)
        assert qmm_i8_direct.decode_launches == n + 1
        acc, x8, xs = _i8_direct_decode_outputs(x, qt)
        rx8, rxs = quantize_rows(x)
        assert torch.equal(x8, rx8) and torch.equal(xs, rxs), M
        assert torch.equal(acc, int8_matmul_plain(rx8, qt.packed).to(torch.int32)), M
        assert torch.equal(y, qmm_i8_direct_plain(x, qt)), M
        assert (y[:, N // 2] == 0).all() and (M <= 2 or (y[M - 1] == 0).all())


@pytest.mark.parametrize("K,N,M", [(4096, 4096, 16), (11008, 4096, 5), (4096, 32768, 8),
                                   (1024, 144, 9)])
def test_i8_direct_decode_deterministic_and_batch_invariant(cuda, K, N, M):
    """The decode kernel bit for bit across two calls, with each row alone
    and with the rows in other batches (8 and 9 rows: one and two B tiles);
    the rows of another run's codes (``given``) give that run's output."""
    qm = importlib.import_module("qlora_tpu_torch.ops.qmatmul")
    qt = _i8_direct_qt(cuda, K, N, False)
    gen = torch.Generator(device=cuda).manual_seed(M + K)
    x = torch.randn(M, K, device=cuda, generator=gen).to(torch.bfloat16)
    y = qmm_i8_direct(x, qt)
    assert torch.equal(qmm_i8_direct(x, qt), y)
    for m in range(M):
        assert torch.equal(qmm_i8_direct(x[m:m + 1], qt), y[m:m + 1]), m
    for a, b in ((0, min(M, 9)), (max(0, M - 8), M)):
        assert torch.equal(qmm_i8_direct(x[a:b], qt), y[a:b]), (a, b)
    plan = i8_direct_decode_plan(K, N, torch.cuda.get_device_properties(cuda).multi_processor_count)
    x8, xs = quantize_rows(x)
    assert torch.equal(qm._i8_direct_decode_launch(torch.zeros_like(x), qt, plan,
                                                   rows=(x8, xs)), y)


@pytest.mark.parametrize("M,K,N,decode", [(4, 4096, 4096, 1), (17, 256, 64, 0), (4, 200, 64, 0)])
def test_i8_direct_repeat_times_the_dispatch_kernel(cuda, M, K, N, decode):
    """``bench_kernels.i8_direct_repeat`` runs the kernel the dispatch takes
    for its rows (the decode kernel up to 16 rows of an accepted shape, with
    x8 and xs = 1 as its given rows; qmm_i8_direct.cu else) and gives that
    kernel's result: the exact sum times the column scale the kernel makes
    from s_out * 127."""
    from qlora_tpu_torch.ops.bench_kernels import i8_direct_repeat

    gen = torch.Generator(device=cuda).manual_seed(M + N)
    qt = quantize(torch.randn(K, N, device=cuda, generator=gen) * K ** -0.5, block_size=K,
                  quant_type="int8", double_quant=False)
    x8, _ = quantize_rows(torch.randn(M, K, device=cuda, generator=gen))
    s_out = qt.absmax.reshape(-1) / 127.0
    n = qmm_i8_direct.decode_launches
    y = i8_direct_repeat(x8, qt.packed, s_out, (K, N), reps=2)
    assert qmm_i8_direct.decode_launches == n                  # a timing helper counts nothing
    scale = (s_out * 127.0) / 127.0 if decode else s_out
    epilogue = importlib.import_module("qlora_tpu_torch.ops.qmatmul")._w8a8_epilogue
    ones = torch.ones(M, 1, device=cuda)
    assert torch.equal(y, epilogue(int8_matmul_plain(x8, qt.packed), scale, ones))
    assert (i8_direct_decode_plan(K, N, 132).accepted and M <= DECODE_ROWS) == bool(decode)


def test_i8_direct_decode_dispatch_edge(cuda):
    """16 rows take the decode kernel, 17 qmm_i8_direct.cu; K % 32 != 0 and N
    % 16 != 0 stay on qmm_i8_direct.cu at any row count; every call equals
    its plain version bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(16)
    for M, K, N, decode in ((16, 4096, 256, 1), (17, 4096, 256, 0), (4, 200, 64, 0),
                            (4, 256, 24, 0), (1, 1000, 24, 0), (16, 64, 16, 1)):
        qt = quantize(torch.randn(K, N, device=cuda, generator=gen) * K ** -0.5, block_size=K,
                      quant_type="int8", double_quant=False)
        x = torch.randn(M, K, device=cuda, generator=gen).to(torch.bfloat16)
        n = (qmm_i8_direct.launches, qmm_i8_direct.decode_launches)
        y = qmm_i8_direct(x, qt)
        assert (qmm_i8_direct.launches, qmm_i8_direct.decode_launches) == (n[0] + 1,
                                                                           n[1] + decode)
        assert torch.equal(y, qmm_i8_direct_plain(x, qt)), (M, K, N)


# above DECODE_ROWS rows the w8a8 wgmma kernel (qmm_nf4_w8a8_wgmma.cu) wherever
# w8a8_tile_plan accepts the shape: one past DECODE_ROWS, parity-int8's 128
# rows and serve-paged's 512 on the LLaMA-7B linears, 256-row CTAs, block
# sizes 8 and 32, ragged N and M, K/2 no multiple of the 64-row k-step, three
# meta-blocks of absmax; then shapes it refuses, which stay on
# qmm_i8_direct.cu: block sizes 12 and 4, N % 8 != 0, K = 200
W8A8_WGMMA_CASES = [
    (17, 4096, 4096, 64, "nf4", True), (128, 4096, 11008, 64, "nf4", True),
    (512, 11008, 4096, 64, "nf4", True), (50, 256, 72, 8, "nf4", False),
    (129, 192, 200, 32, "fp4", False), (40, 64 * 600, 96, 64, "nf4", True),
    (33, 480, 50, 12, "fp4", True), (20, 64, 36, 4, "nf4", True),
    (40, 200, 24, 4, "nf4", False), (50, 256, 72, 4, "nf4", False)]


@pytest.mark.parametrize("M,K,N,block_size,quant_type,dq", [
    (1, 256, 64, 64, "nf4", True), (4, 4096, 4096, 64, "nf4", True),
    (37, 384, 200, 64, "nf4", False), (300, 1024, 320, 32, "fp4", True),
    (2048, 11008, 512, 64, "nf4", True), (16, 64 * 600, 96, 64, "nf4", True),
    (5, 200, 24, 4, "nf4", False),                     # K/2 = 100: no 16-byte row chunks
] + W8A8_WGMMA_CASES)
def test_nf4_w8a8_kernel_equals_plain(cuda, M, K, N, block_size, quant_type, dq):
    gen = torch.Generator(device=cuda).manual_seed(M + K + N)
    w = torch.randn(K, N, device=cuda, generator=gen) * K ** -0.5
    qt = quantize(w, block_size=block_size, quant_type=quant_type, double_quant=dq)
    x = torch.randn(M, K, device=cuda, generator=gen).to(torch.bfloat16)
    before, wgmma = qmm_nf4_w8a8.launches, qmm_nf4_w8a8.wgmma_launches
    decode = qmm_nf4_w8a8.decode_launches
    with default_impl("w8a8"):
        y = qmatmul(x, qt)
    assert qmm_nf4_w8a8.launches == before + 1
    took = w8a8_tile_plan(M, K, N, block_size).accepted
    assert took == (M > DECODE_ROWS and K % 32 == 0 and N % 8 == 0 and block_size % 8 == 0)
    assert qmm_nf4_w8a8.wgmma_launches == wgmma + took
    # up to DECODE_ROWS rows of an accepted shape: qmm_nf4_w8a8_decode.cu
    took = M <= DECODE_ROWS and nf4_w8a8_decode_plan(K, N, block_size, 132).accepted
    assert qmm_nf4_w8a8.decode_launches == decode + took
    x8, _ = quantize_rows(x)
    w8 = w8a8_codes(qt, w8a8_scales(qt)[0])
    assert torch.equal(_w8a8_accumulators(x8, qt), int8_matmul_plain(x8, w8).to(torch.int32))
    assert torch.equal(y, qmm_nf4_w8a8_plain(x, qt))
    exact = qmatmul_plain(x, qt).float()
    assert (y.float() - exact).abs().max() < 0.05 * exact.abs().max()


@pytest.mark.parametrize("M,K,N,block_size,quant_type,dq", W8A8_WGMMA_CASES[:6])
def test_nf4_w8a8_wgmma_deterministic_and_batch_invariant(cuda, M, K, N, block_size,
                                                          quant_type, dq):
    """The w8a8 wgmma kernel bit for bit across two calls, and rows in other
    batches (sub-batches of at least 17 rows, which it takes too, and a row
    alone, which the decode kernel or qmm_i8_direct.cu takes) equal to their
    rows of the batch."""
    gen = torch.Generator(device=cuda).manual_seed(M * K + N)
    qt = quantize(torch.randn(K, N, device=cuda, generator=gen) * K ** -0.5,
                  block_size=block_size, quant_type=quant_type, double_quant=dq)
    x = torch.randn(M, K, device=cuda, generator=gen).to(torch.bfloat16)
    y = qmm_nf4_w8a8(x, qt)
    assert torch.equal(qmm_nf4_w8a8(x, qt), y)
    for a, b in ((0, 17), (M - 17, M), (max(0, M // 2 - 9), M // 2 + 9), (M - 1, M)):
        assert torch.equal(qmm_nf4_w8a8(x[a:b], qt), y[a:b]), (a, b)


def test_nf4_w8a8_dispatch_edge(cuda):
    """16 rows take the decode kernel, 17 the wgmma kernel; K = 200 (K % 32
    != 0), N = 36 and blocks of 4 stay on qmm_i8_direct.cu at any row count;
    every call equals its plain version."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    for M, K, N, B, wgmma, decode in ((16, 4096, 256, 64, 0, 1), (17, 4096, 256, 64, 1, 0),
                                      (300, 200, 64, 4, 0, 0), (17, 224, 64, 8, 1, 0),
                                      (40, 256, 36, 8, 0, 0), (40, 256, 64, 4, 0, 0),
                                      (4, 200, 64, 4, 0, 0)):
        qt = quantize(torch.randn(K, N, device=cuda, generator=gen) * K ** -0.5, block_size=B)
        x = torch.randn(M, K, device=cuda, generator=gen).to(torch.bfloat16)
        before = (qmm_nf4_w8a8.wgmma_launches, qmm_nf4_w8a8.decode_launches)
        y = qmm_nf4_w8a8(x, qt)
        assert (qmm_nf4_w8a8.wgmma_launches, qmm_nf4_w8a8.decode_launches) == (
            before[0] + wgmma, before[1] + decode), (M, K)
        assert torch.equal(y, qmm_nf4_w8a8_plain(x, qt))


# qmm_nf4_w8a8_decode.cu: the LLaMA-7B linears (double quant), f32 absmax and
# FP4 at 7B width, blocks of 32 and 128, a ragged strip (N = 144), one k-step
# (K = 64), 16 splits of up to 2016 packed rows (K = 64 * 1000); then shapes it
# refuses, which stay on qmm_i8_direct.cu (N % 16, block size % 32, K % 64)
NF4_W8A8_DECODE_CASES = [(4096, 4096, 64, "nf4", True), (4096, 11008, 64, "nf4", True),
                         (11008, 4096, 64, "nf4", True), (4096, 4096, 64, "nf4", False),
                         (11008, 4096, 64, "fp4", True), (512, 144, 32, "fp4", False),
                         (1024, 256, 128, "nf4", True), (64, 16, 32, "nf4", False),
                         (64 * 1000, 32, 64, "nf4", True)]
_NF4_W8A8_QT: dict = {}


def _nf4_w8a8_qt(cuda, K, N, B, quant_type, dq):
    """A weight of [K, N] (one per case, made once) with a zero column and a
    column whose largest absmax lies in the high plane's last block."""
    key = (K, N, B, quant_type, dq)
    if key not in _NF4_W8A8_QT:
        gen = torch.Generator(device=cuda).manual_seed(K + N + B + dq)
        w = torch.randn(K, N, device=cuda, generator=gen) * K ** -0.5
        w[:, N // 2] = 0
        w[K - 3, 1] = 4.0
        _NF4_W8A8_QT.clear()
        _NF4_W8A8_QT[key] = quantize(w, block_size=B, quant_type=quant_type, double_quant=dq)
    return _NF4_W8A8_QT[key]


@pytest.mark.parametrize("K,N,B,quant_type,dq", NF4_W8A8_DECODE_CASES)
def test_nf4_w8a8_decode_kernel_equals_plain(cuda, K, N, B, quant_type, dq):
    """At 1 to 16 rows the decode kernel took the call, and its x8 and xs
    equal ``quantize_rows``' on the card, its int32 accumulators the exact
    integer product with ``w8a8_codes`` (and qmm_i8_direct.cu's, the
    "before") and its bf16 output ``qmm_nf4_w8a8_plain``'s, bit for bit; a
    row whose largest |x| lies in the high plane, a zero row and a zero
    column included."""
    qt = _nf4_w8a8_qt(cuda, K, N, B, quant_type, dq)
    w8 = w8a8_codes(qt, w8a8_scales(qt)[0])
    gen = torch.Generator(device=cuda).manual_seed(K * 3 + N)
    for M in range(1, DECODE_ROWS + 1):
        x = torch.randn(M, K, device=cuda, generator=gen).to(torch.bfloat16)
        x[0, K // 2 + K // 3:] *= 50                   # row 0's max in the high plane
        if M > 2:
            x[M - 1] = 0
        n = qmm_nf4_w8a8.decode_launches
        y = qmm_nf4_w8a8(x, qt)
        assert qmm_nf4_w8a8.decode_launches == n + 1
        acc, x8, xs = _nf4_w8a8_decode_outputs(x, qt)
        rx8, rxs = quantize_rows(x)
        assert torch.equal(x8, rx8) and torch.equal(xs, rxs), M
        assert torch.equal(acc, int8_matmul_plain(rx8, w8).to(torch.int32)), M
        if M in (1, 9, 16):
            assert torch.equal(_w8a8_accumulators(rx8, qt), acc), M
        assert torch.equal(y, qmm_nf4_w8a8_plain(x, qt)), M
        assert (y[:, N // 2] == 0).all() and (M <= 2 or (y[M - 1] == 0).all())


@pytest.mark.parametrize("K,N,M", [(4096, 4096, 16), (11008, 4096, 5), (4096, 11008, 8),
                                   (512, 144, 9)])
def test_nf4_w8a8_decode_deterministic_and_batch_invariant(cuda, K, N, M):
    """The decode kernel bit for bit across two calls, with each row alone
    and with the rows in other batches (8 and 9 rows: one and two B tiles);
    the rows of another run's codes (``given``) give that run's output."""
    qm = importlib.import_module("qlora_tpu_torch.ops.qmatmul")
    qt = _nf4_w8a8_qt(cuda, K, N, 32 if K == 512 else 64, "nf4", True)
    gen = torch.Generator(device=cuda).manual_seed(M + K)
    x = torch.randn(M, K, device=cuda, generator=gen).to(torch.bfloat16)
    y = qmm_nf4_w8a8(x, qt)
    assert torch.equal(qmm_nf4_w8a8(x, qt), y)
    for m in range(M):
        assert torch.equal(qmm_nf4_w8a8(x[m:m + 1], qt), y[m:m + 1]), m
    for a, b in ((0, min(M, 9)), (max(0, M - 8), M)):
        assert torch.equal(qmm_nf4_w8a8(x[a:b], qt), y[a:b]), (a, b)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = nf4_w8a8_decode_plan(K, N, qt.block_size, sms)
    x8, xs = quantize_rows(x)
    assert torch.equal(qm._nf4_w8a8_decode_launch(torch.zeros_like(x), qt, plan,
                                                  rows=(x8, xs)), y)


def test_nf4_w8a8_decode_dispatch_edge(cuda):
    """1 and 16 rows take the decode kernel at every LLaMA-7B linear's shape,
    17 the wgmma kernel; N % 16 != 0, blocks of 16 and K % 64 != 0 stay on
    qmm_i8_direct.cu; every call equals its plain version bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(14)
    for M, K, N, B, decode in ((16, 4096, 256, 64, 1), (17, 4096, 256, 64, 0),
                               (1, 11008, 128, 64, 1), (4, 256, 72, 64, 0),
                               (4, 4096, 64, 16, 0), (4, 224, 64, 16, 0), (16, 64, 16, 32, 1)):
        qt = quantize(torch.randn(K, N, device=cuda, generator=gen) * K ** -0.5, block_size=B)
        x = torch.randn(M, K, device=cuda, generator=gen).to(torch.bfloat16)
        n = (qmm_nf4_w8a8.launches, qmm_nf4_w8a8.decode_launches)
        y = qmm_nf4_w8a8(x, qt)
        assert (qmm_nf4_w8a8.launches, qmm_nf4_w8a8.decode_launches) == (n[0] + 1,
                                                                         n[1] + decode)
        assert torch.equal(y, qmm_nf4_w8a8_plain(x, qt)), (M, K, N, B)
    with pytest.raises(ValueError, match="does not take"):
        _nf4_w8a8_decode_outputs(torch.zeros(17, 256, device=cuda), quantize(
            torch.randn(256, 64, device=cuda)))


def test_debug_model_nf4_w8a8_decode_card_matches_cpu(cuda):
    """``PagedBatcher(decode_impl="w8a8")`` on the card takes every decode
    forward's 7 block linears a layer on the decode kernel; one decode step
    of the debug model under ``default_impl("w8a8")``, teacher-forced, gives
    the CPU's plain path's logits within atol 0.2 (as the int8 decode step)."""
    from qlora_tpu_torch.generate.paged import PagedBatcher
    from qlora_tpu_torch.models import init_cache

    cfg = get_config("debug")
    p_cpu = init_params(cfg, seed=0, device="cpu")
    p_gpu = move_to(p_cpu, cuda)
    pb = PagedBatcher(p_gpu, None, cfg, num_slots=2, n_pages=32, page_size=8,
                      max_pages_per_seq=8, prefill_buckets=(16,), eos_id=-1, decode_impl="w8a8")
    n0 = (qmm_nf4_w8a8.launches, qmm_nf4_w8a8.decode_launches)
    reqs = [pb.submit(p, max_new_tokens=n) for p, n in (([3, 17, 5, 9], 6), ([4, 7], 5))]
    pb.run_to_completion()
    assert [len(r.generated) for r in reqs] == [6, 5]
    grown = qmm_nf4_w8a8.launches - n0[0]              # the decode forwards (prefill: exact)
    assert grown > 0 and grown % (7 * cfg.num_layers) == 0
    assert qmm_nf4_w8a8.decode_launches - n0[1] == grown
    ids = torch.tensor([[3, 17, 5, 9], [4, 7, 0, 0]])
    with torch.inference_mode():
        c_cpu, c_gpu = init_cache(cfg, 2, 8, device="cpu"), init_cache(cfg, 2, 8, device=cuda)
        _, c_cpu = forward(p_cpu, None, ids, cfg, cache=c_cpu)
        _, c_gpu = forward(p_gpu, None, ids.to(cuda), cfg, cache=c_gpu)
        tok = torch.tensor([[5], [9]])
        with default_impl("w8a8"):
            want, _ = forward(p_cpu, None, tok, cfg, cache=c_cpu)
            got, _ = forward(p_gpu, None, tok.to(cuda), cfg, cache=c_gpu)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0.2)


def test_w8a8_kernels_round_half_to_even(cuda):
    """Weights and activations built so that most codes land exactly on a
    half: rounding half away from zero (``roundf``) would move them all."""
    K, N = 256, 64
    # NF4: code 1.0 (index 15) everywhere, absmax chosen so that code * ratio = k + 0.5
    packed = torch.full((K // 2, N), 0xFF, dtype=torch.uint8, device=cuda)
    halves = (torch.arange(K // 64 * N, device=cuda).reshape(K // 64, N) % 120 + 0.5)
    absmax = halves.float()
    absmax[0, :] = 127.0                               # the column's maximum: ratio = absmax
    from qlora_tpu_torch.quant import QuantizedTensor
    qt = QuantizedTensor(packed, absmax, None, None, (K, N), 64, "nf4")
    ratio, _ = w8a8_scales(qt)
    assert torch.equal(ratio, absmax)
    w8 = w8a8_codes(qt, ratio)
    assert (w8[64:].float() % 2 == 0).all()            # every half went to the even side
    x = torch.zeros(3, K, device=cuda)
    x[:, 0] = 127.0                                    # xs = 1: x8 = round(x)
    x[0, 1:8] = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5], device=cuda)
    x[1, 64:] = 1.0
    x8, xs = quantize_rows(x)
    assert x8[0, 1:8].tolist() == [0, 2, 2, 0, -2, -2, 4] and (xs == 1).all()
    got = _w8a8_accumulators(x8, qt)
    assert torch.equal(got, int8_matmul_plain(x8, w8).to(torch.int32))
    away = torch.floor(halves[1:] + 0.5).repeat_interleave(64, 0)     # what roundf would give
    assert (away != w8[64:].float()).float().mean() > 0.4


# more than DECODE_ROWS rows of int8 storage (qmm_i8_wgmma.cu, forward and
# dx), beside the cases above: one CTA's 128 rows and ragged edges of it,
# 256-row CTAs (1024 and 2048 rows), ragged N and K, block sizes 2, 4, 8, 12,
# 32 and 64, contractions that are no multiple of the 64-row k-step, two
# meta-blocks of absmax; N = 50 sends the backward, and K = 36 the forward,
# to qmm_i8.cu (a row stride TMA cannot take)
I8_WGMMA_CASES = [(M, 4096, 4096, 64) for M in (17, 40, 128)] + [
    (300, 1024, 72, 32), (2048, 4096, 11008, 64), (1024, 11008, 4096, 64), (50, 256, 72, 4),
    (33, 480, 56, 12), (129, 192, 200, 32), (20, 64, 40, 2), (40, 64 * 260, 96, 64),
    (300, 200, 64, 8), (33, 480, 50, 12), (20, 36, 40, 4)]


# decode rows (the int8 decode kernel): LLaMA-7B's up projection, ragged N
# (byte loads), block 256, block sizes that are no multiple of the 16-row
# k-step (4, 8, 24: each element's own absmax), three meta-blocks of absmax
# (64 * 600), K % 16 != 0 (K = 36: x staged element by element), splits
# longer than the 4096 rows staged at once (64 * 1100)
I8_DECODE_CASES = [(M, K, N, B) for M in (1, 3, 8, 9, 16) for K, N, B in (
    (4096, 11008, 64), (384, 200, 64), (2048, 320, 256), (64 * 600, 96, 64))] + [
    (5, 256, 72, 4), (16, 480, 50, 24), (2, 36, 40, 4), (12, 192, 136, 8),
    (4, 64 * 1100, 32, 64), (7, 11008, 4096, 64)]


@pytest.mark.parametrize("M,K,N,block_size", [
    (1, 256, 64, 64), (4, 4096, 4096, 64), (37, 384, 200, 64), (5, 192, 200, 64),
    (300, 1024, 320, 32), (1024, 11008, 512, 64), (16, 64 * 600, 96, 64),
] + I8_WGMMA_CASES + I8_DECODE_CASES)
@pytest.mark.parametrize("double_quant", [True, False])
def test_i8_fwd_and_bwd_kernels_match_plain(cuda, M, K, N, block_size, double_quant):
    """The forward and dx through ``qmatmul`` and autograd: the forward takes
    the decode kernel up to DECODE_ROWS rows (counted in ``decode_launches``),
    each takes the wgmma kernel exactly where ``i8_tile_plan`` accepts the
    shape, else ``qmm_i8.cu``, and agrees with its plain version."""
    gen = torch.Generator(device=cuda).manual_seed(M + K + N)
    w = torch.randn(K, N, device=cuda, generator=gen) * K ** -0.5
    qt = quantize(w, block_size=block_size, quant_type="int8", double_quant=double_quant)
    x = torch.randn(M, K, device=cuda, generator=gen).to(torch.bfloat16).requires_grad_()
    g = torch.randn(M, N, device=cuda, generator=gen).to(torch.bfloat16)
    took = [i8_tile_plan(M, K, N, block_size, bwd).accepted for bwd in (False, True)]
    assert took == [M > DECODE_ROWS and K % 8 == 0, M > DECODE_ROWS and N % 8 == 0]
    n0 = (qmm_i8_fwd.launches, qmm_i8_bwd.launches, qmm_nf4_fwd_dq.launches,
          qmm_nf4_bwd.launches, qmm_i8_fwd.wgmma_launches, qmm_i8_bwd.wgmma_launches,
          qmm_i8_fwd.decode_launches)
    y = qmatmul(x, qt)
    y.backward(g)
    assert (qmm_i8_fwd.launches, qmm_i8_bwd.launches, qmm_nf4_fwd_dq.launches,
            qmm_nf4_bwd.launches, qmm_i8_fwd.wgmma_launches, qmm_i8_bwd.wgmma_launches,
            qmm_i8_fwd.decode_launches) == (
        n0[0] + 1, n0[1] + 1, n0[2], n0[3], n0[4] + took[0], n0[5] + took[1],
        n0[6] + (M <= DECODE_ROWS))
    torch.testing.assert_close(y.detach().float(), qmm_i8_fwd_plain(x.detach(), qt).float(),
                               rtol=1e-2, atol=2e-2)
    assert x.grad.dtype == torch.bfloat16 and x.grad.shape == (M, K)
    torch.testing.assert_close(x.grad.float(), qmm_i8_bwd_plain(g, qt).float(),
                               rtol=1e-2, atol=2e-2)


def test_i8_kernels_read_out_the_decoded_weight(cuda):
    """Identity operands read the decoded weight out of the forward and the
    backward kernel: ``dequantize``, bit for bit, with int8 and f32 absmax."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    for dq in (True, False):
        for K, N in ((64 * 260, 64), (256, 192), (192, 200)):
            qt = quantize(torch.randn(K, N, device=cuda, generator=gen), quant_type="int8",
                          double_quant=dq)
            w = dequantize(qt, torch.bfloat16)
            assert torch.equal(qmm_i8_bwd(torch.eye(N, device=cuda, dtype=torch.bfloat16), qt),
                               w.T.contiguous())
            if K <= 256:
                assert torch.equal(qmm_i8_fwd(torch.eye(K, device=cuda, dtype=torch.bfloat16),
                                              qt), w)


def _i8_case(cuda, M, K, N, block_size, double_quant):
    gen = torch.Generator(device=cuda).manual_seed(M + K + N + block_size)
    w = torch.randn(K, N, device=cuda, generator=gen) * K ** -0.5
    qt = quantize(w, block_size=block_size, quant_type="int8", double_quant=double_quant)
    x = torch.randn(M, K, device=cuda, generator=gen).to(torch.bfloat16)
    g = torch.randn(M, N, device=cuda, generator=gen).to(torch.bfloat16)
    return qt, x, g


I8_EXACT = [(4096, 11008, 64), (11008, 4096, 64), (64 * 260, 64, 64), (192, 200, 64),
            (480, 56, 12), (256, 72, 4)]


@pytest.mark.parametrize("K,N,block_size", I8_EXACT)
@pytest.mark.parametrize("double_quant", [True, False])
def test_i8_wgmma_identity_reads_out_the_weight(cuda, K, N, block_size, double_quant):
    """Rows of the identity read ``dequantize``'s bf16 weight out of the
    wgmma kernel bit for bit: forward 40 rows of W (both sides of
    absmax-block and, at 64 * 260, meta-block edges), backward 40 columns of
    W as rows of dx.  It decodes the same weight, and f32 sums of one
    product and zeros are exact."""
    qt, _, _ = _i8_case(cuda, 40, K, N, block_size, double_quant)
    w = dequantize(qt, torch.bfloat16)
    ks = one_hot_rows(K, block_size, 40)
    x = torch.zeros(len(ks), K, device=cuda, dtype=torch.bfloat16)
    x[torch.arange(len(ks)), torch.tensor(ks)] = 1
    cs = one_hot_cols(N, 40)
    g = torch.zeros(len(cs), N, device=cuda, dtype=torch.bfloat16)
    g[torch.arange(len(cs)), torch.tensor(cs)] = 1
    before = qmm_i8_fwd.wgmma_launches, qmm_i8_bwd.wgmma_launches
    y, dx = qmm_i8_fwd(x, qt), qmm_i8_bwd(g, qt)
    assert (qmm_i8_fwd.wgmma_launches, qmm_i8_bwd.wgmma_launches) == (before[0] + 1,
                                                                      before[1] + 1)
    assert torch.equal(y, w[ks])
    assert torch.equal(dx, w[:, cs].T.contiguous())


@pytest.mark.parametrize("K,N,block_size", I8_EXACT[:4])
@pytest.mark.parametrize("double_quant", [True, False])
def test_i8_wgmma_deterministic_and_batch_invariant(cuda, K, N, block_size, double_quant):
    """Two calls give the same bits, and a row gives the same bits in a batch
    of 2048 (256-row CTAs at the LLaMA shapes), of 300, of 40 and of 17, in
    the forward and in dx: every output element is one CTA's sum over the
    contraction in a fixed order, whatever the other rows."""
    qt, x, g = _i8_case(cuda, 2048, K, N, block_size, double_quant)
    for wrapper, a in ((qmm_i8_fwd, x), (qmm_i8_bwd, g)):
        y = wrapper(a, qt)
        assert torch.equal(y, wrapper(a, qt))
        for lo, M in ((0, 17), (1000, 40), (130, 300), (2048 - 17, 17)):
            assert torch.equal(wrapper(a[lo:lo + M], qt), y[lo:lo + M]), (wrapper, lo, M)


@pytest.mark.parametrize("double_quant", [True, False])
def test_i8_wgmma_dispatch_edge(cuda, double_quant):
    """DECODE_ROWS rows take the decode kernel forward and qmm_i8.cu
    backward, one more the wgmma kernel, in both directions; a contraction
    whose row stride TMA cannot take (K % 8 != 0 forward, N % 8 != 0
    backward) above DECODE_ROWS rows takes qmm_i8.cu, and the other
    direction of the same weight the wgmma kernel."""
    cases = [(1024, 320, 64, DECODE_ROWS, False, 0), (1024, 320, 64, DECODE_ROWS + 1, False, 1),
             (1024, 320, 64, DECODE_ROWS, True, 0), (1024, 320, 64, DECODE_ROWS + 1, True, 1),
             (36, 40, 4, 20, False, 0), (36, 40, 4, 20, True, 1),
             (480, 50, 12, 20, True, 0), (480, 50, 12, 20, False, 1)]
    for K, N, B, M, bwd, took in cases:
        qt, x, g = _i8_case(cuda, M, K, N, B, double_quant)
        wrapper, plain, a = (qmm_i8_bwd, qmm_i8_bwd_plain, g) if bwd else (
            qmm_i8_fwd, qmm_i8_fwd_plain, x)
        before = wrapper.launches, wrapper.wgmma_launches, qmm_i8_fwd.decode_launches
        y = wrapper(a, qt)
        assert (wrapper.launches, wrapper.wgmma_launches) == (before[0] + 1, before[1] + took), (
            K, N, M, bwd)
        assert qmm_i8_fwd.decode_launches == before[2] + (not bwd and M <= DECODE_ROWS)
        torch.testing.assert_close(y.float(), plain(a, qt).float(), rtol=1e-2, atol=2e-2)


I8_DECODE_EXACT = [(4096, 11008, 64), (64 * 260, 64, 64), (2048, 320, 256), (384, 200, 64),
                   (480, 56, 24), (256, 72, 4), (36, 40, 4)]


@pytest.mark.parametrize("K,N,block_size", I8_DECODE_EXACT)
@pytest.mark.parametrize("double_quant", [True, False])
def test_i8_decode_identity_reads_out_the_weight(cuda, K, N, block_size, double_quant):
    """16 rows of the identity (both sides of absmax-block and, at 64 * 260,
    meta-block edges) read ``dequantize``'s bf16 weight out of the decode
    kernel bit for bit: it decodes the same weight, and its f32 sums of one
    product and zeros are exact."""
    qt, _, _ = _i8_case(cuda, 16, K, N, block_size, double_quant)
    ks = one_hot_rows(K, block_size, 16)
    x = torch.zeros(len(ks), K, device=cuda, dtype=torch.bfloat16)
    x[torch.arange(len(ks)), torch.tensor(ks)] = 1
    before = qmm_i8_fwd.decode_launches
    y = qmm_i8_fwd(x, qt)
    assert qmm_i8_fwd.decode_launches == before + 1
    assert torch.equal(y, dequantize(qt, torch.bfloat16)[ks])


@pytest.mark.parametrize("K,N,block_size", I8_DECODE_EXACT[:4] + [(11008, 4096, 64)])
@pytest.mark.parametrize("double_quant", [True, False])
def test_i8_decode_deterministic_and_batch_invariant(cuda, K, N, block_size, double_quant):
    """Two calls give the same bits, and each row alone, and the first 3 and
    8 rows, give their rows of the 16-row batch bit for bit: the split plan
    and the order of the sums do not depend on M."""
    qt, x, _ = _i8_case(cuda, 16, K, N, block_size, double_quant)
    y = qmm_i8_fwd(x, qt)
    assert torch.equal(y, qmm_i8_fwd(x, qt))
    for i in range(x.shape[0]):
        assert torch.equal(qmm_i8_fwd(x[i:i + 1], qt)[0], y[i]), i
    for M in (3, 8):
        assert torch.equal(qmm_i8_fwd(x[:M], qt), y[:M]), M


@pytest.mark.parametrize("double_quant", [True, False])
def test_i8_decode_dispatch_edge(cuda, double_quant):
    """DECODE_ROWS rows take the decode kernel, one more the wgmma kernel;
    the dx at DECODE_ROWS rows takes qmm_i8.cu, counted in neither."""
    qt, x, g = _i8_case(cuda, DECODE_ROWS + 1, 1024, 320, 64, double_quant)
    for M, bwd, took in ((DECODE_ROWS, False, "decode"), (DECODE_ROWS + 1, False, "wgmma"),
                         (DECODE_ROWS, True, "tile")):
        wrapper, plain, a = (qmm_i8_bwd, qmm_i8_bwd_plain, g) if bwd else (
            qmm_i8_fwd, qmm_i8_fwd_plain, x)
        before = (wrapper.launches, qmm_i8_fwd.decode_launches, wrapper.wgmma_launches)
        y = wrapper(a[:M], qt)
        assert (wrapper.launches, qmm_i8_fwd.decode_launches, wrapper.wgmma_launches) == (
            before[0] + 1, before[1] + (took == "decode"), before[2] + (took == "wgmma")), M
        torch.testing.assert_close(y.float(), plain(a[:M], qt).float(), rtol=1e-2, atol=2e-2)


def test_i8_no_backward_launch_without_input_grad(cuda):
    qt = quantize(torch.randn(256, 64, device=cuda), quant_type="int8")
    x = torch.randn(8, 256, device=cuda).to(torch.bfloat16)
    before = qmm_i8_bwd.launches
    y = qmatmul(x, qt)
    assert not y.requires_grad and qmm_i8_bwd.launches == before
    xg = x.clone().requires_grad_()
    with default_impl("w8a8"):                         # the backward under w8a8 is exact
        qmatmul(xg, quantize(torch.randn(256, 64, device=cuda))).float().sum().backward()
    assert qmm_i8_bwd.launches == before and xg.grad is not None


def test_debug_model_int8_decode_card_matches_cpu(cuda):
    """``generate(decode_impl="int8")`` on the card: 7 block linears per layer
    and the lm_head through ``qmm_i8_direct`` each step, none through the NF4
    kernel; one teacher-forced step's logits against the CPU's plain path
    within atol 0.2 (see tests/test_torch_generate.py)."""
    cfg = get_config("debug")
    p_cpu = init_params(cfg, seed=0, device="cpu")
    p_gpu = move_to(p_cpu, cuda)
    dec_cpu = requantize_params_int8_unstacked(p_cpu)
    dec_gpu = requantize_params_int8_unstacked(p_gpu)
    assert torch.equal(dec_gpu["blocks"][1]["w_up"].qt.packed.cpu(),
                       dec_cpu["blocks"][1]["w_up"].qt.packed)
    ids = torch.tensor([[3, 17, 5, 9], [4, 7, 0, 0]])
    lengths = torch.tensor([4, 2])
    n0 = (qmm_i8_direct.launches, qmm_nf4_fwd_dq.launches)
    toks = generate(p_gpu, None, ids, lengths, cfg, max_new_tokens=4, eos_id=-1,
                    decode_impl="int8", decode_params=dec_gpu)
    assert toks.shape == (2, 4) and toks.is_cuda
    assert qmm_i8_direct.launches == n0[0] + 4 * (7 * cfg.num_layers + 1)
    assert qmm_nf4_fwd_dq.launches == n0[1] + 7 * cfg.num_layers          # the prefill only
    from qlora_tpu_torch.models import init_cache
    with torch.inference_mode():
        c_cpu, c_gpu = init_cache(cfg, 2, 8, device="cpu"), init_cache(cfg, 2, 8, device=cuda)
        _, c_cpu = forward(p_cpu, None, ids, cfg, cache=c_cpu)
        _, c_gpu = forward(p_gpu, None, ids.to(cuda), cfg, cache=c_gpu)
        tok = torch.tensor([[5], [9]])
        with default_impl("w8a8"):
            want, _ = forward(dec_cpu, None, tok, cfg, cache=c_cpu)
            got, _ = forward(dec_gpu, None, tok.to(cuda), cfg, cache=c_gpu)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0.2)


PAGED_CASES = [  # B, C (None: decode), H, KVH, hd, page, pps, lens, window, evict, planted
    (8, None, 32, 32, 128, 64, 16, [0, 1, 63, 64, 65, 300, 511, 1022], None, False, False),
    (8, None, 32, 8, 128, 64, 16, [0, 1, 63, 64, 65, 300, 511, 1022], 256, True, True),
    (3, None, 8, 2, 64, 16, 4, [0, 63, 37], 20, False, True),
    (2, None, 64, 2, 256, 8, 3, [24, 27], None, False, False),     # G = 32; the append clamped
    (3, None, 4, 4, 128, 8, 4, [5, 17, 30], 4, True, False),
    (8, 5, 32, 32, 128, 64, 16, [0, 1, 63, 64, 65, 300, 510, 1019], None, False, False),
    (8, 5, 32, 8, 128, 64, 16, [0, 1, 63, 64, 65, 300, 510, 1019], 256, True, True),
    (3, 8, 4, 2, 128, 16, 4, [13, 29, 47], None, False, False),    # straddles two pages
    (2, 5, 8, 2, 64, 8, 2, [13, 3], None, False, False),           # clamped: later position wins
    (2, 16, 8, 2, 64, 16, 4, [7, 40], 12, False, True),            # C * G = 64
]


@pytest.mark.parametrize("B,C,H,KVH,hd,page,pps,lens,window,evict,planted", PAGED_CASES)
def test_paged_kernels_match_plain(cuda, B, C, H, KVH, hd, page, pps, lens, window, evict,
                                   planted):
    g = torch.Generator(device=cuda).manual_seed(B * 100 + page + (C or 0))
    q, nk, nv, kp, vp, L, tables = paged_case(g, cuda, B, C, H, KVH, hd, page, pps, lens,
                                              window, evict, planted)
    kernel, plain = ((paged_decode_attention_cuda, paged_decode_plain) if C is None
                     else (paged_chunk_attention_cuda, paged_chunk_plain))
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    before = kernel.launches
    split = kernel.split_launches
    o1, _, _ = kernel(q, nk, nv, k1, v1, L, tables, sm_scale=hd ** -0.5, sliding_window=window)
    o2, _, _ = plain(q, nk, nv, k2, v2, L, tables, sm_scale=hd ** -0.5, sliding_window=window)
    assert kernel.launches == before + 1
    # the decode step and every chunk run the split kernel of paged_attention_split.cu
    assert kernel.split_launches == split + 1
    d = (o1.float() - o2.float()).abs()
    tol = 2e-2 * o2.float().abs().amax(-1, keepdim=True)
    assert (d <= tol).all(), f"max excess {(d - tol).max().item()}"
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    assert not torch.equal(k1, kp)                      # the append happened


PAGED_CHUNK_CASES = [c for c in PAGED_CASES if c[1] is not None]
PAGED_DECODE_CASES = [c for c in PAGED_CASES if c[1] is None]


@pytest.mark.parametrize("B,C,H,KVH,hd,page,pps,lens,window,evict,planted", PAGED_DECODE_CASES)
def test_paged_decode_split_deterministic_and_row_invariant(cuda, B, C, H, KVH, hd, page, pps,
                                                            lens, window, evict, planted):
    """The decode step on the split kernel bit for bit across two calls and
    with each row alone, outputs and pools, each call from fresh pools."""
    g = torch.Generator(device=cuda).manual_seed(B * 10 + page)
    q, nk, nv, kp, vp, L, tables = paged_case(g, cuda, B, C, H, KVH, hd, page, pps, lens,
                                              window, evict, planted)
    kw = dict(sm_scale=hd ** -0.5, sliding_window=window)
    runs = [paged_decode_attention_cuda(q, nk, nv, kp.clone(), vp.clone(), L, tables, **kw)
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    o = runs[0][0]
    for b in range(B):
        ob, _, _ = paged_decode_attention_cuda(q[b:b + 1], nk[b:b + 1], nv[b:b + 1], kp.clone(),
                                               vp.clone(), L[b:b + 1], tables[b:b + 1], **kw)
        assert torch.equal(ob[0], o[b]), b


@pytest.mark.parametrize("B,C,H,KVH,hd,page,pps,lens,window,evict,planted", PAGED_DECODE_CASES)
def test_paged_decode_before_still_matches_plain(cuda, B, C, H, KVH, hd, page, pps, lens,
                                                 window, evict, planted):
    """paged_attention.cu's decode entry, the split kernel's "before" at the
    decode step (reached through the private ``_paged_decode_before``),
    within the same tolerance of the plain version, the same pools after the
    append; not counted."""
    before = importlib.import_module("qlora_tpu_torch.ops.paged_attention")._paged_decode_before
    g = torch.Generator(device=cuda).manual_seed(B * 100 + page)
    q, nk, nv, kp, vp, L, tables = paged_case(g, cuda, B, C, H, KVH, hd, page, pps, lens,
                                              window, evict, planted)
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    n = (paged_decode_attention_cuda.launches, paged_decode_attention_cuda.split_launches)
    o1, _, _ = before(q, nk, nv, k1, v1, L, tables, sm_scale=hd ** -0.5, sliding_window=window)
    o2, _, _ = paged_decode_plain(q, nk, nv, k2, v2, L, tables, sm_scale=hd ** -0.5,
                                  sliding_window=window)
    assert (paged_decode_attention_cuda.launches,
            paged_decode_attention_cuda.split_launches) == n
    d = (o1.float() - o2.float()).abs()
    tol = 2e-2 * o2.float().abs().amax(-1, keepdim=True)
    assert (d <= tol).all(), f"max excess {(d - tol).max().item()}"
    assert torch.equal(k1, k2) and torch.equal(v1, v2)


@pytest.mark.parametrize("B,C,H,KVH,hd,page,pps,lens,window,evict,planted", PAGED_CHUNK_CASES)
def test_paged_chunk_split_deterministic_and_row_invariant(cuda, B, C, H, KVH, hd, page, pps,
                                                           lens, window, evict, planted):
    """The split chunk kernel bit for bit across two calls and with each row
    alone, outputs and pools; every call starts from the pools as they were
    (a clamped append may overwrite keys that a later call would read)."""
    g = torch.Generator(device=cuda).manual_seed(B * 10 + page + C)
    q, nk, nv, kp, vp, L, tables = paged_case(g, cuda, B, C, H, KVH, hd, page, pps, lens,
                                              window, evict, planted)
    kw = dict(sm_scale=hd ** -0.5, sliding_window=window)
    runs = [paged_chunk_attention_cuda(q, nk, nv, kp.clone(), vp.clone(), L, tables, **kw)
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    o = runs[0][0]
    for b in range(B):
        ob, _, _ = paged_chunk_attention_cuda(q[b:b + 1], nk[b:b + 1], nv[b:b + 1], kp.clone(),
                                              vp.clone(), L[b:b + 1], tables[b:b + 1], **kw)
        assert torch.equal(ob[0], o[b]), b


@pytest.mark.parametrize("B,C,H,KVH,hd,page,pps,lens,window,evict,planted", PAGED_CHUNK_CASES)
def test_paged_chunk_before_still_matches_plain(cuda, B, C, H, KVH, hd, page, pps, lens, window,
                                                evict, planted):
    """paged_attention.cu's chunk entry, the split kernel's "before" (reached
    through the private ``_paged_chunk_before``), within the same tolerance
    of the plain version, the same pools after the append; not counted."""
    before = importlib.import_module("qlora_tpu_torch.ops.paged_attention")._paged_chunk_before
    g = torch.Generator(device=cuda).manual_seed(B * 100 + page + C)
    q, nk, nv, kp, vp, L, tables = paged_case(g, cuda, B, C, H, KVH, hd, page, pps, lens,
                                              window, evict, planted)
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    n = paged_chunk_attention_cuda.launches
    o1, _, _ = before(q, nk, nv, k1, v1, L, tables, sm_scale=hd ** -0.5, sliding_window=window)
    o2, _, _ = paged_chunk_plain(q, nk, nv, k2, v2, L, tables, sm_scale=hd ** -0.5,
                                 sliding_window=window)
    assert paged_chunk_attention_cuda.launches == n
    d = (o1.float() - o2.float()).abs()
    tol = 2e-2 * o2.float().abs().amax(-1, keepdim=True)
    assert (d <= tol).all(), f"max excess {(d - tol).max().item()}"
    assert torch.equal(k1, k2) and torch.equal(v1, v2)


def test_paged_chunk_of_one_is_the_decode_kernel(cuda):
    g = torch.Generator(device=cuda).manual_seed(5)
    q, nk, nv, kp, vp, L, tables = paged_case(g, cuda, 4, None, 8, 2, 128, 16, 4,
                                              [0, 5, 37, 63], 24, True, True)
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    oc, _, _ = paged_chunk_attention_cuda(q[:, None], nk[:, None], nv[:, None], k1, v1, L,
                                          tables, sm_scale=0.1, sliding_window=24)
    od, _, _ = paged_decode_attention_cuda(q, nk, nv, k2, v2, L, tables, sm_scale=0.1,
                                           sliding_window=24)
    assert torch.equal(oc[:, 0], od) and torch.equal(k1, k2) and torch.equal(v1, v2)


def test_paged_batcher_on_card(cuda):
    """The debug model through ``PagedBatcher`` on the card, plain and
    speculative: every request completes, the pool is recycled, and the
    decode and verify steps launch the paged kernels, one per layer."""
    from qlora_tpu_torch.generate.paged import PagedBatcher

    cfg = get_config("debug")
    params = init_params(cfg, seed=0, device=cuda)
    traffic = [([3, 17, 5, 9] * 3, 6), ([4, 7], 9), ([11, 2, 6, 11, 2, 6], 7)]
    for spec in (0, 3):
        pb = PagedBatcher(params, None, cfg, num_slots=2, n_pages=32, page_size=8,
                          max_pages_per_seq=8, prefill_buckets=(16,), eos_id=-1,
                          spec_draft_len=spec)
        n0 = (paged_decode_attention_cuda.launches, paged_chunk_attention_cuda.launches)
        reqs = [pb.submit(p, max_new_tokens=n) for p, n in traffic]
        pb.run_to_completion()
        assert [len(r.generated) for r in reqs] == [n for _, n in traffic]
        assert pb.pool.n_free == 31 and not pb.pool.tables
        grown = (paged_decode_attention_cuda.launches - n0[0],
                 paged_chunk_attention_cuda.launches - n0[1])
        assert grown[1 if spec else 0] > 0 and grown[1 if spec else 0] % cfg.num_layers == 0
        if not spec:
            assert grown[1] == 0
