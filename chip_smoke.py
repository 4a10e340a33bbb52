#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (qlora_tpu_torch) on one H100.

Run from the root of a checkout:  python3 chip_smoke.py

It needs one CUDA device and ``nvcc`` (it builds the kernels from
``qlora_tpu_torch/csrc``), and exits nonzero, printing no result, without
them.  Phases, each failing the run on any mismatch or exception:

1. build: the card's name and power limit, then every kernel built for sm_90a.
2. kernels: each CUDA kernel against its plain PyTorch version on the card
   at the LLaMA-7B serving and training shapes, with its time (CUDA events),
   the plain version's time, one PyTorch library call's time as a yardstick,
   and the least time the card could take (bytes over 3.35 TB/s or
   operations over the peak rate of their type).  The NF4 forward at
   decode rows (4, 8, 16 and 40) is timed in CUDA graphs beside the tile
   kernel's M <= 16 branch (the "before") and, at 40, the decode kernel;
   up to 16 rows the decode kernel is also held bit for bit: two calls
   equal, each row alone equal to its row in the batch, rows of the
   identity equal to ``dequantize``'s weight.  Above 16 rows (40, 1024,
   2048) the wrapper runs the wgmma kernel, timed beside the tile kernel of
   ``qmm_nf4_fwd.cu`` through its C entry (``tile_ms``, the "before", also
   held to QMM_TOL) and held bit for bit the same way (sub-batches of at
   least 17 rows, which the wgmma kernel takes too).
3. parity: LLaMA-7B width, 2 layers — the same weights through the plain
   path on the CPU and through the kernels on the card, a 128-token prefill
   then 4 teacher-forced decode steps; logits must agree.
4. serve: LLaMA-7B at full width and depth (32 layers), random NF4 weights
   (double quant) and a rank-64 LoRA with nonzero B, ``generate()`` greedy
   on 4 requests (true lengths 512/384/200/97, right-padded to 512), 64 new
   tokens each; launch counts read around the call.
5. nodq: a 2-layer full-width model with f32 absmax generates 16 tokens, so
   the f32-absmax qmm variant runs on a generate path.
6. train-parity: LLaMA-7B width, 2 layers — one collated micro-batch with
   unequal lengths through the plain path on the CPU and through the kernels
   on the card; the loss and every LoRA gradient must agree.
7. train: LLaMA-7B at full width and depth, random NF4 weights and a fresh
   rank-64 LoRA; ``make_train_step`` (2 micro-batches of 2 x 512 collated
   tokens, remat "full", ``paged_adamw_32bit``) takes 5 optimizer steps on
   one batch: finite losses, no movement on the first step (its learning
   rate is 0), a lower loss at the end, frozen tensors byte-identical, and
   exact launch counts read around the steps.
8. kernels-int8: the four kernels of the int8 family against their plain
   versions: ``qmm_i8_direct`` (M = 4, the block linears and the padded
   lm_head, and a ragged shape) and ``qmm_nf4_w8a8`` (M = 4, 128 and 2048) equal
   bit for bit, in the raw int32 accumulators and in the bf16 output;
   ``qmm_i8_fwd`` (M = 4, 1024, 2048) and ``qmm_i8_bwd`` (M = 1024) within
   the NF4 kernels' tolerance, f32 and double-quantized absmax, and reading
   out ``dequantize``'s weight bit for bit from identity operands.  Above 16
   rows the wrappers run the wgmma kernel of ``qmm_i8_wgmma.cu``, timed
   beside the tile kernel of ``qmm_i8.cu`` through its C entry (``tile_ms``,
   the "before", also held to QMM_TOL) and held bit for bit as the NF4 wgmma
   kernel (two calls, sub-batches of at least 17 rows, identity rows).
9. parity-int8: LLaMA-7B width, 2 layers, the CPU's plain path against the
   card, at three seeds: 4 teacher-forced decode steps on the int8 serving
   tree and a 128-token prefill of the NF4 params, both under
   ``default_impl("w8a8")``; logits agree, agree as closely as the exact
   path's once the card multiplies the CPU's int8 row codes, and stay within
   a band of the exact path's without being equal to them.
10. serve-int8 (inside serve, on its weights): the same 4 requests through
   ``generate(..., decode_impl="int8")`` on a serving tree requantized once;
   exact launch counts (the prefill on the NF4 kernel, every decode step on
   ``qmm_i8_direct``, the lm_head included), the first tokens equal to the NF4
   run's, both decode paths' times side by side.
11. train-int8: train-parity and train again over an int8 base (``--bits 8``
   storage), 5 optimizer steps, the NF4 phase's launch counts on the int8
   kernels' counters (every one of them on the int8 wgmma kernel, forward
   and dx) and none on the NF4 ones.
12. kernels-paged: the paged decode and verify-chunk kernels against their
   plain versions at LLaMA-7B width (H 32, hd 128), pages of 64, 16 pages per
   sequence, 8 rows with scattered tables: an inactive row on page 0, lengths
   on both sides of page edges, GQA with a sliding window and entries behind
   it evicted to page 0, planted edges, a chunk across a page and up to the
   table's end, the chunk of one token against the decode kernel; outputs
   within ATTN_TOL, pools byte-equal after the append.
13. paged-parity: LLaMA-7B width, 2 layers — a 126-token prompt prefilled
   into pages with ``PagedPool.write_prefill``, 4 teacher-forced decode steps
   and a 5-token verify chunk through ``forward(cache=paged)``; logits of the
   card against the CPU and against the card's contiguous cache.
14. serve-paged (inside serve, on its weights): ``PagedBatcher`` with 8
   slots over a pool small enough to preempt, 16 requests of 64-512 prompt
   and 16-64 new tokens; exact launch counts from the counted forwards, the
   pool recycled; then the same requests with ``decode_impl="int8",
   prefill_impl="w8a8"``.
15. serve-paged-spec: the same engine with 4 drafts per verify chunk on 8
   requests whose prompts repeat a 16-token phrase.

The last two lines are the ``kernels`` JSON object and the result line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES = 3.35e12      # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
PEAK_BF16 = 989e12        # dense bf16 tensor-core FLOP/s
PEAK_INT8 = 1979e12       # dense int8 tensor-core OP/s
PEAK_F32 = 67e12          # f32 outside the tensor cores, FLOP/s
L2_BYTES = 50 * 2 ** 20   # H100 L2 cache
QMM_TOL = (2e-2, 1e-2)    # atol, rtol: one bf16 ulp of the output + f32 reassociation
ATTN_TOL = 2e-2           # of each (row, head)'s max |out|: bf16 probabilities against
                          # chunk-wise running maxima, up to 2^-8 of the values' scale
LOGIT_TOL = 0.15          # 7B width, 2 layers: bf16 activations rounded in other orders

FLASH_TOL = 2e-2          # o: of each (row, head)'s max |o| (bf16 probabilities against
                          # tile-wise running maxima); dq, dk, dv: of the largest |value| of
                          # their (batch, head) slice (bf16 p and ds, f32 sums in another order)
LSE_TOL = 1e-3            # f32 log-sum-exp, summed in another order
GRAD_TOL = 0.05           # train-parity: |g_card - g_cpu| / |g_cpu| per LoRA tensor; two
                          # layers of bf16 activations rounded in other orders
LOSS_TOL = 0.02           # train-parity: |loss_card - loss_cpu|, losses near ln(32000)

INT8_BAND = 0.05          # kernels-int8: |w8a8 product - exact product| of the largest |exact
                          # value|: per-channel w8a8 noise (the JAX kernel tests' budget)
W8A8_LOGIT_TOL = 0.30     # parity-int8, card against CPU, each quantizing its own rows: twice
                          # LOGIT_TOL.  Where the bf16 activations differ by an ulp, an int8 code
                          # moves a whole step, 1/127 of its row's largest value.  On the CPU's
                          # row codes the card is held to LOGIT_TOL (it reads 0.03 there); free
                          # running it reads 0.17 to 0.23 over PARITY_INT8_SEEDS
INT8_LOGIT_BAND = 0.08    # parity-int8: the int8 path against the exact one through two layers
                          # and the lm_head, of the largest |exact logit|; 0.046 to 0.064 over
                          # PARITY_INT8_SEEDS, where one matmul has 0.012 to 0.015

PARITY_INT8_SEEDS = (41, 51, 61)

SERVE_LENGTHS = (512, 384, 200, 97)
SERVE_NEW = 64
TRAIN_MICRO = (2, 512)    # micro-batch rows x padded length
TRAIN_ACCUM = 2
TRAIN_STEPS = 5
TRAIN_INT8_STEPS = 5      # the int8 base's run: a zero step, a repeat, three that have moved
                          # (the mean of steps 1..4, as the NF4 run's)
TRAIN_LR = 2e-4

# kernel phase: the LLaMA-7B block linears (K, N) at prefill (M = 4 x 512),
# training (M = 2 x 512, forward and backward) and decode (M = 4) rows,
# decode attention at the serving width, flash attention at the training one
QMM_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096))
QMM_ROWS = (2048, 1024, 4, 8, 16, 40)   # + decode: generate()'s 4 rows, serve-paged's 8
                                        # slots, DECODE_ROWS, a verify step's 8 x 5
FEW_ROWS = 64             # up to here a row count is timed in a CUDA graph, with the tile
                          # kernel ("before") and the decode kernel beside it
QMM_BWD_ROWS = TRAIN_MICRO[0] * TRAIN_MICRO[1]
LM_HEAD_SHAPE = (4096, 32768)     # the int8 serving copy pads 32000 columns to 32768
W8A8_ROWS = (4, 128, 512, 2048)  # decode, the parity-int8 prefill (1 x 128), the serve-paged
                                 # prefill of one row at bucket 512 (its commonest), a 4 x 512 group
ATTN_CASES = (   # B, H, KVH, hd, T, lengths, sliding window, planted edges
    (4, 32, 32, 128, 640, (0, 97, 383, 639), None, False),
    (4, 32, 8, 128, 640, (0, 97, 383, 639), 256, False),      # GQA G=4, sliding window
    (4, 32, 32, 128, 600, (5, 300, 598, 599), None, False),   # T not a multiple of 128
    (4, 32, 8, 128, 640, (0, 97, 383, 639), 256, True),       # an off-by-one moves it O(1)
)


PAGE, PPS = 64, 16               # serve-paged's pages: 64 tokens, 16 per sequence (T = 1024)
PAGED_B = 8                      # serve-paged's slots
SPEC_DRAFT = 4                   # drafts per verify chunk (C = 5)
DECODE_LENS = (0, 1, 63, 64, 65, 300, 511, 1022)
CHUNK_LENS = (0, 1, 63, 64, 65, 300, 510, 1019)   # 510 % 64 == 62: across a page; 1019 + 5 == T
PAGED_CASES = (  # C (None: the decode kernel), KVH, lengths, sliding window, evicted, planted
    (None, 32, DECODE_LENS, None, False, False),
    (None, 8, DECODE_LENS, 256, True, False),     # GQA G=4, window, entries behind it on page 0
    (None, 8, DECODE_LENS, 256, True, True),      # an off-by-one moves it O(1)
    (SPEC_DRAFT + 1, 32, CHUNK_LENS, None, False, False),
    (SPEC_DRAFT + 1, 8, CHUNK_LENS, 256, True, False),
    (SPEC_DRAFT + 1, 8, CHUNK_LENS, 256, True, True),
)
SERVE_PAGED = dict(num_slots=PAGED_B, page_size=PAGE, max_pages_per_seq=PPS,
                   prefill_buckets=(128, 256, 512), eos_id=-1, admit_batch=4,
                   admission="optimistic")
SERVE_PAGED_PAGES = 32           # 31 usable pages (1.07 GB at 7B): this traffic preempts twice
SERVE_PAGED_REQUESTS = 16
SERVE_PAGED_SEED = 0
SPEC_REQUESTS = 8
SPEC_PAGES = 64                  # ample: speculation, not preemption, is what this run shows

FLASH_CASES = (  # B, H, KVH, hd, S, lengths, sliding window, planted edges, lse cotangent
    (2, 32, 32, 128, 512, (512, 300), None, False, False),   # the train run's shape
    (2, 32, 8, 128, 512, (512, 300), 256, False, True),      # GQA G=4, sliding window
    (2, 32, 32, 128, 600, (600, 333), None, False, False),   # S no multiple of 64
    (2, 32, 32, 128, 512, (512, 0), None, False, True),      # a row of length 0
    (2, 32, 8, 128, 512, (512, 300), 256, True, False),      # an off-by-one moves it O(1)
)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn(i) over `iters` launches (CUDA events),
    after `warmup` launches; `i` picks which copy of the inputs to use."""
    import torch

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean device time of fn(i) over `iters` launches captured in one CUDA
    graph and replayed, so that the host's cost of a launch, which exceeds
    the kernel's time at decode rows, leaves no gaps between them."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):     # warm up off the capture: allocator, handles
        for i in range(2):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def nf4_kernels():
    """The two NF4 forward kernels launched through their C entries,
    bypassing the dispatch and the counters: (decode, tile), each
    (x, qt) -> y.  The tile kernel's M <= 16 branch is the "before" of the
    decode kernel."""
    import importlib

    qm = importlib.import_module("qlora_tpu_torch.ops.qmatmul")

    def decode(x, qt):
        _, _, scale, offset = qm._check_quantized(qt, x.device)
        return qm._decode_launch(x, qt, scale, offset)

    def tile(x, qt):
        _, N, scale, offset = qm._check_quantized(qt, x.device)
        return qm._launch("qmm_nf4_fwd", "qmm_nf4_fwd", x, qt, N, scale, offset)

    return decode, tile


def one_hot_rows(K, block_size, n):
    """n logical rows of W to read out: both planes, both sides of an
    absmax-block edge and, where K/B > 256, of a meta-block edge."""
    K2, B = K // 2, block_size
    ks = [0, K2, B - 1, B, K2 + B - 1, K2 + B, K2 - 1, K - 1]
    if K // B > 256:
        ks += [256 * B - 1, 256 * B, K2 + 256 * B - 1, K2 + 256 * B]
    ks = list(dict.fromkeys(k for k in ks if k < K))
    more = max(0, n - len(ks))
    ks += list(range(1, K, max(1, K // (more + 1))))[:more]
    return ks[:n]


def decode_checks(name, wrapper, x, qt, w_bf16):
    """The decode path at x's rows, each check bit for bit: two calls equal;
    each row alone equal to its row in the batch; rows of the identity read
    out ``dequantize``'s weight.  Fails the run if one is broken."""
    import torch

    M, K = x.shape
    y = wrapper(x, qt)
    same = torch.equal(y, wrapper(x, qt))
    alone = all(torch.equal(wrapper(x[i:i + 1], qt)[0], y[i]) for i in range(M))
    ks = one_hot_rows(K, qt.block_size, M)
    eye = torch.zeros(M, K, device=x.device, dtype=torch.bfloat16)
    eye[torch.arange(M), torch.tensor(ks)] = 1
    readout = torch.equal(wrapper(eye, qt), w_bf16[ks])
    print(f"kernel {name} M={M} K={K} N={qt.packed.shape[-1]}: two calls equal {same}, each "
          f"row alone equal {alone}, identity rows {ks} read out dequantize's weight "
          f"{readout}", flush=True)
    if not (same and alone and readout):
        fail(f"{name} M={M} K={K}: deterministic {same}, batch-invariant {alone}, "
             f"one-hot readout {readout}")


def wgmma_checks(name, wrapper, x, qt, w_bf16, bwd=False):
    """The wgmma path at x's rows (more than DECODE_ROWS), each check bit for
    bit: two calls equal; sub-batches of at least 17 rows (which the wgmma
    kernel takes too) equal to their rows in the batch; rows of the identity
    read out ``dequantize``'s weight: rows of W forward, columns of W as rows
    of dx backward (``bwd``, x then being g [M, N]).  Fails the run if one is
    broken."""
    import torch

    M, C = x.shape
    y = wrapper(x, qt)
    same = torch.equal(y, wrapper(x, qt))
    subs = [(0, 17), (M - 17, M), (max(0, M // 2 - 20), min(M, M // 2 + 20))]
    alone = all(torch.equal(wrapper(x[a:b], qt), y[a:b]) for a, b in subs)
    ks = one_hot_cols(C, min(M, 64)) if bwd else one_hot_rows(C, qt.block_size, M)
    eye = torch.zeros(len(ks), C, device=x.device, dtype=torch.bfloat16)
    eye[torch.arange(len(ks)), torch.tensor(ks)] = 1
    readout = torch.equal(wrapper(eye, qt), w_bf16[:, ks].T if bwd else w_bf16[ks])
    what = "columns" if bwd else "rows"
    print(f"kernel {name} M={M} {'N' if bwd else 'K'}={C} (wgmma): two calls equal {same}, "
          f"rows {subs} alone equal {alone}, {len(ks)} identity rows read out dequantize's "
          f"weight ({what}) {readout}", flush=True)
    if not (same and alone and readout):
        fail(f"{name} M={M} {'N' if bwd else 'K'}={C} (wgmma): deterministic {same}, "
             f"batch-invariant {alone}, one-hot readout {readout}")


def one_hot_cols(N, n):
    """n columns of W to read out through dx: both sides of a 64-column
    k-step and of a 128-column tile, the last ones, then spread."""
    cs = [c for c in dict.fromkeys((0, 1, 7, 8, 63, 64, 127, 128, N - 8, N - 1)) if 0 <= c < N]
    return (cs + [c for c in range(2, N, max(1, N // n)) if c not in cs])[:n]


def copies_past_l2(nbytes: int) -> int:
    """How many copies of an input of `nbytes` a timing loop rotates through
    so that each launch finds its operands in device memory and not in the
    L2 cache, as the serving path does (it streams every layer's weights)."""
    return max(1, -(-2 * L2_BYTES // nbytes))


def qmm_bound(M, K, N, dq, block_size=64):
    nb = K // block_size
    am_bytes = nb * N * (1 if dq else 4) + (-(-nb // 256) * N * 4 + 4 if dq else 0)
    nbytes = M * K * 2 + K * N // 2 + am_bytes + M * N * 2
    ops = 2 * M * K * N
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_BF16
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def attn_bound(B, H, KVH, hd, lens, T, window):
    keys = []
    for n in lens:
        hi = min(n, T)
        lo = max(0, n - window + 1) if window else 0
        keys.append(max(0, hi - lo))
    kv_read = sum(2 * KVH * k * hd * 2 for k in keys)
    nbytes = kv_read + B * H * hd * 2 * 2 + 2 * B * KVH * hd * 2 * 2 + B * 4
    ops = sum(4 * H * hd * (k + 1) for k in keys)
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def flash_bounds(B, H, KVH, hd, S, lens, window):
    """(bound_ms, bound_by) for flash_fwd, flash_bwd_dq, flash_bwd_dkv: each
    input read once and each output written once, and the products over the
    (query, key) pairs that these lengths and this window leave visible
    (2 products forward, 3 for dq, 4 for dk and dv; 2 * hd operations each)."""
    import numpy as np

    row = np.arange(S)
    pairs = 0
    for n in lens:
        lo = np.maximum(0, row - window + 1) if window else 0
        pairs += int(np.maximum(0, np.minimum(row + 1, n) - lo).sum())
    qo = B * H * S * hd * 2            # q, o, do or dq: bf16 [B, H, S, hd]
    kv = B * KVH * S * hd * 2          # k, v, dk or dv
    stat = B * H * S * 4               # lse or di, f32
    out = {}
    for name, nbytes, products in (
            ("flash_fwd", 2 * qo + 2 * kv + stat + B * 4, 2),
            ("flash_bwd_dq", 3 * qo + 2 * kv + 2 * stat + B * 4, 3),
            ("flash_bwd_dkv", 2 * qo + 4 * kv + 2 * stat + B * 4, 4)):
        t_bytes, t_ops = nbytes / PEAK_BYTES, products * 2 * hd * H * pairs / PEAK_BF16
        out[name] = (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")
    return out


def plant_edges(q, kc, lens, window):
    """Give the keys just inside and just outside each row's window (its
    first key, the one before it, its last key and the slot the new token
    goes to) one shared key that dominates every query of its group, so that
    reading one key too many or too few moves the output by O(1)."""
    B, H, hd = q.shape
    KVH, T = kc.shape[1], kc.shape[2]
    key = q.float().reshape(B, KVH, H // KVH, hd).sum(2).to(kc.dtype)
    for b, n in enumerate(lens):
        hi = min(n, T)
        lo = max(0, n - window + 1) if window else 0
        for t in {lo - 1, lo, hi - 1, hi}:
            if 0 <= t < T:
                kc[b, :, t] = key[b]


def plant_flash_edges(q, k, v, lens, window):
    """The same for flash attention, in place: for a few query rows of each
    batch row (its last valid one, one in the middle, one past its length)
    the keys on both sides of the causal edge (row, row + 1), of the window
    edge (row - window + 1, row - window) and of the length edge (len - 1,
    len) become one key that dominates that query in every head of its
    group, with values of O(1) that differ from key to key.  One key too many
    or too few then moves o, and with it dk and dv, by O(1)."""
    B, H, S, D = q.shape
    KVH = k.shape[1]
    for b, n in enumerate(lens):
        if n < 2:
            continue
        rows = {n - 1, n // 2} | ({min(S - 1, n + 5)} if n < S else set())
        for r in sorted(rows):
            key = q[b, :, r].float().reshape(KVH, H // KVH, D).sum(1).to(k.dtype)
            cols = {r, r + 1, n - 1, n}
            if window:
                cols |= {r - window + 1, r - window}
            for t in cols:
                if 0 <= t < S:
                    k[b, :, t] = key
                    v[b, :, t] = 2.0 * (t % 5 - 2) + 0.5


def paged_case(g, dev, B, C, H, KVH, hd, page, pps, lens, window, evict=False, planted=False):
    """Inputs of one paged-attention call, drawn from `g`: q, new_k, new_v
    ([B, C, ...], or with C None the decode's [B, ...]), pools of noise with
    B * pps + 9 pages, lengths, and tables of distinct scattered pages.  A
    row of length 0 is an inactive slot: its table is all page 0.  With
    `evict` the entries wholly behind the window point at page 0, as
    ``PagedPool.evict_before`` leaves them."""
    import torch

    mk = lambda *s: torch.randn(*s, device=dev, generator=g).to(torch.bfloat16)
    lead = (B,) if C is None else (B, C)
    q, nk, nv = mk(*lead, H, hd), mk(*lead, KVH, hd), mk(*lead, KVH, hd)
    n_pages = B * pps + 9
    kp, vp = mk(n_pages, KVH, page, hd), mk(n_pages, KVH, page, hd)
    perm = torch.randperm(n_pages - 1, generator=g, device=dev)[:B * pps] + 1
    tables = perm.reshape(B, pps).to(torch.int32)
    for b, n in enumerate(lens):
        if n == 0:
            tables[b] = 0
        elif evict and window:
            tables[b, :max(0, n + 1 - window) // page] = 0
    if planted:
        plant_paged_edges(q, kp, tables, lens, window)
    return q, nk, nv, kp, vp, torch.tensor(lens, device=dev, dtype=torch.int32), tables


def plant_paged_edges(q, kp, tables, lens, window):
    """:func:`plant_edges` for the paged pool: the keys on both sides of each
    row's length edge and, for every query of a chunk, of its window edge
    become one key that dominates every query of the kv head's rows."""
    B, H, hd = q.shape[0], q.shape[-2], q.shape[-1]
    KVH, page = kp.shape[1], kp.shape[2]
    T = page * tables.shape[1]
    C = q.shape[1] if q.ndim == 4 else 1
    key = q.float().reshape(B, -1, KVH, H // KVH, hd).sum((1, 3)).to(kp.dtype)
    for b, n in enumerate(lens):
        if n == 0:
            continue
        edges = {min(n, T) - 1, n}
        if window:
            edges |= {e for c in range(C) for e in (n + c - window, n + c - window + 1)}
        for t in edges:
            if 0 <= t < T and int(tables[b, t // page]) != 0:
                kp[int(tables[b, t // page]), :, t % page] = key[b]


def paged_bound(B, C, H, KVH, hd, lens, window, T, pps):
    """(bound_ms, bound_by) of a paged call: the pool keys each row attends
    (read once), q and out, the C new k/v rows read and written into the
    pool, lengths and tables; 4 * hd operations per (query, key) pair, the
    chunk's own keys included, at the f32 rate."""
    keys = [max(0, min(n, T) - (max(0, n - window + 1) if window else 0)) for n in lens]
    nbytes = (2 * KVH * hd * 2 * sum(keys) + 2 * B * C * H * hd * 2
              + 2 * 2 * B * C * KVH * hd * 2 + B * 4 + B * pps * 4)
    ops = sum(4 * C * H * hd * (k + C) for k in keys)
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), sum(keys)


def paged_kernel_phase(dev, results):
    """The two paged kernels against their plain versions at the serve-paged
    shapes (PAGED_CASES), and the chunk of one token against the decode
    kernel."""
    import torch
    import torch.nn.functional as F

    from qlora_tpu_torch.ops import (
        paged_chunk_attention_cuda, paged_chunk_plain, paged_decode_attention_cuda,
        paged_decode_plain,
    )

    g = torch.Generator(device=dev).manual_seed(8642)
    H, hd, B, T = 32, 128, PAGED_B, PAGE * PPS
    for C, KVH, lens, window, evict, planted in PAGED_CASES:
        q, nk, nv, kp, vp, L, tables = paged_case(g, dev, B, C, H, KVH, hd, PAGE, PPS, lens,
                                                  window, evict, planted)
        name = "paged_decode_attention_cuda" if C is None else "paged_chunk_attention_cuda"
        kernel, plain = ((paged_decode_attention_cuda, paged_decode_plain) if C is None
                         else (paged_chunk_attention_cuda, paged_chunk_plain))
        kw = dict(sm_scale=hd ** -0.5, sliding_window=window)
        k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
        o1, _, _ = kernel(q, nk, nv, k1, v1, L, tables, **kw)
        o2, _, _ = plain(q, nk, nv, k2, v2, L, tables, **kw)
        torch.cuda.synchronize()
        diff = (o1.float() - o2.float()).abs()
        err = diff.max().item()
        excess = (diff - ATTN_TOL * o2.float().abs().amax(-1, keepdim=True)).max().item()
        same = torch.equal(k1, k2) and torch.equal(v1, v2)
        moved = None
        if planted:
            # one more key in the window moves the plain output by O(1)
            o3, _, _ = plain(q, nk, nv, kp.clone(), vp.clone(), L, tables, sm_scale=hd ** -0.5,
                             sliding_window=window + 1)
            moved = (o3.float() - o2.float()).abs().max().item()
        Cq = C or 1
        bound_ms, bound_by, keys = paged_bound(B, Cq, H, KVH, hd, lens, window, T, PPS)
        pools = [(k1, v1)] + [(k1.clone(), v1.clone())
                              for _ in range(copies_past_l2(2 * KVH * hd * 2 * keys) - 1)]
        ms = cuda_ms(lambda i: kernel(q, nk, nv, *pools[i % len(pools)], L, tables, **kw), 200)
        plain_ms = cuda_ms(lambda i: plain(q, nk, nv, *pools[i % len(pools)], L, tables, **kw),
                           5)
        # yardstick: index_select of each row's pages into [B, KVH, T, hd], then
        # SDPA with a boolean mask over the pool as if the new tokens were in it
        pos = torch.arange(T, device=dev)
        qpos = L[:, None].long() + torch.arange(Cq, device=dev)[None, :]
        vis = pos[None, None, :] <= qpos[..., None]
        if window:
            vis &= pos[None, None, :] > qpos[..., None] - window
        mask = vis[:, None]
        qs = (q[:, None] if C is None else q).transpose(1, 2)
        flat = tables.reshape(-1)

        def gathered(pages):
            return pages.index_select(0, flat).reshape(B, PPS, KVH, PAGE, hd).transpose(
                1, 2).reshape(B, KVH, T, hd)

        lib_ms = cuda_ms(lambda i: F.scaled_dot_product_attention(
            qs, gathered(pools[i % len(pools)][0]), gathered(pools[i % len(pools)][1]),
            attn_mask=mask, scale=hd ** -0.5, enable_gqa=KVH != H), 200)
        shape = (f"B={B}{'' if C is None else f' C={C}'} H={H} KVH={KVH} hd={hd} page={PAGE} "
                 f"pps={PPS} lens={list(lens)} window={window}"
                 + (" evicted" if evict else "") + (" planted edges" if planted else ""))
        record(results, name, shape, err, f"tol {ATTN_TOL}*row max|ref|", ms, plain_ms, lib_ms,
               (bound_ms, bound_by))
        print(f"  pools byte-equal after the append: {same}"
              + (f"; one more key in the window moves the plain output by {moved:.3g}"
                 if planted else ""), flush=True)
        if excess > 0 or not same:
            fail(f"{name} {shape}: max|d|={err}, pools byte-equal={same}")
        if planted and moved < 0.5:
            fail(f"{name} {shape}: the planted edges move the output by only {moved}")
        del pools, k1, v1, k2, v2

    # the chunk of one token is the decode step
    q, nk, nv, kp, vp, L, tables = paged_case(g, dev, B, None, H, 8, hd, PAGE, PPS,
                                              DECODE_LENS, 256, True, True)
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    kw = dict(sm_scale=hd ** -0.5, sliding_window=256)
    oc, _, _ = paged_chunk_attention_cuda(q[:, None], nk[:, None], nv[:, None], k1, v1, L,
                                          tables, **kw)
    od, _, _ = paged_decode_attention_cuda(q, nk, nv, k2, v2, L, tables, **kw)
    torch.cuda.synchronize()
    same = torch.equal(oc[:, 0], od) and torch.equal(k1, k2) and torch.equal(v1, v2)
    print(f"kernel paged_chunk_attention_cuda C=1 against paged_decode_attention_cuda: outputs "
          f"and pools equal bit for bit: {same}", flush=True)
    if not same:
        fail("the chunk kernel at C=1 differs from the decode kernel")


def kernel_phase(dev, results):
    import torch
    import torch.nn.functional as F

    from qlora_tpu_torch.ops import (
        decode_attention_cuda, decode_attention_plain, qmatmul_bwd_plain, qmatmul_plain,
        qmm_nf4_bwd, qmm_nf4_fwd_dq, qmm_nf4_fwd_f32,
    )
    from qlora_tpu_torch.ops.qmatmul import DECODE_ROWS
    from qlora_tpu_torch.quant import dequantize, quantize

    decode, tile = nf4_kernels()
    g = torch.Generator(device=dev).manual_seed(1234)
    for dq in (True, False):
        wrapper = qmm_nf4_fwd_dq if dq else qmm_nf4_fwd_f32
        for K, N in QMM_SHAPES:
            w = torch.randn(K, N, device=dev, generator=g) * K ** -0.5
            qt = quantize(w, double_quant=dq)
            w_bf16 = dequantize(qt, torch.bfloat16)
            del w
            qts = [qt] + [dataclasses.replace(qt, packed=qt.packed.clone(),
                                              absmax=qt.absmax.clone())
                          for _ in range(copies_past_l2(qt.nbytes) - 1)]
            ws = [w_bf16] + [w_bf16.clone()
                             for _ in range(copies_past_l2(w_bf16.nbytes) - 1)]
            for M in QMM_ROWS:
                x = torch.randn(M, K, device=dev, generator=g).to(torch.bfloat16)
                y = wrapper(x, qt)
                ref = qmatmul_plain(x, qt)
                torch.cuda.synchronize()
                diff = (y.float() - ref.float()).abs()
                err = diff.max().item()
                excess = (diff - QMM_TOL[1] * ref.float().abs()).max().item()
                name = wrapper.__name__
                more = {}
                if M > DECODE_ROWS:   # the tile kernel of qmm_nf4_fwd.cu: the "before"
                    yt = tile(x, qt)
                    torch.cuda.synchronize()
                    dt = (yt.float() - ref.float()).abs()
                    more["tile_err"] = dt.max().item()
                    excess = max(excess, (dt - QMM_TOL[1] * ref.float().abs()).max().item())
                if M > FEW_ROWS:
                    ms = cuda_ms(lambda i: wrapper(x, qts[i % len(qts)]), 20)
                    more["tile_ms"] = cuda_ms(lambda i: tile(x, qts[i % len(qts)]), 5)
                    plain_ms = cuda_ms(lambda i: qmatmul_plain(x, qts[i % len(qts)]), 3)
                    lib_ms = cuda_ms(lambda i: torch.matmul(x, ws[i % len(ws)]), 20)
                else:
                    # device times in a graph: the wrapper (the decode kernel up to
                    # DECODE_ROWS), the tile kernel on the same inputs, the library
                    ms = graph_ms(lambda i: wrapper(x, qts[i % len(qts)]), 200)
                    more["tile_ms"] = graph_ms(lambda i: tile(x, qts[i % len(qts)]), 50)
                    lib_ms = graph_ms(lambda i: torch.matmul(x, ws[i % len(ws)]), 200)
                    plain_ms = cuda_ms(lambda i: qmatmul_plain(x, qts[i % len(qts)]), 20)
                    if M > DECODE_ROWS:   # the decode kernel where the dispatch does not send it
                        yd = decode(x, qt)
                        torch.cuda.synchronize()
                        dd = (yd.float() - ref.float()).abs()
                        more["decode_err"] = dd.max().item()
                        excess = max(excess, (dd - QMM_TOL[1] * ref.float().abs()).max().item())
                        more["decode_ms"] = graph_ms(lambda i: decode(x, qts[i % len(qts)]), 200)
                bound_ms, bound_by = qmm_bound(M, K, N, dq)
                rec = dict(name=name, shape=f"M={M} K={K} N={N}", max_abs_err=err, ms=ms,
                           plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                           bound_by=bound_by, **more)
                results.append(rec)
                print(f"kernel {name} M={M} K={K} N={N}: max|d|={err:.3g} "
                      f"(tol {QMM_TOL[0]} + {QMM_TOL[1]}*|ref|) ms={ms:.4f} "
                      f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                      f"bound_ms={bound_ms:.4f} ({bound_by})"
                      + "".join(f" {k}={v:.4g}" for k, v in more.items()), flush=True)
                if excess > QMM_TOL[0]:
                    fail(f"{name} M={M} K={K} N={N} differs from its plain version by {err}")
                if M <= DECODE_ROWS:
                    decode_checks(name, wrapper, x, qt, w_bf16)
                else:
                    wgmma_checks(name, wrapper, x, qt, w_bf16)
                    if M <= FEW_ROWS:
                        decode_checks(f"{name} (decode kernel)", decode, x, qt, w_bf16)
            # the backward at the training micro-batch: dx = g @ dequant(W)^T
            M = QMM_BWD_ROWS
            gr = torch.randn(M, N, device=dev, generator=g).to(torch.bfloat16)
            dx = qmm_nf4_bwd(gr, qt)
            ref = qmatmul_bwd_plain(gr, qt)
            torch.cuda.synchronize()
            diff = (dx.float() - ref.float()).abs()
            err = diff.max().item()
            excess = (diff - QMM_TOL[1] * ref.float().abs()).max().item()
            ms = cuda_ms(lambda i: qmm_nf4_bwd(gr, qts[i % len(qts)]), 20)
            plain_ms = cuda_ms(lambda i: qmatmul_bwd_plain(gr, qts[i % len(qts)]), 3)
            lib_ms = cuda_ms(lambda i: torch.matmul(gr, ws[i % len(ws)].T), 20)
            bound_ms, bound_by = qmm_bound(M, K, N, dq)    # the same bytes and operations
            shape = f"M={M} K={K} N={N} {'dq' if dq else 'f32'} absmax"
            results.append(dict(name="qmm_nf4_bwd", shape=shape, max_abs_err=err, ms=ms,
                                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                                bound_by=bound_by))
            print(f"kernel qmm_nf4_bwd {shape}: max|d|={err:.3g} "
                  f"(tol {QMM_TOL[0]} + {QMM_TOL[1]}*|ref|) ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                  f"bound_ms={bound_ms:.4f} ({bound_by})", flush=True)
            if excess > QMM_TOL[0]:
                fail(f"qmm_nf4_bwd {shape} differs from its plain version by {err}")

    for B, H, KVH, hd, T, lens, window, planted in ATTN_CASES:
        mk = lambda *s: torch.randn(*s, device=dev, generator=g).to(torch.bfloat16)
        q, nk, nv = mk(B, H, hd), mk(B, KVH, hd), mk(B, KVH, hd)
        kc, vc = mk(B, KVH, T, hd), mk(B, KVH, T, hd)
        if planted:
            plant_edges(q, kc, lens, window)
        L = torch.tensor(lens, device=dev, dtype=torch.int32)
        k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        o1, _, _ = decode_attention_cuda(q, nk, nv, k1, v1, L, sm_scale=hd ** -0.5,
                                         sliding_window=window)
        o2, _, _ = decode_attention_plain(q, nk, nv, k2, v2, L, sm_scale=hd ** -0.5,
                                          sliding_window=window)
        torch.cuda.synchronize()
        diff = (o1.float() - o2.float()).abs()
        err = diff.max().item()
        excess = (diff - ATTN_TOL * o2.float().abs().amax(-1, keepdim=True)).max().item()
        same = torch.equal(k1, k2) and torch.equal(v1, v2)
        caches = [(k1, v1)] + [(k1.clone(), v1.clone())
                               for _ in range(copies_past_l2(2 * k1.nbytes) - 1)]
        ms = cuda_ms(lambda i: decode_attention_cuda(
            q, nk, nv, *caches[i % len(caches)], L, sm_scale=hd ** -0.5,
            sliding_window=window), 200)
        plain_ms = cuda_ms(lambda i: decode_attention_plain(
            q, nk, nv, *caches[i % len(caches)], L, sm_scale=hd ** -0.5,
            sliding_window=window), 20)
        # yardstick: SDPA of the 4 queries over the cache, masked to each
        # row's valid prefix (it reads all T slots and appends nothing)
        pos = torch.arange(T, device=dev)
        valid = pos[None, :] <= L[:, None].clamp(max=T - 1)
        if window:
            valid &= pos[None, :] > L[:, None] - window
        mask = valid[:, None, None, :]
        qs = q[:, :, None, :]
        lib_ms = cuda_ms(lambda i: F.scaled_dot_product_attention(
            qs, *caches[i % len(caches)], attn_mask=mask, scale=hd ** -0.5,
            enable_gqa=KVH != H), 200)
        bound_ms, bound_by = attn_bound(B, H, KVH, hd, lens, T, window)
        shape = (f"B={B} H={H} KVH={KVH} hd={hd} T={T} lens={list(lens)} window={window}"
                 + (" planted edges" if planted else ""))
        results.append(dict(name="decode_attention_cuda", shape=shape, max_abs_err=err,
                            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                            bound_by=bound_by))
        print(f"kernel decode_attention_cuda {shape}: max|d|={err:.3g} "
              f"(tol {ATTN_TOL}*row max|ref|) "
              f"cache bytes equal={same} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})", flush=True)
        if excess > 0 or not same:
            fail(f"decode attention {shape}: max|d|={err}, cache bytes equal={same}")


def flash_phase(dev, results):
    """flash_fwd, flash_bwd_dq and flash_bwd_dkv against their plain versions
    at the training shapes.  The backward kernels get the plain forward's o
    and lse, so that each kernel is held against the same function of the
    same inputs."""
    import torch
    import torch.nn.functional as F

    from qlora_tpu_torch.ops import (
        flash_bwd_dkv, flash_bwd_dq, flash_bwd_plain, flash_fwd, flash_fwd_plain,
    )

    g = torch.Generator(device=dev).manual_seed(4321)
    for B, H, KVH, hd, S, lens, window, planted, with_dlse in FLASH_CASES:
        mk = lambda *s: torch.randn(*s, device=dev, generator=g).to(torch.bfloat16)
        q, k, v, do = mk(B, H, S, hd), mk(B, KVH, S, hd), mk(B, KVH, S, hd), mk(B, H, S, hd)
        if planted:
            plant_flash_edges(q, k, v, lens, window)
        L = torch.tensor(lens, device=dev, dtype=torch.int32)
        sm = hd ** -0.5
        dlse = 0.3 * torch.randn(B, H, S, device=dev, generator=g) if with_dlse else None
        shape = (f"B={B} H={H} KVH={KVH} hd={hd} S={S} lens={list(lens)} window={window}"
                 + (" planted edges" if planted else "") + (" dlse" if with_dlse else ""))

        o, lse = flash_fwd(q, k, v, L, sm, True, window)
        o2, lse2 = flash_fwd_plain(q, k, v, L, sm, True, window)
        di = (o2.float() * do.float()).sum(-1)
        if dlse is not None:
            di = di - dlse
        dq = flash_bwd_dq(q, k, v, L, do, lse2, di, sm, True, window)
        dk, dv = flash_bwd_dkv(q, k, v, L, do, lse2, di, sm, True, window)
        rq, rk, rv = flash_bwd_plain(q, k, v, L, o2, lse2, do, sm, True, window, dlse=dlse)
        torch.cuda.synchronize()

        def excess(got, ref, dims):
            d = (got.float() - ref.float()).abs()
            tol = FLASH_TOL * ref.float().abs().amax(dims, keepdim=True)
            return d.max().item(), (d - tol).max().item()

        errs = {"flash_fwd": excess(o, o2, -1)}
        errs["flash_bwd_dq"] = excess(dq, rq, (-2, -1))
        ek, ev = excess(dk, rk, (-2, -1)), excess(dv, rv, (-2, -1))
        errs["flash_bwd_dkv"] = (max(ek[0], ev[0]), max(ek[1], ev[1]))
        empty = lse2 > 1e37                                  # rows that see no key
        lse_err = (lse - lse2)[~empty].abs().max().item()
        exact = (bool((lse[empty] == 3e38).all()) and bool((o[empty] == 0).all())
                 and bool((dq[empty] == 0).all())
                 and all(bool((dk[b, :, n:] == 0).all()) and bool((dv[b, :, n:] == 0).all())
                         for b, n in enumerate(lens)))
        moved = None
        if planted:
            # the planted keys do what they are for: one more key in the window
            # moves the plain o by O(1), so a kernel that read it would fail
            o3, _ = flash_fwd_plain(q, k, v, L, sm, True, window + 1)
            moved = (o3.float() - o2.float()).abs().max().item()

        n_sets = copies_past_l2(3 * q.nbytes + 2 * k.nbytes)
        sets = [(q, k, v, do)] + [(q.clone(), k.clone(), v.clone(), do.clone())
                                  for _ in range(n_sets - 1)]
        pick = lambda i: sets[i % n_sets]
        ms = {
            "flash_fwd": cuda_ms(lambda i: flash_fwd(*pick(i)[:3], L, sm, True, window), 50),
            "flash_bwd_dq": cuda_ms(lambda i: flash_bwd_dq(*pick(i)[:3], L, pick(i)[3], lse2, di,
                                                           sm, True, window), 50),
            "flash_bwd_dkv": cuda_ms(lambda i: flash_bwd_dkv(*pick(i)[:3], L, pick(i)[3], lse2,
                                                             di, sm, True, window), 50),
        }
        plain_fwd = cuda_ms(lambda i: flash_fwd_plain(*pick(i)[:3], L, sm, True, window), 5)
        plain_bwd = cuda_ms(lambda i: flash_bwd_plain(*pick(i)[:3], L, o2, lse2, pick(i)[3], sm,
                                                      True, window, dlse=dlse), 5)
        # yardstick: SDPA with the same mask (an all-masked row gives it NaN,
        # which does not change its time) and its autograd backward, which
        # computes dq, dk and dv in one call
        row = torch.arange(S, device=dev)[:, None]
        col = torch.arange(S, device=dev)[None, :]
        vis = (col <= row) & (col < L[:, None, None])
        if window:
            vis = vis & (row - col < window)
        mask = vis[:, None]
        sdpa = lambda qq, kk, vv: F.scaled_dot_product_attention(
            qq, kk, vv, attn_mask=mask, scale=sm, enable_gqa=KVH != H)
        lib_fwd = cuda_ms(lambda i: sdpa(*pick(i)[:3]), 50)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = sdpa(*leaves)
        lib_bwd = cuda_ms(lambda i: torch.autograd.grad(out, leaves, pick(i)[3],
                                                        retain_graph=True), 20)
        bounds = flash_bounds(B, H, KVH, hd, S, lens, window)
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            fwd = name == "flash_fwd"
            results.append(dict(
                name=name, shape=shape, max_abs_err=errs[name][0], ms=ms[name],
                plain_ms=plain_fwd if fwd else plain_bwd,
                library_ms=lib_fwd if fwd else lib_bwd,
                bound_ms=bounds[name][0], bound_by=bounds[name][1]))
            print(f"kernel {name} {shape}: max|d|={errs[name][0]:.3g} (tol {FLASH_TOL}*max|ref|"
                  f"{' of the row' if fwd else ' of the slice'}) ms={ms[name]:.4f} "
                  f"plain_ms={plain_fwd if fwd else plain_bwd:.4f} "
                  f"library_ms={lib_fwd if fwd else lib_bwd:.4f} "
                  f"bound_ms={bounds[name][0]:.4f} ({bounds[name][1]})", flush=True)
        print(f"  lse max|d|={lse_err:.3g} (tol {LSE_TOL}); empty rows and keys past the "
              f"length exactly 0: {exact}; plain_ms of the backward is dq, dk and dv "
              f"together, library_ms SDPA's whole backward"
              + (f"; one more key in the window moves the plain o by {moved:.3g}"
                 if planted else ""), flush=True)
        bad = [n for n, (_, ex) in errs.items() if ex > 0]
        if bad or lse_err > LSE_TOL or not exact:
            fail(f"flash {shape}: {bad} differ from their plain versions ({errs}), "
                 f"lse {lse_err}, exact zeros {exact}")
        if planted and moved < 0.5:
            fail(f"flash {shape}: the planted edges move o by only {moved}")
        del sets, leaves, out


def int8_bound(M, K, N, weight_bytes, peak_ops, act_bytes):
    """(bound_ms, bound_by) of an [M, K] x [K, N] product whose weight side
    (codes and scales) is `weight_bytes` and whose activations are
    `act_bytes` wide: every input read once, the bf16 output written once,
    2*M*K*N operations at `peak_ops`."""
    nbytes = M * K * act_bytes + weight_bytes + M * N * 2
    t_bytes, t_ops = nbytes / PEAK_BYTES, 2 * M * K * N / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def record(results, name, shape, err, tol, ms, plain_ms, lib_ms, bound, **more):
    bound_ms, bound_by = bound
    results.append(dict(name=name, shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by, **more))
    extra = "".join(f" {k}={v:.4f}" for k, v in more.items())
    print(f"kernel {name} {shape}: max|d|={err:.3g} ({tol}) ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}){extra}", flush=True)


def int_mm_ms(x8, w8s, s_out, xs, iters):
    """The yardstick of the w8a8 kernels: ``torch._int_mm`` (cuBLAS int8,
    rows padded to 32: it wants more than 16) and the epilogue in PyTorch
    ops.  It takes every shape of this script once its rows are padded."""
    import torch

    M = x8.shape[0]
    xp = torch.nn.functional.pad(x8, (0, 0, 0, (-M) % 32))

    def call(i):
        acc = torch._int_mm(xp, w8s[i % len(w8s)])[:M]
        return (acc.float() * s_out[None, :]).to(torch.bfloat16) * xs.to(torch.bfloat16)

    return cuda_ms(call, iters)


def w8a8_check(name, shape, wrapper, plain, x, qt, w8):
    """A w8a8 kernel against its plain version: the raw int32 accumulators
    equal the exact integer product, and the bf16 output, whose float steps
    (two multiplications, two roundings) both sides take in the same order,
    is equal bit for bit.  Returns the largest |difference| (0.0 or a failure)."""
    import torch

    from qlora_tpu_torch.ops import int8_matmul_plain, quantize_rows
    from qlora_tpu_torch.ops.qmatmul import _w8a8_accumulators

    x8, _ = quantize_rows(x)
    acc = _w8a8_accumulators(x8, qt)
    ref_acc = int8_matmul_plain(x8, w8).to(torch.int32)
    y, ref = wrapper(x, qt), plain(x, qt)
    torch.cuda.synchronize()
    err = (y.float() - ref.float()).abs().max().item()
    if not torch.equal(acc, ref_acc):
        bad = (acc != ref_acc).sum().item()
        fail(f"{name} {shape}: {bad} int32 accumulators differ from the exact integer product")
    if not torch.equal(y, ref):
        fail(f"{name} {shape}: the bf16 output differs from its plain version by {err}")
    return err, y


def int8_kernel_phase(dev, results):
    """The int8 family against its plain versions, at the LLaMA-7B shapes."""
    import torch

    from qlora_tpu_torch.ops import (
        qmatmul_plain, qmm_i8_bwd, qmm_i8_bwd_plain, qmm_i8_direct, qmm_i8_direct_plain,
        qmm_i8_fwd, qmm_i8_fwd_plain, qmm_nf4_w8a8, qmm_nf4_w8a8_plain, quantize_rows,
        w8a8_codes, w8a8_scales,
    )
    from qlora_tpu_torch.ops.qmatmul import DECODE_ROWS
    from qlora_tpu_torch.quant import absmax_f32, dequantize, quantize

    # "ms" is the kernel alone on rows quantized beforehand, as bound_ms and library_ms
    # are; "wrapper_ms" adds the wrapper's row quantization in PyTorch ops
    from qlora_tpu_torch.ops.qmatmul import _launch_w8a8 as launch_w8a8
    g = torch.Generator(device=dev).manual_seed(2468)
    clones = lambda qt: [qt] + [dataclasses.replace(qt, packed=qt.packed.clone(),
                                                    absmax=qt.absmax.clone())
                                for _ in range(copies_past_l2(qt.nbytes) - 1)]
    exact_tol = "equal bit for bit, int32 accumulators and bf16 output"

    # qmm_i8_direct: the decode step's launches (M = 4) and a ragged shape
    for M, (K, N) in [(4, s) for s in QMM_SHAPES + (LM_HEAD_SHAPE,)] + [(5, (200, 328))]:
        w = torch.randn(K, N, device=dev, generator=g) * K ** -0.5
        qt = quantize(w, block_size=K, quant_type="int8", double_quant=False)
        del w
        x = torch.randn(M, K, device=dev, generator=g).to(torch.bfloat16)
        shape = f"M={M} K={K} N={N}"
        err, _ = w8a8_check("qmm_i8_direct", shape, qmm_i8_direct, qmm_i8_direct_plain, x, qt,
                            qt.packed)
        qts = clones(qt)
        x8, xs = quantize_rows(x)
        s_out = absmax_f32(qt).reshape(-1) / 127.0
        ms = cuda_ms(lambda i: launch_w8a8("qmm_i8_direct", x8, qts[i % len(qts)], None, s_out,
                                           xs), 200)
        wrapper_ms = cuda_ms(lambda i: qmm_i8_direct(x, qts[i % len(qts)]), 200)
        plain_ms = cuda_ms(lambda i: qmm_i8_direct_plain(x, qts[i % len(qts)]), 3)
        lib_ms = int_mm_ms(x8, [q.packed for q in qts], s_out, xs, 200)
        record(results, "qmm_i8_direct", shape, err, exact_tol, ms, plain_ms, lib_ms,
               int8_bound(M, K, N, K * N + N * 4 + M * 4, PEAK_INT8, 1), wrapper_ms=wrapper_ms)
        del qts, qt

    # qmm_nf4_w8a8: NF4 storage (double quant), decode and prefill rows
    for K, N in QMM_SHAPES:
        w = torch.randn(K, N, device=dev, generator=g) * K ** -0.5
        qt = quantize(w)
        del w
        ratio, s_out = w8a8_scales(qt)
        w8 = w8a8_codes(qt, ratio)
        qts = clones(qt)
        w8s = [w8] + [w8.clone() for _ in range(copies_past_l2(w8.nbytes) - 1)]
        for M in W8A8_ROWS:
            x = torch.randn(M, K, device=dev, generator=g).to(torch.bfloat16)
            shape = f"M={M} K={K} N={N}"
            err, y = w8a8_check("qmm_nf4_w8a8", shape, qmm_nf4_w8a8, qmm_nf4_w8a8_plain, x, qt,
                                w8)
            exact = qmatmul_plain(x, qt).float()
            off = (y.float() - exact).abs().max().item() / exact.abs().max().item()
            if not 0 < off < INT8_BAND:
                fail(f"qmm_nf4_w8a8 {shape}: {off:.4f} of the largest |value| away from the "
                     f"exact product (band {INT8_BAND})")
            x8, xs = quantize_rows(x)
            iters = 20 if M > 16 else 200
            ms = cuda_ms(lambda i: launch_w8a8("qmm_nf4_w8a8", x8, qts[i % len(qts)], ratio,
                                               s_out, xs), iters)
            wrapper_ms = cuda_ms(lambda i: qmm_nf4_w8a8(x, qts[i % len(qts)]), iters)
            plain_ms = cuda_ms(lambda i: qmm_nf4_w8a8_plain(x, qts[i % len(qts)]), 2)
            lib_ms = int_mm_ms(x8, w8s, s_out, xs, iters)
            record(results, "qmm_nf4_w8a8", shape, err, exact_tol, ms, plain_ms, lib_ms,
                   int8_bound(M, K, N, K * N // 2 + ratio.nbytes + N * 4 + M * 4, PEAK_INT8, 1),
                   wrapper_ms=wrapper_ms, of_exact=off)
        del qts, w8s, w8, qt

    # qmm_i8_fwd, qmm_i8_bwd: the --bits 8 base, f32 and double-quantized absmax;
    # above DECODE_ROWS the wgmma kernel, with the tile kernel of qmm_i8.cu
    # through its C entry beside it (the "before")
    import importlib

    qm = importlib.import_module("qlora_tpu_torch.ops.qmatmul")

    def i8_tile(a, q, fwd):
        K, N, scale, offset = qm._check_quantized(q, a.device)
        return qm._launch("qmm_i8", "qmm_i8_fwd" if fwd else "qmm_i8_bwd", a, q,
                          N if fwd else K, scale, offset)

    tol = f"tol {QMM_TOL[0]} + {QMM_TOL[1]}*|ref|"
    for dq in (True, False):
        for K, N in QMM_SHAPES:
            w = torch.randn(K, N, device=dev, generator=g) * K ** -0.5
            qt = quantize(w, quant_type="int8", double_quant=dq)
            w_bf16 = dequantize(qt, torch.bfloat16)
            del w
            qts = clones(qt)
            ws = [w_bf16] + [w_bf16.clone() for _ in range(copies_past_l2(w_bf16.nbytes) - 1)]
            am_bytes = qt.nbytes - K * N
            kind = "dq" if dq else "f32"
            for name, kernel, plain, rows in (("qmm_i8_fwd", qmm_i8_fwd, qmm_i8_fwd_plain,
                                               (4, QMM_BWD_ROWS, 2048)),
                                              ("qmm_i8_bwd", qmm_i8_bwd, qmm_i8_bwd_plain,
                                               (QMM_BWD_ROWS,))):
                fwd = name == "qmm_i8_fwd"
                for M in rows:
                    a = torch.randn(M, K if fwd else N, device=dev, generator=g).to(torch.bfloat16)
                    y, ref = kernel(a, qt), plain(a, qt)
                    torch.cuda.synchronize()
                    diff = (y.float() - ref.float()).abs()
                    err = diff.max().item()
                    excess = (diff - QMM_TOL[1] * ref.float().abs()).max().item()
                    shape = f"M={M} K={K} N={N} {kind} absmax"
                    more = {}
                    if M > DECODE_ROWS:
                        yt = i8_tile(a, qt, fwd)
                        torch.cuda.synchronize()
                        dt = (yt.float() - ref.float()).abs()
                        more["tile_err"] = dt.max().item()
                        excess = max(excess, (dt - QMM_TOL[1] * ref.float().abs()).max().item())
                    if excess > QMM_TOL[0]:
                        fail(f"{name} {shape} differs from its plain version by {err}")
                    iters = 20 if M > 16 else 200
                    ms = cuda_ms(lambda i: kernel(a, qts[i % len(qts)]), iters)
                    if M > DECODE_ROWS:
                        more["tile_ms"] = cuda_ms(lambda i: i8_tile(a, qts[i % len(qts)], fwd), 5)
                    plain_ms = cuda_ms(lambda i: plain(a, qts[i % len(qts)]), 3 if M > 16 else 20)
                    lib_ms = cuda_ms(lambda i: torch.matmul(
                        a, ws[i % len(ws)] if fwd else ws[i % len(ws)].T), iters)
                    record(results, name, shape, err, tol, ms, plain_ms, lib_ms,
                           int8_bound(M, K, N, K * N + am_bytes, PEAK_BF16, 2), **more)
                    if M > DECODE_ROWS:
                        wgmma_checks(name, kernel, a, qt, w_bf16, bwd=not fwd)
            del qts, ws, w_bf16, qt
        # identity operands read the decoded weight out of both kernels: dequantize's, bit
        # for bit (two meta-blocks of absmax rows; a ragged shape)
        for K, N in ((64 * 260, 64), (192, 200)):
            qt = quantize(torch.randn(K, N, device=dev, generator=g), quant_type="int8",
                          double_quant=dq)
            w = dequantize(qt, torch.bfloat16)
            same = torch.equal(qmm_i8_bwd(torch.eye(N, device=dev, dtype=torch.bfloat16), qt),
                               w.T.contiguous())
            if K <= 256:
                same = same and torch.equal(
                    qmm_i8_fwd(torch.eye(K, device=dev, dtype=torch.bfloat16), qt), w)
            print(f"kernel qmm_i8_fwd/qmm_i8_bwd K={K} N={N} {'dq' if dq else 'f32'} absmax: "
                  f"identity operands read out dequantize's weight bit for bit: {same}",
                  flush=True)
            if not same:
                fail(f"the int8 kernels decode another weight than dequantize (K={K} N={N})")


def seven_b(num_layers=None):
    from qlora_tpu_torch.models import get_config

    cfg = get_config("huggyllama/llama-7b")
    return dataclasses.replace(cfg, num_layers=num_layers) if num_layers else cfg


def random_lora(cfg, dev, seed):
    import torch

    from qlora_tpu_torch.lora import LoraConfig
    from qlora_tpu_torch.models import init_lora_params

    lcfg = LoraConfig(r=64, alpha=16.0)
    lora = init_lora_params(cfg, lcfg, seed=seed, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    for layer in lora:
        for ad in layer.values():
            ad["b"].normal_(0.0, 0.05, generator=g)
    return lora, lcfg


def parity_phase(dev):
    import torch

    from qlora_tpu_torch.models import forward, init_cache, init_params
    from qlora_tpu_torch.utils import move_to

    cfg = seven_b(num_layers=2)
    p_gpu = init_params(cfg, seed=1, device=dev)
    lora_gpu, lcfg = random_lora(cfg, dev, seed=2)
    p_cpu, lora_cpu = move_to(p_gpu, "cpu"), move_to(lora_gpu, "cpu")
    S, steps = 128, 4
    ids = torch.randint(0, cfg.vocab_size, (1, S), generator=torch.Generator().manual_seed(3))
    c_cpu = init_cache(cfg, 1, S + steps, device="cpu")
    c_dev = init_cache(cfg, 1, S + steps, device=dev)
    worst = 0.0
    with torch.inference_mode():
        lc, c_cpu = forward(p_cpu, lora_cpu, ids, cfg, lcfg, cache=c_cpu)
        lg, c_dev = forward(p_gpu, lora_gpu, ids.to(dev), cfg, lcfg, cache=c_dev)
        for step in range(steps + 1):
            last_c, last_g = lc[:, -1], lg[:, -1].cpu()
            if not (torch.isfinite(last_c).all() and torch.isfinite(last_g).all()):
                fail(f"parity: non-finite logits at step {step}")
            err = (last_c - last_g).abs().max().item()
            if step == 0:      # the whole prefill, every position
                err = max(err, (lc - lg.cpu()).abs().max().item())
            worst = max(worst, err)
            print(f"parity step {step}: max|logits cpu - card|={err:.4g} "
                  f"(tol {LOGIT_TOL}, |logits| max {last_c.abs().max().item():.3g})",
                  flush=True)
            if err > LOGIT_TOL:
                fail(f"parity: card logits differ from the CPU's by {err} at step {step}")
            if step == steps:
                break
            tok = last_c.argmax(-1, keepdim=True)         # teacher-force the CPU's token
            lc, c_cpu = forward(p_cpu, lora_cpu, tok, cfg, lcfg, cache=c_cpu)
            lg, c_dev = forward(p_gpu, lora_gpu, tok.to(dev), cfg, lcfg, cache=c_dev)
    del p_gpu, p_cpu, lora_gpu, lora_cpu, c_cpu, c_dev
    torch.cuda.empty_cache()
    return worst


def clone_cache(cache):
    return {"k": [t.clone() for t in cache["k"]], "v": [t.clone() for t in cache["v"]],
            "length": cache["length"].clone()}


@contextlib.contextmanager
def row_codes(tape, replay_on=None):
    """Inside the block the w8a8 paths' ``quantize_rows`` writes each call's
    (x8, xs) to `tape`, or, with `replay_on` a device, hands back the tape's
    entries there in the same order of calls instead of quantizing what it is
    given: a second run of the same model then multiplies the first run's
    int8 codes."""
    import importlib

    qm = importlib.import_module("qlora_tpu_torch.ops.qmatmul")
    real, left = qm.quantize_rows, iter(tape)

    def record(x):
        tape.append(real(x))
        return tape[-1]

    def replay(x):
        x8, xs = next(left)
        if x8.shape != x.shape:
            fail(f"row_codes: call of shape {tuple(x.shape)} meets a tape entry {tuple(x8.shape)}")
        return x8.to(replay_on), xs.to(replay_on)

    qm.quantize_rows = record if replay_on is None else replay
    try:
        yield
    finally:
        qm.quantize_rows = real
    if replay_on is not None and next(left, None) is not None:
        fail("row_codes: the replaying run quantized fewer rows than the recording one")


def parity_int8_phase(dev, seed):
    """The w8a8 paths, CPU plain versions against the card, 2 layers at full
    width: (a) 4 teacher-forced decode steps on the int8 serving tree, (b) a
    128-token prefill of the NF4 params, both under ``default_impl("w8a8")``.
    Three readings each.  Card against CPU, within W8A8_LOGIT_TOL.  The same
    with the CPU's row codes replayed on the card (:func:`row_codes`), within
    LOGIT_TOL, the exact path's limit: given equal codes every integer
    product is equal, and what is left is what the exact path has too.  And
    the card's int8 logits against its exact ones: inside INT8_LOGIT_BAND and
    not equal.  Returns (the worst of each reading, launch counts of the
    prefill)."""
    import torch

    from qlora_tpu_torch.generate.serve_int8 import requantize_params_int8_unstacked
    from qlora_tpu_torch.models import forward, init_cache, init_params
    from qlora_tpu_torch.ops import default_impl
    from qlora_tpu_torch.utils import move_to

    cfg = seven_b(num_layers=2)
    p_gpu = init_params(cfg, seed=seed, device=dev)
    lora_gpu, lcfg = random_lora(cfg, dev, seed=seed + 1)
    S, steps = 128, 4
    ids = torch.randint(0, cfg.vocab_size, (1, S),
                        generator=torch.Generator().manual_seed(seed + 2))
    worst = dict(free=0.0, replayed=0.0, of_exact=0.0)

    def compare(what, l_cpu, l_gpu, l_replayed, l_exact):
        if not all(torch.isfinite(t).all() for t in (l_cpu, l_gpu, l_replayed)):
            fail(f"parity-int8 {what}: non-finite logits")
        err = (l_cpu - l_gpu.cpu()).abs().max().item()
        err_replayed = (l_cpu - l_replayed.cpu()).abs().max().item()
        top = l_exact.abs().max().item()
        off = (l_gpu - l_exact).abs().max().item() / top
        for k, v in (("free", err), ("replayed", err_replayed), ("of_exact", off)):
            worst[k] = max(worst[k], v)
        print(f"parity-int8 seed {seed} {what}: max|logits cpu - card|={err:.4g} (tol "
              f"{W8A8_LOGIT_TOL}), with the CPU's row codes on the card {err_replayed:.4g} (tol "
              f"{LOGIT_TOL}); int8 path against the exact path on the card: {off:.4f} of the "
              f"largest |logit| {top:.3g} (band {INT8_LOGIT_BAND}, and not 0)", flush=True)
        if err > W8A8_LOGIT_TOL:
            fail(f"parity-int8 {what}: card logits differ from the CPU's by {err}")
        if err_replayed > LOGIT_TOL:
            fail(f"parity-int8 {what}: on the CPU's row codes the card's logits still differ "
                 f"from the CPU's by {err_replayed}")
        if not 0 < off < INT8_LOGIT_BAND:
            fail(f"parity-int8 {what}: the int8 path is {off} of the largest |logit| away "
                 "from the exact path")

    with torch.inference_mode():
        dec_gpu = requantize_params_int8_unstacked(p_gpu)
        p_cpu, lora_cpu, dec_cpu = (move_to(t, "cpu") for t in (p_gpu, lora_gpu, dec_gpu))
        # (b) first: the prefill, on the NF4 params, under w8a8
        tape = []
        with default_impl("w8a8"):
            with row_codes(tape):
                l_cpu, _ = forward(p_cpu, lora_cpu, ids, cfg, lcfg,
                                   cache=init_cache(cfg, 1, S, device="cpu"))
            reset_counts()
            l_gpu, _ = forward(p_gpu, lora_gpu, ids.to(dev), cfg, lcfg,
                               cache=init_cache(cfg, 1, S, device=dev))
            torch.cuda.synchronize()
            counts = read_counts()
            with row_codes(tape, dev):
                l_rep, _ = forward(p_gpu, lora_gpu, ids.to(dev), cfg, lcfg,
                                   cache=init_cache(cfg, 1, S, device=dev))
        want = expected_counts(qmm_nf4_w8a8=7 * cfg.num_layers)
        if counts != want:
            fail(f"parity-int8 prefill launch counts {counts} != {want}")
        # the exact prefill fills the caches the decode steps start from
        c_cpu = init_cache(cfg, 1, S + steps, device="cpu")
        c_gpu = init_cache(cfg, 1, S + steps, device=dev)
        e_cpu, c_cpu = forward(p_cpu, lora_cpu, ids, cfg, lcfg, cache=c_cpu)
        e_gpu, c_gpu = forward(p_gpu, lora_gpu, ids.to(dev), cfg, lcfg, cache=c_gpu)
        compare(f"prefill of {S} tokens, NF4 params (launches {counts['qmm_nf4_w8a8']} "
                "qmm_nf4_w8a8)", l_cpu, l_gpu, l_rep, e_gpu)
        # (a) teacher-forced decode steps on the int8 tree
        c_exact = clone_cache(c_gpu)
        tok = e_cpu[:, -1].argmax(-1, keepdim=True)
        for step in range(steps):
            l_exact, c_exact = forward(p_gpu, lora_gpu, tok.to(dev), cfg, lcfg, cache=c_exact)
            c_rep, tape = clone_cache(c_gpu), []
            with default_impl("w8a8"):
                with row_codes(tape):
                    l_cpu, c_cpu = forward(dec_cpu, lora_cpu, tok, cfg, lcfg, cache=c_cpu)
                l_gpu, c_gpu = forward(dec_gpu, lora_gpu, tok.to(dev), cfg, lcfg, cache=c_gpu)
                with row_codes(tape, dev):
                    l_rep, _ = forward(dec_gpu, lora_gpu, tok.to(dev), cfg, lcfg, cache=c_rep)
            compare(f"decode step {step}, int8 tree", l_cpu[:, -1], l_gpu[:, -1], l_rep[:, -1],
                    l_exact[:, -1])
            tok = l_cpu[:, -1].argmax(-1, keepdim=True)      # teacher-force the CPU's token
    del p_gpu, p_cpu, lora_gpu, lora_cpu, dec_gpu, dec_cpu, c_cpu, c_gpu, c_exact, c_rep
    torch.cuda.empty_cache()
    return worst, counts


def paged_parity_phase(dev):
    """LLaMA-7B width, 2 layers, the same weights on the CPU and the card: a
    126-token prompt prefilled into a contiguous cache and scattered into
    pages (``PagedPool.write_prefill``), then 4 decode steps across a page
    edge and a 5-token verify chunk through ``forward(cache=paged)``, the
    CPU's tokens teacher-forced.  The card's paged logits against the CPU's
    and against the card's own contiguous cache fed the same tokens.
    Returns (the worst of the two, launch counts of the card's paged run)."""
    import torch

    from qlora_tpu_torch.generate.paged import PagedPool
    from qlora_tpu_torch.models import forward, init_cache, init_params
    from qlora_tpu_torch.utils import move_to

    cfg = seven_b(num_layers=2)
    p_gpu = init_params(cfg, seed=13, device=dev)
    lora_gpu, lcfg = random_lora(cfg, dev, seed=14)
    p_cpu, lora_cpu = move_to(p_gpu, "cpu"), move_to(lora_gpu, "cpu")
    S, steps, C = 126, 4, SPEC_DRAFT + 1
    g = torch.Generator().manual_seed(15)
    ids = torch.randint(3, cfg.vocab_size, (1, S), generator=g)
    drafts = torch.randint(3, cfg.vocab_size, (1, C - 1), generator=g)

    def paged_run(p, lora, device, toks=None):
        """Prefill, scatter, decode and verify; the tokens are the argmax of
        this run's logits unless `toks` gives them (the card's run, whose
        launches are counted from the first decode step).  Returns (logits of
        each step, tokens fed, the contiguous cache right after the prefill)."""
        contig = init_cache(cfg, 1, S + steps + C, device=device)
        logits, contig = forward(p, lora, ids.to(device), cfg, lcfg, cache=contig)
        after_prefill = clone_cache(contig)
        pool = PagedPool(cfg, n_pages=8, page_size=PAGE, max_pages_per_seq=4, device=device)
        pool.allocate(1, S)
        pool.write_prefill(1, [k[0, :, :S] for k in contig["k"]],
                           [v[0, :, :S] for v in contig["v"]])
        cache, out, fed = pool.decode_cache([1], [S]), [logits[:, -1].cpu()], []
        if toks is not None:
            reset_counts()
        for step in range(steps + 1):
            tok = (out[-1].argmax(-1, keepdim=True) if toks is None else toks[step])
            inp = tok if step < steps else torch.cat([tok, drafts], 1)
            fed.append(inp)
            n = int(cache["length"][0])
            pool.extend(1, n + inp.shape[1])
            cache = dict(cache, tables=pool.table_array([1]))
            logits, cache = forward(p, lora, inp.to(device), cfg, lcfg, cache=cache)
            out.append(logits[0].cpu() if step == steps else logits[:, -1].cpu())
        return out, fed, after_prefill

    with torch.inference_mode():
        l_cpu, fed, _ = paged_run(p_cpu, lora_cpu, "cpu")
        l_gpu, _, contig = paged_run(p_gpu, lora_gpu, dev, [f[:, :1] for f in fed])
        torch.cuda.synchronize()
        counts = read_counts()
        l_contig = []
        for inp in fed:
            logits, contig = forward(p_gpu, lora_gpu, inp.to(dev), cfg, lcfg, cache=contig)
            l_contig.append(logits[0].cpu() if inp.shape[1] > 1 else logits[:, -1].cpu())
    worst = 0.0
    for step, (a, b, c) in enumerate(zip(l_cpu[1:], l_gpu[1:], l_contig)):
        if not all(torch.isfinite(t).all() for t in (a, b, c)):
            fail(f"paged-parity: non-finite logits at step {step}")
        err, err_contig = (a - b).abs().max().item(), (c - b).abs().max().item()
        worst = max(worst, err, err_contig)
        what = f"verify chunk of {C}" if step == steps else f"decode step {step}"
        print(f"paged-parity {what}: max|logits cpu - card| {err:.4g}, max|card paged - card "
              f"contiguous| {err_contig:.4g} (tol {LOGIT_TOL})", flush=True)
        if err > LOGIT_TOL or err_contig > LOGIT_TOL:
            fail(f"paged-parity {what}: card paged logits differ from the CPU's by {err}, "
                 f"from the contiguous cache's by {err_contig}")
    L = cfg.num_layers
    want = expected_counts(qmm_nf4_fwd_dq=7 * L * (steps + 1),      # 1 row, then the chunk of C
                           qmm_nf4_decode_dq=7 * L * (steps + 1),
                           paged_decode_attention_cuda=L * steps, paged_chunk_attention_cuda=L)
    print(f"paged-parity: launches {counts} (expected {want})", flush=True)
    if counts != want:
        fail(f"paged-parity launch counts {counts} != {want}")
    del p_gpu, p_cpu, lora_gpu, lora_cpu, contig
    torch.cuda.empty_cache()
    return worst


def counters():
    from qlora_tpu_torch.ops import (
        decode_attention_cuda, flash_bwd_dkv, flash_bwd_dq, flash_fwd,
        paged_chunk_attention_cuda, paged_decode_attention_cuda, qmm_i8_bwd, qmm_i8_direct,
        qmm_i8_fwd, qmm_nf4_bwd, qmm_nf4_fwd_dq, qmm_nf4_fwd_f32, qmm_nf4_w8a8,
    )

    return (qmm_nf4_fwd_dq, qmm_nf4_fwd_f32, decode_attention_cuda, qmm_nf4_bwd, flash_fwd,
            flash_bwd_dq, flash_bwd_dkv, qmm_i8_direct, qmm_nf4_w8a8, qmm_i8_fwd, qmm_i8_bwd,
            paged_decode_attention_cuda, paged_chunk_attention_cuda)


# the NF4 forward wrappers also count the launches that took the decode
# kernel (M <= DECODE_ROWS), read as qmm_nf4_decode_dq / _f32, and those that
# took the wgmma kernel (more rows), read as qmm_nf4_wgmma_dq / _f32; the rest
# took the tile kernel of qmm_nf4_fwd.cu, which no LLaMA linear takes.  The
# int8 forward and dx count those that took qmm_i8_wgmma.cu (more than
# DECODE_ROWS rows), read as qmm_i8_wgmma_fwd / _bwd; the rest took qmm_i8.cu
DECODE_COUNTS = {"qmm_nf4_decode_dq": "qmm_nf4_fwd_dq", "qmm_nf4_decode_f32": "qmm_nf4_fwd_f32"}
WGMMA_COUNTS = {"qmm_nf4_wgmma_dq": "qmm_nf4_fwd_dq", "qmm_nf4_wgmma_f32": "qmm_nf4_fwd_f32",
                "qmm_i8_wgmma_fwd": "qmm_i8_fwd", "qmm_i8_wgmma_bwd": "qmm_i8_bwd"}


def expected_counts(**nonzero):
    """Every counter at 0 except the ones named."""
    return {**{w.__name__: 0 for w in counters()}, **{k: 0 for k in DECODE_COUNTS},
            **{k: 0 for k in WGMMA_COUNTS}, **nonzero}


def reset_counts():
    for w in counters():
        for attr in ("launches", "decode_launches", "wgmma_launches"):
            if hasattr(w, attr):
                setattr(w, attr, 0)


def read_counts():
    by_name = {w.__name__: w for w in counters()}
    return {**{n: w.launches for n, w in by_name.items()},
            **{k: by_name[n].decode_launches for k, n in DECODE_COUNTS.items()},
            **{k: by_name[n].wgmma_launches for k, n in WGMMA_COUNTS.items()}}


def padded_requests(lengths, S, vocab, seed):
    import torch

    g = torch.Generator().manual_seed(seed)
    ids = torch.zeros((len(lengths), S), dtype=torch.long)
    for b, n in enumerate(lengths):
        ids[b, :n] = torch.randint(3, vocab, (n,), generator=g)
    return ids, torch.tensor(lengths, dtype=torch.int32)


def timed_prefill(dev, cfg, params, lora, lcfg, ids, lengths):
    """Seconds of one prefill of the serve requests on the exact params, as
    ``generate`` runs it first under either decode path; each run times its
    own, just after its ``generate``, and takes it off its total."""
    import torch

    from qlora_tpu_torch.generate.engine import prefill
    from qlora_tpu_torch.models import init_cache

    with torch.inference_mode():
        cache = init_cache(cfg, 4, max(SERVE_LENGTHS) + SERVE_NEW, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, lora, ids.to(dev), lengths.to(dev), cfg, lcfg, cache=cache)
        torch.cuda.synchronize()
        return time.perf_counter() - t0


def serve_phase(dev):
    import torch

    from qlora_tpu_torch.generate import generate
    from qlora_tpu_torch.models import init_params

    cfg = seven_b()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=7, device=dev)
    lora, lcfg = random_lora(cfg, dev, seed=8)
    torch.cuda.synchronize()
    print(f"serve: LLaMA-7B {cfg.num_layers} layers, random NF4 weights (double quant) "
          f"+ rank-{lcfg.r} LoRA, made in {time.perf_counter() - t0:.1f} s", flush=True)
    ids, lengths = padded_requests(SERVE_LENGTHS, max(SERVE_LENGTHS), cfg.vocab_size, 9)
    # warm-up outside the counted run: allocator and cuBLAS handles
    generate(params, lora, ids[:, :16], torch.full((4,), 16), cfg, lcfg,
             max_new_tokens=2, eos_id=-1, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_counts()
    t0 = time.perf_counter()
    toks = generate(params, lora, ids, lengths, cfg, lcfg,
                    max_new_tokens=SERVE_NEW, eos_id=-1, device=dev)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    prefill_s = timed_prefill(dev, cfg, params, lora, lcfg, ids, lengths)
    n_lin = 7 * cfg.num_layers
    want = expected_counts(qmm_nf4_fwd_dq=n_lin * (SERVE_NEW + 1),
                           qmm_nf4_decode_dq=n_lin * SERVE_NEW,       # 4 rows: the decode kernel
                           qmm_nf4_wgmma_dq=n_lin,                    # the prefill: wgmma
                           decode_attention_cuda=cfg.num_layers * SERVE_NEW)
    decode_s = total_s - prefill_s
    print(f"serve: generated {tuple(toks.shape)} tokens in {total_s:.3f} s; prefill "
          f"{prefill_s * 1e3:.1f} ms (4 x 512 padded), decode {decode_s * 1e3:.1f} ms = "
          f"{toks.numel() / decode_s:.1f} tok/s, {decode_s / SERVE_NEW * 1e3:.2f} ms/step; "
          f"peak memory {peak_gib:.2f} GiB", flush=True)
    print(f"serve: launches {counts} (expected {want}: {n_lin} qmm per forward, on the wgmma "
          f"kernel in the prefill and on the decode kernel in each decode step, "
          f"{cfg.num_layers} decode-attention per decode step)",
          flush=True)
    if counts != want:
        fail(f"serve launch counts {counts} != {want}")
    if toks.shape != (4, SERVE_NEW) or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        fail("serve: tokens out of range or wrong shape")
    stats = dict(prefill_ms=prefill_s * 1e3, decode_ms_per_step=decode_s / SERVE_NEW * 1e3,
                 decode_tok_s=toks.numel() / decode_s, peak_gib=peak_gib)
    int8_counts, int8_stats = serve_int8(dev, cfg, params, lora, lcfg, ids, lengths, toks)
    t0 = time.perf_counter()
    paged = serve_paged_phase(dev, cfg, params, lora, lcfg)
    print(f"serve-paged: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    spec = serve_paged_spec_phase(dev, cfg, params, lora, lcfg)
    print(f"serve-paged-spec: {time.perf_counter() - t0:.1f} s", flush=True)
    del params, lora
    torch.cuda.empty_cache()
    return counts, stats, int8_counts, int8_stats, paged, spec


def serve_int8(dev, cfg, params, lora, lcfg, ids, lengths, nf4_toks):
    """The serve phase's requests again through ``decode_impl="int8"``: the
    prefill on the NF4 params (the exact path), every decode step on a
    per-column int8 serving tree made once."""
    import torch

    from qlora_tpu_torch.generate import generate
    from qlora_tpu_torch.generate.serve_int8 import requantize_params_int8_unstacked
    from qlora_tpu_torch.models.layers import QLinear

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        dec = requantize_params_int8_unstacked(params)
    torch.cuda.synchronize()
    requant_s = time.perf_counter() - t0
    tree_bytes = sum(v.qt.nbytes for b in dec["blocks"] for v in b.values()
                   if isinstance(v, QLinear)) + dec["lm_head"].qt.nbytes
    print(f"serve-int8: per-column int8 serving tree requantized in {requant_s:.2f} s, "
          f"{tree_bytes / 2 ** 30:.2f} GiB (lm_head {tuple(dec['lm_head'].qt.packed.shape)})",
          flush=True)
    kw = dict(eos_id=-1, device=dev, decode_impl="int8", decode_params=dec)
    generate(params, lora, ids[:, :16], torch.full((4,), 16), cfg, lcfg, max_new_tokens=2, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_counts()
    t0 = time.perf_counter()
    toks = generate(params, lora, ids, lengths, cfg, lcfg, max_new_tokens=SERVE_NEW, **kw)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    prefill_s = timed_prefill(dev, cfg, params, lora, lcfg, ids, lengths)
    n_lin = 7 * cfg.num_layers
    want = expected_counts(qmm_nf4_fwd_dq=n_lin,                       # the prefill, exact
                           qmm_nf4_wgmma_dq=n_lin,
                           qmm_i8_direct=(n_lin + 1) * SERVE_NEW,      # + 1: the lm_head
                           decode_attention_cuda=cfg.num_layers * SERVE_NEW)
    decode_s = total_s - prefill_s
    agree = (toks == nf4_toks).float().mean().item()
    print(f"serve-int8: generated {tuple(toks.shape)} tokens in {total_s:.3f} s; decode "
          f"{decode_s * 1e3:.1f} ms = {toks.numel() / decode_s:.1f} tok/s, "
          f"{decode_s / SERVE_NEW * 1e3:.2f} ms/step (its prefill, on the exact params, "
          f"{prefill_s * 1e3:.1f} ms); peak memory {peak_gib:.2f} GiB; {agree:.2f} of the tokens equal "
          "the NF4 run's", flush=True)
    print(f"serve-int8: launches {counts} (expected {want}: the prefill's {n_lin} on the NF4 "
          f"kernel, {n_lin} + 1 qmm_i8_direct and {cfg.num_layers} decode-attention per decode "
          "step)", flush=True)
    if counts != want:
        fail(f"serve-int8 launch counts {counts} != {want}")
    if toks.shape != (4, SERVE_NEW) or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        fail("serve-int8: tokens out of range or wrong shape")
    # the first token comes from the prefill's logits, which both runs compute alike
    if not torch.equal(toks[:, 0], nf4_toks[:, 0]):
        fail("serve-int8: the first tokens differ from the NF4 run's")
    del dec
    return counts, dict(decode_ms_per_step=decode_s / SERVE_NEW * 1e3,
                        decode_tok_s=toks.numel() / decode_s, peak_gib=peak_gib,
                        requantize_s=requant_s, tokens_equal=agree)


def paged_traffic(vocab, seed, n):
    """`n` requests: prompt lengths uniform in 64-512, max_new_tokens uniform
    in 16-64, token ids uniform, from `seed`."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens, news = rng.integers(64, 513, size=n), rng.integers(16, 65, size=n)
    return [(rng.integers(3, vocab, size=int(L)).tolist(), int(m)) for L, m in zip(lens, news)]


def phrase_traffic(vocab, seed, n):
    """`n` requests whose prompts repeat one seeded 16-token phrase 4 to 32
    times (64-512 tokens), max_new_tokens uniform in 16-64."""
    import numpy as np

    rng = np.random.default_rng(seed)
    phrase = rng.integers(3, vocab, size=16).tolist()
    return [(phrase * int(rng.integers(4, 33)), int(rng.integers(16, 65))) for _ in range(n)]


def instrument(pb):
    """Count a batcher's decode, verify and prefill forwards and time its
    decode steps and admissions on the host clock (each ends in a host read
    of the sampled tokens; a synchronize closes it), by wrapping its methods."""
    import torch

    st = dict(decode=0, verify=0, prefill=0, prefill_rows=[], steps=0, step_s=0.0,
              verify_steps=0, verify_s=0.0, admit_s=0.0)
    fwd, pre, step, admit = pb._decode_forward, pb._prefill_rows, pb._decode_step, pb._admit

    def decode_forward(toks, cache):
        st["decode" if toks.shape[1] == 1 else "verify"] += 1
        return fwd(toks, cache)

    def prefill_rows(ids, *a):
        st["prefill"] += 1
        st["prefill_rows"].append(ids.numel())
        return pre(ids, *a)

    def decode_step():
        t0, v0 = time.perf_counter(), st["verify"]
        out = step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        st["steps"] += 1
        st["step_s"] += dt
        if st["verify"] > v0:
            st["verify_steps"] += 1
            st["verify_s"] += dt
        return out

    def timed_admit():
        t0 = time.perf_counter()
        admit()
        torch.cuda.synchronize()
        st["admit_s"] += time.perf_counter() - t0

    pb._decode_forward, pb._prefill_rows = decode_forward, prefill_rows
    pb._decode_step, pb._admit = decode_step, timed_admit
    return st


def serve_paged_run(tag, dev, cfg, params, lora, lcfg, traffic, n_pages, **kw):
    """One ``PagedBatcher`` run over `traffic`: every request must end with
    exactly its max_new_tokens in-vocabulary tokens and the pool must be
    fully recycled.  Returns (engine, instrument stats, launch counts, stats)."""
    import torch

    from qlora_tpu_torch.generate.paged import PagedBatcher

    pb = PagedBatcher(params, lora, cfg, lcfg, n_pages=n_pages, device=dev,
                      **{**SERVE_PAGED, **kw})
    st = instrument(pb)
    reqs = [pb.submit(p, max_new_tokens=n) for p, n in traffic]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    pb.run_to_completion()
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    bad = [r.uid for r, (_, n) in zip(reqs, traffic)
           if not (r.done and len(r.generated) == n
                   and all(0 <= t < cfg.vocab_size for t in r.generated))]
    if bad:
        fail(f"{tag}: requests {bad} did not end with exactly their max_new_tokens "
             "in-vocabulary tokens")
    if pb.pool.n_free != n_pages - 1 or pb.pool.tables:
        fail(f"{tag}: the pool is not recycled ({pb.pool.n_free} of {n_pages - 1} free, "
             f"tables {sorted(pb.pool.tables)})")
    tokens = sum(len(r.generated) for r in reqs)
    stats = dict(total_s=total_s, tokens=tokens, tok_s=tokens / total_s,
                 ms_per_step=st["step_s"] / max(st["steps"], 1) * 1e3,
                 admit_s=st["admit_s"], peak_gib=peak_gib, preemptions=pb.preemptions,
                 decode_forwards=st["decode"], verify_forwards=st["verify"],
                 prefill_forwards=st["prefill"])
    rows = {m: st["prefill_rows"].count(m) for m in sorted(set(st["prefill_rows"]))}
    print(f"{tag}: {len(reqs)} requests, {tokens} tokens in {total_s:.3f} s = "
          f"{stats['tok_s']:.1f} tok/s; {st['steps']} decode steps, "
          f"{stats['ms_per_step']:.2f} ms/step; admissions {st['admit_s'] * 1e3:.1f} ms "
          f"({st['prefill']} prefill forwards, token rows: count {rows}); {pb.preemptions} "
          f"preemptions; pool {n_pages} pages, recycled; peak memory {peak_gib:.2f} GiB",
          flush=True)
    return pb, st, counts, stats


def serve_paged_phase(dev, cfg, params, lora, lcfg):
    """serve-paged: the serve phase's weights through ``PagedBatcher`` on 16
    requests over a pool that preempts, with the NF4 path and then with
    ``decode_impl="int8", prefill_impl="w8a8"``; exact launch counts from
    the counted forwards."""
    import torch

    traffic = paged_traffic(cfg.vocab_size, SERVE_PAGED_SEED, SERVE_PAGED_REQUESTS)
    L, n_lin = cfg.num_layers, 7 * cfg.num_layers
    pb, st, counts, stats = serve_paged_run("serve-paged", dev, cfg, params, lora, lcfg,
                                            traffic, SERVE_PAGED_PAGES)
    fwds = st["decode"] + st["prefill"]
    want = expected_counts(qmm_nf4_fwd_dq=n_lin * fwds,
                           qmm_nf4_decode_dq=n_lin * st["decode"],    # 8 rows a decode forward
                           qmm_nf4_wgmma_dq=n_lin * st["prefill"],    # >= 128 rows a prefill
                           paged_decode_attention_cuda=L * st["decode"])
    print(f"serve-paged: launches {counts} (expected {want}: {n_lin} qmm per forward, on the "
          f"decode kernel in each decode forward and on the wgmma kernel in each prefill, {L} "
          "paged decode attention per decode forward)", flush=True)
    if counts != want:
        fail(f"serve-paged launch counts {counts} != {want}")
    if pb.preemptions < 1:
        fail("serve-paged: no preemption; the pool is not small enough for this traffic")
    del pb
    torch.cuda.empty_cache()

    pb, st8, counts8, stats8 = serve_paged_run(
        "serve-paged-int8", dev, cfg, params, lora, lcfg, traffic, SERVE_PAGED_PAGES,
        decode_impl="int8", prefill_impl="w8a8")
    want8 = expected_counts(qmm_i8_direct=(n_lin + 1) * st8["decode"],    # + 1: the lm_head
                            qmm_nf4_w8a8=n_lin * st8["prefill"],
                            paged_decode_attention_cuda=L * st8["decode"])
    print(f"serve-paged-int8: launches {counts8} (expected {want8}: {n_lin} + 1 qmm_i8_direct "
          f"per decode forward, {n_lin} qmm_nf4_w8a8 per prefill forward, no NF4 qmm)",
          flush=True)
    if counts8 != want8:
        fail(f"serve-paged-int8 launch counts {counts8} != {want8}")
    del pb
    torch.cuda.empty_cache()
    return counts, stats, counts8, stats8


def serve_paged_spec_phase(dev, cfg, params, lora, lcfg):
    """serve-paged-spec: verify chunks of SPEC_DRAFT prompt-lookup drafts plus
    the pending token, on prompts that repeat a phrase.  Acceptance is left
    to the random weights; the launch counts follow the counted forwards."""
    import torch

    from qlora_tpu_torch.ops.qmatmul import DECODE_ROWS

    traffic = phrase_traffic(cfg.vocab_size, 5, SPEC_REQUESTS)
    L, n_lin = cfg.num_layers, 7 * cfg.num_layers
    pb, st, counts, stats = serve_paged_run("serve-paged-spec", dev, cfg, params, lora, lcfg,
                                            traffic, SPEC_PAGES, spec_draft_len=SPEC_DRAFT)
    fwds = st["decode"] + st["verify"] + st["prefill"]
    verify_rows = SERVE_PAGED["num_slots"] * (SPEC_DRAFT + 1)
    want = expected_counts(qmm_nf4_fwd_dq=n_lin * fwds,
                           qmm_nf4_decode_dq=n_lin * (st["decode"] + st["verify"] * (
                               verify_rows <= DECODE_ROWS)),
                           qmm_nf4_wgmma_dq=n_lin * (st["prefill"] + st["verify"] * (
                               verify_rows > DECODE_ROWS)),
                           paged_decode_attention_cuda=L * st["decode"],
                           paged_chunk_attention_cuda=L * st["verify"])
    per_chunk = pb.spec_tokens / max(pb.spec_chunks, 1)
    ms_chunk = st["verify_s"] / max(st["verify_steps"], 1) * 1e3
    stats.update(tokens_per_chunk=per_chunk, ms_per_chunk=ms_chunk, chunks=pb.spec_chunks)
    print(f"serve-paged-spec: {st['verify']} verify forwards ({pb.spec_chunks} slot chunks, "
          f"{per_chunk:.3f} tokens retired per chunk, {ms_chunk:.2f} ms per verify step), "
          f"{st['decode']} plain decode forwards near capacity; launches {counts} "
          f"(expected {want})", flush=True)
    if counts != want:
        fail(f"serve-paged-spec launch counts {counts} != {want}")
    if st["verify"] < 1:
        fail("serve-paged-spec: no verify chunk ran")
    del pb
    torch.cuda.empty_cache()
    return counts, stats


def nodq_phase(dev):
    import torch

    from qlora_tpu_torch.generate import generate
    from qlora_tpu_torch.models import init_params

    cfg = seven_b(num_layers=2)
    params = init_params(cfg, seed=11, device=dev, double_quant=False)
    ids, lengths = padded_requests((64, 40), 64, cfg.vocab_size, 12)
    new = 16
    reset_counts()
    toks = generate(params, None, ids, lengths, cfg, max_new_tokens=new, eos_id=-1,
                    device=dev)
    torch.cuda.synchronize()
    counts = read_counts()
    want = expected_counts(qmm_nf4_fwd_f32=7 * cfg.num_layers * (new + 1),
                           qmm_nf4_decode_f32=7 * cfg.num_layers * new,
                           qmm_nf4_wgmma_f32=7 * cfg.num_layers,       # the prefill
                           decode_attention_cuda=cfg.num_layers * new)
    print(f"nodq: generated {tuple(toks.shape)} tokens; launches {counts} "
          f"(expected {want})", flush=True)
    if counts != want or toks.shape != (2, new):
        fail(f"nodq launch counts {counts} != {want}")
    del params
    torch.cuda.empty_cache()
    return counts


class SeededTokenizer:
    """Stands in for a tokenizer: a text is a run of token ids in decimal."""
    bos_token_id, eos_token_id, pad_token_id = 1, 2, 0

    def encode(self, text):
        return [int(t) for t in text.split()]


def collated_batch(vocab, rows, S, seed, stacked):
    """`stacked` micro-batches of `rows` collated examples each, right-padded
    to S, with unequal source and target lengths and -100 on source tokens
    and padding; [stacked, rows, S] arrays, or [rows, S] when stacked is 0."""
    import numpy as np

    from qlora_tpu_torch.train import CausalCollator

    rng = np.random.default_rng(seed)
    text = lambda n: " ".join(str(t) for t in rng.integers(3, vocab, size=n))
    collate = CausalCollator(SeededTokenizer(), source_max_len=S - S // 4,
                             target_max_len=S // 4, pad_to=S)
    micro = []
    for _ in range(max(stacked, 1)):
        inst = [{"input": text(int(rng.integers(S // 8, S - S // 4))),
                 "output": text(int(rng.integers(S // 16, S // 4)))} for _ in range(rows)]
        micro.append(collate(inst))
    if not stacked:
        return micro[0]
    return {k: np.stack([m[k] for m in micro]) for k in micro[0]}


def qmm_counters(quant_type):
    """The names of the (forward, backward) qmm counters a base of this
    storage runs through (double-quantized absmax)."""
    return ("qmm_i8_fwd", "qmm_i8_bwd") if quant_type == "int8" else (
        "qmm_nf4_fwd_dq", "qmm_nf4_bwd")


def train_parity_phase(dev, quant_type="nf4"):
    import torch

    from qlora_tpu_torch.models import init_params
    from qlora_tpu_torch.train import loss_fn
    from qlora_tpu_torch.train.optimizer import tree_leaves, tree_unflatten
    from qlora_tpu_torch.utils import move_to

    tag = "train-parity" if quant_type == "nf4" else f"train-parity-{quant_type}"
    fwd_name, bwd_name = qmm_counters(quant_type)
    cfg = seven_b(num_layers=2)
    p_gpu = init_params(cfg, seed=21, device=dev, quant_type=quant_type)
    lora_gpu, lcfg = random_lora(cfg, dev, seed=22)
    p_cpu, lora_cpu = move_to(p_gpu, "cpu"), move_to(lora_gpu, "cpu")
    batch = collated_batch(cfg.vocab_size, 2, 256, seed=23, stacked=0)
    lengths = batch["attention_mask"].sum(-1).tolist()

    def run(params, lora, device):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(lora)]
        mb = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        loss, n = loss_fn(tree_unflatten(lora, leaves), params, mb, cfg, lcfg, None, True,
                          "lora", "full")
        return loss.detach(), int(n), torch.autograd.grad(loss, leaves)

    reset_counts()
    loss_g, n_g, grads_g = run(p_gpu, lora_gpu, dev)
    torch.cuda.synchronize()
    counts = read_counts()
    loss_c, n_c, grads_c = run(p_cpu, lora_cpu, "cpu")
    names = [f"layer {i} {name}.{k}" for i, layer in enumerate(lora_cpu)
             for name, ad in layer.items() for k in ad]
    worst, worst_name = 0.0, ""
    for name, gg, gc in zip(names, grads_g, grads_c):
        if not torch.isfinite(gg).all() or gc.norm() == 0:
            fail(f"{tag}: gradient of {name} is not finite on the card or 0 on the CPU")
        rel = ((gg.cpu().float() - gc.float()).norm() / gc.float().norm()).item()
        if rel > worst:
            worst, worst_name = rel, name
    d_loss = abs(loss_g.item() - loss_c.item())
    # one forward, one recomputed forward and one backward over 2 layers; the
    # first layer's wq, wk, wv get an input without a gradient: no dx for them
    L = cfg.num_layers
    want = expected_counts(**{fwd_name: 2 * 7 * L, bwd_name: 7 * L - 3}, flash_fwd=2 * L,
                           flash_bwd_dq=L, flash_bwd_dkv=L,
                           **({"qmm_nf4_wgmma_dq": 2 * 7 * L} if quant_type == "nf4" else
                              {"qmm_i8_wgmma_fwd": 2 * 7 * L, "qmm_i8_wgmma_bwd": 7 * L - 3}))
    print(f"{tag}: 2 x 256 collated tokens (lengths {lengths}, {n_c} target tokens); "
          f"loss card {loss_g.item():.5f} cpu {loss_c.item():.5f} |d|={d_loss:.3g} "
          f"(tol {LOSS_TOL}); {len(names)} LoRA gradients, worst |g_card - g_cpu|/|g_cpu| = "
          f"{worst:.4g} at {worst_name} (tol {GRAD_TOL}); launches {counts}", flush=True)
    if n_g != n_c or d_loss > LOSS_TOL or worst > GRAD_TOL:
        fail(f"{tag}: loss differs by {d_loss}, worst gradient by {worst} ({worst_name})")
    if counts != want:
        fail(f"{tag} launch counts {counts} != {want}")
    del p_gpu, p_cpu, lora_gpu, lora_cpu, grads_g, grads_c
    torch.cuda.empty_cache()
    return worst


def frozen_tensors(params):
    """Every tensor of the base model: packed nibbles, absmax, meta-scales
    and offsets of each block linear, the norms, embed and lm_head."""
    import torch

    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(params)
    return out


def train_phase(dev, quant_type="nf4", steps=TRAIN_STEPS):
    import torch

    from qlora_tpu_torch.lora import LoraConfig, count_lora_params
    from qlora_tpu_torch.models import init_lora_params, init_params
    from qlora_tpu_torch.train import init_train_state, make_optimizer, make_train_step

    tag = "train" if quant_type == "nf4" else f"train-{quant_type}"
    fwd_name, bwd_name = qmm_counters(quant_type)
    cfg = seven_b()
    rows, S = TRAIN_MICRO
    t0 = time.perf_counter()
    params = init_params(cfg, seed=31, device=dev, quant_type=quant_type)
    lcfg = LoraConfig(r=64, alpha=16.0, dropout=0.0)
    lora = init_lora_params(cfg, lcfg, seed=32, device=dev)          # B = 0: a fresh adapter
    torch.cuda.synchronize()
    print(f"{tag}: LLaMA-7B {cfg.num_layers} layers, random {quant_type} weights (double "
          f"quant) + a fresh rank-{lcfg.r} LoRA on all 7 block linears ({count_lora_params(lora) / 1e6:.1f}"
          f" M parameters), made in {time.perf_counter() - t0:.1f} s", flush=True)
    frozen = frozen_tensors(params)
    if any(t.requires_grad for t in frozen):
        fail(f"{tag}: a frozen tensor asks for a gradient")
    before = [t.clone() for t in frozen]

    opt = make_optimizer("paged_adamw_32bit", TRAIN_LR, total_steps=steps)
    state = init_train_state(lora, opt, device=dev)
    step = make_train_step(cfg, lcfg, opt, accum_steps=TRAIN_ACCUM, remat="full", device=dev)
    batch = collated_batch(cfg.vocab_size, rows, S, seed=33, stacked=TRAIN_ACCUM)
    real = int(batch["attention_mask"].sum())
    targets = int((batch["labels"][..., 1:] != -100).sum())

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    metrics, secs = [], []
    for _ in range(steps):
        t1 = time.perf_counter()
        state, m = step(state, params, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t1)
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    counts = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    # per optimizer step, TRAIN_ACCUM micro-batches, L layers, 7 block linears each:
    #   qmm forward   7 L in the forward + 7 L in the backward's recomputed forward (remat)
    #   qmm backward  7 L - 3: layer 0's wq, wk, wv see the embeddings, which need no gradient
    #   flash forward L + L recomputed; flash dq L; flash dk, dv L
    L = cfg.num_layers
    per_step = expected_counts(
        **{fwd_name: TRAIN_ACCUM * 2 * 7 * L,         # 2 * 448 = 896
           bwd_name: TRAIN_ACCUM * (7 * L - 3)},      # 2 * 221 = 442
        flash_fwd=TRAIN_ACCUM * 2 * L,                # 128
        flash_bwd_dq=TRAIN_ACCUM * L,                 # 64
        flash_bwd_dkv=TRAIN_ACCUM * L,                # 64
        # M = 1024 rows: every NF4 forward, and every int8 forward and dx, on
        # a wgmma kernel
        **({"qmm_nf4_wgmma_dq": TRAIN_ACCUM * 2 * 7 * L} if quant_type == "nf4" else
           {"qmm_i8_wgmma_fwd": TRAIN_ACCUM * 2 * 7 * L,
            "qmm_i8_wgmma_bwd": TRAIN_ACCUM * (7 * L - 3)}))
    want = {k: v * steps for k, v in per_step.items()}
    step_s = sum(secs[1:]) / (steps - 1)        # the first step warms the allocator
    losses = [m[0] for m in metrics]
    print(f"{tag}: " + "; ".join(f"step {i} loss {l:.5f} grad_norm {g:.5f} {t:.2f} s"
                                for i, ((l, g), t) in enumerate(zip(metrics, secs))), flush=True)
    print(f"{tag}: {step_s:.3f} s per optimizer step (mean of steps 1..{steps - 1}; "
          f"{TRAIN_ACCUM} micro-batches of {rows} x {S}) = "
          f"{TRAIN_ACCUM * rows * S / step_s:.1f} padded tokens/s, {real / step_s:.1f} real "
          f"tokens/s ({real} real, {targets} target tokens per step); peak memory "
          f"{peak_gib:.2f} GiB", flush=True)
    print(f"{tag}: launches {counts} (expected {steps} x {per_step})", flush=True)
    if counts != want:
        fail(f"{tag} launch counts {counts} != {want}")
    if not torch.isfinite(torch.tensor(metrics)).all():
        fail(f"{tag}: a loss or gradient norm is not finite: {metrics}")
    if min(m[1] for m in metrics) <= 0:
        fail(f"{tag}: a gradient norm is 0: {metrics}")
    # the schedule's first learning rate is 0: step 1 sees the weights of step 0
    if abs(losses[1] - losses[0]) > 1e-3:
        fail(f"{tag}: the first step moved the loss ({losses[0]} -> {losses[1]})")
    if not losses[-1] < losses[0]:
        fail(f"{tag}: the loss did not fall ({losses})")
    if state.step != steps:
        fail(f"{tag}: state.step is {state.step}")
    changed = sum(not torch.equal(a, b) for a, b in zip(before, frozen_tensors(params)))
    print(f"{tag}: {len(before)} frozen tensors byte-identical after {steps} steps: "
          f"{changed == 0}", flush=True)
    if changed:
        fail(f"{tag}: {changed} frozen tensors changed")
    del params, lora, state, before
    torch.cuda.empty_cache()
    return counts, per_step, dict(step_s=step_s, padded_tok_s=TRAIN_ACCUM * rows * S / step_s,
                                  real_tok_s=real / step_s, peak_gib=peak_gib, losses=losses)


def train_split(results, per_step, stats, quant_type="nf4"):
    """Split the optimizer step by kernel: each kernel's launches per step
    times its kernel-phase time at the train shape (M = 1024, S = 512).  What
    is left is the plain PyTorch ops (LoRA products and their backward, norms,
    RoPE, SwiGLU, lm_head, the loss, AdamW) and the gaps between launches."""
    at = lambda name, start: next(r["ms"] for r in results
                                  if r["name"] == name and r["shape"].startswith(start))
    M = QMM_BWD_ROWS
    layers = seven_b().num_layers
    fwd_name, bwd_name = qmm_counters(quant_type)
    # per layer: wq, wk, wv, wo (4096 -> 4096), w_gate, w_up (4096 -> 11008), w_down
    fwd = (4 * at(fwd_name, f"M={M} K=4096 N=4096")
           + 2 * at(fwd_name, f"M={M} K=4096 N=11008")
           + at(fwd_name, f"M={M} K=11008 N=4096"))
    fwd_ms = fwd * per_step[fwd_name] / 7
    sq, up, down = (at(bwd_name, f"M={M} K={k} N={n} dq") for k, n in QMM_SHAPES)
    per_micro = layers * (4 * sq + 2 * up + down) - 3 * sq       # layer 0: no dx for q, k, v
    bwd_ms = per_micro * per_step[bwd_name] / (7 * layers - 3)
    head = "B=2 H=32 KVH=32 hd=128 S=512 lens=[512, 300]"
    flash = {n: at(n, head) * per_step[n] for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    step_ms = stats["step_s"] * 1e3
    other = step_ms - fwd_ms - bwd_ms - sum(flash.values())
    return dict(step_ms=step_ms, qmm_fwd_ms=fwd_ms, qmm_bwd_ms=bwd_ms, other_ms=other,
                **{f"{n}_ms": v for n, v in flash.items()})


SOURCES = {    # the two NF4 forward entries: the decode kernel at their headline (M = 4)
    "qmm_nf4_fwd_dq": ("qlora_tpu_torch/csrc/qmm_nf4_decode.cu",
                       "qlora_tpu/ops/qmatmul.py:592 (_qmm_pallas_dq)"),
    "qmm_nf4_fwd_f32": ("qlora_tpu_torch/csrc/qmm_nf4_decode.cu",
                        "qlora_tpu/ops/qmatmul.py:521 (_qmm_pallas)"),
    "decode_attention_cuda": ("qlora_tpu_torch/csrc/decode_attention.cu",
                              "qlora_tpu/ops/decode_attention.py:207 (fused_decode_attention)"),
    "qmm_nf4_bwd": ("qlora_tpu_torch/csrc/qmm_nf4_bwd.cu",
                    "qlora_tpu/ops/qmatmul.py:651 (_qmm_bwd_pallas)"),
    "flash_fwd": ("qlora_tpu_torch/csrc/flash_attention.cu",
                  "qlora_tpu/ops/flash_attention.py:196 (_flash_fwd)"),
    "flash_bwd_dq": ("qlora_tpu_torch/csrc/flash_attention.cu",
                     "qlora_tpu/ops/flash_attention.py:419 (_flash_bwd, pallas_call at :449)"),
    "flash_bwd_dkv": ("qlora_tpu_torch/csrc/flash_attention.cu",
                      "qlora_tpu/ops/flash_attention.py:419 (_flash_bwd, pallas_call at :476)"),
    "qmm_i8_direct": ("qlora_tpu_torch/csrc/qmm_i8_direct.cu",
                      "qlora_tpu/ops/qmatmul.py:325 (_qmm_pallas_i8_direct)"),
    "qmm_nf4_w8a8": ("qlora_tpu_torch/csrc/qmm_i8_direct.cu",
                     "qlora_tpu/ops/qmatmul.py:239 (_qmm_pallas_w8a8)"),
    # the int8 forward and dx: the wgmma kernel at their headline (M = 1024)
    "qmm_i8_fwd": ("qlora_tpu_torch/csrc/qmm_i8_wgmma.cu",
                   "qlora_tpu/ops/qmatmul.py:432 (_qmm_pallas_i8)"),
    "qmm_i8_bwd": ("qlora_tpu_torch/csrc/qmm_i8_wgmma.cu",
                   "qlora_tpu/ops/qmatmul.py:475 (_qmm_bwd_pallas_i8)"),
    "paged_decode_attention_cuda": ("qlora_tpu_torch/csrc/paged_attention.cu",
                                    "qlora_tpu/ops/paged_attention.py:217 "
                                    "(fused_paged_decode_attention)"),
    "paged_chunk_attention_cuda": ("qlora_tpu_torch/csrc/paged_attention.cu",
                                   "qlora_tpu/ops/paged_attention.py:478 "
                                   "(fused_paged_chunk_attention)"),
}
# the NF4 forward's three sources, by shape (ops/qmatmul.py: DECODE_ROWS, tile_plan)
NF4_SOURCES = {"M <= 16": "qlora_tpu_torch/csrc/qmm_nf4_decode.cu",
               "M > 16": "qlora_tpu_torch/csrc/qmm_nf4_wgmma.cu",
               "M > 16, K % 8 != 0": "qlora_tpu_torch/csrc/qmm_nf4_fwd.cu"}
# the int8 forward's and dx's two sources, by shape (ops/qmatmul.py: i8_tile_plan)
I8_SOURCES = {"M > 16": "qlora_tpu_torch/csrc/qmm_i8_wgmma.cu",
              "M <= 16, or a contraction % 8 != 0": "qlora_tpu_torch/csrc/qmm_i8.cu"}
TRAIN_HEADLINE = "M=1024 K=4096 N=4096"   # the wgmma kernel's entry: the train step's commonest
# the shape each kernel's summary entry reports: the decode step's most
# common launch (4096 -> 4096 at batch 4), the serving-shape attention, and
# the train step's micro-batch (M = 1024 rows; 2 x 32 heads x 512 tokens)
HEADLINE = {"qmm_nf4_fwd_dq": "M=4 K=4096 N=4096", "qmm_nf4_fwd_f32": "M=4 K=4096 N=4096",
            "decode_attention_cuda": "B=4 H=32 KVH=32",
            "qmm_nf4_bwd": "M=1024 K=4096 N=4096 dq",
            "flash_fwd": "B=2 H=32 KVH=32 hd=128 S=512 lens=[512, 300]",
            "flash_bwd_dq": "B=2 H=32 KVH=32 hd=128 S=512 lens=[512, 300]",
            "flash_bwd_dkv": "B=2 H=32 KVH=32 hd=128 S=512 lens=[512, 300]",
            # the int8 decode step's most common launch, the serve-paged w8a8 prefill's
            # commonest (one row at bucket 512; the run whose launches the w8a8 kernel's
            # entry counts), the int8 base's train step
            "qmm_i8_direct": "M=4 K=4096 N=4096", "qmm_nf4_w8a8": "M=512 K=4096 N=4096",
            "qmm_i8_fwd": "M=1024 K=4096 N=4096 dq", "qmm_i8_bwd": "M=1024 K=4096 N=4096 dq",
            # serve-paged's decode step and its verify chunk, full attention
            "paged_decode_attention_cuda": "B=8 H=32 KVH=32",
            "paged_chunk_attention_cuda": "B=8 C=5 H=32 KVH=32"}


def qmm_ms_per_forward(results, num_layers, M):
    """The 7 block linears of every layer at M rows, each at its time alone
    in the kernel phase (double-quant variant, operands out of L2)."""
    ms = {r["shape"]: r["ms"] for r in results if r["name"] == "qmm_nf4_fwd_dq"}
    lin = {k: ms[f"M={M} K={k[0]} N={k[1]}"] for k in QMM_SHAPES}
    return num_layers * (4 * lin[(4096, 4096)] + 2 * lin[(4096, 11008)] + lin[(11008, 4096)])


def serve_split(results, num_layers, stats):
    """Split the serve run's prefill and decode step by kernel: each
    kernel's launches times its kernel-phase time.  What is left is the
    plain PyTorch ops (LoRA, norms, RoPE, prefill attention, lm_head,
    sampling) and the gaps between launches."""
    attn = num_layers * next(r["ms"] for r in results if r["name"] == "decode_attention_cuda")
    qmm_prefill = qmm_ms_per_forward(results, num_layers, QMM_ROWS[0])
    qmm_step = qmm_ms_per_forward(results, num_layers, len(SERVE_LENGTHS))
    step = stats["decode_ms_per_step"]
    return dict(prefill_ms=stats["prefill_ms"], prefill_qmm_ms=qmm_prefill,
                step_ms=step, step_qmm_ms=qmm_step, step_attention_ms=attn,
                step_other_ms=step - qmm_step - attn)


def serve_int8_split(results, num_layers, stats):
    """The int8 decode step by kernel, as :func:`serve_split`: 7 launches of
    ``qmm_i8_direct`` per layer and the lm_head's, each at its time alone in
    the kernel phase (the kernel without its wrapper's row quantization)."""
    ms = {r["shape"]: r["ms"] for r in results if r["name"] == "qmm_i8_direct"}
    lin = {k: ms[f"M=4 K={k[0]} N={k[1]}"] for k in QMM_SHAPES + (LM_HEAD_SHAPE,)}
    qmm = num_layers * (4 * lin[(4096, 4096)] + 2 * lin[(4096, 11008)]
                        + lin[(11008, 4096)]) + lin[LM_HEAD_SHAPE]
    attn = num_layers * next(r["ms"] for r in results if r["name"] == "decode_attention_cuda")
    step = stats["decode_ms_per_step"]
    return dict(step_ms=step, step_qmm_ms=qmm, step_attention_ms=attn,
                step_other_ms=step - qmm - attn)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on the card", file=sys.stderr)
        return 2
    if not (ROOT / "qlora_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository (qlora_tpu_torch/ "
              "is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    from qlora_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build_all(verbose=True)
    print(f"build: {sorted(libs)} for sm_90a in {time.perf_counter() - t0:.1f} s", flush=True)

    results = []
    t0 = time.perf_counter()
    kernel_phase(dev, results)
    flash_phase(dev, results)
    print(f"kernels: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    int8_kernel_phase(dev, results)
    print(f"kernels-int8: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    paged_kernel_phase(dev, results)
    print(f"kernels-paged: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    worst = parity_phase(dev)
    print(f"parity: worst max|d| {worst:.4g} <= {LOGIT_TOL}, {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    worst = {}
    for seed in PARITY_INT8_SEEDS:
        w, _ = parity_int8_phase(dev, seed)
        worst = {k: max(v, worst.get(k, 0.0)) for k, v in w.items()}
    print(f"parity-int8: over seeds {PARITY_INT8_SEEDS}, worst max|logits cpu - card| "
          f"{worst['free']:.4g} <= {W8A8_LOGIT_TOL}, on the CPU's row codes "
          f"{worst['replayed']:.4g} <= {LOGIT_TOL}, int8 against exact "
          f"{worst['of_exact']:.4f} < {INT8_LOGIT_BAND}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    worst = paged_parity_phase(dev)
    print(f"paged-parity: worst max|d| {worst:.4g} <= {LOGIT_TOL}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    (serve_counts, serve_stats, int8_counts, int8_stats,
     (paged_counts, paged_stats, paged8_counts, paged8_stats),
     (spec_counts, spec_stats)) = serve_phase(dev)
    print(f"serve, serve-int8, serve-paged and serve-paged-spec: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    nodq_counts = nodq_phase(dev)
    t0 = time.perf_counter()
    worst = train_parity_phase(dev)
    print(f"train-parity: worst gradient difference {worst:.4g} <= {GRAD_TOL}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    train_counts, train_per_step, train_stats = train_phase(dev)
    print(f"train: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    worst = train_parity_phase(dev, "int8")
    train8_counts, train8_per_step, train8_stats = train_phase(dev, "int8", TRAIN_INT8_STEPS)
    print(f"train-int8: worst gradient difference {worst:.4g} <= {GRAD_TOL}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # each kernel's launches on the main path that runs it: serve for the
    # serving kernels (nodq for the f32-absmax variant), train for the rest.
    # The int8 family: serve-int8 for the direct kernel, serve-paged's w8a8
    # prefill for the w8a8 kernel over NF4 storage, train-int8 for the other
    # two; serve-paged and serve-paged-spec for the paged kernels
    launches = dict(train_counts, qmm_nf4_fwd_dq=serve_counts["qmm_nf4_fwd_dq"],
                    decode_attention_cuda=serve_counts["decode_attention_cuda"],
                    qmm_nf4_fwd_f32=nodq_counts["qmm_nf4_fwd_f32"],
                    qmm_i8_direct=int8_counts["qmm_i8_direct"],
                    qmm_nf4_w8a8=paged8_counts["qmm_nf4_w8a8"],
                    qmm_i8_fwd=train8_counts["qmm_i8_fwd"],
                    qmm_i8_bwd=train8_counts["qmm_i8_bwd"],
                    paged_decode_attention_cuda=paged_counts["paged_decode_attention_cuda"],
                    paged_chunk_attention_cuda=spec_counts["paged_chunk_attention_cuda"])
    idle = [name for name in SOURCES if launches[name] <= 0]
    if idle:
        fail(f"kernels never launched on their main path: {idle}")
    summary = []
    for name, (source, replaces) in SOURCES.items():
        rows = [r for r in results if r["name"] == name]
        head = next(r for r in rows if r["shape"].startswith(HEADLINE[name]))
        summary.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head["shape"],
            # the w8a8 kernels' "ms" is the kernel alone; with the wrapper's row
            # quantization (PyTorch ops), as the decode step pays it:
            **({"wrapper_ms": head["wrapper_ms"]} if "wrapper_ms" in head else {}),
        })
    for entry, v, run in ((summary[0], "dq", serve_counts), (summary[1], "f32", nodq_counts)):
        head = next(r for r in results if r["name"] == entry["name"]
                    and r["shape"] == entry["shape"])
        big = next(r for r in results if r["name"] == entry["name"]
                   and r["shape"] == TRAIN_HEADLINE)
        entry.update(sources=NF4_SOURCES, decode_launches=run[f"qmm_nf4_decode_{v}"],
                     wgmma_launches=run[f"qmm_nf4_wgmma_{v}"], tile_ms=head["tile_ms"],
                     wgmma={k: big[k] for k in ("shape", "ms", "tile_ms", "plain_ms",
                                                "library_ms", "bound_ms", "bound_by")})
    for entry in summary:
        if entry["name"] in ("qmm_i8_fwd", "qmm_i8_bwd"):
            head = next(r for r in results if r["name"] == entry["name"]
                        and r["shape"] == entry["shape"])
            d = "fwd" if entry["name"] == "qmm_i8_fwd" else "bwd"
            entry.update(sources=I8_SOURCES, wgmma_launches=train8_counts[f"qmm_i8_wgmma_{d}"],
                         tile_ms=head["tile_ms"])
    summary[0]["launches_train"] = train_counts["qmm_nf4_fwd_dq"]
    summary[0]["wgmma_launches_train"] = train_counts["qmm_nf4_wgmma_dq"]
    split = serve_split(results, seven_b().num_layers, serve_stats)
    print(f"serve: prefill {split['prefill_ms']:.1f} ms, of which qmm kernels "
          f"~{split['prefill_qmm_ms']:.1f} ms; decode step {split['step_ms']:.2f} ms = qmm "
          f"kernels ~{split['step_qmm_ms']:.2f} ms + decode attention "
          f"~{split['step_attention_ms']:.2f} ms + other ~{split['step_other_ms']:.2f} ms "
          "(kernel-phase times x launches)", flush=True)
    s8 = serve_int8_split(results, seven_b().num_layers, int8_stats)
    print(f"serve-int8: decode step {s8['step_ms']:.2f} ms = qmm_i8_direct kernels "
          f"~{s8['step_qmm_ms']:.2f} ms + decode attention ~{s8['step_attention_ms']:.2f} ms + "
          f"other ~{s8['step_other_ms']:.2f} ms (row quantization in PyTorch ops included, issued "
          f"by the host: it differs from call to call); kernel time of a step "
          f"{s8['step_qmm_ms'] + s8['step_attention_ms']:.2f} ms against the NF4 path's "
          f"{split['step_qmm_ms'] + split['step_attention_ms']:.2f} ms; on the host's clock the "
          f"NF4 step is {split['step_ms'] / s8['step_ms']:.2f} x as long in this run", flush=True)
    paged_attn = seven_b().num_layers * next(
        r["ms"] for r in results if r["name"] == "paged_decode_attention_cuda")
    paged_qmm = qmm_ms_per_forward(results, seven_b().num_layers, PAGED_B)
    verify_qmm = qmm_ms_per_forward(results, seven_b().num_layers, PAGED_B * (SPEC_DRAFT + 1))
    print(f"serve-paged: {PAGED_B} slots, {paged_stats['tok_s']:.1f} tok/s over the run "
          f"(admissions included), {paged_stats['ms_per_step']:.2f} ms per decode step (qmm "
          f"kernels ~{paged_qmm:.2f} ms and paged attention ~{paged_attn:.2f} ms of it, "
          "kernel-phase times x launches), against generate()'s 4 rows at "
          f"{serve_stats['decode_tok_s']:.1f} tok/s and {serve_stats['decode_ms_per_step']:.2f} "
          f"ms/step; int8 decode and w8a8 prefill {paged8_stats['tok_s']:.1f} tok/s, "
          f"{paged8_stats['ms_per_step']:.2f} ms/step; speculation "
          f"{spec_stats['tokens_per_chunk']:.3f} tokens per chunk, "
          f"{spec_stats['ms_per_chunk']:.2f} ms per verify step (qmm kernels ~{verify_qmm:.2f} ms "
          f"of it at M={PAGED_B * (SPEC_DRAFT + 1)})", flush=True)
    ts = train_split(results, train_per_step, train_stats)
    print(f"train: optimizer step {ts['step_ms']:.0f} ms = qmm forward kernel "
          f"~{ts['qmm_fwd_ms']:.0f} ms ({train_per_step['qmm_nf4_fwd_dq']} launches) + qmm "
          f"backward kernel ~{ts['qmm_bwd_ms']:.0f} ms ({train_per_step['qmm_nf4_bwd']}) + flash "
          f"forward ~{ts['flash_fwd_ms']:.1f} ms ({train_per_step['flash_fwd']}) + flash dq "
          f"~{ts['flash_bwd_dq_ms']:.1f} ms ({train_per_step['flash_bwd_dq']}) + flash dk, dv "
          f"~{ts['flash_bwd_dkv_ms']:.1f} ms ({train_per_step['flash_bwd_dkv']}) + other "
          f"~{ts['other_ms']:.0f} ms (kernel-phase times x launches)", flush=True)
    t8 = train_split(results, train8_per_step, train8_stats, "int8")
    print(f"train-int8: optimizer step {t8['step_ms']:.0f} ms = qmm_i8_fwd wgmma kernel "
          f"~{t8['qmm_fwd_ms']:.0f} ms ({train8_per_step['qmm_i8_fwd']} launches) + qmm_i8_bwd "
          f"wgmma kernel ~{t8['qmm_bwd_ms']:.0f} ms ({train8_per_step['qmm_i8_bwd']}) + flash "
          f"~{t8['flash_fwd_ms'] + t8['flash_bwd_dq_ms'] + t8['flash_bwd_dkv_ms']:.1f} ms + "
          f"other ~{t8['other_ms']:.0f} ms (kernel-phase times x launches)", flush=True)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
