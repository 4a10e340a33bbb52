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
   least 17 rows, which the wgmma kernel takes too).  The NF4 dx at the
   train step's 1024 rows, both absmax variants, runs the wgmma kernel of
   ``qmm_nf4_bwd_wgmma.cu`` (each packed byte decoded once for both nibble
   planes), timed beside ``qmm_nf4_bwd.cu`` through its C entry (``tile_ms``,
   the "before", also held to QMM_TOL) and held bit for bit the same way
   (identity rows of g read out columns of ``dequantize``'s weight).  Flash
   attention's forward, dq and dk/dv at the train shapes run the wgmma
   kernels of ``flash_attention_wgmma.cu``, each timed beside the kernel of
   ``flash_attention.cu`` that it replaced (``tile_ms``, the "before", also
   held to FLASH_TOL), SDPA with the same mask as the yardstick, and, at the
   train shape with full lengths, SDPA with ``is_causal=True`` on a line of
   its own; each call once on its wgmma kernel and bit-equal across two
   calls.  At head dim 256 (the Gemma presets: gemma-7b's shape, gemma-2b's
   MQA with a window and planted edges, S = 600) the same kernels on their
   WIDE_D tiles (dq 32-key kv tiles; dk and dv split over the consumer
   warpgroups), counted in ``wide_launches``, with no "before".  The NF4
   forward and dx at 1024 rows also on gemma-7b's four block-linear shapes.
   Decode attention runs the split-KV kernel of
   ``decode_attention_split.cu`` at every ATTN_CASES entry and a long cache
   (T = 2048), timed in CUDA graphs beside ``decode_attention.cu`` (its
   "before", through a private wrapper: ``tile_ms``, held to ATTN_TOL) and
   SDPA (``library_ms``, events; in a graph beside it), and held bit for bit
   across two calls and with each row alone, caches byte-equal to the plain
   version's after the append.
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
   tokens, remat "save_linear", the default, ``paged_adamw_32bit``) takes 5
   optimizer steps on one batch: finite losses, no movement on the first
   step (its learning rate is 0), a lower loss at the end, frozen tensors
   byte-identical, and exact launch counts read around the steps: every NF4
   forward and dx and every flash launch on a wgmma kernel (train-parity
   too, under remat "full"), 448 NF4 forward and 64 flash forward a step
   (the backward's recomputed blocks read them back).  Then train remat: the
   same weights under remat "full" (3 steps, 896 and 128) and no remat (2
   steps); step times and peaks of the three, peak("full") <
   peak("save_linear") < peak(False), and "save_linear"'s losses and
   gradient norms within 1e-3 and GRAD_TOL of "full"'s.
8. kernels-int8: the four kernels of the int8 family against their plain
   versions: ``qmm_i8_direct`` (M = 4, 8, 16 on the block linears and the
   padded lm_head, and a ragged shape) and ``qmm_nf4_w8a8`` (M = 4, 8, 16,
   128, 512, 2048) equal bit for bit, in the raw int32 accumulators and in
   the bf16 output.  ``qmm_nf4_w8a8`` up to 16 rows runs the split-K kernel
   of ``qmm_nf4_w8a8_decode.cu``, which quantizes the rows and makes the
   per-column scales itself (NF4 with double quant on the three block
   linears, f32 absmax and FP4 once at M = 4): its x8 and xs equal
   ``quantize_rows``' on the card, two calls and each row alone bit for bit;
   timed in CUDA graphs beside ``qmm_i8_direct.cu``'s NF4 entry through its C
   entry on rows quantized and scales made beforehand (``tile_ms``, the
   "before", equal bit for bit), ``torch._int_mm`` (``library_ms``), the exact
   NF4 decode kernel at the same rows (``exact_ms``) and the wrapper back to
   back (``wrapper_ms``, events).  ``qmm_i8_direct`` up to 16 rows runs the
   split-K kernel of ``qmm_i8_direct_decode.cu``, which quantizes the rows itself: its x8 and
   xs equal ``quantize_rows``' on the card, two calls and each row alone bit
   for bit; timed in CUDA graphs beside ``qmm_i8_direct.cu`` through its C
   entry on rows quantized beforehand (``tile_ms``, the "before", equal bit
   for bit), ``torch._int_mm`` (``library_ms``, in a graph) and the wrapper
   back to back (``wrapper_ms``, events); the ragged shape stays on
   ``qmm_i8_direct.cu``.
   ``qmm_i8_fwd`` (M = 4, 8, 16, 1024, 2048) and ``qmm_i8_bwd`` (M = 4, 8,
   16 on ``qmm_i8.cu``, which no path runs, and 1024) within the NF4 kernels'
   tolerance, f32 and double-quantized absmax, and
   reading out ``dequantize``'s weight bit for bit from identity operands.
   Up to 16 rows the forward runs the split-K kernel of
   ``qmm_i8_decode.cu``, timed in CUDA graphs beside ``qmm_i8.cu``'s 16-row
   branch through its C entry (``tile_ms``, the "before", held to QMM_TOL)
   and held bit for bit as the NF4 decode kernel (two calls, each row alone,
   identity rows).  Above 16 rows the wrappers run the wgmma kernel of
   ``qmm_i8_wgmma.cu``, timed beside the tile kernel of ``qmm_i8.cu``
   through its C entry (``tile_ms``, also held to QMM_TOL) and held bit for
   bit as the NF4 wgmma kernel (two calls, sub-batches of at least 17 rows,
   identity rows).  ``qmm_nf4_w8a8`` above 16 rows (128, 512, 2048) runs
   the int8 wgmma kernel of ``qmm_nf4_w8a8_wgmma.cu``, timed in CUDA graphs
   beside
   ``qmm_i8_direct.cu``'s NF4 path through its C entry (``tile_ms``, the
   "before", held bit for bit too), ``torch._int_mm`` (``library_ms``) and
   the exact NF4 wgmma kernel at the same rows (``exact_ms``), and held bit
   for bit across two calls and with rows in other batches.
9. parity-int8: LLaMA-7B width, 2 layers, the CPU's plain path against the
   card, at three seeds: 4 teacher-forced decode steps on the int8 serving
   tree and a 128-token prefill of the NF4 params, both under
   ``default_impl("w8a8")``; logits agree, agree as closely as the exact
   path's once the card multiplies the CPU's int8 row codes, and stay within
   a band of the exact path's without being equal to them.
10. serve-int8 (inside serve, on its weights): the same 4 requests through
   ``generate(..., decode_impl="int8")`` on a serving tree requantized once;
   exact launch counts (the prefill on the NF4 kernel, every decode step on
   ``qmm_i8_direct``, the lm_head included, all on ``qmm_i8_direct_decode.cu``),
   the first tokens equal to the NF4 run's, both decode paths' times side by
   side.
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
   within ATTN_TOL, pools byte-equal after the append.  The decode step and
   the chunks (C = 5) run the split-KV kernel of ``paged_attention_split.cu``
   (the decode as the chunk of one token), timed in CUDA graphs beside
   ``paged_attention.cu``'s decode or chunk entry (``tile_ms``, the "befores",
   held to ATTN_TOL with their pools byte-equal) and SDPA, and held bit for
   bit across two calls and with each row alone.
13. paged-parity: LLaMA-7B width, 2 layers — a 126-token prompt prefilled
   into pages with ``PagedPool.write_prefill``, 4 teacher-forced decode steps
   and a 5-token verify chunk through ``forward(cache=paged)``; logits of the
   card against the CPU and against the card's contiguous cache.
14. serve-paged (inside serve, on its weights): ``PagedBatcher`` with 8
   slots over a pool small enough to preempt, 16 requests of 64-512 prompt
   and 16-64 new tokens; exact launch counts from the counted forwards (every
   paged decode on the split kernel), the pool recycled; then the same
   requests with ``decode_impl="int8", prefill_impl="w8a8"`` (every decode
   forward's qmm_i8_direct on its decode kernel, every prefill's
   qmm_nf4_w8a8 on the wgmma kernel; its prefill forwards timed); then
   serve-paged-w8a8: the same requests with ``decode_impl="w8a8"`` on the NF4
   weights as stored (every decode forward's 224 qmm_nf4_w8a8 on
   ``qmm_nf4_w8a8_decode.cu``, the prefill exact), its decode step split into
   kernels and the rest.
15. serve-paged-spec: the same engine with 4 drafts per verify chunk on 8
   requests whose prompts repeat a 16-token phrase.
16. parity-i8base: parity over an int8-stored base (``--bits 8``, double
   quant): the prefill on the int8 wgmma kernel, the decode steps on the
   int8 decode kernel, logits within LOGIT_TOL, exact launch counts.
17. serve-i8base: the serve phase's requests through ``generate()`` over a
   full-depth int8-stored base with a rank-64 LoRA: every decode step's 224
   linears on ``qmm_i8_decode.cu``, exact launch counts, its decode ms/step
   beside the NF4 serve phase's, peak memory.
18. train-gemma: ``google/gemma-7b`` (28 layers, hidden 3072, 16 heads of
   256, vocabulary 256000): train-parity-gemma (2 layers, 2 x 512 tokens,
   "save_linear", card against CPU), then 3 optimizer steps at full depth as
   train's (random NF4 weights, a fresh rank-64 LoRA, "save_linear"): 56
   flash forward, dq and dk/dv a step, all on the head-dim-256 tiles, 392 NF4
   forward and 386 dx.
19. train-full: ``mode="full"`` (every tensor of an unquantized model
   trained) at LLaMA-7B width, 16 layers (the f32 gradient sum and AdamW
   moments fit 80 GB), 3 steps: remat "full", flash counts exact, no qmm,
   the loss falling, every tensor moved.

The last two lines are the ``kernels`` JSON object and the result line.

``python3 chip_smoke.py serve-paged-w8a8`` builds the kernels and runs the
serve weights through serve-paged-w8a8 alone, to time the route in turns
with a checkout of another commit that this script is copied into;
``python3 chip_smoke.py train`` does the same for the train phase (at the
checkout's default remat) and ``python3 chip_smoke.py train-gemma`` runs
train-gemma alone.
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
W8A8_ROWS = (128, 512, 2048)     # the parity-int8 prefill (1 x 128), the serve-paged prefill of
                                 # one row at bucket 512 (its commonest), a 4 x 512 group
ATTN_CASES = (   # B, H, KVH, hd, T, lengths, sliding window, planted edges
    (4, 32, 32, 128, 640, (0, 97, 383, 639), None, False),
    (4, 32, 8, 128, 640, (0, 97, 383, 639), 256, False),      # GQA G=4, sliding window
    (4, 32, 32, 128, 600, (5, 300, 598, 599), None, False),   # T not a multiple of 128
    (4, 32, 8, 128, 640, (0, 97, 383, 639), 256, True),       # an off-by-one moves it O(1)
)
ATTN_LONG = (4, 32, 32, 128, 2048, (0, 511, 1500, 2047), None, False)   # five splits of 448
I8_DECODE_ROWS = (4, 8, 16)      # the int8 forward at decode rows: generate()'s 4, 8 slots, 16


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
    # head dim 256: the Gemma presets' training shapes (no "before": flash_attention.cu
    # has no head dim 256)
    (2, 16, 16, 256, 512, (512, 300), None, False, False),   # gemma-7b
    (2, 8, 1, 256, 512, (512, 300), 256, True, False),       # gemma-2b's MQA, planted edges
    (2, 16, 16, 256, 600, (600, 333), None, False, False),   # S no multiple of 64
)
GEMMA = "google/gemma-7b"
# gemma-7b's block linears (K, N): wq, wk, wv; wo; w_gate, w_up; w_down
GEMMA_QMM_SHAPES = ((3072, 4096), (4096, 3072), (3072, 24576), (24576, 3072))
TRAIN_REMAT_STEPS = (("full", 3), (False, 2))   # beside the default's TRAIN_STEPS, same call
TRAIN_GEMMA_STEPS = 3
TRAIN_FULL_LAYERS = 16    # mode "full" at LLaMA-7B width: bf16 weights, an f32 gradient sum
                          # and f32 AdamW moments (14 bytes a parameter) fit 80 GB at 16 layers
TRAIN_FULL_STEPS = 3


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
    """The NF4 kernels launched through their C entries, bypassing the
    dispatch and the counters: (decode, tile, bwd_tile), the first two
    (x, qt) -> y, the last (g, qt) -> dx.  The tile kernel's M <= 16 branch
    is the "before" of the decode kernel, its other rows the wgmma kernel's;
    ``qmm_nf4_bwd.cu`` is the "before" of the NF4 dx kernel."""
    import importlib

    qm = importlib.import_module("qlora_tpu_torch.ops.qmatmul")

    def decode(x, qt):
        _, _, scale, offset = qm._check_quantized(qt, x.device)
        return qm._decode_launch(x, qt, scale, offset)

    def tile(x, qt):
        _, N, scale, offset = qm._check_quantized(qt, x.device)
        return qm._launch("qmm_nf4_fwd", "qmm_nf4_fwd", x, qt, N, scale, offset)

    def bwd_tile(g, qt):
        K, _, scale, offset = qm._check_quantized(qt, g.device)
        return qm._launch("qmm_nf4_bwd", "qmm_nf4_bwd", g, qt, K, scale, offset)

    return decode, tile, bwd_tile


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


def paged_split_checks(shape, kernel, before, q, nk, nv, kp, vp, L, tables, kw, o1, o2):
    """The split kernel, at the decode step or a chunk: it took the call;
    paged_attention.cu's decode or chunk entry (the "before") within ATTN_TOL
    of the plain version with the same pools after the append; two calls and
    each row alone bit for bit.  Every call starts from the pools as they
    were (a clamped append may overwrite keys a later call would read).
    Returns the before's max|d|."""
    import torch

    took = kernel.split_launches
    k3, v3 = kp.clone(), vp.clone()
    ob, _, _ = before(q, nk, nv, k3, v3, L, tables, **kw)
    k4, v4 = kp.clone(), vp.clone()
    twice = torch.equal(kernel(q, nk, nv, k4, v4, L, tables, **kw)[0], o1)
    alone = all(torch.equal(kernel(q[b:b + 1], nk[b:b + 1], nv[b:b + 1], kp.clone(), vp.clone(),
                                   L[b:b + 1], tables[b:b + 1], **kw)[0][0], o1[b])
                for b in range(q.shape[0]))
    torch.cuda.synchronize()
    diff = (ob.float() - o2.float()).abs()
    excess = (diff - ATTN_TOL * o2.float().abs().amax(-1, keepdim=True)).max().item()
    same = torch.equal(k3, k4) and torch.equal(v3, v4)
    split = kernel.split_launches - took == 1 + q.shape[0]
    print(f"  split kernel took every call {split}; two calls equal {twice}; each row alone "
          f"equal {alone}; paged_attention.cu (before) max|d| {diff.max().item():.3g}, its pools "
          f"equal {same}", flush=True)
    if not (split and twice and alone and same) or excess > 0:
        fail(f"{kernel.__name__} {shape}: split {split}, deterministic {twice}, "
             f"row-invariant {alone}, before's pools {same}, before's excess {excess}")
    return diff.max().item()


def paged_kernel_phase(dev, results):
    """The two paged wrappers against their plain versions at the serve-paged
    shapes (PAGED_CASES), and the chunk of one token against the decode step.
    Both run the split kernel (``paged_attention_split.cu``, the decode step
    as the chunk of one token), timed in CUDA graphs beside paged_attention.cu's
    decode or chunk entry (``tile_ms``, the "befores")."""
    import importlib

    import torch
    import torch.nn.functional as F

    from qlora_tpu_torch.ops import (
        paged_chunk_attention_cuda, paged_chunk_plain, paged_decode_attention_cuda,
        paged_decode_plain,
    )

    pa = importlib.import_module("qlora_tpu_torch.ops.paged_attention")

    g = torch.Generator(device=dev).manual_seed(8642)
    H, hd, B, T = 32, 128, PAGED_B, PAGE * PPS
    for C, KVH, lens, window, evict, planted in PAGED_CASES:
        q, nk, nv, kp, vp, L, tables = paged_case(g, dev, B, C, H, KVH, hd, PAGE, PPS, lens,
                                                  window, evict, planted)
        name = "paged_decode_attention_cuda" if C is None else "paged_chunk_attention_cuda"
        kernel, plain, before = (
            (paged_decode_attention_cuda, paged_decode_plain, pa._paged_decode_before) if C is None
            else (paged_chunk_attention_cuda, paged_chunk_plain, pa._paged_chunk_before))
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
        shape = (f"B={B}{'' if C is None else f' C={C}'} H={H} KVH={KVH} hd={hd} page={PAGE} "
                 f"pps={PPS} lens={list(lens)} window={window}"
                 + (" evicted" if evict else "") + (" planted edges" if planted else ""))
        more = {"tile_err": paged_split_checks(shape, kernel, before, q, nk, nv, kp, vp, L,
                                               tables, kw, o1, o2)}
        bound_ms, bound_by, keys = paged_bound(B, Cq, H, KVH, hd, lens, window, T, PPS)
        pools = [(k1, v1)] + [(k1.clone(), v1.clone())
                              for _ in range(copies_past_l2(2 * KVH * hd * 2 * keys) - 1)]
        # device times in CUDA graphs: the wrapper's host time exceeds the split kernel's
        ms = graph_ms(lambda i: kernel(q, nk, nv, *pools[i % len(pools)], L, tables, **kw), 200)
        more["tile_ms"] = graph_ms(lambda i: before(q, nk, nv, *pools[i % len(pools)], L,
                                                    tables, **kw), 50)
        if C is None:
            # the decode step's host cost a call: the wrappers back to back, with events
            more["wrapper_ms"] = cuda_ms(lambda i: kernel(q, nk, nv, *pools[i % len(pools)], L,
                                                          tables, **kw), 200)
            more["tile_wrapper_ms"] = cuda_ms(lambda i: before(q, nk, nv, *pools[i % len(pools)],
                                                               L, tables, **kw), 200)
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
        record(results, name, shape, err, f"tol {ATTN_TOL}*row max|ref|", ms, plain_ms, lib_ms,
               (bound_ms, bound_by), **more)
        print(f"  the split kernel {more['tile_ms'] / ms:.2f}x paged_attention.cu's speed, "
              f"{ms / lib_ms:.2f}x SDPA's time", flush=True)
        print(f"  pools byte-equal after the append: {same}"
              + (f"; one more key in the window moves the plain output by {moved:.3g}"
                 if planted else ""), flush=True)
        if excess > 0 or not same:
            fail(f"{name} {shape}: max|d|={err}, pools byte-equal={same}")
        if planted and moved < 0.5:
            fail(f"{name} {shape}: the planted edges move the output by only {moved}")
        del pools, k1, v1, k2, v2

    # the chunk of one token is the decode step, both on the split kernel
    q, nk, nv, kp, vp, L, tables = paged_case(g, dev, B, None, H, 8, hd, PAGE, PPS,
                                              DECODE_LENS, 256, True, True)
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    kw = dict(sm_scale=hd ** -0.5, sliding_window=256)
    took = (paged_chunk_attention_cuda.split_launches, paged_decode_attention_cuda.split_launches)
    oc, _, _ = paged_chunk_attention_cuda(q[:, None], nk[:, None], nv[:, None], k1, v1, L,
                                          tables, **kw)
    od, _, _ = paged_decode_attention_cuda(q, nk, nv, k2, v2, L, tables, **kw)
    torch.cuda.synchronize()
    same = torch.equal(oc[:, 0], od) and torch.equal(k1, k2) and torch.equal(v1, v2)
    split = (paged_chunk_attention_cuda.split_launches - took[0],
             paged_decode_attention_cuda.split_launches - took[1]) == (1, 1)
    print(f"kernel paged_chunk_attention_cuda C=1 against paged_decode_attention_cuda: outputs "
          f"and pools equal bit for bit: {same}; both on the split kernel: {split}", flush=True)
    if not (same and split):
        fail("the chunk kernel at C=1 differs from the decode step")


def kernel_phase(dev, results):
    import torch
    import torch.nn.functional as F

    from qlora_tpu_torch.ops import (
        qmatmul_bwd_plain, qmatmul_plain, qmm_nf4_bwd, qmm_nf4_fwd_dq, qmm_nf4_fwd_f32,
    )
    from qlora_tpu_torch.ops.qmatmul import DECODE_ROWS
    from qlora_tpu_torch.quant import dequantize, quantize

    decode, tile, bwd_tile = nf4_kernels()
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
            # the backward at the training micro-batch: dx = g @ dequant(W)^T on
            # the wgmma kernel, the tile kernel of qmm_nf4_bwd.cu through its C
            # entry beside it (the "before")
            M = QMM_BWD_ROWS
            gr = torch.randn(M, N, device=dev, generator=g).to(torch.bfloat16)
            before = qmm_nf4_bwd.wgmma_launches
            dx = qmm_nf4_bwd(gr, qt)
            ref = qmatmul_bwd_plain(gr, qt)
            dt = bwd_tile(gr, qt)
            torch.cuda.synchronize()
            if qmm_nf4_bwd.wgmma_launches != before + 1:
                fail(f"qmm_nf4_bwd M={M} K={K} N={N} did not take the wgmma kernel")
            diff = (dx.float() - ref.float()).abs()
            err = diff.max().item()
            excess = (diff - QMM_TOL[1] * ref.float().abs()).max().item()
            tile_diff = (dt.float() - ref.float()).abs()
            excess = max(excess, (tile_diff - QMM_TOL[1] * ref.float().abs()).max().item())
            ms = cuda_ms(lambda i: qmm_nf4_bwd(gr, qts[i % len(qts)]), 20)
            tile_ms = cuda_ms(lambda i: bwd_tile(gr, qts[i % len(qts)]), 5)
            plain_ms = cuda_ms(lambda i: qmatmul_bwd_plain(gr, qts[i % len(qts)]), 3)
            lib_ms = cuda_ms(lambda i: torch.matmul(gr, ws[i % len(ws)].T), 20)
            bound_ms, bound_by = qmm_bound(M, K, N, dq)    # the same bytes and operations
            shape = f"M={M} K={K} N={N} {'dq' if dq else 'f32'} absmax"
            results.append(dict(name="qmm_nf4_bwd", shape=shape, max_abs_err=err, ms=ms,
                                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                                bound_by=bound_by, tile_ms=tile_ms,
                                tile_err=tile_diff.max().item()))
            print(f"kernel qmm_nf4_bwd {shape}: max|d|={err:.3g} "
                  f"(tol {QMM_TOL[0]} + {QMM_TOL[1]}*|ref|) ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                  f"bound_ms={bound_ms:.4f} ({bound_by}) tile_ms={tile_ms:.4f} "
                  f"tile_err={tile_diff.max().item():.4g}", flush=True)
            if excess > QMM_TOL[0]:
                fail(f"qmm_nf4_bwd {shape} differs from its plain version by {err}")
            wgmma_checks("qmm_nf4_bwd", qmm_nf4_bwd, gr, qt, w_bf16, bwd=True)

    decode_attention_phase(dev, g, results)


def gemma_qmm_phase(dev, results):
    """The NF4 forward and dx (double quant) at the train micro-batch's 1024
    rows on gemma-7b's four block-linear shapes, which train-gemma runs: each
    against its plain version (QMM_TOL) on the wgmma kernels, held bit for
    bit as at LLaMA's shapes, timed beside ``torch.matmul`` on the
    dequantized weight."""
    import torch

    from qlora_tpu_torch.ops import qmatmul_bwd_plain, qmatmul_plain, qmm_nf4_bwd, qmm_nf4_fwd_dq
    from qlora_tpu_torch.quant import dequantize, quantize

    g = torch.Generator(device=dev).manual_seed(4242)
    M = QMM_BWD_ROWS
    for K, N in GEMMA_QMM_SHAPES:
        qt = quantize(torch.randn(K, N, device=dev, generator=g) * K ** -0.5)
        w_bf16 = dequantize(qt, torch.bfloat16)
        qts = [qt] + [dataclasses.replace(qt, packed=qt.packed.clone(), absmax=qt.absmax.clone())
                      for _ in range(copies_past_l2(qt.nbytes) - 1)]
        ws = [w_bf16] + [w_bf16.clone() for _ in range(copies_past_l2(w_bf16.nbytes) - 1)]
        x = torch.randn(M, K, device=dev, generator=g).to(torch.bfloat16)
        gr = torch.randn(M, N, device=dev, generator=g).to(torch.bfloat16)
        for name, wrapper, plain, inp, lib, tag in (
                ("qmm_nf4_fwd_dq", qmm_nf4_fwd_dq, qmatmul_plain, x,
                 lambda i: torch.matmul(x, ws[i % len(ws)]), ""),
                ("qmm_nf4_bwd", qmm_nf4_bwd, qmatmul_bwd_plain, gr,
                 lambda i: torch.matmul(gr, ws[i % len(ws)].T), " dq absmax")):
            before = wrapper.wgmma_launches
            y = wrapper(inp, qt)
            ref = plain(inp, qt)
            torch.cuda.synchronize()
            if wrapper.wgmma_launches != before + 1:
                fail(f"{name} M={M} K={K} N={N} (gemma-7b) did not take the wgmma kernel")
            diff = (y.float() - ref.float()).abs()
            err = diff.max().item()
            if (diff - QMM_TOL[1] * ref.float().abs()).max().item() > QMM_TOL[0]:
                fail(f"{name} M={M} K={K} N={N} (gemma-7b) differs from its plain version by {err}")
            wgmma_checks(f"{name} (gemma-7b)", wrapper, inp, qt, w_bf16, bwd=name == "qmm_nf4_bwd")
            record(results, name, f"M={M} K={K} N={N}{tag} (gemma-7b)", err,
                   f"tol {QMM_TOL[0]} + {QMM_TOL[1]}*|ref|",
                   cuda_ms(lambda i: wrapper(inp, qts[i % len(qts)]), 20),
                   cuda_ms(lambda i: plain(inp, qts[i % len(qts)]), 3), cuda_ms(lib, 20),
                   qmm_bound(M, K, N, True))
        del qts, ws


def decode_attention_phase(dev, g, results):
    """The split-KV decode attention kernel (``decode_attention_split.cu``)
    against its plain version at ATTN_CASES and ATTN_LONG, beside the kernel
    it replaced (``decode_attention.cu`` through ``_decode_attention_before``:
    ``tile_ms``, held to ATTN_TOL too) and SDPA; bit for bit across two calls
    and with each row alone; caches byte-equal to the plain version's."""
    import importlib

    import torch
    import torch.nn.functional as F

    from qlora_tpu_torch.ops import decode_attention_cuda, decode_attention_plain

    before = importlib.import_module("qlora_tpu_torch.ops.decode_attention")._decode_attention_before
    for B, H, KVH, hd, T, lens, window, planted in ATTN_CASES + (ATTN_LONG,):
        mk = lambda *s: torch.randn(*s, device=dev, generator=g).to(torch.bfloat16)
        q, nk, nv = mk(B, H, hd), mk(B, KVH, hd), mk(B, KVH, hd)
        kc, vc = mk(B, KVH, T, hd), mk(B, KVH, T, hd)
        if planted:
            plant_edges(q, kc, lens, window)
        L = torch.tensor(lens, device=dev, dtype=torch.int32)
        kw = dict(sm_scale=hd ** -0.5, sliding_window=window)
        k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        k3, v3 = kc.clone(), vc.clone()
        o1, _, _ = decode_attention_cuda(q, nk, nv, k1, v1, L, **kw)
        o2, _, _ = decode_attention_plain(q, nk, nv, k2, v2, L, **kw)
        o3, _, _ = before(q, nk, nv, k3, v3, L, **kw)
        torch.cuda.synchronize()
        tol = ATTN_TOL * o2.float().abs().amax(-1, keepdim=True)
        diff = (o1.float() - o2.float()).abs()
        err = diff.max().item()
        excess = (diff - tol).max().item()
        tile_diff = (o3.float() - o2.float()).abs()
        excess = max(excess, (tile_diff - tol).max().item())
        same = all(torch.equal(a, b) for a, b in ((k1, k2), (v1, v2), (k3, k2), (v3, v2)))
        # bit for bit: two calls, and each row alone against its row of the batch
        twice = torch.equal(o1, decode_attention_cuda(q, nk, nv, k1, v1, L, **kw)[0])
        alone = all(torch.equal(decode_attention_cuda(
            q[b:b + 1], nk[b:b + 1], nv[b:b + 1], k1[b:b + 1], v1[b:b + 1], L[b:b + 1],
            **kw)[0][0], o1[b]) for b in range(B))
        caches = [(k1, v1)] + [(k1.clone(), v1.clone())
                               for _ in range(copies_past_l2(2 * k1.nbytes) - 1)]
        # device times in CUDA graphs: the wrapper's host time exceeds the kernel's
        ms = graph_ms(lambda i: decode_attention_cuda(q, nk, nv, *caches[i % len(caches)], L,
                                                      **kw), 200)
        tile_ms = graph_ms(lambda i: before(q, nk, nv, *caches[i % len(caches)], L, **kw), 100)
        plain_ms = cuda_ms(lambda i: decode_attention_plain(q, nk, nv, *caches[i % len(caches)],
                                                            L, **kw), 20)
        # yardstick: SDPA of the queries over the cache, masked to each row's
        # valid prefix (it reads all T slots and appends nothing)
        pos = torch.arange(T, device=dev)
        valid = pos[None, :] <= L[:, None].clamp(max=T - 1)
        if window:
            valid &= pos[None, :] > L[:, None] - window
        mask = valid[:, None, None, :]
        qs = q[:, :, None, :]
        sdpa = lambda i: F.scaled_dot_product_attention(
            qs, *caches[i % len(caches)], attn_mask=mask, scale=hd ** -0.5, enable_gqa=KVH != H)
        lib_ms = cuda_ms(sdpa, 200)
        lib_graph_ms = graph_ms(sdpa, 200)
        bound_ms, bound_by = attn_bound(B, H, KVH, hd, lens, T, window)
        shape = (f"B={B} H={H} KVH={KVH} hd={hd} T={T} lens={list(lens)} window={window}"
                 + (" planted edges" if planted else ""))
        record(results, "decode_attention_cuda", shape, err, f"tol {ATTN_TOL}*row max|ref|", ms,
               plain_ms, lib_ms, (bound_ms, bound_by), tile_ms=tile_ms,
               tile_err=tile_diff.max().item(), library_graph_ms=lib_graph_ms)
        print(f"  caches byte-equal to the plain version's after the append: {same}; two calls "
              f"equal {twice}; each row alone equal {alone}; {tile_ms / ms:.2f}x "
              f"decode_attention.cu's speed, {ms / lib_ms:.2f}x SDPA's time", flush=True)
        if excess > 0 or not (same and twice and alone):
            fail(f"decode attention {shape}: max|d|={err} (before {tile_diff.max().item()}), "
                 f"caches byte-equal {same}, deterministic {twice}, row-invariant {alone}")
        del caches, k1, v1, k2, v2, k3, v3


def flash_phase(dev, results):
    """flash_fwd, flash_bwd_dq and flash_bwd_dkv (the wgmma kernels of
    ``flash_attention_wgmma.cu``) against their plain versions at the
    training shapes, each beside the kernel of ``flash_attention.cu`` that it
    replaced (``tile_ms``, the "before", held to the same tolerances; head
    dims 64 and 128 only).  The backward kernels get the plain forward's o
    and lse, so that each kernel is held against the same function of the
    same inputs.  Each call must launch its wgmma kernel once (at head dim
    256 on the WIDE_D tiles, ``wide_launches``) and give the same bits
    twice."""
    import importlib

    import torch
    import torch.nn.functional as F

    from qlora_tpu_torch.ops import (
        flash_bwd_dkv, flash_bwd_dq, flash_bwd_plain, flash_fwd, flash_fwd_plain,
    )

    fa = importlib.import_module("qlora_tpu_torch.ops.flash_attention")
    before = {"flash_fwd": fa._flash_fwd_before, "flash_bwd_dq": fa._flash_bwd_dq_before,
              "flash_bwd_dkv": fa._flash_bwd_dkv_before}
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

        o2, lse2 = flash_fwd_plain(q, k, v, L, sm, True, window)
        di = (o2.float() * do.float()).sum(-1)
        if dlse is not None:
            di = di - dlse
        rq, rk, rv = flash_bwd_plain(q, k, v, L, o2, lse2, do, sm, True, window, dlse=dlse)
        empty = lse2 > 1e37                                  # rows that see no key

        def excess(got, ref, dims):
            d = (got.float() - ref.float()).abs()
            tol = FLASH_TOL * ref.float().abs().amax(dims, keepdim=True)
            return d.max().item(), (d - tol).max().item()

        def check(fwd, bwd_dq, bwd_dkv):
            """Max errors of each kernel, lse's, whether empty rows and keys
            past the length got exactly 0, and the outputs."""
            o, lse = fwd(q, k, v, L, sm, True, window)
            dq = bwd_dq(q, k, v, L, do, lse2, di, sm, True, window)
            dk, dv = bwd_dkv(q, k, v, L, do, lse2, di, sm, True, window)
            torch.cuda.synchronize()
            errs = {"flash_fwd": excess(o, o2, -1), "flash_bwd_dq": excess(dq, rq, (-2, -1))}
            ek, ev = excess(dk, rk, (-2, -1)), excess(dv, rv, (-2, -1))
            errs["flash_bwd_dkv"] = (max(ek[0], ev[0]), max(ek[1], ev[1]))
            lse_err = (lse - lse2)[~empty].abs().max().item()
            exact = (bool((lse[empty] == 3e38).all()) and bool((o[empty] == 0).all())
                     and bool((dq[empty] == 0).all())
                     and all(bool((dk[b, :, n:] == 0).all()) and bool((dv[b, :, n:] == 0).all())
                             for b, n in enumerate(lens)))
            return errs, lse_err, exact, (o, lse, dq, dk, dv)

        wrappers = (flash_fwd, flash_bwd_dq, flash_bwd_dkv)
        n0 = [(w.wgmma_launches, w.wide_launches) for w in wrappers]
        errs, lse_err, exact, first = check(*wrappers)
        took = [(w.wgmma_launches - a, w.wide_launches - b) for w, (a, b) in zip(wrappers, n0)]
        if took != [(1, int(hd == 256))] * 3:
            fail(f"flash {shape}: launches (wgmma, head dim 256) {took}, want one each on the "
                 f"{'WIDE_D ' if hd == 256 else ''}wgmma kernels")
        same = all(torch.equal(a, b) for a, b in zip(first, check(*wrappers)[3]))
        if not same:
            fail(f"flash {shape}: two calls gave other bits")
        has_before = hd in (64, 128)      # flash_attention.cu's head dims
        tile_errs, tile_lse_err, tile_exact, _ = (check(*before.values()) if has_before
                                                  else ({}, 0.0, True, None))
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

        def times(fwd, bwd_dq, bwd_dkv, iters, timer=graph_ms):
            return {"flash_fwd": timer(lambda i: fwd(*pick(i)[:3], L, sm, True, window), iters),
                    "flash_bwd_dq": timer(lambda i: bwd_dq(*pick(i)[:3], L, pick(i)[3], lse2,
                                                           di, sm, True, window), iters),
                    "flash_bwd_dkv": timer(lambda i: bwd_dkv(*pick(i)[:3], L, pick(i)[3], lse2,
                                                             di, sm, True, window), iters)}

        # device times in CUDA graphs: a wrapper's host time (checks, tensor
        # maps, the ctypes call) can exceed the new kernels' device time; the
        # wrappers launched back to back, timed with events, beside them
        ms = times(flash_fwd, flash_bwd_dq, flash_bwd_dkv, 50)
        tile_ms = times(*before.values(), 20) if has_before else {}
        wrapper_ms = times(flash_fwd, flash_bwd_dq, flash_bwd_dkv, 50, cuda_ms)
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
        lib_fwd_graph = graph_ms(lambda i: sdpa(*pick(i)[:3]), 50)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = sdpa(*leaves)
        lib_bwd = cuda_ms(lambda i: torch.autograd.grad(out, leaves, pick(i)[3],
                                                        retain_graph=True), 20)
        bounds = flash_bounds(B, H, KVH, hd, S, lens, window)
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            fwd = name == "flash_fwd"
            results.append(dict(
                name=name, shape=shape, max_abs_err=errs[name][0], ms=ms[name],
                **({"tile_ms": tile_ms[name], "tile_err": tile_errs[name][0]}
                   if has_before else {}),
                wrapper_ms=wrapper_ms[name], plain_ms=plain_fwd if fwd else plain_bwd,
                library_ms=lib_fwd if fwd else lib_bwd,
                bound_ms=bounds[name][0], bound_by=bounds[name][1]))
            tile = (f"tile_ms={tile_ms[name]:.4f} (flash_attention.cu, max|d|="
                    f"{tile_errs[name][0]:.3g})" if has_before else "no before at this head dim")
            print(f"kernel {name} {shape}: max|d|={errs[name][0]:.3g} (tol {FLASH_TOL}*max|ref|"
                  f"{' of the row' if fwd else ' of the slice'}) ms={ms[name]:.4f} (graph; "
                  f"wrapper_ms={wrapper_ms[name]:.4f} with events) "
                  f"{tile} plain_ms={plain_fwd if fwd else plain_bwd:.4f} "
                  f"library_ms={lib_fwd if fwd else lib_bwd:.4f} "
                  f"bound_ms={bounds[name][0]:.4f} ({bounds[name][1]})", flush=True)
        bwd = ms["flash_bwd_dq"] + ms["flash_bwd_dkv"]
        speed = lambda n: (f"{tile_ms[n] / ms[n]:.2f}x the before's speed, " if has_before
                           else "")
        tile_ms["bwd"], ms["bwd"] = (tile_ms["flash_bwd_dq"] + tile_ms["flash_bwd_dkv"]
                                     if has_before else None), bwd
        print(f"  lse max|d|={lse_err:.3g} (before {tile_lse_err:.3g}; tol {LSE_TOL}); empty "
              f"rows and keys past the length exactly 0: {exact} (before {tile_exact}); two "
              f"calls bit-equal: {same}; one launch each on the wgmma kernels {took}; forward "
              f"{speed('flash_fwd')}{ms['flash_fwd'] / lib_fwd:.2f}x SDPA's time (SDPA in a "
              f"graph {lib_fwd_graph:.4f} ms); dq + dk/dv {bwd:.4f} ms, {speed('bwd')}"
              f"{bwd / lib_bwd:.2f}x SDPA's whole backward; plain_ms of the backward is dq, dk "
              f"and dv together"
              + (f"; one more key in the window moves the plain o by {moved:.3g}"
                 if planted else ""), flush=True)
        bad = ([n for n, (_, ex) in errs.items() if ex > 0]
               + [f"{n} (before)" for n, (_, ex) in tile_errs.items() if ex > 0])
        if bad or max(lse_err, tile_lse_err) > LSE_TOL or not (exact and tile_exact):
            fail(f"flash {shape}: {bad} differ from their plain versions ({errs}, before "
                 f"{tile_errs}), lse {lse_err} (before {tile_lse_err}), exact zeros {exact} "
                 f"(before {tile_exact})")
        if planted and moved < 0.5:
            fail(f"flash {shape}: the planted edges move o by only {moved}")
        if (B, H, KVH, hd, S, lens, window) == FLASH_CASES[0][:7]:
            causal_sdpa(dev, sets, B, H, hd, S, sm)
        del sets, leaves, out


def causal_sdpa(dev, sets, B, H, hd, S, sm):
    """A second yardstick at the train shape with both lengths S: SDPA with
    ``is_causal=True`` and no mask, which takes PyTorch's flash backend,
    beside the wgmma kernels on the same inputs (their device times, in CUDA
    graphs)."""
    import torch
    import torch.nn.functional as F

    from qlora_tpu_torch.ops import flash_bwd_dkv, flash_bwd_dq, flash_fwd

    L = torch.full((B,), S, device=dev, dtype=torch.int32)
    pick = lambda i: sets[i % len(sets)]
    o, lse = flash_fwd(*pick(0)[:3], L, sm, True, None)
    di = (o.float() * pick(0)[3].float()).sum(-1)
    fwd = graph_ms(lambda i: flash_fwd(*pick(i)[:3], L, sm, True, None), 50)
    bwd = graph_ms(lambda i: flash_bwd_dq(*pick(i)[:3], L, pick(i)[3], lse, di, sm, True,
                                          None), 50)
    bwd += graph_ms(lambda i: flash_bwd_dkv(*pick(i)[:3], L, pick(i)[3], lse, di, sm, True,
                                            None), 50)
    sdpa = lambda qq, kk, vv: F.scaled_dot_product_attention(qq, kk, vv, is_causal=True,
                                                             scale=sm)
    lib_fwd = cuda_ms(lambda i: sdpa(*pick(i)[:3]), 50)
    lib_graph = graph_ms(lambda i: sdpa(*pick(i)[:3]), 50)
    leaves = [t.clone().requires_grad_() for t in pick(0)[:3]]
    out = sdpa(*leaves)
    lib_bwd = cuda_ms(lambda i: torch.autograd.grad(out, leaves, pick(i)[3],
                                                    retain_graph=True), 20)
    print(f"  yardstick B={B} H={H} hd={hd} S={S} lens=[{S}] * {B}, SDPA is_causal=True with no "
          f"mask (PyTorch's flash backend): forward {lib_fwd:.4f} ms with events, {lib_graph:.4f} "
          f"in a graph, against the wgmma kernel's {fwd:.4f} (graph); whole backward "
          f"{lib_bwd:.4f} ms (events) against dq + dk/dv {bwd:.4f} (graphs)", flush=True)


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


def int_mm_ms(x8, w8s, s_out, xs, iters, timer=None):
    """The yardstick of the w8a8 kernels: ``torch._int_mm`` (cuBLAS int8,
    rows padded to 32: it wants more than 16) and the epilogue in PyTorch
    ops.  It takes every shape of this script once its rows are padded.
    Timed by ``timer`` (``cuda_ms`` unless given)."""
    import torch

    M = x8.shape[0]
    xp = torch.nn.functional.pad(x8, (0, 0, 0, (-M) % 32))

    def call(i):
        acc = torch._int_mm(xp, w8s[i % len(w8s)])[:M]
        return (acc.float() * s_out[None, :]).to(torch.bfloat16) * xs.to(torch.bfloat16)

    return (timer or cuda_ms)(call, iters)


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


def i8_direct_decode_check(shape, x, qt):
    """``qmm_i8_direct`` at decode rows: the decode kernel took the call; its
    x8 and xs equal ``quantize_rows``' on the card, its int32 accumulators the
    exact integer product and its bf16 output the plain version's, bit for
    bit; two calls equal, and each row alone equal to its row of the batch.
    Returns (0.0 or a failure, y)."""
    import torch

    from qlora_tpu_torch.ops import int8_matmul_plain, qmm_i8_direct, qmm_i8_direct_plain
    from qlora_tpu_torch.ops import quantize_rows
    from qlora_tpu_torch.ops.qmatmul import _i8_direct_decode_outputs

    took = qmm_i8_direct.decode_launches
    y = qmm_i8_direct(x, qt)
    if qmm_i8_direct.decode_launches != took + 1:
        fail(f"qmm_i8_direct {shape}: qmm_i8_direct_decode.cu did not take the call")
    acc, x8, xs = _i8_direct_decode_outputs(x, qt)
    rx8, rxs = quantize_rows(x)
    ref = qmm_i8_direct_plain(x, qt)
    twice = torch.equal(qmm_i8_direct(x, qt), y)
    alone = all(torch.equal(qmm_i8_direct(x[m:m + 1], qt), y[m:m + 1]) for m in range(x.shape[0]))
    torch.cuda.synchronize()
    codes = torch.equal(x8, rx8) and torch.equal(xs, rxs)
    sums = torch.equal(acc, int8_matmul_plain(rx8, qt.packed).to(torch.int32))
    err = (y.float() - ref.float()).abs().max().item()
    print(f"  qmm_i8_direct {shape} (decode kernel): x8 and xs equal quantize_rows' {codes}; "
          f"int32 sums exact {sums}; output equal {torch.equal(y, ref)}; two calls equal "
          f"{twice}; rows alone equal {alone}", flush=True)
    if not (codes and sums and torch.equal(y, ref) and twice and alone):
        fail(f"qmm_i8_direct {shape}: the decode kernel differs from its plain version "
             f"(codes {codes}, sums {sums}, max|d| {err}, two calls {twice}, rows alone {alone})")
    return err, y


def nf4_w8a8_decode_check(shape, x, qt, w8):
    """``qmm_nf4_w8a8`` at decode rows: the decode kernel took the call; its
    x8 and xs equal ``quantize_rows``' on the card, its int32 accumulators the
    exact integer product with ``w8a8_codes`` and its bf16 output the plain
    version's, bit for bit; two calls equal, and each row alone equal to its
    row of the batch.  Returns (0.0 or a failure, y)."""
    import torch

    from qlora_tpu_torch.ops import int8_matmul_plain, qmm_nf4_w8a8, qmm_nf4_w8a8_plain
    from qlora_tpu_torch.ops import quantize_rows
    from qlora_tpu_torch.ops.qmatmul import _nf4_w8a8_decode_outputs

    took = qmm_nf4_w8a8.decode_launches
    y = qmm_nf4_w8a8(x, qt)
    if qmm_nf4_w8a8.decode_launches != took + 1:
        fail(f"qmm_nf4_w8a8 {shape}: qmm_nf4_w8a8_decode.cu did not take the call")
    acc, x8, xs = _nf4_w8a8_decode_outputs(x, qt)
    rx8, rxs = quantize_rows(x)
    ref = qmm_nf4_w8a8_plain(x, qt)
    twice = torch.equal(qmm_nf4_w8a8(x, qt), y)
    alone = all(torch.equal(qmm_nf4_w8a8(x[m:m + 1], qt), y[m:m + 1]) for m in range(x.shape[0]))
    torch.cuda.synchronize()
    codes = torch.equal(x8, rx8) and torch.equal(xs, rxs)
    sums = torch.equal(acc, int8_matmul_plain(rx8, w8).to(torch.int32))
    err = (y.float() - ref.float()).abs().max().item()
    print(f"  qmm_nf4_w8a8 {shape} (decode kernel): x8 and xs equal quantize_rows' {codes}; "
          f"int32 sums exact {sums}; output equal {torch.equal(y, ref)}; two calls equal "
          f"{twice}; rows alone equal {alone}", flush=True)
    if not (codes and sums and torch.equal(y, ref) and twice and alone):
        fail(f"qmm_nf4_w8a8 {shape}: the decode kernel differs from its plain version "
             f"(codes {codes}, sums {sums}, max|d| {err}, two calls {twice}, rows alone {alone})")
    return err, y


def w8a8_before_check(shape, launch_w8a8, x8, qt, ratio, s_out, xs, w8, y):
    """qmm_i8_direct.cu's NF4 path through its C entry, the "before" of the
    w8a8 wgmma kernel: its accumulators equal the exact integer product and
    its bf16 output the new kernel's, bit for bit."""
    import torch

    from qlora_tpu_torch.ops import int8_matmul_plain

    acc = launch_w8a8("qmm_nf4_w8a8", x8, qt, ratio, None, None, None)
    yt = launch_w8a8("qmm_nf4_w8a8", x8, qt, ratio, s_out, xs, None)
    torch.cuda.synchronize()
    if not (torch.equal(acc, int8_matmul_plain(x8, w8).to(torch.int32)) and torch.equal(yt, y)):
        fail(f"qmm_nf4_w8a8 {shape}: qmm_i8_direct.cu's NF4 path differs from the wgmma kernel")


def w8a8_invariance_check(shape, wrapper, x, qt, y):
    """The w8a8 wgmma kernel bit for bit across two calls, and rows alone
    (sub-batches of at least 17 rows, which it takes too) equal to their
    rows of the batch."""
    import torch

    from qlora_tpu_torch.ops.qmatmul import DECODE_ROWS

    M = x.shape[0]
    cuts = [(0, DECODE_ROWS + 1), (M - DECODE_ROWS - 1, M), (M // 3, M // 3 + 40)]
    twice = torch.equal(wrapper(x, qt), y)
    alone = all(torch.equal(wrapper(x[a:b], qt), y[a:b]) for a, b in cuts if 0 <= a < b <= M)
    print(f"  qmm_nf4_w8a8 {shape}: two calls equal {twice}; rows alone equal {alone}",
          flush=True)
    if not (twice and alone):
        fail(f"qmm_nf4_w8a8 {shape}: not deterministic ({twice}) or not batch-invariant ({alone})")


def int8_kernel_phase(dev, results):
    """The int8 family against its plain versions, at the LLaMA-7B shapes."""
    import torch

    from qlora_tpu_torch.ops import (
        qmatmul_plain, qmm_i8_bwd, qmm_i8_bwd_plain, qmm_i8_direct, qmm_i8_direct_plain,
        qmm_i8_fwd, qmm_i8_fwd_plain, qmm_nf4_fwd_dq, qmm_nf4_fwd_f32, qmm_nf4_w8a8,
        qmm_nf4_w8a8_plain, quantize_rows, w8a8_codes, w8a8_scales,
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

    # qmm_i8_direct: the decode steps' launches (M = 4 in serve-int8, 8 in
    # serve-paged-int8, and 16) on qmm_i8_direct_decode.cu, which quantizes the
    # rows itself, timed in CUDA graphs beside qmm_i8_direct.cu through its C
    # entry on rows quantized beforehand (tile_ms, the "before"); then a ragged
    # shape, which the decode kernel's plan refuses (qmm_i8_direct.cu, events)
    for K, N in QMM_SHAPES + (LM_HEAD_SHAPE,):
        w = torch.randn(K, N, device=dev, generator=g) * K ** -0.5
        qt = quantize(w, block_size=K, quant_type="int8", double_quant=False)
        del w
        qts = clones(qt)
        s_out = absmax_f32(qt).reshape(-1) / 127.0
        for M in I8_DECODE_ROWS:
            x = torch.randn(M, K, device=dev, generator=g).to(torch.bfloat16)
            shape = f"M={M} K={K} N={N}"
            err, y = i8_direct_decode_check(shape, x, qt)
            x8, xs = quantize_rows(x)
            yt = launch_w8a8("qmm_i8_direct", x8, qt, None, s_out, xs)
            torch.cuda.synchronize()
            if not torch.equal(yt, y):
                fail(f"qmm_i8_direct {shape}: qmm_i8_direct.cu (the before) differs from the "
                     "decode kernel")
            ms = graph_ms(lambda i: qmm_i8_direct(x, qts[i % len(qts)]), 200)
            more = dict(tile_ms=graph_ms(lambda i: launch_w8a8(
                "qmm_i8_direct", x8, qts[i % len(qts)], None, s_out, xs), 50))
            more["wrapper_ms"] = cuda_ms(lambda i: qmm_i8_direct(x, qts[i % len(qts)]), 200)
            plain_ms = cuda_ms(lambda i: qmm_i8_direct_plain(x, qts[i % len(qts)]), 3)
            lib_ms = int_mm_ms(x8, [q.packed for q in qts], s_out, xs, 200, graph_ms)
            # bf16 x in, its rows quantized inside the kernel: x, the codes and the
            # column scales read once, y written once
            record(results, "qmm_i8_direct", shape, err, exact_tol, ms, plain_ms, lib_ms,
                   int8_bound(M, K, N, K * N + N * 4, PEAK_INT8, 2), **more)
            print(f"  the decode kernel {more['tile_ms'] / ms:.2f}x qmm_i8_direct.cu's speed, "
                  f"{ms / lib_ms:.2f}x torch._int_mm's time", flush=True)
        del qts, qt
    M, K, N = 5, 200, 328
    qt = quantize(torch.randn(K, N, device=dev, generator=g) * K ** -0.5, block_size=K,
                  quant_type="int8", double_quant=False)
    x = torch.randn(M, K, device=dev, generator=g).to(torch.bfloat16)
    shape = f"M={M} K={K} N={N}"
    took = qmm_i8_direct.decode_launches
    err, _ = w8a8_check("qmm_i8_direct", shape, qmm_i8_direct, qmm_i8_direct_plain, x, qt,
                        qt.packed)
    if qmm_i8_direct.decode_launches != took:
        fail(f"qmm_i8_direct {shape}: the decode kernel took a shape its plan refuses")
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

    # qmm_nf4_w8a8 at decode rows (M = 4 in generate(), 8 in serve-paged-w8a8, and
    # 16) on qmm_nf4_w8a8_decode.cu, which quantizes the rows and makes the
    # per-column scales itself, timed in CUDA graphs beside qmm_i8_direct.cu's NF4
    # entry through its C entry on rows quantized and scales made beforehand
    # (tile_ms, the "before", equal bit for bit), torch._int_mm (library_ms) and
    # the exact NF4 decode kernel at the same rows (exact_ms), and the wrapper back
    # to back (wrapper_ms, events); NF4 with double quant on the three shapes, then
    # f32 absmax and FP4 once
    exact_fns = {True: qmm_nf4_fwd_dq, False: qmm_nf4_fwd_f32}
    for K, N, quant_type, dq, rows in [(K, N, "nf4", True, I8_DECODE_ROWS)
                                       for K, N in QMM_SHAPES] + [
            (4096, 4096, "nf4", False, (4,)), (4096, 4096, "fp4", True, (4,))]:
        w = torch.randn(K, N, device=dev, generator=g) * K ** -0.5
        qt = quantize(w, quant_type=quant_type, double_quant=dq)
        del w
        ratio, s_out = w8a8_scales(qt)
        w8 = w8a8_codes(qt, ratio)
        qts = clones(qt)
        w8s = [w8] + [w8.clone() for _ in range(copies_past_l2(w8.nbytes) - 1)]
        kind = {(True, "nf4"): "", (False, "nf4"): " f32 absmax", (True, "fp4"): " fp4"}[
            dq, quant_type]
        for M in rows:
            x = torch.randn(M, K, device=dev, generator=g).to(torch.bfloat16)
            shape = f"M={M} K={K} N={N}{kind}"
            err, y = nf4_w8a8_decode_check(shape, x, qt, w8)
            exact = qmatmul_plain(x, qt).float()
            off = (y.float() - exact).abs().max().item() / exact.abs().max().item()
            if not 0 < off < INT8_BAND:
                fail(f"qmm_nf4_w8a8 {shape}: {off:.4f} of the largest |value| away from the "
                     f"exact product (band {INT8_BAND})")
            x8, xs = quantize_rows(x)
            w8a8_before_check(shape, launch_w8a8, x8, qt, ratio, s_out, xs, w8, y)
            ms = graph_ms(lambda i: qmm_nf4_w8a8(x, qts[i % len(qts)]), 200)
            more = dict(tile_ms=graph_ms(lambda i: launch_w8a8(
                "qmm_nf4_w8a8", x8, qts[i % len(qts)], ratio, s_out, xs), 20))
            more["exact_ms"] = graph_ms(lambda i: exact_fns[dq](x, qts[i % len(qts)]), 200)
            more["wrapper_ms"] = cuda_ms(lambda i: qmm_nf4_w8a8(x, qts[i % len(qts)]), 200)
            plain_ms = cuda_ms(lambda i: qmm_nf4_w8a8_plain(x, qts[i % len(qts)]), 2)
            lib_ms = int_mm_ms(x8, w8s, s_out, xs, 200, graph_ms)
            # bf16 x in, its rows quantized inside the kernel: x, the packed weight and
            # its absmax read once, y written once (row 1's bound)
            record(results, "qmm_nf4_w8a8", shape, err, exact_tol, ms, plain_ms, lib_ms,
                   qmm_bound(M, K, N, dq), of_exact=off, **more)
            print(f"  the decode kernel {more['tile_ms'] / ms:.2f}x qmm_i8_direct.cu's speed, "
                  f"{ms / lib_ms:.2f}x torch._int_mm's time, {ms / more['exact_ms']:.2f}x the "
                  "exact NF4 decode kernel's", flush=True)
        del qts, w8s, w8, qt

    # qmm_nf4_w8a8 above DECODE_ROWS: NF4 storage (double quant), the int8 wgmma
    # kernel, with qmm_i8_direct.cu's NF4 path through its C entry beside it (the
    # "before") and the exact NF4 wgmma kernel at the same rows
    from qlora_tpu_torch.ops.qmatmul import _w8a8_nf4_entry as w8a8_entry

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
            took = qmm_nf4_w8a8.wgmma_launches
            err, y = w8a8_check("qmm_nf4_w8a8", shape, qmm_nf4_w8a8, qmm_nf4_w8a8_plain, x, qt,
                                w8)
            if qmm_nf4_w8a8.wgmma_launches != took + 1:
                fail(f"qmm_nf4_w8a8 {shape}: the wgmma kernel took "
                     f"{qmm_nf4_w8a8.wgmma_launches - took} launches")
            exact = qmatmul_plain(x, qt).float()
            off = (y.float() - exact).abs().max().item() / exact.abs().max().item()
            if not 0 < off < INT8_BAND:
                fail(f"qmm_nf4_w8a8 {shape}: {off:.4f} of the largest |value| away from the "
                     f"exact product (band {INT8_BAND})")
            x8, xs = quantize_rows(x)
            entry, plan = w8a8_entry(x8, qt)
            # device times in CUDA graphs: at 128 and 512 rows the wgmma kernel is no
            # longer than a launch's host cost through its wrapper
            ms = graph_ms(lambda i: launch_w8a8(entry, x8, qts[i % len(qts)], ratio, s_out, xs,
                                                plan), 50)
            w8a8_before_check(shape, launch_w8a8, x8, qt, ratio, s_out, xs, w8, y)
            w8a8_invariance_check(shape, qmm_nf4_w8a8, x, qt, y)
            more = dict(tile_ms=graph_ms(lambda i: launch_w8a8(
                "qmm_nf4_w8a8", x8, qts[i % len(qts)], ratio, s_out, xs), 10))
            more["exact_ms"] = graph_ms(lambda i: qmm_nf4_fwd_dq(x, qts[i % len(qts)]), 50)
            more["wrapper_ms"] = cuda_ms(lambda i: qmm_nf4_w8a8(x, qts[i % len(qts)]), 20)
            plain_ms = cuda_ms(lambda i: qmm_nf4_w8a8_plain(x, qts[i % len(qts)]), 2)
            lib_ms = int_mm_ms(x8, w8s, s_out, xs, 50, graph_ms)
            record(results, "qmm_nf4_w8a8", shape, err, exact_tol, ms, plain_ms, lib_ms,
                   int8_bound(M, K, N, K * N // 2 + ratio.nbytes + N * 4 + M * 4, PEAK_INT8, 1),
                   of_exact=off, **more)
            print(f"  the wgmma kernel {more['tile_ms'] / ms:.2f}x qmm_i8_direct.cu's speed, "
                  f"{ms / lib_ms:.2f}x torch._int_mm's time, {ms / more['exact_ms']:.2f}x "
                  "the exact NF4 wgmma kernel's", flush=True)
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
                                               I8_DECODE_ROWS + (QMM_BWD_ROWS, 2048)),
                                              ("qmm_i8_bwd", qmm_i8_bwd, qmm_i8_bwd_plain,
                                               I8_DECODE_ROWS + (QMM_BWD_ROWS,))):
                fwd = name == "qmm_i8_fwd"
                for M in rows:
                    a = torch.randn(M, K if fwd else N, device=dev, generator=g).to(torch.bfloat16)
                    took = qmm_i8_fwd.decode_launches
                    y, ref = kernel(a, qt), plain(a, qt)
                    if qmm_i8_fwd.decode_launches != took + (fwd and M <= DECODE_ROWS):
                        fail(f"{name} M={M} K={K} N={N}: the decode kernel took "
                             f"{qmm_i8_fwd.decode_launches - took} launches")
                    # qmm_i8.cu through its C entry: the "before" of both new kernels
                    yt = i8_tile(a, qt, fwd)
                    torch.cuda.synchronize()
                    diff = (y.float() - ref.float()).abs()
                    err = diff.max().item()
                    excess = (diff - QMM_TOL[1] * ref.float().abs()).max().item()
                    shape = f"M={M} K={K} N={N} {kind} absmax"
                    dt = (yt.float() - ref.float()).abs()
                    more = {"tile_err": dt.max().item()}
                    excess = max(excess, (dt - QMM_TOL[1] * ref.float().abs()).max().item())
                    if excess > QMM_TOL[0]:
                        fail(f"{name} {shape} differs from its plain version by {err}")
                    mat = lambda i: torch.matmul(a, ws[i % len(ws)] if fwd else ws[i % len(ws)].T)
                    if M > DECODE_ROWS:
                        ms = cuda_ms(lambda i: kernel(a, qts[i % len(qts)]), 20)
                        more["tile_ms"] = cuda_ms(lambda i: i8_tile(a, qts[i % len(qts)], fwd), 5)
                        plain_ms = cuda_ms(lambda i: plain(a, qts[i % len(qts)]), 3)
                        lib_ms = cuda_ms(mat, 20)
                    elif not fwd:
                        # the dx at decode rows: qmm_i8.cu itself (no path runs it), in a
                        # graph beside g @ Wᵀ on the dequantized weight
                        ms = graph_ms(lambda i: kernel(a, qts[i % len(qts)]), 50)
                        plain_ms = cuda_ms(lambda i: plain(a, qts[i % len(qts)]), 20)
                        lib_ms = graph_ms(mat, 200)
                    else:
                        # device times in a graph: the decode kernel is shorter than its
                        # wrapper's host time
                        ms = graph_ms(lambda i: kernel(a, qts[i % len(qts)]), 200)
                        more["tile_ms"] = graph_ms(lambda i: i8_tile(a, qts[i % len(qts)], fwd),
                                                   20)
                        plain_ms = cuda_ms(lambda i: plain(a, qts[i % len(qts)]), 20)
                        lib_ms = graph_ms(mat, 200)
                    record(results, name, shape, err, tol, ms, plain_ms, lib_ms,
                           int8_bound(M, K, N, K * N + am_bytes, PEAK_BF16, 2), **more)
                    if M > DECODE_ROWS:
                        wgmma_checks(name, kernel, a, qt, w_bf16, bwd=not fwd)
                    elif not fwd:
                        print(f"  qmm_i8.cu's dx at {M} rows {ms / lib_ms:.2f}x torch.matmul's "
                              "time", flush=True)
                    else:
                        print(f"  the decode kernel {more['tile_ms'] / ms:.1f}x qmm_i8.cu's "
                              f"speed, {ms / lib_ms:.2f}x torch.matmul's time", flush=True)
                        decode_checks(f"{name} (decode kernel)", kernel, a, qt, w_bf16)
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


def parity_phase(dev, quant_type="nf4"):
    """LLaMA-7B width, 2 layers, the same weights (NF4, or with ``quant_type``
    "int8" an int8-stored base, double quant) through the plain path on the
    CPU and through the kernels on the card: a 128-token prefill, then 4
    teacher-forced decode steps; logits within LOGIT_TOL.  The int8 base's
    run also checks its launch counts: the prefill on the int8 wgmma kernel,
    every decode step on the int8 decode kernel.  Returns the worst |d|."""
    import torch

    from qlora_tpu_torch.models import forward, init_cache, init_params
    from qlora_tpu_torch.utils import move_to

    tag = "parity" if quant_type == "nf4" else "parity-i8base"
    cfg = seven_b(num_layers=2)
    p_gpu = init_params(cfg, seed=1, device=dev, quant_type=quant_type)
    lora_gpu, lcfg = random_lora(cfg, dev, seed=2)
    p_cpu, lora_cpu = move_to(p_gpu, "cpu"), move_to(lora_gpu, "cpu")
    S, steps = 128, 4
    ids = torch.randint(0, cfg.vocab_size, (1, S), generator=torch.Generator().manual_seed(3))
    c_cpu = init_cache(cfg, 1, S + steps, device="cpu")
    c_dev = init_cache(cfg, 1, S + steps, device=dev)
    worst = 0.0
    with torch.inference_mode():
        lc, c_cpu = forward(p_cpu, lora_cpu, ids, cfg, lcfg, cache=c_cpu)
        reset_counts()
        lg, c_dev = forward(p_gpu, lora_gpu, ids.to(dev), cfg, lcfg, cache=c_dev)
        for step in range(steps + 1):
            last_c, last_g = lc[:, -1], lg[:, -1].cpu()
            if not (torch.isfinite(last_c).all() and torch.isfinite(last_g).all()):
                fail(f"{tag}: non-finite logits at step {step}")
            err = (last_c - last_g).abs().max().item()
            if step == 0:      # the whole prefill, every position
                err = max(err, (lc - lg.cpu()).abs().max().item())
            worst = max(worst, err)
            print(f"{tag} step {step}: max|logits cpu - card|={err:.4g} "
                  f"(tol {LOGIT_TOL}, |logits| max {last_c.abs().max().item():.3g})",
                  flush=True)
            if err > LOGIT_TOL:
                fail(f"{tag}: card logits differ from the CPU's by {err} at step {step}")
            if step == steps:
                break
            tok = last_c.argmax(-1, keepdim=True)         # teacher-force the CPU's token
            lc, c_cpu = forward(p_cpu, lora_cpu, tok, cfg, lcfg, cache=c_cpu)
            lg, c_dev = forward(p_gpu, lora_gpu, tok.to(dev), cfg, lcfg, cache=c_dev)
    torch.cuda.synchronize()
    counts = read_counts()
    if quant_type == "int8":
        n_lin = 7 * cfg.num_layers
        want = expected_counts(qmm_i8_fwd=n_lin * (steps + 1),
                               qmm_i8_decode_fwd=n_lin * steps,     # 1 row: the decode kernel
                               qmm_i8_wgmma_fwd=n_lin,              # the prefill's 128 rows
                               decode_attention_cuda=cfg.num_layers * steps)
        print(f"{tag}: launches {counts} (expected {want})", flush=True)
        if counts != want:
            fail(f"{tag} launch counts {counts} != {want}")
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
    int8 codes.  On the card the direct decode kernel, which quantizes its
    rows itself, takes the tape's codes as its given rows.  Recording reads
    ``quantize_rows`` only: it runs on the CPU's plain path."""
    import importlib

    qm = importlib.import_module("qlora_tpu_torch.ops.qmatmul")
    real, left = qm.quantize_rows, iter(tape)
    real_decode = qm._i8_direct_decode_launch

    def record(x):
        tape.append(real(x))
        return tape[-1]

    def replay(x):
        x8, xs = next(left)
        if x8.shape != x.shape:
            fail(f"row_codes: call of shape {tuple(x.shape)} meets a tape entry {tuple(x8.shape)}")
        return x8.to(replay_on), xs.to(replay_on)

    def replay_decode(x, qt, plan, raw=False, rows=None):
        # qmm_i8_direct_decode.cu quantizes the rows itself: it is handed the
        # tape's codes instead (its `given` rows)
        return real_decode(x, qt, plan, raw, replay(x))

    qm.quantize_rows = record if replay_on is None else replay
    if replay_on is not None:
        qm._i8_direct_decode_launch = replay_decode
    try:
        yield
    finally:
        qm.quantize_rows = real
        qm._i8_direct_decode_launch = real_decode
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
        want = expected_counts(qmm_nf4_w8a8=7 * cfg.num_layers,
                               qmm_nf4_w8a8_wgmma=7 * cfg.num_layers)    # 128 rows
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
                           paged_decode_attention_cuda=L * steps, paged_decode_split=L * steps,
                           paged_chunk_attention_cuda=L, paged_chunk_split=L)
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
# int8 forward counts those that took qmm_i8_decode.cu (M <= DECODE_ROWS),
# read as qmm_i8_decode_fwd; the int8 forward and dx count those that took
# qmm_i8_wgmma.cu (more rows), read as qmm_i8_wgmma_fwd / _bwd; the rest took
# qmm_i8.cu.
# The NF4 dx counts those that took qmm_nf4_bwd_wgmma.cu, read as
# qmm_nf4_wgmma_bwd; the rest took qmm_nf4_bwd.cu.  The w8a8 forward over NF4
# counts those that took qmm_nf4_w8a8_wgmma.cu (more rows), read as
# qmm_nf4_w8a8_wgmma, and those that took qmm_nf4_w8a8_decode.cu (M <=
# DECODE_ROWS), read as qmm_nf4_w8a8_decode; the rest took qmm_i8_direct.cu.
# The direct int8 w8a8
# forward counts those that took qmm_i8_direct_decode.cu (M <= DECODE_ROWS),
# read as qmm_i8_direct_decode; the rest took qmm_i8_direct.cu.  The paged
# decode and chunk attention count those that took paged_attention_split.cu,
# read as paged_decode_split and paged_chunk_split: every call (paged_attention.cu
# is reached only through the uncounted "befores").  The flash wrappers launch
# only the wgmma kernels of flash_attention_wgmma.cu and count each launch in
# wgmma_launches too, read as flash_wgmma_fwd / _bwd_dq / _bwd_dkv, and those at
# head dim 256 (the WIDE_D tiles) in wide_launches, read as flash_wide_fwd /
# _bwd_dq / _bwd_dkv (0 where a checkout's wrappers have no such counter)
DECODE_COUNTS = {"qmm_nf4_decode_dq": "qmm_nf4_fwd_dq", "qmm_nf4_decode_f32": "qmm_nf4_fwd_f32",
                 "qmm_i8_decode_fwd": "qmm_i8_fwd", "qmm_i8_direct_decode": "qmm_i8_direct",
                 "qmm_nf4_w8a8_decode": "qmm_nf4_w8a8"}
WGMMA_COUNTS = {"qmm_nf4_wgmma_dq": "qmm_nf4_fwd_dq", "qmm_nf4_wgmma_f32": "qmm_nf4_fwd_f32",
                "qmm_i8_wgmma_fwd": "qmm_i8_fwd", "qmm_i8_wgmma_bwd": "qmm_i8_bwd",
                "qmm_nf4_wgmma_bwd": "qmm_nf4_bwd", "flash_wgmma_fwd": "flash_fwd",
                "flash_wgmma_bwd_dq": "flash_bwd_dq", "flash_wgmma_bwd_dkv": "flash_bwd_dkv",
                "qmm_nf4_w8a8_wgmma": "qmm_nf4_w8a8"}
SPLIT_COUNTS = {"paged_chunk_split": "paged_chunk_attention_cuda",
                "paged_decode_split": "paged_decode_attention_cuda"}
WIDE_COUNTS = {"flash_wide_fwd": "flash_fwd", "flash_wide_bwd_dq": "flash_bwd_dq",
               "flash_wide_bwd_dkv": "flash_bwd_dkv"}


def expected_counts(**nonzero):
    """Every counter at 0 except the ones named."""
    return {**{w.__name__: 0 for w in counters()}, **{k: 0 for k in DECODE_COUNTS},
            **{k: 0 for k in WGMMA_COUNTS}, **{k: 0 for k in SPLIT_COUNTS},
            **{k: 0 for k in WIDE_COUNTS}, **nonzero}


def reset_counts():
    for w in counters():
        for attr in ("launches", "decode_launches", "wgmma_launches", "split_launches",
                     "wide_launches"):
            if hasattr(w, attr):
                setattr(w, attr, 0)


def read_counts():
    by_name = {w.__name__: w for w in counters()}
    return {**{n: w.launches for n, w in by_name.items()},
            # 0 where a checkout's wrapper has no decode kernel (serve_w8a8_only)
            **{k: getattr(by_name[n], "decode_launches", 0) for k, n in DECODE_COUNTS.items()},
            **{k: by_name[n].wgmma_launches for k, n in WGMMA_COUNTS.items()},
            **{k: by_name[n].split_launches for k, n in SPLIT_COUNTS.items()},
            **{k: getattr(by_name[n], "wide_launches", 0) for k, n in WIDE_COUNTS.items()}}


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
                           qmm_i8_direct_decode=(n_lin + 1) * SERVE_NEW,   # 4 rows: all of them
                           decode_attention_cuda=cfg.num_layers * SERVE_NEW)
    decode_s = total_s - prefill_s
    agree = (toks == nf4_toks).float().mean().item()
    print(f"serve-int8: generated {tuple(toks.shape)} tokens in {total_s:.3f} s; decode "
          f"{decode_s * 1e3:.1f} ms = {toks.numel() / decode_s:.1f} tok/s, "
          f"{decode_s / SERVE_NEW * 1e3:.2f} ms/step (its prefill, on the exact params, "
          f"{prefill_s * 1e3:.1f} ms); peak memory {peak_gib:.2f} GiB; {agree:.2f} of the tokens equal "
          "the NF4 run's", flush=True)
    print(f"serve-int8: launches {counts} (expected {want}: the prefill's {n_lin} on the NF4 "
          f"kernel, {n_lin} + 1 qmm_i8_direct, all on qmm_i8_direct_decode.cu, and "
          f"{cfg.num_layers} decode-attention per decode step)", flush=True)
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


def serve_i8base_phase(dev, nf4_stats):
    """serve-i8base: the serve phase's requests through ``generate()`` over
    a full-depth int8-stored base (``--bits 8``, double quant) with a rank-64
    LoRA: the prefill's linears on the int8 wgmma kernel, every decode
    step's on the int8 decode kernel; exact launch counts, the decode step's
    time beside the NF4 serve phase's from the same run, peak memory."""
    import gc

    import torch

    from qlora_tpu_torch.generate import generate
    from qlora_tpu_torch.models import init_params

    # the serving engines of the serve phase hold reference cycles (their
    # methods wrapped by `instrument`): collect them, so that the peak below
    # counts this run's memory and not theirs
    gc.collect()
    torch.cuda.empty_cache()
    cfg = seven_b()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=7, device=dev, quant_type="int8")
    lora, lcfg = random_lora(cfg, dev, seed=8)
    torch.cuda.synchronize()
    print(f"serve-i8base: LLaMA-7B {cfg.num_layers} layers, random int8 weights (double quant) "
          f"+ rank-{lcfg.r} LoRA, made in {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated", flush=True)
    ids, lengths = padded_requests(SERVE_LENGTHS, max(SERVE_LENGTHS), cfg.vocab_size, 9)
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
    want = expected_counts(qmm_i8_fwd=n_lin * (SERVE_NEW + 1),
                           qmm_i8_decode_fwd=n_lin * SERVE_NEW,       # 4 rows: the decode kernel
                           qmm_i8_wgmma_fwd=n_lin,                    # the prefill: wgmma
                           decode_attention_cuda=cfg.num_layers * SERVE_NEW)
    decode_s = total_s - prefill_s
    stats = dict(prefill_ms=prefill_s * 1e3, decode_ms_per_step=decode_s / SERVE_NEW * 1e3,
                 decode_tok_s=toks.numel() / decode_s, peak_gib=peak_gib)
    print(f"serve-i8base: generated {tuple(toks.shape)} tokens in {total_s:.3f} s; prefill "
          f"{prefill_s * 1e3:.1f} ms, decode {decode_s * 1e3:.1f} ms = "
          f"{stats['decode_tok_s']:.1f} tok/s, {stats['decode_ms_per_step']:.2f} ms/step (the "
          f"NF4 serve phase: {nf4_stats['decode_ms_per_step']:.2f} ms/step, peak "
          f"{nf4_stats['peak_gib']:.2f} GiB); peak memory {peak_gib:.2f} GiB", flush=True)
    print(f"serve-i8base: launches {counts} (expected {want}: {n_lin} qmm_i8_fwd per forward, "
          f"on the wgmma kernel in the prefill and on the decode kernel in each decode step, "
          f"{cfg.num_layers} decode-attention per decode step)", flush=True)
    if counts != want:
        fail(f"serve-i8base launch counts {counts} != {want}")
    if toks.shape != (4, SERVE_NEW) or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        fail("serve-i8base: tokens out of range or wrong shape")
    del params, lora
    torch.cuda.empty_cache()
    return counts, stats


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

    st = dict(decode=0, verify=0, prefill=0, prefill_rows=[], prefill_s=0.0, steps=0,
              step_s=0.0, verify_steps=0, verify_s=0.0, admit_s=0.0)
    fwd, pre, step, admit = pb._decode_forward, pb._prefill_rows, pb._decode_step, pb._admit

    def decode_forward(toks, cache):
        st["decode" if toks.shape[1] == 1 else "verify"] += 1
        return fwd(toks, cache)

    def prefill_rows(ids, *a):
        st["prefill"] += 1
        st["prefill_rows"].append(ids.numel())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pre(ids, *a)
        torch.cuda.synchronize()
        st["prefill_s"] += time.perf_counter() - t0
        return out

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
                 prefill_forwards=st["prefill"], prefill_rows=list(st["prefill_rows"]),
                 prefill_ms=st["prefill_s"] / max(st["prefill"], 1) * 1e3)
    rows = {m: st["prefill_rows"].count(m) for m in sorted(set(st["prefill_rows"]))}
    print(f"{tag}: {len(reqs)} requests, {tokens} tokens in {total_s:.3f} s = "
          f"{stats['tok_s']:.1f} tok/s; {st['steps']} decode steps, "
          f"{stats['ms_per_step']:.2f} ms/step; admissions {st['admit_s'] * 1e3:.1f} ms "
          f"({st['prefill']} prefill forwards of {stats['prefill_ms']:.2f} ms each, token rows: "
          f"count {rows}); {pb.preemptions} "
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
                           paged_decode_attention_cuda=L * st["decode"],
                           paged_decode_split=L * st["decode"])
    print(f"serve-paged: launches {counts} (expected {want}: {n_lin} qmm per forward, on the "
          f"decode kernel in each decode forward and on the wgmma kernel in each prefill, {L} "
          "paged decode attention per decode forward, all on the split kernel)", flush=True)
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
                            qmm_i8_direct_decode=(n_lin + 1) * st8["decode"],   # 8 rows
                            qmm_nf4_w8a8=n_lin * st8["prefill"],       # >= 128 rows a prefill
                            qmm_nf4_w8a8_wgmma=n_lin * st8["prefill"],
                            paged_decode_attention_cuda=L * st8["decode"],
                            paged_decode_split=L * st8["decode"])
    print(f"serve-paged-int8: launches {counts8} (expected {want8}: {n_lin} + 1 qmm_i8_direct "
          f"per decode forward, all on qmm_i8_direct_decode.cu, {n_lin} qmm_nf4_w8a8 per prefill "
          "forward, all on the wgmma kernel, no NF4 qmm)",
          flush=True)
    if counts8 != want8:
        fail(f"serve-paged-int8 launch counts {counts8} != {want8}")
    del pb
    torch.cuda.empty_cache()
    countsw, statsw = serve_paged_w8a8(dev, cfg, params, lora, lcfg, traffic)
    return counts, stats, counts8, stats8, countsw, statsw


def serve_paged_w8a8(dev, cfg, params, lora, lcfg, traffic, check=True):
    """serve-paged-w8a8: the same requests through ``PagedBatcher(decode_impl=
    "w8a8")``, the NF4 weights as stored: every decode forward's 7 block
    linears a layer through ``qmm_nf4_w8a8`` on its decode kernel (8 rows),
    the prefill exact NF4 (on the wgmma kernel), every paged decode on the
    split kernel; exact launch counts (printed only, without ``check``: a
    checkout whose ``qmm_nf4_w8a8`` has no decode kernel, timed beside this
    one)."""
    import torch

    L, n_lin = cfg.num_layers, 7 * cfg.num_layers
    pb, st, counts, stats = serve_paged_run("serve-paged-w8a8", dev, cfg, params, lora, lcfg,
                                            traffic, SERVE_PAGED_PAGES, decode_impl="w8a8")
    want = expected_counts(qmm_nf4_fwd_dq=n_lin * st["prefill"],
                           qmm_nf4_wgmma_dq=n_lin * st["prefill"],     # >= 128 rows a prefill
                           qmm_nf4_w8a8=n_lin * st["decode"],
                           qmm_nf4_w8a8_decode=n_lin * st["decode"],  # 8 rows a decode forward
                           paged_decode_attention_cuda=L * st["decode"],
                           paged_decode_split=L * st["decode"])
    print(f"serve-paged-w8a8: launches {counts} (expected {want}: {n_lin} qmm_nf4_w8a8 per "
          "decode forward, all on qmm_nf4_w8a8_decode.cu, the prefill exact on the NF4 wgmma "
          f"kernel, {L} paged decode attention per decode forward, all on the split kernel)",
          flush=True)
    if check and counts != want:
        fail(f"serve-paged-w8a8 launch counts {counts} != {want}")
    del pb
    torch.cuda.empty_cache()
    return counts, stats


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
                           paged_decode_split=L * st["decode"],
                           paged_chunk_attention_cuda=L * st["verify"],
                           paged_chunk_split=L * st["verify"])
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


def train_counts(L, quant_type="nf4", remat="save_linear", mode="lora", micro=TRAIN_ACCUM,
                 wide=False):
    """The launches of `micro` micro-batches' forward and backward over L
    layers (block linears M = rows x S > 16: every NF4 or int8 forward and dx
    on a wgmma kernel).  Per micro-batch: the 7 L block linears' forward once,
    twice under remat "full" (the backward's recomputed forward; "save_linear"
    reads them back); their dx 7 L - 3 times (layer 0's wq, wk, wv see the
    embeddings, which need no gradient in LoRA training); flash forward L
    times, 2 L under "full", flash dq and dk, dv L times each, at head dim
    256 (`wide`) all on the WIDE_D tiles.  Mode "full" has no qmm."""
    runs = 2 if remat in ("full", True) else 1
    fwd_name, bwd_name = qmm_counters(quant_type)
    flash = {"flash_fwd": micro * runs * L, "flash_bwd_dq": micro * L,
             "flash_bwd_dkv": micro * L}
    counts = {**flash, **{k: flash[n] for k, n in WGMMA_COUNTS.items() if n in flash}}
    if wide:
        counts.update({k: flash[n] for k, n in WIDE_COUNTS.items()})
    if mode == "lora":
        fwd, bwd = micro * runs * 7 * L, micro * (7 * L - 3)
        counts.update({fwd_name: fwd, bwd_name: bwd})
        counts.update({"qmm_nf4_wgmma_dq": fwd, "qmm_nf4_wgmma_bwd": bwd} if quant_type == "nf4"
                      else {"qmm_i8_wgmma_fwd": fwd, "qmm_i8_wgmma_bwd": bwd})
    return expected_counts(**counts)


def train_parity_phase(dev, quant_type="nf4", cfg=None, S=256, remat="full", tag=None):
    """One collated micro-batch of 2 rows through ``loss_fn`` on 2 layers at
    full width, the plain path on the CPU against the kernels on the card:
    the loss and every LoRA gradient must agree, and the card's launches be
    exactly ``train_counts``'."""
    import torch

    from qlora_tpu_torch.models import init_params
    from qlora_tpu_torch.train import loss_fn
    from qlora_tpu_torch.train.optimizer import tree_leaves, tree_unflatten
    from qlora_tpu_torch.utils import move_to

    tag = tag or ("train-parity" if quant_type == "nf4" else f"train-parity-{quant_type}")
    cfg = dataclasses.replace(cfg, num_layers=2) if cfg else seven_b(num_layers=2)
    p_gpu = init_params(cfg, seed=21, device=dev, quant_type=quant_type)
    lora_gpu, lcfg = random_lora(cfg, dev, seed=22)
    p_cpu, lora_cpu = move_to(p_gpu, "cpu"), move_to(lora_gpu, "cpu")
    batch = collated_batch(cfg.vocab_size, 2, S, seed=23, stacked=0)
    lengths = batch["attention_mask"].sum(-1).tolist()

    def run(params, lora, device):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(lora)]
        mb = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        loss, n = loss_fn(tree_unflatten(lora, leaves), params, mb, cfg, lcfg, None, True,
                          "lora", remat)
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
    want = train_counts(cfg.num_layers, quant_type, remat, micro=1, wide=cfg.head_dim == 256)
    print(f"{tag}: 2 x {S} collated tokens (lengths {lengths}, {n_c} target tokens), remat "
          f"{remat!r}; loss card {loss_g.item():.5f} cpu {loss_c.item():.5f} |d|={d_loss:.3g} "
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


def default_remat():
    """The checkout's ``make_train_step`` default (this script may run in a
    checkout of another commit: ``python3 chip_smoke.py train``)."""
    import inspect

    from qlora_tpu_torch.train import make_train_step

    return inspect.signature(make_train_step).parameters["remat"].default


def train_model(dev, cfg, quant_type="nf4", seed=31):
    """Random weights (double quant) and a fresh rank-64 LoRA on all 7 block
    linears (B = 0)."""
    import torch

    from qlora_tpu_torch.lora import LoraConfig
    from qlora_tpu_torch.models import init_lora_params, init_params

    params = init_params(cfg, seed=seed, device=dev, quant_type=quant_type)
    lcfg = LoraConfig(r=64, alpha=16.0, dropout=0.0)
    lora = init_lora_params(cfg, lcfg, seed=seed + 1, device=dev)
    torch.cuda.synchronize()
    return params, lora, lcfg


def train_phase(dev, quant_type="nf4", steps=TRAIN_STEPS, remat=None, cfg=None, made=None,
                tag=None, name="LLaMA-7B"):
    """``make_train_step`` over full-depth random weights (``made``, or new
    ones): `steps` optimizer steps of TRAIN_ACCUM micro-batches on one
    collated batch, launch counts exact, the first step moving nothing, the
    loss falling, frozen tensors byte-identical.  Returns (counts, per-step
    counts, stats, made)."""
    import torch

    from qlora_tpu_torch.lora import count_lora_params
    from qlora_tpu_torch.train import init_train_state, make_optimizer, make_train_step

    remat = default_remat() if remat is None else remat
    tag = tag or ("train" if quant_type == "nf4" else f"train-{quant_type}")
    cfg = cfg or seven_b()
    rows, S = TRAIN_MICRO
    t0 = time.perf_counter()
    params, lora, lcfg = made or train_model(dev, cfg, quant_type)
    print(f"{tag}: {name} {cfg.num_layers} layers, random {quant_type} weights (double "
          f"quant) + a fresh rank-{lcfg.r} LoRA on all 7 block linears ({count_lora_params(lora) / 1e6:.1f}"
          f" M parameters){'' if made else f', made in {time.perf_counter() - t0:.1f} s'}; "
          f"remat {remat!r}", flush=True)
    frozen = frozen_tensors(params)
    if any(t.requires_grad for t in frozen):
        fail(f"{tag}: a frozen tensor asks for a gradient")
    before = [t.clone() for t in frozen]

    opt = make_optimizer("paged_adamw_32bit", TRAIN_LR, total_steps=steps)
    state = init_train_state(lora, opt, device=dev)
    step = make_train_step(cfg, lcfg, opt, accum_steps=TRAIN_ACCUM, remat=remat, device=dev)
    batch = collated_batch(cfg.vocab_size, rows, S, seed=33, stacked=TRAIN_ACCUM)
    real = int(batch["attention_mask"].sum())
    targets = int((batch["labels"][..., 1:] != -100).sum())

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
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

    per_step = train_counts(cfg.num_layers, quant_type, remat, wide=cfg.head_dim == 256)
    want = {k: v * steps for k, v in per_step.items()}
    step_s = sum(secs[1:]) / (steps - 1)        # the first step warms the allocator
    losses = [m[0] for m in metrics]
    print(f"{tag}: " + "; ".join(f"step {i} loss {l:.5f} grad_norm {g:.5f} {t:.2f} s"
                                for i, ((l, g), t) in enumerate(zip(metrics, secs))), flush=True)
    print(f"{tag}: {step_s:.3f} s per optimizer step (mean of steps 1..{steps - 1}; "
          f"{TRAIN_ACCUM} micro-batches of {rows} x {S}, remat {remat!r}) = "
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
    if steps > 2 and not losses[-1] < losses[0]:
        fail(f"{tag}: the loss did not fall ({losses})")
    if state.step != steps:
        fail(f"{tag}: state.step is {state.step}")
    changed = sum(not torch.equal(a, b) for a, b in zip(before, frozen_tensors(params)))
    print(f"{tag}: {len(before)} frozen tensors byte-identical after {steps} steps: "
          f"{changed == 0}", flush=True)
    if changed:
        fail(f"{tag}: {changed} frozen tensors changed")
    del state, before
    torch.cuda.empty_cache()
    return counts, per_step, dict(step_s=step_s, padded_tok_s=TRAIN_ACCUM * rows * S / step_s,
                                  real_tok_s=real / step_s, peak_gib=peak_gib, losses=losses,
                                  grad_norms=[m[1] for m in metrics], secs=secs,
                                  remat=remat), (params, lora, lcfg)


def train_remat_phase(dev, made, stats):
    """The train run's weights again under remat "full" and with no remat
    (TRAIN_REMAT_STEPS), beside the default "save_linear" run (`stats`): the
    step times and peaks of all three; peak("full") < peak("save_linear") <
    peak(False); the losses and gradient norms of "save_linear" and "full"
    within 1e-3 and GRAD_TOL of each other (the tape hands back the bits a
    recomputation gives, so they are expected bit-equal)."""
    runs = {stats["remat"]: stats}
    for remat, steps in TRAIN_REMAT_STEPS:
        _, _, runs[remat], _ = train_phase(dev, steps=steps, remat=remat, made=made,
                                           tag=f"train remat={remat}")
    base, full, none = runs["save_linear"], runs["full"], runs[False]
    n = len(full["losses"])
    d_loss = max(abs(a - b) for a, b in zip(base["losses"][:n], full["losses"]))
    d_norm = max(abs(a - b) / b for a, b in zip(base["grad_norms"][:n], full["grad_norms"]))
    bits = base["losses"][:n] == full["losses"] and base["grad_norms"][:n] == full["grad_norms"]
    print("train remat: " + "; ".join(
        f"{r!r} {runs[r]['step_s']:.3f} s/step (steps {', '.join(f'{t:.3f}' for t in runs[r]['secs'])})"
        f" peak {runs[r]['peak_gib']:.2f} GiB" for r in ("save_linear", "full", False))
        + f"; save_linear against full over {n} steps: max |d loss| {d_loss:.3g} (tol 1e-3), "
        f"max |d grad_norm| / grad_norm {d_norm:.3g} (tol {GRAD_TOL}), bit-equal {bits}; "
        f"save_linear saves {full['step_s'] - base['step_s']:.3f} s a step "
        f"({1 - base['step_s'] / full['step_s']:.1%}) for "
        f"{base['peak_gib'] - full['peak_gib']:.2f} GiB", flush=True)
    if not full["peak_gib"] < base["peak_gib"] < none["peak_gib"]:
        fail(f"train remat: peaks full {full['peak_gib']}, save_linear {base['peak_gib']}, "
             f"no remat {none['peak_gib']} are not in that order")
    if d_loss > 1e-3 or d_norm > GRAD_TOL:
        fail(f"train remat: save_linear and full differ (loss {d_loss}, grad_norm {d_norm})")
    return runs


def train_gemma_phase(dev):
    """gemma-7b (``google/gemma-7b``: 28 layers, hidden 3072, 16 heads of
    256, vocabulary 256000): train-parity at 2 layers and S = 512 under
    "save_linear", then TRAIN_GEMMA_STEPS steps at full depth, every flash
    launch on the head-dim-256 tiles."""
    import torch

    from qlora_tpu_torch.models import get_config

    cfg = get_config(GEMMA)
    t0 = time.perf_counter()
    worst = train_parity_phase(dev, cfg=cfg, S=TRAIN_MICRO[1], remat="save_linear",
                               tag="train-parity-gemma")
    print(f"train-parity-gemma: worst gradient difference {worst:.4g} <= {GRAD_TOL}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    counts, per_step, stats, made = train_phase(dev, steps=TRAIN_GEMMA_STEPS, cfg=cfg,
                                                tag="train-gemma", name="gemma-7b")
    del made
    torch.cuda.empty_cache()
    return counts, per_step, stats


def train_full_phase(dev):
    """``mode="full"``: every tensor of an unquantized LLaMA-7B-width model
    (TRAIN_FULL_LAYERS layers: bf16 weights, their f32 gradient sum and f32
    AdamW moments, 14 bytes a parameter, fit 80 GB), ``paged_adamw_32bit``,
    TRAIN_ACCUM micro-batches of TRAIN_MICRO, TRAIN_FULL_STEPS steps:
    remat "full" (forced), flash counts exact, no qmm, the first step moving
    nothing, the loss falling, every tensor moved (its sum or sum of squares,
    in f64, changed)."""
    import torch

    from qlora_tpu_torch.lora import LoraConfig
    from qlora_tpu_torch.models import init_params
    from qlora_tpu_torch.train import init_train_state, make_optimizer, make_train_step
    from qlora_tpu_torch.train.optimizer import tree_leaves

    tag = "train-full"
    cfg = seven_b(TRAIN_FULL_LAYERS)
    rows, S = TRAIN_MICRO
    steps = TRAIN_FULL_STEPS
    t0 = time.perf_counter()
    params = init_params(cfg, seed=41, quantized=False, device=dev)
    fingerprint = lambda tree: [(t.double().sum().item(), t.double().square().sum().item())
                                for t in tree_leaves(tree)]
    before = fingerprint(params)
    n_params = sum(t.numel() for t in tree_leaves(params))
    opt = make_optimizer("paged_adamw_32bit", TRAIN_LR, total_steps=steps)
    state = init_train_state(params, opt, device=dev)
    del params                # the state holds the only copy: each step makes new tensors
    step = make_train_step(cfg, LoraConfig(), opt, accum_steps=TRAIN_ACCUM, mode="full",
                           device=dev)
    batch = collated_batch(cfg.vocab_size, rows, S, seed=43, stacked=TRAIN_ACCUM)
    torch.cuda.synchronize()
    print(f"{tag}: LLaMA-7B width, {cfg.num_layers} layers, unquantized bf16 weights "
          f"({n_params / 1e9:.3f} B parameters, {len(before)} tensors, all trainable), made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    metrics, secs = [], []
    for _ in range(steps):
        t1 = time.perf_counter()
        state, m = step(state, None, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t1)
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    counts = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    per_step = train_counts(cfg.num_layers, remat="full", mode="full")
    want = {k: v * steps for k, v in per_step.items()}
    moved = sum(a != b for a, b in zip(before, fingerprint(state.trainable)))
    losses = [m[0] for m in metrics]
    step_s = sum(secs[1:]) / (steps - 1)
    print(f"{tag}: " + "; ".join(f"step {i} loss {l:.5f} grad_norm {g:.5f} {t:.2f} s"
                                for i, ((l, g), t) in enumerate(zip(metrics, secs))), flush=True)
    print(f"{tag}: {step_s:.3f} s per optimizer step (mean of steps 1..{steps - 1}); peak "
          f"memory {peak_gib:.2f} GiB; {moved} of {len(before)} tensors moved; launches "
          f"{counts} (expected {steps} x {per_step})", flush=True)
    if counts != want:
        fail(f"{tag} launch counts {counts} != {want}")
    if not torch.isfinite(torch.tensor(metrics)).all() or min(m[1] for m in metrics) <= 0:
        fail(f"{tag}: a loss or gradient norm is not finite or 0: {metrics}")
    if abs(losses[1] - losses[0]) > 1e-3 or not losses[-1] < losses[0]:
        fail(f"{tag}: the first step moved the loss or the loss did not fall ({losses})")
    if moved != len(before):
        fail(f"{tag}: only {moved} of {len(before)} tensors moved")
    del state
    torch.cuda.empty_cache()
    return counts, dict(step_s=step_s, peak_gib=peak_gib, losses=losses)


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
    "decode_attention_cuda": ("qlora_tpu_torch/csrc/decode_attention_split.cu",
                              "qlora_tpu/ops/decode_attention.py:207 (fused_decode_attention, "
                              "pallas_call at :276)"),
    # the NF4 dx: the wgmma kernel at its headline (M = 1024)
    "qmm_nf4_bwd": ("qlora_tpu_torch/csrc/qmm_nf4_bwd_wgmma.cu",
                    "qlora_tpu/ops/qmatmul.py:651 (_qmm_bwd_pallas)"),
    "flash_fwd": ("qlora_tpu_torch/csrc/flash_attention_wgmma.cu",
                  "qlora_tpu/ops/flash_attention.py:196 (_flash_fwd, pallas_call at :224)"),
    "flash_bwd_dq": ("qlora_tpu_torch/csrc/flash_attention_wgmma.cu",
                     "qlora_tpu/ops/flash_attention.py:419 (_flash_bwd, pallas_call at :449)"),
    "flash_bwd_dkv": ("qlora_tpu_torch/csrc/flash_attention_wgmma.cu",
                      "qlora_tpu/ops/flash_attention.py:419 (_flash_bwd, pallas_call at :476)"),
    # the same three at head dim 256 (the WIDE_D tiles; launches from train-gemma)
    "flash_fwd_hd256": ("qlora_tpu_torch/csrc/flash_attention_wgmma.cu",
                        "qlora_tpu/ops/flash_attention.py:196 (_flash_fwd, pallas_call at :224; "
                        "head_dim 256)"),
    "flash_bwd_dq_hd256": ("qlora_tpu_torch/csrc/flash_attention_wgmma.cu",
                           "qlora_tpu/ops/flash_attention.py:419 (_flash_bwd, pallas_call at "
                           ":449; head_dim 256)"),
    "flash_bwd_dkv_hd256": ("qlora_tpu_torch/csrc/flash_attention_wgmma.cu",
                            "qlora_tpu/ops/flash_attention.py:419 (_flash_bwd, pallas_call at "
                            ":476; head_dim 256)"),
    # the direct int8 w8a8 forward: the decode kernel at its headline (M = 4)
    "qmm_i8_direct": ("qlora_tpu_torch/csrc/qmm_i8_direct_decode.cu",
                      "qlora_tpu/ops/qmatmul.py:325 (_qmm_pallas_i8_direct, pallas_call at "
                      ":358; M <= 16)"),
    # the w8a8 forward over NF4: the int8 wgmma kernel at its headline (M = 512)
    "qmm_nf4_w8a8": ("qlora_tpu_torch/csrc/qmm_nf4_w8a8_wgmma.cu",
                     "qlora_tpu/ops/qmatmul.py:239 (_qmm_pallas_w8a8, pallas_call at :270)"),
    # the w8a8 forward over NF4 at decode rows: its decode kernel at its headline (M = 4)
    "qmm_nf4_w8a8_decode": ("qlora_tpu_torch/csrc/qmm_nf4_w8a8_decode.cu",
                            "qlora_tpu/ops/qmatmul.py:239 (_qmm_pallas_w8a8, pallas_call at "
                            ":270; M <= 16)"),
    # the int8 forward and dx: the wgmma kernel at their headline (M = 1024)
    "qmm_i8_fwd": ("qlora_tpu_torch/csrc/qmm_i8_wgmma.cu",
                   "qlora_tpu/ops/qmatmul.py:432 (_qmm_pallas_i8)"),
    # the int8 forward at decode rows: the same wrapper, its decode kernel's entry
    "qmm_i8_fwd_decode": ("qlora_tpu_torch/csrc/qmm_i8_decode.cu",
                          "qlora_tpu/ops/qmatmul.py:432 (_qmm_pallas_i8, pallas_call at :446; "
                          "M <= 16)"),
    "qmm_i8_bwd": ("qlora_tpu_torch/csrc/qmm_i8_wgmma.cu",
                   "qlora_tpu/ops/qmatmul.py:475 (_qmm_bwd_pallas_i8)"),
    # the paged decode step: the split kernel, at the chunk of one token
    "paged_decode_attention_cuda": ("qlora_tpu_torch/csrc/paged_attention_split.cu",
                                    "qlora_tpu/ops/paged_attention.py:217 "
                                    "(fused_paged_decode_attention, pallas_call at :277)"),
    # the verify chunk (C = 5): the split kernel
    "paged_chunk_attention_cuda": ("qlora_tpu_torch/csrc/paged_attention_split.cu",
                                   "qlora_tpu/ops/paged_attention.py:478 "
                                   "(fused_paged_chunk_attention, pallas_call at :544)"),
}
# the NF4 forward's three sources, by shape (ops/qmatmul.py: DECODE_ROWS, tile_plan)
NF4_SOURCES = {"M <= 16": "qlora_tpu_torch/csrc/qmm_nf4_decode.cu",
               "M > 16": "qlora_tpu_torch/csrc/qmm_nf4_wgmma.cu",
               "M > 16, K % 16 != 0": "qlora_tpu_torch/csrc/qmm_nf4_fwd.cu"}
# the NF4 dx's two sources, by shape (ops/qmatmul.py: nf4_bwd_tile_plan)
NF4_BWD_SOURCES = {"M > 16": "qlora_tpu_torch/csrc/qmm_nf4_bwd_wgmma.cu",
                   "M <= 16, or N % 8 != 0": "qlora_tpu_torch/csrc/qmm_nf4_bwd.cu"}
# the int8 forward's and dx's three sources, by shape (ops/qmatmul.py:
# i8_decode_plan, i8_tile_plan)
I8_SOURCES = {"M <= 16, forward": "qlora_tpu_torch/csrc/qmm_i8_decode.cu",
              "M > 16": "qlora_tpu_torch/csrc/qmm_i8_wgmma.cu",
              "M <= 16 backward, or M > 16 and a contraction % 8 != 0":
                  "qlora_tpu_torch/csrc/qmm_i8.cu"}
# the w8a8 forward's two sources over NF4, by shape (ops/qmatmul.py: w8a8_tile_plan)
W8A8_SOURCES = {"M <= 16": "qlora_tpu_torch/csrc/qmm_nf4_w8a8_decode.cu",
                "M > 16": "qlora_tpu_torch/csrc/qmm_nf4_w8a8_wgmma.cu",
                "M <= 16 and K % 64, N % 16 or the block size % 32 not 0; M > 16 and K % 32, "
                "N % 8 or the block size % 8 not 0": "qlora_tpu_torch/csrc/qmm_i8_direct.cu"}
# the direct int8 w8a8 forward's two sources, by shape (ops/qmatmul.py:
# i8_direct_decode_plan)
I8_DIRECT_SOURCES = {"M <= 16": "qlora_tpu_torch/csrc/qmm_i8_direct_decode.cu",
                     "M > 16, or K % 32 or N % 16 not 0": "qlora_tpu_torch/csrc/qmm_i8_direct.cu"}
# summary entries read from another wrapper's rows, and the rows they keep
# (by the row count in the shape): the int8 forward's decode kernel and its
# wgmma kernel share the rows of qmm_i8_fwd
def _rows(shape):
    return int(shape.split()[0][2:]) if shape.startswith("M=") else 0


RESULT_OF = {"qmm_i8_fwd_decode": ("qmm_i8_fwd", lambda s: _rows(s) <= 16),
             "qmm_i8_fwd": ("qmm_i8_fwd", lambda s: _rows(s) > 16),
             "qmm_nf4_w8a8_decode": ("qmm_nf4_w8a8", lambda s: _rows(s) <= 16),
             "qmm_nf4_w8a8": ("qmm_nf4_w8a8", lambda s: _rows(s) > 16),
             **{f"{n}{hd}": (n, (lambda s: "hd=256" in s) if hd else (lambda s: "hd=256" not in s))
                for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv") for hd in ("", "_hd256")}}
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
            # train-gemma's micro-batch: 2 x 16 heads of 256 x 512 tokens
            **{f"flash_{k}_hd256": "B=2 H=16 KVH=16 hd=256 S=512 lens=[512, 300]"
               for k in ("fwd", "bwd_dq", "bwd_dkv")},
            # the int8 decode step's most common launch, the serve-paged w8a8 prefill's
            # commonest (one row at bucket 512; the run whose launches the w8a8 kernel's
            # entry counts), the int8 base's train step
            "qmm_i8_direct": "M=4 K=4096 N=4096", "qmm_nf4_w8a8": "M=512 K=4096 N=4096",
            # the w8a8 decode step over NF4 (serve-paged-w8a8), at generate()'s batch
            "qmm_nf4_w8a8_decode": "M=4 K=4096 N=4096",
            "qmm_i8_fwd": "M=1024 K=4096 N=4096 dq", "qmm_i8_bwd": "M=1024 K=4096 N=4096 dq",
            # the int8 base's decode step (serve-i8base), its commonest launch
            "qmm_i8_fwd_decode": "M=4 K=4096 N=4096 dq",
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
    the kernel phase on the decode kernel (its rows quantized inside it), and
    what qmm_i8_direct.cu, the "before", takes for them on rows quantized
    beforehand."""
    rows = {r["shape"]: r for r in results if r["name"] == "qmm_i8_direct"}
    lin = {k: rows[f"M=4 K={k[0]} N={k[1]}"] for k in QMM_SHAPES + (LM_HEAD_SHAPE,)}
    per_step = lambda key: num_layers * (4 * lin[(4096, 4096)][key] + 2 * lin[(4096, 11008)][key]
                                         + lin[(11008, 4096)][key]) + lin[LM_HEAD_SHAPE][key]
    qmm = per_step("ms")
    attn = num_layers * next(r["ms"] for r in results if r["name"] == "decode_attention_cuda")
    step = stats["decode_ms_per_step"]
    return dict(step_ms=step, step_qmm_ms=qmm, step_qmm_before_ms=per_step("tile_ms"),
                step_attention_ms=attn, step_other_ms=step - qmm - attn)


def serve_w8a8_split(results, num_layers, stats):
    """serve-paged-w8a8's decode step by kernel, as :func:`serve_split`: 7
    ``qmm_nf4_w8a8`` launches a layer at M = 8 (the batcher's slots) on the
    decode kernel, each at its time alone in the kernel phase, and what
    qmm_i8_direct.cu's NF4 entry, the "before", takes for them on rows
    quantized beforehand; one paged decode attention a layer at the kernel
    phase's headline."""
    rows = {r["shape"]: r for r in results if r["name"] == "qmm_nf4_w8a8"}
    lin = {k: rows[f"M={PAGED_B} K={k[0]} N={k[1]}"] for k in QMM_SHAPES}
    per_step = lambda key: num_layers * (4 * lin[(4096, 4096)][key] + 2 * lin[(4096, 11008)][key]
                                         + lin[(11008, 4096)][key])
    attn = num_layers * next(r["ms"] for r in results
                             if r["name"] == "paged_decode_attention_cuda")
    qmm, step = per_step("ms"), stats["ms_per_step"]
    return dict(step_ms=step, step_qmm_ms=qmm, step_qmm_before_ms=per_step("tile_ms"),
                step_attention_ms=attn, step_other_ms=step - qmm - attn)


def w8a8_prefill_split(results, num_layers, stats):
    """serve-paged-int8's w8a8 prefill forwards by kernel: 7 ``qmm_nf4_w8a8``
    launches a layer per forward, each at its kernel-phase time at the nearest
    timed row count (W8A8_ROWS), on the wgmma kernel (``ms``) and on
    qmm_i8_direct.cu (``tile_ms``, the "before")."""
    rows = {r["shape"]: r for r in results if r["name"] == "qmm_nf4_w8a8"}
    timed = [m for m in W8A8_ROWS if m > 16]
    total = dict(ms=0.0, tile_ms=0.0)
    for m in stats["prefill_rows"]:
        near = min(timed, key=lambda t: abs(t - m))
        for key in total:
            total[key] += num_layers * (
                4 * rows[f"M={near} K=4096 N=4096"][key] + 2 * rows[f"M={near} K=4096 N=11008"][key]
                + rows[f"M={near} K=11008 N=4096"][key])
    n = max(stats["prefill_forwards"], 1)
    return dict(prefill_ms=stats["prefill_ms"], qmm_ms=total["ms"] / n,
                qmm_before_ms=total["tile_ms"] / n)


def chunk_split(results, num_layers, stats):
    """serve-paged-spec's verify step: one chunk attention launch a layer at
    the kernel phase's full-attention chunk time (the split kernel, and
    paged_attention.cu's chunk entry, the "before")."""
    head = next(r for r in results if r["name"] == "paged_chunk_attention_cuda"
                and r["shape"].startswith(HEADLINE["paged_chunk_attention_cuda"]))
    return dict(step_ms=stats["ms_per_chunk"], attention_ms=num_layers * head["ms"],
                attention_before_ms=num_layers * head["tile_ms"])


def serve_i8base_split(results, num_layers, stats):
    """The int8 base's decode step by kernel, as :func:`serve_split`: 7
    ``qmm_i8_fwd`` launches per layer at M = 4 on the decode kernel (and
    what ``qmm_i8.cu``'s 16-row branch, the "before", takes for them), each
    at its time alone in the kernel phase (double-quantized absmax), and
    decode attention."""
    rows = {r["shape"]: r for r in results if r["name"] == "qmm_i8_fwd"}
    lin = {k: rows[f"M=4 K={k[0]} N={k[1]} dq absmax"] for k in QMM_SHAPES}
    per_layer = lambda key: (4 * lin[(4096, 4096)][key] + 2 * lin[(4096, 11008)][key]
                             + lin[(11008, 4096)][key])
    attn = num_layers * next(r["ms"] for r in results if r["name"] == "decode_attention_cuda")
    step = stats["decode_ms_per_step"]
    qmm = num_layers * per_layer("ms")
    return dict(prefill_ms=stats["prefill_ms"], step_ms=step, step_qmm_ms=qmm,
                step_qmm_before_ms=num_layers * per_layer("tile_ms"), step_attention_ms=attn,
                step_other_ms=step - qmm - attn)


def train_only(dev) -> None:
    """``python3 chip_smoke.py train``: the train phase alone, at the
    checkout's default remat, to time it in turns with another checkout (its
    parent) that this script is copied into."""
    _, _, stats, _ = train_phase(dev)
    print(f"train only (remat {stats['remat']!r}): {stats['step_s']:.3f} s per optimizer step, "
          f"peak {stats['peak_gib']:.2f} GiB", flush=True)


def serve_w8a8_only(dev) -> None:
    """``python3 chip_smoke.py serve-paged-w8a8``: the serve weights and
    serve-paged-w8a8 alone, to time the route in turns with another checkout
    (its parent) that this script is copied into; the launch counts are
    checked where the checkout's ``qmm_nf4_w8a8`` has its decode kernel."""
    import torch

    from qlora_tpu_torch.generate import generate
    from qlora_tpu_torch.models import init_params
    from qlora_tpu_torch.ops import qmm_nf4_w8a8

    cfg = seven_b()
    params = init_params(cfg, seed=7, device=dev)
    lora, lcfg = random_lora(cfg, dev, seed=8)
    ids, lengths = padded_requests(SERVE_LENGTHS, max(SERVE_LENGTHS), cfg.vocab_size, 9)
    generate(params, lora, ids[:, :16], torch.full((4,), 16), cfg, lcfg,
             max_new_tokens=2, eos_id=-1, device=dev)
    traffic = paged_traffic(cfg.vocab_size, SERVE_PAGED_SEED, SERVE_PAGED_REQUESTS)
    decode = hasattr(qmm_nf4_w8a8, "decode_launches")
    _, stats = serve_paged_w8a8(dev, cfg, params, lora, lcfg, traffic, check=decode)
    print(f"serve-paged-w8a8 only ({'qmm_nf4_w8a8_decode.cu' if decode else 'qmm_i8_direct.cu'}"
          f" at decode rows): {stats['ms_per_step']:.2f} ms per decode step, "
          f"{stats['tok_s']:.1f} tok/s", flush=True)


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

    single = {"serve-paged-w8a8": serve_w8a8_only, "train": train_only,
              "train-gemma": lambda dev: train_gemma_phase(dev)}
    if sys.argv[1:]:
        if len(sys.argv) != 2 or sys.argv[1] not in single:
            print(f"chip_smoke: one phase alone is one of {sorted(single)}", file=sys.stderr)
            return 2
        single[sys.argv[1]](dev)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0
    results = []
    t0 = time.perf_counter()
    kernel_phase(dev, results)
    flash_phase(dev, results)
    gemma_qmm_phase(dev, results)
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
    worst = parity_phase(dev, "int8")
    print(f"parity-i8base: worst max|d| {worst:.4g} <= {LOGIT_TOL}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
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
     (paged_counts, paged_stats, paged8_counts, paged8_stats, pagedw_counts, pagedw_stats),
     (spec_counts, spec_stats)) = serve_phase(dev)
    print(f"serve, serve-int8, serve-paged and serve-paged-spec: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    i8base_counts, i8base_stats = serve_i8base_phase(dev, serve_stats)
    print(f"serve-i8base: {time.perf_counter() - t0:.1f} s", flush=True)
    nodq_counts = nodq_phase(dev)
    t0 = time.perf_counter()
    worst = train_parity_phase(dev)
    print(f"train-parity: worst gradient difference {worst:.4g} <= {GRAD_TOL}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    train_counts, train_per_step, train_stats, made = train_phase(dev)
    print(f"train: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    remat_runs = train_remat_phase(dev, made, train_stats)
    del made
    torch.cuda.empty_cache()
    print(f"train remat: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    worst = train_parity_phase(dev, "int8")
    train8_counts, train8_per_step, train8_stats, _ = train_phase(dev, "int8", TRAIN_INT8_STEPS)
    print(f"train-int8: worst gradient difference {worst:.4g} <= {GRAD_TOL}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gemma_counts, gemma_per_step, gemma_stats = train_gemma_phase(dev)
    print(f"train-gemma: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    full_counts, full_stats = train_full_phase(dev)
    print(f"train-full: {time.perf_counter() - t0:.1f} s", flush=True)

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
                    qmm_nf4_w8a8_decode=pagedw_counts["qmm_nf4_w8a8_decode"],
                    qmm_i8_fwd=train8_counts["qmm_i8_fwd"],
                    qmm_i8_fwd_decode=i8base_counts["qmm_i8_decode_fwd"],
                    qmm_i8_bwd=train8_counts["qmm_i8_bwd"],
                    paged_decode_attention_cuda=paged_counts["paged_decode_attention_cuda"],
                    paged_chunk_attention_cuda=spec_counts["paged_chunk_attention_cuda"],
                    flash_fwd_hd256=gemma_counts["flash_wide_fwd"],
                    flash_bwd_dq_hd256=gemma_counts["flash_wide_bwd_dq"],
                    flash_bwd_dkv_hd256=gemma_counts["flash_wide_bwd_dkv"])
    idle = [name for name in SOURCES if launches[name] <= 0]
    if idle:
        fail(f"kernels never launched on their main path: {idle}")
    summary = []
    for name, (source, replaces) in SOURCES.items():
        of, keep = RESULT_OF.get(name, (name, lambda s: True))
        rows = [r for r in results if r["name"] == of and keep(r["shape"])]
        head = next(r for r in rows if r["shape"].startswith(HEADLINE[name]))
        summary.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head["shape"],
            **({"tile_ms": head["tile_ms"]} if "tile_ms" in head else {}),
            **({"exact_ms": head["exact_ms"]} if "exact_ms" in head else {}),
            # the w8a8 kernels' "ms" is the kernel alone; with the wrapper's row
            # quantization (PyTorch ops), as the decode step pays it.  The flash
            # kernels' "ms" is their device time in CUDA graphs; their wrappers
            # launched back to back, timed with events:
            **({"wrapper_ms": head["wrapper_ms"]} if "wrapper_ms" in head else {}),
            **({"tile_wrapper_ms": head["tile_wrapper_ms"]} if "tile_wrapper_ms" in head else {}),
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
        if entry["name"] == "qmm_nf4_bwd":
            head = next(r for r in results if r["name"] == entry["name"]
                        and r["shape"] == entry["shape"])
            entry.update(sources=NF4_BWD_SOURCES,
                         wgmma_launches=train_counts["qmm_nf4_wgmma_bwd"],
                         tile_ms=head["tile_ms"])
        if entry["name"].startswith("flash_") and entry["name"].endswith("_hd256"):
            entry.update(wide_launches=gemma_counts[
                entry["name"].replace("flash_", "flash_wide_").replace("_hd256", "")])
        elif entry["name"].startswith("flash_"):
            head = next(r for r in results if r["name"] == entry["name"]
                        and r["shape"] == entry["shape"])
            entry.update(before_source="qlora_tpu_torch/csrc/flash_attention.cu",
                         wgmma_launches=train_counts[
                             entry["name"].replace("flash_", "flash_wgmma_")],
                         tile_ms=head["tile_ms"])
        if entry["name"] in ("qmm_i8_fwd", "qmm_i8_bwd"):
            d = "fwd" if entry["name"] == "qmm_i8_fwd" else "bwd"
            entry.update(sources=I8_SOURCES, wgmma_launches=train8_counts[f"qmm_i8_wgmma_{d}"])
        if entry["name"] == "qmm_i8_fwd_decode":
            entry.update(sources=I8_SOURCES, before_source="qlora_tpu_torch/csrc/qmm_i8.cu",
                         decode_launches=i8base_counts["qmm_i8_decode_fwd"])
        if entry["name"] == "decode_attention_cuda":
            entry.update(before_source="qlora_tpu_torch/csrc/decode_attention.cu")
        if entry["name"] == "qmm_nf4_w8a8":
            head = next(r for r in results if r["name"] == entry["name"]
                        and r["shape"] == entry["shape"])
            entry.update(sources=W8A8_SOURCES,
                         before_source="qlora_tpu_torch/csrc/qmm_i8_direct.cu",
                         wgmma_launches=paged8_counts["qmm_nf4_w8a8_wgmma"])
        if entry["name"] == "qmm_nf4_w8a8_decode":
            entry.update(sources=W8A8_SOURCES,
                         before_source="qlora_tpu_torch/csrc/qmm_i8_direct.cu",
                         decode_launches=pagedw_counts["qmm_nf4_w8a8_decode"])
        if entry["name"] == "paged_chunk_attention_cuda":
            entry.update(before_source="qlora_tpu_torch/csrc/paged_attention.cu",
                         split_launches=spec_counts["paged_chunk_split"])
        if entry["name"] == "paged_decode_attention_cuda":
            entry.update(before_source="qlora_tpu_torch/csrc/paged_attention.cu",
                         split_launches=paged_counts["paged_decode_split"])
        if entry["name"] == "qmm_i8_direct":
            entry.update(sources=I8_DIRECT_SOURCES,
                         before_source="qlora_tpu_torch/csrc/qmm_i8_direct.cu",
                         decode_launches=int8_counts["qmm_i8_direct_decode"])
    summary[0]["launches_train"] = train_counts["qmm_nf4_fwd_dq"]
    summary[0]["wgmma_launches_train"] = train_counts["qmm_nf4_wgmma_dq"]
    split = serve_split(results, seven_b().num_layers, serve_stats)
    print(f"serve: prefill {split['prefill_ms']:.1f} ms, of which qmm kernels "
          f"~{split['prefill_qmm_ms']:.1f} ms; decode step {split['step_ms']:.2f} ms = qmm "
          f"kernels ~{split['step_qmm_ms']:.2f} ms + decode attention "
          f"~{split['step_attention_ms']:.2f} ms + other ~{split['step_other_ms']:.2f} ms "
          "(kernel-phase times x launches)", flush=True)
    s8 = serve_int8_split(results, seven_b().num_layers, int8_stats)
    print(f"serve-int8: decode step {s8['step_ms']:.2f} ms = qmm_i8_direct decode kernels "
          f"~{s8['step_qmm_ms']:.2f} ms (before: qmm_i8_direct.cu ~{s8['step_qmm_before_ms']:.2f} "
          f"ms) + decode attention ~{s8['step_attention_ms']:.2f} ms + "
          f"other ~{s8['step_other_ms']:.2f} ms (the host launching the kernels, and the small "
          f"PyTorch ops: it differs from call to call); kernel time of a step "
          f"{s8['step_qmm_ms'] + s8['step_attention_ms']:.2f} ms against the NF4 path's "
          f"{split['step_qmm_ms'] + split['step_attention_ms']:.2f} ms; on the host's clock the "
          f"NF4 step is {split['step_ms'] / s8['step_ms']:.2f} x as long in this run", flush=True)
    i8b = serve_i8base_split(results, seven_b().num_layers, i8base_stats)
    print(f"serve-i8base: decode step {i8b['step_ms']:.2f} ms = qmm_i8_fwd decode kernels "
          f"~{i8b['step_qmm_ms']:.2f} ms (before: qmm_i8.cu's 16-row branch ~"
          f"{i8b['step_qmm_before_ms']:.2f} ms) + decode attention "
          f"~{i8b['step_attention_ms']:.2f} ms + other ~{i8b['step_other_ms']:.2f} ms "
          f"(kernel-phase times x launches); prefill {i8b['prefill_ms']:.1f} ms; against the NF4 "
          f"step's {split['step_ms']:.2f} ms in this run", flush=True)
    paged_head = next(r for r in results if r["name"] == "paged_decode_attention_cuda")
    paged_attn = seven_b().num_layers * paged_head["ms"]
    paged_qmm = qmm_ms_per_forward(results, seven_b().num_layers, PAGED_B)
    verify_qmm = qmm_ms_per_forward(results, seven_b().num_layers, PAGED_B * (SPEC_DRAFT + 1))
    print(f"serve-paged: {PAGED_B} slots, {paged_stats['tok_s']:.1f} tok/s over the run "
          f"(admissions included), {paged_stats['ms_per_step']:.2f} ms per decode step (qmm "
          f"kernels ~{paged_qmm:.2f} ms and paged attention ~{paged_attn:.2f} ms of it, on "
          f"paged_attention.cu, the before: ~{seven_b().num_layers * paged_head['tile_ms']:.2f} "
          "ms; kernel-phase times x launches), against generate()'s 4 rows at "
          f"{serve_stats['decode_tok_s']:.1f} tok/s and {serve_stats['decode_ms_per_step']:.2f} "
          f"ms/step; int8 decode and w8a8 prefill {paged8_stats['tok_s']:.1f} tok/s, "
          f"{paged8_stats['ms_per_step']:.2f} ms/step; speculation "
          f"{spec_stats['tokens_per_chunk']:.3f} tokens per chunk, "
          f"{spec_stats['ms_per_chunk']:.2f} ms per verify step (qmm kernels ~{verify_qmm:.2f} ms "
          f"of it at M={PAGED_B * (SPEC_DRAFT + 1)})", flush=True)
    sw = serve_w8a8_split(results, seven_b().num_layers, pagedw_stats)
    print(f"serve-paged-w8a8: {pagedw_stats['tok_s']:.1f} tok/s over the run (admissions "
          f"included); decode step {sw['step_ms']:.2f} ms = qmm_nf4_w8a8 decode kernels "
          f"~{sw['step_qmm_ms']:.2f} ms (before: qmm_i8_direct.cu's NF4 entry "
          f"~{sw['step_qmm_before_ms']:.2f} ms on rows quantized and scales made beforehand) + "
          f"paged decode attention ~{sw['step_attention_ms']:.2f} ms + other "
          f"~{sw['step_other_ms']:.2f} ms (kernel-phase times x launches); serve-paged's NF4 step "
          f"{paged_stats['ms_per_step']:.2f} ms and serve-paged-int8's "
          f"{paged8_stats['ms_per_step']:.2f} ms in this run", flush=True)
    w8 = w8a8_prefill_split(results, seven_b().num_layers, paged8_stats)
    ch = chunk_split(results, seven_b().num_layers, spec_stats)
    print(f"serve-paged-int8: w8a8 prefill {w8['prefill_ms']:.2f} ms per prefill forward "
          f"({paged8_stats['prefill_forwards']} forwards), of which qmm_nf4_w8a8 kernels "
          f"~{w8['qmm_ms']:.2f} ms (on qmm_i8_direct.cu, the before: ~{w8['qmm_before_ms']:.2f} "
          f"ms); serve-paged-spec: verify step {ch['step_ms']:.2f} ms, of which chunk attention "
          f"~{ch['attention_ms']:.2f} ms (on paged_attention.cu, the before: "
          f"~{ch['attention_before_ms']:.2f} ms) and qmm kernels ~{verify_qmm:.2f} ms "
          "(kernel-phase times x launches)", flush=True)
    ts = train_split(results, train_per_step, train_stats)
    print(f"train: optimizer step {ts['step_ms']:.0f} ms = qmm forward kernel "
          f"~{ts['qmm_fwd_ms']:.0f} ms ({train_per_step['qmm_nf4_fwd_dq']} launches) + qmm_nf4_bwd "
          f"wgmma kernel ~{ts['qmm_bwd_ms']:.0f} ms ({train_per_step['qmm_nf4_bwd']}) + flash "
          f"forward ~{ts['flash_fwd_ms']:.1f} ms ({train_per_step['flash_fwd']}) + flash dq "
          f"~{ts['flash_bwd_dq_ms']:.1f} ms ({train_per_step['flash_bwd_dq']}) + flash dk, dv "
          f"~{ts['flash_bwd_dkv_ms']:.1f} ms ({train_per_step['flash_bwd_dkv']}) + other "
          f"~{ts['other_ms']:.0f} ms (kernel-phase times x launches)", flush=True)
    print(f"train remat: step {', '.join(f'{r!r} {v['step_s']:.3f} s' for r, v in remat_runs.items())}"
          f"; peak {', '.join(f'{r!r} {v['peak_gib']:.2f} GiB' for r, v in remat_runs.items())}"
          f"; train-gemma {gemma_stats['step_s']:.3f} s/step, peak {gemma_stats['peak_gib']:.2f} "
          f"GiB ({gemma_per_step['flash_wide_fwd']} flash forward, "
          f"{gemma_per_step['qmm_nf4_fwd_dq']} NF4 forward a step); train-full "
          f"{full_stats['step_s']:.3f} s/step, peak {full_stats['peak_gib']:.2f} GiB", flush=True)
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
