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
   (identity rows of g read out columns of ``dequantize``'s weight).  At 1,
   4, 8 and 16 rows the NF4 dx runs the split-N decode kernel of
   ``qmm_nf4_bwd_decode.cu``, f32 and double-quantized absmax: within
   QMM_TOL, two calls, each row alone and identity rows bit for bit, timed in
   CUDA graphs beside ``qmm_nf4_bwd.cu`` through its C entry (``tile_ms``,
   the "before") and ``g @ Wᵀ``; a ragged shape its plan accepts and one it
   refuses (N % 16 != 0: ``qmm_nf4_bwd.cu`` takes it).  Flash
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
   ``qmm_i8_direct`` at 17, 24, 33, 40 (a verify chunk of 8 slots x 5) and
   64 rows runs the same kernel on its verify plan (two warps side by side
   over a strip, up to 8 B tiles of 8 rows), with the same checks and rows
   of the identity reading the codes out of its int32 sums, timed as at
   decode rows; ``qmm_i8_direct.cu`` at 128 and 512 rows, past the kernel's
   64, bit for bit and timed beside ``torch._int_mm`` (measured only).
   ``qmm_i8_fwd`` (M = 4, 8, 16, 1024, 2048) and ``qmm_i8_bwd`` (M = 1, 4,
   8, 16 on the split-N decode kernel of ``qmm_i8_bwd_decode.cu``, checked
   and timed as the NF4 dx's, and 1024) within the NF4 kernels'
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
   requests whose prompts repeat a 16-token phrase.  Then
   serve-paged-spec-int8: the same requests with ``decode_impl="int8"``,
   every verify chunk's 40 rows and every decode step on
   ``qmm_i8_direct_decode.cu`` (exact counts); its tokens held to the same
   requests without drafts up to each request's first near-tie, and every
   token it emitted within NEAR_TIE of the best teacher-forced logit.
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
20. train-data (after train remat, on the train phase's weights): the
   training run's data and state.  A seeded alpaca-format .jsonl of 64 examples
   in a temporary directory through ``make_dataset`` (8 held out) and the
   collator (``FakeTokenizer``: no ``transformers`` on the card; source 384,
   target 128, padded to 512; truncation and source masking both checked
   to occur), micro-batches of 2 x 512 in ``bucket_batches``' seeded order,
   2 a step; a fresh rank-64 LoRA (dropout 0), ``paged_adamw_32bit`` warming
   up over 4 of 5 steps.  Run A takes 5 steps, each logged through
   ``MetricsLogger`` and ``StepTimer``, step 2 under ``maybe_profile`` (the
   10 CUDA operations with the most device time and the step's device-busy
   time against its wall time, printed only), and checkpoints after step 3;
   run B finds ``checkpoint-3`` with ``get_last_checkpoint``, loads it into
   a fresh LoRA and optimizer state and takes steps 4 and 5 on the same
   micro-batches: losses, gradient norms and every LoRA tensor equal run
   A's bit for bit, launch counts exact in both runs, then the completed
   sentinel.  The 32-layer NF4 base through ``save_quantized`` and
   ``load_quantized`` onto the card: every tensor byte-equal, a 128-token
   prefill's logits and 8 greedy tokens of ``generate()`` bit-equal.  A
   2-layer LLaMA-7B-width checkpoint in HF's names, bf16 safetensors
   written by a few lines here, through ``load_hf_model`` onto the card and
   onto the CPU: prefill logits within LOGIT_TOL.  Sizes and seconds are
   printed beside the card's name and power limit.
21. cli (the second process's first phase): the driver,
   ``qlora_tpu_torch.cli.main(argv)`` in process, on ``huggyllama/llama-7b`` at full width and depth
   (``--init_random --fake_tokenizer``, dropout 0) over an alpaca .jsonl of
   64 examples (8 held out), on the train cell's shapes (2 x 512: source 384
   + target 128, 2 micro-batches a step, no length grouping).  Run A takes 6
   steps (checkpoints every 2, 2 kept), evaluates at step 6 and at the end,
   scores 16 rows of the bundled five-shot MMLU file at
   ``--mmlu_source_max_len 2032`` (S = 2048: flash) and predicts the 8 eval
   prompts (32 tokens): exact launch counts (every NF4 forward and dx and
   every flash launch on the wgmma kernels, the predict decode on the NF4
   decode kernel and split-KV decode attention), finite losses that fall,
   eval and MMLU in range, one prediction an example, ``metrics.json``.  Run
   B trains 4 steps in a fresh directory, then resumes from
   ``checkpoint-4`` to 6: losses and final LoRA bit-equal to run A's.  Then
   ``python3 -m qlora_tpu_torch.cli`` on run A's directory exits 0 with
   "training already completed".
22. serve-http: ``qlora_tpu_torch.serve_openai.ServingEngine`` over the serve
   phase's kind of model (LLaMA-7B width, 16 layers: HTTP_LAYERS, 32 until
   the tp phase joined the run; random NF4, a rank-64 LoRA) with
   serve-paged's engine (8 slots, pages of 64, buckets 128/256/512, admit 4,
   32 pages: it preempts; greedy), behind ``ThreadingHTTPServer`` on
   127.0.0.1: 16 concurrent clients (12 completions, 4 chats, half of each
   streamed; prompts of 64-512 tokens and budgets of 16-64 from
   serve-paged's seed), the last refused with 400 for its temperature;
   admission starts once the other 15 are in, in the clients' order, so
   that the schedule is the direct run's below whatever order the threads
   ran in (with arrivals racing, this traffic preempts in some orders and
   not in others).  Every
   other answer 200, within its budget, each stream ending in ``[DONE]``,
   ``engine.error`` None, exact launch counts (the paged split kernels, the
   NF4 decode and wgmma kernels), and each completion's tokens equal to a
   direct ``PagedBatcher``'s with the same arguments (the requests submitted
   in the order the engine took them, since a request's uid picks which
   sequence a preemption evicts, and admitted in client order) up to the first
   position whose top-2 margin is under NEAR_TIE.  Requests/s, tokens/s and
   the median and p90 time to first token, host clock.

23. search (inside serve, after serve-int8, on its weights): beam, group-beam
   and contrastive search and single-stream speculation.  First at 2 layers,
   the CPU's plain path against the card: beam search (paged, pages of 16),
   group beam search (4 beams in 2 groups, diversity 0.5) and contrastive
   search (α 0.6, top-k 4) on two prompts of unequal lengths, the card
   forced along the CPU's decisions (every forward's logits within
   LOGIT_TOL, contrastive's hidden states within HIDDEN_TOL; every decision
   it takes itself equal to the CPU's where the CPU's margin is clear of the
   measured rounding), and greedy speculation
   (8 drafts) token by token.  Then at full depth on two of serve's prompts
   (200 and 97 tokens, 32 tokens each): ``beam_search`` paged (its prompt
   pages shared by the 4 beams, ``paged_attention_split.cu`` at page 16) and
   contiguous, held to one another step by step up to the first decision
   within the measured rounding; ``group_beam_search`` (length_penalty
   0.8); ``contrastive_search``; then ``generate_speculative`` (8 drafts, 64
   tokens) on serve's four prompts (verify chunks of 36 rows on the NF4
   ``wgmma`` kernel) and on the 97-token one (9 rows, the decode kernel),
   each held token by token to ``generate()``'s greedy tokens,
   ``generate_stream_speculative`` equal to the latter bit for bit, and one
   run over serve-int8's serving tree held token by token to int8
   ``generate()``.  Exact launch counts from each loop's own steps and
   chunks; ms a step or chunk, tokens/s, peak memory and the memory held
   above the resident weights, beside serve's step, each path timed in a
   call without the checks' trace.  ``kernels`` gains the NF4 forward at
   M = 36 and M = 9, kernels-int8 ``qmm_i8_direct`` at M = 9, and
   kernels-paged the beams' shape (B = 8, pages of 16, prompt pages shared).

24. examples (after serve-http): the remaining single-card surface on one
   model at LLaMA-7B width, 8 layers (EXAMPLES_LAYERS: 32 until the tp phase
   joined the run), random double-quant NF4, a rank-64
   LoRA with nonzero B.  The judge and baseline through the endpoint: two ``ServingEngine``s
   over the same base, with the LoRA and without it (buckets up to 2048, 32
   pages of 64, greedy), behind ThreadingHTTPServer on 127.0.0.1, reached by
   a chat function over urllib that ends the run on any answer but a 200;
   ``generate_baseline_answers`` on 12 Vicuna questions (4 coding, the 3
   math, 5 of other categories: all three prompt ids routed), 32 tokens, 8
   workers, on each engine; then ``run_judge`` (the LoRA engine judging) in
   threeclass and relative mode, 16 tokens.  Held: one answer a question,
   none ``#ERROR#``, each within its budget; one review row a question with
   ``gen_prompt``'s reviewer and prompt ids and the parser's score; no
   prompt cut by the batcher; exact launch counts around each run (every
   decode on the NF4 decode kernel and split paged attention, every prefill
   on the wgmma kernel).  The four examples through their ``main(argv)`` in
   process, only their load helpers replaced (these weights, the LoRA as a
   saved checkpoint, ``ShownTokenizer``): ``guanaco_generate`` (64 sampled
   tokens, seed 0, plain and ``--decode_impl int8``), ``chat_demo`` (two
   turns from a replaced stdin, plain and ``--speculative 4``),
   ``serve_demo`` (8 prompts, 4 slots, a pool that preempts) and
   ``web_demo`` (two streamed chats over HTTP, a webhook server), each
   printed or streamed text equal bit for bit to the port's direct call with
   the same seed, every launch on the decode, wgmma and split kernels.  Then
   ``python3 -m qlora_tpu_torch.scripts.convert_checkpoint`` on a 2-layer
   HF checkpoint: exit 0, every tensor byte-equal to ``save_quantized(
   load_hf_model(src))`` here, seconds a layer; and ``guanaco_generate`` on
   the HF directory, only the tokenizer replaced.

25. tp (after examples): tensor-parallel serving, ``PagedBatcher(tp_mesh=...)``,
   four ranks at LLaMA-7B full width, TP_LAYERS (8) layers.  On one card the ranks share
   it over gloo (NCCL refuses two ranks on one device), with four cards NCCL
   a card a rank; the phase prints the backend and each rank's device.
   Random double-quant NF4 weights and a rank-64 LoRA with nonzero B from
   serve's seeds, the MLP padded 11008 -> 11264 (``pad_mlp``, as
   ``load_hf_model(pad_intermediate_to=...)`` pads a checkpoint: 11008 / 4 =
   2752 rows are no whole pair of 64-row blocks, which split-half packing
   needs).  First, on the single card: the same 8 greedy requests (prompts
   64-512, 32-48 new tokens; 4 slots, pages of 64, 20 pages: it preempts)
   through ``PagedBatcher``, each request's top-2 margins teacher-forced
   without a cache, and the first decode step's logits over a contiguous
   cache; then every rank's shard cut in the parent (``cut_rank_shards``: a
   row-parallel linear quantized as the rank's K-chunk alone) and written to
   a file a rank, so that no rank holds the whole model.  Then the ranks,
   each reading its own shard: run 1, those requests (every rank's tokens
   equal and no rank's own ever different from rank 0's, every token within
   TP_LOGIT_TOL of the best under the single card's teacher-forced logits
   over the context the engine held, equal to the single card's up to each
   request's first margin under TP_NEAR_TIE, the first decode step's logits
   within TP_LOGIT_TOL, one preemption, pools of KVH/4 heads recycled); run 2, 4 requests on the chunk-local int8 tree with
   the w8a8 prefill, one decode step held to the exact tp step's on one cache
   within TP_INT8_BAND of its largest |logit| and every token within twice
   that of the best teacher-forced logit; run 3, 4 requests with 4 drafts a
   verify chunk; ``examples/serve_tp``'s rank function, 16 greedy tokens
   (both held to the teacher-forced logits as run 1).  Launch counts exact on every rank (every qmm on the decode or
   ``wgmma`` kernel at the shard shapes, the int8 decode on
   ``qmm_i8_direct_decode.cu``, attention on the split kernels), read into
   ``kernels`` as ``launches_tp``; each rank's peak memory and host seconds,
   which are no tensor-parallel speed.  The kernels phase times the NF4
   decode kernel at M = 4 on a rank's shard shapes (``TP_QMM_SHAPES``), and
   checks ``qmatmul`` of a whole K-sharded tensor on the card (one decode
   launch a chunk) against its plain version.
26. train-mesh (after both processes below): LoRA finetuning over four
   ranks through ``cli.train`` at LLaMA-7B full width, MESH_LAYERS (8) layers, the gather
   style at (dp, fsdp, tp) = (1, 2, 2) and Megatron at (2, 1, 2), each
   against the single card on the same weights and stream
   (``train_mesh_phase``); then train-sp, then train-full.
27. train-sp (after train-mesh): ring-attention sequence parallelism
   through ``cli.train`` at LLaMA-7B full width and depth on the
   long-context recipe's S = 8192, the recipe's ring (1, 1, 1, 4) at batch
   1 and the weight-sharded ring (1, 2, 1, 2) with ZeRO-1 at batch 2, each
   against the single card on the same weights and stream
   (``train_sp_phase``): losses and grad norms, adapters bit-equal on every
   rank, every rank's launches exact (its flash chunks rank-dependent),
   rotations a step, each rank's activation peak against the single
   card's.  The kernels phase holds the flash kernels at the ring's chunk
   shapes (``ring_kernel_phase``: a non-causal chunk, the causal diagonal,
   both backward on the merged lse and di) against their plain versions and
   times them beside SDPA.
28. train-gspmd (after train-sp): full finetuning on a mesh through
   ``cli.train --full_finetune --bits 16`` at LLaMA-7B width (GSPMD_LAYERS
   layers, dense bf16, ``mode="full"``): run 1 at (dp, fsdp, tp) =
   (1, 2, 2), four gloo ranks on the card; run 2 at (2, 1, 2) as two
   processes of two ranks (``chip_smoke.py gspmd-host``, each building the
   model from the seed) joined through ``--coordinator_address
   localhost:<port> --num_processes 2 --process_id i``; each against the
   single card's ``mode="full"`` steps on the same weights and
   micro-batches (``train_gspmd_phase``): every step's loss and grad norm,
   whole tensors bit-equal on every rank and shards on their dp replicas,
   each rank's trainable and optimizer bytes ~1/(fsdp·tp) of the single
   card's, rank 0's flash launches exact (rows 5 and 6 at the ranks'
   shapes), run 1's checkpoint resumed on the single card for a step.
29. dryrun (the second process's first phase): ``dryrun_multichip(4)``
   (``qlora_tpu_torch/dryrun.py``), every path JAX's dry run takes at
   n = 4 (GSPMD, the dp×fsdp×tp step, Megatron, the ring, tp serving, the
   tp ``PagedBatcher`` with int8 and speculation) in one world of four
   gloo ranks on the card, each path's kernel launches read on rank 0.
30. train-parity-few (in the second process, after parity-int8): train-parity
   at 2 x 8 tokens over an NF4 and an int8 base (LLaMA-7B width, 2 layers,
   remat "full"): 16 rows, so every block linear's forward runs a decode
   kernel and every dx a dx decode kernel (7 L - 3 a micro-batch), attention
   below the flash gate; the loss within LOSS_TOL and every LoRA gradient
   within GRAD_TOL of the CPU's plain path, launch counts exact, no flash
   and no wgmma.

Two processes share the card after the kernel phases: this one runs parity
to train-data, while a second (``chip_smoke.py lane``, started by
``start_lane``) runs paged-parity, parity-int8, train-parity-few, dryrun, cli,
serve-http, examples, tp, train-int8 and train-gemma (``LANE``) and hands back
their launch counts and stats.  The kernels are timed before it starts, on an
idle card; the host times of the
phases of either process are taken beside the other's.  A failure in
either fails the run, and the second process and everything it started end
with the first (its own process group).

The last two lines are the ``kernels`` JSON object and the result line.

``python3 chip_smoke.py serve-paged-w8a8`` builds the kernels and runs the
serve weights through serve-paged-w8a8 alone, to time the route in turns
with a checkout of another commit that this script is copied into;
``python3 chip_smoke.py serve-paged-spec-int8`` runs serve-paged-spec-int8
alone on the same weights; ``python3 chip_smoke.py train`` does the same for
the train phase (at the
checkout's default remat), ``python3 chip_smoke.py train-gemma`` runs
train-gemma alone, ``python3 chip_smoke.py train-data`` train-data alone
(on weights of its own), and ``python3 chip_smoke.py cli``,
``python3 chip_smoke.py serve-http`` and ``python3 chip_smoke.py search``
(serve's weights, its greedy ``generate()`` and serving tree made first),
``python3 chip_smoke.py examples``, ``python3 chip_smoke.py tp`` and
``python3 chip_smoke.py train-sp`` (the ring's chunk kernels first),
``python3 chip_smoke.py train-gspmd`` and ``python3 chip_smoke.py dryrun``
those phases alone.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import logging
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
HIDDEN_TOL = 0.05         # the same, for the final norm's output as a unit vector (contrastive
                          # search's cosines): |u_card - u_cpu| at each position, where bf16
                          # rounding of each element (2^-9 of it) in other orders through two
                          # layers moves it by ~2^-7

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
TRAIN_FEW_S = 8           # train-parity-few: 2 x 8 = 16 rows, the most the dx decode
                          # kernels take (DECODE_ROWS), under the flash gate (S % 128)

# kernel phase: the LLaMA-7B block linears (K, N) at prefill (M = 4 x 512),
# training (M = 2 x 512, forward and backward) and decode (M = 4) rows,
# decode attention at the serving width, flash attention at the training one
QMM_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096))
QMM_ROWS = (2048, 1024, 4, 8, 16, 40, 36, 9)   # + decode: generate()'s 4 rows, serve-paged's
                                               # 8 slots (and 2 x 4 beams), DECODE_ROWS, a
                                               # verify step's 8 x 5, search's speculation at
                                               # 4 x 9 and 1 x 9 (the decode kernel's two tiles)
FEW_ROWS = 64             # up to here a row count is timed in a CUDA graph, with the tile
                          # kernel ("before") and the decode kernel beside it
QMM_BWD_ROWS = TRAIN_MICRO[0] * TRAIN_MICRO[1]
BWD_DECODE_ROWS = (1, 4, 8, 16)  # the dx decode kernels' rows: a row alone and the micro-batches
                                 # of 4, 8 and 16 tokens that train-parity-few's 2 x 8 stands for
# a ragged shape the dx decode plans accept (K/2 % 32 != 0, block 4: each
# element's own absmax) and one they refuse (N % 16 != 0: the tile kernels keep it)
BWD_DECODE_RAGGED = (5, 200, 48, 4)
BWD_DECODE_REFUSED = (5, 192, 200, 32)
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
I8_DIRECT_ROWS = I8_DECODE_ROWS + (9,)   # qmm_i8_direct also at search's int8 verify chunk, 1 x 9
I8_DIRECT_VERIFY = (17, 24, 33, 40, 64)   # qmm_i8_direct past 16 rows, on the split-K kernel's
                                 # verify plan: 40 is serve-paged-spec-int8's verify chunk (8 slots
                                 # x 5), 17 and 33 ragged B tiles, 64 the most it takes
I8_DIRECT_BEYOND = (128, 512)    # qmm_i8_direct.cu past 64 rows, beside torch._int_mm (measured)


PAGE, PPS = 64, 16               # serve-paged's pages: 64 tokens, 16 per sequence (T = 1024)
PAGED_B = 8                      # serve-paged's slots
SPEC_DRAFT = 4                   # drafts per verify chunk (C = 5)
DECODE_LENS = (0, 1, 63, 64, 65, 300, 511, 1022)
CHUNK_LENS = (0, 1, 63, 64, 65, 300, 510, 1019)   # 510 % 64 == 62: across a page; 1019 + 5 == T
# C (None: the decode kernel), KVH, lengths, sliding window, evicted, planted edges; page,
# pages a sequence, and beams sharing each prompt's full pages (0: no sharing)
PagedCase = collections.namedtuple(
    "PagedCase", "C KVH lens window evict planted page pps beams prompts",
    defaults=(PAGE, PPS, 0, ()))
PAGED_CASES = (
    PagedCase(None, 32, DECODE_LENS, None, False, False),
    PagedCase(None, 8, DECODE_LENS, 256, True, False),   # GQA G=4, window, entries behind it
    PagedCase(None, 8, DECODE_LENS, 256, True, True),    # an off-by-one moves it O(1)
    PagedCase(SPEC_DRAFT + 1, 32, CHUNK_LENS, None, False, False),
    PagedCase(SPEC_DRAFT + 1, 8, CHUNK_LENS, 256, True, False),
    PagedCase(SPEC_DRAFT + 1, 8, CHUNK_LENS, 256, True, True),
    # the search phase's paged beams: 2 rows x 4 beams, pages of 16, each row's full
    # prompt pages shared by its beams (prompts 200 and 97, 15 tokens generated:
    # 112 appends at a page's first slot)
    PagedCase(None, 32, (215,) * 4 + (112,) * 4, None, False, False, page=16, pps=16, beams=4,
              prompts=(200, 97)),
)
SERVE_PAGED = dict(num_slots=PAGED_B, page_size=PAGE, max_pages_per_seq=PPS,
                   prefill_buckets=(128, 256, 512), eos_id=-1, admit_batch=4,
                   admission="optimistic")
SERVE_PAGED_PAGES = 32           # 31 usable pages (1.07 GB at 7B): this traffic preempts twice
SERVE_PAGED_REQUESTS = 16
SERVE_PAGED_SEED = 0
SPEC_REQUESTS = 8
SPEC_PAGES = 64                  # ample: speculation, not preemption, is what this run shows

# tp: tensor-parallel serving, four ranks on the one card over gloo (NCCL refuses two
# ranks on one device), or over NCCL a card a rank where there are four cards
TP = 4
TP_LAYERS = 8                    # tp's depth, cut from 32 to make room for train-gspmd and dryrun
TP_PAD = 2 * 64 * TP             # the intermediate padded to whole split-half block pairs
                                 # a rank: 11008 -> 11264, K-chunks of 2816 (11008 / 4 = 2752
                                 # is no whole pair of 64-row blocks: quantize refuses it)
TP_ENGINE = dict(num_slots=4, page_size=PAGE, max_pages_per_seq=PPS,
                 prefill_buckets=(128, 256, 512), eos_id=-1)
TP_REQUESTS, TP_SEED = 8, 20     # prompts of 64-512 tokens, 32-48 new tokens each
TP_PAGES = 20                    # 19 usable pages for 4 slots of up to 9: it preempts once
TP_SMALL = 4                     # run 2 (int8 decode) and run 3 (speculation): 4 requests,
TP_SMALL_NEW = 16                # 16 new tokens each
TP_SERVE_NEW = 16                # examples/serve_tp's rank function: greedy tokens
TP_QMM_SHAPES = ((4096, 1024), (4096, 2816), (1024, 4096), (2816, 4096))   # a rank's wq / wk /
                                 # wv and wo chunk, w_gate / w_up and w_down chunk at tp 4
TP_LOGIT_TOL = 0.25              # the first decode step, four ranks against the single card
                                 # (set when the phase ran 32 layers): the f32 all-reduce's
                                 # order and the row-parallel linears' per-chunk double-quant
                                 # offsets (each rank's K-chunk quantized alone); 0.090
                                 # prefill, 0.106 step read.  Also how far short of the single
                                 # card's best teacher-forced logit an emitted token may fall
TP_NEAR_TIE = 2 * TP_LOGIT_TOL   # C1's rule: tokens equal up to a top-2 margin under this
TP_INT8_BAND = 0.1               # run 2's int8 step against the exact step, of the largest
                                 # |exact logit|: the JAX package's own test's budget at 2
                                 # layers, which 32 layers keep (0.057 read)

MESH_LAYERS = 8                  # train-mesh's depth, cut from 32 to make room for train-gspmd
MESH_STEPS = 2                   # train-mesh: Megatron's optimizer steps; the gather style's
MESH_GATHER_STEPS = 1            # one step costs 16-45 s over gloo (rank 0 sends ~1800
                                 # collectives a step, each ~9-25 ms: it waits for the card's
                                 # time slice), so run 1 takes one and its checkpoint's resumed
                                 # step on the single card shows the loss falling
MESH_GATHER = ("--mesh_fsdp", "2", "--mesh_tp", "2")                          # (1, 2, 2)
MESH_MEGATRON = ("--tp_style", "megatron", "--mesh_dp", "2", "--mesh_tp", "2")  # (2, 1, 2)
MESH_LOSS_RTOL, MESH_GNORM_RTOL = 2e-3, 5e-3   # the JAX package's bounds for its sharded steps
MESH_SAMPLES = 4                 # the training examples: every step's two micro-batches
MESH_START = 1                   # every run resumes from one single-card checkpoint at this
                                 # step: serve's adapters (B ~ N(0, 0.05)) and AdamW with its
                                 # count at 1, so that the first step's rate is not 0.  From
                                 # B = 0 the first update's LoRA term is ~1e-4, under half a
                                 # bf16 ulp of the base output it is added to, and whether it
                                 # survives depends on where each layout rounds (PERF.md §6)
MESH_END = MESH_START + MESH_STEPS          # Megatron's last step
MESH_GATHER_END = MESH_START + MESH_GATHER_STEPS
MESH_SEED = "7"                  # serve's weights (init_params seed 7), a fresh LoRA (seed 8)
MESH_M = TRAIN_MICRO[1]          # a data rank's rows a micro-batch: 1 x 512
# a rank's NF4 linears, (K, N): the gather style's tp shards gathered over fsdp (q/k/v/o,
# gate/up, down), the Megatron column shards and row K-chunks (wo, w_down)
MESH_QMM_SHAPES = ((4096, 2048), (4096, 5504), (11008, 2048), (2048, 4096), (5504, 4096))

# train-sp: the long-context recipe (scripts/finetune_longcontext_sp.sh) through cli.train
SP_SOURCE, SP_TARGET = 2048, 6144        # the recipe's lengths: S = 8192, every token real
SP_STEPS = 2                             # optimizer steps a run, from MESH_START's checkpoint
# (tag, flags, global batch): run 1 the recipe's ring of 4 (2048 positions a rank, batch 1);
# run 2 the weight-sharded ring, ZeRO-1 over fsdp 2, which is also a batch axis (a row a
# data rank: batch 2), 4096 positions a rank
SP_RUNS = (("run 1", ("--mesh_sp", "4"), 1),
           ("run 2", ("--mesh_fsdp", "2", "--mesh_sp", "2"), 2))
SP_CHUNK = (1, 32, 32, 128, 2048)        # B, H, KVH, hd, S of a run-1 rank's ring chunk

# train-gspmd: full finetuning on a mesh (dense bf16, 14 bytes a parameter on the single card)
GSPMD_LAYERS = 4                         # LLaMA-7B width, the depth cut to fit the phase's time
GSPMD_STEPS = 2                          # optimizer steps a mesh run (the first at rate 0:
                                         # the warmup starts there), then one resumed
GSPMD_SEED = 43                          # init_params seed of the dense model, every process
GSPMD_LR = 1e-4
GSPMD_RUNS = (("run 1", (1, 2, 2), 1),   # (tag, (dp, fsdp, tp), processes)
              ("run 2", (2, 1, 2), 2))
DRYRUN_PATHS = ("gspmd", "sharded", "megatron", "ring", "tp-serving", "paged-tp")   # JAX's at 4

FLASH_CASES = (  # B, H, KVH, hd, S, lengths, sliding window, planted edges, lse cotangent
    (2, 32, 32, 128, 512, (512, 300), None, False, False),   # the train run's shape
    (1, 32, 32, 128, 512, (437,), None, False, False),       # train-mesh's gather style, a rank
    (1, 16, 16, 128, 512, (437,), None, False, False),       # train-mesh's Megatron, a rank
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

# train-data: the train phase's weights trained from an alpaca .jsonl file, then resumed
DATA_EXAMPLES, DATA_EVAL = 64, 8
DATA_SOURCE, DATA_TARGET = 384, 128      # the collator's limits; rows padded to their sum, 512
DATA_STEPS, DATA_SAVE_AT, DATA_PROFILE_STEP = 5, 3, 2
DATA_WARMUP = 0.8                        # warmup over 4 of the 5 steps: the resumed count sets
                                         # step 4's learning rate
DATA_WORDS = ("the", "model", "weights", "quantized", "adapter", "gradient", "token", "layer",
              "memory", "card", "batch", "answer", "question", "explain", "briefly", "why",
              "loss", "falls", "ranks", "résumé", "naïve", "données")
STORE_PROMPT, STORE_NEW = 128, 8         # the reloaded store's prefill and greedy tokens
HF_LAYERS = 2                            # the HF checkpoint written at LLaMA-7B width

# cli: the driver's command line in process, at LLaMA-7B, on the train cell's shapes
CLI_MODEL = "huggyllama/llama-7b"
CLI_STEPS, CLI_RESUME_AT, CLI_SAVE, CLI_KEEP = 6, 4, 2, 2
CLI_EVAL_BATCH, CLI_MMLU, CLI_MMLU_LEN, CLI_NEW = 4, 16, 2032, 32   # 2032 + 16: S = 2048, flash
# serve-http: the OpenAI-compatible endpoint over PagedBatcher, 16 clients at once
HTTP_REQUESTS, HTTP_CHAT = 16, 4         # 12 completions and 4 chats, half of each streamed
# examples: the judge and baseline through the endpoint, the four examples' main(argv), the
# converter; one LLaMA-7B (32 layers, random NF4, rank-64 LoRA) for all of them
JUDGE_CATEGORIES = (("coding", 4), ("math", 3))   # + EXAMPLES_OTHER questions of other
EXAMPLES_OTHER = 5                                # categories: prompt ids 2, 3 and 1 all routed
BASELINE_TOKENS, JUDGE_TOKENS, JUDGE_WORKERS = 32, 16, 8
JUDGE_ENGINE = dict(slots=8, page_size=64, max_pages_per_seq=32, n_pages=8 * 32 + 1,
                    prefill_buckets=(128, 256, 512, 1024, 2048), admit_batch=2,
                    steps_per_dispatch=1, temperature=0.0)    # judge prompts: 1-2 k tokens
                                         # (the prefill's f32 scores: 0.5 GB a row a layer at
                                         # 2048, so 2 rows an admission)
EXAMPLE_NEW = 64                         # guanaco_generate's sampled tokens
CHAT_TURNS, CHAT_NEW, CHAT_DRAFT = ("Tell me about alpacas.", "And llamas?"), 24, 4
EXAMPLES_LAYERS = 8                      # the examples' and serve-http's models: LLaMA-7B
HTTP_LAYERS = 16                         # width, their depth cut (from 32) to keep the
                                         # full run in its time once the tp phase joined it
SERVE_DEMO = dict(num_slots=4, n_pages=80, max_new_tokens=40)   # 16-token pages: it preempts
SERVE_DEMO_PROMPTS = 8
WEB_NEW = 24
# search: beams, group beams, contrastive search and speculation on serve's weights
SEARCH_ROWS = (2, 3)                     # serve's prompts of 200 and 97 tokens
SEARCH_BEAMS, SEARCH_GROUPS, SEARCH_DIVERSITY, SEARCH_LP = 4, 2, 0.5, 0.8
SEARCH_NEW, SEARCH_PAGE = 32, 16
CONTRASTIVE_ALPHA, CONTRASTIVE_K = 0.6, 4
SEARCH_DRAFT = 8                         # drafts a verify chunk: 4 x 9 = 36 rows at B = 4
SEARCH_PARITY = (48, 31, 5, 8)           # 2 layers: prompt lengths, new tokens (searches,
                                         # speculation)
NEAR_TIE = 2 * LOGIT_TOL                 # a top-2 margin (teacher-forced, no cache) under
                                         # which bf16 rounded in another order (a cached
                                         # decode, another batch) may pick the other token:
                                         # parity holds the card's logits within LOGIT_TOL
                                         # of another order's, so two runs differ by up to
                                         # twice that


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


def flash_bounds(B, H, KVH, hd, S, lens, window, causal=True):
    """(bound_ms, bound_by) for flash_fwd, flash_bwd_dq, flash_bwd_dkv: each
    input read once and each output written once, and the products over the
    (query, key) pairs that these lengths, causality and this window leave
    visible (2 products forward, 3 for dq, 4 for dk and dv; 2 * hd
    operations each)."""
    import numpy as np

    row = np.arange(S)
    pairs = 0
    for n in lens:
        lo = np.maximum(0, row - window + 1) if window else 0
        hi = np.minimum(row + 1, n) if causal else np.full(S, n)
        pairs += int(np.maximum(0, hi - lo).sum())
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


def paged_case(g, dev, B, C, H, KVH, hd, page, pps, lens, window, evict=False, planted=False,
               beams=0, prompts=()):
    """Inputs of one paged-attention call, drawn from `g`: q, new_k, new_v
    ([B, C, ...], or with C None the decode's [B, ...]), pools of noise with
    B * pps + 9 pages, lengths, and tables of distinct scattered pages.  A
    row of length 0 is an inactive slot: its table is all page 0.  With
    `evict` the entries wholly behind the window point at page 0, as
    ``PagedPool.evict_before`` leaves them.  With `beams`, each run of
    `beams` rows shares its first prompt // page pages (``prompts``, one a
    run), as ``generate/search.py``'s paged beams do."""
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
        if beams and b % beams:
            fb = prompts[b // beams] // page
            tables[b, :fb] = tables[b - b % beams, :fb]
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


def paged_bound(B, C, H, KVH, hd, lens, window, T, pps, shared=0):
    """(bound_ms, bound_by) of a paged call: the pool keys each row attends
    (read once; `shared` of them are pages another row reads too, which the
    card need read only once), q and out, the C new k/v rows read and written
    into the pool, lengths and tables; 4 * hd operations per (query, key)
    pair, the chunk's own keys included, at the f32 rate."""
    keys = [max(0, min(n, T) - (max(0, n - window + 1) if window else 0)) for n in lens]
    nbytes = (2 * KVH * hd * 2 * (sum(keys) - shared) + 2 * B * C * H * hd * 2
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
    H, hd, B = 32, 128, PAGED_B
    for C, KVH, lens, window, evict, planted, page, pps, beams, prompts in PAGED_CASES:
        T = page * pps
        q, nk, nv, kp, vp, L, tables = paged_case(g, dev, B, C, H, KVH, hd, page, pps, lens,
                                                  window, evict, planted, beams, prompts)
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
        shape = (f"B={B}{'' if C is None else f' C={C}'} H={H} KVH={KVH} hd={hd} page={page} "
                 f"pps={pps} lens={list(lens)} window={window}"
                 + (" evicted" if evict else "") + (" planted edges" if planted else "")
                 + (f" beams={beams} shared prompts={list(prompts)}" if beams else ""))
        more = {"tile_err": paged_split_checks(shape, kernel, before, q, nk, nv, kp, vp, L,
                                               tables, kw, o1, o2)}
        shared = sum((beams - 1) * (n // page) * page for n in prompts)
        bound_ms, bound_by, keys = paged_bound(B, Cq, H, KVH, hd, lens, window, T, pps, shared)
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
            return pages.index_select(0, flat).reshape(B, pps, KVH, page, hd).transpose(
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
            # the dx at decode rows: the dx decode kernel, in a graph beside
            # qmm_nf4_bwd.cu through its C entry (the "before") and g @ Wᵀ
            bwd_decode_rows("qmm_nf4_bwd", qmm_nf4_bwd, qmatmul_bwd_plain, bwd_tile, qt, qts, ws,
                            w_bf16, g, results, lambda M: qmm_bound(M, K, N, dq))
        bwd_decode_edges("qmm_nf4_bwd", qmm_nf4_bwd, qmatmul_bwd_plain, "nf4", dq, g)

    decode_attention_phase(dev, g, results)


def bwd_decode_bits(name, shape, wrapper, g, qt, w_bf16, dx):
    """The dx decode kernel bit for bit at g's rows (dx its output): two calls
    equal, each row alone equal to its row of the batch, rows of the identity
    read out columns of ``dequantize``'s weight.  Fails the run if one is
    broken."""
    import torch

    M, N = g.shape
    twice = torch.equal(wrapper(g, qt), dx)
    alone = all(torch.equal(wrapper(g[i:i + 1], qt), dx[i:i + 1]) for i in range(M))
    cs = one_hot_cols(N, max(M, 4))
    eye = torch.zeros(len(cs), N, device=g.device, dtype=torch.bfloat16)
    eye[torch.arange(len(cs)), torch.tensor(cs)] = 1
    readout = torch.equal(wrapper(eye, qt), w_bf16[:, cs].T)
    print(f"kernel {name} {shape} (dx decode kernel): two calls equal {twice}, each row alone "
          f"equal {alone}, identity rows read out columns {cs} of dequantize's weight "
          f"{readout}", flush=True)
    if not (twice and alone and readout):
        fail(f"{name} {shape} (dx decode kernel): deterministic {twice}, batch-invariant "
             f"{alone}, one-hot readout {readout}")


def bwd_decode_rows(name, wrapper, plain, before, qt, qts, ws, w_bf16, gen, results, bound):
    """The dx at BWD_DECODE_ROWS rows on the dx decode kernel of qt's
    storage: it takes the call (``decode_launches``), within QMM_TOL of the
    plain version; two calls equal, each row alone equal to its row of the
    batch, rows of the identity read out columns of ``dequantize``'s weight,
    all bit for bit.  Timed in CUDA graphs beside the kernel it replaced
    through its C entry (``tile_ms``, the "before", also held to QMM_TOL),
    ``g @ Wᵀ`` on the dequantized weight (``library_ms``) and its bound;
    each as a multiple of the library's time."""
    import torch

    K, N = w_bf16.shape
    kind = "dq" if qt.double_quant else "f32"
    for M in BWD_DECODE_ROWS:
        gr = torch.randn(M, N, device=qt.packed.device, generator=gen).to(torch.bfloat16)
        took = wrapper.decode_launches
        dx, ref, old = wrapper(gr, qt), plain(gr, qt), before(gr, qt)
        torch.cuda.synchronize()
        if wrapper.decode_launches != took + 1:
            fail(f"{name} M={M} K={K} N={N}: the dx decode kernel did not take the call")
        shape = f"M={M} K={K} N={N} {kind} absmax"
        diff = (dx.float() - ref.float()).abs()
        err = diff.max().item()
        excess = (diff - QMM_TOL[1] * ref.float().abs()).max().item()
        excess = max(excess, ((old.float() - ref.float()).abs()
                              - QMM_TOL[1] * ref.float().abs()).max().item())
        if excess > QMM_TOL[0]:
            fail(f"{name} {shape} (dx decode kernel or its before) differs from its plain "
                 f"version by {err}")
        bwd_decode_bits(name, shape, wrapper, gr, qt, w_bf16, dx)
        ms = graph_ms(lambda i: wrapper(gr, qts[i % len(qts)]), 200)
        tile_ms = graph_ms(lambda i: before(gr, qts[i % len(qts)]), 10)
        plain_ms = cuda_ms(lambda i: plain(gr, qts[i % len(qts)]), 20)
        lib_ms = graph_ms(lambda i: torch.matmul(gr, ws[i % len(ws)].T), 200)
        record(results, name, shape, err, f"tol {QMM_TOL[0]} + {QMM_TOL[1]}*|ref|", ms,
               plain_ms, lib_ms, bound(M), tile_ms=tile_ms)
        print(f"  the dx decode kernel {tile_ms / ms:.1f}x the before's speed, "
              f"{ms / lib_ms:.2f}x g @ Wᵀ's time", flush=True)


def bwd_decode_edges(name, wrapper, plain, quant_type, dq, gen):
    """The dx decode kernel on a ragged shape its plan accepts (within
    QMM_TOL, ``bwd_decode_bits``), and a shape its plan refuses, which takes
    the tile kernel and says why."""
    import torch

    from qlora_tpu_torch.ops.qmatmul import i8_bwd_decode_plan, nf4_bwd_decode_plan
    from qlora_tpu_torch.quant import dequantize, quantize

    plan_fn = i8_bwd_decode_plan if quant_type == "int8" else nf4_bwd_decode_plan
    dev = gen.device
    for (M, K, N, B), accepted in ((BWD_DECODE_RAGGED, True), (BWD_DECODE_REFUSED, False)):
        qt = quantize(torch.randn(K, N, device=dev, generator=gen) * K ** -0.5, block_size=B,
                      quant_type=quant_type, double_quant=dq)
        gr = torch.randn(M, N, device=dev, generator=gen).to(torch.bfloat16)
        plan = plan_fn(K, N, B, 132)     # whether it accepts does not depend on the SMs
        took = wrapper.launches, wrapper.decode_launches, wrapper.wgmma_launches
        dx, ref = wrapper(gr, qt), plain(gr, qt)
        torch.cuda.synchronize()
        shape = f"M={M} K={K} N={N} block {B} {'dq' if dq else 'f32'} absmax"
        diff = (dx.float() - ref.float()).abs()
        if (diff - QMM_TOL[1] * ref.float().abs()).max().item() > QMM_TOL[0]:
            fail(f"{name} {shape} differs from its plain version by {diff.max().item()}")
        counts = (wrapper.launches - took[0], wrapper.decode_launches - took[1],
                  wrapper.wgmma_launches - took[2])
        if plan.accepted != accepted or counts != (1, int(accepted), 0):
            fail(f"{name} {shape}: plan accepted {plan.accepted} ({plan.reason}), launches "
                 f"(all, decode, wgmma) {counts}")
        if accepted:
            print(f"kernel {name} {shape}: the dx decode plan accepts the ragged shape, within "
                  "QMM_TOL", flush=True)
            bwd_decode_bits(name, shape, wrapper, gr, qt, dequantize(qt, torch.bfloat16), dx)
        else:
            print(f"kernel {name} {shape}: the dx decode plan refuses it ({plan.reason}); "
                  f"the tile kernel took it, within QMM_TOL", flush=True)


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


def ring_kernel_phase(dev, results):
    """The flash kernels at the ring's chunk shapes (train-sp run 1: a rank's
    2048 queries over a shard of 2048 keys, B=1 H=32 hd=128), each against
    its plain version on the same inputs and timed beside it, SDPA and the
    bound: the forward over an earlier shard (non-causal, full length), the
    forward over the rank's own shard (the causal diagonal), and both
    chunks' backward fed the MERGED lse and di = sum(o * do) of the two
    chunks' combined output, as ``ops/ring_attention.py`` feeds them (no
    chunk of length 0 is launched: a rank skips the shards after its own).
    Returns the forward time of each chunk kind, for the phase's split."""
    import torch
    import torch.nn.functional as F

    from qlora_tpu_torch.ops import (
        flash_bwd_dkv, flash_bwd_dq, flash_bwd_plain, flash_fwd, flash_fwd_plain,
    )
    from qlora_tpu_torch.ops.ring_attention import _merge

    B, H, KVH, hd, S = SP_CHUNK
    sm = hd ** -0.5
    g = torch.Generator(device=dev).manual_seed(2468)
    mk = lambda *sh: torch.randn(*sh, device=dev, generator=g).to(torch.bfloat16)
    q, do = mk(B, H, S, hd), mk(B, H, S, hd)
    kv = {"earlier": (mk(B, KVH, S, hd), mk(B, KVH, S, hd)),
          "diagonal": (mk(B, KVH, S, hd), mk(B, KVH, S, hd))}
    causal = {"earlier": False, "diagonal": True}
    L = torch.full((B,), S, device=dev, dtype=torch.int32)
    plain = {c: flash_fwd_plain(q, *kv[c], L, sm, causal[c], None) for c in kv}
    ninf = lambda lse: torch.where(lse > 1e37, torch.full_like(lse, float("-inf")), lse)
    lse_m, o_m = _merge(ninf(plain["diagonal"][1]), plain["diagonal"][0].float(),
                        ninf(plain["earlier"][1]), plain["earlier"][0].float())
    o_m = o_m.to(torch.bfloat16)
    di = (o_m.float() * do.float()).sum(-1)

    def excess(got, ref, dims):
        d = (got.float() - ref.float()).abs()
        tol = FLASH_TOL * ref.float().abs().amax(dims, keepdim=True)
        return d.max().item(), (d - tol).max().item()

    n_sets = copies_past_l2(4 * q.nbytes + 2 * kv["earlier"][0].nbytes)
    copy = lambda: (q.clone(), do.clone(), {c: tuple(t.clone() for t in kv[c]) for c in kv})
    sets = [(q, do, kv)] + [copy() for _ in range(n_sets - 1)]
    pick = lambda i: sets[i % n_sets]
    fwd_ms = {}
    for chunk in ("earlier", "diagonal"):
        cz = causal[chunk]
        k, v = kv[chunk]
        wrappers = (flash_fwd, flash_bwd_dq, flash_bwd_dkv)
        n0 = [w.wgmma_launches for w in wrappers]
        o, lse = flash_fwd(q, k, v, L, sm, cz, None)
        dq = flash_bwd_dq(q, k, v, L, do, lse_m, di, sm, cz, None)
        dk, dv = flash_bwd_dkv(q, k, v, L, do, lse_m, di, sm, cz, None)
        torch.cuda.synchronize()
        if [w.wgmma_launches - a for w, a in zip(wrappers, n0)] != [1, 1, 1]:
            fail(f"ring chunk {chunk}: not one launch each on the wgmma kernels")
        rq, rk, rv = flash_bwd_plain(q, k, v, L, o_m, lse_m, do, sm, cz, None)
        ek, ev = excess(dk, rk, (-2, -1)), excess(dv, rv, (-2, -1))
        errs = {"flash_fwd": excess(o, plain[chunk][0], -1),
                "flash_bwd_dq": excess(dq, rq, (-2, -1)),
                "flash_bwd_dkv": (max(ek[0], ev[0]), max(ek[1], ev[1]))}
        lse_err = (lse - plain[chunk][1]).abs().max().item()
        ms = {"flash_fwd": graph_ms(lambda i: flash_fwd(pick(i)[0], *pick(i)[2][chunk], L, sm, cz,
                                                        None), 50),
              "flash_bwd_dq": graph_ms(lambda i: flash_bwd_dq(pick(i)[0], *pick(i)[2][chunk], L,
                                                              pick(i)[1], lse_m, di, sm, cz,
                                                              None), 50),
              "flash_bwd_dkv": graph_ms(lambda i: flash_bwd_dkv(pick(i)[0], *pick(i)[2][chunk], L,
                                                                pick(i)[1], lse_m, di, sm, cz,
                                                                None), 50)}
        fwd_ms[chunk] = ms["flash_fwd"]
        plain_fwd = cuda_ms(lambda i: flash_fwd_plain(pick(i)[0], *pick(i)[2][chunk], L, sm, cz,
                                                      None), 5)
        plain_bwd = cuda_ms(lambda i: flash_bwd_plain(pick(i)[0], *pick(i)[2][chunk], L, o_m,
                                                      lse_m, pick(i)[1], sm, cz, None), 5)
        sdpa = lambda qq, kk, vv: F.scaled_dot_product_attention(qq, kk, vv, is_causal=cz,
                                                                 scale=sm)
        lib_fwd = cuda_ms(lambda i: sdpa(pick(i)[0], *pick(i)[2][chunk]), 50)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = sdpa(*leaves)
        lib_bwd = cuda_ms(lambda i: torch.autograd.grad(out, leaves, pick(i)[1],
                                                        retain_graph=True), 20)
        bounds = flash_bounds(B, H, KVH, hd, S, (S,), None, causal=cz)
        shape = (f"ring chunk {chunk}: B={B} H={H} KVH={KVH} hd={hd} Sq=Sk={S} "
                 f"{'causal' if cz else 'non-causal'}; backward on the merged lse, di")
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            fwd = name == "flash_fwd"
            results.append(dict(name=name, shape=shape, max_abs_err=errs[name][0], ms=ms[name],
                                plain_ms=plain_fwd if fwd else plain_bwd,
                                library_ms=lib_fwd if fwd else lib_bwd,
                                bound_ms=bounds[name][0], bound_by=bounds[name][1]))
            print(f"kernel {name} {shape}: max|d|={errs[name][0]:.3g} (tol {FLASH_TOL}*max|ref|) "
                  f"ms={ms[name]:.4f} (graph) plain_ms={plain_fwd if fwd else plain_bwd:.4f} "
                  f"library_ms={lib_fwd if fwd else lib_bwd:.4f} (SDPA, "
                  f"{'forward' if fwd else 'whole backward'}) bound_ms={bounds[name][0]:.4f} "
                  f"({bounds[name][1]})", flush=True)
        print(f"  lse max|d|={lse_err:.3g} (tol {LSE_TOL})", flush=True)
        bad = [n for n, (_, ex) in errs.items() if ex > 0]
        if bad or lse_err > LSE_TOL:
            fail(f"ring chunk {chunk}: {bad} differ from their plain versions ({errs}), "
                 f"lse {lse_err}")
        del leaves, out
    del sets
    return fwd_ms


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
    """``qmm_i8_direct`` at up to 64 rows: the split-K kernel took the call; its
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


def i8_direct_identity_check(shape, qt, g):
    """Rows of the identity (one 1 each, at random k) read the codes out of
    the split-K kernel's int32 accumulators: 127 x row k of W, bit for bit."""
    import torch

    from qlora_tpu_torch.ops.qmatmul import _i8_direct_decode_outputs

    M = int(shape.split()[0][2:])
    K = qt.packed.shape[0]
    ks = torch.randint(0, K, (M,), device=qt.packed.device, generator=g)
    eye = torch.zeros(M, K, device=qt.packed.device, dtype=torch.bfloat16)
    eye[torch.arange(M, device=eye.device), ks] = 1
    acc = _i8_direct_decode_outputs(eye, qt)[0]
    if not torch.equal(acc, 127 * qt.packed[ks].to(torch.int32)):
        fail(f"qmm_i8_direct {shape}: identity rows do not read the codes out")


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
    # serve-paged-int8, 16, and search's int8 verify chunk of 9) on
    # qmm_i8_direct_decode.cu, which quantizes the rows itself, timed in CUDA
    # graphs beside qmm_i8_direct.cu through its C entry on rows quantized
    # beforehand (tile_ms, the "before"); then a ragged shape, which the decode
    # kernel's plan refuses (qmm_i8_direct.cu, events)
    for K, N in QMM_SHAPES + (LM_HEAD_SHAPE,):
        w = torch.randn(K, N, device=dev, generator=g) * K ** -0.5
        qt = quantize(w, block_size=K, quant_type="int8", double_quant=False)
        del w
        qts = clones(qt)
        s_out = absmax_f32(qt).reshape(-1) / 127.0
        for M in I8_DIRECT_ROWS:
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
        # past 16 rows (verify chunks, wide decode batches; I8_DIRECT_VERIFY) the
        # same kernel on its verify plan, with the same checks and identity rows,
        # timed beside qmm_i8_direct.cu (tile_ms, the "before") and the wrapper
        for M in I8_DIRECT_VERIFY:
            x = torch.randn(M, K, device=dev, generator=g).to(torch.bfloat16)
            shape = f"M={M} K={K} N={N}"
            err, y = i8_direct_decode_check(shape, x, qt)
            i8_direct_identity_check(shape, qt, g)
            x8, xs = quantize_rows(x)
            yt = launch_w8a8("qmm_i8_direct", x8, qt, None, s_out, xs)
            torch.cuda.synchronize()
            if not torch.equal(yt, y):
                fail(f"qmm_i8_direct {shape}: qmm_i8_direct.cu (the before) differs from the "
                     "split-K kernel")
            ms = graph_ms(lambda i: qmm_i8_direct(x, qts[i % len(qts)]), 100)
            more = dict(tile_ms=graph_ms(lambda i: launch_w8a8(
                "qmm_i8_direct", x8, qts[i % len(qts)], None, s_out, xs), 50))
            more["wrapper_ms"] = cuda_ms(lambda i: qmm_i8_direct(x, qts[i % len(qts)]), 100)
            plain_ms = cuda_ms(lambda i: qmm_i8_direct_plain(x, qts[i % len(qts)]), 3)
            lib_ms = int_mm_ms(x8, [q.packed for q in qts], s_out, xs, 200, graph_ms)
            record(results, "qmm_i8_direct", shape, err, exact_tol, ms, plain_ms, lib_ms,
                   int8_bound(M, K, N, K * N + N * 4, PEAK_INT8, 2), **more)
            print(f"  the split-K kernel at {M} rows {more['tile_ms'] / ms:.2f}x "
                  f"qmm_i8_direct.cu's speed, {ms / lib_ms:.2f}x torch._int_mm's time",
                  flush=True)
        # past 64 rows qmm_i8_direct.cu, measured for the queue: on rows quantized
        # beforehand, beside torch._int_mm and the wrapper
        for M in I8_DIRECT_BEYOND:
            x = torch.randn(M, K, device=dev, generator=g).to(torch.bfloat16)
            shape = f"M={M} K={K} N={N}"
            took = qmm_i8_direct.decode_launches
            err, _ = w8a8_check("qmm_i8_direct", shape, qmm_i8_direct, qmm_i8_direct_plain, x,
                                qt, qt.packed)
            if qmm_i8_direct.decode_launches != took:
                fail(f"qmm_i8_direct {shape}: the split-K kernel took more than 64 rows")
            x8, xs = quantize_rows(x)
            ms = graph_ms(lambda i: launch_w8a8("qmm_i8_direct", x8, qts[i % len(qts)], None,
                                                s_out, xs), 50)
            wrapper_ms = cuda_ms(lambda i: qmm_i8_direct(x, qts[i % len(qts)]), 50)
            plain_ms = cuda_ms(lambda i: qmm_i8_direct_plain(x, qts[i % len(qts)]), 3)
            lib_ms = int_mm_ms(x8, [q.packed for q in qts], s_out, xs, 100, graph_ms)
            bound = int8_bound(M, K, N, K * N + N * 4 + M * 4, PEAK_INT8, 1)
            record(results, "qmm_i8_direct", shape, err, exact_tol, ms, plain_ms, lib_ms, bound,
                   wrapper_ms=wrapper_ms)
            print(f"  qmm_i8_direct.cu at {M} rows: {ms / lib_ms:.2f}x torch._int_mm's time, "
                  f"{ms / bound[0]:.1f}x its bound", flush=True)
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
                                               (QMM_BWD_ROWS,))):
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
                    else:
                        print(f"  the decode kernel {more['tile_ms'] / ms:.1f}x qmm_i8.cu's "
                              f"speed, {ms / lib_ms:.2f}x torch.matmul's time", flush=True)
                        decode_checks(f"{name} (decode kernel)", kernel, a, qt, w_bf16)
            # the dx at decode rows: the dx decode kernel, in a graph beside
            # qmm_i8.cu's 16-row tile through its C entry (the "before") and g @ Wᵀ
            bwd_decode_rows("qmm_i8_bwd", qmm_i8_bwd, qmm_i8_bwd_plain,
                            lambda a, q: i8_tile(a, q, False), qt, qts, ws, w_bf16, g, results,
                            lambda M: int8_bound(M, K, N, K * N + am_bytes, PEAK_BF16, 2))
            del qts, ws, w_bf16, qt
        bwd_decode_edges("qmm_i8_bwd", qmm_i8_bwd, qmm_i8_bwd_plain, "int8", dq, g)
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
# qmm_nf4_wgmma_bwd, and those that took qmm_nf4_bwd_decode.cu (M <=
# DECODE_ROWS), read as qmm_nf4_bwd_decode; the int8 dx those that took
# qmm_i8_bwd_decode.cu, read as qmm_i8_bwd_decode; the rest took
# qmm_nf4_bwd.cu and qmm_i8.cu.  The w8a8 forward over NF4
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
                 "qmm_nf4_w8a8_decode": "qmm_nf4_w8a8", "qmm_nf4_bwd_decode": "qmm_nf4_bwd",
                 "qmm_i8_bwd_decode": "qmm_i8_bwd"}
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
    int8_counts, int8_stats, dec = serve_int8(dev, cfg, params, lora, lcfg, ids, lengths, toks)
    search = search_phase(dev, cfg, params, lora, lcfg, ids, lengths, toks, dec, stats)
    del dec
    gc_cuda()
    t0 = time.perf_counter()
    paged = serve_paged_phase(dev, cfg, params, lora, lcfg)
    print(f"serve-paged: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    spec = serve_paged_spec_phase(dev, cfg, params, lora, lcfg)
    print(f"serve-paged-spec: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    spec8 = serve_paged_spec_int8_phase(dev, cfg, params, lora, lcfg)
    print(f"serve-paged-spec-int8: {time.perf_counter() - t0:.1f} s", flush=True)
    del params, lora
    torch.cuda.empty_cache()
    return counts, stats, int8_counts, int8_stats, paged, spec, spec8, search


def serve_int8(dev, cfg, params, lora, lcfg, ids, lengths, nf4_toks):
    """The serve phase's requests again through ``decode_impl="int8"``: the
    prefill on the NF4 params (the exact path), every decode step on a
    per-column int8 serving tree made once, which it returns for the search
    phase's int8 speculation."""
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
    return counts, dict(decode_ms_per_step=decode_s / SERVE_NEW * 1e3,
                        decode_tok_s=toks.numel() / decode_s, peak_gib=peak_gib,
                        requantize_s=requant_s, tokens_equal=agree), dec


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
                 generated=[list(r.generated) for r in reqs],
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


def serve_paged_spec_int8_phase(dev, cfg, params, lora, lcfg):
    """serve-paged-spec-int8: serve-paged-spec's requests through
    ``PagedBatcher(decode_impl="int8", spec_draft_len=SPEC_DRAFT)``: every
    verify chunk's 8 x 5 rows, lm_head included, on the split-K direct int8
    kernel (its verify plan), every plain decode forward's on its decode
    plan, the prefill exact on the NF4 wgmma kernel; exact launch counts.  Its
    tokens are held to the same requests through ``decode_impl="int8"``
    without drafts up to each request's first top-2 margin under NEAR_TIE,
    the margins teacher-forced the way that engine decides: the prompt
    prefilled exact, the tokens after it through its int8 tree.  Every token
    it emitted lies within NEAR_TIE of the best logit, teacher-forced the same
    way over its own tokens (random weights leave few margins clear of the
    rounding, so this is the check that reaches every token), and the next
    token in the vocabulary, a control, does not."""
    import torch

    from qlora_tpu_torch.models import forward, init_cache
    from qlora_tpu_torch.ops import default_impl
    from qlora_tpu_torch.ops.qmatmul import I8_DIRECT_ROWS

    traffic = phrase_traffic(cfg.vocab_size, 5, SPEC_REQUESTS)
    L, n_lin = cfg.num_layers, 7 * cfg.num_layers
    verify_rows = SERVE_PAGED["num_slots"] * (SPEC_DRAFT + 1)
    if verify_rows > I8_DIRECT_ROWS:
        fail(f"serve-paged-spec-int8: verify chunks of {verify_rows} rows pass the split-K "
             f"kernel's {I8_DIRECT_ROWS}")

    def want(st):
        fwds = st["decode"] + st["verify"]
        return expected_counts(qmm_i8_direct=(n_lin + 1) * fwds,          # + 1: the lm_head
                               qmm_i8_direct_decode=(n_lin + 1) * fwds,   # 8 and 40 rows: all
                               qmm_nf4_fwd_dq=n_lin * st["prefill"],      # the prefill exact
                               qmm_nf4_wgmma_dq=n_lin * st["prefill"],
                               paged_decode_attention_cuda=L * st["decode"],
                               paged_decode_split=L * st["decode"],
                               paged_chunk_attention_cuda=L * st["verify"],
                               paged_chunk_split=L * st["verify"])

    t0 = time.perf_counter()
    pb, st, counts, stats = serve_paged_run("serve-paged-spec-int8", dev, cfg, params, lora,
                                            lcfg, traffic, SPEC_PAGES, spec_draft_len=SPEC_DRAFT,
                                            decode_impl="int8")
    built_s = time.perf_counter() - t0 - stats["total_s"]
    per_chunk = pb.spec_tokens / max(pb.spec_chunks, 1)
    ms_chunk = st["verify_s"] / max(st["verify_steps"], 1) * 1e3
    stats.update(tokens_per_chunk=per_chunk, ms_per_chunk=ms_chunk, chunks=pb.spec_chunks,
                 built_s=built_s)
    print(f"serve-paged-spec-int8: {st['verify']} verify forwards of {verify_rows} rows "
          f"({pb.spec_chunks} slot chunks, {per_chunk:.3f} tokens retired per chunk, "
          f"{ms_chunk:.2f} ms per verify step), {st['decode']} plain decode forwards; the int8 "
          f"tree built with the engine in {built_s:.1f} s; launches "
          f"{ {k: v for k, v in counts.items() if v} } (expected "
          f"{ {k: v for k, v in want(st).items() if v} }: {n_lin} + 1 qmm_i8_direct per decode "
          "and verify forward, all on qmm_i8_direct_decode.cu)", flush=True)
    if counts != want(st):
        fail(f"serve-paged-spec-int8 launch counts {counts} != {want(st)}")
    if st["verify"] < 1:
        fail("serve-paged-spec-int8: no verify chunk ran")
    del pb
    torch.cuda.empty_cache()

    # the same requests without drafts, and each one's margins teacher-forced as
    # that engine decides them: the prompt exact, the tokens after it in int8
    ref_pb, ref_st, ref_counts, ref_stats = serve_paged_run(
        "serve-paged-spec-int8 (the same requests without drafts)", dev, cfg, params, lora,
        lcfg, traffic, SPEC_PAGES, decode_impl="int8")
    if ref_counts != want(ref_st):
        fail(f"serve-paged-spec-int8 without drafts: launch counts {ref_counts} != "
             f"{want(ref_st)}")
    if stats["preemptions"] or ref_stats["preemptions"]:
        fail("serve-paged-spec-int8: a preemption (the pool is ample for these requests)")
    dec = ref_pb.decode_params

    def forced(prompt, toks):
        """The logits that decide each of `toks` after `prompt`, as the int8
        engine computes them: the prompt exact, the tokens through `dec`."""
        cache = init_cache(cfg, 1, len(prompt) + len(toks), device=dev)
        first, cache = forward(params, lora, torch.tensor([prompt], device=dev), cfg, lcfg,
                               cache=cache)
        with default_impl("w8a8"):
            tail, _ = forward(dec, lora, torch.tensor([toks[:-1]], device=dev), cfg, lcfg,
                              cache=cache)
        return torch.cat([first[0, -1:], tail[0]]).float()

    clear_upto, compared, equal, short, control = 0, 0, 0, [], []
    with torch.inference_mode():
        for (prompt, _), ref, got in zip(traffic, ref_stats["generated"], stats["generated"]):
            logits = forced(prompt, got)
            tok = torch.tensor(got, device=dev)[:, None]
            best = logits.max(-1).values
            short.append((best - logits.gather(1, tok)[:, 0]).max().item())
            control.append((best - logits.gather(1, (tok + 1) % cfg.vocab_size)[:, 0])
                           .median().item())
            top2 = forced(prompt, ref).topk(2, dim=-1).values
            ties = ((top2[:, 0] - top2[:, 1]) < NEAR_TIE).nonzero()
            upto = int(ties[0]) if len(ties) else len(ref)
            if got[:upto] != ref[:upto]:
                fail(f"serve-paged-spec-int8: a request's tokens differ from the draftless int8 "
                     f"engine's before its first near-tie ({upto} of {len(ref)} tokens)")
            clear_upto += upto
            compared += len(ref)
            equal += got == ref
    print(f"serve-paged-spec-int8: against the same requests without drafts "
          f"({ref_stats['ms_per_step']:.2f} ms a decode step there): {equal} of {len(traffic)} "
          f"equal in full; {clear_upto} of {compared} tokens before each one's first top-2 "
          f"margin under {NEAR_TIE}, all equal; every emitted token within {max(short):.4g} of "
          f"the best teacher-forced logit (the next token's median shortfall, a control: "
          f"{min(control):.4g} at the least)", flush=True)
    if max(short) > NEAR_TIE or min(control) <= NEAR_TIE:
        fail(f"serve-paged-spec-int8: an emitted token falls {max(short):.4g} short of the best "
             f"teacher-forced logit (> {NEAR_TIE}), or the control's {min(control):.4g} does "
             "not exceed it")
    stats.update(equal=equal, clear_upto=clear_upto, compared=compared, worst_short=max(short),
                 ref_ms_per_step=ref_stats["ms_per_step"])
    del ref_pb, dec
    gc_cuda()
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
                 wide=False, few=False):
    """The launches of `micro` micro-batches' forward and backward over L
    layers (block linears M = rows x S > 16: every NF4 or int8 forward and dx
    on a wgmma kernel).  Per micro-batch: the 7 L block linears' forward once,
    twice under remat "full" (the backward's recomputed forward; "save_linear"
    reads them back); their dx 7 L - 3 times (layer 0's wq, wk, wv see the
    embeddings, which need no gradient in LoRA training); flash forward L
    times, 2 L under "full", flash dq and dk, dv L times each, at head dim
    256 (`wide`) all on the WIDE_D tiles.  Mode "full" has no qmm.  With
    `few` (a micro-batch of at most DECODE_ROWS tokens, its S under the
    flash gate): no flash, every forward on a decode kernel and every dx on
    a dx decode kernel."""
    runs = 2 if remat in ("full", True) else 1
    fwd_name, bwd_name = qmm_counters(quant_type)
    flash = {} if few else {"flash_fwd": micro * runs * L, "flash_bwd_dq": micro * L,
                            "flash_bwd_dkv": micro * L}
    counts = {**flash, **{k: flash[n] for k, n in WGMMA_COUNTS.items() if n in flash}}
    if wide:
        counts.update({k: flash[n] for k, n in WIDE_COUNTS.items()})
    if mode == "lora":
        fwd, bwd = micro * runs * 7 * L, micro * (7 * L - 3)
        counts.update({fwd_name: fwd, bwd_name: bwd})
        kernels = {("nf4", False): ("qmm_nf4_wgmma_dq", "qmm_nf4_wgmma_bwd"),
                   ("int8", False): ("qmm_i8_wgmma_fwd", "qmm_i8_wgmma_bwd"),
                   ("nf4", True): ("qmm_nf4_decode_dq", "qmm_nf4_bwd_decode"),
                   ("int8", True): ("qmm_i8_decode_fwd", "qmm_i8_bwd_decode")}
        counts.update(zip(kernels[quant_type, few], (fwd, bwd)))
    return expected_counts(**counts)


def train_parity_phase(dev, quant_type="nf4", cfg=None, S=256, remat="full", tag=None,
                       with_counts=False):
    """One collated micro-batch of 2 rows through ``loss_fn`` on 2 layers at
    full width, the plain path on the CPU against the kernels on the card:
    the loss and every LoRA gradient must agree, and the card's launches be
    exactly ``train_counts``' (at 2 x S <= DECODE_ROWS tokens, its ``few``
    variant).  Returns the worst gradient difference, and with
    ``with_counts`` the card's launches too."""
    import torch

    from qlora_tpu_torch.models import init_params
    from qlora_tpu_torch.ops.qmatmul import DECODE_ROWS
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
    want = train_counts(cfg.num_layers, quant_type, remat, micro=1, wide=cfg.head_dim == 256,
                        few=2 * S <= DECODE_ROWS)
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
    return (worst, counts) if with_counts else worst


def train_parity_few(dev):
    """train-parity-few: train-parity at 2 x TRAIN_FEW_S tokens (16 rows:
    every block linear's forward on a decode kernel and every dx on a dx
    decode kernel, attention below the flash gate) over an NF4 and an int8
    base.  Returns {storage: the card's launches}."""
    t0 = time.perf_counter()
    out, worst = {}, 0.0
    for quant_type in ("nf4", "int8"):
        w, out[quant_type] = train_parity_phase(dev, quant_type, S=TRAIN_FEW_S,
                                                tag=f"train-parity-few-{quant_type}",
                                                with_counts=True)
        worst = max(worst, w)
    print(f"train-parity-few: NF4 and int8, 2 x {TRAIN_FEW_S} tokens, worst gradient "
          f"difference {worst:.4g} <= {GRAD_TOL}; {time.perf_counter() - t0:.1f} s", flush=True)
    return out


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


def alpaca_jsonl(path, n, seed):
    """`n` seeded alpaca-format examples from DATA_WORDS, one JSON object a
    line: an instruction, an input on two in three, an output.  Under
    FakeTokenizer (a token a byte) prompt and output span ~200-1000 tokens,
    so that both of the collator's limits cut some examples."""
    import numpy as np

    rng = np.random.default_rng(seed)
    text = lambda lo, hi: " ".join(rng.choice(DATA_WORDS, int(rng.integers(lo, hi))))
    with open(path, "w") as f:
        for i in range(n):
            ex = {"instruction": text(3, 20), "input": text(8, 45) if i % 3 else "",
                  "output": text(2, 70)}
            f.write(json.dumps(ex) + "\n")


def data_micro_batches(path):
    """The file through ``make_dataset`` and the collator (FakeTokenizer,
    source 384, target 128, padded to 512), grouped by ``bucket_batches``
    into micro-batches of TRAIN_MICRO[0] rows in its seeded order.  Returns
    (micro-batches, stats)."""
    import numpy as np

    from qlora_tpu_torch.train import CausalCollator, bucket_batches, example_length, make_dataset
    from qlora_tpu_torch.utils import FakeTokenizer

    tok = FakeTokenizer()
    train, evals = make_dataset(path, dataset_format="alpaca", do_eval=True,
                                eval_dataset_size=DATA_EVAL)
    collate = CausalCollator(tok, source_max_len=DATA_SOURCE, target_max_len=DATA_TARGET,
                             train_on_source=False, pad_to=TRAIN_MICRO[1])
    lengths = [example_length(tok, ex) for ex in train]
    order = bucket_batches(lengths, TRAIN_MICRO[0], buckets=(TRAIN_MICRO[1],), seed=5,
                           drop_last=True)
    micro = [collate([train[i] for i in idx]) for idx, _ in order]
    cut = sum(1 + len(tok.encode(ex["input"])) > DATA_SOURCE
              or len(tok.encode(ex["output"])) + 1 > DATA_TARGET for ex in train)
    used = micro[:DATA_STEPS * TRAIN_ACCUM]
    real = sum(int(m["attention_mask"].sum()) for m in used)
    masked = sum(int(((m["labels"] == -100) & (m["attention_mask"] == 1)).sum()) for m in used)
    return micro, dict(train=len(train), eval=len(evals), min_len=min(lengths),
                       max_len=max(lengths), truncated=cut, masked_share=masked / real,
                       micro=len(micro), real=real,
                       lens=np.percentile(lengths, [50, 90]).tolist())


def profile_top(prof, wall_s, card):
    """The profiled step's 10 CUDA operations with the most device time and
    its device-busy time (the kernels' summed time) against its wall time.
    Printed only: it gates nothing."""
    from torch.autograd import DeviceType

    dev_us = lambda e: getattr(e, "self_device_time_total", 0) or getattr(
        e, "self_cuda_time_total", 0)
    rows = [e for e in prof.key_averages() if getattr(e, "device_type", None) == DeviceType.CUDA]
    rows = rows or [e for e in prof.key_averages() if dev_us(e) > 0]
    if not rows:
        print(f"train-data profile: no device time recorded ({card})", flush=True)
        return
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    top = sorted(rows, key=dev_us, reverse=True)[:10]
    print(f"train-data profile of step {DATA_PROFILE_STEP} ({card}): device busy "
          f"{busy_ms:.1f} ms of {wall_s * 1e3:.1f} ms wall ({busy_ms / (wall_s * 1e3):.1%}); "
          "top 10 by device time:", flush=True)
    for e in top:
        print(f"  {dev_us(e) / 1e3:9.3f} ms  {e.count:5d} calls  {e.key[:110]}", flush=True)


def tensor_bits(t):
    """A tensor's bytes, for byte-for-byte comparisons (bf16, 0-d included)."""
    import torch

    return t.detach().reshape(-1).contiguous().view(torch.uint8)


def same_bytes(a, b):
    import torch

    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(tensor_bits(a),
                                                                     tensor_bits(b))


def store_phase(dev, cfg, params, tmp, card):
    """save_quantized the 32-layer base, load_quantized it onto the card:
    every tensor byte-equal; a STORE_PROMPT-token prefill's logits and
    STORE_NEW greedy tokens through ``generate()`` equal on the originals
    and the reloaded, bit for bit, with the launches of both exact (as
    nodq's: the prefills on the NF4 wgmma kernel, every decode step on the
    decode kernels)."""
    import torch

    from qlora_tpu_torch.generate import generate
    from qlora_tpu_torch.models import forward, init_cache
    from qlora_tpu_torch.utils import load_quantized, save_quantized

    path = str(Path(tmp) / "store")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_quantized(path, params, cfg)
    save_s = time.perf_counter() - t0
    nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
    t0 = time.perf_counter()
    back, cfg2 = load_quantized(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if cfg2 != cfg:
        fail(f"train-data store: the config came back as {cfg2}")
    n = 0
    for i, (blk, want) in enumerate(zip(back["blocks"], params["blocks"])):
        if sorted(blk) != sorted(want):
            fail(f"train-data store: layer {i} came back with {sorted(blk)}")
        for name in blk:
            got_t, want_t = frozen_tensors(blk[name]), frozen_tensors(want[name])
            if len(got_t) != len(want_t) or not all(
                    a.is_cuda and same_bytes(a, b) for a, b in zip(got_t, want_t)):
                fail(f"train-data store: layer {i} {name} did not come back byte-equal")
            n += len(got_t)
    for key in ("embed", "final_norm", "lm_head"):
        got_t, want_t = frozen_tensors(back[key]), frozen_tensors(params[key])
        if not all(a.is_cuda and same_bytes(a, b) for a, b in zip(got_t, want_t)):
            fail(f"train-data store: {key} did not come back byte-equal")
        n += len(got_t)
    ids, lengths = padded_requests((STORE_PROMPT,), STORE_PROMPT, cfg.vocab_size, 61)
    outs = []
    reset_counts()
    with torch.inference_mode():
        for p in (params, back):
            cache = init_cache(cfg, 1, STORE_PROMPT, device=dev)
            logits, _ = forward(p, None, ids.to(dev), cfg, cache=cache)
            toks = generate(p, None, ids, lengths, cfg, max_new_tokens=STORE_NEW, eos_id=-1,
                            device=dev)
            outs.append((logits, toks))
    torch.cuda.synchronize()
    counts = read_counts()
    n_lin, L = 7 * cfg.num_layers, cfg.num_layers        # each of the two: a prefill + generate()
    want = expected_counts(qmm_nf4_fwd_dq=2 * n_lin * (STORE_NEW + 2),
                           qmm_nf4_decode_dq=2 * n_lin * STORE_NEW,
                           qmm_nf4_wgmma_dq=2 * 2 * n_lin,
                           decode_attention_cuda=2 * L * STORE_NEW)
    if counts != want:
        fail(f"train-data store launch counts {counts} != {want}")
    (l0, t0_), (l1, t1_) = outs
    print(f"train-data store ({card}): {nbytes / 1e9:.3f} GB written in {save_s:.2f} s, read "
          f"onto the card in {load_s:.2f} s; {n} tensors byte-equal; prefill logits "
          f"bit-equal {torch.equal(l0, l1)}, {STORE_NEW} greedy tokens {t0_.tolist()} and "
          f"{t1_.tolist()}; launches {({k: v for k, v in counts.items() if v})}", flush=True)
    if not (torch.isfinite(l0).all() and torch.equal(l0, l1) and torch.equal(t0_, t1_)):
        fail("train-data store: the reloaded base gives other logits or tokens")
    del back
    torch.cuda.empty_cache()


def write_safetensors(path, tensors):
    """A .safetensors file of bf16 tensors, in the format's own terms: an
    8-byte little-endian header length, a JSON header of each tensor's
    dtype, shape and data_offsets (padded with spaces to 8 bytes), the raw
    bytes."""
    import torch

    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        b = t.to(torch.bfloat16).contiguous().view(torch.int16).numpy().tobytes()
        header[name] = {"dtype": "BF16", "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(b)]}
        blobs.append(b)
        offset += len(b)
    head = json.dumps({"__metadata__": {"format": "pt"}, **header}).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for b in blobs:
            f.write(b)


def write_hf_checkpoint(path, layers, seed):
    """A `layers`-layer LLaMA-7B-width checkpoint in HF's names under `path`
    (created): config.json and random bf16 weights from `seed` as
    model.safetensors.  Returns its config."""
    import torch

    cfg = seven_b(layers)
    path.mkdir()
    (path / "config.json").write_text(json.dumps({
        "model_type": "llama", "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size, "num_hidden_layers": layers,
        "num_attention_heads": cfg.num_heads, "num_key_value_heads": cfg.num_kv_heads,
        "max_position_embeddings": cfg.max_position_embeddings, "rms_norm_eps": cfg.norm_eps,
        "tie_word_embeddings": False}))
    g = torch.Generator().manual_seed(seed)
    D, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    rand = lambda out_dim, in_dim: torch.randn(out_dim, in_dim, generator=g) * in_dim ** -0.5
    tensors = {"model.embed_tokens.weight": torch.randn(V, D, generator=g) * 0.02,
               "model.norm.weight": 1 + 0.1 * torch.randn(D, generator=g),
               "lm_head.weight": rand(V, D)}
    for i in range(layers):
        pre = f"model.layers.{i}."
        for name, (o, n) in {"self_attn.q_proj": (D, D), "self_attn.k_proj": (D, D),
                             "self_attn.v_proj": (D, D), "self_attn.o_proj": (D, D),
                             "mlp.gate_proj": (I, D), "mlp.up_proj": (I, D),
                             "mlp.down_proj": (D, I)}.items():
            tensors[f"{pre}{name}.weight"] = rand(o, n)
        for name in ("input_layernorm", "post_attention_layernorm"):
            tensors[f"{pre}{name}.weight"] = 1 + 0.1 * torch.randn(D, generator=g)
    write_safetensors(path / "model.safetensors", tensors)
    return cfg


def hf_import_phase(dev, tmp, card):
    """A HF_LAYERS-layer checkpoint at LLaMA-7B width in HF's LLaMA names,
    random bf16 weights from a seed, written as model.safetensors; the
    port's ``load_hf_model`` (its own reader; NF4, double quant) onto the
    card and onto the CPU: a STORE_PROMPT-token prefill through the kernels
    within LOGIT_TOL of the plain path's."""
    import torch

    from qlora_tpu_torch.models import forward, init_cache
    from qlora_tpu_torch.utils import load_hf_model

    path = Path(tmp) / "hf"
    cfg = write_hf_checkpoint(path, HF_LAYERS, 71)
    V = cfg.vocab_size
    nbytes = (path / "model.safetensors").stat().st_size
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_gpu, cfg_gpu = load_hf_model(str(path), device=dev)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    p_cpu, cfg_cpu = load_hf_model(str(path), device="cpu")
    if not cfg_gpu == cfg_cpu == cfg:
        fail(f"hf import: config {cfg_gpu} / {cfg_cpu}, expected {cfg}")
    ids = torch.randint(3, V, (1, STORE_PROMPT), generator=torch.Generator().manual_seed(72))
    with torch.inference_mode():
        lg, _ = forward(p_gpu, None, ids.to(dev), cfg,
                        cache=init_cache(cfg, 1, STORE_PROMPT, device=dev))
        lc, _ = forward(p_cpu, None, ids, cfg,
                        cache=init_cache(cfg, 1, STORE_PROMPT, device="cpu"))
    err = (lg.cpu() - lc).abs().max().item()
    print(f"train-data hf import ({card}): {HF_LAYERS} layers at LLaMA-7B width, "
          f"{nbytes / 1e9:.3f} GB of bf16 safetensors, imported (NF4, double quant) onto the "
          f"card in {import_s:.2f} s; prefill max|logits card - cpu| = {err:.4g} (tol "
          f"{LOGIT_TOL}, |logits| max {lc.abs().max().item():.3g})", flush=True)
    if not torch.isfinite(lg).all() or err > LOGIT_TOL:
        fail(f"hf import: card logits differ from the CPU's by {err}")
    del p_gpu, p_cpu
    torch.cuda.empty_cache()


def train_data_phase(dev, made=None, card=""):
    """train-data: the train phase's weights (``made``, or new ones) and a
    fresh rank-64 LoRA (dropout 0) trained from an alpaca .jsonl file in a
    temporary directory: run A takes DATA_STEPS steps (each logged through
    MetricsLogger and StepTimer, step DATA_PROFILE_STEP under maybe_profile)
    and checkpoints after DATA_SAVE_AT; run B resumes from that checkpoint
    into fresh trees and takes the rest on the same micro-batches: its
    losses and final LoRA equal run A's bit for bit.  Then the quantized
    store and the HF import (``store_phase``, ``hf_import_phase``)."""
    import tempfile

    import numpy as np
    import torch

    from qlora_tpu_torch.models import init_lora_params
    from qlora_tpu_torch.train import init_train_state, make_optimizer, make_train_step
    from qlora_tpu_torch.train.optimizer import tree_leaves
    from qlora_tpu_torch.utils import (
        MetricsLogger, StepTimer, get_last_checkpoint, load_checkpoint, mark_completed,
        maybe_profile, save_checkpoint,
    )

    t_phase = time.perf_counter()
    cfg = seven_b()
    params, _, lcfg = made or train_model(dev, cfg)
    if lcfg.dropout != 0:
        fail("train-data: a resumed run equals an uninterrupted one only without dropout")
    stats = {}
    with tempfile.TemporaryDirectory() as tmp:
        data_file = str(Path(tmp) / "alpaca.jsonl")
        alpaca_jsonl(data_file, DATA_EXAMPLES, seed=51)
        micro, ds = data_micro_batches(data_file)
        need = DATA_STEPS * TRAIN_ACCUM
        print(f"train-data: {DATA_EXAMPLES} alpaca examples in a .jsonl -> {ds['train']} train, "
              f"{ds['eval']} eval; example lengths {ds['min_len']}..{ds['max_len']} tokens "
              f"(median, p90 {ds['lens']}), {ds['truncated']} of {ds['train']} truncated by the "
              f"collator (source {DATA_SOURCE}, target {DATA_TARGET}); {ds['micro']} "
              f"micro-batches of {TRAIN_MICRO[0]} x {TRAIN_MICRO[1]}, the first {need} used: "
              f"{ds['real']} real tokens, {ds['masked_share']:.1%} of their labels masked",
              flush=True)
        if ds["truncated"] == 0 or not 0 < ds["masked_share"] < 1 or ds["micro"] < need:
            fail(f"train-data: the data does not exercise truncation and masking: {ds}")
        step_batch = lambda i: {k: np.stack([m[k] for m in micro[TRAIN_ACCUM * i:
                                                                 TRAIN_ACCUM * (i + 1)]])
                                for k in micro[0]}
        opt = make_optimizer("paged_adamw_32bit", TRAIN_LR, total_steps=DATA_STEPS,
                             warmup_ratio=DATA_WARMUP)
        step = make_train_step(cfg, lcfg, opt, accum_steps=TRAIN_ACCUM, device=dev)
        out = str(Path(tmp) / "run")
        per_step = train_counts(cfg.num_layers)

        def run(state, first, last, tag, logger, timer):
            """Optimizer steps first..last (1-based) on their micro-batches."""
            metrics, prof, wall = [], None, None
            reset_counts()
            for i in range(first, last + 1):
                profiled = i == DATA_PROFILE_STEP and tag == "A"
                with maybe_profile(out, profiled) as p:
                    timer.tick()
                    state, m = step(state, params, step_batch(i - 1))
                    dt = timer.tock()
                if profiled:
                    prof, wall = p, dt
                loss, norm = m["loss"].item(), m["grad_norm"].item()
                logger.log({"loss": loss, "grad_norm": norm, "step_s": dt, "run": tag}, step=i)
                metrics.append((loss, norm))
                if tag == "A" and i == DATA_SAVE_AT:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    ckpt = save_checkpoint(out, i, state.trainable, state.opt_state,
                                           data_state={"micro_batches": TRAIN_ACCUM * i})
                    stats["ckpt_save_s"] = time.perf_counter() - t0
                    stats["ckpt_bytes"] = sum(f.stat().st_size for f in Path(ckpt).rglob("*")
                                              if f.is_file())
            torch.cuda.synchronize()
            counts = read_counts()
            want = {k: v * (last - first + 1) for k, v in per_step.items()}
            if counts != want:
                fail(f"train-data run {tag} launch counts {counts} != {want}")
            return state, metrics, counts, prof, wall

        # the first step warms the allocator, the second runs under the profiler
        logger, timer = MetricsLogger(out), StepTimer(skip_first=DATA_PROFILE_STEP, device=dev)
        fresh = lambda seed: init_lora_params(cfg, lcfg, seed=seed, device=dev)
        a_state, a_metrics, a_counts, prof, wall = run(
            init_train_state(fresh(53), opt, device=dev), 1, DATA_STEPS, "A", logger, timer)
        ckpt, done = get_last_checkpoint(out)
        if done or ckpt is None or not ckpt.endswith(f"checkpoint-{DATA_SAVE_AT}"):
            fail(f"train-data: get_last_checkpoint gave {ckpt}, completed {done}")
        t0 = time.perf_counter()
        like = init_train_state(fresh(54), opt, device=dev)
        lora, opt_state, info = load_checkpoint(ckpt, like.trainable, like.opt_state)
        torch.cuda.synchronize()
        stats["ckpt_load_s"] = time.perf_counter() - t0
        if info.get("data_state") != {"micro_batches": TRAIN_ACCUM * DATA_SAVE_AT} or \
                opt_state["count"] != DATA_SAVE_AT:
            fail(f"train-data: the checkpoint's state is {info}, count {opt_state['count']}")
        b_state, b_metrics, b_counts, _, _ = run(
            type(like)(step=info["step"], trainable=lora, opt_state=opt_state),
            DATA_SAVE_AT + 1, DATA_STEPS, "B", logger, timer)
        logger.close()
        mark_completed(out)
        logged = [json.loads(line) for line in open(Path(out) / "train_log.jsonl")]
        same = sum(torch.equal(a, b) for a, b in zip(tree_leaves(a_state.trainable),
                                                     tree_leaves(b_state.trainable)))
        n_lora = len(tree_leaves(a_state.trainable))
        print(f"train-data ({card}): run A losses "
              + ", ".join(f"{l:.6f}" for l, _ in a_metrics) + "; run B (steps "
              f"{DATA_SAVE_AT + 1}..{DATA_STEPS}, resumed) " + ", ".join(
                  f"{l:.6f}" for l, _ in b_metrics) + f"; bit-equal losses and gradient norms "
              f"{b_metrics == a_metrics[DATA_SAVE_AT:]}, LoRA tensors {same} of {n_lora}; step "
              f"times (StepTimer, run A's steps {DATA_PROFILE_STEP + 1}.. and run B's) "
              f"{', '.join(f'{t:.3f}' for t in timer.times)} s, mean {timer.mean:.3f} s; "
              f"{len(logged)} lines in train_log.jsonl", flush=True)
        print(f"train-data checkpoint ({card}): {stats['ckpt_bytes'] / 1e6:.1f} MB (LoRA, AdamW "
              f"state, trainer_state.json), saved in {stats['ckpt_save_s']:.2f} s, loaded onto "
              f"the card in {stats['ckpt_load_s']:.2f} s", flush=True)
        nonzero = lambda c: {k: v for k, v in c.items() if v}
        print(f"train-data: launches run A {nonzero(a_counts)}; run B {nonzero(b_counts)} "
              f"(expected {DATA_STEPS} and {DATA_STEPS - DATA_SAVE_AT} x {nonzero(per_step)}, "
              "every other counter 0)", flush=True)
        if b_metrics != a_metrics[DATA_SAVE_AT:] or same != n_lora:
            fail("train-data: the resumed run differs from the uninterrupted one")
        if get_last_checkpoint(out) != (None, True) or len(logged) != DATA_STEPS + (
                DATA_STEPS - DATA_SAVE_AT):
            fail("train-data: the completed sentinel or the metrics log is wrong")
        if not np.isfinite(a_metrics).all():      # each step has batches of its own
            fail(f"train-data: run A's losses or gradient norms {a_metrics}")
        profile_top(prof, wall, card)
        del a_state, b_state, like, lora, opt_state
        torch.cuda.empty_cache()
        store_phase(dev, cfg, params, tmp, card)
        hf_import_phase(dev, tmp, card)
    print(f"train-data ({card}): {time.perf_counter() - t_phase:.1f} s", flush=True)


def cli_argv(data, out, steps, dev, *extra):
    """The driver's command line for the cli phase: LLaMA-7B with random
    weights, FakeTokenizer, the alpaca file, the train cell's micro-batches
    (2 x 512 = source 384 + target 128, 2 a step, no length grouping)."""
    return ["--model_name_or_path", CLI_MODEL, "--init_random", "--fake_tokenizer",
            "--dataset", data, "--output_dir", out, "--device", str(dev),
            "--eval_dataset_size", str(DATA_EVAL), "--max_eval_samples", str(DATA_EVAL),
            "--per_device_train_batch_size", str(TRAIN_MICRO[0]),
            "--gradient_accumulation_steps", str(TRAIN_ACCUM),
            "--source_max_len", str(DATA_SOURCE), "--target_max_len", str(DATA_TARGET),
            "--group_by_length", "false", "--lora_dropout", "0", "--max_steps", str(steps),
            "--save_steps", str(CLI_SAVE), "--save_total_limit", str(CLI_KEEP),
            "--logging_steps", "1", "--do_eval", "--per_device_eval_batch_size",
            str(CLI_EVAL_BATCH), *extra]


def counted_generate_forwards():
    """Wrap ``generate``'s forward to count its decode forwards (one token
    over a cache); returns (counter, undo)."""
    import qlora_tpu_torch.generate.engine as engine

    real, seen = engine.forward, {"decode": 0}

    def forward(params, lora, ids, *a, **kw):
        if kw.get("cache") is not None and ids.shape[1] == 1:
            seen["decode"] += 1
        return real(params, lora, ids, *a, **kw)

    engine.forward = forward
    return seen, lambda: setattr(engine, "forward", real)


def cli_phase(dev, card=""):
    """cli: ``qlora_tpu_torch.cli.main`` in process at LLaMA-7B full width and
    depth.  Run A trains CLI_STEPS steps from an alpaca .jsonl (checkpoints
    every CLI_SAVE, CLI_KEEP kept), evaluates at its last step and at the
    end, scores MMLU (the bundled five-shot file, S = 2048: flash) and
    predicts the eval split; run B trains CLI_RESUME_AT steps in a fresh
    directory, then resumes to CLI_STEPS: its logged losses and final LoRA
    equal run A's bit for bit.  Launch counts exact; then ``python3 -m
    qlora_tpu_torch.cli`` on run A's directory skips the completed run."""
    import os
    import tempfile

    import numpy as np
    import torch

    from qlora_tpu_torch import cli
    from qlora_tpu_torch.utils.checkpoint import read_arrays

    t_phase = time.perf_counter()
    L = seven_b().num_layers
    n_lin = 7 * L
    with tempfile.TemporaryDirectory() as tmp:
        data = str(Path(tmp) / "alpaca.jsonl")
        alpaca_jsonl(data, DATA_EXAMPLES, seed=51)
        out_a, out_b = str(Path(tmp) / "a"), str(Path(tmp) / "b")
        argv_a = cli_argv(data, out_a, CLI_STEPS, dev, "--eval_steps", str(CLI_STEPS),
                          "--do_mmlu_eval", "--mmlu_dataset", "mmlu-fs",
                          "--max_mmlu_samples", str(CLI_MMLU),
                          "--mmlu_source_max_len", str(CLI_MMLU_LEN), "--do_predict",
                          "--max_new_tokens", str(CLI_NEW))

        def run(argv):
            torch.cuda.synchronize()
            reset_counts()
            seen, undo = counted_generate_forwards()
            t0 = time.perf_counter()
            try:
                metrics = cli.main(argv)
            finally:
                undo()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            gc_cuda()
            return metrics, read_counts(), seen["decode"], secs

        a, a_counts, a_decode, a_s = run(argv_a)
        eval_fwds = 2 * -(-DATA_EVAL // CLI_EVAL_BATCH)        # at step CLI_STEPS and at the end
        mmlu_fwds = -(-CLI_MMLU // CLI_EVAL_BATCH)
        predict_fwds = -(-DATA_EVAL // CLI_EVAL_BATCH)         # one prefill a batch
        step = train_counts(L)
        fwd_wgmma = CLI_STEPS * step["qmm_nf4_fwd_dq"] + n_lin * (eval_fwds + mmlu_fwds
                                                                  + predict_fwds)
        flash_fwd = CLI_STEPS * step["flash_fwd"] + L * (eval_fwds + mmlu_fwds)
        want_a = expected_counts(**{
            **{k: CLI_STEPS * v for k, v in step.items() if v},
            "qmm_nf4_fwd_dq": fwd_wgmma + n_lin * a_decode, "qmm_nf4_wgmma_dq": fwd_wgmma,
            "qmm_nf4_decode_dq": n_lin * a_decode, "decode_attention_cuda": L * a_decode,
            "flash_fwd": flash_fwd, "flash_wgmma_fwd": flash_fwd})
        nonzero = lambda c: {k: v for k, v in c.items() if v}
        print(f"cli run A ({CLI_STEPS} steps, eval at step {CLI_STEPS} and at the end, MMLU "
              f"{CLI_MMLU} five-shot rows at S = {CLI_MMLU_LEN + 16}, predict {DATA_EVAL} "
              f"prompts x {CLI_NEW} tokens: {a_decode} decode forwards): launches "
              f"{nonzero(a_counts)} (expected {nonzero(want_a)}: {step['qmm_nf4_fwd_dq']} NF4 "
              f"forward, {step['qmm_nf4_bwd']} dx and {step['flash_fwd']} of each flash kernel "
              f"a step, all on the wgmma kernels; {n_lin} NF4 forward and {L} flash forward "
              f"an eval or MMLU forward, {n_lin} a prefill, {n_lin} on the decode kernel and "
              f"{L} decode attention a decode forward)", flush=True)
        if a_counts != want_a:
            fail(f"cli run A launch counts {a_counts} != {want_a}")
        if a_decode != predict_fwds * CLI_NEW:
            print(f"cli run A: {a_decode} decode forwards, not {predict_fwds * CLI_NEW}: every "
                  "row of a batch met eos early", flush=True)
        hist = a.get("train_metrics", [])
        losses = [h["loss"] for h in hist]
        preds = [json.loads(line) for line in open(Path(out_a) / "predictions.jsonl")]
        kept = sorted(n for n in os.listdir(out_a) if n.startswith("checkpoint-"))
        saved = json.load(open(Path(out_a) / "metrics.json"))
        logged = [json.loads(line) for line in open(Path(out_a) / "train_log.jsonl")]
        print(f"cli run A ({card}): {a_s:.1f} s; losses " + ", ".join(f"{v:.6f}" for v in losses)
              + f"; logged s/step " + ", ".join(f"{h['seconds_per_step']:.3f}" for h in hist)
              + f"; eval_loss {a.get('eval_loss', float('nan')):.6f}, mmlu_loss "
              f"{a.get('mmlu_loss', float('nan')):.6f}, mmlu_eval_accuracy "
              f"{a.get('mmlu_eval_accuracy', float('nan')):.4f}; {len(preds)} predictions; "
              f"checkpoints kept {kept}", flush=True)
        if (len(losses) != CLI_STEPS or not np.isfinite(losses).all()
                or not losses[-1] < losses[0]):
            fail(f"cli run A: the losses {losses} are not finite and falling")
        if not (0 < a.get("eval_loss", -1) < 2 * np.log(seven_b().vocab_size)
                and 0 <= a.get("mmlu_eval_accuracy", -1) <= 1
                and np.isfinite(a.get("mmlu_loss", np.nan))):
            fail(f"cli run A: eval or MMLU out of range: {a}")
        if len(preds) != DATA_EVAL or not all("prediction" in p for p in preds):
            fail(f"cli run A: {len(preds)} predictions for {DATA_EVAL} eval examples")
        if kept != [f"checkpoint-{CLI_STEPS - CLI_SAVE}", f"checkpoint-{CLI_STEPS}"]:
            fail(f"cli run A: checkpoints {kept} kept, not the last {CLI_KEEP}")
        if saved.keys() != a.keys() or not {"train_metrics", "eval_loss", "mmlu_eval_accuracy",
                                            "predictions_path"} <= saved.keys():
            fail(f"cli run A: metrics.json holds {sorted(saved)}")
        if not (any("eval_loss" in r for r in logged)
                and any("mmlu_eval_accuracy" in r for r in logged)):
            fail("cli run A: the in-training eval or MMLU is missing from train_log.jsonl")

        b1, _, _, b1_s = run(cli_argv(data, out_b, CLI_RESUME_AT, dev))
        os.remove(Path(out_b) / "completed")       # an interrupted longer run
        b2, b_counts, _, b2_s = run(cli_argv(data, out_b, CLI_STEPS, dev))
        rest = CLI_STEPS - CLI_RESUME_AT
        eval_b = -(-DATA_EVAL // CLI_EVAL_BATCH)
        want_b = expected_counts(**{
            **{k: rest * v for k, v in step.items() if v},
            "qmm_nf4_fwd_dq": rest * step["qmm_nf4_fwd_dq"] + n_lin * eval_b,
            "qmm_nf4_wgmma_dq": rest * step["qmm_nf4_fwd_dq"] + n_lin * eval_b,
            "flash_fwd": rest * step["flash_fwd"] + L * eval_b,
            "flash_wgmma_fwd": rest * step["flash_fwd"] + L * eval_b})
        if b_counts != want_b:
            fail(f"cli run B (resumed) launch counts {b_counts} != {want_b}")
        pick = lambda m: [(h["step"], h["loss"], h["grad_norm"]) for h in m["train_metrics"]]
        lora_a = read_arrays(str(Path(out_a) / f"checkpoint-{CLI_STEPS}" / "adapter_model"
                                 / "adapter_weights.npz"))
        lora_b = read_arrays(str(Path(out_b) / f"checkpoint-{CLI_STEPS}" / "adapter_model"
                                 / "adapter_weights.npz"))
        same = sum(torch.equal(lora_a[k], lora_b[k]) for k in lora_a)
        print(f"cli run B: {CLI_RESUME_AT} steps in {b1_s:.1f} s, then resumed from "
              f"checkpoint-{CLI_RESUME_AT} to step {CLI_STEPS} in {b2_s:.1f} s; losses of steps "
              f"{CLI_RESUME_AT + 1}..{CLI_STEPS} " + ", ".join(f"{h[1]:.6f}" for h in pick(b2))
              + f" (run A's " + ", ".join(f"{h[1]:.6f}" for h in pick(a)[CLI_RESUME_AT:])
              + f"); bit-equal {pick(b2) == pick(a)[CLI_RESUME_AT:]}, steps 1..{CLI_RESUME_AT} "
              f"bit-equal {pick(b1) == pick(a)[:CLI_RESUME_AT]}; final LoRA {same} of "
              f"{len(lora_a)} arrays equal", flush=True)
        if (pick(b2) != pick(a)[CLI_RESUME_AT:] or pick(b1) != pick(a)[:CLI_RESUME_AT]
                or same != len(lora_a) or lora_a.keys() != lora_b.keys()):
            fail("cli: the resumed run B differs from run A")

        t0 = time.perf_counter()
        done = subprocess.run([sys.executable, "-m", "qlora_tpu_torch.cli", *argv_a],
                              cwd=ROOT, capture_output=True, text=True, timeout=300)
        sub_s = time.perf_counter() - t0
        print(f"cli: python3 -m qlora_tpu_torch.cli on run A's directory: exit "
              f"{done.returncode} in {sub_s:.1f} s, "
              f"{'training already completed' in done.stderr and 'skipped' or 'not skipped'}",
              flush=True)
        if done.returncode != 0 or "training already completed" not in done.stderr:
            fail(f"cli: the completed run was not skipped: {done.stderr[-2000:]}")
    steady = [h["seconds_per_step"] for h in hist[1::2]]    # steps 2, 4, 6: no save before them
    print(f"cli ({card}): run A {a_s:.1f} s, run B {b1_s:.1f} + {b2_s:.1f} s, the skipped "
          f"run {sub_s:.1f} s; run A's steps 2, 4, 6 {', '.join(f'{t:.3f}' for t in steady)} "
          f"s/step (logged: the host clock between two loss reads), mean "
          f"{sum(steady) / len(steady):.3f}; phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return a_counts, dict(step_s=sum(steady) / len(steady), run_a_s=a_s)


def gc_cuda():
    import gc

    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def http_traffic(seed, n, chat):
    """`n` requests, paged_traffic's lengths and budgets from `seed`: each
    prompt printable ASCII (a FakeTokenizer token a byte) of its length;
    the last `chat` are chats whose Guanaco prompt has that length.
    Returns [(path, body, prompt token ids)]."""
    from qlora_tpu_torch.serve_openai import guanaco_prompt
    from qlora_tpu_torch.utils import FakeTokenizer

    tok = FakeTokenizer()
    out = []
    for i, (ids, budget) in enumerate(paged_traffic(95, seed, n)):
        text = "".join(chr(32 + t % 95) for t in ids)
        stream = i % 2 == 1
        if i < n - chat:
            body = {"prompt": text, "max_tokens": budget, "stream": stream}
            prompt = text
        else:
            room = len(text) - len(guanaco_prompt([{"role": "user", "content": ""}]))
            messages = [{"role": "user", "content": text[:room]}]
            body = {"messages": messages, "max_tokens": budget, "stream": stream}
            prompt = guanaco_prompt(messages)
        if len(tok.encode(prompt)) != len(ids):
            fail("serve-http: a prompt's length is not its traffic's")
        out.append(("/v1/chat/completions" if i >= n - chat else "/v1/completions", body,
                    tok.encode(prompt)))
    return out


def http_client(url, path, body, results, i):
    """One client: POST, then read the whole answer (SSE events for a
    stream); records status, the parsed answer and its host times."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            text = r.read().decode()
            status = r.status
    except urllib.error.HTTPError as e:
        text, status = e.read().decode(), e.code
    results[i] = dict(status=status, text=text, sent=t0, done=time.perf_counter())


def http_engine_run(dev, cfg, params, lora, lcfg, tok, traffic, engine_kw):
    """The endpoint's half of serve-http: ``ServingEngine`` behind
    ThreadingHTTPServer on 127.0.0.1, one client thread a request of
    `traffic` (the last refused for its temperature), the engine's forwards
    counted and timed by ``instrument``.  Returns plain data: the answers,
    each served request's generated tokens and first-token time, the launch
    counts, the instrument stats, the preemptions and the engine's error;
    the engine, its batcher and the server are gone when it returns."""
    import threading
    from http.server import ThreadingHTTPServer

    import torch

    from qlora_tpu_torch.serve_openai import ServingEngine, make_handler

    engine = ServingEngine(params, lora, cfg, tok, lcfg=lcfg, model_id="llama-7b", device=dev,
                           **engine_kw)
    pb = engine.pb
    st = instrument(pb)
    reqs, first = {}, {}
    submit = pb.submit

    def recorded_submit(prompt, max_new_tokens=128, on_token=None):
        key = tuple(prompt)

        def on_tok(uid, t):
            first.setdefault(key, time.perf_counter())
            on_token(uid, t)

        reqs[key] = submit(prompt, max_new_tokens=max_new_tokens, on_token=on_tok)
        return reqs[key]

    refused = len(traffic) - 1
    order = {tuple(ids): i for i, (_, _, ids) in enumerate(traffic)}
    admit, gate = pb._admit, threading.Event()

    def gated_admit():
        # admission starts once every served client's request is in, in the
        # clients' order: the schedule (and its preemptions) is then the
        # direct PagedBatcher's, whatever order the threads ran in
        if not gate.is_set():
            if len(reqs) < refused:
                time.sleep(0.001)
                return
            pb.queue.sort(key=lambda r: order[tuple(r.prompt)])
            gate.set()
        admit()

    pb.submit, pb._admit = recorded_submit, gated_admit
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(engine))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    results = {}
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    clients = [threading.Thread(target=http_client, args=(url, path, body, results, i))
               for i, (path, body, _) in enumerate(traffic)]
    for c in clients:
        c.start()
    for c in clients:
        c.join(timeout=900)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = read_counts()
    srv.shutdown()
    srv.server_close()
    engine.shutdown()
    generated = {k: list(r.generated) for k, r in reqs.items() if r.done}
    return dict(results=results, generated=generated, first=first, counts=counts,
                arrival=list(reqs),     # the prompts in the order the engine took them
                st=dict(st), wall=wall, preemptions=pb.preemptions, error=engine.error,
                sparams=engine.sparams,
                alive=engine.thread.is_alive() or any(c.is_alive() for c in clients))


def serve_http_phase(dev, card=""):
    """serve-http: ``ServingEngine`` over the serve phase's kind of model
    (LLaMA-7B width, HTTP_LAYERS layers, random NF4 weights, a rank-64 LoRA)
    behind ThreadingHTTPServer
    on 127.0.0.1, 16 concurrent clients; every answer checked, the launch
    counts exact from the engine's counted forwards, and each completion's
    tokens against a direct ``PagedBatcher`` with the same arguments up to
    the first near-tie."""
    import numpy as np
    import torch

    from qlora_tpu_torch.generate import generate
    from qlora_tpu_torch.generate.paged import PagedBatcher
    from qlora_tpu_torch.models import forward, init_params
    from qlora_tpu_torch.utils import FakeTokenizer

    t_phase = time.perf_counter()
    cfg = seven_b(HTTP_LAYERS)
    params = init_params(cfg, seed=7, device=dev)
    lora, lcfg = random_lora(cfg, dev, seed=8)
    # warm-up outside the counted run: allocator and cuBLAS handles
    generate(params, lora, torch.randint(3, 200, (4, 16)), torch.full((4,), 16), cfg, lcfg,
             max_new_tokens=2, eos_id=-1, device=dev)
    tok = FakeTokenizer()
    engine_kw = dict(slots=SERVE_PAGED["num_slots"], n_pages=SERVE_PAGED_PAGES,
                     page_size=PAGE, max_pages_per_seq=PPS,
                     prefill_buckets=SERVE_PAGED["prefill_buckets"],
                     admit_batch=SERVE_PAGED["admit_batch"], steps_per_dispatch=1,
                     temperature=0.0)
    traffic = http_traffic(SERVE_PAGED_SEED, HTTP_REQUESTS, HTTP_CHAT)
    traffic[-1][1]["temperature"] = 0.7          # the engine samples greedily: a 400
    refused = len(traffic) - 1
    run = http_engine_run(dev, cfg, params, lora, lcfg, tok, traffic, engine_kw)
    gc_cuda()
    results, st, counts, wall = run["results"], run["st"], run["counts"], run["wall"]
    L, n_lin = cfg.num_layers, 7 * cfg.num_layers

    if run["error"] is not None or run["alive"]:
        fail(f"serve-http: the engine thread failed ({run['error']!r}) or a thread hangs")
    if len(results) != HTTP_REQUESTS or results[refused]["status"] != 400:
        fail(f"serve-http: {len(results)} answers; the mismatched temperature got "
             f"{results.get(refused, {}).get('status')}")
    served = []
    for i, (path, body, ids) in enumerate(traffic[:refused]):
        r = results[i]
        if r["status"] != 200:
            fail(f"serve-http: request {i} got {r['status']}: {r['text'][:500]}")
        gen = run["generated"].get(tuple(ids))
        if gen is None or len(gen) > body["max_tokens"]:
            fail(f"serve-http: request {i} did not end within its max_tokens")
        if body["stream"]:
            events = [ln[6:] for ln in r["text"].splitlines() if ln.startswith("data: ")]
            if not events or events[-1] != "[DONE]":
                fail(f"serve-http: the stream of request {i} does not end in [DONE]")
        else:
            usage = json.loads(r["text"])["usage"]
            if (usage["completion_tokens"] > body["max_tokens"]
                    or usage["prompt_tokens"] != len(ids)):
                fail(f"serve-http: request {i}'s usage {usage}")
        served.append((ids, body["max_tokens"], gen, r, run["first"].get(tuple(ids))))
    want = expected_counts(qmm_nf4_fwd_dq=n_lin * (st["decode"] + st["prefill"]),
                           qmm_nf4_decode_dq=n_lin * st["decode"],    # 8 rows a decode forward
                           qmm_nf4_wgmma_dq=n_lin * st["prefill"],    # >= 128 rows a prefill
                           paged_decode_attention_cuda=L * st["decode"],
                           paged_decode_split=L * st["decode"])
    tokens = sum(len(g) for _, _, g, _, _ in served)
    ttft = sorted((f - r["sent"]) * 1e3 for _, _, _, r, f in served if f is not None)
    print(f"serve-http ({card}): {HTTP_REQUESTS} clients (1 refused with 400), {len(served)} "
          f"served, {tokens} tokens in {wall:.3f} s = {len(served) / wall:.2f} requests/s, "
          f"{tokens / wall:.1f} tok/s; time to first token median "
          f"{np.percentile(ttft, 50):.1f} ms, p90 {np.percentile(ttft, 90):.1f} ms (host clock, "
          f"from the client's send to the engine's first token; admission starts once the 15 are "
          f"in); {st['decode']} decode forwards, "
          f"{st['step_s'] / max(st['steps'], 1) * 1e3:.2f} ms a decode step, {st['prefill']} "
          f"prefills, admissions {st['admit_s']:.3f} s, {run['preemptions']} preemptions; "
          f"launches { {k: v for k, v in counts.items() if v} } (expected "
          f"{ {k: v for k, v in want.items() if v} })", flush=True)
    if counts != want:
        fail(f"serve-http launch counts {counts} != {want}")
    if run["preemptions"] < 1:
        fail("serve-http: no preemption; the pool is not small enough for this traffic")

    # the same prompts straight into a PagedBatcher with the engine's arguments,
    # submitted in the engine's arrival order (a request's uid decides which
    # sequence a preemption evicts) and admitted in the clients' order
    direct = PagedBatcher(params, lora, cfg, lcfg, num_slots=engine_kw["slots"],
                          n_pages=SERVE_PAGED_PAGES, page_size=PAGE, max_pages_per_seq=PPS,
                          prefill_buckets=engine_kw["prefill_buckets"], eos_id=tok.eos_token_id,
                          sparams=run["sparams"], admit_batch=engine_kw["admit_batch"], device=dev)
    st = instrument(direct)
    budget = {tuple(ids): n for ids, n, _, _, _ in served}
    took = {key: direct.submit(list(key), max_new_tokens=budget[key]) for key in run["arrival"]}
    mine = [took[tuple(ids)] for ids, _, _, _, _ in served]
    direct.queue = list(mine)
    t1 = time.perf_counter()
    direct.run_to_completion()
    torch.cuda.synchronize()
    direct_s = time.perf_counter() - t1
    direct_tokens = sum(len(r.generated) for r in mine)

    # near-ties of the direct run's tokens, teacher-forced without a cache
    equal, clear_upto, compared = 0, 0, 0
    for (ids, _, got, _, _), r in zip(served, mine):
        ref = r.generated
        seq = torch.tensor([ids + ref], device=dev)
        with torch.inference_mode():
            logits = forward(params, lora, seq, cfg, lcfg)[0][0, len(ids) - 1:-1].float()
        top2 = logits.topk(2, dim=-1).values
        ties = ((top2[:, 0] - top2[:, 1]) < NEAR_TIE).nonzero()
        upto = min(int(ties[0]) if len(ties) else len(ref), len(got))
        if got[:upto] != ref[:upto]:
            fail(f"serve-http: a completion differs from the direct PagedBatcher's before its "
                 f"first near-tie ({upto} of {len(ref)} tokens)")
        equal += got == ref
        clear_upto += upto
        compared += len(ref)
    print(f"serve-http: tokens against a direct PagedBatcher (same arguments, {direct_tokens} "
          f"tokens in {direct_s:.3f} s = {direct_tokens / direct_s:.1f} tok/s, "
          f"{st['step_s'] / max(st['steps'], 1) * 1e3:.2f} ms a decode step, admissions "
          f"{st['admit_s']:.3f} s, {direct.preemptions} preemptions): {equal} of {len(served)} "
          f"completions equal in "
          f"full; {clear_upto} of {compared} tokens before each one's first top-2 margin under "
          f"{NEAR_TIE}, all equal; phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    del direct, params, lora
    gc_cuda()
    return counts, dict(tok_s=tokens / wall, req_s=len(served) / wall, wall_s=wall,
                        ttft_ms=(float(np.percentile(ttft, 50)), float(np.percentile(ttft, 90))),
                        direct_tok_s=direct_tokens / direct_s, equal=equal)


def judge_questions():
    """The judge's questions from vicuna_questions.jsonl: JUDGE_CATEGORIES'
    first ones (coding and math, each with a reviewer of its own), then the
    first question of each of EXAMPLES_OTHER other categories, which fall
    back to the first reviewer."""
    from qlora_tpu_torch.eval.judge import load_jsonl

    rows = load_jsonl(str(ROOT / "eval" / "prompts" / "vicuna_questions.jsonl"))
    picked = []
    for cat, n in JUDGE_CATEGORIES:
        picked += [q for q in rows if q["category"] == cat][:n]
    others = []
    for q in rows:
        if q["category"] not in dict(JUDGE_CATEGORIES) and q["category"] not in others:
            others.append(q["category"])
            picked.append(q)
    return picked[:sum(n for _, n in JUDGE_CATEGORIES) + EXAMPLES_OTHER]


def start_endpoint(dev, cfg, params, lora, lcfg, tok, model_id):
    """``ServingEngine`` (JUDGE_ENGINE) behind ThreadingHTTPServer on
    127.0.0.1, its forwards counted by ``instrument`` and each admission's
    prompt length before and after the batcher's cut recorded."""
    import threading
    from http.server import ThreadingHTTPServer

    from qlora_tpu_torch.serve_openai import ServingEngine, make_handler

    engine = ServingEngine(params, lora, cfg, tok, lcfg=lcfg, model_id=model_id, device=dev,
                           **JUDGE_ENGINE)
    pb = engine.pb
    ep = dict(engine=engine, st=instrument(pb), admitted=[], usage=[])
    finish = pb._finish_admit

    def recorded_finish(slot, req, uid, L, tok_):
        ep["admitted"].append((len(req.prompt), L))
        finish(slot, req, uid, L, tok_)

    pb._finish_admit = recorded_finish
    ep["srv"] = srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(engine))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    ep["url"] = f"http://127.0.0.1:{srv.server_address[1]}"
    return ep


def endpoint_chat(ep, messages, max_tokens):
    """The reply of /v1/chat/completions.  Anything but a 200 answer ends the
    run here: the judge retries every exception, sleeping up to 100 s each
    time, and would hang the run instead of failing it."""
    import urllib.request

    req = urllib.request.Request(
        ep["url"] + "/v1/chat/completions",
        data=json.dumps({"messages": messages, "max_tokens": max_tokens}).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            status, body = r.status, json.loads(r.read())
    except Exception as e:  # noqa: BLE001 — SystemExit passes the judge's retry loop
        fail(f"examples: a chat request failed ({e!r})")
    if status != 200:
        fail(f"examples: a chat request got {status}")
    ep["usage"].append((max_tokens, body["usage"]))
    return body["choices"][0]["message"]["content"]


def endpoint_part(tag, ep, fn, cfg, card):
    """Run fn() against endpoint `ep`, the launch counts read around it and
    held exactly to the engine's counted forwards (serve-http's expectation:
    every decode forward's qmm on the NF4 decode kernel, every prefill's on
    the wgmma kernel, every paged decode on the split kernel), each request
    within its max_tokens, no prompt cut.  Returns (fn's result, counts,
    stats)."""
    import torch

    st, before, n_used, n_admitted = ep["st"], dict(ep["st"]), len(ep["usage"]), len(ep["admitted"])
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    dec, pre = st["decode"] - before["decode"], st["prefill"] - before["prefill"]
    L, n_lin = cfg.num_layers, 7 * cfg.num_layers
    want = expected_counts(qmm_nf4_fwd_dq=n_lin * (dec + pre), qmm_nf4_decode_dq=n_lin * dec,
                           qmm_nf4_wgmma_dq=n_lin * pre, paged_decode_attention_cuda=L * dec,
                           paged_decode_split=L * dec)
    usage = ep["usage"][n_used:]
    admitted = ep["admitted"][n_admitted:]
    tokens = sum(u["completion_tokens"] for _, u in usage)
    longest = max(u["prompt_tokens"] for _, u in usage)
    widest = max(st["prefill_rows"][len(st["prefill_rows"]) - pre:], default=0)
    print(f"examples {tag} ({card}): {len(usage)} requests in {wall:.3f} s = "
          f"{len(usage) / wall:.2f} requests/s, {tokens} tokens = {tokens / wall:.1f} tok/s; "
          f"prompts up to {longest} tokens, {len(admitted)} admissions, "
          f"{sum(a != b for a, b in admitted)} cut; {dec} decode forwards, {pre} prefills "
          f"({widest} rows at most); launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    if counts != want:
        fail(f"examples {tag}: launch counts {counts} != {want}")
    if st["verify"] != before["verify"] or ep["engine"].error is not None:
        fail(f"examples {tag}: a verify chunk ran or the engine failed ({ep['engine'].error!r})")
    if any(u["completion_tokens"] > n for n, u in usage):
        fail(f"examples {tag}: an answer exceeds its max_tokens")
    if any(a != b for a, b in admitted):
        fail(f"examples {tag}: the batcher cut a prompt ({admitted})")
    return out, counts, dict(wall_s=wall, requests=len(usage), tokens=tokens,
                             req_s=len(usage) / wall, tok_s=tokens / wall, longest=longest)


def judge_part(dev, cfg, params, lora, lcfg, card):
    """Baseline answers from the LoRA engine and from the base engine (the
    paper's adapter against its base), then the LoRA engine judging them in
    both modes; every row checked against ``gen_prompt`` and the parsers."""
    from qlora_tpu_torch.eval import generate_baseline_answers, run_judge
    from qlora_tpu_torch.eval.judge import (
        gen_prompt, load_jsonl, parse_score_pair, parse_three_class_score,
    )
    from qlora_tpu_torch.utils import FakeTokenizer

    tok = FakeTokenizer()
    banks = ROOT / "eval" / "prompts"
    questions = judge_questions()
    # random weights review in noise: the parsers' error log would fill the output
    logging.getLogger("qlora_tpu_torch.eval.judge").setLevel(logging.CRITICAL)
    qids = sorted(q["question_id"] for q in questions)
    reviewers = load_jsonl(str(banks / "reviewer.jsonl"))
    eps = {"lora": start_endpoint(dev, cfg, params, lora, lcfg, tok, "llama-7b-lora"),
           "base": start_endpoint(dev, cfg, params, None, lcfg, tok, "llama-7b")}
    total, stats, answers = collections.Counter(), {}, {}
    try:
        for name, ep in eps.items():
            ask = lambda text, n, ep=ep: endpoint_chat(ep, [{"role": "user", "content": text}], n)
            answers[name], counts, stats[f"baseline-{name}"] = endpoint_part(
                f"baseline-{name}", ep, lambda: generate_baseline_answers(
                    questions, ask, max_tokens=BASELINE_TOKENS, max_workers=JUDGE_WORKERS),
                cfg, card)
            total.update(counts)
            got = answers[name]
            if ([a["question_id"] for a in got] != qids
                    or any(a["text"] == "#ERROR#" for a in got)):
                fail(f"examples baseline-{name}: answers {got}")
        review = lambda s, u, n: endpoint_chat(
            eps["lora"], [{"role": "system", "content": s}, {"role": "user", "content": u}], n)
        by_id = {q["question_id"]: q for q in questions}
        a1 = {a["question_id"]: a["text"] for a in answers["lora"]}
        a2 = {a["question_id"]: a["text"] for a in answers["base"]}
        for mode, bank, parse in (
                ("threeclass", "vicuna_prompt_threeclass.jsonl", parse_three_class_score),
                ("relative", "vicuna_prompt_relative.jsonl", parse_score_pair)):
            prompts = load_jsonl(str(banks / bank))
            rows, counts, stats[f"judge-{mode}"] = endpoint_part(
                f"judge-{mode}", eps["lora"], lambda: run_judge(
                    questions, answers["lora"], answers["base"], reviewers, prompts, review,
                    mode=mode, max_tokens=JUDGE_TOKENS, max_workers=JUDGE_WORKERS), cfg, card)
            total.update(counts)
            if [r["question_id"] for r in rows] != qids:
                fail(f"examples judge-{mode}: review rows for {[r['question_id'] for r in rows]}")
            for r in rows:
                q = by_id[r["question_id"]]
                _, _, rid, pid = gen_prompt(reviewers, prompts, q["category"], q["text"],
                                            a1[q["question_id"]], a2[q["question_id"]])
                if ((r["reviewer_id"], r["prompt_id"]) != (rid, pid)
                        or r["category"] != q["category"]):
                    fail(f"examples judge-{mode}: row {r} routed other than gen_prompt's "
                         f"({rid}, {pid})")
                if repr(r["score"]) != repr(parse(r["review"])):
                    fail(f"examples judge-{mode}: score {r['score']} of review {r['review']!r}")
            routed = sorted({r["prompt_id"] for r in rows})
            scores = collections.Counter(repr(r["score"]) for r in rows)
            print(f"examples judge-{mode}: prompt ids {routed} routed, scores {dict(scores)}",
                  flush=True)
            if routed != [1, 2, 3]:
                fail(f"examples judge-{mode}: prompt ids {routed} routed, not all three")
    finally:
        for ep in eps.values():
            ep["srv"].shutdown()
            ep["srv"].server_close()
            ep["engine"].shutdown()
    return total, stats


@contextlib.contextmanager
def example_loads(modules, model, tok):
    """The examples' load helpers replaced: each hands out `tok`, and
    `model` (params, cfg) where one is given."""
    saved = [(m, m.load_model, m.load_tokenizer) for m in modules]
    try:
        for m in modules:
            if model is not None:
                m.load_model = lambda path, device: model
            m.load_tokenizer = lambda path: tok
        yield
    finally:
        for m, load_model, load_tokenizer in saved:
            m.load_model, m.load_tokenizer = load_model, load_tokenizer


# what each example's main may launch (all of it on the decode, wgmma and split kernels),
# and what it must
EXAMPLE_KERNELS = {"plain": ({"qmm_nf4_fwd_dq", "qmm_nf4_decode_dq", "qmm_nf4_wgmma_dq",
                              "decode_attention_cuda"}, None),
                   "int8": ({"qmm_nf4_fwd_dq", "qmm_nf4_wgmma_dq", "qmm_i8_direct",
                             "qmm_i8_direct_decode", "decode_attention_cuda"}, None),
                   "speculative": ({"qmm_nf4_fwd_dq", "qmm_nf4_decode_dq", "qmm_nf4_wgmma_dq",
                                    "decode_attention_cuda"}, {"decode_attention_cuda"}),
                   "paged": ({"qmm_nf4_fwd_dq", "qmm_nf4_decode_dq", "qmm_nf4_wgmma_dq",
                              "paged_decode_attention_cuda", "paged_decode_split"}, None)}


def check_example_counts(tag, kind, counts):
    """Every launch on the kernels EXAMPLE_KERNELS[kind] allows, each of
    them launched but the optional ones, and none off the decode, wgmma and
    split kernels."""
    allowed, optional = EXAMPLE_KERNELS[kind]
    ran = {k for k, v in counts.items() if v}
    print(f"examples {tag}: launches { {k: counts[k] for k in sorted(ran)} }", flush=True)
    if not allowed - (optional or set()) <= ran <= allowed:
        fail(f"examples {tag}: launched {sorted(ran)}, expected {sorted(allowed)}")
    if (counts["qmm_nf4_fwd_dq"] != counts["qmm_nf4_decode_dq"] + counts["qmm_nf4_wgmma_dq"]
            or counts["qmm_i8_direct"] != counts["qmm_i8_direct_decode"]
            or counts["paged_decode_attention_cuda"] != counts["paged_decode_split"]):
        fail(f"examples {tag}: a launch off the decode, wgmma and split kernels: {counts}")


def example_main(tag, kind, main, argv, total, stdin=""):
    """main(argv) in process with stdin replaced; its printed output.  Its
    launch counts, read around the call, pass ``check_example_counts`` and
    join `total`."""
    import io

    import torch

    out, stdin_was = io.StringIO(), sys.stdin
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    sys.stdin = io.StringIO(stdin)
    try:
        with contextlib.redirect_stdout(out):
            main(argv)
    finally:
        sys.stdin = stdin_was
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    print(f"examples {tag}: main in {wall:.2f} s", flush=True)
    check_example_counts(tag, kind, counts)
    total.update(counts)
    return out.getvalue()


def streamed(tok, stream):
    """What chat_demo prints for a token stream, and the reply's text."""
    printed, reply = "", []
    for step in stream:
        t = int(step[0])
        if t == tok.eos_token_id:
            break
        reply.append(t)
        printed += tok.decode(reply)[len(tok.decode(reply[:-1])):]
    return printed, tok.decode(reply)


def webhook_server():
    """A server that keeps every JSON body POSTed to it."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    hooked = []

    class Hook(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            hooked.append(json.loads(self.rfile.read(n)))
            self.send_response(200)
            self.end_headers()

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Hook)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}/", hooked


def web_chat(url, history, message):
    """The SSE events of one POST /chat."""
    import urllib.request

    req = urllib.request.Request(url + "/chat",
                                 json.dumps({"history": history, "message": message}).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        body = r.read().decode()
    return [json.loads(e[6:]) for e in body.split("\n\n") if e.startswith("data: ")]


def examples_part(dev, cfg, params, lora, lcfg, tmp, total):
    """The four examples through main(argv) on the phase's model, only their load
    helpers replaced (the weights built once, ShownTokenizer), each held bit
    for bit to the port's direct calls with the same seeds."""
    import threading

    import numpy as np
    import torch

    from qlora_tpu_torch.examples import chat_demo, guanaco_generate, serve_demo, web_demo
    from qlora_tpu_torch.generate import (
        SamplingParams, generate, generate_stream, generate_stream_speculative,
    )
    from qlora_tpu_torch.generate.paged import PagedBatcher
    from qlora_tpu_torch.utils.checkpoint import save_checkpoint
    from qlora_tpu_torch.utils.testing import ShownTokenizer

    tok = ShownTokenizer()
    eos = tok.eos_token_id
    sp = SamplingParams(do_sample=True, temperature=0.7, top_p=0.9)   # the examples' defaults
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)
    adapter = Path(tmp) / "adapter"
    ckpt = save_checkpoint(str(adapter), 1, lora)
    common = ["--model_path", "llama-7b", "--adapter_path", str(adapter)]
    with example_loads((guanaco_generate, chat_demo, serve_demo, web_demo), (params, cfg), tok):
        ids = [tok.bos_token_id] + tok.encode(
            guanaco_generate.PROMPT_TEMPLATE.format(user_question="Tell me about alpacas."))
        for impl in (None, "int8"):
            printed = example_main(f"guanaco_generate {impl or 'nf4'}", impl or "plain",
                                   guanaco_generate.main,
                                   common + ["--max_new_tokens", str(EXAMPLE_NEW), "--seed", "0"]
                                   + (["--decode_impl", impl] if impl else []), total)
            toks = generate(params, lora, torch.tensor([ids]), torch.tensor([len(ids)]), cfg,
                            lcfg, max_new_tokens=EXAMPLE_NEW, eos_id=eos, sparams=sp,
                            generator=gen(0), decode_impl=impl, device=dev)
            text = tok.decode([t for t in toks[0].tolist() if t != eos])
            if printed != f"loaded adapter from {ckpt}\n{text}\n":
                fail(f"examples guanaco_generate {impl}: printed {printed!r}, direct {text!r}")

        for draft in (0, CHAT_DRAFT):
            printed = example_main(
                f"chat_demo speculative={draft}", "speculative" if draft else "plain",
                chat_demo.main, common + ["--max_new_tokens", str(CHAT_NEW)]
                + (["--speculative", str(draft)] if draft else []), total,
                stdin="\n".join(CHAT_TURNS) + "\n\n")
            want, history = "Chat ready — empty line to quit.\n", []
            for user in CHAT_TURNS:
                history.append((user, ""))
                ids = [tok.bos_token_id] + tok.encode(chat_demo.build_prompt(history))
                kw = dict(max_new_tokens=CHAT_NEW, eos_id=eos, sparams=sp, generator=gen(0),
                          device=dev)
                x, n = torch.tensor([ids]), torch.tensor([len(ids)])
                stream = (generate_stream_speculative(params, lora, x, n, cfg, lcfg,
                                                      draft_len=draft, **kw) if draft
                          else generate_stream(params, lora, x, n, cfg, lcfg, **kw))
                text, reply = streamed(tok, stream)
                want += f"you> bot> {text}\n"
                history[-1] = (user, reply)
            if printed != want + "you> ":
                fail(f"examples chat_demo speculative={draft}: printed {printed!r}, "
                     f"direct {want!r}")

        rng = np.random.default_rng(12)
        words = " ".join(rng.choice(DATA_WORDS, size=2000))
        prompts = [f"request {i}: {words[int(s):int(s) + int(n)].strip()}" for i, (s, n) in enumerate(
            zip(rng.integers(0, 8000, SERVE_DEMO_PROMPTS),
                rng.integers(180, 480, SERVE_DEMO_PROMPTS)))]
        (Path(tmp) / "prompts.txt").write_text("\n".join(prompts) + "\n")
        printed = example_main(
            "serve_demo", "paged", serve_demo.main,
            common + ["--prompts", str(Path(tmp) / "prompts.txt")]
            + [f"--{k}={v}" for k, v in SERVE_DEMO.items()], total)
        direct = PagedBatcher(params, lora, cfg, lcfg, num_slots=SERVE_DEMO["num_slots"],
                              n_pages=SERVE_DEMO["n_pages"], page_size=16, max_pages_per_seq=64,
                              eos_id=eos, sparams=sp, device=dev)
        reqs = {direct.submit([tok.bos_token_id] + tok.encode(p),
                              max_new_tokens=SERVE_DEMO["max_new_tokens"]).uid: p for p in prompts}
        done = sorted(direct.run_to_completion(), key=lambda r: r.uid)
        want = "".join(f"\n=== {reqs[r.uid]} ===\n{tok.decode(r.generated)}\n" for r in done)
        print(f"examples serve_demo: {len(done)} requests, the direct batcher preempted "
              f"{direct.preemptions} times", flush=True)
        if printed != want or direct.preemptions < 1 or len(done) != SERVE_DEMO_PROMPTS:
            fail(f"examples serve_demo: printed {printed!r}, direct {want!r} "
                 f"({direct.preemptions} preemptions)")
        del direct

        hook_srv, webhook, hooked = webhook_server()
        srv = web_demo.make_server(web_demo.parse_args(
            common + ["--port", "0", "--max_new_tokens", str(WEB_NEW), "--log_webhook", webhook]))
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            history = []
            torch.cuda.synchronize()
            reset_counts()
            for message in CHAT_TURNS:
                events = web_chat(url, history, message)
                reply = "".join(e["delta"] for e in events if "delta" in e)
                if events[-1] != {"done": True} or hooked[-1:] != [
                        {"history": history, "turn": [message, reply]}]:
                    fail(f"examples web_demo: events {events}, webhook {hooked}")
                history = history + [[message, reply]]
            torch.cuda.synchronize()
            counts = read_counts()
            for i, message in enumerate(CHAT_TURNS):
                direct = "".join(srv.engine.stream_reply([tuple(t) for t in history[:i]], message))
                if direct != history[i][1]:
                    fail(f"examples web_demo: streamed {history[i][1]!r}, direct {direct!r}")
        finally:
            for s in (srv, hook_srv):
                s.shutdown()
                s.server_close()
        print(f"examples web_demo: {len(hooked)} turns streamed and logged", flush=True)
        if len(hooked) != len(CHAT_TURNS):
            fail(f"examples web_demo: {len(hooked)} turns logged")
        check_example_counts("web_demo", "plain", counts)
        total.update(counts)


def converter_part(dev, tmp, total, card):
    """``python3 -m qlora_tpu_torch.scripts.convert_checkpoint`` on a
    HF_LAYERS-layer LLaMA-7B-width HF checkpoint (train-data's writer): it
    exits 0 and every tensor of its store, and its config, equal
    ``save_quantized(load_hf_model(src))`` run here.  Then guanaco_generate
    on the HF directory itself, only the tokenizer replaced, against a
    direct ``generate()`` on the weights imported here."""
    import re

    import torch

    from qlora_tpu_torch.examples import guanaco_generate
    from qlora_tpu_torch.generate import SamplingParams, generate
    from qlora_tpu_torch.lora import LoraConfig
    from qlora_tpu_torch.utils import load_hf_model, save_quantized
    from qlora_tpu_torch.utils.checkpoint import read_arrays
    from qlora_tpu_torch.utils.quantized_store import CONFIG_FILE, MODEL_FILE
    from qlora_tpu_torch.utils.testing import ShownTokenizer

    src, dst, ref = Path(tmp) / "hf", Path(tmp) / "converted", Path(tmp) / "in_process"
    cfg = write_hf_checkpoint(src, HF_LAYERS, 73)
    nbytes = (src / "model.safetensors").stat().st_size
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "qlora_tpu_torch.scripts.convert_checkpoint",
                        "--src", str(src), "--dst", str(dst)], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        fail(f"examples converter: exit {r.returncode}: {r.stdout[-2000:]} {r.stderr[-2000:]}")
    said = re.search(r"quantized in ([0-9.]+)s", r.stdout)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, got_cfg = load_hf_model(str(src), device=dev)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    save_quantized(str(ref), params, got_cfg)
    save_s = time.perf_counter() - t0
    a, b = read_arrays(str(dst / MODEL_FILE)), read_arrays(str(ref / MODEL_FILE))
    differ = sorted(k for k in set(a) | set(b) if k not in a or k not in b
                    or not same_bytes(a[k], b[k]))
    same_config = (dst / CONFIG_FILE).read_text() == (ref / CONFIG_FILE).read_text()
    print(f"examples converter ({card}): {HF_LAYERS} layers at LLaMA-7B width, "
          f"{nbytes / 1e9:.3f} GB of bf16 safetensors; python3 -m ...convert_checkpoint "
          f"{wall:.2f} s wall (process start, CUDA and the build included; it printed "
          f"'quantized in {said.group(1) if said else '?'}s'); in process: load_hf_model "
          f"{import_s:.3f} s = {import_s / HF_LAYERS:.3f} s a layer (embedding and lm_head "
          f"included), save_quantized {save_s:.3f} s; {len(a)} tensors, {len(differ)} differ, "
          f"config {'equal' if same_config else 'differs'}", flush=True)
    if differ or not same_config or got_cfg != cfg or not said:
        fail(f"examples converter: tensors {differ[:10]} differ from the in-process store, "
             f"config equal {same_config}")

    tok = ShownTokenizer()
    with example_loads((guanaco_generate,), None, tok):
        printed = example_main("guanaco_generate on the HF directory", "plain",
                               guanaco_generate.main,
                               ["--model_path", str(src), "--max_new_tokens", "16", "--seed", "1"],
                               total)
    ids = [tok.bos_token_id] + tok.encode(
        guanaco_generate.PROMPT_TEMPLATE.format(user_question="Tell me about alpacas."))
    toks = generate(params, None, torch.tensor([ids]), torch.tensor([len(ids)]), cfg,
                    LoraConfig(), max_new_tokens=16, eos_id=tok.eos_token_id,
                    sparams=SamplingParams(do_sample=True, temperature=0.7, top_p=0.9),
                    generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    text = tok.decode([t for t in toks[0].tolist() if t != tok.eos_token_id])
    if printed != text + "\n":
        fail(f"examples converter: guanaco_generate printed {printed!r}, direct {text!r}")
    return dict(wall_s=wall, import_s=import_s, save_s=save_s,
                import_s_per_layer=import_s / HF_LAYERS)


def examples_phase(dev, card=""):
    """examples: the judge and baseline through the endpoint, the four
    examples' main(argv), and the checkpoint converter, on one LLaMA-7B
    width model (EXAMPLES_LAYERS layers, random double-quant NF4, a rank-64
    LoRA with nonzero B).  Returns (the launch counts over its checked runs,
    stats)."""
    import tempfile

    import torch

    from qlora_tpu_torch.generate import generate
    from qlora_tpu_torch.models import init_params

    t_phase = time.perf_counter()
    cfg = seven_b(EXAMPLES_LAYERS)
    params = init_params(cfg, seed=9, device=dev)
    lora, lcfg = random_lora(cfg, dev, seed=10)
    # warm-up outside the counted runs: allocator and cuBLAS handles
    generate(params, lora, torch.randint(3, 200, (4, 16)), torch.full((4,), 16), cfg, lcfg,
             max_new_tokens=2, eos_id=-1, device=dev)
    total, stats = judge_part(dev, cfg, params, lora, lcfg, card)
    gc_cuda()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        examples_part(dev, cfg, params, lora, lcfg, tmp, total)
        stats["examples_s"] = time.perf_counter() - t0
        del params, lora
        gc_cuda()
        stats["converter"] = converter_part(dev, tmp, total, card)
    stats["phase_s"] = time.perf_counter() - t_phase
    print(f"examples ({card}): phase {stats['phase_s']:.1f} s (the four examples "
          f"{stats['examples_s']:.1f} s); launches over its checked runs "
          f"{ {k: v for k, v in total.items() if v} }", flush=True)
    gc_cuda()
    return dict(total), stats


def tp_qmm_phase(dev, results):
    """The NF4 forward at M = 4 on a rank's shard shapes at tp 4 (the tp
    phase's decode launches: wq/wk/wv and w_gate/w_up column shards, the wo
    and w_down K-chunks), in CUDA graphs beside the tile kernel (the
    "before"), the plain version and torch.matmul, with the decode kernel's
    bit-for-bit checks."""
    import torch

    from qlora_tpu_torch.ops import qmatmul, qmatmul_plain, qmm_nf4_fwd_dq
    from qlora_tpu_torch.quant import dequantize, quantize, quantize_k_sharded

    _, tile, _ = nf4_kernels()
    g = torch.Generator(device=dev).manual_seed(4321)
    M = 4
    for K, N in TP_QMM_SHAPES:
        w = torch.randn(K, N, device=dev, generator=g) * K ** -0.5
        qt = quantize(w)
        w_bf16 = dequantize(qt, torch.bfloat16)
        del w
        qts = [qt] + [dataclasses.replace(qt, packed=qt.packed.clone(), absmax=qt.absmax.clone())
                      for _ in range(copies_past_l2(qt.nbytes) - 1)]
        ws = [w_bf16] + [w_bf16.clone() for _ in range(copies_past_l2(w_bf16.nbytes) - 1)]
        x = torch.randn(M, K, device=dev, generator=g).to(torch.bfloat16)
        y, ref = qmm_nf4_fwd_dq(x, qt), qmatmul_plain(x, qt)
        torch.cuda.synchronize()
        diff = (y.float() - ref.float()).abs()
        if (diff - QMM_TOL[1] * ref.float().abs()).max().item() > QMM_TOL[0]:
            fail(f"qmm_nf4_fwd_dq M={M} K={K} N={N} differs from its plain version by "
                 f"{diff.max().item()}")
        ms = graph_ms(lambda i: qmm_nf4_fwd_dq(x, qts[i % len(qts)]), 200)
        tile_ms = graph_ms(lambda i: tile(x, qts[i % len(qts)]), 50)
        lib_ms = graph_ms(lambda i: torch.matmul(x, ws[i % len(ws)]), 200)
        plain_ms = cuda_ms(lambda i: qmatmul_plain(x, qts[i % len(qts)]), 20)
        record(results, "qmm_nf4_fwd_dq", f"M={M} K={K} N={N} (tp shard)", diff.max().item(),
               f"tol {QMM_TOL[0]} + {QMM_TOL[1]}*|ref|", ms, plain_ms, lib_ms,
               qmm_bound(M, K, N, True), tile_ms=tile_ms)
        decode_checks("qmm_nf4_fwd_dq (tp shard)", qmm_nf4_fwd_dq, x, qt, w_bf16)
    mesh_qmm_timings(dev, g, results, tile)
    # a whole K-sharded tensor (the storage a JAX-made row-parallel tree
    # carries) on the card: one decode launch a chunk, against the global
    # view's plain version
    K, N = TP * TP_QMM_SHAPES[1][1], TP_QMM_SHAPES[0][0]
    w = torch.randn(K, N, device=dev, generator=g) * K ** -0.5
    qt = quantize_k_sharded(w, TP)
    del w
    x = torch.randn(M, K, device=dev, generator=g).to(torch.bfloat16)
    reset_counts()
    y = qmatmul(x, qt)
    counts = read_counts()
    ref = qmatmul_plain(x, qt)
    torch.cuda.synchronize()
    diff = (y.float() - ref.float()).abs()
    want = expected_counts(qmm_nf4_fwd_dq=TP, qmm_nf4_decode_dq=TP)
    if counts != want or (diff - 2 * QMM_TOL[1] * ref.float().abs()).max().item() > \
            2 * QMM_TOL[0]:
        fail(f"qmatmul of a K-sharded tensor (K={K} N={N}, {TP} chunks): launches {counts} "
             f"!= {want}, or {diff.max().item()} from its plain version")
    print(f"qmatmul K-sharded global view M={M} K={K} N={N}: {TP} chunks, one decode launch "
          f"each, max|err| {diff.max().item():.4g} (tol 2x({QMM_TOL[0]} + "
          f"{QMM_TOL[1]}*|ref|): each chunk's bf16 partial rounded once more)", flush=True)


def mesh_qmm_timings(dev, g, results, tile):
    """The NF4 forward and dx at a train-mesh rank's shard shapes
    (MESH_QMM_SHAPES) at M = MESH_M rows, each launch on its wgmma kernel,
    against the plain version within QMM_TOL, timed with CUDA events beside
    the tile kernels (the "befores"), the plain versions and torch.matmul on
    the dequantized weight."""
    import torch

    from qlora_tpu_torch.ops import (
        qmatmul_bwd_plain, qmatmul_plain, qmm_nf4_bwd, qmm_nf4_fwd_dq,
    )
    from qlora_tpu_torch.quant import dequantize, quantize

    bwd_tile = nf4_kernels()[2]
    M = MESH_M
    for K, N in MESH_QMM_SHAPES:
        w = torch.randn(K, N, device=dev, generator=g) * K ** -0.5
        qt = quantize(w)
        w_bf16 = dequantize(qt, torch.bfloat16)
        del w
        qts = [qt] + [dataclasses.replace(qt, packed=qt.packed.clone(), absmax=qt.absmax.clone())
                      for _ in range(copies_past_l2(qt.nbytes) - 1)]
        ws = [w_bf16] + [w_bf16.clone() for _ in range(copies_past_l2(w_bf16.nbytes) - 1)]
        x = torch.randn(M, K, device=dev, generator=g).to(torch.bfloat16)
        gr = torch.randn(M, N, device=dev, generator=g).to(torch.bfloat16)
        for name, wrapper, plain, tile_fn, a, lib in (
                ("qmm_nf4_fwd_dq", qmm_nf4_fwd_dq, qmatmul_plain, tile, x,
                 lambda i: torch.matmul(x, ws[i % len(ws)])),
                ("qmm_nf4_bwd", qmm_nf4_bwd, qmatmul_bwd_plain, bwd_tile, gr,
                 lambda i: torch.matmul(gr, ws[i % len(ws)].T))):
            before = wrapper.wgmma_launches
            y, ref = wrapper(a, qt), plain(a, qt)
            torch.cuda.synchronize()
            if wrapper.wgmma_launches != before + 1:
                fail(f"{name} M={M} K={K} N={N} (mesh shard) did not take its wgmma kernel")
            diff = (y.float() - ref.float()).abs()
            if (diff - QMM_TOL[1] * ref.float().abs()).max().item() > QMM_TOL[0]:
                fail(f"{name} M={M} K={K} N={N} (mesh shard) differs from its plain version by "
                     f"{diff.max().item()}")
            ms = cuda_ms(lambda i: wrapper(a, qts[i % len(qts)]), 20)
            tile_ms = cuda_ms(lambda i: tile_fn(a, qts[i % len(qts)]), 5)
            plain_ms = cuda_ms(lambda i: plain(a, qts[i % len(qts)]), 3)
            record(results, name, f"M={M} K={K} N={N} (mesh shard)", diff.max().item(),
                   f"tol {QMM_TOL[0]} + {QMM_TOL[1]}*|ref|", ms, plain_ms, cuda_ms(lib, 20),
                   qmm_bound(M, K, N, True), tile_ms=tile_ms)
        wgmma_checks("qmm_nf4_fwd_dq (mesh shard)", qmm_nf4_fwd_dq, x, qt, w_bf16)
        wgmma_checks("qmm_nf4_bwd (mesh shard)", qmm_nf4_bwd, gr, qt, w_bf16, bwd=True)


def pad_mlp(params, lora, cfg, multiple):
    """The MLP's intermediate dimension padded to a multiple of `multiple`,
    as ``load_hf_model(pad_intermediate_to=...)`` pads a checkpoint: zero
    columns of w_gate and w_up, zero rows of w_down, each quantized again
    (NF4, double quant); zero columns of their LoRA B, zero rows of w_down's
    A.  The model computes the same function.  The trees change in place;
    returns the padded config."""
    import torch
    import torch.nn.functional as F

    from qlora_tpu_torch.models.layers import QLinear
    from qlora_tpu_torch.quant import dequantize, quantize

    pad = -cfg.intermediate_size % multiple
    for block, layer in zip(params["blocks"], lora):
        for name, where in (("w_gate", (0, pad)), ("w_up", (0, pad)), ("w_down", (0, 0, 0, pad))):
            w = F.pad(dequantize(block[name].qt, torch.float32), where)
            block[name] = QLinear(qt=quantize(w), bias=block[name].bias)
            del w
        for name in ("w_gate", "w_up"):
            layer[name]["b"] = F.pad(layer[name]["b"], (0, pad))
        layer["w_down"]["a"] = F.pad(layer["w_down"]["a"], (0, 0, 0, pad))
    return dataclasses.replace(cfg, intermediate_size=cfg.intermediate_size + pad)


def tp_model(dev):
    """The tp phase's model on `dev`: LLaMA-7B width, TP_LAYERS layers from
    serve's seeds, a rank-64 LoRA with nonzero B, the MLP padded for 4 ranks;
    (params, lora, cfg, lcfg).  The parent builds it and cuts every rank's shard from it."""
    from qlora_tpu_torch.models import init_params

    cfg = seven_b(TP_LAYERS)
    params = init_params(cfg, seed=7, device=dev)
    lora, lcfg = random_lora(cfg, dev, seed=8)
    return params, lora, pad_mlp(params, lora, cfg, TP_PAD), lcfg


def tp_rank(mesh, cfg, lcfg, traffic, forced, store):
    """One rank of the tp phase: its shard (cut by the parent, read from
    `store`) onto its device, then run 1 (exact, the whole traffic), the
    first decode step teacher-forced over a contiguous cache, run 2 (int8
    decode and w8a8 prefill) and its one-step logits against the exact
    path's on one cache, run 3 (speculation), and examples/serve_tp's rank
    function; each run's tokens, admissions, disagreements and launch
    counts on this rank."""
    import os

    import torch

    from qlora_tpu_torch.examples.serve_tp import serve_rank
    from qlora_tpu_torch.generate.paged import PagedBatcher
    from qlora_tpu_torch.models.transformer import init_cache
    from qlora_tpu_torch.parallel import make_tp_forward_fn, rank_shards, shard_tp_cache

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // TP))   # the ranks share the host
    dev = mesh.device
    out = dict(device=str(dev), backend=mesh.backend, rank=mesh.rank, entered=time.time())
    t0 = time.perf_counter()
    params, lora = torch.load(os.path.join(store, f"rank{mesh.rank}.pt"), weights_only=False)
    params, lora = rank_shards(params, lora, mesh)
    torch.cuda.synchronize(dev)
    out["load_s"] = time.perf_counter() - t0
    out["shard_gib"] = torch.cuda.memory_allocated(dev) / 2 ** 30

    def engine_run(reqs, **kw):
        t0 = time.perf_counter()
        pb = PagedBatcher(params, lora, cfg, lcfg, n_pages=TP_PAGES, tp_mesh=mesh,
                          **{**TP_ENGINE, **kw})
        built_s = time.perf_counter() - t0
        st = instrument(pb)
        took = [pb.submit(p, max_new_tokens=n) for p, n in reqs]
        torch.cuda.synchronize(dev)
        mesh.barrier()
        reset_counts()
        mesh.disagreements = 0
        t0 = time.perf_counter()
        pb.run_to_completion()
        torch.cuda.synchronize(dev)
        run = dict(tokens=[r.generated for r in took], counts=read_counts(),
                   s=time.perf_counter() - t0, decode=st["decode"], verify=st["verify"],
                   prefill=st["prefill"], steps=st["steps"], preemptions=pb.preemptions,
                   admissions=[[(n, L) for uid, n, L in pb.admission_log if uid == r.uid]
                               for r in took],
                   disagreements=mesh.disagreements,
                   recycled=pb.pool.n_free == TP_PAGES - 1 and not pb.pool.tables,
                   pool_heads=int(pb.pool.k_pages[0].shape[1]),
                   steps_per_dispatch=pb.steps_per_dispatch, built_s=built_s)
        if kw.get("spec_draft_len"):
            run["spec"] = (pb.spec_tokens, pb.spec_chunks)
        return pb, run

    def step_logits(p, lo, impl=None, cache=None):
        """Prefill the forced prompt into a contiguous cache of this rank's
        heads (or take `cache`), then decode the forced token: (the
        prefill's last logits, the step's logits, the cache before the step)."""
        fn = make_tp_forward_fn(cfg, lcfg, mesh, impl=impl)
        ids, tok = forced
        last = None
        if cache is None:
            cache = shard_tp_cache(init_cache(cfg, 1, len(ids) + 2, device=dev), mesh)
            logits, cache = fn(p, lo, torch.tensor([ids], device=dev), cache)
            last = logits[0, -1].cpu()
        before = {k: [t.clone() for t in v] if isinstance(v, list) else v.clone()
                  for k, v in cache.items()}
        logits, _ = fn(p, lo, torch.tensor([[tok]], device=dev), cache)
        return last, logits[0, 0].cpu(), before

    with torch.inference_mode():
        pb, out["run1"] = engine_run(traffic)
        last, step, _ = step_logits(pb.params, pb.lora)
        out["first"] = (last.numpy(), step.numpy())
        del pb
        torch.cuda.empty_cache()
        small = [(p, TP_SMALL_NEW) for p, _ in traffic[:TP_SMALL]]
        pb, out["run2"] = engine_run(small, decode_impl="int8", prefill_impl="w8a8")
        _, exact, cache = step_logits(pb.params, pb.lora)
        _, int8, _ = step_logits(pb.decode_params, pb.lora, impl="w8a8", cache=cache)
        out["run2"]["int8_of_exact"] = ((int8 - exact).abs().max() / exact.abs().max()).item()
        del pb, cache
        torch.cuda.empty_cache()
        pb, out["run3"] = engine_run(small, spec_draft_len=SPEC_DRAFT)
        del pb
        torch.cuda.empty_cache()
        torch.cuda.synchronize(dev)
        mesh.barrier()
        reset_counts()
        mesh.disagreements = 0
        t0 = time.perf_counter()
        toks = serve_rank(mesh, params, cfg, traffic[0][0], TP_SERVE_NEW, -1, lora=lora,
                          lcfg=lcfg)
        torch.cuda.synchronize(dev)
        out["serve_tp"] = dict(tokens=toks, counts=read_counts(), s=time.perf_counter() - t0,
                               disagreements=mesh.disagreements,
                               admissions=[[(0, len(traffic[0][0]))]])
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    return out


def tp_shortfalls(params, lora, cfg, lcfg, dev, prompts, tokens, admissions):
    """Every token an engine emitted held against the single card's
    teacher-forced logits (no cache) over the context the engine decoded it
    from: the prompt, or after a preemption the last L of prompt + generated
    that its re-admission prefilled (``admission_log``).  Returns, over every
    token, (max(logits) - logits[token], max |logits|, the same shortfall of
    the token after it in the vocabulary: a control that the check can
    fail), as flat numpy arrays."""
    import numpy as np
    import torch

    from qlora_tpu_torch.models.transformer import forward

    short, scale, shifted = [], [], []
    with torch.inference_mode():
        for p, g, adm in zip(prompts, tokens, admissions):
            for k, (n, L) in enumerate(adm):
                end = adm[k + 1][0] if k + 1 < len(adm) else len(g)
                ctx = (list(p) + list(g[:n]))[-L:]
                logits = forward(params, lora, torch.tensor([ctx + list(g[n:end])], device=dev),
                                 cfg, lcfg)[0][0, len(ctx) - 1:-1].float()
                tok = torch.tensor(g[n:end], device=dev)[:, None]
                best = logits.max(-1).values
                short.append((best - logits.gather(1, tok)[:, 0]).cpu().numpy())
                scale.append(logits.abs().max(-1).values.cpu().numpy())
                shifted.append((best - logits.gather(1, (tok + 1) % cfg.vocab_size)[:, 0])
                               .cpu().numpy())
    return np.concatenate(short), np.concatenate(scale), np.concatenate(shifted)


def tp_phase(dev, card=""):
    """tp: tensor-parallel serving at LLaMA-7B full width (TP_LAYERS layers),
    four ranks.  On one card they share it over gloo (NCCL refuses two ranks on
    one device: this shows shard shapes, storage, collectives and control
    flow, not tensor-parallel speed); with four cards, NCCL a card a rank.
    Random double-quant NF4 weights from serve's seed, its MLP padded to
    whole K-chunks (``pad_mlp``), a rank-64 LoRA with nonzero B, built once
    in the parent.  Before the ranks start: the single-card
    ``PagedBatcher`` on the traffic (the reference), each request's top-2
    margins teacher-forced without a cache, the first decode step's logits
    over a contiguous cache, and every rank's shard cut in the parent
    (``cut_rank_shards``: a row-parallel linear quantized as the rank's
    K-chunk alone) and written to a file of its own, so that a rank reads
    only its shard.  Checks: every rank's tokens equal and no rank's own
    tokens ever differing from rank 0's (``TPMesh.same``); every token of
    runs 1 and 3 and serve_tp within TP_LOGIT_TOL of the best under the
    single card's teacher-forced logits over the context the engine held
    (run 2's within twice TP_INT8_BAND of the largest |logit|), while the
    next token in the vocabulary falls short of both; run 1's tokens equal
    the single card's up to each request's first top-2 margin under
    TP_NEAR_TIE (run 3's and serve_tp's likewise), the first step's logits
    within TP_LOGIT_TOL, run 2's one-step logits within TP_INT8_BAND of the
    exact path's largest |logit|, pools recycled and of KVH/tp heads, launch
    counts exact on each rank.  Returns (rank 0's launch counts over its
    checked runs, stats)."""
    import os
    import tempfile

    import torch

    from qlora_tpu_torch.generate.paged import PagedBatcher
    from qlora_tpu_torch.models import init_cache
    from qlora_tpu_torch.models.transformer import forward
    from qlora_tpu_torch.parallel import cut_rank_shards, run_ranks

    import numpy as np

    t_phase = time.perf_counter()
    four = torch.cuda.device_count() >= TP
    backend, devices = ("nccl", [f"cuda:{r}" for r in range(TP)]) if four else \
        ("gloo", ["cuda:0" if dev.type == "cuda" else str(dev)] * TP)
    params, lora, cfg, lcfg = tp_model(dev)
    traffic = [(p, 32 + n % 17) for p, n in paged_traffic(cfg.vocab_size, TP_SEED, TP_REQUESTS)]
    L, n_lin = cfg.num_layers, 7 * cfg.num_layers

    # the single card, the reference
    with torch.inference_mode():
        ref = PagedBatcher(params, lora, cfg, lcfg, n_pages=TP_PAGES, device=dev, **TP_ENGINE)
        took = [ref.submit(p, max_new_tokens=n) for p, n in traffic]
        ref.run_to_completion()
        ref_toks = [r.generated for r in took]
        if ref.preemptions < 1:
            fail("tp: the single card's run did not preempt; the pool is too large")
        ref_preempt = ref.preemptions
        del ref
        ties = []
        for (p, _), toks in zip(traffic, ref_toks):
            logits = forward(params, lora, torch.tensor([p + toks], device=dev), cfg,
                             lcfg)[0][0, len(p) - 1:-1].float()
            top2 = logits.topk(2, dim=-1).values
            tie = ((top2[:, 0] - top2[:, 1]) < TP_NEAR_TIE).nonzero()
            ties.append(int(tie[0]) if len(tie) else len(toks))
        forced = (traffic[0][0], ref_toks[0][0])
        cache = init_cache(cfg, 1, len(forced[0]) + 2, device=dev)
        last, cache = forward(params, lora, torch.tensor([forced[0]], device=dev), cfg, lcfg,
                              cache=cache)
        step, _ = forward(params, lora, torch.tensor([[forced[1]]], device=dev), cfg, lcfg,
                          cache=cache)
        card_first = (last[0, -1].float().cpu().numpy(), step[0, 0].float().cpu().numpy())
        del cache, last, step
    torch.cuda.synchronize()
    gc_cuda()
    print(f"tp: {TP} ranks over {backend}, rank devices {devices}; LLaMA-7B {L} layers, "
          f"intermediate padded to {cfg.intermediate_size}; the single card's reference "
          f"{sum(map(len, ref_toks))} tokens, {ref_preempt} preemptions, near-ties at "
          f"{ties} of {[len(t) for t in ref_toks]} tokens", flush=True)

    # a shard reaches its rank through a file: ``run_ranks(per_rank=...)``
    # would pass 1.2 GiB a rank through shared memory, whose size on the
    # machine is not known
    with tempfile.TemporaryDirectory() as store:
        t_cut = time.perf_counter()
        with torch.inference_mode():
            for r, shard in enumerate(cut_rank_shards(params, lora, TP, device="cpu")):
                torch.save(shard, os.path.join(store, f"rank{r}.pt"))
                del shard
        cut_s = time.perf_counter() - t_cut
        shard_files = [os.path.getsize(os.path.join(store, f"rank{r}.pt")) / 2 ** 30
                       for r in range(TP)]
        gc_cuda()
        t_ranks, spawned = time.perf_counter(), time.time()
        ranks = run_ranks(tp_rank, TP, cfg, lcfg, traffic, forced, store, backend=backend,
                          devices=devices, store_dir=store, timeout_s=900)
    ranks_s = time.perf_counter() - t_ranks
    print(f"tp: backend {ranks[0]['backend']}; " + ", ".join(
        f"rank {r['rank']} on {r['device']}" for r in ranks), flush=True)

    def agree(tag, got, want, upto):
        """(tokens compared, tokens in all): each got[i] equals want[i] up
        to request i's first near-tie."""
        upto = [min(u, len(g), len(w)) for g, w, u in zip(got, want, upto)]
        for i, (g, w, u) in enumerate(zip(got, want, upto)):
            if g[:u] != w[:u]:
                fail(f"tp {tag}: request {i} differs before its first near-tie ({u} tokens)")
        return sum(upto), sum(min(len(g), len(w)) for g, w in zip(got, want))

    for tag in ("run1", "run2", "run3", "serve_tp"):
        if any(r[tag]["tokens"] != ranks[0][tag]["tokens"] for r in ranks[1:]):
            fail(f"tp {tag}: the ranks' tokens differ")
        if any(r[tag]["disagreements"] for r in ranks):
            fail(f"tp {tag}: a rank's own tokens differed from rank 0's "
                 f"{[r[tag]['disagreements'] for r in ranks]} times")
    r0 = ranks[0]
    small = [(p, TP_SMALL_NEW) for p, _ in traffic[:TP_SMALL]]
    for tag, reqs in (("run1", traffic), ("run2", small), ("run3", small)):
        run = r0[tag]
        bad = [i for i, (t, (_, n)) in enumerate(zip(run["tokens"], reqs))
               if len(t) != n or not all(0 <= x < cfg.vocab_size for x in t)]
        if bad or not all(r[tag]["recycled"] for r in ranks):
            fail(f"tp {tag}: requests {bad} not at their budget, or a pool not recycled")
        if run["pool_heads"] != cfg.num_kv_heads // TP or run["steps_per_dispatch"] != 1:
            fail(f"tp {tag}: pools of {run['pool_heads']} heads, {run['steps_per_dispatch']} "
                 "steps a dispatch")
    if r0["run1"]["preemptions"] < 1:
        fail("tp run1: no preemption")

    # every emitted token against the single card's teacher-forced logits
    near = {}
    for tag, reqs in (("run1", traffic), ("run2", small), ("run3", small),
                      ("serve_tp", traffic[:1])):
        toks = [r0[tag]["tokens"]] if tag == "serve_tp" else r0[tag]["tokens"]
        short, scale, shifted = tp_shortfalls(params, lora, cfg, lcfg, dev,
                                              [p for p, _ in reqs], toks, r0[tag]["admissions"])
        tol = 2 * TP_INT8_BAND * scale if tag == "run2" else np.full_like(scale, TP_LOGIT_TOL)
        near[tag] = (len(short), float(short.max()), int((short > 0).sum()),
                     float(np.median(shifted)), float(tol.max()))
        if (short > tol).any() or np.median(shifted) <= tol.max():
            fail(f"tp {tag}: {int((short > tol).sum())} of {len(short)} tokens fall more than "
                 f"the tolerance (largest {tol.max():.4g}) short of the single card's best "
                 f"teacher-forced logit (worst {short.max():.4g}), or the control's median "
                 f"{np.median(shifted):.4g} does not exceed it")
    del params, lora
    gc_cuda()

    clear1 = agree("run1", r0["run1"]["tokens"], ref_toks, ties)
    clear3 = agree("run3", r0["run3"]["tokens"], r0["run1"]["tokens"][:TP_SMALL], ties)
    clear_s = agree("serve_tp", [r0["serve_tp"]["tokens"]], [r0["run1"]["tokens"][0]], ties[:1])
    d_last = float(np.abs(r0["first"][0] - card_first[0]).max())
    d_step = float(np.abs(r0["first"][1] - card_first[1]).max())
    if max(d_last, d_step) > TP_LOGIT_TOL:
        fail(f"tp: the first decode step's logits differ from the single card's by "
             f"{d_last:.4g} (prefill) / {d_step:.4g} (step) > {TP_LOGIT_TOL}")
    worst8 = max(r["run2"]["int8_of_exact"] for r in ranks)
    if worst8 >= TP_INT8_BAND:
        fail(f"tp run2: int8 decode logits {worst8:.4g} of the largest |exact logit| >= "
             f"{TP_INT8_BAND}")

    def want(tag):
        run = r0[tag]
        d, v, p = run["decode"], run["verify"], run["prefill"]
        if tag == "run2":
            return expected_counts(qmm_i8_direct=n_lin * d, qmm_i8_direct_decode=n_lin * d,
                                   qmm_nf4_w8a8=n_lin * p, qmm_nf4_w8a8_wgmma=n_lin * p,
                                   paged_decode_attention_cuda=L * d, paged_decode_split=L * d)
        return expected_counts(qmm_nf4_fwd_dq=n_lin * (d + v + p), qmm_nf4_decode_dq=n_lin * d,
                               qmm_nf4_wgmma_dq=n_lin * (v + p),   # 4 x 5 rows a chunk
                               paged_decode_attention_cuda=L * d, paged_decode_split=L * d,
                               paged_chunk_attention_cuda=L * v, paged_chunk_split=L * v)

    new = TP_SERVE_NEW
    expect = {tag: want(tag) for tag in ("run1", "run2", "run3")}
    expect["serve_tp"] = expected_counts(qmm_nf4_fwd_dq=n_lin * new, qmm_nf4_wgmma_dq=n_lin,
                                         qmm_nf4_decode_dq=n_lin * (new - 1),
                                         decode_attention_cuda=L * (new - 1))
    for r in ranks:
        for tag, w in expect.items():
            if r[tag]["counts"] != w:
                fail(f"tp {tag} rank {r['rank']}: launch counts {r[tag]['counts']} != {w}")
    total = collections.Counter()
    for tag in expect:
        total.update(r0[tag]["counts"])
    phase_s = time.perf_counter() - t_phase
    spec_tok, spec_chunks = r0["run3"]["spec"]
    print(f"tp ({card}): every rank's tokens equal in every run, no rank's own tokens ever "
          f"different from rank 0's; every emitted token against the single card's "
          f"teacher-forced logits over the engine's context (tokens, largest shortfall, "
          f"tokens short at all, the next-token control's median, tolerance): " + "; ".join(
              f"{tag} {n} / {w:.4g} / {k} / {c:.4g} / {t:.4g}"
              for tag, (n, w, k, c, t) in near.items()) + f"; run 1 {TP_REQUESTS} requests, "
          f"{r0['run1']['preemptions']} preemptions, {clear1[0]} of {clear1[1]} tokens before "
          f"each request's first top-2 margin under {TP_NEAR_TIE} equal to the single card's; "
          f"run 3 {clear3[0]} of {clear3[1]} and serve_tp {clear_s[0]} of {clear_s[1]} equal "
          f"to run 1's there; first decode step max|logits - single card| {d_last:.4g} "
          f"(prefill) / {d_step:.4g} (step) <= {TP_LOGIT_TOL}; int8 decode {worst8:.4g} of the "
          f"largest |exact logit| < {TP_INT8_BAND}; speculation {spec_tok} tokens in "
          f"{spec_chunks} chunks; launch counts exact on every rank, rank 0's "
          f"{ {k: v for k, v in total.items() if v} }", flush=True)
    print(f"tp ({card}): phase {phase_s:.1f} s, shards cut and written {cut_s:.1f} s "
          f"({', '.join(f'{g:.2f}' for g in shard_files)} GiB a rank), ranks {ranks_s:.1f} s "
          f"(start, load, runs); host seconds of rank 0's runs ("
          f"{'NCCL, a card a rank' if four else 'not a tensor-parallel speed: gloo, four ranks time-sharing one card'}"
          f"): run 1 "
          f"{r0['run1']['s']:.1f} ({r0['run1']['steps']} steps), run 2 {r0['run2']['s']:.1f}, "
          f"run 3 {r0['run3']['s']:.1f}, serve_tp {r0['serve_tp']['s']:.1f}; the ranks in "
          f"their function {max(r['entered'] for r in ranks) - spawned:.1f} s after the spawn, "
          f"rank 0's shard loaded in {r0['load_s']:.1f} s ({r0['shard_gib']:.2f} GiB on its "
          f"device), engines built in {r0['run1']['built_s']:.1f} / {r0['run2']['built_s']:.1f}"
          f" / {r0['run3']['built_s']:.1f} s; peak memory a rank "
          f"{', '.join(f'{r['peak_gib']:.2f}' for r in ranks)} GiB", flush=True)
    gc_cuda()
    return dict(total), dict(phase_s=phase_s, ranks_s=ranks_s, backend=backend,
                             d_logits=max(d_last, d_step), int8_of_exact=worst8,
                             peak_gib=[r["peak_gib"] for r in ranks],
                             worst_short=max(v[1] for k, v in near.items() if k != "run2"))


def tensor_digest(t):
    """Two int64 sums of a tensor's bytes (read as int32 words where they
    fill them): plain and position-weighted.  Two tensors with other bits
    get other digests but for a collision of both sums."""
    import torch

    b = t.detach().contiguous().reshape(-1).view(torch.uint8)
    if b.numel() % 4 == 0:
        v = b.view(torch.int32).to(torch.int64)
    else:
        v = b.to(torch.int64)
    w = torch.arange(v.numel(), device=v.device, dtype=torch.int64) % 65521 + 1
    return torch.stack([v.sum(), (v * w).sum()])


def tree_bytes(tree):
    from qlora_tpu_torch.train.optimizer import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def mesh_hook(event, ctx):
    """train-mesh's probe in every rank of a ``cli.train`` mesh run (the
    CLI calls it at "start", after each "step" and at the "end"): the
    rank's frozen and optimizer-state bytes, its kernel launches and peak
    memory over the loop, the collectives of each step by axis, after each
    step the number of adapter tensors whose bits differ from those of the
    rank holding the same tensor with the lowest world rank (digests
    gathered and compared: nothing is broadcast), and whether the frozen
    shard kept its bits."""
    import torch

    from qlora_tpu_torch.parallel import megatron_lora_specs
    from qlora_tpu_torch.parallel.megatron_step import spec_leaves
    from qlora_tpu_torch.train.optimizer import tree_leaves

    rep, mesh, state = ctx["report"], ctx["mesh"], ctx["state"]
    dev = mesh.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    frozen_digest = lambda: torch.stack([tensor_digest(t) for t in tree_leaves(ctx["frozen"])])
    if event == "start":
        sync()
        rep.update(rank=mesh.rank, device=str(dev), backend=mesh.backend,
                   frozen_bytes=tree_bytes(ctx["frozen"]), opt_bytes=tree_bytes(state.opt_state),
                   lora_bytes=tree_bytes(state.trainable), collectives=[], differing=[],
                   frozen0=frozen_digest().cpu())
        reset_counts()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        rep["base"] = mesh.collectives()
        rep["entered"], rep["started"] = ctx["entered"], time.time()
        return
    if event == "step":
        now = mesh.collectives()
        rep["collectives"].append({k: now[k] - rep["base"][k] for k in now})
        leaves = tree_leaves(state.trainable)
        if ctx["style"] == "megatron":
            sharded = [sp is not None for sp in spec_leaves(
                state.trainable, megatron_lora_specs(state.trainable))]
        else:
            sharded = [False] * len(leaves)
        mine = torch.stack([tensor_digest(t) for t in leaves])
        every = mesh.world.all_gather(mine[None], dim=0)        # [world, leaves, 2]
        # the rank of lowest world rank holding each tensor: rank 0, or for a
        # tp-sharded tensor the rank of this tp coordinate with d = 0
        ref = torch.stack([every[mesh.tp.rank if sh else 0, j] for j, sh in enumerate(sharded)])
        holders = torch.tensor(
            [[r % mesh.shape["tp"] == mesh.tp.rank or not sh for sh in sharded]
             for r in range(mesh.world.size)], device=every.device)
        differ = ((every != ref[None]).any(-1) & holders).sum().item()
        rep["differing"].append(int(differ))
        rep["base"] = mesh.collectives()
        return
    sync()
    rep["ended"] = time.time()
    rep["counts"] = read_counts()
    rep["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2 ** 30 if dev.type == "cuda"
                       else 0.0)
    rep["frozen_same"] = bool(torch.equal(frozen_digest().cpu(), rep.pop("frozen0")))


def mesh_argv(data, out, steps, dev, *extra):
    """train-mesh's command line: the cli phase's (LLaMA-7B, the alpaca
    file, 2 x 512 a micro-batch, 2 a step, its learning rate 2e-4) with
    serve's seed, MESH_SAMPLES training examples (each step sees the same
    four, so that the loss shows the update of the step before), a
    checkpoint only at the end, no eval."""
    return cli_argv(data, out, steps, dev, "--seed", MESH_SEED,
                    "--max_train_samples", str(MESH_SAMPLES), "--save_steps", "1000",
                    "--do_eval", "false", *extra)


def together(*fns):
    """Each of `fns` called in a thread of its own, all at once; their
    results in order, or the first one's exception (a failed check's
    ``SystemExit`` included) raised here."""
    import threading

    out = [None] * len(fns)

    def call(i, fn):
        try:
            out[i] = (True, fn())
        except BaseException as e:
            out[i] = (False, e)

    threads = [threading.Thread(target=call, args=(i, fn)) for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for ok, value in out:
        if not ok:
            raise value
    return [value for _, value in out]


def mesh_agree(tag, got, ref, falls=True, phase="train-mesh"):
    """Each step's loss and grad norm of a mesh run against the single
    card's, and (`falls`) the loss falling; returns the worst relative
    differences."""
    pick = lambda m: [(h["step"], h["loss"], h["grad_norm"]) for h in m["train_metrics"]]
    g, r = pick(got), pick(ref)
    if [s for s, _, _ in g] != [s for s, _, _ in r]:
        fail(f"{phase} {tag}: steps {g} against the single card's {r}")
    dl = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(g, r))
    dg = max(abs(a[2] - b[2]) / abs(b[2]) for a, b in zip(g, r))
    print(f"{phase} {tag}: losses " + ", ".join(f"{x[1]:.6f}" for x in g) + " (single card "
          + ", ".join(f"{x[1]:.6f}" for x in r) + "), grad norms " + ", ".join(
              f"{x[2]:.5f}" for x in g) + " (single card " + ", ".join(f"{x[2]:.5f}" for x in r)
          + f"); worst relative difference {dl:.3g} (loss, <= {MESH_LOSS_RTOL}), {dg:.3g} (grad "
          f"norm, <= {MESH_GNORM_RTOL})", flush=True)
    if dl > MESH_LOSS_RTOL or dg > MESH_GNORM_RTOL:
        fail(f"{phase} {tag}: a step's loss or grad norm differs from the single card's "
             f"({dl:.3g} > {MESH_LOSS_RTOL} or {dg:.3g} > {MESH_GNORM_RTOL})")
    losses = [x[1] for x in g]
    if not all_finite(losses) or (falls and not losses[-1] < losses[0]):
        fail(f"{phase} {tag}: the losses {losses} are not finite and falling")
    return dl, dg


def all_finite(values) -> bool:
    import math

    return all(math.isfinite(v) for v in values)


def loop_times(m, called, took):
    """Where a mesh run's `took` seconds since `called` (``time.time()``)
    went: before rank 0's loop (the ranks' start, their shards written and
    read), the loop, after it (the checkpoint gathered and written, the
    ranks' end); "" for a single-card run."""
    if "mesh_report" not in m:
        return ""
    r0 = m["mesh_report"][0]
    return (f" (before the ranks' loop {r0['started'] - called:.1f} s, of which the ranks' start "
            f"{max(r['entered'] for r in m['mesh_report']) - called:.1f} s, the loop "
            f"{r0['ended'] - r0['started']:.1f} s, after it {called + took - r0['ended']:.1f} s)")


def seed_run(start, out):
    """Directory `out` holding checkpoint `start` (hard links): a run that
    resumes from it."""
    import os

    dst = Path(out) / Path(start).name
    for path in Path(start).rglob("*"):
        target = dst / path.relative_to(start)
        if path.is_dir():
            target.mkdir(parents=True, exist_ok=True)
        else:
            target.parent.mkdir(parents=True, exist_ok=True)
            os.link(path, target)
    return out


def cut_model(args, dev, layers):
    """``cli.build_model_and_tokenizer``'s random model for `args` (its
    seeds: the weights from ``--seed``, the LoRA from ``--seed`` + 1) at
    LLaMA-7B width and `layers` layers: (params, lora, cfg, lcfg,
    tokenizer)."""
    from qlora_tpu_torch import cli
    from qlora_tpu_torch.lora import LoraConfig
    from qlora_tpu_torch.models import init_lora_params, init_params

    cfg = seven_b(layers)
    lcfg = LoraConfig(r=args.lora_r, alpha=args.lora_alpha, dropout=args.lora_dropout)
    params = init_params(cfg, seed=args.seed, quantized=True, device=dev,
                         quant_type=args.quant_type)
    lora = init_lora_params(cfg, lcfg, seed=args.seed + 1, device=dev)
    return params, lora, cfg, lcfg, cli._tokenizer(args)


def train_mesh_phase(dev, card=""):
    """train-mesh: LoRA finetuning over four ranks through ``cli.train`` at
    LLaMA-7B full width, MESH_LAYERS layers (NF4 double quant, the CLI's
    weights from serve's seed, a rank-64 LoRA on all 7 linears, paged_adamw_32bit, remat
    "save_linear"), the cli phase's alpaca file and argv: a global batch of
    2 x 512, 2 micro-batches a step, so that each data rank takes 1 x 512 a
    micro-batch.  Every run resumes from one single-card checkpoint at step
    MESH_START (serve's adapters, AdamW's count at 1).  Run 1: the gather
    style at (dp, fsdp, tp) = (1, 2, 2) with ZeRO-1, MESH_GATHER_STEPS
    steps, its last checkpoint then resumed on the single card through
    ``cli.train`` for one more step; run 2: Megatron at (2, 1, 2) on the
    re-packed tree (row-parallel linears K-sharded over 2), MESH_STEPS
    steps.  On one card the ranks are gloo processes sharing it, both runs
    and the single card's at once (this shows shards, collectives and
    control flow, not parallel speed); with four cards, NCCL a card a rank,
    one run after the other.  Each run against the single card on the same
    weights, argv and stream (run 2's on the re-packed tree, whose K-sharded
    tensors run chunk by chunk): each step's loss within MESH_LOSS_RTOL and
    grad norm within MESH_GNORM_RTOL relative (run 1's resumed step among
    them), the loss falling; on every rank after every step each adapter
    tensor bit-equal to its holder of lowest rank, the frozen shard
    unchanged, its bytes about 1/(fsdp tp) or 1/tp of the model's and (run
    1) the optimizer state's about 1/fsdp of the single card's; rank 0's
    launches exact, every NF4 forward and dx on the wgmma kernels; the
    collectives of a step by axis, Megatron's fewer.  Returns (rank 0's
    launch counts over both runs, stats)."""
    import os
    import tempfile

    import torch

    from qlora_tpu_torch import cli
    from qlora_tpu_torch.parallel import requantize_row_parallel
    from qlora_tpu_torch.utils.checkpoint import save_checkpoint

    t_phase = time.perf_counter()
    four = torch.cuda.device_count() >= 4 if dev.type == "cuda" else False
    ranks = None if four else ("gloo", [str(dev) if dev.type != "cuda" else "cuda:0"] * 4)
    backend = "nccl" if four else "gloo"
    L = MESH_LAYERS
    stats = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = str(Path(tmp) / "alpaca.jsonl")
        alpaca_jsonl(data, DATA_EXAMPLES, seed=51)
        out = lambda tag: str(Path(tmp) / tag)
        t0 = time.perf_counter()
        args = cli.parse_args(mesh_argv(data, out("ref"), MESH_END, dev))
        params, lora, cfg, lcfg, tok = model = cut_model(args, dev, MESH_LAYERS)
        whole = {"gather": tree_bytes(params)}
        opt_whole = 2 * tree_bytes(lora)          # AdamW's mu and nu on one card, f32
        # what every run starts from: a single-card checkpoint at MESH_START,
        # linked into each run's directory
        lora_r = random_lora(cfg, dev, seed=8)[0]
        opt_r = cli._make_optimizer(args).init(lora_r)
        opt_r["count"] = MESH_START
        start = save_checkpoint(out("start"), MESH_START, lora_r, opt_r)
        del lora_r, opt_r
        build_s = time.perf_counter() - t0

        seeded = lambda tag: seed_run(start, out(tag))

        def run(tag, argv, **kw):
            torch.cuda.synchronize()
            reset_counts()
            t0, called = time.perf_counter(), time.time()
            m = cli.train(cli.parse_args(argv), **kw)
            torch.cuda.synchronize()
            stats[f"{tag}_s"] = time.perf_counter() - t0
            where = loop_times(m, called, stats[f"{tag}_s"])
            print(f"train-mesh {tag}: {stats[f'{tag}_s']:.1f} s{where}, steps " + ", ".join(
                f"{h['seconds_per_step']:.2f}" for h in m["train_metrics"]) + " s", flush=True)
            gc_cuda()
            return m

        # the single card one step further: the step run 1's checkpoint resumes to
        repacked = requantize_row_parallel(params, 2)
        whole["megatron"] = tree_bytes(repacked)
        model2 = (repacked, lora, cfg, lcfg, tok)
        work = (
            # the single card, one step further for run 1: the step its checkpoint resumes to
            lambda: (run("ref1", mesh_argv(data, seeded("ref"), MESH_GATHER_END + 1, dev),
                         model=model),
                     run("ref2", mesh_argv(data, seeded("ref2"), MESH_END, dev), model=model2)),
            lambda: run("run1", mesh_argv(data, seeded("run1"), MESH_GATHER_END, dev, *MESH_GATHER),
                        ranks=ranks, model=model, hook=mesh_hook),
            lambda: run("run2", mesh_argv(data, seeded("run2"), MESH_END, dev, *MESH_MEGATRON),
                        ranks=ranks, model=model2, hook=mesh_hook))
        # on one card the single-card runs and both mesh runs go at once
        # (eight gloo processes and the parent share it: their starts,
        # hand-overs and checkpoints overlap); on four cards one after the
        # other (a card holds one rank of a NCCL world)
        (ref1, ref2), run1, run2 = [f() for f in work] if four else together(*work)
        del model2, repacked
        gc_cuda()
        # run 1's last checkpoint resumed on the single card for one more step
        os.remove(Path(out("run1")) / "completed")
        t0 = time.perf_counter()
        res1 = cli.train(cli.parse_args(mesh_argv(data, out("run1"), MESH_GATHER_END + 1, dev)),
                         model=model)
        stats["resume_s"] = time.perf_counter() - t0
        del model, params, lora
        gc_cuda()

    # run 1's step, then its checkpoint's resumed step, against the single card's two
    d1 = mesh_agree("run 1 (gather, 1 x 2 x 2)",
                    dict(run1, train_metrics=run1["train_metrics"] + res1["train_metrics"]),
                    ref1)
    d2 = mesh_agree("run 2 (megatron, 2 x 1 x 2)", run2, ref2)
    if [h["step"] for h in res1["train_metrics"]] != [MESH_GATHER_END + 1]:
        fail(f"train-mesh: the resumed run logged steps {res1['train_metrics']}")
    per_step = train_counts(L)
    total = collections.Counter()
    summary = {}
    for tag, m, frac, style, steps in (("run 1", run1, 4, "gather", MESH_GATHER_STEPS),
                                       ("run 2", run2, 2, "megatron", MESH_STEPS)):
        reps = m["mesh_report"]
        r0 = reps[0]
        total.update(r0["counts"])
        want = expected_counts(**{k: steps * v for k, v in per_step.items() if v})
        if r0["counts"] != want:
            fail(f"train-mesh {tag}: rank 0's launches {r0['counts']} != {want}")
        bad = [(r["rank"], r["differing"]) for r in reps if any(r["differing"])]
        if bad or len(r0["differing"]) != steps:
            fail(f"train-mesh {tag}: adapter tensors differing from their holder of lowest rank "
                 f"(rank, per step): {bad}")
        if not all(r["frozen_same"] for r in reps):
            fail(f"train-mesh {tag}: a rank's frozen shard changed")
        shares = [r["frozen_bytes"] / whole[style] for r in reps]
        if any(not 0.97 / frac <= x <= 1.03 / frac for x in shares):
            fail(f"train-mesh {tag}: the ranks' frozen shares {shares} are not about 1/{frac}")
        opt_shares = [r["opt_bytes"] / opt_whole for r in reps]
        if style == "gather" and any(not 0.49 <= x <= 0.51 for x in opt_shares):
            fail(f"train-mesh {tag}: the ranks' optimizer state shares {opt_shares} are not "
                 "about 1/2 (ZeRO-1 over fsdp 2)")
        coll = r0["collectives"]
        if any(c != coll[0] for c in coll):
            fail(f"train-mesh {tag}: rank 0's collectives differ from step to step: {coll}")
        secs = [h["seconds_per_step"] for h in m["train_metrics"]]
        summary[tag] = dict(collectives={k: v for k, v in coll[0].items() if v},
                            n_collectives=sum(v for k, v in coll[0].items()),
                            step_s=secs, peak_gib=[r["peak_gib"] for r in reps],
                            frozen_gib=[r["frozen_bytes"] / 2 ** 30 for r in reps],
                            opt_gib=[r["opt_bytes"] / 2 ** 30 for r in reps], shares=shares,
                            opt_shares=opt_shares, s=stats[tag.replace(" ", "")  + "_s"])
        print(f"train-mesh {tag} ({style}, {backend}"
              f"{', a card a rank' if four else ', four ranks on one card beside the other run'}): "
              f"rank 0's collectives a step {summary[tag]['collectives']} "
              f"({summary[tag]['n_collectives']} in all; the probe's own gathers left out); "
              f"seconds a step on rank 0's host clock {', '.join(f'{x:.3f}' for x in secs)}; "
              f"frozen storage a rank {', '.join(f'{x:.3f}' for x in summary[tag]['frozen_gib'])} "
              f"GiB ({', '.join(f'{x:.4f}' for x in shares)} of the model's "
              f"{whole[style] / 2 ** 30:.3f} GiB); optimizer state a rank "
              f"{', '.join(f'{x:.3f}' for x in summary[tag]['opt_gib'])} GiB "
              f"({', '.join(f'{x:.4f}' for x in opt_shares)} of the single card's "
              f"{opt_whole / 2 ** 30:.3f} GiB); peak a rank "
              f"{', '.join(f'{x:.2f}' for x in summary[tag]['peak_gib'])} GiB; adapters bit-equal "
              f"to their holders' after every step on every rank, frozen shards unchanged; "
              f"rank 0's launches {dict((k, v) for k, v in r0['counts'].items() if v)}",
              flush=True)
    if summary["run 2"]["n_collectives"] >= summary["run 1"]["n_collectives"]:
        fail("train-mesh: Megatron makes no fewer collectives a step than the gather style")
    phase_s = time.perf_counter() - t_phase
    print(f"train-mesh ({card}): phase {phase_s:.1f} s (model built in {build_s:.1f} s; the single "
          f"card {stats['ref1_s']:.1f} + {stats['ref2_s']:.1f} s, run 1 {stats['run1_s']:.1f} s, "
          f"run 2 {stats['run2_s']:.1f} s, each run's shards cut, written and read, the ranks "
          f"started and a checkpoint gathered and written included; resumed through cli.main "
          f"{stats['resume_s']:.1f} s); the single card's steps "
          f"{', '.join(f'{h['seconds_per_step']:.3f}' for h in ref1['train_metrics'])} s; "
          f"worst relative differences: loss {max(d1[0], d2[0]):.3g}, grad norm "
          f"{max(d1[1], d2[1]):.3g}", flush=True)
    return dict(total), dict(phase_s=phase_s, backend=backend, runs=summary,
                             worst=(max(d1[0], d2[0]), max(d1[1], d2[1])))


def long_alpaca_jsonl(path, n, seed):
    """`n` seeded alpaca examples from DATA_WORDS long enough for the
    long-context recipe: under FakeTokenizer (a token a byte) each prompt
    runs past SP_SOURCE and each output past SP_TARGET, so that the
    collator cuts both and all 8192 positions hold real tokens (the
    prompt's labels ignored, the output's counted)."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def text(chars):
        words = []
        while sum(len(w) + 1 for w in words) < chars:
            words.append(str(rng.choice(DATA_WORDS)))
        return " ".join(words)

    with open(path, "w") as f:
        for _ in range(n):
            f.write(json.dumps({"instruction": text(40), "input": text(SP_SOURCE + 200),
                                "output": text(SP_TARGET + 200)}) + "\n")


def sp_argv(data, out, steps, dev, batch, *extra):
    """train-sp's command line: the long-context recipe's lengths (source
    2048 + target 6144, no length grouping: every row S = 8192) at LLaMA-7B
    with serve's seed, `batch` rows a step and no accumulation, the `batch`
    training examples every step sees again (so that the loss shows the
    update of the step before), remat "full" (JAX's sp step's own default:
    the least activation memory), a checkpoint only at the end, no eval."""
    return ["--model_name_or_path", CLI_MODEL, "--init_random", "--fake_tokenizer",
            "--dataset", data, "--output_dir", out, "--device", str(dev),
            "--per_device_train_batch_size", str(batch), "--gradient_accumulation_steps", "1",
            "--source_max_len", str(SP_SOURCE), "--target_max_len", str(SP_TARGET),
            "--group_by_length", "false", "--lora_dropout", "0", "--max_steps", str(steps),
            "--save_steps", "1000", "--logging_steps", "1", "--do_eval", "false",
            "--seed", MESH_SEED, "--max_train_samples", str(batch), "--remat_policy", "full",
            *extra]


class TimedRotation:
    """A rotation whose ``wait`` adds the host's time blocked in it to
    ``now[0]`` (no reference cycle: the received blocks go when the ring
    drops it, as they do without the probe)."""

    def __init__(self, rot, now):
        self.rot, self.now = rot, now

    def wait(self):
        t0 = time.perf_counter()
        out = self.rot.wait()
        self.now[0] += time.perf_counter() - t0
        return out


def sp_hook(event, ctx):
    """train-sp's probe in every rank: train-mesh's (``mesh_hook``), the
    memory the rank holds when its loop starts (its shard, adapters and
    optimizer state: the peak beyond it is the step's activations and
    transients), and the time its host spends blocked in the ring's
    rotations (``Rotation.wait``) with their bytes, a step at a time."""
    import torch

    mesh_hook(event, ctx)
    rep, sp = ctx["report"], ctx["mesh"].sp
    if event == "start":
        dev = ctx["mesh"].device
        rep["start_gib"] = (torch.cuda.memory_allocated(dev) / 2 ** 30 if dev.type == "cuda"
                            else 0.0)
        rep.update(rot_wait_s=[], rot_gib=[], rot_now=[0.0, 0])
        start = sp.rotate

        def rotate(tensors, shift=1, tag=0):
            rep["rot_now"][1] += sum(t.numel() * t.element_size() for t in tensors)
            return TimedRotation(start(tensors, shift, tag), rep["rot_now"])

        sp.rotate = rotate
    elif event == "step":
        rep["rot_wait_s"].append(rep["rot_now"][0])
        rep["rot_gib"].append(rep["rot_now"][1] / 2 ** 30)
        rep["rot_now"] = [0.0, 0]


def sp_counts(L, s, steps):
    """The launches of sp rank `s` over `steps` steps of one row a data rank
    (remat "full"): train's single micro-batch with the flash kernels once a
    ring chunk, s + 1 chunks a layer (the diagonal and the s shards before
    it), the forward twice (the recomputed block's), every launch on the
    wgmma kernels."""
    per = train_counts(L, remat="full", micro=1)
    flash = {"flash_fwd": 2 * (s + 1) * L, "flash_bwd_dq": (s + 1) * L,
             "flash_bwd_dkv": (s + 1) * L}
    per.update(flash, **{k: flash[n] for k, n in WGMMA_COUNTS.items() if n in flash})
    return {k: steps * v for k, v in per.items()}


def train_sp_phase(dev, card="", results=(), chunk_ms=None):
    """train-sp: ring-attention sequence parallelism through ``cli.train``
    at LLaMA-7B full width and depth (32 layers, NF4 double quant, serve's
    weights, a rank-64 LoRA on all 7 linears, paged_adamw_32bit) on the
    long-context recipe's lengths, S = 8192 (every position a real token).
    Every run resumes from one single-card checkpoint at MESH_START (serve's
    adapters, AdamW's count at 1) for SP_STEPS steps: run 1 the recipe's
    ring, (dp, fsdp, tp, sp) = (1, 1, 1, 4), batch 1 (2048 positions a rank);
    run 2 the weight-sharded ring (1, 2, 1, 2) with ZeRO-1, batch 2 (fsdp is
    a batch axis: a row and 4096 positions a rank).  The single card runs
    each run's argv beside it (its peak memory its own: it starts once the
    mesh run's parent has made its state on the card), the runs one after
    the other: on one card four gloo processes sharing it, with four cards
    NCCL a card a rank (the single card first).  Each run
    against its single card on the same weights, argv and stream: each
    step's loss within MESH_LOSS_RTOL and grad norm within MESH_GNORM_RTOL
    relative, the loss falling; on every rank after every step the adapters
    bit-equal to rank 0's and the frozen shard unchanged, its bytes the
    model's (run 1) or half (run 2), and ZeRO-1's optimizer state half the
    single card's (run 2); every rank's launches exact (its flash chunks
    rank-dependent, every NF4 forward and dx at 2048 or 4096 rows on the
    wgmma kernels); the collectives of a step by axis (the rotations on sp);
    each rank's activation peak about 1/4 of the single card's (a quarter of
    its tokens) and at most half.  `results` (the kernel phases') and
    `chunk_ms` (``ring_kernel_phase``'s) split a run-1 step.  Returns (the
    launches summed over both runs' ranks, stats)."""
    import tempfile
    import threading

    import torch

    from qlora_tpu_torch import cli
    from qlora_tpu_torch.utils.checkpoint import save_checkpoint

    t_phase = time.perf_counter()
    four = torch.cuda.device_count() >= 4 if dev.type == "cuda" else False
    ranks = None if four else ("gloo", [str(dev) if dev.type != "cuda" else "cuda:0"] * 4)
    backend = "nccl" if four else "gloo"
    cuda = dev.type == "cuda"
    L = seven_b().num_layers
    end = MESH_START + SP_STEPS
    stats, refs, runs = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        out = lambda tag: str(Path(tmp) / tag)
        data = out("long.jsonl")
        long_alpaca_jsonl(data, max(b for _, _, b in SP_RUNS), seed=53)
        t0 = time.perf_counter()
        args = cli.parse_args(sp_argv(data, out("ref"), end, dev, 1))
        params, lora, cfg, lcfg, tok = cli.build_model_and_tokenizer(args, dev)
        model = (params, lora, cfg, lcfg, tok)
        whole, opt_whole = tree_bytes(params), 2 * tree_bytes(lora)
        lora_r = random_lora(cfg, dev, seed=8)[0]
        opt_r = cli._make_optimizer(args).init(lora_r)
        opt_r["count"] = MESH_START
        start = save_checkpoint(out("start"), MESH_START, lora_r, opt_r)
        del lora_r, opt_r
        build_s = time.perf_counter() - t0

        def run(tag, batch, flags=(), after=None, **kw):
            if after is not None:     # the single card: its activations and transients alone
                after.wait()
                if cuda:
                    torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated() if cuda else 0
            t0, called = time.perf_counter(), time.time()
            m = cli.train(cli.parse_args(sp_argv(data, seed_run(start, out(tag)), end, dev,
                                                 batch, *flags)), **kw)
            if cuda:
                torch.cuda.synchronize()
            stats[f"{tag}_s"] = time.perf_counter() - t0
            if after is not None:
                stats[f"{tag}_act_gib"] = ((torch.cuda.max_memory_allocated() - held) / 2 ** 30
                                           if cuda else 0.0)
            where = loop_times(m, called, stats[f"{tag}_s"])
            print(f"train-sp {tag}: {stats[f'{tag}_s']:.1f} s{where}, steps " + ", ".join(
                f"{h['seconds_per_step']:.2f}" for h in m["train_metrics"]) + " s"
                + (f", activation peak {stats[f'{tag}_act_gib']:.2f} GiB"
                   if f"{tag}_act_gib" in stats else ""), flush=True)
            return m

        # each run beside its single card (on four cards, after it): the single card
        # starts once the mesh run's parent has made its adapters and optimizer state
        # and gone on to the ranks (it makes nothing more on the card), so that its
        # peak is its own.  One run after the other: both runs' eight ranks at once
        # fill the card
        entered = threading.Event()
        real = cli._train_on_mesh
        cli._train_on_mesh = lambda *a, **kw: (entered.set(), real(*a, **kw))[1]
        try:
            for tag, flags, batch in SP_RUNS:
                gc_cuda()
                reset_counts()
                entered.clear()
                def mesh():
                    try:
                        return run(tag, batch, flags, ranks=ranks, model=model, hook=sp_hook)
                    finally:
                        entered.set()      # a run that failed early frees the single card

                single = lambda: run(f"ref {tag}", batch, after=entered, model=model)
                if four:
                    entered.set()
                    refs[tag], runs[tag] = single(), mesh()
                else:
                    runs[tag], refs[tag] = together(mesh, single)
        finally:
            cli._train_on_mesh = real
        del model, params, lora
        gc_cuda()

    total = collections.Counter()
    summary, worst = {}, [0.0, 0.0]
    for tag, flags, batch in SP_RUNS:
        m, ref = runs[tag], refs[tag]
        d = mesh_agree(f"{tag} ({' '.join(flags)})", m, ref, phase="train-sp")
        worst = [max(a, b) for a, b in zip(worst, d)]
        reps = m["mesh_report"]
        n_sp = int(flags[flags.index("--mesh_sp") + 1])
        fsdp = int(flags[flags.index("--mesh_fsdp") + 1]) if "--mesh_fsdp" in flags else 1
        for r in reps:
            total.update(r["counts"])
            want = expected_counts(**{k: v for k, v in sp_counts(L, r["rank"] % n_sp,
                                                                 SP_STEPS).items() if v})
            if r["counts"] != want:
                fail(f"train-sp {tag}: rank {r['rank']}'s launches {r['counts']} != {want}")
        bad = [(r["rank"], r["differing"]) for r in reps if any(r["differing"])]
        if bad or any(len(r["differing"]) != SP_STEPS for r in reps):
            fail(f"train-sp {tag}: adapter tensors differing from rank 0's (rank, per step): {bad}")
        if not all(r["frozen_same"] for r in reps):
            fail(f"train-sp {tag}: a rank's frozen shard changed")
        shares = [r["frozen_bytes"] / whole for r in reps]
        opt_shares = [r["opt_bytes"] / opt_whole for r in reps]
        if any(not 0.97 / fsdp <= x <= 1.03 / fsdp for x in shares) or any(
                not 0.98 / fsdp <= x <= 1.02 / fsdp for x in opt_shares):
            fail(f"train-sp {tag}: frozen shares {shares}, optimizer state shares {opt_shares}: "
                 f"not about 1/{fsdp}")
        coll = [c for r in reps for c in r["collectives"]]
        if any(c["sp"] != L * (3 * (n_sp - 1) + n_sp) or c["data_sp"] != 2 for c in coll):
            fail(f"train-sp {tag}: collectives a step {coll}: want {L * (3 * (n_sp - 1) + n_sp)} "
                 "rotations on sp (remat 'full': n - 1 forward twice, n - 1 and n backward) "
                 "and 2 all-reduces on (dp, fsdp, sp)")
        act = [r["peak_gib"] - r["start_gib"] for r in reps]
        ref_act = stats[f"ref {tag}_act_gib"]
        if cuda and any(a > 0.5 * ref_act for a in act):
            fail(f"train-sp {tag}: the ranks' activation peaks {act} GiB are not under half the "
                 f"single card's {ref_act:.2f} GiB")
        secs = [h["seconds_per_step"] for h in m["train_metrics"]]
        summary[tag] = dict(collectives={k: v for k, v in coll[0].items() if v}, step_s=secs,
                            ref_step_s=[h["seconds_per_step"] for h in ref["train_metrics"]],
                            peak_gib=[r["peak_gib"] for r in reps], act_gib=act,
                            ref_act_gib=ref_act, shares=shares, opt_shares=opt_shares,
                            rot_wait_s=[r["rot_wait_s"] for r in reps],
                            rot_gib=reps[0]["rot_gib"][0], s=stats[f"{tag}_s"],
                            ref_s=stats[f"ref {tag}_s"],
                            flash_fwd=[r["counts"]["flash_fwd"] for r in reps])
        where = (", a card a rank" if four else ", four ranks on one card; each rotation card "
                 "to card through CUDA IPC, gloo carrying the signals (it sends no CUDA tensor)")
        print(f"train-sp {tag} ({backend}{where}):"
              f" collectives a step {summary[tag]['collectives']} (rank 0; the probe's own "
              f"gathers left out), {summary[tag]['rot_gib']:.3f} GiB sent in rotations a step a "
              f"rank; host blocked in rotations a step, by rank "
              f"{[[round(x, 2) for x in w] for w in summary[tag]['rot_wait_s']]} s of steps "
              f"{', '.join(f'{x:.2f}' for x in secs)} s (rank 0's host clock; the single card's "
              f"{', '.join(f'{x:.2f}' for x in summary[tag]['ref_step_s'])} s); flash forward "
              f"launches by rank {summary[tag]['flash_fwd']}; peak a rank "
              f"{', '.join(f'{x:.2f}' for x in summary[tag]['peak_gib'])} GiB, of which "
              f"activations {', '.join(f'{x:.2f}' for x in act)} against the single card's "
              f"{ref_act:.2f} GiB ({', '.join(f'{x / max(ref_act, 1e-9):.3f}' for x in act)}"
              f"); frozen shares {', '.join(f'{x:.4f}' for x in shares)}, optimizer state shares "
              f"{', '.join(f'{x:.4f}' for x in opt_shares)}; adapters bit-equal on every rank "
              f"after every step, frozen shards unchanged, every rank's launches exact",
              flush=True)
    if chunk_ms and results:
        # run 1, rank 3 (the most chunks): the flash chunks at ring_kernel_phase's times, the
        # NF4 forward at M = 2048 at the kernel phase's (the dx at 2048 is not timed: in "other")
        per = sp_counts(L, 3, 1)
        qmm = qmm_ms_per_forward(results, L, 2048) * 2
        flash = (L * (2 * chunk_ms["diagonal"] + 2 * 3 * chunk_ms["earlier"]))
        print(f"train-sp run 1, rank 3, a step: NF4 forward kernels ~{qmm:.0f} ms "
              f"({per['qmm_nf4_fwd_dq']} at M=2048), flash forward chunks ~{flash:.0f} ms "
              f"({per['flash_fwd']}), host blocked in rotations "
              f"{summary['run 1']['rot_wait_s'][3][-1]:.2f} s, of "
              f"{summary['run 1']['step_s'][-1]:.2f} s on rank 0's clock", flush=True)
    phase_s = time.perf_counter() - t_phase
    print(f"train-sp ({card}): phase {phase_s:.1f} s (model built in {build_s:.1f} s; the single "
          f"card {', '.join(f'{summary[t]['ref_s']:.1f}' for t in summary)} s beside the runs "
          f"{', '.join(f'{summary[t]['s']:.1f}' for t in summary)} s); worst relative "
          f"differences: loss {worst[0]:.3g}, grad norm {worst[1]:.3g}", flush=True)
    return dict(total), dict(phase_s=phase_s, backend=backend, runs=summary, worst=worst)


def gspmd_argv(data, out, steps, dev, *extra):
    """train-gspmd's command line: the cli phase's (the alpaca file, 2 x 512
    a micro-batch, 2 a step) with full finetuning (bits 16), MESH_SAMPLES
    training examples, a checkpoint only at the end, no eval."""
    return cli_argv(data, out, steps, dev, "--full_finetune", "--bits", "16",
                    "--learning_rate", str(GSPMD_LR), "--max_train_samples", str(MESH_SAMPLES),
                    "--save_steps", "1000", "--do_eval", "false", *extra)


def gspmd_model(dev):
    """train-gspmd's model (LLaMA-7B width, GSPMD_LAYERS layers, dense bf16
    from GSPMD_SEED) made on the card and held on the host: every process
    makes the same, and a mesh run's parent only cuts it."""
    from qlora_tpu_torch.lora import LoraConfig
    from qlora_tpu_torch.models import init_params
    from qlora_tpu_torch.train.optimizer import tree_map
    from qlora_tpu_torch.utils.testing import FakeTokenizer

    cfg = seven_b(GSPMD_LAYERS)
    params = tree_map(lambda t: t.cpu(), init_params(cfg, seed=GSPMD_SEED, quantized=False,
                                                     device=dev))
    gc_cuda()
    return params, None, cfg, LoraConfig(), FakeTokenizer()


def gspmd_hook(event, ctx):
    """train-gspmd's probe in every rank of a ``cli.train`` GSPMD run: the
    rank's trainable and optimizer bytes, its launches and peak over the
    loop, and after each step the number of tensors whose bits differ from
    rank 0's (whole tensors: the norms) or from their dp replica's at d = 0
    (shards), digests gathered and compared."""
    import torch

    from qlora_tpu_torch.parallel.megatron_step import spec_leaves
    from qlora_tpu_torch.parallel.mesh import param_specs
    from qlora_tpu_torch.train.optimizer import tree_leaves

    rep, mesh, state = ctx["report"], ctx["mesh"], ctx["state"]
    dev = mesh.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    if event == "start":
        sync()
        rep.update(rank=mesh.rank, device=str(dev), backend=mesh.backend,
                   trainable_bytes=tree_bytes(state.trainable),
                   opt_bytes=tree_bytes(state.opt_state), differing=[])
        reset_counts()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        rep["entered"], rep["started"] = ctx["entered"], time.time()
        return
    if event == "step":
        leaves = tree_leaves(state.trainable)
        whole = [d is None for d in spec_leaves(state.trainable, param_specs(state.trainable))]
        mine = torch.stack([tensor_digest(t) for t in leaves])
        every = mesh.world.all_gather(mine[None], dim=0)          # [world, leaves, 2]
        replicas = mesh.dp.all_gather(mine[None], dim=0)          # [dp, leaves, 2]
        differ = sum(int((every[:, j] != every[0, j]).any(-1).sum()) if w else
                     int((replicas[:, j] != replicas[0, j]).any(-1).sum())
                     for j, w in enumerate(whole))
        rep["differing"].append(differ)
        rep["n_whole"] = sum(whole)
        return
    sync()
    rep["ended"] = time.time()
    rep["counts"] = read_counts()
    rep["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2 ** 30 if dev.type == "cuda"
                       else 0.0)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def gspmd_host_main(dev, spec_path):
    """``chip_smoke.py gspmd-host <spec>``: one process of train-gspmd's run
    2 (a host): the model from the seed, then ``cli.train`` with the
    spec's argv over its ranks (gloo on the card); its metrics and its ranks'
    reports pickled where the spec says."""
    import pickle

    from qlora_tpu_torch import cli

    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    m = cli.train(cli.parse_args(spec["argv"]), ranks=spec["ranks"], model=gspmd_model(dev),
                  hook=gspmd_hook)
    with open(spec["out"], "wb") as f:
        pickle.dump(m, f)
    return 0


def gspmd_single_card(args, model, dev):
    """The single card's ``mode="full"`` steps of the CLI's run for `args`:
    its data stream, optimizer, step and generator (``cli``'s own helpers),
    without the CLI's checkpoint (10 GB at 4 layers).  Returns its
    ``train_metrics``."""
    import torch

    from qlora_tpu_torch import cli
    from qlora_tpu_torch.train import init_train_state, make_train_step

    params, _, cfg, lcfg, tok = model
    optimizer = cli._make_optimizer(args)
    state = init_train_state(params, optimizer, device=dev)
    step = make_train_step(cfg, lcfg, optimizer, accum_steps=args.gradient_accumulation_steps,
                           mode="full", remat=cli._remat(args), device=dev)
    train_ds, _ = cli._datasets(args, False)
    batches = cli._batches(args, train_ds, cli._collator(args, tok), tok, 0)
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    metrics = []
    for i in range(args.max_steps):
        t0 = time.perf_counter()
        state, m = step(state, None, next(batches), generator)
        metrics.append({"step": i + 1, "loss": float(m["loss"]),
                        "grad_norm": float(m["grad_norm"]),
                        "seconds_per_step": time.perf_counter() - t0})
    return {"train_metrics": metrics}


def gspmd_hosts(argv, n_procs, ranks_of, tmp):
    """Run `argv` as `n_procs` processes (``chip_smoke.py gspmd-host``),
    process i's ranks on ``ranks_of(i)`` (backend, devices), joined through
    a coordinator on a free local port; each one's metrics, in process
    order.  A process that fails ends the others."""
    import os
    import pickle
    import signal

    port = free_port()
    procs, outs = [], []
    try:
        for i in range(n_procs):
            spec, out = Path(tmp) / f"host{i}.pkl", Path(tmp) / f"host{i}.out.pkl"
            flags = ["--coordinator_address", f"localhost:{port}", "--num_processes",
                     str(n_procs), "--process_id", str(i)]
            with open(spec, "wb") as f:
                pickle.dump(dict(argv=argv + flags, ranks=ranks_of(i), out=str(out)), f)
            procs.append(subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                           "gspmd-host", str(spec)], process_group=0))
            outs.append(out)
        while any(p.poll() is None for p in procs):
            bad = [p for p in procs if p.poll() not in (None, 0)]
            if bad:
                fail(f"train-gspmd: a host process exited with code {bad[0].returncode}")
            time.sleep(0.5)
        if any(p.returncode != 0 for p in procs):
            fail(f"train-gspmd: host processes exited with {[p.returncode for p in procs]}")
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    results = []
    for o in outs:
        with open(o, "rb") as f:
            results.append(pickle.load(f))
    return results


def train_gspmd_phase(dev, card=""):
    """train-gspmd: full finetuning on a mesh (``--full_finetune --bits
    16``, the GSPMD step) through ``cli.train`` at LLaMA-7B width,
    GSPMD_LAYERS layers of dense bf16 weights from GSPMD_SEED, the cli
    phase's alpaca file and micro-batches (2 x 512, 2 a step), AdamW
    (f32 moments), GSPMD_STEPS steps a run.  Run 1: (dp, fsdp, tp) = (1, 2,
    2), four gloo ranks on the card; its checkpoint then resumed on the
    single card for one step.  Run 2: (2, 1, 2) as two processes of two
    ranks each (a host's parent and its ranks), each building the model
    from the seed, joined through a coordinator on a local port.  Each run
    against the single card's steps on the same weights and stream (the
    CLI's data, optimizer and step, its loop without the checkpoint): each
    step's loss within MESH_LOSS_RTOL and grad norm within MESH_GNORM_RTOL
    relative; on every rank after every step whole tensors bit-equal to
    rank 0's and shards to their dp replica's; each rank's trainable and
    optimizer bytes ~1/(fsdp·tp) of the single card's; rank 0's flash
    launches exact, no qmm (dense).  Returns (rank 0's launch counts over
    both runs, stats)."""
    import os
    import tempfile

    import torch

    from qlora_tpu_torch import cli
    from qlora_tpu_torch.train.optimizer import tree_leaves

    tag = "train-gspmd"
    t_phase = time.perf_counter()
    # one card: gloo ranks sharing it; four: NCCL, a card a rank (run 2's
    # second process on the second pair)
    four = torch.cuda.device_count() >= 4 if dev.type == "cuda" else False
    one = str(dev) if dev.type != "cuda" else "cuda:0"
    local = lambda n, first=0: (("nccl", [f"cuda:{first + r}" for r in range(n)]) if four
                                else ("gloo", [one] * n))
    L = GSPMD_LAYERS
    stats = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = str(Path(tmp) / "alpaca.jsonl")
        alpaca_jsonl(data, DATA_EXAMPLES, seed=51)
        out = lambda t: str(Path(tmp) / t)
        t0 = time.perf_counter()
        model = gspmd_model(dev)
        params = model[0]
        n_params = sum(t.numel() for t in tree_leaves(params))
        whole_bytes = tree_bytes(params)
        opt_whole = 8 * n_params           # AdamW's f32 mu and nu on the single card
        stats["build_s"] = time.perf_counter() - t0
        print(f"{tag}: LLaMA-7B width, {L} layers, dense bf16 ({n_params / 1e9:.3f} B "
              f"parameters, {whole_bytes / 2 ** 30:.2f} GiB; AdamW's moments "
              f"{opt_whole / 2 ** 30:.2f} GiB), made in {stats['build_s']:.1f} s", flush=True)

        def run(t, fn):
            t0, called = time.perf_counter(), time.time()
            m = fn()
            torch.cuda.synchronize()
            stats[f"{t}_s"] = time.perf_counter() - t0
            where = loop_times(m, called, stats[f"{t}_s"]) if isinstance(m, dict) else ""
            gc_cuda()
            print(f"{tag} {t}: {stats[f'{t}_s']:.1f} s{where}", flush=True)
            return m

        # one run at a time: beside the single card's run, run 1's gloo ranks
        # wait for the card's time slices longer than the single card takes
        # (107.4 s together against 21.1 + 64.6 s apart on one H100)
        # the single card, one step further: the step run 1's checkpoint resumes to
        ref = run("ref", lambda: gspmd_single_card(
            cli.parse_args(gspmd_argv(data, out("ref"), GSPMD_STEPS + 1, dev)), model, dev))
        run1 = run("run1", lambda: cli.train(
            cli.parse_args(gspmd_argv(data, out("run1"), GSPMD_STEPS, dev, "--mesh_fsdp", "2",
                                      "--mesh_tp", "2")),
            ranks=local(4), model=model, hook=gspmd_hook))
        hosts = run("run2", lambda: gspmd_hosts(
            gspmd_argv(data, out("run2"), GSPMD_STEPS, dev, "--mesh_dp", "2", "--mesh_tp", "2"),
            2, lambda i: local(2, 2 * i), tmp))
        run2 = dict(hosts[0], mesh_report=hosts[0]["mesh_report"] + hosts[1]["mesh_report"])
        if hosts[1].get("process") != 1 or "train_metrics" in hosts[1]:
            fail(f"{tag} run 2: process 1 returned {sorted(hosts[1])}")
        if not os.path.exists(Path(out("run2")) / f"checkpoint-{GSPMD_STEPS}"):
            fail(f"{tag} run 2: process 0 wrote no checkpoint")
        # run 1's checkpoint on the single card for one more step
        os.remove(Path(out("run1")) / "completed")
        res1 = run("resume", lambda: cli.train(
            cli.parse_args(gspmd_argv(data, out("run1"), GSPMD_STEPS + 1, dev)), model=model))
        del model, params
        gc_cuda()

    ref_two = dict(ref, train_metrics=ref["train_metrics"][:GSPMD_STEPS])
    d1 = mesh_agree("run 1 (1 x 2 x 2, then resumed on the single card)",
                    dict(run1, train_metrics=run1["train_metrics"] + res1["train_metrics"]),
                    ref, falls=False, phase=tag)
    d2 = mesh_agree("run 2 (2 x 1 x 2, two processes)", run2, ref_two, falls=False, phase=tag)
    losses = [h["loss"] for h in ref["train_metrics"]]
    if not losses[-1] < losses[0]:
        fail(f"{tag}: the single card's loss did not fall ({losses})")
    if [h["step"] for h in res1["train_metrics"]] != [GSPMD_STEPS + 1]:
        fail(f"{tag}: the resumed run logged steps {res1['train_metrics']}")
    per_step = train_counts(L, remat="full", mode="full")
    want = expected_counts(**{k: GSPMD_STEPS * v for k, v in per_step.items() if v})
    total = collections.Counter()
    summary = {}
    for t, m, (dp, F, T) in (("run 1", run1, GSPMD_RUNS[0][1]), ("run 2", run2, GSPMD_RUNS[1][1])):
        reps = sorted(m["mesh_report"], key=lambda r: r["rank"])
        r0 = reps[0]
        total.update(r0["counts"])
        if [r["rank"] for r in reps] != list(range(dp * F * T)):
            fail(f"{tag} {t}: reports from ranks {[r['rank'] for r in reps]}")
        if r0["counts"] != want:
            fail(f"{tag} {t}: rank 0's launches {r0['counts']} != {want}")
        bad = [(r["rank"], r["differing"]) for r in reps if any(r["differing"])]
        if bad or len(r0["differing"]) != GSPMD_STEPS:
            fail(f"{tag} {t}: tensors differing from their replicas (rank, per step): {bad}")
        shares = [r["trainable_bytes"] / whole_bytes for r in reps]
        opt_shares = [r["opt_bytes"] / opt_whole for r in reps]
        frac = F * T
        if any(not 0.99 / frac <= x <= 1.03 / frac for x in shares + opt_shares):
            fail(f"{tag} {t}: the ranks' trainable shares {shares} or optimizer shares "
                 f"{opt_shares} are not about 1/{frac}")
        secs = [h["seconds_per_step"] for h in m["train_metrics"]]
        summary[t] = dict(step_s=secs, peak_gib=[r["peak_gib"] for r in reps], shares=shares,
                          opt_shares=opt_shares, s=stats[t.replace(" ", "") + "_s"])
        print(f"{tag} {t} ((dp, fsdp, tp) = {(dp, F, T)}, "
              f"{'two processes of two ranks' if t == 'run 2' else 'one process'}, "
              f"{r0['backend']}): seconds a step on rank 0's host clock "
              f"{', '.join(f'{x:.3f}' for x in secs)}; trainable a rank "
              f"{', '.join(f'{x:.4f}' for x in shares)} of the model's "
              f"{whole_bytes / 2 ** 30:.3f} GiB, optimizer state "
              f"{', '.join(f'{x:.4f}' for x in opt_shares)} of the single card's "
              f"{opt_whole / 2 ** 30:.3f} GiB; peak a rank "
              f"{', '.join(f'{x:.2f}' for x in summary[t]['peak_gib'])} GiB; {r0['n_whole']} "
              f"whole tensors bit-equal on every rank and shards on their dp replicas after "
              f"every step; rank 0's launches {dict((k, v) for k, v in r0['counts'].items() if v)}",
              flush=True)
    phase_s = time.perf_counter() - t_phase
    print(f"{tag} ({card}): phase {phase_s:.1f} s (model made in {stats['build_s']:.1f} s; the "
          f"single card {stats['ref_s']:.1f} s, run 1 {stats['run1_s']:.1f} s, run 2 "
          f"{stats['run2_s']:.1f} s, resumed {stats['resume_s']:.1f} s); the single card's steps "
          f"{', '.join(f'{h['seconds_per_step']:.3f}' for h in ref['train_metrics'])} s; worst "
          f"relative differences: loss {max(d1[0], d2[0]):.3g}, grad norm "
          f"{max(d1[1], d2[1]):.3g}", flush=True)
    return dict(total), dict(phase_s=phase_s, runs=summary,
                             worst=(max(d1[0], d2[0]), max(d1[1], d2[1])))


def dryrun_probe(event, name):
    """dryrun's probe in every rank: the launch counters zeroed before each
    path and read after it (the nonzero ones)."""
    if event == "start":
        reset_counts()
        return None
    return {k: v for k, v in read_counts().items() if v}


def dryrun_phase(dev, card=""):
    """dryrun: ``dryrun_multichip(4)`` on the card (four gloo ranks sharing
    it, one world): every path JAX's dry run takes at n = 4, in order, each
    launching kernels on rank 0.  Returns (each path's launches on rank 0,
    stats)."""
    from qlora_tpu_torch.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    out = dryrun_multichip(4, dev, probe=dryrun_probe, verbose=False)
    lines = out[0]
    names = tuple(name for name, *_ in lines)
    if names != DRYRUN_PATHS:
        fail(f"dryrun: paths {names} != {DRYRUN_PATHS}")
    by_path = {}
    for name, line, secs, counts in lines:
        print(f"dryrun_multichip OK ({line} [{secs:.2f} s; rank 0's launches {counts}]",
              flush=True)
        if not counts:
            fail(f"dryrun {name}: no kernel launched on rank 0")
        by_path[name] = counts
    phase_s = time.perf_counter() - t0
    print(f"dryrun ({card}): {len(lines)} paths in one world of 4 gloo ranks on the card, "
          f"{phase_s:.1f} s", flush=True)
    total = collections.Counter()
    for counts in by_path.values():
        total.update(counts)
    return dict(total), dict(phase_s=phase_s, paths=by_path)


@contextlib.contextmanager
def search_trace(keep=True, force=None):
    """Record what the search and speculation loops decide on, by wrapping
    the model forward in the generation modules and the loops' helpers:
    each forward's input tokens, its logits on the host (a decode step's
    last position, all positions otherwise) and its hidden states where it
    returns them; the beams' sources; each ``_top_k`` call's sorted values
    (one more than it returns), its indices and the forward it follows; and
    each contrastive step's degeneration scores.  With `force` (the trace of
    another run on the same prompts), every ``_top_k`` call and every score
    returns that run's values instead of its own, so this run takes the
    other's decisions and records its own beside them.  Without `keep` it
    records only what a timed run needs: the number of forwards, and the
    host time, after a synchronize, at which the loop's first forward
    starts (its prefill is the first forward); nothing else waits on the
    card or copies.  Launches stay counted by the wrappers."""
    import torch

    import qlora_tpu_torch.generate.engine as engine
    import qlora_tpu_torch.generate.search as search
    import qlora_tpu_torch.generate.speculative as speculative

    tr = {"fwd": [], "srcs": [], "topk": [], "score": [], "t_loop": None}
    saved = [(m, n, getattr(m, n)) for m, n in (
        (engine, "forward"), (search, "forward"), (speculative, "forward"),
        (search, "_reorder_beams"), (search, "_top_k"), (search, "_degeneration_scores"))]
    real_fwd, real_reorder, real_top_k, real_scores = (f for _, _, f in saved[2:])

    def forward(params, lora, ids, *a, **kw):
        if len(tr["fwd"]) == 1:
            torch.cuda.synchronize()
            tr["t_loop"] = time.perf_counter()
        out = real_fwd(params, lora, ids, *a, **kw)
        if not keep:
            tr["fwd"].append(None)
            return out
        last = ids.shape[1] == 1
        rec = {"ids": ids.cpu(), "logits": (out[0][:, 0] if last else out[0]).float().cpu()}
        if len(out) == 3:
            rec["hidden"] = (out[2][:, 0] if last else out[2]).float().cpu()
        tr["fwd"].append(rec)
        return out

    def reorder(cache, gather_rows, *a):
        tr["srcs"].append(gather_rows.cpu())
        return real_reorder(cache, gather_rows, *a)

    def top_k(x, n):
        v, i = real_top_k(x, n + 1)
        tr["topk"].append({"v": v.cpu(), "i": i[:, :n].cpu(), "cont": x.shape[-1] == 2 * n,
                           "fwd": len(tr["fwd"]) - 1})
        if force is None:
            return v[:, :n], i[:, :n]
        f = force["topk"][len(tr["topk"]) - 1]
        return f["v"][:, :n].to(x.device, x.dtype), f["i"].to(x.device)

    def scores(*a):
        s = real_scores(*a)
        tr["score"].append(s.cpu())
        return s if force is None else force["score"][len(tr["score"]) - 1].to(s.device)

    wrapped = (forward, forward, forward) + ((reorder, top_k, scores) if keep else ())
    for (m, n, _), f in zip(saved, wrapped):
        setattr(m, n, f)
    try:
        yield tr
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def step_logits(tr, i, lengths):
    """The logits forward `i` of a trace decided on: a prompt's at each
    row's last token, a decode step's as recorded."""
    import torch

    x = tr["fwd"][i]["logits"]
    return x[torch.arange(len(lengths)), lengths.long() - 1] if x.ndim == 3 else x


def forced_agreement(tag, ref, card, lengths):
    """Hold a run forced along `ref`'s decisions (``search_trace(force=)``)
    to `ref`: the same inputs at every forward, so every forward's logits
    within LOGIT_TOL of ref's (their largest difference d) and its hidden
    states, where it returns them, within HIDDEN_TOL as unit vectors (their
    largest distance dh, at each row's positions inside its prompt); and the
    decisions the run would have taken itself equal to ref's wherever ref's
    margin is clear of the rounding: each ``_top_k`` rank (a beam's
    candidate scores, the prior scores being ref's, each off by at most
    2 d; contrastive's candidates by log-probability, the same) up to a
    row's first gap within 4 d; and contrastive's scores, whose
    probabilities are ref's (forced) and whose cosines are each off by at
    most 2 dh, so the scores by at most 2 α dh: each pick whose best two
    differ by more than twice the largest score difference ds, and at least
    one such pick.  Returns (decisions compared, worst logit difference,
    forwards)."""
    import torch

    if len(ref["fwd"]) != len(card["fwd"]) or len(ref["topk"]) != len(card["topk"]):
        fail(f"{tag}: the forced run took {len(card['fwd'])} forwards, the reference "
             f"{len(ref['fwd'])}")
    d, dh = [], 0.0
    unit = lambda h: h / h.norm(dim=-1, keepdim=True)
    for i, (a, b) in enumerate(zip(ref["fwd"], card["fwd"])):
        if not torch.equal(a["ids"], b["ids"]):
            fail(f"{tag}: forward {i}'s inputs differ in the forced run")
        d.append((step_logits(ref, i, lengths) - step_logits(card, i, lengths)).abs().max().item())
        if ("hidden" in a) != ("hidden" in b):
            fail(f"{tag}: forward {i} returned hidden states in one run only")
        if "hidden" in a:
            dist = (unit(a["hidden"]) - unit(b["hidden"])).norm(dim=-1)
            if dist.ndim == 2:                 # a prompt's: its rows' positions inside it
                dist = dist[torch.arange(dist.shape[1])[None, :] < lengths[:, None]]
            dh = max(dh, dist.max().item())
    if max(d) > LOGIT_TOL:
        fail(f"{tag}: logits differ by {max(d)} > {LOGIT_TOL} on the same inputs")
    if dh > HIDDEN_TOL:
        fail(f"{tag}: hidden states differ by {dh} > {HIDDEN_TOL} as unit vectors")
    compared = 0
    for ca, cb in zip(ref["topk"], card["topk"]):
        v = ca["v"].log() if ref["score"] else ca["v"]     # contrastive: probabilities
        gaps = v[:, :-1] - v[:, 1:]
        for r in range(v.shape[0]):
            for p in range(ca["i"].shape[1]):
                if gaps[r, p] <= 4 * d[ca["fwd"]]:
                    break
                if int(cb["i"][r, p]) != int(ca["i"][r, p]):
                    fail(f"{tag}: a candidate ranked {p} differs at a margin {gaps[r, p]:.4g} "
                         f"> {4 * d[ca['fwd']]:.4g}")
                compared += 1
    if ref["score"]:
        ds = max((sa - sb).abs().max().item() for sa, sb in zip(ref["score"], card["score"]))
        bound = 2 * CONTRASTIVE_ALPHA * dh + 1e-5      # + f32 rounding of the scores
        if ds > bound:
            fail(f"{tag}: degeneration scores differ by {ds:.4g} > 2 α dh = {bound:.4g}")
        clear_picks = 0
        for sa, sb in zip(ref["score"], card["score"]):
            top2 = sa.topk(2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > 2 * ds
            if not torch.equal(sa.argmax(1)[clear], sb.argmax(1)[clear]):
                fail(f"{tag}: a contrastive pick differs at a clear margin")
            clear_picks += int(clear.sum())
        if not clear_picks:
            fail(f"{tag}: no contrastive pick was clear of twice the score difference {ds:.4g}")
        compared += clear_picks
        print(f"{tag}: hidden states within {dh:.4g} <= {HIDDEN_TOL} as unit vectors, scores "
              f"within {ds:.4g} <= 2 α dh; {clear_picks} of "
              f"{sum(len(sa) for sa in ref['score'])} picks clear", flush=True)
    return compared, max(d), len(d)


def beam_agreement(tag, ref, other, lengths, G, tol):
    """Hold two free-running beam searches on the same prompts (paged
    against contiguous) to one another step by step: while every decision
    so far was alike, both runs saw the same inputs, so each step's logits
    must agree within `tol`, and their largest difference d bounds how far a
    candidate's score (a sum of log-probabilities, each off by at most 2 d)
    can have moved; a step's decision (the kg-th against the (kg+1)-th
    continuing candidate of each group) is then taken alike unless its
    margin is within twice that bound: up to the first such step the
    sources and tokens must be equal, and if there is none, nor at the final
    choice, so must the outputs.  Returns (steps decided alike and checked,
    worst logit difference, final score bound)."""
    import torch

    T = len(ref["srcs"])
    cont = [c["v"] for c in ref["topk"] if c["cont"]]
    bound, worst = 0.0, 0.0
    for t in range(T):
        d = (step_logits(ref, t, lengths) - step_logits(other, t, lengths)).abs().max().item()
        worst = max(worst, d)
        if d > tol:
            fail(f"{tag}: step {t}'s logits differ by {d} > {tol} on the same inputs")
        bound += 2 * d
        kg = cont[t * G].shape[-1] - 1
        margin = min((v[:, kg - 1] - v[:, kg]).min().item() for v in cont[t * G:(t + 1) * G])
        if bound > 0 and margin <= 2 * bound:     # equal values break alike
            return t, worst, bound
        if not (torch.equal(ref["srcs"][t], other["srcs"][t])
                and torch.equal(ref["fwd"][t + 1]["ids"], other["fwd"][t + 1]["ids"])):
            fail(f"{tag}: step {t}'s beams differ with a deciding margin {margin:.4g} > "
                 f"{2 * bound:.4g}")
    last = torch.cat([v[:, :-1] for v in cont[-G:]], 1).sort(-1, descending=True).values
    tied = bound > 0 and (last[:, 0] - last[:, 1]).min().item() <= 2 * bound
    return (T - 1 if tied else T), worst, bound


def position_logits(tr, lengths, budget, draft=None):
    """For each row, the logits that decided each of its `budget` greedy
    tokens: ``generate``'s (the prompt's last, then each decode step's) or,
    with `draft`, a speculative run's (the prompt's last, then each verify
    chunk's first accepted positions, the acceptance replayed from the
    chunk's inputs and logits as the loop takes it)."""
    import torch

    B = len(lengths)
    per = [[row] for row in step_logits(tr, 0, lengths)]
    for f in tr["fwd"][1:]:
        if draft is None:
            for b in range(B):
                per[b].append(f["logits"][b])
            continue
        toks = f["logits"].argmax(-1)
        for b in range(B):
            acc = 0
            while acc < draft and int(f["ids"][b, acc + 1]) == int(toks[b, acc]):
                acc += 1
            per[b].extend(f["logits"][b, :max(0, min(acc + 1, budget - len(per[b])))])
    return [torch.stack(p[:budget]) for p in per]


def token_agreement(tag, ref_toks, ref_pos, toks, pos, tol):
    """Greedy tokens of two runs (rows of ref_toks / toks, the logits that
    decided each in ref_pos / pos) held position by position: while every
    token so far was alike both saw the same context, so the logits must
    agree within `tol`; a token is decided alike unless ref's top-2 margin
    is within twice their difference.  Returns (tokens compared before each
    row's first such position, worst logit difference)."""
    compared, worst = 0, 0.0
    for b in range(len(ref_pos)):
        for p in range(len(ref_pos[b])):
            d = (ref_pos[b][p] - pos[b][p]).abs().max().item()
            worst = max(worst, d)
            if d > tol:
                fail(f"{tag}: row {b} position {p}'s logits differ by {d} > {tol}")
            top2 = ref_pos[b][p].topk(2).values
            if top2[0] - top2[1] <= 2 * d:
                break
            if int(ref_toks[b][p]) != int(toks[b][p]):
                fail(f"{tag}: row {b} position {p} differs at a margin "
                     f"{(top2[0] - top2[1]).item():.4g} > {2 * d:.4g}")
            compared += 1
    return compared, worst


def search_parity(dev):
    """search's first part: LLaMA-7B width, 2 layers, the same weights on
    the CPU's plain path and on the card.  Beam search (paged, pages of 16),
    group beam search (k 4, G 2, diversity 0.5) and contrastive search (α
    0.6, top-k 4) on two prompts of unequal lengths, the card forced along
    the CPU's decisions: every forward's logits within LOGIT_TOL, and every
    decision the card takes itself equal to the CPU's where the CPU's margin
    is clear of the measured rounding (:func:`forced_agreement`).  Greedy
    speculation (8 drafts) free-running on both, tokens held position by
    position (:func:`token_agreement`), the chunk count equal where every
    token was compared.  Returns its lines' numbers."""
    import torch

    from qlora_tpu_torch.generate import (
        beam_search, contrastive_search, generate_speculative, group_beam_search,
    )
    from qlora_tpu_torch.models import init_params
    from qlora_tpu_torch.utils import move_to

    cfg = seven_b(num_layers=2)
    p_gpu = init_params(cfg, seed=1, device=dev)
    lora_gpu, lcfg = random_lora(cfg, dev, seed=2)
    p_cpu, lora_cpu = move_to(p_gpu, "cpu"), move_to(lora_gpu, "cpu")
    lens = SEARCH_PARITY[:2]
    ids, lengths = padded_requests(lens, max(lens), cfg.vocab_size, 3)
    new, spec_new = SEARCH_PARITY[2:]
    kw = dict(max_new_tokens=new, eos_id=-1)
    runs = {
        "beam": lambda p, lo, d: beam_search(p, lo, ids, lengths, cfg, lcfg,
                                             num_beams=SEARCH_BEAMS, page_size=SEARCH_PAGE,
                                             device=d, **kw),
        "group-beam": lambda p, lo, d: group_beam_search(
            p, lo, ids, lengths, cfg, lcfg, num_beams=SEARCH_BEAMS, num_beam_groups=SEARCH_GROUPS,
            diversity_penalty=SEARCH_DIVERSITY, page_size=SEARCH_PAGE, device=d, **kw),
        "contrastive": lambda p, lo, d: contrastive_search(
            p, lo, ids, lengths, cfg, lcfg, top_k=CONTRASTIVE_K, penalty_alpha=CONTRASTIVE_ALPHA,
            device=d, **kw),
    }
    lines = {}
    for name, run in runs.items():
        t0 = time.perf_counter()
        with search_trace() as ref:
            want = run(p_cpu, lora_cpu, "cpu")
        with search_trace(force=ref) as card:
            got = run(p_gpu, lora_gpu, dev).cpu()
        if not torch.equal(got, want):
            fail(f"search-parity {name}: the card, forced along the CPU's decisions, "
                 "returned other tokens")
        compared, worst, n_fwd = forced_agreement(f"search-parity {name}", ref, card, lengths)
        lines[name] = dict(compared=compared, worst=worst, forwards=n_fwd)
        print(f"search-parity {name}: the card forced along the CPU's decisions: logits within "
              f"{LOGIT_TOL} at all {n_fwd} forwards (worst max|d| {worst:.4g}); {compared} "
              f"decisions the card took itself clear of the measured rounding, all the CPU's; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    out = []
    for p, lo, d in ((p_cpu, lora_cpu, "cpu"), (p_gpu, lora_gpu, dev)):
        with search_trace() as tr:
            toks, st = generate_speculative(p, lo, ids, lengths, cfg, lcfg,
                                            max_new_tokens=spec_new, eos_id=-1,
                                            draft_len=SEARCH_DRAFT, with_stats=True, device=d)
        out.append((toks.cpu(), st, position_logits(tr, lengths, spec_new, SEARCH_DRAFT)))
    (want, st_cpu, pos_cpu), (got, st_card, pos_card) = out
    compared, worst = token_agreement("search-parity speculation", want, pos_cpu, got, pos_card,
                                      LOGIT_TOL)
    if compared == want.numel() and st_cpu != st_card:
        fail(f"search-parity speculation: chunks {st_card} on the card, {st_cpu} on the CPU")
    lines["speculation"] = dict(compared=compared, tokens=want.numel(), worst=worst,
                                chunks=st_card["chunks"])
    print(f"search-parity speculation (greedy, {SEARCH_DRAFT} drafts): {compared} of "
          f"{want.numel()} tokens decided clear of the measured rounding (worst max|d| "
          f"{worst:.4g}), all equal; chunks card {st_card['chunks']}, CPU {st_cpu['chunks']}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del p_gpu, p_cpu, lora_gpu, lora_cpu
    torch.cuda.empty_cache()
    return lines


def same_result(a, b) -> bool:
    """Two results of an entry point equal bit for bit (tensors, the stats
    dicts beside them, a stream's token lists)."""
    import torch

    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same_result(x, y) for x, y in zip(a, b))
    return a == b


def search_run(tag, fn, want, trace=False):
    """One counted, timed call of a search or speculation entry point, its
    trace recording only the loop's start, so that nothing in the timed
    window copies to the host or waits on the card: returns (its result,
    counts, stats); fails on other launch counts than `want(result,
    forwards)` gives.  With `trace`, a traced call first, for the checks
    (stats["trace"]), held to the same counts, and its result equal to the
    timed call's bit for bit (the kernels use no atomics).  Stats: the
    loop's host time a step (the prefill, the first forward, excluded), peak
    memory, and the memory the call held above what was resident when it
    started."""
    import torch

    def counted(keep):
        reset_counts()
        with search_trace(keep=keep) as tr:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        counts = read_counts()
        expect = want(out, len(tr["fwd"]) - 1)
        if counts != expect:
            fail(f"{tag}: launch counts {counts} != {expect}")
        return out, counts, tr, t0, t1

    traced = counted(True) if trace else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    out, counts, tr, t0, t1 = counted(False)
    if traced and not same_result(traced[0], out):
        fail(f"{tag}: the traced call and the timed call returned other results")
    peak = torch.cuda.max_memory_allocated()
    steps = len(tr["fwd"]) - 1
    stats = dict(steps=steps, total_s=t1 - t0, prefill_s=tr["t_loop"] - t0,
                 ms_per_step=(t1 - tr["t_loop"]) / steps * 1e3, peak_gib=peak / 2 ** 30,
                 held_gib=(peak - resident) / 2 ** 30, trace=traced and traced[2])
    return out, counts, stats


def search_phase(dev, cfg, params, lora, lcfg, ids, lengths, greedy, dec, serve_stats):
    """search: group (diverse) beam search, contrastive search and single-
    stream speculation at LLaMA-7B full depth on serve's weights: search
    parity first (2 layers, card against CPU); then beams (two of serve's
    prompts, 200 and 97 tokens; 4 beams, 32 tokens) paged (pages of 16, the
    prompt pages shared) and contiguous, held to one another step by step;
    group beams (G 2, diversity 0.5, length_penalty 0.8); contrastive search
    (α 0.6, top-k 4); greedy speculation (8 drafts, 64 tokens) on serve's
    four prompts and on the 97-token one, each equal to serve's greedy
    ``generate()`` up to a row's first near-tie, the stream equal to the
    batch bit for bit, and one run on serve-int8's serving tree held to int8
    ``generate()`` on the same prompt.  Exact launch counts from each loop's
    own step and chunk counts.  Each path timed in a call of its own without
    the trace (:func:`search_run`).  Returns (the launches summed over the
    timed calls, per-path stats)."""
    import torch

    from qlora_tpu_torch.generate import (
        beam_search, contrastive_search, generate, generate_speculative,
        generate_stream_speculative, group_beam_search,
    )
    from qlora_tpu_torch.ops.qmatmul import DECODE_ROWS

    t_phase = time.perf_counter()
    parity = search_parity(dev)
    L, n_lin = cfg.num_layers, 7 * cfg.num_layers
    rows = list(SEARCH_ROWS)
    S = int(lengths[rows].max())
    bids, blens = ids[rows, :S].to(dev), lengths[rows].to(dev)
    B, k, T = len(rows), SEARCH_BEAMS, SEARCH_NEW
    kw = dict(max_new_tokens=T, eos_id=-1, device=dev)

    def nf4(prefill_rows, step_rows, steps):
        """The NF4 forward's counts: a prefill of `prefill_rows` and `steps`
        forwards of `step_rows`, each on the decode kernel up to DECODE_ROWS
        rows and on the wgmma kernel above."""
        calls = ((prefill_rows, 1), (step_rows, steps))
        return dict(qmm_nf4_fwd_dq=n_lin * (steps + 1),
                    qmm_nf4_decode_dq=n_lin * sum(n for m, n in calls if m <= DECODE_ROWS),
                    qmm_nf4_wgmma_dq=n_lin * sum(n for m, n in calls if m > DECODE_ROWS))

    def decode_counts(attention, prefill_rows, split=None):
        def want(out, steps):
            if steps != T:
                fail(f"search: {steps} loop forwards for {T} tokens")
            attn = {attention: L * steps, **({split: L * steps} if split else {})}
            return expected_counts(**nf4(prefill_rows, B * k, steps), **attn)
        return want

    Sp = -(-S // SEARCH_PAGE) * SEARCH_PAGE        # the paged beams' prefill, padded to pages
    paged_want = decode_counts("paged_decode_attention_cuda", B * Sp, "paged_decode_split")
    stats, total = {}, {}
    runs = [
        ("beam", lambda: beam_search(params, lora, bids, blens, cfg, lcfg, num_beams=k,
                                     page_size=SEARCH_PAGE, **kw), paged_want, True),
        ("beam-contiguous", lambda: beam_search(params, lora, bids, blens, cfg, lcfg,
                                                num_beams=k, paged_kv=False, **kw),
         decode_counts("decode_attention_cuda", B * S), True),
        ("group-beam", lambda: group_beam_search(
            params, lora, bids, blens, cfg, lcfg, num_beams=k, num_beam_groups=SEARCH_GROUPS,
            diversity_penalty=SEARCH_DIVERSITY, length_penalty=SEARCH_LP,
            page_size=SEARCH_PAGE, **kw), paged_want, False),
        ("contrastive", lambda: contrastive_search(
            params, lora, bids, blens, cfg, lcfg, top_k=CONTRASTIVE_K,
            penalty_alpha=CONTRASTIVE_ALPHA, **kw), decode_counts("decode_attention_cuda", B * S),
         False),
    ]
    outs = {}
    for name, fn, want, trace in runs:
        outs[name], counts, stats[name] = search_run(f"search {name}", fn, want, trace)
        total = {c: total.get(c, 0) + v for c, v in counts.items()}
        out = outs[name]
        if out.shape != (B, T) or not ((out >= 0) & (out < cfg.vocab_size)).all():
            fail(f"search {name}: tokens out of range or wrong shape {tuple(out.shape)}")
    steps, worst, _ = beam_agreement("search beam paged/contiguous", stats["beam"]["trace"],
                                     stats["beam-contiguous"]["trace"], blens.cpu(), 1,
                                     LOGIT_TOL)
    if steps == T and not torch.equal(outs["beam"], outs["beam-contiguous"]):
        fail("search: paged and contiguous beams differ with every decision clear")
    agree = dict(steps=steps, worst=worst,
                 equal=bool(torch.equal(outs["beam"], outs["beam-contiguous"])))
    print(f"search beam: paged (pages of {SEARCH_PAGE}) against contiguous, {steps} of {T} steps "
          f"decided alike before the first within the measured rounding, worst max|logits| "
          f"difference {worst:.4g}; outputs equal {agree['equal']}", flush=True)

    # speculation: serve's four prompts, then the 97-token one alone, each held
    # to generate()'s greedy tokens on the same prompts (traced here, the same
    # call as serve's: its tokens must be serve's bit for bit)
    n_new = greedy.shape[1]
    spec = dict(max_new_tokens=n_new, eos_id=-1, draft_len=SEARCH_DRAFT, device=dev)
    with search_trace() as tr:
        again = generate(params, lora, ids, lengths, cfg, lcfg, max_new_tokens=n_new, eos_id=-1,
                         device=dev)
    if not torch.equal(again, greedy):
        fail("search: generate() on serve's prompts differs from serve's own call")
    greedy_pos = position_logits(tr, lengths, n_new)
    del tr

    def chunk_counts(prefill_rows, chunk_rows, int8=False):
        def want(out, steps):
            chunks = out[1]["chunks"] if isinstance(out, tuple) else steps
            if chunks != steps:
                fail(f"search: {steps} chunk forwards, {chunks} chunks counted")
            if int8:     # the chunks on qmm_i8_direct, the lm_head too; the prefill exact
                return expected_counts(**nf4(prefill_rows, chunk_rows, 0),
                                       qmm_i8_direct=(n_lin + 1) * steps,
                                       qmm_i8_direct_decode=(n_lin + 1) * steps)
            return expected_counts(**nf4(prefill_rows, chunk_rows, steps))
        return want

    one = SEARCH_ROWS[1]
    n1 = int(lengths[one])
    sid, slen = ids[one:one + 1, :n1].to(dev), lengths[one:one + 1].to(dev)
    k1 = SEARCH_DRAFT + 1
    spec_runs = [
        ("speculation-b4", lambda: generate_speculative(params, lora, ids.to(dev), lengths.to(dev),
                                                        cfg, lcfg, with_stats=True, **spec),
         chunk_counts(ids.numel(), len(lengths) * k1)),
        ("speculation-b1", lambda: generate_speculative(params, lora, sid, slen, cfg, lcfg,
                                                        with_stats=True, **spec),
         chunk_counts(n1, k1)),
        ("stream-b1", lambda: [int(t[0]) for t in generate_stream_speculative(
            params, lora, sid, slen, cfg, lcfg, **spec)], chunk_counts(n1, k1)),
        ("speculation-int8-b1", lambda: generate_speculative(
            params, lora, sid, slen, cfg, lcfg, with_stats=True, decode_impl="int8",
            decode_params=dec, **spec), chunk_counts(n1, k1, int8=True)),
    ]
    for name, fn, want in spec_runs:
        outs[name], counts, stats[name] = search_run(f"search {name}", fn, want,
                                                     trace=name != "stream-b1")
        total = {c: total.get(c, 0) + v for c, v in counts.items()}
    b4, st4 = outs["speculation-b4"]
    b1, st1 = outs["speculation-b1"]
    g_cpu = greedy.cpu()
    compared, worst4 = token_agreement(
        "search speculation-b4", g_cpu, greedy_pos, b4.cpu(),
        position_logits(stats["speculation-b4"]["trace"], lengths, n_new, SEARCH_DRAFT),
        LOGIT_TOL)
    compared1, worst1 = token_agreement(
        "search speculation-b1", g_cpu[one:one + 1], greedy_pos[one:one + 1], b1.cpu(),
        position_logits(stats["speculation-b1"]["trace"], lengths[one:one + 1], n_new,
                        SEARCH_DRAFT), LOGIT_TOL)
    if outs["stream-b1"] != b1[0].tolist():
        fail("search: the stream differs from generate_speculative at B = 1")
    # int8 speculation against int8 generate() on the same prompt: the same
    # per-column int8 copy at 9 rows and at 1 (a row's result the same at any
    # row count, kernels-int8), inputs rounded in other orders by the chunk's
    # attention, each run quantizing its own rows: W8A8_LOGIT_TOL
    i8, st8 = outs["speculation-int8-b1"]
    with search_trace() as tr:
        g8 = generate(params, lora, sid, slen, cfg, lcfg, max_new_tokens=n_new, eos_id=-1,
                      decode_impl="int8", decode_params=dec, device=dev)
    compared8, worst8 = token_agreement(
        "search speculation-int8-b1", g8.cpu(), position_logits(tr, slen.cpu(), n_new), i8.cpu(),
        position_logits(stats["speculation-int8-b1"]["trace"], slen.cpu(), n_new, SEARCH_DRAFT),
        W8A8_LOGIT_TOL)
    del tr
    for name, tokens in (("speculation-b4", b4.numel()), ("speculation-b1", n_new),
                         ("stream-b1", n_new), ("speculation-int8-b1", n_new)):
        stats[name]["tokens_per_chunk"] = tokens / stats[name]["steps"]
    for name in ("beam", "beam-contiguous", "group-beam", "contrastive"):
        stats[name]["tokens_per_chunk"] = B    # a token a row a step: the output rows
    for name, st in stats.items():
        tok = (b4.numel() if name == "speculation-b4" else
               B * T if name in ("beam", "beam-contiguous", "group-beam", "contrastive")
               else n_new)
        st["tok_s"] = tok / (st["steps"] * st["ms_per_step"] / 1e3)
        st.pop("trace")
        print(f"search {name}: {st['steps']} {'steps' if 'beam' in name or name == 'contrastive' else 'chunks'}"
              f", {st['ms_per_step']:.2f} ms a {'step' if 'beam' in name or name == 'contrastive' else 'chunk'} "
              f"(prefill {st['prefill_s'] * 1e3:.1f} ms), {st['tok_s']:.1f} output tok/s, "
              f"{st['tokens_per_chunk']:.3f} tokens a forward; peak {st['peak_gib']:.2f} GiB, "
              f"{st['held_gib']:.2f} GiB above the resident weights", flush=True)
    print(f"search speculation: against generate()'s greedy tokens, {compared} of "
          f"{greedy.numel()} decided clear of the measured rounding (worst max|d| {worst4:.4g}) "
          f"at B = 4 ({st4['chunks']} chunks) and {compared1} of {n_new} at B = 1 (worst "
          f"{worst1:.4g}, {st1['chunks']} chunks), all equal; the stream equal bit for bit; int8 "
          f"against int8 generate() {compared8} of {n_new} (worst {worst8:.4g} <= "
          f"{W8A8_LOGIT_TOL}, {st8['chunks']} chunks), all equal; every timed call without the "
          f"trace, equal to its traced call bit for bit; serve's generate() step "
          f"{serve_stats['decode_ms_per_step']:.2f} ms in this run; search phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    print(f"search: launches { {c: v for c, v in total.items() if v} }", flush=True)
    return total, dict(stats=stats, parity=parity, paged_vs_contiguous=agree,
                       greedy_compared=(compared, compared1, compared8),
                       phase_s=time.perf_counter() - t_phase)


def search_only(dev) -> None:
    """``python3 chip_smoke.py search``: serve's weights, its greedy
    ``generate()`` as the speculation's reference (timed, as serve times
    it), serve-int8's serving tree, then the search phase."""
    import torch

    from qlora_tpu_torch.generate import generate
    from qlora_tpu_torch.generate.serve_int8 import requantize_params_int8_unstacked
    from qlora_tpu_torch.models import init_params

    cfg = seven_b()
    params = init_params(cfg, seed=7, device=dev)
    lora, lcfg = random_lora(cfg, dev, seed=8)
    ids, lengths = padded_requests(SERVE_LENGTHS, max(SERVE_LENGTHS), cfg.vocab_size, 9)
    generate(params, lora, ids[:, :16], torch.full((4,), 16), cfg, lcfg,
             max_new_tokens=2, eos_id=-1, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    greedy = generate(params, lora, ids, lengths, cfg, lcfg, max_new_tokens=SERVE_NEW,
                      eos_id=-1, device=dev)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0 - timed_prefill(dev, cfg, params, lora, lcfg, ids,
                                                        lengths)
    with torch.inference_mode():
        dec = requantize_params_int8_unstacked(params)
    search_phase(dev, cfg, params, lora, lcfg, ids, lengths, greedy, dec,
                 dict(decode_ms_per_step=decode_s / SERVE_NEW * 1e3))


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
                      ":358; M <= 64)"),
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
    # the dx at decode rows (train-parity-few's 16 rows): the dx decode kernels
    "qmm_nf4_bwd_decode": ("qlora_tpu_torch/csrc/qmm_nf4_bwd_decode.cu",
                           "qlora_tpu/ops/qmatmul.py:651 (_qmm_bwd_pallas, pallas_call at :679; "
                           "M <= 16)"),
    "qmm_i8_bwd_decode": ("qlora_tpu_torch/csrc/qmm_i8_bwd_decode.cu",
                          "qlora_tpu/ops/qmatmul.py:475 (_qmm_bwd_pallas_i8, pallas_call at :487; "
                          "M <= 16)"),
}
# the NF4 forward's three sources, by shape (ops/qmatmul.py: DECODE_ROWS, tile_plan)
NF4_SOURCES = {"M <= 16": "qlora_tpu_torch/csrc/qmm_nf4_decode.cu",
               "M > 16": "qlora_tpu_torch/csrc/qmm_nf4_wgmma.cu",
               "M > 16, K % 16 != 0": "qlora_tpu_torch/csrc/qmm_nf4_fwd.cu"}
# the NF4 dx's two sources, by shape (ops/qmatmul.py: nf4_bwd_tile_plan)
NF4_BWD_SOURCES = {"M <= 16": "qlora_tpu_torch/csrc/qmm_nf4_bwd_decode.cu",
                   "M > 16": "qlora_tpu_torch/csrc/qmm_nf4_bwd_wgmma.cu",
                   "M <= 16 and N % 16 != 0, or M > 16 and N % 8 != 0":
                       "qlora_tpu_torch/csrc/qmm_nf4_bwd.cu"}
# the int8 forward's and dx's three sources, by shape (ops/qmatmul.py:
# i8_decode_plan, i8_tile_plan)
I8_SOURCES = {"M <= 16, forward": "qlora_tpu_torch/csrc/qmm_i8_decode.cu",
              "M <= 16, backward": "qlora_tpu_torch/csrc/qmm_i8_bwd_decode.cu",
              "M > 16": "qlora_tpu_torch/csrc/qmm_i8_wgmma.cu",
              "M <= 16 backward and N % 16 != 0, or M > 16 and a contraction % 8 != 0":
                  "qlora_tpu_torch/csrc/qmm_i8.cu"}
# the w8a8 forward's two sources over NF4, by shape (ops/qmatmul.py: w8a8_tile_plan)
W8A8_SOURCES = {"M <= 16": "qlora_tpu_torch/csrc/qmm_nf4_w8a8_decode.cu",
                "M > 16": "qlora_tpu_torch/csrc/qmm_nf4_w8a8_wgmma.cu",
                "M <= 16 and K % 64, N % 16 or the block size % 32 not 0; M > 16 and K % 32, "
                "N % 8 or the block size % 8 not 0": "qlora_tpu_torch/csrc/qmm_i8_direct.cu"}
# the direct int8 w8a8 forward's two sources, by shape (ops/qmatmul.py:
# i8_direct_decode_plan)
I8_DIRECT_SOURCES = {"M <= 64": "qlora_tpu_torch/csrc/qmm_i8_direct_decode.cu",
                     "M > 64, or K % 32 or N % 16 not 0": "qlora_tpu_torch/csrc/qmm_i8_direct.cu"}
# summary entries read from another wrapper's rows, and the rows they keep
# (by the row count in the shape): the int8 forward's decode kernel and its
# wgmma kernel share the rows of qmm_i8_fwd, each dx's decode and wgmma
# kernels the rows of its wrapper
def _rows(shape):
    return int(shape.split()[0][2:]) if shape.startswith("M=") else 0


RESULT_OF = {"qmm_i8_fwd_decode": ("qmm_i8_fwd", lambda s: _rows(s) <= 16),
             "qmm_i8_fwd": ("qmm_i8_fwd", lambda s: _rows(s) > 16),
             "qmm_nf4_bwd_decode": ("qmm_nf4_bwd", lambda s: _rows(s) <= 16),
             "qmm_nf4_bwd": ("qmm_nf4_bwd", lambda s: _rows(s) > 16),
             "qmm_i8_bwd_decode": ("qmm_i8_bwd", lambda s: _rows(s) <= 16),
             "qmm_i8_bwd": ("qmm_i8_bwd", lambda s: _rows(s) > 16),
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
            "paged_chunk_attention_cuda": "B=8 C=5 H=32 KVH=32",
            # a train step's dx at 4 tokens, the decode row count of every other entry
            "qmm_nf4_bwd_decode": "M=4 K=4096 N=4096 dq",
            "qmm_i8_bwd_decode": "M=4 K=4096 N=4096 dq"}


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


def verify_int8_split(results, num_layers, stats):
    """serve-paged-spec-int8's verify forward by kernel: 7 ``qmm_i8_direct``
    launches a layer and the lm_head's at a verify chunk's rows, each at its
    kernel-phase time on the split-K kernel (``ms``; ``wrapper_ms`` with the
    wrapper) and on qmm_i8_direct.cu (``tile_ms``, the "before", rows
    quantized beforehand)."""
    M = PAGED_B * (SPEC_DRAFT + 1)
    rows = {r["shape"]: r for r in results if r["name"] == "qmm_i8_direct"}
    lin = {k: rows[f"M={M} K={k[0]} N={k[1]}"] for k in QMM_SHAPES + (LM_HEAD_SHAPE,)}
    per_forward = lambda key: num_layers * (
        4 * lin[(4096, 4096)][key] + 2 * lin[(4096, 11008)][key]
        + lin[(11008, 4096)][key]) + lin[LM_HEAD_SHAPE][key]
    return dict(step_ms=stats["ms_per_chunk"], qmm_ms=per_forward("ms"),
                qmm_wrapper_ms=per_forward("wrapper_ms"), qmm_before_ms=per_forward("tile_ms"))


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


def serve_spec_int8_only(dev) -> None:
    """``python3 chip_smoke.py serve-paged-spec-int8``: the serve weights and
    serve-paged-spec-int8 alone."""
    import torch

    from qlora_tpu_torch.generate import generate
    from qlora_tpu_torch.models import init_params

    cfg = seven_b()
    params = init_params(cfg, seed=7, device=dev)
    lora, lcfg = random_lora(cfg, dev, seed=8)
    generate(params, lora, torch.randint(3, 200, (4, 16)), torch.full((4,), 16), cfg, lcfg,
             max_new_tokens=2, eos_id=-1, device=dev)
    t0 = time.perf_counter()
    _, stats = serve_paged_spec_int8_phase(dev, cfg, params, lora, lcfg)
    print(f"serve-paged-spec-int8 only: {stats['ms_per_chunk']:.2f} ms a verify step, "
          f"{stats['tokens_per_chunk']:.3f} tokens a chunk, {stats['tok_s']:.1f} tok/s; phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def train_int8_phase(dev):
    """train-int8: train-parity and train over an int8 base.  Returns the
    train phase's (counts, per-step counts, stats)."""
    t0 = time.perf_counter()
    worst = train_parity_phase(dev, "int8")
    counts, per_step, stats, _ = train_phase(dev, "int8", TRAIN_INT8_STEPS)
    print(f"train-int8: worst gradient difference {worst:.4g} <= {GRAD_TOL}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return counts, per_step, stats


def timed_gemma_phase(dev):
    t0 = time.perf_counter()
    out = train_gemma_phase(dev)
    print(f"train-gemma: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


# the phases of the second process (``start_lane``), in its order: host-bound
# single-card phases, and tp, whose ranks wait on their collectives.  The main
# process runs parity to train-data beside them; on the 80 GB card the two
# sequences' peaks (tp's ~22 GiB, train-gemma's 37, the main sequence's 24 at
# most) fit together, while train-mesh (~60 GiB over its eight ranks and the
# single card) and train-full (69 GiB) run alone after both
def parity_int8_seeds(dev):
    """parity-int8 at every seed of PARITY_INT8_SEEDS; the worst readings."""
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
    return worst


def timed_paged_parity(dev):
    t0 = time.perf_counter()
    worst = paged_parity_phase(dev)
    print(f"paged-parity: worst max|d| {worst:.4g} <= {LOGIT_TOL}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return worst


LANE = (("paged-parity", lambda dev, card: timed_paged_parity(dev)),
        ("parity-int8", lambda dev, card: parity_int8_seeds(dev)),
        ("train-parity-few", lambda dev, card: train_parity_few(dev)),
        ("dryrun", lambda dev, card: dryrun_phase(dev, card)),
        ("cli", lambda dev, card: cli_phase(dev, card)),
        ("serve-http", lambda dev, card: serve_http_phase(dev, card)),
        ("examples", lambda dev, card: examples_phase(dev, card)),
        ("tp", lambda dev, card: tp_phase(dev, card)),
        ("train-int8", lambda dev, card: train_int8_phase(dev)),
        ("train-gemma", lambda dev, card: timed_gemma_phase(dev)))


def lane_main(dev, out_path, card):
    """The second process: LANE's phases in order, their results pickled to
    `out_path`.  It leads a process group of its own (its ranks join it) and
    ends that group if its parent goes away."""
    import os
    import pickle
    import signal
    import threading

    parent = os.getppid()

    def watch():
        while True:
            time.sleep(2.0)
            if os.getppid() != parent:
                os.killpg(0, signal.SIGKILL)

    threading.Thread(target=watch, daemon=True).start()
    t0 = time.perf_counter()
    out = {}
    for name, phase in LANE:
        out[name] = phase(dev, card)
        gc_cuda()
    out["lane_s"] = time.perf_counter() - t0
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    return 0


def start_lane(card):
    """Start LANE's phases in a second process (``chip_smoke.py lane``)."""
    import os
    import tempfile

    fd, path = tempfile.mkstemp(prefix="chip_smoke_lane_", suffix=".pkl")
    os.close(fd)
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "lane", path, card],
                            process_group=0)
    return proc, path


def finish_lane(lane):
    """Wait for the second process; its phases' results."""
    import pickle

    proc, path = lane
    rc = proc.wait()
    if rc != 0:
        fail(f"the second process ({', '.join(n for n, _ in LANE)}) exited with code {rc}")
    with open(path, "rb") as f:
        return pickle.load(f)


def stop_lane(lane):
    """End the second process and every process it started, if it still runs."""
    import os
    import signal

    proc, path = lane
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    if os.path.exists(path):
        os.unlink(path)


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
    if sys.argv[1:2] == ["lane"] and len(sys.argv) == 4:    # start_lane's second process
        from qlora_tpu_torch.ops import _build

        _build.build_all()
        return lane_main(dev, sys.argv[2], sys.argv[3])
    if sys.argv[1:2] == ["gspmd-host"] and len(sys.argv) == 3:    # train-gspmd's run 2
        from qlora_tpu_torch.ops import _build

        _build.build_all()
        return gspmd_host_main(dev, sys.argv[2])

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
              "train-gemma": lambda dev: train_gemma_phase(dev),
              "train-data": lambda dev: train_data_phase(dev, card=card),
              "cli": lambda dev: cli_phase(dev, card),
              "search": search_only,
              "serve-paged-spec-int8": serve_spec_int8_only,
              "serve-http": lambda dev: serve_http_phase(dev, card),
              "examples": lambda dev: examples_phase(dev, card),
              "tp": lambda dev: (tp_qmm_phase(dev, []), tp_phase(dev, card)),
              "train-mesh": lambda dev: (tp_qmm_phase(dev, []), train_mesh_phase(dev, card)),
              "train-sp": lambda dev: train_sp_phase(dev, card, (), ring_kernel_phase(dev, [])),
              "train-gspmd": lambda dev: train_gspmd_phase(dev, card),
              "dryrun": lambda dev: dryrun_phase(dev, card)}
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
    tp_qmm_phase(dev, results)
    flash_phase(dev, results)
    chunk_ms = ring_kernel_phase(dev, results)
    gemma_qmm_phase(dev, results)
    print(f"kernels: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    int8_kernel_phase(dev, results)
    print(f"kernels-int8: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    paged_kernel_phase(dev, results)
    print(f"kernels-paged: {time.perf_counter() - t0:.1f} s", flush=True)
    # parity to train-data in this process; LANE's phases in a second one
    # beside them, started once the kernels have been timed on an idle card
    import signal

    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))    # so that stop_lane runs
    t_lanes = time.perf_counter()
    lane = start_lane(card)
    try:
        t0 = time.perf_counter()
        worst = parity_phase(dev)
        print(f"parity: worst max|d| {worst:.4g} <= {LOGIT_TOL}, {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        worst = parity_phase(dev, "int8")
        print(f"parity-i8base: worst max|d| {worst:.4g} <= {LOGIT_TOL}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        (serve_counts, serve_stats, int8_counts, int8_stats,
         (paged_counts, paged_stats, paged8_counts, paged8_stats, pagedw_counts, pagedw_stats),
         (spec_counts, spec_stats), (spec8_counts, spec8_stats),
         (search_counts, search_stats)) = serve_phase(dev)
        print(f"serve, serve-int8, search, serve-paged, serve-paged-spec and -spec-int8: "
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
        print(f"train remat: {time.perf_counter() - t0:.1f} s", flush=True)
        train_data_phase(dev, made, card)
        del made
        torch.cuda.empty_cache()
        main_s = time.perf_counter() - t_lanes
        lane_out = finish_lane(lane)
    finally:
        stop_lane(lane)
    print(f"two processes: this one's phases {main_s:.1f} s, the second's "
          f"({', '.join(n for n, _ in LANE)}) {lane_out['lane_s']:.1f} s, both "
          f"{time.perf_counter() - t_lanes:.1f} s", flush=True)
    dryrun_counts, dryrun_stats = lane_out["dryrun"]
    cli_counts, cli_stats = lane_out["cli"]
    http_counts, http_stats = lane_out["serve-http"]
    examples_counts, examples_stats = lane_out["examples"]
    tp_counts, tp_stats = lane_out["tp"]
    train8_counts, train8_per_step, train8_stats = lane_out["train-int8"]
    gemma_counts, gemma_per_step, gemma_stats = lane_out["train-gemma"]
    few_counts = lane_out["train-parity-few"]
    gc_cuda()
    mesh_counts, mesh_stats = train_mesh_phase(dev, card)
    gc_cuda()
    sp_total, sp_stats = train_sp_phase(dev, card, results, chunk_ms)
    gc_cuda()
    gspmd_total, gspmd_stats = train_gspmd_phase(dev, card)
    gc_cuda()
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
                    flash_bwd_dkv_hd256=gemma_counts["flash_wide_bwd_dkv"],
                    qmm_nf4_bwd_decode=few_counts["nf4"]["qmm_nf4_bwd_decode"],
                    qmm_i8_bwd_decode=few_counts["int8"]["qmm_i8_bwd_decode"])
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
        if entry["name"] == "qmm_nf4_bwd_decode":
            entry.update(sources=NF4_BWD_SOURCES,
                         before_source="qlora_tpu_torch/csrc/qmm_nf4_bwd.cu",
                         decode_launches=few_counts["nf4"]["qmm_nf4_bwd_decode"])
        if entry["name"] == "qmm_i8_bwd_decode":
            entry.update(sources=I8_SOURCES, before_source="qlora_tpu_torch/csrc/qmm_i8.cu",
                         decode_launches=few_counts["int8"]["qmm_i8_bwd_decode"])
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
                         decode_launches=int8_counts["qmm_i8_direct_decode"],
                         decode_launches_serve_paged_spec_int8=spec8_counts[
                             "qmm_i8_direct_decode"])
    for entry in summary:     # the CLI and the endpoint (cli, serve-http), the searches, and
        # the judge, the examples and the converter
        for tag, run in (("cli", cli_counts), ("http", http_counts), ("search", search_counts),
                         ("serve_paged_spec_int8", spec8_counts),
                         ("examples", examples_counts), ("tp", tp_counts),
                         ("train_mesh", mesh_counts), ("train_sp", sp_total),
                         ("train_gspmd", gspmd_total), ("dryrun", dryrun_counts)):
            if run.get(entry["name"]):
                entry[f"launches_{tag}"] = run[entry["name"]]
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
    v8 = verify_int8_split(results, seven_b().num_layers, spec8_stats)
    print(f"serve-paged-spec-int8: verify step {v8['step_ms']:.2f} ms ({spec8_stats['chunks']} "
          f"slot chunks, {spec8_stats['tokens_per_chunk']:.3f} tokens a chunk; "
          f"{spec8_stats['tok_s']:.1f} tok/s over the run), of which the int8 qmm kernels "
          f"~{v8['qmm_ms']:.2f} ms a verify forward on the split-K kernel (with the wrapper "
          f"~{v8['qmm_wrapper_ms']:.2f} ms; on qmm_i8_direct.cu, the before: "
          f"~{v8['qmm_before_ms']:.2f} ms, rows quantized beforehand) at M="
          f"{PAGED_B * (SPEC_DRAFT + 1)} (kernel-phase times x launches); serve-paged-spec's NF4 "
          f"verify step {spec_stats['ms_per_chunk']:.2f} ms in this run", flush=True)
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
    print(f"cli ({card}): {cli_stats['step_s']:.3f} s/step through the driver (run A's steps "
          f"2, 4, 6) against the train cell's {train_stats['step_s']:.3f} in this run; "
          f"serve-http: {http_stats['req_s']:.2f} requests/s, {http_stats['tok_s']:.1f} tok/s "
          f"against {http_stats['direct_tok_s']:.1f} tok/s for a direct PagedBatcher on the same "
          f"prompts and serve-paged's {paged_stats['tok_s']:.1f}; time to first token median "
          f"{http_stats['ttft_ms'][0]:.1f} ms, p90 {http_stats['ttft_ms'][1]:.1f} ms", flush=True)
    ss = search_stats["stats"]
    print(f"search ({card}): ms a step, beams paged {ss['beam']['ms_per_step']:.2f}, "
          f"contiguous {ss['beam-contiguous']['ms_per_step']:.2f}, group beams "
          f"{ss['group-beam']['ms_per_step']:.2f}, contrastive {ss['contrastive']['ms_per_step']:.2f}"
          f"; a verify chunk at B = 4 {ss['speculation-b4']['ms_per_step']:.2f} "
          f"({ss['speculation-b4']['tokens_per_chunk']:.3f} tokens a chunk), at B = 1 "
          f"{ss['speculation-b1']['ms_per_step']:.2f} ({ss['speculation-b1']['tokens_per_chunk']:.3f}"
          f"), int8 {ss['speculation-int8-b1']['ms_per_step']:.2f}; against generate()'s "
          f"{serve_stats['decode_ms_per_step']:.2f} ms a step at B = 4", flush=True)
    es = examples_stats
    print(f"examples ({card}): baseline {es['baseline-lora']['req_s']:.2f} requests/s and "
          f"{es['baseline-lora']['tok_s']:.1f} tok/s on the LoRA engine, "
          f"{es['baseline-base']['req_s']:.2f} and {es['baseline-base']['tok_s']:.1f} on the base; "
          f"judge {es['judge-threeclass']['wall_s']:.2f} s threeclass, "
          f"{es['judge-relative']['wall_s']:.2f} s relative (prompts up to "
          f"{es['judge-relative']['longest']} tokens); converter "
          f"{es['converter']['import_s_per_layer']:.3f} s a layer in process; phase "
          f"{es['phase_s']:.1f} s", flush=True)
    print(f"tp ({card}): {TP} ranks over {tp_stats['backend']}, phase {tp_stats['phase_s']:.1f} "
          f"s; logits against the single card {tp_stats['d_logits']:.4g}, int8 "
          f"{tp_stats['int8_of_exact']:.4g}, every emitted token at most "
          f"{tp_stats['worst_short']:.4g} short of the single card's best; peak a rank "
          f"{max(tp_stats['peak_gib']):.2f} GiB", flush=True)
    ms = mesh_stats["runs"]
    print(f"train-mesh ({card}): 4 ranks over {mesh_stats['backend']}, phase "
          f"{mesh_stats['phase_s']:.1f} s; s a step on rank 0, gather style (1, 2, 2) "
          f"{sum(ms['run 1']['step_s']) / len(ms['run 1']['step_s']):.3f}, Megatron (2, 1, 2) "
          f"{sum(ms['run 2']['step_s']) / len(ms['run 2']['step_s']):.3f}; collectives a step "
          f"{ms['run 1']['n_collectives']} / {ms['run 2']['n_collectives']}; worst relative "
          f"difference from the single card: loss {mesh_stats['worst'][0]:.3g}, grad norm "
          f"{mesh_stats['worst'][1]:.3g}; peak a rank {max(ms['run 1']['peak_gib']):.2f} / "
          f"{max(ms['run 2']['peak_gib']):.2f} GiB", flush=True)
    ss = sp_stats["runs"]
    print(f"train-sp ({card}): 4 ranks over {sp_stats['backend']}, phase "
          f"{sp_stats['phase_s']:.1f} s, S = {SP_SOURCE + SP_TARGET}; s a step on rank 0, "
          f"run 1 (1, 1, 1, 4) {', '.join(f'{x:.2f}' for x in ss['run 1']['step_s'])}, run 2 "
          f"(1, 2, 1, 2) {', '.join(f'{x:.2f}' for x in ss['run 2']['step_s'])}; worst relative "
          f"difference from the single card: loss {sp_stats['worst'][0]:.3g}, grad norm "
          f"{sp_stats['worst'][1]:.3g}; activation peak a rank {max(ss['run 1']['act_gib']):.2f}"
          f" / {max(ss['run 2']['act_gib']):.2f} GiB against the single card's "
          f"{ss['run 1']['ref_act_gib']:.2f} / {ss['run 2']['ref_act_gib']:.2f}", flush=True)
    gs = gspmd_stats["runs"]
    print(f"train-gspmd ({card}): {GSPMD_LAYERS} layers of dense bf16 at LLaMA-7B width, phase "
          f"{gspmd_stats['phase_s']:.1f} s; s a step on rank 0, run 1 (1, 2, 2) "
          f"{', '.join(f'{x:.2f}' for x in gs['run 1']['step_s'])}, run 2 (2, 1, 2, two "
          f"processes) {', '.join(f'{x:.2f}' for x in gs['run 2']['step_s'])}; worst relative "
          f"difference from the single card: loss {gspmd_stats['worst'][0]:.3g}, grad norm "
          f"{gspmd_stats['worst'][1]:.3g}; peak a rank {max(gs['run 1']['peak_gib']):.2f} / "
          f"{max(gs['run 2']['peak_gib']):.2f} GiB; dryrun {dryrun_stats['phase_s']:.1f} s, "
          f"{len(dryrun_stats['paths'])} paths", flush=True)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
