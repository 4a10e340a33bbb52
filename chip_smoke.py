#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (qlora_tpu_torch) on one H100.

Run from the root of a checkout:  python3 chip_smoke.py

It needs one CUDA device and ``nvcc`` (it builds the kernels from
``qlora_tpu_torch/csrc``), and exits nonzero, printing no result, without
them.  Phases, each failing the run on any mismatch or exception:

1. build: the card's name and power limit, then every kernel built for sm_90a.
2. kernels: each CUDA kernel against its plain PyTorch version on the card
   at the LLaMA-7B serving shapes, with its time (CUDA events), the plain
   version's time, one PyTorch library call's time as a yardstick, and the
   least time the card could take (bytes over 3.35 TB/s or operations over
   the peak rate of their type).
3. parity: LLaMA-7B width, 2 layers — the same weights through the plain
   path on the CPU and through the kernels on the card, a 128-token prefill
   then 4 teacher-forced decode steps; logits must agree.
4. serve: LLaMA-7B at full width and depth (32 layers), random NF4 weights
   (double quant) and a rank-64 LoRA with nonzero B, ``generate()`` greedy
   on 4 requests (true lengths 512/384/200/97, right-padded to 512), 64 new
   tokens each; launch counts read around the call.
5. nodq: a 2-layer full-width model with f32 absmax generates 16 tokens, so
   the f32-absmax qmm variant runs on a generate path.

The last two lines are the ``kernels`` JSON object and the result line.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES = 3.35e12      # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
PEAK_BF16 = 989e12        # dense bf16 tensor-core FLOP/s
PEAK_F32 = 67e12          # f32 outside the tensor cores, FLOP/s
L2_BYTES = 50 * 2 ** 20   # H100 L2 cache
QMM_TOL = (2e-2, 1e-2)    # atol, rtol: one bf16 ulp of the output + f32 reassociation
ATTN_TOL = 2e-2           # of each (row, head)'s max |out|: bf16 probabilities against
                          # chunk-wise running maxima, up to 2^-8 of the values' scale
LOGIT_TOL = 0.15          # 7B width, 2 layers: bf16 activations rounded in other orders

SERVE_LENGTHS = (512, 384, 200, 97)
SERVE_NEW = 64

# kernel phase: the LLaMA-7B block linears (K, N) at prefill (M = 4 x 512)
# and decode (M = 4) rows, and decode attention at the serving width
QMM_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096))
QMM_ROWS = (2048, 4)
ATTN_CASES = (   # B, H, KVH, hd, T, lengths, sliding window, planted edges
    (4, 32, 32, 128, 640, (0, 97, 383, 639), None, False),
    (4, 32, 8, 128, 640, (0, 97, 383, 639), 256, False),      # GQA G=4, sliding window
    (4, 32, 32, 128, 600, (5, 300, 598, 599), None, False),   # T not a multiple of 128
    (4, 32, 8, 128, 640, (0, 97, 383, 639), 256, True),       # an off-by-one moves it O(1)
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


def kernel_phase(dev, results):
    import torch
    import torch.nn.functional as F

    from qlora_tpu_torch.ops import (
        decode_attention_cuda, decode_attention_plain, qmatmul_plain,
        qmm_nf4_fwd_dq, qmm_nf4_fwd_f32,
    )
    from qlora_tpu_torch.quant import dequantize, quantize

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
                iters = 20 if M > 16 else 200
                ms = cuda_ms(lambda i: wrapper(x, qts[i % len(qts)]), iters)
                plain_ms = cuda_ms(lambda i: qmatmul_plain(x, qts[i % len(qts)]),
                                   3 if M > 16 else 20)
                lib_ms = cuda_ms(lambda i: torch.matmul(x, ws[i % len(ws)]), iters)
                bound_ms, bound_by = qmm_bound(M, K, N, dq)
                name = wrapper.__name__
                rec = dict(name=name, shape=f"M={M} K={K} N={N}", max_abs_err=err, ms=ms,
                           plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                           bound_by=bound_by)
                results.append(rec)
                print(f"kernel {name} M={M} K={K} N={N}: max|d|={err:.3g} "
                      f"(tol {QMM_TOL[0]} + {QMM_TOL[1]}*|ref|) ms={ms:.4f} "
                      f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                      f"bound_ms={bound_ms:.4f} ({bound_by})", flush=True)
                if excess > QMM_TOL[0]:
                    fail(f"{name} M={M} K={K} N={N} differs from its plain version by {err}")

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


def counters():
    from qlora_tpu_torch.ops import decode_attention_cuda, qmm_nf4_fwd_dq, qmm_nf4_fwd_f32

    return (qmm_nf4_fwd_dq, qmm_nf4_fwd_f32, decode_attention_cuda)


def reset_counts():
    for w in counters():
        w.launches = 0


def read_counts():
    return {w.__name__: w.launches for w in counters()}


def padded_requests(lengths, S, vocab, seed):
    import torch

    g = torch.Generator().manual_seed(seed)
    ids = torch.zeros((len(lengths), S), dtype=torch.long)
    for b, n in enumerate(lengths):
        ids[b, :n] = torch.randint(3, vocab, (n,), generator=g)
    return ids, torch.tensor(lengths, dtype=torch.int32)


def serve_phase(dev):
    import torch

    from qlora_tpu_torch.generate import generate
    from qlora_tpu_torch.generate.engine import prefill
    from qlora_tpu_torch.models import init_cache, init_params

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

    with torch.inference_mode():
        cache = init_cache(cfg, 4, max(SERVE_LENGTHS) + SERVE_NEW, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prefill(params, lora, ids.to(dev), lengths.to(dev), cfg, lcfg, cache=cache)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t1
    del cache
    n_lin = 7 * cfg.num_layers
    want = {"qmm_nf4_fwd_dq": n_lin * (SERVE_NEW + 1), "qmm_nf4_fwd_f32": 0,
            "decode_attention_cuda": cfg.num_layers * SERVE_NEW}
    decode_s = total_s - prefill_s
    print(f"serve: generated {tuple(toks.shape)} tokens in {total_s:.3f} s; prefill "
          f"{prefill_s * 1e3:.1f} ms (4 x 512 padded), decode {decode_s * 1e3:.1f} ms = "
          f"{toks.numel() / decode_s:.1f} tok/s, {decode_s / SERVE_NEW * 1e3:.2f} ms/step; "
          f"peak memory {peak_gib:.2f} GiB", flush=True)
    print(f"serve: launches {counts} (expected {want}: {n_lin} qmm per forward, "
          f"{cfg.num_layers} decode-attention per decode step)", flush=True)
    if counts != want:
        fail(f"serve launch counts {counts} != {want}")
    if toks.shape != (4, SERVE_NEW) or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        fail("serve: tokens out of range or wrong shape")
    del params, lora
    torch.cuda.empty_cache()
    return counts, dict(prefill_ms=prefill_s * 1e3, decode_ms_per_step=decode_s / SERVE_NEW
                        * 1e3, decode_tok_s=toks.numel() / decode_s, peak_gib=peak_gib)


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
    want = {"qmm_nf4_fwd_dq": 0, "qmm_nf4_fwd_f32": 7 * cfg.num_layers * (new + 1),
            "decode_attention_cuda": cfg.num_layers * new}
    print(f"nodq: generated {tuple(toks.shape)} tokens; launches {counts} "
          f"(expected {want})", flush=True)
    if counts != want or toks.shape != (2, new):
        fail(f"nodq launch counts {counts} != {want}")
    del params
    torch.cuda.empty_cache()
    return counts


SOURCES = {
    "qmm_nf4_fwd_dq": ("qlora_tpu_torch/csrc/qmm_nf4_fwd.cu",
                       "qlora_tpu/ops/qmatmul.py:592 (_qmm_pallas_dq)"),
    "qmm_nf4_fwd_f32": ("qlora_tpu_torch/csrc/qmm_nf4_fwd.cu",
                        "qlora_tpu/ops/qmatmul.py:521 (_qmm_pallas)"),
    "decode_attention_cuda": ("qlora_tpu_torch/csrc/decode_attention.cu",
                              "qlora_tpu/ops/decode_attention.py:207 (fused_decode_attention)"),
}
# the shape each kernel's summary entry reports: the decode step's most
# common launch (4096 -> 4096 at batch 4) and the serving-shape attention
HEADLINE = {"qmm_nf4_fwd_dq": "M=4 K=4096 N=4096", "qmm_nf4_fwd_f32": "M=4 K=4096 N=4096",
            "decode_attention_cuda": "B=4 H=32 KVH=32"}


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
    qmm_step = qmm_ms_per_forward(results, num_layers, QMM_ROWS[-1])
    step = stats["decode_ms_per_step"]
    return dict(prefill_ms=stats["prefill_ms"], prefill_qmm_ms=qmm_prefill,
                step_ms=step, step_qmm_ms=qmm_step, step_attention_ms=attn,
                step_other_ms=step - qmm_step - attn)


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
    print(f"kernels: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    worst = parity_phase(dev)
    print(f"parity: worst max|d| {worst:.4g} <= {LOGIT_TOL}, {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    serve_counts, serve_stats = serve_phase(dev)
    print(f"serve: {time.perf_counter() - t0:.1f} s", flush=True)
    nodq_counts = nodq_phase(dev)

    launches = dict(serve_counts, qmm_nf4_fwd_f32=nodq_counts["qmm_nf4_fwd_f32"])
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
        })
    split = serve_split(results, seven_b().num_layers, serve_stats)
    print(f"serve: prefill {split['prefill_ms']:.1f} ms, of which qmm kernels "
          f"~{split['prefill_qmm_ms']:.1f} ms; decode step {split['step_ms']:.2f} ms = qmm "
          f"kernels ~{split['step_qmm_ms']:.2f} ms + decode attention "
          f"~{split['step_attention_ms']:.2f} ms + other ~{split['step_other_ms']:.2f} ms "
          "(kernel-phase times x launches)", flush=True)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
