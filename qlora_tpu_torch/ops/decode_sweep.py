"""Ablations of the decode-step kernels on the card: the NF4 decode kernel
(``csrc/qmm_nf4_decode.cu``), the int8 decode kernel
(``csrc/qmm_i8_decode.cu``), the direct int8 (w8a8) decode kernel
(``csrc/qmm_i8_direct_decode.cu``), the w8a8 decode kernel over NF4
(``csrc/qmm_nf4_w8a8_decode.cu``) and split-KV decode attention
(``csrc/decode_attention_split.cu``).

Run on a machine with an H100 and ``nvcc``, from the root of a checkout:

    python -m qlora_tpu_torch.ops.decode_sweep [nf4 | int8 | w8a8 | nf4w8a8 | attention | paged]

Each variant is a kernel's source with one part taken out or one constant
changed, compiled into ``build/sweep/``.  The qmm variants run the real
kernel's split plan on the LLaMA-7B block linears (and a tiny weight, whose
time is the launch's fixed cost) at M = 4 and 16, beside ``torch.matmul`` on
the dequantized bf16 weight; the int8 kernel also runs as built on plans of
1 to 4 blocks per SM (its splits are an argument).  The w8a8 kernel runs as
built, with no products, with loads only (no transposes, no products), with
the rows quantized outside the kernel (its x8 and xs given: what the wrapper
did before) and on plans of 1 to 3 blocks per SM, on the block linears and
the padded lm_head at M = 4, 8 and a verify chunk's 40 (past 16 rows on its
plan for them, two warps side by side), beside ``qmm_i8_direct.cu`` (rows
quantized beforehand) and ``torch._int_mm`` with the epilogue.  The w8a8
kernel over NF4 runs as built, with no products, with no decode (the packed
words go to the products as they are), with loads only (no transposes, no
decode, no products), with the rows quantized outside the kernel, with its
registers bounded for 2 or 4 blocks an SM (3 as built), each of these three
also on plans of about 1 and 3 blocks an SM and of 2 to 4 rounded down, on
the block linears (double quant) at M = 4, 8 and 16, beside ``qmm_i8_direct.cu``'s
NF4 entry (rows quantized and scales made beforehand), the exact NF4 decode
kernel at the same rows and ``torch._int_mm`` on the decoded codes.
Attention runs chip_smoke.py's timed shapes and its long case, as built, cut
and on plans of other keys per split (also an argument); the paged split-KV
kernel (``csrc/paged_attention_split.cu``) likewise at chip_smoke.py's chunk
and decode shapes, beside ``paged_attention.cu``'s chunk or decode entry.  Every launch is
timed in a CUDA graph with its inputs rotated past the 50 MB L2.  Variants
that take parts out compute wrong sums: they time what is left.  One line
per shape and row count; nothing here is used by the port.
"""

from __future__ import annotations

import ctypes
import dataclasses
import importlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CSRC = ROOT / "qlora_tpu_torch" / "csrc"
OUT = ROOT / "build" / "sweep"

_DECODE = ("  const float lo = __fmul_rn(tab[b & 15], am_lo);\n"
           "  const float hi = __fmul_rn(tab[(b >> 4) & 15], am_hi);\n"
           "  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);\n"
           "  return *reinterpret_cast<const uint32_t*>(&v);",
           "  return b | (b << 16) | __float_as_uint(am_lo + am_hi);")
_MMA = ("for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][i], a, bx[mt][0], bx[mt][1]);",
        "for (int mt = 0; mt < MT; ++mt) acc[mt][i][0] += "
        "__uint_as_float((a[0] ^ a[1] ^ a[2] ^ a[3] ^ bx[mt][0] ^ bx[mt][1]) & 0x3fffffff);")
_DEPTH = lambda n: ("constexpr int DEPTH = 1;", f"constexpr int DEPTH = {n};")
VARIANTS = {
    "as built": [],
    "no decode": [_DECODE],                 # bytes go to the tensor cores undecoded
    "no mma": [_MMA],                       # decoded, not multiplied
    "loads only": [_DECODE, _MMA],          # the weight and absmax streamed, little else
    "depth 2": [_DEPTH(2)],
    "depth 4": [_DEPTH(4)],
}
# the int8 kernel: its decode of two codes to a bf16 pair, and its products
_I8_DECODE = ("  const float r = (float)(1.0 / 127.0);\n"
              "  const __nv_bfloat162 v = __floats2bfloat162_rn(__fmul_rn(__fmul_rn(c_lo, r), am_lo),\n"
              "                                                 __fmul_rn(__fmul_rn(c_hi, r), am_hi));\n"
              "  return *reinterpret_cast<const uint32_t*>(&v);",
              "  return __float_as_uint(c_lo + c_hi) ^ __float_as_uint(am_lo + am_hi);")
I8_VARIANTS = {
    "as built": [],
    "no decode": [_I8_DECODE],              # codes go to the tensor cores undecoded
    "no mma": [_MMA],
    "loads only": [_I8_DECODE, _MMA],
    "depth 2": [_DEPTH(2)],
}
I8_BLOCKS_PER_SM = (1, 2, 3, 4)             # the plan's; as built takes 2
# the direct int8 (w8a8) decode kernel: its products and its transposes
_W_MMA = ("for (int mt = 0; mt < MT; ++mt) mma_s8(acc[mt][i], a, bx[mt][0], bx[mt][1]);",
          "for (int mt = 0; mt < MT; ++mt) acc[mt][i][0] += "
          "(int)((a[0] ^ a[1] ^ a[2] ^ a[3] ^ bx[mt][0] ^ bx[mt][1]) & 0xff);")
_W_TRANSPOSE = ("  t[0] = __byte_perm(p0, p2, 0x5410);\n  t[1] = __byte_perm(p0, p2, 0x7632);\n"
                "  t[2] = __byte_perm(p1, p3, 0x5410);\n  t[3] = __byte_perm(p1, p3, 0x7632);",
                "  t[0] = w[0];\n  t[1] = w[1];\n  t[2] = w[2];\n  t[3] = w[3];")
W8A8_VARIANTS = {
    "as built": [],
    "no products": [_W_MMA],                # streamed and transposed, not multiplied
    "loads only": [_W_TRANSPOSE, _W_MMA],   # the codes streamed, little else
}
W8A8_BLOCKS_PER_SM = (1, 2, 3)              # the plan's; as built takes 2
W8A8_SHAPES = ((256, 128), (4096, 4096), (4096, 11008), (11008, 4096), (4096, 32768))
W8A8_ROWS = (4, 8, 40)                      # serve-int8's decode step, serve-paged-int8's,
                                            # serve-paged-spec-int8's verify chunk
# the w8a8 decode kernel over NF4: its two planes' products, its decode of a
# word of packed bytes to one plane's codes, and the transposes
_N_MMA = [(f"for (int mt = 0; mt < MT; ++mt) mma_s8(acc[mt][i], a{p}, b{p}[mt][0], b{p}[mt][1]);",
           f"for (int mt = 0; mt < MT; ++mt) acc[mt][i][0] += "
           f"(int)((a{p}[0] ^ a{p}[1] ^ a{p}[2] ^ a{p}[3] ^ b{p}[mt][0] ^ b{p}[mt][1]) & 0xff);")
          for p in ("l", "h")]
_N_DECODE = ("  const uint32_t o = HI ? offs_hi(w) : offs_lo(w);\n"
             "  return pack4(code8(tab, byte_at(o, 0), ratio), code8(tab, byte_at(o, 1), ratio),\n"
             "               code8(tab, byte_at(o, 2), ratio), code8(tab, byte_at(o, 3), ratio));",
             "  return (HI ? w >> 4 : w) ^ __float_as_uint(ratio);")
NF4_W8A8_VARIANTS = {
    "as built": [],
    "no products": _N_MMA,                  # streamed, transposed and decoded, not multiplied
    "no decode": [_N_DECODE],               # the packed words multiplied as they are
    "loads only": [_W_TRANSPOSE, _N_DECODE] + _N_MMA,   # the bytes streamed, little else
    # registers bounded for 2 or 4 blocks an SM (3 as built)
    **{f"{n} blocks an SM": [("__global__ void __launch_bounds__(WARPS * 32, 3)",
                              f"__global__ void __launch_bounds__(WARPS * 32, {n})")]
       for n in (2, 4)},
}
NF4_W8A8_ROWS = (4, 8, 16)                  # generate()'s batch, serve-paged's 8 slots, 16
NF4_W8A8_BLOCKS_PER_SM = (1, 2, 3)          # the as-built kernel on these plans; the plan takes 2
# split-KV attention: the products, the softmax, and the ring
_A_QK = ("        mma_bf16(s[0], a, bk[0], bk[1]);\n        mma_bf16(s[1], a, bk[2], bk[3]);",
         "        s[0][0] += __uint_as_float((a[0] ^ bk[0]) & 0x3effffff);\n"
         "        s[1][0] += __uint_as_float((a[1] ^ bk[2]) & 0x3effffff);")
_A_PV = ("        mma_bf16(acc[dn], pa, bv[0], bv[1]);\n        mma_bf16(acc[dn + 1], pa, bv[2], bv[3]);",
         "        acc[dn][0] += __uint_as_float((pa[0] ^ bv[0]) & 0x3effffff);\n"
         "        acc[dn + 1][0] += __uint_as_float((pa[1] ^ bv[2]) & 0x3effffff);")
_A_ONE_COPY = [("  static constexpr int PITCH = HD + 8; ", "  static constexpr int PITCH = HD; "),
               ("    for (int i = lane; i < n; i += 32) {\n"
                "      bulk_copy(smem_u32(ks + i * C::PITCH * 2), kc + slab + (size_t)(first + i) * HD, HD * 2,\n"
                "                bar);\n"
                "      bulk_copy(smem_u32(vs + i * C::PITCH * 2), vc + slab + (size_t)(first + i) * HD, HD * 2,\n"
                "                bar);\n    }",
                "    if (lane == 0) {\n"
                "      bulk_copy(smem_u32(ks), kc + slab + (size_t)first * HD, n * HD * 2, bar);\n"
                "      bulk_copy(smem_u32(vs), vc + slab + (size_t)first * HD, n * HD * 2, bar);\n    }")]
ATTN_VARIANTS = {
    "as built": [],
    "no products": [_A_QK, _A_PV],          # loads, softmax and merges
    "3 stages": [("  static constexpr int STAGES = 2;", "  static constexpr int STAGES = 3;")],
    # one bulk copy of K and one of V a chunk, rows unpadded (bank conflicts)
    "one copy a chunk": _A_ONE_COPY,
    "no loads": [("    mbar_wait(smem_u32(full + st), (ch / C::STAGES) & 1);\n", ""),
                 ("    for (int ch = 0; ch < nchunks && ch < C::STAGES; ++ch) fetch(ch);",
                  "    for (int ch = 0; ch < 0; ++ch) fetch(ch);"),
                 ("    if (w == 0 && ch + C::STAGES < nchunks) fetch(ch + C::STAGES);\n", "")],
}
ATTN_KEYS = (64, 128, 256)                  # keys a split, against the plan's own
ATTN_SHAPES = (   # B, H, KVH, hd, T, lengths, window: chip_smoke.py's timed ones, the long case
    (4, 32, 32, 128, 640, (0, 97, 383, 639), None),
    (4, 32, 8, 128, 640, (0, 97, 383, 639), 256),
    (4, 32, 32, 128, 600, (5, 300, 598, 599), None),
    (4, 32, 32, 128, 2048, (0, 511, 1500, 2047), None))
# the verify chunk's split-KV attention (paged_attention_split.cu): the same
# cuts, on the chunk shapes of chip_smoke.py
PAGED_VARIANTS = {
    "as built": [],
    "no products": [_A_QK, _A_PV],
    "no loads": [("    mbar_wait(smem_u32(full + st), (ch / Cf::STAGES) & 1);\n", ""),
                 ("    for (int ch = 0; ch < nchunks && ch < Cf::STAGES; ++ch) fetch(ch);",
                  "    for (int ch = 0; ch < 0; ++ch) fetch(ch);"),
                 ("    if (w == 0 && ch + Cf::STAGES < nchunks) fetch(ch + Cf::STAGES);\n", "")],
}
PAGED_SHAPES = (  # B, C, H, KVH, hd, page, pps, lengths, window, evicted: chip_smoke.py's
    (8, 5, 32, 32, 128, 64, 16, (0, 1, 63, 64, 65, 300, 510, 1019), None, False),   # chunks
    (8, 5, 32, 8, 128, 64, 16, (0, 1, 63, 64, 65, 300, 510, 1019), 256, True),
    (8, 1, 32, 32, 128, 64, 16, (0, 1, 63, 64, 65, 300, 511, 1022), None, False),   # decode
    (8, 1, 32, 8, 128, 64, 16, (0, 1, 63, 64, 65, 300, 511, 1022), 256, True))
SHAPES = ((256, 128), (4096, 4096), (4096, 11008), (11008, 4096))
ROWS = (4, 16)
L2_BYTES = 50 * 2 ** 20
SETS = ("nf4", "int8", "w8a8", "nf4w8a8", "attention", "paged")


def build(source: str, variants: dict, entry: str, argtypes) -> dict:
    """Every variant of `source` compiled at once, one nvcc each: {name:
    typed C entry}."""
    from qlora_tpu_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, edits in variants.items():
        text = (CSRC / source).read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: the source no longer holds {old[:40]!r}")
            text = text.replace(old, new)
        stem = f"{Path(source).stem}_{name.replace(' ', '_')}"
        (OUT / f"{stem}.cu").write_text(text)
        lib = OUT / f"lib{stem}.so"
        procs.append((name, lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(OUT / f"{stem}.cu")])))
    fns = {}
    for name, lib, proc in procs:
        if proc.wait() != 0:
            raise RuntimeError(f"{source} {name!r}: nvcc failed")
        fn = getattr(ctypes.CDLL(str(lib)), entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def graph_ms(fn, iters: int = 100) -> float:
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(2):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def copies_past_l2(qt) -> list:
    return [qt] + [dataclasses.replace(qt, packed=qt.packed.clone(), absmax=qt.absmax.clone())
                   for _ in range(max(1, -(-2 * L2_BYTES // qt.nbytes)) - 1)]


def qmm_sweep(kind: str, dev, g, sms: int) -> None:
    """The NF4 or int8 decode kernel's variants at SHAPES x ROWS."""
    import torch

    from qlora_tpu_torch.quant import dequantize, quantize

    qm = importlib.import_module("qlora_tpu_torch.ops.qmatmul")
    int8 = kind == "int8"
    argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fns = (build("qmm_i8_decode.cu", I8_VARIANTS, "qmm_i8_decode", argtypes) if int8 else
           build("qmm_nf4_decode.cu", VARIANTS, "qmm_nf4_decode", argtypes))
    for K, N in SHAPES:
        qt = quantize(torch.randn(K, N, device=dev, generator=g) * K ** -0.5,
                      quant_type="int8" if int8 else "nf4")
        copies = copies_past_l2(qt)
        w = dequantize(qt, torch.bfloat16)
        ws = [w] + [w.clone() for _ in range(max(1, -(-2 * L2_BYTES // w.nbytes)) - 1)]
        _, _, scale, offset = qm._check_quantized(qt, qt.device)
        code = None if int8 else qm._code_on(qt.quant_type, dev).data_ptr()
        plan = (qm.i8_decode_plan if int8 else qm.decode_plan)(K, N, qt.block_size, sms)
        plans = {"": plan}
        if int8:   # the as-built kernel on other splits
            for per_sm in I8_BLOCKS_PER_SM:
                splits = min(-(-K // plan.unit), 16, -(-per_sm * sms // plan.strips))
                plans[f" ({per_sm}/SM, {splits} splits)"] = dataclasses.replace(plan,
                                                                                 splits=splits)
        for M in ROWS:
            x = torch.randn(M, K, device=dev, generator=g).to(torch.bfloat16)
            y = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
            line = []
            runs = [(name, fn, plan) for name, fn in fns.items()] + [
                (f"as built{tag}", fns["as built"], p) for tag, p in plans.items() if tag]
            for name, fn, p in runs:
                def launch(i, fn=fn, p=p):
                    q = copies[i % len(copies)]
                    err = fn(x.data_ptr(), q.packed.data_ptr(), q.absmax.data_ptr(),
                             scale.data_ptr(), offset.data_ptr(), code, y.data_ptr(),
                             M, K, N, qt.block_size, 1, p.splits, p.unit,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: cudaError_t {err}")
                line.append(f"{name} {graph_ms(launch):.4f}")
            line.append(f"torch.matmul on the bf16 weight {graph_ms(lambda i: x @ ws[i % len(ws)]):.4f}")
            print(f"decode_sweep {kind} K={K} N={N} M={M} splits={plan.splits} (ms): "
                  + ", ".join(line), flush=True)


def w8a8_sweep(dev, g, sms: int) -> None:
    """The direct int8 decode kernel's variants and plans at W8A8_SHAPES x
    W8A8_ROWS, beside qmm_i8_direct.cu and torch._int_mm."""
    import torch

    from qlora_tpu_torch.quant import quantize

    qm = importlib.import_module("qlora_tpu_torch.ops.qmatmul")
    P, I = ctypes.c_void_p, ctypes.c_int
    fns = build("qmm_i8_direct_decode.cu", W8A8_VARIANTS, "qmm_i8_direct_decode",
                [P] * 6 + [I] * 5 + [P])
    stream = lambda: torch.cuda.current_stream().cuda_stream
    for K, N in W8A8_SHAPES:
        qt = quantize(torch.randn(K, N, device=dev, generator=g) * K ** -0.5, block_size=K,
                      quant_type="int8", double_quant=False)
        copies = copies_past_l2(qt)
        col = qt.absmax.reshape(-1)
        s_out = col / 127.0
        for M in W8A8_ROWS:
            wide = M > qm.DECODE_ROWS
            plan = (qm.i8_direct_verify_plan if wide else qm.i8_direct_decode_plan)(K, N, sms)
            longest = -(-K // (qm._I8_DIRECT_WIDE_MAX_ROWS if wide else qm._I8_DIRECT_MAX_ROWS))
            plans = {}
            for per_sm in W8A8_BLOCKS_PER_SM:
                splits = min(K // 32, 16, max(-(-per_sm * sms // plan.strips), longest))
                plans[f" ({per_sm}/SM, {splits} splits)"] = splits
            x = torch.randn(M, K, device=dev, generator=g).to(torch.bfloat16)
            x8, xs = qm.quantize_rows(x)
            xs1 = xs.reshape(-1).contiguous()
            y = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
            runs = [(name, fn, plan.splits, 0) for name, fn in fns.items()]
            runs.append(("rows quantized outside", fns["as built"], plan.splits, 1))
            runs += [(f"as built{tag}", fns["as built"], sp, 0) for tag, sp in plans.items()
                     if sp != plan.splits]
            line = []
            for name, fn, splits, given in runs:
                def launch(i, fn=fn, splits=splits, given=given):
                    q = copies[i % len(copies)]
                    err = fn(x.data_ptr(), q.packed.data_ptr(), col.data_ptr(), y.data_ptr(),
                             x8.data_ptr() if given else None, xs1.data_ptr() if given else None,
                             M, K, N, splits, given, stream())
                    if err:
                        raise RuntimeError(f"{name}: cudaError_t {err}")
                line.append(f"{name} {graph_ms(launch):.4f}")
            before = graph_ms(lambda i: qm._launch_w8a8(
                "qmm_i8_direct", x8, copies[i % len(copies)], None, s_out, xs))
            xp = torch.nn.functional.pad(x8, (0, 0, 0, (-M) % 32))

            def int_mm(i):
                acc = torch._int_mm(xp, copies[i % len(copies)].packed)[:M]
                return (acc.float() * s_out[None, :]).to(torch.bfloat16) * xs.to(torch.bfloat16)

            line.append(f"qmm_i8_direct.cu (before) {before:.4f}")
            line.append(f"torch._int_mm {graph_ms(int_mm):.4f}")
            print(f"decode_sweep w8a8 K={K} N={N} M={M} splits={plan.splits} (ms): "
                  + ", ".join(line), flush=True)


def nf4_w8a8_sweep(dev, g, sms: int) -> None:
    """The w8a8 decode kernel over NF4's variants at the block linears x
    NF4_W8A8_ROWS, beside qmm_i8_direct.cu's NF4 entry, the exact NF4 decode
    kernel and torch._int_mm."""
    import torch

    from qlora_tpu_torch.quant import quantize

    qm = importlib.import_module("qlora_tpu_torch.ops.qmatmul")
    P, I = ctypes.c_void_p, ctypes.c_int
    fns = build("qmm_nf4_w8a8_decode.cu", NF4_W8A8_VARIANTS, "qmm_nf4_w8a8_decode",
                [P] * 9 + [I] * 8 + [P])
    stream = lambda: torch.cuda.current_stream().cuda_stream
    for K, N in SHAPES[1:]:
        qt = quantize(torch.randn(K, N, device=dev, generator=g) * K ** -0.5)
        copies = copies_past_l2(qt)
        _, _, scale, offset = qm._check_quantized(qt, qt.device)
        code = qm._code_on(qt.quant_type, qt.device)
        ratio, s_out = qm.w8a8_scales(qt)
        w8 = qm.w8a8_codes(qt, ratio)
        w8s = [w8] + [w8.clone() for _ in range(max(1, -(-2 * L2_BYTES // w8.nbytes)) - 1)]
        plan = qm.nf4_w8a8_decode_plan(K, N, qt.block_size, sms)
        # other splits: about 1 and 3 blocks an SM, and 2 an SM rounded down (one
        # wave of two-block SMs)
        plans = {}
        for per_sm, up in [(n, True) for n in NF4_W8A8_BLOCKS_PER_SM] + [(n, False)
                                                                        for n in (2, 3, 4)]:
            want = -(-per_sm * sms // plan.strips) if up else per_sm * sms // plan.strips
            splits = max(1, min(K // 64, 16, want))
            if splits != plan.splits and -(-(K // 64) // splits) * 32 <= 2048:
                plans[f" ({splits} splits, {plan.strips * splits} blocks)"] = splits
        for M in NF4_W8A8_ROWS:
            x = torch.randn(M, K, device=dev, generator=g).to(torch.bfloat16)
            x8, xs = qm.quantize_rows(x)
            xs1 = xs.reshape(-1).contiguous()
            y = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
            runs = [(name, fn, 0, plan.splits) for name, fn in fns.items()]
            runs.append(("rows quantized outside", fns["as built"], 1, plan.splits))
            runs += [(f"{name}{tag}", fns[name], 0, sp) for tag, sp in plans.items()
                     for name in ("as built", "2 blocks an SM", "4 blocks an SM")]
            line = []
            for name, fn, given, splits in runs:
                def launch(i, fn=fn, given=given, splits=splits):
                    q = copies[i % len(copies)]
                    err = fn(x.data_ptr(), q.packed.data_ptr(), q.absmax.data_ptr(),
                             scale.data_ptr(), offset.data_ptr(), code.data_ptr(), y.data_ptr(),
                             x8.data_ptr() if given else None, xs1.data_ptr() if given else None,
                             M, K, N, qt.block_size, 1, splits, given, 0, stream())
                    if err:
                        raise RuntimeError(f"{name}: cudaError_t {err}")
                line.append(f"{name} {graph_ms(launch):.4f}")
            before = graph_ms(lambda i: qm._launch_w8a8(
                "qmm_nf4_w8a8", x8, copies[i % len(copies)], ratio, s_out, xs), 20)
            exact = graph_ms(lambda i: qm._decode_launch(x, copies[i % len(copies)], scale,
                                                         offset))
            xp = torch.nn.functional.pad(x8, (0, 0, 0, (-M) % 32))

            def int_mm(i):
                acc = torch._int_mm(xp, w8s[i % len(w8s)])[:M]
                return (acc.float() * s_out[None, :]).to(torch.bfloat16) * xs.to(torch.bfloat16)

            line.append(f"qmm_i8_direct.cu NF4 entry (before) {before:.4f}")
            line.append(f"exact NF4 decode kernel {exact:.4f}")
            line.append(f"torch._int_mm {graph_ms(int_mm):.4f}")
            print(f"decode_sweep nf4w8a8 K={K} N={N} M={M} splits={plan.splits} "
                  f"strips={plan.strips} (ms): "
                  + ", ".join(line), flush=True)


def attention_sweep(dev, g, sms: int) -> None:
    """Split-KV attention's variants and plans at ATTN_SHAPES, beside
    decode_attention.cu (the "before")."""
    import torch

    da = importlib.import_module("qlora_tpu_torch.ops.decode_attention")
    fns = build("decode_attention_split.cu", ATTN_VARIANTS, "decode_attention_split",
                da._SPLIT_ARGTYPES)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    for B, H, KVH, hd, T, lens, window in ATTN_SHAPES:
        mk = lambda *s: torch.randn(*s, device=dev, generator=g).to(torch.bfloat16)
        one = 2 * B * KVH * T * hd * 2
        caches = [(mk(B, KVH, T, hd), mk(B, KVH, T, hd))
                  for _ in range(max(1, -(-2 * L2_BYTES // one)))]
        q, nk, nv = mk(B, H, hd), mk(B, KVH, hd), mk(B, KVH, hd)
        L = torch.tensor(lens, device=dev, dtype=torch.int32)
        out = torch.empty_like(q)
        plan = da.decode_attention_plan(T, KVH, H // KVH, hd, window, sms)
        ws = torch.empty(B * KVH * 16 * H // KVH * (hd + 2), device=dev)   # room for 16 splits
        span = min(T, window - 1) if window else T
        runs = [(name, fn, plan.keys, plan.splits) for name, fn in fns.items()] + [
            (f"as built ({k} keys a split)", fns["as built"], k, -(-span // k))
            for k in ATTN_KEYS if k != plan.keys and -(-span // k) <= 16]
        line = []
        for name, fn, keys, splits in runs:
            def launch(i, fn=fn, keys=keys, splits=splits):
                kc, vc = caches[i % len(caches)]
                err = fn(q.data_ptr(), nk.data_ptr(), nv.data_ptr(), kc.data_ptr(),
                         vc.data_ptr(), L.data_ptr(), ws.data_ptr(), out.data_ptr(), B, KVH,
                         H // KVH, T, hd, hd ** -0.5, window or 0, keys, splits, stream())
                if err:
                    raise RuntimeError(f"{name}: cudaError_t {err}")
            line.append(f"{name} {graph_ms(launch):.4f}")
        before = graph_ms(lambda i: da._decode_attention_before(
            q, nk, nv, *caches[i % len(caches)], L, sm_scale=hd ** -0.5, sliding_window=window))
        line.append(f"decode_attention.cu (before) {before:.4f}")
        print(f"decode_sweep attention B={B} H={H} KVH={KVH} hd={hd} T={T} lens={list(lens)} "
              f"window={window} keys={plan.keys} splits={plan.splits} (ms): " + ", ".join(line),
              flush=True)


def paged_sweep(dev, g, sms: int) -> None:
    """The split kernel's variants and plans at PAGED_SHAPES (chunks of 5 and
    the decode step, C = 1), beside paged_attention.cu's chunk or decode
    entry (the "before"); pools rotated past L2; every launch appends, so
    each run writes the same rows again."""
    import torch

    from chip_smoke import paged_case

    pa = importlib.import_module("qlora_tpu_torch.ops.paged_attention")
    fns = build("paged_attention_split.cu", PAGED_VARIANTS, "paged_chunk_attention_split",
                pa._SPLIT_ARGS)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    for B, C, H, KVH, hd, page, pps, lens, window, evict in PAGED_SHAPES:
        q, nk, nv, kp, vp, L, tables = paged_case(g, dev, B, C, H, KVH, hd, page, pps, lens,
                                                  window, evict)
        pools = [(kp, vp)] + [(kp.clone(), vp.clone())
                              for _ in range(max(1, -(-2 * L2_BYTES // (2 * kp.nbytes))) - 1)]
        out = torch.empty_like(q)
        G, T = H // KVH, page * pps
        plan = pa.paged_chunk_plan(T, KVH, G, C, hd, window, sms)
        ws = torch.empty(B * KVH * 16 * C * G * (hd + 2), device=dev)   # room for 16 splits
        span = min(T, window - 1) if window else T
        runs = [(name, fn, plan.keys, plan.splits) for name, fn in fns.items()] + [
            (f"as built ({k} keys a split)", fns["as built"], k, -(-span // k))
            for k in ATTN_KEYS if k != plan.keys and -(-span // k) <= 16]
        line = []
        for name, fn, keys, splits in runs:
            def launch(i, fn=fn, keys=keys, splits=splits):
                k, v = pools[i % len(pools)]
                err = fn(q.data_ptr(), nk.data_ptr(), nv.data_ptr(), k.data_ptr(), v.data_ptr(),
                         L.data_ptr(), tables.data_ptr(), ws.data_ptr(), out.data_ptr(), B, C,
                         KVH, G, page, pps, hd, hd ** -0.5, window or 0, keys, splits, stream())
                if err:
                    raise RuntimeError(f"{name}: cudaError_t {err}")
            line.append(f"{name} {graph_ms(launch):.4f}")
        if C == 1:   # the decode step: paged_attention.cu's decode entry
            before = graph_ms(lambda i: pa._paged_decode_before(
                q[:, 0], nk[:, 0], nv[:, 0], *pools[i % len(pools)], L, tables,
                sm_scale=hd ** -0.5, sliding_window=window))
        else:
            before = graph_ms(lambda i: pa._paged_chunk_before(
                q, nk, nv, *pools[i % len(pools)], L, tables, sm_scale=hd ** -0.5,
                sliding_window=window))
        line.append(f"paged_attention.cu (before) {before:.4f}")
        print(f"decode_sweep paged B={B} C={C} H={H} KVH={KVH} hd={hd} page={page} pps={pps} "
              f"lens={list(lens)} window={window} keys={plan.keys} splits={plan.splits} "
              f"mtiles={plan.mtiles} (ms): " + ", ".join(line), flush=True)


def main(sets) -> int:
    import torch

    if not torch.cuda.is_available():
        print("decode_sweep: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(5)
    for kind in ("nf4", "int8"):
        if kind in sets:
            qmm_sweep(kind, dev, g, sms)
    if "w8a8" in sets:
        w8a8_sweep(dev, g, sms)
    if "nf4w8a8" in sets:
        nf4_w8a8_sweep(dev, g, sms)
    if "attention" in sets:
        attention_sweep(dev, g, sms)
    if "paged" in sets:
        paged_sweep(dev, g, sms)
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    sys.exit(main([k for k in SETS if k in args] or list(SETS)))
