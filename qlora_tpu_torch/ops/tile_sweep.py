"""Ablations of the wgmma kernels at training and prefill rows on the card:
the NF4 forward (``csrc/qmm_nf4_wgmma.cu``) with, as its "before", the tile
kernel of ``csrc/qmm_nf4_fwd.cu``; the int8 forward and dx
(``csrc/qmm_i8_wgmma.cu``) with, as theirs, the tile kernel of
``csrc/qmm_i8.cu``; the NF4 dx (``csrc/qmm_nf4_bwd_wgmma.cu``) with, as its,
``csrc/qmm_nf4_bwd.cu``; flash attention's forward, dq and dk/dv
(``csrc/flash_attention_wgmma.cu``) with, as theirs,
``csrc/flash_attention.cu``; the w8a8 forward at prefill rows
(``csrc/qmm_nf4_w8a8_wgmma.cu``) with, as its, ``qmm_i8_direct.cu``'s NF4
path.

Run on a machine with an H100 and ``nvcc``, from the root of a checkout:

    python -m qlora_tpu_torch.ops.tile_sweep [nf4 | int8 | nf4bwd | flash | w8a8]

Each variant is a kernel's source with one part taken out, compiled into
``build/sweep_tile/``, run on the LLaMA-7B block linears at M = 1024 (and,
for NF4, 40) with double-quantized absmax, its weights rotated past the 50
MB L2, timed with CUDA events.  Variants that take parts out compute wrong
sums: they time what is left.  The cuts follow
``benchmarks/ablate_kernel.py``:

- ``no absmax multiply``: each weight is the code itself (no absmax read);
- ``no codebook lookup``: the nibble cast to float in place of its code;
- ``no unpack``: the first nibble of each packed word decoded for all its
  bytes;
- ``products only``: no weight loads and no decode (x still arrives by TMA
  in the wgmma kernels and is staged in the tile kernel);
- ``loads only``: the weight and x loaded (and the weight decoded in the
  tile kernel's staging loop), no products; the wgmma kernels' ``no
  products`` keeps their decode and drops only the products, and ``loads
  only`` drops both.

and, for the NF4 wgmma kernel only: ``no fence`` (the proxy fence taken out)
and ``half rows`` (half of each thread's rows decoded, the rest stored as
zeros).  The int8 kernel is cut as built, products only, no products and
loads only, forward and backward, beside ``qmm_i8.cu`` as built, and run in
the designs it was chosen against: codes made floats by int-to-float
conversions, each ring stage released a k-step late (one k-step of wgmmas
left in flight), 128-row CTAs.

The NF4 dx kernel is cut as built, products only, no products and loads
only at M = 1024 with double-quantized absmax, and run with 128-row CTAs,
beside ``qmm_nf4_bwd.cu`` as built.

The flash kernels are cut as built, products only (no mask, no softmax: S
rounded to bf16 as P), softmax only (no products: constant scores) and
loads only, all three kernels at once, and run in the designs they were
chosen against: forward kv tiles of 128 keys, or 3 or 4 stages; dq kv
tiles of 128 keys (2 stages, to fit), or 2 stages; dk, dv CTAs of 64 and
of 128 keys at every shape (the plan picks one by the heads: 128 where G =
1), or 2 steps in the ring.  They run at chip_smoke.py's three timed
shapes (hd 128, causal), each beside ``flash_attention.cu``, timed in CUDA
graphs (their wrappers' host time exceeds the kernels' on the card's host).

The w8a8 kernel is cut as built, products only, no products and loads only
at M = 512 and 2048 on NF4 storage with double quant, and run in the
designs it was chosen against: rounding by ``__float2int_rn`` on the
conversion unit, the 8-byte stores of a half-warp in one column order (bank
conflicts), table addresses formed by one prmt, the packed bytes fetched
two of a warpgroup's k-steps ahead (one k-step fewer in the ring), 128-row
CTAs; beside ``qmm_i8_direct.cu``'s NF4 path and ``torch._int_mm`` on the
decoded codes.

One line per shape, direction and kernel; nothing here is used by the port.

``python -m qlora_tpu_torch.ops.tile_sweep --mutants [nf4 | int8 | nf4bwd | flash |
i8decode | attention | w8a8 | paged | i8direct | nf4w8a8]`` instead
copies the checkout once per mutant of a wgmma kernel into
``build/mutants/``, runs that kernel's ``cuda`` tests in each copy and
prints how many fail: each mutant must fail at least one.  NF4: the high
plane reading the low plane's absmax row, the last k-step dropped, the high
plane's x box taken at kp instead of K/2 + kp, the proxy fence taken out.
int8: the backward's absmax row taken one block off, the last k-step
dropped, the proxy fence taken out.  NF4 dx: the high plane reading the low
plane's absmax row, the low run's mask at K/2 dropped, the last k-step
dropped, the proxy fence taken out.  Flash: the causal edge and the window
edge off by one, the rescale of O dropped, the last kv tile skipped.  The
decode-step kernels (``decode_sweep`` times them): the int8 decode kernel
(``qmm_i8_decode.cu``) with a split boundary one unit off and with its last
split dropped; split-KV attention (``decode_attention_split.cu``) with the
window edge off by one and the splits' rescale dropped in the merge.  The
w8a8 kernel: the transposed store 8 k off, the last k-step dropped, the
proxy fence taken out.  The verify chunk's split-KV attention
(``paged_attention_split.cu``): the decode step (C = 1) appending one slot
late, row c's window edge taken from row 0, a key row read from the previous
page, the splits' rescale dropped.  The direct int8 decode kernel
(``qmm_i8_direct_decode.cu``): a split boundary one k-step off, a row's
largest |x| taken from its own split only (no cluster maximum), and past 16
rows the second column group's warps reading the first group's columns.  The w8a8
decode kernel over NF4 (``qmm_nf4_w8a8_decode.cu``): a column's largest
absmax taken from its own split only, the high plane reading the low
plane's absmax row, a split boundary one k-step off.
"""

from __future__ import annotations

import ctypes
import dataclasses
import importlib
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CSRC = ROOT / "qlora_tpu_torch" / "csrc"
OUT = ROOT / "build" / "sweep_tile"
L2_BYTES = 50 * 2 ** 20
SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096))
ROWS = (1024, 40)   # training rows; a verify chunk's

_DECODE2 = "__fmul_rn(code_at(tab, o0), a0), __fmul_rn(code_at(tab, o1), a1)"
_W_MUL = (_DECODE2, "code_at(tab, o0), code_at(tab, o1)")
_W_LOOKUP = (_DECODE2, "__fmul_rn((float)o0, a0), __fmul_rn((float)o1, a1)")
_W_UNPACK = [("return __byte_perm(o, 0, 0x4440 | e);", "return o & 0x3Cu;")]
_W_DECODE = ("      decode_step<DQ, ALIGNED>(st + 2 * A_BYTES,",
             "      if (false) decode_step<DQ, ALIGNED>(st + 2 * A_BYTES,")
_W_LOADS = ("        issue(s + 2);", "")
_W_MMA = ("wgmma_m64n128k16(acc[mt], gmma_desc(", "if (false) wgmma_m64n128k16(acc[mt], gmma_desc(")
_W_FENCE = ('      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");', "")
_W_HALF = ("    if (r + i < K2) {\n      float al[8]",
           "    if (r + i < K2 && i < ROWS / 2) {\n      float al[8]")
WGMMA = {
    "as built": [],
    "no absmax multiply": [_W_MUL],
    "no codebook lookup": [_W_LOOKUP],
    "no unpack": _W_UNPACK,
    "products only": [_W_DECODE, _W_LOADS],
    "no products": [_W_MMA],
    "no fence": [_W_FENCE],
    "half rows": [_W_HALF],
    "loads only": [_W_DECODE, _W_MMA],
}
_T_MUL = [("wl = __fmul_rn(tab[b & 15], aml);", "wl = tab[b & 15];"),
          ("wh = __fmul_rn(tab[b >> 4], amh);", "wh = tab[b >> 4];")]
_T_LOOKUP = [("wl = __fmul_rn(tab[b & 15], aml);", "wl = __fmul_rn((float)(b & 15), aml);"),
             ("wh = __fmul_rn(tab[b >> 4], amh);", "wh = __fmul_rn((float)(b >> 4), amh);")]
_T_DECODE = ("      if (row < K2 && n < N) {", "      if (false) {")
_T_MMA = ("for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], bfr[j], acc[i][j]);",
          "for (int j = 0; j < FN; ++j) {}")
TILE = {
    "as built": [],
    "no absmax multiply": _T_MUL,
    "no codebook lookup": _T_LOOKUP,
    "products only": [_T_DECODE],
    "loads only": [_T_MMA],
}


MUTANTS = {
    "high plane reads the low plane's absmax row": [
        ("  const int blk[2] = {blk_lo, blk_hi};", "  const int blk[2] = {blk_lo, blk_lo};")],
    "last k-step dropped": [
        ("  for (int s = 0; s < nsteps; ++s) {\n    const int stage = s % STAGES;\n    mbar_wait",
         "  for (int s = 0; s < nsteps - 1; ++s) {\n    const int stage = s % STAGES;\n    mbar_wait")],
    "high plane's x box at kp": [
        ("tma_load_2d(smem_u32(st + A_BYTES), &xmap, bar, K2 + kp, m0);",
         "tma_load_2d(smem_u32(st + A_BYTES), &xmap, bar, kp, m0);")],
    "no proxy fence": [('      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");', "")],
}
MUTANT_TESTS = "qmm_kernel_matches_plain or (wgmma and not i8)"

_I8_DECODE = ("      decode_step<DQ, BWD, ALIGNED>(st + A_BYTES,",
              "      if (false) decode_step<DQ, BWD, ALIGNED>(st + A_BYTES,")
_I8_MMA = ("wgmma_m64n128k16<BWD ? 0 : 1>(acc[mt],", "if (false) wgmma_m64n128k16<BWD ? 0 : 1>(acc[mt],")
I8 = {
    "as built": [],
    "products only": [_I8_DECODE, _W_LOADS],
    "no products": [_I8_MMA],
    "loads only": [_I8_DECODE, _I8_MMA],
    # the designs the kernel chose against
    "int-to-float codes": [(
        "  return __int_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7440 | e)) - 8388736.f;",
        "  return (float)(int8_t)(w >> (8 * e));")],
    "stage released a k-step late": [(
        "    wgmma_commit();\n    wgmma_wait_all();\n"
        "    if (lane == 0) mbar_arrive(smem_u32(empty + stage));\n  }\n",
        "    wgmma_commit();\n    asm volatile(\"wgmma.wait_group.sync.aligned 1;\" ::: \"memory\");\n"
        "    if (s > 0 && lane == 0) mbar_arrive(smem_u32(empty + (s + STAGES - 1) % STAGES));\n"
        "  }\n  wgmma_wait_all();\n")],
}
I8_MUTANTS = {
    "backward absmax row one block off": [
        ("        blk = row(0) / B;", "        blk = max(row(0) / B - 1, 0);")],
    "last k-step dropped": MUTANTS["last k-step dropped"],
    "no proxy fence": MUTANTS["no proxy fence"],
}
I8_MUTANT_TESTS = "i8_fwd_and_bwd or i8_kernels or i8_wgmma"

_NB_DECODE = ("      decode_step<DQ, ALIGNED>(st + A_BYTES,",
              "      if (false) decode_step<DQ, ALIGNED>(st + A_BYTES,")
_NB_LOADS = ("      issue(s + 2);\n", "")
NF4_BWD = {
    "as built": [],
    "products only": [_NB_DECODE, _NB_LOADS],
    "no products": [_W_MMA],
    "loads only": [_NB_DECODE, _W_MMA],
}
NF4_BWD_MUTANTS = {
    "high plane reads the low plane's absmax row": MUTANTS[
        "high plane reads the low plane's absmax row"],
    "low run's mask at K/2 dropped": [
        ("    if (m >= M || p >= K2) continue;",
         "    if (m >= M || (ch >= TP / 8 && p >= K2)) continue;")],
    "last k-step dropped": MUTANTS["last k-step dropped"],
    "no proxy fence": MUTANTS["no proxy fence"],
}
NF4_BWD_MUTANT_TESTS = "qmm_bwd or nf4_bwd_wgmma"

# flash attention's wgmma kernels: each cut edits all three at once
_F_SS = ("    for (int kk = 0; kk < D / 16; ++kk)\n      Mma<BK>::ss(s, kmajor(qa, BQ, kk), kmajor(ka, BK, kk), kk);",
         "    for (int kk = 0; kk < BK / 2; ++kk)\n      s[kk] = 0.01f * (kk + c0);")
_F_MASK = ("    if (!tile_full(r0, BQ, c0, BK, Sq, n, causal, window))\n      mask_scores<BK>",
           "    if (false)\n      mask_scores<BK>")
_F_SOFTMAX = ("    fwd_softmax<BK, D>(s, acc, p, m, l, c);",
              "    for (int e = 0; e < BK / 2; e += 2) p[e / 8][(e / 2) % 4] = pack_bf16(s[e], s[e + 1]);")
_F_RS = ("    for (int kk = 0; kk < BK / 16; ++kk) Mma<D>::rs(acc, p[kk], mnmajor(va, BK, kk));",
         "    for (int kk = 0; kk < BK / 16; ++kk) acc[kk] += __uint_as_float(p[kk][0]);")
_Q_SS = ("      Mma<BK>::ss(s, kmajor(qa, BQ, kk), kmajor(ka, BK, kk), kk);\n"
         "      Mma<BK>::ss(dp, kmajor(da, BQ, kk), kmajor(va, BK, kk), kk);",
         "      if (kk == 0)\n        for (int e = 0; e < BK / 2; ++e) s[e] = dp[e] = 0.01f * (e + c0);")
_Q_PROBS = ("    dq_probs<BK>(s, dp, ds, !tile_full(r0, BQ, c0, BK, Sq, n, causal, window), row,\n"
            "                 c0 + 2 * q, lse2, dif, c, sm_scale, Sq, n, causal, window);",
            "    for (int e = 0; e < BK / 2; e += 2) ds[e / 8][(e / 2) % 4] = pack_bf16(s[e], dp[e + 1]);")
_Q_RS = ("    for (int kk = 0; kk < BK / 16; ++kk) Mma<D>::rs(acc, ds[kk], mnmajor(ka, BK, kk));",
         "    for (int kk = 0; kk < BK / 16; ++kk) acc[kk] += __uint_as_float(ds[kk][0]);")
_K_SS = ("      Mma<BQ>::ss(s, kmajor(ka, KEYS, kk), kmajor(qa, BQ, kk), kk);\n"
         "      Mma<BQ>::ss(dp, kmajor(va, KEYS, kk), kmajor(da, BQ, kk), kk);",
         "      if (kk == 0)\n        for (int e = 0; e < BQ / 2; ++e) s[e] = dp[e] = 0.01f * (e + r0);")
_K_PROBS = ("    dkv_probs<BQ>(s, dp, pt, dst, !tile_full(r0, BQ, k0, KEYS, Sq, n, causal, window), key, r0,\n"
            "                  q, ls, ls + BQ, c, sm_scale, Sq, n, causal, window);",
            "    for (int e = 0; e < BQ / 2; e += 2) {\n"
            "      pt[e / 8][(e / 2) % 4] = pack_bf16(s[e], s[e + 1]);\n"
            "      dst[e / 8][(e / 2) % 4] = pack_bf16(dp[e], dp[e + 1]);\n    }")
_K_RS = ("      Mma<D>::rs(dva, pt[kk], mnmajor(da, BQ, kk));\n"
         "      Mma<D>::rs(dka, dst[kk], mnmajor(qa, BQ, kk));",
         "      dva[kk] += __uint_as_float(pt[kk][0]);\n      dka[kk] += __uint_as_float(dst[kk][0]);")
_SOFTMAXES = [_F_MASK, _F_SOFTMAX, _Q_PROBS, _K_PROBS]
_PRODUCTS = [_F_SS, _F_RS, _Q_SS, _Q_RS, _K_SS, _K_RS]
_ALL = ("fwd", "dq", "dkv")
FLASH = {   # name: (edits, the kernels it concerns, their (rows, cols, stages) where changed)
    "as built": ([], _ALL, {}),
    "products only": (_SOFTMAXES, _ALL, {}),
    "softmax only": (_PRODUCTS, _ALL, {}),
    "loads only": (_SOFTMAXES + _PRODUCTS, _ALL, {}),
    # the designs the kernels were chosen against (None: the plan's own value)
    "128-key kv tiles": ([("constexpr int FWD_BK = 64;", "constexpr int FWD_BK = 128;")], ("fwd",),
                         {"fwd": (128, 128, 2)}),
    "3 stages": ([("constexpr int FWD_STAGES = 2;", "constexpr int FWD_STAGES = 3;")], ("fwd",),
                 {"fwd": (128, 64, 3)}),
    "4 stages": ([("constexpr int FWD_STAGES = 2;", "constexpr int FWD_STAGES = 4;")], ("fwd",),
                 {"fwd": (128, 64, 4)}),
    "128-key kv tiles, 2 stages": ([("constexpr int DQ_BK = 64;", "constexpr int DQ_BK = 128;"),
                                    ("constexpr int DQ_STAGES = 3;", "constexpr int DQ_STAGES = 2;")],
                                   ("dq",), {"dq": (128, 128, 2)}),
    "2 stages": ([("constexpr int DQ_STAGES = 3;", "constexpr int DQ_STAGES = 2;")], ("dq",),
                 {"dq": (128, 64, 2)}),
    # both of the plan's choices of keys a CTA, each at every shape
    "64 keys a CTA": ([], ("dkv",), {"dkv": (64, 64, 4)}),
    "128 keys a CTA": ([], ("dkv",), {"dkv": (64, 128, 4)}),
    "2 steps in the ring": ([("constexpr int DKV_STAGES = 4;", "constexpr int DKV_STAGES = 2;")],
                            ("dkv",), {"dkv": (64, None, 2)}),
}
FLASH_ENTRIES = {"fwd": "flash_wgmma_fwd", "dq": "flash_wgmma_bwd_dq", "dkv": "flash_wgmma_bwd_dkv"}
FLASH_SHAPES = (   # B, H, KVH, S, lengths, window: chip_smoke.py's timed shapes, hd 128, causal
    (2, 32, 32, 512, (512, 300), None), (2, 32, 8, 512, (512, 300), 256),
    (2, 32, 32, 600, (600, 333), None))
_VISIBLE = ("  return row < Sq && col < n && (!causal || col <= row) && "
            "(window <= 0 || row - col < window);")
FLASH_MUTANTS = {
    "causal edge off by one": [(_VISIBLE, _VISIBLE.replace("col <= row", "col < row"))],
    "window edge off by one": [(_VISIBLE, _VISIBLE.replace("row - col < window",
                                                           "row - col <= window"))],
    "rescale of O dropped": [("    o[4 * j] *= alpha[0];\n    o[4 * j + 1] *= alpha[0];\n"
                              "    o[4 * j + 2] *= alpha[1];\n    o[4 * j + 3] *= alpha[1];\n", "")],
    "last kv tile skipped": [("  last = hi > lo ? (hi + bk - 1) / bk : first;",
                              "  last = hi > lo ? max(first, (hi + bk - 1) / bk - 1) : first;")],
}
FLASH_MUTANT_TESTS = "flash"
# the decode-step kernels: the int8 forward at decode rows and split-KV attention
I8_DECODE_MUTANTS = {
    "a split boundary one unit off": [
        ("  const int r1 = min((int)((long long)(split + 1) * units / splits) * unit, K);",
         "  const int r1 = min((int)((long long)(split + 1) * units / splits - 1) * unit, K);")],
    "last split dropped": [
        ("  for (int p0 = r0; p0 < r1; p0 += PASS_ROWS) {",
         "  for (int p0 = r0; p0 < (split + 1 < splits ? r1 : r0); p0 += PASS_ROWS) {")],
}
I8_DECODE_MUTANT_TESTS = "i8_decode or i8_fwd_and_bwd"
ATTN_MUTANTS = {
    "window edge off by one": [("  lo = window > 0 ? max(0, len - window + 1) : 0;",
                                "  lo = window > 0 ? max(0, len - window) : 0;")],
    "a split's rescale dropped": [("        const float sc = expf(ms[sp] - M);",
                                   "        const float sc = 1.f;")],
}
ATTN_MUTANT_TESTS = "decode_kernel_matches or decode_split"
# the w8a8 forward at prefill rows (qmm_nf4_w8a8_wgmma.cu): cut as the int8
# kernel is, and in the designs it was chosen against
_Q_DECODE = ("      decode_step(st + 2 * A_BYTES,", "      if (false) decode_step(st + 2 * A_BYTES,")
_Q_LOADS = [("      issue(s + 2);\n", ""), ("      load_ratios(s + 2);\n", "")]
_Q_MMA = ("wgmma_m64n128k32(acc[mt], gmma_desc(", "if (false) wgmma_m64n128k32(acc[mt], gmma_desc(")
_Q_STORE = "  const int at = nl * TKP + ((((rg >> 1) ^ (nl >> 1)) & 3) << 4) + ((rg & 1) << 3);"
W8A8 = {
    "as built": [],
    "products only": [_Q_DECODE] + _Q_LOADS,
    "no products": [_Q_MMA],
    "loads only": [_Q_DECODE, _Q_MMA],
    # rounding on the conversion unit, and the stores of a half-warp in one column order
    "float2int rounding": [(
        "  return __float_as_uint(__fadd_rn(__fmul_rn(c, ratio), ROUNDER));",
        "  return (uint32_t)__float2int_rn(__fmul_rn(c, ratio));")],
    "stores in one column order": [("  const bool odd = cg & 1;", "  const bool odd = false;")],
    # the codebook at a 256-byte boundary, each entry's shared address formed by
    # one prmt of the nibble's byte offset into the table's address (no add)
    "table address by prmt": [
        ("  __shared__ float tab[16];", "  __shared__ __align__(256) float tab[16];"),
        ("  const float c = *reinterpret_cast<const float*>(reinterpret_cast<const char*>(tab) + o);",
         '  float c;\n  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(c) : "r"(o));'),
        ("      ml[i] = code8(tab, byte_at(offs_lo(word), e & 3), lane_of(rl, e));\n"
         "      mh[i] = code8(tab, byte_at(offs_hi(word), e & 3), lane_of(rh, e));",
         "      ml[i] = code8(tab, __byte_perm(offs_lo(word), smem_u32(tab), 0x7650 | (e & 3)),\n"
         "                    lane_of(rl, e));\n"
         "      mh[i] = code8(tab, __byte_perm(offs_hi(word), smem_u32(tab), 0x7650 | (e & 3)),\n"
         "                    lane_of(rh, e));")],
    # the packed bytes fetched two of a warpgroup's k-steps ahead: three staging
    # slots a warpgroup, one k-step fewer in the ring (W8A8_RINGS)
    "bytes two k-steps ahead": [
        ("  static constexpr int STAGES = MT == 1 ? 6 : 4;",
         "  static constexpr int STAGES = MT == 1 ? 5 : 3;"),
        ("  static constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 4 * W_STAGE_BYTES + 1024;",
         "  static constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 6 * W_STAGE_BYTES + 1024;"),
        ("  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 4 * W_STAGE_BYTES);",
         "  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 6 * W_STAGE_BYTES);"),
        ("    uint8_t* mine = staging + pw * 2 * W_STAGE_BYTES + pt * 8;",
         "    uint8_t* mine = staging + pw * 3 * W_STAGE_BYTES + pt * 8;"),
        ("                             mine + ((s >> 1) & 1) * W_STAGE_BYTES + i * 128 * 8)),",
         "                             mine + ((s >> 1) % 3) * W_STAGE_BYTES + i * 128 * 8)),"),
        ("                     ? *reinterpret_cast<const uint2*>(mine + ((s >> 1) & 1) * W_STAGE_BYTES +",
         "                     ? *reinterpret_cast<const uint2*>(mine + ((s >> 1) % 3) * W_STAGE_BYTES +"),
        ("    issue(pw);\n", "    issue(pw);\n    issue(pw + 2);\n"),
        ("      issue(s + 2);\n      asm volatile(\"cp.async.wait_group 1;\" ::: \"memory\");",
         "      issue(s + 4);\n      asm volatile(\"cp.async.wait_group 2;\" ::: \"memory\");")],
}
# variants whose ring differs from the plan's: ({rows a CTA: k-steps in the
# ring}, staged k-steps of packed bytes)
W8A8_RINGS = {"bytes two k-steps ahead": ({128: 5, 256: 3}, 6)}
W8A8_ROWS = (512, 2048)   # serve-paged's commonest w8a8 prefill; a 4 x 512 group
W8A8_MUTANTS = {
    "transposed store 8 k off": [(_Q_STORE, _Q_STORE.replace("((rg & 1) << 3)",
                                                             "(((rg & 1) ^ 1) << 3)"))],
    "last k-step dropped": MUTANTS["last k-step dropped"],
    "no proxy fence": MUTANTS["no proxy fence"],
}
W8A8_MUTANT_TESTS = "w8a8"
# the verify chunk's split-KV attention (paged_attention_split.cu)
PAGED_MUTANTS = {
    "the decode at C = 1 appending one slot late": [(
        "      const int pos = len + j;\n",
        "      const int pos = len + j + (C == 1);\n")],
    "row c's window edge taken from row 0": [(
        "    first_vis[i] = r >= R ? INT_MAX : window > 0 ? len + r / G - window + 1 : 0;",
        "    first_vis[i] = r >= R ? INT_MAX : window > 0 ? len - window + 1 : 0;")],
    "a key row read from the previous page": [("      const int pg = pos / page;\n",
                                               "      const int pg = max(pos / page - 1, 0);\n")],
    "the splits' rescale dropped": [(
        "      const float sc = expf(__ldg(ws + n_parts * HD + part + sp * R + r) - M);",
        "      const float sc = 1.f;")],
}
PAGED_MUTANT_TESTS = "paged"
# the direct int8 forward at decode rows (qmm_i8_direct_decode.cu)
I8_DIRECT_MUTANTS = {
    "a split boundary one k-step off": [
        ("  const int s_hi = (int)((long long)(split + 1) * ksteps / splits);",
         "  const int s_hi = (int)((long long)(split + 1) * ksteps / splits) - 1;")],
    "a row's max from its own split only": [
        ("      for (int sp = 0; sp < splits; ++sp) amax = max(amax, *cluster.map_shared_rank(pmax + tid, sp));",
         "      amax = pmax[tid];")],
    # past 16 rows two warps share the strip's columns
    "a second column group reading the first's columns": [
        ("const int c = cb + cw * (COLS / L::CG) + g * 4 * LW;", "const int c = cb + g * 4 * LW;")],
}
I8_DIRECT_MUTANT_TESTS = "i8_direct"
# the w8a8 forward over NF4 at decode rows (qmm_nf4_w8a8_decode.cu)
NF4_W8A8_MUTANTS = {
    "a column's max from its own split only": [
        ("    float col = *cluster.map_shared_rank(pcol + tid, 0);\n"
         "    for (int sp = 1; sp < splits; ++sp) col = fmaxf(col, *cluster.map_shared_rank(pcol + tid, sp));",
         "    float col = pcol[tid];")],
    "the high plane reads the low plane's absmax row": [
        ("absmax_row<DQ>(am, absmax, scale, off, K2 / B + blk, c, N);",
         "absmax_row<DQ>(am, absmax, scale, off, blk, c, N);")],
    "a split boundary one k-step off": [
        ("  const int s_hi = (int)((long long)(split + 1) * ksteps / splits);",
         "  const int s_hi = (int)((long long)(split + 1) * ksteps / splits) - 1;")],
}
NF4_W8A8_MUTANT_TESTS = "nf4_w8a8_decode"
# which source each set of mutants edits, and the cuda tests run against them
MUTANT_SETS = {"nf4": ("qmm_nf4_wgmma.cu", MUTANTS, MUTANT_TESTS),
               "int8": ("qmm_i8_wgmma.cu", I8_MUTANTS, I8_MUTANT_TESTS),
               "nf4bwd": ("qmm_nf4_bwd_wgmma.cu", NF4_BWD_MUTANTS, NF4_BWD_MUTANT_TESTS),
               "flash": ("flash_attention_wgmma.cu", FLASH_MUTANTS, FLASH_MUTANT_TESTS),
               "i8decode": ("qmm_i8_decode.cu", I8_DECODE_MUTANTS, I8_DECODE_MUTANT_TESTS),
               "attention": ("decode_attention_split.cu", ATTN_MUTANTS, ATTN_MUTANT_TESTS),
               "w8a8": ("qmm_nf4_w8a8_wgmma.cu", W8A8_MUTANTS, W8A8_MUTANT_TESTS),
               "paged": ("paged_attention_split.cu", PAGED_MUTANTS, PAGED_MUTANT_TESTS),
               "i8direct": ("qmm_i8_direct_decode.cu", I8_DIRECT_MUTANTS,
                            I8_DIRECT_MUTANT_TESTS),
               "nf4w8a8": ("qmm_nf4_w8a8_decode.cu", NF4_W8A8_MUTANTS, NF4_W8A8_MUTANT_TESTS)}
SETS = tuple(MUTANT_SETS)


def mutants(sets) -> int:
    """Each mutant in a copy of the checkout, its cuda tests run there."""
    import shutil

    base = ROOT / "build" / "mutants"
    survived = []
    todo = [(source, tests, name, edits) for source, table, tests in (MUTANT_SETS[k] for k in sets)
            for name, edits in table.items()]
    for source, tests, name, edits in todo:
        name = f"{Path(source).stem} {name}"
        dst = base / name.replace(" ", "_").replace("'", "")
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(ROOT, dst, ignore=shutil.ignore_patterns(
            "build", "chiprun_out", ".git", "__pycache__"))
        src = dst / "qlora_tpu_torch" / "csrc" / source
        text = src.read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"mutant {name!r}: the source no longer holds {old[:48]!r}")
            text = text.replace(old, new)
        src.write_text(text)
        run = subprocess.run(
            [sys.executable, "-m", "pytest", "tests/test_torch_cuda.py", "-m", "cuda", "-q",
             "--noconftest", "-p", "no:cacheprovider", "-k", tests],
            cwd=dst, capture_output=True, text=True, timeout=900)
        tail = run.stdout.strip().splitlines()[-1] if run.stdout.strip() else run.stderr[-300:]
        print(f"tile_sweep mutant {name!r}: {tail}", flush=True)
        if run.returncode == 0:
            survived.append(name)
    print(f"tile_sweep mutants surviving: {survived}", flush=True)
    return 1 if survived else 0


def build(variants) -> dict:
    """Compile every (source, name, edits, entries, argtypes) at once, one
    nvcc each; {(source, name, entry): typed C entry}.  `argtypes` is one
    list for every entry, or a dict by entry."""
    from qlora_tpu_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = []
    for source, name, edits, entries, argtypes in variants:
        text = (CSRC / source).read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{source} {name!r}: the source no longer holds {old[:48]!r}")
            text = text.replace(old, new)
        stem = f"{Path(source).stem}_{re.sub(r'[^A-Za-z0-9]+', '_', name)}"   # nvcc splits on commas
        (OUT / f"{stem}.cu").write_text(text)
        lib = OUT / f"lib{stem}.so"
        procs.append((source, name, entries, argtypes, lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(OUT / f"{stem}.cu")])))
    fns = {}
    for source, name, entries, argtypes, lib, proc in procs:
        if proc.wait() != 0:
            raise RuntimeError(f"{source} {name!r}: nvcc failed")
        for entry in entries:
            fn = getattr(ctypes.CDLL(str(lib)), entry)
            fn.argtypes = argtypes[entry] if isinstance(argtypes, dict) else argtypes
            fn.restype = ctypes.c_int
            fns[(source, name, entry)] = fn
    return fns


def events_ms(fn, iters: int = 20) -> float:
    import torch

    for i in range(2):
        fn(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 50) -> float:
    """Device time of fn(i) over `iters` launches captured in one CUDA graph:
    the flash wrappers' host time exceeds their kernels' on the card's host,
    so events around launches issued one by one would time the host."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
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
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def copies_past_l2(qt) -> list:
    return [qt] + [dataclasses.replace(qt, packed=qt.packed.clone(), absmax=qt.absmax.clone())
                   for _ in range(max(1, -(-2 * L2_BYTES // qt.nbytes)) - 1)]


def main(sets) -> int:
    import torch

    if not torch.cuda.is_available():
        print("tile_sweep: no CUDA device", file=sys.stderr)
        return 2
    from qlora_tpu_torch.quant import quantize

    qm = importlib.import_module("qlora_tpu_torch.ops.qmatmul")
    dev = torch.device("cuda", torch.cuda.current_device())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    P, I = ctypes.c_void_p, ctypes.c_int
    wgmma_args = [P] * 7 + [I] * 8 + [P]
    variants = []
    if "nf4" in sets:
        variants += [("qmm_nf4_wgmma.cu", n, e, ["qmm_nf4_wgmma"], wgmma_args)
                     for n, e in WGMMA.items()]
        variants += [("qmm_nf4_fwd.cu", n, e, ["qmm_nf4_fwd"], qm._ARGTYPES) for n, e in TILE.items()]
    if "int8" in sets:
        variants += [("qmm_i8_wgmma.cu", n, e, ["qmm_i8_wgmma_fwd", "qmm_i8_wgmma_bwd"], wgmma_args)
                     for n, e in I8.items()]
        variants += [("qmm_i8.cu", "as built", [], ["qmm_i8_fwd", "qmm_i8_bwd"], qm._ARGTYPES)]
    if "nf4bwd" in sets:
        variants += [("qmm_nf4_bwd_wgmma.cu", n, e, ["qmm_nf4_bwd_wgmma"], wgmma_args)
                     for n, e in NF4_BWD.items()]
        variants += [("qmm_nf4_bwd.cu", "as built", [], ["qmm_nf4_bwd"], qm._ARGTYPES)]
    w8a8_args = [P] * 7 + [I] * 7 + [P]
    if "w8a8" in sets:
        variants += [("qmm_nf4_w8a8_wgmma.cu", n, e, ["qmm_nf4_w8a8_wgmma"], w8a8_args)
                     for n, e in W8A8.items()]
    if "flash" in sets:
        fa = importlib.import_module("qlora_tpu_torch.ops.flash_attention")
        variants += [("flash_attention_wgmma.cu", n, e,
                      [FLASH_ENTRIES[k] for k in kernels], fa._WGMMA_ARGS)
                     for n, (e, kernels, _) in FLASH.items() if e or n == "as built"]
    built = build(variants)
    g = torch.Generator(device=dev).manual_seed(6)
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def run(fns, copies, a, out, M, K, N, plan, label):
        # each copy's arguments, made once: the loop times the launches alone
        argsets = []
        for q in copies:
            _, _, scale, offset = qm._check_quantized(q, dev)
            code = None if q.quant_type == "int8" else qm._code_on(q.quant_type, dev).data_ptr()
            argsets.append([a.data_ptr(), q.packed.data_ptr(), q.absmax.data_ptr(),
                            scale.data_ptr(), offset.data_ptr(), code, out.data_ptr(), M, K, N,
                            q.block_size, 1] + ([] if plan is None else
                                                [plan.tm, plan.stages, plan.smem]))
        line = []
        for name, fn in fns.items():
            def launch(i, fn=fn):
                err = fn(*argsets[i % len(argsets)], stream())
                if err:
                    raise RuntimeError(f"{label} {name}: cudaError_t {err}")
            line.append(f"{name} {events_ms(launch):.4f}")
        print(f"tile_sweep {label} M={M} K={K} N={N} (ms): " + ", ".join(line), flush=True)

    for K, N in SHAPES:
        if "nf4" in sets:
            qt = quantize(torch.randn(K, N, device=dev, generator=g) * K ** -0.5)
            copies = copies_past_l2(qt)
            for M in ROWS:
                x = torch.randn(M, K, device=dev, generator=g).to(torch.bfloat16)
                y = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
                run({n: built[("qmm_nf4_wgmma.cu", n, "qmm_nf4_wgmma")] for n in WGMMA}, copies,
                    x, y, M, K, N, qm.tile_plan(M, K, N, qt.block_size), "wgmma")
                run({n: built[("qmm_nf4_fwd.cu", n, "qmm_nf4_fwd")] for n in TILE}, copies, x, y,
                    M, K, N, None, "tile (before)")
        if "int8" in sets:
            qt = quantize(torch.randn(K, N, device=dev, generator=g) * K ** -0.5,
                          quant_type="int8")
            copies = copies_past_l2(qt)
            M = ROWS[0]
            for bwd, d in ((False, "fwd"), (True, "bwd")):
                a = torch.randn(M, N if bwd else K, device=dev, generator=g).to(torch.bfloat16)
                out = torch.empty(M, K if bwd else N, dtype=torch.bfloat16, device=dev)
                plan = qm.i8_tile_plan(M, K, N, qt.block_size, bwd)
                run({n: built[("qmm_i8_wgmma.cu", n, f"qmm_i8_wgmma_{d}")] for n in I8}, copies, a,
                    out, M, K, N, plan, f"i8 wgmma {d}")
                tm128 = dataclasses.replace(plan, tm=128, stages=qm._I8_STAGES[128],
                                            smem=qm.i8_tile_smem(128))
                run({"as built": built[("qmm_i8_wgmma.cu", "as built", f"qmm_i8_wgmma_{d}")]},
                    copies, a, out, M, K, N, tm128, f"i8 wgmma {d} (128-row CTAs)")
                run({"as built": built[("qmm_i8.cu", "as built", f"qmm_i8_{d}")]}, copies, a, out,
                    M, K, N, None, f"i8 tile {d} (before)")
        if "nf4bwd" in sets:
            qt = quantize(torch.randn(K, N, device=dev, generator=g) * K ** -0.5)
            copies = copies_past_l2(qt)
            M = ROWS[0]
            a = torch.randn(M, N, device=dev, generator=g).to(torch.bfloat16)
            out = torch.empty(M, K, dtype=torch.bfloat16, device=dev)
            plan = qm.nf4_bwd_tile_plan(M, K, N, qt.block_size)
            run({n: built[("qmm_nf4_bwd_wgmma.cu", n, "qmm_nf4_bwd_wgmma")] for n in NF4_BWD},
                copies, a, out, M, K, N, plan, "nf4 wgmma bwd")
            tm128 = dataclasses.replace(plan, tm=128, stages=qm._I8_STAGES[128],
                                        smem=qm.nf4_bwd_tile_smem(128))
            run({"as built": built[("qmm_nf4_bwd_wgmma.cu", "as built", "qmm_nf4_bwd_wgmma")]},
                copies, a, out, M, K, N, tm128, "nf4 wgmma bwd (128-row CTAs)")
            run({"as built": built[("qmm_nf4_bwd.cu", "as built", "qmm_nf4_bwd")]}, copies, a,
                out, M, K, N, None, "nf4 bwd tile (before)")
        if "w8a8" in sets:
            w8a8_sweep(built, dev, g, K, N)
    if "flash" in sets:
        flash_sweep(built, dev, g)
    return 0


def w8a8_sweep(built, dev, g, K, N) -> None:
    """The w8a8 kernel's variants at W8A8_ROWS, and as built on 128-row CTAs,
    beside qmm_i8_direct.cu's NF4 path (the "before") and torch._int_mm on
    the decoded int8 weight (rows padded to 32); NF4 storage with double
    quant, operands rotated past L2, CUDA events."""
    import torch

    from qlora_tpu_torch.quant import quantize

    qm = importlib.import_module("qlora_tpu_torch.ops.qmatmul")
    qt = quantize(torch.randn(K, N, device=dev, generator=g) * K ** -0.5)
    copies = copies_past_l2(qt)
    ratio, s_out = qm.w8a8_scales(qt)
    code = qm._code_on(qt.quant_type, dev)
    w8s = [qm.w8a8_codes(q, ratio) for q in copies]
    stream = lambda: torch.cuda.current_stream().cuda_stream
    for M in W8A8_ROWS:
        x8, xs = qm.quantize_rows(torch.randn(M, K, device=dev, generator=g))
        y = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
        plan = qm.w8a8_tile_plan(M, K, N, qt.block_size)
        tm128 = dataclasses.replace(plan, tm=128, stages=qm._W8A8_STAGES[128],
                                    smem=qm.w8a8_tile_smem(128))
        def ring(name):
            if name not in W8A8_RINGS:
                return plan
            stages, staged = W8A8_RINGS[name]
            st = stages[plan.tm]
            return dataclasses.replace(plan, stages=st, smem=1024 + st * (
                2 * plan.tm * plan.tkp + 2 * plan.tn * plan.tkp) + staged * plan.tkp * plan.tn + 1024)

        runs = [(n, built[("qmm_nf4_w8a8_wgmma.cu", n, "qmm_nf4_w8a8_wgmma")], ring(n))
                for n in W8A8] + [("as built, 128-row CTAs", built[(
                    "qmm_nf4_w8a8_wgmma.cu", "as built", "qmm_nf4_w8a8_wgmma")], tm128)]
        line = []
        for name, fn, p in runs:
            def launch(i, fn=fn, p=p):
                q = copies[i % len(copies)]
                err = fn(x8.data_ptr(), q.packed.data_ptr(), ratio.data_ptr(), s_out.data_ptr(),
                         xs.data_ptr(), code.data_ptr(), y.data_ptr(), M, K, N, q.block_size,
                         p.tm, p.stages, p.smem, stream())
                if err:
                    raise RuntimeError(f"w8a8 {name}: cudaError_t {err}")
            line.append(f"{name} {events_ms(launch):.4f}")
        before = events_ms(lambda i: qm._launch_w8a8("qmm_nf4_w8a8", x8, copies[i % len(copies)],
                                                     ratio, s_out, xs))
        xp = torch.nn.functional.pad(x8, (0, 0, 0, (-M) % 32))
        int_mm = events_ms(lambda i: torch._int_mm(xp, w8s[i % len(w8s)]))
        line += [f"qmm_i8_direct.cu (before) {before:.4f}", f"torch._int_mm {int_mm:.4f}"]
        print(f"tile_sweep w8a8 M={M} K={K} N={N} tm={plan.tm} (ms): " + ", ".join(line),
              flush=True)


def _replan(plan, kernel, tile):
    """`plan` with one kernel's (rows, cols, stages) replaced (None keeps the
    plan's), its shared memory and grid recomputed."""
    fa = importlib.import_module("qlora_tpu_torch.ops.flash_attention")
    kp = getattr(plan, kernel)
    rows, cols, stages = (new if new is not None else old
                          for new, old in zip(tile, (kp.rows, kp.cols, kp.stages)))
    grid = ((plan.B * plan.KVH, -(-plan.Skv // cols)) if kernel == "dkv"
            else (plan.B * plan.H, -(-plan.Sq // rows)))
    kp = fa.KernelPlan(kernel, rows, cols, stages,
                       fa.flash_smem(kernel, plan.D, rows, cols, stages), grid)
    return dataclasses.replace(plan, **{kernel: kp})


def flash_sweep(built, dev, g) -> None:
    """Every flash variant at chip_smoke.py's three timed shapes, each kernel
    beside flash_attention.cu's (the "before"), operands rotated past L2,
    device times in CUDA graphs."""
    import torch

    fa = importlib.import_module("qlora_tpu_torch.ops.flash_attention")
    D = 128
    for B, H, KVH, S, lens, window in FLASH_SHAPES:
        mk = lambda *s: torch.randn(*s, device=dev, generator=g).to(torch.bfloat16)
        one = 3 * B * H * S * D * 2 + 2 * B * KVH * S * D * 2
        sets = [(mk(B, H, S, D), mk(B, KVH, S, D), mk(B, KVH, S, D), mk(B, H, S, D))
                for _ in range(max(1, -(-2 * L2_BYTES // one)))]
        L = torch.tensor(lens, device=dev, dtype=torch.int32)
        sm = D ** -0.5
        q, k, v, do = sets[0]
        o, lse = fa.flash_fwd(q, k, v, L, sm, True, window)
        di = (o.float() * do.float()).sum(-1)
        lse_out, dq = torch.empty_like(lse), torch.empty_like(q)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        plan = fa.flash_plan(B, H, KVH, S, S, D, True, window)

        def operands(kernel, i):
            q, k, v, do = sets[i % len(sets)]
            if kernel == "fwd":
                return (q, k, v, L, o, lse_out), (q, k, v, o)
            if kernel == "dq":
                return (q, k, v, L, do, lse, di, dq), (q, k, v, do, dq)
            return (q, k, v, L, do, lse, di, dk, dv), (q, k, v, do, dk, dv)

        before = {"fwd": lambda i: fa._flash_fwd_before(*sets[i % len(sets)][:3], L, sm, True,
                                                        window),
                  "dq": lambda i: fa._flash_bwd_dq_before(*sets[i % len(sets)][:3], L,
                                                          sets[i % len(sets)][3], lse, di, sm,
                                                          True, window),
                  "dkv": lambda i: fa._flash_bwd_dkv_before(*sets[i % len(sets)][:3], L,
                                                            sets[i % len(sets)][3], lse, di, sm,
                                                            True, window)}
        for kernel, entry in FLASH_ENTRIES.items():
            line = []
            for name, (edits, kernels, tiles) in FLASH.items():
                if kernel not in kernels:
                    continue
                p = _replan(plan, kernel, tiles[kernel]) if kernel in tiles else plan
                fn = built[("flash_attention_wgmma.cu", name if edits else "as built", entry)]
                ms = graph_ms(lambda i: fa._launch(entry, *operands(kernel, i), p, sm, fn=fn))
                line.append(f"{name} {ms:.4f}")
            line.append(f"flash_attention.cu (before) {graph_ms(before[kernel]):.4f}")
            print(f"tile_sweep flash {kernel} B={B} H={H} KVH={KVH} hd={D} S={S} "
                  f"lens={list(lens)} window={window} (ms): " + ", ".join(line), flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    chosen = [k for k in SETS if k in args] or list(SETS)
    sys.exit(mutants(chosen) if "--mutants" in args else main(chosen))
