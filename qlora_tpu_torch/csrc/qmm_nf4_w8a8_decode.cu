// w8a8 matmul over NF4/FP4 storage for a few rows (decode), the rows of x
// quantized and the per-column scales made in the kernel: the serving
// engines' w8a8 decode path over the NF4 weights as stored
// (PagedBatcher(decode_impl="w8a8")).
//   xs[m] = max|x[m]| / 127 (1 for a zero row), x8 = round(x / xs);
//   col[n] = the column's largest absmax (1 where 0), ratio = absmax * (127 / col);
//   w8[k, n] = round(code[nibble] * ratio[k / B, n]);
//   y[m, n] = bf16(bf16(float(x8 @ w8)[m, n] * s_out[n]) * bf16(xs[m])),
//   s_out = col / 127, with M <= 16.
//
// Replaces the TPU kernel qlora_tpu/ops/qmatmul.py::_qmm_pallas_w8a8
// (_w8a8_fwd_kernel, pallas_call at qmatmul.py:270) at decode rows, and the
// row quantization and per-column scales that its jitted body makes before
// the pallas_call.  It takes the place of qmm_i8_direct.cu's NF4 entry
// (qmm_nf4_w8a8: a WMMA tile kernel, 16-row fragments, ceil(N/64) blocks each
// walking all of K, rows quantized and scales made by PyTorch ops before it),
// which stays as the "before" and keeps the shapes the plan refuses
// (ops/qmatmul.py: nf4_w8a8_decode_plan).  Above 16 rows the w8a8 forward runs
// qmm_nf4_w8a8_wgmma.cu.
//
// Arithmetic, that of quantize_rows, w8a8_scales, w8a8_codes and
// qmm_nf4_w8a8_plain on the card, bit for bit: PyTorch divides a CUDA tensor
// by a Python scalar (amax / 127.0, col / 127.0) as a multiplication by the
// f32 reciprocal, and a tensor by a tensor (x / xs, and 127 / col, which
// w8a8_scales writes as a full tensor divided by col, as JAX's true division)
// as a true division; torch.round rounds half to even.  So
//   absmax: f32 as stored, or int8 double quant decoded as
//     __fmaf_rn(q, __fmul_rn(scale, 1/127), offset), as absmax_f32;
//   col = fmaxf over the column's absmax rows (max is exact and commutative,
//     so the order does not matter; +0 and -0 both become 1);
//   ratio = __fmul_rn(absmax, __fdiv_rn(127, col));
//   w8 = the low byte of __fadd_rn(__fmul_rn(code, ratio), 1.5 * 2^23): the
//     product rounded to f32, then to an integer half to even (|code * ratio|
//     is at most 127, far below 2^22), as qmm_nf4_w8a8_wgmma.cu's producers;
//   xs = __fmul_rn(amax, 1/127), 1 where that is 0;
//   x8 = __float2int_rn(__fdiv_rn(x, xs));
//   s_out = __fmul_rn(col, 1/127);
//   y = bf16(__fmul_rn(float(bf16(__fmul_rn(__int2float_rn(acc), s_out))),
//                      float(bf16(xs)))).
// No --use_fast_math: the divisions stay IEEE.
//
// Storage (qlora_tpu_torch/quant/blockwise.py): packed u8 [K/2, N], N
// contiguous; packed row r holds logical row r in its low nibble and row
// K/2 + r in its high one (the split-half planes); absmax [K/B, N] f32, or
// int8 with meta-scales f32 [ceil((K/B)/256), N] and one f32 offset.  The two
// absmax rows of packed row r are r/B and K/(2B) + r/B.
//
// What bounds it on an H100: the bytes of the weight, K*N/2 packed plus the
// absmax, over 3.35 TB/s (a 4096 x 4096 weight with double quant: 8.7 MB,
// 0.0026 ms).  The products (2*M*K*N) are few, and x is at most 16 rows.
//
// Design (qmm_i8_direct_decode.cu's, over packed nibbles):
// - Split K across blocks.  A block owns a strip of 128 output columns and
//   one split: a run of whole k-steps of 32 packed rows, from a plan that
//   depends only on (K, N, B) and the SM count (ops/qmatmul.py:
//   nf4_w8a8_decode_plan), never on M.  The splits of a strip form one
//   thread-block cluster (at most 16).  Its 4 warps walk consecutive k-steps
//   of the split.  A split of packed rows [r0, r1) multiplies x's columns
//   [r0, r1) (the low plane) and [K/2 + r0, K/2 + r1) (the high plane).
// - A lane streams 16 bytes (16 columns) of 8 packed rows of each k-step
//   (rows 4t .. 4t + 3 and 16 + 4t .. 16 + 4t + 3) with ld.global.nc, L1
//   no-allocate; 8 lanes read 128 contiguous bytes of a row.  The next
//   k-step is in flight while one is decoded and multiplied.
// - Products on mma.sync m16n8k32 (s8 in, s32 accumulators) with the roles
//   swapped: the weight is the 16-row A operand (16 output columns) and x8
//   the 8-column B operand (8 rows of x), so M <= 8 pads nothing.  An A
//   register holds 4 consecutive k of one column.  The lane transposes its
//   4 x 4 blocks of packed bytes (4 rows by 4 columns) with prmt
//   (__byte_perm), so that a word holds 4 rows of one column; its 4 low
//   nibbles then become the low plane's A word and its 4 high nibbles the
//   high plane's, each code made with the column's ratio for that plane
//   (one ratio a word: a k-step lies in one absmax block, B % 32 == 0).
//   Transposing the packed bytes before the decode takes half the prmt of
//   transposing each plane's codes after it.  Each tile runs two products a
//   k-step, the low plane's against x8 [r0 + ..] and the high plane's against
//   x8 [K/2 + r0 + ..], as the JAX kernel's xl and xh.
// - The codes: the 16-entry codebook (_code_on's, so FP4 takes the same
//   path) in shared memory, looked up at byte offsets (one prmt a code), then
//   the rounding above.  The lane's 16 columns' ratios of both planes live in
//   registers and are made again at each absmax block from the absmax row
//   (16-byte loads) and the strip's 127 / col.
// - Column scales in the kernel: the first weight loads are requested, then
//   each block takes the largest absmax of its split's absmax rows (both
//   planes) for its 128 columns, stages its split's two runs of x (bf16) and
//   takes each row's largest |x| over them.  After one cluster barrier every
//   block reads all the splits' row and column maxima from their shared
//   memories (distributed shared memory), so every block sees each row's and
//   each column's full maximum; it makes xs, col, 127 / col and its runs of
//   x8 in shared memory (x8 as it lies: the low run, then the high run).
// - The warps' int32 partials are added in warp order in shared memory; after
//   a cluster barrier each block reads a slice of the strip's output from all
//   the cluster's shared memories and adds the splits in split order.  One
//   epilogue.  No atomics: two calls give the same bits, and a row's result
//   does not depend on M or the other rows.
// - With `raw` the entry writes the int32 accumulators instead of y; with
//   x8 and xs given it also writes the x8 and xs it made (the blocks of the
//   first strip), so that a check can hold all three to their plain versions
//   bit for bit.  With `given` it reads x8 and xs from there instead of
//   quantizing x (decode_sweep's variant with the rows quantized outside).
// - Registers: bounded for 3 blocks an SM (167 at MT = 1; MT = 2 spills 96
//   bytes), so that the plan's ~2 blocks an SM (288 blocks at 4096 x 4096, in
//   clusters of 9) run in one wave.  Bounded for 2 (218 / 254 registers, no
//   spill) the kernel took 1.4-1.5x as long; for 4 it spills more and is
//   slower again (python -m qlora_tpu_torch.ops.decode_sweep nf4w8a8).
// - Shapes: K % 64 == 0 (whole k-steps of 32 packed rows, and 16-byte runs
//   of x in both planes), N % 16 == 0 (a lane's 16 columns are in range or
//   not), B % 32 == 0, a split of at most 2048 packed rows (its two runs of x
//   staged whole).  Every LLaMA-7B block linear (B = 64) passes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int COLS = 128;       // output columns of a block: 16 bytes a lane, 8 lanes a row
constexpr int TILES = 8;        // mma tiles of a warp per k-step (16 columns each)
constexpr int WARPS = 4;        // warps of a block, each a part of the split's k-steps
constexpr int KSTEP = 32;       // packed rows of a k-step: one m16n8k32's depth in each plane
constexpr int MAX_ROWS = 2048;  // packed rows of a split: its two runs of x are staged whole
constexpr int MAX_SPLITS = 16;  // the largest cluster (non-portable above 8)
constexpr int MAX_M = 16;       // rows of x
constexpr float INV127 = 1.f / 127.f;
constexpr float ROUNDER = 12582912.f;  // 1.5 * 2^23
static_assert(WARPS * 32 == COLS, "a thread takes one column's maximum");

__device__ __forceinline__ uint4 ld_stream(const uint8_t* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// a 4 x 4 block of bytes transposed: w[r] holds row r's byte e at bits 8e;
// t[e] gets byte e of w[0], w[1], w[2], w[3] at bits 0, 8, 16, 24
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4], uint32_t (&t)[4]) {
  const uint32_t p0 = __byte_perm(w[0], w[1], 0x5140);   // w0.0 w1.0 w0.1 w1.1
  const uint32_t p1 = __byte_perm(w[0], w[1], 0x7362);   // w0.2 w1.2 w0.3 w1.3
  const uint32_t p2 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t p3 = __byte_perm(w[2], w[3], 0x7362);
  t[0] = __byte_perm(p0, p2, 0x5410);
  t[1] = __byte_perm(p0, p2, 0x7632);
  t[2] = __byte_perm(p1, p3, 0x5410);
  t[3] = __byte_perm(p1, p3, 0x7632);
}

// one bf16 of x over xs, rounded half to even: an int8 code in the low byte
__device__ __forceinline__ uint32_t code_of(uint32_t bf16_bits, float xs) {
  return (uint32_t)__float2int_rn(__fdiv_rn(__uint_as_float(bf16_bits << 16), xs)) & 0xffu;
}

// absmax of (absmax row blk, column n), as absmax_f32 computes it
template <bool DQ>
__device__ __forceinline__ float absmax_at(const void* absmax, const float* scale, float off,
                                           int blk, int n, int N) {
  if (DQ) {
    const int8_t* q = static_cast<const int8_t*>(absmax);
    const float s = __fmul_rn(__ldg(scale + (size_t)(blk / 256) * N + n), INV127);
    return __fmaf_rn((float)__ldg(q + (size_t)blk * N + n), s, off);
  }
  return __ldg(static_cast<const float*>(absmax) + (size_t)blk * N + n);
}

// the absmax of a lane's 16 columns [c, c + 16) in absmax row blk, 16-byte
// loads (N % 16 == 0); 0 past N
template <bool DQ>
__device__ __forceinline__ void absmax_row(float (&am)[16], const void* absmax,
                                           const float* scale, float off, int blk, int c, int N) {
  if (c >= N) {
#pragma unroll
    for (int j = 0; j < 16; ++j) am[j] = 0.f;
    return;
  }
  if (DQ) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(
        static_cast<const int8_t*>(absmax) + (size_t)blk * N + c));
    const float4* sp = reinterpret_cast<const float4*>(scale + (size_t)(blk / 256) * N + c);
    const uint32_t qw[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float4 s4 = __ldg(sp + v);
      const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float qv = (float)(int8_t)(qw[v] >> (8 * e));
        am[4 * v + e] = __fmaf_rn(qv, __fmul_rn(sv[e], INV127), off);
      }
    }
  } else {
    const float4* ap = reinterpret_cast<const float4*>(
        static_cast<const float*>(absmax) + (size_t)blk * N + c);
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float4 a4 = __ldg(ap + v);
      am[4 * v] = a4.x;
      am[4 * v + 1] = a4.y;
      am[4 * v + 2] = a4.z;
      am[4 * v + 3] = a4.w;
    }
  }
}

// 4 * the low or high nibble of each byte of a word: the byte offsets of the
// codes in the codebook, one prmt a byte to take out
__device__ __forceinline__ uint32_t offs_lo(uint32_t w) { return (w << 2) & 0x3C3C3C3Cu; }
__device__ __forceinline__ uint32_t offs_hi(uint32_t w) { return (w >> 2) & 0x3C3C3C3Cu; }
__device__ __forceinline__ uint32_t byte_at(uint32_t o, int e) {
  return __byte_perm(o, 0, 0x4440 | e);
}

// int8(rint(code * ratio)) in the low byte: the product rounded to f32, then
// 1.5 * 2^23 added (rounded half to even onto the integers), as w8a8_codes
__device__ __forceinline__ uint32_t code8(const float* tab, uint32_t o, float ratio) {
  const float c = *reinterpret_cast<const float*>(reinterpret_cast<const char*>(tab) + o);
  return __float_as_uint(__fadd_rn(__fmul_rn(c, ratio), ROUNDER));
}

// the low bytes of four words, in order
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// a word of 4 packed bytes of one column (4 consecutive k) made the 4 int8
// codes of one plane, in byte order, with that column's ratio
template <bool HI>
__device__ __forceinline__ uint32_t codes4(const float* tab, uint32_t w, float ratio) {
  const uint32_t o = HI ? offs_hi(w) : offs_lo(w);
  return pack4(code8(tab, byte_at(o, 0), ratio), code8(tab, byte_at(o, 1), ratio),
               code8(tab, byte_at(o, 2), ratio), code8(tab, byte_at(o, 3), ratio));
}

template <bool DQ, int MT>
__global__ void __launch_bounds__(WARPS * 32, 3)
qmm_nf4_w8a8_decode_kernel(const __nv_bfloat16* __restrict__ x,
                           const uint8_t* __restrict__ packed, const void* __restrict__ absmax,
                           const float* __restrict__ scale, const float* __restrict__ offset,
                           const float* __restrict__ code, void* __restrict__ y,
                           int8_t* __restrict__ x8_io, float* __restrict__ xs_io, int M, int K,
                           int N, int B, int splits, int given, int raw, int pitch, int xpitch) {
  // x8 of the split's two runs [MT*8][pitch] words (the low plane's packed
  // rows, then the high plane's) and the two runs of x [M][xpitch] bf16;
  // after the k loop, from x8 on, the warps' partials and then the block's
  // partial [M][COLS] int32, which the cluster reads
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ float tab[16];
  __shared__ uint32_t pmax[MAX_M];   // the split's row maxima (f32 bits)
  __shared__ float xsv[MAX_M];       // the rows' xs
  __shared__ float pcol[COLS];       // the split's largest absmax of each column
  __shared__ float ccol[COLS];       // the columns' col
  __shared__ float cinv[COLS];       // and 127 / col
  uint32_t* x8s = smem;
  __nv_bfloat16* xb = reinterpret_cast<__nv_bfloat16*>(x8s + MT * 8 * pitch);

  cg::cluster_group cluster = cg::this_cluster();
  const int K2 = K / 2;
  const int tid = threadIdx.x;
  const int lane = tid & 31, wk = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.y;
  const int ksteps = K2 / KSTEP;
  const int s_lo = (int)((long long)split * ksteps / splits);
  const int s_hi = (int)((long long)(split + 1) * ksteps / splits);
  const int r0 = s_lo * KSTEP;                       // the split's first packed row
  const int nsteps = s_hi - s_lo;
  const int rows = nsteps * KSTEP;                   // its packed rows: a run of x a plane
  const int w0 = wk * nsteps / WARPS, w1 = (wk + 1) * nsteps / WARPS;   // the warp's k-steps

  const int cb = blockIdx.x * COLS;  // the block's columns
  const int c = cb + g * 16;         // this lane's 16 columns, all in range or none
  const bool live = c < N;
  const float off = DQ ? *offset : 0.f;
  if (tid < 16) tab[tid] = code[tid];

  // k-step s of the split: the lane's packed rows 4t + h and 16 + 4t + h (h < 4)
  auto load_step = [&](uint4 (&v)[8], int s) {
#pragma unroll
    for (int h = 0; h < 8; ++h) {
      const int row = r0 + KSTEP * s + 4 * t + (h & 3) + 16 * (h >> 2);
      v[h] = live ? ld_stream(packed + (size_t)row * N + c) : make_uint4(0, 0, 0, 0);
    }
  };

  // the first k-step of packed rows, requested before the scales are made
  uint4 ring[8];
  if (w0 < w1) load_step(ring, w0);

  // the split's largest absmax of each of the block's columns, both planes
  {
    const int n = cb + tid;
    float mx = 0.f;
    if (n < N) {
      const int b0 = r0 / B, b1 = (r0 + rows - 1) / B;
      mx = absmax_at<DQ>(absmax, scale, off, b0, n, N);
      for (int b = b0; b <= b1; ++b)
        mx = fmaxf(mx, fmaxf(absmax_at<DQ>(absmax, scale, off, b, n, N),
                             absmax_at<DQ>(absmax, scale, off, K2 / B + b, n, N)));
    }
    pcol[tid] = mx;
  }

  // the split's two runs of x staged, and each row's largest |x| over them
  // (as bf16 bits without the sign, which order as the values do)
  if (!given) {
    for (int m = wk; m < M; m += WARPS) {
      uint32_t mx = 0;
#pragma unroll
      for (int plane = 0; plane < 2; ++plane) {
        const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)m * K + plane * K2 + r0);
        uint4* dst = reinterpret_cast<uint4*>(xb + (size_t)m * xpitch + plane * rows);
        for (int ch = lane; ch < rows / 8; ch += 32) {
          const uint4 v = __ldg(src + ch);
          dst[ch] = v;
          mx = __vmaxu2(mx, __vmaxu2(__vmaxu2(v.x & 0x7fff7fffu, v.y & 0x7fff7fffu),
                                     __vmaxu2(v.z & 0x7fff7fffu, v.w & 0x7fff7fffu)));
        }
      }
      mx = max(mx & 0xffffu, mx >> 16);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      if (lane == 0) pmax[m] = mx << 16;
    }
  }
  cluster.sync();  // every split's maxima are written, and this block's runs are staged

  // each row's xs and each column's col from every split's maxima
  if (tid < M) {
    float xs;
    if (given) {
      xs = xs_io[tid];
    } else {
      uint32_t amax = 0;
      for (int sp = 0; sp < splits; ++sp) amax = max(amax, *cluster.map_shared_rank(pmax + tid, sp));
      xs = __fmul_rn(__uint_as_float(amax), INV127);
      if (xs == 0.f) xs = 1.f;
      if (xs_io != nullptr && blockIdx.x == 0 && split == 0) xs_io[tid] = xs;
    }
    xsv[tid] = xs;
  }
  {
    float col = *cluster.map_shared_rank(pcol + tid, 0);
    for (int sp = 1; sp < splits; ++sp) col = fmaxf(col, *cluster.map_shared_rank(pcol + tid, sp));
    if (col == 0.f) col = 1.f;
    ccol[tid] = col;
    cinv[tid] = __fdiv_rn(127.f, col);
  }
  __syncthreads();

  // the runs of x8 as they lie (4 bytes of a row a word: the low run's words,
  // then the high run's; rows past M are 0)
  const int words = rows / 4;        // words of a run
  const bool keep = !given && x8_io != nullptr && blockIdx.x == 0;
  for (int i = tid; i < MT * 8 * 2 * words; i += WARPS * 32) {
    const int m = i / (2 * words), j = i % (2 * words);
    const int plane = j >= words;
    uint32_t v = 0;
    if (m < M) {
      uint32_t* at =
          reinterpret_cast<uint32_t*>(x8_io + (size_t)m * K + plane * K2 + r0) + (j - plane * words);
      if (given) {
        v = *at;
      } else {
        const uint2 b = *reinterpret_cast<const uint2*>(xb + (size_t)m * xpitch + 4 * j);
        const float xs = xsv[m];
        v = code_of(b.x & 0xffffu, xs) | code_of(b.x >> 16, xs) << 8 |
            code_of(b.y & 0xffffu, xs) << 16 | code_of(b.y >> 16, xs) << 24;
        if (keep) *at = v;
      }
    }
    x8s[m * pitch + j] = v;
  }
  __syncthreads();

  int acc[MT][TILES][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < TILES; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][i][e] = 0;
  float rl[16], rh[16];  // the lane's columns' ratios, low and high plane, of absmax block rblk
  int rblk = -1;

  for (int s = w0; s < w1; ++s) {
    const int blk = (r0 + KSTEP * s) / B;
    if (blk != rblk) {
      rblk = blk;
      float am[16];
      absmax_row<DQ>(am, absmax, scale, off, blk, c, N);
#pragma unroll
      for (int j = 0; j < 16; ++j) rl[j] = __fmul_rn(am[j], cinv[g * 16 + j]);
      absmax_row<DQ>(am, absmax, scale, off, K2 / B + blk, c, N);
#pragma unroll
      for (int j = 0; j < 16; ++j) rh[j] = __fmul_rn(am[j], cinv[g * 16 + j]);
    }
    // B: x8 rows g (+ 8 mt), k 4t .. 4t + 3 and 16 + 4t .. 16 + 4t + 3 of the
    // k-step, in the low run and in the high run
    uint32_t bl[MT][2], bh[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint32_t* row = x8s + (mt * 8 + g) * pitch + 8 * s + t;
      bl[mt][0] = row[0];
      bl[mt][1] = row[4];
      bh[mt][0] = row[words];
      bh[mt][1] = row[words + 4];
    }
    // tr[hh][j][e]: column 4j + e of the lane's 16 at packed rows 4t + 16 hh .. + 3
    uint32_t tr[2][4][4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t w[4] = {word_of(ring[4 * hh], j), word_of(ring[4 * hh + 1], j),
                               word_of(ring[4 * hh + 2], j), word_of(ring[4 * hh + 3], j)};
        transpose4(w, tr[hh][j]);
      }
    if (s + 1 < w1) load_step(ring, s + 1);  // the next k-step in flight
#pragma unroll
    for (int i = 0; i < TILES; ++i) {
      // tile i: columns c + 2i (A row g) and c + 2i + 1 (A row g + 8)
      const int j = i >> 1, e = 2 * (i & 1);
      const uint32_t p[4] = {tr[0][j][e], tr[0][j][e + 1], tr[1][j][e], tr[1][j][e + 1]};
      const uint32_t al[4] = {codes4<false>(tab, p[0], rl[2 * i]),
                              codes4<false>(tab, p[1], rl[2 * i + 1]),
                              codes4<false>(tab, p[2], rl[2 * i]),
                              codes4<false>(tab, p[3], rl[2 * i + 1])};
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_s8(acc[mt][i], al, bl[mt][0], bl[mt][1]);
      const uint32_t ah[4] = {codes4<true>(tab, p[0], rh[2 * i]),
                              codes4<true>(tab, p[1], rh[2 * i + 1]),
                              codes4<true>(tab, p[2], rh[2 * i]),
                              codes4<true>(tab, p[3], rh[2 * i + 1])};
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_s8(acc[mt][i], ah, bh[mt][0], bh[mt][1]);
    }
  }

  // the warps' partials added in warp order
  constexpr int RA = MT * TILES * 4;  // accumulators a lane
  __syncthreads();                    // x8 consumed: the buffer takes the partials
  int* red = reinterpret_cast<int*>(x8s);
  int* part = red + (WARPS - 1) * RA * 32;  // the block's partial [M][COLS]
  if (wk > 0) {
    int* dst = red + (wk - 1) * RA * 32 + lane;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < TILES; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[((mt * TILES + i) * 4 + e) * 32] = acc[mt][i][e];
  }
  __syncthreads();
  if (wk == 0) {
    for (int k = 1; k < WARPS; ++k) {
      const int* src = red + (k - 1) * RA * 32 + lane;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < TILES; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][i][e] += src[((mt * TILES + i) * 4 + e) * 32];
    }
    // lane (g, t) holds rows 2t, 2t + 1 (+ 8 mt) at columns 16g + 2i (A row g)
    // and 16g + 2i + 1 (A row g + 8)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mt * 8 + 2 * t + h;
        if (m >= M) continue;
#pragma unroll
        for (int i = 0; i < TILES; i += 2)
          *reinterpret_cast<int4*>(part + m * COLS + g * 16 + 2 * i) =
              make_int4(acc[mt][i][h], acc[mt][i][2 + h], acc[mt][i + 1][h], acc[mt][i + 1][2 + h]);
      }
  }

  // each block of the cluster sums a slice of the strip's output over the
  // splits, in split order, from the splits' shared memories
  cluster.sync();
  const int q4 = M * (COLS / 4);
  const int e0 = split * q4 / splits, e1 = (split + 1) * q4 / splits;
  for (int e = e0 + tid; e < e1; e += WARPS * 32) {
    const int m = e / (COLS / 4), nl = 4 * (e % (COLS / 4)), n = cb + nl;
    if (n >= N) continue;
    int4 s = *cluster.map_shared_rank(reinterpret_cast<int4*>(part) + e, 0);
    for (int sp = 1; sp < splits; ++sp) {
      const int4 v = *cluster.map_shared_rank(reinterpret_cast<int4*>(part) + e, sp);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    if (raw) {
      *reinterpret_cast<int4*>(static_cast<int*>(y) + (size_t)m * N + n) = s;
      continue;
    }
    const float xr = __bfloat162float(__float2bfloat16(xsv[m]));
    const int a[4] = {s.x, s.y, s.z, s.w};
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float s_out = __fmul_rn(ccol[nl + j], INV127);
      const float scaled = __bfloat162float(__float2bfloat16(__fmul_rn(__int2float_rn(a[j]), s_out)));
      o[j] = __fmul_rn(scaled, xr);
    }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(o[0], o[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(o[2], o[3]);
    uint2 out;
    out.x = *reinterpret_cast<const uint32_t*>(&lo);
    out.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(y) + (size_t)m * N + n) = out;
  }
  cluster.sync();  // the cluster's shared memories are read: blocks may exit
}

template <bool DQ, int MT>
int launch(const void* x, const void* packed, const void* absmax, const void* scale,
           const void* offset, const void* code, void* y, void* x8, void* xs, int M, int K, int N,
           int B, int splits, int given, int raw, int pitch, int xpitch, size_t smem,
           cudaStream_t stream) {
  auto kernel = qmm_nf4_w8a8_decode_kernel<DQ, MT>;
  static const cudaError_t attr = [&] {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024);
    return e != cudaSuccess
               ? e
               : cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + COLS - 1) / COLS, splits, 1);
  cfg.blockDim = dim3(WARPS * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = splits;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(packed),
      absmax, static_cast<const float*>(scale), static_cast<const float*>(offset),
      static_cast<const float*>(code), y, static_cast<int8_t*>(x8), static_cast<float*>(xs), M, K,
      N, B, splits, given, raw, pitch, xpitch);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// x bf16 [M, K] (16-byte aligned; unread when `given`); packed u8 [K/2, N];
// absmax int8 (dq) or f32 [K/B, N]; scale f32 [ceil((K/B)/256), N] and offset
// f32 [1] when dq, else unused; code f32 [16]; y bf16 [M, N], or with `raw`
// the int32 accumulators [M, N]; x8 int8 [M, K] and xs f32 [M]: null, or
// written with the rows as the kernel quantized them, or read instead of
// quantizing x when `given` is 1.  The plan: `splits` (1 to 16, one cluster)
// runs of whole k-steps of 32 packed rows, at most 2048 packed rows each.
// M <= 16, K % 64 == 0, N % 16 == 0, block_size % 32 == 0.  Returns the
// launch's cudaError_t (cudaErrorInvalidValue for a bad shape or plan).
extern "C" int qmm_nf4_w8a8_decode(const void* x, const void* packed, const void* absmax,
                                   const void* scale, const void* offset, const void* code,
                                   void* y, void* x8, void* xs, int M, int K, int N,
                                   int block_size, int dq, int splits, int given, int raw,
                                   void* stream) {
  const int ksteps = K / 2 / KSTEP;
  if (M < 1 || M > MAX_M || K < 2 * KSTEP || K % (2 * KSTEP) || N < 16 || N % 16 ||
      block_size < KSTEP || block_size % KSTEP || (K / 2) % block_size || splits < 1 ||
      splits > MAX_SPLITS || splits > ksteps || (given && (x8 == nullptr || xs == nullptr)) ||
      (dq && (scale == nullptr || offset == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = (ksteps + splits - 1) / splits * KSTEP;  // the longest split's packed rows
  if (rows > MAX_ROWS) return static_cast<int>(cudaErrorInvalidValue);
  const int mt = M > 8 ? 2 : 1;
  const int pitch = (2 * rows / 4 + 31) / 32 * 32 + 4;  // words; 4 mod 32: conflict-free B loads
  const int xpitch = 2 * rows;
  const size_t stage = (size_t)mt * 8 * pitch * 4 + (given ? 0 : (size_t)M * xpitch * 2);
  const size_t parts = ((size_t)(WARPS - 1) * mt * TILES * 4 * 32 + (size_t)M * COLS) * 4;
  const size_t smem = stage > parts ? stage : parts;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dq)
    return mt == 2 ? launch<true, 2>(x, packed, absmax, scale, offset, code, y, x8, xs, M, K, N,
                                     block_size, splits, given, raw, pitch, xpitch, smem, s)
                   : launch<true, 1>(x, packed, absmax, scale, offset, code, y, x8, xs, M, K, N,
                                     block_size, splits, given, raw, pitch, xpitch, smem, s);
  return mt == 2 ? launch<false, 2>(x, packed, absmax, scale, offset, code, y, x8, xs, M, K, N,
                                    block_size, splits, given, raw, pitch, xpitch, smem, s)
                 : launch<false, 1>(x, packed, absmax, scale, offset, code, y, x8, xs, M, K, N,
                                    block_size, splits, given, raw, pitch, xpitch, smem, s);
}
