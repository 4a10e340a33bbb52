// Direct int8 x int8 matmul for a few rows (decode steps and verify chunks),
// the rows of x quantized in the kernel: the serving engines' decode path over
// a per-column int8 weight (w8a8).
//   xs[m] = max|x[m]| / 127 (1 for a zero row), x8 = round(x / xs),
//   y[m, n] = bf16(bf16(float(x8 @ codes)[m, n] * s_out[n]) * bf16(xs[m])),
//   s_out = col / 127, with M <= 64.
//
// Replaces the TPU kernel qlora_tpu/ops/qmatmul.py::_qmm_pallas_i8_direct
// (_i8_direct_kernel, pallas_call at qmatmul.py:358) at up to 64 rows, and
// the row quantization that its jitted body does before the pallas_call.  It
// takes the place of qmm_i8_direct.cu (a WMMA tile kernel: 16-row fragments,
// ceil(N/64) blocks each walking all of K, no load in flight during the
// products, rows quantized by PyTorch ops before it), which stays as the
// "before" and keeps more rows and the shapes the plans refuse
// (ops/qmatmul.py: i8_direct_decode_plan up to 16 rows, i8_direct_verify_plan
// at 17 to 64).
//
// Arithmetic, that of quantize_rows and qmm_i8_direct_plain on the card, bit
// for bit: PyTorch divides a CUDA tensor by a Python scalar (amax / 127.0,
// col / 127.0) as a multiplication by the f32 reciprocal, and a tensor by a
// tensor (x / xs) as a true division; torch.round rounds half to even.  So
//   xs = __fmul_rn(amax, 1/127), 1 where that is 0;
//   x8 = __float2int_rn(__fdiv_rn(x, xs));
//   s_out = __fmul_rn(col, 1/127);
//   y = bf16(__fmul_rn(float(bf16(__fmul_rn(__int2float_rn(acc), s_out))),
//                      float(bf16(xs)))).
// No --use_fast_math: the divisions stay IEEE.
//
// What bounds it on an H100: the bytes of the weight, K*N codes, over 3.35
// TB/s (a 4096 x 4096 weight: 16.8 MB, 0.005 ms).  The products (2*M*K*N)
// are few, and x is at most 64 rows.
//
// Design (qmm_i8_decode.cu's, with int8 operands and the rows quantized in
// the kernel):
// - Split K across blocks.  A block owns a strip of 128 output columns and
//   one split: a run of whole 32-row k-steps, from a plan that depends only on
//   (K, N), the SM count and whether M passes 16 (ops/qmatmul.py:
//   i8_direct_decode_plan, i8_direct_verify_plan), never on the rows' values.
//   The splits of a strip form one thread-block cluster (at most 16).
// - Rows of x in MT B tiles of 8 (MT = ceil(M / 8), 1 to 8): each transposed
//   weight fragment is multiplied by every B tile, so the weight is streamed
//   once for all the rows and only the products grow with M.  The accumulators
//   a lane holds are MT x 4 a 16-column tile, so the layout changes past 16
//   rows (Lay below):
//   up to 16 rows (MT <= 2), a lane streams 16 bytes (16 columns, 8 tiles) of
//   8 rows of each k-step and the block's 4 warps walk consecutive k-steps of
//   the split; past 16 rows, a lane streams 8 bytes (8 columns, 4 tiles), two
//   warps side by side cover the strip's 128 columns and each pair walks half
//   of the split's k-steps (at MT = 8: 128 accumulators a lane, registers
//   bounded for 2 blocks an SM).
// - A lane reads rows 4t .. 4t + 3 and 16 + 4t .. 16 + 4t + 3 of each k-step
//   with ld.global.nc, L1 no-allocate; 8 lanes read 128 (64 past 16 rows)
//   contiguous bytes of a row.  The next k-step is in flight while one is
//   multiplied; the codes are used as stored.
// - Products on mma.sync m16n8k32 (s8 in, s32 accumulators) with the roles
//   swapped: the weight is the 16-row A operand (16 output columns) and x8
//   the 8-column B operand (8 rows of x), so M pads only to a multiple of 8.
//   An A register holds 4 consecutive k of one column, so the lane's 4 x 4
//   blocks of bytes (4 rows by 4 columns) are transposed with prmt
//   (__byte_perm); a B register is 4 consecutive bytes of a row of x8, so x8
//   is staged as it lies.
// - Rows quantized in the kernel: the first weight loads are requested, then
//   each block stages its split's slice of x (bf16; past 16 rows it only reads
//   it, and reads it again to quantize: 64 rows of bf16 would crowd out a
//   second block) and takes each row's largest |x| over it.  After a cluster
//   barrier every block reads all the splits' maxima from their shared
//   memories (distributed shared memory), so every block of every cluster
//   sees the row's full max; it makes xs and its slice of x8 in shared memory.
// - The warps' int32 partials are added in the order of their k-steps (each
//   column group apart) in shared memory; after
//   a cluster barrier each block reads a slice of the strip's output from all
//   the cluster's shared memories and adds the splits in split order.  One
//   epilogue.  No atomics: two calls give the same bits, and a row's result
//   does not depend on M or the other rows.
// - With col null the entry writes the int32 accumulators instead of y; with
//   x8 and xs given it also writes the x8 and xs it made (the blocks of the
//   first strip), so that a check can hold all three to their plain
//   versions bit for bit.  With `given` it reads x8 and xs from there instead
//   of quantizing x (a replay of other row codes, and decode_sweep's variant
//   with the rows quantized outside the kernel).
// - Shapes: K % 32 == 0, N % 16 == 0 (a lane's 16 or 8 columns are in range
//   or not), a split of at most 4096 rows up to 16 rows of x (its slice of x
//   staged whole) and 1536 past them (x8 of 64 rows of it staged whole).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int COLS = 128;       // output columns of a block: 16 bytes a lane, 8 lanes a row
constexpr int TILES = 8;        // mma tiles of a warp per k-step up to 16 rows (16 columns each)
constexpr int WIDE_TILES = 4;   // the same past 16 rows: two warps side by side over the columns
constexpr int WARPS = 4;        // warps of a block
constexpr int KSTEP = 32;       // rows of W a k-step: one m16n8k32's depth
constexpr int DEPTH = 1;        // k-steps of weight rows in flight per lane beside the one multiplied
constexpr int MAX_ROWS = 4096;  // rows of W a split up to 16 rows: its slice of x is staged whole
constexpr int WIDE_MAX_ROWS = 1536;  // the same past 16 rows: x8 of the slice is staged whole
constexpr int MAX_SPLITS = 16;  // the largest cluster (non-portable above 8)
constexpr int NARROW_M = 16;    // rows of x the 16-column layout takes
constexpr int MAX_M = 64;       // rows of x
constexpr float INV127 = 1.f / 127.f;

// the layout at MT B tiles: T mma tiles a warp a k-step (LW words of 4
// columns a lane a row), CG warps side by side over the block's columns, KG
// warps (or pairs) one after another over the split's k-steps
template <int MT>
struct Lay {
  static constexpr bool WIDE = MT * 8 > NARROW_M;
  static constexpr int T = WIDE ? WIDE_TILES : TILES;
  static constexpr int LW = T / 2;
  static constexpr int CG = TILES / T;
  static constexpr int KG = WARPS / CG;
};

template <int LW>
__device__ __forceinline__ void ld_stream(const uint8_t* p, uint32_t (&v)[LW]) {
  if constexpr (LW == 4)
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
        : "l"(p));
  else
    asm("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];" : "=r"(v[0]), "=r"(v[1]) : "l"(p));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// four bf16 of a row (two words) over xs: their codes in one word
__device__ __forceinline__ uint32_t codes_of(uint32_t lo, uint32_t hi, float xs) {
  return code_of(lo & 0xffffu, xs) | code_of(lo >> 16, xs) << 8 | code_of(hi & 0xffffu, xs) << 16 |
         code_of(hi >> 16, xs) << 24;
}

// the largest |x| of 8 bf16 as bf16 bits without the sign (which order as
// the values do), folded into mx two halves at a time
__device__ __forceinline__ uint32_t max_of(uint32_t mx, const uint4& v) {
  return __vmaxu2(mx, __vmaxu2(__vmaxu2(v.x & 0x7fff7fffu, v.y & 0x7fff7fffu),
                               __vmaxu2(v.z & 0x7fff7fffu, v.w & 0x7fff7fffu)));
}

// Past 16 rows, a split's slice of x is read from global memory (L2) twice,
// by loops that keep many loads in flight: the rows' maxima, warp wk taking
// rows wk, wk + WARPS, .. all at once (R of them), and then x8, each thread
// R x 8 bytes of it a pass.
template <int R>
__device__ __forceinline__ void wide_row_max(const __nv_bfloat16* x, uint32_t* pmax, int M, int K,
                                             int r0, int rows, int wk, int lane) {
  uint32_t mx[R];
#pragma unroll
  for (int r = 0; r < R; ++r) mx[r] = 0;
  for (int ch = lane; ch < rows / 8; ch += 32) {
    uint4 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int m = wk + WARPS * r;
      v[r] = m < M ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)m * K + r0) + ch)
                   : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) mx[r] = max_of(mx[r], v[r]);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    uint32_t m2 = max(mx[r] & 0xffffu, mx[r] >> 16);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m2 = max(m2, __shfl_xor_sync(0xffffffffu, m2, o));
    if (lane == 0 && wk + WARPS * r < M) pmax[wk + WARPS * r] = m2 << 16;
  }
}

template <int R>
__device__ __forceinline__ void wide_quantize(const __nv_bfloat16* x, const float* xsv,
                                              uint32_t* x8s, int8_t* x8_io, bool keep, int M,
                                              int tile_rows, int rows, int K, int r0, int pitch,
                                              int tid) {
  const int pairs = rows / 8;             // 8 bf16 of a row of the slice: two words of x8
  const int total = tile_rows * pairs;    // over the B tiles' rows, 0 past M
  for (int i0 = tid; i0 < total; i0 += WARPS * 32 * R) {
    uint4 b[R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int i = i0 + WARPS * 32 * u, m = i / pairs, j = i % pairs;
      b[u] = i < total && m < M
                 ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)m * K + r0) + j)
                 : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int i = i0 + WARPS * 32 * u, m = i / pairs, j = i % pairs;
      if (i >= total) break;
      uint2 v = make_uint2(0, 0);
      if (m < M) {
        const float xs = xsv[m];
        v = make_uint2(codes_of(b[u].x, b[u].y, xs), codes_of(b[u].z, b[u].w, xs));
        if (keep) *reinterpret_cast<uint2*>(x8_io + (size_t)m * K + r0 + 8 * j) = v;
      }
      *reinterpret_cast<uint2*>(x8s + m * pitch + 2 * j) = v;
    }
  }
}

template <int MT>
__global__ void __launch_bounds__(WARPS * 32, Lay<MT>::WIDE ? 2 : 3)
qmm_i8_direct_decode_kernel(const __nv_bfloat16* __restrict__ x,
                            const int8_t* __restrict__ codes, const float* __restrict__ col,
                            void* __restrict__ y, int8_t* __restrict__ x8_io,
                            float* __restrict__ xs_io, int M, int K, int N, int splits,
                            int given, int pitch, int xpitch) {
  // [0, 2 * MAX_M) words: the split's row maxima (f32 bits) and the rows' xs;
  // then x8 of the slice [MT*8][pitch] words and (up to 16 rows) the slice of
  // x [M][xpitch] bf16; after the k loop, from x8 on, the warps' partials and
  // then the block's partial [M][COLS] int32, which the cluster reads
  using L = Lay<MT>;
  constexpr int T = L::T, LW = L::LW;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* pmax = smem;
  float* xsv = reinterpret_cast<float*>(smem + MAX_M);
  uint32_t* x8s = smem + 2 * MAX_M;
  __nv_bfloat16* xb = reinterpret_cast<__nv_bfloat16*>(x8s + MT * 8 * pitch);

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int lane = tid & 31, wk = tid >> 5;
  const int cw = wk % L::CG, kw = wk / L::CG;   // the warp's columns and its part of the k-steps
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.y;
  const int ksteps = K / KSTEP;
  const int s_lo = (int)((long long)split * ksteps / splits);
  const int s_hi = (int)((long long)(split + 1) * ksteps / splits);
  const int r0 = s_lo * KSTEP;                       // the split's first row of W
  const int nsteps = s_hi - s_lo;
  const int w0 = kw * nsteps / L::KG, w1 = (kw + 1) * nsteps / L::KG;   // the warp's k-steps

  const int cb = blockIdx.x * COLS;  // the block's columns
  const int c = cb + cw * (COLS / L::CG) + g * 4 * LW;  // the lane's 4 LW columns, all in range or none
  const bool live = c < N;
  const uint8_t* cu = reinterpret_cast<const uint8_t*>(codes);

  // k-step s of the split: the lane's rows 4t + h and 16 + 4t + h (h < 4)
  auto load_step = [&](uint32_t (&v)[8][LW], int s) {
#pragma unroll
    for (int h = 0; h < 8; ++h) {
      const int row = r0 + KSTEP * s + 4 * t + (h & 3) + 16 * (h >> 2);
      if (live) {
        ld_stream<LW>(cu + (size_t)row * N + c, v[h]);
      } else {
#pragma unroll
        for (int j = 0; j < LW; ++j) v[h][j] = 0;
      }
    }
  };

  // the first k-steps of weight rows, requested before the rows are quantized
  uint32_t ring[DEPTH][8][LW];
#pragma unroll
  for (int j = 0; j < DEPTH; ++j)
    if (w0 + j < w1) load_step(ring[j], w0 + j);

  // the split's slice of x staged (up to 16 rows), and each row's largest |x|
  // over it (as bf16 bits without the sign, which order as the values do)
  const int rows = nsteps * KSTEP;
  if (!given && L::WIDE) {
    wide_row_max<MT * 8 / WARPS>(x, pmax, M, K, r0, rows, wk, lane);
  } else if (!given) {
    for (int m = wk; m < M; m += WARPS) {
      const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)m * K + r0);
      uint4* dst = reinterpret_cast<uint4*>(xb + (size_t)m * xpitch);
      uint32_t mx = 0;
      for (int ch = lane; ch < rows / 8; ch += 32) {
        const uint4 v = __ldg(src + ch);
        dst[ch] = v;
        mx = max_of(mx, v);
      }
      mx = max(mx & 0xffffu, mx >> 16);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      if (lane == 0) pmax[m] = mx << 16;
    }
  }
  cluster.sync();  // every split's maxima are written, and this block's slice is staged

  // each row's xs from every split's maximum, then the slice of x8 as it lies
  // (4 bytes of a row a word; rows past M are 0)
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
  __syncthreads();
  const int words = rows / 4;
  const bool keep = !given && x8_io != nullptr && blockIdx.x == 0;
  if (!given && L::WIDE) {
    wide_quantize<8>(x, xsv, x8s, x8_io, keep, M, MT * 8, rows, K, r0, pitch, tid);
  } else {
    for (int i = tid; i < MT * 8 * words; i += WARPS * 32) {
      const int m = i / words, j = i % words;
      uint32_t v = 0;
      if (m < M) {
        uint32_t* at = reinterpret_cast<uint32_t*>(x8_io + (size_t)m * K + r0) + j;
        if (given) {
          v = *at;
        } else {
          const uint2 b = *reinterpret_cast<const uint2*>(xb + (size_t)m * xpitch + 4 * j);
          v = codes_of(b.x, b.y, xsv[m]);
          if (keep) *at = v;
        }
      }
      x8s[m * pitch + j] = v;
    }
  }
  __syncthreads();

  int acc[MT][T][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][i][e] = 0;

  for (int base = w0; base < w1; base += DEPTH) {
#pragma unroll
    for (int jr = 0; jr < DEPTH; ++jr) {
      const int s = base + jr;
      if (s >= w1) break;
      // B: x8 rows g (+ 8 mt), k 4t .. 4t + 3 and 16 + 4t .. 16 + 4t + 3
      uint32_t bx[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        bx[mt][0] = x8s[(mt * 8 + g) * pitch + 8 * s + t];
        bx[mt][1] = x8s[(mt * 8 + g) * pitch + 8 * s + 4 + t];
      }
      // tr[hh][j][e]: column 4j + e of the lane's 4 LW at k 4t + 16 hh .. + 3
      uint32_t tr[2][LW][4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int j = 0; j < LW; ++j) {
          const uint32_t w[4] = {ring[jr][4 * hh][j], ring[jr][4 * hh + 1][j],
                                 ring[jr][4 * hh + 2][j], ring[jr][4 * hh + 3][j]};
          transpose4(w, tr[hh][j]);
        }
      if (s + DEPTH < w1) load_step(ring[jr], s + DEPTH);  // refill DEPTH k-steps ahead
#pragma unroll
      for (int i = 0; i < T; ++i) {
        // tile i: columns c + 2i (A row g) and c + 2i + 1 (A row g + 8)
        const int j = i >> 1, e = 2 * (i & 1);
        const uint32_t a[4] = {tr[0][j][e], tr[0][j][e + 1], tr[1][j][e], tr[1][j][e + 1]};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_s8(acc[mt][i], a, bx[mt][0], bx[mt][1]);
      }
    }
  }

  // the warps' partials added in the order of their k-steps, each column
  // group's apart
  constexpr int RA = MT * T * 4;  // accumulators a lane
  __syncthreads();                // x8 consumed: the buffer takes the partials
  int* red = reinterpret_cast<int*>(x8s);
  int* part = red + (WARPS - L::CG) * RA * 32;  // the block's partial [M][COLS]
  if (kw > 0) {
    int* dst = red + (wk - L::CG) * RA * 32 + lane;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < T; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[((mt * T + i) * 4 + e) * 32] = acc[mt][i][e];
  }
  __syncthreads();
  if (kw == 0) {
    for (int k = 1; k < L::KG; ++k) {
      const int* src = red + ((k - 1) * L::CG + cw) * RA * 32 + lane;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < T; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][i][e] += src[((mt * T + i) * 4 + e) * 32];
    }
    // lane (g, t) holds rows 2t, 2t + 1 (+ 8 mt) at columns c + 2i (A row g)
    // and c + 2i + 1 (A row g + 8)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mt * 8 + 2 * t + h;
        if (m >= M) continue;
#pragma unroll
        for (int i = 0; i < T; i += 2)
          *reinterpret_cast<int4*>(part + m * COLS + (c - cb) + 2 * i) =
              make_int4(acc[mt][i][h], acc[mt][i][2 + h], acc[mt][i + 1][h], acc[mt][i + 1][2 + h]);
      }
  }

  // each block of the cluster sums a slice of the strip's output over the
  // splits, in split order, from the splits' shared memories
  cluster.sync();
  const int q4 = M * (COLS / 4);
  const int e0 = split * q4 / splits, e1 = (split + 1) * q4 / splits;
  for (int e = e0 + tid; e < e1; e += WARPS * 32) {
    const int m = e / (COLS / 4), n = cb + 4 * (e % (COLS / 4));
    if (n >= N) continue;
    int4 s = *cluster.map_shared_rank(reinterpret_cast<int4*>(part) + e, 0);
    for (int sp = 1; sp < splits; ++sp) {
      const int4 v = *cluster.map_shared_rank(reinterpret_cast<int4*>(part) + e, sp);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    if (col == nullptr) {
      *reinterpret_cast<int4*>(static_cast<int*>(y) + (size_t)m * N + n) = s;
      continue;
    }
    const float4 cs = __ldg(reinterpret_cast<const float4*>(col + n));
    const float xr = __bfloat162float(__float2bfloat16(xsv[m]));
    const int a[4] = {s.x, s.y, s.z, s.w};
    const float sc[4] = {cs.x, cs.y, cs.z, cs.w};
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float scaled =
          __bfloat162float(__float2bfloat16(__fmul_rn(__int2float_rn(a[j]), __fmul_rn(sc[j], INV127))));
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

template <int MT>
int launch(const void* x, const void* codes, const void* col, void* y, void* x8, void* xs, int M,
           int K, int N, int splits, int given, int pitch, int xpitch, size_t smem,
           cudaStream_t stream) {
  auto kernel = qmm_i8_direct_decode_kernel<MT>;
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
      &cfg, kernel, static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(codes),
      static_cast<const float*>(col), y, static_cast<int8_t*>(x8), static_cast<float*>(xs), M, K,
      N, splits, given, pitch, xpitch);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// x bf16 [M, K] (16-byte aligned; unread when `given`); codes int8 [K, N];
// col f32 [N], the columns' scales (absmax), or null for the raw int32
// accumulators [M, N] in y instead of bf16 [M, N]; x8 int8 [M, K] and xs f32
// [M]: null, or written with the rows as the kernel quantized them, or read
// instead of quantizing x when `given` is 1.  The plan: `splits` (1 to 16,
// one cluster) runs of whole 32-row k-steps, at most 4096 rows each up to 16
// rows of x and 1536 past them.  M <= 64, K % 32 == 0, N % 16 == 0.  Returns
// the launch's cudaError_t (cudaErrorInvalidValue for a bad shape or plan).
extern "C" int qmm_i8_direct_decode(const void* x, const void* codes, const void* col, void* y,
                                    void* x8, void* xs, int M, int K, int N, int splits,
                                    int given, void* stream) {
  const int ksteps = K / KSTEP;
  if (M < 1 || M > MAX_M || K < KSTEP || K % KSTEP || N < 16 || N % 16 || splits < 1 ||
      splits > MAX_SPLITS || splits > ksteps || (given && (x8 == nullptr || xs == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = M > NARROW_M;
  const int rows = (ksteps + splits - 1) / splits * KSTEP;  // the longest split
  if (rows > (wide ? WIDE_MAX_ROWS : MAX_ROWS)) return static_cast<int>(cudaErrorInvalidValue);
  const int mt = (M + 7) / 8;
  const int tiles = wide ? WIDE_TILES : TILES;
  const int pitch = (rows / 4 + 31) / 32 * 32 + 4;  // words; 4 mod 32: conflict-free B loads
  const int xpitch = rows;
  const size_t stage = (size_t)mt * 8 * pitch * 4 + (given || wide ? 0 : (size_t)M * xpitch * 2);
  const size_t parts =
      ((size_t)(WARPS - TILES / tiles) * mt * tiles * 4 * 32 + (size_t)M * COLS) * 4;
  const size_t smem = 2 * MAX_M * 4 + (stage > parts ? stage : parts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mt) {
#define QMM_I8_DIRECT_MT(n) \
  case n:                   \
    return launch<n>(x, codes, col, y, x8, xs, M, K, N, splits, given, pitch, xpitch, smem, s);
    QMM_I8_DIRECT_MT(1)
    QMM_I8_DIRECT_MT(2)
    QMM_I8_DIRECT_MT(3)
    QMM_I8_DIRECT_MT(4)
    QMM_I8_DIRECT_MT(5)
    QMM_I8_DIRECT_MT(6)
    QMM_I8_DIRECT_MT(7)
    QMM_I8_DIRECT_MT(8)
#undef QMM_I8_DIRECT_MT
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
