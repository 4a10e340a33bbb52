// Direct int8 x int8 matmul for a few rows (decode), the rows of x quantized
// in the kernel: the serving engines' decode path over a per-column int8
// weight (w8a8).
//   xs[m] = max|x[m]| / 127 (1 for a zero row), x8 = round(x / xs),
//   y[m, n] = bf16(bf16(float(x8 @ codes)[m, n] * s_out[n]) * bf16(xs[m])),
//   s_out = col / 127, with M <= 16.
//
// Replaces the TPU kernel qlora_tpu/ops/qmatmul.py::_qmm_pallas_i8_direct
// (_i8_direct_kernel, pallas_call at qmatmul.py:358) at decode rows, and the
// row quantization that its jitted body does before the pallas_call.  It
// takes the place of qmm_i8_direct.cu (a WMMA tile kernel: 16-row fragments,
// ceil(N/64) blocks each walking all of K, no load in flight during the
// products, rows quantized by PyTorch ops before it), which stays as the
// "before" and keeps more rows and the shapes the plan refuses
// (ops/qmatmul.py: i8_direct_decode_plan).
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
// are few, and x is at most 16 rows.
//
// Design (qmm_i8_decode.cu's, with int8 operands and the rows quantized in
// the kernel):
// - Split K across blocks.  A block owns a strip of 128 output columns and
//   one split: a run of whole 32-row k-steps, from a plan that depends only on
//   (K, N) and the SM count (ops/qmatmul.py: i8_direct_decode_plan), never on
//   M.  The splits of a strip form one thread-block cluster (at most 16).
//   Its 4 warps walk consecutive k-steps of the split.
// - A lane streams 16 bytes (16 columns) of 8 rows of each k-step (rows 4t ..
//   4t + 3 and 16 + 4t .. 16 + 4t + 3) with ld.global.nc, L1 no-allocate; 8
//   lanes read 128 contiguous bytes of a row.  The next k-step is in flight
//   while one is multiplied; the codes are used as stored.
// - Products on mma.sync m16n8k32 (s8 in, s32 accumulators) with the roles
//   swapped: the weight is the 16-row A operand (16 output columns) and x8
//   the 8-column B operand (8 rows of x), so M <= 8 pads nothing.  An A
//   register holds 4 consecutive k of one column, so the lane's 4 x 4 blocks
//   of bytes (4 rows by 4 columns) are transposed with prmt (__byte_perm); a
//   B register is 4 consecutive bytes of a row of x8, so x8 is staged as it
//   lies.
// - Rows quantized in the kernel: the first weight loads are requested, then
//   each block stages its split's slice of x (bf16) and takes each row's
//   largest |x| over it.  After a cluster barrier every block reads all the
//   splits' maxima from their shared memories (distributed shared memory),
//   so every block of every cluster sees the row's full max; it makes xs and
//   its slice of x8 in shared memory.
// - The warps' int32 partials are added in warp order in shared memory; after
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
// - Shapes: K % 32 == 0, N % 16 == 0 (a lane's 16 columns are in range or
//   not), a split of at most 4096 rows (its slice of x staged whole).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int COLS = 128;       // output columns of a block: 16 bytes a lane, 8 lanes a row
constexpr int TILES = 8;        // mma tiles of a warp per k-step (16 columns each)
constexpr int WARPS = 4;        // warps of a block, each a part of the split's k-steps
constexpr int KSTEP = 32;       // rows of W a k-step: one m16n8k32's depth
constexpr int DEPTH = 1;        // k-steps of weight rows in flight per lane beside the one multiplied
constexpr int MAX_ROWS = 4096;  // rows of W a split: its slice of x is staged whole
constexpr int MAX_SPLITS = 16;  // the largest cluster (non-portable above 8)
constexpr int MAX_M = 16;       // rows of x
constexpr float INV127 = 1.f / 127.f;

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

template <int MT>
__global__ void __launch_bounds__(WARPS * 32, 3)
qmm_i8_direct_decode_kernel(const __nv_bfloat16* __restrict__ x,
                            const int8_t* __restrict__ codes, const float* __restrict__ col,
                            void* __restrict__ y, int8_t* __restrict__ x8_io,
                            float* __restrict__ xs_io, int M, int K, int N, int splits,
                            int given, int pitch, int xpitch) {
  // [0, 2 * MAX_M) words: the split's row maxima (f32 bits) and the rows' xs;
  // then x8 of the slice [MT*8][pitch] words and the slice of x [M][xpitch]
  // bf16; after the k loop, from x8 on, the warps' partials and then the
  // block's partial [M][COLS] int32, which the cluster reads
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* pmax = smem;
  float* xsv = reinterpret_cast<float*>(smem + MAX_M);
  uint32_t* x8s = smem + 2 * MAX_M;
  __nv_bfloat16* xb = reinterpret_cast<__nv_bfloat16*>(x8s + MT * 8 * pitch);

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int lane = tid & 31, wk = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.y;
  const int ksteps = K / KSTEP;
  const int s_lo = (int)((long long)split * ksteps / splits);
  const int s_hi = (int)((long long)(split + 1) * ksteps / splits);
  const int r0 = s_lo * KSTEP;                       // the split's first row of W
  const int nsteps = s_hi - s_lo;
  const int w0 = wk * nsteps / WARPS, w1 = (wk + 1) * nsteps / WARPS;   // the warp's k-steps

  const int cb = blockIdx.x * COLS;  // the block's columns
  const int c = cb + g * 16;         // this lane's 16 columns, all in range or none
  const bool live = c < N;
  const uint8_t* cu = reinterpret_cast<const uint8_t*>(codes);

  // k-step s of the split: the lane's rows 4t + h and 16 + 4t + h (h < 4)
  auto load_step = [&](uint4 (&v)[8], int s) {
#pragma unroll
    for (int h = 0; h < 8; ++h) {
      const int row = r0 + KSTEP * s + 4 * t + (h & 3) + 16 * (h >> 2);
      v[h] = live ? ld_stream(cu + (size_t)row * N + c) : make_uint4(0, 0, 0, 0);
    }
  };

  // the first k-steps of weight rows, requested before the rows are quantized
  uint4 ring[DEPTH][8];
#pragma unroll
  for (int j = 0; j < DEPTH; ++j)
    if (w0 + j < w1) load_step(ring[j], w0 + j);

  // the split's slice of x staged, and each row's largest |x| over it (as
  // bf16 bits without the sign, which order as the values do)
  const int rows = nsteps * KSTEP;
  if (!given) {
    for (int m = wk; m < M; m += WARPS) {
      const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)m * K + r0);
      uint4* dst = reinterpret_cast<uint4*>(xb + (size_t)m * xpitch);
      uint32_t mx = 0;
      for (int ch = lane; ch < rows / 8; ch += 32) {
        const uint4 v = __ldg(src + ch);
        dst[ch] = v;
        mx = __vmaxu2(mx, __vmaxu2(__vmaxu2(v.x & 0x7fff7fffu, v.y & 0x7fff7fffu),
                                   __vmaxu2(v.z & 0x7fff7fffu, v.w & 0x7fff7fffu)));
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
  for (int i = tid; i < MT * 8 * words; i += WARPS * 32) {
    const int m = i / words, j = i % words;
    uint32_t v = 0;
    if (m < M) {
      uint32_t* at = reinterpret_cast<uint32_t*>(x8_io + (size_t)m * K + r0) + j;
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
      // tr[hh][j][e]: column 4j + e of the lane's 16 at k 4t + 16 hh .. + 3
      uint32_t tr[2][4][4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t w[4] = {word_of(ring[jr][4 * hh], j), word_of(ring[jr][4 * hh + 1], j),
                                 word_of(ring[jr][4 * hh + 2], j),
                                 word_of(ring[jr][4 * hh + 3], j)};
          transpose4(w, tr[hh][j]);
        }
      if (s + DEPTH < w1) load_step(ring[jr], s + DEPTH);  // refill DEPTH k-steps ahead
#pragma unroll
      for (int i = 0; i < TILES; ++i) {
        // tile i: columns c + 2i (A row g) and c + 2i + 1 (A row g + 8)
        const int j = i >> 1, e = 2 * (i & 1);
        const uint32_t a[4] = {tr[0][j][e], tr[0][j][e + 1], tr[1][j][e], tr[1][j][e + 1]};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_s8(acc[mt][i], a, bx[mt][0], bx[mt][1]);
      }
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
// one cluster) runs of whole 32-row k-steps, at most 4096 rows each.  M <= 16,
// K % 32 == 0, N % 16 == 0.  Returns the launch's cudaError_t
// (cudaErrorInvalidValue for a bad shape or plan).
extern "C" int qmm_i8_direct_decode(const void* x, const void* codes, const void* col, void* y,
                                    void* x8, void* xs, int M, int K, int N, int splits,
                                    int given, void* stream) {
  const int ksteps = K / KSTEP;
  if (M < 1 || M > MAX_M || K < KSTEP || K % KSTEP || N < 16 || N % 16 || splits < 1 ||
      splits > MAX_SPLITS || splits > ksteps || (given && (x8 == nullptr || xs == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = (ksteps + splits - 1) / splits * KSTEP;  // the longest split
  if (rows > MAX_ROWS) return static_cast<int>(cudaErrorInvalidValue);
  const int mt = M > 8 ? 2 : 1;
  const int pitch = (rows / 4 + 31) / 32 * 32 + 4;  // words; 4 mod 32: conflict-free B loads
  const int xpitch = rows;
  const size_t stage = (size_t)mt * 8 * pitch * 4 + (given ? 0 : (size_t)M * xpitch * 2);
  const size_t parts = ((size_t)(WARPS - 1) * mt * TILES * 4 * 32 + (size_t)M * COLS) * 4;
  const size_t smem = 2 * MAX_M * 4 + (stage > parts ? stage : parts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mt == 2)
    return launch<2>(x, codes, col, y, x8, xs, M, K, N, splits, given, pitch, xpitch, smem, s);
  return launch<1>(x, codes, col, y, x8, xs, M, K, N, splits, given, pitch, xpitch, smem, s);
}
