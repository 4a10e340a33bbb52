// Fused int8 dequantize + matmul for a few rows (decode):
// y[M, N] = x[M, K] @ dequant(W)[K, N] with M <= 16 (more rows run as
// groups of 16).
//
// Replaces the TPU kernel qlora_tpu/ops/qmatmul.py::_qmm_pallas_i8
// (_i8_fwd_kernel) at decode rows; its own few-row branch is the TM <= 64
// tiling at qmatmul.py:438-441 (TK up to 1024, TN 128).  Rows above 16 stay
// on qmm_i8_wgmma.cu, and the dx at 16 rows or fewer on qmm_i8.cu.  One
// template, <bool DQ>, serves f32 and double-quantized absmax.
//
// Storage (qlora_tpu_torch/quant/blockwise.py): codes int8 [K, N], N
// contiguous; absmax [K/B, N] f32, or int8 with meta-scales f32
// [ceil((K/B)/256), N] and one f32 offset (absmax = q * (scale * (1/127)) +
// offset as one fused multiply-add).  A weight element is
// bf16((float(code) * (1/127)) * absmax), in that order, which is what
// dequantize() computes: rows of the identity read its bits out.
//
// What bounds it on an H100: the bytes of the weight, K*N codes plus the
// absmax, over 3.35 TB/s (a 4096 x 4096 weight: 17 MB).  The products are
// few (2*M*K*N) and the tensor cores do them.
//
// Design (qmm_nf4_decode.cu's, with int8's simpler decode):
// - Split K across blocks.  A block owns a strip of 128 output columns and
//   one split: a run of whole `unit`s of rows (whole absmax blocks, a
//   multiple of the 16-row k-step), from a plan that depends only on (K, N,
//   B) and the SM count (ops/qmatmul.py: i8_decode_plan), never on M.  Its 4
//   warps walk consecutive k-steps of the split, in passes of at most
//   PASS_ROWS rows whose x fits in shared memory.
// - A lane streams 16 bytes (16 columns) of 4 rows of each k-step (rows 2t,
//   2t + 1, 2t + 8 and 2t + 9) with ld.global.nc, L1 no-allocate; 8 lanes
//   read 128 contiguous bytes of a row.  The next k-step's rows are in
//   flight while one is decoded (a ring of DEPTH slots), and the first are
//   requested before x is staged.
// - The absmax (and meta-scale) of a lane's 16 columns is loaded with
//   16-byte loads and decoded once per absmax block, not once per element.
//   Codes become floats exactly by a byte permute into 2^23's mantissa and
//   one subtraction, as in qmm_i8_wgmma.cu.
// - The products run on mma.sync m16n8k16 (bf16 in, f32 accumulators) with
//   the roles swapped: the decoded weight is the 16-row A operand (16
//   output columns) and x the 8-column B operand (8 rows of x), so M <= 8
//   pads nothing.  Two adjacent k-rows of a column fill one A register; x's
//   own bf16 pairs (x[m, k] | x[m, k + 1] << 16) are the matching B
//   fragments, so x is staged in shared memory as it lies in device memory.
// - The splits of a strip form one thread-block cluster (at most 16).  The
//   warps of a block add their partials in shared memory in warp order;
//   after a cluster barrier each block reads a slice of the strip's output
//   from all the cluster's shared memories (distributed shared memory), adds
//   the splits in split order and rounds to bf16 once.  No atomics: two calls
//   give the same bits, and a row's result does not depend on M or the
//   other rows.
// - Block sizes that are not a multiple of 16 (a k-step crosses absmax
//   blocks) decode each element's absmax where it is used; ragged N and
//   N % 16 != 0 take byte loads; K % 16 != 0 stages x element by element.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int COLS = 128;       // output columns of a block: 16 bytes a lane, 8 lanes a row
constexpr int TILES = 8;        // mma tiles of a warp per k-step (16 columns each)
constexpr int WARPS = 4;        // warps of a block, each a part of the split's k-steps
constexpr int KSTEP = 16;       // rows of W a k-step: one mma's depth
constexpr int DEPTH = 1;        // k-steps of weight rows in flight per lane beside the one decoded
constexpr int PASS_ROWS = 4096; // rows of x staged at once
constexpr int MAX_SPLITS = 16;  // the largest cluster (non-portable above 8)

__device__ __forceinline__ uint4 ld_stream(const uint8_t* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// absmax of (absmax row blk, column n), as dequantize_absmax computes it
template <bool DQ>
__device__ __forceinline__ float absmax_at(const void* absmax, const float* scale, float off,
                                           int blk, int n, int N) {
  if (DQ) {
    const int8_t* q = static_cast<const int8_t*>(absmax);
    const float s = __fmul_rn(__ldg(scale + (size_t)(blk / 256) * N + n), 1.f / 127.f);
    return __fmaf_rn((float)__ldg(q + (size_t)blk * N + n), s, off);
  }
  return __ldg(static_cast<const float*>(absmax) + (size_t)blk * N + n);
}

// the absmax of a lane's 16 columns [c, c + 16) in absmax row blk (0 past N)
template <bool DQ>
__device__ __forceinline__ void absmax_row(float (&am)[16], const void* absmax,
                                           const float* scale, float off, int blk, int c,
                                           int N, bool vec) {
  if (c >= N) {
#pragma unroll
    for (int j = 0; j < 16; ++j) am[j] = 0.f;
    return;
  }
  if (!vec) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      am[j] = c + j < N ? absmax_at<DQ>(absmax, scale, off, blk, c + j, N) : 0.f;
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
        am[4 * v + e] = __fmaf_rn(qv, __fmul_rn(sv[e], 1.f / 127.f), off);
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

// byte e of a word of int8 codes as a float, exactly: the code + 128 as the
// low byte of 2^23's mantissa, less 2^23 + 128
__device__ __forceinline__ float code_at(uint32_t w, int e) {
  return __int_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7440 | e)) - 8388736.f;
}

// two weights of one column, k-rows r (low half) and r + 1, decoded and
// rounded to bf16: (code * (1/127)) * absmax
__device__ __forceinline__ uint32_t decode_pair(float c_lo, float c_hi, float am_lo,
                                                float am_hi) {
  const float r = (float)(1.0 / 127.0);
  const __nv_bfloat162 v = __floats2bfloat162_rn(__fmul_rn(__fmul_rn(c_lo, r), am_lo),
                                                 __fmul_rn(__fmul_rn(c_hi, r), am_hi));
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <bool DQ, bool ALIGNED, int MT>
__global__ void __launch_bounds__(WARPS * 32, MT == 1 ? 4 : 3)
qmm_i8_decode_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ codes,
                     const void* __restrict__ absmax, const float* __restrict__ scale,
                     const float* __restrict__ offset, __nv_bfloat16* __restrict__ y, int M,
                     int K, int N, int B, int splits, int unit, int pitch) {
  // x [MT*8][pitch] words (bf16 pairs); after the k loop, the warps' partials
  // and then the block's partial [rows][COLS] floats, which the cluster reads
  extern __shared__ __align__(16) uint32_t smem[];

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int lane = tid & 31, wk = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * 16;
  const int rows_here = min(M - m0, MT * 8);
  const int units = (K + unit - 1) / unit;
  const int r0 = (int)((long long)split * units / splits) * unit;
  const int r1 = min((int)((long long)(split + 1) * units / splits) * unit, K);

  const int cb = blockIdx.x * COLS;     // the block's columns
  const int c = cb + g * 16;            // this lane's 16 columns
  const bool vec = (N & 15) == 0;       // then c < N means all 16 columns are in range
  const float off = DQ ? *offset : 0.f;
  const uint8_t* cu = reinterpret_cast<const uint8_t*>(codes);
  const int ro[4] = {2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9};   // the lane's rows of a k-step

  auto load_row = [&](int row, int end) -> uint4 {
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row < end && c < N) {
      const uint8_t* p = cu + (size_t)row * N + c;
      if (vec) {
        v = ld_stream(p);
      } else {
        uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (c + j < N) w[j / 4] |= (uint32_t)__ldg(p + j) << (8 * (j % 4));
        v = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    return v;
  };

  float acc[MT][TILES][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < TILES; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][i][e] = 0.f;
  float am[16];  // the lane's columns in the current absmax block (ALIGNED)
  int am_blk = -1;

  for (int p0 = r0; p0 < r1; p0 += PASS_ROWS) {
    const int p1 = min(p0 + PASS_ROWS, r1);
    const int nsteps = (p1 - p0 + KSTEP - 1) / KSTEP;
    const int words = nsteps * (KSTEP / 2);  // x words a row of this pass
    const int s0 = wk * nsteps / WARPS, s1 = (wk + 1) * nsteps / WARPS;

    // a ring of DEPTH k-steps of weight rows and the first absmax block,
    // requested before x is staged
    uint4 ring[DEPTH][4];
#pragma unroll
    for (int j = 0; j < DEPTH; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h)
        ring[j][h] = load_row(p0 + KSTEP * (s0 + j) + ro[h], s0 + j < s1 ? p1 : 0);
    if (ALIGNED && s0 < s1 && (p0 + KSTEP * s0) / B != am_blk) {
      am_blk = (p0 + KSTEP * s0) / B;
      absmax_row<DQ>(am, absmax, scale, off, am_blk, c, N, vec);
    }

    // this pass's x as it lies (bf16 pairs); rows of x past M and k past
    // the pass are 0
    if (p0 != r0) __syncthreads();  // the previous pass's x is consumed
    if ((K & 15) == 0) {  // then p0 and p1 are multiples of 16 and rows 16-byte aligned
      const int chunks = words / 4;
      for (int i = tid; i < MT * 8 * chunks; i += WARPS * 32) {
        const int m = i / chunks, ch = i % chunks;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (m < rows_here)
          v = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + m) * K + p0 + ch * 8);
        *reinterpret_cast<uint4*>(smem + m * pitch + ch * 4) = v;
      }
    } else {
      const unsigned short* xu = reinterpret_cast<const unsigned short*>(x);
      for (int i = tid; i < MT * 8 * words; i += WARPS * 32) {
        const int m = i / words, j = i % words;
        const int k = p0 + 2 * j;
        uint32_t v = 0;
        if (m < rows_here) {
          const size_t at = (size_t)(m0 + m) * K + k;
          if (k < p1) v = xu[at];
          if (k + 1 < p1) v |= (uint32_t)xu[at + 1] << 16;
        }
        smem[m * pitch + j] = v;
      }
    }
    __syncthreads();

    for (int base = s0; base < s1; base += DEPTH) {
#pragma unroll
      for (int jr = 0; jr < DEPTH; ++jr) {
        const int s = base + jr;
        if (s >= s1) break;
        const int kb = p0 + KSTEP * s;
        if (ALIGNED && kb / B != am_blk) {
          am_blk = kb / B;
          absmax_row<DQ>(am, absmax, scale, off, am_blk, c, N, vec);
        }
        uint32_t bx[MT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          bx[mt][0] = smem[(mt * 8 + g) * pitch + 8 * s + t];
          bx[mt][1] = smem[(mt * 8 + g) * pitch + 8 * s + t + 4];
        }
        uint32_t w[4][4];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          w[h][0] = ring[jr][h].x;
          w[h][1] = ring[jr][h].y;
          w[h][2] = ring[jr][h].z;
          w[h][3] = ring[jr][h].w;
        }
        if (s + DEPTH < s1) {  // refill this slot DEPTH k-steps ahead
#pragma unroll
          for (int h = 0; h < 4; ++h) ring[jr][h] = load_row(kb + KSTEP * DEPTH + ro[h], p1);
        }
#pragma unroll
        for (int i = 0; i < TILES; ++i) {
          // tile i: columns c + 2i (A row g) and c + 2i + 1 (A row g + 8),
          // bytes 2i and 2i + 1 of the lane's 16
          float cv[4][2];  // [row ro[h]][column]
#pragma unroll
          for (int h = 0; h < 4; ++h)
#pragma unroll
            for (int q = 0; q < 2; ++q) cv[h][q] = code_at(w[h][i >> 1], 2 * (i & 1) + q);
          uint32_t a[4];
          if (ALIGNED) {
            const float a0 = am[2 * i], a1 = am[2 * i + 1];
            a[0] = decode_pair(cv[0][0], cv[1][0], a0, a0);
            a[1] = decode_pair(cv[0][1], cv[1][1], a1, a1);
            a[2] = decode_pair(cv[2][0], cv[3][0], a0, a0);
            a[3] = decode_pair(cv[2][1], cv[3][1], a1, a1);
          } else {
            // a k-step crosses absmax blocks: each element's own absmax
            float ams[4][2];
#pragma unroll
            for (int h = 0; h < 4; ++h)
#pragma unroll
              for (int q = 0; q < 2; ++q) {
                const int row = kb + ro[h], n = c + 2 * i + q;
                ams[h][q] = row < p1 && n < N ? absmax_at<DQ>(absmax, scale, off, row / B, n, N)
                                              : 0.f;
              }
            a[0] = decode_pair(cv[0][0], cv[1][0], ams[0][0], ams[1][0]);
            a[1] = decode_pair(cv[0][1], cv[1][1], ams[0][1], ams[1][1]);
            a[2] = decode_pair(cv[2][0], cv[3][0], ams[2][0], ams[3][0]);
            a[3] = decode_pair(cv[2][1], cv[3][1], ams[2][1], ams[3][1]);
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][i], a, bx[mt][0], bx[mt][1]);
        }
      }
    }
  }

  // the warps' partials added in warp order
  constexpr int R = MT * TILES * 4;  // accumulators a lane
  __syncthreads();                   // x consumed: the buffer takes the partials
  float* red = reinterpret_cast<float*>(smem);
  float* part = red + (WARPS - 1) * R * 32;  // the block's partial [rows_here][COLS]
  if (wk > 0) {
    float* dst = red + (wk - 1) * R * 32 + lane;
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
      const float* src = red + (k - 1) * R * 32 + lane;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < TILES; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][i][e] += src[((mt * TILES + i) * 4 + e) * 32];
    }
    // lane (g, t) holds rows 2t, 2t+1 (+ 8 mt) at columns 16g + 2i (A row g)
    // and 16g + 2i + 1 (A row g + 8)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mt * 8 + 2 * t + h;
        if (m >= rows_here) continue;
#pragma unroll
        for (int i = 0; i < TILES; i += 2)
          *reinterpret_cast<float4*>(part + m * COLS + g * 16 + 2 * i) =
              make_float4(acc[mt][i][h], acc[mt][i][2 + h], acc[mt][i + 1][h],
                          acc[mt][i + 1][2 + h]);
      }
  }

  // each block of the cluster sums a slice of the strip's output over the
  // splits, in split order, from the splits' shared memories
  cluster.sync();
  const int q4 = rows_here * (COLS / 4);
  const int e0 = split * q4 / splits, e1 = (split + 1) * q4 / splits;
  for (int e = e0 + tid; e < e1; e += WARPS * 32) {
    const int m = e / (COLS / 4), n = cb + 4 * (e % (COLS / 4));
    if (n >= N) continue;
    float4 s = *cluster.map_shared_rank(reinterpret_cast<float4*>(part) + e, 0);
    for (int sp = 1; sp < splits; ++sp) {
      const float4 v = *cluster.map_shared_rank(reinterpret_cast<float4*>(part) + e, sp);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    __nv_bfloat16* out = y + (size_t)(m0 + m) * N + n;
    if ((N & 3) == 0) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(s.x, s.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(s.z, s.w);
      uint2 o;
      o.x = *reinterpret_cast<const uint32_t*>(&lo);
      o.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(out) = o;
    } else {
      const float v[4] = {s.x, s.y, s.z, s.w};
      for (int j = 0; j < 4 && n + j < N; ++j) out[j] = __float2bfloat16(v[j]);
    }
  }
  cluster.sync();  // the cluster's shared memories are read: blocks may exit
}

template <bool DQ, bool ALIGNED, int MT>
int launch(const void* x, const void* codes, const void* absmax, const void* scale,
           const void* offset, void* y, int M, int K, int N, int B, int splits, int unit,
           int pitch, size_t smem, cudaStream_t stream) {
  auto kernel = qmm_i8_decode_kernel<DQ, ALIGNED, MT>;
  static const cudaError_t attr = [&] {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024);
    return e != cudaSuccess
               ? e
               : cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + COLS - 1) / COLS, splits, (M + 15) / 16);
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
      absmax, static_cast<const float*>(scale), static_cast<const float*>(offset),
      static_cast<__nv_bfloat16*>(y), M, K, N, B, splits, unit, pitch);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <bool DQ>
int launch_dq(bool aligned, bool two_tiles, const void* x, const void* codes, const void* absmax,
              const void* scale, const void* offset, void* y, int M, int K, int N, int B,
              int splits, int unit, int pitch, size_t smem, cudaStream_t s) {
  if (aligned)
    return two_tiles ? launch<DQ, true, 2>(x, codes, absmax, scale, offset, y, M, K, N, B,
                                           splits, unit, pitch, smem, s)
                     : launch<DQ, true, 1>(x, codes, absmax, scale, offset, y, M, K, N, B,
                                           splits, unit, pitch, smem, s);
  return two_tiles ? launch<DQ, false, 2>(x, codes, absmax, scale, offset, y, M, K, N, B, splits,
                                          unit, pitch, smem, s)
                   : launch<DQ, false, 1>(x, codes, absmax, scale, offset, y, M, K, N, B, splits,
                                          unit, pitch, smem, s);
}

}  // namespace

// x bf16 [M, K] row-major (16-byte aligned); codes int8 [K, N]; absmax int8
// (dq) or f32 [K/B, N]; scale f32 [ceil((K/B)/256), N] and offset f32 [1]
// when dq, else unused; the codebook argument of the NF4 entries is unused
// here; y bf16 [M, N].  The plan: `splits` (1 to 16, one cluster) runs of
// whole `unit`s of rows, unit a multiple of 16.  Returns the launch's
// cudaError_t (cudaErrorInvalidValue for a bad plan).
extern "C" int qmm_i8_decode(const void* x, const void* codes, const void* absmax,
                             const void* scale, const void* offset, const void* unused, void* y,
                             int M, int K, int N, int block_size, int dq, int splits, int unit,
                             void* stream) {
  (void)unused;
  const int units = unit > 0 ? (K + unit - 1) / unit : 0;
  if (M <= 0 || K <= 0 || N <= 0 || block_size <= 0 || unit <= 0 || unit % KSTEP ||
      splits < 1 || splits > MAX_SPLITS || splits > units)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool two_tiles = M > 8;
  const int mt = two_tiles ? 2 : 1;
  int rows = (units + splits - 1) / splits * unit;
  rows = rows < PASS_ROWS ? rows : PASS_ROWS;
  const int words = (rows + KSTEP - 1) / KSTEP * (KSTEP / 2);
  const int pitch = (words + 31) / 32 * 32 + 4;  // words; 4 mod 32: conflict-free B loads
  const size_t stage = (size_t)mt * 8 * pitch * 4;
  const size_t parts = ((size_t)(WARPS - 1) * mt * TILES * 4 * 32 + mt * 8 * COLS) * 4;
  const size_t smem = stage > parts ? stage : parts;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = block_size % KSTEP == 0;
  if (dq)
    return launch_dq<true>(aligned, two_tiles, x, codes, absmax, scale, offset, y, M, K, N,
                           block_size, splits, unit, pitch, smem, s);
  return launch_dq<false>(aligned, two_tiles, x, codes, absmax, scale, offset, y, M, K, N,
                          block_size, splits, unit, pitch, smem, s);
}
