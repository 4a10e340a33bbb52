// Fused NF4/FP4 dequantize + matmul for a few rows (decode):
// y[M, N] = x[M, K] @ dequant(W)[K, N] with M <= 16 (more rows run as
// groups of 16).
//
// Replaces the TPU kernels qlora_tpu/ops/qmatmul.py::_qmm_pallas_dq (int8
// double-quantized absmax) and ::_qmm_pallas (f32 absmax) at decode rows;
// their own few-row branch is the `if TM <= 64` tiling at qmatmul.py:538.
// Rows above 16 stay on the tile kernel of qmm_nf4_fwd.cu.  One template,
// <bool DQ>, serves both variants.
//
// Storage (qlora_tpu_torch/quant/blockwise.py): packed u8 [K/2, N], N
// contiguous, packed row r holds logical row r in its low nibble and row
// K/2 + r in its high one; absmax [K/B, N] f32, or int8 with meta-scales
// f32 [ceil((K/B)/256), N] and one f32 offset.  K % 2B == 0, so the two
// absmax rows of packed row r are r/B and K/(2B) + r/B.
//
// What bounds it on an H100: the bytes of the weight, K*N/2 packed plus
// the absmax, over 3.35 TB/s (a 4096 x 4096 weight: 8.7 MB).  The products
// are few (2*M*K*N) and the tensor cores do them.
//
// Design:
// - Split K across blocks.  A block owns a strip of 128 output columns and
//   one split: a run of whole `unit`s of packed rows (whole absmax blocks),
//   from a plan that depends only on (K, N, B) and the SM count
//   (ops/qmatmul.py: decode_plan), never on M.  Its 4 warps walk
//   consecutive 8-row k-steps of the split, in passes of at most PASS_ROWS
//   rows whose x fits in shared memory.
// - A lane streams 16 bytes (16 columns) of two packed rows per k-step
//   with ld.global.nc, L1 no-allocate; 8 lanes read 128 contiguous bytes
//   of a row.  The next k-step's rows are in flight while one is decoded
//   (a ring of DEPTH slots; deeper rings measured slower), and the first
//   are issued before x is staged.
// - The absmax (and meta-scale) of a lane's 16 columns is loaded with
//   16-byte loads and decoded once per absmax block, not once per element.
//   The 16-entry codebook lives in shared memory.  Each weight is
//   __fmul_rn(code, absmax) rounded to bf16, as dequantize() and the tile
//   kernel compute it.
// - The products run on mma.sync m16n8k16 (bf16 in, f32 accumulators) with
//   the roles swapped: the decoded weight is the 16-row A operand (16
//   output columns) and x the 8-column B operand (8 rows of x), so M <= 8
//   pads nothing.  The low and high nibble of one byte fill two adjacent k
//   slots; x is staged in shared memory as the same pairs
//   (x[m, r] | x[m, K/2 + r] << 16), so a B fragment is one 32-bit load.
// - The splits of a strip form one thread-block cluster (at most 16).  The
//   warps of a block add their partials in shared memory in warp order;
//   after a cluster barrier each block reads a slice of the strip's output
//   from all the cluster's shared memories (distributed shared memory), adds
//   the splits in split order and rounds to bf16 once.  Nothing goes
//   through device memory but x, the weight and y, and no atomics: two calls
//   give the same bits, and a row's result does not depend on M or the
//   other rows.
// - Block sizes that are not a multiple of 8 (a k-step crosses absmax
//   blocks) decode each element's absmax where it is used; ragged N and
//   N % 16 != 0 take byte loads.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int COLS = 128;       // output columns of a block: 16 bytes a lane, 8 lanes a row
constexpr int TILES = 8;        // mma tiles of a warp per k-step (16 columns each)
constexpr int WARPS = 4;        // warps of a block, each a part of the split's k-steps
constexpr int DEPTH = 1;        // k-steps of weight rows in flight per lane beside the one decoded
constexpr int PASS_ROWS = 2048; // packed rows of x staged at once
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

// the absmax of a lane's 16 columns [c, c + 16) in absmax row blk
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

// one byte's two nibbles decoded to bf16 and paired: low nibble (the
// lower k slot) in the low half
__device__ __forceinline__ uint32_t decode_pair(uint32_t b, float am_lo, float am_hi,
                                                const float* tab) {
  const float lo = __fmul_rn(tab[b & 15], am_lo);
  const float hi = __fmul_rn(tab[(b >> 4) & 15], am_hi);
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <bool DQ, bool ALIGNED, int MT>
__global__ void __launch_bounds__(WARPS * 32, MT == 1 ? 4 : 3)
qmm_decode_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
                  const void* __restrict__ absmax, const float* __restrict__ scale,
                  const float* __restrict__ offset, const float* __restrict__ code,
                  __nv_bfloat16* __restrict__ y, int M, int K, int N, int B, int splits,
                  int unit, int pitch) {
  // x pairs [MT*8][pitch] words; after the k loop, the warps' partials and
  // then the block's partial [rows][COLS] floats, which the cluster reads
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ float tab[16];

  cg::cluster_group cluster = cg::this_cluster();
  const int K2 = K / 2;
  const int tid = threadIdx.x;
  const int lane = tid & 31, wk = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * 16;
  const int rows_here = min(M - m0, MT * 8);
  const int units = (K2 + unit - 1) / unit;
  const int r0 = (int)((long long)split * units / splits) * unit;
  const int r1 = min((int)((long long)(split + 1) * units / splits) * unit, K2);
  if (tid < 16) tab[tid] = code[tid];

  const int cb = blockIdx.x * COLS;     // the block's columns
  const int c = cb + g * 16;            // this lane's 16 columns
  const bool vec = (N & 15) == 0;       // then c < N means all 16 columns are in range
  const float off = DQ ? *offset : 0.f;

  auto load_row = [&](int row, int end) -> uint4 {
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row < end && c < N) {
      const uint8_t* p = packed + (size_t)row * N + c;
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
  float am[2][16];  // [plane][column] of the current absmax block (ALIGNED)
  int am_blk = -1;

  for (int p0 = r0; p0 < r1; p0 += PASS_ROWS) {
    const int p1 = min(p0 + PASS_ROWS, r1);
    const int nsteps = (p1 - p0 + 7) / 8;
    const int s0 = wk * nsteps / WARPS, s1 = (wk + 1) * nsteps / WARPS;

    // a ring of DEPTH k-steps of weight rows and the first absmax block,
    // issued before x is staged
    uint4 ring[DEPTH][2];
#pragma unroll
    for (int j = 0; j < DEPTH; ++j) {
      ring[j][0] = load_row(p0 + 8 * (s0 + j) + t, s0 + j < s1 ? p1 : 0);
      ring[j][1] = load_row(p0 + 8 * (s0 + j) + t + 4, s0 + j < s1 ? p1 : 0);
    }
    if (ALIGNED && s0 < s1 && (p0 + 8 * s0) / B != am_blk) {
      am_blk = (p0 + 8 * s0) / B;
      absmax_row<DQ>(am[0], absmax, scale, off, am_blk, c, N, vec);
      absmax_row<DQ>(am[1], absmax, scale, off, K2 / B + am_blk, c, N, vec);
    }

    // this pass's x, both planes, as bf16 pairs; rows of x past M and
    // packed rows past the split are 0
    if (p0 != r0) __syncthreads();  // the previous pass's x is consumed
    if ((K & 15) == 0) {  // then K/2 and p0 are multiples of 8, and so is p1 - p0
      for (int i = tid; i < MT * 8 * nsteps; i += WARPS * 32) {
        const int m = i / nsteps, ch = i % nsteps;
        uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
        if (m < rows_here) {
          const __nv_bfloat16* row = x + (size_t)(m0 + m) * K + p0 + ch * 8;
          lo = *reinterpret_cast<const uint4*>(row);
          hi = *reinterpret_cast<const uint4*>(row + K2);
        }
        uint4* dst = reinterpret_cast<uint4*>(smem + m * pitch + ch * 8);
        dst[0] = make_uint4(__byte_perm(lo.x, hi.x, 0x5410), __byte_perm(lo.x, hi.x, 0x7632),
                            __byte_perm(lo.y, hi.y, 0x5410), __byte_perm(lo.y, hi.y, 0x7632));
        dst[1] = make_uint4(__byte_perm(lo.z, hi.z, 0x5410), __byte_perm(lo.z, hi.z, 0x7632),
                            __byte_perm(lo.w, hi.w, 0x5410), __byte_perm(lo.w, hi.w, 0x7632));
      }
    } else {
      const unsigned short* xu = reinterpret_cast<const unsigned short*>(x);
      for (int i = tid; i < MT * 8 * nsteps * 8; i += WARPS * 32) {
        const int m = i / (nsteps * 8), j = i % (nsteps * 8);
        uint32_t v = 0;
        if (m < rows_here && p0 + j < p1) {
          const size_t at = (size_t)(m0 + m) * K + p0 + j;
          v = (uint32_t)xu[at] | ((uint32_t)xu[at + K2] << 16);
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
        const int kb = p0 + 8 * s;
        if (ALIGNED && kb / B != am_blk) {
          am_blk = kb / B;
          absmax_row<DQ>(am[0], absmax, scale, off, am_blk, c, N, vec);
          absmax_row<DQ>(am[1], absmax, scale, off, K2 / B + am_blk, c, N, vec);
        }
        uint32_t bx[MT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          bx[mt][0] = smem[(mt * 8 + g) * pitch + 8 * s + t];
          bx[mt][1] = smem[(mt * 8 + g) * pitch + 8 * s + t + 4];
        }
        const uint32_t w0[4] = {ring[jr][0].x, ring[jr][0].y, ring[jr][0].z, ring[jr][0].w};
        const uint32_t w1[4] = {ring[jr][1].x, ring[jr][1].y, ring[jr][1].z, ring[jr][1].w};
        if (s + DEPTH < s1) {  // refill this slot DEPTH k-steps ahead
          ring[jr][0] = load_row(kb + 8 * DEPTH + t, p1);
          ring[jr][1] = load_row(kb + 8 * DEPTH + t + 4, p1);
        }
#pragma unroll
        for (int i = 0; i < TILES; ++i) {
          const int sh = (i & 1) * 16;
          const uint32_t b00 = (w0[i >> 1] >> sh) & 0xFF, b01 = (w0[i >> 1] >> (sh + 8)) & 0xFF;
          const uint32_t b10 = (w1[i >> 1] >> sh) & 0xFF, b11 = (w1[i >> 1] >> (sh + 8)) & 0xFF;
          uint32_t a[4];
          if (ALIGNED) {
            a[0] = decode_pair(b00, am[0][2 * i], am[1][2 * i], tab);
            a[1] = decode_pair(b01, am[0][2 * i + 1], am[1][2 * i + 1], tab);
            a[2] = decode_pair(b10, am[0][2 * i], am[1][2 * i], tab);
            a[3] = decode_pair(b11, am[0][2 * i + 1], am[1][2 * i + 1], tab);
          } else {
            // a k-step crosses absmax blocks: each element's own absmax
            const int rows[2] = {kb + t, kb + t + 4};
            const uint32_t bytes[2][2] = {{b00, b01}, {b10, b11}};
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int q = 0; q < 2; ++q) {
                const int n = c + 2 * i + q;
                float lo = 0.f, hi = 0.f;
                if (rows[h] < p1 && n < N) {
                  lo = absmax_at<DQ>(absmax, scale, off, rows[h] / B, n, N);
                  hi = absmax_at<DQ>(absmax, scale, off, (rows[h] + K2) / B, n, N);
                }
                a[2 * h + q] = decode_pair(bytes[h][q], lo, hi, tab);
              }
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][i], a, bx[mt][0], bx[mt][1]);
        }
      }
    }
  }

  // the warps' partials added in warp order
  constexpr int R = MT * TILES * 4;  // accumulators a lane
  __syncthreads();                   // x pairs consumed: the buffer takes the partials
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
    // lane (g, t) holds rows 2t, 2t+1 (+ 8 mt) at columns 16g + 2i (slot g)
    // and 16g + 2i + 1 (slot g + 8)
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
int launch(const void* x, const void* packed, const void* absmax, const void* scale,
           const void* offset, const void* code, void* y, int M, int K, int N, int B,
           int splits, int unit, int pitch, size_t smem, cudaStream_t stream) {
  auto kernel = qmm_decode_kernel<DQ, ALIGNED, MT>;
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
      &cfg, kernel, static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(packed),
      absmax, static_cast<const float*>(scale), static_cast<const float*>(offset),
      static_cast<const float*>(code), static_cast<__nv_bfloat16*>(y), M, K, N, B, splits,
      unit, pitch);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <bool DQ>
int launch_dq(bool aligned, bool two_tiles, const void* x, const void* packed,
              const void* absmax, const void* scale, const void* offset, const void* code,
              void* y, int M, int K, int N, int B, int splits, int unit, int pitch, size_t smem,
              cudaStream_t s) {
  if (aligned)
    return two_tiles ? launch<DQ, true, 2>(x, packed, absmax, scale, offset, code, y, M, K, N,
                                           B, splits, unit, pitch, smem, s)
                     : launch<DQ, true, 1>(x, packed, absmax, scale, offset, code, y, M, K, N,
                                           B, splits, unit, pitch, smem, s);
  return two_tiles ? launch<DQ, false, 2>(x, packed, absmax, scale, offset, code, y, M, K, N, B,
                                          splits, unit, pitch, smem, s)
                   : launch<DQ, false, 1>(x, packed, absmax, scale, offset, code, y, M, K, N, B,
                                          splits, unit, pitch, smem, s);
}

}  // namespace

// x bf16 [M, K] row-major (16-byte aligned); packed u8 [K/2, N]; absmax int8
// (dq) or f32 [K/B, N]; scale f32 [ceil((K/B)/256), N] and offset f32 [1]
// when dq, else unused; code f32 [16]; y bf16 [M, N].  The plan: `splits`
// (1 to 16, one cluster) runs of whole `unit`s of packed rows, unit a
// multiple of 8.  Returns the launch's cudaError_t (cudaErrorInvalidValue
// for a bad plan).
extern "C" int qmm_nf4_decode(const void* x, const void* packed, const void* absmax,
                              const void* scale, const void* offset, const void* code, void* y,
                              int M, int K, int N, int block_size, int dq, int splits, int unit,
                              void* stream) {
  const int K2 = K / 2;
  const int units = (K2 + unit - 1) / unit;
  if (M <= 0 || splits < 1 || splits > MAX_SPLITS || splits > units || unit % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool two_tiles = M > 8;
  const int mt = two_tiles ? 2 : 1;
  int rows = (units + splits - 1) / splits * unit;
  rows = rows < PASS_ROWS ? rows : PASS_ROWS;
  const int pitch = (rows + 31) / 32 * 32 + 4;  // words; 4 mod 32: conflict-free B loads
  const size_t stage = (size_t)mt * 8 * pitch * 4;
  const size_t parts = ((size_t)(WARPS - 1) * mt * TILES * 4 * 32 + mt * 8 * COLS) * 4;
  const size_t smem = stage > parts ? stage : parts;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = block_size % 8 == 0;
  if (dq)
    return launch_dq<true>(aligned, two_tiles, x, packed, absmax, scale, offset, code, y, M, K,
                           N, block_size, splits, unit, pitch, smem, s);
  return launch_dq<false>(aligned, two_tiles, x, packed, absmax, scale, offset, code, y, M, K,
                          N, block_size, splits, unit, pitch, smem, s);
}
