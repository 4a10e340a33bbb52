// Input gradient of the fused int8 dequantize + matmul for a few rows:
// dx[M, K] = g[M, N] @ dequant(W)[K, N]^T with M <= 16 (more rows run as
// groups of 16).  The weight is frozen; it is decoded again here.
//
// Replaces the TPU kernel qlora_tpu/ops/qmatmul.py::_qmm_bwd_pallas_i8
// (_i8_bwd_kernel, pallas_call at qmatmul.py:487) at 16 rows or fewer: a
// train step over an int8 base (--bits 8) whose micro-batch holds B * S <=
// 16 tokens.  More rows run qmm_i8_wgmma.cu; this kernel's "before" is the
// 16-row WMMA tile of qmm_i8.cu, which still takes the shapes the plan
// refuses.  One template, <bool DQ>, serves f32 and double-quantized absmax
// (absmax = q * (scale * (1/127)) + offset as one fused multiply-add).
//
// Storage (qlora_tpu_torch/quant/blockwise.py): codes int8 [K, N], N
// contiguous; absmax [K/B, N] f32, or int8 with meta-scales f32
// [ceil((K/B)/256), N] and one f32 offset.  A weight element is
// bf16((float(code) * (1/127)) * absmax), in that order, which is what
// dequantize() computes.
//
// What bounds it on an H100: the bytes of the weight, K*N codes plus the
// absmax, over 3.35 TB/s (a 4096 x 4096 weight: 17 MB).  The products are
// few (2*M*K*N) and the tensor cores do them.
//
// Design (qmm_nf4_bwd_decode.cu's over int8 codes):
// - A block owns a strip of 64 rows of W (64 dx columns) and one split of
//   the contraction N, a run of whole 128-column k-steps, from a plan that
//   depends only on (K, N) and the SM count (ops/qmatmul.py:
//   i8_bwd_decode_plan), never on M.  Warp w owns 16 rows of the strip and
//   walks every k-step of the split, in passes of at most PASS_COLS columns
//   whose g fits in shared memory.
// - mma.sync m16n8k16 with the decoded weight as the 16-row A operand (a row
//   of A is a row of W) and g's rows as the 8-column B operand.  Lane (r, t)
//   holds A rows r and r + 8 and streams 16 bytes (16 columns) of each of
//   those rows of W in each 64-column half of a k-step with ld.global.nc, L1
//   no-allocate.  Word v of the 16 bytes is k-tile v: byte j of lane t's
//   word fills contraction slot 2t + (j & 1) + 8 (j >> 1), so g's columns c,
//   c + 1 and c + 2, c + 3 are the B fragment's two registers, and g is
//   staged in shared memory as it lies.  Codes become floats exactly by a
//   byte permute into 2^23's mantissa and one subtraction.
// - The next k-step's bytes are in flight while one is decoded, and the
//   first are requested before g and the absmax are staged.
// - Where the block size is a multiple of the strip's 64 rows (every model
//   linear), the strip's rows share one absmax row, which the block decodes
//   for its pass into shared memory as f32 once; other block sizes read each
//   element's absmax where it is used.
// - The splits of a strip form one thread-block cluster (at most 16); each
//   block's partial [rows][64] goes to shared memory, and after a cluster
//   barrier each block adds a slice of it over the splits in split order
//   through distributed shared memory and rounds to bf16 once.  No atomics
//   and no global workspace: two calls give the same bits, and a row's
//   result does not depend on M or the other rows.
// - The plan refuses N % 16 != 0 (a 16-byte load of a row needs a row stride
//   in multiples of 16): qmm_i8.cu keeps those shapes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int STRIP = 64;        // rows of W of a block (dx columns): 16 a warp
constexpr int OUT = STRIP;
constexpr int WARPS = 4;
constexpr int KSTEP = 128;       // contraction columns of a k-step: two halves of 64
constexpr int PASS_COLS = 1024;  // contraction columns of g staged at once
constexpr int MAX_SPLITS = 16;   // the largest cluster (non-portable above 8)

__device__ __forceinline__ uint4 ld_stream(const int8_t* p) {
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

// the absmax of columns n .. n + 3 of absmax row blk (n % 4 == 0, N % 16 == 0)
template <bool DQ>
__device__ __forceinline__ float4 absmax4(const void* absmax, const float* scale, float off,
                                          int blk, int n, int N) {
  if (DQ) {
    const uint32_t q = __ldg(reinterpret_cast<const uint32_t*>(
        static_cast<const int8_t*>(absmax) + (size_t)blk * N + n));
    const float4 s = __ldg(reinterpret_cast<const float4*>(scale + (size_t)(blk / 256) * N + n));
    return make_float4(__fmaf_rn((float)(int8_t)q, __fmul_rn(s.x, 1.f / 127.f), off),
                       __fmaf_rn((float)(int8_t)(q >> 8), __fmul_rn(s.y, 1.f / 127.f), off),
                       __fmaf_rn((float)(int8_t)(q >> 16), __fmul_rn(s.z, 1.f / 127.f), off),
                       __fmaf_rn((float)(int8_t)(q >> 24), __fmul_rn(s.w, 1.f / 127.f), off));
  }
  return __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(absmax) +
                                               (size_t)blk * N + n));
}

// byte e of a word of int8 codes as a float, exactly: the code + 128 as the
// low byte of 2^23's mantissa, less 2^23 + 128
__device__ __forceinline__ float code_at(uint32_t w, int e) {
  return __int_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7440 | e)) - 8388736.f;
}

// where column j of a pass lies in the staged absmax: 4 floats of padding
// after every 32 columns, so that the 4 lanes of a row (16 columns apart)
// read their 16-byte runs from distinct banks
__host__ __device__ __forceinline__ int am_at(int j) { return j + 4 * (j >> 5); }

// two weights decoded, (code * (1/127)) * absmax, rounded to bf16 and
// paired, the first in the low half (the lower contraction slot)
__device__ __forceinline__ uint32_t decode_pair(float c_lo, float c_hi, float am_lo,
                                                float am_hi) {
  const float q = (float)(1.0 / 127.0);
  const __nv_bfloat162 v = __floats2bfloat162_rn(__fmul_rn(__fmul_rn(c_lo, q), am_lo),
                                                 __fmul_rn(__fmul_rn(c_hi, q), am_hi));
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <bool DQ, bool ALIGNED, int MT>
__global__ void __launch_bounds__(WARPS * 32, MT == 1 ? 4 : 3)
qmm_i8_bwd_decode_kernel(const __nv_bfloat16* __restrict__ g, const int8_t* __restrict__ codes,
                         const void* __restrict__ absmax, const float* __restrict__ scale,
                         const float* __restrict__ offset, __nv_bfloat16* __restrict__ dx,
                         int M, int K, int N, int B, int splits, int pass_cols, int pitch) {
  // g [MT*8][pitch] words (bf16 pairs as they lie) and, ALIGNED, the
  // strip's absmax [am_at(pass_cols)] f32; after the k loop the block's
  // partial [rows][OUT] f32, which the cluster reads
  extern __shared__ __align__(16) uint32_t smem[];

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int lane = tid & 31, wk = tid >> 5;
  const int r = lane >> 2, t = lane & 3;
  const int strip0 = blockIdx.x * STRIP;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * 16;
  const int rows_here = min(M - m0, MT * 8);
  const int units = (N + KSTEP - 1) / KSTEP;
  const int c0 = (int)((long long)split * units / splits) * KSTEP;
  const int c1 = min((int)((long long)(split + 1) * units / splits) * KSTEP, N);

  const int ka = strip0 + 16 * wk + r, kb = ka + 8;  // this lane's rows of W: A rows r, r + 8
  const bool a_ok = ka < K, b_ok = kb < K;
  const int8_t* wa = codes + (size_t)(a_ok ? ka : 0) * N;
  const int8_t* wb = codes + (size_t)(b_ok ? kb : 0) * N;
  const float off = DQ ? *offset : 0.f;
  uint32_t* gs = smem;
  float* ams = reinterpret_cast<float*>(smem + MT * 8 * pitch);
  const int blk = strip0 / B;  // ALIGNED: the strip's absmax row

  auto load = [&](const int8_t* row, bool ok, int col, int end) -> uint4 {
    return ok && col < end ? ld_stream(row + col) : make_uint4(0, 0, 0, 0);
  };

  float acc[MT][2][4];  // [row tile][k-tile parity][fragment]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][i][e] = 0.f;

  for (int p0 = c0; p0 < c1; p0 += pass_cols) {
    const int p1 = min(p0 + pass_cols, c1);
    const int nsteps = (p1 - p0 + KSTEP - 1) / KSTEP;
    // the first k-step's bytes, [half][row a, row b], requested before g and
    // the absmax are staged
    uint4 ring[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ring[h][0] = load(wa, a_ok, p0 + 64 * h + 16 * t, p1);
      ring[h][1] = load(wb, b_ok, p0 + 64 * h + 16 * t, p1);
    }

    if (p0 != c0) __syncthreads();  // the previous pass's g and absmax are consumed
    // g's rows of this pass; rows past M and columns past the pass are 0
    const int chunks = nsteps * (KSTEP / 8);  // 16-byte chunks a row
    for (int i = tid; i < MT * 8 * chunks; i += WARPS * 32) {
      const int m = i / chunks, ch = i % chunks;
      const int col = p0 + 8 * ch;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m < rows_here && col < p1)
        v = *reinterpret_cast<const uint4*>(g + (size_t)(m0 + m) * N + col);
      *reinterpret_cast<uint4*>(gs + m * pitch + 4 * ch) = v;
    }
    if (ALIGNED) {
      for (int i = tid; i < nsteps * (KSTEP / 4); i += WARPS * 32) {
        const int j = 4 * i;
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
        if (p0 + j < p1) a = absmax4<DQ>(absmax, scale, off, blk, p0 + j, N);
        *reinterpret_cast<float4*>(ams + am_at(j)) = a;
      }
    }
    __syncthreads();

    for (int s = 0; s < nsteps; ++s) {
      uint4 w[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        w[h][0] = ring[h][0];
        w[h][1] = ring[h][1];
      }
      if (s + 1 < nsteps) {  // the next k-step's bytes, in flight while this one is decoded
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          ring[h][0] = load(wa, a_ok, p0 + KSTEP * (s + 1) + 64 * h + 16 * t, p1);
          ring[h][1] = load(wb, b_ok, p0 + KSTEP * (s + 1) + 64 * h + 16 * t, p1);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j0 = KSTEP * s + 64 * h + 16 * t;  // the lane's 16 columns, from p0
        float am_a[16], am_b[16];                    // their absmax in rows ka and kb
        if (ALIGNED) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 a = *reinterpret_cast<const float4*>(ams + am_at(j0 + 4 * q));
            am_a[4 * q] = am_b[4 * q] = a.x;
            am_a[4 * q + 1] = am_b[4 * q + 1] = a.y;
            am_a[4 * q + 2] = am_b[4 * q + 2] = a.z;
            am_a[4 * q + 3] = am_b[4 * q + 3] = a.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int n = p0 + j0 + j;
            am_a[j] = a_ok && n < p1 ? absmax_at<DQ>(absmax, scale, off, ka / B, n, N) : 0.f;
            am_b[j] = b_ok && n < p1 ? absmax_at<DQ>(absmax, scale, off, kb / B, n, N) : 0.f;
          }
        }
        uint4 bq[MT][2];  // g's columns p0 + j0 .. + 15 of rows mt * 8 + r
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint4* src = reinterpret_cast<const uint4*>(gs + (mt * 8 + r) * pitch + j0 / 2);
          bq[mt][0] = src[0];
          bq[mt][1] = src[1];
        }
        const uint32_t xa[4] = {w[h][0].x, w[h][0].y, w[h][0].z, w[h][0].w};
        const uint32_t xb[4] = {w[h][1].x, w[h][1].y, w[h][1].z, w[h][1].w};
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          // k-tile v: bytes 0, 1 at slots 2t, 2t + 1 and bytes 2, 3 at 2t + 8,
          // 2t + 9; row ka is A row r, row kb A row r + 8
          uint32_t a[4];
          a[0] = decode_pair(code_at(xa[v], 0), code_at(xa[v], 1), am_a[4 * v], am_a[4 * v + 1]);
          a[1] = decode_pair(code_at(xb[v], 0), code_at(xb[v], 1), am_b[4 * v], am_b[4 * v + 1]);
          a[2] = decode_pair(code_at(xa[v], 2), code_at(xa[v], 3), am_a[4 * v + 2],
                             am_a[4 * v + 3]);
          a[3] = decode_pair(code_at(xb[v], 2), code_at(xb[v], 3), am_b[4 * v + 2],
                             am_b[4 * v + 3]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const uint4 q = bq[mt][v >> 1];
            mma_bf16(acc[mt][v & 1], a, (v & 1) ? q.z : q.x, (v & 1) ? q.w : q.y);
          }
        }
      }
    }
  }

  // the block's partial: lane (r, t) holds dx rows 2t, 2t + 1 (+ 8 mt) at
  // local columns 16 wk + r (row ka) and 16 wk + r + 8 (row kb)
  __syncthreads();  // g and the absmax consumed: the buffer takes the partial
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = mt * 8 + 2 * t + e;
      if (m >= rows_here) continue;
      part[m * OUT + 16 * wk + r] = acc[mt][0][e] + acc[mt][1][e];
      part[m * OUT + 16 * wk + r + 8] = acc[mt][0][2 + e] + acc[mt][1][2 + e];
    }

  // each block of the cluster sums a slice of the strip's output over the
  // splits, in split order, from the splits' shared memories
  cluster.sync();
  const int q4 = rows_here * (OUT / 4);
  const int e0 = split * q4 / splits, e1 = (split + 1) * q4 / splits;
  for (int e = e0 + tid; e < e1; e += WARPS * 32) {
    float4 s = *cluster.map_shared_rank(reinterpret_cast<float4*>(part) + e, 0);
    for (int sp = 1; sp < splits; ++sp) {
      const float4 v = *cluster.map_shared_rank(reinterpret_cast<float4*>(part) + e, sp);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const int m = e / (OUT / 4), k = strip0 + 4 * (e % (OUT / 4));
    __nv_bfloat16* out = dx + (size_t)(m0 + m) * K + k;
    if ((K & 3) == 0 && k + 3 < K) {  // 8-byte aligned, all four in range
      const __nv_bfloat162 a = __floats2bfloat162_rn(s.x, s.y);
      const __nv_bfloat162 b = __floats2bfloat162_rn(s.z, s.w);
      uint2 o;
      o.x = *reinterpret_cast<const uint32_t*>(&a);
      o.y = *reinterpret_cast<const uint32_t*>(&b);
      *reinterpret_cast<uint2*>(out) = o;
    } else {
      const float v[4] = {s.x, s.y, s.z, s.w};
      for (int j = 0; j < 4 && k + j < K; ++j) out[j] = __float2bfloat16(v[j]);
    }
  }
  cluster.sync();  // the cluster's shared memories are read: blocks may exit
}

template <bool DQ, bool ALIGNED, int MT>
int launch(const void* g, const void* codes, const void* absmax, const void* scale,
           const void* offset, void* dx, int M, int K, int N, int B, int splits, int pass_cols,
           int pitch, size_t smem, cudaStream_t stream) {
  auto kernel = qmm_i8_bwd_decode_kernel<DQ, ALIGNED, MT>;
  static const cudaError_t attr = [&] {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024);
    return e != cudaSuccess
               ? e
               : cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((K + STRIP - 1) / STRIP, splits, (M + 15) / 16);
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
      &cfg, kernel, static_cast<const __nv_bfloat16*>(g), static_cast<const int8_t*>(codes),
      absmax, static_cast<const float*>(scale), static_cast<const float*>(offset),
      static_cast<__nv_bfloat16*>(dx), M, K, N, B, splits, pass_cols, pitch);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <bool DQ>
int launch_dq(bool aligned, bool two_tiles, const void* g, const void* codes, const void* absmax,
              const void* scale, const void* offset, void* dx, int M, int K, int N, int B,
              int splits, int pass_cols, int pitch, size_t smem, cudaStream_t s) {
  if (aligned)
    return two_tiles ? launch<DQ, true, 2>(g, codes, absmax, scale, offset, dx, M, K, N, B,
                                           splits, pass_cols, pitch, smem, s)
                     : launch<DQ, true, 1>(g, codes, absmax, scale, offset, dx, M, K, N, B,
                                           splits, pass_cols, pitch, smem, s);
  return two_tiles ? launch<DQ, false, 2>(g, codes, absmax, scale, offset, dx, M, K, N, B,
                                          splits, pass_cols, pitch, smem, s)
                   : launch<DQ, false, 1>(g, codes, absmax, scale, offset, dx, M, K, N, B,
                                          splits, pass_cols, pitch, smem, s);
}

}  // namespace

// g bf16 [M, N] row-major (16-byte aligned); codes int8 [K, N]; absmax int8
// (dq) or f32 [K/B, N]; scale f32 [ceil((K/B)/256), N] and offset f32 [1]
// when dq, else unused; the codebook argument of the NF4 entries is unused
// here; dx bf16 [M, K].  The plan: `splits` (1 to 16, one cluster) runs of
// whole 128-column k-steps of N; N % 16 == 0.  Returns the launch's
// cudaError_t (cudaErrorInvalidValue for a bad plan).
extern "C" int qmm_i8_bwd_decode(const void* g, const void* codes, const void* absmax,
                                 const void* scale, const void* offset, const void* unused,
                                 void* dx, int M, int K, int N, int block_size, int dq,
                                 int splits, void* stream) {
  (void)unused;
  const int units = (N + KSTEP - 1) / KSTEP;
  if (M <= 0 || K <= 0 || N <= 0 || N % 16 || block_size <= 0 || K % block_size ||
      splits < 1 || splits > MAX_SPLITS || splits > units)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool two_tiles = M > 8;
  const int mt = two_tiles ? 2 : 1;
  int cols = (units + splits - 1) / splits * KSTEP;  // a split's longest run of columns
  cols = cols < PASS_COLS ? cols : PASS_COLS;
  const int pitch = cols / 2 + 4;  // words; 4 mod 32: conflict-free 16-byte B loads
  const bool aligned = block_size % STRIP == 0;
  const size_t smem = ((size_t)mt * 8 * pitch + (aligned ? am_at(cols) : 0)) * 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dq)
    return launch_dq<true>(aligned, two_tiles, g, codes, absmax, scale, offset, dx, M, K, N,
                           block_size, splits, cols, pitch, smem, s);
  return launch_dq<false>(aligned, two_tiles, g, codes, absmax, scale, offset, dx, M, K, N,
                          block_size, splits, cols, pitch, smem, s);
}
