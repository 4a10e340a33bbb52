// Input gradient of the fused NF4/FP4 dequantize + matmul for a few rows:
// dx[M, K] = g[M, N] @ dequant(W)[K, N]^T with M <= 16 (more rows run as
// groups of 16).  The weight is frozen; it is decoded again here.
//
// Replaces the TPU kernel qlora_tpu/ops/qmatmul.py::_qmm_bwd_pallas
// (_qmm_bwd_kernel, pallas_call at qmatmul.py:679) at 16 rows or fewer: a
// train step whose micro-batch holds B * S <= 16 tokens.  More rows run
// qmm_nf4_bwd_wgmma.cu; this kernel's "before" is the WMMA tile kernel of
// qmm_nf4_bwd.cu, which still takes the shapes the plan refuses.  One
// template, <bool DQ>, serves f32 and double-quantized absmax, decoded with
// the forward's arithmetic (absmax = q * (scale * (1/127)) + offset as one
// fused multiply-add; a weight is code * absmax rounded to bf16, as
// dequantize() computes it).
//
// Storage (qlora_tpu_torch/quant/blockwise.py): packed u8 [K/2, N], N
// contiguous, packed row p holds logical row p in its low nibble and row
// K/2 + p in its high one; absmax [K/B, N] f32, or int8 with meta-scales f32
// [ceil((K/B)/256), N] and one f32 offset.  K % 2B == 0.
//
// What bounds it on an H100: the bytes of the weight, K*N/2 packed plus the
// absmax, over 3.35 TB/s (a 4096 x 4096 weight: 8.7 MB).  The products are
// few (2*M*K*N) and the tensor cores do them.
//
// Design (qmm_nf4_decode.cu's, turned around: the contraction N is the
// contiguous axis of the packed weight):
// - Cut dx's columns into strips and the contraction into splits.  A block
//   owns a strip of 32 packed rows (64 dx columns: the low and the high plane
//   of each) and one split: a run of whole 128-column k-steps of N, from a
//   plan that depends only on (K, N) and the SM count (ops/qmatmul.py:
//   nf4_bwd_decode_plan), never on M.  Warp w owns 8 packed rows of the
//   strip and walks every k-step of the split, in passes of at most
//   PASS_COLS columns whose g fits in shared memory.
// - The products run on mma.sync m16n8k16 (bf16 in, f32 accumulators) with
//   the decoded weight as the 16-row A operand and g's rows as the 8-column
//   B operand, so M <= 8 pads nothing.  A rows 0-7 are the low nibbles and
//   rows 8-15 the high nibbles of the warp's 8 packed rows (dx columns p and
//   K/2 + p): lane (r, t) holds A rows r and r + 8, so one 4-byte word of its
//   packed row feeds its whole A fragment.  A lane streams 16 bytes (16
//   columns) of its packed row in each 64-column half of a k-step with
//   ld.global.nc, L1 no-allocate; the 4 lanes of a row read 64 contiguous
//   bytes.  Word v of the 16 bytes is k-tile v: byte j of lane t's word
//   fills contraction slot 2t + (j & 1) + 8 (j >> 1).  In that order g's
//   columns c, c + 1 and c + 2, c + 3 are the B fragment's two registers: g
//   is staged in shared memory as it lies in device memory, and a lane's B
//   fragments for a half are two 16-byte shared loads.
// - The next k-step's bytes are in flight while one is decoded, and the
//   first are requested before g and the absmax are staged.
// - absmax changes along the contraction: each column has its own.  Where
//   the block size is a multiple of the strip's 32 rows (every model
//   linear), a strip's rows share one absmax row in each plane, which the
//   block decodes for its pass into shared memory as f32 once; other block
//   sizes read each element's absmax where it is used.  The 16-entry
//   codebook lives in shared memory.
// - Reduce the splits deterministically: the splits of a strip form one
//   thread-block cluster (at most 16).  Each block writes its partial
//   [rows][64] to shared memory; after a cluster barrier each block reads a
//   slice of the strip's output from all the cluster's shared memories
//   (distributed shared memory), adds the splits in split order and rounds
//   to bf16 once.  No atomics and no global workspace: two calls give the
//   same bits, and a row's result does not depend on M or the other rows.
// - The plan refuses N % 16 != 0 (a 16-byte load of a packed row needs a row
//   stride in multiples of 16): qmm_nf4_bwd.cu keeps those shapes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int STRIP = 32;        // packed rows of a block: 8 a warp
constexpr int OUT = 2 * STRIP;   // dx columns of a block: both planes of its packed rows
constexpr int WARPS = 4;
constexpr int KSTEP = 128;       // contraction columns of a k-step: two halves of 64
constexpr int PASS_COLS = 1024;  // contraction columns of g staged at once
constexpr int MAX_SPLITS = 16;   // the largest cluster (non-portable above 8)

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

// where column j of a pass lies in the staged absmax: 4 floats of padding
// after every 32 columns, so that the 4 lanes of a row (16 columns apart)
// read their 16-byte runs from distinct banks
__host__ __device__ __forceinline__ int am_at(int j) { return j + 4 * (j >> 5); }

// two weights rounded to bf16 and paired, the first in the low half (the
// lower contraction slot)
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <bool DQ, bool ALIGNED, int MT>
__global__ void __launch_bounds__(WARPS * 32, MT == 1 ? 4 : 3)
qmm_bwd_decode_kernel(const __nv_bfloat16* __restrict__ g, const uint8_t* __restrict__ packed,
                      const void* __restrict__ absmax, const float* __restrict__ scale,
                      const float* __restrict__ offset, const float* __restrict__ code,
                      __nv_bfloat16* __restrict__ dx, int M, int K, int N, int B, int splits,
                      int pass_cols, int pitch) {
  // g [MT*8][pitch] words (bf16 pairs as they lie) and, ALIGNED, the
  // strip's absmax [2 planes][am_at(pass_cols)] f32; after the k loop the
  // block's partial [rows][OUT] f32, which the cluster reads
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ float tab[16];

  cg::cluster_group cluster = cg::this_cluster();
  const int K2 = K / 2;
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
  if (tid < 16) tab[tid] = code[tid];

  const int p = strip0 + 8 * wk + r;  // this lane's packed row: A rows r (dx column p), r + 8
  const bool row_ok = p < K2;         //   (dx column K/2 + p)
  const uint8_t* prow = packed + (size_t)(row_ok ? p : 0) * N;
  const float off = DQ ? *offset : 0.f;
  uint32_t* gs = smem;
  float* ams = reinterpret_cast<float*>(smem + MT * 8 * pitch);
  const int blk_lo = strip0 / B, blk_hi = K2 / B + strip0 / B;  // ALIGNED: the strip's rows

  auto load = [&](int col, int end) -> uint4 {
    return row_ok && col < end ? ld_stream(prow + col) : make_uint4(0, 0, 0, 0);
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
    // the first k-step's bytes, requested before g and the absmax are staged
    uint4 ring[2] = {load(p0 + 16 * t, p1), load(p0 + 64 + 16 * t, p1)};

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
      const int quads = nsteps * (KSTEP / 4);  // 4 columns a thread, each plane
      for (int i = tid; i < 2 * quads; i += WARPS * 32) {
        const int plane = i / quads, j = 4 * (i % quads);
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
        if (p0 + j < p1) a = absmax4<DQ>(absmax, scale, off, plane ? blk_hi : blk_lo, p0 + j, N);
        *reinterpret_cast<float4*>(ams + plane * am_at(pass_cols) + am_at(j)) = a;
      }
    }
    __syncthreads();

    for (int s = 0; s < nsteps; ++s) {
      const uint4 w[2] = {ring[0], ring[1]};
      if (s + 1 < nsteps) {  // the next k-step's bytes, in flight while this one is decoded
        ring[0] = load(p0 + KSTEP * (s + 1) + 16 * t, p1);
        ring[1] = load(p0 + KSTEP * (s + 1) + 64 + 16 * t, p1);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j0 = KSTEP * s + 64 * h + 16 * t;  // the lane's 16 columns, from p0
        float lo[16], hi[16];                        // their absmax, low and high plane
        if (ALIGNED) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 a = *reinterpret_cast<const float4*>(ams + am_at(j0 + 4 * q));
            const float4 b =
                *reinterpret_cast<const float4*>(ams + am_at(pass_cols) + am_at(j0 + 4 * q));
            lo[4 * q] = a.x, lo[4 * q + 1] = a.y, lo[4 * q + 2] = a.z, lo[4 * q + 3] = a.w;
            hi[4 * q] = b.x, hi[4 * q + 1] = b.y, hi[4 * q + 2] = b.z, hi[4 * q + 3] = b.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int n = p0 + j0 + j;
            const bool in = row_ok && n < p1;
            lo[j] = in ? absmax_at<DQ>(absmax, scale, off, p / B, n, N) : 0.f;
            hi[j] = in ? absmax_at<DQ>(absmax, scale, off, (K2 + p) / B, n, N) : 0.f;
          }
        }
        uint4 bq[MT][2];  // g's columns p0 + j0 .. + 15 of rows mt * 8 + r
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint4* src = reinterpret_cast<const uint4*>(gs + (mt * 8 + r) * pitch + j0 / 2);
          bq[mt][0] = src[0];
          bq[mt][1] = src[1];
        }
        const uint32_t wv[4] = {w[h].x, w[h].y, w[h].z, w[h].w};
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          // k-tile v: bytes 0, 1 at slots 2t, 2t + 1 and bytes 2, 3 at 2t + 8,
          // 2t + 9; low nibbles A row r, high nibbles A row r + 8
          const uint32_t b = wv[v];
          uint32_t a[4];
          a[0] = bf16_pair(__fmul_rn(tab[b & 15], lo[4 * v]),
                           __fmul_rn(tab[(b >> 8) & 15], lo[4 * v + 1]));
          a[1] = bf16_pair(__fmul_rn(tab[(b >> 4) & 15], hi[4 * v]),
                           __fmul_rn(tab[(b >> 12) & 15], hi[4 * v + 1]));
          a[2] = bf16_pair(__fmul_rn(tab[(b >> 16) & 15], lo[4 * v + 2]),
                           __fmul_rn(tab[(b >> 24) & 15], lo[4 * v + 3]));
          a[3] = bf16_pair(__fmul_rn(tab[(b >> 20) & 15], hi[4 * v + 2]),
                           __fmul_rn(tab[(b >> 28) & 15], hi[4 * v + 3]));
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
  // local columns 16 wk + r (A row r) and 16 wk + r + 8 (A row r + 8)
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
    // local columns lc .. lc + 3: A rows i .. i + 3 of warp lc / 16, one plane
    const int m = e / (OUT / 4), lc = 4 * (e % (OUT / 4));
    const int i = lc % 16;
    const int row = strip0 + 8 * (lc / 16) + (i & 7);  // packed row of the first
    __nv_bfloat16* out = dx + (size_t)(m0 + m) * K + (i < 8 ? row : K2 + row);
    if ((K & 7) == 0 && row + 3 < K2) {  // 8-byte aligned, all four in range
      const __nv_bfloat162 a = __floats2bfloat162_rn(s.x, s.y);
      const __nv_bfloat162 b = __floats2bfloat162_rn(s.z, s.w);
      uint2 o;
      o.x = *reinterpret_cast<const uint32_t*>(&a);
      o.y = *reinterpret_cast<const uint32_t*>(&b);
      *reinterpret_cast<uint2*>(out) = o;
    } else {
      const float v[4] = {s.x, s.y, s.z, s.w};
      for (int j = 0; j < 4 && row + j < K2; ++j) out[j] = __float2bfloat16(v[j]);
    }
  }
  cluster.sync();  // the cluster's shared memories are read: blocks may exit
}

template <bool DQ, bool ALIGNED, int MT>
int launch(const void* g, const void* packed, const void* absmax, const void* scale,
           const void* offset, const void* code, void* dx, int M, int K, int N, int B,
           int splits, int pass_cols, int pitch, size_t smem, cudaStream_t stream) {
  auto kernel = qmm_bwd_decode_kernel<DQ, ALIGNED, MT>;
  static const cudaError_t attr = [&] {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024);
    return e != cudaSuccess
               ? e
               : cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((K / 2 + STRIP - 1) / STRIP, splits, (M + 15) / 16);
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
      &cfg, kernel, static_cast<const __nv_bfloat16*>(g), static_cast<const uint8_t*>(packed),
      absmax, static_cast<const float*>(scale), static_cast<const float*>(offset),
      static_cast<const float*>(code), static_cast<__nv_bfloat16*>(dx), M, K, N, B, splits,
      pass_cols, pitch);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <bool DQ>
int launch_dq(bool aligned, bool two_tiles, const void* g, const void* packed,
              const void* absmax, const void* scale, const void* offset, const void* code,
              void* dx, int M, int K, int N, int B, int splits, int pass_cols, int pitch,
              size_t smem, cudaStream_t s) {
  if (aligned)
    return two_tiles ? launch<DQ, true, 2>(g, packed, absmax, scale, offset, code, dx, M, K, N,
                                           B, splits, pass_cols, pitch, smem, s)
                     : launch<DQ, true, 1>(g, packed, absmax, scale, offset, code, dx, M, K, N,
                                           B, splits, pass_cols, pitch, smem, s);
  return two_tiles ? launch<DQ, false, 2>(g, packed, absmax, scale, offset, code, dx, M, K, N,
                                          B, splits, pass_cols, pitch, smem, s)
                   : launch<DQ, false, 1>(g, packed, absmax, scale, offset, code, dx, M, K, N,
                                          B, splits, pass_cols, pitch, smem, s);
}

}  // namespace

// g bf16 [M, N] row-major (16-byte aligned); packed u8 [K/2, N]; absmax int8
// (dq) or f32 [K/B, N]; scale f32 [ceil((K/B)/256), N] and offset f32 [1]
// when dq, else unused; code f32 [16]; dx bf16 [M, K].  The plan: `splits`
// (1 to 16, one cluster) runs of whole 128-column k-steps of N; N % 16 == 0.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for a bad plan).
extern "C" int qmm_nf4_bwd_decode(const void* g, const void* packed, const void* absmax,
                                  const void* scale, const void* offset, const void* code,
                                  void* dx, int M, int K, int N, int block_size, int dq,
                                  int splits, void* stream) {
  const int units = (N + KSTEP - 1) / KSTEP;
  if (M <= 0 || K <= 0 || N <= 0 || N % 16 || block_size <= 0 || K % (2 * block_size) ||
      splits < 1 || splits > MAX_SPLITS || splits > units)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool two_tiles = M > 8;
  const int mt = two_tiles ? 2 : 1;
  int cols = (units + splits - 1) / splits * KSTEP;  // a split's longest run of columns
  cols = cols < PASS_COLS ? cols : PASS_COLS;
  const int pitch = cols / 2 + 4;  // words; 4 mod 32: conflict-free 16-byte B loads
  const bool aligned = block_size % STRIP == 0;
  const size_t smem = ((size_t)mt * 8 * pitch + (aligned ? 2 * am_at(cols) : 0)) * 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dq)
    return launch_dq<true>(aligned, two_tiles, g, packed, absmax, scale, offset, code, dx, M, K,
                           N, block_size, splits, cols, pitch, smem, s);
  return launch_dq<false>(aligned, two_tiles, g, packed, absmax, scale, offset, code, dx, M, K,
                          N, block_size, splits, cols, pitch, smem, s);
}
