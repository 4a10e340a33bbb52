// Fused int8 dequantize + matmul over the unpacked blockwise-int8 storage (the
// --bits 8 base), forward and backward with respect to the input:
//   qmm_i8_fwd:  y[M,N]  = x[M,K] @ dequant(W)[K,N]
//   qmm_i8_bwd:  dx[M,K] = g[M,N] @ dequant(W)[K,N]^T
// The weight is frozen and gets no gradient; the backward decodes it again.
//
// Replaces the TPU kernels qlora_tpu/ops/qmatmul.py::_qmm_pallas_i8
// (_i8_fwd_kernel) and ::_qmm_bwd_pallas_i8 (_i8_bwd_kernel) where no newer
// kernel takes the shape: the dx at 16 rows or fewer, and above 16 rows a
// contraction whose row stride TMA cannot take.  The forward at 16 rows or
// fewer runs qmm_i8_decode.cu (split K over a cluster) and more rows run
// qmm_i8_wgmma.cu; this kernel is their "before", which chip_smoke.py times
// beside them through the C entries below.  Those TPU kernels take f32
// absmax only and have double quantization undone before them; these also
// decode int8 absmax themselves (<DQ>), with the arithmetic of the NF4 kernels
// (absmax = q * (scale * (1/127)) + offset as one fused multiply-add), so no
// f32 absmax array is written to device memory on every call.
//
// Storage (qlora_tpu_torch/quant/blockwise.py): codes int8 [K, N] row-major;
// absmax [K/B, N] f32, or int8 with f32 meta-scales [ceil((K/B)/256), N] and
// one f32 offset.  A weight element is bf16((float(code) * (1/127)) * absmax),
// in that order, which is what dequantize() computes: an identity operand reads
// the same bits out of both kernels.
//
// What bounds them on an H100: at training shapes (M = micro-batch rows in the
// hundreds or thousands) the bf16 tensor-core rate, 2*M*K*N operations; at a
// handful of rows the bytes of the weight, K*N codes plus the absmax.
//
// Design (the "before" of both newer kernels): one template serves both
// directions.  A block owns a [TM, 64] tile of
// the output (TM = 128 with 8 warps, or 16 with 4 warps when M <= 16) and walks
// the contraction (K forward, N backward) 64 at a time.  Each step stages the
// activation tile (16-byte loads where the rows allow it) and the decoded
// W[64 k, 64 n] tile, row-major [k][n] in bf16, in shared memory.  The forward
// reads it as a row_major matrix_b fragment; the backward reads the same layout
// as a col_major fragment, which is W^T with no transpose pass.  bf16 WMMA
// (m16n16k16), f32 accumulators, bf16 output; every K, N and block size that
// quantize() accepts runs, with masked tails.  What held it back at 16 rows
// (64 blocks of 128 threads at N = 4096, each walking all of K and staging a
// decoded 64 x 64 tile a step, no overlap of loads and products, a 16-row
// product for 4 rows) is what qmm_i8_decode.cu was designed against.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

// The absmax of row block `blk` of column n: f32 as stored, or int8 undone
// with its meta-block's scale and the offset.
template <bool DQ>
__device__ __forceinline__ float i8_absmax(const void* __restrict__ absmax,
                                           const float* __restrict__ scale, float off, int blk,
                                           int n, int N) {
  if (DQ) {
    const int8_t* aq = static_cast<const int8_t*>(absmax);
    const float s = scale[(size_t)(blk / 256) * N + n] * (1.f / 127.f);
    return __fmaf_rn((float)aq[(size_t)blk * N + n], s, off);
  }
  return static_cast<const float*>(absmax)[(size_t)blk * N + n];
}

constexpr int TO = 64;        // output columns per block (n forward, k backward)
constexpr int TC = 64;        // contraction step (k forward, n backward)
constexpr int LDA = TC + 8;   // bf16 row pitch of the staged activation tile
constexpr int LDW = 64 + 8;   // bf16 row pitch of the staged weight tile [k][n]

template <int TM>
struct Shape {
  static constexpr int NTHREADS = TM >= 128 ? 256 : 128;
  static constexpr int WARPS_M = TM >= 128 ? 4 : 1;
  static constexpr int WARPS_O = (NTHREADS / 32) / WARPS_M;
  static constexpr int WM = TM / WARPS_M;       // 32 or 16
  static constexpr int WO = TO / WARPS_O;       // 32 or 16
  static constexpr int FM = WM / 16;
  static constexpr int FO = WO / 16;
  static constexpr int LDC = WO + 4;            // f32 row pitch of a warp's epilogue patch
  static constexpr int STAGE_BYTES = (TM * LDA + 64 * LDW) * 2;
  static constexpr int EPI_BYTES = (NTHREADS / 32) * WM * LDC * 4;
  static constexpr int SMEM_BYTES = STAGE_BYTES > EPI_BYTES ? STAGE_BYTES : EPI_BYTES;
};

// a: x [M, K] (forward) or g [M, N] (backward), bf16 row-major with C columns.
// out: y [M, N] or dx [M, K], bf16 row-major with O columns.
template <bool DQ, bool BWD, int TM>
__global__ void __launch_bounds__(Shape<TM>::NTHREADS)
qmm_i8_kernel(const __nv_bfloat16* __restrict__ a, const int8_t* __restrict__ codes,
              const void* __restrict__ absmax, const float* __restrict__ scale,
              const float* __restrict__ offset, __nv_bfloat16* __restrict__ out, int M, int K,
              int N, int block_size) {
  using S = Shape<TM>;
  __shared__ __align__(128) unsigned char raw[S::SMEM_BYTES];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(raw);   // [TM][LDA]
  __nv_bfloat16* ws = as + TM * LDA;                           // [64 k][LDW]

  const int C = BWD ? N : K;    // contraction length
  const int O = BWD ? K : N;    // output width
  const int m0 = blockIdx.y * TM;
  const int o0 = blockIdx.x * TO;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp / S::WARPS_O;
  const int wo = warp % S::WARPS_O;
  const float off = DQ ? *offset : 0.f;
  const bool vec = (C % 8) == 0;   // 16-byte loads of the activation rows stay aligned

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[S::FM][S::FO];
#pragma unroll
  for (int i = 0; i < S::FM; ++i)
#pragma unroll
    for (int j = 0; j < S::FO; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int c0 = 0; c0 < C; c0 += TC) {
    __syncthreads();  // the previous step's tiles are consumed
    for (int i = tid; i < TM * (TC / 8); i += S::NTHREADS) {
      const int r = i / (TC / 8);
      const int c = (i % (TC / 8)) * 8;
      const int m = m0 + r;
      const int cc = c0 + c;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m < M) {
        if (vec && cc + 8 <= C) {
          v = *reinterpret_cast<const uint4*>(a + (size_t)m * C + cc);
        } else {
          __align__(16) __nv_bfloat16 e[8];
#pragma unroll
          for (int t = 0; t < 8; ++t)
            e[t] = (cc + t < C) ? a[(size_t)m * C + cc + t] : __float2bfloat16(0.f);
          v = *reinterpret_cast<const uint4*>(e);
        }
      }
      *reinterpret_cast<uint4*>(as + r * LDA + c) = v;
    }
    // the weight tile W[k0 + r][n0 + c], k the contraction forward and the
    // output backward
    const int k0 = BWD ? o0 : c0;
    const int n0 = BWD ? c0 : o0;
    for (int i = tid; i < 64 * 64; i += S::NTHREADS) {
      const int r = i / 64;
      const int c = i % 64;
      const int k = k0 + r;
      const int n = n0 + c;
      float w = 0.f;
      if (k < K && n < N) {
        const float am = i8_absmax<DQ>(absmax, scale, off, k / block_size, n, N);
        const float v = __fmul_rn((float)codes[(size_t)k * N + n], (float)(1.0 / 127.0));
        w = __fmul_rn(v, am);
      }
      ws[r * LDW + c] = __float2bfloat16(w);
    }
    __syncthreads();
#pragma unroll
    for (int cc = 0; cc < TC; cc += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[S::FM];
#pragma unroll
      for (int i = 0; i < S::FM; ++i)
        wmma::load_matrix_sync(af[i], as + (wm * S::WM + i * 16) * LDA + cc, LDA);
      if (BWD) {
        // B[c][o] = W[k = o][n = c]: the row-major [k][n] tile read col_major
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf[S::FO];
#pragma unroll
        for (int j = 0; j < S::FO; ++j)
          wmma::load_matrix_sync(bf[j], ws + (wo * S::WO + j * 16) * LDW + cc, LDW);
#pragma unroll
        for (int i = 0; i < S::FM; ++i)
#pragma unroll
          for (int j = 0; j < S::FO; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
      } else {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[S::FO];
#pragma unroll
        for (int j = 0; j < S::FO; ++j)
          wmma::load_matrix_sync(bf[j], ws + cc * LDW + wo * S::WO + j * 16, LDW);
#pragma unroll
        for (int i = 0; i < S::FM; ++i)
#pragma unroll
          for (int j = 0; j < S::FO; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
      }
    }
  }

  __syncthreads();  // every warp is done with the staged tiles
  float* cs = reinterpret_cast<float*>(raw) + warp * S::WM * S::LDC;
#pragma unroll
  for (int i = 0; i < S::FM; ++i)
#pragma unroll
    for (int j = 0; j < S::FO; ++j)
      wmma::store_matrix_sync(cs + (i * 16) * S::LDC + j * 16, acc[i][j], S::LDC,
                              wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < S::WM * S::WO; i += 32) {
    const int r = i / S::WO;
    const int c = i % S::WO;
    const int m = m0 + wm * S::WM + r;
    const int o = o0 + wo * S::WO + c;
    if (m < M && o < O) out[(size_t)m * O + o] = __float2bfloat16(cs[r * S::LDC + c]);
  }
}

template <bool DQ, bool BWD>
void launch(const void* a, const void* codes, const void* absmax, const void* scale,
            const void* offset, void* out, int M, int K, int N, int block_size,
            cudaStream_t stream) {
  const auto* ab = static_cast<const __nv_bfloat16*>(a);
  const auto* cd = static_cast<const int8_t*>(codes);
  const auto* sc = static_cast<const float*>(scale);
  const auto* of = static_cast<const float*>(offset);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  const int O = BWD ? K : N;
  if (M <= 16) {
    dim3 grid((O + TO - 1) / TO, (M + 15) / 16);
    qmm_i8_kernel<DQ, BWD, 16><<<grid, Shape<16>::NTHREADS, 0, stream>>>(
        ab, cd, absmax, sc, of, ob, M, K, N, block_size);
  } else {
    dim3 grid((O + TO - 1) / TO, (M + 127) / 128);
    qmm_i8_kernel<DQ, BWD, 128><<<grid, Shape<128>::NTHREADS, 0, stream>>>(
        ab, cd, absmax, sc, of, ob, M, K, N, block_size);
  }
}

template <bool BWD>
int entry(const void* a, const void* codes, const void* absmax, const void* scale,
          const void* offset, void* out, int M, int K, int N, int block_size, int dq,
          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dq)
    launch<true, BWD>(a, codes, absmax, scale, offset, out, M, K, N, block_size, s);
  else
    launch<false, BWD>(a, codes, absmax, scale, offset, out, M, K, N, block_size, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x bf16 [M, K] row-major; codes int8 [K, N]; absmax int8 (dq) or f32 [K/B, N];
// scale f32 [ceil((K/B)/256), N] and offset f32 [1] when dq, else unused; the
// codebook argument of the NF4 entries is unused here; y bf16 [M, N].  Returns
// the launch's cudaError_t.
extern "C" int qmm_i8_fwd(const void* x, const void* codes, const void* absmax,
                          const void* scale, const void* offset, const void* unused, void* y,
                          int M, int K, int N, int block_size, int dq, void* stream) {
  (void)unused;
  return entry<false>(x, codes, absmax, scale, offset, y, M, K, N, block_size, dq, stream);
}

// g bf16 [M, N] row-major; the weight as above; dx bf16 [M, K].
extern "C" int qmm_i8_bwd(const void* g, const void* codes, const void* absmax,
                          const void* scale, const void* offset, const void* unused, void* dx,
                          int M, int K, int N, int block_size, int dq, void* stream) {
  (void)unused;
  return entry<true>(g, codes, absmax, scale, offset, dx, M, K, N, block_size, dq, stream);
}
