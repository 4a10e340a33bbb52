// Backward of the fused NF4/FP4 dequantize + matmul with respect to its input:
// dx[M,K] = g[M,N] @ dequant(W)[K,N]^T.  The weight is frozen and gets no
// gradient; it is decoded again here instead of being kept from the forward.
//
// Replaces the TPU kernel qlora_tpu/ops/qmatmul.py::_qmm_bwd_pallas
// (_qmm_bwd_kernel).  That kernel takes f32 absmax only and has double
// quantization undone before it; this one also decodes int8 absmax itself
// (<DQ>), with the arithmetic of the forward kernel (qmm_nf4_fwd.cu: absmax =
// q * (scale * (1/127)) + offset as one fused multiply-add, then code * absmax
// rounded to bf16), so the backward sees the weight the forward saw bit for
// bit and no f32 absmax array is written to device memory on every call.
//
// Storage: packed u8 [K/2, N], byte (r, n) holds logical row r in its low
// nibble and row K/2 + r in its high one; absmax [K/B, N] f32, or int8 with
// f32 meta-scales [ceil((K/B)/256), N] and one f32 offset.
//
// What bounds it on an H100: at training shapes (M = micro-batch rows in the
// hundreds or thousands) the bf16 tensor-core rate, 2*M*K*N operations; the
// weight bytes K*N/2 matter only at a handful of rows.
//
// Design: a block of 8 warps owns a [128, 64] tile of dx and walks N, the
// contraction, 64 columns at a time.  Each step stages g[128, 64] and the
// decoded W[64, 64] (code[nibble] * absmax, rounded to bf16) in shared memory,
// W row-major [k][n]: read as a col_major matrix_b fragment that is W^T with
// no transpose pass.  Each element picks its nibble plane by its own logical
// row, so an output tile may straddle K/2, and every K, N and block size that
// quantize() accepts runs here with masked tails.  bf16 WMMA (m16n16k16), f32
// accumulators, bf16 output.  Later work: a wgmma/TMA pipeline, and decoding
// each weight tile once for more than 128 rows of g.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

// The absmax of row block `blk` of column n: f32 as stored, or int8 undone
// with its meta-block's scale and the offset, in the forward kernel's order.
template <bool DQ>
__device__ __forceinline__ float nf4_absmax(const void* __restrict__ absmax,
                                            const float* __restrict__ scale, float off, int blk,
                                            int n, int N) {
  if (DQ) {
    const int8_t* aq = static_cast<const int8_t*>(absmax);
    const float s = scale[(size_t)(blk / 256) * N + n] * (1.f / 127.f);
    return __fmaf_rn((float)aq[(size_t)blk * N + n], s, off);
  }
  return static_cast<const float*>(absmax)[(size_t)blk * N + n];
}

constexpr int TM = 128;
constexpr int TK = 64;        // logical rows of W (columns of dx) per block
constexpr int TN = 64;        // contraction step
constexpr int NTHREADS = 256;
constexpr int LDG = TN + 8;   // bf16 row pitch of the staged g tile
constexpr int LDW = TN + 8;   // bf16 row pitch of the staged weight tile
constexpr int LDC = 32 + 4;   // f32 row pitch of a warp's epilogue patch
constexpr int STAGE_BYTES = (TM * LDG + TK * LDW) * 2;
constexpr int EPI_BYTES = (NTHREADS / 32) * 32 * LDC * 4;
constexpr int SMEM_BYTES = STAGE_BYTES > EPI_BYTES ? STAGE_BYTES : EPI_BYTES;

template <bool DQ>
__global__ void __launch_bounds__(NTHREADS)
qmm_bwd_kernel(const __nv_bfloat16* __restrict__ g, const uint8_t* __restrict__ packed,
               const void* __restrict__ absmax, const float* __restrict__ scale,
               const float* __restrict__ offset, const float* __restrict__ code,
               __nv_bfloat16* __restrict__ dx, int M, int K, int N, int block_size) {
  __shared__ __align__(128) unsigned char raw[SMEM_BYTES];
  __shared__ float tab[16];
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(raw);   // [TM][LDG]
  __nv_bfloat16* ws = gs + TM * LDG;                           // [TK][LDW]

  const int K2 = K / 2;
  const int m0 = blockIdx.y * TM;
  const int k0 = blockIdx.x * TK;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp / 2;   // 4 warps along M, 32 rows each
  const int wk = warp % 2;   // 2 warps along K, 32 columns each
  if (tid < 16) tab[tid] = code[tid];
  const float off = DQ ? *offset : 0.f;
  const bool vec = (N % 8) == 0;   // 16-byte loads of g rows stay aligned

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int n0 = 0; n0 < N; n0 += TN) {
    __syncthreads();  // the previous step's tiles are consumed (and tab is written)
    for (int i = tid; i < TM * (TN / 8); i += NTHREADS) {
      const int r = i / (TN / 8);
      const int c = (i % (TN / 8)) * 8;
      const int m = m0 + r;
      const int n = n0 + c;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m < M) {
        if (vec && n + 8 <= N) {
          v = *reinterpret_cast<const uint4*>(g + (size_t)m * N + n);
        } else {
          __align__(16) __nv_bfloat16 e[8];
#pragma unroll
          for (int t = 0; t < 8; ++t)
            e[t] = (n + t < N) ? g[(size_t)m * N + n + t] : __float2bfloat16(0.f);
          v = *reinterpret_cast<const uint4*>(e);
        }
      }
      *reinterpret_cast<uint4*>(gs + r * LDG + c) = v;
    }
    for (int i = tid; i < TK * TN; i += NTHREADS) {
      const int r = i / TN;
      const int c = i % TN;
      const int k = k0 + r;
      const int n = n0 + c;
      float w = 0.f;
      if (k < K && n < N) {
        const bool high = k >= K2;
        const uint8_t b = packed[(size_t)(high ? k - K2 : k) * N + n];
        const float am = nf4_absmax<DQ>(absmax, scale, off, k / block_size, n, N);
        w = __fmul_rn(tab[high ? (b >> 4) : (b & 15)], am);
      }
      ws[r * LDW + c] = __float2bfloat16(w);
    }
    __syncthreads();
#pragma unroll
    for (int nn = 0; nn < TN; nn += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], gs + (wm * 32 + i * 16) * LDG + nn, LDG);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], ws + (wk * 32 + j * 16) * LDW + nn, LDW);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }

  __syncthreads();  // every warp is done with the staged tiles
  float* cs = reinterpret_cast<float*>(raw) + warp * 32 * LDC;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (i * 16) * LDC + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 32 * 32; i += 32) {
    const int r = i / 32;
    const int c = i % 32;
    const int m = m0 + wm * 32 + r;
    const int k = k0 + wk * 32 + c;
    if (m < M && k < K) dx[(size_t)m * K + k] = __float2bfloat16(cs[r * LDC + c]);
  }
}

template <bool DQ>
void launch(const void* g, const void* packed, const void* absmax, const void* scale,
            const void* offset, const void* code, void* dx, int M, int K, int N,
            int block_size, cudaStream_t stream) {
  dim3 grid((K + TK - 1) / TK, (M + TM - 1) / TM);
  qmm_bwd_kernel<DQ><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(g), static_cast<const uint8_t*>(packed), absmax,
      static_cast<const float*>(scale), static_cast<const float*>(offset),
      static_cast<const float*>(code), static_cast<__nv_bfloat16*>(dx), M, K, N, block_size);
}

}  // namespace

// g bf16 [M, N] row-major; packed u8 [K/2, N]; absmax int8 (dq) or f32 [K/B, N];
// scale f32 [ceil((K/B)/256), N] and offset f32 [1] when dq, else unused;
// code f32 [16]; dx bf16 [M, K].  Returns the launch's cudaError_t.
extern "C" int qmm_nf4_bwd(const void* g, const void* packed, const void* absmax,
                           const void* scale, const void* offset, const void* code, void* dx,
                           int M, int K, int N, int block_size, int dq, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dq)
    launch<true>(g, packed, absmax, scale, offset, code, dx, M, K, N, block_size, s);
  else
    launch<false>(g, packed, absmax, scale, offset, code, dx, M, K, N, block_size, s);
  return static_cast<int>(cudaGetLastError());
}
