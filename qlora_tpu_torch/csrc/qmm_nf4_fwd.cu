// Fused NF4/FP4 dequantize + matmul, forward: y[M,N] = x[M,K] @ dequant(W)[K,N].
//
// Replaces the TPU kernels qlora_tpu/ops/qmatmul.py::_qmm_pallas_dq
// (_qmm_fwd_kernel_dq -> _fwd_body, int8 double-quantized absmax undone in
// the kernel) and ::_qmm_pallas (_qmm_fwd_kernel, f32 absmax).  One template,
// <bool DQ>, serves both.
//
// Storage (qlora_tpu_torch/quant/blockwise.py): packed u8 [K/2, N] holds
// logical row r in the low nibble and row K/2 + r in the high one; absmax
// [K/B, N] is f32, or int8 with meta-scales f32 [ceil((K/B)/256), N] and one
// f32 offset (absmax = q * (scale * (1/127)) + offset, one fused multiply-add,
// as _fwd_body and XLA compute it).
//
// What bounds it on an H100: at prefill (M = B*S in the thousands) the bf16
// tensor-core rate, 2*M*K*N operations; at decode (M = batch, a few rows) the
// bytes of the weight, K*N/2 packed plus the absmax, over 3.35 TB/s.
//
// Design: a block owns a [TM, 64] output tile (TM = 64, or 16 when M <= 16)
// and walks the packed rows 64 at a time.  Each step stages the two x column
// slices that pair with those packed rows ([kp, kp+64) and [K/2+kp, ...)) and
// the decoded weights of both nibble planes, in bf16, into shared memory; each
// packed byte is read from device memory once per block.  The decode looks up
// the 16-entry codebook in shared memory and scales by the absmax of the
// element's own row block, so any block size, any number of meta-blocks and
// any K and N that quantize() accepts run here; ragged M, N and K/2 edges are
// masked.  Four warps contract the tiles with bf16 WMMA (m16n16k16) into f32
// accumulators; the epilogue rounds to bf16.  The dispatch (ops/qmatmul.py)
// sends rows above DECODE_ROWS here; fewer rows go to the split-K decode
// kernel of qmm_nf4_decode.cu, and the TM = 16 branch below is reached only
// through this entry directly.  Not yet done (later work): a wgmma/TMA
// pipeline for prefill and training rows.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TKP = 64;       // packed rows per step (64 logical rows per plane)
constexpr int TN = 64;
constexpr int NTHREADS = 128;
constexpr int LDX = TKP + 8;  // bf16 row pitch of the staged x tiles
constexpr int LDW = TN + 8;   // bf16 row pitch of the staged weight tiles
constexpr int LDC = TN + 4;   // f32 row pitch of the epilogue tile

template <bool DQ, int TM>
__global__ void __launch_bounds__(NTHREADS)
qmm_fwd_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
               const void* __restrict__ absmax, const float* __restrict__ scale,
               const float* __restrict__ offset, const float* __restrict__ code,
               __nv_bfloat16* __restrict__ y, int M, int K, int N, int block_size) {
  constexpr int WARPS_M = TM >= 32 ? 2 : 1;
  constexpr int WARPS_N = (NTHREADS / 32) / WARPS_M;
  constexpr int WM = TM / WARPS_M;
  constexpr int WN = TN / WARPS_N;
  constexpr int FM = WM / 16;
  constexpr int FN = WN / 16;
  constexpr int XS_BYTES = 2 * TM * LDX * 2;
  constexpr int CS_BYTES = TM * LDC * 4;
  static_assert(CS_BYTES <= XS_BYTES, "epilogue tile reuses the x tiles");

  __shared__ __align__(128) unsigned char xs_raw[XS_BYTES];
  __shared__ __align__(128) __nv_bfloat16 ws[2][TKP][LDW];
  __shared__ float tab[16];
  auto xs = reinterpret_cast<__nv_bfloat16 (*)[TM][LDX]>(xs_raw);

  const int K2 = K / 2;
  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * TN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  if (tid < 16) tab[tid] = code[tid];
  const float off = DQ ? *offset : 0.f;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int kp = 0; kp < K2; kp += TKP) {
    __syncthreads();  // the previous step's tiles are consumed
    for (int i = tid; i < 2 * TM * TKP; i += NTHREADS) {
      const int plane = i / (TM * TKP);
      const int r = (i / TKP) % TM;
      const int c = i % TKP;
      const int m = m0 + r;
      const int k = kp + c;
      __nv_bfloat16 v = __float2bfloat16(0.f);
      if (m < M && k < K2) v = x[(size_t)m * K + (size_t)plane * K2 + k];
      xs[plane][r][c] = v;
    }
    for (int i = tid; i < TKP * TN; i += NTHREADS) {
      const int r = i / TN;
      const int c = i % TN;
      const int row = kp + r;
      const int n = n0 + c;
      float wl = 0.f, wh = 0.f;
      if (row < K2 && n < N) {
        const uint8_t b = packed[(size_t)row * N + n];
        const int bl = row / block_size;
        const int bh = (row + K2) / block_size;
        float aml, amh;
        if (DQ) {
          const int8_t* aq = static_cast<const int8_t*>(absmax);
          const float sl = scale[(size_t)(bl / 256) * N + n] * (1.f / 127.f);
          const float sh = scale[(size_t)(bh / 256) * N + n] * (1.f / 127.f);
          aml = __fmaf_rn((float)aq[(size_t)bl * N + n], sl, off);
          amh = __fmaf_rn((float)aq[(size_t)bh * N + n], sh, off);
        } else {
          const float* af = static_cast<const float*>(absmax);
          aml = af[(size_t)bl * N + n];
          amh = af[(size_t)bh * N + n];
        }
        wl = __fmul_rn(tab[b & 15], aml);
        wh = __fmul_rn(tab[b >> 4], amh);
      }
      ws[0][r][c] = __float2bfloat16(wl);
      ws[1][r][c] = __float2bfloat16(wh);
    }
    __syncthreads();
#pragma unroll
    for (int plane = 0; plane < 2; ++plane) {
#pragma unroll
      for (int kk = 0; kk < TKP; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[FM];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bfr[FN];
#pragma unroll
        for (int i = 0; i < FM; ++i)
          wmma::load_matrix_sync(a[i], &xs[plane][wm * WM + i * 16][kk], LDX);
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::load_matrix_sync(bfr[j], &ws[plane][kk][wn * WN + j * 16], LDW);
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], bfr[j], acc[i][j]);
      }
    }
  }

  __syncthreads();
  float* cs = reinterpret_cast<float*>(xs_raw);
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(&cs[(wm * WM + i * 16) * LDC + wn * WN + j * 16], acc[i][j],
                              LDC, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < TM * TN; i += NTHREADS) {
    const int r = i / TN;
    const int c = i % TN;
    const int m = m0 + r;
    const int n = n0 + c;
    if (m < M && n < N) y[(size_t)m * N + n] = __float2bfloat16(cs[r * LDC + c]);
  }
}

template <bool DQ>
void launch(const void* x, const void* packed, const void* absmax, const void* scale,
            const void* offset, const void* code, void* y, int M, int K, int N,
            int block_size, cudaStream_t stream) {
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* pk = static_cast<const uint8_t*>(packed);
  const auto* sc = static_cast<const float*>(scale);
  const auto* of = static_cast<const float*>(offset);
  const auto* cb = static_cast<const float*>(code);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  if (M <= 16) {
    dim3 grid((N + TN - 1) / TN, (M + 15) / 16);
    qmm_fwd_kernel<DQ, 16><<<grid, NTHREADS, 0, stream>>>(xb, pk, absmax, sc, of, cb, yb, M,
                                                          K, N, block_size);
  } else {
    dim3 grid((N + TN - 1) / TN, (M + 63) / 64);
    qmm_fwd_kernel<DQ, 64><<<grid, NTHREADS, 0, stream>>>(xb, pk, absmax, sc, of, cb, yb, M,
                                                          K, N, block_size);
  }
}

}  // namespace

// x bf16 [M, K] row-major; packed u8 [K/2, N]; absmax int8 (dq) or f32 [K/B, N];
// scale f32 [ceil((K/B)/256), N] and offset f32 [1] when dq, else unused;
// code f32 [16]; y bf16 [M, N].  Returns the launch's cudaError_t.
extern "C" int qmm_nf4_fwd(const void* x, const void* packed, const void* absmax,
                           const void* scale, const void* offset, const void* code, void* y,
                           int M, int K, int N, int block_size, int dq, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dq)
    launch<true>(x, packed, absmax, scale, offset, code, y, M, K, N, block_size, s);
  else
    launch<false>(x, packed, absmax, scale, offset, code, y, M, K, N, block_size, s);
  return static_cast<int>(cudaGetLastError());
}
