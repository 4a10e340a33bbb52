// int8 x int8 matmul on the tensor cores with an exact int32 sum, scaled in the
// epilogue: the serving engines' decode path (w8a8).
//   qmm_i8_direct:  y[M,N] = (x8[M,K] @ w8[K,N]) * s_out[n] * xs[m], w8 read as stored
//   qmm_nf4_w8a8:   the same, w8 decoded here from NF4/FP4 nibbles
//
// Replaces the TPU kernels qlora_tpu/ops/qmatmul.py::_qmm_pallas_i8_direct
// (_i8_direct_kernel) and ::_qmm_pallas_w8a8 (_w8a8_fwd_kernel).  Above 16
// rows the NF4 entry is reached only where ops/qmatmul.py: w8a8_tile_plan
// refuses the shape (K % 32 != 0) and as the "before" that chip_smoke.py
// times beside qmm_nf4_w8a8_wgmma.cu, which takes those rows; at 16 rows or
// fewer only where ops/qmatmul.py: nf4_w8a8_decode_plan refuses the shape (K
// % 64, N % 16 or the block size % 32 not 0) and as the "before" of
// qmm_nf4_w8a8_decode.cu, which takes those rows.  The direct
// (per-column) entry is the "before" of qmm_i8_direct_decode.cu at 16 rows
// or fewer, which it times through this C entry: it keeps more rows and the
// shapes ops/qmatmul.py: i8_direct_decode_plan refuses (K % 32 != 0, N % 16
// != 0).  As there, the
// rows of x are quantized to int8 before the kernel (xs = max|x| / 127,
// x8 = round(x / xs)) and the per-column scales are made before it
// (s_out = col / 127; for NF4, ratio = absmax * (127 / col) with col the
// column's largest absmax).  The epilogue reproduces the reference's two bf16
// roundings: y = bf16(bf16(float(acc) * s_out[n]) * bf16(xs[m])).  With s_out
// null the kernel writes the int32 accumulators instead, so that a check can
// hold the integer product to its plain version bit for bit.
//
// Storage: direct, codes int8 [K, N] row-major, one scale per column
// (block_size = K).  NF4, packed u8 [K/2, N]: byte (r, n) holds logical row r in
// its low nibble and row K/2 + r in its high one; ratio f32 [K/B, N]; a weight
// element is int8(rint(code[nibble] * ratio[k / B, n])), half to even as
// jnp.round and torch.round.
//
// What bounds them on an H100: at decode (M = batch, a few rows) the bytes of
// the weight over 3.35 TB/s, K*N for int8 codes, K*N/2 plus the ratios for NF4;
// at prefill rows the int8 tensor-core rate, 2*M*K*N operations.
//
// Design: a block of 4 warps owns a [TM, 64] output tile (TM = 64, or 16 when
// M <= 16) and walks K 64 rows at a time (NF4: 64 packed rows, which are two
// planes of 64 logical rows, each with its own slice of x8).  Weight rows and
// x8 rows move 16 bytes a thread where the shape allows it, byte by byte with
// masks otherwise, so every K and N runs.  Shared memory holds each tile as
// 16-byte-wide slabs with a 32-byte row pitch, which keeps every WMMA fragment
// pointer 32-byte aligned; int8 WMMA (m16n16k16, int32 accumulators).  Later
// work: at M <= 16 three quarters of each fragment's rows are idle and only
// ceil(N/64) blocks walk all of K with no load in flight during the MMAs
// (split-K, cp.async or TMA, wgmma at prefill rows).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TK = 64;        // rows of each plane per step
constexpr int TN = 64;
constexpr int NTHREADS = 128;
constexpr int SLAB = 16;      // bytes of a tile row held in one slab
constexpr int PITCH = 32;     // row pitch inside a slab, bytes
constexpr int LDC = TN + 4;   // int32 row pitch of the epilogue tile

template <bool NF4, int TM>
__global__ void __launch_bounds__(NTHREADS)
qmm_w8a8_kernel(const int8_t* __restrict__ x8, const void* __restrict__ weight,
                const float* __restrict__ ratio, const float* __restrict__ s_out,
                const float* __restrict__ xs, const float* __restrict__ code,
                void* __restrict__ y, int M, int K, int N, int block_size) {
  constexpr int PLANES = NF4 ? 2 : 1;
  constexpr int WARPS_M = TM >= 32 ? 2 : 1;
  constexpr int WARPS_N = (NTHREADS / 32) / WARPS_M;
  constexpr int WM = TM / WARPS_M;
  constexpr int WN = TN / WARPS_N;
  constexpr int FM = WM / 16;
  constexpr int FN = WN / 16;
  constexpr int XS_BYTES = PLANES * (TK / SLAB) * TM * PITCH;
  constexpr int WS_BYTES = PLANES * (TN / SLAB) * TK * PITCH;
  constexpr int CS_BYTES = TM * LDC * 4;
  constexpr int SMEM_BYTES = XS_BYTES + WS_BYTES > CS_BYTES ? XS_BYTES + WS_BYTES : CS_BYTES;

  __shared__ __align__(128) unsigned char raw[SMEM_BYTES];
  __shared__ float tab[16];
  // xt[plane][k slab][row][PITCH], wt[plane][n slab][k][PITCH]
  int8_t* xt = reinterpret_cast<int8_t*>(raw);
  int8_t* wt = xt + XS_BYTES;

  const int KP = NF4 ? K / 2 : K;       // rows of one plane
  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * TN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  if (NF4 && tid < 16) tab[tid] = code[tid];
  const bool xvec = (K % 16) == 0 && (KP % 16) == 0 &&
                    (reinterpret_cast<uintptr_t>(x8) % 16) == 0;
  const bool wvec = (N % 16) == 0 && (reinterpret_cast<uintptr_t>(weight) % 16) == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0);

  for (int kp = 0; kp < KP; kp += TK) {
    __syncthreads();  // the previous step's tiles are consumed (and tab is written)
    // x8 rows: 16-byte chunks, chunk (plane, row r, slab s) = x8[m0 + r][plane*KP + kp + 16 s ...]
    for (int i = tid; i < PLANES * TM * (TK / SLAB); i += NTHREADS) {
      const int plane = i / (TM * (TK / SLAB));
      const int r = (i / (TK / SLAB)) % TM;
      const int s = i % (TK / SLAB);
      const int m = m0 + r;
      const int k = kp + s * SLAB;          // within the plane
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m < M && k < KP) {
        const int8_t* src = x8 + (size_t)m * K + (size_t)plane * KP + k;
        if (xvec && k + SLAB <= KP) {
          v = *reinterpret_cast<const uint4*>(src);
        } else {
          __align__(16) int8_t e[SLAB];
#pragma unroll
          for (int t = 0; t < SLAB; ++t) e[t] = (k + t < KP) ? src[t] : (int8_t)0;
          v = *reinterpret_cast<const uint4*>(e);
        }
      }
      *reinterpret_cast<uint4*>(xt + ((plane * (TK / SLAB) + s) * TM + r) * PITCH) = v;
    }
    // weight rows: chunk (row r, slab s) = 16 columns n0 + 16 s ... of row kp + r
    for (int i = tid; i < TK * (TN / SLAB); i += NTHREADS) {
      const int r = i / (TN / SLAB);
      const int s = i % (TN / SLAB);
      const int row = kp + r;
      const int n = n0 + s * SLAB;
      __align__(16) uint8_t b[SLAB];
      *reinterpret_cast<uint4*>(b) = make_uint4(0u, 0u, 0u, 0u);
      const bool live = row < KP && n < N;
      if (live) {
        const uint8_t* src = static_cast<const uint8_t*>(weight) + (size_t)row * N + n;
        if (wvec && n + SLAB <= N) {
          *reinterpret_cast<uint4*>(b) = *reinterpret_cast<const uint4*>(src);
        } else {
#pragma unroll
          for (int t = 0; t < SLAB; ++t) b[t] = (n + t < N) ? src[t] : (uint8_t)0;
        }
      }
      if (NF4) {
        __align__(16) int8_t lo[SLAB];
        __align__(16) int8_t hi[SLAB];
        const int bl = row / block_size;
        const int bh = (row + KP) / block_size;
#pragma unroll
        for (int t = 0; t < SLAB; ++t) {
          int ql = 0, qh = 0;
          if (live && n + t < N) {
            const float rl = ratio[(size_t)bl * N + n + t];
            const float rh = ratio[(size_t)bh * N + n + t];
            ql = __float2int_rn(__fmul_rn(tab[b[t] & 15], rl));
            qh = __float2int_rn(__fmul_rn(tab[b[t] >> 4], rh));
          }
          lo[t] = (int8_t)ql;
          hi[t] = (int8_t)qh;
        }
        *reinterpret_cast<uint4*>(wt + ((0 * (TN / SLAB) + s) * TK + r) * PITCH) =
            *reinterpret_cast<const uint4*>(lo);
        *reinterpret_cast<uint4*>(wt + ((1 * (TN / SLAB) + s) * TK + r) * PITCH) =
            *reinterpret_cast<const uint4*>(hi);
      } else {
        *reinterpret_cast<uint4*>(wt + (s * TK + r) * PITCH) =
            *reinterpret_cast<const uint4*>(b);
      }
    }
    __syncthreads();
#pragma unroll
    for (int plane = 0; plane < PLANES; ++plane) {
#pragma unroll
      for (int ks = 0; ks < TK / SLAB; ++ks) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a[FM];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> bf[FN];
#pragma unroll
        for (int i = 0; i < FM; ++i)
          wmma::load_matrix_sync(
              a[i],
              reinterpret_cast<const signed char*>(
                  xt + ((plane * (TK / SLAB) + ks) * TM + wm * WM + i * 16) * PITCH),
              PITCH);
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::load_matrix_sync(
              bf[j],
              reinterpret_cast<const signed char*>(
                  wt + ((plane * (TN / SLAB) + (wn * WN) / SLAB + j) * TK + ks * SLAB) * PITCH),
              PITCH);
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
      }
    }
  }

  __syncthreads();  // every warp is done with the staged tiles
  int* cs = reinterpret_cast<int*>(raw);
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(&cs[(wm * WM + i * 16) * LDC + wn * WN + j * 16], acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < TM * TN; i += NTHREADS) {
    const int r = i / TN;
    const int c = i % TN;
    const int m = m0 + r;
    const int n = n0 + c;
    if (m >= M || n >= N) continue;
    const int a32 = cs[r * LDC + c];
    if (s_out == nullptr) {
      static_cast<int*>(y)[(size_t)m * N + n] = a32;
    } else {
      const __nv_bfloat16 scaled = __float2bfloat16(__fmul_rn(__int2float_rn(a32), s_out[n]));
      const float row_scale = __bfloat162float(__float2bfloat16(xs[m]));
      static_cast<__nv_bfloat16*>(y)[(size_t)m * N + n] =
          __float2bfloat16(__fmul_rn(__bfloat162float(scaled), row_scale));
    }
  }
}

template <bool NF4>
int launch(const void* x8, const void* weight, const void* ratio, const void* s_out,
           const void* xs, const void* code, void* y, int M, int K, int N, int block_size,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int8_t*>(x8);
  const auto* rp = static_cast<const float*>(ratio);
  const auto* sp = static_cast<const float*>(s_out);
  const auto* xsp = static_cast<const float*>(xs);
  const auto* cp = static_cast<const float*>(code);
  if (M <= 16) {
    dim3 grid((N + TN - 1) / TN, (M + 15) / 16);
    qmm_w8a8_kernel<NF4, 16><<<grid, NTHREADS, 0, st>>>(xp, weight, rp, sp, xsp, cp, y, M, K, N,
                                                        block_size);
  } else {
    dim3 grid((N + TN - 1) / TN, (M + 63) / 64);
    qmm_w8a8_kernel<NF4, 64><<<grid, NTHREADS, 0, st>>>(xp, weight, rp, sp, xsp, cp, y, M, K, N,
                                                        block_size);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x8 int8 [M, K] row-major; codes int8 [K, N]; s_out f32 [N] and xs f32 [M], or
// both null for raw accumulators; y bf16 [M, N], or int32 [M, N] when s_out is
// null.  Returns the launch's cudaError_t.
extern "C" int qmm_i8_direct(const void* x8, const void* codes, const void* s_out,
                             const void* xs, void* y, int M, int K, int N, void* stream) {
  return launch<false>(x8, codes, nullptr, s_out, xs, nullptr, y, M, K, N, K, stream);
}

// x8 int8 [M, K]; packed u8 [K/2, N]; ratio f32 [K/B, N]; s_out, xs and y as
// above; code f32 [16].
extern "C" int qmm_nf4_w8a8(const void* x8, const void* packed, const void* ratio,
                            const void* s_out, const void* xs, const void* code, void* y, int M,
                            int K, int N, int block_size, void* stream) {
  return launch<true>(x8, packed, ratio, s_out, xs, code, y, M, K, N, block_size, stream);
}
