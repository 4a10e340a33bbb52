// Flash attention for training and the no-cache forward: the forward with its
// lse residual, and the two backward kernels (dq; dk and dv).
//
// Replaces the TPU kernels qlora_tpu/ops/flash_attention.py::_flash_fwd
// (_fwd_kernel) and ::_flash_bwd (_bwd_dq_kernel, _bwd_dkv_kernel).
//
// Layout: q, o, do, dq bf16 [B, H, Sq, D]; k, v, dk, dv bf16 [B, KVH, Skv, D]
// with KVH | H (query head h reads kv head h / (H / KVH)); kv_lengths int32
// [B]; lse and di f32 [B, H, Sq].  Key `col` is visible to query `row` when
//   col < kv_lengths[b]  &&  (!causal || col <= row)  &&  (!window || row - col < window).
// A row with no visible key gets o = 0 and lse = 3e38, so the backward's
// exp(s - lse) is 0 and its gradients are exactly 0.  lse is in nats.
//
// Arithmetic, as the TPU kernels: bf16 operands, f32 accumulation, f32 softmax
// statistics; the probabilities are rounded to bf16 for the p v and p^T do
// products, ds = p (dp - di) sm_scale is rounded to bf16 for ds k and ds^T q,
// the output is normalised once at the end.  di = sum(o do) - dlse is computed
// by the caller.
//
// What bounds them on an H100: at training lengths (S in the hundreds) each
// kernel reads and writes a few tensors of B H S D bf16 once, which takes
// longer at 3.35 TB/s than the 4 B H S^2 D / 2 (forward, causal) or
// 10 B H S^2 D / 2 (backward) tensor-core operations at 989 TFLOP/s; from
// S of a few thousand on the operations bound.
//
// Design: every kernel walks 64 x 64 score tiles with 4 warps; a warp owns 16
// rows of its block's tile, so a row's statistics stay inside one warp.
//   forward, dq: one block per (b, h, 64 query rows), walking the kv tiles
//     from the window's start to the causal / length limit (tiles that are
//     wholly masked are never loaded).
//   dk, dv: one block per (b, kv head, 64 keys), walking the query tiles that
//     can see those keys, for each of the G query heads of the kv head in
//     turn, summing in registers: no repeated K/V in memory, no atomics, the
//     same sum in every run.
// Products are bf16 WMMA (m16n16k16).  A score tile goes through shared memory
// as f32, where the lanes (two per row) mask it, exponentiate it and write the
// bf16 operand of the next product.  K^T, V^T, Q^T and dO^T are never formed:
// the row-major tiles are read as col_major matrix_b fragments.  The output
// accumulators stay in WMMA fragments; a per-row factor (the online softmax's
// exp(m_old - m_new), or 1/l at the end) reaches them as an accumulator
// fragment loaded from a 16 x 16 patch whose rows hold the factor, since two
// fragments of one type share their element layout.  Shared memory is dynamic
// (81 to 121 KB at D = 128).  Head dims 64 and 128; any Sq and Skv, tails
// masked.  Later work: mma fragments with known layouts (no round trip of the
// scores through shared memory), cp.async double buffering, wgmma.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDS = 64 + 4;     // f32 row pitch of a warp's [16][64] score patch
constexpr int LDP = 64 + 8;     // bf16 row pitch of a warp's [16][64] operand patch
constexpr float EMPTY_LSE = 3e38f;
constexpr unsigned FULL = 0xffffffffu;

template <int D>
struct Layout {
  static constexpr int LDT = D + 8;                     // bf16 row pitch of a [64][D] tile
  static constexpr int LDO = D + 4;                     // f32 row pitch of the epilogue stage
  static constexpr int TILE = 64 * LDT;                 // elements
  static constexpr int PATCH_F = NWARPS * 16 * LDS;     // elements (f32)
  static constexpr int PATCH_H = NWARPS * 16 * LDP;     // elements (bf16)
  static constexpr int FWD_BYTES = 3 * TILE * 2 + PATCH_F * 4 + PATCH_H * 2 + NWARPS * 256 * 4;
  static constexpr int DQ_BYTES = 4 * TILE * 2 + 2 * PATCH_F * 4 + PATCH_H * 2;
  static constexpr int DKV_BYTES = 4 * TILE * 2 + 2 * PATCH_F * 4 + 2 * PATCH_H * 2 + 2 * 64 * 4;
  static_assert(64 * LDO * 4 <= 2 * TILE * 2, "the epilogue stage reuses two tiles");
};

__device__ __forceinline__ bool visible(int row, int col, int kvlen, int causal, int window) {
  return col < kvlen && (!causal || col <= row) && (window <= 0 || row - col < window);
}

// rows [row0, row0 + 64) of src [nrows][D] into dst [64][D + 8]; zero past the end
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, int row0,
                                          int nrows, int tid) {
  constexpr int C8 = D / 8;
  for (int i = tid; i < 64 * C8; i += NTHREADS) {
    const int r = i / C8;
    const int c = (i % C8) * 8;
    const int row = row0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < nrows) v = *reinterpret_cast<const uint4*>(src + (size_t)row * D + c);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = v;
  }
}

// out[16][64] (f32, pitch LDS) = a[16][D] @ t[64][D]^T, both bf16 with pitch D + 8
template <int D>
__device__ __forceinline__ void rows_times_tile_t(const bf16* a, const bf16* t, float* out) {
  constexpr int LDT = D + 8;
  AccFrag acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
    wmma::load_matrix_sync(af, a + kk, LDT);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
      wmma::load_matrix_sync(bfr, t + (j * 16) * LDT + kk, LDT);
      wmma::mma_sync(acc[j], af, bfr, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(out + j * 16, acc[j], LDS, wmma::mem_row_major);
}

// acc[16][D] += p[16][64] (bf16, pitch LDP) @ t[64][D] (bf16, pitch D + 8)
template <int D>
__device__ __forceinline__ void add_patch_times_tile(const bf16* p, const bf16* t,
                                                     AccFrag (&acc)[D / 16]) {
  constexpr int LDT = D + 8;
#pragma unroll
  for (int kk = 0; kk < 64; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
    wmma::load_matrix_sync(af, p + kk, LDP);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
      wmma::load_matrix_sync(bfr, t + kk * LDT + j * 16, LDT);
      wmma::mma_sync(acc[j], af, bfr, acc[j]);
    }
  }
}

// multiply row r of every accumulator by patch[r][*] (all 16 entries of a row equal)
template <int D>
__device__ __forceinline__ void scale_rows(AccFrag (&acc)[D / 16], const float* patch) {
  AccFrag f;
  wmma::load_matrix_sync(f, patch, 16, wmma::mem_row_major);
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
#pragma unroll
    for (int e = 0; e < f.num_elements; ++e) acc[j].x[e] *= f.x[e];
}

// the warp's 16 accumulator rows, rounded to bf16, into rows [row0, row0 + 16)
// of dst [nrows][D], through the warp's f32 stage [16][D + 4]
template <int D>
__device__ __forceinline__ void store_rows(AccFrag (&acc)[D / 16], float* stage,
                                           bf16* __restrict__ dst, int row0, int nrows,
                                           int lane) {
  constexpr int LDO = D + 4;
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wmma::store_matrix_sync(stage + j * 16, acc[j], LDO, wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 16 * (D / 2); i += 32) {
    const int r = i / (D / 2);
    const int c = (i % (D / 2)) * 2;
    const int row = row0 + r;
    if (row < nrows)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row * D + c) =
          __floats2bfloat162_rn(stage[r * LDO + c], stage[r * LDO + c + 1]);
  }
  __syncwarp();
}

// the kv tiles a query tile starting at q0 can see: [first, last)
__device__ __forceinline__ void kv_range(int q0, int kvlen, int causal, int window, int& first,
                                         int& last) {
  int hi = kvlen;
  if (causal) hi = min(hi, q0 + BQ);
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  first = lo / BK;
  last = (hi + BK - 1) / BK;
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ kv_lengths,
                 bf16* __restrict__ o, float* __restrict__ lse, int H, int KVH, int Sq, int Skv,
                 float sm_scale, int causal, int window) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + L::TILE;
  bf16* Vs = Ks + L::TILE;
  float* Ss = reinterpret_cast<float*>(Vs + L::TILE);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + L::PATCH_F);
  float* As = reinterpret_cast<float*>(Ps + L::PATCH_H);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int kvlen = max(0, min(kv_lengths[b], Skv));
  const size_t qoff = (size_t)(b * H + h) * Sq;
  const bf16* kb = k + (size_t)(b * KVH + kvh) * Skv * D;
  const bf16* vb = v + (size_t)(b * KVH + kvh) * Skv * D;
  float* Sw = Ss + warp * 16 * LDS;
  bf16* Pw = Ps + warp * 16 * LDP;
  float* Aw = As + warp * 256;
  const int r = lane >> 1;        // two lanes share a row, 32 columns each
  const int half = lane & 1;
  const int row = q0 + warp * 16 + r;

  load_tile<D>(Qs, q + qoff * D, q0, Sq, tid);
  int first, last;
  kv_range(q0, kvlen, causal, window, first, last);

  float m = -INFINITY, l = 0.f;
  AccFrag oacc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(oacc[j], 0.f);

  for (int t = first; t < last; ++t) {
    __syncthreads();   // the previous tile is consumed
    load_tile<D>(Ks, kb, t * BK, Skv, tid);
    load_tile<D>(Vs, vb, t * BK, Skv, tid);
    __syncthreads();
    rows_times_tile_t<D>(Qs + warp * 16 * L::LDT, Ks, Sw);
    __syncwarp();
    const int c0 = t * BK + half * 32;
    const float* srow = Sw + r * LDS + half * 32;
    float mx = -INFINITY;
    for (int c = 0; c < 32; ++c)
      if (visible(row, c0 + c, kvlen, causal, window)) mx = fmaxf(mx, srow[c] * sm_scale);
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = (m_new == -INFINITY) ? 1.f : expf(m - m_new);
    bf16* prow = Pw + r * LDP + half * 32;
    float sum = 0.f;
    for (int c = 0; c < 32; ++c) {
      const float p =
          visible(row, c0 + c, kvlen, causal, window) ? expf(srow[c] * sm_scale - m_new) : 0.f;
      prow[c] = __float2bfloat16(p);
      sum += p;
    }
    sum += __shfl_xor_sync(FULL, sum, 1);
    l = l * alpha + sum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < 8; ++i) Aw[r * 16 + half * 8 + i] = alpha;
    __syncwarp();
    scale_rows<D>(oacc, Aw);
    add_patch_times_tile<D>(Pw, Vs, oacc);
  }

  const float inv = l > 0.f ? 1.f / l : 0.f;   // no visible key: o = 0
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 8; ++i) Aw[r * 16 + half * 8 + i] = inv;
  __syncwarp();
  scale_rows<D>(oacc, Aw);
  __syncthreads();   // every warp is done with the K and V tiles
  float* stage = reinterpret_cast<float*>(Ks) + warp * 16 * L::LDO;
  store_rows<D>(oacc, stage, o + qoff * D, q0 + warp * 16, Sq, lane);
  if (lse != nullptr && half == 0 && row < Sq)
    lse[qoff + row] = l > 0.f ? m + logf(l) : EMPTY_LSE;
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ kv_lengths,
                    const bf16* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ di, bf16* __restrict__ dq, int H, int KVH, int Sq,
                    int Skv, float sm_scale, int causal, int window) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + L::TILE;
  bf16* Ks = dOs + L::TILE;
  bf16* Vs = Ks + L::TILE;
  float* Ss = reinterpret_cast<float*>(Vs + L::TILE);
  float* DPs = Ss + L::PATCH_F;
  bf16* dSs = reinterpret_cast<bf16*>(DPs + L::PATCH_F);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int kvlen = max(0, min(kv_lengths[b], Skv));
  const size_t qoff = (size_t)(b * H + h) * Sq;
  const bf16* kb = k + (size_t)(b * KVH + kvh) * Skv * D;
  const bf16* vb = v + (size_t)(b * KVH + kvh) * Skv * D;
  float* Sw = Ss + warp * 16 * LDS;
  float* DPw = DPs + warp * 16 * LDS;
  bf16* dSw = dSs + warp * 16 * LDP;
  const int r = lane >> 1;
  const int half = lane & 1;
  const int row = q0 + warp * 16 + r;
  const float lse_r = row < Sq ? lse[qoff + row] : EMPTY_LSE;
  const float di_r = row < Sq ? di[qoff + row] : 0.f;

  load_tile<D>(Qs, q + qoff * D, q0, Sq, tid);
  load_tile<D>(dOs, dout + qoff * D, q0, Sq, tid);
  int first, last;
  kv_range(q0, kvlen, causal, window, first, last);

  AccFrag acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int t = first; t < last; ++t) {
    __syncthreads();
    load_tile<D>(Ks, kb, t * BK, Skv, tid);
    load_tile<D>(Vs, vb, t * BK, Skv, tid);
    __syncthreads();
    rows_times_tile_t<D>(Qs + warp * 16 * L::LDT, Ks, Sw);     // s = q k^T
    rows_times_tile_t<D>(dOs + warp * 16 * L::LDT, Vs, DPw);   // dp = do v^T
    __syncwarp();
    const int c0 = t * BK + half * 32;
    const float* srow = Sw + r * LDS + half * 32;
    const float* dprow = DPw + r * LDS + half * 32;
    bf16* dsrow = dSw + r * LDP + half * 32;
    for (int c = 0; c < 32; ++c) {
      const float p =
          visible(row, c0 + c, kvlen, causal, window) ? expf(srow[c] * sm_scale - lse_r) : 0.f;
      dsrow[c] = __float2bfloat16(p * (dprow[c] - di_r) * sm_scale);
    }
    __syncwarp();
    add_patch_times_tile<D>(dSw, Ks, acc);                     // dq += ds k
  }

  __syncthreads();
  float* stage = reinterpret_cast<float*>(Ks) + warp * 16 * L::LDO;
  store_rows<D>(acc, stage, dq + qoff * D, q0 + warp * 16, Sq, lane);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ kv_lengths,
                     const bf16* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ di, bf16* __restrict__ dk, bf16* __restrict__ dv,
                     int H, int KVH, int Sq, int Skv, float sm_scale, int causal, int window) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + L::TILE;
  bf16* Qs = Vs + L::TILE;
  bf16* dOs = Qs + L::TILE;
  float* STs = reinterpret_cast<float*>(dOs + L::TILE);
  float* DPTs = STs + L::PATCH_F;
  bf16* PTs = reinterpret_cast<bf16*>(DPTs + L::PATCH_F);
  bf16* dSTs = PTs + L::PATCH_H;
  float* Ls = reinterpret_cast<float*>(dSTs + L::PATCH_H);   // lse of the query tile
  float* Ds = Ls + 64;                                       // di of the query tile

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KVH;
  const int kvlen = max(0, min(kv_lengths[b], Skv));
  const size_t koff = (size_t)(b * KVH + kvh) * Skv;
  float* STw = STs + warp * 16 * LDS;
  float* DPTw = DPTs + warp * 16 * LDS;
  bf16* PTw = PTs + warp * 16 * LDP;
  bf16* dSTw = dSTs + warp * 16 * LDP;
  const int r = lane >> 1;        // two lanes share a key, 32 query rows each
  const int half = lane & 1;
  const int key = k0 + warp * 16 + r;

  AccFrag dkacc[D / 16], dvacc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::fill_fragment(dkacc[j], 0.f);
    wmma::fill_fragment(dvacc[j], 0.f);
  }

  if (k0 < kvlen) {   // else no query sees these keys: dk = dv = 0
    load_tile<D>(Ks, k + koff * D, k0, Skv, tid);
    load_tile<D>(Vs, v + koff * D, k0, Skv, tid);
    // the query rows that can see a key of this tile: [row_lo, row_hi)
    const int row_lo = causal ? k0 : 0;
    const int row_hi = window > 0 ? min(Sq, k0 + BK - 1 + window) : Sq;
    for (int g = 0; g < G; ++g) {
      const size_t qoff = (size_t)(b * H + kvh * G + g) * Sq;
      for (int t = row_lo / BQ; t * BQ < row_hi; ++t) {
        __syncthreads();   // the previous query tile is consumed
        load_tile<D>(Qs, q + qoff * D, t * BQ, Sq, tid);
        load_tile<D>(dOs, dout + qoff * D, t * BQ, Sq, tid);
        if (tid < 64) {
          const int rr = t * BQ + tid;
          Ls[tid] = rr < Sq ? lse[qoff + rr] : EMPTY_LSE;
          Ds[tid] = rr < Sq ? di[qoff + rr] : 0.f;
        }
        __syncthreads();
        rows_times_tile_t<D>(Ks + warp * 16 * L::LDT, Qs, STw);     // s^T = k q^T
        rows_times_tile_t<D>(Vs + warp * 16 * L::LDT, dOs, DPTw);   // dp^T = v do^T
        __syncwarp();
        const int c0 = half * 32;
        const float* srow = STw + r * LDS + c0;
        const float* dprow = DPTw + r * LDS + c0;
        bf16* prow = PTw + r * LDP + c0;
        bf16* dsrow = dSTw + r * LDP + c0;
        for (int c = 0; c < 32; ++c) {
          const int row = t * BQ + c0 + c;
          const float p = visible(row, key, kvlen, causal, window)
                              ? expf(srow[c] * sm_scale - Ls[c0 + c])
                              : 0.f;
          prow[c] = __float2bfloat16(p);
          dsrow[c] = __float2bfloat16(p * (dprow[c] - Ds[c0 + c]) * sm_scale);
        }
        __syncwarp();
        add_patch_times_tile<D>(PTw, dOs, dvacc);    // dv += p^T do
        add_patch_times_tile<D>(dSTw, Qs, dkacc);    // dk += ds^T q
      }
    }
  }

  __syncthreads();   // every warp is done with the Q and dO tiles
  float* stage = reinterpret_cast<float*>(Qs) + warp * 16 * L::LDO;
  store_rows<D>(dkacc, stage, dk + koff * D, k0 + warp * 16, Skv, lane);
  store_rows<D>(dvacc, stage, dv + koff * D, k0 + warp * 16, Skv, lane);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* lens, void* o,
                       void* lse, int B, int H, int KVH, int Sq, int Skv, float sm_scale,
                       int causal, int window, void* stream) {
  cudaError_t e = allow_smem(flash_fwd_kernel<D>, Layout<D>::FWD_BYTES);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D><<<grid, NTHREADS, Layout<D>::FWD_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(lens), static_cast<bf16*>(o), static_cast<float*>(lse), H, KVH, Sq,
      Skv, sm_scale, causal, window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* lens,
                      const void* dout, const void* lse, const void* di, void* dq, int B, int H,
                      int KVH, int Sq, int Skv, float sm_scale, int causal, int window,
                      void* stream) {
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<D>, Layout<D>::DQ_BYTES);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_bwd_dq_kernel<D>
      <<<grid, NTHREADS, Layout<D>::DQ_BYTES, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          static_cast<const int*>(lens), static_cast<const bf16*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(di), static_cast<bf16*>(dq),
          H, KVH, Sq, Skv, sm_scale, causal, window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* lens,
                       const void* dout, const void* lse, const void* di, void* dk, void* dv,
                       int B, int H, int KVH, int Sq, int Skv, float sm_scale, int causal,
                       int window, void* stream) {
  cudaError_t e = allow_smem(flash_bwd_dkv_kernel<D>, Layout<D>::DKV_BYTES);
  if (e != cudaSuccess) return e;
  dim3 grid((Skv + BK - 1) / BK, KVH, B);
  flash_bwd_dkv_kernel<D>
      <<<grid, NTHREADS, Layout<D>::DKV_BYTES, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          static_cast<const int*>(lens), static_cast<const bf16*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(di), static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), H, KVH, Sq, Skv, sm_scale, causal, window);
  return cudaGetLastError();
}

}  // namespace

// Every entry returns the launch's cudaError_t; cudaErrorInvalidValue for a head
// dim other than 64 or 128.  window <= 0 means no sliding window; lse may be null
// in flash_fwd.

extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* kv_lengths,
                         void* o, void* lse, int B, int H, int KVH, int Sq, int Skv, int D,
                         float sm_scale, int causal, int window, void* stream) {
  if (D == 64)
    return launch_fwd<64>(q, k, v, kv_lengths, o, lse, B, H, KVH, Sq, Skv, sm_scale, causal,
                          window, stream);
  if (D == 128)
    return launch_fwd<128>(q, k, v, kv_lengths, o, lse, B, H, KVH, Sq, Skv, sm_scale, causal,
                           window, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* kv_lengths,
                            const void* dout, const void* lse, const void* di, void* dq, int B,
                            int H, int KVH, int Sq, int Skv, int D, float sm_scale, int causal,
                            int window, void* stream) {
  if (D == 64)
    return launch_dq<64>(q, k, v, kv_lengths, dout, lse, di, dq, B, H, KVH, Sq, Skv, sm_scale,
                         causal, window, stream);
  if (D == 128)
    return launch_dq<128>(q, k, v, kv_lengths, dout, lse, di, dq, B, H, KVH, Sq, Skv, sm_scale,
                          causal, window, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* kv_lengths,
                             const void* dout, const void* lse, const void* di, void* dk,
                             void* dv, int B, int H, int KVH, int Sq, int Skv, int D,
                             float sm_scale, int causal, int window, void* stream) {
  if (D == 64)
    return launch_dkv<64>(q, k, v, kv_lengths, dout, lse, di, dk, dv, B, H, KVH, Sq, Skv,
                          sm_scale, causal, window, stream);
  if (D == 128)
    return launch_dkv<128>(q, k, v, kv_lengths, dout, lse, di, dk, dv, B, H, KVH, Sq, Skv,
                           sm_scale, causal, window, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
