// Fused attention over the shared paged KV pool, with the new tokens
// appended in place: one token per sequence (decode) or a chunk of C tokens
// (the speculative verify step).
//
// Replaces the TPU kernels qlora_tpu/ops/paged_attention.py::
// fused_paged_decode_attention (_kernel) and fused_paged_chunk_attention
// (_chunk_kernel).  Both entries are "befores" now: the decode step and
// every chunk run paged_attention_split.cu, and this file's decode and chunk
// entries are reached only through ops/paged_attention.py:
// _paged_decode_before and _paged_chunk_before, for timing and as a second
// reference.  The pool is page-major, [n_pages, KVH, page, hd] bf16 per
// layer; tables[b] maps sequence b's logical pages to pool pages.  Query row
// c of a chunk sits at position lengths[b] + c and attends the pool keys
// 0..lengths[b]-1 (and, with a sliding window, only those with
// pos > lengths[b] + c - window) plus the chunk's own keys 0..c (those with
// c - j < window).  The decode step is the chunk with C = 1.  Then the C new
// k/v rows land at positions lengths[b]..lengths[b]+C-1, each in page
// tables[b][min(pos / page, pps - 1)] at offset pos % page.
//
// What bounds it on an H100: the bytes of the pool keys each sequence
// attends, 2 * keys * hd * 2 per (sequence, kv head), over 3.35 TB/s; the
// arithmetic is 4 * C * G * keys * hd operations, far under the card's rate.
//
// Design: the contiguous decode kernel (decode_attention.cu) with a page
// table.  One block per (sequence b, kv head h) handles the C * G query rows
// of that head (row r = c * G + g), loaded once into shared memory as f32.  It
// walks only the keys in [max(0, len - window + 1), min(len, pps * page)) in
// runs of at most 64 tokens that never cross a page, each run a contiguous
// slice of the (page, h) slab, staged into shared memory with 16-byte vector
// loads: it never reads a page past ceil(len / page), nor one wholly behind
// the window (evicted entries point at the reserved page 0).  One warp scores
// a key for every row (lane d holds elements d, d+32, ...; a shuffle reduction
// sums them); scores, running max and sum are f32; a key outside a row's
// window gets probability exactly 0; softmax is by exp from the running max
// (initial max MASK = -0.7 * f32 max); the probabilities are rounded to bf16
// for the value product, as the TPU kernel does.  The chunk's own keys and
// values are read from the inputs, their probabilities stay f32, and the
// den == 0 -> 1 guard closes.  The append comes last, after the block's
// reads, one token after the other in chunk order by the same threads, so
// that where the clamp maps two positions to one slot the later one stays.
// Blocks of different sequences share only page 0: inactive rows append
// there and evicted entries point there.  An active sequence's walked range
// holds only its own pages, so whatever races on page 0 reaches only the
// dropped outputs of inactive rows.  Any page size and table width run;
// head_dim 64, 128 and 256; C * G <= 64.  paged_attention_split.cu, which
// took both entries' place, splits each sequence's keys across blocks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int TC = 64;        // keys per run
constexpr int MAX_ROWS = 64;  // C * G query rows per block
constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr float MASK = -0.7f * FLT_MAX;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

size_t smem_bytes(int rows, int hd) {
  // ks, vs [TC][hd] bf16; qs, acc [rows][hd] f32; ps [rows][TC] f32; m, l, alpha
  return (size_t)2 * TC * hd * 2 + (size_t)2 * rows * hd * 4 + (size_t)rows * TC * 4 +
         (size_t)3 * MAX_ROWS * 4;
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS)
paged_attn_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ nk,
                  const __nv_bfloat16* __restrict__ nv, __nv_bfloat16* __restrict__ kp,
                  __nv_bfloat16* __restrict__ vp, const int* __restrict__ lengths,
                  const int* __restrict__ tables, __nv_bfloat16* __restrict__ out, int KVH,
                  int G, int C, int page, int pps, float sm_scale, int window) {
  constexpr int E = HD / 32;   // elements of a row each lane holds
  constexpr int V16 = HD / 8;  // 16-byte vectors per row
  const int R = C * G;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + TC * HD;
  float* qs = reinterpret_cast<float*>(vs + TC * HD);
  float* acc = qs + R * HD;
  float* ps = acc + R * HD;
  float* m_s = ps + R * TC;
  float* l_s = m_s + MAX_ROWS;
  float* a_s = l_s + MAX_ROWS;

  const int b = blockIdx.x / KVH;
  const int h = blockIdx.x % KVH;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int len = lengths[b];
  const int* tab = tables + (size_t)b * pps;
  // q, out [B, C, KVH * G, HD]; nk, nv [B, C, KVH, HD]
  auto row_off = [&](int r) {
    return ((((size_t)b * C + r / G) * KVH + h) * G + r % G) * HD;
  };
  auto tok_off = [&](int j) { return (((size_t)b * C + j) * KVH + h) * HD; };

  for (int i = tid; i < R * HD; i += NTHREADS) {
    qs[i] = __bfloat162float(q[row_off(i / HD) + i % HD]);
    acc[i] = 0.f;
  }
  if (tid < R) {
    m_s[tid] = MASK;
    l_s[tid] = 0.f;
  }

  const int lo = window > 0 ? max(0, len - window + 1) : 0;
  const int hi = min(len, page * pps);
  for (int c0 = lo; c0 < hi;) {
    const int pg = c0 / page;
    const int off = c0 - pg * page;
    const int n = min(min(TC, hi - c0), page - off);
    const size_t src = (((size_t)tab[pg] * KVH + h) * page + off) * HD;
    __syncthreads();  // previous run consumed; q and stats initialised
    const uint4* ksrc = reinterpret_cast<const uint4*>(kp + src);
    const uint4* vsrc = reinterpret_cast<const uint4*>(vp + src);
    uint4* kdst = reinterpret_cast<uint4*>(ks);
    uint4* vdst = reinterpret_cast<uint4*>(vs);
    for (int i = tid; i < n * V16; i += NTHREADS) {
      kdst[i] = ksrc[i];
      vdst[i] = vsrc[i];
    }
    __syncthreads();
    for (int t = warp; t < n; t += NWARPS) {
      float kr[E];
#pragma unroll
      for (int e = 0; e < E; ++e) kr[e] = __bfloat162float(ks[t * HD + lane + 32 * e]);
      for (int r = 0; r < R; ++r) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) part = fmaf(qs[r * HD + lane + 32 * e], kr[e], part);
        part = warp_sum(part);
        if (lane == 0) ps[r * TC + t] = part * sm_scale;
      }
    }
    __syncthreads();
    for (int r = warp; r < R; r += NWARPS) {
      // row r's query sits at len + r / G: it keeps keys with pos > len + c - window
      const int first = window > 0 ? len + r / G - window + 1 - c0 : 0;
      float mx = MASK;
      for (int t = lane; t < n; t += 32)
        if (t >= first) mx = fmaxf(mx, ps[r * TC + t]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float p = t >= first ? expf(ps[r * TC + t] - m_new) : 0.f;
        ps[r * TC + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        a_s[r] = alpha;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < R * HD; i += NTHREADS) {
      const int r = i / HD;
      const int d = i % HD;
      float pv = 0.f;
      for (int t = 0; t < n; ++t)
        pv = fmaf(__bfloat162float(__float2bfloat16(ps[r * TC + t])),
                  __bfloat162float(vs[t * HD + d]), pv);
      acc[i] = acc[i] * a_s[r] + pv;
    }
    c0 += n;
  }
  __syncthreads();

  // the chunk's own keys: row r (chunk index c) sees tokens j <= c inside the window
  for (int w = warp; w < R * C; w += NWARPS) {
    const int r = w / C;
    const int j = w % C;
    const int c = r / G;
    if (j > c || (window > 0 && c - j >= window)) continue;  // uniform across the warp
    const __nv_bfloat16* kj = nk + tok_off(j);
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e)
      part = fmaf(qs[r * HD + lane + 32 * e], __bfloat162float(kj[lane + 32 * e]), part);
    part = warp_sum(part);
    if (lane == 0) ps[r * TC + j] = part * sm_scale;
  }
  __syncthreads();
  for (int r = warp; r < R; r += NWARPS) {
    const int c = r / G;
    const int first = window > 0 ? max(0, c - window + 1) : 0;
    float mx = MASK;
    for (int j = first + lane; j <= c; j += 32) mx = fmaxf(mx, ps[r * TC + j]);
    mx = warp_max(mx);
    const float m_prev = m_s[r];
    const float m_f = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int j = lane; j <= c; j += 32) {
      const float p = j >= first ? expf(ps[r * TC + j] - m_f) : 0.f;
      ps[r * TC + j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float alpha = expf(m_prev - m_f);
      l_s[r] = l_s[r] * alpha + sum;
      a_s[r] = alpha;
    }
  }
  __syncthreads();
  for (int i = tid; i < R * HD; i += NTHREADS) {
    const int r = i / HD;
    const int d = i % HD;
    const int c = r / G;
    float num = acc[i] * a_s[r];
    for (int j = 0; j <= c; ++j)
      num = fmaf(ps[r * TC + j], __bfloat162float(nv[tok_off(j) + d]), num);
    const float l = l_s[r];
    out[row_off(r) + d] = __float2bfloat16(num / (l == 0.f ? 1.f : l));
  }

  // append in place, after every read of the pool above
  for (int j = 0; j < C; ++j) {
    const int pos = len + j;
    const int pg = min(pos / page, pps - 1);
    const size_t dst = (((size_t)tab[pg] * KVH + h) * page + pos % page) * HD;
    const size_t src = tok_off(j);
    for (int d = tid; d < HD; d += NTHREADS) {
      kp[dst + d] = nk[src + d];
      vp[dst + d] = nv[src + d];
    }
  }
}

template <int HD>
int launch(const void* q, const void* nk, const void* nv, void* kp, void* vp,
           const void* lengths, const void* tables, void* out, int B, int C, int KVH, int G,
           int page, int pps, float sm_scale, int window, cudaStream_t stream) {
  const size_t smem = smem_bytes(C * G, HD);
  auto kern = paged_attn_kernel<HD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<B * KVH, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(nk),
      static_cast<const __nv_bfloat16*>(nv), static_cast<__nv_bfloat16*>(kp),
      static_cast<__nv_bfloat16*>(vp), static_cast<const int*>(lengths),
      static_cast<const int*>(tables), static_cast<__nv_bfloat16*>(out), KVH, G, C, page, pps,
      sm_scale, window);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* nk, const void* nv, void* kp, void* vp,
             const void* lengths, const void* tables, void* out, int B, int C, int KVH, int G,
             int page, int pps, int hd, float sm_scale, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || C < 1 || G < 1 || C * G > MAX_ROWS || page < 1 || pps < 1)
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 64:
      return launch<64>(q, nk, nv, kp, vp, lengths, tables, out, B, C, KVH, G, page, pps,
                        sm_scale, window, s);
    case 128:
      return launch<128>(q, nk, nv, kp, vp, lengths, tables, out, B, C, KVH, G, page, pps,
                         sm_scale, window, s);
    case 256:
      return launch<256>(q, nk, nv, kp, vp, lengths, tables, out, B, C, KVH, G, page, pps,
                         sm_scale, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out bf16 [B, KVH*G, hd]; nk, nv bf16 [B, KVH, hd]; kp, vp bf16
// [n_pages, KVH, page, hd] (updated in place); lengths int32 [B]; tables int32
// [B, pps]; window <= 0: none.  hd in {64, 128, 256}, G <= 64.  Returns the
// launch's cudaError_t (cudaErrorInvalidValue for an unsupported shape).
extern "C" int paged_decode_attention(const void* q, const void* nk, const void* nv, void* kp,
                                      void* vp, const void* lengths, const void* tables,
                                      void* out, int B, int KVH, int G, int page, int pps, int hd,
                                      float sm_scale, int window, void* stream) {
  return dispatch(q, nk, nv, kp, vp, lengths, tables, out, B, 1, KVH, G, page, pps, hd,
                  sm_scale, window, stream);
}

// The verify chunk: q, out bf16 [B, C, KVH*G, hd]; nk, nv bf16 [B, C, KVH, hd];
// the rest as paged_decode_attention.  C * G <= 64.
extern "C" int paged_chunk_attention(const void* q, const void* nk, const void* nv, void* kp,
                                     void* vp, const void* lengths, const void* tables,
                                     void* out, int B, int C, int KVH, int G, int page, int pps,
                                     int hd, float sm_scale, int window, void* stream) {
  return dispatch(q, nk, nv, kp, vp, lengths, tables, out, B, C, KVH, G, page, pps, hd,
                  sm_scale, window, stream);
}
