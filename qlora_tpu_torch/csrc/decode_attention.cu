// Fused decode attention over the contiguous KV cache, one new token per row:
// the "before" of decode_attention_split.cu, which the port runs.  This
// kernel is reached only through ops/decode_attention.py:
// _decode_attention_before, which chip_smoke.py times beside the split
// kernel and the tests hold against the plain version.
//
// Replaces the TPU kernel qlora_tpu/ops/decode_attention.py::
// fused_decode_attention (_kernel): masked online-softmax attention of each
// query head over its kv head's valid prefix plus the new token, then the new
// token's k/v written into the cache at position lengths[b], in place.
//
// What bounds it on an H100: the bytes of the valid K/V prefix,
// 2 * len * hd * 2 per (row, kv head), over 3.35 TB/s; the arithmetic is
// 4 * G * len * hd operations, far under the card's rate.
//
// Design: one block per (row b, kv head h) stream, which owns the contiguous
// [T, hd] slab of each cache.  The block loads its G query rows once, then
// walks only the keys in [max(0, len - window + 1), min(len, T)) in chunks of
// 64 tokens, staged into shared memory with 16-byte vector loads, so it reads
// about `len` tokens and never the whole capacity.  One warp scores a key
// for all G query rows (lane d holds elements d, d+32, ...; a shuffle
// reduction sums them), scores and the running max/sum are f32, softmax is
// by exp from the running max (initial max MASK = -0.7 * f32 max), and the
// probabilities are rounded to bf16 for the value product, as the TPU kernel
// does.  The new token's score and value merge analytically from the inputs,
// with the den == 0 -> 1 guard.  Then the new k/v land at lengths[b] when
// lengths[b] < T; at or past the capacity nothing is written, as the TPU
// kernel behaves.  Any T runs; head_dim 64, 128 and 256, and G <= 32.  What
// held it back (one CTA per (row, kv head), the longest row's chunks walked
// one after another with synchronous loads, a shuffle reduction per (key,
// query row)) is what decode_attention_split.cu was designed against.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int TC = 64;  // keys per chunk
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

size_t smem_bytes(int G, int hd) {
  // qs, acc [G][hd] f32; ks, vs [TC][hd] bf16; ps [G][TC] f32; m, l, alpha [G]
  return (size_t)2 * G * hd * 4 + (size_t)2 * TC * hd * 2 + (size_t)G * TC * 4 +
         (size_t)3 * 32 * 4;
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS)
decode_attn_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ nk,
                   const __nv_bfloat16* __restrict__ nv, __nv_bfloat16* __restrict__ kc,
                   __nv_bfloat16* __restrict__ vc, const int* __restrict__ lengths,
                   __nv_bfloat16* __restrict__ out, int KVH, int G, int T, float sm_scale,
                   int window) {
  constexpr int E = HD / 32;  // elements of a row each lane holds
  constexpr int V16 = HD / 8; // 16-byte vectors per row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + TC * HD;
  float* qs = reinterpret_cast<float*>(vs + TC * HD);
  float* acc = qs + G * HD;
  float* ps = acc + G * HD;
  float* m_s = ps + G * TC;
  float* l_s = m_s + 32;
  float* a_s = l_s + 32;

  const int b = blockIdx.x / KVH;
  const int h = blockIdx.x % KVH;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int len = lengths[b];
  const size_t slab = ((size_t)b * KVH + h) * (size_t)T * HD;
  const size_t qoff = ((size_t)b * KVH + h) * (size_t)G * HD;  // heads h*G .. h*G+G-1
  const size_t toff = ((size_t)b * KVH + h) * HD;

  for (int i = tid; i < G * HD; i += NTHREADS) {
    qs[i] = __bfloat162float(q[qoff + i]);
    acc[i] = 0.f;
  }
  if (tid < G) {
    m_s[tid] = MASK;
    l_s[tid] = 0.f;
  }

  const int lo = window > 0 ? max(0, len - window + 1) : 0;
  const int hi = min(len, T);
  for (int c0 = lo; c0 < hi; c0 += TC) {
    const int n = min(TC, hi - c0);
    __syncthreads();  // previous chunk consumed; q and stats initialised
    const uint4* ksrc = reinterpret_cast<const uint4*>(kc + slab + (size_t)c0 * HD);
    const uint4* vsrc = reinterpret_cast<const uint4*>(vc + slab + (size_t)c0 * HD);
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
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) part = fmaf(qs[g * HD + lane + 32 * e], kr[e], part);
        part = warp_sum(part);
        if (lane == 0) ps[g * TC + t] = part * sm_scale;
      }
    }
    __syncthreads();
    for (int g = warp; g < G; g += NWARPS) {
      float mx = MASK;
      for (int t = lane; t < n; t += 32) mx = fmaxf(mx, ps[g * TC + t]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float p = expf(ps[g * TC + t] - m_new);
        ps[g * TC + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[g] = l_s[g] * alpha + sum;
        a_s[g] = alpha;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < G * HD; i += NTHREADS) {
      const int g = i / HD;
      const int d = i % HD;
      float pv = 0.f;
      for (int t = 0; t < n; ++t)
        pv = fmaf(__bfloat162float(__float2bfloat16(ps[g * TC + t])),
                  __bfloat162float(vs[t * HD + d]), pv);
      acc[i] = acc[i] * a_s[g] + pv;
    }
  }
  __syncthreads();

  // merge the new token from the inputs, normalise, emit
  for (int g = warp; g < G; g += NWARPS) {
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e)
      part = fmaf(qs[g * HD + lane + 32 * e], __bfloat162float(nk[toff + lane + 32 * e]), part);
    part = warp_sum(part);
    if (lane == 0) {
      const float s_new = part * sm_scale;
      const float m_prev = m_s[g];
      const float m_f = fmaxf(m_prev, s_new);
      const float alpha = expf(m_prev - m_f);
      const float p_new = expf(s_new - m_f);
      m_s[g] = p_new;              // reused: the new token's weight
      a_s[g] = alpha;
      l_s[g] = l_s[g] * alpha + p_new;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * HD; i += NTHREADS) {
    const int g = i / HD;
    const int d = i % HD;
    const float num = acc[i] * a_s[g] + m_s[g] * __bfloat162float(nv[toff + d]);
    const float l = l_s[g];
    const float den = l == 0.f ? 1.f : l;
    out[qoff + i] = __float2bfloat16(num / den);
  }

  // append in place; the block read only keys below len, so no hazard
  if (len >= 0 && len < T) {
    for (int d = tid; d < HD; d += NTHREADS) {
      kc[slab + (size_t)len * HD + d] = nk[toff + d];
      vc[slab + (size_t)len * HD + d] = nv[toff + d];
    }
  }
}

template <int HD>
int launch(const void* q, const void* nk, const void* nv, void* kc, void* vc,
           const void* lengths, void* out, int B, int KVH, int G, int T, float sm_scale,
           int window, cudaStream_t stream) {
  const size_t smem = smem_bytes(G, HD);
  auto kern = decode_attn_kernel<HD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<B * KVH, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(nk),
      static_cast<const __nv_bfloat16*>(nv), static_cast<__nv_bfloat16*>(kc),
      static_cast<__nv_bfloat16*>(vc), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), KVH, G, T, sm_scale, window);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out bf16 [B, KVH*G, hd]; nk, nv bf16 [B, KVH, hd]; kc, vc bf16
// [B, KVH, T, hd] (updated in place); lengths int32 [B]; window <= 0: none.
// hd in {64, 128, 256}, G <= 32.  Returns the launch's cudaError_t
// (cudaErrorInvalidValue for an unsupported head_dim).
extern "C" int decode_attention(const void* q, const void* nk, const void* nv, void* kc,
                                void* vc, const void* lengths, void* out, int B, int KVH,
                                int G, int T, int hd, float sm_scale, int window,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > 32) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 64: return launch<64>(q, nk, nv, kc, vc, lengths, out, B, KVH, G, T, sm_scale, window, s);
    case 128: return launch<128>(q, nk, nv, kc, vc, lengths, out, B, KVH, G, T, sm_scale, window, s);
    case 256: return launch<256>(q, nk, nv, kc, vc, lengths, out, B, KVH, G, T, sm_scale, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
