// Split-KV decode attention over the contiguous KV cache, one new token per
// row.
//
// Replaces the TPU kernel qlora_tpu/ops/decode_attention.py::
// fused_decode_attention (_kernel): masked online-softmax attention of each
// query head over its kv head's valid prefix plus the new token, then the new
// token's k/v written into the cache at position lengths[b], in place.  It
// takes the place of decode_attention.cu (one block per (row, kv head)),
// which stays as the "before".
//
// What bounds it on an H100: the bytes of the visible K/V, 2 * keys * hd * 2
// per (row, kv head), over 3.35 TB/s; the arithmetic (4 * G * keys * hd
// operations) is far under the card's rate.  At serving lengths the whole
// call moves a few MB, so latency and parallelism set its time, not the
// stream alone.
//
// Design:
// - Split each (row b, kv head h)'s visible keys [lo, hi) = [max(0, len -
//   window + 1), min(len, T)) across `splits` CTAs of `keys` keys each, from
//   the row's first visible key.  The plan (ops/decode_attention.py:
//   decode_attention_plan) depends on T, the heads and the window, never on
//   B or the lengths.  A CTA takes up to 16 query heads of the kv head's
//   group (a second CTA row takes G > 16).  A split with no visible key
//   contributes (m = MASK, l = 0, acc = 0).
// - Keys and values stream into a ring of STAGES shared-memory stages of 64
//   keys by cp.async.bulk, one copy per key row (each (row, kv head) slab is
//   contiguous), completing on an mbarrier per stage; rows are padded by 16
//   bytes so that ldmatrix reads them without bank conflicts.  While one
//   chunk is scored the next ones load.
// - Scores on mma.sync m16n8k16 (bf16 in, f32 out): the 16 query heads are
//   the A operand, each warp's 16 keys of a chunk the B operand, so no key
//   costs a shuffle reduction.  The f32 scores become an online softmax in
//   the accumulator registers (running max and sum per row, exp by expf,
//   masked logits MASK = -0.7 * f32 max), and the probabilities, rounded to
//   bf16, are the A operand of P.V in place (V through ldmatrix.trans).
// - Each warp keeps its own (m, l, acc); the warps merge in warp order in
//   shared memory and the CTA writes its partial for its real query heads
//   to an f32 workspace [B * KVH, splits, G] (m, l, acc[hd]).  A CTA whose
//   split holds no visible key exits at once and writes nothing.
// - A second launch, one CTA per (row, kv head, 16 query heads), merges the
//   splits in split order -- only those that hold keys, which it counts from
//   the row's length as the first launch does -- then the new token's score
//   and value from the inputs, with the den == 0 -> 1 guard.  No atomics:
//   two calls give the same bits, and a row's result does not depend on the
//   other rows.  The wrapper counts the two launches as one call.
// - The append comes last: the merging CTA writes the new k/v at lengths[b]
//   when lengths[b] < T, after every read of the first launch (no CTA reads
//   keys at or past lengths[b] anyway).  At or past the capacity nothing is
//   written.  Any T runs; head_dim 64, 128 and 256, G <= 32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int TK = 64;          // keys a chunk: 16 a warp
constexpr int WARPS = 4;
constexpr int ROWS = 16;        // query heads a CTA: the rows of one mma tile
constexpr int MAX_SPLITS = 16;  // CTAs a (row, kv head, 16 query heads)
constexpr float MASK = -0.7f * FLT_MAX;

template <int HD>
struct Cfg {
  static constexpr int PITCH = HD + 8;                 // bf16 elements a staged row
  static constexpr int STAGES = 2;                     // chunks in the ring
  static constexpr int KV_BYTES = TK * PITCH * 2;      // K (or V) of one chunk
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int RING = STAGES * STAGE_BYTES;
  static constexpr int WACC = WARPS * ROWS * HD * 4;   // the warps' sums, f32
  static constexpr int Q_BYTES = ROWS * PITCH * 2;
  static constexpr int STATS = 2 * WARPS * ROWS * 4;  // the warps' m and l
  static constexpr int SMEM = RING + Q_BYTES + STATS + 8 * STAGES;
  static_assert(WACC <= RING, "the warps' sums reuse the ring");
  static_assert(RING % 16 == 0 && Q_BYTES % 16 == 0 && STATS % 8 == 0, "alignment");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` contiguous bytes from global memory into this CTA's shared memory,
// completing on the mbarrier at `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the visible keys [lo, hi) of a row that holds `len` tokens, and how many
// of the plan's splits hold any: as ops/decode_attention.py computes them
__device__ __forceinline__ void row_keys(int len, int T, int window, int keys, int splits,
                                         int& lo, int& hi, int& used) {
  lo = window > 0 ? max(0, len - window + 1) : 0;
  hi = min(len, T);
  used = hi > lo ? min(splits, (hi - lo + keys - 1) / keys) : 0;
}

// the first launch: one split of a (row, kv head)'s keys for up to 16 query
// heads; writes the split's (m, l, acc) of each real query head to the
// workspace
template <int HD>
__global__ void __launch_bounds__(WARPS * 32)
decode_attn_split_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ kc,
                         const __nv_bfloat16* __restrict__ vc, const int* __restrict__ lengths,
                         float* __restrict__ ws, int KVH, int G, int T, float sm_scale,
                         int window, int keys) {
  using C = Cfg<HD>;
  const int split = blockIdx.x, splits = gridDim.x;
  const int b = blockIdx.y / KVH, h = blockIdx.y % KVH;
  int lo, hi, used;
  row_keys(__ldg(lengths + b), T, window, keys, splits, lo, hi, used);
  if (split >= used) return;  // no visible key: the merge skips this split
  const int k0 = lo + split * keys;
  const int k1 = min(k0 + keys, hi);
  const int nchunks = (k1 - k0 + TK - 1) / TK;

  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* ring = smem;                                         // [STAGES][K, V][TK][PITCH]
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + C::RING);   // [ROWS][PITCH]
  float* wm = reinterpret_cast<float*>(smem + C::RING + C::Q_BYTES);      // [WARPS][ROWS]
  float* wl = wm + WARPS * ROWS;                                          // [WARPS][ROWS]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::RING + C::Q_BYTES + C::STATS);

  const int tid = threadIdx.x;
  const int lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.z * ROWS;            // the CTA's first query head of the group
  const int rows = min(G - r0, ROWS);
  const size_t slab = ((size_t)b * KVH + h) * (size_t)T * HD;
  const size_t qrow = ((size_t)b * KVH + h) * G + r0;   // rows of q [B * H]

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) mbar_init(smem_u32(full + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // warp 0 loads chunk ch into its stage: one bulk copy per key row of K
  // and of V, all completing on the stage's barrier
  auto fetch = [&](int ch) {
    const int st = ch % C::STAGES;
    const int first = k0 + ch * TK;
    const int n = min(TK, k1 - first);
    uint8_t* ks = ring + st * C::STAGE_BYTES;
    uint8_t* vs = ks + C::KV_BYTES;
    const uint32_t bar = smem_u32(full + st);
    if (lane == 0) mbar_arrive_tx(bar, 2u * n * HD * 2);
    __syncwarp();
    for (int i = lane; i < n; i += 32) {
      bulk_copy(smem_u32(ks + i * C::PITCH * 2), kc + slab + (size_t)(first + i) * HD, HD * 2,
                bar);
      bulk_copy(smem_u32(vs + i * C::PITCH * 2), vc + slab + (size_t)(first + i) * HD, HD * 2,
                bar);
    }
  };
  if (w == 0)
    for (int ch = 0; ch < nchunks && ch < C::STAGES; ++ch) fetch(ch);

  // the CTA's query heads (zeros past G)
  for (int i = tid; i < ROWS * HD / 8; i += WARPS * 32) {
    const int r = i / (HD / 8), c8 = i % (HD / 8);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < rows) v = *reinterpret_cast<const uint4*>(q + (qrow + r) * HD + c8 * 8);
    *reinterpret_cast<uint4*>(qs + r * C::PITCH + c8 * 8) = v;
  }
  __syncthreads();

  // each warp's 16 keys of every chunk: (m, l, acc) of rows g and g + 8
  float m[2] = {MASK, MASK}, l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  const int kw = 16 * w;  // the warp's first key of a chunk
  for (int ch = 0; ch < nchunks; ++ch) {
    const int st = ch % C::STAGES;
    const int n = min(TK, k1 - (k0 + ch * TK));
    __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(ring + st * C::STAGE_BYTES);
    __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(ring + st * C::STAGE_BYTES +
                                                         C::KV_BYTES);
    mbar_wait(smem_u32(full + st), (ch / C::STAGES) & 1);
    if (kw < n) {
      if (kw + 16 > n) {  // value rows past the chunk: zeros (their p is 0)
        for (int i = lane; i < (kw + 16 - n) * (HD / 8); i += 32) {
          const int r = n + i / (HD / 8), c8 = i % (HD / 8);
          *reinterpret_cast<uint4*>(vs + r * C::PITCH + c8 * 8) = make_uint4(0, 0, 0, 0);
        }
        __syncwarp();
      }
      // s[j]: rows g, g + 8 by keys kw + 8j + 2t, + 1
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[4], bk[4];
        ldsm_x4(a, smem_u32(qs + (((lane >> 3) & 1) * 8 + (lane & 7)) * C::PITCH + 16 * kk +
                            (lane >> 4) * 8));
        ldsm_x4(bk, smem_u32(ks + (kw + (lane >> 4) * 8 + (lane & 7)) * C::PITCH + 16 * kk +
                             ((lane >> 3) & 1) * 8));
        mma_bf16(s[0], a, bk[0], bk[1]);
        mma_bf16(s[1], a, bk[2], bk[3]);
      }
      float mx[2] = {MASK, MASK};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kw + 8 * j + 2 * t + (e & 1);
          s[j][e] = key < n ? s[j][e] * sm_scale : MASK;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float mn = fmaxf(m[i], mx[i]);
        alpha[i] = expf(m[i] - mn);
        m[i] = mn;
      }
      float ps[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - m[e >> 1]);
          ps[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + ps[i];
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        acc[i][0] *= alpha[0];
        acc[i][1] *= alpha[0];
        acc[i][2] *= alpha[1];
        acc[i][3] *= alpha[1];
      }
      // P (rows by the warp's 16 keys) as the A operand, rounded to bf16
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int dn = 0; dn < HD / 8; dn += 2) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, smem_u32(vs + (kw + ((lane >> 3) & 1) * 8 + (lane & 7)) * C::PITCH +
                                   8 * dn + (lane >> 4) * 8));
        mma_bf16(acc[dn], pa, bv[0], bv[1]);
        mma_bf16(acc[dn + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // the stage is consumed
    if (w == 0 && ch + C::STAGES < nchunks) fetch(ch + C::STAGES);
  }

  // the warps' (m, l, acc) merged in warp order into the split's partial;
  // the ring is free (the loop ended in a barrier)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  float* wacc = reinterpret_cast<float*>(ring);     // [WARPS][ROWS][HD]
  if (t == 0) {
    wm[w * ROWS + g] = m[0];
    wm[w * ROWS + g + 8] = m[1];
    wl[w * ROWS + g] = l[0];
    wl[w * ROWS + g + 8] = l[1];
  }
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    if (g < rows)
      *reinterpret_cast<float2*>(wacc + (w * ROWS + g) * HD + 8 * i + 2 * t) =
          make_float2(acc[i][0], acc[i][1]);
    if (g + 8 < rows)
      *reinterpret_cast<float2*>(wacc + (w * ROWS + g + 8) * HD + 8 * i + 2 * t) =
          make_float2(acc[i][2], acc[i][3]);
  }
  __syncthreads();
  // workspace [B * KVH][splits][G]: acc [.. HD] floats, then m and l
  const size_t part = ((size_t)blockIdx.y * splits + split) * G + r0;
  const size_t n_parts = (size_t)gridDim.y * splits * G;
  for (int i = tid; i < rows * (HD / 4); i += WARPS * 32) {
    const int r = i / (HD / 4), d = 4 * (i % (HD / 4));
    float mc = MASK;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) mc = fmaxf(mc, wm[k * ROWS + r]);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    float ls = 0.f;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) {
      const float sc = expf(wm[k * ROWS + r] - mc);
      const float4 v = *reinterpret_cast<const float4*>(wacc + (k * ROWS + r) * HD + d);
      a.x += v.x * sc;
      a.y += v.y * sc;
      a.z += v.z * sc;
      a.w += v.w * sc;
      ls += wl[k * ROWS + r] * sc;
    }
    *reinterpret_cast<float4*>(ws + (part + r) * HD + d) = a;
    if (d == 0) {
      ws[n_parts * HD + part + r] = mc;
      ws[n_parts * (HD + 1) + part + r] = ls;
    }
  }
}

// the second launch: for (row b, kv head h, up to 16 query heads) the splits
// that hold keys merged in split order, then the new token; then the append
template <int HD>
__global__ void __launch_bounds__(WARPS * 32)
decode_attn_merge_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ nk,
                         const __nv_bfloat16* __restrict__ nv, __nv_bfloat16* __restrict__ kc,
                         __nv_bfloat16* __restrict__ vc, const int* __restrict__ lengths,
                         const float* __restrict__ ws, __nv_bfloat16* __restrict__ out,
                         int KVH, int G, int T, float sm_scale, int window, int keys,
                         int splits) {
  __shared__ float snew[ROWS];
  const int tid = threadIdx.x;
  const int lane = tid & 31, w = tid >> 5;
  const int b = blockIdx.x / KVH, h = blockIdx.x % KVH;
  const int r0 = blockIdx.y * ROWS;
  const int rows = min(G - r0, ROWS);
  const int len = __ldg(lengths + b);
  int lo, hi, used;
  row_keys(len, T, window, keys, splits, lo, hi, used);
  const size_t qrow = ((size_t)b * KVH + h) * G + r0;   // rows of q and out [B * H]
  const size_t tok = ((size_t)b * KVH + h) * HD;
  const size_t part = (size_t)blockIdx.x * splits * G + r0;   // split sp: part + sp * G
  const size_t n_parts = (size_t)gridDim.x * splits * G;

  // the new token's score of each query head
  for (int r = w; r < rows; r += WARPS) {
    float p = 0.f;
    for (int d = lane; d < HD; d += 32)
      p = fmaf(__bfloat162float(q[(qrow + r) * HD + d]), __bfloat162float(nk[tok + d]), p);
    p = warp_sum(p);
    if (lane == 0) snew[r] = p * sm_scale;
  }
  __syncthreads();

  for (int e = tid; e < rows * (HD / 4); e += WARPS * 32) {
    const int r = e / (HD / 4), d = 4 * (e % (HD / 4));
    float ms[MAX_SPLITS];
    float M = MASK;
#pragma unroll
    for (int sp = 0; sp < MAX_SPLITS; ++sp) {
      ms[sp] = sp < used ? __ldg(ws + n_parts * HD + part + sp * G + r) : MASK;
      M = fmaxf(M, ms[sp]);
    }
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
    float L = 0.f;
#pragma unroll
    for (int sp = 0; sp < MAX_SPLITS; ++sp) {
      if (sp < used) {
        const float sc = expf(ms[sp] - M);
        const float4 v = __ldg(reinterpret_cast<const float4*>(ws + (part + sp * G + r) * HD + d));
        num.x += v.x * sc;
        num.y += v.y * sc;
        num.z += v.z * sc;
        num.w += v.w * sc;
        L += __ldg(ws + n_parts * (HD + 1) + part + sp * G + r) * sc;
      }
    }
    const float sn = snew[r];
    const float mf = fmaxf(M, sn);
    const float alpha = expf(M - mf);
    const float pn = expf(sn - mf);
    L = L * alpha + pn;
    const float den = L == 0.f ? 1.f : L;
    const uint2 nvw = *reinterpret_cast<const uint2*>(nv + tok + d);
    const float2 v01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&nvw.x));
    const float2 v23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&nvw.y));
    uint2 o;
    o.x = pack_bf16((num.x * alpha + pn * v01.x) / den, (num.y * alpha + pn * v01.y) / den);
    o.y = pack_bf16((num.z * alpha + pn * v23.x) / den, (num.w * alpha + pn * v23.y) / den);
    *reinterpret_cast<uint2*>(out + (qrow + r) * HD + d) = o;
  }

  // append in place; the first launch, which read the caches, is done
  if (blockIdx.y == 0 && len >= 0 && len < T) {
    const size_t at = (((size_t)b * KVH + h) * T + len) * HD;
    for (int i = tid; i < HD / 8; i += WARPS * 32) {
      reinterpret_cast<uint4*>(kc + at)[i] = reinterpret_cast<const uint4*>(nk + tok)[i];
      reinterpret_cast<uint4*>(vc + at)[i] = reinterpret_cast<const uint4*>(nv + tok)[i];
    }
  }
}

template <int HD>
int launch(const void* q, const void* nk, const void* nv, void* kc, void* vc,
           const void* lengths, void* ws, void* out, int B, int KVH, int G, int T,
           float sm_scale, int window, int keys, int splits, cudaStream_t stream) {
  using C = Cfg<HD>;
  auto split_kernel = decode_attn_split_kernel<HD>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int mtiles = (G + ROWS - 1) / ROWS;
  const auto* lens = static_cast<const int*>(lengths);
  split_kernel<<<dim3(splits, B * KVH, mtiles), WARPS * 32, C::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kc),
      static_cast<const __nv_bfloat16*>(vc), lens, static_cast<float*>(ws), KVH, G, T, sm_scale,
      window, keys);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_attn_merge_kernel<HD><<<dim3(B * KVH, mtiles), WARPS * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(nk),
      static_cast<const __nv_bfloat16*>(nv), static_cast<__nv_bfloat16*>(kc),
      static_cast<__nv_bfloat16*>(vc), lens, static_cast<const float*>(ws),
      static_cast<__nv_bfloat16*>(out), KVH, G, T, sm_scale, window, keys, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out bf16 [B, KVH*G, hd]; nk, nv bf16 [B, KVH, hd]; kc, vc bf16
// [B, KVH, T, hd] (updated in place), all at 16-byte addresses; lengths int32
// [B]; window <= 0: none; ws f32 workspace of B * KVH * splits * G * (hd + 2)
// floats.  The plan: `splits` (1 to 16) CTAs of `keys` keys (a multiple of
// 64) per (row, kv head, 16 query heads).  hd in {64, 128, 256}, G <= 32.
// Two launches on `stream`.  Returns the first failing launch's cudaError_t
// (cudaErrorInvalidValue for an unsupported shape or plan).
extern "C" int decode_attention_split(const void* q, const void* nk, const void* nv, void* kc,
                                      void* vc, const void* lengths, void* ws, void* out, int B,
                                      int KVH, int G, int T, int hd, float sm_scale, int window,
                                      int keys, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || KVH < 1 || T < 1 || G < 1 || G > 32 || splits < 1 || splits > MAX_SPLITS ||
      keys < TK || keys % TK)
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 64:
      return launch<64>(q, nk, nv, kc, vc, lengths, ws, out, B, KVH, G, T, sm_scale, window,
                        keys, splits, s);
    case 128:
      return launch<128>(q, nk, nv, kc, vc, lengths, ws, out, B, KVH, G, T, sm_scale, window,
                         keys, splits, s);
    case 256:
      return launch<256>(q, nk, nv, kc, vc, lengths, ws, out, B, KVH, G, T, sm_scale, window,
                         keys, splits, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
