// Split-KV attention of a chunk of C >= 1 query tokens per sequence over the
// shared paged KV pool, with the chunk's k/v rows appended in place: the
// speculative verify step (C >= 2) and the decode step (C = 1).
//
// Replaces the TPU kernels qlora_tpu/ops/paged_attention.py::
// fused_paged_chunk_attention (body _chunk_kernel, pallas_call at
// paged_attention.py:544) and ::fused_paged_decode_attention (pallas_call at
// paged_attention.py:277), the decode step being the chunk of one token.  It
// takes the place of both entries of paged_attention.cu (one block per
// (sequence, kv head), one warp shuffle-reduction per (key, row)), which stay
// as the "befores".  At C = 1 a CTA row holds the G query heads of one kv
// head (one row of 16 at G = 1, which costs nothing where the key stream sets
// the pace), and the merge launch appends the one new row at the clamped
// position, as the decode kernel did: inactive rows and evicted entries write
// to or point at page 0.
//
// The function: the pool is page-major, [n_pages, KVH, page, hd] bf16 per
// layer; tables[b] maps sequence b's logical pages to pool pages.  Query row
// c of sequence b sits at position lengths[b] + c and attends the pool keys
// 0..lengths[b]-1 (with a sliding window only those at positions
// > lengths[b] + c - window) and the chunk's own keys j <= c with c - j <
// window.  Masked logits are MASK = -0.7 * f32 max and get probability
// exactly 0; the pool probabilities are rounded to bf16 for P.V while the
// chunk's own terms stay f32; l == 0 divides by 1.  Then the C new rows land
// at tables[b][min(pos / page, pps - 1)], offset pos % page, in chunk order,
// so the later position wins where the clamp maps two positions to one slot.
//
// What bounds it on an H100: the bytes of the pool keys each sequence
// attends, 2 * keys * hd * 2 per (sequence, kv head), over 3.35 TB/s; the
// arithmetic (4 * C * G * keys * hd operations) is far under the card's rate.
//
// Design: decode_attention_split.cu read through the page table.
// - The C * G query rows of a (sequence, kv head), row r = c * G + g, are
//   cut into CTA rows of 16 (one mma tile; a second, third or fourth CTA row
//   where C * G > 16, each reading the keys again, from L2 mostly).
// - First launch: each (sequence, kv head, 16 rows)'s visible pool keys
//   [lo, hi) = [max(0, len - window + 1), min(len, pps * page)) -- the union
//   over the chunk's rows, row 0's being the widest -- are shared over
//   `splits` CTAs of `keys` keys each, from lo.  The plan
//   (ops/paged_attention.py: paged_chunk_plan) depends on the capacity, the
//   heads, C, hd and the window, never on B or the lengths.  Keys and values
//   stream into a ring of 64-key stages by cp.async.bulk, one copy per key
//   row, the row's address taken from the page table (one lookup a row), so
//   any page size runs and a chunk may span pages; pages past ceil(len /
//   page) and pages wholly behind the window (evicted entries point at page
//   0) are never read.  Scores and P.V on mma.sync m16n8k16 with the 16
//   query rows as the A operand.  Visibility differs per row (row c's window
//   edge is one key later than row c - 1's), so each (row, key) pair is
//   masked on its own: a masked pair's logit is MASK and its probability
//   exactly 0 (a select, not exp(MASK - m), which is 1 for a row with no
//   visible key yet).  Value rows past the split's end are zeroed in shared
//   memory (p = 0 times stale memory can be NaN).  Each split writes an f32
//   partial (m, l, acc) per row to a workspace; a split that holds no pool
//   key exits at once.
// - Second launch, one CTA per (sequence, kv head, 16 rows): the splits
//   that hold keys, counted from the length as the first launch counts them,
//   merged in split order; then the chunk's own keys and values from the
//   inputs (f32 probabilities), and the den == 0 -> 1 guard.  No atomics:
//   two calls give the same bits, and a row's result does not depend on the
//   other rows.
// - The append comes last, in the second launch (after every read of the
//   first on the same stream), by the CTA of each (sequence, kv head)'s first
//   rows, in chunk order, each 16-byte piece of a row by the same thread.
//   Blocks of different sequences share only page 0: inactive rows append
//   there and evicted entries point there, and no active sequence reads it.
// - head_dim 64, 128 and 256; C * G <= 64.
// - What sets the pace (python -m qlora_tpu_torch.ops.decode_sweep paged):
//   at full attention the stream of keys and values (no loads takes half the
//   time, no products nearly all of it); at a window of 256 the two
//   launches' fixed cost (no loads only 10 % faster), which is also why a CTA row
//   of 16 query rows reads the keys again for a second row rather than
//   holding 32 rows.  Other keys a split were slower at both.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int TK = 64;          // keys a chunk: 16 a warp
constexpr int WARPS = 4;
constexpr int ROWS = 16;        // query rows a CTA: the rows of one mma tile
constexpr int MAX_SPLITS = 16;  // CTAs a (sequence, kv head, 16 rows)
constexpr int MAX_ROWS = 64;    // C * G
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

// the visible pool keys [lo, hi) of a sequence that holds `len` tokens (the
// union over the chunk's rows), and how many of the plan's splits hold any:
// as ops/paged_attention.py computes them
__device__ __forceinline__ void row_keys(int len, int T, int window, int keys, int splits,
                                         int& lo, int& hi, int& used) {
  lo = window > 0 ? max(0, len - window + 1) : 0;
  hi = min(len, T);
  used = hi > lo ? min(splits, (hi - lo + keys - 1) / keys) : 0;
}

// q, out [B, C, KVH * G, HD]: the row of query row r = c * G + g of
// (sequence b, kv head h)
__device__ __forceinline__ size_t q_row(int b, int h, int r, int C, int KVH, int G) {
  return (((size_t)b * C + r / G) * KVH + h) * G + r % G;
}

// the first launch: one split of a (sequence, kv head)'s pool keys for up to
// 16 query rows; writes the split's (m, l, acc) of each real row to the
// workspace
template <int HD>
__global__ void __launch_bounds__(WARPS * 32)
paged_chunk_split_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ kp,
                         const __nv_bfloat16* __restrict__ vp, const int* __restrict__ lengths,
                         const int* __restrict__ tables, float* __restrict__ ws, int C, int KVH,
                         int G, int page, int pps, float sm_scale, int window, int keys) {
  using Cf = Cfg<HD>;
  const int split = blockIdx.x, splits = gridDim.x;
  const int b = blockIdx.y / KVH, h = blockIdx.y % KVH;
  const int len = __ldg(lengths + b);
  int lo, hi, used;
  row_keys(len, page * pps, window, keys, splits, lo, hi, used);
  if (split >= used) return;  // no visible pool key: the merge skips this split
  const int k0 = lo + split * keys;
  const int k1 = min(k0 + keys, hi);
  const int nchunks = (k1 - k0 + TK - 1) / TK;

  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* ring = smem;                                          // [STAGES][K, V][TK][PITCH]
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + Cf::RING);   // [ROWS][PITCH]
  float* wm = reinterpret_cast<float*>(smem + Cf::RING + Cf::Q_BYTES);     // [WARPS][ROWS]
  float* wl = wm + WARPS * ROWS;                                           // [WARPS][ROWS]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Cf::RING + Cf::Q_BYTES + Cf::STATS);

  const int tid = threadIdx.x;
  const int lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int R = C * G;
  const int r0 = blockIdx.z * ROWS;            // the CTA's first row of the (b, h) group
  const int rows = min(R - r0, ROWS);
  const int* tab = tables + (size_t)b * pps;

  if (tid == 0) {
    for (int s = 0; s < Cf::STAGES; ++s) mbar_init(smem_u32(full + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // warp 0 loads chunk ch into its stage: one bulk copy per key row of K
  // and of V, each from the pool page that holds it, all completing on the
  // stage's barrier
  auto fetch = [&](int ch) {
    const int st = ch % Cf::STAGES;
    const int first = k0 + ch * TK;
    const int n = min(TK, k1 - first);
    uint8_t* ks = ring + st * Cf::STAGE_BYTES;
    uint8_t* vs = ks + Cf::KV_BYTES;
    const uint32_t bar = smem_u32(full + st);
    if (lane == 0) mbar_arrive_tx(bar, 2u * n * HD * 2);
    __syncwarp();
    for (int i = lane; i < n; i += 32) {
      const int pos = first + i;
      const int pg = pos / page;
      const size_t src = (((size_t)__ldg(tab + pg) * KVH + h) * page + (pos - pg * page)) * HD;
      bulk_copy(smem_u32(ks + i * Cf::PITCH * 2), kp + src, HD * 2, bar);
      bulk_copy(smem_u32(vs + i * Cf::PITCH * 2), vp + src, HD * 2, bar);
    }
  };
  if (w == 0)
    for (int ch = 0; ch < nchunks && ch < Cf::STAGES; ++ch) fetch(ch);

  // the CTA's query rows (zeros past R)
  for (int i = tid; i < ROWS * HD / 8; i += WARPS * 32) {
    const int r = i / (HD / 8), c8 = i % (HD / 8);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < rows)
      v = *reinterpret_cast<const uint4*>(q + q_row(b, h, r0 + r, C, KVH, G) * HD + c8 * 8);
    *reinterpret_cast<uint4*>(qs + r * Cf::PITCH + c8 * 8) = v;
  }
  __syncthreads();

  // the first visible pool position of the thread's rows g and g + 8: row
  // c sees positions > len + c - window (rows past R see none)
  int first_vis[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + g + 8 * i;
    first_vis[i] = r >= R ? INT_MAX : window > 0 ? len + r / G - window + 1 : 0;
  }

  // each warp's 16 keys of every chunk: (m, l, acc) of rows g and g + 8
  float m[2] = {MASK, MASK}, l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  const int kw = 16 * w;  // the warp's first key of a chunk
  for (int ch = 0; ch < nchunks; ++ch) {
    const int st = ch % Cf::STAGES;
    const int first = k0 + ch * TK;
    const int n = min(TK, k1 - first);
    __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(ring + st * Cf::STAGE_BYTES);
    __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(ring + st * Cf::STAGE_BYTES +
                                                         Cf::KV_BYTES);
    mbar_wait(smem_u32(full + st), (ch / Cf::STAGES) & 1);
    if (kw < n) {
      if (kw + 16 > n) {  // value rows past the chunk: zeros (their p is 0)
        for (int i = lane; i < (kw + 16 - n) * (HD / 8); i += 32) {
          const int r = n + i / (HD / 8), c8 = i % (HD / 8);
          *reinterpret_cast<uint4*>(vs + r * Cf::PITCH + c8 * 8) = make_uint4(0, 0, 0, 0);
        }
        __syncwarp();
      }
      // s[j]: rows g, g + 8 by keys kw + 8j + 2t, + 1
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[4], bk[4];
        ldsm_x4(a, smem_u32(qs + (((lane >> 3) & 1) * 8 + (lane & 7)) * Cf::PITCH + 16 * kk +
                            (lane >> 4) * 8));
        ldsm_x4(bk, smem_u32(ks + (kw + (lane >> 4) * 8 + (lane & 7)) * Cf::PITCH + 16 * kk +
                             ((lane >> 3) & 1) * 8));
        mma_bf16(s[0], a, bk[0], bk[1]);
        mma_bf16(s[1], a, bk[2], bk[3]);
      }
      // each (row, key) pair masked on its own: inside the split and at or
      // after the row's first visible position
      bool vis[2][4];
      float mx[2] = {MASK, MASK};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kw + 8 * j + 2 * t + (e & 1);
          vis[j][e] = key < n && first + key >= first_vis[e >> 1];
          s[j][e] = vis[j][e] ? s[j][e] * sm_scale : MASK;
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
          s[j][e] = vis[j][e] ? expf(s[j][e] - m[e >> 1]) : 0.f;
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
        ldsm_x4_trans(bv, smem_u32(vs + (kw + ((lane >> 3) & 1) * 8 + (lane & 7)) * Cf::PITCH +
                                   8 * dn + (lane >> 4) * 8));
        mma_bf16(acc[dn], pa, bv[0], bv[1]);
        mma_bf16(acc[dn + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // the stage is consumed
    if (w == 0 && ch + Cf::STAGES < nchunks) fetch(ch + Cf::STAGES);
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
  // workspace [B * KVH][splits][R]: acc [.. HD] floats, then m and l
  const size_t part = ((size_t)blockIdx.y * splits + split) * R + r0;
  const size_t n_parts = (size_t)gridDim.y * splits * R;
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

// the second launch: for (sequence b, kv head h, up to 16 rows) the splits
// that hold keys merged in split order, then the chunk's own keys; then, by
// the CTA of the first rows, the append
template <int HD>
__global__ void __launch_bounds__(WARPS * 32)
paged_chunk_merge_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ nk,
                         const __nv_bfloat16* __restrict__ nv, __nv_bfloat16* __restrict__ kp,
                         __nv_bfloat16* __restrict__ vp, const int* __restrict__ lengths,
                         const int* __restrict__ tables, const float* __restrict__ ws,
                         __nv_bfloat16* __restrict__ out, int C, int KVH, int G, int page,
                         int pps, float sm_scale, int window, int keys, int splits) {
  __shared__ float pc[ROWS][MAX_ROWS];      // the chunk's scores, then probabilities
  __shared__ float scs[ROWS][MAX_SPLITS];   // each split's scale, exp(m_split - M)
  __shared__ float alpha_s[ROWS], den_s[ROWS];
  const int tid = threadIdx.x;
  const int lane = tid & 31, w = tid >> 5;
  const int b = blockIdx.x / KVH, h = blockIdx.x % KVH;
  const int R = C * G;
  const int r0 = blockIdx.y * ROWS;
  const int rows = min(R - r0, ROWS);
  const int len = __ldg(lengths + b);
  int lo, hi, used;
  row_keys(len, page * pps, window, keys, splits, lo, hi, used);
  auto tok = [&](int j) { return (((size_t)b * C + j) * KVH + h) * HD; };
  const size_t part = (size_t)blockIdx.x * splits * R + r0;   // split sp: part + sp * R
  const size_t n_parts = (size_t)gridDim.x * splits * R;

  // the chunk's own scores: row r (token c) sees tokens j <= c with c - j < window
  for (int i = w; i < rows * C; i += WARPS) {
    const int r = i / C, j = i % C;
    const int c = (r0 + r) / G;
    if (j > c || (window > 0 && c - j >= window)) continue;  // uniform across the warp
    const __nv_bfloat16* qr = q + q_row(b, h, r0 + r, C, KVH, G) * HD;
    float p = 0.f;
    for (int d = lane; d < HD; d += 32)
      p = fmaf(__bfloat162float(qr[d]), __bfloat162float(nk[tok(j) + d]), p);
    p = warp_sum(p);
    if (lane == 0) pc[r][j] = p * sm_scale;
  }
  __syncthreads();
  if (tid < rows) {
    const int r = tid;
    const int c = (r0 + r) / G;
    const int jlo = window > 0 ? max(0, c - window + 1) : 0;
    float M = MASK;
    for (int sp = 0; sp < used; ++sp) M = fmaxf(M, __ldg(ws + n_parts * HD + part + sp * R + r));
    float L = 0.f;
    for (int sp = 0; sp < used; ++sp) {
      const float sc = expf(__ldg(ws + n_parts * HD + part + sp * R + r) - M);
      scs[r][sp] = sc;
      L += __ldg(ws + n_parts * (HD + 1) + part + sp * R + r) * sc;
    }
    float mf = M;
    for (int j = jlo; j <= c; ++j) mf = fmaxf(mf, pc[r][j]);
    const float alpha = expf(M - mf);
    L *= alpha;
    for (int j = 0; j <= c; ++j) {
      const float p = j >= jlo ? expf(pc[r][j] - mf) : 0.f;
      pc[r][j] = p;
      L += p;
    }
    alpha_s[r] = alpha;
    den_s[r] = L == 0.f ? 1.f : L;
  }
  __syncthreads();

  for (int e = tid; e < rows * (HD / 4); e += WARPS * 32) {
    const int r = e / (HD / 4), d = 4 * (e % (HD / 4));
    const int c = (r0 + r) / G;
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp = 0; sp < used; ++sp) {
      const float sc = scs[r][sp];
      const float4 v = __ldg(reinterpret_cast<const float4*>(ws + (part + sp * R + r) * HD + d));
      num.x += v.x * sc;
      num.y += v.y * sc;
      num.z += v.z * sc;
      num.w += v.w * sc;
    }
    const float alpha = alpha_s[r];
    float o[4] = {num.x * alpha, num.y * alpha, num.z * alpha, num.w * alpha};
    for (int j = 0; j <= c; ++j) {
      const float p = pc[r][j];
      const uint2 vw = *reinterpret_cast<const uint2*>(nv + tok(j) + d);
      const float2 v01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&vw.x));
      const float2 v23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&vw.y));
      o[0] = fmaf(p, v01.x, o[0]);
      o[1] = fmaf(p, v01.y, o[1]);
      o[2] = fmaf(p, v23.x, o[2]);
      o[3] = fmaf(p, v23.y, o[3]);
    }
    const float den = den_s[r];
    uint2 res;
    res.x = pack_bf16(o[0] / den, o[1] / den);
    res.y = pack_bf16(o[2] / den, o[3] / den);
    *reinterpret_cast<uint2*>(out + q_row(b, h, r0 + r, C, KVH, G) * HD + d) = res;
  }

  // append in place, in chunk order; the first launch, which read the pool,
  // is done
  if (blockIdx.y == 0) {
    const int* tab = tables + (size_t)b * pps;
    for (int j = 0; j < C; ++j) {
      const int pos = len + j;
      const int pg = min(pos / page, pps - 1);
      const size_t at = (((size_t)__ldg(tab + pg) * KVH + h) * page + pos % page) * HD;
      for (int i = tid; i < HD / 8; i += WARPS * 32) {
        reinterpret_cast<uint4*>(kp + at)[i] = reinterpret_cast<const uint4*>(nk + tok(j))[i];
        reinterpret_cast<uint4*>(vp + at)[i] = reinterpret_cast<const uint4*>(nv + tok(j))[i];
      }
    }
  }
}

template <int HD>
int launch(const void* q, const void* nk, const void* nv, void* kp, void* vp,
           const void* lengths, const void* tables, void* ws, void* out, int B, int C, int KVH,
           int G, int page, int pps, float sm_scale, int window, int keys, int splits,
           cudaStream_t stream) {
  using Cf = Cfg<HD>;
  auto split_kernel = paged_chunk_split_kernel<HD>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cf::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int mtiles = (C * G + ROWS - 1) / ROWS;
  const auto* lens = static_cast<const int*>(lengths);
  const auto* tabs = static_cast<const int*>(tables);
  split_kernel<<<dim3(splits, B * KVH, mtiles), WARPS * 32, Cf::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kp),
      static_cast<const __nv_bfloat16*>(vp), lens, tabs, static_cast<float*>(ws), C, KVH, G,
      page, pps, sm_scale, window, keys);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_chunk_merge_kernel<HD><<<dim3(B * KVH, mtiles), WARPS * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(nk),
      static_cast<const __nv_bfloat16*>(nv), static_cast<__nv_bfloat16*>(kp),
      static_cast<__nv_bfloat16*>(vp), lens, tabs, static_cast<const float*>(ws),
      static_cast<__nv_bfloat16*>(out), C, KVH, G, page, pps, sm_scale, window, keys, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out bf16 [B, C, KVH*G, hd]; nk, nv bf16 [B, C, KVH, hd]; kp, vp bf16
// [n_pages, KVH, page, hd] (updated in place), all at 16-byte addresses;
// lengths int32 [B]; tables int32 [B, pps]; window <= 0: none; ws f32
// workspace of B * KVH * splits * C * G * (hd + 2) floats.  The plan:
// `splits` (1 to 16) CTAs of `keys` keys (a multiple of 64) per (sequence,
// kv head, 16 rows).  hd in {64, 128, 256}, 1 <= C, C * G <= 64.  Two
// launches on `stream`.  Returns the first failing launch's cudaError_t
// (cudaErrorInvalidValue for an unsupported shape or plan).
extern "C" int paged_chunk_attention_split(const void* q, const void* nk, const void* nv,
                                           void* kp, void* vp, const void* lengths,
                                           const void* tables, void* ws, void* out, int B, int C,
                                           int KVH, int G, int page, int pps, int hd,
                                           float sm_scale, int window, int keys, int splits,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || C < 1 || KVH < 1 || G < 1 || C * G > MAX_ROWS || page < 1 || pps < 1 ||
      splits < 1 || splits > MAX_SPLITS || keys < TK || keys % TK)
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 64:
      return launch<64>(q, nk, nv, kp, vp, lengths, tables, ws, out, B, C, KVH, G, page, pps,
                        sm_scale, window, keys, splits, s);
    case 128:
      return launch<128>(q, nk, nv, kp, vp, lengths, tables, ws, out, B, C, KVH, G, page, pps,
                         sm_scale, window, keys, splits, s);
    case 256:
      return launch<256>(q, nk, nv, kp, vp, lengths, tables, ws, out, B, C, KVH, G, page, pps,
                         sm_scale, window, keys, splits, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
