// Fused NF4/FP4 dequantize + matmul for prefill and training rows:
// y[M, N] = x[M, K] @ dequant(W)[K, N] with M > 16, on Hopper's wgmma.
//
// Replaces the TPU kernels qlora_tpu/ops/qmatmul.py::_qmm_pallas_dq (int8
// double-quantized absmax, pallas_call at qmatmul.py:616) and ::_qmm_pallas
// (f32 absmax, pallas_call at :559) at more than 16 rows; fewer rows run the
// split-K kernel of qmm_nf4_decode.cu.  One template, <bool DQ>, serves both
// variants.  The dispatch (ops/qmatmul.py: tile_plan) sends every shape with
// K % 16 == 0 here (TMA needs x's row stride, and the start of the high
// plane's boxes at column K/2, in multiples of 16 bytes); other shapes stay
// on the tile kernel of qmm_nf4_fwd.cu.
//
// Storage (qlora_tpu_torch/quant/blockwise.py): packed u8 [K/2, N], N
// contiguous; packed row r holds logical row r in its low nibble and row
// K/2 + r in its high one; absmax [K/B, N] f32, or int8 with meta-scales f32
// [ceil((K/B)/256), N] and one f32 offset (absmax = q * (scale * (1/127)) +
// offset, one fused multiply-add, as dequantize computes it).
//
// What bounds it on an H100: the bf16 tensor-core rate, 2*M*K*N operations
// (M = 1024: 0.035 ms at 4096 x 4096), not the bytes.  The TPU kernel takes
// row tiles of up to 1024 to amortize the decode of each weight tile over
// many rows; here the decode runs in producer warpgroups beside the
// products, once per weight tile for 128 or 256 rows.
//
// Design (one CTA per 128 x 128 or 256 x 128 output tile, 512 threads, no
// split-K; the plan picks 256 rows where 128-row tiles would need more than
// one wave of CTAs):
// - A k-step is TKP = 64 packed rows: 64 logical rows in each nibble plane,
//   four m64n128k16 wgmmas per plane and consumer warpgroup.
// - x: two TMA boxes [rows, 64 columns] per k-step, at column kp (low
//   plane) and K/2 + kp (high plane), 128-byte swizzle (the K-major layout
//   wgmma reads), arrival on the stage's full mbarrier with expect-tx.  TMA
//   zero-fills rows past M and columns past K; the low box may run past K/2
//   into real high-half values, so the weight rows past K/2 decode as zeros.
// - Weight: two producer warpgroups take alternate k-steps, so one's waits
//   and fences overlap the other's decode.  A producer thread owns 8 columns
//   of 8 packed rows of its k-step; the bytes arrive in its own slot of a
//   staging ring through 8-byte cp.async issued a k-step of its own ahead
//   (byte loads where N % 8 != 0).  It decodes both planes (the 16-entry
//   codebook in shared memory, looked up at byte offsets taken out with one
//   prmt each; __fmul_rn(code, absmax) rounded to bf16, exactly as
//   dequantize) and stores bf16 B tiles in the MN-major 128-byte-swizzled
//   layout that wgmma reads with the transpose bit: n in two 64-column
//   halves, 128-byte rows of k, so each store is one 16-byte chunk of a row
//   and a quarter-warp fills a row without bank conflicts.  It fences
//   (fence.proxy.async) before it arrives on the full barrier, so the async
//   proxy sees the generic stores.
// - The absmax of a thread's 8 columns is loaded (16-byte loads) a k-step
//   ahead and decoded once per k-step and plane, q * (scale / 127) + offset
//   with one __fmaf_rn in the DQ variant; its block row advances by
//   comparison, no division.  Block sizes that are no multiple of 8 take
//   each element's own absmax (ALIGNED = false, a slow path for odd shapes).
// - Two consumer warpgroups own 64 MT rows each (MT = 1 or 2 m64 tiles),
//   wait on the full barrier, run the k-step's 8 MT wgmmas into f32
//   registers, wait for them and release the stage on its empty barrier.  A
//   ring of 3 (MT = 1) or 2 (MT = 2) k-steps in dynamic shared memory, 226 KB
//   with the staging ring.
// - Sums run over K in one fixed order per output element: deterministic,
//   and a row's result does not depend on the other rows.
// - Epilogue: round to bf16 once, stage the tile in shared memory (the ring,
//   free by then), store rows with 16-byte stores, masked at the M and N
//   edges.
// - Registers: at MT = 2 a consumer thread holds 128 accumulators, so
//   setmaxnreg moves registers from the producers (down to 88) to the
//   consumers (up to 168); at MT = 1 the 128 that 512 threads get each do.
// - What sets the pace (python -m qlora_tpu_torch.ops.tile_sweep): the
//   producers' decode; the products alone run near cuBLAS's time.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int TN = 128;                    // columns of a CTA
constexpr int TKP = 64;                    // packed rows of a k-step (64 logical rows a plane)
constexpr int THREADS = 512;               // warpgroups 0, 1 multiply; 2, 3 decode
constexpr int ROWS = TKP * TN / 8 / 128;   // packed rows of a k-step per producer thread
constexpr int B_BYTES = TKP * TN * 2;      // one plane's decoded weight, 16 KB
constexpr int W_STAGE_BYTES = TKP * TN;    // a k-step's packed bytes, staged for a producer
constexpr int C_PITCH = TN + 8;            // bf16 row pitch of the staged output tile

// A CTA's rows: MT m64 tiles per consumer warpgroup, 128 MT rows, so a
// decoded weight tile serves 128 or 256 rows.  The ring holds as many
// k-steps as fit beside the producers' staging ring.
template <int MT>
struct Tile {
  static constexpr int TM = 128 * MT;
  static constexpr int A_BYTES = TM * TKP * 2;  // one plane's x box
  static constexpr int STAGE_BYTES = 2 * A_BYTES + 2 * B_BYTES;
  static constexpr int STAGES = MT == 1 ? 3 : 2;
  // alignment, the ring, the producers' staging ring, barriers
  static constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 4 * W_STAGE_BYTES + 1024;
  static_assert(TM * C_PITCH * 2 <= STAGES * STAGE_BYTES, "the output tile reuses the ring");
  static_assert(SMEM_BYTES + 64 <= 232448, "227 KB a block");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}" ::"r"(bar)
               : "memory");
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

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(bar)
      : "memory");
}

// a wgmma shared-memory descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// d[64] += A (64 x 16, K-major, x) * B (16 x 128, MN-major, the decoded weight), bf16 in, f32
// accumulators; the transpose bit of B is set (imm-trans-b = 1)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
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

// the absmax of 8 columns [n, n + 8) in absmax row blk, one by one (0 past N)
template <bool DQ>
__device__ __forceinline__ void absmax8(float (&am)[8], const void* absmax, const float* scale,
                                        float off, int blk, int n, int N) {
#pragma unroll
  for (int e = 0; e < 8; ++e)
    am[e] = n + e < N ? absmax_at<DQ>(absmax, scale, off, blk, n + e, N) : 0.f;
}

// the next k-step's absmax of 8 columns in both planes, as loaded with
// 8- and 16-byte loads (N % 8 == 0): int8 codes and meta-scales (DQ), or f32
struct AbsRaw {
  uint2 q[2];
  float4 v[2][2];
};

template <bool DQ>
__device__ __forceinline__ void raw_load(AbsRaw& raw, const void* absmax, const float* scale,
                                         int blk_lo, int blk_hi, int n, int N) {
  if (n >= N) {  // columns past N: absmax 0, so their weights decode to 0
    raw.q[0] = raw.q[1] = make_uint2(0, 0);
    raw.v[0][0] = raw.v[0][1] = raw.v[1][0] = raw.v[1][1] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const int blk[2] = {blk_lo, blk_hi};
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const float* v;
    if (DQ) {
      raw.q[p] = __ldg(reinterpret_cast<const uint2*>(static_cast<const int8_t*>(absmax) +
                                                      (size_t)blk[p] * N + n));
      v = scale + (size_t)(blk[p] / 256) * N + n;
    } else {
      v = static_cast<const float*>(absmax) + (size_t)blk[p] * N + n;
    }
    raw.v[p][0] = __ldg(reinterpret_cast<const float4*>(v));
    raw.v[p][1] = __ldg(reinterpret_cast<const float4*>(v) + 1);
  }
}

template <bool DQ>
__device__ __forceinline__ void raw_decode(float (&am_lo)[8], float (&am_hi)[8],
                                           const AbsRaw& raw, float off) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    float* am = p ? am_hi : am_lo;
    const float v[8] = {raw.v[p][0].x, raw.v[p][0].y, raw.v[p][0].z, raw.v[p][0].w,
                        raw.v[p][1].x, raw.v[p][1].y, raw.v[p][1].z, raw.v[p][1].w};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (DQ) {
        const float qv = (float)(int8_t)((e < 4 ? raw.q[p].x : raw.q[p].y) >> (8 * (e & 3)));
        am[e] = __fmaf_rn(qv, __fmul_rn(v[e], 1.f / 127.f), off);
      } else {
        am[e] = v[e];
      }
    }
  }
}

// 4 * the nibble of each byte of a packed word, low plane or high plane: the
// byte offsets of the codes in the codebook, one prmt a byte to take out
__device__ __forceinline__ uint32_t offs_lo(uint32_t w) { return (w << 2) & 0x3C3C3C3Cu; }
__device__ __forceinline__ uint32_t offs_hi(uint32_t w) { return (w >> 2) & 0x3C3C3C3Cu; }
__device__ __forceinline__ uint32_t byte_at(uint32_t o, int e) {
  return __byte_perm(o, 0, 0x4440 | e);
}

__device__ __forceinline__ float code_at(const float* tab, uint32_t o) {
  return *reinterpret_cast<const float*>(reinterpret_cast<const char*>(tab) + o);
}

// two decoded weights, rounded to bf16 and paired (the first in the low half)
__device__ __forceinline__ uint32_t decode2(uint32_t o0, uint32_t o1, float a0, float a1,
                                           const float* tab) {
  const __nv_bfloat162 v =
      __floats2bfloat162_rn(__fmul_rn(code_at(tab, o0), a0), __fmul_rn(code_at(tab, o1), a1));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// packed rows [r, r + ROWS) at columns [n, n + 8): 8 bytes a row (0 past
// K/2 or N), byte by byte (N % 8 != 0)
__device__ __forceinline__ void load_rows(uint2 (&w)[ROWS], const uint8_t* packed, int r, int K2,
                                          int n, int N) {
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    uint32_t b[2] = {0, 0};
    if (r + i < K2) {
      const uint8_t* p = packed + (size_t)(r + i) * N + n;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (n + e < N) b[e / 4] |= (uint32_t)__ldg(p + e) << (8 * (e % 4));
    }
    w[i] = make_uint2(b[0], b[1]);
  }
}

// one k-step's ROWS x 8 share of a producer thread (rows r .. r + ROWS - 1 of
// K/2, tile rows k0 ..), decoded into the stage's two B tiles.  Tile layout
// (per plane): [n / 64][k][n % 64] bf16, 128-byte rows of 64 columns, 16-byte
// chunk c of row k at chunk c ^ (k % 8); the thread's 8 columns are chunk
// `cg` of each of its rows.  ALIGNED: one absmax block per plane for the
// rows, am_lo / am_hi given; else each element's own absmax, from logical
// rows r + i and K/2 + r + i.
template <bool DQ, bool ALIGNED>
__device__ __forceinline__ void decode_step(uint8_t* b_lo, uint8_t* b_hi,
                                            const uint2 (&w)[ROWS], const float (&am_lo)[8],
                                            const float (&am_hi)[8], const float* tab, int k0,
                                            int cg, int r, int K2, int n, int N, int B,
                                            const void* absmax, const float* scale, float off) {
  const int half = (cg >> 3) * (TKP * 128);
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int k = k0 + i;
    const int at = half + k * 128 + (((cg & 7) ^ (k & 7)) << 4);
    uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
    if (r + i < K2) {
      float al[8], ah[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (ALIGNED) {
          al[e] = am_lo[e];
          ah[e] = am_hi[e];
        } else {
          const bool in = n + e < N;
          al[e] = in ? absmax_at<DQ>(absmax, scale, off, (r + i) / B, n + e, N) : 0.f;
          ah[e] = in ? absmax_at<DQ>(absmax, scale, off, (K2 + r + i) / B, n + e, N) : 0.f;
        }
      }
      const uint32_t l0 = offs_lo(w[i].x), l1 = offs_lo(w[i].y);
      const uint32_t h0 = offs_hi(w[i].x), h1 = offs_hi(w[i].y);
      lo.x = decode2(byte_at(l0, 0), byte_at(l0, 1), al[0], al[1], tab);
      lo.y = decode2(byte_at(l0, 2), byte_at(l0, 3), al[2], al[3], tab);
      lo.z = decode2(byte_at(l1, 0), byte_at(l1, 1), al[4], al[5], tab);
      lo.w = decode2(byte_at(l1, 2), byte_at(l1, 3), al[6], al[7], tab);
      hi.x = decode2(byte_at(h0, 0), byte_at(h0, 1), ah[0], ah[1], tab);
      hi.y = decode2(byte_at(h0, 2), byte_at(h0, 3), ah[2], ah[3], tab);
      hi.z = decode2(byte_at(h1, 0), byte_at(h1, 1), ah[4], ah[5], tab);
      hi.w = decode2(byte_at(h1, 2), byte_at(h1, 3), ah[6], ah[7], tab);
    }
    *reinterpret_cast<uint4*>(b_lo + at) = lo;
    *reinterpret_cast<uint4*>(b_hi + at) = hi;
  }
}

template <bool DQ, bool ALIGNED, bool VEC, int MT>
__global__ void __launch_bounds__(THREADS, 1)
qmm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap, const uint8_t* __restrict__ packed,
                 const void* __restrict__ absmax, const float* __restrict__ scale,
                 const float* __restrict__ offset, const float* __restrict__ code,
                 __nv_bfloat16* __restrict__ y, int M, int K, int N, int B) {
  constexpr int TM = Tile<MT>::TM, A_BYTES = Tile<MT>::A_BYTES;
  constexpr int STAGE_BYTES = Tile<MT>::STAGE_BYTES, STAGES = Tile<MT>::STAGES;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ float tab[16];
  // the ring at a 1024-byte boundary (the 128-byte swizzle's period), then
  // the producers' staging ring and the barriers; offsets from smem_raw keep
  // the accesses in the shared state space (ld/st.shared, not generic)
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* staging = ring + STAGES * STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 4 * W_STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int K2 = K / 2;
  const int m0 = blockIdx.x * TM;
  const int n0 = blockIdx.y * TN;
  const int nsteps = (K2 + TKP - 1) / TKP;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(full + s), 128 + 1);  // a producer warpgroup + the expect-tx
      mbar_init(smem_u32(empty + s), 8);             // one lane of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (tid < 16) tab[tid] = code[tid];
  __syncthreads();

  if (tid >= 256) {
    // ---- producer warpgroups: TMA for x, the weight decoded into B tiles.
    // Warpgroup pw takes the k-steps pw, pw + 2, ..., so one warpgroup's
    // waits and fences overlap the other's decode ----
    // at 256 rows the consumers need 128 accumulators a thread: registers
    // move from the producers (88) to them (168)
    if (MT == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 88;" ::: "memory");
    const int pw = (tid - 256) >> 7;
    const int pt = tid & 127;
    const int cg = pt & 15;           // 8 columns: n0 + 8 cg
    const int k0 = (pt >> 4) * ROWS;  // ROWS rows of the k-step
    const int n = n0 + 8 * cg;
    const float off = DQ ? *offset : 0.f;
    // the absmax rows of this thread's rows in each plane, advanced per
    // k-step by comparison (ALIGNED: B % ROWS == 0, so the ROWS rows of a
    // k-step lie in one block; K/2 is a multiple of B)
    int blk_lo = 0, rem_lo = pw * TKP + k0, blk_hi = 0, rem_hi = K2 + pw * TKP + k0;
    if (ALIGNED) {
      blk_lo = rem_lo / B; rem_lo -= blk_lo * B;
      blk_hi = rem_hi / B; rem_hi -= blk_hi * B;
    }
    auto advance = [&] {
      rem_lo += 2 * TKP;
      while (rem_lo >= B) { rem_lo -= B; ++blk_lo; }
      rem_hi += 2 * TKP;
      while (rem_hi >= B) { rem_hi -= B; ++blk_hi; }
    };
    float am_lo[8], am_hi[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) am_lo[e] = am_hi[e] = 0.f;
    // VEC: the packed rows of a k-step arrive in this thread's own slot of
    // its warpgroup's two-slot staging ring through cp.async, issued one of
    // its k-steps ahead, and the next k-step's absmax in registers
    uint8_t* mine = staging + pw * 2 * W_STAGE_BYTES + pt * 8;
    auto issue = [&](int s) {
      if (s < nsteps) {
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const int r = s * TKP + k0 + i;
          if (r < K2 && n < N)
            asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(smem_u32(
                             mine + ((s >> 1) & 1) * W_STAGE_BYTES + i * 128 * 8)),
                         "l"(packed + (size_t)r * N + n)
                         : "memory");
        }
      }
      asm volatile("cp.async.commit_group;" ::: "memory");
    };
    AbsRaw raw;
    if (VEC) {
      issue(pw);
      if (ALIGNED) raw_load<DQ>(raw, absmax, scale, blk_lo, blk_hi, n, N);
    }
    uint2 cur[ROWS];
    for (int s = pw; s < nsteps; s += 2) {
      const int stage = s % STAGES;
      const uint32_t phase = (s / STAGES) & 1;
      const int kp = s * TKP;
      if (VEC) {
        issue(s + 2);
        asm volatile("cp.async.wait_group 1;" ::: "memory");
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
          cur[i] = *reinterpret_cast<const uint2*>(mine + ((s >> 1) & 1) * W_STAGE_BYTES +
                                                   i * 128 * 8);
        if (ALIGNED) {
          raw_decode<DQ>(am_lo, am_hi, raw, off);
          advance();
          if (s + 2 < nsteps) raw_load<DQ>(raw, absmax, scale, blk_lo, blk_hi, n, N);
        }
      } else {
        load_rows(cur, packed, kp + k0, K2, n, N);
        if (ALIGNED) {
          absmax8<DQ>(am_lo, absmax, scale, off, blk_lo, n, N);
          absmax8<DQ>(am_hi, absmax, scale, off, blk_hi, n, N);
          advance();
        }
      }
      uint8_t* st = ring + stage * STAGE_BYTES;
      mbar_wait(smem_u32(empty + stage), phase ^ 1);
      if (pt == 0) {
        const uint32_t bar = smem_u32(full + stage);
        mbar_arrive_tx(bar, 2 * A_BYTES);
        tma_load_2d(smem_u32(st), &xmap, bar, kp, m0);
        tma_load_2d(smem_u32(st + A_BYTES), &xmap, bar, K2 + kp, m0);
      }
      decode_step<DQ, ALIGNED>(st + 2 * A_BYTES, st + 2 * A_BYTES + B_BYTES, cur, am_lo, am_hi,
                               tab, k0, cg, kp + k0, K2, n, N, B, absmax, scale, off);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(smem_u32(full + stage));
    }
    return;
  }

  // ---- consumer warpgroups 0 and 1: rows m0 + 64 MT wg .. + 64 MT - 1 ----
  if (MT == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 168;" ::: "memory");
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  float acc[MT][64];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[mt][i] = 0.f;
  for (int s = 0; s < nsteps; ++s) {
    const int stage = s % STAGES;
    mbar_wait(smem_u32(full + stage), (s / STAGES) & 1);
    const uint32_t st = smem_u32(ring + stage * STAGE_BYTES);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const uint32_t a = st + p * A_BYTES + wg * MT * (64 * 128);  // x: K-major, 128-byte rows
      const uint32_t b = st + 2 * A_BYTES + p * B_BYTES;           // weight: MN-major
#pragma unroll
      for (int kk = 0; kk < TKP / 16; ++kk) {
        const uint64_t db = gmma_desc(b + kk * 16 * 128, TKP * 128, 1024);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          wgmma_m64n128k16(acc[mt], gmma_desc(a + mt * (64 * 128) + kk * 32, 16, 1024), db);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    if (lane == 0) mbar_arrive(smem_u32(empty + stage));
  }

  // epilogue: bf16 tile in the ring (every stage consumed), then 16-byte rows
  asm volatile("bar.sync 1, 256;" ::: "memory");
  __nv_bfloat16* c = reinterpret_cast<__nv_bfloat16*>(ring);
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int row = (wg * MT + mt) * 64 + warp * 16 + g;
#pragma unroll
    for (int i = 0; i < TN / 8; ++i) {
      const int col = 8 * i + 2 * q;
      *reinterpret_cast<__nv_bfloat162*>(c + row * C_PITCH + col) =
          __floats2bfloat162_rn(acc[mt][4 * i], acc[mt][4 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(c + (row + 8) * C_PITCH + col) =
          __floats2bfloat162_rn(acc[mt][4 * i + 2], acc[mt][4 * i + 3]);
    }
  }
  asm volatile("bar.sync 1, 256;" ::: "memory");
  for (int e = tid; e < TM * (TN / 8); e += 256) {
    const int r = e / (TN / 8), ch = e % (TN / 8);
    const int m = m0 + r, nn = n0 + 8 * ch;
    if (m >= M || nn >= N) continue;
    const __nv_bfloat16* src = c + r * C_PITCH + 8 * ch;
    __nv_bfloat16* dst = y + (size_t)m * N + nn;
    if (VEC) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int k = 0; k < 8 && nn + k < N; ++k) dst[k] = src[k];
    }
  }
}

// cuTensorMapEncodeTiled from the driver library that the process has loaded,
// found once, so that the library needs no link against libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

template <bool DQ, bool ALIGNED, bool VEC, int MT>
int launch(const void* x, const void* packed, const void* absmax, const void* scale,
           const void* offset, const void* code, void* y, int M, int K, int N, int B,
           cudaStream_t stream) {
  using T = Tile<MT>;
  const EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {TKP, T::TM};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = qmm_wgmma_kernel<DQ, ALIGNED, VEC, MT>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((M + T::TM - 1) / T::TM, (N + TN - 1) / TN);
  kernel<<<grid, THREADS, T::SMEM_BYTES, stream>>>(
      xmap, static_cast<const uint8_t*>(packed), absmax, static_cast<const float*>(scale),
      static_cast<const float*>(offset), static_cast<const float*>(code),
      static_cast<__nv_bfloat16*>(y), M, K, N, B);
  return static_cast<int>(cudaGetLastError());
}

template <int MT>
int launch_mt(bool dq, bool aligned, bool vec, const void* x, const void* packed,
              const void* absmax, const void* scale, const void* offset, const void* code,
              void* y, int M, int K, int N, int B, cudaStream_t s) {
#define QMM_WGMMA_LAUNCH(D, A, V) \
  launch<D, A, V, MT>(x, packed, absmax, scale, offset, code, y, M, K, N, B, s)
  if (dq) {
    if (aligned) return vec ? QMM_WGMMA_LAUNCH(true, true, true) : QMM_WGMMA_LAUNCH(true, true, false);
    return vec ? QMM_WGMMA_LAUNCH(true, false, true) : QMM_WGMMA_LAUNCH(true, false, false);
  }
  if (aligned) return vec ? QMM_WGMMA_LAUNCH(false, true, true) : QMM_WGMMA_LAUNCH(false, true, false);
  return vec ? QMM_WGMMA_LAUNCH(false, false, true) : QMM_WGMMA_LAUNCH(false, false, false);
#undef QMM_WGMMA_LAUNCH
}

}  // namespace

// x bf16 [M, K] row-major, 16-byte aligned, K % 16 == 0; packed u8 [K/2, N];
// absmax int8 (dq) or f32 [K/B, N]; scale f32 [ceil((K/B)/256), N] and
// offset f32 [1] when dq, else unused; code f32 [16]; y bf16 [M, N].  The
// plan's constants (ops/qmatmul.py: tile_plan): `tm` rows a CTA (128 or
// 256), `stages` k-steps in the ring and `smem` bytes of dynamic shared
// memory, checked against the kernel's own.  Returns the launch's cudaError_t (cudaErrorInvalidValue for a shape
// or plan the kernel does not take, or when the tensor map cannot be made).
extern "C" int qmm_nf4_wgmma(const void* x, const void* packed, const void* absmax,
                             const void* scale, const void* offset, const void* code, void* y,
                             int M, int K, int N, int block_size, int dq, int tm, int stages,
                             int smem, void* stream) {
  const bool two = tm == Tile<2>::TM;
  if (M <= 0 || K <= 0 || K % 16 || N <= 0 || block_size <= 0 ||
      (tm != Tile<1>::TM && !two) || stages != (two ? Tile<2>::STAGES : Tile<1>::STAGES) ||
      smem != (two ? Tile<2>::SMEM_BYTES : Tile<1>::SMEM_BYTES) ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = block_size % ROWS == 0;  // K / 2 % ROWS == 0 as K % 16 == 0
  const bool vec = N % 8 == 0;
  return two ? launch_mt<2>(dq, aligned, vec, x, packed, absmax, scale, offset, code, y, M, K, N,
                            block_size, s)
             : launch_mt<1>(dq, aligned, vec, x, packed, absmax, scale, offset, code, y, M, K, N,
                            block_size, s);
}
