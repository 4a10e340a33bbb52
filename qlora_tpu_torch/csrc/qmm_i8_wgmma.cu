// Fused int8 dequantize + matmul for prefill and training rows (M > 16), on
// Hopper's wgmma, forward and backward with respect to the input:
//   qmm_i8_wgmma_fwd:  y[M, N]  = x[M, K] @ dequant(W)[K, N]
//   qmm_i8_wgmma_bwd:  dx[M, K] = g[M, N] @ dequant(W)[K, N]^T
//
// Replaces the TPU kernels qlora_tpu/ops/qmatmul.py::_qmm_pallas_i8 (body
// _i8_fwd_kernel, pallas_call at qmatmul.py:446) and ::_qmm_bwd_pallas_i8
// (body _i8_bwd_kernel, pallas_call at :487) at more than 16 rows.  Fewer
// rows, and shapes whose activation row stride TMA cannot take (K % 8 != 0
// forward, N % 8 != 0 backward), run qmm_i8.cu (ops/qmatmul.py:
// i8_tile_plan).  One template, <bool DQ, bool BWD, ...>, serves both
// directions and both absmax variants.
//
// Storage (qlora_tpu_torch/quant/blockwise.py): codes int8 [K, N], N
// contiguous; absmax [K/B, N] f32, or int8 with meta-scales f32
// [ceil((K/B)/256), N] and one f32 offset (absmax = q * (scale * (1/127)) +
// offset, one fused multiply-add, as dequantize computes it).  A weight
// element is bf16((float(code) * (1/127)) * absmax), in that order, as
// dequantize computes it: an identity operand reads the same bits out.
//
// What bounds it on an H100: the bf16 tensor-core rate, 2*M*K*N operations
// (M = 1024: 0.035 ms at 4096 x 4096), not the bytes (K*N codes, read once
// per 128 or 256 rows).  The decode runs in producer warpgroups beside the
// products, once per weight tile for the CTA's 128 or 256 rows.
//
// Design (one CTA per 128 x 128 or 256 x 128 output tile, 512 threads, no
// split of the contraction; the plan picks 256 rows where 128-row tiles
// would need more than one wave of CTAs):
// - A k-step is TK = 64 rows of the contraction (k forward, n backward):
//   four m64n128k16 wgmmas per consumer warpgroup and m64 tile.
// - The activation (x forward, g backward) arrives as one TMA box [rows, 64
//   columns] per k-step, 128-byte swizzle (the K-major layout wgmma reads),
//   on the stage's full mbarrier with expect-tx.  TMA zero-fills rows past M
//   and columns past the contraction's end; the producers write weight rows
//   and columns past the ends as zeros.
// - The weight: two producer warpgroups take alternate k-steps, so one's
//   waits and fences overlap the other's decode.  A producer thread owns 8
//   columns of 8 weight rows of the tile; the codes arrive in its own slot of
//   a staging ring through 8-byte cp.async issued a k-step of its own ahead
//   (byte loads forward where N % 8 != 0).
//   - Forward, the tile is W[k0:k0+64, n0:n0+128], stored MN-major with the
//     128-byte swizzle (transpose bit set): n in two 64-column halves of
//     128-byte k rows.
//   - Backward, the tile is W[k0:k0+128, n0:n0+64], the rows k being output
//     columns, kept in its natural [k][n] order: 64 n of a row are 128 bytes,
//     one swizzle row, so the tile is K-major (the contraction n
//     contiguous), the layout of the activation box, read with the transpose
//     bit cleared.  No transpose pass.
//   Each store is one 16-byte chunk of a 128-byte row (chunk c of row r at
//   c ^ (r % 8)), and a quarter-warp fills a row without bank conflicts.
// - The absmax of a thread's 8 columns is loaded (8- and 16-byte loads) a
//   k-step ahead and decoded once per k-step, q * (scale / 127) + offset
//   with one __fmaf_rn in the DQ variant.  Forward its block row advances by
//   comparison, no division; backward the thread's rows, and so its block
//   row, stay fixed while the columns advance.  Block sizes that are no
//   multiple of 8 take each element's own absmax (ALIGNED = false, a slow
//   path for odd shapes).
// - Every producer fences (fence.proxy.async) before it arrives on the full
//   barrier, so the async proxy that wgmma reads through sees the generic
//   stores.
// - Two consumer warpgroups own 64 MT rows each (MT = 1 or 2 m64 tiles),
//   wait on the full barrier, run the k-step's 4 MT wgmmas into f32
//   registers, wait for them and release the stage on its empty barrier.  A
//   ring of 6 (MT = 1) or 4 (MT = 2) k-steps in dynamic shared memory, 226 KB
//   with the staging ring.
// - Sums run over the contraction in one fixed order per output element:
//   deterministic, and a row's result does not depend on the other rows.
// - Epilogue: round to bf16 once, stage the tile in shared memory (the ring,
//   free by then), store rows with 16-byte stores, masked at the edges.
// - Registers: at MT = 2 a consumer thread holds 128 accumulators, so
//   setmaxnreg moves registers from the producers (down to 88) to the
//   consumers (up to 168).
// - What sets the pace (python -m qlora_tpu_torch.ops.tile_sweep int8): the
//   products alone and the decode alone each take about two thirds of the
//   kernel's time, and overlap only in part.  128-row CTAs, a consumer that
//   keeps one k-step of wgmmas in flight, and int-to-float conversions of
//   the codes were each slower.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int TN = 128;                 // output columns of a CTA (n forward, k backward)
constexpr int TK = 64;                  // contraction rows of a k-step (k forward, n backward)
constexpr int THREADS = 512;            // warpgroups 0, 1 multiply; 2, 3 decode
constexpr int ROWS = 8;                 // weight rows of a k-step per producer thread
constexpr int B_BYTES = TK * TN * 2;    // a k-step's decoded weight, 16 KB
constexpr int W_STAGE_BYTES = TK * TN;  // a k-step's codes, staged for a producer
constexpr int C_PITCH = TN + 8;         // bf16 row pitch of the staged output tile
static_assert(TK * TN / 8 / ROWS == 128, "a producer warpgroup covers a k-step");

// A CTA's rows: MT m64 tiles per consumer warpgroup, 128 MT rows, so a
// decoded weight tile serves 128 or 256 rows.  The ring holds as many
// k-steps as fit beside the producers' staging ring.
template <int MT>
struct Tile {
  static constexpr int TM = 128 * MT;
  static constexpr int A_BYTES = TM * TK * 2;  // the activation box
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES = MT == 1 ? 6 : 4;
  // alignment, the ring, the producers' staging ring, barriers
  static constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 4 * W_STAGE_BYTES + 1024;
  static_assert(TM * C_PITCH * 2 <= STAGES * STAGE_BYTES, "the output tile reuses the ring");
  static_assert(SMEM_BYTES <= 232448, "227 KB a block");
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

// d[64] += A (64 x 16, K-major, the activation) * B (16 x 128, the decoded
// weight), bf16 in, f32 accumulators; B is MN-major with the transpose bit
// (TRANS_B = 1, forward) or K-major without it (TRANS_B = 0, backward)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, %67;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1), "n"(TRANS_B)
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

// a k-step's absmax of 8 columns, as loaded with 8- and 16-byte loads
// (N % 8 == 0): int8 codes and meta-scales (DQ), or f32
struct AbsRaw {
  uint2 q;
  float4 v[2];
};

template <bool DQ>
__device__ __forceinline__ void raw_load(AbsRaw& raw, const void* absmax, const float* scale,
                                         int blk, int n, int N, bool in) {
  if (!in) {  // rows or columns past the weight: absmax 0
    raw.q = make_uint2(0, 0);
    raw.v[0] = raw.v[1] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const float* v;
  if (DQ) {
    raw.q = __ldg(reinterpret_cast<const uint2*>(static_cast<const int8_t*>(absmax) +
                                                 (size_t)blk * N + n));
    v = scale + (size_t)(blk / 256) * N + n;
  } else {
    v = static_cast<const float*>(absmax) + (size_t)blk * N + n;
  }
  raw.v[0] = __ldg(reinterpret_cast<const float4*>(v));
  raw.v[1] = __ldg(reinterpret_cast<const float4*>(v) + 1);
}

template <bool DQ>
__device__ __forceinline__ void raw_decode(float (&am)[8], const AbsRaw& raw, float off) {
  const float v[8] = {raw.v[0].x, raw.v[0].y, raw.v[0].z, raw.v[0].w,
                      raw.v[1].x, raw.v[1].y, raw.v[1].z, raw.v[1].w};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    if (DQ) {
      const float qv = (float)(int8_t)((e < 4 ? raw.q.x : raw.q.y) >> (8 * (e & 3)));
      am[e] = __fmaf_rn(qv, __fmul_rn(v[e], 1.f / 127.f), off);
    } else {
      am[e] = v[e];
    }
  }
}

// the int8 code in byte e of w as a float, exactly: its byte with the sign
// bit flipped is code + 128, placed in the mantissa of 2^23 (one prmt), minus
// 2^23 + 128 (one add); the conversion unit, which also rounds the results
// to bf16, is the producers' scarcest
__device__ __forceinline__ float code_at(uint32_t w, int e) {
  return __int_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7440 | e)) - 8388736.f;
}

// two decoded weights, bytes e and e + 1 of a word of codes, rounded to bf16
// and paired (the first in the low half): (code * (1/127)) * absmax
__device__ __forceinline__ uint32_t decode2(uint32_t w, int e, float a0, float a1) {
  const float r = (float)(1.0 / 127.0);
  const float c0 = code_at(w, e), c1 = code_at(w, e + 1);
  const __nv_bfloat162 v =
      __floats2bfloat162_rn(__fmul_rn(__fmul_rn(c0, r), a0), __fmul_rn(__fmul_rn(c1, r), a1));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// codes of rows [r, r + ROWS) at columns [n, n + 8): 8 bytes a row (0 past
// K or N), byte by byte (N % 8 != 0)
__device__ __forceinline__ void load_rows(uint2 (&w)[ROWS], const int8_t* codes, int r, int K,
                                          int n, int N) {
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    uint32_t b[2] = {0, 0};
    if (r + i < K) {
      const int8_t* p = codes + (size_t)(r + i) * N + n;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (n + e < N) b[e / 4] |= (uint32_t)(uint8_t)__ldg(p + e) << (8 * (e % 4));
    }
    w[i] = make_uint2(b[0], b[1]);
  }
}

// one k-step's ROWS x 8 share of a producer thread: weight rows r .. r +
// ROWS - 1 at columns n .. n + 7, tile rows t .. t + ROWS - 1, 16-byte chunk
// cg of each, decoded into the stage's B tile.  Forward (MN-major): [n / 64]
// [k][n % 64] bf16, 128-byte rows of 64 columns; backward (K-major): [k][n],
// 128-byte rows of the 64 contraction columns.  Chunk c of row t lies at
// chunk c ^ (t % 8).  ALIGNED: the rows lie in one absmax block, am given;
// else each element's own absmax.
template <bool DQ, bool BWD, bool ALIGNED>
__device__ __forceinline__ void decode_step(uint8_t* b, const uint2 (&w)[ROWS],
                                            const float (&am)[8], int t, int cg, int r, int n,
                                            int K, int N, int B, const void* absmax,
                                            const float* scale, float off) {
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = t + i;
    const int at = BWD ? row * 128 + ((cg ^ (row & 7)) << 4)
                       : (cg >> 3) * (TK * 128) + row * 128 + (((cg & 7) ^ (row & 7)) << 4);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r + i < K && n < N) {
      float a[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        a[e] = ALIGNED ? am[e]
                       : (n + e < N ? absmax_at<DQ>(absmax, scale, off, (r + i) / B, n + e, N)
                                    : 0.f);
      v.x = decode2(w[i].x, 0, a[0], a[1]);
      v.y = decode2(w[i].x, 2, a[2], a[3]);
      v.z = decode2(w[i].y, 0, a[4], a[5]);
      v.w = decode2(w[i].y, 2, a[6], a[7]);
    }
    *reinterpret_cast<uint4*>(b + at) = v;
  }
}

// a: x [M, K] (forward) or g [M, N] (backward) through `amap`; out: y [M, N]
// or dx [M, K].  VEC: N % 8 == 0, the codes' rows take 8-byte cp.async (always
// so backward, where the plan asks N % 8 == 0 of g's row stride).
template <bool DQ, bool BWD, bool ALIGNED, bool VEC, int MT>
__global__ void __launch_bounds__(THREADS, 1)
qmm_i8_wgmma_kernel(const __grid_constant__ CUtensorMap amap, const int8_t* __restrict__ codes,
                    const void* __restrict__ absmax, const float* __restrict__ scale,
                    const float* __restrict__ offset, __nv_bfloat16* __restrict__ out, int M,
                    int K, int N, int B) {
  constexpr int TM = Tile<MT>::TM, A_BYTES = Tile<MT>::A_BYTES;
  constexpr int STAGE_BYTES = Tile<MT>::STAGE_BYTES, STAGES = Tile<MT>::STAGES;
  constexpr int CPR = BWD ? TK / 8 : TN / 8;  // 8-column chunks of a weight-tile row
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // the ring at a 1024-byte boundary (the 128-byte swizzle's period), then
  // the producers' staging ring and the barriers; offsets from smem_raw keep
  // the accesses in the shared state space (ld/st.shared, not generic)
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* staging = ring + STAGES * STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 4 * W_STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int C = BWD ? N : K;  // the contraction
  const int O = BWD ? K : N;  // the output's columns
  const int m0 = blockIdx.x * TM;
  const int o0 = blockIdx.y * TN;
  const int nsteps = (C + TK - 1) / TK;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(full + s), 128 + 1);  // a producer warpgroup + the expect-tx
      mbar_init(smem_u32(empty + s), 8);       // one lane of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // ---- producer warpgroups: TMA for the activation, the weight decoded
    // into B tiles.  Warpgroup pw takes the k-steps pw, pw + 2, ..., so one
    // warpgroup's waits and fences overlap the other's decode ----
    if (MT == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 88;" ::: "memory");
    const int pw = (tid - 256) >> 7;
    const int pt = tid & 127;
    const int cg = pt % CPR;
    const int t = (pt / CPR) * ROWS;  // the thread's first row of the weight tile
    // at k-step s the thread's weight rows start at row(s), its 8 columns at
    // col(s): forward rows s TK + t, columns o0 + 8 cg; backward rows o0 + t,
    // columns s TK + 8 cg
    auto row = [&](int s) { return BWD ? o0 + t : s * TK + t; };
    auto col = [&](int s) { return BWD ? s * TK + 8 * cg : o0 + 8 * cg; };
    const float off = DQ ? *offset : 0.f;
    // ALIGNED (B % ROWS == 0): a thread's ROWS rows lie in one absmax block,
    // row blk.  Forward it advances with the rows, 2 TK a k-step of the
    // warpgroup, by comparison; backward the rows stay and so does blk
    int blk = 0, rem = 0;
    if (ALIGNED) {
      if (BWD) {
        blk = row(0) / B;
      } else {
        blk = row(pw) / B;
        rem = row(pw) - blk * B;
      }
    }
    auto advance = [&] {
      if (!BWD) {
        rem += 2 * TK;
        while (rem >= B) { rem -= B; ++blk; }
      }
    };
    float am[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) am[e] = 0.f;
    // VEC: the codes of a k-step arrive in this thread's own slot of its
    // warpgroup's two-slot staging ring through cp.async, issued one of its
    // k-steps ahead, and the next k-step's absmax in registers
    uint8_t* mine = staging + pw * 2 * W_STAGE_BYTES + pt * 8;
    auto issue = [&](int s) {
      if (s < nsteps) {
        const int r = row(s), n = col(s);
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          if (r + i < K && n < N)
            asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(smem_u32(
                             mine + ((s >> 1) & 1) * W_STAGE_BYTES + i * 128 * 8)),
                         "l"(codes + (size_t)(r + i) * N + n)
                         : "memory");
        }
      }
      asm volatile("cp.async.commit_group;" ::: "memory");
    };
    AbsRaw raw;
    if (VEC) {
      issue(pw);
      if (ALIGNED) raw_load<DQ>(raw, absmax, scale, blk, col(pw), N, row(pw) < K && col(pw) < N);
    }
    uint2 cur[ROWS];
    for (int s = pw; s < nsteps; s += 2) {
      const int stage = s % STAGES;
      const uint32_t phase = (s / STAGES) & 1;
      if (VEC) {
        issue(s + 2);
        asm volatile("cp.async.wait_group 1;" ::: "memory");
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
          cur[i] = *reinterpret_cast<const uint2*>(mine + ((s >> 1) & 1) * W_STAGE_BYTES +
                                                   i * 128 * 8);
        if (ALIGNED) {
          raw_decode<DQ>(am, raw, off);
          advance();
          if (s + 2 < nsteps)
            raw_load<DQ>(raw, absmax, scale, blk, col(s + 2), N,
                         row(s + 2) < K && col(s + 2) < N);
        }
      } else {
        load_rows(cur, codes, row(s), K, col(s), N);
        if (ALIGNED) {
          if (row(s) < K) {
            absmax8<DQ>(am, absmax, scale, off, blk, col(s), N);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) am[e] = 0.f;
          }
          advance();
        }
      }
      uint8_t* st = ring + stage * STAGE_BYTES;
      mbar_wait(smem_u32(empty + stage), phase ^ 1);
      if (pt == 0) {
        const uint32_t bar = smem_u32(full + stage);
        mbar_arrive_tx(bar, A_BYTES);
        tma_load_2d(smem_u32(st), &amap, bar, s * TK, m0);
      }
      decode_step<DQ, BWD, ALIGNED>(st + A_BYTES, cur, am, t, cg, row(s), col(s), K, N, B,
                                    absmax, scale, off);
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
    const uint32_t a = smem_u32(ring + stage * STAGE_BYTES) + wg * MT * (64 * 128);
    const uint32_t b = smem_u32(ring + stage * STAGE_BYTES) + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      // forward B: MN-major, 16 k rows of 128 bytes a step, the two column
      // halves TK * 128 bytes apart; backward B: K-major like the activation
      const uint64_t db = BWD ? gmma_desc(b + kk * 32, 16, 1024)
                              : gmma_desc(b + kk * 16 * 128, TK * 128, 1024);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        wgmma_m64n128k16<BWD ? 0 : 1>(acc[mt], gmma_desc(a + mt * (64 * 128) + kk * 32, 16, 1024),
                                      db);
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
    const int r = (wg * MT + mt) * 64 + warp * 16 + g;
#pragma unroll
    for (int i = 0; i < TN / 8; ++i) {
      const int cc = 8 * i + 2 * q;
      *reinterpret_cast<__nv_bfloat162*>(c + r * C_PITCH + cc) =
          __floats2bfloat162_rn(acc[mt][4 * i], acc[mt][4 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(c + (r + 8) * C_PITCH + cc) =
          __floats2bfloat162_rn(acc[mt][4 * i + 2], acc[mt][4 * i + 3]);
    }
  }
  asm volatile("bar.sync 1, 256;" ::: "memory");
  const bool vec_out = O % 8 == 0;
  for (int e = tid; e < TM * (TN / 8); e += 256) {
    const int r = e / (TN / 8), ch = e % (TN / 8);
    const int m = m0 + r, o = o0 + 8 * ch;
    if (m >= M || o >= O) continue;
    const __nv_bfloat16* src = c + r * C_PITCH + 8 * ch;
    __nv_bfloat16* dst = out + (size_t)m * O + o;
    if (vec_out) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int k = 0; k < 8 && o + k < O; ++k) dst[k] = src[k];
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

template <bool DQ, bool BWD, bool ALIGNED, bool VEC, int MT>
int launch(const void* a, const void* codes, const void* absmax, const void* scale,
           const void* offset, void* out, int M, int K, int N, int B, cudaStream_t stream) {
  using T = Tile<MT>;
  const EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorInvalidValue);
  const int C = BWD ? N : K, O = BWD ? K : N;
  CUtensorMap amap;
  const cuuint64_t dims[2] = {(cuuint64_t)C, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)C * 2};
  const cuuint32_t box[2] = {TK, T::TM};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&amap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(a), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = qmm_i8_wgmma_kernel<DQ, BWD, ALIGNED, VEC, MT>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((M + T::TM - 1) / T::TM, (O + TN - 1) / TN);
  kernel<<<grid, THREADS, T::SMEM_BYTES, stream>>>(
      amap, static_cast<const int8_t*>(codes), absmax, static_cast<const float*>(scale),
      static_cast<const float*>(offset), static_cast<__nv_bfloat16*>(out), M, K, N, B);
  return static_cast<int>(cudaGetLastError());
}

// the instantiations: backward always has N % 8 == 0 (VEC)
template <bool BWD, int MT>
int launch_mt(bool dq, bool aligned, bool vec, const void* a, const void* codes,
              const void* absmax, const void* scale, const void* offset, void* out, int M, int K,
              int N, int B, cudaStream_t s) {
#define QMM_I8_WGMMA_LAUNCH(D, A, V) \
  launch<D, BWD, A, V, MT>(a, codes, absmax, scale, offset, out, M, K, N, B, s)
  if (BWD || vec) {
    if (dq) return aligned ? QMM_I8_WGMMA_LAUNCH(true, true, true) : QMM_I8_WGMMA_LAUNCH(true, false, true);
    return aligned ? QMM_I8_WGMMA_LAUNCH(false, true, true) : QMM_I8_WGMMA_LAUNCH(false, false, true);
  }
  if constexpr (!BWD) {
    if (dq) return aligned ? QMM_I8_WGMMA_LAUNCH(true, true, false) : QMM_I8_WGMMA_LAUNCH(true, false, false);
    return aligned ? QMM_I8_WGMMA_LAUNCH(false, true, false) : QMM_I8_WGMMA_LAUNCH(false, false, false);
  }
  return static_cast<int>(cudaErrorInvalidValue);
#undef QMM_I8_WGMMA_LAUNCH
}

template <bool BWD>
int entry(const void* a, const void* codes, const void* absmax, const void* scale,
          const void* offset, void* out, int M, int K, int N, int block_size, int dq, int tm,
          int stages, int smem, void* stream) {
  const bool two = tm == Tile<2>::TM;
  const int C = BWD ? N : K;
  const bool vec = N % 8 == 0;
  const bool aligned = block_size % ROWS == 0;
  const auto at = [](const void* p, int n) { return reinterpret_cast<uintptr_t>(p) % n == 0; };
  if (M <= 0 || K <= 0 || N <= 0 || C % 8 || block_size <= 0 || K % block_size ||
      (tm != Tile<1>::TM && !two) || stages != (two ? Tile<2>::STAGES : Tile<1>::STAGES) ||
      smem != (two ? Tile<2>::SMEM_BYTES : Tile<1>::SMEM_BYTES) || !at(a, 16) ||
      (vec && !at(codes, 8)) ||
      (vec && aligned && !(at(absmax, dq ? 8 : 16) && (!dq || at(scale, 16)))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return two ? launch_mt<BWD, 2>(dq, aligned, vec, a, codes, absmax, scale, offset, out, M, K, N,
                                 block_size, s)
             : launch_mt<BWD, 1>(dq, aligned, vec, a, codes, absmax, scale, offset, out, M, K, N,
                                 block_size, s);
}

}  // namespace

// x bf16 [M, K] row-major, 16-byte aligned, K % 8 == 0; codes int8 [K, N];
// absmax int8 (dq) or f32 [K/B, N]; scale f32 [ceil((K/B)/256), N] and offset
// f32 [1] when dq, else unused; the codebook argument of the NF4 entries is
// unused here; y bf16 [M, N].  The plan's constants (ops/qmatmul.py:
// i8_tile_plan): `tm` rows a CTA (128 or 256), `stages` k-steps in the ring
// and `smem` bytes of dynamic shared memory, checked against the kernel's
// own.  Returns the launch's cudaError_t (cudaErrorInvalidValue for a shape,
// alignment or plan the kernel does not take, or when the tensor map cannot
// be made).
extern "C" int qmm_i8_wgmma_fwd(const void* x, const void* codes, const void* absmax,
                                const void* scale, const void* offset, const void* unused,
                                void* y, int M, int K, int N, int block_size, int dq, int tm,
                                int stages, int smem, void* stream) {
  (void)unused;
  return entry<false>(x, codes, absmax, scale, offset, y, M, K, N, block_size, dq, tm, stages,
                      smem, stream);
}

// g bf16 [M, N] row-major, 16-byte aligned, N % 8 == 0; the weight as above;
// dx bf16 [M, K].
extern "C" int qmm_i8_wgmma_bwd(const void* g, const void* codes, const void* absmax,
                                const void* scale, const void* offset, const void* unused,
                                void* dx, int M, int K, int N, int block_size, int dq, int tm,
                                int stages, int smem, void* stream) {
  (void)unused;
  return entry<true>(g, codes, absmax, scale, offset, dx, M, K, N, block_size, dq, tm, stages,
                     smem, stream);
}
