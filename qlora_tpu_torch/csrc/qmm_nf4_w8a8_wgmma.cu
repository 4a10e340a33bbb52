// w8a8 matmul over NF4/FP4 storage at prefill rows (M > 16), on Hopper's int8
// wgmma: y[M, N] = (x8[M, K] @ w8[K, N]) * s_out[n] * xs[m], with w8 decoded
// here from the packed nibbles and the int32 sum exact.
//
// Replaces the TPU kernel qlora_tpu/ops/qmatmul.py::_qmm_pallas_w8a8 (body
// _w8a8_fwd_kernel, pallas_call at qmatmul.py:270) above 16 rows.  Fewer
// rows run qmm_nf4_w8a8_decode.cu; shapes its plan refuses (ops/qmatmul.py:
// w8a8_tile_plan: K % 32, N % 8 or the block size % 8 not 0; no model
// linear) stay on qmm_i8_direct.cu's NF4 path, which this kernel replaced at
// these rows and which stays beside it as the "before".
//
// The function is qmm_i8_direct.cu's: rows of x quantized to int8 before the
// kernel (x8, xs), per-column scales made before it (ratio f32 [K/B, N] =
// absmax * (127 / col), s_out f32 [N] = col / 127).  A weight element is
// int8(rint(code[nibble] * ratio[k / B, n])), the product rounded to f32 and
// then to an integer half to even, as w8a8_codes and jnp.round compute it.
// The sum is int32 and exact (|sum| <= 11008 * 127^2 < 2^31).  The epilogue
// rounds twice, y = bf16(bf16(float(acc) * s_out[n]) * bf16(xs[m])); with
// s_out null the kernel writes the int32 accumulators instead.  So the kernel
// equals its plain version bit for bit at every shape.
//
// Storage: packed u8 [K/2, N], N contiguous; byte (r, n) holds logical row r
// in its low nibble and row K/2 + r in its high one (the split-half planes).
//
// What bounds it on an H100: the int8 tensor-core rate, 2*M*K*N operations
// (M = 512: 0.0087 ms at 4096 x 4096), not the bytes (K*N/2 packed, read once
// per 128 or 256 rows).
//
// Design (qmm_nf4_wgmma.cu's pipeline; one CTA per 128 x 128 or 256 x 128
// output tile, 512 threads, no split of K; the plan picks 256 rows where
// 128-row tiles would need more than one wave of CTAs):
// - A k-step is TKP = 64 packed rows: 64 k of each plane, 64 bytes, two
//   m64n128k32 wgmmas per plane, consumer warpgroup and m64 tile.
// - x8: two TMA boxes [rows, 64 bytes] per k-step, at column kp (low plane)
//   and K/2 + kp (high plane), 64-byte swizzle, on the stage's full mbarrier
//   with expect-tx.  TMA zero-fills rows past M and columns past K; the low
//   box may run past K/2 into high-plane values, so packed rows past K/2
//   decode as zeros.  K % 32 == 0 puts the high box's start on a 16-byte
//   boundary; the plan and the C entry refuse other K.
// - int8 wgmma reads both operands K-major (the 16-bit types' transpose bits
//   do not exist for .s8), so the producers transpose while they decode: the
//   B tile of a plane is [n][k], 64-byte rows of k, 64-byte swizzle (16-byte
//   chunk c of row n at c ^ ((n >> 1) & 3)).  A producer thread owns 8
//   columns of 8 packed rows of a k-step; for each column it packs its 8
//   low-plane and 8 high-plane codes (prmt) into two 8-byte words and stores
//   each into its plane's tile.  Threads of a half-warp differ in their 8
//   rows (rg = pt % 8) and in the parity of their column group, which each
//   stores in the other order (column e ^ 1 at step e), so the 8-byte stores
//   of a half-warp hit 16 distinct bank pairs.
// - Decode: the 16-entry codebook in shared memory, looked up at byte
//   offsets (one prmt a byte); __fmul_rn(code, ratio), then __fadd_rn of
//   1.5 * 2^23, whose low byte is the product rounded half to even (exact
//   for |p| < 2^22, two's complement; the add runs at the full f32 rate where
//   __float2int_rn takes the conversion unit).
// - The bytes arrive in the thread's own slot of a staging ring through
//   8-byte cp.async issued a k-step of its own ahead; two producer
//   warpgroups take alternate k-steps.  The ratios of a thread's 8 columns
//   (two 16-byte loads a plane: its 8 rows lie in one block, the block size
//   being a multiple of 8) are loaded a k-step ahead.
// - Every producer fences (fence.proxy.async) before it arrives on the full
//   barrier, so the async proxy that wgmma reads through sees its stores.
// - Two consumer warpgroups own 64 MT rows each (MT = 1 or 2 m64 tiles) and
//   run the k-step's 4 MT wgmmas into int32 registers; a ring of 6 (MT = 1)
//   or 4 (MT = 2) k-steps, 226 KB with the staging ring.
// - Sums run over K in one fixed order per output element: deterministic,
//   and a row's result does not depend on the other rows.
// - Epilogue: the scaled bf16 (or the raw int32) tile staged in shared
//   memory (the ring, free by then), stored with 16-byte stores, masked at
//   the M and N edges.
// - Registers: at MT = 2 a consumer thread holds 128 accumulators, so
//   setmaxnreg moves registers from the producers (down to 88) to the
//   consumers (up to 168).
// - What sets the pace (python -m qlora_tpu_torch.ops.tile_sweep w8a8): the
//   producers' decode.  Without it the products alone take 29-43 % of the
//   time, and a CTA's k-step takes as long at 128 rows as at 512.  Rounding
//   by __float2int_rn was 7-11 % slower, the stores of a half-warp in one
//   column order up to 21 %, 128-row CTAs at 2048 rows 35-55 %; table
//   addresses formed by one prmt, or bytes fetched two of a warpgroup's
//   k-steps ahead, gained 2-4 % at 256-row CTAs and nothing at 128.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int TN = 128;                  // columns of a CTA
constexpr int TKP = 64;                  // packed rows of a k-step (64 bytes of k a plane)
constexpr int THREADS = 512;             // warpgroups 0, 1 multiply; 2, 3 decode
constexpr int ROWS = 8;                  // packed rows of a k-step per producer thread
constexpr int B_BYTES = TN * TKP;        // one plane's B tile, [n][k] int8, 8 KB
constexpr int W_STAGE_BYTES = TKP * TN;  // a k-step's packed bytes, staged for a producer
constexpr int C_PITCH = TN + 8;          // bf16 row pitch of the staged output tile
constexpr int I_PITCH = TN + 4;          // int32 row pitch of the staged accumulators
constexpr float ROUNDER = 12582912.f;    // 1.5 * 2^23
static_assert(TKP * TN / 8 / ROWS == 128, "a producer warpgroup covers a k-step");

// A CTA's rows: MT m64 tiles per consumer warpgroup, 128 MT rows.
template <int MT>
struct Tile {
  static constexpr int TM = 128 * MT;
  static constexpr int A_BYTES = TM * TKP;                 // one plane's x8 box
  static constexpr int STAGE_BYTES = 2 * A_BYTES + 2 * B_BYTES;
  static constexpr int STAGES = MT == 1 ? 6 : 4;
  // alignment, the ring, the producers' staging ring, barriers
  static constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 4 * W_STAGE_BYTES + 1024;
  static_assert(TM * I_PITCH * 4 <= STAGES * STAGE_BYTES, "the output tile reuses the ring");
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

// a wgmma shared-memory descriptor of a K-major operand, 64-byte swizzle:
// 8-row groups `sbo` bytes apart (leading offset unused for swizzled K-major)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (2ull << 62);
}

// d[64] += A (64 x 32 int8, K-major, x8) * B (32 x 128 int8, K-major, the
// decoded weight), int32 accumulators
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
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

// 4 * the nibble of each byte of a packed word, low plane or high plane: the
// byte offsets of the codes in the codebook, one prmt a byte to take out
__device__ __forceinline__ uint32_t offs_lo(uint32_t w) { return (w << 2) & 0x3C3C3C3Cu; }
__device__ __forceinline__ uint32_t offs_hi(uint32_t w) { return (w >> 2) & 0x3C3C3C3Cu; }
__device__ __forceinline__ uint32_t byte_at(uint32_t o, int e) {
  return __byte_perm(o, 0, 0x4440 | e);
}

// int8(rint(code * ratio)) in the low byte: the product rounded to f32, then
// 1.5 * 2^23 added (rounded half to even onto the integers), as w8a8_codes
__device__ __forceinline__ uint32_t code8(const float* tab, uint32_t o, float ratio) {
  const float c = *reinterpret_cast<const float*>(reinterpret_cast<const char*>(tab) + o);
  return __float_as_uint(__fadd_rn(__fmul_rn(c, ratio), ROUNDER));
}

// the low bytes of four words, in order
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// the ratios of 8 columns [n, n + 8) in ratio row blk, two 16-byte loads (0
// when !in: rows past K/2 or columns past N)
__device__ __forceinline__ void ratio8(float4 (&v)[2], const float* ratio, int blk, int n, int N,
                                       bool in) {
  if (!in) {
    v[0] = v[1] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const float4* p = reinterpret_cast<const float4*>(ratio + (size_t)blk * N + n);
  v[0] = __ldg(p);
  v[1] = __ldg(p + 1);
}

__device__ __forceinline__ float lane_of(const float4 (&v)[2], int e) {
  const float4 h = v[e >> 2];
  return (e & 3) == 0 ? h.x : (e & 3) == 1 ? h.y : (e & 3) == 2 ? h.z : h.w;
}

// one k-step's share of a producer thread: packed rows r .. r + 7 (rows
// 8 rg .. 8 rg + 7 of the step's 64), columns 8 cg .. 8 cg + 7 of the tile,
// decoded into the stage's two B tiles bt [plane][n][k] with the ratios rl /
// rh of the rows' block in each plane
__device__ __forceinline__ void decode_step(uint8_t* bt, const uint2 (&w)[ROWS],
                                            const float4 (&rl)[2], const float4 (&rh)[2],
                                            const float* tab, int rg, int cg, int r, int K2) {
  uint32_t lo[8][2], hi[8][2];  // per column: its 8 rows' codes of each plane
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    uint32_t ml[ROWS], mh[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const uint32_t word = e < 4 ? w[i].x : w[i].y;
      ml[i] = code8(tab, byte_at(offs_lo(word), e & 3), lane_of(rl, e));
      mh[i] = code8(tab, byte_at(offs_hi(word), e & 3), lane_of(rh, e));
      if (r + i >= K2) ml[i] = mh[i] = 0u;  // rows past K/2 (columns past N have ratio 0)
    }
    lo[e][0] = pack4(ml[0], ml[1], ml[2], ml[3]);
    lo[e][1] = pack4(ml[4], ml[5], ml[6], ml[7]);
    hi[e][0] = pack4(mh[0], mh[1], mh[2], mh[3]);
    hi[e][1] = pack4(mh[4], mh[5], mh[6], mh[7]);
  }
  // column nl of a plane's tile is a 64-byte row; the thread's 8 bytes are
  // half (rg & 1) of chunk (rg >> 1), which lies at chunk (rg >> 1) ^ ((nl >> 1) & 3)
  const bool odd = cg & 1;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int nl = 8 * cg + (e ^ (int)odd);
    const int at = nl * TKP + ((((rg >> 1) ^ (nl >> 1)) & 3) << 4) + ((rg & 1) << 3);
    const uint2 vl = odd ? make_uint2(lo[e ^ 1][0], lo[e ^ 1][1]) : make_uint2(lo[e][0], lo[e][1]);
    const uint2 vh = odd ? make_uint2(hi[e ^ 1][0], hi[e ^ 1][1]) : make_uint2(hi[e][0], hi[e][1]);
    *reinterpret_cast<uint2*>(bt + at) = vl;
    *reinterpret_cast<uint2*>(bt + B_BYTES + at) = vh;
  }
}

// x8 [M, K] through `xmap`; y bf16 [M, N] (s_out given) or int32 [M, N];
// N and the block size B multiples of 8.
template <int MT>
__global__ void __launch_bounds__(THREADS, 1)
qmm_nf4_w8a8_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                          const uint8_t* __restrict__ packed, const float* __restrict__ ratio,
                          const float* __restrict__ s_out, const float* __restrict__ xs,
                          const float* __restrict__ code, void* __restrict__ y, int M, int K,
                          int N, int B) {
  constexpr int TM = Tile<MT>::TM, A_BYTES = Tile<MT>::A_BYTES;
  constexpr int STAGE_BYTES = Tile<MT>::STAGE_BYTES, STAGES = Tile<MT>::STAGES;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ float tab[16];
  // the ring at a 1024-byte boundary (a multiple of the 64-byte swizzle's
  // 512-byte period), then the producers' staging ring and the barriers
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* staging = ring + STAGES * STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 4 * W_STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int K2 = K / 2;
  const int m0 = blockIdx.x * TM;
  const int n0 = blockIdx.y * TN;
  const int nsteps = (K2 + TKP - 1) / TKP;
  if (tid < 16) tab[tid] = code[tid];
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(full + s), 128 + 1);  // a producer warpgroup + the expect-tx
      mbar_init(smem_u32(empty + s), 8);       // one lane of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // ---- producer warpgroups: TMA for x8, the weight decoded into B tiles.
    // Warpgroup pw takes the k-steps pw, pw + 2, ... ----
    if (MT == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 88;" ::: "memory");
    const int pw = (tid - 256) >> 7;
    const int pt = tid & 127;
    const int rg = pt & 7;      // the thread's 8 packed rows of a k-step: 8 rg ..
    const int cg = pt >> 3;     // its 8 columns: n0 + 8 cg ..
    const int n = n0 + 8 * cg;
    auto row = [&](int s) { return s * TKP + 8 * rg; };
    // a thread's rows lie in one block of each plane (B % 8 == 0), ratio rows
    // row(s) / B and (K/2 + row(s)) / B; K/2 % 8 == 0 (K % 32 == 0), so its
    // rows are all inside K/2 or all past
    uint8_t* mine = staging + pw * 2 * W_STAGE_BYTES + pt * 8;
    auto issue = [&](int s) {
      if (s < nsteps) {
        const int r = row(s);
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          if (r + i < K2 && n < N)
            asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(smem_u32(
                             mine + ((s >> 1) & 1) * W_STAGE_BYTES + i * 128 * 8)),
                         "l"(packed + (size_t)(r + i) * N + n)
                         : "memory");
        }
      }
      asm volatile("cp.async.commit_group;" ::: "memory");
    };
    float4 nl[2] = {}, nh[2] = {}, rl[2] = {}, rh[2] = {};
    auto load_ratios = [&](int s) {
      const int r = row(s);
      const bool in = s < nsteps && r < K2 && n < N;
      ratio8(nl, ratio, r / B, n, N, in);
      ratio8(nh, ratio, (K2 + r) / B, n, N, in);
    };
    issue(pw);
    load_ratios(pw);
    uint2 cur[ROWS];
    for (int s = pw; s < nsteps; s += 2) {
      const int stage = s % STAGES;
      const uint32_t phase = (s / STAGES) & 1;
      issue(s + 2);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        cur[i] = row(s) + i < K2 && n < N
                     ? *reinterpret_cast<const uint2*>(mine + ((s >> 1) & 1) * W_STAGE_BYTES +
                                                       i * 128 * 8)
                     : make_uint2(0u, 0u);
      rl[0] = nl[0], rl[1] = nl[1], rh[0] = nh[0], rh[1] = nh[1];
      load_ratios(s + 2);
      uint8_t* st = ring + stage * STAGE_BYTES;
      mbar_wait(smem_u32(empty + stage), phase ^ 1);
      if (pt == 0) {
        const uint32_t bar = smem_u32(full + stage);
        mbar_arrive_tx(bar, 2 * A_BYTES);
        tma_load_2d(smem_u32(st), &xmap, bar, s * TKP, m0);
        tma_load_2d(smem_u32(st + A_BYTES), &xmap, bar, K2 + s * TKP, m0);
      }
      decode_step(st + 2 * A_BYTES, cur, rl, rh, tab, rg, cg, row(s), K2);
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
  int acc[MT][64];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[mt][i] = 0;
  for (int s = 0; s < nsteps; ++s) {
    const int stage = s % STAGES;
    mbar_wait(smem_u32(full + stage), (s / STAGES) & 1);
    const uint32_t base = smem_u32(ring + stage * STAGE_BYTES);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const uint32_t a = base + p * A_BYTES + wg * MT * (64 * TKP);
      const uint32_t b = base + 2 * A_BYTES + p * B_BYTES;
#pragma unroll
      for (int kk = 0; kk < TKP / 32; ++kk) {
        // both operands K-major, 64-byte rows, 8-row groups 512 bytes apart
        const uint64_t db = gmma_desc(b + kk * 32, 8 * TKP);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          wgmma_m64n128k32(acc[mt], gmma_desc(a + mt * (64 * TKP) + kk * 32, 8 * TKP), db);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    if (lane == 0) mbar_arrive(smem_u32(empty + stage));
  }

  // epilogue: the tile in the ring (every stage consumed), then 16-byte rows
  asm volatile("bar.sync 1, 256;" ::: "memory");
  const int g = lane >> 2, q = lane & 3;
  if (s_out == nullptr) {
    int* c = reinterpret_cast<int*>(ring);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = (wg * MT + mt) * 64 + warp * 16 + g;
#pragma unroll
      for (int i = 0; i < TN / 8; ++i) {
        const int cc = 8 * i + 2 * q;
        *reinterpret_cast<int2*>(c + r * I_PITCH + cc) = make_int2(acc[mt][4 * i], acc[mt][4 * i + 1]);
        *reinterpret_cast<int2*>(c + (r + 8) * I_PITCH + cc) =
            make_int2(acc[mt][4 * i + 2], acc[mt][4 * i + 3]);
      }
    }
    asm volatile("bar.sync 1, 256;" ::: "memory");
    const bool vec_out = N % 4 == 0;
    for (int e = tid; e < TM * (TN / 4); e += 256) {
      const int r = e / (TN / 4), ch = e % (TN / 4);
      const int m = m0 + r, o = n0 + 4 * ch;
      if (m >= M || o >= N) continue;
      const int* src = c + r * I_PITCH + 4 * ch;
      int* dst = static_cast<int*>(y) + (size_t)m * N + o;
      if (vec_out) {
        *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
      } else {
        for (int k = 0; k < 4 && o + k < N; ++k) dst[k] = src[k];
      }
    }
    return;
  }
  __nv_bfloat16* c = reinterpret_cast<__nv_bfloat16*>(ring);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r = (wg * MT + mt) * 64 + warp * 16 + g;
    // bf16(xs[m]) of the thread's two rows (0 past M: their outputs are dropped)
    const float x0 = m0 + r < M ? __bfloat162float(__float2bfloat16(__ldg(xs + m0 + r))) : 0.f;
    const float x1 =
        m0 + r + 8 < M ? __bfloat162float(__float2bfloat16(__ldg(xs + m0 + r + 8))) : 0.f;
#pragma unroll
    for (int i = 0; i < TN / 8; ++i) {
      const int cc = 8 * i + 2 * q;
      const float s0 = n0 + cc < N ? __ldg(s_out + n0 + cc) : 0.f;
      const float s1 = n0 + cc + 1 < N ? __ldg(s_out + n0 + cc + 1) : 0.f;
      // y = bf16(bf16(float(acc) * s_out[n]) * bf16(xs[m])), qmm_i8_direct.cu's epilogue
      auto out = [&](int a32, float so, float rs) {
        const __nv_bfloat16 scaled = __float2bfloat16(__fmul_rn(__int2float_rn(a32), so));
        return __float2bfloat16(__fmul_rn(__bfloat162float(scaled), rs));
      };
      __nv_bfloat162 v0, v1;
      v0.x = out(acc[mt][4 * i], s0, x0);
      v0.y = out(acc[mt][4 * i + 1], s1, x0);
      v1.x = out(acc[mt][4 * i + 2], s0, x1);
      v1.y = out(acc[mt][4 * i + 3], s1, x1);
      *reinterpret_cast<__nv_bfloat162*>(c + r * C_PITCH + cc) = v0;
      *reinterpret_cast<__nv_bfloat162*>(c + (r + 8) * C_PITCH + cc) = v1;
    }
  }
  asm volatile("bar.sync 1, 256;" ::: "memory");
  const bool vec_out = N % 8 == 0;
  for (int e = tid; e < TM * (TN / 8); e += 256) {
    const int r = e / (TN / 8), ch = e % (TN / 8);
    const int m = m0 + r, o = n0 + 8 * ch;
    if (m >= M || o >= N) continue;
    const __nv_bfloat16* src = c + r * C_PITCH + 8 * ch;
    __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(y) + (size_t)m * N + o;
    if (vec_out) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int k = 0; k < 8 && o + k < N; ++k) dst[k] = src[k];
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

template <int MT>
int launch(const void* x8, const void* packed, const void* ratio, const void* s_out,
           const void* xs, const void* code, void* y, int M, int K, int N, int B,
           cudaStream_t stream) {
  using T = Tile<MT>;
  const EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {TKP, T::TM};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(x8), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = qmm_nf4_w8a8_wgmma_kernel<MT>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((M + T::TM - 1) / T::TM, (N + TN - 1) / TN);
  kernel<<<grid, THREADS, T::SMEM_BYTES, stream>>>(
      xmap, static_cast<const uint8_t*>(packed), static_cast<const float*>(ratio),
      static_cast<const float*>(s_out), static_cast<const float*>(xs),
      static_cast<const float*>(code), y, M, K, N, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x8 int8 [M, K] row-major at a 16-byte address, K % 32 == 0; packed u8
// [K/2, N] at an 8-byte address and ratio f32 [K/B, N] at a 16-byte one, N
// and B multiples of 8; code f32 [16]; s_out f32 [N] and xs f32 [M],
// or both null for the raw accumulators; y bf16 [M, N], or int32 [M, N] when
// s_out is null.  The plan's constants (ops/qmatmul.py: w8a8_tile_plan):
// `tm` rows a CTA (128 or 256), `stages` k-steps in the ring and `smem` bytes
// of dynamic shared memory, checked against the kernel's own.  Returns the
// launch's cudaError_t (cudaErrorInvalidValue for a shape, alignment or plan
// the kernel does not take, or when the tensor map cannot be made).
extern "C" int qmm_nf4_w8a8_wgmma(const void* x8, const void* packed, const void* ratio,
                                  const void* s_out, const void* xs, const void* code, void* y,
                                  int M, int K, int N, int block_size, int tm, int stages,
                                  int smem, void* stream) {
  const bool two = tm == Tile<2>::TM;
  const auto at = [](const void* p, int n) { return reinterpret_cast<uintptr_t>(p) % n == 0; };
  if (M <= 0 || K <= 0 || N <= 0 || K % 32 || N % 8 || block_size <= 0 || block_size % ROWS ||
      K % (2 * block_size) || (tm != Tile<1>::TM && !two) ||
      stages != (two ? Tile<2>::STAGES : Tile<1>::STAGES) ||
      smem != (two ? Tile<2>::SMEM_BYTES : Tile<1>::SMEM_BYTES) || !at(x8, 16) ||
      !at(packed, 8) || !at(ratio, 16) || (s_out == nullptr) != (xs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return two ? launch<2>(x8, packed, ratio, s_out, xs, code, y, M, K, N, block_size, s)
             : launch<1>(x8, packed, ratio, s_out, xs, code, y, M, K, N, block_size, s);
}
