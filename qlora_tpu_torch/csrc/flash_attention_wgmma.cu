// Flash attention for training and the no-cache forward on Hopper's wgmma:
// the forward with its lse residual, and the two backward kernels (dq; dk
// and dv), fed by TMA, with the score tile kept in registers.
//
// Replaces the TPU kernels qlora_tpu/ops/flash_attention.py::_flash_fwd
// (def at :196, pallas_call at :224) and ::_flash_bwd (def at :419; the dq
// pallas_call at :449, the dk, dv one at :476).  flash_attention.cu, the
// first port of the same kernels (WMMA, the scores through shared memory),
// stays beside this source as its "before".
//
// Layout: q, o, do, dq bf16 [B, H, Sq, D]; k, v, dk, dv bf16 [B, KVH, Skv, D]
// with KVH | H (query head h reads kv head h / (H / KVH)); each is read or
// written through its own strides (b, h, s in elements, the last dim
// contiguous, each stride a multiple of 8), so the model's transposed views
// go in and come out without a copy.  kv_lengths int32 [B]; lse and di f32
// [B, H, Sq], contiguous.  Key `col` is visible to query `row` when
//   row < Sq  &&  col < kv_lengths[b]  &&  (!causal || col <= row)  &&
//   (!window || row - col < window).
// A row with no visible key gets o = 0 and lse = 3e38, so the backward's
// p = exp(s - lse) is 0 and its gradients are exactly 0; keys past a row's
// length get exactly zero dk and dv.  lse is in nats at the interface; the
// kernels work in base 2 inside (log2(e) * sm_scale folded into one FMA).
//
// Arithmetic, as the TPU kernels: bf16 operands, f32 accumulation, f32
// softmax statistics; the probabilities are rounded to bf16 for the p v and
// p^T do products, ds = p (dp - di) sm_scale is rounded to bf16 for ds k and
// ds^T q, the output is normalised once at the end.  di = sum(o do) - dlse
// is computed by the caller.
//
// What bounds them on an H100: at training lengths (S in the hundreds) each
// kernel reads and writes a few tensors of B H S D bf16 once, which takes
// longer at 3.35 TB/s than its 4 (forward), 6 (dq) or 8 (dk, dv) x D
// operations per visible (query, key) pair at 989 TFLOP/s; from S of a few
// thousand the tensor cores bound them.
//
// Design (one CTA of 384 threads: two consumer warpgroups and a producer
// warpgroup whose first warp issues the loads; setmaxnreg moves registers
// from the producer, 24 a thread, to the consumers, 240):
// - TMA: every operand through a 4-D tensor map {D, S, heads, B} over its
//   strides, boxes of 64 columns (128 bytes, the 128-byte swizzle) by a
//   tile's rows; S is a dimension of its own, so rows past S arrive as
//   zeros, never as the next head's rows.  A tile of D = 128 is two boxes.
// - forward: a CTA owns 128 query rows of one (b, h), each consumer
//   warpgroup 64 of them.  The producer loads the Q tile once, then keeps a
//   ring of K and V tiles (64 keys each) in flight.  Per kv tile a
//   warpgroup runs S = Q K^T (wgmma, both operands K-major in shared
//   memory) into f32 registers, then the online softmax in those registers
//   (row maxima and sums over the lane quad that shares a row, exp2), and
//   converts P in place to bf16: the f32 accumulator layout of a 64 x 16
//   slice of S is the register layout of a wgmma A operand, so P feeds
//   O += P V (wgmma, A from registers, V [keys][D] read MN-major with the
//   transpose bit) with no shuffle and no shared memory.  The rescale of O
//   by exp2(m_old - m_new) is a multiply on its registers.
// - dq: the same CTA shape; Q, dO once, a ring of K and V tiles of 64 keys.
//   S = Q K^T and dP = dO V^T (both K-major), p and ds in registers,
//   dQ += dS K (A from registers, K MN-major).
// - dk, dv: a CTA owns 64 or 128 keys of one (b, kv head) and walks the
//   query tiles of 64 rows that can see them, for each of the G query heads
//   in turn; the producer brings Q, dO and the tile's lse, di through the
//   ring.  Per step: S^T = K Q^T and dP^T = V dO^T (K-major), P^T and dS^T
//   in registers, dV += P^T dO and dK += dS^T Q (A from registers, dO and Q
//   MN-major).  With 128 keys each consumer warpgroup owns 64 of them; with
//   64 (the plan's choice where a kv head serves several query heads: each
//   CTA then walks G times the steps, and 128-key CTAs would leave most of
//   the card idle) both take alternate steps over the same keys and at the
//   end the second warpgroup's sums go through shared memory to the first,
//   which adds them.  Either way: no atomics, one fixed order of summation
//   (fixed by the heads, not by B), the same bits in every run.
// - Tiles wholly outside the visible region are never loaded; the mask is
//   applied only on the tiles that a length, causal or window edge crosses
//   (tile_full), the others skip the test.  The CTAs of the longest query
//   tiles (the last, when causal) are launched first.
// - No thread writes a wgmma operand to shared memory (P and dS stay in
//   registers), so no proxy fence is needed.  The epilogue rounds to bf16,
//   stages a warpgroup's 64 rows in the shared memory its Q (or K, V) tile
//   held and stores them with 16-byte stores, masked at the sequence end.
// - Head dim 256 (the Gemma presets): a warpgroup's 64 x 256 f32 accumulator
//   is 128 registers a thread, so each kernel keeps one accumulator of that
//   width a thread.  The forward is the same kernel (O is m64n256).  dq keeps
//   its 128 query rows a CTA but takes kv tiles of 32 keys, so that Q, dO
//   and three stages fit in shared memory (230,656 bytes).  dk, dv cannot hold
//   both sums (256 registers): a CTA owns 64 keys and both consumer
//   warpgroups walk every step, warpgroup 0 summing dV += P^T dO and
//   warpgroup 1 dK += dS^T Q, each recomputing S^T = K Q^T (warpgroup 1
//   also dP^T); a ring of 2 steps, whose lse and di rows sit after the
//   tiles.  Still no atomics and one order of summation.
// - The tile sizes and ring depths below are checked against the plan the
//   caller launches from (ops/flash_attention.py: flash_plan).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 384;            // warpgroups 0, 1 consume; 2 produces
constexpr int FWD_BQ = 128;             // forward: query rows of a CTA
constexpr int FWD_BK = 64;              // forward: keys of a kv tile
constexpr int FWD_STAGES = 2;           // forward: kv tiles in the ring
constexpr int DQ_BQ = 128;              // dq: query rows of a CTA
constexpr int DQ_BK = 64;               // dq: keys of a kv tile
constexpr int DQ_STAGES = 3;            // dq: kv tiles in the ring
constexpr int DKV_BQ = 64;              // dk, dv: query rows of a step
constexpr int DKV_FEW_KEYS = 64;        // dk, dv: keys of a CTA with grouped query heads
constexpr int DKV_MANY_KEYS = 128;      // dk, dv: keys of a CTA with one query head a kv head
constexpr int DKV_STAGES = 4;           // dk, dv: steps in the ring
constexpr int WIDE_D = 256;             // the head dim whose kernels take the tiles below
constexpr int DQ_WIDE_BK = 32;          // dq at WIDE_D: keys of a kv tile
constexpr int DKV_WIDE_KEYS = 64;       // dk, dv at WIDE_D: keys of a CTA, dV and dK split
constexpr int DKV_WIDE_STAGES = 2;      // dk, dv at WIDE_D: steps in the ring
constexpr int BAR_BYTES = 256;          // the mbarriers, after the tiles
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float EMPTY_LSE = 3e38f;

// The shared memory of each kernel: 1024 bytes to align the tiles to the
// 128-byte swizzle's period, the tiles, the ring, the barriers
template <int D>
struct Fwd {
  static constexpr int Q_BYTES = FWD_BQ * D * 2;
  static constexpr int KV_BYTES = FWD_BK * D * 2;
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int SMEM = 1024 + Q_BYTES + FWD_STAGES * STAGE_BYTES + BAR_BYTES;
  static_assert(SMEM <= 232448, "227 KB a block");
  static_assert((2 * FWD_STAGES + 1) * 8 <= BAR_BYTES, "barriers");
};

template <int D>
struct Dq {
  static constexpr int BK = D == WIDE_D ? DQ_WIDE_BK : DQ_BK;   // keys of a kv tile
  static constexpr int Q_BYTES = DQ_BQ * D * 2;     // Q, and dO beside it
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + DQ_STAGES * STAGE_BYTES + BAR_BYTES;
  static_assert(SMEM <= 232448, "227 KB a block");
  static_assert((2 * DQ_STAGES + 1) * 8 <= BAR_BYTES, "barriers");
};

template <int D, int KEYS>
struct Dkv {
  static constexpr int KV_BYTES = KEYS * D * 2;       // K, and V beside it
  static constexpr int T_BYTES = DKV_BQ * D * 2;      // a step's Q, and its dO
  static constexpr int STAGE_BYTES = 2 * T_BYTES + 2 * DKV_BQ * 4;   // + lse, di
  static constexpr int SMEM = 1024 + 2 * KV_BYTES + DKV_STAGES * STAGE_BYTES + BAR_BYTES;
  static_assert(SMEM <= 232448, "227 KB a block");
  static_assert((2 * DKV_STAGES + 1) * 8 <= BAR_BYTES, "barriers");
  static_assert(KEYS == 64 || KEYS == 128, "one or two warpgroups of keys");
  // the second warpgroup's dK and dV sums, f32, reuse the ring
  static_assert(KEYS != 64 || D * 512 <= DKV_STAGES * STAGE_BYTES, "partial sums");
};

// dk, dv at WIDE_D: the ring holds 1024-aligned tiles, the steps' lse and di
// rows follow it
template <int D>
struct DkvWide {
  static constexpr int KV_BYTES = DKV_WIDE_KEYS * D * 2;   // K, and V beside it
  static constexpr int T_BYTES = DKV_BQ * D * 2;           // a step's Q, and its dO
  static constexpr int STAGE_BYTES = 2 * T_BYTES;
  static constexpr int ROW_BYTES = 2 * DKV_BQ * 4;         // a step's lse and di
  static constexpr int SMEM =
      1024 + 2 * KV_BYTES + DKV_WIDE_STAGES * (STAGE_BYTES + ROW_BYTES) + BAR_BYTES;
  static_assert(SMEM <= 232448, "227 KB a block");
  static_assert((2 * DKV_WIDE_STAGES + 1) * 8 <= BAR_BYTES, "barriers");
  static_assert(STAGE_BYTES % 1024 == 0, "tiles aligned to the swizzle's period");
};

struct Strides {   // of a [B, heads, S, D] operand, in elements
  long long b, h, s;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
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

// one box of a 4-D tensor map: columns c0.., rows c1.. of head c2, batch c3
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// a wgmma shared-memory descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// a tile of `rows` rows stored as boxes of 64 columns: the k16 slice kk of
// its contraction over the columns (K-major: S = A B^T with both row-major)
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows, int kk) {
  return gmma_desc(tile + (kk >> 2) * rows * 128 + (kk & 3) * 32, 16, 1024);
}

// the same tile as a B operand contracted over its rows (MN-major, read
// with the transpose bit): rows 16 kk .. 16 kk + 15, all its columns
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int rows, int kk) {
  return gmma_desc(tile + kk * 16 * 128, rows * 128, 1024);
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

// keep the compiler from moving register reads or writes across the
// asynchronous wgmma that owns these registers
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

template <int REGS>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(REGS));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float xor_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float xor_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ bool visible(int row, int col, int Sq, int n, int causal, int window) {
  return row < Sq && col < n && (!causal || col <= row) && (window <= 0 || row - col < window);
}

// every (row, col) of rows r0 .. r0 + rows - 1 and cols c0 .. c0 + cols - 1
// is visible: the tile needs no mask
__device__ __forceinline__ bool tile_full(int r0, int rows, int c0, int cols, int Sq, int n,
                                          int causal, int window) {
  return c0 + cols <= n && r0 + rows <= Sq && (!causal || c0 + cols - 1 <= r0) &&
         (window <= 0 || r0 + rows - 1 - c0 < window);
}

// the kv tiles of `bk` keys that query rows r0 .. r0 + rows - 1 can see: [first, last)
__device__ __forceinline__ void kv_tiles(int r0, int rows, int Sq, int n, int causal, int window,
                                         int bk, int& first, int& last) {
  const int hi = causal ? min(n, min(r0 + rows, Sq)) : n;
  const int lo = window > 0 ? max(0, r0 - window + 1) : 0;
  first = lo / bk;
  last = hi > lo ? (hi + bk - 1) / bk : first;
}

// the query tiles of `bq` rows that can see a key of k0 .. k0 + keys - 1: [first, last)
__device__ __forceinline__ void q_tiles(int k0, int keys, int Sq, int n, int causal, int window,
                                        int bq, int& first, int& last) {
  const int ce = min(k0 + keys, n);
  const int lo = causal ? k0 : 0;
  const int hi = window > 0 ? min(Sq, ce - 1 + window) : Sq;
  first = lo / bq;
  last = ce > k0 && hi > lo ? (hi + bq - 1) / bq : first;
}

// the accumulator layout of wgmma m64nN: thread (warp w, lane 4 g + q) holds
// d[4 j + e] at row 16 w + g + 8 (e >> 1), column 8 j + 2 q + (e & 1)

// masked scores of a forward tile: -inf where a key is not visible
template <int N>
__device__ __forceinline__ void mask_scores(float (&s)[N / 2], int row, int col, int Sq, int n,
                                            int causal, int window) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (!visible(row + 8 * (e >> 1), col + 8 * j + (e & 1), Sq, n, causal, window))
        s[4 * j + e] = -INFINITY;
}

template <int N>
struct Mma;

template <>
struct Mma<32> {
  // d[16] (+)= A (64 x 16, K-major in shared memory) * B (16 x 32, K-major)
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct Mma<64> {
  // d[32] (+)= A (64 x 16, K-major in shared memory) * B (16 x 64, K-major)
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc));
  }
  // d[32] += A (64 x 16, bf16 pairs in registers) * B (16 x 64, MN-major: transposed)
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Mma<128> {
  // d[64] (+)= A (64 x 16, K-major in shared memory) * B (16 x 128, K-major)
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(acc));
  }
  // d[64] += A (64 x 16, bf16 pairs in registers) * B (16 x 128, MN-major: transposed)
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <>
struct Mma<256> {
  // d[128] += A (64 x 16, bf16 pairs in registers) * B (16 x 256, MN-major: transposed)
  static __device__ __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// the online softmax of one kv tile, in the registers of S: row maxima and
// sums over the quad of lanes that shares a row, p = exp2(s c - m) with m
// in units of log2, the sums and O rescaled by exp2(m_old - m_new), and P
// rounded to bf16 in the register layout of a wgmma A operand (k16 slice
// kk: d[8 kk .. 8 kk + 7], paired)
template <int BK, int D>
__device__ __forceinline__ void fwd_softmax(const float (&s)[BK / 2], float (&o)[D / 2],
                                            uint32_t (&p)[BK / 16][4], float (&m)[2],
                                            float (&l)[2], float c) {
  float x[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    x[0] = fmaxf(x[0], fmaxf(s[4 * j], s[4 * j + 1]));
    x[1] = fmaxf(x[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float u[2], alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], xor_max(x[r]) * c);
    u[r] = m_new == -INFINITY ? 0.f : m_new;   // a row that has seen no key yet
    alpha[r] = ex2(m[r] - u[r]);
    m[r] = m_new;
  }
  float t[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    const float e0 = ex2(fmaf(s[4 * j], c, -u[0])), e1 = ex2(fmaf(s[4 * j + 1], c, -u[0]));
    const float e2 = ex2(fmaf(s[4 * j + 2], c, -u[1])), e3 = ex2(fmaf(s[4 * j + 3], c, -u[1]));
    t[0] += e0 + e1;
    t[1] += e2 + e3;
    p[j / 2][(j & 1) * 2] = pack_bf16(e0, e1);
    p[j / 2][(j & 1) * 2 + 1] = pack_bf16(e2, e3);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + t[r];   // this thread's columns
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

// dq's p and ds of one kv tile: p = exp2(s c - lse log2 e), 0 where masked;
// ds = p (dp - di) sm_scale rounded to bf16 in the A operand's layout
template <int BK>
__device__ __forceinline__ void dq_probs(const float (&s)[BK / 2], const float (&dp)[BK / 2],
                                         uint32_t (&ds)[BK / 16][4], bool masked, int row,
                                         int col, const float (&lse2)[2], const float (&di)[2],
                                         float c, float sm_scale, int Sq, int n, int causal,
                                         int window) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float p = ex2(fmaf(s[4 * j + e], c, -lse2[r]));
      if (masked && !visible(row + 8 * r, col + 8 * j + (e & 1), Sq, n, causal, window)) p = 0.f;
      v[e] = p * (dp[4 * j + e] - di[r]) * sm_scale;
    }
    ds[j / 2][(j & 1) * 2] = pack_bf16(v[0], v[1]);
    ds[j / 2][(j & 1) * 2 + 1] = pack_bf16(v[2], v[3]);
  }
}

// dk, dv's P^T and dS^T of one step: rows are keys, columns query rows,
// whose lse (times log2 e) and di come from shared memory
template <int BQ>
__device__ __forceinline__ void dkv_probs(const float (&s)[BQ / 2], const float (&dp)[BQ / 2],
                                          uint32_t (&pt)[BQ / 16][4], uint32_t (&dst)[BQ / 16][4],
                                          bool masked, int key, int qrow0, int q,
                                          const float* lse2, const float* di, float c,
                                          float sm_scale, int Sq, int n, int causal, int window) {
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    float pv[4], dv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * q + (e & 1);
      float p = ex2(fmaf(s[4 * j + e], c, -lse2[col]));
      if (masked && !visible(qrow0 + col, key + 8 * (e >> 1), Sq, n, causal, window)) p = 0.f;
      pv[e] = p;
      dv[e] = p * (dp[4 * j + e] - di[col]) * sm_scale;
    }
    pt[j / 2][(j & 1) * 2] = pack_bf16(pv[0], pv[1]);
    pt[j / 2][(j & 1) * 2 + 1] = pack_bf16(pv[2], pv[3]);
    dst[j / 2][(j & 1) * 2] = pack_bf16(dv[0], dv[1]);
    dst[j / 2][(j & 1) * 2 + 1] = pack_bf16(dv[2], dv[3]);
  }
}

// P^T alone (dk, dv at WIDE_D: the warpgroup that sums dV needs no dP^T)
template <int BQ>
__device__ __forceinline__ void dkv_p(const float (&s)[BQ / 2], uint32_t (&pt)[BQ / 16][4],
                                      bool masked, int key, int qrow0, int q, const float* lse2,
                                      float c, int Sq, int n, int causal, int window) {
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    float pv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * q + (e & 1);
      float p = ex2(fmaf(s[4 * j + e], c, -lse2[col]));
      if (masked && !visible(qrow0 + col, key + 8 * (e >> 1), Sq, n, causal, window)) p = 0.f;
      pv[e] = p;
    }
    pt[j / 2][(j & 1) * 2] = pack_bf16(pv[0], pv[1]);
    pt[j / 2][(j & 1) * 2 + 1] = pack_bf16(pv[2], pv[3]);
  }
}

// a warpgroup's 64 x D accumulator, rounded to bf16, staged in shared memory
// as rows wrow0 .. wrow0 + 63 of a tile of boxes (64 columns, `rows` rows,
// 16-byte chunk c of tile row r at c ^ (r % 8)), then stored as rows row0 ..
// of dst (row stride ss elements), those below nrows, 16 bytes a store
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], uint8_t* tile, int rows,
                                           int wrow0, bf16* __restrict__ dst, long long ss,
                                           int row0, int nrows, int wg) {
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tr = wrow0 + 16 * warp + g + 8 * h;
      uint8_t* at = tile + (j >> 3) * rows * 128 + tr * 128 + (((j & 7) ^ (tr & 7)) << 4) + q * 4;
      *reinterpret_cast<uint32_t*>(at) = pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  named_sync(1 + wg, 128);
  for (int e = t; e < 64 * (D / 8); e += 128) {
    const int r = e / (D / 8), ch = e % (D / 8), tr = wrow0 + r;
    if (row0 + r >= nrows) continue;
    const uint8_t* at = tile + (ch >> 3) * rows * 128 + tr * 128 + (((ch & 7) ^ (tr & 7)) << 4);
    *reinterpret_cast<uint4*>(dst + (row0 + r) * ss + ch * 8) =
        *reinterpret_cast<const uint4*>(at);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, const int* __restrict__ kv_lengths,
                 bf16* __restrict__ o, float* __restrict__ lse, Strides os, int H, int KVH, int Sq,
                 int Skv, float sm_scale, int causal, int window) {
  using L = Fwd<D>;
  constexpr int BQ = FWD_BQ, BK = FWD_BK, ST = FWD_STAGES;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);
  uint8_t* ring = qs + L::Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ST * L::STAGE_BYTES);
  uint64_t* empty = full + ST;
  uint64_t* qbar = empty + ST;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // the longest rows first
  const int kvh = h / (H / KVH);
  const int n = min(max(__ldg(kv_lengths + b), 0), Skv);
  int first, last;
  kv_tiles(r0, BQ, Sq, n, causal, window, BK, first, last);
  const int ntiles = last - first;
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), 8);   // one lane of each consumer warp
    }
    mbar_init(smem_u32(qbar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // ---- producer: the Q tile once, then the ring of K and V tiles ----
    regs_dec<24>();
    if (tid == 256 && ntiles > 0) {
      mbar_arrive_tx(smem_u32(qbar), L::Q_BYTES);
      for (int c = 0; c < D / 64; ++c)
        tma_load_4d(smem_u32(qs + c * BQ * 128), &qmap, smem_u32(qbar), 64 * c, r0, h, b);
      for (int i = 0; i < ntiles; ++i) {
        const int st = i % ST;
        mbar_wait(smem_u32(empty + st), ((i / ST) & 1) ^ 1);
        const uint32_t bar = smem_u32(full + st);
        uint8_t* ks = ring + st * L::STAGE_BYTES;
        const int c0 = (first + i) * BK;
        mbar_arrive_tx(bar, L::STAGE_BYTES);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(smem_u32(ks + c * BK * 128), &kmap, bar, 64 * c, c0, kvh, b);
          tma_load_4d(smem_u32(ks + L::KV_BYTES + c * BK * 128), &vmap, bar, 64 * c, c0, kvh, b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each ----
  regs_inc<240>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int row = r0 + 64 * wg + 16 * warp + g;   // and row + 8
  const float c = sm_scale * LOG2E;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  if (ntiles > 0) mbar_wait(smem_u32(qbar), 0);
  const uint32_t qa = smem_u32(qs) + wg * 64 * 128;
  for (int i = 0; i < ntiles; ++i) {
    const int st = i % ST;
    const int c0 = (first + i) * BK;
    mbar_wait(smem_u32(full + st), (i / ST) & 1);
    const uint32_t ka = smem_u32(ring + st * L::STAGE_BYTES), va = ka + L::KV_BYTES;
    float s[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Mma<BK>::ss(s, kmajor(qa, BQ, kk), kmajor(ka, BK, kk), kk);
    wgmma_commit();
    wgmma_wait_all();
    pin(s);
    if (!tile_full(r0, BQ, c0, BK, Sq, n, causal, window))
      mask_scores<BK>(s, row, c0 + 2 * q, Sq, n, causal, window);
    uint32_t p[BK / 16][4];
    fwd_softmax<BK, D>(s, acc, p, m, l, c);
    pin(acc);
    pin(p);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) Mma<D>::rs(acc, p[kk], mnmajor(va, BK, kk));
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
    if (lane == 0) mbar_arrive(smem_u32(empty + st));
  }

  // epilogue: o = acc / l once, lse = m ln 2 + log l (nats)
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = xor_sum(l[r]);
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;   // no visible key: o = 0
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[4 * j] *= inv[0];
    acc[4 * j + 1] *= inv[0];
    acc[4 * j + 2] *= inv[1];
    acc[4 * j + 3] *= inv[1];
  }
  if (q == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row + 8 * r < Sq)
        lse[((size_t)b * H + h) * Sq + row + 8 * r] =
            l[r] > 0.f ? m[r] * LN2 + logf(l[r]) : EMPTY_LSE;
  store_rows<D>(acc, qs, BQ, 64 * wg, o + b * os.b + h * os.h, os.s, r0 + 64 * wg, Sq, wg);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_dq_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
                const int* __restrict__ kv_lengths, const float* __restrict__ lse,
                const float* __restrict__ di, bf16* __restrict__ dq, Strides dqs, int H, int KVH,
                int Sq, int Skv, float sm_scale, int causal, int window) {
  using L = Dq<D>;
  constexpr int BQ = DQ_BQ, BK = L::BK, ST = DQ_STAGES;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);
  uint8_t* dos = qs + L::Q_BYTES;
  uint8_t* ring = dos + L::Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ST * L::STAGE_BYTES);
  uint64_t* empty = full + ST;
  uint64_t* qbar = empty + ST;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // the longest rows first
  const int kvh = h / (H / KVH);
  const int n = min(max(__ldg(kv_lengths + b), 0), Skv);
  int first, last;
  kv_tiles(r0, BQ, Sq, n, causal, window, BK, first, last);
  const int ntiles = last - first;
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), 8);
    }
    mbar_init(smem_u32(qbar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // ---- producer: Q and dO once, then the ring of K and V tiles ----
    regs_dec<24>();
    if (tid == 256 && ntiles > 0) {
      const uint32_t qb = smem_u32(qbar);
      mbar_arrive_tx(qb, 2 * L::Q_BYTES);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(smem_u32(qs + c * BQ * 128), &qmap, qb, 64 * c, r0, h, b);
        tma_load_4d(smem_u32(dos + c * BQ * 128), &domap, qb, 64 * c, r0, h, b);
      }
      for (int i = 0; i < ntiles; ++i) {
        const int st = i % ST;
        mbar_wait(smem_u32(empty + st), ((i / ST) & 1) ^ 1);
        const uint32_t bar = smem_u32(full + st);
        uint8_t* ks = ring + st * L::STAGE_BYTES;
        const int c0 = (first + i) * BK;
        mbar_arrive_tx(bar, L::STAGE_BYTES);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(smem_u32(ks + c * BK * 128), &kmap, bar, 64 * c, c0, kvh, b);
          tma_load_4d(smem_u32(ks + L::KV_BYTES + c * BK * 128), &vmap, bar, 64 * c, c0, kvh, b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each ----
  regs_inc<240>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int row = r0 + 64 * wg + 16 * warp + g;   // and row + 8
  const float c = sm_scale * LOG2E;
  const size_t off = ((size_t)b * H + h) * Sq;
  float lse2[2], dif[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {   // rows past Sq: p = 0
    lse2[r] = row + 8 * r < Sq ? __ldg(lse + off + row + 8 * r) * LOG2E : INFINITY;
    dif[r] = row + 8 * r < Sq ? __ldg(di + off + row + 8 * r) : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  if (ntiles > 0) mbar_wait(smem_u32(qbar), 0);
  const uint32_t qa = smem_u32(qs) + wg * 64 * 128, da = smem_u32(dos) + wg * 64 * 128;
  for (int i = 0; i < ntiles; ++i) {
    const int st = i % ST;
    const int c0 = (first + i) * BK;
    mbar_wait(smem_u32(full + st), (i / ST) & 1);
    const uint32_t ka = smem_u32(ring + st * L::STAGE_BYTES), va = ka + L::KV_BYTES;
    float s[BK / 2], dp[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      Mma<BK>::ss(s, kmajor(qa, BQ, kk), kmajor(ka, BK, kk), kk);
      Mma<BK>::ss(dp, kmajor(da, BQ, kk), kmajor(va, BK, kk), kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(s);
    pin(dp);
    uint32_t ds[BK / 16][4];
    dq_probs<BK>(s, dp, ds, !tile_full(r0, BQ, c0, BK, Sq, n, causal, window), row,
                 c0 + 2 * q, lse2, dif, c, sm_scale, Sq, n, causal, window);
    pin(acc);
    pin(ds);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) Mma<D>::rs(acc, ds[kk], mnmajor(ka, BK, kk));
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
    if (lane == 0) mbar_arrive(smem_u32(empty + st));
  }
  store_rows<D>(acc, qs, BQ, 64 * wg, dq + b * dqs.b + h * dqs.h, dqs.s, r0 + 64 * wg, Sq, wg);
}

template <int D, int KEYS>
__global__ void __launch_bounds__(THREADS, 1)
flash_dkv_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
                 const int* __restrict__ kv_lengths, const float* __restrict__ lse,
                 const float* __restrict__ di, bf16* __restrict__ dk, bf16* __restrict__ dv,
                 Strides dks, Strides dvs, int H, int KVH, int Sq, int Skv, float sm_scale,
                 int causal, int window) {
  using L = Dkv<D, KEYS>;
  constexpr int BQ = DKV_BQ, ST = DKV_STAGES;
  constexpr bool SPLIT = KEYS == 64;   // both warpgroups on the same keys, alternate steps
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* ks = align1024(smem_raw);
  uint8_t* vs = ks + L::KV_BYTES;
  uint8_t* ring = vs + L::KV_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ST * L::STAGE_BYTES);
  uint64_t* empty = full + ST;
  uint64_t* kvbar = empty + ST;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / KVH, kvh = blockIdx.x % KVH;
  const int k0 = blockIdx.y * KEYS;   // causal: the first keys have the most rows
  const int G = H / KVH;
  const int n = min(max(__ldg(kv_lengths + b), 0), Skv);
  int first, last;
  q_tiles(k0, KEYS, Sq, n, causal, window, BQ, first, last);
  const int nt = last - first;
  const int nsteps = G * nt;   // step i: query head kvh G + i / nt, tile first + i % nt
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(smem_u32(full + s), 32);             // the producer warp's lanes
      mbar_init(smem_u32(empty + s), SPLIT ? 4 : 8);  // one lane of each consumer warp
    }
    mbar_init(smem_u32(kvbar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // ---- producer warp: K and V once, then each step's Q, dO (TMA) and
    // lse (times log2 e) and di (its lanes) through the ring ----
    regs_dec<24>();
    if (tid < 288 && nsteps > 0) {
      const int lane = tid & 31;
      if (lane == 0) {
        mbar_arrive_tx(smem_u32(kvbar), 2 * L::KV_BYTES);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(smem_u32(ks + c * KEYS * 128), &kmap, smem_u32(kvbar), 64 * c, k0, kvh, b);
          tma_load_4d(smem_u32(vs + c * KEYS * 128), &vmap, smem_u32(kvbar), 64 * c, k0, kvh, b);
        }
      }
      for (int i = 0; i < nsteps; ++i) {
        const int st = i % ST;
        const int hq = kvh * G + i / nt, r0 = (first + i % nt) * BQ;
        mbar_wait(smem_u32(empty + st), ((i / ST) & 1) ^ 1);
        uint8_t* qt = ring + st * L::STAGE_BYTES;
        float* ls = reinterpret_cast<float*>(qt + 2 * L::T_BYTES);
        const size_t off = ((size_t)b * H + hq) * Sq;
#pragma unroll
        for (int k = 0; k < BQ / 32; ++k) {   // rows past Sq: p = 0
          const int rr = lane + 32 * k, row = r0 + rr;
          ls[rr] = row < Sq ? __ldg(lse + off + row) * LOG2E : INFINITY;
          ls[BQ + rr] = row < Sq ? __ldg(di + off + row) : 0.f;
        }
        const uint32_t bar = smem_u32(full + st);
        if (lane == 0) {
          mbar_arrive_tx(bar, 2 * L::T_BYTES);
          for (int c = 0; c < D / 64; ++c) {
            tma_load_4d(smem_u32(qt + c * BQ * 128), &qmap, bar, 64 * c, r0, hq, b);
            tma_load_4d(smem_u32(qt + L::T_BYTES + c * BQ * 128), &domap, bar, 64 * c, r0, hq, b);
          }
        } else {
          mbar_arrive(bar);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 keys each (or the same 64, alternate steps) ----
  regs_inc<240>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int krow = SPLIT ? 0 : 64 * wg;          // the warpgroup's keys in the CTA's tile
  const int key = k0 + krow + 16 * warp + g;     // and key + 8
  const float c = sm_scale * LOG2E;
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  if (nsteps > 0) mbar_wait(smem_u32(kvbar), 0);
  const uint32_t ka = smem_u32(ks) + krow * 128, va = smem_u32(vs) + krow * 128;
  for (int i = SPLIT ? wg : 0; i < nsteps; i += SPLIT ? 2 : 1) {
    const int st = i % ST;
    const int r0 = (first + i % nt) * BQ;
    mbar_wait(smem_u32(full + st), (i / ST) & 1);
    uint8_t* qt = ring + st * L::STAGE_BYTES;
    const uint32_t qa = smem_u32(qt), da = qa + L::T_BYTES;
    const float* ls = reinterpret_cast<const float*>(qt + 2 * L::T_BYTES);
    float s[BQ / 2], dp[BQ / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      Mma<BQ>::ss(s, kmajor(ka, KEYS, kk), kmajor(qa, BQ, kk), kk);
      Mma<BQ>::ss(dp, kmajor(va, KEYS, kk), kmajor(da, BQ, kk), kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(s);
    pin(dp);
    uint32_t pt[BQ / 16][4], dst[BQ / 16][4];
    dkv_probs<BQ>(s, dp, pt, dst, !tile_full(r0, BQ, k0, KEYS, Sq, n, causal, window), key, r0,
                  q, ls, ls + BQ, c, sm_scale, Sq, n, causal, window);
    pin(dka);
    pin(dva);
    pin(pt);
    pin(dst);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      Mma<D>::rs(dva, pt[kk], mnmajor(da, BQ, kk));
      Mma<D>::rs(dka, dst[kk], mnmajor(qa, BQ, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(dka);
    pin(dva);
    if (lane == 0) mbar_arrive(smem_u32(empty + st));
  }

  if (SPLIT) {
    // the second warpgroup's sums to the first through the ring, added in
    // this order every run
    const int t = tid & 127;
    float* part = reinterpret_cast<float*>(ring);
    named_sync(3, 256);   // both are done with the ring
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        part[i * 128 + t] = dka[i];
        part[(D / 2 + i) * 128 + t] = dva[i];
      }
    }
    named_sync(3, 256);
    if (wg == 1) return;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      dka[i] += part[i * 128 + t];
      dva[i] += part[(D / 2 + i) * 128 + t];
    }
  }
  store_rows<D>(dka, ks, KEYS, krow, dk + b * dks.b + kvh * dks.h, dks.s, k0 + krow, Skv, wg);
  store_rows<D>(dva, vs, KEYS, krow, dv + b * dvs.b + kvh * dvs.h, dvs.s, k0 + krow, Skv, wg);
}

// dk, dv at WIDE_D: 64 keys a CTA; every step goes to both consumer
// warpgroups, warpgroup 0 summing dV and warpgroup 1 dK, so that each holds
// one 64 x D accumulator
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_dkv_wide_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap domap, const int* __restrict__ kv_lengths,
                      const float* __restrict__ lse, const float* __restrict__ di,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, Strides dks, Strides dvs, int H,
                      int KVH, int Sq, int Skv, float sm_scale, int causal, int window) {
  using L = DkvWide<D>;
  constexpr int BQ = DKV_BQ, KEYS = DKV_WIDE_KEYS, ST = DKV_WIDE_STAGES;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* ks = align1024(smem_raw);
  uint8_t* vs = ks + L::KV_BYTES;
  uint8_t* ring = vs + L::KV_BYTES;
  float* stats = reinterpret_cast<float*>(ring + ST * L::STAGE_BYTES);   // [ST][lse, di][BQ]
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + ST * 2 * BQ);
  uint64_t* empty = full + ST;
  uint64_t* kvbar = empty + ST;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / KVH, kvh = blockIdx.x % KVH;
  const int k0 = blockIdx.y * KEYS;
  const int G = H / KVH;
  const int n = min(max(__ldg(kv_lengths + b), 0), Skv);
  int first, last;
  q_tiles(k0, KEYS, Sq, n, causal, window, BQ, first, last);
  const int nt = last - first;
  const int nsteps = G * nt;   // step i: query head kvh G + i / nt, tile first + i % nt
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(smem_u32(full + s), 32);   // the producer warp's lanes
      mbar_init(smem_u32(empty + s), 8);   // one lane of each consumer warp
    }
    mbar_init(smem_u32(kvbar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // ---- producer warp: K and V once, then each step's Q, dO (TMA) and
    // lse (times log2 e) and di (its lanes) ----
    regs_dec<24>();
    if (tid < 288 && nsteps > 0) {
      const int lane = tid & 31;
      if (lane == 0) {
        mbar_arrive_tx(smem_u32(kvbar), 2 * L::KV_BYTES);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(smem_u32(ks + c * KEYS * 128), &kmap, smem_u32(kvbar), 64 * c, k0, kvh, b);
          tma_load_4d(smem_u32(vs + c * KEYS * 128), &vmap, smem_u32(kvbar), 64 * c, k0, kvh, b);
        }
      }
      for (int i = 0; i < nsteps; ++i) {
        const int st = i % ST;
        const int hq = kvh * G + i / nt, r0 = (first + i % nt) * BQ;
        mbar_wait(smem_u32(empty + st), ((i / ST) & 1) ^ 1);
        uint8_t* qt = ring + st * L::STAGE_BYTES;
        float* ls = stats + st * 2 * BQ;
        const size_t off = ((size_t)b * H + hq) * Sq;
#pragma unroll
        for (int k = 0; k < BQ / 32; ++k) {   // rows past Sq: p = 0
          const int rr = lane + 32 * k, row = r0 + rr;
          ls[rr] = row < Sq ? __ldg(lse + off + row) * LOG2E : INFINITY;
          ls[BQ + rr] = row < Sq ? __ldg(di + off + row) : 0.f;
        }
        const uint32_t bar = smem_u32(full + st);
        if (lane == 0) {
          mbar_arrive_tx(bar, L::STAGE_BYTES);
          for (int c = 0; c < D / 64; ++c) {
            tma_load_4d(smem_u32(qt + c * BQ * 128), &qmap, bar, 64 * c, r0, hq, b);
            tma_load_4d(smem_u32(qt + L::T_BYTES + c * BQ * 128), &domap, bar, 64 * c, r0, hq, b);
          }
        } else {
          mbar_arrive(bar);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: the same 64 keys, every step; 0 sums dV, 1 dK ----
  regs_inc<240>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int key = k0 + 16 * warp + g;   // and key + 8
  const float c = sm_scale * LOG2E;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  if (nsteps > 0) mbar_wait(smem_u32(kvbar), 0);
  const uint32_t ka = smem_u32(ks), va = smem_u32(vs);
  for (int i = 0; i < nsteps; ++i) {
    const int st = i % ST;
    const int r0 = (first + i % nt) * BQ;
    mbar_wait(smem_u32(full + st), (i / ST) & 1);
    const uint32_t qa = smem_u32(ring + st * L::STAGE_BYTES), da = qa + L::T_BYTES;
    const float* ls = stats + st * 2 * BQ;
    const bool masked = !tile_full(r0, BQ, k0, KEYS, Sq, n, causal, window);
    float s[BQ / 2];
    uint32_t a[BQ / 16][4];
    if (wg == 0) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Mma<BQ>::ss(s, kmajor(ka, KEYS, kk), kmajor(qa, BQ, kk), kk);
      wgmma_commit();
      wgmma_wait_all();
      pin(s);
      dkv_p<BQ>(s, a, masked, key, r0, q, ls, c, Sq, n, causal, window);
      pin(acc);
      pin(a);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) Mma<D>::rs(acc, a[kk], mnmajor(da, BQ, kk));
    } else {
      float dp[BQ / 2];
      uint32_t pt[BQ / 16][4];   // unused: dV is the other warpgroup's
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        Mma<BQ>::ss(s, kmajor(ka, KEYS, kk), kmajor(qa, BQ, kk), kk);
        Mma<BQ>::ss(dp, kmajor(va, KEYS, kk), kmajor(da, BQ, kk), kk);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(s);
      pin(dp);
      dkv_probs<BQ>(s, dp, pt, a, masked, key, r0, q, ls, ls + BQ, c, sm_scale, Sq, n, causal,
                    window);
      pin(acc);
      pin(a);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) Mma<D>::rs(acc, a[kk], mnmajor(qa, BQ, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
    if (lane == 0) mbar_arrive(smem_u32(empty + st));
  }

  named_sync(3, 256);   // both are done reading K and V: their tiles stage the sums
  if (wg == 0)
    store_rows<D>(acc, vs, KEYS, 0, dv + b * dvs.b + kvh * dvs.h, dvs.s, k0, Skv, wg);
  else
    store_rows<D>(acc, ks, KEYS, 0, dk + b * dks.b + kvh * dks.h, dks.s, k0, Skv, wg);
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

// an operand [B, heads, S, D] with strides st (b, h, s; elements) as a 4-D
// tensor map {D, S, heads, B}, boxes of 64 columns by `rows` rows, 128-byte
// swizzle, zeros past every edge (an empty S is read as one row of zeros)
bool make_map(CUtensorMap* map, const void* p, int B, int heads, int S, int D,
              const long long* st, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode || reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (int i = 0; i < 3; ++i)
    if (st[i] <= 0 || st[i] % 8) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)(S > 0 ? S : 1), (cuuint64_t)heads,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool out_ok(const void* p, const long long* st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st[0] % 8 == 0 && st[1] % 8 == 0 &&
         st[2] % 8 == 0;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, const void* lens, void* o, void* lse,
               const long long* st, int B, int H, int KVH, int Sq, int Skv, float sm_scale,
               int causal, int window, int rows, int cols, int stages, int smem,
               cudaStream_t stream) {
  using L = Fwd<D>;
  if (rows != FWD_BQ || cols != FWD_BK || stages != FWD_STAGES || smem != L::SMEM ||
      !out_ok(o, st + 9))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, B, H, Sq, D, st, FWD_BQ) || !make_map(&km, k, B, KVH, Skv, D, st + 3, FWD_BK) ||
      !make_map(&vm, v, B, KVH, Skv, D, st + 6, FWD_BK))
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = allow_smem(flash_fwd_kernel<D>, L::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(B * H, (Sq + FWD_BQ - 1) / FWD_BQ);
  flash_fwd_kernel<D><<<grid, THREADS, L::SMEM, stream>>>(
      qm, km, vm, static_cast<const int*>(lens), static_cast<bf16*>(o), static_cast<float*>(lse),
      Strides{st[9], st[10], st[11]}, H, KVH, Sq, Skv, sm_scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* lens, const void* dout,
              const void* lse, const void* di, void* dq, const long long* st, int B, int H,
              int KVH, int Sq, int Skv, float sm_scale, int causal, int window, int rows,
              int cols, int stages, int smem, cudaStream_t stream) {
  using L = Dq<D>;
  if (rows != DQ_BQ || cols != L::BK || stages != DQ_STAGES || smem != L::SMEM ||
      !out_ok(dq, st + 12))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qm, km, vm, dom;
  if (!make_map(&qm, q, B, H, Sq, D, st, DQ_BQ) || !make_map(&km, k, B, KVH, Skv, D, st + 3, L::BK) ||
      !make_map(&vm, v, B, KVH, Skv, D, st + 6, L::BK) ||
      !make_map(&dom, dout, B, H, Sq, D, st + 9, DQ_BQ))
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = allow_smem(flash_dq_kernel<D>, L::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(B * H, (Sq + DQ_BQ - 1) / DQ_BQ);
  flash_dq_kernel<D><<<grid, THREADS, L::SMEM, stream>>>(
      qm, km, vm, dom, static_cast<const int*>(lens), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<bf16*>(dq), Strides{st[12], st[13], st[14]}, H,
      KVH, Sq, Skv, sm_scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int KEYS>
int launch_dkv_keys(const void* q, const void* k, const void* v, const void* lens, const void* dout,
               const void* lse, const void* di, void* dk, void* dv, const long long* st, int B,
               int H, int KVH, int Sq, int Skv, float sm_scale, int causal, int window,
               int stages, int smem, cudaStream_t stream) {
  using L = Dkv<D, KEYS>;
  if (stages != DKV_STAGES || smem != L::SMEM || !out_ok(dk, st + 12) || !out_ok(dv, st + 15))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qm, km, vm, dom;
  if (!make_map(&qm, q, B, H, Sq, D, st, DKV_BQ) || !make_map(&km, k, B, KVH, Skv, D, st + 3, KEYS) ||
      !make_map(&vm, v, B, KVH, Skv, D, st + 6, KEYS) ||
      !make_map(&dom, dout, B, H, Sq, D, st + 9, DKV_BQ))
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = allow_smem(flash_dkv_kernel<D, KEYS>, L::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(B * KVH, (Skv + KEYS - 1) / KEYS);
  flash_dkv_kernel<D, KEYS><<<grid, THREADS, L::SMEM, stream>>>(
      qm, km, vm, dom, static_cast<const int*>(lens), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      Strides{st[12], st[13], st[14]}, Strides{st[15], st[16], st[17]}, H, KVH, Sq, Skv, sm_scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

// the plan's keys a CTA: 64 (both consumer warpgroups on the same keys,
// alternate steps) or 128 (each its own 64)
template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* lens, const void* dout,
               const void* lse, const void* di, void* dk, void* dv, const long long* st, int B,
               int H, int KVH, int Sq, int Skv, float sm_scale, int causal, int window, int rows,
               int cols, int stages, int smem, cudaStream_t stream) {
  if (rows != DKV_BQ) return static_cast<int>(cudaErrorInvalidValue);
  if (cols == DKV_FEW_KEYS)
    return launch_dkv_keys<D, DKV_FEW_KEYS>(q, k, v, lens, dout, lse, di, dk, dv, st, B, H, KVH,
                                            Sq, Skv, sm_scale, causal, window, stages, smem, stream);
  if (cols == DKV_MANY_KEYS)
    return launch_dkv_keys<D, DKV_MANY_KEYS>(q, k, v, lens, dout, lse, di, dk, dv, st, B, H, KVH,
                                             Sq, Skv, sm_scale, causal, window, stages, smem, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dk, dv at WIDE_D: 64 keys a CTA, dV and dK on the two consumer warpgroups
template <int D>
int launch_dkv_wide(const void* q, const void* k, const void* v, const void* lens,
                    const void* dout, const void* lse, const void* di, void* dk, void* dv,
                    const long long* st, int B, int H, int KVH, int Sq, int Skv, float sm_scale,
                    int causal, int window, int rows, int cols, int stages, int smem,
                    cudaStream_t stream) {
  using L = DkvWide<D>;
  if (rows != DKV_BQ || cols != DKV_WIDE_KEYS || stages != DKV_WIDE_STAGES || smem != L::SMEM ||
      !out_ok(dk, st + 12) || !out_ok(dv, st + 15))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qm, km, vm, dom;
  if (!make_map(&qm, q, B, H, Sq, D, st, DKV_BQ) ||
      !make_map(&km, k, B, KVH, Skv, D, st + 3, DKV_WIDE_KEYS) ||
      !make_map(&vm, v, B, KVH, Skv, D, st + 6, DKV_WIDE_KEYS) ||
      !make_map(&dom, dout, B, H, Sq, D, st + 9, DKV_BQ))
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = allow_smem(flash_dkv_wide_kernel<D>, L::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(B * KVH, (Skv + DKV_WIDE_KEYS - 1) / DKV_WIDE_KEYS);
  flash_dkv_wide_kernel<D><<<grid, THREADS, L::SMEM, stream>>>(
      qm, km, vm, dom, static_cast<const int*>(lens), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      Strides{st[12], st[13], st[14]}, Strides{st[15], st[16], st[17]}, H, KVH, Sq, Skv, sm_scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

bool dims_ok(int B, int H, int KVH, int Sq, int Skv) {
  return B > 0 && H > 0 && KVH > 0 && H % KVH == 0 && Sq > 0 && Skv >= 0 &&
         (long long)B * H < (1ll << 31) && (Sq + 63) / 64 < 65536 && (Skv + 63) / 64 < 65536;
}

}  // namespace

// q, k, v, do: bf16 [B, H or KVH, S, D] with the strides given (b, h, s in
// elements each: q, k, v, then o / do, dq, dk, dv as the entry names them),
// the last dim contiguous, every stride a multiple of 8 and every pointer
// 16-byte aligned; lse, di f32 [B, H, Sq] contiguous; kv_lengths int32 [B].
// window <= 0 means no sliding window.  rows, cols, stages and smem are the
// plan's (ops/flash_attention.py: flash_plan): a tile's query rows and keys,
// the ring's depth and the dynamic shared memory, checked against the
// kernel's own.  Every entry returns the launch's cudaError_t
// (cudaErrorInvalidValue for a head dim other than 64, 128 or 256, a plan,
// stride or alignment the kernel does not take, or a tensor map that cannot
// be made).

extern "C" int flash_wgmma_fwd(const void* q, const void* k, const void* v,
                               const void* kv_lengths, void* o, void* lse,
                               const long long* strides, int B, int H, int KVH, int Sq, int Skv,
                               int D, float sm_scale, int causal, int window, int rows, int cols,
                               int stages, int smem, void* stream) {
  if (!dims_ok(B, H, KVH, Sq, Skv)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_fwd<64>(q, k, v, kv_lengths, o, lse, strides, B, H, KVH, Sq, Skv, sm_scale,
                          causal, window, rows, cols, stages, smem, s);
  if (D == 128)
    return launch_fwd<128>(q, k, v, kv_lengths, o, lse, strides, B, H, KVH, Sq, Skv, sm_scale,
                           causal, window, rows, cols, stages, smem, s);
  if (D == WIDE_D)
    return launch_fwd<WIDE_D>(q, k, v, kv_lengths, o, lse, strides, B, H, KVH, Sq, Skv, sm_scale,
                              causal, window, rows, cols, stages, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_wgmma_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* kv_lengths, const void* dout, const void* lse,
                                  const void* di, void* dq, const long long* strides, int B,
                                  int H, int KVH, int Sq, int Skv, int D, float sm_scale,
                                  int causal, int window, int rows, int cols, int stages,
                                  int smem, void* stream) {
  if (!dims_ok(B, H, KVH, Sq, Skv)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_dq<64>(q, k, v, kv_lengths, dout, lse, di, dq, strides, B, H, KVH, Sq, Skv,
                         sm_scale, causal, window, rows, cols, stages, smem, s);
  if (D == 128)
    return launch_dq<128>(q, k, v, kv_lengths, dout, lse, di, dq, strides, B, H, KVH, Sq, Skv,
                          sm_scale, causal, window, rows, cols, stages, smem, s);
  if (D == WIDE_D)
    return launch_dq<WIDE_D>(q, k, v, kv_lengths, dout, lse, di, dq, strides, B, H, KVH, Sq, Skv,
                             sm_scale, causal, window, rows, cols, stages, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_wgmma_bwd_dkv(const void* q, const void* k, const void* v,
                                   const void* kv_lengths, const void* dout, const void* lse,
                                   const void* di, void* dk, void* dv, const long long* strides,
                                   int B, int H, int KVH, int Sq, int Skv, int D, float sm_scale,
                                   int causal, int window, int rows, int cols, int stages,
                                   int smem, void* stream) {
  if (!dims_ok(B, H, KVH, Sq, Skv)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_dkv<64>(q, k, v, kv_lengths, dout, lse, di, dk, dv, strides, B, H, KVH, Sq,
                          Skv, sm_scale, causal, window, rows, cols, stages, smem, s);
  if (D == 128)
    return launch_dkv<128>(q, k, v, kv_lengths, dout, lse, di, dk, dv, strides, B, H, KVH, Sq,
                           Skv, sm_scale, causal, window, rows, cols, stages, smem, s);
  if (D == WIDE_D)
    return launch_dkv_wide<WIDE_D>(q, k, v, kv_lengths, dout, lse, di, dk, dv, strides, B, H, KVH,
                                   Sq, Skv, sm_scale, causal, window, rows, cols, stages, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
