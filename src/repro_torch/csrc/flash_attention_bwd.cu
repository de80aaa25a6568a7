// Backward of the GQA flash attention of flash_attention.cu on Hopper:
// dQ, dK and dV for causal (optionally sliding-window) attention at
// Sq == Sk and for non-causal attention at any Sk, head dims 32, 64, 128
// and 256, in bf16 (tensor cores) and in f32 (CUDA cores).
//
// The port's own kernel: the TPU kernel it pairs with,
// src/repro/kernels/flash_attention/kernel.py :: flash_attention, has no
// backward (nothing in src/repro/kernels/ defines a custom_vjp); the
// reference's training differentiates its jnp causal_flash_attention
// (src/repro/models/layers.py).  It computes the backward of
// kernels/flash_attention/ref.py :: flash_attention_ref by its explicit
// formula (flash_attention_bwd_ref):
//   P = exp(scale Q K^T - lse), recomputed under the forward's mask from
//       the forward's per-row log-sum-exp;
//   dP = dO V^T;  dS = P (dP - D_i), D_i = rowsum(dO * O);
//   dQ = scale dS K;  dK = scale dS^T Q;  dV = P^T dO,
// dK and dV of a KV head summed over its G query heads.
//
// What bounds it on the H100: operations.  Each unmasked (query, key) pair
// costs 10 D flops (Q K^T again, dO V^T, P^T dO, dS^T Q, dS K) against
// ~9 B S H D bytes moved, so from S of a few hundred only the tensor cores
// come near the bound.  This design recomputes S and dP once more for dQ,
// 14 D flops a pair in all: the price of a dQ with no atomics.
//
// What the first design measured (mma.sync fed by cp.async, one
// dK/dV block per 64-key tile, one dQ block per 64-query tile): 1.4628 ms
// through a CUDA graph at the train shape (B=2, S=2048, H=16, KV=2, D=128,
// causal), 5.2x SDPA's backward and 17x the bound.  Its dK/dV grid was 128
// blocks of 4 warps on 132 SMs, and the causal walk made the first key
// tile 32x the last, so the longest block set the pace at 2x the balanced
// length.
//
// What this design does about it.  Three or four launches on one stream,
// all deterministic (no atomics on the data), so that two calls give the
// same bits; the wrapper counts them as one launch of the backward:
//   1. bwd_prep: D_i = rowsum(dO * O) with 16-byte loads (D / 8 lanes a
//      row) and lse log2(e), both f32 into a scratch padded to whole
//      64-row tiles (0 and +inf past Sq, so one TMA bulk copy reads any
//      tile's 256 bytes).  Its last block writes the dK/dV schedule.
//   2. The schedule.  Key tile t of 64 keys walks its G query heads and,
//      for each, the query tiles that reach it: w(t) = G nq(t) iterations
//      in a fixed order.  The host planner (ops.py :: plan_bwd_units) picks
//      a cap T, the balanced share of the card's workers (2 x SMs, or SMs
//      at D = 256: ops.py :: bwd_slots_per_sm); each walk is cut into units
//      of at most T iterations, the
//      full units first in (tile, chunk) order, then the remainders, larger
//      first.  bwd_prep writes the same order as a table from the kernel's
//      scalar arguments alone (one thread a tile, each with a loop over the
//      tiles for its ranks): no host-to-device copy and no host sync, so a
//      call can be captured in a CUDA graph.
//   3. bwd_dq_dkdv_tc (D = 64, 128 and 256): dQ and dK/dV in one
//      persistent launch of one block per SM.  At D = 64 and 128 a block
//      holds two consumer warpgroups, each a worker with jobs of its own,
//      and a producer warpgroup that gives up its registers (setmaxnreg:
//      24 + 2 x 240) and whose warps 8 and 9 feed the two workers by TMA
//      (128-byte swizzle) through rings of mbarrier stages.  At D = 256 the
//      block is one worker that both consumer warpgroups serve (below).
//      The jobs are the dK/dV units (heaviest first) and
//      then the dQ jobs, one per (64 queries, head, batch), the longest
//      causal walks first, dealt round-robin in snake order.  The stage
//      ring runs on across a worker's jobs, and the producer queues a job's
//      first stage before its fixed tiles, so the next job's tiles load
//      while the current one finishes.
//      A dK/dV unit keeps K and V of its 64 keys in shared memory and
//      streams Q, dO, lse and D of each iteration: S^T = K Q^T and
//      dP^T = V dO^T run as wgmma m64n64k16 from shared memory; P^T and
//      dS^T are rounded to bf16 in registers as the A operands of
//      dV += P^T dO and dK += dS^T Q (m64n{D}k16, dO and Q transposed B
//      operands), each issued as soon as its operand is ready, so that dP^T
//      and dV overlap the exponentials.  dK and dV stay f32 in registers
//      across the unit.  A tile with one unit writes bf16 dK and dV itself;
//      each unit of a split tile writes f32 partials to the scratch.
//      A dQ job keeps Q and dO and streams K and V: S = Q K^T and
//      dP = dO V^T from shared memory, dS rounded to bf16 in registers as
//      the A operand of dQ += dS K (K a transposed B operand).
//      D = 256 (gemma-7b).  A 64-row tile pair is 64 KB, so two slots of
//      two stages do not fit, and one warpgroup would hold 256 f32 dK and
//      dV accumulators a thread.  So the block is one worker (Cfg::W = 1,
//      one dK/dV worker an SM for the planner): its slot holds the fixed
//      pair, two 64.5 KB stages and two 64 x 64 f32 exchange tiles, the
//      whole 227 KB, and both consumer warpgroups serve each of its jobs
//      (serve_one), each holding half of the accumulators and computing
//      one of the two 64 x 64 products that the D = 64/128 worker computes
//      both of.  dK/dV: warpgroup 0 computes S^T, forms P^T, passes it to
//      warpgroup 1 through an exchange tile (an mbarrier pair in place of
//      a named barrier) and sums dV += P^T dO; warpgroup 1 computes dP^T,
//      forms dS^T and sums dK += dS^T Q (m64n256k16, 128 accumulators a
//      thread), so S^T is computed once and the two do equal work.  dQ:
//      warpgroup 0 computes S and P, warpgroup 1 dP; each passes its tile
//      to the other, both form the same dS, and each sums half of dQ's
//      columns (m64n128k16).  The producer thread keeps 40 registers and
//      the consumers 232, which take all of the 168 x 384 the block
//      launches with; at 24 the producer spilled.  Each warpgroup releases
//      a job's fixed tiles after its last product that reads them.
//   4. bwd_merge sums each split tile's partials in unit order, scales dK
//      and writes bf16 (only where a tile was split).
// D = 32 (reranker-minilm) keeps the first design's mma.sync kernels
// (bwd_dq_mma, bwd_dkdv_mma: m16n8k16 fed by ldmatrix from a 2-stage
// cp.async ring), under the same schedule, scratch and merge.  Fully masked
// tiles are skipped as the forward skips them (the key walk runs from the
// window's edge to the diagonal, the query walk from the diagonal to the
// window's end); the mask runs only on the tiles it cuts.  Rows past S are
// read as zeros (TMA, or cp.async with a zero source size), masked, and
// never stored.
//
// f32 (f32::bwd_f32, any D of the four): the f32 checks hold to 2e-5, which
// TF32 would miss, so every product is an f32 FMA on the CUDA cores (67
// TFLOP/s, the bound).  A simpler design: bwd_prep_f32 writes D_i (one warp
// a row), then one block per (64 queries, head, batch) sums dQ and one per
// (64 keys, KV head, batch) dK and dV over its G query heads, whole and
// deterministic (no split, no merge, no atomics).  The fixed 64-row tile
// pair stays in shared memory and the other pair streams past in 32-row
// tiles (~217 KB at D = 256); scores and P, dS go through shared memory,
// each thread a 4 x 2 register tile of them and 4 rows x D/16 columns of
// each output.
//
// What it measured (NVIDIA H100 80GB HBM3, 700 W, kernel_ab.py against the
// first design's tree in one call): 0.44 ms at the train shape, 0.30x the first
// design and 1.55x SDPA's backward.  At D = 128 each worker holds two
// stages only (32 KB of K and V plus 33 KB a stage), and a stage is
// released only when its last product is done: issuing the next tile's
// products earlier held stages longer and ran slower (0.49 ms).
// At D = 256 its times beside SDPA's and the mma.sync design's are in
// PERF.md section 6 (kernel_ab.py), and what each part of an iteration
// costs there (flash_bwd_probe.py).  Two lessons: a branch per element
// around the exponentials (the mask test) serialised their latencies, so
// the mask now goes first, as -inf, and the exponentials run straight, as
// in the forward; and issuing the next iteration's first product before
// waiting for the second gained nothing, so each warpgroup waits per
// iteration.
#include <cuda.h>  // CUtensorMap types only: nothing here links libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

struct Strides {
  long long b, h, s;
};

constexpr int TILE = 64;  // rows of every tile: queries or keys
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// the dK/dV schedule (ops.py :: plan_bwd_units is its host twin)
// ---------------------------------------------------------------------------

// The kernels' scalar arguments.  NQ, NK: query and key tiles; T: the cap
// of a unit, in (query head, query tile) iterations.
struct Shape {
  int B, H, KV, G, Sq, Sk, window, causal, NQ, NK, T;
};

// The query tiles that reach key tile t: from qt0, nq of them.  Causal,
// from its first key to its last key's window; non-causal, all.
__host__ __device__ inline void tile_walk(const Shape& s, int t, int& qt0, int& nq) {
  int q_begin = 0, q_end = s.Sq;
  if (s.causal) {
    q_begin = t * TILE;
    if (s.window > 0) q_end = imin(s.Sq, t * TILE + TILE - 1 + s.window);
  }
  qt0 = q_begin / TILE;
  nq = q_end > q_begin ? (q_end - 1) / TILE - qt0 + 1 : 0;
}

// Key tile t's walk of w = G nq iterations: f full units of T, a remainder
// unit of r iterations where r > 0, nu units in all.
struct TileUnits {
  int w, f, r, nu;
};

__host__ __device__ inline TileUnits tile_units(const Shape& s, int t) {
  int qt0, nq;
  tile_walk(s, t, qt0, nq);
  TileUnits u;
  u.w = s.G * nq;
  u.f = u.w / s.T;
  u.r = u.w % s.T;
  u.nu = u.f + (u.r > 0);
  return u;
}

// Units (U), partial slots (P) and split tiles (M) of one (batch, KV head).
void plan_counts(const Shape& s, int& U, int& P, int& M) {
  U = P = M = 0;
  for (int t = 0; t < s.NK; ++t) {
    const TileUnits u = tile_units(s, t);
    U += u.nu;
    if (u.nu >= 2) {
      P += u.nu;
      ++M;
    }
  }
}

// One block writes the order of one (batch, KV head)'s units, identical for
// all: units[rank] = (tile, first iteration, end, partial slot or -1), the
// full units in (tile, chunk) order, then the remainders by size (larger
// first, ties by tile); merges[m] = (tile, first slot, units) of the m-th
// split tile.  A split tile's slots are consecutive, in chunk order.
__device__ void plan_block(const Shape& s, int4* units, int4* merges) {
  for (int t = threadIdx.x; t < s.NK; t += blockDim.x) {
    const TileUnits mine = tile_units(s, t);
    int f_before = 0, f_total = 0, r_rank = 0, slot0 = 0, m_rank = 0;
    for (int o = 0; o < s.NK; ++o) {
      const TileUnits u = tile_units(s, o);
      f_total += u.f;
      if (o < t) {
        f_before += u.f;
        if (u.nu >= 2) {
          slot0 += u.nu;
          ++m_rank;
        }
      }
      if (u.r > mine.r || (u.r == mine.r && o < t)) ++r_rank;
    }
    const bool split = mine.nu >= 2;
    for (int c = 0; c < mine.f; ++c)
      units[f_before + c] = make_int4(t, c * s.T, (c + 1) * s.T, split ? slot0 + c : -1);
    if (mine.r > 0)
      units[f_total + r_rank] = make_int4(t, mine.f * s.T, mine.w, split ? slot0 + mine.f : -1);
    if (split) merges[m_rank] = make_int4(t, slot0, mine.nu, 0);
  }
}

// The forward's mask: query i over key j.
__device__ __forceinline__ bool kept(int i, int j, const Shape& s) {
  return i < s.Sq && j < s.Sk &&
         (!s.causal || (j <= i && (s.window <= 0 || j > i - s.window)));
}

// Whether every (query, key) pair of the 64 x 64 tile pair is kept.
__device__ __forceinline__ bool all_kept(int q_lo, int k_lo, const Shape& s) {
  return k_lo + TILE <= s.Sk && q_lo + TILE <= s.Sq &&
         (!s.causal ||
          (k_lo + TILE - 1 <= q_lo && (s.window <= 0 || k_lo > q_lo + TILE - 1 - s.window)));
}

// ---------------------------------------------------------------------------
// 1. preparation: D_i, lse in log2 units, the schedule
// ---------------------------------------------------------------------------

__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), v = __bfloat1622float2(y[i]);
    s = fmaf(u.x, v.x, s);
    s = fmaf(u.y, v.y, s);
  }
  return s;
}

// Rows (b, h, i) of the padded (B, H, NQ * 64) f32 scratch: delta = D_i and
// lse2 = lse log2(e) for i < Sq, 0 and +inf past it.  D / 8 lanes read a
// row's 16-byte chunks of O and dO.  The last block writes the schedule.
template <int D>
__global__ void __launch_bounds__(256)
bwd_prep(const bf16* __restrict__ o, const bf16* __restrict__ dout,
         const float* __restrict__ lse, float* __restrict__ lse2p,
         float* __restrict__ deltap, int4* __restrict__ units, int4* __restrict__ merges,
         Shape s, Strides os, Strides dos) {
  if (blockIdx.x == gridDim.x - 1) {
    plan_block(s, units, merges);
    return;
  }
  constexpr int LPR = D / 8;        // lanes a row
  constexpr int RPB = 256 / LPR;    // rows a block
  const int Sqp = s.NQ * TILE;
  const long long rows = (long long)s.B * s.H * Sqp;
  const long long row = (long long)blockIdx.x * RPB + threadIdx.x / LPR;
  const int c = threadIdx.x % LPR;
  const bool valid = row < rows;
  const int i = valid ? (int)(row % Sqp) : 0;
  const long long bh = valid ? row / Sqp : 0;
  const int h = (int)(bh % s.H), b = (int)(bh / s.H);
  float sum = 0.f;
  if (valid && i < s.Sq) {
    const uint4 x = *reinterpret_cast<const uint4*>(o + b * os.b + h * os.h + i * os.s + c * 8);
    const uint4 y =
        *reinterpret_cast<const uint4*>(dout + b * dos.b + h * dos.h + i * dos.s + c * 8);
    sum = dot8(x, y);
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (valid && c == 0) {
    deltap[row] = i < s.Sq ? sum : 0.f;
    lse2p[row] = i < s.Sq ? lse[bh * s.Sq + i] * LOG2E : INFINITY;
  }
}

// ---------------------------------------------------------------------------
// 4. the merge of split tiles
// ---------------------------------------------------------------------------

// Block (split tile m, b * KV + kv head, 16-row quarter z): dK = scale x
// the sum of the tile's partials and dV = their sum, in unit order, into
// bf16, for keys 16z..16z+15 of the tile.
template <int D>
__global__ void __launch_bounds__(256)
bwd_merge(const float* __restrict__ part, const int4* __restrict__ merges,
          bf16* __restrict__ dk, bf16* __restrict__ dv, Shape s, int P, float scale,
          Strides dks, Strides dvs) {
  const int4 mg = merges[blockIdx.x];
  const int bkv = blockIdx.y, b = bkv / s.KV, kvh = bkv % s.KV;
  const int k_lo = mg.x * TILE;
  constexpr int N = TILE * D, Q = N / 4;  // a partial, a quarter of it
  for (int e = threadIdx.x * 4; e < 2 * Q; e += 256 * 4) {
    const int which = e / Q, rem = blockIdx.z * Q + e % Q, row = rem / D, col = rem % D;
    if (k_lo + row >= s.Sk) continue;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = 0; c < mg.z; ++c) {
      const float4 x = *reinterpret_cast<const float4*>(
          part + ((long long)(bkv * P + mg.y + c) * 2 + which) * N + rem);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    const float m = which == 0 ? scale : 1.f;
    __nv_bfloat162 lo = __floats2bfloat162_rn(acc.x * m, acc.y * m);
    __nv_bfloat162 hi = __floats2bfloat162_rn(acc.z * m, acc.w * m);
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&lo);
    packed.y = *reinterpret_cast<uint32_t*>(&hi);
    bf16* dst = which == 0 ? dk + b * dks.b + kvh * dks.h + (k_lo + row) * dks.s + col
                           : dv + b * dvs.b + kvh * dvs.h + (k_lo + row) * dvs.s + col;
    *reinterpret_cast<uint2*>(dst) = packed;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// D = 64 and 128: wgmma fed by TMA (helpers copied from flash_attention.cu,
// so that the forward's build and times stay put)
// ---------------------------------------------------------------------------

namespace tc {

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` of the barrier has completed.  A
// barrier that stays open for seconds means a broken pipeline: trap, so
// that the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = global_ns();
    } else if (global_ns() - t0 > 4000000000ull) {
      __trap();
    }
  }
}

// One TMA box of a 4-d tensor map into shared memory; completion is
// reported to `bar` as transferred bytes.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` (a multiple of 16) of contiguous global memory into shared memory
// by the TMA unit, completion reported to `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand (the layout
// TMA writes with CU_TENSOR_MAP_SWIZZLE_128B): start address, leading and
// stride byte offsets in 16-byte units, layout type 1 (128B swizzle).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((saddr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// D(64 x 64) (+)= A(64 x 16, smem) * B(64 x 16, smem)^T, both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x 64) += A(64 x 16, registers) * B(16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 128) += A(64 x 16, registers) * B(16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 256) += A(64 x 16, registers) * B(16 x 256, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4],
                                         uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n256(d, a, db);
}

// X(64 x 64) = A(64 x D) B(64 x D)^T, both 64-row tiles of DC boxes of
// (64 x 64) bf16 in shared memory, 128B-swizzled.
template <int D>
__device__ __forceinline__ void wgmma_abt(float (&x)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * TILE * 128 + (kk % 4) * 32;  // 16 columns = 32 bytes
    wgmma_ss_n64(x, desc_sw128(a + off, 16, 1024), desc_sw128(b + off, 16, 1024), kk > 0);
  }
}

// acc(64 x D) += A(64 x 64, registers: four k-steps of 16) B(64 x D), B a
// 64-row tile in shared memory read as a transposed (MN-major) operand: rows
// 16kk..16kk+15 are two 8-row groups (SBO 1024 B), the D columns D/64 boxes
// (LBO one box).
template <int D>
__device__ __forceinline__ void wgmma_ab(float (&acc)[D / 2], const uint32_t (&a)[4][4],
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<D>(acc, a[kk], desc_sw128(b + kk * 16 * 128, TILE * 128, 1024));
}

// The m64n64 accumulator x as four A operands of k-steps of 16 columns.
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// A block: two consumer warpgroups (warps 0-7) and a producer warpgroup
// (warps 8-11) whose warps 8 .. 8 + W - 1 feed them.  A worker has a list of
// jobs of its own (see bwd_dq_dkdv_tc) and a slot of shared memory: FB
// buffers of two fixed 64-row tiles (a dK/dV job's K and V, a dQ job's Q
// and dO), a ring of STAGES pairs of streamed tiles (Q and dO, or K and V),
// STAGES x 512 bytes of lse2 and D (dK/dV jobs), and barriers:
// fixed_full[FB], fixed_empty[FB], full[STAGES], empty[STAGES].  With two
// fixed buffers (D = 64) the producer loads the next job's fixed tiles
// while the consumer still works on the current job's.
// Where two slots of two stages each fit (D = 64 and 128) each consumer
// warpgroup is a worker (W = 2).  At D = 256 a tile pair is 64 KB, so the
// block is one worker (W = 1) served by both consumer warpgroups, and its
// slot adds two 64 x 64 f32 exchange tiles (channel 0 written by warpgroup
// 0, channel 1 by warpgroup 1) with barriers xfull[2], xempty[2]:
// 64 + 2 x 64.5 + 32 KB, all of the 227 KB but the alignment slack.
template <int D>
struct Cfg {
  static constexpr int BOX = TILE * 128;         // one (64 x 64) bf16 box
  static constexpr int TILE_BYTES = (D / 64) * BOX;
  static constexpr int THREADS = 384;
  static constexpr int BUDGET = 232448 - 1024;   // less the alignment slack
  static constexpr int FB = D <= 64 ? 2 : 1;
  static constexpr int FIXED = 2 * TILE_BYTES;
  static constexpr int STAGE = 2 * TILE_BYTES;
  static constexpr int W = (BUDGET / 2 - FB * FIXED - 1024) / (STAGE + 512) >= 2 ? 2 : 1;
  static constexpr int XT = TILE * TILE * 4;     // one exchange tile
  static constexpr int XCH = W == 1 ? 2 * XT : 0;
  static constexpr int STAGES_FIT = (BUDGET / W - FB * FIXED - XCH - 1024) / (STAGE + 512);
  static constexpr int STAGES = STAGES_FIT > 4 ? 4 : STAGES_FIT;
  static constexpr int STG = FB * FIXED;
  static constexpr int F32 = STG + STAGES * STAGE;
  static constexpr int X = F32 + STAGES * 512;
  static constexpr int BAR = X + XCH;
  static constexpr int NBAR = 2 * (FB + STAGES) + (W == 1 ? 4 : 0);
  static constexpr int SLOT = (BAR + 8 * NBAR + 1023) / 1024 * 1024;
  static constexpr int SMEM = W * SLOT + 1024;
  static constexpr int CONSUMERS = 256 / W;      // threads that release a stage
  // registers a thread of the producer and of the consumer warpgroups,
  // which take all of the 168 x 384 the block launches with: one worker's
  // producer thread needs more than 24 not to spill, and its consumers no
  // more than 232 (128 f32 of dK or dV, 64 of S^T or dP^T and P^T)
  static constexpr int PRODUCER_REGS = W == 1 ? 40 : 24;
  static constexpr int CONSUMER_REGS = W == 1 ? 232 : 240;
  static_assert(STAGES >= 2, "shared memory holds fewer than two stages");
  static_assert(SMEM <= 232448, "the slots exceed a block's shared memory");
};

// Barrier addresses of a slot.
template <int D>
struct Bars {
  using C = Cfg<D>;
  uint32_t base;
  __device__ uint32_t fixed_full(int f) const { return base + 8 * f; }
  __device__ uint32_t fixed_empty(int f) const { return base + 8 * (C::FB + f); }
  __device__ uint32_t full(int s) const { return base + 8 * (2 * C::FB + s); }
  __device__ uint32_t empty(int s) const { return base + 8 * (2 * C::FB + C::STAGES + s); }
  __device__ uint32_t xfull(int c) const { return base + 8 * (2 * C::FB + 2 * C::STAGES + c); }
  __device__ uint32_t xempty(int c) const {
    return base + 8 * (2 * C::FB + 2 * C::STAGES + 2 + c);
  }
};

// What a worker's job is: dK/dV unit `unit` of the schedule (rank, batch,
// KV head), or dQ of query tile qi of (batch, head) bh.
struct Job {
  bool dkdv;
  int b, head, t, it0, it1, slot;  // dK/dV: KV head, key tile, iterations, partial slot
  int qi;                          // dQ: query tile (head: the query head)
};

__device__ __forceinline__ Job job_of(long long item, long long n_units, const int4* units,
                                      const Shape& s) {
  Job j;
  const int BKV = s.B * s.KV;
  j.dkdv = item < n_units;
  if (j.dkdv) {
    const int4 un = units[item / BKV];
    const int bkv = (int)(item % BKV);
    j.b = bkv / s.KV;
    j.head = bkv % s.KV;
    j.t = un.x;
    j.it0 = un.y;
    j.it1 = un.z;
    j.slot = un.w;
    j.qi = 0;
  } else {
    // dQ jobs: the longest causal walks (the last query tiles) first
    const long long BH = (long long)s.B * s.H, q = item - n_units;
    j.qi = s.causal ? s.NQ - 1 - (int)(q / BH) : (int)(q / BH);
    const int bh = (int)(q % BH);
    j.b = bh / s.H;
    j.head = bh % s.H;
    j.t = j.it0 = 0;
    j.slot = -1;
    // the key tiles of the walk: causal, from the window's edge to the
    // diagonal; non-causal, all keys
    const int q_lo = j.qi * TILE;
    int kv_begin = 0;
    if (s.causal && s.window > 0) kv_begin = imax(0, q_lo - s.window + 1) / TILE * TILE;
    const int kv_end = s.causal ? imin(s.Sk, q_lo + TILE) : s.Sk;
    j.it0 = kv_begin / TILE;
    j.it1 = cdiv(kv_end, TILE);
  }
  return j;
}

// The worker's k-th job: round k of the combined list of n_units dK/dV
// units and then the dQ jobs, both heaviest first, dealt to the NW workers
// in snake order (forward in even rounds, backward in odd ones), so that
// each worker's sum of job lengths comes out near the mean.
__device__ __forceinline__ long long item_of(int k, int w, int NW) {
  return (long long)k * NW + ((k & 1) ? NW - 1 - w : w);
}

// A 64 x 64 f32 accumulator through an exchange tile, in fragment order:
// thread t of a warpgroup writes its 32 values to float4s t, t + 128, ..
// (each warp's stores one contiguous 512-byte run), and thread t of the
// other warpgroup, which holds the same (row, column) pairs of its own
// accumulators, reads them back.
__device__ __forceinline__ void put_tile(float4* t, const float (&x)[32]) {
  const int tid = threadIdx.x % 128;
#pragma unroll
  for (int e = 0; e < 8; ++e)
    t[e * 128 + tid] = make_float4(x[4 * e], x[4 * e + 1], x[4 * e + 2], x[4 * e + 3]);
}
__device__ __forceinline__ void get_tile(float (&x)[32], const float4* t) {
  const int tid = threadIdx.x % 128;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float4 v = t[e * 128 + tid];
    x[4 * e] = v.x;
    x[4 * e + 1] = v.y;
    x[4 * e + 2] = v.z;
    x[4 * e + 3] = v.w;
  }
}

// The consumers of a one-worker block (W = 1, D = 256): warpgroups g = 0
// and 1 take every job of the worker together, so each holds half of the
// job's accumulators (128 f32 a thread at most) and the two trade the
// 64 x 64 products each computes once through the exchange tiles.
//   dK/dV: g 0 computes S^T = K Q^T, forms P^T and sends it on channel 0,
//   then sums dV += P^T dO; g 1 computes dP^T = V dO^T, takes P^T, forms
//   dS^T = P^T (dP^T - D) and sums dK += dS^T Q (both m64n256k16, A from
//   registers).  S^T is computed once and the two do equal work.
//   dQ: g 0 computes S = Q K^T and forms P, g 1 computes dP = dO V^T; each
//   sends its tile on its own channel and takes the other's, both form the
//   same dS = P (dP - D), and g sums columns 128 g .. 128 g + 127 of
//   dQ += dS K (m64n128k16).
// Each warpgroup releases a job's fixed tiles after its last product that
// reads them, so the next job's K and V (or Q and dO) load during the last
// iteration's second product.  Channel c's uses are counted alike by both
// warpgroups (u0, u1): the writer of use u waits for the reader to have
// taken use u - 1.
template <int D>
__device__ __forceinline__ void serve_one(
    uint32_t slot, uint8_t* slot_ptr, const Bars<D>& bar, int w, int NW, long long n_units,
    long long n_items, const int4* __restrict__ units, const float* __restrict__ lse2p,
    const float* __restrict__ deltap, float* __restrict__ part, bf16* __restrict__ dq,
    bf16* __restrict__ dk, bf16* __restrict__ dv, const Shape& s, int P, float scale,
    Strides dqs, Strides dks, Strides dvs) {
  using C = Cfg<D>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = warp / 4;                     // this warpgroup
  const int r0 = (warp % 4) * 16 + lane / 4;  // this thread's rows r0 and r0 + 8
  const int c0 = (lane % 4) * 2;              // and columns c0 + 8i, c0 + 8i + 1
  const float scale_log2 = scale * LOG2E;
  const int Sqp = s.NQ * TILE;
  float4* const ch0 = reinterpret_cast<float4*>(slot_ptr + C::X);  // channel 0
  float4* const mine = ch0 + g * (C::XT / 16);          // channel g
  float4* const theirs = ch0 + (1 - g) * (C::XT / 16);  // channel 1 - g
  int n = 0;           // stages consumed so far
  int u0 = 0, u1 = 0;  // uses of channels 0 and 1 so far
  for (int k = 0;; ++k) {
    const long long item = item_of(k, w, NW);
    if (item >= n_items) break;
    const Job j = job_of(item, n_units, units, s);
    const uint32_t fa = slot, fbt = fa + C::TILE_BYTES;
    mbar_wait(bar.fixed_full(0), k & 1);

    if (j.dkdv) {
      // ---- g 0: dV, g 1: dK of keys k_lo + r0 (+ 8) ----
      const int k_lo = j.t * TILE;
      int qt0, nq;
      tile_walk(s, j.t, qt0, nq);
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      for (int it = j.it0; it < j.it1; ++it, ++n) {
        const int st = n % C::STAGES;
        const int qlo = (qt0 + it % nq) * TILE;
        const uint32_t sq = slot + C::STG + st * C::STAGE, sdo = sq + C::TILE_BYTES;
        const float* f = reinterpret_cast<const float*>(slot_ptr + C::F32 + st * 512);
        mbar_wait(bar.full(st), (n / C::STAGES) & 1);
        float x[32];
        wgmma_fence();
        wgmma_abt<D>(x, g == 0 ? fa : fbt, g == 0 ? sq : sdo);  // S^T = K Q^T, dP^T = V dO^T
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(x);
        if (it + 1 == j.it1) mbar_arrive(bar.fixed_empty(0));
        if (g == 0) {
          // the mask first, then the exponentials with no branch between
          // them (a branch per element serialised their latencies)
          if (!all_kept(qlo, k_lo, s)) {
#pragma unroll
            for (int i = 0; i < 32; ++i) {
              const int col = (i / 4) * 8 + c0 + (i & 1);  // query in the tile
              x[i] = kept(qlo + col, k_lo + r0 + 8 * ((i >> 1) & 1), s) ? x[i] : -INFINITY;
            }
          }
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const float2 l2 = *reinterpret_cast<const float2*>(f + jj * 8 + c0);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              x[4 * jj + e] = exp2f(fmaf(x[4 * jj + e], scale_log2, -((e & 1) ? l2.y : l2.x)));
          }
          if (u0 > 0) mbar_wait(bar.xempty(0), (u0 - 1) & 1);
          put_tile(ch0, x);
          mbar_arrive(bar.xfull(0));
        } else {
          float p[32];
          mbar_wait(bar.xfull(0), u0 & 1);
          get_tile(p, ch0);
          mbar_arrive(bar.xempty(0));
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const float2 dl = *reinterpret_cast<const float2*>(f + TILE + jj * 8 + c0);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = 4 * jj + e;
              x[i] = p[i] * (x[i] - ((e & 1) ? dl.y : dl.x));  // dS^T
            }
          }
        }
        ++u0;
        uint32_t a[4][4];
        to_a(a, x);
        fence_regs(acc);
        wgmma_fence();
        wgmma_ab<D>(acc, a, g == 0 ? sdo : sq);  // dV += P^T dO, dK += dS^T Q
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(bar.empty(st));
      }
      if (j.it1 <= j.it0) mbar_arrive(bar.fixed_empty(0));
      const float mul = g == 0 ? 1.f : scale;
      if (j.slot < 0) {
        bf16* out = g == 0 ? dv : dk;
        const Strides os = g == 0 ? dvs : dks;
#pragma unroll
        for (int i = 0; i < D / 2; i += 2) {
          const int key = k_lo + r0 + 8 * ((i >> 1) & 1);
          if (key < s.Sk) {
            const int col = (i / 4) * 8 + c0;
            *reinterpret_cast<uint32_t*>(out + j.b * os.b + j.head * os.h + key * os.s + col) =
                pack_bf16(acc[i] * mul, acc[i + 1] * mul);
          }
        }
      } else {
        // partials: dK's then dV's 64 x D f32 of the slot
        const int bkv = j.b * s.KV + j.head;
        float* pp = part + ((long long)(bkv * P + j.slot) * 2 + (g == 0)) * TILE * D;
#pragma unroll
        for (int i = 0; i < D / 2; i += 2) {
          const int e = (r0 + 8 * ((i >> 1) & 1)) * D + (i / 4) * 8 + c0;
          *reinterpret_cast<float2*>(pp + e) = make_float2(acc[i], acc[i + 1]);
        }
      }
    } else {
      // ---- dQ of queries q_lo + r0 (+ 8), columns 128 g .. 128 g + 127 ----
      const int q_lo = j.qi * TILE;
      const long long prow = ((long long)j.b * s.H + j.head) * Sqp + q_lo + r0;
      const float lse2[2] = {lse2p[prow], lse2p[prow + 8]};
      const float dl[2] = {deltap[prow], deltap[prow + 8]};
      float acc[D / 4];
#pragma unroll
      for (int i = 0; i < D / 4; ++i) acc[i] = 0.f;
      for (int it = j.it0; it < j.it1; ++it, ++n) {
        const int st = n % C::STAGES;
        const int kv_lo = it * TILE;
        const uint32_t sk = slot + C::STG + st * C::STAGE, sv = sk + C::TILE_BYTES;
        mbar_wait(bar.full(st), (n / C::STAGES) & 1);
        float x[32], y[32];
        wgmma_fence();
        wgmma_abt<D>(x, g == 0 ? fa : fbt, g == 0 ? sk : sv);  // S = Q K^T, dP = dO V^T
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(x);
        if (it + 1 == j.it1) mbar_arrive(bar.fixed_empty(0));
        if (g == 0) {
          if (!all_kept(q_lo, kv_lo, s)) {
#pragma unroll
            for (int i = 0; i < 32; ++i) {
              const int key = kv_lo + (i / 4) * 8 + c0 + (i & 1);
              x[i] = kept(q_lo + r0 + 8 * ((i >> 1) & 1), key, s) ? x[i] : -INFINITY;
            }
          }
#pragma unroll
          for (int i = 0; i < 32; ++i)
            x[i] = exp2f(fmaf(x[i], scale_log2, -lse2[(i >> 1) & 1]));  // P
        }
        // send this warpgroup's tile on channel g, take the other's
        const int um = g == 0 ? u0 : u1, ut = g == 0 ? u1 : u0;
        if (um > 0) mbar_wait(bar.xempty(g), (um - 1) & 1);
        put_tile(mine, x);
        mbar_arrive(bar.xfull(g));
        mbar_wait(bar.xfull(1 - g), ut & 1);
        get_tile(y, theirs);
        mbar_arrive(bar.xempty(1 - g));
        ++u0;
        ++u1;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float p = g == 0 ? x[i] : y[i], dp = g == 0 ? y[i] : x[i];
          x[i] = p * (dp - dl[(i >> 1) & 1]);  // dS
        }
        uint32_t a[4][4];
        to_a(a, x);
        fence_regs(acc);
        wgmma_fence();
        wgmma_ab<D / 2>(acc, a, sk + g * (D / 128) * C::BOX);  // dQ += dS K, half the columns
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(bar.empty(st));
      }
      if (j.it1 <= j.it0) mbar_arrive(bar.fixed_empty(0));
#pragma unroll
      for (int i = 0; i < D / 4; i += 2) {
        const int row = q_lo + r0 + 8 * ((i >> 1) & 1);
        if (row < s.Sq) {
          const int col = g * (D / 2) + (i / 4) * 8 + c0;
          *reinterpret_cast<uint32_t*>(dq + j.b * dqs.b + j.head * dqs.h + row * dqs.s + col) =
              pack_bf16(acc[i] * scale, acc[i + 1] * scale);
        }
      }
    }
  }
}

// The backward's dQ and dK/dV jobs on wgmma.  Block x runs workers W x ..
// W x + W - 1 of NW = W gridDim.x: its two consumer warpgroups at W = 2,
// both on one worker's jobs at W = 1 (D = 256, see serve_one).  A dK/dV job
// (unit u of U x B x KV: rank u / (B KV), batch and KV head u % (B KV))
// keeps K and V of its 64 keys fixed and streams Q, dO, lse2 and D of each
// (query head, query tile) iteration; a dQ job keeps Q and dO of its 64
// queries and streams K and V of each key tile.  The stage ring runs on
// across the worker's jobs, and the producer queues a job's first stage
// before its fixed tiles, so the next job's first tiles load while the
// current one finishes.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
bwd_dq_dkdv_tc(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmk,
               const __grid_constant__ CUtensorMap tmv, const __grid_constant__ CUtensorMap tmdo,
               const float* __restrict__ lse2p, const float* __restrict__ deltap,
               const int4* __restrict__ units, float* __restrict__ part,
               bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv, Shape s,
               int U, int P, float scale, Strides dqs, Strides dks, Strides dvs) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  if (threadIdx.x == 0) {
    for (int sl = 0; sl < C::W; ++sl) {
      const Bars<D> bar{base + sl * C::SLOT + C::BAR};
      for (int f = 0; f < C::FB; ++f) {
        mbar_init(bar.fixed_full(f), 1);
        mbar_init(bar.fixed_empty(f), C::CONSUMERS);
      }
      for (int st = 0; st < C::STAGES; ++st) {
        mbar_init(bar.full(st), 1);
        mbar_init(bar.empty(st), C::CONSUMERS);
      }
      if constexpr (C::W == 1) {
        for (int c = 0; c < 2; ++c) {
          mbar_init(bar.xfull(c), 128);
          mbar_init(bar.xempty(c), 128);
        }
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sl = warp >= 8 ? warp - 8 : C::W == 2 ? warp / 4 : 0;
  const int NW = C::W * gridDim.x, w = C::W * blockIdx.x + sl;
  const long long n_units = (long long)U * s.B * s.KV;
  const long long n_items = n_units + (long long)s.NQ * s.B * s.H;
  const uint32_t slot = base + sl * C::SLOT;
  const Bars<D> bar{slot + C::BAR};
  const int Sqp = s.NQ * TILE;

  if (warp >= 8) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::PRODUCER_REGS));
    if (sl >= C::W || lane != 0) return;
    int n = 0;  // stage loads so far
    for (int k = 0;; ++k) {
      const long long item = item_of(k, w, NW);
      if (item >= n_items) break;
      const Job j = job_of(item, n_units, units, s);
      const int fb = k % C::FB;
      // dK/dV: K, V of the key tile; dQ: Q, dO of the query tile
      auto load_fixed = [&] {
        if (k >= C::FB) mbar_wait(bar.fixed_empty(fb), ((k / C::FB) & 1) ^ 1);
        const uint32_t fixed = slot + fb * C::FIXED;
        const CUtensorMap* ma = j.dkdv ? &tmk : &tmq;
        const CUtensorMap* mb = j.dkdv ? &tmv : &tmdo;
        const int row = j.dkdv ? j.t * TILE : j.qi * TILE;
        mbar_expect_tx(bar.fixed_full(fb), C::FIXED);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(fixed + c * C::BOX, ma, bar.fixed_full(fb), c * 64, row, j.head, j.b);
          tma_load_4d(fixed + C::TILE_BYTES + c * C::BOX, mb, bar.fixed_full(fb), c * 64, row,
                      j.head, j.b);
        }
      };
      int qt0 = 0, nq = 1;
      if (j.dkdv) tile_walk(s, j.t, qt0, nq);
      for (int it = j.it0; it < j.it1; ++it, ++n) {
        const int st = n % C::STAGES;
        if (n >= C::STAGES) mbar_wait(bar.empty(st), ((n / C::STAGES) & 1) ^ 1);
        const uint32_t dst = slot + C::STG + st * C::STAGE;
        if (j.dkdv) {
          const int h = j.head * s.G + it / nq, qlo = (qt0 + it % nq) * TILE;
          const long long prow = ((long long)j.b * s.H + h) * Sqp + qlo;
          const uint32_t f = slot + C::F32 + st * 512;
          mbar_expect_tx(bar.full(st), C::STAGE + 512);
          for (int c = 0; c < D / 64; ++c) {
            tma_load_4d(dst + c * C::BOX, &tmq, bar.full(st), c * 64, qlo, h, j.b);
            tma_load_4d(dst + C::TILE_BYTES + c * C::BOX, &tmdo, bar.full(st), c * 64, qlo, h,
                        j.b);
          }
          bulk_load(f, lse2p + prow, 256, bar.full(st));
          bulk_load(f + 256, deltap + prow, 256, bar.full(st));
        } else {
          const int kvh = j.head / s.G;
          mbar_expect_tx(bar.full(st), C::STAGE);
          for (int c = 0; c < D / 64; ++c) {
            tma_load_4d(dst + c * C::BOX, &tmk, bar.full(st), c * 64, it * TILE, kvh, j.b);
            tma_load_4d(dst + C::TILE_BYTES + c * C::BOX, &tmv, bar.full(st), c * 64,
                        it * TILE, kvh, j.b);
          }
        }
        if (it == j.it0) load_fixed();
      }
      if (j.it1 <= j.it0) load_fixed();
    }
    return;
  }

  // ---- consumers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::CONSUMER_REGS));
  uint8_t* slot_ptr = smem_raw + (slot - smem_u32(smem_raw));
  if constexpr (C::W == 1) {
    serve_one<D>(slot, slot_ptr, bar, w, NW, n_units, n_items, units, lse2p, deltap, part, dq,
                 dk, dv, s, P, scale, dqs, dks, dvs);
  } else {
    const int r0 = (warp % 4) * 16 + lane / 4;  // this thread's rows r0 and r0 + 8
    const int c0 = (lane % 4) * 2;              // and columns c0 + 8i, c0 + 8i + 1
    const float scale_log2 = scale * LOG2E;
    int n = 0;  // stages consumed so far
    for (int k = 0;; ++k) {
      const long long item = item_of(k, w, NW);
      if (item >= n_items) break;
      const Job j = job_of(item, n_units, units, s);
      const int fb = k % C::FB;
      const uint32_t fa = slot + fb * C::FIXED, fbt = fa + C::TILE_BYTES;
      mbar_wait(bar.fixed_full(fb), (k / C::FB) & 1);

      if (j.dkdv) {
        // ---- dK and dV of keys k_lo + r0 (+ 8) ----
        const int k_lo = j.t * TILE;
        int qt0, nq;
        tile_walk(s, j.t, qt0, nq);
        float adk[D / 2], adv[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) adk[i] = adv[i] = 0.f;
        for (int it = j.it0; it < j.it1; ++it, ++n) {
          const int st = n % C::STAGES;
          const int qlo = (qt0 + it % nq) * TILE;
          const uint32_t sq = slot + C::STG + st * C::STAGE, sdo = sq + C::TILE_BYTES;
          const float* f = reinterpret_cast<const float*>(slot_ptr + C::F32 + st * 512);
          mbar_wait(bar.full(st), (n / C::STAGES) & 1);
          float x[32], dp[32];
          wgmma_fence();
          wgmma_abt<D>(x, fa, sq);  // S^T = K Q^T
          wgmma_commit();
          wgmma_abt<D>(dp, fbt, sdo);  // dP^T = V dO^T
          wgmma_commit();
          wgmma_wait<1>();
          fence_regs(x);
          const bool mask = !all_kept(qlo, k_lo, s);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const float2 l2 = *reinterpret_cast<const float2*>(f + jj * 8 + c0);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = 4 * jj + e;
              const int col = jj * 8 + c0 + (e & 1);  // query in the tile
              const int key = k_lo + r0 + 8 * (e >> 1);
              x[i] = !mask || kept(qlo + col, key, s)
                         ? exp2f(fmaf(x[i], scale_log2, -((e & 1) ? l2.y : l2.x)))
                         : 0.f;
            }
          }
          uint32_t pa[4][4];
          to_a(pa, x);
          fence_regs(adv);
          wgmma_fence();
          wgmma_ab<D>(adv, pa, sdo);  // dV += P^T dO
          wgmma_commit();
          wgmma_wait<1>();  // dP^T is in
          fence_regs(dp);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const float2 dl = *reinterpret_cast<const float2*>(f + TILE + jj * 8 + c0);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = 4 * jj + e;
              dp[i] = x[i] * (dp[i] - ((e & 1) ? dl.y : dl.x));  // dS^T
            }
          }
          uint32_t dsa[4][4];
          to_a(dsa, dp);
          fence_regs(adk);
          wgmma_fence();
          wgmma_ab<D>(adk, dsa, sq);  // dK += dS^T Q
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(adk);
          fence_regs(adv);
          mbar_arrive(bar.empty(st));
        }
        mbar_arrive(bar.fixed_empty(fb));
        if (j.slot < 0) {
#pragma unroll
          for (int i = 0; i < D / 2; i += 2) {
            const int key = k_lo + r0 + 8 * ((i >> 1) & 1);
            if (key < s.Sk) {
              const int col = (i / 4) * 8 + c0;
              *reinterpret_cast<uint32_t*>(dk + j.b * dks.b + j.head * dks.h + key * dks.s +
                                           col) = pack_bf16(adk[i] * scale, adk[i + 1] * scale);
              *reinterpret_cast<uint32_t*>(dv + j.b * dvs.b + j.head * dvs.h + key * dvs.s +
                                           col) = pack_bf16(adv[i], adv[i + 1]);
            }
          }
        } else {
          const int bkv = j.b * s.KV + j.head;
          float* pk = part + (long long)(bkv * P + j.slot) * 2 * TILE * D;
          float* pv = pk + TILE * D;
#pragma unroll
          for (int i = 0; i < D / 2; i += 2) {
            const int e = (r0 + 8 * ((i >> 1) & 1)) * D + (i / 4) * 8 + c0;
            *reinterpret_cast<float2*>(pk + e) = make_float2(adk[i], adk[i + 1]);
            *reinterpret_cast<float2*>(pv + e) = make_float2(adv[i], adv[i + 1]);
          }
        }
      } else {
        // ---- dQ of queries q_lo + r0 (+ 8) ----
        const int q_lo = j.qi * TILE;
        const long long prow = ((long long)j.b * s.H + j.head) * Sqp + q_lo + r0;
        const float lse2[2] = {lse2p[prow], lse2p[prow + 8]};
        const float dl[2] = {deltap[prow], deltap[prow + 8]};
        float acc[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
        for (int it = j.it0; it < j.it1; ++it, ++n) {
          const int st = n % C::STAGES;
          const int kv_lo = it * TILE;
          const uint32_t sk = slot + C::STG + st * C::STAGE, sv = sk + C::TILE_BYTES;
          mbar_wait(bar.full(st), (n / C::STAGES) & 1);
          float x[32], dp[32];
          wgmma_fence();
          wgmma_abt<D>(x, fa, sk);  // S = Q K^T
          wgmma_commit();
          wgmma_abt<D>(dp, fbt, sv);  // dP = dO V^T
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(x);
          fence_regs(dp);
          const bool mask = !all_kept(q_lo, kv_lo, s);
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int r = (i >> 1) & 1;
            const int key = kv_lo + (i / 4) * 8 + c0 + (i & 1);
            const float p = !mask || kept(q_lo + r0 + 8 * r, key, s)
                                ? exp2f(fmaf(x[i], scale_log2, -lse2[r]))
                                : 0.f;
            x[i] = p * (dp[i] - dl[r]);  // dS
          }
          uint32_t a[4][4];
          to_a(a, x);
          fence_regs(acc);
          wgmma_fence();
          wgmma_ab<D>(acc, a, sk);  // dQ += dS K
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc);
          mbar_arrive(bar.empty(st));
        }
        mbar_arrive(bar.fixed_empty(fb));
#pragma unroll
        for (int i = 0; i < D / 2; i += 2) {
          const int row = q_lo + r0 + 8 * ((i >> 1) & 1);
          if (row < s.Sq) {
            const int col = (i / 4) * 8 + c0;
            *reinterpret_cast<uint32_t*>(dq + j.b * dqs.b + j.head * dqs.h + row * dqs.s + col) =
                pack_bf16(acc[i] * scale, acc[i + 1] * scale);
          }
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime so that
// nothing links libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (B, heads, S, D) bf16 tensor with element strides (batch, head,
// position) as a 4-d tensor map, boxes of (64 rows x 64), 128B swizzle;
// rows past S read as zeros.
bool encode(CUtensorMap* map, const void* ptr, int B, int heads, int S, int D, Strides st) {
  EncodeTiled fn = encoder();
  if (!fn) return false;
  // a dimension of size 1 is never stepped: any 16-byte multiple will do
  auto stride = [](long long s, int n) { return (cuuint64_t)(n > 1 ? s * 2 : 16); };
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {stride(st.s, S), stride(st.h, heads), stride(st.b, B)};
  const cuuint32_t box[4] = {64, (cuuint32_t)TILE, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
            strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tc

// ---------------------------------------------------------------------------
// D = 32: the first design's mma.sync kernels, under the same schedule
// ---------------------------------------------------------------------------

namespace mma {

constexpr int THREADS = 128;  // four warps a block, 16 rows each
constexpr int STEP = 16;      // keys (dq) or queries (dkdv) per inner step
constexpr int STAGES = 2;

template <int D>
struct Smem {
  static_assert(D == 32, "the mma.sync kernels serve D = 32 alone");
  static constexpr int TILE_BYTES = TILE * D * 2;
  // dkdv: K and V, then STAGES x (Q, dO, lse2[TILE], delta[TILE])
  static constexpr int STAGE_A = 2 * TILE_BYTES + 2 * TILE * 4;
  static constexpr int DKDV = 2 * TILE_BYTES + STAGES * STAGE_A;
  // dq: Q and dO, then STAGES x (K, V)
  static constexpr int STAGE_B = 2 * TILE_BYTES;
  static constexpr int DQ = 2 * TILE_BYTES + STAGES * STAGE_B;
};

// 16 bytes from global to shared memory, asynchronously; with valid false
// the 16 bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The (16 x 16) accumulators of two n-blocks of 8 as the A operand of the
// next product: the m16n8 C layout of n-blocks 0 and 1 is the m16k16 A
// layout of k 0-7 and 8-15.
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&c)[2][4]) {
  a[0] = pack_bf16(c[0][0], c[0][1]);
  a[1] = pack_bf16(c[0][2], c[0][3]);
  a[2] = pack_bf16(c[1][0], c[1][1]);
  a[3] = pack_bf16(c[1][2], c[1][3]);
}

// Byte offset of 16-byte chunk c of row r in a tile of rows of D = 32
// bf16: chunk c is stored at c ^ ((r / 2) % 4), so that the 8 rows an
// ldmatrix reads at one chunk column (two 64-byte rows to 128 bytes) fall
// in 8 different 16-byte bank groups.
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * (D * 2) + ((c ^ ((r >> 1) & 3)) << 4);
}

// Rows [lo, lo + TILE) of a (rows x D) bf16 matrix (row stride rs
// elements) into the swizzled tile at dst; rows at or past n are zeros.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* base, long long rs,
                                          int lo, int n) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < TILE * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const bool valid = lo + r < n;
    const bf16* src = base + (valid ? (long long)(lo + r) * rs : 0) + c * 8;
    cp_async16(dst + swz<D>(r, c), src, valid);
  }
}

// Block (query tile, head, batch): dQ of 64 query rows over the key tiles
// that reach them; causal query tiles launch longest walk first.
template <int D>
__global__ void __launch_bounds__(THREADS)
bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           const bf16* __restrict__ dout, const float* __restrict__ lse2p,
           const float* __restrict__ deltap, bf16* __restrict__ dq, Shape s, float scale,
           Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs) {
  using S = Smem<D>;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t sq = base, sdo = base + S::TILE_BYTES;
  auto stage = [&](int st) { return base + 2 * S::TILE_BYTES + st * S::STAGE_B; };

  const int qi = s.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q_lo = qi * TILE, h = blockIdx.y, b = blockIdx.z, kvh = h / s.G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mi = lane / 8, mr = lane % 8;  // ldmatrix: matrix, row of it
  const int g4 = lane / 4, t4 = lane % 4;  // mma fragment row, column pair
  const float scale_log2 = scale * LOG2E;

  // causal: from the window's edge to the diagonal; non-causal: all keys
  int kv_begin = 0;
  if (s.causal && s.window > 0) kv_begin = imax(0, q_lo - s.window + 1) / TILE * TILE;
  const int kv_end = s.causal ? imin(s.Sk, q_lo + TILE) : s.Sk;
  const int n_tiles = kv_end > kv_begin ? cdiv(kv_end - kv_begin, TILE) : 0;

  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;
  auto load_kv = [&](int t) {
    const uint32_t st = stage(t % STAGES);
    const int lo = kv_begin + t * TILE;
    load_tile<D>(st, kb, ks.s, lo, s.Sk);
    load_tile<D>(st + S::TILE_BYTES, vb, vs.s, lo, s.Sk);
  };

  load_tile<D>(sq, q + b * qs.b + h * qs.h, qs.s, q_lo, s.Sq);
  load_tile<D>(sdo, dout + b * dos.b + h * dos.h, dos.s, q_lo, s.Sq);
  cp_async_commit();
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // this warp's 16 query rows of Q and dO as A fragments, and the lse (in
  // log2 units) and D of its rows g4 and g4 + 8
  const int qw = q_lo + warp * 16;
  uint32_t qa[D / 16][4], da[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int r = warp * 16 + (mi % 2) * 8 + mr, c = 2 * kk + mi / 2;
    ldmatrix_x4(qa[kk], sq + swz<D>(r, c));
    ldmatrix_x4(da[kk], sdo + swz<D>(r, c));
  }
  float lse2[2], dl[2];
  const long long row0 = ((long long)b * s.H + h) * s.NQ * TILE;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = lse2p[row0 + qw + g4 + 8 * r];
    dl[r] = deltap[row0 + qw + g4 + 8 * r];
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_kv(t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint32_t sk = stage(t % STAGES), sv = sk + S::TILE_BYTES;
    const int kv_lo = kv_begin + t * TILE;
#pragma unroll 1
    for (int step = 0; step < TILE / STEP; ++step) {
      const int k0 = kv_lo + step * STEP;
      // keys past Sk, rows past Sq, or 16 x 16 wholly masked for this warp
      if (k0 >= s.Sk || qw >= s.Sq) break;
      if (s.causal && (k0 > qw + STEP - 1 ||
                       (s.window > 0 && k0 + STEP - 1 <= qw - s.window)))
        continue;
      float x[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t bk[4], bv[4];  // {n-block 0: k lo, k hi; n-block 1: k lo, k hi}
        const int r = step * STEP + (mi / 2) * 8 + mr, c = 2 * kk + mi % 2;
        ldmatrix_x4(bk, sk + swz<D>(r, c));
        ldmatrix_x4(bv, sv + swz<D>(r, c));
        mma_bf16(x[0], qa[kk], bk[0], bk[1]);
        mma_bf16(x[1], qa[kk], bk[2], bk[3]);
        mma_bf16(dp[0], da[kk], bv[0], bv[1]);
        mma_bf16(dp[1], da[kk], bv[2], bv[3]);
      }
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int i = qw + g4 + 8 * r, j = k0 + nb * 8 + 2 * t4 + (e & 1);
          const float p = kept(i, j, s) ? exp2f(fmaf(x[nb][e], scale_log2, -lse2[r])) : 0.f;
          x[nb][e] = p * (dp[nb][e] - dl[r]);  // dS
        }
      uint32_t dsa[4];
      to_a(dsa, x);
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj) {
        uint32_t bt[4];  // {n-block 2jj: k lo, k hi; n-block 2jj+1: k lo, k hi}
        ldmatrix_x4_trans(bt, sk + swz<D>(step * STEP + (mi % 2) * 8 + mr, 2 * jj + mi / 2));
        mma_bf16(acc[2 * jj], dsa, bt[0], bt[1]);
        mma_bf16(acc[2 * jj + 1], dsa, bt[2], bt[3]);
      }
    }
    __syncthreads();  // the stage is reloaded by the next iteration
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = qw + g4 + 8 * r;
      if (i < s.Sq) {
        bf16* dst = dq + b * dqs.b + h * dqs.h + i * dqs.s + j * 8 + 2 * t4;
        *reinterpret_cast<uint32_t*>(dst) =
            pack_bf16(acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
      }
    }
}

// One 64-query iteration of a dK/dV warp over its 16 keys kw..kw+15: S^T =
// K Q^T, P^T = exp2(S^T scale log2e - lse2), dV += P^T dO, dP^T = V dO^T,
// dS^T = P^T (dP^T - D) and dK += dS^T Q, in steps of 16 queries.  f holds
// the iteration's lse2 and D rows.
template <int D>
__device__ __forceinline__ void dkdv_iter(float (&dva)[D / 8][4], float (&dka)[D / 8][4],
                                          uint32_t sk, uint32_t sv, uint32_t sq, uint32_t sdo,
                                          const float* f, int qlo, int q_end, int kw,
                                          int kr, const Shape& s, float scale_log2) {
  const int lane = threadIdx.x % 32;
  const int mi = lane / 8, mr = lane % 8;
  const int g4 = lane / 4, t4 = lane % 4;
#pragma unroll 1
  for (int step = 0; step < TILE / STEP; ++step) {
    const int q0 = qlo + step * STEP;
    // queries past the range, keys past Sk, or 16 x 16 wholly masked
    if (q0 >= q_end || kw >= s.Sk) break;
    if (s.causal && (q0 + STEP - 1 < kw ||
                     (s.window > 0 && q0 >= kw + STEP - 1 + s.window)))
      continue;
    // S^T and dP^T: 16 keys x 16 queries
    float x[2][4] = {}, dp[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], bq[4];
      const int ra = kr + (mi % 2) * 8 + mr, ca = 2 * kk + mi / 2;
      const int rb = step * STEP + (mi / 2) * 8 + mr, cb = 2 * kk + mi % 2;
      ldmatrix_x4(a, sk + swz<D>(ra, ca));
      ldmatrix_x4(bq, sq + swz<D>(rb, cb));
      mma_bf16(x[0], a, bq[0], bq[1]);
      mma_bf16(x[1], a, bq[2], bq[3]);
      ldmatrix_x4(a, sv + swz<D>(ra, ca));
      ldmatrix_x4(bq, sdo + swz<D>(rb, cb));
      mma_bf16(dp[0], a, bq[0], bq[1]);
      mma_bf16(dp[1], a, bq[2], bq[3]);
    }
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int xq = step * STEP + nb * 8 + 2 * t4 + (e & 1);  // query in tile
        const int i = qlo + xq, j = kw + g4 + 8 * (e >> 1);
        const float p = kept(i, j, s) ? exp2f(fmaf(x[nb][e], scale_log2, -f[xq])) : 0.f;
        x[nb][e] = p;
        dp[nb][e] = p * (dp[nb][e] - f[TILE + xq]);  // dS^T
      }
    uint32_t pa[4], dsa[4];
    to_a(pa, x);
    to_a(dsa, dp);
#pragma unroll
    for (int jj = 0; jj < D / 16; ++jj) {
      uint32_t bt[4];
      const int r = step * STEP + (mi % 2) * 8 + mr, c = 2 * jj + mi / 2;
      ldmatrix_x4_trans(bt, sdo + swz<D>(r, c));
      mma_bf16(dva[2 * jj], pa, bt[0], bt[1]);
      mma_bf16(dva[2 * jj + 1], pa, bt[2], bt[3]);
      ldmatrix_x4_trans(bt, sq + swz<D>(r, c));
      mma_bf16(dka[2 * jj], dsa, bt[0], bt[1]);
      mma_bf16(dka[2 * jj + 1], dsa, bt[2], bt[3]);
    }
  }
}

// A warp's 16 keys of dK (times scale) or dV: bf16 into the output, or the
// f32 partial of a split tile's unit (slot >= 0) into `part`.
template <int D>
__device__ __forceinline__ void store_keys(const float (&acc)[D / 8][4], float mul, int slot,
                                           float* part, bf16* out, Strides os, int b, int kvh,
                                           int k_lo, int kw, const Shape& s) {
  const int lane = threadIdx.x % 32;
  const int g4 = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = kw + g4 + 8 * r;
      const int col = j * 8 + 2 * t4;
      if (slot >= 0) {
        *reinterpret_cast<float2*>(part + (key - k_lo) * D + col) =
            make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
      } else if (key < s.Sk) {
        *reinterpret_cast<uint32_t*>(out + b * os.b + kvh * os.h + key * os.s + col) =
            pack_bf16(acc[j][2 * r] * mul, acc[j][2 * r + 1] * mul);
      }
    }
}

// Block u (of U x B x KV): unit u / (B KV) of the schedule for batch and KV
// head u % (B KV): dK and dV of the tile's 64 keys over the unit's
// (query head, query tile) iterations, written as bf16 or, for a split
// tile, as f32 partials.  Warp w takes keys 16 w..16 w + 15 and sums both
// dK and dV of them.
template <int D>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse2p, const float* __restrict__ deltap,
             const int4* __restrict__ units, float* __restrict__ part,
             bf16* __restrict__ dk, bf16* __restrict__ dv, Shape s, int P, float scale,
             Strides qs, Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs) {
  using S = Smem<D>;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t sk = base, sv = base + S::TILE_BYTES;
  auto stage_off = [&](int st) { return 2 * S::TILE_BYTES + st * S::STAGE_A; };

  const int BKV = s.B * s.KV;
  const int bkv = blockIdx.x % BKV;
  const int4 un = units[blockIdx.x / BKV];
  const int b = bkv / s.KV, kvh = bkv % s.KV;
  const int k_lo = un.x * TILE, it0 = un.y, n_it = un.z - un.y;
  const int warp = threadIdx.x / 32;
  const float scale_log2 = scale * LOG2E;
  const int Sqp = s.NQ * TILE;

  int qt0, nq;
  tile_walk(s, un.x, qt0, nq);
  const int q_end = s.causal && s.window > 0 ? imin(s.Sq, k_lo + TILE - 1 + s.window) : s.Sq;

  auto load_it = [&](int n) {
    const int it = it0 + n;
    const int h = kvh * s.G + it / nq, qlo = (qt0 + it % nq) * TILE;
    const int off = stage_off(n % STAGES);
    load_tile<D>(base + off, q + b * qs.b + h * qs.h, qs.s, qlo, s.Sq);
    load_tile<D>(base + off + S::TILE_BYTES, dout + b * dos.b + h * dos.h, dos.s, qlo,
                     s.Sq);
    float* f = reinterpret_cast<float*>(smem + off + 2 * S::TILE_BYTES);
    const long long row0 = ((long long)b * s.H + h) * Sqp + qlo;
    for (int x = threadIdx.x; x < 2 * TILE; x += THREADS)
      f[x] = x < TILE ? lse2p[row0 + x] : deltap[row0 + x - TILE];
  };

  load_tile<D>(sk, k + b * ks.b + kvh * ks.h, ks.s, k_lo, s.Sk);
  load_tile<D>(sv, v + b * vs.b + kvh * vs.h, vs.s, k_lo, s.Sk);
  if (n_it > 0) load_it(0);
  cp_async_commit();

  float dva[D / 8][4], dka[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dva[j][e] = dka[j][e] = 0.f;

  const int kr = warp * 16, kw = k_lo + kr;  // this warp's 16 keys
  for (int n = 0; n < n_it; ++n) {
    if (n + 1 < n_it) load_it(n + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int it = it0 + n;
    const int qlo = (qt0 + it % nq) * TILE;
    const int off = stage_off(n % STAGES);
    const uint32_t sq = base + off, sdo = sq + S::TILE_BYTES;
    const float* f = reinterpret_cast<const float*>(smem + off + 2 * S::TILE_BYTES);
    dkdv_iter<D>(dva, dka, sk, sv, sq, sdo, f, qlo, q_end, kw, kr, s, scale_log2);
    __syncthreads();  // the stage is reloaded by the next iteration
  }
  cp_async_wait<0>();

  float* pk = part + (long long)(bkv * P + imax(un.w, 0)) * 2 * TILE * D;
  float* pv = pk + TILE * D;
  store_keys<D>(dka, scale, un.w, pk, dk, dks, b, kvh, k_lo, kw, s);
  store_keys<D>(dva, 1.f, un.w, pv, dv, dvs, b, kvh, k_lo, kw, s);
}

}  // namespace mma

// ---------------------------------------------------------------------------
// f32: the CUDA-core kernels
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int NT = 256;    // 16 row lanes (tr) x 16 column lanes (tc)
constexpr int FIX = 64;    // rows of the fixed tile: keys (dK/dV) or queries (dQ)
constexpr int STR = 32;    // rows of each streamed tile
constexpr int WP = STR + 1;  // pitch of the (FIX x STR) P and dS tiles

template <int D>
struct Smem {
  static constexpr int PITCH = D + 4;  // conflict-free float4 reads of rows
  static constexpr int FLOATS = 2 * FIX * PITCH + 2 * STR * PITCH + 2 * FIX * WP + 2 * STR;
  static constexpr int BYTES = FLOATS * 4;
  static_assert(BYTES <= 232448, "the f32 tiles exceed a block's shared memory");
};

// Rows [lo, lo + rows) of a (n x D) f32 matrix (row stride rs elements)
// into shared memory at dst (pitch D + 4); rows at or past n are zeros.
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* base, long long rs, int lo,
                                      int rows, int n) {
  constexpr int C4 = D / 4;
  for (int i = threadIdx.x; i < rows * C4; i += NT) {
    const int r = i / C4, c = (i % C4) * 4;
    const float4 x = lo + r < n
                         ? *reinterpret_cast<const float4*>(base + (long long)(lo + r) * rs + c)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * Smem<D>::PITCH + c) = x;
  }
}

// x[i][j] = sum_d A[tr + 16 i][d] C[tc + 16 j][d]: A the fixed (FIX x D)
// tile, C a streamed (STR x D) tile, both of pitch D + 4.
template <int D>
__device__ __forceinline__ void dots(float (&x)[4][2], const float* A, const float* C,
                                     int tr, int tc) {
  constexpr int P = Smem<D>::PITCH;
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i][0] = x[i][1] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], c[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(A + (tr + 16 * i) * P + d);
#pragma unroll
    for (int j = 0; j < 2; ++j) c[j] = *reinterpret_cast<const float4*>(C + (tc + 16 * j) * P + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        x[i][j] = fmaf(a[i].x, c[j].x, x[i][j]);
        x[i][j] = fmaf(a[i].y, c[j].y, x[i][j]);
        x[i][j] = fmaf(a[i].z, c[j].z, x[i][j]);
        x[i][j] = fmaf(a[i].w, c[j].w, x[i][j]);
      }
  }
}

// acc[i][j] += sum_s W[tr + 16 i][s] E[s][tc + 16 j]: W a (FIX x STR) tile
// of pitch WP, E a streamed (STR x D) tile of pitch D + 4.
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[4][D / 16], const float* W,
                                           const float* E, int tr, int tc) {
  constexpr int P = Smem<D>::PITCH;
#pragma unroll 2
  for (int t = 0; t < STR; ++t) {
    float w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = W[(tr + 16 * i) * WP + t];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const float e = E[t * P + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(w[i], e, acc[i][j]);
    }
  }
}

// Rows (b, h, i) of delta = D_i = rowsum(dO * O) in f32, one warp a row.
template <int D>
__global__ void __launch_bounds__(256)
bwd_prep_f32(const float* __restrict__ o, const float* __restrict__ dout,
             float* __restrict__ deltap, Shape s, Strides os, Strides dos) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)s.B * s.H * s.Sq) return;
  const int i = (int)(row % s.Sq), h = (int)(row / s.Sq % s.H), b = (int)(row / s.Sq / s.H);
  const float* x = o + b * os.b + h * os.h + i * os.s;
  const float* y = dout + b * dos.b + h * dos.h + i * dos.s;
  float sum = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32) sum = fmaf(x[c], y[c], sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) deltap[row] = sum;
}

// Block (64 keys, KV head, batch) with DKDV, or (64 queries, head, batch)
// without: the fixed tile (K and V, or Q and dO) stays in shared memory and
// the other two stream past in tiles of 32 rows (Q and dO of each query head
// of the group over the queries that reach the keys, or K and V over the
// keys the queries reach).  Each streamed tile: X = the scores (S^T or S)
// and dX = dP^T or dP, from dots over D; P = exp(scale X - lse) under the
// forward's mask, dS = P (dX - D_i); then dV += P^T dO and dK += dS^T Q,
// or dQ += dS K.  Every thread holds rows tr + 16 i of the fixed tile and
// columns tc + 16 j of its outputs, all sums in f32 FMA.
template <int D, bool DKDV>
__global__ void __launch_bounds__(NT, 1)
bwd_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
        const float* __restrict__ dout, const float* __restrict__ lse,
        const float* __restrict__ deltap, float* __restrict__ g0, float* __restrict__ g1,
        Shape s, float scale, Strides qs, Strides ks, Strides vs, Strides dos, Strides g0s,
        Strides g1s) {
  using S = Smem<D>;
  extern __shared__ float4 smem4[];
  float* fa = reinterpret_cast<float*>(smem4);  // K or Q
  float* fb = fa + FIX * S::PITCH;              // V or dO
  float* sa = fb + FIX * S::PITCH;              // streamed Q or K
  float* sb = sa + STR * S::PITCH;              // streamed dO or V
  float* pw = sb + STR * S::PITCH;              // P (or P^T)
  float* dsw = pw + FIX * WP;                   // dS (or dS^T)
  float* rows = dsw + FIX * WP;                 // lse and D of streamed queries

  const int tr = threadIdx.x % 16, tc = threadIdx.x / 16;
  const int b = blockIdx.z, hh = blockIdx.y;  // KV head (DKDV) or query head
  const int tile = DKDV || !s.causal ? blockIdx.x : gridDim.x - 1 - blockIdx.x;
  const int lo = tile * FIX;

  float acc0[4][D / 16], acc1[4][D / 16];  // dV and dK, or dQ (acc0)
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc0[i][j] = acc1[i][j] = 0.f;

  // the fixed rows' lse and D (dQ)
  float lse_f[4] = {0.f, 0.f, 0.f, 0.f}, dl_f[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (DKDV) {
    stage<D>(fa, k + b * ks.b + hh * ks.h, ks.s, lo, FIX, s.Sk);
    stage<D>(fb, v + b * vs.b + hh * vs.h, vs.s, lo, FIX, s.Sk);
  } else {
    stage<D>(fa, q + b * qs.b + hh * qs.h, qs.s, lo, FIX, s.Sq);
    stage<D>(fb, dout + b * dos.b + hh * dos.h, dos.s, lo, FIX, s.Sq);
    const long long r0 = ((long long)b * s.H + hh) * s.Sq;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = lo + tr + 16 * i;
      if (qi < s.Sq) {
        lse_f[i] = lse[r0 + qi];
        dl_f[i] = deltap[r0 + qi];
      }
    }
  }

  // the streamed walk: per query head of the group (DKDV), the rows
  // [walk_lo, walk_hi) in tiles of STR
  int walk_lo = 0, walk_hi, heads = 1;
  if constexpr (DKDV) {
    heads = s.G;
    walk_hi = s.Sq;
    if (s.causal) {
      walk_lo = lo / STR * STR;
      if (s.window > 0) walk_hi = imin(s.Sq, lo + FIX - 1 + s.window);
    }
  } else {
    walk_hi = s.causal ? imin(s.Sk, lo + FIX) : s.Sk;
    if (s.causal && s.window > 0) walk_lo = imax(0, lo - s.window + 1) / STR * STR;
  }

  for (int g = 0; g < heads; ++g) {
    const int h = DKDV ? hh * s.G + g : hh;
    const long long r0 = ((long long)b * s.H + h) * s.Sq;
    for (int slo = walk_lo; slo < walk_hi; slo += STR) {
      __syncthreads();  // the previous tile's readers are done
      if constexpr (DKDV) {
        stage<D>(sa, q + b * qs.b + h * qs.h, qs.s, slo, STR, s.Sq);
        stage<D>(sb, dout + b * dos.b + h * dos.h, dos.s, slo, STR, s.Sq);
        for (int x = threadIdx.x; x < 2 * STR; x += NT) {
          const int qi = slo + x % STR;
          rows[x] = qi < s.Sq ? (x < STR ? lse[r0 + qi] : deltap[r0 + qi]) : 0.f;
        }
      } else {
        const int kvh = h / s.G;
        stage<D>(sa, k + b * ks.b + kvh * ks.h, ks.s, slo, STR, s.Sk);
        stage<D>(sb, v + b * vs.b + kvh * vs.h, vs.s, slo, STR, s.Sk);
      }
      __syncthreads();
      float x[4][2], dx[4][2];
      dots<D>(x, fa, sa, tr, tc);
      dots<D>(dx, fb, sb, tr, tc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int fi = lo + tr + 16 * i, si = slo + tc + 16 * j;
          const int qi = DKDV ? si : fi, kj = DKDV ? fi : si;
          const float l = DKDV ? rows[tc + 16 * j] : lse_f[i];
          const float dl = DKDV ? rows[STR + tc + 16 * j] : dl_f[i];
          const float p = kept(qi, kj, s) ? expf(fmaf(x[i][j], scale, -l)) : 0.f;
          pw[(tr + 16 * i) * WP + tc + 16 * j] = p;
          dsw[(tr + 16 * i) * WP + tc + 16 * j] = p * (dx[i][j] - dl);
        }
      __syncthreads();
      if constexpr (DKDV) {
        accumulate<D>(acc0, pw, sb, tr, tc);   // dV += P^T dO
        accumulate<D>(acc1, dsw, sa, tr, tc);  // dK += dS^T Q
      } else {
        accumulate<D>(acc0, dsw, sa, tr, tc);  // dQ += dS K
      }
    }
  }

  // dK = scale acc1 and dV = acc0 of the keys, or dQ = scale acc0
  const int n = DKDV ? s.Sk : s.Sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = lo + tr + 16 * i;
    if (r >= n) continue;
    float* o0 = g0 + b * g0s.b + hh * g0s.h + (long long)r * g0s.s;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) o0[tc + 16 * j] = DKDV ? acc0[i][j] : acc0[i][j] * scale;
    if constexpr (DKDV) {
      float* o1 = g1 + b * g1s.b + hh * g1s.h + (long long)r * g1s.s;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) o1[tc + 16 * j] = acc1[i][j] * scale;
    }
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* o, const float* dout,
           const float* lse, void* work, long long work_bytes, float* dq, float* dk,
           float* dv, const Shape& s, Strides qs, Strides ks, Strides vs, Strides os,
           Strides dos, Strides dqs, Strides dks, Strides dvs, cudaStream_t stream) {
  const long long rows = (long long)s.B * s.H * s.Sq;
  if (work_bytes < rows * 4) return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(bwd_f32<D, true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Smem<D>::BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(bwd_f32<D, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Smem<D>::BYTES);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  float* deltap = static_cast<float*>(work);
  bwd_prep_f32<D><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(o, dout, deltap, s, os, dos);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const float scale = 1.f / sqrtf((float)D);
  // dQ: the longest causal walks (the last query tiles) launch first
  bwd_f32<D, false><<<dim3(cdiv(s.Sq, FIX), s.H, s.B), NT, Smem<D>::BYTES, stream>>>(
      q, k, v, dout, lse, deltap, dq, nullptr, s, scale, qs, ks, vs, dos, dqs, dqs);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // dK/dV: the first key tiles walk the most queries and launch first
  bwd_f32<D, true><<<dim3(cdiv(s.Sk, FIX), s.KV, s.B), NT, Smem<D>::BYTES, stream>>>(
      q, k, v, dout, lse, deltap, dv, dk, s, scale, qs, ks, vs, dos, dvs, dks);
  return (int)cudaGetLastError();
}

}  // namespace f32


// The scratch of one call: lse2 and delta (B H NQ 64 f32 each), the schedule
// (U + M int4), the partials (B KV P x 2 x 64 x D f32).
struct Work {
  float* lse2p;
  float* deltap;
  int4* units;
  int4* merges;
  float* part;
  long long bytes;
};

Work layout(void* work, const Shape& s, int U, int P, int M, int D) {
  const long long rows = (long long)s.B * s.H * s.NQ * TILE;
  const long long off_table = (8 * rows + 15) / 16 * 16;
  const long long off_part = (off_table + 16ll * (U + M) + 255) / 256 * 256;
  char* w = static_cast<char*>(work);
  Work r;
  r.lse2p = reinterpret_cast<float*>(w);
  r.deltap = r.lse2p + rows;
  r.units = reinterpret_cast<int4*>(w + off_table);
  r.merges = r.units + U;
  r.part = reinterpret_cast<float*>(w + off_part);
  r.bytes = off_part + (long long)s.B * s.KV * P * 2 * TILE * D * 4;
  return r;
}

int device_sms() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
           const float* lse, void* work, long long work_bytes, bf16* dq, bf16* dk,
           bf16* dv, const Shape& s, Strides qs, Strides ks, Strides vs, Strides os,
           Strides dos, Strides dqs, Strides dks, Strides dvs, cudaStream_t stream) {
  int U, P, M;
  plan_counts(s, U, P, M);
  const Work w = layout(work, s, U, P, M, D);
  if (work_bytes < w.bytes) return (int)cudaErrorInvalidValue;
  constexpr bool TC = D >= 64;  // D = 32: the mma.sync kernels
  static bool configured = false;
  if (!configured) {
    cudaError_t e;
    if constexpr (TC) {
      e = cudaFuncSetAttribute(tc::bwd_dq_dkdv_tc<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, tc::Cfg<D>::SMEM);
    } else {
      e = cudaFuncSetAttribute(mma::bwd_dq_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               mma::Smem<D>::DQ);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(mma::bwd_dkdv_mma<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 mma::Smem<D>::DKDV);
    }
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const float scale = 1.f / sqrtf((float)D);
  const long long rows = (long long)s.B * s.H * s.NQ * TILE;
  const long long prep_blocks = (rows + 256 / (D / 8) - 1) / (256 / (D / 8));
  bwd_prep<D><<<(unsigned)(prep_blocks + 1), 256, 0, stream>>>(
      o, dout, lse, w.lse2p, w.deltap, w.units, w.merges, s, os, dos);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long units = (long long)U * s.B * s.KV;
  if constexpr (TC) {
    using C = tc::Cfg<D>;
    CUtensorMap tq, tk, tv, tdo;
    if (!tc::encode(&tq, q, s.B, s.H, s.Sq, D, qs) ||
        !tc::encode(&tk, k, s.B, s.KV, s.Sk, D, ks) ||
        !tc::encode(&tv, v, s.B, s.KV, s.Sk, D, vs) ||
        !tc::encode(&tdo, dout, s.B, s.H, s.Sq, D, dos))
      return (int)cudaErrorInvalidValue;
    // one block per SM at most, each running C::W workers
    const long long per_block = (units + (long long)s.NQ * s.B * s.H + C::W - 1) / C::W;
    const int sms = device_sms();
    const int blocks = per_block < sms ? (int)per_block : sms;
    tc::bwd_dq_dkdv_tc<D><<<blocks, C::THREADS, C::SMEM, stream>>>(
        tq, tk, tv, tdo, w.lse2p, w.deltap, w.units, w.part, dq, dk, dv, s, U, P, scale, dqs,
        dks, dvs);
  } else {
    mma::bwd_dq_mma<D><<<dim3(s.NQ, s.H, s.B), mma::THREADS, mma::Smem<D>::DQ, stream>>>(
        q, k, v, dout, w.lse2p, w.deltap, dq, s, scale, qs, ks, vs, dos, dqs);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    mma::bwd_dkdv_mma<D><<<(unsigned)units, mma::THREADS, mma::Smem<D>::DKDV,
                           stream>>>(
        q, k, v, dout, w.lse2p, w.deltap, w.units, w.part, dk, dv, s, P, scale, qs, ks, vs,
        dos, dks, dvs);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess || M == 0) return (int)e;
  bwd_merge<D><<<dim3(M, s.B * s.KV, 4), 256, 0, stream>>>(w.part, w.merges, dk, dv, s, P,
                                                        scale, dks, dvs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The backward of flash_attention_fwd.  q, o, dout, dq: (B, H, Sq, D); k,
// v, dk, dv: (B, KV, Sk, D); each addressed through element strides (batch,
// head, position) with a contiguous last dim and 16-byte aligned rows.
// lse: the forward's contiguous (B, H, Sq) f32 log-sum-exp.  causal and
// window as in the forward.  dtype: 0 = float32 (CUDA cores), 1 = bfloat16
// (tensor cores).  D of 32, 64, 128 or 256; Sq >= 1.  unit_cap: the bf16
// dK/dV schedule's cap T (ops.py :: plan_bwd_units; the f32 kernels do not
// read it); work: a 256-byte aligned scratch of work_bytes, at least what
// the call needs (ops.py :: bwd_work_bytes).  Returns cudaGetLastError(),
// or cudaErrorInvalidValue for arguments it does not take.
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const void* lse, void* work, void* dq, void* dk,
                        void* dv, int B, int H, int KV, int Sq, int Sk, int D, int window,
                        int causal, int dtype, int unit_cap, long long work_bytes, long long qsb,
                        long long qsh, long long qss, long long ksb, long long ksh,
                        long long kss, long long vsb, long long vsh, long long vss,
                        long long osb, long long osh, long long oss, long long dosb,
                        long long dosh, long long doss, long long dqsb, long long dqsh,
                        long long dqss, long long dksb, long long dksh, long long dkss,
                        long long dvsb, long long dvsh, long long dvss, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV || unit_cap < 1)
    return (int)cudaErrorInvalidValue;
  const Shape s{B, H, KV, H / KV, Sq, Sk, window, causal, cdiv(Sq, TILE), cdiv(Sk, TILE),
                unit_cap};
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss}, os{osb, osh, oss},
      dos{dosb, dosh, doss}, dqs{dqsb, dqsh, dqss}, dks{dksb, dksh, dkss},
      dvs{dvsb, dvsh, dvss};
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  auto args = [&](auto tag) {
    constexpr int DD = decltype(tag)::value;
    if (dtype == 0)
      return f32::launch<DD>(static_cast<const float*>(q), static_cast<const float*>(k),
                             static_cast<const float*>(v), static_cast<const float*>(o),
                             static_cast<const float*>(dout), static_cast<const float*>(lse),
                             work, work_bytes, static_cast<float*>(dq),
                             static_cast<float*>(dk), static_cast<float*>(dv), s, qs, ks, vs,
                             os, dos, dqs, dks, dvs, static_cast<cudaStream_t>(stream));
    return launch<DD>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
                      static_cast<const bf16*>(dout), static_cast<const float*>(lse), work,
                      work_bytes, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                      static_cast<bf16*>(dv), s, qs, ks, vs, os, dos, dqs, dks, dvs,
                      static_cast<cudaStream_t>(stream));
  };
  switch (D) {
    case 32:
      return args(std::integral_constant<int, 32>{});
    case 64:
      return args(std::integral_constant<int, 64>{});
    case 128:
      return args(std::integral_constant<int, 128>{});
    case 256:
      return args(std::integral_constant<int, 256>{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
