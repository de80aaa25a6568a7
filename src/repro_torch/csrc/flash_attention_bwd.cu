// Backward of the GQA flash attention of flash_attention.cu on Hopper:
// dQ, dK and dV for causal (optionally sliding-window) attention at
// Sq == Sk and for non-causal attention at any Sk, bf16, head dims 32, 64
// and 128.
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
// come near the bound.
//
// What the design does about it.  Three launches on one stream, all
// deterministic (no atomics), so that two runs give the same bits:
//   1. bwd_delta: D_i = rowsum(dO * O) in f32, one warp per row;
//   2. bwd_dq, one block per (64 query rows, head, batch): each warp keeps
//      its 16 query rows of Q and dO as mma.sync A fragments in registers
//      and walks the key tiles that reach them (64 rows of K and V by
//      16-byte cp.async into a double-buffered ring of XOR-swizzled
//      shared memory), 16 keys at a time: S and dP on mma.sync m16n8k16
//      (bf16 in, f32 accumulate), P and dS in registers, dS rounded to
//      bf16 as the A operand of dQ += dS K (K by ldmatrix.trans); dQ stays
//      in f32 registers;
//   3. bwd_dkdv, one block per (64 key rows, KV head, batch): K and V stay
//      in shared memory, each warp owns 16 keys and walks the G query
//      heads of its KV head and, for each, the query tiles that reach its
//      keys (Q, dO, lse and D of 64 rows double-buffered), 16 queries at a
//      time: S^T = K Q^T and dP^T = V dO^T, P^T and dS^T rounded to bf16
//      as A operands of dV += P^T dO and dK += dS^T Q; dK and dV stay in
//      f32 registers across all G heads, and are written once.
// Fully masked tiles are skipped as the forward skips them (the key loop
// runs from the window's edge to the diagonal, the query loop from the
// diagonal to the window's end), and each warp skips the 16 x 16 steps
// its causal or window mask empties.  Rows past S are read as zeros
// (cp.async with a zero source size), masked, and never stored.
// wgmma, TMA and warp specialisation are left to a later design.
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

constexpr int THREADS = 128;  // four warps
constexpr int TILE = 64;      // rows of a staged tile: 16 per warp
constexpr int STEP = 16;      // keys (dq) or queries (dkdv) per inner step
constexpr int STAGES = 2;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Smem {
  static constexpr int TILE_BYTES = TILE * D * 2;
  // dkdv: K and V, then STAGES x (Q, dO, lse2[TILE], delta[TILE])
  static constexpr int STAGE_A = 2 * TILE_BYTES + 2 * TILE * 4;
  static constexpr int DKDV = 2 * TILE_BYTES + STAGES * STAGE_A;
  // dq: Q and dO, then STAGES x (K, V)
  static constexpr int STAGE_B = 2 * TILE_BYTES;
  static constexpr int DQ = 2 * TILE_BYTES + STAGES * STAGE_B;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// Byte offset of 16-byte chunk c of row r in a tile of rows of D bf16:
// chunk c is stored at c ^ f(r), so that the 8 rows an ldmatrix reads at
// one chunk column fall in 8 different 16-byte bank groups: f(r) = r % 8
// for rows of 128 bytes or more, (r / 2) % 4 for D = 32's 64-byte rows
// (two rows to 128 bytes).
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  if constexpr (D >= 64)
    return r * (D * 2) + ((c ^ (r & 7)) << 4);
  else
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

// The forward's mask: query i over key j.
__device__ __forceinline__ bool kept(int i, int j, int Sq, int Sk, int window,
                                     int causal) {
  return i < Sq && j < Sk && (!causal || (j <= i && (window <= 0 || j > i - window)));
}

// D_i = sum_d dO[i, d] * O[i, d] in f32, one warp per (b, h, i) row, into
// the contiguous (B, H, Sq) delta.
__global__ void __launch_bounds__(256)
bwd_delta(const bf16* __restrict__ o, const bf16* __restrict__ dout,
          float* __restrict__ delta, long long rows, int H, int Sq, int D, Strides os,
          Strides dos) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int i = (int)(row % Sq);
  const long long bh = row / Sq;
  const int h = (int)(bh % H), b = (int)(bh / H);
  const bf16* orow = o + b * os.b + h * os.h + i * os.s;
  const bf16* drow = dout + b * dos.b + h * dos.h + i * dos.s;
  float s = 0.f;
  for (int c = lane; c < D; c += 32)
    s = fmaf(__bfloat162float(orow[c]), __bfloat162float(drow[c]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// Block (query tile, head, batch): dQ of 64 query rows over the key tiles
// that reach them.
template <int D>
__global__ void __launch_bounds__(THREADS)
bwd_dq(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
       const bf16* __restrict__ dout, const float* __restrict__ lse,
       const float* __restrict__ delta, bf16* __restrict__ dq, int Sq, int Sk, int G,
       int window, int causal, float scale, Strides qs, Strides ks, Strides vs,
       Strides dos, Strides dqs) {
  using S = Smem<D>;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t sq = base, sdo = base + S::TILE_BYTES;
  auto stage = [&](int st) { return base + 2 * S::TILE_BYTES + st * S::STAGE_B; };

  const int q_lo = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z, kvh = h / G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mi = lane / 8, mr = lane % 8;  // ldmatrix: matrix, row of it
  const int g4 = lane / 4, t4 = lane % 4;  // mma fragment row, column pair
  const float scale_log2 = scale * LOG2E;

  // causal: from the window's edge to the diagonal; non-causal: all keys
  int kv_begin = 0;
  if (causal && window > 0) kv_begin = max(0, q_lo - window + 1) / TILE * TILE;
  const int kv_end = causal ? min(Sk, q_lo + TILE) : Sk;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + TILE - 1) / TILE : 0;

  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;
  auto load_kv = [&](int t) {
    const uint32_t st = stage(t % STAGES);
    const int lo = kv_begin + t * TILE;
    load_tile<D>(st, kb, ks.s, lo, Sk);
    load_tile<D>(st + S::TILE_BYTES, vb, vs.s, lo, Sk);
  };

  load_tile<D>(sq, q + b * qs.b + h * qs.h, qs.s, q_lo, Sq);
  load_tile<D>(sdo, dout + b * dos.b + h * dos.h, dos.s, q_lo, Sq);
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
  const long long row0 = ((long long)b * gridDim.y + h) * Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = qw + g4 + 8 * r;
    lse2[r] = i < Sq ? lse[row0 + i] * LOG2E : 0.f;
    dl[r] = i < Sq ? delta[row0 + i] : 0.f;
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
      if (k0 >= Sk || qw >= Sq) break;
      if (causal && (k0 > qw + STEP - 1 ||
                     (window > 0 && k0 + STEP - 1 <= qw - window)))
        continue;
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t bk[4], bv[4];  // {n-block 0: k lo, k hi; n-block 1: k lo, k hi}
        const int r = step * STEP + (mi / 2) * 8 + mr, c = 2 * kk + mi % 2;
        ldmatrix_x4(bk, sk + swz<D>(r, c));
        ldmatrix_x4(bv, sv + swz<D>(r, c));
        mma_bf16(s[0], qa[kk], bk[0], bk[1]);
        mma_bf16(s[1], qa[kk], bk[2], bk[3]);
        mma_bf16(dp[0], da[kk], bv[0], bv[1]);
        mma_bf16(dp[1], da[kk], bv[2], bv[3]);
      }
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int i = qw + g4 + 8 * r, j = k0 + nb * 8 + 2 * t4 + (e & 1);
          const float p = kept(i, j, Sq, Sk, window, causal)
                              ? exp2f(fmaf(s[nb][e], scale_log2, -lse2[r]))
                              : 0.f;
          s[nb][e] = p * (dp[nb][e] - dl[r]);  // dS
        }
      uint32_t dsa[4];
      to_a(dsa, s);
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
      if (i < Sq) {
        bf16* dst = dq + b * dqs.b + h * dqs.h + i * dqs.s + j * 8 + 2 * t4;
        *reinterpret_cast<uint32_t*>(dst) =
            pack_bf16(acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
      }
    }
}

// Block (key tile, KV head, batch): dK and dV of 64 key rows over the G
// query heads of the KV head and the query tiles that reach the keys.
template <int D>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv(const bf16* __restrict__ q, const bf16* __restrict__ k,
         const bf16* __restrict__ v, const bf16* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ delta,
         bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Sq, int Sk, int G,
         int window, int causal, float scale, Strides qs, Strides ks, Strides vs,
         Strides dos, Strides dks, Strides dvs) {
  using S = Smem<D>;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t sk = base, sv = base + S::TILE_BYTES;
  auto stage_off = [&](int st) { return 2 * S::TILE_BYTES + st * S::STAGE_A; };

  const int k_lo = blockIdx.x * TILE, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mi = lane / 8, mr = lane % 8;
  const int g4 = lane / 4, t4 = lane % 4;
  const float scale_log2 = scale * LOG2E;

  // queries that see any key of the tile: causal, from its first key to
  // its last key's window; non-causal, all
  int q_begin = 0, q_end = Sq;
  if (causal) {
    q_begin = k_lo;
    if (window > 0) q_end = min(Sq, k_lo + TILE - 1 + window);
  }
  const int qt0 = q_begin / TILE;
  const int nq = q_end > q_begin ? (q_end - 1) / TILE - qt0 + 1 : 0;
  const int n_it = G * nq;  // (query head, query tile) pairs

  auto load_it = [&](int it) {
    const int h = kvh * G + it / nq, qlo = (qt0 + it % nq) * TILE;
    const int off = stage_off(it % STAGES);
    load_tile<D>(base + off, q + b * qs.b + h * qs.h, qs.s, qlo, Sq);
    load_tile<D>(base + off + S::TILE_BYTES, dout + b * dos.b + h * dos.h, dos.s, qlo, Sq);
    // lse (in log2 units) and D by plain loads: a (b, h) row of the
    // (B, H, Sq) tensors starts 16-byte aligned only where Sq % 4 == 0
    float* f = reinterpret_cast<float*>(smem + off + 2 * S::TILE_BYTES);
    const long long row0 = ((long long)b * H + h) * Sq;
    for (int x = threadIdx.x; x < 2 * TILE; x += THREADS) {
      const int i = qlo + x % TILE;
      f[x] = i >= Sq ? 0.f : x < TILE ? lse[row0 + i] * LOG2E : delta[row0 + i];
    }
  };

  load_tile<D>(sk, k + b * ks.b + kvh * ks.h, ks.s, k_lo, Sk);
  load_tile<D>(sv, v + b * vs.b + kvh * vs.h, vs.s, k_lo, Sk);
  if (n_it > 0) load_it(0);
  cp_async_commit();

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  const int kw = k_lo + warp * 16;  // this warp's 16 keys
  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) load_it(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int qlo = (qt0 + it % nq) * TILE;
    const int off = stage_off(it % STAGES);
    const uint32_t sq = base + off, sdo = sq + S::TILE_BYTES;
    const float* f = reinterpret_cast<const float*>(smem + off + 2 * S::TILE_BYTES);
#pragma unroll 1
    for (int step = 0; step < TILE / STEP; ++step) {
      const int q0 = qlo + step * STEP;
      // queries past the range, keys past Sk, or 16 x 16 wholly masked
      if (q0 >= q_end || kw >= Sk) break;
      if (causal && (q0 + STEP - 1 < kw ||
                     (window > 0 && q0 >= kw + STEP - 1 + window)))
        continue;
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 16 queries
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4], bq[4];
        const int ra = warp * 16 + (mi % 2) * 8 + mr, ca = 2 * kk + mi / 2;
        const int rb = step * STEP + (mi / 2) * 8 + mr, cb = 2 * kk + mi % 2;
        ldmatrix_x4(a, sk + swz<D>(ra, ca));
        ldmatrix_x4(bq, sq + swz<D>(rb, cb));
        mma_bf16(s[0], a, bq[0], bq[1]);
        mma_bf16(s[1], a, bq[2], bq[3]);
        ldmatrix_x4(a, sv + swz<D>(ra, ca));
        ldmatrix_x4(bq, sdo + swz<D>(rb, cb));
        mma_bf16(dp[0], a, bq[0], bq[1]);
        mma_bf16(dp[1], a, bq[2], bq[3]);
      }
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = step * STEP + nb * 8 + 2 * t4 + (e & 1);  // query in tile
          const int i = qlo + x, j = kw + g4 + 8 * (e >> 1);
          const float p = kept(i, j, Sq, Sk, window, causal)
                              ? exp2f(fmaf(s[nb][e], scale_log2, -f[x]))
                              : 0.f;
          s[nb][e] = p;
          dp[nb][e] = p * (dp[nb][e] - f[TILE + x]);  // dS^T
        }
      uint32_t pa[4], dsa[4];
      to_a(pa, s);
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
    __syncthreads();  // the stage is reloaded by the next iteration
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = kw + g4 + 8 * r;
      if (key < Sk) {
        const int col = j * 8 + 2 * t4;
        *reinterpret_cast<uint32_t*>(dk + b * dks.b + kvh * dks.h + key * dks.s + col) =
            pack_bf16(dka[j][2 * r] * scale, dka[j][2 * r + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + b * dvs.b + kvh * dvs.h + key * dvs.s + col) =
            pack_bf16(dva[j][2 * r], dva[j][2 * r + 1]);
      }
    }
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
           const float* lse, float* delta, bf16* dq, bf16* dk, bf16* dv, int B, int H,
           int KV, int Sq, int Sk, int window, int causal, Strides qs, Strides ks,
           Strides vs, Strides os, Strides dos, Strides dqs, Strides dks, Strides dvs,
           cudaStream_t stream) {
  using S = Smem<D>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        bwd_dq<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::DQ);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(bwd_dkdv<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               S::DKDV);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const float scale = 1.f / sqrtf((float)D);
  const long long rows = (long long)B * H * Sq;
  bwd_delta<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(o, dout, delta, rows, H, Sq, D,
                                                              os, dos);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bwd_dq<D><<<dim3((Sq + TILE - 1) / TILE, H, B), THREADS, S::DQ, stream>>>(
      q, k, v, dout, lse, delta, dq, Sq, Sk, H / KV, window, causal, scale, qs, ks, vs, dos,
      dqs);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bwd_dkdv<D><<<dim3((Sk + TILE - 1) / TILE, KV, B), THREADS, S::DKDV, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, H, Sq, Sk, H / KV, window, causal, scale, qs, ks,
      vs, dos, dks, dvs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The backward of flash_attention_fwd's bf16 path.  q, o, dout, dq:
// (B, H, Sq, D); k, v, dk, dv: (B, KV, Sk, D); each addressed through
// element strides (batch, head, position) with a contiguous last dim and
// 16-byte aligned rows.  lse: the forward's contiguous (B, H, Sq) f32
// log-sum-exp; delta: a contiguous (B, H, Sq) f32 scratch that receives
// D_i.  causal and window as in the forward.  D of 32, 64 or 128; Sq >= 1.
// Returns cudaGetLastError().
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const void* lse, void* delta, void* dq, void* dk,
                        void* dv, int B, int H, int KV, int Sq, int Sk, int D, int window,
                        int causal, long long qsb, long long qsh, long long qss,
                        long long ksb, long long ksh, long long kss, long long vsb,
                        long long vsh, long long vss, long long osb, long long osh,
                        long long oss, long long dosb, long long dosh, long long doss,
                        long long dqsb, long long dqsh, long long dqss, long long dksb,
                        long long dksh, long long dkss, long long dvsb, long long dvsh,
                        long long dvss, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV) return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss}, os{osb, osh, oss},
      dos{dosb, dosh, doss}, dqs{dqsb, dqsh, dqss}, dks{dksb, dksh, dkss},
      dvs{dvsb, dvsh, dvss};
  auto args = [&](auto tag) {
    constexpr int DD = decltype(tag)::value;
    return launch<DD>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
                      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
                      static_cast<float*>(delta), static_cast<bf16*>(dq),
                      static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, H, KV, Sq, Sk,
                      window, causal, qs, ks, vs, os, dos, dqs, dks, dvs,
                      static_cast<cudaStream_t>(stream));
  };
  switch (D) {
    case 32:
      return args(std::integral_constant<int, 32>{});
    case 64:
      return args(std::integral_constant<int, 64>{});
    case 128:
      return args(std::integral_constant<int, 128>{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
