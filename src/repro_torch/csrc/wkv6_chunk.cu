// The WKV6 recurrence of RWKV6 "Finch" (rwkv6-7b) in chunks, on Hopper's
// tensor cores: the bf16 prefill path, D = 64.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan/kernel.py ::
// wkv6_scan (body _wkv6_kernel) for bf16 prompts of S >= 2 tokens, reached
// through ops.py :: wkv6_op; decode (S = 1) and f32 stay on wkv6_scan.cu.
// Per (batch, head), with a (D, D) f32 state S (k-dim x v-dim):
//
//   o_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t
//   S_t = diag(exp(logw_t)) S_{t-1} + k_t^T v_t
//
// In a chunk of C = 64 tokens, with cum the inclusive prefix sum of logw
// (here in log2 units) and excl[t] = cum[t - 1] (0 at t = 0):
//
//   o     = (r * 2^excl) S0 + A v + (r . (u * k)) v
//   A[t,s] = sum_c r[t,c] k[s,c] 2^(excl[t,c] - cum[s,c])   (s < t)
//   S     = diag(2^cum_last) S0 + (k * 2^(cum_last - cum))^T v
//
// A is built in sub-chunks of 16 tokens.  On the diagonal sub-chunks it is
// computed pair by pair on the CUDA cores.  Below them, the pair (i, j),
// j < i, factors through B_i = cum at the last token of sub-chunk i - 1:
// A_ij = (r_i * 2^(excl_i - B_i)) (k_j * 2^(B_i - cum_j))^T, a 16 x 16 x D
// product on the tensor cores.  Every exponent is <= 0: the prefix sum of
// logw <= 0 does not increase, in floating point too, and each difference
// above subtracts a later cum from an earlier one.  Nothing is divided by
// a decay, so strong decays (logw ~ -7 per token, where 2^-cum over a
// chunk would overflow f32) underflow to 0 instead.  This is the TPU
// kernel's chunked form, whose docstring avoids the 1/decay factorisation
// of GPU kernels for the same reason.
//
// What bounds it on the H100.  At S = 1000, H = 64 it reads ~51 MB (r, k,
// v and o in bf16, logw in f32, the state twice in f32): ~15 us at
// 3.35 TB/s.  The tensor-core products of the chunked form are ~1.6
// GFLOP: ~2 us at 989 TFLOP/s, ~3x that with the hi/lo operands below.
// Per (head, chunk) the form also takes ~48k exponentials (30k of them on
// the diagonal sub-chunks): ~12 us for the whole call at the SFU's 16 per
// clock per SM.  The 64-token chunks of one head are sequential, and at
// B = 1 one head's work is all that two SMs have, so what bounds the
// kernel in practice is the latency of each chunk's dependent phases.
//
// What the design does about it.  The TPU kernel walks the chunks on a
// sequential grid axis and carries the state in scratch; Hopper runs
// blocks in no order, so here one block owns 32 v-columns of one (b, h)
// (grid (D / 32, H, B), 128 blocks at B = 1, H = 64) and walks the chunks
// itself.  The two column blocks of a head form a cluster: everything that
// does not depend on v (the decayed operands, the bonus, the diagonal
// blocks of A) is computed half by each and written to both blocks'
// shared memory, so no SM repeats the other's exponentials.  Of the 8
// warps, warps 0-3 compute the 16 output rows of sub-chunk w each; warps
// 4-7 hold the (64 x 32) f32 state slice in mma accumulators for the whole
// sequence (16 rows each), update it per chunk and stage it in shared
// memory, and in the time that leaves them while the output warps finish
// a chunk they load chunk n + 2 by cp.async into a 3-stage ring and take
// chunk n + 1's prefix sum of logw in place (two runs of 32 tokens per
// channel, joined in one order).  Rows past S are zero-filled (r = k = v
// = 0, logw = 0: nothing added, nothing decayed), so the state at S is
// exact and S needs no multiple of 64.  Per chunk, all warps build the
// decayed operands and the diagonal blocks of A; then the products run on
// mma.sync.m16n8k16: the inter term, A_wj for j < w (straight from the
// accumulators into A fragments), A_ww by ldmatrix, A v with v by
// ldmatrix.trans, the state update with k_dec by ldmatrix.trans as the A
// operand; the bonus is added in f32.  The cluster barrier before a
// chunk's operands are written is split: a block arrives once it has read
// its previous operands and waits only when it is about to write.
//
// Every tensor-core operand is split into bf16 hi + lo (x - hi), and each
// product is taken as hi*hi + hi*lo + lo*hi, which reads its operands to
// ~16 bits.  With single bf16 operands the output rows' error against the
// f32 recurrence read up to 0.042 of their RMS at H = 64 (bf16 output
// rounding alone reads ~0.012), and the output missed the plain version's
// 2e-2 tolerance at S = 1000 and 2048; with the split they read as the
// output rounding does and the state stays within ~2e-5 of f32.  A, the
// one operand of A v that is not a bf16 input, is split further, into
// hi + lo + lo2 (lo2 = x - hi - lo), ~24 bits, taken against v in three
// products.  Read to 16 bits, A rounds ~0.3% of the outputs to the other
// bf16 neighbour of the f32 recurrence's, and training rwkv6-7b's
// gradients then stray from the f32 run's ~1.4x as far as the plain bf16
// run's do; at 24 bits they stray as the plain run's (an emulation of the
// split on the card; the other operands at 24 bits change nothing there).
// C = 64 and sub-chunks of 16 (the mma's rows, one sub-chunk per output
// warp) keep the pairwise diagonal work at a quarter of the chunk's pairs
// and the shared memory at ~217 KB with three stages; 8 warps is what the
// registers of the output warps' fragments allow.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
namespace cg = cooperative_groups;

constexpr int D = 64;      // head dim
constexpr int C = 64;      // tokens per chunk
constexpr int SUB = 16;    // tokens per sub-chunk
constexpr int NSUB = C / SUB;
constexpr int COLS = 32;   // v-columns (state columns) per block
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
// warps 0..NSUB-1 compute the output rows of their sub-chunk, warps NSUB..
// hold and update 16 state rows each
static_assert(WARPS == 2 * NSUB && D == NSUB * 16, "warp roles");
// the two column blocks of a head form a cluster and split the work that
// does not depend on v (the decayed operands and the diagonal blocks)
constexpr int CLUSTER = D / COLS;
static_assert(CLUSTER == 2, "one peer");

// row pitches in elements, padded so that the 8 rows one ldmatrix (or one
// quarter-warp's 16-byte loads) reads fall in distinct bank groups
constexpr int PK = D + 8;     // bf16 (., D) tiles: 144 B
constexpr int PV = COLS + 8;  // bf16 (., COLS) tiles: 80 B
constexpr int PW = D + 4;     // f32 logw / cum: 272 B
constexpr int PA = SUB + 8;   // bf16 diagonal blocks of A: 48 B
constexpr int KQ_ROWS = SUB * NSUB * (NSUB - 1) / 2;  // k_j rows over all i

// byte offsets in dynamic shared memory: STAGES stages of inputs, then the
// chunk's tensor-core operands, each as a bf16 high half and, right after
// it, the low half (x - hi); the diagonal blocks of A also a third part
constexpr int R_OFF = 0;
constexpr int K_OFF = R_OFF + C * PK * 2;
constexpr int V_OFF = K_OFF + C * PK * 2;
constexpr int W_OFF = V_OFF + C * PV * 2;
constexpr int STAGE = W_OFF + C * PW * 4;
constexpr int RDEC_LO = C * PK * 2;
constexpr int RQ_LO = (C - SUB) * PK * 2;
constexpr int KQ_LO = KQ_ROWS * PK * 2;
constexpr int AD_LO = C * PA * 2;
constexpr int S_LO = D * PV * 2;
constexpr int STAGES = 3;  // chunk n is computed, n + 1 scanned, n + 2 loaded
constexpr int RDEC = STAGES * STAGE;         // r * 2^excl        (C, D)
constexpr int KDEC = RDEC + 2 * RDEC_LO;     // k * 2^(last-cum)  (C, D)
constexpr int RQ = KDEC + 2 * RDEC_LO;       // r_i * 2^(excl-B_i), i >= 1
constexpr int KQ = RQ + 2 * RQ_LO;           // k_j * 2^(B_i-cum), j < i
constexpr int AD = KQ + 2 * KQ_LO;           // diagonal blocks of A (C, SUB), 3 parts
constexpr int SH = AD + 3 * AD_LO;           // S0 (D, COLS)
constexpr int BONUS = SH + 2 * S_LO;         // r . (u * k), f32 (C,)
constexpr int US = BONUS + C * 4;            // u of the head, f32 (D,)
constexpr int TOT = US + D * 4;              // cum's partial sums, f32
// the state warps also load the chunks and take their prefix sums
constexpr int LOADERS = THREADS - NSUB * 32;
constexpr int QT = C * D / LOADERS;          // tokens per thread in the scan
static_assert(LOADERS % D == 0 && C % (LOADERS / D) == 0, "scan split");
constexpr int SMEM = TOT + LOADERS * 4;

constexpr float LOG2E = 1.4426950408889634f;

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
template <int N>  // all but the N most recent groups have landed
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the cluster barrier in two halves: arrive (releasing this thread's
// shared-memory reads and writes) and wait (acquiring the peer's)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// a barrier of the state warps alone
__device__ __forceinline__ void loaders_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(LOADERS) : "memory");
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

// (a_hi + a_lo) (b_hi + b_lo) less the lo * lo product: hi * hi into d,
// the two cross products into x (two accumulators keep the dependent
// chains of mma short)
__device__ __forceinline__ void mma3(float (&d)[4], float (&x)[4],
                                     const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                     uint32_t bh0, uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma_bf16(d, ah, bh0, bh1);
  mma_bf16(x, al, bh0, bh1);
  mma_bf16(x, ah, bl0, bl1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x as hi + lo bf16 pairs: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - f.x, y - f.y);
}

// x as hi + lo + lo2 bf16 pairs, lo2 = bf16(x - hi - lo)
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi, uint32_t& lo,
                                       uint32_t& lo2) {
  split2(x, y, hi, lo);
  const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  const float2 l = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&lo));
  lo2 = pack_bf16(x - h.x - l.x, y - h.y - l.y);
}

// 2^x on the SFU; x <= 0 everywhere in this kernel, -inf gives 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void load8(const bf16* p, float (&x)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
// 8 values as bf16 hi at byte `at` and lo at `at + lo_bytes`, in this
// block's shared memory and in its peer's
__device__ __forceinline__ void store8_split(uint8_t* mine, uint8_t* peer, int at,
                                             int lo_bytes, const float (&x)[8]) {
  uint4 h, l;
  split2(x[0], x[1], h.x, l.x);
  split2(x[2], x[3], h.y, l.y);
  split2(x[4], x[5], h.z, l.z);
  split2(x[6], x[7], h.w, l.w);
  *reinterpret_cast<uint4*>(mine + at) = h;
  *reinterpret_cast<uint4*>(mine + at + lo_bytes) = l;
  *reinterpret_cast<uint4*>(peer + at) = h;
  *reinterpret_cast<uint4*>(peer + at + lo_bytes) = l;
}

// grid (D / COLS, H, B), THREADS threads, SMEM bytes of dynamic shared
// memory.  s0 and s1 may be one buffer: each block reads its state slice
// before the loop and writes it after.
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
wkv6_chunk_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ logw,
                  const float* __restrict__ u, const float* s0,
                  bf16* __restrict__ out, float* s1, int H, int S, long long rsb,
                  long long rsh, long long rst, long long ksb, long long ksh,
                  long long kst, long long vsb, long long vsh, long long vst,
                  long long wsb, long long wsh, long long wst, long long osb,
                  long long osh, long long ost) {
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t sb = smem_u32(smem);
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  uint8_t* psmem = cluster.map_shared_rank(smem, rank ^ 1);  // the peer's
  const int col0 = blockIdx.x * COLS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;    // mma fragment: row, column pair
  const int mi = lane / 8, mr = lane % 8;  // ldmatrix: matrix, row of it
  const bool state_warp = warp >= NSUB;
  const int w16 = 16 * (warp % NSUB);      // the warp's rows (tokens or state)

  const bf16* rb = r + b * rsb + h * rsh;
  const bf16* kb = k + b * ksb + h * ksh;
  const bf16* vb = v + b * vsb + h * vsh + col0;
  const float* wb = logw + b * wsb + h * wsh;
  bf16* ob = out + b * osb + h * osh + col0;
  const long long sbase = ((long long)b * H + h) * D * D + col0;

  bf16* ad = reinterpret_cast<bf16*>(smem + AD);
  bf16* pad = reinterpret_cast<bf16*>(psmem + AD);
  bf16* sh = reinterpret_cast<bf16*>(smem + SH);
  float* bonus = reinterpret_cast<float*>(smem + BONUS);
  float* pbonus = reinterpret_cast<float*>(psmem + BONUS);
  float* us = reinterpret_cast<float*>(smem + US);
  float* tot = reinterpret_cast<float*>(smem + TOT);

  for (int i = tid; i < D; i += THREADS) us[i] = u[h * D + i];
  // the diagonal blocks' entries at s >= t stay zero (all three parts)
  for (int i = tid; i < 3 * C * PA; i += THREADS) ad[i] = __float2bfloat16(0.f);

  // a state warp's 16 rows in the accumulator layout: st[nb][2 * hh + e]
  // is row w16 + g + 8 * hh, column 8 * nb + 2 * q + e
  float st[COLS / 8][4];
  auto stage_state = [&]() {  // S0 as hi + lo bf16, for the inter-chunk term
#pragma unroll
    for (int nb = 0; nb < COLS / 8; ++nb)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = w16 + g + 8 * hh, col = 8 * nb + 2 * q;
        uint32_t hi, lo;
        split2(st[nb][2 * hh], st[nb][2 * hh + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(sh + row * PV + col) = hi;
        *reinterpret_cast<uint32_t*>(smem + SH + S_LO + (row * PV + col) * 2) = lo;
      }
  };
  if (state_warp) {
#pragma unroll
    for (int nb = 0; nb < COLS / 8; ++nb)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = w16 + g + 8 * hh, col = 8 * nb + 2 * q;
        const float2 x = *reinterpret_cast<const float2*>(s0 + sbase + row * D + col);
        st[nb][2 * hh] = x.x;
        st[nb][2 * hh + 1] = x.y;
      }
    stage_state();
  }

  const int n_chunks = (S + C - 1) / C;
  const int ltid = tid - NSUB * 32;  // the state warps' thread index
  auto load_chunk = [&](int n) {
    const uint32_t st0 = sb + (n % STAGES) * STAGE;
    const int t0 = n * C;
    for (int i = ltid; i < C * (D / 8); i += LOADERS) {
      const int row = i / (D / 8), p = i % (D / 8);
      const bool ok = t0 + row < S;
      const long long t = ok ? t0 + row : 0;
      cp_async16(st0 + R_OFF + (row * PK + p * 8) * 2, rb + t * rst + p * 8, ok);
      cp_async16(st0 + K_OFF + (row * PK + p * 8) * 2, kb + t * kst + p * 8, ok);
    }
    for (int i = ltid; i < C * (COLS / 8); i += LOADERS) {
      const int row = i / (COLS / 8), p = i % (COLS / 8);
      const bool ok = t0 + row < S;
      const long long t = ok ? t0 + row : 0;
      cp_async16(st0 + V_OFF + (row * PV + p * 8) * 2, vb + t * vst + p * 8, ok);
    }
    for (int i = ltid; i < C * (D / 4); i += LOADERS) {
      const int row = i / (D / 4), p = i % (D / 4);
      const bool ok = t0 + row < S;
      const long long t = ok ? t0 + row : 0;
      cp_async16(st0 + W_OFF + (row * PW + p * 4) * 4, wb + t * wst + p * 4, ok);
    }
    cp_async_commit();
  };
  // Once chunk n has landed: cum = prefix sum of logw * log2(e), in place.
  // Thread (c, q) sums QT tokens of channel c, then adds the cum before its
  // run, summed run by run in one order: the last cum of run q - 1 and the
  // offset of run q are then one and the same sum, so cum does not
  // increase across runs either.
  auto scan_chunk = [&](int n) {
    if (n + 1 < n_chunks)
      cp_async_wait<1>();  // chunk n + 1's copies may still fly
    else
      cp_async_wait<0>();
    loaders_sync();  // every loader's copies of chunk n have landed
    float* cum = reinterpret_cast<float*>(smem + (n % STAGES) * STAGE + W_OFF);
    const int c = ltid % D, q = ltid / D;
    float x[QT], acc = 0.f;
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      acc += cum[(q * QT + j) * PW + c] * LOG2E;  // logw <= 0
      x[j] = acc;
    }
    tot[q * D + c] = acc;
    loaders_sync();
    float off = 0.f;
    for (int p = 0; p < q; ++p) off += tot[p * D + c];
#pragma unroll
    for (int j = 0; j < QT; ++j) cum[(q * QT + j) * PW + c] = off + x[j];
  };

  if (state_warp) {
    load_chunk(0);
    if (n_chunks > 1) load_chunk(1);
    scan_chunk(0);
  }
  cluster_arrive();  // the zeros of ad are in place
  for (int n = 0; n < n_chunks; ++n) {
    const int t0 = n * C;
    // chunk n has landed and its cum is in place; chunk n - 1's readers
    // are done.  While the output warps finish this chunk, the state warps
    // load chunk n + 2 (into chunk n - 1's stage) and take chunk n + 1's
    // prefix sums.
    __syncthreads();
    uint8_t* stg = smem + (n % STAGES) * STAGE;
    const bf16* rs = reinterpret_cast<const bf16*>(stg + R_OFF);
    const bf16* ks = reinterpret_cast<const bf16*>(stg + K_OFF);
    const bf16* vs = reinterpret_cast<const bf16*>(stg + V_OFF);
    const float* cum = reinterpret_cast<const float*>(stg + W_OFF);
    const uint32_t vs_a = sb + (n % STAGES) * STAGE + V_OFF;

    // the peer has read its operands of chunk n - 1: they may be replaced
    cluster_wait();

    // 2. the decayed operands as bf16 hi + lo, the bonus, and the diagonal
    //    blocks of A
    const float* last = cum + (C - 1) * PW;
    //    Each block of the cluster takes every other THREADS items.
    static_assert(C * (D / 8) % (CLUSTER * THREADS) == 0,
                  "every thread takes the bonus' shuffles");
    for (int i = tid + rank * THREADS; i < C * (D / 8); i += CLUSTER * THREADS) {
      const int t = i / (D / 8), c = (i % (D / 8)) * 8;
      float rr[8], kk[8], cu[8], ex[8], la[8];
      load8(rs + t * PK + c, rr);
      load8(ks + t * PK + c, kk);
      // bonus_t = r_t . (u * k_t): the D / 8 lanes of token t meet by shuffles
      float bo = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) bo = fmaf(rr[j] * us[c + j], kk[j], bo);
#pragma unroll
      for (int off = 1; off < D / 8; off <<= 1) bo += __shfl_xor_sync(0xffffffffu, bo, off);
      if (c == 0) bonus[t] = pbonus[t] = bo;
      load8(cum + t * PW + c, cu);
      load8(last + c, la);
      if (t > 0) {
        load8(cum + (t - 1) * PW + c, ex);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) ex[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        rr[j] *= ex2(ex[j]);
        kk[j] *= ex2(la[j] - cu[j]);
      }
      store8_split(smem, psmem, RDEC + (t * PK + c) * 2, RDEC_LO, rr);
      store8_split(smem, psmem, KDEC + (t * PK + c) * 2, RDEC_LO, kk);
    }
    // rows t of sub-chunks i >= 1: r_t * 2^(cum[t-1] - cum[i*SUB-1])
    for (int i = tid + rank * THREADS; i < (C - SUB) * (D / 8); i += CLUSTER * THREADS) {
      const int t = SUB + i / (D / 8), c = (i % (D / 8)) * 8;
      const int bi = (t / SUB) * SUB - 1;
      float rr[8], ex[8], bn[8];
      load8(rs + t * PK + c, rr);
      load8(cum + (t - 1) * PW + c, ex);
      load8(cum + bi * PW + c, bn);
#pragma unroll
      for (int j = 0; j < 8; ++j) rr[j] *= ex2(ex[j] - bn[j]);
      store8_split(smem, psmem, RQ + ((t - SUB) * PK + c) * 2, RQ_LO, rr);
    }
    // for each i >= 1, rows s < i*SUB: k_s * 2^(cum[i*SUB-1] - cum[s]),
    // packed i after i from row SUB * i * (i - 1) / 2
    for (int i = tid + rank * THREADS; i < KQ_ROWS * (D / 8); i += CLUSTER * THREADS) {
      const int row = i / (D / 8), c = (i % (D / 8)) * 8;
      int si = 1, base = 0;
      while (row >= base + si * SUB) {
        base += si * SUB;
        ++si;
      }
      const int s = row - base, bi = si * SUB - 1;
      float kk[8], cu[8], bn[8];
      load8(ks + s * PK + c, kk);
      load8(cum + s * PW + c, cu);
      load8(cum + bi * PW + c, bn);
#pragma unroll
      for (int j = 0; j < 8; ++j) kk[j] *= ex2(bn[j] - cu[j]);
      store8_split(smem, psmem, KQ + (row * PK + c) * 2, KQ_LO, kk);
    }
    // the diagonal blocks: block `rank` of the cluster takes sub-chunks
    // 2 rank and 2 rank + 1, four warps each, one of the SUB * (SUB - 1) / 2
    // pairs s < t per lane, each a sum over the D channels
    {
      constexpr int LANES = THREADS * CLUSTER / NSUB;
      constexpr int PAIRS = SUB * (SUB - 1) / 2;
      constexpr int PER_LANE = (PAIRS + LANES - 1) / LANES;
      const int base = SUB * (NSUB / CLUSTER * rank + warp / (WARPS * CLUSTER / NSUB));
      const int pl = lane + 32 * (warp % (WARPS * CLUSTER / NSUB));
      int tt[PER_LANE], ss[PER_LANE];
      float acc[PER_LANE];
#pragma unroll
      for (int m = 0; m < PER_LANE; ++m) {
        int p = min(pl + LANES * m, PAIRS - 1), t = 1;
        while (p >= t) {
          p -= t;
          ++t;
        }
        tt[m] = base + t;
        ss[m] = base + p;
        acc[m] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < D; c += 8) {
#pragma unroll
        for (int m = 0; m < PER_LANE; ++m) {
          float rr[8], kk[8], ex[8], cs[8];
          load8(rs + tt[m] * PK + c, rr);
          load8(ks + ss[m] * PK + c, kk);
          load8(cum + (tt[m] - 1) * PW + c, ex);
          load8(cum + ss[m] * PW + c, cs);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[m] = fmaf(rr[j] * kk[j], ex2(ex[j] - cs[j]), acc[m]);
        }
      }
#pragma unroll
      for (int m = 0; m < PER_LANE; ++m)
        if (pl + LANES * m < PAIRS) {
          const bf16 hi = __float2bfloat16(acc[m]);
          const float rest = acc[m] - __bfloat162float(hi);
          const bf16 lo = __float2bfloat16(rest);
          const bf16 lo2 = __float2bfloat16(rest - __bfloat162float(lo));
          const int at = tt[m] * PA + (ss[m] - base);
          ad[at] = pad[at] = hi;
          ad[at + C * PA] = pad[at + C * PA] = lo;
          ad[at + 2 * C * PA] = pad[at + 2 * C * PA] = lo2;
        }
    }
    cluster_arrive();  // both halves of the operands are in place
    cluster_wait();

    if (!state_warp) {
      // 3. the output rows of sub-chunk `warp`
      float o[COLS / 8][4], ox[COLS / 8][4];
#pragma unroll
      for (int nb = 0; nb < COLS / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nb][e] = ox[nb][e] = 0.f;
      // inter-chunk: (r * 2^excl) S0
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ah[4], al[4];
        const uint32_t at = sb + RDEC + ((w16 + (mi % 2) * 8 + mr) * PK + (2 * kk + mi / 2) * 8) * 2;
        ldmatrix_x4(ah, at);
        ldmatrix_x4(al, at + RDEC_LO);
#pragma unroll
        for (int j = 0; j < COLS / 16; ++j) {
          uint32_t bh[4], bl[4];
          const uint32_t bt = sb + SH + ((16 * kk + (mi % 2) * 8 + mr) * PV + (2 * j + mi / 2) * 8) * 2;
          ldmatrix_x4_trans(bh, bt);
          ldmatrix_x4_trans(bl, bt + S_LO);
          mma3(o[2 * j], ox[2 * j], ah, al, bh[0], bh[1], bl[0], bl[1]);
          mma3(o[2 * j + 1], ox[2 * j + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
        }
      }
      // below the diagonal: A_wj = rq_w kq_(w, j)^T on the tensor cores,
      // then o += A_wj v_j with A_wj (hi + lo + lo2) from the accumulators
      if (warp > 0) {
        uint32_t rh[D / 16][4], rl[D / 16][4];
        const uint32_t rq_a = sb + RQ + (warp - 1) * SUB * PK * 2;
        const uint32_t kq_a = sb + KQ + (SUB * warp * (warp - 1) / 2) * PK * 2;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t at = rq_a + (((mi % 2) * 8 + mr) * PK + (2 * kk + mi / 2) * 8) * 2;
          ldmatrix_x4(rh[kk], at);
          ldmatrix_x4(rl[kk], at + RQ_LO);
        }
        for (int j = 0; j < warp; ++j) {
          float p[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
          float px[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t kh[4], kl[4];  // {s 0-7: c lo, c hi; s 8-15: c lo, c hi}
            const uint32_t bt = kq_a + ((16 * j + (mi / 2) * 8 + mr) * PK + (2 * kk + mi % 2) * 8) * 2;
            ldmatrix_x4(kh, bt);
            ldmatrix_x4(kl, bt + KQ_LO);
            mma3(p[0], px[0], rh[kk], rl[kk], kh[0], kh[1], kl[0], kl[1]);
            mma3(p[1], px[1], rh[kk], rl[kk], kh[2], kh[3], kl[2], kl[3]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p[0][e] += px[0][e];
            p[1][e] += px[1][e];
          }
          uint32_t ph[4], pl[4], pl2[4];
          split3(p[0][0], p[0][1], ph[0], pl[0], pl2[0]);
          split3(p[0][2], p[0][3], ph[1], pl[1], pl2[1]);
          split3(p[1][0], p[1][1], ph[2], pl[2], pl2[2]);
          split3(p[1][2], p[1][3], ph[3], pl[3], pl2[3]);
#pragma unroll
          for (int jj = 0; jj < COLS / 16; ++jj) {
            uint32_t vf[4];
            ldmatrix_x4_trans(vf, vs_a + ((16 * j + (mi % 2) * 8 + mr) * PV + (2 * jj + mi / 2) * 8) * 2);
            mma_bf16(o[2 * jj], ph, vf[0], vf[1]);
            mma_bf16(ox[2 * jj], pl, vf[0], vf[1]);
            mma_bf16(ox[2 * jj], pl2, vf[0], vf[1]);
            mma_bf16(o[2 * jj + 1], ph, vf[2], vf[3]);
            mma_bf16(ox[2 * jj + 1], pl, vf[2], vf[3]);
            mma_bf16(ox[2 * jj + 1], pl2, vf[2], vf[3]);
          }
        }
      }
      // the diagonal block: o += A_ww v_w
      {
        uint32_t ah[4], al[4], al2[4];
        const uint32_t at = sb + AD + ((w16 + (mi % 2) * 8 + mr) * PA + (mi / 2) * 8) * 2;
        ldmatrix_x4(ah, at);
        ldmatrix_x4(al, at + AD_LO);
        ldmatrix_x4(al2, at + 2 * AD_LO);
#pragma unroll
        for (int jj = 0; jj < COLS / 16; ++jj) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, vs_a + ((w16 + (mi % 2) * 8 + mr) * PV + (2 * jj + mi / 2) * 8) * 2);
          mma_bf16(o[2 * jj], ah, vf[0], vf[1]);
          mma_bf16(ox[2 * jj], al, vf[0], vf[1]);
          mma_bf16(ox[2 * jj], al2, vf[0], vf[1]);
          mma_bf16(o[2 * jj + 1], ah, vf[2], vf[3]);
          mma_bf16(ox[2 * jj + 1], al, vf[2], vf[3]);
          mma_bf16(ox[2 * jj + 1], al2, vf[2], vf[3]);
        }
      }
#pragma unroll
      for (int nb = 0; nb < COLS / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nb][e] += ox[nb][e];
      // the bonus in f32, and the rows before S out
#pragma unroll
      for (int nb = 0; nb < COLS / 8; ++nb)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int t = w16 + g + 8 * hh, col = 8 * nb + 2 * q;
          const float2 vv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(vs + t * PV + col));
          if (t0 + t < S)
            *reinterpret_cast<__nv_bfloat162*>(ob + (t0 + t) * ost + col) =
                __floats2bfloat162_rn(fmaf(bonus[t], vv.x, o[nb][2 * hh]),
                                      fmaf(bonus[t], vv.y, o[nb][2 * hh + 1]));
        }
    } else {
      // 4. the warp's state rows: S = diag(2^last) S + kdec^T v
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float dcy = ex2(last[w16 + g + 8 * hh]);
#pragma unroll
        for (int nb = 0; nb < COLS / 8; ++nb) {
          st[nb][2 * hh] *= dcy;
          st[nb][2 * hh + 1] *= dcy;
        }
      }
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk) {
        uint32_t ah[4], al[4];  // kdec^T: the warp's rows c, tokens 16kk..16kk+15
        const uint32_t at = sb + KDEC + ((16 * kk + (mi / 2) * 8 + mr) * PK + (w16 / 8 + mi % 2) * 8) * 2;
        ldmatrix_x4_trans(ah, at);
        ldmatrix_x4_trans(al, at + RDEC_LO);
#pragma unroll
        for (int jj = 0; jj < COLS / 16; ++jj) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, vs_a + ((16 * kk + (mi % 2) * 8 + mr) * PV + (2 * jj + mi / 2) * 8) * 2);
          mma_bf16(st[2 * jj], al, vf[0], vf[1]);
          mma_bf16(st[2 * jj], ah, vf[0], vf[1]);
          mma_bf16(st[2 * jj + 1], al, vf[2], vf[3]);
          mma_bf16(st[2 * jj + 1], ah, vf[2], vf[3]);
        }
      }
    }
    if (state_warp && n + 2 < n_chunks) load_chunk(n + 2);
    if (state_warp && n + 1 < n_chunks) scan_chunk(n + 1);
    cluster_arrive();  // this block has read its operands of chunk n
    __syncthreads();   // every output warp has read this chunk's S0
    if (state_warp) stage_state();
  }
  cluster_wait();

  if (state_warp) {
#pragma unroll
    for (int nb = 0; nb < COLS / 8; ++nb)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = w16 + g + 8 * hh, col = 8 * nb + 2 * q;
        *reinterpret_cast<float2*>(s1 + sbase + row * D + col) =
            make_float2(st[nb][2 * hh], st[nb][2 * hh + 1]);
      }
  }
}

}  // namespace

extern "C" {

// The arguments of wkv6_scan_fwd (wkv6_scan.cu): r/k/v/out (B, H, S, D) in
// `dtype`, which must be 1 (bfloat16), with D = 64; logw (B, H, S, D) f32;
// each addressed through element strides (batch, head, position) with a
// contiguous last dim and 16-byte aligned rows.  u: contiguous (H, D) f32;
// s0/s1: contiguous (B, H, D, D) f32, s1 may be s0.  Returns
// cudaGetLastError().
int wkv6_chunk_fwd(const void* r, const void* k, const void* v,
                   const void* logw, const void* u, const void* s0, void* out,
                   void* s1, int B, int H, int S, int D_, int dtype,
                   long long rsb, long long rsh, long long rst, long long ksb,
                   long long ksh, long long kst, long long vsb, long long vsh,
                   long long vst, long long wsb, long long wsh, long long wst,
                   long long osb, long long osh, long long ost, void* stream) {
  if (S < 1 || B < 1 || H < 1 || B > 65535 || H > 65535 || D_ != D || dtype != 1)
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv6_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid(D / COLS, H, B);
  wkv6_chunk_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(r), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<bf16*>(out), static_cast<float*>(s1), H, S, rsb, rsh, rst,
      ksb, ksh, kst, vsb, vsh, vst, wsb, wsh, wst, osb, osh, ost);
  return (int)cudaGetLastError();
}

const char* wkv6_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
