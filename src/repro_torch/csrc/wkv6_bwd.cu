// The gradient of the WKV6 recurrence of RWKV6 "Finch" (rwkv6-7b), in
// chunks on Hopper's tensor cores.
//
// The TPU kernel src/repro/kernels/rwkv6_scan/kernel.py :: wkv6_scan has no
// backward: the reference trains through JAX's autodiff of its jnp
// wkv6_chunked (src/repro/models/rwkv.py:49).  This kernel takes that
// autodiff's place under ops.py :: WKV6Fn.  Per (batch, head), with S_t the
// (D, D) f32 state after token t (k-dim x v-dim, S_{-1} = state0), dS_t the
// loss's gradient with respect to it (dS_{S-1} = 0: the final state is not
// differentiated) and c_t = v_t . dO_t:
//
//   dr_t = S_{t-1} dO_t^T + u * k_t c_t
//   dk_t = dS_t v_t^T + r_t * u c_t
//   dv_t = k_t dS_t + (r_t . (u * k_t)) dO_t
//   dS_{t-1} = diag(exp(logw_t)) dS_t + r_t^T dO_t
//   dlogw_t = exp(logw_t) sum_j S_{t-1}[:, j] dS_t[:, j]
//   du = sum_{b, t} r_t * k_t c_t,   dstate0 = dS_{-1}
//
// In chunks of C = 64 tokens (the last zero-padded: r = k = v = dO = 0,
// logw = 0, as wkv6_chunk.cu pads), with cum the prefix sum of logw in a
// chunk (log2 units), excl[t] = cum[t - 1], last = cum[C - 1], the state S0
// at the chunk's start, the gradient dSe at its end and dA[t, s] = dO_t .
// v_s for s < t:
//
//   dr = 2^excl (dO S0^T) + sum_s dA[t, s] k_s 2^(excl_t - cum_s) + u k c
//   dk = 2^(last - cum) (v dSe^T) + sum_t dA[t, s] r_t 2^(excl_t - cum_s) + r u c
//   dv = (k 2^(last - cum)) dSe + A^T dO + (r . (u * k)) dO
//
// and dlogw_t, expanded in the chunk, is per channel the sum of (a)
// 2^last (S0 dSe^T)[i, i]; (b) sum_{t' > t} r_t' (2^excl dO S0^T)_t'; (c)
// sum_{s < t} k_s (2^(last - cum) v dSe^T)_s; (d) the pairs s < t < t' of
// Z[t', s] = k_s r_t' 2^(excl_t' - cum_s) dA[t', s] that straddle t.  No
// sum runs across chunks and no two growing sums are subtracted, so dlogw
// is resolved at strong decays, where it is ~1e-3 of r . dr~ (the old
// running sum of r . dr~ - k . dk~ left ~1.2e-4 of its norm in error).
// Every exponent is <= 0 and is a sum over its own span of tokens: each
// chunk's logw is summed in sub-chunks of 16 (before, after each token and
// in all), and an exponent adds those pieces, never subtracting two prefix
// sums ~450 deep (which would put ~2e-5 of relative error into each
// decay).  The plain version of this arithmetic is ref.py ::
// wkv6_bwd_chunk_ref; the plain version of the function, which the wrapper
// runs on the CPU, is wkv6_bwd_ref.
//
// What bounds it on the H100.  The function moves 22 bytes per token, head
// and channel (r, k, v, dO read in bf16, logw in f32; dr, dk, dv written
// in bf16, dlogw in f32): 0.37 GB at the train shape (B = 2, S = 2048,
// H = 64), 0.11 ms at 3.35 TB/s.  The chunked form's products are ~16
// GFLOP there, ~0.017 ms at the bf16 tensor-core rate, ~2.5x that in the
// bf16 parts below.  So bytes bound it.  The design adds a scratch of the
// chunks' S0 and dSe (2 x 64 MB at the train shape), written once and read
// once, and reads the inputs twice: ~0.9 GB in all, ~0.27 ms.  What holds
// it above that is the CUDA-core work around the products (~100k
// exponentials and the diagonal blocks' pairs a chunk), done by one
// thread per channel and sub-chunk in long dependent chains.
//
// What the design does about it: two launches.
//
// 1. wkv6_bwd_states, grid (2, H, B): block 0 of a head walks its chunks
//    forward, S_{n+1} = diag(2^last) S_n + (k 2^(last - cum))^T v, block 1
//    backward, dS_{n-1} = diag(2^last) dS_n + (r 2^excl)^T dO, each holding
//    the (64 x 64) f32 state in the mma accumulators of 8 warps (16 rows x
//    32 columns each) and writing it to the scratch (streaming stores)
//    before each chunk's update; block 1 ends with dstate0.  The chunk's
//    operands come by cp.async one chunk ahead.  256 blocks at the train
//    shape, two an SM.
// 2. wkv6_bwd_chunk, grid (chunks, H, B), one block of 16 warps per chunk
//    (4096 at the train shape, nothing sequential between them).  The
//    (channel c, sub-chunk j) units are taken in two shifts, warps 0-7 and
//    8-15, that split the units' work: the first sums logw and builds the
//    decayed operands while the second sums the diagonal blocks of A pair
//    by pair (a warp's 32 channels meet by halving exchanges of 16 pairs at
//    a time); after the products the second scales the products' rows
//    while the first takes the diagonal blocks' pairs of dr, dk and (d),
//    then the first adds the terms of dlogw (prefix sums within a
//    sub-chunk in its own registers, whole sub-chunks through shared
//    memory).  In the products, sub-chunk m = warp % 4 of 16 tokens has an
//    r warp (0-3: dO S0^T and, below the diagonal, dA kq, dA_{m,j} =
//    dO_m v_j^T for j < m and kq = k_s 2^(B_m - cum_s) through the boundary
//    B_m before sub-chunk m), a k warp (4-7: v dSe^T and, above the
//    diagonal, dA^T rE through E_m, the end of sub-chunk m, rE = r
//    2^(excl - E_m)), a v warp (8-11: A^T dO, A^T_{m,l} = kE_m rE_l^T with
//    kE = k 2^(E_m - cum), and the diagonal block) and a warp for dv's
//    inter-chunk rows (12-15: (k 2^(last - cum)) dSe).  The first shift's
//    r and k warps start their products as soon as the operands are built
//    (named barriers), while the second may still sum A's pairs.  The
//    products' rows reach the units through shared memory, where the
//    operands were, and dr, dk and dlogw leave it 16 bytes a thread.
//    Nothing is atomic: every element is written once, du per chunk (the
//    wrapper sums them), so two calls give the same bits.
//
// Every tensor-core operand that is not a bf16 input (S0, dSe, dA, A and
// the decayed r and k) is split into bf16 hi + lo (x - hi), and a product
// of two split operands is taken as hi*hi + hi*lo + lo*hi.  Two parts were
// chosen by emulation (wkv6_split_probe.py bwd:2222 against bwd_ref and
// bwd:3333): one rwkv6-7b train step's gradients stray from the f32 run's
// by 1.0335x the plain bf16 run's with two parts, 1.0338x with three and
// 1.0337x in f32, on one H100.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

namespace {

using bf16 = __nv_bfloat16;

constexpr int D = 64;       // head dim, the only one taken
constexpr int C = 64;       // tokens per chunk
constexpr int SUB = 16;     // tokens per sub-chunk: the mma tile's rows
constexpr int NSUB = C / SUB;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
static_assert(THREADS == D * NSUB, "one thread per channel and sub-chunk");
static_assert(WARPS == 2 * NSUB, "an r warp and a k warp per sub-chunk");
constexpr int PK = D + 8;   // bf16 (., D) tiles: 144 B a row
constexpr int PW = D + 4;   // f32 (., D) tiles: 272 B a row
constexpr int PA = SUB + 8; // bf16 diagonal blocks of A^T: 48 B a row
constexpr int PD = SUB + 1; // f32 diagonal blocks of dA
constexpr float LOG2E = 1.4426950408889634f;

// element strides (batch, head, position) of the nine (B, H, S, D) tensors
enum { R_, K_, V_, W_, DO_, DR_, DK_, DV_, DW_, NTENSORS };
struct Strides {
  long long s[3 * NTENSORS];
  __device__ __forceinline__ long long at(int tensor, int b, int h) const {
    return b * s[3 * tensor] + h * s[3 * tensor + 1];
  }
  __device__ __forceinline__ long long t(int tensor) const {
    return s[3 * tensor + 2];
  }
};

struct Args {
  const bf16 *r, *k, *v, *dout;
  const float *logw, *u, *s0;
  bf16 *dr, *dk, *dv;
  float *dlogw, *du_part, *ds0;
  float* states;  // (2, B, H, N, D, D): S_n, then dS_n
  int B, H, S, N;
  Strides st;
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// Fragments of 16 x 16 bf16 tiles in shared memory (byte address `base`,
// row pitch P elements) for mma.m16n8k16, with mi = lane / 8, mr = lane % 8:
// a_rows: the A operand (M x K) stored row by row (rows m0.., columns k0..);
// a_cols: the A operand stored transposed (rows k0.., columns m0..);
// b_rows: the B operand (K x N) stored as N rows of K (rows n0.., columns
//   k0..): b[0], b[1] for n0..n0+7, b[2], b[3] for n0+8..n0+15;
// b_cols: the B operand stored as K rows of N (rows k0.., columns n0..).
template <int P>
__device__ __forceinline__ void a_rows(uint32_t (&f)[4], uint32_t base, int m0, int k0, int mi,
                                       int mr) {
  ldmatrix_x4(f, base + ((m0 + (mi % 2) * 8 + mr) * P + k0 + (mi / 2) * 8) * 2);
}
template <int P>
__device__ __forceinline__ void a_cols(uint32_t (&f)[4], uint32_t base, int k0, int m0, int mi,
                                       int mr) {
  ldmatrix_x4_trans(f, base + ((k0 + (mi / 2) * 8 + mr) * P + m0 + (mi % 2) * 8) * 2);
}
template <int P>
__device__ __forceinline__ void b_rows(uint32_t (&f)[4], uint32_t base, int n0, int k0, int mi,
                                       int mr) {
  ldmatrix_x4(f, base + ((n0 + (mi / 2) * 8 + mr) * P + k0 + (mi % 2) * 8) * 2);
}
template <int P>
__device__ __forceinline__ void b_cols(uint32_t (&f)[4], uint32_t base, int k0, int n0, int mi,
                                       int mr) {
  ldmatrix_x4_trans(f, base + ((k0 + (mi % 2) * 8 + mr) * P + n0 + (mi / 2) * 8) * 2);
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

// d += (a_hi + a_lo) b, b a bf16 input taken whole; 16 x 16 of output
// (the two n-blocks of b[0..3])
__device__ __forceinline__ void mma_a2(float (&d0)[4], float (&d1)[4], const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4], const uint32_t (&b)[4]) {
  mma_bf16(d0, ah, b[0], b[1]);
  mma_bf16(d1, ah, b[2], b[3]);
  mma_bf16(d0, al, b[0], b[1]);
  mma_bf16(d1, al, b[2], b[3]);
}
// d += a (b_hi + b_lo), a a bf16 input taken whole
__device__ __forceinline__ void mma_b2(float (&d0)[4], float (&d1)[4], const uint32_t (&a)[4],
                                       const uint32_t (&bh)[4], const uint32_t (&bl)[4]) {
  mma_bf16(d0, a, bh[0], bh[1]);
  mma_bf16(d1, a, bh[2], bh[3]);
  mma_bf16(d0, a, bl[0], bl[1]);
  mma_bf16(d1, a, bl[2], bl[3]);
}
// d += (a_hi + a_lo)(b_hi + b_lo) less lo * lo
__device__ __forceinline__ void mma_ab2(float (&d0)[4], float (&d1)[4], const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4], const uint32_t (&bh)[4],
                                        const uint32_t (&bl)[4]) {
  mma_bf16(d0, ah, bh[0], bh[1]);
  mma_bf16(d1, ah, bh[2], bh[3]);
  mma_bf16(d0, al, bh[0], bh[1]);
  mma_bf16(d1, al, bh[2], bh[3]);
  mma_bf16(d0, ah, bl[0], bl[1]);
  mma_bf16(d1, ah, bl[2], bl[3]);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) as hi + lo bf16 pairs: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - f.x, y - f.y);
}

// x as bf16 hi at p and lo at p + lo_elems
__device__ __forceinline__ void store_split(bf16* p, int lo_elems, float x) {
  const bf16 hi = __float2bfloat16(x);
  p[0] = hi;
  p[lo_elems] = __float2bfloat16(x - __bfloat162float(hi));
}

// a 16 x 16 f32 accumulator pair (rows g, g + 8; columns 2q.., 8 + 2q..)
// as the hi and lo A fragments of the next product
__device__ __forceinline__ void acc_to_a(const float (&p)[2][4], uint32_t (&h)[4],
                                         uint32_t (&l)[4]) {
  split2(p[0][0], p[0][1], h[0], l[0]);
  split2(p[0][2], p[0][3], h[1], l[1]);
  split2(p[1][0], p[1][1], h[2], l[2]);
  split2(p[1][2], p[1][3], h[3], l[3]);
}

// 8 consecutive bf16 (16-byte aligned) as f32
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

// 2^x on the SFU; x <= 0 everywhere in this kernel, -inf gives 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The logw of channel c in sub-chunk j of a staged chunk (pitch PW), in
// log2 units: per token the sums over the sub-chunk's tokens before it and
// after it, and over all of them.
__device__ __forceinline__ float sub_sums(const float* lw, int j, int c, float (&before)[SUB],
                                          float (&after)[SUB]) {
  float l[SUB];
#pragma unroll
  for (int t = 0; t < SUB; ++t) l[t] = lw[(SUB * j + t) * PW + c] * LOG2E;
  float acc = 0.f;
#pragma unroll
  for (int t = 0; t < SUB; ++t) {
    before[t] = acc;
    acc += l[t];
  }
  float rev = 0.f;
#pragma unroll
  for (int t = SUB - 1; t >= 0; --t) {
    after[t] = rev;
    rev += l[t];
  }
  return acc;
}

// The pairs s < t' of a sub-chunk, numbered p = t' (t' - 1) / 2 + s, and
// the terms r_t' k_s 2^(before_t' - before_(s+1)) of pairs P0 .. P0 + 31
// into x (0 past the last pair), every index a constant.
constexpr int PAIRS = SUB * (SUB - 1) / 2;
__host__ __device__ constexpr int pair_t(int p) {
  int t = 1;
  while (p >= t) {
    p -= t;
    ++t;
  }
  return t;
}
template <int P>
__device__ __forceinline__ float pair_term(const float (&rr)[SUB], const float (&kk)[SUB],
                                           const float (&before)[SUB]) {
  if constexpr (P < PAIRS) {
    constexpr int tp = pair_t(P), s = P - tp * (tp - 1) / 2;
    return rr[tp] * kk[s] * ex2(before[tp] - before[s + 1]);
  } else {
    return 0.f;
  }
}
template <int P0, int... E>
__device__ __forceinline__ void pair_terms(float (&x)[16], const float (&rr)[SUB],
                                           const float (&kk)[SUB], const float (&before)[SUB],
                                           std::integer_sequence<int, E...>) {
  ((x[E] = pair_term<P0 + E>(rr, kk, before)), ...);
}
// One halving exchange of pair_sums: lanes whose bit OFF is clear keep
// entries e < OFF, the others e + OFF, each summed with its partner's.
template <int OFF>
__device__ __forceinline__ void halve(float (&x)[16], int lane) {
  const bool up = lane & OFF;
#pragma unroll
  for (int e = 0; e < OFF; ++e) {
    const float send = up ? x[e] : x[e + OFF];
    const float keep = up ? x[e + OFF] : x[e];
    x[e] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

// The terms of pairs 16 G .. 16 G + 15 summed over the warp's 32 lanes into
// out[16 G ..]: four halving exchanges leave lane L the sum over its half
// warp of pair 16 G + L % 16, and one more adds the other half.
template <int G>
__device__ __forceinline__ void pair_sums(float* out, const float (&rr)[SUB],
                                          const float (&kk)[SUB], const float (&before)[SUB],
                                          int lane) {
  if constexpr (16 * G < PAIRS) {
    float x[16];
    pair_terms<16 * G>(x, rr, kk, before, std::make_integer_sequence<int, 16>());
    halve<8>(x, lane);
    halve<4>(x, lane);
    halve<2>(x, lane);
    halve<1>(x, lane);
    x[0] += __shfl_xor_sync(0xffffffffu, x[0], 16);
    if (lane < 16) out[16 * G + lane] = x[0];
  }
}

// Rows T0 <= t' < T1 of a diagonal block's pairs s < t' for one channel:
// their shares of dr (drd[t']) and dk (dkd[s]) and of (d), the pairs
// s < t < t' inside the block (d4[t]).  The decay of a pair is the product
// of the decays w of the tokens s < tau < t', taken from tau = t' - 1 down
// (dA: the block of dA, pitch PD).
template <int T0, int T1>
__device__ __forceinline__ void diag_pairs(const float (&rr)[SUB], const float (&kk)[SUB],
                                           const float (&w)[SUB], const float* dA,
                                           float (&drd)[SUB], float (&dkd)[SUB],
                                           float (&d4)[SUB]) {
#pragma unroll
  for (int tp = T0; tp < T1; ++tp) {
    float z[SUB];
    float f = 1.f;
#pragma unroll
    for (int s = tp - 1; s >= 0; --s) {
      if (s < tp - 1) f *= w[s + 1];
      const float fk = f * dA[tp * PD + s] * kk[s];
      drd[tp] += fk;
      dkd[s] = fmaf(f * dA[tp * PD + s], rr[tp], dkd[s]);
      z[s] = fk * rr[tp];
    }
    // t in (s, tp) takes the sum of z over s < t
    float run = 0.f;
#pragma unroll
    for (int t = 1; t < tp; ++t) {
      run += z[t - 1];
      d4[t] += run;
    }
  }
}

// ---------------------------------------------------------------------------
// 1. the chunks' start states and end gradients
// ---------------------------------------------------------------------------

constexpr int ST_X = 0;                      // bf16 (C, PK): k, or r backward
constexpr int ST_Y = ST_X + C * PK * 2;      // bf16 (C, PK): v, or dO
constexpr int ST_W = ST_Y + C * PK * 2;      // f32 (C, PW): logw
constexpr int ST_STAGE = ST_W + C * PW * 4;
constexpr int ST_OP = 2 * ST_STAGE;          // bf16 (C, PK) hi, then lo: X decayed
constexpr int ST_OP_LO = C * PK;             // elements
constexpr int ST_TOT = ST_OP + 2 * ST_OP_LO * 2;  // f32 (NSUB, D)
constexpr int ST_DCY = ST_TOT + NSUB * D * 4;     // f32 (D): 2^last
constexpr int ST_SMEM = ST_DCY + D * 4;

__global__ void __launch_bounds__(THREADS) wkv6_bwd_states(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t sb = smem_u32(smem);
  const bool back = blockIdx.x == 1;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4, mi = lane / 8, mr = lane % 8;
  const int w16 = SUB * (warp % NSUB), c0 = 32 * (warp / NSUB);  // the warp's rows, columns
  const Strides& st = a.st;
  const int xi = back ? R_ : K_, yi = back ? DO_ : V_;
  const bf16* xb = (back ? a.r : a.k) + st.at(xi, b, h);
  const bf16* yb = (back ? a.dout : a.v) + st.at(yi, b, h);
  const float* wb = a.logw + st.at(W_, b, h);
  const long long xs = st.t(xi), ys = st.t(yi), ws = st.t(W_);
  const int N = a.N, S = a.S;
  const long long head = (long long)b * a.H + h;
  float* out = a.states + (((long long)back * a.B * a.H + head) * N) * D * D;

  auto load = [&](int n) {
    const uint32_t s0 = sb + (n & 1) * ST_STAGE;
    const int t0 = n * C;
    for (int i = tid; i < C * (D / 8); i += THREADS) {
      const int row = i / (D / 8), p = i % (D / 8);
      const bool ok = t0 + row < S;
      const long long t = ok ? t0 + row : 0;
      cp_async16(s0 + ST_X + (row * PK + p * 8) * 2, xb + t * xs + p * 8, ok);
      cp_async16(s0 + ST_Y + (row * PK + p * 8) * 2, yb + t * ys + p * 8, ok);
    }
    for (int i = tid; i < C * (D / 4); i += THREADS) {
      const int row = i / (D / 4), p = i % (D / 4);
      const bool ok = t0 + row < S;
      const long long t = ok ? t0 + row : 0;
      cp_async16(s0 + ST_W + (row * PW + p * 4) * 4, wb + t * ws + p * 4, ok);
    }
    cp_async_commit();
  };

  // acc[nb][2 hh + e]: row w16 + g + 8 hh, column c0 + 8 nb + 2 q + e
  float acc[4][4];
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = w16 + g + 8 * hh, col = c0 + 8 * nb + 2 * q;
      float2 x = make_float2(0.f, 0.f);
      if (!back) x = *reinterpret_cast<const float2*>(a.s0 + head * D * D + row * D + col);
      acc[nb][2 * hh] = x.x;
      acc[nb][2 * hh + 1] = x.y;
    }

  const int step = back ? -1 : 1;
  int n = back ? N - 1 : 0;
  load(n);
  float* tot = reinterpret_cast<float*>(smem + ST_TOT);
  float* dcy = reinterpret_cast<float*>(smem + ST_DCY);
  bf16* op = reinterpret_cast<bf16*>(smem + ST_OP);
  for (int i = 0; i < N; ++i, n += step) {
    cp_async_wait_all();
    __syncthreads();  // chunk n has landed; chunk n - step's readers are done
    if (i + 1 < N) load(n + step);
    uint8_t* stg = smem + (n & 1) * ST_STAGE;
    float* lw = reinterpret_cast<float*>(stg + ST_W);
    const bf16* xsm = reinterpret_cast<const bf16*>(stg + ST_X);
    // thread (c, j): channel c of sub-chunk j
    const int c = tid % D, j = tid / D;
    float before[SUB], after[SUB];
    tot[j * D + c] = sub_sums(lw, j, c, before, after);
    __syncthreads();
    float pre = 0.f, post = 0.f, last = 0.f;
#pragma unroll
    for (int m = 0; m < NSUB; ++m) {
      const float x = tot[m * D + c];
      if (m < j) pre += x;
      if (m > j) post += x;
      last += x;
    }
    if (j == 0) dcy[c] = ex2(last);
    // X decayed: k 2^(last - cum) forward, r 2^excl backward
#pragma unroll
    for (int t = 0; t < SUB; ++t) {
      const int row = SUB * j + t;
      const float e = back ? pre + before[t] : after[t] + post;
      store_split(op + row * PK + c, ST_OP_LO,
                  __bfloat162float(xsm[row * PK + c]) * ex2(e));
    }
    // the state before the chunk out to the scratch
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = w16 + g + 8 * hh, col = c0 + 8 * nb + 2 * q;
        __stcs(reinterpret_cast<float2*>(out + (long long)n * D * D + row * D + col),
               make_float2(acc[nb][2 * hh], acc[nb][2 * hh + 1]));
      }
    __syncthreads();  // the decayed operand and 2^last are in place
    // acc = diag(2^last) acc + X_dec^T Y
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float d = dcy[w16 + g + 8 * hh];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        acc[nb][2 * hh] *= d;
        acc[nb][2 * hh + 1] *= d;
      }
    }
    const uint32_t ys_a = sb + (n & 1) * ST_STAGE + ST_Y;
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) {
      uint32_t ah[4], al[4];
      a_cols<PK>(ah, sb + ST_OP, 16 * kk, w16, mi, mr);
      a_cols<PK>(al, sb + ST_OP + ST_OP_LO * 2, 16 * kk, w16, mi, mr);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t y[4];
        b_cols<PK>(y, ys_a, 16 * kk, c0 + 16 * jj, mi, mr);
        mma_a2(acc[2 * jj], acc[2 * jj + 1], ah, al, y);
      }
    }
  }
  if (back && a.ds0) {
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = w16 + g + 8 * hh, col = c0 + 8 * nb + 2 * q;
        *reinterpret_cast<float2*>(a.ds0 + head * D * D + row * D + col) =
            make_float2(acc[nb][2 * hh], acc[nb][2 * hh + 1]);
      }
  }
}

// ---------------------------------------------------------------------------
// 2. every chunk on its own
// ---------------------------------------------------------------------------

// 16 warps.  The (channel, sub-chunk) units, one a thread, are taken in two
// shifts: warps 0-7 ("first") and 8-15 each hold all 256 units and split
// the units' work between them.  In the products, warps 0-3 are the r
// warps, 4-7 the k warps, 8-11 the v warps of sub-chunks 0-3, and 12-15
// take dv's inter-chunk rows for the v warps.
constexpr int CTHREADS = 2 * THREADS;
constexpr int UNITS = THREADS;

// decayed operands of the products off the diagonal, rows packed:
// kq for m = 1..3, rows s < 16 m, from row 16 m (m - 1) / 2;
// rE for m = 0..2, rows t' >= 16 (m + 1), from row re_base(m);
// kE, rows s < 48 (sub-chunks 0..2)
constexpr int KQ_ROWS = SUB * NSUB * (NSUB - 1) / 2;  // 96
constexpr int RE_ROWS = KQ_ROWS;
constexpr int KE_ROWS = C - SUB;
__device__ __forceinline__ int kq_base(int m) { return SUB * m * (m - 1) / 2; }
__device__ __forceinline__ int re_base(int m) { return SUB * m * (2 * NSUB - 1 - m) / 2; }

constexpr int TILE = C * PK * 2;             // bytes of a bf16 (C, PK) tile
constexpr int FTILE = C * PW * 4;            // bytes of an f32 (C, PW) tile
constexpr int RS = 0;                        // r, k, v, dO: bf16 (C, PK)
constexpr int KS = RS + TILE;
constexpr int VS = KS + TILE;
constexpr int DS = VS + TILE;
constexpr int LW = DS + TILE;                // logw: f32 (C, PW)
// the operands, each as bf16 hi then lo: S0, dSe, k 2^(last - cum); kq, rE,
// kE; the diagonal blocks of A^T (s, t')
constexpr int S0H = LW + FTILE, S0L = S0H + TILE, DSH = S0L + TILE, DSL = DSH + TILE;
constexpr int KDH = DSL + TILE, KDL = KDH + TILE;
constexpr int KQ_LO = KQ_ROWS * PK;          // elements
constexpr int RE_LO = RE_ROWS * PK;
constexpr int KE_LO = KE_ROWS * PK;
constexpr int ADT_LO = NSUB * SUB * PA;
constexpr int KQ = KDL + TILE;
constexpr int RE = KQ + 2 * KQ_LO * 2;
constexpr int KE = RE + 2 * RE_LO * 2;
constexpr int ADT = KE + 2 * KE_LO * 2;
constexpr int OPR_END = ADT + 2 * ADT_LO * 2;
// once the products are done, their rows for the units, f32 (C, PW), where
// the operands were: dO S0^T, dA kq, v dSe^T, dA^T rE
constexpr int DRI = S0H, DRB = DRI + FTILE, DKI = DRB + FTILE, DKB = DKI + FTILE;
constexpr int DVI = DKB + FTILE;             // dv's inter-chunk rows
// S0 then dSe as loaded, f32 (D, D) each, where rE and kE go once they
// are split
constexpr int SST = DVI + FTILE;
static_assert(SST >= KQ && SST + 2 * D * D * 4 <= OPR_END, "room for the states as loaded");
constexpr int DAD = OPR_END;                 // diagonal blocks of dA, f32 (NSUB, SUB, PD)
// dA^T rE of s < 16 against t' >= 48 and t' >= 32, of s in 16..31 against
// t' >= 48: f32 (3, SUB, PW)
constexpr int SNAP = DAD + NSUB * SUB * PD * 4;
constexpr int PART = SNAP + 3 * SUB * PW * 4;  // f32 (2, NSUB, 128): A's pairs by each warp
constexpr int TOT = PART + 2 * NSUB * 128 * 4; // f32 (NSUB, D): logw over each sub-chunk
constexpr int XT = TOT + NSUB * D * 4;       // f32 (NSUB, D): sum of r * dr inter-chunk
constexpr int YT = XT + NSUB * D * 4;        // f32 (NSUB, D): sum of k * dk inter-chunk
constexpr int GZ = YT + NSUB * D * 4;        // f32 (3, D): the snapshots' sums of Z
constexpr int DUS = GZ + 3 * D * 4;          // f32 (NSUB, D): du of each sub-chunk
constexpr int AV = DUS + NSUB * D * 4;       // f32 (D): (S0 dSe^T)[i, i]
constexpr int US = AV + D * 4;               // f32 (D): u
constexpr int CT = US + D * 4;               // f32 (C): c_t = v_t . dO_t
constexpr int BON = CT + C * 4;              // f32 (C): r_t . (u * k_t)
constexpr int SMEM = BON + C * 4;
static_assert(SMEM <= 232448, "one block an SM");

__global__ void __launch_bounds__(CTHREADS, 1) wkv6_bwd_chunk(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t sb = smem_u32(smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4, mi = lane / 8, mr = lane % 8;
  const int m = warp % NSUB, m16 = SUB * m;  // an mma warp's sub-chunk
  const int role = warp / NSUB;              // 0 r, 1 k, 2 v warps, 3 dv's inter rows
  const bool first = tid < UNITS;            // the units' first shift
  const int c = tid % D, j = (tid % UNITS) / D;  // the unit's channel and sub-chunk
  const Strides& st = a.st;
  const int S = a.S, N = a.N;
  const bf16* rs = reinterpret_cast<const bf16*>(smem + RS);
  const bf16* ks = reinterpret_cast<const bf16*>(smem + KS);
  const bf16* vs = reinterpret_cast<const bf16*>(smem + VS);
  const bf16* dos = reinterpret_cast<const bf16*>(smem + DS);
  const float* lw = reinterpret_cast<const float*>(smem + LW);
  float* tot = reinterpret_cast<float*>(smem + TOT);
  float* dad = reinterpret_cast<float*>(smem + DAD);
  float* av = reinterpret_cast<float*>(smem + AV);
  float* us = reinterpret_cast<float*>(smem + US);
  float* ct = reinterpret_cast<float*>(smem + CT);
  float* bon = reinterpret_cast<float*>(smem + BON);
  bf16* adt = reinterpret_cast<bf16*>(smem + ADT);

  // block (n, h, b): chunk n of head h of batch row b.  Its inputs by
  // cp.async, rows past S zero-filled; S0 and dSe as the walks left them
  const int n = blockIdx.x, h = blockIdx.y, b = blockIdx.z, t0 = n * C;
  const long long head = (long long)b * a.H + h;
#pragma unroll
  for (int x = 0; x < 4; ++x) {  // r, k, v, dO: tensors R_ .. V_ and DO_
    const int tensor = x < 3 ? x : DO_;
    const bf16* src = (x == 0 ? a.r : x == 1 ? a.k : x == 2 ? a.v : a.dout) +
                      st.at(tensor, b, h);
    const long long ts = st.t(tensor);
    for (int i = tid; i < C * (D / 8); i += CTHREADS) {
      const int row = i / (D / 8), p = i % (D / 8);
      const bool ok = t0 + row < S;
      const long long t = ok ? t0 + row : 0;
      cp_async16(sb + x * TILE + (row * PK + p * 8) * 2, src + t * ts + p * 8, ok);
    }
  }
  {
    const float* wb = a.logw + st.at(W_, b, h);
    for (int i = tid; i < C * (D / 4); i += CTHREADS) {
      const int row = i / (D / 4), p = i % (D / 4);
      const bool ok = t0 + row < S;
      const long long t = ok ? t0 + row : 0;
      cp_async16(sb + LW + (row * PW + p * 4) * 4, wb + t * st.t(W_) + p * 4, ok);
    }
    const float* s0 = a.states + (head * N + n) * D * D;
    const float* ds = s0 + (long long)a.B * a.H * N * D * D;
    for (int i = tid; i < D * D / 4; i += CTHREADS) {
      cp_async16(sb + SST + i * 16, s0 + 4 * i, true);
      cp_async16(sb + SST + D * D * 4 + i * 16, ds + 4 * i, true);
    }
    cp_async_commit();
  }
  if (tid < D) us[tid] = a.u[h * D + tid];
  cp_async_wait_all();
  __syncthreads();

  // S0 and dSe as hi + lo, and (S0 dSe^T)[i, i]: thread tid takes 8
  // consecutive elements of row tid / 8 of each
  {
    const int row = tid / 8, col = 8 * (tid % 8);
    const float* s0 = reinterpret_cast<const float*>(smem + SST) + row * D + col;
    const float* ds = s0 + D * D;
    float x[8], y[8], dot = 0.f;
#pragma unroll
    for (int i = 0; i < 8; i += 4) {
      const float4 p = *reinterpret_cast<const float4*>(s0 + i);
      const float4 r = *reinterpret_cast<const float4*>(ds + i);
      x[i] = p.x; x[i + 1] = p.y; x[i + 2] = p.z; x[i + 3] = p.w;
      y[i] = r.x; y[i + 1] = r.y; y[i + 2] = r.z; y[i + 3] = r.w;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) dot = fmaf(x[i], y[i], dot);
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    dot += __shfl_xor_sync(0xffffffffu, dot, 2);
    dot += __shfl_xor_sync(0xffffffffu, dot, 4);
    if (tid % 8 == 0) av[row] = dot;
    uint4 xh, xl, yh, yl;
    split2(x[0], x[1], xh.x, xl.x);
    split2(x[2], x[3], xh.y, xl.y);
    split2(x[4], x[5], xh.z, xl.z);
    split2(x[6], x[7], xh.w, xl.w);
    split2(y[0], y[1], yh.x, yl.x);
    split2(y[2], y[3], yh.y, yl.y);
    split2(y[4], y[5], yh.z, yl.z);
    split2(y[6], y[7], yh.w, yl.w);
    const int at = (row * PK + col) * 2;
    *reinterpret_cast<uint4*>(smem + S0H + at) = xh;
    *reinterpret_cast<uint4*>(smem + S0L + at) = xl;
    *reinterpret_cast<uint4*>(smem + DSH + at) = yh;
    *reinterpret_cast<uint4*>(smem + DSL + at) = yl;
  }

  float before[SUB], after[SUB];
  if (first) {
    tot[j * D + c] = sub_sums(lw, j, c, before, after);  // the sub-chunk sums
  } else {
    // c_t and the bonus, 4 lanes a token, 16 channels each
    static_assert(UNITS == 4 * C && D == 4 * 16, "the second shift covers the tokens");
    {
      const int t = (tid - UNITS) / 4, e0 = 16 * (tid % 4);
      float cc = 0.f, bo = 0.f;
#pragma unroll
      for (int e = e0; e < e0 + 16; e += 8) {
        float vv[8], dd[8], r8[8], k8[8];
        load8(vs + t * PK + e, vv);
        load8(dos + t * PK + e, dd);
        load8(rs + t * PK + e, r8);
        load8(ks + t * PK + e, k8);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          cc = fmaf(vv[i], dd[i], cc);
          bo = fmaf(r8[i] * us[e + i], k8[i], bo);
        }
      }
      cc += __shfl_xor_sync(0xffffffffu, cc, 1);
      bo += __shfl_xor_sync(0xffffffffu, bo, 1);
      cc += __shfl_xor_sync(0xffffffffu, cc, 2);
      bo += __shfl_xor_sync(0xffffffffu, bo, 2);
      if (tid % 4 == 0) {
        ct[t] = cc;
        bon[t] = bo;
      }
    }
    // the diagonal blocks of dA: dO_m v_m^T, by warps 8-11
    if (role == 2) {
      float p[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t af[4], bf[4];
        a_rows<PK>(af, sb + DS, m16, 16 * kk, mi, mr);
        b_rows<PK>(bf, sb + VS, m16, 16 * kk, mi, mr);
        mma_bf16(p[0], af, bf[0], bf[1]);
        mma_bf16(p[1], af, bf[2], bf[3]);
      }
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dad[(m * SUB + g + 8 * (e / 2)) * PD + 8 * nb + 2 * q + e % 2] = p[nb][e];
    }
  }
  __syncthreads();

  // the sums over the sub-chunks before, after and around sub-chunk j
  auto spans = [&](float& pre, float& post, float& last) {
    pre = post = last = 0.f;
#pragma unroll
    for (int i = 0; i < NSUB; ++i) {
      const float x = tot[i * D + c];
      if (i < j) pre += x;
      if (i > j) post += x;
      last += x;
    }
  };
  float* part = reinterpret_cast<float*>(smem + PART);
  sub_sums(lw, j, c, before, after);
  if (first) {
    // the decayed operands as hi + lo, by the units, in code for each
    // sub-chunk (j is the same across a warp)
    float pre, post, last;
    spans(pre, post, last);
    auto build = [&](auto jc) {
      constexpr int J = decltype(jc)::value;
      bf16* kd = reinterpret_cast<bf16*>(smem + KDH);
      bf16* kq = reinterpret_cast<bf16*>(smem + KQ);
      bf16* re = reinterpret_cast<bf16*>(smem + RE);
      bf16* ke = reinterpret_cast<bf16*>(smem + KE);
      // the unit's factors: 2^(sum over sub-chunks J+1..i-1) for kq of
      // sub-chunk i > J, 2^(sum over i+1..J-1) for rE of i < J
      float fq[NSUB], fr[NSUB], span = 0.f;
#pragma unroll
      for (int i = J + 1; i < NSUB; ++i) {
        fq[i] = ex2(span);
        span += tot[i * D + c];
      }
      span = 0.f;
#pragma unroll
      for (int i = J - 1; i >= 0; --i) {
        fr[i] = ex2(span);
        span += tot[i * D + c];
      }
      const float epost = ex2(post);
#pragma unroll
      for (int t = 0; t < SUB; ++t) {
        const int row = SUB * J + t;
        const float ke_t = __bfloat162float(ks[row * PK + c]) * ex2(after[t]);
        const float rb_t = __bfloat162float(rs[row * PK + c]) * ex2(before[t]);
        store_split(kd + row * PK + c, C * PK, ke_t * epost);  // k 2^(last - cum)
#pragma unroll
        for (int i = J + 1; i < NSUB; ++i)
          store_split(kq + (kq_base(i) + row) * PK + c, KQ_LO, ke_t * fq[i]);
#pragma unroll
        for (int i = J - 1; i >= 0; --i)
          store_split(re + (re_base(i) + row - SUB * (i + 1)) * PK + c, RE_LO, rb_t * fr[i]);
        if (J < NSUB - 1) store_split(ke + row * PK + c, KE_LO, ke_t);
      }
    };
    static_assert(NSUB == 4, "one case per sub-chunk");
    switch (j) {
      case 0: build(std::integral_constant<int, 0>()); break;
      case 1: build(std::integral_constant<int, 1>()); break;
      case 2: build(std::integral_constant<int, 2>()); break;
      default: build(std::integral_constant<int, 3>()); break;
    }
    // the operands are the second shift's too (barrier 6, no wait); the
    // r and k warps start as soon as the whole first shift is done
    // (barrier 5), while the second may still sum A's pairs
    asm volatile("bar.arrive 6, %0;\n" ::"n"(CTHREADS) : "memory");
    asm volatile("bar.sync 5, %0;\n" ::"n"(UNITS) : "memory");
  } else {
    // the diagonal blocks of A: A[t', s] = sum_c r_t' k_s 2^(before_t' -
    // before_(s+1)), s < t' (a difference of sums over 16 tokens at most:
    // A feeds only dv, rounded to bf16).  The unit takes its channel's terms
    // of sub-chunk j's pairs, 16 at a time, and its warp (32 channels) sums
    // them (pair_sums); a sub-chunk's two warps meet in shared memory.
    float rr[SUB], kk[SUB];
#pragma unroll
    for (int t = 0; t < SUB; ++t) {
      rr[t] = __bfloat162float(rs[(SUB * j + t) * PK + c]);
      kk[t] = __bfloat162float(ks[(SUB * j + t) * PK + c]);
    }
    float* mine = part + ((warp % 2) * NSUB + j) * 128;
    pair_sums<0>(mine, rr, kk, before, lane);
    pair_sums<1>(mine, rr, kk, before, lane);
    pair_sums<2>(mine, rr, kk, before, lane);
    pair_sums<3>(mine, rr, kk, before, lane);
    pair_sums<4>(mine, rr, kk, before, lane);
    pair_sums<5>(mine, rr, kk, before, lane);
    pair_sums<6>(mine, rr, kk, before, lane);
    pair_sums<7>(mine, rr, kk, before, lane);
    // the sub-chunk's two warps meet (barrier 1 + j, 64 threads), and the
    // second writes its block of A^T as hi + lo, zeros above the diagonal
    asm volatile("bar.sync %0, 64;\n" ::"r"(1 + j) : "memory");
    if (warp % 2) {
      static_assert(SUB * PA * 2 % 16 == 0 && ADT_LO * 2 % 16 == 0, "16-byte zeros");
      for (int i = lane; i < 2 * SUB * PA * 2 / 16; i += 32) {
        const int part_of = i / (SUB * PA * 2 / 16), at = i % (SUB * PA * 2 / 16);
        reinterpret_cast<uint4*>(adt + SUB * j * PA + part_of * ADT_LO)[at] = make_uint4(0, 0, 0, 0);
      }
      __syncwarp();
      for (int p = lane; p < PAIRS; p += 32) {
        // p = tp (tp - 1) / 2 + s, s < tp: 1 + 8 p lies in [(2 tp - 1)^2, (2 tp + 1)^2)
        const int tp = (int)((1.f + sqrtf(1.f + 8.f * p)) * 0.5f), s = p - tp * (tp - 1) / 2;
        store_split(adt + (SUB * j + s) * PA + tp, ADT_LO,
                    part[j * 128 + p] + part[(NSUB + j) * 128 + p]);
      }
    }
    // every operand in place (barrier 6: the first shift has arrived)
    asm volatile("bar.sync 6, %0;\n" ::"n"(CTHREADS) : "memory");
  }

  // the products
  // r warps: dO S0^T, dA kq; k: v dSe^T, dA^T rE; v: A^T dO; role 3: dv inter
  float x0[8][4] = {}, x1[8][4] = {};
  if (role == 0) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t af[4];
      a_rows<PK>(af, sb + DS, m16, 16 * kk, mi, mr);
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj) {
        uint32_t bh[4], bl[4];
        b_rows<PK>(bh, sb + S0H, 16 * jj, 16 * kk, mi, mr);
        b_rows<PK>(bl, sb + S0L, 16 * jj, 16 * kk, mi, mr);
        mma_b2(x0[2 * jj], x0[2 * jj + 1], af, bh, bl);
      }
    }
    // below the diagonal: dA_{m,i} = dO_m v_i^T, i < m, against kq
    for (int i = 0; i < m; ++i) {
      float p[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t af[4], bf[4];
        a_rows<PK>(af, sb + DS, m16, 16 * kk, mi, mr);
        b_rows<PK>(bf, sb + VS, SUB * i, 16 * kk, mi, mr);
        mma_bf16(p[0], af, bf[0], bf[1]);
        mma_bf16(p[1], af, bf[2], bf[3]);
      }
      uint32_t ph[4], pl[4];
      acc_to_a(p, ph, pl);
      const int row = kq_base(m) + SUB * i;
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj) {
        uint32_t bh[4], bl[4];
        b_cols<PK>(bh, sb + KQ, row, 16 * jj, mi, mr);
        b_cols<PK>(bl, sb + KQ + KQ_LO * 2, row, 16 * jj, mi, mr);
        mma_ab2(x1[2 * jj], x1[2 * jj + 1], ph, pl, bh, bl);
      }
    }
  } else if (role == 1) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t af[4];
      a_rows<PK>(af, sb + VS, m16, 16 * kk, mi, mr);
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj) {
        uint32_t bh[4], bl[4];
        b_rows<PK>(bh, sb + DSH, 16 * jj, 16 * kk, mi, mr);
        b_rows<PK>(bl, sb + DSL, 16 * jj, 16 * kk, mi, mr);
        mma_b2(x0[2 * jj], x0[2 * jj + 1], af, bh, bl);
      }
    }
    // above the diagonal, sub-chunks l = 3 down to m + 1: dA^T rE, its
    // partial sums kept for dlogw's straddling pairs
    for (int l = NSUB - 1; l > m; --l) {
      float p[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t af[4], bf[4];
        a_rows<PK>(af, sb + VS, m16, 16 * kk, mi, mr);
        b_rows<PK>(bf, sb + DS, SUB * l, 16 * kk, mi, mr);
        mma_bf16(p[0], af, bf[0], bf[1]);
        mma_bf16(p[1], af, bf[2], bf[3]);
      }
      uint32_t ph[4], pl[4];
      acc_to_a(p, ph, pl);
      const int row = re_base(m) + SUB * (l - m - 1);
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj) {
        uint32_t bh[4], bl[4];
        b_cols<PK>(bh, sb + RE, row, 16 * jj, mi, mr);
        b_cols<PK>(bl, sb + RE + RE_LO * 2, row, 16 * jj, mi, mr);
        mma_ab2(x1[2 * jj], x1[2 * jj + 1], ph, pl, bh, bl);
      }
      const int snap = m == 0 ? (l == 3 ? 0 : (l == 2 ? 1 : -1)) : (m == 1 && l == 3 ? 2 : -1);
      if (snap >= 0) {
        float* sp = reinterpret_cast<float*>(smem + SNAP) + snap * SUB * PW;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sp[(g + 8 * (e / 2)) * PW + 8 * nb + 2 * q + e % 2] = x1[nb][e];
      }
    }
  } else if (role == 3) {
    // dv's inter-chunk rows, (k 2^(last - cum)) dSe, for the v warp of
    // sub-chunk m
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t kh[4], kl[4];
      a_rows<PK>(kh, sb + KDH, m16, 16 * kk, mi, mr);
      a_rows<PK>(kl, sb + KDL, m16, 16 * kk, mi, mr);
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj) {
        uint32_t bh[4], bl[4];
        b_cols<PK>(bh, sb + DSH, 16 * kk, 16 * jj, mi, mr);
        b_cols<PK>(bl, sb + DSL, 16 * kk, 16 * jj, mi, mr);
        mma_ab2(x0[2 * jj], x0[2 * jj + 1], kh, kl, bh, bl);
      }
    }
  } else {
    // dv's rows within the chunk: A^T_{m,l} dO_l for l > m with
    // A^T_{m,l} = kE_m rE_l^T, then the diagonal block A^T_{m,m} dO_m
    for (int l = NSUB - 1; l > m; --l) {
      const int row = re_base(m) + SUB * (l - m - 1);
      float at[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ah[4], al[4], bh[4], bl[4];
        a_rows<PK>(ah, sb + KE, m16, 16 * kk, mi, mr);
        a_rows<PK>(al, sb + KE + KE_LO * 2, m16, 16 * kk, mi, mr);
        b_rows<PK>(bh, sb + RE, row, 16 * kk, mi, mr);
        b_rows<PK>(bl, sb + RE + RE_LO * 2, row, 16 * kk, mi, mr);
        mma_ab2(at[0], at[1], ah, al, bh, bl);
      }
      uint32_t ph[4], pl[4];
      acc_to_a(at, ph, pl);
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj) {
        uint32_t bf[4];
        b_cols<PK>(bf, sb + DS, SUB * l, 16 * jj, mi, mr);
        mma_a2(x0[2 * jj], x0[2 * jj + 1], ph, pl, bf);
      }
    }
    {
      uint32_t ah[4], al[4];
      a_rows<PA>(ah, sb + ADT, m16, 0, mi, mr);
      a_rows<PA>(al, sb + ADT + ADT_LO * 2, m16, 0, mi, mr);
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj) {
        uint32_t bf[4];
        b_cols<PK>(bf, sb + DS, m16, 16 * jj, mi, mr);
        mma_a2(x0[2 * jj], x0[2 * jj + 1], ah, al, bf);
      }
    }
    // the bonus, while dO is here
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = m16 + g + 8 * hh, col = 8 * nb + 2 * q;
        const float2 d = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dos + t * PK + col));
        x0[nb][2 * hh] = fmaf(bon[t], d.x, x0[nb][2 * hh]);
        x0[nb][2 * hh + 1] = fmaf(bon[t], d.y, x0[nb][2 * hh + 1]);
      }
  }
  __syncthreads();  // every operand is read: their place takes the products' rows
  if (role != 2) {
    float* t_i = reinterpret_cast<float*>(smem + (role == 0 ? DRI : role == 1 ? DKI : DVI));
    float* t_b = reinterpret_cast<float*>(smem + (role ? DKB : DRB));
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int at = (m16 + g + 8 * hh) * PW + 8 * nb + 2 * q;
        *reinterpret_cast<float2*>(t_i + at) = make_float2(x0[nb][2 * hh], x0[nb][2 * hh + 1]);
        if (role < 2)
          *reinterpret_cast<float2*>(t_b + at) = make_float2(x1[nb][2 * hh], x1[nb][2 * hh + 1]);
      }
  }
  __syncthreads();
  if (role == 2) {
    // dv: the rows within the chunk and the bonus, then the inter-chunk rows; out
    const float* dvi = reinterpret_cast<const float*>(smem + DVI);
    bf16* dvb = a.dv + st.at(DV_, b, h);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = m16 + g + 8 * hh, col = 8 * nb + 2 * q;
        const float2 e = *reinterpret_cast<const float2*>(dvi + t * PW + col);
        if (t0 + t < S)
          __stcs(reinterpret_cast<unsigned int*>(dvb + (t0 + t) * st.t(DV_) + col),
                 pack_bf16(x0[nb][2 * hh] + e.x, x0[nb][2 * hh + 1] + e.y));
      }
  }

  float* dri = reinterpret_cast<float*>(smem + DRI);
  float* drb = reinterpret_cast<float*>(smem + DRB);
  float* dki = reinterpret_cast<float*>(smem + DKI);
  float* dkb = reinterpret_cast<float*>(smem + DKB);
  float* xt = reinterpret_cast<float*>(smem + XT);
  float* yt = reinterpret_cast<float*>(smem + YT);
  float* gz = reinterpret_cast<float*>(smem + GZ);
  float* dus = reinterpret_cast<float*>(smem + DUS);
  // the first shift: the diagonal block's pairs
  float rr[SUB], kk[SUB], drd[SUB], dkd[SUB], d4[SUB];
#pragma unroll
  for (int t = 0; t < SUB; ++t) {
    rr[t] = __bfloat162float(rs[(SUB * j + t) * PK + c]);
    kk[t] = __bfloat162float(ks[(SUB * j + t) * PK + c]);
    drd[t] = dkd[t] = d4[t] = 0.f;
  }
  const float* dA = dad + j * SUB * PD;
  if (first) {
    float w[SUB];  // the decay of each token, exp(logw)
#pragma unroll
    for (int t = 0; t < SUB; ++t) w[t] = ex2(lw[(SUB * j + t) * PW + c] * LOG2E);
    diag_pairs<1, SUB>(rr, kk, w, dA, drd, dkd, d4);
  } else {
    // the products' rows scaled: dr and dk less the diagonal blocks' pairs
    // in place of the inter-chunk rows, dlogw's within-sub-chunk terms in
    // place of the others; the sums over the sub-chunk, du, and the
    // snapshots' sums of Z (over s in sub-chunk j = 0 against t' after 48
    // and after 32, j = 1 against t' after 48)
    float pre, post, last;
    spans(pre, post, last);
    sub_sums(lw, j, c, before, after);
    const float epre = ex2(pre), epost = ex2(post);
    const float uc = us[c];
    const float* sp = reinterpret_cast<const float*>(smem + SNAP);
    float xsum = 0.f, ysum = 0.f, du = 0.f, z0 = 0.f, z1 = 0.f;
#pragma unroll
    for (int t = 0; t < SUB; ++t) {
      const int row = SUB * j + t, at = row * PW + c;
      const float ea = ex2(after[t]), eb = ex2(before[t]);
      const float vi = dri[at] * eb * epre;
      const float vb = j > 0 ? drb[at] * eb : 0.f;
      const float wi = dki[at] * ea * epost;
      const float wb = j < NSUB - 1 ? dkb[at] * ea : 0.f;
      const float cc = ct[row];
      dri[at] = vi + vb + uc * kk[t] * cc;
      dki[at] = wi + wb + rr[t] * uc * cc;
      const float xi = rr[t] * vi, yi = kk[t] * wi;
      xsum += xi;
      ysum += yi;
      drb[at] = xi + rr[t] * vb;
      dkb[at] = yi + kk[t] * wb;
      du = fmaf(rr[t] * kk[t], cc, du);
      if (j == 0) {
        z0 = fmaf(kk[t] * ea, sp[t * PW + c], z0);
        z1 = fmaf(kk[t] * ea, sp[(SUB + t) * PW + c], z1);
      } else if (j == 1) {
        z0 = fmaf(kk[t] * ea, sp[(2 * SUB + t) * PW + c], z0);
      }
    }
    xt[j * D + c] = xsum;
    yt[j * D + c] = ysum;
    dus[j * D + c] = du;
    if (j == 0) {
      gz[c] = z0;
      gz[D + c] = z1;
    } else if (j == 1) {
      gz[2 * D + c] = z0;
    }
  }
  __syncthreads();
  if (first) {
    // the gradients, into the tiles.  dlogw: (a); (b) and (c) across sub-chunks; the
    // straddling pairs of whole sub-chunks; then within the sub-chunk
    float pre, post, last;
    spans(pre, post, last);
    float base = av[c] * ex2(last);
#pragma unroll
    for (int i = 0; i < NSUB; ++i) {
      if (i > j) base += xt[i * D + c];
      if (i < j) base += yt[i * D + c];
    }
    if (j == 1) base += gz[D + c];
    if (j == 2) base += gz[c] + gz[2 * D + c];
    float run = 0.f;
#pragma unroll
    for (int t = SUB - 1; t >= 0; --t) {
      d4[t] += run;
      run += drb[(SUB * j + t) * PW + c];
    }
    run = 0.f;
#pragma unroll
    for (int t = 0; t < SUB; ++t) {
      const int at = (SUB * j + t) * PW + c;
      dri[at] += drd[t];
      dki[at] += dkd[t];
      drb[at] = base + d4[t] + run;
      run += dkb[at];
    }
    if (j == 0) {
      float x = 0.f;
#pragma unroll
      for (int i = 0; i < NSUB; ++i) x += dus[i * D + c];
      a.du_part[(head * a.N + n) * D + c] = x;
    }
  }
  __syncthreads();
  // dr, dk and dlogw out, 16 bytes a thread at a time
  {
    const int row = tid / 8, col = 8 * (tid % 8);
    if (t0 + row < S) {
      const float* x = dri + row * PW + col;
      const float* y = dki + row * PW + col;
      uint4 pr, pk;
      pr.x = pack_bf16(x[0], x[1]); pr.y = pack_bf16(x[2], x[3]);
      pr.z = pack_bf16(x[4], x[5]); pr.w = pack_bf16(x[6], x[7]);
      pk.x = pack_bf16(y[0], y[1]); pk.y = pack_bf16(y[2], y[3]);
      pk.z = pack_bf16(y[4], y[5]); pk.w = pack_bf16(y[6], y[7]);
      __stcs(reinterpret_cast<uint4*>(a.dr + st.at(DR_, b, h) + (t0 + row) * st.t(DR_) + col), pr);
      __stcs(reinterpret_cast<uint4*>(a.dk + st.at(DK_, b, h) + (t0 + row) * st.t(DK_) + col), pk);
      float* w = a.dlogw + st.at(DW_, b, h) + (t0 + row) * st.t(DW_) + col;
      __stcs(reinterpret_cast<float4*>(w), *reinterpret_cast<const float4*>(drb + row * PW + col));
      __stcs(reinterpret_cast<float4*>(w + 4),
             *reinterpret_cast<const float4*>(drb + row * PW + col + 4));
    }
  }
}

}  // namespace

extern "C" {

// r/k/v/dout/dr/dk/dv: (B, H, S, 64) bf16; logw/dlogw: (B, H, S, 64) f32;
// each addressed through element strides (batch, head, position) with a
// contiguous last dim and 16-byte aligned rows, given in `strides` in the
// order r, k, v, logw, dout, dr, dk, dv, dlogw (27 values).  u: contiguous
// (H, 64) f32; s0: contiguous (B, H, 64, 64) f32; states: a scratch of
// 2 * B * H * N * 64 * 64 f32, N = ceil(S / 64); du_part: contiguous
// (B, H, N, 64) f32, each chunk's share of du (the caller sums them); ds0:
// contiguous (B, H, 64, 64) f32, or null where the state's gradient is not
// wanted.  Two launches on `stream`.  Returns cudaGetLastError().
int wkv6_bwd(const void* r, const void* k, const void* v, const void* logw,
             const void* u, const void* s0, const void* dout, void* dr,
             void* dk, void* dv, void* dlogw, void* du_part, void* ds0,
             void* states, int B, int H, int S, int Dh, const long long* strides,
             void* stream) {
  if (Dh != D || S < 1 || B < 1 || H < 1 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const int N = (S + C - 1) / C;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(wkv6_bwd_states,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, ST_SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(wkv6_bwd_chunk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  Args a;
  a.r = static_cast<const bf16*>(r);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.logw = static_cast<const float*>(logw);
  a.u = static_cast<const float*>(u);
  a.s0 = static_cast<const float*>(s0);
  a.dr = static_cast<bf16*>(dr);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.dlogw = static_cast<float*>(dlogw);
  a.du_part = static_cast<float*>(du_part);
  a.ds0 = static_cast<float*>(ds0);
  a.states = static_cast<float*>(states);
  a.B = B;
  a.H = H;
  a.S = S;
  a.N = N;
  for (int i = 0; i < 3 * NTENSORS; ++i) a.st.s[i] = strides[i];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  wkv6_bwd_states<<<dim3(2, H, B), THREADS, ST_SMEM, s>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  wkv6_bwd_chunk<<<dim3(N, H, B), CTHREADS, SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

const char* wkv6_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
