// The gradient of the WKV6 recurrence of RWKV6 "Finch" (rwkv6-7b), on Hopper.
//
// The TPU kernel src/repro/kernels/rwkv6_scan/kernel.py :: wkv6_scan has no
// backward: the reference trains through JAX's autodiff of its jnp
// wkv6_chunked (src/repro/models/rwkv.py:49).  This kernel takes that
// autodiff's place under ops.py :: WKV6Fn.  Per (batch, head), with S_t the
// (D, D) f32 state after token t (k-dim x v-dim, S_{-1} = state0), dS_t the
// loss's gradient with respect to it (dS_{S-1} = 0: the final state is not
// differentiated) and c_t = v_t . dO_t:
//
//   dr_t = S_{t-1} dO_t^T + u * k_t c_t                (first term: dr~_t)
//   dk_t = dS_t v_t^T + r_t * u c_t                     (first term: dk~_t)
//   dv_t = k_t dS_t + (r_t . (u * k_t)) dO_t
//   dS_{t-1} = diag(exp(logw_t)) dS_t + r_t^T dO_t
//   dlogw_t = P_t - k_t * dk~_t,  P_t = sum_{t' > t} (r_t' * dr~_t' - k_t' * dk~_t')
//   du = sum_{b, t} r_t * k_t c_t,   dstate0 = dS_{-1}
//
// dlogw never needs S and dS at once and never divides by a decay.  P_t is
// sum_j S_t[:, j] dS_t[:, j], so one running sum of the difference stays
// that small; the two sums taken apart would each grow with the sequence
// and cancel (at strong decays, to ~1e-3 of their size).  At strong decays
// dlogw_t is itself ~1e-3 of P_t, so in f32 its norm carries ~1e-4 of
// error and its worst rows ~0.4 of their RMS, as in the plain version;
// exp(logw_t) sum_j S_{t-1} dS_t, which has no cancellation, needs S and dS
// at once (the chunked redesign).  The plain version is ref.py ::
// wkv6_bwd_ref, which runs the same passes.
//
// What bounds it on the H100.  Per token and head the function needs about
// 12 D^2 f32 operations on the CUDA cores: the state rebuilt (3 D^2: a
// product and an FMA per element), dr~ (2 D^2), dS carried (3 D^2), dk~ and
// dv (2 D^2 each); it moves 22 bytes per token, head and channel (r, k, v,
// dO read in bf16, logw in f32; dr, dk, dv written in bf16, dlogw in f32).
// At the training shape (B = 2, S = 2048, H = 64, D = 64) that is 12.9
// GFLOP, 0.19 ms at 67 TFLOP/s, against 0.37 GB, 0.11 ms at 3.35 TB/s: it is
// bound by operations, and the tokens of one head are strictly sequential.
//
// What the design does about it.  The rows of S and dS evolve independently
// of each other (diag(w) scales rows, each update is an outer product), and
// so do their columns.  dr~, dk~ and so dlogw are sums along rows; dv is a
// sum along columns.  So two kinds of blocks of 128 threads split each head,
// and no block reduces across warps in its token loop:
//
// * a row block owns 32 rows of S and dS for the whole sequence, each row
//   held by KS = 4 neighbouring lanes, 16 columns each.  One pass forward in
//   time rebuilds S from state0 and writes dr and r * dr~ (into dlogw, as a
//   scratch); one pass backward carries dS and writes dk, dlogw (the
//   running P_t, a thread per row) and the block's rows of du (per batch
//   row) and dstate0;
// * a column block owns 32 columns of dS, each held by 4 lanes, 16 rows
//   each, and walks backward carrying dS to write dv.
//
// At the training shape that is 2 row and 2 column blocks per (b, h), 512
// blocks, all resident at once at 4 blocks per SM.  The dS carried by the
// row and the column blocks is the same (3 D^2 per token done twice), which
// buys a reduction of 4 lanes (warp shuffles) for every sum.  The 4 lanes
// of a row or column meet KS tokens at a time in one transposed reduction
// (3 shuffles for 4 tokens), as in wkv6_scan.cu.  T tokens at a time are
// staged in shared memory as f32 (exp(logw) once per element), the next
// chunk's loads held in registers while the current one is computed.  A
// chunk's results go through shared memory, so every global write is a
// row of consecutive elements.  Nothing is atomic: every output element is
// written once by one thread, so two calls give the same bits.  A chunked
// tensor-core form (as wkv6_chunk.cu does the forward) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 64;          // head dim, the only one taken
constexpr int KS = 4;          // lanes sharing one state row (column)
static_assert(KS == 4, "the grouped reduction below is written for 4 lanes");
constexpr int NS = D / KS;     // state elements per lane
constexpr int ROWS = 32;       // rows per row block
constexpr int COLS = 32;       // columns per column block
constexpr int NT = ROWS * KS;  // threads per block
static_assert(NT == COLS * KS, "both kinds of blocks take NT threads");
constexpr int NWARPS = NT / 32;
constexpr int RBLOCKS = D / ROWS;
constexpr int CBLOCKS = D / COLS;
constexpr int T = 32;          // tokens staged per chunk

// shared memory of a row block: v, dO (T x D), then r, k, exp(logw),
// results and r * dr~ of its rows (T x ROWS), c_t, u of its rows, du parts
constexpr int ROW_SMEM = 2 * T * D + 5 * T * ROWS + T + ROWS + NT;
// of a column block: r, k, exp(logw) (T x D), dO and results of its
// columns (T x COLS), r . (u * k) per token, u
constexpr int COL_SMEM = 3 * T * D + 2 * T * COLS + T + D;
constexpr int SMEM_FLOATS = ROW_SMEM > COL_SMEM ? ROW_SMEM : COL_SMEM;

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

__device__ __forceinline__ void unpack(const uint4& q, float* x, float) {
  const float4 f = *reinterpret_cast<const float4*>(&q);
  x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
}

__device__ __forceinline__ void unpack(const uint4& q, float* x, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// A (T, W)-element tile of a (S, .) operand (row t at base + t * ts), held
// as 16-byte pieces in registers between its load from device memory and
// its store to shared memory as f32 at a pitch of W.  Thread tid holds
// pieces tid, tid + NT, ...; rows past n are neither loaded nor stored.
// Loads are plain (no __ldg): the r * dr~ scratch goes through here too,
// and this kernel writes it.
template <typename E, int W>
struct Tile {
  static constexpr int C = 16 / sizeof(E);  // elements per piece
  static constexpr int PR = W / C;          // pieces per row
  static constexpr int N = (T * PR + NT - 1) / NT;
  uint4 q[N];

  __device__ __forceinline__ void load(const E* base, long long ts, int n) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int p = threadIdx.x + i * NT;
      if (p < T * PR && p / PR < n)
        q[i] = *reinterpret_cast<const uint4*>(base + (p / PR) * ts + (p % PR) * C);
    }
  }

  __device__ __forceinline__ void store(float* dst, int n, bool decay) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int p = threadIdx.x + i * NT;
      if (p < T * PR && p / PR < n) {
        float x[C];
        unpack(q[i], x, E());
        if (decay) {
#pragma unroll
          for (int j = 0; j < C; ++j) x[j] = expf(x[j]);
        }
        float* d = dst + (p / PR) * W + (p % PR) * C;
#pragma unroll
        for (int j = 0; j < C; j += 4)
          *reinterpret_cast<float4*>(d + j) = make_float4(x[j], x[j + 1], x[j + 2], x[j + 3]);
      }
    }
  }
};

// One token for a lane's 16 elements of a row of S (or dS), columns
// 4 (ks + 4 m) + e: returns the partial sum of st * red over them and moves
// st to st * w + a * add.  Forward: red = dO_t, add = v_t, a = k_t (row).
// Backward: red = v_t, add = dO_t, a = r_t (row).
__device__ __forceinline__ float row_token(float* st, const float* red,
                                           const float* add, int ks, float w,
                                           float a) {
  float o0 = 0.f, o1 = 0.f, o2 = 0.f, o3 = 0.f;
#pragma unroll
  for (int m = 0; m < NS / 4; ++m) {
    const int c = 4 * (ks + KS * m);
    const float4 x = *reinterpret_cast<const float4*>(red + c);
    const float4 y = *reinterpret_cast<const float4*>(add + c);
    float* s = st + 4 * m;
    o0 = fmaf(s[0], x.x, o0);
    o1 = fmaf(s[1], x.y, o1);
    o2 = fmaf(s[2], x.z, o2);
    o3 = fmaf(s[3], x.w, o3);
    s[0] = fmaf(s[0], w, a * y.x);
    s[1] = fmaf(s[1], w, a * y.y);
    s[2] = fmaf(s[2], w, a * y.z);
    s[3] = fmaf(s[3], w, a * y.w);
  }
  return (o0 + o1) + (o2 + o3);
}

// One token backward for a lane's 16 elements of a column of dS, rows
// 4 (ks + 4 m) + e: returns the partial sum of k_t * dS over them and moves
// dS to exp(logw_t) * dS + r_t * d, d = dO_t at this column.
__device__ __forceinline__ float col_token(float* st, const float* kk,
                                           const float* ww, const float* rr,
                                           int ks, float d) {
  float o0 = 0.f, o1 = 0.f, o2 = 0.f, o3 = 0.f;
#pragma unroll
  for (int m = 0; m < NS / 4; ++m) {
    const int c = 4 * (ks + KS * m);
    const float4 k4 = *reinterpret_cast<const float4*>(kk + c);
    const float4 w4 = *reinterpret_cast<const float4*>(ww + c);
    const float4 r4 = *reinterpret_cast<const float4*>(rr + c);
    float* s = st + 4 * m;
    o0 = fmaf(k4.x, s[0], o0);
    o1 = fmaf(k4.y, s[1], o1);
    o2 = fmaf(k4.z, s[2], o2);
    o3 = fmaf(k4.w, s[3], o3);
    s[0] = fmaf(s[0], w4.x, r4.x * d);
    s[1] = fmaf(s[1], w4.y, r4.y * d);
    s[2] = fmaf(s[2], w4.z, r4.z * d);
    s[3] = fmaf(s[3], w4.w, r4.w * d);
  }
  return (o0 + o1) + (o2 + o3);
}

// The partial sums p[q] of KS tokens over the KS lanes of a row: lanes with
// bit 1 of ks keep tokens 2, 3 and send 0, 1; then bit 0.  Lane ks returns
// the whole sum of token ks.
__device__ __forceinline__ float gather4(const float* p, int ks) {
  const bool hi = ks & 2, odd = ks & 1;
  float a0 = hi ? p[2] : p[0], a1 = hi ? p[3] : p[1];
  a0 += __shfl_xor_sync(0xffffffffu, hi ? p[0] : p[2], 2);
  a1 += __shfl_xor_sync(0xffffffffu, hi ? p[1] : p[3], 2);
  float o = odd ? a1 : a0;
  o += __shfl_xor_sync(0xffffffffu, odd ? a0 : a1, 1);
  return o;
}

__device__ __forceinline__ float sum4(float o) {
  o += __shfl_xor_sync(0xffffffffu, o, 1);
  return o + __shfl_xor_sync(0xffffffffu, o, 2);
}

// a . b over D elements of two staged rows, one warp per token
__device__ __forceinline__ float warp_dot(const float* a, const float* b,
                                          const float* c, int lane) {
  float x = 0.f;
#pragma unroll
  for (int j = lane; j < D; j += 32) x = fmaf(a[j] * (c ? c[j] : 1.f), b[j], x);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

struct Args {
  const __nv_bfloat16 *r, *k, *v, *dout;
  const float *logw, *u, *s0;
  __nv_bfloat16 *dr, *dk, *dv;
  float *dlogw, *du_part, *ds0;
  int H, S;
  Strides st;
};

__device__ __forceinline__ void row_block(const Args& a, float* smem, int r0, int h, int b) {
  float* vs = smem;
  float* dos = vs + T * D;
  float* rs = dos + T * D;
  float* kb = rs + T * ROWS;
  float* ws = kb + T * ROWS;
  float* res = ws + T * ROWS;
  float* rdrs = res + T * ROWS;
  float* cdot = rdrs + T * ROWS;
  float* us = cdot + T;
  float* dus = us + ROWS;

  const int tid = threadIdx.x, ks = tid % KS, rl = tid / KS;
  const int lane = tid & 31, warp = tid >> 5;
  const Strides& st = a.st;
  const __nv_bfloat16* rb = a.r + st.at(R_, b, h) + r0;
  const __nv_bfloat16* kbp = a.k + st.at(K_, b, h) + r0;
  const __nv_bfloat16* vb = a.v + st.at(V_, b, h);
  const __nv_bfloat16* dob = a.dout + st.at(DO_, b, h);
  const float* wb = a.logw + st.at(W_, b, h) + r0;
  __nv_bfloat16* drb = a.dr + st.at(DR_, b, h) + r0;
  __nv_bfloat16* dkb = a.dk + st.at(DK_, b, h) + r0;
  float* dwb = a.dlogw + st.at(DW_, b, h) + r0;
  const long long sbase = ((long long)b * a.H + h) * D * D + (long long)(r0 + rl) * D;
  const int S = a.S;

  for (int i = tid; i < ROWS; i += NT) us[i] = a.u[h * D + r0 + i];

  Tile<__nv_bfloat16, D> vt, dot;
  Tile<__nv_bfloat16, ROWS> rt, kt;
  Tile<float, ROWS> wt, pt;
  auto fetch = [&](int t0, bool back) {
    const int n = min(T, S - t0);
    vt.load(vb + t0 * st.t(V_), st.t(V_), n);
    dot.load(dob + t0 * st.t(DO_), st.t(DO_), n);
    rt.load(rb + t0 * st.t(R_), st.t(R_), n);
    kt.load(kbp + t0 * st.t(K_), st.t(K_), n);
    wt.load(wb + t0 * st.t(W_), st.t(W_), n);
    if (back) pt.load(dwb + t0 * st.t(DW_), st.t(DW_), n);
  };
  auto stage = [&](int n, bool back) {
    vt.store(vs, n, false);
    dot.store(dos, n, false);
    rt.store(rs, n, false);
    kt.store(kb, n, false);
    wt.store(ws, n, true);
    if (back) pt.store(rdrs, n, false);
  };
  // c_t = v_t . dO_t of the staged tokens
  auto dots = [&](int n) {
    for (int t = warp; t < n; t += NWARPS) {
      const float x = warp_dot(vs + t * D, dos + t * D, nullptr, lane);
      if (lane == 0) cdot[t] = x;
    }
  };

  float s[NS];
#pragma unroll
  for (int m = 0; m < NS / 4; ++m) {
    const float4 x = *reinterpret_cast<const float4*>(a.s0 + sbase + 4 * (ks + KS * m));
    s[4 * m] = x.x; s[4 * m + 1] = x.y; s[4 * m + 2] = x.z; s[4 * m + 3] = x.w;
  }

  // forward in time: rebuild S, write dr and r * dr~ (into dlogw)
  fetch(0, false);
  for (int t0 = 0; t0 < S; t0 += T) {
    const int n = min(T, S - t0);
    __syncthreads();  // the previous chunk's readers are done
    stage(n, false);
    __syncthreads();
    if (t0 + T < S) fetch(t0 + T, false);
    dots(n);
    int t = 0;
    for (; t + KS <= n; t += KS) {
      float p[KS];
#pragma unroll
      for (int q = 0; q < KS; ++q) {
        const int tq = t + q;
        p[q] = row_token(s, dos + tq * D, vs + tq * D, ks, ws[tq * ROWS + rl],
                         kb[tq * ROWS + rl]);
      }
      res[(t + ks) * ROWS + rl] = gather4(p, ks);
    }
    for (; t < n; ++t) {
      const float o = sum4(row_token(s, dos + t * D, vs + t * D, ks,
                                     ws[t * ROWS + rl], kb[t * ROWS + rl]));
      if (ks == 0) res[t * ROWS + rl] = o;
    }
    __syncthreads();
    for (int e = tid; e < n * ROWS; e += NT) {
      const int tt = e / ROWS, i = e % ROWS;
      const float drt = res[e];
      drb[(t0 + tt) * st.t(DR_) + i] = __float2bfloat16(fmaf(us[i] * kb[e], cdot[tt], drt));
      dwb[(t0 + tt) * st.t(DW_) + i] = rs[e] * drt;
    }
  }
  __syncthreads();  // r * dr~ is visible to the whole block

  // backward in time: carry dS, write dk, dlogw, du and dstate0
#pragma unroll
  for (int j = 0; j < NS; ++j) s[j] = 0.f;
  float du = 0.f, acc = 0.f;  // acc: P_t of row tid (tid < ROWS)
  const int last = (S - 1) / T * T;
  fetch(last, true);
  for (int t0 = last; t0 >= 0; t0 -= T) {
    const int n = min(T, S - t0);
    __syncthreads();
    stage(n, true);
    __syncthreads();
    if (t0 > 0) fetch(t0 - T, true);
    dots(n);
    const int whole = n - n % KS;
    for (int t = n - 1; t >= whole; --t) {
      const float o = sum4(row_token(s, vs + t * D, dos + t * D, ks,
                                     ws[t * ROWS + rl], rs[t * ROWS + rl]));
      if (ks == 0) res[t * ROWS + rl] = o;
    }
    for (int t = whole - KS; t >= 0; t -= KS) {
      float p[KS];
#pragma unroll
      for (int q = KS - 1; q >= 0; --q) {
        const int tq = t + q;
        p[q] = row_token(s, vs + tq * D, dos + tq * D, ks, ws[tq * ROWS + rl],
                         rs[tq * ROWS + rl]);
      }
      res[(t + ks) * ROWS + rl] = gather4(p, ks);
    }
    __syncthreads();
    for (int e = tid; e < n * ROWS; e += NT) {
      const int tt = e / ROWS, i = e % ROWS;
      const float dkt = res[e], rr = rs[e], kk = kb[e];
      dkb[(t0 + tt) * st.t(DK_) + i] = __float2bfloat16(fmaf(rr * us[i], cdot[tt], dkt));
      res[e] = kk * dkt;
      du = fmaf(rr * kk, cdot[tt], du);  // row tid % ROWS
    }
    __syncthreads();
    if (tid < ROWS) {
      for (int tt = n - 1; tt >= 0; --tt) {
        const float kdk = res[tt * ROWS + tid];
        dwb[(t0 + tt) * st.t(DW_) + tid] = acc - kdk;
        acc += rdrs[tt * ROWS + tid] - kdk;
      }
    }
  }

  dus[tid] = du;
  __syncthreads();
  if (tid < ROWS) {
    float x = 0.f;
#pragma unroll
    for (int g = 0; g < NT / ROWS; ++g) x += dus[tid + g * ROWS];
    a.du_part[((long long)b * a.H + h) * D + r0 + tid] = x;
  }
  if (a.ds0) {
#pragma unroll
    for (int m = 0; m < NS / 4; ++m)
      *reinterpret_cast<float4*>(a.ds0 + sbase + 4 * (ks + KS * m)) =
          make_float4(s[4 * m], s[4 * m + 1], s[4 * m + 2], s[4 * m + 3]);
  }
}

__device__ __forceinline__ void col_block(const Args& a, float* smem, int c0, int h, int b) {
  float* rs = smem;
  float* kb = rs + T * D;
  float* ws = kb + T * D;
  float* dos = ws + T * D;
  float* res = dos + T * COLS;
  float* bon = res + T * COLS;
  float* us = bon + T;

  const int tid = threadIdx.x, ks = tid % KS, cl = tid / KS;
  const int lane = tid & 31, warp = tid >> 5;
  const Strides& st = a.st;
  const __nv_bfloat16* rb = a.r + st.at(R_, b, h);
  const __nv_bfloat16* kbp = a.k + st.at(K_, b, h);
  const float* wb = a.logw + st.at(W_, b, h);
  const __nv_bfloat16* dob = a.dout + st.at(DO_, b, h) + c0;
  __nv_bfloat16* dvb = a.dv + st.at(DV_, b, h) + c0;
  const int S = a.S;

  for (int i = tid; i < D; i += NT) us[i] = a.u[h * D + i];

  Tile<__nv_bfloat16, D> rt, kt;
  Tile<float, D> wt;
  Tile<__nv_bfloat16, COLS> dot;
  auto fetch = [&](int t0) {
    const int n = min(T, S - t0);
    rt.load(rb + t0 * st.t(R_), st.t(R_), n);
    kt.load(kbp + t0 * st.t(K_), st.t(K_), n);
    wt.load(wb + t0 * st.t(W_), st.t(W_), n);
    dot.load(dob + t0 * st.t(DO_), st.t(DO_), n);
  };

  float s[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) s[j] = 0.f;
  const int last = (S - 1) / T * T;
  fetch(last);
  for (int t0 = last; t0 >= 0; t0 -= T) {
    const int n = min(T, S - t0);
    __syncthreads();
    rt.store(rs, n, false);
    kt.store(kb, n, false);
    wt.store(ws, n, true);
    dot.store(dos, n, false);
    __syncthreads();
    if (t0 > 0) fetch(t0 - T);
    // r_t . (u * k_t)
    for (int t = warp; t < n; t += NWARPS) {
      const float x = warp_dot(rs + t * D, kb + t * D, us, lane);
      if (lane == 0) bon[t] = x;
    }
    const int whole = n - n % KS;
    for (int t = n - 1; t >= whole; --t) {
      const float o = sum4(col_token(s, kb + t * D, ws + t * D, rs + t * D, ks,
                                     dos[t * COLS + cl]));
      if (ks == 0) res[t * COLS + cl] = o;
    }
    for (int t = whole - KS; t >= 0; t -= KS) {
      float p[KS];
#pragma unroll
      for (int q = KS - 1; q >= 0; --q) {
        const int tq = t + q;
        p[q] = col_token(s, kb + tq * D, ws + tq * D, rs + tq * D, ks,
                         dos[tq * COLS + cl]);
      }
      res[(t + ks) * COLS + cl] = gather4(p, ks);
    }
    __syncthreads();
    for (int e = tid; e < n * COLS; e += NT) {
      const int tt = e / COLS, j = e % COLS;
      dvb[(t0 + tt) * st.t(DV_) + j] = __float2bfloat16(fmaf(bon[tt], dos[e], res[e]));
    }
  }
}

// grid (RBLOCKS + CBLOCKS, H, B): blocks x < RBLOCKS own rows, the others
// columns, of head h of batch row b
__global__ void __launch_bounds__(NT, 4) wkv6_bwd_kernel(const Args a) {
  __shared__ __align__(16) float smem[SMEM_FLOATS];
  const int h = blockIdx.y, b = blockIdx.z;
  if (blockIdx.x < RBLOCKS)
    row_block(a, smem, blockIdx.x * ROWS, h, b);
  else
    col_block(a, smem, (blockIdx.x - RBLOCKS) * COLS, h, b);
}

}  // namespace

extern "C" {

// r/k/v/dout/dr/dk/dv: (B, H, S, 64) bf16; logw/dlogw: (B, H, S, 64) f32;
// each addressed through element strides (batch, head, position) with a
// contiguous last dim, given in `strides` in the order r, k, v, logw, dout,
// dr, dk, dv, dlogw (27 values).  u: contiguous (H, 64) f32; s0: contiguous
// (B, H, 64, 64) f32; du_part: contiguous (B, H, 64) f32, each batch row's
// share of du (the caller sums them); ds0: contiguous (B, H, 64, 64) f32, or
// null where the state's gradient is not wanted.  dlogw must not overlap an
// input: it holds r * dr~ between the two passes.  Returns
// cudaGetLastError().
int wkv6_bwd(const void* r, const void* k, const void* v, const void* logw,
             const void* u, const void* s0, const void* dout, void* dr,
             void* dk, void* dv, void* dlogw, void* du_part, void* ds0, int B,
             int H, int S, int Dh, const long long* strides, void* stream) {
  if (Dh != D || S < 1 || B < 1 || H < 1 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.r = static_cast<const __nv_bfloat16*>(r);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.logw = static_cast<const float*>(logw);
  a.u = static_cast<const float*>(u);
  a.s0 = static_cast<const float*>(s0);
  a.dr = static_cast<__nv_bfloat16*>(dr);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.dlogw = static_cast<float*>(dlogw);
  a.du_part = static_cast<float*>(du_part);
  a.ds0 = static_cast<float*>(ds0);
  a.H = H;
  a.S = S;
  for (int i = 0; i < 3 * NTENSORS; ++i) a.st.s[i] = strides[i];
  const dim3 grid(RBLOCKS + CBLOCKS, H, B);
  wkv6_bwd_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* wkv6_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
