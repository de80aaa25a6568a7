// The WKV6 recurrence of RWKV6 "Finch" (rwkv6-7b), on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan/kernel.py ::
// wkv6_scan (body _wkv6_kernel), reached through ops.py :: wkv6_op.  Per
// (batch, head), with a (D, D) f32 state S (k-dim x v-dim):
//
//   o_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t
//   S_t = diag(exp(logw_t)) S_{t-1} + k_t^T v_t
//
// It returns o in r's dtype and the final state in f32.  Every exponent is
// a logw <= 0; there is no 1/decay factor anywhere.
//
// What bounds it on the H100.  Per token and head the recurrence does
// ~5 D^2 f32 operations (D^2 FMA for o, a multiply and an FMA per state
// element) on ~(3 * 2 + 4 + 2) D bytes of r, k, v, logw and o, so at D = 64
// the prefill is bound by operations: at S = 1000, H = 64 it is ~1.3 GFLOP,
// ~20 us at the 67 TFLOP/s of the CUDA cores, against ~51 MB (~15 us) of
// bytes.  A decode step (S = 1) is bound by bytes: each (b, h) reads and
// writes its 16 KB state, ~17 MB at B = 8, ~5 us.  The tokens of one head
// are strictly sequential, so the parallelism is B * H * D state columns.
//
// What the design does about it.  Unlike the TPU kernel it carries nothing
// from block to block: the TPU kernel walks the chunks of a sequence on a
// sequential grid axis, while Hopper runs blocks in no order.  Here one
// block owns COLS columns of one (b, h) state for the whole sequence and
// loops over t itself.  The columns of S are independent, so a head is
// split over D / COLS blocks (128 blocks at B = 1, H = 64).  Each column is
// held in the registers of KS neighbouring threads of a warp, D / KS rows
// each, so a token needs no block barrier: the KS partial sums of o_t meet
// by warp shuffles, KS tokens at a time in one transposed reduction, which
// leaves each lane one token's sum and lets a group's shuffles overlap the
// next group's FMAs.  T tokens at a time are staged in shared memory as
// f32 (exp(logw) once per element, not once per column); each thread loads
// its 16-byte pieces of the next T tokens into registers before it works
// on the current ones, so device-memory latency is paid once, not once per
// chunk.  r, k and the decay are read back as float4 from rows padded so
// that the KS slices of one load fall in distinct banks.  The bonus
// r_t . (u * k_t) is one dot product per token, computed once per chunk by
// the whole block.  The loop runs to exactly S, so nothing is masked, and
// the state may be updated in place (each thread reads and writes only its
// own elements).  The chunked tensor-core form (the TPU kernel's (C, C)
// decay products) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int KS = 4;           // threads sharing one state column
static_assert(KS == 4, "the grouped reduction below is written for 4 lanes");
constexpr int COLS = 32;        // state columns per block
constexpr int NT = COLS * KS;   // threads per block
constexpr int NWARPS = NT / 32;

template <int D>
struct Cfg {
  static constexpr int T = D <= 64 ? 32 : 16;  // tokens staged per chunk
  static constexpr int R = D / KS;             // state rows per thread
  static constexpr int PITCH = D + 4 * KS;     // row of r/k/decay in smem
};

// Shared-memory index of element j of a staged row: slice s = j / R starts
// at s * (R + 4), which spreads the KS slices over distinct banks.
template <int D>
__device__ __forceinline__ int padded(int j) {
  return j + 4 * (j / Cfg<D>::R);
}

__device__ __forceinline__ void store_elem(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_elem(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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

// One (TT, W)-element tile of a (S, .) row-major operand (row t at
// base + t * ts), held as 16-byte pieces in registers between its load from
// device memory and its store to shared memory as f32.  Thread tid holds
// pieces tid, tid + NT, ...; rows past n are neither loaded nor stored.
template <typename T, int TT, int W>
struct Tile {
  static constexpr int C = 16 / sizeof(T);  // elements per piece
  static constexpr int PR = W / C;          // pieces per row
  static constexpr int N = (TT * PR + NT - 1) / NT;
  uint4 q[N];

  __device__ __forceinline__ void load(const T* base, long long ts, int n) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int p = threadIdx.x + i * NT;
      if (p < TT * PR && p / PR < n)
        q[i] = *reinterpret_cast<const uint4*>(base + (p / PR) * ts + (p % PR) * C);
    }
  }

  // element c of row t goes to dst[t * pitch + at(c)], as exp(x) if `decay`
  template <typename At>
  __device__ __forceinline__ void store(float* dst, int pitch, int n, At at,
                                        bool decay) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int p = threadIdx.x + i * NT;
      if (p < TT * PR && p / PR < n) {
        float x[C];
        unpack(q[i], x, T());
        if (decay) {
#pragma unroll
          for (int j = 0; j < C; ++j) x[j] = expf(x[j]);
        }
        const int c = (p % PR) * C;
        float* d = dst + (p / PR) * pitch;
#pragma unroll
        for (int j = 0; j < C; j += 4)  // a group of 4 stays in one slice
          *reinterpret_cast<float4*>(d + at(c + j)) =
              make_float4(x[j], x[j + 1], x[j + 2], x[j + 3]);
      }
    }
  }
};

// One token for this thread's R rows of its column: returns the partial
// r_t . S_{t-1}[rows, col] and moves them to S_t.
template <int R>
__device__ __forceinline__ float token(float* st, const float* rr,
                                       const float* kk, const float* ww,
                                       float vv) {
  float o0 = 0.f, o1 = 0.f, o2 = 0.f, o3 = 0.f;
#pragma unroll
  for (int j = 0; j < R; j += 4) {
    const float4 r4 = *reinterpret_cast<const float4*>(rr + j);
    const float4 k4 = *reinterpret_cast<const float4*>(kk + j);
    const float4 w4 = *reinterpret_cast<const float4*>(ww + j);
    o0 = fmaf(r4.x, st[j], o0);
    o1 = fmaf(r4.y, st[j + 1], o1);
    o2 = fmaf(r4.z, st[j + 2], o2);
    o3 = fmaf(r4.w, st[j + 3], o3);
    st[j] = fmaf(st[j], w4.x, k4.x * vv);
    st[j + 1] = fmaf(st[j + 1], w4.y, k4.y * vv);
    st[j + 2] = fmaf(st[j + 2], w4.z, k4.z * vv);
    st[j + 3] = fmaf(st[j + 3], w4.w, k4.w * vv);
  }
  return (o0 + o1) + (o2 + o3);
}

// grid (D / COLS, H, B); thread tid holds rows [ks * R, ks * R + R) of
// column col0 + tid / KS, ks = tid % KS.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
wkv6_fwd(const T* __restrict__ r, const T* __restrict__ k,
         const T* __restrict__ v, const float* __restrict__ logw,
         const float* __restrict__ u, const float* s0, T* __restrict__ out,
         float* s1, int H, int S, long long rsb, long long rsh, long long rst,
         long long ksb, long long ksh, long long kst, long long vsb,
         long long vsh, long long vst, long long wsb, long long wsh,
         long long wst, long long osb, long long osh, long long ost) {
  using C = Cfg<D>;
  constexpr int TT = C::T, R = C::R, PITCH = C::PITCH;
  __shared__ __align__(16) float rs[TT * PITCH];
  __shared__ __align__(16) float kbuf[TT * PITCH];
  __shared__ __align__(16) float wbuf[TT * PITCH];
  __shared__ __align__(16) float vs[TT * COLS];
  __shared__ float bonus[TT];
  __shared__ float us[D];

  const int col0 = blockIdx.x * COLS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ks = tid % KS;
  const int c = tid / KS;
  const int lane = tid & 31, warp = tid >> 5;

  const T* rb = r + b * rsb + h * rsh;
  const T* kb = k + b * ksb + h * ksh;
  const T* vb = v + b * vsb + h * vsh + col0;
  const float* wb = logw + b * wsb + h * wsh;
  T* ob = out + b * osb + h * osh + col0 + c;
  const long long sbase = ((long long)b * H + h) * D * D + col0 + c;

  for (int i = tid; i < D; i += NT) us[i] = u[h * D + i];

  float st[R];
#pragma unroll
  for (int j = 0; j < R; ++j) st[j] = s0[sbase + (long long)(ks * R + j) * D];

  Tile<T, TT, D> rt, kt;
  Tile<float, TT, D> wt;
  Tile<T, TT, COLS> vt;
  auto fetch = [&](int t0) {
    const int n = min(TT, S - t0);
    rt.load(rb + t0 * rst, rst, n);
    kt.load(kb + t0 * kst, kst, n);
    wt.load(wb + t0 * wst, wst, n);
    vt.load(vb + t0 * vst, vst, n);
  };
  const auto pad = [](int j) { return padded<D>(j); };
  const auto flat = [](int j) { return j; };

  fetch(0);
  for (int t0 = 0; t0 < S; t0 += TT) {
    const int n = min(TT, S - t0);
    __syncthreads();  // us is staged / the previous chunk's readers are done
    rt.store(rs, PITCH, n, pad, false);
    kt.store(kbuf, PITCH, n, pad, false);
    wt.store(wbuf, PITCH, n, pad, true);
    vt.store(vs, COLS, n, flat, false);
    __syncthreads();
    // the next chunk's loads fly while this one is computed
    if (t0 + TT < S) fetch(t0 + TT);

    // bonus_t = r_t . (u * k_t), one warp per token
    for (int t = warp; t < n; t += NWARPS) {
      float a = 0.f;
      for (int j = lane; j < D; j += 32) {
        const int p = t * PITCH + padded<D>(j);
        a = fmaf(rs[p] * us[j], kbuf[p], a);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        a += __shfl_xor_sync(0xffffffffu, a, off);
      if (lane == 0) bonus[t] = a;
    }
    __syncthreads();

    const int slice = ks * (R + 4);
    int t = 0;
    // KS tokens at a time: their partial sums meet in one transposed
    // reduction over the KS lanes of the column, after which lane ks holds
    // token t + ks, so the shuffles of a group overlap the next group's FMAs
    for (; t + KS <= n; t += KS) {
      float p[KS];
#pragma unroll
      for (int q = 0; q < KS; ++q) {
        const int row = (t + q) * PITCH + slice;
        p[q] = token<R>(st, rs + row, kbuf + row, wbuf + row, vs[(t + q) * COLS + c]);
      }
      // lanes with bit 1 of ks keep tokens 2, 3 and send 0, 1; then bit 0
      const bool hi = ks & 2, odd = ks & 1;
      float a0 = hi ? p[2] : p[0], a1 = hi ? p[3] : p[1];
      a0 += __shfl_xor_sync(0xffffffffu, hi ? p[0] : p[2], 2);
      a1 += __shfl_xor_sync(0xffffffffu, hi ? p[1] : p[3], 2);
      float o = odd ? a1 : a0;
      o += __shfl_xor_sync(0xffffffffu, odd ? a0 : a1, 1);
      const int tq = t + ks;
      store_elem(ob + (t0 + tq) * ost, fmaf(bonus[tq], vs[tq * COLS + c], o));
    }
    for (; t < n; ++t) {
      const int row = t * PITCH + slice;
      const float vv = vs[t * COLS + c];
      float o = token<R>(st, rs + row, kbuf + row, wbuf + row, vv);
#pragma unroll
      for (int off = 1; off < KS; off <<= 1)
        o += __shfl_xor_sync(0xffffffffu, o, off);
      if (ks == 0) store_elem(ob + (t0 + t) * ost, fmaf(bonus[t], vv, o));
    }
  }

#pragma unroll
  for (int j = 0; j < R; ++j) s1[sbase + (long long)(ks * R + j) * D] = st[j];
}

template <typename T, int D>
int launch(const void* r, const void* k, const void* v, const float* logw,
           const float* u, const float* s0, void* out, float* s1, int B,
           int H, int S, const long long* st, cudaStream_t stream) {
  const dim3 grid(D / COLS, H, B);
  wkv6_fwd<T, D><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), logw, u, s0, static_cast<T*>(out), s1, H, S,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], st[12], st[13], st[14]);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const float* logw,
             const float* u, const float* s0, void* out, float* s1, int B,
             int H, int S, int D, const long long* st, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(r, k, v, logw, u, s0, out, s1, B, H, S, st, stream);
    case 64:
      return launch<T, 64>(r, k, v, logw, u, s0, out, s1, B, H, S, st, stream);
    case 128:
      return launch<T, 128>(r, k, v, logw, u, s0, out, s1, B, H, S, st, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// r/k/v/out: (B, H, S, D) in `dtype` (0 = float32, 1 = bfloat16); logw:
// (B, H, S, D) f32; each addressed through element strides (batch, head,
// position) with a contiguous last dim.  u: contiguous (H, D) f32; s0/s1:
// contiguous (B, H, D, D) f32, s1 may be s0.  Returns cudaGetLastError().
int wkv6_scan_fwd(const void* r, const void* k, const void* v,
                  const void* logw, const void* u, const void* s0, void* out,
                  void* s1, int B, int H, int S, int D, int dtype,
                  long long rsb, long long rsh, long long rst, long long ksb,
                  long long ksh, long long kst, long long vsb, long long vsh,
                  long long vst, long long wsb, long long wsh, long long wst,
                  long long osb, long long osh, long long ost, void* stream) {
  if (S < 1 || B < 1 || H < 1 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const long long st[15] = {rsb, rsh, rst, ksb, ksh, kst, vsb, vsh,
                            vst, wsb, wsh, wst, osb, osh, ost};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const float* lw = static_cast<const float*>(logw);
  const float* uu = static_cast<const float*>(u);
  const float* a = static_cast<const float*>(s0);
  float* z = static_cast<float*>(s1);
  switch (dtype) {
    case 0:
      return dispatch<float>(r, k, v, lw, uu, a, out, z, B, H, S, D, st, cs);
    case 1:
      return dispatch<__nv_bfloat16>(r, k, v, lw, uu, a, out, z, B, H, S, D, st, cs);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* wkv6_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
