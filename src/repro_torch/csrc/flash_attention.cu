// Causal, optionally sliding-window, GQA flash attention for prefill on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py ::
// flash_attention (body _flash_kernel), reached through ops.py ::
// flash_attention_op.
//
// What bounds it on the H100: operations, at the prompt lengths the engine
// serves.  Causal QK^T plus PV costs about 2*B*H*S^2*D multiply-adds
// (4*B*H*D flops per unmasked (query, key) pair), against (3+1)*B*S*H*D
// elements moved, so from S of a few hundred on the arithmetic dominates.
//
// What the design does about it, in this first version: one block per
// (q tile, head, batch) walks the kv tiles in a loop that starts at the
// window's edge and stops at the causal diagonal, so fully masked tiles
// cost nothing (the TPU kernel's block skipping; the loop replaces its
// sequential grid axis).  Q, K and V tiles are staged in shared memory as
// f32 and each thread keeps a 4x4 (or 2x4) register tile of scores and a
// RM x D/8 slice of the output accumulator, so every shared-memory load
// feeds several FMAs.  Softmax statistics (running max, sum) and the
// accumulator are f32.  The products run on the CUDA cores, not the tensor
// cores: wgmma, TMA and warp specialisation are the next step for speed.
// The kv head of query head h is h / G; any S >= 1 is taken, the ragged
// tail of q and kv being masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 128;  // 16 row groups (ty) x 8 column lanes (tx)

__device__ __forceinline__ void load_chunk(const float* src, float* dst) {
  float4 u = *reinterpret_cast<const float4*>(src);
  dst[0] = u.x; dst[1] = u.y; dst[2] = u.z; dst[3] = u.w;
}

__device__ __forceinline__ void load_chunk(const __nv_bfloat16* src, float* dst) {
  uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_elem(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_elem(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Copy `rows` rows of D elements (row r at base + r * row_stride) into
// shared memory `dst` (row pitch `pitch` floats) as f32 times `mul`.
// Rows at or past `valid` are written as zeros.
template <typename T, int D>
__device__ __forceinline__ void stage_tile(const T* base, long long row_stride,
                                           int rows, int valid, float* dst,
                                           int pitch, float mul) {
  constexpr int C = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int CPR = D / C;
  for (int i = threadIdx.x; i < rows * CPR; i += NT) {
    const int r = i / CPR;
    const int c = (i % CPR) * C;
    float v[C];
    if (r < valid) {
      load_chunk(base + r * row_stride + c, v);
#pragma unroll
      for (int j = 0; j < C; ++j) v[j] *= mul;
    } else {
#pragma unroll
      for (int j = 0; j < C; ++j) v[j] = 0.f;
    }
    float* d = dst + r * pitch + c;
#pragma unroll
    for (int j = 0; j < C; j += 4)
      *reinterpret_cast<float4*>(d + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  }
}

struct Strides {
  long long b, h, s;
};

template <int D, int BQ, int BKV>
constexpr size_t smem_floats() {
  return (size_t)BQ * (D + 4) + (size_t)BKV * (D + 4) + (size_t)BKV * D +
         (size_t)BQ * (BKV + 1);
}

template <typename T, int D, int BQ, int BKV>
__global__ void __launch_bounds__(NT)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int S, int G, int window,
          float scale, Strides qs_, Strides ks_, Strides vs_, Strides os_) {
  constexpr int RM = BQ / 16;  // query rows per thread
  constexpr int CN = BKV / 8;  // score columns per thread
  constexpr int DN = D / 8;    // output columns per thread
  constexpr int QP = D + 4;    // padded pitches: conflict-free float4 reads
  constexpr int KP = D + 4;
  constexpr int VP = D;
  constexpr int PP = BKV + 1;

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + BQ * QP;
  float* vs = ks + BKV * KP;
  float* ps = vs + BKV * VP;

  const int q_lo = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / G;
  const int ty = threadIdx.x >> 3;
  const int tx = threadIdx.x & 7;

  const T* qb = q + b * qs_.b + h * qs_.h + q_lo * qs_.s;
  const T* kb = k + b * ks_.b + kvh * ks_.h;
  const T* vb = v + b * vs_.b + kvh * vs_.h;
  stage_tile<T, D>(qb, qs_.s, BQ, min(BQ, S - q_lo), qs, QP, scale);

  float m[RM], l[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;
  }

  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q_lo - window + 1) / BKV * BKV;
  const int kv_end = min(S, q_lo + BQ);

  for (int kv_lo = kv_begin; kv_lo < kv_end; kv_lo += BKV) {
    __syncthreads();  // the previous tile's readers are done
    const int valid = min(BKV, S - kv_lo);
    stage_tile<T, D>(kb + kv_lo * ks_.s, ks_.s, BKV, valid, ks, KP, 1.f);
    stage_tile<T, D>(vb + kv_lo * vs_.s, vs_.s, BKV, valid, vs, VP, 1.f);
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;

#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[RM], kv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty * RM + i) * QP + d);
#pragma unroll
      for (int j = 0; j < CN; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 8 * j) * KP + d);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // Mask, then the online softmax.  The 8 lanes of one row group hold a
    // row's BKV scores between them; they are lanes tx = 0..7 of one warp.
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = ty * RM + i;
      const int qpos = q_lo + row;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kpos = kv_lo + tx + 8 * j;
        const bool ok = kpos < S && kpos <= qpos && (window <= 0 || kpos > qpos - window);
        s[i][j] = ok ? s[i][j] : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // A row with no unmasked key yet keeps m = -inf; exponentiate against
      // 0 so that its probabilities and correction are 0, never NaN.
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m[i] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = expf(s[i][j] - m_use);
        rs += p;
        ps[row * PP + tx + 8 * j] = p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DN; ++j) acc[i][j] *= corr;
    }
    __syncwarp();  // a row's probabilities were written by its own warp

    for (int t = 0; t < valid; ++t) {
      float pv[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) pv[i] = ps[(ty * RM + i) * PP + t];
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        const float vv = vs[t * VP + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qpos = q_lo + ty * RM + i;
    if (qpos >= S) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* orow = o + b * os_.b + h * os_.h + qpos * os_.s;
#pragma unroll
    for (int j = 0; j < DN; ++j) store_elem(orow + tx + 8 * j, acc[i][j] * inv);
  }
}

template <typename T, int D, int BQ, int BKV>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int KV, int S, int window, Strides qs, Strides ks, Strides vs,
           Strides os, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<D, BQ, BKV>() * sizeof(float);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd<T, D, BQ, BKV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  const float scale = 1.f / sqrtf((float)D);
  flash_fwd<T, D, BQ, BKV><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H / KV, window, scale, qs, ks, vs, os);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int H,
             int KV, int S, int D, int window, Strides qs, Strides ks,
             Strides vs, Strides os, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64, 64, 32>(q, k, v, o, B, H, KV, S, window, qs, ks, vs, os, stream);
    case 128:
      return launch<T, 128, 64, 32>(q, k, v, o, B, H, KV, S, window, qs, ks, vs, os, stream);
    case 256:
      return launch<T, 256, 32, 32>(q, k, v, o, B, H, KV, S, window, qs, ks, vs, os, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q: (B, H, S, D) and k/v: (B, KV, S, D) addressed through element strides
// (batch, head, position); the last dim is contiguous.  out has q's shape.
// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int KV, int S, int D, int window, int dtype,
                        long long qsb, long long qsh, long long qss,
                        long long ksb, long long ksh, long long kss,
                        long long vsb, long long vsh, long long vss,
                        long long osb, long long osh, long long oss,
                        void* stream) {
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, H, KV, S, D, window, qs, ks, vs, os, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, H, KV, S, D, window, qs, ks, vs, os, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
