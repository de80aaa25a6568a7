// GQA decode attention over a KV cache with per-sequence lengths, on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py ::
// decode_attention (body _decode_kernel), reached through ops.py ::
// decode_attention_op.  Unlike it, the lengths are a (B,) int32 tensor on
// the device (the engine's ragged batch), and G is not padded to 8.
//
// What bounds it on the H100: bytes.  One query token per sequence reads
// its whole valid cache, 2 * sum_b lengths_b * KV * D * 2 bytes per layer in
// bf16, for 4 * G flops per cache element: far below the card's ~295
// flops/byte balance point.
//
// What the design does about it, in this first version: one block per
// (kv head, sequence) streams that head's K/V rows once, in tiles staged in
// shared memory with 16-byte loads, and all G query heads of the group
// share every tile (the GQA reuse of the TPU kernel).  The loop covers only
// positions 0 .. lengths[b]-1, so a short sequence reads only its own
// prefix; a row of length 0 reads nothing and returns zeros.  Softmax
// statistics and the accumulator are f32.  Splitting long caches over
// several blocks (split-K), to fill all SMs at small batch, is a later step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 128;
constexpr int NWARPS = NT / 32;
constexpr int MAX_G = 16;

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
template <typename T, int D>
__device__ __forceinline__ void stage_rows(const T* base, long long row_stride,
                                           int rows, float* dst, int pitch,
                                           float mul) {
  constexpr int C = 16 / sizeof(T);
  constexpr int CPR = D / C;
  for (int i = threadIdx.x; i < rows * CPR; i += NT) {
    const int r = i / CPR;
    const int c = (i % CPR) * C;
    float v[C];
    load_chunk(base + r * row_stride + c, v);
    float* d = dst + r * pitch + c;
#pragma unroll
    for (int j = 0; j < C; j += 4)
      *reinterpret_cast<float4*>(d + j) =
          make_float4(v[j] * mul, v[j + 1] * mul, v[j + 2] * mul, v[j + 3] * mul);
  }
}

template <int D>
struct Tile {
  static constexpr int TT = 8192 / D;  // cache rows per tile: 128, 64, 32
  static constexpr int KP = D + 4;     // padded: conflict-free float4 reads
  static constexpr int VP = D;
  static constexpr int NRG = NT / (D / 2);        // row groups of threads
  static constexpr int MAXR = MAX_G / NRG;        // query rows per thread
  static constexpr size_t smem_floats =
      (size_t)MAX_G * D + (size_t)TT * KP + (size_t)TT * VP + (size_t)MAX_G * TT +
      3 * MAX_G;
};

// TQ: the type of q and out; TC: the type of the caches (the engine keeps
// its cache in bf16 whatever the weights' type).
template <typename TQ, typename TC, int D>
__global__ void __launch_bounds__(NT)
decode_fwd(const TQ* __restrict__ q, const TC* __restrict__ kc,
           const TC* __restrict__ vc, const int* __restrict__ lengths,
           TQ* __restrict__ o, int KV, int G, int Smax, long long ksb,
           long long ksh, long long kss, long long vsb, long long vsh,
           long long vss, float scale) {
  using TL = Tile<D>;
  constexpr int TT = TL::TT, KP = TL::KP, VP = TL::VP, NRG = TL::NRG,
                MAXR = TL::MAXR;

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // (G, D), pre-scaled
  float* ks = qs + MAX_G * D;                   // (TT, KP)
  float* vs = ks + TT * KP;                     // (TT, VP)
  float* ss = vs + TT * VP;                     // (G, TT) scores, then p
  float* mrow = ss + MAX_G * TT;
  float* lrow = mrow + MAX_G;
  float* crow = lrow + MAX_G;

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int len = min(max(lengths[b], 0), Smax);

  const TQ* qb = q + ((long long)b * KV + kvh) * G * D;
  const TC* kb = kc + b * ksb + kvh * ksh;
  const TC* vb = vc + b * vsb + kvh * vsh;
  stage_rows<TQ, D>(qb, D, G, qs, D, scale);
  if (tid < G) {
    mrow[tid] = -INFINITY;
    lrow[tid] = 0.f;
  }

  // this thread's output slice: columns d0, d0+1 of query rows rg + NRG*i
  const int d0 = 2 * (tid % (D / 2));
  const int rg = tid / (D / 2);
  float acc[MAXR][2];
#pragma unroll
  for (int i = 0; i < MAXR; ++i) acc[i][0] = acc[i][1] = 0.f;

  for (int t0 = 0; t0 < len; t0 += TT) {
    __syncthreads();  // q staged / the previous tile's readers are done
    const int n = min(TT, len - t0);
    stage_rows<TC, D>(kb + t0 * kss, kss, n, ks, KP, 1.f);
    stage_rows<TC, D>(vb + t0 * vss, vss, n, vs, VP, 1.f);
    __syncthreads();

    for (int idx = tid; idx < G * TT; idx += NT) {
      const int g = idx / TT, t = idx % TT;
      float sc = -INFINITY;
      if (t < n) {
        sc = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; d += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qs + g * D + d);
          const float4 kv = *reinterpret_cast<const float4*>(ks + t * KP + d);
          sc = fmaf(qv.x, kv.x, sc);
          sc = fmaf(qv.y, kv.y, sc);
          sc = fmaf(qv.z, kv.z, sc);
          sc = fmaf(qv.w, kv.w, sc);
        }
      }
      ss[g * TT + t] = sc;
    }
    __syncthreads();

    // online softmax, one warp per query head; every tile has n >= 1 valid
    // rows, so the new max is finite
    for (int g = warp; g < G; g += NWARPS) {
      float mx = -INFINITY;
      for (int t = lane; t < TT; t += 32) mx = fmaxf(mx, ss[g * TT + t]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = mrow[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < TT; t += 32) {
        const float p = expf(ss[g * TT + t] - m_new);
        ss[g * TT + t] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        crow[g] = c;
        lrow[g] = lrow[g] * c + sum;
        mrow[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < MAXR; ++i) {
      const int g = rg + NRG * i;
      if (g < G) {
        const float c = crow[g];
        acc[i][0] *= c;
        acc[i][1] *= c;
      }
    }
    for (int t = 0; t < n; ++t) {
      const float2 vv = *reinterpret_cast<const float2*>(vs + t * VP + d0);
#pragma unroll
      for (int i = 0; i < MAXR; ++i) {
        const int g = rg + NRG * i;
        if (g < G) {
          const float p = ss[g * TT + t];
          acc[i][0] = fmaf(p, vv.x, acc[i][0]);
          acc[i][1] = fmaf(p, vv.y, acc[i][1]);
        }
      }
    }
  }
  __syncthreads();  // lrow is final (also when len == 0)

#pragma unroll
  for (int i = 0; i < MAXR; ++i) {
    const int g = rg + NRG * i;
    if (g < G) {
      const float l = lrow[g];
      const float inv = l > 0.f ? 1.f / l : 0.f;
      TQ* orow = o + (((long long)b * KV + kvh) * G + g) * D;
      store_elem(orow + d0, acc[i][0] * inv);
      store_elem(orow + d0 + 1, acc[i][1] * inv);
    }
  }
}

template <typename TQ, typename TC, int D>
int launch(const void* q, const void* kc, const void* vc, const int* lengths,
           void* o, int B, int KV, int G, int Smax, long long ksb, long long ksh,
           long long kss, long long vsb, long long vsh, long long vss,
           cudaStream_t stream) {
  constexpr size_t smem = Tile<D>::smem_floats * sizeof(float);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(decode_fwd<TQ, TC, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid(KV, B);
  const float scale = 1.f / sqrtf((float)D);
  decode_fwd<TQ, TC, D><<<grid, NT, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(kc), static_cast<const TC*>(vc),
      lengths, static_cast<TQ*>(o), KV, G, Smax, ksb, ksh, kss, vsb, vsh, vss, scale);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TC>
int dispatch(const void* q, const void* kc, const void* vc, const int* lengths,
             void* o, int B, int KV, int G, int Smax, int D, long long ksb,
             long long ksh, long long kss, long long vsb, long long vsh,
             long long vss, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<TQ, TC, 64>(q, kc, vc, lengths, o, B, KV, G, Smax, ksb, ksh, kss, vsb, vsh, vss, stream);
    case 128:
      return launch<TQ, TC, 128>(q, kc, vc, lengths, o, B, KV, G, Smax, ksb, ksh, kss, vsb, vsh, vss, stream);
    case 256:
      return launch<TQ, TC, 256>(q, kc, vc, lengths, o, B, KV, G, Smax, ksb, ksh, kss, vsb, vsh, vss, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q: contiguous (B, KV, G, D); caches: (B, KV, Smax, D) addressed through
// element strides (batch, head, position) with a contiguous last dim;
// lengths: (B,) int32 on the device; out: contiguous (B, KV, G, D) in q's
// type.  q_dtype / cache_dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError().
int decode_attention_fwd(const void* q, const void* kc, const void* vc,
                         const void* lengths, void* o, int B, int KV, int G,
                         int Smax, int D, int q_dtype, int cache_dtype,
                         long long ksb, long long ksh, long long kss,
                         long long vsb, long long vsh, long long vss,
                         void* stream) {
  if (G < 1 || G > MAX_G) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  using bf16 = __nv_bfloat16;
  const int pick = q_dtype * 2 + cache_dtype;
  switch (pick) {
    case 0:
      return dispatch<float, float>(q, kc, vc, lens, o, B, KV, G, Smax, D, ksb, ksh, kss, vsb, vsh, vss, st);
    case 1:
      return dispatch<float, bf16>(q, kc, vc, lens, o, B, KV, G, Smax, D, ksb, ksh, kss, vsb, vsh, vss, st);
    case 2:
      return dispatch<bf16, float>(q, kc, vc, lens, o, B, KV, G, Smax, D, ksb, ksh, kss, vsb, vsh, vss, st);
    case 3:
      return dispatch<bf16, bf16>(q, kc, vc, lens, o, B, KV, G, Smax, D, ksb, ksh, kss, vsb, vsh, vss, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
