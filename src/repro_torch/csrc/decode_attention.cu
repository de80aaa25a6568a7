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
// flops/byte balance point.  To reach the memory rate the kernel needs
// enough blocks in flight on all 132 SMs, loads that overlap the
// arithmetic, and arithmetic cheap enough not to become the limit itself.
//
// What the design does about it.  bf16 q over a bf16 cache (tc::): split-K.
// The grid is (splits, KV, B); block s covers positions [s*chunk,
// min((s+1)*chunk, len_b)) of one (kv head, sequence).  The host picks
// chunk from Smax and B*KV (ops.py :: plan_splits), never from the device
// lengths, so that even one sequence fills the card.  K and V tiles stay
// bf16 in shared memory (16-byte cp.async, a ring of three stages, rows
// XOR-swizzled for conflict-free ldmatrix); the G query rows of the group
// are padded to 16 in registers and Q K^T and P V run on mma.sync m16n8k16
// (bf16 in, f32 accumulate), so all G heads share each tile at tensor-core
// cost.  Each block writes its partial (m, l, O) in f32 to a scratch
// buffer, and a second kernel on the same stream merges the
// ceil(len_b/chunk) partials of each (b, kv head) by log-sum-exp; a block
// whose range starts at or past len_b has no partial to write and returns.
// A row of length 0 returns zeros.
//
// A sharded decode whose ranks each hold a block of a row's positions
// merges their outputs by log-sum-exp over the model ranks, so each call
// may also return every query's LSE: with a non-null lse pointer the merge
// writes O in f32 (not rounded to bf16) and (M + log2 L) ln 2 from the
// registers that hold M and L already, in the same launch (-inf for a row
// of length 0, whose O is zeros).
//
// f32 q (the f32 model checks, over an f32 or bf16 cache) and bf16 q over
// an f32 cache keep the first design (f32::), on the CUDA cores: one block
// per (kv head, sequence), tiles widened to f32 in shared memory, all G
// query heads sharing every tile; TF32 would miss the f32 checks' 2e-5.
// With an lse pointer it writes O in f32 and m + ln l.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// f32 q, or an f32 cache: the CUDA-core kernel
// ---------------------------------------------------------------------------

namespace f32 {
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

// TQ: the type of q; TC: the type of the caches (the engine keeps its
// cache in bf16 whatever the weights' type); TO: the type of out, q's, or
// f32 where lse is given (then lse[b, kv head, g] = m + ln l, natural-log
// units, -inf for a row of length 0).
template <typename TQ, typename TC, typename TO, int D>
__global__ void __launch_bounds__(NT)
decode_fwd(const TQ* __restrict__ q, const TC* __restrict__ kc,
           const TC* __restrict__ vc, const int* __restrict__ lengths,
           TO* __restrict__ o, float* __restrict__ lse, int KV, int G, int Smax, long long ksb,
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
      TO* orow = o + (((long long)b * KV + kvh) * G + g) * D;
      store_elem(orow + d0, acc[i][0] * inv);
      store_elem(orow + d0 + 1, acc[i][1] * inv);
    }
  }
  if (lse != nullptr && tid < G) {
    const float l = lrow[tid];
    lse[((long long)b * KV + kvh) * G + tid] = l > 0.f ? mrow[tid] + logf(l) : -INFINITY;
  }
}

template <typename TQ, typename TC, typename TO, int D>
int launch(const void* q, const void* kc, const void* vc, const int* lengths,
           void* o, float* lse, int B, int KV, int G, int Smax, long long ksb,
           long long ksh, long long kss, long long vsb, long long vsh,
           long long vss, cudaStream_t stream) {
  constexpr size_t smem = Tile<D>::smem_floats * sizeof(float);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(decode_fwd<TQ, TC, TO, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid(KV, B);
  const float scale = 1.f / sqrtf((float)D);
  decode_fwd<TQ, TC, TO, D><<<grid, NT, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(kc), static_cast<const TC*>(vc),
      lengths, static_cast<TO*>(o), lse, KV, G, Smax, ksb, ksh, kss, vsb, vsh, vss, scale);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TC, typename TO>
int dispatch(const void* q, const void* kc, const void* vc, const int* lengths,
             void* o, float* lse, int B, int KV, int G, int Smax, int D, long long ksb,
             long long ksh, long long kss, long long vsb, long long vsh,
             long long vss, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<TQ, TC, TO, 64>(q, kc, vc, lengths, o, lse, B, KV, G, Smax, ksb, ksh, kss, vsb, vsh, vss, stream);
    case 128:
      return launch<TQ, TC, TO, 128>(q, kc, vc, lengths, o, lse, B, KV, G, Smax, ksb, ksh, kss, vsb, vsh, vss, stream);
    case 256:
      return launch<TQ, TC, TO, 256>(q, kc, vc, lengths, o, lse, B, KV, G, Smax, ksb, ksh, kss, vsb, vsh, vss, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16 q over a bf16 cache: split-K on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TILE = 16 * WARPS;  // cache rows per tile: 16 per warp
constexpr int STAGES = 3;

template <int D>
struct Cfg {
  static constexpr int CHUNKS = D / 8;  // 16-byte chunks of a row
  static constexpr int TILE_BYTES = TILE * D * 2;
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;  // K then V
  static constexpr int RING = STAGES * STAGE_BYTES;
  // after the loop, the warps' (m, l, O) states of 16 rows, reusing the ring
  static constexpr int COMBINE = WARPS * 16 * (D + 2) * 4;
  static constexpr int SMEM = RING > COMBINE ? RING : COMBINE;
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

// Byte offset of 16-byte chunk c of row r in a tile: rows of D*2 bytes,
// chunk c stored at c ^ (r % 8), so that the 8 rows an ldmatrix reads at
// one column fall in 8 different bank groups.
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * (D * 2) + ((c ^ (r & 7)) << 4);
}

// Block (split, kv head, sequence): cache positions [split*chunk,
// min((split+1)*chunk, len)) of one (b, kv head), for the G query heads of
// the group.  K and V tiles of TILE rows stay bf16 in shared memory and
// arrive by 16-byte cp.async in a ring of STAGES, the next tiles' loads in
// flight while the current one is computed.  Each warp takes 16 rows of a
// tile: S = Q K^T on mma.sync m16n8k16 (the G query rows padded to 16 in
// registers, K by ldmatrix), the online softmax in registers, then
// O += P V (P from the S accumulators, V by ldmatrix.trans).  The four
// warps' states are merged in shared memory and the block writes its
// partial (m, l, O[G][D]) in f32, m in log2 units, O unnormalised.
template <int D>
__global__ void __launch_bounds__(THREADS)
decode_split(const bf16* __restrict__ q, const bf16* __restrict__ kc,
             const bf16* __restrict__ vc, const int* __restrict__ lengths,
             float* __restrict__ part_o, float* __restrict__ part_ml, int KV, int G,
             int Smax, int chunk, long long ksb, long long ksh, long long kss,
             long long vsb, long long vsh, long long vss, float scale_log2) {
  using C = Cfg<D>;
  constexpr int CH = C::CHUNKS;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t sbase = smem_u32(smem);

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = min(max(lengths[b], 0), Smax);
  const int lo = split * chunk;
  const int hi = min(lo + chunk, len);
  const long long part = ((long long)b * KV + kvh) * splits + split;

  if (lo >= hi) return;  // past the row's end: the merge reads no partial here

  const bf16* kb = kc + b * ksb + kvh * ksh;
  const bf16* vb = vc + b * vsb + kvh * vsh;
  const int n_tiles = (hi - lo + TILE - 1) / TILE;

  auto load_tile = [&](int t) {
    const int st = t % STAGES;
    const uint32_t sk = sbase + st * C::STAGE_BYTES, sv = sk + C::TILE_BYTES;
    const int p0 = lo + t * TILE;
    for (int i = threadIdx.x; i < TILE * CH; i += THREADS) {
      const int r = i / CH, c = i % CH;
      const bool valid = p0 + r < hi;
      const long long pos = valid ? p0 + r : lo;
      cp_async16(sk + swz<D>(r, c), kb + pos * kss + c * 8, valid);
      cp_async16(sv + swz<D>(r, c), vb + pos * vss + c * 8, valid);
    }
  };

  // query rows g = lane/4 and lane/4 + 8 (zero past G) as A fragments
  uint32_t qa[D / 16][4];
  {
    const bf16* qb = q + ((long long)b * KV + kvh) * G * D;
    const int g0 = lane / 4, g1 = g0 + 8;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int c = ks * 16 + (lane % 4) * 2;
      qa[ks][0] = g0 < G ? *reinterpret_cast<const uint32_t*>(qb + g0 * D + c) : 0u;
      qa[ks][1] = g1 < G ? *reinterpret_cast<const uint32_t*>(qb + g1 * D + c) : 0u;
      qa[ks][2] = g0 < G ? *reinterpret_cast<const uint32_t*>(qb + g0 * D + c + 8) : 0u;
      qa[ks][3] = g1 < G ? *reinterpret_cast<const uint32_t*>(qb + g1 * D + c + 8) : 0u;
    }
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles) load_tile(t);
    cp_async_commit();
  }

  const int mi = lane / 8, mr = lane % 8;  // ldmatrix: matrix, row of it
  for (int t = 0; t < n_tiles; ++t) {
    if (t + STAGES - 1 < n_tiles) load_tile(t + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();

    const uint32_t sk = sbase + (t % STAGES) * C::STAGE_BYTES, sv = sk + C::TILE_BYTES;
    const int wr = warp * 16;  // this warp's 16 rows of the tile
    // S (16 x 16): n-block 0 = rows wr..wr+7, n-block 1 = rows wr+8..wr+15
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t kf[4];  // {nb0 k-lo, nb0 k-hi, nb1 k-lo, nb1 k-hi}
      ldmatrix_x4(kf, sk + swz<D>(wr + (mi / 2) * 8 + mr, ks * 2 + (mi % 2)));
      mma_bf16(s[0], qa[ks], kf[0], kf[1]);
      mma_bf16(s[1], qa[ks], kf[2], kf[3]);
    }
    const int p0 = lo + t * TILE + wr;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = p0 + nb * 8 + (lane % 4) * 2 + (e & 1);
        s[nb][e] = pos < hi ? s[nb][e] : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
      }
    float corr[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * scale_log2);
      // a warp whose rows are all past the end keeps m = -inf
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      corr[r] = exp2f(m[r] - m_use[r]);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = exp2f(fmaf(s[nb][e], scale_log2, -m_use[e >> 1]));
        l[e >> 1] += s[nb][e];
      }
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      uint32_t vf[4];  // {n-block 2j: keys lo, keys hi; n-block 2j+1: lo, hi}
      ldmatrix_x4_trans(vf, sv + swz<D>(wr + (mi % 2) * 8 + mr, 2 * j + mi / 2));
      mma_bf16(acc[2 * j], pa, vf[0], vf[1]);
      mma_bf16(acc[2 * j + 1], pa, vf[2], vf[3]);
    }
    __syncthreads();  // the stage is reloaded STAGES-1 tiles from now
  }
  cp_async_wait<0>();

  // merge the four warps' states of rows g < G
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float* cm = reinterpret_cast<float*>(smem);  // (WARPS, 16) m, then l
  float* cl = cm + WARPS * 16;
  float* co = cl + WARPS * 16;  // (WARPS, 16, D)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int g = lane / 4 + 8 * r;
    if (g < G) {
      if (lane % 4 == 0) {
        cm[warp * 16 + g] = m[r];
        cl[warp * 16 + g] = l[r];
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = j * 8 + (lane % 4) * 2;
        *reinterpret_cast<float2*>(co + (warp * 16 + g) * D + col) =
            make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, cm[w * 16 + g]);
    float ll = 0.f, oo = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = exp2f(cm[w * 16 + g] - mm);  // mm is finite: lo < hi
      ll += cl[w * 16 + g] * c;
      oo += co[(w * 16 + g) * D + d] * c;
    }
    part_o[(part * G + g) * D + d] = oo;
    if (d == 0) {
      part_ml[(part * G + g) * 2] = mm;
      part_ml[(part * G + g) * 2 + 1] = ll;
    }
  }
}

// Block (query head g, kv head, sequence): the log-sum-exp merge of the
// ceil(len/chunk) partials the row has, written as D values in TO (bf16,
// or f32 where lse is given); a row of length 0 is zeros.  Warp 0 turns
// the partials' (m, l) into weights 2^(m_p - M) / L in shared memory, and
// where lse is given writes (M + log2 L) ln 2 (-inf for a row of length
// 0); then each thread sums its columns over the partials, several loads
// in flight at a time.
template <typename TO>
__global__ void __launch_bounds__(THREADS)
decode_merge(const float* __restrict__ part_o, const float* __restrict__ part_ml,
             const int* __restrict__ lengths, TO* __restrict__ o,
             float* __restrict__ lse, int KV, int G, int D, int Smax, int chunk,
             int splits) {
  extern __shared__ float wn[];  // (n,)
  const int g = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int len = min(max(lengths[b], 0), Smax);
  const int n = (len + chunk - 1) / chunk;
  const long long part0 = ((long long)b * KV + kvh) * splits;
  const float* ml = part_ml + (part0 * G + g) * 2;  // partial p at ml[2 * G * p]
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float mm = -INFINITY;
    for (int p = lane; p < n; p += 32) mm = fmaxf(mm, ml[2LL * G * p]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, off));
    float ll = 0.f;
    for (int p = lane; p < n; p += 32) {
      const float c = exp2f(ml[2LL * G * p] - mm);
      wn[p] = c;
      ll += c * ml[2LL * G * p + 1];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ll += __shfl_xor_sync(0xffffffffu, ll, off);
    const float inv = ll > 0.f ? 1.f / ll : 0.f;
    for (int p = lane; p < n; p += 32) wn[p] *= inv;
    if (lse != nullptr && lane == 0)
      lse[((long long)b * KV + kvh) * G + g] =
          ll > 0.f ? (mm + log2f(ll)) * 0.6931471805599453f : -INFINITY;
  }
  __syncthreads();
  TO* ob = o + (((long long)b * KV + kvh) * G + g) * D;
  const float* po = part_o + (part0 * G + g) * D;  // partial p at po[G * D * p]
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float oo = 0.f;
#pragma unroll 8
    for (int p = 0; p < n; ++p) oo = fmaf(wn[p], po[(long long)G * D * p + d], oo);
    f32::store_elem(ob + d, oo);
  }
}

template <int D>
int launch(const void* q, const void* kc, const void* vc, const int* lengths, void* o,
           float* lse, void* scratch, int B, int KV, int G, int Smax, int chunk, int splits,
           long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
           long long vss, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_split<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  float* part_o = static_cast<float*>(scratch);
  float* part_ml = part_o + (long long)B * KV * splits * G * D;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  decode_split<D><<<dim3(splits, KV, B), THREADS, Cfg<D>::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kc),
      static_cast<const bf16*>(vc), lengths, part_o, part_ml, KV, G, Smax, chunk, ksb, ksh,
      kss, vsb, vsh, vss, scale_log2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // one weight per split: within the default 48 KB up to 12288 splits
  const dim3 grid(G, KV, B);
  const size_t smem = splits * sizeof(float);
  if (lse != nullptr)
    decode_merge<float><<<grid, THREADS, smem, stream>>>(
        part_o, part_ml, lengths, static_cast<float*>(o), lse, KV, G, D, Smax, chunk, splits);
  else
    decode_merge<bf16><<<grid, THREADS, smem, stream>>>(
        part_o, part_ml, lengths, static_cast<bf16*>(o), nullptr, KV, G, D, Smax, chunk, splits);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* kc, const void* vc, const int* lengths, void* o,
             float* lse, void* scratch, int B, int KV, int G, int Smax, int D, int chunk, int splits,
             long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
             long long vss, cudaStream_t st) {
  if (chunk < TILE || chunk % TILE || splits < 1 || (long long)chunk * splits < Smax)
    return (int)cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return launch<64>(q, kc, vc, lengths, o, lse, scratch, B, KV, G, Smax, chunk, splits, ksb, ksh, kss, vsb, vsh, vss, st);
    case 128:
      return launch<128>(q, kc, vc, lengths, o, lse, scratch, B, KV, G, Smax, chunk, splits, ksb, ksh, kss, vsb, vsh, vss, st);
    case 256:
      return launch<256>(q, kc, vc, lengths, o, lse, scratch, B, KV, G, Smax, chunk, splits, ksb, ksh, kss, vsb, vsh, vss, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

extern "C" {

// q: contiguous (B, KV, G, D); caches: (B, KV, Smax, D) addressed through
// element strides (batch, head, position) with a contiguous last dim;
// lengths: (B,) int32 on the device; out: contiguous (B, KV, G, D) in q's
// type, or in f32 where lse is not null: then lse, contiguous (B, KV, G)
// f32, gets each query's log-sum-exp.  q_dtype / cache_dtype: 0 = float32,
// 1 = bfloat16.  With both bf16 the split-K kernels run: chunk and splits
// come from ops.py :: plan_splits, and scratch holds B*KV*splits*G*(D+2)
// floats.  Returns cudaGetLastError().
int decode_attention_fwd(const void* q, const void* kc, const void* vc,
                         const void* lengths, void* o, void* lse_out, void* scratch, int B,
                         int KV, int G, int Smax, int D, int q_dtype,
                         int cache_dtype, int chunk, int splits,
                         long long ksb, long long ksh, long long kss,
                         long long vsb, long long vsh, long long vss,
                         void* stream) {
  if (G < 1 || G > f32::MAX_G) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  float* lse = static_cast<float*>(lse_out);
  using bf16 = __nv_bfloat16;
  const int pick = q_dtype * 2 + cache_dtype;
  switch (pick) {
    case 0:
      return f32::dispatch<float, float, float>(q, kc, vc, lens, o, lse, B, KV, G, Smax, D, ksb, ksh, kss, vsb, vsh, vss, st);
    case 1:
      return f32::dispatch<float, bf16, float>(q, kc, vc, lens, o, lse, B, KV, G, Smax, D, ksb, ksh, kss, vsb, vsh, vss, st);
    case 2:
      if (lse != nullptr)
        return f32::dispatch<bf16, float, float>(q, kc, vc, lens, o, lse, B, KV, G, Smax, D, ksb, ksh, kss, vsb, vsh, vss, st);
      return f32::dispatch<bf16, float, bf16>(q, kc, vc, lens, o, lse, B, KV, G, Smax, D, ksb, ksh, kss, vsb, vsh, vss, st);
    case 3:
      return tc::dispatch(q, kc, vc, lens, o, lse, scratch, B, KV, G, Smax, D, chunk, splits, ksb, ksh, kss, vsb, vsh, vss, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
