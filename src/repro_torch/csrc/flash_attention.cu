// GQA flash attention for prefill on Hopper: causal, optionally
// sliding-window, or non-causal with its own key length (Sq != Sk).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py ::
// flash_attention (body _flash_kernel), reached through ops.py ::
// flash_attention_op; the non-causal mode is the kernel behind the
// reference's plain bidirectional_attention (src/repro/models/layers.py),
// which the encoders use.
//
// What bounds it on the H100: operations, at the prompt lengths the engine
// serves.  Causal QK^T plus PV costs 4*D flops per unmasked (query, key)
// pair, against (3+1)*B*S*H*D elements moved, so from S of a few hundred
// the arithmetic dominates, and only the tensor cores (989 TFLOP/s dense
// bf16, 15x the CUDA cores' f32 rate) come near the bound.
//
// What the design does about it.  bf16 (tc::flash_fwd_tc): one block per
// (query tile, head, batch) with one or two consumer warpgroups of 64 query
// rows and a producer: a warp, or with two consumer warpgroups a whole
// warpgroup whose registers setmaxnreg hands to the consumers, so that
// their f32 accumulators do not spill.  The producer loads the Q tile once
// and the K and V tiles by TMA (tensor maps built on the host, 128-byte
// swizzle) into a ring of stages guarded by full/empty mbarriers, so the
// next tiles' loads overlap the current tile's arithmetic.  S = Q K^T runs as
// wgmma m64n{BKV}k16 with both operands in shared memory; the mask and the
// online softmax run in registers in the accumulator's layout (row max and
// sum over the four lanes of a quad); P is rounded to bf16 in registers
// and is the A operand of O += P V (wgmma m64n{D}k16, V a transposed B
// operand).  m, l and O stay f32; O is stored in bf16.  The kv loop runs
// from the window's edge to the causal diagonal, so fully masked tiles
// cost nothing (the TPU kernel's block skipping; the loop replaces its
// sequential grid axis).  Ragged S: TMA reads rows past S as zeros, the
// mask drops them, and rows past S are not stored.  Query rows per block
// (128, or 64 where 128 would leave SMs idle) are chosen by S so that short
// prompts still spread over the card's SMs.  Given an lse pointer (the
// training forward; serving passes none), a block also stores each row's
// log-sum-exp, (m + log2 l) ln 2 with m in log2 units, from the registers that
// already hold m and l: the backward (flash_attention_bwd.cu) recomputes
// the probabilities from it.
//
// Non-causal (the encoders): every query tile walks all ceil(Sk / BKV) kv
// tiles, and only keys at or past Sk are masked.  Head dim 32 (the MiniLM
// reranker) keeps the 64-wide, 128B-swizzled boxes: the tensor maps say
// the rows are 32 wide, so TMA fills columns 32-63 of every box with
// zeros; S = Q K^T runs only the two k-steps of the real columns, O += P V
// runs at n = 64 and the zero columns 32-63 of O are not stored.
//
// f32 (f32::flash_fwd) keeps the first design, on the CUDA cores: the f32
// model checks hold it to 2e-5, which TF32 on the tensor cores would miss.
// Q, K and V tiles are staged in shared memory and each thread keeps a
// register tile of scores and a slice of the output accumulator.  Given an
// lse pointer (f32 training) it stores each row's log-sum-exp as the bf16
// path does, from the m and l the row's eight lanes already share.
#include <cuda.h>  // CUtensorMap types only: nothing here links libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Strides {
  long long b, h, s;
};

// ---------------------------------------------------------------------------
// f32: the CUDA-core kernel
// ---------------------------------------------------------------------------

namespace f32 {
constexpr int NT = 128;  // 16 row groups (ty) x 8 column lanes (tx)

__device__ __forceinline__ void load_chunk(const float* src, float* dst) {
  float4 u = *reinterpret_cast<const float4*>(src);
  dst[0] = u.x; dst[1] = u.y; dst[2] = u.z; dst[3] = u.w;
}

__device__ __forceinline__ void store_elem(float* p, float x) { *p = x; }

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

template <int D, int BQ, int BKV>
constexpr size_t smem_floats() {
  return (size_t)BQ * (D + 4) + (size_t)BKV * (D + 4) + (size_t)BKV * D +
         (size_t)BQ * (BKV + 1);
}

template <typename T, int D, int BQ, int BKV>
__global__ void __launch_bounds__(NT)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse, int Sq,
          int Sk, int G, int window, int causal, float scale, Strides qs_, Strides ks_,
          Strides vs_, Strides os_) {
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
  stage_tile<T, D>(qb, qs_.s, BQ, min(BQ, Sq - q_lo), qs, QP, scale);

  float m[RM], l[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;
  }

  // causal: from the window's edge to the diagonal; non-causal: all keys
  int kv_begin = 0;
  if (causal && window > 0) kv_begin = max(0, q_lo - window + 1) / BKV * BKV;
  const int kv_end = causal ? min(Sk, q_lo + BQ) : Sk;

  for (int kv_lo = kv_begin; kv_lo < kv_end; kv_lo += BKV) {
    __syncthreads();  // the previous tile's readers are done
    const int valid = min(BKV, Sk - kv_lo);
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
        const bool ok = kpos < Sk && (!causal || (kpos <= qpos &&
                                                  (window <= 0 || kpos > qpos - window)));
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
    if (qpos >= Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* orow = o + b * os_.b + h * os_.h + qpos * os_.s;
#pragma unroll
    for (int j = 0; j < DN; ++j) store_elem(orow + tx + 8 * j, acc[i][j] * inv);
    // the row's log-sum-exp for the backward, as the bf16 path writes it:
    // natural log (q was staged times scale, so m is in natural units),
    // +inf for a row with no key
    if (lse != nullptr && tx == 0)
      lse[((long long)b * gridDim.y + h) * Sq + qpos] =
          l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
  }
}

template <typename T, int D, int BQ, int BKV>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
           int H, int KV, int Sq, int Sk, int window, int causal, Strides qs, Strides ks,
           Strides vs, Strides os, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<D, BQ, BKV>() * sizeof(float);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd<T, D, BQ, BKV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  const float scale = 1.f / sqrtf((float)D);
  flash_fwd<T, D, BQ, BKV><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, Sq, Sk, H / KV, window, causal, scale, qs, ks, vs, os);
  return (int)cudaGetLastError();
}

// The tiles launched for head dim D: f(Tile<D, BQ, BKV>{}), or
// cudaErrorInvalidValue for a head dim the kernel does not take.
template <int D_, int BQ_>
struct Tile {
  static constexpr int D = D_, BQ = BQ_, BKV = 32;
};

template <typename F>
int with_tile(int D, F f) {
  switch (D) {
    case 32:
      return f(Tile<32, 64>{});
    case 64:
      return f(Tile<64, 64>{});
    case 128:
      return f(Tile<128, 64>{});
    case 256:
      return f(Tile<256, 32>{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
             int H, int KV, int Sq, int Sk, int D, int window, int causal, Strides qs,
             Strides ks, Strides vs, Strides os, cudaStream_t stream) {
  return with_tile(D, [&](auto tile) {
    using C = decltype(tile);
    return launch<T, C::D, C::BQ, C::BKV>(q, k, v, o, lse, B, H, KV, Sq, Sk, window,
                                          causal, qs, ks, vs, os, stream);
  });
}

// The plan of the tiles dispatch launches (see flash_attention_plan).
int plan(int D, int* out) {
  return with_tile(D, [&](auto tile) {
    using C = decltype(tile);
    out[0] = 0;  // no warpgroup: the CUDA cores
    out[1] = C::BQ;
    out[2] = C::BKV;
    out[3] = 1;  // one tile of K and V at a time
    out[4] = (int)(smem_floats<C::D, C::BQ, C::BKV>() * sizeof(float));
    return 0;
  });
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// D(64 x 128) (+)= A(64 x 16, smem) * B(128 x 16, smem)^T, both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
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


template <int BKV>
__device__ __forceinline__ void wgmma_s(float (&d)[BKV / 2], uint64_t da, uint64_t db,
                                        int scale_d);
template <>
__device__ __forceinline__ void wgmma_s<64>(float (&d)[32], uint64_t da, uint64_t db,
                                            int scale_d) {
  wgmma_ss_n64(d, da, db, scale_d);
}
template <>
__device__ __forceinline__ void wgmma_s<128>(float (&d)[64], uint64_t da, uint64_t db,
                                             int scale_d) {
  wgmma_ss_n128(d, da, db, scale_d);
}

template <int D>
__device__ __forceinline__ void wgmma_o(float (&d)[D / 2], const uint32_t (&a)[4],
                                        uint64_t db);
template <>
__device__ __forceinline__ void wgmma_o<64>(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db) {
  wgmma_rs_n64(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_o<128>(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n128(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_o<256>(float (&d)[128], const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n256(d, a, db);
}

// Tiles of one block: NWG consumer warpgroups of 64 query rows each, kv
// tiles of BKV rows in a ring of STAGES, every tile stored as DP/64 boxes of
// (rows x 64) bf16 = rows x 128 bytes, 128B-swizzled by TMA.  DP is the
// head dim padded to a whole box: 64 for D = 32, whose columns 32-63 TMA
// fills with zeros.
template <int D, int NWG, int BKV>
struct Cfg {
  static constexpr int DP = D < 64 ? 64 : D;
  static constexpr int DC = DP / 64;
  // with two consumer warpgroups the producer is a whole warpgroup, so that
  // setmaxnreg can hand its registers to the consumers (24 + 2 x 240 per
  // thread; 168 for all would spill the D=128 accumulators)
  static constexpr bool PRODUCER_WG = NWG == 2;
  static constexpr int ROWS = NWG * 64;  // query rows of the block
  static constexpr int THREADS = NWG * 128 + (PRODUCER_WG ? 128 : 32);
  static constexpr int Q_BOX = 64 * 128;          // bytes of one (64 x 64) box
  static constexpr int KV_BOX = BKV * 128;
  static constexpr int Q_BYTES = NWG * DC * Q_BOX;
  static constexpr int KV_TILE = DC * KV_BOX;  // one K (or V) tile
  static constexpr int BUDGET = 232448 - 1024 - 128;
  static constexpr int STAGES_FIT = (BUDGET - Q_BYTES) / (2 * KV_TILE);
  static constexpr int STAGES = STAGES_FIT > 3 ? 3 : STAGES_FIT;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_TILE;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_TILE;
  static constexpr int SMEM = BAR_OFF + 128 + 1024;  // + barriers, alignment slack
  static_assert(STAGES >= 2, "shared memory holds fewer than two stages");
};

// One block: query rows [q_lo, q_lo + NWG * 64) of head h, batch b.  Warp
// NWG*4 is the producer (with NWG = 2, warps 8-11 give
// up their registers to the consumers): its lane 0 loads Q once and
// K/V tiles by TMA into the ring, guarded by full (TMA bytes) and empty
// (consumer arrivals) barriers.  Each consumer warpgroup computes
// S = Q K^T (wgmma, both operands in shared memory), masks it and runs the
// online softmax in registers in the accumulator's layout, rounds P to bf16
// as the register A operand of O += P V (wgmma, V an MN-major B operand).
// Non-causal (causal = 0) runs every query row over all Sk keys.
template <int D, int NWG, int BKV>
__global__ void __launch_bounds__(Cfg<D, NWG, BKV>::THREADS, 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap tmq,
             const __grid_constant__ CUtensorMap tmk,
             const __grid_constant__ CUtensorMap tmv, bf16* __restrict__ o,
             float* __restrict__ lse, int Sq,
             int Sk, int G, int window, int causal, float scale_log2, long long osb,
             long long osh, long long oss) {
  using C = Cfg<D, NWG, BKV>;
  constexpr int DP = C::DP, DC = C::DC, STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sq = base, sk = base + C::K_OFF, sv = base + C::V_OFF;
  const uint32_t bar = base + C::BAR_OFF;  // q, kfull[], vfull[], empty[]
  const uint32_t qbar = bar;
  auto kfull = [&](int s) { return bar + 8 * (1 + s); };
  auto vfull = [&](int s) { return bar + 8 * (1 + STAGES + s); };
  auto empty = [&](int s) { return bar + 8 * (1 + 2 * STAGES + s); };

  // the longest query tiles first: causal work grows with the tile index
  // (non-causal tiles are all equal)
  const int q_lo = (gridDim.x - 1 - blockIdx.x) * C::ROWS;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // causal: from the window's edge to the diagonal; non-causal: all keys
  int kv_begin = 0;
  if (causal && window > 0) kv_begin = max(0, q_lo - window + 1) / BKV * BKV;
  const int kv_end = causal ? min(Sk, q_lo + C::ROWS) : Sk;
  const int n_tiles = (kv_end - kv_begin + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(kfull(s), 1);
      mbar_init(vfull(s), 1);
      mbar_init(empty(s), NWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= NWG * 4) {
    // ---- producer ----
    if constexpr (C::PRODUCER_WG) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == NWG * 4 && lane == 0) {
      mbar_expect_tx(qbar, C::Q_BYTES);
      for (int w = 0; w < NWG; ++w)
        for (int c = 0; c < DC; ++c)
          tma_load_4d(sq + (w * DC + c) * C::Q_BOX, &tmq, qbar, c * 64, q_lo + w * 64,
                      h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % STAGES;
        const uint32_t ph = (it / STAGES) & 1;
        if (it >= STAGES) mbar_wait(empty(st), ph ^ 1);
        const int kv_lo = kv_begin + it * BKV;
        mbar_expect_tx(kfull(st), C::KV_TILE);
        for (int c = 0; c < DC; ++c)
          tma_load_4d(sk + st * C::KV_TILE + c * C::KV_BOX, &tmk, kfull(st), c * 64,
                      kv_lo, kvh, b);
        mbar_expect_tx(vfull(st), C::KV_TILE);
        for (int c = 0; c < DC; ++c)
          tma_load_4d(sv + st * C::KV_TILE + c * C::KV_BOX, &tmv, vfull(st), c * 64,
                      kv_lo, kvh, b);
      }
    }
    return;
  }

  // ---- consumers ----
  if constexpr (C::PRODUCER_WG) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int wg = warp / 4;
  const int w4 = warp % 4;
  const int r0 = w4 * 16 + lane / 4;  // this thread's rows r0 and r0 + 8
  const int q0 = q_lo + wg * 64 + r0;
  const int wq_first = q_lo + wg * 64, wq_last = wq_first + 63;

  float acc[DP / 2];
#pragma unroll
  for (int j = 0; j < DP / 2; ++j) acc[j] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  mbar_wait(qbar, 0);
  const uint32_t sq_wg = sq + wg * DC * C::Q_BOX;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % STAGES;
    const uint32_t ph = (it / STAGES) & 1;
    const int kv_lo = kv_begin + it * BKV;
    // a tile past this warpgroup's diagonal, or wholly before its window
    const bool skip = causal && (kv_lo > wq_last ||
                                 (window > 0 && kv_lo + BKV - 1 <= wq_first - window));
    uint32_t p[BKV / 16][4];
    mbar_wait(kfull(st), ph);
    if (!skip) {
      float s[BKV / 2];
      wgmma_fence();
      // the real columns only: with D = 32 the box's columns 32-63 are zeros
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns = 32 bytes
        const uint64_t da = desc_sw128(sq_wg + (kk / 4) * C::Q_BOX + off, 16, 1024);
        const uint64_t db =
            desc_sw128(sk + st * C::KV_TILE + (kk / 4) * C::KV_BOX + off, 16, 1024);
        wgmma_s<BKV>(s, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);

      // causal: keys past a row's diagonal or before its window (keys past
      // Sk lie past every stored row's diagonal); non-causal: keys past Sk
      const bool need_mask =
          causal ? kv_lo + BKV - 1 > wq_first || (window > 0 && kv_lo <= wq_last - window)
                 : kv_lo + BKV > Sk;
      if (need_mask) {
#pragma unroll
        for (int j = 0; j < BKV / 2; ++j) {
          const int kpos = kv_lo + (j / 4) * 8 + (lane % 4) * 2 + (j & 1);
          const int qpos = q0 + 8 * ((j >> 1) & 1);
          const bool ok = causal ? kpos <= qpos && (window <= 0 || kpos > qpos - window)
                                 : kpos < Sk;
          s[j] = ok ? s[j] : -INFINITY;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BKV / 2; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
      float corr[2], m_use[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);
        // a row with no unmasked key yet keeps m = -inf; exponentiate
        // against 0 so that its probabilities and correction are 0
        m_use[r] = m_new == -INFINITY ? 0.f : m_new;
        corr[r] = exp2f(m[r] - m_use[r]);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int j = 0; j < BKV / 2; ++j) {
        const int r = (j >> 1) & 1;
        s[j] = exp2f(fmaf(s[j], scale_log2, -m_use[r]));
        l[r] += s[j];
      }
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
#pragma unroll
      for (int j = 0; j < DP / 2; ++j) acc[j] *= corr[(j >> 1) & 1];
    }
    mbar_wait(vfull(st), ph);
    if (!skip) {
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        // keys 16kk..16kk+15: two 8-row groups (SBO 1024 B); the DP columns
        // are DP/64 boxes of 64 (LBO = one box)
        const uint64_t db = desc_sw128(sv + st * C::KV_TILE + kk * 16 * 128, C::KV_BOX,
                                       1024);
        wgmma_o<DP>(acc, p[kk], db);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
    }
    mbar_arrive(empty(st));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv[2] = {l[0] > 0.f ? 1.f / l[0] : 0.f, l[1] > 0.f ? 1.f / l[1] : 0.f};
  // accumulators j < D / 2 hold columns < D: the padding columns are not stored
#pragma unroll
  for (int j = 0; j < D / 2; j += 2) {
    const int r = (j >> 1) & 1;
    const int row = wg * 64 + r0 + 8 * r;  // within the block
    const int qpos = q_lo + row;
    if (qpos < Sq) {
      const int col = (j / 4) * 8 + (lane % 4) * 2;
      bf16* dst = o + b * osb + h * osh + qpos * oss + col;
      *reinterpret_cast<uint32_t*>(dst) = pack_bf16(acc[j] * inv[r], acc[j + 1] * inv[r]);
    }
  }
  // each row's log-sum-exp of the scaled scores, natural log, for the
  // backward (training only; serving passes no lse): m is in log2 units
  if (lse != nullptr && lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = q_lo + wg * 64 + r0 + 8 * r;
      if (qpos < Sq)
        lse[((long long)b * gridDim.y + h) * Sq + qpos] =
            l[r] > 0.f ? (m[r] + log2f(l[r])) * 0.6931471805599453f : INFINITY;
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
// position) as a 4-d tensor map, boxes of (rows x 64), 128B swizzle; rows
// past S, and columns past D when D = 32, read as zeros.
bool encode(CUtensorMap* map, const void* ptr, int B, int heads, int S, int D,
            Strides st, int rows) {
  EncodeTiled fn = encoder();
  if (!fn) return false;
  // a dimension of size 1 is never stepped: any 16-byte multiple will do
  auto stride = [](long long s, int n) { return (cuuint64_t)(n > 1 ? s * 2 : 16); };
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {stride(st.s, S), stride(st.h, heads), stride(st.b, B)};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
            strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int NWG, int BKV>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
           int KV, int Sq, int Sk, int window, int causal, Strides qs, Strides ks,
           Strides vs, Strides os, cudaStream_t stream) {
  using C = Cfg<D, NWG, BKV>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_tc<D, NWG, BKV>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, B, H, Sq, D, qs, 64) || !encode(&tk, k, B, KV, Sk, D, ks, BKV) ||
      !encode(&tv, v, B, KV, Sk, D, vs, BKV))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Sq + C::ROWS - 1) / C::ROWS, H, B);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  flash_fwd_tc<D, NWG, BKV><<<grid, C::THREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), lse, Sq, Sk, H / KV, window, causal, scale_log2,
      os.b, os.h, os.s);
  return (int)cudaGetLastError();
}

int device_sms() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// Consumer warpgroups per block: two (128 query rows) while that still puts
// at least one block on each of the card's SMs, else one (64 rows).  D = 256
// holds its (64 x 256) f32 accumulator in one warpgroup only.
int pick_warpgroups(int B, int H, int S, int D, int sms) {
  return D <= 128 && (long long)B * H * ((S + 127) / 128) >= sms ? 2 : 1;
}

// The tiles launched for head dim D with nwg consumer warpgroups:
// f(Tile<D, NWG, BKV>{}), or cudaErrorInvalidValue for a head dim the
// kernel does not take.
template <int D_, int NWG_, int BKV_>
struct Tile {
  static constexpr int D = D_, NWG = NWG_, BKV = BKV_;
};

template <typename F>
int with_tile(int D, int nwg, F f) {
  const bool two = nwg == 2;
  switch (D) {
    case 32:
      return two ? f(Tile<32, 2, 128>{}) : f(Tile<32, 1, 128>{});
    case 64:
      return two ? f(Tile<64, 2, 128>{}) : f(Tile<64, 1, 128>{});
    case 128:
      return two ? f(Tile<128, 2, 128>{}) : f(Tile<128, 1, 128>{});
    case 256:
      return f(Tile<256, 1, 64>{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
             int H, int KV, int Sq, int Sk, int D, int window, int causal, Strides qs,
             Strides ks, Strides vs, Strides os, cudaStream_t st) {
  return with_tile(D, pick_warpgroups(B, H, Sq, D, device_sms()), [&](auto tile) {
    using T = decltype(tile);
    return launch<T::D, T::NWG, T::BKV>(q, k, v, o, lse, B, H, KV, Sq, Sk, window, causal,
                                        qs, ks, vs, os, st);
  });
}

// The plan of the tiles dispatch launches (see flash_attention_plan).
int plan(int B, int H, int Sq, int D, int* out) {
  return with_tile(D, pick_warpgroups(B, H, Sq, D, device_sms()), [&](auto tile) {
    using T = decltype(tile);
    using C = Cfg<T::D, T::NWG, T::BKV>;
    out[0] = T::NWG;
    out[1] = C::ROWS;
    out[2] = T::BKV;
    out[3] = C::STAGES;
    out[4] = C::SMEM;
    return 0;
  });
}

}  // namespace tc

}  // namespace

extern "C" {

// q: (B, H, Sq, D) and k/v: (B, KV, Sk, D) addressed through element
// strides (batch, head, position); the last dim is contiguous.  out has q's
// shape.  causal = 1 (Sq == Sk, optional window) or 0 (no mask, window 0).
// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).  lse, when
// not null, receives each row's log-sum-exp of the scaled, masked scores,
// natural log (+inf for a row with no key), as a contiguous (B, H, Sq) f32
// tensor; the backward (flash_attention_bwd.cu) recomputes the
// probabilities from it.
// Returns cudaGetLastError().
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                        int B, int H, int KV, int Sq, int Sk, int D, int window,
                        int causal, int dtype,
                        long long qsb, long long qsh, long long qss,
                        long long ksb, long long ksh, long long kss,
                        long long vsb, long long vsh, long long vss,
                        long long osb, long long osh, long long oss,
                        void* stream) {
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return f32::dispatch<float>(q, k, v, o, static_cast<float*>(lse), B, H, KV, Sq, Sk, D,
                                window, causal, qs, ks, vs, os, st);
  if (dtype == 1)
    return tc::dispatch(q, k, v, o, static_cast<float*>(lse), B, H, KV, Sq, Sk, D, window,
                        causal, qs, ks, vs, os, st);
  return (int)cudaErrorInvalidValue;
}

// The tiles flash_attention_fwd launches for (B, H, Sq, D, dtype) on the
// current device, from the same tables and warpgroup choice: out[0] consumer
// warpgroups (0 for the f32 CUDA-core kernel), out[1] query rows per block,
// out[2] kv rows per tile, out[3] stages of the kv ring, out[4] dynamic
// shared memory in bytes.  The grid is ceil(Sq / out[1]) x H x B blocks.
// Returns 0, or cudaErrorInvalidValue for a head dim or dtype the kernel
// does not take.
int flash_attention_plan(int B, int H, int Sq, int D, int dtype, int* out) {
  if (dtype == 0) return f32::plan(D, out);
  if (dtype == 1) return tc::plan(B, H, Sq, D, out);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
