// Pieces shared by the teacher-forced recurrence kernels K3
// (teacher_fwd.cu) and K4 (teacher_bwd.cu): type helpers, block
// reductions and the per-row location-sensitive attention terms.  The
// backward recomputes the attention energies with the same functions the
// forward used, so both see the same tanh values bit for bit.
//
// Numerics follow the JAX package's XLA scan (decoder_bptt.py), not the
// Pallas kernel: only the LSTM product operands are rounded to the stream
// dtype (rnd<T>); the attention (query, location conv, loc_dense, tanh,
// energies, softmax, context) and all state are float32.  The Pallas
// kernel additionally rounds memory, pmem, the banded location matrix,
// tanh(.) before v and w before the context, because Mosaic wants bf16
// matrix-unit operands; Hopper's FFMA path has no such need.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace t2v {

constexpr int kAttThreads = 1024;  // threads of the per-row attention kernels
constexpr int kSplit = 4;          // K-split of the recurrence products (partial sums)

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// float -> stream dtype -> float (the XLA scan's `.astype(compute_dtype)`)
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}

__device__ __forceinline__ float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sum or max; every thread gets the result.  `red` holds 32 floats.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, u) : v + u;
  }
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : (kMax ? -3.402823466e38f : 0.0f);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float u = __shfl_xor_sync(0xffffffffu, v, o);
      v = kMax ? fmaxf(v, u) : v + u;
    }
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  v = red[0];
  __syncthreads();
  return v;
}

// 8 consecutive elements of T (16-byte aligned) as floats.
template <typename T> struct Vec8;
template <> struct Vec8<float> {
  __device__ __forceinline__ static void load(const float* p, float* o) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  }
};
template <> struct Vec8<__nv_bfloat16> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* o) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

// D += A . B on the tensor cores, one m16n8k16 tile of a warp: A (16 x 16,
// row-major) and B (16 x 8, column-major) in bf16, two per 32-bit register
// (lower index in the low half), D in float32.  Lane l holds A rows l/4 and
// l/4 + 8, k pairs 2(l%4) and 2(l%4) + 8; B column l/4, the same k pairs;
// D rows l/4 and l/4 + 8, columns 2(l%4) and 2(l%4) + 1.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One k16 step of a warp's 16 x 32 output tile: A rows [r0, r0 + 16) of
// `as` and B columns [0, 32) of `bs`, both bf16 with k contiguous and row
// strides lda / ldb (in bf16 elements), k offset k0.
__device__ __forceinline__ void warp_mma_16x32(float (&acc)[4][4], const __nv_bfloat16* as,
                                               int lda, int r0, const __nv_bfloat16* bs,
                                               int ldb, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
  auto word = [](const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); };
  const uint32_t a[4] = {word(as + (r0 + g) * lda + k0 + t2),
                         word(as + (r0 + g + 8) * lda + k0 + t2),
                         word(as + (r0 + g) * lda + k0 + t2 + 8),
                         word(as + (r0 + g + 8) * lda + k0 + t2 + 8)};
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const uint32_t b[2] = {word(bs + (nt * 8 + g) * ldb + k0 + t2),
                           word(bs + (nt * 8 + g) * ldb + k0 + t2 + 8)};
    mma_bf16(acc[nt], a, b);
  }
}

struct Dims {
  int T, B, S, E, H, P, A, F, K;
};

// Shared-memory layout of the attention kernels (floats).  The forward uses
// the first part; the backward appends its own buffers.
struct AttSmem {
  float *hs, *q, *part, *wpad, *e, *loc, *ldw, *lw, *red;
  int Lp;
  __device__ AttSmem(float* sm, const Dims& d) {
    Lp = d.S + d.K - 1;
    const int np = part_floats(d, blockDim.x);
    hs = sm;
    q = hs + d.H;
    part = q + d.A;
    wpad = part + np;
    e = wpad + 2 * Lp;
    loc = e + d.S;
    ldw = loc + d.S * d.F;
    lw = ldw + d.F * (d.A + 1);
    red = lw + d.K * 2 * d.F;
  }
  // the partial-sum buffer of the query and context products
  __host__ __device__ static int part_floats(const Dims& d, int threads) {
    const int np = d.A > threads ? d.A : threads;
    return np > d.E ? np : d.E;
  }
  __host__ __device__ static int floats(const Dims& d, int threads) {
    const int np = part_floats(d, threads);
    return d.H + d.A + np + 2 * (d.S + d.K - 1) + d.S + d.S * d.F + d.F * (d.A + 1) +
           d.K * 2 * d.F + 32;
  }
};

// Stage one row's attention inputs: h_att (H), the zero-padded
// [w_prev; w_cum] features, loc_dense_w (F, A; rows padded to A + 1 floats
// so that a warp reading one column across F rows hits distinct banks) and
// loc_w (K, 2, F).
__device__ __forceinline__ void att_stage(const AttSmem& s, const Dims& d, const float* h,
                                          const float* w_prev, const float* w_cum,
                                          const float* ldw, const float* locw) {
  const int pad = (d.K - 1) / 2;
  for (int i = threadIdx.x; i < d.H; i += blockDim.x) s.hs[i] = h[i];
  for (int i = threadIdx.x; i < s.Lp; i += blockDim.x) {
    const int p = i - pad;
    const bool in = p >= 0 && p < d.S;
    s.wpad[i] = in ? w_prev[p] : 0.0f;
    s.wpad[s.Lp + i] = in ? w_cum[p] : 0.0f;
  }
  for (int i = threadIdx.x; i < d.F * d.A; i += blockDim.x) s.ldw[i + i / d.A] = ldw[i];
  for (int i = threadIdx.x; i < d.K * 2 * d.F; i += blockDim.x) s.lw[i] = locw[i];
  __syncthreads();
}

// q = h_att . query_w (H, A), split over k when A < blockDim; then the
// location features loc[s][f] = sum_k,c feat_c[s + k - pad] * loc_w[k][c][f].
__device__ __forceinline__ void att_query_loc(const AttSmem& s, const Dims& d,
                                              const float* __restrict__ wq) {
  const int A = d.A, np = (int)blockDim.x >= A ? (int)blockDim.x / A : 1;
  for (int i = threadIdx.x; i < np * A; i += blockDim.x) {
    const int a = i % A, pp = i / A;
    float acc = 0.0f;
#pragma unroll 4
    for (int k = pp; k < d.H; k += np) acc = fmaf(s.hs[k], wq[(size_t)k * A + a], acc);
    s.part[i] = acc;
  }
  for (int i = threadIdx.x; i < d.S * d.F; i += blockDim.x) {
    const int p = i / d.F, f = i - p * d.F;
    float acc = 0.0f;
    for (int k = 0; k < d.K; ++k) {
      acc = fmaf(s.wpad[p + k], s.lw[(k * 2) * d.F + f], acc);
      acc = fmaf(s.wpad[s.Lp + p + k], s.lw[(k * 2 + 1) * d.F + f], acc);
    }
    s.loc[i] = acc;
  }
  __syncthreads();
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    float acc = 0.0f;
    for (int pp = 0; pp < np; ++pp) acc += s.part[pp * A + a];
    s.q[a] = acc;
  }
  __syncthreads();
}

// tanh(q[a] + loc[p] . loc_dense[:, a] + pmem[p][a]) for one (position, unit).
__device__ __forceinline__ float att_tanh(const AttSmem& s, const Dims& d,
                                          const float* __restrict__ pmem_row, int p, int a) {
  float l = 0.0f;
  for (int f = 0; f < d.F; ++f) l = fmaf(s.loc[p * d.F + f], s.ldw[f * (d.A + 1) + a], l);
  return tanhf(s.q[a] + l + pmem_row[(size_t)p * d.A + a]);
}

}  // namespace t2v
