// Autoregressive Tacotron2 decode loop for 1 <= B <= 8 rows (kernel K1).
//
// Replaces: tacotron2_vae_tpu/ops/pallas/decoder_loop.py::_kernel (B=1,
// via decode_loop) and ::_kernel_batched (1<B<=8, via decode_loop_batched).
// One set of kernels serves every B from 1 to 8 (B is a template argument).
//
// What bounds it on an H100: every decoder step streams the two fused LSTM
// weight matrices, (P+E+Ha) x 4Ha and (Ha+E+Hd) x 4Hd, plus the small
// query / location / projection weights: ~36.3 MB in bf16 (~72.6 MB in f32)
// per step at the full-width defaults, against 3.35 TB/s of HBM -> about
// 10.8 us (bf16) / 21.7 us (f32) per step.  The activations are a few KB.
// The TPU kernel pinned all weights in VMEM for the whole loop; one SM has
// 227 KB of shared memory, so that does not carry over.  In bf16 the two
// LSTM weights (35.7 MB) fit in the 50 MB L2, so steps after the first can
// run faster than the HBM bound.
//
// Design (per-step kernels, not a persistent kernel with a grid sync): six
// kernels per step, captured for `check_every` steps into one CUDA graph
// that the host replays on the caller's stream.
//   pre   prenet (2 x linear+ReLU+dropout 0.5): every block computes layer
//         1 for every row, then 64 outputs of layer 2
//   lstm  attention LSTM: two warps per hidden unit compute its 4 gate rows
//         for every batch row (GEMV over weights packed [4*j+g][k]), then
//         the fp32 cell update
//   att   one cluster of kNC CTAs per row (below): query, the 31-tap
//         location conv over [w_prev, w_cum], loc_dense, tanh(q+loc+pmem).v,
//         additive mask, softmax over S, context = w.memory, w_cum += w
//   lstm  decoder LSTM (same kernel)
//   proj  one warp per output column: fused mel+gate projection
//   fin   one block: writes the step's outputs for rows not yet finished,
//         updates finished[B], the step count and the all-done flag
// Every kernel reads the step index from the device (flags[1]) and returns
// at once when the all-done flag is set or max_steps is reached; the host
// reads the flag after every replay of the graph to stop launching.  Per-step
// kernels were chosen over a persistent kernel because each phase needs a
// different parallel layout (unit-parallel GEMV vs row-parallel attention)
// and a grid-wide barrier five times per step would need a cooperative
// launch; the price is 6 launches per step, which the graph replays with
// less launch overhead than one stream launch each.
//
// The attention step.  One block per row ran it as a chain on one SM: the
// whole query product (Wq, 128 x 1024, 256 KB in bf16, read by every row's
// block), then the location conv, loc_dense and energies for all S
// positions, the softmax and the context over all of E, eight barriers
// apart: ~25 us of a 59-75 us step, against ~0.1 us for its bytes (Wq, the
// row's memory and processed memory, ~0.34 MB at B=1, S=64, bf16) and its
// ~1.1 MFLOP.  Like every K1 kernel it is bound by latency, not by the
// card's rates: its time is the length of its chain of dependent phases,
// each a round trip to memory or a barrier.  Now a row runs on a cluster of
// kNC = 8 CTAs on neighbouring SMs, so each compute link of the chain is
// kNC times shorter, and the chain has fewer round trips:
//   - all of a CTA's independent loads are issued together at its start
//     (cp.async copies of h_att, loc_w, loc_dense_w, its processed memory,
//     its w_prev / w_cum window, mask and w_cum; its first memory vectors
//     for the context into registers);
//   - each CTA computes A / kNC rows of the query (Wq read once a row, not
//     once a block; every weight load of a warp in flight before its first
//     FMA) and the CTAs exchange them through distributed shared memory (no
//     separate query launch, which would cost another ~1 us graph node);
//   - each CTA owns a contiguous range of ceil(S / kNC) positions, with the
//     conv's halo, and computes the location features, loc_dense and
//     energies of that range only;
//   - the softmax takes one exchange through distributed shared memory:
//     each CTA's max m and sum of exp(e - m), the sums rescaled to the
//     row's max and added in rank order (no float atomics, so a run is
//     deterministic);
//   - the context is split over E: each CTA reads every weight from its
//     owner's exponentials and sums its E / kNC columns over all of S.
// Two cluster barriers and one split arrive/wait (so that no CTA exits
// while another still reads its shared memory) replace the block-wide
// chain.  kNC = 8 measured 0.4-2.5 us a step faster than 4 at S = 32 and
// 64, B = 1 and 4 (chip_smoke.py --k12 in turns; PERF.md).
//
// Numerics follow the TPU kernel's casting points: every activation is
// rounded to the weight dtype right before its product (prenet input and
// hidden, the LSTM inputs, h_att for the query, the location features
// before and after the conv, tanh(.) before v, the attention weights before
// the context product, [h_dec, ctx] before the projection); products
// accumulate in fp32, and all state (h, c, w_prev, w_cum, ctx) stays fp32.
// The mask is additive with finfo(float32).min, so a fully masked row is
// uniform, not NaN.  Prenet dropout draws its bits from a counter hash of
// (seed, step, layer, row, unit); ops/decoder_loop.py computes the same
// hash, so the plain twin reproduces the kernel's masks bit for bit.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = 8;          // warps per block in the GEMV kernels
constexpr int kThreads = 256;      // threads per block elsewhere
constexpr int kNC = 8;             // attention: CTAs per row (one cluster), S split kNC ways
constexpr int kCtxPre = 4;         // attention: context memory vectors a thread loads early
constexpr int kPreRows = 64;       // prenet layer-2 outputs per block
constexpr int kMaxF = 32;          // location filters held in registers
constexpr int kSplitK = 2;         // warps sharing one LSTM unit's dot products
constexpr int kPreThreads = 512;   // threads of the prenet kernel

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f<__half>(__half v) { return __half2float(v); }

// float -> weight dtype -> float (the TPU kernel's `.astype(io_dtype)`).
template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
template <> __device__ __forceinline__ float rnd<__half>(float v) {
  return __half2float(__float2half_rn(v));
}

__device__ __forceinline__ float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }

// The step this launch belongs to, read from the device-side step count
// (flags[1], advanced by fin_kernel at the end of every step), or -1 once
// every row has finished or max_steps steps have run.
__device__ __forceinline__ int step_of(const int* flags, int max_steps) {
  const int t = flags[1];
  return flags[0] || t >= max_steps ? -1 : t;
}

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352dU;
  x ^= x >> 15;
  x *= 0x846ca68bU;
  x ^= x >> 16;
  return x;
}

// Keep bit of prenet dropout: keep iff the hash is below 2^31 (rate 0.5).
__device__ __forceinline__ bool keep_bit(uint32_t seed, uint32_t step, uint32_t layer,
                                         uint32_t row, uint32_t unit) {
  uint32_t h = mix32(seed ^ 0x9e3779b9U);
  h = mix32(h ^ step);
  h = mix32(h ^ ((row * 2u + layer) * 65536u + unit));
  return h < 0x80000000u;
}

// Unpack one 16-byte vector of weights into floats (`load` from memory,
// `unpack` from a register copy).
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(uint4 v, float* out) {
    out[0] = __uint_as_float(v.x); out[1] = __uint_as_float(v.y);
    out[2] = __uint_as_float(v.z); out[3] = __uint_as_float(v.w);
  }
  __device__ __forceinline__ static void load(const float* p, float* out) {
    unpack(*reinterpret_cast<const uint4*>(p), out);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(uint4 v, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    unpack(*reinterpret_cast<const uint4*>(p), out);
  }
};
template <> struct Vec<__half> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(uint4 v, float* out) {
    const __half2* h = reinterpret_cast<const __half2*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __half22float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void load(const __half* p, float* out) {
    unpack(*reinterpret_cast<const uint4*>(p), out);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage x (B rows of K floats, row stride ldx, both multiples of 4) into
// shared memory as xs[b * K + k], rounded to T, then synchronise.  Each
// thread keeps 4 16-byte loads in flight before it stores, so a copy costs
// about one load round trip instead of one per loop iteration.
template <typename T, int B>
__device__ __forceinline__ void stage_rows(const float* x, int ldx, int K, float* xs) {
  const int K4 = K / 4, n = B * K4;
  for (int i0 = threadIdx.x; i0 < n; i0 += 4 * blockDim.x) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * blockDim.x, b = i / K4;
      if (i < n) v[u] = *reinterpret_cast<const float4*>(x + (size_t)b * ldx + 4 * (i - b * K4));
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n)
        *reinterpret_cast<float4*>(xs + 4 * i) =
            make_float4(rnd<T>(v[u].x), rnd<T>(v[u].y), rnd<T>(v[u].z), rnd<T>(v[u].w));
    }
  }
  __syncthreads();
}

// acc[r][b] = sum_k w[row0 + r][k] * xs[b][k] for R weight rows and B batch rows,
// one warp; every lane holds the full sums on return.  Each lane loads its
// V-wide slice of x once (16-byte shared loads) and reuses it for the R rows.
// Only columns [kb, ke) are summed (split-K); xs must be 16-byte aligned and
// K, kb, ke multiples of V.
template <typename T, int B, int R>
__device__ __forceinline__ void warp_gemv(const T* __restrict__ w, size_t row0, int K,
                                          const float* xs, float (&acc)[R][B], int kb = 0,
                                          int ke = -1) {
  constexpr int V = Vec<T>::N;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int b = 0; b < B; ++b) acc[r][b] = 0.0f;
  if (ke < 0) ke = K;
  for (int k0 = kb + lane * V; k0 < ke; k0 += 32 * V) {
    float xv[B][V];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const float4* p = reinterpret_cast<const float4*>(xs + b * K + k0);
#pragma unroll
      for (int q4 = 0; q4 < V / 4; ++q4) {
        const float4 x4 = p[q4];
        xv[b][4 * q4] = x4.x;
        xv[b][4 * q4 + 1] = x4.y;
        xv[b][4 * q4 + 2] = x4.z;
        xv[b][4 * q4 + 3] = x4.w;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float wv[V];
      Vec<T>::load(w + (row0 + r) * (size_t)K + k0, wv);
#pragma unroll
      for (int b = 0; b < B; ++b)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[r][b] = fmaf(wv[e], xv[b][e], acc[r][b]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int b = 0; b < B; ++b) acc[r][b] = warp_sum(acc[r][b]);
}

// ---------------------------------------------------------------- kernels

// Prenet for all B rows: every block computes layer 1 (small) for every row,
// then its kPreRows outputs of layer 2.  Weights in (out, in) layout, read
// by warps as in warp_gemv; each call covers R rows (16 at B=1 down to 2
// at B>4 for layer 1, at most 8 for layer 2) so a warp needs few load
// round trips.
template <typename T, int B>
__global__ void __launch_bounds__(kPreThreads) pre_kernel(const T* __restrict__ w1, const T* __restrict__ w2,
                           const float* __restrict__ prev, int ldprev, int n_in, int P,
                           float* __restrict__ xa, int lda, const int* __restrict__ flags,
                           int max_steps, uint32_t seed, int dropout_on) {
  constexpr int R1 = B <= 2 ? 16 : B <= 4 ? 8 : 4;  // R1 * B <= 32, divides P
  constexpr int R2 = R1 < 4 ? R1 : 4;
  const int t = step_of(flags, max_steps);
  if (t < 0) return;
  extern __shared__ float sm[];
  float* xin = sm;           // B * n_in
  float* h1 = sm + B * n_in; // B * P
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int i = threadIdx.x; i < B * n_in; i += blockDim.x) {
    const int b = i / n_in;
    xin[i] = t == 0 ? 0.0f : rnd<T>(prev[(size_t)b * ldprev + (i - b * n_in)]);
  }
  __syncthreads();
  for (int n0 = warp * R1; n0 < P; n0 += nw * R1) {
    float acc[R1][B];
    warp_gemv<T, B, R1>(w1, (size_t)n0, n_in, xin, acc);
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < R1; ++r)
#pragma unroll
        for (int b = 0; b < B; ++b) {
          float v = fmaxf(acc[r][b], 0.0f);
          if (dropout_on) v = keep_bit(seed, t, 0, b, n0 + r) ? v * 2.0f : 0.0f;
          h1[b * P + n0 + r] = rnd<T>(v);
        }
    }
  }
  __syncthreads();
  const int end = min(P, (int)(blockIdx.x + 1) * kPreRows);
  for (int n0 = blockIdx.x * kPreRows + warp * R2; n0 < end; n0 += nw * R2) {
    float acc[R2][B];
    warp_gemv<T, B, R2>(w2, (size_t)n0, P, h1, acc);
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < R2; ++r)
#pragma unroll
        for (int b = 0; b < B; ++b) {
          float v = fmaxf(acc[r][b], 0.0f);
          if (dropout_on) v = keep_bit(seed, t, 1, b, n0 + r) ? v * 2.0f : 0.0f;
          xa[(size_t)b * lda + n0 + r] = v;
        }
    }
  }
}

// One LSTM step: w is (4H, K) with row 4*j+g holding gate g of unit j
// (gate order i, f, g, o); bias is (4H) in gate-major order g*H+j.  Each
// unit's dot products are split over kSplitK warps of the block (halving
// each warp's chain of weight-load round trips); the partial sums meet in
// shared memory in a fixed order.
template <typename T, int B>
__global__ void lstm_kernel(const T* __restrict__ w, const float* __restrict__ bias,
                            const float* __restrict__ x, int ldx, int K, int H,
                            float* __restrict__ c, float* __restrict__ hout, int ldh,
                            const int* __restrict__ flags, int max_steps) {
  if (step_of(flags, max_steps) < 0) return;
  extern __shared__ float xs[];  // B * K
  __shared__ float part[kWarps][4][B];
  stage_rows<T, B>(x, ldx, K, xs);
  constexpr int V = Vec<T>::N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int unit = warp / kSplitK, ks = warp % kSplitK;
  const int j = blockIdx.x * (kWarps / kSplitK) + unit;
  const int kc = (K / kSplitK + V - 1) / V * V;
  const int kb = min(K, ks * kc), ke = min(K, kb + kc);
  if (j < H) {
    float acc[4][B];
    warp_gemv<T, B, 4>(w, (size_t)4 * j, K, xs, acc, kb, ke);
    if (lane == 0)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int b = 0; b < B; ++b) part[warp][r][b] = acc[r][b];
  }
  __syncthreads();
  if (j < H && ks == 0 && lane < B) {
    const int b = lane;
    float g[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      g[r] = bias[r * H + j];
      for (int k = 0; k < kSplitK; ++k) g[r] += part[warp + k][r][b];
    }
    const float cn = sigm(g[1]) * c[(size_t)b * H + j] + sigm(g[0]) * tanhf(g[2]);
    c[(size_t)b * H + j] = cn;
    hout[(size_t)b * ldh + j] = sigm(g[3]) * tanhf(cn);
  }
}

// Fused mel+gate projection: out[b][n] = w[n] . x[b] + bias[n].
template <typename T, int B>
__global__ void proj_kernel(const T* __restrict__ w, const float* __restrict__ bias,
                            const float* __restrict__ x, int ldx, int K, int N,
                            float* __restrict__ out, const int* __restrict__ flags,
                            int max_steps) {
  if (step_of(flags, max_steps) < 0) return;
  extern __shared__ float xs[];
  stage_rows<T, B>(x, ldx, K, xs);
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (n >= N) return;
  float acc[1][B];
  warp_gemv<T, B, 1>(w, (size_t)n, K, xs, acc);
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int b = 0; b < B; ++b)
    if (lane == b) out[(size_t)b * N + n] = acc[0][b] + bias[n];
}

struct AttDims {
  int S, E, Ha, Hd, P, A, F, KL;
  int lda, ldd, ldp;
};

__host__ __device__ inline int up4(int x) { return (x + 3) / 4 * 4; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// dst[0, bytes) = src[0, bytes) by 16-byte cp.async copies that do not wait
// for their data (both 16-byte aligned, bytes a multiple of 16); complete
// with cp_async_wait() and a barrier.
__device__ __forceinline__ void copy_async(void* dst, const void* src, int bytes) {
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(
                     static_cast<char*>(dst) + 16 * i)),
                 "l"(static_cast<const char*>(src) + 16 * i)
                 : "memory");
}
// dst[0] = *src (4 bytes), or 0 when !in (src is then not read).
__device__ __forceinline__ void copy_async4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// acc[r] = w[row0 + r] . rnd<T>(x) for R rows, one warp, x in shared memory
// as float; each lane sums its k in the order warp_gemv does, but issues the
// loads of NK weight vectors per row before its first FMA, so K <= 32 V NK
// costs one round trip to memory, not K / 32 V of them.
template <typename T, int R, int NK>
__device__ __forceinline__ void query_rows(const T* __restrict__ w, size_t row0, int K,
                                           const float* xs, float (&acc)[R]) {
  constexpr int V = Vec<T>::N;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0f;
  for (int kb = 0; kb < K; kb += 32 * V * NK) {
    uint4 raw[NK][R];
#pragma unroll
    for (int c = 0; c < NK; ++c) {
      const int k0 = kb + (c * 32 + lane) * V;
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (k0 < K) raw[c][r] = *reinterpret_cast<const uint4*>(w + (row0 + r) * (size_t)K + k0);
    }
#pragma unroll
    for (int c = 0; c < NK; ++c) {
      const int k0 = kb + (c * 32 + lane) * V;
      if (k0 >= K) break;
      float xv[V];
#pragma unroll
      for (int q4 = 0; q4 < V / 4; ++q4) {
        const float4 x4 = reinterpret_cast<const float4*>(xs + k0)[q4];
        xv[4 * q4] = rnd<T>(x4.x);
        xv[4 * q4 + 1] = rnd<T>(x4.y);
        xv[4 * q4 + 2] = rnd<T>(x4.z);
        xv[4 * q4 + 3] = rnd<T>(x4.w);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float wv[V];
        Vec<T>::unpack(raw[c][r], wv);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[r] = fmaf(wv[e], xv[e], acc[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = warp_sum(acc[r]);
}

// One attention CTA's share of a row, cluster rank `rank`: positions
// [s0, s0 + n) of S in chunks of Sc = ceil(S / kNC) (the last ones shorter
// or empty; Sc4 rounded up to 4); context columns [k0, k0 + ncol) of E in
// chunks of Ec (a multiple of the V-wide weight vector; the last ones
// shorter or empty); query rows [rank A / kNC, (rank + 1) A / kNC).  Lc is
// the length of the staged w_prev / w_cum window, rounded up to 4: the
// positions, the conv's halo of (KL - 1) / 2 on each side, and the sliding
// window's last read.
struct AttGeo {
  int Sc, Sc4, s0, n, Lc, Ec, k0, ncol;
  __host__ __device__ AttGeo(const AttDims& d, int V, int rank) {
    Sc = (d.S + kNC - 1) / kNC;
    Sc4 = up4(Sc);
    s0 = rank * Sc;
    n = d.S - s0 < Sc ? d.S - s0 : Sc;
    if (n < 0) n = 0;
    Lc = up4(Sc + d.KL + 1);
    Ec = (d.E + kNC * V - 1) / (kNC * V) * V;
    k0 = rank * Ec;
    ncol = d.E - k0 < Ec ? d.E - k0 : Ec;
    if (ncol < 0) ncol = 0;
  }
  // floats of shared memory, in the order the kernel lays them out (every
  // region a multiple of 4 floats, so each starts 16-byte aligned); tb is
  // sizeof(T), the arrays copied from memory as they are stored (pmem,
  // loc_w, loc_dense_w) take ... * tb / 4 floats
  __host__ __device__ static int floats(const AttDims& d, int V, int tb) {
    const AttGeo g(d, V, 0);
    const int cpart = kThreads * V > g.Ec ? kThreads * V : g.Ec;
    return g.Sc4 * d.F + g.Sc4 * d.A * tb / 4 + cpart + d.Ha + d.A + 2 * g.Lc + 3 * g.Sc4 +
           up4(d.S) + d.KL * 2 * d.F * tb / 4 + d.F * d.A * tb / 4 + g.Sc4 * (d.A / 32) + 4;
  }
};

// Location-sensitive attention of row blockIdx.y on a cluster of kNC CTAs
// (kThreads threads each).  Every CTA computes its A / kNC rows of the
// query and the CTAs exchange them through distributed shared memory; each
// then takes its own positions: location conv, loc_dense, tanh(.).v and the
// mask.  Each CTA's max and sum of exp(e - max) meet through distributed
// shared memory in one exchange (the sums rescaled to the row's max and
// added in rank order); every CTA reads all S exponentials from their
// owners, so it holds every weight for its E / kNC columns of the context.
// Thread mapping for the energies: a = tid % A (one attention unit, its
// loc_dense column held in registers), groups of A threads take positions
// in turn; a warp sums its 32 units' v.tanh(.) terms by shuffles.
template <typename T>
__global__ void __cluster_dims__(kNC, 1, 1) __launch_bounds__(kThreads, 1)
att_kernel(AttDims d, const T* __restrict__ wq, const T* __restrict__ locw,
           const T* __restrict__ ldw, const T* __restrict__ v, const T* __restrict__ pmem,
           const T* __restrict__ mem, const float* __restrict__ addmask,
           float* __restrict__ wprev, float* __restrict__ wcum, float* __restrict__ xa,
           float* __restrict__ xd, float* __restrict__ xp, const int* __restrict__ flags,
           int max_steps) {
  if (step_of(flags, max_steps) < 0) return;  // every CTA of the cluster alike
  extern __shared__ __align__(16) float sm[];
  constexpr int V = Vec<T>::N, TB = (int)sizeof(T);
  cg::cluster_group cl = cg::this_cluster();
  const int S = d.S, A = d.A, F = d.F, KL = d.KL, Ha = d.Ha, E = d.E;
  const int rank = (int)cl.block_rank(), b = blockIdx.y;
  const AttGeo geo(d, V, rank);
  const int pad = (KL - 1) / 2, Lc = geo.Lc, Aq = A / kNC, n = geo.n;
  const int WG = A / 32, G = blockDim.x / A;  // warps per group, groups
  float* locf = sm;                                         // Sc4 * F
  T* pms = reinterpret_cast<T*>(locf + geo.Sc4 * F);        // Sc4 * A of T
  float* cpart = locf + geo.Sc4 * F + geo.Sc4 * A * TB / 4; // max(kThreads * V, Ec)
  float* hs = cpart + (kThreads * V > geo.Ec ? kThreads * V : geo.Ec);  // Ha
  float* q = hs + Ha;                                       // A
  float* wpad = q + A;                                      // 2 * Lc (w_prev; w_cum)
  float* e = wpad + 2 * Lc;                                 // Sc4
  float* madd = e + geo.Sc4;                                // Sc4: this CTA's additive mask
  float* wc = madd + geo.Sc4;                               // Sc4: this CTA's w_cum
  float* wall = wc + geo.Sc4;                               // up4(S): every weight of the row
  T* lw = reinterpret_cast<T*>(wall + up4(S));              // KL * 2 * F of T
  T* ldws = lw + KL * 2 * F;                                // F * A of T
  float* epart = reinterpret_cast<float*>(ldws + F * A);    // Sc4 * WG
  float* slot = epart + geo.Sc4 * WG;                       // 4: this CTA's max and sum
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* hq = xd + (size_t)b * d.ldd;  // h_att of this step

  // Every load that waits on no other is in flight at once: the memory
  // vectors of this thread's first kCtxPre context positions into registers
  // (used after the softmax); h_att, loc_w, loc_dense_w, this CTA's
  // processed memory, its w_prev / w_cum window and its own mask and w_cum
  // as asynchronous copies (rounded or widened where they are read,
  // the window rounded in place by the thread that copied it).
  const int cgs = geo.ncol / V, ns = cgs > 0 ? max(1, (int)blockDim.x / cgs) : 1;
  const int cgi = tid % max(cgs, 1), ps = tid / max(cgs, 1);  // context column group, positions
  const bool ctx_thread = cgs > 0 && ps < ns;
  uint4 mpre[kCtxPre];
#pragma unroll
  for (int u = 0; u < kCtxPre; ++u) {
    const int s = ps + u * ns;
    if (ctx_thread && s < S)
      mpre[u] = *reinterpret_cast<const uint4*>(mem + ((size_t)b * S + s) * E + geo.k0 + cgi * V);
  }
  copy_async(hs, hq, Ha * 4);
  copy_async(lw, locw, KL * 2 * F * TB);
  copy_async(ldws, ldw, F * A * TB);
  copy_async(pms, pmem + ((size_t)b * S + geo.s0) * A, n * A * TB);
  for (int i = tid; i < Lc; i += blockDim.x) {
    const int s = geo.s0 - pad + i;
    const bool in = s >= 0 && s < S;
    copy_async4(wpad + i, wprev + (size_t)b * S + (in ? s : 0), in);
    copy_async4(wpad + Lc + i, wcum + (size_t)b * S + (in ? s : 0), in);
  }
  for (int p = tid; p < n; p += blockDim.x) {
    copy_async4(madd + p, addmask + (size_t)b * S + geo.s0 + p, true);
    copy_async4(wc + p, wcum + (size_t)b * S + geo.s0 + p, true);
  }
  cp_async_wait();
  for (int i = tid; i < Lc; i += blockDim.x) {
    wpad[i] = rnd<T>(wpad[i]);
    wpad[Lc + i] = rnd<T>(wpad[Lc + i]);
  }
  __syncthreads();

  // this CTA's rows of the query q = h_att . Wq^T, Wq (A, Ha): 4 rows a warp call
  for (int n0 = rank * Aq + warp * 4; n0 < (rank + 1) * Aq; n0 += (blockDim.x >> 5) * 4) {
    float acc[4];
    query_rows<T, 4, 4>(wq, (size_t)n0, Ha, hs, acc);
    if (lane == 0)
#pragma unroll
      for (int r = 0; r < 4; ++r) q[n0 + r] = acc[r];
  }
  const int a = tid % A, g = tid / A, wg = (tid % A) >> 5;
  float wl[kMaxF];
#pragma unroll
  for (int f = 0; f < kMaxF; ++f) wl[f] = f < F ? to_f(ldws[f * A + a]) : 0.0f;
  const float va = to_f(v[a]);
  // every CTA's query rows are written, and every CTA has staged its w_prev /
  // w_cum window, so the updates after the softmax cannot race a read of it
  cl.sync();
  for (int i = tid; i < A; i += blockDim.x)
    if (i / Aq != rank) q[i] = *cl.map_shared_rank(q + i, i / Aq);

  // location features of this CTA's positions, 2 consecutive positions per
  // thread with a sliding window over the taps, rounded to T (the TPU
  // kernel's acc.astype)
  for (int i = tid; i < (geo.Sc4 / 2) * F; i += blockDim.x) {
    const int sg = i / F, f = i - sg * F, p = sg * 2;  // p: local position
    float acc[2] = {0.0f, 0.0f};
    if (p < n) {
      float w0[2] = {wpad[p], wpad[p + 1]}, w1[2] = {wpad[Lc + p], wpad[Lc + p + 1]};
#pragma unroll 4
      for (int dk = 0; dk < KL; ++dk) {
        const float l0 = to_f(lw[(dk * 2) * F + f]), l1 = to_f(lw[(dk * 2 + 1) * F + f]);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          acc[j] = fmaf(w0[j], l0, acc[j]);
          acc[j] = fmaf(w1[j], l1, acc[j]);
        }
        w0[0] = w0[1];
        w1[0] = w1[1];
        w0[1] = wpad[p + dk + 2];
        w1[1] = wpad[Lc + p + dk + 2];
      }
    }
    locf[p * F + f] = rnd<T>(acc[0]);
    locf[(p + 1) * F + f] = rnd<T>(acc[1]);
  }
  __syncthreads();
  // energies, 4 positions per pass, so 4 independent shuffle reductions overlap
  for (int p0 = g; p0 < n; p0 += 4 * G) {
    float part[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int p = p0 + u * G;
      part[u] = 0.0f;
      if (p < n) {
        const float4* lf = reinterpret_cast<const float4*>(locf + p * F);
        float loc = 0.0f;
#pragma unroll
        for (int f4 = 0; f4 < kMaxF / 4; ++f4) {
          if (4 * f4 < F) {
            const float4 x4 = lf[f4];
            loc = fmaf(x4.x, wl[4 * f4], loc);
            loc = fmaf(x4.y, wl[4 * f4 + 1], loc);
            loc = fmaf(x4.z, wl[4 * f4 + 2], loc);
            loc = fmaf(x4.w, wl[4 * f4 + 3], loc);
          }
        }
        part[u] = va * rnd<T>(tanhf(q[a] + loc + to_f(pms[p * A + a])));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < 4; ++u) part[u] += __shfl_xor_sync(0xffffffffu, part[u], o);
    if (lane == 0)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (p0 + u * G < n) epart[(p0 + u * G) * WG + wg] = part[u];
  }
  __syncthreads();
  for (int p = tid; p < n; p += blockDim.x) {
    float sum = 0.0f;
    for (int w = 0; w < WG; ++w) sum += epart[p * WG + w];
    e[p] = sum + madd[p];
  }
  __syncthreads();

  // softmax over the row: this CTA's max m and sum of exp(e - m) (warp 0),
  // exchanged once; the row's max M, and the sums rescaled by exp(m - M)
  // and added in rank order
  if (warp == 0) {
    float m = -3.402823466e38f;
    for (int p = lane; p < n; p += 32) m = fmaxf(m, e[p]);
    m = warp_max(m);
    float sum = 0.0f;
    for (int p = lane; p < n; p += 32) {
      const float ex = expf(e[p] - m);
      e[p] = ex;
      sum += ex;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      slot[0] = m;
      slot[1] = sum;
    }
  }
  cl.sync();
  float mx = -3.402823466e38f, scale[kNC], tot = 0.0f;
#pragma unroll
  for (int r = 0; r < kNC; ++r) mx = fmaxf(mx, *cl.map_shared_rank(slot, r));
#pragma unroll
  for (int r = 0; r < kNC; ++r) {
    scale[r] = expf(*cl.map_shared_rank(slot, r) - mx);
    tot += *cl.map_shared_rank(slot + 1, r) * scale[r];
  }
  // every weight of the row from its owner's exponentials; this CTA's own
  // positions also update w_prev and w_cum
  for (int s = tid; s < S; s += blockDim.x) {
    const int r = s / geo.Sc;
    float sc = scale[0];
#pragma unroll
    for (int k = 1; k < kNC; ++k) sc = r == k ? scale[k] : sc;
    const float w = *cl.map_shared_rank(e + (s - r * geo.Sc), r) * sc / tot;
    wall[s] = rnd<T>(w);
    if (r == rank) {
      wprev[(size_t)b * S + s] = w;
      wcum[(size_t)b * S + s] = wc[s - geo.s0] + w;
    }
  }
  // done reading the other CTAs' shared memory; none of them may exit
  // before every CTA has arrived here (the wait below)
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  __syncthreads();

  // context = w . memory over this CTA's columns: column group cgi of V
  // columns, positions ps, ps + ns, .. (partials added in order below)
  float* xa_row = xa + (size_t)b * d.lda;
  if (geo.ncol > 0) {
    if (ctx_thread) {
      float acc[V];
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = 0.0f;
#pragma unroll
      for (int u = 0; u < kCtxPre; ++u) {
        const int s = ps + u * ns;
        if (s < S) {
          float mv[V];
          Vec<T>::unpack(mpre[u], mv);
          const float ws = wall[s];
#pragma unroll
          for (int j = 0; j < V; ++j) acc[j] = fmaf(ws, mv[j], acc[j]);
        }
      }
#pragma unroll 4
      for (int s = ps + kCtxPre * ns; s < S; s += ns) {
        float mv[V];
        Vec<T>::load(mem + ((size_t)b * S + s) * E + geo.k0 + cgi * V, mv);
        const float ws = wall[s];
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] = fmaf(ws, mv[j], acc[j]);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) cpart[ps * geo.ncol + cgi * V + j] = acc[j];
    }
    __syncthreads();
    for (int c = tid; c < geo.ncol; c += blockDim.x) {
      float acc = 0.0f;
      for (int j = 0; j < ns; ++j) acc += cpart[j * geo.ncol + c];
      const int k = geo.k0 + c;
      xa_row[d.P + k] = acc;
      xd[(size_t)b * d.ldd + Ha + k] = acc;
      xp[(size_t)b * d.ldp + d.Hd + k] = acc;
    }
  }
  // h_att into the attention LSTM's next input, this CTA's slice of it
  const int hc = (Ha + kNC - 1) / kNC, h1 = min(Ha, (rank + 1) * hc);
  for (int k = rank * hc + tid; k < h1; k += blockDim.x) xa_row[d.P + E + k] = hq[k];
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Step epilogue, one block: outputs of active rows, finished flags, step count.
__global__ void fin_kernel(int B, int S, int n_out, int N, int Ha, int E, int Hd,
                           const float* __restrict__ out_t, const float* __restrict__ wprev,
                           const float* __restrict__ xp, int ldp, float* __restrict__ xd,
                           int ldd, int* __restrict__ flags, float* __restrict__ mel_out,
                           float* __restrict__ gate_out, float* __restrict__ align_out,
                           int max_steps, float thr) {
  const int t = step_of(flags, max_steps);
  if (t < 0) return;
  __shared__ int active[8];
  int* finished = flags + 2;
  if (threadIdx.x < B) active[threadIdx.x] = !finished[threadIdx.x];
  __syncthreads();
  for (int i = threadIdx.x; i < B * n_out; i += blockDim.x) {
    const int b = i / n_out, k = i - b * n_out;
    if (active[b]) mel_out[((size_t)t * B + b) * n_out + k] = out_t[(size_t)b * N + k];
  }
  for (int i = threadIdx.x; i < B * S; i += blockDim.x) {
    const int b = i / S;
    if (active[b]) align_out[(size_t)t * B * S + i] = wprev[i];
  }
  if (threadIdx.x < B && active[threadIdx.x])
    gate_out[(size_t)t * B + threadIdx.x] = out_t[(size_t)threadIdx.x * N + n_out];
  for (int i = threadIdx.x; i < B * Hd; i += blockDim.x) {
    const int b = i / Hd, k = i - b * Hd;
    xd[(size_t)b * ldd + Ha + E + k] = xp[(size_t)b * ldp + k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int all = 1;
    for (int b = 0; b < B; ++b) {
      const int f = finished[b] | (sigm(out_t[(size_t)b * N + n_out]) > thr);
      finished[b] = f;
      all &= f;
    }
    flags[1] = t + 1;
    flags[0] = all;
  }
}

struct Args {
  int B, S, E, Ha, Hd, P, A, F, KL, n_out;
  const void *w1, *w2, *att_w, *dec_w, *wq, *locw, *ldw, *v, *pg_w, *mem, *pmem;
  const float *att_b, *dec_b, *pg_b, *addmask;
  float *xa, *xd, *xp, *c_att, *c_dec, *wprev, *wcum, *out_t;
  int* flags;
  float *mel_out, *gate_out, *align_out;
  int max_steps, dropout_on, check_every;
  float thr;
  uint32_t seed;
  cudaStream_t stream;
};

cudaError_t smem_attr(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int B>
cudaError_t run(const Args& a) {
  const int N = a.n_out + 1;
  const int Ka = a.P + a.E + a.Ha, Kd = a.Ha + a.E + a.Hd, Kp = a.Hd + a.E;
  const AttDims d{a.S, a.E, a.Ha, a.Hd, a.P, a.A, a.F, a.KL, Ka, Kd, Kp};
  const size_t sm_pre = (size_t)B * (a.n_out + a.P) * sizeof(float);
  const size_t sm_la = (size_t)B * Ka * sizeof(float);
  const size_t sm_ld = (size_t)B * Kd * sizeof(float);
  const size_t sm_pj = (size_t)B * Kp * sizeof(float);
  const size_t sm_att = (size_t)AttGeo::floats(d, Vec<T>::N, sizeof(T)) * sizeof(float);
  cudaError_t err;
  if ((err = smem_attr((const void*)pre_kernel<T, B>, sm_pre)) != cudaSuccess) return err;
  if ((err = smem_attr((const void*)lstm_kernel<T, B>, sm_la > sm_ld ? sm_la : sm_ld)) != cudaSuccess)
    return err;
  if ((err = smem_attr((const void*)proj_kernel<T, B>, sm_pj)) != cudaSuccess) return err;
  if ((err = smem_attr((const void*)att_kernel<T>, sm_att)) != cudaSuccess) return err;

  const T* w1 = static_cast<const T*>(a.w1);
  const T* w2 = static_cast<const T*>(a.w2);
  const T* att_w = static_cast<const T*>(a.att_w);
  const T* dec_w = static_cast<const T*>(a.dec_w);
  const T* pg_w = static_cast<const T*>(a.pg_w);
  const int gemv_threads = 32 * kWarps;
  constexpr int kUnits = kWarps / kSplitK;  // LSTM units per block
  auto enqueue_step = [&](cudaStream_t s) {
    pre_kernel<T, B><<<(a.P + kPreRows - 1) / kPreRows, kPreThreads, sm_pre, s>>>(
        w1, w2, a.out_t, N, a.n_out, a.P, a.xa, Ka, a.flags, a.max_steps, a.seed,
        a.dropout_on);
    lstm_kernel<T, B><<<(a.Ha + kUnits - 1) / kUnits, gemv_threads, sm_la, s>>>(
        att_w, a.att_b, a.xa, Ka, Ka, a.Ha, a.c_att, a.xd, Kd, a.flags, a.max_steps);
    att_kernel<T><<<dim3(kNC, B), kThreads, sm_att, s>>>(
        d, static_cast<const T*>(a.wq), static_cast<const T*>(a.locw),
        static_cast<const T*>(a.ldw), static_cast<const T*>(a.v),
        static_cast<const T*>(a.pmem), static_cast<const T*>(a.mem), a.addmask, a.wprev,
        a.wcum, a.xa, a.xd, a.xp, a.flags, a.max_steps);
    lstm_kernel<T, B><<<(a.Hd + kUnits - 1) / kUnits, gemv_threads, sm_ld, s>>>(
        dec_w, a.dec_b, a.xd, Kd, Kd, a.Hd, a.c_dec, a.xp, Kp, a.flags, a.max_steps);
    proj_kernel<T, B><<<(N + kWarps - 1) / kWarps, gemv_threads, sm_pj, s>>>(
        pg_w, a.pg_b, a.xp, Kp, Kp, N, a.out_t, a.flags, a.max_steps);
    fin_kernel<<<1, kThreads, 0, s>>>(B, a.S, a.n_out, N, a.Ha, a.E, a.Hd, a.out_t, a.wprev,
                                      a.xp, Kp, a.xd, Kd, a.flags, a.mel_out, a.gate_out,
                                      a.align_out, a.max_steps, a.thr);
  };

  // Capture k steps (6 launches each) into a CUDA graph once, then replay it
  // on the caller's stream until every row has finished or max_steps steps
  // have run; the kernels take the step from flags[1] and return at once
  // past the end.  Capture needs a stream of its own (the caller's may be
  // the legacy default stream, which cannot be captured).
  const int k = a.check_every > 0 && a.check_every < a.max_steps ? a.check_every : a.max_steps;
  cudaStream_t cs = nullptr;
  cudaGraph_t graph = nullptr;
  cudaGraphExec_t exec = nullptr;
  if ((err = cudaStreamCreateWithFlags(&cs, cudaStreamNonBlocking)) != cudaSuccess) return err;
  if ((err = cudaStreamBeginCapture(cs, cudaStreamCaptureModeThreadLocal)) == cudaSuccess) {
    for (int i = 0; i < k; ++i) enqueue_step(cs);
    const cudaError_t launch_err = cudaGetLastError();
    err = cudaStreamEndCapture(cs, &graph);
    if (err == cudaSuccess) err = launch_err;
  }
  if (err == cudaSuccess) err = cudaGraphInstantiate(&exec, graph, 0);
  for (int t = 0; err == cudaSuccess && t < a.max_steps; t += k) {
    if ((err = cudaGraphLaunch(exec, a.stream)) != cudaSuccess || t + k >= a.max_steps) break;
    int done = 0;
    err = cudaMemcpyAsync(&done, a.flags, sizeof(int), cudaMemcpyDeviceToHost, a.stream);
    if (err == cudaSuccess) err = cudaStreamSynchronize(a.stream);
    if (done) break;
  }
  // an executable graph still in flight is freed when its launch completes
  if (exec) cudaGraphExecDestroy(exec);
  if (graph) cudaGraphDestroy(graph);
  cudaStreamDestroy(cs);
  return err;
}

template <typename T>
cudaError_t run_b(const Args& a) {
  switch (a.B) {
    case 1: return run<T, 1>(a);
    case 2: return run<T, 2>(a);
    case 3: return run<T, 3>(a);
    case 4: return run<T, 4>(a);
    case 5: return run<T, 5>(a);
    case 6: return run<T, 6>(a);
    case 7: return run<T, 7>(a);
    case 8: return run<T, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 weights, 1 = bfloat16, 2 = float16 (ops/decoder_loop.py
// DTYPES); any other value returns cudaErrorInvalidValue.  Shapes (row-major):
//   w1 (P, n_out), w2 (P, P); att_w (4Ha, P+E+Ha), att_b (4Ha);
//   dec_w (4Hd, Ha+E+Hd), dec_b (4Hd); wq (A, Ha); locw (KL, 2, F);
//   ldw (F, A); v (A); pg_w (n_out+1, Hd+E), pg_b (n_out+1);
//   mem (B, S, E), pmem (B, S, A) in the weight dtype; addmask (B, S) f32.
// Work buffers (f32, zeroed by the caller): xa (B, P+E+Ha), xd (B, Ha+E+Hd),
//   xp (B, Hd+E), c_att (B, Ha), c_dec (B, Hd), wprev, wcum (B, S),
//   out_t (B, n_out+1); flags int32 (2+B) zeroed: [all_done, steps, finished..].
// Outputs (f32, zeroed by the caller): mel_out (max_steps, B, n_out),
//   gate_out (max_steps, B), align_out (max_steps, B, S).
// Returns a cudaError_t (0 on success).
extern "C" int t2v_decode_loop(
    int dtype, int B, int S, int E, int Ha, int Hd, int P, int A, int F, int KL, int n_out,
    const void* w1, const void* w2, const void* att_w, const float* att_b,
    const void* dec_w, const float* dec_b, const void* wq, const void* locw,
    const void* ldw, const void* v, const void* pg_w, const float* pg_b,
    const void* mem, const void* pmem, const float* addmask,
    float* xa, float* xd, float* xp, float* c_att, float* c_dec, float* wprev, float* wcum,
    float* out_t, int* flags, float* mel_out, float* gate_out, float* align_out,
    int max_steps, float thr, unsigned int seed, int dropout_on, int check_every,
    void* stream) {
  if (B < 1 || B > 8 || A % 32 != 0 || A % (4 * kNC) != 0 || kThreads % A != 0 ||
      F > kMaxF || F % 4 != 0 || P % 16 != 0 || E > 4 * kNC * kThreads)
    return (int)cudaErrorInvalidValue;
  Args a{B, S, E, Ha, Hd, P, A, F, KL, n_out,
         w1, w2, att_w, dec_w, wq, locw, ldw, v, pg_w, mem, pmem,
         att_b, dec_b, pg_b, addmask,
         xa, xd, xp, c_att, c_dec, wprev, wcum, out_t, flags,
         mel_out, gate_out, align_out,
         max_steps, dropout_on, check_every, thr, seed,
         static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return (int)run_b<float>(a);
    case 1: return (int)run_b<__nv_bfloat16>(a);
    case 2: return (int)run_b<__half>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}
