// Autoregressive Tacotron2 decode loop for 1 <= B <= 8 rows (kernel K1).
//
// Replaces: tacotron2_vae_tpu/ops/pallas/decoder_loop.py::_kernel (B=1,
// via decode_loop) and ::_kernel_batched (1<B<=8, via decode_loop_batched).
// One set of kernels serves every B from 1 to 8 (B is a template argument).
//
// What bounds it on an H100: every decoder step reads the two fused LSTM
// weight matrices, (P+E+Ha) x 4Ha and (Ha+E+Hd) x 4Hd, plus the small
// query / location / projection / prenet weights: ~36.3 MB in bf16 (~72.6 MB
// in f32) a step at the full-width defaults, against 3.35 TB/s of HBM ->
// about 10.8 us (bf16) / 21.7 us (f32) a step if every byte came from HBM.
// The activations are a few KB.  The TPU kernel pinned all weights in VMEM
// for the whole loop; one SM has 227 KB of shared memory, so that does not
// carry over.  The 50 MB L2 holds them instead: the card lets 32.8 MB be
// set aside for persisting lines (cudaDevAttrMaxPersistingL2CacheSize), a
// hitRatio of 0.92 of the bf16 LSTM weights (35.7 MB) and 0.46 of the f32
// ones (71.4 MB).  Measured (PERF.md): in f32 the window saves ~5 us a
// step; in bf16 the weights stay in L2 without it, and with it a decode
// was slower, so the wrapper asks for it only where both LSTMs' weights
// exceed the card's L2 (ops/decoder_loop.py l2_window).  Every kernel is
// bound by latency, not by the card's rates: its time is its chain of
// dependent loads and barriers, which each issues a chunk at a time.
//
// Design: four per-step kernels in a CUDA graph that loops on the device.
//   lstm  attention LSTM: two warps per hidden unit compute its 4 gate rows
//         for every batch row (GEMV over weights packed [4*j+g][k], the
//         weight loads of a chunk in flight with x's before the first FMA),
//         then the fp32 cell update; launched, where asked, with an L2
//         access-policy window over its weights (persisting hits,
//         streaming misses)
//   att   one cluster of kNC CTAs per row (below): query, the 31-tap
//         location conv over [w_prev, w_cum], loc_dense, tanh(q+loc+pmem).v,
//         additive mask, softmax over S, context = w.memory, w_cum += w
//   lstm  decoder LSTM (same kernel, its own window over its weights)
//   tail  one cluster of kTailNC CTAs: the fused mel+gate projection (its
//         N = n_mel*r + 1 columns split over the CTAs, a warp a column),
//         the frame exchanged through distributed shared memory, the step's
//         outputs for rows not yet finished, the finished flags, the step
//         count, then the prenet of step t+1 on that frame (each layer's
//         outputs split over the CTAs, layer 1's exchanged the same way);
//         it ends the graph's loop (cudaGraphSetConditional) once every row
//         has finished or max_steps steps have run; every launch adds one
//         to a count on the device (flags[kTailRuns]), which the entry
//         returns with the step count.
// Each of the four needs the whole output of the one before, so four
// launches a step is the least that per-step kernels allow (a persistent
// kernel would need a grid-wide barrier between them).  The tail is bound
// by latency, not by its ~0.5 MB of weights (0.15 us of HBM): one round trip
// for all its loads (weights, flags, [h_dec, ctx]), two cluster exchanges,
// three short products; kTailNC = 8 measured 3.3-5.0 us a step faster than
// 4 (tools/decode_turns.py in turns with a copy built with 4; PERF.md).
//
// The loop on the device: the graph is one conditional WHILE node whose
// body is kUnroll = 8 steps' kernels (an iteration of the node measured
// ~4.5-7 us of its own, and a step past the end returns at once), so a
// decode is one graph launch, with no host read of the all-finished flag
// between steps; the host synchronises once, at the end, to read the step
// count.  The graph is built once per set of sizes and
// weights (kDecodeGraphs kept, most recent first) and reused by every call:
// its kernels take fixed pointers into a work arena that the entry owns, and
// each call's head kernel (a plain launch before the graph, its arguments
// by value) copies the call's memory, processed memory and mask into the
// arena, zeroes the recurrent state (the prenet of the zero first frame is
// zero: the prenet has no bias) and writes the call's output pointers,
// step cap, seed and threshold there.  So a call with new tensors needs no
// capture, no update and no instantiation; the outputs are the caller's own
// tensors, never a buffer a later call overwrites.  Every kernel reads the
// step from the device (flags[1]) and returns at once once flags[0] is set
// (every row finished or max_steps reached).  The L2 set-aside is scoped to
// the decode: set before the head, then, after the final synchronise, the
// persisting lines reset and the limit restored to what it was.  Decodes are
// serialised by one mutex, which the arena, the cache and the device-wide
// limit need.
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
// Each dot product is summed in one fixed order by one warp (no partial sums
// across CTAs, no float atomics), so a run is deterministic.
// The mask is additive with finfo(float32).min, so a fully masked row is
// uniform, not NaN.  Prenet dropout draws its bits from a counter hash of
// (seed, step, layer, row, unit); ops/decoder_loop.py computes the same
// hash, so the plain twin reproduces the kernel's masks bit for bit.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>
#include <vector>

namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = 8;          // warps per block in the LSTM kernel
constexpr int kThreads = 256;      // threads per block elsewhere
constexpr int kNC = 8;             // attention: CTAs per row (one cluster), S split kNC ways
constexpr int kCtxPre = 4;         // attention: context memory vectors a thread loads early
constexpr int kMaxF = 32;          // location filters held in registers
constexpr int kSplitK = 2;         // warps sharing one LSTM unit's dot products
constexpr int kTailNC = 8;         // tail: CTAs of its cluster
constexpr int kTailThreads = 512;  // threads of each tail CTA
constexpr int kProjNK = 8;         // tail: weight vectors a lane loads before its FMAs
constexpr int kHeadBlocks = 64;    // blocks of the head kernel
constexpr int kDecodeGraphs = 8;   // executable graphs kept, one per set of sizes and weights
constexpr int kUnroll = 8;         // steps in the body of the graph's device-side loop
constexpr int kFlags = 16;         // ints of the flags: done, step, finished[B], ..., tail runs
constexpr int kTailRuns = kFlags - 1;  // flags slot counting the tail's launches
constexpr int kNoCap = 0x7fffffff; // the step cap the graph's kernels see (the tail applies max_steps)

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

template <typename T> __device__ __forceinline__ float4 rnd4(float4 v) {
  return make_float4(rnd<T>(v.x), rnd<T>(v.y), rnd<T>(v.z), rnd<T>(v.w));
}

__device__ __forceinline__ float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }

// The step this launch belongs to, read from the device-side step count
// (flags[1], advanced by tail_kernel at the end of every step), or -1 once
// flags[0] is set (every row finished or max_steps steps run) or t reaches
// max_steps.
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


// One warp's weight vectors of R rows for one chunk of 32 V NK columns
// starting at c0 (lane l holds columns c0 + (l + 32 c) V, c < NK, those
// below ke), loaded with every load in flight at once.  A kernel loads its
// first chunk before the data it multiplies is ready, so that the two
// round trips to memory overlap.
template <typename T, int R, int NK>
struct Chunk {
  uint4 raw[NK][R];
  __device__ __forceinline__ void load(const T* __restrict__ w, size_t row0, int K, int c0,
                                       int ke) {
    constexpr int V = Vec<T>::N;
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int c = 0; c < NK; ++c) {
      const int k0 = c0 + (c * 32 + lane) * V;
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (k0 < ke) raw[c][r] = *reinterpret_cast<const uint4*>(w + (row0 + r) * (size_t)K + k0);
    }
  }
};

// acc[r][b] += the chunk's products with xs[b * K + k] (xs 16-byte aligned).
template <typename T, int B, int R, int NK>
__device__ __forceinline__ void fma_chunk(const Chunk<T, R, NK>& ch, int c0, int ke, int K,
                                          const float* xs, float (&acc)[R][B]) {
  constexpr int V = Vec<T>::N;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < NK; ++c) {
    const int k0 = c0 + (c * 32 + lane) * V;
    if (k0 < ke) {
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
        Vec<T>::unpack(ch.raw[c][r], wv);
#pragma unroll
        for (int b = 0; b < B; ++b)
#pragma unroll
          for (int e = 0; e < V; ++e) acc[r][b] = fmaf(wv[e], xv[b][e], acc[r][b]);
      }
    }
  }
}

// acc[r][b] = sum over k in [kb, ke) of w[row0 + r][k] * xs[b * K + k], for R
// weight rows and B batch rows, one warp; every lane holds the full sums on
// return.  Lane l sums k = kb + (l + 32 i) V in order of i, a chunk of NK
// vectors of each row at a time (one round trip to memory a chunk); the
// first chunk is `first`, loaded earlier, when `have_first`.  K, kb, ke
// multiples of V.  A kernel keeps one call site a product: its code is
// fetched anew at every launch, and the tail ran faster with less of it
// (PERF.md).
template <typename T, int B, int R, int NK>
__device__ __forceinline__ void gemv_rows(const T* __restrict__ w, size_t row0, int K,
                                          const float* xs, float (&acc)[R][B], int kb, int ke,
                                          const Chunk<T, R, NK>& first, bool have_first) {
  constexpr int step = 32 * Vec<T>::N * NK;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int b = 0; b < B; ++b) acc[r][b] = 0.0f;
  int c0 = kb;
  if (have_first) {
    fma_chunk<T, B, R, NK>(first, c0, ke, K, xs, acc);
    c0 += step;
  }
  for (; c0 < ke; c0 += step) {
    Chunk<T, R, NK> ch;
    ch.load(w, row0, K, c0, ke);
    fma_chunk<T, B, R, NK>(ch, c0, ke, K, xs, acc);
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int b = 0; b < B; ++b) acc[r][b] = warp_sum(acc[r][b]);
}

// acc[i / B][i % B] for a lane's own i (a select per element, so that each
// lane of a warp takes a different element in parallel after warp_sum).
template <int R, int B>
__device__ __forceinline__ float pick(const float (&acc)[R][B], int i) {
  float v = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int b = 0; b < B; ++b) v = r * B + b == i ? acc[r][b] : v;
  return v;
}

// ---------------------------------------------------------------- kernels

// One LSTM step: w is (4H, K) with row 4*j+g holding gate g of unit j
// (gate order i, f, g, o); bias is (4H) in gate-major order g*H+j.  Each
// unit's dot products are split over kSplitK warps of the block (halving
// each warp's chain of weight-load round trips); each warp loads the first
// chunk of its four rows (up to 4 vectors a row and lane, as registers
// allow) while the step is read and x staged, so the weights, the step and
// the data arrive in one round trip.  The partial sums meet in shared
// memory in a fixed order.
template <typename T, int B>
__global__ void lstm_kernel(const T* __restrict__ w, const float* __restrict__ bias,
                            const float* __restrict__ x, int ldx, int K, int H,
                            float* __restrict__ c, float* __restrict__ hout, int ldh,
                            const int* __restrict__ flags, int max_steps) {
  constexpr int V = Vec<T>::N;
  constexpr int NK = B <= 2 ? 4 : B <= 4 ? 2 : 1;  // loads in flight, as registers allow
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int unit = warp / kSplitK, ks = warp % kSplitK;
  const int j = blockIdx.x * (kWarps / kSplitK) + unit;
  const int kc = (K / kSplitK + V - 1) / V * V;
  const int kb = min(K, ks * kc), ke = min(K, kb + kc);
  const int t = step_of(flags, max_steps);
  Chunk<T, 4, NK> first;
  if (j < H) first.load(w, (size_t)4 * j, K, kb, ke);
  extern __shared__ float xs[];  // B * K
  __shared__ float part[kWarps][4][B];
  stage_rows<T, B>(x, ldx, K, xs);
  if (t < 0) return;  // past the end (the whole block alike)
  if (j < H) {
    float acc[4][B];
    gemv_rows<T, B, 4, NK>(w, (size_t)4 * j, K, xs, acc, kb, ke, first, true);
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
// as float; each lane sums its k in the order gemv_rows does, and issues the
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

// ------------------------------------------------------- the step's tail

// A call's values that the graph's kernels cannot take as arguments (the
// graph is reused across calls): written by head_kernel, read by tail_kernel.
struct Params {
  float* mel_out;
  float* gate_out;
  float* align_out;
  int max_steps, dropout_on;
  uint32_t seed;
  float thr;
};

struct TailDims {
  int S, E, Ha, Hd, P, n_out;
  int lda, ldd, ldp;
};

// The tail's split over a cluster of nc CTAs: each takes Nc of the N
// projection columns (the last ones fewer or none) and Pc of the prenet's P
// outputs of each layer (P % 16 == 0 and nc <= 8, so Pc is even).  Its
// shared memory, in floats, in the kernel's order (every region a multiple
// of 4 floats): [h_dec, ctx] rounded (B Kp), its own columns (B up4(Nc)),
// the whole frame (up4(B N)), the frame rounded for prenet layer 1
// (up4(B n_out)), its own layer-1 outputs (B up4(Pc)), all of them (B P).
struct TailGeo {
  int N, Nc, Pc;
  __host__ __device__ TailGeo(const TailDims& d, int nc) {
    N = d.n_out + 1;
    Nc = (N + nc - 1) / nc;
    Pc = (d.P + nc - 1) / nc;
  }
  __host__ __device__ static int floats(const TailDims& d, int nc, int B) {
    const TailGeo g(d, nc);
    return B * (d.Hd + d.E) + B * up4(g.Nc) + up4(B * g.N) + up4(B * d.n_out) +
           B * up4(g.Pc) + B * d.P;
  }
};

// ReLU, then prenet dropout 0.5 with the bits of (seed, step, layer, row b,
// unit n), scaled by 2 where kept.
__device__ __forceinline__ float relu_drop(float v, const Params& p, int step, int layer, int b,
                                           int n) {
  v = fmaxf(v, 0.0f);
  if (p.dropout_on) v = keep_bit(p.seed, step, layer, b, n) ? v * 2.0f : 0.0f;
  return v;
}

// The end of step t and the prenet of step t+1, on a cluster of nc =
// kTailNC CTAs (kTailThreads threads each); rank 0 first counts the launch
// in flags[kTailRuns].  Every load
// that waits on no other is issued first: a warp's weights (a projection
// column, two rows of each prenet layer), the step, the Params, the
// finished flags, a thread's first alignment value and [h_dec, ctx] (staged
// rounded into shared memory; the CTA's share of h_dec copied unrounded
// into the decoder LSTM's next input on the way).  Each CTA computes its
// columns of the fused mel+gate projection, a warp a column; the CTAs read
// each other's columns through distributed shared memory, so every CTA
// holds the whole frame.  Each writes its columns of mel and gate and its
// share of the alignments for rows not yet finished.  Unless the loop ends
// here, each then
// computes its Pc outputs of prenet layer 1 on the frame rounded (dropout
// bits of step t+1), the CTAs exchange them the same way, and each computes
// its Pc outputs of layer 2 into the attention LSTM's input.  Rank 0 last
// advances the finished flags, the step count and the all-done flag, and,
// inside the graph's loop (`looped`), ends the loop when every row has
// finished or max_steps steps have run.
template <typename T, int B>
__global__ void __cluster_dims__(kTailNC, 1, 1) __launch_bounds__(kTailThreads, 1)
tail_kernel(TailDims d, const T* __restrict__ w1, const T* __restrict__ w2,
            const T* __restrict__ pg_w, const float* __restrict__ pg_b, float* __restrict__ xa,
            float* __restrict__ xd, const float* __restrict__ xp,
            const float* __restrict__ wprev, int* __restrict__ flags,
            const Params* __restrict__ prm, cudaGraphConditionalHandle loop, int looped) {
  cg::cluster_group cl = cg::this_cluster();
  const int nc = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const TailGeo geo(d, nc);
  const int N = geo.N, Kp = d.Hd + d.E, n_in = d.n_out, P = d.P;
  const int c0 = rank * geo.Nc, c1 = min(N, c0 + geo.Nc);  // this CTA's columns
  const int q0 = rank * geo.Pc, q1 = min(P, q0 + geo.Pc);  // its prenet outputs
  const int col0 = c0 + warp, n1 = q0 + 2 * warp;           // this warp's first ones
  const int g0 = rank * blockDim.x + tid, gs = nc * blockDim.x;  // the cluster's threads
  Chunk<T, 1, kProjNK> wp;
  Chunk<T, 2, 1> wl1;
  Chunk<T, 2, 2> wl2;
  if (col0 < c1) wp.load(pg_w, (size_t)col0, Kp, 0, Kp);
  if (n1 < q1) {
    wl1.load(w1, (size_t)n1, n_in, 0, n_in);
    wl2.load(w2, (size_t)n1, P, 0, P);
  }
  const int t = step_of(flags, kNoCap);
  if (rank == 0 && tid == 0) ++flags[kTailRuns];
  const Params p = *prm;
  int* finished = flags + 2;
  const int fin = tid < B ? finished[tid] : 1;
  const float wp0 = g0 < B * d.S ? wprev[g0] : 0.0f;
  extern __shared__ __align__(16) float sm[];
  float* xs = sm;                        // B * Kp
  float* own = xs + B * Kp;              // B * up4(Nc)
  float* frame = own + B * up4(geo.Nc);  // up4(B * N)
  float* xin = frame + up4(B * N);       // up4(B * n_in)
  float* h1own = xin + up4(B * n_in);    // B * up4(Pc)
  float* h1 = h1own + B * up4(geo.Pc);   // B * P
  __shared__ int active[B];
  {  // as stage_rows (4 loads of a thread in flight), and the unrounded
     // vectors i of h_dec with i % nc == rank into xd
    const int K4 = Kp / 4, n4 = B * K4, hd4 = d.Hd / 4;
    for (int i0 = tid; i0 < n4; i0 += 4 * blockDim.x) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * blockDim.x, b = i / K4;
        if (i < n4)
          v[u] = *reinterpret_cast<const float4*>(xp + (size_t)b * d.ldp + 4 * (i - b * K4));
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * blockDim.x, b = i / K4, k4 = i - b * K4;
        if (i >= n4) continue;
        *reinterpret_cast<float4*>(xs + 4 * i) = rnd4<T>(v[u]);  // [h_dec, ctx] rounded
        if (k4 < hd4 && i % nc == rank)
          *reinterpret_cast<float4*>(xd + (size_t)b * d.ldd + d.Ha + d.E + 4 * k4) = v[u];
      }
    }
    if (tid < B) active[tid] = !fin;
    __syncthreads();
  }
  if (t < 0) {  // past the end (every CTA alike): end the graph's loop
    if (looped && rank == 0 && tid == 0) cudaGraphSetConditional(loop, 0);
    return;
  }

  // this CTA's columns [c0, c1) of the projection, a warp a column
  for (int col = col0; col < c1; col += nw) {
    float acc[1][B];
    gemv_rows<T, B, 1, kProjNK>(pg_w, (size_t)col, Kp, xs, acc, 0, Kp, wp, col == col0);
    if (lane < B) own[lane * geo.Nc + col - c0] = pick(acc, lane) + pg_b[col];
  }
  // every CTA's columns are in its shared memory, and every CTA has read
  // the step and the finished flags (rank 0 rewrites them below)
  cl.sync();
  for (int i = tid; i < B * N; i += blockDim.x) {
    const int b = i / N, col = i - b * N, r = col / geo.Nc;
    frame[i] = *cl.map_shared_rank(own + b * geo.Nc + col - r * geo.Nc, r);
  }
  __syncthreads();

  bool all = true;
#pragma unroll
  for (int b = 0; b < B; ++b) all = all && (!active[b] || sigm(frame[b * N + d.n_out]) > p.thr);
  const bool stop = all || t + 1 >= p.max_steps;

  // outputs of rows not yet finished: this CTA's columns of mel and gate,
  // its share of the alignments
  const int nown = max(0, c1 - c0);
  for (int i = tid; i < B * nown; i += blockDim.x) {
    const int b = i / nown, col = c0 + i - b * nown;
    if (!active[b]) continue;
    const float v = frame[b * N + col];
    if (col < d.n_out)
      p.mel_out[((size_t)t * B + b) * d.n_out + col] = v;
    else
      p.gate_out[(size_t)t * B + b] = v;
  }
  for (int i = g0; i < B * d.S; i += gs)
    if (active[i / d.S]) p.align_out[(size_t)t * B * d.S + i] = i == g0 ? wp0 : wprev[i];

  // the prenet of step t+1 (2 x linear+ReLU+dropout 0.5) on the frame
  // rounded, two rows a warp call (lane i takes element i's ReLU, dropout
  // and store); after every row has finished or at max_steps no step reads it
  if (!stop) {
    const int tn = t + 1;
    for (int i = tid; i < B * n_in; i += blockDim.x) {
      const int b = i / n_in;
      xin[i] = rnd<T>(frame[b * N + i - b * n_in]);
    }
    __syncthreads();
    for (int n0 = n1; n0 < q1; n0 += 2 * nw) {
      float acc[2][B];
      gemv_rows<T, B, 2, 1>(w1, (size_t)n0, n_in, xin, acc, 0, n_in, wl1, n0 == n1);
      if (lane < 2 * B) {
        const int r = lane / B, b = lane - r * B;
        h1own[b * geo.Pc + n0 - q0 + r] = rnd<T>(relu_drop(pick(acc, lane), p, tn, 0, b, n0 + r));
      }
    }
    cl.sync();  // every CTA's layer-1 outputs
    for (int i = tid; i < B * P; i += blockDim.x) {
      const int b = i / P, n = i - b * P, r = n / geo.Pc;
      h1[i] = *cl.map_shared_rank(h1own + b * geo.Pc + n - r * geo.Pc, r);
    }
    __syncthreads();
    for (int n0 = n1; n0 < q1; n0 += 2 * nw) {
      float acc[2][B];
      gemv_rows<T, B, 2, 2>(w2, (size_t)n0, P, h1, acc, 0, P, wl2, n0 == n1);
      if (lane < 2 * B) {
        const int r = lane / B, b = lane - r * B;
        xa[(size_t)b * d.lda + n0 + r] = relu_drop(pick(acc, lane), p, tn, 1, b, n0 + r);
      }
    }
  }
  // done reading the other CTAs' shared memory; none of them may exit
  // before every CTA has arrived here (the wait at the end)
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  __syncthreads();
  if (rank == 0 && tid == 0) {  // after every other write of this CTA
#pragma unroll
    for (int b = 0; b < B; ++b)
      finished[b] = !active[b] || sigm(frame[b * N + d.n_out]) > p.thr;
    flags[1] = t + 1;
    flags[0] = stop;
    if (looped && stop) cudaGraphSetConditional(loop, 0);
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// What head_kernel does before a call's graph: the call's memory,
// processed memory and additive mask copied into the entry's arena (the
// graph's attention kernel reads them there), the recurrent state zeroed
// (xa, xd, xp, c_att, c_dec, w_prev, w_cum back to back; xa's prenet part
// too, which is the prenet of the zero first frame: the prenet has no
// bias), the flags and the tail's count reset and the call's Params written.
struct HeadArgs {
  const uint4* mem_src;
  uint4* mem_dst;
  size_t mem_vecs;
  const uint4* pmem_src;
  uint4* pmem_dst;
  size_t pmem_vecs;
  const float* mask_src;
  float* mask_dst;
  size_t mask_n;
  float4* state;
  size_t state_vecs;
  int* flags;
  Params* prm;
  Params p;
};

__global__ void head_kernel(HeadArgs h) {
  const size_t g0 = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  const size_t gs = (size_t)gridDim.x * blockDim.x;
  for (size_t i = g0; i < h.mem_vecs; i += gs) h.mem_dst[i] = h.mem_src[i];
  for (size_t i = g0; i < h.pmem_vecs; i += gs) h.pmem_dst[i] = h.pmem_src[i];
  for (size_t i = g0; i < h.mask_n; i += gs) h.mask_dst[i] = h.mask_src[i];
  for (size_t i = g0; i < h.state_vecs; i += gs) h.state[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (g0 < (size_t)kFlags) h.flags[g0] = g0 == 0 ? h.p.max_steps <= 0 : 0;
  if (g0 == 0) *h.prm = h.p;
}

// ------------------------------------------------------------ the host side

struct Args {
  int dtype, B, S, E, Ha, Hd, P, A, F, KL, n_out, l2_window, use_graph;
  const void *w1, *w2, *att_w, *dec_w, *wq, *locw, *ldw, *v, *pg_w, *mem, *pmem;
  const float *att_b, *dec_b, *pg_b, *addmask;
  float *mel_out, *gate_out, *align_out;
  int max_steps, dropout_on;
  float thr;
  uint32_t seed;
  cudaStream_t stream;
};

// Byte offsets of an entry's arena: the recurrent state (floats, back to
// back, each part a multiple of 4 floats), then the copies of the call's
// memory, processed memory and mask, the flags and the Params.
struct Layout {
  size_t xa, xd, xp, c_att, c_dec, wprev, wcum, state_end, mem, pmem, mask, flags, prm, bytes;
  Layout(const Args& a, int tb) {
    auto al = [](size_t x) { return (x + 255) / 256 * 256; };
    const size_t B = a.B, S = a.S;
    size_t o = 0;
    xa = o, o += 4 * B * (a.P + a.E + a.Ha);
    xd = o, o += 4 * B * (a.Ha + a.E + a.Hd);
    xp = o, o += 4 * B * (a.Hd + a.E);
    c_att = o, o += 4 * B * a.Ha;
    c_dec = o, o += 4 * B * a.Hd;
    wprev = o, o += 4 * (size_t)up4((int)(B * S));
    wcum = o, o += 4 * (size_t)up4((int)(B * S));
    state_end = o;
    mem = o = al(o), o += B * S * a.E * tb;
    pmem = o = al(o), o += B * S * a.A * tb;
    mask = o = al(o), o += 4 * B * S;
    flags = o = al(o), o += 4 * kFlags;
    prm = o = al(o), o += sizeof(Params);
    bytes = al(o);
  }
};

// The L2 set-aside for both LSTMs' weights and the windows' hitRatio: the
// whole of their bytes up to the card's limit on persisting lines, and the
// share that fits (float32's 71.4 MB do not).
struct L2Plan {
  size_t setaside = 0, max_window = 0;
  float hit = 0.0f;
};

cudaError_t l2_plan(size_t bytes, L2Plan* pl) {
  int dev = 0, maxp = 0, maxw = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&maxp, cudaDevAttrMaxPersistingL2CacheSize, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&maxw, cudaDevAttrMaxAccessPolicyWindowSize, dev);
  pl->setaside = std::min(bytes, (size_t)maxp);
  pl->max_window = (size_t)maxw;
  pl->hit = bytes > 0 ? std::min(1.0f, (float)((double)pl->setaside / (double)bytes)) : 0.0f;
  return err;
}

cudaAccessPolicyWindow window_of(const void* base, size_t bytes, const L2Plan& pl) {
  cudaAccessPolicyWindow w = {};
  w.base_ptr = const_cast<void*>(base);
  w.num_bytes = std::min(bytes, pl.max_window);
  w.hitRatio = pl.hit;
  w.hitProp = cudaAccessPropertyPersisting;
  w.missProp = cudaAccessPropertyStreaming;
  return w;
}

struct Entry {
  std::vector<long long> key;  // dtype, device, sizes, window flag, weights
  cudaGraph_t graph;
  cudaGraphExec_t exec;
  char* arena;
  L2Plan l2;
};

struct Cache {
  std::mutex mu;                 // held for a whole decode: the arena, this cache, the L2 limit
  std::vector<Entry> entries;    // most recent first
  long long captures = 0;        // graphs instantiated so far
  long long windowed = 0;        // LSTM kernel nodes carrying their window, last graph built
  L2Plan l2;                     // the last decode's set-aside and hitRatio
};

Cache& cache() {
  static Cache* c = new Cache;  // never destroyed: no teardown after the CUDA runtime's
  return *c;
}

cudaError_t smem_attr(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int B>
cudaError_t launch_lstm(cudaStream_t s, const cudaAccessPolicyWindow* win, size_t smem,
                        const T* w, const float* b, const float* x, int K, int H, float* c,
                        float* h, int ldh, const int* flags) {
  constexpr int kUnits = kWarps / kSplitK;  // LSTM units per block
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((H + kUnits - 1) / kUnits);
  cfg.blockDim = dim3(32 * kWarps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute at[1];
  if (win) {
    at[0].id = cudaLaunchAttributeAccessPolicyWindow;
    at[0].val.accessPolicyWindow = *win;
    cfg.attrs = at;
    cfg.numAttrs = 1;
  }
  return cudaLaunchKernelEx(&cfg, lstm_kernel<T, B>, w, b, x, K, K, H, c, h, ldh, flags, kNoCap);
}

// The LSTM kernel nodes of `body` whose access-policy window is the one
// their launch asked for (read back from the captured graph).
template <typename T, int B>
cudaError_t count_windows(cudaGraph_t body, const cudaAccessPolicyWindow (&want)[2],
                          long long* n) {
  size_t count = 0;
  cudaError_t err = cudaGraphGetNodes(body, nullptr, &count);
  std::vector<cudaGraphNode_t> nodes(count);
  if (err == cudaSuccess && count) err = cudaGraphGetNodes(body, nodes.data(), &count);
  *n = 0;
  for (size_t i = 0; err == cudaSuccess && i < count; ++i) {
    cudaGraphNodeType type;
    if ((err = cudaGraphNodeGetType(nodes[i], &type)) != cudaSuccess) break;
    if (type != cudaGraphNodeTypeKernel) continue;
    cudaKernelNodeParams kp;
    if ((err = cudaGraphKernelNodeGetParams(nodes[i], &kp)) != cudaSuccess) break;
    if (kp.func != (void*)lstm_kernel<T, B>) continue;
    cudaKernelNodeAttrValue v;
    err = cudaGraphKernelNodeGetAttribute(nodes[i], cudaKernelNodeAttributeAccessPolicyWindow, &v);
    const cudaAccessPolicyWindow& got = v.accessPolicyWindow;
    for (const cudaAccessPolicyWindow& w : want)
      if (err == cudaSuccess && got.base_ptr == w.base_ptr && got.num_bytes == w.num_bytes &&
          got.hitRatio == w.hitRatio && got.hitProp == w.hitProp && got.missProp == w.missProp)
        ++*n;
  }
  return err;
}

template <typename T, int B>
cudaError_t launch_tail(cudaStream_t s, const TailDims& td, const T* w1, const T* w2,
                        const T* pg_w, const float* pg_b, float* xa, float* xd, const float* xp,
                        const float* wprev, int* flags, const Params* prm,
                        cudaGraphConditionalHandle loop, int looped) {
  tail_kernel<T, B><<<kTailNC, kTailThreads, (size_t)TailGeo::floats(td, kTailNC, B) * 4, s>>>(
      td, w1, w2, pg_w, pg_b, xa, xd, xp, wprev, flags, prm, loop, looped);
  return cudaGetLastError();
}

// Enqueue one step's four kernels on s, every pointer into e's arena;
// `looped`: inside e's graph, whose loop the tail ends through `loop`.
template <typename T, int B>
cudaError_t enqueue_step(const Args& a, const Entry& e, cudaStream_t s,
                         cudaGraphConditionalHandle loop, int looped) {
  const int Ka = a.P + a.E + a.Ha, Kd = a.Ha + a.E + a.Hd, Kp = a.Hd + a.E;
  const AttDims d{a.S, a.E, a.Ha, a.Hd, a.P, a.A, a.F, a.KL, Ka, Kd, Kp};
  const TailDims td{a.S, a.E, a.Ha, a.Hd, a.P, a.n_out, Ka, Kd, Kp};
  const size_t sm_la = (size_t)B * Ka * sizeof(float), sm_ld = (size_t)B * Kd * sizeof(float);
  const size_t sm_att = (size_t)AttGeo::floats(d, Vec<T>::N, sizeof(T)) * sizeof(float);
  const Layout L(a, sizeof(T));
  char* z = e.arena;
  float* xa = reinterpret_cast<float*>(z + L.xa);
  float* xd = reinterpret_cast<float*>(z + L.xd);
  float* xp = reinterpret_cast<float*>(z + L.xp);
  float* wprev = reinterpret_cast<float*>(z + L.wprev);
  int* flags = reinterpret_cast<int*>(z + L.flags);
  const T* att_w = static_cast<const T*>(a.att_w);
  const T* dec_w = static_cast<const T*>(a.dec_w);
  const cudaAccessPolicyWindow win[2] = {
      window_of(att_w, (size_t)4 * a.Ha * Ka * sizeof(T), e.l2),
      window_of(dec_w, (size_t)4 * a.Hd * Kd * sizeof(T), e.l2)};

  cudaError_t err = launch_lstm<T, B>(s, a.l2_window ? &win[0] : nullptr, sm_la, att_w, a.att_b,
                                      xa, Ka, a.Ha, reinterpret_cast<float*>(z + L.c_att), xd, Kd,
                                      flags);
  if (err != cudaSuccess) return err;
  att_kernel<T><<<dim3(kNC, B), kThreads, sm_att, s>>>(
      d, static_cast<const T*>(a.wq), static_cast<const T*>(a.locw),
      static_cast<const T*>(a.ldw), static_cast<const T*>(a.v),
      reinterpret_cast<const T*>(z + L.pmem), reinterpret_cast<const T*>(z + L.mem),
      reinterpret_cast<const float*>(z + L.mask), wprev, reinterpret_cast<float*>(z + L.wcum),
      xa, xd, xp, flags, kNoCap);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = launch_lstm<T, B>(s, a.l2_window ? &win[1] : nullptr, sm_ld, dec_w, a.dec_b, xd, Kd,
                          a.Hd, reinterpret_cast<float*>(z + L.c_dec), xp, Kp, flags);
  if (err != cudaSuccess) return err;
  return launch_tail<T, B>(s, td, static_cast<const T*>(a.w1), static_cast<const T*>(a.w2),
                           static_cast<const T*>(a.pg_w), a.pg_b, xa, xd, xp, wprev, flags,
                           reinterpret_cast<const Params*>(z + L.prm), loop, looped);
}

// Build e's graph: one conditional WHILE node (its handle 1 at every
// launch) whose body is kUnroll steps' four kernels each (kernels past the
// end return at once), captured on a stream of its own (the caller's may be
// the legacy default stream, which cannot be captured).  The LSTM nodes
// must carry their windows.
template <typename T, int B>
cudaError_t build(const Args& a, Entry& e, long long* windowed) {
  const int Ka = a.P + a.E + a.Ha, Kd = a.Ha + a.E + a.Hd, Kp = a.Hd + a.E;
  const AttDims d{a.S, a.E, a.Ha, a.Hd, a.P, a.A, a.F, a.KL, Ka, Kd, Kp};
  const TailDims td{a.S, a.E, a.Ha, a.Hd, a.P, a.n_out, Ka, Kd, Kp};
  cudaError_t err;
  if ((err = smem_attr((const void*)lstm_kernel<T, B>, (size_t)B * std::max(Ka, Kd) * 4)) !=
          cudaSuccess ||
      (err = smem_attr((const void*)att_kernel<T>,
                       (size_t)AttGeo::floats(d, Vec<T>::N, sizeof(T)) * 4)) != cudaSuccess ||
      (err = smem_attr((const void*)tail_kernel<T, B>,
                       (size_t)TailGeo::floats(td, kTailNC, B) * 4)) != cudaSuccess)
    return err;
  const cudaAccessPolicyWindow win[2] = {
      window_of(a.att_w, (size_t)4 * a.Ha * Ka * sizeof(T), e.l2),
      window_of(a.dec_w, (size_t)4 * a.Hd * Kd * sizeof(T), e.l2)};

  cudaGraph_t g = nullptr;
  if ((err = cudaGraphCreate(&g, 0)) != cudaSuccess) return err;
  cudaGraphConditionalHandle loop = 0;
  cudaGraphNodeParams cp = {};
  cudaGraphNode_t node;
  cudaStream_t cs = nullptr;
  if ((err = cudaGraphConditionalHandleCreate(&loop, g, 1, cudaGraphCondAssignDefault)) ==
      cudaSuccess) {
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = loop;
    cp.conditional.type = cudaGraphCondTypeWhile;
    cp.conditional.size = 1;
    err = cudaGraphAddNode(&node, g, nullptr, 0, &cp);
  }
  if (err == cudaSuccess) err = cudaStreamCreateWithFlags(&cs, cudaStreamNonBlocking);
  const cudaGraph_t body = err == cudaSuccess ? cp.conditional.phGraph_out[0] : nullptr;
  if (err == cudaSuccess)
    err = cudaStreamBeginCaptureToGraph(cs, body, nullptr, nullptr, 0,
                                        cudaStreamCaptureModeThreadLocal);
  if (err == cudaSuccess) {
    cudaError_t le = cudaSuccess;
    for (int i = 0; le == cudaSuccess && i < kUnroll; ++i)
      le = enqueue_step<T, B>(a, e, cs, loop, 1);
    cudaGraph_t captured = nullptr;
    err = cudaStreamEndCapture(cs, &captured);
    if (err == cudaSuccess) err = le;
  }
  if (cs) cudaStreamDestroy(cs);
  *windowed = 0;
  if (err == cudaSuccess) err = count_windows<T, B>(body, win, windowed);
  // a window that the graph does not carry is an error, not a slower run
  if (err == cudaSuccess && a.l2_window && *windowed != 2 * kUnroll) err = cudaErrorInvalidValue;
  if (err == cudaSuccess) err = cudaGraphInstantiate(&e.exec, g, 0);
  if (err != cudaSuccess) {
    cudaGraphDestroy(g);
    return err;
  }
  e.graph = g;
  return cudaSuccess;
}

// One decode (under the cache's mutex): the graph of these sizes and
// weights, built on first use; the head on the caller's stream, the graph
// after it, one synchronise at the end for the step count and the tail's
// launches (counts[0], counts[1]); the L2 set-aside only for the decode.
template <typename T, int B>
cudaError_t run(const Args& a, int* counts) {
  Cache& C = cache();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::vector<long long> key = {
      a.dtype, dev, a.B, a.S, a.E, a.Ha, a.Hd, a.P, a.A, a.F, a.KL, a.n_out, a.l2_window,
      (long long)a.w1, (long long)a.w2, (long long)a.att_w,
      (long long)a.att_b,
      (long long)a.dec_w, (long long)a.dec_b, (long long)a.wq, (long long)a.locw,
      (long long)a.ldw, (long long)a.v, (long long)a.pg_w, (long long)a.pg_b};
  auto& es = C.entries;
  const auto it = std::find_if(es.begin(), es.end(), [&](const Entry& e) { return e.key == key; });
  const Layout L(a, sizeof(T));
  if (it != es.end()) {
    std::rotate(es.begin(), it, it + 1);
  } else {
    Entry e{key, nullptr, nullptr, nullptr, {}};
    const size_t lstm_bytes = (size_t)4 * sizeof(T) *
                              ((size_t)a.Ha * (a.P + a.E + a.Ha) +
                               (size_t)a.Hd * (a.Ha + a.E + a.Hd));
    if ((err = l2_plan(lstm_bytes, &e.l2)) != cudaSuccess) return err;
    if ((err = cudaMalloc(&e.arena, L.bytes)) != cudaSuccess) return err;
    if ((err = build<T, B>(a, e, &C.windowed)) != cudaSuccess) {
      cudaFree(e.arena);
      return err;
    }
    ++C.captures;
    if ((int)es.size() == kDecodeGraphs) {  // every earlier decode has been synchronised
      cudaGraphExecDestroy(es.back().exec);
      cudaGraphDestroy(es.back().graph);
      cudaFree(es.back().arena);
      es.pop_back();
    }
    es.insert(es.begin(), e);
  }
  const Entry& e = es.front();
  char* z = e.arena;
  HeadArgs h;
  h.mem_src = static_cast<const uint4*>(a.mem);
  h.mem_dst = reinterpret_cast<uint4*>(z + L.mem);
  h.mem_vecs = (size_t)a.B * a.S * a.E * sizeof(T) / 16;
  h.pmem_src = static_cast<const uint4*>(a.pmem);
  h.pmem_dst = reinterpret_cast<uint4*>(z + L.pmem);
  h.pmem_vecs = (size_t)a.B * a.S * a.A * sizeof(T) / 16;
  h.mask_src = a.addmask;
  h.mask_dst = reinterpret_cast<float*>(z + L.mask);
  h.mask_n = (size_t)a.B * a.S;
  h.state = reinterpret_cast<float4*>(z + L.xa);
  h.state_vecs = (L.state_end - L.xa) / 16;
  h.flags = reinterpret_cast<int*>(z + L.flags);
  h.prm = reinterpret_cast<Params*>(z + L.prm);
  h.p = Params{a.mel_out, a.gate_out, a.align_out, a.max_steps, a.dropout_on, a.seed, a.thr};

  size_t before = 0;
  const bool scoped = a.l2_window != 0;
  if (scoped) {
    if ((err = cudaDeviceGetLimit(&before, cudaLimitPersistingL2CacheSize)) != cudaSuccess)
      return err;
    if ((err = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, e.l2.setaside)) != cudaSuccess)
      return err;
    C.l2 = e.l2;
  }
  head_kernel<<<kHeadBlocks, kThreads, 0, a.stream>>>(h);
  err = cudaGetLastError();
  if (a.use_graph) {
    if (err == cudaSuccess) err = cudaGraphLaunch(e.exec, a.stream);
  } else {  // every step's kernels on the stream (past the end they return at once)
    for (int i = 0; err == cudaSuccess && i < a.max_steps; ++i)
      err = enqueue_step<T, B>(a, e, a.stream, 0, 0);
  }
  int fl[kFlags] = {};
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(fl, h.flags, sizeof(fl), cudaMemcpyDeviceToHost, a.stream);
  const cudaError_t sync_err = cudaStreamSynchronize(a.stream);
  if (err == cudaSuccess) err = sync_err;
  if (scoped) {
    const cudaError_t r1 = cudaCtxResetPersistingL2Cache();
    const cudaError_t r2 = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, before);
    if (err == cudaSuccess) err = r1 != cudaSuccess ? r1 : r2;
  }
  counts[0] = fl[1];
  counts[1] = fl[kTailRuns];
  return err;
}

template <typename T>
cudaError_t run_b(const Args& a, int* counts) {
  switch (a.B) {
    case 1: return run<T, 1>(a, counts);
    case 2: return run<T, 2>(a, counts);
    case 3: return run<T, 3>(a, counts);
    case 4: return run<T, 4>(a, counts);
    case 5: return run<T, 5>(a, counts);
    case 6: return run<T, 6>(a, counts);
    case 7: return run<T, 7>(a, counts);
    case 8: return run<T, 8>(a, counts);
    default: return cudaErrorInvalidValue;
  }
}

// The tail alone at step flags[1] (the entry t2v_tail_step): its Params
// copied to a device buffer of the stream's own, synchronised at the end.
template <typename T, int B>
cudaError_t tail_once(const TailDims& td, const void* w1, const void* w2, const void* pg_w,
                      const float* pg_b, float* xa, float* xd, const float* xp,
                      const float* wprev, int* flags, const Params& p, cudaStream_t s) {
  cudaError_t err = smem_attr((const void*)tail_kernel<T, B>,
                              (size_t)TailGeo::floats(td, kTailNC, B) * 4);
  Params* prm = nullptr;
  if (err == cudaSuccess) err = cudaMallocAsync(reinterpret_cast<void**>(&prm), sizeof(p), s);
  if (err != cudaSuccess) return err;
  err = cudaMemcpyAsync(prm, &p, sizeof(p), cudaMemcpyHostToDevice, s);
  if (err == cudaSuccess)
    err = launch_tail<T, B>(s, td, static_cast<const T*>(w1), static_cast<const T*>(w2),
                            static_cast<const T*>(pg_w), pg_b, xa, xd, xp, wprev, flags, prm, 0,
                            0);
  const cudaError_t free_err = cudaFreeAsync(prm, s);
  const cudaError_t sync_err = cudaStreamSynchronize(s);
  return err != cudaSuccess ? err : free_err != cudaSuccess ? free_err : sync_err;
}

template <typename T>
cudaError_t tail_b(int B, const TailDims& td, const void* w1, const void* w2, const void* pg_w,
                   const float* pg_b, float* xa, float* xd, const float* xp,
                   const float* wprev, int* flags, const Params& p, cudaStream_t s) {
  switch (B) {
    case 1: return tail_once<T, 1>(td, w1, w2, pg_w, pg_b, xa, xd, xp, wprev, flags, p, s);
    case 2: return tail_once<T, 2>(td, w1, w2, pg_w, pg_b, xa, xd, xp, wprev, flags, p, s);
    case 3: return tail_once<T, 3>(td, w1, w2, pg_w, pg_b, xa, xd, xp, wprev, flags, p, s);
    case 4: return tail_once<T, 4>(td, w1, w2, pg_w, pg_b, xa, xd, xp, wprev, flags, p, s);
    case 5: return tail_once<T, 5>(td, w1, w2, pg_w, pg_b, xa, xd, xp, wprev, flags, p, s);
    case 6: return tail_once<T, 6>(td, w1, w2, pg_w, pg_b, xa, xd, xp, wprev, flags, p, s);
    case 7: return tail_once<T, 7>(td, w1, w2, pg_w, pg_b, xa, xd, xp, wprev, flags, p, s);
    case 8: return tail_once<T, 8>(td, w1, w2, pg_w, pg_b, xa, xd, xp, wprev, flags, p, s);
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
// Outputs (f32, zeroed by the caller): mel_out (max_steps, B, n_out),
//   gate_out (max_steps, B), align_out (max_steps, B, S); counts[0] = the
//   steps run, counts[1] = the tail kernel's launches (counted on the
//   device).  l2_window: 1 gives the LSTM launches their L2 window and
//   scopes the set-aside to the call; use_graph: 1 runs the step loop as
//   the cached graph, 0 launches every step's kernels on the stream
//   (max_steps steps; for the profiler, which does not see the launches of
//   a conditional node's body one by one).
// Synchronises the stream before it returns.  Returns a cudaError_t (0 on
// success).
extern "C" int t2v_decode_loop(
    int dtype, int B, int S, int E, int Ha, int Hd, int P, int A, int F, int KL, int n_out,
    const void* w1, const void* w2, const void* att_w, const float* att_b,
    const void* dec_w, const float* dec_b, const void* wq, const void* locw,
    const void* ldw, const void* v, const void* pg_w, const float* pg_b,
    const void* mem, const void* pmem, const float* addmask,
    float* mel_out, float* gate_out, float* align_out,
    int max_steps, float thr, unsigned int seed, int dropout_on, int l2_window, int use_graph,
    int* counts, void* stream) {
  if (B < 1 || B > 8 || A % 32 != 0 || A % (4 * kNC) != 0 || kThreads % A != 0 ||
      F > kMaxF || F % 4 != 0 || P % 16 != 0 || E > 4 * kNC * kThreads || counts == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a{dtype, B, S, E, Ha, Hd, P, A, F, KL, n_out, l2_window, use_graph,
         w1, w2, att_w, dec_w, wq, locw, ldw, v, pg_w, mem, pmem,
         att_b, dec_b, pg_b, addmask,
         mel_out, gate_out, align_out,
         max_steps, dropout_on, thr, seed,
         static_cast<cudaStream_t>(stream)};
  std::lock_guard<std::mutex> lock(cache().mu);
  switch (dtype) {
    case 0: return (int)run_b<float>(a, counts);
    case 1: return (int)run_b<__nv_bfloat16>(a, counts);
    case 2: return (int)run_b<__half>(a, counts);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The tail kernel alone, once, on the caller's tensors (its check against
// its plain version, ops/decoder_loop.py tail_step): step flags[1] of a
// decode with flags (kFlags ints: done, step, finished[B], ..., the tail's
// count in the last) whose decoder LSTM has written xp (B, Hd+E) = [h_dec,
// ctx] and whose attention wrote wprev (B, S).  Writes the step's outputs
// (mel_out, gate_out, align_out as in t2v_decode_loop) for rows not yet
// finished, h_dec into xd (B, Ha+E+Hd) at column Ha+E, the prenet of step
// t+1 into xa (B, P+E+Ha) at column 0 unless the decode stops here, and
// the flags.  Weights and dtype as t2v_decode_loop's.  Synchronises the
// stream before it returns; returns a cudaError_t.
extern "C" int t2v_tail_step(int dtype, int B, int S, int E, int Ha, int Hd, int P, int n_out,
                             const void* w1, const void* w2, const void* pg_w,
                             const float* pg_b, float* xa, float* xd, const float* xp,
                             const float* wprev, int* flags, float* mel_out, float* gate_out,
                             float* align_out, int max_steps, float thr, unsigned int seed,
                             int dropout_on, void* stream) {
  if (B < 1 || B > 8 || P % 16 != 0) return (int)cudaErrorInvalidValue;
  const TailDims td{S, E, Ha, Hd, P, n_out, P + E + Ha, Ha + E + Hd, Hd + E};
  const Params p{mel_out, gate_out, align_out, max_steps, dropout_on, seed, thr};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)tail_b<float>(B, td, w1, w2, pg_w, pg_b, xa, xd, xp, wprev, flags, p, s);
    case 1:
      return (int)tail_b<__nv_bfloat16>(B, td, w1, w2, pg_w, pg_b, xa, xd, xp, wprev, flags, p,
                                         s);
    case 2: return (int)tail_b<__half>(B, td, w1, w2, pg_w, pg_b, xa, xd, xp, wprev, flags, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out[0..n) of: graphs instantiated so far; the card's most persisting-L2
// bytes; its largest access-policy window; the persisting-L2 limit now;
// LSTM kernel nodes carrying their window in the last graph built; the last
// decode's set-aside; its hitRatio x 1e6; the CUDA runtime's and the
// driver's versions.  Returns a cudaError_t.
extern "C" int t2v_decode_info(long long* out, int n) {
  Cache& C = cache();
  std::lock_guard<std::mutex> lock(C.mu);
  int dev = 0, maxp = 0, maxw = 0, runtime = 0, driver = 0;
  size_t limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaRuntimeGetVersion(&runtime);
  if (err == cudaSuccess) err = cudaDriverGetVersion(&driver);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&maxp, cudaDevAttrMaxPersistingL2CacheSize, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&maxw, cudaDevAttrMaxAccessPolicyWindowSize, dev);
  if (err == cudaSuccess) err = cudaDeviceGetLimit(&limit, cudaLimitPersistingL2CacheSize);
  const long long v[9] = {C.captures, maxp, maxw, (long long)limit, C.windowed,
                          (long long)C.l2.setaside, (long long)(C.l2.hit * 1e6), runtime, driver};
  for (int i = 0; i < n && i < 9; ++i) out[i] = v[i];
  return (int)err;
}
