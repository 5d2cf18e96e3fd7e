// The transcript encoder's LSTM recurrence, every direction and step in
// one launch: kernels K7 (forward) and K8 (backward).
//
// Replaces no TPU kernel: the JAX package runs this recurrence as an XLA
// scan (tacotron2_vae_tpu/ops/rnn.py lstm_scan), which PyTorch can only
// express as a Python loop of ~13 small launches a step, plus autograd's
// replay of each of them backwards; on the card that loop is host time.
//
// Semantics (ops/encoder_lstm.py lstm_fwd_plain / lstm_bwd_plain): for each
// direction d, gates g = gx_t + cast(h) w_hh^T + bias with PyTorch's gate
// order (i, f, g, o), the product's operands rounded to the stream dtype and
// summed in float32, h and c float32; pack-padded lengths: a step outside
// its row's length keeps the state and emits zeros (a reversed direction
// scans the sequence backwards, so its padded steps come first).  The
// backward rounds the recurrent gradient cast(dg w_hh) to the stream dtype,
// as autograd of the cast does.
//
// What bounds it on an H100: at the training shape (D=2, B=64, T=561,
// H=256, bf16) the recurrent products are 38 GFLOP (0.04 ms at 989 TFLOP/s)
// and the bytes (gx in, outputs and the residuals out) ~0.7 GB (0.2 ms at
// 3.35 TB/s), but every step needs the whole h of the step before: T
// dependent steps, so the kernel is bound by one step's latency.  The
// design keeps that chain on chip:
//   - one cluster of kCL = 8 CTAs a (direction, row tile); CTA r owns the
//     hidden units [r U, r U + U), U = H / 8, and their 4U gate columns;
//   - bf16 and float16: the CTA's slice of w_hh (4U x H, 64 KB at H=256)
//     lives in registers as mma.sync A fragments for the whole call
//     (64 registers a thread); float32: in shared memory, FFMA products;
//   - forward step: the gates of the tile's rows (M = 4U gate columns,
//     N = the 8 or 16 rows, K = H) from h in shared memory, the float32
//     cell update, then the CTA's h slice stored into every peer's shared
//     memory (DSMEM) for the next step, and one cluster barrier;
//   - backward step: the cell's backward for the CTA's units gives dgates
//     (written out as dgx); the CTA's products dg w_hh over its own 4U gate
//     columns give a partial dh for every hidden unit, which goes to the
//     unit's owner (a reduce-scatter of U x rows floats a peer) and is
//     summed there in a fixed order, so a run is deterministic.  dg enters
//     the 2-byte product as two stream-dtype terms (hi + lo), so the product
//     sees dg to ~16 bits, as autograd's float32 product does;
//   - each step's inputs (gx; or the saved gates, cell states and output
//     gradient) are loaded one step ahead, in flight across the barrier.
// dw_hh and dbias are one large product and a sum after K8 (the wrapper).
// The kernels are enc_lstm_fwd and enc_lstm_bwd: names of their own, so a
// reader of the profiler's trace tells them from K3/K4's kernels.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

namespace cg = cooperative_groups;

// The stream types' codes (StreamType in teacher_common.cuh); 2-byte types
// take the tensor-core products.
enum StreamType { kF32 = 0, kBF16 = 1, kF16 = 2 };
template <typename T> constexpr bool is_tc() { return !std::is_same<T, float>::value; }
constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f<__half>(__half v) { return __half2float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }
// float -> stream type -> float: the cast of ops/layers.py
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f<T>(from_f<T>(v)); }
__device__ __forceinline__ float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }

constexpr int kCL = 8;         // CTAs of a cluster: one (direction, row tile)
constexpr int kThreads = 256;  // eight warps
constexpr int kWarps = kThreads / 32;

// Sizes of one (stream type, hidden size, row tiles of 8) instance.
template <typename T, int H, int NT>
struct Geo {
  static constexpr bool kTC = is_tc<T>();
  static constexpr int U = H / kCL;          // hidden units a CTA owns
  static constexpr int GC = 4 * U;           // their gate columns: i, f, g, o blocks of U
  static constexpr int NR = 8 * NT;          // rows of a tile
  static constexpr int HP = U / 2;           // unit pairs of a row (a thread's item)
  static constexpr int PPT = (HP * NR + kThreads - 1) / kThreads;  // items a thread
  static constexpr int LDH = H + (kTC ? 8 : 4);   // h operand row (elements)
  static constexpr int LDD = GC + (kTC ? 8 : 4);  // dgates operand row (elements)
  static constexpr int LDG = NR + 4;              // gates / partials row (floats)
  static constexpr int SPLIT = kTC ? 2 : 1;       // dgates terms: hi + lo in 2-byte types
  // forward product: M = GC in m-tiles of 16, one a warp, over all of K = H
  // (at H = 16 the 8 gate columns fill half a tile: rows past GC are zero)
  static constexpr int MTF = cdiv(GC, 16), KSF = H / 16;
  // backward product: M = H in m-tiles of 16 (MPW a warp), K = GC (padded
  // to 16 with zero weights and zero dgates columns at H = 16)
  static constexpr int MTB = H / 16, MPW = MTB > kWarps ? MTB / kWarps : 1, KSB = cdiv(GC, 16);
  static constexpr int WB = MTB / MPW;       // warps of the backward product
  static constexpr size_t kW = kTC ? 0 : (size_t)GC * LDH * 4;  // float32 weight slice
  static constexpr size_t kFwd = 2 * NR * LDH * sizeof(T) + (size_t)GC * LDG * 4 + kW;
  static constexpr size_t kRed = (size_t)2 * kCL * U * LDG * 4;
  static constexpr size_t kBwd = kRed + kW + (size_t)SPLIT * NR * LDD * sizeof(T);
  static_assert(H % 16 == 0 && H <= 256 && MTF <= kWarps && WB <= kWarps, "hidden size");
  static_assert(!kTC || LDD >= KSB * 16, "dgates operand row holds the padded K");
  static_assert(MTB % MPW == 0, "backward m-tiles");
  // local gate column m (gate m / U of unit m % U) -> row of w_hh
  __device__ static int wrow(int m, int u0) { return (m / U) * H + u0 + m % U; }
};

__device__ __forceinline__ uint32_t bits(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }
__device__ __forceinline__ uint32_t bits(__half v) { return __half_as_ushort(v); }
template <typename T> __device__ __forceinline__ uint32_t pack2(T lo, T hi) {
  return bits(lo) | (bits(hi) << 16);
}

template <typename T> __device__ __forceinline__ uint32_t ld2(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a (16x16, row) . b (16x8, col), float32 accumulation.
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// A thread's item i: unit pair j0, j0 + 1 of tile row n; false past the tile.
template <typename G>
__device__ __forceinline__ bool item(int i, int& n, int& j0) {
  const int e = threadIdx.x + i * kThreads;
  n = e / G::HP;
  j0 = 2 * (e % G::HP);
  return e < G::HP * G::NR;
}

__device__ __forceinline__ bool in_len(const int* lens, int b, int t, int nT, bool rev) {
  return (rev ? nT - 1 - t : t) < (lens ? lens[b] : nT);
}

// The float32 weight slice ws[m][k] = w_hh[wrow(m)][k] in shared memory.
template <typename G, typename T>
__device__ void load_ws(float* ws, const T* wd, int u0, int H) {
  for (int i = threadIdx.x; i < G::GC * H; i += kThreads) {
    const int m = i / H, k = i - m * H;
    ws[m * G::LDH + k] = to_f(wd[(size_t)G::wrow(m, u0) * H + k]);
  }
}

// ------------------------------------------------------------ K7: forward

// gx (D, B, nT, 4H) float32 in each direction's time order; w (D, 4H, H) in
// T; bias (D, 4H); lens (B,) or null.  Writes out (D, B, nT, H) and, where
// given, the residuals gsave (D, B, nT, 4H) = the pre-activation gates and
// csave (D, B, nT, H) = the cell state after each step.
template <typename T, int H, int NT>
__global__ void __cluster_dims__(kCL, 1, 1) __launch_bounds__(kThreads, 1)
enc_lstm_fwd(int B, int nT, int rev_mask, const float* __restrict__ gx,
             const T* __restrict__ w, const float* __restrict__ bias,
             const int* __restrict__ lens, float* __restrict__ out, float* __restrict__ gsave,
             float* __restrict__ csave) {
  using G = Geo<T, H, NT>;
  constexpr int U = G::U, NR = G::NR, LDH = G::LDH, LDG = G::LDG, PPT = G::PPT;
  extern __shared__ __align__(16) uint8_t smem[];
  T* hs = reinterpret_cast<T*>(smem);                                   // [2][NR][LDH]
  float* gs = reinterpret_cast<float*>(smem + 2 * NR * LDH * sizeof(T));  // [GC][LDG]
  float* ws = gs + G::GC * LDG;                                         // [GC][LDH] (float32)
  cg::cluster_group cl = cg::this_cluster();
  const int r = (int)cl.block_rank(), d = blockIdx.y, row0 = blockIdx.z * NR;
  const bool rev = (rev_mask >> d) & 1;
  const int warp = threadIdx.x >> 5, g8 = (threadIdx.x & 31) >> 2, q4 = threadIdx.x & 3;
  const int u0 = r * U;
  const T* wd = w + (size_t)d * 4 * H * H;

  for (int i = threadIdx.x; i < 2 * NR * LDH; i += kThreads) hs[i] = from_f<T>(0.f);
  uint32_t a[G::KSF][4];  // this warp's m-tile of the slice, all of K
  if constexpr (G::kTC) {
    if (warp < G::MTF) {
      const int m0 = warp * 16 + g8, m1 = m0 + 8;
      const T* w0 = wd + (size_t)G::wrow(m0, u0) * H + 2 * q4;
      const T* w1 = wd + (size_t)G::wrow(m1, u0) * H + 2 * q4;
#pragma unroll
      for (int ks = 0; ks < G::KSF; ++ks) {
        a[ks][0] = m0 < G::GC ? ld2(w0 + ks * 16) : 0u;
        a[ks][1] = m1 < G::GC ? ld2(w1 + ks * 16) : 0u;
        a[ks][2] = m0 < G::GC ? ld2(w0 + ks * 16 + 8) : 0u;
        a[ks][3] = m1 < G::GC ? ld2(w1 + ks * 16 + 8) : 0u;
      }
    }
  } else {
    load_ws<G>(ws, wd, u0, H);
  }
  float c[PPT][2], h[PPT][2];
  float2 bq[PPT][4], xn[PPT][4];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    int n, j0;
    c[i][0] = c[i][1] = h[i][0] = h[i][1] = 0.f;
    if (item<G>(i, n, j0) && row0 + n < B)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        bq[i][q] = *reinterpret_cast<const float2*>(bias + (size_t)d * 4 * H + q * H + u0 + j0);
        xn[i][q] = *reinterpret_cast<const float2*>(
            gx + ((size_t)(d * B + row0 + n) * nT) * 4 * H + q * H + u0 + j0);
      }
  }
  cl.sync();  // every CTA's buffers zeroed before any peer writes into them

  for (int t = 0; t < nT; ++t) {
    float2 xc[PPT][4];
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      int n, j0;
      const bool on = item<G>(i, n, j0) && row0 + n < B;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        xc[i][q] = xn[i][q];
        if (on && t + 1 < nT)
          xn[i][q] = *reinterpret_cast<const float2*>(
              gx + ((size_t)(d * B + row0 + n) * nT + t + 1) * 4 * H + q * H + u0 + j0);
      }
    }
    const T* hc = hs + (t & 1) * NR * LDH;
    T* hn = hs + ((t + 1) & 1) * NR * LDH;
    if constexpr (G::kTC) {
      if (warp < G::MTF) {
        float acc[NT][4] = {};
#pragma unroll
        for (int ks = 0; ks < G::KSF; ++ks)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const T* hb = hc + (nt * 8 + g8) * LDH + ks * 16 + 2 * q4;
            mma16816<T>(acc[nt], a[ks], ld2(hb), ld2(hb + 8));
          }
        const int m = warp * 16 + g8;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          *reinterpret_cast<float2*>(gs + m * LDG + nt * 8 + 2 * q4) =
              make_float2(acc[nt][0], acc[nt][1]);
          if (m + 8 < G::GC)
            *reinterpret_cast<float2*>(gs + (m + 8) * LDG + nt * 8 + 2 * q4) =
                make_float2(acc[nt][2], acc[nt][3]);
        }
      }
    } else {
      for (int o = threadIdx.x; o < G::GC * NR; o += kThreads) {
        const int m = o % G::GC, n = o / G::GC;
        const float4* wr = reinterpret_cast<const float4*>(ws + m * LDH);
        const float4* hr = reinterpret_cast<const float4*>(hc + n * LDH);
        float s = 0.f;
#pragma unroll 8
        for (int k = 0; k < H / 4; ++k) {
          const float4 x = wr[k], y = hr[k];
          s = fmaf(x.x, y.x, s);
          s = fmaf(x.y, y.y, s);
          s = fmaf(x.z, y.z, s);
          s = fmaf(x.w, y.w, s);
        }
        gs[m * LDG + n] = s;
      }
    }
    __syncthreads();

    float gq[PPT][4][2], ov[PPT][2];
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      int n, j0;
      if (!item<G>(i, n, j0) || row0 + n >= B) continue;
      const bool valid = in_len(lens, row0 + n, t, nT, rev);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        gq[i][q][0] = (xc[i][q].x + gs[(q * U + j0) * LDG + n]) + bq[i][q].x;
        gq[i][q][1] = (xc[i][q].y + gs[(q * U + j0 + 1) * LDG + n]) + bq[i][q].y;
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float ig = sigm(gq[i][0][u]), fg = sigm(gq[i][1][u]);
        const float gg = tanhf(gq[i][2][u]), og = sigm(gq[i][3][u]);
        const float cn = fg * c[i][u] + ig * gg;
        const float hv = og * tanhf(cn);
        if (valid) c[i][u] = cn, h[i][u] = hv;
        ov[i][u] = valid ? hv : 0.f;
      }
      if (t + 1 < nT) {  // this CTA's h slice into every CTA's next buffer
        T* dst = hn + n * LDH + u0 + j0;
        if constexpr (G::kTC) {
          const uint32_t v = pack2(from_f<T>(h[i][0]), from_f<T>(h[i][1]));
#pragma unroll
          for (int p = 0; p < kCL; ++p) *reinterpret_cast<uint32_t*>(cl.map_shared_rank(dst, p)) = v;
        } else {
          const float2 v = make_float2(h[i][0], h[i][1]);
#pragma unroll
          for (int p = 0; p < kCL; ++p) *reinterpret_cast<float2*>(cl.map_shared_rank(dst, p)) = v;
        }
      }
    }
    cluster_arrive();
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      int n, j0;
      if (!item<G>(i, n, j0) || row0 + n >= B) continue;
      const size_t row = (size_t)(d * B + row0 + n) * nT + t;
      *reinterpret_cast<float2*>(out + row * H + u0 + j0) = make_float2(ov[i][0], ov[i][1]);
      if (gsave) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          *reinterpret_cast<float2*>(gsave + row * 4 * H + q * H + u0 + j0) =
              make_float2(gq[i][q][0], gq[i][q][1]);
        *reinterpret_cast<float2*>(csave + row * H + u0 + j0) = make_float2(c[i][0], c[i][1]);
      }
    }
    cluster_wait();
  }
}

// ----------------------------------------------------------- K8: backward

// dout (D, B, nT, H): the gradient of K7's out; gsave, csave: K7's
// residuals.  Writes dg (D, B, nT, 4H): the gradient of the gates, which is
// also gx's (zero at steps outside a row's length).
template <typename T, int H, int NT>
__global__ void __cluster_dims__(kCL, 1, 1) __launch_bounds__(kThreads, 1)
enc_lstm_bwd(int B, int nT, int rev_mask, const T* __restrict__ w,
             const int* __restrict__ lens, const float* __restrict__ dout,
             const float* __restrict__ gsave, const float* __restrict__ csave,
             float* __restrict__ dg) {
  using G = Geo<T, H, NT>;
  constexpr int U = G::U, NR = G::NR, LDG = G::LDG, LDD = G::LDD, PPT = G::PPT;
  extern __shared__ __align__(16) uint8_t smem[];
  float* red = reinterpret_cast<float*>(smem);      // [2][kCL source][U][LDG] partial dh
  float* ws = red + 2 * kCL * U * LDG;              // [GC][LDH] (float32)
  T* ds = reinterpret_cast<T*>(smem + G::kRed + G::kW);  // [SPLIT][NR][LDD] this CTA's dgates
  cg::cluster_group cl = cg::this_cluster();
  const int r = (int)cl.block_rank(), d = blockIdx.y, row0 = blockIdx.z * NR;
  const bool rev = (rev_mask >> d) & 1;
  const int warp = threadIdx.x >> 5, g8 = (threadIdx.x & 31) >> 2, q4 = threadIdx.x & 3;
  const int u0 = r * U;
  const T* wd = w + (size_t)d * 4 * H * H;

  for (int i = threadIdx.x; i < G::SPLIT * NR * LDD; i += kThreads) ds[i] = from_f<T>(0.f);
  // A[k][m] = w_hh[wrow(m)][k]: hidden unit k (this warp's m-tiles) by local gate column m
  uint32_t a[G::MPW][G::KSB][4];
  if constexpr (G::kTC) {
    if (warp < G::WB) {
#pragma unroll
      for (int mm = 0; mm < G::MPW; ++mm) {
        const int k = (warp * G::MPW + mm) * 16 + g8;
#pragma unroll
        for (int ks = 0; ks < G::KSB; ++ks) {
          const int m = ks * 16 + 2 * q4;
          auto at = [&](int mc, int kr) {
            return mc < G::GC ? wd[(size_t)G::wrow(mc, u0) * H + kr] : from_f<T>(0.f);
          };
          a[mm][ks][0] = pack2(at(m, k), at(m + 1, k));
          a[mm][ks][1] = pack2(at(m, k + 8), at(m + 1, k + 8));
          a[mm][ks][2] = pack2(at(m + 8, k), at(m + 9, k));
          a[mm][ks][3] = pack2(at(m + 8, k + 8), at(m + 9, k + 8));
        }
      }
    }
  } else {
    load_ws<G>(ws, wd, u0, H);
  }

  // a step's inputs of an item: gates (4), cell after, cell before, dout
  struct In {
    float2 g[4], cn, cp, dy;
  };
  auto load = [&](In& x, int n, int j0, int t) {
    const size_t row = (size_t)(d * B + row0 + n) * nT + t;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      x.g[q] = *reinterpret_cast<const float2*>(gsave + row * 4 * H + q * H + u0 + j0);
    x.cn = *reinterpret_cast<const float2*>(csave + row * H + u0 + j0);
    x.cp = t ? *reinterpret_cast<const float2*>(csave + (row - 1) * H + u0 + j0)
             : make_float2(0.f, 0.f);
    x.dy = *reinterpret_cast<const float2*>(dout + row * H + u0 + j0);
  };
  float dh[PPT][2], dc[PPT][2];
  In xn[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    int n, j0;
    dh[i][0] = dh[i][1] = dc[i][0] = dc[i][1] = 0.f;
    if (item<G>(i, n, j0) && row0 + n < B) load(xn[i], n, j0, nT - 1);
  }
  cl.sync();

  for (int t = nT - 1; t >= 0; --t) {
    In xc[PPT];
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      int n, j0;
      xc[i] = xn[i];
      if (item<G>(i, n, j0) && row0 + n < B && t > 0) load(xn[i], n, j0, t - 1);
    }
    // partial dh of step t + 1's dgates, from every source CTA
    const float* rd = red + ((t + 1) & 1) * kCL * U * LDG;
    float dgv[PPT][4][2];
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      int n, j0;
      if (!item<G>(i, n, j0) || row0 + n >= B) continue;
      const bool valid = in_len(lens, row0 + n, t, nT, rev);
      const In& x = xc[i];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float rec = 0.f;
        if (t + 1 < nT) {
#pragma unroll
          for (int s = 0; s < kCL; ++s) rec += rd[(s * U + j0 + u) * LDG + n];
          rec = rnd<T>(rec);
        }
        const float dhs = dh[i][u] + rec;
        if (!valid) {  // the state passed through: no gradient reaches the gates
          dh[i][u] = dhs;
#pragma unroll
          for (int q = 0; q < 4; ++q) dgv[i][q][u] = 0.f;
          continue;
        }
        const float gi = u ? x.g[0].y : x.g[0].x, gf = u ? x.g[1].y : x.g[1].x;
        const float gg_ = u ? x.g[2].y : x.g[2].x, go = u ? x.g[3].y : x.g[3].x;
        const float cn = u ? x.cn.y : x.cn.x, cp = u ? x.cp.y : x.cp.x;
        const float dy = u ? x.dy.y : x.dy.x;
        const float ig = sigm(gi), fg = sigm(gf), gg = tanhf(gg_), og = sigm(go);
        const float tc = tanhf(cn);
        const float dhn = dhs + dy;
        const float dct = dc[i][u] + dhn * og * (1.f - tc * tc);
        dgv[i][0][u] = dct * gg * ig * (1.f - ig);
        dgv[i][1][u] = dct * cp * fg * (1.f - fg);
        dgv[i][2][u] = dct * ig * (1.f - gg * gg);
        dgv[i][3][u] = dhn * tc * og * (1.f - og);
        dc[i][u] = dct * fg;
        dh[i][u] = 0.f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        T* dst = ds + n * LDD + q * U + j0;
        if constexpr (G::kTC) {
          const T h0 = from_f<T>(dgv[i][q][0]), h1 = from_f<T>(dgv[i][q][1]);
          *reinterpret_cast<uint32_t*>(dst) = pack2(h0, h1);
          *reinterpret_cast<uint32_t*>(dst + NR * LDD) =
              pack2(from_f<T>(dgv[i][q][0] - to_f(h0)), from_f<T>(dgv[i][q][1] - to_f(h1)));
        } else {
          *reinterpret_cast<float2*>(dst) = make_float2(dgv[i][q][0], dgv[i][q][1]);
        }
      }
    }
    __syncthreads();
    if (t > 0) {  // partial dh = dg . w_hh over this CTA's gate columns, to each unit's owner
      float* wr = red + (t & 1) * kCL * U * LDG + r * U * LDG;
      if constexpr (G::kTC) {
        if (warp < G::WB) {
          float acc[G::MPW][NT][4] = {};
#pragma unroll
          for (int s = 0; s < G::SPLIT; ++s)
#pragma unroll
            for (int ks = 0; ks < G::KSB; ++ks)
#pragma unroll
              for (int nt = 0; nt < NT; ++nt) {
                const T* db = ds + (s * NR + nt * 8 + g8) * LDD + ks * 16 + 2 * q4;
                const uint32_t b0 = ld2(db), b1 = ld2(db + 8);
#pragma unroll
                for (int mm = 0; mm < G::MPW; ++mm) mma16816<T>(acc[mm][nt], a[mm][ks], b0, b1);
              }
#pragma unroll
          for (int mm = 0; mm < G::MPW; ++mm)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int k = (warp * G::MPW + mm) * 16 + g8 + 8 * half;
              float* dst = cl.map_shared_rank(wr, k / U) + (k % U) * LDG + 2 * q4;
#pragma unroll
              for (int nt = 0; nt < NT; ++nt)
                *reinterpret_cast<float2*>(dst + nt * 8) =
                    make_float2(acc[mm][nt][2 * half], acc[mm][nt][2 * half + 1]);
            }
        }
      } else {
        for (int o = threadIdx.x; o < H * NR; o += kThreads) {
          const int k = o % H, n = o / H;
          const float* dr = reinterpret_cast<const float*>(ds) + n * LDD;
          float s = 0.f;
#pragma unroll 8
          for (int m = 0; m < G::GC; ++m) s = fmaf(ws[m * G::LDH + k], dr[m], s);
          cl.map_shared_rank(wr, k / U)[(k % U) * LDG + n] = s;
        }
      }
    }
    cluster_arrive();
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      int n, j0;
      if (!item<G>(i, n, j0) || row0 + n >= B) continue;
      const size_t row = (size_t)(d * B + row0 + n) * nT + t;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<float2*>(dg + row * 4 * H + q * H + u0 + j0) =
            make_float2(dgv[i][q][0], dgv[i][q][1]);
    }
    cluster_wait();
  }
}

// ------------------------------------------------------------- launching

cudaError_t smem_attr(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

struct Call {
  int D, B, T, rev;
  const void* w;
  const int* lens;
  const float *gx, *bias, *dout, *gsave, *csave;
  float *out, *gout, *cout, *dg;
  cudaStream_t s;
};

template <typename T, int H, int NT>
cudaError_t launch(const Call& c, bool fwd) {
  using G = Geo<T, H, NT>;
  const dim3 grid(kCL, c.D, cdiv(c.B, G::NR));
  const T* w = static_cast<const T*>(c.w);
  cudaError_t e;
  if (fwd) {
    if ((e = smem_attr((const void*)enc_lstm_fwd<T, H, NT>, G::kFwd)) != cudaSuccess) return e;
    enc_lstm_fwd<T, H, NT><<<grid, kThreads, G::kFwd, c.s>>>(c.B, c.T, c.rev, c.gx, w, c.bias,
                                                             c.lens, c.out, c.gout, c.cout);
  } else {
    if ((e = smem_attr((const void*)enc_lstm_bwd<T, H, NT>, G::kBwd)) != cudaSuccess) return e;
    enc_lstm_bwd<T, H, NT><<<grid, kThreads, G::kBwd, c.s>>>(c.B, c.T, c.rev, w, c.lens, c.dout,
                                                             c.gsave, c.csave, c.dg);
  }
  return cudaGetLastError();
}

// Row tiles of 8 up to B = 8, of 16 beyond (2D to 2D * ceil(B / 16) clusters).
template <typename T, int H>
cudaError_t launch_nt(const Call& c, bool fwd) {
  return c.B <= 8 ? launch<T, H, 1>(c, fwd) : launch<T, H, 2>(c, fwd);
}

template <typename T>
cudaError_t launch_h(const Call& c, int H, bool fwd) {
  switch (H) {
    case 16: return launch_nt<T, 16>(c, fwd);
    case 32: return launch_nt<T, 32>(c, fwd);
    case 64: return launch_nt<T, 64>(c, fwd);
    case 128: return launch_nt<T, 128>(c, fwd);
    case 256: return launch_nt<T, 256>(c, fwd);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t run(int dtype, int H, const Call& c, bool fwd) {
  if (c.D < 1 || c.D > 2 || c.B < 1 || c.T < 1) return cudaErrorInvalidValue;
  switch (dtype) {
    case kF32: return launch_h<float>(c, H, fwd);
    case kBF16: return launch_h<__nv_bfloat16>(c, H, fwd);
    case kF16: return launch_h<__half>(c, H, fwd);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// K7: the forward recurrence of D (1 or 2) directions over B rows and T
// steps, hidden size H (16, 32, 64, 128 or 256), stream type dtype (StreamType).
// rev_mask bit d: direction d scans a reversed sequence (lengths count from
// its end).  gx (D, B, T, 4H) float32; w (D, 4H, H) in the stream type;
// bias (D, 4H) float32; lens (B,) int32 or null (every step inside).
// Writes out (D, B, T, H); gsave (D, B, T, 4H) and csave (D, B, T, H) where
// not null (both or neither).  Launches on `stream`, does not synchronise;
// returns a cudaError_t.
extern "C" int t2v_encoder_lstm_fwd(int dtype, int D, int B, int T, int H, int rev_mask,
                                    const float* gx, const void* w, const float* bias,
                                    const int* lens, float* out, float* gsave, float* csave,
                                    void* stream) {
  if ((gsave == nullptr) != (csave == nullptr)) return (int)cudaErrorInvalidValue;
  const Call c{D, B, T, rev_mask, w, lens, gx, bias, nullptr, nullptr, nullptr,
               out, gsave, csave, nullptr, static_cast<cudaStream_t>(stream)};
  return (int)run(dtype, H, c, true);
}

// K8: the backward of K7 over its residuals: dout (D, B, T, H) float32, the
// gradient of out; writes dg (D, B, T, 4H) float32.  Other arguments as K7's.
extern "C" int t2v_encoder_lstm_bwd(int dtype, int D, int B, int T, int H, int rev_mask,
                                    const void* w, const int* lens, const float* dout,
                                    const float* gsave, const float* csave, float* dg,
                                    void* stream) {
  const Call c{D, B, T, rev_mask, w, lens, nullptr, nullptr, dout, gsave, csave,
               nullptr, nullptr, nullptr, dg, static_cast<cudaStream_t>(stream)};
  return (int)run(dtype, H, c, false);
}
