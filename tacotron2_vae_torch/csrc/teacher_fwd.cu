// Teacher-forced decoder recurrence, forward over all T steps (kernel K3).
//
// Replaces: tacotron2_vae_tpu/ops/pallas/teacher_fwd.py::_kernel (via
// fwd_pallas): per step the attention LSTM on [prenet_t, ctx, h_att], the
// location-sensitive attention (query, 31-tap location conv over
// [w_prev, w_cum], loc_dense, tanh(q + loc + pmem) . v, additive mask,
// softmax, context, w_cum += w), the decoder LSTM on [h_att, ctx, h_dec],
// and recurrent dropout by pre-scaled masks on h and c of both LSTMs.
// Emits ys = (h_dec, ctx, w) and the residuals (g_att, g_dec in the stream
// dtype; c_att_prev, c_dec_prev, h_att in float32).
//
// What bounds it on an H100: the two LSTM products, (B x 1792) . (1792 x
// 4096) and (B x 2560) . (2560 x 4096) per step at the defaults: 2.35
// GFLOP per step at B=64 (1.2 TFLOP over T=512); against the bf16 tensor
// rate that is ~1.2 ms per call, against the 36 MB of bf16 weights read
// every step ~5.6 ms.  In bf16 the products run on the tensor cores
// (mma.sync m16n8k16, one 16 x 32 tile per warp, no TMA or pipelining), so
// tile loads and the per-step dependency chain bound them; in float32 they
// run in FFMA (67 TFLOP/s peak, ~18 ms at best).
//
// Design: per step five kernels, launched by the host loop in
// t2v_teacher_fwd on the caller's stream (one ctypes call per direction):
//   lstm_gemm attention LSTM product (lstm_gemm_tc in bf16): each block
//             owns 8 hidden units, i.e.
//             their 4 gate columns (32 columns of the (K, 4H) weight), for
//             all B <= 64 rows and one of kSplit K-chunks (512 blocks at
//             the defaults); 128 threads, each 4 rows x (4 gates of one
//             unit); 16-byte loads one tile ahead.  The input rows are read
//             straight from the output streams of the previous step (no
//             concatenation copies), rounded to the stream dtype as they
//             are staged.
//   lstm_cell sums the K-chunk partials in order, adds the bias, stores g in
//             the stream dtype, updates the cell in float32, applies the
//             dropout masks.
//   att_fwd   one block of 1024 threads per row: query, location conv,
//             loc_dense, energies, mask, softmax, context, w_cum += w
//             (teacher_common.cuh).
//   lstm_gemm + lstm_cell  the decoder LSTM on [h_att_t, ctx_t, h_dec_{t-1}].
// Per-step kernels were chosen over a persistent kernel for the reason
// K1 gives (different parallel layouts per phase, grid-wide barriers).

#include "teacher_common.cuh"

namespace {

using namespace t2v;

constexpr int kRows = 64;     // batch rows per tile (all of B)
constexpr int kUnits = 8;     // hidden units per block
constexpr int kBK = 32;       // k per shared tile
constexpr int kGemmThreads = 128;
constexpr int kXs = kRows + 4;  // padded row stride of the staged x tile

struct Seg3 {
  const float* p[3];
  int ld[3];
  int w[3];
};

// Partial LSTM gate sums for B <= 64 rows over one K-chunk: part[ks][b][n]
// = sum_{k in chunk ks} round(x[b][k]) W[k][n] for the block's 32 columns
// n = g*H + j (4 gates of 8 units); W (K, 4H) in the stream dtype.  Tiles
// are loaded with 16-byte vectors one tile ahead of the products.
template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
lstm_gemm(Seg3 x, int K, int kchunk, const T* __restrict__ W, int H, int B,
          float* __restrict__ part) {
  __shared__ __align__(16) float xs[kBK][kXs];
  __shared__ __align__(16) float ws[kBK][kUnits][4];
  const int tid = threadIdx.x, tx = tid % kUnits, ty = tid / kUnits;
  const int j0 = blockIdx.x * kUnits, H4 = 4 * H;
  const int kbeg = blockIdx.y * kchunk, kend = min(K, kbeg + kchunk);
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[r][g] = 0.0f;
  float4 xr[4];
  float wr[8];
  const int wk = tid / 4, wg = tid % 4;  // this thread's weight vector: row k0+wk, gate wg
  auto load = [&](int k0) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = tid + u * kGemmThreads, row = i / 8, k = k0 + 4 * (i % 8);
      xr[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (row < B && k < kend) {
        int seg = 0, kk = k;
        while (kk >= x.w[seg]) kk -= x.w[seg++];
        xr[u] = *reinterpret_cast<const float4*>(x.p[seg] + (size_t)row * x.ld[seg] + kk);
      }
    }
    const int k = k0 + wk;
    if (k < kend) {
      Vec8<T>::load(W + (size_t)k * H4 + wg * H + j0, wr);
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u) wr[u] = 0.0f;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = tid + u * kGemmThreads, row = i / 8, kq = 4 * (i % 8);
      xs[kq][row] = rnd<T>(xr[u].x);
      xs[kq + 1][row] = rnd<T>(xr[u].y);
      xs[kq + 2][row] = rnd<T>(xr[u].z);
      xs[kq + 3][row] = rnd<T>(xr[u].w);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) ws[wk][u][wg] = wr[u];
  };
  if (kbeg < kend) load(kbeg);
  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    store();
    __syncthreads();
    if (k0 + kBK < kend) load(k0 + kBK);
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 xv = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 wv = *reinterpret_cast<const float4*>(&ws[kk][tx][0]);
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
      const float wa[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] = fmaf(xa[r], wa[g], acc[r][g]);
    }
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.y * B * H4;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int b = ty * 4 + r;
    if (b < B)
#pragma unroll
      for (int g = 0; g < 4; ++g) out[(size_t)b * H4 + g * H + j0 + tx] = acc[r][g];
  }
}

// The bf16 form of lstm_gemm on the tensor cores: x rounded to bf16 as it
// is staged, W tiles transposed into (column, k) order in shared memory;
// each of the 4 warps computes 16 rows x the block's 32 columns with
// mma.sync m16n8k16 (float32 accumulation), column n = gate * 8 + unit.
__global__ void __launch_bounds__(kGemmThreads)
lstm_gemm_tc(Seg3 x, int K, int kchunk, const __nv_bfloat16* __restrict__ W, int H, int B,
             float* __restrict__ part) {
  constexpr int kLd = kBK + 8;  // bf16 row stride: conflict-free fragment reads
  __shared__ __align__(16) __nv_bfloat16 xs[kRows * kLd];
  __shared__ __align__(16) __nv_bfloat16 ws[4 * kUnits * kLd];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int j0 = blockIdx.x * kUnits, H4 = 4 * H;
  const int kbeg = blockIdx.y * kchunk, kend = min(K, kbeg + kchunk);
  float acc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
  float4 xr[4];
  uint4 wr;
  const int wk = tid / 4, wg = tid % 4;  // this thread's weight vector: row k0+wk, gate wg
  auto load = [&](int k0) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = tid + u * kGemmThreads, row = i / 8, k = k0 + 4 * (i % 8);
      xr[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (row < B && k < kend) {
        int seg = 0, kk = k;
        while (kk >= x.w[seg]) kk -= x.w[seg++];
        xr[u] = *reinterpret_cast<const float4*>(x.p[seg] + (size_t)row * x.ld[seg] + kk);
      }
    }
    const int k = k0 + wk;
    wr = k < kend ? *reinterpret_cast<const uint4*>(W + (size_t)k * H4 + wg * H + j0)
                  : make_uint4(0u, 0u, 0u, 0u);
  };
  auto store = [&]() {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = tid + u * kGemmThreads, row = i / 8, kq = 4 * (i % 8);
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(xs + row * kLd + kq);
      dst[0] = __floats2bfloat162_rn(xr[u].x, xr[u].y);
      dst[1] = __floats2bfloat162_rn(xr[u].z, xr[u].w);
    }
    const __nv_bfloat16* w8 = reinterpret_cast<const __nv_bfloat16*>(&wr);
#pragma unroll
    for (int u = 0; u < 8; ++u) ws[(wg * kUnits + u) * kLd + wk] = w8[u];
  };
  if (kbeg < kend) load(kbeg);
  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    store();
    __syncthreads();
    if (k0 + kBK < kend) load(k0 + kBK);
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) warp_mma_16x32(acc, xs, kLd, 16 * warp, ws, kLd, ks);
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.y * B * H4;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * warp + g + (e >= 2 ? 8 : 0), n = nt * 8 + t2 + (e & 1);
      if (row < B) out[(size_t)row * H4 + (n / kUnits) * H + j0 + n % kUnits] = acc[nt][e];
    }
}

// LSTM cell from the partial sums, one thread per (row, unit): g = sum of
// the kSplit partials (in order) + bias, stored in the stream dtype;
// c = sig(f) c_prev + sig(i) tanh(g), h = sig(o) tanh(c); then h *= mh,
// c *= mc when masks are given.
template <typename T>
__global__ void lstm_cell(const float* __restrict__ part, int nsplit,
                          const float* __restrict__ bias, int H, int B,
                          const float* __restrict__ c_prev, float* __restrict__ c_next,
                          float* __restrict__ h_out, T* __restrict__ g_out,
                          const T* __restrict__ mh, const T* __restrict__ mc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * H) return;
  const int b = i / H, j = i - b * H, H4 = 4 * H;
  float gv[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    float acc = part[(size_t)b * H4 + g * H + j];
    for (int ks = 1; ks < nsplit; ++ks) acc += part[((size_t)ks * B + b) * H4 + g * H + j];
    gv[g] = acc + bias[g * H + j];
    g_out[(size_t)b * H4 + g * H + j] = from_f<T>(gv[g]);
  }
  float c = sigm(gv[1]) * c_prev[i] + sigm(gv[0]) * tanhf(gv[2]);
  float h = sigm(gv[3]) * tanhf(c);
  if (mh != nullptr) {
    h *= to_f<T>(mh[i]);
    c *= to_f<T>(mc[i]);
  }
  h_out[i] = h;
  if (c_next != nullptr) c_next[i] = c;
}

struct FwdArgs {
  Dims d;
  const float *wq, *locw, *ldw, *v, *mem, *pmem, *addmask;
  const float* zeros;
  float *h_att, *ctx, *w, *wcum;
};

// Attention for one row per block at step t.
__global__ void __launch_bounds__(kAttThreads) att_fwd(FwdArgs a, int t) {
  extern __shared__ __align__(16) float sm[];
  const Dims& d = a.d;
  const AttSmem s(sm, d);
  const int b = blockIdx.x, S = d.S, E = d.E;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const size_t row = (size_t)t * d.B + b;
  const float* w_prev = t > 0 ? a.w + (row - d.B) * S : a.zeros;
  float* wcum = a.wcum + (size_t)b * S;
  att_stage(s, d, a.h_att + row * d.H, w_prev, wcum, a.ldw, a.locw);
  att_query_loc(s, d, a.wq);

  const float* pm = a.pmem + (size_t)b * S * d.A;
  for (int p = warp; p < S; p += nw) {
    float acc = 0.0f;
    for (int u = lane; u < d.A; u += 32) acc += a.v[u] * att_tanh(s, d, pm, p, u);
    acc = warp_sum(acc);
    if (lane == 0) s.e[p] = acc + a.addmask[(size_t)b * S + p];
  }
  __syncthreads();
  float m = -3.402823466e38f;
  for (int p = threadIdx.x; p < S; p += blockDim.x) m = fmaxf(m, s.e[p]);
  m = block_reduce<true>(m, s.red);
  float sum = 0.0f;
  for (int p = threadIdx.x; p < S; p += blockDim.x) {
    const float ex = expf(s.e[p] - m);
    s.e[p] = ex;
    sum += ex;
  }
  sum = block_reduce<false>(sum, s.red);
  for (int p = threadIdx.x; p < S; p += blockDim.x) {
    const float wt = s.e[p] / sum;
    s.e[p] = wt;
    a.w[row * S + p] = wt;
    wcum[p] += wt;
  }
  __syncthreads();
  // context = w . memory, positions split over npc groups of threads
  const float* mem = a.mem + (size_t)b * S * E;
  const int npc = (int)blockDim.x >= E ? (int)blockDim.x / E : 1;
  for (int i = threadIdx.x; i < npc * E; i += blockDim.x) {
    const int k = i % E, pp = i / E;
    float acc = 0.0f;
#pragma unroll 4
    for (int p = pp; p < S; p += npc) acc = fmaf(s.e[p], mem[(size_t)p * E + k], acc);
    s.part[i] = acc;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < E; k += blockDim.x) {
    float acc = 0.0f;
    for (int pp = 0; pp < npc; ++pp) acc += s.part[pp * E + k];
    a.ctx[row * E + k] = acc;
  }
}

cudaError_t smem_attr(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
cudaError_t run(const Dims& d, const void* attn_w_, const float* attn_b, const void* dec_w_,
                const float* dec_b, FwdArgs fa, const float* prenet, const void* m1_,
                const void* m2_, const void* m3_, const void* m4_, float* h_dec,
                void* g_att_, void* g_dec_, float* c_att, float* c_dec, float* part,
                cudaStream_t st) {
  const T* attn_w = static_cast<const T*>(attn_w_);
  const T* dec_w = static_cast<const T*>(dec_w_);
  const T *m1 = static_cast<const T*>(m1_), *m2 = static_cast<const T*>(m2_);
  const T *m3 = static_cast<const T*>(m3_), *m4 = static_cast<const T*>(m4_);
  T* g_att = static_cast<T*>(g_att_);
  T* g_dec = static_cast<T*>(g_dec_);
  const size_t smem = (size_t)AttSmem::floats(d, kAttThreads) * sizeof(float);
  cudaError_t err = smem_attr((const void*)att_fwd, smem);
  if (err != cudaSuccess) return err;
  const int B = d.B, H = d.H, E = d.E, P = d.P;
  const size_t BH = (size_t)B * H;
  const int grid = H / kUnits, cells = (B * H + 255) / 256;
  const int Ka = P + E + H, Kd = 2 * H + E;
  auto chunk = [](int K) { return (K / kSplit + kBK - 1) / kBK * kBK; };
  // bf16 products on the tensor cores, float32 ones in FFMA
  auto gemm = [&](const Seg3& x, int K, const T* W) {
    if constexpr (sizeof(T) == 2)
      lstm_gemm_tc<<<dim3(grid, kSplit), kGemmThreads, 0, st>>>(x, K, chunk(K), W, H, B, part);
    else
      lstm_gemm<T><<<dim3(grid, kSplit), kGemmThreads, 0, st>>>(x, K, chunk(K), W, H, B, part);
  };
  for (int t = 0; t < d.T; ++t) {
    const size_t o = (size_t)t * BH;
    const bool first = t == 0, last = t + 1 == d.T;
    const Seg3 xa{{prenet + (size_t)t * B * P, first ? fa.zeros : fa.ctx + (size_t)(t - 1) * B * E,
                   first ? fa.zeros : fa.h_att + o - BH},
                  {P, E, H}, {P, E, H}};
    gemm(xa, Ka, attn_w);
    lstm_cell<T><<<cells, 256, 0, st>>>(part, kSplit, attn_b, H, B, c_att + o,
                                        last ? nullptr : c_att + o + BH, fa.h_att + o,
                                        g_att + 4 * o, m1 ? m1 + o : nullptr,
                                        m2 ? m2 + o : nullptr);
    att_fwd<<<B, kAttThreads, smem, st>>>(fa, t);
    const Seg3 xd{{fa.h_att + o, fa.ctx + (size_t)t * B * E, first ? fa.zeros : h_dec + o - BH},
                  {H, E, H}, {H, E, H}};
    gemm(xd, Kd, dec_w);
    lstm_cell<T><<<cells, 256, 0, st>>>(part, kSplit, dec_b, H, B, c_dec + o,
                                        last ? nullptr : c_dec + o + BH, h_dec + o,
                                        g_dec + 4 * o, m3 ? m3 + o : nullptr,
                                        m4 ? m4 + o : nullptr);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// dtype: 0 = float32 stream, 1 = bfloat16.  Shapes (row-major): attn_w
// (P+E+H, 4H), dec_w (2H+E, 4H) in the stream dtype; attn_b, dec_b (4H);
// query_w (H, A); loc_w (K, 2, F); loc_dense_w (F, A); v (A); prenet
// (T, B, P); memory (B, S, E); pmem (B, S, A); add_mask (B, S); masks m1..m4
// (T, B, H) in the stream dtype, or all null (dropout off).  Outputs: h_dec,
// h_att (T, B, H), ctx (T, B, E), w (T, B, S) float32; g_att, g_dec
// (T, B, 4H) stream dtype; c_att, c_dec (T, B, H) the cell state before each
// step, zeroed by the caller.  Work: wcum (B, S) and zeros (>= B*max(H,E,S))
// zeroed; part (kSplit, B, 4H) float32.  Returns a cudaError_t (0 on success).
extern "C" int t2v_teacher_fwd(
    int dtype, int T, int B, int S, int E, int H, int P, int A, int F, int K,
    const void* attn_w, const float* attn_b, const void* dec_w, const float* dec_b,
    const float* query_w, const float* loc_w, const float* loc_dense_w, const float* v,
    const float* prenet, const float* memory, const float* pmem, const float* add_mask,
    const void* m1, const void* m2, const void* m3, const void* m4,
    float* h_dec, float* ctx, float* w, void* g_att, void* g_dec, float* c_att, float* c_dec,
    float* h_att, float* wcum, const float* zeros, float* part, void* stream) {
  if (B < 1 || B > kRows || H % kUnits != 0 || K % 2 == 0 || T < 1 || P % 4 || E % 4 ||
      (m1 == nullptr) != (m4 == nullptr))
    return (int)cudaErrorInvalidValue;
  const Dims d{T, B, S, E, H, P, A, F, K};
  FwdArgs fa{d, query_w, loc_w, loc_dense_w, v, memory, pmem, add_mask, zeros, h_att, ctx, w, wcum};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 1 ? run<__nv_bfloat16>(d, attn_w, attn_b, dec_w, dec_b, fa, prenet, m1, m2, m3, m4,
                                      h_dec, g_att, g_dec, c_att, c_dec, part, st)
                 : run<float>(d, attn_w, attn_b, dec_w, dec_b, fa, prenet, m1, m2, m3, m4, h_dec,
                              g_att, g_dec, c_att, c_dec, part, st);
  return (int)err;
}
