// Teacher-forced decoder recurrence, reverse-time BPTT over all T steps
// (kernel K4).
//
// Replaces: tacotron2_vae_tpu/ops/pallas/teacher_fwd.py::_bwd_kernel (via
// bwd_pallas): per reverse step the decoder-LSTM backward (c recomputed
// from the saved gates, m3/m4 applied to dh/dc first), dx_dec = dg_dec .
// dec_w^T, the attention backward (dw from dctx . memory and the carries,
// softmax backward, tanh recomputed, dta = de v (1 - ta^2), dq, the F-wide
// dloc = dta . loc_dense^T, the transposed location conv into the w_prev /
// w_cum carries), dh_att += dq . query_w^T, the attention-LSTM backward and
// dx_att = dg_att . attn_w^T (dpn, dctx_prev, dh_att_prev).  Streams out
// dg_att, dg_dec, dloc (stream dtype), dpn, dctx (float32) and accumulates
// dv, dWq, dWld = sum loc^T dta (directly: the Pallas kernel's G
// accumulator and F x F solve were a Mosaic reshape workaround) and dpmem.
//
// What bounds it on an H100: the two dx products, (B x 4096) . (4096 x
// 2560) and (B x 4096) . (4096 x 1792) per step, contracting the (K, 4H)
// weights over their 4H axis (no transposed copy): 2.35 GFLOP per step at
// B=64, plus the attention backward (~0.3 GFLOP per step).  As in K3 the
// bf16 products run on the tensor cores (gemm_nt_tc, mma.sync m16n8k16),
// bound by tile loads and the per-step dependency chain rather than by the
// 36 MB weight stream; the float32 ones run in FFMA.
//
// Design: per reverse step seven kernels from the host loop:
//   lstm_bwd  decoder LSTM backward, elementwise over (B, H)
//   gemm_nt   dx_dec = dg_dec . dec_w^T: 64 rows x 32 columns x one of
//             kSplit chunks of the 4H axis per block, 16-byte loads one
//             tile ahead; sum_split adds the chunks in order
//   att_bwd   one block of 1024 threads per row (teacher_common.cuh
//             recompute + backward); the loc_dense and dloc rows in shared
//             memory are padded by one float, since warps read them down a
//             column (32-way bank conflicts otherwise)
//   lstm_bwd  attention LSTM backward, and dWq[j, :] += sum_b h_att[b, j]
//             dq[b, :] for the block's units
//   gemm_nt   dx_att = dg_att . attn_w^T; sum_split writes it into dpn[t]
//             and the dctx / dh_att carries
// Cross-row sums (dv, dWld) go to per-row partials that each row's block
// owns across all steps and are summed over rows in a fixed order at the
// end, so the kernel is reproducible run to run; dWq rows and dpmem rows
// each have one owner.  No float atomics.

#include "teacher_common.cuh"

namespace {

using namespace t2v;

constexpr int kRows = 64;
constexpr int kCols = 32;   // output columns per gemm_nt block
constexpr int kBN = 32;     // reduction (4H) chunk per shared tile
constexpr int kGemmThreads = 128;
constexpr int kUnits = 8;   // hidden units per lstm_bwd block
constexpr int kEwThreads = 256;

struct OutSeg3 {
  float* p[3];
  int ld[3];
  int w[3];
};

// Partial products for B <= 64 rows over one chunk of the reduction axis:
// part[ns][b][k] = sum_{n in chunk ns} A[b][n] W[k][n], A (B, N) and W
// (K, N) in the stream dtype, float32 sums; 32 output columns per block.
// Tiles are loaded with 16-byte vectors one tile ahead of the products.
template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
gemm_nt(const T* __restrict__ A, int N, const T* __restrict__ W, int K, int B, int nchunk,
        float* __restrict__ part) {
  __shared__ __align__(16) float as[kBN][kRows + 4];
  __shared__ __align__(16) float ws[kBN][kCols + 4];
  const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;
  const int kb = blockIdx.x * kCols;
  const int nbeg = blockIdx.y * nchunk, nend = min(N, nbeg + nchunk);
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
  float ar[2][8], wr[8];
  auto load = [&](int n0) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = tid + u * kGemmThreads, row = i / 4, n = n0 + 8 * (i % 4);
      if (row < B && n < nend) {
        Vec8<T>::load(A + (size_t)row * N + n, ar[u]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) ar[u][e] = 0.0f;
      }
    }
    const int kc = tid / 4, n = n0 + 8 * (tid % 4);
    if (kb + kc < K && n < nend) {
      Vec8<T>::load(W + (size_t)(kb + kc) * N + n, wr);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) wr[e] = 0.0f;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = tid + u * kGemmThreads, row = i / 4, nq = 8 * (i % 4);
#pragma unroll
      for (int e = 0; e < 8; ++e) as[nq + e][row] = ar[u][e];
    }
    const int kc = tid / 4, nq = 8 * (tid % 4);
#pragma unroll
    for (int e = 0; e < 8; ++e) ws[nq + e][kc] = wr[e];
  };
  if (nbeg < nend) load(nbeg);
  for (int n0 = nbeg; n0 < nend; n0 += kBN) {
    store();
    __syncthreads();
    if (n0 + kBN < nend) load(n0 + kBN);
#pragma unroll 8
    for (int nn = 0; nn < kBN; ++nn) {
      const float4 av = *reinterpret_cast<const float4*>(&as[nn][ty * 4]);
      const float4 wv = *reinterpret_cast<const float4*>(&ws[nn][tx * 4]);
      const float aa[4] = {av.x, av.y, av.z, av.w};
      const float wc[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(aa[r], wc[c], acc[r][c]);
    }
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.y * B * K;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int b = ty * 4 + r;
    if (b >= B) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = kb + tx * 4 + c;
      if (k < K) out[(size_t)b * K + k] = acc[r][c];
    }
  }
}

// The bf16 form of gemm_nt on the tensor cores: the A and W tiles are
// copied to shared memory as they are ((row, n) order, n contiguous, which
// is the column-major B operand W^T needs); each of the 4 warps computes
// 16 rows x the block's 32 output columns with mma.sync m16n8k16.
__global__ void __launch_bounds__(kGemmThreads)
gemm_nt_tc(const __nv_bfloat16* __restrict__ A, int N, const __nv_bfloat16* __restrict__ W,
           int K, int B, int nchunk, float* __restrict__ part) {
  constexpr int kLd = kBN + 8;  // bf16 row stride: conflict-free fragment reads
  __shared__ __align__(16) __nv_bfloat16 as[kRows * kLd];
  __shared__ __align__(16) __nv_bfloat16 ws[kCols * kLd];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kb = blockIdx.x * kCols;
  const int nbeg = blockIdx.y * nchunk, nend = min(N, nbeg + nchunk);
  float acc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
  uint4 ar[2], wr;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  auto load = [&](int n0) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = tid + u * kGemmThreads, row = i / 4, n = n0 + 8 * (i % 4);
      ar[u] = row < B && n < nend ? *reinterpret_cast<const uint4*>(A + (size_t)row * N + n)
                                  : zero;
    }
    const int kc = tid / 4, n = n0 + 8 * (tid % 4);
    wr = kb + kc < K && n < nend ? *reinterpret_cast<const uint4*>(W + (size_t)(kb + kc) * N + n)
                                 : zero;
  };
  auto store = [&]() {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = tid + u * kGemmThreads;
      *reinterpret_cast<uint4*>(as + (i / 4) * kLd + 8 * (i % 4)) = ar[u];
    }
    *reinterpret_cast<uint4*>(ws + (tid / 4) * kLd + 8 * (tid % 4)) = wr;
  };
  if (nbeg < nend) load(nbeg);
  for (int n0 = nbeg; n0 < nend; n0 += kBN) {
    store();
    __syncthreads();
    if (n0 + kBN < nend) load(n0 + kBN);
#pragma unroll
    for (int ks = 0; ks < kBN; ks += 16) warp_mma_16x32(acc, as, kLd, 16 * warp, ws, kLd, ks);
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.y * B * K;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * warp + g + (e >= 2 ? 8 : 0), k = kb + nt * 8 + t2 + (e & 1);
      if (row < B && k < K) out[(size_t)row * K + k] = acc[nt][e];
    }
}

// out = sum of the nsplit partials (in order), written into the column
// segments of ``out``.
__global__ void sum_split(const float* __restrict__ part, int nsplit, int B, int K,
                          OutSeg3 out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * K) return;
  float acc = part[i];
  for (int ns = 1; ns < nsplit; ++ns) acc += part[(size_t)ns * B * K + i];
  const int b = i / K;
  int k = i - b * K, sg = 0;
  while (k >= out.w[sg]) k -= out.w[sg++];
  out.p[sg][(size_t)b * out.ld[sg] + k] = acc;
}

// LSTM cell backward for the block's 8 units and all B rows, from the
// saved pre-activation gates g (B, 4H) and cell state c_prev (c is
// recomputed).  dh = (dh_a [+ dh_b]) * mh, dc = dc_io * mc; writes dg (B, 4H)
// in the stream dtype and dc_io = dc_prev.  With dq given, also
// dwq[j][a] += sum_b hq[b][j] * dq[b][a] for the block's units j.
template <typename T>
__global__ void __launch_bounds__(kEwThreads)
lstm_bwd(int B, int H, const T* __restrict__ g, const float* __restrict__ c_prev,
         const float* __restrict__ dh_a, int ld_a, const float* __restrict__ dh_b, int ld_b,
         float* __restrict__ dc_io, const T* __restrict__ mh, const T* __restrict__ mc,
         T* __restrict__ dg, const float* __restrict__ hq, const float* __restrict__ dq, int A,
         float* __restrict__ dwq) {
  const int j0 = blockIdx.x * kUnits, H4 = 4 * H;
  for (int i = threadIdx.x; i < B * kUnits; i += blockDim.x) {
    const int b = i / kUnits, j = j0 + i % kUnits;
    const size_t bj = (size_t)b * H + j;
    float dh = dh_a[(size_t)b * ld_a + j];
    if (dh_b != nullptr) dh = dh + dh_b[(size_t)b * ld_b + j];
    float dc = dc_io[bj];
    if (mh != nullptr) {
      dh = dh * to_f<T>(mh[bj]);
      dc = dc * to_f<T>(mc[bj]);
    }
    const T* gr = g + (size_t)b * H4 + j;
    const float ig = sigm(to_f<T>(gr[0])), fg = sigm(to_f<T>(gr[H]));
    const float gt = tanhf(to_f<T>(gr[2 * H])), og = sigm(to_f<T>(gr[3 * H]));
    const float cp = c_prev[bj];
    const float c = fg * cp + ig * gt;
    const float tc = tanhf(c);
    const float dct = dc + dh * og * (1.0f - tc * tc);
    T* dr = dg + (size_t)b * H4 + j;
    dr[0] = from_f<T>(dct * gt * ig * (1.0f - ig));
    dr[H] = from_f<T>(dct * cp * fg * (1.0f - fg));
    dr[2 * H] = from_f<T>(dct * ig * (1.0f - gt * gt));
    dr[3 * H] = from_f<T>(dh * tc * og * (1.0f - og));
    dc_io[bj] = dct * fg;
  }
  if (dq == nullptr) return;
  for (int i = threadIdx.x; i < kUnits * A; i += blockDim.x) {
    const int j = j0 + i / A, a = i % A;
    float s = 0.0f;
    for (int b = 0; b < B; ++b) s = fmaf(hq[(size_t)b * H + j], dq[(size_t)b * A + a], s);
    dwq[(size_t)j * A + a] += s;
  }
}

struct BwdArgs {
  Dims d;
  const float *wq, *locw, *ldw, *v, *mem, *pmem;
  const float *dctx_out, *dw_out, *h_att, *w_seq, *w_cum_prev;
  const float* dx_dec;  // (B, 2H+E) of this step
  float *dh_att_c, *dctx_c, *dw_prev_c, *dwcum_c;
  float *dctx_tot, *dh_att, *dq, *dv_part, *dwld_part, *dpmem;
  void* dloc;
};

__host__ __device__ inline int bwd_floats(const Dims& d, int threads) {
  return AttSmem::floats(d, threads) + d.S * d.A + d.S * (d.F + 1) + d.E + d.S + d.A;
}

// Attention backward for one row per block at step t.
template <typename T>
__global__ void __launch_bounds__(kAttThreads) att_bwd(BwdArgs a, int t) {
  extern __shared__ __align__(16) float sm[];
  const Dims& d = a.d;
  const AttSmem s(sm, d);
  const int S = d.S, E = d.E, A = d.A, F = d.F, H = d.H, b = blockIdx.x;
  float* tb = sm + AttSmem::floats(d, blockDim.x);  // (S, A): tanh, then dta
  float* dl = tb + S * A;                            // (S, F) dloc, rows padded to F + 1
  float* dcx = dl + S * (F + 1);                     // (E) dctx
  float* wt = dcx + E;                               // (S) w_t
  float* dqs = wt + S;                               // (A) dq
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const size_t row = (size_t)t * d.B + b;
  const int Kd = 2 * H + E;
  const float* dxd = a.dx_dec + (size_t)b * Kd;
  float* dwp = a.dw_prev_c + (size_t)b * S;
  float* dwc = a.dwcum_c + (size_t)b * S;

  for (int p = threadIdx.x; p < S; p += blockDim.x) wt[p] = a.w_seq[row * S + p];
  for (int k = threadIdx.x; k < E; k += blockDim.x) {
    const float v = dxd[H + k] + a.dctx_out[row * E + k] + a.dctx_c[(size_t)b * E + k];
    dcx[k] = v;
    a.dctx_tot[row * E + k] = v;
  }
  // w_prev = w_{t-1} (zero at t = 0): s.e doubles as its zero row
  for (int p = threadIdx.x; p < S; p += blockDim.x) s.e[p] = 0.0f;
  __syncthreads();
  const float* w_prev = t > 0 ? a.w_seq + (row - d.B) * S : s.e;
  att_stage(s, d, a.h_att + row * H, w_prev, a.w_cum_prev + row * S, a.ldw, a.locw);
  att_query_loc(s, d, a.wq);

  // dw = dw_out + dw_prev + dwcum + dctx . memory[p]  (into s.e)
  const float* mem = a.mem + (size_t)b * S * E;
  for (int p = warp; p < S; p += nw) {
    float acc = 0.0f;
    for (int k = lane; k < E; k += 32) acc = fmaf(dcx[k], mem[(size_t)p * E + k], acc);
    acc = warp_sum(acc);
    if (lane == 0) s.e[p] = a.dw_out[row * S + p] + dwp[p] + dwc[p] + acc;
  }
  __syncthreads();
  float dsum = 0.0f;
  for (int p = threadIdx.x; p < S; p += blockDim.x) dsum += s.e[p] * wt[p];
  dsum = block_reduce<false>(dsum, s.red);
  for (int p = threadIdx.x; p < S; p += blockDim.x) s.e[p] = wt[p] * (s.e[p] - dsum);  // de
  // tanh of every (position, unit), recomputed as the forward did
  const float* pm = a.pmem + (size_t)b * S * A;
  for (int i = threadIdx.x; i < S * A; i += blockDim.x) tb[i] = att_tanh(s, d, pm, i / A, i % A);
  __syncthreads();
  for (int u = threadIdx.x; u < A; u += blockDim.x) {
    float acc = 0.0f;
    for (int p = 0; p < S; ++p) acc = fmaf(tb[p * A + u], s.e[p], acc);
    a.dv_part[(size_t)b * A + u] += acc;
  }
  __syncthreads();
  float* dpm = a.dpmem + (size_t)b * S * A;
  for (int i = threadIdx.x; i < S * A; i += blockDim.x) {
    const float ta = tb[i];
    const float dta = s.e[i / A] * a.v[i % A] * (1.0f - ta * ta);
    tb[i] = dta;
    dpm[i] += dta;
  }
  __syncthreads();
  for (int u = threadIdx.x; u < A; u += blockDim.x) {
    float acc = 0.0f;
    for (int p = 0; p < S; ++p) acc += tb[p * A + u];
    dqs[u] = acc;
    a.dq[(size_t)b * A + u] = acc;
  }
  float* dwld = a.dwld_part + (size_t)b * F * A;
  for (int i = threadIdx.x; i < F * A; i += blockDim.x) {
    const int f = i / A, u = i % A;
    float acc = 0.0f;
    for (int p = 0; p < S; ++p) acc = fmaf(s.loc[p * F + f], tb[p * A + u], acc);
    dwld[i] += acc;
  }
  T* dlo = static_cast<T*>(a.dloc) + row * S * F;
  for (int i = threadIdx.x; i < S * F; i += blockDim.x) {
    const int p = i / F, f = i % F;
    float acc = 0.0f;
    for (int u = 0; u < A; ++u) acc = fmaf(tb[p * A + u], s.ldw[f * (A + 1) + u], acc);
    dl[p * (F + 1) + f] = acc;
    dlo[i] = from_f<T>(acc);
  }
  __syncthreads();
  // transposed location conv: dfeat[p][c] = sum_k,f dloc[p + pad - k][f] loc_w[k][c][f],
  // the taps split over npk groups of threads (partials in tb, free now)
  const int pad = (d.K - 1) / 2;
  const int npk = max(1, min((int)blockDim.x / (2 * S), A / 2));
  for (int i = threadIdx.x; i < npk * 2 * S; i += blockDim.x) {
    const int o = i % (2 * S), pk = i / (2 * S), c = o / S, p = o % S;
    float acc = 0.0f;
    for (int k = pk; k < d.K; k += npk) {
      const int q = p + pad - k;
      if (q < 0 || q >= S) continue;
      for (int f = 0; f < F; ++f) acc = fmaf(dl[q * (F + 1) + f], s.lw[(k * 2 + c) * F + f], acc);
    }
    tb[i] = acc;
  }
  __syncthreads();
  for (int o = threadIdx.x; o < 2 * S; o += blockDim.x) {
    float acc = 0.0f;
    for (int pk = 0; pk < npk; ++pk) acc += tb[pk * 2 * S + o];
    const int c = o / S, p = o % S;
    if (c == 0)
      dwp[p] = acc;
    else
      dwc[p] = acc + dwc[p];
  }
  // dh_att (pre-mask) = dx_dec[:H] + dh_att carry + dq . query_w^T, a warp per unit
  for (int k = warp; k < H; k += nw) {
    float acc = 0.0f;
    for (int u = lane; u < A; u += 32) acc = fmaf(dqs[u], a.wq[(size_t)k * A + u], acc);
    acc = warp_sum(acc);
    if (lane == 0) a.dh_att[(size_t)b * H + k] = dxd[k] + a.dh_att_c[(size_t)b * H + k] + acc;
  }
}

// out[i] = sum over rows b (in order) of part[b][i].
__global__ void sum_rows(const float* __restrict__ part, int B, int n, float* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    float acc = 0.0f;
    for (int b = 0; b < B; ++b) acc += part[(size_t)b * n + i];
    out[i] = acc;
  }
}

template <typename T>
cudaError_t run(BwdArgs ba, const void* attn_w_, const void* dec_w_, const void* m1_,
                const void* m2_, const void* m3_, const void* m4_, const float* dh_dec_out,
                const void* g_att_, const void* g_dec_, const float* c_att_prev,
                const float* c_dec_prev, void* dg_att_, void* dg_dec_, float* dpn, float* dv,
                float* dwq, float* dwld, float* dx_dec, float* dc_att, float* dc_dec,
                float* part, cudaStream_t st) {
  const Dims d = ba.d;
  const T* attn_w = static_cast<const T*>(attn_w_);
  const T* dec_w = static_cast<const T*>(dec_w_);
  const T *m1 = static_cast<const T*>(m1_), *m2 = static_cast<const T*>(m2_);
  const T *m3 = static_cast<const T*>(m3_), *m4 = static_cast<const T*>(m4_);
  const T* g_att = static_cast<const T*>(g_att_);
  const T* g_dec = static_cast<const T*>(g_dec_);
  T* dg_att = static_cast<T*>(dg_att_);
  T* dg_dec = static_cast<T*>(dg_dec_);
  const size_t smem = (size_t)bwd_floats(d, kAttThreads) * sizeof(float);
  cudaError_t err = smem > 48 * 1024
                        ? cudaFuncSetAttribute((const void*)att_bwd<T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem)
                        : cudaSuccess;
  if (err != cudaSuccess) return err;
  const int B = d.B, H = d.H, E = d.E, P = d.P, A = d.A;
  const int Kd = 2 * H + E, Ka = P + E + H, H4 = 4 * H;
  const size_t BH = (size_t)B * H;
  const int nchunk = (H4 / kSplit + kBN - 1) / kBN * kBN;
  // bf16 products on the tensor cores, float32 ones in FFMA
  auto gemm = [&](const T* a, const T* w, int K) {
    const dim3 grid((K + kCols - 1) / kCols, kSplit);
    if constexpr (sizeof(T) == 2)
      gemm_nt_tc<<<grid, kGemmThreads, 0, st>>>(a, H4, w, K, B, nchunk, part);
    else
      gemm_nt<T><<<grid, kGemmThreads, 0, st>>>(a, H4, w, K, B, nchunk, part);
  };
  const OutSeg3 od{{dx_dec, dx_dec, dx_dec}, {Kd, Kd, Kd}, {Kd, Kd, Kd}};
  for (int t = d.T - 1; t >= 0; --t) {
    const size_t o = (size_t)t * BH;
    lstm_bwd<T><<<H / kUnits, kEwThreads, 0, st>>>(
        B, H, g_dec + 4 * o, c_dec_prev + o, dh_dec_out + o, H, dx_dec + H + E, Kd, dc_dec,
        m3 ? m3 + o : nullptr, m4 ? m4 + o : nullptr, dg_dec + 4 * o, nullptr, nullptr, A,
        nullptr);
    gemm(dg_dec + 4 * o, dec_w, Kd);
    sum_split<<<(B * Kd + 255) / 256, 256, 0, st>>>(part, kSplit, B, Kd, od);
    att_bwd<T><<<B, kAttThreads, smem, st>>>(ba, t);
    lstm_bwd<T><<<H / kUnits, kEwThreads, 0, st>>>(
        B, H, g_att + 4 * o, c_att_prev + o, ba.dh_att, H, nullptr, 0, dc_att,
        m1 ? m1 + o : nullptr, m2 ? m2 + o : nullptr, dg_att + 4 * o, ba.h_att + o, ba.dq, A,
        dwq);
    const OutSeg3 oa{{dpn + (size_t)t * B * P, ba.dctx_c, ba.dh_att_c}, {P, E, H}, {P, E, H}};
    gemm(dg_att + 4 * o, attn_w, Ka);
    sum_split<<<(B * Ka + 255) / 256, 256, 0, st>>>(part, kSplit, B, Ka, oa);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  sum_rows<<<1, 256, 0, st>>>(ba.dv_part, B, A, dv);
  sum_rows<<<(d.F * A + 255) / 256, 256, 0, st>>>(ba.dwld_part, B, d.F * A, dwld);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 stream, 1 = bfloat16.  Inputs (row-major): attn_w
// (P+E+H, 4H), dec_w (2H+E, 4H) stream dtype; query_w (H, A), loc_w
// (K, 2, F), loc_dense_w (F, A), v (A), memory (B, S, E), pmem (B, S, A);
// masks m1..m4 (T, B, H) stream dtype or all null; the output cotangents
// dh_dec (T, B, H), dctx (T, B, E), dw (T, B, S); the forward's g_att, g_dec
// (T, B, 4H) stream dtype, c_att_prev, c_dec_prev, h_att (T, B, H), w_seq
// and w_cum_prev (T, B, S).  Outputs: dg_att, dg_dec (T, B, 4H) and dloc
// (T, B, S, F) stream dtype; dpn (T, B, P), dctx_tot (T, B, E); dv (A),
// dwld (F, A); dwq (H, A) and dpmem (B, S, A) zeroed by the caller.  Work,
// all float32 and zeroed: dx_dec (B, 2H+E), dh_att_c (B, H), dctx_c (B, E),
// dc_att, dc_dec (B, H), dw_prev_c, dwcum_c (B, S), dh_att (B, H), dq
// (B, A), dv_part (B, A), dwld_part (B, F, A); part (kSplit, B,
// max(2H+E, P+E+H)) float32, not zeroed.  Returns a cudaError_t.
extern "C" int t2v_teacher_bwd(
    int dtype, int T, int B, int S, int E, int H, int P, int A, int F, int K,
    const void* attn_w, const void* dec_w, const float* query_w, const float* loc_w,
    const float* loc_dense_w, const float* v, const float* memory, const float* pmem,
    const void* m1, const void* m2, const void* m3, const void* m4,
    const float* dh_dec, const float* dctx, const float* dw, const void* g_att,
    const void* g_dec, const float* c_att_prev, const float* c_dec_prev, const float* h_att,
    const float* w_seq, const float* w_cum_prev,
    void* dg_att, void* dg_dec, float* dpn, float* dctx_tot, void* dloc, float* dv, float* dwq,
    float* dwld, float* dpmem,
    float* dx_dec, float* dh_att_c, float* dctx_c, float* dc_att, float* dc_dec,
    float* dw_prev_c, float* dwcum_c, float* dh_att, float* dq, float* dv_part,
    float* dwld_part, float* part, void* stream) {
  if (B < 1 || B > kRows || H % kUnits != 0 || K % 2 == 0 || T < 1 ||
      (m1 == nullptr) != (m4 == nullptr))
    return (int)cudaErrorInvalidValue;
  const Dims d{T, B, S, E, H, P, A, F, K};
  BwdArgs ba{d, query_w, loc_w, loc_dense_w, v, memory, pmem,
             dctx, dw, h_att, w_seq, w_cum_prev, dx_dec,
             dh_att_c, dctx_c, dw_prev_c, dwcum_c,
             dctx_tot, dh_att, dq, dv_part, dwld_part, dpmem, dloc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 1
          ? run<__nv_bfloat16>(ba, attn_w, dec_w, m1, m2, m3, m4, dh_dec, g_att, g_dec,
                               c_att_prev, c_dec_prev, dg_att, dg_dec, dpn, dv, dwq, dwld,
                               dx_dec, dc_att, dc_dec, part, st)
          : run<float>(ba, attn_w, dec_w, m1, m2, m3, m4, dh_dec, g_att, g_dec, c_att_prev,
                       c_dec_prev, dg_att, dg_dec, dpn, dv, dwq, dwld, dx_dec, dc_att, dc_dec,
                       part, st);
  return (int)err;
}
