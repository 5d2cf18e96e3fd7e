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
// weights over their 4H axis: 2.35 GFLOP per step at B=64 and 36 MB of
// bf16 weights, plus the float32 attention backward (~0.3 GFLOP per step);
// as in K3 the reverse-time dependency chain of short kernels sets the
// time of a call.
//
// Design: per reverse step six kernels (bf16 stream), replayed from one
// CUDA graph of the loop (K3's note gives the reason):
//   lstm_bwd  decoder LSTM backward, elementwise over (B, H), dg_dec
//             stored in bf16: the operand of the next product, written once
//   dx_tc     dx_dec = dg_dec . dec_w^T on wgmma: a CTA owns 128 output
//             columns (N = 128, the weight rows read K-major as stored, no
//             transposed copy, evict-last in L2) for all B <= 64 rows and
//             one of kTcSplit chunks of 4H, fed by a 4-stage TMA ring from a
//             producer warp;
//             the kTcSplit CTAs of a cluster add their partial tiles in
//             order through distributed shared memory and write the sums
//             (the former sum_split)
//   att_query q = h_att . query_w for all rows (shared with K3, so the
//             recomputed tanh matches the forward's bit for bit)
//   att_bwd   a row's attention backward on a cluster of kNC CTAs, each
//             owning S / kNC positions: the dsum reduction and dq through
//             distributed shared memory, the (S x F) . (F x A) recompute
//             and its two transposes (dWld, dloc) register-tiled, the
//             transposed location conv over a dloc halo read from the
//             neighbouring CTAs; 62 KB of shared memory (dead regions
//             reused) and <= 85 registers a thread, so that three CTAs fit
//             an SM and all 64 clusters run in one wave (at two an SM 62
//             fit)
//   lstm_bwd  attention LSTM backward with dh_att += dq . query_w^T and
//             dWq += h_att^T dq for its units: each block reads its 8 rows
//             of query_w, so query_w is read once a step
//   dx_tc     dx_att = dg_att . attn_w^T into dpn[t] and the dctx / dh_att
//             carries
// The float32 stream keeps the FFMA products (gemm_nt + sum_split).  The
// float16 stream (fp16_run) runs the bf16 kernels instantiated on __half;
// its dg and dloc streams are rounded to f16 with no clamp, so a loss
// scale that overflows them gives inf or NaN, which the step must see.
// Cross-row sums (dv, dWld) go to per-(row, CTA) partials owned across all
// steps and summed in a fixed order at the end, so the kernel is
// reproducible run to run; dWq rows and dpmem rows each have one owner.
// No float atomics.

#include "teacher_common.cuh"

namespace {

using namespace t2v;

constexpr int kRows = 64;
constexpr int kCols = 32;   // output columns per gemm_nt block (float32 products)
constexpr int kBN = 32;     // reduction (4H) chunk per shared tile (float32 products)
constexpr int kGemmThreads = 128;
constexpr int kUnits = 8;   // hidden units per lstm_bwd block
constexpr int kEwThreads = 256;
constexpr int kTcCols = 128;              // output columns per dx_tc CTA (N)
constexpr int kTcStages = 4;              // TMA ring depth: 97 KB, two CTAs an SM
constexpr int kPartLd = kTcCols + 8;      // row stride of a CTA's partial tile

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


// dx product in a 2-byte stream type T (bf16 or f16): out (B, Kout) =
// dg[t] (B, 4H) . W^T, W (Kout, 4H), for the CTA's 128 output columns, the
// reduction split over the kTcSplit CTAs of a cluster and summed in rank
// order; the sums go to the column segments of `out`.  mg maps dg (T, B,
// 4H) and mw the weight.
template <typename T>
__global__ void __cluster_dims__(1, kTcSplit, 1) __launch_bounds__(kTcThreads)
dx_tc(const __grid_constant__ CUtensorMap mg, const __grid_constant__ CUtensorMap mw, int t,
      int N4, int Kout, int B, OutSeg3 out) {
  extern __shared__ uint8_t smraw[];
  using R = TcRing<kTcCols, kTcStages>;
  uint8_t* ring = align1024(smraw);
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), kb = blockIdx.x * kTcCols;
  const int ntiles = cdiv(N4, kTileK), per = cdiv(ntiles, kTcSplit);
  const int it0 = min(ntiles, rank * per), it1 = min(ntiles, it0 + per);
  tc_init_barriers<kTcCols, kTcStages>(ring);
  float acc[kTcCols / 2];
#pragma unroll
  for (int i = 0; i < kTcCols / 2; ++i) acc[i] = 0.0f;
  const CUtensorMap *pmg = &mg, *pmw = &mw;
  tc_mainloop<T, kTcCols, kTcStages, false>(
      ring, it0, it1, 16, 1024,
      [&](uint8_t* sa, uint8_t* sb, uint64_t* bar, int it) {
        const int n0 = it * kTileK;
        tma_3d(sa, pmg, bar, n0, 0, t);
        tma_2d_keep(sb, pmw, bar, n0, kb);
      },
      acc);
  __syncthreads();
  float* part = reinterpret_cast<float*>(ring);
  if (threadIdx.x < 128) tc_store<kTcCols>(acc, part, kPartLd);
  cl.sync();
  constexpr int cpc = kTcCols / kTcSplit;  // columns this CTA finishes, 4 a thread
  for (int i = threadIdx.x; i < kRows * cpc / 4; i += blockDim.x) {
    const int b = i / (cpc / 4), c0 = rank * cpc + 4 * (i % (cpc / 4));
    if (b >= B || kb + c0 >= Kout) continue;
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int r = 0; r < kTcSplit; ++r) {
      const float4 v = ld_dsmem4(part + b * kPartLd + c0, r);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int k = kb + c0 + e, sg = 0;
      if (k >= Kout) break;
      while (k >= out.w[sg]) k -= out.w[sg++];
      out.p[sg][(size_t)b * out.ld[sg] + k] = sv[e];
    }
  }
  cl.sync();
}

// LSTM cell backward for the block's 8 units and all B rows, from the
// saved pre-activation gates g (B, 4H) and cell state c_prev (c is
// recomputed).  dh = (dh_a [+ dh_b] [+ dq . query_w^T]) * mh, dc = dc_io *
// mc; writes dg (B, 4H) in the stream dtype and dc_io = dc_prev.  With dq
// given (B, A), the block stages dq (rows padded by one float), its 8 rows
// of query_w (H, A) transposed (unit fastest), so that the warps' reads
// hit distinct banks, and its columns of hq; adds dq . query_w[j]^T to dh
// and accumulates dwq[j][a] += sum_b hq[b][j] dq[b][a] for its units j.
template <typename T>
__global__ void __launch_bounds__(kEwThreads)
lstm_bwd(int B, int H, const T* __restrict__ g, const float* __restrict__ c_prev,
         const float* __restrict__ dh_a, int ld_a, const float* __restrict__ dh_b, int ld_b,
         float* __restrict__ dc_io, const T* __restrict__ mh, const T* __restrict__ mc,
         T* __restrict__ dg, const float* __restrict__ hq, const float* __restrict__ dq,
         const float* __restrict__ wq, int A, float* __restrict__ dwq) {
  extern __shared__ __align__(16) float sm[];
  const int lq = A + 1;           // row stride of the staged dq
  float* dqs = sm;                // (B, A + 1)
  float* wqs = sm + B * lq;       // (A, kUnits)
  float* hqs = wqs + A * kUnits;  // (B, kUnits)
  const int j0 = blockIdx.x * kUnits, H4 = 4 * H;
  if (dq != nullptr) {
#pragma unroll 8
    for (int i = threadIdx.x; i < B * A; i += blockDim.x) dqs[(i / A) * lq + i % A] = dq[i];
#pragma unroll 4
    for (int i = threadIdx.x; i < kUnits * A; i += blockDim.x)
      wqs[(i % A) * kUnits + i / A] = wq[(size_t)j0 * A + i];
    for (int i = threadIdx.x; i < B * kUnits; i += blockDim.x)
      hqs[i] = hq[(size_t)(i / kUnits) * H + j0 + i % kUnits];
    __syncthreads();
  }
  for (int i = threadIdx.x; i < B * kUnits; i += blockDim.x) {
    const int b = i / kUnits, u = i % kUnits, j = j0 + u;
    const size_t bj = (size_t)b * H + j;
    float dh = dh_a[(size_t)b * ld_a + j];
    if (dh_b != nullptr) dh = dh + dh_b[(size_t)b * ld_b + j];
    if (dq != nullptr) {
      float acc = 0.0f;
      for (int a = 0; a < A; ++a) acc = fmaf(dqs[b * lq + a], wqs[a * kUnits + u], acc);
      dh = dh + acc;
    }
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
    for (int b = 0; b < B; ++b) s = fmaf(hqs[b * kUnits + j - j0], dqs[b * lq + a], s);
    dwq[(size_t)j * A + a] += s;
  }
}

struct BwdAtt {
  Dims d;
  const float *qpart, *locw, *ldw, *v, *mem, *pmem, *zeros;
  const float *dctx_out, *dw_out, *w_seq, *w_cum_prev;
  const float* dx_dec;  // (B, 2H+E) of this step
  float *dctx_c, *dw_prev_c, *dwcum_c;
  float *dctx_tot, *dq, *dv_part, *dwld_part, *dpmem;
  void* dloc;
};

// Attention backward of row blockIdx.y at step t on a cluster of kNC CTAs.
template <typename T>
__global__ void __cluster_dims__(kNC, 1, 1) __launch_bounds__(kAttThreads, 3)
att_bwd(BwdAtt a, int t) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cl = cg::this_cluster();
  const Dims& d = a.d;
  const int rank = (int)cl.block_rank(), b = blockIdx.y;
  const int S = d.S, E = d.E, A = d.A, F = d.F, H = d.H, nt = blockDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const AttGeo g(d, rank);
  const AttSmem s(sm, d, g, true);
  const size_t row = (size_t)t * d.B + b;
  const float* dxd = a.dx_dec + (size_t)b * (2 * H + E);
  float* dwp = a.dw_prev_c + (size_t)b * S + g.s0;
  float* dwc = a.dwcum_c + (size_t)b * S + g.s0;

  att_stage(s, d, g, b, a.qpart, a.v, t > 0 ? a.w_seq + (row - d.B) * S : a.zeros,
            a.w_cum_prev + row * S, a.locw, a.ldw);
  for (int p = tid; p < g.Sc4; p += nt) s.wt[p] = p < g.n ? a.w_seq[row * S + g.s0 + p] : 0.0f;
  for (int k = tid; k < E; k += nt)
    s.dcx[k] = dxd[H + k] + a.dctx_out[row * E + k] + a.dctx_c[(size_t)b * E + k];
  __syncthreads();
  att_loc(s, d, g);
  // dw = dw_out + dw_prev + dwcum + dctx . memory[p]  (into s.e)
  const float* mem = a.mem + ((size_t)b * S + g.s0) * E;
  for (int p0 = 4 * warp; p0 < g.n; p0 += 4 * nw) {  // 4 positions a warp, loads in flight
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int kq = lane; kq < E / 4; kq += 32) {
      const float4 x = *reinterpret_cast<const float4*>(s.dcx + 4 * kq);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (p0 + r >= g.n) continue;
        const float4 m =
            __ldcs(reinterpret_cast<const float4*>(mem + (size_t)(p0 + r) * E + 4 * kq));
        acc[r] = fmaf(x.x, m.x, fmaf(x.y, m.y, fmaf(x.z, m.z, fmaf(x.w, m.w, acc[r]))));
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float sum = warp_sum(acc[r]);
      const int p = p0 + r;
      if (lane == 0 && p < g.n) s.e[p] = a.dw_out[row * S + g.s0 + p] + dwp[p] + dwc[p] + sum;
    }
  }
  __syncthreads();
  float ds = 0.0f;
  for (int p = tid; p < g.n; p += nt) ds += s.e[p] * s.wt[p];
  ds = block_reduce<false>(ds, s.red);
  if (tid == 0) s.slot[0] = ds;
  cl.sync();
  float dsum = 0.0f;
  for (int r = 0; r < kNC; ++r) dsum += *cl.map_shared_rank(s.slot, r);
  for (int p = tid; p < g.Sc4; p += nt) s.de[p] = p < g.n ? s.wt[p] * (s.e[p] - dsum) : 0.0f;
  const int ec = cdiv(E, kNC), k1 = min(E, (rank + 1) * ec);
  for (int k = rank * ec + tid; k < k1; k += nt) a.dctx_tot[row * E + k] = s.dcx[k];
  __syncthreads();
  // tanh of every (position, unit), recomputed as the forward did
  const float* pm = a.pmem + ((size_t)b * S + g.s0) * A;
  float* dpm = a.dpmem + ((size_t)b * S + g.s0) * A;
  for (int i = tid; i < (g.Sc4 / 4) * g.nAq; i += nt) {
    const int pq = i / g.nAq, aq = i - pq * g.nAq;
    float ta[4][4], dvs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    att_tanh_tile(s, d, g, pm, pq, aq, ta);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = 4 * pq + r;
      float dta[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int u = 4 * aq + c;
        dvs[c] = fmaf(ta[r][c], s.de[p], dvs[c]);
        dta[c] = s.de[p] * s.v[u] * (1.0f - ta[r][c] * ta[r][c]);
        if (p < g.n && u < A) dpm[(size_t)p * A + u] += dta[c];
      }
      *reinterpret_cast<float4*>(s.dta + p * g.ldt + 4 * aq) =
          make_float4(dta[0], dta[1], dta[2], dta[3]);
    }
    *reinterpret_cast<float4*>(s.dvp + pq * g.A4 + 4 * aq) =
        make_float4(dvs[0], dvs[1], dvs[2], dvs[3]);
  }
  __syncthreads();
  // dv and dq partials of the chunk; loc_dense^T into the dead ldw / locT
  for (int u = tid; u < A; u += nt) {
    float dv = 0.0f, dqv = 0.0f;
    for (int pq = 0; pq < g.Sc4 / 4; ++pq) dv += s.dvp[pq * g.A4 + u];
    for (int p = 0; p < g.n; ++p) dqv += s.dta[p * g.ldt + u];
    a.dv_part[((size_t)b * kNC + rank) * A + u] += dv;
    s.dqc[u] = dqv;
  }
  for (int i = tid; i < F * A; i += nt) s.ldwT[(i % A) * g.ldF + i / A] = a.ldw[i];
  for (int i = tid; i < A * (g.F4 - F); i += nt)
    s.ldwT[(i / (g.F4 - F)) * g.ldF + F + i % (g.F4 - F)] = 0.0f;
  // dWld partial of the chunk: loc^T . dta, 4 x 4 tiles of (filter, unit)
  float* dwld = a.dwld_part + ((size_t)b * kNC + rank) * F * A;
  for (int i = tid; i < g.nFq * g.nAq; i += nt) {
    const int fq = i / g.nAq, aq = i - fq * g.nAq;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
    for (int p = 0; p < g.n; ++p) {
      const float4 lv = *reinterpret_cast<const float4*>(s.loc + p * g.F4 + 4 * fq);
      const float4 dv = *reinterpret_cast<const float4*>(s.dta + p * g.ldt + 4 * aq);
      const float lr[4] = {lv.x, lv.y, lv.z, lv.w}, dc[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(lr[r], dc[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int f = 4 * fq + r, u = 4 * aq + c;
        if (f < F && u < A) dwld[f * A + u] += acc[r][c];
      }
  }
  __syncthreads();
  // dloc = dta . loc_dense^T, (position, 4 filters) per thread
  T* dlo = static_cast<T*>(a.dloc) + (row * S + g.s0) * F;
  for (int i = tid; i < g.n * g.nFq; i += nt) {
    const int p = i / g.nFq, fq = i - p * g.nFq;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int u = 0; u < A; ++u) {
      const float x = s.dta[p * g.ldt + u];
      const float4 wv = *reinterpret_cast<const float4*>(s.ldwT + u * g.ldF + 4 * fq);
      acc[0] = fmaf(x, wv.x, acc[0]);
      acc[1] = fmaf(x, wv.y, acc[1]);
      acc[2] = fmaf(x, wv.z, acc[2]);
      acc[3] = fmaf(x, wv.w, acc[3]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int f = 4 * fq + c;
      if (f < F) {
        s.dl[p * F + f] = acc[c];
        dlo[(size_t)p * F + f] = from_f<T>(acc[c]);
      }
    }
  }
  cl.sync();
  // dq of the row: this CTA adds the partials of its slice of A, in rank order
  const int ac = cdiv(A, kNC), a1 = min(A, (rank + 1) * ac);
  for (int u = rank * ac + tid; u < a1; u += nt) {
    float acc = 0.0f;
    for (int r = 0; r < kNC; ++r) acc += cl.map_shared_rank(s.dqc, r)[u];
    a.dq[(size_t)b * A + u] = acc;
  }
  // dloc over the halo [s0 - pad, s0 + Sc + pad), from the CTAs that own it,
  // stored transposed (dlh[f][h]) for the conv's reads along positions
  for (int i = tid; i < g.L * F; i += nt) {
    const int h = i / F, f = i - h * F, q = g.s0 - g.pad + h;
    float val = 0.0f;
    if (q >= 0 && q < S) {
      const int r = q / g.Sc;
      val = cl.map_shared_rank(s.dl, r)[(q - r * g.Sc) * F + f];
    }
    s.dlh[f * g.Lh + h] = val;
  }
  __syncthreads();
  // transposed location conv: dfeat[p][c] = sum_k,f dloc[p + pad - k][f]
  // loc_w[k][c][f], the taps split 4 ways (partials added in order)
  const int n2 = 2 * g.Sc4;
  for (int i = tid; i < 4 * n2; i += nt) {
    const int pk = i / n2, o = i - pk * n2, c = o / g.Sc4, p = o - c * g.Sc4;
    float acc = 0.0f;
    if (p < g.n)
      for (int k = pk; k < d.K; k += 4) {
        const float* dr = s.dlh + (p + 2 * g.pad - k);
        const float* lr = s.lw + (k * 2 + c) * F;
        for (int f = 0; f < F; ++f) acc = fmaf(dr[f * g.Lh], lr[f], acc);
      }
    s.cred[i] = acc;
  }
  __syncthreads();
  for (int o = tid; o < n2; o += nt) {
    const int c = o / g.Sc4, p = o - c * g.Sc4;
    if (p >= g.n) continue;
    const float acc = ((s.cred[o] + s.cred[n2 + o]) + s.cred[2 * n2 + o]) + s.cred[3 * n2 + o];
    if (c == 0)
      dwp[p] = acc;
    else
      dwc[p] = acc + dwc[p];
  }
  cl.sync();  // the dl and dqc of this CTA stay until the cluster has read them
}

// out[i] = sum over rows b (in order) of part[b][i].
__global__ void sum_rows(const float* __restrict__ part, int B, int n, float* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    float acc = 0.0f;
    for (int b = 0; b < B; ++b) acc += part[(size_t)b * n + i];
    out[i] = acc;
  }
}

GraphCache graphs;  // the step loops of the last calls, as CUDA graphs

template <typename T>
cudaError_t run(BwdAtt ba, const float* wq, const void* attn_w_, const void* dec_w_,
                const void* m1_, const void* m2_, const void* m3_, const void* m4_,
                const float* dh_dec_out, const void* g_att_, const void* g_dec_,
                const float* c_att_prev, const float* c_dec_prev, const float* h_att,
                void* dg_att_, void* dg_dec_, float* dpn, float* dv, float* dwq, float* dwld,
                float* dx_dec, float* dh_att_c, float* dc_att, float* dc_dec, float* part,
                float* qpart, bool graph, const GraphKey& key, cudaStream_t st) {
  const Dims d = ba.d;
  const T* attn_w = static_cast<const T*>(attn_w_);
  const T* dec_w = static_cast<const T*>(dec_w_);
  const T *m1 = static_cast<const T*>(m1_), *m2 = static_cast<const T*>(m2_);
  const T *m3 = static_cast<const T*>(m3_), *m4 = static_cast<const T*>(m4_);
  const T* g_att = static_cast<const T*>(g_att_);
  const T* g_dec = static_cast<const T*>(g_dec_);
  T* dg_att = static_cast<T*>(dg_att_);
  T* dg_dec = static_cast<T*>(dg_dec_);
  constexpr bool kTc = is_tc<T>();
  const int B = d.B, H = d.H, E = d.E, P = d.P, A = d.A;
  const int Kd = 2 * H + E, Ka = P + E + H, H4 = 4 * H;
  const size_t att_smem = (size_t)AttSmem::bwd_floats(d) * sizeof(float);
  const size_t ew_smem = (size_t)(B * (A + 1) + kUnits * (A + B)) * sizeof(float);
  const size_t tc_smem = TcRing<kTcCols, kTcStages>::kSmemBytes;
  cudaError_t err = smem_attr((const void*)att_bwd<T>, att_smem);
  if (err == cudaSuccess) err = smem_attr((const void*)lstm_bwd<T>, ew_smem);
  if constexpr (kTc)
    if (err == cudaSuccess) err = smem_attr((const void*)dx_tc<T>, tc_smem);
  if (err != cudaSuccess) return err;
  CUtensorMap mga, mgd, mwa, mwd;
  if constexpr (kTc) {
    const uint64_t dg3[3] = {(uint64_t)H4, (uint64_t)B, (uint64_t)d.T};
    const uint64_t dwa[2] = {(uint64_t)H4, (uint64_t)Ka}, dwd[2] = {(uint64_t)H4, (uint64_t)Kd};
    const uint32_t bg[3] = {kTileK, kRows, 1}, bw[2] = {kTileK, kTcCols};
    if ((err = tensor_map<T>(&mga, dg_att, 3, dg3, bg)) != cudaSuccess ||
        (err = tensor_map<T>(&mgd, dg_dec, 3, dg3, bg)) != cudaSuccess ||
        (err = tensor_map<T>(&mwa, attn_w, 2, dwa, bw)) != cudaSuccess ||
        (err = tensor_map<T>(&mwd, dec_w, 2, dwd, bw)) != cudaSuccess)
      return err;
  }
  const size_t BH = (size_t)B * H;
  const int nchunk = (H4 / kSplit + kBN - 1) / kBN * kBN;
  const dim3 att_grid(kNC, B), q_grid(cdiv(A, 32), cdiv(H, kQChunk));
  auto product = [&](cudaStream_t s, const T* dg, const CUtensorMap& mg, const CUtensorMap& mw,
                     const T* w, int K, int t, const OutSeg3& out) {
    if constexpr (kTc) {
      dx_tc<T><<<dim3(cdiv(K, kTcCols), kTcSplit), kTcThreads, tc_smem, s>>>(mg, mw, t, H4, K,
                                                                             B, out);
    } else {
      gemm_nt<T><<<dim3((K + kCols - 1) / kCols, kSplit), kGemmThreads, 0, s>>>(
          dg, H4, w, K, B, nchunk, part);
      sum_split<<<(B * K + 255) / 256, 256, 0, s>>>(part, kSplit, B, K, out);
    }
  };
  const OutSeg3 od{{dx_dec, dx_dec, dx_dec}, {Kd, Kd, Kd}, {Kd, Kd, Kd}};
  auto enqueue = [&](cudaStream_t s) {
    for (int t = d.T - 1; t >= 0; --t) {
      const size_t o = (size_t)t * BH;
      lstm_bwd<T><<<H / kUnits, kEwThreads, 0, s>>>(
          B, H, g_dec + 4 * o, c_dec_prev + o, dh_dec_out + o, H, dx_dec + H + E, Kd, dc_dec,
          m3 ? m3 + o : nullptr, m4 ? m4 + o : nullptr, dg_dec + 4 * o, nullptr, nullptr,
          nullptr, A, nullptr);
      product(s, dg_dec + 4 * o, mgd, mwd, dec_w, Kd, t, od);
      att_query<<<q_grid, 256, 0, s>>>(h_att + o, B, H, wq, A, qpart);
      att_bwd<T><<<att_grid, kAttThreads, att_smem, s>>>(ba, t);
      lstm_bwd<T><<<H / kUnits, kEwThreads, ew_smem, s>>>(
          B, H, g_att + 4 * o, c_att_prev + o, dx_dec, Kd, dh_att_c, H, dc_att,
          m1 ? m1 + o : nullptr, m2 ? m2 + o : nullptr, dg_att + 4 * o, h_att + o, ba.dq, wq, A,
          dwq);
      const OutSeg3 oa{{dpn + (size_t)t * B * P, ba.dctx_c, dh_att_c}, {P, E, H}, {P, E, H}};
      product(s, dg_att + 4 * o, mga, mwa, attn_w, Ka, t, oa);
    }
    sum_rows<<<1, 256, 0, s>>>(ba.dv_part, B * kNC, A, dv);
    sum_rows<<<(d.F * A + 255) / 256, 256, 0, s>>>(ba.dwld_part, B * kNC, d.F * A, dwld);
  };
  return launch_loop(enqueue, graph, graphs, key, st);
}

}  // namespace

// dtype: 0 = float32 stream, 1 = bfloat16, 2 = float16 (StreamType); any
// other value returns cudaErrorInvalidValue.  Inputs (row-major): attn_w
// (P+E+H, 4H), dec_w (2H+E, 4H) stream dtype; query_w (H, A), loc_w
// (K, 2, F), loc_dense_w (F, A), v (A), memory (B, S, E), pmem (B, S, A);
// masks m1..m4 (T, B, H) stream dtype or all null; the output cotangents
// dh_dec (T, B, H), dctx (T, B, E), dw (T, B, S); the forward's g_att, g_dec
// (T, B, 4H) stream dtype, c_att_prev, c_dec_prev, h_att (T, B, H), w_seq
// and w_cum_prev (T, B, S).  Outputs: dg_att, dg_dec (T, B, 4H) and dloc
// (T, B, S, F) stream dtype; dpn (T, B, P), dctx_tot (T, B, E); dv (A),
// dwld (F, A); dwq (H, A) and dpmem (B, S, A) zeroed by the caller.  Work,
// all float32 and zeroed: dx_dec (B, 2H+E), dh_att_c (B, H), dctx_c (B, E),
// dc_att, dc_dec (B, H), dw_prev_c, dwcum_c (B, S), dq (B, A), dv_part
// (B, kNC, A), dwld_part (B, kNC, F, A), zeros (S); not zeroed: part
// (kSplit, B, max(2H+E, P+E+H)) (float32 stream), qpart (cdiv(H, kQChunk),
// B, A).  graph != 0 replays the loop from a CUDA graph.  Returns a
// cudaError_t.
extern "C" int t2v_teacher_bwd(
    int dtype, int T, int B, int S, int E, int H, int P, int A, int F, int K, int graph,
    const void* attn_w, const void* dec_w, const float* query_w, const float* loc_w,
    const float* loc_dense_w, const float* v, const float* memory, const float* pmem,
    const void* m1, const void* m2, const void* m3, const void* m4,
    const float* dh_dec, const float* dctx, const float* dw, const void* g_att,
    const void* g_dec, const float* c_att_prev, const float* c_dec_prev, const float* h_att,
    const float* w_seq, const float* w_cum_prev,
    void* dg_att, void* dg_dec, float* dpn, float* dctx_tot, void* dloc, float* dv, float* dwq,
    float* dwld, float* dpmem,
    float* dx_dec, float* dh_att_c, float* dctx_c, float* dc_att, float* dc_dec,
    float* dw_prev_c, float* dwcum_c, float* dq, float* dv_part, float* dwld_part,
    const float* zeros, float* part, float* qpart, void* stream) {
  if (B < 1 || B > kRows || H % kUnits != 0 || K % 2 == 0 || T < 1 ||
      (m1 == nullptr) != (m4 == nullptr))
    return (int)cudaErrorInvalidValue;
  const Dims d{T, B, S, E, H, P, A, F, K};
  const BwdAtt ba{d, qpart, loc_w, loc_dense_w, v, memory, pmem, zeros,
                  dctx, dw, w_seq, w_cum_prev, dx_dec,
                  dctx_c, dw_prev_c, dwcum_c,
                  dctx_tot, dq, dv_part, dwld_part, dpmem, dloc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const GraphKey key = make_key(
      dtype, T, B, S, E, H, P, A, F, K, attn_w, dec_w, query_w, loc_w, loc_dense_w, v, memory,
      pmem, m1, m2, m3, m4, dh_dec, dctx, dw, g_att, g_dec, c_att_prev, c_dec_prev, h_att, w_seq,
      w_cum_prev, dg_att, dg_dec, dpn, dctx_tot, dloc, dv, dwq, dwld, dpmem, dx_dec, dh_att_c,
      dctx_c, dc_att, dc_dec, dw_prev_c, dwcum_c, dq, dv_part, dwld_part, zeros, part, qpart);
  auto go = [&](auto tag) {  // tag: a null T*
    using T = std::remove_pointer_t<decltype(tag)>;
    return run<T>(ba, query_w, attn_w, dec_w, m1, m2, m3, m4, dh_dec, g_att, g_dec, c_att_prev,
                  c_dec_prev, h_att, dg_att, dg_dec, dpn, dv, dwq, dwld, dx_dec, dh_att_c, dc_att,
                  dc_dec, part, qpart, graph != 0, key, st);
  };
  switch (dtype) {
    case kF32: return (int)go(static_cast<float*>(nullptr));
    case kBF16: return (int)go(static_cast<__nv_bfloat16*>(nullptr));
    case kF16: return (int)go(static_cast<__half*>(nullptr));
    default: return (int)cudaErrorInvalidValue;
  }
}

// Step-loop graphs instantiated so far by t2v_teacher_bwd (replays and
// updates add none).
extern "C" int t2v_teacher_bwd_graph_captures() {
  std::lock_guard<std::mutex> lock(graphs.mu);
  return graphs.captures;
}

// Graphs given new pointers in place so far by t2v_teacher_bwd.
extern "C" int t2v_teacher_bwd_graph_updates() {
  std::lock_guard<std::mutex> lock(graphs.mu);
  return graphs.updates;
}

// Host nanoseconds t2v_teacher_bwd has spent building graphs so far:
// capturing the loop, then instantiating it or updating one in place.
extern "C" long long t2v_teacher_bwd_graph_build_ns() {
  std::lock_guard<std::mutex> lock(graphs.mu);
  return graphs.build_ns;
}
