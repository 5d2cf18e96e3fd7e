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
// The attention backward is linear in de once the forward's values are
// known: with G = v (1 - ta^2) (S x A), M = G . loc_dense^T (S x F) and
// N[p][k][c] = sum_f M[p][f] loc_w[k][c][f], dta = de G, dq = G^T de,
// dloc = de M and the transposed conv dfeat[q][c] = sum_k de[q + pad - k]
// N[q + pad - k][k][c].  G, M and N depend on h_att, w_prev, w_cum, pmem
// and the weights alone, so the (S x F) . (F x A) products leave the
// reverse-time chain; what stays on it per position is dctx . memory (E
// MACs), G^T de (A) and 2K taps.
//
// Design: the steps go in chunks of C (the wrapper sizes C from (B, S)
// under a memory budget), from the last.  A chunk is
//   att_query            q = h_att . query_w for the chunk's steps at once
//                        (grid z: one step each; the forward's partials,
//                        so the recomputed tanh matches K3's bit for bit)
//   att_bwd<T, kCoef>    coefficient pass, one CTA a (64 positions, row,
//                        step): att_stage / att_loc / att_tanh_tile as the
//                        forward, then G^T in shared memory and the M and N
//                        products, register-tiled (4 x 2 and 4 x 4 outputs
//                        a thread, 16-byte shared operands); writes ta, M,
//                        N (2K, S) and loc to the ring
//   per step, from the last (five kernels, bf16 stream; one CUDA graph of
//   the loop, K3's note gives the reason):
//   lstm_bwd  decoder LSTM backward, elementwise over (B, H), dg_dec
//             stored in bf16: the operand of the next product, written once
//   dx_tc     dx_dec = dg_dec . dec_w^T on wgmma: a CTA owns 128 output
//             columns (N = 128, the weight rows read K-major as stored, no
//             transposed copy, evict-last in L2) for all B <= 64 rows and
//             one of kTcSplit chunks of 4H, fed by a 4-stage TMA ring from a
//             producer warp; the kTcSplit CTAs of a cluster add their
//             partial tiles in order through distributed shared memory
//   att_bwd<T, kChain>  the chain: a row on a cluster of kNC CTAs, each
//             owning S / kNC positions; the step's inputs and the slot's
//             ta rows come in by cp.async while dw = carries + dctx .
//             memory streams memory, then the dsum reduction and dq = G^T
//             de through distributed shared memory, de to the ring, and
//             the carries through the 2K taps of N (read into registers
//             while dq is formed) over a de halo read from the
//             neighbouring CTAs; three cluster barriers, two of them split
//             into arrive and wait around work that needs neither half
//   lstm_bwd  attention LSTM backward with dh_att += dq . query_w^T and
//             dWq += h_att^T dq for its units: each block reads its 8 rows
//             of query_w, so query_w is read once a step
//   dx_tc     dx_att = dg_att . attn_w^T into dpn[t] and the dctx / dh_att
//             carries
//   att_bwd<T, kAccum>   accumulation pass, one CTA a (row, S / kNC
//                        positions) over the chunk's steps in reverse time:
//                        dloc = de M (stream dtype), dpmem += de G (its rows
//                        held in shared memory), the CTA's dv and dWld =
//                        loc^T (de G) partials (4 x 4 tiles a thread); the
//                        next step's tiles come in by cp.async while a step
//                        is worked
// so a step takes 5 + 3 / C graph nodes (C >= 3: no more than the 6 of the
// earlier design, whose att_bwd did all of the attention backward on the
// chain).
//
// What bounds it on an H100 at B = 64 (bf16, kernel by kernel, us a step;
// PERF.md, kernel table row 2):
//   the LSTM part: the two dx products, (B x 4096) . (4096 x 2560) and
//     (B x 4096) . (4096 x 1792), 2.35 GFLOP and 36 MB of bf16 weights a
//     step, and the two cell backwards: latency-bound as in K3, ~58 us at
//     any S.
//   the chain: memory's bytes.  It reads memory (B, S, E) in float32 every
//     step, 50 MB at S = 384 (15 us at 3.35 TB/s), and the slot's ta (12.6
//     MB), with 700 MACs a position against 17 600 when the products ran on
//     it: 39 us at S = 384 (memory streams ~19 of it, ta ~5, the barriers,
//     dq and the taps ~8).  At S = 128 memory is 16.8 MB and the fixed
//     latency of one step (staging, three cluster barriers) is most of its
//     20 us.  kChain keeps three CTAs an SM (<= 85 registers, N's taps
//     read into registers, not shared memory), so that all 64 clusters
//     run in one wave (at two an SM only 62 fit).
//   the passes: float32 FFMA, ~0.8 GFLOP a step at S = 384 (loc and N 2 x
//     0.1, the tanh argument and M 2 x 0.2, dWld 0.2), parallel over the
//     chunk's steps, rows and positions: 38 + 22 us at S = 384 (~13
//     TFLOP/s, a fifth of the peak; two CTAs an SM, their staging latency
//     and the tanh are the rest), 13 + 8 us at S = 128.  The ring's bytes
//     (~25 MB a step at S = 384) go through HBM once each way.
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
constexpr int kCoefPos = 64;              // positions of a coefficient-pass CTA
constexpr int kRingAlign = 64;            // floats: each coefficient array on 256 bytes
constexpr int kCoef = 0, kChain = 1, kAccum = 2;  // att_bwd's phases
constexpr int kTaps = 32;                 // location taps the chain holds in registers

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

// The coefficients of a chunk of reverse steps, one slot a step (slot =
// step - the chunk's first step), each array starting on kRingAlign floats.
struct Ring {
  float* q;    // (C, cdiv(H, kQChunk), B, A) att_query partials
  float* ta;   // (C, B, S, A) tanh(q + loc . loc_dense + pmem)
  float* m;    // (C, B, S, F) M = G . loc_dense^T, G = v (1 - ta^2)
  float* n;    // (C, B, 2K, S) N[2k + c][p] = sum_f M[p][f] loc_w[k][c][f]
  float* loc;  // (C, B, S, F) the location features
  float* de;   // (C, B, S) the chain's energy cotangents
};

__host__ __device__ constexpr size_t ring_part(size_t n) {
  return (n + kRingAlign - 1) / kRingAlign * kRingAlign;
}

inline Ring carve_ring(float* r, const Dims& d, int C) {
  const size_t BS = (size_t)C * d.B * d.S;
  Ring g;
  g.q = r;
  g.ta = g.q + ring_part((size_t)C * cdiv(d.H, kQChunk) * d.B * d.A);
  g.m = g.ta + ring_part(BS * d.A);
  g.n = g.m + ring_part(BS * d.F);
  g.loc = g.n + ring_part(BS * 2 * d.K);
  g.de = g.loc + ring_part(BS * d.F);
  return g;
}

struct BwdAtt {
  Dims d;
  const float *locw, *ldw, *v, *mem, *pmem, *zeros;
  const float *dctx_out, *dw_out, *w_seq, *w_cum_prev;
  const float* dx_dec;  // (B, 2H+E) of this step
  float *dctx_c, *dw_prev_c, *dwcum_c;
  float *dctx_tot, *dq, *dv_part, *dwld_part, *dpmem;
  void* dloc;
  Ring r;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A cluster barrier in two halves: arrive (this thread's shared-memory
// writes released to the cluster), later wait (the others' acquired), with
// work between them that needs neither.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// f(r, c) for each (r, c) = divmod(i, cols) of i = threadIdx.x, +
// blockDim.x, ... < rows * cols, with no division a step
template <typename Fn>
__device__ __forceinline__ void for_2d(int rows, int cols, Fn&& f) {
  const int dr = blockDim.x / cols, dc = blockDim.x - dr * cols;
  int r = threadIdx.x / cols, c = threadIdx.x - r * cols;
  while (r < rows) {
    f(r, c);
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

// dst (rows, ld), ld % 4 == 0: the first nrows rows of cols floats of src
// (row stride lds) by cp.async, 16 bytes a copy when the rows allow it;
// zeros elsewhere.
__device__ __forceinline__ void stage_rows(float* dst, int ld, const float* src, size_t lds,
                                           int rows, int nrows, int cols) {
  if (cols % 4 == 0 && lds % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    for_2d(rows, ld / 4, [&](int r, int c4) {
      const int c = 4 * c4;
      if (r < nrows && c < cols)
        cp_async16(dst + r * ld + c, src + r * lds + c);
      else
        *reinterpret_cast<float4*>(dst + r * ld + c) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    });
  } else {
    for_2d(rows, ld, [&](int r, int c) {
      if (r < nrows && c < cols)
        cp_async4(dst + r * ld + c, src + r * lds + c);
      else
        dst[r * ld + c] = 0.0f;
    });
  }
}

// Coefficient pass, one CTA a (kCoefPos positions, row, step of the chunk):
// the forward's energies again (att_stage, att_loc and att_tanh_tile on the
// att_query partials, so ta is the forward's bit for bit), then G^T (A4,
// Sc4) in shared memory, M = G . loc_dense^T (4 positions x 2 filters a
// thread) and N (4 taps x 4 positions a thread).
struct CoefSmem {
  float *gt, *mt, *ldwT, *lwT;
  // row strides of the transposed weights: the transposes' stores land two
  // (ldwT) and eight (lwT) ways on a bank, not 32
  __host__ __device__ static int ldt(const AttGeo& g) { return g.F4 + 2; }
  __host__ __device__ static int ldj(const Dims& d) { return up4(2 * d.K) + 4; }
  // G^T's row stride: the warps' stores of 4 positions down 32 units of G
  // land on distinct banks
  __host__ __device__ static int ldg(const AttGeo& g) { return g.Sc4 + 4; }
  __host__ __device__ static int floats(const Dims& d, const AttGeo& g) {
    return AttSmem::bwd_floats(d, g) + g.A4 * ldg(g) + g.F4 * g.Sc4 + g.A4 * ldt(g) +
           d.F * ldj(d);
  }
  __device__ CoefSmem(const AttSmem& s, const Dims& d, const AttGeo& g) {
    gt = s.loc + g.Sc4 * g.F4;                      // G^T (A4, ldg)
    mt = gt + g.A4 * ldg(g);                        // M^T (F4, Sc4)
    ldwT = mt + g.F4 * g.Sc4;                       // loc_dense^T (A4, ldt)
    lwT = ldwT + g.A4 * ldt(g);                     // loc_w^T (F, ldj)
  }
};

__device__ __forceinline__ void att_coef(const BwdAtt& a, int t0) {
  extern __shared__ __align__(16) float sm[];
  const Dims& d = a.d;
  const int S = d.S, A = d.A, F = d.F, J = 2 * d.K, J4 = up4(J), nt = blockDim.x;
  const int tid = threadIdx.x, b = blockIdx.y, slot = blockIdx.z, t = t0 + slot;
  const AttGeo g(d, blockIdx.x * kCoefPos, kCoefPos);
  const AttSmem s(sm, d, g, true);
  const CoefSmem c(s, d, g);
  const int ldt = CoefSmem::ldt(g), ldj = CoefSmem::ldj(d), ldg = CoefSmem::ldg(g);
  const int nPq = g.Sc4 / 4, nF2 = g.F4 / 2;
  const size_t row = (size_t)t * d.B + b, rs = (size_t)slot * d.B + b;
  att_stage(s, d, g, b, a.r.q + (size_t)slot * cdiv(d.H, kQChunk) * d.B * A, a.v,
            t > 0 ? a.w_seq + (row - d.B) * S : a.zeros, a.w_cum_prev + row * S, a.locw, a.ldw);
  __syncthreads();
  for_2d(g.F4, g.A4, [&](int f, int u) {  // from the staged ldw (F, A4), zero-padded
    c.ldwT[u * ldt + f] = f < F ? s.ldw[f * g.A4 + u] : 0.0f;
  });
  for_2d(J4, F, [&](int j, int f) {  // from the staged loc_w (2K, F)
    c.lwT[f * ldj + j] = j < J ? s.lw[j * F + f] : 0.0f;
  });
  att_loc(s, d, g);
  __syncthreads();
  float* lo = a.r.loc + (rs * S + g.s0) * F;
  for_2d(g.n, F, [&](int p, int f) { lo[p * F + f] = s.loc[p * g.F4 + f]; });
  // ta into the ring and G^T = (v (1 - ta^2))^T, zero past the chunk; the
  // units fastest, so that a warp's pmem loads and ta stores are contiguous
  const float* pm = a.pmem + ((size_t)b * S + g.s0) * A;
  float* tar = a.r.ta + (rs * S + g.s0) * A;
  for (int i = tid; i < nPq * g.nAq; i += nt) {
    const int aq = i % g.nAq, pq = i / g.nAq;
    float ta[4][4];
    att_tanh_tile(s, d, g, pm, pq, aq, ta);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = 4 * pq + r;
      if (p >= g.n) continue;
      if (A % 4 == 0) {
        *reinterpret_cast<float4*>(tar + (size_t)p * A + 4 * aq) =
            make_float4(ta[r][0], ta[r][1], ta[r][2], ta[r][3]);
      } else {
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          if (4 * aq + cc < A) tar[(size_t)p * A + 4 * aq + cc] = ta[r][cc];
      }
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int u = 4 * aq + cc;
      float gv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        gv[r] = 4 * pq + r < g.n ? s.v[u] * (1.0f - ta[r][cc] * ta[r][cc]) : 0.0f;
      *reinterpret_cast<float4*>(c.gt + u * ldg + 4 * pq) =
          make_float4(gv[0], gv[1], gv[2], gv[3]);
    }
  }
  __syncthreads();
  // M = G . loc_dense^T, 4 positions x 2 filters a thread
  float* mr = a.r.m + (rs * S + g.s0) * F;
  for (int i = tid; i < nPq * nF2; i += nt) {
    const int f2 = i % nF2, pq = i / nF2;
    float acc[4][2];
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[r][0] = acc[r][1] = 0.0f;
#pragma unroll 4
    for (int u = 0; u < A; ++u) {
      const float4 gv = *reinterpret_cast<const float4*>(c.gt + u * ldg + 4 * pq);
      const float2 wv = *reinterpret_cast<const float2*>(c.ldwT + u * ldt + 2 * f2);
      const float gr[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r][0] = fmaf(gr[r], wv.x, acc[r][0]);
        acc[r][1] = fmaf(gr[r], wv.y, acc[r][1]);
      }
    }
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int f = 2 * f2 + cc;
      *reinterpret_cast<float4*>(c.mt + f * g.Sc4 + 4 * pq) =
          make_float4(acc[0][cc], acc[1][cc], acc[2][cc], acc[3][cc]);
      if (f >= F) continue;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (4 * pq + r < g.n) mr[(size_t)(4 * pq + r) * F + f] = acc[r][cc];
    }
  }
  __syncthreads();
  // N[2k + c][p] = sum_f M[p][f] loc_w[k][c][f], 4 taps x 4 positions a thread
  float* nr = a.r.n + rs * J * S + g.s0;
  for (int i = tid; i < nPq * (J4 / 4); i += nt) {
    const int pq = i % nPq, jq = i / nPq;
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][r] = 0.0f;
#pragma unroll 4
    for (int f = 0; f < F; ++f) {
      const float4 mv = *reinterpret_cast<const float4*>(c.mt + f * g.Sc4 + 4 * pq);
      const float4 wv = *reinterpret_cast<const float4*>(c.lwT + f * ldj + 4 * jq);
      const float mr4[4] = {mv.x, mv.y, mv.z, mv.w}, wj[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[j][r] = fmaf(wj[j], mr4[r], acc[j][r]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (4 * jq + j >= J) continue;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (4 * pq + r < g.n) nr[(size_t)(4 * jq + j) * S + 4 * pq + r] = acc[j][r];
    }
  }
}

// Chain, one cluster of kNC CTAs a row (each S / kNC positions) at step t:
// what needs the carries, linear in de given the slot's coefficients.
struct ChainSmem {
  float *dcx, *dc2, *dc3, *v, *e, *wt, *dwo, *dwp, *dwc, *dl, *ta, *dqp, *dqc, *red, *slot;
  // partial sums of dq a unit, over interleaved positions
  __host__ __device__ static int groups(const AttGeo& g) {
    return g.A4 < kAttThreads ? kAttThreads / g.A4 : 1;
  }
  __host__ __device__ static int floats(const Dims& d, const AttGeo& g) {
    return 3 * up4(d.E) + g.A4 + 5 * g.Sc4 + up4(g.L) + g.Sc4 * g.A4 + (groups(g) + 1) * g.A4 +
           32 + 8;
  }
  __device__ ChainSmem(float* sm, const Dims& d, const AttGeo& g) {
    dcx = sm;                             // dctx of the row (E): dx_dec's part, then the sum
    dc2 = dcx + up4(d.E);                 // the output cotangent dctx[t] (E)
    dc3 = dc2 + up4(d.E);                 // the dctx carry (E)
    v = dc3 + up4(d.E);                   // v (A4)
    e = v + g.A4;                         // dw (Sc4)
    wt = e + g.Sc4;                       // w (Sc4)
    dwo = wt + g.Sc4;                     // the output cotangent dw[t] (Sc4)
    dwp = dwo + g.Sc4;                    // the w_prev carry (Sc4)
    dwc = dwp + g.Sc4;                    // the w_cum carry (Sc4)
    dl = dwc + g.Sc4;                     // de over [s0 - pad, s0 + Sc + pad) (L)
    ta = dl + up4(g.L);                   // this step's ta (Sc4, A4)
    dqp = ta + g.Sc4 * g.A4;              // dq partials (groups, A4)
    dqc = dqp + groups(g) * g.A4;         // dq of this CTA (A4)
    red = dqc + g.A4;
    slot = red + 32;
  }
};

__device__ __forceinline__ void att_chain(const BwdAtt& a, int t, int slot) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cl = cg::this_cluster();
  const Dims& d = a.d;
  const int rank = (int)cl.block_rank(), b = blockIdx.y;
  const int S = d.S, E = d.E, A = d.A, H = d.H, J = 2 * d.K, nt = blockDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const AttGeo g(d, rank);
  const ChainSmem s(sm, d, g);
  const size_t row = (size_t)t * d.B + b, rs = (size_t)slot * d.B + b;
  const float* dxd = a.dx_dec + (size_t)b * (2 * H + E);
  float* dwp = a.dw_prev_c + (size_t)b * S + g.s0;
  float* dwc = a.dwcum_c + (size_t)b * S + g.s0;

  // the step's inputs, then the slot's ta rows (in flight while dw is
  // formed), by cp.async
  stage_rows(s.dcx, up4(E), dxd + H, 0, 1, 1, E);
  stage_rows(s.dc2, up4(E), a.dctx_out + row * E, 0, 1, 1, E);
  stage_rows(s.dc3, up4(E), a.dctx_c + (size_t)b * E, 0, 1, 1, E);
  stage_rows(s.v, g.A4, a.v, 0, 1, 1, A);
  stage_rows(s.wt, g.Sc4, a.w_seq + row * S + g.s0, 0, 1, 1, g.n);
  stage_rows(s.dwo, g.Sc4, a.dw_out + row * S + g.s0, 0, 1, 1, g.n);
  stage_rows(s.dwp, g.Sc4, dwp, 0, 1, 1, g.n);
  stage_rows(s.dwc, g.Sc4, dwc, 0, 1, 1, g.n);
  cp_async_commit();
  stage_rows(s.ta, g.A4, a.r.ta + (rs * S + g.s0) * A, A, g.Sc4, g.n, A);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  for (int k = tid; k < E; k += nt) s.dcx[k] = s.dcx[k] + s.dc2[k] + s.dc3[k];
  __syncthreads();
  // dw = dw_out + dw_prev + dwcum + dctx . memory[p]  (into s.e)
  const float* mem = a.mem + ((size_t)b * S + g.s0) * E;
  const int E4 = E / 4;
  for (int p0 = 4 * warp; p0 < g.n; p0 += 4 * nw) {  // 4 positions a warp
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k0 = lane; k0 < E4; k0 += 2 * 32) {  // 8 loads of a lane in flight
      float4 m[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int kq = k0 + 32 * j;
          m[j][r] = p0 + r < g.n && kq < E4
                        ? __ldcs(reinterpret_cast<const float4*>(mem + (size_t)(p0 + r) * E +
                                                                 4 * kq))
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kq = k0 + 32 * j;
        if (kq >= E4) break;
        const float4 x = *reinterpret_cast<const float4*>(s.dcx + 4 * kq);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[r] = fmaf(x.x, m[j][r].x,
                        fmaf(x.y, m[j][r].y, fmaf(x.z, m[j][r].z, fmaf(x.w, m[j][r].w, acc[r]))));
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float sum = warp_sum(acc[r]);
      const int p = p0 + r;
      if (lane == 0 && p < g.n) s.e[p] = s.dwo[p] + s.dwp[p] + s.dwc[p] + sum;
    }
  }
  __syncthreads();
  float ds = 0.0f;
  for (int p = tid; p < g.n; p += nt) ds += s.e[p] * s.wt[p];
  ds = block_reduce<false>(ds, s.red);
  if (tid == 0) s.slot[0] = ds;
  cluster_arrive();  // the slots, read after the work below
  const int ec = cdiv(E, kNC), k1 = min(E, (rank + 1) * ec);
  for (int k = rank * ec + tid; k < k1; k += nt) a.dctx_tot[row * E + k] = s.dcx[k];
  // the taps of N for this thread's first (carry, position) of the conv,
  // nv[k] = N[2k + c][q + pad - k], in flight through dq
  const float* nr = a.r.n + rs * J * S;
  auto ntap = [&](int k, int c, int q) {
    const int p = g.s0 + q + g.pad - k;
    return p >= 0 && p < S ? __ldg(nr + (size_t)(2 * k + c) * S + p) : 0.0f;
  };
  const bool pre = tid < 2 * g.n;
  const int c0 = pre ? tid / g.n : 0, q0 = pre ? tid - c0 * g.n : 0;
  float nv[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) nv[k] = pre && k < d.K ? ntap(k, c0, q0) : 0.0f;
  cluster_wait();
  float dsum = 0.0f;
  for (int r = 0; r < kNC; ++r) dsum += *cl.map_shared_rank(s.slot, r);
  for (int p = tid; p < g.n; p += nt) {
    const float de = s.wt[p] * (s.e[p] - dsum);
    s.dl[g.pad + p] = de;
    a.r.de[rs * S + g.s0 + p] = de;
  }
  cp_async_wait<0>();
  __syncthreads();
  // dq partials: sum_p de[p] G[p][u] over interleaved positions
  const int ng = ChainSmem::groups(g);
  for (int i = tid; i < ng * g.A4; i += nt) {
    const int grp = i / g.A4, u = i - grp * g.A4;
    const float vu = s.v[u];
    float acc = 0.0f;
    for (int p = grp; p < g.n; p += ng) {  // dta rounded as the twin's de v (1 - ta^2)
      const float x = s.ta[p * g.A4 + u];
      acc += __fmul_rn(s.dl[g.pad + p] * vu, 1.0f - x * x);
    }
    s.dqp[i] = acc;
  }
  __syncthreads();
  for (int u = tid; u < g.A4; u += nt) {
    float acc = 0.0f;
    for (int grp = 0; grp < ng; ++grp) acc += s.dqp[grp * g.A4 + u];
    s.dqc[u] = acc;
  }
  cl.sync();
  // dq of the row: this CTA adds the partials of its slice of A, in rank order
  const int ac = cdiv(A, kNC), a1 = min(A, (rank + 1) * ac);
  for (int u = rank * ac + tid; u < a1; u += nt) {
    float acc = 0.0f;
    for (int r = 0; r < kNC; ++r) acc += cl.map_shared_rank(s.dqc, r)[u];
    a.dq[(size_t)b * A + u] = acc;
  }
  // de over the halo, from the CTAs that own it (zero outside the sequence)
  for (int h = tid; h < g.L; h += nt) {
    if (h >= g.pad && h < g.pad + g.n) continue;
    const int q = g.s0 - g.pad + h;
    float val = 0.0f;
    if (q >= 0 && q < S) {
      const int r = q / g.Sc;
      val = cl.map_shared_rank(s.dl, r)[g.pad + q - r * g.Sc];
    }
    s.dl[h] = val;
  }
  cluster_arrive();  // done with the other CTAs' shared memory
  __syncthreads();
  // transposed location conv through N: dfeat[q][c] = sum_k de[q + pad - k]
  // N[2k + c][q + pad - k], the taps in order
  for (int i = tid; i < 2 * g.n; i += nt) {
    const int c = i / g.n, q = i - c * g.n;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      if (k >= d.K) break;
      acc = fmaf(s.dl[q + 2 * g.pad - k], i == tid ? nv[k] : ntap(k, c, q), acc);
    }
    for (int k = kTaps; k < d.K; ++k) acc = fmaf(s.dl[q + 2 * g.pad - k], ntap(k, c, q), acc);
    if (c == 0)
      dwp[q] = acc;
    else
      dwc[q] = acc + s.dwc[q];
  }
  cluster_wait();  // the dl and dqc of this CTA stay until the cluster has read them
}

// Accumulation pass, one CTA a (row, S / kNC positions) over a chunk's
// steps in reverse time: dloc = de M (stream dtype), dpmem += de G, and this
// CTA's partials dv += de ta and dWld += loc^T (de G) (4 x 4 tiles of
// (filter, unit) a thread, the filters fastest: a warp reads 8 loc and 4
// dta vectors a position; the tiles' sums kept row by row, [r][tile][4],
// so that a warp's loads and stores of them are contiguous), in sub-tiles
// of rows() positions whose dpmem rows stay in shared memory over the
// chunk.  The next step's ring tiles
// come in by cp.async while a step is worked (two buffers).
struct AccSmem {
  float *dwl, *dvs, *v, *dta, *dpm, *ta[2], *loc[2], *m[2], *de[2];
  __host__ __device__ static int rows(const AttGeo& g) {
    const int r = 4096 / g.A4;
    return r < 1 ? 1 : r > 32 ? 32 : r;
  }
  __host__ __device__ static int buffer(const AttGeo& g) {  // one step's tiles
    const int R = rows(g);
    return R * g.A4 + 2 * R * g.F4 + up4(R);
  }
  __host__ __device__ static int floats(const AttGeo& g) {
    return g.F4 * g.A4 + 2 * g.A4 + 2 * rows(g) * g.A4 + 2 * buffer(g);
  }
  __device__ AccSmem(float* sm, const AttGeo& g) {
    const int R = rows(g);
    dwl = sm;                   // dWld partial (4, nFq * nAq, 4)
    dvs = dwl + g.F4 * g.A4;    // dv partial (A4)
    v = dvs + g.A4;             // v (A4)
    dta = v + g.A4;             // de G (R, A4)
    dpm = dta + R * g.A4;       // dpmem rows (R, A4)
    float* p = dpm + R * g.A4;
    for (int k = 0; k < 2; ++k) {
      ta[k] = p;                // (R, A4)
      loc[k] = ta[k] + R * g.A4;  // (R, F4)
      m[k] = loc[k] + R * g.F4;   // (R, F4)
      de[k] = m[k] + R * g.F4;    // (R)
      p += buffer(g);
    }
  }
};

template <typename T>
__device__ __forceinline__ void att_accum(const BwdAtt& a, int t0, int steps) {
  extern __shared__ __align__(16) float sm[];
  const Dims& d = a.d;
  const int S = d.S, A = d.A, F = d.F, nt = blockDim.x, tid = threadIdx.x;
  const int rank = blockIdx.x, b = blockIdx.y;
  const AttGeo g(d, rank);
  const AccSmem s(sm, g);
  const int R = AccSmem::rows(g), RA = R * g.A4, nit = cdiv(g.n, R) * steps;
  T* dlo = static_cast<T*>(a.dloc);
  for (int i = tid; i < g.F4 * g.A4; i += nt) s.dwl[i] = 0.0f;
  for (int u = tid; u < g.A4; u += nt) {
    s.dvs[u] = 0.0f;
    s.v[u] = u < A ? a.v[u] : 0.0f;
  }
  // iteration it: sub-tile it / steps, the steps of the chunk from the last
  auto stage = [&](int it, int k) {
    const int p0 = (it / steps) * R, np = min(R, g.n - p0);
    const size_t o = ((size_t)(steps - 1 - it % steps) * d.B + b) * S + g.s0 + p0;
    stage_rows(s.ta[k], g.A4, a.r.ta + o * A, A, R, np, A);
    stage_rows(s.loc[k], g.F4, a.r.loc + o * F, F, R, np, F);
    stage_rows(s.m[k], g.F4, a.r.m + o * F, F, R, np, F);
    stage_rows(s.de[k], up4(R), a.r.de + o, 0, 1, 1, np);
    cp_async_commit();
  };
  if (nit > 0) stage(0, 0);
  for (int it = 0; it < nit; ++it) {
    const int k = it & 1, sl = steps - 1 - it % steps;
    const int p0 = (it / steps) * R, np = min(R, g.n - p0), ps = g.s0 + p0;
    float* dpmem = a.dpmem + ((size_t)b * S + ps) * A;
    __syncthreads();  // the other buffer and dpm are free
    if (sl == steps - 1) {  // a sub-tile starts: its dpmem rows
      stage_rows(s.dpm, g.A4, dpmem, A, R, np, A);
      cp_async_commit();
    }
    if (it + 1 < nit) {
      stage(it + 1, k ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float *ta = s.ta[k], *de = s.de[k], *mm = s.m[k];
    // de G into dpmem's rows and the dWld operand
    for_2d(R, g.A4, [&](int p, int u) {
      const int i = p * g.A4 + u;
      const float x = ta[i], gd = __fmul_rn(de[p] * s.v[u], 1.0f - x * x);
      s.dta[i] = gd;
      s.dpm[i] += gd;
    });
    for (int u = tid; u < g.A4; u += nt) {
      float acc = s.dvs[u];
      for (int p = 0; p < np; ++p) acc = fmaf(ta[p * g.A4 + u], de[p], acc);
      s.dvs[u] = acc;
    }
    T* dl = dlo + (((size_t)(t0 + sl) * d.B + b) * S + ps) * F;
    for_2d(np, F, [&](int p, int f) { dl[p * F + f] = from_f<T>(de[p] * mm[p * g.F4 + f]); });
    __syncthreads();
    // dWld += loc^T dta
    const float* lo = s.loc[k];
    const int nti = g.nFq * g.nAq;
    for (int i = tid; i < nti; i += nt) {
      const int fq = i % g.nFq, aq = i / g.nFq;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 w = *reinterpret_cast<const float4*>(s.dwl + (r * nti + i) * 4);
        acc[r][0] = w.x;
        acc[r][1] = w.y;
        acc[r][2] = w.z;
        acc[r][3] = w.w;
      }
      for (int p = 0; p < np; ++p) {
        const float4 lv = *reinterpret_cast<const float4*>(lo + p * g.F4 + 4 * fq);
        const float4 dv = *reinterpret_cast<const float4*>(s.dta + p * g.A4 + 4 * aq);
        const float lr[4] = {lv.x, lv.y, lv.z, lv.w}, dc[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(lr[r], dc[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
        *reinterpret_cast<float4*>(s.dwl + (r * nti + i) * 4) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
    if (sl == 0)  // the sub-tile's last step: its dpmem rows back (each thread its own)
      for_2d(np, A, [&](int p, int u) { dpmem[(size_t)p * A + u] = s.dpm[p * g.A4 + u]; });
  }
  __syncthreads();
  const size_t own = (size_t)b * kNC + rank;
  for (int u = tid; u < A; u += nt) a.dv_part[own * A + u] += s.dvs[u];
  for_2d(F, A, [&](int f, int u) {  // row f % 4 of tile (f / 4, u / 4), column u % 4
    const int tile = (u / 4) * g.nFq + f / 4;
    a.dwld_part[(own * F + f) * A + u] += s.dwl[((f % 4) * g.nFq * g.nAq + tile) * 4 + u % 4];
  });
}

// K4's attention backward in three phases, all under one name so that a
// profile sums them: kCoef (grid (cdiv(S, kCoefPos), B, steps of the chunk
// from t)), kChain (cluster (kNC, B) at step t, slot n) and kAccum (grid
// (kNC, B), the n steps of the chunk from t).
template <typename T, int kPhase>
__global__ void __launch_bounds__(kAttThreads, kPhase == kChain ? 3 : 2)
    att_bwd(BwdAtt a, int t, int n) {
  if constexpr (kPhase == kCoef)
    att_coef(a, t);
  else if constexpr (kPhase == kChain)
    att_chain(a, t, n);
  else
    att_accum<T>(a, t, n);
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
                int C, bool graph, const GraphKey& key, cudaStream_t st,
                long long* coef_steps) {
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
  const AttGeo gc(d, 0, kCoefPos), g0(d, 0);
  const size_t coef_smem = (size_t)CoefSmem::floats(d, gc) * sizeof(float);
  const size_t chain_smem = (size_t)ChainSmem::floats(d, g0) * sizeof(float);
  const size_t acc_smem = (size_t)AccSmem::floats(g0) * sizeof(float);
  const size_t ew_smem = (size_t)(B * (A + 1) + kUnits * (A + B)) * sizeof(float);
  const size_t tc_smem = TcRing<kTcCols, kTcStages>::kSmemBytes;
  cudaError_t err = smem_attr((const void*)att_bwd<T, kCoef>, coef_smem);
  if (err == cudaSuccess) err = smem_attr((const void*)att_bwd<T, kChain>, chain_smem);
  if (err == cudaSuccess) err = smem_attr((const void*)att_bwd<T, kAccum>, acc_smem);
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
  // the chain's cluster launch
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = kNC;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t chain = {};
  chain.gridDim = dim3(kNC, B);
  chain.blockDim = dim3(kAttThreads);
  chain.dynamicSmemBytes = chain_smem;
  chain.attrs = cluster;
  chain.numAttrs = 1;
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
  // returns the reverse steps whose coefficient pass it launched
  auto enqueue = [&](cudaStream_t s) -> long long {
    chain.stream = s;
    long long coef = 0;
    // chunks of C steps from the last: coefficients, the chain, accumulation
    for (int hi = d.T - 1; hi >= 0; hi -= C) {
      const int lo = max(0, hi - C + 1), n = hi - lo + 1;
      att_query<<<dim3(cdiv(A, 32), cdiv(H, kQChunk), n), 256, 0, s>>>(
          h_att + (size_t)lo * BH, B, H, wq, A, ba.r.q);
      att_bwd<T, kCoef><<<dim3(cdiv(d.S, kCoefPos), B, n), kAttThreads, coef_smem, s>>>(ba, lo, n);
      coef += n;
      for (int t = hi; t >= lo; --t) {
        const size_t o = (size_t)t * BH;
        lstm_bwd<T><<<H / kUnits, kEwThreads, 0, s>>>(
            B, H, g_dec + 4 * o, c_dec_prev + o, dh_dec_out + o, H, dx_dec + H + E, Kd, dc_dec,
            m3 ? m3 + o : nullptr, m4 ? m4 + o : nullptr, dg_dec + 4 * o, nullptr, nullptr,
            nullptr, A, nullptr);
        product(s, dg_dec + 4 * o, mgd, mwd, dec_w, Kd, t, od);
        cudaLaunchKernelEx(&chain, att_bwd<T, kChain>, ba, t, t - lo);
        lstm_bwd<T><<<H / kUnits, kEwThreads, ew_smem, s>>>(
            B, H, g_att + 4 * o, c_att_prev + o, dx_dec, Kd, dh_att_c, H, dc_att,
            m1 ? m1 + o : nullptr, m2 ? m2 + o : nullptr, dg_att + 4 * o, h_att + o, ba.dq, wq,
            A, dwq);
        const OutSeg3 oa{{dpn + (size_t)t * B * P, ba.dctx_c, dh_att_c}, {P, E, H}, {P, E, H}};
        product(s, dg_att + 4 * o, mga, mwa, attn_w, Ka, t, oa);
      }
      att_bwd<T, kAccum><<<dim3(kNC, B), kAttThreads, acc_smem, s>>>(ba, lo, n);
    }
    sum_rows<<<1, 256, 0, s>>>(ba.dv_part, B * kNC, A, dv);
    sum_rows<<<(d.F * A + 255) / 256, 256, 0, s>>>(ba.dwld_part, B * kNC, d.F * A, dwld);
    return coef;
  };
  return launch_loop(enqueue, graph, graphs, key, st, coef_steps);
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
// (kSplit, B, max(2H+E, P+E+H)) (float32 stream), ring (the coefficients
// of C steps, Ring: each of its six arrays rounded up to kRingAlign
// floats).  C, the steps of a chunk, is 1..T.  graph != 0 replays the loop
// from a CUDA graph.  *coef_steps gets the reverse steps whose coefficient
// pass the loop launched (its graph's count when replayed): T when every
// chunk ran it.  Returns a cudaError_t.
extern "C" int t2v_teacher_bwd(
    int dtype, int T, int B, int S, int E, int H, int P, int A, int F, int K, int C, int graph,
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
    const float* zeros, float* part, float* ring, long long* coef_steps, void* stream) {
  if (B < 1 || B > kRows || H % kUnits != 0 || K % 2 == 0 || T < 1 || C < 1 || C > T ||
      (m1 == nullptr) != (m4 == nullptr))
    return (int)cudaErrorInvalidValue;
  const Dims d{T, B, S, E, H, P, A, F, K};
  const BwdAtt ba{d, loc_w, loc_dense_w, v, memory, pmem, zeros,
                  dctx, dw, w_seq, w_cum_prev, dx_dec,
                  dctx_c, dw_prev_c, dwcum_c,
                  dctx_tot, dq, dv_part, dwld_part, dpmem, dloc, carve_ring(ring, d, C)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const GraphKey key = make_key(
      dtype, T, B, S, E, H, P, A, F, K, C, attn_w, dec_w, query_w, loc_w, loc_dense_w, v, memory,
      pmem, m1, m2, m3, m4, dh_dec, dctx, dw, g_att, g_dec, c_att_prev, c_dec_prev, h_att, w_seq,
      w_cum_prev, dg_att, dg_dec, dpn, dctx_tot, dloc, dv, dwq, dwld, dpmem, dx_dec, dh_att_c,
      dctx_c, dc_att, dc_dec, dw_prev_c, dwcum_c, dq, dv_part, dwld_part, zeros, part, ring);
  auto go = [&](auto tag) {  // tag: a null T*
    using T = std::remove_pointer_t<decltype(tag)>;
    return run<T>(ba, query_w, attn_w, dec_w, m1, m2, m3, m4, dh_dec, g_att, g_dec, c_att_prev,
                  c_dec_prev, h_att, dg_att, dg_dec, dpn, dv, dwq, dwld, dx_dec, dh_att_c, dc_att,
                  dc_dec, part, C, graph != 0, key, st, coef_steps);
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
