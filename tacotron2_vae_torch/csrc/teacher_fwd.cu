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
// GFLOP per step at B=64 (1.2 TFLOP over T=512), ~1.2 ms per call at the
// bf16 tensor rate; the 36 MB of bf16 weights read every step (most of it
// from the 50 MB L2); and the float32 attention (~0.11 GFLOP per step).
// Every step depends on the one before, so a step is a chain of short
// kernels and its latency, not the card's rates, is what a call costs.
//
// Design: per step four kernels (bf16 stream), launched by the host loop in
// t2v_teacher_fwd and replayed from one CUDA graph of the whole loop:
//   lstm_tc   attention LSTM product on wgmma: a CTA owns 64 hidden units,
//             i.e. all four gate columns of them (N = 256 = 4 x 64, four
//             TMA boxes of the (K, 4H) weight read MN-major as stored, no
//             transposed copy, marked evict-last in L2), for all B <= 64
//             rows (the warpgroup's M = 64; rows past B are zeros), and one
//             of kTcSplit reduction chunks; a producer warp keeps a 2-stage
//             TMA ring of 64-deep tiles ahead of one consumer warpgroup (two
//             CTAs an SM: at one an SM only 15 of the 16 clusters of 8 fit
//             at once).  The kTcSplit CTAs of a unit block form a cluster:
//             their partial tiles are added in order through distributed
//             shared memory, each CTA finishing 8 of the 64 units: bias,
//             gates stored in bf16, the cell update in float32, dropout
//             masks, and h written in float32 and as the bf16 operand of
//             the next products (rounded where the scan rounds).  The
//             activations are read as bf16 operand matrices written once
//             per step (Xa, Xd: [prenet|ctx|h_att], [h_att|ctx|h_dec],
//             double-buffered by step parity), not re-read in float32 by
//             every column block.
//   att_query q = h_att . query_w for all rows at once (query_w read once a
//             step), in kQChunk partials the attention adds in order.
//   att_fwd   the attention of a row on a cluster of kNC CTAs, each owning
//             S / kNC positions: location conv, the (S x F) . (F x A)
//             loc_dense product register-tiled 4 x 4 per thread, tanh, v,
//             mask; softmax max and sum and the context partials exchanged
//             through distributed shared memory (sums in rank order).  B =
//             64 rows occupy 256 CTAs in one wave.
//   lstm_tc   the decoder LSTM on [h_att_t, ctx_t, h_dec_{t-1}].
// The float32 stream keeps FFMA products (lstm_gemm + lstm_cell, split
// over kSplit reduction chunks summed in order); it is checked, not tuned.
// A CUDA graph of the step loop was chosen over a persistent kernel with
// grid barriers: the phases need different parallel layouts and cluster
// shapes (8-CTA split-K clusters, 4-CTA attention clusters) that one
// cooperative grid cannot take.  Measured at B=64, S=128, T=512, bf16 (H100
// 80GB HBM3, 700 W; PERF.md): launched kernel by kernel a step leaves 6.6
// to 6.7 us (K3) and 9.4 to 10.4 us (K4) between its kernels, replayed from
// a graph about 1 us; capturing and instantiating a call's 2,051- or
// 3,074-node graph costs 12-16 or 23-34 ms, so the graphs of the last four
// sets of sizes are kept (launch_loop in teacher_common.cuh), and a call at
// known sizes with new pointers updates its graph in place.
// The float16 stream (fp16_run) runs the bf16 stream's kernels instantiated
// on __half: f16 wgmma products, f16 TMA maps, gates and operands rounded
// to f16 (round to nearest even; past 65504 a value becomes inf, which the
// step's overflow check must see).
// No float atomics: every sum has one owner and a fixed order.

#include "teacher_common.cuh"

namespace {

using namespace t2v;

constexpr int kRows = 64;     // batch rows per tile (all of B)
constexpr int kUnits = 8;     // hidden units per block (float32 products)
constexpr int kBK = 32;       // k per shared tile (float32 products)
constexpr int kGemmThreads = 128;
constexpr int kXs = kRows + 4;  // padded row stride of the staged x tile
constexpr int kTcUnits = 64;  // hidden units per wgmma CTA (N = 4 x 64)
constexpr int kTcStages = 2;  // TMA ring depth: 81 KB of shared memory, two CTAs an SM
constexpr int kPartLd = 4 * kTcUnits + 8;  // row stride of a CTA's partial tile

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


// The cell of one LSTM at step t, applied by the clusters of lstm_tc; T is
// the 2-byte stream type (bf16 or f16).
template <typename T>
struct Cell {
  const float* bias;            // (4H)
  const float* c_prev;          // (B, H)
  float* c_next;                // (B, H) or null (last step)
  float* h_out;                 // (B, H) float32
  T* g_out;                     // (B, 4H) the gates, stored in T
  const T *mh, *mc;             // dropout masks (B, H) or null
  T* x1;                        // T copy of h into an operand matrix (row stride ld1)
  int ld1;
  T* x2;                        // a second copy, or null
  int ld2;
  const float* pn;              // the next step's prenet rows (B, P) or null
  T* pn_dst;                    // their T copy (row stride ldp)
  int P, ldp;
};

// LSTM product and cell in a 2-byte stream type T: gates (B, 4H) = X (64 x
// K, T, zero rows past B) . W (K, 4H) + bias for the CTA's 64 units, split
// over the kTcSplit CTAs of a cluster (see the note at the top).  X[par]
// and W are TMA maps.
template <typename T>
__global__ void __cluster_dims__(1, kTcSplit, 1) __launch_bounds__(kTcThreads)
lstm_tc(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw, int par,
        int K, int H, int B, Cell<T> c) {
  extern __shared__ uint8_t smraw[];
  using R = TcRing<4 * kTcUnits, kTcStages>;
  uint8_t* ring = align1024(smraw);
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), j0 = blockIdx.x * kTcUnits;
  const int ntiles = cdiv(K, kTileK), per = cdiv(ntiles, kTcSplit);
  const int it0 = min(ntiles, rank * per), it1 = min(ntiles, it0 + per);
  tc_init_barriers<4 * kTcUnits, kTcStages>(ring);
  float acc[2 * kTcUnits];
#pragma unroll
  for (int i = 0; i < 2 * kTcUnits; ++i) acc[i] = 0.0f;
  const CUtensorMap *pmx = &mx, *pmw = &mw;
  // MN-major weight tile: 64-unit boxes (kBBytes / 4 apart) of 64 k rows,
  // 8-row k groups 1 KB apart
  tc_mainloop<T, 4 * kTcUnits, kTcStages, true>(
      ring, it0, it1, R::kBBytes / 4, 1024,
      [&](uint8_t* sa, uint8_t* sb, uint64_t* bar, int it) {
        const int k0 = it * kTileK;
        tma_3d(sa, pmx, bar, k0, 0, par);
#pragma unroll
        for (int g = 0; g < 4; ++g) tma_2d_keep(sb + g * (R::kBBytes / 4), pmw, bar, g * H + j0, k0);
      },
      acc);
  __syncthreads();  // every stage consumed: the ring becomes the partial tile
  float* part = reinterpret_cast<float*>(ring);
  if (threadIdx.x < 128) tc_store<4 * kTcUnits>(acc, part, kPartLd);
  // this CTA finishes units [8 rank, 8 rank + 8) of the block, 4 of one row
  // a thread; what the cell reads besides the gates is loaded before the
  // cluster barrier, the partials after it (added in rank order)
  constexpr int upc = kTcUnits / kTcSplit, ipr = upc / 4;
  static_assert(kRows * ipr <= kTcThreads, "one epilogue item a thread");
  const int b = threadIdx.x / ipr, j = j0 + rank * upc + 4 * (threadIdx.x % ipr), H4 = 4 * H;
  const bool mine = threadIdx.x < kRows * ipr && b < B && j < H;
  float bias[4][4], cp[4], mhv[4], mcv[4];
  if (mine) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int g = 0; g < 4; ++g) bias[g][e] = c.bias[g * H + j + e];
      const size_t bj = (size_t)b * H + j + e;
      cp[e] = c.c_prev[bj];
      mhv[e] = c.mh != nullptr ? to_f<T>(c.mh[bj]) : 1.0f;
      mcv[e] = c.mh != nullptr ? to_f<T>(c.mc[bj]) : 1.0f;
    }
  }
  cl.sync();
  if (mine) {
    float4 gs[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) gs[g] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int r = 0; r < kTcSplit; ++r) {
      const float* pr = part + b * kPartLd + (j - j0);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float4 v = ld_dsmem4(pr + g * kTcUnits, r);
        gs[g].x += v.x;
        gs[g].y += v.y;
        gs[g].z += v.z;
        gs[g].w += v.w;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float gv[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float4& v = gs[g];
        gv[g] = (e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w) + bias[g][e];
        c.g_out[(size_t)b * H4 + g * H + j + e] = from_f<T>(gv[g]);
      }
      const size_t bj = (size_t)b * H + j + e;
      float cc = sigm(gv[1]) * cp[e] + sigm(gv[0]) * tanhf(gv[2]);
      float h = sigm(gv[3]) * tanhf(cc);
      if (c.mh != nullptr) {
        h *= mhv[e];
        cc *= mcv[e];
      }
      c.h_out[bj] = h;
      if (c.c_next != nullptr) c.c_next[bj] = cc;
      c.x1[(size_t)b * c.ld1 + j + e] = from_f<T>(h);
      if (c.x2 != nullptr) c.x2[(size_t)b * c.ld2 + j + e] = from_f<T>(h);
    }
  }
  if (c.pn != nullptr) {
    const int stride = gridDim.x * gridDim.y * blockDim.x;
    for (int i = (blockIdx.y * gridDim.x + blockIdx.x) * blockDim.x + threadIdx.x; i < B * c.P;
         i += stride)
      c.pn_dst[(size_t)(i / c.P) * c.ldp + i % c.P] = from_f<T>(c.pn[i]);
  }
  cl.sync();  // the partial tiles stay until every CTA of the cluster has read them
}

// dst[b][k] = T(src[b][k]) for a (B, P) float32 block (row stride ld).
template <typename T>
__global__ void round_rows(const float* __restrict__ src, int B, int P, T* __restrict__ dst,
                           int ld) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < B * P; i += gridDim.x * blockDim.x)
    dst[(size_t)(i / P) * ld + i % P] = from_f<T>(src[i]);
}

struct FwdAtt {
  Dims d;
  const float *wq, *qpart, *locw, *ldw, *v, *mem, *pmem, *addmask, *zeros;
  float *w, *wcum, *ctx;
  void *xd, *xa;  // copies of ctx_t in the 2-byte stream type T at its operand columns, or null
  int ldd, lda;
};

// Attention of row blockIdx.y at step t on a cluster of kNC CTAs.
template <typename T>
__global__ void __cluster_dims__(kNC, 1, 1) __launch_bounds__(kAttThreads)
att_fwd(FwdAtt a, int t) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cl = cg::this_cluster();
  const Dims& d = a.d;
  const int rank = (int)cl.block_rank(), b = blockIdx.y, S = d.S, E = d.E;
  const AttGeo g(d, rank);
  const AttSmem s(sm, d, g, false);
  const size_t row = (size_t)t * d.B + b;
  const float* w_prev = t > 0 ? a.w + (row - d.B) * S : a.zeros;
  float* wcum = a.wcum + (size_t)b * S;
  att_stage(s, d, g, b, a.qpart, a.v, w_prev, wcum, a.locw, a.ldw);
  __syncthreads();
  att_loc(s, d, g);
  __syncthreads();
  const float* pm = a.pmem + ((size_t)b * S + g.s0) * d.A;
  for (int i = threadIdx.x; i < (g.Sc4 / 4) * g.nAq; i += blockDim.x) {
    const int pq = i / g.nAq, aq = i - pq * g.nAq;
    float ta[4][4];
    att_tanh_tile(s, d, g, pm, pq, aq, ta);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float acc = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc = fmaf(s.v[4 * aq + c], ta[r][c], acc);
      s.epart[(4 * pq + r) * (g.nAq + 1) + aq] = acc;
    }
  }
  __syncthreads();
  float m = -3.402823466e38f;
  for (int p = threadIdx.x; p < g.n; p += blockDim.x) {
    float acc = 0.0f;
    for (int aq = 0; aq < g.nAq; ++aq) acc += s.epart[p * (g.nAq + 1) + aq];
    const float e = acc + a.addmask[(size_t)b * S + g.s0 + p];
    s.e[p] = e;
    m = fmaxf(m, e);
  }
  m = block_reduce<true>(m, s.red);
  if (threadIdx.x == 0) s.slot[0] = m;
  cl.sync();  // also: every CTA has staged its w_cum halo before any update below
  float mx = -3.402823466e38f;
  for (int r = 0; r < kNC; ++r) mx = fmaxf(mx, *cl.map_shared_rank(s.slot, r));
  float sum = 0.0f;
  for (int p = threadIdx.x; p < g.n; p += blockDim.x) {
    const float ex = expf(s.e[p] - mx);
    s.e[p] = ex;
    sum += ex;
  }
  sum = block_reduce<false>(sum, s.red);
  if (threadIdx.x == 0) s.slot[1] = sum;
  cl.sync();
  float tot = 0.0f;
  for (int r = 0; r < kNC; ++r) tot += *cl.map_shared_rank(s.slot + 1, r);
  for (int p = threadIdx.x; p < g.n; p += blockDim.x) {
    const float wt = s.e[p] / tot;
    s.e[p] = wt;
    a.w[row * S + g.s0 + p] = wt;
    wcum[g.s0 + p] += wt;
  }
  __syncthreads();
  att_context(a.mem + ((size_t)b * S + g.s0) * E, s.e, g.n, E, s.csc, s.cpart);
  cl.sync();
  // this CTA adds the context partials of its slice of E, in rank order
  const int ec = cdiv(E, kNC), k1 = min(E, (rank + 1) * ec);
  for (int k = rank * ec + threadIdx.x; k < k1; k += blockDim.x) {
    float acc = 0.0f;
    for (int r = 0; r < kNC; ++r) acc += cl.map_shared_rank(s.cpart, r)[k];
    a.ctx[row * E + k] = acc;
    if (a.xd != nullptr) {
      static_cast<T*>(a.xd)[(size_t)b * a.ldd + k] = from_f<T>(acc);
      static_cast<T*>(a.xa)[(size_t)b * a.lda + k] = from_f<T>(acc);
    }
  }
  cl.sync();
}

struct Scratch {
  float *part, *qpart;
  void *xa, *xd;  // (2, 64, kap) and (2, 64, kdp) operand matrices in the 2-byte stream type
};

GraphCache graphs;  // the step loops of the last calls, as CUDA graphs

template <typename T>
cudaError_t run(const Dims& d, const void* attn_w_, const float* attn_b, const void* dec_w_,
                const float* dec_b, FwdAtt fa, const float* prenet, const void* m1_,
                const void* m2_, const void* m3_, const void* m4_, float* h_dec, float* h_att,
                void* g_att_, void* g_dec_, float* c_att, float* c_dec, Scratch sc, bool graph,
                const GraphKey& key, cudaStream_t st) {
  const T* attn_w = static_cast<const T*>(attn_w_);
  const T* dec_w = static_cast<const T*>(dec_w_);
  const T *m1 = static_cast<const T*>(m1_), *m2 = static_cast<const T*>(m2_);
  const T *m3 = static_cast<const T*>(m3_), *m4 = static_cast<const T*>(m4_);
  T* g_att = static_cast<T*>(g_att_);
  T* g_dec = static_cast<T*>(g_dec_);
  constexpr bool kTc = is_tc<T>();
  // the operand matrices, in T (used by the tensor-core streams only)
  T* const xa = static_cast<T*>(sc.xa);
  T* const xd = static_cast<T*>(sc.xd);
  const size_t att_smem = (size_t)AttSmem::fwd_floats(d) * sizeof(float);
  const size_t tc_smem = TcRing<4 * kTcUnits, kTcStages>::kSmemBytes;
  cudaError_t err = smem_attr((const void*)att_fwd<T>, att_smem);
  if constexpr (kTc)
    if (err == cudaSuccess) err = smem_attr((const void*)lstm_tc<T>, tc_smem);
  if (err != cudaSuccess) return err;
  const int B = d.B, H = d.H, E = d.E, P = d.P, A = d.A;
  const size_t BH = (size_t)B * H;
  const int Ka = P + E + H, Kd = 2 * H + E, H4 = 4 * H;
  const int kap = cdiv(Ka, kTileK) * kTileK, kdp = cdiv(Kd, kTileK) * kTileK;
  const size_t xa_n = (size_t)kRows * kap, xd_n = (size_t)kRows * kdp;
  CUtensorMap mxa, mxd, mwa, mwd;
  if constexpr (kTc) {
    const uint64_t dxa[3] = {(uint64_t)kap, kRows, 2}, dxd[3] = {(uint64_t)kdp, kRows, 2};
    const uint64_t dwa[2] = {(uint64_t)H4, (uint64_t)Ka}, dwd[2] = {(uint64_t)H4, (uint64_t)Kd};
    const uint32_t bx[3] = {kTileK, kRows, 1}, bw[2] = {kTcUnits, kTileK};
    if ((err = tensor_map<T>(&mxa, xa, 3, dxa, bx)) != cudaSuccess ||
        (err = tensor_map<T>(&mxd, xd, 3, dxd, bx)) != cudaSuccess ||
        (err = tensor_map<T>(&mwa, attn_w, 2, dwa, bw)) != cudaSuccess ||
        (err = tensor_map<T>(&mwd, dec_w, 2, dwd, bw)) != cudaSuccess)
      return err;
  }
  const dim3 tc_grid(cdiv(H, kTcUnits), kTcSplit), att_grid(kNC, B);
  const dim3 q_grid(cdiv(A, 32), cdiv(H, kQChunk));
  const int grid = H / kUnits, cells = (B * H + 255) / 256;
  auto chunk = [](int K) { return (K / kSplit + kBK - 1) / kBK * kBK; };
  auto enqueue = [&](cudaStream_t s) {
    if constexpr (kTc) {
      cudaMemsetAsync(xa, 0, 2 * xa_n * sizeof(T), s);
      cudaMemsetAsync(xd, 0, 2 * xd_n * sizeof(T), s);
      round_rows<T><<<cdiv(B * P, 256), 256, 0, s>>>(prenet, B, P, xa, kap);
    }
    for (int t = 0; t < d.T; ++t) {
      const size_t o = (size_t)t * BH;
      const bool first = t == 0, last = t + 1 == d.T;
      const int par = t & 1;
      T *xa_now = xa + par * xa_n, *xa_next = xa + (1 - par) * xa_n;
      T *xd_now = xd + par * xd_n, *xd_next = xd + (1 - par) * xd_n;
      if constexpr (kTc) {
        const Cell<T> ca{attn_b, c_att + o, last ? nullptr : c_att + o + BH, h_att + o,
                      g_att + 4 * o, m1 ? m1 + o : nullptr, m2 ? m2 + o : nullptr,
                      xd_now, kdp, xa_next + P + E, kap,
                      last ? nullptr : prenet + (size_t)(t + 1) * B * P, xa_next, P, kap};
        lstm_tc<T><<<tc_grid, kTcThreads, tc_smem, s>>>(mxa, mwa, par, Ka, H, B, ca);
      } else {
        const Seg3 xa{{prenet + (size_t)t * B * P,
                       first ? fa.zeros : fa.ctx + (size_t)(t - 1) * B * E,
                       first ? fa.zeros : h_att + o - BH},
                      {P, E, H}, {P, E, H}};
        lstm_gemm<T><<<dim3(grid, kSplit), kGemmThreads, 0, s>>>(xa, Ka, chunk(Ka), attn_w, H,
                                                                  B, sc.part);
        lstm_cell<T><<<cells, 256, 0, s>>>(sc.part, kSplit, attn_b, H, B, c_att + o,
                                           last ? nullptr : c_att + o + BH, h_att + o,
                                           g_att + 4 * o, m1 ? m1 + o : nullptr,
                                           m2 ? m2 + o : nullptr);
      }
      att_query<<<q_grid, 256, 0, s>>>(h_att + o, B, H, fa.wq, A, sc.qpart);
      FwdAtt at = fa;
      at.xd = kTc ? xd_now + H : nullptr;
      at.xa = kTc ? xa_next + P : nullptr;
      at.ldd = kdp;
      at.lda = kap;
      att_fwd<T><<<att_grid, kAttThreads, att_smem, s>>>(at, t);
      if constexpr (kTc) {
        const Cell<T> cd{dec_b, c_dec + o, last ? nullptr : c_dec + o + BH, h_dec + o,
                      g_dec + 4 * o, m3 ? m3 + o : nullptr, m4 ? m4 + o : nullptr,
                      xd_next + H + E, kdp, nullptr, 0, nullptr, nullptr, P, kap};
        lstm_tc<T><<<tc_grid, kTcThreads, tc_smem, s>>>(mxd, mwd, par, Kd, H, B, cd);
      } else {
        const Seg3 xd{{h_att + o, fa.ctx + (size_t)t * B * E, first ? fa.zeros : h_dec + o - BH},
                      {H, E, H}, {H, E, H}};
        lstm_gemm<T><<<dim3(grid, kSplit), kGemmThreads, 0, s>>>(xd, Kd, chunk(Kd), dec_w, H,
                                                                  B, sc.part);
        lstm_cell<T><<<cells, 256, 0, s>>>(sc.part, kSplit, dec_b, H, B, c_dec + o,
                                           last ? nullptr : c_dec + o + BH, h_dec + o,
                                           g_dec + 4 * o, m3 ? m3 + o : nullptr,
                                           m4 ? m4 + o : nullptr);
      }
    }
  };
  return launch_loop(enqueue, graph, graphs, key, st);
}

}  // namespace

// dtype: 0 = float32 stream, 1 = bfloat16, 2 = float16 (StreamType); any
// other value returns cudaErrorInvalidValue.  Shapes (row-major): attn_w
// (P+E+H, 4H), dec_w (2H+E, 4H) in the stream dtype; attn_b, dec_b (4H);
// query_w (H, A); loc_w (K, 2, F); loc_dense_w (F, A); v (A); prenet
// (T, B, P); memory (B, S, E); pmem (B, S, A); add_mask (B, S); masks m1..m4
// (T, B, H) in the stream dtype, or all null (dropout off).  Outputs: h_dec,
// h_att (T, B, H), ctx (T, B, E), w (T, B, S) float32; g_att, g_dec
// (T, B, 4H) stream dtype; c_att, c_dec (T, B, H) the cell state before each
// step, zeroed by the caller.  Work: wcum (B, S) and zeros (>= B*max(H,E,S))
// zeroed; part (kSplit, B, 4H) float32 (float32 stream); qpart
// (cdiv(H, kQChunk), B, A) float32; xa (2, 64, cdiv(P+E+H, 64) * 64) and xd
// (2, 64, cdiv(2H+E, 64) * 64) in the stream dtype (bf16 and f16 streams).
// graph != 0 replays the loop from a CUDA graph.  Returns a cudaError_t (0 on success).
extern "C" int t2v_teacher_fwd(
    int dtype, int T, int B, int S, int E, int H, int P, int A, int F, int K, int graph,
    const void* attn_w, const float* attn_b, const void* dec_w, const float* dec_b,
    const float* query_w, const float* loc_w, const float* loc_dense_w, const float* v,
    const float* prenet, const float* memory, const float* pmem, const float* add_mask,
    const void* m1, const void* m2, const void* m3, const void* m4,
    float* h_dec, float* ctx, float* w, void* g_att, void* g_dec, float* c_att, float* c_dec,
    float* h_att, float* wcum, const float* zeros, float* part, float* qpart, void* xa, void* xd,
    void* stream) {
  if (B < 1 || B > kRows || H % kUnits != 0 || K % 2 == 0 || T < 1 || P % 4 || E % 4 ||
      (m1 == nullptr) != (m4 == nullptr))
    return (int)cudaErrorInvalidValue;
  const Dims d{T, B, S, E, H, P, A, F, K};
  const FwdAtt fa{d, query_w, qpart, loc_w, loc_dense_w, v, memory, pmem, add_mask, zeros,
                  w, wcum, ctx, nullptr, nullptr, 0, 0};
  const Scratch sc{part, qpart, xa, xd};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const GraphKey key =
      make_key(dtype, T, B, S, E, H, P, A, F, K, attn_w, attn_b, dec_w, dec_b, query_w, loc_w,
               loc_dense_w, v, prenet, memory, pmem, add_mask, m1, m2, m3, m4, h_dec, ctx, w,
               g_att, g_dec, c_att, c_dec, h_att, wcum, zeros, part, qpart, xa, xd);
  auto go = [&](auto tag) {  // tag: a null T*
    using T = std::remove_pointer_t<decltype(tag)>;
    return run<T>(d, attn_w, attn_b, dec_w, dec_b, fa, prenet, m1, m2, m3, m4, h_dec, h_att,
                  g_att, g_dec, c_att, c_dec, sc, graph != 0, key, st);
  };
  switch (dtype) {
    case kF32: return (int)go(static_cast<float*>(nullptr));
    case kBF16: return (int)go(static_cast<__nv_bfloat16*>(nullptr));
    case kF16: return (int)go(static_cast<__half*>(nullptr));
    default: return (int)cudaErrorInvalidValue;
  }
}

// Step-loop graphs instantiated so far by t2v_teacher_fwd (replays and
// updates add none).
extern "C" int t2v_teacher_fwd_graph_captures() {
  std::lock_guard<std::mutex> lock(graphs.mu);
  return graphs.captures;
}

// Graphs given new pointers in place so far by t2v_teacher_fwd.
extern "C" int t2v_teacher_fwd_graph_updates() {
  std::lock_guard<std::mutex> lock(graphs.mu);
  return graphs.updates;
}
