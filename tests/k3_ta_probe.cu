// A probe for tests/test_torch_port_cuda.py: the tanh term of every step's
// attention energies, ta = tanh(q + loc . loc_dense + pmem), computed as
// K3's att_fwd computes it (tacotron2_vae_torch/csrc/teacher_fwd.cu): q from
// att_query one step at a time, a CTA per cluster rank owning S / kNC
// positions (AttGeo(d, rank)), the forward's shared-memory layout, and
// att_stage / att_loc / att_tanh_tile; written out as (T, B, S, A).  K4's
// coefficient pass must write the same bits into its ring.
//
// Built by the test itself: nvcc with the port's flags and -I on its csrc.

#include "teacher_common.cuh"

namespace {

using namespace t2v;

struct Probe {
  Dims d;
  const float *qpart, *locw, *ldw, *v, *pmem, *w_seq, *w_cum_prev, *zeros;
  float* ta;
};

// att_fwd's first half for row blockIdx.y at step t, rank blockIdx.x
__global__ void __launch_bounds__(kAttThreads) ta_fwd(Probe a, int t) {
  extern __shared__ __align__(16) float sm[];
  const Dims& d = a.d;
  const int rank = blockIdx.x, b = blockIdx.y, S = d.S;
  const AttGeo g(d, rank);
  const AttSmem s(sm, d, g, false);
  const size_t row = (size_t)t * d.B + b;
  const float* w_prev = t > 0 ? a.w_seq + (row - d.B) * S : a.zeros;
  att_stage(s, d, g, b, a.qpart, a.v, w_prev, a.w_cum_prev + row * S, a.locw, a.ldw);
  __syncthreads();
  att_loc(s, d, g);
  __syncthreads();
  const float* pm = a.pmem + ((size_t)b * S + g.s0) * d.A;
  float* out = a.ta + (row * S + g.s0) * d.A;
  for (int i = threadIdx.x; i < (g.Sc4 / 4) * g.nAq; i += blockDim.x) {
    const int pq = i / g.nAq, aq = i - pq * g.nAq;
    float ta[4][4];
    att_tanh_tile(s, d, g, pm, pq, aq, ta);
    for (int r = 0; r < 4; ++r)
      for (int c = 0; c < 4; ++c) {
        const int p = 4 * pq + r, u = 4 * aq + c;
        if (p < g.n && u < d.A) out[(size_t)p * d.A + u] = ta[r][c];
      }
  }
}

}  // namespace

// h_att (T, B, H), query_w (H, A), loc_w (K, 2, F), loc_dense_w (F, A),
// v (A), pmem (B, S, A), w_seq and w_cum_prev (T, B, S), zeros (S), all
// float32; qpart (cdiv(H, kQChunk), B, A) scratch; ta (T, B, S, A) out.
extern "C" int t2v_k3_ta_probe(int T, int B, int S, int E, int H, int P, int A, int F, int K,
                               const float* h_att, const float* query_w, const float* loc_w,
                               const float* loc_dense_w, const float* v, const float* pmem,
                               const float* w_seq, const float* w_cum_prev, const float* zeros,
                               float* qpart, float* ta, void* stream) {
  const Dims d{T, B, S, E, H, P, A, F, K};
  const Probe a{d, qpart, loc_w, loc_dense_w, v, pmem, w_seq, w_cum_prev, zeros, ta};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)AttSmem::fwd_floats(d) * sizeof(float);
  cudaError_t err = smem_attr((const void*)ta_fwd, smem);
  if (err != cudaSuccess) return (int)err;
  for (int t = 0; t < T; ++t) {
    att_query<<<dim3(cdiv(A, 32), cdiv(H, kQChunk)), 256, 0, st>>>(
        h_att + (size_t)t * B * H, B, H, query_w, A, qpart);
    ta_fwd<<<dim3(kNC, B), kAttThreads, smem, st>>>(a, t);
  }
  return (int)cudaGetLastError();
}
