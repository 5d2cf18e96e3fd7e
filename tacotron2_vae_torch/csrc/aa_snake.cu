// Anti-aliased SnakeBeta activation (kernel K9): BigVGAN's Activation1d,
// y = Down(SnakeBeta(Up(x))), on (B, C, L) float32 in one pass.
//
// Replaces: no TPU kernel.  The JAX package has no BigVGAN; this kernel
// was added with the port's BigVGAN vocoder (models/bigvgan.py), whose 109
// activations a call are otherwise about ten PyTorch launches and ten full
// passes each, over twice the signal's length (a replicate pad, a depthwise
// transposed convolution, a slice, five elementwise operations, a pad and a
// depthwise strided convolution).
//
// The function, per channel c with x[t] replicated past its ends:
//   Up:   u[m] = 2 sum_p xp[p] f[m + 15 - 2p], m < 2L, xp = x padded by 5
//         (a stride-2 transposed convolution with the 12-tap filter f,
//         scaled by the ratio 2 and cut to [15 : -15]), which comes to
//         u[2i] = 2 sum_{q<6} f[2q+1] x[i+2-q],  u[2i+1] = 2 sum_{q<6} f[2q] x[i+3-q];
//   Snake: s[m] = u[m] + (1 / (e^beta_c + 1e-9)) sin^2(u[m] e^alpha_c);
//   Down: y[t] = sum_{k<12} g[k] s[2t + k - 5], s replicated past its ends
//         (pad 5 left and 6 right, a stride-2 convolution with filter g).
//
// What bounds it on an H100: the bytes.  It reads x once and writes y once,
// 8 bytes a channel-sample in float32, against ~60 operations a sample (two
// 6-tap sums, two sines, one 12-tap sum): ~7.5 operations a byte, far under
// the ~20 at which 67 TFLOP/s of float32 would bound it before 3.35 TB/s.
// The 109 launches of a 9.6 s item (640 mel frames once padded to the
// bucket) move ~3.1 GB, 0.94 ms at the HBM rate.
//
// Design: one block of kThreads threads a tile of kTile outputs of one
// (row, channel), its blocks over every row and tile in one flat grid.  A
// block loads its x tile with a halo of 6 on each side (the indices clamped
// to the row: the replicate padding, resolved on load), computes the 2 kTile
// + 12 upsampled, activated samples its outputs read into shared memory (the
// 2L intermediate never leaves the chip), then the outputs.  Each thread
// works from registers: 8 activated samples from 10 x values (three 16-byte
// shared loads), then 4 outputs from 18 samples (five 16-byte loads) and one
// 16-byte store, so that shared-memory traffic and index arithmetic stay
// well under the sines and multiply-adds (a first version, one sample and one
// output a thread with 6 and 12 scalar shared loads each, ran at 16-20 % of
// the bytes bound; PERF.md).  The samples past the row's ends (replicated
// in s) are computed as if interior and then overwritten by the edge sample,
// in the first and last tile alone.  The filters (24 floats) and the
// channel's e^alpha and 1 / (e^beta + 1e-9) are read or computed once a
// block.  Sines are the accurate sinf (no fast math): the arguments reach
// tens of radians and the plain twin uses torch.sin.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 12;     // both filters: kaiser_sinc_filter1d(0.25, 0.3, 12)
constexpr int kHalo = 6;      // x samples a tile reads past each of its ends
constexpr int kTile = 1024;   // outputs a block
constexpr int kThreads = 256;
constexpr int kPer = kTile / kThreads;   // outputs a thread
constexpr int kXs = kTile + 20;          // the x tile, its halo, the last chunk's slack
constexpr int kSs = 2 * kTile + 24;      // the activated samples (from offset 3), slack

__device__ __forceinline__ float snake(float u, float a, float ib) {
  const float sn = sinf(u * a);
  return u + ib * (sn * sn);
}

__global__ void __launch_bounds__(kThreads)
aa_snake_kernel(const float* __restrict__ x, const float* __restrict__ alpha,
                const float* __restrict__ beta, const float* __restrict__ up,
                const float* __restrict__ down, float* __restrict__ y, int C, int L,
                int n_tiles) {
  __shared__ __align__(16) float xs[kXs];
  __shared__ __align__(16) float sp[kSs];
  __shared__ __align__(16) float fu[kTaps];
  __shared__ __align__(16) float fd[kTaps];
  const int row = blockIdx.x / n_tiles;
  const int t0 = (blockIdx.x - row * n_tiles) * kTile;
  const int nt = min(kTile, L - t0);
  const float* xr = x + (size_t)row * L;
  if (threadIdx.x < kTaps) {
    fu[threadIdx.x] = up[threadIdx.x];
    fd[threadIdx.x] = down[threadIdx.x];
  }
  // xs[j] = x[clamp(t0 - 6 + j)]
  for (int j = threadIdx.x; j < nt + 16; j += kThreads)
    xs[j] = __ldg(xr + min(max(t0 - kHalo + j, 0), L - 1));
  const int c = row % C;
  const float a = expf(__ldg(alpha + c));
  const float ib = 1.0f / (expf(__ldg(beta + c)) + 1e-9f);
  __syncthreads();
  float f[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; k += 4) {
    const float4 v = *reinterpret_cast<const float4*>(fu + k);
    f[k] = v.x, f[k + 1] = v.y, f[k + 2] = v.z, f[k + 3] = v.w;
  }
  // ss[j] = s[m], m = 2 t0 - 6 + j, for the n_s samples the outputs read.
  // Chunk q: ss[8q .. 8q + 8) from x positions i = t0 - 3 + 4q + p, p < 4:
  //   s[2i]     from x[i + 2 - k], k < 6: xv[p + 5 - k]
  //   s[2i + 1] from x[i + 3 - k]:         xv[p + 6 - k]
  // where xv[v] = xs[4q + v].
  float* ss = sp + 3;   // so that each thread's outputs read 16-byte aligned samples
  const int n_s = 2 * nt + 2 * kHalo;
  for (int q = threadIdx.x; 8 * q < n_s; q += kThreads) {
    float xv[12];
    const float4* x4 = reinterpret_cast<const float4*>(xs + 4 * q);
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      const float4 w = x4[v];
      xv[4 * v] = w.x, xv[4 * v + 1] = w.y, xv[4 * v + 2] = w.z, xv[4 * v + 3] = w.w;
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      float ue = 0.0f, uo = 0.0f;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        ue = fmaf(f[2 * k + 1], xv[p + 5 - k], ue);
        uo = fmaf(f[2 * k], xv[p + 6 - k], uo);
      }
      ss[8 * q + 2 * p] = snake(2.0f * ue, a, ib);
      ss[8 * q + 2 * p + 1] = snake(2.0f * uo, a, ib);
    }
  }
  __syncthreads();
  // s is replicated past its ends: the samples before m = 0 and after
  // m = 2L - 1 take the edge's value (first and last tile only)
  const int lo = kHalo - 2 * t0, hi = 2 * L - 1 - 2 * t0 + kHalo;
  if (lo > 0 || hi < n_s - 1) {
    const float s_lo = ss[max(lo, 0)], s_hi = ss[min(hi, n_s - 1)];
    for (int j = threadIdx.x; j < n_s; j += kThreads) {
      if (j < lo) ss[j] = s_lo;
      if (j > hi) ss[j] = s_hi;
    }
    __syncthreads();
  }
  // y[t0 + k0 + p] = sum_j g[j] ss[2 (k0 + p) + 1 + j] = sum_j g[j] sp[2 k0 + 4 + 2p + j]
#pragma unroll
  for (int k = 0; k < kTaps; k += 4) {
    const float4 v = *reinterpret_cast<const float4*>(fd + k);
    f[k] = v.x, f[k + 1] = v.y, f[k + 2] = v.z, f[k + 3] = v.w;
  }
  const int k0 = kPer * threadIdx.x;
  if (k0 < nt) {
    float sv[20];
    const float4* s4 = reinterpret_cast<const float4*>(sp + 2 * k0 + 4);
#pragma unroll
    for (int v = 0; v < 5; ++v) {
      const float4 w = s4[v];
      sv[4 * v] = w.x, sv[4 * v + 1] = w.y, sv[4 * v + 2] = w.z, sv[4 * v + 3] = w.w;
    }
    float acc[kPer];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      acc[p] = 0.0f;
#pragma unroll
      for (int j = 0; j < kTaps; ++j) acc[p] = fmaf(f[j], sv[2 * p + j], acc[p]);
    }
    float* yr = y + (size_t)row * L + t0 + k0;
    if ((L & 3) == 0 && k0 + kPer <= nt) {
      *reinterpret_cast<float4*>(yr) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int p = 0; p < kPer; ++p)
        if (k0 + p < nt) yr[p] = acc[p];
    }
  }
}

}  // namespace

// y (rows, L) = the activation of x (rows, L), row r being channel r % C;
// alpha, beta (C,) the log-scale exponents; up, down the two 12-tap filters.
extern "C" int t2v_aa_snake(const float* x, const float* alpha, const float* beta,
                            const float* up, const float* down, float* y, int rows, int C, int L,
                            void* stream) {
  if (rows <= 0 || C <= 0 || L <= 0 || rows % C != 0) return (int)cudaErrorInvalidValue;
  const int64_t n_tiles = (L + kTile - 1) / kTile;
  const int64_t blocks = (int64_t)rows * n_tiles;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  aa_snake_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, alpha, beta, up, down, y, C, L, (int)n_tiles);
  return (int)cudaGetLastError();
}
