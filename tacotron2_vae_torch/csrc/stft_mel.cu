// Fused log-mel front end for one waveform (kernel K2): reflect pad ->
// overlapped framing -> Hann window -> real FFT in full fp32 -> magnitude ->
// slaney mel filterbank -> log(max(x, 1e-5)).
//
// Replaces: tacotron2_vae_tpu/ops/pallas/stft_mel.py::_kernel (via
// _mel_impl / mel_spectrogram_pallas).  The TPU kernel ran the DFT as a
// matmul against a (1024, 2x640) basis at Precision.HIGHEST; here tensor
// cores would need TF32, which keeps ~3 decimal digits and breaks the 1e-4
// log-mel tolerance, so the FFT runs in plain fp32.
//
// What bounds it on an H100: neither resource by much.  A 3 s, 16 kHz clip
// has 188 frames; the wav, the output (80 x 188) and the tables it reads
// (window, twiddles, band table, ~1000 packed filterbank weights) are
// ~0.27 MB, 0.080 us at 3.35 TB/s, and an FFT (2.5 N log2 N flops a frame)
// plus the window, the magnitudes and the mel product over the filterbank's
// nonzeros is ~5.7 MFLOP, 0.085 us at 67 TFLOP/s of fp32, so the operations
// bound it by a little (chip_smoke.k2_bound).  Both are far below the cost
// of one launch (~1 us for an empty kernel), so what a call costs is its
// launch, the host work around it, and the latency of its dependent phases:
// one round trip to memory, then the FFT stages (four radix-4 and one
// radix-2 at n_fft 1024), the magnitudes and the mel product, each behind a
// block barrier.
//
// Design: one block of kThreads threads per frame (188 blocks at 3 s: one
// wave over the 132 SMs, several blocks an SM).  A frame of n_fft real
// samples is one complex FFT of M = n_fft/2 points, z[m] = x[2m] + i x[2m+1]
// (reflect padding resolved by index arithmetic, so the padded wav is never
// materialised), split afterwards into the n_fft/2 + 1 bins of the real
// FFT: X[k] = Ze[k] + W^k Zo[k], Ze = (Z[k] + conj Z[M-k]) / 2,
// Zo = (Z[k] - conj Z[M-k]) / 2i, W = exp(-2 pi i / n_fft).  One frame a
// block, and not two frames packed as the real and imaginary parts of one
// FFT, because the rounding error of a packed pair is relative to the
// louder frame: a quiet frame beside a loud one (speech after silence)
// would carry the loud one's error into its log-mel, while here each frame's
// error stays relative to its own energy, as in the twin's DFT.  The FFT is
// a Stockham autosort over two shared buffers: radix-4 stages (one
// butterfly a thread at n_fft 1024), then one radix-2 stage when log2 M is
// odd; stage s reads element j + r M/R, multiplies it by the twiddle of
// (j mod Ns) r / (Ns R) turns, and writes (j / Ns) Ns R + j mod Ns + r Ns.
// Twiddles come from one table of W^k, k < n_fft, computed on the host in
// float64 and rounded once to fp32 (W_M^x = W^2x).  The shared buffers are
// indexed through an XOR swizzle within each 16-element row (sw below) in
// place of padding: a half-warp's 16 float2 accesses fall on distinct banks
// in every stage (the writes of the Ns = 1 and Ns = 4 stages, strided by 4,
// would otherwise be 4-way conflicts).  The mel product runs over each
// band's nonzero bins only ([start, end) and an offset into the packed
// weights, a table built once on the host with the filterbank): ~1000 FMAs
// a frame instead of 80 x 513.  A block's loads are all in flight at once:
// the tables by asynchronous copies (cp.async): the twiddles, waited for
// before the first stage, and the mel tables, which land while the FFT
// runs; the frame's samples through registers, kPer pairs a thread
// loaded before any is stored.  (Loading each array in a loop of its own
// took 8.13-8.15 us a call on an H100 80GB HBM3 at 700 W; this, 5.98-6.36
// us, in turns in one run of chip_smoke.py --k12; PERF.md.)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kFrames = 1;     // frames per block
constexpr int kRadix = 4;      // radix of the FFT stages (one radix-2 stage last if needed)
constexpr int kPer = 4;        // sample pairs a thread loads before it stores any

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// dst[0, bytes) = src[0, bytes) by 16-byte cp.async copies, committed as a
// group of their own (both 16-byte aligned); the tail of bytes % 16 by plain
// loads.
__device__ __forceinline__ void copy_async(void* dst, const void* src, int bytes) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(d + 16 * i)),
                 "l"(s + 16 * i)
                 : "memory");
  for (int i = bytes / 16 * 16 + threadIdx.x; i < bytes; i += blockDim.x) d[i] = s[i];
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are still in flight.
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// XOR swizzle of a shared-buffer index within its row of 16 float2: flips
// the two low bit pairs by bits 4-5, so both stride-1 and stride-4 runs of a
// half-warp land on 16 distinct 8-byte bank pairs.
__device__ __forceinline__ int sw(int i) { return i ^ (((i >> 4) & 3) * 5); }

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// One Stockham stage of radix R over M points (M / R butterflies).
template <int R>
__device__ __forceinline__ void fft_stage(const float2* __restrict__ src, float2* __restrict__ dst,
                                          const float2* __restrict__ tw, int M, int n_fft, int Ns) {
  const int q = M / R, tstep = n_fft / (Ns * R);
  for (int j = threadIdx.x; j < q; j += blockDim.x) {
    const int jm = j & (Ns - 1);
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = src[sw(j + r * q)];
    if (Ns > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r) v[r] = cmul(v[r], tw[r * jm * tstep]);
    }
    float2 y[R];
    if constexpr (R == 4) {
      const float2 t0 = make_float2(v[0].x + v[2].x, v[0].y + v[2].y);
      const float2 t1 = make_float2(v[0].x - v[2].x, v[0].y - v[2].y);
      const float2 t2 = make_float2(v[1].x + v[3].x, v[1].y + v[3].y);
      const float2 t3 = make_float2(v[1].y - v[3].y, v[3].x - v[1].x);  // (v1 - v3) * -i
      y[0] = make_float2(t0.x + t2.x, t0.y + t2.y);
      y[1] = make_float2(t1.x + t3.x, t1.y + t3.y);
      y[2] = make_float2(t0.x - t2.x, t0.y - t2.y);
      y[3] = make_float2(t1.x - t3.x, t1.y - t3.y);
    } else {
      y[0] = make_float2(v[0].x + v[1].x, v[0].y + v[1].y);
      y[1] = make_float2(v[0].x - v[1].x, v[0].y - v[1].y);
    }
    const int d = (j - jm) * R + jm;
#pragma unroll
    for (int r = 0; r < R; ++r) dst[sw(d + r * Ns)] = y[r];
  }
}

__global__ void __launch_bounds__(kThreads)
stft_mel_kernel(const float* __restrict__ wav, int n, const float* __restrict__ window,
                const float2* __restrict__ twid, const int* __restrict__ bands,
                const float* __restrict__ melw, int nnz, float* __restrict__ out, int n_fft,
                int hop, int n_mels, int n_frames) {
  extern __shared__ __align__(16) float sm[];
  const int M = n_fft / 2, frame = blockIdx.x * kFrames;
  float2* buf0 = reinterpret_cast<float2*>(sm);  // M
  float2* buf1 = buf0 + M;                       // M
  float2* tw = buf1 + M;                         // n_fft
  float* w = reinterpret_cast<float*>(tw + n_fft);  // nnz packed filterbank weights
  int* bt = reinterpret_cast<int*>(w + (nnz + 3) / 4 * 4);  // n_mels x (start, end, offset)

  // the tables by asynchronous copies (the twiddles' group first, then the
  // mel tables' two, which the FFT does not wait for), the frame through
  // registers, kPer sample pairs a thread in flight at once
  copy_async(tw, twid, n_fft * 8);
  copy_async(w, melw, nnz * 4);
  copy_async(bt, bands, 3 * n_mels * 4);
  const int base = frame * hop - n_fft / 2;  // wav index of the frame's first sample
  for (int m0 = 0; m0 < M; m0 += kPer * blockDim.x) {
    float2 z[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int m = m0 + u * blockDim.x + threadIdx.x;
      if (m < M) {
        int j0 = base + 2 * m, j1 = j0 + 1;
        j0 = j0 < 0 ? -j0 : (j0 >= n ? 2 * (n - 1) - j0 : j0);
        j1 = j1 < 0 ? -j1 : (j1 >= n ? 2 * (n - 1) - j1 : j1);
        z[u] = make_float2(wav[j0] * window[2 * m], wav[j1] * window[2 * m + 1]);
      }
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int m = m0 + u * blockDim.x + threadIdx.x;
      if (m < M) buf0[sw(m)] = z[u];
    }
  }
  copy_wait<2>();  // the twiddles (the mel tables' groups may be in flight)
  __syncthreads();

  float2 *src = buf0, *dst = buf1;
  int Ns = 1;
  for (; Ns * kRadix <= M; Ns *= kRadix) {
    fft_stage<kRadix>(src, dst, tw, M, n_fft, Ns);
    __syncthreads();
    float2* t = src;
    src = dst;
    dst = t;
  }
  if (Ns < M) {
    fft_stage<2>(src, dst, tw, M, n_fft, Ns);
    __syncthreads();
    float2* t = src;
    src = dst;
    dst = t;
  }

  // |X[k]| for k = 0..M from Z = src (natural order), into the free buffer
  float* mag = reinterpret_cast<float*>(dst);  // M + 1 floats
  for (int k = threadIdx.x; k <= M; k += blockDim.x) {
    const float2 a = src[sw(k & (M - 1))], c = src[sw((M - k) & (M - 1))];
    const float2 ze = make_float2(0.5f * (a.x + c.x), 0.5f * (a.y - c.y));
    const float2 zo = make_float2(0.5f * (a.y + c.y), 0.5f * (c.x - a.x));
    const float2 wz = cmul(tw[k], zo);
    const float re = ze.x + wz.x, im = ze.y + wz.y;
    mag[k] = sqrtf(re * re + im * im);
  }
  copy_wait<0>();  // the mel tables
  __syncthreads();

  for (int mb = threadIdx.x; mb < n_mels; mb += blockDim.x) {
    const int k0 = bt[3 * mb], k1 = bt[3 * mb + 1];
    const float* wb = w + bt[3 * mb + 2] - k0;
    float acc = 0.0f;
#pragma unroll 4
    for (int k = k0; k < k1; ++k) acc = fmaf(wb[k], mag[k], acc);
    out[(size_t)mb * n_frames + frame] = logf(fmaxf(acc, 1e-5f));
  }
}

}  // namespace

// wav (n,) f32; window (n_fft,) f32; twid (n_fft,) complex64 as float pairs,
// exp(-2 pi i k / n_fft); bands (n_mels, 3) int32 of [start, end) of each
// band's nonzero bins and the offset of its weights in melw (nnz,) f32;
// out (n_mels, n/hop+1) f32.  Requires n > n_fft/2 (reflect padding) and
// n_fft a power of two >= 4.  Returns a cudaError_t (0 on success).
extern "C" int t2v_stft_mel(const float* wav, int n, const float* window, const float* twid,
                            const int* bands, const float* melw, int nnz, float* out, int n_fft,
                            int hop, int n_mels, void* stream) {
  if (n <= n_fft / 2 || n_fft < 4 || (n_fft & (n_fft - 1)) != 0 || nnz < 0)
    return (int)cudaErrorInvalidValue;
  const int n_frames = n / hop + 1;
  const size_t smem = (size_t)(4 * n_fft + (nnz + 3) / 4 * 4 + 3 * n_mels) * sizeof(float);
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(stft_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  stft_mel_kernel<<<(n_frames + kFrames - 1) / kFrames, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      wav, n, window, reinterpret_cast<const float2*>(twid), bands, melw, nnz, out, n_fft, hop,
      n_mels, n_frames);
  return (int)cudaGetLastError();
}
