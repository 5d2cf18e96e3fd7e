// Kernels K5 and K6: the two Mosaic probes of tools/reshape_probe.py.
//
// K5 replaces tools/reshape_probe.py::probe_reshape.kernel (line 31):
//   out[b*S + s, x] = in[b, s*X + x] + 1,  in (B, S*X) -> out (B*S, X), f32.
// K6 replaces tools/reshape_probe.py::probe_out_block.kernel (line 54):
//   out[t] = x @ w for every t < T,  x (BS, K), w (K, F) -> out (T, BS, F), f32.
//
// On the TPU both asked what Mosaic accepts: a (1, S*X) value reshaped to
// (S, X) rows narrower or wider than the 128 lanes, and a (1, BS, F) output
// block with F = 32 lanes.  On Hopper neither question arises: the reshape
// of a row-major array is index arithmetic, and any output width is a
// stride.  What is left is the function itself.
//
// What bounds them on an H100: K5 at B=4, S=128, X=128 reads and writes
// 256 KiB each (0.16 us at 3.35 TB/s) and does one add per element; K6
// reads x (256 KiB) and w (16 KiB) and writes T = 4 slices of 64 KiB
// (0.16 us), and one 512 x 128 x 32 product is 4.2 MFLOP (0.06 us at
// 67 TFLOP/s of fp32).  Both bounds are far below the few microseconds a
// launch costs, so at the probe shapes both kernels are launch-bound; their
// designs only keep each byte moving once.
//
// Design.  K5: a grid-stride loop, one thread per 4 consecutive x of an
// output row with 16-byte loads and stores when X and the input row stride
// are multiples of 4 and both pointers are 16-byte aligned, else one
// element per thread (the ragged edge needs no mask beyond the loop bound).
// K6: one block per tile of kRows rows of x.  The block stages w (K x F)
// and its x tile in shared memory, each thread accumulates the dot product
// of one (row, f) pair in FFMA in the order k = 0..K-1, and stores it to
// every one of the T output slices: the product is computed once, not once
// per grid step as on the TPU.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;  // rows of x per K6 block

__global__ void reshape_plus_one_vec4(const float* __restrict__ in, float* __restrict__ out,
                                      int B, int S, int X, long long ld_in) {
  const int X4 = X / 4;
  const long long n = (long long)B * S * X4;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int x4 = (int)(i % X4);
    const long long r = i / X4;  // output row b*S + s
    const long long b = r / S;
    const int s = (int)(r - b * S);
    float4 v = *reinterpret_cast<const float4*>(in + b * ld_in + (long long)s * X + 4 * x4);
    v.x += 1.0f;
    v.y += 1.0f;
    v.z += 1.0f;
    v.w += 1.0f;
    *reinterpret_cast<float4*>(out + r * X + 4 * x4) = v;
  }
}

__global__ void reshape_plus_one(const float* __restrict__ in, float* __restrict__ out, int B,
                                 int S, int X, long long ld_in) {
  const long long n = (long long)B * S * X;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int x = (int)(i % X);
    const long long r = i / X;
    const long long b = r / S;
    const int s = (int)(r - b * S);
    out[i] = in[b * ld_in + (long long)s * X + x] + 1.0f;
  }
}

__global__ void out_block_matmul(const float* __restrict__ x, const float* __restrict__ w,
                                 float* __restrict__ out, int BS, int K, int F, int T) {
  extern __shared__ float sm[];
  float* ws = sm;           // K * F
  float* xs = sm + K * F;   // kRows * K
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, BS - row0);
  for (int i = threadIdx.x; i < K * F; i += blockDim.x) ws[i] = w[i];
  for (int i = threadIdx.x; i < rows * K; i += blockDim.x) xs[i] = x[(long long)row0 * K + i];
  __syncthreads();
  const long long slice = (long long)BS * F;
  for (int i = threadIdx.x; i < rows * F; i += blockDim.x) {
    const int r = i / F, f = i - r * F;
    const float* xr = xs + r * K;
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) acc = fmaf(xr[k], ws[k * F + f], acc);
    float* o = out + (long long)(row0 + r) * F + f;
    for (int t = 0; t < T; ++t) o[t * slice] = acc;
  }
}

int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace

// in: B rows of S*X f32 at row stride ld_in (elements); out (B*S, X) f32
// contiguous.  Returns a cudaError_t (0 on success).
extern "C" int t2v_reshape_plus_one(const float* in, float* out, int B, int S, int X,
                                    long long ld_in, void* stream) {
  if (B < 1 || S < 1 || X < 1 || ld_in < (long long)S * X) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec4 = X % 4 == 0 && ld_in % 4 == 0 && (reinterpret_cast<size_t>(in) & 15) == 0 &&
                    (reinterpret_cast<size_t>(out) & 15) == 0;
  if (vec4) {
    reshape_plus_one_vec4<<<grid_for((long long)B * S * (X / 4)), kThreads, 0, st>>>(in, out, B, S,
                                                                                      X, ld_in);
  } else {
    reshape_plus_one<<<grid_for((long long)B * S * X), kThreads, 0, st>>>(in, out, B, S, X, ld_in);
  }
  return (int)cudaGetLastError();
}

// x (BS, K), w (K, F), out (T, BS, F), all f32 contiguous.  K * F + 8 * K
// floats must fit one block's shared memory.  Returns a cudaError_t.
extern "C" int t2v_out_block_matmul(const float* x, const float* w, float* out, int BS, int K,
                                    int F, int T, void* stream) {
  if (BS < 1 || K < 1 || F < 1 || T < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(K * F + kRows * K) * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(out_block_matmul, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  const int blocks = (BS + kRows - 1) / kRows;
  out_block_matmul<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(x, w, out, BS,
                                                                                  K, F, T);
  return (int)cudaGetLastError();
}
