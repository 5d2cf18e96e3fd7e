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
// 67 TFLOP/s of fp32).  Both bounds are far below the microsecond that a
// launch costs inside a CUDA graph, so at the probe shapes both are
// latency-bound: what counts is the launch, the dispatch of blocks and how
// long each thread's chain of dependent instructions is.
//
// K5.  Output row r of the copy is a run of L = S*X floats:
// out[r*L + j] = in[r*ld_in + j] + 1.  When ld_in == L the B rows are one
// run of B*L floats and the kernel makes one flat pass; otherwise
// blockIdx.y is the row.  No division: a thread's index is j = 4 * (its
// global thread index) past the row's scalar head.  Each thread moves one
// float4, its load issued before its store.  A flat pass whose ends are
// 16-byte aligned (the probes' case) runs reshape_plus_one_flat, which does
// nothing else, in blocks of kFlatThreads = 512 (32 blocks at the probe
// shape).  Timed in turns on the H100 (chip_smoke.py --k56), 128-thread
// blocks (128 blocks, one wave) were ~0.03 us slower than PyTorch's own
// `x + 1`, 256 level with it, 512 ~0.02 us faster and 1024 ~0.1 us slower:
// with the 256 KiB input in L2 the time is the launch and the dispatch of
// blocks, not bandwidth.  The rest runs reshape_plus_one in 128-thread
// blocks, one grid row per input row where rows are apart.  16-byte
// accesses need the out row's and the in row's addresses to agree modulo
// 16 bytes: the head up to the first 16-byte boundary of the out row and
// the ragged tail (at most 3 + 3 floats) are scalars done by thread 0 of
// the row; where the two rows' alignments disagree (a misaligned view,
// ld_in not a multiple of 4), the loads are four scalars and the stores
// stay float4.
//
// K6.  A block computes a tile of kRows = 4 rows of x by kCols = 32
// columns of w (grid: ceil(BS / 4) x ceil(F / 32); the probe shape gives
// 128 blocks of 128 threads).  The reduction over K is split kSplit = 4
// ways, one warp each, over chunks of kChunk = 128: warp q sums k = 32 q ..
// 32 q + 31 of each chunk.  A warp stages only its own slice of w (32 x 32)
// and of the x tile (4 x 32) in shared memory, with 16-byte cp.async where
// the rows are 16-byte aligned, so it waits on its own copies and a
// __syncwarp, not on the block.  A lane holds 1 row x 4 columns and sums
// in four float4 accumulators (k mod 4), so no chain is longer than 8
// dependent FFMAs a chunk; it adds them in a fixed order, (a0 + a1) +
// (a2 + a3).  The four warps' partials go through shared memory and are
// added in warp order by every lane of the tile (so the result does not
// depend on scheduling, and no atomics); lane (r, c) of warp q then stores
// the sum to slices t = q, q + 4, ... with 16-byte stores.  K is a
// template: K6<128> (the probe's K, one chunk, fully unrolled, 16-byte
// copies and stores) and K6<0> (any K, any F, any alignment: a chunk loop,
// 4-byte copies with the ragged edges zero-filled).  Shared memory is
// 20 KiB a block whatever K is, so K6 has no limit on K.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFlatThreads = 512;  // K5, one flat aligned pass: one float4 a thread
constexpr int kCopyThreads = 128;  // K5, any other layout: one float4 a thread
constexpr int kMaxGridY = 65535;

constexpr int kRows = 4;     // K6: rows of x per block
constexpr int kCols = 32;    // K6: columns of w per block
constexpr int kSplit = 4;    // K6: warps over K, one reduction slice each
constexpr int kChunk = 128;  // K6: K staged per pass
constexpr int kSlice = kChunk / kSplit;  // 32 k a warp per chunk
constexpr int kXPitch = kSlice + 4;      // padded x row: rows 4 banks apart
constexpr int kK6Threads = 32 * kSplit;
static_assert(kRows * (kCols / 4) == 32, "K6: a warp's lanes are the tile's rows x column quads");

// ------------------------------------------------------------------ K5

__global__ void __launch_bounds__(kFlatThreads)
reshape_plus_one_flat(const float4* __restrict__ in, float4* __restrict__ out, int n4) {
  const int i = blockIdx.x * kFlatThreads + threadIdx.x;
  if (i < n4) {
    float4 v = __ldg(in + i);
    v.x += 1.0f;
    v.y += 1.0f;
    v.z += 1.0f;
    v.w += 1.0f;
    out[i] = v;
  }
}

__global__ void __launch_bounds__(kCopyThreads)
reshape_plus_one(const float* __restrict__ in, float* __restrict__ out, int L, long long ld_in,
                 long long ld_out) {
  const float* src = in + blockIdx.y * ld_in;
  float* dst = out + blockIdx.y * ld_out;
  const uint32_t dst_mis = (uint32_t)(reinterpret_cast<uintptr_t>(dst) >> 2) & 3u;
  const int head = min((int)((4u - dst_mis) & 3u), L);
  const int body4 = (L - head) >> 2;
  const bool vec_in = ((reinterpret_cast<uintptr_t>(src) ^ reinterpret_cast<uintptr_t>(dst)) &
                       15u) == 0;
  const int t = blockIdx.x * kCopyThreads + threadIdx.x;
  const int j = head + 4 * t;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (t < body4) {
    if (vec_in) {
      v = __ldg(reinterpret_cast<const float4*>(src + j));
    } else {
      v = make_float4(__ldg(src + j), __ldg(src + j + 1), __ldg(src + j + 2), __ldg(src + j + 3));
    }
  }
  // thread 0 of the row also takes the scalar head and tail
  const int tail0 = head + 4 * body4;
  float hv[3], tv[3];
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      hv[i] = i < head ? __ldg(src + i) : 0.f;
      tv[i] = tail0 + i < L ? __ldg(src + tail0 + i) : 0.f;
    }
  }
  if (t < body4) {
    v.x += 1.0f;
    v.y += 1.0f;
    v.z += 1.0f;
    v.w += 1.0f;
    *reinterpret_cast<float4*>(dst + j) = v;
  }
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (i < head) dst[i] = hv[i] + 1.0f;
      if (tail0 + i < L) dst[tail0 + i] = tv[i] + 1.0f;
    }
  }
}

// ------------------------------------------------------------------ K6

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void fma4(float4& a, float x, const float4& w) {
  a.x = fmaf(x, w.x, a.x);
  a.y = fmaf(x, w.y, a.y);
  a.z = fmaf(x, w.z, a.z);
  a.w = fmaf(x, w.w, a.w);
}

__device__ __forceinline__ float4 add4(const float4& a, const float4& b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// One warp's slice of a chunk: ws (kSlice x kCols) and xs (kRows x kXPitch)
// hold w[k0 + kk][col0 ...] and x[row0 + r][k0 + kk] for kk < kSlice.
template <bool kVec>
__device__ __forceinline__ void stage_slice(const float* __restrict__ x,
                                            const float* __restrict__ w, float* ws, float* xs,
                                            int lane, int row0, int col0, int k0, int BS, int K,
                                            int F) {
  if (kVec) {
    // every row of the tile and every column group in range, K % 4 == 0,
    // F % 4 == 0 and 16-byte aligned bases (the host checks)
#pragma unroll
    for (int i = lane; i < kSlice * (kCols / 4); i += 32) {
      const int kk = i / (kCols / 4), c4 = i % (kCols / 4);
      cp_async16(ws + kk * kCols + 4 * c4, w + (long long)(k0 + kk) * F + col0 + 4 * c4);
    }
#pragma unroll
    for (int i = lane; i < kRows * (kSlice / 4); i += 32) {
      const int r = i / (kSlice / 4), q4 = i % (kSlice / 4);
      cp_async16(xs + r * kXPitch + 4 * q4, x + (long long)(row0 + r) * K + k0 + 4 * q4);
    }
    cp_async_wait_all();
  } else {
    for (int i = lane; i < kSlice * kCols; i += 32) {
      const int kk = i / kCols, c = i % kCols;
      const int k = k0 + kk, col = col0 + c;
      ws[kk * kCols + c] = k < K && col < F ? w[(long long)k * F + col] : 0.f;
    }
    for (int i = lane; i < kRows * kSlice; i += 32) {
      const int r = i / kSlice, kk = i % kSlice;
      const int row = row0 + r, k = k0 + kk;
      xs[r * kXPitch + kk] = row < BS && k < K ? x[(long long)row * K + k] : 0.f;
    }
  }
  __syncwarp();
}

// A lane's 1 x 4 tile over one slice, four accumulators by k mod 4.
__device__ __forceinline__ void mac_slice(const float* ws, const float* xs, int r, int c4,
                                          float4 (&acc)[4]) {
#pragma unroll
  for (int kk = 0; kk < kSlice; kk += 4) {
    const float4 xv = *reinterpret_cast<const float4*>(xs + r * kXPitch + kk);
    fma4(acc[0], xv.x, *reinterpret_cast<const float4*>(ws + (kk + 0) * kCols + 4 * c4));
    fma4(acc[1], xv.y, *reinterpret_cast<const float4*>(ws + (kk + 1) * kCols + 4 * c4));
    fma4(acc[2], xv.z, *reinterpret_cast<const float4*>(ws + (kk + 2) * kCols + 4 * c4));
    fma4(acc[3], xv.w, *reinterpret_cast<const float4*>(ws + (kk + 3) * kCols + 4 * c4));
  }
}

// kK = 128: the probe's K, one chunk, every access 16 bytes (the host
// launches it only when the shapes and addresses allow).  kK = 0: any K.
template <int kK>
__global__ void __launch_bounds__(kK6Threads)
out_block_matmul(const float* __restrict__ x, const float* __restrict__ w,
                 float* __restrict__ out, int BS, int K, int F, int T) {
  static_assert(kK == 0 || kK == kChunk, "K6 is instantiated for K = 128 and for any K");
  constexpr bool kFast = kK == kChunk;
  __shared__ __align__(16) float ws_all[kSplit][kSlice * kCols];
  __shared__ __align__(16) float xs_all[kSplit][kRows * kXPitch];
  __shared__ __align__(16) float4 part[kSplit][32];

  const int q = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane / (kCols / 4), c4 = lane % (kCols / 4);
  const int row0 = blockIdx.x * kRows, col0 = blockIdx.y * kCols;
  float* ws = ws_all[q];
  float* xs = xs_all[q];

  float4 acc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (kFast) {
    stage_slice<true>(x, w, ws, xs, lane, row0, col0, q * kSlice, BS, K, F);
    mac_slice(ws, xs, r, c4, acc);
  } else {
    for (int k0 = 0; k0 < K; k0 += kChunk) {
      stage_slice<false>(x, w, ws, xs, lane, row0, col0, k0 + q * kSlice, BS, K, F);
      mac_slice(ws, xs, r, c4, acc);
      __syncwarp();  // the slice is read before the next chunk overwrites it
    }
  }
  part[q][lane] = add4(add4(acc[0], acc[1]), add4(acc[2], acc[3]));
  __syncthreads();
  float4 sum = part[0][lane];
#pragma unroll
  for (int i = 1; i < kSplit; ++i) sum = add4(sum, part[i][lane]);

  const int row = row0 + r, col = col0 + 4 * c4;
  if (row >= BS || col >= F) return;
  const long long slice = (long long)BS * F;
  float* o = out + (long long)row * F + col;
  if (kFast || (F % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15u) == 0)) {
    for (int t = q; t < T; t += kSplit) *reinterpret_cast<float4*>(o + t * slice) = sum;
  } else {
    const float s4[4] = {sum.x, sum.y, sum.z, sum.w};
    for (int t = q; t < T; t += kSplit) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (col + i < F) o[t * slice + i] = s4[i];
    }
  }
}

__global__ void empty_kernel() {}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// in: B rows of S*X f32 at row stride ld_in (elements); out (B*S, X) f32
// contiguous.  Returns a cudaError_t (0 on success).
extern "C" int t2v_reshape_plus_one(const float* in, float* out, int B, int S, int X,
                                    long long ld_in, void* stream) {
  const long long L = (long long)S * X;
  if (B < 1 || S < 1 || X < 1 || ld_in < L || L > (1ll << 31) - 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // one flat run when the rows are back to back, else one grid row per b
  const bool flat = ld_in == L && (long long)B * L <= (1ll << 31) - 8;
  const int rows = flat ? 1 : B;
  const int len = flat ? (int)(B * L) : (int)L;
  if (flat && len % 4 == 0 && aligned16(in) && aligned16(out)) {
    reshape_plus_one_flat<<<(len / 4 + kFlatThreads - 1) / kFlatThreads, kFlatThreads, 0, st>>>(
        reinterpret_cast<const float4*>(in), reinterpret_cast<float4*>(out), len / 4);
    return (int)cudaGetLastError();
  }
  const int blocks = (int)(((len + 3) / 4 + kCopyThreads - 1) / kCopyThreads);
  for (int r0 = 0; r0 < rows; r0 += kMaxGridY) {
    const dim3 grid(blocks, rows - r0 < kMaxGridY ? rows - r0 : kMaxGridY);
    reshape_plus_one<<<grid, kCopyThreads, 0, st>>>(in + r0 * ld_in, out + r0 * L, len, ld_in, L);
  }
  return (int)cudaGetLastError();
}

// x (BS, K), w (K, F), out (T, BS, F), all f32 contiguous; any sizes (the
// kernel stages K in chunks).  Returns a cudaError_t.
extern "C" int t2v_out_block_matmul(const float* x, const float* w, float* out, int BS, int K,
                                    int F, int T, void* stream) {
  if (BS < 1 || K < 1 || F < 1 || T < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((BS + kRows - 1) / kRows, (F + kCols - 1) / kCols);
  const bool fast = K == kChunk && BS % kRows == 0 && F % kCols == 0 && aligned16(x) &&
                    aligned16(w) && aligned16(out);
  if (fast) {
    out_block_matmul<kChunk><<<grid, kK6Threads, 0, st>>>(x, w, out, BS, K, F, T);
  } else {
    out_block_matmul<0><<<grid, kK6Threads, 0, st>>>(x, w, out, BS, K, F, T);
  }
  return (int)cudaGetLastError();
}

// An empty kernel launched the same way: the floor that K5's and K6's
// times are read against (the cost of one launch, not a kernel's work).
extern "C" int t2v_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
