// Pieces shared by the teacher-forced recurrence kernels K3
// (teacher_fwd.cu) and K4 (teacher_bwd.cu): type helpers, block
// reductions, the Hopper building blocks of the bf16 and float16 LSTM
// products (TMA tensor maps, mbarriers, wgmma and the producer/consumer
// ring, each templated on the 2-byte stream type), the
// batched query product, and the per-chunk location-sensitive attention
// terms.  The backward recomputes the attention energies with the same
// functions (and the same query product) the forward used, so both see the
// same tanh values bit for bit.
//
// Numerics follow the JAX package's XLA scan (decoder_bptt.py), not the
// Pallas kernel: only the LSTM product operands are rounded to the stream
// dtype (rnd<T>); the attention (query, location conv, loc_dense, tanh,
// energies, softmax, context) and all state are float32.  The Pallas
// kernel additionally rounds memory, pmem, the banded location matrix,
// tanh(.) before v and w before the context, because Mosaic wants bf16
// matrix-unit operands; Hopper's FFMA path has no such need.

#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <chrono>
#include <mutex>
#include <type_traits>
#include <utility>
#include <vector>

namespace t2v {

namespace cg = cooperative_groups;


constexpr int kSplit = 4;         // K-split of the float32 FFMA products (partial sums)
constexpr int kNC = 4;            // attention: CTAs per batch row (one cluster), S split in kNC
constexpr int kAttThreads = 256;  // threads of an attention CTA
constexpr int kQChunk = 64;       // att_query: rows of H per block (one partial each)
constexpr int kTileK = 64;        // wgmma products: reduction per stage (128 bytes of bf16)
constexpr int kTcSplit = 8;       // wgmma products: CTAs of a cluster splitting the reduction
constexpr int kTcThreads = 160;   // one consumer warpgroup + one producer warp

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f<__half>(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// round to nearest even; past 65504 this is inf, as PyTorch's cast: a loss
// scale that overflows the float16 streams must show as inf, not a clamp
template <> __device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }

// float -> stream dtype -> float (the XLA scan's `.astype(compute_dtype)`)
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}

__device__ __forceinline__ float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sum or max; every thread gets the result.  `red` holds 32 floats.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, u) : v + u;
  }
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : (kMax ? -3.402823466e38f : 0.0f);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float u = __shfl_xor_sync(0xffffffffu, v, o);
      v = kMax ? fmaxf(v, u) : v + u;
    }
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  v = red[0];
  __syncthreads();
  return v;
}

// 8 consecutive elements of T (16-byte aligned) as floats.
template <typename T> struct Vec8;
template <> struct Vec8<float> {
  __device__ __forceinline__ static void load(const float* p, float* o) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  }
};
template <> struct Vec8<__nv_bfloat16> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* o) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};
template <> struct Vec8<__half> {
  __device__ __forceinline__ static void load(const __half* p, float* o) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __half2* h = reinterpret_cast<const __half2*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

// The stream dtype codes of the C entry points (ops/teacher_fwd.py DTYPES);
// any other value is refused.
enum StreamType { kF32 = 0, kBF16 = 1, kF16 = 2 };

// The 2-byte stream types take the tensor-core products.
template <typename T> constexpr bool is_tc() {
  return std::is_same<T, __nv_bfloat16>::value || std::is_same<T, __half>::value;
}

struct Dims {
  int T, B, S, E, H, P, A, F, K;
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int up4(int a) { return (a + 3) & ~3; }

// ------------------------------------------------ Hopper building blocks

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA tile loads into shared memory, completing on `bar` (transaction bytes).
// tma_2d_keep marks the lines it reads to be evicted last from L2: the LSTM
// weights are read again every step, while the attention streams memory and
// pmem past them.
__device__ __forceinline__ void tma_2d_keep(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(policy));
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                       int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// 16 bytes of CTA `rank`'s shared memory at the address of p in this CTA
// (distributed shared memory, read with ld.shared::cluster).
__device__ __forceinline__ float4 ld_dsmem4(const void* p, int rank) {
  uint32_t a;
  float4 v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (all >> 4).  K-major tiles (64 k of bf16
// = one 128-byte row per M/N index): SBO = 1024 (8 rows), LBO unused (16).
// MN-major tiles (64 M/N of bf16 per 128-byte row, one row per k): LBO is
// the stride between 64-wide M/N blocks, SBO between 8-row k groups.
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// D (64 x N, float32 in registers) += A (64 x 16, K-major) . B (16 x N),
// A and B in the stream type T (bf16 or f16, one asm statement each):
// N = 256 with B MN-major (the forward's (K, 4H) weight as it is stored),
// N = 128 with B K-major (the backward's contraction over 4H).  Thread t of
// the warpgroup holds, for each 8-column block i, rows 16(t/32) + (t%32)/4
// (+8) and columns 8i + 2(t%4) (+1) in d[4i .. 4i+3].
#define T2V_WGMMA_M64N256(AB) \
  asm volatile( \
      "{\n" \
      ".reg .pred p;\n" \
      "setp.ne.b32 p, %130, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." AB "." AB " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63," \
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79," \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95," \
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111," \
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127" \
      "}, %128, %129, p, 1, 1, 0, 1;\n" \
      "}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127]) \
      : "l"(da), "l"(db), "r"(1))

template <typename T>
__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], uint64_t da, uint64_t db) {
  if constexpr (std::is_same<T, __half>::value)
    T2V_WGMMA_M64N256("f16");
  else
    T2V_WGMMA_M64N256("bf16");
}

#define T2V_WGMMA_M64N128(AB) \
  asm volatile( \
      "{\n" \
      ".reg .pred p;\n" \
      "setp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
      "}, %64, %65, p, 1, 1, 0, 0;\n" \
      "}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "l"(da), "l"(db), "r"(1))

template <typename T>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da, uint64_t db) {
  if constexpr (std::is_same<T, __half>::value)
    T2V_WGMMA_M64N128("f16");
  else
    T2V_WGMMA_M64N128("bf16");
}

// Ring of kS stages in shared memory (each an A tile of 64 rows x 64 k and
// a B tile of N x 64 k, bf16, 128-byte swizzled, 1024-byte aligned) and its
// full/empty barriers behind them.  Warp 4 (one thread) produces: it waits
// for a free stage and issues the stage's TMA loads (`load`), whose bytes
// complete the stage's full barrier.  Warps 0-3 (one warpgroup) consume:
// four wgmma k16 steps per stage, then free the stage.  Reduction tiles
// [it0, it1) of this CTA; acc must be zeroed by the caller.
template <int N, int kS>
struct TcRing {
  static constexpr int kABytes = 64 * kTileK * 2;
  static constexpr int kBBytes = N * kTileK * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kSmemBytes = kS * kStageBytes + 2 * kS * 8 + 1024;
  __device__ static uint64_t* full(uint8_t* ring) {
    return reinterpret_cast<uint64_t*>(ring + kS * kStageBytes);
  }
  __device__ static uint64_t* empty(uint8_t* ring) { return full(ring) + kS; }
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

template <int N, int kS>
__device__ __forceinline__ void tc_init_barriers(uint8_t* ring) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(&TcRing<N, kS>::full(ring)[s], 1);
      mbar_init(&TcRing<N, kS>::empty(ring)[s], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

template <typename T, int N, int kS, bool kMN, typename Load>
__device__ __forceinline__ void tc_mainloop(uint8_t* ring, int it0, int it1, uint32_t lbo,
                                            uint32_t sbo, Load&& load, float (&acc)[N / 2]) {
  using R = TcRing<N, kS>;
  uint64_t *full = R::full(ring), *empty = R::empty(ring);
  const int tid = threadIdx.x;
  if (tid >= 128) {
    if (tid == 128) {
      int s = 0;
      uint32_t ph = 0;
      for (int it = it0; it < it1; ++it) {
        mbar_wait(&empty[s], ph ^ 1);
        mbar_expect_tx(&full[s], R::kStageBytes);
        load(ring + s * R::kStageBytes, ring + s * R::kStageBytes + R::kABytes, &full[s], it);
        if (++s == kS) { s = 0; ph ^= 1; }
      }
    }
    return;
  }
  int s = 0;
  uint32_t ph = 0;
  for (int it = it0; it < it1; ++it) {
    mbar_wait(&full[s], ph);
    const uint8_t* a = ring + s * R::kStageBytes;
    const uint64_t da = gmma_desc(a, 16, 1024);
    const uint64_t db = kMN ? gmma_desc(a + R::kABytes, lbo, sbo) : gmma_desc(a + R::kABytes, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk) {
      // k16 steps: 32 bytes along a K-major row; 16 rows (2048 bytes) of an MN-major tile
      if constexpr (N == 256)
        wgmma_m64n256<T>(acc, da + 2 * kk, db + (kMN ? 128 : 2) * kk);
      else
        wgmma_m64n128<T>(acc, da + 2 * kk, db + (kMN ? 128 : 2) * kk);
    }
    wgmma_commit();
    wgmma_wait0();
    mbar_arrive(&empty[s]);
    if (++s == kS) { s = 0; ph ^= 1; }
  }
}

// The consumer warpgroup's accumulators into part (64 rows, row stride ld floats).
template <int N>
__device__ __forceinline__ void tc_store(const float (&acc)[N / 2], float* part, int ld) {
  const int t = threadIdx.x, r0 = 16 * (t >> 5) + ((t & 31) >> 2), c0 = 2 * (t & 3);
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    *reinterpret_cast<float2*>(part + r0 * ld + 8 * i + c0) = make_float2(acc[4 * i], acc[4 * i + 1]);
    *reinterpret_cast<float2*>(part + (r0 + 8) * ld + 8 * i + c0) =
        make_float2(acc[4 * i + 2], acc[4 * i + 3]);
  }
}

// A row-major tensor of a 2-byte stream type T of up to 3 dims (innermost
// first) as a TMA map with a 128-byte-swizzled box; out-of-range rows and
// columns load as zeros.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

template <typename T>
inline cudaError_t tensor_map(CUtensorMap* map, const void* base, int rank, const uint64_t* dims,
                              const uint32_t* box) {
  static_assert(is_tc<T>(), "TMA maps of the 2-byte streams only");
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault);
#endif
    if (e != cudaSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  cuuint64_t gd[3], gs[2];
  cuuint32_t bx[3], es[3] = {1, 1, 1};
  uint64_t stride = dims[0] * 2;
  for (int i = 0; i < rank; ++i) {
    gd[i] = dims[i];
    bx[i] = box[i];
    if (i > 0) {
      gs[i - 1] = stride;
      stride *= dims[i];
    }
  }
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUresult r = encode(map, type, rank, const_cast<void*>(base),
                            gd, gs, bx, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

inline cudaError_t smem_attr(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The executable CUDA graphs of the last kGraphs sets of sizes a direction
// was called with, most recent first.  A call's key is its sizes (dims) and
// its argument pointers (ptrs); an entry holds the pointers its graph now
// launches with.
constexpr int kGraphs = 4;
struct GraphKey {
  std::vector<uint64_t> dims, ptrs;
};
struct GraphEntry {
  GraphKey key;
  cudaGraphExec_t exec;
  long long work;  // what the captured loop's enqueue counted (launch_loop)
};
struct GraphCache {
  std::mutex mu;
  std::vector<GraphEntry> entries;
  int captures = 0;  // graphs instantiated so far (a replay or an update adds none)
  int updates = 0;   // graphs given new pointers in place (cudaGraphExecUpdate)
  long long build_ns = 0;  // host time of both: capture plus instantiation or update
};

inline void key_push(GraphKey& k, const void* p) {
  k.ptrs.push_back(reinterpret_cast<uintptr_t>(p));
}
inline void key_push(GraphKey& k, int v) { k.dims.push_back(static_cast<uint32_t>(v)); }
template <typename... Ts>
GraphKey make_key(Ts... xs) {
  GraphKey k;
  (key_push(k, xs), ...);
  return k;
}

// Record `enqueue` (a whole recurrence) into a new graph on a stream of its
// own: the caller's may be the legacy default stream, which cannot be
// captured, and thread-local capture leaves other threads' launches alone.
template <typename F>
cudaError_t capture(F&& enqueue, cudaGraph_t* g) {
  cudaStream_t cs = nullptr;
  cudaError_t err = cudaStreamCreateWithFlags(&cs, cudaStreamNonBlocking);
  if (err != cudaSuccess) return err;
  if ((err = cudaStreamBeginCapture(cs, cudaStreamCaptureModeThreadLocal)) == cudaSuccess) {
    enqueue(cs);
    const cudaError_t launch_err = cudaGetLastError();
    err = cudaStreamEndCapture(cs, g);
    if (err == cudaSuccess) err = launch_err;
  }
  cudaStreamDestroy(cs);
  return err;
}

// Run `enqueue(stream)` (a whole recurrence) on st: launched kernel by
// kernel (graph false), or as one CUDA graph.  The graph of the call's sizes
// is replayed as it is when the pointers are those it holds.  New pointers
// (a training loop's tensors come back at shifting addresses) are patched
// into it: the loop is captured again and the executable graph updated in
// place, with no new instantiation.  Sizes not seen among the last kGraphs
// are captured and instantiated in place of the oldest.  An enqueue that
// returns a count of the work it launched (K4: the reverse steps of its
// coefficient launches) has it kept with its graph; *work gets the count of
// the loop this call ran, replayed or not (0 for an enqueue that returns
// nothing, or on an error).
template <typename F>
cudaError_t launch_loop(F&& enqueue, bool graph, GraphCache& cache, const GraphKey& key,
                        cudaStream_t st, long long* work = nullptr) {
  long long ran = 0;
  const auto enq = [&](cudaStream_t s) {
    if constexpr (std::is_void_v<decltype(enqueue(s))>)
      enqueue(s);
    else
      ran = enqueue(s);
  };
  const auto done = [&](cudaError_t e) {
    if (work != nullptr) *work = e == cudaSuccess ? ran : 0;
    return e;
  };
  if (!graph) {
    enq(st);
    return done(cudaGetLastError());
  }
  std::lock_guard<std::mutex> lock(cache.mu);
  auto& es = cache.entries;
  const auto it = std::find_if(es.begin(), es.end(),
                               [&](const GraphEntry& e) { return e.key.dims == key.dims; });
  const bool seen = it != es.end();
  if (seen) {
    std::rotate(es.begin(), it, it + 1);
    if (es.front().key.ptrs == key.ptrs) {
      ran = es.front().work;
      return done(cudaGraphLaunch(es.front().exec, st));
    }
  }
  const auto t0 = std::chrono::steady_clock::now();
  const auto built = [&] {
    cache.build_ns += std::chrono::duration_cast<std::chrono::nanoseconds>(
                          std::chrono::steady_clock::now() - t0)
                          .count();
  };
  cudaGraph_t g = nullptr;
  cudaError_t err = capture(enq, &g);
  if (err == cudaSuccess && seen) {
    // an update changes the launches to come, not one already in flight
    cudaGraphExecUpdateResultInfo info;
    if (cudaGraphExecUpdate(es.front().exec, g, &info) == cudaSuccess) {
      cudaGraphDestroy(g);
      es.front().key.ptrs = key.ptrs;
      es.front().work = ran;
      ++cache.updates;
      built();
      return done(cudaGraphLaunch(es.front().exec, st));
    }
    cudaGetLastError();  // the topology changed: instantiate anew below
    cudaGraphExecDestroy(es.front().exec);
    es.erase(es.begin());
  }
  cudaGraphExec_t exec = nullptr;
  if (err == cudaSuccess) err = cudaGraphInstantiate(&exec, g, 0);
  if (g) cudaGraphDestroy(g);
  built();
  if (err != cudaSuccess) {
    if (exec) cudaGraphExecDestroy(exec);
    return done(err);
  }
  ++cache.captures;
  if ((int)es.size() == kGraphs) {
    // an executable graph still in flight is freed when its launch completes
    cudaGraphExecDestroy(es.back().exec);
    es.pop_back();
  }
  es.insert(es.begin(), {key, exec, ran});
  return done(cudaGraphLaunch(exec, st));
}

// ------------------------------------------------------------ attention

// q partials: qpart[ks][b][a] = sum over k in [ks * kQChunk, ...) of
// h[b][k] query_w[k][a], for all B rows at once, so query_w is read once a
// step; the attention CTAs add the cdiv(H, kQChunk) partials in order.
// Grid (cdiv(A, 32), cdiv(H, kQChunk), steps), 256 threads, each 4 rows x 2
// units; grid z takes consecutive steps of h (B, H) into consecutive sets
// of partials (z = 0 alone in the forward).
__global__ void __launch_bounds__(256)
att_query(const float* __restrict__ h, int B, int H, const float* __restrict__ wq, int A,
          float* __restrict__ qpart) {
  __shared__ __align__(16) float hs[kQChunk][64 + 4];
  __shared__ __align__(16) float ws[kQChunk][32];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int a0 = blockIdx.x * 32, k0 = blockIdx.y * kQChunk;
  h += (size_t)blockIdx.z * B * H;
  qpart += (size_t)blockIdx.z * gridDim.y * B * A;
  for (int i = tid; i < 64 * kQChunk; i += 256) {
    const int b = i / kQChunk, k = i % kQChunk;
    hs[k][b] = b < B && k0 + k < H ? h[(size_t)b * H + k0 + k] : 0.0f;
  }
  for (int i = tid; i < kQChunk * 32; i += 256) {
    const int k = i / 32, a = i % 32;
    ws[k][a] = k0 + k < H && a0 + a < A ? wq[(size_t)(k0 + k) * A + a0 + a] : 0.0f;
  }
  __syncthreads();
  float acc[4][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll 8
  for (int k = 0; k < kQChunk; ++k) {
    const float4 hv = *reinterpret_cast<const float4*>(&hs[k][4 * ty]);
    const float2 wv = *reinterpret_cast<const float2*>(&ws[k][2 * tx]);
    const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      acc[r][0] = fmaf(hr[r], wv.x, acc[r][0]);
      acc[r][1] = fmaf(hr[r], wv.y, acc[r][1]);
    }
  }
  float* out = qpart + (size_t)blockIdx.y * B * A;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int b = 4 * ty + r;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int a = a0 + 2 * tx + c;
      if (b < B && a < A) out[(size_t)b * A + a] = acc[r][c];
    }
  }
}

// One attention CTA's share of a row: positions [s0, s0 + n) of the S,
// in chunks of Sc (the last ones shorter or empty), cluster rank `rank`;
// or any chunk of Sc positions from s0 (the backward's coefficient pass).
// Per-chunk arrays are padded to Sc4 positions, A4 units and F4 filters.
struct AttGeo {
  int Sc, Sc4, s0, n, A4, F4, nAq, nFq, pad, L;
  __host__ __device__ AttGeo(const Dims& d, int rank)
      : AttGeo(d, rank * cdiv(d.S, kNC), cdiv(d.S, kNC)) {}
  __host__ __device__ AttGeo(const Dims& d, int s0_, int Sc_) {
    Sc = Sc_;
    Sc4 = up4(Sc);
    s0 = s0_;
    n = d.S - s0 < Sc ? d.S - s0 : Sc;
    if (n < 0) n = 0;
    A4 = up4(d.A);
    F4 = up4(d.F);
    nAq = A4 / 4;
    nFq = F4 / 4;
    pad = (d.K - 1) / 2;
    L = Sc + d.K - 1;  // positions [s0 - pad, s0 + Sc + pad)
  }
};

// Shared-memory layout of an attention CTA (floats; every array a multiple
// of 4 floats): a common part, then the forward's own (epart's rows padded
// by one float: a warp reads down its columns) or, in the backward's
// coefficient pass, loc (Sc4, F4), which att_loc then fills beside locT.
struct AttSmem {
  float *q, *v, *wpad, *lw, *ldw, *locT, *e, *slot, *red;  // common
  float *epart, *cpart, *csc;                              // forward
  float* loc;                                              // backward
  __host__ __device__ static int common_floats(const Dims& d, const AttGeo& g) {
    return 2 * g.A4 + up4(2 * g.L) + up4(d.K * 2 * d.F) + d.F * g.A4 + d.F * g.Sc4 + g.Sc4 +
           8 + 32;
  }
  __host__ __device__ static int ctx_scratch(const Dims& d) {
    return up4(d.E > 4 * kAttThreads ? d.E : 4 * kAttThreads);
  }
  __host__ __device__ static int fwd_floats(const Dims& d) {
    const AttGeo g(d, 0);
    return common_floats(d, g) + up4(g.Sc4 * (g.nAq + 1)) + up4(d.E) + ctx_scratch(d);
  }
  __host__ __device__ static int bwd_floats(const Dims& d, const AttGeo& g) {
    return common_floats(d, g) + g.Sc4 * g.F4;
  }
  __device__ AttSmem(float* sm, const Dims& d, const AttGeo& g, bool bwd) {
    q = sm;
    v = q + g.A4;
    wpad = v + g.A4;
    lw = wpad + up4(2 * g.L);
    ldw = lw + up4(d.K * 2 * d.F);
    locT = ldw + d.F * g.A4;
    e = locT + d.F * g.Sc4;
    slot = e + g.Sc4;
    red = slot + 8;
    float* p = red + 32;
    epart = cpart = csc = loc = nullptr;
    if (bwd) {
      loc = p;
      return;
    }
    epart = p;
    cpart = epart + up4(g.Sc4 * (g.nAq + 1));
    csc = cpart + up4(d.E);
  }
};

// dst[i] = src[i] for i < n, 16 bytes a load when n % 4 == 0 (both 16-byte
// aligned), else one float at a time.
__device__ __forceinline__ void copy_f4(float* dst, const float* __restrict__ src, int n) {
  if (n % 4 == 0) {
#pragma unroll 4
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x)
      reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

// Stage a row's attention inputs for this CTA: q (the partials of att_query
// added in order), v, the zero-padded halos of [w_prev; w_cum] around the
// chunk, loc_w (K, 2, F) and loc_dense_w (F, A) with rows padded to A4.
__device__ __forceinline__ void att_stage(const AttSmem& s, const Dims& d, const AttGeo& g, int b,
                                          const float* qpart, const float* v, const float* w_prev,
                                          const float* w_cum, const float* locw, const float* ldw) {
  constexpr int kMaxQ = 16;  // partials loaded at once (H <= 1024 at kQChunk 64)
  const int nks = cdiv(d.H, kQChunk);
  for (int a = threadIdx.x; a < g.A4; a += blockDim.x) {
    float acc = 0.0f;
    if (a < d.A) {
      for (int k0 = 0; k0 < nks; k0 += kMaxQ) {
        float part[kMaxQ];
#pragma unroll
        for (int i = 0; i < kMaxQ; ++i)
          part[i] = k0 + i < nks ? qpart[((size_t)(k0 + i) * d.B + b) * d.A + a] : 0.0f;
#pragma unroll
        for (int i = 0; i < kMaxQ; ++i)
          if (k0 + i < nks) acc += part[i];
      }
    }
    s.q[a] = acc;
    s.v[a] = a < d.A ? v[a] : 0.0f;
  }
  for (int i = threadIdx.x; i < g.L; i += blockDim.x) {
    const int p = g.s0 - g.pad + i;
    const bool in = p >= 0 && p < d.S;
    s.wpad[i] = in ? w_prev[p] : 0.0f;
    s.wpad[g.L + i] = in ? w_cum[p] : 0.0f;
  }
  copy_f4(s.lw, locw, d.K * 2 * d.F);
  if (g.A4 == d.A) {
    copy_f4(s.ldw, ldw, d.F * d.A);
  } else {
    for (int i = threadIdx.x; i < d.F * g.A4; i += blockDim.x) {
      const int f = i / g.A4, a = i - f * g.A4;
      s.ldw[i] = a < d.A ? ldw[f * d.A + a] : 0.0f;
    }
  }
}

// Location features of the chunk: loc[p][f] = sum_k w_prev[p + k - pad]
// loc_w[k][0][f] + w_cum[p + k - pad] loc_w[k][1][f] (the taps in order),
// into locT[f][p] (and loc[p][f] when given), zero for p >= n; 4 filters a
// thread (16-byte loc_w loads) when F % 4 == 0.
__device__ __forceinline__ void att_loc(const AttSmem& s, const Dims& d, const AttGeo& g) {
  if (d.F % 4 == 0) {
    for (int i = threadIdx.x; i < g.Sc4 * g.nFq; i += blockDim.x) {
      const int p = i / g.nFq, f0 = 4 * (i - p * g.nFq);
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (p < g.n)
        for (int k = 0; k < d.K; ++k) {
          const float w0 = s.wpad[p + k], w1 = s.wpad[g.L + p + k];
          const float4 l0 = *reinterpret_cast<const float4*>(s.lw + (k * 2) * d.F + f0);
          const float4 l1 = *reinterpret_cast<const float4*>(s.lw + (k * 2 + 1) * d.F + f0);
          acc[0] = fmaf(w1, l1.x, fmaf(w0, l0.x, acc[0]));
          acc[1] = fmaf(w1, l1.y, fmaf(w0, l0.y, acc[1]));
          acc[2] = fmaf(w1, l1.z, fmaf(w0, l0.z, acc[2]));
          acc[3] = fmaf(w1, l1.w, fmaf(w0, l0.w, acc[3]));
        }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s.locT[(f0 + c) * g.Sc4 + p] = acc[c];
        if (s.loc != nullptr) s.loc[p * g.F4 + f0 + c] = acc[c];
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < g.Sc4 * d.F; i += blockDim.x) {
    const int p = i / d.F, f = i - p * d.F;
    float acc = 0.0f;
    if (p < g.n)
      for (int k = 0; k < d.K; ++k) {
        acc = fmaf(s.wpad[p + k], s.lw[(k * 2) * d.F + f], acc);
        acc = fmaf(s.wpad[g.L + p + k], s.lw[(k * 2 + 1) * d.F + f], acc);
      }
    s.locT[f * g.Sc4 + p] = acc;
    if (s.loc != nullptr) s.loc[p * g.F4 + f] = acc;
  }
}

// tanh(q[a] + loc[p] . loc_dense[:, a] + pmem[p][a]) for the 4 x 4 tile of
// positions 4pq.. and units 4aq.. (register-tiled over F); `pm` is the
// chunk's first pmem row.  Zero pmem outside the chunk and the units.
__device__ __forceinline__ void att_tanh_tile(const AttSmem& s, const Dims& d, const AttGeo& g,
                                              const float* __restrict__ pm, int pq, int aq,
                                              float (&ta)[4][4]) {
  float pv[4][4], l[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int p = 4 * pq + r, a = 4 * aq + c;
      pv[r][c] = p < g.n && a < d.A ? __ldcs(pm + (size_t)p * d.A + a) : 0.0f;
      l[r][c] = 0.0f;
    }
  for (int f = 0; f < d.F; ++f) {
    const float4 lv = *reinterpret_cast<const float4*>(s.locT + f * g.Sc4 + 4 * pq);
    const float4 wv = *reinterpret_cast<const float4*>(s.ldw + f * g.A4 + 4 * aq);
    const float lr[4] = {lv.x, lv.y, lv.z, lv.w}, wc[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) l[r][c] = fmaf(lr[r], wc[c], l[r][c]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) ta[r][c] = tanhf(s.q[4 * aq + c] + l[r][c] + pv[r][c]);
}

// Context partial of the chunk: out[k] = sum_{p < n} w[p] mem[p][k] (E % 4
// == 0), 16-byte loads marked streaming (evict first: memory is too large to
// keep in L2 beside the LSTM weights), the positions split over the block's
// spare threads (partials in `scratch`, max(E, 4 * blockDim.x) floats,
// added in order).
__device__ __forceinline__ void att_context(const float* __restrict__ mem, const float* w, int n,
                                            int E, float* scratch, float* out) {
  const int E4 = E / 4, ns = max(1, (int)blockDim.x / E4);
  for (int i = threadIdx.x; i < ns * E4; i += blockDim.x) {
    const int kq = i % E4, ps = i / E4;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 8
    for (int p = ps; p < n; p += ns) {
      const float4 m = __ldcs(reinterpret_cast<const float4*>(mem + (size_t)p * E + 4 * kq));
      const float wp = w[p];
      acc.x = fmaf(wp, m.x, acc.x);
      acc.y = fmaf(wp, m.y, acc.y);
      acc.z = fmaf(wp, m.z, acc.z);
      acc.w = fmaf(wp, m.w, acc.w);
    }
    *reinterpret_cast<float4*>(scratch + (size_t)ps * E + 4 * kq) = acc;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < E; k += blockDim.x) {
    float acc = 0.0f;
    for (int ps = 0; ps < ns; ++ps) acc += scratch[(size_t)ps * E + k];
    out[k] = acc;
  }
}

}  // namespace t2v
