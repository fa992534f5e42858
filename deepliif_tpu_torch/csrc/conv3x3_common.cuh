// Pieces shared by the fused conv kernels of this directory (the
// tensor-core mainloop conv3x3_wgmma.cuh, which runs conv3x3_stats.cu
// (float32, bfloat16), conv3x3_stats_int8.cu and the stride-2 translator
// stages conv3x3_s2_stats.cu and convtranspose3_s2_stats.cu; tail_s2d.cu):
// the halo source rule, a cp.async wrapper, bfloat16 rounding helpers and
// the fixed-order reduction of the per-tile statistics.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace conv3x3 {

// Source index of padded position i along an axis of length n, or -1 where
// the value is zero: the zero-padding halo, and positions past the halo
// that only feed masked outputs of a ragged tile.
__device__ __forceinline__ int src_index(int i, int n, bool reflect) {
  if (i >= 0 && i < n) return i;
  if (reflect && i == -1) return 1;
  if (reflect && i == n) return n - 2;
  return -1;
}

// cp.async copy of 16 bytes; valid == false zero-fills the destination
// without reading the source.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// ---- bfloat16: values are carried in float registers and rounded to
// bfloat16 (nearest, ties to even) where the TPU kernel stores bf16.

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// element 0 of a packed pair sits in the low 16 bits (little endian)
__device__ __forceinline__ float bf16_lo(unsigned v) {
  return __uint_as_float(v << 16);
}

__device__ __forceinline__ float bf16_hi(unsigned v) {
  return __uint_as_float(v & 0xffff0000u);
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(hi)))
          << 16);
}

// The norm affine in bfloat16, as the TPU kernel runs it on a bf16 block:
// the product and the sum are each rounded to bf16 (sc, bi hold bf16
// values). A product of two bf16 values is exact in float, so rounding it
// once gives the bf16 product.
__device__ __forceinline__ float affine_bf16(float u, float sc, float bi) {
  return bf16_round(bf16_round(u * sc) + bi);
}

// ---- statistics: the kernels write per-(sample, tile, channel) partial
// sums in a fixed order; this pass sums them in tile order. No float
// atomics: results are bitwise reproducible run to run and do not depend on
// the batch a sample rides in.

// stats[s, q, c] = sum over tiles, in tile order, of partial[s, tile, q, c]
__global__ void stats_reduce_kernel(const float* __restrict__ partial,
                                    float* __restrict__ stats, int S,
                                    int n_tiles, int C) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= S * 2 * C) return;
  const int c = idx % C;
  const int q = (idx / C) % 2;
  const int s = idx / (2 * C);
  const float* p = partial + ((size_t)s * n_tiles * 2 + q) * C + c;
  float acc = 0.f;
  for (int tile = 0; tile < n_tiles; ++tile) acc += p[(size_t)tile * 2 * C];
  stats[idx] = acc;
}

inline cudaError_t launch_stats_reduce(const float* partial, float* stats,
                                       int S, int n_tiles, int C,
                                       cudaStream_t st) {
  const int total = S * 2 * C;
  stats_reduce_kernel<<<(total + 255) / 256, 256, 0, st>>>(partial, stats, S,
                                                           n_tiles, C);
  return cudaGetLastError();
}

}  // namespace conv3x3
