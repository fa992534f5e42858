// Pieces shared by the fused conv kernels of this directory
// (conv3x3_stats.cu: float32 on CUDA cores, bfloat16 on the tensor-core
// mainloop conv3x3_wgmma.cuh, which also runs the stride-2 translator
// stages conv3x3_s2_stats.cu and convtranspose3_s2_stats.cu;
// conv3x3_stats_int8.cu; tail_s2d.cu) and by plane_stats.cu: the output
// tiling of the CUDA-core trunk kernels, the halo source rule, cp.async
// wrappers, bfloat16 rounding helpers and the fixed-order per-(sample,
// channel) statistics.
//
// The CUDA-core trunk kernels (conv3x3_stats float32, conv3x3_stats_int8)
// tile the output the same way (conv3x3_wgmma.cuh tiles its own): one
// block per (spatial tile
// of TH x TW pixels, BN output channels, sample), 256 threads, each owning
// 2 x 4 pixels x 8 output channels. A warp holds 8 pixel groups x 4 channel
// groups. Pixel group pg owns tile rows 2*(pg/4) + {0,1} and columns
// 4*(pg%4) + {0..3}; channel group cg owns channels n0 + cg*4 + {0..3} and
// n0 + 64 + cg*4 + {0..3}.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace conv3x3 {

constexpr int TH = 8;                // output rows per block
constexpr int TW = 16;               // output columns per block
constexpr int BN = 128;              // output channels per block
constexpr int NT = 256;              // threads: 16 pixel groups x 16 channel groups
constexpr int IH = TH + 2;           // staged input rows (1-px halo)
constexpr int IW = TW + 2;           // staged input columns
// Row stride of a staged input plane (in 4-byte words): 16-byte aligned
// rows, and two row pairs 16 banks apart, so the 8 pixel groups of a warp
// read without conflicts.
constexpr int IWP = 24;
constexpr int IN_STRIDE = IH * IWP;  // words per staged input plane

struct Tile {
  int tile, n0, s, r0, c0, t, pg, cg, pr, pc;
};

__device__ __forceinline__ Tile tile_of_block(int tiles_w) {
  Tile q;
  q.tile = blockIdx.x;
  q.n0 = blockIdx.y * BN;
  q.s = blockIdx.z;
  q.r0 = (q.tile / tiles_w) * TH;
  q.c0 = (q.tile % tiles_w) * TW;
  q.t = threadIdx.x;
  const int lane = q.t % 32;
  const int warp = q.t / 32;
  q.pg = (warp % 2) * 8 + lane % 8;
  q.cg = (warp / 2) * 4 + lane / 8;
  q.pr = 2 * (q.pg / 4);
  q.pc = 4 * (q.pg % 4);
  return q;
}

// Output channel of a thread's accumulator column n (0..7).
__device__ __forceinline__ int out_channel(const Tile& q, int n) {
  return q.n0 + (n < 4 ? q.cg * 4 + n : 64 + q.cg * 4 + n - 4);
}

// Source index of padded position i along an axis of length n, or -1 where
// the value is zero: the zero-padding halo, and positions past the halo
// that only feed masked outputs of a ragged tile.
__device__ __forceinline__ int src_index(int i, int n, bool reflect) {
  if (i >= 0 && i < n) return i;
  if (reflect && i == -1) return 1;
  if (reflect && i == n) return n - 2;
  return -1;
}

// cp.async copies of 4 or 16 bytes; valid == false zero-fills the
// destination without reading the source.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// waits until this thread's copies of all but the newest group have landed
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
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

// 8 bf16 input channels k0..k0+7 of one pixel (one 16-byte load) -> floats
// after the optional norm affine (in bf16, as affine_bf16) and ReLU, for the
// sample whose (S, C) affine rows start at scale/bias. Used by the tail
// kernel, which stages its input without cp.async.
__device__ __forceinline__ void unpack8_affine_relu(
    uint4 v, const float* __restrict__ scale, const float* __restrict__ bias,
    int k0, bool has_affine, bool in_relu, float (&u)[8]) {
  const unsigned words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    u[k] = (k % 2 == 0) ? bf16_lo(words[k / 2]) : bf16_hi(words[k / 2]);
    if (has_affine)
      u[k] = affine_bf16(u[k], bf16_round(scale[k0 + k]),
                         bf16_round(bias[k0 + k]));
    if (in_relu) u[k] = fmaxf(u[k], 0.f);
  }
}

// ---- statistics: per-channel partial sums over this block's pixels, in a
// fixed order (each thread sums its own pixels in order, then an xor
// butterfly over the 8 lanes of a warp sharing a channel
// group, then the warp holding pixel groups 8-15 hands its sums to the one
// holding 0-7), written to partial[s, tile, {sum, sumsq}, c]. No float
// atomics: results are bitwise reproducible run to run and do not depend
// on the batch a sample rides in. `red` is 512 floats of shared memory
// that no thread reads any more; psum/psq are a thread's sums over its
// in-range pixels.
__device__ __forceinline__ void block_partial_stats(
    const Tile& q, float (&psum)[8], float (&psq)[8], float* red,
    float* partial, int C, int n_tiles) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      psum[n] += __shfl_xor_sync(0xffffffffu, psum[n], off);
      psq[n] += __shfl_xor_sync(0xffffffffu, psq[n], off);
    }
  }
  if (q.pg == 8) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      red[(q.cg * 8 + n) * 2] = psum[n];
      red[(q.cg * 8 + n) * 2 + 1] = psq[n];
    }
  }
  __syncthreads();
  if (q.pg == 0) {
    float* ps = partial + ((size_t)q.s * n_tiles + q.tile) * 2 * C;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int co = out_channel(q, n);
      if (co < C) {
        ps[co] = psum[n] + red[(q.cg * 8 + n) * 2];
        ps[C + co] = psq[n] + red[(q.cg * 8 + n) * 2 + 1];
      }
    }
  }
}

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

inline int num_tiles(int H, int W) {
  return ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
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
