// Per-(sample, channel) sums over the spatial plane, in a fixed order, for
// the per-sample batch-stat norm of inference on Hopper (sm_90a), float32
// and bfloat16 input.
//
// Replaces the reductions that deepliif_tpu/nets/layers.py batch_stat_norm
// (per_sample=True) leaves to XLA (mean, then the mean of (x - mean)^2, in
// float32), and the head statistics of the fused translator stages
// (deepliif_tpu/nets/resnet.py _apply_fused: sum and sum of squares of the
// head conv output). For x (S, P, C) NHWC (P = H * W pixels) and an
// optional center m (S, C):
//
//   stats[s, 0, c] = sum_p (x[s, p, c] - m[s, c])
//   stats[s, 1, c] = sum_p (x[s, p, c] - m[s, c])^2       (m = 0 if absent)
//
// in float32. A norm calls it twice (m = 0 for the mean, m = mean for the
// variance): the JAX package's two-pass formula.
//
// Why a kernel: torch's CUDA mean over (H, W) splits its sum by the shape
// of the whole tensor, so a tile alone and the same tile in a batch of 16
// got different statistics. Here the order depends on P and C only: block
// (chunk, channel tile, sample) sums pixels chunk * 256 + row + 8 * i for
// rows 0..7 in pixel order (one thread per (row, channel)), the 8 rows are
// added in row order, and a second kernel adds the chunks in chunk order.
// No float atomics: bitwise reproducible and independent of the batch.
//
// What bounds it: it reads x once per call and does 3 flops per element:
// memory-bound (3.35 TB/s). Lanes run over 32 consecutive channels of a
// pixel (64 or 128 contiguous bytes per warp load), and each thread keeps
// four loads in flight.

#include "conv3x3_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int LANES = 32;          // channels per block
constexpr int ROWS = 8;            // pixel rows per block (one warp each)
constexpr int CHUNK = 256;         // pixels per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(LANES * ROWS)
plane_partial_kernel(const T* __restrict__ x, const float* __restrict__ center,
                     float* __restrict__ partial, int P, int C,
                     int n_chunks) {
  const int lane = threadIdx.x % LANES;
  const int row = threadIdx.x / LANES;
  const int chunk = blockIdx.x;
  const int c = blockIdx.y * LANES + lane;
  const int s = blockIdx.z;
  float s1 = 0.f, s2 = 0.f;
  if (c < C) {
    const float m = center ? center[(size_t)s * C + c] : 0.f;
    const T* xs = x + (size_t)s * P * C + c;
    const int p1 = min((chunk + 1) * CHUNK, P);
#pragma unroll 4
    for (int p = chunk * CHUNK + row; p < p1; p += ROWS) {
      const float d = to_f32(xs[(size_t)p * C]) - m;
      s1 += d;
      s2 = fmaf(d, d, s2);
    }
  }
  __shared__ float red[2][ROWS][LANES];
  red[0][row][lane] = s1;
  red[1][row][lane] = s2;
  __syncthreads();
  if (row == 0 && c < C) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      a += red[0][r][lane];
      b += red[1][r][lane];
    }
    float* ps = partial + ((size_t)s * n_chunks + chunk) * 2 * C;
    ps[c] = a;
    ps[C + c] = b;
  }
}

template <typename T>
int launch(const T* x, const float* center, float* partial, float* stats,
           int S, int P, int C, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_chunks = (P + CHUNK - 1) / CHUNK;
  const dim3 grid(n_chunks, (C + LANES - 1) / LANES, S);
  plane_partial_kernel<T><<<grid, LANES * ROWS, 0, st>>>(x, center, partial,
                                                         P, C, n_chunks);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      conv3x3::launch_stats_reduce(partial, stats, S, n_chunks, C, st));
}

}  // namespace

extern "C" {

// Number of pixel chunks per sample: the wrapper sizes the partial-sum
// scratch (S, n_chunks, 2, C) with it.
int plane_stats_num_chunks(int P) { return (P + CHUNK - 1) / CHUNK; }

// Launch both kernels on `stream`; returns the cudaError_t of the launches
// (0 on success). center may be null.
int plane_stats_f32(const float* x, const float* center, float* partial,
                    float* stats, int S, int P, int C, void* stream) {
  return launch<float>(x, center, partial, stats, S, P, C, stream);
}

int plane_stats_bf16(const void* x, const float* center, float* partial,
                     float* stats, int S, int P, int C, void* stream) {
  return launch<bf16>(static_cast<const bf16*>(x), center, partial, stats, S,
                      P, C, stream);
}

}  // extern "C"
