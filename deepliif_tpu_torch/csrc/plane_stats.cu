// Per-(sample, channel) statistics over the spatial plane, in one read of x
// and in a fixed order, for the per-sample batch-stat norm of inference on
// Hopper (sm_90a), float32 and bfloat16 input.
//
// Replaces the reductions that deepliif_tpu/nets/layers.py batch_stat_norm
// (per_sample=True) leaves to XLA (the mean, then the mean of (x - mean)^2,
// in float32: the two-pass formula); the head statistics of the fused
// translator stages (deepliif_tpu/nets/resnet.py _apply_fused: sum and sum
// of squares) are derived from the same result by the wrapper
// (layers.plane_sums). For x (S, P, C) NHWC (P = H * W pixels; or NCHW
// memory, see below), in float32:
//
//   stats[s, 0, c] = mean,  stats[s, 1, c] = sum_p (x - mean)^2 / P
//
// Why a kernel: torch's CUDA mean over (H, W) splits its sum by the shape
// of the whole tensor, so a tile alone and the same tile in a batch of 16
// got different statistics. Here the order depends on P and C only, with
// no float atomics: bitwise reproducible and independent of the batch.
// The chunk layout is decided in one place, the wrapper
// (layers._plane_geometry, a function of P, C, the element size and the
// layout); the constants below are the array sizes it is built on, and
// launch() refuses any geometry that does not fit them.
//
// What bounds it: x read once, a few flops per element: memory-bound (the
// flagship's (16, 64, 512, 512) bf16 norm, 537 MB: 0.160 ms at 3.35 TB/s).
// The first version took the mean in one call and sum (x - mean)^2 in a
// second one, so it read x twice (0.56 ms on the H100, against
// torch.var_mean's 0.33 ms). This design reads it once:
//  * chunk kernel: block (chunk, channel tile, sample) holds its chunk of
//    rows * V pixels x G 16-byte channel units in registers (V = 16 loads
//    of 16 bytes a thread, all issued before any is used: 64 KB in flight
//    per block; on the H100 V = 16 beat V = 8 by 10 % at float32, and the
//    tree in shared memory beat warp shuffles). Thread (pixel lane pl, unit g) holds pixels chunk * rows *
//    V + pl + rows * i. It sums its values, the pixel lanes' sums go
//    through a fixed-order tree in shared memory, the chunk mean is sum /
//    n; then it sums (x - chunk mean)^2 from the values still in registers
//    and the tree gives the chunk's M2. Exact two-pass arithmetic per chunk,
//    so a large offset (mean >> std) costs no digits, as it would in
//    sum x^2 - n mean^2;
//  * merge kernel: per (sample, channel), n_seg threads each merge a
//    contiguous run of chunks in chunk order with Chan's formula
//        M2 = M2a + M2b + d^2 na nb / (na + nb),  d = mean_b - mean_a,
//    then thread 0 merges the runs in order. The partials are 2 floats per
//    (chunk, channel): 2.1 MB at the flagship's bf16 shape, under 1 % of x;
//  * NCHW input (the float32 path's unet up-norms: cuDNN's float32
//    conv-transposes are NCHW-native and slower in NHWC on the H100,
//    experiments/torch_segnet_spread.py --layout) is read
//    in place by a second chunk kernel: a plane is contiguous there, so
//    block (chunk, channel, sample) holds 256 x V 16-byte loads of one
//    plane, sums them through a warp butterfly and the warps in order, and
//    writes the same partials for the same merge.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;      // threads of a chunk block
constexpr int V = 16;        // 16-byte loads per thread
constexpr int SEG = 16;      // most runs of chunks per (sample, channel)
constexpr int MC = 16;       // channels per merge block

// 16 bytes of x -> the floats of N consecutive channels
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void get(const uint4& v, float (&f)[N]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
};

template <>
struct Vec<bf16> {
  static constexpr int N = 8;
  __device__ static void get(const uint4& v, float (&f)[N]) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// Sum of v over the block's pixel lanes (rows of G threads), in a fixed
// tree: lane pl adds lane pl + h for h = (power of two >= rows) / 2, ...,
// 1. On return every thread holds the sums of its channel unit.
template <int N>
__device__ __forceinline__ void lane_sum(float (&v)[N], float* red, int t,
                                         int pl, int g, int G, int rows) {
  float4* r4 = reinterpret_cast<float4*>(red);
#pragma unroll
  for (int k = 0; k < N / 4; ++k)
    r4[t * (N / 4) + k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2],
                                      v[4 * k + 3]);
  __syncthreads();
  int h = 1;
  while (2 * h < rows) h *= 2;
  for (; h >= 1; h /= 2) {
    if (pl < h && pl + h < rows) {
#pragma unroll
      for (int k = 0; k < N / 4; ++k) {
        float4 a = r4[t * (N / 4) + k];
        const float4 b = r4[(t + h * G) * (N / 4) + k];
        a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
        r4[t * (N / 4) + k] = a;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    const float4 a = r4[g * (N / 4) + k];
    v[4 * k] = a.x; v[4 * k + 1] = a.y; v[4 * k + 2] = a.z; v[4 * k + 3] = a.w;
  }
  __syncthreads();   // red is reused by the next call
}

// partial[s, chunk, 0, c] = the chunk's mean, partial[s, chunk, 1, c] = its
// sum of (x - mean)^2
template <typename T>
__global__ void __launch_bounds__(NT)
plane_chunk_kernel(const T* __restrict__ x, float* __restrict__ partial,
                   int P, int C, int G, int rows, int chunk_px,
                   int n_chunks) {
  constexpr int N = Vec<T>::N;
  __shared__ __align__(16) float red[NT * N];
  const int t = threadIdx.x;
  const int g = t % G;
  const int pl = t / G;
  const int c0 = (blockIdx.y * G + g) * N;
  const bool on = pl < rows && c0 < C;
  const int s = blockIdx.z;
  const int chunk = blockIdx.x;
  const int p0 = chunk * chunk_px + pl;
  const int n = min(chunk_px, P - chunk * chunk_px);
  const T* xs = x + (size_t)s * P * C + c0;

  uint4 v[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int p = p0 + rows * i;
    v[i] = (on && p < P)
               ? __ldg(reinterpret_cast<const uint4*>(xs + (size_t)p * C))
               : make_uint4(0u, 0u, 0u, 0u);
  }
  float sum[N];
#pragma unroll
  for (int k = 0; k < N; ++k) sum[k] = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float f[N];
    Vec<T>::get(v[i], f);
#pragma unroll
    for (int k = 0; k < N; ++k) sum[k] += f[k];   // zeros past P add 0
  }
  lane_sum<N>(sum, red, t, pl, g, G, rows);
  float mean[N], m2[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    mean[k] = sum[k] / static_cast<float>(n);
    m2[k] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (p0 + rows * i < P) {
      float f[N];
      Vec<T>::get(v[i], f);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float d = f[k] - mean[k];
        m2[k] = fmaf(d, d, m2[k]);
      }
    }
  }
  lane_sum<N>(m2, red, t, pl, g, G, rows);
  if (pl == 0 && c0 < C) {
    float* ps = partial + ((size_t)s * n_chunks + chunk) * 2 * C + c0;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      ps[k] = mean[k];
      ps[C + k] = m2[k];
    }
  }
}

// Sum of v over the block: an xor butterfly in each warp (every lane ends
// with the same sum, since float addition commutes), then the 8 warps' sums
// in warp order.
__device__ __forceinline__ float block_sum(float v, float* red, int t) {
#pragma unroll
  for (int o = 16; o >= 1; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (t % 32 == 0) red[t / 32] = v;
  __syncthreads();
  float total = red[0];
#pragma unroll
  for (int w = 1; w < NT / 32; ++w) total += red[w];
  __syncthreads();   // red is reused by the next call
  return total;
}

// The same partials from NCHW memory, where plane (s, c) is P contiguous
// values: block (chunk, c, s) holds chunk_px = NT * V * N pixels of one
// plane, thread t the N-value loads t + NT * i (N = 16 bytes of values,
// or 1 where P * sizeof(T) is not a multiple of 16 and a plane may start
// unaligned).
template <typename T, bool VEC>
__global__ void __launch_bounds__(NT)
plane_chunk_nchw_kernel(const T* __restrict__ x, float* __restrict__ partial,
                        int P, int C, int chunk_px, int n_chunks) {
  constexpr int N = VEC ? Vec<T>::N : 1;
  __shared__ float red[NT / 32];
  const int t = threadIdx.x;
  const int chunk = blockIdx.x;
  const int c = blockIdx.y;
  const int s = blockIdx.z;
  const int n = min(chunk_px, P - chunk * chunk_px);
  const T* xs = x + ((size_t)s * C + c) * P + (size_t)chunk * chunk_px;

  uint4 v[VEC ? V : 1];
  float u[VEC ? 1 : V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int e = (t + NT * i) * N;        // n % N == 0 when VEC
    if constexpr (VEC)
      v[i] = e < n ? __ldg(reinterpret_cast<const uint4*>(xs + e))
                   : make_uint4(0u, 0u, 0u, 0u);
    else
      u[i] = e < n ? to_f32(xs[e]) : 0.f;
  }
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if constexpr (VEC) {
      float f[N];
      Vec<T>::get(v[i], f);
#pragma unroll
      for (int k = 0; k < N; ++k) sum += f[k];
    } else {
      sum += u[i];
    }
  }
  const float mean = block_sum(sum, red, t) / static_cast<float>(n);
  float m2 = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if ((t + NT * i) * N >= n) continue;
    if constexpr (VEC) {
      float f[N];
      Vec<T>::get(v[i], f);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float d = f[k] - mean;
        m2 = fmaf(d, d, m2);
      }
    } else {
      const float d = u[i] - mean;
      m2 = fmaf(d, d, m2);
    }
  }
  m2 = block_sum(m2, red, t);
  if (t == 0) {
    float* ps = partial + ((size_t)s * n_chunks + chunk) * 2 * C + c;
    ps[0] = mean;
    ps[C] = m2;
  }
}

// (n, mean, m2) <- its merge with a run of nb values of mean mb and M2 mb2
__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2,
                                           float nb, float mb, float mb2) {
  if (nb == 0.f) return;
  const float nn = n + nb;
  const float d = mb - mean;
  mean += d * (nb / nn);
  m2 += mb2 + d * d * (n * nb / nn);
  n = nn;
}

// block (channel tile, sample) of n_seg * MC threads: n_seg runs of
// ceil(n_chunks / n_seg) chunks each
__global__ void __launch_bounds__(SEG * MC)
plane_merge_kernel(const float* __restrict__ partial, float* __restrict__ stats,
                   int P, int C, int chunk_px, int n_chunks, int n_seg) {
  __shared__ float run[3][SEG][MC];
  const int cl = threadIdx.x % MC;
  const int seg = threadIdx.x / MC;
  const int c = blockIdx.x * MC + cl;
  const int s = blockIdx.y;
  const int len = (n_chunks + n_seg - 1) / n_seg;
  const int j1 = min((seg + 1) * len, n_chunks);
  float n = 0.f, mean = 0.f, m2 = 0.f;
  if (c < C) {
    const float* ps = partial + (size_t)s * n_chunks * 2 * C + c;
    for (int j = seg * len; j < j1; ++j)
      chan_merge(n, mean, m2,
                 static_cast<float>(min(chunk_px, P - j * chunk_px)),
                 ps[(size_t)j * 2 * C], ps[(size_t)j * 2 * C + C]);
  }
  run[0][seg][cl] = n;
  run[1][seg][cl] = mean;
  run[2][seg][cl] = m2;
  __syncthreads();
  if (seg != 0 || c >= C) return;
  for (int r = 1; r < n_seg; ++r)
    chan_merge(n, mean, m2, run[0][r][cl], run[1][r][cl], run[2][r][cl]);
  float* out = stats + (size_t)s * 2 * C + c;
  out[0] = mean;
  out[C] = m2 / static_cast<float>(P);
}

template <typename T>
int launch(const T* x, float* partial, float* stats, int S, int P, int C,
           int nchw, int G, int rows, int chunk_px, int n_chunks, int n_seg,
           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int N = Vec<T>::N;
  if (n_chunks != (P + chunk_px - 1) / chunk_px || n_seg < 1 || n_seg > SEG)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nchw) {
    const bool vec = (static_cast<long>(P) * sizeof(T)) % 16 == 0;
    if (chunk_px != NT * V * (vec ? N : 1))
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(n_chunks, C, S);
    if (vec)
      plane_chunk_nchw_kernel<T, true><<<grid, NT, 0, st>>>(
          x, partial, P, C, chunk_px, n_chunks);
    else
      plane_chunk_nchw_kernel<T, false><<<grid, NT, 0, st>>>(
          x, partial, P, C, chunk_px, n_chunks);
  } else {
    if (C % N || G < 1 || G > 32 || rows < 1 || G * rows > NT ||
        chunk_px != rows * V)
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(n_chunks, (C / N + G - 1) / G, S);
    plane_chunk_kernel<T><<<grid, NT, 0, st>>>(x, partial, P, C, G, rows,
                                              chunk_px, n_chunks);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  plane_merge_kernel<<<dim3((C + MC - 1) / MC, S), n_seg * MC, 0, st>>>(
      partial, stats, P, C, chunk_px, n_chunks, n_seg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch both kernels on `stream`; returns the cudaError_t of the launches
// (0 on success; cudaErrorInvalidValue for a geometry the kernels are not
// built for). x: NHWC memory (nchw 0) or NCHW memory (nchw 1), 16-byte
// aligned. partial: (S, n_chunks, 2, C) float32 scratch. stats: (S, 2, C)
// [mean, biased variance]. The geometry comes from the wrapper
// (layers._plane_geometry): NHWC, G 16-byte channel units (<= 32) x rows
// pixel lanes (G * rows <= 256), chunk_px = rows * V; NCHW, chunk_px = 256
// * V * (values per 16 bytes, or 1 where P * sizeof(T) is not a multiple
// of 16); n_chunks = ceil(P / chunk_px); n_seg (<= 16) runs merged per
// channel.
int plane_stats_f32(const float* x, float* partial, float* stats, int S,
                    int P, int C, int nchw, int G, int rows, int chunk_px,
                    int n_chunks, int n_seg, void* stream) {
  return launch<float>(x, partial, stats, S, P, C, nchw, G, rows, chunk_px,
                       n_chunks, n_seg, stream);
}

int plane_stats_bf16(const void* x, float* partial, float* stats, int S,
                     int P, int C, int nchw, int G, int rows, int chunk_px,
                     int n_chunks, int n_seg, void* stream) {
  return launch<bf16>(static_cast<const bf16*>(x), partial, stats, S, P, C,
                      nchw, G, rows, chunk_px, n_chunks, n_seg, stream);
}

}  // extern "C"
