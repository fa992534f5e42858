// Fused (affine -> ReLU ->) 3x3 stride-1 conv + per-(sample, channel) output
// statistics, for the inference ResNet trunk on Hopper (sm_90a), in float32
// and in bfloat16.
//
// Replaces the TPU Pallas kernel deepliif_tpu/ops/fused_resblock.py::_kernel
// (driven by conv3x3_stats / resblock_chain). Same contract:
//
//   u     = relu(x * in_scale[s] + in_bias[s])    (affine and ReLU optional)
//   u     = pad1(u)                               (reflect, or zeros applied
//                                                  AFTER the affine/ReLU)
//   y     = conv3x3(u, w)                         (f32 accumulation)
//   stats = (sum_hw y, sum_hw y^2)  per (sample, channel), from the f32
//           accumulator
//
// bfloat16 (x, w and y bf16; scale/bias f32 as given): the affine runs in
// bf16 as on the TPU (scale and bias rounded to bf16, the product and the
// sum each rounded to bf16), the products of bf16 values are exact in f32
// and accumulate in f32 (the TPU MXU's bf16 x bf16 -> f32, up to the order
// of the sum), y is rounded to bf16 and the stats come from the f32
// accumulator, not from the rounded y.
//
// Layout: x and y are NHWC (S, H, W, C) contiguous, so a channels_last NCHW
// tensor enters with no transpose; w is HWIO (3, 3, C, C) contiguous, laid
// out once when the model is loaded; scale/bias are (S, C).
//
// What bounds it: at the flagship shape (128 x 128 x 256 per tile) one conv
// is 2 * 128*128 * 256*256 * 9 = 19.3 GFLOP per tile against 33.6 MB (f32)
// or 16.8 MB (bf16) of activation traffic in and out: compute-bound. This
// kernel runs on the FFMA pipe (67 TFLOP/s published for the H100 SXM at
// 700 W) in both types; bf16 tensor cores (989 TFLOP/s) are later work.
//
// Design (simple first):
//  * tiling and thread layout as in conv3x3_common.cuh; a thread reads its
//    4 x 6 float input window per input channel from shared memory once
//    (float4 + float2 per row) and reuses it for all 9 taps;
//  * the K loop walks input channels BK at a time through two shared-memory
//    stages: while the block runs the 9 * BK rank-1 updates of one stage,
//    cp.async copies the next (TH+2) x (TW+2) x BK input tile (halo rows
//    and columns from their reflected sources, zero-filled where padding
//    is zero) and the next 9 x BK x BN weight slice into the other.
//    float32 lands in the float input planes and each thread applies the
//    affine and ReLU in place to the values it copied; bfloat16 lands as 16
//    bytes per pixel (8 channels) in a raw buffer, and the thread that
//    copied it converts it (affine in bf16, ReLU) into the float planes.
//    The zero padding stays zero. bf16 weights stay bf16 in shared memory
//    and are widened as they are read;
//  * ragged edges (H % TH, W % TW, C % BN, C % BK) are masked; float32
//    takes any shape, bfloat16 needs C % 8 == 0 (16-byte copies);
//  * statistics: the TPU grid is sequential and accumulates across row
//    chunks; here blocks run in parallel, so each block writes per-channel
//    partial sums for its tile in a fixed order and a second kernel sums
//    them in tile order (conv3x3_common.cuh). No float atomics.
//
// Left for later: tensor cores (wgmma on bf16, or split-TF32 operands for
// float32), TMA loads and deeper pipelines, a persistent schedule, and
// fusing the stats reduction into the epilogue of the last block.

#include <type_traits>

#include "conv3x3_common.cuh"

namespace {

using namespace conv3x3;
using bf16 = __nv_bfloat16;

constexpr int BK = 8;                // input channels per shared-memory stage

template <typename T>
struct Stage {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  static constexpr int W_BYTES = 9 * BK * BN * (int)sizeof(T);
  static constexpr int IN_BYTES = BK * IN_STRIDE * 4;         // float planes
  static constexpr int RAW_BYTES = kBf16 ? IH * IW * BK * 2 : 0;
  static constexpr int BYTES = W_BYTES + IN_BYTES + RAW_BYTES;
  static constexpr int SMEM = 2 * BYTES;   // f32: 89,088; bf16: 57,984
};

// Position of input-tile element e (channel k, tile row/col) and whether it
// has a source value (false: zero padding, past the halo, or channel >= C).
struct InElem {
  int k, dst, gr, gc;   // channel in the stage, plane offset, source
  bool ok;
};

__device__ __forceinline__ InElem in_elem(int e, int k0, int r0, int c0,
                                          int H, int W, int C, bool reflect) {
  InElem q;
  q.k = e % BK;
  const int pix = e / BK;
  const int row = pix / IW;
  const int col = pix % IW;
  q.dst = q.k * IN_STRIDE + row * IWP + col;
  q.gr = src_index(r0 - 1 + row, H, reflect);
  q.gc = src_index(c0 - 1 + col, W, reflect);
  q.ok = q.gr >= 0 && q.gc >= 0 && k0 + q.k < C;
  return q;
}

// Pixel e (0 .. IH*IW) of the bf16 input tile: plane offset and source.
struct InPix {
  int dst, gr, gc;
  bool ok;
};

__device__ __forceinline__ InPix in_pix(int e, int r0, int c0, int H, int W,
                                        bool reflect) {
  InPix q;
  const int row = e / IW;
  const int col = e % IW;
  q.dst = row * IWP + col;
  q.gr = src_index(r0 - 1 + row, H, reflect);
  q.gc = src_index(c0 - 1 + col, W, reflect);
  q.ok = q.gr >= 0 && q.gc >= 0;
  return q;
}

// Issues the copies of input channels [k0, k0 + BK) into one stage.
template <typename T>
__device__ __forceinline__ void load_stage(
    char* stage, const T* xs, const T* __restrict__ w, int k0, int r0,
    int c0, int n0, int H, int W, int C, bool reflect, bool vec_w, int t) {
  T* w_s = reinterpret_cast<T*>(stage);
  if constexpr (Stage<T>::kBf16) {
    bf16* raw = reinterpret_cast<bf16*>(stage + Stage<T>::W_BYTES +
                                        Stage<T>::IN_BYTES);
    // C % 8 == 0 and BK == 8: a pixel's 8 channels are one 16-byte copy
    for (int e = t; e < IH * IW; e += NT) {
      const InPix q = in_pix(e, r0, c0, H, W, reflect);
      cp_async16(&raw[e * BK],
                 q.ok ? xs + ((size_t)q.gr * W + q.gc) * C + k0 : xs, q.ok);
    }
    for (int e = t; e < 9 * BK * BN / 8; e += NT) {   // 8 output channels
      const int n = (e % (BN / 8)) * 8;
      const int k = (e / (BN / 8)) % BK;
      const int tap = e / (BN / 8 * BK);
      const int ci = k0 + k;
      const int co = n0 + n;
      const bool ok = ci < C && co < C;
      cp_async16(&w_s[(tap * BK + k) * BN + n],
                 ok ? w + ((size_t)tap * C + ci) * C + co : w, ok);
    }
  } else {
    float* in_s = reinterpret_cast<float*>(stage + Stage<T>::W_BYTES);
    // the float32 loops stay rolled: unrolled, they spill registers
#pragma unroll 1
    for (int e = t; e < BK * IH * IW; e += NT) {
      const InElem q = in_elem(e, k0, r0, c0, H, W, C, reflect);
      cp_async4(&in_s[q.dst],
                q.ok ? xs + ((size_t)q.gr * W + q.gc) * C + k0 + q.k : xs,
                q.ok);
    }
    if (vec_w) {  // C % 4 == 0: 16-byte copies of 4 output channels
#pragma unroll 1
      for (int e = t; e < 9 * BK * BN / 4; e += NT) {
        const int n = (e % (BN / 4)) * 4;
        const int k = (e / (BN / 4)) % BK;
        const int tap = e / (BN / 4 * BK);
        const int ci = k0 + k;
        const int co = n0 + n;
        const bool ok = ci < C && co < C;
        cp_async16(&w_s[(tap * BK + k) * BN + n],
                   ok ? w + ((size_t)tap * C + ci) * C + co : w, ok);
      }
    } else {
#pragma unroll 1
      for (int e = t; e < 9 * BK * BN; e += NT) {
        const int n = e % BN;
        const int k = (e / BN) % BK;
        const int tap = e / (BN * BK);
        const int ci = k0 + k;
        const int co = n0 + n;
        const bool ok = ci < C && co < C;
        cp_async4(&w_s[e], ok ? w + ((size_t)tap * C + ci) * C + co : w, ok);
      }
    }
  }
}

// After this thread's copies of a stage landed: the affine and ReLU on the
// values it copied, into the float input planes (padding stays zero).
template <typename T>
__device__ __forceinline__ void transform_stage(
    char* stage, const float* __restrict__ in_scale,
    const float* __restrict__ in_bias, int s, int k0, int r0, int c0, int H,
    int W, int C, bool reflect, bool has_affine, bool in_relu, int t) {
  float* in_s = reinterpret_cast<float*>(stage + Stage<T>::W_BYTES);
  if constexpr (Stage<T>::kBf16) {
    const bf16* raw = reinterpret_cast<const bf16*>(
        stage + Stage<T>::W_BYTES + Stage<T>::IN_BYTES);
    for (int e = t; e < IH * IW; e += NT) {
      const InPix q = in_pix(e, r0, c0, H, W, reflect);
      float* dst = in_s + q.dst;
      if (!q.ok) {
#pragma unroll
        for (int k = 0; k < BK; ++k) dst[k * IN_STRIDE] = 0.f;
        continue;
      }
      const uint4 v = *reinterpret_cast<const uint4*>(&raw[e * BK]);
      const unsigned words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float u = (k % 2 == 0) ? bf16_lo(words[k / 2]) : bf16_hi(words[k / 2]);
        if (has_affine) {
          const size_t i = (size_t)s * C + k0 + k;
          u = affine_bf16(u, bf16_round(in_scale[i]), bf16_round(in_bias[i]));
        }
        if (in_relu) u = fmaxf(u, 0.f);
        dst[k * IN_STRIDE] = u;
      }
    }
  } else {
    if (!has_affine && !in_relu) return;
#pragma unroll 1
    for (int e = t; e < BK * IH * IW; e += NT) {
      const InElem q = in_elem(e, k0, r0, c0, H, W, C, reflect);
      if (!q.ok) continue;
      float& v = in_s[q.dst];
      if (has_affine)
        v = v * in_scale[(size_t)s * C + k0 + q.k] +
            in_bias[(size_t)s * C + k0 + q.k];
      if (in_relu) v = fmaxf(v, 0.f);
    }
  }
}

// 8 weights of tap row `wrow` for channel group cg, widened to float
template <typename T>
__device__ __forceinline__ void load_b(const T* wrow, int cg, float (&b)[8]) {
  if constexpr (Stage<T>::kBf16) {
    const uint2 b0 = *reinterpret_cast<const uint2*>(wrow + cg * 4);
    const uint2 b1 = *reinterpret_cast<const uint2*>(wrow + 64 + cg * 4);
    b[0] = bf16_lo(b0.x); b[1] = bf16_hi(b0.x);
    b[2] = bf16_lo(b0.y); b[3] = bf16_hi(b0.y);
    b[4] = bf16_lo(b1.x); b[5] = bf16_hi(b1.x);
    b[6] = bf16_lo(b1.y); b[7] = bf16_hi(b1.y);
  } else {
    const float4 b0 = *reinterpret_cast<const float4*>(wrow + cg * 4);
    const float4 b1 = *reinterpret_cast<const float4*>(wrow + 64 + cg * 4);
    b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
    b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 2)
conv3x3_stats_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const float* __restrict__ in_scale,
                     const float* __restrict__ in_bias,
                     T* __restrict__ y, float* __restrict__ partial,
                     int H, int W, int C, int tiles_w, int n_tiles,
                     bool reflect, bool has_affine, bool in_relu) {
  extern __shared__ __align__(16) char smem[];  // 2 x [w_s | in_s (| raw)]
  const Tile q = tile_of_block(tiles_w);
  const int t = q.t;
  const bool vec_w = C % 4 == 0;
  const T* xs = x + (size_t)q.s * H * W * C;

  float acc[8][8];   // [pixel (2 rows x 4 columns)][channel]
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int n_chunks = (C + BK - 1) / BK;
  load_stage<T>(smem, xs, w, 0, q.r0, q.c0, q.n0, H, W, C, reflect, vec_w, t);
  cp_async_commit();
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    char* stage = smem + (chunk & 1) * Stage<T>::BYTES;
    if (chunk + 1 < n_chunks)
      load_stage<T>(smem + ((chunk + 1) & 1) * Stage<T>::BYTES, xs, w,
                    (chunk + 1) * BK, q.r0, q.c0, q.n0, H, W, C, reflect,
                    vec_w, t);
    cp_async_commit();
    cp_async_wait_prev();
    const int k0 = chunk * BK;
    transform_stage<T>(stage, in_scale, in_bias, q.s, k0, q.r0, q.c0, H, W,
                       C, reflect, has_affine, in_relu, t);
    __syncthreads();

    const T* w_s = reinterpret_cast<const T*>(stage);
    const float* in_s =
        reinterpret_cast<const float*>(stage + Stage<T>::W_BYTES);
#pragma unroll 1
    for (int k = 0; k < BK; ++k) {
      const float* ik = in_s + k * IN_STRIDE + q.pr * IWP + q.pc;
      float win[4][6];   // input rows pr..pr+3, columns pc..pc+5 (halo incl.)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 v = *reinterpret_cast<const float4*>(ik + r * IWP);
        const float2 u = *reinterpret_cast<const float2*>(ik + r * IWP + 4);
        win[r][0] = v.x; win[r][1] = v.y; win[r][2] = v.z; win[r][3] = v.w;
        win[r][4] = u.x; win[r][5] = u.y;
      }
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3;
        const int kx = tap % 3;
        float b[8];
        load_b<T>(&w_s[(tap * BK + k) * BN], q.cg, b);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int n = 0; n < 8; ++n)
              acc[i * 4 + j][n] = fmaf(win[i + ky][j + kx], b[n],
                                       acc[i * 4 + j][n]);
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }

  // epilogue: store y and sum this thread's pixels per channel
  float psum[8], psq[8];
#pragma unroll
  for (int n = 0; n < 8; ++n) { psum[n] = 0.f; psq[n] = 0.f; }
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int gr = q.r0 + q.pr + p / 4;
    const int gc = q.c0 + q.pc + p % 4;
    if (gr < H && gc < W) {
      T* yp = y + (((size_t)q.s * H + gr) * W + gc) * C;
      if constexpr (Stage<T>::kBf16) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          psum[n] += acc[p][n];
          psq[n] += acc[p][n] * acc[p][n];
        }
        // C % 8 == 0: a group of 4 channels is all in range or all out
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          const int co = out_channel(q, 4 * g);
          if (co < C) {
            uint2 pk;
            pk.x = pack_bf16x2(acc[p][4 * g], acc[p][4 * g + 1]);
            pk.y = pack_bf16x2(acc[p][4 * g + 2], acc[p][4 * g + 3]);
            *reinterpret_cast<uint2*>(yp + co) = pk;
          }
        }
      } else {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int co = out_channel(q, n);
          if (co < C) yp[co] = acc[p][n];
          psum[n] += acc[p][n];
          psq[n] += acc[p][n] * acc[p][n];
        }
      }
    }
  }
  // the stages are no longer read
  block_partial_stats(q, psum, psq, reinterpret_cast<float*>(smem), partial,
                      C, n_tiles);
}

template <typename T>
int launch(const T* x, const T* w, const float* in_scale,
           const float* in_bias, T* y, float* partial, float* stats, int S,
           int H, int W, int C, int reflect, int has_affine, int in_relu,
           void* stream) {
  if (Stage<T>::kBf16 && C % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles_w = (W + TW - 1) / TW;
  const int n_tiles = num_tiles(H, W);
  const dim3 grid(n_tiles, (C + BN - 1) / BN, S);
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_stats_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Stage<T>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv3x3_stats_kernel<T><<<grid, NT, Stage<T>::SMEM, st>>>(
      x, w, in_scale, in_bias, y, partial, H, W, C, tiles_w, n_tiles,
      reflect != 0, has_affine != 0, in_relu != 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_stats_reduce(partial, stats, S, n_tiles, C,
                                              st));
}

}  // namespace

extern "C" {

// Number of spatial tiles per sample: the wrapper sizes the partial-sum
// scratch (S, n_tiles, 2, C) with it.
int conv3x3_stats_num_tiles(int H, int W) { return num_tiles(H, W); }

// Launch both kernels on `stream` and return the cudaError_t of the
// launches (0 on success). in_scale/in_bias may be null when has_affine is
// 0. The bf16 entry takes and returns bf16 x, w and y (C % 8 == 0).
int conv3x3_stats_f32(const float* x, const float* w, const float* in_scale,
                      const float* in_bias, float* y, float* partial,
                      float* stats, int S, int H, int W, int C, int reflect,
                      int has_affine, int in_relu, void* stream) {
  return launch<float>(x, w, in_scale, in_bias, y, partial, stats, S, H, W,
                       C, reflect, has_affine, in_relu, stream);
}

int conv3x3_stats_bf16(const void* x, const void* w, const float* in_scale,
                       const float* in_bias, void* y, float* partial,
                       float* stats, int S, int H, int W, int C, int reflect,
                       int has_affine, int in_relu, void* stream) {
  return launch<bf16>(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                      in_scale, in_bias, static_cast<bf16*>(y), partial,
                      stats, S, H, W, C, reflect, has_affine, in_relu, stream);
}

}  // extern "C"
