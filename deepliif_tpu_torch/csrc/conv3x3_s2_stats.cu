// Fused (affine -> ReLU ->) 3x3 stride-2 zero-pad-1 conv + per-(sample,
// channel) output statistics, bfloat16, for the down stages of the
// inference ResNet translator on Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel deepliif_tpu/labs/fused_stages.py
// ::_down_kernel (driven by conv3x3_s2_stats, pallas_call at :175), which the
// fused translator stages (deepliif_tpu/nets/resnet.py _apply_fused) run
// twice per translator. Same contract:
//
//   u     = relu(x * in_scale[s] + in_bias[s])    (affine and ReLU optional;
//                                                  in bf16: scale and bias
//                                                  rounded to bf16, product
//                                                  and sum each rounded)
//   u     = zero pad 1 (applied AFTER the affine, so it never leaks into
//           the pad)
//   y     = conv(u, w, stride 2)                  (bf16 x bf16 products,
//                                                  exact in f32, f32 sums)
//   stats = (sum_hw y, sum_hw y^2) per (sample, channel) from the f32
//           accumulator, not from the rounded y
//
// x (S, H, W, Cin) NHWC bf16, H and W even; w (3, 3, Cin, Cout) HWIO bf16;
// y (S, H/2, W/2, Cout) bf16; Cin % 8 == 0 and Cout % 8 == 0.
//
// What bounds it: the flagship calls (down0: (16, 512, 512, 64) -> 128,
// down1: (16, 256, 256, 128) -> 256) are 154.6 GFLOP each against 0.8 and
// 0.4 GB of traffic: on the bf16 tensor cores (989 TFLOP/s) down0 would be
// bound by its bytes and down1 by its operations. This first version runs
// on the FFMA pipe (67 TFLOP/s), so it is compute-bound; wgmma is later
// work.
//
// Design (simple first):
//  * the output tiling of conv3x3_common.cuh: one block per (8 x 16 output
//    pixels, 128 output channels, sample), 256 threads of 2 x 4 pixels x 8
//    channels each;
//  * the K loop walks input channels 8 at a time. Each stage loads the
//    17 x 33 input window of the tile (stride 2 plus the 1-pixel pad, one
//    16-byte load per pixel) into float planes in shared memory, applying
//    the affine and ReLU, with zeros where the pad or the image edge is;
//    and the 9 x 8 x 128 bf16 weight slice. No cp.async pipeline: the
//    loads of the next stage do not overlap this one's math;
//  * for each input channel and tap row, a thread reads its two 9-float
//    input rows once and uses them for the 3 column taps;
//  * statistics as in conv3x3_common.cuh: per-tile partial sums in a fixed
//    order, then a second kernel sums the tiles in tile order. No float
//    atomics, so y and the stats are bitwise reproducible and do not depend
//    on the batch a sample rides in.

#include "conv3x3_common.cuh"

namespace {

using namespace conv3x3;
using bf16 = __nv_bfloat16;

constexpr int BK = 8;                 // input channels per stage
constexpr int SH = 2 * TH + 1;        // staged input rows (17)
constexpr int SW = 2 * TW + 1;        // staged input columns (33)
constexpr int SWP = 36;               // row stride of a staged plane (floats)
constexpr int PLANE = SH * SWP;       // floats per staged channel
constexpr int IN_BYTES = BK * PLANE * 4;
constexpr int W_ELEMS = 9 * BK * BN;  // bf16 weights per stage
constexpr int SMEM = IN_BYTES + W_ELEMS * 2;   // 38,016 bytes

__global__ void __launch_bounds__(NT, 2)
conv3x3_s2_stats_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                        const float* __restrict__ in_scale,
                        const float* __restrict__ in_bias,
                        bf16* __restrict__ y, float* __restrict__ partial,
                        int H, int W, int Cin, int Cout, int tiles_w,
                        int n_tiles, bool has_affine, bool in_relu) {
  extern __shared__ __align__(16) char smem[];
  float* in_s = reinterpret_cast<float*>(smem);
  bf16* w_s = reinterpret_cast<bf16*>(smem + IN_BYTES);
  const Tile q = tile_of_block(tiles_w);
  const int t = q.t;
  const int Ho = H / 2, Wo = W / 2;
  const bf16* xs = x + (size_t)q.s * H * W * Cin;
  const float* sc = has_affine ? in_scale + (size_t)q.s * Cin : nullptr;
  const float* bi = has_affine ? in_bias + (size_t)q.s * Cin : nullptr;
  // input row / column of staged element (0, 0): the pad row / column
  // above / left of output (r0, c0)
  const int ir0 = 2 * q.r0 - 1;
  const int ic0 = 2 * q.c0 - 1;

  float acc[8][8];   // [pixel (2 rows x 4 columns)][channel]
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll 1
  for (int k0 = 0; k0 < Cin; k0 += BK) {
    for (int e = t; e < SH * SW; e += NT) {
      const int row = e / SW;
      const int col = e % SW;
      const int gr = ir0 + row;
      const int gc = ic0 + col;
      float* dst = in_s + row * SWP + col;
      float u[8];
      if (gr >= 0 && gr < H && gc >= 0 && gc < W) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            xs + ((size_t)gr * W + gc) * Cin + k0);
        unpack8_affine_relu(v, sc, bi, k0, has_affine, in_relu, u);
      } else {
#pragma unroll
        for (int k = 0; k < BK; ++k) u[k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < BK; ++k) dst[k * PLANE] = u[k];
    }
    for (int e = t; e < W_ELEMS / 8; e += NT) {   // 8 output channels
      const int n = (e % (BN / 8)) * 8;
      const int k = (e / (BN / 8)) % BK;
      const int tap = e / (BN / 8 * BK);
      const int co = q.n0 + n;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (co < Cout)
        v = *reinterpret_cast<const uint4*>(
            w + ((size_t)tap * Cin + k0 + k) * Cout + co);
      *reinterpret_cast<uint4*>(&w_s[(tap * BK + k) * BN + n]) = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int k = 0; k < BK; ++k) {
      // output (pr + i, pc + j) taps staged rows 2 (pr + i) + ky and
      // columns 2 (pc + j) + kx
      const float* ik = in_s + k * PLANE + 2 * q.pr * SWP + 2 * q.pc;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        float win[2][9];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float* rp = ik + (2 * i + ky) * SWP;
          const float4 a = *reinterpret_cast<const float4*>(rp);
          const float4 b = *reinterpret_cast<const float4*>(rp + 4);
          win[i][0] = a.x; win[i][1] = a.y; win[i][2] = a.z; win[i][3] = a.w;
          win[i][4] = b.x; win[i][5] = b.y; win[i][6] = b.z; win[i][7] = b.w;
          win[i][8] = rp[8];
        }
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          float b[8];
          load_w8_bf16(&w_s[((ky * 3 + kx) * BK + k) * BN], q.cg, b);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int n = 0; n < 8; ++n)
                acc[i * 4 + j][n] = fmaf(win[i][2 * j + kx], b[n],
                                         acc[i * 4 + j][n]);
        }
      }
    }
    __syncthreads();  // the next stage overwrites the planes and weights
  }

  // epilogue: store y (bf16) and sum this thread's pixels per channel from
  // the f32 accumulator
  float psum[8], psq[8];
#pragma unroll
  for (int n = 0; n < 8; ++n) { psum[n] = 0.f; psq[n] = 0.f; }
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int gr = q.r0 + q.pr + p / 4;
    const int gc = q.c0 + q.pc + p % 4;
    if (gr < Ho && gc < Wo) {
      bf16* yp = y + (((size_t)q.s * Ho + gr) * Wo + gc) * Cout;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        psum[n] += acc[p][n];
        psq[n] += acc[p][n] * acc[p][n];
      }
      // Cout % 8 == 0: a group of 4 channels is all in range or all out
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int co = out_channel(q, 4 * g);
        if (co < Cout) {
          uint2 pk;
          pk.x = pack_bf16x2(acc[p][4 * g], acc[p][4 * g + 1]);
          pk.y = pack_bf16x2(acc[p][4 * g + 2], acc[p][4 * g + 3]);
          *reinterpret_cast<uint2*>(yp + co) = pk;
        }
      }
    }
  }
  block_partial_stats(q, psum, psq, reinterpret_cast<float*>(smem), partial,
                      Cout, n_tiles);
}

}  // namespace

extern "C" {

// Number of output tiles per sample for an H x W input: the wrapper sizes
// the partial-sum scratch (S, n_tiles, 2, Cout) with it.
int conv3x3_s2_stats_num_tiles(int H, int W) {
  return num_tiles(H / 2, W / 2);
}

// Launch both kernels on `stream`; returns the cudaError_t of the launches
// (0 on success). in_scale/in_bias may be null when has_affine is 0.
int conv3x3_s2_stats_bf16(const void* x, const void* w, const float* in_scale,
                          const float* in_bias, void* y, float* partial,
                          float* stats, int S, int H, int W, int Cin,
                          int Cout, int has_affine, int in_relu,
                          void* stream) {
  if (H % 2 || W % 2 || Cin % 8 || Cout % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles_w = (W / 2 + TW - 1) / TW;
  const int n_tiles = num_tiles(H / 2, W / 2);
  const dim3 grid(n_tiles, (Cout + BN - 1) / BN, S);
  conv3x3_s2_stats_kernel<<<grid, NT, SMEM, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), in_scale,
      in_bias, static_cast<bf16*>(y), partial, H, W, Cin, Cout, tiles_w,
      n_tiles, has_affine != 0, in_relu != 0);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_stats_reduce(partial, stats, S, n_tiles,
                                              Cout, st));
}

}  // extern "C"
