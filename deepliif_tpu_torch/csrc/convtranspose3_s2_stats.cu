// Fused (affine -> ReLU ->) ConvTranspose2d(3, stride 2, padding 1,
// output_padding 1) + per-(sample, channel) output statistics, bfloat16,
// for the up stages of the inference ResNet translator on Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel deepliif_tpu/labs/fused_stages.py
// ::_up_kernel (driven by convtranspose3_s2_stats, pallas_call at :320),
// which the fused translator stages (deepliif_tpu/nets/resnet.py
// _apply_fused) run twice per translator. Same contract, in the phase form
// of the TPU kernel: with w in the forward-conv HWIO layout (the torch
// IOHW kernel spatially flipped), per axis
//
//   out[2m]     = w[1] x[m]
//   out[2m + 1] = w[0] x[m] + w[2] x[m + 1]        (x[H] = 0)
//
// so an output 2 x 2 block takes 9 taps of input rows m, m + 1 and columns
// q, q + 1. The input is relu(x * in_scale[s] + in_bias[s]) in bf16 as in
// conv3x3_s2_stats.cu (affine and ReLU optional; the up0 stage has
// neither), and the zero row / column past the bottom / right edge is
// applied after the affine. bf16 x bf16 products are exact in f32 and sum
// in f32; y is rounded to bf16; the stats come from the f32 accumulator.
// (The TPU kernel sums its stats per column phase and adds the two halves
// at the end; here each channel is one sum, so the two agree to f32
// rounding, not bit for bit.)
//
// x (S, H, W, Cin) NHWC bf16; w (3, 3, Cin, Cout) HWIO bf16; y (S, 2H, 2W,
// Cout) bf16; Cin % 8 == 0 and Cout % 8 == 0.
//
// What bounds it: the flagship calls (up0: (16, 128, 128, 256) -> 128, up1:
// (16, 256, 256, 128) -> 64) are 154.6 GFLOP each against 0.4 and 0.8 GB
// of traffic; this first version runs on the FFMA pipe (67 TFLOP/s), so it
// is compute-bound. up1 has 64 output channels: half of each block's
// 128-channel tile is masked. wgmma and a 64-wide tile are later work.
//
// Design (simple first): the output tiling of conv3x3_common.cuh (8 x 16
// output pixels x 128 channels per block; a thread's 2 x 4 pixels are one
// row pair 2m, 2m + 1 and two column pairs); the K loop stages 16 input
// channels of the tile's 5 x 9 input window (4 x 8 pixels plus the halo
// row and column) as float planes, with the 9 x 16 x 128 weight slice;
// each thread reads its 2 x 3 input window per channel once and runs the 9
// taps from it. Statistics as in conv3x3_common.cuh: fixed order, no float
// atomics.

#include "conv3x3_common.cuh"

namespace {

using namespace conv3x3;
using bf16 = __nv_bfloat16;

constexpr int BK = 16;                // input channels per stage
constexpr int SH = TH / 2 + 1;        // staged input rows (5)
constexpr int SW = TW / 2 + 1;        // staged input columns (9)
constexpr int SWP = 12;               // row stride of a staged plane (floats)
constexpr int PLANE = SH * SWP;       // floats per staged channel
constexpr int IN_BYTES = BK * PLANE * 4;
constexpr int W_ELEMS = 9 * BK * BN;  // bf16 weights per stage
constexpr int SMEM = IN_BYTES + W_ELEMS * 2;   // 40,704 bytes

__global__ void __launch_bounds__(NT, 2)
convtranspose3_s2_stats_kernel(const bf16* __restrict__ x,
                               const bf16* __restrict__ w,
                               const float* __restrict__ in_scale,
                               const float* __restrict__ in_bias,
                               bf16* __restrict__ y,
                               float* __restrict__ partial, int H, int W,
                               int Cin, int Cout, int tiles_w, int n_tiles,
                               bool has_affine, bool in_relu) {
  extern __shared__ __align__(16) char smem[];
  float* in_s = reinterpret_cast<float*>(smem);
  bf16* w_s = reinterpret_cast<bf16*>(smem + IN_BYTES);
  const Tile q = tile_of_block(tiles_w);
  const int t = q.t;
  const int Ho = 2 * H, Wo = 2 * W;
  const bf16* xs = x + (size_t)q.s * H * W * Cin;
  const float* sc = has_affine ? in_scale + (size_t)q.s * Cin : nullptr;
  const float* bi = has_affine ? in_bias + (size_t)q.s * Cin : nullptr;
  const int ir0 = q.r0 / 2;           // input row / column of staged (0, 0)
  const int ic0 = q.c0 / 2;

  float acc[8][8];   // [pixel (rows 2m, 2m+1 x columns 2q .. 2q+3)][channel]
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll 1
  for (int k0 = 0; k0 < Cin; k0 += BK) {
    // one 16-byte load (8 channels of one pixel) per element
    for (int e = t; e < SH * SW * (BK / 8); e += NT) {
      const int half = e % (BK / 8);
      const int pix = e / (BK / 8);
      const int row = pix / SW;
      const int col = pix % SW;
      const int gr = ir0 + row;
      const int gc = ic0 + col;
      const int kc = k0 + half * 8;
      float* dst = in_s + half * 8 * PLANE + row * SWP + col;
      float u[8];
      if (gr < H && gc < W && kc < Cin) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            xs + ((size_t)gr * W + gc) * Cin + kc);
        unpack8_affine_relu(v, sc, bi, kc, has_affine, in_relu, u);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) u[k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) dst[k * PLANE] = u[k];
    }
    for (int e = t; e < W_ELEMS / 8; e += NT) {   // 8 output channels
      const int n = (e % (BN / 8)) * 8;
      const int k = (e / (BN / 8)) % BK;
      const int tap = e / (BN / 8 * BK);
      const int co = q.n0 + n;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (co < Cout && k0 + k < Cin)
        v = *reinterpret_cast<const uint4*>(
            w + ((size_t)tap * Cin + k0 + k) * Cout + co);
      *reinterpret_cast<uint4*>(&w_s[(tap * BK + k) * BN + n]) = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int k = 0; k < BK; ++k) {
      // input rows m, m + 1 and columns q .. q + 2 of this thread's outputs
      const float* ik = in_s + k * PLANE + (q.pr / 2) * SWP + q.pc / 2;
      float win[2][3];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const float2 v = *reinterpret_cast<const float2*>(ik + a * SWP);
        win[a][0] = v.x;
        win[a][1] = v.y;
        win[a][2] = ik[a * SWP + 2];
      }
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        // row phase: ky 1 -> out row 2m from x[m]; ky 0 -> 2m + 1 from
        // x[m]; ky 2 -> 2m + 1 from x[m + 1]
        const int i = ky == 1 ? 0 : 1;
        const int a = ky == 2 ? 1 : 0;
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          // column phase, the same rule: kx 1 -> even columns 2q' from
          // x[q']; kx 0 -> odd 2q' + 1 from x[q']; kx 2 -> odd from
          // x[q' + 1]; q' = q, q + 1
          const int j0 = kx == 1 ? 0 : 1;
          const int bo = kx == 2 ? 1 : 0;
          float b[8];
          load_w8_bf16(&w_s[((ky * 3 + kx) * BK + k) * BN], q.cg, b);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
#pragma unroll
            for (int n = 0; n < 8; ++n)
              acc[i * 4 + j0 + 2 * jj][n] =
                  fmaf(win[a][jj + bo], b[n], acc[i * 4 + j0 + 2 * jj][n]);
        }
      }
    }
    __syncthreads();  // the next stage overwrites the planes and weights
  }

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

// Number of output tiles per sample for an H x W input (a 2H x 2W output).
int convtranspose3_s2_stats_num_tiles(int H, int W) {
  return num_tiles(2 * H, 2 * W);
}

// Launch both kernels on `stream`; returns the cudaError_t of the launches
// (0 on success). in_scale/in_bias may be null when has_affine is 0.
int convtranspose3_s2_stats_bf16(const void* x, const void* w,
                                 const float* in_scale, const float* in_bias,
                                 void* y, float* partial, float* stats, int S,
                                 int H, int W, int Cin, int Cout,
                                 int has_affine, int in_relu, void* stream) {
  if (Cin % 8 || Cout % 8) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles_w = (2 * W + TW - 1) / TW;
  const int n_tiles = num_tiles(2 * H, 2 * W);
  const dim3 grid(n_tiles, (Cout + BN - 1) / BN, S);
  convtranspose3_s2_stats_kernel<<<grid, NT, SMEM, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), in_scale,
      in_bias, static_cast<bf16*>(y), partial, H, W, Cin, Cout, tiles_w,
      n_tiles, has_affine != 0, in_relu != 0);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_stats_reduce(partial, stats, S, n_tiles,
                                              Cout, st));
}

}  // extern "C"
