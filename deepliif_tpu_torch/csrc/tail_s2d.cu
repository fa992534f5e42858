// Fused (affine -> ReLU ->) 3-px pad -> 7x7 conv to Cout = 3 (-> + bias ->
// tanh), bfloat16, for the tail of the inference ResNet translator on Hopper
// (sm_90a).
//
// Replaces the TPU Pallas kernel deepliif_tpu/labs/fused_stages.py
// ::_tail_kernel (driven by tail_s2d_block, pallas_call at :536; wrapper
// tail_s2d_fused :563), which ends the port's fused translator stages once
// per translator. Same contract:
//
//   u = relu(x * in_scale[s] + in_bias[s])    (affine and ReLU optional; in
//                                              bf16: scale and bias rounded
//                                              to bf16, product and sum each
//                                              rounded)
//   u = pad 3: reflect (PyTorch ReflectionPad2d, the edge not repeated) or
//       zero (AFTER the affine: relu(bias) != 0 must not leak into the pad)
//   c = conv7x7(u, w)                         (bf16 x bf16 products, exact in
//                                              f32, f32 sums in one fixed
//                                              order)
//   fused: y = tanh(bf16(bf16(c) + bias))     (c rounded to bf16, the bf16
//                                              bias added and rounded, tanh
//                                              in f32 rounded to bf16)
//   else:  y = bf16(c)                        (the block form, no bias/tanh)
//
// x (S, H, W, Cin) NHWC bf16, Cin % 8 == 0; w (7, 7, Cin, 3) HWIO bf16;
// bias (3,) bf16 or null; y (S, 3, H, W) bf16, the NCHW layout the
// generator returns (the TPU kernel's 8x8 space-to-depth block layout is
// made from it by the wrapper of the block form).
//
// What bounds it: the flagship call ((16, 512, 512, 64) -> 3) moves 562 MB
// (x read once, y written once): 0.168 ms at 3.35 TB/s; its 7.89e10 FLOP
// take 0.080 ms on the bf16 tensor cores but 1.18 ms on the FP32 FFMA pipe.
// Cout = 3 fills no tensor-core tile, so this first version runs on FFMA
// and is bound by its operations there.
//
// Design (simple first; not the TPU's 8x8 space-to-depth matmul, which is
// a lane-utilisation trick for the MXU):
//  * one block per (64 x 64 output pixels, sample), 256 threads; each
//    thread owns 16 consecutive pixels of one output row x 3 channels
//    (48 f32 accumulators). Lanes 0-7 of a warp take 8 consecutive rows,
//    lanes 8-15 the next 16 columns of the same rows, and so on;
//  * the K loop walks input channels 8 at a time. Each stage loads the
//    70 x 70 halo slab of the tile (one 16-byte load per pixel: 8 channels),
//    applies the affine and ReLU, resolves the padding (reflect indices, or
//    zeros), and stores it as bf16 planes (one per channel, row stride 72:
//    the 8 rows a quarter warp reads fall in 8 different bank groups); the
//    8 x 7 x 7 x 3 weights of the stage are widened to float. No cp.async
//    pipeline: two blocks per SM overlap one's loads with the other's math;
//  * per (channel, kernel row) a thread reads its 22-value input row once
//    (three 16-byte loads) and the 21 weights once, then runs 7 x 16 x 3
//    FFMA;
//  * pixels past H or W (a ragged tile) read zeros and are not stored.
//    No atomics: each output is one thread's sum over its own sample, so y
//    is byte-equal run to run and does not depend on the batch.

#include "conv3x3_common.cuh"

namespace {

using conv3x3::bf16_hi;
using conv3x3::bf16_lo;
using conv3x3::bf16_round;
using conv3x3::pack_bf16x2;
using conv3x3::unpack8_affine_relu;
using bf16 = __nv_bfloat16;

constexpr int KS = 7;                 // kernel size
constexpr int PAD = 3;
constexpr int COUT = 3;
constexpr int TH = 64;                // output rows per block
constexpr int TW = 64;                // output columns per block
constexpr int PX = 16;                // output pixels per thread (one row)
constexpr int NT = 256;               // threads: 64 rows x 4 column segments
constexpr int CK = 8;                 // input channels per stage
constexpr int SR = TH + KS - 1;       // staged rows (70)
constexpr int SC = TW + KS - 1;       // staged columns (70)
constexpr int RS = 72;                // row stride of a staged plane (bf16)
constexpr int PLANE = SR * RS;        // bf16 per staged channel
constexpr int WROW = 24;              // floats per (channel, ky): 7 x 3 + pad
constexpr int IN_BYTES = CK * PLANE * 2;        // 80,640
constexpr int SMEM = IN_BYTES + CK * KS * WROW * 4;   // 86,016 bytes
static_assert(RS % 8 == 0 && (RS / 8) % 2 == 1, "row stride");
// the last column segment reads 24 values (three 16-byte loads) of a row
static_assert(TW - PX + 24 <= RS && SC <= RS, "window reads");

// Source index of padded position i along an axis of length n, or -1 where
// the value is zero (the zero pad, and positions past the pad that feed only
// masked outputs of a ragged tile). Reflect needs n > PAD.
__device__ __forceinline__ int src_index(int i, int n, bool reflect) {
  if (i >= 0 && i < n) return i;
  if (reflect && i < 0 && i >= -PAD) return -i;
  if (reflect && i >= n && i < n + PAD) return 2 * (n - 1) - i;
  return -1;
}

__global__ void __launch_bounds__(NT, 2)
tail_s2d_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const bf16* __restrict__ bias,
                const float* __restrict__ in_scale,
                const float* __restrict__ in_bias, bf16* __restrict__ y,
                int H, int W, int Cin, int tiles_w, bool has_affine,
                bool in_relu, bool reflect, bool fused) {
  extern __shared__ __align__(16) char smem[];
  bf16* in_s = reinterpret_cast<bf16*>(smem);
  float* w_s = reinterpret_cast<float*>(smem + IN_BYTES);
  const int t = threadIdx.x;
  const int s = blockIdx.y;
  const int r0 = (blockIdx.x / tiles_w) * TH;
  const int c0 = (blockIdx.x % tiles_w) * TW;
  const int lane = t % 32;
  const int tr = (t / 32) * 8 + lane % 8;    // tile row
  const int pc = (lane / 8) * PX;            // first tile column
  const bf16* xs = x + (size_t)s * H * W * Cin;
  const float* sc = has_affine ? in_scale + (size_t)s * Cin : nullptr;
  const float* bi = has_affine ? in_bias + (size_t)s * Cin : nullptr;

  float acc[PX][COUT];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int co = 0; co < COUT; ++co) acc[p][co] = 0.f;

#pragma unroll 1
  for (int k0 = 0; k0 < Cin; k0 += CK) {
    for (int e = t; e < SR * SC; e += NT) {
      const int row = e / SC;
      const int col = e % SC;
      const int gr = src_index(r0 - PAD + row, H, reflect);
      const int gc = src_index(c0 - PAD + col, W, reflect);
      float u[CK];
      if (gr >= 0 && gc >= 0) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            xs + ((size_t)gr * W + gc) * Cin + k0);
        unpack8_affine_relu(v, sc, bi, k0, has_affine, in_relu, u);
      } else {
#pragma unroll
        for (int k = 0; k < CK; ++k) u[k] = 0.f;
      }
      bf16* dst = in_s + row * RS + col;
#pragma unroll
      for (int k = 0; k < CK; ++k) dst[k * PLANE] = __float2bfloat16(u[k]);
    }
    // w[ky][kx][k0 + k][co] -> w_s[(k * 7 + ky) * WROW + kx * 3 + co]; the
    // 24 values of one tap are contiguous in w
    for (int e = t; e < KS * KS * CK * COUT; e += NT) {
      const int tap = e / (CK * COUT);
      const int k = (e / COUT) % CK;
      const int co = e % COUT;
      w_s[(k * KS + tap / KS) * WROW + (tap % KS) * COUT + co] =
          __bfloat162float(w[((size_t)tap * Cin + k0 + k) * COUT + co]);
    }
    __syncthreads();

#pragma unroll 1
    for (int k = 0; k < CK; ++k) {
      const bf16* ip = in_s + k * PLANE + tr * RS + pc;
      const float* wp = w_s + k * KS * WROW;
#pragma unroll 1
      for (int ky = 0; ky < KS; ++ky) {
        const uint4* rp = reinterpret_cast<const uint4*>(ip + ky * RS);
        const uint4 a0 = rp[0], a1 = rp[1], a2 = rp[2];
        const unsigned words[12] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y,
                                    a1.z, a1.w, a2.x, a2.y, a2.z, a2.w};
        float win[PX + KS - 1];
#pragma unroll
        for (int j = 0; j < PX + KS - 1; ++j)
          win[j] = (j % 2 == 0) ? bf16_lo(words[j / 2]) : bf16_hi(words[j / 2]);
        const float4* wq = reinterpret_cast<const float4*>(wp + ky * WROW);
        float wk[WROW];
#pragma unroll
        for (int j = 0; j < WROW / 4; ++j) {
          const float4 q = wq[j];
          wk[4 * j] = q.x; wk[4 * j + 1] = q.y;
          wk[4 * j + 2] = q.z; wk[4 * j + 3] = q.w;
        }
#pragma unroll
        for (int kx = 0; kx < KS; ++kx)
#pragma unroll
          for (int p = 0; p < PX; ++p)
#pragma unroll
            for (int co = 0; co < COUT; ++co)
              acc[p][co] = fmaf(win[p + kx], wk[kx * COUT + co], acc[p][co]);
      }
    }
    __syncthreads();  // the next stage overwrites the slab and the weights
  }

  const int gr = r0 + tr;
  const int gc = c0 + pc;
  if (gr >= H) return;
#pragma unroll
  for (int co = 0; co < COUT; ++co) {
    float v[PX];
    const float b = (fused && bias) ? __bfloat162float(bias[co]) : 0.f;
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      v[p] = acc[p][co];
      if (fused) {
        v[p] = bf16_round(v[p]);
        if (bias) v[p] = bf16_round(v[p] + b);
        v[p] = tanhf(v[p]);
      }
    }
    bf16* yp = y + (((size_t)s * COUT + co) * H + gr) * W + gc;
    if (W % 8 == 0 && gc + PX <= W) {
      uint4* yq = reinterpret_cast<uint4*>(yp);
#pragma unroll
      for (int j = 0; j < PX / 8; ++j)
        yq[j] = make_uint4(pack_bf16x2(v[8 * j], v[8 * j + 1]),
                           pack_bf16x2(v[8 * j + 2], v[8 * j + 3]),
                           pack_bf16x2(v[8 * j + 4], v[8 * j + 5]),
                           pack_bf16x2(v[8 * j + 6], v[8 * j + 7]));
    } else {
#pragma unroll
      for (int p = 0; p < PX; ++p)
        if (gc + p < W) yp[p] = __float2bfloat16(v[p]);
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 on success).
// in_scale/in_bias may be null when has_affine is 0, bias may be null; fused
// 0 writes the rounded conv (no bias, no tanh).
int tail_s2d_bf16(const void* x, const void* w, const void* bias,
                  const float* in_scale, const float* in_bias, void* y, int S,
                  int H, int W, int Cin, int Cout, int has_affine, int in_relu,
                  int reflect, int fused, void* stream) {
  if (Cin % 8 || Cout != COUT || (reflect && (H <= PAD || W <= PAD)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      tail_s2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_w = (W + TW - 1) / TW;
  const dim3 grid(tiles_w * ((H + TH - 1) / TH), S);
  tail_s2d_kernel<<<grid, NT, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(bias), in_scale, in_bias, static_cast<bf16*>(y),
      H, W, Cin, tiles_w, has_affine != 0, in_relu != 0, reflect != 0,
      fused != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
