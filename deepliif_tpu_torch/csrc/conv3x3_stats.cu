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
// float32 (x, w, y f32): the affine in f32 (the product and the sum each
// rounded), y the f32 sum.
//
// Layout: x and y are NHWC (S, H, W, C) contiguous, so a channels_last NCHW
// tensor enters with no transpose; w is HWIO (3, 3, C, C) contiguous; C % 8
// == 0 and x, w, scale, bias 16-byte aligned; scale/bias are (S, C).
//
// What bounds it: at the flagship shape (128 x 128 x 256 per tile) one conv
// is 2 * 128*128 * 256*256 * 9 = 19.3 GFLOP per tile against 33.6 MB (f32)
// or 16.8 MB (bf16) of activation traffic in and out: compute-bound, on the
// bf16 tensor cores (989 TFLOP/s) in bfloat16 and, in float32, on the TF32
// tensor cores (495 TFLOP/s) three times over (below).
//
// Both run the implicit-GEMM wgmma mainloop of conv3x3_wgmma.cuh at stride
// 1 (CONV_S1): 16 x 16 output pixels per item, an 18 x 18 input slab of 32
// bytes of channels per stage loaded by the TMA engine (zeros outside x;
// reflect padding copies the halo pixels from their sources in the slab,
// and the producer transforms them like any other pixel), per-tile partial
// statistics in a fixed order, summed in tile order.
//
// bfloat16: 128 output channels per item, 16 input channels per stage, a
// 4-slot ring (a stage is 47 KB) that the producer fills 3 stages ahead. It
// rounds y once from an f32 sum of the same exact products as the plain
// version, in another order: within one bf16 ulp of it.
//
// float32, split TF32: u = u_hi + u_lo and w = w_hi + w_lo, hi = tf32(v)
// and lo = tf32(v - hi) (cvt.rna: round to nearest, ties away; raw f32
// bits given to the tensor cores would be truncated, and lo would not be
// the remainder), and each k8 step issues u_hi w_hi, u_hi w_lo and u_lo
// w_hi (u_lo w_lo, about 2^-22 of the product, is dropped). Every product
// of two tf32 values is exact in f32, so this is an f32 conv up to the
// dropped term and the order of the sums: within a few f32 ulps of the
// plain version (measured on the CPU against float64: as accurate as the
// cuDNN-order f32 conv; 1x TF32, hi w_hi alone, misses the 1e-4 tolerance
// by 14x). What was in the way and what the design does:
//  * tf32 operands must be K-major (transposed operands exist only for
//    16-bit types): the weights are packed once per call as K-major core
//    matrices (column = output channel, its 8 input channels contiguous),
//    two planes per tap (w_hi, w_lo, split at pack time); the NHWC slab is
//    K-major as A already, and 8 f32 channels are 32 bytes, so the slab
//    layout and the ldmatrix.x4 A loads of the bf16 path serve unchanged
//    (each lane's 32-bit word is one f32);
//  * the activations are split in the consumers' registers after the
//    producer's f32 affine, once per A fragment for the three products;
//  * shared memory: a stage of 8 input channels at 128 output channels
//    would hold 9 x 8 x 128 x 4 B x 2 planes = 73.7 KB of weights (2 slots);
//    at 64 output channels per item it is 36.9 KB + a 10.4 KB slab = 47 KB,
//    so the ring keeps 4 slots, and a consumer warpgroup's registers hold
//    both m64 tiles' accumulators (64), the unit temporary (32) and the 9
//    taps' hi and lo fragments (72) without a wait inside the unit;
//  * accumulation: the tensor cores' own accumulation drifts over long
//    chains (PERF.md, PR 6), so each m64 tile sums a stage (27 wgmmas, hi w_hi
//    first, the two small products into the same temporary) into a fresh
//    temporary that is added to the f32 accumulator with FFMA.

#include "conv3x3_common.cuh"
#include "conv3x3_wgmma.cuh"

namespace {

using namespace conv3x3_wgmma;

// the bfloat16 trunk
using GBf16 = Geom<CONV_S1, 128, 4>;
// the float32 trunk, split TF32
using GF32 = Geom<CONV_S1, 64, 4, OP_TF32>;

}  // namespace

extern "C" {

// Number of spatial tiles per sample of both kernels: the wrapper sizes the
// partial-sum scratch (S, n_tiles, 2, C) with it.
int conv3x3_stats_num_tiles(int H, int W) {
  return conv3x3_wgmma::num_tiles(H, W);
}

// The bytes of the packed-weight workspace each kernel takes.
long conv3x3_stats_bf16_wpack_bytes(int C) {
  return conv3x3_wgmma::wpack_bytes<GBf16>(C, C);
}

long conv3x3_stats_f32_wpack_bytes(int C) {
  return conv3x3_wgmma::wpack_bytes<GF32>(C, C);
}

// Launch the kernels (weight pack, conv, stats reduction) on `stream` and
// return the cudaError_t of the launches (0 on success; 1000 + a CUresult if
// x's TMA tensor map was refused). x, w and y are float32 (f32) or bfloat16
// (bf16); wpack is a 16-byte aligned workspace of the *_wpack_bytes(C)
// bytes; in_scale/in_bias may be null when has_affine is 0.
int conv3x3_stats_f32(const void* x, const void* w, void* wpack,
                      const float* in_scale, const float* in_bias, void* y,
                      float* partial, float* stats, int S, int H, int W,
                      int C, int reflect, int has_affine, int in_relu,
                      void* stream) {
  return launch<GF32>(x, static_cast<const float*>(w), wpack, in_scale,
                      in_bias, static_cast<float*>(y), partial, stats, S, H,
                      W, C, C, reflect != 0, has_affine != 0, in_relu != 0,
                      static_cast<cudaStream_t>(stream));
}

int conv3x3_stats_bf16(const void* x, const void* w, void* wpack,
                       const float* in_scale, const float* in_bias, void* y,
                       float* partial, float* stats, int S, int H, int W,
                       int C, int reflect, int has_affine, int in_relu,
                       void* stream) {
  return launch<GBf16>(x, static_cast<const bf16*>(w), wpack, in_scale,
                       in_bias, static_cast<bf16*>(y), partial, stats, S, H,
                       W, C, C, reflect != 0, has_affine != 0, in_relu != 0,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
