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
// 0.4 GB of traffic: on the bf16 tensor cores (989 TFLOP/s) down0 is bound
// by its bytes and down1 by its operations.
//
// Design: the implicit-GEMM wgmma mainloop of conv3x3_wgmma.cuh at stride
// 2 (CONV_S2): 16 x 16 output pixels x 128 output channels per block, the
// input slab of 33 x 33 pixels of 16 channels per stage loaded by the TMA
// engine as 4 phase planes (rows and columns of one parity each) so that a
// tap reads adjacent pixels of one plane, a 2-slot ring (a stage is 73 KB);
// per-tile partial statistics in a fixed order, summed in tile order by a
// second kernel. No float atomics, so y and the stats are bitwise
// reproducible and do not depend on the batch a sample rides in.

#include "conv3x3_common.cuh"
#include "conv3x3_wgmma.cuh"

namespace {
using G = conv3x3_wgmma::Geom<conv3x3_wgmma::CONV_S2, 128, 2>;
}

extern "C" {

// Number of output tiles per sample for an H x W input: the wrapper sizes
// the partial-sum scratch (S, n_tiles, 2, Cout) with it.
int conv3x3_s2_stats_num_tiles(int H, int W) {
  return conv3x3_wgmma::num_tiles(H / 2, W / 2);
}

// Bytes of the packed-weight workspace that conv3x3_s2_stats_bf16 takes.
long conv3x3_s2_stats_wpack_bytes(int Cin, int Cout) {
  return conv3x3_wgmma::wpack_bytes<G>(Cin, Cout);
}

// Launch the kernels on `stream`; returns the cudaError_t of the launches
// (0 on success). in_scale/in_bias may be null when has_affine is 0; wpack
// is a 16-byte aligned workspace of conv3x3_s2_stats_wpack_bytes bytes.
int conv3x3_s2_stats_bf16(const void* x, const void* w, void* wpack,
                          const float* in_scale, const float* in_bias,
                          void* y, float* partial, float* stats, int S, int H,
                          int W, int Cin, int Cout, int has_affine,
                          int in_relu, void* stream) {
  using bf16 = __nv_bfloat16;
  return conv3x3_wgmma::launch<G>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), wpack,
      in_scale, in_bias, static_cast<bf16*>(y), partial, stats, S, H, W, Cin,
      Cout, false, has_affine != 0, in_relu != 0,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
