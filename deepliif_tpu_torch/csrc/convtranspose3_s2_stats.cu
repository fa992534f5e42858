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
// so the four output phases (a, b) are stride-1 convs of 1, 2, 2 and 4 taps
// over the input, with a halo of one row and one column at the bottom and
// right. The input is relu(x * in_scale[s] + in_bias[s]) in bf16 as in
// conv3x3_s2_stats.cu (affine and ReLU optional; the up0 stage has
// neither), and the zero row / column past the bottom / right edge is
// applied after the affine. bf16 x bf16 products are exact in f32 and sum
// in f32; y is rounded to bf16; the stats come from the f32 accumulator.
// (The TPU kernel sums its stats per column phase and adds the two halves
// at the end; here per (tile, phase) partials are summed in that order, so
// the two agree to f32 rounding, not bit for bit.)
//
// x (S, H, W, Cin) NHWC bf16; w (3, 3, Cin, Cout) HWIO bf16; y (S, 2H, 2W,
// Cout) bf16; Cin % 8 == 0 and Cout % 8 == 0.
//
// What bounds it: the flagship calls (up0: (16, 128, 128, 256) -> 128, up1:
// (16, 256, 256, 128) -> 64) are 154.6 GFLOP each against 0.4 and 0.8 GB
// of traffic: on the bf16 tensor cores up0 is bound by its operations
// (0.156 ms) and up1 by its bytes (0.240 ms).
//
// Design: the implicit-GEMM wgmma mainloop of conv3x3_wgmma.cuh (CONVT):
// a work item is a 16 x 16 input tile x one output phase x 64 output
// channels (an n64 instantiation: up1's Cout is 64, and up0's 128 runs as
// two channel blocks), so that each m64 tile of a consumer warpgroup keeps
// a temporary of its own and runs a unit of up to 8 k16 steps over several
// stages before it is folded into its accumulator; the persistent CTAs walk
// items whose phase order rotates with the tile, absorbing the phases'
// uneven tap counts. Each stage loads 16 input channels of the 17 x 17
// input slab (TMA) and the phase's taps of the packed weights (one bulk
// copy); the consumers apply the input's affine and ReLU to their A
// fragments, so the producer does not transform a tile's slab once per
// phase. A stage is small (18 KB), so the ring has 8 slots, 7 loading
// ahead. y is stored interleaved into NHWC at (2m + a, 2n + b);
// per-(tile, phase) partial statistics in a fixed order are summed in that
// order by a second kernel. No float atomics, so y and the stats are
// bitwise reproducible and do not depend on the batch a sample rides in.

#include "conv3x3_common.cuh"
#include "conv3x3_wgmma.cuh"

namespace {
using G = conv3x3_wgmma::Geom<conv3x3_wgmma::CONVT, 64, 8>;
}

extern "C" {

// Number of (tile, phase) partial-statistics rows per sample for an H x W
// input: the wrapper sizes the partial-sum scratch (S, rows, 2, Cout) with
// it.
int convtranspose3_s2_stats_num_tiles(int H, int W) {
  return conv3x3_wgmma::num_tiles(H, W) * G::NPH;
}

// Bytes of the packed-weight workspace that convtranspose3_s2_stats_bf16
// takes.
long convtranspose3_s2_stats_wpack_bytes(int Cin, int Cout) {
  return conv3x3_wgmma::wpack_bytes<G>(Cin, Cout);
}

// Launch the kernels on `stream`; returns the cudaError_t of the launches
// (0 on success). in_scale/in_bias may be null when has_affine is 0; wpack
// is a 16-byte aligned workspace of convtranspose3_s2_stats_wpack_bytes
// bytes.
int convtranspose3_s2_stats_bf16(const void* x, const void* w, void* wpack,
                                 const float* in_scale, const float* in_bias,
                                 void* y, float* partial, float* stats, int S,
                                 int H, int W, int Cin, int Cout,
                                 int has_affine, int in_relu, void* stream) {
  using bf16 = __nv_bfloat16;
  return conv3x3_wgmma::launch<G>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), wpack,
      in_scale, in_bias, static_cast<bf16*>(y), partial, stats, S, H, W, Cin,
      Cout, false, has_affine != 0, in_relu != 0,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
