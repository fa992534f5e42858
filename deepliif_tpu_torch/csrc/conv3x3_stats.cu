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
// or 16.8 MB (bf16) of activation traffic in and out: compute-bound, on the
// FFMA pipe in float32 (67 TFLOP/s published for the H100 SXM at 700 W), on
// the bf16 tensor cores (989 TFLOP/s) in bfloat16.
//
// bfloat16: the implicit-GEMM wgmma mainloop of conv3x3_wgmma.cuh at stride
// 1 (CONV_S1): 16 x 16 output pixels x 128 output channels per item, an 18
// x 18 input slab of 16 channels per stage loaded by the TMA engine (zeros
// outside x; reflect padding copies the halo pixels from their sources in
// the slab, and the producer transforms them like any other pixel), a
// 4-slot ring (a stage is 47 KB) that the producer fills 3 stages ahead;
// per-tile partial statistics in a fixed order, summed in tile order. It
// rounds y once from an f32 sum of the same exact products as the plain
// version, in another order: within one bf16 ulp of it.
//
// float32, design (simple first):
//  * tiling and thread layout as in conv3x3_common.cuh; a thread reads its
//    4 x 6 float input window per input channel from shared memory once
//    (float4 + float2 per row) and reuses it for all 9 taps;
//  * the K loop walks input channels BK at a time through two shared-memory
//    stages: while the block runs the 9 * BK rank-1 updates of one stage,
//    cp.async copies the next (TH+2) x (TW+2) x BK input tile (halo rows
//    and columns from their reflected sources, zero-filled where padding
//    is zero) and the next 9 x BK x BN weight slice into the other; each
//    thread applies the affine and ReLU in place to the values it copied.
//    The zero padding stays zero;
//  * ragged edges (H % TH, W % TW, C % BN, C % BK) are masked; any shape;
//  * statistics: the TPU grid is sequential and accumulates across row
//    chunks; here blocks run in parallel, so each block writes per-channel
//    partial sums for its tile in a fixed order and a second kernel sums
//    them in tile order (conv3x3_common.cuh). No float atomics.
//
// Left for later: float32 on the tensor cores (split-TF32 operands), TMA
// loads and deeper pipelines, a persistent schedule, and fusing the stats
// reduction into the epilogue of the last block.

#include "conv3x3_common.cuh"
#include "conv3x3_wgmma.cuh"

namespace {

using namespace conv3x3;

constexpr int BK = 8;                // input channels per shared-memory stage
// a stage: the 9 x BK x BN weight slice and BK float input planes
constexpr int W_BYTES = 9 * BK * BN * 4;
constexpr int STAGE_BYTES = W_BYTES + BK * IN_STRIDE * 4;
constexpr int SMEM = 2 * STAGE_BYTES;   // 89,088

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

// Issues the copies of input channels [k0, k0 + BK) into one stage.
// The loops stay rolled: unrolled, they spill registers.
__device__ __forceinline__ void load_stage(
    char* stage, const float* xs, const float* __restrict__ w, int k0, int r0,
    int c0, int n0, int H, int W, int C, bool reflect, bool vec_w, int t) {
  float* w_s = reinterpret_cast<float*>(stage);
  float* in_s = reinterpret_cast<float*>(stage + W_BYTES);
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

// After this thread's copies of a stage landed: the affine and ReLU in
// place on the values it copied (padding stays zero).
__device__ __forceinline__ void transform_stage(
    char* stage, const float* __restrict__ in_scale,
    const float* __restrict__ in_bias, int s, int k0, int r0, int c0, int H,
    int W, int C, bool reflect, bool has_affine, bool in_relu, int t) {
  if (!has_affine && !in_relu) return;
  float* in_s = reinterpret_cast<float*>(stage + W_BYTES);
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

__global__ void __launch_bounds__(NT, 2)
conv3x3_stats_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ in_scale,
                     const float* __restrict__ in_bias,
                     float* __restrict__ y, float* __restrict__ partial,
                     int H, int W, int C, int tiles_w, int n_tiles,
                     bool reflect, bool has_affine, bool in_relu) {
  extern __shared__ __align__(16) char smem[];  // 2 x [w_s | in_s]
  const Tile q = tile_of_block(tiles_w);
  const int t = q.t;
  const bool vec_w = C % 4 == 0;
  const float* xs = x + (size_t)q.s * H * W * C;

  float acc[8][8];   // [pixel (2 rows x 4 columns)][channel]
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int n_chunks = (C + BK - 1) / BK;
  load_stage(smem, xs, w, 0, q.r0, q.c0, q.n0, H, W, C, reflect, vec_w, t);
  cp_async_commit();
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    char* stage = smem + (chunk & 1) * STAGE_BYTES;
    if (chunk + 1 < n_chunks)
      load_stage(smem + ((chunk + 1) & 1) * STAGE_BYTES, xs, w,
                 (chunk + 1) * BK, q.r0, q.c0, q.n0, H, W, C, reflect, vec_w,
                 t);
    cp_async_commit();
    cp_async_wait_prev();
    const int k0 = chunk * BK;
    transform_stage(stage, in_scale, in_bias, q.s, k0, q.r0, q.c0, H, W, C,
                    reflect, has_affine, in_relu, t);
    __syncthreads();

    const float* w_s = reinterpret_cast<const float*>(stage);
    const float* in_s = reinterpret_cast<const float*>(stage + W_BYTES);
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
        // 8 weights of this tap row for channel group cg
        const float* wrow = &w_s[(tap * BK + k) * BN];
        const float4 b0 = *reinterpret_cast<const float4*>(wrow + q.cg * 4);
        const float4 b1 =
            *reinterpret_cast<const float4*>(wrow + 64 + q.cg * 4);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
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
      float* yp = y + (((size_t)q.s * H + gr) * W + gc) * C;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int co = out_channel(q, n);
        if (co < C) yp[co] = acc[p][n];
        psum[n] += acc[p][n];
        psq[n] += acc[p][n] * acc[p][n];
      }
    }
  }
  // the stages are no longer read
  block_partial_stats(q, psum, psq, reinterpret_cast<float*>(smem), partial,
                      C, n_tiles);
}

// the bfloat16 trunk on the tensor cores
using GBf16 = conv3x3_wgmma::Geom<conv3x3_wgmma::CONV_S1, 128, 4>;

}  // namespace

extern "C" {

// Number of spatial tiles per sample of the float32 kernel: the wrapper
// sizes the partial-sum scratch (S, n_tiles, 2, C) with it.
int conv3x3_stats_num_tiles(int H, int W) { return num_tiles(H, W); }

// The same for the bfloat16 kernel, and the bytes of the packed-weight
// workspace it takes.
int conv3x3_stats_bf16_num_tiles(int H, int W) {
  return conv3x3_wgmma::num_tiles(H, W);
}

long conv3x3_stats_bf16_wpack_bytes(int C) {
  return conv3x3_wgmma::wpack_bytes<GBf16>(C, C);
}

// Launch both kernels on `stream` and return the cudaError_t of the
// launches (0 on success). in_scale/in_bias may be null when has_affine is
// 0.
int conv3x3_stats_f32(const float* x, const float* w, const float* in_scale,
                      const float* in_bias, float* y, float* partial,
                      float* stats, int S, int H, int W, int C, int reflect,
                      int has_affine, int in_relu, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles_w = (W + TW - 1) / TW;
  const int n_tiles = num_tiles(H, W);
  const dim3 grid(n_tiles, (C + BN - 1) / BN, S);
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv3x3_stats_kernel<<<grid, NT, SMEM, st>>>(
      x, w, in_scale, in_bias, y, partial, H, W, C, tiles_w, n_tiles,
      reflect != 0, has_affine != 0, in_relu != 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_stats_reduce(partial, stats, S, n_tiles, C,
                                              st));
}

// bfloat16 x, w and y (C % 8 == 0, 16-byte aligned); wpack is a 16-byte
// aligned workspace of conv3x3_stats_bf16_wpack_bytes(C) bytes.
int conv3x3_stats_bf16(const void* x, const void* w, void* wpack,
                       const float* in_scale, const float* in_bias, void* y,
                       float* partial, float* stats, int S, int H, int W,
                       int C, int reflect, int has_affine, int in_relu,
                       void* stream) {
  using bf16 = __nv_bfloat16;
  return conv3x3_wgmma::launch<GBf16>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), wpack,
      in_scale, in_bias, static_cast<bf16*>(y), partial, stats, S, H, W, C, C,
      reflect != 0, has_affine != 0, in_relu != 0,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
