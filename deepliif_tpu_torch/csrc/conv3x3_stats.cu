// Fused (affine -> ReLU ->) 3x3 stride-1 conv + per-(sample, channel) output
// statistics, for the inference ResNet trunk on Hopper (sm_90a), float32.
//
// Replaces the TPU Pallas kernel deepliif_tpu/ops/fused_resblock.py::_kernel
// (driven by conv3x3_stats / resblock_chain). Same contract:
//
//   u     = relu(x * in_scale[s] + in_bias[s])    (affine and ReLU optional)
//   u     = pad1(u)                               (reflect, or zeros applied
//                                                  AFTER the affine/ReLU)
//   y     = conv3x3(u, w)                         (f32 accumulation)
//   stats = (sum_hw y, sum_hw y^2)  per (sample, channel)
//
// Layout: x and y are NHWC (S, H, W, C) contiguous, so a channels_last NCHW
// tensor enters with no transpose; w is HWIO (3, 3, C, C) contiguous, laid
// out once when the model is loaded; scale/bias are (S, C).
//
// What bounds it: at the flagship shape (128 x 128 x 256 per tile) one conv
// is 2 * 128*128 * 256*256 * 9 = 19.3 GFLOP per tile against 33.6 MB of
// activation traffic in and out, i.e. ~575 FLOP per byte: compute-bound.
// At f32 there are no tensor cores without TF32, so the ceiling is the FFMA
// rate (67 TFLOP/s published for the H100 SXM at 700 W).
//
// Design (simple first):
//  * one block per (spatial tile of TH x TW pixels, BN output channels,
//    sample); 256 threads, each owning 2 x 4 pixels x 8 output channels in
//    registers (64 f32 accumulators). Per input channel a thread reads its
//    4 x 6 input window from shared memory once (float4 + float2 per row)
//    and reuses it for all 9 taps;
//  * the K loop walks input channels BK at a time through two shared-memory
//    stages: while the block runs the 9 * BK rank-1 updates of one stage,
//    cp.async copies the next (TH+2) x (TW+2) x BK input tile (halo rows
//    and columns from their reflected sources, zero-filled where padding
//    is zero) and the next 9 x BK x BN weight slice into the other; each
//    thread applies the affine and ReLU to the input values it copied once
//    they land, leaving the zero padding at zero;
//  * ragged edges (H % TH, W % TW, C % BN, C % BK) are masked, so any shape
//    is taken;
//  * statistics: the TPU grid is sequential and accumulates across row
//    chunks; here blocks run in parallel, so each block writes per-channel
//    partial sums for its tile to a scratch (S, n_tiles, 2, C) with a fixed
//    shuffle order, and a second kernel sums the partials in tile order.
//    No float atomics: results are bitwise reproducible run to run and do
//    not depend on the batch a sample rides in.
//
// Left for later: tensor cores (wgmma on split-TF32 or bf16 operands), TMA
// loads and deeper pipelines, a persistent schedule, and fusing the stats
// reduction into the epilogue of the last block per sample.

#include <cuda_runtime.h>

namespace {

constexpr int TH = 8;                // output rows per block
constexpr int TW = 16;               // output columns per block
constexpr int BN = 128;              // output channels per block
constexpr int BK = 8;                // input channels per shared-memory stage
constexpr int NT = 256;              // threads: 16 pixel groups x 16 channel groups
constexpr int IH = TH + 2;           // staged input rows (1-px halo)
constexpr int IW = TW + 2;           // staged input columns
// Row stride of the staged input: 16-byte aligned rows, and two row pairs
// 16 banks apart, so the 8 pixel groups of a warp read without conflicts.
constexpr int IWP = 24;
constexpr int IN_STRIDE = IH * IWP;  // floats per staged input channel
constexpr int W_FLOATS = 9 * BK * BN;           // weight slice per stage
constexpr int STAGE_FLOATS = W_FLOATS + BK * IN_STRIDE;
constexpr int SMEM_BYTES = 2 * STAGE_FLOATS * sizeof(float);  // 89,088

// Source index of padded position i along an axis of length n, or -1 where
// the value is zero: the zero-padding halo, and positions past the halo
// that only feed masked outputs of a ragged tile.
__device__ __forceinline__ int src_index(int i, int n, bool reflect) {
  if (i >= 0 && i < n) return i;
  if (reflect && i == -1) return 1;
  if (reflect && i == n) return n - 2;
  return -1;
}

// cp.async copies of 4 or 16 bytes; src_bytes 0 zero-fills the destination
// without reading the source.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// waits until this thread's copies of all but the newest group have landed
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Position of input-tile element e (channel k, tile row/col) and whether it
// has a source value (false: zero padding, past the halo, or channel >= C).
struct InElem {
  int k, dst, gr, gc;   // channel in the stage, shared-memory offset, source
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
__device__ __forceinline__ void load_stage(
    float* stage, const float* xs, const float* __restrict__ w, int k0,
    int r0, int c0, int n0, int H, int W, int C, bool reflect, bool vec_w,
    int t) {
  float* w_s = stage;
  float* in_s = stage + W_FLOATS;
  for (int e = t; e < BK * IH * IW; e += NT) {
    const InElem q = in_elem(e, k0, r0, c0, H, W, C, reflect);
    cp_async4(&in_s[q.dst],
              q.ok ? xs + ((size_t)q.gr * W + q.gc) * C + k0 + q.k : xs, q.ok);
  }
  if (vec_w) {  // C % 4 == 0: 16-byte copies of 4 output channels
    for (int e = t; e < W_FLOATS / 4; e += NT) {
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
    for (int e = t; e < W_FLOATS; e += NT) {
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

__global__ void __launch_bounds__(NT, 2)
conv3x3_stats_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ in_scale,
                     const float* __restrict__ in_bias,
                     float* __restrict__ y, float* __restrict__ partial,
                     int H, int W, int C, int tiles_w, int n_tiles,
                     bool reflect, bool has_affine, bool in_relu) {
  extern __shared__ __align__(16) float smem[];  // 2 x [w_s | in_s]

  const int tile = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  const int s = blockIdx.z;
  const int r0 = (tile / tiles_w) * TH;
  const int c0 = (tile % tiles_w) * TW;
  const int t = threadIdx.x;
  // A warp holds 8 pixel groups x 4 channel groups. Pixel group pg owns
  // tile rows 2*(pg/4) + {0,1} and columns 4*(pg%4) + {0..3}; channel group
  // cg owns channels n0 + cg*4 + {0..3} and n0 + 64 + cg*4 + {0..3}.
  const int lane = t % 32;
  const int warp = t / 32;
  const int pg = (warp % 2) * 8 + lane % 8;
  const int cg = (warp / 2) * 4 + lane / 8;
  const int pr = 2 * (pg / 4);
  const int pc = 4 * (pg % 4);
  const bool vec_w = C % 4 == 0;

  const float* xs = x + (size_t)s * H * W * C;

  float acc[8][8];   // [pixel (2 rows x 4 columns)][channel]
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int n_chunks = (C + BK - 1) / BK;
  load_stage(smem, xs, w, 0, r0, c0, n0, H, W, C, reflect, vec_w, t);
  cp_async_commit();
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    float* stage = smem + (chunk & 1) * STAGE_FLOATS;
    if (chunk + 1 < n_chunks)
      load_stage(smem + ((chunk + 1) & 1) * STAGE_FLOATS, xs, w,
                 (chunk + 1) * BK, r0, c0, n0, H, W, C, reflect, vec_w, t);
    cp_async_commit();
    cp_async_wait_prev();
    const int k0 = chunk * BK;
    const float* w_s = stage;
    float* in_s = stage + W_FLOATS;
    if (has_affine || in_relu) {
      // the values this thread copied: affine, ReLU; padding stays zero
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
    __syncthreads();

#pragma unroll 1
    for (int k = 0; k < BK; ++k) {
      const float* ik = in_s + k * IN_STRIDE + pr * IWP + pc;
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
        const float* wrow = &w_s[(tap * BK + k) * BN];
        const float4 b0 = *reinterpret_cast<const float4*>(wrow + cg * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(wrow + 64 + cg * 4);
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

  // epilogue: store y, per-channel partial sums over this tile's pixels
  float psum[8], psq[8];
#pragma unroll
  for (int n = 0; n < 8; ++n) { psum[n] = 0.f; psq[n] = 0.f; }
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int gr = r0 + pr + p / 4;
    const int gc = c0 + pc + p % 4;
    if (gr < H && gc < W) {
      float* yp = y + (((size_t)s * H + gr) * W + gc) * C;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int co = n0 + (n < 4 ? cg * 4 + n : 64 + cg * 4 + n - 4);
        if (co < C) yp[co] = acc[p][n];
        psum[n] += acc[p][n];
        psq[n] += acc[p][n] * acc[p][n];
      }
    }
  }
  // Fixed-order reduction over the 16 pixel groups of a channel group: an
  // xor butterfly over the 8 lanes of a warp that share it, then the warp
  // holding pixel groups 8-15 hands its sums to the one holding 0-7.
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      psum[n] += __shfl_xor_sync(0xffffffffu, psum[n], off);
      psq[n] += __shfl_xor_sync(0xffffffffu, psq[n], off);
    }
  }
  float* red = smem;   // [cg][n][sum, sumsq]; the stages are no longer read
  if (pg == 8) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      red[(cg * 8 + n) * 2] = psum[n];
      red[(cg * 8 + n) * 2 + 1] = psq[n];
    }
  }
  __syncthreads();
  if (pg == 0) {
    float* ps = partial + ((size_t)s * n_tiles + tile) * 2 * C;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int co = n0 + (n < 4 ? cg * 4 + n : 64 + cg * 4 + n - 4);
      if (co < C) {
        ps[co] = psum[n] + red[(cg * 8 + n) * 2];
        ps[C + co] = psq[n] + red[(cg * 8 + n) * 2 + 1];
      }
    }
  }
}

// stats[s, q, c] = sum over tiles, in tile order, of partial[s, tile, q, c]
__global__ void stats_reduce_kernel(const float* __restrict__ partial,
                                    float* __restrict__ stats, int S,
                                    int n_tiles, int C) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= S * 2 * C) return;
  const int c = idx % C;
  const int q = (idx / C) % 2;
  const int s = idx / (2 * C);
  const float* p = partial + ((size_t)s * n_tiles * 2 + q) * C + c;
  float acc = 0.f;
  for (int tile = 0; tile < n_tiles; ++tile) acc += p[(size_t)tile * 2 * C];
  stats[idx] = acc;
}

}  // namespace

extern "C" {

// Number of spatial tiles per sample: the wrapper sizes the partial-sum
// scratch (S, n_tiles, 2, C) with it.
int conv3x3_stats_num_tiles(int H, int W) {
  return ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
}

// Launches both kernels on `stream` and returns the cudaError_t of the
// launches (0 on success). in_scale/in_bias may be null when has_affine is 0.
int conv3x3_stats_f32(const float* x, const float* w, const float* in_scale,
                      const float* in_bias, float* y, float* partial,
                      float* stats, int S, int H, int W, int C, int reflect,
                      int has_affine, int in_relu, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles_w = (W + TW - 1) / TW;
  const int n_tiles = conv3x3_stats_num_tiles(H, W);
  const dim3 grid(n_tiles, (C + BN - 1) / BN, S);
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv3x3_stats_kernel<<<grid, NT, SMEM_BYTES, st>>>(
      x, w, in_scale, in_bias, y, partial, H, W, C, tiles_w, n_tiles,
      reflect != 0, has_affine != 0, in_relu != 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = S * 2 * C;
  stats_reduce_kernel<<<(total + 255) / 256, 256, 0, st>>>(partial, stats, S,
                                                           n_tiles, C);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
