// Fused (affine -> ReLU ->) 3-px pad -> 7x7 conv to Cout = 3 (-> + bias ->
// tanh), bfloat16, for the tail of the inference ResNet translator on
// Hopper's tensor cores (wgmma, sm_90a).
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
// x (S, H, W, Cin) NHWC bf16, Cin % 8 == 0, 16-byte aligned; w (7, 7, Cin,
// 3) HWIO bf16; bias (3,) bf16 or null; y (S, 3, H, W) bf16, the NCHW
// layout the generator returns (the TPU kernel's 8x8 space-to-depth block
// layout is made from it by the wrapper of the block form).
//
// What bounds it: the flagship call ((16, 512, 512, 64) -> 3) moves 562 MB
// (x read once, y written once): 0.168 ms at 3.35 TB/s; its 7.89e10 FLOP
// take 0.080 ms on the bf16 tensor cores but 1.18 ms on the FP32 FFMA pipe,
// where the first version ran (2.45 ms on the H100). Cout = 3 fills no
// tensor-core tile, and packing the 49 taps into K (im2col, N = 8) re-reads
// each A value once per tap from shared memory: 6.3 KB per output pixel.
//
// Design: the kernel-column taps go into N, the kernel-row taps into K.
// For output row r and staged input column m of a tile,
//   Q[r, m, (kx, co)] = sum_ky sum_ci u[r + ky - 3, m, ci] w[ky, kx, ci, co]
// is a GEMM with M = the 64 staged columns of the row (one m64 wgmma, the
// 4 warps of a warpgroup 16 columns each), N = 7 kx x 3 co = 21 padded to
// 24 (m64n24k16), K = 7 ky x Cin: a kernel row's tap is a shift of the A
// rows by one staged row, address arithmetic for ldmatrix, so each staged
// value is read 7 times (not 49) from shared memory. The kx taps are summed
// in the epilogue: y[r, c, co] = sum_kx Q[r, c + kx, 3 kx + co] (a tile
// row's 64 staged columns give 58 output columns).
//  * tile: 8 output rows x 58 output columns of one sample, 256 threads =
//    2 warpgroups, 4 output rows each (12 f32 accumulators a row a thread);
//  * stages of 16 input channels (one k16 step), double-buffered: while
//    the warpgroups run stage k, cp.async brings stage k + 1's slab (14
//    rows x 64 columns x 32 bytes, the halo included, each pixel's two
//    16-byte halves swapped on every other group of 4 columns so that an
//    ldmatrix phase's 8 rows fall in 8 distinct bank groups) and its
//    packed weights (7 ky x 24 columns x 16 channels, the K-major core
//    matrices of desc_kmajor, packed once per call by tail_wpack_kernel).
//    cp.async zero-fills what has no source (the zero pad, the positions
//    past it, channels past Cin) and copies the reflected pixel into the
//    halo (reflect); each thread then applies the affine and ReLU in place
//    to its own units that have a source, with packed bf16x2 arithmetic;
//  * per (output row, stage) one unit of 7 wgmma steps (ky = 0..6) runs
//    into a fresh f32 temporary, added to the row's f32 accumulator once
//    it completed: the tensor cores' own accumulation drifts over long K
//    (measured on the H100 for the trunk kernels), so no chain runs past
//    7 steps;
//  * epilogue: the accumulators go to shared memory (Q, 25 floats per
//    column: reads of consecutive output columns are conflict-free), and
//    each thread sums the 7 kx terms of an output in kx order, rounds, adds
//    the bias, takes tanh and stores y (consecutive threads, consecutive
//    columns). Outputs past H or W are not stored.
// Each output is one thread's sum in a fixed order over its own sample,
// with no atomics: y is byte-equal run to run and does not depend on the
// batch.
//
// Of the trunk mainloop (conv3x3_wgmma.cuh) it takes the PTX wrappers
// (ldmatrix, wgmma fences, the K-major descriptor), not the TMA producer
// warpgroup: its Geom is built for 3x3 taps of a 16 x 16 pixel tile with
// the output channels in N, and here the taps are in N and a tile row is
// the M. Measured on the H100 at (16, 512, 512, 64) -> 3: 0.58 ms (the
// FFMA version 2.42 ms in the same call), 29 % of the byte bound; the
// halo (14 staged rows for 8 output rows, 64 columns for 58) and one
// drain of the tensor cores per (row, stage) are what a faster version
// would take on next.

#include "conv3x3_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using conv3x3::bf16_round;
using conv3x3::cp_async16;
using conv3x3::cp_async_commit;
using conv3x3_wgmma::cp_async_wait;
using conv3x3_wgmma::desc_kmajor;
using conv3x3_wgmma::fence_proxy_async;
using conv3x3_wgmma::fence_regs;
using conv3x3_wgmma::ldmatrix_x4;
using conv3x3_wgmma::smem_u32;
using conv3x3_wgmma::wgmma_commit;
using conv3x3_wgmma::wgmma_fence;
using conv3x3_wgmma::wgmma_wait;

constexpr int KS = 7;                 // kernel size
constexpr int PAD = 3;
constexpr int COUT = 3;
constexpr int MP = 64;                // staged columns of a tile row (m64)
constexpr int TW = MP - KS + 1;       // output columns of a tile (58)
constexpr int NWG = 2;                // warpgroups
constexpr int RPW = 4;                // output rows per warpgroup
constexpr int TH = NWG * RPW;         // output rows of a tile (8)
constexpr int NT = 128 * NWG;         // threads
constexpr int SR = TH + KS - 1;       // staged rows (14)
constexpr int KC = 16;                // input channels per stage
constexpr int NN = 24;                // N: 7 kx x 3 co = 21, padded
constexpr int NACC = NN / 2;          // accumulators a row a thread (12)
constexpr int WKY_BYTES = NN * KC * 2;          // B of one ky (768)
constexpr int W_BYTES = KS * WKY_BYTES;         // B of a stage (5376)
constexpr int SLAB_BYTES = SR * MP * KC * 2;    // 28,672
constexpr int STAGE_BYTES = W_BYTES + SLAB_BYTES;
constexpr int QS = NN + 1;            // floats per staged column of Q
constexpr int Q_BYTES = TH * MP * QS * 4;       // 51,200
constexpr int SMEM = 2 * STAGE_BYTES > Q_BYTES ? 2 * STAGE_BYTES : Q_BYTES;
constexpr int UNITS = SR * MP * 2;    // 16-byte slab units of a stage
constexpr int UPT = UNITS / NT;       // per thread (7)
constexpr int W_UNITS = W_BYTES / 16;
static_assert(UNITS % NT == 0 && NT % (2 * MP) == 0,
              "a thread stages one column half of every other row");
static_assert(STAGE_BYTES % 128 == 0, "stage alignment");

// Source index of padded position i along an axis of length n, or -1 where
// the value is zero (the zero pad, and positions past the pad that feed only
// masked outputs of a ragged tile). Reflect needs n > PAD.
__device__ __forceinline__ int src_index(int i, int n, bool reflect) {
  if (i >= 0 && i < n) return i;
  if (reflect && i < 0 && i >= -PAD) return -i;
  if (reflect && i >= n && i < n + PAD) return 2 * (n - 1) - i;
  return -1;
}

// byte offset in a stage's slab of 16-byte half h of staged pixel (row, m)
__device__ __forceinline__ int slab_off(int row, int m, int h) {
  return ((row * MP + m) * 2 + (h ^ ((m >> 2) & 1))) * 16;
}

// d[12] = A (m64 x k16, bf16 fragments in registers) * B (k16 x n24, bf16,
// K-major core matrices in shared memory) + (accumulate ? d : 0), f32.
// Thread (warp w, lane l) holds d[i] of row 16w + l/4 + 8((i/2)%2), column
// 8(i/4) + 2(l%4) + i%2.
__device__ __forceinline__ void wgmma_n24(float (&d)[NACC],
                                          const uint32_t (&a)[4],
                                          uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, %16, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

// wpk[k][ky][desc_kmajor image of (16 channels x 24 columns)]: column n =
// 3 kx + co holds w[ky, kx, 16 k + ch, co], zero past 21 columns or Cin.
__global__ void tail_wpack_kernel(const bf16* __restrict__ w,
                                  bf16* __restrict__ wpk, int Cin, int NK) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= NK * (W_BYTES / 2)) return;
  const int e = idx % 8;              // channel within the 16-byte chunk
  const int n8 = (idx / 8) % 8;       // column within the core matrix
  const int kh = (idx / 64) % 2;      // 16-byte chunk of the k16 step
  const int n = (idx / 128) % 3 * 8 + n8;
  const int ky = (idx / 384) % KS;
  const int ch = (idx / (W_BYTES / 2)) * KC + kh * 8 + e;
  wpk[idx] = (n < KS * COUT && ch < Cin)
                 ? w[((ky * KS + n / COUT) * Cin + ch) * COUT + n % COUT]
                 : __float2bfloat16(0.f);
}

// One stage's copies: the thread's slab units (column m, half h, rows
// row0 + 2i) and its share of the packed weights. Returns the units that
// have a source (bit i); the others are zero-filled and stay zero.
__device__ __forceinline__ unsigned issue_stage(char* stage, const bf16* xs,
                                               const bf16* wpk, int k, int t,
                                               int m, int h, int row0,
                                               const int (&gr)[UPT], int gc,
                                               int W, int Cin) {
  const int ch = k * KC + 8 * h;
  unsigned ok = 0;
#pragma unroll
  for (int i = 0; i < UPT; ++i) {
    const bool on = gr[i] >= 0 && gc >= 0 && ch < Cin;
    const bf16* src = on ? xs + ((size_t)gr[i] * W + gc) * Cin + ch : xs;
    cp_async16(stage + W_BYTES + slab_off(row0 + 2 * i, m, h), src, on);
    ok |= static_cast<unsigned>(on) << i;
  }
  const char* wsrc = reinterpret_cast<const char*>(wpk) + (size_t)k * W_BYTES;
  for (int u = t; u < W_UNITS; u += NT)
    cp_async16(stage + 16 * u, wsrc + 16 * u, true);
  cp_async_commit();
  return ok;
}

__global__ void __launch_bounds__(NT, 2)
tail_s2d_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wpk,
                const bf16* __restrict__ bias,
                const float* __restrict__ in_scale,
                const float* __restrict__ in_bias, bf16* __restrict__ y,
                int H, int W, int Cin, int tiles_w, bool has_affine,
                bool in_relu, bool reflect, bool fused) {
  extern __shared__ __align__(128) char smem[];
  const int t = threadIdx.x;
  const int s = blockIdx.y;
  const int r0 = (blockIdx.x / tiles_w) * TH;
  const int c0 = (blockIdx.x % tiles_w) * TW;
  const bf16* xs = x + (size_t)s * H * W * Cin;
  const int NK = (Cin + KC - 1) / KC;

  // the staging role: column m, half h, rows row0 + 2i of every stage
  const int m = (t / 2) % MP;
  const int h = t % 2;
  const int row0 = t / (2 * MP);
  const int gc = src_index(c0 - PAD + m, W, reflect);
  int gr[UPT];
#pragma unroll
  for (int i = 0; i < UPT; ++i)
    gr[i] = src_index(r0 - PAD + row0 + 2 * i, H, reflect);

  // the compute role: warpgroup wg owns output rows wg * RPW + j; warp wq
  // of it staged columns 16 wq .. 16 wq + 15
  const int wg = t / 128;
  const int wq = (t / 32) % 4;
  const int lane = t % 32;
  const int am = 16 * wq + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int ah = lane >> 4;
  float acc[RPW][NACC];
#pragma unroll
  for (int j = 0; j < RPW; ++j)
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[j][i] = 0.f;

  unsigned ok = issue_stage(smem, xs, wpk, 0, t, m, h, row0, gr, gc, W, Cin);
  unsigned ok_next = 0;
#pragma unroll 1
  for (int k = 0; k < NK; ++k) {
    char* stage = smem + (k % 2) * STAGE_BYTES;
    if (k + 1 < NK) {
      ok_next = issue_stage(smem + ((k + 1) % 2) * STAGE_BYTES, xs, wpk, k + 1,
                            t, m, h, row0, gr, gc, W, Cin);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (has_affine || in_relu) {
      // this thread's 8 channels of the stage, scale and bias in bf16
      const int ch = k * KC + 8 * h;
      __nv_bfloat162 s2[4], b2[4];
      const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool on = has_affine && ch < Cin;
        const float* sc = in_scale + (size_t)s * Cin + ch + 2 * e;
        const float* bi = in_bias + (size_t)s * Cin + ch + 2 * e;
        s2[e] = on ? __floats2bfloat162_rn(sc[0], sc[1]) : zero;
        b2[e] = on ? __floats2bfloat162_rn(bi[0], bi[1]) : zero;
      }
#pragma unroll
      for (int i = 0; i < UPT; ++i) {
        if (!((ok >> i) & 1u)) continue;
        uint4* p = reinterpret_cast<uint4*>(stage + W_BYTES +
                                            slab_off(row0 + 2 * i, m, h));
        uint4 v = *p;
        uint32_t* wv = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          __nv_bfloat162 u = *reinterpret_cast<__nv_bfloat162*>(&wv[e]);
          if (has_affine) u = __hadd2_rn(__hmul2_rn(u, s2[e]), b2[e]);
          if (in_relu) u = __hmax2(u, zero);
          wv[e] = *reinterpret_cast<uint32_t*>(&u);
        }
        *p = v;
      }
    }
    fence_proxy_async();   // the weights and slab, before the wgmma reads
    __syncthreads();

    const uint32_t w_s = smem_u32(stage);
    const uint32_t slab_s = smem_u32(stage + W_BYTES);
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const int orow = wg * RPW + j;
      uint32_t a[KS][4];
#pragma unroll
      for (int ky = 0; ky < KS; ++ky)
        ldmatrix_x4(a[ky], slab_s + slab_off(orow + ky, am, ah));
      float tmp[NACC];
      wgmma_fence();
#pragma unroll
      for (int ky = 0; ky < KS; ++ky)
        wgmma_n24(tmp, a[ky], desc_kmajor(w_s + ky * WKY_BYTES), ky > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(tmp);
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[j][i] += tmp[i];
    }
    __syncthreads();   // the stage's buffer is refilled two stages on
    ok = ok_next;
  }

  // epilogue: Q[orow][m][n] through shared memory (the stage buffers are
  // free: every copy landed and every wgmma completed)
  float* q = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < RPW; ++j)
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int qm = 16 * wq + lane / 4 + 8 * ((i / 2) % 2);
      const int qn = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
      if (qn < KS * COUT)
        q[((wg * RPW + j) * MP + qm) * QS + qn] = acc[j][i];
    }
  __syncthreads();
  for (int idx = t; idx < TH * COUT * TW; idx += NT) {
    const int jj = idx % TW;
    const int co = (idx / TW) % COUT;
    const int orow = idx / (TW * COUT);
    const int gy = r0 + orow;
    const int gx = c0 + jj;
    if (gy >= H || gx >= W) continue;
    const float* qp = q + (orow * MP + jj) * QS + co;
    float v = qp[0];
#pragma unroll
    for (int kx = 1; kx < KS; ++kx) v += qp[kx * (QS + COUT)];
    if (fused) {
      v = bf16_round(v);
      if (bias) v = bf16_round(v + __bfloat162float(bias[co]));
      v = tanhf(v);
    }
    y[(((size_t)s * COUT + co) * H + gy) * W + gx] = __float2bfloat16(v);
  }
}

}  // namespace

extern "C" {

// Bytes of the packed-weight workspace the wrapper passes as wpk.
long tail_s2d_wpack_bytes(int Cin) {
  return static_cast<long>((Cin + KC - 1) / KC) * W_BYTES;
}

// Launch on `stream` (the weight pack, then the conv); returns the
// cudaError_t of the launches (0 on success). in_scale/in_bias may be null
// when has_affine is 0, bias may be null; fused 0 writes the rounded conv
// (no bias, no tanh). wpk: tail_s2d_wpack_bytes(Cin) bytes, 16-byte aligned.
int tail_s2d_bf16(const void* x, const void* w, const void* bias,
                  const float* in_scale, const float* in_bias, void* y,
                  void* wpk, int S, int H, int W, int Cin, int Cout,
                  int has_affine, int in_relu, int reflect, int fused,
                  void* stream) {
  if (Cin % 8 || Cout != COUT || (reflect && (H <= PAD || W <= PAD)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nk = (Cin + KC - 1) / KC;
  const int pack = nk * (W_BYTES / 2);
  tail_wpack_kernel<<<(pack + 255) / 256, 256, 0, st>>>(
      static_cast<const bf16*>(w), static_cast<bf16*>(wpk), Cin, nk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(tail_s2d_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_w = (W + TW - 1) / TW;
  const dim3 grid(tiles_w * ((H + TH - 1) / TH), S);
  tail_s2d_kernel<<<grid, NT, SMEM, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wpk),
      static_cast<const bf16*>(bias), in_scale, in_bias, static_cast<bf16*>(y),
      H, W, Cin, tiles_w, has_affine != 0, in_relu != 0, reflect != 0,
      fused != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
