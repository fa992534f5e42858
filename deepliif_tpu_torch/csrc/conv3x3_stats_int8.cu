// Fused (affine -> ReLU ->) quantize -> int8 3x3 stride-1 conv -> dequant +
// per-(sample, channel) output statistics, for the int8 inference ResNet
// trunk on Hopper (sm_90a). bfloat16 activations, int8 weights.
//
// Replaces the TPU Pallas kernel
// deepliif_tpu/ops/fused_resblock.py::_kernel_int8 (driven by
// conv3x3_stats_int8 / resblock_chain_int8). Same contract and the same
// rounding points:
//
//   u   = relu(bf16(bf16(x * bf16(in_scale[s])) + bf16(in_bias[s])))
//   u   = pad1(u)              (reflect, or zeros applied AFTER affine/ReLU)
//   static:  v = u * bf16(inv_a[c])
//   dynamic: m = max(max |u| over the (sample, 16-row chunk + its 2 halo
//                rows) window, 1e-12);  v = u * bf16(127 / m)
//   q   = clip(rint(v), -127, 127)             (round half to even)
//   acc = conv3x3(q, w_q)                      (int32, exact)
//   yf  = f32(acc) * deq[co]     with deq[co] * (m / 127) in dynamic mode
//   y   = bf16(yf);  stats = (sum_hw yf, sum_hw yf^2) per (sample, channel)
//
// v is the float32 product of two bf16 values, which is exact: the JAX
// kernel writes the product in bf16 and converts it to float32 for the
// rounding, and XLA folds that pair of conversions away (measured on the
// JAX package's kernel in interpret mode: rounding v to bf16 first changes
// 3-10 % of the q values), so the exact product is the reference.
//
// The dynamic scale's granularity is semantics: a halo row is quantized
// with the scale of the chunk that consumes it, so the same input row has
// different q for the outputs of chunk r and chunk r - 1. Here a first
// kernel writes m for each (sample, chunk) (a max, so order-free and
// deterministic), and the conv's output tiles (TH = 8 rows) never straddle
// a chunk boundary (the chunk is 16 rows, or all of H when H < 16), so a
// tile quantizes its whole input window with its own chunk's m.
//
// Layout: x, y NHWC bf16 (S, H, W, C) with C % 8 == 0; w_q packed by the
// wrapper as (3, 3, C/4, C) int32 words, each holding 4 consecutive input
// channels of one output channel (the __dp4a operand); deq, inv_a (C,) f32;
// in_scale/in_bias (S, C) f32.
//
// What bounds it: 19.3 G int8 MACs x 2 per tile at the flagship shape
// against 16.8 MB of bf16 activation traffic: compute-bound. This kernel
// runs on __dp4a (4 MACs per instruction on the integer pipe); s8 tensor
// cores (mma.sync / wgmma, 1,979 TOPS dense) are later work.
//
// Design: the tiling, the two-stage cp.async pipeline and the fixed-order
// statistics of conv3x3_stats.cu. A stage holds BK = 16 input channels: the
// input lands as raw bf16 (two 16-byte copies per pixel), and the thread
// that copied 8 channels applies the affine, ReLU and quantization to them
// and stores them as two packed int32 words into the int8 planes; weights
// land packed. A thread's 4 x 6 window of packed words serves all 9 taps.

#include "conv3x3_common.cuh"

namespace {

using namespace conv3x3;
using bf16 = __nv_bfloat16;

constexpr int BK = 16;                              // input channels per stage
constexpr int BK4 = BK / 4;                         // packed words per pixel
constexpr int W_WORDS = 9 * BK4 * BN;               // 4,608 int32
constexpr int IN_WORDS = BK4 * IN_STRIDE;           // 960 int32
constexpr int RAW_BYTES = IH * IW * BK * 2;         // 5,760
constexpr int STAGE_BYTES = (W_WORDS + IN_WORDS) * 4 + RAW_BYTES;  // 28,032
constexpr int SMEM_BYTES = 2 * STAGE_BYTES;         // 56,064
constexpr int CHUNK = 16;                           // rows per dynamic scale
constexpr int MAX_NT = 512;                         // threads of the max pass

struct Quant {
  const float* in_scale;   // (S, C) or null
  const float* in_bias;
  const float* inv_a;      // (C,), static mode
  bool has_affine, in_relu, dynamic;
};

// u of channel c (a bf16 value held in a float) after the affine and ReLU
__device__ __forceinline__ float transform(float u, const Quant& qt, int s,
                                           int c, int C) {
  if (qt.has_affine) {
    const size_t i = (size_t)s * C + c;
    u = affine_bf16(u, bf16_round(qt.in_scale[i]), bf16_round(qt.in_bias[i]));
  }
  if (qt.in_relu) u = fmaxf(u, 0.f);
  return u;
}

__device__ __forceinline__ int quantize(float v) {
  return static_cast<int>(fminf(fmaxf(rintf(v), -127.f), 127.f));
}

__device__ __forceinline__ unsigned pack_s8x4(int a, int b, int c, int d) {
  return (static_cast<unsigned>(a) & 0xffu) |
         ((static_cast<unsigned>(b) & 0xffu) << 8) |
         ((static_cast<unsigned>(c) & 0xffu) << 16) |
         ((static_cast<unsigned>(d) & 0xffu) << 24);
}

// m_raw[s, r] = max |u| over padded rows r*ch - 1 .. r*ch + ch (the chunk
// and its halo rows: reflected rows for reflect padding, zeros at the image
// border for zero padding), all columns and channels. One block per
// (chunk, sample). The conv kernel clamps it at 1e-12.
__global__ void __launch_bounds__(MAX_NT)
chunk_absmax_kernel(const bf16* __restrict__ x, Quant qt,
                    float* __restrict__ m_raw, int H, int W, int C, int ch,
                    int n_chunks, bool reflect) {
  __shared__ float red[MAX_NT / 32];
  const int r = blockIdx.x;
  const int s = blockIdx.y;
  const bf16* xs = x + (size_t)s * H * W * C;
  const int per_row = W * C / 8;          // 16-byte pieces per row
  float m = 0.f;
  for (int e = threadIdx.x; e < (ch + 2) * per_row; e += MAX_NT) {
    const int row = e / per_row;
    const int src = src_index(r * ch - 1 + row, H, reflect);
    if (src < 0) continue;                // zero row: |0| adds nothing
    const int piece = e % per_row;
    const uint4 v = *reinterpret_cast<const uint4*>(
        xs + (size_t)src * W * C + (size_t)piece * 8);
    const unsigned words[4] = {v.x, v.y, v.z, v.w};
    const int c0 = (piece * 8) % C;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float u = (k % 2 == 0) ? bf16_lo(words[k / 2])
                                   : bf16_hi(words[k / 2]);
      m = fmaxf(m, fabsf(transform(u, qt, s, c0 + k, C)));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < MAX_NT / 32; ++i) m = fmaxf(m, red[i]);
    m_raw[(size_t)s * n_chunks + r] = m;
  }
}

// Issues the copies of input channels [k0, k0 + BK) into one stage.
__device__ __forceinline__ void load_stage(
    char* stage, const bf16* xs, const int* __restrict__ wp, int k0, int r0,
    int c0, int n0, int H, int W, int C, bool reflect, int t) {
  int* w_s = reinterpret_cast<int*>(stage);
  bf16* raw = reinterpret_cast<bf16*>(stage + (W_WORDS + IN_WORDS) * 4);
  for (int e = t; e < IH * IW * (BK / 8); e += NT) {
    const int half = e % (BK / 8);
    const int pix = e / (BK / 8);
    const int gr = src_index(r0 - 1 + pix / IW, H, reflect);
    const int gc = src_index(c0 - 1 + pix % IW, W, reflect);
    const bool ok = gr >= 0 && gc >= 0 && k0 + half * 8 < C;
    cp_async16(&raw[pix * BK + half * 8],
               ok ? xs + ((size_t)gr * W + gc) * C + k0 + half * 8 : xs, ok);
  }
  const int c4 = C / 4;
  for (int e = t; e < 9 * BK4 * (BN / 4); e += NT) {   // 4 output channels
    const int n = (e % (BN / 4)) * 4;
    const int k4 = (e / (BN / 4)) % BK4;
    const int tap = e / ((BN / 4) * BK4);
    const int ci4 = k0 / 4 + k4;
    const int co = n0 + n;
    const bool ok = ci4 < c4 && co < C;
    cp_async16(&w_s[(tap * BK4 + k4) * BN + n],
               ok ? wp + ((size_t)tap * c4 + ci4) * C + co : wp, ok);
  }
}

// After this thread's copies of a stage landed: affine, ReLU and
// quantization of the 8 channels it copied, into the packed int8 planes.
__device__ __forceinline__ void transform_stage(
    char* stage, const Quant& qt, float inva_dyn, int s, int k0, int r0,
    int c0, int H, int W, int C, bool reflect, int t) {
  int* in_q = reinterpret_cast<int*>(stage + W_WORDS * 4);
  const bf16* raw =
      reinterpret_cast<const bf16*>(stage + (W_WORDS + IN_WORDS) * 4);
  for (int e = t; e < IH * IW * (BK / 8); e += NT) {
    const int half = e % (BK / 8);
    const int pix = e / (BK / 8);
    const int row = pix / IW;
    const int col = pix % IW;
    const int gr = src_index(r0 - 1 + row, H, reflect);
    const int gc = src_index(c0 - 1 + col, W, reflect);
    const bool ok = gr >= 0 && gc >= 0 && k0 + half * 8 < C;
    int* dst = in_q + (half * 2) * IN_STRIDE + row * IWP + col;
    if (!ok) {
      dst[0] = 0;
      dst[IN_STRIDE] = 0;
      continue;
    }
    const uint4 v = *reinterpret_cast<const uint4*>(&raw[pix * BK + half * 8]);
    const unsigned words[4] = {v.x, v.y, v.z, v.w};
    int qv[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = k0 + half * 8 + k;
      float u = (k % 2 == 0) ? bf16_lo(words[k / 2]) : bf16_hi(words[k / 2]);
      u = transform(u, qt, s, c, C);
      const float inva = qt.dynamic ? inva_dyn : bf16_round(qt.inv_a[c]);
      qv[k] = quantize(u * inva);   // exact product of two bf16 values
    }
    dst[0] = static_cast<int>(pack_s8x4(qv[0], qv[1], qv[2], qv[3]));
    dst[IN_STRIDE] = static_cast<int>(pack_s8x4(qv[4], qv[5], qv[6], qv[7]));
  }
}

__global__ void __launch_bounds__(NT, 2)
conv3x3_stats_int8_kernel(const bf16* __restrict__ x,
                          const int* __restrict__ wp,
                          const float* __restrict__ deq, Quant qt,
                          const float* __restrict__ m_raw,
                          bf16* __restrict__ y, float* __restrict__ partial,
                          int H, int W, int C, int tiles_w, int n_tiles,
                          int ch, int n_chunks, bool reflect) {
  extern __shared__ __align__(16) char smem[];  // 2 x [w_s | in_q | raw]
  const Tile q = tile_of_block(tiles_w);
  const int t = q.t;
  const bf16* xs = x + (size_t)q.s * H * W * C;

  // this tile's chunk: TH divides the chunk, so no tile straddles two
  float m = 0.f, inva_dyn = 0.f;
  if (qt.dynamic) {
    m = fmaxf(m_raw[(size_t)q.s * n_chunks + q.r0 / ch], 1e-12f);
    inva_dyn = bf16_round(127.f / m);
  }

  int acc[8][8];   // [pixel (2 rows x 4 columns)][channel]
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0;

  const int n_k = (C + BK - 1) / BK;
  load_stage(smem, xs, wp, 0, q.r0, q.c0, q.n0, H, W, C, reflect, t);
  cp_async_commit();
  for (int kc = 0; kc < n_k; ++kc) {
    char* stage = smem + (kc & 1) * STAGE_BYTES;
    if (kc + 1 < n_k)
      load_stage(smem + ((kc + 1) & 1) * STAGE_BYTES, xs, wp, (kc + 1) * BK,
                 q.r0, q.c0, q.n0, H, W, C, reflect, t);
    cp_async_commit();
    cp_async_wait_prev();
    transform_stage(stage, qt, inva_dyn, q.s, kc * BK, q.r0, q.c0, H, W, C,
                    reflect, t);
    __syncthreads();

    const int* w_s = reinterpret_cast<const int*>(stage);
    const int* in_q = reinterpret_cast<const int*>(stage + W_WORDS * 4);
#pragma unroll 1
    for (int k4 = 0; k4 < BK4; ++k4) {
      const int* ik = in_q + k4 * IN_STRIDE + q.pr * IWP + q.pc;
      int win[4][6];   // packed input rows pr..pr+3, columns pc..pc+5
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int4 v = *reinterpret_cast<const int4*>(ik + r * IWP);
        const int2 u = *reinterpret_cast<const int2*>(ik + r * IWP + 4);
        win[r][0] = v.x; win[r][1] = v.y; win[r][2] = v.z; win[r][3] = v.w;
        win[r][4] = u.x; win[r][5] = u.y;
      }
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3;
        const int kx = tap % 3;
        const int* wrow = &w_s[(tap * BK4 + k4) * BN];
        const int4 b0 = *reinterpret_cast<const int4*>(wrow + q.cg * 4);
        const int4 b1 = *reinterpret_cast<const int4*>(wrow + 64 + q.cg * 4);
        const int b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int n = 0; n < 8; ++n)
              acc[i * 4 + j][n] = __dp4a(win[i + ky][j + kx], b[n],
                                         acc[i * 4 + j][n]);
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }

  // epilogue: dequant, store y in bf16, partial sums of the f32 values
  float dq[8];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int co = out_channel(q, n);
    dq[n] = co < C ? deq[co] : 0.f;
    if (qt.dynamic) dq[n] = __fmul_rn(dq[n], m / 127.f);
  }
  float yf[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int gr = q.r0 + q.pr + p / 4;
    const int gc = q.c0 + q.pc + p % 4;
    const bool in = gr < H && gc < W;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      yf[p][n] = in ? __fmul_rn(static_cast<float>(acc[p][n]), dq[n]) : 0.f;
    if (in) {
      bf16* yp = y + (((size_t)q.s * H + gr) * W + gc) * C;
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int co = out_channel(q, 4 * g);
        if (co < C) {   // C % 8 == 0: 4 channels all in range or all out
          uint2 pk;
          pk.x = pack_bf16x2(yf[p][4 * g], yf[p][4 * g + 1]);
          pk.y = pack_bf16x2(yf[p][4 * g + 2], yf[p][4 * g + 3]);
          *reinterpret_cast<uint2*>(yp + co) = pk;
        }
      }
    }
  }
  float psum[8], psq[8];
#pragma unroll
  for (int n = 0; n < 8; ++n) { psum[n] = 0.f; psq[n] = 0.f; }
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      psum[n] += yf[p][n];
      psq[n] += yf[p][n] * yf[p][n];
    }
  block_partial_stats(q, psum, psq, reinterpret_cast<float*>(smem), partial,
                      C, n_tiles);
}

}  // namespace

extern "C" {

int conv3x3_stats_int8_num_tiles(int H, int W) { return num_tiles(H, W); }

// Launches the max pass (dynamic mode), the conv and the stats reduction on
// `stream`; returns the cudaError_t of the launches (0 on success).
// m_raw is (S, n_chunks) f32 scratch, used only in dynamic mode; inv_a may
// be null in dynamic mode; in_scale/in_bias may be null when has_affine is
// 0. ch is the dynamic chunk height: 16, or H when H < 16; H % ch == 0.
int conv3x3_stats_int8(const void* x, const int* w_packed, const float* deq,
                       const float* inv_a, const float* in_scale,
                       const float* in_bias, void* y, float* m_raw,
                       float* partial, float* stats, int S, int H, int W,
                       int C, int ch, int reflect, int has_affine,
                       int in_relu, int dynamic, void* stream) {
  if (C % 8 != 0 || ch <= 0 || H % ch != 0 || (ch != CHUNK && ch != H) ||
      (ch % TH != 0 && ch != H))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const Quant qt{in_scale, in_bias, inv_a, has_affine != 0, in_relu != 0,
                 dynamic != 0};
  const int n_chunks = H / ch;
  cudaError_t err;
  if (dynamic) {
    chunk_absmax_kernel<<<dim3(n_chunks, S), MAX_NT, 0, st>>>(
        xb, qt, m_raw, H, W, C, ch, n_chunks, reflect != 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles_w = (W + TW - 1) / TW;
  const int n_tiles = num_tiles(H, W);
  const dim3 grid(n_tiles, (C + BN - 1) / BN, S);
  err = cudaFuncSetAttribute(conv3x3_stats_int8_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv3x3_stats_int8_kernel<<<grid, NT, SMEM_BYTES, st>>>(
      xb, w_packed, deq, qt, m_raw, static_cast<bf16*>(y), partial, H, W, C,
      tiles_w, n_tiles, ch, n_chunks, reflect != 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_stats_reduce(partial, stats, S, n_tiles, C,
                                              st));
}

}  // extern "C"
