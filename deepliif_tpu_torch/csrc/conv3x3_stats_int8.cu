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
// different q for the outputs of chunk r and chunk r - 1.
//
// Layout: x, y NHWC bf16 (S, H, W, C) with C % 8 == 0; w_q HWIO (3, 3, C,
// C) int8; deq, inv_a (C,) f32; in_scale/in_bias (S, C) f32.
//
// What bounds it: 19.3 G int8 MACs x 2 per tile at the flagship shape
// against 16.8 MB of bf16 activation traffic: compute-bound, on the s8
// tensor cores (1,979 TOP/s dense): 0.156 ms at (16, 128, 128, 256).
//
// Design, three passes:
//  1. (dynamic) row_absmax_kernel writes max |u| of each (sample, row), one
//     block per row (one block per chunk left most SMs idle: 0.17 ms against
//     0.08 at (16, 128, 128, 256)), and chunk_max_kernel a chunk's m as the
//     max of its window's rows (a max, so order-free and deterministic): m
//     must be known before the quantize pass and the conv's dequant;
//  2. quantize_blocks_kernel writes q once per conv as per-chunk blocks
//     (S * n_chunks, ch + 2, W + 2, Cp) int8 (ch = 16, or H when H < 16; Cp
//     = C rounded up to 16, so that a block row is a multiple of the 16
//     bytes a tensor map's strides must be): each chunk's rows with its two
//     halo rows quantized at the chunk's own scale, reflect or zero rows and
//     columns included, zero past C. 77 MB at (16, 128, 128, 256). A
//     thread quantizes 8 channels of a block pixel, with 32-bit indexing
//     (64-bit divisions cost more than the bytes) and the per-channel
//     scales loaded as vectors;
//  3. the s8 variant of the wgmma mainloop of conv3x3_wgmma.cuh (CONV_S1,
//     OP_S8): 16 x 16 output pixels x 64 output channels per item, whose
//     tile is one chunk (tiles never straddle chunks, so a tile's slab is
//     its chunk's block: 18 x 18 pixels x 32 channels per stage, one TMA
//     box, no transform: the producer only issues copies, which in the bf16
//     kernel bounded every kind); wgmma m64n64k32 s32.s8.s8 with A from
//     registers (ldmatrix.x4 on the slab, whose 32-byte pixels are the bf16
//     path's layout) and B K-major (s8 takes only K-major operands: the
//     weights are packed once per call as core matrices, column = output
//     channel, its 32 input channels contiguous); int32 sums are exact (|acc|
//     <= 127^2 x 2304 < 2^31), so they run straight in the accumulators
//     across all of K, and y is bit-equal to the plain version whatever the
//     order. At 128 output channels the accumulators (128 registers) and
//     both m64 tiles' A fragments (72) spilled, and the whole dynamic call
//     took 0.718 ms against 0.625 at 64 (experiments/torch_kernel_ab.py,
//     H100 SXM at 700 W). The epilogue dequantizes
//     with the expression of the contract and sums the stats in a fixed
//     order, summed in tile order.
//  The producer-side alternative (quantizing the bf16 slab in shared memory
//  per stage) would put back on the producer the pass that bounded the bf16
//  kernel, once per 64 output channels.

#include "conv3x3_common.cuh"
#include "conv3x3_wgmma.cuh"

namespace {

using namespace conv3x3;
using bf16 = __nv_bfloat16;
using G8 = conv3x3_wgmma::Geom<conv3x3_wgmma::CONV_S1, 64, 4,
                               conv3x3_wgmma::OP_S8>;

constexpr int CHUNK = 16;        // rows per dynamic scale
static_assert(conv3x3_wgmma::TM == CHUNK, "a tile is one chunk");

struct Quant {
  const float* in_scale;   // (S, C) or null
  const float* in_bias;
  const float* inv_a;      // (C,), static mode
  bool has_affine, in_relu, dynamic;
};

__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

// u of channels c0 .. c0 + 7 of one pixel of sample s (one 16-byte load of
// bf16 x) after the affine (in bf16) and ReLU
__device__ __forceinline__ void transform8(uint4 v, const Quant& qt, int s,
                                           int c0, int C, float (&u)[8]) {
  const unsigned words[4] = {v.x, v.y, v.z, v.w};
  float sc[8], bi[8];
  if (qt.has_affine) {
    load8(qt.in_scale + (size_t)s * C + c0, sc);
    load8(qt.in_bias + (size_t)s * C + c0, bi);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    u[k] = (k % 2 == 0) ? bf16_lo(words[k / 2]) : bf16_hi(words[k / 2]);
    if (qt.has_affine)
      u[k] = affine_bf16(u[k], bf16_round(sc[k]), bf16_round(bi[k]));
    if (qt.in_relu) u[k] = fmaxf(u[k], 0.f);
  }
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

// rowmax[s, r] = max |u| over row r of sample s, all columns and channels.
// One block per (row, sample): a chunk's max is the max of its rows'.
__global__ void __launch_bounds__(256)
row_absmax_kernel(const bf16* __restrict__ x, Quant qt,
                  float* __restrict__ rowmax, int H, int W, int C) {
  __shared__ float red[8];
  const int r = blockIdx.x;
  const int s = blockIdx.y;
  const bf16* xr = x + ((size_t)s * H + r) * W * C;
  const int groups = C / 8;
  float m = 0.f;
  for (int e = threadIdx.x; e < W * groups; e += 256) {
    float u[8];
    transform8(*reinterpret_cast<const uint4*>(xr + (size_t)e * 8), qt, s,
               (e % groups) * 8, C, u);
#pragma unroll
    for (int k = 0; k < 8; ++k) m = fmaxf(m, fabsf(u[k]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < 8; ++i) m = fmaxf(m, red[i]);
    rowmax[(size_t)s * H + r] = m;
  }
}

// m_raw[s, r] = the max of rowmax over chunk r's padded rows r * ch - 1 ..
// r * ch + ch (the reflected halo rows are image rows, the zero ones add
// nothing). One thread per (sample, chunk).
__global__ void chunk_max_kernel(const float* __restrict__ rowmax,
                                 float* __restrict__ m_raw, int S, int H,
                                 int ch, int n_chunks, bool reflect) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= S * n_chunks) return;
  const int s = b / n_chunks, r = b % n_chunks;
  float m = 0.f;
  for (int k = 0; k < ch + 2; ++k) {
    const int src = src_index(r * ch - 1 + k, H, reflect);
    if (src >= 0) m = fmaxf(m, rowmax[(size_t)s * H + src]);
  }
  m_raw[b] = m;
}

// qb[(s * n_chunks + r), i, j, c] = q of padded position (row r * ch - 1 +
// i, column j - 1, channel c) at chunk r's scale; zero where the padding is
// zero and past C. Block row y = (s * n_chunks + r) * (ch + 2) + i, a few
// per CTA; one thread per 8 channels of a block pixel.
__global__ void __launch_bounds__(256)
quantize_blocks_kernel(const bf16* __restrict__ x, Quant qt,
                       const float* __restrict__ m_raw,
                       int8_t* __restrict__ qb, int S, int H, int W, int C,
                       int Cp, int ch, int n_chunks, bool reflect) {
  const int groups = Cp / 8;
  const int n_rows = S * n_chunks * (ch + 2);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (W + 2) * groups) return;
  const int j = t / groups, g = t % groups;
  const int c0 = 8 * g;
  const int gc = src_index(j - 1, W, reflect);
  float inv[8];
  if (!qt.dynamic && c0 < C) load8(qt.inv_a + c0, inv);
  for (int y = blockIdx.y; y < n_rows; y += gridDim.y) {
    const int b = y / (ch + 2), i = y % (ch + 2);
    const int s = b / n_chunks, r = b % n_chunks;
    const int gr = src_index(r * ch - 1 + i, H, reflect);
    uint2 out = make_uint2(0u, 0u);
    if (gr >= 0 && gc >= 0 && c0 < C) {
      float u[8];
      transform8(*reinterpret_cast<const uint4*>(
                     x + (((size_t)s * H + gr) * W + gc) * C + c0),
                 qt, s, c0, C, u);
      const float inva_dyn =
          qt.dynamic ? bf16_round(127.f / fmaxf(m_raw[b], 1e-12f)) : 0.f;
      int qv[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float inva = qt.dynamic ? inva_dyn : bf16_round(inv[k]);
        qv[k] = quantize(u[k] * inva);   // exact product of two bf16 values
      }
      out.x = pack_s8x4(qv[0], qv[1], qv[2], qv[3]);
      out.y = pack_s8x4(qv[4], qv[5], qv[6], qv[7]);
    }
    *reinterpret_cast<uint2*>(qb + ((size_t)y * (W + 2) + j) * Cp + c0) = out;
  }
}

}  // namespace

extern "C" {

int conv3x3_stats_int8_num_tiles(int H, int W) {
  return conv3x3_wgmma::num_tiles(H, W);
}

// Bytes of the packed-weight workspace and of the quantized blocks that
// conv3x3_stats_int8 takes (ch: the chunk height, as below).
long conv3x3_stats_int8_wpack_bytes(int C) {
  return conv3x3_wgmma::wpack_bytes<G8>(C, C);
}

long conv3x3_stats_int8_qblock_bytes(int S, int H, int W, int C, int ch) {
  return (long)S * (H / ch) * (ch + 2) * (W + 2) *
         conv3x3_wgmma::s8_block_channels(C);
}

// Launches the row max pass (dynamic mode), the quantize pass, the weight
// pack, the conv and the stats reduction on `stream`; returns the
// cudaError_t of the launches (0 on success; 1000 + a CUresult if the
// blocks' TMA tensor map was refused). w_q is int8 HWIO; wpack and qblocks
// are 16-byte aligned workspaces of the *_bytes above; m_raw (S, n_chunks)
// and rowmax (S, H) are f32 scratch, used only in dynamic mode; inv_a may
// be null in dynamic mode; in_scale/in_bias may be null when has_affine is
// 0; in_scale, in_bias and inv_a 16-byte aligned. ch is the dynamic chunk
// height: 16, or H when H < 16; H % ch == 0.
int conv3x3_stats_int8(const void* x, const void* w_q, void* wpack,
                       void* qblocks, const float* deq, const float* inv_a,
                       const float* in_scale, const float* in_bias, void* y,
                       float* m_raw, float* rowmax, float* partial,
                       float* stats, int S, int H, int W, int C, int ch,
                       int reflect, int has_affine, int in_relu, int dynamic,
                       void* stream) {
  if (C % 8 != 0 || ch <= 0 || H % ch != 0 ||
      !(ch == CHUNK || (ch == H && H < CHUNK)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const Quant qt{in_scale, in_bias, inv_a, has_affine != 0, in_relu != 0,
                 dynamic != 0};
  const int n_chunks = H / ch;
  const int Cp = conv3x3_wgmma::s8_block_channels(C);
  cudaError_t err;
  if (dynamic) {
    row_absmax_kernel<<<dim3(H, S), 256, 0, st>>>(xb, qt, rowmax, H, W, C);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    chunk_max_kernel<<<(S * n_chunks + 127) / 128, 128, 0, st>>>(
        rowmax, m_raw, S, H, ch, n_chunks, reflect != 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // a CTA quantizes 4 block rows of 256 8-channel groups
  const int n_rows = S * n_chunks * (ch + 2);
  const int rows_y = (n_rows + 3) / 4;
  const dim3 grid(((W + 2) * (Cp / 8) + 255) / 256,
                  rows_y < 65535 ? rows_y : 65535);
  quantize_blocks_kernel<<<grid, 256, 0, st>>>(
      xb, qt, m_raw, static_cast<int8_t*>(qblocks), S, H, W, C, Cp, ch,
      n_chunks, reflect != 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the blocks hold the affine, the ReLU and the padding
  return conv3x3_wgmma::launch<G8>(
      qblocks, static_cast<const int8_t*>(w_q), wpack, nullptr, nullptr,
      static_cast<bf16*>(y), partial, stats, S, H, W, C, C, false, false,
      false, st, conv3x3_wgmma::Dequant{deq, m_raw, n_chunks, dynamic != 0});
}

}  // extern "C"
