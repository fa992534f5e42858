// int8 x int8 -> int32 convolution with a fused dequantizing epilogue, for
// every quantized conv of int8 scope 'all' outside the fused trunk kernel,
// on Hopper (sm_90a).
//
// Replaces XLA's int8 conv_general_dilated of deepliif_tpu/nets/layers.py
// conv2d (:114-124) and conv_transpose2d (:500-510): not a Pallas kernel,
// but PyTorch has no int8 convolution on CUDA to hand it to. One implicit
// GEMM covers the four kinds of the flagship's int8 forward and the unfused
// trunk: 3x3 stride 2 (the translators' down convs), 4x4 stride 2 (the
// U-Nets' down convs), the conv-transposes 3x3 and 4x4 stride 2 (input
// dilation 2), and 3x3 stride 1 (the unfused trunk). For x_q (N, H, W,
// Cin) int8 NHWC and w (KH, KW, Cout, Cin) int8 (the HWIO weights with Cin
// innermost, packed by the wrapper):
//
//   acc[n, oy, ox, co] = sum over taps (ky, kx) and ci of
//                        x_q[n, iy, ix, ci] * w[ky, kx, co, ci]     (int32)
//   iy = (oy * stride + ky - pad_h) / dil, kept where that is an integer
//        in [0, H) (ix likewise); dil 2 is the conv-transpose's input
//        dilation, whose zero taps are skipped, never multiplied
//   y = bf16(f32(acc) * deq[n?, co]) (+ bf16 bias, rounded to bf16)
//
// the rounding points of layers.conv2d's int8 route: the f32 product
// rounded once, then to the output dtype, then the bias added in it. A
// float32 output skips the bf16 rounding (fmul and fadd without FMA
// contraction). The int32 sums are exact (|acc| <= 127^2 * 16 taps * 1024
// channels < 2^31), so the kernel is bit-equal to its plain version
// (ops/conv_int8.py: a float64 conv of the int8 values) and independent of
// the batch: no float atomics, no split of K across blocks.
//
// Design (a simple kernel that is right; its wgmma redesign is ROADMAP Queue
// 2b): block tile 128 output pixels x 64 output channels, 8 warps of 32 x
// 32, K in stages of one tap x 64 input channels; mma.sync m16n8k32 s8
// (16 per warp and stage); a 3-stage cp.async ring with zero fill for the
// padding, the skipped rows and the channel tail (Cin % 64); the 16-byte
// chunks of a 64-byte smem row XOR-swizzled by (row >> 1) & 3, so the
// fragment loads (8 rows x 4 words a quad) hit 32 distinct banks. A
// conv-transpose runs its dil x dil output phases as grid.z: every pixel of
// a block has the same taps, so no tap is tested per pixel. What bounds it
// on the H100: int8 tensor-core operations at the flagship's large convs
// (several GOP per call against tens of MB moved), where mma.sync reaches
// a fraction of wgmma's rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 128;       // output pixels of a block
constexpr int BN = 64;        // output channels of a block
constexpr int BK = 64;        // input channels (bytes) of a stage
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int A_BYTES = BM * BK;
constexpr int B_BYTES = BN * BK;
constexpr int SMEM_BYTES = STAGES * (A_BYTES + B_BYTES);

struct Params {
  const int8_t* x;        // (N, H, W, Cin)
  const int8_t* wgt;      // (KH, KW, Cout, Cin)
  const float* deq;       // (Cout), or (N, Cout) when deq_per_sample
  const void* bias;       // (Cout) in the output dtype, or null
  void* y;                // (N, HO, WO, Cout), bf16 or float32
  int n, h, w, cin, ho, wo, cout;
  int kh, kw, stride, dil, pad_h, pad_w;
  int deq_per_sample, out_f32;
};

// byte offset of (row, byte) in a 64-byte smem row, 16-byte chunks swizzled
__device__ __forceinline__ int swz(int row, int byte) {
  return row * BK + ((((byte >> 4) ^ (row >> 1)) & 3) << 4) + (byte & 15);
}

// -- PTX wrappers ----------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `bytes` 0 writes 16 zero bytes (src unread)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a (16 x 32 s8, row) * b (32 x 8 s8, col), int32 accumulators
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// -------------------------------------------------------------------------

__device__ __forceinline__ uint32_t lds32(const uint8_t* base, int off) {
  return *reinterpret_cast<const uint32_t*>(base + off);
}

// the taps of output phase p along one axis: first tap and count
__device__ __forceinline__ void phase_taps(int k, int dil, int pad, int p,
                                           int& k0, int& nk) {
  k0 = ((pad - p) % dil + dil) % dil;
  nk = k0 < k ? (k - k0 + dil - 1) / dil : 0;
}

__global__ void __launch_bounds__(THREADS)
    conv_s8_kernel(const Params P) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* sA = smem;
  uint8_t* sB = smem + STAGES * A_BYTES;

  const int tid = threadIdx.x;
  const int py = blockIdx.z / P.dil, px = blockIdx.z % P.dil;
  // output pixels of this phase: oy = py + dil * i, ox = px + dil * j
  const int hp = P.ho > py ? (P.ho - py + P.dil - 1) / P.dil : 0;
  const int wp = P.wo > px ? (P.wo - px + P.dil - 1) / P.dil : 0;
  const long long m_phase = static_cast<long long>(P.n) * hp * wp;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  if (m0 >= m_phase) return;               // the whole block: no barrier yet
  const int n0 = blockIdx.y * BN;

  int ky0, nty, kx0, ntx;
  phase_taps(P.kh, P.dil, P.pad_h, py, ky0, nty);
  phase_taps(P.kw, P.dil, P.pad_w, px, kx0, ntx);
  const int nck = (P.cin + BK - 1) / BK;
  const int nsteps = nty * ntx * nck;

  // loader roles: A rows tid / 4 and tid / 4 + 64, B row tid / 4; all at
  // 16-byte chunk tid % 4 of the stage's 64 channels
  const int chunk = tid & 3;
  int a_n[2], a_y[2], a_x[2];
  bool a_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long m = m0 + (tid >> 2) + r * 64;
    a_ok[r] = m < m_phase;
    const long long mm = a_ok[r] ? m : 0;
    const int per = hp * wp;
    a_n[r] = static_cast<int>(mm / per);
    const int rem = static_cast<int>(mm % per);
    // position in the dilated input before the tap offset
    a_y[r] = (py + P.dil * (rem / wp)) * P.stride - P.pad_h;
    a_x[r] = (px + P.dil * (rem % wp)) * P.stride - P.pad_w;
  }
  const int b_co = n0 + (tid >> 2);

  auto load = [&](int step, int buf) {
    const int tap = step / nck, cc = step % nck;
    const int ky = ky0 + P.dil * (tap / ntx), kx = kx0 + P.dil * (tap % ntx);
    const int c = cc * BK + chunk * 16;
    const bool c_ok = c < P.cin;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = (tid >> 2) + r * 64;
      const int dy = a_y[r] + ky, dx = a_x[r] + kx;
      // dy, dx are multiples of dil here (the phase's taps), so the
      // divisions are exact
      const int iy = dy / P.dil, ix = dx / P.dil;
      const bool ok = a_ok[r] && c_ok && dy >= 0 && dx >= 0 && iy < P.h &&
                      ix < P.w;
      const int8_t* src =
          ok ? P.x + ((static_cast<long long>(a_n[r]) * P.h + iy) * P.w + ix) *
                         P.cin + c
             : P.x;
      cp_async16(sA + buf * A_BYTES + swz(row, chunk * 16), src, ok ? 16 : 0);
    }
    {
      const int row = tid >> 2;
      const bool ok = c_ok && b_co < P.cout;
      const int8_t* src =
          ok ? P.wgt + (static_cast<long long>(ky * P.kw + kx) * P.cout +
                        b_co) * P.cin + c
             : P.wgt;
      cp_async16(sB + buf * B_BYTES + swz(row, chunk * 16), src, ok ? 16 : 0);
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 32;
  const int g = lane >> 2, t = lane & 3;
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // refill the slot that step s - 1 used: every thread is past it
    const int nxt = s + STAGES - 1;
    if (nxt < nsteps) load(nxt, nxt % STAGES);
    cp_async_commit();
    const uint8_t* a_s = sA + (s % STAGES) * A_BYTES;
    const uint8_t* b_s = sB + (s % STAGES) * B_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + i * 16 + g;
        a[i][0] = lds32(a_s, swz(r, kk + t * 4));
        a[i][1] = lds32(a_s, swz(r + 8, kk + t * 4));
        a[i][2] = lds32(a_s, swz(r, kk + 16 + t * 4));
        a[i][3] = lds32(a_s, swz(r + 8, kk + 16 + t * 4));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = wn + j * 8 + g;
        b[j][0] = lds32(b_s, swz(r, kk + t * 4));
        b[j][1] = lds32(b_s, swz(r, kk + 16 + t * 4));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
  }
  cp_async_wait<0>();

  // epilogue: acc (row g / g + 8, channels 2t, 2t + 1 of each n8 tile)
  const int per = hp * wp;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + wm + i * 16 + g + half * 8;
      if (m >= m_phase) continue;
      const int nb = static_cast<int>(m / per);
      const int rem = static_cast<int>(m % per);
      const int oy = py + P.dil * (rem / wp), ox = px + P.dil * (rem % wp);
      const long long pix =
          (static_cast<long long>(nb) * P.ho + oy) * P.wo + ox;
      const float* deq = P.deq + (P.deq_per_sample ? nb * P.cout : 0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = n0 + wn + j * 8 + t * 2 + e;
          if (co >= P.cout) continue;
          const float v = __fmul_rn(static_cast<float>(acc[i][j][half * 2 + e]),
                                    deq[co]);
          if (P.out_f32) {
            float o = v;
            if (P.bias) o = __fadd_rn(o, static_cast<const float*>(P.bias)[co]);
            static_cast<float*>(P.y)[pix * P.cout + co] = o;
          } else {
            __nv_bfloat16 o = __float2bfloat16_rn(v);
            if (P.bias)
              o = __float2bfloat16_rn(
                  __bfloat162float(o) +
                  __bfloat162float(
                      static_cast<const __nv_bfloat16*>(P.bias)[co]));
            static_cast<__nv_bfloat16*>(P.y)[pix * P.cout + co] = o;
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 on
// success; cudaErrorInvalidValue for a shape the kernel does not take: Cin
// % 16, Cout % 8, a stride or a dilation other than 1 with the other 1,
// 16-byte misaligned x or w). Arguments as in Params; the wrapper
// (ops/conv_int8.py) computes HO, WO and the padding and packs w.
int conv_s8(const void* x, const void* w, const float* deq, const void* bias,
            void* y, int n, int h, int wd, int cin, int ho, int wo, int cout,
            int kh, int kw, int stride, int dil, int pad_h, int pad_w,
            int deq_per_sample, int out_f32, void* stream) {
  if (cin % 16 || cout % 8 || stride < 1 || dil < 1 ||
      (stride > 1 && dil > 1) || n < 1 || ho < 1 || wo < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Params P{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), deq,
           bias, y, n, h, wd, cin, ho, wo, cout, kh, kw, stride, dil, pad_h,
           pad_w, deq_per_sample, out_f32};
  const int hp = (ho + dil - 1) / dil, wp = (wo + dil - 1) / dil;
  const long long m = static_cast<long long>(n) * hp * wp;
  dim3 grid(static_cast<unsigned>((m + BM - 1) / BM), (cout + BN - 1) / BN,
            dil * dil);
  conv_s8_kernel<<<grid, THREADS, SMEM_BYTES,
                   static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
