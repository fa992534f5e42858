// Quantize -> int8 x int8 -> int32 convolution -> dequantize, for every
// quantized conv of int8 scope 'all' outside the fused trunk kernel, on
// Hopper (sm_90a): the activation arrives in bf16 and is quantized while it
// is loaded, so no int8 activation tensor exists.
//
// Replaces the JAX package's int8 route of deepliif_tpu/nets/layers.py
// conv2d (:114-124) and conv_transpose2d (:500-510): the activation
// quantize (_quant_act :83-99, _quant_act_int8 :158-174) and XLA's int8
// conv_general_dilated, which is not a Pallas kernel. For x (N, H, W, Cin)
// bf16 NHWC and the HWIO int8 kernel w_q:
//
//   static:  q = clip(rint(bf16(x * inv_a[ci])), +-127)    inv_a bf16
//   dynamic: s[n] = max(max |x[n]| / 127, 1e-12) (f32, a true division)
//            q = clip(rint(bf16(f32(x) / f32(bf16(s[n])))), +-127)
//   acc[n, oy, ox, co] = sum over taps (ky, kx) and ci of
//            q[n, iy, ix, ci] * w_q[ky, kx, ci, co]                  (int32)
//   y = bf16(f32(acc) * deq) (+ bf16 bias, added in bf16)
//            deq = w_s[co] (static), s[n] * w_s[co] (dynamic, one f32
//            product)
//
// with iy = (oy * stride + ky - pad_h) / dil where that is an integer in
// [0, H) (dil 2: a conv-transpose's input dilation, whose zero taps are
// skipped). The product of two bf16 values is exact in f32 and rounded
// once to bf16 (__hmul2_rn); the division is __fdiv_rn (never a
// reciprocal; the build has no --use_fast_math). The int32 sums are exact
// (|acc| <= 127^2 * 16 taps * 1024 channels < 2^31), so y is bit-equal to
// the plain version (ops/conv_int8.py: torch's quantize, a float64 conv of
// the int8 values, the same epilogue) whatever the order of the sums, and
// does not depend on the batch.
//
// What bounds it on the H100: the flagship's large calls move bytes (the
// translator's down0, (16, 512, 512, 64) -> 128: 537 MB of bf16 x read and
// 268 MB of y written, 0.240 ms at 3.35 TB/s, against 0.078 ms of s8
// tensor-core work); its inner U-Net calls move their weights (up to 8 MB
// for 16-1024 output pixels) or are s8 operations. So x is read in bf16
// and quantized on the way into shared memory (four torch passes over x
// and an int8 copy of it cost more than the conv), and:
//  * the weights are packed once per session (ops/quant.pack_s8_weights):
//    per (tap, 32-channel step) every output channel's 32 input channels
//    as the K-major core matrices of the wgmma B descriptor, so that BN
//    output channels are BN x 32 contiguous bytes, one bulk copy;
//  * every kind is one loop over taps: an output phase (a conv has one, a
//    conv-transpose four) is a stride-S conv whose taps (ty, tx) are
//    contiguous offsets (oy0 + ty, ox0 + tx) from (S i, S j), weight tap
//    (ky0 + dil ty, kx0 + dil tx); the dilation's zero taps never occur;
//  * the slab mode (plan_slab; the calls whose phase grid is 8 columns
//    wide or more, with an item for every SM): an item is ti x tj
//    positions of one sample's phase grid and every phase, its slab the
//    input they read, in S x S planes by row and column parity, each plane
//    row 16-byte pixels of one 16-channel half (K-major, so that 8 pixels
//    are a core matrix): any tap's A operand is then 64 consecutive plane
//    pixels from an offset, one descriptor, whatever the stride. Warps 0-6
//    load the slab's bf16 per 32-channel chunk (all of a thread's 16-byte
//    loads in flight together), quantize it once and store the s8 chunk;
//    warp 7 issues the weights, a bulk copy per tap of a kernel row, into
//    an 8-slot ring; two consumer warpgroups run wgmma m64nBNk32 s32.s8.s8,
//    both operands in shared memory, each warpgroup its m64 blocks of the
//    item: a block is one row of 64 columns where the grid's width is a
//    multiple of 64, else 64 consecutive positions a PW + b of rows of the
//    plane's pitch, the columns past the grid computed and dropped. Items
//    run every pass (phase, 64- or 128-channel block) on one slab held for
//    all of them (two items' slabs where they fit: the producers an item
//    ahead); where the chunks do not fit (C_in 1024), one pass per item on
//    a ring of chunk slots, the slab quantized again per pass;
//  * the gather mode (the rest: the U-Nets' 1-4 pixel levels): M = output
//    pixels of a phase flattened over the batch, K in steps of one tap x
//    32 channels; each of 256 producer threads gathers its rows' bf16 by
//    cp.async (zero fill for the padding, the skipped taps, the channel
//    tail), quantizes its own copies when they landed and stores them as
//    16-byte chunks of the A slot (unit u at byte 16 u: a quarter warp
//    writes 128 contiguous bytes); one consumer warpgroup; a call with
//    fewer items than SMs splits K across CTAs, adds its int32 sums into a
//    zeroed workspace with integer atomics (exact, so the order does not
//    matter) and a second pass applies the epilogue. No float atomics;
//  * dynamic scales: a first pass (conv_s8_absmax_kernel) reads x once in
//    bf16 and takes the per-sample max of |x| as an integer atomicMax on
//    the bits of the bf16 magnitudes (order-free, deterministic). The slab
//    mode's items hold one sample, so their quantized values come from a
//    table per sample of q at each of the 1280 bf16 magnitudes where it is
//    neither 0 nor 127 (qtab_entry, by __fdiv_rn); the gather mode divides
//    per element;
//  * the mbarriers take one arrival per warp (a shared-memory atomic per
//    thread serialized a step); the packed weights' output channels are
//    permuted within each block so that the accumulator layout gives a
//    thread BN / 4 consecutive channels (the slab mode's epilogue stores
//    16 bytes at a time, whole 32-byte sectors a quad of lanes), and reads
//    the weights' scales and the bias from shared memory; CTAs are
//    persistent, one per SM.
// What is left on the table (ROADMAP): barriers, loops and addresses are
// a quarter to a half of a call (experiments/torch_conv_s8_parts.py); the
// slab mode runs its epilogue between passes, with the tensor cores idle;
// a conv-transpose at C_in 1024 quantizes its slab once per pass; ptxas
// serializes the gather mode's dynamic wgmmas (C7518).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

#include "conv3x3_wgmma.cuh"   // PTX wrappers: mbarriers, bulk copy, wgmma

namespace {

using bf16 = __nv_bfloat16;
using namespace conv3x3_wgmma;

constexpr int NT = 384;              // two producer, one consumer warpgroup
constexpr int PT = 256;              // producer threads
constexpr int CT = 128;              // consumer threads
constexpr int KC = 32;               // input channels of a step
constexpr int CIN_MAX = 2048;        // static scales staged in shared memory
constexpr int INV_BYTES = CIN_MAX * 2;
constexpr int COUT_MAX = 2048;       // the slab mode's scales in shared memory
constexpr int MAX_PHASES = 4;
constexpr int MIN_SPLIT_STEPS = 4;   // steps of a K split, at least

template <int BN_, int MT_, bool DYN_>
struct Cfg {
  static constexpr int BN = BN_;               // output channels of an item
  static constexpr int MT = MT_;               // m64 tiles of an item
  static constexpr int BM = 64 * MT;           // output pixels of an item
  static constexpr bool DYN = DYN_;
  static constexpr int U = BM / (PT / 2);      // units per producer thread
  static constexpr int NSTG = U == 1 ? 6 : 4;  // steps staged ahead
  // A / B ring slots: the weights of step g + NSTG are issued once the
  // consumers released step g + NSTG - NSA, far enough back that the
  // producers do not wait on the consumers' round trip
  static constexpr int NSA = U == 1 ? 14 : 12;
  static constexpr int A_BYTES = BM * KC;
  static constexpr int B_BYTES = BN * KC;
  static constexpr int SLOT = A_BYTES + B_BYTES;
  static constexpr int STG_BYTES = BM * KC * 2;
  static constexpr int SMEM =
      NSA * SLOT + NSTG * STG_BYTES + INV_BYTES + 2 * NSA * 8;
  static_assert(MT * BN <= 256, "accumulators of one consumer thread");
  static_assert(U >= 1, "a unit per producer thread at least");
  static_assert(SMEM <= 232448, "the shared memory of one block");
};

// One output phase (a conv has one; a conv-transpose of input dilation 2
// has four): output pixel (n, i, j) is (oy, ox) = (py + dil i, px + dil j);
// its tap (ty, tx) < (nty, ntx) reads input (stride i + oy0 + ty, stride j
// + ox0 + tx) with weight tap (ky0 + dil ty, kx0 + dil tx).
struct Phase {
  int nty, ntx, ky0, kx0, oy0, ox0, py, px, hp, wp;
  int m_tiles;   // BM tiles of its n hp wp pixels
  int item0;     // its first item
};

// The slab mode's geometry (plan_slab): an item is ti phase-grid rows x tj
// columns of one sample, every phase and channel block; its slab is the
// input that those outputs read, in S x S planes by row and column parity
// (S: the stride of a phase), each PH x PW pixels, quantized once per item.
struct Slab {
  int s, nti, ntj, npass;     // stride; row and column tiles; passes
  int ti, tj;                 // an item's phase-grid rows and columns
  int bstride;                // positions between its m64 blocks
  int oy_min, ox_min;         // the slab's origin from (S i0, S j0)
  int ph, pw, npix, npixp;    // plane rows, columns; pixels (padded to 8)
  int ru;                     // units per producer thread and chunk
  int chunk_bytes;            // one 32-channel chunk of the slab
  int nr;                     // chunk slots of the slab ring
  int ppi, npg;               // passes per item, items per tile
  int b_slot_bytes, nsb;      // the weights' ring
  int rps, nt;                // kernel rows and taps of a weights stage
  int inv_off, ws_off, bias_off, qtab_off, zero_off, tab_off, slab_off;
  int b_off, smem;
};

struct Params {
  const bf16* x;         // (n, h, w, cin)
  const int8_t* wpk;     // (kh, kw, nkc, cout_pad * 32), pack_s8_weights
  const float* w_s;      // (cout)
  const bf16* inv;       // (cin) static, else null
  const float* amax;     // (n) max |x| per sample, dynamic, else null
  const bf16* bias;      // (cout) or null
  bf16* y;               // (n, ho, wo, cout)
  int* ws;               // (n, ho, wo, cout) int32 zeroed, split > 1
  int n, h, w, cin, ho, wo, cout, cout_pad, kw, stride, dil;
  int nkc, nb, split, n_phase, n_items;
  Phase ph[MAX_PHASES];
  Slab sl;
};

// One item: phase p, row tile mt, channel block nb, steps [k_lo, k_hi) of
// the phase's taps x nkc.
struct Item {
  int p, mt, nb, k_lo, k_hi;
};

__device__ __forceinline__ Item item_of(const Params& P, int it) {
  int p = 0;
  while (p + 1 < P.n_phase && it >= P.ph[p + 1].item0) ++p;
  const Phase& f = P.ph[p];
  int rest = it - f.item0;
  Item q;
  q.p = p;
  q.nb = rest % P.nb;
  rest /= P.nb;
  q.mt = rest % f.m_tiles;
  const int sk = rest / f.m_tiles;
  const int nk = f.nty * f.ntx * P.nkc;
  q.k_lo = static_cast<int>(static_cast<long long>(sk) * nk / P.split);
  q.k_hi = static_cast<int>(static_cast<long long>(sk + 1) * nk / P.split);
  return q;
}

// A CTA's steps in order: items blockIdx.x, + gridDim.x, ... (those with
// steps), each from k_lo to k_hi.
struct Cursor {
  int it, k;
  Item q;
};

__device__ __forceinline__ void seek(const Params& P, Cursor& c) {
  while (c.it < P.n_items) {
    c.q = item_of(P, c.it);
    if (c.q.k_lo < c.q.k_hi) break;
    c.it += gridDim.x;
  }
  c.k = c.q.k_lo;
}

__device__ __forceinline__ Cursor cursor_start(const Params& P) {
  Cursor c;
  c.it = blockIdx.x;
  c.q = Item{0, 0, 0, 0, 0};
  seek(P, c);
  return c;
}

// advances; returns true when the cursor entered a new item
__device__ __forceinline__ bool cursor_next(const Params& P, Cursor& c) {
  if (++c.k < c.q.k_hi) return false;
  c.it += gridDim.x;
  seek(P, c);
  return true;
}

// ---- the tensor-core step: wgmma with A and B K-major in shared memory

// d[32] = A (m64 x k32, s8, K-major in shared memory) * B (k32 x n64, s8,
// K-major in shared memory) + (accumulate ? d : 0), s32 (exact).
__device__ __forceinline__ void wgmma_ss(int (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n"
      "}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64] = A (m64 x k32, s8, K-major in shared memory) * B (k32 x n128, s8,
// K-major in shared memory) + (accumulate ? d : 0), s32 (exact).
__device__ __forceinline__ void wgmma_ss(int (&d)[64], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// ---- per-element arithmetic

// s = max(amax / 127, 1e-12), the per-sample scale (ops/quant.py
// quant_act_dynamic: a true division, then the clamp)
__device__ __forceinline__ float dyn_scale(float amax) {
  return fmaxf(__fdiv_rn(amax, 127.f), 1e-12f);
}

// The bf16 pair p (clipped to +-127, integral after rounding) -> its two
// values rounded half to even as the low byte of each: adding 1.5 * 2^23
// rounds a float of magnitude < 2^22 to an integer k in round-to-nearest-
// even, and leaves k in the low bits of the sum's encoding (0x4B400000 + k).
__device__ __forceinline__ uint32_t round_pair(__nv_bfloat162 p) {
  const __nv_bfloat162 lim = __floats2bfloat162_rn(127.f, 127.f);
  const __nv_bfloat162 nlim = __floats2bfloat162_rn(-127.f, -127.f);
  p = __hmin2(__hmax2(p, nlim), lim);
  const uint32_t w = *reinterpret_cast<uint32_t*>(&p);
  const uint32_t lo = __float_as_uint(__fadd_rn(__uint_as_float(w << 16),
                                                12582912.f));
  const uint32_t hi = __float_as_uint(
      __fadd_rn(__uint_as_float(w & 0xffff0000u), 12582912.f));
  return __byte_perm(lo, hi, 0x0040);   // bytes: lo.0, hi.0 (then don't care)
}

// 8 bf16 values (a uint4 of x) -> 8 s8 in a uint2. Static: times the bf16
// scales iv (the exact product rounded once to bf16); dynamic: divided by
// sb (bf16(s) in f32), the quotient rounded to f32, then to bf16.
template <bool DYN>
__device__ __forceinline__ uint2 quant8(uint4 v, uint4 iv, float sb) {
  const uint32_t xw[4] = {v.x, v.y, v.z, v.w};
  const uint32_t iw[4] = {iv.x, iv.y, iv.z, iv.w};
  uint32_t pr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 p;
    if constexpr (DYN) {
      const float a = __uint_as_float(xw[i] << 16);
      const float b = __uint_as_float(xw[i] & 0xffff0000u);
      p = __floats2bfloat162_rn(__fdiv_rn(a, sb), __fdiv_rn(b, sb));
    } else {
      p = __hmul2_rn(*reinterpret_cast<const __nv_bfloat162*>(&xw[i]),
                     *reinterpret_cast<const __nv_bfloat162*>(&iw[i]));
    }
    pr[i] = round_pair(p);
  }
  return make_uint2(__byte_perm(pr[0], pr[1], 0x5410),
                    __byte_perm(pr[2], pr[3], 0x5410));
}

// y's channel pair (co, co + 1) from their int32 sums: bf16(f32(acc) *
// deq), then + bias in bf16
__device__ __forceinline__ uint32_t out_pair(int a0, int a1, float d0,
                                             float d1, const bf16* bias,
                                             int co) {
  bf16 o0 = __float2bfloat16_rn(__fmul_rn(static_cast<float>(a0), d0));
  bf16 o1 = __float2bfloat16_rn(__fmul_rn(static_cast<float>(a1), d1));
  if (bias != nullptr) {
    o0 = __float2bfloat16_rn(
        __fadd_rn(__bfloat162float(o0), __bfloat162float(bias[co])));
    o1 = __float2bfloat16_rn(
        __fadd_rn(__bfloat162float(o1), __bfloat162float(bias[co + 1])));
  }
  return static_cast<uint32_t>(__bfloat16_as_ushort(o0)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(o1)) << 16);
}

// ---- the gather mode (the rest)

template <class G>
__global__ void __launch_bounds__(NT, 1)
    conv_s8_gather_kernel(const __grid_constant__ Params P) {
  extern __shared__ __align__(128) char smem[];
  char* ring = smem;                                 // NSA x (A | B)
  char* stg = smem + G::NSA * G::SLOT;               // NSTG x staging
  bf16* inv_s = reinterpret_cast<bf16*>(stg + G::NSTG * G::STG_BYTES);
  const uint32_t full0 = smem_u32(stg + G::NSTG * G::STG_BYTES + INV_BYTES);
  const uint32_t empty0 = full0 + 8 * G::NSA;
  const int t = threadIdx.x;
  if (t == 0) {
    for (int i = 0; i < G::NSA; ++i) {
      // one arrival per producer warp and the weights' tx; one per
      // consumer warp (a shared-memory atomic per thread serialized a step)
      mbar_init(full0 + 8 * i, PT / 32 + 1);
      mbar_init(empty0 + 8 * i, CT / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (!G::DYN) {
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int i = t; i < P.nkc * KC; i += NT)
      inv_s[i] = i < P.cin ? P.inv[i] : zero;
  }
  __syncthreads();

  if (t < PT) {
    // ---- producers
    const int mrow = ((t >> 4) << 3) + (t & 7);   // row of unit 0
    const int kc = (t >> 3) & 1;                  // its 16-channel half
    Cursor ic = cursor_start(P);                  // next step to issue
    Cursor cc = ic;                               // next step to quantize
    // the issue cursor's units: pixel base n h w, input row and column of
    // the phase's first tap (INT_MIN / 2: a row past M)
    int ub[G::U], uy[G::U], ux[G::U];
    float sb[G::U];   // the quantize cursor's units: bf16(s[n]) (dynamic)
    auto units = [&](const Item& q) {
      const Phase& f = P.ph[q.p];
      const int hw = f.hp * f.wp;
#pragma unroll
      for (int r = 0; r < G::U; ++r) {
        const int m = q.mt * G::BM + mrow + (PT / 2) * r;
        const int n = m / hw, rem = m - n * hw;
        const int i = rem / f.wp, j = rem - i * f.wp;
        const bool ok = n < P.n;
        ub[r] = ok ? n * P.h * P.w : 0;
        uy[r] = ok ? P.stride * i + f.oy0 : INT_MIN / 2;
        ux[r] = P.stride * j + f.ox0;
      }
    };
    auto scales = [&](const Item& q) {
      const Phase& f = P.ph[q.p];
      const int hw = f.hp * f.wp;
#pragma unroll
      for (int r = 0; r < G::U; ++r) {
        const int n = (q.mt * G::BM + mrow + (PT / 2) * r) / hw;
        sb[r] = n < P.n ? __bfloat162float(__float2bfloat16_rn(
                              dyn_scale(P.amax[n])))
                        : 1.f;
      }
    };
    if (ic.it < P.n_items) units(ic.q);
    if constexpr (G::DYN) {
      if (cc.it < P.n_items) scales(cc.q);
    }
    int gi = 0;   // the issue cursor's step number
    auto issue = [&]() {
      const int slot = gi % G::NSA;
      char* st = stg + (gi % G::NSTG) * G::STG_BYTES;
      const Phase& f = P.ph[ic.q.p];
      const int tap = ic.k / P.nkc, c = ic.k - tap * P.nkc;
      const int ty = tap / f.ntx, tx = tap - ty * f.ntx;
      if (t == 0) {   // the step's weights, once the slot is free
        if (gi >= G::NSA)
          mbar_wait(empty0 + 8 * slot, ((gi / G::NSA) - 1) & 1);
        const uint32_t full = full0 + 8 * slot;
        const int ky = f.ky0 + P.dil * ty, kx = f.kx0 + P.dil * tx;
        const long long off =
            (static_cast<long long>((ky * P.kw + kx) * P.nkc + c) *
                 P.cout_pad +
             static_cast<long long>(ic.q.nb) * G::BN) * KC;
        mbar_arrive_expect_tx(full, G::B_BYTES);
        bulk_copy_g2s(smem_u32(ring + slot * G::SLOT + G::A_BYTES),
                      P.wpk + off, G::B_BYTES, full);
      }
      const int ch = c * KC + kc * 16;
#pragma unroll
      for (int r = 0; r < G::U; ++r) {
        const int iy = uy[r] + ty, ix = ux[r] + tx;
        const bool ok =
            static_cast<unsigned>(iy) < static_cast<unsigned>(P.h) &&
            static_cast<unsigned>(ix) < static_cast<unsigned>(P.w);
        const bf16* src =
            ok ? P.x + static_cast<long long>(ub[r] + iy * P.w + ix) * P.cin +
                     ch
               : P.x;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          conv3x3::cp_async16(st + ((2 * r + hh) * PT + t) * 16, src + 8 * hh,
                              ok && ch + 8 * hh < P.cin);
      }
      if (cursor_next(P, ic) && ic.it < P.n_items) units(ic.q);
      ++gi;
    };
    for (int s = 0; s < G::NSTG; ++s) {
      if (ic.it < P.n_items) issue();
      conv3x3::cp_async_commit();
    }
    for (int g = 0; cc.it < P.n_items; ++g) {
      cp_async_wait<G::NSTG - 1>();   // this thread's copies of step g
      const int slot = g % G::NSA;
      if (g >= G::NSA) mbar_wait(empty0 + 8 * slot, ((g / G::NSA) - 1) & 1);
      const char* st = stg + (g % G::NSTG) * G::STG_BYTES;
      char* a = ring + slot * G::SLOT;
      const int c = cc.k % P.nkc;
      uint4 iv0 = make_uint4(0u, 0u, 0u, 0u), iv1 = iv0;
      if constexpr (!G::DYN) {
        const uint4* ip =
            reinterpret_cast<const uint4*>(inv_s + c * KC + kc * 16);
        iv0 = ip[0];
        iv1 = ip[1];
      }
#pragma unroll
      for (int r = 0; r < G::U; ++r) {
        const uint4 v0 =
            *reinterpret_cast<const uint4*>(st + ((2 * r) * PT + t) * 16);
        const uint4 v1 =
            *reinterpret_cast<const uint4*>(st + ((2 * r + 1) * PT + t) * 16);
        const float s = G::DYN ? sb[r] : 0.f;
        const uint2 q0 = quant8<G::DYN>(v0, iv0, s);
        const uint2 q1 = quant8<G::DYN>(v1, iv1, s);
        *reinterpret_cast<uint4*>(a + (t + PT * r) * 16) =
            make_uint4(q0.x, q0.y, q1.x, q1.y);
      }
      fence_proxy_async();   // the A chunks, before the tensor cores read them
      __syncwarp();          // the warp's chunks, before its lane 0 arrives
      if ((t & 31) == 0) mbar_arrive(full0 + 8 * slot);
      if (ic.it < P.n_items) issue();
      conv3x3::cp_async_commit();
      if (cursor_next(P, cc) && cc.it < P.n_items) {
        if constexpr (G::DYN) scales(cc.q);
      }
    }
    cp_async_wait<0>();
  } else {
    // ---- consumers
    const int wq = ((t - PT) >> 5) & 3;    // warp of the warpgroup
    const int lane = t & 31;
    int acc[G::MT][G::BN / 2];
#pragma unroll
    for (int j = 0; j < G::MT; ++j)
#pragma unroll
      for (int i = 0; i < G::BN / 2; ++i) acc[j][i] = 0;
    auto release = [&](int slot) {
      __syncwarp();
      if ((t & 31) == 0) mbar_arrive(empty0 + 8 * slot);
    };
    Cursor cc = cursor_start(P);
    int prev = -1;   // the slot whose wgmmas may still be running
    for (int g = 0; cc.it < P.n_items; ++g) {
      const int slot = g % G::NSA;
      mbar_wait(full0 + 8 * slot, (g / G::NSA) & 1);
      const uint32_t a_s = smem_u32(ring + slot * G::SLOT);
      const uint64_t db = desc_kmajor(a_s + G::A_BYTES);
      const int first = cc.k == cc.q.k_lo;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < G::MT; ++j)
        wgmma_ss(acc[j], desc_kmajor(a_s + j * 2048), db, !first);
      wgmma_commit();
      if (cc.k < cc.q.k_hi - 1) {   // keep this step's wgmmas in flight
        wgmma_wait<1>();
        if (prev >= 0) release(prev);
        prev = slot;
      } else {
        wgmma_wait<0>();
#pragma unroll
        for (int j = 0; j < G::MT; ++j) fence_regs(acc[j]);
        if (prev >= 0) release(prev);
        release(slot);
        prev = -1;
        // epilogue: d[i] of row 16 wq + lane / 4 + 8 ((i / 2) % 2), column
        // 8 (i / 4) + 2 (lane % 4) + i % 2 of each m64 tile
        const Item& q = cc.q;
        const Phase& f = P.ph[q.p];
        const int hw = f.hp * f.wp;
#pragma unroll
        for (int j = 0; j < G::MT; ++j) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int m = q.mt * G::BM + j * 64 + 16 * wq + (lane >> 2) +
                          8 * hh;
            const int n = m / hw;
            if (n >= P.n) continue;
            const int rem = m - n * hw;
            const int i = rem / f.wp, jj = rem - i * f.wp;
            const long long pix =
                (static_cast<long long>(n) * P.ho + f.py + P.dil * i) * P.wo +
                f.px + P.dil * jj;
            const float sn = G::DYN ? dyn_scale(P.amax[n]) : 0.f;
#pragma unroll
            for (int v = 0; v < G::BN / 8; ++v) {
              // the packed weights' column order (quant.pack_s8_weights)
              const int co = q.nb * G::BN + (lane & 3) * (G::BN / 4) + 2 * v;
              if (co >= P.cout) continue;   // cout % 8: the pair together
              const int a0 = acc[j][4 * v + 2 * hh];
              const int a1 = acc[j][4 * v + 2 * hh + 1];
              const long long o = pix * P.cout + co;
              if (P.ws != nullptr) {
                atomicAdd(P.ws + o, a0);
                atomicAdd(P.ws + o + 1, a1);
              } else {
                float d0 = P.w_s[co], d1 = P.w_s[co + 1];
                if (G::DYN) {
                  d0 = __fmul_rn(sn, d0);
                  d1 = __fmul_rn(sn, d1);
                }
                *reinterpret_cast<uint32_t*>(P.y + o) =
                    out_pair(a0, a1, d0, d1, P.bias, co);
              }
            }
          }
        }
      }
      cursor_next(P, cc);
    }
  }
}

// ---- the slab mode (wide calls)

// the slab mode: two producer warpgroups (warps 0-6 quantize, warp 7 issues
// the weights), two consumer warpgroups
constexpr int NTS = 512;
constexpr int CTS = 256;
constexpr int SPT = PT - 32;      // slab producer threads
constexpr int SLAB_RU_MAX = 8;   // units of a producer thread per chunk
constexpr int MAX_STAGE_TAPS = 4;   // taps of a weights stage
constexpr int SLAB_BARS = 128 * 3 * 8;   // 2 nkc + nsb mbarriers, at most

// Shared-memory descriptor of a K-major operand without swizzle, 8-row core
// matrices of 16-byte rows: lbo between the two 16-byte halves of K, sbo
// between 8-row groups.
__device__ __forceinline__ uint64_t desc_k(uint32_t addr, uint32_t lbo,
                                           uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32);
}

// the slab producer threads only (named barrier 2)
__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(SPT) : "memory");
}

// Dynamic scales in the slab mode, whose items hold one sample: q(x) =
// clip(rint(bf16(__fdiv_rn(x, bf16(s))))) depends on x's bf16 bits alone,
// is odd in x, and is 0 below |x| = bf16(s) / 4 and 127 from bf16(s) 256
// on: 10 binades, 1280 magnitudes. The sample's table holds q of each, its
// first entry the 0 below, its last the 127 above; an element is then its
// magnitude's offset from bf16(s) / 4, clamped, one byte read, the sign.
constexpr int QTAB_LEN = 10 * 128;
constexpr int QTAB_STRIDE = QTAB_LEN + 8;   // with the two end entries

// the table's first magnitude: the bits of bf16(s) / 4 (two binades down)
__device__ __forceinline__ int qtab_base(float amax) {
  return static_cast<int>(
             __bfloat16_as_ushort(__float2bfloat16_rn(dyn_scale(amax)))) -
         2 * 128;
}

// entry i of the table of a sample whose bf16(s) has the bits base + 256
__device__ __forceinline__ uint8_t qtab_entry(int base, int i) {
  if (i == 0) return 0;
  if (i > QTAB_LEN) return 127;
  const float sb = __uint_as_float(static_cast<uint32_t>(base + 256) << 16);
  const float x = __uint_as_float(static_cast<uint32_t>(base + i - 1) << 16);
  const float b = __bfloat162float(__float2bfloat16_rn(__fdiv_rn(x, sb)));
  return static_cast<uint8_t>(rintf(fminf(b, 127.f)));
}

// q of the bf16 value w (low 16 bits) by the sample's table, as a byte
__device__ __forceinline__ uint32_t qtab_q(uint32_t w, const uint8_t* tab,
                                           int base) {
  const int i = min(max(static_cast<int>(w & 0x7fffu) - base + 1, 0),
                    QTAB_LEN + 1);
  const int q = tab[i];
  return static_cast<uint32_t>(w & 0x8000u ? -q : q) & 0xffu;
}

// quant8<dynamic> by the sample's table
__device__ __forceinline__ uint2 quant8_qtab(uint4 v, const uint8_t* tab,
                                             int base) {
  const uint32_t xw[4] = {v.x, v.y, v.z, v.w};
  uint32_t b[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    b[2 * i] = qtab_q(xw[i] & 0xffffu, tab, base);
    b[2 * i + 1] = qtab_q(xw[i] >> 16, tab, base);
  }
  return make_uint2(b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24),
                    b[4] | (b[5] << 8) | (b[6] << 16) | (b[7] << 24));
}

// One weights stage's wgmmas: T taps (A at a_off[t], B at b_off[t]) into
// each of the warpgroup's TW blocks (bst bytes apart); the pass's first
// stage starts the sums.
template <int T, int TW, int BN>
__device__ __forceinline__ void stage_taps(int (&acc)[TW][BN / 2],
                                           const uint32_t (&a_off)[T],
                                           const uint32_t (&b_off)[T],
                                           uint32_t lbo, uint32_t bst,
                                           bool first) {
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const uint64_t db = desc_kmajor(b_off[t]);
#pragma unroll
    for (int j = 0; j < TW; ++j)
      wgmma_ss(acc[j], desc_k(a_off[t] + j * bst, lbo, 128), db,
               !(first && t == 0));
  }
}

template <int BN, int TW, int S, int NTAP, bool DYN>
__global__ void __launch_bounds__(NTS, 1)
    conv_s8_slab_kernel(const __grid_constant__ Params P) {
  constexpr int LS = S == 2 ? 1 : 0;   // log2 S: the planes by parity
  extern __shared__ __align__(128) char smem[];
  const Slab& L = P.sl;
  const uint32_t bars = smem_u32(smem);
  // the slab ring of nr chunk slots: chunk g of the CTA's items (g = ic nkc
  // + c) in slot g % nr. full_slab[i] at bars + 8 i, empty_slab[i] at + 8
  // (nr + i), bfull[i] at + 8 (2 nr + i), bempty[i] at + 8 (2 nr + nsb + i)
  const int nsc = L.nr;
  const uint32_t full_slab = bars, empty_slab = bars + 8 * nsc;
  const uint32_t bfull = bars + 16 * nsc, bempty = bfull + 8 * L.nsb;
  bf16* inv_s = reinterpret_cast<bf16*>(smem + L.inv_off);
  uint8_t* qtab_s = reinterpret_cast<uint8_t*>(smem + L.qtab_off);
  char* slab = smem + L.slab_off;
  char* bring = smem + L.b_off;
  const int t = threadIdx.x;
  const int n_items = P.n * L.nti * L.ntj * L.npg;
  if (t == 0) {
    for (int c = 0; c < nsc; ++c) {
      mbar_init(full_slab + 8 * c, SPT / 32);
      mbar_init(empty_slab + 8 * c, CTS / 32);
    }
    for (int b = 0; b < L.nsb; ++b) {
      mbar_init(bfull + 8 * b, 1);
      mbar_init(bempty + 8 * b, CTS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the static scales, the weights' scales and the bias, once per CTA
  float* ws_s = reinterpret_cast<float*>(smem + L.ws_off);
  bf16* bias_s = reinterpret_cast<bf16*>(smem + L.bias_off);
  const bf16 zero = __float2bfloat16_rn(0.f);
  if constexpr (!DYN) {
    for (int i = t; i < P.nkc * KC; i += NTS)
      inv_s[i] = i < P.cin ? P.inv[i] : zero;
  }
  for (int i = t; i < P.cout; i += NTS) {
    ws_s[i] = P.w_s[i];
    if (P.bias != nullptr) bias_s[i] = P.bias[i];
  }
  for (int i = t; i < BN * KC / 16; i += NTS)   // the padded taps' weights
    reinterpret_cast<uint4*>(smem + L.zero_off)[i] = make_uint4(0, 0, 0, 0);
  fence_proxy_async();   // the zeros, before the tensor cores read them
  __syncthreads();
  // item it: sample it / per_n, then its tile (row block, column block),
  // then its group of ppi passes, fastest
  const int per_n = L.nti * L.ntj * L.npg;

  if (t < SPT) {
    // ---- producers: each item's slab, chunk by chunk: all of a thread's
    // units of the chunk loaded (up to 16 loads of 16 bytes in flight),
    // then quantized into the slab. Unit r of thread t (u = t + SPT r) is
    // pixel (u / 16) 8 + u % 8 of the planes, channel half (u / 8) % 2; its
    // table entry packs the slab offset (16 bits) and the pixel's row and
    // column from the slab origin (8 bits each)
    const int kc = (t >> 3) & 1;
    uint32_t* tab = reinterpret_cast<uint32_t*>(smem + L.tab_off);
    for (int r = 0; r < SLAB_RU_MAX; ++r) {
      const int u = t + SPT * r;
      const int px = ((u >> 4) << 3) + (u & 7);
      const int plane = px / (L.ph * L.pw), rem = px - plane * L.ph * L.pw;
      const int rr = rem / L.pw, cc = rem - rr * L.pw;
      tab[r * SPT + t] =
          r < L.ru && px < L.npix
              ? static_cast<uint32_t>(kc * L.npixp * 16 + px * 16) |
                    (static_cast<uint32_t>(S * rr + (plane >> LS)) << 16) |
                    (static_cast<uint32_t>(S * cc + (plane & (S - 1))) << 24)
              : 0xffffffffu;
    }
    int it = blockIdx.x, ic = 0, c = 0;
    while (it < n_items) {
      const int n = it / per_n;
      const int tile = (it - n * per_n) / L.npg;
      const int ti = tile / L.ntj;
      const int r0 = S * ti * L.ti + L.oy_min;
      const int c0 = S * (tile - ti * L.ntj) * L.tj + L.ox_min;
      const int ch = c * KC + kc * 16;
      uint4 v[SLAB_RU_MAX][2];
#pragma unroll
      for (int r = 0; r < SLAB_RU_MAX; ++r) {
        v[r][0] = v[r][1] = make_uint4(0u, 0u, 0u, 0u);
        const uint32_t e = tab[r * SPT + t];
        if (e == 0xffffffffu) continue;
        const int gy = r0 + static_cast<int>((e >> 16) & 0xff);
        const int gx = c0 + static_cast<int>(e >> 24);
        if (static_cast<unsigned>(gy) >= static_cast<unsigned>(P.h) ||
            static_cast<unsigned>(gx) >= static_cast<unsigned>(P.w))
          continue;
        const uint4* src = reinterpret_cast<const uint4*>(
            P.x + (static_cast<long long>(n * P.h + gy) * P.w + gx) * P.cin +
            ch);
        if (ch < P.cin) v[r][0] = __ldg(src);
        if (ch + 8 < P.cin) v[r][1] = __ldg(src + 1);
      }
      const int g = ic * P.nkc + c;
      const int bc = g % L.nr, k = g / L.nr;
      if (k > 0)   // the consumers are done with the slot's last chunk
        mbar_wait(empty_slab + 8 * bc, (k - 1) & 1);
      const uint8_t* qtab = qtab_s + (ic & 1) * QTAB_STRIDE;
      int qbase = 0;
      if constexpr (DYN) {
        qbase = qtab_base(P.amax[n]);
        if (c == 0) {   // the item's sample: its table
          for (int i = t; i < QTAB_LEN + 2; i += SPT)
            qtab_s[(ic & 1) * QTAB_STRIDE + i] = qtab_entry(qbase, i);
          producers_sync();
        }
      }
      uint4 iv0 = make_uint4(0u, 0u, 0u, 0u), iv1 = iv0;
      if constexpr (!DYN) {
        const uint4* ip =
            reinterpret_cast<const uint4*>(inv_s + c * KC + kc * 16);
        iv0 = ip[0];
        iv1 = ip[1];
      }
      char* dst = slab + bc * L.chunk_bytes;
#pragma unroll
      for (int r = 0; r < SLAB_RU_MAX; ++r) {
        const uint32_t e = tab[r * SPT + t];
        if (e == 0xffffffffu) continue;
        uint2 q0, q1;
        if constexpr (DYN) {
          q0 = quant8_qtab(v[r][0], qtab, qbase);
          q1 = quant8_qtab(v[r][1], qtab, qbase);
        } else {
          q0 = quant8<false>(v[r][0], iv0, 0.f);
          q1 = quant8<false>(v[r][1], iv1, 0.f);
        }
        *reinterpret_cast<uint4*>(dst + (e & 0xffff)) =
            make_uint4(q0.x, q0.y, q1.x, q1.y);
      }
      fence_proxy_async();   // the slab chunk, before the tensor cores
      __syncwarp();
      if ((t & 31) == 0) mbar_arrive(full_slab + 8 * bc);
      if (++c == P.nkc) {
        c = 0;
        it += gridDim.x;
        ++ic;
      }
    }
  } else if (t < PT) {
    // ---- the weights' warp: lane 0 issues each stage's weights (item,
    // pass, chunk, kernel row: one bulk copy per tap of the row) into the
    // ring, once the consumers released the slot
    if (t == SPT) {
      const int nph = P.n_phase;
      int it = blockIdx.x, pi = 0, c = 0, ty0 = 0;
      for (int st = 0; it < n_items; ++st) {
        const int pass = (it % L.npg) * L.ppi + pi;
        const Phase& f = P.ph[pass % nph];
        const int nb = pass / nph;
        const int slot = st % L.nsb;
        if (st >= L.nsb)
          mbar_wait(bempty + 8 * slot, ((st / L.nsb) - 1) & 1);
        const uint32_t full = bfull + 8 * slot;
        const int rows = min(L.rps, f.nty - ty0);
        mbar_arrive_expect_tx(full, rows * f.ntx * BN * KC);
        for (int ty = ty0; ty < ty0 + rows; ++ty)
          for (int tx = 0; tx < f.ntx; ++tx) {
            const int ky = f.ky0 + P.dil * ty, kx = f.kx0 + P.dil * tx;
            const long long off =
                (static_cast<long long>((ky * P.kw + kx) * P.nkc + c) *
                     P.cout_pad +
                 static_cast<long long>(nb) * BN) * KC;
            bulk_copy_g2s(
                smem_u32(bring + slot * L.b_slot_bytes +
                         ((ty - ty0) * f.ntx + tx) * BN * KC),
                P.wpk + off, BN * KC, full);
          }
        if ((ty0 += rows) == f.nty) {
          ty0 = 0;
          if (++c == P.nkc) {
            c = 0;
            if (++pi == L.ppi) {
              pi = 0;
              it += gridDim.x;
            }
          }
        }
      }
    }
  } else {
    // ---- consumers: per item, each pass (phase, channel block) runs the
    // chunks, each chunk the phase's kernel rows (a stage of weights each)
    // warpgroup wg owns m64 blocks wg TW .. wg TW + TW - 1 of the item
    const int wg = (t - PT) >> 7;
    const int wq = ((t - PT) >> 5) & 3;
    const int lane = t & 31;
    const int nph = P.n_phase;
    const bf16* bias = P.bias != nullptr ? bias_s : nullptr;
    const uint32_t zero_b = smem_u32(smem + L.zero_off);
    int acc[TW][BN / 2];
#pragma unroll
    for (int j = 0; j < TW; ++j)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[j][i] = 0;
    int gs = 0;   // stages run
    const uint32_t lbo = L.npixp * 16;
    for (int it = blockIdx.x, ic = 0; it < n_items; it += gridDim.x, ++ic) {
      const int n = it / per_n;
      const int tile = (it - n * per_n) / L.npg;
      const int ti = tile / L.ntj;
      const int i0 = ti * L.ti, j0 = (tile - ti * L.ntj) * L.tj;
      for (int pi = 0; pi < L.ppi; ++pi) {
        const int pass = (it % L.npg) * L.ppi + pi;
        const int p = pass % nph, nb = pass / nph;
        const Phase& f = P.ph[p];
        for (int c = 0; c < P.nkc; ++c) {
          const int g = ic * P.nkc + c;
          const int bc = g % L.nr;
          if (pi == 0) mbar_wait(full_slab + 8 * bc, (g / L.nr) & 1);
          const uint32_t chunk = smem_u32(slab + bc * L.chunk_bytes);
          for (int ty0 = 0; ty0 < f.nty; ty0 += L.rps) {
            const int slot = gs % L.nsb;
            mbar_wait(bfull + 8 * slot, (gs / L.nsb) & 1);
            const uint32_t bs = smem_u32(bring + slot * L.b_slot_bytes);
            // the stage's taps: position m = a PW + b of the item (row a,
            // column b) reads for tap (ty, tx) slab row S a + dy, column S b
            // + rx: plane (dy % S, rx % S), pixel m + (dy / S) PW + rx / S
            // of it; block k holds positions k bstride .. + 63
            // NTAP taps, every stage of the call alike: wgmmas issued in a
            // sequence whose length varies at run time are serialized by
            // ptxas. A stage with fewer taps (a conv-transpose's phases)
            // pads with taps of zero weights.
            const int nt = min(L.rps, f.nty - ty0) * f.ntx;
            uint32_t a_off[NTAP], b_off[NTAP];
#pragma unroll
            for (int i = 0; i < NTAP; ++i) {
              const int ty = ty0 + i / f.ntx, tx = i - (i / f.ntx) * f.ntx;
              const int dy = f.oy0 + ty - L.oy_min, rx = f.ox0 + tx - L.ox_min;
              a_off[i] = i < nt ? chunk + (((((dy & (S - 1)) * S +
                                             (rx & (S - 1))) * L.ph +
                                            (dy >> LS)) * L.pw + (rx >> LS) +
                                           wg * TW * L.bstride) * 16)
                                : chunk;
              b_off[i] = i < nt ? bs + i * BN * KC : zero_b;
            }
            wgmma_fence();
            stage_taps<NTAP, TW, BN>(acc, a_off, b_off, lbo,
                                     L.bstride * 16, c == 0 && ty0 == 0);
            wgmma_commit();
            wgmma_wait<1>();   // the previous stage's wgmmas are done
            if (gs > 0) {      // its weights' slot is free
              __syncwarp();
              if (lane == 0) mbar_arrive(bempty + 8 * ((gs - 1) % L.nsb));
            }
            ++gs;
          }
          // the item's last pass is done with chunk c (the wait is
          // unconditional: a wgmma wait on one branch only also serializes)
          wgmma_wait<0>();
          if (pi == L.ppi - 1) {
            __syncwarp();
            if (lane == 0) mbar_arrive(empty_slab + 8 * bc);
          }
        }
        wgmma_wait<0>();
#pragma unroll
        for (int j = 0; j < TW; ++j) fence_regs(acc[j]);
        // epilogue: position (wg TW + j) bstride + 16 wq + lane / 4 + 8 hh,
        // at phase-grid row i0 + a, column j0 + b; channels of d[i] as in
        // the gather mode
        const float sn = DYN ? dyn_scale(P.amax[n]) : 0.f;
#pragma unroll
        for (int j = 0; j < TW; ++j) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int m = (wg * TW + j) * L.bstride + 16 * wq + (lane >> 2) +
                          8 * hh;
            const int a = m / L.pw, b = m - a * L.pw;
            const int i = i0 + a, jj = j0 + b;
            if (b >= L.tj || a >= L.ti || i >= f.hp) continue;
            const long long pix =
                (static_cast<long long>(n) * P.ho + f.py + P.dil * i) * P.wo +
                f.px + P.dil * jj;
            // the packed weights' column order (quant.pack_s8_weights)
            // gives this thread channels (lane % 4) BN / 4 .. + BN / 4 - 1:
            // 16-byte stores of 8 channels (4 pairs v)
#pragma unroll
            for (int g = 0; g < BN / 32; ++g) {
              const int co0 = nb * BN + (lane & 3) * (BN / 4) + 8 * g;
              if (co0 >= P.cout) continue;   // cout % 8: all 8 together
              uint32_t pr[4];
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const int v = 4 * g + u, co = co0 + 2 * u;
                float d0 = ws_s[co], d1 = ws_s[co + 1];
                if (DYN) {
                  d0 = __fmul_rn(sn, d0);
                  d1 = __fmul_rn(sn, d1);
                }
                pr[u] = out_pair(acc[j][4 * v + 2 * hh],
                                 acc[j][4 * v + 2 * hh + 1], d0, d1, bias, co);
              }
              *reinterpret_cast<uint4*>(P.y + pix * P.cout + co0) =
                  make_uint4(pr[0], pr[1], pr[2], pr[3]);
            }
          }
        }
      }
    }
  }
}

// The epilogue of a split call: y from the summed workspace, a channel
// pair per thread.
__global__ void conv_s8_finish_kernel(const int* __restrict__ ws,
                                      const float* __restrict__ w_s,
                                      const float* __restrict__ amax,
                                      const bf16* __restrict__ bias,
                                      bf16* __restrict__ y, long long n_pairs,
                                      int px_per_sample, int cout) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n_pairs; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long o = 2 * i;
    const int co = static_cast<int>(o % cout);
    const int n = static_cast<int>(o / cout / px_per_sample);
    float d0 = w_s[co], d1 = w_s[co + 1];
    if (amax != nullptr) {
      const float sn = dyn_scale(amax[n]);
      d0 = __fmul_rn(sn, d0);
      d1 = __fmul_rn(sn, d1);
    }
    const int2 a = *reinterpret_cast<const int2*>(ws + o);
    *reinterpret_cast<uint32_t*>(y + o) = out_pair(a.x, a.y, d0, d1, bias, co);
  }
}

// amax[n] = max |x[n]| as the f32 bits of a bf16 magnitude, for amax
// zeroed: per thread a packed max of the 16-bit magnitudes, a warp and
// block max, one integer atomicMax per block (the bits of non-negative
// floats order as the floats do)
__global__ void __launch_bounds__(256)
    conv_s8_absmax_kernel(const uint4* __restrict__ x, long long per_sample,
                          unsigned* __restrict__ amax) {
  __shared__ unsigned red[8];
  const uint4* xs = x + blockIdx.y * per_sample;
  unsigned m = 0;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < per_sample;
       i += gridDim.x * 256LL) {
    const uint4 v = xs[i];
    m = __vmaxu2(m, v.x & 0x7fff7fffu);
    m = __vmaxu2(m, v.y & 0x7fff7fffu);
    m = __vmaxu2(m, v.z & 0x7fff7fffu);
    m = __vmaxu2(m, v.w & 0x7fff7fffu);
  }
  m = max(m & 0xffffu, m >> 16);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < 8; ++i) m = max(m, red[i]);
    atomicMax(amax + blockIdx.y, m << 16);
  }
}

// ---- host side

int block_n(int cout) { return cout <= 64 ? 64 : 128; }

// m64 blocks of a slab consumer warpgroup: its accumulators, TW x BN / 2
// int32 a thread, fill 64 registers
int slab_blocks(int bn) { return bn == 64 ? 2 : 1; }

bool plan_slab(Params& P, int n_sm);

// Fills P's geometry (phases, items) for the split `split` (0: choose it)
// and n_sm SMs; returns the split, or 0 for a shape the kernel does not
// take.
int plan(Params& P, int n, int h, int w, int cin, int ho, int wo, int cout,
         int kh, int kw, int stride, int dil, int pad_h, int pad_w,
         int n_sm) {
  if (n < 1 || h < 1 || w < 1 || ho < 1 || wo < 1 || cin < 8 || cin % 8 ||
      cin > CIN_MAX || cout < 8 || cout % 8 || kh < 1 || kw < 1 ||
      stride < 1 || dil < 1 || (stride > 1 && dil > 1) || dil > 2)
    return 0;
  const int bn = block_n(cout), bm = bn == 64 ? 256 : 128;
  P.n = n; P.h = h; P.w = w; P.cin = cin; P.ho = ho; P.wo = wo;
  P.cout = cout; P.kw = kw; P.stride = stride; P.dil = dil;
  P.nkc = (cin + KC - 1) / KC;
  P.nb = (cout + bn - 1) / bn;
  P.n_phase = dil * dil;
  int base = 0, min_nk = INT_MAX;
  for (int p = 0; p < P.n_phase; ++p) {
    Phase& f = P.ph[p];
    f.py = p / dil;
    f.px = p % dil;
    f.ky0 = ((pad_h - f.py) % dil + dil) % dil;
    f.kx0 = ((pad_w - f.px) % dil + dil) % dil;
    f.nty = f.ky0 < kh ? (kh - f.ky0 + dil - 1) / dil : 0;
    f.ntx = f.kx0 < kw ? (kw - f.kx0 + dil - 1) / dil : 0;
    if (f.nty == 0 || f.ntx == 0) return 0;
    f.oy0 = (f.py + f.ky0 - pad_h) / dil;   // exact: a multiple of dil
    f.ox0 = (f.px + f.kx0 - pad_w) / dil;
    f.hp = ho > f.py ? (ho - f.py + dil - 1) / dil : 0;
    f.wp = wo > f.px ? (wo - f.px + dil - 1) / dil : 0;
    const long long m = static_cast<long long>(n) * f.hp * f.wp;
    f.m_tiles = static_cast<int>((m + bm - 1) / bm);
    base += f.m_tiles * P.nb;
    if (f.m_tiles > 0) min_nk = std::min(min_nk, f.nty * f.ntx * P.nkc);
  }
  if (plan_slab(P, n_sm)) {
    P.split = 1;
    return 1;
  }
  P.sl = Slab{};   // s 0: the gather mode
  int split = 1;
  if (base > 0 && base < n_sm)
    split = std::max(1, std::min(n_sm / base, min_nk / MIN_SPLIT_STEPS));
  P.split = split;
  int item0 = 0;
  for (int p = 0; p < P.n_phase; ++p) {
    P.ph[p].item0 = item0;
    item0 += P.ph[p].m_tiles * P.nb * split;
  }
  P.n_items = item0;
  return split;
}

// The slab mode's geometry for a call whose phases share one grid: items of
// 2 TW rows x 64 columns (one row per m64 block) where the grid's width is
// a multiple of 64, else of its whole width and as many rows as 2 TW blocks
// of 64 positions hold (position a PW + b: a row of the plane's pitch, the
// columns past the width computed and dropped), if that makes an item for
// every SM; false: the gather mode.
bool plan_slab(Params& P, int n_sm) {
  const Phase& f0 = P.ph[0];
  int oy_min = INT_MAX, ox_min = INT_MAX, oy_end = INT_MIN, ox_end = INT_MIN;
  int max_ntx = 0;
  for (int p = 0; p < P.n_phase; ++p) {
    const Phase& f = P.ph[p];
    if (f.hp != f0.hp || f.wp != f0.wp) return false;
    oy_min = std::min(oy_min, f.oy0);
    ox_min = std::min(ox_min, f.ox0);
    oy_end = std::max(oy_end, f.oy0 + f.nty);
    ox_end = std::max(ox_end, f.ox0 + f.ntx);
    max_ntx = std::max(max_ntx, f.ntx);
  }
  // grids narrower than 8 columns stay in the gather mode: their slab
  // items read the weights once per sample, which costs more there than
  // the gather mode's quantize per tap (measured on the H100)
  if (f0.hp < 1 || f0.wp < 8 || (f0.wp > 64 && f0.wp % 64) ||
      P.cout > COUT_MAX)
    return false;
  Slab& L = P.sl;
  const int s = P.stride, bn = block_n(P.cout);
  const int nblk = 2 * slab_blocks(bn);
  if (s > 2) return false;
  L.s = s;
  L.oy_min = oy_min;
  L.ox_min = ox_min;
  L.tj = std::min(f0.wp, 64);
  L.pw = (s * (L.tj - 1) + ox_end - ox_min + s - 1) / s;
  if (f0.wp % 64 == 0) {   // a row per block
    L.ti = nblk;
    L.bstride = L.pw;
    L.ph = (s * (L.ti - 1) + oy_end - oy_min + s - 1) / s;
  } else {                 // blocks of 64 consecutive positions
    L.ti = nblk * 64 / L.pw;
    L.bstride = 64;
    if (L.ti < 1) return false;
    // the last block's reads, its dropped positions included
    const int reach = nblk * 64 + (oy_end - oy_min - 1) / s * L.pw +
                      (ox_end - ox_min - 1) / s;
    L.ph = std::max((s * (L.ti - 1) + oy_end - oy_min + s - 1) / s,
                    (reach + L.pw - 1) / L.pw);
  }
  L.npix = s * s * L.ph * L.pw;
  L.npixp = (L.npix + 7) / 8 * 8;
  L.ru = (L.npixp + SPT / 2 - 1) / (SPT / 2);
  if (L.ru > SLAB_RU_MAX) return false;
  L.chunk_bytes = L.npixp * 32;
  L.nti = (f0.hp + L.ti - 1) / L.ti;
  L.ntj = f0.wp / L.tj;
  L.npass = P.n_phase * P.nb;
  // a weights stage: every kernel row of the phase where the phases all
  // have the same taps, at most 4 and 16 KB (a 4x4 conv-transpose), else
  // one row; the stage's tap count, at least 2, is the kernel's NTAP
  int max_nty = 0;
  bool uniform = true;
  for (int p = 0; p < P.n_phase; ++p) {
    max_nty = std::max(max_nty, P.ph[p].nty);
    uniform = uniform && P.ph[p].nty * P.ph[p].ntx == f0.nty * f0.ntx;
  }
  L.rps = uniform && max_nty * max_ntx <= MAX_STAGE_TAPS &&
                  max_nty * max_ntx * bn * KC <= 16384
              ? max_nty
              : 1;
  if (L.rps * max_ntx > MAX_STAGE_TAPS) return false;
  L.nt = std::max(2, L.rps * max_ntx);
  if (s == 2 && L.nt < 3) L.nt = 3;
  L.b_slot_bytes = L.rps * max_ntx * bn * KC;
  // the static scales, the weights' scales and the bias, sized by the call
  const int cout16 = (P.cout + 15) / 16 * 16;
  L.inv_off = SLAB_BARS;
  L.ws_off = L.inv_off + P.nkc * KC * 2;
  L.bias_off = L.ws_off + cout16 * 4;
  L.qtab_off = L.bias_off + cout16 * 2;
  L.zero_off = L.qtab_off + 2 * QTAB_STRIDE;
  L.tab_off = L.zero_off + 128 * KC;
  L.slab_off = L.tab_off + SLAB_RU_MAX * SPT * 4;
  // the slab ring beside 4 weight slots: two items' whole slabs (the
  // producers an item ahead; every pass of an item reads its slab), else
  // one, else a ring of chunks for items of one pass each (the slab
  // quantized again for each pass); then as many weight slots as fit, up
  // to 8
  constexpr int SMEM_MAX = 232448, NR_MAX = SLAB_BARS / 16 - 8;
  auto b_off = [&](int nr) {
    return L.slab_off + (nr * L.chunk_bytes + 127) / 128 * 128;
  };
  const int room = (SMEM_MAX - 4 * L.b_slot_bytes - L.slab_off) /
                   L.chunk_bytes;
  // a narrow grid's items are few: one pass each, unless that is not
  // needed to give every SM an item
  const bool one_pass =
      f0.wp < 64 && P.n * L.nti * L.ntj < n_sm && L.npass > 1;
  L.ppi = L.npass;
  if (!one_pass && 2 * P.nkc <= std::min(room, NR_MAX)) {
    L.nr = 2 * P.nkc;
  } else if (!one_pass && P.nkc <= std::min(room, NR_MAX)) {
    L.nr = P.nkc;
  } else {
    L.ppi = 1;
    L.nr = std::min(room, NR_MAX);
    if (L.nr < 2) return false;
  }
  L.npg = L.npass / L.ppi;
  L.b_off = b_off(L.nr);
  for (L.nsb = 8; L.nsb >= 2; L.nsb -= 2) {
    L.smem = L.b_off + L.nsb * L.b_slot_bytes;
    if (L.smem <= SMEM_MAX) break;
  }
  if (L.smem > SMEM_MAX) return false;
  P.n_items = P.n * L.nti * L.ntj * L.npg;
  // a grid narrower than 64 columns: the slab mode only with an item for
  // every SM (else the gather mode, which splits K)
  if (f0.wp < 64 && P.n_items < n_sm) return false;
  return true;
}

int num_sms() {
  int dev = 0, n_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n_sm;
}

// The dynamic shared memory attribute is set on every launch: it belongs to
// the current device, and a process may launch on several (one replica per
// card); the call costs about a microsecond of host time.
template <class G>
cudaError_t launch(const Params& P, int n_sm, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      conv_s8_gather_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G::SMEM);
  if (err != cudaSuccess) return err;
  const int grid = P.n_items < n_sm ? P.n_items : n_sm;
  if (grid > 0) conv_s8_gather_kernel<G><<<grid, NT, G::SMEM, st>>>(P);
  return cudaGetLastError();
}

template <int BN, int S, int NTAP, bool DYN>
cudaError_t launch_slab(const Params& P, int n_sm, cudaStream_t st) {
  constexpr int TW = BN == 64 ? 2 : 1;
  const cudaError_t err = cudaFuncSetAttribute(
      conv_s8_slab_kernel<BN, TW, S, NTAP, DYN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (err != cudaSuccess) return err;
  const int grid = P.n_items < n_sm ? P.n_items : n_sm;
  if (grid > 0)
    conv_s8_slab_kernel<BN, TW, S, NTAP, DYN>
        <<<grid, NTS, P.sl.smem, st>>>(P);
  return cudaGetLastError();
}

// the taps of a weights stage: 3 or 4 at stride 2 (the down convs), 2, 3 or
// 4 at stride 1 (conv-transposes, stride-1 convs)
template <int BN, bool DYN>
cudaError_t launch_slab_s(const Params& P, int n_sm, cudaStream_t st) {
  const int nt = P.sl.nt;
  if (P.sl.s == 2)
    return nt == 3 ? launch_slab<BN, 2, 3, DYN>(P, n_sm, st)
                   : launch_slab<BN, 2, 4, DYN>(P, n_sm, st);
  if (nt == 2) return launch_slab<BN, 1, 2, DYN>(P, n_sm, st);
  if (nt == 3) return launch_slab<BN, 1, 3, DYN>(P, n_sm, st);
  return launch_slab<BN, 1, 4, DYN>(P, n_sm, st);
}

template <bool DYN>
cudaError_t launch_bn(const Params& P, int n_sm, cudaStream_t st) {
  if (P.sl.s > 0) {
    if (block_n(P.cout) == 64) return launch_slab_s<64, DYN>(P, n_sm, st);
    return launch_slab_s<128, DYN>(P, n_sm, st);
  }
  if (block_n(P.cout) == 64) return launch<Cfg<64, 4, DYN>>(P, n_sm, st);
  return launch<Cfg<128, 2, DYN>>(P, n_sm, st);
}

}  // namespace

extern "C" {

// The K split that conv_s8 takes for this shape (1: none; > 1: it needs
// the int32 workspace), or 0 for a shape it does not take.
int conv_s8_split(int n, int h, int w, int cin, int ho, int wo, int cout,
                  int kh, int kw, int stride, int dil, int pad_h,
                  int pad_w) {
  Params P{};
  return plan(P, n, h, w, cin, ho, wo, cout, kh, kw, stride, dil, pad_h,
              pad_w, num_sms());
}

// The per-sample max |x| of x (n, per_sample) bf16, per_sample % 8 == 0,
// 16-byte aligned, into amax (n) f32; on `stream`. Returns the cudaError_t.
int conv_s8_absmax(const void* x, float* amax, int n, long long per_sample,
                   void* stream) {
  if (n < 1 || per_sample < 8 || per_sample % 8 ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(float) * n, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long vec = per_sample / 8;
  long long blocks = (vec + 2047) / 2048;
  const long long cap = std::max(1, 1024 / n);
  blocks = blocks < cap ? blocks : cap;
  conv_s8_absmax_kernel<<<dim3(static_cast<unsigned>(blocks), n), 256, 0,
                          st>>>(static_cast<const uint4*>(x), vec,
                                reinterpret_cast<unsigned*>(amax));
  return static_cast<int>(cudaGetLastError());
}

// Launch on `stream`: (zero the workspace,) the conv, (the split's
// epilogue). x (n, h, w, cin) bf16 NHWC, 16-byte aligned; wpk the packed
// weights (kh, kw, ceil(cin / 32), cout_pad * 32), cout_pad a multiple of
// the channel block (64, 128 or 256 by cout), 16-byte aligned; w_s (cout)
// f32; static: inv (cin) bf16 and amax null; dynamic: amax (n) f32 (from
// conv_s8_absmax) and inv null; bias (cout) bf16 or null; y (n, ho, wo,
// cout) bf16; ws (n, ho, wo, cout) int32 when `split` (conv_s8_split) > 1.
// pad_h, pad_w: the zero padding at the top and left of the (dilated)
// input. Returns the cudaError_t (cudaErrorInvalidValue for what the
// kernel does not take: cin % 8, cin > 2048, cout % 8, stride and dil
// both above 1, a dilation above 2, a phase without taps, misaligned
// pointers, a split other than conv_s8_split's).
int conv_s8(const void* x, const void* wpk, const float* w_s,
            const void* inv, const float* amax, const void* bias, void* y,
            void* ws, int n, int h, int w, int cin, int ho, int wo, int cout,
            int cout_pad, int kh, int kw, int stride, int dil, int pad_h,
            int pad_w, int split, void* stream) {
  const int n_sm = num_sms();
  if (n_sm < 1) return static_cast<int>(cudaErrorInvalidDevice);
  Params P{};
  const int want = plan(P, n, h, w, cin, ho, wo, cout, kh, kw, stride, dil,
                        pad_h, pad_w, n_sm);
  const bool dyn = amax != nullptr;
  if (want == 0 || want != split || (split > 1) != (ws != nullptr) ||
      dyn == (inv != nullptr) || cout_pad < cout ||
      cout_pad % block_n(cout) ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(wpk) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  P.x = static_cast<const bf16*>(x);
  P.wpk = static_cast<const int8_t*>(wpk);
  P.w_s = w_s;
  P.inv = static_cast<const bf16*>(inv);
  P.amax = amax;
  P.bias = static_cast<const bf16*>(bias);
  P.y = static_cast<bf16*>(y);
  P.ws = static_cast<int*>(ws);
  P.cout_pad = cout_pad;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long outs = static_cast<long long>(n) * ho * wo * cout;
  cudaError_t err;
  if (split > 1) {
    err = cudaMemsetAsync(ws, 0, sizeof(int) * outs, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = dyn ? launch_bn<true>(P, n_sm, st) : launch_bn<false>(P, n_sm, st);
  if (err != cudaSuccess || split == 1) return static_cast<int>(err);
  const long long pairs = outs / 2;
  const long long blocks = (pairs + 255) / 256;
  conv_s8_finish_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                          256, 0, st>>>(
      static_cast<const int*>(ws), w_s, amax, P.bias, P.y, pairs, ho * wo,
      cout);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
