// Implicit-GEMM 3x3 convolution on Hopper's tensor cores (wgmma, sm_90a),
// fused with the input's norm affine and ReLU and with per-(sample,
// channel) output statistics. Three kinds (Geom<KIND, BN, NST, OP>):
//  * CONV_S1: stride 1, reflect or zero pad 1, the ResNet trunk
//    (conv3x3_stats.cu; replaces deepliif_tpu/ops/fused_resblock.py
//    ::_kernel, and with OP_S8 conv3x3_stats_int8.cu, ::_kernel_int8);
//  * CONV_S2: stride 2, zero pad 1, the translator's down stages
//    (conv3x3_s2_stats.cu; replaces deepliif_tpu/labs/fused_stages.py
//    ::_down_kernel);
//  * CONVT: ConvTranspose2d(3, stride 2, padding 1, output_padding 1), the
//    up stages (convtranspose3_s2_stats.cu; replaces
//    deepliif_tpu/labs/fused_stages.py::_up_kernel), in its phase form: with
//    w in the forward-conv HWIO layout (the torch kernel spatially flipped),
//    per axis out[2m] = w[1] x[m] and out[2m + 1] = w[0] x[m] + w[2] x[m + 1]
//    (x past the edge is zero), so each of the four output phases (a, b) is
//    a stride-1 conv of 1, 2, 2 or 4 taps over the input, with a halo of one
//    row and one column at the bottom and right.
//
// Three operand types (OP): bf16 (all kinds), split TF32 (CONV_S1 float32:
// x, w, y f32, three TF32 products per multiply-add, conv3x3_stats.cu) and
// s8 (CONV_S1 int8: the input pre-quantized into int8 blocks that hold the
// halo, int32 sums dequantized to bf16, conv3x3_stats_int8.cu). A staged
// pixel is 32 bytes of channels in each (KC = 16 bf16, 8 f32 or 32 int8
// channels a stage), so the slab layout and the A loads are shared; tf32
// and s8 take only K-major B, packed as core matrices without swizzle
// (desc_kmajor). The rest of this note describes the bf16 form.
//
// Contract (the kernels' headers): u = relu(x * scale[s] + bias[s]) in bf16
// (scale and bias rounded to bf16, the product and the sum each rounded);
// the pad (zeros written after the affine; reflect: the reflected pixel's
// transformed value); y = the conv of u with bf16 x bf16 products summed in
// f32; y rounded to bf16; stats (sum, sum^2) per (sample, channel) from the
// f32 sums. x NHWC (S, H, W, Cin), w HWIO (3, 3, Cin, Cout), y NHWC, Cin and
// Cout % 8 == 0, x, w, scale and bias 16-byte aligned.
//
// The GEMM: M = a tile of 16 x 16 output pixels (CONVT: of one phase, 16 x
// 16 input pixels), N = BN output channels (128; 64 for CONVT), K = taps x
// Cin. What bounds it on the H100: the operations (the trunk (16, 128, 128,
// 256): 154.6 GFLOP, 0.156 ms at 989 TFLOP/s, against 0.068 ms for its
// bytes) or the bytes of x and y (down0, up1) and, per SM, what each stage
// moves into shared memory and how many requests that takes: the weights
// (taps x KC x BN x 2 B per stage, whatever the tile's M) and the input
// slab. So the tile is as large as the accumulator registers allow, the
// weights are packed once per call so that a stage's taps are one bulk
// copy, and the slab arrives as TMA boxes of a tensor map of x: 16-byte
// cp.async copies, one request per 16 bytes of a pixel, held the producer
// back (measured on the H100).
//
// Warp specialization, 384 threads:
//  * warpgroup 0, the producer (setmaxnreg 40), fills an NST-slot ring in
//    shared memory, one stage of KC = 16 input channels at a time, AHEAD
//    stages ahead of the consumers. Thread 0 starts the stage's copies on
//    the slot's "landed" mbarrier: the weights of its taps (per tap BN / 64
//    blocks of KC rows x 128 B, 128-byte swizzled: chunk q of row k at q ^
//    (k % 8), the MN-major SWIZZLE_128B layout that the wgmma B descriptor
//    names; CONVT's image holds the taps phase by phase) and the input slab
//    of KC channels, one TMA box per plane (CONV_S2: (2*16+1)^2 pixels in 4
//    phase planes by row and column parity, loaded with a traversal stride
//    of 2, so that a tap reads adjacent pixels of a plane; CONV_S1 18^2 and
//    CONVT 17^2 pixels in one plane), 32-byte swizzled so that any 8
//    adjacent pixels of a plane row fall in 8 distinct bank groups. The TMA
//    engine reads zeros outside x: the zero pad, past the edge, channels
//    past Cin. Threads 0-7 copy the stage's norm scale and bias ahead into
//    shared memory. Where the stage needs it (affine, ReLU or reflect
//    padding; not CONVT, see below), all 128 threads then pass over their
//    chunks of the slab (a table of their offsets and positions filled
//    once per CTA): they copy the reflected halo pixels from their sources
//    in the slab, and apply the affine and ReLU in place with packed
//    bf16x2 arithmetic to the chunks that have a source (a reflected pixel
//    is transformed like any other; a zero stays zero). Then they arrive on
//    the slot's "full" mbarrier;
//  * warpgroups 1 and 2, the consumers (setmaxnreg 232), own output rows
//    0-7 and 8-15 of the tile as two m64 tiles each (warp w: rows 4j + w,
//    all 16 columns). A comes from registers (wgmma ... RS): ldmatrix.x4,
//    each lane giving the address of one pixel's 8 channels, so the tap
//    shift, the stride-2 gather and the phase offsets are address
//    arithmetic. CONVT's consumers apply the affine and ReLU to their A
//    fragments themselves (zero where the pixel has no source): each of a
//    tile's 4 phase items would otherwise have the producer transform the
//    same slab again. The k16 steps (one per tap of a stage: 9, or the
//    phase's 1-4) run in units into a fresh f32 temporary that is added to
//    the f32 accumulator (round to nearest) once the unit completed: a unit
//    is a stage per m64 tile (9 steps), or for CONVT up to 8 steps over several
//    stages, each m64 tile with a temporary of its own so that the tensor
//    cores are not drained per stage. Summing all of K in the tensor cores'
//    own accumulation drifts from an f32 sum by several bf16 ulps of small
//    outputs (measured on the H100); a unit sums at most 144 products
//    there. The consumers arrive on the slot's "empty" mbarrier when its
//    wgmmas are done;
//  * the CTAs are persistent: CTA b walks the items b, b + gridDim.x, ...
//    (item = tile x phase x BN channels of one sample, channel block
//    fastest; the phase order rotates with the tile so that a CTA's items
//    cycle through the phases' uneven tap counts) and their stages as one
//    sequence of steps through the ring, so copies run ahead across items.
//
// Epilogue (consumers): y rounded to bf16 and stored NHWC (CONVT: phase (a,
// b) of input pixel (m, n) at output (2m + a, 2n + b)); each thread sums
// its own pixels per channel in a fixed order, an xor butterfly over the 8
// lanes that share channels, then the 8 consumer warps' sums in warp order,
// written as per-item partials partial[s, tile * phases + phase, {sum,
// sumsq}, c] that stats_reduce_kernel sums in that order. No float atomics,
// no split K, and the tiling does not depend on S: y and the stats are
// byte-equal run to run and alone vs in a batch.

#pragma once

// CUtensorMap (types only: the encoder is fetched at run time)
#include <cuda.h>

#include <cstdint>
#include <type_traits>

#include "conv3x3_common.cuh"

namespace conv3x3_wgmma {

using bf16 = __nv_bfloat16;

constexpr int NT = 384;      // producer warpgroup + two consumer warpgroups
constexpr int PT = 128;      // producer threads
constexpr int CT = 256;      // consumer threads
constexpr int TM = 16;       // tile rows (output; CONVT: input)
constexpr int TN = 16;       // tile columns
constexpr int M_SUB = 2;     // m64 tiles per consumer warpgroup
// a staged pixel is 32 bytes of channels, one wgmma step deep: 16 bf16, 8
// f32 (tf32) or 32 int8 channels; two 16-byte chunks
constexpr int CPP = 2;       // 16-byte chunks per staged pixel
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

enum Kind { CONV_S1, CONV_S2, CONVT };

// The tensor cores' operands: bf16 (x, w, y bf16); split TF32 (x, w, y f32:
// each operand v = hi + lo with hi = tf32(v), lo = tf32(v - hi), and
// hi*hi + hi*lo + lo*hi summed in f32); s8 (x pre-quantized into int8
// blocks that hold their halo, w int8, int32 sums dequantized to bf16 y).
enum Op { OP_BF16, OP_TF32, OP_S8 };

template <int KIND, int BN_, int NST_, int OP_ = OP_BF16>
struct Geom {
  static constexpr int OP = OP_;
  // the slab's source holds the halo, already transformed (s8 blocks)
  static constexpr bool PREQ = OP == OP_S8;
  static constexpr int ESIZE = OP == OP_TF32 ? 4 : (OP == OP_S8 ? 1 : 2);
  static constexpr int KC = 32 / ESIZE;      // input channels per stage
  static constexpr int EPC = 16 / ESIZE;     // channels per 16-byte chunk
  static constexpr int NPLANE = OP == OP_TF32 ? 2 : 1;   // weights hi, lo
  // the element types of the weights (HWIO) and of y
  using WT = std::conditional_t<OP == OP_TF32, float,
                                std::conditional_t<OP == OP_S8, int8_t,
                                                   __nv_bfloat16>>;
  using YT = std::conditional_t<OP == OP_TF32, float, __nv_bfloat16>;
  using AT = std::conditional_t<OP == OP_S8, int, float>;   // the sums
  static constexpr bool TRANSPOSED = KIND == CONVT;
  static constexpr int BN = BN_;             // output channels per item
  static constexpr int NB64 = BN / 64;       // 64-column weight blocks
  static constexpr int NST = NST_;           // ring slots
  static constexpr int AHEAD = NST - 1;      // stages loading ahead
  static constexpr int STRIDE = KIND == CONV_S2 ? 2 : 1;   // of the slab
  static constexpr int PAD = TRANSPOSED ? 0 : 1;  // slab origin r0*STRIDE-PAD
  static constexpr int NPH = TRANSPOSED ? 4 : 1;  // output phases per tile
  static constexpr int NTAP = TRANSPOSED ? 4 : 9;  // most taps of a stage
  static constexpr int SH = TRANSPOSED ? TM + 1 : (TM - 1) * STRIDE + 3;
  static constexpr int SW = TRANSPOSED ? TN + 1 : (TN - 1) * STRIDE + 3;
  static constexpr int PH = (SH + STRIDE - 1) / STRIDE;   // plane rows
  static constexpr int PW = (SW + STRIDE - 1) / STRIDE;   // plane columns
  static constexpr int NPL = STRIDE * STRIDE;             // planes
  static constexpr int SLAB_ELEMS = SH * SW * CPP;   // 16-byte chunks a stage
  // staged pixels per plane: a plane starts 256-byte aligned (the TMA
  // engine's destination, and the period of its 32-byte swizzle)
  static constexpr int PLANE_PIX = (PH * PW + 7) / 8 * 8;
  static constexpr int SLAB_BYTES = NPL * PLANE_PIX * CPP * 16;
  static constexpr int SLAB_TX = NPL * PH * PW * CPP * 16;   // bytes loaded
  // bf16: one 64-column block of the MN-major weights
  static constexpr int WBLK_BYTES = KC * 128;
  // a tap's weights: BN columns x 32 bytes per plane (bf16: NB64 blocks)
  static constexpr int WTAP_BYTES = NPLANE * BN * 32;
  static constexpr int WPLANE_BYTES = BN * 32;
  static constexpr int W_BYTES = NTAP * WTAP_BYTES;  // a slot's weights
  static constexpr int WIMG_BYTES = 9 * WTAP_BYTES;  // packed, per stage
  static constexpr int STAGE_BYTES =
      (W_BYTES + SLAB_BYTES + 1023) / 1024 * 1024;
  // slab chunks per producer thread (its table of their slab offsets and
  // positions)
  static constexpr int NE = (SLAB_ELEMS + PT - 1) / PT;
  static constexpr int TABLE_BYTES = NE * PT * 4;
  // each thread's masks of every slot: chunks with a source, reflected ones
  static constexpr int MASK_BYTES = 2 * NST * PT * 4;
  // each slot's norm scale and bias of its KC channels
  static constexpr int AFF_BYTES = NST * 2 * KC * 4;
  static constexpr int RED_BYTES = (CT / 32) * BN * 2 * 4;   // stats scratch
  static constexpr int BAR_BYTES = 3 * NST * 8;   // full, empty, landed
  // the ring, the stats scratch, the slab table, the masks, the affine, the
  // barriers, and slack to align the ring to 1024 bytes
  static constexpr int SMEM = NST * STAGE_BYTES + RED_BYTES + TABLE_BYTES +
                              MASK_BYTES + AFF_BYTES + BAR_BYTES + 1024;
  static_assert(BN == 64 || BN == 128, "an n64 or n128 wgmma");
  // CONVT: each m64 tile keeps a temporary of its own (stage_deferred)
  static_assert(!TRANSPOSED || BN == 64, "two temporaries per tile at n64");
  static_assert(OP == OP_BF16 || KIND == CONV_S1, "tf32 and s8: the trunk");
  static_assert(OP == OP_BF16 || BN == 64, "tf32 and s8: n64");
  static_assert(PT % CPP == 0, "a producer thread owns one chunk of a pixel");
  static_assert(W_BYTES % 1024 == 0, "the slab starts 1024-byte aligned");
  static_assert(NE <= 32, "slab mask fits 32 bits");
  static_assert(SLAB_BYTES <= 65536 && SH < 256 && SW < 256,
                "a table entry packs 16 + 8 + 8 bits");
  static_assert(NST >= 2 && SMEM <= 232448, "the shared memory of one block");
};

// ---- PTX wrappers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// orders this thread's generic-proxy accesses to shared memory before later
// async-proxy ones (the TMA engine's writes into the same ring slot)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses to accumulators across the wgmma
// fences and waits
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a SWIZZLE_128B operand: start address,
// leading and stride byte offsets (all >> 4), layout type 1 (128B swizzle).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (1ull << 62);
}

// d[N/2] = A (m64 x k16, bf16 fragments in registers) * B (k16 x nN, bf16,
// MN-major in shared memory: 64-column blocks LBO apart) + (accumulate ? d :
// 0), f32. Thread (warp w, lane l) holds d[i] of row 16w + l/4 +
// 8((i/2)%2), column 8(i/4) + 2(l%4) + i%2.
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

// tf32 and s8 take only K-major operands. Shared-memory descriptor of a
// K-major operand without swizzle (layout type 0): 8 x 16-byte core
// matrices, each 128 contiguous bytes; the leading byte offset steps along
// K (between the two 16-byte halves of a 32-byte step), the stride byte
// offset along N (between groups of 8 columns): the 16-byte chunk kc (0,
// 1) of column n sits at byte (n / 8) * 256 + kc * 128 + (n % 8) * 16.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  constexpr uint32_t LBO = 128, SBO = 256;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(LBO >> 4) << 16) |
         (static_cast<uint64_t>(SBO >> 4) << 32);
}

// f32 -> tf32 (an f32 bit pattern with the low 13 mantissa bits zero),
// rounded to nearest, ties away from zero. Rounded explicitly: the tensor
// cores would truncate raw f32 bits, and lo = v - hi is the remainder only
// of the hi they are given.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[32] = A (m64 x k8, tf32 fragments in registers: thread (warp w, lane l)
// holds rows 16w + l/4 (+8 in a1, a3), columns l%4 (+4 in a2, a3)) * B (k8
// x n64, tf32, K-major in shared memory) + (accumulate ? d : 0), f32.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

// d[32] = A (m64 x k32, s8 fragments in registers: rows as wgmma_tf32,
// bytes 4 (l%4) .. +3 (+16 in a2, a3)) * B (k32 x n64, s8, K-major in
// shared memory) + (accumulate ? d : 0), s32 (exact).
__device__ __forceinline__ void wgmma_s8(int (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

// ---- mbarriers and register reallocation

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// release: the arriving thread's earlier shared-memory writes are visible to
// a thread whose wait sees the phase complete
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// bulk copy (TMA engine) of `bytes` from global to shared memory, counted
// on mbarrier `bar` as transactions
__device__ __forceinline__ void bulk_copy_g2s(uint32_t dst, const void* src,
                                              uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// arrives (count 1) and adds `bytes` to the transactions the phase waits for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// TMA copy of the 4-D box at coordinates (c0, c1, c2, c3) of tensor map
// `map` (a kernel parameter) to shared memory, counted on mbarrier `bar`;
// coordinates out of the tensor (negative ones included) read zeros
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// waits until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// the consumer threads only (named barrier 1)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CT) : "memory");
}

// the producer threads only (named barrier 2)
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(PT) : "memory");
}

// until at most N of this thread's newest cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---- taps

// Step r of a stage of output phase ph (CONVT: 0..3 = (a, b) = (ph / 2, ph
// % 2)): the tap (ky * 3 + kx) of the HWIO weight and its input offset (dy,
// dx) from the output's own input pixel. Along an axis, phase 0 takes tap
// 1 at offset 0, phase 1 taps 0 and 2 at offsets 0 and 1.
__device__ __forceinline__ int convt_ntaps(int ph) {
  return (1 + (ph >> 1)) * (1 + (ph & 1));
}

__device__ __forceinline__ void convt_tap(int ph, int r, int& tap, int& dy,
                                          int& dx) {
  const int a = ph >> 1, b = ph & 1;
  const int iy = r / (1 + b), ix = r % (1 + b);
  dy = a ? iy : 0;
  dx = b ? ix : 0;
  tap = (a ? 2 * iy : 1) * 3 + (b ? 2 * ix : 1);
}

// CONVT's packed weights hold the taps phase by phase (positions 0 | 1-2 |
// 3-4 | 5-8: taps 4 | 3 5 | 1 7 | 0 2 6 8), so that a stage's taps are one
// bulk copy: phase ph starts at position convt_first(ph).
__device__ __forceinline__ int convt_first(int ph) {
  return ph == 0 ? 0 : 2 * ph - 1;
}

// The tap at position pos of a stage's packed weights.
template <class G>
__device__ __forceinline__ int image_tap(int pos) {
  if constexpr (G::TRANSPOSED) {
    const int ph = pos == 0 ? 0 : (pos <= 2 ? 1 : (pos <= 4 ? 2 : 3));
    int tap, dy, dx;
    convt_tap(ph, pos - convt_first(ph), tap, dy, dx);
    return tap;
  } else {
    return pos;
  }
}

// Staged-pixel offset of step r from the step's base pixel (output row
// orow, column oc of the tile: slab pixel orow * PW + oc of plane 0).
template <class G>
__device__ __forceinline__ int step_delta(int ph, int r) {
  if constexpr (G::TRANSPOSED) {
    int tap, dy, dx;
    convt_tap(ph, r, tap, dy, dx);
    return dy * G::PW + dx;
  } else {
    const int ky = r / 3, kx = r % 3;
    return ((ky % G::STRIDE) * G::STRIDE + kx % G::STRIDE) * G::PLANE_PIX +
           (ky / G::STRIDE) * G::PW + kx / G::STRIDE;
  }
}

// ---- staging (producer)

// Byte offset of 16-byte chunk c of staged pixel P (plane-major index):
// 8 adjacent pixels of a plane row land in 8 distinct 16-byte bank groups.
__device__ __forceinline__ int slab_off(int P, int c) {
  return (P * CPP + (c ^ ((P / (8 / CPP)) % CPP))) * 16;
}

// Staged pixel index of slab position (sr, sc) in its phase plane (by row
// and column parity at stride 2).
template <class G>
__device__ __forceinline__ int slab_pixel(int sr, int sc) {
  return ((sr % G::STRIDE) * G::STRIDE + sc % G::STRIDE) * G::PLANE_PIX +
         (sr / G::STRIDE) * G::PW + sc / G::STRIDE;
}

// One work item: a tile of TM x TN pixels, one output phase and BN output
// channels of one sample. Items run channel block fastest, then phase, then
// tile, then sample, so that the CTAs in flight share their input slabs
// and weights in L2; the phase order rotates with the tile.
struct Item {
  int s, tile, ph, n0, r0, c0;
};

template <class G>
__device__ __forceinline__ Item item_of(int it, int n_nb, int n_tiles,
                                        int tiles_w) {
  Item q;
  q.n0 = (it % n_nb) * G::BN;
  const int p = (it / n_nb) % G::NPH;
  const int rest = it / (n_nb * G::NPH);
  q.tile = rest % n_tiles;
  q.s = rest / n_tiles;
  q.ph = (p + q.tile) % G::NPH;
  q.r0 = (q.tile / tiles_w) * TM;
  q.c0 = (q.tile % tiles_w) * TN;
  return q;
}

// A CTA's steps in order: items blockIdx.x, + gridDim.x, ..., n_k stages
// each. Advancing is a compare; item_of's divisions run once per item.
struct Cursor {
  int it, kk;
  Item q;
};

template <class G>
__device__ __forceinline__ Cursor cursor_start(int n_nb, int n_tiles,
                                               int tiles_w) {
  return Cursor{(int)blockIdx.x, 0,
                item_of<G>(blockIdx.x, n_nb, n_tiles, tiles_w)};
}

template <class G>
__device__ __forceinline__ void cursor_next(Cursor& c, int n_k, int n_nb,
                                            int n_tiles, int tiles_w) {
  if (++c.kk == n_k) {
    c.kk = 0;
    c.it += gridDim.x;
    c.q = item_of<G>(c.it, n_nb, n_tiles, tiles_w);
  }
}

// The producer threads' slab tables: entry i of thread p describes slab
// chunk e = p + i * PT (chunk e % CPP of slab pixel e / CPP): its byte
// offset (16 bits), slab row and column (8 bits each); all ones past the
// slab. The same for every stage and item.
template <class G>
__device__ __forceinline__ void fill_table(uint32_t* table, int p) {
  for (int i = 0; i < G::NE; ++i) {
    const int e = p + i * PT;
    uint32_t ent = 0xffffffffu;
    if (e < G::SLAB_ELEMS) {
      const int pix = e / CPP;
      const int sr = pix / G::SW, sc = pix % G::SW;
      ent = static_cast<uint32_t>(slab_off(slab_pixel<G>(sr, sc), e % CPP)) |
            (static_cast<uint32_t>(sr) << 16) |
            (static_cast<uint32_t>(sc) << 24);
    }
    table[i * PT + p] = ent;
  }
}

// Which of producer thread p's slab chunks (table entries) of item q have
// a source pixel (src, bit i: entry i; false: zero pad, past the edge or
// the halo of a ragged tile: the TMA engine loaded zeros there) and which
// of those are reflected halo pixels (refl), whose source the TMA engine did
// not load there. The same for every stage of the item.
template <class G>
__device__ __forceinline__ void slab_masks(uint32_t& src, uint32_t& refl,
                                           const uint32_t* table,
                                           const Item& q, int H, int W,
                                           bool reflect, int p) {
  const int ir0 = q.r0 * G::STRIDE - G::PAD;
  const int ic0 = q.c0 * G::STRIDE - G::PAD;
  src = 0;
  refl = 0;
#pragma unroll
  for (int i = 0; i < G::NE; ++i) {
    const uint32_t ent = table[i * PT + p];
    const int ir = ir0 + ((ent >> 16) & 0xff), ic = ic0 + (ent >> 24);
    const int gr = conv3x3::src_index(ir, H, reflect);
    const int gc = conv3x3::src_index(ic, W, reflect);
    const bool ok = ent != 0xffffffffu && gr >= 0 && gc >= 0;
    src |= static_cast<uint32_t>(ok) << i;
    refl |= static_cast<uint32_t>(ok && (gr != ir || gc != ic)) << i;
  }
}

// Reflect padding, once a stage landed: producer thread p copies its
// reflected halo chunks (refl) from their source pixels, which lie in the
// same slab, before any chunk is transformed.
template <class G>
__device__ __forceinline__ void fix_halo(char* stage, const uint32_t* table,
                                         uint32_t refl, const Item& q, int H,
                                         int W, int p) {
  char* slab = stage + G::W_BYTES;
  const int ir0 = q.r0 * G::STRIDE - G::PAD;
  const int ic0 = q.c0 * G::STRIDE - G::PAD;
#pragma unroll
  for (int i = 0; i < G::NE; ++i) {
    if (!((refl >> i) & 1u)) continue;
    const uint32_t ent = table[i * PT + p];
    const int gr = conv3x3::src_index(ir0 + ((ent >> 16) & 0xff), H, true);
    const int gc = conv3x3::src_index(ic0 + (ent >> 24), W, true);
    *reinterpret_cast<uint4*>(slab + (ent & 0xffff)) =
        *reinterpret_cast<const uint4*>(
            slab + slab_off(slab_pixel<G>(gr - ir0, gc - ic0), p % CPP));
  }
}

// Producer thread p < 2 KC / 4 copies 4 channels of the stage's norm scale
// (p < KC / 4) or bias into the slot's aff[2 KC] (scale at 0, bias at KC),
// zero past Cin, in its cp.async group of the stage; they are read by every
// producer thread after a producer_sync.
template <class G>
__device__ __forceinline__ void load_affine(float* aff, const float* in_scale,
                                            const float* in_bias, int s, int k0,
                                            int Cin, int p) {
  constexpr int N4 = G::KC / 4;
  const int k = k0 + 4 * (p % N4);
  const float* src = (p < N4 ? in_scale : in_bias) + (size_t)s * Cin + k;
  conv3x3::cp_async16(aff + 4 * p, k < Cin ? src : in_scale, k < Cin);
}

// After a stage landed: the affine and ReLU in place on producer thread
// p's slab chunks that had a source (mask); the zero-filled ones stay zero.
// aff: the slot's scale and bias. bf16: scale and bias rounded to bf16, the
// product and the sum each rounded to nearest, no fused multiply-add; f32:
// the product and the sum each rounded to nearest.
template <class G>
__device__ __forceinline__ void transform_stage(char* stage,
                                                const uint32_t* table,
                                                uint32_t mask,
                                                const float* aff,
                                                bool has_affine, bool in_relu,
                                                int p) {
  if ((!has_affine && !in_relu) || mask == 0) return;
  constexpr bool F32 = G::OP == OP_TF32;
  const int c0 = G::EPC * (p % CPP);
  char* slab = stage + G::W_BYTES;
  // the scale and bias of the thread's 16-byte chunk: 4 f32 or 4 bf16 pairs
  using SB = std::conditional_t<F32, float, __nv_bfloat162>;
  const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
  SB sc[4], bi[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (F32) {
      sc[j] = has_affine ? aff[c0 + j] : 0.f;
      bi[j] = has_affine ? aff[G::KC + c0 + j] : 0.f;
    } else {
      sc[j] = has_affine ? __floats2bfloat162_rn(aff[c0 + 2 * j],
                                                 aff[c0 + 2 * j + 1])
                         : zero;
      bi[j] = has_affine ? __floats2bfloat162_rn(aff[G::KC + c0 + 2 * j],
                                                 aff[G::KC + c0 + 2 * j + 1])
                         : zero;
    }
  }
  constexpr int TB = 2;   // chunks whose loads are in flight together
#pragma unroll
  for (int i0 = 0; i0 < G::NE; i0 += TB) {
    uint32_t off[TB];
    uint4 v[TB];
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      off[b] = i0 + b < G::NE ? table[(i0 + b) * PT + p] & 0xffff : 0;
      if (i0 + b < G::NE && ((mask >> (i0 + b)) & 1u))
        v[b] = *reinterpret_cast<const uint4*>(slab + off[b]);
    }
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      if (i0 + b >= G::NE || !((mask >> (i0 + b)) & 1u)) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (F32) {
          float* f = reinterpret_cast<float*>(&v[b]);
          if (has_affine) f[j] = __fadd_rn(__fmul_rn(f[j], sc[j]), bi[j]);
          if (in_relu) f[j] = fmaxf(f[j], 0.f);
        } else {
          __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v[b]);
          if (has_affine) h[j] = __hadd2_rn(__hmul2_rn(h[j], sc[j]), bi[j]);
          if (in_relu) h[j] = __hmax2(h[j], zero);
        }
      }
      *reinterpret_cast<uint4*>(slab + off[b]) = v[b];
    }
  }
}

// ---- the tensor-core work of one stage, per consumer warpgroup: its two
// m64 tiles, the A fragments of a k16 step per tap (load_a; weights of step
// r at slot position r). CONV_S1 / CONV_S2 (compute_stage): each tile runs
// one unit of the stage's 9 steps into a fresh f32 temporary, which is
// added to acc[j] (round to nearest) once the unit completed, just before
// the next unit reuses it and its A fragments (a drain per unit). s8: both
// m64 tiles' 9 steps straight into the int32 sums (exact, so no unit
// temporaries), waited for once per stage; first: the item's first stage,
// which starts the sums.

template <class G, int T, int N>
__device__ __forceinline__ void load_a(uint32_t (&a)[N][4], uint32_t slab_s,
                                       int ph, int orow, int lane) {
  static_assert(T <= N, "A registers for every step");
  // ldmatrix.x4: lane l gives the address of row l % 8 of matrix l / 8;
  // matrices 0-3 = (pixels 0-7 | 8-15) x (channels 0-7 | 8-15) of the k16
  // step, which is the RS A fragment order a0..a3
  const int oc = (lane & 7) + 8 * ((lane >> 3) & 1);   // output column
  const int kc = lane >> 4;                            // chunk of the step
  const int base = orow * G::PW + oc;
#pragma unroll
  for (int r = 0; r < T; ++r)
    ldmatrix_x4(a[r], slab_s + slab_off(base + step_delta<G>(ph, r), kc));
}

template <class G>
__device__ __forceinline__ void compute_stage(
    const char* stage, typename G::AT (&acc)[M_SUB][G::BN / 2], int row0,
    int lane, bool first) {
  constexpr int T = 9;     // the taps
  const uint32_t w_s = smem_u32(stage);
  const uint32_t slab_s = smem_u32(stage + G::W_BYTES);
  if constexpr (G::OP == OP_S8) {
    uint32_t a[M_SUB][T][4];
#pragma unroll
    for (int j = 0; j < M_SUB; ++j)
      load_a<G, T>(a[j], slab_s, 0, row0 + 4 * j, lane);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < M_SUB; ++j)
#pragma unroll
      for (int r = 0; r < T; ++r)
        wgmma_s8(acc[j], a[j][r], desc_kmajor(w_s + r * G::WTAP_BYTES),
                 r > 0 || !first);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < M_SUB; ++j) fence_regs(acc[j]);
  } else {
    uint32_t a[T][4];        // A of a unit
    float tmp[G::BN / 2];    // the unit's temporary
#pragma unroll
    for (int j = 0; j < M_SUB; ++j) {
      if (j > 0) {   // fold the previous unit
        wgmma_wait<0>();
        fence_regs(tmp);
#pragma unroll
        for (int i = 0; i < G::BN / 2; ++i) acc[j - 1][i] += tmp[i];
      }
      load_a<G, T>(a, slab_s, 0, row0 + 4 * j, lane);
      if constexpr (G::OP == OP_TF32) {
        // the split of u (f32 bits in a): hi in a, lo = tf32(u - hi), exact
        uint32_t lo[T][4];
#pragma unroll
        for (int r = 0; r < T; ++r)
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const float u = __uint_as_float(a[r][m]);
            a[r][m] = tf32_rna(u);
            lo[r][m] = tf32_rna(u - __uint_as_float(a[r][m]));
          }
        wgmma_fence();
#pragma unroll
        for (int r = 0; r < T; ++r) {
          const uint32_t wt = w_s + r * G::WTAP_BYTES;   // hi plane, lo after
          wgmma_tf32(tmp, a[r], desc_kmajor(wt), r > 0);
          wgmma_tf32(tmp, a[r], desc_kmajor(wt + G::WPLANE_BYTES), 1);
          wgmma_tf32(tmp, lo[r], desc_kmajor(wt), 1);
        }
      } else {
        wgmma_fence();
#pragma unroll
        for (int r = 0; r < T; ++r)
          wgmma_rs(tmp, a[r],
                   desc_sw128(w_s + r * G::WTAP_BYTES, G::WBLK_BYTES, 8 * 128),
                   r > 0);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(tmp);
#pragma unroll
    for (int i = 0; i < G::BN / 2; ++i) acc[M_SUB - 1][i] += tmp[i];
  }
}

// CONVT's work of a stage, with the folds deferred (n64): each m64 tile j has
// a temporary of its own, tmp[j], that runs a unit of up to UK_DEFER k16
// steps over several stages of an item (fresh: the unit starts here,
// scale-d 0) and is folded into acc[j] (round to nearest) when the unit
// ends; both tiles' wgmmas of a stage run back to back and are waited for
// once, so the tensor cores are drained once per stage, not per unit.
// The input's affine and ReLU run here, on the A fragments (xf): a phase
// item would otherwise have the producer transform its tile's slab a
// fourth time.
constexpr int UK_DEFER = 8;

// The affine (bf16, as transform_stage) and ReLU on a consumer's A
// fragments of a stage, zero where the pixel has no source. Thread l holds,
// in fragment m of a step, pixel l / 4 + 8 (m % 2) of its tile row and
// channels 8 (m / 2) + 2 (l % 4) + {0, 1} of the stage.
struct FragAffine {
  __nv_bfloat162 s2[2], b2[2];   // per channel pair (m / 2)
  bool affine, relu;
  int ir0, ic0, H, W;            // the tile's input origin, the input's size
};

template <int T>
__device__ __forceinline__ void transform_a(uint32_t (&a)[4][4],
                                            const FragAffine& xf, int ph,
                                            int orow, int lane) {
  const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll
  for (int r = 0; r < T; ++r) {
    int tap, dy, dx;
    convt_tap(ph, r, tap, dy, dx);
    const bool row_ok = xf.ir0 + orow + dy < xf.H;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const bool ok =
          row_ok && xf.ic0 + (lane >> 2) + 8 * (m & 1) + dx < xf.W;
      __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&a[r][m]);
      if (xf.affine)
        h = __hadd2_rn(__hmul2_rn(h, xf.s2[m >> 1]), xf.b2[m >> 1]);
      if (xf.relu) h = __hmax2(h, zero);
      if (!ok) h = zero;
      a[r][m] = *reinterpret_cast<uint32_t*>(&h);
    }
  }
}

template <class G, int T>
__device__ __forceinline__ void stage_deferred(
    const char* stage, float (&acc)[M_SUB][G::BN / 2],
    float (&tmp)[M_SUB][G::BN / 2], uint32_t (&a)[M_SUB][4][4], int ph,
    int row0, int lane, bool fresh, bool unit_end, const FragAffine& xf) {
  const uint32_t w_s = smem_u32(stage);
  const uint32_t slab_s = smem_u32(stage + G::W_BYTES);
#pragma unroll
  for (int j = 0; j < M_SUB; ++j) {
    load_a<G, T>(a[j], slab_s, ph, row0 + 4 * j, lane);
    if (xf.affine || xf.relu) transform_a<T>(a[j], xf, ph, row0 + 4 * j, lane);
  }
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < M_SUB; ++j)
#pragma unroll
    for (int r = 0; r < T; ++r)
      wgmma_rs(tmp[j], a[j][r],
               desc_sw128(w_s + r * G::WTAP_BYTES, G::WBLK_BYTES, 8 * 128),
               r > 0 || !fresh);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < M_SUB; ++j) {
    fence_regs(tmp[j]);
    if (unit_end) {
#pragma unroll
      for (int i = 0; i < G::BN / 2; ++i) acc[j][i] += tmp[j][i];
    }
  }
}

// y (bf16; tf32: f32) and the item's per-channel partial statistics (see
// the header); cw: consumer warp 0..7, ct: consumer thread 0..255. Ho x Wo
// is the tile grid's extent (CONVT: the input's; y is 2Ho x 2Wo).
template <class G>
__device__ __forceinline__ void epilogue(float (&acc)[M_SUB][G::BN / 2],
                                         const Item& q, int row0, int cw,
                                         int lane, int ct, float* red,
                                         typename G::YT* __restrict__ y,
                                         float* __restrict__ partial, int Ho,
                                         int Wo, int Cout, int n_tiles) {
  constexpr int NV = G::BN / 8;   // 8-channel groups of a row of acc
  constexpr int OS = G::TRANSPOSED ? 2 : 1;
  // this thread's pixels (four) summed per channel (its BN / 4 channels
  // 8 v + 2 (lane % 4) + {0, 1}, v < NV) in a fixed order
  float psum[2 * NV], psq[2 * NV];
#pragma unroll
  for (int n = 0; n < 2 * NV; ++n) {
    psum[n] = 0.f;
    psq[n] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < M_SUB; ++j) {
    const int tr = q.r0 + row0 + 4 * j;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tc = q.c0 + (lane >> 2) + 8 * h;
      if (tr < Ho && tc < Wo) {
        const int gr = OS * tr + (G::TRANSPOSED ? q.ph >> 1 : 0);
        const int gc = OS * tc + (G::TRANSPOSED ? q.ph & 1 : 0);
        typename G::YT* yp =
            y + (((size_t)q.s * OS * Ho + gr) * OS * Wo + gc) * Cout + q.n0;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const float a0 = acc[j][4 * v + 2 * h];
          const float a1 = acc[j][4 * v + 2 * h + 1];
          const int co = 8 * v + 2 * (lane & 3);
          // Cout % 8 == 0: a channel pair is in range or out of it together
          if (q.n0 + co < Cout) {
            if constexpr (G::OP == OP_TF32)
              *reinterpret_cast<float2*>(yp + co) = make_float2(a0, a1);
            else
              *reinterpret_cast<unsigned*>(yp + co) =
                  conv3x3::pack_bf16x2(a0, a1);
          }
          psum[2 * v] += a0;
          psum[2 * v + 1] += a1;
          psq[2 * v] += a0 * a0;
          psq[2 * v + 1] += a1 * a1;
        }
      }
    }
  }
  // the 8 lanes that hold the same channels (lane % 4 equal), butterfly
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
#pragma unroll
    for (int n = 0; n < 2 * NV; ++n) {
      psum[n] += __shfl_xor_sync(0xffffffffu, psum[n], off);
      psq[n] += __shfl_xor_sync(0xffffffffu, psq[n], off);
    }
  }
  // then the 8 consumer warps in warp order
  if (lane < 4) {
#pragma unroll
    for (int n = 0; n < 2 * NV; ++n) {
      const int ch = 8 * (n / 2) + 2 * lane + n % 2;
      red[(cw * G::BN + ch) * 2] = psum[n];
      red[(cw * G::BN + ch) * 2 + 1] = psq[n];
    }
  }
  consumer_sync();
  const int ch = ct % G::BN;
  const int qq = ct / G::BN;   // 0: sum, 1: sum of squares (BN 64: 2, 3 idle)
  if (qq < 2 && q.n0 + ch < Cout) {
    float v = 0.f;
#pragma unroll
    for (int wp = 0; wp < CT / 32; ++wp) v += red[(wp * G::BN + ch) * 2 + qq];
    partial[((size_t)q.s * n_tiles * G::NPH + q.tile * G::NPH + q.ph) * 2 *
                Cout +
            qq * Cout + q.n0 + ch] = v;
  }
  consumer_sync();   // red is read before the next item writes it
}

// Lays the weights out once per call as the ring's weight image of every
// (channel block, stage): wp[nb][kb] = WIMG_BYTES in the shared-memory
// order of a stage of all 9 taps (tap position (image_tap)), zero past Cin
// and Cout, so that a stage's weights are one bulk copy. bf16: per tap the
// MN-major 64-column blocks of KC input channel rows, swizzled 16-byte
// chunks (SWIZZLE_128B). tf32 and s8: per tap (and plane: tf32 hi = tf32(w),
// then lo = tf32(w - hi)) the K-major core matrices of desc_kmajor, chunk
// kc of column n holding input channels kc * EPC .. + EPC - 1 of the stage.
template <class G>
__global__ void pack_weights_kernel(const typename G::WT* __restrict__ w,
                                    uint4* __restrict__ wp, int Cin, int Cout,
                                    int n_k, int n_nb) {
  constexpr int CH = G::WIMG_BYTES / 16;   // chunks per stage image
  const long total = (long)n_nb * n_k * CH;
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < total;
       i += (long)gridDim.x * blockDim.x) {
    const int chunk = static_cast<int>(i % CH);
    const int kb = static_cast<int>((i / CH) % n_k);
    const int nb = static_cast<int>(i / ((long)CH * n_k));
    const int tap = image_tap<G>(chunk / (G::WTAP_BYTES / 16));
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (G::OP == OP_BF16) {
      const int blk = (chunk / (G::WBLK_BYTES / 16)) % G::NB64;
      const int k = (chunk / 8) % G::KC;
      const int jj = (chunk % 8) ^ (k % 8);   // the swizzle, undone
      const int co = nb * G::BN + blk * 64 + jj * 8;
      const int ci = kb * G::KC + k;
      if (ci < Cin && co < Cout)
        v = *reinterpret_cast<const uint4*>(w + ((size_t)tap * Cin + ci) *
                                                    Cout + co);
    } else {
      const int pc = chunk % (G::WPLANE_BYTES / 16);   // chunk in its plane
      const int plane = (chunk / (G::WPLANE_BYTES / 16)) % G::NPLANE;
      const int n = (pc / 16) * 8 + pc % 8;   // desc_kmajor's layout, undone
      const int co = nb * G::BN + n;
      const int ci0 = kb * G::KC + ((pc / 8) % 2) * G::EPC;
      uint32_t word[4] = {0u, 0u, 0u, 0u};
      if (co < Cout) {
#pragma unroll
        for (int e = 0; e < G::EPC; ++e) {
          const int ci = ci0 + e;
          if (ci >= Cin) break;
          const typename G::WT wv = w[((size_t)tap * Cin + ci) * Cout + co];
          if constexpr (G::OP == OP_TF32) {
            const uint32_t hi = tf32_rna(wv);
            word[e] = plane == 0 ? hi : tf32_rna(wv - __uint_as_float(hi));
          } else {
            word[e / 4] |= (static_cast<uint32_t>(wv) & 0xffu) << (8 * (e % 4));
          }
        }
      }
      v = make_uint4(word[0], word[1], word[2], word[3]);
    }
    wp[i] = v;
  }
}

// s8: the dequant of the int32 sums, yf = f32(acc) * deq[co] (dynamic:
// deq[co] * (m / 127), m = max(m_raw[s, chunk], 1e-12) of the item's
// 16-row chunk), and the layout of the quantized blocks the slab is loaded
// from: (S * n_chunks, chunk + 2 halo rows, W + 2, Cin rounded up to 16).
struct Dequant {
  const float* deq;
  const float* m_raw;
  int n_chunks;
  bool dynamic;
};

template <class G>
__device__ __forceinline__ void dequant(const int (&acc)[M_SUB][G::BN / 2],
                                        float (&yf)[M_SUB][G::BN / 2],
                                        const Item& q, int lane,
                                        const Dequant& dq, int Cout) {
  const float m =
      dq.dynamic ? fmaxf(dq.m_raw[(size_t)q.s * dq.n_chunks + q.r0 / TM],
                         1e-12f)
                 : 0.f;
#pragma unroll
  for (int i = 0; i < G::BN / 2; ++i) {
    const int co = q.n0 + 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
    float d = co < Cout ? dq.deq[co] : 0.f;
    if (dq.dynamic) d = __fmul_rn(d, m / 127.f);
#pragma unroll
    for (int j = 0; j < M_SUB; ++j)
      yf[j][i] = __fmul_rn(static_cast<float>(acc[j][i]), d);
  }
}

template <class G>
__global__ void __launch_bounds__(NT, 1)
conv_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                  const char* __restrict__ wp,
                  const float* __restrict__ in_scale,
                  const float* __restrict__ in_bias,
                  typename G::YT* __restrict__ y,
                  float* __restrict__ partial, int H, int W, int Ho, int Wo,
                  int Cin, int Cout, int tiles_w, int n_tiles, int n_nb,
                  int n_items, bool reflect, bool has_affine, bool in_relu,
                  Dequant dq) {
  extern __shared__ __align__(16) char smem_raw[];
  // the 128B-swizzled weight blocks need 1024-byte aligned addresses
  char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  char* tail = smem + G::NST * G::STAGE_BYTES;
  float* red = reinterpret_cast<float*>(tail);
  uint32_t* table = reinterpret_cast<uint32_t*>(tail + G::RED_BYTES);
  // src_mask[slot][PT], then refl_mask[slot][PT]
  uint32_t* masks =
      reinterpret_cast<uint32_t*>(tail + G::RED_BYTES + G::TABLE_BYTES);
  float* aff = reinterpret_cast<float*>(tail + G::RED_BYTES + G::TABLE_BYTES +
                                        G::MASK_BYTES);
  const uint32_t bars = smem_u32(tail + G::RED_BYTES + G::TABLE_BYTES +
                                 G::MASK_BYTES + G::AFF_BYTES);
  // full[i] at bars + 8 i, empty[i] at bars + 8 (NST + i), landed[i] at
  // bars + 8 (2 NST + i)
  const int t = threadIdx.x;
  if (t == 0) {
    for (int i = 0; i < G::NST; ++i) {
      mbar_init(bars + 8 * i, PT);
      mbar_init(bars + 8 * (G::NST + i), CT);
      mbar_init(bars + 8 * (2 * G::NST + i), 1);
    }
    // the barriers' initialization visible to the TMA engine
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (t < PT) fill_table<G>(table, t);
  __syncthreads();
  const int n_k = (Cin + G::KC - 1) / G::KC;
  const int my_items =
      (n_items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int n_steps = my_items * n_k;

  if (t < PT) {
    // ---- producer: steps g + 1 .. g + AHEAD are loading while the
    // consumers run step g - 1 and g lands; once g landed it is transformed
    // and handed over
    reg_dealloc<PRODUCER_REGS>();
    // whether a stage needs the producer's pass over its slab (CONVT's
    // consumers apply the affine and ReLU to their A fragments)
    const bool touch = !G::TRANSPOSED && (has_affine || in_relu || reflect);
    Cursor ic = cursor_start<G>(n_nb, n_tiles, tiles_w);   // next to issue
    Cursor tc = ic;                                         // next to hand over
    uint32_t item_src = 0, item_refl = 0;   // slab_masks of ic's item
    auto issue = [&](int g) {   // step g, at ic
      const int slot = g % G::NST;
      if (g >= G::NST)   // the consumers are done with step g - NST
        mbar_wait(bars + 8 * (G::NST + slot), (g / G::NST - 1) & 1);
      const Item& q = ic.q;
      char* stage = smem + slot * G::STAGE_BYTES;
      if (t == 0) {   // the stage's weights (one bulk copy) and input slab
        const uint32_t landed = bars + 8 * (2 * G::NST + slot);
        const int n_tap = G::TRANSPOSED ? convt_ntaps(q.ph) : 9;
        const int first = G::TRANSPOSED ? convt_first(q.ph) : 0;
        mbar_arrive_expect_tx(landed, n_tap * G::WTAP_BYTES + G::SLAB_TX);
        bulk_copy_g2s(smem_u32(stage),
                      wp + ((size_t)(q.n0 / G::BN) * n_k + ic.kk) *
                               G::WIMG_BYTES + first * G::WTAP_BYTES,
                      n_tap * G::WTAP_BYTES, landed);
        if constexpr (G::PREQ) {   // the item's chunk block, halo included
          tma_load_4d(smem_u32(stage + G::W_BYTES), &x_map, ic.kk * G::KC,
                      q.c0, 0, q.s * dq.n_chunks + q.r0 / TM, landed);
        } else {   // one box per plane: rows and columns of its parity
          for (int pl = 0; pl < G::NPL; ++pl)
            tma_load_4d(
                smem_u32(stage + G::W_BYTES + pl * G::PLANE_PIX * 32),
                &x_map, ic.kk * G::KC,
                q.c0 * G::STRIDE - G::PAD + pl % G::STRIDE,
                q.r0 * G::STRIDE - G::PAD + pl / G::STRIDE, q.s, landed);
        }
      }
      if (touch) {
        if (ic.kk == 0)
          slab_masks<G>(item_src, item_refl, table, q, H, W, reflect, t);
        // a channel past Cin has no source either (the thread's chunk is the
        // same EPC channels of every pixel)
        const bool ch_ok = ic.kk * G::KC + G::EPC * (t % CPP) < Cin;
        masks[slot * PT + t] = ch_ok ? item_src : 0u;
        masks[(G::NST + slot) * PT + t] = ch_ok ? item_refl : 0u;
      }
      if (has_affine && t < 2 * G::KC / 4)
        load_affine<G>(aff + slot * 2 * G::KC, in_scale, in_bias, q.s,
                       ic.kk * G::KC, Cin, t);
      cursor_next<G>(ic, n_k, n_nb, n_tiles, tiles_w);
    };
    for (int g = 0; g < G::AHEAD; ++g) {
      if (g < n_steps) issue(g);
      conv3x3::cp_async_commit();
    }
    for (int g = 0; g < n_steps; ++g) {
      const int slot = g % G::NST;
      char* stage = smem + slot * G::STAGE_BYTES;
      mbar_wait(bars + 8 * (2 * G::NST + slot), (g / G::NST) & 1);
      if (has_affine) cp_async_wait<G::AHEAD - 1>();   // its affine copies
      if (touch) {
        if (reflect) {
          fix_halo<G>(stage, table, masks[(G::NST + slot) * PT + t], tc.q, H,
                      W, t);
        }
        // every thread's affine copies and halo chunks
        if (has_affine || reflect) producer_sync();
        transform_stage<G>(stage, table, masks[slot * PT + t],
                           aff + slot * 2 * G::KC, has_affine, in_relu, t);
        // these generic-proxy writes before the TMA engine's next ones
        fence_proxy_async();
      }
      mbar_arrive(bars + 8 * slot);
      if (g + G::AHEAD < n_steps) issue(g + G::AHEAD);
      conv3x3::cp_async_commit();
      cursor_next<G>(tc, n_k, n_nb, n_tiles, tiles_w);
    }
  } else {
    // ---- consumers
    reg_alloc<CONSUMER_REGS>();
    const int ct = t - PT;
    const int cw = ct >> 5;      // consumer warp 0..7
    const int lane = t & 31;
    // warpgroup g (0, 1), warp w of it: rows 8 g + w and 8 g + 4 + w
    const int row0 = 8 * (cw >> 2) + (cw & 3);
    Cursor cc = cursor_start<G>(n_nb, n_tiles, tiles_w);
    typename G::AT acc[M_SUB][G::BN / 2];
#pragma unroll
    for (int j = 0; j < M_SUB; ++j)
#pragma unroll
      for (int i = 0; i < G::BN / 2; ++i) acc[j][i] = 0;
    // CONVT: the temporaries of the deferred units, and the A fragments
    float tmp[M_SUB][G::BN / 2];
    uint32_t a[M_SUB][4][4];
    for (int g = 0; g < n_steps; ++g) {
      const int slot = g % G::NST;
      const Item& q = cc.q;
      const char* stage = smem + slot * G::STAGE_BYTES;
      const int kk = cc.kk;
      mbar_wait(bars + 8 * slot, (g / G::NST) & 1);
      if constexpr (G::TRANSPOSED) {
        // units of UK_DEFER steps: UK_DEFER / n_tap stages (n_tap 1, 2, 4)
        const int unit = UK_DEFER >> ((q.ph >> 1) + (q.ph & 1));
        const bool fresh = (kk & (unit - 1)) == 0;
        const bool unit_end = ((kk + 1) & (unit - 1)) == 0 || kk == n_k - 1;
        FragAffine xf{{}, {}, has_affine, in_relu, q.r0, q.c0, H, W};
        if (has_affine) {   // the slot's scale and bias of this thread's
                            // channel pairs
          const float* af = aff + slot * 2 * G::KC;
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int ch = 8 * c + 2 * (lane & 3);
            xf.s2[c] = __floats2bfloat162_rn(af[ch], af[ch + 1]);
            xf.b2[c] = __floats2bfloat162_rn(af[G::KC + ch],
                                             af[G::KC + ch + 1]);
          }
        }
        if (q.ph == 0)
          stage_deferred<G, 1>(stage, acc, tmp, a, q.ph, row0, lane, fresh,
                               unit_end, xf);
        else if (q.ph == 3)
          stage_deferred<G, 4>(stage, acc, tmp, a, q.ph, row0, lane, fresh,
                               unit_end, xf);
        else
          stage_deferred<G, 2>(stage, acc, tmp, a, q.ph, row0, lane, fresh,
                               unit_end, xf);
      } else {
        compute_stage<G>(stage, acc, row0, lane, kk == 0);
      }
      mbar_arrive(bars + 8 * (G::NST + slot));
      if (kk == n_k - 1) {
        if constexpr (G::OP == OP_S8) {   // the next item's first stage
                                          // starts its sums
          float yf[M_SUB][G::BN / 2];
          dequant<G>(acc, yf, q, lane, dq, Cout);
          epilogue<G>(yf, q, row0, cw, lane, ct, red, y, partial, Ho, Wo,
                      Cout, n_tiles);
        } else {
          epilogue<G>(acc, q, row0, cw, lane, ct, red, y, partial, Ho, Wo,
                      Cout, n_tiles);
#pragma unroll
          for (int j = 0; j < M_SUB; ++j)
#pragma unroll
            for (int i = 0; i < G::BN / 2; ++i) acc[j][i] = 0.f;
        }
      }
      cursor_next<G>(cc, n_k, n_nb, n_tiles, tiles_w);
    }
  }
}

inline int num_tiles(int Ho, int Wo) {
  return ((Ho + TM - 1) / TM) * ((Wo + TN - 1) / TN);
}

// Bytes of the packed-weight workspace that launch<G>() takes.
template <class G>
inline long wpack_bytes(int Cin, int Cout) {
  return (long)((Cout + G::BN - 1) / G::BN) * ((Cin + G::KC - 1) / G::KC) *
         G::WIMG_BYTES;
}

// cuTensorMapEncodeTiled of the driver API, fetched through the runtime
// (no link against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                            : nullptr;
  }();
  return fn;
}

// Channels per pixel of the s8 blocks: Cin rounded up to 16, so that a row
// of the blocks is a multiple of the 16 bytes that a tensor map's strides
// must be.
inline int s8_block_channels(int Cin) { return (Cin + 15) / 16 * 16; }

// The tensor map that the producer loads its slab planes with: boxes of KC
// channels (32 bytes) x PW x PH pixels (every STRIDE-th), 32-byte swizzled
// (16-byte chunk c of pixel P at c ^ ((P / 4) % 2), the slab's own layout),
// zeros outside the tensor. bf16 and tf32: x (S, H, W, Cin). s8: the
// quantized blocks (S * n_chunks, H / n_chunks + 2, W + 2,
// s8_block_channels(Cin)) int8, whose rows and columns hold the halo.
template <class G>
inline CUresult x_tensor_map(CUtensorMap* map, const void* x, int S, int H,
                             int W, int Cin, int n_chunks) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  cuuint64_t dims[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H,
                        (cuuint64_t)S};
  if constexpr (G::PREQ) {
    dims[0] = (cuuint64_t)s8_block_channels(Cin);
    dims[1] = (cuuint64_t)W + 2;
    dims[2] = (cuuint64_t)(H / n_chunks) + 2;
    dims[3] = (cuuint64_t)S * n_chunks;
  }
  const cuuint64_t strides[3] = {dims[0] * G::ESIZE,
                                 dims[1] * dims[0] * G::ESIZE,
                                 dims[2] * dims[1] * dims[0] * G::ESIZE};
  const cuuint32_t box[4] = {G::KC, G::PW * G::STRIDE, G::PH * G::STRIDE, 1};
  const cuuint32_t elem[4] = {1, G::STRIDE, G::STRIDE, 1};
  const CUtensorMapDataType type =
      G::OP == OP_TF32  ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
      : G::OP == OP_S8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode(map, type, 4, const_cast<void*>(x), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Packs the weights into `wpack`, launches the conv kernel (one persistent
// CTA per SM, at most one per item) and the stats reduction over the
// partials in (tile, phase) order on `st`; returns the first cudaError_t (0
// on success; 1000 + the CUresult if x's tensor map was refused).
// `partial` holds S x num_tiles x NPH x 2 x Cout floats. s8: x is the
// quantized blocks (x_tensor_map), which hold the input's affine, ReLU and
// padding, and dq its dequant.
template <class G>
inline int launch(const void* x, const typename G::WT* w, void* wpack,
                  const float* in_scale, const float* in_bias,
                  typename G::YT* y, float* partial, float* stats, int S,
                  int H, int W, int Cin, int Cout, bool reflect,
                  bool has_affine, bool in_relu, cudaStream_t st,
                  Dequant dq = Dequant{nullptr, nullptr, 1, false}) {
  if (Cin % 8 || Cout % 8 || H % G::STRIDE || W % G::STRIDE)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap x_map;
  const CUresult map_err =
      x_tensor_map<G>(&x_map, x, S, H, W, Cin, dq.n_chunks);
  if (map_err != CUDA_SUCCESS) return 1000 + static_cast<int>(map_err);
  // the tile grid's extent: the output's (CONVT: the input's)
  const int Ho = H / G::STRIDE;
  const int Wo = W / G::STRIDE;
  const int tiles_w = (Wo + TN - 1) / TN;
  const int n_tiles = num_tiles(Ho, Wo);
  const int n_nb = (Cout + G::BN - 1) / G::BN;
  const int n_items = S * n_tiles * G::NPH * n_nb;
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(conv_wgmma_kernel<G>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               G::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_k = (Cin + G::KC - 1) / G::KC;
  const long chunks = wpack_bytes<G>(Cin, Cout) / 16;
  const int pack_blocks =
      (int)((chunks + 255) / 256 < 4096 ? (chunks + 255) / 256 : 4096);
  pack_weights_kernel<G><<<pack_blocks, 256, 0, st>>>(
      w, static_cast<uint4*>(wpack), Cin, Cout, n_k, n_nb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = n_items < n_sm ? n_items : n_sm;
  conv_wgmma_kernel<G><<<grid, NT, G::SMEM, st>>>(
      x_map, static_cast<const char*>(wpack), in_scale, in_bias, y, partial,
      H, W, Ho, Wo, Cin, Cout, tiles_w, n_tiles, n_nb, n_items, reflect,
      has_affine, in_relu, dq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(conv3x3::launch_stats_reduce(
      partial, stats, S, n_tiles * G::NPH, Cout, st));
}

}  // namespace conv3x3_wgmma
