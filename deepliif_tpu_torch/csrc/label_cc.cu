// Connected-component labeling of a foreground mask on Hopper (sm_90a): a
// block-local union-find in shared memory per tile, unions in global memory
// only across tile borders, and the labels as the only global array.
//
// Replaces the TPU kernel deepliif_tpu/ops/labeling.py label_prop_pallas
// (K foreground-masked min-label sweeps of the whole canvas in VMEM) together
// with the loop that calls it, label_components_pallas (pointer jumping
// between calls until nothing changes), and gives the labels of the XLA
// label_components that the JAX device quantifier runs: for a mask fg (H, W)
// and 4- or 8-connectivity,
//
//   labels[i] = 0                                  if fg[i] == 0
//   labels[i] = 1 + min flat index of i's component otherwise
//
// The TPU version holds the whole canvas in VMEM and sweeps it K times per
// call. Here a canvas (268 MB of int32 labels at 67 MPx) fits in no on-chip
// memory, so the tile is the unit: a TH x TW tile (16 x 256) is
// labeled in one CTA's shared memory, and only the pixels on a tile's first
// row and first column unite across the border, in global memory. What
// bounds it is bytes: the mask read once (1 B/px) and the labels written once
// (4 B/px) at 3.35 TB/s. Three launches; what each moves:
//
//   1. local (1 B/px read, 4 B/px written). The CTA loads its tile's mask
//      with 16-byte loads as one 32-bit word per 32 pixels of a row. Runs of
//      foreground in a row are found from the bits (a run's pixels point at
//      its first pixel; no atomics), and runs of adjacent rows are united in
//      shared memory (atomicMin on local indices, links toward the smaller
//      index) only where a run first touches a run of the row above:
//        conn 4: p and up, unless left and up-left are foreground too;
//        conn 8: p and up-right where up is background; at a run's first
//                pixel, p and up, or else p and up-left.
//      Local raster order maps monotonically onto flat indices, so a local
//      root is the minimum flat index of its piece of the component. Each
//      pixel gets root + 1 (0 for background), written once, in 16-byte
//      stores. The giant background component of the conn-4 mask is cut
//      here into tile-sized pieces without a global atomic.
//   2. border (about (TH + TW) / (TH * TW) of the pixels: 6.6 % at 16 x 256;
//      a few bytes of mask around each, the labels of what it unites). A
//      warp per tile: a pixel on its first row (taken 32 at a time from the
//      mask's bits, as in pass 1) or first column unites with its
//      neighbours across the border by the same first-touch rules, in
//      global memory: `labels` holds parent + 1, a union finds both roots
//      through L2 (ld.global.cg) and links the larger under the smaller with
//      an integer atomicMin, retrying until the link holds (Playne and
//      Hawick 2018). The rules at the border, for p = (y, x), F(q) the mask:
//        first row:    conn 4 as above; conn 8 as above;
//        first column: conn 4: p and left, unless p is not on the tile's
//                      first row and up and up-left are foreground;
//                      conn 8: p and left; where left is background, p and
//                      up-left (not on the first row, up background) and p
//                      and down-left (down background).
//      Each skipped union is implied by unions that are made (induction over
//      raster order), so every adjacent pair of foreground pixels ends in one
//      set.
//   3. resolve (4 B/px read; 4 B/px written only where a label changes).
//      Each pixel follows its label to the root and writes root + 1 where it
//      differs. Background pixels hold 0 since pass 1, so this pass reads the
//      labels only, not the mask again. A root is never written here, so a
//      label read meanwhile is an ancestor and plain (L1-cached) loads do.
//
// Links always point at a smaller index, so every root is its component's
// minimum flat index: the labels are canonical and equal run to run although
// the order of the links is not. Every atomic is an integer minimum.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// The tile: TH rows of WPR 32-pixel words, 16 x 256, chosen against 32 x
// 128, 8 x 512 and 32 x 256 by their times at 8192^2 (PERF.md). A retune
// edits these two and A/Bs the change against this tree with
// experiments/torch_kernel_ab.py --other.
constexpr int TH = 16;
constexpr int WPR = 8;
constexpr int TW = 32 * WPR;
static_assert(TH <= 32 && WPR <= 32, "the border pass takes a tile per warp");
static_assert((TW & (TW - 1)) == 0, "local indices split by shifts");
constexpr int BORDER_WARPS = 4;    // tiles per CTA of the border pass
constexpr int RESOLVE_THREADS = 256;

__host__ __device__ constexpr int log2i(int v) {
  return v <= 1 ? 0 : 1 + log2i(v / 2);
}

// bit k set where byte k of x is nonzero
__device__ __forceinline__ uint32_t nonzero4(uint32_t x) {
  const uint32_t m = (((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u;
  return ((m >> 7) * 0x204081u) >> 21 & 0xFu;
}

__device__ __forceinline__ uint32_t nonzero16(uint4 v) {
  return nonzero4(v.x) | nonzero4(v.y) << 4 | nonzero4(v.z) << 8 |
         nonzero4(v.w) << 12;
}

// First pixel of the run that holds pixel x of a row of foreground bits
// (x itself is foreground): one past the highest background bit below x.
__device__ __forceinline__ int run_start(const uint32_t* row, int x) {
  int j = x >> 5;
  uint32_t m = ~row[j] & ((1u << (x & 31)) - 1u);
  while (!m) {
    if (--j < 0) return 0;
    m = ~row[j];
  }
  return (j << 5) + 32 - __clz(m);
}

// 32 foreground bits of row y from column x (bit k: pixel x + k; 0 outside
// the canvas). VEC: w % 16 == 0 and fg 16-byte aligned, and x % 16 == 0.
template <bool VEC>
__device__ __forceinline__ uint32_t load_word(const uint8_t* fg, int h, int w,
                                              int y, int x) {
  uint32_t word = 0;
  if (y < 0 || y >= h) return word;
  const uint8_t* row = fg + static_cast<long long>(y) * w;
  if (VEC) {
    // x and w are multiples of 16: each half is in or out whole
    if (x + 16 <= w) word = nonzero16(*reinterpret_cast<const uint4*>(row + x));
    if (x + 32 <= w)
      word |= nonzero16(*reinterpret_cast<const uint4*>(row + x + 16)) << 16;
  } else {
#pragma unroll 4
    for (int k = 0; k < 32; ++k)
      if (x + k < w && row[x + k]) word |= 1u << k;
  }
  return word;
}

// Shared-memory union-find over local indices. parent[i] <= i always holds
// and only decreases, so a walk ends; a value read while another thread links
// is still an ancestor.
__device__ __forceinline__ int find_local(const volatile int* parent, int i) {
  int p = parent[i];
  while (p != i) {
    i = p;
    p = parent[i];
  }
  return i;
}

__device__ void unite_local(int* parent, int a, int b) {
  bool done;
  do {
    a = find_local(parent, a);
    b = find_local(parent, b);
    if (a < b) {
      // b was a root when found; if another union linked it meanwhile, old
      // is its new parent and the loop unites a with that
      const int old = atomicMin(parent + b, a);
      done = old == b;
      b = old;
    } else if (b < a) {
      const int old = atomicMin(parent + a, b);
      done = old == a;
      a = old;
    } else {
      done = true;
    }
  } while (!done);
}

// Pass 1: one CTA per TH x TW tile, one thread per 32-pixel word.
// VEC: w % 16 == 0 and both arrays 16-byte aligned.
template <bool VEC>
__global__ void __launch_bounds__(TH * WPR)
local_kernel(const uint8_t* __restrict__ fg, int* __restrict__ labels, int h,
             int w, int tiles_x, bool conn8) {
  constexpr int NT = TH * WPR;
  constexpr int LOG_TW = log2i(TW);
  __shared__ uint32_t bits[TH][WPR];
  __shared__ int parent[TH * TW];

  const int t = threadIdx.x;
  const int r = t / WPR, j = t % WPR;
  const int y0 = (blockIdx.x / tiles_x) * TH;
  const int x0 = (blockIdx.x % tiles_x) * TW;
  const int y = y0 + r, xw = x0 + 32 * j;

  const uint32_t word = load_word<VEC>(fg, h, w, y, xw);
  bits[r][j] = word;
  __syncthreads();

  // runs: every run's first pixel is its own parent
  const uint32_t left = (word << 1) | (j > 0 ? bits[r][j - 1] >> 31 : 0u);
  const uint32_t starts = word & ~left;
  for (uint32_t s = starts; s; s &= s - 1)
    parent[r * TW + 32 * j + __ffs(s) - 1] = r * TW + 32 * j + __ffs(s) - 1;
  __syncthreads();

  // rows: unite where a run first touches a run of the row above
  if (r > 0) {
    const uint32_t up = bits[r - 1][j];
    const uint32_t up_left =
        (up << 1) | (j > 0 ? bits[r - 1][j - 1] >> 31 : 0u);
    const uint32_t up_right =
        (up >> 1) | (j + 1 < WPR ? bits[r - 1][j + 1] << 31 : 0u);
    uint32_t c_up, c_ul = 0, c_ur = 0;
    if (conn8) {
      c_ur = word & up_right & ~up;
      c_up = starts & up;
      c_ul = starts & ~up & up_left;
    } else {
      c_up = word & up & ~(left & up_left);
    }
    const uint32_t* row = bits[r];
    const uint32_t* above = bits[r - 1];
    const int base = r * TW, base_up = (r - 1) * TW;
    for (uint32_t c = c_up | c_ul | c_ur; c; c &= c - 1) {
      const int b = __ffs(c) - 1;
      const int x = 32 * j + b;
      const int p = base + run_start(row, x);
      if (c_up >> b & 1) unite_local(parent, p, base_up + run_start(above, x));
      if (c_ul >> b & 1)
        unite_local(parent, p, base_up + run_start(above, x - 1));
      if (c_ur >> b & 1)
        unite_local(parent, p, base_up + run_start(above, x + 1));
    }
  }
  __syncthreads();

  // every run's first pixel points at its root
  for (uint32_t s = starts; s; s &= s - 1) {
    const int i = r * TW + 32 * j + __ffs(s) - 1;
    parent[i] = find_local(parent, i);
  }
  __syncthreads();

  // labels: 4 pixels a thread a step, a warp on 128 contiguous pixels
  constexpr int CHUNKS = TH * TW / 4;
#pragma unroll 2
  for (int c = t; c < CHUNKS; c += NT) {
    const int ry = c / (TW / 4), rx = (c % (TW / 4)) * 4;
    const int gy = y0 + ry, gx = x0 + rx;
    if (gy >= h || gx >= w) continue;
    const uint32_t* row = bits[ry];
    const uint32_t b4 = row[rx >> 5] >> (rx & 31) & 0xFu;
    int v[4];
    int start = -1;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (b4 >> k & 1) {
        if (start < 0) start = run_start(row, rx + k);
        const int root = parent[(ry << LOG_TW) + start];
        v[k] = (y0 + (root >> LOG_TW)) * w + x0 + (root & (TW - 1)) + 1;
      } else {
        start = -1;
        v[k] = 0;
      }
    }
    int* out = labels + static_cast<long long>(gy) * w + gx;
    if (VEC) {
      *reinterpret_cast<int4*>(out) = make_int4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (gx + k < w) out[k] = v[k];
    }
  }
}

// Global union-find on labels (parent + 1), read through L2 so that a link
// made by another SM is seen on the next read.
__device__ __forceinline__ int find_global(const int* labels, int i) {
  int p = __ldcg(labels + i) - 1;
  while (p != i) {
    i = p;
    p = __ldcg(labels + i) - 1;
  }
  return i;
}

// Root of i, and i's parent lowered to it (i is no root then, so no union
// targets it; atomicMin keeps a smaller ancestor stored meanwhile).
__device__ __forceinline__ int find_compress(int* labels, int i) {
  const int root = find_global(labels, i);
  if (root != i) atomicMin(labels + i, root + 1);
  return root;
}

__device__ void unite_global(int* labels, int a, int b) {
  bool done;
  do {
    a = find_compress(labels, a);
    b = find_compress(labels, b);
    if (a < b) {
      const int old = atomicMin(labels + b, a + 1) - 1;
      done = old == b;
      b = old;
    } else if (b < a) {
      const int old = atomicMin(labels + a, b + 1) - 1;
      done = old == a;
      a = old;
    } else {
      done = true;
    }
  } while (!done);
}

struct Mask {
  const uint8_t* fg;
  int h, w;
  __device__ __forceinline__ bool operator()(int y, int x) const {
    return y >= 0 && y < h && x >= 0 && x < w &&
           __ldg(fg + static_cast<long long>(y) * w + x);
  }
};

// Pass 2: a warp per tile. Lane j < WPR takes word j of the tile's first row
// against the row above (the row rules on 32 pixels at once, then a union per
// candidate bit); lane t < TH takes pixel t of the tile's first column.
template <bool VEC>
__global__ void __launch_bounds__(32 * BORDER_WARPS)
border_kernel(const uint8_t* __restrict__ fg, int* labels, int h, int w,
              int tiles_x, long long tiles, bool conn8) {
  const long long tile =
      static_cast<long long>(blockIdx.x) * BORDER_WARPS + threadIdx.x / 32;
  if (tile >= tiles) return;
  const int lane = threadIdx.x % 32;
  const int y0 = static_cast<int>(tile / tiles_x) * TH;
  const int x0 = static_cast<int>(tile % tiles_x) * TW;
  const Mask F{fg, h, w};
  if (y0 > 0 && lane < WPR) {
    const int x = x0 + 32 * lane;
    const uint32_t word = load_word<VEC>(fg, h, w, y0, x);
    const uint32_t up = load_word<VEC>(fg, h, w, y0 - 1, x);
    const uint32_t left = (word << 1) | F(y0, x - 1);
    const uint32_t up_left = (up << 1) | F(y0 - 1, x - 1);
    const uint32_t up_right =
        (up >> 1) | static_cast<uint32_t>(F(y0 - 1, x + 32)) << 31;
    uint32_t c_up, c_ul = 0, c_ur = 0;
    if (conn8) {
      const uint32_t starts = word & ~left;
      c_ur = word & up_right & ~up;
      c_up = starts & up;
      c_ul = starts & ~up & up_left;
    } else {
      c_up = word & up & ~(left & up_left);
    }
    for (uint32_t c = c_up | c_ul | c_ur; c; c &= c - 1) {
      const int b = __ffs(c) - 1;
      const int p = y0 * w + x + b;
      if (c_up >> b & 1) unite_global(labels, p, p - w);
      if (c_ul >> b & 1) unite_global(labels, p, p - w - 1);
      if (c_ur >> b & 1) unite_global(labels, p, p - w + 1);
    }
  }
  if (x0 > 0 && lane < TH) {
    const int y = y0 + lane, x = x0;
    if (F(y, x)) {
      const int p = y * w + x;
      const bool left = F(y, x - 1);
      if (conn8) {
        if (left) {
          unite_global(labels, p, p - 1);
        } else {
          if (y != y0 && !F(y - 1, x) && F(y - 1, x - 1))
            unite_global(labels, p, p - w - 1);
          if (!F(y + 1, x) && F(y + 1, x - 1))
            unite_global(labels, p, p + w - 1);
        }
      } else if (left && !(y != y0 && F(y - 1, x) && F(y - 1, x - 1))) {
        unite_global(labels, p, p - 1);
      }
    }
  }
}

// Root of i by plain loads (pass 3: roots are final and never written, any
// other label read is an ancestor).
__device__ __forceinline__ int find_final(const int* labels, int i) {
  int p = labels[i] - 1;
  while (p != i) {
    i = p;
    p = labels[i] - 1;
  }
  return i;
}

// Pass 3: 4 labels a thread.
template <bool VEC>
__global__ void __launch_bounds__(RESOLVE_THREADS)
resolve_kernel(int* labels, long long n) {
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * RESOLVE_THREADS + threadIdx.x) * 4;
  if (i0 >= n) return;
  int v[4];
  const bool whole = VEC && i0 + 4 <= n;
  if (whole) {
    const int4 q = *reinterpret_cast<const int4*>(labels + i0);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = i0 + k < n ? labels[i0 + k] : 0;
  }
  bool changed = false;
  int last = -1, last_root = -1;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (!v[k]) continue;
    const int a = v[k] - 1;
    if (a != last) {
      last = a;
      last_root = find_final(labels, a);
      // shorten the walk of the pixels that follow a
      if (last_root != a && labels[a] != last_root + 1)
        labels[a] = last_root + 1;
    }
    if (last_root != a) {
      v[k] = last_root + 1;
      changed = true;
    }
  }
  if (!changed) return;
  if (whole) {
    *reinterpret_cast<int4*>(labels + i0) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (i0 + k < n) labels[i0 + k] = v[k];
  }
}

}  // namespace

extern "C" {

// Labels of the (h, w) mask fg (uint8 or bool, nonzero = foreground) into
// labels (h, w) int32; 8-connectivity when conn8 != 0, else 4. Needs
// h * w < 2^31 (the wrapper checks). Launches on `stream` (one launch when
// the canvas is one tile, else three); returns the cudaError_t of the
// launches (0 on success).
int label_cc(const uint8_t* fg, int* labels, int h, int w, int conn8,
             void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (static_cast<long long>(h) * w <= 0) return 0;
  const bool c8 = conn8 != 0;
  const int tiles_x = (w + TW - 1) / TW;
  const long long tiles =
      static_cast<long long>(tiles_x) * ((h + TH - 1) / TH);
  const bool vec = w % 16 == 0 && reinterpret_cast<uintptr_t>(fg) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(labels) % 16 == 0;
  const unsigned local_blocks = static_cast<unsigned>(tiles);
  if (vec)
    local_kernel<true><<<local_blocks, TH * WPR, 0, st>>>(fg, labels, h, w,
                                                          tiles_x, c8);
  else
    local_kernel<false><<<local_blocks, TH * WPR, 0, st>>>(fg, labels, h, w,
                                                           tiles_x, c8);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tiles > 1) {
    const unsigned border_blocks =
        static_cast<unsigned>((tiles + BORDER_WARPS - 1) / BORDER_WARPS);
    if (vec)
      border_kernel<true><<<border_blocks, 32 * BORDER_WARPS, 0, st>>>(
          fg, labels, h, w, tiles_x, tiles, c8);
    else
      border_kernel<false><<<border_blocks, 32 * BORDER_WARPS, 0, st>>>(
          fg, labels, h, w, tiles_x, tiles, c8);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long n = static_cast<long long>(h) * w;
    const unsigned blocks = static_cast<unsigned>(
        (n + 4LL * RESOLVE_THREADS - 1) / (4LL * RESOLVE_THREADS));
    if (reinterpret_cast<uintptr_t>(labels) % 16 == 0)
      resolve_kernel<true><<<blocks, RESOLVE_THREADS, 0, st>>>(labels, n);
    else
      resolve_kernel<false><<<blocks, RESOLVE_THREADS, 0, st>>>(labels, n);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // extern "C"
