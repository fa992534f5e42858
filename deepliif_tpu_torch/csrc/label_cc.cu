// Connected-component labeling of a foreground mask on Hopper (sm_90a):
// union-find with atomicMin linking, in three launches.
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
// On the TPU a whole canvas fits in VMEM and a call runs K sweeps; here a
// canvas (up to 268 MB of int32 at 67 MPx) fits in no on-chip memory, and
// sweeping to a fixed point costs O(diameter / K) passes over it, where the
// background component spans the canvas. Union-find needs one pass:
//
//   1. init:     parent[i] = fg[i] ? i : -1
//   2. merge:    each foreground pixel unites with its foreground neighbours
//                that come before it in raster order (up, left; at
//                8-connectivity also up-left and up-right, skipped where the
//                pixel above already joins them). A union finds both roots
//                and links the larger under the smaller with atomicMin,
//                retrying until the link holds (Playne and Hawick 2018;
//                Komura 2015).
//   3. compress: labels[i] = find(i) + 1, storing the root back into parent.
//
// Links always point at a smaller index, so every root is its component's
// minimum flat index: the labels are canonical and equal run to run although
// the order of the links is not. The atomics are integer minima, which are
// order-free.
//
// What bounds it: it reads the mask once (1 B/px) and writes the labels once
// (4 B/px) at 3.35 TB/s; parent is scratch (4 B/px, written and read a few
// times, mostly through L2). One thread per pixel; parent is read with
// ld.global.cg (L2, not L1) inside the merge so that a link made by another
// SM is seen on the next read.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ long long pixel_index() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__global__ void __launch_bounds__(THREADS)
init_kernel(const uint8_t* __restrict__ fg, int* __restrict__ parent, int n) {
  const long long i = pixel_index();
  if (i < n) parent[i] = fg[i] ? static_cast<int>(i) : -1;
}

// Root of i. parent[j] <= j always holds and only ever decreases, so the walk
// ends; a value read while another thread links is still an ancestor.
__device__ __forceinline__ int find_root(const int* parent, int i) {
  int p = __ldcg(parent + i);
  while (p != i) {
    i = p;
    p = __ldcg(parent + i);
  }
  return i;
}

// Root of i, and i's parent lowered to it (i is no root then, so no union
// targets it; atomicMin keeps a smaller ancestor stored meanwhile).
__device__ __forceinline__ int find_compress(int* parent, int i) {
  const int root = find_root(parent, i);
  if (root != i) atomicMin(parent + i, root);
  return root;
}

__device__ void unite(int* parent, int a, int b) {
  bool done;
  do {
    a = find_compress(parent, a);
    b = find_compress(parent, b);
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

// At 8-connectivity, a pixel whose upper neighbour is foreground unites with
// it alone: its left, up-left and up-right neighbours are joined to that
// pixel through their own unions (by induction over the rows). Without it,
// the left neighbour makes the up-left one redundant the same way.
__global__ void __launch_bounds__(THREADS)
merge_kernel(const uint8_t* __restrict__ fg, int* parent, int h, int w,
             int conn8) {
  const long long li = pixel_index();
  if (li >= static_cast<long long>(h) * w) return;
  const int i = static_cast<int>(li);
  if (!fg[i]) return;
  const int y = i / w;
  const int x = i - y * w;
  const bool up = y > 0 && fg[i - w];
  if (up) unite(parent, i, i - w);
  if (!conn8) {
    if (x > 0 && fg[i - 1]) unite(parent, i, i - 1);
    return;
  }
  if (up) return;
  if (x > 0 && fg[i - 1]) {
    unite(parent, i, i - 1);
  } else if (x > 0 && y > 0 && fg[i - w - 1]) {
    unite(parent, i, i - w - 1);
  }
  if (x + 1 < w && y > 0 && fg[i - w + 1]) unite(parent, i, i - w + 1);
}

__global__ void __launch_bounds__(THREADS)
compress_kernel(const uint8_t* __restrict__ fg, int* parent,
                int* __restrict__ labels, int n) {
  const long long li = pixel_index();
  if (li >= n) return;
  const int i = static_cast<int>(li);
  if (!fg[i]) {
    labels[i] = 0;
    return;
  }
  // parent is final here: a concurrent store below only shortens a path
  const int root = find_root(parent, i);
  if (root != i) parent[i] = root;
  labels[i] = root + 1;
}

}  // namespace

extern "C" {

// Labels of the (h, w) mask fg (uint8 or bool, nonzero = foreground) into
// labels (h, w) int32, using parent (h, w) int32 as scratch; 8-connectivity
// when conn8 != 0, else 4. Needs h * w < 2^31 (the wrapper checks). Three
// launches on `stream`; returns the cudaError_t of the launches (0 on
// success).
int label_cc(const uint8_t* fg, int* parent, int* labels, int h, int w,
             int conn8, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n = static_cast<long long>(h) * w;
  if (n <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n + THREADS - 1) / THREADS);
  init_kernel<<<blocks, THREADS, 0, st>>>(fg, parent, static_cast<int>(n));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_kernel<<<blocks, THREADS, 0, st>>>(fg, parent, h, w, conn8);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  compress_kernel<<<blocks, THREADS, 0, st>>>(fg, parent, labels,
                                              static_cast<int>(n));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
