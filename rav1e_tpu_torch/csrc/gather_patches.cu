// Patch gather: square patches of P x P from int32 planes, a group of
// independent gathers in one launch (CUDA, sm_90a).
//
// Replaces the Pallas TPU kernel tools/bench_gather.py `kern` (driven by
// `g_pallas`) and the `vmap(dynamic_slice)` of the P-frame path:
// rav1e_tpu/pipeline/tpu_inter.py `_gather_patch` (the subpel-descent
// patch around each block's centre MV) and `_mc_batch.slice_one` (the
// (n+7)^2 window of each block's 8-tap prediction).
//
// Each item g of a group is one gather:
//   out_g[b, y, x] = plane_g[r0'[b] + y, c0'[b] + x]
//   r0' = clamp(r0[b] < 0 ? r0[b] + H : r0[b], 0, H - P), c0' likewise
//
// That is jax.lax.dynamic_slice's rule, which the main path relies on: a
// negative start counts from the end (numpy style), then the start is
// clamped so the window lies inside the plane. The Pallas kernel's pl.ds
// does neither. On the speed-10 path no start is negative (the search
// radius and the coarse-MV clamp keep every window inside the padding).
//
// Bound: bytes. There is no arithmetic beyond addresses: each output
// element is one 4-byte read and one 4-byte write. The least traffic of a
// launch is the patches written plus each distinct plane's elements that
// its windows cover, read once: neighbouring patches overlap, and items
// of a group may read the same plane (chip_smoke.py, _gather_bound).
// The P frame's gathers are small (0.5 to 20 MB): one launch each spent
// most of its time on the launch's fixed cost and on a block per patch
// that left most of its threads idle. What the design does about that:
// - one launch a group: the items' descriptors (pointers, H, W, B, P, the
//   output offset) travel in the kernel's parameter struct
//   (__grid_constant__, no copy to the device), and each block finds its
//   item from the prefix of the items' block counts;
// - a block's patches are one run of elements, consecutive threads on
//   consecutive elements: every store of a warp is one contiguous run,
//   every load a run of a patch row or two, and no lane idles at a row's
//   end. Each thread carries its element's (patch, row, column) to the
//   next one THREADS on by a fixed step with two compares and selects,
//   so the element loop has no division and no divergent branch (a
//   mapping of rows to warps and columns to lanes, measured first, was
//   slower: lanes past P idle, and at P > 32 the lanes of a warp part
//   ways between rows);
// - as many whole patches a block as fit in about 3,072 elements (P = 39:
//   2, P = 23: 5, P = 15: 13), so no block is mostly idle on a small
//   patch and each thread has a dozen elements (2,048 and 4,096 were
//   measured too, and 128 threads a block: each lost on the frame);
// - four elements a thread in flight: four loads, then four stores.
// Rows are read and written as contiguous runs and the overlapping rows
// of neighbouring patches hit in L2. Staging the loads through shared
// memory with cp.async (12 elements a thread in flight) was measured
// slower at every size (PERF.md), so the copy goes through
// registers; TMA row copies were not tried.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_ITEMS = 16;   // gathers a launch
constexpr int MAX_PPB = 32;     // patches a block
constexpr int TARGET = 3072;    // elements a block, at least one patch
constexpr int UNROLL = 4;       // elements a thread in flight

struct Item {
  const int* plane;
  const int* r0;
  const int* c0;
  int64_t out;      // element offset of the item's [B, P, P] in out
  int H, W, B, P;
  int ppb;          // patches a block
  int qj, qy, qx;   // THREADS elements as whole patches, rows and columns
  int block0;       // the item's first block
};

struct Group {
  int n;
  int* out;
  Item items[MAX_ITEMS];
};

__global__ void __launch_bounds__(THREADS)
gather_patches_kernel(const __grid_constant__ Group g) {
  int i = 0;
  while (i + 1 < g.n && static_cast<int>(blockIdx.x) >= g.items[i + 1].block0)
    ++i;
  const Item& it = g.items[i];
  const int P = it.P, W = it.W;
  const int PP = P * P;
  const int b0 = (blockIdx.x - it.block0) * it.ppb;
  const int nb = min(it.ppb, it.B - b0);
  __shared__ int64_t s_off[MAX_PPB];
  if (threadIdx.x < nb) {
    const int b = b0 + threadIdx.x;
    const int rs = it.r0[b] < 0 ? it.r0[b] + it.H : it.r0[b];
    const int cs = it.c0[b] < 0 ? it.c0[b] + W : it.c0[b];
    const int r = min(max(rs, 0), it.H - P);
    const int c = min(max(cs, 0), W - P);
    s_off[threadIdx.x] = static_cast<int64_t>(r) * W + c;
  }
  __syncthreads();
  // the block's nb patches as one run of nb * P * P elements; thread t
  // copies elements t, t + THREADS, ... and carries (patch, row, column)
  // from one to the next by the step (qj, qy, qx)
  const int n = nb * PP;
  const int qj = it.qj, qy = it.qy, qx = it.qx;
  const int e0 = threadIdx.x;
  int j = e0 / PP;
  int y = (e0 - j * PP) / P;
  int x = e0 - j * PP - y * P;
  const int* __restrict__ plane = it.plane;
  int* __restrict__ out = g.out + it.out + static_cast<int64_t>(b0) * PP;
  for (int e = e0; e < n; e += UNROLL * THREADS) {
    int v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (e + u * THREADS < n)
        v[u] = __ldg(plane + s_off[j] + static_cast<int64_t>(y) * W + x);
      x += qx;
      const bool cx = x >= P;
      x -= cx ? P : 0;
      y += qy + cx;
      const bool cy = y >= P;
      y -= cy ? P : 0;
      j += qj + cy;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (e + u * THREADS < n) out[e + u * THREADS] = v[u];
  }
}

__global__ void empty_kernel() {}

}  // namespace

// One item of a group as the host describes it.
struct GatherDesc {
  const void* plane;
  const void* r0;
  const void* c0;
  long long out;    // element offset of the item's patches in out
  int H, W, B, P;
};

// Launches the group's n <= 16 gathers as one kernel (none if every B is
// 0). Returns the CUDA error, or cudaErrorInvalidValue for n > 16.
extern "C" int gather_patches_many_launch(const GatherDesc* d, int n,
                                          void* out, void* stream) {
  if (n < 0 || n > MAX_ITEMS) return static_cast<int>(cudaErrorInvalidValue);
  Group g{};
  g.n = n;
  g.out = static_cast<int*>(out);
  int blocks = 0;
  for (int i = 0; i < n; ++i) {
    Item& it = g.items[i];
    it.plane = static_cast<const int*>(d[i].plane);
    it.r0 = static_cast<const int*>(d[i].r0);
    it.c0 = static_cast<const int*>(d[i].c0);
    it.out = d[i].out;
    it.H = d[i].H;
    it.W = d[i].W;
    it.B = d[i].B;
    it.P = d[i].P;
    const int P = it.P;
    it.ppb = std::min(std::max(TARGET / (P * P), 1), MAX_PPB);
    it.qj = THREADS / (P * P);
    it.qy = (THREADS - it.qj * P * P) / P;
    it.qx = THREADS - it.qj * P * P - it.qy * P;
    it.block0 = blocks;
    blocks += (it.B + it.ppb - 1) / it.ppb;
  }
  if (blocks > 0) {
    gather_patches_kernel<<<blocks, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(g);
  }
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel: the fixed cost of a launch, which chip_smoke.py times
// beside the kernels' bounds.
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
