// Patch gather: B square patches of P x P from one int32 plane (CUDA,
// sm_90a).
//
// Replaces the Pallas TPU kernel tools/bench_gather.py `kern` (driven by
// `g_pallas`) and the `vmap(dynamic_slice)` of the P-frame path:
// rav1e_tpu/pipeline/tpu_inter.py `_gather_patch` (the subpel-descent
// patch around each block's centre MV) and `_mc_batch.slice_one` (the
// (n+7)^2 window of each block's 8-tap prediction).
//
//   out[b, y, x] = plane[r0'[b] + y, c0'[b] + x]
//   r0' = clamp(r0[b] < 0 ? r0[b] + H : r0[b], 0, H - P), c0' likewise
//
// That is jax.lax.dynamic_slice's rule, which the main path relies on: a
// negative start counts from the end (numpy style), then the start is
// clamped so the window lies inside the plane. The Pallas kernel's pl.ds
// does neither. On the speed-10 path no start is negative (the search
// radius and the coarse-MV clamp keep every window inside the padding).
//
// Bound: bytes. There is no arithmetic beyond addresses: each output
// element is one 4-byte read and one 4-byte write. The least traffic is
// the patches written plus the lesser of the plane and the patches read
// (neighbouring patches overlap, so a cached plane is read about once).
// Design: one thread block per patch, threads striding over its P*P
// elements with consecutive threads on consecutive columns, so each
// patch row is read and written as contiguous, coalesced runs; the
// overlapping rows of neighbouring patches hit in L2. Faster forms
// (cp.async or TMA row copies, uint8 reads, fusing the 8-tap filter of
// _mc_batch so the patch never goes to device memory) are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
gather_patches_kernel(const int* __restrict__ plane, int H, int W,
                      const int* __restrict__ r0, const int* __restrict__ c0,
                      int P, int* __restrict__ out) {
  const int b = blockIdx.x;
  const int rs = r0[b] < 0 ? r0[b] + H : r0[b];
  const int cs = c0[b] < 0 ? c0[b] + W : c0[b];
  const int r = min(max(rs, 0), H - P);
  const int c = min(max(cs, 0), W - P);
  const int* src = plane + static_cast<int64_t>(r) * W + c;
  int* dst = out + static_cast<int64_t>(b) * P * P;
  const int n = P * P;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int y = i / P;
    const int x = i - y * P;
    dst[i] = src[static_cast<int64_t>(y) * W + x];
  }
}

}  // namespace

extern "C" int gather_patches_launch(const void* plane, int H, int W,
                                     const void* r0, const void* c0, int B,
                                     int P, void* out, void* stream) {
  if (B > 0) {
    gather_patches_kernel<<<B, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(plane), H, W, static_cast<const int*>(r0),
        static_cast<const int*>(c0), P, static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
