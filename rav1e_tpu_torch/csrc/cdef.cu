// CDEF on the card: direction search, ladder SSE table and filter (CUDA,
// sm_90a). Three kernels, each launched once per plane (dirs once per
// frame) by rav1e_tpu_torch/ops/cdef.py.
//
// What they replace. The JAX package computes CDEF with jnp in plane
// space (rav1e_tpu/ops/tpu/cdef.py): `cdef_directions_jax` (:58) and
// `_dirs_var` (:272) for the per-8x8 direction and variance,
// `_prep_plane` (:187), which materialises 12 shifted tap planes per
// plane, and `_filter_from_prep` (:220), a few dozen elementwise ops per
// tap, run for each of the 8 ladder entries of `cdef_search_persb_jax`
// (:281) and once more to apply the winners. Its Pallas kernel
// (cdef_pallas.py::cdef_candidates_pallas, deleted in a011a69) built the
// direction taps of an 8-row slab once in fast memory and ran all 8
// candidates on them. XLA fuses the jnp form on the TPU; eager PyTorch
// fuses nothing, so on the card the jnp form is ~100 MB of tap planes for
// 1080p luma and thousands of launches per frame. These kernels keep the
// taps in registers and shared memory instead.
//
// The arithmetic is the reference's, integer for integer:
//   constrain(d, S, D) = sign(d) * min(|d|, max(0, S - (|d| >> max(0, D -
//                        msb(S))))), 0 where S == 0;
//   msb is an integer 31 - clz (the reference takes floor(log2(f32)),
//   which agrees wherever CDEF reads it: strengths <= 14 and
//   min(msb(var >> 6), 12));
//   y = x + ((8 + s - (s < 0)) >> 4), clipped to the min/max of x and the
//   taps that are in the frame, kept as x when the 8x8 unit is skipped or
//   both strengths are 0. Out-of-frame taps (LARGE in the reference's
//   padded plane) drop out of the sum and of the clamp window. Every
//   shift of a value that may be negative is `>>` on int (arithmetic),
//   never `/`.
//
// (a) cdef_dirs: one thread per 8x8 luma block. The eight direction
//     costs are sums of squared partial sums (at most 2^34), kept in
//     int64 where the reference uses two int32 limbs; the first maximum
//     wins ties; var = (cost[best] - cost[best ^ 4]) >> 10. Bound: the
//     operations (about 1,100 integer ops a block), 2 MB read at 1080p.
// (b) cdef_ladder_sse: one thread block per sampled superblock (the TL
//     and BR 32x32 luma / 16x16 chroma quadrants of a 64x64 SB) or per
//     32-block (the full branch). The region and a 2-pixel halo go to
//     shared memory, LARGE outside the frame; each thread selects a
//     pixel's 4 primary and 8 secondary taps once by its block's
//     direction and runs the 8 ladder entries on them in registers; each
//     entry's squared error against the source goes to shared memory.
//     The block then sums each cell in f32 in the order XLA:CPU sums the
//     reference's `d.sum(...)` (ops/cdef.py, _xla_rows_sum): the cell's
//     rows in order, each row over 8 lanes, the running total entering
//     lane 0, the lanes folded in halves. One thread per (entry, row)
//     forms the row's exact integer terms; one thread per entry adds
//     them to its total, so the table is the reference's f32 table also
//     where a cell passes 2^24, and runs are deterministic.
//     Bound: the operations, not the 3 MB it reads: the 8 entries need
//     about 600 integer ops per filtered luma pixel (550 chroma) when
//     the tap work they share (difference, |.|, in-frame test, clamp
//     window) is done once (chip_smoke.py, _cdef_ladder_ops). This
//     kernel redoes that shared work in every entry (about 950 ops a
//     pixel); hoisting it out of the entry loop is later work.
// (c) cdef_apply: one thread per output pixel, taps read through L1 from
//     the uint8 plane, strengths per SB from the winning ladder index, or
//     one uniform pair (the fixed-strength filter, where the direction is
//     0 when the plane's primary strength is 0). Bound: the operations.
// A simple form, right first; faster ones (one launch for the three
// planes, the apply fused into the SSE pass for the winners) are later
// work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LARGE = 1 << 14;
constexpr int THREADS = 256;

// CDEF_LADDER: (y_pri, y_sec, uv_pri, uv_sec) per entry.
__constant__ int c_ladder[8][4] = {
    {0, 0, 0, 0}, {1, 0, 1, 0}, {2, 1, 1, 0}, {3, 1, 2, 1},
    {5, 2, 4, 1}, {7, 2, 5, 2}, {10, 2, 8, 2}, {14, 4, 12, 4}};

// Tap offsets (dy, dx) per direction: primary (k0,+), (k0,-), (k1,+),
// (k1,-); secondary ((d+2,k0),+-), ((d-2,k0),+-), then k1 (the
// reference's _shift_tables).
__constant__ int c_pri[8][4][2] = {
    {{-1, 1}, {1, -1}, {-2, 2}, {2, -2}},
    {{0, 1}, {0, -1}, {-1, 2}, {1, -2}},
    {{0, 1}, {0, -1}, {0, 2}, {0, -2}},
    {{0, 1}, {0, -1}, {1, 2}, {-1, -2}},
    {{1, 1}, {-1, -1}, {2, 2}, {-2, -2}},
    {{1, 0}, {-1, 0}, {2, 1}, {-2, -1}},
    {{1, 0}, {-1, 0}, {2, 0}, {-2, 0}},
    {{1, 0}, {-1, 0}, {2, -1}, {-2, 1}}};
__constant__ int c_sec[8][8][2] = {
    {{0, 1}, {0, -1}, {1, 0}, {-1, 0}, {0, 2}, {0, -2}, {2, 0}, {-2, 0}},
    {{0, 1}, {0, -1}, {1, 0}, {-1, 0}, {1, 2}, {-1, -2}, {2, -1}, {-2, 1}},
    {{1, 1}, {-1, -1}, {-1, 1}, {1, -1}, {2, 2}, {-2, -2}, {-2, 2}, {2, -2}},
    {{1, 0}, {-1, 0}, {0, 1}, {0, -1}, {2, 1}, {-2, -1}, {-1, 2}, {1, -2}},
    {{1, 0}, {-1, 0}, {0, 1}, {0, -1}, {2, 0}, {-2, 0}, {0, 2}, {0, -2}},
    {{1, 0}, {-1, 0}, {0, 1}, {0, -1}, {2, -1}, {-2, 1}, {1, 2}, {-1, -2}},
    {{-1, 1}, {1, -1}, {1, 1}, {-1, -1}, {-2, 2}, {2, -2}, {2, 2}, {-2, -2}},
    {{0, 1}, {0, -1}, {1, 0}, {-1, 0}, {-1, 2}, {1, -2}, {2, 1}, {-2, -1}}};

// 840 / (pixels in bin b of direction d): DIV_TABLE by bin count.
__constant__ int c_div[8][15] = {
    {840, 420, 280, 210, 168, 140, 120, 105, 120, 140, 168, 210, 280, 420, 840},
    {420, 210, 140, 105, 105, 105, 105, 105, 140, 210, 420, 0, 0, 0, 0},
    {105, 105, 105, 105, 105, 105, 105, 105, 0, 0, 0, 0, 0, 0, 0},
    {420, 210, 140, 105, 105, 105, 105, 105, 140, 210, 420, 0, 0, 0, 0},
    {840, 420, 280, 210, 168, 140, 120, 105, 120, 140, 168, 210, 280, 420, 840},
    {420, 210, 140, 105, 105, 105, 105, 105, 140, 210, 420, 0, 0, 0, 0},
    {105, 105, 105, 105, 105, 105, 105, 105, 0, 0, 0, 0, 0, 0, 0},
    {420, 210, 140, 105, 105, 105, 105, 105, 140, 210, 420, 0, 0, 0, 0}};

__host__ __device__ constexpr int dir_bin(int d, int i, int j) {
  return d == 0   ? i + j
         : d == 1 ? i + (j >> 1)
         : d == 2 ? i
         : d == 3 ? 3 + i - (j >> 1)
         : d == 4 ? 7 + i - j
         : d == 5 ? 3 - (i >> 1) + j
         : d == 6 ? j
                  : (i >> 1) + j;
}

__device__ __forceinline__ int msb(int x) { return 31 - __clz(max(x, 1)); }

__device__ __forceinline__ int constrain(int diff, int strength, int damp) {
  if (strength <= 0) return 0;
  const int adj = max(0, damp - msb(strength));
  const int a = abs(diff);
  const int m = min(a, max(0, strength - (a >> adj)));
  return diff < 0 ? -m : m;
}

// The luma primary strength after the variance adjustment.
__device__ __forceinline__ int luma_pri_adj(int pri, int var) {
  if (var <= 0) return 0;
  const int v6 = var >> 6;
  const int vs = v6 > 0 ? min(msb(v6), 12) : 0;
  return (pri * (4 + vs) + 8) >> 4;
}

// One pixel: x, its 4 primary and 8 secondary taps (LARGE outside the
// frame), the plane's strengths and damping. Returns the filtered value,
// or x where the unit is skipped or both strengths are 0.
__device__ __forceinline__ int cdef_px(int x, const int (&pt)[4],
                                       const int (&st)[8], int pri_adj,
                                       int sec, int pdamp, bool skip) {
  if (skip || (pri_adj <= 0 && sec <= 0)) return x;
  const bool odd = pri_adj & 1;
  const int ta = odd ? 3 : 4;
  const int tb = odd ? 3 : 2;
  int s = 0, mx = x, mn = x;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int p = pt[t];
    if (p != LARGE) {
      s += (t < 2 ? ta : tb) * constrain(p - x, pri_adj, pdamp);
      mx = max(mx, p);
      mn = min(mn, p);
    }
  }
  if (sec > 0) {
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int p = st[t];
      if (p != LARGE) {
        s += (t < 4 ? 2 : 1) * constrain(p - x, sec, pdamp);
        mx = max(mx, p);
        mn = min(mn, p);
      }
    }
  }
  const int y = x + ((8 + s - (s < 0 ? 1 : 0)) >> 4);
  return min(max(y, mn), mx);
}

// (a) direction and variance, one thread per 8x8 luma block.
__global__ void __launch_bounds__(THREADS)
cdef_dirs_kernel(const uint8_t* __restrict__ y, int H, int W,
                 int8_t* __restrict__ dir_out, int* __restrict__ var_out) {
  const int nbx = W >> 3;
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= (H >> 3) * nbx) return;
  const uint8_t* src = y + static_cast<int64_t>(b / nbx) * 8 * W
                       + (b % nbx) * 8;
  int x[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      x[i][j] = static_cast<int>(__ldg(src + i * W + j)) - 128;
  long long cost[8];
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    int part[15];
#pragma unroll
    for (int k = 0; k < 15; ++k) part[k] = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) part[dir_bin(d, i, j)] += x[i][j];
    long long c = 0;
#pragma unroll
    for (int k = 0; k < 15; ++k)
      c += static_cast<long long>(part[k] * part[k]) * c_div[d][k];
    cost[d] = c;
  }
  int best = 0;
  long long cb = cost[0];
#pragma unroll
  for (int d = 1; d < 8; ++d)
    if (cost[d] > cb) {
      cb = cost[d];
      best = d;
    }
  long long co = cost[0];
#pragma unroll
  for (int d = 1; d < 8; ++d)
    if (d == ((best + 4) & 7)) co = cost[d];
  dir_out[b] = static_cast<int8_t>(best);
  var_out[b] = static_cast<int>((cb - co) >> 10);
}

// (b) the ladder's SSE table. Region side B (32 luma, 16 chroma); unit
// side N (8 luma, 4 chroma: one direction / skip flag each). Each cell's
// sum is the reference's f32 one (see the header): every squared error
// is exact in f32 and so is every sum of at most 16 of them, so the
// only roundings are the adds into the running total, which
// `row_terms` lists in XLA:CPU's order for one row.
template <int B, int N>
__global__ void __launch_bounds__(THREADS)
cdef_ladder_sse_kernel(const uint8_t* __restrict__ plane,
                       const uint8_t* __restrict__ src, int H, int W,
                       const int8_t* __restrict__ dirs,
                       const int* __restrict__ var,
                       const uint8_t* __restrict__ skip8, int damping,
                       int sampled, int R, int C, float* __restrict__ out) {
  constexpr int T = B + 4;
  constexpr bool LUMA = N == 8;
  // per row: the pixels at 0, 8, .. (lane 0 of each chunk of 8), then
  // the lane-4, lanes-2+6 and odd-lane totals of the 8-lane fold
  constexpr int NT = B / 8 + 3;
  static_assert(8 * B <= THREADS, "one thread per (entry, row)");
  __shared__ int tile[T][T + 1];
  __shared__ uint16_t err[8][B][B + 2];   // squared errors <= 255^2
  __shared__ int terms[8][B][NT];
  const int br = blockIdx.x / C;
  const int bc = blockIdx.x - br * C;
  const int gw = W / N;
  const int pdamp = LUMA ? damping : damping - 1;
  float total = 0.0f;       // thread k < 8: entry k's running total
  const int nreg = sampled ? 2 : 1;
  for (int q = 0; q < nreg; ++q) {
    const int r0 = (sampled ? 2 * br + q : br) * B;
    const int c0 = (sampled ? 2 * bc + q : bc) * B;
    __syncthreads();
    for (int i = threadIdx.x; i < T * T; i += THREADS) {
      const int ty = i / T;
      const int tx = i - ty * T;
      const int yy = r0 - 2 + ty;
      const int xx = c0 - 2 + tx;
      tile[ty][tx] = (yy >= 0 && yy < H && xx >= 0 && xx < W)
                         ? static_cast<int>(plane[static_cast<int64_t>(yy) * W + xx])
                         : LARGE;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < B * B; i += THREADS) {
      const int py = i / B;
      const int px = i - py * B;
      const int yy = r0 + py;
      const int xx = c0 + px;
      const int g = (yy / N) * gw + xx / N;
      const int d = dirs[g];
      const bool sk = skip8[g] != 0;
      const int v = LUMA ? var[g] : 0;
      const int x = tile[py + 2][px + 2];
      int pt[4], st[8];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        pt[t] = tile[py + 2 + c_pri[d][t][0]][px + 2 + c_pri[d][t][1]];
#pragma unroll
      for (int t = 0; t < 8; ++t)
        st[t] = tile[py + 2 + c_sec[d][t][0]][px + 2 + c_sec[d][t][1]];
      const int s0 = static_cast<int>(src[static_cast<int64_t>(yy) * W + xx]);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int pri = c_ladder[k][LUMA ? 0 : 2];
        const int sec = c_ladder[k][LUMA ? 1 : 3];
        const int pa = LUMA ? luma_pri_adj(pri, v) : pri;
        const int e = cdef_px(x, pt, st, pa, sec, pdamp, sk) - s0;
        err[k][py][px] = static_cast<uint16_t>(e * e);
      }
    }
    __syncthreads();
    // row_terms, one thread per (entry, row), exact integers
    if (threadIdx.x < 8 * B) {
      const int k = threadIdx.x / B;
      const int r = threadIdx.x - k * B;
      const uint16_t* e = err[k][r];
      int l4 = 0, l26 = 0, lodd = 0;
#pragma unroll
      for (int c = 0; c < B / 8; ++c) {
        terms[k][r][c] = e[8 * c];
        l4 += e[8 * c + 4];
        l26 += e[8 * c + 2] + e[8 * c + 6];
        lodd += e[8 * c + 1] + e[8 * c + 3] + e[8 * c + 5] + e[8 * c + 7];
      }
      terms[k][r][B / 8] = l4;
      terms[k][r][B / 8 + 1] = l26;
      terms[k][r][B / 8 + 2] = lodd;
    }
    __syncthreads();
    // the running total, rows in order, each term one f32 add
    if (threadIdx.x < 8) {
      for (int r = 0; r < B; ++r) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
          total = __fadd_rn(total, static_cast<float>(terms[threadIdx.x][r][j]));
      }
    }
  }
  if (threadIdx.x < 8)
    out[static_cast<int64_t>(threadIdx.x) * R * C + blockIdx.x] = total;
}

// (c) the filtered plane, one thread per pixel. idx (per SB, row stride
// nc_sb) selects the ladder entry; without idx every pixel takes the
// uniform pair (pri, sec). SB side S: 64 luma, 32 chroma.
template <int N, int S>
__global__ void __launch_bounds__(THREADS)
cdef_apply_kernel(const uint8_t* __restrict__ plane, int H, int W,
                  const int8_t* __restrict__ dirs,
                  const int* __restrict__ var,
                  const uint8_t* __restrict__ skip8,
                  const int* __restrict__ idx, int nc_sb, int pri_u,
                  int sec_u, int damping, uint8_t* __restrict__ out) {
  constexpr bool LUMA = N == 8;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= static_cast<int64_t>(H) * W) return;
  const int yy = static_cast<int>(i / W);
  const int xx = static_cast<int>(i - static_cast<int64_t>(yy) * W);
  int pri = pri_u, sec = sec_u;
  if (idx != nullptr) {
    const int k = idx[(yy / S) * nc_sb + xx / S];
    pri = c_ladder[k][LUMA ? 0 : 2];
    sec = c_ladder[k][LUMA ? 1 : 3];
  }
  const int g = (yy / N) * (W / N) + xx / N;
  const int d = pri > 0 ? dirs[g] : 0;
  const int x = plane[i];
  int pt[4], st[8];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int ry = yy + c_pri[d][t][0];
    const int rx = xx + c_pri[d][t][1];
    pt[t] = (ry >= 0 && ry < H && rx >= 0 && rx < W)
                ? static_cast<int>(__ldg(plane + static_cast<int64_t>(ry) * W + rx))
                : LARGE;
  }
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int ry = yy + c_sec[d][t][0];
    const int rx = xx + c_sec[d][t][1];
    st[t] = (ry >= 0 && ry < H && rx >= 0 && rx < W)
                ? static_cast<int>(__ldg(plane + static_cast<int64_t>(ry) * W + rx))
                : LARGE;
  }
  const int pa = LUMA ? luma_pri_adj(pri, var[g]) : pri;
  const int pdamp = LUMA ? damping : damping - 1;
  out[i] = static_cast<uint8_t>(cdef_px(x, pt, st, pa, sec, pdamp,
                                        skip8[g] != 0));
}

}  // namespace

extern "C" int cdef_dirs_launch(const void* y, int H, int W, void* dir_out,
                                void* var_out, void* stream) {
  const int n = (H >> 3) * (W >> 3);
  if (n > 0) {
    cdef_dirs_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(y), H, W, static_cast<int8_t*>(dir_out),
        static_cast<int*>(var_out));
  }
  return static_cast<int>(cudaGetLastError());
}

// out f32 [8, R, C]: R x C = the SBs (sampled) or the 32-blocks (full).
extern "C" int cdef_ladder_sse_launch(const void* plane, const void* src,
                                      int H, int W, const void* dirs,
                                      const void* var, const void* skip8,
                                      int damping, int chroma, int sampled,
                                      int R, int C, void* out,
                                      void* stream) {
  if (R * C > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    auto p = static_cast<const uint8_t*>(plane);
    auto q = static_cast<const uint8_t*>(src);
    auto d = static_cast<const int8_t*>(dirs);
    auto v = static_cast<const int*>(var);
    auto k = static_cast<const uint8_t*>(skip8);
    auto o = static_cast<float*>(out);
    if (chroma) {
      cdef_ladder_sse_kernel<16, 4><<<R * C, THREADS, 0, s>>>(
          p, q, H, W, d, v, k, damping, sampled, R, C, o);
    } else {
      cdef_ladder_sse_kernel<32, 8><<<R * C, THREADS, 0, s>>>(
          p, q, H, W, d, v, k, damping, sampled, R, C, o);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cdef_apply_launch(const void* plane, int H, int W,
                                 const void* dirs, const void* var,
                                 const void* skip8, const void* idx,
                                 int nc_sb, int pri, int sec, int damping,
                                 int chroma, void* out, void* stream) {
  const int64_t n = static_cast<int64_t>(H) * W;
  if (n > 0) {
    const int grid = static_cast<int>((n + THREADS - 1) / THREADS);
    auto s = static_cast<cudaStream_t>(stream);
    auto p = static_cast<const uint8_t*>(plane);
    auto d = static_cast<const int8_t*>(dirs);
    auto v = static_cast<const int*>(var);
    auto k = static_cast<const uint8_t*>(skip8);
    auto ix = static_cast<const int*>(idx);
    auto o = static_cast<uint8_t*>(out);
    if (chroma) {
      cdef_apply_kernel<4, 32><<<grid, THREADS, 0, s>>>(
          p, H, W, d, v, k, ix, nc_sb, pri, sec, damping, o);
    } else {
      cdef_apply_kernel<8, 64><<<grid, THREADS, 0, s>>>(
          p, H, W, d, v, k, ix, nc_sb, pri, sec, damping, o);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
