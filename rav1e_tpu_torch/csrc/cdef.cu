// CDEF on the card: direction search, ladder SSE table and filter (CUDA,
// sm_90a). Three kernels, each launched once a frame by
// rav1e_tpu_torch/ops/cdef.py; the SSE table and the filter take the
// frame's three planes (4:2:0) in that one launch.
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
// candidates on them. These kernels keep the taps in shared memory and
// registers instead.
//
// The arithmetic is the reference's, integer for integer:
//   constrain(d, S, D) = sign(d) * min(|d|, max(0, S - (|d| >> max(0, D -
//                        msb(S))))), 0 where S == 0;
//   msb is an integer 31 - clz (the reference takes floor(log2(f32)),
//   which agrees wherever CDEF reads it: strengths <= 14 and
//   min(msb(var >> 6), 12));
//   y = x + ((8 + s - (s < 0)) >> 4), clipped to the min/max of x and the
//   taps that are in the frame, kept as x when the 8x8 unit is skipped or
//   both strengths are 0. Every shift of a value that may be negative is
//   `>>` on int (arithmetic), never `/`.
// Taps outside the frame (LARGE in the reference's padded plane) are
// OUT = -2^14 in the tiles here. For them |d| >= 2^14, so |d| >> D > 14
// >= S for any damping D <= 10 (AV1 allows 3..6) and constrain gives 0
// with no test; a signed max and an unsigned min leave them out of the
// clamp window (-2^14 is the largest unsigned value), again with no test.
// Each tile is a region and a 2-pixel halo as int16, filled one aligned
// 4-byte word of the plane a load.
//
// (a) cdef_dirs: eight threads per 8x8 luma block, one per direction.
//     A direction's cost is a sum over its bins of partial^2 * 840 / n,
//     with n the bin's pixels and |partial| <= 128 n at 8 bits, so it is
//     at most 128^2 * 840 * 64 = 880,803,840 < 2^31 - 1 and int32 holds
//     it exactly (the reference uses two int32 limbs; an all-black block
//     reaches the bound in every direction). The first maximum wins
//     ties; var = (cost[best] - cost[best ^ 4]) >> 10. A block of 256
//     threads takes 32 8x8 blocks of one block row. Warps 0 and 1 load
//     four rows each of the 32 (one 8-byte word a lane, 256 contiguous
//     bytes a row; W % 8 == 0 and an 8-byte-aligned base, which the
//     wrapper ensures), store them as x - 128 in int8, and store the
//     transposed blocks' rows four bytes at a time (byte permutes); then
//     warp d forms direction d's bins for its 32 blocks with __dp4a on 4
//     pixels a word, the byte masks and bin weights folded at compile
//     time, directions 5, 6, 7 as the kinds of 3, 2, 1 on the transposed
//     block (rows for 6, pair sums for 5 and 7), so no warp diverges.
//     One warp then takes each block's argmax. 1080p: 261,120 threads
//     in 1,088 blocks. Bound: the 2 MB read at 1080p; the least work, 351
//     operations a block (chip_smoke.py, _dirs_ops), takes less. Measured
//     against other forms (PERF.md): one row a thread for all 8 warps, two
//     block rows a block, and the bins' sums as int8 tensor-core products
//     with a one-hot table were each slower.
// (b) cdef_ladder_sse: the table of each ladder entry's squared error
//     against the source, per cell: per superblock over its TL and BR
//     32x32 luma / 16x16 chroma quadrants (the sampled branch), or per
//     32-block (the full branch). One block of 128 threads per cell takes
//     the cell's luma and both chroma planes, so one launch serves the
//     frame: 510 blocks at 1080p sampled, all resident at once (4 a SM,
//     at most 128 registers a thread). Bound: the operations, not the
//     3 MB it reads (chip_smoke.py, _cdef_ladder_ops). What the design
//     does about them:
//     - the tap work the entries share is done once a pixel: the 12 tap
//       differences, |.|, their signs (times the secondary weight) and
//       the two clamp windows (primary taps, and primary + secondary);
//       the secondary taps' constrained sum depends on the entry only
//       through its secondary strength, so it is formed once for each
//       of 1, 2 and 4 and shared by the entries that have it; chroma
//       entries 1 and 2 are one pair, (1, 0), and filter once. Each
//       entry then does only its primary taps, the round and the clip;
//     - each thread takes runs of 8 (luma) or 4 (chroma) pixels of one
//       unit row, two rows of one unit in the sampled branch, so the
//       unit's direction, skip flag and per-entry strengths, damping
//       shifts and tap weights are read and formed once for the run;
//     - the exact-integer table: every squared error is an integer <=
//       255^2, so a cell whose integer total is <= 2^24 has every
//       partial sum exact in f32, and the reference's f32 sum is that
//       total in any order. Each thread sums its errors in int32, each
//       warp reduces them (REDUX), and the block writes the totals as
//       f32. Only when some total of the block passes 2^24 (decided by
//       __syncthreads_or) does the block run the reference's order:
//       region by region (the TL quadrant, then the BR one) the errors
//       go to shared memory, one thread per (entry, row) forms the row's
//       exact terms, and one thread per entry adds them to its f32
//       running total in XLA:CPU's order (ops/cdef.py, _xla_rows_sum:
//       the rows in order, each row over 8 lanes, the running total
//       entering lane 0, the lanes folded in halves). Real content stays
//       far below 2^24; noise at q 255 passes it.
// (c) cdef_apply: the frame filtered with each SB's winning ladder entry,
//     or with one uniform pair per plane kind (the fixed-strength filter,
//     where the direction is 0 when the plane's primary strength is 0).
//     One block of 256 threads per 64x64 luma SB takes its luma and its
//     two 32x32 chroma SBs: one launch a frame. The block reads the SB's
//     entry once from idx on the device. A plane whose pair is (0, 0), or
//     an SB whose units are all skipped, is copied with 8-byte (luma) and
//     4-byte (chroma) loads and stores; otherwise the SB and its 2-pixel
//     halo go to shared memory and each thread filters runs of 8 (luma)
//     or 4 (chroma) pixels of one unit row, two rows of one unit, with
//     the unit's direction, skip flag and strengths formed once, and
//     stores each run as one word. Skipped units and units with no
//     strength are copied from the tile. SBs cut by the frame edge are
//     masked. No integer division per pixel. Bound: the operations
//     (chip_smoke.py, _cdef_ops: 7 a tap that the pair's strengths
//     read, the clamp window, 5 or 6 to round and clip).
// Each kernel is a template on the pixel type: uint8_t at 8 bits,
// uint16_t at 10 (the reference's CoeffShift 2: the strengths and
// dampings scale by 4, the primary taps' parity reads the adjusted
// strength >> 2, and the direction search runs on px >> 2, packed to
// bytes as it loads). The tiles stay int16, and OUT still constrains to
// 0 (|d| >= 2^14 - 1023, >> at most 8, exceeds every strength <= 56).
// At 10 bits a squared error is up to 1023^2 and a luma cell's total up
// to 2,143,291,392, still an exact int32; the ordered path (common at 10
// bits: a cell passes 2^24 at an RMS error of 64 in 10-bit units) forms
// its row terms with shared atomics instead of the 8-bit err array.
//
// The tiled search (the reference's cdef_search_persb_tiled,
// rav1e_tpu/ops/tpu/cdef.py:442) runs (b) and (c) on one shard's tile
// columns: the planes they read are the shard's columns with a halo of
// `halo` columns (8 luma, 4 chroma) of each neighbour on either side,
// and a halo that lies outside the frame (the first or last shard) is
// marked by the valid column range [xlo, xhi), so its taps are OUT, as
// the reference's LARGE sentinel there. The SB grid starts at column
// `halo`; the sources, the grids, the table and the outputs are the
// shard's own columns. Without a halo (halo 0, [0, W)) the kernels read
// the whole frame as before.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;         // cdef_dirs, cdef_apply
constexpr int LADDER_THREADS = 128;  // cdef_ladder_sse
constexpr uint32_t OUT2 = 0xC000C000u;   // two int16 OUT = -2^14
constexpr int EXACT = 1 << 24;       // f32 sums of integers are exact up to here

// CDEF_LADDER[k][col]: (y_pri, y_sec, uv_pri, uv_sec) of entry k.
__host__ __device__ constexpr int ladder(int k, int col) {
  return col == 0   ? (k < 4 ? k : k == 4 ? 5 : k == 5 ? 7 : k == 6 ? 10 : 14)
         : col == 1 ? (k < 2 ? 0 : k < 4 ? 1 : k < 7 ? 2 : 4)
         : col == 2 ? (k < 3 ? (k > 0) : k == 3 ? 2 : k == 4 ? 4
                       : k == 5 ? 5 : k == 6 ? 8 : 12)
                    : (k < 3 ? 0 : k < 5 ? 1 : k < 7 ? 2 : 4);
}

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

__device__ __forceinline__ int umin(int a, int b) {
  return static_cast<int>(min(static_cast<unsigned>(a),
                              static_cast<unsigned>(b)));
}

// min(a, max(0, s - (a >> sh))) for a = |d| >= 0: constrain's magnitude.
__device__ __forceinline__ int lim(int a, int s, int sh) {
  return max(0, min(a, s - (a >> sh)));
}

// The luma primary strength after the variance adjustment.
__device__ __forceinline__ int luma_pri_adj(int pri, int var) {
  if (var <= 0) return 0;
  const int v6 = var >> 6;
  const int vs = v6 > 0 ? min(msb(v6), 12) : 0;
  return (pri * (4 + vs) + 8) >> 4;
}

// Pixels: uint8_t at 8 bits, uint16_t at 10 (values <= 1023). SHIFT<Pix>
// is bd - 8: the strengths and dampings scale by it, the direction
// search reads px >> SHIFT, and the primary taps' parity reads the
// adjusted strength >> SHIFT (the reference's CoeffShift).
template <typename Pix>
constexpr int SHIFT = sizeof(Pix) == 1 ? 0 : 2;

// The vector type of N bytes (4, 8 or 16): one load or store a run.
template <int N>
struct Vec;
template <>
struct Vec<4> {
  using T = uint32_t;
};
template <>
struct Vec<8> {
  using T = uint2;
};
template <>
struct Vec<16> {
  using T = uint4;
};

// A vector's 32-bit words, and a vector made of words.
__device__ __forceinline__ void words(uint32_t v, uint32_t* w) { w[0] = v; }
__device__ __forceinline__ void words(uint2 v, uint32_t* w) {
  w[0] = v.x;
  w[1] = v.y;
}
__device__ __forceinline__ void words(uint4 v, uint32_t* w) {
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}
template <typename V>
__device__ __forceinline__ V vec_of(const uint32_t* w);
template <>
__device__ __forceinline__ uint32_t vec_of<uint32_t>(const uint32_t* w) {
  return w[0];
}
template <>
__device__ __forceinline__ uint2 vec_of<uint2>(const uint32_t* w) {
  return make_uint2(w[0], w[1]);
}
template <>
__device__ __forceinline__ uint4 vec_of<uint4>(const uint32_t* w) {
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Rows r0 - 2 .. r0 + RH + 1 and columns c0 - 4 .. c0 + RW + 3 of a
// plane (row stride `stride`) into `tile` ([RH + 4][RW + 8] int16), OUT
// outside the frame: outside rows 0 .. H - 1 and columns xlo .. xhi - 1.
// Four pixels an aligned load (one 4-byte word at 8 bits, 8 bytes at
// 10; c0, stride, xlo and xhi are multiples of 4). Without a halo the
// columns are 0 .. W - 1 of a plane of stride W; with one (the tiled
// search), the plane is a shard's columns with `halo` columns of each
// neighbour on either side, and a halo that lies outside the frame is
// left out of [xlo, xhi), so its taps are OUT as at a frame edge.
template <int RH, int RW, int NT, typename Pix>
__device__ __forceinline__ void load_tile(int16_t* tile,
                                          const Pix* __restrict__ plane,
                                          int H, int stride, int xlo,
                                          int xhi, int r0, int c0) {
  constexpr int WPR = (RW + 8) / 4;
  for (int i = threadIdx.x; i < (RH + 4) * WPR; i += NT) {
    const int ty = i / WPR;
    const int tw = i - ty * WPR;
    const int yy = r0 - 2 + ty;
    const int xx = c0 - 4 + 4 * tw;
    uint2 v = make_uint2(OUT2, OUT2);
    if (yy >= 0 && yy < H && xx >= xlo && xx < xhi) {
      const Pix* at = plane + static_cast<int64_t>(yy) * stride + xx;
      if constexpr (sizeof(Pix) == 1) {
        const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(at));
        v = make_uint2(__byte_perm(w, 0, 0x4140),
                       __byte_perm(w, 0, 0x4342));
      } else {
        v = __ldg(reinterpret_cast<const uint2*>(at));
      }
    }
    reinterpret_cast<uint2*>(tile)[i] = v;
  }
}

// Each direction's 12 tap offsets in a tile of COLS columns, into shared
// memory (a thread's unit reads its row with one dynamic index).
template <int COLS>
__device__ __forceinline__ void fill_offsets(int (*off)[12]) {
  for (int i = threadIdx.x; i < 96; i += 32) {
    const int d = i / 12, t = i - d * 12;
    off[d][t] = t < 4 ? c_pri[d][t][0] * COLS + c_pri[d][t][1]
                      : c_sec[d][t - 4][0] * COLS + c_sec[d][t - 4][1];
  }
}

// (a) direction and variance: a block of 256 threads takes a row of 32
// 8x8 luma blocks (DIR_BLOCKS, one a lane), warp d their direction d.

constexpr int DIR_BLOCKS = 32;

// The bytes of the 4-byte word h of row i that direction d's bin k holds,
// as a __dp4a mask (1 in each byte that the bin takes).
__host__ __device__ constexpr int bin_mask(int d, int i, int h, int k) {
  return (dir_bin(d, i, 4 * h) == k ? 0x1 : 0)
         | (dir_bin(d, i, 4 * h + 1) == k ? 0x100 : 0)
         | (dir_bin(d, i, 4 * h + 2) == k ? 0x10000 : 0)
         | (dir_bin(d, i, 4 * h + 3) == k ? 0x1000000 : 0);
}

// 840 / (pixels in bin k) for the directions of the row kind (d = 2:
// rows), the diagonal kind (d = 0: i + j) and the half-diagonal kind
// (d = 1: i + (j >> 1)), 0 past the last bin.
__host__ __device__ constexpr int bin_weight(int d, int k) {
  return d == 2 ? (k < 8 ? 105 : 0)
         : d == 0 ? (k < 15 ? 840 / (k < 8 ? k + 1 : 15 - k) : 0)
                  : (k < 11 ? 840 / (2 * (k < 3 ? k + 1 : k > 7 ? 11 - k
                                                                 : 4))
                            : 0);
}

// Direction d's cost from the block's rows (x - 128 as int8 in 8 bytes),
// in int32. d is 0..4, or the kind of direction 5, 6, 7 (3, 2, 1) read
// on the transposed block. A bin of n pixels has |sum| <= 128 n and
// weight 840 / n, so the cost is at most 128^2 * 840 * 64 = 880,803,840
// < 2^31 - 1 (an all-black block reaches it in every direction).
template <int D>
__device__ __forceinline__ int dir_cost(const uint2* __restrict__ rows) {
  int part[15];
#pragma unroll
  for (int k = 0; k < 15; ++k) part[k] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint2 r = rows[i * DIR_BLOCKS];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < 15; ++k)
        if (bin_mask(D, i, h, k) != 0)
          part[k] = __dp4a(static_cast<int>(h ? r.y : r.x),
                           bin_mask(D, i, h, k), part[k]);
  }
  constexpr int KIND = D == 3 ? 1 : D == 4 ? 0 : D;
  int c = 0;
#pragma unroll
  for (int k = 0; k < 15; ++k)
    if (bin_weight(KIND, k) != 0) c += part[k] * part[k] * bin_weight(KIND, k);
  return c;
}

// Two 10-bit pixels a word (a, b: two words) >> 2 as four bytes.
__device__ __forceinline__ uint32_t pack_shr2(uint32_t a, uint32_t b) {
  return __byte_perm((a >> 2) & 0x00FF00FFu, (b >> 2) & 0x00FF00FFu,
                     0x6420);
}

template <typename Pix>
__global__ void __launch_bounds__(THREADS)
cdef_dirs_kernel(const Pix* __restrict__ y, int H, int W,
                 int8_t* __restrict__ dir_out, int* __restrict__ var_out) {
  // rows[i][b]: row i of block b; cols[j][b]: column j of block b (the
  // transposed block's row j); both x - 128 as int8
  __shared__ uint2 rows[8][DIR_BLOCKS];
  __shared__ uint2 cols[8][DIR_BLOCKS];
  __shared__ int cost[8][DIR_BLOCKS];
  const int nbx = W >> 3;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bx = blockIdx.x * DIR_BLOCKS + lane;
  const int by = blockIdx.y;
  // warps 0 and 1 load rows 4w .. 4w + 3 of the 32 blocks (runs of 256
  // contiguous bytes) and store the transposed blocks' rows 4 bytes at
  // a time
  if (warp < 2) {
    const int r0 = 4 * warp;
    uint2 r[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      r[q] = make_uint2(0x80808080u, 0x80808080u);
      if (bx < nbx) {
        const Pix* at = y + static_cast<int64_t>(8 * by + r0 + q) * W
                        + 8 * bx;
        if constexpr (sizeof(Pix) == 1) {
          r[q] = __ldg(reinterpret_cast<const uint2*>(at));
        } else {
          // 8 pixels in 16 bytes, read >> 2 as the 8-bit search reads
          const uint4 w = __ldg(reinterpret_cast<const uint4*>(at));
          r[q] = make_uint2(pack_shr2(w.x, w.y), pack_shr2(w.z, w.w));
        }
      }
      r[q].x ^= 0x80808080u;
      r[q].y ^= 0x80808080u;
      rows[r0 + q][lane] = r[q];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // byte j of the 4 rows: column j of the block at those rows
      const int t = j & 3, sel = t | (4 + t) << 4;
      auto w = [&](int q) { return j < 4 ? r[q].x : r[q].y; };
      reinterpret_cast<uint32_t*>(&cols[j][lane])[warp] =
          __byte_perm(__byte_perm(w(0), w(1), sel),
                      __byte_perm(w(2), w(3), sel), 0x5410);
    }
  }
  __syncthreads();
  int c;
  switch (warp) {
    case 0: c = dir_cost<0>(&rows[0][lane]); break;
    case 1: c = dir_cost<1>(&rows[0][lane]); break;
    case 2: c = dir_cost<2>(&rows[0][lane]); break;
    case 3: c = dir_cost<3>(&rows[0][lane]); break;
    case 4: c = dir_cost<4>(&rows[0][lane]); break;
    case 5: c = dir_cost<3>(&cols[0][lane]); break;
    case 6: c = dir_cost<2>(&cols[0][lane]); break;
    default: c = dir_cost<1>(&cols[0][lane]); break;
  }
  cost[warp][lane] = c;
  __syncthreads();
  if (warp == 0 && bx < nbx) {
    int best = 0, cbest = cost[0][lane];
#pragma unroll
    for (int d = 1; d < 8; ++d)
      if (cost[d][lane] > cbest) {
        cbest = cost[d][lane];
        best = d;
      }
    const int64_t o = static_cast<int64_t>(by) * nbx + bx;
    dir_out[o] = static_cast<int8_t>(best);
    var_out[o] = (cbest - cost[(best + 4) & 7][lane]) >> 10;
  }
}

// ---- (b) the ladder's SSE table ---------------------------------------

// One unit's (8x8 luma, 4x4 chroma) per-entry primary strength after the
// luma variance adjustment, its damping shift and its two tap weights.
struct Unit {
  int pa[8], psh[8], ta[8], tb[8];
};

// pdamp: the plane's damping, scaled (+ SHIFT) as the strengths are.
template <bool LUMA, int SH>
__device__ __forceinline__ void unit_entries(int var, int pdamp, Unit& u) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int pri = ladder(k, LUMA ? 0 : 2) << SH;
    const int pa = LUMA ? luma_pri_adj(pri, var) : pri;
    const int odd = (pa >> SH) & 1;
    u.pa[k] = pa;
    u.psh[k] = max(0, pdamp - msb(pa));
    u.ta[k] = odd ? 3 : 4;
    u.tb[k] = odd ? 3 : 2;
  }
}

// The 8 ladder entries' filtered values minus the source s0, for the
// pixel at tile[i]; ssh[j]: the damping shift of secondary strength
// 2^j << SH (damping + SH - (j + SH): the same as at 8 bits).
template <bool LUMA, int SH>
__device__ __forceinline__ void ladder_px(const int16_t* tile, int i,
                                          const int* off, const Unit& u,
                                          const int (&ssh)[3], bool skip,
                                          int s0, int (&e)[8]) {
  const int x = tile[i];
  if (skip) {
#pragma unroll
    for (int k = 0; k < 8; ++k) e[k] = x - s0;
    return;
  }
  int a[12], sg[12];
  int mxp = x, mnp = x, mxs = x, mns = x;
#pragma unroll
  for (int t = 0; t < 12; ++t) {
    const int p = tile[i + off[t]];
    const int d = p - x;
    const int neg = d >> 31;
    a[t] = abs(d);
    // sign(d), times 2 for the first four secondary taps
    sg[t] = (t >= 4 && t < 8) ? ((neg * 4) | 2) : (neg | 1);
    if (t < 4) {
      mxp = max(mxp, p);
      mnp = umin(mnp, p);
    }
    mxs = max(mxs, p);
    mns = umin(mns, p);
  }
  int ssum[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    int acc = 0;
#pragma unroll
    for (int t = 4; t < 12; ++t)
      acc += sg[t] * lim(a[t], (1 << j) << SH, ssh[j]);
    ssum[j] = acc;
  }
  e[0] = x - s0;
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    if (!LUMA && k == 2) {     // chroma entries 1 and 2 are both (1, 0)
      e[2] = e[1];
      continue;
    }
    const int sec = ladder(k, LUMA ? 1 : 3);
    const int p01 = sg[0] * lim(a[0], u.pa[k], u.psh[k])
                    + sg[1] * lim(a[1], u.pa[k], u.psh[k]);
    const int p23 = sg[2] * lim(a[2], u.pa[k], u.psh[k])
                    + sg[3] * lim(a[3], u.pa[k], u.psh[k]);
    int s = u.ta[k] * p01 + u.tb[k] * p23;
    if (sec > 0) s += ssum[sec == 1 ? 0 : sec == 2 ? 1 : 2];
    const int y = x + ((8 + s + (s >> 31)) >> 4);
    e[k] = min(max(y, sec > 0 ? mns : mnp), sec > 0 ? mxs : mxp) - s0;
  }
}

// The NPX pixels of a run from its words: pixel j of 8 or 16 bits.
template <typename Pix>
__device__ __forceinline__ int run_px(const uint32_t* w, int j) {
  if constexpr (sizeof(Pix) == 1)
    return static_cast<int>((w[j >> 2] >> (8 * (j & 3))) & 255u);
  else
    return static_cast<int>((w[j >> 1] >> (16 * (j & 1))) & 0xFFFFu);
}

// A run of NPX pixels at src as words, one vector load.
template <int NPX, typename Pix>
__device__ __forceinline__ void load_run(const Pix* __restrict__ src,
                                         uint32_t* w) {
  using V = typename Vec<NPX * sizeof(Pix)>::T;
  words(__ldg(reinterpret_cast<const V*>(src)), w);
}

// The errors of one run of 8 (luma) or 4 (chroma) pixels of a unit row:
// f(j, e) for pixel j. tile: the region's tile; ty, tx: the run's first
// pixel in region coordinates; src: the source at that pixel.
template <bool LUMA, typename Pix, typename F>
__device__ __forceinline__ void ladder_run(const int16_t* tile, int ty,
                                           int tx, const int* off,
                                           const Unit& u, const int (&ssh)[3],
                                           bool skip,
                                           const Pix* __restrict__ src,
                                           F&& f) {
  constexpr int NPX = LUMA ? 8 : 4;
  constexpr int COLS = LUMA ? 40 : 24;
  uint32_t sw[NPX * sizeof(Pix) / 4];
  load_run<NPX>(src, sw);
  const int i0 = (ty + 2) * COLS + tx + 4;
#pragma unroll
  for (int j = 0; j < NPX; ++j) {
    int e[8];
    ladder_px<LUMA, SHIFT<Pix>>(tile, i0 + j, off, u, ssh, skip,
                                run_px<Pix>(sw, j), e);
    f(j, e);
  }
}

// One block per cell: R x C = the SBs (sampled: each SB's TL and BR
// 32x32 luma / 16x16 chroma quadrants) or the 32-blocks (full). The
// thread's runs: luma, 4 runs of 8 px across a 32-px quadrant row, the
// rest of the thread index over (quadrant, row); chroma, 4 runs of 4 px,
// the rest over (plane, quadrant, row). Out f32 [3, 8, R, C].
//
// At 10 bits (Pix = uint16_t) a squared error is at most 1023^2 <= 2^20:
// a thread's run sums at most 16 of them, a cell's luma total at most
// 2,048 (2,143,291,392 < 2^31), so the int32 totals stay exact. The
// ordered path has no room for the errors themselves (32 bits each), so
// each thread forms its run's part of each row's terms, the lane-0
// errors stored and the lane sums added with shared atomics (integers,
// in any order), and the f32 chain reads the same terms as at 8 bits.
template <bool SAMPLED, typename Pix>
__global__ void __launch_bounds__(LADDER_THREADS, 4)
cdef_ladder_sse_kernel(const Pix* __restrict__ py,
                       const Pix* __restrict__ pu,
                       const Pix* __restrict__ pv,
                       const Pix* __restrict__ sy,
                       const Pix* __restrict__ su,
                       const Pix* __restrict__ sv, int H, int W,
                       const int8_t* __restrict__ dirs,
                       const int* __restrict__ var,
                       const uint8_t* __restrict__ skip8, int damping, int R,
                       int C, float* __restrict__ out,
                       int* __restrict__ paths, int halo, int xlo,
                       int xhi) {
  constexpr int NREG = SAMPLED ? 2 : 1;   // regions (quadrants) a cell
  constexpr int RPT = NREG;               // rows a thread's run covers
  constexpr int SH = SHIFT<Pix>;
  constexpr bool WIDE = sizeof(Pix) == 2;
  __shared__ __align__(16) int16_t tile_y[NREG][36 * 40];
  __shared__ __align__(16) int16_t tile_c[2][NREG][20 * 24];
  __shared__ int off_y[8][12], off_c[8][12];
  __shared__ int wsum[2][LADDER_THREADS / 32][8];
  // the ordered path: one region's squared errors (8 bits), each row's
  // terms
  __shared__ uint16_t err[WIDE ? 1 : 8][32][34];
  __shared__ int terms[8][32][7];

  const int tid = threadIdx.x;
  const int br = blockIdx.x / C;
  const int bc = blockIdx.x - br * C;
  const int Hc = H >> 1, Wc = W >> 1, gw = W >> 3;
  const int ssh_y[3] = {max(0, damping), max(0, damping - 1),
                        max(0, damping - 2)};
  const int ssh_c[3] = {max(0, damping - 1), max(0, damping - 2),
                        max(0, damping - 3)};
  const int pdamp_y = damping + SH, pdamp_c = damping + SH - 1;
  // region q's first row (rc = br) or column (rc = bc); b: its side,
  // 32 luma, 16 chroma
  auto org = [&](int q, int b, int rc) {
    return (SAMPLED ? 2 * rc + q : rc) * b;
  };

  if (tid < 32) {
    fill_offsets<40>(off_y);
    fill_offsets<24>(off_c);
  }
  // the planes' strides and the shard's first column in them (a halo);
  // the sources, grids and table are the shard's own (W columns)
  const int sy_w = W + 2 * halo, sc_w = sy_w >> 1;
#pragma unroll
  for (int q = 0; q < NREG; ++q) {
    load_tile<32, 32, LADDER_THREADS>(tile_y[q], py, H, sy_w, xlo, xhi,
                                      org(q, 32, br), org(q, 32, bc) + halo);
    load_tile<16, 16, LADDER_THREADS>(tile_c[0][q], pu, Hc, sc_w, xlo >> 1,
                                      xhi >> 1, org(q, 16, br),
                                      org(q, 16, bc) + (halo >> 1));
    load_tile<16, 16, LADDER_THREADS>(tile_c[1][q], pv, Hc, sc_w, xlo >> 1,
                                      xhi >> 1, org(q, 16, br),
                                      org(q, 16, bc) + (halo >> 1));
  }
  __syncthreads();

  const int u4 = tid & 3, rest = tid >> 2;
  const int lane = tid & 31, warp = tid >> 5;
  {
    // luma: RPT rows of one unit
    const int q = SAMPLED ? rest >> 4 : 0;
    const int row0 = SAMPLED ? (rest & 15) * 2 : rest;
    const int yy = org(q, 32, br) + row0, xx = org(q, 32, bc) + 8 * u4;
    const int g = (yy >> 3) * gw + (xx >> 3);
    Unit un;
    unit_entries<true, SH>(var[g], pdamp_y, un);
    const int* off = off_y[dirs[g]];
    const bool sk = skip8[g] != 0;
    int acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int r = 0; r < RPT; ++r)
      ladder_run<true>(tile_y[q], row0 + r, 8 * u4, off, un, ssh_y, sk,
                       sy + static_cast<int64_t>(yy + r) * W + xx,
                       [&](int, const int (&e)[8]) {
#pragma unroll
                         for (int k = 0; k < 8; ++k) acc[k] += e[k] * e[k];
                       });
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int s = __reduce_add_sync(0xffffffffu, acc[k]);
      if (lane == 0) wsum[0][warp][k] = s;
    }
  }
  {
    // chroma: warps 0-1 the U plane, 2-3 the V plane; RPT rows of a unit
    const int pl = rest >> 4, r2 = rest & 15;
    const int q = SAMPLED ? r2 >> 3 : 0;
    const int row0 = SAMPLED ? (r2 & 7) * 2 : r2;
    const int yy = org(q, 16, br) + row0, xx = org(q, 16, bc) + 4 * u4;
    const int g = (yy >> 2) * gw + (xx >> 2);
    Unit un;
    unit_entries<false, SH>(0, pdamp_c, un);
    const int* off = off_c[dirs[g]];
    const bool sk = skip8[g] != 0;
    const Pix* s = pl ? sv : su;
    int acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int r = 0; r < RPT; ++r)
      ladder_run<false>(tile_c[pl][q], row0 + r, 4 * u4, off, un, ssh_c, sk,
                        s + static_cast<int64_t>(yy + r) * Wc + xx,
                        [&](int, const int (&e)[8]) {
#pragma unroll
                          for (int k = 0; k < 8; ++k)
                            if (k != 2) acc[k] += e[k] * e[k];
                        });
    acc[2] = acc[1];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int s2 = __reduce_add_sync(0xffffffffu, acc[k]);
      if (lane == 0) wsum[1][warp][k] = s2;
    }
  }
  __syncthreads();

  // exact integer totals: thread 8 p + k holds plane p's entry k
  const int RC = R * C;
  int total = 0;
  if (tid < 24) {
    const int p = tid >> 3, k = tid & 7;
    if (p == 0) {
#pragma unroll
      for (int w = 0; w < LADDER_THREADS / 32; ++w) total += wsum[0][w][k];
    } else {
      total = wsum[1][2 * p - 2][k] + wsum[1][2 * p - 1][k];
    }
  }
  if (!__syncthreads_or(tid < 24 && total > EXACT)) {
    if (tid < 24)
      out[static_cast<int64_t>(tid) * RC + blockIdx.x] =
          static_cast<float>(total);
    if (tid == 0 && paths != nullptr) atomicAdd(paths, 1);
    return;
  }

  // the ordered path: plane by plane, region by region, the reference's
  // f32 running total of each entry (thread k < 8)
  float ftotal = 0.0f;
  for (int p = 0; p < 3; ++p) {
    const int B = p == 0 ? 32 : 16;
    const int nt = B / 8 + 3;   // row terms: lane 0 per chunk of 8, then
                                // the lane-4, lanes-2+6 and odd-lane totals
    for (int q = 0; q < NREG; ++q) {
      __syncthreads();
      if constexpr (WIDE) {
        // zero the lane sums that the atomics add into
        for (int i = tid; i < 8 * B * 3; i += LADDER_THREADS) {
          const int k = i / (3 * B), rj = i - k * 3 * B;
          terms[k][rj / 3][B / 8 + rj % 3] = 0;
        }
        __syncthreads();
      }
      // one run's squared errors: at 8 bits into err, at 10 into its
      // row's terms (pixel col of the row, lane col & 7 of its chunk)
      int p4[8], p26[8], podd[8];   // this run's parts of the lane sums
#pragma unroll
      for (int k = 0; k < 8; ++k) p4[k] = p26[k] = podd[k] = 0;
      auto put = [&](int row, int col, const int (&e)[8]) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int e2 = e[k] * e[k];
          if constexpr (WIDE) {
            const int lane = col & 7;
            if (lane == 0)
              terms[k][row][col >> 3] = e2;
            else if (lane == 4)
              p4[k] += e2;
            else if (lane == 2 || lane == 6)
              p26[k] += e2;
            else
              podd[k] += e2;
          } else {
            err[k][row][col] = static_cast<uint16_t>(e2);
          }
        }
      };
      int row = -1;
      if (p == 0) {
        row = tid >> 2;
        const int yy = org(q, 32, br) + row, xx = org(q, 32, bc) + 8 * u4;
        const int g = (yy >> 3) * gw + (xx >> 3);
        Unit un;
        unit_entries<true, SH>(var[g], pdamp_y, un);
        ladder_run<true>(tile_y[q], row, 8 * u4, off_y[dirs[g]], un, ssh_y,
                         skip8[g] != 0,
                         sy + static_cast<int64_t>(yy) * W + xx,
                         [&](int j, const int (&e)[8]) {
                           put(row, 8 * u4 + j, e);
                         });
      } else if (tid < 64) {
        row = tid >> 2;
        const int yy = org(q, 16, br) + row, xx = org(q, 16, bc) + 4 * u4;
        const int g = (yy >> 2) * gw + (xx >> 2);
        Unit un;
        unit_entries<false, SH>(0, pdamp_c, un);
        ladder_run<false>(tile_c[p - 1][q], row, 4 * u4, off_c[dirs[g]], un,
                          ssh_c, skip8[g] != 0,
                          (p == 1 ? su : sv) + static_cast<int64_t>(yy) * Wc
                              + xx,
                          [&](int j, const int (&e)[8]) {
                            put(row, 4 * u4 + j, e);
                          });
      }
      if constexpr (WIDE) {
        if (row >= 0) {
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            atomicAdd(&terms[k][row][B / 8], p4[k]);
            atomicAdd(&terms[k][row][B / 8 + 1], p26[k]);
            atomicAdd(&terms[k][row][B / 8 + 2], podd[k]);
          }
        }
        __syncthreads();
      } else {
        __syncthreads();
        for (int i = tid; i < 8 * B; i += LADDER_THREADS) {
          const int k = i / B, r = i - k * B;
          const uint16_t* e = err[k][r];
          int l4 = 0, l26 = 0, lodd = 0;
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
      }
      if (tid < 8)
        for (int r = 0; r < B; ++r)
          for (int j = 0; j < nt; ++j)
            ftotal = __fadd_rn(ftotal, static_cast<float>(terms[tid][r][j]));
    }
    if (tid < 8) {
      out[static_cast<int64_t>(8 * p + tid) * RC + blockIdx.x] = ftotal;
      ftotal = 0.0f;
    }
  }
  if (tid == 0 && paths != nullptr) atomicAdd(paths + 1, 1);
}

// ---- (c) the filtered frame ---------------------------------------------

// One pixel at tile[i] filtered with one strength pair: the unit's
// adjusted primary strength pa (damping shift psh, tap weights ta, tb)
// and the secondary strength sec (shift ssh; its taps only when sec > 0).
__device__ __forceinline__ int apply_px(const int16_t* tile, int i,
                                        const int* off, int pa, int psh,
                                        int ta, int tb, int sec, int ssh) {
  const int x = tile[i];
  int p01 = 0, p23 = 0, s = 0, mx = x, mn = x;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int p = tile[i + off[t]];
    const int d = p - x;
    const int c = ((d >> 31) | 1) * lim(abs(d), pa, psh);
    if (t < 2)
      p01 += c;
    else
      p23 += c;
    mx = max(mx, p);
    mn = umin(mn, p);
  }
  if (sec > 0) {
#pragma unroll
    for (int t = 4; t < 12; ++t) {
      const int p = tile[i + off[t]];
      const int d = p - x;
      const int neg = d >> 31;
      s += (t < 8 ? ((neg * 4) | 2) : (neg | 1)) * lim(abs(d), sec, ssh);
      mx = max(mx, p);
      mn = umin(mn, p);
    }
  }
  s += ta * p01 + tb * p23;
  const int y = x + ((8 + s + (s >> 31)) >> 4);
  return min(max(y, mn), mx);
}

// One run of NPX pixels of a unit row: filtered from the tile, or kept
// as they are where the unit is skipped or has no strength; stored as
// one vector (NPX pixels) at dst. pa, sec and pdamp arrive scaled by
// SHIFT<Pix>; the primary taps' parity reads pa >> SHIFT.
template <int NPX, int COLS, typename Pix>
__device__ __forceinline__ void apply_run(const int16_t* tile, int ty, int tx,
                                          const int* off, int pa, int sec,
                                          int pdamp, bool keep,
                                          Pix* __restrict__ dst) {
  using V = typename Vec<NPX * sizeof(Pix)>::T;
  constexpr int PPW = 4 / sizeof(Pix);   // pixels a 32-bit word
  constexpr int BITS = 8 * sizeof(Pix);
  const int i0 = (ty + 2) * COLS + tx + 4;
  uint32_t w[NPX / PPW];
#pragma unroll
  for (int h = 0; h < NPX / PPW; ++h) w[h] = 0;
  const int psh = max(0, pdamp - msb(pa));
  const int ssh = max(0, pdamp - msb(sec));
  const int odd = (pa >> SHIFT<Pix>) & 1;
  const int ta = odd ? 3 : 4, tb = odd ? 3 : 2;
#pragma unroll
  for (int j = 0; j < NPX; ++j) {
    const int y = keep ? tile[i0 + j]
                       : apply_px(tile, i0 + j, off, pa, psh, ta, tb, sec,
                                  ssh);
    w[j / PPW] |= static_cast<uint32_t>(y) << (BITS * (j % PPW));
  }
  *reinterpret_cast<V*>(dst) = vec_of<V>(w);
}

// A run of NPX pixels copied with one vector load and store.
template <int NPX, typename Pix>
__device__ __forceinline__ void copy_run(const Pix* __restrict__ src,
                                         Pix* __restrict__ dst) {
  using V = typename Vec<NPX * sizeof(Pix)>::T;
  *reinterpret_cast<V*>(dst) = __ldg(reinterpret_cast<const V*>(src));
}

// One block per 64x64 luma SB: its luma (runs of 8 px, rows 2 rp and
// 2 rp + 1 of unit column u8 for thread 8 rp + u8) and its two 32x32
// chroma SBs (runs of 4 px; the rest of the thread index over (plane,
// row pair)). idx (row stride ceil(W / 64)) selects the SB's ladder
// entry; without idx the planes take the uniform pairs.
template <typename Pix>
__global__ void __launch_bounds__(THREADS, 4)
cdef_apply_kernel(const Pix* __restrict__ py,
                  const Pix* __restrict__ pu,
                  const Pix* __restrict__ pv, int H, int W,
                  const int8_t* __restrict__ dirs,
                  const int* __restrict__ var,
                  const uint8_t* __restrict__ skip8,
                  const int* __restrict__ idx, int y_pri, int y_sec,
                  int uv_pri, int uv_sec, int damping,
                  Pix* __restrict__ oy, Pix* __restrict__ ou,
                  Pix* __restrict__ ov, int* __restrict__ paths, int halo,
                  int xlo, int xhi) {
  constexpr int SH = SHIFT<Pix>;
  __shared__ __align__(16) int16_t tile_y[68 * 72];
  __shared__ __align__(16) int16_t tile_c[2][36 * 40];
  __shared__ int off_y[8][12], off_c[8][12];
  const int tid = threadIdx.x;
  const int nc = (W + 63) >> 6;
  const int sbr = blockIdx.x / nc;
  const int sbc = blockIdx.x - sbr * nc;
  const int Hc = H >> 1, Wc = W >> 1, gw = W >> 3;
  int lp = y_pri, ls = y_sec, cp = uv_pri, cs = uv_sec;
  if (idx != nullptr) {
    const int k = idx[blockIdx.x];
    lp = ladder(k, 0);
    ls = ladder(k, 1);
    cp = ladder(k, 2);
    cs = ladder(k, 3);
  }
  lp <<= SH;
  ls <<= SH;
  cp <<= SH;
  cs <<= SH;
  bool sk = true;
  if (tid < 64) {
    const int uy = 8 * sbr + (tid >> 3), ux = 8 * sbc + (tid & 7);
    if (uy < (H >> 3) && ux < gw) sk = skip8[uy * gw + ux] != 0;
  }
  const bool all_skip = __syncthreads_and(sk);
  const bool copy_y = all_skip || (lp == 0 && ls == 0);
  const bool copy_c = all_skip || (cp == 0 && cs == 0);
  if (tid < 32) {
    fill_offsets<72>(off_y);
    fill_offsets<40>(off_c);
  }
  // the input planes' strides (a shard with its halo columns); the
  // outputs and grids are the shard's own W columns
  const int sy_w = W + 2 * halo, sc_w = sy_w >> 1, hc = halo >> 1;
  if (!copy_y)
    load_tile<64, 64, THREADS>(tile_y, py, H, sy_w, xlo, xhi, 64 * sbr,
                               64 * sbc + halo);
  if (!copy_c) {
    load_tile<32, 32, THREADS>(tile_c[0], pu, Hc, sc_w, xlo >> 1, xhi >> 1,
                               32 * sbr, 32 * sbc + hc);
    load_tile<32, 32, THREADS>(tile_c[1], pv, Hc, sc_w, xlo >> 1, xhi >> 1,
                               32 * sbr, 32 * sbc + hc);
  }
  __syncthreads();
  const int u8 = tid & 7, rest = tid >> 3;
  {
    const int row0 = 2 * rest;
    const int xx = 64 * sbc + 8 * u8;
    const int yy = 64 * sbr + row0;
    if (xx < W && yy < H) {
      const int64_t o = static_cast<int64_t>(yy) * W + xx;
      if (copy_y) {
        const int64_t oi = static_cast<int64_t>(yy) * sy_w + xx + halo;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          copy_run<8>(py + oi + r * sy_w, oy + o + r * W);
      } else {
        const int g = (yy >> 3) * gw + (xx >> 3);
        const int pa = luma_pri_adj(lp, var[g]);
        const bool keep = skip8[g] != 0 || (pa == 0 && ls == 0);
        const int* off = off_y[lp > 0 ? dirs[g] : 0];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          apply_run<8, 72>(tile_y, row0 + r, 8 * u8, off, pa, ls,
                           damping + SH, keep, oy + o + r * W);
      }
    }
  }
  {
    const int pl = rest >> 4;
    const int row0 = 2 * (rest & 15);
    const int xx = 32 * sbc + 4 * u8;
    const int yy = 32 * sbr + row0;
    if (xx < Wc && yy < Hc) {
      const int64_t o = static_cast<int64_t>(yy) * Wc + xx;
      Pix* dst = pl ? ov : ou;
      if (copy_c) {
        const Pix* src = pl ? pv : pu;
        const int64_t oi = static_cast<int64_t>(yy) * sc_w + xx + hc;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          copy_run<4>(src + oi + r * sc_w, dst + o + r * Wc);
      } else {
        const int g = (yy >> 2) * gw + (xx >> 2);
        const int* off = off_c[cp > 0 ? dirs[g] : 0];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          apply_run<4, 40>(tile_c[pl], row0 + r, 4 * u8, off, cp, cs,
                           damping + SH - 1, skip8[g] != 0,
                           dst + o + r * Wc);
      }
    }
  }
  if (tid == 0 && paths != nullptr) {
    atomicAdd(paths + (copy_y ? 1 : 0), 1);
    atomicAdd(paths + (copy_c ? 1 : 0), 2);
  }
}

}  // namespace

// Every launch takes the planes' bit depth bd: 8 (uint8_t pixels) or 10
// (uint16_t); the wrappers check it.
extern "C" int cdef_dirs_launch(const void* y, int H, int W, void* dir_out,
                                void* var_out, int bd, void* stream) {
  if (H >= 8 && W >= 8) {
    const dim3 grid(((W >> 3) + DIR_BLOCKS - 1) / DIR_BLOCKS, H >> 3);
    auto s = static_cast<cudaStream_t>(stream);
    auto d = static_cast<int8_t*>(dir_out);
    auto vr = static_cast<int*>(var_out);
    if (bd == 8)
      cdef_dirs_kernel<<<grid, THREADS, 0, s>>>(
          static_cast<const uint8_t*>(y), H, W, d, vr);
    else
      cdef_dirs_kernel<<<grid, THREADS, 0, s>>>(
          static_cast<const uint16_t*>(y), H, W, d, vr);
  }
  return static_cast<int>(cudaGetLastError());
}

// out f32 [3, 8, R, C]: R x C = the SBs (sampled) or the 32-blocks (full);
// paths int32 [2]: blocks that took the exact-integer and the ordered path.
// H x W: the frame (or a shard's columns) that the sources, grids and
// table cover. halo: 0, or the luma columns of each neighbour on either
// side of the planes y, u, v (stride W + 2 halo luma); [xlo, xhi): the
// planes' luma columns that lie in the frame.
extern "C" int cdef_ladder_sse_launch(const void* y, const void* u,
                                      const void* v, const void* sy,
                                      const void* su, const void* sv, int H,
                                      int W, const void* dirs,
                                      const void* var, const void* skip8,
                                      int damping, int sampled, int R, int C,
                                      void* out, void* paths, int bd,
                                      int halo, int xlo, int xhi,
                                      void* stream) {
  if (R * C > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    auto b = [](const void* p) { return static_cast<const uint8_t*>(p); };
    auto h = [](const void* p) { return static_cast<const uint16_t*>(p); };
    auto d = static_cast<const int8_t*>(dirs);
    auto vr = static_cast<const int*>(var);
    auto o = static_cast<float*>(out);
    auto pc = static_cast<int*>(paths);
    if (bd == 8 && sampled)
      cdef_ladder_sse_kernel<true><<<R * C, LADDER_THREADS, 0, s>>>(
          b(y), b(u), b(v), b(sy), b(su), b(sv), H, W, d, vr, b(skip8),
          damping, R, C, o, pc, halo, xlo, xhi);
    else if (bd == 8)
      cdef_ladder_sse_kernel<false><<<R * C, LADDER_THREADS, 0, s>>>(
          b(y), b(u), b(v), b(sy), b(su), b(sv), H, W, d, vr, b(skip8),
          damping, R, C, o, pc, halo, xlo, xhi);
    else if (sampled)
      cdef_ladder_sse_kernel<true><<<R * C, LADDER_THREADS, 0, s>>>(
          h(y), h(u), h(v), h(sy), h(su), h(sv), H, W, d, vr, b(skip8),
          damping, R, C, o, pc, halo, xlo, xhi);
    else
      cdef_ladder_sse_kernel<false><<<R * C, LADDER_THREADS, 0, s>>>(
          h(y), h(u), h(v), h(sy), h(su), h(sv), H, W, d, vr, b(skip8),
          damping, R, C, o, pc, halo, xlo, xhi);
  }
  return static_cast<int>(cudaGetLastError());
}

// paths int32 [2]: (SB, plane) pairs filtered and copied (chroma counts 2).
// H x W, halo, [xlo, xhi): as cdef_ladder_sse_launch's; the outputs are
// H x W.
extern "C" int cdef_apply_launch(const void* y, const void* u, const void* v,
                                 int H, int W, const void* dirs,
                                 const void* var, const void* skip8,
                                 const void* idx, int y_pri, int y_sec,
                                 int uv_pri, int uv_sec, int damping,
                                 void* oy, void* ou, void* ov, void* paths,
                                 int bd, int halo, int xlo, int xhi,
                                 void* stream) {
  const int nsb = ((H + 63) >> 6) * ((W + 63) >> 6);
  if (nsb > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    auto b = [](const void* p) { return static_cast<const uint8_t*>(p); };
    auto ob = [](void* p) { return static_cast<uint8_t*>(p); };
    auto h = [](const void* p) { return static_cast<const uint16_t*>(p); };
    auto oh = [](void* p) { return static_cast<uint16_t*>(p); };
    auto d = static_cast<const int8_t*>(dirs);
    auto vr = static_cast<const int*>(var);
    auto ix = static_cast<const int*>(idx);
    auto pc = static_cast<int*>(paths);
    if (bd == 8)
      cdef_apply_kernel<<<nsb, THREADS, 0, s>>>(
          b(y), b(u), b(v), H, W, d, vr, b(skip8), ix, y_pri, y_sec, uv_pri,
          uv_sec, damping, ob(oy), ob(ou), ob(ov), pc, halo, xlo, xhi);
    else
      cdef_apply_kernel<<<nsb, THREADS, 0, s>>>(
          h(y), h(u), h(v), H, W, d, vr, b(skip8), ix, y_pri, y_sec, uv_pri,
          uv_sec, damping, oh(oy), oh(ou), oh(ov), pc, halo, xlo, xhi);
  }
  return static_cast<int>(cudaGetLastError());
}
