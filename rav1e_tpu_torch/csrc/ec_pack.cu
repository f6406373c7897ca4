// od_ec range coding of symbol IR, batched over tiles (CUDA, sm_90a).
//
// Replaces the Pallas TPU kernel rav1e_tpu/entropy/ec_pallas.py
// `_pack_kernel` (driven by `pack_ir`). A host pass (RecordingEncoder)
// resolves every symbol of a tile to (fl, fh, cu, cv): inverse-CDF
// bounds in Q15 plus the EC_MIN_PROB offsets. Coding is then the scalar
// recurrence over (low, rng) of the AV1 od_ec encoder:
//
//   u = fl < 2^15 ? (((rng >> 8) * (fl >> 6)) >> 1) + cu : rng
//   v =             (((rng >> 8) * (fh >> 6)) >> 1) + cv
//   low += rng - u;  rng = u - v;  d = 15 - msb(rng)
//   low <<= d;  rng <<= d
//
// Bound. Read once, the IR is 16 B a row and the bytes at most 2 B a
// row: microseconds at 3.35 TB/s, and the operations fewer still. What
// bounds a direct port is the chain: each row needs the previous row's
// rng, so one thread codes a tile at the latency of a step (~73 ns a row
// on this card, 166 ms for a 1080p keyframe's 2.28 M rows). The design
// below breaks the chain into chunks of L rows. What bounds it then is
// (a) the speculation's 128x work, issued at the card's integer rate,
// and (b) the latency of the longest chunk, walked by one thread in the
// code pass; a smaller L shortens (b) and lengthens the resolve passes'
// walks, which grow as sqrt(chunks). PERF.md has the times by pass.
//
// Design. Two facts break the chain.
//  - A row with fl < 2^15 reads only r8 = rng >> 8, one of 128 values,
//    so a chunk of rows that starts at such a row maps each start r8 to
//    an end rng and a total shift S, whatever came before.
//  - `low` is linear. With a_i = rng_i - u_i and B_i the shift before
//    row i, the stream is the big integer sum of a_i with its lowest bit
//    at bit 14 + B_i (bit 0 = the stream's first, most significant bit),
//    plus m = 2^14 - 1 at the last bit 14 + D; then the lowest 14 bits
//    are cleared, bit D is set, and the 15 + D bits are padded to bytes.
// So each tile runs six passes, each a kernel of this file:
//  0. boundaries: chunk slot k starts at the first row in [kL, (k+1)L)
//     with fl < 2^15 (slot 0 at row 0; a slot without one is empty) and
//     runs to the next chunk's start. One warp per slot (ballot); it also
//     zeroes the slot's share of the byte accumulator.
//  1. speculate: 128 threads per chunk find the chunk's end, then run
//     the rng/d recurrence from rng = r8 << 8, r8 = 128..255, and record
//     (end rng, S). The rows go through shared memory, so each is one
//     coalesced load and then a broadcast. Slot 0 is exact at r8 = 128
//     (rng = 2^15).
//  2. compose: each group of G slots composes its maps into one (128
//     lanes, one per start r8); empty slots are the identity and a
//     tile's slot 0 restarts from (2^15, 0), which keeps tiles apart.
//  3. resolve: each group walks the group maps before it, then its own
//     slots, and writes every chunk's exact start (rng, B). G is about
//     sqrt(slots), so both walks are short; both passes stage 32 maps
//     at a time in shared memory and walk them there.
//  4. code: one thread per chunk runs the full recurrence from its exact
//     start with a 24-bit window (the Pallas kernel's early flush, at the
//     chunk's global bit offset) and adds each flushed byte, then the
//     window, into the tile's accumulator with integer atomics (order
//     does not matter). Neighbouring chunks overlap by at most 16 bits.
//     The tile's last chunk adds m and writes the tile's bit count.
//  5. carry: one block per tile, through shared memory in stages of
//     8,192 slots from the tile's end. Each thread resolves its 8 slots
//     serially (wide carries included), adds its right neighbour's carry,
//     and a Hillis-Steele scan of (generate, propagate) flags carries a
//     0/1 through runs of 0xFF segments. Then the termination's rounding,
//     the bytes and the length (-1 marks a leading carry out of the
//     stream).
// The default L = 512 gives a 1080p keyframe about 4,460 chunks: about
// 570 K speculating threads, two waves of the card.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int PROB_TOP = 1 << 15;
constexpr int LANES = 128;          // start states r8 = 128..255
constexpr int CARRY_THREADS = 1024;
constexpr int TERM = (1 << 14) - 1;

struct Args {
  const int4* ir;
  const int64_t* offsets;   // null: one tile of nrows rows
  long long nrows;
  int ntiles;
  long long slots;
  int L;
  int G;
  int4* sinfo;      // per slot: (tile, k, start row or -1, end row)
  int2* maps;       // per slot x lane: (end rng, S)
  int2* gmaps;      // per group x lane: (end rng, S)
  int* gflags;      // per group: 1 = holds a chunk, 2 = holds a slot 0
  int2* cstart;     // per slot: exact (start rng, bit offset B)
  unsigned* acc;    // per tile at 2*beg + 8*t: [0] leading carry, [1+]
  int* nbits;       // per tile: 15 + D
  uint8_t* out;     // per tile at 2*beg + 8*t: the finished bytes
  int* lens;        // per tile: byte count, -1 on a leading carry
};

__device__ __forceinline__ void step(const int4 s, int& rng, int& a, int& d) {
  const int r8 = rng >> 8;
  const int u = s.x < PROB_TOP ? ((r8 * (s.x >> 6)) >> 1) + s.z : rng;
  const int v = ((r8 * (s.y >> 6)) >> 1) + s.w;
  a = rng - u;
  const int r = u - v;                 // in [4, 2^16)
  d = __clz(r) - 16;
  rng = r << d;
}

__device__ __forceinline__ int64_t off(const Args& p, int t) {
  return p.offsets ? p.offsets[t] : (t ? p.nrows : 0);
}

__device__ __forceinline__ int64_t tile_slot0(const Args& p, int t) {
  return off(p, t) / p.L + t;
}

// ---- pass 0: boundaries (one warp per slot) ---------------------------------
__global__ void __launch_bounds__(128) boundaries_kernel(Args p) {
  const long long j = blockIdx.x * 4LL + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (j >= p.slots) return;
  // the tile of slot j: the last t with tile_slot0(t) <= j
  int lo = 0, hi = p.ntiles - 1, t = -1;
  while (lo <= hi) {
    const int mid = (lo + hi) >> 1;
    if (tile_slot0(p, mid) <= j) { t = mid; lo = mid + 1; } else { hi = mid - 1; }
  }
  int4 info = make_int4(-1, 0, -1, 0);
  if (t >= 0) {
    const int64_t beg = off(p, t), end = off(p, t + 1);
    const int n = static_cast<int>(end - beg);
    const long long kslots = end / p.L - beg / p.L + 1;
    const long long k = j - tile_slot0(p, t);
    if (k < kslots) {
      info.x = t;
      info.y = static_cast<int>(k);
      // zero this slot's share of the tile's accumulator
      unsigned* acc = p.acc + 2 * beg + 8LL * t;
      const long long lim = 2LL * n + 8;
      const long long zlo = 2LL * k * p.L;
      const long long zhi = k == kslots - 1 ? lim
                            : (2LL * (k + 1) * p.L < lim ? 2LL * (k + 1) * p.L : lim);
      // zlo, zhi and the tile's base are even: two words a store
      uint2* acc2 = reinterpret_cast<uint2*>(acc);
      for (long long i = zlo / 2 + lane; i < zhi / 2; i += 32) acc2[i] = make_uint2(0u, 0u);
      if (k == 0) {
        info.z = 0;
      } else {
        const long long wlo = k * p.L;
        const long long whi = (k + 1) * p.L < n ? (k + 1) * p.L : n;
        for (long long base = wlo; base < whi; base += 32) {
          const long long i = base + lane;
          const bool hit = i < whi && p.ir[beg + i].x < PROB_TOP;
          const unsigned m = __ballot_sync(0xffffffffu, hit);
          if (m) { info.z = static_cast<int>(base + __ffs(m) - 1); break; }
        }
      }
    }
  }
  if (lane == 0) p.sinfo[j] = info;
}

// ---- pass 1: speculate (128 threads per slot) -------------------------------
// The block first finds the chunk's end (the first row at or after
// (k+1)L with fl < 2^15, or the tile's end) and records it in sinfo.w;
// then it stages the rows through shared memory with fl and fh already
// shifted (fl = 2^15 as -1), so the loop over them has a fixed count.
__global__ void __launch_bounds__(LANES) speculate_kernel(Args p) {
  __shared__ int4 rows[LANES];
  __shared__ int found;
  const long long j = blockIdx.x;
  const int4 info = p.sinfo[j];
  if (info.z < 0) return;
  const int t = info.x, k = info.y, start = info.z;
  const int64_t beg = off(p, t);
  const int n = static_cast<int>(off(p, t + 1) - beg);
  const long long stop = static_cast<long long>(k + 1) * p.L;
  if (threadIdx.x == 0) found = n;
  __syncthreads();
  for (long long base = stop; base < n; base += LANES) {
    const long long i = base + threadIdx.x;
    if (i < n && p.ir[beg + i].x < PROB_TOP) atomicMin(&found, static_cast<int>(i));
    __syncthreads();
    const bool hit = found < n;
    __syncthreads();
    if (hit) break;
  }
  const int end = found;
  if (threadIdx.x == 0) p.sinfo[j].w = end;
  int rng = (LANES + threadIdx.x) << 8, S = 0;
  for (int base = start; base < end; base += LANES) {
    __syncthreads();
    if (base + static_cast<int>(threadIdx.x) < end) {
      const int4 r = p.ir[beg + base + threadIdx.x];
      rows[threadIdx.x] = make_int4(r.x < PROB_TOP ? r.x >> 6 : -1, r.y >> 6, r.z, r.w);
    }
    __syncthreads();
    const int cnt = end - base < LANES ? end - base : LANES;
    for (int i = 0; i < cnt; ++i) {
      const int4 s = rows[i];
      const int r8 = rng >> 8;
      const int u = s.x >= 0 ? ((r8 * s.x) >> 1) + s.z : rng;
      const int r = u - (((r8 * s.y) >> 1) + s.w);
      const int d = __clz(r) - 16;
      rng = r << d;
      S += d;
    }
  }
  p.maps[j * LANES + threadIdx.x] = make_int2(rng, S);
}

// The resolve passes stage BATCH maps at a time in shared memory (all
// loads in flight at once), then walk them there.
constexpr int BATCH = 32;                        // 32 KB of maps

__device__ __forceinline__ void stage_maps(int2 (*sm)[LANES], const int2* src,
                                           long long b0, int cnt) {
#pragma unroll 8
  for (int m = 0; m < cnt; ++m) sm[m][threadIdx.x] = src[(b0 + m) * LANES + threadIdx.x];
}

// ---- pass 2: compose each group of G slots (128 lanes per group) ------------
__global__ void __launch_bounds__(LANES) compose_kernel(Args p) {
  __shared__ int2 sm[BATCH][LANES];
  __shared__ int4 si[BATCH];
  const long long g = blockIdx.x;
  const long long j0 = g * p.G;
  const long long j1 = j0 + p.G < p.slots ? j0 + p.G : p.slots;
  int rng = (LANES + threadIdx.x) << 8, S = 0, flags = 0;
  for (long long b0 = j0; b0 < j1; b0 += BATCH) {
    const int cnt = j1 - b0 < BATCH ? static_cast<int>(j1 - b0) : BATCH;
    __syncthreads();
    stage_maps(sm, p.maps, b0, cnt);
    if (threadIdx.x < cnt) si[threadIdx.x] = p.sinfo[b0 + threadIdx.x];
    __syncthreads();
    for (int m = 0; m < cnt; ++m) {
      const int4 info = si[m];
      if (info.z < 0) continue;
      flags |= 1;
      if (info.y == 0) { rng = PROB_TOP; S = 0; flags |= 2; }
      const int2 e = sm[m][(rng >> 8) - LANES];
      rng = e.x;
      S += e.y;
    }
  }
  p.gmaps[g * LANES + threadIdx.x] = make_int2(rng, S);
  if (threadIdx.x == 0) p.gflags[g] = flags;
}

// ---- pass 3: resolve every chunk's exact start (one block per group) --------
__global__ void __launch_bounds__(LANES) resolve_kernel(Args p) {
  __shared__ int2 sm[BATCH][LANES];
  __shared__ int4 si[BATCH];
  const long long g = blockIdx.x;
  int rng = PROB_TOP, S = 0;          // meaningful on thread 0
  // the state entering group g: the group maps before it
  for (long long b0 = 0; b0 < g; b0 += BATCH) {
    const int cnt = g - b0 < BATCH ? static_cast<int>(g - b0) : BATCH;
    __syncthreads();
    stage_maps(sm, p.gmaps, b0, cnt);
    if (threadIdx.x < cnt) si[threadIdx.x].x = p.gflags[b0 + threadIdx.x];
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int m = 0; m < cnt; ++m) {
        const int f = si[m].x;
        if (!(f & 1)) continue;
        const int2 e = sm[m][(rng >> 8) - LANES];
        rng = e.x;
        S = (f & 2 ? 0 : S) + e.y;
      }
    }
  }
  // then each chunk of the group
  const long long j0 = g * p.G;
  const long long j1 = j0 + p.G < p.slots ? j0 + p.G : p.slots;
  for (long long b0 = j0; b0 < j1; b0 += BATCH) {
    const int cnt = j1 - b0 < BATCH ? static_cast<int>(j1 - b0) : BATCH;
    __syncthreads();
    stage_maps(sm, p.maps, b0, cnt);
    if (threadIdx.x < cnt) si[threadIdx.x] = p.sinfo[b0 + threadIdx.x];
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int m = 0; m < cnt; ++m) {
        const int4 info = si[m];
        if (info.z < 0) continue;
        if (info.y == 0) { rng = PROB_TOP; S = 0; }
        p.cstart[b0 + m] = make_int2(rng, S);
        const int2 e = sm[m][(rng >> 8) - LANES];
        rng = e.x;
        S += e.y;
      }
    }
  }
}

// ---- pass 4: code every chunk into the accumulator (one thread each) --------
// The 32 threads of a warp walk 32 chunks, L rows apart, so on nearly
// every row some thread of the warp misses L1; the rows are therefore
// loaded a group of R ahead into registers.
constexpr int R = 16;

__device__ __forceinline__ void load_rows(int4 (&b)[R], const int4* ir,
                                          int from, int end) {
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (from + r < end) b[r] = ir[from + r];
}

__global__ void __launch_bounds__(32) code_kernel(Args p) {
  const long long j = blockIdx.x * 32LL + threadIdx.x;
  if (j >= p.slots) return;
  const int4 info = p.sinfo[j];
  if (info.z < 0) return;
  const int t = info.x, start = info.z, end = info.w;
  const int64_t beg = off(p, t);
  const int n = static_cast<int>(off(p, t + 1) - beg);
  unsigned* acc = p.acc + 2 * beg + 8LL * t + 1;   // acc[-1]: leading carry
  const int2 cs = p.cstart[j];
  int rng = cs.x, bits = 15 + cs.y;
  int flushed = ((cs.y - 1) >> 3) << 3;           // floor to a byte, may be -8
  int low = 0;
  const int4* ir = p.ir + beg;
  int4 cur[R], nxt[R];
  load_rows(cur, ir, start, end);
  for (int i0 = start; i0 < end; i0 += R) {
    load_rows(nxt, ir, i0 + R, end);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (i0 + r >= end) break;
      int a, d;
      step(cur[r], rng, a, d);
      low += a;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int window = bits - flushed;
        if (window + d >= 24) {
          const int keep = window - 8;
          atomicAdd(acc + (flushed >> 3), static_cast<unsigned>(low >> keep));
          low &= (1 << keep) - 1;
          flushed += 8;
        }
      }
      low <<= d;
      bits += d;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) cur[r] = nxt[r];
  }
  const bool last = end == n;
  if (last) low += TERM;
  // the window [flushed, bits), padded to a byte, carry bits above it
  const int pad = (8 - (bits & 7)) & 7;
  const unsigned long long val = static_cast<unsigned long long>(low) << pad;
  const int nbw = (bits + pad - flushed) >> 3;
  for (int b = 0; b < nbw; ++b) {
    const int sh = 8 * (nbw - 1 - b);
    const unsigned long long x = b == 0 ? val >> sh : (val >> sh) & 255u;
    if (x) atomicAdd(acc + (flushed >> 3) + b, static_cast<unsigned>(x));
  }
  if (last) p.nbits[t] = bits;
}

// ---- pass 5: carries, termination, bytes (one block per tile) ---------------
// The tile's accumulator goes through shared memory in stages of STAGE
// slots, from its end (least significant) to its start; the carry out of
// a stage enters the next one at its right end. Within a stage, thread s
// owns CSEG contiguous slots (the rightmost CSEG belong to the last
// thread): it resolves them serially with carries of any width, adds its
// right neighbour's carry-out, and a Hillis-Steele scan of (generate,
// propagate) flags brings the remaining 0/1 carry through runs of 0xFF
// segments. A segment's carry-out is below 2^25 (each slot is below
// 2^32), so a segment of CSEG >= 4 bytes that takes it overflows by at
// most 1; only the tile's first segment may be shorter, and a carry out
// of it is a leading carry anyway.
constexpr int CSEG = 8;
constexpr int STAGE = CARRY_THREADS * CSEG;      // 8192 slots, 36 KB padded

__global__ void __launch_bounds__(CARRY_THREADS) carry_kernel(Args p) {
  __shared__ unsigned sh[CARRY_THREADS * (CSEG + 1)];   // padded: no conflicts
  __shared__ unsigned long long cout[CARRY_THREADS];
  __shared__ unsigned char gen[CARRY_THREADS], prop[CARRY_THREADS];
  __shared__ unsigned long long stage_carry;
  const int t = blockIdx.x;
  const int s = threadIdx.x;
  const int64_t beg = off(p, t);
  const unsigned* acc = p.acc + 2 * beg + 8LL * t;
  uint8_t* out = p.out + 2 * beg + 8LL * t;
  const int nbits = p.nbits[t];
  const int nb = ((nbits + 7) >> 3) + 1;           // slot 0: leading carry
  if (s == 0) stage_carry = 0;
  // each stage's slots are loaded into registers while the stage before
  // it is resolved
  unsigned pre[CSEG];
  auto fetch = [&](int hi) {
#pragma unroll
    for (int i = 0; i < CSEG; ++i) {
      const int x = hi - STAGE + s + i * CARRY_THREADS;
      pre[i] = x >= 0 ? acc[x] : 0u;
    }
  };
  fetch(nb);
  for (int hi = nb; hi > 0; hi -= STAGE) {
    const int lo = hi - STAGE > 0 ? hi - STAGE : 0;
    const int base = hi - STAGE;                   // slot of sh's element 0
    __syncthreads();
#pragma unroll
    for (int i = 0; i < CSEG; ++i) {
      const int r = s + i * CARRY_THREADS;
      sh[(r / CSEG) * (CSEG + 1) + r % CSEG] = pre[i];
    }
    if (lo > 0) fetch(lo);
    const unsigned long long cin_stage = stage_carry;
    __syncthreads();
    // my segment: slots [a, a + CSEG) of the stage, those >= lo
    unsigned* seg = sh + s * (CSEG + 1);
    const int a = base + s * CSEG;
    const int c0 = lo > a ? lo - a : 0;            // first slot of mine in use
    const bool active = c0 < CSEG;
    // 1. the segment alone
    unsigned long long c = 0;
    if (active) {
      for (int q = CSEG - 1; q >= c0; --q) {
        const unsigned long long x = seg[q] + c;
        seg[q] = static_cast<unsigned>(x & 255u);
        c = x >> 8;
      }
    }
    cout[s] = c;
    __syncthreads();
    // 2. the right neighbour's carry (the previous stage's for the last)
    unsigned char g = 0, pr = 1;
    if (active) {
      c = s + 1 < CARRY_THREADS ? cout[s + 1] : cin_stage;
      for (int q = CSEG - 1; q >= c0 && c; --q) {
        const unsigned long long x = seg[q] + c;
        seg[q] = static_cast<unsigned>(x & 255u);
        c = x >> 8;
      }
      g = c ? 1 : 0;
      for (int q = c0; q < CSEG && pr; ++q) pr = seg[q] == 255u;
    }
    gen[s] = g;
    prop[s] = pr;
    __syncthreads();
    // 3. suffix scan: gen[s] becomes the 0/1 carry out of segments [s, end)
    for (int dist = 1; dist < CARRY_THREADS; dist <<= 1) {
      unsigned char g2 = 0, p2 = 1;
      if (s + dist < CARRY_THREADS) { g2 = gen[s + dist]; p2 = prop[s + dist]; }
      __syncthreads();
      gen[s] = gen[s] | (prop[s] & g2);
      prop[s] = prop[s] & p2;
      __syncthreads();
    }
    // 4. the 0/1 carry into each segment
    if (active && s + 1 < CARRY_THREADS && gen[s + 1]) {
      for (int q = CSEG - 1; q >= c0; --q) {
        const unsigned x = seg[q] + 1u;
        seg[q] = x & 255u;
        if (x < 256u) break;
      }
    }
    // the termination, in the last thread's slots of the first stage:
    // clear the lowest 14 bits, set the 15th
    if (hi == nb && s == CARRY_THREADS - 1) {
      for (int q = nbits - 15; q < nbits; ++q) {
        const int r = (q >> 3) + 1 - base;
        unsigned* w = sh + (r / CSEG) * (CSEG + 1) + r % CSEG;
        const unsigned bit = 1u << (7 - (q & 7));
        *w = q == nbits - 15 ? (*w | bit) : (*w & ~bit);
      }
    }
    // the carry into the next stage, from its first segment in use
    const int first = (lo - base) / CSEG;
    if (s == first) {
      stage_carry = cout[s] + gen[s];
      if (lo == 0)   // the tile's start: slot 0 and the carry out of it
        p.lens[t] = stage_carry != 0 || seg[c0] != 0 ? -1 : nb - 1;
    }
    __syncthreads();
    for (int r = s; r < STAGE; r += CARRY_THREADS)
      if (base + r >= lo && base + r >= 1)
        out[base + r - 1] = static_cast<uint8_t>(sh[(r / CSEG) * (CSEG + 1) + r % CSEG]);
  }
}

}  // namespace

// ir: int32 [N, 4] (16-byte aligned); offsets: int64 [ntiles + 1] row
// offsets, or null for one tile of nrows rows; slots = N / L + ntiles chunk slots of L rows; G slots per
// resolve group. Work buffers (int32 elements): sinfo [slots, 4], maps
// [slots, 128, 2], gmaps [ceil(slots / G), 128, 2], gflags
// [ceil(slots / G)], cstart [slots, 2], acc [2N + 8 ntiles], nbits
// [ntiles]. Outputs: out uint8 [2N + 8 ntiles] (tile t's bytes at
// 2*offsets[t] + 8t), lens int32 [ntiles]. pass = -1 launches the six
// passes on `stream`, pass = 0..5 that pass alone. Returns the first
// non-zero cudaGetLastError() after a launch, else 0.
extern "C" int ec_pack_launch(const void* ir, const void* offsets,
                              long long nrows, int ntiles, long long slots,
                              int L, int G,
                              void* sinfo, void* maps, void* gmaps,
                              void* gflags, void* cstart, void* acc,
                              void* nbits, void* out, void* lens,
                              void* stream, int pass) {
  if (ntiles <= 0 || slots <= 0) return static_cast<int>(cudaGetLastError());
  Args p{static_cast<const int4*>(ir), static_cast<const int64_t*>(offsets),
         nrows, ntiles, slots, L, G,
         static_cast<int4*>(sinfo), static_cast<int2*>(maps),
         static_cast<int2*>(gmaps), static_cast<int*>(gflags),
         static_cast<int2*>(cstart), static_cast<unsigned*>(acc),
         static_cast<int*>(nbits), static_cast<uint8_t*>(out),
         static_cast<int*>(lens)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long ngroups = (slots + G - 1) / G;
  for (int q = 0; q < 6; ++q) {
    if (pass >= 0 && q != pass) continue;
    switch (q) {
      case 0: boundaries_kernel<<<static_cast<unsigned>((slots + 3) / 4), 128, 0, st>>>(p); break;
      case 1: speculate_kernel<<<static_cast<unsigned>(slots), LANES, 0, st>>>(p); break;
      case 2: compose_kernel<<<static_cast<unsigned>(ngroups), LANES, 0, st>>>(p); break;
      case 3: resolve_kernel<<<static_cast<unsigned>(ngroups), LANES, 0, st>>>(p); break;
      case 4: code_kernel<<<static_cast<unsigned>((slots + 31) / 32), 32, 0, st>>>(p); break;
      case 5: carry_kernel<<<ntiles, CARRY_THREADS, 0, st>>>(p); break;
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
