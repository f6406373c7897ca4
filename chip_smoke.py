#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rav1e_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:
  1. the card (nvidia-smi name + power limit), torch and CUDA versions;
  2. the build of csrc/ec_pack.cu, csrc/gather_patches.cu and
     csrc/cdef.cu with nvcc for sm_90a, one nvcc process each, and of
     the C++ tile packer csrc/packer.cpp with g++, all started together;
  3. the od_ec kernels against their plain version: a 4-tile batch (three
     random adapting-CDF streams of about 20k IR rows, one empty tile) in
     one call at chunk lengths L = 16, 100 and the default: chunk starts
     equal to chunk_starts, finished bytes equal to pack_ir_plain +
     finish and to the port's ECEncoder; and a stream whose carry runs
     back through some 10,000 0xFF bytes;
  4. the empty kernel's time (the fixed cost of a launch, printed beside
     the bounds); the patch-gather kernel against its plain version at
     the 1080p P frame's shapes (B = 2040; P = 43, 39 from the padded
     luma plane, P = 23 from a padded chroma plane; the 64x64 merge's
     B = 510, P = 71 luma and P = 39 chroma; and refine16's B = 8160
     per-16 patches, P = 27 luma and P = 15 chroma), starts out of range
     included, through gather_patches and through gather_patches_many
     (every shape in one mixed group): max |err| 0; kernel, plain and
     indexing-call times; then a speed-6 1080p P frame's gathers
     replayed as the main path groups them (SPEED6_P_GROUPS, one launch
     a group) on random planes of the frame's shapes: equal to the plain
     version; kernel, plain and indexing ms, and the byte bound summed
     over the launches (each launch reads a plane's covered elements
     once);
  5. the speed-10 keyframe at 1920x1088 on cuda, once to warm and once
     timed: stage times, the ec_pack launches, the tile's IR (the C++
     packer's) coded again by pack_ir_plain with identical bytes, and
     the ec kernels' device
     time (CUDA events) at L = 256, 512, 1024, 2048 with identical bytes
     at each, and per pass at the default L = 512;
  6. the three CDEF kernels (cdef_dirs, cdef_ladder_sse, cdef_apply;
     the last two one launch a frame for the three planes) against their
     plain versions on phase 5's deblocked recon with its skip map (the
     sampled branch) and on it cut to 1920x1056 (the full branch), as
     contiguous uint8 planes: dir, var, the SSE tables and the applied
     planes (ladder winners, every entry and a uniform strength) exactly
     equal; the blocks on each path (the table's exact-integer and
     ordered paths, the apply's filtered and copied (SB, plane) pairs);
     kernel and plain device ms (mean of 3; cdef_dirs' kernel 20) and
     the bound; then noise at
     q 255 (256x192 sampled, 160x96 full), where a cell's SSE passes
     2^24 and the f32 order decides: the tables of kernel (blocks on
     the ordered path) and plain version, and the search's index and
     planes on cuda and on cpu, exactly equal; cdef_dirs on extreme
     blocks (all 0: every cost at the int32 bound; all 255; a ramp and
     stripes along each direction), from a misaligned base, and at
     1928x1088 (8 px past a multiple of 64), equal to its plain version;
  7. the port on cuda vs the port on cpu, keyframe at 256x192, speed 10:
     level differences (|d| = 1 at < 1e-4 of the coefficients allowed,
     from the f32 forward transform) and identical recon wherever no
     differing level is upstream;
  8-9. encode_gop_tpu on cuda vs on cpu, KEY + 1 P: 512x384 at speed 10,
     and 256x192 at speed 8 with cdef (0, 0, 0, 0, 3): the share of
     blocks whose (mv, skip) agree (>= 99%), levels by phase 7's rule,
     identical CDEF index maps and packets where every MV, skip and level
     agrees;
  10. the same at speed 7 with cdef, on content with sharp squares that
     makes blocks split: every level, split map, MV field, skip, CDEF map
     and packet identical;
  11. encode_pframe_tpu(planes, ref) with the reference's defaults (split
     RDO with refine16, 16-px search, subpel) at 256x192 on cuda vs cpu:
     every decision, level, the recon and the packet identical; the
     gather launches at refine16's patch sizes;
  12-13. encode_gop_tpu at q 100 at 1920x544 (the depth cut, to keep
     the run short): KEY + 1 P at speed 10 (no split, no CDEF: the P
     frame takes write_inter_tile_fast), then KEY + 2 P at speed 7
     with cdef (0, 0, 0, 0, 3), run as a user calls it (the C++ packer,
     the keyframe's host half and each P frame's fetch + pack on worker
     threads), every kernel's count set to 0 just before and read just
     after: the GOP's wall time, per-frame stage times, packet sizes,
     shares of split 32-blocks and the packer call each frame took;
     every frame launched each kernel that serves it (the main thread's
     kernels counted per device half, ec_pack once a tile); every tile's
     IR coded again by pack_ir_plain gives the packet's bytes; recon
     within 0..255; each tile's ec kernel time at L = 256, 512, 1024 and
     its per-pass times;
  14. the default keyframe (speed 6: 13 luma modes on the 2i+j schedule,
     CfL, the quads' TX type search, the 16->8 split) with cdef
     (0, 0, 0, 0, 3) at 256x192 on cuda vs on cpu, twice: on synth
     content with squares, a straight edge and chroma that follows luma
     (the split8 gate off) and on it with an 8-px checkerboard region
     (the gate on; the 8..16 px band printed): every level, recon,
     mode map, CfL alpha, TX type, split and 16->8 map, CDEF index, the
     filtered recon and the packet identical; the blocks that took CfL, a
     directional mode, each TX type and the 16->8 split counted;
  14b. a speed-6 KEY + 1 P GOP with cdef at 256x192 on cuda vs on cpu,
     on panning content with 8x8 squares, a flat SB and new flat 32x32
     squares: every fetched decision (MVs, skips, levels, split, 16->8,
     64x64 and intra maps, per-8 skips, CDEF map), the recon and the
     packets identical; the P frame must split a quad 16->8, merge a
     64x64 SB and take an intra block (SATD ranks every descent);
  15. the main path: encode_gop_tpu(frames, 100, speed=6, cdef=(0, 0, 0,
     0, 3)), the preset the reference's bench times, KEY + 2 P at
     1920x1088 on synth(1920, 1088, n=3) (the keyframe is phase 5's
     frame), checked as phases 12-13 (each frame with CDEF launches
     cdef_ladder_sse and cdef_apply once); the packets must be the JAX
     package's [86204, 13929, 5602] bytes (their SHA-256 printed); each
     P frame's shares of split, 16->8, merged and intra blocks; each P
     frame launched exactly phase 4's replayed gather groups, fewer than
     13 launches (the count when each gather was its own launch);
  15b. each frame of phase 15 packed again from the same decisions by
     the C++ packer and by the Python TileWriter + RecordingEncoder
     (use_native=False): the IRs equal row for row, the kernel's bytes
     on both equal pack_ir_plain + finish's; both walks' times;
  16. a speed-6 keyframe on a 1920x128 frame with phase 14's
     checkerboard every 256 px (the split8 gate on, quads split 16->8 at
     full width; the depth cut to keep the run short), counted as
     phase 15.

Phases 5, 7-16 print the packer call (NativeTileWriter method) each
frame took. Prints a kernels JSON line (launches: phases 15, 13 and 16
together, and each path's own count, every count set to 0 just before
its path; the gather's ms, bound and plain and indexing ms are phase
4's replayed speed-6 P frame, with its launches a P frame; the CDEF
kernels' launches per frame of those paths and their ms per 1080p
frame), then, as the last line, {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, printing no result, without CUDA or without the
rav1e_tpu_torch package beside it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12     # non-tensor float32 peak (no int32 entry)
# integer instructions a second at most: 132 SMs x 4 schedulers x 32
# lanes x 1.98 GHz boost, one warp instruction a scheduler a clock (the
# float32 peak above counts each of these FMA lanes as 2 operations).
# Integer work issues on the INT32 pipe (64 lanes a SM) and on the FMA
# pipe (IMAD and its forms) together, so 64 lanes a SM is no ceiling.
H100_INT_OPS_PER_S = H100_F32_OPS_PER_S / 2
# the JAX package's speed-6 KEY + 2 P GOP of synth(1920, 1088, n=3) at
# q 100 with cdef (0, 0, 0, 0, 3), on the CPU (ROADMAP.md, Recent)
GOP6_BYTES = [86204, 13929, 5602]
CDEF_SPEED8 = (0, 0, 0, 0, 3)  # the speed-7/8 paths' cdef argument


def synth(w, h, n=1, seed=3):
    """The synthetic content family of bench.py's synth_1080p."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 100 + 50 * np.sin(xx / 37) + 40 * np.cos(yy / 23)
    noise = rng.normal(0, 5, (h, w))
    frames = []
    for t in range(n):
        y = (base + 20 * np.sin((xx + 3 * t) / 29) + noise).clip(0, 255)
        u = (128 + 30 * np.sin((xx[::2, ::2] + 2 * t) / 31)).clip(0, 255)
        v = (128 - 25 * np.cos((yy[::2, ::2] + t) / 27)).clip(0, 255)
        frames.append([y.astype(np.uint8), u.astype(np.uint8),
                       v.astype(np.uint8)])
    return frames


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


class PackerCalls:
    """While entered, keeps every tile the C++ packer codes (from any
    thread): (the NativeTileWriter method that walked it, the writer's
    device, its IR on the host, its bytes)."""

    METHODS = ("write_intra_tile_fast", "write_inter_tile_fast",
               "write_inter_tile_fast2", "write_tile")

    def __init__(self, native):
        self.W = native.NativeTileWriter
        self.got = []

    def __enter__(self):
        W, got = self.W, self.got
        self.saved = {m: W.__dict__[m] for m in self.METHODS + ("code",)}

        def walking(m, f):
            def walk(w, *a, **k):
                w.walked = m
                return f(w, *a, **k)
            return walk

        for m in self.METHODS:
            setattr(W, m, walking(m, self.saved[m]))
        code = self.saved["code"]

        def coding(w, ir):
            tile = code(w, ir)
            got.append((w.walked, str(w.device), ir.clone(), tile))
            return tile

        W.code = coding
        return self

    def __exit__(self, *exc):
        for m, f in self.saved.items():
            setattr(self.W, m, f)
        return False

    def by_packet(self, pkts, device=None):
        """The kept (method, device, IR, tile) of each packet (a tile is
        the end of its packet), None where no kept tile ends it."""
        kept = [g for g in self.got if device is None or g[1] == device]
        return [next((g for g in kept if p.endswith(g[3])), None)
                for p in pkts]

    def methods(self, pkts, device=None):
        return [None if g is None else g[0]
                for g in self.by_packet(pkts, device)]


def random_stream(seed: int, iters: int):
    """Adapting-CDF symbols with literals and bools mixed in, coded by
    ECEncoder and recorded by RecordingEncoder. Returns (IR, bytes)."""
    from rav1e_tpu_torch.entropy.ec import PROB_TOP, ECEncoder
    from rav1e_tpu_torch.entropy.ec_cuda import RecordingEncoder
    rng = np.random.default_rng(seed)

    def make_cdf(n):
        cuts = sorted(rng.integers(1, PROB_TOP, n - 1).tolist(),
                      reverse=True)
        return list(cuts) + [0, 0]

    cdfs = [make_cdf(n) for n in (2, 3, 5, 8, 13, 16)]
    cdfs2 = [list(c) for c in cdfs]
    enc, rec = ECEncoder(), RecordingEncoder()
    for i in range(iters):
        which = int(rng.integers(0, len(cdfs)))
        s = int(rng.integers(0, len(cdfs[which]) - 2))
        enc.encode_symbol(s, cdfs[which])
        rec.encode_symbol(s, cdfs2[which])
        if i % 7 == 0:
            v = int(rng.integers(0, 256))
            enc.encode_literal(v, 8)
            rec.encode_literal(v, 8)
        if i % 11 == 0:
            b = int(rng.integers(0, 2))
            f = int(rng.integers(64, PROB_TOP - 64))
            enc.encode_bool(b, f)
            rec.encode_bool(b, f)
    return rec.ir_tensor(), enc.done()


def carry_stream(steps: int):
    """Bools steered to keep the coder's interval around 1/2, so `low`
    runs to 0x7FFF...; then one bool lifts it above 1/2, and the carry
    runs back through every 0xFF byte. Returns (IR, ECEncoder bytes)."""
    from rav1e_tpu_torch.entropy.ec import PROB_TOP, ECEncoder
    from rav1e_tpu_torch.entropy.ec_cuda import RecordingEncoder
    enc, rec = ECEncoder(), RecordingEncoder()
    low, rng, nbits = 0, PROB_TOP, 15

    def bool_(val, f):
        nonlocal low, rng, nbits
        v = (((rng >> 8) * (f >> 6)) >> 1) + 4
        low, rng = (low + rng - v, v) if val else (low, rng - v)
        d = 16 - rng.bit_length()
        low, rng, nbits = low << d, rng << d, nbits + d
        enc.encode_bool(val, f)
        rec.encode_bool(val, f)

    for _ in range(steps):
        v = (((rng >> 8) * (1 << 8)) >> 1) + 4
        bool_(int(low + rng - v <= 1 << (nbits - 1)), 1 << 14)
    bool_(1, 64)
    return rec.ir_tensor(), enc.done()


def kernel_vs_plain(torch, ec):
    """Phase 3."""
    streams = [random_stream(s, 9000) for s in (11, 12, 13)]
    streams.append((torch.zeros((0, 4), dtype=torch.int32),
                    ec.finish([], 0, 15, 0)))
    from rav1e_tpu_torch.entropy.ec import ECEncoder
    if streams[-1][1] != ECEncoder().done():
        fail("empty-tile termination differs from ECEncoder")
    irs = [s[0] for s in streams]
    plain = [ec.finish(c.tolist(), *st[:3].tolist())
             for c, st in map(ec.pack_ir_plain, irs)]
    offs = [0]
    for ir in irs:
        offs.append(offs[-1] + ir.shape[0])
    ir_all = torch.cat(irs).cuda()
    off_t = torch.tensor(offs, dtype=torch.int64).cuda()
    for L in (16, 100, ec.CHUNK_ROWS):
        work: dict = {}
        out, lens = ec.pack_ir(ir_all, off_t, chunk_rows=L, work=work)
        torch.cuda.synchronize()
        tiles = ec.fetch_tiles(out, lens, offs)
        sinfo = work["sinfo"].cpu()
        counts = []
        for t, ir in enumerate(irs):
            got = sinfo[sinfo[:, 0] == t, 2]
            want = ec.chunk_starts(ir, L)
            if not torch.equal(got[got >= 0].long(), want[want >= 0]):
                fail(f"L = {L}, tile {t}: the kernel's chunk starts differ "
                     "from chunk_starts")
            counts.append(int((got >= 0).sum()))
            err = byte_err(tiles[t], plain[t])
            if err or tiles[t] != streams[t][1]:
                fail(f"L = {L}, tile {t}: kernel bytes differ from "
                     f"pack_ir_plain + finish or ECEncoder (max |err| "
                     f"{err})")
        print(f"# kernel vs plain at L = {L}: 4 tiles in one launch, IR "
              f"rows {[int(ir.shape[0]) for ir in irs]}, chunks {counts}: "
              "bytes identical to pack_ir_plain + finish and ECEncoder "
              "(max |err| 0)", flush=True)
    ir_c, ref_c = carry_stream(80000)
    for L in (16, ec.CHUNK_ROWS):
        out, lens = ec.pack_ir(ir_c.cuda(), chunk_rows=L)
        if ec.fetch_tiles(out, lens, [0, ir_c.shape[0]])[0] != ref_c:
            fail(f"L = {L}: the carry stream's kernel bytes differ from "
                 "ECEncoder")
    print(f"# carry through {len(ref_c)} bytes of 0x7FFF...F ({ir_c.shape[0]}"
          " IR rows, two stages of the carry pass) at L = 16 and the "
          "default: bytes identical", flush=True)


def byte_err(a: bytes, b: bytes) -> int:
    """Largest |a[i] - b[i]|; 256 if the lengths differ."""
    if len(a) != len(b):
        return 256
    return max((abs(x - y) for x, y in zip(a, b)), default=0)


def time_cuda(torch, fn, reps: int, hold: bool = True) -> float:
    """Mean ms of fn() over reps launches, by CUDA events. hold=True
    first queues a spin kernel of about 50 ms, so every launch is queued
    before the first one runs and the events time the device alone;
    hold=False times the launches as the host paces them."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(100_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def slice_1080p(torch, ec, native, ti, floor_ms):
    """Phase 5. Returns (the kernels-line entry of the od_ec kernel, the
    timed run's KeyframeDevice, the planes)."""
    planes = synth(1920, 1088)[0]
    with PackerCalls(native) as calls:
        t0 = time.perf_counter()
        pkt_w, _ = ti.encode_keyframe_tpu(planes, 100, speed=10,
                                          device="cuda")
        print(f"# 1080p warm run {time.perf_counter() - t0:.3f} s; packer "
              f"call {calls.methods([pkt_w])}", flush=True)
    ir = calls.got[0][2]
    timings: dict = {}
    kds = []
    orig_an = ti.analyze_keyframe

    def keeping_analyze(*a, **k):
        kds.append(orig_an(*a, **k))
        return kds[-1]

    ti.analyze_keyframe = keeping_analyze
    try:
        ec.pack_ir.launches = 0
        t0 = time.perf_counter()
        pkt, rec = ti.encode_keyframe_tpu(planes, 100, speed=10,
                                          device="cuda", timings=timings)
        wall = time.perf_counter() - t0
        launches = ec.pack_ir.launches
    finally:
        ti.analyze_keyframe = orig_an
    if launches < 1:
        fail("the 1080p keyframe did not launch the od_ec kernel")
    if pkt != pkt_w:
        fail("the two 1080p runs gave different packets")
    shapes = [r.shape for r in rec]
    if shapes != [p.shape for p in planes] or any(
            r.min() < 0 or r.max() > 255 for r in rec):
        fail(f"1080p recon has shapes {shapes} or leaves 0..255")
    print(f"# 1080p keyframe (speed 10, q 100, cuda): {len(pkt)} bytes in "
          f"{wall:.3f} s; stages (s): "
          + json.dumps({k: round(v, 4) for k, v in timings.items()}),
          flush=True)

    n = int(ir.shape[0])
    ir_d = ir.cuda()
    t0 = time.perf_counter()
    c_p, st_p = ec.pack_ir_plain(ir)
    plain = ec.finish(c_p.tolist(), *st_p[:3].tolist())
    plain_ms = (time.perf_counter() - t0) * 1e3
    if plain not in pkt:
        fail("1080p tile: the plain bytes are not the packet's tile")
    k = int(st_p[3])
    ms = {}
    for L in (256, 512, ec.CHUNK_ROWS, 2048):
        got = {}

        def run():
            got["r"] = ec.pack_ir(ir_d, chunk_rows=L)

        ms[L] = time_cuda(torch, run, 3)
        err = byte_err(ec.fetch_tiles(*got["r"], [0, n])[0], plain)
        if err:
            fail(f"1080p tile, L = {L}: kernel and plain bytes differ "
                 f"(max |err| {err})")
    passes = pass_times(torch, ec, ir_d)
    nbytes = 16 * n + 4 * k + 16 + 16     # IR, chunks, state, offsets
    ops = 24 * n + 5 * k                  # integer ops of the recurrence
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3
    kms = ms[ec.CHUNK_ROWS]
    print(f"# ec kernel, 1080p keyframe tile: {n} symbols, {len(plain)} "
          f"bytes, {kms:.4f} ms at L = {ec.CHUNK_ROWS} ({n / kms * 1e3:.4g} "
          f"symbols/s); by L: {json.dumps({L: round(t, 4) for L, t in ms.items()})}"
          f"; passes (ms): {json.dumps(passes)}; plain {plain_ms:.1f} ms, "
          f"bound {max(t_bytes, t_ops):.5f} ms (the empty launch "
          f"{floor_ms:.5f} ms), launches {launches}", flush=True)
    return {"name": "ec_pack", "route": "cuda",
            "source": "rav1e_tpu_torch/csrc/ec_pack.cu",
            "replaces": "rav1e_tpu/entropy/ec_pallas.py:82",
            "launches": launches, "max_abs_err": err, "ms": kms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}, kds[0], planes


def pass_times(torch, ec, ir_d, reps: int = 3) -> dict:
    """Device ms of each pass of the od_ec kernels on one tile (default
    chunk length), by CUDA events around each pass, mean of reps calls
    queued behind a spin kernel."""
    ec.pack_ir(ir_d)
    torch.cuda.synchronize()
    evs = [[torch.cuda.Event(enable_timing=True)
            for _ in range(len(ec.PASSES) + 1)] for _ in range(reps)]
    torch.cuda._sleep(100_000_000)
    for ev in evs:
        ec.pack_ir(ir_d, events=ev)
    torch.cuda.synchronize()
    return {name: round(sum(ev[i].elapsed_time(ev[i + 1])
                            for ev in evs) / reps, 5)
            for i, name in enumerate(ec.PASSES)}


# How the CDEF bounds count: one operation is one integer instruction a
# pixel; an add fused with a min or a max (VIADDMNMX), a three-input min,
# max (VIMNMX3) or add (IADD3) and a multiply-add (IMAD) count one each.
# A tap outside the frame is -2^14 in a tile, so it constrains to 0 and
# leaves the clamp window with no test. Per tap: its difference d, |d|
# and sign(d) times its weight (3, shared by every strength that reads
# the tap); per tap and strength S: |d| >> shift, S minus that fused
# with the max against 0, the min with |d|, the multiply-add into the
# sum (4). Per filtered pixel: the clamp window over the pixel and its 4
# primary taps (two VIMNMX3 each way, 4), 8 more with the secondary taps;
# the round and clip, y = min(max(x + ((8 + s + (s >> 31)) >> 4), lo),
# hi) (5), and one more add where both a primary and a secondary sum
# enter s. Loads are not counted: they are bytes.


def _pri_adj(torch, cd, var, pri, chroma: bool):
    """The primary strength per 8x8 unit (var: the per-unit grid) after
    luma's variance adjustment (pri: the unadjusted strength, an int or
    a grid)."""
    if chroma:
        return torch.full_like(var, pri) if isinstance(pri, int) else pri
    v = var.long()
    vs = torch.where((v >> 6) > 0,
                     torch.clamp(cd._msb(v >> 6).long(), max=12), 0)
    return torch.where(v > 0, (pri * (4 + vs) + 8) >> 4, 0)


def _distinct(torch, vals, keep):
    """Per unit, how many distinct values vals [K, ...] takes where keep."""
    v = torch.where(keep, vals, -1).sort(0).values
    new = torch.ones_like(keep)
    new[1:] = v[1:] != v[:-1]
    return (new & (v >= 0)).sum(0)


def _unit_px(torch, mask, units, n):
    """Pixels of each n x n unit that mask covers (all if None)."""
    if mask is None:
        return torch.full(units, n * n, dtype=torch.int64)
    return mask.reshape(units[0], n, units[1], n).sum((1, 3)).long().cpu()


def _cdef_ops(torch, cd, var, skip8, chroma: bool, entries):
    """Integer operations of one CDEF pass (cdef_apply) on these inputs,
    counted as set out above: a pixel of a skipped unit, or of a unit
    whose pair is (0, 0) after luma's adjustment, is copied (bytes only);
    a filtered pixel takes its primary taps where the adjusted primary
    strength is > 0 and its secondary taps where the secondary strength
    is > 0 (7 a tap: 3 + 4), its window and its round and clip; luma's
    adjustment adds 6 a filtered unit. entries: the ladder index per 8x8
    luma unit."""
    lad = torch.tensor(cd.CDEF_LADDER, dtype=torch.int64, device=var.device)
    k = entries.long()
    pa = _pri_adj(torch, cd, var, lad[k, 2 if chroma else 0], chroma)
    sec = lad[k, 3 if chroma else 1]
    act = (~skip8.bool()) & ((pa > 0) | (sec > 0))
    per = (4 + 8 * (sec > 0) + 28 * (pa > 0) + 56 * (sec > 0) + 5
           + ((pa > 0) & (sec > 0)).long())
    ops = int(torch.where(act, per, 0).sum()) * (16 if chroma else 64)
    return ops if chroma else ops + 6 * int(act.sum())


def _cdef_ladder_ops(torch, cd, var, skip8, chroma: bool, mask):
    """Integer operations of the 8-entry ladder SSE (cdef_ladder_sse) on
    these inputs: the least work the function needs, counted as set out
    above, with each piece of work that entries share done once. Per
    pixel of a unit where some entry filters: the shared tap work of the
    primary taps (where an entry's adjusted primary strength is > 0) and
    of the secondary taps (where one has a secondary strength), the
    window (4, and 8 more with secondary taps); each distinct adjusted
    primary strength's sum over the 4 primary taps (16) and each distinct
    secondary strength's over the 8 secondary taps (32); each distinct
    pair's round and clip and its error against the source (1); one
    multiply-add into each filtering entry's squared-error total. Every
    pixel: the unfiltered error and its multiply-add (2). Luma's
    adjustment: 4 a unit that is not skipped and 2 a unit and entry.
    mask: the pixels the table covers (all if None)."""
    n = 4 if chroma else 8
    units = tuple(skip8.shape)
    lad = cd.CDEF_LADDER
    keep = ~skip8.bool()
    pa = torch.stack([_pri_adj(torch, cd, var, e[2 if chroma else 0], chroma)
                      for e in lad]).long()
    sec = torch.tensor([e[3 if chroma else 1] for e in lad],
                       device=var.device)[:, None, None].expand_as(pa)
    act = keep & ((pa > 0) | (sec > 0))
    pri_on = act & (pa > 0)
    sec_on = act & (sec > 0)
    pairs = _distinct(torch, pa * 8 + sec, act)
    both = _distinct(torch, pa * 8 + sec, pri_on & sec_on)
    per_px = (12 * pri_on.any(0) + (24 + 8) * sec_on.any(0)
              + 4 * act.any(0)
              + 16 * _distinct(torch, pa, pri_on)
              + 32 * _distinct(torch, sec, sec_on)
              + 6 * pairs + both + act.sum(0) + 2)
    px = _unit_px(torch, mask, units, n)
    ops = int((per_px.long().cpu() * px).sum())
    if not chroma:
        ops += int(((px > 0) & keep.cpu()).sum()) * (4 + 2 * len(lad))
    return ops


def _sampled_mask(torch, h, w, b, dev):
    """The pixels of the TL and BR b x b quadrant of each 2b x 2b SB."""
    r = (torch.arange(h, device=dev) // b) % 2
    c = (torch.arange(w, device=dev) // b) % 2
    return r[:, None] == c[None, :]


def _paths(torch, cd, fn):
    """fn()'s blocks by path on the card (cd.PATHS), counted from 0."""
    pc = cd.path_counts("cuda")
    pc.zero_()
    out = fn()
    return out, dict(zip(cd.PATHS, pc.tolist()))


def _tests_content():
    """tests/_torch_content.py (the direction bins and extreme blocks the
    CDEF tests share), loaded by its path: an installed package may also
    be named `tests`."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parent / "tests" / \
        "_torch_content.py"
    spec = importlib.util.spec_from_file_location("_torch_content", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dirs_ops():
    """cdef_dirs' least work an 8x8 block, one op an instruction: each
    bin's sum of x - 128 as __dp4a words (4 pixels of one bin a word, the
    -128 n in the first word's accumulator), a square and a multiply-add
    by 840 / n a bin, the argmax of the 8 costs (a compare and two
    selects a step) and var (a subtract and a shift)."""
    words = bins = 0
    for b in _tests_content().DIR_BINS:
        n = np.bincount(b.ravel())
        words += int(((n + 3) // 4).sum())
        bins += len(n)
    return words + 2 * bins + 3 * 7 + 2


def cdef_phase(torch, cd, planes_d, srcs_d, skip8, floor_ms):
    """Phase 6 on one frame (contiguous uint8 planes, as cdef_search_persb
    gives them): every CDEF kernel against its plain version on the same
    inputs (dir, var, the SSE tables and the applied planes exactly
    equal; one launch a frame for the table and for the apply, the plain
    version per plane), the blocks on each path, device ms (CUDA events,
    mean of 3) of kernel and plain, and the bound (cdef_apply's on the
    map of every entry), which no kernel may beat, and the empty launch
    (floor_ms) beside it. Returns {kernel: (ms, plain_ms, bound_ms,
    bound_by)} for one frame's three planes."""
    h, w = planes_d[0].shape
    sampled = h % 64 == 0 and w % 64 == 0
    dirs, var = cd.cdef_dirs(planes_d[0])
    dp, vp = cd.cdef_dirs_plain(planes_d[0])
    if not (torch.equal(dirs, dp) and torch.equal(var, vp)):
        fail(f"{w}x{h}: cdef_dirs kernel and plain version differ")
    res = {}
    nb = dirs.numel()
    t_b = (h * w + 5 * nb) / H100_BYTES_PER_S * 1e3
    t_o = _dirs_ops() * nb / H100_INT_OPS_PER_S * 1e3
    # a launch of a few us: the mean of 20 (3 add about 1 us a launch)
    res["cdef_dirs"] = [
        time_cuda(torch, lambda: cd.cdef_dirs(planes_d[0]), 20),
        time_cuda(torch, lambda: cd.cdef_dirs_plain(planes_d[0]), 3),
        max(t_b, t_o), "bytes" if t_b >= t_o else "operations"]
    damping = CDEF_SPEED8[4]
    largs = (planes_d, srcs_d, dirs, var, skip8, damping, sampled)
    sses, lpaths = _paths(torch, cd, lambda: cd.cdef_ladder_sse(*largs))

    def ladder_plain():
        return [cd.cdef_ladder_sse_plain(p, s, dirs, var, skip8, damping,
                                         i > 0, sampled)
                for i, (p, s) in enumerate(zip(planes_d, srcs_d))]

    for i, want in enumerate(ladder_plain()):
        if not torch.equal(sses[i], want):
            fail(f"{w}x{h} plane {i}: cdef_ladder_sse kernel and plain "
                 f"version differ (max |err| "
                 f"{float((sses[i] - want).abs().max())})")
    t_o = t_b = 0.0
    for i, p in enumerate(planes_d):
        chroma = i > 0
        ph, pw = p.shape
        mask = (_sampled_mask(torch, ph, pw, 16 if chroma else 32, p.device)
                if sampled else None)
        t_o += _cdef_ladder_ops(torch, cd, var, skip8, chroma,
                                mask) / H100_INT_OPS_PER_S * 1e3
        t_b += (2 * ph * pw + 32 * sses[i][0].numel()) / H100_BYTES_PER_S * 1e3
    res["cdef_ladder_sse"] = [
        time_cuda(torch, lambda: cd.cdef_ladder_sse(*largs), 3),
        time_cuda(torch, ladder_plain, 3), max(t_b, t_o),
        "operations" if t_o >= t_b else "bytes"]
    nby, nbx = h // 32, w // 32
    nr, nc = (nby + 1) // 2, (nbx + 1) // 2
    idx = cd._choose(cd._sse_sb(sses, sampled, nr, nc),
                     torch.tensor(60.0, device=dirs.device))
    every = (torch.arange(nr * nc, device=dirs.device) % 8).reshape(nr, nc)
    aargs = (planes_d, dirs, var, skip8, damping)

    def apply_plain(**kw):
        st = kw.get("strengths", (0, 0, 0, 0))
        return [cd.cdef_apply_plain(p, dirs, var, skip8, damping, i > 0,
                                    kw.get("idx"), *(st[2:] if i else st[:2]))
                for i, p in enumerate(planes_d)]

    # the winners, every entry, and the uniform mode with chroma's primary
    # strength 0 (direction 0)
    apaths = {}
    for name, kw in (("winners", {"idx": idx}), ("every", {"idx": every}),
                     ("uniform", {"strengths": (3, 1, 0, 2)})):
        got, apaths[name] = _paths(torch, cd, lambda: cd.cdef_apply(*aargs,
                                                                    **kw))
        if not all(torch.equal(a, b) for a, b in zip(got, apply_plain(**kw))):
            fail(f"{w}x{h}: cdef_apply kernel and plain version differ on "
                 f"the {name} map")
    # timed and bounded on `every` (7 of 8 SBs filtered, at every entry);
    # the winners' map of this frame may filter nothing
    t_o = t_b = 0.0
    ent = cd._upsample(every, 8)[:h // 8, :w // 8]   # per 8x8 luma unit
    for i, p in enumerate(planes_d):
        t_o += _cdef_ops(torch, cd, var, skip8, i > 0,
                         ent) / H100_INT_OPS_PER_S * 1e3
        t_b += 2 * p.numel() / H100_BYTES_PER_S * 1e3
    res["cdef_apply"] = [
        time_cuda(torch, lambda: cd.cdef_apply(*aargs, idx=every), 3),
        time_cuda(torch, lambda: apply_plain(idx=every), 3), max(t_b, t_o),
        "operations" if t_o >= t_b else "bytes"]
    winners_ms = time_cuda(torch, lambda: cd.cdef_apply(*aargs, idx=idx), 3)
    print(f"# CDEF kernels vs plain at {w}x{h} ("
          f"{'sampled' if sampled else 'full'} branch, idx used "
          f"{sorted(set(idx.flatten().tolist()))}): dir, var, SSE tables "
          "and applied planes (the winners, every entry, a uniform "
          "strength) identical (max |err| 0); per frame ms "
          "(kernel, plain, bound, bound by; cdef_apply on the map of "
          "every entry): "
          + json.dumps({k: [round(v, 5) if isinstance(v, float) else v
                            for v in r] for k, r in res.items()})
          + f"; cdef_apply on the winners' map {winners_ms:.5f} ms; the "
          f"empty launch {floor_ms:.5f} ms", flush=True)
    print(f"# CDEF paths at {w}x{h}: cdef_ladder_sse blocks "
          f"{json.dumps({k: v for k, v in lpaths.items() if 'ladder' in k})}"
          "; cdef_apply (SB, plane) pairs by map "
          + json.dumps({m: {k: v for k, v in c.items() if 'apply' in k}
                        for m, c in apaths.items()}), flush=True)
    beaten = [k for k, r in res.items() if r[0] < r[2]]
    if beaten:
        fail(f"{w}x{h}: {beaten} ran in less than its bound: the count "
             "is no floor")
    return res


def dirs_extremes(torch, cd):
    """Phase 6, cdef_dirs at its extremes: dir_extremes' blocks, on an
    8-byte-aligned and a misaligned base (the wrapper copies it), and a
    1928x1088 frame (width 8 past a multiple of 64, the last thread block
    of each row partly outside it): kernel and plain version equal; the
    all-black block gives dir 0, var 0."""
    y = torch.from_numpy(np.tile(_tests_content().dir_extremes(),
                                 (2, 1))).cuda()
    flat = torch.empty(y.numel() + 1, dtype=torch.uint8, device="cuda")
    odd = flat[1:].view(y.shape)
    odd.copy_(y)
    rng = np.random.default_rng(29)
    wide = torch.from_numpy(synth(1928, 1088)[0][0]).cuda()
    noisy = torch.from_numpy(
        rng.integers(0, 256, (1088, 1928)).astype(np.uint8)).cuda()
    for what, p in (("extreme blocks", y), ("a misaligned base", odd),
                    ("1928x1088 synth", wide), ("1928x1088 noise", noisy)):
        d, v = cd.cdef_dirs(p)
        dp, vp = cd.cdef_dirs_plain(p)
        if not (torch.equal(d, dp) and torch.equal(v, vp)):
            fail(f"cdef_dirs on {what}: kernel and plain version differ")
    d, v = cd.cdef_dirs(y)
    if int(d[0, 0]) != 0 or int(v[0, 0]) != 0:
        fail(f"cdef_dirs on the all-black block: dir {int(d[0, 0])}, var "
             f"{int(v[0, 0])}, expected 0, 0")
    print(f"# cdef_dirs at its extremes (all 0, all 255, a ramp and "
          f"stripes along each direction, random; a misaligned base; "
          f"1928x1088 synth and noise): kernel = plain; dirs of the "
          f"extreme blocks {d[0, :18].tolist()}", flush=True)


def noise_at_q255(w, h, seed, scale=1):
    """Binary noise (0 / 255) as the source and, as its recon, the 8x8
    block means with mild noise (what q 255 leaves of it), divided by
    `scale`: per-plane cell SSEs pass 2^24. (recon, source, skip8)."""
    rng = np.random.default_rng(seed)
    rec, src = [], []
    for ph, pw in ((h, w), (h // 2, w // 2), (h // 2, w // 2)):
        s = np.where(rng.random((ph, pw)) < 0.5, 0, 255).astype(np.int32)
        m = s.reshape(ph // 8, 8, pw // 8, 8).mean((1, 3))
        r = np.kron(m, np.ones((8, 8))) + rng.normal(0, 12, (ph, pw))
        rec.append(np.clip(r.clip(0, 255).astype(np.int32) // scale, 0, 255))
        src.append(s)
    return rec, src, rng.random((h // 8, w // 8)) < 0.1


def cdef_past_2_24(torch, cd):
    """Phase 6, past 2^24: on noise at q 255, 256x192 (sampled branch)
    and 160x96 with a heavier error (full branch), the SSE tables of the
    kernel (the blocks past 2^24 on its ordered path) and of the plain
    version on the card, and the search's index and filtered planes on
    cuda and on cpu, exactly equal; a luma cell passes 2^24, where the
    order of the f32 sum decides."""
    for w, h, seed, scale in ((256, 192, 19, 1), (160, 96, 11, 4)):
        rec, src, skip8 = noise_at_q255(w, h, seed, scale)
        sampled = h % 64 == 0 and w % 64 == 0
        dev = {d: ([torch.from_numpy(p.astype(np.uint8)).to(d) for p in rec],
                   [torch.from_numpy(p.astype(np.uint8)).to(d) for p in src],
                   torch.from_numpy(skip8).to(d)) for d in ("cuda", "cpu")}
        rd, sd, kd = dev["cuda"]
        dirs, var = cd.cdef_dirs(rd[0])
        got, paths = _paths(torch, cd, lambda: cd.cdef_ladder_sse(
            rd, sd, dirs, var, kd, 3, sampled))
        for i in range(3):
            if not torch.equal(got[i], cd.cdef_ladder_sse_plain(
                    rd[i], sd[i], dirs, var, kd, 3, i > 0, sampled)):
                fail(f"{w}x{h} noise plane {i}: cdef_ladder_sse kernel and "
                     "plain version differ")
        top = float(got.max())
        if top < 2 ** 24:
            fail(f"{w}x{h} noise: no cell passes 2^24 ({top})")
        if paths["ladder_ordered"] < 1:
            fail(f"{w}x{h} noise: no block took the ordered path ({paths})")
        same = []
        for lam in (None, 60.0, 2000.0):
            out = {d: cd.cdef_search_persb(
                *dev[d], 3, lam=None if lam is None
                else torch.tensor(lam, device=d)) for d in dev}
            same.append(torch.equal(out["cuda"][0].cpu(), out["cpu"][0])
                        and all(torch.equal(a.cpu(), b) for a, b in
                                zip(out["cuda"][1], out["cpu"][1])))
        print(f"# CDEF past 2^24 at {w}x{h} (noise at q 255, "
              f"{'sampled' if sampled else 'full'} branch, largest cell "
              f"SSE {top:.0f}): kernel and plain tables identical, blocks "
              f"exact / ordered {paths['ladder_exact']} / "
              f"{paths['ladder_ordered']}; index and planes cuda = cpu at "
              f"lam None, 60, 2000: {same}", flush=True)
        if not all(same):
            fail(f"{w}x{h} noise: cdef_search_persb differs on cuda and cpu")


def gpu_vs_cpu(torch, native, ti):
    """Phase 7."""
    planes = synth(256, 192)[0]
    kd = {d: ti.analyze_keyframe(planes, 100, speed=10, device=d)
          for d in ("cuda", "cpu")}
    lv = {d: [x.cpu().numpy() for x in kd[d].state[3:6]] for d in kd}
    diff = [np.abs(a.astype(np.int64) - b) for a, b in
            zip(lv["cuda"], lv["cpu"])]
    ndiff = sum(int((x != 0).sum()) for x in diff)
    ntot = sum(x.size for x in diff)
    dmax = max(int(x.max()) for x in diff)
    with PackerCalls(native) as calls:
        pk = {d: ti.encode_keyframe_tpu(planes, 100, speed=10, device=d)
              for d in kd}
    same_pkt = pk["cuda"][0] == pk["cpu"][0]
    print(f"# 256x192 cuda vs cpu: {ndiff} of {ntot} levels differ "
          f"(max |d| {dmax}); packets identical: {same_pkt}; packer calls "
          f"{ {d: calls.methods([pk[d][0]], d) for d in pk} }", flush=True)
    if dmax > 1 or ndiff * 1e4 >= ntot:
        fail("cuda and cpu levels differ beyond |d| = 1 at < 1e-4")
    # a block is clean if no block at or above-left of it has a
    # differing level (DC prediction reads the above and left blocks)
    bad = np.zeros(diff[0].shape[:2], bool)
    for x in diff:
        bad |= x.reshape(x.shape[0], x.shape[1], -1).any(-1)
    clean = ~np.maximum.accumulate(np.maximum.accumulate(bad, 0), 1)
    for p in range(3):
        a = kd["cuda"].state[p].cpu().numpy()[clean]
        b = kd["cpu"].state[p].cpu().numpy()[clean]
        if not np.array_equal(a, b):
            fail(f"plane {p}: cuda and cpu recon differ where the levels "
                 "agree")
    if ndiff == 0 and not (same_pkt and all(
            np.array_equal(a, b) for a, b in zip(pk["cuda"][1],
                                                 pk["cpu"][1]))):
        fail("levels agree but packets or recon differ")


# the patch gathers of a 1080p P frame: (P, padded plane H, W, block
# pitch, patches B, block-grid columns). 43 / 39 / 23 at B = 2040: the
# 32-blocks' descent patch (M = 2), luma MC and chroma MC (8- or 4-tap);
# 71 / 39 at B = 510: the 64x64 merge's luma and 32x32 chroma MC;
# 27 / 15: refine16's per-16 patches (n = 16, M = 2) and its 8x8 chroma
GATHER_SHAPES = ((43, 1152, 1984, 32, 2040, 60),
                 (39, 1152, 1984, 32, 2040, 60),
                 (23, 576, 992, 16, 2040, 60),
                 (71, 1152, 1984, 64, 510, 30),
                 (39, 576, 992, 32, 510, 30),
                 (27, 1152, 1984, 16, 8160, 120),
                 (15, 576, 992, 8, 8160, 120))
# a speed-6 1080p P frame's gathers, one group a launch, each item (P, B,
# plane H, W): the descent patch; the re-judge's three candidate MCs; the
# final U/V windows (8- and 4-tap chroma); the merge's two 64x64 luma
# MCs; its U/V MCs (mv64 follows the luma costs: a second launch). Phase
# 15 must launch exactly these on each P frame.
_Y, _C = (1152, 1984), (576, 992)
SPEED6_P_GROUPS = (((43, 2040) + _Y,),
                   ((39, 2040) + _Y,) * 3,
                   ((23, 2040) + _C,) * 2,
                   ((71, 510) + _Y,) * 2,
                   ((39, 510) + _C,) * 2)


def _gather_starts(torch, rng, P, H, W, blk, B, ncol):
    """Starts in the main path's layout (a raster block grid with
    per-block drift), plus starts below 0 and past H-P / W-P."""
    gy, gx = np.divmod(np.arange(B), ncol)
    r0 = gy * blk + rng.integers(0, 2 * blk - 8, B)
    c0 = gx * blk + rng.integers(0, 2 * blk - 8, B)
    r0[:4] = [-1, -2 * P, H - P + 3, H + 40]
    c0[:4] = [W, -5, W - P + 1, -3 * W]
    return tuple(torch.from_numpy(x.astype(np.int32)).cuda()
                 for x in (r0, c0))


def _gather_bound(torch, gp, items):
    """A gather launch's byte bound (ms) on its items [(plane, r0, c0,
    P), ...]: the patches written, the starts, and each distinct plane's
    elements that the windows cover (clamped as the kernel clamps them),
    read once however many windows of the launch overlap them."""
    nbytes = 0
    covered = {}
    for plane, r0, c0, P in items:
        H, W = plane.shape
        B = r0.numel()
        nbytes += 4 * B * P * P + 8 * B
        key = (plane.data_ptr(), H, W)
        if key not in covered:
            covered[key] = torch.zeros((H, W), dtype=torch.bool,
                                       device=plane.device)
        ar = torch.arange(P, device=plane.device)
        rr = gp._starts(r0, H, P)[:, None, None] + ar[None, :, None]
        cc = gp._starts(c0, W, P)[:, None, None] + ar[None, None, :]
        covered[key][rr, cc] = True
    nbytes += 4 * sum(int(m.sum()) for m in covered.values())
    return nbytes / H100_BYTES_PER_S * 1e3


def _indexing(torch, gp, plane, r0, c0, P):
    """The PyTorch call that computes one gather: plane[rr, cc]."""
    H, W = plane.shape
    ar = torch.arange(P, device="cuda")
    rr = gp._starts(r0, H, P)[:, None, None] + ar[None, :, None]
    cc = gp._starts(c0, W, P)[:, None, None] + ar[None, None, :]
    return lambda: plane[rr, cc]


def gather_phase(torch, gp, floor_ms):
    """Phase 4. Per patch size and count (P, B): gather_patches and
    gather_patches_many (every shape in one mixed group) against the plain
    version, max |err|, kernel / plain / indexing ms (device time by CUDA
    events, mean of 20 launches) and the byte bound. Then the speed-6 P
    frame's gathers (SPEED6_P_GROUPS) replayed as the main path groups
    them, on random planes of the frame's shapes. Returns ({(P, B):
    numbers}, the frame's numbers)."""
    rng = np.random.default_rng(5)
    out = {}
    planes = {}
    starts = {}
    for P, H, W, blk, B, ncol in GATHER_SHAPES:
        planes.setdefault((H, W), [torch.from_numpy(
            rng.integers(0, 256, (H, W)).astype(np.int32)).cuda()
            for _ in range(2)])
        starts[(P, B)] = _gather_starts(torch, rng, P, H, W, blk, B, ncol)
    items = [(planes[(H, W)][0], *starts[(P, B)], P)
             for P, H, W, _, B, _ in GATHER_SHAPES]
    n0 = gp.gather_patches_many.launches
    group = gp.gather_patches_many(items)
    if gp.gather_patches_many.launches != n0 + 1:
        fail("the mixed group of every gather shape took other than one "
             "launch")
    for (P, H, W, blk, B, ncol), it, got_g in zip(GATHER_SHAPES, items,
                                                   group):
        plane, r0_t, c0_t, _ = it
        got = gp.gather_patches(plane, r0_t, c0_t, P)
        want = gp.gather_patches_plain(plane, r0_t, c0_t, P)
        torch.cuda.synchronize()
        err = max(int((got - want).abs().max()),
                  int((got_g - want).abs().max()))
        if err != 0 or not (torch.equal(got, want)
                            and torch.equal(got_g, want)):
            fail(f"gather P={P} B={B}: kernel (gather_patches or the mixed "
                 f"group) and plain version differ (max |err| {err})")
        ms = time_cuda(torch, lambda: gp.gather_patches(plane, r0_t, c0_t,
                                                         P), 20)
        plain_ms = time_cuda(torch, lambda: gp.gather_patches_plain(
            plane, r0_t, c0_t, P), 20)
        lib_ms = time_cuda(torch, _indexing(torch, gp, *it), 20)
        paced = time_cuda(torch, lambda: gp.gather_patches(
            plane, r0_t, c0_t, P), 20, hold=False)
        bound = _gather_bound(torch, gp, [it])
        print(f"# gather P={P} B={B} from [{H}, {W}]: kernel {ms:.5f} ms, "
              f"plain {plain_ms:.5f} ms, indexing call {lib_ms:.5f} ms, "
              f"bound {bound:.5f} ms ({100 * bound / ms:.0f}% of it; the "
              f"empty launch {floor_ms:.5f} ms), max |err| {err} (both "
              f"entry points); launches as the host paces them "
              f"{paced:.5f} ms each", flush=True)
        out[(P, B)] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                       "bound_ms": bound, "err": err}
    # the speed-6 P frame's gathers, grouped as the main path launches them
    shape = {(P, B, H, W): (blk, ncol)
             for P, H, W, blk, B, ncol in GATHER_SHAPES}
    groups = []
    for g in SPEED6_P_GROUPS:
        items = []
        for i, (P, B, H, W) in enumerate(g):
            # one luma reference; a chroma group's items are U and V
            plane = planes[(H, W)][0 if (H, W) == _Y else i]
            blk, ncol = shape[(P, B, H, W)]
            items.append((plane, *_gather_starts(torch, rng, P, H, W, blk, B,
                                                 ncol), P))
        groups.append(items)

    def frame():
        return [gp.gather_patches_many(g) for g in groups]

    def frame_plain():
        return [gp.gather_patches_many_plain(g) for g in groups]

    n0 = gp.gather_patches_many.launches
    got = frame()
    if gp.gather_patches_many.launches - n0 != len(groups):
        fail("the replayed frame took other than one launch a group")
    err = 0
    for gg, gw in zip(got, frame_plain()):
        for a, b in zip(gg, gw):
            err = max(err, int((a - b).abs().max()))
            if not torch.equal(a, b):
                fail("the replayed speed-6 P frame's gathers differ from "
                     f"the plain version (max |err| {err})")
    calls = [_indexing(torch, gp, *it) for g in groups for it in g]
    fr = {"ms": time_cuda(torch, frame, 20),
          "plain_ms": time_cuda(torch, frame_plain, 20),
          "library_ms": time_cuda(torch, lambda: [c() for c in calls], 20),
          "bound_ms": sum(_gather_bound(torch, gp, g) for g in groups),
          "launches": len(groups), "err": err}
    print(f"# gather, a speed-6 1080p P frame replayed ({len(groups)} "
          f"launches, {sum(map(len, groups))} gathers, groups "
          f"{[[it[:2] for it in g] for g in SPEED6_P_GROUPS]}): kernel "
          f"{fr['ms']:.5f} ms, plain {fr['plain_ms']:.5f} ms, indexing "
          f"calls {fr['library_ms']:.5f} ms, summed byte bound "
          f"{fr['bound_ms']:.5f} ms ({100 * fr['bound_ms'] / fr['ms']:.1f}% "
          f"of it; {len(groups)} empty launches "
          f"{len(groups) * floor_ms:.5f} ms), max |err| {err}", flush=True)
    return out, fr


def _level_diffs(a_list, b_list):
    diff = [np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64))
            for a, b in zip(a_list, b_list)]
    return (sum(int((x != 0).sum()) for x in diff),
            sum(x.size for x in diff), max(int(x.max()) for x in diff))


def squares(frames):
    """Static sharp-edged 16x16 squares stamped on each frame's luma (as
    tests/test_torch_split.py does): the 32x32 predictors cannot follow
    their edges and the zero MV fits them, so blocks split."""
    for f in frames:
        h, w = f[0].shape
        for k, (r, c) in enumerate(((16, 16), (48, 80), (80, 144),
                                    (16, 112), (96, 48))):
            if r + 16 <= h and c + 16 <= w:
                f[0][r:r + 16, c:c + 16] = (230, 30, 220, 40, 200)[k]
    return frames


def panning(w, h):
    """Two frames of synth's content, the second panned by (3, -2) luma
    pixels, with squares() stamped on both (static)."""
    planes = synth(w + 16, h + 16)[0]
    frames = []
    for dy, dx in ((0, 0), (3, -2)):
        frames.append([p[(8 + dy) // s:(8 + dy) // s + h // s,
                         (8 + dx) // s:(8 + dx) // s + w // s].copy()
                       for p, s in zip(planes, (1, 2, 2))])
    return squares(frames)


def _recording_fetch(tp):
    """Patch tp._fetch_packed to keep what it returns; returns (the list
    it fills, a function that restores it)."""
    got, orig = [], tp._fetch_packed

    def recording_fetch(o, *a, **k):
        got.append(orig(o, *a, **k))
        return got[-1]

    tp._fetch_packed = recording_fetch

    def restore():
        tp._fetch_packed = orig

    return got, restore


FETCHED = ("mv8", "skip", "lv_y", "lv_u", "lv_v", "split", "mv16", "skip16",
           "lf_lvl", "cdef_idx")


def gop_gpu_vs_cpu(torch, native, ti, tp, w, h, speed, cdef=None,
                   strict=False):
    """Phases 8-10: a KEY + 1 P GOP on cuda and on cpu. strict: every
    level, split map, MV field, skip, CDEF map and packet must agree."""
    frames = synth(w, h, n=2)
    if strict:
        frames = squares(frames)
    kd = {d: ti.analyze_keyframe(frames[0], 100, speed=speed, cdef=cdef,
                                 device=d)
          for d in ("cuda", "cpu")}
    kf = _level_diffs([x.cpu().numpy() for x in kd["cuda"].state[3:6]],
                      [x.cpu().numpy() for x in kd["cpu"].state[3:6]])
    kf_split = [kd[d].state[8].cpu().numpy() for d in ("cuda", "cpu")]

    calls = {}

    def run(device):
        """The GOP's packets and its P frame's fetched decisions."""
        got, restore = _recording_fetch(tp)
        try:
            with PackerCalls(native) as pc:
                pkts, _ = tp.encode_gop_tpu(frames, 100, speed=speed,
                                            cdef=cdef, device=device)
        finally:
            restore()
        calls[device] = pc.methods(pkts)
        return pkts, got[0]

    (pk_g, g), (pk_c, c) = run("cuda"), run("cpu")
    agree = np.all(g[0] == c[0], axis=1) & (g[1] == c[1])
    share = float(agree.mean())
    pf = _level_diffs([x[agree] for x in g[2:5]],
                      [x[agree] for x in c[2:5]])
    same_pkts = [a == b for a, b in zip(pk_g, pk_c)]
    # the CDEF index maps: the keyframe's in its meta tail, the P frame's
    # in the fetched decisions
    nsb = ((h // 32 + 1) // 2) * ((w // 32 + 1) // 2)
    maps_same = (np.array_equal(kd["cuda"].meta[-nsb:].cpu().numpy(),
                                kd["cpu"].meta[-nsb:].cpu().numpy())
                 and np.array_equal(g[9], c[9]))
    print(f"# {w}x{h} GOP speed {speed}, cdef {cdef}, cuda vs cpu: (mv, "
          f"skip) agree on {int(agree.sum())} of {agree.size} blocks "
          f"({100 * share:.2f}%); keyframe levels differ {kf[0]} of {kf[1]} "
          f"(max |d| {kf[2]}); P levels on agreeing blocks differ {pf[0]} "
          f"of {pf[1]} (max |d| {pf[2]}); CDEF index maps identical: "
          f"{maps_same}; packets identical: {same_pkts}; split 32-blocks "
          f"(keyframe, P) {int(kf_split[1].sum())}, {int(c[5].sum())} of "
          f"{c[5].size}; packer calls {calls}", flush=True)
    if strict:
        bad = [k for k, a, b in zip(FETCHED, g, c) if not np.array_equal(a,
                                                                        b)]
        if not np.array_equal(*kf_split):
            bad.append("keyframe split")
        if kf[0] or bad or not maps_same or not all(same_pkts):
            fail(f"{w}x{h} speed {speed}: cuda and cpu differ ({bad}, "
                 f"keyframe levels {kf[0]}, CDEF maps identical "
                 f"{maps_same}, packets identical {same_pkts})")
        return
    if share < 0.99:
        fail("cuda and cpu agree on fewer than 99% of the P blocks")
    for nd, nt, dmax in (kf, pf):
        if dmax > 1 or nd * 1e4 >= nt:
            fail("cuda and cpu levels differ beyond |d| = 1 at < 1e-4")
    if (kf[0] == 0 and pf[0] == 0 and agree.all()
            and not (maps_same and all(same_pkts))):
        fail("every MV, skip and level agrees but the CDEF maps or the "
             "packets differ")


FETCHED6 = FETCHED + ("choice", "mvb8", "b64_map", "split16", "skip8")


def speed6_p_content(w, h):
    """panning()'s two frames with sharp static 8x8 squares (quads split
    16->8), a flat ramp over the bottom-left 64x64 SB (merges) and, in
    the second frame only, two flat 32x32 squares the first does not hold
    (intra-in-inter)."""
    frames = panning(w, h)
    for i, f in enumerate(frames):
        y = f[0].astype(np.int32)
        y[h - 64:h, 0:64] = 90 + np.arange(64)[None, :] // 5
        for r, c, val in ((8, 72, 230), (40, 136, 30), (72, 104, 220),
                          (136, 200, 25)):
            if r + 8 <= h and c + 8 <= w:
                y[r:r + 8, c:c + 8] = val
        if i == 1:
            for r, c, val in ((0, w - 64, 250), (96, 96, 10)):
                y[r:r + 32, c:c + 32] = val
        f[0] = np.clip(y, 0, 255).astype(np.uint8)
    return frames


def speed6_gop_gpu_vs_cpu(native, tp, w, h):
    """Phase 14b: a speed-6 KEY + 1 P GOP with cdef at w x h on cuda and
    on cpu: every fetched decision (MVs, skips, levels, split / split16 /
    b64 / choice maps, skip8, CDEF map), the recon and the packets must
    agree, and the P frame must take each speed-6 tool. Returns the P
    frame's tool counts."""
    frames = speed6_p_content(w, h)
    res, calls = {}, {}
    for d in ("cuda", "cpu"):
        got, restore = _recording_fetch(tp)
        try:
            with PackerCalls(native) as pc:
                pkts, recs = tp.encode_gop_tpu(frames, 100, speed=6,
                                               cdef=CDEF_SPEED8, device=d)
        finally:
            restore()
        calls[d] = pc.methods(pkts)
        rec = [np.asarray(r.cpu() if hasattr(r, "cpu") else r, np.int32)
               for r in recs[1]]
        res[d] = (pkts, rec, got[0])
    (pk_g, rc_g, g), (pk_c, rc_c, c) = res["cuda"], res["cpu"]
    bad = [k for k, a, b in zip(FETCHED6, g, c) if not np.array_equal(a, b)]
    if not all(np.array_equal(a, b) for a, b in zip(rc_g, rc_c)):
        bad.append("recon")
    d = dict(zip(FETCHED6, c))
    counts = {"blocks": int(d["split"].size), "split": int(d["split"].sum()),
              "quads_split_16_to_8": int(d["split16"].sum()),
              "merged_64x64": int(d["b64_map"].sum()),
              "intra_32": int((d["choice"] == 3).sum()),
              "satd": "every descent"}
    print(f"# {w}x{h} speed-6 GOP (KEY + 1 P, cdef {CDEF_SPEED8}), cuda vs "
          f"cpu: differing {bad or 'nothing'}; packets identical: "
          f"{pk_g == pk_c} ({[len(p) for p in pk_c]} bytes); P frame took: "
          f"{json.dumps(counts)}; packer calls {calls}", flush=True)
    if bad or pk_g != pk_c:
        fail(f"the {w}x{h} speed-6 GOP differs between cuda and cpu: {bad}")
    lacking = [k for k in ("quads_split_16_to_8", "merged_64x64",
                           "intra_32") if counts[k] < 1]
    if lacking:
        fail(f"the {w}x{h} speed-6 P frame took no {lacking}")
    return counts


def default_pframe_gpu_vs_cpu(native, tp, w, h):
    """Phase 11: encode_pframe_tpu(planes, ref) with the reference's
    defaults (split RDO with refine16, 16-px search, subpel) on cuda and
    on cpu; every MV field, split map, skip, level, the recon and the
    packet must agree. Returns the cuda run's gathers by patch size."""
    frames = panning(w, h)
    sizes: dict = {}
    orig_g = tp.gather_patches_many

    def counting_gather(items):
        items = list(items)
        for it in items:
            if it[0].is_cuda:
                sizes[it[3]] = sizes.get(it[3], 0) + 1
        return orig_g(items)

    res, calls = {}, {}
    for d in ("cuda", "cpu"):
        got, restore = _recording_fetch(tp)
        tp.gather_patches_many = counting_gather
        try:
            with PackerCalls(native) as pc:
                pkt, rec = tp.encode_pframe_tpu(frames[1], frames[0],
                                                device=d)
        finally:
            restore()
            tp.gather_patches_many = orig_g
        calls[d] = pc.methods([pkt])
        res[d] = (pkt, rec, got[0])
    (pk_g, rc_g, g), (pk_c, rc_c, c) = res["cuda"], res["cpu"]
    bad = [k for k, a, b in zip(FETCHED, g, c) if not np.array_equal(a, b)]
    if not all(np.array_equal(a, b) for a, b in zip(rc_g, rc_c)):
        bad.append("recon")
    split, mv16 = c[5], c[6]
    print(f"# {w}x{h} default P frame (split, refine16, search 16, subpel), "
          f"cuda vs cpu: differing {bad or 'nothing'}; packets identical: "
          f"{pk_g == pk_c} ({len(pk_c)} bytes); split 32-blocks "
          f"{int(split.sum())} of {split.size}, fractional per-16 MVs "
          f"{int((mv16[split] % 8 != 0).sum())}; cuda gathers by patch "
          f"size {sizes}; packer calls {calls}", flush=True)
    if bad or pk_g != pk_c:
        fail(f"the default P frame differs between cuda and cpu: {bad}")
    if not split.any():
        fail("the default P frame split no block")
    return sizes


def gop_1080p(torch, ec, gp, cd, native, ti, tp, n: int, speed: int,
              cdef=None, h: int = 1088, expect=None, record=None):
    """Phases 12, 13 and 15: a 1920 x h KEY + (n - 1) P GOP on cuda as a
    user calls it (the C++ packer, the keyframe's host half and each P
    frame's fetch + pack on worker threads), every kernel's count set to
    0 just before it and read just after. The kernels the main thread
    launches (the gather in the P steps, CDEF in every frame's device
    half) are counted per frame between the device halves' last stage
    marks; ec_pack, launched on the workers, must run once a frame, one
    launch a tile the packer coded. Checks that every frame launched
    each kernel that serves it (the keyframe: ec_pack, and the three CDEF
    kernels with cdef; each P frame: also gather_patches), and with
    `expect` that the packets have those sizes (printing each packet's
    SHA-256). `record`, a list, receives each pack call's arguments
    (("key", kd, planes) and ("p", args, kwargs)). Returns ({kernel:
    launches}, {gather group: launches}, with a group a tuple of its
    items' (P, B, plane H, W), P frames, stage times)."""
    frames = synth(1920, h, n=n)
    w = 1920
    nsb = ((h // 32 + 1) // 2) * ((w // 32 + 1) // 2)
    sizes: dict = {}

    def counting_gather(items):
        items = list(items)
        key = tuple((P, int(r0.shape[0])) + tuple(plane.shape)
                    for plane, r0, _, P in items)
        sizes[key] = sizes.get(key, 0) + 1
        return gp.gather_patches_many(items)

    kern = {"gather_patches": gp.gather_patches_many, "ec_pack": ec.pack_ir}
    if cdef is not None:
        kern.update(cdef_dirs=cd.cdef_dirs,
                    cdef_ladder_sse=cd.cdef_ladder_sse,
                    cdef_apply=cd.cdef_apply)
    on_main = [k for k in kern if k != "ec_pack"]
    snaps = []                  # main-thread counts after each device half
    chosen = {}                 # each frame's CDEF ladder entries, counted
    split_share = {}            # each frame's share of split 32-blocks
    tools = {}                  # each P frame's speed-6 block kinds
    orig_pack, orig_kpack = tp._pack_pframe, ti.pack_keyframe
    orig_mark = tp._Stages.mark

    def mark(stages, name):
        orig_mark(stages, name)
        if name in ("meta", "pack") and \
                threading.current_thread() is threading.main_thread():
            snaps.append({k: kern[k].launches for k in on_main})

    def pack_p(*a, **k):
        i = a[3]                             # the order hint: the frame
        split_share[i] = (0.0 if k.get("split") is None
                          else float(np.mean(k["split"])))
        if k.get("choice") is not None:
            # shares of the 32-blocks: split 16->8 (any quad), in a
            # merged 64x64 SB, intra-in-inter
            b64 = np.repeat(np.repeat(k["b64_map"], 2, 0), 2, 1)
            tools[i] = {"split16": float(np.mean(k["split16"].any(1))),
                        "merged": float(np.mean(b64)),
                        "intra": float(np.mean(k["choice"] == 3))}
        if cdef is not None:
            chosen[i] = np.bincount(np.asarray(k["cdef"][1], np.int64)
                                    .ravel(), minlength=8).tolist()
        if record is not None:
            record.append(("p", a, dict(k)))
        return orig_pack(*a, **k)

    def pack_key(kd, planes, *a, **k):
        split_share[0] = float(np.mean(kd.state[8].cpu().numpy()))
        if cdef is not None:
            chosen[0] = np.bincount(kd.meta[-nsb:].cpu().numpy().astype(
                np.int64), minlength=8).tolist()
        if record is not None:
            record.append(("key", kd, planes))
        return orig_kpack(kd, planes, *a, **k)

    saved = tp.gather_patches_many
    tp.gather_patches_many = counting_gather
    tp._pack_pframe, ti.pack_keyframe = pack_p, pack_key
    tp._Stages.mark = mark
    timings: list = []
    try:
        with PackerCalls(native) as calls:
            for f in kern.values():
                f.launches = 0
            t0 = time.perf_counter()
            pkts, recs = tp.encode_gop_tpu(frames, 100, speed=speed,
                                           cdef=cdef, device="cuda",
                                           timings=timings)
            wall = time.perf_counter() - t0
            launches = {k: f.launches for k, f in kern.items()}
    finally:
        tp.gather_patches_many = saved
        tp._pack_pframe, ti.pack_keyframe = orig_pack, orig_kpack
        tp._Stages.mark = orig_mark
    n_p = len(frames) - 1
    methods = calls.methods(pkts)
    print(f"# {w}x{h} GOP (KEY + {n_p} P, speed {speed}, cdef {cdef}, q 100, "
          f"cuda, overlapped): {wall:.3f} s (gop_wall "
          f"{timings[0]['gop_wall']:.3f} s); packets "
          f"{[len(p) for p in pkts]} bytes; packer calls {methods}; "
          f"launches {json.dumps(launches)}, gather groups (P, B, plane) "
          f"and their launches {sizes}", flush=True)
    for i, t in enumerate(timings):
        print(f"# frame {i} stages (s): "
              + json.dumps({k: round(v, 4) for k, v in t.items()}),
              flush=True)
    if chosen:
        print(f"# CDEF ladder entries chosen per frame (SBs per entry "
              f"0..7): {[chosen.get(i) for i in range(len(frames))]}",
              flush=True)
    print(f"# share of split 32-blocks per frame: "
          f"{[split_share.get(i) for i in range(len(frames))]}", flush=True)
    if tools:
        print(f"# P frames' shares of 32-blocks with a quad split 16->8, "
              f"merged into 64x64, intra: "
              f"{json.dumps([tools.get(i) for i in range(1, n)])}",
              flush=True)
    sizes_b = [len(p) for p in pkts]
    if expect is not None:
        import hashlib
        print(f"# packets {sizes_b} bytes, the reference's {expect} "
              f"(the JAX package on the CPU): equal {sizes_b == expect}; "
              f"SHA-256: {[hashlib.sha256(p).hexdigest()[:16] for p in pkts]}",
              flush=True)
        if sizes_b != expect:
            fail(f"speed {speed} GOP packets {sizes_b}, expected {expect}")
    if len(snaps) != len(frames):
        fail(f"{len(snaps)} device halves ended, {len(frames)} expected")
    prev = {k: 0 for k in on_main}
    for i, after in enumerate(snaps):
        step = {k: after[k] - prev[k] for k in on_main}
        need = [k for k in on_main if k != "gather_patches" or i > 0]
        bad = [k for k in need if step[k] < 1]
        if bad:
            fail(f"frame {i} did not launch {bad} (device half {step})")
        # the CDEF table and filter: one launch a frame for three planes
        many = [k for k in ("cdef_ladder_sse", "cdef_apply")
                if k in step and step[k] != 1]
        if many:
            fail(f"frame {i} launched {many} other than once ({step})")
        prev = after
    if len(calls.got) != len(frames) or None in methods \
            or launches["ec_pack"] != len(frames):
        fail(f"{len(calls.got)} tiles coded by the packer and "
             f"{launches['ec_pack']} ec_pack launches for {len(frames)} "
             f"frames (packer calls {methods})")
    if methods[0] != "write_intra_tile_fast" or any(
            m not in ("write_inter_tile_fast", "write_inter_tile_fast2")
            for m in methods[1:]):
        fail(f"the frames took the packer calls {methods}")
    captured = [g[2] for g in calls.by_packet(pkts)]
    for i, (ir, pkt) in enumerate(zip(captured, pkts)):
        c_p, st_p = ec.pack_ir_plain(ir)
        if not pkt.endswith(ec.finish(c_p.tolist(), *st_p[:3].tolist())):
            fail(f"frame {i}: the IR coded by pack_ir_plain is not the "
                 "packet's tile")
    kf_rec = recs[0]
    if any(r.min() < 0 or r.max() > 255 for r in kf_rec):
        fail("the keyframe recon leaves 0..255")
    for i, rec in enumerate(recs[1:], start=1):
        if [tuple(r.shape) for r in rec] != [p.shape for p in frames[i]] \
                or any(r.dtype != torch.uint8 for r in rec):
            fail(f"P frame {i}: recon shapes or type wrong")
    rows = [int(x.shape[0]) for x in captured]
    print(f"# {w}x{h} GOP: {len(captured)} tiles ({rows} symbols) re-coded "
          "by pack_ir_plain: identical bytes; every frame launched the "
          "kernels that serve it", flush=True)
    for i, ir in enumerate(captured):
        ir_d = ir.cuda()
        ms = {L: time_cuda(torch, lambda: ec.pack_ir(ir_d, chunk_rows=L), 3)
              for L in (256, ec.CHUNK_ROWS, 1024)}
        print(f"# frame {i} tile ({ir.shape[0]} symbols): ec kernel "
              f"{ms[ec.CHUNK_ROWS]:.4f} ms at L = {ec.CHUNK_ROWS}; by L: "
              f"{json.dumps({L: round(t, 4) for L, t in ms.items()})}; "
              f"passes (ms): {json.dumps(pass_times(torch, ec, ir_d))}",
              flush=True)
    return launches, sizes, n_p, timings


def packer_vs_writer(torch, ec, native, ti, tp, record):
    """Phase 15b: each frame of phase 15's GOP packed again from the
    same decisions, by the C++ packer and by the Python TileWriter with a
    RecordingEncoder (use_native=False), one after the other on this
    thread: the two IRs must be equal row for row, and the kernel's
    bytes on each must be pack_ir_plain + finish's."""
    py = []

    class Capture(ec.RecordingEncoder):
        def done(self):
            ir = self.ir_tensor()
            py.append((ir, super().done()))
            return py[-1][1]

    def order(c):
        return 0 if c[0] == "key" else c[1][3]

    saved = ti.RecordingEncoder, tp.RecordingEncoder
    ti.RecordingEncoder = tp.RecordingEncoder = Capture
    try:
        for c in sorted(record, key=order):
            def run(use_native, t):
                if c[0] == "key":
                    return ti.pack_keyframe(c[1], c[2], 100, device="cuda",
                                            timings=t,
                                            use_native=use_native)[0]
                return tp._pack_pframe(*c[1], **{**c[2], "timings": t,
                                                 "use_native": use_native})

            t_n, t_p = {}, {}
            with PackerCalls(native) as calls:
                pkt_n = run(True, t_n)
            del py[:]
            pkt_p = run(False, t_p)
            (method, _, ir_n, tile_n), (ir_p, tile_p) = calls.got[0], py[0]
            same_ir = ir_n.shape == ir_p.shape and torch.equal(ir_n, ir_p)
            c_p, st_p = ec.pack_ir_plain(ir_n)
            plain = ec.finish(c_p.tolist(), *st_p[:3].tolist())
            same = tile_n == plain and tile_p == plain and pkt_n == pkt_p
            print(f"# frame {order(c)} ({method}): IR {ir_n.shape[0]} rows "
                  f"(Python writer {ir_p.shape[0]}), equal row for row: "
                  f"{same_ir}; the kernel's bytes on both IRs equal "
                  f"pack_ir_plain + finish's: {same}; walk (s): C++ packer "
                  f"{t_n['tile_walk']:.4f}, Python writer "
                  f"{t_p['tile_walk']:.4f}; IR upload {t_n['ir_upload']:.4f}"
                  f" s, ec_kernel (upload included) {t_n['ec_kernel']:.4f} "
                  f"s", flush=True)
            if not (same_ir and same):
                fail(f"frame {order(c)}: the packer and the Python writer "
                     "differ")
    finally:
        ti.RecordingEncoder, tp.RecordingEncoder = saved


def speed6_content(w, h):
    """synth content with squares() stamped on it, a straight diagonal
    luma edge and u following luma: blocks split, take directional
    modes, the four TX types of the quads and CfL."""
    planes = squares([synth(w, h)[0]])[0]
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.where(xx - yy > w // 3, planes[0].astype(np.int32) + 60,
                 planes[0])
    planes[0] = np.clip(y, 0, 255).astype(np.uint8)
    yd = planes[0].reshape(h // 2, 2, w // 2, 2).mean((1, 3))
    planes[1] = np.clip(128 + 0.5 * (yd - 128), 0, 255).astype(np.uint8)
    return planes


def checker_region(planes, y0=48, x0=64):
    """An 8-px checkerboard (+-40) over a 96x128 luma region of the
    planes at (y0, x0) (in place): 8x8 blocks flat, 16x16 blocks not, so
    the frame's 8..16 px band passes the split8 gate."""
    yy, xx = np.mgrid[0:96, 0:128]
    y = planes[0][y0:y0 + 96, x0:x0 + 128].astype(np.int32)
    planes[0][y0:y0 + 96, x0:x0 + 128] = np.clip(
        y + np.where((xx // 8 + yy // 8) % 2, 40, -40), 0, 255)
    return planes


def checker_tiled(planes):
    """checker_region every 256 px across the frame's width (and every
    192 px down, from row 16): enough of the frame for the gate."""
    h, w = planes[0].shape
    for y0 in range(16, h - 96 + 1, 192):
        for x0 in range(64, w - 128 + 1, 256):
            checker_region(planes, y0, x0)
    return planes


STATE = ("rec_y", "rec_u", "rec_v", "lv_y", "lv_u", "lv_v", "y_modes",
         "uv_modes", "split", "cfl", "ytx", "s16", "ym8", "uvm8")
DIRECTIONAL = (3, 4, 5, 6, 7, 8)       # D45 D135 D113 D157 D203 D67


def speed6_gpu_vs_cpu(torch, native, ti, w: int, h: int, split8: bool):
    """Phase 14: the default keyframe with cdef on cuda and on cpu. Every
    grid of the state, the meta buffer, the filtered recon and the packet
    must be identical. Returns the tools' counts."""
    planes = speed6_content(w, h)
    if split8:
        planes = checker_region(planes)
    band = ti._detail_band8(planes[0])
    if (band > 256.0) != split8:
        fail(f"{w}x{h}: the 8..16 px band {band:.1f} is on the wrong side "
             "of the split8 gate")
    kd = {d: ti.analyze_keyframe(planes, 100, cdef=CDEF_SPEED8, device=d)
          for d in ("cuda", "cpu")}
    bad = [n for n, a, b in zip(STATE, kd["cuda"].state, kd["cpu"].state)
           if not torch.equal(a.cpu(), b.cpu())]
    for k in ("meta", "rec_packed"):
        if not torch.equal(getattr(kd["cuda"], k).cpu(),
                           getattr(kd["cpu"], k).cpu()):
            bad.append(k)
    with PackerCalls(native) as pc:
        out = {d: ti.pack_keyframe(kd[d], planes, 100, device=d)
               for d in kd}
    calls = {d: pc.methods([out[d][0]], d) for d in out}
    if out["cuda"][0] != out["cpu"][0]:
        bad.append("packet")
    if not all(np.array_equal(a, b) for a, b in zip(out["cuda"][1],
                                                    out["cpu"][1])):
        bad.append("recon")
    g = [x.cpu().numpy() for x in kd["cpu"].state]
    my, mu, sp, ytx, s16 = g[6], g[7], g[8], g[10], g[11]
    whole = ~sp
    quads = sp[..., None] & ~s16
    counts = {
        "blocks": int(sp.size), "split": int(sp.sum()),
        "cfl": int((mu[..., 0][whole] == 13).sum()),
        "directional_32": int(np.isin(my[..., 0][whole], DIRECTIONAL).sum()),
        "directional_16": int(np.isin(my[..., 1:][quads], DIRECTIONAL).sum()),
        "tx_types_16 (DCT, ADST_ADST, ADST_DCT, DCT_ADST)":
            np.bincount(ytx[quads], minlength=5)[1:].tolist(),
        "split_16_to_8": int(s16.sum())}
    tag = " with a checkerboard" if split8 else ""
    print(f"# {w}x{h} speed-6 keyframe{tag}, cuda vs cpu: 8..16 px band "
          f"{band:.3f} (gate "
          f"{'on' if split8 else 'off'}); differing {bad or 'nothing'}; "
          f"{len(out['cpu'][0])} bytes; taken: {json.dumps(counts)}; "
          f"packer calls {calls}", flush=True)
    if bad:
        fail(f"{w}x{h} speed 6: cuda and cpu differ ({bad})")
    if split8 and not counts["split_16_to_8"]:
        fail(f"{w}x{h}: no quad split 16->8 over the gate")
    return counts


def speed6_keyframe(torch, ec, cd, native, ti, planes, what: str,
                    split8: bool):
    """Phase 16: a full-width speed-6 keyframe with cdef on cuda,
    every kernel's count set to 0 just before and read just after; the
    split8 gate must be `split8`. Returns ({kernel: launches}, stage
    times)."""
    band = ti._detail_band8(planes[0])
    if (band > 256.0) != split8:
        fail(f"{what}: the 8..16 px band {band:.1f} is on the wrong side of "
             "the split8 gate")
    kern = {"ec_pack": ec.pack_ir, "cdef_dirs": cd.cdef_dirs,
            "cdef_ladder_sse": cd.cdef_ladder_sse, "cdef_apply": cd.cdef_apply}
    timings: dict = {}
    kds = []
    saved = ti.analyze_keyframe

    def analyze(*a, **k):
        kds.append(saved(*a, **k))
        return kds[-1]

    ti.analyze_keyframe = analyze
    try:
        with PackerCalls(native) as calls:
            for f in kern.values():
                f.launches = 0
            t0 = time.perf_counter()
            pkt, rec = ti.encode_keyframe_tpu(planes, 100, cdef=CDEF_SPEED8,
                                              device="cuda", timings=timings)
            wall = time.perf_counter() - t0
            launches = {k: f.launches for k, f in kern.items()}
    finally:
        ti.analyze_keyframe = saved
    n8 = int(kds[0].state[STATE.index("s16")].sum())
    stages = {k: round(v, 4) for k, v in timings.items()}
    print(f"# {what} speed-6 keyframe (q 100, cdef {CDEF_SPEED8}, cuda): "
          f"{len(pkt)} bytes in {wall:.3f} s; 8..16 px band "
          f"{band:.3f} (gate {'on' if split8 else 'off'}); quads split "
          f"16->8: {n8}; packer call {calls.methods([pkt])}; launches "
          f"{json.dumps(launches)}; stages (s): {json.dumps(stages)}",
          flush=True)
    idle = [k for k, n in launches.items() if n < 1]
    if idle:
        fail(f"the {what} speed-6 keyframe did not launch {idle}")
    if launches["cdef_ladder_sse"] != 1 or launches["cdef_apply"] != 1:
        fail(f"the {what} speed-6 keyframe launched the CDEF table or "
             f"filter other than once ({launches})")
    if split8 and not n8:
        fail(f"the {what} speed-6 keyframe split no quad 16->8")
    if [r.shape for r in rec] != [p.shape for p in planes] or any(
            r.min() < 0 or r.max() > 255 for r in rec):
        fail(f"the {what} speed-6 recon has other shapes or leaves 0..255")
    c_p, st_p = ec.pack_ir_plain(calls.got[0][2])
    if not pkt.endswith(ec.finish(c_p.tolist(), *st_p[:3].tolist())):
        fail(f"the {what} speed-6 tile's IR coded by pack_ir_plain is not "
             "the packet's tile")
    return launches, timings


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from rav1e_tpu_torch import nvcc
    import rav1e_tpu_torch.entropy.ec_cuda as ec
    import rav1e_tpu_torch.entropy.native as native
    import rav1e_tpu_torch.ops.cdef as cd
    import rav1e_tpu_torch.ops.gather as gp
    import rav1e_tpu_torch.pipeline.tpu_inter as tp
    import rav1e_tpu_torch.pipeline.tpu_intra as ti

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        packer = ex.submit(nvcc.build_host, native.SRC)
        libs = nvcc.build_all([ec.SRC, gp.SRC, cd.SRC])
        libs.append(packer.result())
    t_build = time.perf_counter() - t0
    out = subprocess.run([nvcc.nvcc(), "--version"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    release = next((ln for ln in out if "release" in ln), out[-1])
    print(f"# built {[lib.name for lib in libs]} in {t_build:.2f} s with "
          f"nvcc: {release}", flush=True)
    for lib in libs:
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"# {lib.name}: {line.strip()}", flush=True)

    floor_ms = time_cuda(torch, gp.empty_launch, 20)
    print(f"# the empty kernel (csrc/gather_patches.cu, queued behind a "
          f"spin kernel, mean of 20): {floor_ms:.5f} ms a launch, the part "
          "of a small launch's time that no kernel design closes",
          flush=True)
    kernel_vs_plain(torch, ec)
    gather, gframe = gather_phase(torch, gp, floor_ms)
    ec_entry, kd, planes = slice_1080p(torch, ec, native, ti, floor_ms)
    # phase 6: the CDEF kernels on the deblocked 1080p keyframe recon
    # (sampled branch) and on it cut to 1920x1056 (full branch)
    h, w = planes[0].shape
    rp = kd.rec_packed
    # contiguous uint8 planes, as cdef_search_persb hands them on
    rec_d = cd._as_u8([rp[:h], rp[h:, :w // 2], rp[h:, w // 2:]])
    src_d = [torch.from_numpy(p).cuda() for p in planes]
    skip8 = ti._kf_skip8(kd.state)
    cdef_ms = cdef_phase(torch, cd, rec_d, src_d, skip8, floor_ms)
    cdef_phase(torch, cd, cd._as_u8([rec_d[0][:1056], rec_d[1][:528],
                                     rec_d[2][:528]]),
               cd._as_u8([src_d[0][:1056], src_d[1][:528], src_d[2][:528]]),
               skip8[:132], floor_ms)
    dirs_extremes(torch, cd)
    cdef_past_2_24(torch, cd)
    gpu_vs_cpu(torch, native, ti)
    gop_gpu_vs_cpu(torch, native, ti, tp, 512, 384, 10)
    gop_gpu_vs_cpu(torch, native, ti, tp, 256, 192, 8, CDEF_SPEED8)
    gop_gpu_vs_cpu(torch, native, ti, tp, 256, 192, 7, CDEF_SPEED8,
                   strict=True)
    r16_sizes = default_pframe_gpu_vs_cpu(native, tp, 256, 192)
    for P in (27, 15):
        g = gather[(P, 8160)]
        print(f"# refine16 gather P={P}: {r16_sizes.get(P, 0)} gathers in "
              f"the 256x192 default P frame; at 1080p (B = 8160) kernel "
              f"{g['ms']:.5f} ms, plain {g['plain_ms']:.5f} ms, indexing "
              f"call {g['library_ms']:.5f} ms, bound {g['bound_ms']:.5f} ms",
              flush=True)
        if r16_sizes.get(P, 0) < 1:
            fail(f"the default P frame launched no gather at P = {P}")
    for split8 in (False, True):
        speed6_gpu_vs_cpu(torch, native, ti, 256, 192, split8)
    speed6_gop_gpu_vs_cpu(native, tp, 256, 192)
    # the speed-10 and speed-7 GOPs, their depth cut to 544 rows to keep
    # the run short
    gop_1080p(torch, ec, gp, cd, native, ti, tp, 2, 10, h=544)
    gop7_launches, _, n_p7, _ = gop_1080p(torch, ec, gp, cd, native, ti,
                                          tp, 3, 7, CDEF_SPEED8, h=544)
    # the main path: the speed-6 GOP with CDEF, the preset the
    # reference's bench times
    record: list = []
    launches, groups, n_p, _ = gop_1080p(torch, ec, gp, cd, native, ti, tp,
                                         3, 6, CDEF_SPEED8,
                                         expect=GOP6_BYTES, record=record)
    # the same frames packed again by the packer and by the Python writer
    packer_vs_writer(torch, ec, native, ti, tp, record)
    # a full-width speed-6 keyframe whose quads split 16->8
    kf6s_launches, _ = speed6_keyframe(torch, ec, cd, native, ti,
                                       checker_tiled(synth(1920, 128)[0]),
                                       "1920x128 split8", True)

    # the gather entry: phase 4's replay of the groups each P frame
    # launched
    want = {g: n_p for g in SPEED6_P_GROUPS}
    if groups != want:
        fail(f"the speed-6 P frames launched the gather groups {groups}, "
             f"phase 4 replayed {want}")
    per_frame = launches["gather_patches"] / n_p
    print(f"# gather launches a speed-6 1080p P frame: {per_frame:g} "
          f"(each gather its own launch: 13)", flush=True)
    if per_frame >= 13:
        fail(f"the speed-6 P frame launched {per_frame} gathers, not fewer "
             "than 13")
    items: dict = {}
    for g in SPEED6_P_GROUPS:
        for P, B, _, _ in g:
            items[(P, B)] = items.get((P, B), 0) + 1
    for k in ((71, 510), (39, 510), (23, 2040)):
        g = gather[k]
        print(f"# gather P={k[0]} B={k[1]} on the speed-6 main path: "
              f"{items.get(k, 0)} gathers a P frame; alone, kernel "
              f"{g['ms']:.5f} ms, plain {g['plain_ms']:.5f} ms, indexing "
              f"call {g['library_ms']:.5f} ms, bound {g['bound_ms']:.5f} ms "
              f"({100 * g['bound_ms'] / g['ms']:.0f}% of it)", flush=True)
    gather_entry = {
        "name": "gather_patches", "route": "cuda",
        "source": "rav1e_tpu_torch/csrc/gather_patches.cu",
        "replaces": "tools/bench_gather.py:65",
        "launches": launches["gather_patches"],
        "max_abs_err": max([gframe["err"]]
                           + [g["err"] for g in gather.values()]),
        "ms": gframe["ms"], "plain_ms": gframe["plain_ms"],
        "bound_ms": gframe["bound_ms"], "bound_by": "bytes",
        "library_ms": gframe["library_ms"],
        "launches_per_p_frame": per_frame}
    print(f"# gather per speed-6 P frame ({per_frame:g} launches): kernel "
          f"{gframe['ms']:.5f} ms, summed byte bound "
          f"{gframe['bound_ms']:.5f} ms "
          f"({100 * gframe['bound_ms'] / gframe['ms']:.1f}%), empty "
          f"launches {per_frame * floor_ms:.5f} ms", flush=True)
    # launches on the main paths, each counted from 0 in its own run:
    # phase 15's speed-6 GOP, phase 13's speed-7 GOP and phase 16's
    # split8 keyframe
    by_path = {"gop6": dict(launches), "gop7": gop7_launches,
               "kf6_split8": kf6s_launches}
    for k in launches:
        launches[k] = sum(p.get(k, 0) for p in by_path.values())
    print(f"# launches on the main paths (phases 15, 13, 16): "
          f"{json.dumps(by_path)}", flush=True)

    def paths(k):
        return {p: n.get(k, 0) for p, n in by_path.items()}

    ec_entry["launches"] = launches["ec_pack"]
    ec_entry["launches_by_path"] = paths("ec_pack")
    gather_entry["launches_by_path"] = paths("gather_patches")
    replaces = {"cdef_dirs": "rav1e_tpu/ops/tpu/cdef.py:58",
                "cdef_ladder_sse": "rav1e_tpu/ops/tpu/cdef.py:281",
                "cdef_apply": "rav1e_tpu/ops/tpu/cdef.py:220"}
    frames = (n_p + 1) + (n_p7 + 1) + 1       # the three paths' frames
    cdef_entries = [
        {"name": k, "route": "cuda",
         "source": "rav1e_tpu_torch/csrc/cdef.cu", "replaces": replaces[k],
         "launches": launches[k], "launches_by_path": paths(k),
         "launches_per_frame": launches[k] / frames,
         "max_abs_err": 0, "ms": r[0],
         "plain_ms": r[1], "bound_ms": r[2], "bound_by": r[3],
         "library_ms": None} for k, r in cdef_ms.items()]
    entries = [ec_entry, gather_entry] + cdef_entries
    for e in entries:
        e["empty_launch_ms"] = floor_ms
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
