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
     a group) on random planes of the frame's shapes, and a speed-6
     1080p B frame's (SPEED6_B_GROUPS): equal to the plain version;
     kernel, plain and indexing ms, and the byte bound summed over the
     launches (each launch reads a plane's covered elements once);
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
  12-13. encode_gop_tpu at q 100 at 1920x288 (the depth cut, to keep
     the run short; 540 blocks, so the half-resolution search runs): KEY + 1 P at speed 10 (no split, no CDEF: the P
     frame's uniform 32-blocks), then KEY + 2 P at speed 7
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
     the C++ packer and by the Python TileWriter into an IRRecorder
     (use_native=False): the IRs equal row for row, the kernel's bytes
     on both equal pack_ir_plain + finish's; both walks' times;
  16. a speed-6 keyframe on a 1920x128 frame with phase 14's
     checkerboard every 256 px (the split8 gate on, quads split 16->8 at
     full width; the depth cut to keep the run short), counted as
     phase 15;
  17. the default reordered group (api/context.py at speed 6, bgroup =
     4) after phase 15's keyframe, on synth(1920, 1088, n=5) at q 100
     with cdef (0, 0, 0, 0, 3): the non-shown anchor P (frame 4), B0
     (frame 2, non-shown), B1 (frame 1), show-existing 3, B1 (frame 3),
     show-existing 1, each B with split and b64_rdo; the packets' sizes
     and SHA-256 prefixes must be BGROUP_PINS; each frame's launches
     (each B frame B_LAUNCHES, its gathers SPEED6_B_GROUPS; the anchor
     SPEED6_P_GROUPS), each B tile's IR coded again by pack_ir_plain,
     the B frames' shares of fwd, bwd, compound and split blocks and
     their stage times;
  17b. the two-reference frames on cuda vs on cpu at 256x192 on the fade
     + occluding-mover content of tests/_torch_content.py: a speed-6 KEY
     and phase 17's group, then a KEY -> P -> LAST + GOLDEN chain
     (encode_pframe2_tpu): every fetched decision (MVs, choice, skips,
     levels, split, mv16, CDEF map), the recons and the packets
     identical; B0 takes fwd, bwd and compound blocks and splits, the
     LAST + GOLDEN frame takes both references;
  18. the session API (api/context.py, the CLI): (a) the port's Context
     at its defaults (speed 6, reordered, lookahead 8) with
     min_key_frame_interval 4 on cuda and on cpu at 256x192, on 10 frames
     of two fade + occluding-mover groups (the cut at frame 5): packets,
     frame types, frame numbers and qps identical, the cut a KEY; (b) the
     lookahead's pair stats at 1920x1088 on panning content, cuda against
     cpu: mv and inter cost identical, intra within 1e-6 relative; device
     ms a frame pair; (c) synth(1920, 540, n=5) written as y4m and
     encoded by rav1e_tpu_torch.cli.main at its defaults on cuda with
     enc_stats (the 32-padding to 544 and render_size): each packet's
     type, frame, qp and bytes, each coded frame's wall seconds and
     launches (ec_pack and the CDEF kernels in every frame, the gather in
     every inter frame); where the port's dav1d shim loads libdav1d, the
     IVF decodes to 5 frames whose PSNR against the source is each
     packet's enc_stats (else a line says the decode was not run);
  19. 10-bit 4:2:0: (a) the three CDEF kernels on 10-bit planes (int16,
     read as uint16) against their plain versions as in phase 6, on
     phase 5's recon and source as 10-bit planes (to_10bit: x 4 plus a
     seeded dither in [0, 3]), sampled (1920x1088) and full (1920x1056)
     branches, the extremes and the noise past 2^24 scaled to 10 bits:
     max |err| 0, the blocks on each path, device ms and bounds; (b) at
     256x192 on cuda vs on cpu, on the fade + occluding-mover content as
     10-bit planes: after the 10-bit numpy keyframe, the default P frame
     and phase 17's reordered group (bit_depth=10), then the port's
     Context with bit_depth=10 on 10 frames with a cut: every decision,
     recon and packet identical; (c) the 10-bit reordered group at
     1920x1088 on cuda (synth(1920, 1088, n=5) as 10-bit planes on
     phase 15's keyframe recon << 2: not a decodable stream, since the
     10-bit numpy keyframe takes minutes at 1080p), each frame's
     launches and stage times, packets pinned in HBD_PINS (the CPU
     route's, made by `python3 chip_smoke.py --hbd-pins`);
  20. loop restoration and speeds 0-3: (a) the LRF search (ops/lrf.py)
     on phase 5's 1080p recon against its source, luma and U, and the
     luma as 10-bit planes, on cuda and on cpu: grids and filtered planes
     identical; per plane the warm call's wall ms, its kernel launches
     and device ms (torch.profiler) and the host argmin's ms; (b) a
     speed-2 Context (the numpy keyframe with HORZ/VERT partitions and
     LR, the 24-px anchor search, LR on every P and B frame) on cuda and
     on cpu at 256x192, 5 frames: packets, frame types, frame numbers
     and qps identical; (c) a
     keyframe with LR (encode_keyframe_tpu(lr=True)) and phase 17's group
     at speed 2 with lr on every frame (the anchor's 24-px search) at
     1920x1088 on cuda, each frame's launches and stage times (lr,
     tile_walk), packets pinned in LR_PINS (the CPU route's, made by
     `python3 chip_smoke.py --lr-pins`), decoded to the recons where
     libdav1d loads;
  21. tiles, variance AQ and the numpy routes: (a) phase 17's group at
     1920x1088 after phase 15's keyframe, without intra-in-inter (as a
     tiled session codes it), untiled and on a 2x2 tile grid on cuda:
     each tiled frame's recon equal to the untiled one's, each tiled
     frame one ec_pack launch for its four tiles (each tile's bytes equal
     to pack_ir_plain + finish on its IR), the anchor's T-tile launch
     timed against its bytes bound; (b) an AQ keyframe
     (encode_keyframe_tpu(aq=True), speed 10's mode sets, CDEF) at
     1920x1088 on cuda, its stages and launches, and the speed-6 AQ
     keyframe on cuda and on cpu at 256x192: packets identical; (c)
     Context sessions on cuda and on cpu, packets identical: tiles=4 at
     256x192 (5 frames), and `aq`, 4:2:2, 4:4:4, 12-bit, photon_noise,
     switch_frame_interval and error_resilient at 128x96 (4 frames);
  22. the multi-device layer, the C API and 12-bit LR: (a) the table and
     the filter with a column halo (the tiled CDEF search's) on phase
     5's recon in 2 tile columns, each shard against the plain versions
     and the shards against the unsharded table and cdef_apply, their
     device ms and bounds; then phase 15's frame 1 as a P frame in 2
     tile columns (parallel/tile_encode.py::encode_pframe_tiled, two
     shards on two cards where there are two, else both on cuda:0, each
     on its own thread and stream) on phase 15's keyframe recon: packet
     and recon against TILED_PINS (the CPU route's, made by `python3
     chip_smoke.py --tiled-pins`), the gather and each CDEF kernel
     launched by each shard and ONE ec_pack launch for both tiles, the
     wall and each kernel's device ms (torch.profiler); the same at
     256x192 on cuda against the CPU route; (b) GopScheduler over two
     workers encoding two GOPs, each phase 15's frames 0-1 at speed 6:
     phase 15's first two packets each (two workers of one card take
     turns), the wall beside phase 15's GOP; (c) the C API (capi/capi.c, built with g++ in
     the run; it fails if Python.h is missing) through ctypes on cuda at
     256x192: packets equal to Config(...).new_context()'s; (d) a 12-bit
     speed-2 Context (LR searched on the host) at 256x192, cuda against
     cpu (KEY + P); (e) parallel/dryrun.py::dryrun_multichip over every
     card. Phases 18c (1920x540, 5 frames), 20b (5 frames) and 21c (5
     and 4 frames) are cut in depth to make room for it.

Each phase group prints the seconds since the start when it is done.
Phases 5, 7-16 print the packer call (NativeTileWriter method) each
frame took. Prints a kernels JSON line (launches: phases 15, 13, 16, 17,
18c, 19c, 20c, 21a's tiled group, 22a's tiled P frame and 22b's GOPs
together, and each path's own count,
every count set to 0 just before its path; ec_pack's tiled_* keys are
21a's T-tile launch; the gather's ms, bound and plain and indexing ms
are phase 4's replayed speed-6 P frame, with its launches a P frame,
and the replayed B frame's beside them; the CDEF kernels' launches per
frame of those paths and their ms per 1080p frame, their 10-bit ms and
bounds from phase 19a and their halo forms' from phase 22a beside
them), then, as the last line,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, printing no result, without CUDA or without the
rav1e_tpu_torch package beside it.

    python3 chip_smoke.py --bgroup-pins

encodes phase 15's keyframe on cuda, then phase 17's group on the CPU
route (device="cpu"), and prints the BGROUP_PINS that phase 17 checks;

    python3 chip_smoke.py --hbd-pins

does the same for phase 19c's 10-bit group and prints HBD_PINS, and

    python3 chip_smoke.py --lr-pins

for phase 20c's LR keyframe and group, LR_PINS, and

    python3 chip_smoke.py --tiled-pins

for phase 22a's tiled P frame (the keyframe on cuda, the frame on two
CPU shards), TILED_PINS.
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
    """While entered, keeps every tile the C++ packer walks (from any
    thread): (the NativeTileWriter method that walked it, the writer's
    device, its IR on the host, its bytes). A tile coded by its writer is
    kept as it is coded; a tile walked for its frame's one ec_pack launch
    (ir_only) as tpu_inter's pack_tile_irs codes the frame's tiles."""

    METHODS = ("write_intra_tile_fast", "write_inter_tile_fast2",
               "write_tile")

    def __init__(self, native):
        from rav1e_tpu_torch.pipeline import tpu_inter
        self.W, self.tp = native.NativeTileWriter, tpu_inter
        self.got = []

    def __enter__(self):
        W, got = self.W, self.got
        self.saved = {m: W.__dict__[m]
                      for m in self.METHODS + ("code", "_finish")}
        self.saved_pack = self.tp.pack_tile_irs
        walked, lock = {}, threading.Lock()

        def walking(m, f):
            def walk(w, *a, **k):
                w.walked = m
                return f(w, *a, **k)
            return walk

        for m in self.METHODS:
            setattr(W, m, walking(m, self.saved[m]))
        code, finish = self.saved["code"], self.saved["_finish"]

        def coding(w, ir):
            tile = code(w, ir)
            got.append((w.walked, str(w.device), ir.clone(), tile))
            return tile

        def finishing(w):
            out = finish(w)
            if w.ir_only:
                with lock:
                    walked[id(out)] = (getattr(w, "walked", None),
                                       str(w.device), out)
            return out

        pack = self.saved_pack

        def pack_tiles(irs, *a, **k):
            tiles = pack(irs, *a, **k)
            with lock:
                kept = [walked.pop(id(ir), None) for ir in irs]
            got.extend((g[0], g[1], ir.clone(), tile)
                       for g, ir, tile in zip(kept, irs, tiles)
                       if g is not None)
            return tiles

        W.code, W._finish = coding, finishing
        self.tp.pack_tile_irs = pack_tiles
        return self

    def __exit__(self, *exc):
        for m, f in self.saved.items():
            setattr(self.W, m, f)
        self.tp.pack_tile_irs = self.saved_pack
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


def _dirs_ops(bd: int = 8):
    """cdef_dirs' least work an 8x8 block, one op an instruction: each
    bin's sum of x - 128 as __dp4a words (4 pixels of one bin a word, the
    -128 n in the first word's accumulator), a square and a multiply-add
    by 840 / n a bin, the argmax of the 8 costs (a compare and two
    selects a step) and var (a subtract and a shift); above 8 bits, one
    more a pixel for px >> (bd - 8)."""
    words = bins = 0
    for b in _tests_content().DIR_BINS:
        n = np.bincount(b.ravel())
        words += int(((n + 3) // 4).sum())
        bins += len(n)
    return words + 2 * bins + 3 * 7 + 2 + (64 if bd > 8 else 0)


def cdef_phase(torch, cd, planes_d, srcs_d, skip8, floor_ms, bd: int = 8):
    """Phase 6 on one frame (contiguous uint8 planes, as cdef_search_persb
    gives them; phase 19a: int16 planes of 10-bit values, bd=10): every
    CDEF kernel against its plain version on the same
    inputs (dir, var, the SSE tables and the applied planes exactly
    equal; one launch a frame for the table and for the apply, the plain
    version per plane), the blocks on each path, device ms (CUDA events,
    mean of 3) of kernel and plain, and the bound (cdef_apply's on the
    map of every entry), which no kernel may beat, and the empty launch
    (floor_ms) beside it. Returns {kernel: (ms, plain_ms, bound_ms,
    bound_by)} for one frame's three planes."""
    h, w = planes_d[0].shape
    tag = f"{w}x{h}" + ("" if bd == 8 else f" {bd}-bit")
    px = planes_d[0].element_size()        # bytes a pixel
    sampled = h % 64 == 0 and w % 64 == 0
    dirs, var = cd.cdef_dirs(planes_d[0], bd)
    dp, vp = cd.cdef_dirs_plain(planes_d[0], bd)
    if not (torch.equal(dirs, dp) and torch.equal(var, vp)):
        fail(f"{tag}: cdef_dirs kernel and plain version differ")
    res = {}
    nb = dirs.numel()
    t_b = (px * h * w + 5 * nb) / H100_BYTES_PER_S * 1e3
    t_o = _dirs_ops(bd) * nb / H100_INT_OPS_PER_S * 1e3
    # a launch of a few us: the mean of 20 (3 add about 1 us a launch)
    res["cdef_dirs"] = [
        time_cuda(torch, lambda: cd.cdef_dirs(planes_d[0], bd), 20),
        time_cuda(torch, lambda: cd.cdef_dirs_plain(planes_d[0], bd), 3),
        max(t_b, t_o), "bytes" if t_b >= t_o else "operations"]
    damping = CDEF_SPEED8[4]
    largs = (planes_d, srcs_d, dirs, var, skip8, damping, sampled, bd)
    sses, lpaths = _paths(torch, cd, lambda: cd.cdef_ladder_sse(*largs))

    def ladder_plain():
        return [cd.cdef_ladder_sse_plain(p, s, dirs, var, skip8, damping,
                                         i > 0, sampled, bd)
                for i, (p, s) in enumerate(zip(planes_d, srcs_d))]

    for i, want in enumerate(ladder_plain()):
        if not torch.equal(sses[i], want):
            fail(f"{tag} plane {i}: cdef_ladder_sse kernel and plain "
                 f"version differ (max |err| "
                 f"{float((sses[i] - want).abs().max())})")
    # the strengths scale by 2^(bd - 8), which leaves every count below
    # as it is (an adjusted strength is > 0, or two are distinct, at
    # every bit depth alike); the bytes scale by the pixel's size
    t_o = t_b = 0.0
    for i, p in enumerate(planes_d):
        chroma = i > 0
        ph, pw = p.shape
        mask = (_sampled_mask(torch, ph, pw, 16 if chroma else 32, p.device)
                if sampled else None)
        t_o += _cdef_ladder_ops(torch, cd, var, skip8, chroma,
                                mask) / H100_INT_OPS_PER_S * 1e3
        t_b += (2 * px * ph * pw
                + 32 * sses[i][0].numel()) / H100_BYTES_PER_S * 1e3
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
                                    kw.get("idx"), *(st[2:] if i else st[:2]),
                                    bd)
                for i, p in enumerate(planes_d)]

    # the winners, every entry, and the uniform mode with chroma's primary
    # strength 0 (direction 0)
    apaths = {}
    for name, kw in (("winners", {"idx": idx}), ("every", {"idx": every}),
                     ("uniform", {"strengths": (3, 1, 0, 2)})):
        got, apaths[name] = _paths(torch, cd, lambda: cd.cdef_apply(
            *aargs, **kw, bd=bd))
        if not all(torch.equal(a, b) for a, b in zip(got, apply_plain(**kw))):
            fail(f"{tag}: cdef_apply kernel and plain version differ on "
                 f"the {name} map")
    # timed and bounded on `every` (7 of 8 SBs filtered, at every entry);
    # the winners' map of this frame may filter nothing
    t_o = t_b = 0.0
    ent = cd._upsample(every, 8)[:h // 8, :w // 8]   # per 8x8 luma unit
    for i, p in enumerate(planes_d):
        t_o += _cdef_ops(torch, cd, var, skip8, i > 0,
                         ent) / H100_INT_OPS_PER_S * 1e3
        t_b += 2 * px * p.numel() / H100_BYTES_PER_S * 1e3
    res["cdef_apply"] = [
        time_cuda(torch, lambda: cd.cdef_apply(*aargs, idx=every, bd=bd), 3),
        time_cuda(torch, lambda: apply_plain(idx=every), 3), max(t_b, t_o),
        "operations" if t_o >= t_b else "bytes"]
    winners_ms = time_cuda(torch, lambda: cd.cdef_apply(*aargs, idx=idx,
                                                        bd=bd), 3)
    print(f"# CDEF kernels vs plain at {tag} ("
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
    print(f"# CDEF paths at {tag}: cdef_ladder_sse blocks "
          f"{json.dumps({k: v for k, v in lpaths.items() if 'ladder' in k})}"
          "; cdef_apply (SB, plane) pairs by map "
          + json.dumps({m: {k: v for k, v in c.items() if 'apply' in k}
                        for m, c in apaths.items()}), flush=True)
    beaten = [k for k, r in res.items() if r[0] < r[2]]
    if beaten:
        fail(f"{tag}: {beaten} ran in less than its bound: the count "
             "is no floor")
    return res


def to_10bit(p, rng):
    """An 8-bit plane as 10-bit values: p << 2 plus a dither in [0, 3]
    (int16)."""
    p = np.asarray(p).astype(np.int16) << 2
    return p + rng.integers(0, 4, p.shape).astype(np.int16)


def dirs_extremes(torch, cd, bd: int = 8):
    """Phase 6, cdef_dirs at its extremes: dir_extremes' blocks, on an
    8-byte-aligned and a misaligned base (the wrapper copies it), and a
    1928x1088 frame (width 8 past a multiple of 64, the last thread block
    of each row partly outside it): kernel and plain version equal; the
    all-black block gives dir 0, var 0. Phase 19a (bd=10): the same
    content as 10-bit int16 planes (to_10bit), and 10-bit noise."""
    rng = np.random.default_rng(29)
    ext = np.tile(_tests_content().dir_extremes(), (2, 1))
    wide = synth(1928, 1088)[0][0]
    if bd == 8:
        dt = torch.uint8
        noise = rng.integers(0, 256, (1088, 1928)).astype(np.uint8)
    else:
        dt = torch.int16
        ext, wide = to_10bit(ext, rng), to_10bit(wide, rng)
        noise = rng.integers(0, 1 << bd, (1088, 1928)).astype(np.int16)
    y = torch.from_numpy(ext).cuda()
    flat = torch.empty(y.numel() + 1, dtype=dt, device="cuda")
    odd = flat[1:].view(y.shape)
    odd.copy_(y)
    wide = torch.from_numpy(wide).cuda()
    noisy = torch.from_numpy(noise).cuda()
    for what, p in (("extreme blocks", y), ("a misaligned base", odd),
                    ("1928x1088 synth", wide), ("1928x1088 noise", noisy)):
        d, v = cd.cdef_dirs(p, bd)
        dp, vp = cd.cdef_dirs_plain(p, bd)
        if not (torch.equal(d, dp) and torch.equal(v, vp)):
            fail(f"cdef_dirs ({bd}-bit) on {what}: kernel and plain version "
                 "differ")
    d, v = cd.cdef_dirs(y, bd)
    if int(d[0, 0]) != 0 or int(v[0, 0]) != 0:
        fail(f"cdef_dirs ({bd}-bit) on the all-black block: dir "
             f"{int(d[0, 0])}, var {int(v[0, 0])}, expected 0, 0")
    print(f"# cdef_dirs ({bd}-bit) at its extremes (all 0, all max, a ramp "
          f"and stripes along each direction, random; a misaligned base; "
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


def cdef_past_2_24(torch, cd, bd: int = 8):
    """Phase 6, past 2^24: on noise at q 255, 256x192 (sampled branch)
    and 160x96 with a heavier error (full branch), the SSE tables of the
    kernel (the blocks past 2^24 on its ordered path) and of the plain
    version on the card, and the search's index and filtered planes on
    cuda and on cpu, exactly equal; a luma cell passes 2^24, where the
    order of the f32 sum decides. Phase 19a (bd=10): the same noise
    scaled to 10 bits (x 4, int16 planes)."""
    up, dt = (1, np.uint8) if bd == 8 else (1 << (bd - 8), np.int16)
    for w, h, seed, scale in ((256, 192, 19, 1), (160, 96, 11, 4)):
        rec, src, skip8 = noise_at_q255(w, h, seed, scale)
        sampled = h % 64 == 0 and w % 64 == 0
        dev = {d: ([torch.from_numpy((p * up).astype(dt)).to(d)
                    for p in rec],
                   [torch.from_numpy((p * up).astype(dt)).to(d)
                    for p in src],
                   torch.from_numpy(skip8).to(d)) for d in ("cuda", "cpu")}
        rd, sd, kd = dev["cuda"]
        dirs, var = cd.cdef_dirs(rd[0], bd)
        got, paths = _paths(torch, cd, lambda: cd.cdef_ladder_sse(
            rd, sd, dirs, var, kd, 3, sampled, bd))
        for i in range(3):
            if not torch.equal(got[i], cd.cdef_ladder_sse_plain(
                    rd[i], sd[i], dirs, var, kd, 3, i > 0, sampled, bd)):
                fail(f"{w}x{h} {bd}-bit noise plane {i}: cdef_ladder_sse "
                     "kernel and plain version differ")
        top = float(got.max())
        if top < 2 ** 24:
            fail(f"{w}x{h} noise: no cell passes 2^24 ({top})")
        if paths["ladder_ordered"] < 1:
            fail(f"{w}x{h} noise: no block took the ordered path ({paths})")
        same = []
        for lam in (None, 60.0, 2000.0):
            out = {d: cd.cdef_search_persb(
                *dev[d], 3, lam=None if lam is None
                else torch.tensor(lam, device=d), bd=bd) for d in dev}
            same.append(torch.equal(out["cuda"][0].cpu(), out["cpu"][0])
                        and all(torch.equal(a.cpu(), b) for a, b in
                                zip(out["cuda"][1], out["cpu"][1])))
        print(f"# CDEF past 2^24 at {w}x{h} {bd}-bit (noise at q 255, "
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
# a 1080p B frame's gathers (phase 17 must launch exactly these on each):
# both references' descent patches; their six re-judge MCs (three
# candidates each); their U/V windows at the chosen MVs
SPEED6_B_GROUPS = (((43, 2040) + _Y,) * 2,
                   ((39, 2040) + _Y,) * 6,
                   ((23, 2040) + _C,) * 4)


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
    events, mean of 20 launches) and the byte bound. Then a speed-6 P
    frame's gathers (SPEED6_P_GROUPS) and a B frame's (SPEED6_B_GROUPS)
    replayed as the main path groups them, on random planes of the
    frame's shapes. Returns ({(P, B): numbers}, the P frame's numbers, the
    B frame's)."""
    rng = np.random.default_rng(5)
    out = {}
    planes = {}
    starts = {}
    for P, H, W, blk, B, ncol in GATHER_SHAPES:
        # two luma references; the U and V planes of two references
        planes.setdefault((H, W), [torch.from_numpy(
            rng.integers(0, 256, (H, W)).astype(np.int32)).cuda()
            for _ in range(2 if (H, W) == _Y else 4)])
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
    shape = {(P, B, H, W): (blk, ncol)
             for P, H, W, blk, B, ncol in GATHER_SHAPES}

    def replay(spec, what, plane_of):
        """The frame's gathers grouped as the main path launches them,
        plane_of(group, item) picking each item's plane."""
        groups = []
        for g in spec:
            items = []
            for i, (P, B, H, W) in enumerate(g):
                blk, ncol = shape[(P, B, H, W)]
                items.append((planes[(H, W)][plane_of(g, i)],
                              *_gather_starts(torch, rng, P, H, W, blk, B,
                                              ncol), P))
            groups.append(items)

        def frame():
            return [gp.gather_patches_many(g) for g in groups]

        def frame_plain():
            return [gp.gather_patches_many_plain(g) for g in groups]

        n0 = gp.gather_patches_many.launches
        got = frame()
        if gp.gather_patches_many.launches - n0 != len(groups):
            fail(f"the replayed {what} took other than one launch a group")
        err = 0
        for gg, gw in zip(got, frame_plain()):
            for a, b in zip(gg, gw):
                err = max(err, int((a - b).abs().max()))
                if not torch.equal(a, b):
                    fail(f"the replayed {what}'s gathers differ from the "
                         f"plain version (max |err| {err})")
        calls = [_indexing(torch, gp, *it) for g in groups for it in g]
        fr = {"ms": time_cuda(torch, frame, 20),
              "plain_ms": time_cuda(torch, frame_plain, 20),
              "library_ms": time_cuda(torch, lambda: [c() for c in calls],
                                      20),
              "bound_ms": sum(_gather_bound(torch, gp, g) for g in groups),
              "launches": len(groups), "err": err}
        print(f"# gather, a {what} replayed ({len(groups)} launches, "
              f"{sum(map(len, groups))} gathers, groups "
              f"{[[it[:2] for it in g] for g in spec]}): kernel "
              f"{fr['ms']:.5f} ms, plain {fr['plain_ms']:.5f} ms, indexing "
              f"calls {fr['library_ms']:.5f} ms, summed byte bound "
              f"{fr['bound_ms']:.5f} ms "
              f"({100 * fr['bound_ms'] / fr['ms']:.1f}% of it; "
              f"{len(groups)} empty launches "
              f"{len(groups) * floor_ms:.5f} ms), max |err| {err}",
              flush=True)
        return fr

    # a P frame: one luma reference, a chroma group's items U and V; a B
    # frame: each group's first half the fwd reference's, the second the
    # bwd one's (chroma: U, V of fwd, then of bwd)
    pf = replay(SPEED6_P_GROUPS, "speed-6 1080p P frame",
                lambda g, i: 0 if g[i][2:] == _Y else i)
    bf = replay(SPEED6_B_GROUPS, "speed-6 1080p B frame",
                lambda g, i: i // (len(g) // 2) if g[i][2:] == _Y else i)
    return out, pf, bf


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
    items' (P, B, plane H, W), P frames, stage times, packets, recons)."""
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
    from rav1e_tpu_torch.trace import Stages
    orig_mark = Stages.mark

    def mark(stages, name, n=None):
        orig_mark(stages, name, n)
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
    Stages.mark = mark
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
        Stages.mark = orig_mark
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
            m != "write_inter_tile_fast2" for m in methods[1:]):
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
    return launches, sizes, n_p, timings, pkts, recs


class CapturedIR:
    """While entered, keeps the IR and bytes of every tile that
    tpu_inter's pack_tile_irs codes, in order, in .got: the Python
    TileWriter's walks (the keyframe's and the inter frames', each coded
    after its walk) and the tiled C++ walks."""

    def __init__(self, tp):
        self.tp, self.got = tp, []

    def __enter__(self):
        got, pack = self.got, self.tp.pack_tile_irs
        self.saved = pack

        def pack_tiles(irs, *a, **k):
            tiles = pack(irs, *a, **k)
            got.extend(zip([ir.clone() for ir in irs], tiles))
            return tiles

        self.tp.pack_tile_irs = pack_tiles
        return self

    def __exit__(self, *exc):
        self.tp.pack_tile_irs = self.saved
        return False


def packer_vs_writer(torch, ec, native, ti, tp, record):
    """Phase 15b: each frame of phase 15's GOP packed again from the
    same decisions, by the C++ packer and by the Python TileWriter into
    an IRRecorder (use_native=False), one after the other on this
    thread: the two IRs must be equal row for row, and the kernel's
    bytes on each must be pack_ir_plain + finish's."""
    def order(c):
        return 0 if c[0] == "key" else c[1][3]

    with CapturedIR(tp) as py:
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
            del py.got[:]
            pkt_p = run(False, t_p)
            (method, _, ir_n, tile_n), (ir_p, tile_p) = (calls.got[0],
                                                         py.got[0])
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


# the reordered group's packets in coding order (the non-shown anchor P,
# B0, B1, show-existing 3, B1, show-existing 1) after phase 15's keyframe
# of synth(1920, 1088, n=5) at q 100 with cdef (0, 0, 0, 0, 3): (bytes,
# SHA-256 prefix) from the port's CPU route (device="cpu") on the H100
# machine's host, whose packets equal the JAX package's at every test
# shape (tests/test_torch_bframe.py); made by
# `python3 chip_smoke.py --bgroup-pins`
BGROUP_PINS = [(30684, "610e340bbe53fed5"), (5372, "39d31b4932536438"),
               (1951, "84e2ee92a6da14e1"), (5, "479f23cb97654286"),
               (2406, "0d6f4e700308289c"), (5, "f5ed02db3266a088")]


def reordered_group(tp, frames, krec, device, run=None, bit_depth=8,
                    speed=6, lr=False, tile_grid=None, intra=True):
    """The group api/context.py codes at `speed` (6) with bgroup = 4 after
    a keyframe (frames[0], its recon krec, slot 0, order hint 0), at q 100
    with cdef (0, 0, 0, 0, 3): the non-shown anchor P (frame 4, refreshing
    slot 1; the speed's P tools and search), B0 (frame 2 on KEY and the
    anchor, non-shown, refreshing slot 3), B1 (frame 1 on KEY and B0),
    show-existing 3, B1 (frame 3 on B0 and the anchor), show-existing 1;
    every frame with loop restoration when lr; tile_grid (cols_log2,
    rows_log2) codes every frame in tiles; intra=False turns the anchor's
    intra-in-inter off (a tiled session's anchor has none). run(label,
    fn, *a, **k) calls each frame's entry point (default: fn(*a, **k)).
    Returns (the packets in coding order, {frame: recon int32 planes}).
    bit_depth: the frames' (8 or 10, phase 19)."""
    from rav1e_tpu_torch.api.speed import SpeedSettings
    from rav1e_tpu_torch.entropy.obu import show_existing_packet
    ss = SpeedSettings.from_preset(speed)
    run = run or (lambda label, fn, *a, **k: fn(*a, **k))
    kw = dict(cdef=CDEF_SPEED8, device=device, bit_depth=bit_depth, lr=lr,
              tile_grid=tile_grid)
    bkw = dict(kw, b64_rdo=ss.b64_merge, use_split=ss.partition_split_rdo)
    kref = (krec if bit_depth > 8
            else [np.asarray(r, np.uint8) for r in krec])
    apkt, arec = run("anchor P (frame 4)", tp.encode_pframe_tpu, frames[4],
                     kref, 100,
                     order_hint=4, refresh_flags=1 << 1, ref_slot=0,
                     show_frame=False, use_split=ss.partition_split_rdo,
                     use_satd=ss.satd_subpel, refine16=ss.mv_refine_16,
                     intra_rdo=ss.intra_in_inter and intra,
                     b64_rdo=ss.b64_merge, search=ss.search_px,
                     subpel=ss.subpel, use_split8=ss.partition_split8, **kw)
    b0, r0 = run("B0 (frame 2)", tp.encode_bframe_tpu, frames[2], krec, arec, 100,
                 order_hint=2, slot_fwd=0, slot_bwd=1, ref_hints=(0, 4),
                 refresh_flags=1 << 3, show_frame=False, **bkw)
    b1, r1 = run("B1 (frame 1)", tp.encode_bframe_tpu, frames[1], krec, r0, 100,
                 order_hint=1, slot_fwd=0, slot_bwd=3, ref_hints=(0, 2),
                 **bkw)
    b3, r3 = run("B1 (frame 3)", tp.encode_bframe_tpu, frames[3], r0, arec, 100,
                 order_hint=3, slot_fwd=3, slot_bwd=1, ref_hints=(2, 4),
                 **bkw)
    pkts = [apkt, b0, b1, show_existing_packet(3), b3, show_existing_packet(1)]
    return pkts, {1: r1, 2: r0, 3: r3, 4: arec}


def _pins(pkts):
    import hashlib
    return [(len(p), hashlib.sha256(p).hexdigest()[:16]) for p in pkts]


def bgroup_pins(torch, ti, tp):
    """`--bgroup-pins`: phase 15's keyframe on cuda (its packet must be
    GOP6_BYTES[0] bytes, the JAX package's), then phase 17's group on the
    CPU route (device="cpu"). Prints BGROUP_PINS."""
    frames = synth(1920, 1088, n=5)
    kpkt, krec = ti.encode_keyframe_tpu(frames[0], 100, cdef=CDEF_SPEED8,
                                        device="cuda")
    if len(kpkt) != GOP6_BYTES[0]:
        fail(f"the keyframe took {len(kpkt)} bytes, not {GOP6_BYTES[0]}")
    t0 = time.perf_counter()
    pkts, _ = reordered_group(tp, frames, krec, "cpu")
    print(f"# the reordered group on the CPU route in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(f"BGROUP_PINS = {_pins(pkts)}", flush=True)
    return 0


# a B frame's kernel launches on the main path: its gathers in three
# groups, the three CDEF kernels once each, one od_ec launch for its tile
B_LAUNCHES = {"gather_patches": 3, "ec_pack": 1, "cdef_dirs": 1,
              "cdef_ladder_sse": 1, "cdef_apply": 1}


def bgroup_1080p(torch, ec, gp, cd, tp, krec, kpkt):
    """Phase 17: the reordered group after phase 15's keyframe (its packet
    kpkt and recon krec) on cuda, every kernel's count set to 0 just
    before it and read just after, and per frame: packets against
    BGROUP_PINS; each frame's launches and gather groups (the anchor:
    SPEED6_P_GROUPS; each B frame: SPEED6_B_GROUPS and B_LAUNCHES); each B
    tile's IR coded again by pack_ir_plain gives its bytes; the B frames'
    shares of fwd, bwd, compound and split blocks and stage times.
    Returns ({kernel: launches}, B frames, [(label, stage times)])."""
    frames = synth(1920, 1088, n=5)
    kern = {"gather_patches": gp.gather_patches_many, "ec_pack": ec.pack_ir,
            "cdef_dirs": cd.cdef_dirs, "cdef_ladder_sse": cd.cdef_ladder_sse,
            "cdef_apply": cd.cdef_apply}
    groups: dict = {}
    saved = tp.gather_patches_many

    def counting_gather(items):
        items = list(items)
        key = tuple((P, int(r0.shape[0])) + tuple(plane.shape)
                    for plane, r0, _, P in items)
        groups[key] = groups.get(key, 0) + 1
        return saved(items)

    rows = []

    def run(label, fn, *a, **k):
        groups.clear()
        before = {n: f.launches for n, f in kern.items()}
        got, restore = _recording_fetch(tp)
        t = {}
        try:
            out = fn(*a, timings=t, **k)
        finally:
            restore()
        rows.append((label, {n: f.launches - before[n]
                             for n, f in kern.items()},
                     dict(groups), t, got[0]))
        return out

    tp.gather_patches_many = counting_gather
    try:
        with CapturedIR(tp) as cap:
            for f in kern.values():
                f.launches = 0
            t0 = time.perf_counter()
            pkts, recs = reordered_group(tp, frames, krec, "cuda", run=run)
            wall = time.perf_counter() - t0
            launches = {n: f.launches for n, f in kern.items()}
    finally:
        tp.gather_patches_many = saved
    pins = _pins(pkts)
    print(f"# 1920x1088 reordered group (KEY from phase 15, anchor P, B0, B1, "
          f"SEF 3, B1, SEF 1; speed 6, q 100, cdef {CDEF_SPEED8}, cuda): "
          f"{wall:.3f} s after the keyframe; packets {[len(kpkt)]} + "
          f"{[n for n, _ in pins]} bytes, SHA-256 {[h for _, h in pins]}; "
          f"the CPU route's (BGROUP_PINS) {BGROUP_PINS}; launches "
          f"{json.dumps(launches)}", flush=True)
    want_b = {g: 1 for g in SPEED6_B_GROUPS}
    want_p = {g: 1 for g in SPEED6_P_GROUPS}
    for label, n, g, t, dec in rows:
        d = dict(zip(FETCHED6, dec))
        ch = np.bincount(d["choice"], minlength=4)[:3] / d["choice"].size
        print(f"# {label}: shares of 32-blocks fwd / bwd / compound "
              f"{ch.round(4).tolist()}, split {float(d['split'].mean()):.4f}"
              f"; launches {json.dumps(n)}; gather groups (P, B, plane) "
              f"{g}; stages (s) "
              + json.dumps({k: round(v, 4) for k, v in t.items()}),
              flush=True)
        if label.startswith("anchor"):
            if g != want_p:
                fail(f"the anchor launched the gather groups {g}, not "
                     f"{want_p}")
            idle = [k for k, v in n.items() if v < 1]
            if idle:
                fail(f"the anchor launched no {idle}")
        else:
            if n != B_LAUNCHES or g != want_b:
                fail(f"{label} launched {n} in the gather groups {g}, not "
                     f"{B_LAUNCHES} in {want_b}")
            if d["b64_map"].any():
                fail(f"{label} merged a 64x64 SB")
    # the anchor's tile (the C++ walk) and the three B frames' (the
    # Python walk), each coded by pack_tile_irs
    coded = (0, 1, 2, 4)
    ends = sorted(next((i for i in coded if pkts[i].endswith(tile)), -1)
                  for _, tile in cap.got)
    if ends != list(coded):
        fail(f"{len(cap.got)} tiles coded by pack_tile_irs end the packets "
             f"{ends}, not the anchor's and the 3 B frames' {list(coded)}")
    for ir, tile in cap.got:
        c_p, st_p = ec.pack_ir_plain(ir)
        if tile != ec.finish(c_p.tolist(), *st_p[:3].tolist()):
            fail("a tile's IR coded by pack_ir_plain is not its bytes")
    print(f"# the group's tiles' IR ({[int(ir.shape[0]) for ir, _ in cap.got]}"
          " rows) re-coded by pack_ir_plain: identical bytes", flush=True)
    for i, rec in recs.items():
        if [tuple(r.shape) for r in rec] != [p.shape for p in frames[i]] or \
                any(r.min() < 0 or r.max() > 255 for r in rec):
            fail(f"frame {i}: recon shapes wrong or outside 0..255")
    if pins != BGROUP_PINS:
        fail(f"the reordered group's packets {pins}, pinned {BGROUP_PINS}")
    return launches, 3, [(r[0], r[3]) for r in rows]


def bgroup_gpu_vs_cpu(tp, ti, w, h):
    """Phase 17b: a KEY + the reordered group (speed 6, cdef) and a KEY ->
    P -> LAST + GOLDEN P chain at w x h on cuda and on cpu, on the fade +
    occluding-mover content of tests/_torch_content.py: every fetched
    decision (MVs, choice, skips, levels, split, mv16, CDEF map, ...), the
    recons and the packets identical; B0 takes fwd, bwd and compound
    blocks and splits a 32-block, the LAST + GOLDEN frame both
    references."""
    frames = _tests_content().bgroup(w, h, n=5)
    res = {}
    for d in ("cuda", "cpu"):
        got, restore = _recording_fetch(tp)
        try:
            kpkt, krec = ti.encode_keyframe_tpu(frames[0], 100,
                                                cdef=CDEF_SPEED8, device=d)
            pkts, recs = reordered_group(tp, frames, krec, d)
            ppkt, prec = tp.encode_pframe_tpu(
                frames[1], [r.astype(np.uint8) for r in krec], 100,
                order_hint=1, cdef=CDEF_SPEED8, device=d)
            mpkt, mrec = tp.encode_pframe2_tpu(
                frames[2], prec, krec, 100, order_hint=2, cdef=CDEF_SPEED8,
                use_satd=True, device=d)
        finally:
            restore()
        res[d] = ([kpkt] + pkts + [ppkt, mpkt],
                  [krec] + list(recs.values()) + [prec, mrec], got)
    (pk_g, rc_g, g), (pk_c, rc_c, c) = res["cuda"], res["cpu"]
    bad = []
    for i, (a, b) in enumerate(zip(g, c)):
        bad += [f"frame {i} {k}" for k, x, y in zip(FETCHED6, a, b)
                if not np.array_equal(x, y)]
    if not all(np.array_equal(np.asarray(x, np.int32), np.asarray(y, np.int32))
               for ra, rb in zip(rc_g, rc_c) for x, y in zip(ra, rb)):
        bad.append("recon")
    same = [a == b for a, b in zip(pk_g, pk_c)]
    b0 = dict(zip(FETCHED6, c[1]))
    m2 = dict(zip(FETCHED6, c[-1]))
    kinds = np.bincount(b0["choice"], minlength=3).tolist()
    print(f"# {w}x{h} KEY + reordered group and KEY -> P -> LAST + GOLDEN, "
          f"cuda vs cpu: differing {bad or 'nothing'}; packets identical "
          f"{same} ({[len(p) for p in pk_c]} bytes); B0 blocks fwd / bwd / "
          f"compound {kinds}, split {int(b0['split'].sum())}; LAST / GOLDEN "
          f"blocks {np.bincount(m2['choice'], minlength=2).tolist()}",
          flush=True)
    if bad or not all(same):
        fail(f"the {w}x{h} two-reference frames differ between cuda and "
             f"cpu: {bad}, packets identical {same}")
    if min(kinds[:3]) < 1 or not b0["split"].any() or \
            len(set(m2["choice"].tolist())) < 2:
        fail(f"the {w}x{h} B0 or LAST + GOLDEN frame lacks a block kind")


def _session(ctx, frames):
    """Send every frame to a Context, flush and drain it: its packets."""
    for f in frames:
        ctx.send_frame(f)
    ctx.flush()
    pkts = []
    while True:
        _, p = ctx.receive_packet()
        if p is None:
            return pkts
        pkts.append(p)


def session_gpu_vs_cpu(w: int = 256, h: int = 192):
    """Phase 18a: the port's Context at its defaults (speed 6, reordered,
    lookahead 8) with min_key_frame_interval=4 on cuda and on cpu, on 10
    frames: tests/_torch_content.py's fade + occluding-mover group and
    another from another seed (the scene cut at frame 5). Packets, frame
    types, frame numbers and qps identical; the cut coded as a KEY."""
    from rav1e_tpu_torch.api import Config
    c = _tests_content()
    frames = c.bgroup(w, h, n=5) + c.bgroup(w, h, n=5, seed=32)
    res = {}
    for d in ("cuda", "cpu"):
        t0 = time.perf_counter()
        pkts = _session(Config(width=w, height=h, min_key_frame_interval=4
                               ).new_context(device=d), frames)
        res[d] = ([(p.frame_type, p.input_frameno, p.qp) for p in pkts],
                  [p.data for p in pkts], time.perf_counter() - t0)
    (kinds, data, t_g), (kinds_c, data_c, t_c) = res["cuda"], res["cpu"]
    same = [a == b for a, b in zip(data, data_c)]
    print(f"# {w}x{h} session (Config defaults, min_key_frame_interval 4, "
          f"10 frames with a cut) cuda {t_g:.2f} s vs cpu {t_c:.2f} s: "
          f"packets identical {same}; (type, frame, qp) {kinds}; bytes "
          f"{[len(b) for b in data]}", flush=True)
    if kinds != kinds_c or len(data) != len(data_c) or not all(same):
        fail(f"the {w}x{h} session differs between cuda and cpu: "
             f"{kinds} vs {kinds_c}, packets identical {same}")
    keys = [n for t, n, _ in kinds if t == "KEY"]
    if keys != [0, 5]:
        fail(f"the {w}x{h} session's keyframes are frames {keys}, not the "
             "first and the cut (0, 5)")


def lookahead_gpu_vs_cpu(torch, w: int = 1920, h: int = 1088):
    """Phase 18b: the lookahead's pair stats (analysis/lookahead.py, plain
    torch: the +-8 px full-pel search of every 16x16 block) on panning()'s
    two frames (synth panned by (3, -2) px under static squares), packed,
    cuda against cpu: mv and inter cost identical, the
    intra cost within 1e-6 relative (its f32 sum order); the device ms a
    frame pair (CUDA events, mean of 5) and its peak memory. Returns the
    ms."""
    from rav1e_tpu_torch.analysis.lookahead import _pair_stats_packed_fn
    from rav1e_tpu_torch.pipeline.tpu_inter import pack_src
    bufs = [torch.from_numpy(pack_src(f)) for f in panning(w, h)]
    fn = _pair_stats_packed_fn(h, w)
    t0 = time.perf_counter()
    cpu = [x.numpy() for x in fn(bufs[1], bufs[0])]
    t_cpu = time.perf_counter() - t0
    g = [b.cuda() for b in bufs]
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    gpu = [x.cpu().numpy() for x in fn(g[1], g[0])]
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    ms = time_cuda(torch, lambda: fn(g[1], g[0]), 5)
    rel = float(np.max(np.abs(gpu[2] - cpu[2]) / np.maximum(cpu[2], 1)))
    moved = float(np.mean(np.any(cpu[0] != 0, axis=-1)))
    print(f"# lookahead pair stats {w}x{h} ({cpu[1].size} blocks, "
          f"{moved:.3f} with a nonzero mv): mv identical "
          f"{np.array_equal(gpu[0], cpu[0])}, inter identical "
          f"{np.array_equal(gpu[1], cpu[1])}, intra max rel diff {rel:.3g}; "
          f"device {ms:.4f} ms a frame pair (cpu {t_cpu:.2f} s), peak "
          f"{peak:.1f} MiB", flush=True)
    if not (np.array_equal(gpu[0], cpu[0]) and np.array_equal(gpu[1], cpu[1])
            and rel <= 1e-6):
        fail("the lookahead's pair stats differ between cuda and cpu")
    return ms


def session_cli_1080p(torch, kern: dict):
    """Phase 18c: synth(1920, 540, n=5) (its depth cut from 1920x1080 and
    9 frames, to keep the run short) written as y4m and encoded by
    rav1e_tpu_torch.cli.main at its defaults (cuda, speed 6, reordered,
    lookahead 8) with enc_stats on, every kernel's count set to 0 just
    before and read just after. Prints each packet's type, frame, qp and
    bytes, each coded frame's wall seconds and launches; every frame
    launches ec_pack and the three CDEF kernels, every inter frame the
    gather. Where the port's dav1d shim loads libdav1d, the IVF decodes to
    its frames, each frame's PSNR against the (edge-padded) source equal
    to its packet's enc_stats. Returns ({kernel: launches}, coded frames)."""
    import tempfile
    from pathlib import Path

    import rav1e_tpu_torch.pipeline.tpu_inter as tp
    import rav1e_tpu_torch.pipeline.tpu_intra as ti
    from rav1e_tpu_torch.api.context import Context
    from rav1e_tpu_torch.cli import main as cli
    from rav1e_tpu_torch.cli.ivf import read_ivf
    from rav1e_tpu_torch.cli.y4m import write_y4m
    from rav1e_tpu_torch.conform import dav1d
    w, h, n = 1920, 540, 5
    frames = synth(w, h, n=n)
    pkts, calls = [], []
    saved_rp = Context.receive_packet

    def receive(self):
        st, p = saved_rp(self)
        if p is not None:
            pkts.append(p)
        return st, p

    def timed(fn):
        def call(*a, **k):
            torch.cuda.synchronize()
            before = {m: f.launches for m, f in kern.items()}
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            calls.append((fn.__name__, time.perf_counter() - t0,
                          {m: f.launches - before[m]
                           for m, f in kern.items()}))
            return out
        return call

    entries = [(ti, "encode_keyframe_tpu")] + [
        (tp, m) for m in ("encode_pframe_tpu", "encode_bframe_tpu",
                          "encode_pframe2_tpu")]
    saved = [(mod, m, getattr(mod, m)) for mod, m in entries]
    with tempfile.TemporaryDirectory() as tmp:
        src, ivf = Path(tmp) / "in.y4m", Path(tmp) / "out.ivf"
        write_y4m(str(src), frames)
        Context.receive_packet = receive
        for mod, m, fn in saved:
            setattr(mod, m, timed(fn))
        try:
            for f in kern.values():
                f.launches = 0
            t0 = time.perf_counter()
            cli.main([str(src), "-o", str(ivf), "-s", "enc_stats=1"])
            wall = time.perf_counter() - t0
            launches = {m: f.launches for m, f in kern.items()}
        finally:
            Context.receive_packet = saved_rp
            for mod, m, fn in saved:
                setattr(mod, m, fn)
        stream = list(read_ivf(str(ivf)))
    coded = [p for p in pkts if p.frame_type != "SHOW_EXISTING"]
    print(f"# {w}x{h} y4m -> IVF through rav1e_tpu_torch.cli.main (cuda, "
          f"speed 6, reordered, lookahead 8, enc_stats): {wall:.3f} s for "
          f"{n} frames ({n / wall:.4f} frames/s), the pipelines "
          f"{sum(c[1] for c in calls):.3f} s of it; launches "
          f"{json.dumps(launches)}", flush=True)
    for p in pkts:
        print(f"#   packet {p.frame_type} frame {p.input_frameno} qp {p.qp}:"
              f" {len(p.data)} bytes", flush=True)
    if len(calls) != len(coded) or len(coded) != n:
        fail(f"{len(calls)} pipeline calls for {len(coded)} coded frames, "
             f"{n} frames sent")
    for p, (name, sec, nl) in zip(coded, calls):
        st = p.enc_stats
        print(f"#   frame {p.input_frameno} ({name}): {sec:.3f} s, launches "
              f"{json.dumps(nl)}, PSNR y/u/v {st.psnr_y:.4f} / "
              f"{st.psnr_u:.4f} / {st.psnr_v:.4f}", flush=True)
        need = [m for m in kern if m != "gather_patches"
                or p.frame_type == "INTER"]
        if any(nl[m] < 1 for m in need):
            fail(f"frame {p.input_frameno} launched no {need}: {nl}")
    if [(t, d) for t, d in stream] != [(p.input_frameno, p.data)
                                       for p in pkts]:
        fail("the IVF's packets are not the session's")
    try:
        ver = dav1d.version()
    except OSError as e:
        print(f"# libdav1d does not load here ({e}): the IVF is not "
              "decoded; packets and launches checked only", flush=True)
        return launches, n
    dec = dav1d.decode_all([d for _, d in stream])
    stats = {p.input_frameno: p.enc_stats for p in coded}
    psnr = []
    for i, (d, f) in enumerate(zip(dec, frames)):
        got = []
        for j, (plane, ref) in enumerate(zip(d.planes, f)):
            ch, cw = plane.shape
            ref = np.pad(ref, ((0, ch - ref.shape[0]), (0, cw - ref.shape[1])),
                         mode="edge").astype(np.float64)
            mse = np.mean((ref - plane.astype(np.float64)) ** 2)
            got.append(float(10 * np.log10(255.0 ** 2 / mse))
                       if mse > 0 else 99.0)
        want = [stats[i].psnr_y, stats[i].psnr_u, stats[i].psnr_v]
        psnr.append(got)
        if got != want:
            fail(f"decoded frame {i}'s PSNR {got} is not enc_stats' {want}")
    print(f"# libdav1d {ver} decoded the IVF to {len(dec)} frames; each "
          f"frame's PSNR against the source equals its enc_stats "
          f"(y: {[round(p[0], 4) for p in psnr]})", flush=True)
    if len(dec) != n:
        fail(f"libdav1d decoded {len(dec)} frames, {n} sent")
    return launches, n


# ---- phase 19: 10-bit 4:2:0 -------------------------------------------------

# the 10-bit reordered group of phase 19c in coding order (the non-shown
# anchor P, B0, B1, show-existing 3, B1, show-existing 1): (bytes,
# SHA-256 prefix) from the port's CPU route (device="cpu") on the H100
# machine's host, whose 10-bit packets equal the JAX package's at every
# test shape (tests/test_torch_hbd.py); made by
# `python3 chip_smoke.py --hbd-pins`
HBD_PINS = [(89609, "7285c0da5de634f2"), (59494, "1dc02c01f5b02bee"),
            (19242, "8210308a2a42fa2e"), (5, "479f23cb97654286"),
            (15635, "69d60ddc9c3d4377"), (5, "f5ed02db3266a088")]


def hbd_frames(krec, n=5):
    """Phase 19c's input: synth(1920, 1088, n) as 10-bit planes
    (to_10bit, seed 37), and phase 15's keyframe recon krec << 2 as the
    reference picture (the 10-bit numpy keyframe takes minutes at 1080p;
    so these packets follow no keyframe of theirs and are not a
    decodable stream)."""
    rng = np.random.default_rng(37)
    frames = [[to_10bit(p, rng) for p in f] for f in synth(1920, 1088, n=n)]
    return frames, [np.asarray(r, np.int32) << 2 for r in krec]


def hbd_pins(torch, ti, tp):
    """`--hbd-pins`: phase 15's keyframe on cuda (its packet must be
    GOP6_BYTES[0] bytes), then phase 19c's 10-bit group on the CPU route.
    Prints HBD_PINS."""
    kpkt, krec = ti.encode_keyframe_tpu(synth(1920, 1088)[0], 100,
                                        cdef=CDEF_SPEED8, device="cuda")
    if len(kpkt) != GOP6_BYTES[0]:
        fail(f"the keyframe took {len(kpkt)} bytes, not {GOP6_BYTES[0]}")
    frames, kref = hbd_frames(krec)
    t0 = time.perf_counter()
    pkts, _ = reordered_group(tp, frames, kref, "cpu", bit_depth=10)
    print(f"# the 10-bit group on the CPU route in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(f"HBD_PINS = {_pins(pkts)}", flush=True)
    return 0


def cdef_10bit(torch, cd, rec_d, src_d, skip8, floor_ms):
    """Phase 19a: the three CDEF kernels on 10-bit planes (int16, read as
    uint16 by the kernels) against their plain versions, as phase 6:
    phase 5's deblocked 1080p keyframe recon and its source as 10-bit
    planes (to_10bit, seed 43), the sampled branch at 1920x1088 and the
    full one at 1920x1056; then the extremes and the noise past 2^24 at
    10 bits. Returns cdef_phase's {kernel: (ms, plain_ms, bound_ms,
    bound_by)} of the sampled frame."""
    rng = np.random.default_rng(43)
    rec10 = [torch.from_numpy(to_10bit(p.cpu().numpy(), rng)).cuda()
             for p in rec_d]
    src10 = [torch.from_numpy(to_10bit(p.cpu().numpy(), rng)).cuda()
             for p in src_d]
    res = cdef_phase(torch, cd, rec10, src10, skip8, floor_ms, bd=10)
    cdef_phase(torch, cd, [rec10[0][:1056], rec10[1][:528], rec10[2][:528]],
               [src10[0][:1056], src10[1][:528], src10[2][:528]],
               skip8[:132], floor_ms, bd=10)
    dirs_extremes(torch, cd, bd=10)
    cdef_past_2_24(torch, cd, bd=10)
    return res


def hbd_gpu_vs_cpu(tp, w: int = 256, h: int = 192):
    """Phase 19b: 10-bit 4:2:0 on cuda and on cpu at w x h, on
    tests/_torch_content.py's fade + occluding-mover content as 10-bit
    planes (to_10bit): after the 10-bit numpy keyframe (host, the same for
    both), the low-latency P frame (encode_pframe_tpu's defaults,
    bit_depth=10) and phase 17's reordered group (the anchor P and three
    B frames); then the port's Context at its defaults with bit_depth=10
    and min_key_frame_interval=4 on 10 frames with a cut at frame 5.
    Every fetched decision, the recons, the packets, and the session's
    packets, frame types, frame numbers and qps identical."""
    from rav1e_tpu_torch.api import Config
    from rav1e_tpu_torch.pipeline.intra import encode_keyframe
    c = _tests_content()
    rng = np.random.default_rng(47)
    frames = [[to_10bit(p, rng) for p in f] for f in c.bgroup(w, h, n=5)]
    t0 = time.perf_counter()
    kpkt, krec = encode_keyframe(frames[0], 100, cdef=CDEF_SPEED8,
                                 bit_depth=10)
    t_kf = time.perf_counter() - t0
    res = {}
    for d in ("cuda", "cpu"):
        got, restore = _recording_fetch(tp)
        try:
            ppkt, prec = tp.encode_pframe_tpu(
                frames[1], krec, 100, order_hint=1, cdef=CDEF_SPEED8,
                bit_depth=10, device=d)
            pkts, recs = reordered_group(tp, frames, krec, d, bit_depth=10)
        finally:
            restore()
        res[d] = ([ppkt] + pkts, [prec] + list(recs.values()), got)
    (pk_g, rc_g, g), (pk_c, rc_c, cc) = res["cuda"], res["cpu"]
    bad = []
    for i, (a, b) in enumerate(zip(g, cc)):
        bad += [f"frame {i} {k}" for k, x, y in zip(FETCHED6, a, b)
                if not np.array_equal(x, y)]
    if not all(np.array_equal(x, y) for ra, rb in zip(rc_g, rc_c)
               for x, y in zip(ra, rb)):
        bad.append("recon")
    same = [a == b for a, b in zip(pk_g, pk_c)]
    top = max(int(r.max()) for rec in rc_c for r in rec)
    b0 = dict(zip(FETCHED6, cc[2]))
    kinds = np.bincount(b0["choice"], minlength=3).tolist()
    print(f"# {w}x{h} 10-bit P and reordered group, cuda vs cpu (numpy "
          f"keyframe {len(kpkt)} B in {t_kf:.2f} s): differing "
          f"{bad or 'nothing'}; packets identical {same} "
          f"({[len(p) for p in pk_c]} bytes); recon max {top}; B0 blocks "
          f"fwd / bwd / compound {kinds}", flush=True)
    if bad or not all(same):
        fail(f"the {w}x{h} 10-bit frames differ between cuda and cpu: "
             f"{bad}, packets identical {same}")
    if top <= 255 or top > 1023:
        fail(f"the {w}x{h} 10-bit recons reach {top}, not 256..1023")
    frames2 = frames + [[to_10bit(p, rng) for p in f]
                        for f in c.bgroup(w, h, n=5, seed=32)]
    res = {}
    for d in ("cuda", "cpu"):
        t0 = time.perf_counter()
        pk = _session(Config(width=w, height=h, bit_depth=10,
                             min_key_frame_interval=4).new_context(device=d),
                      frames2)
        res[d] = ([(p.frame_type, p.input_frameno, p.qp) for p in pk],
                  [p.data for p in pk], time.perf_counter() - t0)
    (kinds, data, t_g), (kinds_c, data_c, t_c) = res["cuda"], res["cpu"]
    same = [a == b for a, b in zip(data, data_c)]
    print(f"# {w}x{h} 10-bit session (Config defaults, bit_depth 10, "
          f"min_key_frame_interval 4, 10 frames with a cut) cuda "
          f"{t_g:.2f} s vs cpu {t_c:.2f} s: packets identical {same}; "
          f"(type, frame, qp) {kinds}; bytes {[len(b) for b in data]}",
          flush=True)
    if kinds != kinds_c or len(data) != len(data_c) or not all(same):
        fail(f"the {w}x{h} 10-bit session differs between cuda and cpu: "
             f"{kinds} vs {kinds_c}, packets identical {same}")
    keys = [n for t, n, _ in kinds if t == "KEY"]
    if keys != [0, 5]:
        fail(f"the {w}x{h} 10-bit session's keyframes are frames {keys}, "
             "not the first and the cut (0, 5)")


def hbd_1080p(torch, ec, gp, cd, tp, krec):
    """Phase 19c: the 10-bit reordered group at 1920x1088 on cuda
    (hbd_frames: the anchor P and three B frames at q 100, speed 6, cdef
    (0, 0, 0, 0, 3), bit_depth=10), every kernel's count set to 0 just
    before it and read just after: packets against HBD_PINS, each frame's
    launches (the anchor: every kernel; each B frame: B_LAUNCHES), stage
    times, recons within 0..1023. Returns ({kernel: launches}, frames)."""
    frames, kref = hbd_frames(krec)
    kern = {"gather_patches": gp.gather_patches_many, "ec_pack": ec.pack_ir,
            "cdef_dirs": cd.cdef_dirs, "cdef_ladder_sse": cd.cdef_ladder_sse,
            "cdef_apply": cd.cdef_apply}
    rows = []

    def run(label, fn, *a, **k):
        before = {n: f.launches for n, f in kern.items()}
        t = {}
        out = fn(*a, timings=t, **k)
        rows.append((label, {n: f.launches - before[n]
                             for n, f in kern.items()}, t))
        return out

    for f in kern.values():
        f.launches = 0
    t0 = time.perf_counter()
    pkts, recs = reordered_group(tp, frames, kref, "cuda", run=run,
                                 bit_depth=10)
    wall = time.perf_counter() - t0
    launches = {n: f.launches for n, f in kern.items()}
    pins = _pins(pkts)
    print(f"# 1920x1088 10-bit reordered group (anchor P, B0, B1, SEF 3, "
          f"B1, SEF 1; speed 6, q 100, cdef {CDEF_SPEED8}, cuda; not a "
          f"decodable stream: its reference is phase 15's 8-bit keyframe "
          f"recon << 2): {wall:.3f} s; packets {[n for n, _ in pins]} "
          f"bytes, SHA-256 {[x for _, x in pins]}; the CPU route's "
          f"(HBD_PINS) {HBD_PINS}; launches {json.dumps(launches)}",
          flush=True)
    for label, n, t in rows:
        print(f"# 10-bit {label}: launches {json.dumps(n)}; stages (s) "
              + json.dumps({k: round(v, 4) for k, v in t.items()}),
              flush=True)
        if label.startswith("anchor"):
            idle = [k for k, v in n.items() if v < 1]
            if idle:
                fail(f"the 10-bit anchor launched no {idle}")
        elif n != B_LAUNCHES:
            fail(f"10-bit {label} launched {n}, not {B_LAUNCHES}")
    for i, rec in recs.items():
        if [tuple(r.shape) for r in rec] != [p.shape for p in frames[i]] or \
                any(r.min() < 0 or r.max() > 1023 for r in rec):
            fail(f"10-bit frame {i}: recon shapes wrong or outside 0..1023")
    if pins != HBD_PINS:
        fail(f"the 10-bit group's packets {pins}, pinned {HBD_PINS}")
    return launches, 4


# the LR stream's packets (phase 20c: the keyframe, then the group in
# coding order) on the CPU route: made by `python3 chip_smoke.py
# --lr-pins`
LR_PINS = [(93789, "9f578ac7b76cd23a"), (29061, "c70382dd79c823ea"),
           (7740, "a96729a8588dfbb5"), (3666, "503ea8fa1d185f1f"),
           (5, "479f23cb97654286"), (4310, "50fa855df39ba1dd"),
           (5, "f5ed02db3266a088")]


def _device_profile(torch, fn):
    """fn() under torch.profiler on the card: (its result, kernel launches,
    their summed device ms, copies and sets), or (result, None, None,
    None) where the profiler shows no device events."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if str(getattr(e, "device_type", "")).endswith("CUDA")]
    if not evs:
        return out, None, None, None
    dt = lambda e: getattr(e, "device_time", None) or getattr(  # noqa
        e, "cuda_time", 0)
    kern = [e for e in evs if "memcpy" not in e.name.lower()
            and "memset" not in e.name.lower()]
    return out, len(kern), sum(dt(e) for e in kern) / 1e3, len(evs) - len(kern)


def lrf_1080p(torch, rec_d, src_d):
    """Phase 20a: the loop-restoration search (ops/lrf.py: the Wiener
    least-squares taps and presets, the 8 SGR sets, the per-unit SSEs in
    XLA:CPU's f32 order, each unit's winner applied) on phase 5's 1080p
    keyframe recon against its source, luma and U, and the luma as
    10-bit planes (to_10bit, seed 47; the box sums in int64), on cuda
    and on cpu: the grids and the filtered planes identical; per plane
    on cuda the wall ms of a warm call, its kernel launches and device
    ms (profiler), and the host argmin's ms (_choose on the fetched
    per-unit results)."""
    from rav1e_tpu_torch.ops import lrf as lrf_mod
    rng = np.random.default_rng(47)
    y10 = [torch.from_numpy(to_10bit(p.cpu().numpy(), rng)).to(torch.int32)
           for p in (rec_d[0], src_d[0])]
    out = {}
    for name, rec, src, ss, bd in (("luma", rec_d[0], src_d[0], 0, 8),
                                   ("U", rec_d[1], src_d[1], 1, 8),
                                   ("luma 10-bit", *y10, 0, 10)):
        uv = name == "U"
        res = {}
        for d in ("cuda", "cpu"):
            r, s_ = rec.to(d), src.to(d)
            if d == "cuda":
                lrf_mod.search_lr_plane(r, s_, bd=bd, ss=ss, chroma=uv)  # warm
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            g, f, used = lrf_mod.search_lr_plane(r, s_, bd=bd, ss=ss,
                                                 chroma=uv)
            if d == "cuda":
                torch.cuda.synchronize()
            res[d] = (g, f.cpu(), used, 1e3 * (time.perf_counter() - t0))
        (g, f, used, wall), (gc, fc, usedc, wall_c) = res["cuda"], res["cpu"]
        rc, sc = (x.cuda().to(torch.int32) for x in (rec, src))
        summ, _, _, tb = lrf_mod._search_dev(rc, sc, bd, ss, chroma=uv)
        summ = summ.cpu().numpy()
        t0 = time.perf_counter()
        lrf_mod._choose(summ, tb, uv)
        am = 1e3 * (time.perf_counter() - t0)
        _, n_k, dev_ms, n_copy = _device_profile(
            torch, lambda: lrf_mod.search_lr_plane(rc, sc, bd=bd, ss=ss,
                                                   chroma=uv))
        cells = [c for row in g for c in row]
        kinds = {k: sum(1 for c in cells if (c and c[0]) == k)
                 for k in ("W", "S", None)}
        same = g == gc and torch.equal(f, fc) and used == usedc
        print(f"# LRF search {name} {tuple(rec.shape)} on phase 5's recon: "
              f"units Wiener / SGR / none {list(kinds.values())}; cuda "
              f"{wall:.2f} ms a warm call (host argmin {am:.3f} ms), "
              f"{n_k if n_k is not None else 'not measured'} kernel "
              f"launches, device {'%.3f' % dev_ms if dev_ms else 'not measured'}"
              f" ms, {n_copy} copies; cpu {wall_c:.1f} ms; grid and "
              f"filtered plane identical {same}", flush=True)
        if not same:
            fail(f"the LRF search of the 1080p {name} plane differs between "
                 "cuda and cpu")
        if not used:
            fail(f"no unit of the 1080p {name} plane chose a filter")
        if int(f.max()) > (1 << bd) - 1 or int(f.min()) < 0:
            fail(f"the filtered 1080p {name} plane leaves 0..{(1 << bd) - 1}")
        out[name] = (wall, n_k, dev_ms, am)
    return out


def lr_session_gpu_vs_cpu(w: int = 256, h: int = 192):
    """Phase 20b: the port's Context at speed 2 (the numpy keyframe with
    HORZ/VERT partitions and loop restoration, the 24-px anchor P search,
    loop restoration in every P and B frame) on cuda and on cpu at w x h,
    5 frames (the depth cut from 9 to keep the run short) of
    tests/_torch_content.py's session content: packets, frame types,
    frame numbers and qps identical."""
    from rav1e_tpu_torch.api import Config
    frames = _tests_content().session(w, h, 5)
    res = {}
    for d in ("cuda", "cpu"):
        t0 = time.perf_counter()
        pk = _session(Config(width=w, height=h, speed=2).new_context(
            device=d), frames)
        res[d] = ([(p.frame_type, p.input_frameno, p.qp) for p in pk],
                  [p.data for p in pk], time.perf_counter() - t0)
    (kinds, data, t_g), (kinds_c, data_c, t_c) = res["cuda"], res["cpu"]
    same = [a == b for a, b in zip(data, data_c)]
    print(f"# {w}x{h} speed-2 session (5 frames, loop restoration, HORZ/VERT "
          f"keyframe, 24-px anchor search) cuda {t_g:.2f} s vs cpu "
          f"{t_c:.2f} s: packets identical {same}; (type, frame, qp) "
          f"{kinds}; bytes {[len(b) for b in data]}", flush=True)
    if kinds != kinds_c or len(data) != len(data_c) or not all(same):
        fail(f"the {w}x{h} speed-2 session differs between cuda and cpu: "
             f"{kinds} vs {kinds_c}, packets identical {same}")


def lr_keyframe(ti, frames, device, run=None):
    """Phase 20c's keyframe: frames[0] at q 100 with cdef (0, 0, 0, 0, 3)
    and loop restoration (encode_keyframe_tpu(lr=True): the device
    search, then the Python walk), at speed 10's mode sets (phase 5's:
    the speed-6 keyframe's recon wavefront would add half a minute).
    Returns (packet, recon)."""
    run = run or (lambda label, fn, *a, **k: fn(*a, **k))
    return run("keyframe (frame 0)", ti.encode_keyframe_tpu, frames[0], 100,
               speed=10, cdef=CDEF_SPEED8, lr=True, device=device)


def lr_pins(torch, ti, tp):
    """`--lr-pins`: phase 20c's keyframe and group on the CPU route.
    Prints LR_PINS."""
    frames = synth(1920, 1088, n=5)
    t0 = time.perf_counter()
    kpkt, krec = lr_keyframe(ti, frames, "cpu")
    pkts, _ = reordered_group(tp, frames, krec, "cpu", speed=2, lr=True)
    print(f"# the LR keyframe and group on the CPU route in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(f"LR_PINS = {_pins([kpkt] + pkts)}", flush=True)
    return 0


def lr_group_1080p(torch, ec, gp, cd, ti, tp):
    """Phase 20c: a speed-10 keyframe with loop restoration (lr_keyframe),
    then the reordered group at speed 2 with loop restoration on every
    frame, at 1920x1088 on cuda: the anchor P (the 24-px search,
    refine16 and the speed-6 tools), B0, B1, B1, every kernel's count
    set to 0 just before the keyframe and read just after the group:
    packets against LR_PINS (the CPU route's), where libdav1d loads the
    stream decoded to the recons, each frame's launches (the keyframe: every
    kernel but the gather; the anchor: every kernel; each B frame:
    B_LAUNCHES) and stage times (lr, the search and apply on the device;
    tile_walk, the Python walk LR frames take). Returns ({kernel: launches},
    frames)."""
    from rav1e_tpu_torch.conform import dav1d
    frames = synth(1920, 1088, n=5)
    kern = {"gather_patches": gp.gather_patches_many, "ec_pack": ec.pack_ir,
            "cdef_dirs": cd.cdef_dirs, "cdef_ladder_sse": cd.cdef_ladder_sse,
            "cdef_apply": cd.cdef_apply}
    rows = []

    def run(label, fn, *a, **k):
        before = {n: f.launches for n, f in kern.items()}
        t = {}
        out = fn(*a, timings=t, **k)
        rows.append((label, {n: f.launches - before[n]
                             for n, f in kern.items()}, t))
        return out

    for f in kern.values():
        f.launches = 0
    t0 = time.perf_counter()
    kpkt, krec = lr_keyframe(ti, frames, "cuda", run=run)
    pkts, recs = reordered_group(tp, frames, krec, "cuda", run=run, speed=2,
                                 lr=True)
    wall = time.perf_counter() - t0
    launches = {n: f.launches for n, f in kern.items()}
    pkts = [kpkt] + pkts
    recs[0] = krec
    pins = _pins(pkts)
    print(f"# 1920x1088 speed-2 LR stream (KEY, anchor P with the 24-px "
          f"search, B0, B1, SEF 3, B1, SEF 1; q 100, cdef {CDEF_SPEED8}, lr "
          f"on every frame, cuda): {wall:.3f} s; packets "
          f"{[n for n, _ in pins]} bytes, SHA-256 {[x for _, x in pins]}; "
          f"the CPU route's (LR_PINS) {LR_PINS}; launches "
          f"{json.dumps(launches)}", flush=True)
    for label, n, t in rows:
        print(f"# LR {label}: launches {json.dumps(n)}; stages (s) "
              + json.dumps({k: round(v, 4) for k, v in t.items()}),
              flush=True)
        if "lr" not in t or "tile_walk" not in t:
            fail(f"LR {label} timed no lr or tile_walk stage")
        if label.startswith(("keyframe", "anchor")):
            idle = [k for k, v in n.items() if v < 1 and (
                k != "gather_patches" or label.startswith("anchor"))]
            if idle:
                fail(f"the LR {label} launched no {idle}")
        elif n != B_LAUNCHES:
            fail(f"LR {label} launched {n}, not {B_LAUNCHES}")
    for i, rec in recs.items():
        if [tuple(r.shape) for r in rec] != [p.shape for p in frames[i]] or \
                any(r.min() < 0 or r.max() > 255 for r in rec):
            fail(f"LR frame {i}: recon shapes wrong or outside 0..255")
    if pins != LR_PINS:
        fail(f"the LR stream's packets {pins}, pinned {LR_PINS}")
    try:
        dav1d.version()
    except OSError as e:
        print(f"# libdav1d does not load here ({e}): the LR stream is not "
              "decoded; packets checked against the CPU route", flush=True)
        return launches, 5
    dec = dav1d.decode_all(pkts)
    for d, i in zip(dec, range(5)):
        if any(not np.array_equal(np.asarray(pl)[:r.shape[0], :r.shape[1]],
                                  np.asarray(r))
               for pl, r in zip(d.planes, recs[i])):
            fail(f"libdav1d's frame {i} of the LR stream is not its recon")
    print(f"# libdav1d decoded the LR stream to {len(dec)} frames, each its "
          "recon", flush=True)
    return launches, 5


# ---- phase 21: tiles, variance AQ, the numpy routes -------------------------

def _decoders():
    """The decoders that load on this machine: {name: decode_all}, each
    returning per frame its three planes."""
    from rav1e_tpu_torch.conform import aom, dav1d
    out = {}
    for name, mod, probe in (("libdav1d", dav1d, dav1d.version),
                             ("libaom", aom, aom._load)):
        try:
            probe()
        except OSError as e:
            print(f"# {name} does not load here ({e})", flush=True)
            continue

        def decode(pkts, mod=mod):
            return [getattr(f, "planes", f) for f in mod.decode_all(pkts)]
        out[name] = decode
    return out


def tiles_1080p(torch, ec, gp, cd, tp, krec, kpkt):
    """Phase 21a: phase 17's reordered group after phase 15's keyframe,
    without the anchor's intra-in-inter (a tiled session's tools), coded
    untiled and then on a 2x2 tile grid (tile_grid=(1, 1)) on cuda, every
    kernel's count set to 0 just before the tiled group and read just
    after it. Each tiled frame's recon must equal the untiled frame's
    (the decisions are frame-global), each tiled frame must launch
    ec_pack once for its four tiles (pack_tile_irs), and each tile's bytes
    must be pack_ir_plain + finish's on its IR. The anchor's T-tile launch
    is timed (CUDA events, mean of 3) against its bytes bound and the
    plain version. Where a decoder loads, the KEY + tiled group stream
    decodes to the recons. Returns ({kernel: launches}, frames, the
    kernels-line fields of the T-tile launch)."""
    frames = synth(1920, 1088, n=5)
    kern = {"gather_patches": gp.gather_patches_many, "ec_pack": ec.pack_ir,
            "cdef_dirs": cd.cdef_dirs, "cdef_ladder_sse": cd.cdef_ladder_sse,
            "cdef_apply": cd.cdef_apply}
    rows, coded = [], []
    saved = tp.pack_tile_irs

    def keeping(irs, *a, **k):
        tiles = saved(irs, *a, **k)
        coded.append(([ir.clone() for ir in irs], tiles))
        return tiles

    def run(label, fn, *a, **k):
        before = {n: f.launches for n, f in kern.items()}
        n_coded = len(coded)
        t = {}
        out = fn(*a, timings=t, **k)
        rows.append((label, {n: f.launches - before[n]
                             for n, f in kern.items()}, t,
                     coded[n_coded:]))
        return out

    untiled_pkts, untiled = reordered_group(tp, frames, krec, "cuda",
                                            intra=False)
    tp.pack_tile_irs = keeping
    try:
        for f in kern.values():
            f.launches = 0
        t0 = time.perf_counter()
        pkts, recs = reordered_group(tp, frames, krec, "cuda", run=run,
                                     tile_grid=(1, 1), intra=False)
        wall = time.perf_counter() - t0
        launches = {n: f.launches for n, f in kern.items()}
    finally:
        tp.pack_tile_irs = saved
    print(f"# 1920x1088 reordered group on a 2x2 tile grid (KEY from phase "
          f"15, anchor P without intra-in-inter, B0, B1, SEF 3, B1, SEF 1; "
          f"cuda): {wall:.3f} s after the keyframe; packets "
          f"{[len(p) for p in pkts]} bytes (untiled "
          f"{[len(p) for p in untiled_pkts]}); launches "
          f"{json.dumps(launches)}", flush=True)
    for i, rec in recs.items():
        if any(not np.array_equal(a, b) for a, b in zip(rec, untiled[i])):
            fail(f"tiled frame {i}: its recon differs from the untiled "
                 "frame's")
    anchor = None
    for label, n, t, got in rows:
        if n["ec_pack"] != 1 or len(got) != 1 or len(got[0][0]) != 4:
            fail(f"tiled {label}: {n['ec_pack']} ec_pack launches for "
                 f"{[len(g[0]) for g in got]} tiles, not one for 4")
        irs, tiles = got[0]
        for ir, tile in zip(irs, tiles):
            c_p, st_p = ec.pack_ir_plain(ir)
            if tile != ec.finish(c_p.tolist(), *st_p[:3].tolist()):
                fail(f"tiled {label}: a tile's bytes are not pack_ir_plain "
                     "+ finish's on its IR")
        if label.startswith("anchor"):
            anchor = irs
        print(f"# tiled {label}: tile IR rows "
              f"{[int(ir.shape[0]) for ir in irs]}, tile bytes "
              f"{[len(x) for x in tiles]}; launches {json.dumps(n)}; stages "
              f"(s) " + json.dumps({k: round(v, 4) for k, v in t.items()}),
              flush=True)
    print("# every tiled frame: recon equal to the untiled frame's; one "
          "ec_pack launch for its 4 tiles, each tile's bytes pack_ir_plain "
          "+ finish's", flush=True)
    # the anchor's T-tile launch, timed and bounded
    offs = [0]
    for ir in anchor:
        offs.append(offs[-1] + int(ir.shape[0]))
    ir_d = torch.cat(anchor).cuda()
    off_d = torch.tensor(offs, dtype=torch.int64).cuda()
    t0 = time.perf_counter()
    plain, k = [], 0
    for ir in anchor:
        c_p, st_p = ec.pack_ir_plain(ir)
        plain.append(ec.finish(c_p.tolist(), *st_p[:3].tolist()))
        k += int(st_p[3])
    plain_ms = (time.perf_counter() - t0) * 1e3
    got = {}

    def launch():
        got["r"] = ec.pack_ir(ir_d, off_d)

    ms = time_cuda(torch, launch, 3)
    err = max(byte_err(a, b) for a, b in zip(
        ec.fetch_tiles(*got["r"], offs), plain))
    if err:
        fail(f"the anchor's T-tile launch differs from the plain version "
             f"(max |err| {err})")
    n_rows, T = offs[-1], len(anchor)
    nbytes = 16 * n_rows + 4 * k + 16 * T + 8 * (T + 1)
    ops = 24 * n_rows + 5 * k
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3
    bound = max(t_bytes, t_ops)
    print(f"# the tiled anchor's ec_pack launch: {T} tiles, IR rows "
          f"{[offs[i + 1] - offs[i] for i in range(T)]}, {ms:.5f} ms of "
          f"device time (mean of 3), bound {bound:.5f} ms "
          f"({'bytes' if t_bytes >= t_ops else 'operations'}; "
          f"{100 * bound / ms:.1f}%), plain {plain_ms:.1f} ms", flush=True)
    decs = _decoders()
    for name, decode in decs.items():
        out = decode([kpkt] + pkts)
        shown = [krec] + [recs[i] for i in (1, 2, 3, 4)]
        if len(out) != 5 or any(
                not np.array_equal(np.asarray(pl)[:r.shape[0], :r.shape[1]],
                                   np.asarray(r))
                for f, rec in zip(out, shown) for pl, r in zip(f, rec)):
            fail(f"{name} does not decode the tiled stream to its recons")
        print(f"# {name} decoded the KEY + tiled group to its 5 recons",
              flush=True)
    return launches, 4, {
        "tiled_frame_ms": ms, "tiled_frame_plain_ms": plain_ms,
        "tiled_frame_bound_ms": bound,
        "tiled_frame_bound_by": "bytes" if t_bytes >= t_ops
        else "operations", "tiled_frame_tiles": T,
        "tiled_frame_ir_rows": [offs[i + 1] - offs[i] for i in range(T)],
        "tiled_frame_max_abs_err": err,
        "launches_per_tiled_frame": 1}


def aq_keyframes(torch, ec, cd, ti):
    """Phase 21b: a variance-AQ keyframe (speed 10's mode sets, cdef
    (0, 0, 0, 0, 3)) at 1920x1088 on cuda: its stages (the segment map
    and the per-block quantizers on the device, then the Python walk),
    its launches (ec_pack and the three CDEF kernels once each), four
    segments used and a finite recon in range; then the speed-6 AQ
    keyframe of a 256x192 frame on cuda and on cpu: packets and recons
    identical."""
    planes = synth(1920, 1088, seed=7)[0]
    kern = {"ec_pack": ec.pack_ir, "cdef_dirs": cd.cdef_dirs,
            "cdef_ladder_sse": cd.cdef_ladder_sse,
            "cdef_apply": cd.cdef_apply}
    before = {n: f.launches for n, f in kern.items()}
    t = {}
    t0 = time.perf_counter()
    pkt, rec = ti.encode_keyframe_tpu(planes, 100, speed=10, aq=True,
                                      cdef=CDEF_SPEED8, device="cuda",
                                      timings=t)
    wall = time.perf_counter() - t0
    n = {k: f.launches - before[k] for k, f in kern.items()}
    seg_map = ti._aq_segments(planes[0], 100)[0]
    print(f"# 1920x1088 AQ keyframe (speed 10, q 100, cdef {CDEF_SPEED8}, "
          f"cuda): {len(pkt)} bytes in {wall:.3f} s; segments "
          f"{np.bincount(seg_map.ravel(), minlength=4).tolist()}; launches "
          f"{json.dumps(n)}; stages (s) "
          + json.dumps({k: round(v, 4) for k, v in t.items()}), flush=True)
    if any(v != 1 for v in n.values()):
        fail(f"the AQ keyframe launched {n}, not each kernel once")
    if len(set(seg_map.ravel().tolist())) != 4 or [
            tuple(r.shape) for r in rec] != [p.shape for p in planes] or any(
            r.min() < 0 or r.max() > 255 for r in rec):
        fail("the AQ keyframe used fewer than 4 segments or its recon is "
             "out of shape or range")
    small = synth(256, 192, seed=7)[0]
    res = {}
    for d in ("cuda", "cpu"):
        t0 = time.perf_counter()
        res[d] = ti.encode_keyframe_tpu(small, 100, aq=True,
                                        cdef=CDEF_SPEED8, device=d)
        res[d] += (time.perf_counter() - t0,)
    same = res["cuda"][0] == res["cpu"][0] and all(
        np.array_equal(a, b) for a, b in zip(res["cuda"][1], res["cpu"][1]))
    print(f"# 256x192 speed-6 AQ keyframe cuda {res['cuda'][2]:.2f} s vs "
          f"cpu {res['cpu'][2]:.2f} s: {len(res['cuda'][0])} bytes, packet "
          f"and recon identical: {same}", flush=True)
    if not same:
        fail("the 256x192 AQ keyframe differs between cuda and cpu")


def _to_sampling(planes, cs, bd=8):
    """4:2:0 [y, u, v] as 4:2:2 / 4:4:4 (chroma repeated) at bd bits."""
    y, u, v = planes
    if cs != "420":
        u, v = (np.repeat(p, 2, axis=0) for p in (u, v))
    if cs == "444":
        u, v = (np.repeat(p, 2, axis=1) for p in (u, v))
    if bd == 8:
        return [y, u, v]
    return [(p.astype(np.uint16) << (bd - 8)) | (p.astype(np.uint16) & 3)
            for p in (y, u, v)]


def sessions_gpu_vs_cpu():
    """Phase 21c: Context sessions on cuda and on cpu, packets, frame
    types, frame numbers and qps identical: tiles=4 (a 2x2 grid) at
    256x192, 5 frames; and at 128x96, 4 frames each: `aq` (speed 10),
    4:2:2 and 4:4:4 (low latency), 12-bit, photon_noise (ISO 800),
    switch frames every 3 and error_resilient (low latency, speed 8)
    (their depth cut from 6 and 5 frames to keep the run short)."""
    from rav1e_tpu_torch.api import Config
    c = _tests_content()
    cases = [("tiles=4", c.bgroup(256, 192, n=5), dict(tiles=4))]
    small = c.bgroup(128, 96, n=4)
    cases += [
        ("aq", small, dict(speed=10, extra={"aq": "1"})),
        ("4:2:2", [_to_sampling(f, "422") for f in small],
         dict(chroma_sampling="422", low_latency=True)),
        ("4:4:4", [_to_sampling(f, "444") for f in small],
         dict(chroma_sampling="444")),
        ("12-bit", [_to_sampling(f, "420", 12) for f in small],
         dict(bit_depth=12)),
        ("photon_noise", small, dict(extra={"photon_noise": 800})),
        ("switch_frame_interval", small,
         dict(low_latency=True, extra={"switch_frame_interval": 3})),
        ("error_resilient", small, dict(speed=8, low_latency=True,
                                        extra={"error_resilient": "1"}))]
    for name, frames, cfg in cases:
        h, w = frames[0][0].shape
        res = {}
        for d in ("cuda", "cpu"):
            t0 = time.perf_counter()
            pkts = _session(Config(width=w, height=h, quantizer=120, **cfg
                                   ).new_context(device=d), frames)
            res[d] = ([(p.frame_type, p.input_frameno, p.qp) for p in pkts],
                      [p.data for p in pkts], time.perf_counter() - t0)
        (kinds, data, t_g), (kinds_c, data_c, t_c) = res["cuda"], res["cpu"]
        same = kinds == kinds_c and data == data_c
        print(f"# {w}x{h} {name} session ({len(frames)} frames) cuda "
              f"{t_g:.2f} s vs cpu {t_c:.2f} s: packets identical {same}; "
              f"(type, frame, qp) {kinds}; bytes {[len(b) for b in data]}",
              flush=True)
        if not same:
            fail(f"the {name} session differs between cuda and cpu")


# ---- phase 22: the multi-device layer, the C API, 12-bit LR -----------------

# phase 22a's 2-shard tiled P frame (phase 15's frame 1 on its keyframe's
# recon, q 100): ((packet bytes, SHA-256 prefix), the recon's SHA-256
# prefix), from the CPU route (["cpu", "cpu"]), made by
# `python3 chip_smoke.py --tiled-pins`
TILED_PINS = ((4423, "d7e311d609864413"), "85d462313a4b1965")

# the profiler's kernel names of each hand-written kernel (phase 22a)
KERNEL_NAMES = {
    "gather_patches": ("gather_patches_kernel",),
    "ec_pack": ("boundaries_kernel", "speculate_kernel", "compose_kernel",
                "resolve_kernel", "code_kernel", "carry_kernel"),
    "cdef_dirs": ("cdef_dirs_kernel",),
    "cdef_ladder_sse": ("cdef_ladder_sse_kernel",),
    "cdef_apply": ("cdef_apply_kernel",)}


def _rec_hash(rec) -> str:
    import hashlib
    h = hashlib.sha256()
    for p in rec:
        h.update(np.ascontiguousarray(np.asarray(p, np.int32)).tobytes())
    return h.hexdigest()[:16]


def _shard_devices(torch):
    """Two shards or workers: on two cards where there are two, else both
    on cuda:0 (each on a stream of its own)."""
    return (["cuda:0", "cuda:1"] if torch.cuda.device_count() >= 2
            else ["cuda:0", "cuda:0"])


def tiled_pins(torch, ti):
    """`--tiled-pins`: phase 15's keyframe on cuda (its packet must be
    GOP6_BYTES[0] bytes), then phase 22a's tiled P frame on the CPU route
    (two CPU shards). Prints TILED_PINS."""
    from rav1e_tpu_torch.parallel.tile_encode import encode_pframe_tiled
    frames = synth(1920, 1088, n=2)
    kpkt, krec = ti.encode_keyframe_tpu(frames[0], 100, cdef=CDEF_SPEED8,
                                        device="cuda")
    if len(kpkt) != GOP6_BYTES[0]:
        fail(f"the keyframe took {len(kpkt)} bytes, not {GOP6_BYTES[0]}")
    t0 = time.perf_counter()
    pkt, rec = encode_pframe_tiled(
        frames[1], [np.asarray(r, np.uint8) for r in krec], 100,
        ["cpu", "cpu"])
    print(f"# the tiled P frame on the CPU route in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(f"TILED_PINS = {(_pins([pkt])[0], _rec_hash(rec))}", flush=True)
    return 0


def _halo_planes(torch, planes, t, T):
    """Shard t of T's [y, u, v] columns with 8 (4 chroma) columns of each
    neighbour on either side (zeros outside the frame, which the kernels
    read as out of frame), contiguous."""
    out = []
    for p, e in zip(planes, (8, 4, 4)):
        w = p.shape[1] // T
        lo, hi = t * w, (t + 1) * w
        z = torch.zeros_like(p[:, :e])
        out.append(torch.cat([p[:, lo - e:lo] if t else z, p[:, lo:hi],
                              p[:, hi:hi + e] if t < T - 1 else z],
                             1).contiguous())
    return out


def halo_cdef(torch, cd, rec_d, src_d, skip8, floor_ms, T: int = 2):
    """Phase 22a's kernels: the table and the filter with a column halo
    (the tiled CDEF search's), on phase 5's deblocked 1080p recon cut
    into T tile columns (the full branch, every 32-block, as the tiled
    search evaluates): each shard's halo table and applied planes (the
    winners of the unsharded table with the nb_strengths RD, and every
    entry) equal to their plain versions; the shards' tables equal the
    unsharded table's columns and their applied planes, assembled, the
    unsharded cdef_apply at the same indices. Device ms (CUDA events,
    mean of 3) of the T launches a frame, the plain versions' and the
    bound (the least work of each shard's inputs, summed). Returns
    {kernel: (ms, plain_ms, bound_ms, bound_by)} of one frame."""
    h, w = rec_d[0].shape
    tw = w // T
    damping = CDEF_SPEED8[4]
    dirs, var = cd.cdef_dirs(rec_d[0])
    table = cd.cdef_ladder_sse(rec_d, src_d, dirs, var, skip8, damping,
                               False)
    nby, nbx = h // 32, w // 32
    nr, nc = (nby + 1) // 2, (nbx + 1) // 2
    idx = cd._choose(cd._sse_sb(table, False, nr, nc),
                     torch.tensor(60.0, device=dirs.device))
    every = (torch.arange(nr * nc, device=dirs.device) % 8).reshape(nr, nc)
    shards = []
    for t in range(T):
        g = slice(t * tw // 8, (t + 1) * tw // 8)
        sb = slice(t * tw // 64, (t + 1) * tw // 64)
        shards.append(dict(
            ext=_halo_planes(torch, rec_d, t, T),
            src=[p[:, t * (tw >> s):(t + 1) * (tw >> s)].contiguous()
                 for p, s in zip(src_d, (0, 1, 1))],
            dirs=dirs[:, g].contiguous(), var=var[:, g].contiguous(),
            skip8=skip8[:, g].contiguous(), sb=sb,
            outside=(t == 0, t == T - 1), t=t))
    for sh in shards:
        got = cd.cdef_ladder_sse(sh["ext"], sh["src"], sh["dirs"], sh["var"],
                                 sh["skip8"], damping, False, halo=8,
                                 outside=sh["outside"])
        t = sh["t"]
        if not torch.equal(got, table[..., t * tw // 32:(t + 1) * tw // 32]):
            fail(f"shard {t}: the halo table differs from the unsharded "
                 "table's columns")
        for i, (p, s) in enumerate(zip(sh["ext"], sh["src"])):
            want = cd.cdef_ladder_sse_plain(p, s, sh["dirs"], sh["var"],
                                            sh["skip8"], damping, i > 0,
                                            False, 8, 8, sh["outside"])
            if not torch.equal(got[i], want):
                fail(f"shard {t} plane {i}: the halo cdef_ladder_sse kernel "
                     "and its plain version differ")
    for name, m in (("winners", idx), ("every", every)):
        full = cd.cdef_apply(rec_d, dirs, var, skip8, damping, idx=m)
        parts = []
        for sh in shards:
            got = cd.cdef_apply(sh["ext"], sh["dirs"], sh["var"], sh["skip8"],
                                damping, idx=m[:, sh["sb"]], halo=8,
                                outside=sh["outside"])
            want = [cd.cdef_apply_plain(p, sh["dirs"], sh["var"], sh["skip8"],
                                        damping, i > 0, m[:, sh["sb"]],
                                        halo=8, outside=sh["outside"])
                    for i, p in enumerate(sh["ext"])]
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                fail(f"shard {sh['t']}: the halo cdef_apply kernel and its "
                     f"plain version differ on the {name} map")
            parts.append(got)
        for j in range(3):
            if not torch.equal(torch.cat([p[j] for p in parts], 1), full[j]):
                fail(f"the {T} shards' halo cdef_apply on the {name} map, "
                     f"assembled, differ from the unsharded cdef_apply "
                     f"(plane {j})")
    px = rec_d[0].element_size()

    def ladder(sh):
        return cd.cdef_ladder_sse(sh["ext"], sh["src"], sh["dirs"],
                                  sh["var"], sh["skip8"], damping, False,
                                  halo=8, outside=sh["outside"])

    def ladder_plain(sh):
        return [cd.cdef_ladder_sse_plain(p, s, sh["dirs"], sh["var"],
                                         sh["skip8"], damping, i > 0, False,
                                         8, 8, sh["outside"])
                for i, (p, s) in enumerate(zip(sh["ext"], sh["src"]))]

    def apply(sh):
        return cd.cdef_apply(sh["ext"], sh["dirs"], sh["var"], sh["skip8"],
                             damping, idx=every[:, sh["sb"]], halo=8,
                             outside=sh["outside"])

    def apply_plain(sh):
        return [cd.cdef_apply_plain(p, sh["dirs"], sh["var"], sh["skip8"],
                                    damping, i > 0, every[:, sh["sb"]],
                                    halo=8, outside=sh["outside"])
                for i, p in enumerate(sh["ext"])]

    res = {}
    lo = lb = ao = ab = 0.0
    for sh in shards:
        ent = cd._upsample(every[:, sh["sb"]], 8)[:h // 8, :tw // 8]
        for i, (p, s) in enumerate(zip(sh["ext"], sh["src"])):
            lo += _cdef_ladder_ops(torch, cd, sh["var"], sh["skip8"], i > 0,
                                   None) / H100_INT_OPS_PER_S * 1e3
            lb += (px * (p.numel() + s.numel())
                   + 32 * (s.numel() // ((16 if i else 32) ** 2))
                   ) / H100_BYTES_PER_S * 1e3
            ao += _cdef_ops(torch, cd, sh["var"], sh["skip8"], i > 0,
                            ent) / H100_INT_OPS_PER_S * 1e3
            ab += px * (p.numel() + s.numel()) / H100_BYTES_PER_S * 1e3
    res["cdef_ladder_sse"] = [
        sum(time_cuda(torch, lambda sh=sh: ladder(sh), 3) for sh in shards),
        sum(time_cuda(torch, lambda sh=sh: ladder_plain(sh), 3)
            for sh in shards), max(lo, lb),
        "operations" if lo >= lb else "bytes"]
    res["cdef_apply"] = [
        sum(time_cuda(torch, lambda sh=sh: apply(sh), 3) for sh in shards),
        sum(time_cuda(torch, lambda sh=sh: apply_plain(sh), 3)
            for sh in shards), max(ao, ab),
        "operations" if ao >= ab else "bytes"]
    print(f"# CDEF with a column halo at {w}x{h} in {T} tile columns (full "
          f"branch; idx used {sorted(set(idx.flatten().tolist()))}): each "
          "shard's table and applied planes (winners, every entry) equal to "
          "the plain versions; the tables equal the unsharded table's "
          "columns, the assembled planes the unsharded cdef_apply's; per "
          "frame ms (the T launches; kernel, plain, bound, bound by; "
          "cdef_apply on the map of every entry): "
          + json.dumps({k: [round(v, 5) if isinstance(v, float) else v
                            for v in r] for k, r in res.items()})
          + f"; the empty launch {floor_ms:.5f} ms", flush=True)
    beaten = [k for k, r in res.items() if r[0] < r[2]]
    if beaten:
        fail(f"halo {beaten} ran in less than its bound: the count is no "
             "floor")
    return res


def _kernel_device_ms(torch, prof) -> dict:
    """Device ms and launches by hand-written kernel from a torch.profiler
    run's device events ((None, 0) where it saw none), and the names of
    the other device kernels it saw."""
    evs = [e for e in prof.events()
           if str(getattr(e, "device_type", "")).endswith("CUDA")]
    out, seen = {}, set()
    for k, names in KERNEL_NAMES.items():
        mine = [e for e in evs if any(nm in e.name for nm in names)]
        seen.update(id(e) for e in mine)
        tot = sum((getattr(e, "device_time", None)
                   or getattr(e, "cuda_time", 0)) for e in mine)
        out[k] = (round(tot / 1e3, 5) if mine else None, len(mine))
    other = sorted({e.name[:60] for e in evs if id(e) not in seen})
    return out, other


def tiled_1080p(torch, ec, gp, cd, tp, ti, krec):
    """Phase 22a: phase 15's frame 1 as a P frame in 2 tile columns
    (parallel/tile_encode.py::encode_pframe_tiled), each a shard on its
    own thread and stream, on phase 15's keyframe recon, every kernel's
    count set to 0 just before and read just after: the packet and recon
    must be TILED_PINS (the CPU route's); the launches: the gather, each
    CDEF kernel once a shard (the table and the filter with their column
    halo) and ONE ec_pack launch for both tiles. The frame's wall time
    and stages, and each kernel's device ms in a second, profiled call.
    Then the same at 256x192 on cuda against the CPU route within the
    phase: packet and recon identical. Returns ({kernel: launches}, the
    profiled device ms)."""
    import rav1e_tpu_torch.parallel.tile_encode as te
    from torch.profiler import ProfilerActivity, profile
    devs = _shard_devices(torch)
    frames = synth(1920, 1088, n=2)
    kref = [np.asarray(r, np.uint8) for r in krec]
    kern = {"gather_patches": gp.gather_patches_many, "ec_pack": ec.pack_ir,
            "cdef_dirs": cd.cdef_dirs, "cdef_ladder_sse": cd.cdef_ladder_sse,
            "cdef_apply": cd.cdef_apply}
    coded, saved = [], te.pack_tile_irs

    def counting(irs, *a, **k):
        coded.append(len(irs))
        return saved(irs, *a, **k)

    te.pack_tile_irs = counting
    try:
        for f in kern.values():
            f.launches = 0
        t = {}
        t0 = time.perf_counter()
        pkt, rec = te.encode_pframe_tiled(frames[1], kref, 100, devs,
                                          timings=t)
        wall = time.perf_counter() - t0
        launches = {n: f.launches for n, f in kern.items()}
    finally:
        te.pack_tile_irs = saved
    pins = (_pins([pkt])[0], _rec_hash(rec))
    print(f"# 1920x1088 P frame in 2 tile columns on {devs}: {wall:.3f} s "
          f"of wall; {len(pkt)} bytes; pins {pins}; launches "
          f"{json.dumps(launches)}; pack_tile_irs calls {coded} (tiles); "
          f"stages (s) {json.dumps({k: round(v, 4) for k, v in t.items()})}",
          flush=True)
    if pins != TILED_PINS:
        fail(f"the tiled P frame {pins} is not TILED_PINS {TILED_PINS} (the "
             "CPU route's)")
    want = {"ec_pack": 1, "cdef_dirs": 2, "cdef_ladder_sse": 2,
            "cdef_apply": 2}
    if coded != [2] or any(launches[k] != n for k, n in want.items()) \
            or launches["gather_patches"] < 2:
        fail(f"the tiled P frame launched {launches} with tiles coded "
             f"{coded}: not one ec_pack launch for 2 tiles, each CDEF kernel "
             "once a shard and the gather in each shard")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pkt2, _ = te.encode_pframe_tiled(frames[1], kref, 100, devs)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
    dev_ms, other = _kernel_device_ms(torch, prof)
    print(f"# the tiled P frame again under torch.profiler: {wall2:.3f} s "
          f"of wall; device ms and launches by kernel {json.dumps(dev_ms)}; "
          f"other device work: {other}", flush=True)
    if pkt2 != pkt:
        fail("the tiled P frame's second call gave another packet")
    small = synth(256, 192, n=2)
    kp, kr = ti.encode_keyframe_tpu(small[0], 100, speed=10, device="cpu")
    kr = [np.asarray(r, np.uint8) for r in kr]
    got = {}
    for name, d in (("cuda", devs), ("cpu", ["cpu", "cpu"])):
        t0 = time.perf_counter()
        got[name] = te.encode_pframe_tiled(small[1], kr, 100, d)
        got[name + "_s"] = time.perf_counter() - t0
    same = got["cuda"][0] == got["cpu"][0] and all(
        np.array_equal(a, b) for a, b in zip(got["cuda"][1], got["cpu"][1]))
    print(f"# 256x192 P frame in 2 tile columns: cuda {got['cuda_s']:.2f} s "
          f"vs cpu {got['cpu_s']:.2f} s, {len(got['cuda'][0])} bytes: packet "
          f"and recon identical {same}", flush=True)
    if not same:
        fail("the 256x192 tiled P frame differs between cuda and cpu")
    return launches, dev_ms


def gop_scheduler_1080p(torch, ec, gp, cd, pkts6, gop6_wall: float):
    """Phase 22b: GopScheduler over two workers (each a thread and a
    stream, on this card or two) encoding two GOPs, each phase 15's
    frames 0-1 (KEY + P at speed 6, cdef (0, 0, 0, 0, 3)), every kernel's
    count set to 0 just before and read just after: each GOP must give
    phase 15's first two packets exactly, in order. Two workers of one
    card take turns (GopScheduler's lock per device), so on one card the
    two GOPs run one after the other; the wall is printed beside phase
    15's (its KEY + 2 P GOP of the same frames, gop6_wall, which holds
    the run's first 1080p speed-6 keyframe). Returns {kernel:
    launches}."""
    from rav1e_tpu_torch.parallel.gop_encode import GopScheduler
    devs = _shard_devices(torch)
    frames = synth(1920, 1088, n=2)
    kern = {"gather_patches": gp.gather_patches_many, "ec_pack": ec.pack_ir,
            "cdef_dirs": cd.cdef_dirs, "cdef_ladder_sse": cd.cdef_ladder_sse,
            "cdef_apply": cd.cdef_apply}
    for f in kern.values():
        f.launches = 0
    t0 = time.perf_counter()
    pkts = GopScheduler(devs).encode(frames + frames, key_interval=2,
                                     qindex=100, speed=6, cdef=CDEF_SPEED8)
    wall = time.perf_counter() - t0
    launches = {n: f.launches for n, f in kern.items()}
    want = list(pkts6[:2]) * 2
    turns = " (taking turns on one card)" if devs[0] == devs[1] else ""
    print(f"# GopScheduler over {devs}{turns}: two 1920x1088 GOPs (KEY + P, "
          f"speed 6) in {wall:.3f} s of wall, {wall / 2:.3f} s a GOP; phase "
          f"15's KEY + 2 P GOP of the same frames {gop6_wall:.3f} s; packets "
          f"{[len(p) for p in pkts]} bytes; launches {json.dumps(launches)}",
          flush=True)
    if pkts != want:
        fail(f"the GOPs gave {[len(p) for p in pkts]} bytes, not phase 15's "
             f"{[len(p) for p in want]}")
    return launches


def capi_phase(torch, w: int = 256, h: int = 192):
    """Phase 22c: the C API (capi/capi.c, built with g++ against this
    Python's headers) loaded with ctypes in this process, on cuda (the
    default device) at 256x192: 5 frames of the fade + occluding-mover
    group at q 100, speed 10; its packets and frame numbers must equal
    Config(...).new_context()'s at the same settings."""
    import ctypes as ct
    from rav1e_tpu_torch.api import Config
    from rav1e_tpu_torch.capi.build import build
    try:
        so = build()
    except RuntimeError as e:
        fail(f"the C API shim does not build here: {e}")

    class RaPacket(ct.Structure):
        _fields_ = [("data", ct.POINTER(ct.c_uint8)), ("len", ct.c_size_t),
                    ("input_frameno", ct.c_uint64), ("frame_type", ct.c_int),
                    ("opaque", ct.c_void_p)]

    lib = ct.CDLL(str(so))
    vp = ct.c_void_p
    lib.rav1e_config_default.restype = vp
    lib.rav1e_config_parse.argtypes = [vp, ct.c_char_p, ct.c_char_p]
    lib.rav1e_context_new.argtypes = [vp]
    lib.rav1e_context_new.restype = vp
    lib.rav1e_frame_new.argtypes = [vp]
    lib.rav1e_frame_new.restype = vp
    lib.rav1e_frame_fill_plane.argtypes = [vp, ct.c_int, ct.c_char_p,
                                           ct.c_size_t, ct.c_ssize_t,
                                           ct.c_int]
    lib.rav1e_send_frame.argtypes = [vp, vp]
    lib.rav1e_receive_packet.argtypes = [vp, ct.POINTER(ct.POINTER(RaPacket))]
    for f in ("rav1e_packet_unref", "rav1e_frame_unref",
              "rav1e_context_unref", "rav1e_config_unref"):
        getattr(lib, f).argtypes = [vp]
    lib.rav1e_version_full.restype = ct.c_char_p
    frames = _tests_content().bgroup(w, h, n=5)
    kv = {"width": w, "height": h, "quantizer": 100, "speed": 10}
    t0 = time.perf_counter()
    cfg = lib.rav1e_config_default()
    for k, v in kv.items():
        lib.rav1e_config_parse(cfg, k.encode(), str(v).encode())
    ctx = lib.rav1e_context_new(cfg)
    if not ctx:
        fail("rav1e_context_new returned NULL on cuda")
    for f in frames:
        fr = lib.rav1e_frame_new(ctx)
        for i, p in enumerate(f):
            data = np.ascontiguousarray(p).tobytes()
            lib.rav1e_frame_fill_plane(fr, i, data, len(data), p.shape[1], 1)
        if lib.rav1e_send_frame(ctx, fr) != 0:
            fail("rav1e_send_frame failed")
        lib.rav1e_frame_unref(fr)
    lib.rav1e_send_frame(ctx, None)
    got = []
    while True:
        pp = ct.POINTER(RaPacket)()
        st = lib.rav1e_receive_packet(ctx, ct.byref(pp))
        if st == 0 and pp:
            got.append((ct.string_at(pp.contents.data, pp.contents.len),
                        pp.contents.input_frameno))
            lib.rav1e_packet_unref(pp)
        elif st in (1, 3):
            break
        else:
            fail(f"rav1e_receive_packet returned status {st}")
    lib.rav1e_context_unref(ctx)
    lib.rav1e_config_unref(cfg)
    t_c = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = [(p.data, p.input_frameno) for p in _session(
        Config.parse(kv).new_context(), frames)]
    t_p = time.perf_counter() - t0
    print(f"# C API ({lib.rav1e_version_full().decode()}) through ctypes on "
          f"cuda at {w}x{h}, 5 frames: {t_c:.2f} s, {len(got)} packets "
          f"{[len(d) for d, _ in got]} bytes; Config(...).new_context() "
          f"{t_p:.2f} s: identical {got == want}", flush=True)
    if got != want:
        fail("the C API's packets differ from the Context's")


def lr12_session(w: int = 256, h: int = 192):
    """Phase 22d: a 12-bit speed-2 Context (the numpy pipelines, loop
    restoration searched on the host at 12 bits) on cuda and on cpu at
    256x192, KEY + P (low latency) of the fade + occluding-mover group
    (its depth cut to 2 frames to keep the run short): packets, frame
    types, frame numbers and qps identical."""
    from rav1e_tpu_torch.api import Config
    frames = [_to_sampling(f, "420", 12)
              for f in _tests_content().bgroup(w, h, n=3)[:2]]
    res = {}
    for d in ("cuda", "cpu"):
        t0 = time.perf_counter()
        pkts = _session(Config(width=w, height=h, bit_depth=12, speed=2,
                               quantizer=120, low_latency=True
                               ).new_context(device=d), frames)
        res[d] = ([(p.frame_type, p.input_frameno, p.qp) for p in pkts],
                  [p.data for p in pkts], time.perf_counter() - t0)
    (kinds, data, t_g), (kinds_c, data_c, t_c) = res["cuda"], res["cpu"]
    same = kinds == kinds_c and data == data_c
    print(f"# {w}x{h} 12-bit speed-2 session (LR on the host) cuda "
          f"{t_g:.2f} s vs cpu {t_c:.2f} s: packets identical {same}; "
          f"(type, frame, qp) {kinds}; bytes {[len(b) for b in data]}",
          flush=True)
    if not same:
        fail("the 12-bit LR session differs between cuda and cpu")


def multichip_dryrun(torch):
    """Phase 22e: dryrun_multichip over every card (parallel/dryrun.py):
    the tiled P frame and the GOP streams equal to the CPU route's."""
    from rav1e_tpu_torch.parallel.dryrun import dryrun_multichip
    t0 = time.perf_counter()
    out = dryrun_multichip(torch.cuda.device_count())
    print(f"# dryrun_multichip({torch.cuda.device_count()}): "
          f"{json.dumps(out)} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    if not out["cpu_route_equal"]:
        fail("dryrun_multichip did not hold its streams to the CPU route")


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
    if sys.argv[1:] == ["--bgroup-pins"]:
        return bgroup_pins(torch, ti, tp)
    if sys.argv[1:] == ["--hbd-pins"]:
        return hbd_pins(torch, ti, tp)
    if sys.argv[1:] == ["--lr-pins"]:
        return lr_pins(torch, ti, tp)
    if sys.argv[1:] == ["--tiled-pins"]:
        return tiled_pins(torch, ti)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t_start = time.perf_counter()

    def stamp(what):
        print(f"# [{time.perf_counter() - t_start:.1f} s] {what} done",
              flush=True)

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
    stamp("phase 3")
    gather, gframe, bframe = gather_phase(torch, gp, floor_ms)
    stamp("phases 1-4")
    ec_entry, kd, planes = slice_1080p(torch, ec, native, ti, floor_ms)
    stamp("phase 5")
    # phase 6: the CDEF kernels on the deblocked 1080p keyframe recon
    # (sampled branch) and on it cut to 1920x1056 (full branch)
    h, w = planes[0].shape
    rp = kd.rec_packed
    # contiguous uint8 planes, as cdef_search_persb hands them on
    rec_d = cd._as_pix([rp[:h], rp[h:, :w // 2], rp[h:, w // 2:]])
    src_d = [torch.from_numpy(p).cuda() for p in planes]
    skip8 = ti._kf_skip8(kd.state)
    cdef_ms = cdef_phase(torch, cd, rec_d, src_d, skip8, floor_ms)
    stamp("phase 6 (sampled)")
    cdef_phase(torch, cd, cd._as_pix([rec_d[0][:1056], rec_d[1][:528],
                                     rec_d[2][:528]]),
               cd._as_pix([src_d[0][:1056], src_d[1][:528], src_d[2][:528]]),
               skip8[:132], floor_ms)
    dirs_extremes(torch, cd)
    stamp("phase 6 (full, extremes)")
    cdef_past_2_24(torch, cd)
    stamp("phases 5-6")
    gpu_vs_cpu(torch, native, ti)
    stamp("phase 7")
    gop_gpu_vs_cpu(torch, native, ti, tp, 512, 384, 10)
    stamp("phase 8")
    gop_gpu_vs_cpu(torch, native, ti, tp, 256, 192, 8, CDEF_SPEED8)
    stamp("phase 9")
    gop_gpu_vs_cpu(torch, native, ti, tp, 256, 192, 7, CDEF_SPEED8,
                   strict=True)
    r16_sizes = default_pframe_gpu_vs_cpu(native, tp, 256, 192)
    stamp("phases 7-11")
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
    stamp("phase 14 (before 14b)")
    speed6_gop_gpu_vs_cpu(native, tp, 256, 192)
    stamp("phase 14")
    # the speed-10 and speed-7 GOPs, their depth cut to 288 rows (544
    # before phase 20 came) to keep the run short; still 540 blocks, so
    # the P frames search at half resolution as at 1080p
    gop_1080p(torch, ec, gp, cd, native, ti, tp, 2, 10, h=288)
    stamp("phase 12")
    gop7_launches, _, n_p7, _, _, _ = gop_1080p(torch, ec, gp, cd, native, ti,
                                          tp, 3, 7, CDEF_SPEED8, h=288)
    stamp("phases 12-13")
    # the main path: the speed-6 GOP with CDEF, the preset the
    # reference's bench times
    record: list = []
    launches, groups, n_p, gop6_timings, pkts6, recs6 = gop_1080p(
        torch, ec, gp, cd, native, ti, tp,
                                         3, 6, CDEF_SPEED8,
                                         expect=GOP6_BYTES, record=record)
    stamp("phase 15")
    # the same frames packed again by the packer and by the Python writer
    packer_vs_writer(torch, ec, native, ti, tp, record)
    stamp("phases 15, 15b")
    # a full-width speed-6 keyframe whose quads split 16->8
    kf6s_launches, _ = speed6_keyframe(torch, ec, cd, native, ti,
                                       checker_tiled(synth(1920, 128)[0]),
                                       "1920x128 split8", True)
    stamp("phase 16")
    # the default reordered group after phase 15's keyframe, then the
    # two-reference frames on cuda against cpu
    bg_launches, n_b, _ = bgroup_1080p(torch, ec, gp, cd, tp, recs6[0],
                                       pkts6[0])
    stamp("phase 17")
    bgroup_gpu_vs_cpu(tp, ti, 256, 192)
    stamp("phases 17, 17b")
    # the session API: a Context on cuda against cpu, the lookahead's pair
    # stats at 1080p, and the CLI's y4m -> IVF encode at 1080p
    session_gpu_vs_cpu()
    stamp("phase 18a")
    la_ms = lookahead_gpu_vs_cpu(torch)
    stamp("phase 18b")
    sess_launches, n_s = session_cli_1080p(torch, {
        "gather_patches": gp.gather_patches_many, "ec_pack": ec.pack_ir,
        "cdef_dirs": cd.cdef_dirs, "cdef_ladder_sse": cd.cdef_ladder_sse,
        "cdef_apply": cd.cdef_apply})
    stamp("phase 18")
    print(f"# lookahead: {la_ms:.4f} ms of device time a 1080p frame pair, "
          "one pair a frame sent", flush=True)
    # phase 19, 10-bit 4:2:0: the CDEF kernels on 16-bit planes, cuda
    # against cpu at 256x192, and the 1080p 10-bit group
    cdef10_ms = cdef_10bit(torch, cd, rec_d, src_d, skip8, floor_ms)
    stamp("phase 19a")
    hbd_gpu_vs_cpu(tp)
    stamp("phase 19b")
    hbd_launches, n_h = hbd_1080p(torch, ec, gp, cd, tp, recs6[0])
    stamp("phase 19")
    # phase 20, loop restoration and speeds 0-3: the LRF search on phase
    # 5's recon, a speed-2 Context on cuda against cpu, and a keyframe and
    # the speed-2 group with LR at 1080p
    lrf_1080p(torch, rec_d, src_d)
    stamp("phase 20a")
    lr_session_gpu_vs_cpu()
    stamp("phase 20b")
    lr_launches, n_l = lr_group_1080p(torch, ec, gp, cd, ti, tp)
    stamp("phase 20")
    # phase 21: phase 17's group on a 2x2 tile grid, the AQ keyframe, and
    # the tiled, AQ and numpy-route sessions on cuda against cpu
    tile_launches, n_t, tiled = tiles_1080p(torch, ec, gp, cd, tp,
                                            recs6[0], pkts6[0])
    stamp("phase 21a")
    aq_keyframes(torch, ec, cd, ti)
    stamp("phase 21b")
    sessions_gpu_vs_cpu()
    stamp("phase 21")
    # phase 22: the halo CDEF kernels, the 2-shard tiled P frame, the GOP
    # scheduler, the C API, 12-bit LR and dryrun_multichip
    halo_ms = halo_cdef(torch, cd, rec_d, src_d, skip8, floor_ms)
    stamp("phase 22a's kernels")
    tiled_p_launches, tiled_dev_ms = tiled_1080p(torch, ec, gp, cd, tp, ti,
                                                 recs6[0])
    stamp("phase 22a")
    sched_launches = gop_scheduler_1080p(torch, ec, gp, cd, pkts6,
                                         gop6_timings[0]["gop_wall"])
    stamp("phase 22b")
    capi_phase(torch)
    stamp("phase 22c")
    lr12_session()
    stamp("phase 22d")
    multichip_dryrun(torch)
    stamp("phase 22e")

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
    gather_entry.update(
        b_frame_ms=bframe["ms"], b_frame_plain_ms=bframe["plain_ms"],
        b_frame_bound_ms=bframe["bound_ms"],
        b_frame_library_ms=bframe["library_ms"],
        launches_per_b_frame=B_LAUNCHES["gather_patches"])
    gather_entry["max_abs_err"] = max(gather_entry["max_abs_err"],
                                      bframe["err"])
    print(f"# gather per speed-6 B frame ({bframe['launches']} launches): "
          f"kernel {bframe['ms']:.5f} ms, summed byte bound "
          f"{bframe['bound_ms']:.5f} ms "
          f"({100 * bframe['bound_ms'] / bframe['ms']:.1f}%)", flush=True)
    print(f"# gather per speed-6 P frame ({per_frame:g} launches): kernel "
          f"{gframe['ms']:.5f} ms, summed byte bound "
          f"{gframe['bound_ms']:.5f} ms "
          f"({100 * gframe['bound_ms'] / gframe['ms']:.1f}%), empty "
          f"launches {per_frame * floor_ms:.5f} ms", flush=True)
    # launches on the main paths, each counted from 0 in its own run:
    # phase 15's speed-6 GOP, phase 13's speed-7 GOP, phase 16's split8
    # keyframe, phase 17's reordered group, phase 18's CLI session and
    # phase 19c's 10-bit group
    by_path = {"gop6": dict(launches), "gop7": gop7_launches,
               "kf6_split8": kf6s_launches, "bgroup6": bg_launches,
               "session_cli": sess_launches, "hbd10": hbd_launches,
               "lr": lr_launches, "tiles": tile_launches,
               "tiled_p": tiled_p_launches, "gop_sched": sched_launches}
    for k in launches:
        launches[k] = sum(p.get(k, 0) for p in by_path.values())
    print(f"# launches on the main paths (phases 15, 13, 16, 17, 18, 19c, "
          f"20c, 21a, 22a, 22b): {json.dumps(by_path)}", flush=True)

    def paths(k):
        return {p: n.get(k, 0) for p, n in by_path.items()}

    ec_entry["launches"] = launches["ec_pack"]
    ec_entry["launches_by_path"] = paths("ec_pack")
    ec_entry.update(tiled)
    gather_entry["launches"] = launches["gather_patches"]
    gather_entry["launches_by_path"] = paths("gather_patches")
    replaces = {"cdef_dirs": "rav1e_tpu/ops/tpu/cdef.py:58",
                "cdef_ladder_sse": "rav1e_tpu/ops/tpu/cdef.py:281",
                "cdef_apply": "rav1e_tpu/ops/tpu/cdef.py:220"}
    # the eight paths' frames (phases 17, 19c and 21a: the anchor and the
    # B frames; 20c: the keyframe too)
    # 22a: one frame in 2 shards (each CDEF kernel once a shard); 22b: two
    # GOPs of KEY + P
    frames = ((n_p + 1) + (n_p7 + 1) + 1 + (1 + n_b) + n_s + n_h + n_l + n_t
              + 1 + 4)
    cdef_entries = [
        {"name": k, "route": "cuda",
         "source": "rav1e_tpu_torch/csrc/cdef.cu", "replaces": replaces[k],
         "launches": launches[k], "launches_by_path": paths(k),
         "launches_per_frame": launches[k] / frames,
         "max_abs_err": 0, "ms": r[0],
         "plain_ms": r[1], "bound_ms": r[2], "bound_by": r[3],
         "library_ms": None, "ms_10bit": cdef10_ms[k][0],
         "plain_ms_10bit": cdef10_ms[k][1],
         "bound_ms_10bit": cdef10_ms[k][2],
         "bound_by_10bit": cdef10_ms[k][3],
         "tiled_frame_device_ms": tiled_dev_ms[k][0]}
        for k, r in cdef_ms.items()]
    for e in cdef_entries:
        if e["name"] in halo_ms:
            h_ms, h_pl, h_b, h_by = halo_ms[e["name"]]
            e.update(ms_halo=h_ms, plain_ms_halo=h_pl, bound_ms_halo=h_b,
                     bound_by_halo=h_by)
    ec_entry["tiled_p_frame_device_ms"] = tiled_dev_ms["ec_pack"][0]
    gather_entry["tiled_p_frame_device_ms"] = \
        tiled_dev_ms["gather_patches"][0]
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
