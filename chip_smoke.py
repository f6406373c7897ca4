#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rav1e_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:
  1. the card (nvidia-smi name + power limit), torch and CUDA versions;
  2. the build of csrc/ec_pack.cu, csrc/gather_patches.cu and
     csrc/cdef.cu with nvcc for sm_90a, one nvcc process each, started
     together;
  3. the od_ec kernels against their plain version: a 4-tile batch (three
     random adapting-CDF streams of about 20k IR rows, one empty tile) in
     one call at chunk lengths L = 16, 100 and the default: chunk starts
     equal to chunk_starts, finished bytes equal to pack_ir_plain +
     finish and to the port's ECEncoder; and a stream whose carry runs
     back through some 10,000 0xFF bytes;
  4. the patch-gather kernel against its plain version at the 1080p P
     frame's three shapes (B = 2040; P = 43, 39 from the padded luma
     plane, P = 23 from a padded chroma plane), starts out of range
     included: max |err| 0; kernel, plain and indexing-call times;
  5. the speed-10 keyframe at 1920x1088 on cuda, once to warm and once
     timed: stage times, the ec_pack launches, the tile's IR coded again
     by pack_ir_plain with identical bytes, and the ec kernels' device
     time (CUDA events) at L = 256, 512, 1024, 2048 with identical bytes
     at each, and per pass at the default L = 512;
  6. the three CDEF kernels (cdef_dirs, cdef_ladder_sse, cdef_apply)
     against their plain versions on phase 5's deblocked recon with its
     skip map (the sampled branch) and on it cut to 1920x1056 (the full
     branch): dir, var, the SSE tables and the applied planes (ladder
     winners and a uniform strength) exactly equal; kernel and plain
     device ms (mean of 3) and the bound;
  7. the port on cuda vs the port on cpu, keyframe at 256x192, speed 10:
     level differences (|d| = 1 at < 1e-4 of the coefficients allowed,
     from the f32 forward transform) and identical recon wherever no
     differing level is upstream;
  8-9. encode_gop_tpu on cuda vs on cpu, KEY + 1 P: 512x384 at speed 10,
     and 256x192 at speed 8 with cdef (0, 0, 0, 0, 3): the share of
     blocks whose (mv, skip) agree (>= 99%), levels by phase 7's rule,
     identical CDEF index maps and packets where every MV, skip and level
     agrees;
  10-11. encode_gop_tpu at 1920x1088, q 100: KEY + 1 P at speed 10, then
     the main path, KEY + 2 P at speed 8 with cdef (0, 0, 0, 0, 3), every
     kernel's count set to 0 just before and read just after: per-frame
     stage times and packet sizes; every frame launched each kernel that
     serves it; every tile's IR coded again by pack_ir_plain gives the
     packet's bytes; recon within 0..255; each tile's ec kernel time at
     L = 256, 512, 1024 and its per-pass times.

Prints a kernels JSON line, then, as the last line,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, printing no result, without CUDA or without the
rav1e_tpu_torch package beside it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12     # non-tensor float32 peak (no int32 entry)
# int32 issue rate: 132 SMs x 64 INT32 lanes x 1.98 GHz boost (Hopper
# white paper, H100 SXM)
H100_INT32_OPS_PER_S = 132 * 64 * 1.98e9
CDEF_SPEED8 = (0, 0, 0, 0, 3)  # the main path's cdef argument


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


def slice_1080p(torch, ec, ti):
    """Phase 5. Returns (the kernels-line entry of the od_ec kernel, the
    timed run's KeyframeDevice, the planes)."""
    planes = synth(1920, 1088)[0]
    captured = []

    class Capture(ec.RecordingEncoder):
        def done(self):
            captured.append(self.ir_tensor())
            return super().done()

    orig = ti.RecordingEncoder
    ti.RecordingEncoder = Capture
    try:
        t0 = time.perf_counter()
        pkt_w, _ = ti.encode_keyframe_tpu(planes, 100, speed=10,
                                          device="cuda")
        print(f"# 1080p warm run {time.perf_counter() - t0:.3f} s",
              flush=True)
    finally:
        ti.RecordingEncoder = orig
    ir = captured[0]
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
          f"bound {max(t_bytes, t_ops):.5f} ms, launches {launches}",
          flush=True)
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


def _pri_adj(torch, cd, var, pri, chroma: bool):
    """The primary strength per pixel after luma's variance adjustment
    (var: the per-8x8 grid; pri: the unadjusted strength, per pixel or
    an int)."""
    if chroma:
        return pri
    v = cd._upsample(var, 8).long()
    vs = torch.where((v >> 6) > 0,
                     torch.clamp(cd._msb(v >> 6).long(), max=12), 0)
    return torch.where(v > 0, (pri * (4 + vs) + 8) >> 4, 0)


def _cdef_ops(torch, cd, dirs, var, skip8, chroma: bool, entries):
    """Integer operations of one CDEF pass (cdef_apply) on these inputs:
    an inactive pixel (skipped unit, or both strengths 0) is kept as it
    is; an active one constrains its 4 primary taps, and its 8 secondary
    taps when the secondary strength is > 0, at 11 ops a tap
    (difference, |.|, shift, limit, min, sign, weight, add, in-frame
    test, max, min), plus 8 to round and clip; luma's variance
    adjustment adds 6 per active 8x8 unit. entries: the ladder index per
    pixel."""
    sk = cd._upsample(skip8, 4 if chroma else 8)
    lad = torch.tensor(cd.CDEF_LADDER, dtype=torch.int64, device=sk.device)
    k = entries.long()
    pri = lad[k, 2 if chroma else 0]
    sec = lad[k, 3 if chroma else 1]
    pa = _pri_adj(torch, cd, var, pri, chroma)
    active = (~sk) & ((pa > 0) | (sec > 0))
    per = 4 * 11 + (sec > 0).long() * 8 * 11 + 8
    ops = int(torch.sum(torch.where(active, per, 0)))
    return ops if chroma else ops + int(active.sum()) // 64 * 6


def _cdef_ladder_ops(torch, cd, dirs, var, skip8, chroma: bool, mask):
    """Integer operations of the 8-entry ladder SSE (cdef_ladder_sse) on
    these inputs, counting once what the entries share. Per pixel that
    some entry filters, each tap's difference, |.|, in-frame test and
    its clamp window's max and min (5 ops; the secondary taps only where
    an entry with a secondary strength filters it: the window of the
    entries with secondary taps extends the primary one); the error of
    the unfiltered pixel against the source (3, every pixel). Per pixel
    and entry that filters it: each tap's shift, limit, min, sign,
    weight and add (6), 8 to round and clip, 3 for the squared error and
    its sum; luma's variance adjustment, 6 per 8x8 unit and entry.
    mask: the pixels the table covers (all if None)."""
    n = 4 if chroma else 8
    sk = cd._upsample(skip8, n)
    if mask is not None:
        sk = sk | ~mask
    act_any = torch.zeros_like(sk)
    sec_any = torch.zeros_like(sk)
    per_entry = 0
    for pri, sec in (e[2:] if chroma else e[:2] for e in cd.CDEF_LADDER):
        act = (~sk) & ((_pri_adj(torch, cd, var, pri, chroma) > 0)
                       | (sec > 0))
        na = int(act.sum())
        act_any |= act
        if sec > 0:
            sec_any |= act
        per_entry += na * (4 * 6 + (8 * 6 if sec > 0 else 0) + 8 + 3)
        if not chroma:
            per_entry += na // 64 * 6
    npx = sk.numel() if mask is None else int(mask.sum())
    return (int(act_any.sum()) * 4 * 5 + int(sec_any.sum()) * 8 * 5
            + 3 * npx + per_entry)


def _sampled_mask(torch, h, w, b, dev):
    """The pixels of the TL and BR b x b quadrant of each 2b x 2b SB."""
    r = (torch.arange(h, device=dev) // b) % 2
    c = (torch.arange(w, device=dev) // b) % 2
    return r[:, None] == c[None, :]


def cdef_phase(torch, cd, planes_d, srcs_d, skip8):
    """Phase 6 on one frame: every CDEF kernel against its plain version
    on the same inputs (dir, var, the SSE tables and the applied planes
    exactly equal), device ms (CUDA events, mean of 3) of kernel and
    plain, and the bound (cdef_apply's on the map of every entry). Returns {kernel: (ms, plain_ms, bound_ms,
    bound_by)} summed over the planes of one frame."""
    h, w = planes_d[0].shape
    sampled = h % 64 == 0 and w % 64 == 0
    dirs, var = cd.cdef_dirs(planes_d[0])
    dp, vp = cd.cdef_dirs_plain(planes_d[0])
    if not (torch.equal(dirs, dp) and torch.equal(var, vp)):
        fail(f"{w}x{h}: cdef_dirs kernel and plain version differ")
    res = {}
    nb = dirs.numel()
    t_b = (h * w + 5 * nb) / H100_BYTES_PER_S * 1e3
    t_o = 864 * nb / H100_INT32_OPS_PER_S * 1e3
    res["cdef_dirs"] = [
        time_cuda(torch, lambda: cd.cdef_dirs(planes_d[0]), 3),
        time_cuda(torch, lambda: cd.cdef_dirs_plain(planes_d[0]), 3),
        max(t_b, t_o), "bytes" if t_b >= t_o else "operations"]
    sses = []
    for k in ("cdef_ladder_sse", "cdef_apply"):
        res[k] = [0.0, 0.0, 0.0, 0.0]
    for i, (p, s) in enumerate(zip(planes_d, srcs_d)):
        chroma = i > 0
        args = (p, s, dirs, var, skip8, CDEF_SPEED8[4], chroma, sampled)
        got = cd.cdef_ladder_sse(*args)
        want = cd.cdef_ladder_sse_plain(*args)
        if not torch.equal(got, want):
            fail(f"{w}x{h} plane {i}: cdef_ladder_sse kernel and plain "
                 f"version differ (max |err| "
                 f"{int((got.long() - want.long()).abs().max())})")
        sses.append(got)
        ph, pw = p.shape
        mask = (_sampled_mask(torch, ph, pw, 16 if chroma else 32, p.device)
                if sampled else None)
        t_o = _cdef_ladder_ops(torch, cd, dirs, var, skip8, chroma,
                               mask) / H100_INT32_OPS_PER_S * 1e3
        t_b = (2 * ph * pw + 32 * got[0].numel()) / H100_BYTES_PER_S * 1e3
        r = res["cdef_ladder_sse"]
        r[0] += time_cuda(torch, lambda: cd.cdef_ladder_sse(*args), 3)
        r[1] += time_cuda(torch, lambda: cd.cdef_ladder_sse_plain(*args), 3)
        r[2] += max(t_b, t_o)
        r[3] += t_o - t_b
    nby, nbx = h // 32, w // 32
    nr, nc = (nby + 1) // 2, (nbx + 1) // 2
    idx = cd._choose(cd._sse_sb(sses, sampled, nr, nc),
                     torch.tensor(60.0, device=dirs.device))
    every = (torch.arange(nr * nc, device=dirs.device) % 8).reshape(nr, nc)
    winners_ms = 0.0
    for i, p in enumerate(planes_d):
        chroma = i > 0
        args = (p, dirs, var, skip8, CDEF_SPEED8[4], chroma)
        for ix in (idx, every):
            got = cd.cdef_apply(*args, idx=ix)
            want = cd.cdef_apply_plain(*args, idx=ix)
            if not torch.equal(got, want):
                fail(f"{w}x{h} plane {i}: cdef_apply kernel and plain "
                     "version differ")
        # the uniform mode, chroma with no primary strength (direction 0)
        pri, sec = (0, 2) if chroma else (3, 1)
        got = cd.cdef_apply(*args, pri=pri, sec=sec)
        want = cd.cdef_apply_plain(*args, pri=pri, sec=sec)
        if not torch.equal(got, want):
            fail(f"{w}x{h} plane {i}: uniform-strength cdef_apply kernel "
                 "and plain version differ")
        # timed and bounded on `every` (7 of 8 SBs filtered, at every
        # entry); the winners' map of this frame may filter nothing
        sbs = 32 if chroma else 64
        ph, pw = p.shape
        ent = cd._upsample(every, sbs)[:ph, :pw]
        t_o = _cdef_ops(torch, cd, dirs, var, skip8, chroma,
                        ent) / H100_INT32_OPS_PER_S * 1e3
        t_b = 2 * ph * pw / H100_BYTES_PER_S * 1e3
        r = res["cdef_apply"]
        r[0] += time_cuda(torch, lambda: cd.cdef_apply(*args, idx=every), 3)
        r[1] += time_cuda(torch,
                          lambda: cd.cdef_apply_plain(*args, idx=every), 3)
        r[2] += max(t_b, t_o)
        r[3] += t_o - t_b
        winners_ms += time_cuda(torch,
                                lambda: cd.cdef_apply(*args, idx=idx), 3)
    for k in ("cdef_ladder_sse", "cdef_apply"):
        res[k][3] = "operations" if res[k][3] >= 0 else "bytes"
    print(f"# CDEF kernels vs plain at {w}x{h} ("
          f"{'sampled' if sampled else 'full'} branch, idx used "
          f"{sorted(set(idx.flatten().tolist()))}): dir, var, SSE tables "
          "and applied planes (the winners, every entry, a uniform "
          "strength) identical (max |err| 0); per frame ms "
          "(kernel, plain, bound, bound by; cdef_apply on the map of "
          "every entry): "
          + json.dumps({k: [round(v, 5) if isinstance(v, float) else v
                            for v in r] for k, r in res.items()})
          + f"; cdef_apply on the winners' map {winners_ms:.5f} ms",
          flush=True)
    return res


def gpu_vs_cpu(torch, ti):
    """Phase 6."""
    planes = synth(256, 192)[0]
    kd = {d: ti.analyze_keyframe(planes, 100, speed=10, device=d)
          for d in ("cuda", "cpu")}
    lv = {d: [x.cpu().numpy() for x in kd[d].state[3:6]] for d in kd}
    diff = [np.abs(a.astype(np.int64) - b) for a, b in
            zip(lv["cuda"], lv["cpu"])]
    ndiff = sum(int((x != 0).sum()) for x in diff)
    ntot = sum(x.size for x in diff)
    dmax = max(int(x.max()) for x in diff)
    pk = {d: ti.encode_keyframe_tpu(planes, 100, speed=10, device=d)
          for d in kd}
    same_pkt = pk["cuda"][0] == pk["cpu"][0]
    print(f"# 256x192 cuda vs cpu: {ndiff} of {ntot} levels differ "
          f"(max |d| {dmax}); packets identical: {same_pkt}", flush=True)
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


def gather_phase(torch, gp):
    """Phase 4. Per patch size: max |err|, kernel / plain / indexing ms
    (device time by CUDA events, mean of 20 launches) and the byte
    bound."""
    B = 2040
    rng = np.random.default_rng(5)
    out = {}
    for P, H, W, blk in ((43, 1152, 1984, 32), (39, 1152, 1984, 32),
                         (23, 576, 992, 16)):
        plane = torch.from_numpy(
            rng.integers(0, 256, (H, W)).astype(np.int32)).cuda()
        # the main path's layout: a 34 x 60 block grid with per-block
        # drift, plus starts below 0 and past H-P / W-P
        gy, gx = np.divmod(np.arange(B), 60)
        r0 = gy * blk + rng.integers(0, 2 * blk - 8, B)
        c0 = gx * blk + rng.integers(0, 2 * blk - 8, B)
        r0[:4] = [-1, -2 * P, H - P + 3, H + 40]
        c0[:4] = [W, -5, W - P + 1, -3 * W]
        r0_t, c0_t = (torch.from_numpy(x.astype(np.int32)).cuda()
                      for x in (r0, c0))
        got = gp.gather_patches(plane, r0_t, c0_t, P)
        want = gp.gather_patches_plain(plane, r0_t, c0_t, P)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        if err != 0 or not torch.equal(got, want):
            fail(f"gather P={P}: kernel and plain version differ "
                 f"(max |err| {err})")
        ar = torch.arange(P, device="cuda")
        rr = gp._starts(r0_t, H, P)[:, None, None] + ar[None, :, None]
        cc = gp._starts(c0_t, W, P)[:, None, None] + ar[None, None, :]
        ms = time_cuda(torch, lambda: gp.gather_patches(plane, r0_t, c0_t,
                                                         P), 20)
        plain_ms = time_cuda(torch, lambda: gp.gather_patches_plain(
            plane, r0_t, c0_t, P), 20)
        lib_ms = time_cuda(torch, lambda: plane[rr, cc], 20)
        paced = time_cuda(torch, lambda: gp.gather_patches(
            plane, r0_t, c0_t, P), 20, hold=False)
        written = 4 * B * P * P
        nbytes = written + min(4 * H * W, written) + 8 * B
        bound = nbytes / H100_BYTES_PER_S * 1e3
        print(f"# gather P={P} B={B} from [{H}, {W}]: kernel {ms:.5f} ms, "
              f"plain {plain_ms:.5f} ms, indexing call {lib_ms:.5f} ms, "
              f"bound {bound:.5f} ms ({nbytes / 1e6:.2f} MB at 3.35 TB/s), "
              f"max |err| {err}; launches as the host paces them "
              f"{paced:.5f} ms each", flush=True)
        out[P] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                  "bound_ms": bound, "err": err}
    return out


def _level_diffs(a_list, b_list):
    diff = [np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64))
            for a, b in zip(a_list, b_list)]
    return (sum(int((x != 0).sum()) for x in diff),
            sum(x.size for x in diff), max(int(x.max()) for x in diff))


def gop_gpu_vs_cpu(torch, ti, tp, w, h, speed, cdef=None):
    """Phases 8 and 9: a KEY + 1 P GOP on cuda and on cpu."""
    frames = synth(w, h, n=2)
    kd = {d: ti.analyze_keyframe(frames[0], 100, speed=speed, cdef=cdef,
                                 device=d)
          for d in ("cuda", "cpu")}
    kf = _level_diffs([x.cpu().numpy() for x in kd["cuda"].state[3:6]],
                      [x.cpu().numpy() for x in kd["cpu"].state[3:6]])
    orig = tp._fetch_packed

    def run(device):
        """The GOP's packets and its P frame's fetched decisions."""
        got = []

        def recording_fetch(o, *a, **k):
            got.append(orig(o, *a, **k))
            return got[-1]

        tp._fetch_packed = recording_fetch
        try:
            pkts, _ = tp.encode_gop_tpu(frames, 100, speed=speed,
                                        cdef=cdef, device=device)
        finally:
            tp._fetch_packed = orig
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
          f"{maps_same}; packets identical: {same_pkts}", flush=True)
    if share < 0.99:
        fail("cuda and cpu agree on fewer than 99% of the P blocks")
    for nd, nt, dmax in (kf, pf):
        if dmax > 1 or nd * 1e4 >= nt:
            fail("cuda and cpu levels differ beyond |d| = 1 at < 1e-4")
    if (kf[0] == 0 and pf[0] == 0 and agree.all()
            and not (maps_same and all(same_pkts))):
        fail("every MV, skip and level agrees but the CDEF maps or the "
             "packets differ")


def gop_1080p(torch, ec, gp, cd, ti, tp, n: int, speed: int, cdef=None):
    """Phases 10 and 11: a 1920x1088 KEY + (n - 1) P GOP on cuda, every
    kernel's count set to 0 just before it and read just after. Checks
    that every frame launched each kernel that serves it (the keyframe:
    ec_pack, and the three CDEF kernels with cdef; each P frame: also
    gather_patches). Returns ({kernel: launches}, gather launches per
    patch size, P frames)."""
    frames = synth(1920, 1088, n=n)
    h, w = frames[0][0].shape
    nsb = ((h // 32 + 1) // 2) * ((w // 32 + 1) // 2)
    captured = []

    class Capture(ec.RecordingEncoder):
        def done(self):
            captured.append(self.ir_tensor())
            return super().done()

    sizes: dict = {}

    def counting_gather(plane, r0, c0, P):
        sizes[P] = sizes.get(P, 0) + 1
        return gp.gather_patches(plane, r0, c0, P)

    kern = {"gather_patches": gp.gather_patches, "ec_pack": ec.pack_ir}
    if cdef is not None:
        kern.update(cdef_dirs=cd.cdef_dirs,
                    cdef_ladder_sse=cd.cdef_ladder_sse,
                    cdef_apply=cd.cdef_apply)
    marks = []
    chosen = []                 # each frame's CDEF ladder entries, counted

    def mark():
        marks.append({k: f.launches for k, f in kern.items()})

    orig_pack, orig_kpack = tp._pack_pframe, ti.pack_keyframe

    def marking(fn):
        def wrapped(*a, **k):
            mark()
            if cdef is not None:
                # the P frame's map, or the keyframe's meta tail
                cmap = (k["cdef"][1] if fn is orig_pack
                        else a[0].meta[-nsb:].cpu().numpy())
                chosen.append(np.bincount(
                    np.asarray(cmap, np.int64).ravel(), minlength=8)
                    .tolist())
            r = fn(*a, **k)
            mark()
            return r
        return wrapped

    saved = (ti.RecordingEncoder, tp.RecordingEncoder, tp.gather_patches)
    ti.RecordingEncoder = tp.RecordingEncoder = Capture
    tp.gather_patches = counting_gather
    tp._pack_pframe = marking(orig_pack)
    ti.pack_keyframe = marking(orig_kpack)
    timings: list = []
    try:
        for f in kern.values():
            f.launches = 0
        t0 = time.perf_counter()
        pkts, recs = tp.encode_gop_tpu(frames, 100, speed=speed, cdef=cdef,
                                       device="cuda", timings=timings)
        wall = time.perf_counter() - t0
        launches = {k: f.launches for k, f in kern.items()}
    finally:
        ti.RecordingEncoder, tp.RecordingEncoder, tp.gather_patches = saved
        tp._pack_pframe, ti.pack_keyframe = orig_pack, orig_kpack
    n_p = len(frames) - 1
    print(f"# 1080p GOP (KEY + {n_p} P, speed {speed}, cdef {cdef}, q 100, "
          f"cuda): {wall:.3f} s; packets {[len(p) for p in pkts]} bytes; "
          f"launches {json.dumps(launches)}, gather by patch size {sizes}",
          flush=True)
    for i, t in enumerate(timings):
        print(f"# frame {i} stages (s): "
              + json.dumps({k: round(v, 4) for k, v in t.items()}),
              flush=True)
    if chosen:
        print(f"# CDEF ladder entries chosen per frame (SBs per entry "
              f"0..7): {chosen}", flush=True)
    if len(marks) != 2 * len(frames):
        fail(f"{len(marks) // 2} frames packed, {len(frames)} expected")
    prev = {k: 0 for k in kern}
    for i in range(len(frames)):
        before, after = marks[2 * i], marks[2 * i + 1]
        step = {k: before[k] - prev[k] for k in kern}
        need = [k for k in kern if k not in ("ec_pack", "gather_patches")]
        if i > 0:
            need.append("gather_patches")
        bad = [k for k in need if step[k] < 1]
        if after["ec_pack"] - before["ec_pack"] < 1:
            bad.append("ec_pack")
        if bad:
            fail(f"frame {i} did not launch {bad} (device half {step}, "
                 f"pack {after['ec_pack'] - before['ec_pack']})")
        prev = after
    if len(captured) != len(frames):
        fail(f"{len(captured)} tiles coded, {len(frames)} expected")
    for i, (ir, pkt) in enumerate(zip(captured, pkts)):
        c_p, st_p = ec.pack_ir_plain(ir)
        if ec.finish(c_p.tolist(), *st_p[:3].tolist()) not in pkt:
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
    print(f"# 1080p GOP: {len(captured)} tiles ({rows} symbols) re-coded "
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
    return launches, sizes, n_p


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from rav1e_tpu_torch import nvcc
    import rav1e_tpu_torch.entropy.ec_cuda as ec
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
    libs = nvcc.build_all([ec.SRC, gp.SRC, cd.SRC])
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

    kernel_vs_plain(torch, ec)
    gather = gather_phase(torch, gp)
    ec_entry, kd, planes = slice_1080p(torch, ec, ti)
    # phase 6: the CDEF kernels on the deblocked 1080p keyframe recon
    # (sampled branch) and on it cut to 1920x1056 (full branch)
    h, w = planes[0].shape
    rp = kd.rec_packed
    rec_d = [rp[:h], rp[h:, :w // 2], rp[h:, w // 2:]]
    src_d = [torch.from_numpy(p).cuda() for p in planes]
    skip8 = ti._kf_skip8(kd.state)
    cdef_ms = cdef_phase(torch, cd, rec_d, src_d, skip8)
    cut = [rec_d[0][:1056], rec_d[1][:528], rec_d[2][:528]]
    cdef_phase(torch, cd, cut, [src_d[0][:1056], src_d[1][:528],
                                src_d[2][:528]], skip8[:132])
    gpu_vs_cpu(torch, ti)
    gop_gpu_vs_cpu(torch, ti, tp, 512, 384, 10)
    gop_gpu_vs_cpu(torch, ti, tp, 256, 192, 8, CDEF_SPEED8)
    gop_1080p(torch, ec, gp, cd, ti, tp, 2, 10)
    # the main path: the speed-8 GOP with CDEF
    launches, sizes, n_p = gop_1080p(torch, ec, gp, cd, ti, tp, 3, 8,
                                     CDEF_SPEED8)

    # the gather entry: one P frame's launches at the measured sizes
    per_frame = {P: n / n_p for P, n in sizes.items()}
    if set(per_frame) - set(gather):
        fail(f"the GOP gathered patch sizes {sorted(per_frame)}, phase 4 "
             f"measured {sorted(gather)}")

    def frame_sum(key):
        return sum(k * gather[P][key] for P, k in per_frame.items())

    bound = frame_sum("bound_ms")
    gather_entry = {
        "name": "gather_patches", "route": "cuda",
        "source": "rav1e_tpu_torch/csrc/gather_patches.cu",
        "replaces": "tools/bench_gather.py:65",
        "launches": launches["gather_patches"],
        "max_abs_err": max(g["err"] for g in gather.values()),
        "ms": frame_sum("ms"), "plain_ms": frame_sum("plain_ms"),
        "bound_ms": bound, "bound_by": "bytes",
        "library_ms": frame_sum("library_ms")}
    print(f"# gather per P frame ({per_frame} launches by patch size): "
          f"kernel {gather_entry['ms']:.5f} ms, bound {bound:.5f} ms",
          flush=True)
    ec_entry["launches"] = launches["ec_pack"]
    replaces = {"cdef_dirs": "rav1e_tpu/ops/tpu/cdef.py:58",
                "cdef_ladder_sse": "rav1e_tpu/ops/tpu/cdef.py:281",
                "cdef_apply": "rav1e_tpu/ops/tpu/cdef.py:220"}
    cdef_entries = [
        {"name": k, "route": "cuda",
         "source": "rav1e_tpu_torch/csrc/cdef.cu", "replaces": replaces[k],
         "launches": launches[k], "max_abs_err": 0, "ms": r[0],
         "plain_ms": r[1], "bound_ms": r[2], "bound_by": r[3],
         "library_ms": None} for k, r in cdef_ms.items()]
    print(json.dumps({"kernels": [ec_entry, gather_entry]
                      + cdef_entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
