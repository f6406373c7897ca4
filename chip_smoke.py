#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rav1e_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:
  1. the card (nvidia-smi name + power limit), torch and CUDA versions;
  2. the build of csrc/ec_pack.cu and csrc/gather_patches.cu with nvcc
     for sm_90a, one nvcc process each, started together;
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
  5. the speed-10 keyframe slice at 1920x1088 on cuda, once to warm and
     once timed: stage times, the launch count of the main-path run, the
     tile's IR coded again by pack_ir_plain with identical bytes, and the
     ec kernels' device time (CUDA events) at L = 256, 512, 1024, 2048
     with identical bytes at each, and per pass at the default L = 512;
  6. the port on cuda vs the port on cpu, keyframe at 256x192: level
     differences (|d| = 1 at < 1e-4 of the coefficients allowed, from the
     f32 forward transform) and identical recon wherever no differing
     level is upstream;
  7. encode_gop_tpu on cuda vs on cpu at 512x384, KEY + 1 P: the share
     of blocks whose (mv, skip) agree (>= 99%), levels by phase 6's rule,
     identical packets where every map and level agrees;
  8. encode_gop_tpu at 1920x1088, KEY + 2 P, speed 10, q 100: per-frame
     stage times and packet sizes; every P frame launched gather_patches
     and ec_pack; every tile's IR coded again by pack_ir_plain gives the
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
    """Phase 5. Returns the kernels-line entry of the od_ec kernel."""
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
    ec.pack_ir.launches = 0
    t0 = time.perf_counter()
    pkt, rec = ti.encode_keyframe_tpu(planes, 100, speed=10,
                                      device="cuda", timings=timings)
    wall = time.perf_counter() - t0
    launches = ec.pack_ir.launches
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
            "library_ms": None}


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


def gpu_vs_cpu(torch, ti):
    """Phase 6."""
    planes = synth(256, 192)[0]
    kd = {d: ti.analyze_keyframe(planes, 100, device=d)
          for d in ("cuda", "cpu")}
    lv = {d: [x.cpu().numpy() for x in kd[d].state[3:6]] for d in kd}
    diff = [np.abs(a.astype(np.int64) - b) for a, b in
            zip(lv["cuda"], lv["cpu"])]
    ndiff = sum(int((x != 0).sum()) for x in diff)
    ntot = sum(x.size for x in diff)
    dmax = max(int(x.max()) for x in diff)
    pk = {d: ti.encode_keyframe_tpu(planes, 100, device=d) for d in kd}
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


def gop_gpu_vs_cpu(torch, ti, tp):
    """Phase 7."""
    frames = synth(512, 384, n=2)
    kd = {d: ti.analyze_keyframe(frames[0], 100, device=d)
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
            pkts, _ = tp.encode_gop_tpu(frames, 100, speed=10,
                                        device=device)
        finally:
            tp._fetch_packed = orig
        return pkts, got[0]

    (pk_g, g), (pk_c, c) = run("cuda"), run("cpu")
    agree = np.all(g[0] == c[0], axis=1) & (g[1] == c[1])
    share = float(agree.mean())
    pf = _level_diffs([x[agree] for x in g[2:5]],
                      [x[agree] for x in c[2:5]])
    same_pkts = [a == b for a, b in zip(pk_g, pk_c)]
    print(f"# 512x384 GOP cuda vs cpu: (mv, skip) agree on "
          f"{int(agree.sum())} of {agree.size} blocks ({100 * share:.2f}%); "
          f"keyframe levels differ {kf[0]} of {kf[1]} (max |d| {kf[2]}); "
          f"P levels on agreeing blocks differ {pf[0]} of {pf[1]} "
          f"(max |d| {pf[2]}); packets identical: {same_pkts}", flush=True)
    if share < 0.99:
        fail("cuda and cpu agree on fewer than 99% of the P blocks")
    for nd, nt, dmax in (kf, pf):
        if dmax > 1 or nd * 1e4 >= nt:
            fail("cuda and cpu levels differ beyond |d| = 1 at < 1e-4")
    if kf[0] == 0 and pf[0] == 0 and agree.all() and not all(same_pkts):
        fail("every map and level agrees but the packets differ")


def gop_1080p(torch, ec, gp, ti, tp):
    """Phase 8. Returns (gather launches, launches per patch size, P
    frames) of the main-path run."""
    frames = synth(1920, 1088, n=3)
    captured = []

    class Capture(ec.RecordingEncoder):
        def done(self):
            captured.append(self.ir_tensor())
            return super().done()

    sizes: dict = {}

    def counting_gather(plane, r0, c0, P):
        sizes[P] = sizes.get(P, 0) + 1
        return gp.gather_patches(plane, r0, c0, P)

    marks = []
    orig_pack = tp._pack_pframe

    def marking_pack(*a, **k):
        marks.append((gp.gather_patches.launches, ec.pack_ir.launches))
        r = orig_pack(*a, **k)
        marks.append((gp.gather_patches.launches, ec.pack_ir.launches))
        return r

    saved = (ti.RecordingEncoder, tp.RecordingEncoder, tp.gather_patches)
    ti.RecordingEncoder = tp.RecordingEncoder = Capture
    tp.gather_patches = counting_gather
    tp._pack_pframe = marking_pack
    timings: list = []
    try:
        gp.gather_patches.launches = 0
        ec.pack_ir.launches = 0
        t0 = time.perf_counter()
        pkts, recs = tp.encode_gop_tpu(frames, 100, speed=10,
                                       device="cuda", timings=timings)
        wall = time.perf_counter() - t0
        launches = (gp.gather_patches.launches, ec.pack_ir.launches)
    finally:
        ti.RecordingEncoder, tp.RecordingEncoder, tp.gather_patches = saved
        tp._pack_pframe = orig_pack
    n_p = len(frames) - 1
    print(f"# 1080p GOP (KEY + {n_p} P, speed 10, q 100, cuda): "
          f"{wall:.3f} s; packets {[len(p) for p in pkts]} bytes; "
          f"gather launches {launches[0]} by patch size {sizes}, ec "
          f"launches {launches[1]}", flush=True)
    for i, t in enumerate(timings):
        print(f"# frame {i} stages (s): "
              + json.dumps({k: round(v, 4) for k, v in t.items()}),
              flush=True)
    if len(marks) != 2 * n_p:
        fail(f"{len(marks) // 2} P frames packed, {n_p} expected")
    prev_g = 0
    for i in range(n_p):
        (g0, e0), (g1, e1) = marks[2 * i], marks[2 * i + 1]
        if g0 - prev_g < 1 or e1 - e0 < 1:
            fail(f"P frame {i + 1} launched gather_patches {g0 - prev_g} "
                 f"and ec_pack {e1 - e0} times")
        prev_g = g1
    if marks[0][1] < 1:
        fail("the GOP's keyframe did not launch ec_pack")
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
          "by pack_ir_plain: identical bytes", flush=True)
    for i, ir in enumerate(captured):
        ir_d = ir.cuda()
        ms = {L: time_cuda(torch, lambda: ec.pack_ir(ir_d, chunk_rows=L), 3)
              for L in (256, ec.CHUNK_ROWS, 1024)}
        print(f"# frame {i} tile ({ir.shape[0]} symbols): ec kernel "
              f"{ms[ec.CHUNK_ROWS]:.4f} ms at L = {ec.CHUNK_ROWS}; by L: "
              f"{json.dumps({L: round(t, 4) for L, t in ms.items()})}; "
              f"passes (ms): {json.dumps(pass_times(torch, ec, ir_d))}",
              flush=True)
    return launches[0], sizes, n_p


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from rav1e_tpu_torch import nvcc
    import rav1e_tpu_torch.entropy.ec_cuda as ec
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
    libs = nvcc.build_all([ec.SRC, gp.SRC])
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
    ec_entry = slice_1080p(torch, ec, ti)
    gpu_vs_cpu(torch, ti)
    gop_gpu_vs_cpu(torch, ti, tp)
    n_gather, sizes, n_p = gop_1080p(torch, ec, gp, ti, tp)

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
        "launches": n_gather,
        "max_abs_err": max(g["err"] for g in gather.values()),
        "ms": frame_sum("ms"), "plain_ms": frame_sum("plain_ms"),
        "bound_ms": bound, "bound_by": "bytes",
        "library_ms": frame_sum("library_ms")}
    print(f"# gather per P frame ({per_frame} launches by patch size): "
          f"kernel {gather_entry['ms']:.5f} ms, bound {bound:.5f} ms",
          flush=True)
    print(json.dumps({"kernels": [ec_entry, gather_entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
