"""Decides `correct`: the stream check over every packet of the session,
the decode of a sample of the window's coded frames against the
reconstruction each left as a reference, and the fidelity of every coded
frame's reconstruction to the frame sent; each number beside its limit
(`portbench/limits/<cell>.json`, set from sound runs and from the
control; PERF.md gives the readings)."""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field

import numpy as np

from portbench.reference.av1 import Unsupported
from portbench.reference.decode import decode_frame
from portbench.reference.fidelity import frame_numbers
from portbench.reference.stream import check_stream

# number -> how it is gathered over the frames
WORST = ("mse_y", "mse_uv", "sb_mse_y")


@dataclass
class Verdict:
    correct: bool
    numbers: dict                 # name -> (value, limit or None)
    failed_frames: set
    notes: list = field(default_factory=list)


def judge(packets, calls, content, content_frames: int, guarantees: dict,
          limits: dict, seed: int = 0, window_packets=()) -> Verdict:
    """packets: [(data, claimed frameno)] as returned by the session;
    calls: the pipeline calls in coding order, each with .data and .rec;
    content: gives frame(i) for the content_frames frames sent;
    window_packets: indices of the packets that arrived in the window,
    from whose coded frames the decode sample is drawn (seeded by `seed`).
    Each recon is judged against the frame its call coded; the stream
    check holds that frame to the one its order hint names."""
    rep = check_stream(packets, guarantees)
    notes = [f"packet {k}: {why}" for k, why in rep.faults[:20]]
    bad = set(rep.bad_packets)
    worst = {n: 0.0 for n in WORST}
    per_frame_bad = set()
    coded_all = [k for k, (d, f) in enumerate(packets)
                 if not _is_show_existing(d)]
    if len(coded_all) != len(calls):
        notes.append(f"{len(coded_all)} coded packets, {len(calls)} "
                     "pipeline calls")
        bad.add(-1)
    call_of = dict(zip(coded_all, calls))
    for k, c in call_of.items():
        if packets[k][0] != c.data:
            notes.append(f"packet {k} is not its pipeline call's")
            bad.add(k)
    for k, c in call_of.items():
        f = packets[k][1]          # the frame this call coded
        if not 0 <= f < content_frames:
            bad.add(k)
            continue
        nums = frame_numbers(c.rec, content.frame(f))
        for n, v in nums.items():
            worst[n] = max(worst[n], v)
            lim = limits.get(n)
            if lim is not None and v > lim:
                per_frame_bad.add(f)
    mismatch = decode_sample(rep, call_of, packets, seed, window_packets,
                             notes)
    numbers = {"stream_faults": (len(bad), limits.get("stream_faults", 0)),
               "decode_mismatch": (len(mismatch),
                                   limits.get("decode_mismatch", 0))}
    for n in WORST:
        numbers[n] = (worst[n], limits.get(n))
    failed = {packets[k][1] for k in bad | mismatch if k >= 0} | \
        per_frame_bad
    ok = all(lim is None or v <= lim for v, lim in numbers.values())
    return Verdict(ok, numbers, failed, notes)


def decode_sample(rep, call_of, packets, seed, window_packets, notes) -> set:
    """Decode one coded frame of each class (KEY, P, B0, B1) among those
    that arrived in the window, drawn from the seed, from the kept
    reconstructions of the frames in its reference slots; returns the
    packets whose decode is not the reconstruction their call kept (or
    that could not be decoded)."""
    rng = random.Random(seed)
    by_cls = {}
    for k in sorted(set(window_packets)):
        if k in rep.coded and k in call_of:
            by_cls.setdefault(rep.coded[k][2], []).append(k)
    rec_of = {rep.frames[k]: call_of[k].rec for k in rep.coded
              if k in call_of}
    bad = set()
    for cls in sorted(by_cls):
        k = rng.choice(by_cls[cls])
        fr, seq, _, slots = rep.coded[k]
        refs = {i: rec_of[f] for i, f in enumerate(slots) if f in rec_of}
        t = time.perf_counter()
        try:
            out = decode_frame(fr, seq, refs)
            rec = [np.asarray(p) for p in call_of[k].rec]
            diff = [int((o != r).sum()) if o.shape == r.shape else -1
                    for o, r in zip(out, rec)]
        except Unsupported as e:
            diff = [f"not decoded: {e}"]
        notes.append(f"decoded {cls} frame {rep.frames[k]} (packet {k}, "
                     f"{len(packets[k][0])} bytes) in "
                     f"{time.perf_counter() - t:.1f} s; samples that "
                     f"differ from its reconstruction, y u v: {diff}")
        if any(d != 0 for d in diff):
            bad.add(k)
    return bad


def _is_show_existing(data: bytes) -> bool:
    from portbench.reference.av1 import OBU_FRAME_HEADER, obus
    try:
        return any(t == OBU_FRAME_HEADER for t, _ in obus(data))
    except ValueError:
        return False
