"""The stream's structure against what the configuration guarantees, by a
plain decoder model over the headers (`av1.Decoder`): each packet reads,
every frame is displayed once and in input order, each frame's identity
(its order hint since the last keyframe) is the input frame the session
says it codes, each frame's quantizer is the fixed-quantizer rule's for
its place in the pyramid, and the sizes, loop filters and tiles are the
configuration's."""

from __future__ import annotations

from dataclasses import dataclass, field

from portbench.reference.av1 import KEY, Decoder, Unsupported, _rel


@dataclass
class StreamReport:
    faults: list = field(default_factory=list)       # (packet index, why)
    frames: dict = field(default_factory=dict)       # packet index -> frameno
    displayed: list = field(default_factory=list)    # framenos in order
    keyframes: list = field(default_factory=list)    # framenos
    # per coded packet index: its header, the sequence header in force,
    # its class (KEY / P / B0 / B1) and the frame held in each slot
    # before it
    coded: dict = field(default_factory=dict)

    @property
    def bad_packets(self) -> set:
        return {k for k, _ in self.faults}


def check_stream(packets, g: dict) -> StreamReport:
    """packets: [(data, claimed frameno)] in the order the session
    returned them. g: the configuration's `guarantees`."""
    dec = Decoder()
    rep = StreamReport()
    kf = None                 # identity of the last keyframe
    slot_frame = [None] * 8   # identity in each slot
    slot_cls = [None] * 8     # KEY / P / B0 / B1 of each slot's frame
    shown = set()
    nxt = 0                   # next frame to display

    def fault(k, why):
        rep.faults.append((k, why))

    for k, (data, claimed) in enumerate(packets):
        try:
            u = dec.unit(data)
        except Unsupported as e:
            fault(k, f"unreadable: {e}")
            continue
        fr = u.frame
        if fr.show_existing:
            f = slot_frame[fr.show_idx]
            if f is None or f in shown:
                fault(k, f"show-existing of slot {fr.show_idx} ({f}), "
                         "shown already or empty")
                continue
            if f != nxt:
                fault(k, f"displays frame {f}, {nxt} is due")
            if claimed != f:
                fault(k, f"session says frame {claimed}, slot holds {f}")
            shown.add(f)
            rep.displayed.append(f)
            nxt = f + 1
            continue
        if fr.frame_type == KEY:
            s = u.seq
            if s is None:
                fault(k, "keyframe without a sequence header")
                continue
            want = (tuple(g["coded_size"]), g["bit_depth"],
                    tuple(g["subsampling"]), g["cdef"])
            got = ((s.width, s.height), s.bit_depth, (s.ss_x, s.ss_y),
                   s.enable_cdef)
            if got != want:
                fault(k, f"sequence {got}, configuration {want}")
            if fr.order_hint != 0:
                fault(k, f"keyframe order hint {fr.order_hint}")
            f, cls = nxt, "KEY"
            kf = f
            rep.keyframes.append(f)
        else:
            if kf is None:
                fault(k, "inter frame before a keyframe")
                continue
            bits = dec.seq.order_hint_bits
            f = kf + (fr.order_hint - (nxt - kf)) % (1 << bits) + (nxt - kf)
            if f >= nxt + (1 << (bits - 1)):
                f -= 1 << bits
            refs = sorted(set(fr.ref_idx))
            future = [i for i in refs
                      if _rel(dec.ref_hint[i], fr.order_hint, bits) > 0]
            if not future:
                cls = "P"
            elif all(slot_cls[i] in ("KEY", "P") for i in refs):
                cls = "B0"
            else:
                cls = "B1"
            if fr.error_resilient:
                fault(k, "error-resilient inter frame")
        if claimed != f:
            fault(k, f"session says frame {claimed}, order hint gives {f}")
        if fr.base_q_idx != g["qindex"][cls]:
            fault(k, f"{cls} frame at qindex {fr.base_q_idx}, the "
                     f"configuration's is {g['qindex'][cls]}")
        if tuple(fr.render) != tuple(g["render_size"]):
            fault(k, f"render size {fr.render}")
        if (fr.cdef is not None) != g["cdef"]:
            fault(k, "CDEF parameters present" if fr.cdef is not None
                  else "CDEF parameters missing")
        if len(fr.tiles) != g["tiles"]:
            fault(k, f"{len(fr.tiles)} tiles")
        rep.frames[k] = f
        rep.coded[k] = (fr, dec.seq, cls, list(slot_frame))
        for i in range(8):
            if fr.refresh >> i & 1:
                slot_frame[i], slot_cls[i] = f, cls
        if fr.show_frame:
            if f != nxt:
                fault(k, f"displays frame {f}, {nxt} is due")
            shown.add(f)
            rep.displayed.append(f)
            nxt = f + 1
    return rep
