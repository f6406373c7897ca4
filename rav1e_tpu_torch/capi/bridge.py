"""Python side of the rav1e-compatible C API (the port's copy of the
JAX package's bridge).

The C shim (capi.c) embeds CPython, imports this module, and calls the
flat functions below. Everything crossing the boundary is a plain
int / bytes / tuple so the C side never needs numpy headers.

Reference parity: rav1e src/capi.rs (the 36 rav1e_* functions,
SURVEY.md Appendix A.5). Status codes mirror EncoderStatus.

The session runs on the key/value map's "device" ("cuda" when absent,
which raises without CUDA, so rav1e_context_new returns NULL; "cpu" runs
the port on the CPU): the ABI's form of the CLI's --device.
"""

from __future__ import annotations

import numpy as np

from rav1e_tpu_torch.api.context import Config, Context, EncoderStatus

_FRAME_TYPE = {"KEY": 0, "INTER": 1, "SHOW_EXISTING": 1,
               "INTRA_ONLY": 2, "SWITCH": 3}


class _Session:
    """Context + C-API bookkeeping (opaque pointers, frame queue)."""

    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.opaque: dict[int, int] = {}     # input_frameno -> void*
        self.next_frameno = 0
        self.last_status = 0


def context_new(kv: dict) -> _Session:
    kv = dict(kv)
    device = kv.pop("device", None)
    cfg = Config.parse(kv)
    return _Session(cfg.new_context(device=device))


def context_info(s: _Session) -> tuple:
    """(width, height, bit_depth, ss_x, ss_y) for C-side frame alloc."""
    c = s.ctx.cfg
    ss_x, ss_y = {"420": (1, 1), "422": (1, 0), "444": (0, 0)}[
        c.chroma_sampling]
    return (c.width, c.height, c.bit_depth, ss_x, ss_y)


def send_frame(s: _Session, planes, frame_type_override: int,
               opaque: int) -> int:
    """planes: None (flush) or [y_bytes, u_bytes, v_bytes].

    Each plane is packed little-endian rows (u8 for 8-bit, u16 else).
    frame_type_override: 1 = force KEY (RA_FRAME_TYPE_OVERRIDE_KEY).
    """
    try:
        if planes is None:
            st = s.ctx.send_frame(None)
        else:
            c = s.ctx.cfg
            dt = np.uint8 if c.bit_depth == 8 else np.uint16
            w, h = c.width, c.height
            ss_x, ss_y = {"420": (1, 1), "422": (1, 0), "444": (0, 0)}[
                c.chroma_sampling]
            cw = (w + ss_x) >> ss_x
            ch = (h + ss_y) >> ss_y
            dims = [(h, w), (ch, cw), (ch, cw)]
            arrs = [np.frombuffer(p, dtype=dt).reshape(d)
                    for p, d in zip(planes, dims)]
            if frame_type_override == 1:
                s.ctx.force_key_frame()
            if opaque:
                s.opaque[s.next_frameno] = opaque
            st = s.ctx.send_frame(arrs)
            if st == EncoderStatus.SUCCESS:
                s.next_frameno += 1
        s.last_status = st.value
        return st.value
    except Exception:
        s.last_status = -1
        return -1


def receive_packet(s: _Session) -> tuple:
    """-> (status, data|None, input_frameno, frame_type, opaque)."""
    try:
        st, pkt = s.ctx.receive_packet()
        s.last_status = st.value
        if pkt is None:
            return (st.value, None, 0, 0, 0)
        ftype = _FRAME_TYPE.get(pkt.frame_type, 1)
        opaque = s.opaque.pop(pkt.input_frameno, 0)
        return (st.value, pkt.data, pkt.input_frameno, ftype, opaque)
    except Exception:
        s.last_status = -1
        return (-1, None, 0, 0, 0)


def sequence_header(s: _Session) -> bytes:
    """rav1e_container_sequence_header: standalone seq-hdr OBU bytes."""
    from rav1e_tpu_torch.entropy.obu import ObuType, obu
    return obu(ObuType.SEQUENCE_HEADER, s.ctx.sequence().write())


def last_status(s: _Session) -> int:
    return s.last_status


def twopass_out(s: _Session) -> bytes:
    return s.ctx.twopass_out()


def twopass_summary(s: _Session) -> bytes:
    return s.ctx.twopass_summary()


def twopass_in(s: _Session, data: bytes) -> int:
    try:
        s.ctx.twopass_in(bytes(data))
        return 0
    except Exception:
        return -1


def twopass_bytes_needed(s: _Session) -> int:
    try:
        return s.ctx.twopass_bytes_needed()
    except Exception:
        return 0
