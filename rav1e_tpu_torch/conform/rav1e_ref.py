"""ctypes shim over the system librav1e (rav1e v0.5.1) C API.

Purpose: (a) generate known-good AV1 streams to validate our dav1d shim
and bitstream tooling, (b) the baseline encoder for fps / bytes / BD-rate
measurements (BASELINE.md rows 5-6).

The C API surface is the 36 functions of librav1e 0.5.1's symbols
list (SURVEY.md Appendix A.5); struct layouts follow rav1e v0.5
src/capi.rs (#[repr(C)]). The port's copy of the JAX package's shim:
host ctypes code, which imports nothing of either package.
"""

from __future__ import annotations

import ctypes as C

import numpy as np

# EncoderStatus (capi.rs)
SUCCESS = 0
NEED_MORE_DATA = 1
ENOUGH_DATA = 2
LIMIT_REACHED = 3
ENCODED = 4


class RaPacket(C.Structure):
    _fields_ = [
        ("data", C.POINTER(C.c_uint8)),
        ("len", C.c_size_t),
        ("input_frameno", C.c_uint64),
        ("frame_type", C.c_int),
        ("opaque", C.c_void_p),
    ]


_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = C.CDLL("librav1e.so.0")
    lib.rav1e_config_default.restype = C.c_void_p
    lib.rav1e_config_parse.argtypes = [C.c_void_p, C.c_char_p, C.c_char_p]
    lib.rav1e_config_parse_int.argtypes = [C.c_void_p, C.c_char_p, C.c_int]
    lib.rav1e_config_unref.argtypes = [C.c_void_p]
    lib.rav1e_context_new.restype = C.c_void_p
    lib.rav1e_context_new.argtypes = [C.c_void_p]
    lib.rav1e_context_unref.argtypes = [C.c_void_p]
    lib.rav1e_frame_new.restype = C.c_void_p
    lib.rav1e_frame_new.argtypes = [C.c_void_p]
    lib.rav1e_frame_unref.argtypes = [C.c_void_p]
    lib.rav1e_frame_fill_plane.argtypes = [
        C.c_void_p, C.c_int, C.POINTER(C.c_uint8), C.c_size_t,
        C.c_ssize_t, C.c_int,
    ]
    lib.rav1e_send_frame.argtypes = [C.c_void_p, C.c_void_p]
    lib.rav1e_receive_packet.argtypes = [C.c_void_p, C.POINTER(C.POINTER(RaPacket))]
    lib.rav1e_packet_unref.argtypes = [C.POINTER(RaPacket)]
    lib.rav1e_status_to_str.restype = C.c_char_p
    _lib = lib
    return lib


class RefEncoder:
    """Minimal rav1e session: 8-bit 4:2:0 frames in, raw OBU packets out."""

    def __init__(self, width: int, height: int, speed: int = 10,
                 quantizer: int = 100, threads: int = 1,
                 low_latency: bool = True, extra: dict | None = None):
        lib = _load()
        self._lib = lib
        cfg = lib.rav1e_config_default()
        opts: dict = {
            "width": width, "height": height, "speed": speed,
            "quantizer": quantizer, "threads": threads,
            "low_latency": "true" if low_latency else "false",
        }
        if extra:
            opts.update(extra)
        for k, v in opts.items():
            if isinstance(v, str):
                rc = lib.rav1e_config_parse(cfg, k.encode(), v.encode())
            else:
                rc = lib.rav1e_config_parse_int(cfg, k.encode(), int(v))
            if rc != 0:
                raise ValueError(f"rav1e_config_parse({k}={v}) -> {rc}")
        self._ctx = lib.rav1e_context_new(cfg)
        lib.rav1e_config_unref(cfg)
        if not self._ctx:
            raise RuntimeError("rav1e_context_new failed")
        self.width, self.height = width, height

    def close(self):
        if getattr(self, "_ctx", None):
            self._lib.rav1e_context_unref(self._ctx)
            self._ctx = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def send(self, yuv: list[np.ndarray]):
        """Send one frame: [y, u, v] uint8 arrays (420)."""
        frame = self._lib.rav1e_frame_new(self._ctx)
        if not frame:
            raise RuntimeError("rav1e_frame_new failed")
        for i, p in enumerate(yuv):
            p = np.ascontiguousarray(p, dtype=np.uint8)
            h, w = p.shape
            ptr = p.ctypes.data_as(C.POINTER(C.c_uint8))
            self._lib.rav1e_frame_fill_plane(frame, i, ptr, p.size, w, 1)
        rc = self._lib.rav1e_send_frame(self._ctx, frame)
        self._lib.rav1e_frame_unref(frame)
        if rc != SUCCESS:
            raise RuntimeError(f"rav1e_send_frame -> {rc}")

    def flush_signal(self):
        rc = self._lib.rav1e_send_frame(self._ctx, None)
        if rc not in (SUCCESS, ENOUGH_DATA):
            raise RuntimeError(f"rav1e_send_frame(flush) -> {rc}")

    def receive_all(self) -> list[bytes]:
        """Drain all currently available packets."""
        out = []
        while True:
            pkt = C.POINTER(RaPacket)()
            rc = self._lib.rav1e_receive_packet(self._ctx, C.byref(pkt))
            if rc == SUCCESS:
                p = pkt.contents
                out.append(bytes(C.string_at(p.data, p.len)))
                self._lib.rav1e_packet_unref(pkt)
            elif rc == ENCODED:
                continue
            elif rc in (NEED_MORE_DATA, ENOUGH_DATA, LIMIT_REACHED):
                break
            else:
                raise RuntimeError(f"rav1e_receive_packet -> {rc}")
        return out


def encode_frames(frames: list[list[np.ndarray]], **kw) -> list[bytes]:
    """Encode 8-bit 420 frames with rav1e; return raw OBU packets."""
    h, w = frames[0][0].shape
    enc = RefEncoder(w, h, **kw)
    pkts: list[bytes] = []
    for f in frames:
        enc.send(f)
        pkts.extend(enc.receive_all())
    enc.flush_signal()
    pkts.extend(enc.receive_all())
    enc.close()
    return pkts
