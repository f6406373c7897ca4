"""ctypes shim over the system libdav1d (dav1d 1.0.0, soname 6).

No dav1d headers are installed, so the small C ABI surface we need is
declared here by hand (dav1d 1.0.0 include/dav1d/*.h layouts).

Role in the framework: the conformance decoder oracle. Our encoder's
bitstreams are fed through ``Decoder.decode()`` and the returned planes
must match the encoder's reconstruction bit-exactly (same oracle the
reference uses: rav1e src/test_encode_decode/dav1d.rs).
"""

from __future__ import annotations

import ctypes as C
from dataclasses import dataclass

import numpy as np

_LIB_PATH = "libdav1d.so.6"

# enum Dav1dPixelLayout
I400, I420, I422, I444 = 0, 1, 2, 3

_EAGAIN = -11


class Dav1dDataProps(C.Structure):
    _fields_ = [
        ("timestamp", C.c_int64),
        ("duration", C.c_int64),
        ("offset", C.c_int64),
        ("size", C.c_size_t),
        ("user_data_ptr", C.c_void_p),
        ("user_data_ref", C.c_void_p),
    ]


class Dav1dData(C.Structure):
    _fields_ = [
        ("data", C.POINTER(C.c_uint8)),
        ("sz", C.c_size_t),
        ("ref", C.c_void_p),
        ("m", Dav1dDataProps),
    ]


class Dav1dPictureParameters(C.Structure):
    _fields_ = [
        ("w", C.c_int),
        ("h", C.c_int),
        ("layout", C.c_int),
        ("bpc", C.c_int),
    ]


class Dav1dPicture(C.Structure):
    # dav1d 1.0.0 include/dav1d/picture.h
    _fields_ = [
        ("seq_hdr", C.c_void_p),
        ("frame_hdr", C.c_void_p),
        ("data", C.c_void_p * 3),
        ("stride", C.c_ssize_t * 2),
        ("p", Dav1dPictureParameters),
        ("m", Dav1dDataProps),
        ("content_light", C.c_void_p),
        ("mastering_display", C.c_void_p),
        ("itut_t35", C.c_void_p),
        ("reserved", C.c_size_t * 4),
        ("frame_hdr_ref", C.c_void_p),
        ("seq_hdr_ref", C.c_void_p),
        ("content_light_ref", C.c_void_p),
        ("mastering_display_ref", C.c_void_p),
        ("itut_t35_ref", C.c_void_p),
        ("reserved_ref", C.c_size_t * 4),
        ("ref", C.c_void_p),
        ("allocator_data", C.c_void_p),
        # safety margin in case the real struct is larger than we think
        ("_pad", C.c_uint8 * 64),
    ]


# Dav1dSettings is filled by dav1d_default_settings(); we only ever touch
# the first few int fields, so an oversized opaque blob with a leading
# int view is safe.
class Dav1dSettings(C.Structure):
    _fields_ = [
        ("n_threads", C.c_int),
        ("max_frame_delay", C.c_int),
        ("apply_grain", C.c_int),
        ("operating_point", C.c_int),
        ("all_layers", C.c_int),
        ("frame_size_limit", C.c_uint),
        ("_opaque", C.c_uint8 * 512),
    ]


_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = C.CDLL(_LIB_PATH)
    lib.dav1d_version.restype = C.c_char_p
    lib.dav1d_open.argtypes = [C.POINTER(C.c_void_p), C.POINTER(Dav1dSettings)]
    lib.dav1d_default_settings.argtypes = [C.POINTER(Dav1dSettings)]
    lib.dav1d_data_create.restype = C.POINTER(C.c_uint8)
    lib.dav1d_data_create.argtypes = [C.POINTER(Dav1dData), C.c_size_t]
    lib.dav1d_send_data.argtypes = [C.c_void_p, C.POINTER(Dav1dData)]
    lib.dav1d_get_picture.argtypes = [C.c_void_p, C.POINTER(Dav1dPicture)]
    lib.dav1d_picture_unref.argtypes = [C.POINTER(Dav1dPicture)]
    lib.dav1d_data_unref.argtypes = [C.POINTER(Dav1dData)]
    lib.dav1d_close.argtypes = [C.POINTER(C.c_void_p)]
    lib.dav1d_flush.argtypes = [C.c_void_p]
    _lib = lib
    return lib


def version() -> str:
    return _load().dav1d_version().decode()


@dataclass
class DecodedFrame:
    """One decoded (shown) frame: planes as uint16 arrays at true size."""

    planes: list[np.ndarray]  # [y, u, v] (u/v absent for monochrome)
    layout: int  # I4xx
    bpc: int
    timestamp: int


def _copy_picture(pic: Dav1dPicture) -> DecodedFrame:
    w, h, layout, bpc = pic.p.w, pic.p.h, pic.p.layout, pic.p.bpc
    assert 0 < w <= 65536 and 0 < h <= 65536, (w, h)
    assert layout in (I400, I420, I422, I444), layout
    assert bpc in (8, 10, 12), bpc
    nbytes = 1 if bpc == 8 else 2
    dt = np.uint8 if bpc == 8 else np.uint16

    def plane(i: int, pw: int, ph: int, stride: int) -> np.ndarray:
        buf = (C.c_uint8 * (stride * ph)).from_address(pic.data[i])
        arr = np.frombuffer(buf, dtype=np.uint8).reshape(ph, stride)
        arr = arr.view(dt)[:, :pw]
        return arr.astype(np.uint16)

    planes = [plane(0, w, h, pic.stride[0])]
    if layout != I400:
        ss_x = 1 if layout in (I420, I422) else 0
        ss_y = 1 if layout == I420 else 0
        cw = (w + ss_x) >> ss_x
        ch = (h + ss_y) >> ss_y
        for i in (1, 2):
            planes.append(plane(i, cw, ch, pic.stride[1]))
    del nbytes
    return DecodedFrame(
        planes=planes, layout=layout, bpc=bpc, timestamp=pic.m.timestamp
    )


class Decoder:
    """Stateful dav1d decoder: feed raw OBU packets, collect shown frames."""

    def __init__(self, n_threads: int = 1):
        self._lib = _load()
        s = Dav1dSettings()
        self._lib.dav1d_default_settings(C.byref(s))
        s.n_threads = n_threads
        # conformance compares the pre-grain reconstruction
        s.apply_grain = 0
        self._ctx = C.c_void_p()
        rc = self._lib.dav1d_open(C.byref(self._ctx), C.byref(s))
        if rc != 0:
            raise RuntimeError(f"dav1d_open failed: {rc}")

    def close(self):
        if self._ctx:
            self._lib.dav1d_close(C.byref(self._ctx))
            self._ctx = C.c_void_p()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _drain_pictures(self, out: list[DecodedFrame]):
        while True:
            pic = Dav1dPicture()
            rc = self._lib.dav1d_get_picture(self._ctx, C.byref(pic))
            if rc == _EAGAIN:
                return
            if rc != 0:
                raise RuntimeError(f"dav1d_get_picture failed: {rc}")
            out.append(_copy_picture(pic))
            self._lib.dav1d_picture_unref(C.byref(pic))

    def send(self, packet: bytes, timestamp: int = 0) -> list[DecodedFrame]:
        """Send one temporal unit (raw OBUs); return any frames produced."""
        frames: list[DecodedFrame] = []
        data = Dav1dData()
        buf = self._lib.dav1d_data_create(C.byref(data), len(packet))
        if not buf:
            raise MemoryError("dav1d_data_create failed")
        C.memmove(buf, packet, len(packet))
        data.m.timestamp = timestamp
        while True:
            rc = self._lib.dav1d_send_data(self._ctx, C.byref(data))
            if rc == 0:
                break
            if rc != _EAGAIN:
                self._lib.dav1d_data_unref(C.byref(data))
                raise RuntimeError(f"dav1d_send_data failed: {rc}")
            self._drain_pictures(frames)
        self._drain_pictures(frames)
        return frames

    def flush(self) -> list[DecodedFrame]:
        """Signal end of stream and drain all remaining frames."""
        frames: list[DecodedFrame] = []
        # Draining after the last TU: dav1d returns frames until EAGAIN with
        # no pending data means fully drained.
        while True:
            pic = Dav1dPicture()
            rc = self._lib.dav1d_get_picture(self._ctx, C.byref(pic))
            if rc == _EAGAIN:
                break
            if rc != 0:
                raise RuntimeError(f"dav1d_get_picture failed: {rc}")
            frames.append(_copy_picture(pic))
            self._lib.dav1d_picture_unref(C.byref(pic))
        return frames


def decode_all(packets: list[bytes]) -> list[DecodedFrame]:
    """Decode a list of temporal units; return all shown frames in order."""
    dec = Decoder()
    frames: list[DecodedFrame] = []
    for i, p in enumerate(packets):
        frames.extend(dec.send(p, timestamp=i))
    frames.extend(dec.flush())
    dec.close()
    return frames
