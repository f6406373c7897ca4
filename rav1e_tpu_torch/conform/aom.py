"""ctypes shim over the system libaom (3.6) AV1 decoder: the port's copy of
the JAX package's conform/aom.py, so that the port's checks decode without
importing the JAX package.

Second conformance oracle beside dav1d (mirrors rav1e's dual
decode_test / decode_test_dav1d features, SURVEY §4). No headers are
installed; the small ABI surface is declared here. The encoder ABI
version is probed at runtime (aom_codec_dec_init_ver rejects
mismatches safely).
"""

from __future__ import annotations

import ctypes as C

import numpy as np

_lib = None
_abi = None


class AomImage(C.Structure):
    # aom_image.h (aom 3.x): 14 unsigned ints, then metadata ptr,
    # planes[3], stride[3], bps, temporal_id, spatial_id, ...
    _fields_ = [
        ("fmt", C.c_uint),
        ("cp", C.c_uint),
        ("tc", C.c_uint),
        ("mc", C.c_uint),
        ("monochrome", C.c_uint),
        ("csp", C.c_uint),
        ("range", C.c_uint),
        ("w", C.c_uint),
        ("h", C.c_uint),
        ("bit_depth", C.c_uint),
        ("d_w", C.c_uint),
        ("d_h", C.c_uint),
        ("r_w", C.c_uint),
        ("r_h", C.c_uint),
        ("x_chroma_shift", C.c_uint),
        ("y_chroma_shift", C.c_uint),
        ("planes", C.c_void_p * 3),
        ("stride", C.c_int * 3),
        ("bps", C.c_int),
        ("temporal_id", C.c_int),
        ("spatial_id", C.c_int),
        ("user_priv", C.c_void_p),
        ("img_data", C.c_void_p),
        ("img_data_owner", C.c_int),
        ("self_allocd", C.c_int),
        ("metadata", C.c_void_p),
        ("fb_priv", C.c_void_p),
        ("_pad", C.c_uint8 * 64),
    ]


def _load():
    global _lib, _abi
    if _lib is not None:
        return _lib
    lib = C.CDLL("libaom.so.3")
    lib.aom_codec_av1_dx.restype = C.c_void_p
    lib.aom_codec_dec_init_ver.argtypes = [
        C.c_void_p, C.c_void_p, C.c_void_p, C.c_long, C.c_int]
    lib.aom_codec_decode.argtypes = [
        C.c_void_p, C.POINTER(C.c_uint8), C.c_size_t, C.c_void_p]
    lib.aom_codec_get_frame.restype = C.POINTER(AomImage)
    lib.aom_codec_get_frame.argtypes = [C.c_void_p, C.POINTER(C.c_void_p)]
    lib.aom_codec_error.restype = C.c_char_p
    lib.aom_codec_error.argtypes = [C.c_void_p]
    lib.aom_codec_error_detail.restype = C.c_char_p
    lib.aom_codec_error_detail.argtypes = [C.c_void_p]
    lib.aom_codec_destroy.argtypes = [C.c_void_p]
    _lib = lib
    # probe decoder ABI version
    iface = lib.aom_codec_av1_dx()
    for ver in range(24, 0, -1):
        ctx = (C.c_uint8 * 256)()
        rc = lib.aom_codec_dec_init_ver(ctx, iface, None, 0, ver)
        if rc == 0:
            _abi = ver
            lib.aom_codec_destroy(ctx)
            break
    else:
        raise RuntimeError("no working AOM_DECODER_ABI_VERSION found")
    return lib


class Decoder:
    def __init__(self):
        lib = _load()
        self._lib = lib
        self._ctx = (C.c_uint8 * 256)()
        rc = lib.aom_codec_dec_init_ver(
            self._ctx, lib.aom_codec_av1_dx(), None, 0, _abi)
        if rc != 0:
            raise RuntimeError(f"aom dec init failed: {rc}")

    def close(self):
        if self._ctx is not None:
            self._lib.aom_codec_destroy(self._ctx)
            self._ctx = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def error_detail(self) -> str:
        e = self._lib.aom_codec_error(self._ctx) or b""
        d = self._lib.aom_codec_error_detail(self._ctx) or b""
        return (e + b": " + d).decode(errors="replace")

    def decode(self, packet: bytes) -> list[list[np.ndarray]]:
        buf = (C.c_uint8 * len(packet)).from_buffer_copy(packet)
        rc = self._lib.aom_codec_decode(self._ctx, buf, len(packet), None)
        if rc != 0:
            raise RuntimeError(f"aom_codec_decode: {rc} ({self.error_detail()})")
        out = []
        it = C.c_void_p()
        while True:
            img = self._lib.aom_codec_get_frame(self._ctx, C.byref(it))
            if not img:
                break
            im = img.contents
            hbd = bool(im.fmt & 0x800)  # AOM_IMG_FMT_HIGHBITDEPTH
            dt = np.uint16 if hbd else np.uint8
            nb = 2 if hbd else 1
            planes = []
            for p in range(3):
                if not im.planes[p]:
                    break
                pw = im.d_w if p == 0 else (im.d_w + im.x_chroma_shift) >> im.x_chroma_shift
                ph = im.d_h if p == 0 else (im.d_h + im.y_chroma_shift) >> im.y_chroma_shift
                stride = im.stride[p]
                raw = (C.c_uint8 * (stride * ph)).from_address(im.planes[p])
                arr = np.frombuffer(raw, np.uint8).reshape(ph, stride)
                arr = arr.view(dt)[:, :pw].astype(np.uint16)
                planes.append(arr.copy())
            del nb
            out.append(planes)
        return out


def decode_all(packets: list[bytes]) -> list[list[np.ndarray]]:
    dec = Decoder()
    frames = []
    for p in packets:
        frames.extend(dec.decode(p))
    dec.close()
    return frames
