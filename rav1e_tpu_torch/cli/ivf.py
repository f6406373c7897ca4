"""IVF muxing (reference parity: rav1e src/bin/muxer/ivf.rs).

DKIF container with AV01 fourcc; 12-byte frame headers.
"""

from __future__ import annotations

import struct


def ivf_header(width: int, height: int, fps_num: int, fps_den: int,
               n_frames: int = 0) -> bytes:
    return (b"DKIF" + struct.pack("<HH", 0, 32) + b"AV01"
            + struct.pack("<HHIII", width, height, fps_num, fps_den,
                          n_frames) + b"\x00\x00\x00\x00")


def ivf_frame(data: bytes, pts: int) -> bytes:
    return struct.pack("<IQ", len(data), pts) + data


def read_ivf(path):
    """Yield (pts, payload) packets from an IVF file."""
    with open(path, "rb") as f:
        hdr = f.read(32)
        assert hdr[:4] == b"DKIF", "not an IVF file"
        while True:
            fh = f.read(12)
            if len(fh) < 12:
                return
            sz, pts = struct.unpack("<IQ", fh)
            yield pts, f.read(sz)
