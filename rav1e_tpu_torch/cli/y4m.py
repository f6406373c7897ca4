"""y4m (YUV4MPEG2) reader/writer.

Reference parity: rav1e src/bin/decoder/y4m.rs (8/10/12-bit,
420/422/444), the CLI's only ingest path (no ffmpeg dependency).
"""

from __future__ import annotations

import io
from dataclasses import dataclass

import numpy as np


@dataclass
class Y4MInfo:
    width: int
    height: int
    fps_num: int = 30
    fps_den: int = 1
    chroma: str = "420"
    bit_depth: int = 8


class Y4MReader:
    def __init__(self, f):
        self.f = f if hasattr(f, "read") else open(f, "rb")
        header = b""
        while not header.endswith(b"\n"):
            c = self.f.read(1)
            if not c:
                raise EOFError("no y4m header")
            header += c
        parts = header.decode().strip().split(" ")
        assert parts[0] == "YUV4MPEG2", parts[0]
        info = Y4MInfo(0, 0)
        for p in parts[1:]:
            if p.startswith("W"):
                info.width = int(p[1:])
            elif p.startswith("H"):
                info.height = int(p[1:])
            elif p.startswith("F"):
                num, den = p[1:].split(":")
                info.fps_num, info.fps_den = int(num), int(den)
            elif p.startswith("C"):
                c = p[1:]
                if c.startswith("420"):
                    info.chroma = "420"
                elif c.startswith("422"):
                    info.chroma = "422"
                elif c.startswith("444"):
                    info.chroma = "444"
                if "p10" in c:
                    info.bit_depth = 10
                elif "p12" in c:
                    info.bit_depth = 12
        self.info = info

    def read_frame(self):
        """Returns [y, u, v] arrays or None at EOF."""
        line = b""
        while not line.endswith(b"\n"):
            c = self.f.read(1)
            if not c:
                return None
            line += c
        assert line.startswith(b"FRAME"), line
        i = self.info
        dt = np.uint8 if i.bit_depth == 8 else np.uint16
        nb = 1 if i.bit_depth == 8 else 2
        ss_x = 1 if i.chroma in ("420", "422") else 0
        ss_y = 1 if i.chroma == "420" else 0
        cw = (i.width + ss_x) >> ss_x
        ch = (i.height + ss_y) >> ss_y
        planes = []
        for (w, h) in ((i.width, i.height), (cw, ch), (cw, ch)):
            raw = self.f.read(w * h * nb)
            if len(raw) < w * h * nb:
                return None
            planes.append(np.frombuffer(raw, dt).reshape(h, w))
        return planes

    def __iter__(self):
        while True:
            f = self.read_frame()
            if f is None:
                return
            yield f


def write_y4m(path, frames, fps=(30, 1), bit_depth=8, chroma="420"):
    tag = {"420": "420jpeg", "422": "422", "444": "444"}[chroma]
    if bit_depth > 8:
        tag = chroma + f"p{bit_depth}"
    h, w = frames[0][0].shape
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F{fps[0]}:{fps[1]} Ip A1:1 "
                f"C{tag}\n".encode())
        for fr in frames:
            f.write(b"FRAME\n")
            for p in fr:
                f.write(np.ascontiguousarray(p).tobytes())
