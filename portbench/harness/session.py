"""Drives one encoder session through the Context in a closed loop: each
frame is sent as soon as the Context takes it, and every ready packet is
drained. Set-up codes the stream's first `warm_frames` frames (the
keyframe and the first group, the shapes of the cell's traffic); the
window then runs for `seconds`, and ends at the last packet that arrived
in it."""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class PacketLog:
    data: bytes
    frameno: int          # the Context's input_frameno
    ftype: str            # KEY / INTER / SHOW_EXISTING
    t: float              # perf_counter when receive_packet returned it


@dataclass
class SessionLog:
    packets: list = field(default_factory=list)
    t_send: dict = field(default_factory=dict)    # frameno -> perf_counter
    sent: int = 0
    t0: float = 0.0            # window start
    deadline: float = 0.0


def encoder_config(cfg: dict, overrides: dict | None = None):
    """The configuration file's `encoder` settings as a Context Config."""
    from rav1e_tpu_torch.api import Config
    enc = dict(cfg["encoder"], **(overrides or {}))
    return Config.parse(enc)


def shown(packets) -> dict:
    """frameno -> the packet that displays it (a shown frame or a
    show-existing packet; a packet that does not read displays nothing)."""
    from portbench.reference.av1 import Unsupported, shows_frame
    out = {}
    for k, p in enumerate(packets):
        try:
            if shows_frame(p.data):
                out.setdefault(p.frameno, k)
        except Unsupported:
            pass
    return out


class Session:
    WARM_LIMIT = 10_000       # frames sent before a warm-up gives up

    def __init__(self, ctx, content):
        self.ctx, self.content = ctx, content
        self.log = SessionLog()

    def _drain(self):
        from rav1e_tpu_torch.api import EncoderStatus
        while True:
            st, pkt = self.ctx.receive_packet()
            if st != EncoderStatus.SUCCESS:
                return
            self.log.packets.append(PacketLog(bytes(pkt.data),
                                              pkt.input_frameno,
                                              pkt.frame_type,
                                              time.perf_counter()))

    def _send_next(self):
        i = self.log.sent
        f = self.content.frame(i)
        self.log.t_send[i] = time.perf_counter()
        self.ctx.send_frame(f)
        self.log.sent += 1
        self._drain()

    def warm(self, warm_frames: int):
        """Code until the first `warm_frames` frames are displayed."""
        while len(shown(self.log.packets)) < warm_frames:
            if self.log.sent >= self.WARM_LIMIT:
                raise RuntimeError("warm-up did not finish")
            self._send_next()

    def window(self, seconds: float, switch: tuple | None = None):
        """Drive the session for `seconds`; switch = (seconds into the
        window, function) is called once, between two frames, there."""
        self.log.t0 = time.perf_counter()
        self.log.deadline = self.log.t0 + seconds
        while time.perf_counter() < self.log.deadline:
            if switch and time.perf_counter() >= self.log.t0 + switch[0]:
                switch[1]()
                switch = None
            self._send_next()
        if switch:
            switch[1]()


@dataclass
class Window:
    """What arrived in the window: the packets (indices into the log),
    the frames they complete and the last arrival."""

    packets: list
    frames: list          # framenos displayed in the window, in order
    t_last: float
    latency: dict         # frameno -> seconds from send to display


def window_of(log: SessionLog, shot_frames: int = 0) -> Window:
    """The frames displayed by packets that arrived in the window; with
    shots (`shot_frames` > 0), up to the last shot that ended in it, so
    that every window holds the same mix of keyframes and inter frames.
    The window ends at the last of their display packets."""
    disp = shown(log.packets)
    arrived = {k for k, p in enumerate(log.packets)
               if log.t0 < p.t <= log.deadline}
    frames = sorted(f for f, k in disp.items() if k in arrived)
    if shot_frames and frames:
        end = (frames[-1] + 1) // shot_frames * shot_frames
        if end > frames[0]:
            frames = [f for f in frames if f < end]
    t_last = max((log.packets[disp[f]].t for f in frames), default=log.t0)
    pk = sorted(k for k in arrived if log.packets[k].t <= t_last)
    lat = {f: log.packets[disp[f]].t - log.t_send[f] for f in frames}
    return Window(pk, frames, t_last, lat)
