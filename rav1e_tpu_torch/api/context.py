"""Encoder session: Config -> Context, send_frame / receive_packet.

Reference parity: rav1e src/api/context.rs + internal.rs. The state
machine accepts frames, places keyframes (scene detection,
key_frame_interval, forced keys), codes the default reordered depth-2
pyramid (or low-latency IPPP), weights each inter frame's RD by the
lookahead's per-block distortion scales, picks each frame's q by the
rate controller, and emits packets in coded order. Key names mirror
rav1e_config_parse where meaningful.

Each frame goes where the reference's Context sends it, on the Context's
device (cuda unless device="cpu"). 8- and 10-bit 4:2:0 P and B frames run
the device steps (tiled frames too: frame-global decisions, one entropy
state per tile, all tiles coded in one od_ec launch), with loop
restoration at speeds 0-3 and film grain. 8-bit 4:2:0 keyframes run the
device keyframe (variance AQ included) unless they need HORZ/VERT
partitions (speeds 0-3) or film grain. The rest is the reference's own
routing onto its numpy pipelines, on the port's copies of them
(pipeline/intra.py, pipeline/inter.py; host numpy, LR on the device):
other keyframes, 12-bit, 4:2:2 and 4:4:4 frames, the inter frames of an
`aq` session, switch frames and error-resilient frames. That routing is
by configuration and logged once (_warn_slow); nothing catches an error
to fall back. Loop restoration at 12 bits searches on the host, as the
reference's (pipeline/lr.py).

With tracing on (rav1e_tpu_torch.trace) the session records its spans:
send_frame and receive_packet, and inside them pad, lookahead,
scenechange, rc, host32 and one `frame` span around each pipeline call,
whose frame number and kind (keyframe, pframe, pframe2, bframe, or the
numpy routes np_keyframe, np_pframe, np_bframe) the pipeline's own spans
carry.
"""

from __future__ import annotations

import enum
import logging
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from rav1e_tpu_torch import trace
from rav1e_tpu_torch.device import resolve_device

log = logging.getLogger("rav1e_tpu_torch")

class EncoderStatus(enum.Enum):
    SUCCESS = 0
    NEED_MORE_DATA = 1
    ENOUGH_DATA = 2
    LIMIT_REACHED = 3
    ENCODED = 4
    FAILURE = -1


@dataclass
class EncoderStats:
    """Per-packet encoder stats (rav1e Packet::enc_stats analog):
    reconstruction distortion + stream accounting. Filled when
    Config.extra['enc_stats'] is truthy."""

    psnr_y: float
    psnr_u: float
    psnr_v: float
    size_bytes: int
    qp: int


@dataclass
class Packet:
    data: bytes
    input_frameno: int
    frame_type: str
    qp: int
    enc_stats: "EncoderStats | None" = None


def _truthy(v) -> bool:
    return str(v).lower() in ("1", "true", "on", "yes")


@dataclass
class Config:
    width: int = 640
    height: int = 480
    speed: int = 6
    quantizer: int = 100
    bit_depth: int = 8
    chroma_sampling: str = "420"
    key_frame_interval: int = 240
    min_key_frame_interval: int = 12
    # rav1e default: reordered GOPs (the depth-2 B-pyramid); set True
    # for strict IPPP output order (rav1e --low-latency)
    low_latency: bool = False
    threads: int = 1
    tiles: int = 1
    extra: dict = field(default_factory=dict)

    @classmethod
    def parse(cls, kv: dict) -> "Config":
        """rav1e_config_parse-style key/value configuration."""
        cfg = cls()
        for k, v in kv.items():
            key = {"qp": "quantizer"}.get(k, k)
            if hasattr(cfg, key):
                cur = getattr(cfg, key)
                if isinstance(cur, bool):
                    v = str(v).lower() in ("1", "true", "yes")
                elif isinstance(cur, int):
                    v = int(v)
                setattr(cfg, key, v)
            else:
                cfg.extra[k] = v
        return cfg

    def new_context(self, device=None) -> "Context":
        """A Context on `device` (cuda unless device="cpu")."""
        return Context(self, device=device)


class Context:
    """send_frame / receive_packet state machine (rav1e-shaped).

    Reordered mode (the default) buffers groups of `bgroup` frames and
    codes each as a non-shown anchor P, a B pyramid and show-existing
    packets; low-latency mode codes IPPP (LAST + GOLDEN at speeds <= 5),
    with periodic switch frames (switch_frame_interval) or
    error-resilient inter frames (error_resilient) if asked. Scene
    detection + key_frame_interval place keyframes; rate control picks
    per-frame qindex when bitrate > 0."""

    def __init__(self, cfg: Config, device=None):
        if cfg.bit_depth not in (8, 10, 12):
            raise ValueError(f"bit_depth must be 8/10/12, got "
                             f"{cfg.bit_depth}")
        if cfg.chroma_sampling not in ("420", "422", "444"):
            raise ValueError(f"chroma_sampling must be 420/422/444, got "
                             f"{cfg.chroma_sampling!r}")
        if cfg.width < 1 or cfg.height < 1:
            raise ValueError("frame dimensions must be >= 1")
        from rav1e_tpu_torch.analysis.scenechange import SceneChangeDetector
        from rav1e_tpu_torch.api.speed import SpeedSettings
        from rav1e_tpu_torch.rate.rc import RCConfig, RCState
        self.cfg = cfg
        self.speed_settings = SpeedSettings.from_preset(cfg.speed)
        # coded (padded) dims: the SB grid wants 32-multiples; input is
        # edge-replicated up and the display crop is signaled via
        # render_size (spec 5.9.6)
        self._cw = (cfg.width + 31) // 32 * 32
        self._ch = (cfg.height + 31) // 32 * 32
        self._render = ((cfg.width, cfg.height)
                        if (self._cw, self._ch) != (cfg.width, cfg.height)
                        else None)
        self._ss_x, self._ss_y = {"420": (1, 1), "422": (1, 0),
                                  "444": (0, 0)}[cfg.chroma_sampling]
        # tiles: power-of-two uniform grid, cols favored (rav1e
        # TilingInfo::from_target_tiles)
        from rav1e_tpu_torch.entropy.obu import Sequence, TileInfo
        tl = max(0, (max(1, cfg.tiles) - 1).bit_length())
        seq_probe = Sequence(width=self._cw, height=self._ch)
        ti_max = TileInfo(seq_probe)
        cols_l2 = min((tl + 1) // 2, ti_max.max_log2_cols)
        rows_l2 = min(tl - cols_l2, ti_max.max_log2_rows)
        self._tile_cols_log2, self._tile_rows_log2 = cols_l2, rows_l2
        # error-resilience features (rav1e error_resilient +
        # switch_frame_interval) require low-latency mode, like rav1e's
        # "switch frame interval requires low latency mode"
        # S-frames are periodic spec SWITCH_FRAME splice points (integer
        # MVs, refresh all slots); error_resilient codes every inter frame
        # with resilient headers. Both code the 8 reference slots' order
        # hints, tracked in _slot_hints.
        self._switch_interval = int(
            cfg.extra.get("switch_frame_interval", 0) or 0)
        self._error_resilient = _truthy(cfg.extra.get("error_resilient", ""))
        if (self._switch_interval or self._error_resilient) \
                and not cfg.low_latency:
            raise ValueError(
                "switch_frame_interval / error_resilient require "
                "low_latency mode (rav1e contract)")
        self._slot_hints = [0] * 8
        self._aq = _truthy(cfg.extra.get("aq", ""))
        self.device = resolve_device(device)
        self._q: deque = deque()
        self._out: deque = deque()
        self._input_frameno = 0
        self._force_key_framenos: set[int] = set()
        self._flushed = False
        self._detector = SceneChangeDetector(
            bit_depth=cfg.bit_depth,
            min_kf_interval=cfg.min_key_frame_interval,
            max_kf_interval=cfg.key_frame_interval,
            mode=self.speed_settings.scene_mode)
        self._rc = RCState(RCConfig(
            target_bitrate=int(cfg.extra.get("bitrate", 0) or 0),
            framerate=float(cfg.extra.get("framerate", 30.0) or 30.0),
            quantizer=cfg.quantizer),
            pass_=int(cfg.extra.get("pass", 0) or 0))
        self._ref_rec = None      # previous reconstruction (numpy int32)
        self._golden_rec = None   # the GOP keyframe's (LAST + GOLDEN P)
        # the GOP's keyframe enabled loop restoration: every frame of
        # the GOP then codes its LR parameters
        self._lr_seq = False
        self._order_hint = 0
        self._cdef_enabled = False
        self._grain_enabled = False
        self._warned: set = set()
        # sequence-level color/HDR signaling (rav1e C API
        # rav1e_config_set_color_description / set_content_light /
        # set_mastering_display)
        self._seq_extra: dict = {}
        if cfg.extra.get("still_picture"):
            self._seq_extra["still_picture"] = str(
                cfg.extra["still_picture"]).lower() in ("1", "true", "yes")
        cd = cfg.extra.get("color_description")  # "cp,tc,mc"
        if cd:
            cp, tc, mc = (int(x) for x in str(cd).split(","))
            self._seq_extra["color_description"] = (cp, tc, mc)
        if cfg.extra.get("color_range") is not None:
            self._seq_extra["color_range"] = int(
                cfg.extra["color_range"])
        ti_raw = cfg.extra.get("timing_info")  # "num_units,time_scale"
        if ti_raw:
            # rav1e enable_timing_info (TRateParameters): fixed-fps
            # display timing in the sequence header (spec 5.5.3)
            parts = [int(x) for x in str(ti_raw).split(",")]
            self._seq_extra["timing_info_present"] = True
            self._seq_extra["num_units_in_display_tick"] = parts[0]
            self._seq_extra["time_scale"] = parts[1]
            if len(parts) > 2:
                self._seq_extra["num_ticks_per_picture"] = parts[2]
        self._metadata = b""
        cl = cfg.extra.get("content_light")      # "max_cll,max_fall"
        if cl:
            from rav1e_tpu_torch.entropy.obu import content_light_obu
            cll, fall = (int(x) for x in str(cl).split(","))
            self._metadata += content_light_obu(cll, fall)
        md = cfg.extra.get("mastering_display")
        if md:
            # "rx,ry,gx,gy,bx,by,wx,wy,max_nits,min_nits"
            from rav1e_tpu_torch.entropy.obu import mastering_display_obu
            v = [float(x) for x in str(md).split(",")]
            self._metadata += mastering_display_obu(
                [(v[0], v[1]), (v[2], v[3]), (v[4], v[5])],
                (v[6], v[7]), v[8], v[9])
        # reordered (B-frame) mode: buffer groups of `bgroup` frames,
        # code the last as a non-shown anchor, the rest as B frames,
        # then a show_existing packet (rav1e low_latency=false path).
        self._bgroup = 0
        if not cfg.low_latency:
            self._bgroup = max(2, int(cfg.extra.get("bgroup", 4) or 4))
        self._gbuf: list = []
        self._cur_slot = 0        # slot holding the forward reference
        # lookahead importance propagation + activity masking feeding
        # per-block DistortionScale weights into the P/B-frame RDO
        # (rav1e src/api/lookahead.rs + src/activity.rs).
        self._want_stats = _truthy(cfg.extra.get("enc_stats", ""))
        # On by default for the thorough presets; rdo_lookahead_frames=0
        # disables, any value forces on.
        la_raw = cfg.extra.get("rdo_lookahead_frames", None)
        la_depth = (int(la_raw) if la_raw is not None
                    else (8 if cfg.speed <= 7 else 0))
        self._lookahead = None
        self._la_depth = 0
        if (la_depth > 0 and cfg.bit_depth == 8
                and cfg.chroma_sampling == "420" and not self._tiled):
            from rav1e_tpu_torch.analysis.lookahead import Lookahead
            tune = str(cfg.extra.get("tune", "Psnr")).lower()
            self._lookahead = Lookahead(depth=min(la_depth, 32), tune=tune)
            self._la_depth = min(la_depth, 32)

    @property
    def _tiled(self) -> bool:
        return bool(self._tile_cols_log2 or self._tile_rows_log2)

    def _warn_slow(self, why: str):
        """One notice per cause when a configuration routes to the numpy
        pipelines (the reference's own routing, on the host): no silent
        performance cliff."""
        if why not in self._warned:
            self._warned.add(why)
            log.warning("rav1e_tpu_torch: %s: coded on the numpy pipeline "
                        "(host, slow), as the reference routes it", why)

    def _pad_planes(self, planes):
        """Edge-replicate planes up to the coded (32-aligned) size."""
        cw, ch = self._cw, self._ch
        tgt = [(ch, cw),
               ((ch + self._ss_y) >> self._ss_y,
                (cw + self._ss_x) >> self._ss_x),
               ((ch + self._ss_y) >> self._ss_y,
                (cw + self._ss_x) >> self._ss_x)]
        out = []
        for p, (th, tw) in zip(planes, tgt):
            h, w = p.shape
            if (h, w) != (th, tw):
                p = np.pad(p, ((0, th - h), (0, tw - w)), mode="edge")
            out.append(p)
        return out

    # -- input side ----------------------------------------------------------

    def send_frame(self, frame: list[np.ndarray] | None) -> EncoderStatus:
        """frame: [y, u, v] planes (uint8 at 8 bits, uint16 at 10), or
        None to signal flush. The frame is packed and uploaded at the
        session's bit depth (the reference's send_frame packs at 8 bits,
        which keeps 10-bit values mod 256)."""
        with trace.span("send_frame"):
            return self._send_frame(frame)

    def _send_frame(self, frame) -> EncoderStatus:
        if frame is None:
            self._flushed = True
            return EncoderStatus.SUCCESS
        if self._flushed:
            return EncoderStatus.ENOUGH_DATA
        y, u, v = (np.asarray(p) for p in frame)
        cfg = self.cfg
        if y.shape != (cfg.height, cfg.width):
            raise ValueError(
                f"frame is {y.shape[::-1]}, config {cfg.width}x"
                f"{cfg.height}")
        c_h = (cfg.height + self._ss_y) >> self._ss_y
        c_w = (cfg.width + self._ss_x) >> self._ss_x
        for name, p in (("u", u), ("v", v)):
            if p.shape != (c_h, c_w):
                raise ValueError(
                    f"{name} plane is {p.shape[::-1]}, expected "
                    f"{c_w}x{c_h} for {cfg.chroma_sampling}")
        want = np.uint8 if cfg.bit_depth == 8 else np.uint16
        for name, p in (("y", y), ("u", u), ("v", v)):
            if p.dtype != want and p.dtype.kind not in "iu":
                raise ValueError(
                    f"{name} plane dtype {p.dtype} does not match "
                    f"bit_depth {cfg.bit_depth} (want {np.dtype(want)})")
        with trace.span("pad"):
            padded = self._pad_planes([y, u, v])
        src_dev = None
        if self._lookahead is not None:
            # single upload per frame: the packed source feeds the
            # lookahead ME stats now and the encode step later
            from rav1e_tpu_torch.pipeline.tpu_inter import pack_src
            with trace.span("lookahead"):
                src_dev = torch.from_numpy(
                    pack_src(padded, bd=cfg.bit_depth)).to(self.device)
                self._lookahead.push_packed(src_dev, self._ch, self._cw)
        self._q.append((self._input_frameno, padded, src_dev))
        self._input_frameno += 1
        return EncoderStatus.SUCCESS

    # -- output side ---------------------------------------------------------

    def receive_packet(self) -> tuple[EncoderStatus, Packet | None]:
        with trace.span("receive_packet"):
            return self._receive_packet()

    def _receive_packet(self) -> tuple[EncoderStatus, Packet | None]:
        if self._out:
            return EncoderStatus.SUCCESS, self._out.popleft()
        # with lookahead, hold frames until the analysis window fills
        # (rav1e returns NeedMoreData until rdo_lookahead_frames queue)
        need = 0 if self._flushed else self._la_depth
        while len(self._q) > need and not self._out:
            frameno, planes, src_dev = self._q.popleft()
            if self._bgroup:
                self._pump_reordered(frameno, planes, src_dev)
            else:
                self._out.append(
                    self._encode_frame(frameno, planes,
                                       src_dev=src_dev))
        if not self._out and self._flushed and self._gbuf:
            self._encode_group()
        if self._out:
            return EncoderStatus.SUCCESS, self._out.popleft()
        if self._flushed:
            return EncoderStatus.LIMIT_REACHED, None
        return EncoderStatus.NEED_MORE_DATA, None

    # -- reordered (B-frame) scheduling --------------------------------------

    def _pump_reordered(self, frameno: int, planes, src_dev=None):
        is_key = (self._scene_cut(planes[0])
                  or self._ref_rec is None
                  or frameno in self._force_key_framenos)
        self._force_key_framenos.discard(frameno)
        if is_key:
            if self._gbuf:
                self._encode_group()     # close the open group first
            self._out.append(self._encode_frame(frameno, planes,
                                                force_key=True))
            self._cur_slot = 0
            return
        self._gbuf.append((frameno, planes, src_dev))
        if len(self._gbuf) >= self._bgroup:
            self._encode_group()

    def _pframe_kw(self, tgrid) -> dict:
        """The speed preset's encode_pframe_tpu tools, as the reference's
        reordered group passes them (no intra-in-inter in a tiled
        frame)."""
        ss = self.speed_settings
        return dict(use_split=ss.partition_split_rdo,
                    use_satd=ss.satd_subpel, refine16=ss.mv_refine_16,
                    intra_rdo=ss.intra_in_inter and tgrid is None,
                    b64_rdo=ss.b64_merge, search=ss.search_px,
                    subpel=ss.subpel, use_split8=ss.partition_split8,
                    lr=self._lr_seq, bit_depth=self.cfg.bit_depth,
                    tile_grid=tgrid, device=self.device)

    def _numpy_kw(self) -> dict:
        """The numpy pipelines' session arguments."""
        return dict(lr=self._lr_seq, bit_depth=self.cfg.bit_depth,
                    chroma_sampling=self.cfg.chroma_sampling,
                    render_size=self._render, device=self.device)

    def _scene_cut(self, y) -> bool:
        with trace.span("scenechange"):
            return self._detector.analyze_next_frame(y)

    def _select_qi(self, ftype: str) -> int:
        with trace.span("rc"):
            return self._rc.select_qi(ftype)

    def _rc_update(self, ftype: str, q: int, data: bytes):
        with trace.span("rc"):
            self._rc.update(ftype, q, len(data) * 8)

    def _encode_group(self):
        """Code the buffered frames as anchor-P (non-shown) + B pyramid +
        show_existing; reference slots ping-pong between 1 and 2 so the
        previous anchor stays live as the forward reference. 8- and
        10-bit 4:2:0 groups run on the device steps (the anchor
        encode_pframe_tpu, the B frames encode_bframe_tpu with per-block
        fwd / bwd / COMPOUND_AVERAGE RDO; a tiled session's with its tile
        grid); 12-bit, 4:2:2, 4:4:4 and `aq` groups on the numpy
        pipelines, one tile a frame, as the reference codes them."""
        from rav1e_tpu_torch.entropy.obu import show_existing_packet
        from rav1e_tpu_torch.pipeline.inter import encode_bframe, encode_pframe
        from rav1e_tpu_torch.pipeline.tpu_inter import (encode_bframe_tpu,
                                                        encode_pframe_tpu)
        frames = self._gbuf
        self._gbuf = []
        if not frames:
            return
        cfg, ss = self.cfg, self.speed_settings
        fast_ok = (cfg.bit_depth in (8, 10) and cfg.chroma_sampling == "420"
                   and not self._aq)
        if not fast_ok:
            self._warn_slow(
                f"B-group config (bit_depth={cfg.bit_depth}, "
                f"chroma={cfg.chroma_sampling}, aq={self._aq})")
        tgrid = ((self._tile_cols_log2, self._tile_rows_log2)
                 if self._tiled and fast_ok else None)
        base = self._order_hint
        # per-frame lookahead importance (input-order window) before
        # any pops; coding order below consumes by group index
        ds = [None] * len(frames)
        if self._lookahead is not None:
            with trace.span("lookahead"):
                for k, (_fn, _pl, _sd) in enumerate(frames):
                    ds[k] = self._lookahead.scales_at(k, _pl[0])
                for _ in frames:
                    self._lookahead.pop()

        def code_p(fn, pl, sd, dsk, **kw):
            if fast_ok:
                with trace.frame(fn, "pframe"):
                    return encode_pframe_tpu(
                        pl, self._ref_rec, film_grain=grain,
                        render_size=self._render, dscale=dsk, src_dev=sd,
                        **kw, **self._pframe_kw(tgrid))
            with trace.frame(fn, "np_pframe"):
                return encode_pframe(pl, self._ref_rec, film_grain=grain,
                                     **kw, **self._numpy_kw())

        if len(frames) == 1:
            fn, pl, sd = frames[0]
            q = self._select_qi("INTER")
            cdef, grain = self._loop_params(False, q)
            slot_new = 2 if self._cur_slot == 1 else 1
            data, rec = code_p(fn, pl, sd, ds[0], qindex=q,
                               order_hint=(base + 1) & 127, cdef=cdef,
                               refresh_flags=1 << slot_new,
                               ref_slot=self._cur_slot)
            self._finish(data, fn, "INTER", q, rec, slot_new,
                         base + 1, src=pl)
            return
        afn, apl, asd = frames[-1]
        q = self._select_qi("INTER")
        cdef, grain = self._loop_params(False, q)
        slot_new = 2 if self._cur_slot == 1 else 1
        ahint = (base + len(frames)) & 127
        adata, arec = code_p(afn, apl, asd, ds[-1], qindex=q,
                             order_hint=ahint,
                             cdef=cdef, refresh_flags=1 << slot_new,
                             ref_slot=self._cur_slot, show_frame=False)
        self._out.append(Packet(data=adata, input_frameno=afn,
                                frame_type="INTER", qp=q,
                                enc_stats=self._mk_stats(apl, arec,
                                                         adata, q)))
        self._rc_update("INTER", q, adata)
        arec32 = _host32(arec)
        if fast_ok:
            enc_b, b_kind = encode_bframe_tpu, "bframe"
            bkw = dict(b64_rdo=ss.b64_merge, use_split=ss.partition_split_rdo,
                       lr=self._lr_seq, bit_depth=cfg.bit_depth,
                       tile_grid=tgrid, render_size=self._render,
                       device=self.device)
        else:
            enc_b, b_kind = encode_bframe, "np_bframe"
            bkw = self._numpy_kw()

        def dkw(k):
            """Per-frame lookahead / device-source arguments (device
            steps)."""
            return dict(dscale=ds[k], src_dev=frames[k][2]) if fast_ok else {}

        # Binary pyramid over the inner frames for ANY group length
        # (rav1e InterConfig pyramid, src/api/internal.rs: depth-2 for
        # group_input_len=4; tail groups at flush/scene-cut keep the
        # same recursive shape instead of a flat B chain).  A span
        # (lo, hi) with recon refs at both ends codes its middle frame
        # as a B — non-shown + slot-refreshing when it has children
        # (subtype B0 at depth 0, B1 deeper) — then recurses left,
        # emits SEF(mid), recurses right.  Slots 3..6 serve pyramid
        # depths 0..3 (one live per depth on the recursion path).
        def code_span(i0, i1, lo_ctx, hi_ctx, depth):
            """Code inner frames[i0:i1] in display order.  lo_ctx /
            hi_ctx = (rec32, slot, order_hint) of the bounding refs."""
            if i0 >= i1:
                return
            m = (i0 + i1) // 2
            fn_m, pl_m, _sd = frames[m]
            hint_m = (base + m + 1) & 127
            leaf = (i1 - i0) == 1
            subtype = "B0" if depth == 0 else "B1"
            qm = self._select_qi(subtype)
            bslot = min(3 + depth, 6)
            with trace.frame(fn_m, b_kind):
                bdata, brec = enc_b(
                    pl_m, lo_ctx[0], hi_ctx[0], qindex=qm,
                    order_hint=hint_m, cdef=cdef, film_grain=grain,
                    slot_fwd=lo_ctx[1], slot_bwd=hi_ctx[1],
                    ref_hints=(lo_ctx[2], hi_ctx[2]),
                    refresh_flags=0 if leaf else 1 << bslot,
                    show_frame=leaf, **dkw(m), **bkw)
            self._out.append(Packet(data=bdata, input_frameno=fn_m,
                                    frame_type="INTER", qp=qm,
                                    enc_stats=self._mk_stats(
                                        pl_m, brec, bdata, qm)))
            self._rc_update(subtype, qm, bdata)
            if leaf:
                return
            mid_ctx = (_host32(brec), bslot, hint_m)
            code_span(i0, m, lo_ctx, mid_ctx, depth + 1)
            self._out.append(Packet(data=show_existing_packet(bslot),
                                    input_frameno=fn_m,
                                    frame_type="SHOW_EXISTING", qp=qm))
            code_span(m + 1, i1, mid_ctx, hi_ctx, depth + 1)

        code_span(0, len(frames) - 1,
                  (self._ref_rec, self._cur_slot, base & 127),
                  (arec32, slot_new, ahint), 0)
        self._out.append(Packet(data=show_existing_packet(slot_new),
                                input_frameno=afn,
                                frame_type="SHOW_EXISTING", qp=q))
        self._ref_rec = arec32
        self._cur_slot = slot_new
        self._order_hint = base + len(frames)

    def _finish(self, data, frameno, ftype, q, rec, slot, order,
                src=None):
        self._out.append(Packet(data=data, input_frameno=frameno,
                                frame_type=ftype, qp=q,
                                enc_stats=self._mk_stats(src, rec,
                                                         data, q)))
        self._rc_update(ftype, q, data)
        self._ref_rec = _host32(rec)
        self._cur_slot = slot
        self._order_hint = order

    def _mk_stats(self, src, rec, data, q):
        """EncoderStats for one coded frame (opt-in via
        Config.extra['enc_stats']; rav1e Packet::enc_stats analog)."""
        if not self._want_stats or src is None or rec is None:
            return None
        mx = float((1 << self.cfg.bit_depth) - 1)
        ps = []
        for p, r in zip(src, rec):
            p = np.asarray(p, np.float64)
            r = np.asarray(r, np.float64)[: p.shape[0], : p.shape[1]]
            mse = np.mean((p - r) ** 2)
            ps.append(float(10 * np.log10(mx * mx / mse))
                      if mse > 0 else 99.0)
        return EncoderStats(ps[0], ps[1], ps[2], len(data), q)

    def _loop_params(self, is_key: bool, q: int):
        """(cdef, film_grain) under the per-GOP seq-level consistency
        rules (presence fixed at the keyframe)."""
        cdef = None
        if (str(self.cfg.extra.get("cdef", "auto")) != "off"
                and self.speed_settings.cdef_auto):
            from rav1e_tpu_torch.ops.ref.cdef import cdef_strengths_for_q
            cdef = cdef_strengths_for_q(q)
            if cdef is None:
                # the device paths search strengths per frame; enable
                # CDEF with zero strengths so the search can upgrade them
                damping = 3 + (q >= 64) + (q >= 160)
                cdef = (0, 0, 0, 0, damping)
        if is_key:
            self._cdef_enabled = cdef is not None
        elif self._cdef_enabled:
            cdef = cdef or (0, 0, 0, 0, 3)
        else:
            cdef = None
        grain = None
        iso = int(self.cfg.extra.get("photon_noise", 0) or 0)
        if iso:
            from rav1e_tpu_torch.entropy.obu import photon_noise_params
            grain = photon_noise_params(iso)
        if is_key:
            self._grain_enabled = grain is not None
        elif not self._grain_enabled:
            grain = None
        return cdef, grain

    def _encode_frame(self, frameno: int, planes,
                      force_key: bool | None = None,
                      src_dev=None) -> Packet:
        cfg = self.cfg
        ss = self.speed_settings
        if force_key is None:
            is_key = (self._scene_cut(planes[0])
                      or self._ref_rec is None
                      or frameno in self._force_key_framenos)
            self._force_key_framenos.discard(frameno)
        else:
            is_key = force_key
        dscale = None
        if self._lookahead is not None:
            with trace.span("lookahead"):
                if not is_key:
                    dscale = self._lookahead.scales(planes[0])
                self._lookahead.pop()
        ftype = "KEY" if is_key else "INTER"
        q = self._select_qi(ftype)
        cdef, grain = self._loop_params(is_key, q)
        aq = self._aq
        # the device steps: 8- and 10-bit 4:2:0 (a tiled frame packs per
        # tile from frame-global decisions); the device keyframe is
        # 8-bit. Keyframes of tiled sessions code as a single tile
        # (tile_info is per-frame, spec 5.9.15) so the wavefront stays
        # whole-frame.
        fast_ok = cfg.bit_depth in (8, 10) and cfg.chroma_sampling == "420"
        if not fast_ok:
            self._warn_slow(f"frame config (bit_depth={cfg.bit_depth}, "
                            f"chroma={cfg.chroma_sampling})")
        tgrid = ((self._tile_cols_log2, self._tile_rows_log2)
                 if self._tiled and fast_ok else None)
        fast_kf = fast_ok and cfg.bit_depth == 8
        if is_key and fast_ok and not fast_kf:
            self._warn_slow("10/12-bit keyframe")
        if not is_key and aq and fast_ok:
            self._warn_slow("aq=1 inter frames")
        if is_key:
            lr = ss.lr and not self._tiled
            if fast_kf and grain is None and not ss.rect_parts:
                from rav1e_tpu_torch.pipeline.tpu_intra import (
                    encode_keyframe_tpu)
                with trace.frame(frameno, "keyframe"):
                    data, rec = encode_keyframe_tpu(
                        planes, qindex=q, cdef=cdef, speed=cfg.speed,
                        render_size=self._render,
                        seq_extra=self._seq_extra or None, lr=lr, aq=aq,
                        device=self.device)
            else:
                # the reference's device keyframe is 8-bit 4:2:0 without
                # film grain or HORZ/VERT partitions: it codes the others
                # on its numpy pipeline, on the host, as here (LR on the
                # device)
                from rav1e_tpu_torch.pipeline.intra import encode_keyframe
                with trace.frame(frameno, "np_keyframe"):
                    data, rec = encode_keyframe(
                        planes, qindex=q, cdef=cdef, film_grain=grain, aq=aq,
                        bit_depth=cfg.bit_depth,
                        chroma_sampling=cfg.chroma_sampling,
                        tile_cols_log2=self._tile_cols_log2,
                        tile_rows_log2=self._tile_rows_log2, lr=lr,
                        render_size=self._render,
                        seq_extra=self._seq_extra or None,
                        part_rdo=ss.rect_parts,
                        angle_deltas=ss.angle_deltas, device=self.device)
            self._lr_seq = lr
            if self._metadata:
                # metadata OBUs ride the keyframe temporal unit, after
                # the 2-byte temporal delimiter and before the frame
                # (spec 6.7.1 ordering; rav1e emits HDR metadata on
                # every keyframe)
                data = data[:2] + self._metadata + data[2:]
            self._order_hint = 0
            self._slot_hints = [0] * 8   # KEY refreshes every slot
        else:
            self._order_hint += 1
            oh = self._order_hint & 127
            is_sframe = bool(self._switch_interval and self._order_hint
                             % self._switch_interval == 0)
            if is_sframe or self._error_resilient:
                # S-frame / error-resilient inter frame: resilient headers
                # with the slots' order hints; S-frames code whole-pel MVs
                # and refresh every reference slot (spec SWITCH_FRAME)
                from rav1e_tpu_torch.pipeline.inter import encode_pframe
                with trace.frame(frameno, "np_pframe"):
                    data, rec = encode_pframe(
                        planes, self._ref_rec, qindex=q, order_hint=oh,
                        cdef=cdef, film_grain=grain, aq=aq,
                        tile_cols_log2=self._tile_cols_log2,
                        tile_rows_log2=self._tile_rows_log2,
                        switch_frame=is_sframe,
                        error_resilient=self._error_resilient,
                        slot_order_hints=list(self._slot_hints),
                        **self._numpy_kw())
                self._ref_rec = _host32(rec)
                if is_sframe:
                    self._slot_hints = [oh] * 8
                    self._golden_rec = self._ref_rec
                else:
                    self._slot_hints[0] = oh
                self._rc_update(ftype, q, data)
                return Packet(data=data, input_frameno=frameno,
                              frame_type=ftype, qp=q,
                              enc_stats=self._mk_stats(planes, rec, data, q))
            # multi-ref P (rav1e multiref): LAST = previous recon,
            # GOLDEN = the GOP keyframe (KEY refreshes every slot, P
            # only slot 0, so slot 1 still holds the keyframe). Static
            # areas skip against the clean keyframe instead of
            # accumulating re-encode loss along the LAST chain.
            use_mref = (fast_ok and cfg.bit_depth == 8 and tgrid is None
                        and not aq and ss.multiref
                        and self._golden_rec is not None
                        and self._order_hint >= 2 and grain is None
                        and not self._lr_seq)
            if use_mref:
                from rav1e_tpu_torch.pipeline.tpu_inter import (
                    encode_pframe2_tpu)
                with trace.frame(frameno, "pframe2"):
                    data, rec = encode_pframe2_tpu(
                        planes, self._ref_rec, self._golden_rec,
                        qindex=q, order_hint=oh, cdef=cdef, slot_last=0,
                        slot_golden=1, golden_hint=0, dscale=dscale,
                        use_satd=ss.satd_subpel,
                        render_size=self._render, device=self.device)
            elif fast_ok and not aq:
                # the reference's low-latency call: the speed's tools
                # but encode_pframe_tpu's default search and subpel
                from rav1e_tpu_torch.pipeline.tpu_inter import (
                    encode_pframe_tpu)
                with trace.frame(frameno, "pframe"):
                    data, rec = encode_pframe_tpu(
                        planes, self._ref_rec, qindex=q, order_hint=oh,
                        cdef=cdef, film_grain=grain,
                        render_size=self._render,
                        use_split=ss.partition_split_rdo,
                        use_satd=ss.satd_subpel, refine16=ss.mv_refine_16,
                        intra_rdo=ss.intra_in_inter and tgrid is None,
                        b64_rdo=ss.b64_merge,
                        use_split8=ss.partition_split8, lr=self._lr_seq,
                        bit_depth=cfg.bit_depth, dscale=dscale,
                        src_dev=src_dev, tile_grid=tgrid,
                        device=self.device)
            else:
                from rav1e_tpu_torch.pipeline.inter import encode_pframe
                with trace.frame(frameno, "np_pframe"):
                    data, rec = encode_pframe(
                        planes, self._ref_rec, qindex=q, order_hint=oh,
                        cdef=cdef, film_grain=grain, aq=aq,
                        tile_cols_log2=self._tile_cols_log2,
                        tile_rows_log2=self._tile_rows_log2,
                        **self._numpy_kw())
        self._ref_rec = _host32(rec)
        if is_key:
            self._golden_rec = self._ref_rec
        else:
            self._slot_hints[0] = self._order_hint & 127
        self._rc_update(ftype, q, data)
        return Packet(data=data, input_frameno=frameno, frame_type=ftype,
                      qp=q, enc_stats=self._mk_stats(planes, rec,
                                                     data, q))

    def flush(self):
        self.send_frame(None)

    # -- C API support (rav1e src/capi.rs analogs) ---------------------------

    def force_key_frame(self):
        """Mark the NEXT frame passed to send_frame as a forced keyframe
        (rav1e_frame_set_type FrameTypeOverride::Key)."""
        self._force_key_framenos.add(self._input_frameno)

    def sequence(self):
        """Standalone Sequence matching what the pipelines will emit
        (rav1e_container_sequence_header)."""
        from rav1e_tpu_torch.entropy.obu import Sequence
        extra = self._seq_extra or {}
        return Sequence(
            width=self._cw, height=self._ch,
            bit_depth=self.cfg.bit_depth,
            subsampling_x=self._ss_x, subsampling_y=self._ss_y,
            enable_cdef=True,
            enable_intra_edge_filter=True,
            still_picture=bool(extra.get("still_picture", False)),
            color_range=int(extra.get("color_range", 0)),
            color_description=extra.get("color_description"),
            timing_info_present=bool(
                extra.get("timing_info_present", False)),
            num_units_in_display_tick=int(
                extra.get("num_units_in_display_tick", 1)),
            time_scale=int(extra.get("time_scale", 30)),
            num_ticks_per_picture=int(
                extra.get("num_ticks_per_picture", 1)))

    def twopass_bytes_needed(self) -> int:
        """Bytes of pass-1 data wanted before the next pass-2 packet
        (0 when satisfied; rav1e_twopass_bytes_needed)."""
        return self._rc.twopass_bytes_needed()

    # -- two-pass plumbing (rav1e rav1e_twopass_out/in analogs) --------------

    def twopass_out(self) -> bytes:
        """Pass-1 records produced since the last call."""
        return self._rc.twopass_out()

    def twopass_summary(self) -> bytes:
        """End-of-pass-1 summary (call after draining all packets)."""
        return self._rc.twopass_summary()

    def twopass_in(self, data: bytes):
        """Feed the complete pass-1 stats before pass-2 encoding."""
        self._rc.twopass_in(data)


def _host32(rec) -> list[np.ndarray]:
    """A recon's planes as host int32 arrays (a device tensor is fetched
    first)."""
    with trace.span("host32"):
        return [np.asarray(p.cpu() if isinstance(p, torch.Tensor) else p
                           ).astype(np.int32) for p in rec]
