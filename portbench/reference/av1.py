"""Plain reader of AV1 temporal units down to the end of each frame's
uncompressed header and the sizes of its tiles (AV1 bitstream
specification, sections 5.3-5.11: obu_header, sequence_header_obu,
uncompressed_header, tile_group_obu). Written from the specification;
it reads the syntax a single-layer 8- or 10-bit stream without
superres, frame ids, intrabc, warped or global motion and decoder models
uses, and raises `Unsupported` on anything else. It keeps each tile's
bytes and what `decode.py` needs to decode them."""

from __future__ import annotations

from dataclasses import dataclass, field

OBU_SEQUENCE_HEADER, OBU_TD, OBU_FRAME_HEADER, OBU_FRAME = 1, 2, 3, 6
OBU_TILE_GROUP, OBU_METADATA, OBU_PADDING = 4, 5, 15
KEY, INTER, INTRA_ONLY, SWITCH = 0, 1, 2, 3
PRIMARY_REF_NONE = 7
SEG_FEATURE_BITS = (8, 6, 6, 6, 6, 3, 0, 0)
SEG_FEATURE_SIGNED = (1, 1, 1, 1, 1, 0, 0, 0)


class Unsupported(ValueError):
    """Syntax outside what this reader covers, or a malformed unit."""


class Bits:
    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def f(self, n: int) -> int:
        v = 0
        for _ in range(n):
            i = self.pos >> 3
            if i >= len(self.data):
                raise Unsupported("read past the end of the OBU")
            v = (v << 1) | ((self.data[i] >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def su(self, n: int) -> int:
        v = self.f(n)
        return v - (1 << n) if v & (1 << (n - 1)) else v

    def uvlc(self) -> int:
        lz = 0
        while not self.f(1):
            lz += 1
            if lz > 32:
                raise Unsupported("uvlc too long")
        return (1 << lz) - 1 + self.f(lz) if lz else 0

    def le(self, n: int) -> int:
        if self.pos & 7:
            raise Unsupported("le() not byte aligned")
        i = self.pos >> 3
        v = int.from_bytes(self.data[i:i + n], "little")
        self.pos += 8 * n
        return v

    def byte_align(self):
        self.pos = (self.pos + 7) & ~7


@dataclass
class Seq:
    profile: int
    width: int
    height: int
    bit_depth: int
    ss_x: int
    ss_y: int
    mono: bool
    order_hint_bits: int
    enable_order_hint: bool
    enable_ref_frame_mvs: bool
    enable_warped_motion: bool
    force_sct: int          # seq_force_screen_content_tools
    force_int_mv: int       # seq_force_integer_mv
    enable_superres: bool
    enable_cdef: bool
    enable_restoration: bool
    film_grain: bool
    separate_uv_delta_q: bool
    equal_picture_interval: bool
    use_128: bool
    enable_filter_intra: bool = False
    enable_intra_edge_filter: bool = False
    enable_interintra: bool = False
    enable_masked_compound: bool = False
    enable_jnt_comp: bool = False


@dataclass
class Frame:
    show_existing: bool = False
    show_idx: int = -1
    frame_type: int = KEY
    show_frame: bool = True
    showable: bool = False
    error_resilient: bool = False
    order_hint: int = 0
    primary_ref_frame: int = PRIMARY_REF_NONE
    refresh: int = 0
    ref_idx: tuple = ()
    width: int = 0
    height: int = 0
    render: tuple = (0, 0)
    base_q_idx: int = 0
    delta_q: tuple = (0, 0, 0, 0, 0)   # y dc, u dc, u ac, v dc, v ac
    segmentation: bool = False
    lf_levels: tuple = (0, 0, 0, 0)
    cdef: tuple | None = None          # (damping, [(yp, ys, up, us)])
    lr: tuple = (0, 0, 0)
    tx_mode_select: bool = False
    reference_select: bool = False
    skip_mode: bool = False
    reduced_tx_set: bool = False
    tile_size_bytes: int = 4
    tiles: list = field(default_factory=list)   # byte size of each tile
    tile_data: list = field(default_factory=list)
    disable_cdf_update: bool = False
    allow_sct: bool = False
    force_int_mv: bool = False
    allow_hp: bool = False
    interp_filter: int = 0
    filter_switchable: bool = False
    motion_switchable: bool = False
    lf_sharpness: int = 0
    lf_delta_enabled: bool = False
    delta_q_present: bool = False
    cdef_bits: int = 0
    ref_hints: tuple = ()              # RefOrderHint of each ref_idx slot


@dataclass
class Unit:
    """One temporal unit: its sequence header (if it carries one) and its
    frame."""

    seq: Seq | None
    frame: Frame


def obus(data: bytes):
    """(obu_type, payload) of each OBU."""
    i = 0
    while i < len(data):
        h = data[i]
        if h & 0x80:
            raise Unsupported("obu_forbidden_bit set")
        typ, ext, has_size = (h >> 3) & 15, (h >> 2) & 1, (h >> 1) & 1
        i += 1 + ext
        if not has_size:
            raise Unsupported("OBU without a size field")
        size = shift = 0
        while True:
            if i >= len(data):
                raise Unsupported("truncated leb128")
            b = data[i]
            i += 1
            size |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        if i + size > len(data):
            raise Unsupported("OBU runs past the packet")
        yield typ, data[i:i + size]
        i += size


def _timing_info(b: Bits) -> bool:
    b.f(32)
    b.f(32)
    equal = bool(b.f(1))
    if equal:
        b.uvlc()
    return equal


def parse_sequence_header(p: bytes) -> Seq:
    b = Bits(p)
    profile = b.f(3)
    b.f(1)                                   # still_picture
    if b.f(1):
        raise Unsupported("reduced_still_picture_header")
    equal = False
    if b.f(1):                               # timing_info_present_flag
        equal = _timing_info(b)
        if b.f(1):
            raise Unsupported("decoder_model_info")
    ddelay = b.f(1)
    for _ in range(b.f(5) + 1):
        b.f(12)
        if b.f(5) > 7:
            b.f(1)
        if ddelay and b.f(1):
            b.f(4)
    wb, hb = b.f(4) + 1, b.f(4) + 1
    width, height = b.f(wb) + 1, b.f(hb) + 1
    if b.f(1):
        raise Unsupported("frame_id_numbers_present_flag")
    use_128 = bool(b.f(1))
    filter_intra, edge_filter = bool(b.f(1)), bool(b.f(1))
    interintra, masked = bool(b.f(1)), bool(b.f(1))
    warped = bool(b.f(1))
    b.f(1)                                   # enable_dual_filter
    eoh = bool(b.f(1))
    rfmvs = jnt = False
    if eoh:
        jnt = bool(b.f(1))
        rfmvs = bool(b.f(1))
    sct = 2 if b.f(1) else b.f(1)
    if sct > 0:
        imv = 2 if b.f(1) else b.f(1)
    else:
        imv = 2
    ohb = b.f(3) + 1 if eoh else 0
    superres, cdef, lr = bool(b.f(1)), bool(b.f(1)), bool(b.f(1))
    high = b.f(1)
    bd = (12 if b.f(1) else 10) if profile == 2 and high else (
        10 if high else 8)
    mono = bool(b.f(1)) if profile != 1 else False
    if mono:
        raise Unsupported("monochrome")
    cp = tc = mc = 2
    if b.f(1):
        cp, tc, mc = b.f(8), b.f(8), b.f(8)
    if cp == 1 and tc == 13 and mc == 0:
        ssx = ssy = 0
    else:
        b.f(1)                               # color_range
        if profile == 0:
            ssx = ssy = 1
        elif profile == 1:
            ssx = ssy = 0
        elif bd == 12:
            ssx = b.f(1)
            ssy = b.f(1) if ssx else 0
        else:
            ssx, ssy = 1, 0
        if ssx and ssy:
            b.f(2)                           # chroma_sample_position
    sep = bool(b.f(1))
    grain = bool(b.f(1))
    return Seq(profile, width, height, bd, ssx, ssy, mono, ohb, eoh, rfmvs,
               warped, sct, imv, superres, cdef, lr, grain, sep, equal,
               use_128, filter_intra, edge_filter, interintra, masked, jnt)


def _tile_log2(blk: int, target: int) -> int:
    k = 0
    while (blk << k) < target:
        k += 1
    return k


def _delta_q(b: Bits) -> int:
    return b.su(7) if b.f(1) else 0


def _rel(a: int, c: int, bits: int) -> int:
    diff = a - c
    m = 1 << (bits - 1)
    return (diff & (m - 1)) - (diff & m)


class Decoder:
    """The reference frame state a header reader needs (RefOrderHint,
    RefFrameType, each slot's size), carried from unit to unit."""

    def __init__(self):
        self.seq: Seq | None = None
        self.ref_hint = [0] * 8
        self.ref_type = [None] * 8
        self.ref_size = [None] * 8

    def frame_header(self, p: bytes) -> tuple[Frame, Bits]:
        s = self.seq
        if s is None:
            raise Unsupported("frame before any sequence header")
        b = Bits(p)
        fr = Frame()
        fr.show_existing = bool(b.f(1))
        if fr.show_existing:
            fr.show_idx = b.f(3)
            if self.ref_type[fr.show_idx] is None:
                raise Unsupported("show_existing_frame of an empty slot")
            fr.frame_type = self.ref_type[fr.show_idx]
            fr.order_hint = self.ref_hint[fr.show_idx]
            fr.width, fr.height = self.ref_size[fr.show_idx]
            if fr.frame_type == KEY:
                fr.refresh = 0xFF
            return fr, b
        fr.frame_type = b.f(2)
        intra = fr.frame_type in (KEY, INTRA_ONLY)
        fr.show_frame = bool(b.f(1))
        if fr.show_frame:
            fr.showable = fr.frame_type != KEY
        else:
            fr.showable = bool(b.f(1))
        if fr.frame_type == SWITCH or (fr.frame_type == KEY
                                       and fr.show_frame):
            fr.error_resilient = True
        else:
            fr.error_resilient = bool(b.f(1))
        if fr.frame_type == KEY and fr.show_frame:
            self.ref_hint = [0] * 8
            self.ref_type = [None] * 8
        disable_cdf_update = fr.disable_cdf_update = bool(b.f(1))
        sct = b.f(1) if s.force_sct == 2 else s.force_sct
        force_int_mv = 0
        if sct:
            force_int_mv = b.f(1) if s.force_int_mv == 2 else s.force_int_mv
        if intra:
            force_int_mv = 1
        fr.allow_sct, fr.force_int_mv = bool(sct), bool(force_int_mv)
        if fr.frame_type == SWITCH:
            override = True
        else:
            override = bool(b.f(1))
        if override:
            raise Unsupported("frame_size_override_flag")
        fr.order_hint = b.f(s.order_hint_bits)
        if intra or fr.error_resilient:
            fr.primary_ref_frame = PRIMARY_REF_NONE
        else:
            fr.primary_ref_frame = b.f(3)
        if fr.frame_type == SWITCH or (fr.frame_type == KEY
                                       and fr.show_frame):
            fr.refresh = 0xFF
        else:
            fr.refresh = b.f(8)
        if (not intra or fr.refresh != 0xFF) and fr.error_resilient \
                and s.enable_order_hint:
            for i in range(8):
                h = b.f(s.order_hint_bits)
                if h != self.ref_hint[i]:
                    raise Unsupported("ref_order_hint differs from the "
                                      "slot's")
        fr.width, fr.height = s.width, s.height
        if fr.frame_type == INTRA_ONLY:
            raise Unsupported("intra-only frames")
        if intra:
            self._superres(b)
            fr.render = self._render(b, s)
            if sct and b.f(1):
                raise Unsupported("allow_intrabc")
        else:
            if s.enable_order_hint and b.f(1):
                raise Unsupported("frame_refs_short_signaling")
            fr.ref_idx = tuple(b.f(3) for _ in range(7))
            for i in fr.ref_idx:
                if self.ref_type[i] is None:
                    raise Unsupported("reference to an empty slot")
            fr.ref_hints = tuple(self.ref_hint[i] for i in fr.ref_idx)
            self._superres(b)
            fr.render = self._render(b, s)
            if not force_int_mv:
                fr.allow_hp = bool(b.f(1))
            fr.filter_switchable = bool(b.f(1))
            if not fr.filter_switchable:
                fr.interp_filter = b.f(2)
            fr.motion_switchable = bool(b.f(1))
            if not fr.error_resilient and s.enable_ref_frame_mvs:
                if b.f(1):
                    raise Unsupported("use_ref_frame_mvs")
        if not disable_cdf_update:
            b.f(1)                           # disable_frame_end_update_cdf
        ntiles = self._tile_info(b, s, fr)
        fr.base_q_idx = b.f(8)
        ydc = _delta_q(b)
        udc = uac = vdc = vac = 0
        diff = bool(b.f(1)) if s.separate_uv_delta_q else False
        udc, uac = _delta_q(b), _delta_q(b)
        vdc, vac = (_delta_q(b), _delta_q(b)) if diff else (udc, uac)
        fr.delta_q = (ydc, udc, uac, vdc, vac)
        if b.f(1):                           # using_qmatrix
            b.f(4)
            b.f(4)
            if s.separate_uv_delta_q:
                b.f(4)
        fr.segmentation = bool(b.f(1))
        if fr.segmentation:
            if fr.primary_ref_frame != PRIMARY_REF_NONE:
                raise Unsupported("segmentation update flags")
            for _ in range(8):
                for j in range(8):
                    if b.f(1) and SEG_FEATURE_BITS[j]:
                        if SEG_FEATURE_SIGNED[j]:
                            b.su(1 + SEG_FEATURE_BITS[j])
                        else:
                            b.f(SEG_FEATURE_BITS[j])
        dq_present = bool(b.f(1)) if fr.base_q_idx > 0 else False
        fr.delta_q_present = dq_present
        if dq_present:
            b.f(2)
            if b.f(1):                       # delta_lf_present
                b.f(2)
                b.f(1)
        if fr.base_q_idx == 0:
            raise Unsupported("lossless")
        l0, l1 = b.f(6), b.f(6)
        l2 = l3 = 0
        if l0 or l1:
            l2, l3 = b.f(6), b.f(6)
        fr.lf_levels = (l0, l1, l2, l3)
        fr.lf_sharpness = b.f(3)
        fr.lf_delta_enabled = bool(b.f(1))
        if fr.lf_delta_enabled and b.f(1):   # loop_filter_delta_update
            for _ in range(8 + 2):
                if b.f(1):
                    b.su(7)
        if s.enable_cdef:
            damping = b.f(2) + 3
            bits = fr.cdef_bits = b.f(2)
            st = []
            for _ in range(1 << bits):
                yp, ys, up, us = b.f(4), b.f(2), b.f(4), b.f(2)
                st.append((yp, 4 if ys == 3 else ys, up, 4 if us == 3 else us))
            fr.cdef = (damping, st)
        if s.enable_restoration:
            fr.lr = tuple(b.f(2) for _ in range(3))
            if any(fr.lr):
                sh = b.f(1)
                if s.use_128:
                    sh += 1
                elif sh:
                    b.f(1)
                if s.ss_x and s.ss_y and any(fr.lr[1:]):
                    b.f(1)
        fr.tx_mode_select = bool(b.f(1))
        if not intra:
            fr.reference_select = bool(b.f(1))
            if fr.reference_select and s.enable_order_hint \
                    and self._skip_mode_allowed(fr, s):
                fr.skip_mode = bool(b.f(1))
            if not fr.error_resilient and s.enable_warped_motion:
                if b.f(1):
                    raise Unsupported("allow_warped_motion")
        fr.reduced_tx_set = bool(b.f(1))
        if not intra:
            for _ in range(7):
                if b.f(1):
                    raise Unsupported("global motion")
        if s.film_grain and (fr.show_frame or fr.showable):
            raise Unsupported("film grain parameters")
        fr.tiles = [0] * ntiles
        return fr, b

    def _superres(self, b: Bits):
        if self.seq.enable_superres and b.f(1):
            raise Unsupported("superres")

    @staticmethod
    def _render(b: Bits, s: Seq) -> tuple:
        if b.f(1):
            return (b.f(16) + 1, b.f(16) + 1)
        return (s.width, s.height)

    @staticmethod
    def _tile_info(b: Bits, s: Seq, fr: Frame) -> int:
        mi_cols = 2 * ((fr.width + 7) >> 3)
        mi_rows = 2 * ((fr.height + 7) >> 3)
        sh = 5 if s.use_128 else 4
        sb_cols = (mi_cols + (1 << sh) - 1) >> sh
        sb_rows = (mi_rows + (1 << sh) - 1) >> sh
        sb_size = sh + 2
        max_w_sb = 4096 >> sb_size
        max_area_sb = (4096 * 2304) >> (2 * sb_size)
        min_cols = _tile_log2(max_w_sb, sb_cols)
        max_cols = _tile_log2(1, min(sb_cols, 64))
        max_rows = _tile_log2(1, min(sb_rows, 64))
        min_tiles = max(min_cols, _tile_log2(max_area_sb, sb_rows * sb_cols))
        if not b.f(1):
            raise Unsupported("non-uniform tile spacing")
        cols = min_cols
        while cols < max_cols and b.f(1):
            cols += 1
        rows = max(min_tiles - cols, 0)
        while rows < max_rows and b.f(1):
            rows += 1
        tile_w = (sb_cols + (1 << cols) - 1) >> cols
        tile_h = (sb_rows + (1 << rows) - 1) >> rows
        n_cols = -(-sb_cols // tile_w)
        n_rows = -(-sb_rows // tile_h)
        fr.tile_size_bytes = 4
        if cols or rows:
            b.f(rows + cols)
            fr.tile_size_bytes = b.f(2) + 1
        return n_cols * n_rows

    def _skip_mode_allowed(self, fr: Frame, s: Seq) -> bool:
        bits = s.order_hint_bits
        fwd = bwd = None
        for i in fr.ref_idx:
            h = self.ref_hint[i]
            d = _rel(h, fr.order_hint, bits)
            if d < 0 and (fwd is None or _rel(h, fwd, bits) > 0):
                fwd = h
            elif d > 0 and (bwd is None or _rel(h, bwd, bits) < 0):
                bwd = h
        if fwd is None:
            return False
        if bwd is not None:
            return True
        snd = None
        for i in fr.ref_idx:
            h = self.ref_hint[i]
            if _rel(h, fwd, bits) < 0 and (snd is None
                                           or _rel(h, snd, bits) > 0):
                snd = h
        return snd is not None

    def update_refs(self, fr: Frame):
        """The reference update process for a decoded frame."""
        for i in range(8):
            if fr.refresh >> i & 1:
                self.ref_hint[i] = fr.order_hint
                self.ref_type[i] = fr.frame_type
                self.ref_size[i] = (fr.width, fr.height)

    def unit(self, data: bytes) -> Unit:
        """Read one temporal unit and apply its reference updates."""
        seq = None
        frame = None
        got_td = False
        for k, (typ, p) in enumerate(obus(data)):
            if typ == OBU_TD:
                if k != 0 or p:
                    raise Unsupported("temporal delimiter not first or "
                                      "not empty")
                got_td = True
            elif typ == OBU_SEQUENCE_HEADER:
                seq = self.seq = parse_sequence_header(p)
            elif typ in (OBU_METADATA, OBU_PADDING):
                continue
            elif typ in (OBU_FRAME, OBU_FRAME_HEADER):
                if frame is not None:
                    raise Unsupported("two frames in one temporal unit")
                frame, b = self.frame_header(p)
                if typ == OBU_FRAME_HEADER:
                    if not frame.show_existing:
                        raise Unsupported("separate tile group OBUs")
                    _trailing(b)
                else:
                    if frame.show_existing:
                        raise Unsupported("show_existing_frame in a FRAME "
                                          "OBU")
                    b.byte_align()
                    self._tiles(b, frame)
            else:
                raise Unsupported(f"OBU type {typ}")
        if not got_td or frame is None:
            raise Unsupported("a temporal unit needs a TD and a frame")
        if frame.show_existing and frame.frame_type == KEY:
            raise Unsupported("show_existing of a key frame")
        if not frame.show_existing:
            self.update_refs(frame)
        return Unit(seq, frame)

    @staticmethod
    def _tiles(b: Bits, fr: Frame):
        n = len(fr.tiles)
        if n > 1 and b.f(1):
            raise Unsupported("tile_start_and_end_present_flag")
        b.byte_align()
        end = len(b.data)
        for t in range(n):
            if t < n - 1:
                size = b.le(fr.tile_size_bytes) + 1
            else:
                size = end - (b.pos >> 3)
            if size <= 0 or (b.pos >> 3) + size > end:
                raise Unsupported("tile sizes do not fit the OBU")
            fr.tiles[t] = size
            fr.tile_data.append(b.data[b.pos >> 3:(b.pos >> 3) + size])
            b.pos += 8 * size


def _trailing(b: Bits):
    """trailing_bits(): a one, then zeros to the end of the OBU."""
    if b.f(1) != 1:
        raise Unsupported("trailing one bit missing")
    while b.pos < 8 * len(b.data):
        if b.f(1):
            raise Unsupported("nonzero trailing bits")


def shows_frame(data: bytes) -> bool:
    """Whether a temporal unit displays a frame: its frame header's first
    bits (show_existing_frame, or frame_type then show_frame), which need
    no decoder state."""
    for typ, p in obus(data):
        if typ in (OBU_FRAME, OBU_FRAME_HEADER):
            b = Bits(p)
            if b.f(1):
                return True
            b.f(2)
            return bool(b.f(1))
    raise Unsupported("a temporal unit without a frame")
