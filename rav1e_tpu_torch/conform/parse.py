"""Minimal AV1 bitstream parser for debugging/conformance tooling.

Parses OBUs, sequence headers and intra frame headers (the subset our
encoder emits plus what rav1e v0.5.1 writes for keyframes) far enough
to locate tile data. Also contains a bit-exact replica of dav1d's msac
decoder for symbol-level debugging (reference: dav1d src/msac.c).
The port's copy of the JAX package's parser (host code).
"""

from __future__ import annotations

from dataclasses import dataclass, field

EC_WIN_SIZE = 64
_MASK = (1 << 64) - 1


class BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def f(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def byte_align(self):
        self.pos = (self.pos + 7) & ~7


def parse_obus(packet: bytes):
    """Yield (obu_type, payload_bytes)."""
    i = 0
    while i < len(packet):
        hdr = packet[i]
        obu_type = (hdr >> 3) & 0xF
        has_size = (hdr >> 1) & 1
        ext = (hdr >> 2) & 1
        i += 1
        if ext:
            i += 1
        assert has_size
        sz = 0
        shift = 0
        while True:
            b = packet[i]
            i += 1
            sz |= (b & 0x7F) << shift
            shift += 7
            if not (b & 0x80):
                break
        yield obu_type, packet[i: i + sz]
        i += sz


@dataclass
class SeqInfo:
    width: int = 0
    height: int = 0
    order_hint_bits: int = 0
    enable_cdef: bool = False
    enable_restoration: bool = False
    enable_superres: bool = False
    bit_depth: int = 8
    mono: bool = False
    film_grain: bool = False
    still_picture: bool = False
    reduced_still: bool = False
    seq_force_screen_content_tools: int = 2
    seq_force_integer_mv: int = 2
    frame_id_numbers: bool = False
    use_128: bool = False
    raw: dict = field(default_factory=dict)


def parse_sequence_header(payload: bytes) -> SeqInfo:
    b = BitReader(payload)
    s = SeqInfo()
    profile = b.f(3)
    s.still_picture = bool(b.f(1))
    s.reduced_still = bool(b.f(1))
    assert not s.reduced_still, "reduced header not handled"
    timing = b.f(1)
    assert timing == 0
    b.f(1)  # initial_display_delay
    ops = b.f(5) + 1
    for _ in range(ops):
        b.f(12)
        lvl = b.f(5)
        if lvl > 7:
            b.f(1)
    wbits = b.f(4) + 1
    hbits = b.f(4) + 1
    s.width = b.f(wbits) + 1
    s.height = b.f(hbits) + 1
    s.frame_id_numbers = bool(b.f(1))
    assert not s.frame_id_numbers
    s.use_128 = bool(b.f(1))
    b.f(1)  # filter_intra
    b.f(1)  # intra edge filter
    b.f(1)  # interintra
    b.f(1)  # masked
    b.f(1)  # warped
    b.f(1)  # dual filter
    order_hint = b.f(1)
    if order_hint:
        b.f(1)  # jnt
        b.f(1)  # ref frame mvs
    if b.f(1) == 0:  # seq_choose_screen_content_tools
        s.seq_force_screen_content_tools = b.f(1)
    if s.seq_force_screen_content_tools > 0:
        if b.f(1) == 0:  # seq_choose_integer_mv
            s.seq_force_integer_mv = b.f(1)
    else:
        s.seq_force_integer_mv = 2
    if order_hint:
        s.order_hint_bits = b.f(3) + 1
    s.enable_superres = bool(b.f(1))
    s.enable_cdef = bool(b.f(1))
    s.enable_restoration = bool(b.f(1))
    # color config
    high = b.f(1)
    if profile == 2 and high:
        twelve = b.f(1)
        s.bit_depth = 12 if twelve else 10
    else:
        s.bit_depth = 10 if high else 8
    if profile != 1:
        s.mono = bool(b.f(1))
    cdesc = b.f(1)
    if cdesc:
        cp, tc, mc = b.f(8), b.f(8), b.f(8)
    else:
        cp = tc = mc = None
    identity = cdesc and cp == 1 and tc == 13 and mc == 0
    if s.mono:
        b.f(1)
    elif not identity:
        b.f(1)  # color_range
        if profile == 0:
            ssx = ssy = 1
        else:
            ssx = ssy = 0
        if ssx and ssy:
            b.f(2)  # chroma sample position
    b.f(1)  # separate_uv_delta_q
    s.film_grain = bool(b.f(1))
    return s


@dataclass
class FrameInfo:
    frame_type: int = 0
    base_q_idx: int = 0
    tile_data_offset: int = 0  # byte offset of tile group within payload
    tx_mode_select: int = 0
    reduced_tx_set: int = 0
    deblock_levels: tuple = (0, 0, 0, 0)
    cdef_bits: int = 0
    disable_cdf_update: int = 0
    tile_cols_log2: int = 0
    tile_rows_log2: int = 0
    raw: dict = field(default_factory=dict)


def _tile_log2(blk, target):
    k = 0
    while (blk << k) < target:
        k += 1
    return k


def parse_intra_frame(payload: bytes, s: SeqInfo) -> FrameInfo:
    """Parse the uncompressed header of a KEY/INTRA frame inside an
    OBU_FRAME payload; returns info incl. tile data offset."""
    b = BitReader(payload)
    fi = FrameInfo()
    assert b.f(1) == 0, "show_existing_frame"
    fi.frame_type = b.f(2)
    show = b.f(1)
    assert fi.frame_type == 0 and show == 1, "only shown KEY supported"
    fi.disable_cdf_update = b.f(1)
    if s.seq_force_screen_content_tools == 2:
        allow_screen = b.f(1)
    else:
        allow_screen = s.seq_force_screen_content_tools
    assert allow_screen == 0
    size_override = b.f(1)
    b.f(s.order_hint_bits)  # order_hint
    assert size_override == 0
    if s.enable_superres:
        use_superres = b.f(1)
        assert not use_superres
    assert b.f(1) == 0, "render size differs"
    if not fi.disable_cdf_update:
        b.f(1)  # disable_frame_end_update_cdf
    # tile info
    mi_cols = 2 * ((s.width + 7) >> 3)
    mi_rows = 2 * ((s.height + 7) >> 3)
    sb_cols = (mi_cols + 15) >> 4
    sb_rows = (mi_rows + 15) >> 4
    assert not s.use_128
    uniform = b.f(1)
    assert uniform == 1
    min_cols = _tile_log2(64, sb_cols)
    max_cols = _tile_log2(1, min(sb_cols, 64))
    max_rows = _tile_log2(1, min(sb_rows, 64))
    min_tiles = max(min_cols, _tile_log2(2304, sb_rows * sb_cols))
    k = min_cols
    while k < max_cols and b.f(1):
        k += 1
    fi.tile_cols_log2 = k
    min_rows = max(min_tiles - k, 0)
    k = min_rows
    while k < max_rows and b.f(1):
        k += 1
    fi.tile_rows_log2 = k
    if fi.tile_cols_log2 or fi.tile_rows_log2:
        b.f(fi.tile_cols_log2 + fi.tile_rows_log2)  # context_update_tile_id
        fi.raw["tile_size_bytes"] = b.f(2) + 1
    # quantization
    fi.base_q_idx = b.f(8)
    for _ in range(3):  # y_dc, u_dc, u_ac (separate_uv_delta_q == 0)
        if b.f(1):
            b.f(7)
    assert b.f(1) == 0, "qmatrix"
    assert b.f(1) == 0, "segmentation"
    if fi.base_q_idx > 0:
        delta_q_present = b.f(1)
        if delta_q_present:
            b.f(2)
            delta_lf = b.f(1)
            if delta_lf:
                b.f(2)
                b.f(1)
    # loop filter
    l0, l1 = b.f(6), b.f(6)
    l2 = l3 = 0
    if not s.mono and (l0 or l1):
        l2, l3 = b.f(6), b.f(6)
    fi.deblock_levels = (l0, l1, l2, l3)
    b.f(3)  # sharpness
    if b.f(1):  # delta enabled
        if b.f(1):  # delta update
            for _ in range(8):
                if b.f(1):
                    b.f(7)
            for _ in range(2):
                if b.f(1):
                    b.f(7)
    if s.enable_cdef:
        b.f(2)  # damping - 3
        fi.cdef_bits = b.f(2)
        for _ in range(1 << fi.cdef_bits):
            b.f(6)
            b.f(6)
    if s.enable_restoration:
        kinds = [b.f(2) for _ in range(3 if not s.mono else 1)]
        if any(kinds):
            raise NotImplementedError("restoration parsing")
    fi.tx_mode_select = b.f(1)
    # intra: no reference mode / skip mode / warped
    fi.reduced_tx_set = b.f(1)
    # film grain absent (no film_grain or not shown)
    assert not s.film_grain
    b.byte_align()
    fi.tile_data_offset = b.pos >> 3
    return fi


class Msac:
    """Bit-exact replica of dav1d's C msac decoder."""

    def __init__(self, data: bytes, disable_cdf_update: bool = False):
        self.buf = data
        self.pos = 0
        self.dif = (1 << (EC_WIN_SIZE - 1)) - 1
        self.rng = 0x8000
        self.cnt = -15
        self.allow_update = not disable_cdf_update
        self._refill()

    def _refill(self):
        c = EC_WIN_SIZE - self.cnt - 24
        dif = self.dif
        while c >= 0:
            if self.pos >= len(self.buf):
                break
            dif ^= self.buf[self.pos] << c
            self.pos += 1
            c -= 8
        self.dif = dif
        self.cnt = EC_WIN_SIZE - c - 24

    def _norm(self, dif: int, rng: int):
        d = 16 - rng.bit_length()
        self.cnt -= d
        self.dif = (((dif + 1) << d) - 1) & _MASK
        self.rng = rng << d
        if self.cnt < 0:
            self._refill()

    def decode_symbol(self, cdf: list) -> int:
        """cdf: mutable list [v0..v_{n-2}, 0, counter] (n-symbol)."""
        n_symbols = len(cdf) - 2  # dav1d convention: nsyms - 1
        c = self.dif >> (EC_WIN_SIZE - 16)
        r = self.rng
        v = r
        val = -1
        while True:
            val += 1
            u = v
            v = ((r >> 8) * (cdf[val] >> 6) >> 1) + 4 * (n_symbols - val)
            if c >= v:
                break
        self.dif -= v << (EC_WIN_SIZE - 16)
        if self.allow_update:
            count = cdf[n_symbols + 1]
            rate = 4 + (count >> 4) + (n_symbols > 2)
            for i in range(val):
                cdf[i] += (32768 - cdf[i]) >> rate
            for i in range(val, n_symbols):
                cdf[i] -= cdf[i] >> rate
            cdf[n_symbols + 1] = count + (count < 32)
        self._norm(self.dif, u - v)
        return val

    def decode_bool(self, f: int) -> int:
        r = self.rng
        v = ((r >> 8) * (f >> 6) >> 1) + 4
        vw = v << (EC_WIN_SIZE - 16)
        ret = self.dif >= vw
        if ret:
            self.dif -= vw
            rng = r - v
        else:
            rng = v
        self._norm(self.dif, rng)
        return 0 if ret else 1

    def decode_bool_adapt(self, cdf: list) -> int:
        bit = self.decode_bool(cdf[0])
        if self.allow_update:
            count = cdf[2]
            rate = 4 + (count >> 4)
            if bit:
                cdf[0] += (32768 - cdf[0]) >> rate
            else:
                cdf[0] -= cdf[0] >> rate
            cdf[2] = count + (count < 32)
        return bit
