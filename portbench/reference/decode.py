"""A plain AV1 tile decoder: the symbol decoder, the tile syntax and the
reconstruction of the AV1 specification (sections 5.11, 6.10, 7.10-7.15,
8.2), in Python and numpy, for the syntax a single-tile 8-bit 4:2:0 stream
of this encoder uses: the partitions NONE, HORZ, VERT and SPLIT, intra
modes with angle deltas, chroma from luma and the edge filter, the
largest transform of each block, every transform type of the reduced
sets, single and compound (LAST, ALTREF-style) prediction from the
spatial motion vector stack, the regular 8-tap filter, deblocking and
CDEF. It raises `Unsupported` on anything else (segmentation, delta q,
palettes, loop restoration, switchable filters, several tiles...).

`decode_frame` decodes one frame from its packet's tiles and the planes
of the frames in its reference slots, and returns its reconstruction:
the frame it leaves as a reference. Nothing here comes from the program
under test; the default CDFs and quantizer tables (`default_cdfs.npz`)
are the specification's, and the 1-D transforms, the directional
predictor and the edge sample filters are frozen copies (`txfm.py`,
`predict.py`, `loopfilter.py`)."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from portbench.reference.av1 import KEY, Frame, Seq, Unsupported
from portbench.reference.loopfilter import cdef, deblock
from portbench.reference.predict import (compound_average, inter_block,
                                         intra_edges, predict_intra)
from portbench.reference.txfm import inverse_2d

# -- block and transform sizes (specification order) ------------------
W4 = [1, 1, 2, 2, 2, 4, 4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 1, 4, 2, 8, 4, 16]
H4 = [1, 2, 1, 2, 4, 2, 4, 8, 4, 8, 16, 8, 16, 32, 16, 32, 4, 1, 8, 2, 16, 4]
BLOCK = {(w, h): b for b, (w, h) in enumerate(zip(W4, H4))}
B8X8, B64X64 = 3, 12
SIZE_GROUP = [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 0, 0, 1, 1,
              2, 2]
NONE_P, HORZ, VERT, SPLIT = 0, 1, 2, 3
INTRA_MODE_CONTEXT = [0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0]
UV_CFL = 13
SMOOTHS = (9, 10, 11)
NEARESTMV, NEARMV, GLOBALMV, NEWMV = 13, 14, 15, 16
NEAREST_NEARESTMV, NEAR_NEARMV, NEAREST_NEWMV, NEW_NEARESTMV = 17, 18, 19, 20
NEAR_NEWMV, NEW_NEARMV, GLOBAL_GLOBALMV, NEW_NEWMV = 21, 22, 23, 24
NEW_MODES = (NEWMV, NEW_NEWMV, NEAR_NEWMV, NEW_NEARMV, NEAREST_NEWMV,
             NEW_NEARESTMV)
COMPOUND_MODE_CTX_MAP = [[0, 1, 1, 1, 1], [1, 2, 3, 4, 4], [4, 4, 5, 6, 7]]
REF_CAT_LEVEL = 640
MV_BORDER = 128
INTRA_FRAME, NONE_REF = 0, -1
BWDREF, ALTREF2, ALTREF = 5, 6, 7
DCT_DCT, IDTX = 0, 9
# Tx_Type_Intra_Inv_Set1/2, Tx_Type_Inter_Inv_Set1/2/3
INTRA_INV = {1: [9, 0, 10, 11, 3, 1, 2], 2: [9, 0, 3, 1, 2]}
INTER_INV = {1: [9, 10, 11, 12, 13, 14, 15, 0, 3, 1, 2, 6, 4, 5, 7, 8],
             2: [9, 10, 11, 0, 3, 1, 2, 6, 4, 5, 7, 8], 3: [9, 0]}
SET_TYPES = {0: {0}, **{s: set(v) for s, v in INTRA_INV.items()}}
INTER_SET_TYPES = {0: {0}, **{s: set(v) for s, v in INTER_INV.items()}}
MODE_TO_TXFM = [0, 1, 2, 0, 3, 1, 2, 2, 1, 3, 1, 2, 3, 0]
# Coeff_Base_Ctx_Offset by shape (square, tall, wide), [min(r,4)][min(c,4)]
_OFF_SQ = [[0, 1, 6, 6, 21], [1, 6, 6, 21, 21], [6, 6, 21, 21, 21],
           [6, 21, 21, 21, 21], [21, 21, 21, 21, 21]]
_OFF_TALL = [[0, 11, 11, 11, 11], [11, 11, 11, 11, 11], [6, 6, 21, 21, 21],
             [6, 21, 21, 21, 21], [21, 21, 21, 21, 21]]
_OFF_WIDE = [[0, 16, 6, 6, 21], [16, 16, 6, 21, 21], [16, 16, 21, 21, 21],
             [16, 16, 21, 21, 21], [16, 16, 21, 21, 21]]
_SIG_REF = {0: ((0, 1), (1, 0), (1, 1), (0, 2), (2, 0)),
            2: ((1, 0), (2, 0), (3, 0), (4, 0), (0, 1)),
            1: ((0, 1), (0, 2), (0, 3), (0, 4), (1, 0))}
_MAG_REF = {0: ((0, 1), (1, 0), (1, 1)), 2: ((0, 1), (1, 0), (2, 0)),
            1: ((0, 1), (1, 0), (0, 2))}
CLASS_2D, CLASS_HORIZ, CLASS_VERT = 0, 1, 2
PAD = 80          # samples kept past the frame for blocks that cross it


def _log2(n: int) -> int:
    return n.bit_length() - 1


def tx_class(t: int) -> int:
    if t in (10, 12, 14):
        return CLASS_VERT
    if t in (11, 13, 15):
        return CLASS_HORIZ
    return CLASS_2D


def max_tx(bs: int) -> tuple:
    """Max_Tx_Size_Rect, as (width, height) in samples."""
    return min(W4[bs] * 4, 64), min(H4[bs] * 4, 64)


def plane_block(bs: int, sx: int, sy: int) -> tuple:
    """get_plane_residual_size for 4:2:0 / 4:4:4, as (w4, h4)."""
    return max(W4[bs] >> sx, 1), max(H4[bs] >> sy, 1)


def uv_tx(bs: int, sx: int, sy: int) -> tuple:
    w4, h4 = plane_block(bs, sx, sy)
    tw, th = min(w4 * 4, 64), min(h4 * 4, 64)
    if tw == 64 or th == 64:
        if tw == 16:
            return 16, 32
        if th == 16:
            return 32, 16
        return 32, 32
    return tw, th


# -- default CDFs -------------------------------------------------------
_TABLES = None


def _tables() -> dict:
    global _TABLES
    if _TABLES is None:
        with np.load(Path(__file__).with_name("default_cdfs.npz")) as z:
            _TABLES = {k: z[k] for k in z.files}
    return _TABLES


def _cdfs(a: np.ndarray):
    """Nested lists of inverse CDFs, each with its adaptation counter."""
    if a.ndim == 1:
        return [int(v) for v in a] + [0]
    return [_cdfs(x) for x in a]


class CDFs:
    """Every CDF a tile of this syntax reads, at its default values."""

    def __init__(self, base_q_idx: int):
        t = _tables()
        q = 0 if base_q_idx <= 20 else 1 if base_q_idx <= 60 else \
            2 if base_q_idx <= 120 else 3
        for k in ("partition_8", "partition_mid", "kf_y_mode", "y_mode",
                  "uv_mode", "uv_mode_cfl", "angle_delta", "skip",
                  "cfl_sign", "cfl_alpha", "intra_ext_tx1", "intra_ext_tx2",
                  "inter_ext_tx1", "inter_ext_tx2", "inter_ext_tx3",
                  "intra_inter", "newmv", "zeromv", "refmv", "drl",
                  "single_ref", "comp_inter", "comp_ref_type", "comp_ref",
                  "comp_bwdref", "inter_compound_mode", "mv_joint"):
            setattr(self, k, _cdfs(t[k]))
        self.mv = [{k: _cdfs(t[f"mv{i}_{k}"]) for k in (
            "sign", "classes", "class0", "class0_fr", "class0_hp", "bits",
            "fr", "hp")} for i in (0, 1)]
        self.txb_skip = _cdfs(t["txb_skip"][q])
        self.eob_pt = {16 << i: _cdfs(t[f"eob_pt_{16 << i}"][q])
                       for i in range(7)}
        self.eob_hi_bit = _cdfs(t["eob_hi_bit"][q])
        self.coeff_base_eob = _cdfs(t["coeff_base_eob"][q])
        self.coeff_base = _cdfs(t["coeff_base42"][q])
        self.coeff_br = _cdfs(t["coeff_br"][q])
        self.dc_sign = _cdfs(t["dc_sign"][q])


# -- symbol decoder (specification 8.2) ---------------------------------
class SymbolReader:
    def __init__(self, data: bytes, adapt: bool):
        self.data = bytes(data) + bytes(4)
        self.pos = 0
        n = min(8 * len(data), 15)
        buf = self._f(n)
        self.val = ((1 << 15) - 1) ^ (buf << (15 - n))
        self.rng = 1 << 15
        self.max_bits = 8 * len(data) - 15
        self.adapt = adapt

    def _f(self, n: int) -> int:
        if n <= 0:
            return 0
        i, pos = self.pos >> 3, self.pos
        word = int.from_bytes(self.data[i:i + 4], "big")
        self.pos = pos + n
        return (word >> (32 - (pos & 7) - n)) & ((1 << n) - 1)

    def symbol(self, cdf: list, adapt: bool = True) -> int:
        n = len(cdf) - 1
        rng, val = self.rng, self.val
        r8 = rng >> 8
        cur = rng
        s = -1
        while True:
            s += 1
            prev = cur
            cur = ((r8 * (cdf[s] >> 6)) >> 1) + 4 * (n - s - 1)
            if val >= cur:
                break
        rng = prev - cur
        val -= cur
        bits = 16 - rng.bit_length()
        if bits:
            rng <<= bits
            mb = self.max_bits
            nb = bits if mb >= bits else (mb if mb > 0 else 0)
            new = self._f(nb) << (bits - nb)
            val = new ^ (((val + 1) << bits) - 1)
            self.max_bits -= bits
        self.val, self.rng = val, rng
        if adapt and self.adapt:
            count = cdf[n]
            rate = 3 + (count > 15) + (count > 31) + min(n.bit_length() - 1,
                                                         2)
            for i in range(n - 1):
                if i < s:
                    cdf[i] += (32768 - cdf[i]) >> rate
                else:
                    cdf[i] -= cdf[i] >> rate
            cdf[n] = count + (count < 32)
        return s

    def bool(self) -> int:
        return self.symbol([1 << 14, 0, 0], adapt=False)

    def literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bool()
        return v


class _Tile:
    """The decoding state of one frame (one tile)."""

    def __init__(self, fr: Frame, seq: Seq, refs: dict):
        if seq.bit_depth != 8 or (seq.ss_x, seq.ss_y) != (1, 1):
            raise Unsupported("only 8-bit 4:2:0 is decoded")
        if seq.use_128:
            raise Unsupported("128x128 superblocks")
        for what, on in (("filter intra", seq.enable_filter_intra),
                         ("inter-intra", seq.enable_interintra),
                         ("masked compound", seq.enable_masked_compound),
                         ("distance-weighted compound", seq.enable_jnt_comp),
                         ("segmentation", fr.segmentation),
                         ("delta q", fr.delta_q_present),
                         ("loop filter deltas", fr.lf_delta_enabled),
                         ("screen content tools", fr.allow_sct),
                         ("TX_MODE_SELECT", fr.tx_mode_select),
                         ("skip mode", fr.skip_mode),
                         ("loop restoration", any(fr.lr)),
                         ("switchable filters", fr.filter_switchable),
                         ("a filter other than EIGHTTAP",
                          fr.interp_filter != 0),
                         ("switchable motion modes", fr.motion_switchable),
                         ("several tiles", len(fr.tile_data) != 1)):
            if on:
                raise Unsupported(what)
        self.fr, self.seq = fr, seq
        self.intra_frame = fr.frame_type == KEY
        self.bd, self.sx, self.sy = 8, 1, 1
        self.w, self.h = fr.width, fr.height
        self.mi_cols = 2 * ((fr.width + 7) >> 3)
        self.mi_rows = 2 * ((fr.height + 7) >> 3)
        mr, mc = self.mi_rows + 32, self.mi_cols + 32
        self.msize = np.full((mr, mc), B8X8, np.int8)
        self.skip = np.zeros((mr, mc), np.uint8)
        self.is_inter = np.zeros((mr, mc), np.uint8)
        self.written = np.zeros((mr, mc), bool)
        self.ymode = np.zeros((mr, mc), np.int8)
        self.uvmode = np.zeros((mr, mc), np.int8)
        self.ref = np.full((mr, mc, 2), NONE_REF, np.int8)
        self.mvs = np.zeros((mr, mc, 2, 2), np.int32)
        self.txtype = np.zeros((mr, mc), np.int8)
        self.txw = [np.zeros(((mr * 4 >> s[1]) // 4, (mc * 4 >> s[0]) // 4),
                             np.int16) for s in ((0, 0), (1, 1), (1, 1))]
        self.txh = [a.copy() for a in self.txw]
        self.cdef_idx = np.full(((mr + 15) // 16, (mc + 15) // 16), -1,
                                np.int8)
        ph, pw = self.mi_rows * 4 + PAD, self.mi_cols * 4 + PAD
        self.planes = [np.zeros((ph, pw), np.int64),
                       np.zeros((ph >> 1, pw >> 1), np.int64),
                       np.zeros((ph >> 1, pw >> 1), np.int64)]
        self.above_lvl = [np.zeros(mc, np.int16) for _ in range(3)]
        self.above_dc = [np.zeros(mc, np.int8) for _ in range(3)]
        self.left_lvl = [np.zeros(mr, np.int16) for _ in range(3)]
        self.left_dc = [np.zeros(mr, np.int8) for _ in range(3)]
        self.cdf = CDFs(fr.base_q_idx)
        self.r = SymbolReader(fr.tile_data[0], not fr.disable_cdf_update)
        t = _tables()
        q, dq = fr.base_q_idx, fr.delta_q

        def look(name, d):
            return int(t[name][min(max(q + d, 0), 255)])
        self.dq = [(look("dc_q_8", dq[0]), look("ac_q_8", 0)),
                   (look("dc_q_8", dq[1]), look("ac_q_8", dq[2])),
                   (look("dc_q_8", dq[3]), look("ac_q_8", dq[4]))]
        bits = seq.order_hint_bits
        self.sign_bias = [False] * 8
        self.ref_planes = {}
        if not self.intra_frame:
            for i in range(7):
                d = fr.ref_hints[i] - fr.order_hint
                m = 1 << (bits - 1)
                d = (d & (m - 1)) - (d & m)
                self.sign_bias[i + 1] = d > 0
                planes = refs.get(fr.ref_idx[i])
                if planes is not None:
                    self.ref_planes[i + 1] = [np.asarray(p, np.int64)
                                              for p in planes]

    # -- the tile --------------------------------------------------------
    def decode(self):
        for r in range(0, self.mi_rows, 16):
            for p in range(3):
                self.left_lvl[p][:] = 0
                self.left_dc[p][:] = 0
            for c in range(0, self.mi_cols, 16):
                self._clear_block_decoded(r, c)
                self.decode_partition(r, c, B64X64)
        return self.planes

    def _clear_block_decoded(self, r, c):
        self.bdec = []
        for p in range(3):
            sx, sy = (self.sx, self.sy) if p else (0, 0)
            w4, h4 = (self.mi_cols - c) >> sx, (self.mi_rows - r) >> sy
            n_y, n_x = (16 >> sy) + 2, (16 >> sx) + 2
            d = np.zeros((n_y, n_x), bool)
            d[0, :min(max(w4 + 1, 0), n_x)] = True
            d[:min(max(h4 + 1, 0), n_y), 0] = True
            d[(16 >> sy) + 1, 0] = False
            self.bdec.append(d)

    def decode_partition(self, r, c, bs):
        if r >= self.mi_rows or c >= self.mi_cols:
            return
        half = W4[bs] >> 1
        has_rows = r + half < self.mi_rows
        has_cols = c + half < self.mi_cols
        if bs < B8X8:
            part = NONE_P
        elif has_rows and has_cols:
            part = self.r.symbol(self._part_cdf(r, c, bs))
        elif has_cols:
            part = SPLIT if self._split_bool(r, c, bs, (2, 3, 4, 6, 7, 9)) \
                else HORZ
        elif has_rows:
            part = SPLIT if self._split_bool(r, c, bs, (1, 3, 4, 5, 6, 8)) \
                else VERT
        else:
            part = SPLIT
        w, h = W4[bs], H4[bs]
        if part == NONE_P:
            self.decode_block(r, c, bs)
        elif part == HORZ:
            sub = BLOCK[(w, h // 2)]
            self.decode_block(r, c, sub)
            if has_rows:
                self.decode_block(r + half, c, sub)
        elif part == VERT:
            sub = BLOCK[(w // 2, h)]
            self.decode_block(r, c, sub)
            if has_cols:
                self.decode_block(r, c + half, sub)
        elif part == SPLIT:
            sub = BLOCK[(w // 2, h // 2)]
            if sub == 0:
                for dr, dc in ((0, 0), (0, 1), (1, 0), (1, 1)):
                    self.decode_partition(r + dr, c + dc, sub)
            else:
                for dr, dc in ((0, 0), (0, half), (half, 0), (half, half)):
                    self.decode_partition(r + dr, c + dc, sub)
        else:
            raise Unsupported(f"partition {part}")

    def _part_cdf(self, r, c, bs):
        bsl = _log2(W4[bs])
        above = r > 0 and _log2(W4[self.msize[r - 1, c]]) < bsl
        left = c > 0 and _log2(H4[self.msize[r, c - 1]]) < bsl
        ctx = 2 * int(left) + int(above)
        if bs == B8X8:
            return self.cdf.partition_8[ctx]
        return self.cdf.partition_mid[{6: 0, 9: 1, 12: 2}[bs]][ctx]

    def _split_bool(self, r, c, bs, parts):
        cdf = self._part_cdf(r, c, bs)
        n = len(cdf) - 1
        psum = 0
        for k in parts:
            if k < n:
                psum += (32768 if k == 0 else cdf[k - 1]) - cdf[k]
        return self.r.symbol([psum, 0, 0], adapt=False)

    # -- blocks ------------------------------------------------------------
    def decode_block(self, r, c, bs):
        b = _Block(r, c, bs)
        w4, h4 = W4[bs], H4[bs]
        if h4 == 1 and self.sy and not r & 1:
            b.has_chroma = False
        elif w4 == 1 and self.sx and not c & 1:
            b.has_chroma = False
        b.avail_u, b.avail_l = r > 0, c > 0
        b.avail_u_c, b.avail_l_c = b.avail_u, b.avail_l
        if b.has_chroma:
            if self.sy and h4 == 1:
                b.avail_u_c = r - 2 >= 0
            if self.sx and w4 == 1:
                b.avail_l_c = c - 2 >= 0
        if self.intra_frame:
            self.intra_frame_mode_info(b)
        else:
            self.inter_frame_mode_info(b)
        if b.skip:
            for p in range(1 + 2 * b.has_chroma):
                sx, sy = (self.sx, self.sy) if p else (0, 0)
                self.above_lvl[p][c >> sx:(c + w4) >> sx] = 0
                self.above_dc[p][c >> sx:(c + w4) >> sx] = 0
                self.left_lvl[p][r >> sy:(r + h4) >> sy] = 0
                self.left_dc[p][r >> sy:(r + h4) >> sy] = 0
        sl = (slice(r, r + h4), slice(c, c + w4))
        self.msize[sl] = bs
        self.skip[sl] = b.skip
        self.is_inter[sl] = b.is_inter
        self.ymode[sl] = b.ymode
        self.uvmode[sl] = b.uvmode
        self.ref[sl] = b.refs
        self.mvs[sl] = b.mv
        self.written[sl] = True
        if b.is_inter:
            self.predict_inter(b)
        self.residual(b)

    def _read_skip(self, b):
        ctx = (int(self.skip[b.r - 1, b.c]) if b.avail_u else 0) + \
              (int(self.skip[b.r, b.c - 1]) if b.avail_l else 0)
        b.skip = self.r.symbol(self.cdf.skip[ctx])

    def _read_cdef(self, b):
        if b.skip or not self.seq.enable_cdef:
            return
        r, c = b.r >> 4, b.c >> 4
        if self.cdef_idx[r, c] == -1:
            self.cdef_idx[r, c] = self.r.literal(self.fr.cdef_bits)

    def intra_frame_mode_info(self, b):
        self._read_skip(b)
        self._read_cdef(b)
        am = int(self.ymode[b.r - 1, b.c]) if b.avail_u else 0
        lm = int(self.ymode[b.r, b.c - 1]) if b.avail_l else 0
        b.ymode = self.r.symbol(self.cdf.kf_y_mode[INTRA_MODE_CONTEXT[am]][
            INTRA_MODE_CONTEXT[lm]])
        self._intra_rest(b)

    def _intra_rest(self, b):
        use_angle = b.bs >= B8X8
        if use_angle and 1 <= b.ymode <= 8:
            b.angle_y = self.r.symbol(self.cdf.angle_delta[b.ymode - 1]) - 3
        if b.has_chroma:
            cfl = max(W4[b.bs], H4[b.bs]) <= 8
            b.uvmode = self.r.symbol((self.cdf.uv_mode_cfl if cfl
                                      else self.cdf.uv_mode)[b.ymode])
            if b.uvmode == UV_CFL:
                signs = self.r.symbol(self.cdf.cfl_sign)
                su, sv = (signs + 1) // 3, (signs + 1) % 3
                if su:
                    a = 1 + self.r.symbol(self.cdf.cfl_alpha[(su - 1) * 3
                                                             + sv])
                    b.cfl_u = -a if su == 1 else a
                if sv:
                    a = 1 + self.r.symbol(self.cdf.cfl_alpha[(sv - 1) * 3
                                                             + su])
                    b.cfl_v = -a if sv == 1 else a
            if use_angle and 1 <= b.uvmode <= 8:
                b.angle_uv = self.r.symbol(
                    self.cdf.angle_delta[b.uvmode - 1]) - 3

    def inter_frame_mode_info(self, b):
        self._read_skip(b)
        self._read_cdef(b)
        ctx = self._intra_inter_ctx(b)
        b.is_inter = self.r.symbol(self.cdf.intra_inter[ctx])
        if not b.is_inter:
            b.ymode = self.r.symbol(self.cdf.y_mode[SIZE_GROUP[b.bs]])
            self._intra_rest(b)
            return
        self.read_ref_frames(b)
        comp = b.refs[1] > INTRA_FRAME
        st = self.find_mv_stack(b, comp)
        if comp:
            ctx = COMPOUND_MODE_CTX_MAP[st.ref_ctx >> 1][min(st.new_ctx, 4)]
            b.ymode = NEAREST_NEARESTMV + self.r.symbol(
                self.cdf.inter_compound_mode[ctx])
        elif self.r.symbol(self.cdf.newmv[st.new_ctx]) == 0:
            b.ymode = NEWMV
        elif self.r.symbol(self.cdf.zeromv[0]) == 0:
            b.ymode = GLOBALMV
        else:
            b.ymode = NEARESTMV if self.r.symbol(
                self.cdf.refmv[st.ref_ctx]) == 0 else NEARMV
        idx = 0
        if b.ymode in (NEWMV, NEW_NEWMV):
            for i in range(2):
                if st.n > i + 1:
                    if self.r.symbol(self.cdf.drl[st.drl_ctx[i]]) == 0:
                        idx = i
                        break
                    idx = i + 1
        elif b.ymode in (NEARMV, NEAR_NEARMV, NEAR_NEWMV, NEW_NEARMV):
            idx = 1
            for i in (1, 2):
                if st.n > i + 1:
                    if self.r.symbol(self.cdf.drl[st.drl_ctx[i]]) == 0:
                        idx = i
                        break
                    idx = i + 1
        for i in range(1 + comp):
            mode = _comp_mode(b.ymode, i)
            if mode == GLOBALMV:
                pred = (0, 0)
            else:
                pos = 0 if mode == NEARESTMV else idx
                if mode == NEWMV and st.n <= 1:
                    pos = 0
                pred = st.mvs[pos][i]
            if mode == NEWMV:
                d = self.read_mv()
                b.mv[i] = (pred[0] + d[0], pred[1] + d[1])
            else:
                b.mv[i] = pred

    def _intra_inter_ctx(self, b):
        ai = not self.is_inter[b.r - 1, b.c] if b.avail_u else False
        li = not self.is_inter[b.r, b.c - 1] if b.avail_l else False
        if b.avail_u and b.avail_l:
            return 3 if ai and li else int(ai or li)
        if b.avail_u or b.avail_l:
            return 2 * int(ai if b.avail_u else li)
        return 0

    def _neighbours(self, b):
        out = []
        if b.avail_u:
            out.append(tuple(self.ref[b.r - 1, b.c]))
        if b.avail_l:
            out.append(tuple(self.ref[b.r, b.c - 1]))
        return out

    def _count(self, b, *frames):
        return sum((r0 in frames) + (r1 in frames)
                   for r0, r1 in self._neighbours(b))

    def _ref_ctx(self, b, a, c):
        na, nc = self._count(b, *a), self._count(b, *c)
        return 0 if na < nc else (1 if na == nc else 2)

    def read_ref_frames(self, b):
        sym = self.r.symbol
        comp = 0
        if self.fr.reference_select and min(W4[b.bs], H4[b.bs]) >= 2:
            comp = sym(self.cdf.comp_inter[self._comp_mode_ctx(b)])
        if comp:
            if sym(self.cdf.comp_ref_type[self._comp_ref_type_ctx(b)]) == 0:
                raise Unsupported("unidirectional compound references")
            if sym(self.cdf.comp_ref[self._ref_ctx(b, (1, 2), (3, 4))][0]):
                r0 = 4 if sym(self.cdf.comp_ref[self._ref_ctx(
                    b, (3,), (4,))][2]) else 3
            else:
                r0 = 2 if sym(self.cdf.comp_ref[self._ref_ctx(
                    b, (1,), (2,))][1]) else 1
            if sym(self.cdf.comp_bwdref[self._ref_ctx(b, (5, 6), (7,))][0]):
                r1 = ALTREF
            else:
                r1 = ALTREF2 if sym(self.cdf.comp_bwdref[self._ref_ctx(
                    b, (5,), (6,))][1]) else BWDREF
            b.refs = (r0, r1)
            return
        sr = self.cdf.single_ref
        if sym(sr[self._ref_ctx(b, (1, 2, 3, 4), (5, 6, 7))][0]):
            if sym(sr[self._ref_ctx(b, (5, 6), (7,))][1]):
                r0 = ALTREF
            else:
                r0 = ALTREF2 if sym(sr[self._ref_ctx(b, (5,), (6,))][5]) \
                    else BWDREF
        elif sym(sr[self._ref_ctx(b, (1, 2), (3, 4))][2]):
            r0 = 4 if sym(sr[self._ref_ctx(b, (3,), (4,))][4]) else 3
        else:
            r0 = 2 if sym(sr[self._ref_ctx(b, (1,), (2,))][3]) else 1
        b.refs = (r0, NONE_REF)

    def _comp_mode_ctx(self, b):
        def side(avail, rr, cc):
            if not avail:
                return None
            r0, r1 = self.ref[rr, cc]
            return r0, r1 <= INTRA_FRAME, r0 <= INTRA_FRAME

        def bwd(x):
            return BWDREF <= x <= ALTREF
        a = side(b.avail_u, b.r - 1, b.c)
        l = side(b.avail_l, b.r, b.c - 1)
        if a and l:
            if a[1] and l[1]:
                return int(bwd(a[0])) ^ int(bwd(l[0]))
            if a[1]:
                return 2 + int(bwd(a[0]) or a[2])
            if l[1]:
                return 2 + int(bwd(l[0]) or l[2])
            return 4
        if a:
            return int(bwd(a[0])) if a[1] else 3
        if l:
            return int(bwd(l[0])) if l[1] else 3
        return 1

    def _comp_ref_type_ctx(self, b):
        def side(avail, rr, cc):
            r0, r1 = self.ref[rr, cc] if avail else (INTRA_FRAME, NONE_REF)
            intra = r0 <= INTRA_FRAME
            comp = avail and not intra and r1 > INTRA_FRAME
            uni = comp and (r0 >= BWDREF) == (r1 >= BWDREF)
            return r0, intra, comp, uni
        a0, a_intra, a_comp, a_uni = side(b.avail_u, b.r - 1, b.c)
        l0, l_intra, l_comp, l_uni = side(b.avail_l, b.r, b.c - 1)
        au, al = b.avail_u, b.avail_l
        if au and not a_intra and al and not l_intra:
            same = int((a0 >= BWDREF) == (l0 >= BWDREF))
            if not a_comp and not l_comp:
                return 1 + 2 * same
            if not a_comp:
                return 1 if not l_uni else 3 + same
            if not l_comp:
                return 1 if not a_uni else 3 + same
            if not a_uni and not l_uni:
                return 0
            if not a_uni or not l_uni:
                return 2
            return 3 + int((a0 == BWDREF) == (l0 == BWDREF))
        if au and al:
            if a_comp:
                return 1 + 2 * int(a_uni)
            if l_comp:
                return 1 + 2 * int(l_uni)
            return 2
        if a_comp:
            return 4 * int(a_uni)
        if l_comp:
            return 4 * int(l_uni)
        return 2

    def read_mv(self):
        joint = self.r.symbol(self.cdf.mv_joint)
        d = [0, 0]
        if joint in (2, 3):
            d[0] = self._mv_component(0)
        if joint in (1, 3):
            d[1] = self._mv_component(1)
        return d

    def _mv_component(self, i):
        t = self.cdf.mv[i]
        sym = self.r.symbol
        sign = sym(t["sign"])
        cls = sym(t["classes"])
        int_mv, hp = self.fr.force_int_mv, self.fr.allow_hp
        if cls == 0:
            c0 = sym(t["class0"])
            fr = 3 if int_mv else sym(t["class0_fr"][c0])
            h = sym(t["class0_hp"]) if hp else 1
            mag = ((c0 << 3) | (fr << 1) | h) + 1
        else:
            d = 0
            for k in range(cls):
                d |= sym(t["bits"][k]) << k
            mag = 2 << (cls + 2)
            fr = 3 if int_mv else sym(t["fr"])
            h = sym(t["hp"]) if hp else 1
            mag += ((d << 3) | (fr << 1) | h) + 1
        return -mag if sign else mag

    # -- the motion vector stack (specification 7.10.2) ---------------------
    def find_mv_stack(self, b, comp):
        st = _Stack(b, comp)
        bw4, bh4 = W4[b.bs], H4[b.bs]
        st.found = False
        self._scan_row(st, -1)
        above = st.found
        st.found = False
        self._scan_col(st, -1)
        left = st.found
        st.found = False
        if max(bw4, bh4) <= 16:
            self._scan_point(st, -1, bw4)
        above |= st.found
        close = int(above) + int(left)
        n_nearest, n_new = len(st.mvs), st.new
        for e in range(n_nearest):
            st.w[e] += REF_CAT_LEVEL
        st.found = False
        self._scan_point(st, -1, -1)
        above |= st.found
        st.found = False
        self._scan_row(st, -3)
        above |= st.found
        st.found = False
        self._scan_col(st, -3)
        left |= st.found
        st.found = False
        if bh4 > 1:
            self._scan_row(st, -5)
        above |= st.found
        st.found = False
        if bw4 > 1:
            self._scan_col(st, -5)
        left |= st.found
        total = int(above) + int(left)
        st.sort(0, n_nearest)
        st.sort(n_nearest, len(st.mvs))
        if len(st.mvs) < 2:
            self._extra_search(st)
        st.n = len(st.mvs)
        st.drl_ctx = []
        for i in range(st.n):
            z = 0
            if i + 1 < st.n:
                w0, w1 = st.w[i], st.w[i + 1]
                if w0 >= REF_CAT_LEVEL:
                    z = 0 if w1 >= REF_CAT_LEVEL else 1
                else:
                    z = 2
            st.drl_ctx.append(z)
        st.drl_ctx += [0] * 3
        top = -b.r * 32
        bottom = (self.mi_rows - bh4 - b.r) * 32
        lft = -b.c * 32
        right = (self.mi_cols - bw4 - b.c) * 32
        br_, bc_ = MV_BORDER + bh4 * 32, MV_BORDER + bw4 * 32
        st.mvs = [tuple((min(max(m[0], top - br_), bottom + br_),
                         min(max(m[1], lft - bc_), right + bc_))
                        for m in e) for e in st.mvs]
        while len(st.mvs) < 2:
            st.mvs.append(((0, 0), (0, 0)))
        if close == 0:
            st.new_ctx, st.ref_ctx = min(total, 1), total
        elif close == 1:
            st.new_ctx, st.ref_ctx = 3 - min(n_new, 1), 2 + total
        else:
            st.new_ctx, st.ref_ctx = 5 - min(n_new, 1), 5
        return st

    def _inside(self, r, c):
        return 0 <= r < self.mi_rows and 0 <= c < self.mi_cols

    def _scan_row(self, st, dr):
        b = st.b
        bw4 = W4[b.bs]
        end = min(bw4, self.mi_cols - b.c, 16)
        dc = 0
        step16 = bw4 >= 16
        if abs(dr) > 1:
            dr += b.r & 1
            dc = 1 - (b.c & 1)
        i = 0
        while i < end:
            rr, cc = b.r + dr, b.c + dc + i
            if not self._inside(rr, cc):
                break
            ln = min(bw4, W4[self.msize[rr, cc]])
            if abs(dr) > 1:
                ln = max(2, ln)
            if step16:
                ln = max(4, ln)
            self._add_candidate(st, rr, cc, 2 * ln)
            i += ln

    def _scan_col(self, st, dc):
        b = st.b
        bh4 = H4[b.bs]
        end = min(bh4, self.mi_rows - b.r, 16)
        dr = 0
        step16 = bh4 >= 16
        if abs(dc) > 1:
            dr = 1 - (b.r & 1)
            dc += b.c & 1
        i = 0
        while i < end:
            rr, cc = b.r + dr + i, b.c + dc
            if not self._inside(rr, cc):
                break
            ln = min(bh4, H4[self.msize[rr, cc]])
            if abs(dc) > 1:
                ln = max(2, ln)
            if step16:
                ln = max(4, ln)
            self._add_candidate(st, rr, cc, 2 * ln)
            i += ln

    def _scan_point(self, st, dr, dc):
        rr, cc = st.b.r + dr, st.b.c + dc
        if self._inside(rr, cc) and self.written[rr, cc]:
            self._add_candidate(st, rr, cc, 4)

    def _lower(self, mv):
        if self.fr.allow_hp:
            return tuple(mv)
        out = []
        for v in mv:
            v = int(v)
            if self.fr.force_int_mv:
                a = (abs(v) + 3) >> 3
                v = a << 3 if v > 0 else -(a << 3)
            elif v & 1:
                v += -1 if v > 0 else 1
            out.append(v)
        return tuple(out)

    def _add_candidate(self, st, rr, cc, weight):
        if not self.is_inter[rr, cc]:
            return
        refs = tuple(int(x) for x in self.ref[rr, cc])
        mode = int(self.ymode[rr, cc])
        if not st.comp:
            for lst in (0, 1):
                if refs[lst] == st.b.refs[0]:
                    mv = self._lower(self.mvs[rr, cc, lst])
                    if mode in NEW_MODES:
                        st.new += 1
                    st.found = True
                    st.push((mv,), weight)
        elif refs == tuple(st.b.refs):
            mvs = (self._lower(self.mvs[rr, cc, 0]),
                   self._lower(self.mvs[rr, cc, 1]))
            st.found = True
            st.push(mvs, weight)
            if mode in NEW_MODES:
                st.new += 1

    def _extra_search(self, st):
        b = st.b
        w4 = min(16, W4[b.bs], self.mi_cols - b.c)
        h4 = min(16, H4[b.bs], self.mi_rows - b.r)
        n4 = min(w4, h4)
        ref_id, ref_diff = [[], []], [[], []]
        for pss in (0, 1):
            if not (pss < 2 and len(st.mvs) < 2):
                break
            i = 0
            while i < n4 and len(st.mvs) < 2:
                rr, cc = (b.r - 1, b.c + i) if pss == 0 else (b.r + i,
                                                              b.c - 1)
                if not self._inside(rr, cc):
                    break
                self._add_extra(st, rr, cc, ref_id, ref_diff)
                i += (W4 if pss == 0 else H4)[self.msize[rr, cc]]
        if st.comp:
            combined = [[], []]
            for lst in (0, 1):
                mvs = list(ref_id[lst])
                for m in ref_diff[lst]:
                    if len(mvs) >= 2:
                        break
                    mvs.append(m)
                while len(mvs) < 2:
                    mvs.append((0, 0))
                combined[lst] = mvs
            if len(st.mvs) == 1:
                if (combined[0][0] == st.mvs[0][0]
                        and combined[1][0] == st.mvs[0][1]):
                    st.mvs.append((combined[0][1], combined[1][1]))
                else:
                    st.mvs.append((combined[0][0], combined[1][0]))
                st.w.append(2)
            else:
                for i in (0, 1):
                    st.mvs.append((combined[0][i], combined[1][i]))
                    st.w.append(2)

    def _add_extra(self, st, rr, cc, ref_id, ref_diff):
        refs = [int(x) for x in self.ref[rr, cc]]
        b = st.b
        for cl in (0, 1):
            cref = refs[cl]
            if cref <= INTRA_FRAME:
                continue
            mv = tuple(int(v) for v in self.mvs[rr, cc, cl])
            if st.comp:
                for lst in (0, 1):
                    if cref == b.refs[lst] and len(ref_id[lst]) < 2:
                        ref_id[lst].append(mv)
                    elif len(ref_diff[lst]) < 2:
                        m = mv
                        if self.sign_bias[cref] != self.sign_bias[
                                b.refs[lst]]:
                            m = (-m[0], -m[1])
                        ref_diff[lst].append(m)
            else:
                if self.sign_bias[cref] != self.sign_bias[b.refs[0]]:
                    mv = (-mv[0], -mv[1])
                if all(e[0] != mv for e in st.mvs):
                    st.mvs.append((mv,))
                    st.w.append(2)

    # -- prediction and residual -------------------------------------------
    def predict_inter(self, b):
        if not b.has_chroma or W4[b.bs] < 2 or H4[b.bs] < 2:
            raise Unsupported("inter blocks under 8x8")
        comp = b.refs[1] > INTRA_FRAME
        for p in range(3):
            sx, sy = (self.sx, self.sy) if p else (0, 0)
            x, y = (b.c >> sx) * 4, (b.r >> sy) * 4
            w, h = (W4[b.bs] * 4) >> sx, (H4[b.bs] * 4) >> sy
            preds = []
            for i in range(1 + comp):
                ref = self.ref_planes.get(b.refs[i])
                if ref is None:
                    raise Unsupported(f"no planes for reference {b.refs[i]}")
                preds.append(inter_block(ref[p], x, y, w, h, b.mv[i], sx,
                                         sy, comp))
            out = compound_average(*preds) if comp else preds[0]
            self.planes[p][y:y + h, x:x + w] = out

    def residual(self, b):
        tx = max_tx(b.bs)
        for p in range(1 + 2 * b.has_chroma):
            sx, sy = (self.sx, self.sy) if p else (0, 0)
            tw, th = tx if p == 0 else uv_tx(b.bs, sx, sy)
            pw4, ph4 = plane_block(b.bs, sx, sy)
            bx, by = (b.c >> sx) * 4, (b.r >> sy) * 4
            for y in range(0, ph4, th >> 2):
                for x in range(0, pw4, tw >> 2):
                    self.transform_block(b, p, bx + 4 * x, by + 4 * y, tw,
                                         th, x, y)

    def transform_block(self, b, p, sx0, sy0, tw, th, x, y):
        sx, sy = (self.sx, self.sy) if p else (0, 0)
        row, col = (sy0 << sy) >> 2, (sx0 << sx) >> 2
        sbr, sbc = row & 15, col & 15
        step_x, step_y = tw >> 2, th >> 2
        max_x = self.mi_cols * 4 - 1
        max_y = self.mi_rows * 4 - 1
        if sx0 >= (max_x >> sx) or sy0 >= (max_y >> sy):
            return
        pl = self.planes[p]
        bd = self.bdec[p]
        if not b.is_inter:
            cfl = p > 0 and b.uvmode == UV_CFL
            mode = b.ymode if p == 0 else (0 if cfl else b.uvmode)
            have_l = (b.avail_l if p == 0 else b.avail_l_c) or x > 0
            have_a = (b.avail_u if p == 0 else b.avail_u_c) or y > 0
            have_ar = bool(bd[(sbr >> sy), (sbc >> sx) + step_x + 1])
            have_bl = bool(bd[(sbr >> sy) + step_y + 1, (sbc >> sx)])
            mx = ((self.mi_cols * 4) >> sx) - 1
            my = ((self.mi_rows * 4) >> sy) - 1
            above, left, corner = intra_edges(pl, sx0, sy0, tw, th, have_l,
                                              have_a, have_ar, have_bl, mx,
                                              my, self.bd)
            pred = predict_intra(mode, b.angle_y if p == 0 else b.angle_uv,
                                 tw, th, above, left, corner, have_l,
                                 have_a, mx - sx0 + 1, my - sy0 + 1,
                                 self.bd, self.seq.enable_intra_edge_filter,
                                 self._filter_type(b, p))
            pl[sy0:sy0 + th, sx0:sx0 + tw] = pred
            if cfl:
                self._cfl(b, p, sx0, sy0, tw, th)
            if p == 0:
                b.max_luma_w, b.max_luma_h = sx0 + tw, sy0 + th
        if not b.skip:
            eob, quant = self.coeffs(b, p, sx0, sy0, tw, th)
            if eob:
                self._reconstruct(b, p, sx0, sy0, tw, th, quant)
        self.txw[p][sy0 >> 2:(sy0 >> 2) + step_y,
                    sx0 >> 2:(sx0 >> 2) + step_x] = tw
        self.txh[p][sy0 >> 2:(sy0 >> 2) + step_y,
                    sx0 >> 2:(sx0 >> 2) + step_x] = th
        bd[(sbr >> sy) + 1:(sbr >> sy) + 1 + step_y,
           (sbc >> sx) + 1:(sbc >> sx) + 1 + step_x] = True

    def _filter_type(self, b, p):
        def smooth(rr, cc):
            if p == 0:
                return int(self.ymode[rr, cc]) in SMOOTHS
            if self.ref[rr, cc, 0] > INTRA_FRAME:
                return False
            return int(self.uvmode[rr, cc]) in SMOOTHS
        above = left = False
        if b.avail_u if p == 0 else b.avail_u_c:
            rr, cc = b.r - 1, b.c
            if p > 0:
                if self.sx and not b.c & 1:
                    cc += 1
                if self.sy and b.r & 1:
                    rr -= 1
            above = smooth(rr, cc)
        if b.avail_l if p == 0 else b.avail_l_c:
            rr, cc = b.r, b.c - 1
            if p > 0:
                if self.sx and b.c & 1:
                    cc -= 1
                if self.sy and not b.r & 1:
                    rr += 1
            left = smooth(rr, cc)
        return int(above or left)

    def _cfl(self, b, p, x0, y0, w, h):
        sx, sy = self.sx, self.sy
        alpha = b.cfl_u if p == 1 else b.cfl_v
        ly = np.minimum((y0 + np.arange(h)) << sy, b.max_luma_h - (1 << sy))
        lx = np.minimum((x0 + np.arange(w)) << sx, b.max_luma_w - (1 << sx))
        luma = self.planes[0]
        t = np.zeros((h, w), np.int64)
        for dy in range(sy + 1):
            for dx in range(sx + 1):
                t += luma[np.ix_(ly + dy, lx + dx)]
        lv = t << (3 - sx - sy)
        n = _log2(w) + _log2(h)
        avg = (int(lv.sum()) + (1 << (n - 1))) >> n
        s = alpha * (lv - avg)
        scaled = np.where(s >= 0, (s + 32) >> 6, -((-s + 32) >> 6))
        pl = self.planes[p]
        pl[y0:y0 + h, x0:x0 + w] = np.clip(pl[y0:y0 + h, x0:x0 + w] + scaled,
                                           0, 255)

    def _tx_set(self, b, tw, th):
        sqr_up = _log2(max(tw, th)) - 2
        sqr = _log2(min(tw, th)) - 2
        if sqr_up > 3:
            return 0
        if b.is_inter:
            if self.fr.reduced_tx_set or sqr_up == 3:
                return 3
            return 2 if sqr == 2 else 1
        if sqr_up == 3:
            return 0
        if self.fr.reduced_tx_set:
            return 2
        return 2 if sqr == 2 else 1

    def _tx_type(self, b, p, x0, y0, tw, th):
        if max(tw, th) > 32:
            return DCT_DCT
        s = self._tx_set(b, tw, th)
        if p == 0:
            return int(self.txtype[y0 >> 2, x0 >> 2])
        types = (INTER_SET_TYPES if b.is_inter else SET_TYPES)[s]
        if b.is_inter:
            t = int(self.txtype[max(b.r, y0 << self.sy >> 2),
                                max(b.c, x0 << self.sx >> 2)])
        else:
            t = MODE_TO_TXFM[b.uvmode]
        return t if t in types else DCT_DCT

    def _read_tx_type(self, b, x0, y0, tw, th):
        s = self._tx_set(b, tw, th)
        t = DCT_DCT
        if s > 0 and self.fr.base_q_idx > 0:
            sqr = _log2(min(tw, th)) - 2
            if b.is_inter:
                table = {1: self.cdf.inter_ext_tx1, 2: self.cdf.inter_ext_tx2,
                         3: self.cdf.inter_ext_tx3}[s]
                t = INTER_INV[s][self.r.symbol(table[sqr])]
            else:
                table = {1: self.cdf.intra_ext_tx1,
                         2: self.cdf.intra_ext_tx2}[s]
                t = INTRA_INV[s][self.r.symbol(table[sqr][b.ymode])]
        self.txtype[y0 >> 2:(y0 + th) >> 2, x0 >> 2:(x0 + tw) >> 2] = t

    def coeffs(self, b, p, x0, y0, tw, th):
        sx, sy = (self.sx, self.sy) if p else (0, 0)
        sym = self.r.symbol
        x4, y4, w4, h4 = x0 >> 2, y0 >> 2, tw >> 2, th >> 2
        max_x4 = self.mi_cols >> sx
        max_y4 = self.mi_rows >> sy
        sqr = _log2(min(tw, th)) - 2
        sqr_up = _log2(max(tw, th)) - 2
        tctx = (sqr + sqr_up + 1) >> 1
        ptype = int(p > 0)
        a_lvl, a_dc = self.above_lvl[p], self.above_dc[p]
        l_lvl, l_dc = self.left_lvl[p], self.left_dc[p]
        ax = [x4 + k for k in range(w4) if x4 + k < max_x4]
        ly = [y4 + k for k in range(h4) if y4 + k < max_y4]
        pw4, ph4 = plane_block(b.bs, sx, sy)
        if p == 0:
            top = min(max([int(a_lvl[i]) for i in ax], default=0), 255)
            lft = min(max([int(l_lvl[i]) for i in ly], default=0), 255)
            if (pw4 * 4, ph4 * 4) == (tw, th):
                ctx = 0
            elif top == 0 and lft == 0:
                ctx = 1
            elif top == 0 or lft == 0:
                ctx = 2 + int(max(top, lft) > 3)
            elif max(top, lft) <= 3:
                ctx = 4
            elif min(top, lft) <= 3:
                ctx = 5
            else:
                ctx = 6
        else:
            above = any(a_lvl[i] or a_dc[i] for i in ax)
            left = any(l_lvl[i] or l_dc[i] for i in ly)
            ctx = 7 + int(above) + int(left)
            if pw4 * ph4 * 16 > tw * th:
                ctx += 3
        all_zero = sym(self.cdf.txb_skip[tctx][ctx])
        eob = 0
        cul = dc_cat = 0
        quant = None
        if all_zero:
            if p == 0:
                self.txtype[y4:y4 + h4, x4:x4 + w4] = DCT_DCT
        else:
            if p == 0:
                self._read_tx_type(b, x0, y0, tw, th)
            ttype = self._tx_type(b, p, x0, y0, tw, th)
            cls = tx_class(ttype)
            sw, sh = min(tw, 32), min(th, 32)
            scan = _scan(sw, sh, cls, ttype == IDTX)
            npel = sw * sh
            tbl = self.cdf.eob_pt[max(npel, 16)]
            emctx = 0 if cls == CLASS_2D else 1
            cdf = tbl[ptype][emctx] if npel <= 256 else tbl[ptype]
            pt = sym(cdf) + 1
            eob = pt if pt < 2 else (1 << (pt - 2)) + 1
            if pt >= 3:
                if sym(self.cdf.eob_hi_bit[tctx][ptype][pt - 1]):
                    eob += 1 << (pt - 3)
                for i in range(1, max(0, pt - 2)):
                    if self.r.bool():
                        eob += 1 << (max(0, pt - 2) - 1 - i)
            lv = np.zeros((sh, sw), np.int64)
            lay = _layout(sw, sh, cls)
            lvl = [0] * (sw * sh)
            l3 = [0] * lay.size
            l15 = [0] * lay.size
            cb = self.cdf.coeff_base[tctx][ptype]
            cbr = self.cdf.coeff_br[min(tctx, 3)][ptype]
            a, b_, c_, d, e = lay.base_nb
            f, g, h_ = lay.br_nb
            for ci in range(eob - 1, -1, -1):
                pos = scan[ci]
                q = lay.pidx[pos]
                if ci == eob - 1:
                    ectx = 0 if ci == 0 else (1 if ci <= npel >> 3 else
                                              2 if ci <= npel >> 2 else 3)
                    level = sym(self.cdf.coeff_base_eob[tctx][ptype][ectx]) + 1
                elif pos == 0 and cls == CLASS_2D:
                    level = sym(cb[0])
                else:
                    m = l3[q + a] + l3[q + b_] + l3[q + c_] + l3[q + d] + \
                        l3[q + e]
                    level = sym(cb[_MAG4[m] + lay.base_off[pos]])
                if level > 2:
                    m = l15[q + f] + l15[q + g] + l15[q + h_]
                    bc = _MAG6[m] + lay.br_off[pos]
                    for _ in range(4):
                        k = sym(cbr[bc])
                        level += k
                        if k < 3:
                            break
                lvl[pos] = level
                l3[q] = level if level < 3 else 3
                l15[q] = level if level < 15 else 15
            for ci in range(eob):
                pos = int(scan[ci])
                level = lvl[pos]
                if not level:
                    continue
                if ci == 0:
                    dcs = 0
                    for i in ax:
                        dcs += {1: -1, 2: 1}.get(int(a_dc[i]), 0)
                    for i in ly:
                        dcs += {1: -1, 2: 1}.get(int(l_dc[i]), 0)
                    sctx = 0 if dcs == 0 else (1 if dcs < 0 else 2)
                    sign = sym(self.cdf.dc_sign[ptype][sctx])
                else:
                    sign = self.r.bool()
                if level > 14:
                    n = 0
                    while True:
                        n += 1
                        if self.r.bool():
                            break
                        if n > 32:
                            raise Unsupported("golomb code too long")
                    x = 1
                    for _ in range(n - 1):
                        x = (x << 1) | self.r.bool()
                    level = x + 14
                if pos == 0:
                    dc_cat = 1 if sign else 2
                level &= 0xFFFFF
                cul += level
                r, c = divmod(pos, sw)
                lv[r, c] = -level if sign else level
            cul = min(63, cul)
            quant = (lv, ttype)
        a_lvl[x4:x4 + w4] = cul
        a_dc[x4:x4 + w4] = dc_cat
        l_lvl[y4:y4 + h4] = cul
        l_dc[y4:y4 + h4] = dc_cat
        return eob, quant

    def _reconstruct(self, b, p, x0, y0, tw, th, quant):
        lv, ttype = quant
        dc_q, ac_q = self.dq[p]
        q = np.full(lv.shape, ac_q, np.int64)
        q[0, 0] = dc_q
        pels = tw * th
        shift = int(pels > 256) + int(pels > 1024)
        a = ((np.abs(lv) * q) & 0xFFFFFF) >> shift
        dq = np.clip(np.sign(lv) * a, -(1 << (7 + self.bd)),
                     (1 << (7 + self.bd)) - 1)
        coef = np.zeros((th, tw), np.int64)
        coef[:lv.shape[0], :lv.shape[1]] = dq
        res = inverse_2d(coef, ttype, self.bd)
        pl = self.planes[p]
        pl[y0:y0 + th, x0:x0 + tw] = np.clip(pl[y0:y0 + th, x0:x0 + tw]
                                             + res, 0, (1 << self.bd) - 1)

    # -- the frame -----------------------------------------------------------
    def filters(self):
        fr = self.fr
        info = {"mi_rows": self.mi_rows, "mi_cols": self.mi_cols,
                "bw4": np.asarray(W4, np.int64)[self.msize.astype(np.int64)],
                "bh4": np.asarray(H4, np.int64)[self.msize.astype(np.int64)],
                "skip": self.skip, "is_inter": self.is_inter,
                "txw": self.txw, "txh": self.txh}
        deblock(self.planes, info, self.w, self.h, self.sx, self.sy,
                fr.lf_levels, fr.lf_sharpness, self.bd)
        if self.seq.enable_cdef and fr.cdef is not None:
            damping, strengths = fr.cdef
            self.planes = cdef(self.planes, self.skip, self.cdef_idx,
                               strengths, damping, self.mi_rows,
                               self.mi_cols, self.sx, self.sy, self.bd)


class _Block:
    def __init__(self, r, c, bs):
        self.r, self.c, self.bs = r, c, bs
        self.has_chroma = True
        self.skip = 0
        self.is_inter = 0
        self.ymode = 0
        self.uvmode = 0
        self.angle_y = self.angle_uv = 0
        self.cfl_u = self.cfl_v = 0
        self.refs = (INTRA_FRAME, NONE_REF)
        self.mv = [(0, 0), (0, 0)]
        self.max_luma_w = self.max_luma_h = 0


class _Stack:
    def __init__(self, b, comp):
        self.b, self.comp = b, comp
        self.mvs, self.w = [], []
        self.new = 0
        self.found = False

    def push(self, mvs, weight):
        for i, e in enumerate(self.mvs):
            if e == mvs:
                self.w[i] += weight
                return
        if len(self.mvs) < 8:
            self.mvs.append(mvs)
            self.w.append(weight)

    def sort(self, start, end):
        while end > start:
            new_end = start
            for i in range(start + 1, end):
                if self.w[i - 1] < self.w[i]:
                    self.w[i - 1], self.w[i] = self.w[i], self.w[i - 1]
                    self.mvs[i - 1], self.mvs[i] = self.mvs[i], self.mvs[i - 1]
                    new_end = i
            end = new_end


def _comp_mode(ymode, i):
    """get_mode(refList) of the specification."""
    if ymode < NEAREST_NEARESTMV:
        return ymode
    if i == 0:
        if ymode in (NEW_NEWMV, NEW_NEARESTMV, NEW_NEARMV):
            return NEWMV
        if ymode in (NEAREST_NEARESTMV, NEAREST_NEWMV):
            return NEARESTMV
        if ymode in (NEAR_NEARMV, NEAR_NEWMV):
            return NEARMV
        return GLOBALMV
    if ymode in (NEW_NEWMV, NEAREST_NEWMV, NEAR_NEWMV):
        return NEWMV
    if ymode in (NEAREST_NEARESTMV, NEW_NEARESTMV):
        return NEARESTMV
    if ymode in (NEAR_NEARMV, NEW_NEARMV):
        return NEARMV
    return GLOBALMV


_SCANS = {}


def _scan(w, h, cls, idtx):
    """The scan of a w x h coefficient block: positions r * w + c."""
    key = (w, h, cls)
    if key not in _SCANS:
        if cls == CLASS_VERT:
            s = [r * w + c for r in range(h) for c in range(w)]
        elif cls == CLASS_HORIZ:
            s = [r * w + c for c in range(w) for r in range(h)]
        else:
            s = []
            for d in range(w + h - 1):
                lo, hi = max(0, d - w + 1), min(d, h - 1)
                cells = [(r, d - r) for r in range(lo, hi + 1)]
                if (w == h and d % 2 == 0) or w > h:
                    cells = cells[::-1]
                s.extend(r * w + c for r, c in cells)
        _SCANS[key] = s
    return _SCANS[key]


_MAG4 = [min((m + 1) >> 1, 4) for m in range(16)]
_MAG6 = [min((m + 1) >> 1, 6) for m in range(46)]
_LAYOUTS = {}


class _Layout:
    """A w x h coefficient block laid out with 4 columns and 4 rows of
    zeros past it, so that the level contexts read their neighbours
    without bounds checks: each position's index there, the neighbours'
    offsets, and each position's context offsets (get_coeff_base_ctx and
    get_br_ctx of the specification)."""

    def __init__(self, w, h, cls):
        stride = w + 4
        self.size = stride * (h + 4)
        self.pidx = [(p // w) * stride + p % w for p in range(w * h)]
        self.base_nb = [dr * stride + dc for dr, dc in _SIG_REF[cls]]
        self.br_nb = [dr * stride + dc for dr, dc in _MAG_REF[cls]]
        offs = _OFF_SQ if w == h else (_OFF_TALL if h > w else _OFF_WIDE)
        self.base_off, self.br_off = [], []
        for p in range(w * h):
            r, c = divmod(p, w)
            if cls == CLASS_2D:
                self.base_off.append(offs[min(r, 4)][min(c, 4)])
                self.br_off.append(0 if r == 0 and c == 0 else
                                   7 if r < 2 and c < 2 else 14)
            else:
                idx = r if cls == CLASS_VERT else c
                self.base_off.append(26 + 5 * min(idx, 2))
                self.br_off.append(0 if r == 0 and c == 0 else
                                   7 if idx == 0 else 14)


def _layout(w, h, cls):
    key = (w, h, cls)
    if key not in _LAYOUTS:
        _LAYOUTS[key] = _Layout(w, h, cls)
    return _LAYOUTS[key]


def decode_frame(fr: Frame, seq: Seq, refs: dict) -> list:
    """The reconstruction of a coded frame (not a show-existing one) as
    [y, u, v] at the frame size. refs: slot -> [y, u, v] planes of the
    frame held there; only the slots the frame refers to are read."""
    if fr.show_existing:
        raise ValueError("a show-existing frame codes no tile")
    t = _Tile(fr, seq, refs)
    t.decode()
    t.filters()
    h, w = fr.height, fr.width
    return [t.planes[0][:h, :w], t.planes[1][:(h + 1) >> 1, :(w + 1) >> 1],
            t.planes[2][:(h + 1) >> 1, :(w + 1) >> 1]]
