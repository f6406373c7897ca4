"""CDEF: constrained directional enhancement filter (AV1 spec 7.15).

Reference parity: rav1e src/cdef.rs (cdef_analyze_superblock /
cdef_filter_superblock). The decoder derives the filter direction from
the pre-CDEF reconstruction, so the encoder must reproduce the whole
process bit-exactly; the decode oracles arbitrate every detail.

Scope: 64x64 CDEF units at 8, 10 and 12 bits. With cdef_bits = 0 the
per-SB index costs zero bits, so a uniform strength set needs only frame
header signaling plus this filter. The chroma blocks follow the chroma
sampling (cdef_filter_frame's ss_x / ss_y, with the spec's 4:2:2
direction map); the JAX package's copy filters chroma as 4:2:0 at every
sampling, which decoders do not (ROADMAP.md section 3).
"""

from __future__ import annotations

import numpy as np

# spec Cdef_Directions[dir][k] -> (dy, dx)
CDEF_DIRECTIONS = [
    [(-1, 1), (-2, 2)],
    [(0, 1), (-1, 2)],
    [(0, 1), (0, 2)],
    [(0, 1), (1, 2)],
    [(1, 1), (2, 2)],
    [(1, 0), (2, 1)],
    [(1, 0), (2, 0)],
    [(1, 0), (2, -1)],
]

# the chroma direction of a 4:2:2 block from its luma direction (the
# spec's Cdef_Uv_Dir; dav1d's uv_dirs[1])
UV_DIR_422 = [7, 0, 2, 4, 5, 6, 6, 6]

PRI_TAPS = [[4, 2], [3, 3]]   # [pri_strength & 1][k]
SEC_TAPS = [2, 1]

# 840 / count, indexed by bin pixel count
DIV_TABLE = [0, 840, 420, 280, 210, 168, 140, 120, 105]

LARGE = 1 << 14  # out-of-frame sentinel (unavailable pixels)


def cdef_strengths_for_q(qindex: int):
    """Heuristic uniform strength set (None = leave CDEF off).

    Without per-SB strength RDO (rav1e rdo_loop_decision), CDEF only
    pays off at higher quantizers where ringing dominates."""
    if qindex < 120:
        return None
    y_pri = min(15, max(1, qindex // 48))
    y_sec = 2 if qindex >= 180 else 1
    uv_pri = max(0, y_pri - 1)
    uv_sec = max(0, y_sec - 1)
    damping = 3 + (qindex >= 64) + (qindex >= 160)
    return (y_pri, y_sec, uv_pri, uv_sec, damping)


def cdef_direction(block8: np.ndarray, bd: int = 8) -> tuple[int, int]:
    """Spec 7.15.2: 8-direction search on one 8x8 block of the
    pre-CDEF recon. Returns (dir, var)."""
    x = (block8.astype(np.int64) >> (bd - 8)) - 128
    ii = np.arange(8)[:, None] + np.zeros(8, np.int64)[None, :]
    jj = np.zeros(8, np.int64)[:, None] + np.arange(8)[None, :]
    bins = [
        ii + jj,
        ii + (jj >> 1),
        ii,
        3 + ii - (jj >> 1),
        7 + ii - jj,
        3 - (ii >> 1) + jj,
        jj,
        (ii >> 1) + jj,
    ]
    cost = np.zeros(8, np.int64)
    for d in range(8):
        b = bins[d].ravel()
        n = int(b.max()) + 1
        part = np.zeros(n, np.int64)
        cnt = np.zeros(n, np.int64)
        np.add.at(part, b, x.ravel())
        np.add.at(cnt, b, 1)
        cost[d] = int(np.sum(part * part
                             * np.asarray(DIV_TABLE)[cnt]))
    best = int(np.argmax(cost))
    var = int((cost[best] - cost[(best + 4) % 8]) >> 10)
    return best, var


def constrain(diff, strength: int, damping: int):
    """Spec Constrain(): sign * min(|d|, max(0, S - (|d| >> adj)))."""
    if strength == 0:
        return np.zeros_like(np.asarray(diff))
    adj = max(0, damping - (strength.bit_length() - 1))
    a = np.abs(diff)
    lim = np.maximum(0, strength - (a >> adj))
    return np.sign(diff) * np.minimum(a, lim)


def cdef_filter_block(padded: np.ndarray, py: int, px: int, n: int,
                      pri: int, sec: int, damping: int, direction: int,
                      var: int, is_luma: bool, bd: int = 8,
                      nw: int | None = None) -> np.ndarray:
    """Filter one n x nw block (nw None: n). `padded` holds the pre-CDEF
    plane padded by >= 2 px with the LARGE sentinel; (py, px) is the
    block origin in padded coordinates. Returns the filtered block."""
    nw = n if nw is None else nw
    x = padded[py: py + n, px: px + nw].astype(np.int64)
    if is_luma and pri:
        # spec: luma primary strength scales with direction variance;
        # flat blocks (var == 0) get no primary filtering
        if var:
            vs = (min((var >> 6).bit_length() - 1, 12)
                  if (var >> 6) else 0)
            pri_adj = (pri * (4 + vs) + 8) >> 4
        else:
            pri_adj = 0
    else:
        pri_adj = pri
    # plane damping: CdefDamping (luma) / CdefDamping-1 (chroma), used
    # by both primary and secondary constrain (oracle-fitted)
    pdamp = damping if is_luma else damping - 1
    sdamp = pdamp
    # tap weights follow the (variance-adjusted) strength parity
    taps = PRI_TAPS[(pri_adj >> (bd - 8)) & 1]
    out = np.zeros((n, nw), np.int64)
    mx = x.copy()
    mn = x.copy()

    def tap(dy, dx, t, strength, damp):
        nonlocal out, mx, mn
        p = padded[py + dy: py + dy + n, px + dx: px + dx + nw] \
            .astype(np.int64)
        valid = p != LARGE
        out = out + np.where(valid,
                             t * constrain(p - x, strength, damp), 0)
        mx = np.where(valid, np.maximum(mx, p), mx)
        mn = np.where(valid, np.minimum(mn, p), mn)

    if pri_adj:
        for k in range(2):
            dy, dx = CDEF_DIRECTIONS[direction][k]
            tap(dy, dx, taps[k], pri_adj, pdamp)
            tap(-dy, -dx, taps[k], pri_adj, pdamp)
    if sec:
        for k in range(2):
            for d2 in ((direction + 2) & 7, (direction - 2) & 7):
                dy, dx = CDEF_DIRECTIONS[d2][k]
                tap(dy, dx, SEC_TAPS[k], sec, sdamp)
                tap(-dy, -dx, SEC_TAPS[k], sec, sdamp)
    y = x + ((8 + out - (out < 0)) >> 4)
    return np.clip(y, mn, mx).astype(np.int32)


def cdef_filter_frame(planes, skip_8x8: np.ndarray, y_pri: int,
                      y_sec: int, uv_pri: int, uv_sec: int,
                      damping: int, bd: int = 8, ss_x: int = 1,
                      ss_y: int = 1):
    """Apply CDEF to reconstruction planes in place.

    planes: [y, u, v] int32 (post-deblock recon). skip_8x8: bool
    [h/8, w/8], True where ALL coded blocks covering that luma 8x8 are
    skip (such blocks are not filtered). ss_x / ss_y: the chroma
    subsampling; a luma 8x8 block's chroma block is (8 >> ss_y) x
    (8 >> ss_x), at 4:2:2 filtered along UV_DIR_422's direction."""
    # spec 7.15.3 CoeffShift: the 8-bit-scale header strengths scale
    # by << shift and the damping by + shift above 8-bit
    shift = bd - 8
    y_pri <<= shift
    y_sec <<= shift
    uv_pri <<= shift
    uv_sec <<= shift
    damping += shift
    y = planes[0]
    h, w = y.shape
    pad = 3
    py = np.full((h + 2 * pad, w + 2 * pad), LARGE, np.int32)
    py[pad:-pad, pad:-pad] = y
    pu = pv = None
    if len(planes) > 1:
        u, v = planes[1], planes[2]
        ch, cw = u.shape
        pu = np.full((ch + 2 * pad, cw + 2 * pad), LARGE, np.int32)
        pu[pad:-pad, pad:-pad] = u
        pv = np.full((ch + 2 * pad, cw + 2 * pad), LARGE, np.int32)
        pv[pad:-pad, pad:-pad] = v
    n8y, n8x = h // 8, w // 8
    for by in range(n8y):
        for bx in range(n8x):
            if skip_8x8[by, bx]:
                continue
            blk = y[by * 8: by * 8 + 8, bx * 8: bx * 8 + 8]
            d, var = cdef_direction(blk, bd)
            # spec: a plane with zero primary strength filters its
            # secondary taps around direction 0
            if y_pri or y_sec:
                dy_ = d if y_pri else 0
                planes[0][by * 8:by * 8 + 8, bx * 8:bx * 8 + 8] = \
                    cdef_filter_block(py, by * 8 + pad, bx * 8 + pad, 8,
                                      y_pri, y_sec, damping, dy_, var,
                                      True, bd)
            if pu is not None and (uv_pri or uv_sec):
                duv = d if uv_pri else 0
                if ss_x != ss_y:
                    duv = UV_DIR_422[duv] if uv_pri else 0
                ch, cw = 8 >> ss_y, 8 >> ss_x
                cy, cx = by * ch, bx * cw
                for pl, pp in ((planes[1], pu), (planes[2], pv)):
                    pl[cy:cy + ch, cx:cx + cw] = cdef_filter_block(
                        pp, cy + pad, cx + pad, ch, uv_pri, uv_sec,
                        damping, duv, 0, False, bd, nw=cw)
    return planes
