"""Intra and inter prediction (AV1 specification sections 7.11.2 and
7.11.3) in plain numpy. The directional predictor with its edge filter
and upsampling, and the tables, are a frozen copy of the port's plain
reference (`ops/ref/intra.py`, `ops/ref/mc.py`, held there against
libdav1d and libaom); the edge assembly, the non-directional
predictors, chroma from luma and the block prediction follow the
specification."""

from __future__ import annotations

import numpy as np


# spec Sm_Weights_Tx_* (smooth prediction weights by block dimension)
SM_WEIGHTS = {
    4: [255, 149, 85, 64],
    8: [255, 197, 146, 105, 73, 50, 37, 32],
    16: [255, 225, 196, 170, 145, 123, 102, 84, 68, 54, 43, 33, 26, 20, 17, 16],
    32: [255, 240, 225, 210, 196, 182, 169, 157, 145, 133, 122, 111, 101, 92,
         83, 74, 66, 59, 52, 45, 39, 34, 29, 25, 21, 17, 14, 12, 10, 9, 8, 8],
    64: [255, 248, 240, 233, 225, 218, 210, 203, 196, 189, 182, 176, 169, 163,
         156, 150, 144, 138, 133, 127, 121, 116, 111, 106, 101, 96, 91, 86,
         82, 77, 73, 69, 65, 61, 57, 54, 50, 47, 44, 41, 38, 35, 32, 29, 27,
         25, 22, 20, 18, 16, 15, 13, 12, 10, 9, 8, 7, 6, 6, 5, 5, 4, 4, 4],
}


# spec Dr_Intra_Derivative (sparse, by prediction angle; 64*cot(angle)
# rounded). Verified against libdav1d's packed copy (.rodata@67137).
DR_INTRA_DERIVATIVE = {
    3: 1023, 6: 547, 9: 372, 14: 273, 17: 215, 20: 178, 23: 151,
    26: 132, 29: 116, 32: 102, 36: 90, 39: 80, 42: 71, 45: 64,
    48: 57, 51: 51, 54: 45, 58: 40, 61: 35, 64: 31, 67: 27, 70: 23,
    73: 19, 76: 15, 81: 11, 84: 7, 87: 3,
}


INTRA_EDGE_KERNELS = ((0, 4, 8, 4, 0), (0, 5, 6, 5, 0),
                      (2, 4, 4, 4, 2))


def intra_edge_filter_strength(w: int, h: int, filter_type: int,
                               delta: int) -> int:
    """Spec 7.11.2.9 Intra_Edge_Filter_Strength."""
    d = abs(delta)
    blk_wh = w + h
    strength = 0
    if filter_type == 0:
        if blk_wh <= 8:
            if d >= 56:
                strength = 1
        elif blk_wh <= 12:
            if d >= 40:
                strength = 1
        elif blk_wh <= 16:
            if d >= 40:
                strength = 1
        elif blk_wh <= 24:
            if d >= 8:
                strength = 1
            if d >= 16:
                strength = 2
            if d >= 32:
                strength = 3
        elif blk_wh <= 32:
            strength = 1
            if d >= 4:
                strength = 2
            if d >= 32:
                strength = 3
        else:
            strength = 3
    else:
        if blk_wh <= 8:
            if d >= 40:
                strength = 1
            if d >= 64:
                strength = 2
        elif blk_wh <= 16:
            if d >= 20:
                strength = 1
            if d >= 48:
                strength = 2
        elif blk_wh <= 24:
            if d >= 4:
                strength = 3
        else:
            strength = 3
    return strength


def use_intra_edge_upsample(w: int, h: int, filter_type: int,
                            delta: int) -> bool:
    """Spec 7.11.2.10 Use_Intra_Edge_Upsample."""
    d = abs(delta)
    blk_wh = w + h
    if d <= 0 or d >= 40:
        return False
    return blk_wh <= 16 if filter_type == 0 else blk_wh <= 8


def _filter_edge(buf: np.ndarray, sz: int, strength: int):
    """Spec 7.11.2.12 intra_edge_filter on `buf` where buf[0] holds
    edge position -1 (the corner); writes positions 0..sz-2 in place."""
    if strength == 0 or sz <= 1:
        return
    kern = INTRA_EDGE_KERNELS[strength - 1]
    edge = buf[:sz].copy()
    for i in range(1, sz):
        t = 0
        for j in range(5):
            k = min(max(i - 2 + j, 0), sz - 1)
            t += kern[j] * int(edge[k])
        buf[i] = (t + 8) >> 4


def _upsample_edge(buf: np.ndarray, num_px: int, bd: int) -> np.ndarray:
    """Intra edge upsampling (spec 7.11.2.14 semantics, oracle-
    verified): `buf[0]` is edge position -1 and buf[1..num_px] the
    num_px edge samples. Returns the half-pel edge where the original
    sample k sits at index 2k+2 (so upsampled position -2 == the old
    corner) and odd indices hold the (-1, 9, 9, -1)/16 interpolation
    between neighbors."""
    # op[k + 2] = orig[k] for k in -2..num_px+1 (edge-replicated)
    op = np.empty(num_px + 4, np.int64)
    op[0] = buf[0]
    op[1] = buf[0]
    op[2: num_px + 2] = buf[1: num_px + 1]
    op[num_px + 2] = buf[num_px]
    op[num_px + 3] = buf[num_px]
    out = np.empty(2 * num_px + 1, np.int64)
    mx = (1 << bd) - 1
    for k in range(-1, num_px):
        out[2 * k + 2] = op[k + 2]
    for k in range(-1, num_px - 1):
        sv = (-op[k + 1] + 9 * op[k + 2] + 9 * op[k + 3]
              - op[k + 4])
        out[2 * k + 3] = min(max((sv + 8) >> 4, 0), mx)
    return out


def predict_directional(p_angle: int, w: int, h: int, above: np.ndarray,
                        left: np.ndarray, top_left: int,
                        bd: int = 8, edge_filter: bool = False,
                        filter_type: int = 0,
                        have_above: bool = True, have_left: bool = True,
                        n_above: int | None = None,
                        n_left: int | None = None) -> np.ndarray:
    """Spec 7.11.2.4 directional prediction with the optional intra
    edge filter + upsampling (seq.enable_intra_edge_filter).

    above/left hold w+h entries (replicated per the edge fill rules);
    n_above/n_left are the counts of in-frame pixels along each edge
    (spec MaxX/MaxY clamps for the filter extents)."""
    AR = np.empty(w + h + 1, np.int64)
    AR[0] = top_left
    AR[1:] = above[: w + h]
    LC = np.empty(w + h + 1, np.int64)
    LC[0] = top_left
    LC[1:] = left[: w + h]
    up_a = up_l = 0
    if edge_filter:
        if p_angle != 90 and p_angle != 180:
            if 90 < p_angle < 180 and (w + h) >= 24:
                corner = (int(LC[1]) * 5 + int(AR[0]) * 6
                          + int(AR[1]) * 5 + 8) >> 4
                AR[0] = corner
                LC[0] = corner
            if have_above:
                strength = intra_edge_filter_strength(
                    w, h, filter_type, p_angle - 90)
                num_px = (min(w, n_above if n_above is not None else w)
                          + (h if p_angle < 90 else 0) + 1)
                _filter_edge(AR, num_px, strength)
            if have_left:
                strength = intra_edge_filter_strength(
                    w, h, filter_type, p_angle - 180)
                num_px = (min(h, n_left if n_left is not None else h)
                          + (w if p_angle > 180 else 0) + 1)
                _filter_edge(LC, num_px, strength)
        if use_intra_edge_upsample(w, h, filter_type, p_angle - 90):
            up_a = 1
            AR = _upsample_edge(AR, w + (h if p_angle < 90 else 0), bd)
        if use_intra_edge_upsample(w, h, filter_type, p_angle - 180):
            up_l = 1
            LC = _upsample_edge(LC, h + (w if p_angle > 180 else 0), bd)
    off_a = 1 << up_a
    off_l = 1 << up_l
    ii = np.arange(h)[:, None]
    jj = np.arange(w)[None, :]
    if p_angle < 90:
        dx = DR_INTRA_DERIVATIVE[p_angle]
        idx = (ii + 1) * dx
        base = (idx >> (6 - up_a)) + (jj << up_a)
        shift = ((idx << up_a) >> 1) & 31
        max_base = (w + h - 1) << up_a
        b0 = np.minimum(base, max_base) + off_a
        b1 = np.minimum(base + 1, max_base) + off_a
        out = (AR[b0] * (32 - shift) + AR[b1] * shift + 16) >> 5
        return np.where(base > max_base, AR[max_base + off_a],
                        out).astype(np.int32)
    if p_angle > 180:
        dy = DR_INTRA_DERIVATIVE[270 - p_angle]
        idx = (jj + 1) * dy
        base = (idx >> (6 - up_l)) + (ii << up_l)
        shift = ((idx << up_l) >> 1) & 31
        max_base = (w + h - 1) << up_l
        b0 = np.minimum(base, max_base) + off_l
        b1 = np.minimum(base + 1, max_base) + off_l
        out = (LC[b0] * (32 - shift) + LC[b1] * shift + 16) >> 5
        return np.where(base > max_base, LC[max_base + off_l],
                        out).astype(np.int32)
    if p_angle == 90:
        return np.tile(AR[off_a: off_a + w].astype(np.int32), (h, 1))
    if p_angle == 180:
        return np.tile(LC[off_l: off_l + h].astype(np.int32)[:, None],
                       (1, w))
    # zone 2: 90 < p_angle < 180, both edges + the (filtered) corner
    dx = DR_INTRA_DERIVATIVE.get(180 - p_angle, 0)
    dy = DR_INTRA_DERIVATIVE.get(p_angle - 90, 0)
    idx_a = (jj << 6) - (ii + 1) * dx
    base_a = idx_a >> (6 - up_a)
    use_a = base_a >= -(1 << up_a)
    shift_a = ((idx_a << up_a) >> 1) & 31
    hi_a = (w << up_a)
    ba0 = np.clip(base_a, -off_a, hi_a - 1) + off_a
    ba1 = np.clip(base_a + 1, -off_a, hi_a) + off_a
    ba1 = np.minimum(ba1, len(AR) - 1)
    out_a = (AR[ba0] * (32 - shift_a) + AR[ba1] * shift_a + 16) >> 5
    idx_l = (ii << 6) - (jj + 1) * dy
    base_l = idx_l >> (6 - up_l)
    shift_l = ((idx_l << up_l) >> 1) & 31
    hi_l = (h << up_l)
    bl0 = np.clip(base_l, -off_l, hi_l - 1) + off_l
    bl1 = np.clip(base_l + 1, -off_l, hi_l) + off_l
    bl1 = np.minimum(bl1, len(LC) - 1)
    out_l = (LC[bl0] * (32 - shift_l) + LC[bl1] * shift_l + 16) >> 5
    return np.where(use_a, out_a, out_l).astype(np.int32)



FILTER_BITS = 7
SUBPEL_FILTERS = {
    "REGULAR": np.array([
        [0, 0, 0, 128, 0, 0, 0, 0],
        [0, 2, -6, 126, 8, -2, 0, 0],
        [0, 2, -10, 122, 18, -4, 0, 0],
        [0, 2, -12, 116, 28, -8, 2, 0],
        [0, 2, -14, 110, 38, -10, 2, 0],
        [0, 2, -14, 102, 48, -12, 2, 0],
        [0, 2, -16, 94, 58, -12, 2, 0],
        [0, 2, -14, 84, 66, -12, 2, 0],
        [0, 2, -14, 76, 76, -14, 2, 0],
        [0, 2, -12, 66, 84, -14, 2, 0],
        [0, 2, -12, 58, 94, -16, 2, 0],
        [0, 2, -12, 48, 102, -14, 2, 0],
        [0, 2, -10, 38, 110, -14, 2, 0],
        [0, 2, -8, 28, 116, -12, 2, 0],
        [0, 0, -4, 18, 122, -10, 2, 0],
        [0, 0, -2, 8, 126, -6, 2, 0],
    ], np.int32),
    "REGULAR_4": np.array([
        [0, 0, 0, 128, 0, 0, 0, 0],
        [0, 0, -4, 126, 8, -2, 0, 0],
        [0, 0, -8, 122, 18, -4, 0, 0],
        [0, 0, -10, 116, 28, -6, 0, 0],
        [0, 0, -12, 110, 38, -8, 0, 0],
        [0, 0, -12, 102, 48, -10, 0, 0],
        [0, 0, -14, 94, 58, -10, 0, 0],
        [0, 0, -12, 84, 66, -10, 0, 0],
        [0, 0, -12, 76, 76, -12, 0, 0],
        [0, 0, -10, 66, 84, -12, 0, 0],
        [0, 0, -10, 58, 94, -14, 0, 0],
        [0, 0, -10, 48, 102, -12, 0, 0],
        [0, 0, -8, 38, 110, -12, 0, 0],
        [0, 0, -6, 28, 116, -10, 0, 0],
        [0, 0, -4, 18, 122, -8, 0, 0],
        [0, 0, -2, 8, 126, -4, 0, 0],
    ], np.int32),
}


def intra_edges(plane: np.ndarray, x: int, y: int, w: int, h: int,
                have_left: bool, have_above: bool, have_above_rt: bool,
                have_below_lt: bool, max_x: int, max_y: int, bd: int):
    """AboveRow[0..w+h-1], LeftCol[0..w+h-1] and AboveRow[-1] as the
    specification assembles them from the current frame."""
    n = w + h
    if have_above:
        lim = min(max_x, x + (2 * w if have_above_rt else w) - 1)
        above = plane[y - 1, np.minimum(lim, x + np.arange(n))]
    elif have_left:
        above = np.full(n, plane[y, x - 1])
    else:
        above = np.full(n, (1 << (bd - 1)) - 1)
    if have_left:
        lim = min(max_y, y + (2 * h if have_below_lt else h) - 1)
        left = plane[np.minimum(lim, y + np.arange(n)), x - 1]
    elif have_above:
        left = np.full(n, plane[y - 1, x])
    else:
        left = np.full(n, (1 << (bd - 1)) + 1)
    if have_above and have_left:
        corner = plane[y - 1, x - 1]
    elif have_above:
        corner = plane[y - 1, x]
    elif have_left:
        corner = plane[y, x - 1]
    else:
        corner = 1 << (bd - 1)
    return above.astype(np.int64), left.astype(np.int64), int(corner)


MODE_ANGLE = {1: 90, 2: 180, 3: 45, 4: 135, 5: 113, 6: 157, 7: 203,
              8: 67}
DC, SMOOTH, SMOOTH_V, SMOOTH_H, PAETH = 0, 9, 10, 11, 12


def predict_intra(mode: int, angle_delta: int, w: int, h: int, above,
                  left, corner: int, have_left: bool, have_above: bool,
                  n_above: int, n_left: int, bd: int, edge_filter: bool,
                  filter_type: int) -> np.ndarray:
    """The h x w prediction of one intra mode (specification 7.11.2)."""
    if mode in MODE_ANGLE:
        return predict_directional(
            MODE_ANGLE[mode] + 3 * angle_delta, w, h, above, left, corner,
            bd, edge_filter=edge_filter, filter_type=filter_type,
            have_above=have_above, have_left=have_left, n_above=n_above,
            n_left=n_left).astype(np.int64)
    a, l = above[:w], left[:h]
    if mode == DC:
        if have_above and have_left:
            avg = (int(a.sum()) + int(l.sum()) + ((w + h) >> 1)) // (w + h)
        elif have_left:
            avg = (int(l.sum()) + (h >> 1)) >> (h.bit_length() - 1)
        elif have_above:
            avg = (int(a.sum()) + (w >> 1)) >> (w.bit_length() - 1)
        else:
            avg = 1 << (bd - 1)
        return np.full((h, w), avg, np.int64)
    if mode == PAETH:
        base = a[None, :] + l[:, None] - corner
        p_left = np.abs(base - l[:, None])
        p_top = np.abs(base - a[None, :])
        p_tl = np.abs(base - corner)
        return np.where((p_left <= p_top) & (p_left <= p_tl),
                        np.broadcast_to(l[:, None], (h, w)),
                        np.where(p_top <= p_tl,
                                 np.broadcast_to(a[None, :], (h, w)),
                                 corner)).astype(np.int64)
    wy = np.array(SM_WEIGHTS[h], np.int64)[:, None]
    wx = np.array(SM_WEIGHTS[w], np.int64)[None, :]
    if mode == SMOOTH:
        s = (wy * a[None, :] + (256 - wy) * l[h - 1]
             + wx * l[:, None] + (256 - wx) * a[w - 1])
        return (s + 256) >> 9
    if mode == SMOOTH_V:
        return (wy * a[None, :] + (256 - wy) * l[h - 1] + 128) >> 8
    if mode == SMOOTH_H:
        return (wx * l[:, None] + (256 - wx) * a[w - 1] + 128) >> 8
    raise ValueError(f"intra mode {mode}")


def inter_block(ref: np.ndarray, x: int, y: int, w: int, h: int, mv,
                ssx: int, ssy: int, compound: bool, bd: int = 8):
    """block_inter_prediction without scaling (specification 7.11.3.4):
    the h x w prediction at plane position (x, y) of one reference plane,
    displaced by `mv` (row, col, in eighths of a luma sample); at the
    compound precision, or rounded to pixels when not compound."""
    r0 = 5 if bd == 12 else 3
    r1 = 7 if compound else (9 if bd == 12 else 11)
    last_y, last_x = ref.shape[0] - 1, ref.shape[1] - 1
    py = (y << 4) + ((2 * int(mv[0])) >> ssy)
    px = (x << 4) + ((2 * int(mv[1])) >> ssx)
    fh = SUBPEL_FILTERS["REGULAR_4" if w <= 4 else "REGULAR"][px & 15]
    fv = SUBPEL_FILTERS["REGULAR_4" if h <= 4 else "REGULAR"][py & 15]
    rows = np.clip(np.arange((py >> 4) - 3, (py >> 4) + h + 4), 0, last_y)
    cols = np.clip(np.arange((px >> 4) - 3, (px >> 4) + w + 4), 0, last_x)
    src = ref[np.ix_(rows, cols)].astype(np.int64)
    mid = sum(int(fh[t]) * src[:, t:t + w] for t in range(8))
    mid = (mid + (1 << (r0 - 1))) >> r0
    out = sum(int(fv[t]) * mid[t:t + h] for t in range(8))
    out = (out + (1 << (r1 - 1))) >> r1
    return out if compound else np.clip(out, 0, (1 << bd) - 1)


def compound_average(p0, p1, bd: int = 8):
    """COMPOUND_AVERAGE: Round2(p0 + p1, 1 + InterPostRound)."""
    post = 2 * FILTER_BITS - ((5 if bd == 12 else 3) + 7)
    s = 1 + post
    return np.clip((p0 + p1 + (1 << (s - 1))) >> s, 0, (1 << bd) - 1)
