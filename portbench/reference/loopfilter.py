"""The in-loop filters of the AV1 specification in plain numpy: the
deblocking filter (section 7.14) over the transform edges of the whole
frame, and CDEF (section 7.15) over its 8x8 blocks. The per-edge sample
filters (`_thresholds`, `_filter_edge`) are a frozen copy of the port's
plain reference (`ops/ref/deblock.py`, held there against libdav1d and
libaom); which edges are filtered, at what length, and all of CDEF follow
the specification. Every edge of one pass, and every block of CDEF,
reads the frame as the previous stage left it, so each stage is one
vectorised step."""

from __future__ import annotations

import numpy as np


def _thresholds(level: int, sharpness: int = 0):
    shift = 2 if sharpness > 4 else (1 if sharpness > 0 else 0)
    if sharpness > 0:
        limit = np.clip(level >> shift, 1, 9 - sharpness)
    else:
        limit = max(1, level)
    blimit = 2 * (level + 2) + limit
    thresh = level >> 4
    return int(limit), int(blimit), int(thresh)


def _filter_edge(p, q, limit, blimit, thresh, size, bd=8, row_mask=None):
    """Filter one edge. p: [...,: n] samples left/above of the edge in
    reverse order isn't used; layout: p[:, i] = p_i (p0 nearest edge),
    q[:, i] = q_i. Returns new (p, q) (modified up to taps)."""
    F = 1 << (bd - 8)
    # spec 7.14.6.2: the level-derived thresholds scale with bit depth
    limit, blimit, thresh = limit * F, blimit * F, thresh * F
    p = p.astype(np.int32)
    q = q.astype(np.int32)
    p0, p1 = p[:, 0], p[:, 1]
    q0, q1 = q[:, 0], q[:, 1]
    fmask = ((np.abs(p1 - p0) <= limit) & (np.abs(q1 - q0) <= limit)
             & (np.abs(p0 - q0) * 2 + np.abs(p1 - q1) // 2 <= blimit))
    if row_mask is not None:
        fmask = fmask & row_mask
    if size >= 6:
        p2, q2 = p[:, 2], q[:, 2]
        fmask &= (np.abs(p2 - p1) <= limit) & (np.abs(q2 - q1) <= limit)
    if size >= 8:
        p3, q3 = p[:, 3], q[:, 3]
        fmask &= (np.abs(p3 - p2) <= limit) & (np.abs(q3 - q2) <= limit)
    hev = (np.abs(p1 - p0) > thresh) | (np.abs(q1 - q0) > thresh)

    out_p = p.copy()
    out_q = q.copy()

    # narrow filter (4): signed arithmetic with char-range clamps
    # (libaom filter4 / spec 7.14.6.3)
    off = 0x80 * F
    lo, hi = -128 * F, 128 * F - 1

    def c3(x):
        return np.clip(x, lo, hi)

    ps1, ps0 = p1 - off, p0 - off
    qs0, qs1 = q0 - off, q1 - off
    fil = np.where(hev, c3(ps1 - qs1), 0)
    fil = c3(fil + 3 * (qs0 - ps0))
    f1 = c3(fil + 4) >> 3
    f2 = c3(fil + 3) >> 3
    n_q0 = c3(qs0 - f1) + off
    n_p0 = c3(ps0 + f2) + off
    f3 = (f1 + 1) >> 1
    n_q1 = c3(qs1 - f3) + off
    n_p1 = c3(ps1 + f3) + off

    def r3(x):
        return (x + 4) >> 3

    def r4(x):
        return (x + 8) >> 4

    if size == 4:
        sel4 = fmask
        out_p[:, 0] = np.where(sel4, n_p0, p0)
        out_p[:, 1] = np.where(sel4 & ~hev, n_p1, p1)
        out_q[:, 0] = np.where(sel4, n_q0, q0)
        out_q[:, 1] = np.where(sel4 & ~hev, n_q1, q1)
        return out_p, out_q

    if size == 6:
        p2, q2 = p[:, 2], q[:, 2]
        flat = (np.maximum.reduce([np.abs(p1 - p0), np.abs(q1 - q0),
                                   np.abs(p2 - p0), np.abs(q2 - q0)])
                <= F)
        w_p1 = r3(p2 * 3 + p1 * 2 + p0 * 2 + q0)
        w_p0 = r3(p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1)
        w_q0 = r3(p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2)
        w_q1 = r3(p0 + q0 * 2 + q1 * 2 + q2 * 3)
        selw = fmask & flat
        sel4 = fmask & ~flat
        out_p[:, 0] = np.where(selw, w_p0, np.where(sel4, n_p0, p0))
        out_p[:, 1] = np.where(selw, w_p1,
                               np.where(sel4 & ~hev, n_p1, p1))
        out_q[:, 0] = np.where(selw, w_q0, np.where(sel4, n_q0, q0))
        out_q[:, 1] = np.where(selw, w_q1,
                               np.where(sel4 & ~hev, n_q1, q1))
        return out_p, out_q

    p2, p3 = p[:, 2], p[:, 3]
    q2, q3 = q[:, 2], q[:, 3]
    flat = (np.maximum.reduce([
        np.abs(p1 - p0), np.abs(q1 - q0), np.abs(p2 - p0),
        np.abs(q2 - q0), np.abs(p3 - p0), np.abs(q3 - q0)]) <= F)
    # 8-tap outputs
    e_p2 = r3(p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0)
    e_p1 = r3(p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1)
    e_p0 = r3(p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2)
    e_q0 = r3(p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3)
    e_q1 = r3(p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3)
    e_q2 = r3(p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3)

    if size == 8:
        selw = fmask & flat
        sel4 = fmask & ~flat
        out_p[:, 2] = np.where(selw, e_p2, p2)
        out_p[:, 1] = np.where(selw, e_p1,
                               np.where(sel4 & ~hev, n_p1, p1))
        out_p[:, 0] = np.where(selw, e_p0, np.where(sel4, n_p0, p0))
        out_q[:, 0] = np.where(selw, e_q0, np.where(sel4, n_q0, q0))
        out_q[:, 1] = np.where(selw, e_q1,
                               np.where(sel4 & ~hev, n_q1, q1))
        out_q[:, 2] = np.where(selw, e_q2, q2)
        return out_p, out_q

    assert size == 14
    p4, p5, p6 = p[:, 4], p[:, 5], p[:, 6]
    q4, q5, q6 = q[:, 4], q[:, 5], q[:, 6]
    flat2 = (np.maximum.reduce([
        np.abs(p4 - p0), np.abs(q4 - q0), np.abs(p5 - p0),
        np.abs(q5 - q0), np.abs(p6 - p0), np.abs(q6 - q0)]) <= F)
    # 13-tap wide filter, weights sum to 16 (dav1d lf wd16)
    w_p5 = r4(p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0)
    w_p4 = r4(p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0 + q0 + q1)
    w_p3 = r4(p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0 + q0 + q1
              + q2)
    w_p2 = r4(p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0 + q0 + q1
              + q2 + q3)
    w_p1 = r4(p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2 + q0 + q1
              + q2 + q3 + q4)
    w_p0 = r4(p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + q2
              + q3 + q4 + q5)
    w_q0 = r4(q6 + q5 + q4 + q3 + q2 + q1 * 2 + q0 * 2 + p0 * 2 + p1 + p2
              + p3 + p4 + p5)
    w_q1 = r4(q6 * 2 + q5 + q4 + q3 + q2 * 2 + q1 * 2 + q0 * 2 + p0 + p1
              + p2 + p3 + p4)
    w_q2 = r4(q6 * 3 + q5 + q4 + q3 * 2 + q2 * 2 + q1 * 2 + q0 + p0 + p1
              + p2 + p3)
    w_q3 = r4(q6 * 4 + q5 + q4 * 2 + q3 * 2 + q2 * 2 + q1 + q0 + p0 + p1
              + p2)
    w_q4 = r4(q6 * 5 + q5 * 2 + q4 * 2 + q3 * 2 + q2 + q1 + q0 + p0 + p1)
    w_q5 = r4(q6 * 7 + q5 * 2 + q4 * 2 + q3 + q2 + q1 + q0 + p0)

    sel14 = fmask & flat & flat2
    sel8 = fmask & flat & ~flat2
    sel4 = fmask & ~flat
    for i, (w14, e8, orig) in enumerate([
            (w_p0, e_p0, p0), (w_p1, e_p1, p1), (w_p2, e_p2, p2)]):
        out_p[:, i] = np.where(sel14, w14, np.where(sel8, e8, orig))
    out_p[:, 3] = np.where(sel14, w_p3, p3)
    out_p[:, 4] = np.where(sel14, w_p4, p4)
    out_p[:, 5] = np.where(sel14, w_p5, p5)
    for i, (w14, e8, orig) in enumerate([
            (w_q0, e_q0, q0), (w_q1, e_q1, q1), (w_q2, e_q2, q2)]):
        out_q[:, i] = np.where(sel14, w14, np.where(sel8, e8, orig))
    out_q[:, 3] = np.where(sel14, w_q3, q3)
    out_q[:, 4] = np.where(sel14, w_q4, q4)
    out_q[:, 5] = np.where(sel14, w_q5, q5)
    # narrow fallback for non-flat rows
    out_p[:, 0] = np.where(sel4, n_p0, out_p[:, 0])
    out_p[:, 1] = np.where(sel4 & ~hev, n_p1, out_p[:, 1])
    out_q[:, 0] = np.where(sel4, n_q0, out_q[:, 0])
    out_q[:, 1] = np.where(sel4 & ~hev, n_q1, out_q[:, 1])
    return out_p, out_q



# samples read on each side of an edge by each filter length
NREAD = {4: 2, 6: 3, 8: 4, 14: 7}


def deblock(planes, info, frame_w: int, frame_h: int, ssx: int, ssy: int,
            levels, sharpness: int, bd: int = 8):
    """Filter `planes` (int64, padded; changed in place). `info` holds the
    per-MI grids `bw4`, `bh4`, `skip`, `is_inter` and, per plane, the
    transform width and height over each 4x4 unit (`txw`, `txh`)."""
    for p in range(3):
        sx, sy = (ssx, ssy) if p else (0, 0)
        for pss in (0, 1):
            lvl = levels[pss] if p == 0 else levels[1 + p]
            if lvl == 0:
                continue
            _deblock_pass(planes[p], info, p, pss, sx, sy, frame_w,
                          frame_h, _thresholds(lvl, sharpness), bd)


def _deblock_pass(pl, info, p, pss, sx, sy, frame_w, frame_h, thr, bd):
    txw, txh = info["txw"][p], info["txh"][p]
    rows4 = (info["mi_rows"] + sy) >> sy
    cols4 = (info["mi_cols"] + sx) >> sx
    i = np.arange(rows4)[:, None]
    j = np.arange(cols4)[None, :]
    mr = np.minimum((i << sy) | sy, info["mi_rows"] - 1)
    mc = np.minimum((j << sx) | sx, info["mi_cols"] - 1)
    skip = info["skip"][mr, mc].astype(bool)
    intra = ~info["is_inter"][mr, mc].astype(bool)
    on = ((i << sy) * 4 < frame_h) & ((j << sx) * 4 < frame_w)
    if pss == 0:
        cur, prev = txw[:rows4, :cols4], np.roll(txw[:rows4, :cols4], 1, 1)
        bsz = np.maximum((info["bw4"][mr, mc] * 4) >> sx, 4)
        pos = j * 4
        on &= j > 0
    else:
        cur, prev = txh[:rows4, :cols4], np.roll(txh[:rows4, :cols4], 1, 0)
        bsz = np.maximum((info["bh4"][mr, mc] * 4) >> sy, 4)
        pos = i * 4
        on &= i > 0
    tx_edge = pos % cur == 0
    blk_edge = pos % bsz == 0
    apply = on & tx_edge & (blk_edge | ~skip | intra)
    size = np.minimum(np.minimum(cur, prev), 16 if p == 0 else 8)
    out = pl.copy()
    lim = {4: 4, 8: 8 if p == 0 else 6, 16: 14}
    for s in (4, 8, 16):
        ui, uj = np.nonzero(apply & (size == s))
        if not len(ui):
            continue
        n = NREAD[lim[s]]
        k = np.arange(4)
        if pss == 0:
            ys = (ui[:, None] * 4 + k).ravel()
            xs = np.repeat(uj * 4, 4)
            pcols = xs[:, None] - 1 - np.arange(n)
            qcols = xs[:, None] + np.arange(n)
            pv = pl[ys[:, None], pcols]
            qv = pl[ys[:, None], qcols]
        else:
            xs = (uj[:, None] * 4 + k).ravel()
            ys = np.repeat(ui * 4, 4)
            pv = pl[ys[:, None] - 1 - np.arange(n), xs[:, None]]
            qv = pl[ys[:, None] + np.arange(n), xs[:, None]]
        np_, nq = _filter_edge(pv, qv, *thr, lim[s], bd)
        if pss == 0:
            out[ys[:, None], pcols] = np_
            out[ys[:, None], qcols] = nq
        else:
            out[ys[:, None] - 1 - np.arange(n), xs[:, None]] = np_
            out[ys[:, None] + np.arange(n), xs[:, None]] = nq
    pl[...] = out


# CDEF (specification 7.15)
CDEF_DIRECTIONS = np.array([
    [(-1, 1), (-2, 2)], [(0, 1), (-1, 2)], [(0, 1), (0, 2)],
    [(0, 1), (1, 2)], [(1, 1), (2, 2)], [(1, 0), (2, 1)],
    [(1, 0), (2, 0)], [(1, 0), (2, -1)]], np.int64)
PRI_TAPS = np.array([[4, 2], [3, 3]], np.int64)
SEC_TAPS = np.array([2, 1], np.int64)
DIV_TABLE = np.array([0, 840, 420, 280, 210, 168, 140, 120, 105], np.int64)


def _direction_bins():
    ii, jj = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    bins = [ii + jj, ii + (jj >> 1), ii, 3 + ii - (jj >> 1), 7 + ii - jj,
            3 - (ii >> 1) + jj, jj, (ii >> 1) + jj]
    out = []
    for b in bins:
        b = b.ravel()
        onehot = np.zeros((64, 15), np.int64)
        onehot[np.arange(64), b] = 1
        out.append((onehot, DIV_TABLE[np.minimum(onehot.sum(0), 8)]))
    return out


_BINS = _direction_bins()


def cdef_directions(luma, ys, xs, bd: int = 8):
    """(direction, variance) of the 8x8 luma blocks at (ys, xs)."""
    k = np.arange(8)
    blk = luma[ys[:, None, None] + k[:, None], xs[:, None, None] + k]
    x = (blk.reshape(len(ys), 64) >> (bd - 8)) - 128
    cost = np.stack([((x @ oh) ** 2 * w).sum(1) for oh, w in _BINS], 1)
    best = np.argmax(cost, 1)
    var = (cost[np.arange(len(ys)), best]
           - cost[np.arange(len(ys)), (best + 4) & 7]) >> 10
    return best, var


def _floor_log2(v):
    return np.where(v > 0, np.frexp(np.maximum(v, 1))[1] - 1, 0)


def _constrain(diff, strength, damping):
    adj = np.maximum(0, damping - _floor_log2(strength))
    a = np.abs(diff)
    val = np.minimum(a, np.maximum(0, strength - (a >> adj)))
    return np.where(strength == 0, 0, np.sign(diff) * val)


def cdef(planes, skip, cdef_idx, strengths, damping: int, mi_rows: int,
         mi_cols: int, ssx: int, ssy: int, bd: int = 8):
    """CDEF of the frame (planes int64, padded; returns new planes).
    skip: per-MI skip flags; cdef_idx: per 64x64 unit, -1 where none was
    read; strengths: [(y_pri, y_sec, uv_pri, uv_sec)] as coded (a
    secondary 3 already read as 4)."""
    r = np.arange(0, mi_rows, 2)[:, None]
    c = np.arange(0, mi_cols, 2)[None, :]
    idx = cdef_idx[r >> 4, c >> 4]
    sk = (skip[r, c] & skip[np.minimum(r + 1, mi_rows - 1), c]
          & skip[r, np.minimum(c + 1, mi_cols - 1)]
          & skip[np.minimum(r + 1, mi_rows - 1),
                 np.minimum(c + 1, mi_cols - 1)]).astype(bool)
    br, bc = np.nonzero((idx >= 0) & ~sk)
    out = [pl.copy() for pl in planes]
    if not len(br):
        return out
    ib = idx[br, bc]
    st = np.asarray(strengths, np.int64)[ib]
    shift = bd - 8
    ydir, var = cdef_directions(planes[0], br * 8, bc * 8, bd)
    ypri, ysec = st[:, 0] << shift, st[:, 1] << shift
    dirs = np.where(ypri == 0, 0, ydir)
    vstr = np.where((var >> 6) > 0,
                    np.minimum(_floor_log2(np.maximum(var >> 6, 1)), 12), 0)
    ypri = np.where(var > 0, (ypri * (4 + vstr) + 8) >> 4, 0)
    _cdef_filter(planes[0], out[0], br, bc, 0, 0, ypri, ysec,
                 damping + shift, dirs, mi_rows, mi_cols, shift)
    upri, usec = st[:, 2] << shift, st[:, 3] << shift
    udirs = np.where(upri == 0, 0, ydir)
    if (ssx, ssy) != (1, 1):
        raise ValueError("CDEF of chroma other than 4:2:0")
    for p in (1, 2):
        _cdef_filter(planes[p], out[p], br, bc, ssx, ssy, upri, usec,
                     damping + shift - 1, udirs, mi_rows, mi_cols, shift)
    return out


def _cdef_filter(src, dst, br, bc, sx, sy, pri, sec, damping, dirs,
                 mi_rows, mi_cols, shift):
    h, w = 8 >> sy, 8 >> sx
    y0, x0 = (br * 8) >> sy, (bc * 8) >> sx
    ii = np.arange(h)[None, :, None]
    jj = np.arange(w)[None, None, :]
    yy = y0[:, None, None] + ii
    xx = x0[:, None, None] + jj
    x = src[yy, xx]
    rows, cols = (mi_rows * 4) >> sy, (mi_cols * 4) >> sx
    pri3 = pri[:, None, None]
    sec3 = sec[:, None, None]
    taps = PRI_TAPS[(pri >> shift) & 1][:, :, None, None]
    total = np.zeros_like(x)
    mx, mn = x.copy(), x.copy()

    def tap(d, k, sign):
        dy = sign * CDEF_DIRECTIONS[d, k, 0][:, None, None]
        dx = sign * CDEF_DIRECTIONS[d, k, 1][:, None, None]
        ty, tx = yy + dy, xx + dx
        ok = (ty >= 0) & (ty < rows) & (tx >= 0) & (tx < cols)
        v = src[np.clip(ty, 0, src.shape[0] - 1),
                np.clip(tx, 0, src.shape[1] - 1)]
        return v, ok

    for k in range(2):
        for sign in (-1, 1):
            v, ok = tap(dirs, k, sign)
            total += np.where(ok, taps[:, k] * _constrain(v - x, pri3,
                                                          damping), 0)
            mx = np.where(ok, np.maximum(mx, v), mx)
            mn = np.where(ok, np.minimum(mn, v), mn)
            for off in (-2, 2):
                v, ok = tap((dirs + off) & 7, k, sign)
                total += np.where(ok, SEC_TAPS[k] * _constrain(v - x, sec3,
                                                               damping), 0)
                mx = np.where(ok, np.maximum(mx, v), mx)
                mn = np.where(ok, np.minimum(mn, v), mn)
    dst[yy, xx] = np.clip(x + ((8 + total - (total < 0)) >> 4), mn, mx)
