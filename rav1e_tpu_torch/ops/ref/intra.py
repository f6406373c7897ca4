"""Intra prediction (AV1 spec §7.11.2) — numpy reference.

Reference parity: rav1e src/predict.rs / src/recon_intra.rs: edge
assembly with availability rules, DC/V/H/Smooth/Paeth predictors,
directional modes with 6-bit fractional positions (added with the
full intra milestone).

Predictors operate on the RECONSTRUCTED neighbors (the encoder must
reproduce decoder state exactly).
"""

from __future__ import annotations

import numpy as np

from rav1e_tpu_torch.core.constants import PredictionMode

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


def cfl_ac(luma_rec: np.ndarray, cw: int, ch: int, ss_x: int = 1,
           ss_y: int = 1) -> np.ndarray:
    """Spec 7.11.5 luma AC: subsample-averaged recon luma scaled to
    x8 (sum << (3 - ss_x - ss_y)), mean-subtracted round-half-up."""
    l2 = luma_rec[: ch << ss_y, : cw << ss_x].astype(np.int32)
    if ss_x and ss_y:
        L = (l2[0::2, 0::2] + l2[0::2, 1::2]
             + l2[1::2, 0::2] + l2[1::2, 1::2]) << 1
    elif ss_x:
        L = (l2[:, 0::2] + l2[:, 1::2]) << 2
    else:
        L = l2 << 3
    n = (cw * ch).bit_length() - 1
    avg = (int(L.sum()) + (1 << (n - 1))) >> n
    return L - avg


def cfl_predict(dc_pred: np.ndarray, ac: np.ndarray, alpha: int,
                bd: int = 8) -> np.ndarray:
    """pred = DC + Round2Signed(alpha * ac, 6), clipped."""
    scaled = alpha * ac
    out = dc_pred + np.sign(scaled) * ((np.abs(scaled) + 32) >> 6)
    return np.clip(out, 0, (1 << bd) - 1).astype(np.int32)


_DIRECTIONAL = {
    PredictionMode.D45_PRED: 45, PredictionMode.D67_PRED: 67,
    PredictionMode.D113_PRED: 113, PredictionMode.D135_PRED: 135,
    PredictionMode.D157_PRED: 157, PredictionMode.D203_PRED: 203,
}


def predict(mode: PredictionMode, w: int, h: int,
            above: np.ndarray | None, left: np.ndarray | None,
            top_left: int | None, bd: int = 8,
            have_above: bool | None = None,
            have_left: bool | None = None,
            angle_delta: int = 0,
            edge_filter: bool = False, filter_type: int = 0,
            n_above: int | None = None,
            n_left: int | None = None) -> np.ndarray:
    """Predict a w x h block from neighbor arrays.

    above: length >= w (may be longer for directional), or None if the
    above row is unavailable. left: length >= h or None. Values are
    reconstructed pixels. have_above/have_left override availability
    when the caller passes spec-filled edge arrays (DC averages only
    truly available sides even though the fill exists)."""
    base = 1 << (bd - 1)
    maxv = (1 << bd) - 1
    have_a = above is not None
    have_l = left is not None
    # true availability (for DC averaging) vs filled-array presence
    avail_a = have_a if have_above is None else have_above
    avail_l = have_l if have_left is None else have_left
    if mode == PredictionMode.DC_PRED:
        have_a, have_l = avail_a, avail_l
        if have_a and have_l:
            s = int(above[:w].sum()) + int(left[:h].sum())
            avg = (s + ((w + h) >> 1)) // (w + h)
        elif have_a:
            avg = (int(above[:w].sum()) + (w >> 1)) >> (w.bit_length() - 1)
        elif have_l:
            avg = (int(left[:h].sum()) + (h >> 1)) >> (h.bit_length() - 1)
        else:
            avg = base
        return np.full((h, w), avg, np.int32)
    if mode == PredictionMode.V_PRED and angle_delta == 0:
        a = above if have_a else np.full(w, base - 1, np.int32)
        return np.tile(a[:w].astype(np.int32), (h, 1))
    if mode == PredictionMode.H_PRED and angle_delta == 0:
        ll = left if have_l else np.full(h, base + 1, np.int32)
        return np.tile(ll[:h].astype(np.int32)[:, None], (1, w))
    if mode in (PredictionMode.V_PRED, PredictionMode.H_PRED):
        base_angle = (90 if mode == PredictionMode.V_PRED
                      else 180) + 3 * angle_delta
        a = (above.astype(np.int32) if have_a
             else np.full(w + h, base - 1, np.int32))
        if len(a) < w + h:
            a = np.concatenate([a, np.full(w + h - len(a), a[-1])])
        ll = (left.astype(np.int32) if have_l
              else np.full(w + h, base + 1, np.int32))
        if len(ll) < w + h:
            ll = np.concatenate([ll, np.full(w + h - len(ll), ll[-1])])
        tl = int(top_left) if top_left is not None else base
        return predict_directional(base_angle, w, h, a, ll, tl, bd,
                                   edge_filter=edge_filter,
                                   filter_type=filter_type,
                                   have_above=avail_a, have_left=avail_l,
                                   n_above=n_above, n_left=n_left)
    if mode == PredictionMode.PAETH_PRED:
        a = (above[:w].astype(np.int32) if have_a
             else np.full(w, base - 1, np.int32))
        ll = (left[:h].astype(np.int32) if have_l
              else np.full(h, base + 1, np.int32))
        tl = int(top_left) if top_left is not None else base
        pa = np.abs(ll[:, None] - tl)        # |left - tl| dist for above
        pl = np.abs(a[None, :] - tl)
        ptl = np.abs(a[None, :] + ll[:, None] - 2 * tl)
        out = np.where((pa <= pl) & (pa <= ptl), np.tile(a, (h, 1)),
                       np.where(pl <= ptl, np.tile(ll[:, None], (1, w)), tl))
        return out.astype(np.int32)
    if mode in _DIRECTIONAL:
        base_angle = _DIRECTIONAL[mode] + 3 * angle_delta
        a = (above.astype(np.int32) if have_a
             else np.full(w + h, base - 1, np.int32))
        if len(a) < w + h:
            a = np.concatenate([a, np.full(w + h - len(a), a[-1])])
        ll = (left.astype(np.int32) if have_l
              else np.full(w + h, base + 1, np.int32))
        if len(ll) < w + h:
            ll = np.concatenate([ll, np.full(w + h - len(ll), ll[-1])])
        tl = int(top_left) if top_left is not None else base
        return predict_directional(base_angle, w, h, a, ll, tl, bd,
                                   edge_filter=edge_filter,
                                   filter_type=filter_type,
                                   have_above=avail_a, have_left=avail_l,
                                   n_above=n_above, n_left=n_left)
    if mode in (PredictionMode.SMOOTH_PRED, PredictionMode.SMOOTH_V_PRED,
                PredictionMode.SMOOTH_H_PRED):
        a = (above[:w].astype(np.int64) if have_a
             else np.full(w, base - 1, np.int64))
        ll = (left[:h].astype(np.int64) if have_l
              else np.full(h, base + 1, np.int64))
        right = a[w - 1]
        bottom = ll[h - 1]
        wh = np.array(SM_WEIGHTS[h], np.int64)[:, None]
        ww = np.array(SM_WEIGHTS[w], np.int64)[None, :]
        if mode == PredictionMode.SMOOTH_PRED:
            sm = (wh * a[None, :] + (256 - wh) * bottom
                  + ww * ll[:, None] + (256 - ww) * right)
            out = (sm + 256) >> 9
        elif mode == PredictionMode.SMOOTH_V_PRED:
            sm = wh * a[None, :] + (256 - wh) * bottom
            out = (sm + 128) >> 8
        else:
            sm = ww * ll[:, None] + (256 - ww) * right
            out = (sm + 128) >> 8
        return np.clip(out, 0, maxv).astype(np.int32)
    raise NotImplementedError(mode)
