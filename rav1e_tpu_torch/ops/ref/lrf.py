"""Loop restoration filters (AV1 spec 7.17) - numpy reference.

Reference parity: rav1e src/lrf.rs (Wiener 7-tap solve/apply, SGRPROJ
box sums, stripe processing). This implements the normative filters that
ops/lrf.py's device search is held to; the decode oracles arbitrate
rounding and stripe clamping. The numpy search (search_lr_plane, with
solve_wiener and sgr_pass_outputs) is the JAX package's host search,
which the port runs for 12-bit planes as the reference does
(pipeline/lr.py); 8- and 10-bit planes search on the device.

Wiener: separable 7-tap, taps (w0,w1,w2) per direction with the center
implied (128 - 2*(w0+w1+w2)); vertical pass with InterRound0 rounding
into a clamped intermediate, then horizontal with InterRound1.

Stripes: restoration operates on 64-row stripes offset so the first
stripe is 56 rows; filter rows clamp to within 2 rows of the stripe
edge. The rows inside the stripe are the CDEF output's; the up to 2
rows above and below it are the deblocked frame's before CDEF (the
spec's get_source_sample: UpscaledCurrFrame outside the stripe,
UpscaledCdefFrame inside). The filters take that plane as `pre`; with
CDEF off it is the CDEF output itself (pre=None).
"""

from __future__ import annotations

import numpy as np

WIENER_TAPS_MID = (3, -7, 15)
WIENER_TAPS_MIN = (-5, -23, -17)
WIENER_TAPS_MAX = (10, 8, 46)
WIENER_TAPS_K = (1, 2, 3)


def _wiener_7(taps3):
    w0, w1, w2 = taps3
    return np.array([w0, w1, w2, 128 - 2 * (w0 + w1 + w2), w2, w1, w0],
                    np.int64)


def _source_rows(src, pre, rows, cols, s_lo: int, s_hi: int):
    """The LR input at the (clamped) rows x cols, int64: the CDEF output
    src inside the stripe [s_lo, s_hi], the pre-CDEF plane pre outside
    it (pre None: src throughout)."""
    e = src[np.ix_(rows, cols)]
    if pre is not None:
        out = (rows < s_lo) | (rows > s_hi)
        e = np.where(out[:, None], pre[np.ix_(rows, cols)], e)
    return e.astype(np.int64)


def wiener_filter_unit(src: np.ndarray, y0: int, x0: int, h: int, w: int,
                       vtaps, htaps, bd: int = 8,
                       stripe_h0: int = 56, stripe_h: int = 64,
                       pre: np.ndarray | None = None) -> np.ndarray:
    """Filter one LRU [y0:y0+h, x0:x0+w] of plane `src` (the CDEF
    output; pre the deblocked plane before CDEF, or None without CDEF).
    Horizontal pass first with a positive bias into a clamped
    intermediate, then vertical subtracting the propagated bias
    (dav1d/libaom wiener semantics). Filter rows clamp to the
    containing stripe +-2 (those outside it read pre); columns clamp to
    the frame."""
    ph, pw = src.shape
    vf = _wiener_7(vtaps)
    hf = _wiener_7(htaps)
    rb_h = 3 + (2 if bd == 12 else 0)
    rb_v = 11 - (2 if bd == 12 else 0)
    off_h = 1 << (rb_h - 1)
    bias_h = 1 << (bd + 6)
    clip_lim = 1 << (bd + 1 + 7 - rb_h)
    off_v = 1 << (rb_v - 1)
    round_off_v = 1 << (bd + rb_v - 1)
    out = np.zeros((h, w), np.int64)
    cols = np.clip(np.arange(x0 - 3, x0 + w + 3), 0, pw - 1)
    for yy in range(y0, y0 + h):
        # stripe bounds for this row (first stripe is 8 rows shorter)
        if yy < stripe_h0:
            s_lo, s_hi = 0, stripe_h0 - 1
        else:
            k = (yy - stripe_h0) // stripe_h
            s_lo = stripe_h0 + k * stripe_h
            s_hi = s_lo + stripe_h - 1
        lo = max(0, s_lo - 2)
        hi = min(ph - 1, s_hi + 2)
        rows = np.clip(np.arange(yy - 3, yy + 4), lo, hi)
        patch = _source_rows(src, pre, rows, cols, s_lo, s_hi)  # [7, w+6]
        # horizontal pass on each of the 7 source rows
        hor = np.full((7, w), bias_h, np.int64)
        for t in range(7):
            hor += hf[t] * patch[:, t: t + w]
        hor = np.clip((hor + off_h) >> rb_h, 0, clip_lim - 1)
        s = np.full(w, -round_off_v, np.int64)
        s += np.tensordot(vf, hor, axes=(0, 0))
        s = (s + off_v) >> rb_v
        out[yy - y0] = np.clip(s, 0, (1 << bd) - 1)
    return out.astype(np.int32)


def solve_wiener(rec: np.ndarray, src: np.ndarray, y0: int, x0: int,
                 h: int, w: int, n_iter: int = 3,
                 chroma: bool = False):
    """Least-squares separable Wiener taps for one unit (alternating
    h/v solves; rav1e src/lrf.rs equivalent). Returns (vtaps, htaps)
    integer taps within the spec ranges. chroma=True pins tap 0 to 0
    (spec 5-tap chroma Wiener)."""
    r = rec[max(0, y0 - 3): y0 + h + 3, max(0, x0 - 3): x0 + w + 3]
    oy = y0 - max(0, y0 - 3)
    ox = x0 - max(0, x0 - 3)
    pad = np.pad(r.astype(np.float64), 3, mode="edge")
    t = src[y0: y0 + h, x0: x0 + w].astype(np.float64)

    def taps_vec(taps3):
        a, b, c = taps3
        return np.array([a, b, c, 128 - 2 * (a + b + c), c, b, a],
                        np.float64) / 128.0

    def apply_axis(img, taps3, axis):
        f = taps_vec(taps3)
        out = np.zeros_like(img)
        for k in range(7):
            out += f[k] * np.roll(img, 3 - k, axis=axis)
        return out

    j0 = 1 if chroma else 0      # chroma: tap 0 pinned to 0 (5-tap)

    def solve_axis(img, axis):
        """LS for the free taps on `img` vs target; basis_j =
        (x[-j-1] + x[+j+1] - 2 x0) / 128."""
        x0c = img[3 + oy: 3 + oy + h, 3 + ox: 3 + ox + w]
        B = []
        for j in range(j0, 3):
            d = 3 - j  # tap distance 3,2,1 for coeff index 0,1,2
            m = (np.roll(img, d, axis=axis) + np.roll(img, -d, axis=axis)
                 - 2 * img)[3 + oy: 3 + oy + h, 3 + ox: 3 + ox + w]
            B.append((m / 128.0).ravel())
        Bm = np.stack(B, 1)
        resid = (t - x0c).ravel()
        try:
            sol, *_ = np.linalg.lstsq(Bm, resid, rcond=None)
        except np.linalg.LinAlgError:
            return list(WIENER_TAPS_MID[j0:] if chroma
                        else WIENER_TAPS_MID)
        taps = [0] * j0 + [
            int(np.clip(round(sol[j - j0]), WIENER_TAPS_MIN[j],
                        WIENER_TAPS_MAX[j])) for j in range(j0, 3)]
        return taps

    v = [0] * j0 + list(WIENER_TAPS_MID[j0:])
    hh = list(v)
    for _ in range(n_iter):
        vert = apply_axis(pad, v, 0)
        hh = solve_axis(vert, 1)
        horz = apply_axis(pad, hh, 1)
        v = solve_axis(horz, 0)
    return tuple(v), tuple(hh)


# per-set (s0, s1) strengths for the two SGR passes (r=2 then r=1),
# extracted from libdav1d .rodata@68768; s == 0 disables the pass
SGR_PARAMS_S = [
    (140, 3236), (112, 2158), (93, 1618), (80, 1438),
    (70, 1295), (58, 1177), (47, 1079), (37, 996),
    (30, 925), (25, 863), (0, 2589), (0, 1618),
    (0, 1177), (0, 925), (56, 0), (22, 0),
]
SGRPROJ_XQD_MIN = (-96, -32)
SGRPROJ_XQD_MAX = (31, 95)
SGRPROJ_XQD_MID = (-32, 31)
SGRPROJ_PRJ_SUBEXP_K = 4


def _sgr_ab(src: np.ndarray, pre, y_lo: int, hs: int, x0: int, w: int,
            r: int, s: int, bd: int, s_lo: int, s_hi: int):
    """(A, B) on the extended grid [-1..hs] x [-1..w] for one stripe
    piece whose first output row is frame row `y_lo`, in the stripe
    [s_lo, s_hi]. Source reads clamp rows to the stripe +-2, then the
    frame (those outside the stripe read pre), and columns to the frame
    (spec get_source_sample semantics)."""
    ph, pw = src.shape
    n = (2 * r + 1) ** 2
    rows = np.clip(np.arange(y_lo - 1 - r, y_lo + hs + 1 + r),
                   max(0, s_lo - 2), min(ph - 1, s_hi + 2))
    cols = np.clip(np.arange(x0 - 1 - r, x0 + w + 1 + r), 0, pw - 1)
    e = _source_rows(src, pre, rows, cols, s_lo, s_hi)
    c1 = np.cumsum(np.cumsum(np.pad(e, ((1, 0), (1, 0))), 0), 1)
    c2 = np.cumsum(np.cumsum(np.pad(e * e, ((1, 0), (1, 0))), 0), 1)
    k = 2 * r + 1

    def box(c):
        return (c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k])

    b = box(c1)       # sum of x    [hs+2, w+2]
    a = box(c2)       # sum of x^2
    bs = b
    if bd > 8:
        # the variance takes the sums at 8-bit scale; B takes the sum
        # itself (spec 7.17.3; the reference scales b for B too, which
        # libdav1d does not decode)
        d = bd - 8
        a = (a + (1 << (2 * d - 1))) >> (2 * d)
        bs = (b + (1 << (d - 1))) >> d
    p = np.maximum(0, a * n - bs * bs)
    z = (p * s + (1 << 19)) >> 20
    A = np.where(z >= 255, 256,
                 np.where(z == 0, 1, ((z << 8) + (z >> 1)) // (z + 1)))
    one_over_n = ((1 << 12) + (n >> 1)) // n
    B = ((256 - A) * b * one_over_n + (1 << 11)) >> 12
    return A, B


def _sgr_flt_piece(src: np.ndarray, pre, y_lo: int, hs: int, x0: int,
                   w: int, r: int, s: int, bd: int, s_lo: int, s_hi: int):
    """One self-guided pass over a stripe piece, returning flt at 2^4
    scale. For r=2 the A/B grid exists only at odd local rows (-1, 1,
    ...): odd output rows read their own row ((5,6,5), shift 8), even
    rows combine rows i-1/i+1 (shift 9). r=1 uses the full 3x3
    (3,4,3 / 4,4,4) cross, shift 9."""
    A, B = _sgr_ab(src, pre, y_lo, hs, x0, w, r, s, bd, s_lo, s_hi)
    x = src[y_lo: y_lo + hs,
            max(0, x0): x0 + w].astype(np.int64)
    out = np.zeros((hs, w), np.int64)
    if r == 2:
        for i in range(hs):
            g = i + 1
            if i & 1:
                a = 5 * (A[g, :-2] + A[g, 2:]) + 6 * A[g, 1:-1]
                b = 5 * (B[g, :-2] + B[g, 2:]) + 6 * B[g, 1:-1]
                sh = 8
            else:
                a = (5 * (A[g - 1, :-2] + A[g - 1, 2:])
                     + 6 * A[g - 1, 1:-1]
                     + 5 * (A[g + 1, :-2] + A[g + 1, 2:])
                     + 6 * A[g + 1, 1:-1])
                b = (5 * (B[g - 1, :-2] + B[g - 1, 2:])
                     + 6 * B[g - 1, 1:-1]
                     + 5 * (B[g + 1, :-2] + B[g + 1, 2:])
                     + 6 * B[g + 1, 1:-1])
                sh = 9
            out[i] = (a * x[i] + b + (1 << (sh - 1))) >> sh
    else:
        wgt = ((3, 4, 3), (4, 4, 4), (3, 4, 3))
        for i in range(hs):
            g = i + 1
            a = b = 0
            for dy, w3 in zip((-1, 0, 1), wgt):
                a = (a + w3[0] * A[g + dy, :-2]
                     + w3[1] * A[g + dy, 1:-1] + w3[2] * A[g + dy, 2:])
                b = (b + w3[0] * B[g + dy, :-2]
                     + w3[1] * B[g + dy, 1:-1] + w3[2] * B[g + dy, 2:])
            out[i] = (a * x[i] + b + (1 << 8)) >> 9
    return out


def sgr_weights(sgr_set: int, xqd0: int, xqd1: int):
    """Decoded (w0, w1, w2): the coded values weight pass-0 output and
    the SOURCE; the r=1 pass receives the remainder 128 - w0 - w1."""
    s0, s1 = SGR_PARAMS_S[sgr_set]
    w0 = xqd0 if s0 else 0
    w1 = xqd1 if s1 else (1 << 7) - w0
    w2 = (1 << 7) - w0 - w1
    return w0, w1, w2


def _stripe(yy: int, stripe_h0: int, stripe_h: int):
    """The stripe [s_lo, s_hi] that frame row yy lies in."""
    if yy < stripe_h0:
        return 0, stripe_h0 - 1
    k = (yy - stripe_h0) // stripe_h
    s_lo = stripe_h0 + k * stripe_h
    return s_lo, s_lo + stripe_h - 1


def sgr_pass_outputs(src: np.ndarray, y0: int, x0: int, h: int, w: int,
                     sgr_set: int, bd: int = 8, stripe_h0: int = 56,
                     stripe_h: int = 64, pre: np.ndarray | None = None):
    """(flt0, flt1, u) for one unit at 2^4 scale (flt == u for a
    disabled pass) — the encoder's LS weight solve needs the raw pass
    outputs. The passes read as sgr_filter_unit's do (pre beyond each
    stripe, the unscaled box sum in B)."""
    s0, s1 = SGR_PARAMS_S[sgr_set]
    f0 = np.zeros((h, w), np.int64)
    f1 = np.zeros((h, w), np.int64)
    uu = np.zeros((h, w), np.int64)
    yy = y0
    while yy < y0 + h:
        s_lo, s_hi = _stripe(yy, stripe_h0, stripe_h)
        y_hi = min(s_hi + 1, y0 + h)
        hs = y_hi - yy
        u = src[yy: y_hi, x0: x0 + w].astype(np.int64) << 4
        sl = slice(yy - y0, y_hi - y0)
        uu[sl] = u
        f0[sl] = (_sgr_flt_piece(src, pre, yy, hs, x0, w, 2, s0, bd,
                                 s_lo, s_hi) if s0 else u)
        f1[sl] = (_sgr_flt_piece(src, pre, yy, hs, x0, w, 1, s1, bd,
                                 s_lo, s_hi) if s1 else u)
        yy = y_hi
    return f0, f1, uu


def sgr_filter_unit(src: np.ndarray, y0: int, x0: int, h: int, w: int,
                    sgr_set: int, xqd0: int, xqd1: int,
                    bd: int = 8, stripe_h0: int = 56,
                    stripe_h: int = 64,
                    pre: np.ndarray | None = None) -> np.ndarray:
    """SGRPROJ restoration for one unit (spec 7.17.3), processed per
    64-row stripe piece (first stripe 56 rows) with reads clamped to
    the stripe +-2 rows (those outside it read pre, the deblocked plane
    before CDEF, as wiener_filter_unit's). The coded xqd weight pass 0
    (r=2) and the source; pass 1 (r=1) takes the 128-complement."""
    s0, s1 = SGR_PARAMS_S[sgr_set]
    w0, w1, w2 = sgr_weights(sgr_set, xqd0, xqd1)
    out = np.zeros((h, w), np.int64)
    yy = y0
    while yy < y0 + h:
        s_lo, s_hi = _stripe(yy, stripe_h0, stripe_h)
        y_hi = min(s_hi + 1, y0 + h)
        hs = y_hi - yy
        x = src[yy: y_hi, x0: x0 + w].astype(np.int64)
        u = x << 4
        acc = w1 * u
        acc = acc + (w0 * _sgr_flt_piece(src, pre, yy, hs, x0, w, 2, s0,
                                         bd, s_lo, s_hi)
                     if s0 else w0 * u)
        acc = acc + (w2 * _sgr_flt_piece(src, pre, yy, hs, x0, w, 1, s1,
                                         bd, s_lo, s_hi)
                     if s1 else w2 * u)
        out[yy - y0: y_hi - y0] = (acc + (1 << 10)) >> 11
        yy = y_hi
    return np.clip(out, 0, (1 << bd) - 1).astype(np.int32)


def count_units(frame_size: int, unit_size: int) -> int:
    """Spec count_units_in_frame: last partial unit merges when under
    half a unit."""
    return max((frame_size + (unit_size >> 1)) // unit_size, 1)


SGR_SETS = (0, 3, 6, 9, 11, 12, 14, 15)    # the SGR sets the search tries


def search_lr_plane(rec: np.ndarray, src: np.ndarray, bd: int = 8,
                    ss: int = 0, pre: np.ndarray | None = None, *,
                    chroma: bool):
    """Per-LRU restoration search for one plane on the host (the
    reference's numpy search, rav1e src/lrf.rs + rdo_loop_decision's
    LRF leg as a whole-plane pass): for every unit try the LS-solved
    Wiener taps, three Wiener presets, and the LS-weight SGRPROJ sets;
    keep the SSE winner or None. The port routes 12-bit planes here, as
    the reference does (pipeline/lr.py).

    rec: CDEF-output plane (the LR input); src: source plane; pre: the
    deblocked plane before CDEF (None without CDEF), which the filters
    and the SGR pass outputs read beyond each stripe (the reference
    reads rec there, which decoders do not). ss: the plane's vertical
    subsampling shift (0 luma), which scales the stripe geometry (64>>ss
    rows, first stripe short by 8>>ss); chroma marks a chroma plane at
    any subsampling and pins Wiener tap 0 (the reference takes ss > 0
    for it). Returns (grid [n_ur][n_uc] of None | ("W", vt, ht) |
    ("S", set, xqd0, xqd1), filtered plane, used flag)."""
    off = 8 >> ss
    stripe_h = 64 >> ss
    stripe_h0 = stripe_h - off
    ph, pw = rec.shape
    unit_size = 64
    n_ur = count_units(ph, unit_size)
    n_uc = count_units(pw, unit_size)
    grid = [[None] * n_uc for _ in range(n_ur)]
    presets = ([(3, -7, 15), (0, -4, 8), (1, -2, 4)] if not chroma
               else [(0, -7, 15), (0, -4, 8), (0, -2, 4)])
    filtered = rec.copy()
    used = False
    geo = dict(bd=bd, stripe_h0=stripe_h0, stripe_h=stripe_h, pre=pre)
    for ur in range(n_ur):
        y0 = 0 if ur == 0 else ur * unit_size - off
        y1 = ph if ur == n_ur - 1 else (ur + 1) * unit_size - off
        for uc in range(n_uc):
            x0 = uc * unit_size
            x1 = pw if uc == n_uc - 1 else (uc + 1) * unit_size
            h, w = y1 - y0, x1 - x0
            base_sse = int(((rec[y0:y1, x0:x1]
                             - src[y0:y1, x0:x1]) ** 2).sum())
            vs, hs = solve_wiener(rec, src, y0, x0, h, w,
                                  chroma=chroma)
            best = None
            for vt, ht in [(vs, hs)] + [(tp, tp) for tp in presets]:
                f = wiener_filter_unit(rec, y0, x0, h, w, vt, ht, **geo)
                sse = int(((f - src[y0:y1, x0:x1]) ** 2).sum())
                if sse < base_sse and (best is None or sse < best[0]):
                    best = (sse, tuple(vt), tuple(ht), f)
            if best is not None:
                best_sse, best_f = best[0], best[3]
                best_kind = ("W", best[1], best[2])
            else:
                best_sse, best_f, best_kind = base_sse, None, None
            tgt = src[y0:y1, x0:x1].astype(np.int64) << 4
            for sset in SGR_SETS:
                s0c, s1c = SGR_PARAMS_S[sset]
                f0s, f1s, us = sgr_pass_outputs(rec, y0, x0, h, w, sset,
                                                **geo)
                a = (f0s - us).ravel().astype(np.float64)
                b = (f1s - us).ravel().astype(np.float64)
                t = ((tgt - us) << 7).ravel().astype(np.float64)
                if s0c and s1c:
                    g = np.array([[a @ a, a @ b], [a @ b, b @ b]])
                    rhs = np.array([a @ t, b @ t])
                    try:
                        w0f, w2f = np.linalg.solve(
                            g + 1e-6 * np.eye(2), rhs)
                    except np.linalg.LinAlgError:
                        continue
                elif s0c:
                    w0f = (a @ t) / max(a @ a, 1e-9)
                    w2f = 0.0
                else:
                    w0f = 0.0
                    w2f = (b @ t) / max(b @ b, 1e-9)
                x0q = max(SGRPROJ_XQD_MIN[0],
                          min(SGRPROJ_XQD_MAX[0], round(w0f)))
                if not s0c:
                    x0q = 0
                x1q = max(SGRPROJ_XQD_MIN[1],
                          min(SGRPROJ_XQD_MAX[1],
                              (1 << 7) - x0q - round(w2f)))
                if not s1c:
                    x1q = max(SGRPROJ_XQD_MIN[1],
                              min(SGRPROJ_XQD_MAX[1], (1 << 7) - x0q))
                fs = sgr_filter_unit(rec, y0, x0, h, w, sset, x0q, x1q,
                                     **geo)
                sse = int(((fs - src[y0:y1, x0:x1]) ** 2).sum())
                if sse < best_sse:
                    best_sse = sse
                    best_kind = ("S", sset, x0q, x1q)
                    best_f = fs
            if best_kind is not None:
                grid[ur][uc] = best_kind
                filtered[y0:y1, x0:x1] = best_f
                used = True
    return grid, filtered, used
