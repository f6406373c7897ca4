"""Motion compensation: spec-exact sub-pel inter prediction (8-bit).

Reference parity: rav1e src/mc.rs (put_8tap paths). Semantics follow
AV1 spec 7.11.3 (block_inter_predict, no reference scaling):

- MVs are (row, col) in 1/8 luma pel. For a plane with subsampling ss,
  the 1/16-pel position is ``(pos << 4) + (mv << (1 - ss))``.
- Two 1D passes with 8-tap filters (16 phases, FILTER_BITS=7):
  horizontal first, intermediate = Round2(sum, InterRound0=3), then
  vertical, result = Round2(sum, InterRound1=11), clipped to 8-bit.
  Integer positions use the impulse phase, making the cascade exact.
- Out-of-frame taps replicate the edge pixels (spec clamping).

Filter coefficients are the spec constants (verified against the
libaom build's .rodata; REGULAR at i16 offset 159104).
"""

from __future__ import annotations

import numpy as np

FILTER_BITS = 7
INTER_ROUND0 = 3    # 8-bit intermediate downshift
INTER_ROUND1 = 11   # 2*FILTER_BITS - INTER_ROUND0

# interp_filter enum order from the frame header: EIGHTTAP, SMOOTH,
# SHARP (BILINEAR only via the never-signaled 4th value).
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
    "SMOOTH": np.array([
        [0, 0, 0, 128, 0, 0, 0, 0],
        [0, 2, 28, 62, 34, 2, 0, 0],
        [0, 0, 26, 62, 36, 4, 0, 0],
        [0, 0, 22, 62, 40, 4, 0, 0],
        [0, 0, 20, 60, 42, 6, 0, 0],
        [0, 0, 18, 58, 44, 8, 0, 0],
        [0, 0, 16, 56, 46, 10, 0, 0],
        [0, -2, 16, 54, 48, 12, 0, 0],
        [0, -2, 14, 52, 52, 14, -2, 0],
        [0, 0, 12, 48, 54, 16, -2, 0],
        [0, 0, 10, 46, 56, 16, 0, 0],
        [0, 0, 8, 44, 58, 18, 0, 0],
        [0, 0, 6, 42, 60, 20, 0, 0],
        [0, 0, 4, 40, 62, 22, 0, 0],
        [0, 0, 4, 36, 62, 26, 0, 0],
        [0, 0, 2, 34, 62, 28, 2, 0],
    ], np.int32),
    "SHARP": np.array([
        [0, 0, 0, 128, 0, 0, 0, 0],
        [-2, 2, -6, 126, 8, -2, 2, 0],
        [-2, 6, -12, 124, 16, -6, 4, -2],
        [-2, 8, -18, 120, 26, -10, 6, -2],
        [-4, 10, -22, 116, 38, -14, 6, -2],
        [-4, 10, -22, 108, 48, -18, 8, -2],
        [-4, 10, -24, 100, 60, -20, 8, -2],
        [-4, 10, -24, 90, 70, -22, 10, -2],
        [-4, 12, -24, 80, 80, -24, 12, -4],
        [-2, 10, -22, 70, 90, -24, 10, -4],
        [-2, 8, -20, 60, 100, -24, 10, -4],
        [-2, 8, -18, 48, 108, -22, 10, -4],
        [-2, 6, -14, 38, 116, -22, 10, -4],
        [-2, 6, -10, 26, 120, -18, 8, -2],
        [-2, 4, -6, 16, 124, -12, 6, -2],
        [0, 2, -2, 8, 126, -6, 2, -2],
    ], np.int32),
    "BILINEAR": np.array([
        [0, 0, 0, 128 - 8 * p, 8 * p, 0, 0, 0] for p in range(16)
    ], np.int32),
    # 4-tap banks (spec Subpel_Filters[4]/[5]): used whenever the
    # predicted block's width (x pass) or height (y pass) is <= 4 —
    # e.g. the 4x4 chroma of an 8x8 luma block at 4:2:0. Extracted
    # from the system libaom .rodata (i16 offset 2382464 / 2382336).
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
    "SMOOTH_4": np.array([
        [0, 0, 0, 128, 0, 0, 0, 0],
        [0, 0, 30, 62, 34, 2, 0, 0],
        [0, 0, 26, 62, 36, 4, 0, 0],
        [0, 0, 22, 62, 40, 4, 0, 0],
        [0, 0, 20, 60, 42, 6, 0, 0],
        [0, 0, 18, 58, 44, 8, 0, 0],
        [0, 0, 16, 56, 46, 10, 0, 0],
        [0, 0, 14, 54, 48, 12, 0, 0],
        [0, 0, 12, 52, 52, 12, 0, 0],
        [0, 0, 12, 48, 54, 14, 0, 0],
        [0, 0, 10, 46, 56, 16, 0, 0],
        [0, 0, 8, 44, 58, 18, 0, 0],
        [0, 0, 6, 42, 60, 20, 0, 0],
        [0, 0, 4, 40, 62, 22, 0, 0],
        [0, 0, 4, 36, 62, 26, 0, 0],
        [0, 0, 2, 34, 62, 30, 0, 0],
    ], np.int32),
}


def _bank(filt: str, dim: int) -> np.ndarray:
    """Filter bank for one 1D pass: the 4-tap variant when the block
    extent along the pass is <= 4 (spec 7.11.3.4; SHARP falls back to
    the regular 4-tap like libaom)."""
    if dim <= 4 and filt in ("REGULAR", "SHARP", "SMOOTH"):
        return SUBPEL_FILTERS["SMOOTH_4" if filt == "SMOOTH"
                              else "REGULAR_4"]
    return SUBPEL_FILTERS[filt]


def _round2(x, n):
    return (x + (1 << (n - 1))) >> n


def mc_predict(ref: np.ndarray, y0: int, x0: int, h: int, w: int,
               mv: tuple, ss: int = 0,
               filt: str = "REGULAR", bd: int = 8,
               ss_y: int | None = None) -> np.ndarray:
    """Predict an h x w block of a plane from `ref` at plane position
    (y0, x0) displaced by luma-scale 1/8-pel `mv` (row, col).

    ss subsamples both axes (4:2:0); pass ss_y separately for 4:2:2
    (ss=1, ss_y=0).  8/10-bit share InterRound0/1 = 3/11; 12-bit
    would use 5/9."""
    ssy = ss if ss_y is None else ss_y
    r0, r1 = (5, 9) if bd == 12 else (INTER_ROUND0, INTER_ROUND1)
    rh, rw = ref.shape
    # 1/16-pel plane-scale positions
    py = (y0 << 4) + (int(mv[0]) << (1 - ssy))
    px = (x0 << 4) + (int(mv[1]) << (1 - ss))
    iy, fy = py >> 4, py & 15
    ix, fx = px >> 4, px & 15
    fh = _bank(filt, w)[fx]
    fv = _bank(filt, h)[fy]
    # gather source rows/cols with edge replication
    rows = np.clip(np.arange(iy - 3, iy + h + 4), 0, rh - 1)
    cols = np.clip(np.arange(ix - 3, ix + w + 4), 0, rw - 1)
    src = ref[np.ix_(rows, cols)].astype(np.int64)  # (h+7, w+7)
    # horizontal pass -> (h+7, w)
    interm = np.zeros((h + 7, w), np.int64)
    for t in range(8):
        interm += fh[t] * src[:, t: t + w]
    interm = _round2(interm, r0)
    # vertical pass -> (h, w)
    out = np.zeros((h, w), np.int64)
    for t in range(8):
        out += fv[t] * interm[t: t + h]
    out = _round2(out, r1)
    return np.clip(out, 0, (1 << bd) - 1).astype(np.int32)


def _mc_intermediate(ref: np.ndarray, y0: int, x0: int, h: int, w: int,
                     mv: tuple, ss: int, filt: str, bd: int,
                     ss_y: int | None = None) -> np.ndarray:
    """One reference's prediction at compound intermediate precision
    (spec 7.11.3.1 isCompound: InterRound1 = 7, minus 2 at 12-bit), NOT
    clipped to pixel range."""
    ssy = ss if ss_y is None else ss_y
    r0, r1 = (5, 5) if bd == 12 else (INTER_ROUND0, 7)
    rh, rw = ref.shape
    py = (y0 << 4) + (int(mv[0]) << (1 - ssy))
    px = (x0 << 4) + (int(mv[1]) << (1 - ss))
    iy, fy = py >> 4, py & 15
    ix, fx = px >> 4, px & 15
    fh = _bank(filt, w)[fx]
    fv = _bank(filt, h)[fy]
    rows = np.clip(np.arange(iy - 3, iy + h + 4), 0, rh - 1)
    cols = np.clip(np.arange(ix - 3, ix + w + 4), 0, rw - 1)
    src = ref[np.ix_(rows, cols)].astype(np.int64)
    interm = np.zeros((h + 7, w), np.int64)
    for t in range(8):
        interm += fh[t] * src[:, t: t + w]
    interm = _round2(interm, r0)
    out = np.zeros((h, w), np.int64)
    for t in range(8):
        out += fv[t] * interm[t: t + h]
    return _round2(out, r1)


def mc_predict_avg(ref0: np.ndarray, ref1: np.ndarray, y0: int, x0: int,
                   h: int, w: int, mv0: tuple, mv1: tuple, ss: int = 0,
                   filt: str = "REGULAR", bd: int = 8,
                   ss_y: int | None = None) -> np.ndarray:
    """COMPOUND_AVERAGE inter prediction: both references filtered at
    intermediate precision (scale 2^(bd+4)), then
    Round2(p0 + p1, InterPostRound + 1) with InterPostRound = 4
    (spec 7.11.3.1 compound path)."""
    p0 = _mc_intermediate(ref0, y0, x0, h, w, mv0, ss, filt, bd,
                          ss_y=ss_y)
    p1 = _mc_intermediate(ref1, y0, x0, h, w, mv1, ss, filt, bd,
                          ss_y=ss_y)
    out = _round2(p0 + p1, 5)
    return np.clip(out, 0, (1 << bd) - 1).astype(np.int32)
