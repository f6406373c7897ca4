"""Loop restoration search and apply on the device (port of
rav1e_tpu/ops/tpu/lrf.py; the filters are ops/ref/lrf.py's).

The plane is gathered once into a [P, PH, PW] batch of stripe-piece
patches: a piece is one LR unit's rows within one 64-row stripe (32 for
4:2:0 chroma, the first stripe 8 (4) rows shorter), its rows clamped to
the stripe +-2 and then the frame, its columns to the frame, so every
candidate filter runs as dense batched integer ops on the batch:

- Wiener: the separable 7-tap filter with per-piece tap triples; the
  least-squares taps (three alternating f32 solves per axis) and the 3
  presets;
- SGRPROJ: box sums by 2-D cumsum (int32 at 8 bits; int64 at 10, where
  the squares' running sums over a patch pass 2^31), z = p * s in 13-bit
  halves, for the 8 sets, each with per-unit least-squares weights.

Every candidate's per-unit SSE and the SGR weight sums are f32 sums
that pass 2^24, so they follow XLA:CPU's order for the reference's jit
(_xla_sum_hw: the tree rewriter's 32 x 32 windows, each summed one add
at a time, then the windows; _unit_sum: the pieces of a unit in order;
_fma32 where its object code fuses a multiply into a subtract). Read
from the reference's --xla_dump_to object files. The host takes one
fetch of the per-unit results and keeps the first minimum of the
reference's candidate order; each unit's winner is applied on the
device, bit-exact with ops/ref/lrf.py's wiener_filter_unit and
sgr_filter_unit.

The rows beyond each stripe come from the deblocked plane before CDEF
(`pre`), as decoders read them; the reference reads the CDEF output
there, so with CDEF on its streams decode to other pixels.

10-bit planes take the same search. The reference searches them in
host numpy (exact integer SSEs, f64 solves), so there the port's
choices are its own; its apply is bit-exact at either depth.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from rav1e_tpu_torch.device import to_host
from rav1e_tpu_torch.ops.ref.lrf import (SGR_PARAMS_S, SGR_SETS,
                                         SGRPROJ_XQD_MAX, SGRPROJ_XQD_MIN,
                                         WIENER_TAPS_MAX, WIENER_TAPS_MIN,
                                         count_units)

WIENER_PRESETS = ((3, -7, 15), (0, -4, 8), (1, -2, 4))
RW = 32           # XLA:CPU's tree-reduction window


def _piece_geometry(ph: int, pw: int, ss: int, unit_size: int = 64):
    """Static piece/unit layout for a plane: the unit row bands, the
    column bands and the pieces (unit_row, y0, y1, row_lo, row_hi, s_lo,
    s_hi): rows clamp to [row_lo, row_hi], the stripe [s_lo, s_hi] +-2
    within the frame."""
    off = 8 >> ss
    stripe_h = 64 >> ss
    stripe_h0 = stripe_h - off
    n_ur = count_units(ph, unit_size)
    n_uc = count_units(pw, unit_size)
    ubands = []
    for ur in range(n_ur):
        y0 = 0 if ur == 0 else ur * unit_size - off
        y1 = ph if ur == n_ur - 1 else (ur + 1) * unit_size - off
        ubands.append((y0, y1))
    cbands = []
    for uc in range(n_uc):
        x0 = uc * unit_size
        x1 = pw if uc == n_uc - 1 else (uc + 1) * unit_size
        cbands.append((x0, x1))

    def stripe_of(y):
        if y < stripe_h0:
            return 0, stripe_h0 - 1
        k = (y - stripe_h0) // stripe_h
        lo = stripe_h0 + k * stripe_h
        return lo, lo + stripe_h - 1

    pieces = []
    for ur, (y0, y1) in enumerate(ubands):
        yy = y0
        while yy < y1:
            s_lo, s_hi = stripe_of(yy)
            y_hi = min(s_hi + 1, y1)
            pieces.append((ur, yy, y_hi, max(0, s_lo - 2),
                           min(ph - 1, s_hi + 2), s_lo, s_hi))
            yy = y_hi
    max_h = max(p[2] - p[1] for p in pieces)
    max_w = max(x1 - x0 for x0, x1 in cbands)
    return dict(n_ur=n_ur, n_uc=n_uc, ubands=ubands, cbands=cbands,
                pieces=pieces, max_h=max_h, max_w=max_w,
                stripe_h0=stripe_h0, stripe_h=stripe_h)


@lru_cache(maxsize=8)
def _gather_maps(ph: int, pw: int, ss: int, halo: int,
                 unit_size: int = 64):
    """Static (rows_idx [P, PH], cols_idx [P, PW], valid masks, meta,
    outside [P, PH]) for the piece-patch gather with `halo` px of clamped
    context. Rows clamp to the piece's stripe +-2 then the frame; cols
    clamp to the frame (spec get_source_sample); outside marks the rows
    beyond the stripe, which read the plane before CDEF. meta:
    (unit_row, unit_col, y0, h, x0, w) a piece."""
    g = _piece_geometry(ph, pw, ss, unit_size)
    pieces, cbands = g["pieces"], g["cbands"]
    P = len(pieces) * len(cbands)
    PH = g["max_h"] + 2 * halo
    PW = g["max_w"] + 2 * halo
    rows = np.zeros((P, PH), np.int64)
    outside = np.zeros((P, PH), bool)
    cols = np.zeros((P, PW), np.int64)
    hmask = np.zeros((P, g["max_h"]), bool)
    wmask = np.zeros((P, g["max_w"]), bool)
    meta = []
    k = 0
    for (ur, y0, y1, rlo, rhi, s_lo, s_hi) in pieces:
        for uc, (x0, x1) in enumerate(cbands):
            h, w = y1 - y0, x1 - x0
            rows[k] = np.clip(np.arange(y0 - halo, y0 - halo + PH), rlo, rhi)
            outside[k] = (rows[k] < s_lo) | (rows[k] > s_hi)
            cols[k] = np.clip(np.arange(x0 - halo, x0 - halo + PW), 0, pw - 1)
            hmask[k, :h] = True
            wmask[k, :w] = True
            meta.append((ur, uc, y0, h, x0, w))
            k += 1
    return g, rows, cols, hmask, wmask, meta, outside


class _Tables:
    """A plane shape's gather maps, masks and piece bookkeeping on one
    device."""

    def __init__(self, ph: int, pw: int, ss: int, dev: torch.device):
        g, rows3, cols3, hmask, wmask, meta, out3 = _gather_maps(ph, pw, ss, 3)
        _, rows4, cols4, _, _, _, out4 = _gather_maps(ph, pw, ss, 4)
        self.g = g
        self.P = rows3.shape[0]
        self.H, self.W = g["max_h"], g["max_w"]
        self.n_units = g["n_ur"] * g["n_uc"]
        unit_of = np.asarray([m[0] * g["n_uc"] + m[1] for m in meta],
                             np.int64)
        # the scatter-add visits the pieces in order: a unit's k-th piece
        # is added in pass k (at most one piece of a unit a pass)
        seen: dict = {}
        slot = np.zeros(self.P, np.int64)
        for k, u in enumerate(unit_of):
            slot[k] = seen.get(u, 0)
            seen[u] = slot[k] + 1
        self.passes = [(torch.as_tensor(np.nonzero(slot == s)[0], device=dev),
                        torch.as_tensor(unit_of[slot == s], device=dev))
                       for s in range(int(slot.max()) + 1)]
        # the unit's first piece (its least-squares taps are the unit's)
        first = {}
        for k, u in enumerate(unit_of):
            first.setdefault(int(u), k)
        self.first_piece = np.asarray([first[u] for u in range(self.n_units)])
        row_par = np.zeros((self.P, self.H), np.int32)
        # each piece's valid pixels in the flat plane
        flat = np.full((self.P, self.H, self.W), -1, np.int64)
        for k, (ur, uc, y0, h, x0, w) in enumerate(meta):
            row_par[k, :h] = np.arange(h) & 1
            flat[k, :h, :w] = ((y0 + np.arange(h))[:, None] * pw
                               + (x0 + np.arange(w))[None, :])
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        self.rows3, self.cols3 = t(rows3), t(cols3)
        self.rows4, self.cols4 = t(rows4), t(cols4)
        self.out3, self.out4 = t(out3), t(out4)
        self.hm, self.wm = t(hmask), t(wmask)
        self.mask2 = self.hm[:, :, None] & self.wm[:, None, :]
        self.row_par = t(row_par)
        self.unit_of = t(unit_of)
        valid = flat >= 0
        self.valid = t(valid)
        self.flat_idx = t(flat[valid])


@lru_cache(maxsize=16)
def _tables(ph: int, pw: int, ss: int, dev: torch.device) -> _Tables:
    return _Tables(ph, pw, ss, dev)


def _gather_patches(plane, rows, cols, pre=None, outside=None):
    """[P, PH, PW] piece patches from one [ph, pw] plane; with pre (the
    plane before CDEF), its pixels on the rows marked outside."""
    p = plane[rows[:, :, None], cols[:, None, :]]
    if pre is None:
        return p
    return torch.where(outside[:, :, None], pre[rows[:, :, None],
                                                cols[:, None, :]], p)


# ---- XLA:CPU's f32 orders ---------------------------------------------------

def _window_split(n: int):
    """XLA:CPU's tree rewriter on one reduced dim of size n: a dim of at
    most 32 is one window; a longer one is padded to a multiple of 32
    (half the padding before, half after) and cut into windows of 32.
    Returns (window, windows, pad_lo, pad_hi)."""
    if n <= RW:
        return n, 1, 0, 0
    pad = -n % RW
    return RW, (n + pad) // RW, pad // 2, pad - pad // 2


def _xla_sum_hw(x):
    """x [..., H, W] f32 summed over its last two dims as XLA:CPU sums the
    reference's jnp.sum(..., axis=(1, 2)) of a piece batch: the tree
    rewriter's reduce-window (_window_split on each dim), each window
    one f32 add at a time, row-major, from 0; then each row of windows
    in order from 0, and the two rows' sums added (the reduce's
    vectorized loop). Read from the object files of the reference's
    reduce-window and reduce kernels (window rows of 1 and 2, columns of
    1-3)."""
    H, W = x.shape[-2:]
    wh, nh, h_lo, h_hi = _window_split(H)
    ww, nw, w_lo, w_hi = _window_split(W)
    if h_lo or h_hi or w_lo or w_hi:
        x = torch.nn.functional.pad(x, (w_lo, w_hi, h_lo, h_hi))
    lead = x.shape[:-2]
    xw = x.reshape(lead + (nh, wh, nw, ww))
    acc = torch.zeros(lead + (nh, nw), dtype=torch.float32, device=x.device)
    for r in range(wh):
        row = xw[..., r, :, :]
        for c in range(ww):
            acc = acc + row[..., c]
    total = None
    for i in range(nh):          # nh <= 2: a piece is one stripe high
        s = torch.zeros(lead, dtype=torch.float32, device=x.device)
        for j in range(nw):
            s = s + acc[..., i, j]
        total = s if total is None else total + s
    return total


def _unit_sum(tb: _Tables, v):
    """[..., P] -> [..., n_units]: each unit's pieces added in piece
    order from 0, as the reference's .at[unit].add scatter runs."""
    out = torch.zeros(v.shape[:-1] + (tb.n_units,), dtype=v.dtype,
                      device=v.device)
    for pieces, units in tb.passes:
        out[..., units] = out[..., units] + v[..., pieces]
    return out


def _fma32(a, b, c):
    """fma(a, b, c) of f32 tensors, rounded once: a * b + c in f64
    (the product is exact there), rounded to odd, then to f32."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    odd = (s.view(torch.int64) & 1) == 1
    bump = (err != 0) & ~odd
    s = torch.where(bump, torch.nextafter(s, s + err), s)
    return s.float()


# ---- Wiener -----------------------------------------------------------------

def _swap_rows(A, b, j: int):
    """Partial pivoting at column j: rows j and the first i >= j of the
    largest |A[i, j]| swapped in A [P, n, n] and b [P, n] (in place)."""
    ar = torch.arange(A.shape[0], device=A.device)
    p = j + torch.argmax(torch.abs(A[:, j:, j]), dim=1)
    Aj, bj = A[ar, j].clone(), b[ar, j].clone()
    A[ar, j], b[ar, j] = A[ar, p], b[ar, p]
    A[ar, p], b[ar, p] = Aj, bj


def _solve_small(G, r):
    """jnp.linalg.solve of [P, n, n] f32 systems (n = 2 or 3) as
    XLA:CPU runs it: LAPACK sgetrf (OpenBLAS getf2: partial pivoting,
    the column below the pivot scaled by its reciprocal, each later
    column updated by gemv), the row permutation, then strsm with the
    unit lower and the upper factors (the diagonal's reciprocals; rows
    in blocks of 2 and 1, fused multiply-adds inside a block, the
    products from another block rounded first). Each rounding was
    matched bit for bit against jnp.linalg.solve on 20,000 random
    systems of each size."""
    A, b = G.clone(), r.clone()
    n = A.shape[1]
    _swap_rows(A, b, 0)
    inv = 1.0 / A[:, 0, 0]
    for i in range(1, n):
        A[:, i, 0] = A[:, i, 0] * inv
    for i in range(1, n):
        A[:, i, 1] = A[:, i, 1] - A[:, i, 0] * A[:, 0, 1]
    if n == 2:
        y0 = b[:, 0]
        y1 = _fma32(-A[:, 1, 0], y0, b[:, 1])
        x1 = y1 * (1.0 / A[:, 1, 1])
        x0 = _fma32(-A[:, 0, 1], x1, y0) * (1.0 / A[:, 0, 0])
        return torch.stack([x0, x1], 1)
    _swap_rows(A, b, 1)
    A[:, 2, 1] = A[:, 2, 1] * (1.0 / A[:, 1, 1])
    A[:, 1, 2] = A[:, 1, 2] - A[:, 1, 0] * A[:, 0, 2]
    A[:, 2, 2] = A[:, 2, 2] - _fma32(A[:, 2, 1], A[:, 1, 2],
                                     A[:, 2, 0] * A[:, 0, 2])
    y0 = b[:, 0]
    y1 = _fma32(-A[:, 1, 0], y0, b[:, 1])
    y2 = b[:, 2] - _fma32(A[:, 2, 1], y1, A[:, 2, 0] * y0)
    x2 = y2 * (1.0 / A[:, 2, 2])
    c1 = y1 - A[:, 1, 2] * x2
    c0 = y0 - A[:, 0, 2] * x2
    x1 = c1 * (1.0 / A[:, 1, 1])
    x0 = _fma32(-A[:, 0, 1], x1, c0) * (1.0 / A[:, 0, 0])
    return torch.stack([x0, x1, x2], 1)


def _wiener_solve_batch(patch, tgt, wmask, hmask, chroma: bool):
    """The reference's alternating f32 least squares for the separable
    taps. patch [P, H+6, W+6] f32 (the gather's clamped rows and
    columns); tgt [P, H, W] f32; masks select valid pixels. Returns
    (v, h) int32 [P, 3]."""
    P, PH, PW = patch.shape
    H, W = PH - 6, PW - 6
    dev = patch.device
    mask = (hmask[:, :, None] & wmask[:, None, :]).to(torch.float32)
    j0 = 1 if chroma else 0
    n = 3 - j0
    mins = torch.tensor(WIENER_TAPS_MIN, dtype=torch.float32, device=dev)
    maxs = torch.tensor(WIENER_TAPS_MAX, dtype=torch.float32, device=dev)

    def apply_axis(img, t3, axis):
        # integer taps on integer pixels: exact in f32 in any order
        s = lambda d: torch.roll(img, -d, dims=axis)  # noqa: E731
        c = 128.0 - 2.0 * (t3[:, 0] + t3[:, 1] + t3[:, 2])
        out = (t3[:, 0, None, None] * (s(-3) + s(3))
               + t3[:, 1, None, None] * (s(-2) + s(2))
               + t3[:, 2, None, None] * (s(-1) + s(1))
               + c[:, None, None] * img)
        return out / 128.0

    def solve_axis(img, axis):
        if axis == 1:
            s = lambda d: img[:, 3 + d: 3 + d + H, 3: 3 + W]  # noqa: E731
        else:
            s = lambda d: img[:, 3: 3 + H, 3 + d: 3 + d + W]  # noqa: E731
        x0c = s(0)
        resid = (tgt - x0c) * mask
        Bs = [((s(-(3 - j)) + s(3 - j) - 2 * x0c) / 128.0) * mask
              for j in range(j0, 3)]
        # the normal equations' products, then their sums in one batch
        pairs = [(i, k) for i in range(n) for k in range(i, n)]
        prods = [Bs[i] * Bs[k] for i, k in pairs] + [b * resid for b in Bs]
        sums = _xla_sum_hw(torch.stack(prods))
        G = torch.empty((P, n, n), dtype=torch.float32, device=dev)
        for q, (i, k) in enumerate(pairs):
            G[:, i, k] = sums[q]
            G[:, k, i] = sums[q]
        r = sums[len(pairs):].T
        G = G + 1e-4 * torch.eye(n, dtype=torch.float32, device=dev)
        sol = _solve_small(G, r)
        if j0:
            sol = torch.cat([torch.zeros((P, 1), dtype=torch.float32,
                                         device=dev), sol], 1)
        sol = torch.minimum(torch.maximum(torch.round(sol), mins), maxs)
        if j0:
            sol[:, 0] = 0.0
        return sol

    mid = torch.tensor([0.0 if chroma else 3.0, -7.0, 15.0],
                       dtype=torch.float32, device=dev)
    v = mid.expand(P, 3)
    hh = v
    for _ in range(3):
        vert = apply_axis(patch, v, 1)
        hh = solve_axis(vert, 2)
        horz = apply_axis(patch, hh, 2)
        v = solve_axis(horz, 1)
    return v.to(torch.int32), hh.to(torch.int32)


def _wiener_apply2(patch, v3, h3, bd: int):
    """Separable Wiener with per-piece vertical (axis 1) and horizontal
    (axis 2) tap triples (int32 [P, 3]; integer, spec rounding), on
    patch [P, H+6, W+6] int32 at bit depth 8 or 10. Returns [P, H, W]
    int32."""
    rb_h, rb_v = 3, 11
    off_h = 1 << (rb_h - 1)
    bias_h = 1 << (bd + 6)
    clip_lim = 1 << (bd + 1 + 7 - rb_h)
    off_v = 1 << (rb_v - 1)
    round_off_v = 1 << (bd + rb_v - 1)
    P, PH, PW = patch.shape
    H, W = PH - 6, PW - 6

    def sep(x, t3, axis, n_keep):
        if axis == 1:
            s = lambda d: x[:, 3 + d: 3 + d + n_keep, :]  # noqa: E731
        else:
            s = lambda d: x[:, :, 3 + d: 3 + d + n_keep]  # noqa: E731
        c = (128 - 2 * (t3[:, 0] + t3[:, 1] + t3[:, 2]))[:, None, None]
        return (t3[:, 0, None, None] * (s(-3) + s(3))
                + t3[:, 1, None, None] * (s(-2) + s(2))
                + t3[:, 2, None, None] * (s(-1) + s(1)) + c * s(0))

    hor = bias_h + sep(patch, h3, 2, W)
    hor = torch.clamp((hor + off_h) >> rb_h, 0, clip_lim - 1)
    out = sep(hor, v3, 1, H) - round_off_v
    out = (out + off_v) >> rb_v
    return torch.clamp(out, 0, (1 << bd) - 1)


# ---- SGRPROJ ----------------------------------------------------------------

def _mul_shift20(p, s: int):
    """(p * s + 2^19) >> 20 in int32 lanes for p up to ~2^26: p split at
    13 bits (the reference's split)."""
    p_hi = p >> 13
    p_lo = p & 0x1FFF
    t = p_lo * s + (1 << 19)
    return (p_hi * s + (t >> 13)) >> 7


def _sgr_ab_batch(patch, r: int, s: int, bd: int):
    """(A, B) [P, H+2, W+2] int32 on the extended [-1..H] x [-1..W] grid
    of patch [P, H+2+2r, W+2+2r] int32 (halo 1 + r). Above 8 bits the
    sums run in int64: a patch's squares pass 2^31 at 10 bits."""
    n = (2 * r + 1) ** 2
    acc = torch.int32 if bd == 8 else torch.int64
    pad = lambda x: torch.nn.functional.pad(x.to(acc), (1, 0, 1, 0))  # noqa
    c1 = torch.cumsum(torch.cumsum(pad(patch), 1, dtype=acc), 2, dtype=acc)
    c2 = torch.cumsum(torch.cumsum(pad(patch) ** 2, 1, dtype=acc), 2,
                      dtype=acc)
    k = 2 * r + 1

    def box(c):
        return (c[:, k:, k:] - c[:, :-k, k:] - c[:, k:, :-k]
                + c[:, :-k, :-k])

    b = box(c1)
    a = box(c2)
    bs = b
    if bd > 8:
        # B takes the unscaled sum (spec 7.17.3), as ops/ref/lrf.py's
        d = bd - 8
        a = (a + (1 << (2 * d - 1))) >> (2 * d)
        bs = (b + (1 << (d - 1))) >> d
    p = torch.clamp(a * n - bs * bs, min=0)
    z = _mul_shift20(p, s)
    A = torch.where(z >= 255, 256,
                    torch.where(z == 0, 1,
                                torch.div((z << 8) + (z >> 1), z + 1,
                                          rounding_mode="floor")))
    one_over_n = ((1 << 12) + (n >> 1)) // n
    B = ((256 - A) * b * one_over_n + (1 << 11)) >> 12
    return A.to(torch.int32), B.to(torch.int32)


def _sgr_flt_batch(patch_r, x, r: int, s: int, bd: int, row_par):
    """One self-guided pass at 2^4 scale over a piece batch: patch_r
    [P, H+2+2r, W+2+2r] (halo 1 + r), x [P, H, W] the unit pixels,
    row_par [P, H] each row's parity within its piece (r = 2 reads its
    A/B rows by parity). Returns [P, H, W] int32."""
    A, B = _sgr_ab_batch(patch_r, r, s, bd)
    P, H, W = x.shape
    if r == 2:
        def row3(M, g0):
            sl = M[:, g0: g0 + H, :]
            return 5 * (sl[:, :, :-2] + sl[:, :, 2:]) + 6 * sl[:, :, 1:-1]

        a_odd, b_odd = row3(A, 1), row3(B, 1)
        a_ev = row3(A, 0) + row3(A, 2)
        b_ev = row3(B, 0) + row3(B, 2)
        odd = row_par.bool()[:, :, None]
        return torch.where(odd, (a_odd * x + b_odd + (1 << 7)) >> 8,
                           (a_ev * x + b_ev + (1 << 8)) >> 9)
    wgt = ((3, 4, 3), (4, 4, 4), (3, 4, 3))
    a = 0
    b = 0
    for dy, w3 in zip((0, 1, 2), wgt):
        As = A[:, dy: dy + H, :]
        Bs = B[:, dy: dy + H, :]
        a = (a + w3[0] * As[:, :, :-2] + w3[1] * As[:, :, 1:-1]
             + w3[2] * As[:, :, 2:])
        b = (b + w3[0] * Bs[:, :, :-2] + w3[1] * Bs[:, :, 1:-1]
             + w3[2] * Bs[:, :, 2:])
    return (a * x + b + (1 << 8)) >> 9


def _sgr_weights(aa, ab, bb, at, bt, s0: int, s1: int):
    """The per-unit least-squares SGR weights, quantized: (x0q, x1q)
    int32. The 2-set form as the reference's object code computes it:
    each difference of products fuses its first product (fma), its
    second product rounded."""
    if s0 and s1:
        det = _fma32(bb, aa, -(ab * ab)) + 1e-6
        w0f = _fma32(bb, at, -(ab * bt)) / det
        w2f = _fma32(aa, bt, -(ab * at)) / det
    elif s0:
        w0f = at / torch.clamp(aa, min=1e-9)
        w2f = torch.zeros_like(w0f)
    else:
        w0f = torch.zeros_like(at)
        w2f = bt / torch.clamp(bb, min=1e-9)
    x0q = _sat_i32(torch.clamp(torch.round(w0f), SGRPROJ_XQD_MIN[0],
                               SGRPROJ_XQD_MAX[0]))
    if not s0:
        x0q = torch.zeros_like(x0q)
    if s1:
        x1q = torch.clamp(128 - x0q - _sat_i32(torch.round(w2f)),
                          SGRPROJ_XQD_MIN[1], SGRPROJ_XQD_MAX[1])
    else:
        x1q = torch.clamp(128 - x0q, SGRPROJ_XQD_MIN[1], SGRPROJ_XQD_MAX[1])
    return x0q, x1q


def _sat_i32(x):
    """f32 -> int32 as XLA converts: saturating, NaN to 0."""
    x = torch.nan_to_num(x, nan=0.0)
    return torch.clamp(x, -2.0 ** 31, 2.0 ** 31 - 128).to(torch.int32)


# ---- whole-plane search ---------------------------------------------------

def _search_dev(rec, src, bd: int, ss: int, pre=None, *, chroma: bool):
    """The reference's jitted step as torch ops on rec's device. rec, src
    [ph, pw] int32; pre the deblocked plane before CDEF (None: rec),
    whose rows the patches take beyond each stripe; chroma pins the
    Wiener tap 0 to 0. Returns (summary f32 [n], the SGR sets' filtered
    pieces [S, P, H, W], the piece patches p3, the table)."""
    ph, pw = rec.shape
    tb = _tables(ph, pw, ss, rec.device)
    H, W, P = tb.H, tb.W, tb.P
    mask2 = tb.mask2
    p3 = _gather_patches(rec, tb.rows3, tb.cols3, pre, tb.out3)  # halo 3
    tgt = p3[:, 3: 3 + H, 3: 3 + W]
    s3 = _gather_patches(src, tb.rows3, tb.cols3)
    starget = s3[:, 3: 3 + H, 3: 3 + W]

    def sq_err(f):
        d = torch.where(mask2, f - starget, 0).to(torch.float32)
        return d * d

    # ---- Wiener: least-squares taps + presets ----
    vsol, hsol = _wiener_solve_batch(p3.to(torch.float32),
                                     starget.to(torch.float32),
                                     tb.wm, tb.hm, chroma)
    presets = torch.tensor(WIENER_PRESETS, dtype=torch.int32,
                           device=rec.device)
    if chroma:
        presets[:, 0] = 0
    wien = [_wiener_apply2(p3, vsol, hsol, bd)]
    for i in range(3):
        t3 = presets[i].expand(P, 3)
        wien.append(_wiener_apply2(p3, t3, t3, bd))
    errs = torch.stack([sq_err(tgt)] + [sq_err(f) for f in wien])
    sse_w = _unit_sum(tb, _xla_sum_hw(errs))            # [5, U]

    # ---- SGR sets ----
    p4 = _gather_patches(rec, tb.rows4, tb.cols4, pre, tb.out4)  # halo 4
    u = tgt << 4
    tgt7 = ((starget - tgt) << 11).to(torch.float32)
    flts = []
    prods, slots = [], []
    for sset in SGR_SETS:
        s0, s1 = SGR_PARAMS_S[sset]
        f0 = (_sgr_flt_batch(p4[:, 1:-1, 1:-1], tgt, 2, s0, bd, tb.row_par)
              if s0 else u)
        f1 = (_sgr_flt_batch(p4[:, 2:-2, 2:-2], tgt, 1, s1, bd, tb.row_par)
              if s1 else u)
        flts.append((f0, f1))
        a = torch.where(mask2, f0 - u, 0).to(torch.float32)
        b = torch.where(mask2, f1 - u, 0).to(torch.float32)
        want = {"aa": (a, a), "ab": (a, b), "bb": (b, b), "at": (a, tgt7),
                "bt": (b, tgt7)}
        names = (("aa", "ab", "bb", "at", "bt") if s0 and s1 else
                 ("aa", "at") if s0 else ("bb", "bt"))
        slots.append({})
        for nm in names:
            slots[-1][nm] = len(prods)
            x, y = want[nm]
            prods.append(x * y)
    sums = _unit_sum(tb, _xla_sum_hw(torch.stack(prods)))
    zero = torch.zeros_like(sums[0])
    fs_all, xqd = [], []
    for sset, (f0, f1), sl in zip(SGR_SETS, flts, slots):
        s0, s1 = SGR_PARAMS_S[sset]
        get = lambda nm: sums[sl[nm]] if nm in sl else zero  # noqa: E731
        x0q, x1q = _sgr_weights(get("aa"), get("ab"), get("bb"), get("at"),
                                get("bt"), s0, s1)
        w0 = x0q if s0 else torch.zeros_like(x0q)
        w1 = x1q if s1 else 128 - w0
        w2 = 128 - w0 - w1
        wp = lambda w: w[tb.unit_of][:, None, None]  # noqa: E731
        acc = wp(w1) * u + wp(w0) * f0 + wp(w2) * f1
        fs_all.append(torch.clamp((acc + (1 << 10)) >> 11, 0, (1 << bd) - 1))
        xqd.append(torch.stack([x0q, x1q]))
    fs_all = torch.stack(fs_all)                        # [S, P, H, W]
    sse_s = _unit_sum(tb, _xla_sum_hw(torch.stack([sq_err(f)
                                                   for f in fs_all])))
    summary = torch.cat([sse_w.reshape(-1), sse_s.reshape(-1),
                         torch.stack(xqd).reshape(-1).to(torch.float32),
                         vsol.reshape(-1).to(torch.float32),
                         hsol.reshape(-1).to(torch.float32)])
    return summary, fs_all, p3, tb


def search_lr_plane(rec, src, bd: int = 8, ss: int = 0, pre=None, *,
                    chroma: bool):
    """The reference's search_lr_plane_tpu on rec's device: rec and src
    are [ph, pw] integer tensors on one device (the recon straight from
    the pipeline's device planes), at bit depth bd (8 or 10), ss the
    plane's vertical subsampling shift; chroma marks a chroma plane at
    any subsampling, whose Wiener tap 0 is pinned to 0 (the reference
    takes ss > 0 for it, and so a 4:2:2 or 4:4:4 chroma plane for luma,
    a 7-tap Wiener filter that its 5-tap coding cannot carry); pre the
    deblocked plane before
    CDEF, or None where CDEF is off: the filters read its rows beyond
    each stripe, as the spec's and ops/ref/lrf.py's do (the reference
    reads the CDEF output there, which decoders do not). The search,
    the per-unit SSEs and the winners' apply run there; the host takes
    one fetch of the per-unit results (_choose). Returns (grid
    [n_ur][n_uc] of None | ("W", vtaps, htaps) | ("S", set, xqd0,
    xqd1), the filtered plane (int32, on rec's device), used)."""
    if bd not in (8, 10):
        raise NotImplementedError(
            "the device LR search takes 8- and 10-bit planes: 12-bit planes "
            "search on the host (ops/ref/lrf.py::search_lr_plane, routed "
            "by pipeline/lr.py), as the reference's do")
    rec = rec.to(torch.int32)
    src = src.to(device=rec.device, dtype=torch.int32)
    if pre is not None:
        pre = pre.to(device=rec.device, dtype=torch.int32)
    summary, fs_all, p3, tb = _search_dev(rec, src, bd, ss, pre,
                                          chroma=chroma)
    grid, choice, taps = _choose(to_host(summary), tb, chroma)
    if not choice.any():
        return grid, rec, False
    return grid, _apply_choice(rec, p3, fs_all, tb, choice, taps, bd), True


def _choose(s, tb: _Tables, chroma: bool):
    """The host argmin on the fetched summary s: per unit the first
    minimum in the reference's order (the least-squares Wiener taps, the
    3 presets, the 8 SGR sets), none where it does not beat the
    unfiltered SSE; the least-squares taps a unit codes are its first
    piece's. Returns (grid, choice per unit: 0 none, 1 Wiener, 2 + i SGR
    set i, taps [U, 2, 3] the Wiener units' (v, h))."""
    U, P, S = tb.n_units, tb.P, len(SGR_SETS)
    o = 0
    base = s[o: o + U]
    wien = s[o + U: o + 5 * U].reshape(4, U)
    o += 5 * U
    sgr = s[o: o + S * U].reshape(S, U)
    o += S * U
    xqd = s[o: o + 2 * S * U].reshape(S, 2, U).astype(np.int64)
    o += 2 * S * U
    vsol = s[o: o + 3 * P].reshape(P, 3).astype(np.int64)
    hsol = s[o + 3 * P: o + 6 * P].reshape(P, 3).astype(np.int64)
    n_ur, n_uc = tb.g["n_ur"], tb.g["n_uc"]
    grid = [[None] * n_uc for _ in range(n_ur)]
    choice = np.zeros(U, np.int64)
    taps = np.zeros((U, 2, 3), np.int64)
    for ur in range(n_ur):
        for uc in range(n_uc):
            un = ur * n_uc + uc
            fp = tb.first_piece[un]
            cands = []
            for ci in range(4):
                if ci == 0:
                    vt = tuple(int(t) for t in vsol[fp])
                    ht = tuple(int(t) for t in hsol[fp])
                else:
                    p = WIENER_PRESETS[ci - 1]
                    vt = ht = (0, p[1], p[2]) if chroma else p
                cands.append((float(wien[ci, un]), ("W", vt, ht), ci))
            for si, sset in enumerate(SGR_SETS):
                cands.append((float(sgr[si, un]),
                              ("S", sset, int(xqd[si, 0, un]),
                               int(xqd[si, 1, un])), si))
            best_sse, best_kind, idx = min(cands, key=lambda c: c[0])
            if best_sse >= float(base[un]):
                continue
            grid[ur][uc] = best_kind
            if best_kind[0] == "W":
                choice[un] = 1
                taps[un] = (best_kind[1], best_kind[2])
            else:
                choice[un] = 2 + idx
    return grid, choice, taps


def _apply_choice(rec, p3, fs_all, tb: _Tables, choice, taps, bd: int):
    """The filtered plane: each unit's winner (choice per unit: 0 none, 1
    Wiener with taps[unit] = (v, h), 2 + i the SGR set i's output of the
    search) written over rec's pixels, on rec's device."""
    dev = rec.device
    ch = torch.as_tensor(choice, device=dev)[tb.unit_of]       # [P]
    if (choice == 1).any():
        t = torch.as_tensor(taps, dtype=torch.int32, device=dev)[tb.unit_of]
        fw = _wiener_apply2(p3, t[:, 0], t[:, 1], bd)
    else:
        fw = torch.zeros_like(fs_all[0])
    cand = torch.cat([fw[None], fs_all])                      # [1 + S, P..]
    pick = cand[torch.clamp(ch - 1, min=0), torch.arange(tb.P, device=dev)]
    keep = tb.valid & (ch > 0)[:, None, None]
    out = rec.clone().reshape(-1)
    sel = keep[tb.valid]
    out[tb.flat_idx[sel]] = pick[keep].to(out.dtype)
    return out.reshape(rec.shape)
