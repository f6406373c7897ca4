"""CDEF: the per-8x8 direction search, the per-SB strength search over the
8-entry ladder and the filter (port of rav1e_tpu/ops/tpu/cdef.py).

Three stages, each a CUDA kernel of csrc/cdef.cu on the card (launched
once a frame) and a plain PyTorch version here (per plane):

- `cdef_dirs`: direction and variance of every 8x8 luma block
  (`cdef_directions_jax` + `_dirs_var` of the reference);
- `cdef_ladder_sse`: each ladder entry's squared error against the
  source, per sampled superblock or per 32-block, for the frame's three
  planes in one launch (`_prep_plane` + 8 x `_filter_from_prep` + the
  sums of `cdef_search_persb_jax`), f32 in the reference's order; the
  plain version `cdef_ladder_sse_plain` takes one plane;
- `cdef_apply`: the frame's three planes filtered in one launch with
  each SB's winning entry, or with one uniform strength pair per plane
  kind (`cdef_filter_frame_jax`); `cdef_apply_plain` takes one plane.

Between them, shared by both routes: the per-SB SSE from the three
planes' tables, the nb_strengths subset RD over the 107 masks (its sum
over the SBs in XLA:CPU's order, `_subset_sum`) and the argmin.
`cdef_search_persb` and `cdef_filter_frame` are the reference's entry
points; they convert the planes to contiguous uint8 once a frame and
the kernels read the bool skip map's bytes as they are. Each wrapper
takes a CPU tensor to its plain version and a CUDA tensor to its kernel
(counted in `<wrapper>.launches`; `path_counts` counts the kernels'
blocks by path on the card); there is no fallback, and the kernels take
8-bit content only (bd > 8 raises, ROADMAP.md item 12).

The reference's SSEs are f32 sums, and the order of the sum decides
once a cell passes 2^24 (an RMS error of 64 a pixel, noise at q 255).
The plain version sums in XLA:CPU's order (`_xla_rows_sum`;
tests/test_torch_speed6.py holds the table to the reference's bit for
bit past 2^24). The kernel sums each cell's squared errors exactly in
int32 and writes the total as f32, which is the ordered sum wherever
the total is at most 2^24 (every partial sum is then an exact f32
integer); a block with a total past 2^24 sums in the reference's order
instead (csrc/cdef.cu, tests/test_torch_cdef_fast.py).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from itertools import combinations

import numpy as np
import torch

from rav1e_tpu_torch import nvcc
from rav1e_tpu_torch.ops.ref.cdef import (
    CDEF_DIRECTIONS,
    DIV_TABLE,
    LARGE,
    PRI_TAPS,
    SEC_TAPS,
)

SRC = nvcc.CSRC / "cdef.cu"

# secondary strengths must be in {0, 1, 2, 4} (spec 2-bit code, 3->4)
CDEF_LADDER = [
    (0, 0, 0, 0), (1, 0, 1, 0), (2, 1, 1, 0), (3, 1, 2, 1),
    (5, 2, 4, 1), (7, 2, 5, 2), (10, 2, 8, 2), (14, 4, 12, 4),
]


def compact_ladder(cdef_map):
    """Compress the frame's signaled strength set to the ladder
    entries its SBs actually chose (rav1e signals nb_strengths the
    same way): the full 8-entry set costs ~12 header bytes + 3
    bits/SB — real rate on small frames. Returns (strengths list,
    cdef_bits, remapped per-SB map)."""
    used = np.unique(np.asarray(cdef_map))
    bits = int(np.ceil(np.log2(len(used)))) if len(used) > 1 else 0
    lut = np.zeros(len(CDEF_LADDER), np.uint8)
    for i, u in enumerate(used):
        lut[int(u)] = i
    strengths = [tuple(CDEF_LADDER[int(u)]) for u in used]
    while len(strengths) < (1 << bits):
        strengths.append(strengths[-1])
    return strengths, bits, lut[np.asarray(cdef_map)]


# ---- the plain versions (the reference's jnp functions in torch) ------------

@lru_cache(maxsize=None)
def _dir_matrices():
    """One-hot [64, nbins] matrices + weight vectors per direction."""
    ii = np.arange(8)[:, None] + np.zeros(8, np.int64)[None, :]
    jj = np.zeros(8, np.int64)[:, None] + np.arange(8)[None, :]
    bins = [ii + jj, ii + (jj >> 1), ii, 3 + ii - (jj >> 1), 7 + ii - jj,
            3 - (ii >> 1) + jj, jj, (ii >> 1) + jj]
    mats, wts = [], []
    for b in bins:
        b = b.ravel()
        n = int(b.max()) + 1
        m = np.zeros((64, n), np.float32)
        m[np.arange(64), b] = 1.0
        cnt = m.sum(axis=0).astype(np.int64)
        mats.append(m)
        wts.append(np.asarray(DIV_TABLE)[cnt].astype(np.int64))
    return mats, wts


def _msb(x):
    """floor(log2(max(x, 1))) as an integer. The reference takes it from
    a float32 log2, which is off by one at some powers of two (8192 and
    32768 among them, on XLA:CPU); CDEF reads it only for strengths
    <= 14 and as min(msb(var >> 6), 12), where the two agree."""
    x = torch.clamp(torch.as_tensor(x), min=1).to(torch.float64)
    return (torch.frexp(x)[1] - 1).to(torch.int32)


def _constrain(diff, strength, damping):
    adj = torch.clamp(damping - _msb(strength), min=0)
    a = torch.abs(diff)
    lim = torch.clamp(strength - (a >> adj), min=0)
    out = torch.sign(diff) * torch.minimum(a, lim)
    return torch.where(strength > 0, out, 0)


def cdef_directions(yblks):
    """yblks [B, 8, 8] int -> (dir [B] int32, var [B] int32). The costs
    (up to ~2^34) are int64; the first maximum wins ties (spec)."""
    mats, wts = _dir_matrices()
    dev = yblks.device
    x = (yblks.reshape(-1, 64).to(torch.int32) - 128).to(torch.float32)
    costs = []
    for d in range(8):
        # partial sums of at most 8 values of |x| <= 128: exact in f32
        part = (x @ torch.as_tensor(mats[d], device=dev)).to(torch.int64)
        costs.append(torch.sum(part * part
                               * torch.as_tensor(wts[d], device=dev), 1))
    cost = torch.stack(costs, 1)
    best = torch.zeros(x.shape[0], dtype=torch.int64, device=dev)
    cb = cost[:, 0]
    for d in range(1, 8):
        gt = cost[:, d] > cb
        best = torch.where(gt, d, best)
        cb = torch.where(gt, cost[:, d], cb)
    co = torch.gather(cost, 1, ((best + 4) % 8)[:, None])[:, 0]
    return best.to(torch.int32), ((cb - co) >> 10).to(torch.int32)


def _dirs_var(y):
    """Direction/variance per 8x8 luma block, as [h/8, w/8] grids."""
    h, w = y.shape
    yb = (y.reshape(h // 8, 8, w // 8, 8).permute(0, 2, 1, 3)
          .reshape(-1, 8, 8))
    dirs, var = cdef_directions(yb)
    return dirs.reshape(h // 8, w // 8), var.reshape(h // 8, w // 8)


@lru_cache(maxsize=None)
def _shift_tables():
    """Per-direction tap offsets: primary [8][4], secondary [8][8]
    (dy, dx) — slot order: (k0,+),(k0,-),(k1,+),(k1,-) primary;
    ((d+2,k),±),((d-2,k),±) per k secondary."""
    pri = [[None] * 4 for _ in range(8)]
    sec = [[None] * 8 for _ in range(8)]
    for d in range(8):
        t = 0
        for k in range(2):
            dy, dx = CDEF_DIRECTIONS[d][k]
            for sgn in (1, -1):
                pri[d][t] = (sgn * dy, sgn * dx)
                t += 1
        t = 0
        for k in range(2):
            for d2 in ((d + 2) & 7, (d - 2) & 7):
                dy, dx = CDEF_DIRECTIONS[d2][k]
                for sgn in (1, -1):
                    sec[d][t] = (sgn * dy, sgn * dx)
                    t += 1
    return pri, sec


def _prep_plane(plane, dirs_pix, n, is_luma):
    """Candidate-independent part of the filter, in plane space: the 4
    primary and 8 secondary tap values of every pixel, as static shifted
    slices of the LARGE-padded plane selected by the pixel's direction.
    dirs_pix [h, w]: the luma-block direction upsampled to this plane."""
    h, w = plane.shape
    x = plane.to(torch.int32)
    P = torch.nn.functional.pad(x, (2, 2, 2, 2), value=LARGE)
    pri_off, sec_off = _shift_tables()

    def shifted(dy, dx):
        return P[2 + dy: 2 + dy + h, 2 + dx: 2 + dx + w]

    def select(offsets_per_dir):
        acc = torch.zeros((h, w), dtype=torch.int32, device=x.device)
        for d in range(8):
            acc = acc + torch.where(dirs_pix == d,
                                    shifted(*offsets_per_dir[d]), 0)
        return acc

    p_pri = [select([pri_off[d][t] for d in range(8)]) for t in range(4)]
    p_sec = [select([sec_off[d][t] for d in range(8)]) for t in range(8)]
    return dict(x=x, p_pri=p_pri, p_sec=p_sec, n=n, is_luma=is_luma,
                dtype=plane.dtype)


def _filter_from_prep(pp, skip_pix, pri, sec, damping, var_pix,
                      coeff_shift: int = 0):
    """Apply one (pri, sec) strength pair (scalars or per-pixel maps) to
    the prepared taps: the reference's filter tail, op for op. Strengths
    and damping arrive pre-scaled for bd > 8; the tap parity reads the
    unscaled strength."""
    x = pp["x"]
    dev = x.device
    pri = torch.as_tensor(pri, dtype=torch.int32, device=dev)
    sec = torch.as_tensor(sec, dtype=torch.int32, device=dev)
    damping = torch.as_tensor(damping, dtype=torch.int32, device=dev)
    if pp["is_luma"]:
        v6 = var_pix >> 6
        vs = torch.where(v6 > 0, torch.clamp(_msb(v6), max=12), 0)
        pri_adj = torch.where(var_pix > 0, (pri * (4 + vs) + 8) >> 4, 0)
    else:
        pri_adj = torch.broadcast_to(pri, x.shape)
    pdamp = damping if pp["is_luma"] else damping - 1
    parity = (pri_adj >> coeff_shift) & 1
    i32 = torch.int32
    tap_a = torch.where(parity == 0, PRI_TAPS[0][0], PRI_TAPS[1][0]).to(i32)
    tap_b = torch.where(parity == 0, PRI_TAPS[0][1], PRI_TAPS[1][1]).to(i32)
    pri_taps = [tap_a, tap_a, tap_b, tap_b]
    s = torch.zeros_like(x)
    mx = x
    mn = x
    for t in range(4):
        p = pp["p_pri"][t]
        valid = p != LARGE
        c = _constrain(p - x, pri_adj, pdamp)
        s = s + torch.where(valid, pri_taps[t] * c, 0)
        mx = torch.where(valid, torch.maximum(mx, p), mx)
        mn = torch.where(valid, torch.minimum(mn, p), mn)
    for t in range(8):
        p = pp["p_sec"][t]
        valid = (p != LARGE) & (sec > 0)
        c = _constrain(p - x, sec, pdamp)
        s = s + torch.where(valid, SEC_TAPS[t // 4] * c, 0)
        mx = torch.where(valid, torch.maximum(mx, p), mx)
        mn = torch.where(valid, torch.minimum(mn, p), mn)
    y = x + ((8 + s - (s < 0).to(torch.int32)) >> 4)
    y = torch.minimum(torch.maximum(y, mn), mx)
    active = (~skip_pix) & ((pri_adj > 0) | (sec > 0))
    y = torch.where(active, y, x)
    return y.to(pp["dtype"])


def _upsample(grid, n):
    return grid.repeat_interleave(n, 0).repeat_interleave(n, 1)


def _diag(a, b):
    """The sampled view of a plane: its TL and BR b x b quadrants of
    every 2b x 2b superblock, [2, nr, b, nc, b]."""
    h, w = a.shape[-2:]
    v = a.reshape(h // (2 * b), 2, b, w // (2 * b), 2, b)
    return torch.stack([v[:, 0, :, :, 0, :], v[:, 1, :, :, 1, :]], 0)


def cdef_dirs_plain(y, bd: int = 8):
    """(dir int8 [H/8, W/8], var int32 [H/8, W/8]) of a luma plane."""
    shift = bd - 8
    y = y.to(torch.int32)
    dirs, var = _dirs_var(y >> shift if shift else y)
    return dirs.to(torch.int8), var


def _ladder_errors(plane, src, dirs, var, skip8, damping: int, chroma: bool,
                   sampled: bool, bd: int):
    """Each ladder entry's filtered plane minus `src`, int32, in the
    cells of the SSE table: [2, R, b, C, b] (sampled: the TL and BR
    b x b quadrants of each SB) or [R, b, C, b] (each b-block). Returns
    (the 8 error arrays, the cell's pixel dims)."""
    shift = bd - 8
    n, b = (4, 16) if chroma else (8, 32)
    pp = _prep_plane(plane, _upsample(dirs, n), n, not chroma)
    skip_pix = _upsample(skip8, n)
    var_pix = None if chroma else _upsample(var, 8)
    src = src.to(torch.int32)
    if sampled:
        pp = {**pp, "x": _diag(pp["x"], b),
              "p_pri": [_diag(p, b) for p in pp["p_pri"]],
              "p_sec": [_diag(p, b) for p in pp["p_sec"]]}
        skip_pix = _diag(skip_pix, b)
        var_pix = None if chroma else _diag(var_pix, b)
        src = _diag(src, b)
        dims = (0, 2, 4)
    else:
        h, w = plane.shape
        src = src.reshape(h // b, b, w // b, b)
        dims = (1, 3)
    errs = []
    for c in CDEF_LADDER:
        pri, sec = (c[2], c[3]) if chroma else (c[0], c[1])
        y = _filter_from_prep(pp, skip_pix, pri << shift, sec << shift,
                              damping + shift, var_pix, coeff_shift=shift)
        errs.append(y.to(torch.int32).reshape(src.shape) - src)
    return errs, dims


def _xla_rows_sum(x, lanes: int = 8):
    """x [..., rows, L] summed over its last two dims in f32 as XLA:CPU
    sums a fused reduce whose innermost reduced dim is a row of L: the
    rows in order, each row vectorized over `lanes` lanes (the running
    total enters lane 0, the row's chunks of `lanes` add lane by lane,
    then the lanes fold in halves: 8 -> 4 -> 2 -> 1)."""
    s = torch.zeros(x.shape[:-2], dtype=torch.float32, device=x.device)
    for r in range(x.shape[-2]):
        seg = x[..., r, :].reshape(x.shape[:-2] + (-1, lanes))
        acc = torch.cat([(s + seg[..., 0, 0])[..., None], seg[..., 0, 1:]],
                        -1)
        for c in range(1, seg.shape[-2]):
            acc = acc + seg[..., c, :]
        while acc.shape[-1] > 1:
            k = acc.shape[-1] // 2
            acc = acc[..., :k] + acc[..., k:]
        s = acc[..., 0]
    return s


def cdef_ladder_sse_plain(plane, src, dirs, var, skip8, damping: int,
                          chroma: bool, sampled: bool, bd: int = 8):
    """f32 [8, R, C]: each ladder entry's squared error of one plane
    against `src`, summed over the TL and BR quadrants of each SB
    (sampled: R x C = the SBs) or over each 32-block (32 luma / 16
    chroma px; R x C = the block grid), in the reference's f32 order
    (_xla_rows_sum over each cell's rows: sampled, the TL quadrant's
    then the BR one's). dirs/var/skip8: the luma 8x8 grids; damping:
    the frame's (luma) damping."""
    errs, dims = _ladder_errors(plane, src, dirs, var, skip8, damping,
                                chroma, sampled, bd)
    d = torch.stack(errs).to(torch.float32) ** 2
    if sampled:     # [8, 2, R, b, C, b] -> [8, R, C, 2 b, b]
        d = d.permute(0, 2, 4, 1, 3, 5)
        d = d.reshape(d.shape[:3] + (-1, d.shape[-1]))
    else:           # [8, R, b, C, b] -> [8, R, C, b, b]
        d = d.permute(0, 1, 3, 2, 4)
    return _xla_rows_sum(d)


def cdef_apply_plain(plane, dirs, var, skip8, damping: int, chroma: bool,
                     idx=None, pri: int = 0, sec: int = 0, bd: int = 8):
    """One plane filtered: with each SB's ladder entry idx [nr, nc]
    (64x64 luma SBs), or with the uniform pair (pri, sec) when idx is
    None. The direction is 0 where the primary strength is 0 (spec; the
    reference's `deff`). Returns the plane's dtype."""
    shift = bd - 8
    n, sb = (4, 32) if chroma else (8, 64)
    h, w = plane.shape
    dev = plane.device
    if idx is not None:
        lad = torch.tensor(CDEF_LADDER, dtype=torch.int32, device=dev)
        col = 2 if chroma else 0
        sel = lad[idx.long()]
        pri = _upsample(sel[..., col], sb)[:h, :w] << shift
        sec = _upsample(sel[..., col + 1], sb)[:h, :w] << shift
        d_pix = torch.where(pri > 0, _upsample(dirs, n), 0)
    else:
        pri, sec = pri << shift, sec << shift
        d_pix = (_upsample(dirs, n) if pri > 0
                 else torch.zeros((h, w), dtype=torch.int8, device=dev))
    pp = _prep_plane(plane, d_pix, n, not chroma)
    return _filter_from_prep(pp, _upsample(skip8, n), pri, sec,
                             damping + shift,
                             None if chroma else _upsample(var, 8),
                             coeff_shift=shift)


# ---- the kernels' wrappers --------------------------------------------------

def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cdef_dirs_launch.argtypes = [p, i, i, p, p, p]
    lib.cdef_ladder_sse_launch.argtypes = [p] * 6 + [i, i, p, p, p, i, i, i,
                                                     i, p, p, p]
    lib.cdef_apply_launch.argtypes = [p, p, p, i, i, p, p, p, p, i, i, i, i,
                                      i, p, p, p, p, p]
    for f in (lib.cdef_dirs_launch, lib.cdef_ladder_sse_launch,
              lib.cdef_apply_launch):
        f.restype = ctypes.c_int


def _on_card(t: torch.Tensor, what: str, bd: int) -> bool:
    """False for a CPU tensor (the plain version runs); True for a CUDA
    one (the kernel runs); raises otherwise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {t.device}")
    if bd != 8:
        raise NotImplementedError(
            f"the {what} kernel takes 8-bit planes: bit depth above 8 is "
            "not ported to rav1e_tpu_torch yet: ROADMAP.md queue 1, item 12 "
            "(bd=10)")
    return True


def _ptr(t):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _check_frame(planes, dirs, var, skip8, damping: int):
    """(h, w) of a 4:2:0 frame [y, u, v] in 8x8 luma units whose grids
    (h/8 x w/8, on the frame's device) fit it, with AV1's damping (the
    range the kernels' out-of-frame taps need)."""
    if not 3 <= damping <= 6:
        raise ValueError(f"CDEF damping is 3..6 (AV1), got {damping}")
    if len(planes) != 3:
        raise ValueError(f"a frame is [y, u, v], got {len(planes)} planes")
    y = planes[0]
    h, w = y.shape
    if h % 8 or w % 8:
        raise ValueError(f"luma plane {(h, w)} is not a whole number of "
                         "CDEF units")
    for c in planes[1:]:
        if tuple(c.shape) != (h // 2, w // 2) or c.device != y.device:
            raise ValueError(f"chroma plane {tuple(c.shape)} is not the 4:2:0 "
                             f"half of luma {(h, w)} on its device")
    g = (h // 8, w // 8)
    # the kernels read dirs as int8, var as int32 and skip8's bytes; both
    # routes check
    for a, what, dts in ((dirs, "dirs", (torch.int8,)),
                         (var, "var", (torch.int32,)),
                         (skip8, "skip8", (torch.bool, torch.uint8))):
        if tuple(a.shape) != g or a.device != y.device:
            raise ValueError(f"{what} must be a {g} grid on the plane's "
                             f"device, got {tuple(a.shape)} on {a.device}")
        if a.dtype not in dts:
            raise ValueError(f"{what} must be {' or '.join(map(str, dts))}"
                             f", got {a.dtype}")
    return h, w


def _aligned(planes):
    """The planes from a 16-byte aligned base, as the kernels' vector
    loads read them (a copy only where one is not)."""
    return [p if p.data_ptr() % 16 == 0 else p.clone() for p in planes]


# Blocks that took each path, counted on the card by the kernels: the
# ladder's exact-integer and ordered paths, the apply's filtered and
# copied (SB, plane) pairs. Zero it, run, read it (chip_smoke.py, tests).
PATHS = ("ladder_exact", "ladder_ordered", "apply_filtered", "apply_copied")
_PATH_COUNTS: dict = {}


def path_counts(device) -> torch.Tensor:
    """The int32 [4] path counters of a CUDA device (see PATHS)."""
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in _PATH_COUNTS:
        _PATH_COUNTS[dev] = torch.zeros(4, dtype=torch.int32, device=dev)
    return _PATH_COUNTS[dev]


def cdef_dirs(y, bd: int = 8):
    """(dir int8 [H/8, W/8], var int32 [H/8, W/8]) of the luma plane
    [H, W] (8-bit values). CUDA: the cdef_dirs kernel; CPU: the plain
    version."""
    if y.dim() != 2 or y.shape[0] % 8 or y.shape[1] % 8:
        raise ValueError(f"luma plane must be [H, W] in 8x8 units, got "
                         f"{tuple(y.shape)}")
    if not _on_card(y, "cdef_dirs", bd):
        return cdef_dirs_plain(y, bd)
    lib = nvcc.load(SRC, _bind)
    H, W = y.shape
    # the kernel reads each 8x8 block's row as one 8-byte word
    y8 = _aligned([y.to(torch.uint8).contiguous()])[0]
    with torch.cuda.device(y.device):
        dirs = torch.empty((H // 8, W // 8), dtype=torch.int8,
                           device=y.device)
        var = torch.empty((H // 8, W // 8), dtype=torch.int32,
                          device=y.device)
        _raise_on(lib.cdef_dirs_launch(_ptr(y8), H, W, _ptr(dirs), _ptr(var),
                                       _stream()), "cdef_dirs")
    nvcc.count_launch(cdef_dirs)
    return dirs, var


cdef_dirs.launches = 0


def cdef_ladder_sse(planes, srcs, dirs, var, skip8, damping: int,
                    sampled: bool, bd: int = 8):
    """f32 [3, 8, R, C]: the SSE tables of a 4:2:0 frame's planes
    [y, u, v] against srcs, each cdef_ladder_sse_plain of its plane (R x C
    = the SBs sampled, the 32-blocks full). CUDA: one cdef_ladder_sse
    launch for the three planes; CPU: the plain version per plane."""
    h, w = _check_frame(planes, dirs, var, skip8, damping)
    if [tuple(s.shape) for s in srcs] != [tuple(p.shape) for p in planes] \
            or h % 32 or w % 32:
        raise ValueError(f"planes {[tuple(p.shape) for p in planes]} and "
                         f"sources {[tuple(s.shape) for s in srcs]} must "
                         "match in 32-blocks")
    if sampled and (h % 64 or w % 64):
        raise ValueError("the sampled branch needs whole superblocks")
    if not _on_card(planes[0], "cdef_ladder_sse", bd):
        return torch.stack([
            cdef_ladder_sse_plain(p, s, dirs, var, skip8, damping, i > 0,
                                  sampled, bd)
            for i, (p, s) in enumerate(zip(planes, srcs))])
    lib = nvcc.load(SRC, _bind)
    R, C = (h // 64, w // 64) if sampled else (h // 32, w // 32)
    ps, ss = _aligned(_as_u8(planes)), _aligned(_as_u8(srcs))
    dev = planes[0].device
    with torch.cuda.device(dev):
        out = torch.empty((3, 8, R, C), dtype=torch.float32, device=dev)
        _raise_on(lib.cdef_ladder_sse_launch(
            *map(_ptr, ps), *map(_ptr, ss), h, w, _ptr(dirs.contiguous()),
            _ptr(var.contiguous()), _ptr(skip8.contiguous()), int(damping),
            int(sampled), R, C, _ptr(out), _ptr(path_counts(dev)),
            _stream()), "cdef_ladder_sse")
    nvcc.count_launch(cdef_ladder_sse)
    return out


cdef_ladder_sse.launches = 0


def cdef_apply(planes, dirs, var, skip8, damping: int, idx=None,
               strengths=(0, 0, 0, 0), bd: int = 8):
    """A 4:2:0 frame's planes [y, u, v] filtered, each cdef_apply_plain of
    its plane: with each SB's ladder entry idx [ceil(h/64), ceil(w/64)],
    or with the uniform strengths (y_pri, y_sec, uv_pri, uv_sec) when idx
    is None. CUDA: one cdef_apply launch for the three planes, uint8 out;
    CPU: the plain version per plane, the planes' dtype."""
    h, w = _check_frame(planes, dirs, var, skip8, damping)
    if idx is not None and tuple(idx.shape) != (-(-h // 64), -(-w // 64)):
        raise ValueError(f"idx must be the 64-px SB grid of the frame, got "
                         f"{tuple(idx.shape)}")
    y_pri, y_sec, uv_pri, uv_sec = (int(s) for s in strengths)
    if not _on_card(planes[0], "cdef_apply", bd):
        return [cdef_apply_plain(p, dirs, var, skip8, damping, i > 0, idx,
                                 *((uv_pri, uv_sec) if i else (y_pri, y_sec)),
                                 bd)
                for i, p in enumerate(planes)]
    lib = nvcc.load(SRC, _bind)
    ps = _aligned(_as_u8(planes))
    ix = None if idx is None else idx.to(torch.int32).contiguous()
    dev = planes[0].device
    with torch.cuda.device(dev):
        outs = [torch.empty_like(p) for p in ps]
        _raise_on(lib.cdef_apply_launch(
            *map(_ptr, ps), h, w, _ptr(dirs.contiguous()),
            _ptr(var.contiguous()), _ptr(skip8.contiguous()), _ptr(ix),
            y_pri, y_sec, uv_pri, uv_sec, int(damping), *map(_ptr, outs),
            _ptr(path_counts(dev)[2:]), _stream()), "cdef_apply")
    nvcc.count_launch(cdef_apply)
    return outs


cdef_apply.launches = 0


# ---- the decision between the SSE table and the apply (shared) --------------

def _tree_sum(x, window: int = 32):
    """x.sum(-1) in f32 as XLA:CPU computes jnp.sum over a long axis: its
    tree-reduction rewriter pads the axis with zeros to a multiple of 32
    (half the padding before, the rest after), sums each window of 32
    one add at a time, and reduces the partial sums the same way; 32 or
    fewer are added one at a time."""
    n = x.shape[-1]
    while n > window:
        m = -(-n // window)
        pad = m * window - n
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        x = x.reshape(x.shape[:-1] + (m, window))
        acc = x[..., 0]
        for i in range(1, window):
            acc = acc + x[..., i]
        x, n = acc, m
    acc = x[..., 0]
    for i in range(1, n):
        acc = acc + x[..., i]
    return acc


def _subset_sum(x):
    """x.sum(-1) over the SBs as the reference's fused subset RD sums
    it on XLA:CPU: more than 32 SBs as `_tree_sum`; up to 32 in a loop
    that LLVM vectorizes by the trip count n. Up to 16 over 8 lanes with
    the tail masked (zeros past the end); 17-32 over 8 lanes, or over 4
    where n % 8 >= 4, with the tail added one at a time after. The SBs
    add lane by lane in chunks, then the lanes fold in halves
    (8 -> 4 -> 2 -> 1). Read from the loop's optimized LLVM IR and
    matched at 1-32 and 33-1100 SBs (tests/test_torch_speed6.py)."""
    n = x.shape[-1]
    if n > 32:
        return _tree_sum(x)
    lanes = 4 if n > 16 and n % 8 >= 4 else 8
    body = n if n <= 16 else n - n % lanes
    v = torch.nn.functional.pad(x[..., :body], (0, (-body) % lanes))
    acc = v[..., :lanes]
    for c in range(1, v.shape[-1] // lanes):
        acc = acc + v[..., lanes * c: lanes * c + lanes]
    while acc.shape[-1] > 1:
        k = acc.shape[-1] // 2
        acc = acc[..., :k] + acc[..., k:]
    acc = acc[..., 0]
    for i in range(body, n):
        acc = acc + x[..., i]
    return acc


@lru_cache(maxsize=None)
def _subsets(nsb: int):
    """The nb_strengths RD's static 1-, 2-, 4- and 8-entry subsets of
    the ladder: (masks [S, 8] bool, bits [S] f32 = 12 n + nsb log2 n)."""
    K = len(CDEF_LADDER)
    masks, bits = [], []
    for n in (1, 2, 4, 8):
        for sub in combinations(range(K), n):
            m = np.zeros(K, bool)
            m[list(sub)] = True
            masks.append(m)
            bits.append(12.0 * n + float(nsb) * (0 if n == 1 else np.log2(n)))
    return np.array(masks), np.array(bits, np.float32)


def _sse_sb(f, sampled: bool, nr: int, nc: int):
    """Per-SB f32 SSE [8, nr, nc] from the three planes' f32 tables, in
    the reference's order: 2 (Y + U + V) sampled (half the pixels stand
    for the SB); else Y + U + V per 32-block, then the 2x2 sum (edge SBs
    of frames that are not 64-aligned cover fewer blocks)."""
    if sampled:
        return 2.0 * (f[0] + f[1] + f[2])
    sse32 = f[0] + f[1] + f[2]
    K, nby, nbx = sse32.shape
    ssep = torch.nn.functional.pad(sse32, (0, nc * 2 - nbx, 0, nr * 2 - nby))
    r = ssep.reshape(K, nr, 2, nc, 2)
    return ((r[:, :, 0, :, 0] + r[:, :, 0, :, 1]) + r[:, :, 1, :, 0]
            + r[:, :, 1, :, 1])


def _choose(sse_sb, lam):
    """Each SB's ladder index [nr, nc] int32: the SSE argmin, within the
    subset that minimises total SSE + lam (12 bits per entry + log2 n
    bits per SB) when lam is given (rav1e's nb_strengths search)."""
    K, nr, nc = sse_sb.shape
    if lam is not None:
        dev = sse_sb.device
        m_np, b_np = _subsets(nr * nc)
        masks = torch.as_tensor(m_np, device=dev)
        bits = torch.as_tensor(b_np, device=dev)
        lam = torch.as_tensor(lam, dtype=torch.float32, device=dev)
        flat = sse_sb.reshape(K, nr * nc)
        msse = torch.where(masks[:, :, None], flat[None], torch.inf)
        tot = _subset_sum(torch.amin(msse, 1)) + lam * bits
        allowed = masks[torch.argmin(tot)]
        sse_sb = torch.where(allowed[:, None, None], sse_sb, torch.inf)
    return torch.argmin(sse_sb, dim=0).to(torch.int32)


# ---- the reference's entry points -------------------------------------------

def _as_u8(planes):
    """8-bit planes as the kernels take them, converted once a frame."""
    return [p.to(torch.uint8).contiguous() for p in planes]


def cdef_search_persb(planes, srcs, skip8, damping: int, lam=None,
                      bd: int = 8):
    """Per-64x64-SB CDEF strength-index RDO over the 8-entry ladder
    (the reference's cdef_search_persb_jax). Frames that are 64-aligned
    with 4:2:0 chroma rank the ladder on each SB's TL and BR 32-blocks
    and apply only the winner; others evaluate every 32-block. lam
    enables the nb_strengths subset RD. planes/srcs: [y, u, v]; skip8
    [h/8, w/8] bool. Returns (idx [ceil(h/64), ceil(w/64)] int32,
    filtered planes: uint8 at bd 8, else the input dtype)."""
    if bd == 8:
        planes, srcs = _as_u8(planes), _as_u8(srcs)
    h, w = planes[0].shape
    damping = int(damping)
    dirs, var = cdef_dirs(planes[0], bd)
    sampled = h % 64 == 0 and w % 64 == 0
    sses = cdef_ladder_sse(planes, srcs, dirs, var, skip8, damping, sampled,
                           bd)
    nby, nbx = h // 32, w // 32
    idx = _choose(_sse_sb(sses, sampled, (nby + 1) // 2, (nbx + 1) // 2),
                  lam)
    return idx, cdef_apply(planes, dirs, var, skip8, damping, idx=idx, bd=bd)


def cdef_filter_frame(planes, skip8, y_pri: int, y_sec: int, uv_pri: int,
                      uv_sec: int, damping: int):
    """CDEF with one strength pair per plane kind over the whole frame
    (the reference's cdef_filter_frame_jax). Returns uint8 planes."""
    planes = _as_u8(planes)
    dirs, var = cdef_dirs(planes[0])
    return cdef_apply(planes, dirs, var, skip8, int(damping),
                      strengths=(y_pri, y_sec, uv_pri, uv_sec))
