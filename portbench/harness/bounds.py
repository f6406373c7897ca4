"""The yardstick of the kernels' roofline shares, frozen here: the H100's
published peaks and the least work of a launch of each hand-written
kernel on its own inputs. Copied from chip_smoke.py (`H100_*`,
`_cdef_ladder_ops` with `_pri_adj`, `_distinct`, `_unit_px`,
`_sampled_mask`, and `_gather_bound`) with the port's constants they read
(`ops/cdef.py::CDEF_LADDER`, `_msb`; `ops/gather.py::_starts`), so that
a change to the program cannot move them. Times in seconds."""

from __future__ import annotations

import torch

H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12     # non-tensor float32 peak (no int32 entry)
# integer instructions a second at most: 132 SMs x 4 schedulers x 32
# lanes x 1.98 GHz boost, one warp instruction a scheduler a clock (the
# float32 peak counts each of these FMA lanes as 2 operations)
H100_INT_OPS_PER_S = H100_F32_OPS_PER_S / 2

CDEF_LADDER = [
    (0, 0, 0, 0), (1, 0, 1, 0), (2, 1, 1, 0), (3, 1, 2, 1),
    (5, 2, 4, 1), (7, 2, 5, 2), (10, 2, 8, 2), (14, 4, 12, 4),
]


def _msb(x):
    """floor(log2(max(x, 1)))."""
    x = torch.clamp(torch.as_tensor(x), min=1).to(torch.float64)
    return (torch.frexp(x)[1] - 1).to(torch.int32)


def _pri_adj(var, pri, chroma: bool):
    """The primary strength per 8x8 unit after luma's variance
    adjustment."""
    if chroma:
        return torch.full_like(var, pri) if isinstance(pri, int) else pri
    v = var.long()
    vs = torch.where((v >> 6) > 0, torch.clamp(_msb(v >> 6).long(), max=12),
                     0)
    return torch.where(v > 0, (pri * (4 + vs) + 8) >> 4, 0)


def _distinct(vals, keep):
    """Per unit, how many distinct values vals [K, ...] takes where keep."""
    v = torch.where(keep, vals, -1).sort(0).values
    new = torch.ones_like(keep)
    new[1:] = v[1:] != v[:-1]
    return (new & (v >= 0)).sum(0)


def _unit_px(mask, units, n):
    """Pixels of each n x n unit that mask covers (all if None)."""
    if mask is None:
        return torch.full(units, n * n, dtype=torch.int64)
    return mask.reshape(units[0], n, units[1], n).sum((1, 3)).long().cpu()


def sampled_mask(h, w, b, dev):
    """The pixels of the TL and BR b x b quadrant of each 2b x 2b SB."""
    r = (torch.arange(h, device=dev) // b) % 2
    c = (torch.arange(w, device=dev) // b) % 2
    return r[:, None] == c[None, :]


def cdef_ladder_ops(var, skip8, chroma: bool, mask) -> int:
    """Integer operations of the 8-entry ladder SSE on these inputs: the
    least work the function needs, each piece of work that entries share
    done once. Per pixel of a unit where some entry filters: the shared
    tap work of the primary taps (where an entry's adjusted primary
    strength is > 0) and of the secondary taps (where one has a secondary
    strength), the window (4, and 8 more with secondary taps); each
    distinct adjusted primary strength's sum over the 4 primary taps (16)
    and each distinct secondary strength's over the 8 secondary taps
    (32); each distinct pair's round and clip and its error against the
    source (1); one multiply-add into each filtering entry's squared-error
    total. Every pixel: the unfiltered error and its multiply-add (2).
    Luma's adjustment: 4 a unit that is not skipped and 2 a unit and
    entry. mask: the pixels the table covers (all if None)."""
    n = 4 if chroma else 8
    units = tuple(skip8.shape)
    keep = ~skip8.bool()
    pa = torch.stack([_pri_adj(var, e[2 if chroma else 0], chroma)
                      for e in CDEF_LADDER]).long()
    sec = torch.tensor([e[3 if chroma else 1] for e in CDEF_LADDER],
                       device=var.device)[:, None, None].expand_as(pa)
    act = keep & ((pa > 0) | (sec > 0))
    pri_on = act & (pa > 0)
    sec_on = act & (sec > 0)
    pairs = _distinct(pa * 8 + sec, act)
    both = _distinct(pa * 8 + sec, pri_on & sec_on)
    per_px = (12 * pri_on.any(0) + (24 + 8) * sec_on.any(0)
              + 4 * act.any(0)
              + 16 * _distinct(pa, pri_on)
              + 32 * _distinct(sec, sec_on)
              + 6 * pairs + both + act.sum(0) + 2)
    px = _unit_px(mask, units, n)
    ops = int((per_px.long().cpu() * px).sum())
    if not chroma:
        ops += int(((px > 0) & keep.cpu()).sum()) * (4 + 2 * len(CDEF_LADDER))
    return ops


def cdef_ladder_bound(shapes, esize: int, var, skip8, sampled: bool,
                      cells) -> float:
    """One cdef_ladder_sse launch (a 4:2:0 frame's three planes of these
    shapes, esize bytes a pixel; cells: each plane's R x C table cells):
    the larger of its operations over the integer peak and its bytes (each
    plane and source read once, the f32 table of 8 entries written) over
    the bandwidth."""
    t_o = t_b = 0.0
    for i, (ph, pw) in enumerate(shapes):
        chroma = i > 0
        mask = (sampled_mask(ph, pw, 16 if chroma else 32, var.device)
                if sampled else None)
        t_o += cdef_ladder_ops(var, skip8, chroma, mask) / H100_INT_OPS_PER_S
        t_b += (2 * esize * ph * pw + 32 * cells[i]) / H100_BYTES_PER_S
    return max(t_o, t_b)


def _starts(s, n: int, P: int):
    """dynamic_slice's start rule along an axis of length n."""
    return torch.clamp(torch.where(s < 0, s + n, s), 0, n - P).long()


def gather_bound(items) -> float:
    """A gather launch's byte bound on its items [(shape, plane key, r0,
    c0, P)]: the patches written, the starts, and each distinct plane's
    elements that the windows cover (clamped as the kernel clamps them),
    read once however many windows of the launch overlap them."""
    nbytes = 0
    covered = {}
    for (H, W), key, r0, c0, P in items:
        B = r0.numel()
        nbytes += 4 * B * P * P + 8 * B
        if key not in covered:
            covered[key] = torch.zeros((H, W), dtype=torch.bool,
                                       device=r0.device)
        ar = torch.arange(P, device=r0.device)
        rr = _starts(r0, H, P)[:, None, None] + ar[None, :, None]
        cc = _starts(c0, W, P)[:, None, None] + ar[None, None, :]
        covered[key][rr, cc] = True
    nbytes += 4 * sum(int(m.sum()) for m in covered.values())
    return nbytes / H100_BYTES_PER_S
