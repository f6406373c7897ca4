"""Deblocking filter in PyTorch (port of rav1e_tpu/ops/tpu/deblock.py).

Whole-frame batched: with a uniform TX grid (spacing >= 8) the filter
reach (±7 luma / ±3 chroma) never overlaps between edges, so ALL
vertical edges filter in one gather/compute/reassemble pass, then all
horizontal edges — the spec's serial edge order is irrelevant here.

Filter levels are 0-d int32 tensors, so the level search stays on the
device with no host round trip until the caller fetches its result.
`deblock_search_tiled` is the search of one tile column of a frame whose
columns run as shards (parallel/tile_encode.py): the reference's
shard_map form, its ppermute halos and psum taken by the shard group it
is given.
"""

from __future__ import annotations

import numpy as np
import torch


def _filter_stack(p, q, limit, blimit, thresh, size, bd=8, mask=None):
    """Spec edge filter over a stack of edge samples. p/q: [M, n] int32,
    p[:, 0] nearest the edge; limit/blimit/thresh int32 (0-d tensors
    or ints). Returns the filtered (p, q)."""
    F = 1 << (bd - 8)
    # spec 7.14.6.2: the level-derived thresholds scale with bit depth
    limit, blimit, thresh = limit * F, blimit * F, thresh * F
    ab = torch.abs
    p0, p1 = p[:, 0], p[:, 1]
    q0, q1 = q[:, 0], q[:, 1]
    fmask = ((ab(p1 - p0) <= limit) & (ab(q1 - q0) <= limit)
             & (ab(p0 - q0) * 2 + torch.div(ab(p1 - q1), 2,
                                            rounding_mode="floor")
                <= blimit))
    if mask is not None:
        fmask = fmask & mask
    if size >= 6:
        p2, q2 = p[:, 2], q[:, 2]
        fmask = fmask & (ab(p2 - p1) <= limit) & (ab(q2 - q1) <= limit)
    if size >= 8:
        p3, q3 = p[:, 3], q[:, 3]
        fmask = fmask & (ab(p3 - p2) <= limit) & (ab(q3 - q2) <= limit)
    hev = (ab(p1 - p0) > thresh) | (ab(q1 - q0) > thresh)

    off = 0x80 * F
    lo, hi = -128 * F, 128 * F - 1

    def c3(x):
        return torch.clamp(x, lo, hi)

    ps1, ps0 = p1 - off, p0 - off
    qs0, qs1 = q0 - off, q1 - off
    fil = torch.where(hev, c3(ps1 - qs1), 0)
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

    def out(orig, cols):
        """orig with columns {i: new} replaced."""
        return torch.stack([cols.get(i, orig[:, i])
                            for i in range(orig.shape[1])], dim=1)

    W = torch.where
    if size == 4:
        sel4 = fmask
        return (out(p, {0: W(sel4, n_p0, p0), 1: W(sel4 & ~hev, n_p1, p1)}),
                out(q, {0: W(sel4, n_q0, q0), 1: W(sel4 & ~hev, n_q1, q1)}))

    if size == 6:
        p2, q2 = p[:, 2], q[:, 2]
        flat = (torch.maximum(
            torch.maximum(ab(p1 - p0), ab(q1 - q0)),
            torch.maximum(ab(p2 - p0), ab(q2 - q0))) <= F)
        w_p1 = r3(p2 * 3 + p1 * 2 + p0 * 2 + q0)
        w_p0 = r3(p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1)
        w_q0 = r3(p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2)
        w_q1 = r3(p0 + q0 * 2 + q1 * 2 + q2 * 3)
        selw = fmask & flat
        sel4 = fmask & ~flat
        return (out(p, {0: W(selw, w_p0, W(sel4, n_p0, p0)),
                        1: W(selw, w_p1, W(sel4 & ~hev, n_p1, p1))}),
                out(q, {0: W(selw, w_q0, W(sel4, n_q0, q0)),
                        1: W(selw, w_q1, W(sel4 & ~hev, n_q1, q1))}))

    p2, p3 = p[:, 2], p[:, 3]
    q2, q3 = q[:, 2], q[:, 3]

    def maxr(*xs):
        m = xs[0]
        for x in xs[1:]:
            m = torch.maximum(m, x)
        return m

    flat = maxr(ab(p1 - p0), ab(q1 - q0), ab(p2 - p0),
                ab(q2 - q0), ab(p3 - p0), ab(q3 - q0)) <= F
    e_p2 = r3(p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0)
    e_p1 = r3(p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1)
    e_p0 = r3(p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2)
    e_q0 = r3(p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3)
    e_q1 = r3(p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3)
    e_q2 = r3(p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3)

    if size == 8:
        selw = fmask & flat
        sel4 = fmask & ~flat
        return (out(p, {2: W(selw, e_p2, p2),
                        1: W(selw, e_p1, W(sel4 & ~hev, n_p1, p1)),
                        0: W(selw, e_p0, W(sel4, n_p0, p0))}),
                out(q, {0: W(selw, e_q0, W(sel4, n_q0, q0)),
                        1: W(selw, e_q1, W(sel4 & ~hev, n_q1, q1)),
                        2: W(selw, e_q2, q2)}))

    assert size == 14
    p4, p5, p6 = p[:, 4], p[:, 5], p[:, 6]
    q4, q5, q6 = q[:, 4], q[:, 5], q[:, 6]
    flat2 = maxr(ab(p4 - p0), ab(q4 - q0), ab(p5 - p0),
                 ab(q5 - q0), ab(p6 - p0), ab(q6 - q0)) <= F
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

    def side(w14, e8, n4, orig, w3, w4, w5, o3, o4, o5):
        c0 = W(sel4, n4[0], W(sel14, w14[0], W(sel8, e8[0], orig[0])))
        c1 = W(sel4 & ~hev, n4[1],
               W(sel14, w14[1], W(sel8, e8[1], orig[1])))
        c2 = W(sel14, w14[2], W(sel8, e8[2], orig[2]))
        return {0: c0, 1: c1, 2: c2, 3: W(sel14, w3, o3),
                4: W(sel14, w4, o4), 5: W(sel14, w5, o5)}

    return (out(p, side((w_p0, w_p1, w_p2), (e_p0, e_p1, e_p2),
                        (n_p0, n_p1), (p0, p1, p2), w_p3, w_p4, w_p5,
                        p3, p4, p5)),
            out(q, side((w_q0, w_q1, w_q2), (e_q0, e_q1, e_q2),
                        (n_q0, n_q1), (q0, q1, q2), w_q3, w_q4, w_q5,
                        q3, q4, q5)))


def _levels_to_thresholds(level):
    """sharpness=0 thresholds (ops.ref.deblock._thresholds)."""
    limit = torch.clamp(level, min=1)
    blimit = 2 * (level + 2) + limit
    thresh = level >> 4
    return limit, blimit, thresh


def deblock_plane(plane, block: int, level_v, level_h, is_luma: bool,
                  bd: int = 8, split_map=None, outer_block: int = 32,
                  merge_map=None, sub_map=None, edge_on_v=None):
    """Filter one plane (the reference's deblock_plane_jax). plane
    [H, W] int32; level_v/level_h 0-d int32 tensors, 0 disables.
    split_map: bool [bh, bw] per outer block — inner edges filter only
    where set. merge_map: bool [nr, nc] per 64x64 SB — PARTITION_NONE
    at 64 removes the SB's inner 32-level edges (no longer block edges in
    the stream).

    sub_map: bool [H//cs, W//cs] with cs = block//2 — cells whose TX is
    the half size (16x16 quads split to four 8x8 blocks: TX_8X8 luma /
    TX_4X4 chroma). The filter length follows the MIN adjacent TX (spec
    7.14.5): block-grid edges flanked by a sub cell drop 14->8 taps
    (luma) / 6->4 (chroma) per row, and half-spacing interior edges
    appear inside sub quads (8-tap luma / 4-tap chroma). At 4:2:0 the
    luma 8-cell grid and the chroma 4-cell grid coincide, so one
    [H/8, W/8] map serves all three planes.

    edge_on_v: bool [E] over the vertical block-grid edges (columns
    block, 2 block, ...): an edge filters only where set (the tiled
    search's shard boundaries at a frame edge). The reference's
    edge_on_h has no caller and is not carried over."""
    H, W = plane.shape
    size = 14 if is_luma else 6
    n = size // 2
    size2 = 8 if is_luma else 4   # sub-TX filter + its sample span
    n2 = size2 // 2
    cs = block // 2               # sub-TX extent on this plane
    ob = outer_block if is_luma else outer_block // 2
    sb = 2 * ob                   # 64x64 SB extent on this plane
    dev = plane.device
    out = plane

    def edge_mask(pos, axis_len, ax):
        # [axis_len, E] active mask per edge from split_map / merge_map
        if split_map is None and merge_map is None:
            return None
        ones = torch.ones(axis_len, dtype=torch.bool, device=dev)
        ms = []
        for x in pos:
            if x % ob != 0:
                if split_map is None:
                    ms.append(ones)
                    continue
                line = split_map[:, x // ob] if ax == 0 else \
                    split_map[x // ob, :]
                ms.append(torch.repeat_interleave(line, ob)[:axis_len])
            elif merge_map is not None and x % sb != 0:
                line = merge_map[:, x // sb] if ax == 0 else \
                    merge_map[x // sb, :]
                ms.append(~torch.repeat_interleave(line, sb)[:axis_len])
            else:
                ms.append(ones)
        return torch.stack(ms, dim=1)

    def two_lengths(pf, qf, m, small, limit, blimit, thresh):
        """The grid edges' filter: `size` taps, or `size2` on the rows
        where `small` [M] (a sub cell flanks the edge)."""
        if small is None:
            return _filter_stack(pf, qf, limit, blimit, thresh, size, bd, m)
        m_big = ~small if m is None else (m & ~small)
        m_small = small if m is None else (m & small)
        np_, nq = _filter_stack(pf, qf, limit, blimit, thresh, size, bd,
                                m_big)
        np2, nq2 = _filter_stack(pf[:, :n2], qf[:, :n2], limit, blimit,
                                 thresh, size2, bd, m_small)
        sc = small[:, None]
        np_ = torch.cat([torch.where(sc, np2, np_[:, :n2]), np_[:, n2:]], 1)
        nq = torch.cat([torch.where(sc, nq2, nq[:, :n2]), nq[:, n2:]], 1)
        return np_, nq

    # Uniform edge spacing: the p/q samples of ALL edges are pure slices
    # of the [.., G, block] group reshape, and the filtered plane
    # reassembles by concatenation.
    assert block >= size, (block, size)
    xs = np.arange(block, W, block)
    if len(xs):
        assert W % block == 0, (W, block)
        E = len(xs)
        limit, blimit, thresh = _levels_to_thresholds(level_v)
        g = out.reshape(H, W // block, block)
        p = g[:, :-1, block - n:].flip(-1)            # [H, E, n]
        q = g[:, 1:, :n]
        m = edge_mask(xs, H, 0)
        if edge_on_v is not None:
            eo = torch.broadcast_to(edge_on_v[None, :], (H, E))
            m = eo if m is None else (m & eo)
        small = None
        if sub_map is not None:
            ix = torch.as_tensor(xs // cs, device=dev)
            sm = sub_map[:, ix - 1] | sub_map[:, ix]     # [H//cs, E]
            small = torch.repeat_interleave(sm, cs, 0)[:H].reshape(-1)
        pf = p.reshape(-1, n)
        qf = q.reshape(-1, n)
        np_, nq = two_lengths(pf, qf, None if m is None else m.reshape(-1),
                              small, limit, blimit, thresh)
        on = level_v > 0
        np_ = torch.where(on, np_, pf).reshape(H, E, n).flip(-1)
        nq = torch.where(on, nq, qf).reshape(H, E, n)
        q_side = torch.cat([g[:, :1, :n], nq], dim=1)
        p_side = torch.cat([np_, g[:, -1:, block - n:]], dim=1)
        out = torch.cat([q_side, g[:, :, n:block - n], p_side],
                        dim=2).reshape(H, W)

    if sub_map is not None and W >= 2 * block:
        # interior half-spacing vertical edges (one per block group, at
        # column k*block + cs): only inside sub quads, where both flanks
        # are sub TXs, so one size2 pass
        limit, blimit, thresh = _levels_to_thresholds(level_v)
        g = out.reshape(H, W // block, block)
        p = g[:, :, cs - n2: cs].flip(-1)             # [H, G, n2]
        q = g[:, :, cs: cs + n2]
        ec = torch.as_tensor((np.arange(W // block) * block + cs) // cs,
                             device=dev)
        sm = sub_map[:, ec - 1] & sub_map[:, ec]
        m = torch.repeat_interleave(sm, cs, 0)[:H].reshape(-1)
        pf, qf = p.reshape(-1, n2), q.reshape(-1, n2)
        np_, nq = _filter_stack(pf, qf, limit, blimit, thresh, size2, bd, m)
        on = level_v > 0
        np_ = torch.where(on, np_, pf).reshape(H, -1, n2).flip(-1)
        nq = torch.where(on, nq, qf).reshape(H, -1, n2)
        out = torch.cat([g[:, :, :cs - n2], np_, nq, g[:, :, cs + n2:]],
                        dim=2).reshape(H, W)

    ys = np.arange(block, H, block)
    if len(ys):
        assert H % block == 0, (H, block)
        E = len(ys)
        limit, blimit, thresh = _levels_to_thresholds(level_h)
        g = out.reshape(H // block, block, W)
        # [E, n, W] with row 0 nearest the edge -> [W, E, n]
        p = g[:-1, block - n:, :].flip(1).permute(2, 0, 1)
        q = g[1:, :n, :].permute(2, 0, 1)
        m = edge_mask(ys, W, 1)
        small = None
        if sub_map is not None:
            iy = torch.as_tensor(ys // cs, device=dev)
            sm = sub_map[iy - 1, :] | sub_map[iy, :]     # [E, W//cs]
            small = torch.repeat_interleave(sm, cs, 1)[:, :W].T.reshape(-1)
        pf = p.reshape(-1, n)
        qf = q.reshape(-1, n)
        np_, nq = two_lengths(pf, qf, None if m is None else m.reshape(-1),
                              small, limit, blimit, thresh)
        on = level_h > 0
        np_ = (torch.where(on, np_, pf).reshape(W, E, n).flip(-1)
               .permute(1, 2, 0))
        nq = torch.where(on, nq, qf).reshape(W, E, n).permute(1, 2, 0)
        q_side = torch.cat([g[:1, :n, :], nq], dim=0)
        p_side = torch.cat([np_, g[-1:, block - n:, :]], dim=0)
        out = torch.cat([q_side, g[:, n:block - n, :], p_side],
                        dim=1).reshape(H, W)

    if sub_map is not None and H >= 2 * block:
        # interior half-spacing horizontal edges inside sub quads
        limit, blimit, thresh = _levels_to_thresholds(level_h)
        g = out.reshape(H // block, block, W)
        p = g[:, cs - n2: cs, :].flip(1).permute(2, 0, 1)   # [W, G, n2]
        q = g[:, cs: cs + n2, :].permute(2, 0, 1)
        er = torch.as_tensor((np.arange(H // block) * block + cs) // cs,
                             device=dev)
        sm = sub_map[er - 1, :] & sub_map[er, :]            # [G, W//cs]
        m = torch.repeat_interleave(sm, cs, 1)[:, :W].T.reshape(-1)
        G = H // block
        pf, qf = p.reshape(-1, n2), q.reshape(-1, n2)
        np_, nq = _filter_stack(pf, qf, limit, blimit, thresh, size2, bd, m)
        on = level_h > 0
        np_ = (torch.where(on, np_, pf).reshape(W, G, n2).flip(-1)
               .permute(1, 2, 0))
        nq = torch.where(on, nq, qf).reshape(W, G, n2).permute(1, 2, 0)
        out = torch.cat([g[:, :cs - n2, :], np_, nq, g[:, cs + n2:, :]],
                        dim=1).reshape(H, W)
    return out


def deblock_frame(planes, level_y, level_uv, block_y: int = 32,
                  block_c: int = 16, bd: int = 8, split_map=None,
                  sub_map=None, merge_map=None):
    """Deblock [y, u, v] (the reference's deblock_frame_jax)."""
    return [deblock_plane(p, blk, lvl, lvl, i == 0, bd, split_map,
                          merge_map=merge_map, sub_map=sub_map)
            for i, (p, blk, lvl) in enumerate(
                zip(planes, (block_y, block_c, block_c),
                    (level_y, level_uv, level_uv)))]


def deblock_search(planes, srcs, base_level, block_y: int = 32,
                   block_c: int = 16, bd: int = 8, split_map=None,
                   sub_map=None, merge_map=None):
    """Whole-frame deblock level search: try a fixed ladder of scale
    factors around the q-derived level, pick the one minimizing the
    f32 SSE vs source (`torch.argmin` takes the first minimum, as
    `jnp.argmin`). Returns (level chosen, 0-d int32 tensor; filtered
    planes).

    For H >= 256 the candidate SSEs are ESTIMATED on a 64-aligned
    centre row band (~1/3 of the frame) and only the winner filters
    the whole frame."""
    dev = planes[0].device
    scales = torch.tensor([0.0, 0.5, 1.0, 1.5, 2.0], dtype=torch.float32,
                          device=dev)
    base = torch.as_tensor(base_level, dtype=torch.int32, device=dev)
    cand = torch.clamp((scales * base).to(torch.int32), 0, 63)
    H = planes[0].shape[0]
    lo = (H // 3) // 64 * 64
    hi = max(lo + 64, (2 * H // 3) // 64 * 64)
    if hi < H and H >= 256:
        planes_c = [planes[0][lo:hi], planes[1][lo >> 1: hi >> 1],
                    planes[2][lo >> 1: hi >> 1]]
        srcs_c = [srcs[0][lo:hi], srcs[1][lo >> 1: hi >> 1],
                  srcs[2][lo >> 1: hi >> 1]]
        split_c = (split_map[lo // 32: hi // 32]
                   if split_map is not None else None)
        merge_c = (merge_map[lo // 64: hi // 64]
                   if merge_map is not None else None)
        sub_c = sub_map[lo // 8: hi // 8] if sub_map is not None else None
    else:
        planes_c, srcs_c = planes, srcs
        split_c, merge_c, sub_c = split_map, merge_map, sub_map

    def est(level):
        o = deblock_frame(planes_c, level, level, block_y, block_c, bd,
                          split_c, sub_c, merge_c)
        sse = None
        for a, s in zip(o, srcs_c):
            e = torch.sum((a - s).to(torch.float32) ** 2)
            sse = e if sse is None else sse + e
        return sse

    sses = torch.stack([est(cand[i]) for i in range(cand.shape[0])])
    best = cand[torch.argmin(sses)]
    return best, deblock_frame(planes, best, best, block_y, block_c, bd,
                               split_map, sub_map, merge_map)


def deblock_search_tiled(planes, srcs, base_level, split_grid, group,
                         bd: int = 8):
    """The deblock level search of one tile column (the reference's
    deblock_search_tiled, its shard_map body): planes / srcs are this
    shard's [y, u, v] column slices (int32, on its device), split_grid
    its [nby, nbx_t] split map, `group` the frame's shard group
    (parallel/tiles.py: T, index, shift_right / shift_left for the
    ppermute, psum). The 32 / 16 px halo columns come once from the
    neighbours (they do not depend on the level), then each candidate
    level filters the extended planes on the 16 / 8 px edge grid.
    Boundary edges between shards are computed by both neighbours (each
    keeps its own side); the frame's outer edges are off. The
    candidates' f32 SSEs are summed over the shards (in shard order)
    before the argmin, so every shard takes the frame's level. Returns
    (level, 0-d int32; this shard's filtered planes)."""
    tw = planes[0].shape[1]
    dev = planes[0].device

    def halo_ext(x, hw):
        left = group.shift_right(x[:, -hw:])
        right = group.shift_left(x[:, :hw])
        return torch.cat([left, x, right], dim=1)

    ye = halo_ext(planes[0], 32)
    ue = halo_ext(planes[1], 16)
    ve = halo_ext(planes[2], 16)
    sg = halo_ext(split_grid, 1)
    first, last = group.index == 0, group.index == group.T - 1

    def edge_on(w_ext, block, lo, hi):
        eo = torch.ones(len(range(block, w_ext, block)), dtype=torch.bool,
                        device=dev)
        eo[lo // block - 1] = not first
        eo[hi // block - 1] = not last
        return eo

    eo_y = edge_on(64 + tw, 16, 32, 32 + tw)
    eo_c = edge_on(32 + tw // 2, 8, 16, 16 + tw // 2)
    scales = torch.tensor([0.0, 0.5, 1.0, 1.5, 2.0], dtype=torch.float32,
                          device=dev)
    base = torch.as_tensor(base_level, dtype=torch.int32, device=dev)
    cand = torch.clamp((scales * base).to(torch.int32), 0, 63)
    outs, sses = [], []
    for i in range(cand.shape[0]):
        lvl = cand[i]
        o = [deblock_plane(ye, 16, lvl, lvl, True, bd, sg, 32,
                           edge_on_v=eo_y)[:, 32:32 + tw],
             deblock_plane(ue, 8, lvl, lvl, False, bd, sg, 32,
                           edge_on_v=eo_c)[:, 16:16 + tw // 2],
             deblock_plane(ve, 8, lvl, lvl, False, bd, sg, 32,
                           edge_on_v=eo_c)[:, 16:16 + tw // 2]]
        sse = None
        for a, s in zip(o, srcs):
            e = torch.sum((a - s).to(torch.float32) ** 2)
            sse = e if sse is None else sse + e
        outs.append(o)
        sses.append(sse)
    k = torch.argmin(group.psum(torch.stack(sses)))
    return cand[k], [torch.stack([o[j] for o in outs])[k] for j in range(3)]
