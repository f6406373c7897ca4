"""Lookahead analysis: per-block ME stats, intra-cost estimates, and
backward importance propagation over the lookahead window.

Reference parity: rav1e src/api/lookahead.rs (compute_motion_vectors,
estimate_intra_costs, estimate_importance_block_difference) and
src/api/internal.rs::compute_block_importances /
src/rdo.rs::DistortionScale. The per-pair ME stats run on the device
for a whole frame pair at once (every block's full-pel search in a few
batched ops); the backward propagation walks the window on the host
(tiny grids).

Block granularity is 16x16 (IMPORTANCE_BLOCK_SIZE in rav1e is 8; 16
matches the inter pipeline's sub-block unit — half the grid, same
propagation semantics).
"""

from __future__ import annotations

import numpy as np
import torch

from rav1e_tpu_torch.device import to_host

BLK = 16         # importance block size (px)
SEARCH = 8       # full-pel lookahead search radius (px)


def _pair_stats_fn(h: int, w: int):
    """(cur, prev) luma [h, w] uint8 tensors on one device -> (mv
    [nby, nbx, 2] int32, inter_cost, intra_cost [nby, nbx] f32) per 16x16
    block, on that device. inter_cost = the SSD of the best full-pel
    match within +-8 px (the previous frame edge-extended); intra_cost =
    the SSD of the DC (mean) prediction residual (estimate_intra_costs
    analog: an upper bound on what intra coding must spend where inter
    prediction fails).

    The SSD is wsq - 2 * corr + sum(blk^2) in f32, formed in that order
    (_ssd_terms: each term exact). The intra cost follows the
    reference's fused loop: the mean, then each (x - mean)^2 fused into
    its lane's running sum (fma) as _rows_in_lanes adds. The first
    minimum wins (argmin), flat content included. Deeper planes raise
    ValueError: the session runs the lookahead on 8-bit 4:2:0 only, as
    the reference's does."""
    nby, nbx = h // BLK, w // BLK
    B = nby * nbx
    span = 2 * SEARCH + 1
    win = 2 * SEARCH + BLK

    def stats(cur, prev):
        dev = cur.device
        if cur.dtype != torch.uint8 or prev.dtype != torch.uint8:
            raise ValueError("the lookahead takes 8-bit planes, not "
                             f"{cur.dtype} / {prev.dtype}")
        cur = cur.to(torch.int32)
        prev = prev.to(torch.int32)
        blks = (cur.reshape(nby, BLK, nbx, BLK).permute(0, 2, 1, 3)
                .reshape(B, BLK, BLK))
        # prev edge-extended by SEARCH px on every side
        rr = torch.arange(-SEARCH, h + SEARCH, device=dev).clamp(0, h - 1)
        cc = torch.arange(-SEARCH, w + SEARCH, device=dev).clamp(0, w - 1)
        pp = prev[rr][:, cc]
        # each block's search window [B, win, win]: rows by*BLK .. +win
        wins = (pp.unfold(0, win, BLK).unfold(1, win, BLK)
                .reshape(B, win, win))
        wsq, corr, bsum = _ssd_terms(blks, wins)
        ssd = ((wsq - 2.0 * corr) + bsum[:, None, None]).reshape(B, -1)
        flat = torch.argmin(ssd, dim=1).to(torch.int32)
        mv = torch.stack([torch.div(flat, span, rounding_mode="floor")
                          - SEARCH, flat % span - SEARCH], 1)
        inter = ssd.min(dim=1).values
        bf = blks.float()
        # the mean's sum is exact (below 2^24) in any order
        mean = bf.sum((1, 2)) * (1.0 / (BLK * BLK))
        d = (bf - mean[:, None, None]).double()
        intra = _rows_in_lanes(d * d)
        return (mv.reshape(nby, nbx, 2), inter.reshape(nby, nbx),
                intra.reshape(nby, nbx))

    return stats


def _ssd_terms(blks, wins):
    """(wsq, corr, sum(blk^2)) as f32 from blks [B, 16, 16] and wins
    [B, 32, 32] int32 of 8-bit planes. Each is summed exactly in int32
    and rounded once, which equals the reference's f32 sums: they stay
    below 2^24."""
    B = blks.shape[0]
    span = 2 * SEARCH + 1
    wsq_rows = wins * wins
    corr = torch.empty((B, span, span), dtype=torch.int32,
                       device=blks.device)
    wsq = torch.empty_like(corr)
    bl = blks[:, :, None, :]
    for dy in range(span):
        rows = wins[:, dy:dy + BLK]                   # [B, 16, win]
        corr[:, dy] = (rows.unfold(2, BLK, 1) * bl).sum((1, 3))
        wsq[:, dy] = wsq_rows[:, dy:dy + BLK].sum(1).unfold(1, BLK, 1).sum(2)
    return wsq.float(), corr.float(), (blks * blks).sum((1, 2)).float()


def _rows_in_lanes(x):
    """x [B, 16, 16] exact f64 squares summed over each block as
    XLA:CPU's fused loop sums them: 8 lanes across rows (lane l takes
    rows l and l + 8, each row's 16 terms one at a time, each added by
    fma: one rounding to f32 a step), then the lanes folded in halves
    (8 -> 4 -> 2 -> 1)."""
    acc = torch.zeros((x.shape[0], 8), dtype=torch.float32, device=x.device)
    for k in range(BLK // 8):
        for c in range(BLK):
            acc = (x[:, 8 * k: 8 * k + 8, c] + acc.double()).float()
    while acc.shape[1] > 1:
        h = acc.shape[1] // 2
        acc = acc[:, :h] + acc[:, h:]
    return acc[:, 0]


def compute_importances(stats: list) -> np.ndarray:
    """Backward importance propagation over the lookahead window.

    stats[i] = (mv, inter_cost, intra_cost) of frame i+1 vs frame i
    (i = 0 is the frame about to be encoded). Walks the window from
    the future back: each block's accumulated importance (plus one
    unit for the block itself) flows to the area of the previous frame
    its motion vector references, weighted by how much of the block's
    signal inter prediction actually explains
    (compute_block_importances in rav1e src/api/internal.rs).
    Returns the importance grid for frame 0."""
    if not stats:
        raise ValueError("need at least one frame pair")
    nby, nbx = stats[0][1].shape
    gy = np.repeat(np.arange(nby), nbx)
    gx = np.tile(np.arange(nbx), nby)
    imp = np.zeros((nby, nbx), np.float64)
    for mv, inter, intra in reversed(stats):
        # propagation fraction: how predictable the block was
        frac = np.clip(1.0 - inter / (intra + 1.0), 0.0, 1.0)
        flow = ((imp + 1.0) * frac).ravel()
        # scatter each block's flow to the up-to-4 blocks its
        # motion-projected footprint overlaps in the previous frame
        # (vectorized: 4 scatter-adds over the whole grid)
        py = np.clip(gy * BLK + mv[..., 0].ravel(), 0, (nby - 1) * BLK)
        px = np.clip(gx * BLK + mv[..., 1].ravel(), 0, (nbx - 1) * BLK)
        b0y, oy = np.divmod(py, BLK)
        b0x, ox = np.divmod(px, BLK)
        nxt = np.zeros((nby, nbx), np.float64)
        for dy, wy in ((0, BLK - oy), (1, oy)):
            for dx, wx in ((0, BLK - ox), (1, ox)):
                ty = np.minimum(b0y + dy, nby - 1)
                tx = np.minimum(b0x + dx, nbx - 1)
                np.add.at(nxt, (ty, tx),
                          flow * (wy * wx) / (BLK * BLK))
        imp = nxt
    return imp


def distortion_scales(imp: np.ndarray, strength: float = 1.0
                      ) -> np.ndarray:
    """Importance grid -> per-block RD distortion weights.

    rav1e's DistortionScale maps propagated importance to a multiplier
    on distortion in every RD decision (important blocks get more
    bits). Normalized so the frame-mean log-scale is 0 — total rate
    stays put, allocation shifts."""
    s = np.power(1.0 + imp, 0.5 * strength)
    s /= np.exp(np.mean(np.log(s)))
    return np.clip(s, 0.25, 4.0).astype(np.float32)


def activity_scales(y: np.ndarray, strength: float = 0.5) -> np.ndarray:
    """Per-16x16 activity masking scales (rav1e src/activity.rs,
    Tune::Psychovisual): low-variance (flat/dark) areas are
    perceptually fragile -> weight their distortion up; high-texture
    areas mask error -> weight down."""
    h, w = y.shape
    ch, cw = h // BLK * BLK, w // BLK * BLK
    b = (np.asarray(y[:ch, :cw], np.float64)
         .reshape(ch // BLK, BLK, cw // BLK, BLK)
         .transpose(0, 2, 1, 3))
    var = b.var(axis=(2, 3)) + 1.0
    s = np.power(var / np.exp(np.mean(np.log(var))), -0.25 * strength)
    return np.clip(s, 0.25, 4.0).astype(np.float32)


def _pair_stats_packed_fn(h: int, w: int):
    """Like _pair_stats_fn but takes two PACKED source buffers
    (pipeline.tpu_inter.pack_src layout, uint8 on the device) so the
    session's single per-frame upload feeds both the lookahead and the
    encode step; the luma (the buffer's first h rows) is cropped to the
    16-grid."""
    ch, cw = h // BLK * BLK, w // BLK * BLK
    inner = _pair_stats_fn(ch, cw)

    def stats(cur_buf, prev_buf):
        return inner(cur_buf[:ch, :cw], prev_buf[:ch, :cw])

    return stats


class Lookahead:
    """Sliding lookahead window over input frames.

    Per-pair ME stats are computed incrementally as frames arrive
    (push_packed, on the device the buffers lie on); `scales()` returns
    the distortion-scale grid for the frame at the current encode
    position, using up to `depth` future pairs; `pop()` advances the
    position. Pushes may run arbitrarily far ahead of pops (stats are
    tiny; frames are not retained). The JAX package's host-plane `push`
    has no caller in a session and is not carried over."""

    def __init__(self, depth: int = 8, tune: str = "psnr"):
        self.depth = depth
        self.tune = tune
        self._prev = None                     # last pushed buffer
        self._pending: list = []              # device stats not fetched
        self._stats: list = []                # stats[i]: f[i+1] vs f[i]

    def push_packed(self, buf, h: int, w: int):
        """buf: device-resident packed source (pack_src layout). The
        stats are queued on the device and fetched lazily (_drain)."""
        if self._prev is not None:
            self._pending.append(
                _pair_stats_packed_fn(h, w)(buf, self._prev))
        self._prev = buf

    def _drain(self):
        for s in self._pending:
            self._stats.append(tuple(to_host(x) for x in s))
        self._pending.clear()

    def pop(self):
        self._drain()
        if self._stats:
            self._stats.pop(0)

    def reset(self):
        self._drain()
        self._stats.clear()

    def scales(self, cur_y: np.ndarray | None = None
               ) -> np.ndarray | None:
        """Distortion-scale grid (16x16 units) for the frame at the
        current encode position; cur_y enables activity masking when
        tune == psychovisual."""
        return self.scales_at(0, cur_y)

    def scales_at(self, k: int, cur_y: np.ndarray | None = None
                  ) -> np.ndarray | None:
        """scales() for the frame k input positions AHEAD of the
        current pop position — reordered (B-pyramid) groups encode
        frames out of input order, but importance propagation always
        runs over the input-order pair chain (rav1e
        compute_block_importances walks input order regardless of
        coding order)."""
        self._drain()
        s = None
        if len(self._stats) > k:
            s = distortion_scales(
                compute_importances(self._stats[k:k + self.depth]))
        if self.tune == "psychovisual" and cur_y is not None:
            a = activity_scales(cur_y)
            s = a if s is None else (s * a).astype(np.float32)
        return s
