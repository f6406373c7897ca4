"""Reference intra (KEY) frame encoder — numpy, serial, conformant.

Reference parity: rav1e src/encoder.rs encode_frame for keyframes with
a fixed partition plan (this first slice: 32x32 blocks, DC prediction,
DCT only, TX_MODE_LARGEST). The encoder reconstructs exactly as the
decoder will (predict from recon edges -> quantize -> dequant ->
inverse transform -> clip), which the dav1d oracle verifies bit-exact.

This serial version defines behavior for the batched TPU pipeline.
"""

from __future__ import annotations

import numpy as np

from rav1e_tpu_torch.core.constants import (
    ANGLE_BASE,
    MAX_TX_SIZE_RECT,
    BlockSize,
    FrameType,
    PartitionType,
    PredictionMode,
    TxType,
    subsize,
)
from rav1e_tpu_torch.entropy.obu import FrameParams, Sequence, TileInfo, keyframe_packet
from rav1e_tpu_torch.entropy.tile import (
    BlockDecision,
    TileWriter,
    chroma_tx_size,
    chroma_tx_type,
)
from rav1e_tpu_torch.ops.ref.intra import predict
from rav1e_tpu_torch.ops.ref.quant import dequantize, quantize
from rav1e_tpu_torch.ops.ref.transforms import forward_transform, inverse_transform


class PlaneState:
    def __init__(self, src: np.ndarray):
        self.src = src.astype(np.int32)
        self.rec = np.zeros_like(self.src)
        # decoded bitmap at 4-px-unit resolution (spec BlockDecoded):
        # edge availability (above-right / below-left) follows decode
        # order exactly, which this map reproduces
        self.dec = np.zeros(((self.src.shape[0] + 3) // 4,
                             (self.src.shape[1] + 3) // 4), bool)


def _edges(ps: PlaneState, x: int, y: int, w: int, h: int, bd: int = 8):
    """Spec 7.11.2 edge assembly: above/left extended to w+h with
    above-right / below-left availability from the decoded map, frame
    clamping, and replication. The above-right pixels read stop at
    x + 2w - 1 and the below-left ones at y + 2h - 1 (the spec's
    aboveLimit / leftLimit), within the w + h of each edge; the JAX
    package's copy reads h above-right and w below-left pixels, which
    decoders do not on rectangular (4:2:2 chroma) blocks."""
    ph, pw = ps.src.shape
    have_a, have_l = y > 0, x > 0
    above = left = None
    top_left = None
    if have_a:
        n = min(w, pw - x)
        a = ps.rec[y - 1, x: x + n].astype(np.int32)
        if n < w:
            a = np.concatenate([a, np.full(w - n, a[-1])])
        # above-right: one flag for the whole extension
        uy, ux = y // 4 - 1, (x + w) // 4
        has_tr = (ux < ps.dec.shape[1] and ps.dec[uy, ux])
        if has_tr:
            n2 = min(w, h, pw - (x + w))
            if n2 > 0:
                a = np.concatenate(
                    [a, ps.rec[y - 1, x + w: x + w + n2]])
        a = np.concatenate([a, np.full(w + h - len(a), a[-1])])
        above = a
    if have_l:
        n = min(h, ph - y)
        ll = ps.rec[y: y + n, x - 1].astype(np.int32)
        if n < h:
            ll = np.concatenate([ll, np.full(h - n, ll[-1])])
        uy, ux = (y + h) // 4, x // 4 - 1
        has_bl = (uy < ps.dec.shape[0] and ps.dec[uy, ux])
        if has_bl:
            n2 = min(w, h, ph - (y + h))
            if n2 > 0:
                ll = np.concatenate(
                    [ll, ps.rec[y + h: y + h + n2, x - 1]])
        ll = np.concatenate([ll, np.full(w + h - len(ll), ll[-1])])
        left = ll
    # spec fill for missing edges: replicate the other edge's first
    # pixel (proven against both oracles in the TPU wavefront path).
    # DC must still average only truly-available sides, hence the
    # explicit availability flags in the return.
    if above is None and left is not None:
        above = np.full(w + h, left[0], np.int32)
    if left is None and above is not None:
        left = np.full(w + h, above[0], np.int32)
    if have_a and have_l:
        top_left = int(ps.rec[y - 1, x - 1])
    elif have_a or have_l:
        top_left = int(above[0] if have_a else left[0])
    return above, left, top_left, have_a, have_l


def _encode_block_plane(ps: PlaneState, x: int, y: int, tx, tx_type,
                        mode: PredictionMode, qindex: int, bd: int = 8):
    h, w = tx.height, tx.width
    above, left, top_left, av_a, av_l = _edges(ps, x, y, w, h, bd)
    pred = predict(mode, w, h, above, left, top_left, bd,
                   have_above=av_a, have_left=av_l)
    resid = ps.src[y: y + h, x: x + w] - pred
    cf = forward_transform(resid, tx, tx_type)
    levels = quantize(cf, qindex, tx)
    dq = dequantize(levels, qindex, tx)
    r2 = inverse_transform(dq, tx, tx_type)
    rec = np.clip(pred + r2, 0, (1 << bd) - 1)
    ps.rec[y: y + h, x: x + w] = rec
    ps.dec[y // 4: (y + h) // 4, x // 4: (x + w) // 4] = True
    return levels, pred


def encode_keyframe(planes: list[np.ndarray], qindex: int = 100,
                    block: BlockSize = BlockSize.B32X32,
                    tile_cols_log2: int = 0, tile_rows_log2: int = 0,
                    cdef: tuple | None = None, bit_depth: int = 8,
                    chroma_sampling: str = "420",
                    film_grain=None, lr: bool = False,
                    aq: bool = False, edge_filter: bool = True,
                    render_size: tuple | None = None,
                    seq_extra: dict | None = None,
                    part_rdo: bool = False,
                    angle_deltas: bool = True, device=None):
    """Encode one 8-bit 4:2:0 KEY frame. Returns (packet, recon planes).

    planes: [y (h,w), u, v] uint8, dims multiples of 8. Tile counts are
    powers of two (uniform spacing, spec 5.9.15); each tile encodes
    independently. With lr, the loop-restoration search of an 8-bit
    frame runs on `device` (cuda unless device="cpu"; pipeline/lr.py),
    the rest on the host.
    """
    y, u, v = planes
    h, w = y.shape
    assert h % 8 == 0 and w % 8 == 0
    ss_x, ss_y = {"420": (1, 1), "422": (1, 0), "444": (0, 0)}[
        chroma_sampling]
    profile = 0
    if chroma_sampling == "444":
        profile = 1
    if chroma_sampling == "422" or bit_depth == 12:
        profile = 2
    seq = Sequence(width=w, height=h, enable_cdef=cdef is not None,
                   bit_depth=bit_depth, profile=profile,
                   subsampling_x=ss_x, subsampling_y=ss_y,
                   film_grain_params_present=film_grain is not None,
                   enable_restoration=lr,
                   enable_intra_edge_filter=edge_filter)
    for k, v_ in (seq_extra or {}).items():
        setattr(seq, k, v_)
    fp = FrameParams(frame_type=FrameType.KEY, base_q_idx=qindex,
                     render_size=render_size)
    fp.film_grain = film_grain
    # variance AQ: 4 active segments with ALT_Q deltas; per-block ids
    # are chosen inside the tile from source activity
    seg_alt_q = [-18, -6, 6, 18, None, None, None, None] if aq else None
    fp.seg_alt_q = seg_alt_q
    if lr:
        assert tile_cols_log2 == 0 and tile_rows_log2 == 0, \
            "LR with multi-tile lands later"
        fp.lr_types = (1, 0, 0)  # SWITCHABLE luma, none chroma
    if cdef is not None:
        (fp.cdef_y_pri, fp.cdef_y_sec, fp.cdef_uv_pri,
         fp.cdef_uv_sec, fp.cdef_damping) = cdef
    ti = TileInfo(seq, tile_cols_log2, tile_rows_log2)
    frame_rec = [np.zeros(y.shape, np.int32),
                 np.zeros(u.shape, np.int32),
                 np.zeros(v.shape, np.int32)]
    skip_mi = np.zeros((h >> 2, w >> 2), bool)
    tiles = []
    for t_r in range(ti.n_rows):
        for t_c in range(ti.n_cols):
            mi_r0 = min(ti.row_starts[t_r] * 16, h >> 2)
            mi_r1 = min(ti.row_starts[t_r + 1] * 16, h >> 2)
            mi_c0 = min(ti.col_starts[t_c] * 16, w >> 2)
            mi_c1 = min(ti.col_starts[t_c + 1] * 16, w >> 2)
            py0, py1 = mi_r0 * 4, mi_r1 * 4
            px0, px1 = mi_c0 * 4, mi_c1 * 4
            cy0, cy1 = py0 >> ss_y, py1 >> ss_y
            cx0, cx1 = px0 >> ss_x, px1 >> ss_x
            tw_t, parts_t, blocks_t, recs, tskip = _encode_keyframe_tile(
                [y[py0:py1, px0:px1], u[cy0:cy1, cx0:cx1],
                 v[cy0:cy1, cx0:cx1]],
                qindex, block, bit_depth, ss_x, ss_y,
                seg_alt_q=seg_alt_q, edge_filter=edge_filter,
                part_rdo=part_rdo, angle_deltas=angle_deltas)
            tiles.append((tw_t, parts_t, blocks_t))
            frame_rec[0][py0:py1, px0:px1] = recs[0]
            frame_rec[1][cy0:cy1, cx0:cx1] = recs[1]
            frame_rec[2][cy0:cy1, cx0:cx1] = recs[2]
            skip_mi[mi_r0:mi_r1, mi_c0:mi_c1] = tskip
    # LR reads the deblocked planes before CDEF beyond each stripe
    pre = ([p.copy() for p in frame_rec] if lr and cdef is not None
           else None)
    if cdef is not None:
        from rav1e_tpu_torch.ops.ref.cdef import cdef_filter_frame
        skip8 = skip_mi[::2, ::2] & skip_mi[1::2, ::2] \
            & skip_mi[::2, 1::2] & skip_mi[1::2, 1::2]
        cdef_filter_frame(frame_rec, skip8, fp.cdef_y_pri, fp.cdef_y_sec,
                          fp.cdef_uv_pri, fp.cdef_uv_sec,
                          fp.cdef_damping, bd=bit_depth, ss_x=ss_x,
                          ss_y=ss_y)
    if lr:
        from rav1e_tpu_torch.pipeline.lr import apply_lr_frame
        fp.lr_types = apply_lr_frame(frame_rec, [y, u, v],
                                     tiles[0][0], bit_depth,
                                     ss_x, ss_y, device=device, pre=pre)
    tile_bytes = [tw_t.write_tile(p_t, b_t)
                  for tw_t, p_t, b_t in tiles]
    pkt = keyframe_packet(seq, fp, ti, tile_bytes)
    return pkt, frame_rec


def _encode_keyframe_tile(planes, qindex: int, block: BlockSize,
                          bit_depth: int = 8, ss_x: int = 1,
                          ss_y: int = 1, lr: bool = False,
                          seg_alt_q: list | None = None,
                          edge_filter: bool = True,
                          part_rdo: bool = False,
                          angle_deltas: bool = True):
    """Encode one tile (tiles are fully independent: prediction and
    entropy context never cross the boundary, so a tile encodes exactly
    like a small frame). Returns (tile bytes, recon planes)."""
    y, u, v = planes
    h, w = y.shape
    mi_rows, mi_cols = h >> 2, w >> 2
    tw = TileWriter(mi_rows, mi_cols, qindex, ss_x=ss_x, ss_y=ss_y,
                    seg_alt_q=seg_alt_q)
    states = [PlaneState(y), PlaneState(u), PlaneState(v)]
    # variance AQ: per-32x32 source activity -> quartile segment map
    qcell = {"q": qindex}
    seg_map = None
    if seg_alt_q is not None:
        n_sr, n_sc = (h + 31) // 32, (w + 31) // 32
        var = np.zeros((n_sr, n_sc))
        for sr in range(n_sr):
            for sc in range(n_sc):
                blk = y[sr * 32: sr * 32 + 32,
                        sc * 32: sc * 32 + 32].astype(np.float64)
                var[sr, sc] = blk.var()
        qs = np.quantile(var, (0.25, 0.5, 0.75)) if var.size > 1 else \
            (var.flat[0],) * 3
        seg_map = np.digitize(var, qs).astype(np.int8)
    y_modes = [
        PredictionMode.DC_PRED, PredictionMode.V_PRED,
        PredictionMode.H_PRED, PredictionMode.D45_PRED,
        PredictionMode.D135_PRED, PredictionMode.D113_PRED,
        PredictionMode.D157_PRED, PredictionMode.D203_PRED,
        PredictionMode.D67_PRED, PredictionMode.SMOOTH_PRED,
        PredictionMode.SMOOTH_V_PRED, PredictionMode.SMOOTH_H_PRED,
        PredictionMode.PAETH_PRED,
    ]
    uv_modes = y_modes

    partitions: dict = {}
    blocks: dict = {}

    bw_mi = block.width_mi

    # ---- RD bookkeeping for partition-shape search --------------------
    # (rav1e src/rdo.rs rdo_partition_decision: NONE vs HORZ vs VERT vs
    # SPLIT priced at sse + lambda*bits with real writer-rate tables)
    from rav1e_tpu_torch.entropy.cost import (estimate_block_bits_np,
                                        mode_cost_tables, rd_lambda,
                                        tx_block_cost_luts)
    lam = rd_lambda(qindex, bit_depth)
    _mc = mode_cost_tables()
    _luts: dict = {}

    def lv_bits(lv, tx, tt, plane):
        key = (int(tx), int(tt), 0 if plane == 0 else 1)
        if key not in _luts:
            _luts[key] = tx_block_cost_luts(qindex, tx, tt, plane)
        return estimate_block_bits_np(lv, _luts[key])

    def _snapshot(r: int, c: int, n: int = 32):
        y0, x0 = r * 4, c * 4
        snap = []
        for pi, ps in enumerate(states):
            sx = 0 if pi == 0 else ss_x
            sy = 0 if pi == 0 else ss_y
            xx, yy = x0 >> sx, y0 >> sy
            hh, ww = n >> sy, n >> sx
            snap.append((ps.rec[yy: yy + hh, xx: xx + ww].copy(),
                         ps.dec[yy // 4: (yy + hh) // 4,
                                xx // 4: (xx + ww) // 4].copy()))
        nmi = n >> 2
        return (snap, ymode_grid[r: r + nmi, c: c + nmi].copy(),
                uvmode_grid[r: r + nmi, c: c + nmi].copy())

    def _restore(r: int, c: int, saved, n: int = 32):
        snap, ymg, uvmg = saved
        y0, x0 = r * 4, c * 4
        for pi, ps in enumerate(states):
            sx = 0 if pi == 0 else ss_x
            sy = 0 if pi == 0 else ss_y
            xx, yy = x0 >> sx, y0 >> sy
            hh, ww = n >> sy, n >> sx
            ps.rec[yy: yy + hh, xx: xx + ww] = snap[pi][0]
            ps.dec[yy // 4: (yy + hh) // 4,
                   xx // 4: (xx + ww) // 4] = snap[pi][1]
        nmi = n >> 2
        ymode_grid[r: r + nmi, c: c + nmi] = ymg
        uvmode_grid[r: r + nmi, c: c + nmi] = uvmg

    _P32 = int(BlockSize.B32X32)
    _P16 = int(BlockSize.B16X16)

    def plan(r: int, c: int, bsize: BlockSize):
        """Build the partition tree + encode blocks in writer order."""
        if r >= mi_rows or c >= mi_cols:
            return
        half = bsize.width_mi // 2
        fully_inside = (r + bsize.height_mi <= mi_rows
                        and c + bsize.width_mi <= mi_cols)
        if (fully_inside and part_rdo
                and bsize == BlockSize.B32X32):
            _part_search32(r, c)
            return
        if fully_inside and bsize.width_mi <= bw_mi:
            partitions[(r, c, int(bsize))] = PartitionType.NONE
            encode_block(r, c, bsize)
            return
        partitions[(r, c, int(bsize))] = PartitionType.SPLIT
        sub = subsize(PartitionType.SPLIT, bsize)
        for (dr, dc) in ((0, 0), (0, half), (half, 0), (half, half)):
            plan(r + dr, c + dc, sub)

    def _part_search32(r: int, c: int):
        """RD-choose the partition shape of one fully-inside 32x32:
        NONE / HORZ (two 32x16) / VERT (two 16x32) / SPLIT (4x 16x16).
        Each candidate is trial-encoded in decode order on the live
        plane states (prediction edges see the earlier sub-block's
        recon, exactly as the decoder will), then rolled back; the
        winner re-encodes and stays committed."""
        cands = {
            PartitionType.NONE: [(r, c, BlockSize.B32X32)],
            PartitionType.HORZ: [(r, c, BlockSize.B32X16),
                                 (r + 4, c, BlockSize.B32X16)],
            PartitionType.VERT: [(r, c, BlockSize.B16X32),
                                 (r, c + 4, BlockSize.B16X32)],
            PartitionType.SPLIT: [(r, c, BlockSize.B16X16),
                                  (r, c + 4, BlockSize.B16X16),
                                  (r + 4, c, BlockSize.B16X16),
                                  (r + 4, c + 4, BlockSize.B16X16)],
        }
        if ss_x == 1 and ss_y == 0:
            # 4:2:2: B16X32 subsamples to an 8x32 chroma block, which
            # the spec's Subsampled_Size table marks BLOCK_INVALID —
            # both dav1d and libaom reject such streams. rav1e gates
            # partition candidates the same way (partition.rs
            # subsampled_size() -> None drops the shape from RDO).
            del cands[PartitionType.VERT]
        best = None
        for part, blks in cands.items():
            saved = _snapshot(r, c)
            dist = 0
            bits = float(_mc["partition_mid"][int(part)])
            if part == PartitionType.SPLIT:
                # each 16x16 child codes its own PARTITION_NONE symbol
                bits += 4.0 * float(_mc["partition_mid"][0])
            for (rr, cc, bs) in blks:
                d_, b_ = encode_block(rr, cc, bs, sink={})
                dist += d_
                bits += b_
            cost = dist + lam * bits
            if best is None or cost < best[0]:
                best = (cost, part, blks)
            _restore(r, c, saved)
        _, part, blks = best
        partitions[(r, c, _P32)] = part
        if part == PartitionType.SPLIT:
            for (rr, cc, bs) in blks:
                partitions[(rr, cc, _P16)] = PartitionType.NONE
        for (rr, cc, bs) in blks:
            encode_block(rr, cc, bs)

    maxpx = (1 << bit_depth) - 1

    # per-MI mode grids for the edge filter's smooth-neighbor check
    ymode_grid = np.zeros((mi_rows, mi_cols), np.int16)
    uvmode_grid = np.zeros((mi_rows, mi_cols), np.int16)
    _SMOOTH = {int(PredictionMode.SMOOTH_PRED),
               int(PredictionMode.SMOOTH_V_PRED),
               int(PredictionMode.SMOOTH_H_PRED)}

    def ftype(plane, r, c):
        g = ymode_grid if plane == 0 else uvmode_grid
        a_sm = r > 0 and int(g[r - 1, c]) in _SMOOTH
        l_sm = c > 0 and int(g[r, c - 1]) in _SMOOTH
        return 1 if (a_sm or l_sm) else 0

    def trial_pred(ps, x, yy, tx, tx_type, pred):
        h2, w2 = tx.height, tx.width
        resid = ps.src[yy: yy + h2, x: x + w2] - pred
        cf = forward_transform(resid, tx, tx_type)
        lv = quantize(cf, qcell["q"], tx, bd=bit_depth)
        dq = dequantize(lv, qcell["q"], tx, bd=bit_depth)
        r2 = inverse_transform(dq, tx, tx_type, bd=bit_depth)
        rec = np.clip(pred + r2, 0, maxpx)
        sse = int(((ps.src[yy: yy + h2, x: x + w2] - rec) ** 2).sum())
        return lv, rec, sse

    def trial(ps, x, yy, tx, tx_type, mode, delta=0, ft=0):
        h2, w2 = tx.height, tx.width
        above, left, top_left, av_a, av_l = _edges(ps, x, yy, w2, h2)
        ph2, pw2 = ps.src.shape
        pred = predict(mode, w2, h2, above, left, top_left,
                       bd=bit_depth, have_above=av_a, have_left=av_l,
                       angle_delta=delta, edge_filter=edge_filter,
                       filter_type=ft, n_above=pw2 - x, n_left=ph2 - yy)
        return trial_pred(ps, x, yy, tx, tx_type, pred)

    def dc_pred_of(ps, x, yy, tx):
        h2, w2 = tx.height, tx.width
        above, left, top_left, av_a, av_l = _edges(ps, x, yy, w2, h2)
        return predict(PredictionMode.DC_PRED, w2, h2, above, left,
                       top_left, bd=bit_depth,
                       have_above=av_a, have_left=av_l)

    def commit(ps, x, yy, rec):
        h2, w2 = rec.shape
        ps.rec[yy: yy + h2, x: x + w2] = rec
        ps.dec[yy // 4: (yy + h2) // 4, x // 4: (x + w2) // 4] = True

    def encode_block(r: int, c: int, bsize: BlockSize,
                     sink: dict | None = None):
        seg = 0
        if seg_map is not None:
            seg = int(seg_map[min(r // 8, seg_map.shape[0] - 1),
                              min(c // 8, seg_map.shape[1] - 1)])
            qcell["q"] = max(1, min(255, qindex + seg_alt_q[seg]))
        ytx = MAX_TX_SIZE_RECT[bsize]
        uvtx = chroma_tx_size(bsize, ss_x, ss_y)
        ytt = TxType.DCT_DCT
        # luma mode RDO over all 13 single-delta-0 modes
        ft_y = ftype(0, r, c)
        best = None
        for m in y_modes:
            lv, rec, sse = trial(states[0], c * 4, r * 4, ytx, ytt, m,
                                 ft=ft_y)
            cost = sse  # SSE-only decision (rate folded in later)
            if best is None or cost < best[0]:
                best = (cost, m, 0, lv, rec)
        # angle-delta refinement for angular winners (V/H/D*)
        # (SpeedSettings.angle_deltas; rav1e fine_directional_intra)
        if (angle_deltas and best[1] in ANGLE_BASE
                and bsize >= BlockSize.B8X8):
            for delta in (-3, -2, -1, 1, 2, 3):
                lv, rec, sse = trial(states[0], c * 4, r * 4, ytx, ytt,
                                     best[1], delta, ft=ft_y)
                if sse < best[0]:
                    best = (sse, best[1], delta, lv, rec)
        _, y_mode, y_delta, ylv, yrec = best
        commit(states[0], c * 4, r * 4, yrec)
        # joint chroma RDO (u+v share one coded uv_mode; the chroma tx
        # type follows uv_mode, so each candidate transforms with its
        # own type)
        bestc = None
        ft_uv = ftype(1, r, c)
        for m in uv_modes:
            uvtt = chroma_tx_type(m, uvtx, True)
            ulv, urec, usse = trial(states[1], (c * 4) >> ss_x,
                                    (r * 4) >> ss_y, uvtx, uvtt, m,
                                    ft=ft_uv)
            vlv, vrec, vsse = trial(states[2], (c * 4) >> ss_x,
                                    (r * 4) >> ss_y, uvtx, uvtt, m,
                                    ft=ft_uv)
            if bestc is None or usse + vsse < bestc[0]:
                bestc = (usse + vsse, m, ulv, urec, vlv, vrec)
        # CfL candidate (allowed <= 32x32): alpha per plane minimizing
        # prediction SSE against the source, then a full trial
        cfl_alphas = None
        if bsize.width <= 32 and bsize.height <= 32:
            from rav1e_tpu_torch.ops.ref.intra import cfl_ac, cfl_predict
            cw, ch2 = uvtx.width, uvtx.height
            ac = cfl_ac(states[0].rec[r * 4: r * 4 + (ch2 << ss_y),
                                      c * 4: c * 4 + (cw << ss_x)],
                        cw, ch2, ss_x, ss_y)
            alphas = []
            preds = []
            for pi in (1, 2):
                dc = dc_pred_of(states[pi], (c * 4) >> ss_x,
                                (r * 4) >> ss_y, uvtx)
                src = states[pi].src[(r * 4) >> ss_y:
                                     ((r * 4) >> ss_y) + ch2,
                                     (c * 4) >> ss_x:
                                     ((c * 4) >> ss_x) + cw]
                best_a, best_sse, best_pred = 0, int(((src - dc) ** 2)
                                                     .sum()), dc
                for a in range(-16, 17):
                    if a == 0:
                        continue
                    p = cfl_predict(dc, ac, a, bd=bit_depth)
                    sse = int(((src - p) ** 2).sum())
                    if sse < best_sse:
                        best_a, best_sse, best_pred = a, sse, p
                alphas.append(best_a)
                preds.append(best_pred)
            if alphas != [0, 0]:
                uvtt_cfl = chroma_tx_type(PredictionMode.UV_CFL_PRED,
                                          uvtx, True)
                ulv2, urec2, usse2 = trial_pred(
                    states[1], (c * 4) >> ss_x, (r * 4) >> ss_y, uvtx,
                    uvtt_cfl, preds[0])
                vlv2, vrec2, vsse2 = trial_pred(
                    states[2], (c * 4) >> ss_x, (r * 4) >> ss_y, uvtx,
                    uvtt_cfl, preds[1])
                if usse2 + vsse2 < bestc[0]:
                    bestc = (usse2 + vsse2, PredictionMode.UV_CFL_PRED,
                             ulv2, urec2, vlv2, vrec2)
                    cfl_alphas = (alphas[0], alphas[1])
        _, uv_mode, ulv, urec, vlv, vrec = bestc
        commit(states[1], (c * 4) >> ss_x, (r * 4) >> ss_y, urec)
        commit(states[2], (c * 4) >> ss_x, (r * 4) >> ss_y, vrec)
        d = BlockDecision(y_mode=y_mode, uv_mode=uv_mode, skip=False,
                          angle_delta_y=y_delta, seg_id=seg)
        if cfl_alphas is not None and uv_mode == PredictionMode.UV_CFL_PRED:
            d.cfl_alpha_idx = cfl_alphas
        if not ylv.any() and not ulv.any() and not vlv.any():
            d.skip = True
        else:
            d.coeffs = {0: ylv, 1: ulv, 2: vlv, "y_tx_type": ytt}
        (blocks if sink is None else sink)[(r, c)] = d
        bh_mi, bwmi = bsize.height_mi, bsize.width_mi
        ymode_grid[r: r + bh_mi, c: c + bwmi] = int(y_mode)
        uvmode_grid[r: r + bh_mi, c: c + bwmi] = int(uv_mode)
        # RD accounting (mode + coefficient rate, real cost tables) for
        # the partition-shape search; dist = whole-block recon SSE
        dist = best[0] + bestc[0]
        bits = float(_mc["skip"][0][int(d.skip)])
        bits += float(_mc["kf_y_mode"][int(y_mode)])
        if y_mode in ANGLE_BASE and bsize >= BlockSize.B8X8:
            bits += float(_mc["angle_delta"][int(y_mode) - 1][y_delta + 3])
        cfl_ok = bsize.width <= 32 and bsize.height <= 32
        uvtab = _mc["uv_mode_cfl"] if cfl_ok else _mc["uv_mode"]
        bits += float(uvtab[int(uv_mode)])
        if uv_mode == PredictionMode.UV_CFL_PRED and cfl_alphas:
            au, av = cfl_alphas
            su = 0 if au == 0 else (1 if au < 0 else 2)
            sv = 0 if av == 0 else (1 if av < 0 else 2)
            js = su * 3 + sv - 1
            bits += float(_mc["cfl_sign"][js])
            if su:
                bits += float(_mc["cfl_alpha"][js - 2][abs(au) - 1])
            if sv:
                bits += float(_mc["cfl_alpha"][sv * 3 + su - 3][abs(av) - 1])
        if uv_mode in ANGLE_BASE and bsize >= BlockSize.B8X8:
            bits += float(_mc["angle_delta"][int(uv_mode) - 1][0 + 3])
        if not d.skip:
            bits += lv_bits(ylv, ytx, ytt, 0)
            uvtt_w = chroma_tx_type(uv_mode, uvtx, True)
            bits += lv_bits(ulv, uvtx, uvtt_w, 1)
            bits += lv_bits(vlv, uvtx, uvtt_w, 2)
        return dist, bits

    for r in range(0, mi_rows, 16):
        for c in range(0, mi_cols, 16):
            plan(r, c, BlockSize.B64X64)

    # tile writing is deferred to the frame level so in-loop filter
    # decisions computed on the full frame (CDEF, loop restoration)
    # can be signaled inside the tile bitstream (rav1e interleaves
    # rdo_loop_decision per-SB; we batch whole-frame, same stream)
    return (tw, partitions, blocks, [s.rec for s in states],
            tw.skip_grid.astype(bool))
