"""The numpy inter pipeline: P and B frames on the host (the port's copy of
the JAX package's pipeline/inter.py).

Reference parity: rav1e's IPPP and reordered InterConfig paths
(src/api/internal.rs; src/encoder.rs inter blocks). Per 32x32 block: a
full-pel SAD search with quarter-pel refinement, GLOBALMV or NEWMV (a B
block single-LAST, single-ALTREF or COMPOUND_AVERAGE), DCT residual or
skip. It codes what the device steps do not: 12 bits, 4:2:2 and 4:4:4,
variance AQ inter frames, switch frames and error-resilient frames
(api/context.py routes them here, as the reference's Context does).

Everything but three points is the reference's, byte for byte: the C++
packer (entropy/native.py) is always built, so 4:2:0 frames without LR or
integer MVs walk it (its IR range-coded on `device`: cuda unless
device="cpu") and a packer error raises; loop restoration runs on
`device` (pipeline/lr.py), reading the deblocked planes before CDEF
beyond each stripe at the frame's chroma subsampling, as decoders do;
and CDEF filters 4:2:2 and 4:4:4 chroma blocks at their own size
(ops/ref/cdef.py). The reference reads the CDEF output, takes 4:2:0
stripes and filters 4:2:0 chroma blocks at every sampling, which
decoders do not (ROADMAP.md section 3).
"""

from __future__ import annotations

import functools

import numpy as np

from rav1e_tpu_torch.core.constants import (
    BlockSize,
    FrameType,
    PartitionType,
    PredictionMode,
    TxSize,
    TxType,
)
from rav1e_tpu_torch.entropy.obu import (
    FrameParams,
    Sequence,
    TileInfo,
    interframe_packet,
)
from rav1e_tpu_torch.entropy.tile import BlockDecision, TileWriter, chroma_tx_size
from rav1e_tpu_torch.ops.ref.mc import mc_predict, mc_predict_avg
from rav1e_tpu_torch.ops.ref.quant import dequantize, quantize
from rav1e_tpu_torch.ops.ref.transforms import forward_transform, inverse_transform


def _fullpel_search(src, ref, by, bx, rng_px=16):
    """Exhaustive full-pel SAD search over a +-rng_px window (clamped
    in-frame). Returns (mv_row, mv_col) in whole pixels."""
    h, w = ref.shape
    blk = src[by: by + 32, bx: bx + 32]
    y_lo, y_hi = max(0, by - rng_px), min(h - 32, by + rng_px)
    x_lo, x_hi = max(0, bx - rng_px), min(w - 32, bx + rng_px)
    win = ref[y_lo: y_hi + 32, x_lo: x_hi + 32]
    views = np.lib.stride_tricks.sliding_window_view(win, (32, 32))
    sads = np.abs(views.astype(np.int32)
                  - blk[None, None]).sum(axis=(2, 3))
    iy, ix = np.unravel_index(np.argmin(sads), sads.shape)
    best = int(sads[iy, ix])
    zero = int(sads[by - y_lo, bx - x_lo])
    if best + 1024 >= zero:  # cheap mv-cost bias toward (0,0)
        return (0, 0), zero
    return (y_lo + int(iy) - by, x_lo + int(ix) - bx), best


def _subpel_refine(src, ref, by, bx, mv_fp, steps=(4, 2)):
    """Quarter-pel refinement (hp bit implied 1 => even 1/8 units)."""
    best_mv = (mv_fp[0] * 8, mv_fp[1] * 8)
    blk = src[by: by + 32, bx: bx + 32]

    def cost(mv):
        p = mc_predict(ref, by, bx, 32, 32, mv)
        return int(np.abs(p - blk).sum())

    best = cost(best_mv)
    for step in steps:
        improved = True
        while improved:
            improved = False
            for dmv in ((-step, 0), (step, 0), (0, -step), (0, step)):
                cand = (best_mv[0] + dmv[0], best_mv[1] + dmv[1])
                cc = cost(cand)
                if cc < best:
                    best, best_mv, improved = cc, cand, True
    return best_mv


def encode_pframe(planes, ref_planes, qindex: int = 100,
                  order_hint: int = 1, use_native: bool = True,
                  search_px: int = 16, subpel: bool = True,
                  tile_cols_log2: int = 0, tile_rows_log2: int = 0,
                  cdef: tuple | None = None, bit_depth: int = 8,
                  refresh_flags: int = 0x01, ref_slot: int = 0,
                  show_frame: bool = True, film_grain=None,
                  aq: bool = False, render_size: tuple | None = None,
                  lr: bool = False, switch_frame: bool = False,
                  error_resilient: bool = False,
                  slot_order_hints: list | None = None,
                  chroma_sampling: str = "420", device=None):
    """Encode one P frame against ref_planes. Returns (packet, recon).

    Per 32x32 block: full-pel SAD search (+- search_px) with quarter-pel
    refinement; (0,0) codes as GLOBALMV, otherwise NEWMV. Residual DCT
    at TX_32X32 luma / TX_16X16 chroma; all-zero => skip.

    switch_frame=True codes an S-frame (rav1e switch_frame_interval,
    spec SWITCH_FRAME): error-resilient splice point with whole-pel
    MVs (force_integer_mv), refreshing every reference slot.
    error_resilient=True codes a plain error-resilient INTER frame.
    Both code the 8 reference slots' order hints (slot_order_hints).
    `device` codes the packer's IR and runs LR (cuda unless "cpu").
    """
    y, u, v = [p.astype(np.int32) for p in planes]
    ry, ru, rv = [p.astype(np.int32) for p in ref_planes]
    h, w = y.shape
    assert h % 32 == 0 and w % 32 == 0
    int_mv = switch_frame
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
                   film_grain_params_present=film_grain is not None)
    fp = FrameParams(
        frame_type=FrameType.SWITCH if switch_frame else FrameType.INTER,
        base_q_idx=qindex, render_size=render_size,
        error_resilient=error_resilient, force_integer_mv=int_mv,
        slot_order_hints=slot_order_hints)
    fp.film_grain = film_grain
    seg_alt_q = [-18, -6, 6, 18, None, None, None, None] if aq else None
    fp.seg_alt_q = seg_alt_q
    seg_map = None
    if aq:
        n_sr, n_sc = h // 32, w // 32
        var = np.array([[y[sr * 32: sr * 32 + 32,
                           sc * 32: sc * 32 + 32].astype(np.float64).var()
                         for sc in range(n_sc)] for sr in range(n_sr)])
        thr = np.quantile(var, (0.25, 0.5, 0.75)) if var.size > 1 else \
            (var.flat[0],) * 3
        seg_map = np.digitize(var, thr).astype(np.int8)
    if cdef is not None:
        (fp.cdef_y_pri, fp.cdef_y_sec, fp.cdef_uv_pri,
         fp.cdef_uv_sec, fp.cdef_damping) = cdef
    ti = TileInfo(seq, tile_cols_log2, tile_rows_log2)
    mi_rows, mi_cols = h >> 2, w >> 2
    cls = TileWriter
    if (use_native and not lr and not int_mv
            and chroma_sampling == "420"):
        # the native packer has no LR-unit, integer-MV or non-420
        # syntax; those frames take the python writer
        from rav1e_tpu_torch.entropy.native import NativeTileWriter
        cls = functools.partial(NativeTileWriter, device=device)
    rec = [np.zeros_like(y), np.zeros_like(u), np.zeros_like(v)]
    partitions: dict = {}
    blocks: dict = {}
    for by in range(0, h, 32):
        for bx in range(0, w, 32):
            r, c = by >> 2, bx >> 2
            partitions[(r, c, int(BlockSize.B64X64))] = PartitionType.SPLIT
            partitions[(r, c, int(BlockSize.B32X32))] = PartitionType.NONE
            mv_fp, _ = _fullpel_search(y, ry, by, bx, search_px)
            if mv_fp != (0, 0) and subpel and not int_mv:
                mv = _subpel_refine(y, ry, by, bx, mv_fp)
            else:
                # force_integer_mv: whole-pel MVs only
                mv = (mv_fp[0] * 8, mv_fp[1] * 8)
            mode = (PredictionMode.GLOBALMV if mv == (0, 0)
                    else PredictionMode.NEWMV)
            seg = 0
            q_eff = qindex
            if seg_map is not None:
                seg = int(seg_map[by // 32, bx // 32])
                q_eff = max(1, min(255, qindex + seg_alt_q[seg]))
            lvls = []
            preds = []
            uvtx = chroma_tx_size(BlockSize.B32X32, ss_x, ss_y)
            for pi, (src, ref, tx) in enumerate([
                    (y, ry, TxSize.TX_32X32),
                    (u, ru, uvtx), (v, rv, uvtx)]):
                sx = 0 if pi == 0 else ss_x
                sy = 0 if pi == 0 else ss_y
                px, py = bx >> sx, by >> sy
                nw, nh = 32 >> sx, 32 >> sy
                pred = mc_predict(ref, py, px, nh, nw, mv, ss=sx,
                                  ss_y=sy, bd=bit_depth)
                preds.append(pred)
                resid = src[py: py + nh, px: px + nw] - pred
                cf = forward_transform(resid, tx, TxType.DCT_DCT)
                lv = quantize(cf, q_eff, tx, bd=bit_depth)
                dq = dequantize(lv, q_eff, tx, bd=bit_depth)
                r2 = inverse_transform(dq, tx, TxType.DCT_DCT,
                                       bd=bit_depth)
                out = rec[pi]
                out[py: py + nh, px: px + nw] = np.clip(
                    pred + r2, 0, (1 << bit_depth) - 1)
                lvls.append(lv)
            d = BlockDecision(y_mode=mode,
                              uv_mode=PredictionMode.DC_PRED, skip=False,
                              mv=mv, seg_id=seg)
            if not any(lv.any() for lv in lvls):
                d.skip = True
                # skip: recon = prediction exactly
                for pi in range(3):
                    sx = 0 if pi == 0 else ss_x
                    sy = 0 if pi == 0 else ss_y
                    px, py = bx >> sx, by >> sy
                    rec[pi][py: py + (32 >> sy),
                            px: px + (32 >> sx)] = preds[pi]
            else:
                d.coeffs = {0: lvls[0], 1: lvls[1], 2: lvls[2]}
            blocks[(r, c)] = d

    # pack per tile (ME/MC are frame-global; entropy state is
    # tile-local, so each tile gets its own writer and local coords;
    # tile BYTES are produced after the in-loop filter decisions so
    # LR unit data can ride the tile bitstream)
    tws = []
    for t_r in range(ti.n_rows):
        for t_c in range(ti.n_cols):
            r0 = min(ti.row_starts[t_r] * 16, mi_rows)
            r1 = min(ti.row_starts[t_r + 1] * 16, mi_rows)
            c0 = min(ti.col_starts[t_c] * 16, mi_cols)
            c1 = min(ti.col_starts[t_c + 1] * 16, mi_cols)
            tw = cls(r1 - r0, c1 - c0, qindex, inter_frame=True,
                     seg_alt_q=seg_alt_q, force_integer_mv=int_mv,
                     ss_x=ss_x, ss_y=ss_y)
            tparts = {(r - r0, c - c0, bs): p
                      for (r, c, bs), p in partitions.items()
                      if r0 <= r < r1 and c0 <= c < c1}
            tblocks = {(r - r0, c - c0): d
                       for (r, c), d in blocks.items()
                       if r0 <= r < r1 and c0 <= c < c1}
            tws.append((tw, tparts, tblocks))
    # LR reads the deblocked planes before CDEF beyond each stripe
    pre = [p.copy() for p in rec] if lr and cdef is not None else None
    if cdef is not None:
        from rav1e_tpu_torch.ops.ref.cdef import cdef_filter_frame
        skip8 = np.zeros((h // 8, w // 8), bool)
        for (r, c), d in blocks.items():
            skip8[r // 2: r // 2 + 4, c // 2: c // 2 + 4] = d.skip
        cdef_filter_frame(rec, skip8, fp.cdef_y_pri, fp.cdef_y_sec,
                          fp.cdef_uv_pri, fp.cdef_uv_sec,
                          fp.cdef_damping, bd=bit_depth, ss_x=ss_x,
                          ss_y=ss_y)
    if lr and ti.n_rows == 1 and ti.n_cols == 1:
        # restoration for inter frames too (rav1e enables LRF on all
        # frame types); sequence-level gating comes from the keyframe
        from rav1e_tpu_torch.pipeline.lr import apply_lr_frame
        seq.enable_restoration = True
        fp.lr_types = apply_lr_frame(rec, [y, u, v], tws[0][0],
                                     bit_depth, ss_x, ss_y, device=device,
                                     pre=pre)
    tiles = [tw.write_tile(p_t, b_t) for tw, p_t, b_t in tws]
    ref_idx = [ref_slot] * 7
    pkt = interframe_packet(seq, fp, ti, tiles, order_hint,
                            refresh_flags=refresh_flags, ref_idx=ref_idx,
                            show_frame=show_frame)
    return pkt, rec


def encode_gop(frames, qindex: int = 100, device=None):
    """KEY + P... chain; returns (packets, recons)."""
    from rav1e_tpu_torch.pipeline.tpu_intra import encode_keyframe_tpu

    pkts, recs = [], []
    pkt, rec = encode_keyframe_tpu(frames[0], qindex=qindex, speed=8,
                                   deblock=False, device=device)
    pkts.append(pkt)
    recs.append(rec)
    for i, f in enumerate(frames[1:], start=1):
        pkt, rec = encode_pframe(f, recs[-1], qindex=qindex, order_hint=i,
                                 device=device)
        pkts.append(pkt)
        recs.append(rec)
    return pkts, recs


def encode_bframe(planes, ref_fwd, ref_bwd, qindex: int = 100,
                  order_hint: int = 1, use_native: bool = True,
                  search_px: int = 16, bit_depth: int = 8,
                  cdef: tuple | None = None, film_grain=None,
                  slot_fwd: int = 0, slot_bwd: int = 1,
                  ref_hints: tuple | None = None,
                  render_size: tuple | None = None,
                  refresh_flags: int = 0, show_frame: bool = True,
                  lr: bool = False, chroma_sampling: str = "420",
                  device=None):
    """Encode one B frame: per block, single-ref prediction from either
    LAST (the forward recon, slot 0) or ALTREF (the backward recon,
    slot 1), or their COMPOUND_AVERAGE - whichever wins the block's luma
    SSE. `device` codes the packer's IR and runs LR (cuda unless "cpu").

    Reference parity: rav1e's reordered InterConfig path (pyramid
    depth 1); the backward frame is coded first as a non-shown frame
    and displayed later via show_existing_frame."""
    y, u, v = [p.astype(np.int32) for p in planes]
    refs = [[p.astype(np.int32) for p in ref_fwd],
            [p.astype(np.int32) for p in ref_bwd]]
    ref_enum = [1, 7]            # LAST, ALTREF
    ref_slot = [0, 1]
    h, w = y.shape
    assert h % 32 == 0 and w % 32 == 0
    ss_x, ss_y = {"420": (1, 1), "422": (1, 0), "444": (0, 0)}[
        chroma_sampling]
    profile = 0
    if chroma_sampling == "444":
        profile = 1
    if chroma_sampling == "422" or bit_depth == 12:
        profile = 2
    seq = Sequence(width=w, height=h, bit_depth=bit_depth,
                   profile=profile,
                   subsampling_x=ss_x, subsampling_y=ss_y,
                   enable_cdef=cdef is not None,
                   film_grain_params_present=film_grain is not None)
    fp = FrameParams(frame_type=FrameType.INTER, base_q_idx=qindex,
                     render_size=render_size)
    fp.film_grain = film_grain
    if cdef is not None:
        (fp.cdef_y_pri, fp.cdef_y_sec, fp.cdef_uv_pri,
         fp.cdef_uv_sec, fp.cdef_damping) = cdef
    ti = TileInfo(seq)
    mi_rows, mi_cols = h >> 2, w >> 2
    cls = TileWriter
    if use_native and not lr and chroma_sampling == "420":
        # the native packer has no LR-unit or non-420 syntax; those
        # frames take the python writer
        from rav1e_tpu_torch.entropy.native import NativeTileWriter
        cls = functools.partial(NativeTileWriter, device=device)
    rec = [np.zeros_like(y), np.zeros_like(u), np.zeros_like(v)]
    partitions: dict = {}
    blocks: dict = {}
    for by in range(0, h, 32):
        for bx in range(0, w, 32):
            r, c = by >> 2, bx >> 2
            partitions[(r, c, int(BlockSize.B64X64))] = PartitionType.SPLIT
            partitions[(r, c, int(BlockSize.B32X32))] = PartitionType.NONE
            cand_mv = []
            for k in range(2):
                mv_fp, sad = _fullpel_search(y, refs[k][0], by, bx,
                                             search_px)
                if mv_fp != (0, 0):
                    mv = _subpel_refine(y, refs[k][0], by, bx, mv_fp)
                else:
                    mv = (0, 0)
                cand_mv.append(mv)
            # pick single-LAST / single-ALT / compound-average by luma
            # SSE of the actual prediction
            sy_blk = y[by: by + 32, bx: bx + 32]
            preds_y = [mc_predict(refs[k][0], by, bx, 32, 32, cand_mv[k],
                                  bd=bit_depth) for k in range(2)]
            preds_y.append(mc_predict_avg(
                refs[0][0], refs[1][0], by, bx, 32, 32, cand_mv[0],
                cand_mv[1], bd=bit_depth))
            sses = [int(((p - sy_blk) ** 2).sum()) for p in preds_y]
            choice = int(np.argmin(sses))
            is_comp = choice == 2
            if is_comp:
                mode = PredictionMode.NEW_NEWMV
                if cand_mv[0] == (0, 0) and cand_mv[1] == (0, 0):
                    mode = PredictionMode.GLOBAL_GLOBALMV
                k = 0
                mv = cand_mv[0]
            else:
                k = choice
                mv = cand_mv[k]
                mode = (PredictionMode.GLOBALMV if mv == (0, 0)
                        else PredictionMode.NEWMV)
            lvls = []
            preds = []
            uvtx = chroma_tx_size(BlockSize.B32X32, ss_x, ss_y)
            for pi, tx in enumerate([TxSize.TX_32X32, uvtx, uvtx]):
                sx = 0 if pi == 0 else ss_x
                sy = 0 if pi == 0 else ss_y
                px, py = bx >> sx, by >> sy
                nw, nh = 32 >> sx, 32 >> sy
                src = (y, u, v)[pi]
                if is_comp:
                    pred = mc_predict_avg(
                        refs[0][pi], refs[1][pi], py, px, nh, nw,
                        cand_mv[0], cand_mv[1], ss=sx, ss_y=sy,
                        bd=bit_depth)
                else:
                    pred = mc_predict(refs[k][pi], py, px, nh, nw, mv,
                                      ss=sx, ss_y=sy, bd=bit_depth)
                preds.append(pred)
                resid = src[py: py + nh, px: px + nw] - pred
                cf = forward_transform(resid, tx, TxType.DCT_DCT)
                lv = quantize(cf, qindex, tx, bd=bit_depth)
                dq = dequantize(lv, qindex, tx, bd=bit_depth)
                r2 = inverse_transform(dq, tx, TxType.DCT_DCT,
                                       bd=bit_depth)
                rec[pi][py: py + nh, px: px + nw] = np.clip(
                    pred + r2, 0, (1 << bit_depth) - 1)
                lvls.append(lv)
            d = BlockDecision(y_mode=mode,
                              uv_mode=PredictionMode.DC_PRED, skip=False,
                              mv=mv, ref=ref_enum[k])
            if is_comp:
                d.ref = 1
                d.ref2 = 7
                d.mv = cand_mv[0]
                d.mv2 = cand_mv[1]
            if not any(lv.any() for lv in lvls):
                d.skip = True
                for pi in range(3):
                    sx = 0 if pi == 0 else ss_x
                    sy = 0 if pi == 0 else ss_y
                    px, py = bx >> sx, by >> sy
                    rec[pi][py: py + (32 >> sy),
                            px: px + (32 >> sx)] = preds[pi]
            else:
                d.coeffs = {0: lvls[0], 1: lvls[1], 2: lvls[2]}
            blocks[(r, c)] = d
    tw = cls(mi_rows, mi_cols, qindex, inter_frame=True,
             ref_sign_bias={1: False, 7: True}, reference_select=True,
             ss_x=ss_x, ss_y=ss_y)
    # LR reads the deblocked planes before CDEF beyond each stripe
    pre = [p.copy() for p in rec] if lr and cdef is not None else None
    if cdef is not None:
        from rav1e_tpu_torch.ops.ref.cdef import cdef_filter_frame
        skip8 = np.zeros((h // 8, w // 8), bool)
        for (r, c), d in blocks.items():
            skip8[r // 2: r // 2 + 4, c // 2: c // 2 + 4] = d.skip
        cdef_filter_frame(rec, skip8, fp.cdef_y_pri, fp.cdef_y_sec,
                          fp.cdef_uv_pri, fp.cdef_uv_sec,
                          fp.cdef_damping, bd=bit_depth, ss_x=ss_x,
                          ss_y=ss_y)
    if lr:
        from rav1e_tpu_torch.pipeline.lr import apply_lr_frame
        seq.enable_restoration = True
        fp.lr_types = apply_lr_frame(rec, [y, u, v], tw,
                                     bit_depth, ss_x, ss_y, device=device,
                                     pre=pre)
    tile = tw.write_tile(partitions, blocks)
    # ref_idx: LAST -> slot_fwd, ..., ALTREF(idx 6) -> slot_bwd
    ref_idx = [slot_fwd] * 6 + [slot_bwd]
    fp.reference_select = True
    fh, bh2 = ref_hints or (0, order_hint + 1)
    fp.ref_order_hints = [fh] * 6 + [bh2]
    pkt = interframe_packet(seq, fp, ti, [tile], order_hint,
                            refresh_flags=refresh_flags,
                            ref_idx=ref_idx, show_frame=show_frame)
    return pkt, rec


def encode_gop_bframes(frames, qindex: int = 100, device=None):
    """KEY + backward ALT + B... chain (display order == input order).

    Coding order: KEY(t=0, slot 0), ALT(t=N, non-shown, slot 1),
    B(t=1..N-1, shown, no refresh), then show_existing(slot 1).
    Returns (packets, recons in display order)."""
    from rav1e_tpu_torch.entropy.obu import show_existing_packet
    from rav1e_tpu_torch.pipeline.tpu_intra import encode_keyframe_tpu

    n = len(frames)
    assert n >= 3
    pkts = []
    kp, kr = encode_keyframe_tpu(frames[0], qindex=qindex, speed=8,
                                 deblock=False, device=device)
    pkts.append(kp)
    ap, ar = encode_pframe(frames[-1], kr, qindex=qindex,
                           order_hint=n - 1, refresh_flags=0x02,
                           ref_slot=0, show_frame=False, device=device)
    pkts.append(ap)
    recs = [kr]
    for t in range(1, n - 1):
        bp, br = encode_bframe(frames[t], kr, ar, qindex=qindex,
                               order_hint=t, device=device)
        pkts.append(bp)
        recs.append(br)
    pkts.append(show_existing_packet(1))
    recs.append(ar)
    return pkts, recs
