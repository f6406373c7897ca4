"""Keyframe encoder on the device: batched mode pass + anti-diagonal
recon wavefront (port of rav1e_tpu/pipeline/tpu_intra.py).

Blocks on one anti-diagonal have no prediction dependency, so each step
batches every block of the diagonal through predict -> forward DCT ->
quantize -> dequantize -> bit-exact inverse -> reconstruct. The frame
runs in two phases:

  phase 1  `wavefront_frame`: the mode pass, every block at once with
           the SOURCE planes standing in for the recon state (no
           cross-block dependencies). Only the decision grids are kept.
  phase 2  `recon_wavefront`: decoder-order reconstruction with ONE mode
           per block on diagonal-skewed state arrays, where every read
           and write is one row of the skewed layout.

Then `_finalize_kf` runs the deblock level search and CDEF (the per-SB
ladder search of ops/cdef, or one fixed strength) and packs the meta +
nonzero-coefficient stream; the host unpacks it, walks the blocks into
TileWriter, whose RecordingEncoder has the tile range-coded by the CUDA
kernel of entropy/ec_cuda, and builds the OBU packet.

This slice ports the speed-8 to 10 toolsets (api/speed.py): DC-only luma
and chroma at speeds 9-10, the 7 non-directional luma modes and 4 chroma
modes at speed 8 (chroma 16x16 then codes in the mode's TX type), no
split RDO, no CfL, no TX search, no split8, no above-right extension.
Other options raise NotImplementedError naming the ROADMAP.md item that
brings them.
"""

from __future__ import annotations

import functools
import time
from typing import NamedTuple

import numpy as np
import torch

from rav1e_tpu_torch.core.constants import (
    BlockSize,
    FrameType,
    PartitionType,
    PredictionMode,
    TxSize,
    TxType,
)
from rav1e_tpu_torch.api.speed import SpeedSettings
from rav1e_tpu_torch.device import resolve_device
from rav1e_tpu_torch.entropy.ec_cuda import RecordingEncoder
from rav1e_tpu_torch.entropy.obu import (
    FrameParams,
    Sequence,
    TileInfo,
    keyframe_packet,
)
from rav1e_tpu_torch.entropy.tile import BlockDecision, TileWriter, \
    chroma_tx_type
from rav1e_tpu_torch.ops import transforms as T
from rav1e_tpu_torch.ops.cdef import (
    cdef_filter_frame,
    cdef_search_persb,
    compact_ladder,
)
from rav1e_tpu_torch.ops.deblock import deblock_search
from rav1e_tpu_torch.ops.intra import predict_modes
from rav1e_tpu_torch.ops.ref.deblock import level_from_qindex
from rav1e_tpu_torch.ops.ref.quant import ac_q, chroma_dq, dc_q, tx_scale
from rav1e_tpu_torch.pipeline.tpu_inter import (
    _nomark,
    _not_ported,
    _Stages,
    gather_dense,
    nnz_stream,
    scanline,
    unpack_stream,
)

LB = 32  # luma block
CB = 16  # chroma block

P = PredictionMode
# speed 8: the 7 non-directional luma modes and 4 chroma modes
MODES_7 = (P.DC_PRED, P.V_PRED, P.H_PRED, P.SMOOTH_PRED,
           P.SMOOTH_V_PRED, P.SMOOTH_H_PRED, P.PAETH_PRED)
# speed <= 6: + 6 directional (D45/D67 read the above-right extension,
# D203 below-left: the 2i+j schedule, ROADMAP.md item 8)
MODES_FULL = MODES_7 + (P.D45_PRED, P.D67_PRED, P.D113_PRED,
                        P.D135_PRED, P.D157_PRED, P.D203_PRED)
MODES_QUAD = MODES_7 + (P.D113_PRED, P.D135_PRED, P.D157_PRED)
MODES_FAST = (P.DC_PRED,)
MODES_UV = (P.DC_PRED, P.V_PRED, P.H_PRED, P.SMOOTH_PRED)
MODES_UV_FULL = (P.DC_PRED, P.V_PRED, P.H_PRED, P.SMOOTH_PRED,
                 P.SMOOTH_V_PRED, P.SMOOTH_H_PRED, P.PAETH_PRED,
                 P.D113_PRED, P.D135_PRED, P.D157_PRED)
ANGULAR = (P.V_PRED, P.H_PRED, P.D45_PRED, P.D67_PRED, P.D113_PRED,
           P.D135_PRED, P.D157_PRED, P.D203_PRED)

KF_META = 54   # per-block meta row: flags + modes + cfl + ytx + 8x8


# ---- rate model (WriterCounter twin, batched) ------------------------------

def rate_luts(qindex: int, tx_size, plane: int, device) -> dict:
    """Context-exact coefficient-rate LUTs for one (tx_size, plane) as
    tensors (entropy/cost.py), pre-expanded on the host into
    position-dependent select tables with a SMALL leading data axis:
      base_sel [5, 4, h, w]  = base_bits[off_grid + m, lv3]
      br_sel   [7, 16, h, w] = br_lvl_bits[br_off + m, lv15]
      eob_sel  [3, h, w]     = eob_base_bits[eregion, t]
    so block_bits reduces every lookup to a short where-chain."""
    from rav1e_tpu_torch.entropy.cost import tx_block_cost_luts
    luts = tx_block_cost_luts(qindex, tx_size, TxType.DCT_DCT, plane)
    n = luts["scan_pos"].size
    sp = luts["scan_pos"]
    h, w = sp.shape
    eregion = np.where(sp == 0, 0,
                       np.where(sp <= (n >> 3), 1,
                                np.where(sp <= (n >> 2), 2, 3)))
    bb = luts["base_bits"]                    # [41, 4]
    off = luts["off_grid"]                    # [h, w]
    base_sel = np.empty((5, 4, h, w), np.float32)
    for m in range(5):
        base_sel[m] = bb[np.minimum(off + m, bb.shape[0] - 1)
                         ].transpose(2, 0, 1)
    base_sel[:, :, 0, 0] = bb[0][None]        # DC position: bctx = 0
    brl = luts["br_lvl_bits"]                 # [21, 16]
    rr = np.arange(h)[:, None]
    cc = np.arange(w)[None, :]
    br_off = np.where((rr == 0) & (cc == 0), 0,
                      np.where((rr < 2) & (cc < 2), 7, 14))
    br_sel = np.empty((7, 16, h, w), np.float32)
    for m in range(7):
        br_sel[m] = brl[np.minimum(br_off + m, brl.shape[0] - 1)
                        ].transpose(2, 0, 1)
    eob_sel = (luts["eob_base_bits"][eregion]      # [h, w, 3]
               .transpose(2, 0, 1).astype(np.float32))

    def t(x, dtype=None):
        return torch.as_tensor(np.asarray(x, dtype), device=device)

    return {"scan_pos": t(sp),
            "base_sel": t(base_sel),
            "br_sel": t(br_sel),
            "eob_sel": t(eob_sel),
            "eob_cost": t(luts["eob_cost"]),
            "skip1": t(luts["skip1"], np.float32),
            "skip0": t(luts["skip0"], np.float32)}


def _wsel(idx, tab, first: int = 0):
    """Gather-free lookup tab[idx] for a SMALL static leading axis:
    where-chain over tab's first dim (broadcasts [M, h, w] against idx
    [..., h, w]). Entries below `first` are taken as 0 (br chains cost
    0 below level 3)."""
    out = (tab[0] * torch.ones_like(idx, dtype=tab.dtype) if first == 0
           else torch.zeros(idx.shape, dtype=tab.dtype, device=idx.device))
    for k in range(max(first, 1), tab.shape[0]):
        out = torch.where(idx == k, tab[k], out)
    return out


def block_bits(lv, L) -> torch.Tensor:
    """Estimated coefficient bits for level blocks lv [..., h, w] with
    LUT set L (rate_luts): the serial writer's context chain
    (entropy/coeffs.py::write_coeffs) batched — base/br contexts from
    neighbor levels, exact eob accounting, golomb tails."""
    a = torch.abs(lv)
    lv3 = torch.clamp(a, max=3)
    lv15 = torch.clamp(a, max=15)

    def sh2(x, dr, dc):
        if not (dr or dc):
            return x
        return torch.nn.functional.pad(x, (0, dc, 0, dr))[..., dr:, dc:]

    nsum = (sh2(lv3, 0, 1) + sh2(lv3, 1, 0) + sh2(lv3, 1, 1)
            + sh2(lv3, 0, 2) + sh2(lv3, 2, 0))
    brsum = sh2(lv15, 0, 1) + sh2(lv15, 1, 0) + sh2(lv15, 1, 1)
    mm = torch.clamp((nsum + 1) >> 1, max=4)
    bm = torch.clamp((brsum + 1) >> 1, max=6)
    base = None
    for lvl in range(4):
        col = _wsel(mm, L["base_sel"][:, lvl])
        base = col if base is None else torch.where(lv3 == lvl, col, base)
    br = None
    for m in range(7):
        row = _wsel(lv15, L["br_sel"][m], first=3)
        br = row if br is None else torch.where(bm == m, row, br)
    gol = torch.where(
        a > 14,
        2.0 * torch.floor(torch.log2(torch.clamp(a - 14, min=1).to(
            torch.float32))) + 1.0, 0.0)
    sign = (a > 0).to(torch.float32)
    per = base + br + gol + sign
    ebits = (_wsel(torch.clamp(lv3 - 1, min=0), L["eob_sel"])
             + br + gol + sign)
    sp = L["scan_pos"]
    eob = torch.amax(torch.where(a > 0, sp + 1, 0), dim=(-2, -1))
    at_eob = sp == (eob[..., None, None] - 1)
    coded = sp < eob[..., None, None]
    body = torch.sum(torch.where(coded, torch.where(at_eob, ebits, per),
                                 0.0), dim=(-2, -1))
    return torch.where(eob == 0, L["skip1"],
                       L["skip0"] + L["eob_cost"][eob] + body)


def build_rd(qindex: int, modes_y, modes_uv, bit_depth: int = 8,
             modes_quad=None, device=None) -> dict:
    """All RD inputs of the mode pass and the recon wavefront:
    quantizers, λ, rate LUTs, per-candidate mode-signaling bits,
    partition bits — a dict of tensors on `device`. The reference's
    CfL, TX-search and split8 entries are not ported yet."""
    from rav1e_tpu_torch.entropy.cost import mode_cost_tables, rd_lambda
    dev = resolve_device(device)
    mc = mode_cost_tables()

    def mbits(table, m):
        b = float(table[int(m)])
        if m in ANGULAR:   # delta=0 symbol (angle_delta cdf idx m-1)
            b += float(mc["angle_delta"][int(m) - 1][3])
        return b

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x, dtype), device=dev)

    pm = mc["partition_mid"]
    qc = qindex + chroma_dq(qindex)
    return {
        "qdc": t(dc_q(qindex, 0, bit_depth), np.int32),
        "qac": t(ac_q(qindex, 0, bit_depth), np.int32),
        "qdc_c": t(dc_q(qc, 0, bit_depth), np.int32),
        "qac_c": t(ac_q(qc, 0, bit_depth), np.int32),
        "lam": t(rd_lambda(qindex, bit_depth), np.float32),
        "y32": rate_luts(qindex, TxSize.TX_32X32, 0, dev),
        "y16": rate_luts(qindex, TxSize.TX_16X16, 0, dev),
        "c16": rate_luts(qc, TxSize.TX_16X16, 1, dev),
        "c8": rate_luts(qc, TxSize.TX_8X8, 1, dev),
        "ybits": t([mbits(mc["kf_y_mode"], m) for m in modes_y],
                   np.float32),
        "uvbits": t([mbits(mc["uv_mode"], m) for m in modes_uv],
                    np.float32),
        "yqbits": t([mbits(mc["kf_y_mode"], m)
                     for m in (modes_quad or modes_y)], np.float32),
        # partition signaling: NONE@32 vs SPLIT@32 + 4x NONE@16
        "split_bits": t(pm[int(PartitionType.SPLIT)]
                        - pm[int(PartitionType.NONE)]
                        + 4.0 * pm[int(PartitionType.NONE)], np.float32),
    }


def rd_from_numpy(rd: dict, device) -> dict:
    """The reference's build_rd output, given as numpy arrays (nested
    dicts included), as the port's dict of tensors on `device`."""
    dev = resolve_device(device)
    return {k: (rd_from_numpy(v, dev) if isinstance(v, dict)
                else torch.tensor(np.asarray(v), device=dev))
            for k, v in rd.items()}


@functools.lru_cache(maxsize=None)
def _dc_grids(tx_size: TxSize, device: torch.device):
    """(dc mask [h, w] bool, quantizer bias grid [h, w] int32)."""
    m = np.zeros((tx_size.height, tx_size.width), bool)
    m[0, 0] = True
    return (torch.as_tensor(m, device=device),
            torch.as_tensor(np.where(m, 21, 17).astype(np.int32),
                            device=device))


def _q_dyn(cf, tx_size, dcq, acq):
    """Quantize with quantizer scalars (0-d int32 tensors)."""
    shift = tx_scale(tx_size)
    m, bias = _dc_grids(tx_size, cf.device)
    q = torch.where(m, dcq, acq).to(torch.int32)
    a = torch.abs(cf) << shift
    lv = torch.clamp(
        torch.div(a + torch.div(q * bias, 64, rounding_mode="floor"), q,
                  rounding_mode="floor"), max=(1 << 15) - 1)
    return torch.sign(cf) * lv


def _dq_dyn(lv, tx_size, dcq, acq):
    shift = tx_scale(tx_size)
    m, _ = _dc_grids(tx_size, lv.device)
    q = torch.where(m, dcq, acq).to(torch.int32)
    dqv = ((torch.abs(lv) * q) & 0xFFFFFF) >> shift
    return torch.sign(lv) * dqv


def _cand_eval(preds, srcb, tx_size, dqs, tts, maxpx=255, approx=False):
    """Evaluate K prediction candidates: returns (rec, lv, sse) stacked
    [K, N, h, w] / [K, N]; tts: per-candidate TxType list (one batched
    chain when all candidates share a type, else one chain each).

    approx=True swaps the spec-exact integer inverse for the float
    inverse — for mode RANKING only; callers reconstruct survivors
    exactly."""
    inv = T.inverse_approx if approx else T.inverse_transform
    K, n, blkh, blkw = preds.shape
    dq0, dq1 = dqs
    if len(set(tts)) == 1:
        resid = (srcb[None] - preds).reshape(K * n, blkh, blkw)
        cf = T.forward_transform(resid, tx_size, tts[0])
        lv = _q_dyn(cf, tx_size, dq0, dq1)
        dq = _dq_dyn(lv, tx_size, dq0, dq1)
        r2 = inv(dq, tx_size, tts[0])
        recb = torch.clamp(preds.reshape(K * n, blkh, blkw) + r2, 0, maxpx)
        recb = recb.to(torch.int32).reshape(K, n, blkh, blkw)
        lvk = lv.reshape(K, n, blkh, blkw)
    else:
        recs, lvs = [], []
        for k in range(K):
            cf = T.forward_transform(srcb - preds[k], tx_size, tts[k])
            lv = _q_dyn(cf, tx_size, dq0, dq1)
            r2 = inv(_dq_dyn(lv, tx_size, dq0, dq1), tx_size, tts[k])
            recs.append(torch.clamp(preds[k] + r2, 0, maxpx)
                        .to(torch.int32))
            lvs.append(lv)
        recb = torch.stack(recs, 0)
        lvk = torch.stack(lvs, 0)
    sse = torch.sum((recb - srcb[None]).to(torch.float32) ** 2,
                    dim=(-2, -1))
    return recb, lvk, sse


def _modes_tensor(modes, device):
    return torch.tensor([int(m) for m in modes], dtype=torch.int32,
                        device=device)


def wavefront_frame(edges, srcs, rd, modes_y, modes_uv, approx=False):
    """Phase 1, the dense mode pass (the reference's wavefront_frame
    with dense=True): every block of the frame on ONE "diagonal" in
    raster order, with `edges` (block grids [bh, bw, b, b] of y, u, v)
    standing in for the recon state, so block reads are reshapes and
    edge reads are static row/col shifts of the block grid.

    Returns the reference's 14 block grids: (y_rec, u_rec, v_rec, y_lv,
    u_lv, v_lv, y_modes [bh,bw,5], uv_modes [bh,bw,5], split, cfl
    [bh,bw,2], y_txs [bh,bw,4], s16 [bh,bw,4], ym8 [bh,bw,4,4],
    uvm8 [bh,bw,4,4]). Split RDO and CfL are not ported yet."""
    lam = rd["lam"]
    ry, ru, rv = edges
    dev = ry.device
    bh_g, bw_g = ry.shape[0], ry.shape[1]

    def _dn(a):     # row i <- max(i-1, 0)
        return torch.cat([a[:1], a[:-1]], 0)

    def _rt(a):     # col j <- max(j-1, 0)
        return torch.cat([a[:, :1], a[:, :-1]], 1)

    def blk(arr):
        return arr.reshape((-1,) + tuple(arr.shape[2:]))

    def gather_edges(rec, blkh, blkw):
        above = blk(_dn(rec))[:, blkh - 1, :]
        left = blk(_rt(rec))[:, :, blkw - 1]
        tl = blk(_rt(_dn(rec)))[:, blkh - 1, blkw - 1]
        return above, left, tl

    ii = torch.arange(bh_g, device=dev).repeat_interleave(bw_g)
    jj = torch.arange(bw_g, device=dev).repeat(bh_g)
    n = ii.shape[0]
    sel = torch.arange(n, device=dev)
    has_a = ii > 0
    has_l = jj > 0

    # ---- luma 32 candidates ----
    srcb_y = blk(srcs[0])
    a_y, l_y, tl_y = gather_edges(ry, LB, LB)
    preds32 = predict_modes(modes_y, a_y, l_y, tl_y, has_a, has_l, LB, LB)
    rec32, lv32, sse32 = _cand_eval(
        preds32, srcb_y, TxSize.TX_32X32, (rd["qdc"], rd["qac"]),
        [TxType.DCT_DCT] * len(modes_y), approx=approx)
    cost32 = sse32 + lam * (block_bits(lv32, rd["y32"])
                            + rd["ybits"][:, None])
    b32 = torch.argmin(cost32, dim=0)
    y_rec, y_lv = rec32[b32, sel], lv32[b32, sel]
    y32_mode = _modes_tensor(modes_y, dev)[b32]

    # ---- chroma 16 candidates (joint u+v mode) ----
    cts16 = [chroma_tx_type(m, TxSize.TX_16X16, True) for m in modes_uv]
    dqs_c = (rd["qdc_c"], rd["qac_c"])

    def chroma_cands(rec, src):
        a, l_, tl = gather_edges(rec, CB, CB)
        preds = predict_modes(modes_uv, a, l_, tl, has_a, has_l, CB, CB)
        return _cand_eval(preds, blk(src), TxSize.TX_16X16, dqs_c, cts16,
                          approx=approx)

    ur, ulv, usse = chroma_cands(ru, srcs[1])
    vr, vlv, vsse = chroma_cands(rv, srcs[2])
    ccost = (usse + vsse
             + lam * (block_bits(ulv, rd["c16"])
                      + block_bits(vlv, rd["c16"])
                      + rd["uvbits"][:, None]))
    bc = torch.argmin(ccost, dim=0)
    c16_mode = _modes_tensor(modes_uv, dev)[bc]

    i32 = torch.int32
    zeros = functools.partial(torch.zeros, device=dev)

    def g(x):
        return x.reshape((bh_g, bw_g) + tuple(x.shape[1:]))

    return (g(y_rec), g(ur[bc, sel]), g(vr[bc, sel]), g(y_lv),
            g(ulv[bc, sel]), g(vlv[bc, sel]),
            g(y32_mode[:, None].expand(n, 5).contiguous()),
            g(c16_mode[:, None].expand(n, 5).contiguous()),
            g(zeros((n,), dtype=torch.bool)), g(zeros((n, 2), dtype=i32)),
            g(torch.ones((n, 4), dtype=i32, device=dev)),
            g(zeros((n, 4), dtype=torch.bool)),
            g(zeros((n, 4, 4), dtype=i32)), g(zeros((n, 4, 4), dtype=i32)))


# ---- phase 2: recon wavefront on the diagonal-skewed layout ----------------

@functools.lru_cache(maxsize=8)
def _skew_tables(bh: int, bw: int):
    """Host tables for the diagonal-skewed layout: block (i, j) lives at
    [d, s] with d = i + j, s = i. Returns (ii [D,S], jj [D,S] clamped
    block indices, has_l [D,S], valid [D,S], unskew_d [bh,bw],
    unskew_s [bh,bw]). (The reference's 2i+j schedule for the
    above-right extension is not ported yet.)"""
    D = bh - 1 + bw
    S = bh
    ii = np.zeros((D, S), np.int32)
    jj = np.zeros((D, S), np.int32)
    valid = np.zeros((D, S), bool)
    un_d = np.zeros((bh, bw), np.int32)
    un_s = np.zeros((bh, bw), np.int32)
    for i in range(bh):
        for j in range(bw):
            d = i + j
            ii[d, i], jj[d, i], valid[d, i] = i, j, True
            un_d[i, j], un_s[i, j] = d, i
    has_l = valid & (jj > 0)
    return ii, jj, has_l, valid, un_d, un_s


def _mode_lut(modes):
    lut = np.zeros(32, np.int32)
    for k, m in enumerate(modes):
        lut[int(m)] = k
    return lut


def _tts_select(modes, tx):
    """(distinct TxType list, per-mode tx-id LUT) for chroma chains."""
    tts = []
    lut = np.zeros(32, np.int32)
    for m in list(modes) + [P.UV_CFL_PRED]:
        tt = chroma_tx_type(m, tx, True)
        if tt not in tts:
            tts.append(tt)
        lut[int(m)] = tts.index(tt)
    return tuple(tts), lut


def _clamp_row(arr, r: int) -> int:
    """A one-row start as jax.lax.dynamic_slice and dynamic_update_slice
    take theirs: a negative start counts from the end, then the start is
    clamped into range."""
    n = arr.shape[0]
    return min(max(r + n if r < 0 else r, 0), n - 1)


def recon_wavefront(sy_sk, su_sk, sv_sk, ym_sk, uvm_sk, has_l_tab, rd,
                    modes_y, modes_uv):
    """Decoder-order reconstruction with FIXED per-block decisions.

    All arrays are diagonal-skewed: index [d, s] holds block
    (i=s, j=d-s). State rows are offset +3 so neighbor reads (d-1, d-2)
    never clamp; every row index is still clamped as the reference's
    dynamic slices clamp theirs. The reference's fori_loop over the D
    diagonals is a Python loop; the state updates in place (the rows
    read in a step are never the row written). Returns skewed (rec_y,
    rec_u, rec_v, lv_y, lv_u, lv_v)."""
    D, S = has_l_tab.shape
    dev = sy_sk.device
    qdc, qac = rd["qdc"], rd["qac"]
    qdc_c, qac_c = rd["qdc_c"], rd["qac_c"]
    luty = torch.as_tensor(_mode_lut(modes_y), device=dev).long()
    lutuv = torch.as_tensor(_mode_lut(modes_uv), device=dev).long()
    tts16, tid16_np = _tts_select(modes_uv, TxSize.TX_16X16)
    tid16 = torch.as_tensor(tid16_np, device=dev).long()
    o_a, o_l, o_tl = 1, 1, 2
    slot_has_a = torch.arange(S, device=dev) > 0

    def shift1(x):
        return torch.cat([torch.zeros_like(x[:1]), x[:-1]], 0)

    def rows(arr, r):
        return arr[_clamp_row(arr, r)]

    def put(arr, r, x):
        arr[_clamp_row(arr, r)] = x

    def code_one(pred, src, tx, dq0, dq1, tt=TxType.DCT_DCT):
        cf = T.forward_transform(src - pred, tx, tt)
        lv = _q_dyn(cf, tx, dq0, dq1)
        dqv = _dq_dyn(lv, tx, dq0, dq1)
        r2 = T.inverse_transform(dqv, tx, tt)
        return torch.clamp(pred + r2, 0, 255).to(torch.int32), lv

    def code_sel(pred, src, tx, dq0, dq1, tts, tid):
        """TX chain per distinct chroma TxType, selected by tid [S]."""
        if len(tts) == 1:
            return code_one(pred, src, tx, dq0, dq1, tts[0])
        outs = [code_one(pred, src, tx, dq0, dq1, tt) for tt in tts]
        t3 = tid[None, :, None, None].expand((1,) + tuple(pred.shape))
        return (torch.gather(torch.stack([o[0] for o in outs]), 0, t3)[0],
                torch.gather(torch.stack([o[1] for o in outs]), 0, t3)[0])

    def sel_modes(preds, k):
        idx = k[None, :, None, None].expand((1,) + tuple(preds.shape[1:]))
        return torch.gather(preds, 0, idx)[0]

    i32 = torch.int32
    ry_sk = torch.zeros((D + 3, S, LB, LB), dtype=i32, device=dev)
    ru_sk = torch.zeros((D + 3, S, CB, CB), dtype=i32, device=dev)
    rv_sk = torch.zeros((D + 3, S, CB, CB), dtype=i32, device=dev)
    lvy_sk = torch.zeros((D, S, LB, LB), dtype=i32, device=dev)
    lvu_sk = torch.zeros((D, S, CB, CB), dtype=i32, device=dev)
    lvv_sk = torch.zeros((D, S, CB, CB), dtype=i32, device=dev)

    def edges(rp, b, row):
        a = shift1(rows(rp, row - o_a)[:, b - 1, :])
        left = rows(rp, row - o_l)[:, :, b - 1]
        tl = shift1(rows(rp, row - o_tl)[:, b - 1, b - 1])
        return a, left, tl

    for d in range(D):
        row = d + 3
        has_l = rows(has_l_tab, d)
        ym_d = rows(ym_sk, d)
        uvm_d = rows(uvm_sk, d)

        # ---- luma 32 (single chosen mode) ----
        a_y, l_y, tl_y = edges(ry_sk, LB, row)
        preds32 = predict_modes(modes_y, a_y, l_y, tl_y, slot_has_a,
                                has_l, LB, LB)
        p32 = sel_modes(preds32, luty[ym_d[:, 0].long()])
        rec_y_d, lv_y_d = code_one(p32, rows(sy_sk, d), TxSize.TX_32X32,
                                   qdc, qac)

        # ---- chroma 16 (chosen joint uv mode) ----
        ku = lutuv[uvm_d[:, 0].long()]
        tu = tid16[uvm_d[:, 0].long()]
        out_c = []
        for rp, src in ((ru_sk, su_sk), (rv_sk, sv_sk)):
            a, left, tl = edges(rp, CB, row)
            pc = predict_modes(modes_uv, a, left, tl, slot_has_a, has_l,
                               CB, CB)
            out_c.append(code_sel(sel_modes(pc, ku), rows(src, d),
                                  TxSize.TX_16X16, qdc_c, qac_c, tts16, tu))
        (rec_u_d, lv_u_d), (rec_v_d, lv_v_d) = out_c

        put(ry_sk, row, rec_y_d)
        put(ru_sk, row, rec_u_d)
        put(rv_sk, row, rec_v_d)
        put(lvy_sk, d, lv_y_d)
        put(lvu_sk, d, lv_u_d)
        put(lvv_sk, d, lv_v_d)
    return (ry_sk[3:], ru_sk[3:], rv_sk[3:], lvy_sk, lvu_sk, lvv_sk)


# ---- device epilogue: deblock search + compact meta ------------------------

def _kf_stream_cap(B: int) -> int:
    """Keyframes are coefficient-dense: 128 nonzeros/block slots."""
    return B * 128


def _kf_quads(x, n):
    Bq = x.shape[0]
    return (x.reshape(Bq, 2, n, 2, n).permute(0, 1, 3, 2, 4)
            .reshape(Bq, 4, n, n))


def _kf_skip_flags(state):
    """(skip_q [B,4], skip_b [B], split [B]) from the level grids
    (device twin of the host all-zero test)."""
    ly, lu, lvv, sp = state[3], state[4], state[5], state[8]
    bh, bw = sp.shape
    B = bh * bw
    nz = ((_kf_quads(ly.reshape(B, LB, LB), LB // 2) != 0).any(-1).any(-1)
          | (_kf_quads(lu.reshape(B, CB, CB), CB // 2) != 0).any(-1).any(-1)
          | (_kf_quads(lvv.reshape(B, CB, CB), CB // 2) != 0)
          .any(-1).any(-1))
    skip_q = ~nz
    return skip_q, skip_q.all(dim=1), sp.reshape(B)


def _from_blocks_t(a):
    """[bh, bw, b, b] block grid -> [bh*b, bw*b] plane (device)."""
    bh, bw, b, _ = a.shape
    return a.permute(0, 2, 1, 3).reshape(bh * b, bw * b)


def _to_blocks_t(p, b: int):
    """[h, w] plane -> [h/b, w/b, b, b] int32 block grid (device)."""
    h, w = p.shape
    return (p.reshape(h // b, b, w // b, b).permute(0, 2, 1, 3)
            .to(torch.int32))


def _kf_skip8(state):
    """The CDEF skip gate [2 bh * 2, 2 bw * 2] on 8x8 units: each 16x16
    quad's skip inside split blocks, the block's skip elsewhere."""
    skip_q, skip_b, split = _kf_skip_flags(state)
    bh, bw = state[8].shape
    sk = torch.where(split[:, None], skip_q,
                     skip_b[:, None].expand(-1, 4)).reshape(bh, bw, 2, 2)
    return (sk.permute(0, 2, 1, 3).reshape(bh * 2, bw * 2)
            .repeat_interleave(2, 0).repeat_interleave(2, 1))


def _kf_filters(state, srcs, base_lf: int, cdef_prm, lam,
                use_cdef: bool, use_deblock: bool, cdef_rdo: bool = False,
                mark=_nomark):
    """Keyframe in-loop filters: the deblock level search, then CDEF —
    the per-64x64-SB ladder search against the source (cdef_rdo) or the
    fixed strengths cdef_prm (y_pri, y_sec, uv_pri, uv_sec, damping).
    `mark(name)` runs after each ("filters", "cdef"). Returns (lf_lvl
    0-d int32, cdef_idx [ceil(bh/2), ceil(bw/2)] int32, rec_packed uint8
    [3h/2, w]: y over u|v)."""
    bh, bw = state[8].shape
    planes = [_from_blocks_t(state[i]) for i in range(3)]
    dev = planes[0].device
    lf_lvl = torch.zeros((), dtype=torch.int32, device=dev)
    if use_deblock:
        lf_lvl, planes = deblock_search(
            planes, [_from_blocks_t(s) for s in srcs], base_lf, LB, CB, 8)
    mark("filters")
    cdef_idx = torch.zeros(((bh + 1) // 2, (bw + 1) // 2), dtype=torch.int32,
                           device=dev)
    if use_cdef:
        skip8 = _kf_skip8(state)
        if cdef_rdo:
            cdef_idx, planes = cdef_search_persb(
                planes, [_from_blocks_t(s) for s in srcs], skip8,
                cdef_prm[4], lam=lam)
        else:
            planes = cdef_filter_frame(planes, skip8, *cdef_prm)
    mark("cdef")
    u8 = [p.to(torch.uint8) for p in planes]
    return (lf_lvl, cdef_idx,
            torch.cat([u8[0], torch.cat([u8[1], u8[2]], 1)], 0))


def _kf_meta(state, lf_lvl, cdef_idx):
    """Keyframe compact meta packing so the host does ONE small fetch.

    Returns (meta flat int8 = [B+1 hdr rows | counts | nonzero pos/val
    stream | per-SB cdef idx], lv_y/lv_u/lv_v int16 device arrays for
    the overflow gather). Hdr row: flags (skip, split) | my[5] | mu[5] |
    cf[2] | ytx[4] | s16[4] | ym8[16] | uvm8[16]; tail row: [lf_lvl]."""
    (_, _, _, ly, lu, lvv, my, mu, sp, cf, ytx, s16, ym8, uvm8) = state
    bh, bw = sp.shape
    B = bh * bw
    _, skip_b, split = _kf_skip_flags(state)
    ly_f = ly.reshape(B, LB, LB)
    lu_f = lu.reshape(B, CB, CB)
    lv_f = lvv.reshape(B, CB, CB)
    sl = scanline(ly_f, lu_f, lv_f, _kf_quads(ly_f, LB // 2),
                  _kf_quads(lu_f, CB // 2), _kf_quads(lv_f, CB // 2),
                  split, B)
    counts, pos, val = nnz_stream(sl, _kf_stream_cap(B))
    i8 = torch.int8
    row = torch.cat(
        [torch.stack([skip_b, split], dim=1).to(i8),
         my.reshape(B, 5).to(i8), mu.reshape(B, 5).to(i8),
         cf.reshape(B, 2).to(i8), ytx.reshape(B, 4).to(i8),
         s16.reshape(B, 4).to(i8), ym8.reshape(B, 16).to(i8),
         uvm8.reshape(B, 16).to(i8)], dim=1)
    tail = torch.zeros((1, KF_META), dtype=i8, device=row.device)
    tail[0, 0] = lf_lvl.to(i8)
    hdr = torch.cat([row, tail], dim=0)

    def words1(x):
        x = x.to(torch.int32)
        return torch.stack([(x >> 8).to(i8), (x & 255).to(i8)],
                           -1).reshape(-1)

    meta = torch.cat([hdr.reshape(-1), words1(counts), words1(pos),
                      words1(val), cdef_idx.reshape(-1).to(i8)])
    return (meta, ly_f.to(torch.int16), lu_f.to(torch.int16),
            lv_f.to(torch.int16))


def _finalize_kf(state, srcs, base_lf: int, cdef_prm, lam, use_cdef: bool,
                 use_deblock: bool, cdef_rdo: bool = False, mark=_nomark):
    """Device-side keyframe epilogue: in-loop filter searches, then the
    compact meta packing."""
    lf_lvl, cdef_idx, rec_packed = _kf_filters(
        state, srcs, base_lf, cdef_prm, lam, use_cdef, use_deblock,
        cdef_rdo, mark)
    meta, lvy, lvu, lvv = _kf_meta(state, lf_lvl, cdef_idx)
    return meta, rec_packed, lvy, lvu, lvv


# ---- entry point ------------------------------------------------------------

class KeyframeDevice(NamedTuple):
    """What the device half of a keyframe encode leaves on the device:
    the unskewed 14-grid state (pre-deblock recon, levels, decisions),
    the meta buffer, the filtered recon and the int16 level arrays; and
    the CDEF settings the host half signals."""
    state: tuple
    meta: torch.Tensor
    rec_packed: torch.Tensor
    lvy: torch.Tensor
    lvu: torch.Tensor
    lvv: torch.Tensor
    cdef: tuple | None = None
    cdef_rdo: bool = True


def _check_speed(speed: int):
    if speed < 8:
        _not_ported(f"speed {speed} (< 8: split RDO, and at 6 CfL, TX "
                    "search, split8, the directional modes)",
                    "item 8 (keyframes at speeds 8 and 6)")


def _check_options(speed, cdef, lr, aq, deferred, planes, seq_extra):
    _check_speed(speed)
    if cdef is not None and len(cdef) != 5:
        raise ValueError("cdef is (y_pri, y_sec, uv_pri, uv_sec, damping)")
    if aq:
        _not_ported("variance AQ", "item 14 (keyframe variance AQ)")
    if lr:
        _not_ported("loop restoration", "item 13 (LRF)")
    if deferred:
        _not_ported("the deferred keyframe pack",
                    "item 10 (encode_gop + port bench)")
    if ((seq_extra or {}).get("bit_depth", 8) > 8
            or any(int(np.max(p)) > 255 for p in planes)):
        _not_ported("bit depth above 8", "item 12 (bd=10)")


def _mode_sets(speed: int):
    """(modes_y, modes_uv) of a speed preset, as the reference derives
    them from SpeedSettings."""
    ss = SpeedSettings.from_preset(speed)
    modes_y = (MODES_FULL if ss.intra_modes >= 13 else
               (MODES_7 if ss.intra_modes >= 7 else MODES_FAST))
    modes_uv = (MODES_UV_FULL if ss.intra_modes >= 13 else
                (MODES_UV if ss.intra_modes >= 7 else MODES_FAST))
    return modes_y, modes_uv


def analyze_keyframe(planes, qindex: int = 100, speed: int = 6,
                     deblock: bool = True, cdef: tuple | None = None,
                     cdef_rdo: bool = True, device=None,
                     timings: dict | None = None) -> KeyframeDevice:
    """The device half of a keyframe encode (steps 1-5 of
    encode_keyframe_tpu): upload, rd, phase 1, phase 2, the deblock and
    CDEF searches and meta packing, with the speed preset's mode sets.
    cdef: None (off) or (y_pri, y_sec, uv_pri, uv_sec, damping); with
    cdef_rdo each 64x64 SB takes its ladder entry (damping cdef[4]),
    else the tuple is one fixed strength."""
    _check_speed(speed)
    dev = resolve_device(device)
    stages = _Stages(dev, timings)
    y, u, v = (np.asarray(p) for p in planes)
    h, w = y.shape
    if h % LB or w % LB:
        raise ValueError("pad the planes to multiples of 32")
    bh, bw = h // LB, w // LB
    # one upload: y over u|v, uint8
    packed = torch.from_numpy(np.ascontiguousarray(np.concatenate(
        [y, np.concatenate([u, v], axis=1)], axis=0).astype(np.uint8)))
    src = packed.to(dev)
    sy = _to_blocks_t(src[:h], LB)
    su = _to_blocks_t(src[h:, :w // 2], CB)
    sv = _to_blocks_t(src[h:, w // 2:], CB)
    modes_y, modes_uv = _mode_sets(speed)
    rd = build_rd(qindex, modes_y, modes_uv, device=dev)
    ii_sk, jj_sk, has_l_sk, _, un_d, un_s = _skew_tables(bh, bw)
    isk, jsk = (torch.as_tensor(a, device=dev).long() for a in (ii_sk,
                                                                  jj_sk))
    ud, us = (torch.as_tensor(a, device=dev).long() for a in (un_d, un_s))
    has_l_t = torch.as_tensor(has_l_sk, device=dev)
    stages.mark("setup")

    def skew(arr):
        return arr[isk, jsk]

    def unskew(sk):
        return sk[ud, us]

    # ---- phase 1: mode decisions from SOURCE edges, fully batched
    dec = wavefront_frame((sy, su, sv), (sy, su, sv), rd, modes_y,
                          modes_uv, approx=True)
    stages.mark("phase1")
    # ---- phase 2: decoder-order recon with the chosen modes
    rw = recon_wavefront(skew(sy), skew(su), skew(sv), skew(dec[6]),
                         skew(dec[7]), has_l_t, rd, modes_y, modes_uv)
    stages.mark("recon_wavefront")
    state = tuple(unskew(x) for x in rw) + tuple(dec[6:])
    cdef_prm = tuple(cdef) if cdef is not None else (0, 0, 0, 0, 3)
    lf_lvl, cdef_idx, rec_packed = _kf_filters(
        state, (sy, su, sv), level_from_qindex(qindex), cdef_prm, rd["lam"],
        cdef is not None, deblock, cdef_rdo, stages.mark)
    meta, lvy, lvu, lvv = _kf_meta(state, lf_lvl, cdef_idx)
    stages.mark("meta")
    return KeyframeDevice(state, meta, rec_packed, lvy, lvu, lvv,
                          None if cdef is None else cdef_prm, cdef_rdo)


def encode_keyframe_tpu(planes: list[np.ndarray], qindex: int = 100,
                        speed: int = 6, deblock: bool = True,
                        cdef: tuple | None = None,
                        render_size: tuple | None = None,
                        seq_extra: dict | None = None,
                        cdef_rdo: bool = True, lr: bool = False,
                        aq: bool = False, deferred: bool = False,
                        device=None, timings: dict | None = None):
    """KEY frame encode on the device; dims must be multiples of 32,
    4:2:0 8-bit. Runs on `cuda` unless device="cpu" is passed. The
    defaults are the reference's; speeds below 8 raise
    NotImplementedError (ROADMAP.md item 8).

    cdef: None disables CDEF at the sequence level; a 5-tuple (y_pri,
    y_sec, uv_pri, uv_sec, damping) enables it — with cdef_rdo each
    64x64 SB picks its ladder entry (damping cdef[4]) and the frame
    signals the entries used; cdef_rdo=False applies the tuple as one
    fixed frame-wide strength.

    Returns (packet, [y, u, v] recon int32) — the same as the
    reference's encode_keyframe_tpu at the same speed: the recon is the
    decoder's output (deblocking and CDEF included). `timings`, when
    given, receives the wall time of each stage."""
    _check_options(speed, cdef, lr, aq, deferred, planes, seq_extra)
    dev = resolve_device(device)
    kd = analyze_keyframe(planes, qindex, speed, deblock, cdef, cdef_rdo,
                          dev, timings)
    return pack_keyframe(kd, planes, qindex, render_size, seq_extra, dev,
                         timings)


def pack_keyframe(kd: KeyframeDevice, planes, qindex: int = 100,
                  render_size: tuple | None = None,
                  seq_extra: dict | None = None, device=None,
                  timings: dict | None = None):
    """The host half of a keyframe encode (the reference's deferred
    `_finish`): one fetch of the meta buffer and the recon, unpack, the
    overflow gather, the tile walk (its IR range-coded on `device`) and
    the OBU packet. Returns (packet, [y, u, v] recon int32)."""
    dev = resolve_device(device)
    stages = _Stages(dev, timings)
    h, w = np.asarray(planes[0]).shape
    bh, bw = h // LB, w // LB
    B = bh * bw
    cap = _kf_stream_cap(B)

    # ---- fetch + unpack (host) ----
    meta = kd.meta.cpu().numpy()
    o0 = (B + 1) * KF_META
    body = meta[:o0].reshape(B + 1, KF_META)
    body, mtail = body[:-1], body[-1]
    lf = int(mtail[0])
    sp = (body[:, 1] != 0).reshape(bh, bw)
    my = body[:, 2:7].astype(np.int32).reshape(bh, bw, 5)
    mu = body[:, 7:12].astype(np.int32).reshape(bh, bw, 5)

    def unw(raw):
        wd = raw.reshape(-1, 2).astype(np.int32)
        return wd[:, 0] * 256 + (wd[:, 1] & 0xFF)

    o1 = o0 + 2 * B
    o2 = o1 + 2 * (cap + 1)
    counts = unw(meta[o0:o1])
    pos = unw(meta[o1:o2])
    o3 = o2 + 2 * (cap + 1)
    val = unw(meta[o2:o3]).astype(np.int16)
    nr, nc = (bh + 1) // 2, (bw + 1) // 2
    cdef_map = (meta[o3:].astype(np.uint8).reshape(nr, nc)
                if kd.cdef is not None and kd.cdef_rdo else None)
    lv_y, lv_u, lv_v, over = unpack_stream(counts, pos, val,
                                           sp.reshape(B), cap)
    didx = np.nonzero(over)[0]
    if len(didx):
        gd = gather_dense(kd.lvy, kd.lvu, kd.lvv,
                          torch.as_tensor(didx, device=dev)).cpu().numpy()
        lv_y[didx] = gd[:, :1024].reshape(-1, 32, 32)
        lv_u[didx] = gd[:, 1024:1280].reshape(-1, 16, 16)
        lv_v[didx] = gd[:, 1280:].reshape(-1, 16, 16)
    ly = lv_y.reshape(bh, bw, 32, 32)
    lu = lv_u.reshape(bh, bw, 16, 16)
    lvv = lv_v.reshape(bh, bw, 16, 16)
    rp = kd.rec_packed.cpu().numpy()
    rec = [rp[:h].astype(np.int32), rp[h:, :w // 2].astype(np.int32),
           rp[h:, w // 2:].astype(np.int32)]
    stages.mark("fetch_unpack")

    # ---- tile walk (host) into the writer; the kernel codes the IR ----
    t_walk = time.perf_counter()
    seq = Sequence(width=w, height=h, enable_cdef=kd.cdef is not None)
    for k, v_ in (seq_extra or {}).items():
        setattr(seq, k, v_)
    fp = FrameParams(frame_type=FrameType.KEY, base_q_idx=qindex,
                     loop_filter_levels=(lf, lf, lf, lf),
                     render_size=render_size)
    fp.delta_q_u_dc = fp.delta_q_u_ac = chroma_dq(qindex)
    cdef_bits = 0
    if cdef_map is not None:
        fp.cdef_damping = kd.cdef[4]
        fp.cdef_strengths, cdef_bits, cdef_map = compact_ladder(cdef_map)
    elif kd.cdef is not None:
        (fp.cdef_y_pri, fp.cdef_y_sec, fp.cdef_uv_pri, fp.cdef_uv_sec,
         fp.cdef_damping) = kd.cdef
    ti = TileInfo(seq)
    mi_rows, mi_cols = h >> 2, w >> 2
    ec_times: dict = {}
    tw = TileWriter(mi_rows, mi_cols, qindex,
                    encoder=functools.partial(RecordingEncoder, dev,
                                              ec_times))
    if cdef_bits:
        tw.cdef_bits = cdef_bits
        tw.cdef_idx_map = cdef_map
    partitions: dict = {}
    blocks: dict = {}
    for bi in range(bh):
        for bj in range(bw):
            r, c = bi * 8, bj * 8
            yl, ul, vl = ly[bi, bj], lu[bi, bj], lvv[bi, bj]
            d = BlockDecision(y_mode=PredictionMode(int(my[bi, bj, 0])),
                              uv_mode=PredictionMode(int(mu[bi, bj, 0])),
                              skip=False, seg_id=0)
            if not yl.any() and not ul.any() and not vl.any():
                d.skip = True
            else:
                d.coeffs = {0: yl, 1: ul, 2: vl,
                            "y_tx_type": TxType.DCT_DCT}
            blocks[(r, c)] = d
            partitions[(r, c, int(BlockSize.B32X32))] = PartitionType.NONE
    for r in range(0, mi_rows, 16):
        for c in range(0, mi_cols, 16):
            partitions[(r, c, int(BlockSize.B64X64))] = PartitionType.SPLIT
    tile = tw.write_tile(partitions, blocks)
    pkt = keyframe_packet(seq, fp, ti, [tile])
    if timings is not None:
        # the walk's own time: the coding stages are timed in done()
        timings["tile_walk"] = (time.perf_counter() - t_walk
                                - ec_times["ec_kernel"] - ec_times["finish"])
        timings.update(ec_times)
    return pkt, rec
