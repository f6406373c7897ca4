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

Then `_kf_filters` runs the deblock level search and CDEF (the per-SB
ladder search of ops/cdef, or one fixed strength) and `_kf_meta` packs
the meta + nonzero-coefficient stream; the host unpacks it, the C++
packer (entropy/native.py) walks the tile into od_ec symbol IR in one
call, the CUDA kernels of entropy/ec_cuda range-code the IR, and the
host builds the OBU packet. With deferred=True that host half is handed
back as a callable for a worker thread (encode_gop_tpu runs it while
the P frames compute).

The toolsets of every speed preset (api/speed.py): DC-only luma and
chroma at speeds 9-10, the 7 non-directional luma modes and 4 chroma
modes at speeds 7-8 (chroma 16x16 then codes in the mode's TX type), at
speed 7 PARTITION_SPLIT RDO (each 32x32 block also tries four 16x16
luma + 8x8 joint-uv quads, coded in order TL, TR, BL, BR with each
quad's edges read from the quads before it), and at speeds 0-6 the
speed-6 keyframe:
  - 13 luma modes: D45/D67 read the above-right extension and D203 the
    below-left one, so the recon schedule is d = 2i + j (block (i-1,
    j+1) is then one diagonal earlier) and D203 is selectable only where
    the decoder replicates its below-left edge;
  - 10 chroma modes and CfL (one alpha per plane from the prediction
    SSE, then one full trial);
  - the four QUAD_TXS luma TX types per 16x16 quad;
  - when the source has detail in the 8..16 px band (_detail_band8 >
    256), each quad may split again into four 8x8 luma blocks with 4x4
    joint-uv chroma (the 16->8 split).
Loop restoration (lr=True) runs on the device recon (pipeline/lr.py)
and packs with the Python TileWriter, as the reference does; so does
variance AQ (aq=True: a segment a 32-block by its luma variance
quartile, each block quantized at its segment's qindex in both phases).
A bit depth above 8 raises NotImplementedError naming the ROADMAP.md
item (the reference codes it on its numpy keyframe, pipeline/intra.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from rav1e_tpu_torch import trace
from rav1e_tpu_torch.core.constants import (
    BlockSize,
    FrameType,
    PartitionType,
    PredictionMode,
    TxSize,
    TxType,
)
from rav1e_tpu_torch.api.speed import SpeedSettings
from rav1e_tpu_torch.device import SideStream, resolve_device, to_host
from rav1e_tpu_torch.entropy.ec_cuda import IRRecorder
from rav1e_tpu_torch.entropy.native import NativeTileWriter
from rav1e_tpu_torch.entropy.obu import (
    FrameParams,
    Sequence,
    TileInfo,
    keyframe_packet,
)
from rav1e_tpu_torch.entropy.tile import (
    INTRA_TX_SET2,
    BlockDecision,
    TileWriter,
    chroma_tx_type,
)
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
    _code_tiles,
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
# D203 below-left: the 2i+j schedule); the 16x16 quads skip the
# extension-reading modes
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
             modes_quad=None, device=None, use_cfl: bool = False,
             tx_search: bool = False, split8: bool = False) -> dict:
    """All RD inputs of the mode pass and the recon wavefront:
    quantizers, λ, rate LUTs, per-candidate mode-signaling bits,
    partition bits — a dict of tensors on `device`, with the reference's
    keys, values and dtypes.

    tx_search adds "ytxb" [len(QUAD_TXS), K]: the intra_ext_tx2 symbol
    bits per (TX candidate, quad mode); use_cfl adds "cfl_bits" (the CfL
    mode, a joint sign other than zero-zero, two alpha symbols); split8
    adds the TX_8X8 luma / TX_4X4 chroma rate LUTs "y8" / "c4" and
    "split16_bits" (SPLIT@16 instead of NONE@16, plus 4x NONE@8)."""
    from rav1e_tpu_torch.entropy.cost import (
        mode_cost_tables,
        rd_lambda,
        symbol_bits,
        tables,
    )
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
    out = {}
    if tx_search:
        # CDF row sqr(16x16) = 2 of intra_ext_tx2, per prediction mode;
        # the candidates are set-2 symbols 1..4
        t2 = tables()["intra_ext_tx2"]
        out["ytxb"] = t([[symbol_bits(t2[2, int(m)])[ti + 1]
                          for m in (modes_quad or modes_y)]
                         for ti in range(len(QUAD_TXS))], np.float32)
    if use_cfl:
        out["cfl_bits"] = t(mc["uv_mode_cfl"][int(P.UV_CFL_PRED)]
                            + float(mc["cfl_sign"][1:].mean())
                            + 2.0 * float(mc["cfl_alpha"].mean()),
                            np.float32)
    if split8:
        p8 = mc["partition_8"]
        out["y8"] = rate_luts(qindex, TxSize.TX_8X8, 0, dev)
        out["c4"] = rate_luts(qc, TxSize.TX_4X4, 1, dev)
        out["split16_bits"] = t(pm[int(PartitionType.SPLIT)]
                                - pm[int(PartitionType.NONE)]
                                + 4.0 * p8[int(PartitionType.NONE)],
                                np.float32)
    return out | {
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
    """Quantize with quantizer scalars (0-d int32 tensors) or per-block
    quantizers ([n] int32, one per leading block of cf: variance AQ,
    each block at its segment's qindex, spec get_qidx)."""
    shift = tx_scale(tx_size)
    m, bias = _dc_grids(tx_size, cf.device)
    if dcq.dim():
        dcq, acq = dcq[:, None, None], acq[:, None, None]
    q = torch.where(m, dcq, acq).to(torch.int32)
    a = torch.abs(cf) << shift
    lv = torch.clamp(
        torch.div(a + torch.div(q * bias, 64, rounding_mode="floor"), q,
                  rounding_mode="floor"), max=(1 << 15) - 1)
    return torch.sign(cf) * lv


def _dq_dyn(lv, tx_size, dcq, acq):
    shift = tx_scale(tx_size)
    m, _ = _dc_grids(tx_size, lv.device)
    if dcq.dim():
        dcq, acq = dcq[:, None, None], acq[:, None, None]
    q = torch.where(m, dcq, acq).to(torch.int32)
    dqv = ((torch.abs(lv) * q) & 0xFFFFFF) >> shift
    return torch.sign(lv) * dqv


def _cand_eval(preds, srcb, tx_size, dqs, tts, maxpx=255, approx=False):
    """Evaluate K prediction candidates: returns (rec, lv, sse) stacked
    [K, N, h, w] / [K, N]; tts: per-candidate TxType list (one batched
    chain when all candidates share a type, else one chain each); dqs:
    the (dc, ac) quantizers, scalars or per-block [N].

    approx=True swaps the spec-exact integer inverse for the float
    inverse — for mode RANKING only; callers reconstruct survivors
    exactly."""
    inv = T.inverse_approx if approx else T.inverse_transform
    K, n, blkh, blkw = preds.shape
    dq0, dq1 = dqs
    if len(set(tts)) == 1:
        if dq0.dim():
            dq0, dq1 = dq0.repeat(K), dq1.repeat(K)
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


def _sub_edge(cur, ea, el, etl, has_a, has_l, r0: int, c0: int, half: int):
    """Edges of the sub-block at (r0, c0), size `half`, of blocks whose
    in-progress recon is `cur` [n, B, B]; ea/el/etl are the outer
    blocks' edges (valid per has_a/has_l). Inside the block the edges
    are always available; the top-left pixel of an edge sub-block comes
    from the outer edge it lies on, 0 where that edge is missing.
    Returns (above, left, top-left, has_above, has_left); the first
    three may be views of `cur`, read before `cur` is written."""
    n = cur.shape[0]
    ones = torch.ones((n,), dtype=torch.bool, device=cur.device)
    if r0 > 0:
        sa, ha = cur[:, r0 - 1, c0: c0 + half], ones
    else:
        sa, ha = ea[:, c0: c0 + half], has_a
    if c0 > 0:
        sl, hl = cur[:, r0: r0 + half, c0 - 1], ones
    else:
        sl, hl = el[:, r0: r0 + half], has_l
    if r0 > 0 and c0 > 0:
        stl = cur[:, r0 - 1, c0 - 1]
    elif r0 > 0:
        stl = torch.where(has_l, el[:, r0 - 1], 0)
    elif c0 > 0:
        stl = torch.where(has_a, ea[:, c0 - 1], 0)
    else:
        stl = etl
    return sa, sl, stl, ha, hl


QUADS = ((0, 0), (0, 1), (1, 0), (1, 1))   # TL, TR, BL, BR (row, col)

KF_SEG_ALT_Q = (-18, -6, 6, 18)     # variance-AQ segment q deltas
# rd's quantizer keys, their per-block variance-AQ grids [bh, bw] and
# those grids skewed [D, S] (the reference's names)
_AQ_KEYS = (("qdc", "qdc_g", "qdc_sk"), ("qac", "qac_g", "qac_sk"),
            ("qdc_c", "qdc_cg", "qdc_csk"), ("qac_c", "qac_cg", "qac_csk"))

# luma TX16 intra tx-type candidates: symbols 1..4 of INTRA_TX_SET2
# (IDTX excluded: a screen-content tool)
QUAD_TXS = (TxType.DCT_DCT, TxType.ADST_ADST, TxType.ADST_DCT,
            TxType.DCT_ADST)


def _quad_plane(edges, has_a, has_l, srcb, tx_size, dqs, modes, lam, L,
                mbits, approx):
    """Luma 4-way split of blocks of size 2 * tx_size (the 16->8 split):
    four sub-blocks RDO'd in order TL, TR, BL, BR over `modes` (DCT_DCT),
    each predicted from the in-progress recon of those before it.
    edges: the outer blocks' (above, left, top-left). Returns (rec,
    levels [n, B, B], modes [n, 4] int32, cost [n], the sub-blocks'
    costs added one at a time in order)."""
    half = tx_size.height
    n = srcb.shape[0]
    dev = srcb.device
    sel = torch.arange(n, device=dev)
    K = len(modes)
    cur = torch.zeros((n, 2 * half, 2 * half), dtype=torch.int32, device=dev)
    clv = torch.zeros_like(cur)
    mode_tab = _modes_tensor(modes, dev)
    ms = []
    tot = torch.zeros((n,), dtype=torch.float32, device=dev)
    for qr, qc in QUADS:
        r0, c0 = qr * half, qc * half
        preds = predict_modes(modes, *_sub_edge(cur, *edges, has_a, has_l,
                                                r0, c0, half), half, half)
        recb, lvk, sse = _cand_eval(
            preds, srcb[:, r0: r0 + half, c0: c0 + half], tx_size, dqs,
            [TxType.DCT_DCT] * K, approx=approx)
        cost = sse + lam * (block_bits(lvk, L) + mbits[:, None])
        best = torch.argmin(cost, dim=0)
        cur[:, r0: r0 + half, c0: c0 + half] = recb[best, sel]
        clv[:, r0: r0 + half, c0: c0 + half] = lvk[best, sel]
        ms.append(mode_tab[best])
        tot = tot + cost[best, sel]
    return cur, clv, torch.stack(ms, dim=-1), tot


def _cquad(edges_u, edges_v, has_a, has_l, src_u, src_v, tx, dqs, modes_uv,
           lam, L, uvbits, cts, approx):
    """Joint-uv 4-way split of a chroma region of size 2 * tx.height (the
    4x4 children of a 16->8 split): four sub-blocks RDO'd in order, one
    shared uv mode each. Returns (rec_u, rec_v, lv_u, lv_v, modes [n, 4],
    cost [n])."""
    half = tx.height
    n = src_u.shape[0]
    dev = src_u.device
    sel = torch.arange(n, device=dev)
    cu = torch.zeros((n, 2 * half, 2 * half), dtype=torch.int32, device=dev)
    cv, cul, cvl = (torch.zeros_like(cu) for _ in range(3))
    mode_tab = _modes_tensor(modes_uv, dev)
    ms = []
    tot = torch.zeros((n,), dtype=torch.float32, device=dev)
    for qr, qc in QUADS:
        r0, c0 = qr * half, qc * half
        sau, slu, stu, hau, hlu = _sub_edge(cu, *edges_u, has_a, has_l, r0,
                                            c0, half)
        sav, slv, stv, _, _ = _sub_edge(cv, *edges_v, has_a, has_l, r0, c0,
                                        half)
        pu = predict_modes(modes_uv, sau, slu, stu, hau, hlu, half, half)
        pv = predict_modes(modes_uv, sav, slv, stv, hau, hlu, half, half)
        cs = (slice(None), slice(r0, r0 + half), slice(c0, c0 + half))
        ru, lu, su = _cand_eval(pu, src_u[cs], tx, dqs, cts, approx=approx)
        rv, lv, sv = _cand_eval(pv, src_v[cs], tx, dqs, cts, approx=approx)
        cst = su + sv + lam * (block_bits(lu, L) + block_bits(lv, L)
                               + uvbits[:, None])
        bq = torch.argmin(cst, dim=0)
        cu[cs], cv[cs] = ru[bq, sel], rv[bq, sel]
        cul[cs], cvl[cs] = lu[bq, sel], lv[bq, sel]
        ms.append(mode_tab[bq])
        tot = tot + cst[bq, sel]
    return cu, cv, cul, cvl, torch.stack(ms, dim=-1), tot


def wavefront_frame(edges, srcs, rd, modes_y, modes_uv, approx=False,
                    modes_quad=None, split_rdo: bool = False):
    """Phase 1, the dense mode pass (the reference's wavefront_frame
    with dense=True): every block of the frame on ONE "diagonal" in
    raster order, with `edges` (block grids [bh, bw, b, b] of y, u, v)
    standing in for the recon state, so block reads are reshapes and
    edge reads are static row/col shifts of the block grid.

    Returns the reference's 14 block grids: (y_rec, u_rec, v_rec, y_lv,
    u_lv, v_lv, y_modes [bh,bw,5], uv_modes [bh,bw,5], split, cfl
    [bh,bw,2], y_txs [bh,bw,4], s16 [bh,bw,4], ym8 [bh,bw,4,4],
    uvm8 [bh,bw,4,4]). The mode stores hold the 32-mode in slot 0 and
    the quads' modes in slots 1..4 (the 32-mode again without
    split_rdo). split_rdo adds the PARTITION_SPLIT candidate over
    `modes_quad` (default modes_y). What else runs follows rd's keys:
    "has_tr"/"d203_ok" [bh, bw] (the extension-reading directional
    modes: above-right pixels where block (i-1, j+1) is decoded first,
    D203 only where the decoder replicates below-left), "cfl_bits" (the
    CfL candidate), "ytxb" (the quads' TX type search) and "y8" (the
    16->8 split). With "qdc_g" (variance AQ: the per-block quantizers
    qdc_g / qac_g / qdc_cg / qac_cg [bh, bw]) each block quantizes at its
    segment's qindex."""
    lam = rd["lam"]
    ry, ru, rv = edges
    dev = ry.device
    bh_g, bw_g = ry.shape[0], ry.shape[1]
    if modes_quad is None:
        modes_quad = modes_y

    def _dn(a):     # row i <- max(i-1, 0)
        return torch.cat([a[:1], a[:-1]], 0)

    def _rt(a):     # col j <- max(j-1, 0)
        return torch.cat([a[:, :1], a[:, :-1]], 1)

    def _lt(a):     # col j <- min(j+1, bw-1)
        return torch.cat([a[:, 1:], a[:, -1:]], 1)

    def blk(arr):
        return arr.reshape((-1,) + tuple(arr.shape[2:]))

    if "qdc_g" in rd:
        # variance AQ: the blocks' segment quantizers, in block order
        rd = rd | {k: blk(rd[g]) for k, g, _ in _AQ_KEYS}

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
    aext = lext = None
    if "has_tr" in rd:
        # above-right row from block (i-1, j+1), else the last above
        # pixel replicated; below-left always replicated
        ar = blk(_lt(_dn(ry)))[:, LB - 1, :]
        tr_ok = rd["has_tr"].reshape(-1)
        aext = torch.cat([a_y, torch.where(tr_ok[:, None], ar,
                                           a_y[:, -1:].expand(-1, LB))], 1)
        lext = torch.cat([l_y, l_y[:, -1:].expand(-1, LB)], 1)
    preds32 = predict_modes(modes_y, a_y, l_y, tl_y, has_a, has_l, LB, LB,
                            aext=aext, lext=lext)
    rec32, lv32, sse32 = _cand_eval(
        preds32, srcb_y, TxSize.TX_32X32, (rd["qdc"], rd["qac"]),
        [TxType.DCT_DCT] * len(modes_y), approx=approx)
    cost32 = sse32 + lam * (block_bits(lv32, rd["y32"])
                            + rd["ybits"][:, None])
    if "d203_ok" in rd and P.D203_PRED in modes_y:
        k = modes_y.index(P.D203_PRED)
        pen = torch.where(rd["d203_ok"].reshape(-1), 0.0, 1e18)
        cost32 = torch.cat([cost32[:k], (cost32[k] + pen)[None],
                            cost32[k + 1:]])
    b32 = torch.argmin(cost32, dim=0)
    y_rec, y_lv = rec32[b32, sel], lv32[b32, sel]
    y32_mode = _modes_tensor(modes_y, dev)[b32]

    # ---- chroma 16 candidates (joint u+v mode) ----
    cts16 = [chroma_tx_type(m, TxSize.TX_16X16, True) for m in modes_uv]
    dqs_c = (rd["qdc_c"], rd["qac_c"])

    def chroma_cands(rec, src):
        a, l_, tl = gather_edges(rec, CB, CB)
        preds = predict_modes(modes_uv, a, l_, tl, has_a, has_l, CB, CB)
        return (*_cand_eval(preds, blk(src), TxSize.TX_16X16, dqs_c, cts16,
                            approx=approx), preds[0])

    ur, ulv, usse, dc_u = chroma_cands(ru, srcs[1])
    vr, vlv, vsse, dc_v = chroma_cands(rv, srcs[2])
    ccost = (usse + vsse
             + lam * (block_bits(ulv, rd["c16"])
                      + block_bits(vlv, rd["c16"])
                      + rd["uvbits"][:, None]))
    bc = torch.argmin(ccost, dim=0)
    c16_mode = _modes_tensor(modes_uv, dev)[bc]
    u_rec, v_rec = ur[bc, sel], vr[bc, sel]
    u_lv, v_lv = ulv[bc, sel], vlv[bc, sel]
    c16_cost = ccost[bc, sel]

    i32 = torch.int32
    zeros = functools.partial(torch.zeros, device=dev)
    cfl = zeros((n, 2), dtype=i32)
    if "cfl_bits" in rd:
        cfl_u, cfl_v, cf = _cfl_candidate(y_rec, dc_u, dc_v, blk(srcs[1]),
                                          blk(srcs[2]), rd, approx)
        take = cf["cost"] < c16_cost
        t3 = take[:, None, None]
        u_rec = torch.where(t3, cf["u"], u_rec)
        v_rec = torch.where(t3, cf["v"], v_rec)
        u_lv = torch.where(t3, cf["ulv"], u_lv)
        v_lv = torch.where(t3, cf["vlv"], v_lv)
        c16_mode = torch.where(take, int(P.UV_CFL_PRED), c16_mode)
        c16_cost = torch.where(take, cf["cost"], c16_cost)
        cfl = torch.stack([torch.where(take, cfl_u, 0),
                           torch.where(take, cfl_v, 0)], dim=-1)

    y_modes = y32_mode[:, None].expand(n, 5).contiguous()
    uv_modes = c16_mode[:, None].expand(n, 5).contiguous()
    split = zeros((n,), dtype=torch.bool)
    y_txs = torch.ones((n, 4), dtype=i32, device=dev)
    s16 = zeros((n, 4), dtype=torch.bool)
    ym8 = zeros((n, 4, 4), dtype=i32)
    uvm8 = zeros((n, 4, 4), dtype=i32)
    if split_rdo:
        q = _split_quads(
            (a_y, l_y, tl_y), gather_edges(ru, CB, CB),
            gather_edges(rv, CB, CB), has_a, has_l,
            (srcb_y, blk(srcs[1]), blk(srcs[2])), rd, modes_quad, modes_uv,
            approx)
        split_cost = q["cost"] + lam * rd["split_bits"]
        none_cost = cost32[b32, sel] + c16_cost
        split = split_cost < none_cost
        s3 = split[:, None, None]
        y_rec = torch.where(s3, q["y"], y_rec)
        y_lv = torch.where(s3, q["ylv"], y_lv)
        u_rec = torch.where(s3, q["u"], u_rec)
        v_rec = torch.where(s3, q["v"], v_rec)
        u_lv = torch.where(s3, q["ulv"], u_lv)
        v_lv = torch.where(s3, q["vlv"], v_lv)
        y_modes = torch.cat([y32_mode[:, None], q["ym"]], 1)
        uv_modes = torch.cat([c16_mode[:, None], q["uvm"]], 1)
        y_txs = torch.where(split[:, None], q["ytx"], 1)
        cfl = torch.where(split[:, None], 0, cfl)
        if "s16" in q:
            # a 16->8 split lives only under a split 32 parent
            s16 = q["s16"] & split[:, None]
            ym8, uvm8 = q["ym8"], q["uvm8"]

    def g(x):
        return x.reshape((bh_g, bw_g) + tuple(x.shape[1:]))

    return (g(y_rec), g(u_rec), g(v_rec), g(y_lv), g(u_lv), g(v_lv),
            g(y_modes), g(uv_modes), g(split), g(cfl), g(y_txs), g(s16),
            g(ym8), g(uvm8))


def _cfl_luma_ac(yr):
    """CfL's AC contribution [n, 16, 16] from the 32x32 luma recon yr
    (spec 7.11.5, 4:2:0): 2x2 sums doubled, minus their rounded mean."""
    L = ((yr[:, 0::2, 0::2] + yr[:, 0::2, 1::2]
          + yr[:, 1::2, 0::2] + yr[:, 1::2, 1::2]) << 1)
    avg = (torch.sum(L, dim=(1, 2), keepdim=True, dtype=torch.int32)
           + (1 << 7)) >> 8
    return L - avg


def _cfl_pred(dc, alpha, ac):
    """DC + alpha * AC, rounded and clipped: dc [.., 16, 16], alpha
    broadcast against ac."""
    scl = alpha * ac
    return torch.clamp(dc + torch.sign(scl) * ((torch.abs(scl) + 32) >> 6),
                       0, 255)


def _cfl_candidate(y_rec, dc_u, dc_v, src_u, src_v, rd, approx):
    """The CfL candidate of phase 1 (rav1e rdo_cfl_alpha): per plane the
    alpha in -16..16 whose prediction has the least SSE against the
    source (the first of equal ones), then one full trial at the chosen
    pair; both alphas 0 is not codable and costs 1e18. Each prediction
    SSE is at most 255^2 * 256 = 16,646,400 < 2^24, so its f32 sum is
    exact in any order. Returns (alpha_u, alpha_v, {u, v, ulv, vlv,
    cost})."""
    lam = rd["lam"]
    ac = _cfl_luma_ac(y_rec)
    n = ac.shape[0]
    sel = torch.arange(n, device=ac.device)
    alphas = torch.arange(-16, 17, dtype=torch.int32, device=ac.device)

    def plane(dc, src):
        p = _cfl_pred(dc[None], alphas[:, None, None, None], ac[None])
        psse = torch.sum((p - src[None]).to(torch.float32) ** 2,
                         dim=(-2, -1))
        k = torch.argmin(psse, dim=0)
        return k.to(torch.int32) - 16, p[k, sel]

    au, pu = plane(dc_u, src_u)
    av, pv = plane(dc_v, src_v)
    ctt = chroma_tx_type(P.UV_CFL_PRED, TxSize.TX_16X16, True)
    dqs = (rd["qdc_c"], rd["qac_c"])
    ru, lu, su = _cand_eval(pu[None], src_u, TxSize.TX_16X16, dqs, [ctt],
                            approx=approx)
    rv, lv, sv = _cand_eval(pv[None], src_v, TxSize.TX_16X16, dqs, [ctt],
                            approx=approx)
    cost = (su[0] + sv[0]
            + lam * (block_bits(lu[0], rd["c16"])
                     + block_bits(lv[0], rd["c16"]) + rd["cfl_bits"])
            + torch.where((au == 0) & (av == 0), 1e18, 0.0))
    return au, av, {"u": ru[0], "v": rv[0], "ulv": lu[0], "vlv": lv[0],
                    "cost": cost}


def _split_quads(edges_y, edges_u, edges_v, has_a, has_l, srcs, rd,
                 modes_quad, modes_uv, approx):
    """The PARTITION_SPLIT candidate of phase 1: per quad (TL, TR, BL,
    BR) the best 16x16 luma mode over modes_quad (with rd["ytxb"], over
    the four QUAD_TXS types too), then the best joint-uv 8x8 mode, each
    quad predicted from the recon of the quads before it (_sub_edge).
    With rd["y8"] each quad also tries the 16->8 split (four 8x8 luma
    blocks, _quad_plane, and 4x4 joint-uv chroma, _cquad) and keeps the
    cheaper. The quad costs are added one at a time in quad order, as
    the reference adds them. Returns the quads' recon and levels
    (spatial [n, 32, 32] / [n, 16, 16]), their modes [n, 4], TX symbols
    [n, 4] and summed cost [n]; with split8 also s16 [n, 4] and the
    children's modes ym8 / uvm8 [n, 4, 4]."""
    lam = rd["lam"]
    srcb_y, srcu, srcv = srcs
    n = srcb_y.shape[0]
    dev = srcb_y.device
    sel = torch.arange(n, device=dev)
    i32 = torch.int32
    K = len(modes_quad)
    txbits = rd.get("ytxb")
    split8 = "y8" in rd
    cts8 = [chroma_tx_type(m, TxSize.TX_8X8, True) for m in modes_uv]
    cts4 = ([chroma_tx_type(m, TxSize.TX_4X4, True) for m in modes_uv]
            if split8 else None)
    mode_tab_q = _modes_tensor(modes_quad, dev)
    mode_tab_uv = _modes_tensor(modes_uv, dev)
    dqs, dqs_c = (rd["qdc"], rd["qac"]), (rd["qdc_c"], rd["qac_c"])
    cur = torch.zeros((n, LB, LB), dtype=i32, device=dev)
    clv = torch.zeros_like(cur)
    cur_u = torch.zeros((n, CB, CB), dtype=i32, device=dev)
    cur_v, cu_lv, cv_lv = (torch.zeros_like(cur_u) for _ in range(3))
    ym, uvm, ytx, s16, ym8, uvm8 = [], [], [], [], [], []
    tot = torch.zeros((n,), dtype=torch.float32, device=dev)
    half, h8 = CB, CB // 2
    for qr, qc in QUADS:
        r0, c0 = qr * half, qc * half
        # --- luma 16-whole, over the TX types with txbits ---
        sa, sl, stl, ha, hl = _sub_edge(cur, *edges_y, has_a, has_l, r0, c0,
                                        half)
        preds = predict_modes(modes_quad, sa, sl, stl, ha, hl, half, half)
        sub_src = srcb_y[:, r0: r0 + half, c0: c0 + half]
        recs, lvs, costs = [], [], []
        for ti, tt in enumerate(QUAD_TXS if txbits is not None
                                else QUAD_TXS[:1]):
            recb, lvk, sse = _cand_eval(preds, sub_src, TxSize.TX_16X16, dqs,
                                        [tt] * K, approx=approx)
            bits = block_bits(lvk, rd["y16"]) + rd["yqbits"][:, None]
            if txbits is not None:
                bits = bits + txbits[ti][:, None]
            costs.append(sse + lam * bits)
            recs.append(recb)
            lvs.append(lvk)
        cost = torch.cat(costs, 0)                # [len(types) * K, n]
        b16 = torch.argmin(cost, dim=0)
        rec16 = torch.cat(recs, 0)[b16, sel]
        lv16 = torch.cat(lvs, 0)[b16, sel]
        cost16 = cost[b16, sel]
        ytx.append((torch.div(b16, K, rounding_mode="floor") + 1).to(i32))
        ym.append(mode_tab_q[b16 % K])
        # --- chroma 8-whole (joint uv) ---
        cr0, cc0 = r0 // 2, c0 // 2
        eu = _sub_edge(cur_u, *edges_u, has_a, has_l, cr0, cc0, h8)
        ev = _sub_edge(cur_v, *edges_v, has_a, has_l, cr0, cc0, h8)
        pu = predict_modes(modes_uv, *eu[:3], eu[3], eu[4], h8, h8)
        pv = predict_modes(modes_uv, *ev[:3], eu[3], eu[4], h8, h8)
        cs = (slice(None), slice(cr0, cr0 + h8), slice(cc0, cc0 + h8))
        ru8, lu8, su8 = _cand_eval(pu, srcu[cs], TxSize.TX_8X8, dqs_c, cts8,
                                   approx=approx)
        rv8, lv8, sv8 = _cand_eval(pv, srcv[cs], TxSize.TX_8X8, dqs_c, cts8,
                                   approx=approx)
        cst = (su8 + sv8 + lam * (block_bits(lu8, rd["c8"])
                                  + block_bits(lv8, rd["c8"])
                                  + rd["uvbits"][:, None]))
        bq = torch.argmin(cst, dim=0)
        uvm.append(mode_tab_uv[bq])
        rq, lq = rec16, lv16
        uq, vq, uql, vql = ru8[bq, sel], rv8[bq, sel], lu8[bq, sel], \
            lv8[bq, sel]
        if split8:
            # --- four 8x8 luma children + the 4x4 joint-uv quad ---
            y8, y8l, y8m, y8c = _quad_plane(
                (sa, sl, stl), ha, hl, sub_src, TxSize.TX_8X8, dqs,
                modes_quad, lam, rd["y8"], rd["yqbits"], approx)
            u4, v4, u4l, v4l, c4m, c4c = _cquad(
                eu[:3], ev[:3], eu[3], eu[4], srcu[cs], srcv[cs],
                TxSize.TX_4X4, dqs_c, modes_uv, lam, rd["c4"],
                rd["uvbits"], cts4, approx)
            cost_split16 = y8c + c4c + lam * rd["split16_bits"]
            cost_whole = cost16 + cst[bq, sel]
            sq = cost_split16 < cost_whole
            s3 = sq[:, None, None]
            rq, lq = torch.where(s3, y8, rq), torch.where(s3, y8l, lq)
            uq, vq = torch.where(s3, u4, uq), torch.where(s3, v4, vq)
            uql, vql = torch.where(s3, u4l, uql), torch.where(s3, v4l, vql)
            tot = tot + torch.where(sq, cost_split16, cost_whole)
            s16.append(sq)
            ym8.append(y8m)
            uvm8.append(c4m)
        else:
            tot = tot + cost16 + cst[bq, sel]
        # the edge views above are consumed: write the quads in place
        cur[:, r0: r0 + half, c0: c0 + half] = rq
        clv[:, r0: r0 + half, c0: c0 + half] = lq
        cur_u[cs], cur_v[cs], cu_lv[cs], cv_lv[cs] = uq, vq, uql, vql
    out = {"y": cur, "ylv": clv, "u": cur_u, "v": cur_v, "ulv": cu_lv,
           "vlv": cv_lv, "ym": torch.stack(ym, 1), "uvm": torch.stack(uvm, 1),
           "ytx": torch.stack(ytx, 1), "cost": tot}
    if split8:
        out.update(s16=torch.stack(s16, 1), ym8=torch.stack(ym8, 1),
                   uvm8=torch.stack(uvm8, 1))
    return out


# ---- phase 2: recon wavefront on the diagonal-skewed layout ----------------

@functools.lru_cache(maxsize=8)
def _skew_tables(bh: int, bw: int, ext: bool = False):
    """Host tables for the diagonal-skewed layout: block (i, j) lives at
    [d, s] with d = (2 if ext else 1) * i + j, s = i — ext is the 2i+j
    schedule, under which the above-right block (i-1, j+1) is one
    diagonal earlier. Returns (ii [D,S], jj [D,S] clamped block indices,
    has_l [D,S], valid [D,S], unskew_d [bh,bw], unskew_s [bh,bw])."""
    stride = 2 if ext else 1
    D = stride * (bh - 1) + bw
    S = bh
    ii = np.zeros((D, S), np.int32)
    jj = np.zeros((D, S), np.int32)
    valid = np.zeros((D, S), bool)
    un_d = np.zeros((bh, bw), np.int32)
    un_s = np.zeros((bh, bw), np.int32)
    for i in range(bh):
        for j in range(bw):
            d = stride * i + j
            ii[d, i], jj[d, i], valid[d, i] = i, j, True
            un_d[i, j], un_s[i, j] = d, i
    has_l = valid & (jj > 0)
    return ii, jj, has_l, valid, un_d, un_s


def _edge_tables(bh: int, bw: int):
    """Decode-order edge availability of the 32x32 blocks (spec
    BlockDecoded: SB raster, then Z order within the 64x64 SB): (has_tr
    [bh, bw], the above-right block (i-1, j+1) is decoded before (i, j);
    d203_ok [bh, bw], the below-left block (i+1, j-1) is not, so the
    decoder replicates that edge as the encoder does)."""
    def dkey(i, j):
        return (i // 2, j // 2, (i % 2) * 2 + (j % 2))

    has_tr = np.zeros((bh, bw), bool)
    has_bl = np.zeros((bh, bw), bool)
    for i in range(bh):
        for j in range(bw):
            if i > 0 and j + 1 < bw:
                has_tr[i, j] = dkey(i - 1, j + 1) < dkey(i, j)
            if j > 0 and i + 1 < bh:
                has_bl[i, j] = dkey(i + 1, j - 1) < dkey(i, j)
    return has_tr, ~has_bl


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
                    modes_y, modes_uv, sp_sk=None, modes_quad=None,
                    cf_sk=None, tr_tab=None, ytx_sk=None, s16_sk=None,
                    ym8_sk=None, uvm8_sk=None):
    """Decoder-order reconstruction with FIXED per-block decisions.

    All arrays are diagonal-skewed: index [d, s] holds block (i=s,
    j=d-s), or (i=s, j=d-2s) on the 2i+j schedule (tr_tab given). State
    rows are offset +3 so neighbour reads (d-1..d-3) never clamp; every
    row index is still clamped as the reference's dynamic slices clamp
    theirs. The reference's fori_loop over the D diagonals is a Python
    loop; the state updates in place (the rows read in a step are never
    the row written).

    Optional decisions, each [D, S, ...] (None: the tool is off):
    sp_sk (split RDO) marks the blocks coded as four 16x16 luma quads
    (modes ym_sk[..., 1:] over modes_quad) and four 8x8 chroma quads
    (uvm_sk[..., 1:]), each predicted from the quads before it; tr_tab
    (the 2i+j schedule) whether block (i-1, j+1)'s bottom row extends
    the above edge of the directional modes; cf_sk the CfL alphas (u, v)
    of blocks whose chroma mode is UV_CFL_PRED; ytx_sk each luma quad's
    intra_ext_tx2 symbol (1..4 -> QUAD_TXS); s16_sk the quads coded as
    four 8x8 luma blocks (modes ym8_sk [D, S, 4, 4]) with 4x4 chroma
    (uvm8_sk). With "qdc_sk" in rd (variance AQ: the per-block
    quantizers skewed, qdc_sk / qac_sk / qdc_csk / qac_csk [D, S]) each
    diagonal quantizes its blocks at their segments' qindex. Returns
    skewed (rec_y, rec_u, rec_v, lv_y, lv_u, lv_v)."""
    D, S = has_l_tab.shape
    dev = sy_sk.device
    qdc, qac = rd["qdc"], rd["qac"]
    qdc_c, qac_c = rd["qdc_c"], rd["qac_c"]
    aq = "qdc_sk" in rd
    if modes_quad is None:
        modes_quad = modes_y
    ext = tr_tab is not None
    luty = torch.as_tensor(_mode_lut(modes_y), device=dev).long()
    lutq = torch.as_tensor(_mode_lut(modes_quad), device=dev).long()
    lutuv_np = _mode_lut(modes_uv)
    lutuv_np[int(P.UV_CFL_PRED)] = len(modes_uv)   # CfL after the modes
    lutuv = torch.as_tensor(lutuv_np, device=dev).long()
    tts16, tid16_np = _tts_select(modes_uv, TxSize.TX_16X16)
    tid16 = torch.as_tensor(tid16_np, device=dev).long()
    tts8, tid8_np = _tts_select(modes_uv, TxSize.TX_8X8)
    tid8 = torch.as_tensor(tid8_np, device=dev).long()
    tts4, tid4_np = _tts_select(modes_uv, TxSize.TX_4X4)
    tid4 = torch.as_tensor(tid4_np, device=dev).long()
    # rows back to the above, left and top-left blocks' diagonals
    o_a, o_l, o_tl = (2, 1, 3) if ext else (1, 1, 2)
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
        """TX chain per distinct TxType, selected by tid [S]."""
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

    def quads(ed, has_a, has_l, src, modes, pred_k, tx, code,
              children=None):
        """The four quads of one plane (or the four 16->8 children of a
        quad) in order, each predicted from those coded before it; ed /
        has_a / has_l: the outer blocks' edges and their availability;
        pred_k(qi) the index of each slot's mode in `modes`, code(qi,
        pred, src) its (recon, levels); children(qi, quad edges, src) the
        quad's 16->8 split recon and levels with the flag to take them.
        Returns (recon, levels) [S, 2 half, 2 half]."""
        half = tx.height
        cur = torch.zeros((S, 2 * half, 2 * half), dtype=i32, device=dev)
        clv = torch.zeros_like(cur)
        for qi, (qr, qc) in enumerate(QUADS):
            r0, c0 = qr * half, qc * half
            eq = _sub_edge(cur, *ed, has_a, has_l, r0, c0, half)
            pq = predict_modes(modes, *eq, half, half)
            sub = src[:, r0: r0 + half, c0: c0 + half]
            rq, lq = code(qi, sel_modes(pq, pred_k(qi)), sub)
            if children is not None:
                rc, lc, take = children(qi, eq, sub)
                rq = torch.where(take[:, None, None], rc, rq)
                lq = torch.where(take[:, None, None], lc, lq)
            # the edge views above are consumed: write the quad in place
            cur[:, r0: r0 + half, c0: c0 + half] = rq
            clv[:, r0: r0 + half, c0: c0 + half] = lq
        return cur, clv

    for d in range(D):
        row = d + 3
        has_l = rows(has_l_tab, d)
        ym_d = rows(ym_sk, d).long()
        uvm_d = rows(uvm_sk, d).long()
        sy_d = rows(sy_sk, d)
        s16_d = rows(s16_sk, d) if s16_sk is not None else None
        if aq:
            # variance AQ: the diagonal's per-block segment quantizers
            qdc, qac, qdc_c, qac_c = (rows(rd[sk], d)
                                      for _, _, sk in _AQ_KEYS)

        # ---- luma 32 (single chosen mode) ----
        ed_y = edges(ry_sk, LB, row)
        aext = lext = None
        if ext:
            # block (i-1, j+1): one diagonal back, one slot up
            a_y, l_y, _ = ed_y
            ar = shift1(rows(ry_sk, row - o_l)[:, LB - 1, :])
            aext = torch.cat([a_y, torch.where(
                rows(tr_tab, d)[:, None], ar, a_y[:, -1:].expand(-1, LB))],
                1)
            lext = torch.cat([l_y, l_y[:, -1:].expand(-1, LB)], 1)
        preds32 = predict_modes(modes_y, *ed_y, slot_has_a, has_l, LB, LB,
                                aext=aext, lext=lext)
        p32 = sel_modes(preds32, luty[ym_d[:, 0]])
        rec_y_d, lv_y_d = code_one(p32, sy_d, TxSize.TX_32X32, qdc, qac)
        if sp_sk is not None:
            s3 = rows(sp_sk, d)[:, None, None]
            if ytx_sk is not None:
                ytx_d = rows(ytx_sk, d).long() - 1

                def code_y16(qi, pred, src):
                    return code_sel(pred, src, TxSize.TX_16X16, qdc, qac,
                                    QUAD_TXS, ytx_d[:, qi])
            else:
                def code_y16(qi, pred, src):
                    return code_one(pred, src, TxSize.TX_16X16, qdc, qac)
            y_children = None
            if s16_d is not None:
                ym8_d = rows(ym8_sk, d).long()

                def y_children(qi, eq, src):
                    rc, lc = quads(
                        eq[:3], eq[3], eq[4], src, modes_quad,
                        lambda si: lutq[ym8_d[:, qi, si]], TxSize.TX_8X8,
                        lambda si, p, s: code_one(p, s, TxSize.TX_8X8, qdc,
                                                  qac))
                    return rc, lc, s16_d[:, qi]
            ry_q, ly_q = quads(ed_y, slot_has_a, has_l, sy_d, modes_quad,
                               lambda qi: lutq[ym_d[:, 1 + qi]],
                               TxSize.TX_16X16, code_y16, y_children)
            rec_y_d = torch.where(s3, ry_q, rec_y_d)
            lv_y_d = torch.where(s3, ly_q, lv_y_d)

        # ---- chroma 16 (chosen joint uv mode or CfL), then its quads ----
        ku = lutuv[uvm_d[:, 0]]
        tu = tid16[uvm_d[:, 0]]
        if cf_sk is not None:
            ac = _cfl_luma_ac(rec_y_d)
            cf_d = rows(cf_sk, d)
        out_c = []
        for ci, (rp, src) in enumerate(((ru_sk, su_sk), (rv_sk, sv_sk))):
            ed_c = edges(rp, CB, row)
            src_d = rows(src, d)
            pc = predict_modes(modes_uv, *ed_c, slot_has_a, has_l, CB, CB)
            if cf_sk is not None:
                pc = torch.cat([pc, _cfl_pred(pc[0], cf_d[:, ci, None, None],
                                              ac)[None]], 0)
            rec_c, lv_c = code_sel(sel_modes(pc, ku), src_d,
                                   TxSize.TX_16X16, qdc_c, qac_c, tts16, tu)
            if sp_sk is not None:
                c_children = None
                if s16_d is not None:
                    uvm8_d = rows(uvm8_sk, d).long()

                    def c_children(qi, eq, src):
                        rc, lc = quads(
                            eq[:3], eq[3], eq[4], src, modes_uv,
                            lambda si: lutuv[uvm8_d[:, qi, si]],
                            TxSize.TX_4X4,
                            lambda si, p, s: code_sel(
                                p, s, TxSize.TX_4X4, qdc_c, qac_c, tts4,
                                tid4[uvm8_d[:, qi, si]]))
                        return rc, lc, s16_d[:, qi]

                def code_c8(qi, pred, src):
                    return code_sel(pred, src, TxSize.TX_8X8, qdc_c, qac_c,
                                    tts8, tid8[uvm_d[:, 1 + qi]])
                rc_q, lc_q = quads(ed_c, slot_has_a, has_l, src_d, modes_uv,
                                   lambda qi: lutuv[uvm_d[:, 1 + qi]],
                                   TxSize.TX_8X8, code_c8, c_children)
                rec_c = torch.where(s3, rc_q, rec_c)
                lv_c = torch.where(s3, lc_q, lv_c)
            out_c.append((rec_c, lv_c))
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


def _kf_sub_levels(state):
    """Per-8x8-child level views: (ly8 [B,4,4,8,8], lu4 [B,4,4,4,4],
    lv4 [B,4,4,4,4]) in (quad, sub-quad) order — the storage is
    spatial, these are reshapes."""
    ly, lu, lvv, sp = state[3], state[4], state[5], state[8]
    bh, bw = sp.shape
    B = bh * bw

    def subq(x, n):
        q = _kf_quads(x, 2 * n)                   # [B, 4, 2n, 2n]
        return _kf_quads(q.reshape(-1, 2 * n, 2 * n),
                         n).reshape(B, 4, 4, n, n)

    return (subq(ly.reshape(B, LB, LB), LB // 4),
            subq(lu.reshape(B, CB, CB), CB // 4),
            subq(lvv.reshape(B, CB, CB), CB // 4))


def _kf_skip8(state, split8: bool = False):
    """The CDEF skip gate [4 bh, 4 bw] on 8x8 units: each 16x16 quad's
    skip inside split blocks, the block's skip elsewhere; with split8,
    each coded 8x8 child's skip inside 16->8 split quads."""
    skip_q, skip_b, split = _kf_skip_flags(state)
    bh, bw = state[8].shape
    qeff = torch.where(split[:, None], skip_q, skip_b[:, None].expand(-1, 4))
    if not split8:
        return (qeff.reshape(bh, bw, 2, 2).permute(0, 2, 1, 3)
                .reshape(bh * 2, bw * 2)
                .repeat_interleave(2, 0).repeat_interleave(2, 1))
    ly8, lu4, lv4 = _kf_sub_levels(state)
    skip_c = ~((ly8 != 0).any(-1).any(-1) | (lu4 != 0).any(-1).any(-1)
               | (lv4 != 0).any(-1).any(-1))               # [B, 4, 4]
    s16 = (state[11] & state[8][:, :, None]).reshape(-1, 4, 1)
    eff = torch.where(s16, skip_c, qeff[:, :, None])
    return (eff.reshape(bh, bw, 2, 2, 2, 2).permute(0, 2, 4, 1, 3, 5)
            .reshape(bh * 4, bw * 4))


def _kf_filters(state, srcs, base_lf: int, cdef_prm, lam,
                use_cdef: bool, use_deblock: bool, cdef_rdo: bool = False,
                mark=trace.nomark, split_rdo: bool = False,
                split8: bool = False, keep_pre: bool = False):
    """Keyframe in-loop filters: the deblock level search, then CDEF —
    the per-64x64-SB ladder search against the source (cdef_rdo) or the
    fixed strengths cdef_prm (y_pri, y_sec, uv_pri, uv_sec, damping).
    With split_rdo the deblock runs on the 16-px luma / 8-px chroma grid,
    its interior edges gated by the split map; with split8 the 16->8
    split quads add their 8-px TX edges (sub_map) and CDEF's skip gate
    is taken per 8x8 child. `mark(name)` runs after each ("filters",
    "cdef"). Returns (lf_lvl 0-d int32, cdef_idx [ceil(bh/2),
    ceil(bw/2)] int32, rec_packed uint8 [3h/2, w]: y over u|v, and with
    keep_pre and CDEF on the deblocked planes before CDEF, which loop
    restoration reads beyond each stripe, else None)."""
    bh, bw = state[8].shape
    planes = [_from_blocks_t(state[i]) for i in range(3)]
    dev = planes[0].device
    lf_lvl = torch.zeros((), dtype=torch.int32, device=dev)
    if use_deblock:
        sub_map = None
        if split8:
            # per 8x8 luma (4x4 chroma) cell: inside a 16->8 split quad
            s16 = state[11] & state[8][:, :, None]
            sub_map = (s16.reshape(bh, bw, 2, 2).permute(0, 2, 1, 3)
                       .reshape(bh * 2, bw * 2)
                       .repeat_interleave(2, 0).repeat_interleave(2, 1))
        blk_y, blk_c = (16, 8) if split_rdo else (LB, CB)
        lf_lvl, planes = deblock_search(
            planes, [_from_blocks_t(s) for s in srcs], base_lf, blk_y,
            blk_c, 8, state[8] if split_rdo else None, sub_map)
    mark("filters")
    cdef_idx = torch.zeros(((bh + 1) // 2, (bw + 1) // 2), dtype=torch.int32,
                           device=dev)
    pre = planes if keep_pre and use_cdef else None
    if use_cdef:
        skip8 = _kf_skip8(state, split8)
        if cdef_rdo:
            cdef_idx, planes = cdef_search_persb(
                planes, [_from_blocks_t(s) for s in srcs], skip8,
                cdef_prm[4], lam=lam)
        else:
            planes = cdef_filter_frame(planes, skip8, *cdef_prm)
    mark("cdef")
    u8 = [p.to(torch.uint8) for p in planes]
    return (lf_lvl, cdef_idx,
            torch.cat([u8[0], torch.cat([u8[1], u8[2]], 1)], 0), pre)


def _kf_meta(state, lf_lvl, cdef_idx, split8: bool = False):
    """Keyframe compact meta packing so the host does ONE small fetch.

    Returns (meta flat int8 = [B+1 hdr rows | counts | nonzero pos/val
    stream | per-SB cdef idx], lv_y/lv_u/lv_v int16 device arrays for
    the overflow gather). Hdr row: flags (skip, split) | my[5] | mu[5] |
    cf[2] | ytx[4] | s16[4] | ym8[16] | uvm8[16]; tail row: [lf_lvl].
    With split8 the stream lays the 16->8 split quads out as four 8x8 /
    4x4 scans."""
    (_, _, _, ly, lu, lvv, my, mu, sp, cf, ytx, s16, ym8, uvm8) = state
    bh, bw = sp.shape
    B = bh * bw
    _, skip_b, split = _kf_skip_flags(state)
    ly_f = ly.reshape(B, LB, LB)
    lu_f = lu.reshape(B, CB, CB)
    lv_f = lvv.reshape(B, CB, CB)
    sub = {}
    if split8:
        ly8, lu4, lv4 = _kf_sub_levels(state)
        sub = {"lv_y8": ly8, "lv_u4": lu4, "lv_v4": lv4,
               "split16": s16.reshape(B, 4)}
    sl = scanline(ly_f, lu_f, lv_f, _kf_quads(ly_f, LB // 2),
                  _kf_quads(lu_f, CB // 2), _kf_quads(lv_f, CB // 2),
                  split, B, **sub)
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


# ---- entry point ------------------------------------------------------------

class KeyframeDevice(NamedTuple):
    """What the device half of a keyframe encode leaves on the device:
    the unskewed 14-grid state (pre-deblock recon, levels, decisions),
    the meta buffer, the filtered recon and the int16 level arrays; the
    CDEF settings the host half signals; for loop restoration with CDEF
    on, the deblocked planes before CDEF; and with variance AQ the
    segment map [bh, bw] and the segments' q deltas."""
    state: tuple
    meta: torch.Tensor
    rec_packed: torch.Tensor
    lvy: torch.Tensor
    lvu: torch.Tensor
    lvv: torch.Tensor
    cdef: tuple | None = None
    cdef_rdo: bool = True
    pre_cdef: list | None = None
    seg_map: np.ndarray | None = None
    seg_alt_q: list | None = None


def _check_options(cdef, planes, seq_extra):
    if cdef is not None and len(cdef) != 5:
        raise ValueError("cdef is (y_pri, y_sec, uv_pri, uv_sec, damping)")
    if ((seq_extra or {}).get("bit_depth", 8) > 8
            or any(int(np.max(p)) > 255 for p in planes)):
        # as the reference's: its device keyframe is 8-bit too
        raise NotImplementedError(
            "the device keyframe takes 8-bit planes: a keyframe at a bit "
            "depth above 8 is coded on the host by "
            "rav1e_tpu_torch.pipeline.intra.encode_keyframe(bit_depth=...), "
            "as api/context.py does (ROADMAP.md, item 12)")


def _mode_sets(speed: int):
    """(modes_y, modes_uv, modes_quad) of a speed preset, as the
    reference's encode_keyframe_tpu derives them from SpeedSettings."""
    ss = SpeedSettings.from_preset(speed)
    modes_y = (MODES_FULL if ss.intra_modes >= 13 else
               (MODES_7 if ss.intra_modes >= 7 else MODES_FAST))
    modes_quad = MODES_QUAD if ss.intra_modes >= 13 else modes_y
    modes_uv = (MODES_UV_FULL if ss.intra_modes >= 13 else
                (MODES_UV if ss.intra_modes >= 7 else MODES_FAST))
    return modes_y, modes_uv, modes_quad


def analyze_keyframe(planes, qindex: int = 100, speed: int = 6,
                     deblock: bool = True, cdef: tuple | None = None,
                     cdef_rdo: bool = True, device=None,
                     timings: dict | None = None,
                     lr: bool = False, aq: bool = False) -> KeyframeDevice:
    """The device half of a keyframe encode (steps 1-5 of
    encode_keyframe_tpu): upload, rd, phase 1, phase 2, the deblock and
    CDEF searches and meta packing, with the speed preset's mode sets.
    cdef: None (off) or (y_pri, y_sec, uv_pri, uv_sec, damping); with
    cdef_rdo each 64x64 SB takes its ladder entry (damping cdef[4]),
    else the tuple is one fixed strength. lr keeps the deblocked planes
    before CDEF (pre_cdef) for loop restoration. aq: variance AQ, each
    32-block quantized at its segment's qindex (_aq_segments)."""
    dev = resolve_device(device)
    stages = trace.stages(dev, timings)
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
    # SpeedSettings sets the toolset (api/speed.py)
    ss = SpeedSettings.from_preset(speed)
    modes_y, modes_uv, modes_quad = _mode_sets(speed)
    split_rdo = ss.partition_split_rdo
    # D45/D67 read the above-right extension, whose block (i-1, j+1)
    # sits on the same i+j diagonal: the full toolset recons on 2i + j
    ext = any(m in (P.D45_PRED, P.D67_PRED, P.D203_PRED) for m in modes_y)
    tx_search = ss.tx_search and split_rdo
    # the 16->8 split only where the source has energy in the 8..16 px
    # band (host numpy, the reference's gate bit for bit)
    split8 = ss.kf_split8 and split_rdo and _detail_band8(y) > 256.0
    rd = build_rd(qindex, modes_y, modes_uv, modes_quad=modes_quad,
                  device=dev, use_cfl=ss.cfl, tx_search=tx_search,
                  split8=split8)
    seg_map = seg_alt_q = None
    if aq:
        seg_map, seg_alt_q, qgrids = _aq_segments(y, qindex)
        for k, g in qgrids.items():
            rd[k] = torch.as_tensor(g, device=dev)
    ii_sk, jj_sk, has_l_sk, valid_sk, un_d, un_s = _skew_tables(bh, bw, ext)
    tr_sk = None
    if ext:
        has_tr, d203_ok = _edge_tables(bh, bw)
        rd["has_tr"] = torch.as_tensor(has_tr, device=dev)
        rd["d203_ok"] = torch.as_tensor(d203_ok, device=dev)
        tr_sk = torch.as_tensor(has_tr[ii_sk, jj_sk] & valid_sk, device=dev)
    isk, jsk = (torch.as_tensor(a, device=dev).long() for a in (ii_sk,
                                                                  jj_sk))
    ud, us = (torch.as_tensor(a, device=dev).long() for a in (un_d, un_s))
    has_l_t = torch.as_tensor(has_l_sk, device=dev)
    stages.mark("setup")

    def skew(arr, on=True):
        return arr[isk, jsk] if on else None

    def unskew(sk):
        return sk[ud, us]

    if aq:
        # phase 2 reads the quantizers per skewed diagonal
        for _, g, sk in _AQ_KEYS:
            rd[sk] = skew(rd[g])

    # ---- phase 1: mode decisions from SOURCE edges, fully batched
    dec = wavefront_frame((sy, su, sv), (sy, su, sv), rd, modes_y,
                          modes_uv, approx=True, modes_quad=modes_quad,
                          split_rdo=split_rdo)
    stages.mark("phase1")
    # ---- phase 2: decoder-order recon with the chosen modes
    rw = recon_wavefront(
        skew(sy), skew(su), skew(sv), skew(dec[6]), skew(dec[7]), has_l_t,
        rd, modes_y, modes_uv, skew(dec[8], split_rdo), modes_quad,
        cf_sk=skew(dec[9], ss.cfl), tr_tab=tr_sk,
        ytx_sk=skew(dec[10], tx_search), s16_sk=skew(dec[11], split8),
        ym8_sk=skew(dec[12], split8), uvm8_sk=skew(dec[13], split8))
    stages.mark("recon_wavefront", int(has_l_t.shape[0]))   # diagonals
    state = tuple(unskew(x) for x in rw) + tuple(dec[6:])
    cdef_prm = tuple(cdef) if cdef is not None else (0, 0, 0, 0, 3)
    lf_lvl, cdef_idx, rec_packed, pre = _kf_filters(
        state, (sy, su, sv), level_from_qindex(qindex), cdef_prm, rd["lam"],
        cdef is not None, deblock, cdef_rdo, stages.mark, split_rdo, split8,
        keep_pre=lr)
    meta, lvy, lvu, lvv = _kf_meta(state, lf_lvl, cdef_idx, split8)
    stages.mark("meta")
    return KeyframeDevice(state, meta, rec_packed, lvy, lvu, lvv,
                          None if cdef is None else cdef_prm, cdef_rdo, pre,
                          seg_map, seg_alt_q)


def _aq_segments(y: np.ndarray, qindex: int):
    """Variance AQ, host numpy as in the reference: each 32-block's luma
    variance (f64), its quartile segment (np.quantile, np.digitize), the
    segments' q deltas KF_SEG_ALT_Q clamped so base + delta stays in [1,
    255] (qindex 0 would make the segment lossless), and each block's
    quantizers at its segment's qindex (spec get_qidx; rav1e
    src/segmentation.rs). The rate tables and lambda stay at the base q:
    the CDFs depend only on base_q_idx. Returns (seg_map [bh, bw] int8,
    seg_alt_q for FrameParams and TileWriter, {rd key: [bh, bw] int32})."""
    from rav1e_tpu_torch.entropy.cdf import tables
    h, w = y.shape
    bh, bw = h // LB, w // LB
    yb = (np.asarray(y).reshape(bh, LB, bw, LB).transpose(0, 2, 1, 3)
          .astype(np.float64))
    var = yb.var(axis=(2, 3))
    qs = (np.quantile(var, (0.25, 0.5, 0.75)) if var.size > 1
          else (var.flat[0],) * 3)
    seg_map = np.digitize(var, qs).astype(np.int8)
    alt = np.clip(np.asarray(KF_SEG_ALT_Q, np.int32), 1 - qindex,
                  255 - qindex)
    qi_b = (qindex + alt[seg_map]).astype(np.int32)
    qi_cb = np.clip(qi_b + chroma_dq(qindex), 0, 255)
    t_ = tables()
    grids = {"qdc_g": t_["dc_q_8"][qi_b], "qac_g": t_["ac_q_8"][qi_b],
             "qdc_cg": t_["dc_q_8"][qi_cb], "qac_cg": t_["ac_q_8"][qi_cb]}
    return (seg_map, [int(a) for a in alt] + [None] * 4,
            {k: g.astype(np.int32) for k, g in grids.items()})


def _detail_band8(y: np.ndarray) -> float:
    """Mean luma energy in the 8..16 px spatial band: per-16x16-block
    variance minus per-8x8-block variance (what an 8x8 predictor can
    model that a 16x16 one cannot). Host numpy in float32, as the
    reference computes the split8 gate."""
    y = np.asarray(y, np.float32)
    h, w = y.shape
    h8, w8 = h // 8 * 8, w // 8 * 8
    v8 = (y[:h8, :w8].reshape(h8 // 8, 8, w8 // 8, 8)
          .var(axis=(1, 3)).mean())
    h16, w16 = h // 16 * 16, w // 16 * 16
    v16 = (y[:h16, :w16].reshape(h16 // 16, 16, w16 // 16, 16)
           .var(axis=(1, 3)).mean())
    return float(v16 - v8)


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
    defaults are the reference's (speed 6; speeds 0-5 read the same
    keyframe tools).

    cdef: None disables CDEF at the sequence level; a 5-tuple (y_pri,
    y_sec, uv_pri, uv_sec, damping) enables it — with cdef_rdo each
    64x64 SB picks its ladder entry (damping cdef[4]) and the frame
    signals the entries used; cdef_rdo=False applies the tuple as one
    fixed frame-wide strength.

    Returns (packet, [y, u, v] recon int32) — the same as the
    reference's encode_keyframe_tpu at the same speed: the recon is the
    decoder's output (deblocking and CDEF included). `timings`, when
    given, receives the wall time of each stage.

    deferred=True returns (finish, rec_dev) once the device half is
    queued, as the reference does: `finish()`, callable from any thread,
    runs the host half (pack_keyframe, on a stream of its own that waits
    for the device half) and returns (packet, recon); rec_dev is the
    filtered recon's three planes on the device (uint8), for P frames to
    reference meanwhile. lr=True (loop restoration: the search and
    apply on the device, ops/lrf.py) packs with the Python TileWriter,
    as the reference does, and cannot be deferred. aq=True (variance AQ:
    four segments by each 32-block's luma variance quartile, q deltas
    KF_SEG_ALT_Q, each block quantized at its segment's qindex on the
    device) signals segmentation and packs with the Python TileWriter,
    as the reference does."""
    _check_options(cdef, planes, seq_extra)
    if deferred and lr:
        raise ValueError("deferred is incompatible with lr")
    dev = resolve_device(device)
    kd = analyze_keyframe(planes, qindex, speed, deblock, cdef, cdef_rdo,
                          dev, timings, lr=lr, aq=aq)
    if not deferred:
        return pack_keyframe(kd, planes, qindex, render_size, seq_extra,
                             dev, timings, lr=lr)
    after = SideStream(dev)

    def finish():
        with after:
            return pack_keyframe(kd, planes, qindex, render_size,
                                 seq_extra, dev, timings)

    h, w = np.asarray(planes[0]).shape
    rp = kd.rec_packed
    return finish, (rp[:h], rp[h:, :w // 2], rp[h:, w // 2:])


def pack_keyframe(kd: KeyframeDevice, planes, qindex: int = 100,
                  render_size: tuple | None = None,
                  seq_extra: dict | None = None, device=None,
                  timings: dict | None = None, use_native: bool = True,
                  lr: bool = False):
    """The host half of a keyframe encode (the reference's deferred
    `_finish`): one fetch of the meta buffer and the recon, unpack, the
    overflow gather, the tile walk (its IR range-coded on `device`) and
    the OBU packet. The walk is the C++ packer's write_intra_tile_fast,
    as in the reference; use_native=False walks the blocks in the Python
    TileWriter instead (same IR, row for row), the writer the tests and
    chip_smoke.py hold the packer against. lr runs loop restoration on
    the device recon before the fetch (pipeline/lr.py) and walks the
    Python TileWriter, whose tiles carry the units' parameters, as the
    reference does; so does a variance-AQ keyframe (kd.seg_map), whose
    blocks carry their segment ids. Returns (packet, [y, u, v] recon
    int32)."""
    dev = resolve_device(device)
    stages = trace.stages(dev, timings)
    h, w = np.asarray(planes[0]).shape
    bh, bw = h // LB, w // LB
    B = bh * bw
    cap = _kf_stream_cap(B)

    # ---- fetch + unpack (host) ----
    meta = to_host(kd.meta)
    o0 = (B + 1) * KF_META
    body = meta[:o0].reshape(B + 1, KF_META)
    body, mtail = body[:-1], body[-1]
    lf = int(mtail[0])
    sp = (body[:, 1] != 0).reshape(bh, bw)
    my = body[:, 2:7].astype(np.int32).reshape(bh, bw, 5)
    mu = body[:, 7:12].astype(np.int32).reshape(bh, bw, 5)
    cfm = body[:, 12:14].astype(np.int32).reshape(bh, bw, 2)
    ytx = body[:, 14:18].astype(np.int32).reshape(bh, bw, 4)
    s16 = (body[:, 18:22] != 0).reshape(bh, bw, 4)
    ym8 = body[:, 22:38].astype(np.int32).reshape(bh, bw, 4, 4)
    uvm8 = body[:, 38:54].astype(np.int32).reshape(bh, bw, 4, 4)
    # 16->8 split quads (only under a split 32: phase 1 masks them)
    any8 = bool(s16.any())

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
    lv_y, lv_u, lv_v, over = unpack_stream(
        counts, pos, val, sp.reshape(B), cap,
        s16.reshape(B, 4) if any8 else None)
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
    rp = kd.rec_packed
    lr_data = None
    if lr:
        from rav1e_tpu_torch.pipeline.lr import search_lr_frame
        use_native = False
        stages.mark("fetch_unpack")
        rec_d = [rp[:h], rp[h:, :w // 2], rp[h:, w // 2:]]
        src_d = [torch.as_tensor(np.asarray(p), device=dev) for p in planes]
        lr_types, lr_data = search_lr_frame(rec_d, src_d, 8, 1,
                                            pre=kd.pre_cdef)
        rec = [to_host(p).astype(np.int32) for p in rec_d]
        stages.mark("lr")
    else:
        rp = to_host(rp)
        rec = [rp[:h].astype(np.int32), rp[h:, :w // 2].astype(np.int32),
               rp[h:, w // 2:].astype(np.int32)]
        stages.mark("fetch_unpack")

    # ---- tile walk (host) into IR; the kernel codes the IR ----
    seq = Sequence(width=w, height=h, enable_cdef=kd.cdef is not None)
    for k, v_ in (seq_extra or {}).items():
        setattr(seq, k, v_)
    fp = FrameParams(frame_type=FrameType.KEY, base_q_idx=qindex,
                     loop_filter_levels=(lf, lf, lf, lf),
                     render_size=render_size)
    if lr:
        seq.enable_restoration = True
        fp.lr_types = lr_types
    if kd.seg_map is not None:
        fp.seg_alt_q = kd.seg_alt_q
        use_native = False
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
    if use_native:
        # the writer times its walk (tile_walk) and codes its tile
        tw = NativeTileWriter(mi_rows, mi_cols, qindex, device=dev,
                              timings=timings)
        tile = tw.write_intra_tile_fast(
            sp.reshape(-1), my.reshape(-1, 5), mu.reshape(-1, 5),
            cfm.reshape(-1, 2), ly.reshape(-1, 32, 32),
            lu.reshape(-1, 16, 16), lvv.reshape(-1, 16, 16),
            cdef_idx=cdef_map, cdef_bits=cdef_bits,
            ytx=ytx.reshape(-1, 4), split16=s16 if any8 else None,
            ym8=ym8 if any8 else None, uvm8=uvm8 if any8 else None)
        return keyframe_packet(seq, fp, ti, [tile]), rec
    tw = TileWriter(mi_rows, mi_cols, qindex, encoder=IRRecorder,
                    lr_data=lr_data, seg_alt_q=kd.seg_alt_q)
    if cdef_bits:
        tw.cdef_bits = cdef_bits
        tw.cdef_idx_map = cdef_map
    partitions, blocks = _kf_tile_dicts(sp, my, mu, cfm, ytx, s16, ym8,
                                        uvm8, ly, lu, lvv, mi_rows, mi_cols,
                                        kd.seg_map)
    # tile_walk from the fetch's end to the IR, then the coding stages
    tile, = _code_tiles([tw.write_tile(partitions, blocks)], dev, timings,
                        stages)
    return keyframe_packet(seq, fp, ti, [tile]), rec


def _kf_tile_dicts(sp, my, mu, cfm, ytx, s16, ym8, uvm8, ly, lu, lvv,
                   mi_rows: int, mi_cols: int, seg_map=None):
    """The keyframe's blocks, from pack_keyframe's grids ([bh, bw, ...]),
    as TileWriter.write_tile's partitions and blocks dicts (the Python
    writer's walk, use_native=False); seg_map [bh, bw] gives each
    32-block's blocks their segment id (variance AQ)."""
    bh, bw = sp.shape
    partitions: dict = {}
    blocks: dict = {}
    seg = 0

    def intra_block(y_mode, uv_mode, yl, ul, vl, y_tx_type, cfl=None):
        d = BlockDecision(y_mode=PredictionMode(int(y_mode)),
                          uv_mode=PredictionMode(int(uv_mode)),
                          skip=False, seg_id=seg)
        if d.uv_mode == PredictionMode.UV_CFL_PRED:
            d.cfl_alpha_idx = (int(cfl[0]), int(cfl[1]))
        if not yl.any() and not ul.any() and not vl.any():
            d.skip = True
        else:
            d.coeffs = {0: yl, 1: ul, 2: vl, "y_tx_type": y_tx_type}
        return d

    for bi in range(bh):
        for bj in range(bw):
            r, c = bi * 8, bj * 8
            yl, ul, vl = ly[bi, bj], lu[bi, bj], lvv[bi, bj]
            if seg_map is not None:
                seg = int(seg_map[bi, bj])
            if not sp[bi, bj]:
                blocks[(r, c)] = intra_block(my[bi, bj, 0], mu[bi, bj, 0],
                                             yl, ul, vl, TxType.DCT_DCT,
                                             cfm[bi, bj])
                partitions[(r, c, int(BlockSize.B32X32))] = \
                    PartitionType.NONE
                continue
            # PARTITION_SPLIT: four 16x16 children, TX_16X16 luma
            # (intra_ext_tx2 symbol ytx) + TX_8X8 chroma, or SPLIT@16 into
            # four 8x8 children (TX_8X8 luma + TX_4X4 chroma, DCT_DCT);
            # their levels stored spatially in the block's level arrays
            partitions[(r, c, int(BlockSize.B32X32))] = PartitionType.SPLIT
            for q, (qr, qc) in enumerate(QUADS):
                dr, dc = 4 * qr, 4 * qc           # in 4x4 units
                py, px, cy, cx = 16 * qr, 16 * qc, 8 * qr, 8 * qc
                if s16[bi, bj, q]:
                    partitions[(r + dr, c + dc, int(BlockSize.B16X16))] = \
                        PartitionType.SPLIT
                    for si, (sr, sc) in enumerate(QUADS):
                        y0, x0 = py + 8 * sr, px + 8 * sc
                        u0, v0 = cy + 4 * sr, cx + 4 * sc
                        at = (r + dr + 2 * sr, c + dc + 2 * sc)
                        blocks[at] = intra_block(
                            ym8[bi, bj, q, si], uvm8[bi, bj, q, si],
                            yl[y0: y0 + 8, x0: x0 + 8],
                            ul[u0: u0 + 4, v0: v0 + 4],
                            vl[u0: u0 + 4, v0: v0 + 4], TxType.DCT_DCT)
                        partitions[at + (int(BlockSize.B8X8),)] = \
                            PartitionType.NONE
                    continue
                blocks[(r + dr, c + dc)] = intra_block(
                    my[bi, bj, 1 + q], mu[bi, bj, 1 + q],
                    yl[py: py + 16, px: px + 16],
                    ul[cy: cy + 8, cx: cx + 8],
                    vl[cy: cy + 8, cx: cx + 8],
                    INTRA_TX_SET2[int(ytx[bi, bj, q])])
                partitions[(r + dr, c + dc, int(BlockSize.B16X16))] = \
                    PartitionType.NONE
    for r in range(0, mi_rows, 16):
        for c in range(0, mi_cols, 16):
            partitions[(r, c, int(BlockSize.B64X64))] = PartitionType.SPLIT
    return partitions, blocks
