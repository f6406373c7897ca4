"""Batched P-frame encoding on the device (port of
rav1e_tpu/pipeline/tpu_inter.py), plus the coefficient compaction that
the keyframe path shares.

Inter blocks are independent given the reference frame, so the whole
frame batches:

- full-pel motion search as one batched product per frame (SSD as
  ||w||^2 - 2 w.b + ||b||^2, the w.b term a bf16 product with f32
  sums), at half resolution (ds2) once the frame has >= 510 blocks;
- neighbour / median / zero / coarse (4x downsampled) MV candidates,
  8 passes on the search's SSD surface and one exact re-judge;
- a fixed-trip descent from one gathered patch per block: quarter-pel
  at speed 8 (subpel), a single full-pel step after ds2 at speeds 9-10;
- spec 8-tap MC in int32 from patches that `ops.gather.gather_patches`
  (a CUDA kernel on the card) copies out of the padded reference;
- DCT + quantize + bit-exact inverse over the [B, 32, 32] batch, skip
  RD, the deblock level search, CDEF's per-SB ladder search (ops/cdef,
  CUDA kernels on the card), and one packed int8 decision buffer;
- host: unpack, TileWriter walk, od_ec coding by the CUDA kernel of
  entropy/ec_cuda, OBU packet.

This slice ports the speed-8 to 10 P toolsets (api/speed.py): single
reference, subpel at speed 8, CDEF when asked, no split RDO, no 64x64
merge, no intra-in-inter, no SATD. Other options raise
NotImplementedError naming the ROADMAP.md item that brings them.

Sums that rank decisions follow XLA:CPU's order where values pass 2^24
(the sliding window sums and per-block sums of squares of the search:
one f32 add at a time, row-major), so the port's decisions match the
reference's on the CPU; residual SSEs stay below 2^24 on real content
and are summed by torch.
"""

from __future__ import annotations

import functools
import time
from functools import lru_cache

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
from rav1e_tpu_torch.device import resolve_device
from rav1e_tpu_torch.entropy.ec_cuda import RecordingEncoder
from rav1e_tpu_torch.entropy.obu import (
    FrameParams,
    Sequence,
    TileInfo,
    interframe_packet,
)
from rav1e_tpu_torch.entropy.tile import BlockDecision, TileWriter
from rav1e_tpu_torch.ops import transforms as T
from rav1e_tpu_torch.ops.gather import gather_patches
from rav1e_tpu_torch.ops.ref.mc import SUBPEL_FILTERS
from rav1e_tpu_torch.ops.ref.quant import ac_q as ac_q_lut
from rav1e_tpu_torch.ops.ref.quant import chroma_dq
from rav1e_tpu_torch.ops.ref.quant import dc_q as dc_q_lut

PAD = 32          # ref padding: search 16 + subpel drift + filter taps
SEARCH = 16       # full-pel search radius (px)
HDR_BYTES = 35    # per-block control record (mv/flags/choice/sub8)
SL_LEN = 1536     # scan-line length per block (y 1024 + u/v 256)


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to rav1e_tpu_torch yet: ROADMAP.md queue 1, "
        f"{item}")


class _Stages:
    """Wall time per stage into `out` (None: off), each taken after the
    device has finished the stage's work."""

    def __init__(self, dev: torch.device, out: dict | None):
        self.dev, self.out = dev, out
        self.t = time.perf_counter()

    def mark(self, name: str):
        if self.out is None:
            return
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        now = time.perf_counter()
        self.out[name] = now - self.t
        self.t = now


def _nomark(name: str):
    pass


# ---- tables ------------------------------------------------------------------

@lru_cache(maxsize=None)
def _filt(device: torch.device) -> torch.Tensor:
    """The spec's REGULAR 8-tap bank [16, 8] int32."""
    return torch.as_tensor(np.asarray(SUBPEL_FILTERS["REGULAR"], np.int32),
                           device=device)


def _round2(x, n):
    return (x + (1 << (n - 1))) >> n


def _split_bits() -> float:
    from rav1e_tpu_torch.entropy.cost import mode_cost_tables
    pm = mode_cost_tables()["partition_mid"]
    return float(pm[int(PartitionType.SPLIT)]
                 - pm[int(PartitionType.NONE)]
                 + 4.0 * pm[int(PartitionType.NONE)])


@lru_cache(maxsize=1)
def _split8_bits() -> float:
    """Partition bits for a 16->8 SPLIT: the SPLIT-vs-NONE delta at
    the 16 level (partition_mid) plus four NONE symbols from the
    4-ary partition_8 family (spec: 8x8 with 4x4 support present)."""
    from rav1e_tpu_torch.entropy.cost import (_avg_bits, mode_cost_tables,
                                              tables)
    pm = mode_cost_tables()["partition_mid"]
    p8 = _avg_bits(tables()["partition_8"])
    return float(pm[int(PartitionType.SPLIT)]
                 - pm[int(PartitionType.NONE)]
                 + 4.0 * p8[int(PartitionType.NONE)])


@lru_cache(maxsize=1)
def _intra_in_inter_bits() -> float:
    """Signaling bits for a DC intra block in an inter frame:
    intra_inter(0) + y_mode(DC, size group 3) + uv_mode_cfl(DC)."""
    from rav1e_tpu_torch.entropy.cost import _avg_bits, tables
    t = tables()
    return (float(_avg_bits(t["intra_inter"])[0])
            + float(_avg_bits(t["y_mode"])[0])
            + float(_avg_bits(t["uv_mode_cfl"])[0]))


def _merge_save_bits() -> float:
    """Signaling bits PARTITION_NONE at 64 saves vs SPLIT + 4x NONE@32."""
    from rav1e_tpu_torch.entropy.cost import mode_cost_tables
    pm = mode_cost_tables()["partition_mid"]
    return float(pm[int(PartitionType.SPLIT)]
                 + 4.0 * pm[int(PartitionType.NONE)]
                 - pm[int(PartitionType.NONE)])


def build_rd_inter(qindex: int, bit_depth: int = 8,
                   chroma_dq: int | None = None, device=None) -> dict:
    """RD inputs of the batched P step as tensors on `device`: λ, MV-rate
    LUT, inter mode bits, coefficient-rate LUTs (entropy/cost.py).
    chroma_dq: frame-header delta_q_u in qindex steps (chroma quantizes
    and prices at qindex + chroma_dq)."""
    from rav1e_tpu_torch.entropy.cost import (inter_mode_bits,
                                              mv_component_bits, rd_lambda,
                                              sad_lambda)
    from rav1e_tpu_torch.ops.ref.deblock import level_from_qindex
    from rav1e_tpu_torch.ops.ref.quant import chroma_dq as _cdq
    from rav1e_tpu_torch.pipeline.tpu_intra import rate_luts
    dev = resolve_device(device)
    imb = inter_mode_bits()
    if chroma_dq is None:
        chroma_dq = _cdq(qindex)
    qc = qindex + chroma_dq

    def i32(x):
        return torch.tensor(int(x), dtype=torch.int32, device=dev)

    def f32(x):
        return torch.tensor(float(x), dtype=torch.float32, device=dev)

    return {
        "dcq_c": i32(dc_q_lut(qc, 0, bit_depth)),
        "acq_c": i32(ac_q_lut(qc, 0, bit_depth)),
        "lam": f32(rd_lambda(qindex, bit_depth)),
        "lam_sad": f32(sad_lambda(qindex, bit_depth)),
        "mv_bits": torch.as_tensor(np.asarray(mv_component_bits(),
                                              np.float32), device=dev),
        "newmv": f32(imb["NEWMV"] + 1.2),  # + mv_joint avg
        "globalmv": f32(imb["GLOBALMV"]),
        "nearest": f32(imb["NEARESTMV"]),
        "near": f32(imb["NEARMV"]),
        "intra32": f32(_intra_in_inter_bits()),
        "skip0": f32(imb["skip0"]),
        "skip1": f32(imb["skip1"]),
        "y32": rate_luts(qindex, TxSize.TX_32X32, 0, dev),
        "c16": rate_luts(qc, TxSize.TX_16X16, 1, dev),
        "y16": rate_luts(qindex, TxSize.TX_16X16, 0, dev),
        "c8": rate_luts(qc, TxSize.TX_8X8, 1, dev),
        "c32": rate_luts(qc, TxSize.TX_32X32, 1, dev),
        "y8": rate_luts(qindex, TxSize.TX_8X8, 0, dev),
        "c4": rate_luts(qc, TxSize.TX_4X4, 1, dev),
        "split_bits": f32(_split_bits()),
        "split_bits8": f32(_split8_bits()),
        "merge_save": f32(_merge_save_bits()),
        "base_lf": i32(level_from_qindex(qindex)),
    }


def rd_inter_from_numpy(rd: dict, device) -> dict:
    """The reference's build_rd_inter output, given as numpy arrays
    (nested dicts included), as the port's dict of tensors."""
    from rav1e_tpu_torch.pipeline.tpu_intra import rd_from_numpy
    return rd_from_numpy(rd, device)


# ---- motion compensation -----------------------------------------------------

def _taps(fil, patch, n: int, axis: int):
    """sum_t fil[..., t] * patch shifted by t along `axis` (-1: columns,
    -2: rows), over n outputs: the separable filter pass in int32."""
    out = None
    for t in range(fil.shape[-1]):
        f = fil[..., t, None, None]
        x = patch[..., :, t: t + n] if axis == -1 else patch[..., t: t + n, :]
        out = f * x if out is None else out + f * x
    return out


def _mc_batch(ref_pad, pos_r, pos_c, mv8, n, ss, interm=False,
              four_tap=False, bd: int = 8):
    """Batched sub-pel prediction. ref_pad int32 padded by PAD>>ss with
    edge replication; pos_r/pos_c int32 [B] plane-scale block origins;
    mv8 int32 [B, 2] luma-scale 1/8-pel MVs; n = block size. Returns
    [B, n, n] int32. Each block's (n+7)^2 window is one gather_patches
    call for the whole batch."""
    if interm:
        _not_ported("compound-precision MC (interm)",
                    "item 11 (other P/B routes)")
    if four_tap:
        _not_ported("the 4-tap MC bank (split8 children)",
                    "item 8 (keyframes at speeds 8 and 6)")
    p = PAD >> ss
    p16r = (pos_r << 4) + mv8[:, 0] * (2 >> ss)
    p16c = (pos_c << 4) + mv8[:, 1] * (2 >> ss)
    ir, fr = p16r >> 4, p16r & 15
    ic, fc = p16c >> 4, p16c & 15
    patch = gather_patches(ref_pad, ir + (p - 3), ic + (p - 3), n + 7)
    bank = _filt(ref_pad.device)
    intm = _round2(_taps(bank[fc.long()], patch, n, -1), 3)
    out = _taps(bank[fr.long()], intm, n, -2)
    return torch.clamp(_round2(out, 11), 0, (1 << bd) - 1)


def _gather_patch(ref_pad, pos_r, pos_c, mv8c, n, ss, M):
    """ONE patch per block: an (n+7+2M)^2 window around the centre MV,
    from which every descent candidate within ±M px evaluates.
    Returns (patch [B, n+7+2M, n+7+2M], ir0, ic0) with patch[b, 0, 0]
    = ref row (ir0 - 3 - M), col (ic0 - 3 - M)."""
    p = PAD >> ss
    p16r = (pos_r << 4) + mv8c[:, 0] * (2 >> ss)
    p16c = (pos_c << 4) + mv8c[:, 1] * (2 >> ss)
    ir0, ic0 = p16r >> 4, p16c >> 4
    patch = gather_patches(ref_pad, ir0 + (p - 3 - M), ic0 + (p - 3 - M),
                           n + 7 + 2 * M)
    return patch, ir0, ic0


def _mc_patch(patch, ir0, ic0, pos_r, pos_c, mv8, n, ss, M,
              interm=False, bd: int = 8):
    """Subpel prediction from pre-gathered patches (bit-exact twin of
    _mc_batch): the whole-pixel drift vs the patch centre (<= M) folds
    into an extended (8+2M)-tap filter with the 8 spec taps placed at
    the drift offset. Accepts extra leading batch dims shared across
    the array arguments (mv8 [..., 2], pos/ir0 broadcastable)."""
    if interm:
        _not_ported("compound-precision MC (interm)",
                    "item 11 (other P/B routes)")
    p16r = (pos_r << 4) + mv8[..., 0] * (2 >> ss)
    p16c = (pos_c << 4) + mv8[..., 1] * (2 >> ss)
    ir, fr = p16r >> 4, p16r & 15
    ic, fc = p16c >> 4, p16c & 15
    cr = torch.clamp(ir - ir0 + M, 0, 2 * M)
    cc = torch.clamp(ic - ic0 + M, 0, 2 * M)
    bank = _filt(patch.device)

    def ext(fil, carry):
        # fil [..., 8] -> [..., 8 + 2M] with taps at offset carry
        out = None
        for s in range(2 * M + 1):
            v = torch.nn.functional.pad(fil, (s, 2 * M - s))
            out = v if out is None else torch.where(
                carry[..., None] == s, v, out)
        return out

    fh = ext(bank[fc.long()], cc)
    fv = ext(bank[fr.long()], cr)
    intm = _round2(_taps(fh, patch, n, -1), 3)
    out = _taps(fv, intm, n, -2)
    return torch.clamp(_round2(out, 11), 0, (1 << bd) - 1)


def _mc_patch_multi(patch, ir0, ic0, pos_r, pos_c, mv8c, n, ss, M,
                    bd: int = 8):
    """_mc_patch for C candidate MVs [C, B, 2] sharing one patch set.
    Returns [C, B, n, n] int32."""
    return _mc_patch(patch[None], ir0[None], ic0[None], pos_r[None],
                     pos_c[None], mv8c, n, ss, M, bd=bd)


def to_blocks(plane, n):
    return (plane.reshape(-1, n, plane.shape[1] // n, n)
            .permute(0, 2, 1, 3).reshape(-1, n, n))


def from_blocks(blks, ph, pw, n):
    return (blks.reshape(ph // n, pw // n, n, n)
            .permute(0, 2, 1, 3).reshape(ph, pw))


def _edge_pad(x, p: int):
    """jnp.pad(x, p, mode="edge") on the last two dims, by index clamp
    (any dtype)."""
    H, W = x.shape[-2:]
    rows = torch.clamp(torch.arange(-p, H + p, device=x.device), 0, H - 1)
    cols = torch.clamp(torch.arange(-p, W + p, device=x.device), 0, W - 1)
    return x.index_select(-2, rows).index_select(-1, cols)


def _window_sum(x, kh: int, kw: int):
    """lax.reduce_window(x, 0., add, (kh, kw) on the last two dims,
    stride 1, "valid") in XLA:CPU's order: one f32 add at a time,
    row-major over the window."""
    H, W = x.shape[-2:]
    ho, wo = H - kh + 1, W - kw + 1
    acc = torch.zeros(x.shape[:-2] + (ho, wo), dtype=x.dtype,
                      device=x.device)
    for dy in range(kh):
        for dx in range(kw):
            acc += x[..., dy: dy + ho, dx: dx + wo]
    return acc


def _rsum(x):
    """jnp.sum(x, (-2, -1)) in XLA:CPU's order: one f32 add at a time,
    row-major."""
    flat = x.reshape(x.shape[:-2] + (-1,))
    acc = torch.zeros(flat.shape[:-1], dtype=x.dtype, device=x.device)
    for i in range(flat.shape[-1]):
        acc += flat[..., i]
    return acc


# ---- motion search -----------------------------------------------------------

def _search_one_ref(ryp, blks, by, bx, rd, B, use_satd=False,
                    search: int = SEARCH, subpel: bool = True,
                    bd: int = 8, ds2: bool = True):
    """Motion search vs ONE padded reference plane: full-pel SSD from a
    batched product, then the fixed-trip descent from one pre-gathered
    patch per block. Returns (mv8 [B,2] eighth-pel, patch, pir0, pic0,
    grid_fn); grid_fn(mv [B,2]) estimates full-frame SSE of an in-window
    MV from the search's SSD surface. patch is None when there is no
    descent (the full-resolution stage without subpel).

    ds2=True runs the full-pel stage at HALF resolution once the frame
    has >= 510 blocks, then opens the descent with a full-pel step from
    M=2 patches. subpel (speed 8) descends on to quarter pel: steps of
    8, 4, 2, 2 eighth-pel after ds2, 4, 2, 2 at full resolution (M=1),
    every candidate predicted from the one patch."""
    if use_satd:
        _not_ported("SATD subpel distortion",
                    "item 8 (keyframes at speeds 8 and 6)")
    assert search <= PAD, (search, PAD)
    dev = ryp.device
    nby_l = ryp.shape[0] // 32 - 2                # h // 32
    nbx_l = ryp.shape[1] // 32 - 2
    if B != nby_l * nbx_l:
        _not_ported("the tile-sharded search", "item 17 (parallel)")
    use_ds2 = ds2 and B >= 510 and search % 2 == 0 and search >= 4

    def assemble_windows(plane, want, tile, offp, kk):
        """[B, want, want] windows at origin tile*(i,j)+offp of `plane`
        (padded coords), want <= tile*kk, via static tiling."""
        need_r = offp + tile * (nby_l + kk - 1)
        need_c = offp + tile * (nbx_l + kk - 1)
        pr = max(0, need_r - plane.shape[0])
        pc = max(0, need_c - plane.shape[1])
        if pr or pc:
            plane = torch.nn.functional.pad(plane, (0, pc, 0, pr))
        g = (plane[offp:need_r, offp:need_c]
             .reshape(nby_l + kk - 1, tile, nbx_l + kk - 1, tile)
             .permute(0, 2, 1, 3))
        rows = [torch.cat([g[i:nby_l + i, j:nbx_l + j] for j in range(kk)],
                          dim=-1) for i in range(kk)]
        wins = torch.cat(rows, dim=-2)
        return wins.reshape(-1, tile * kk, tile * kk)[:, :want, :want]

    # SSD surface as one batched product with a diagonal reduction:
    #   M[b, r, R, dx] = sum_c blk[b, r, c] * win[b, R, dx + c]
    #   corr[b, dy, dx] = sum_r M[b, r, r + dy, dx]
    # Operands round to bf16 as the reference's; the products of
    # bf16 values and their sums over c are exact in f32, so torch's
    # product order cannot change M. The sum over r runs in the
    # reference's order.
    def ssd_surface(wins, wsq, bcomp, n, S):
        S1 = 2 * S + 1
        w_bf = wins.to(torch.bfloat16).to(torch.float32)
        b_bf = bcomp.to(torch.bfloat16).to(torch.float32)
        w2 = torch.stack([w_bf[:, :, dx: dx + n] for dx in range(S1)], 2)
        m = torch.einsum("brc,bRdc->brRd", b_bf, w2)
        corr = m[:, 0, 0:S1, :]
        for r in range(1, n):
            corr = corr + m[:, r, r: r + S1, :]   # [B,S1,S1]
        if bcomp.dtype == torch.int32:
            # XLA:CPU sums the int32 squares exactly before the cast
            bsq = torch.sum(bcomp * bcomp, dim=(1, 2)).to(torch.float32)
        else:
            bsq = _rsum(bcomp * bcomp)
        return wsq - 2.0 * corr + bsq[:, None, None]

    def rate_grid(S, px_step):
        # NEWMV + the MV residual for every non-zero candidate;
        # (0,0) codes GLOBALMV
        fp_idx = np.abs(np.arange(-S, S + 1)) * 8 * px_step
        mvb = rd["mv_bits"][torch.as_tensor(fp_idx, device=dev)]
        g = mvb[:, None] + mvb[None, :] + rd["newmv"]
        g[S, S] = rd["globalmv"]
        return g[None]

    if use_ds2:
        # half-res full-pel stage (hierarchical level 1)
        S2 = search // 2
        r2 = (ryp.to(torch.float32)
               .reshape(ryp.shape[0] // 2, 2, ryp.shape[1] // 2, 2)
               .mean((1, 3)))
        blks2 = blks.to(torch.float32).reshape(B, 16, 2, 16, 2) \
            .mean((2, 4))
        off2 = PAD // 2 - S2
        win2 = 2 * S2 + 16
        K2 = (win2 + 15) // 16
        sq2 = _window_sum(r2 * r2, 16, 16)
        wins = assemble_windows(r2, win2, 16, off2, K2)
        wsq = assemble_windows(sq2, 2 * S2 + 1, 16, off2, K2)
        # x4: each ds2 cell stands for 4 source pixels of SSE
        ssd = ssd_surface(wins, wsq, blks2, 16, S2) * 4.0
        cost = ssd + rd["lam"] * rate_grid(S2, 2)
        flat = torch.argmin(cost.reshape(B, -1), dim=1).to(torch.int32)
        mv_fp = torch.stack([flat // (2 * S2 + 1) - S2,
                             flat % (2 * S2 + 1) - S2], 1) * 2
        grid_S, grid_step = S2, 2
        # full-pel opening step: the ds2 winner is within +-1 px of
        # the full-res optimum; drift 8+4+2+2 = 2 px -> M = 2
        desc_steps = (8, 4, 2, 2) if subpel else (8,)
        M = 2
    else:
        win_sz = 2 * search + 32
        sq_sums = _window_sum((ryp * ryp).to(torch.float32), 32, 32)
        off = PAD - search                        # window origin shift
        K = (win_sz + 31) // 32                   # tiles per window side
        wins = assemble_windows(ryp.to(torch.float32), win_sz, 32, off, K)
        wsq = assemble_windows(sq_sums, 2 * search + 1, 32, off, K)
        ssd = ssd_surface(wins, wsq, blks, 32, search)
        cost = ssd + rd["lam"] * rate_grid(search, 1)
        flat = torch.argmin(cost.reshape(B, -1), dim=1).to(torch.int32)
        mv_fp = torch.stack([flat // (2 * search + 1) - search,
                             flat % (2 * search + 1) - search], 1)
        grid_S, grid_step = search, 1
        desc_steps = (4, 2, 2) if subpel else ()
        M = 1

    ssd_flat = ssd.reshape(B, -1)

    def grid_fn(mv):
        """SSE of an in-window MV read off the SSD surface."""
        fp_r = (mv[:, 0] + 4) >> 3
        fp_c = (mv[:, 1] + 4) >> 3
        cy = torch.clamp(torch.round(fp_r / grid_step).to(torch.int32),
                         -grid_S, grid_S)
        cx = torch.clamp(torch.round(fp_c / grid_step).to(torch.int32),
                         -grid_S, grid_S)
        flat_i = (cy + grid_S) * (2 * grid_S + 1) + (cx + grid_S)
        return torch.gather(ssd_flat, 1, flat_i[:, None].long())[:, 0]

    mv8 = mv_fp * 8
    if not desc_steps:
        return mv8, None, None, None, grid_fn
    # one patch gather per block; every descent candidate evaluates
    # in-patch (drift <= M px)
    patch32, pir0, pic0 = _gather_patch(ryp, by, bx, mv8, 32, 0, M)

    def mv_rate(mv):
        return (rd["mv_bits"][torch.abs(mv[..., 0]).long()]
                + rd["mv_bits"][torch.abs(mv[..., 1]).long()])

    pred = _mc_patch(patch32, pir0, pic0, by, bx, mv8, 32, 0, M, bd=bd)
    d = (pred - blks).to(torch.float32)
    best = torch.sum(d * d, dim=(1, 2)) + rd["lam"] * mv_rate(mv8)
    for step_sz in desc_steps:
        delta = torch.tensor([[-step_sz, 0], [step_sz, 0], [0, -step_sz],
                              [0, step_sz]], dtype=torch.int32, device=dev)
        cands = mv8[None] + delta[:, None, :]            # [4,B,2]
        pred = _mc_patch_multi(patch32, pir0, pic0, by, bx, cands, 32, 0,
                               M, bd=bd)
        df = (pred - blks[None]).to(torch.float32)
        costs = (torch.sum(df * df, dim=(2, 3))
                 + rd["lam"] * mv_rate(cands))           # [4,B]
        k = torch.argmin(costs, dim=0)
        cbest = torch.gather(costs, 0, k[None])[0]
        cmv = torch.gather(cands, 0, k[None, :, None].expand(1, B, 2))[0]
        better = cbest < best
        mv8 = torch.where(better[:, None], cmv, mv8)
        best = torch.where(better, cbest, best)
    # zero-MV blocks stay GLOBALMV-zero
    is_zero = torch.all(mv_fp == 0, dim=1)
    mv8 = torch.where(is_zero[:, None], 0, mv8)
    return mv8, patch32, pir0, pic0, grid_fn


def _coarse_mv(y, ryp, B, search: int = SEARCH):
    """Hierarchical long-range candidate: full-pel SSD at 4x
    downsampling over +-4*search px. Returns [B, 2] full-res eighth-pel
    MVs on the 4-px grid, clamped so the 8-tap window stays inside the
    padding of both planes. Same matmul-diagonal form as the fine
    search, in f32; the sums that pass 2^24 run in the reference's
    order."""
    h, tw = y.shape
    S = search                                     # ds4 radius
    dev = y.device

    def ds4(p):
        return (p.reshape(p.shape[0] // 4, 4, p.shape[1] // 4, 4)
                .to(torch.float32).mean((1, 3)))

    yd = ds4(y)                                    # [h/4, tw/4]
    # reference without PAD, downsampled, then re-padded by S
    rf = ryp[PAD:PAD + h, PAD:PAD + tw]
    rd4 = _edge_pad(ds4(rf), S)
    blks = to_blocks(yd, 8)                        # [B, 8, 8]
    win_sz = 2 * S + 8
    nby, nbx = h // 32, tw // 32
    K = (win_sz + 7) // 8
    need_r = 8 * (nby + K - 1)
    need_c = 8 * (nbx + K - 1)
    pr = max(0, need_r - rd4.shape[0])
    pc = max(0, need_c - rd4.shape[1])
    g = (torch.nn.functional.pad(rd4, (0, pc, 0, pr))[:need_r, :need_c]
         .reshape(nby + K - 1, 8, nbx + K - 1, 8).permute(0, 2, 1, 3))
    rows = [torch.cat([g[i:nby + i, j:nbx + j] for j in range(K)], dim=-1)
            for i in range(K)]
    wins = (torch.cat(rows, dim=-2)
            .reshape(B, 8 * K, 8 * K)[:, :win_sz, :win_sz])
    S1 = 2 * S + 1
    w2 = torch.stack([wins[:, :, dx: dx + 8] for dx in range(S1)], 2)
    # the f32 contraction over c, one term at a time as XLA:CPU sums it
    m = None
    for c in range(8):
        t = blks[:, :, None, None, c] * w2[:, None, :, :, c]
        m = t if m is None else m + t
    corr = m[:, 0, 0:S1, :]
    for r in range(1, 8):
        corr = corr + m[:, r, r: r + S1, :]
    wsq = _window_sum(wins * wins, 8, 8)
    ssd = wsq - 2.0 * corr + _rsum(blks * blks)[:, None, None]
    flat = torch.argmin(ssd.reshape(B, -1), dim=1).to(torch.int32)
    mv_px = torch.stack([flat // S1 - S, flat % S1 - S], 1) * 4
    ii = torch.arange(B, dtype=torch.int32, device=dev)
    by = (ii // nbx) * 32
    bx = (ii % nbx) * 32
    # the binding limit is chroma's PAD/2 at half scale: 2*(PAD/2 - 8)
    lim = min(PAD - 8, 2 * (PAD // 2 - 8))
    tr = torch.clamp(by + mv_px[:, 0], -lim, h - 32 + lim)
    tc = torch.clamp(bx + mv_px[:, 1], -lim, tw - 32 + lim)
    return torch.stack([tr - by, tc - bx], 1) * 8  # 1/8 pel


def _median_q(mv8):
    """The median MV on the quarter-pel grid, as the reference computes
    it: jnp.median (the mean of the two middle values for an even
    count, in f32), /2, round half to even, *2. torch.median would
    return the lower middle value."""
    a = torch.sort(mv8.to(torch.float32), dim=0).values
    n = a.shape[0]
    med = (a[(n - 1) // 2] + a[n // 2]) * 0.5
    return torch.round(med / 2).to(torch.int32) * 2


# ---- the P-frame body --------------------------------------------------------

def _check_p_options(use_split, ryp2, fwd2, intra_rdo, b64_rdo,
                     use_split8, bd):
    if ryp2 is not None or fwd2:
        _not_ported("two-reference P/B steps", "item 11 (other P/B routes)")
    for on, what in ((use_split, "split RDO"), (intra_rdo, "intra-in-inter"),
                     (b64_rdo, "the 64x64 merge"),
                     (use_split8, "16->8 split RDO")):
        if on:
            _not_ported(what, "item 8 (keyframes at speeds 8 and 6: the "
                        "speed-6 P tools)")
    if bd != 8:
        _not_ported("bit depth above 8", "item 12 (bd=10)")


def p_frame_body(y, u, v, ryp, rup, rvp, dcq, acq, cdef_prm, rd,
                 by, bx, nby, nbx, deblock_fn=None, cdef_fn=None,
                 use_split: bool = True,
                 ryp2=None, rup2=None, rvp2=None, ds16=None,
                 use_satd: bool = False, refine16: bool = True,
                 fwd2: bool = False, intra_rdo: bool = False,
                 b64_rdo: bool = False,
                 search: int = SEARCH, subpel: bool = True,
                 use_split8: bool = False, bd: int = 8, mark=_nomark):
    """The batched P-frame encode of one frame, single reference, no
    split (the speed-9/10 toolset): full-pel search, MV-field candidate
    passes, skip RD, recon, injected in-loop filter, scan lines.

    y/u/v: source planes (int32); ryp/rup/rvp: PADDED reference planes
    (int32); by/bx: int32 pixel origins of the 32-blocks; dcq/acq: luma
    quantizer 0-d int32 tensors. `mark(name)` is called after each stage
    (search, cand, code). Returns the reference's 19-tuple."""
    _check_p_options(use_split, ryp2, fwd2, intra_rdo, b64_rdo, use_split8,
                     bd)
    from rav1e_tpu_torch.pipeline.tpu_intra import _dq_dyn, _q_dyn, block_bits
    h, tw = y.shape[0], y.shape[1]
    B = nby * nbx
    mx = (1 << bd) - 1
    dev = y.device
    blks = to_blocks(y, 32)                       # [B,32,32]
    if ds16 is None:
        ds16 = torch.ones((B, 4), dtype=torch.float32, device=dev)
    ds32 = torch.mean(ds16, dim=1)                # [B]
    mv8, _, _, _, gridf0 = _search_one_ref(
        ryp, blks, by, bx, rd, B, use_satd, search, subpel, bd=bd)
    mark("search")

    ub = to_blocks(u.to(torch.int32), 16)
    vb = to_blocks(v.to(torch.int32), 16)
    lam = rd["lam"]
    i32 = torch.int32

    def exact_sse(ref_pad):
        def f(mv):
            p = _mc_batch(ref_pad, by, bx, mv, 32, 0, bd=bd)
            return torch.sum((p - blks).to(torch.float32) ** 2, dim=(1, 2))
        return f

    def cand_pass(mv8, sse_fn, extra=None, grid_fn=None):
        """Left / above / zero / median MV candidates priced with
        NEIGHBOUR-RELATIVE rates (NEAREST alias when the MV matches the
        stack predictor); grid_fn preselects one alternative on the
        SSD surface so sse_fn runs on {own, best-alt, extra} only."""
        mvg = mv8.reshape(nby, nbx, 2)
        mvl = torch.cat([mvg[:, :1], mvg[:, :-1]], 1).reshape(B, 2)
        mva = torch.cat([mvg[:1], mvg[:-1]], 0).reshape(B, 2)

        def zero(mv):
            return (mv[:, 0] == 0) & (mv[:, 1] == 0)

        def dbits(mv, pred):
            d0 = torch.clamp(torch.abs(mv[:, 0] - pred[:, 0]), max=1024)
            d1 = torch.clamp(torch.abs(mv[:, 1] - pred[:, 1]), max=1024)
            return rd["mv_bits"][d0.long()] + rd["mv_bits"][d1.long()]

        def rate_rel(mv, pred):
            r = rd["newmv"] + dbits(mv, pred)
            same = (mv[:, 0] == pred[:, 0]) & (mv[:, 1] == pred[:, 1])
            r = torch.where(same & ~zero(pred), rd["nearest"], r)
            return torch.where(zero(mv), rd["globalmv"], r)

        r_own = rate_rel(mv8, mvl)
        mv0 = torch.zeros_like(mv8)
        mvmed = _median_q(mv8)[None].expand(B, 2)
        rates = [r_own,
                 torch.where(zero(mvl), rd["globalmv"], rd["nearest"]),
                 torch.where(zero(mva), rd["globalmv"], rd["near"]),
                 rd["globalmv"].expand(B),
                 rate_rel(mvmed, mvl)]
        cands = [mv8, mvl, mva, mv0, mvmed]
        if grid_fn is not None:
            alt_r = torch.stack(rates[1:], 0)             # [4,B]
            alt_c = (ds32[None]
                     * torch.stack([grid_fn(c) for c in cands[1:]], 0)
                     + lam * alt_r)
            ka = torch.argmin(alt_c, dim=0)               # [B]
            alt_mv = cands[1]
            for i in range(1, 4):
                alt_mv = torch.where(ka[:, None] == i, cands[1 + i],
                                     alt_mv)
            cands = [mv8, alt_mv]
            rates = [rates[0], torch.gather(alt_r, 0, ka[None])[0]]
        if extra is not None:
            cands.append(extra)
            rates.append(rate_rel(extra, mvl))
        cand_r = torch.stack(rates, 0)                    # [C,B]
        cc = (ds32[None] * torch.stack([sse_fn(c) for c in cands], 0)
              + lam * cand_r)
        k = torch.argmin(cc, dim=0)                       # own wins ties
        out = mv8
        for i in range(1, len(cands)):
            out = torch.where(k[:, None] == i, cands[i], out)
        return out, torch.gather(cand_r, 0, k[None])[0]

    # blob erosion on the SSD surface, then the long-range rescue and
    # one exact re-judge
    for _ in range(8):
        mv8, _ = cand_pass(mv8, gridf0)
    mv_coarse = _coarse_mv(y, ryp, B, search)
    mv8, _ = cand_pass(mv8, exact_sse(ryp), extra=mv_coarse,
                       grid_fn=gridf0)
    pred_y = _mc_batch(ryp, by, bx, mv8, 32, 0, bd=bd)
    pred_u = _mc_batch(rup, by // 2, bx // 2, mv8, 16, 1, bd=bd)
    pred_v = _mc_batch(rvp, by // 2, bx // 2, mv8, 16, 1, bd=bd)
    choice = torch.zeros((B,), dtype=i32, device=dev)
    mvb8 = torch.zeros_like(mv8)
    mark("cand")

    def code(resid, tx, chroma=False):
        # quantizer scalars: the frame's luma q, or the chroma q at the
        # frame-header delta_q_u
        cf = T.forward_transform(resid, tx, TxType.DCT_DCT)
        qd = rd["dcq_c"] if chroma else dcq
        qa = rd["acq_c"] if chroma else acq
        lv = _q_dyn(cf, tx, qd, qa)
        r2 = T.inverse_transform(_dq_dyn(lv, tx, qd, qa), tx,
                                 TxType.DCT_DCT, bd=bd)
        return lv, r2

    lv_y, r2_y = code(blks - pred_y, TxSize.TX_32X32)
    lv_u, r2_u = code(ub - pred_u, TxSize.TX_16X16, chroma=True)
    lv_v, r2_v = code(vb - pred_v, TxSize.TX_16X16, chroma=True)
    # skip as an RD decision: sse(recon) + λ(skip0 + coeff bits) vs
    # sse(pred) + λ·skip1
    cd_y = torch.clamp(pred_y + r2_y, 0, mx)
    cd_u = torch.clamp(pred_u + r2_u, 0, mx)
    cd_v = torch.clamp(pred_v + r2_v, 0, mx)

    def sse(a, b):
        return torch.sum((a - b).to(torch.float32) ** 2, dim=(1, 2))

    sse_c = sse(cd_y, blks) + sse(cd_u, ub) + sse(cd_v, vb)
    sse_s = sse(pred_y, blks) + sse(pred_u, ub) + sse(pred_v, vb)
    cbits = (block_bits(lv_y, rd["y32"]) + block_bits(lv_u, rd["c16"])
             + block_bits(lv_v, rd["c16"]))
    skip = (ds32 * sse_s + lam * rd["skip1"]
            <= ds32 * sse_c + lam * (rd["skip0"] + cbits))
    sk3 = skip[:, None, None]
    lv_y = torch.where(sk3, 0, lv_y)
    lv_u = torch.where(sk3, 0, lv_u)
    lv_v = torch.where(sk3, 0, lv_v)
    rec_y = torch.where(sk3, pred_y, cd_y)
    rec_u = torch.where(sk3, pred_u, cd_u)
    rec_v = torch.where(sk3, pred_v, cd_v)
    mark("code")

    split = torch.zeros((B,), dtype=torch.bool, device=dev)
    zeros = functools.partial(torch.zeros, dtype=i32, device=dev)
    return _finish_outputs(
        y, u, v, h, tw, nby, nbx, B, rd, cdef_prm, mv8, skip, split,
        split[:, None, None], mv8[:, None, :].expand(B, 4, 2),
        skip[:, None].expand(B, 4), lv_y, lv_u, lv_v,
        zeros((B * 4, 16, 16)), zeros((B * 4, 8, 8)), zeros((B * 4, 8, 8)),
        rec_y, rec_u, rec_v, deblock_fn, cdef_fn, choice, mvb8, bd=bd)


def _finish_outputs(y, u, v, h, tw, nby, nbx, B, rd, cdef_prm, mv8,
                    skip, split, sp3, mv16_out, skip16_out, lv_y, lv_u,
                    lv_v, lv_y16, lv_u8, lv_v8, rec_y, rec_u, rec_v,
                    deblock_fn, cdef_fn, choice, mvb8, b64_map=None,
                    split16=None, skip8_out=None, lv_y8=None,
                    lv_u4=None, lv_v4=None, bd: int = 8):
    """Common tail of p_frame_body: in-loop filter + scan line + output
    tuple. The 16->8 layout (split16) is not ported; the P frame's CDEF
    runs in _core's `cdef` stage, not through cdef_fn."""
    if split16 is not None:
        _not_ported("16->8 split RDO", "item 8 (keyframes at speeds 8 and "
                    "6: the speed-6 P tools)")
    if cdef_fn is not None:
        raise NotImplementedError(
            "p_frame_body's cdef_fn has no caller in rav1e_tpu_torch: the "
            "P frame's CDEF search runs in _core (its `cdef` stage)")
    dev = y.device
    fry = from_blocks(rec_y, h, tw, 32)
    fru = from_blocks(rec_u, h // 2, tw // 2, 16)
    frv = from_blocks(rec_v, h // 2, tw // 2, 16)
    if deblock_fn is not None:
        srcs32 = [y, u.to(torch.int32), v.to(torch.int32)]
        lf_lvl, (fry, fru, frv) = deblock_fn(
            [fry, fru, frv], srcs32, rd["base_lf"],
            split.reshape(nby, nbx), None)
    else:
        lf_lvl = torch.zeros((), dtype=torch.int32, device=dev)
    nsb = ((nby + 1) // 2, (nbx + 1) // 2)
    cdef_idx = torch.zeros(nsb, dtype=torch.int32, device=dev)
    sl = scanline(lv_y, lv_u, lv_v, lv_y16, lv_u8, lv_v8, split, B)
    if b64_map is None:
        b64_map = torch.zeros(nsb, dtype=torch.bool, device=dev)
    pix = _pix_dtype(bd)
    return (mv8, skip, sl,
            lv_y.to(torch.int16), lv_u.to(torch.int16),
            lv_v.to(torch.int16),
            fry.to(pix), fru.to(pix), frv.to(pix), lf_lvl, cdef_idx,
            split, mv16_out.to(torch.int32), skip16_out,
            choice.to(torch.int32), mvb8.to(torch.int32), b64_map,
            torch.zeros((B, 4), dtype=torch.bool, device=dev),
            torch.zeros((B, 4, 4), dtype=torch.bool, device=dev))


def _sub_grids(nby, nbx, split16, skip16_out, skip8_out):
    """Spatial grids from quad-ordered flags: s16g [2nby, 2nbx] — the
    per-16 sub-split map; skip8g [4nby, 4nbx] — the exact 8x8-unit skip
    map (per-8 inside split16 quads, the 16's skip elsewhere): CDEF's
    skip gate (and the 16->8 deblock map of item 8)."""
    s16g = (split16.reshape(nby, nbx, 2, 2)
            .permute(0, 2, 1, 3).reshape(nby * 2, nbx * 2))
    sk16 = (skip16_out.reshape(nby, nbx, 2, 2)
            .permute(0, 2, 1, 3).reshape(nby * 2, nbx * 2))
    sk8 = (skip8_out.reshape(nby, nbx, 2, 2, 2, 2)
           .permute(0, 2, 4, 1, 3, 5).reshape(nby * 4, nbx * 4))
    base = sk16.repeat_interleave(2, 0).repeat_interleave(2, 1)
    s16x = s16g.repeat_interleave(2, 0).repeat_interleave(2, 1)
    return s16g, torch.where(s16x, sk8, base)


# ---- coefficient compaction (shared with the keyframe path) ------------------

@lru_cache(maxsize=1)
def _scans():
    from rav1e_tpu_torch.entropy.coeffs import TX_CLASS_2D, scan_order
    return (scan_order(32, 32, TX_CLASS_2D),
            scan_order(16, 16, TX_CLASS_2D),
            scan_order(8, 8, TX_CLASS_2D))


def _take(x, scan, dim):
    return torch.index_select(
        x, dim, torch.as_tensor(np.asarray(scan, np.int64),
                                device=x.device))


def scanline(lv_y, lv_u, lv_v, lv_y16, lv_u8, lv_v8, split, B,
             lv_y8=None, lv_u4=None, lv_v4=None, split16=None):
    """Device-side [B, 1536] int16 scan-ordered level line (split
    blocks: quadrant-major sub-TX scans). The reference's split16
    (16->8 sub-quad) layout is not ported yet."""
    if split16 is not None:
        _not_ported("the 16->8 scan layout", "item 8 (keyframes at "
                    "speeds 8 and 6)")
    scan32, scan16, scan8 = _scans()
    y_n = _take(lv_y.reshape(B, 1024), scan32, 1)
    u_n = _take(lv_u.reshape(B, 256), scan16, 1)
    v_n = _take(lv_v.reshape(B, 256), scan16, 1)
    y_s = _take(lv_y16.reshape(B, 4, 256), scan16, 2).reshape(B, 1024)
    u_s = _take(lv_u8.reshape(B, 4, 64), scan8, 2).reshape(B, 256)
    v_s = _take(lv_v8.reshape(B, 4, 64), scan8, 2).reshape(B, 256)
    s1 = split[:, None]
    return torch.cat(
        [torch.where(s1, y_s, y_n), torch.where(s1, u_s, u_n),
         torch.where(s1, v_s, v_n)], dim=1).to(torch.int16)


@lru_cache(maxsize=1)
def _stream_maps():
    """Host inverse maps: stream position p (0..1535) -> plane and
    raster (spatial) index within the plane's level array, for the
    NONE-partition and SPLIT layouts."""
    scan32, scan16, scan8 = _scans()
    pl = np.empty(SL_LEN, np.int8)
    pl[:1024] = 0
    pl[1024:1280] = 1
    pl[1280:] = 2
    idx_ns = np.empty(SL_LEN, np.int32)
    idx_ns[:1024] = scan32
    idx_ns[1024:1280] = scan16
    idx_ns[1280:] = scan16
    idx_sp = np.empty(SL_LEN, np.int32)
    for p in range(1024):
        q, s = p // 256, scan16[p % 256]
        sr, sc = s // 16, s % 16
        idx_sp[p] = (16 * (q // 2) + sr) * 32 + 16 * (q % 2) + sc
    for base in (1024, 1280):
        for k in range(256):
            q, s = k // 64, scan8[k % 64]
            sr, sc = s // 8, s % 8
            idx_sp[base + k] = (8 * (q // 2) + sr) * 16 + 8 * (q % 2) + sc
    return pl, idx_ns, idx_sp


def nnz_stream(sl, cap):
    """Device-side stream compaction of the scan line: returns
    (counts [B] int32, pos [cap+1] int32, val [cap+1] int32) with the
    nonzero entries of `sl` in FIXED per-block slots of k = cap // B
    entries (block-major, scan order; slot tail zero-padded). Blocks
    with more than k nonzeros overflow (host full-gathers those).

    A per-row top-k over position keys. Only the top-k VALUES are used
    and the keys of nonzeros are unique, so the tie order of
    `torch.topk` (among the zero keys) cannot change the result."""
    B, L = sl.shape
    k = cap // B
    sl32 = sl.to(torch.int32)
    nz = sl32 != 0
    counts = nz.sum(dim=1, dtype=torch.int32)
    # key: earlier scan positions get larger keys; zeros get 0
    ar = torch.arange(L, dtype=torch.int32, device=sl.device)
    key = torch.where(nz, L - ar[None, :], 0)
    topv = torch.topk(key, k, dim=1).values     # [B, k] descending
    live = topv > 0
    pos = torch.where(live, L - topv, 0)         # ascending scan pos
    val = torch.where(live, torch.gather(sl32, 1, pos.long()), 0)
    pad = torch.zeros((1,), dtype=torch.int32, device=sl.device)
    return (counts, torch.cat([pos.reshape(-1), pad]),
            torch.cat([val.reshape(-1), pad]))


def unpack_stream(counts, pos, val, split, cap):
    """Host: scatter the nonzero stream back into per-block level
    arrays (lv_y [B,32,32], lv_u/lv_v [B,16,16] int16). Returns the
    arrays plus `over` — blocks whose entries ran past the stream
    capacity (the caller full-gathers those). The reference's split16
    (16->8) layout is not ported yet."""
    B = counts.shape[0]
    k = cap // B
    kc = np.minimum(counts, k)
    over = counts > k
    lv_y = np.zeros((B, 1024), np.int16)
    lv_u = np.zeros((B, 256), np.int16)
    lv_v = np.zeros((B, 256), np.int16)
    if int(kc.sum()):
        # fixed per-block slots: block b's entries at [b*k, b*k+kc[b])
        mask = np.arange(k)[None, :] < kc[:, None]
        blk, slot = np.nonzero(mask)
        p = pos[:B * k].reshape(B, k)[blk, slot]
        v = val[:B * k].reshape(B, k)[blk, slot]
        pl, idx_ns, idx_sp = _stream_maps()
        plane = pl[p]
        sidx = np.where(split[blk], idx_sp[p], idx_ns[p])
        for i, lv in enumerate((lv_y, lv_u, lv_v)):
            m = plane == i
            lv[blk[m], sidx[m]] = v[m]
    return (lv_y.reshape(B, 32, 32), lv_u.reshape(B, 16, 16),
            lv_v.reshape(B, 16, 16), over)


def gather_dense(lv_y, lv_u, lv_v, idx):
    """ONE transfer for all dense blocks' full-precision levels:
    [D, 1024+256+256] int16."""
    n = idx.shape[0]
    return torch.cat([lv_y[idx].reshape(n, -1), lv_u[idx].reshape(n, -1),
                      lv_v[idx].reshape(n, -1)], dim=1)


# ---- single-buffer host<->device IO -------------------------------------------

def _stream_cap(B: int) -> int:
    """Capacity of the P frame's nonzero-coefficient stream (entries):
    64 nonzeros per block; blocks past it take the dense gather."""
    return B * 64


def _i16_hi_lo(x):
    """int16 -> (hi int8, lo uint8) lanes (arithmetic-shift encoding;
    host rebuilds hi*256 + lo)."""
    x = x.to(torch.int32)
    return (x >> 8).to(torch.int8), (x & 255).to(torch.uint8)


def pack_outputs(o):
    """Device-side: p_frame_body outputs -> ONE flat int8 buffer:
    [B+1 header rows | counts int16[B] | pos int16[cap+1] |
    val int16[cap+1] | cdef_idx | b64_map].

    Header row (HDR_BYTES): mv8 hi/lo int16[2] | mv16 int16[4,2] |
    7 flag bytes (skip, 0, split, skip16[4]) | mvb8 hi/lo int16[2] |
    ref choice | split16 nibble | skip8 bits lo/hi. Tail header row:
    [lf_lvl]. Casts to int8 wrap values above 127, as the reference's
    astype does."""
    mv8, skip, sl = o[0], o[1], o[2]
    lf, cdef_idx = o[9], o[10]
    split, mv16, skip16 = o[11], o[12], o[13]
    choice, mvb8 = o[14], o[15]
    b64_map = o[16]
    split16, skip8 = o[17], o[18]
    B = mv8.shape[0]
    dev = mv8.device
    i8 = torch.int8

    def words(x):
        hi, lo = _i16_hi_lo(x.reshape(B, -1))
        return torch.stack([hi, lo.to(i8)], -1).reshape(B, -1)

    def bits(x):
        # [B, k<=8] bool -> one packed byte column
        k = x.shape[1]
        w = torch.sum(x.to(torch.int32) << torch.arange(
            k, dtype=torch.int32, device=dev)[None], dim=1,
            dtype=torch.int32)
        return w.to(i8)[:, None]

    zero = torch.zeros((B, 1), dtype=i8, device=dev)
    flags = torch.cat([skip[:, None].to(i8), zero, split[:, None].to(i8),
                       skip16.to(i8)], dim=1)
    sk8f = skip8.reshape(B, 16)
    hdr = torch.cat([words(mv8), words(mv16), flags, words(mvb8),
                     choice[:, None].to(i8), bits(split16.reshape(B, 4)),
                     bits(sk8f[:, :8]), bits(sk8f[:, 8:])], dim=1)
    tail = torch.zeros((1, HDR_BYTES), dtype=i8, device=dev)
    tail[0, 0] = lf.to(i8)
    hdr = torch.cat([hdr, tail], dim=0)
    counts, pos, val = nnz_stream(sl, _stream_cap(B))

    def words1(x):
        x = x.to(torch.int32)
        return torch.stack([(x >> 8).to(i8), (x & 255).to(i8)],
                           -1).reshape(-1)

    return torch.cat([hdr.reshape(-1), words1(counts), words1(pos),
                      words1(val), cdef_idx.reshape(-1).to(i8),
                      b64_map.reshape(-1).to(i8)])


def unpack_outputs(buf: np.ndarray, nby: int, nbx: int):
    """Host-side twin of pack_outputs. Returns (mv8, skip, split,
    mv16, skip16, choice, mvb8, lf_lvl, cdef_map, counts, pos, val,
    b64_map, split16, skip8)."""
    buf = np.asarray(buf)
    total = buf.shape[0]
    B = nby * nbx
    nsb = ((nby + 1) // 2) * ((nbx + 1) // 2)
    assert (B + 1) * HDR_BYTES + 2 * B + 4 * (_stream_cap(B) + 1) \
        + 2 * nsb == total, total
    cap = _stream_cap(B)
    o0 = (B + 1) * HDR_BYTES
    hdr = buf[:o0].reshape(B + 1, HDR_BYTES)
    body, tail = hdr[:-1], hdr[-1]

    def unw(raw):
        w = raw.reshape(-1, 2).astype(np.int32)
        return w[:, 0] * 256 + (w[:, 1] & 0xFF)

    counts = unw(buf[o0:o0 + 2 * B])
    o1 = o0 + 2 * B
    pos = unw(buf[o1:o1 + 2 * (cap + 1)])
    o2 = o1 + 2 * (cap + 1)
    val = unw(buf[o2:o2 + 2 * (cap + 1)]).astype(np.int16)
    o3 = o2 + 2 * (cap + 1)
    cdef_map = (buf[o3:o3 + nsb].astype(np.uint8)
                .reshape((nby + 1) // 2, (nbx + 1) // 2))
    b64_map = (buf[o3 + nsb:] != 0).reshape((nby + 1) // 2,
                                            (nbx + 1) // 2)

    def unwords(cols, shape):
        w = body[:, cols].reshape(B, -1, 2).astype(np.int16)
        return (w[:, :, 0] * 256 + (w[:, :, 1] & 0xFF)).reshape(shape)

    mv8 = unwords(slice(0, 4), (B, 2)).astype(np.int32)
    mv16 = unwords(slice(4, 20), (B, 4, 2)).astype(np.int32)
    flags = body[:, 20:27] != 0
    skip, split = flags[:, 0], flags[:, 2]
    skip16 = flags[:, 3:7]
    mvb8 = unwords(slice(27, 31), (B, 2)).astype(np.int32)
    choice = body[:, 31].astype(np.int32)

    def unbits(col, k):
        w = body[:, col].astype(np.int32) & 0xFF
        return (w[:, None] >> np.arange(k)[None]) & 1 != 0

    split16 = unbits(32, 4)                        # [B, 4]
    skip8 = np.concatenate([unbits(33, 8), unbits(34, 8)],
                           axis=1).reshape(B, 4, 4)
    return (mv8, skip, split, mv16, skip16, choice, mvb8,
            int(tail[0]), cdef_map, counts, pos, val, b64_map,
            split16, skip8)


def _pix_dtype(bd: int):
    if bd != 8:
        _not_ported("bit depth above 8", "item 12 (bd=10)")
    return torch.uint8


def pack_src(planes, bd: int = 8) -> np.ndarray:
    """Host-side: [y, u, v] 4:2:0 -> one [3h/2, w] uint8 array (u|v side
    by side under y) for a single upload."""
    if bd != 8:
        _not_ported("bit depth above 8", "item 12 (bd=10)")
    y, u, v = (np.asarray(p, np.uint8) for p in planes)
    return np.concatenate([y, np.concatenate([u, v], axis=1)], axis=0)


def _unpack_src(buf, h, w):
    y = buf[:h].to(torch.int32)
    u = buf[h:, :w // 2].to(torch.int32)
    v = buf[h:, w // 2:].to(torch.int32)
    return y, u, v


# ---- the per-shape step -------------------------------------------------------

@lru_cache(maxsize=None)
def _block_origins(nby: int, nbx: int, device: torch.device):
    by = (np.repeat(np.arange(nby), nbx) * 32).astype(np.int32)
    bx = (np.tile(np.arange(nbx), nby) * 32).astype(np.int32)
    return (torch.as_tensor(by, device=device),
            torch.as_tensor(bx, device=device))


@lru_cache(maxsize=8)
def _core(h: int, w: int, use_cdef: bool = False,
          use_deblock: bool = True, use_split: bool = True,
          two_ref: bool = False, use_satd: bool = False,
          refine16: bool = True, fwd2: bool = False,
          intra_rdo: bool = False, b64_rdo: bool = False,
          search: int = SEARCH, subpel: bool = True,
          use_split8: bool = False, bd: int = 8):
    """Batched P-frame step for an h x w frame, as plain functions (torch
    runs eagerly; nothing is compiled). qindex enters as the dcq/acq
    tensors. Returns (step, (nby, nbx), gather_dense) with
    step(src, ry, ru, rv, dcq, acq, cdef_prm, rd, ds, mark) ->
    (packed decisions int8, lv_y, lv_u, lv_v (int16, on the device for
    the overflow gather), recon y, u, v uint8). `mark(name)` runs after
    each stage: search, cand, code (core), filt (deblock), cdef, pack."""
    if two_ref:
        _not_ported("the two-reference step", "item 11 (other P/B routes)")
    nby, nbx = h // 32, w // 32

    def pad3(ry, ru, rv):
        return (_edge_pad(ry.to(torch.int32), PAD),
                _edge_pad(ru.to(torch.int32), PAD // 2),
                _edge_pad(rv.to(torch.int32), PAD // 2))

    def core(src, ry, ru, rv, dcq, acq, cdef_prm, rd, ds, mark=_nomark):
        y, u, v = _unpack_src(src, h, w)
        ryp, rup, rvp = pad3(ry, ru, rv)
        by, bx = _block_origins(nby, nbx, src.device)
        return p_frame_body(y, u, v, ryp, rup, rvp, dcq, acq, cdef_prm,
                            rd, by, bx, nby, nbx, None, None, use_split,
                            ds16=ds, use_satd=use_satd, refine16=refine16,
                            intra_rdo=intra_rdo, b64_rdo=b64_rdo,
                            search=search, subpel=subpel,
                            use_split8=use_split8, bd=bd, mark=mark)

    def filt(src, fry, fru, frv, base_lf, cdef_prm, split, skip16, b64m,
             lam, split16, skip8q, mark=_nomark):
        """The in-loop filter searches as their own stages: the deblock
        level search on the 16-px edge grid (interior edges gated by the
        split map), then, with use_cdef, the per-64x64-SB CDEF ladder
        search against the source (damping cdef_prm[4], the
        nb_strengths RD at lam) on the exact 8x8-unit skip gate.
        Returns (lf_lvl, cdef_idx, y, u, v uint8)."""
        from rav1e_tpu_torch.ops.cdef import cdef_search_persb
        from rav1e_tpu_torch.ops.deblock import deblock_search
        y, u, v = _unpack_src(src, h, w)
        planes = [fry.to(torch.int32), fru.to(torch.int32),
                  frv.to(torch.int32)]
        _, skip8 = _sub_grids(nby, nbx, split16, skip16, skip8q)
        lf_lvl = torch.zeros((), dtype=torch.int32, device=src.device)
        if use_deblock:
            lf_lvl, planes = deblock_search(
                planes, [y, u, v], base_lf, block_y=16, block_c=8, bd=bd,
                split_map=split.reshape(nby, nbx))
        mark("filt")
        if use_cdef:
            cdef_idx, planes = cdef_search_persb(
                planes, [y, u, v], skip8, cdef_prm[4], lam=lam, bd=bd)
        else:
            cdef_idx = torch.zeros(((nby + 1) // 2, (nbx + 1) // 2),
                                   dtype=torch.int32, device=src.device)
        mark("cdef")
        dt = _pix_dtype(bd)
        return (lf_lvl, cdef_idx, planes[0].to(dt), planes[1].to(dt),
                planes[2].to(dt))

    def pack(o, lf_lvl, cdef_idx):
        o = list(o)
        o[9], o[10] = lf_lvl, cdef_idx
        return pack_outputs(o)

    def step(src, ry, ru, rv, dcq, acq, cdef_prm, rd, ds, mark=_nomark):
        o = core(src, ry, ru, rv, dcq, acq, cdef_prm, rd, ds, mark)
        if not (use_deblock or use_cdef):
            out = (pack(o, o[9], o[10]), o[3], o[4], o[5], o[6], o[7],
                   o[8])
            mark("pack")
            return out
        lf_lvl, cdef_idx, fry, fru, frv = filt(
            src, o[6], o[7], o[8], rd["base_lf"], cdef_prm, o[11], o[13],
            o[16], rd["lam"], o[17], o[18], mark)
        out = (pack(o, lf_lvl, cdef_idx), o[3], o[4], o[5], fry, fru, frv)
        mark("pack")
        return out

    return step, (nby, nbx), gather_dense


# ---- host side -----------------------------------------------------------------

def _fetch_packed(o, gather_dense, nby, nbx, packed=None):
    """Pull one frame's decisions to the host: ONE transfer of the
    packed buffer + (rarely) one batched gather for stream-overflow
    blocks. Returns (mv8, skip, lv_y, lv_u, lv_v, split, mv16, skip16,
    lf_lvl, cdef_idx, choice, mvb8, b64_map, split16, skip8)."""
    (mv8, skip, split, mv16, skip16, choice, mvb8, lf, cdef_map,
     counts, pos, val, b64_map, split16, skip8) = unpack_outputs(
        o[0].cpu().numpy() if packed is None else packed, nby, nbx)
    if split16.any():
        _not_ported("the 16->8 stream layout", "item 8 (keyframes at "
                    "speeds 8 and 6)")
    lv_y, lv_u, lv_v, over = unpack_stream(counts, pos, val, split,
                                           _stream_cap(nby * nbx))
    didx = np.nonzero(over)[0]
    if len(didx):
        g = gather_dense(o[1], o[2], o[3], torch.as_tensor(
            didx, device=o[1].device)).cpu().numpy()
        lv_y[didx] = g[:, :1024].reshape(-1, 32, 32)
        lv_u[didx] = g[:, 1024:1280].reshape(-1, 16, 16)
        lv_v[didx] = g[:, 1280:].reshape(-1, 16, 16)
    return (mv8, skip, lv_y, lv_u, lv_v, split, mv16, skip16,
            lf, cdef_map, choice, mvb8, b64_map, split16, skip8)


def _pack_pframe(h, w, qindex, order_hint, mv8, skip, lv_y, lv_u, lv_v,
                 use_native=False, cdef=None, film_grain=None,
                 render_size=None, lf_level=0, split=None, mv16=None,
                 skip16=None, refresh_flags=0x01, ref_slot=0,
                 show_frame=True, choice=None, b64_map=None,
                 lr_ctx=None, split16=None, skip8=None,
                 bit_depth: int = 8, tile_grid: tuple | None = None,
                 device=None, timings: dict | None = None):
    """Entropy-pack one P frame of 32x32 NONE blocks (single ref, no
    split) from the batched outputs: TileWriter walks the blocks on the
    host and its RecordingEncoder has the tile range-coded on `device`
    (the od_ec kernel on cuda). `timings` receives tile_walk, ec_kernel
    and finish.

    cdef: None, a 5-tuple (one frame-wide strength), or (5-tuple,
    idx_map): the per-SB form signals the ladder entries the SBs chose
    (compact_ladder) and a literal index per 64x64 SB in the tile. The
    C++ packer, LR, tiles and the split / 64x64 / intra block kinds are
    not ported."""
    if use_native:
        _not_ported("the C++ packer", "item 9 (the C++ packer)")
    cdef_map = None
    if cdef is not None and isinstance(cdef[1], np.ndarray):
        cdef, cdef_map = cdef
    if lr_ctx is not None:
        _not_ported("loop restoration", "item 13 (LRF)")
    if tile_grid is not None:
        _not_ported("multi-tile frames", "item 17 (parallel)")
    if bit_depth != 8:
        _not_ported("bit depth above 8", "item 12 (bd=10)")
    for x, what in ((split, "split blocks"), (b64_map, "64x64 blocks"),
                    (split16, "16->8 split blocks"),
                    (None if choice is None else np.asarray(choice) == 3,
                     "intra-in-inter blocks")):
        if x is not None and np.asarray(x).any():
            _not_ported(what, "item 8 (keyframes at speeds 8 and 6: the "
                        "speed-6 P tools)")
    dev = resolve_device(device)
    t_walk = time.perf_counter()
    seq = Sequence(width=w, height=h, enable_cdef=cdef is not None,
                   bit_depth=bit_depth,
                   film_grain_params_present=film_grain is not None)
    lf = int(lf_level)
    fp = FrameParams(frame_type=FrameType.INTER, base_q_idx=qindex,
                     render_size=render_size,
                     loop_filter_levels=(lf, lf, lf, lf))
    fp.film_grain = film_grain
    fp.delta_q_u_dc = fp.delta_q_u_ac = chroma_dq(qindex)
    cdef_bits = 0
    if cdef_map is not None:
        from rav1e_tpu_torch.ops.cdef import compact_ladder
        fp.cdef_damping = cdef[4]
        fp.cdef_strengths, cdef_bits, cdef_map = compact_ladder(cdef_map)
    elif cdef is not None:
        (fp.cdef_y_pri, fp.cdef_y_sec, fp.cdef_uv_pri, fp.cdef_uv_sec,
         fp.cdef_damping) = cdef
    ti = TileInfo(seq)
    mi_rows, mi_cols = h >> 2, w >> 2
    nbx = w // 32
    ec_times: dict = {}
    tw = TileWriter(mi_rows, mi_cols, qindex, inter_frame=True,
                    encoder=functools.partial(RecordingEncoder, dev,
                                              ec_times))
    if cdef_bits:
        tw.cdef_bits = cdef_bits
        tw.cdef_idx_map = cdef_map
    partitions: dict = {}
    blocks: dict = {}
    for b in range(mv8.shape[0]):
        by, bx = (b // nbx) * 32, (b % nbx) * 32
        r, c = by >> 2, bx >> 2
        partitions[(r, c, int(BlockSize.B64X64))] = PartitionType.SPLIT
        partitions[(r, c, int(BlockSize.B32X32))] = PartitionType.NONE
        mv = (int(mv8[b, 0]), int(mv8[b, 1]))
        d = BlockDecision(y_mode=(PredictionMode.GLOBALMV if mv == (0, 0)
                                  else PredictionMode.NEWMV),
                          uv_mode=PredictionMode.DC_PRED,
                          skip=bool(skip[b]), mv=mv)
        if not d.skip:
            d.coeffs = {0: lv_y[b], 1: lv_u[b], 2: lv_v[b]}
        blocks[(r, c)] = d
    tile = tw.write_tile(partitions, blocks)
    pkt = interframe_packet(seq, fp, ti, [tile], order_hint,
                            refresh_flags=refresh_flags,
                            ref_idx=[ref_slot] * 7, show_frame=show_frame)
    if timings is not None:
        # the walk's own time: the coding stages are timed in done()
        timings["tile_walk"] = (time.perf_counter() - t_walk
                                - ec_times["ec_kernel"] - ec_times["finish"])
        timings.update(ec_times)
    return pkt


def _ds16_quads(dscale, nby: int, nbx: int, device=None):
    """Per-16 distortion-scale grid [2*nby, 2*nbx] -> [B,4] in the quad
    (TL,TR,BL,BR) order p_frame_body expects; ones if None."""
    dev = resolve_device(device)
    if dscale is None:
        return torch.ones((nby * nbx, 4), dtype=torch.float32, device=dev)
    g = np.asarray(dscale, np.float32)
    assert g.shape == (2 * nby, 2 * nbx), (g.shape, nby, nbx)
    return torch.as_tensor(np.ascontiguousarray(
        g.reshape(nby, 2, nbx, 2).transpose(0, 2, 1, 3)
        .reshape(nby * nbx, 4)), device=dev)


def _q_scalars(qindex: int, dev):
    return (torch.tensor(dc_q_lut(qindex), dtype=torch.int32, device=dev),
            torch.tensor(ac_q_lut(qindex), dtype=torch.int32, device=dev))


def encode_pframe_tpu(planes, ref_planes, qindex: int = 100,
                      order_hint: int = 1, use_native: bool = False,
                      ref_dev=None, return_device: bool = False,
                      cdef: tuple | None = None, film_grain=None,
                      render_size: tuple | None = None,
                      use_split: bool = True,
                      refresh_flags: int = 0x01, ref_slot: int = 0,
                      show_frame: bool = True, dscale=None,
                      src_dev=None, use_satd: bool = False,
                      refine16: bool = True, intra_rdo: bool = False,
                      b64_rdo: bool = False, lr: bool = False,
                      search: int = SEARCH, subpel: bool = True,
                      use_split8: bool = False, bit_depth: int = 8,
                      tile_grid: tuple | None = None, device=None,
                      timings: dict | None = None):
    """Batched P frame (single reference) on the device; dims multiples
    of 32, 4:2:0 8-bit. Runs on `cuda` unless device="cpu" is passed.

    The defaults are the reference's (split RDO, a 16-px search, subpel),
    so a call that relies on them raises NotImplementedError naming the
    ROADMAP item of the tool not ported yet; the speed-8 toolset is
    use_split=False, refine16=False, search=8, subpel=True, and speeds
    9-10 take subpel=False. use_native (the reference's C++ packer, which
    writes the same bytes as the Python writer) is item 9.
    cdef: None (off) or (y_pri, y_sec, uv_pri, uv_sec, damping): each
    64x64 SB picks its ladder entry (damping cdef[4]) and the frame
    signals the entries used.
    ref_dev: device-resident reference planes (y, u, v uint8) from a
    prior call with return_device=True, which skips the upload; src_dev:
    the packed source (pack_src) already on the device. `timings`
    receives each stage's wall time. Returns (packet, [y, u, v] recon
    int32) and, with return_device, the device recon too."""
    if lr:
        _not_ported("loop restoration", "item 13 (LRF)")
    if use_native:
        _not_ported("the C++ packer", "item 9 (the C++ packer)")
    y, u, v = planes
    h, w = y.shape[0], y.shape[1]
    assert h % 32 == 0 and w % 32 == 0
    dev = resolve_device(device)
    stages = _Stages(dev, timings)
    step, (nby, nbx), gdense = _core(h, w, cdef is not None,
                                     use_split=use_split, use_satd=use_satd,
                                     refine16=refine16, intra_rdo=intra_rdo,
                                     b64_rdo=b64_rdo, search=search,
                                     subpel=subpel, use_split8=use_split8,
                                     bd=bit_depth)
    if ref_dev is None:
        ref_dev = tuple(torch.as_tensor(np.asarray(p, np.uint8), device=dev)
                        for p in ref_planes)
    if src_dev is None:
        src_dev = torch.from_numpy(pack_src(planes, bd=bit_depth)).to(dev)
    cdef_prm = _cdef_prm(cdef)
    rd = build_rd_inter(qindex, bit_depth, device=dev)
    ds = _ds16_quads(dscale, nby, nbx, dev)
    stages.mark("upload")
    outs = step(src_dev, *ref_dev, *_q_scalars(qindex, dev), cdef_prm, rd,
                ds, stages.mark)
    rec_dev = outs[4:7]
    (mv8, skip, lv_y, lv_u, lv_v, split, mv16, skip16, lf_lvl,
     cdef_map, _, _, _, _, _) = _fetch_packed(outs, gdense, nby, nbx)
    rec = [r.cpu().numpy().astype(np.int32) for r in rec_dev]
    stages.mark("fetch_unpack")
    pkt = _pack_pframe(h, w, qindex, order_hint, mv8, skip, lv_y, lv_u,
                       lv_v, cdef=None if cdef is None else (cdef_prm,
                                                             cdef_map),
                       film_grain=film_grain,
                       render_size=render_size, lf_level=lf_lvl,
                       split=split, mv16=mv16, skip16=skip16,
                       refresh_flags=refresh_flags, ref_slot=ref_slot,
                       show_frame=show_frame, bit_depth=bit_depth,
                       device=dev, timings=timings)
    if return_device:
        return pkt, rec, rec_dev
    return pkt, rec


def _cdef_prm(cdef):
    """The step's CDEF parameters: the 5-tuple of python ints, or the
    reference's placeholder when CDEF is off."""
    if cdef is not None and len(cdef) != 5:
        raise ValueError("cdef is (y_pri, y_sec, uv_pri, uv_sec, damping)")
    return tuple(int(c) for c in cdef) if cdef is not None else (0, 0, 0, 0,
                                                                 3)


def encode_gop_tpu(frames, qindex: int = 100, speed: int = 8,
                   cdef: tuple | None = None, device=None,
                   timings: list | None = None):
    """KEY + P chain on the device, at speeds 8-10; 4:2:0 8-bit frames
    with dims multiples of 32. Runs on `cuda` unless device="cpu" is
    passed. cdef (None, or (y_pri, y_sec, uv_pri, uv_sec, damping)) runs
    the per-SB CDEF search on every frame, with damping cdef[4]; each P
    frame then references the CDEF-filtered recon.

    The frames run in order: the keyframe's device half, its host pack,
    then each P step, its fetch and its host pack. The reference planes
    stay on the device between frames (the keyframe's filtered recon,
    then each P frame's). The reference's overlap of the keyframe pack
    and of per-frame fetch and pack with later frames' device work is
    ROADMAP item 10. Returns (packets, recons): the keyframe's recon as
    numpy int32 planes, each P frame's as uint8 tensors on the device.
    `timings`, when given a list, receives one dict of stage times per
    frame."""
    from rav1e_tpu_torch.api.speed import SpeedSettings
    from rav1e_tpu_torch.pipeline.tpu_intra import (_check_options,
                                                    analyze_keyframe,
                                                    encode_keyframe_tpu,
                                                    pack_keyframe)
    _check_options(speed, cdef, False, False, False, frames[0], None)
    dev = resolve_device(device)

    def frame_times():
        if timings is None:
            return None
        timings.append({})
        return timings[-1]

    if len(frames) == 1:
        pkt, rec = encode_keyframe_tpu(frames[0], qindex=qindex,
                                       speed=speed, cdef=cdef, device=dev,
                                       timings=frame_times())
        return [pkt], [rec]
    t_kf = frame_times()
    kd = analyze_keyframe(frames[0], qindex, speed, cdef=cdef, device=dev,
                          timings=t_kf)
    kf_pkt, kf_rec = pack_keyframe(kd, frames[0], qindex, device=dev,
                                   timings=t_kf)
    pkts, recs = [kf_pkt], [kf_rec]
    h, w = frames[0][0].shape
    ss = SpeedSettings.from_preset(speed)
    step, (nby, nbx), gdense = _core(h, w, cdef is not None,
                                     use_split=ss.partition_split_rdo,
                                     use_satd=ss.satd_subpel,
                                     refine16=ss.mv_refine_16,
                                     intra_rdo=ss.intra_in_inter,
                                     b64_rdo=ss.b64_merge,
                                     search=ss.search_px,
                                     subpel=ss.subpel,
                                     use_split8=ss.partition_split8)
    dcq, acq = _q_scalars(qindex, dev)
    rd = build_rd_inter(qindex, device=dev)
    cdef_prm = _cdef_prm(cdef)
    ones = _ds16_quads(None, nby, nbx, dev)
    rp = kd.rec_packed
    ref_dev = (rp[:h], rp[h:, :w // 2], rp[h:, w // 2:])
    for i, f in enumerate(frames[1:], start=1):
        t_p = frame_times()
        stages = _Stages(dev, t_p)
        src = torch.from_numpy(pack_src(f)).to(dev)
        stages.mark("upload")
        o = step(src, *ref_dev, dcq, acq, cdef_prm, rd, ones, stages.mark)
        ref_dev = o[4:7]
        (mv8, skip, lv_y, lv_u, lv_v, split, mv16, skip16, lf_lvl,
         cdef_map, _, _, _, _, _) = _fetch_packed(o, gdense, nby, nbx)
        stages.mark("fetch_unpack")
        pkts.append(_pack_pframe(
            h, w, qindex, i, mv8, skip, lv_y, lv_u, lv_v,
            cdef=None if cdef is None else (cdef_prm, cdef_map),
            lf_level=lf_lvl, split=split, mv16=mv16, skip16=skip16,
            device=dev, timings=t_p))
        recs.append([o[4], o[5], o[6]])
    return pkts, recs
