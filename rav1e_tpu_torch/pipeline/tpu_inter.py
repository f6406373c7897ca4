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
  at speeds 7-8 (subpel), a single full-pel step after ds2 at speeds
  9-10;
- spec 8-tap MC in int32 from patches that `ops.gather.gather_patches_many`
  (a CUDA kernel on the card) copies out of the padded reference, the
  independent gathers of a stage in one launch;
- DCT + quantize + bit-exact inverse over the [B, 32, 32] batch, skip
  RD, the deblock level search, CDEF's per-SB ladder search (ops/cdef,
  CUDA kernels on the card), and one packed int8 decision buffer;
- host: unpack, the C++ packer's one-call tile walk into od_ec symbol
  IR (entropy/native.py), od_ec coding of the IR by the CUDA kernels of
  entropy/ec_cuda, OBU packet.

encode_gop_tpu overlaps as the reference's does: the keyframe's host
half, each P frame's source packing and each P frame's fetch + pack run
on a pool of four worker threads while the main thread uploads and
dispatches the P steps in order; each worker's device work (fetches into
pinned buffers, the od_ec kernels) runs on a stream of its own that
waits only for its frame's step.

The speed-0 to 10 P toolsets (api/speed.py) and the reference's default
P call: single reference, subpel at speeds <= 8, a 24-px search at
speeds <= 2, CDEF when asked, at speeds <= 7 the PARTITION_SPLIT
candidate (per-16 MVs from {parent, zero}, or refined in-patch with
refine16; TX_16X16 + TX_8X8 residuals; per-16 skip RD), and at speed 6
SATD in the subpel descent,
the 16->8 split (TX_8X8 + TX_4X4 children on 4-tap chroma MC), the 64x64
merge (TX_64X64) and intra-in-inter (DC_PRED 32x32). The two-reference
step serves the B frame (encode_bframe_tpu: single-fwd, single-bwd or
COMPOUND_AVERAGE per block, the cheap {parent, zero} split) and the
LAST + GOLDEN P frame (encode_pframe2_tpu); both are packed by the
Python TileWriter, as the reference packs them, its IR coded on the
device. encode_pframe_tpu and encode_bframe_tpu code 8- and 10-bit
4:2:0 (bit_depth; 10-bit pixels are int16 on the device, _pix_dtype),
with loop restoration after CDEF when lr (pipeline/lr.py, the Python
walk then packs the tile, as in the reference), and in tiles with
tile_grid: frame-global decisions, each tile walked in tile-local
coordinates with its own entropy state (a P frame's on the C++ packer, on
worker threads; a B frame's on the Python TileWriter), every tile of the
frame range-coded in one od_ec launch (ec_cuda.pack_tile_irs);
encode_pframe2_tpu and encode_gop_tpu are 8-bit, as the reference's.
Options the reference's device steps do not reach raise
NotImplementedError (ROADMAP.md section 3).

Sums that rank decisions follow XLA:CPU's order where values pass 2^24
(the sliding window sums and per-block sums of squares of the search:
one f32 add at a time, row-major; the merge's and intra-in-inter's
SSEs: _sse64_xla, _sse_cols_xla, _sse_rows_xla; the two-reference
re-judge and ref choice: _sse_cols_xla, _sse_cols_b_xla; above 8 bits
the full-pel SSD correlation: _bf16_corr), so the port's decisions match
the reference's on the CPU; the other residual SSEs stay below 2^24 on
real content and are summed by torch.
"""

from __future__ import annotations

import functools
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache

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
from rav1e_tpu_torch.device import SideStream, resolve_device, to_host
from rav1e_tpu_torch.entropy.ec_cuda import IRRecorder, pack_tile_irs
from rav1e_tpu_torch.entropy.native import NativeTileWriter
from rav1e_tpu_torch.entropy.obu import (
    FrameParams,
    Sequence,
    TileInfo,
    interframe_packet,
)
from rav1e_tpu_torch.entropy.tile import BlockDecision, TileWriter
from rav1e_tpu_torch.ops import transforms as T
from rav1e_tpu_torch.ops.gather import gather_patches_many
from rav1e_tpu_torch.ops.ref.mc import SUBPEL_FILTERS
from rav1e_tpu_torch.ops.ref.quant import ac_q as ac_q_lut
from rav1e_tpu_torch.ops.ref.quant import chroma_dq
from rav1e_tpu_torch.ops.ref.quant import dc_q as dc_q_lut

PAD = 32          # ref padding: search 16 + subpel drift + filter taps
SEARCH = 16       # full-pel search radius (px)
HDR_BYTES = 35    # per-block control record (mv/flags/choice/sub8)
SL_LEN = 1536     # scan-line length per block (y 1024 + u/v 256)


def _unreachable(what: str):
    raise NotImplementedError(
        f"{what}: the reference's device steps do not code it either "
        "(ROADMAP.md section 3, not reachable in the reference)")


def _check_bit_depth(bd: int):
    """8 and 10 bits run; the reference codes 12 bits only on its numpy
    pipelines (pipeline/intra.py, pipeline/inter.py), as the port's
    Context does."""
    if bd not in (8, 10):
        _unreachable(f"bit depth {bd} on the device steps")


# ---- tables ------------------------------------------------------------------

@lru_cache(maxsize=None)
def _filt(device: torch.device, four_tap: bool = False) -> torch.Tensor:
    """The spec's REGULAR 8-tap bank [16, 8] int32, or with four_tap its
    4-tap bank (Subpel_Filters[4], zero-padded to 8 taps)."""
    bank = SUBPEL_FILTERS["REGULAR_4" if four_tap else "REGULAR"]
    return torch.as_tensor(np.asarray(bank, np.int32), device=device)


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


def _mc_window(ref_pad, pos_r, pos_c, mv8, n, ss):
    """The gather half of batched sub-pel prediction (the reference's
    _mc_batch). ref_pad int32 padded by PAD>>ss with edge replication;
    pos_r/pos_c int32 [B] plane-scale block origins; mv8 int32 [B, 2]
    luma-scale 1/8-pel MVs; n = block size. Returns each block's
    (n+7)^2 window as a gather_patches_many item (ref_pad, r0, c0, n + 7),
    and the blocks' sub-pel phases (fr, fc)."""
    p = PAD >> ss
    p16r = (pos_r << 4) + mv8[:, 0] * (2 >> ss)
    p16c = (pos_c << 4) + mv8[:, 1] * (2 >> ss)
    ir, fr = p16r >> 4, p16r & 15
    ic, fc = p16c >> 4, p16c & 15
    return (ref_pad, ir + (p - 3), ic + (p - 3), n + 7), fr, fc


def _mc_filter(patch, fr, fc, n, four_tap=False, bd: int = 8,
               interm=False):
    """The filter half of batched sub-pel prediction: the separable 8-tap
    filter (four_tap: the spec's 4-tap bank, for blocks of w/h <= 4: the
    4x4 chroma of 16->8 children, predicted here as one region that
    shares the MV) of each block's window at its phases, in int32.
    interm keeps compound intermediate precision (spec 7.11.3.1
    isCompound: InterRound1 = 7, unclipped) for _comp_avg. Returns
    [B, n, n]."""
    bank = _filt(patch.device, four_tap)
    intm = _round2(_taps(bank[fc.long()], patch, n, -1), 3)
    out = _taps(bank[fr.long()], intm, n, -2)
    if interm:
        return _round2(out, 7)
    return torch.clamp(_round2(out, 11), 0, (1 << bd) - 1)


def _comp_avg(p0, p1, bd: int = 8):
    """COMPOUND_AVERAGE of two intermediate-precision predictions
    (ops/ref/mc.py mc_predict_avg's twin): Round2(p0 + p1, 5), clipped."""
    return torch.clamp(_round2(p0 + p1, 5), 0, (1 << bd) - 1)


def _mc_windows(specs):
    """The windows of several predictions [(ref_pad, pos_r, pos_c, mv8, n,
    ss), ...] gathered in one launch: [(patch, fr, fc), ...] for
    _mc_filter."""
    wins = [_mc_window(*s) for s in specs]
    patches = gather_patches_many([w[0] for w in wins])
    return [(pt, fr, fc) for pt, (_, fr, fc) in zip(patches, wins)]


def _patch_window(ref_pad, pos_r, pos_c, mv8c, n, ss, M):
    """The gather item of _gather_patch: (ref_pad, r0, c0, n+7+2M), ir0,
    ic0."""
    p = PAD >> ss
    p16r = (pos_r << 4) + mv8c[:, 0] * (2 >> ss)
    p16c = (pos_c << 4) + mv8c[:, 1] * (2 >> ss)
    ir0, ic0 = p16r >> 4, p16c >> 4
    return ((ref_pad, ir0 + (p - 3 - M), ic0 + (p - 3 - M), n + 7 + 2 * M),
            ir0, ic0)


def _gather_patch(ref_pad, pos_r, pos_c, mv8c, n, ss, M):
    """ONE patch per block: an (n+7+2M)^2 window around the centre MV,
    from which every descent candidate within ±M px evaluates.
    Returns (patch [B, n+7+2M, n+7+2M], ir0, ic0) with patch[b, 0, 0]
    = ref row (ir0 - 3 - M), col (ic0 - 3 - M)."""
    item, ir0, ic0 = _patch_window(ref_pad, pos_r, pos_c, mv8c, n, ss, M)
    return gather_patches_many([item])[0], ir0, ic0


def _mc_patch(patch, ir0, ic0, pos_r, pos_c, mv8, n, ss, M,
              interm=False, bd: int = 8):
    """Subpel prediction from pre-gathered patches (bit-exact twin of
    _mc_window + _mc_filter): the whole-pixel drift vs the patch centre (<= M) folds
    into an extended (8+2M)-tap filter with the 8 spec taps placed at
    the drift offset. Accepts extra leading batch dims shared across
    the array arguments (mv8 [..., 2], pos/ir0 broadcastable). interm:
    compound intermediate precision, as _mc_filter's."""
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
    if interm:
        return _round2(out, 7)
    return torch.clamp(_round2(out, 11), 0, (1 << bd) - 1)


def _mc_patch_multi(patch, ir0, ic0, pos_r, pos_c, mv8c, n, ss, M,
                    bd: int = 8):
    """_mc_patch for C candidate MVs [C, B, 2] sharing one patch set.
    Returns [C, B, n, n] int32."""
    return _mc_patch(patch[None], ir0[None], ic0[None], pos_r[None],
                     pos_c[None], mv8c, n, ss, M, bd=bd)


def _wht8(x, dim: int):
    """The 8-point Walsh-Hadamard transform (Sylvester order) of x along
    `dim`, in exact int32 butterflies."""
    x = x.movedim(dim, -1)
    shape = x.shape
    for h in (4, 2, 1):
        y = x.reshape(shape[:-1] + (8 // (2 * h), 2, h))
        x = torch.stack([y[..., 0, :] + y[..., 1, :],
                         y[..., 0, :] - y[..., 1, :]], -2).reshape(shape)
    return x.movedim(-1, dim)


def satd(d):
    """SAD-normalised SATD over 8x8 Hadamard tiles (the reference's
    `satd`): [B, n, n] int32 residual -> [B] f32. The reference sums the
    f32 |H x H| over the block. H H^T = 8 I, so a tile's outputs t have
    sum t^2 = 64 sum d^2 and sum |t| <= 8 sqrt(sum t^2) <= 512 max |d|;
    a 32-block's 16 tiles total at most 8,192 max |d|: 2,088,960 at 8
    bits and 8,380,416 at 10 (|d| <= 1023), both below 2^24. Every
    partial sum is then an exact f32 integer, and the int32 sum cast once
    to f32 is the reference's value in any order
    (tests/test_torch_hbd.py holds the bound)."""
    B, n, _ = d.shape
    x = (d.reshape(B, n // 8, 8, n // 8, 8).permute(0, 1, 3, 2, 4)
         .to(torch.int32))
    t = _wht8(_wht8(x, -2), -1)
    tot = torch.sum(torch.abs(t).reshape(B, -1), dim=1, dtype=torch.int32)
    return tot.to(torch.float32) * 0.125


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


def _bf16_corr(b_bf, w2):
    """M = einsum("brc,bRdc->brRd", b_bf, w2) of bf16-rounded f32 operands
    in XLA:CPU's order for the reference's bf16 dot with f32 results: two
    running f32 sums over c, the even c's and the odd c's, added at the
    end. Each product is exact in f32 (8-bit mantissas), so this order
    decides only where a partial sum passes 2^24 (above 8 bits), or where
    the half-resolution stage's quarter-pel means mix fine and coarse
    terms. Matched against the reference's einsum at a 16-px search's
    shapes (tests/test_torch_hbd.py); the half-resolution stage of an
    8-px search sums in an order not yet matched (ROADMAP.md section
    3)."""
    n = b_bf.shape[-1]
    lanes = []
    for c0 in (0, 1):
        acc = torch.zeros(b_bf.shape[:2] + w2.shape[1:3],
                          dtype=torch.float32, device=b_bf.device)
        for c in range(c0, n, 2):
            acc = acc + b_bf[:, :, None, None, c] * w2[:, None, :, :, c]
        lanes.append(acc)
    return lanes[0] + lanes[1]


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
    every candidate predicted from the one patch. use_satd ranks the
    descent's candidates by SATD + lam_sad x MV bits (speed 6) instead
    of SSE + lam x MV bits."""
    return _search_refs([ryp], blks, by, bx, rd, B, use_satd, search,
                        subpel, bd, ds2)[0]


def _search_refs(refs, blks, by, bx, rd, B, use_satd=False,
                 search: int = SEARCH, subpel: bool = True, bd: int = 8,
                 ds2: bool = True):
    """_search_one_ref against each padded reference plane of `refs`, the
    descent patches of all of them gathered in one launch. Returns
    [_search_one_ref's 5-tuple, ...]."""
    full = [_search_fullpel(r, blks, by, bx, rd, B, search, subpel, ds2, bd)
            for r in refs]
    if not full[0][2]:
        return [(mv_fp * 8, None, None, None, grid_fn)
                for mv_fp, grid_fn, _, _ in full]
    items = [_patch_window(r, by, bx, mv_fp * 8, 32, 0, M)
             for r, (mv_fp, _, _, M) in zip(refs, full)]
    patches = gather_patches_many([it[0] for it in items])
    return [(_descend(patch, ir0, ic0, mv_fp, blks, by, bx, rd, B, steps, M,
                      use_satd, bd), patch, ir0, ic0, grid_fn)
            for patch, (_, ir0, ic0), (mv_fp, grid_fn, steps, M)
            in zip(patches, items, full)]


def _search_fullpel(ryp, blks, by, bx, rd, B, search: int = SEARCH,
                    subpel: bool = True, ds2: bool = True, bd: int = 8):
    """The full-pel stage of _search_one_ref. Returns (mv_fp [B, 2]
    full-pel, grid_fn, the descent's steps in eighth-pel, the descent
    patches' margin M)."""
    assert search <= PAD, (search, PAD)
    dev = ryp.device
    nby_l = ryp.shape[0] // 32 - 2                # h // 32
    nbx_l = ryp.shape[1] // 32 - 2
    # a tile shard's blocks (parallel/tile_encode.py) are a column slice
    # of the full-frame reference's grid, at by/bx; the reference takes
    # the exact full-resolution surface there
    tiled = B != nby_l * nbx_l
    use_ds2 = (ds2 and not tiled and B >= 510 and search % 2 == 0
               and search >= 4)

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
    # Operands round to bf16 as the reference's, and the products of
    # bf16 values are exact in f32. At 8 bits their sums over c are
    # exact too, so torch's product order cannot change M; above 8 bits
    # they pass 2^24 and M takes the reference's order (_bf16_corr). The
    # sum over r runs in the reference's order.
    def ssd_surface(wins, wsq, bcomp, n, S):
        S1 = 2 * S + 1
        w_bf = wins.to(torch.bfloat16).to(torch.float32)
        b_bf = bcomp.to(torch.bfloat16).to(torch.float32)
        w2 = torch.stack([w_bf[:, :, dx: dx + n] for dx in range(S1)], 2)
        m = (torch.einsum("brc,bRdc->brRd", b_bf, w2) if bd == 8
             else _bf16_corr(b_bf, w2))
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
        if not tiled:
            wins = assemble_windows(ryp.to(torch.float32), win_sz, 32, off,
                                    K)
            wsq = assemble_windows(sq_sums, 2 * search + 1, 32, off, K)
        else:
            # each block's own windows (the reference's per-block
            # dynamic_slice), both gathered in one launch; the f32 sums
            # travel as their int32 bits
            r0, c0 = by + off, bx + off
            wins, wsq = gather_patches_many(
                [(ryp, r0, c0, win_sz),
                 (sq_sums.view(torch.int32), r0, c0, 2 * search + 1)])
            wins = wins.to(torch.float32)
            wsq = wsq.view(torch.float32)
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

    return mv_fp, grid_fn, desc_steps, M


def _descend(patch32, pir0, pic0, mv_fp, blks, by, bx, rd, B, desc_steps,
             M: int, use_satd: bool = False, bd: int = 8):
    """The descent of _search_one_ref from the full-pel MVs mv_fp, every
    candidate predicted from the block's one patch (drift <= M px).
    Returns mv8 [B, 2] eighth-pel."""
    dev = blks.device
    mv8 = mv_fp * 8

    def mv_rate(mv):
        return (rd["mv_bits"][torch.abs(mv[..., 0]).long()]
                + rd["mv_bits"][torch.abs(mv[..., 1]).long()])

    def dist(d, mv):
        """[C, B, 32, 32] residuals -> [C, B] descent costs."""
        C = d.shape[0]
        if use_satd:
            return (satd(d.reshape(C * B, 32, 32)).reshape(C, B)
                    + rd["lam_sad"] * mv_rate(mv))
        df = d.to(torch.float32)
        return torch.sum(df * df, dim=(2, 3)) + rd["lam"] * mv_rate(mv)

    pred = _mc_patch(patch32, pir0, pic0, by, bx, mv8, 32, 0, M, bd=bd)
    best = dist((pred - blks)[None], mv8[None])[0]
    for step_sz in desc_steps:
        delta = torch.tensor([[-step_sz, 0], [step_sz, 0], [0, -step_sz],
                              [0, step_sz]], dtype=torch.int32, device=dev)
        cands = mv8[None] + delta[:, None, :]            # [4,B,2]
        pred = _mc_patch_multi(patch32, pir0, pic0, by, bx, cands, 32, 0,
                               M, bd=bd)
        costs = dist(pred - blks[None], cands)           # [4,B]
        k = torch.argmin(costs, dim=0)
        cbest = torch.gather(costs, 0, k[None])[0]
        cmv = torch.gather(cands, 0, k[None, :, None].expand(1, B, 2))[0]
        better = cbest < best
        mv8 = torch.where(better[:, None], cmv, mv8)
        best = torch.where(better, cbest, best)
    # zero-MV blocks stay GLOBALMV-zero
    is_zero = torch.all(mv_fp == 0, dim=1)
    return torch.where(is_zero[:, None], 0, mv8)


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


def _pick(k, xs):
    """xs[k[b]][b] for every block b: k [B] indexes the list xs of [B, ...]
    tensors."""
    out = xs[0]
    for i in range(1, len(xs)):
        sel = (k == i).reshape((-1,) + (1,) * (xs[i].dim() - 1))
        out = torch.where(sel, xs[i], out)
    return out


# ---- the P-frame body --------------------------------------------------------

def p_frame_body(y, u, v, ryp, rup, rvp, dcq, acq, cdef_prm, rd,
                 by, bx, nby, nbx, use_split: bool = True,
                 ryp2=None, rup2=None, rvp2=None, ds16=None,
                 use_satd: bool = False, refine16: bool = True,
                 fwd2: bool = False, intra_rdo: bool = False,
                 b64_rdo: bool = False,
                 search: int = SEARCH, subpel: bool = True,
                 use_split8: bool = False, bd: int = 8, mark=trace.nomark):
    """The batched P-frame encode of one frame: full-pel search (use_satd:
    the descent ranks by SATD), MV-field candidate passes, skip RD, and
    with use_split the PARTITION_SPLIT candidate (per-16 MVs, TX_16X16
    luma + TX_8X8 chroma, per-16 skip RD; with use_split8 each quad's
    16->8 split, TX_8X8 luma + TX_4X4 chroma on 4-tap chroma MC, per-8
    skip RD), then with b64_rdo the 64x64 merge (when nby and nbx are
    even) and with intra_rdo the intra-in-inter flips, then recon and
    scan lines.

    With a second padded reference ryp2/rup2/rvp2 (the two-reference step)
    both references are searched and re-judged, and each block picks
    single-fwd, single-bwd or COMPOUND_AVERAGE by RD (choice 0 / 1 / 2;
    fwd2, LAST + GOLDEN: fwd or the second reference at 2 bits more, no
    compound); mv8 is then the chosen single reference's MV (fwd for
    compound), mvb8 the second MV of a compound block. The split is then
    the cheap {parent, zero} one (refine16 is off), a zero-MV child
    predicting from the fwd reference. The two-reference 64x64 merge is
    not ported: no entry point of the reference reaches it.

    y/u/v: source planes (int32); ryp/rup/rvp: PADDED reference planes
    (int32); by/bx: int32 pixel origins of the 32-blocks; dcq/acq: luma
    quantizer 0-d int32 tensors. refine16 descends each 16's MV from the
    better of {parent, zero} in-patch (8, 4, 2, 2 eighth-pel); without it
    the 16's MV is the better of {parent, zero}. `mark(name)` is called
    after each stage (search, cand, code, split, merge64, intra). Returns
    the reference's 19-tuple; the in-loop filters run after it, in
    _core's `filt` (the reference's deblock_fn / cdef_fn have no caller
    here)."""
    two = ryp2 is not None
    if two and b64_rdo:
        raise NotImplementedError(
            "the two-reference 64x64 merge (the reference's _merge64_pass "
            "with ryp2, rav1e_tpu/pipeline/tpu_inter.py:637-660) is not "
            "ported: no entry point of the reference reaches it "
            "(ROADMAP.md section 3)")
    from rav1e_tpu_torch.pipeline.tpu_intra import _dq_dyn, _q_dyn, block_bits
    h, tw = y.shape[0], y.shape[1]
    B = nby * nbx
    mx = (1 << bd) - 1
    dev = y.device
    blks = to_blocks(y, 32)                       # [B,32,32]
    if ds16 is None:
        ds16 = torch.ones((B, 4), dtype=torch.float32, device=dev)
    ds32 = torch.mean(ds16, dim=1)                # [B]
    refs = [(ryp, rup, rvp)] + ([(ryp2, rup2, rvp2)] if two else [])
    searched = _search_refs([r[0] for r in refs], blks, by, bx, rd, B,
                            use_satd, search, subpel, bd=bd)
    mvs = [s[0] for s in searched]
    grids = [s[4] for s in searched]
    mark("search")

    ub = to_blocks(u.to(torch.int32), 16)
    vb = to_blocks(v.to(torch.int32), 16)
    lam = rd["lam"]
    i32 = torch.int32

    def cand_set(mv8, extra=None, grid_fn=None):
        """Left / above / zero / median MV candidates priced with
        NEIGHBOUR-RELATIVE rates (NEAREST alias when the MV matches the
        stack predictor); grid_fn preselects one alternative on the SSD
        surface, so the exact re-judge runs on {own, best-alt, extra}
        only. Returns (candidate MV fields, their rates [C, B])."""
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
            cands = [mv8, _pick(ka, cands[1:])]
            rates = [rates[0], torch.gather(alt_r, 0, ka[None])[0]]
        if extra is not None:
            cands.append(extra)
            rates.append(rate_rel(extra, mvl))
        return cands, torch.stack(rates, 0)               # [C,B]

    def cand_pick(cands, cand_r, sses):
        """The candidate each block takes (own wins ties), its MV and its
        rate."""
        cc = ds32[None] * torch.stack(sses, 0) + lam * cand_r
        k = torch.argmin(cc, dim=0)
        return k, _pick(k, cands), torch.gather(cand_r, 0, k[None])[0]

    def rejudge(extras):
        """The exact re-judge of each reference's MV field (with its
        long-range candidate): the candidates' windows of every reference
        in one gather launch. Returns per reference (MVs, rates, the chosen
        candidates' luma predictions, their windows)."""
        sets = [cand_set(mv, ex, gf) for mv, ex, gf in zip(mvs, extras,
                                                          grids)]
        wins = _mc_windows([(r[0], by, bx, c, 32, 0)
                            for r, (cands, _) in zip(refs, sets)
                            for c in cands])
        out = []
        for cands, cand_r in sets:
            w, wins = wins[:len(cands)], wins[len(cands):]
            preds = [_mc_filter(*x, 32, bd=bd) for x in w]
            if two:
                # the two-reference step's re-judge sums as XLA:CPU does
                # there (rows on 8 lanes); the one-reference step's stays
                # below 2^24 on real content
                sses = _sse_cols_xla(torch.cat(preds),
                                     blks.repeat(len(preds), 1, 1)
                                     ).split(B)
            else:
                sses = [torch.sum((p - blks).to(torch.float32) ** 2,
                                  dim=(1, 2)) for p in preds]
            k, mv, rate = cand_pick(cands, cand_r, sses)
            out.append((mv, rate, _pick(k, preds),
                        tuple(_pick(k, [x[j] for x in w])
                              for j in range(3))))
        return out

    # blob erosion on the SSD surface, then the long-range rescue and
    # one exact re-judge, each reference's field on its own
    def grid_pass(mv8, grid_fn):
        cands, cand_r = cand_set(mv8)
        return cand_pick(cands, cand_r, [grid_fn(c) for c in cands])[1]

    for _ in range(8):
        mvs = [grid_pass(mv, gf) for mv, gf in zip(mvs, grids)]
    mv_coarse = [_coarse_mv(y, r[0], B, search) for r in refs]
    judged = rejudge(mv_coarse)
    # the chroma windows, both references' in one launch; they also serve
    # the 4-tap chroma of the 16->8 split and compound's second filter
    cwin = _mc_windows([(r[k], by // 2, bx // 2, j[0], 16, 1)
                        for r, j in zip(refs, judged) for k in (1, 2)])
    preds_c = [_mc_filter(*w, 16, bd=bd) for w in cwin]
    mv8, rate32, pred_y, _ = judged[0]
    win_u, win_v = cwin[:2]
    pred_u, pred_v = preds_c[:2]
    choice = torch.zeros((B,), dtype=i32, device=dev)
    mvb8 = torch.zeros_like(mv8)
    if two:
        (choice, mv8, mvb8, pred_y, pred_u, pred_v) = _choose_ref(
            judged, cwin, preds_c, blks, ds32, lam, fwd2, bd)
        rate32 = None
        if use_split8:
            # the parent's 4-tap chroma is the fwd reference's at the
            # chosen MV, as the reference predicts it
            win_u, win_v = _mc_windows([(rup, by // 2, bx // 2, mv8, 16, 1),
                                        (rvp, by // 2, bx // 2, mv8, 16, 1)])
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

    def sse(a, b):
        return torch.sum((a - b).to(torch.float32) ** 2, dim=(1, 2))

    def code_skip(preds, srcs, txs, lv_luts, ds):
        """Code the residual of each plane, then skip as an RD decision:
        sse(recon) + λ(skip0 + coeff bits) vs sse(pred) + λ·skip1.
        Returns (levels, recons, skip, the chosen RD cost)."""
        lvs, cds = [], []
        for k, (p, s_, tx) in enumerate(zip(preds, srcs, txs)):
            lv, r2 = code(s_ - p, tx, chroma=k > 0)
            lvs.append(lv)
            cds.append(torch.clamp(p + r2, 0, mx))
        sse_c = sse(cds[0], srcs[0]) + sse(cds[1], srcs[1]) \
            + sse(cds[2], srcs[2])
        sse_s = sse(preds[0], srcs[0]) + sse(preds[1], srcs[1]) \
            + sse(preds[2], srcs[2])
        cbits = (block_bits(lvs[0], rd[lv_luts[0]])
                 + block_bits(lvs[1], rd[lv_luts[1]])
                 + block_bits(lvs[2], rd[lv_luts[1]]))
        c_skip = ds * sse_s + lam * rd["skip1"]
        c_code = ds * sse_c + lam * (rd["skip0"] + cbits)
        skip = c_skip <= c_code
        sk3 = skip[:, None, None]
        return ([torch.where(sk3, 0, lv) for lv in lvs],
                [torch.where(sk3, p, c) for p, c in zip(preds, cds)],
                skip, torch.where(skip, c_skip, c_code))

    (lv_y, lv_u, lv_v), (rec_y, rec_u, rec_v), skip, c32 = code_skip(
        (pred_y, pred_u, pred_v), (blks, ub, vb),
        (TxSize.TX_32X32, TxSize.TX_16X16, TxSize.TX_16X16), ("y32", "c16"),
        ds32)
    mark("code")

    def mv_bits(mv):
        # jnp clamps an index past the table; torch would raise
        a = torch.clamp(torch.abs(mv), max=rd["mv_bits"].shape[0] - 1).long()
        return rd["mv_bits"][a[..., 0]] + rd["mv_bits"][a[..., 1]]

    def mv_rate(mv):
        zero = (mv[..., 0] == 0) & (mv[..., 1] == 0)
        return torch.where(zero, rd["globalmv"], mv_bits(mv) + rd["newmv"])

    # a two-reference block's 32-level rate: its primary MV from zero
    cost32 = lam * (mv_rate(mv8) if rate32 is None else rate32) + c32

    if not use_split:
        split = torch.zeros((B,), dtype=torch.bool, device=dev)
        skip16_out = skip[:, None].expand(B, 4)
        b64_map = None
        if b64_rdo and nby % 2 == 0 and nbx % 2 == 0:
            # the merge on the 32-level costs, as the reference's
            (b64_map, _, mv8, rec_y, rec_u, rec_v, lv_y, lv_u, lv_v, skip,
             split, skip16_out, choice, mvb8) = _merge64_pass(
                y, u, v, ryp, rup, rvp, rd, code, nby, nbx, mv8, rec_y,
                rec_u, rec_v, lv_y, lv_u, lv_v, skip, split, skip16_out,
                choice, mvb8, cost32, bd=bd)
            mark("merge64")
        zeros = functools.partial(torch.zeros, dtype=i32, device=dev)
        return _finish_outputs(
            y, h, tw, nby, nbx, B, mv8, skip, split,
            mv8[:, None, :].expand(B, 4, 2), skip16_out,
            lv_y, lv_u, lv_v, zeros((B * 4, 16, 16)), zeros((B * 4, 8, 8)),
            zeros((B * 4, 8, 8)), rec_y, rec_u, rec_v, choice, mvb8,
            b64_map=b64_map, bd=bd)

    # ---- the PARTITION_SPLIT candidate: per-16 MVs, TX16/TX8
    # residuals, per-16 skip RD ----
    offs_r = torch.tensor([0, 0, 16, 16], dtype=i32, device=dev)
    offs_c = torch.tensor([0, 16, 0, 16], dtype=i32, device=dev)
    by16 = (by[:, None] + offs_r[None, :]).reshape(-1)
    bx16 = (bx[:, None] + offs_c[None, :]).reshape(-1)
    blks16 = _quads(blks, 16)
    ub8 = _quads(ub, 8)
    vb8 = _quads(vb, 8)
    ds16f = ds16.reshape(B * 4)
    mv_par = mv8.repeat_interleave(4, 0)
    mv_zero = torch.zeros_like(mv_par)


    def cost16_pred(pred, mv):
        return ds16f * sse(pred, blks16) + lam * mv_bits(mv)

    # two references take the cheap split: the refined per-16 descent
    # predicts from the fwd reference alone
    if refine16 and not two:
        # two patch gathers (parent- and zero-centred) in one launch, then
        # the whole per-16 descent runs in-patch: drift <= 8+4+2+2
        # eighth-pel = 2 px
        (item_p, pir_p, pic_p), (item_z, pir_z, pic_z) = (
            _patch_window(ryp, by16, bx16, m, 16, 0, 2)
            for m in (mv_par, mv_zero))
        patch_p, patch_z = gather_patches_many([item_p, item_z])

        def pred16(patch, ir0, ic0, mv):
            return _mc_patch(patch, ir0, ic0, by16, bx16, mv, 16, 0, 2,
                             bd=bd)

        best_par = cost16_pred(pred16(patch_p, pir_p, pic_p, mv_par), mv_par)
        zcost = cost16_pred(pred16(patch_z, pir_z, pic_z, mv_zero), mv_zero)
        zbet = zcost < best_par
        mv16 = torch.where(zbet[:, None], 0, mv_par)
        best16 = torch.minimum(best_par, zcost)
        patch16 = torch.where(zbet[:, None, None], patch_z, patch_p)
        pir16 = torch.where(zbet, pir_z, pir_p)
        pic16 = torch.where(zbet, pic_z, pic_p)
        for step_sz in (8, 4, 2, 2):
            delta = torch.tensor([[-step_sz, 0], [step_sz, 0],
                                  [0, -step_sz], [0, step_sz]], dtype=i32,
                                 device=dev)
            cands = mv16[None] + delta[:, None, :]          # [4, 4B, 2]
            costs = torch.stack([cost16_pred(
                pred16(patch16, pir16, pic16, c), c) for c in cands], 0)
            k = torch.argmin(costs, dim=0)
            cbest = torch.gather(costs, 0, k[None])[0]
            cmv = torch.gather(cands, 0, k[None, :, None].expand(1, -1,
                                                                 2))[0]
            better = cbest < best16
            mv16 = torch.where(better[:, None], cmv, mv16)
            best16 = torch.where(better, cbest, best16)
        pred_y16 = pred16(patch16, pir16, pic16, mv16)
        win_u8, win_v8 = _mc_windows([
            (rup, by16 // 2, bx16 // 2, mv16, 8, 1),
            (rvp, by16 // 2, bx16 // 2, mv16, 8, 1)])
        pred_u8 = _mc_filter(*win_u8, 8, bd=bd)
        pred_v8 = _mc_filter(*win_v8, 8, bd=bd)
        if use_split8:
            # the 16->8 children's 4x4 chroma: the 4-tap bank over the
            # 8x8 region, which shares the quad's MV and its windows
            pred_u8_4t = _mc_filter(*win_u8, 8, four_tap=True, bd=bd)
            pred_v8_4t = _mc_filter(*win_v8, 8, four_tap=True, bd=bd)
    else:
        # per-16 MV in {parent, zero}: parent = the quadrant of the
        # 32-block's prediction, zero = the co-located reference block
        hF, wF = ryp.shape[0] - 2 * PAD, ryp.shape[1] - 2 * PAD
        p2 = PAD // 2
        idx16 = ((by16 // 16) * (wF // 16) + bx16 // 16).long()
        pz_y = to_blocks(ryp[PAD:PAD + hF, PAD:PAD + wF], 16)[idx16]
        pz_u = to_blocks(rup[p2:p2 + hF // 2, p2:p2 + wF // 2], 8)[idx16]
        pz_v = to_blocks(rvp[p2:p2 + hF // 2, p2:p2 + wF // 2], 8)[idx16]
        zbet = (cost16_pred(pz_y, mv_zero)
                < cost16_pred(_quads(pred_y, 16), mv_par))
        if two:
            # a zero-MV child decodes as single-fwd GLOBALMV: a non-fwd
            # parent with a zero MV would read the same in the packed
            # stream, so its quads take the zero child
            zbet = zbet | ((mv_par[:, 0] == 0) & (mv_par[:, 1] == 0)
                           & (choice.repeat_interleave(4) != 0))
        mv16 = torch.where(zbet[:, None], 0, mv_par)
        z3 = zbet[:, None, None]
        pred_y16 = torch.where(z3, pz_y, _quads(pred_y, 16))
        pred_u8 = torch.where(z3, pz_u, _quads(pred_u, 8))
        pred_v8 = torch.where(z3, pz_v, _quads(pred_v, 8))
        if use_split8:
            # the parent 32-block's chroma (its windows) through the 4-tap
            # bank, quartered; the zero MV is an integer phase, the same
            # in both banks
            pred_u8_4t = torch.where(z3, pz_u, _quads(_mc_filter(
                *win_u, 16, four_tap=True, bd=bd), 8))
            pred_v8_4t = torch.where(z3, pz_v, _quads(_mc_filter(
                *win_v, 16, four_tap=True, bd=bd), 8))
    (lv_y16, lv_u8, lv_v8), (rec_y16, rec_u8, rec_v8), skip16, c16 = \
        code_skip((pred_y16, pred_u8, pred_v8), (blks16, ub8, vb8),
                  (TxSize.TX_16X16, TxSize.TX_8X8, TxSize.TX_8X8),
                  ("y16", "c8"), ds16f)
    cost16 = lam * mv_rate(mv16) + c16

    # ---- the 16->8 split: four 8x8 children per quad on the quad's MV
    # (NEAREST aliases), TX_8X8 luma + TX_4X4 chroma, per-8 skip RD ----
    split16 = torch.zeros((B, 4), dtype=torch.bool, device=dev)
    skip8_out = torch.zeros((B, 4, 4), dtype=torch.bool, device=dev)
    lv_y8 = lv_u4 = lv_v4 = None
    if use_split8:
        ds8 = ds16f.repeat_interleave(4)
        (lv_y8, lv_u4, lv_v4), (rec_y8, rec_u4, rec_v4), skip8, c8 = \
            code_skip((_quads(pred_y16, 8), _quads(pred_u8_4t, 4),
                       _quads(pred_v8_4t, 4)),
                      (_quads(blks16, 8), _quads(ub8, 4), _quads(vb8, 4)),
                      (TxSize.TX_8X8, TxSize.TX_4X4, TxSize.TX_4X4),
                      ("y8", "c4"), ds8)
        cost8 = lam * rd["nearest"] + c8
        c_s16 = (_quad_sum(cost8.reshape(B * 4, 4))
                 + lam * rd["split_bits8"])
        s16f = c_s16 < cost16
        cost16 = torch.where(s16f, c_s16, cost16)
        s16q = s16f[:, None, None]
        lv_y16 = torch.where(s16q, _unquads(lv_y8, 8), lv_y16)
        lv_u8 = torch.where(s16q, _unquads(lv_u4, 4), lv_u8)
        lv_v8 = torch.where(s16q, _unquads(lv_v4, 4), lv_v8)
        rec_y16 = torch.where(s16q, _unquads(rec_y8, 8), rec_y16)
        rec_u8 = torch.where(s16q, _unquads(rec_u4, 4), rec_u8)
        rec_v8 = torch.where(s16q, _unquads(rec_v4, 4), rec_v8)
        # a split quad reports skip16 = AND of its children (the exact
        # per-8 skips travel in skip8_out)
        skip16 = torch.where(s16f, torch.all(skip8.reshape(B * 4, 4), 1),
                             skip16)
        split16 = s16f.reshape(B, 4)
        skip8_out = skip8.reshape(B, 4, 4)

    cost_split = _quad_sum(cost16.reshape(B, 4)) + lam * rd["split_bits"]
    split = cost_split < cost32
    sp3 = split[:, None, None]

    # ---- choose + assemble ----
    lv_y = torch.where(sp3, _unquads(lv_y16, 16), lv_y)
    lv_u = torch.where(sp3, _unquads(lv_u8, 8), lv_u)
    lv_v = torch.where(sp3, _unquads(lv_v8, 8), lv_v)
    rec_y = torch.where(sp3, _unquads(rec_y16, 16), rec_y)
    rec_u = torch.where(sp3, _unquads(rec_u8, 8), rec_u)
    rec_v = torch.where(sp3, _unquads(rec_v8, 8), rec_v)
    mv16_out = torch.where(sp3, mv16.reshape(B, 4, 2),
                           mv8[:, None, :].expand(B, 4, 2))
    skip16_out = torch.where(split[:, None], skip16.reshape(B, 4),
                             skip[:, None])
    cost_fin = torch.where(split, cost_split, cost32)
    mark("split")

    b64_map = torch.zeros(((nby + 1) // 2, (nbx + 1) // 2), dtype=torch.bool,
                          device=dev)
    b64g = torch.zeros((B,), dtype=torch.bool, device=dev)
    if b64_rdo and nby % 2 == 0 and nbx % 2 == 0:
        (b64_map, b64g, mv8, rec_y, rec_u, rec_v, lv_y, lv_u, lv_v, skip,
         split, skip16_out, choice, mvb8) = _merge64_pass(
            y, u, v, ryp, rup, rvp, rd, code, nby, nbx, mv8, rec_y, rec_u,
            rec_v, lv_y, lv_u, lv_v, skip, split, skip16_out, choice, mvb8,
            cost_fin, bd=bd)
        mark("merge64")

    if intra_rdo:
        (rec_y, rec_u, rec_v, lv_y, lv_u, lv_v, skip, split, skip16_out,
         choice, mv8) = _intra_pass(
            blks, ub, vb, rd, code, nby, nbx, ds32, cost_fin, b64g, rec_y,
            rec_u, rec_v, lv_y, lv_u, lv_v, skip, split, skip16_out, choice,
            mv8, bd=bd)
        mark("intra")

    # the merge and the intra flips may clear `split` under a quad that
    # wanted its 16->8 split: re-mask so the coded tree stays valid
    split16 = split16 & split[:, None]
    skip8_out = skip8_out & split16[:, :, None]
    return _finish_outputs(
        y, h, tw, nby, nbx, B, mv8, skip, split, mv16_out, skip16_out, lv_y,
        lv_u, lv_v, lv_y16, lv_u8, lv_v8, rec_y, rec_u, rec_v, choice, mvb8,
        b64_map=b64_map, split16=split16 if use_split8 else None,
        skip8_out=skip8_out, lv_y8=lv_y8, lv_u4=lv_u4, lv_v4=lv_v4, bd=bd)


def _choose_ref(judged, cwin, preds_c, blks, ds32, lam, fwd2: bool,
                bd: int = 8):
    """The two-reference step's choice per 32-block (the reference's
    p_frame_body, ryp2 branch): single-fwd (0), single-bwd (1, 4 bits
    more: a minority reference codes against an empty stack) or
    COMPOUND_AVERAGE (2, both MV rates and 2 bits), the first of equal
    costs; fwd2 (LAST + GOLDEN) chooses between the two single
    references, the second at 2 bits more. judged: each reference's (MVs,
    rate, luma prediction, luma window) from the re-judge; cwin / preds_c:
    the U, V windows and predictions of fwd then bwd at those MVs. The
    compound predictions filter the same windows again at intermediate
    precision. Returns (choice, mv8: the single reference's MV, fwd for
    compound; mvb8: the second MV of compound blocks; pred_y, pred_u,
    pred_v)."""
    (mvf, rate_f, pf_y, wf_y), (mvb, rate_b, pb_y, wb_y) = judged
    B = blks.shape[0]
    # pf and pb sum as XLA:CPU's fused cost loop sums them: chunks 0, 2,
    # 3, 1 in the B step, in order with fwd2
    sse_fb = (_sse_cols_xla if fwd2 else _sse_cols_b_xla)(
        torch.cat([pf_y, pb_y]), blks.repeat(2, 1, 1))
    cost_f = ds32 * sse_fb[:B] + lam * rate_f
    pf_u, pf_v, pb_u, pb_v = preds_c
    if fwd2:
        cost_b = ds32 * sse_fb[B:] + lam * (rate_b + 2.0)
        costs = [cost_f, cost_b]
        pc_y, pc_u, pc_v = pf_y, pf_u, pf_v
    else:
        pc_y, pc_u, pc_v = (
            _comp_avg(_mc_filter(*wf, n, bd=bd, interm=True),
                      _mc_filter(*wb, n, bd=bd, interm=True), bd)
            for wf, wb, n in ((wf_y, wb_y, 32), (cwin[0], cwin[2], 16),
                              (cwin[1], cwin[3], 16)))
        cost_b = ds32 * sse_fb[B:] + lam * (rate_b + 4.0)
        cost_c = (ds32 * _sse_cols_xla(pc_y, blks)
                  + lam * (rate_f + rate_b + 2.0))
        costs = [cost_f, cost_b, cost_c]
    choice = torch.argmin(torch.stack(costs, 1), dim=1).to(torch.int32)
    preds = [_pick(choice, list(p)) for p in ((pf_y, pb_y, pc_y),
                                              (pf_u, pb_u, pc_u),
                                              (pf_v, pb_v, pc_v))]
    mvb8 = torch.where((choice == 2)[:, None], mvb, 0)
    mv8 = torch.where((choice == 1)[:, None], mvb, mvf)
    return (choice, mv8, mvb8, *preds)


def _merge64_pass(y, u, v, ryp, rup, rvp, rd, code, nby, nbx, mv8, rec_y,
                  rec_u, rec_v, lv_y, lv_u, lv_v, skip, split, skip16_out,
                  choice, mvb8, cost_fin, bd: int = 8):
    """PARTITION_NONE at 64x64 (the reference's _merge64_pass, single
    reference): one MV per SB from {the TL child's MV, zero}, TX_64X64
    luma (its 32x32 retained levels) and TX_32X32 chroma with a skip RD,
    against the four 32-level costs. Returns the updated per-32 outputs
    with (b64_map, b64g)."""
    from rav1e_tpu_torch.pipeline.tpu_intra import block_bits
    mx = (1 << bd) - 1
    lam = rd["lam"]
    dev = y.device
    B = nby * nbx
    nr64, nc64 = nby // 2, nbx // 2
    B64n = nr64 * nc64
    by64, bx64 = (o * 2 for o in _block_origins(nr64, nc64, dev))
    blks64 = to_blocks(y, 64)
    ub32 = to_blocks(u.to(torch.int32), 32)
    vb32 = to_blocks(v.to(torch.int32), 32)
    mv_tl = mv8.reshape(nby, nbx, 2)[0::2, 0::2].reshape(B64n, 2)
    zero = torch.zeros_like(mv_tl)
    # the merged block's MV-stack predictor: the left SB's TL MV
    mvtl_g = mv_tl.reshape(nr64, nc64, 2)
    pred64 = torch.cat([mvtl_g[:, :1], mvtl_g[:, :-1]], 1).reshape(B64n, 2)

    def mvr64(mv):
        z = (mv[:, 0] == 0) & (mv[:, 1] == 0)
        d0 = torch.clamp(torch.abs(mv[:, 0] - pred64[:, 0]), max=1024)
        d1 = torch.clamp(torch.abs(mv[:, 1] - pred64[:, 1]), max=1024)
        same = (d0 == 0) & (d1 == 0) & ~z
        r = rd["newmv"] + rd["mv_bits"][d0.long()] + rd["mv_bits"][d1.long()]
        r = torch.where(same, rd["nearest"], r)
        return torch.where(z, rd["globalmv"], r)

    preds = [_mc_filter(*w, 64, bd=bd) for w in _mc_windows(
        [(ryp, by64, bx64, m, 64, 0) for m in (mv_tl, zero)])]
    costs = torch.stack([_sse64_xla(p, blks64) + lam * mvr64(m)
                         for p, m in zip(preds, (mv_tl, zero))], 0)
    k1 = torch.argmin(costs, dim=0) == 1
    mv64 = torch.where(k1[:, None], zero, mv_tl)
    pred_y64 = torch.where(k1[:, None, None], preds[1], preds[0])
    # mv64 follows the luma costs: the chroma windows are a second launch
    win_u, win_v = _mc_windows([(rup, by64 // 2, bx64 // 2, mv64, 32, 1),
                                (rvp, by64 // 2, bx64 // 2, mv64, 32, 1)])
    pred_u64 = _mc_filter(*win_u, 32, bd=bd)
    pred_v64 = _mc_filter(*win_v, 32, bd=bd)
    lv_y64, r2_y64 = code(blks64 - pred_y64, TxSize.TX_64X64)
    lv_u32, r2_u32 = code(ub32 - pred_u64, TxSize.TX_32X32, chroma=True)
    lv_v32, r2_v32 = code(vb32 - pred_v64, TxSize.TX_32X32, chroma=True)
    cd_y64 = torch.clamp(pred_y64 + r2_y64, 0, mx)
    cd_u32 = torch.clamp(pred_u64 + r2_u32, 0, mx)
    cd_v32 = torch.clamp(pred_v64 + r2_v32, 0, mx)
    sse64_c = (_sse64_xla(cd_y64, blks64) + _sse_cols_xla(cd_u32, ub32)
               + _sse_cols_xla(cd_v32, vb32))
    sse64_s = (_sse64_xla(pred_y64, blks64) + _sse_cols_xla(pred_u64, ub32)
               + _sse_cols_xla(pred_v64, vb32))
    # TX_64X64 codes only its low-frequency 32x32 (zeroed beyond)
    lv64r = lv_y64[:, :32, :32]
    cbits64 = (block_bits(lv64r, rd["y32"]) + block_bits(lv_u32, rd["c32"])
               + block_bits(lv_v32, rd["c32"]))
    c_skip = sse64_s + lam * rd["skip1"]
    c_code = sse64_c + lam * (rd["skip0"] + cbits64)
    skip64 = c_skip <= c_code
    cost64 = (lam * (mvr64(mv64) - rd["merge_save"])
              + torch.where(skip64, c_skip, c_code))
    # the four 32-costs as XLA:CPU sums them: (TL + TR) + (BL + BR)
    cf = cost_fin.reshape(nr64, 2, nc64, 2)
    cf22 = ((cf[:, 0, :, 0] + cf[:, 0, :, 1])
            + (cf[:, 1, :, 0] + cf[:, 1, :, 1])).reshape(B64n)
    b64 = cost64 < cf22
    b64_map = b64.reshape(nr64, nc64)

    def quads64(x, n):
        return (x.reshape(nr64, nc64, 2, n, 2, n).permute(0, 2, 1, 4, 3, 5)
                .reshape(B, n, n))

    def up(x):
        # per-SB -> per-32 (raster)
        return (x.reshape((nr64, nc64) + x.shape[1:])
                .repeat_interleave(2, 0).repeat_interleave(2, 1)
                .reshape((B,) + x.shape[1:]))

    b64g = up(b64)
    b3 = b64g[:, None, None]
    sk3 = skip64[:, None, None]
    rec_y = torch.where(b3, quads64(torch.where(sk3, pred_y64, cd_y64), 32),
                        rec_y)
    rec_u = torch.where(b3, quads64(torch.where(sk3, pred_u64, cd_u32), 16),
                        rec_u)
    rec_v = torch.where(b3, quads64(torch.where(sk3, pred_v64, cd_v32), 16),
                        rec_v)
    # the retained luma levels ride in the SB's TL child slot
    lv64_tl = torch.zeros((nby, nbx, 32, 32), dtype=lv_y.dtype, device=dev)
    lv64_tl[0::2, 0::2] = torch.where(sk3, 0, lv64r).reshape(
        nr64, nc64, 32, 32).to(lv_y.dtype)
    lv_y = torch.where(b3, lv64_tl.reshape(B, 32, 32), lv_y)
    lv_u = torch.where(b3, quads64(torch.where(sk3, 0, lv_u32), 16), lv_u)
    lv_v = torch.where(b3, quads64(torch.where(sk3, 0, lv_v32), 16), lv_v)
    skip64g = up(skip64)
    skip = torch.where(b64g, skip64g, skip)
    split = split & ~b64g
    skip16_out = torch.where(b64g[:, None], skip64g[:, None], skip16_out)
    mv8 = torch.where(b64g[:, None], up(mv64), mv8)
    choice = torch.where(b64g, 0, choice)
    mvb8 = torch.where(b64g[:, None], 0, mvb8)
    return (b64_map, b64g, mv8, rec_y, rec_u, rec_v, lv_y, lv_u, lv_v,
            skip, split, skip16_out, choice, mvb8)


def _intra_pass(blks, ub, vb, rd, code, nby, nbx, ds32, cost_fin, b64g,
                rec_y, rec_u, rec_v, lv_y, lv_u, lv_v, skip, split,
                skip16_out, choice, mv8, bd: int = 8):
    """Intra-in-inter (the reference's intra_rdo block): DC_PRED at 32x32
    luma and 16x16 chroma from the UNFILTERED inter recon of the
    neighbours, coded with its skip RD; a block flips to intra
    (choice 3) where that is cheaper, it is not merged, and its above,
    left and above-left neighbours do not also want intra (so no flipped
    block gives edges to another). Returns the updated per-32 outputs."""
    from rav1e_tpu_torch.ops.intra import predict_modes
    from rav1e_tpu_torch.pipeline.tpu_intra import block_bits
    mx = (1 << bd) - 1
    lam = rd["lam"]
    dev = blks.device
    B = nby * nbx
    iy, jx = (o // 32 for o in _block_origins(nby, nbx, dev))
    has_a, has_l = iy > 0, jx > 0

    def dn(a):
        return torch.cat([a[:1], a[:-1]], 0)

    def rt(a):
        return torch.cat([a[:, :1], a[:, :-1]], 1)

    def pred_dc(rec, n):
        g = rec.reshape(nby, nbx, n, n)
        a = dn(g)[:, :, n - 1, :].reshape(B, n)
        le = rt(g)[:, :, :, n - 1].reshape(B, n)
        tl = rt(dn(g))[:, :, n - 1, n - 1].reshape(B)
        return predict_modes((PredictionMode.DC_PRED,), a, le, tl, has_a,
                             has_l, n, n)[0]

    pi_y, pi_u, pi_v = pred_dc(rec_y, 32), pred_dc(rec_u, 16), \
        pred_dc(rec_v, 16)
    lvi_y, r2i_y = code(blks - pi_y, TxSize.TX_32X32)
    lvi_u, r2i_u = code(ub - pi_u, TxSize.TX_16X16, chroma=True)
    lvi_v, r2i_v = code(vb - pi_v, TxSize.TX_16X16, chroma=True)
    cdi_y = torch.clamp(pi_y + r2i_y, 0, mx)
    cdi_u = torch.clamp(pi_u + r2i_u, 0, mx)
    cdi_v = torch.clamp(pi_v + r2i_v, 0, mx)
    sse_ic = (_sse_rows_xla(cdi_y, blks) + _sse_rows_xla(cdi_u, ub)
              + _sse_rows_xla(cdi_v, vb))
    sse_is = (_sse_rows_xla(pi_y, blks) + _sse_rows_xla(pi_u, ub)
              + _sse_rows_xla(pi_v, vb))
    cbits_i = (block_bits(lvi_y, rd["y32"]) + block_bits(lvi_u, rd["c16"])
               + block_bits(lvi_v, rd["c16"]))
    c_skip = ds32 * sse_is + lam * rd["skip1"]
    c_code = ds32 * sse_ic + lam * (rd["skip0"] + cbits_i)
    skip_i = c_skip <= c_code
    cost_i = lam * rd["intra32"] + torch.where(skip_i, c_skip, c_code)
    dg = ((cost_i < cost_fin) & ~b64g).reshape(nby, nbx)

    def false_dn(a):
        return torch.cat([torch.zeros_like(a[:1]), a[:-1]], 0)

    def false_rt(a):
        return torch.cat([torch.zeros_like(a[:, :1]), a[:, :-1]], 1)

    flip = (dg & ~false_dn(dg) & ~false_rt(dg)
            & ~false_rt(false_dn(dg))).reshape(B)
    f3 = flip[:, None, None]
    s_i3 = skip_i[:, None, None]
    rec_y = torch.where(f3, torch.where(s_i3, pi_y, cdi_y), rec_y)
    rec_u = torch.where(f3, torch.where(s_i3, pi_u, cdi_u), rec_u)
    rec_v = torch.where(f3, torch.where(s_i3, pi_v, cdi_v), rec_v)
    lv_y = torch.where(f3, torch.where(s_i3, 0, lvi_y), lv_y)
    lv_u = torch.where(f3, torch.where(s_i3, 0, lvi_u), lv_u)
    lv_v = torch.where(f3, torch.where(s_i3, 0, lvi_v), lv_v)
    skip = torch.where(flip, skip_i, skip)
    split = split & ~flip
    skip16_out = torch.where(flip[:, None], skip_i[:, None], skip16_out)
    choice = torch.where(flip, 3, choice)          # 3 = INTRA (DC)
    mv8 = torch.where(flip[:, None], 0, mv8)
    return (rec_y, rec_u, rec_v, lv_y, lv_u, lv_v, skip, split, skip16_out,
            choice, mv8)


def _sse64_xla(a, b):
    """The merge's luma SSE of [N, 64, 64] blocks in XLA:CPU's f32 order:
    each 32x32 quadrant summed one add at a time, row-major (the tree
    rewriter's reduce-window), then the quadrants as (TL + TR) +
    (BL + BR) (a 2-lane vector reduce). Read from the reference's fused
    loops' optimized IR (--xla_dump_to); its sums pass 2^24."""
    d = (a - b).to(torch.float32) ** 2
    n = d.shape[0]
    q = d.reshape(n, 2, 32, 2, 32).permute(0, 1, 3, 2, 4).reshape(n, 4, 1024)
    p = q[..., 0]
    for i in range(1, 1024):
        p = p + q[..., i]
    return (p[:, 0] + p[:, 1]) + (p[:, 2] + p[:, 3])


def _sse_cols_xla(a, b):
    """An SSE over [N, R, C] blocks as XLA:CPU sums the merge's chroma:
    rows in order, each vectorized over 8 lanes along the row
    (ops.cdef._xla_rows_sum)."""
    from rav1e_tpu_torch.ops.cdef import _xla_rows_sum
    return _xla_rows_sum((a - b).to(torch.float32) ** 2, 8)


def _sse_cols_b_xla(a, b):
    """An SSE over [N, R, 32] blocks as XLA:CPU sums the B step's single-
    reference luma costs (sse_of on the fwd and bwd predictions): rows in
    order, each vectorized over 8 lanes (the running total enters lane
    0), the row's four chunks of 8 added lane by lane in the order 0, 2,
    3, 1, then the lanes fold in halves (8 -> 4 -> 2 -> 1). Read from the
    fused cost loop's machine code (the reassociated FMA chain of its
    object file under --xla_dump_to; its LLVM IR shows two accumulators
    that the backend merges); the compound prediction's sum in the same
    loop takes the chunks in order (_sse_cols_xla)."""
    d = (a - b).to(torch.float32) ** 2
    n, R, C = d.shape
    s = torch.zeros((n,), dtype=torch.float32, device=d.device)
    for r in range(R):
        seg = d[:, r].reshape(n, C // 8, 8)
        acc = torch.cat([(s + seg[:, 0, 0])[:, None], seg[:, 0, 1:]], -1)
        for c in (2, 3, 1):
            acc = acc + seg[:, c]
        while acc.shape[-1] > 1:
            k = acc.shape[-1] // 2
            acc = acc[:, :k] + acc[:, k:]
        s = acc[:, 0]
    return s


def _sse_rows_xla(a, b):
    """An SSE over [N, R, C] blocks as XLA:CPU sums intra-in-inter's:
    vectorized over 8 lanes ACROSS rows (lane j takes rows j, j + 8,
    ..., each row's C terms one at a time), then the lanes fold in
    halves (8 -> 4 -> 2 -> 1). Read from the fused loop's optimized IR;
    the luma sum passes 2^24 on noise."""
    d = (a - b).to(torch.float32) ** 2
    n, R, C = d.shape
    g = d.reshape(n, R // 8, 8, C)
    acc = torch.zeros((n, 8), dtype=torch.float32, device=d.device)
    for k in range(R // 8):
        for c in range(C):
            acc = acc + g[:, k, :, c]
    while acc.shape[-1] > 1:
        h = acc.shape[-1] // 2
        acc = acc[:, :h] + acc[:, h:]
    return acc[:, 0]


def _quad_sum(c):
    """[B, 4] -> [B]: the four quads' costs added one at a time in quad
    order, the order of XLA:CPU's sum over a short f32 axis (torch.sum
    promises none)."""
    return ((c[:, 0] + c[:, 1]) + c[:, 2]) + c[:, 3]


def _quads(x, n):
    """[B, 2n, 2n] -> [4B, n, n] in (TL, TR, BL, BR) order."""
    Bn = x.shape[0]
    return (x.reshape(Bn, 2, n, 2, n).permute(0, 1, 3, 2, 4)
            .reshape(Bn * 4, n, n))


def _unquads(x, n):
    """_quads' inverse: [4B, n, n] -> [B, 2n, 2n]."""
    Bn = x.shape[0] // 4
    return (x.reshape(Bn, 2, 2, n, n).permute(0, 1, 3, 2, 4)
            .reshape(Bn, 2 * n, 2 * n))


def _finish_outputs(y, h, tw, nby, nbx, B, mv8, skip, split, mv16_out,
                    skip16_out, lv_y, lv_u, lv_v, lv_y16, lv_u8, lv_v8,
                    rec_y, rec_u, rec_v, choice, mvb8, b64_map=None,
                    split16=None, skip8_out=None, lv_y8=None, lv_u4=None,
                    lv_v4=None, bd: int = 8):
    """Common tail of p_frame_body: scan line + output tuple. split16
    None: no 16->8 layout."""
    dev = y.device
    fry = from_blocks(rec_y, h, tw, 32)
    fru = from_blocks(rec_u, h // 2, tw // 2, 16)
    frv = from_blocks(rec_v, h // 2, tw // 2, 16)
    sl = scanline(lv_y, lv_u, lv_v, lv_y16, lv_u8, lv_v8, split, B,
                  lv_y8, lv_u4, lv_v4, split16)
    if split16 is None:
        split16 = torch.zeros((B, 4), dtype=torch.bool, device=dev)
        skip8_out = torch.zeros((B, 4, 4), dtype=torch.bool, device=dev)
    nsb = ((nby + 1) // 2, (nbx + 1) // 2)
    if b64_map is None:
        b64_map = torch.zeros(nsb, dtype=torch.bool, device=dev)
    pix = _pix_dtype(bd)
    return (mv8, skip, sl,
            lv_y.to(torch.int16), lv_u.to(torch.int16),
            lv_v.to(torch.int16),
            fry.to(pix), fru.to(pix), frv.to(pix),
            torch.zeros((), dtype=torch.int32, device=dev),
            torch.zeros(nsb, dtype=torch.int32, device=dev),
            split, mv16_out.to(torch.int32), skip16_out,
            choice.to(torch.int32), mvb8.to(torch.int32), b64_map,
            split16, skip8_out)


def _sub_grids(nby, nbx, split16, skip16_out, skip8_out):
    """Spatial grids from quad-ordered flags: s16g [2nby, 2nbx] — the
    per-16 sub-split map; skip8g [4nby, 4nbx] — the exact 8x8-unit skip
    map (per-8 inside split16 quads, the 16's skip elsewhere): CDEF's
    skip gate; s16g at 8-px cells is the deblock's sub_map."""
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
            scan_order(8, 8, TX_CLASS_2D),
            scan_order(4, 4, TX_CLASS_2D))


def _take(x, scan, dim):
    return torch.index_select(
        x, dim, torch.as_tensor(np.asarray(scan, np.int64),
                                device=x.device))


def scanline(lv_y, lv_u, lv_v, lv_y16, lv_u8, lv_v8, split, B,
             lv_y8=None, lv_u4=None, lv_v4=None, split16=None):
    """Device-side [B, 1536] int16 scan-ordered level line (split
    blocks: quadrant-major sub-TX scans; split16 quads: sub-quadrant-
    major 8x8/4x4 scans inside the quad's 256/64-entry region, from
    lv_y8 / lv_u4 / lv_v4 in (quad, sub-quad) order)."""
    scan32, scan16, scan8, scan4 = _scans()
    y_n = _take(lv_y.reshape(B, 1024), scan32, 1)
    u_n = _take(lv_u.reshape(B, 256), scan16, 1)
    v_n = _take(lv_v.reshape(B, 256), scan16, 1)
    y_s = _take(lv_y16.reshape(B, 4, 256), scan16, 2)       # [B, 4, 256]
    u_s = _take(lv_u8.reshape(B, 4, 64), scan8, 2)          # [B, 4, 64]
    v_s = _take(lv_v8.reshape(B, 4, 64), scan8, 2)
    if split16 is not None:
        sq = split16.reshape(B, 4)[:, :, None]
        y_s = torch.where(sq, _take(lv_y8.reshape(B, 4, 4, 64), scan8, 3)
                          .reshape(B, 4, 256), y_s)
        u_s = torch.where(sq, _take(lv_u4.reshape(B, 4, 4, 16), scan4, 3)
                          .reshape(B, 4, 64), u_s)
        v_s = torch.where(sq, _take(lv_v4.reshape(B, 4, 4, 16), scan4, 3)
                          .reshape(B, 4, 64), v_s)
    s1 = split[:, None]
    return torch.cat(
        [torch.where(s1, y_s.reshape(B, 1024), y_n),
         torch.where(s1, u_s.reshape(B, 256), u_n),
         torch.where(s1, v_s.reshape(B, 256), v_n)], dim=1).to(torch.int16)


@lru_cache(maxsize=1)
def _stream_maps():
    """Host inverse maps: stream position p (0..1535) -> plane and
    raster (spatial) index within the plane's level array, for the
    NONE-partition, SPLIT and sub-SPLIT (16->8) layouts, plus the quad
    index of each position (selects the per-quad layout)."""
    scan32, scan16, scan8, scan4 = _scans()
    pl = np.empty(SL_LEN, np.int8)
    pl[:1024] = 0
    pl[1024:1280] = 1
    pl[1280:] = 2
    idx_ns = np.empty(SL_LEN, np.int32)
    idx_ns[:1024] = scan32
    idx_ns[1024:1280] = scan16
    idx_ns[1280:] = scan16
    idx_sp = np.empty(SL_LEN, np.int32)
    idx_s8 = np.empty(SL_LEN, np.int32)
    quad_of = np.empty(SL_LEN, np.int32)
    for p in range(1024):
        q, s = p // 256, scan16[p % 256]
        sr, sc = s // 16, s % 16
        idx_sp[p] = (16 * (q // 2) + sr) * 32 + 16 * (q % 2) + sc
        quad_of[p] = q
        k, s8 = (p % 256) // 64, scan8[p % 64]
        r8, c8 = s8 // 8, s8 % 8
        idx_s8[p] = ((16 * (q // 2) + 8 * (k // 2) + r8) * 32
                     + 16 * (q % 2) + 8 * (k % 2) + c8)
    for base in (1024, 1280):
        for k in range(256):
            q, s = k // 64, scan8[k % 64]
            sr, sc = s // 8, s % 8
            idx_sp[base + k] = (8 * (q // 2) + sr) * 16 + 8 * (q % 2) + sc
            quad_of[base + k] = q
            j, s4 = (k % 64) // 16, scan4[k % 16]
            r4, c4 = s4 // 4, s4 % 4
            idx_s8[base + k] = ((8 * (q // 2) + 4 * (j // 2) + r4) * 16
                                + 8 * (q % 2) + 4 * (j % 2) + c4)
    return pl, idx_ns, idx_sp, idx_s8, quad_of


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


def unpack_stream(counts, pos, val, split, cap, split16=None):
    """Host: scatter the nonzero stream back into per-block level
    arrays (lv_y [B,32,32], lv_u/lv_v [B,16,16] int16). Returns the
    arrays plus `over` — blocks whose entries ran past the stream
    capacity (the caller full-gathers those). split16 [B, 4] selects the
    sub-split (8x8 / 4x4 scan) layout per quad of a split block."""
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
        pl, idx_ns, idx_sp, idx_s8, quad_of = _stream_maps()
        plane = pl[p]
        sidx = np.where(split[blk], idx_sp[p], idx_ns[p])
        if split16 is not None and split16.any():
            sub = split[blk] & split16[blk, quad_of[p]]
            sidx = np.where(sub, idx_s8[p], sidx)
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
    """The device dtype of bd-bit pixels: uint8, or int16 above 8 bits
    (the reference's uint16; torch's uint16 has few operations, and 10-
    bit values fit int16)."""
    return torch.uint8 if bd == 8 else torch.int16


def _np_pix(bd: int):
    """_pix_dtype on the host."""
    return np.uint8 if bd == 8 else np.int16


def pack_src(planes, bd: int = 8) -> np.ndarray:
    """Host-side: [y, u, v] 4:2:0 -> one [3h/2, w] array (u|v side by
    side under y) for a single upload; uint8 at 8 bits, int16 above."""
    y, u, v = (np.asarray(p).astype(_np_pix(bd), copy=False)
               for p in planes)
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
          use_split8: bool = False, bd: int = 8, lr: bool = False):
    """Batched P-frame step for an h x w frame, as plain functions (torch
    runs eagerly; nothing is compiled). qindex enters as the dcq/acq
    tensors. Returns (step, (nby, nbx), gather_dense) with
    step(src, ry, ru, rv, dcq, acq, cdef_prm, rd, ds, mark) ->
    (packed decisions int8, lv_y, lv_u, lv_v (int16, on the device for
    the overflow gather), recon y, u, v in _pix_dtype(bd)), and with lr
    an eighth output: the deblocked planes before CDEF (int32), which
    loop restoration reads beyond each stripe, or None with CDEF off.
    `mark(name)` runs after each stage: search, cand, code, split,
    merge64, intra (core; split with use_split, merge64 with b64_rdo on
    even block counts, intra with intra_rdo), filt (deblock), cdef, pack.

    two_ref=True builds the two-reference step, step(src, ry, ru, rv, ry2,
    ru2, rv2, dcq, acq, cdef_prm, rd, ds, mark): the B frame (fwd, bwd or
    compound per block), or with fwd2 the LAST + GOLDEN P frame. As the
    reference's, its core takes use_split, use_satd, fwd2, search, subpel
    and bd, and not refine16, intra_rdo, b64_rdo or use_split8, which
    reach only its filters (b64_rdo: an all-false merge map)."""
    nby, nbx = h // 32, w // 32

    def pad3(ry, ru, rv):
        return (_edge_pad(ry.to(torch.int32), PAD),
                _edge_pad(ru.to(torch.int32), PAD // 2),
                _edge_pad(rv.to(torch.int32), PAD // 2))

    def core(src, ry, ru, rv, dcq, acq, cdef_prm, rd, ds, mark=trace.nomark):
        y, u, v = _unpack_src(src, h, w)
        ryp, rup, rvp = pad3(ry, ru, rv)
        by, bx = _block_origins(nby, nbx, src.device)
        return p_frame_body(y, u, v, ryp, rup, rvp, dcq, acq, cdef_prm,
                            rd, by, bx, nby, nbx, use_split,
                            ds16=ds, use_satd=use_satd, refine16=refine16,
                            intra_rdo=intra_rdo, b64_rdo=b64_rdo,
                            search=search, subpel=subpel,
                            use_split8=use_split8 and use_split, bd=bd,
                            mark=mark)

    def core2(src, ry, ru, rv, ry2, ru2, rv2, dcq, acq, cdef_prm, rd, ds,
              mark=trace.nomark):
        y, u, v = _unpack_src(src, h, w)
        by, bx = _block_origins(nby, nbx, src.device)
        return p_frame_body(y, u, v, *pad3(ry, ru, rv), dcq, acq, cdef_prm,
                            rd, by, bx, nby, nbx, use_split,
                            *pad3(ry2, ru2, rv2), ds16=ds,
                            use_satd=use_satd, fwd2=fwd2, search=search,
                            subpel=subpel, bd=bd, mark=mark)

    def filt(src, fry, fru, frv, base_lf, cdef_prm, split, skip16, b64m,
             lam, split16, skip8q, mark=trace.nomark):
        """The in-loop filter searches as their own stages: the deblock
        level search on the 16-px edge grid (interior edges gated by the
        split map, the merged SBs' inner 32-edges off, 8-px edges and
        shorter taps at 16->8 quads), then, with use_cdef, the
        per-64x64-SB CDEF ladder search against the source (damping
        cdef_prm[4], the nb_strengths RD at lam) on the exact 8x8-unit
        skip gate.
        Returns (lf_lvl, cdef_idx, y, u, v in _pix_dtype(bd), the planes
        before CDEF with lr and CDEF on, else None)."""
        from rav1e_tpu_torch.ops.cdef import cdef_search_persb
        from rav1e_tpu_torch.ops.deblock import deblock_search
        y, u, v = _unpack_src(src, h, w)
        planes = [fry.to(torch.int32), fru.to(torch.int32),
                  frv.to(torch.int32)]
        s16g, skip8 = _sub_grids(nby, nbx, split16, skip16, skip8q)
        lf_lvl = torch.zeros((), dtype=torch.int32, device=src.device)
        if use_deblock:
            lf_lvl, planes = deblock_search(
                planes, [y, u, v], base_lf, block_y=16, block_c=8, bd=bd,
                split_map=split.reshape(nby, nbx),
                merge_map=b64m if b64_rdo else None,
                sub_map=(s16g.repeat_interleave(2, 0).repeat_interleave(2, 1)
                         if use_split8 else None))
        mark("filt")
        pre = planes if lr and use_cdef else None
        if use_cdef:
            cdef_idx, planes = cdef_search_persb(
                planes, [y, u, v], skip8, cdef_prm[4], lam=lam, bd=bd)
        else:
            cdef_idx = torch.zeros(((nby + 1) // 2, (nbx + 1) // 2),
                                   dtype=torch.int32, device=src.device)
        mark("cdef")
        dt = _pix_dtype(bd)
        return (lf_lvl, cdef_idx, planes[0].to(dt), planes[1].to(dt),
                planes[2].to(dt), pre)

    def pack(o, lf_lvl, cdef_idx):
        o = list(o)
        o[9], o[10] = lf_lvl, cdef_idx
        return pack_outputs(o)

    def tail(src, o, cdef_prm, rd, mark):
        if not (use_deblock or use_cdef):
            out = (pack(o, o[9], o[10]), o[3], o[4], o[5], o[6], o[7],
                   o[8]) + ((None,) if lr else ())
            mark("pack")
            return out
        lf_lvl, cdef_idx, fry, fru, frv, pre = filt(
            src, o[6], o[7], o[8], rd["base_lf"], cdef_prm, o[11], o[13],
            o[16], rd["lam"], o[17], o[18], mark)
        out = (pack(o, lf_lvl, cdef_idx), o[3], o[4], o[5], fry, fru,
               frv) + ((pre,) if lr else ())
        mark("pack")
        return out

    def step(src, ry, ru, rv, dcq, acq, cdef_prm, rd, ds, mark=trace.nomark):
        o = core(src, ry, ru, rv, dcq, acq, cdef_prm, rd, ds, mark)
        return tail(src, o, cdef_prm, rd, mark)

    def step2(src, ry, ru, rv, ry2, ru2, rv2, dcq, acq, cdef_prm, rd, ds,
              mark=trace.nomark):
        o = core2(src, ry, ru, rv, ry2, ru2, rv2, dcq, acq, cdef_prm, rd, ds,
                  mark)
        return tail(src, o, cdef_prm, rd, mark)

    return (step2 if two_ref else step), (nby, nbx), gather_dense


# ---- host side -----------------------------------------------------------------

def _fetch_packed(o, gather_dense, nby, nbx, packed=None):
    """Pull one frame's decisions to the host: ONE transfer of the
    packed buffer (into a pinned buffer, on the current stream) +
    (rarely) one batched gather for stream-overflow blocks. Returns
    (mv8, skip, lv_y, lv_u, lv_v, split, mv16, skip16,
    lf_lvl, cdef_idx, choice, mvb8, b64_map, split16, skip8)."""
    (mv8, skip, split, mv16, skip16, choice, mvb8, lf, cdef_map,
     counts, pos, val, b64_map, split16, skip8) = unpack_outputs(
        to_host(o[0]) if packed is None else packed, nby, nbx)
    lv_y, lv_u, lv_v, over = unpack_stream(counts, pos, val, split,
                                           _stream_cap(nby * nbx),
                                           split16=split16)
    didx = np.nonzero(over)[0]
    if len(didx):
        g = to_host(gather_dense(o[1], o[2], o[3], torch.as_tensor(
            didx, device=o[1].device)))
        lv_y[didx] = g[:, :1024].reshape(-1, 32, 32)
        lv_u[didx] = g[:, 1024:1280].reshape(-1, 16, 16)
        lv_v[didx] = g[:, 1280:].reshape(-1, 16, 16)
    return (mv8, skip, lv_y, lv_u, lv_v, split, mv16, skip16,
            lf, cdef_map, choice, mvb8, b64_map, split16, skip8)


def _pack_pframe(h, w, qindex, order_hint, mv8, skip, lv_y, lv_u, lv_v,
                 use_native=True, cdef=None, film_grain=None,
                 render_size=None, lf_level=0, split=None, mv16=None,
                 skip16=None, refresh_flags=0x01, ref_slot=0,
                 show_frame=True, choice=None, b64_map=None,
                 lr_ctx=None, split16=None, skip8=None,
                 bit_depth: int = 8, tile_grid: tuple | None = None,
                 device=None, timings: dict | None = None):
    """Entropy-pack one P frame (single ref) from the batched outputs:
    the C++ packer (use_native, the reference's default) or the Python
    TileWriter walks the blocks on the host into od_ec symbol IR, which
    is range-coded on `device` (the od_ec kernels on cuda). The packer
    walks every P frame with write_inter_tile_fast2 (the reference takes
    its uniform-grid write_inter_tile_fast where there is no split map,
    no CDEF index, no intra, 64x64 or 16->8 block: the same IR); a
    packer error raises. `timings` receives tile_walk, ir_upload,
    ec_kernel and finish.

    split/mv16/skip16 (optional) describe PARTITION_SPLIT 32-blocks: four
    16x16 inter blocks with their own MVs and skips, their TX_16X16 luma
    and TX_8X8 chroma levels stored spatially inside lv_*. split16/skip8
    ([B, 4] / [B, 4, 4], quad then sub-quad order) split a quad further
    into four 8x8 children on the quad's MV (TX_8X8 luma, TX_4X4
    chroma). choice == 3 marks an intra-in-inter block (DC luma and
    chroma); b64_map [nby/2, nbx/2] marks 64x64 PARTITION_NONE blocks
    (TX_64X64 luma from the TL child's retained 32x32 levels, TX_32X32
    chroma from the four children's slots).

    cdef: None, a 5-tuple (one frame-wide strength), or (5-tuple,
    idx_map): the per-SB form signals the ladder entries the SBs chose
    (compact_ladder) and a literal index per 64x64 SB in the tile.
    lr_ctx: (lr_types, lr_data) of the frame's loop restoration
    (pipeline/lr.py::search_lr_frame), which the Python walk codes, as
    the reference's does.

    tile_grid (cols_log2, rows_log2): a multi-tile frame, as the
    reference packs it: the decisions stay frame-global; each tile's
    blocks walk in tile-local coordinates (its own entropy state, MV
    stacks and contexts), write_inter_tile_fast2's tiles on worker
    threads (the C++ walk runs without the GIL), and the tiles' IRs are
    coded in ONE ec_pack launch (pack_tile_irs)."""
    if lr_ctx is not None:
        use_native = False
    dev = resolve_device(device)
    st = trace.stages(dev, timings)     # the Python walk's tile_walk
    seq, fp, cdef_map, cdef_bits = _inter_headers(
        h, w, qindex, cdef, film_grain, render_size, lf_level, bit_depth,
        lr_ctx)
    if tile_grid is not None and lr_ctx is not None:
        _unreachable("loop restoration in a multi-tile frame")
    ti = (TileInfo(seq) if tile_grid is None
          else TileInfo(seq, tile_grid[0], tile_grid[1]))
    intra_map = None if choice is None else np.asarray(choice) == 3
    if intra_map is not None and not intra_map.any():
        intra_map = None
    if b64_map is not None and not np.asarray(b64_map).any():
        b64_map = None
    if split16 is not None and not np.asarray(split16).any():
        split16 = skip8 = None
    if not use_native:
        partitions, blocks = _pframe_tile_dicts(
            w, mv8, skip, lv_y, lv_u, lv_v, split, mv16, skip16, intra_map,
            b64_map, split16, skip8)
        tiles = _python_walk(ti, h, w, qindex, partitions, blocks, cdef_map,
                             cdef_bits, dev, timings, st,
                             lr_data=lr_ctx and lr_ctx[1])
    else:
        tiles = _pack_pframe_tiles(
            ti, h, w, qindex, mv8, skip, lv_y, lv_u, lv_v, split, mv16,
            skip16, cdef_map, cdef_bits, intra_map, b64_map, split16, skip8,
            dev, timings)
    return interframe_packet(seq, fp, ti, tiles, order_hint,
                             refresh_flags=refresh_flags,
                             ref_idx=[ref_slot] * 7, show_frame=show_frame)


def _inter_headers(h, w, qindex, cdef, film_grain, render_size, lf_level,
                   bit_depth: int, lr_ctx=None):
    """An inter frame's sequence and frame headers, as the reference's
    pack functions set them. cdef: None, a 5-tuple (one frame-wide
    strength) or (5-tuple, idx_map) (the per-SB ladder: the entries used
    are signalled, compact_ladder); lr_ctx: None or (lr_types, lr_data),
    which enables restoration in the sequence. Returns (seq, fp, the
    compacted index map or None, its bits)."""
    cdef_map = None
    if cdef is not None and isinstance(cdef[1], np.ndarray):
        cdef, cdef_map = cdef
    seq = Sequence(width=w, height=h, enable_cdef=cdef is not None,
                   bit_depth=bit_depth,
                   film_grain_params_present=film_grain is not None)
    lf = int(lf_level)
    fp = FrameParams(frame_type=FrameType.INTER, base_q_idx=qindex,
                     render_size=render_size,
                     loop_filter_levels=(lf, lf, lf, lf))
    fp.film_grain = film_grain
    fp.delta_q_u_dc = fp.delta_q_u_ac = chroma_dq(qindex)
    if lr_ctx is not None:
        seq.enable_restoration = True
        fp.lr_types = lr_ctx[0]
    cdef_bits = 0
    if cdef_map is not None:
        from rav1e_tpu_torch.ops.cdef import compact_ladder
        fp.cdef_damping = cdef[4]
        fp.cdef_strengths, cdef_bits, cdef_map = compact_ladder(cdef_map)
    elif cdef is not None:
        (fp.cdef_y_pri, fp.cdef_y_sec, fp.cdef_uv_pri, fp.cdef_uv_sec,
         fp.cdef_damping) = cdef
    return seq, fp, cdef_map, cdef_bits


def _tile_spans(ti, h: int, w: int):
    """The tiles of TileInfo ti in raster order, each (row0, row1, col0,
    col1) in 64x64 superblocks, clipped to the frame."""
    sbr, sbc = -(-h // 64), -(-w // 64)
    return [(min(ti.row_starts[tr], sbr), min(ti.row_starts[tr + 1], sbr),
             min(ti.col_starts[tc], sbc), min(ti.col_starts[tc + 1], sbc))
            for tr in range(ti.n_rows) for tc in range(ti.n_cols)]


def _python_walk(ti, h, w, qindex, partitions, blocks, cdef_map, cdef_bits,
                 device, timings, st, **writer):
    """The tiles of TileInfo ti walked by the Python TileWriter (keyword
    arguments `writer`), each in tile-local coordinates with its own
    entropy state and its slice of the CDEF index map, into od_ec IR;
    the tiles' IRs are coded in one launch on `device` (pack_tile_irs:
    the od_ec kernels on cuda). `st`, the pack's stages, closes tile_walk
    after the walks (_code_tiles); `timings` receives the coding stages.
    Returns the tiles' bytes."""
    irs = []
    for r0, r1, c0, c1 in _tile_spans(ti, h, w):
        m0, m1 = r0 * 16, min(r1 * 16, h >> 2)
        n0, n1 = c0 * 16, min(c1 * 16, w >> 2)
        tw = TileWriter(m1 - m0, n1 - n0, qindex, inter_frame=True,
                        encoder=IRRecorder, **writer)
        if cdef_bits:
            tw.cdef_bits = cdef_bits
            tw.cdef_idx_map = cdef_map[r0:r1, c0:c1]
        tparts = {(r - m0, c - n0, bs): p
                  for (r, c, bs), p in partitions.items()
                  if m0 <= r < m1 and n0 <= c < n1}
        tblocks = {(r - m0, c - n0): d for (r, c), d in blocks.items()
                   if m0 <= r < m1 and n0 <= c < n1}
        irs.append(tw.write_tile(tparts, tblocks))
    return _code_tiles(irs, device, timings, st)


def _code_tiles(irs, device, timings, st):
    """A frame's tile IRs coded in one launch: `st` (the pack's stages)
    first closes tile_walk, its work count the IR rows the walks wrote;
    `timings` gets the coding stages."""
    st.mark("tile_walk", sum(int(ir.shape[0]) for ir in irs))
    return pack_tile_irs(irs, device, timings)


def _pack_pframe_tiles(ti, h, w, qindex, mv8, skip, lv_y, lv_u, lv_v, split,
                       mv16, skip16, cdef_map, cdef_bits, intra_map, b64_map,
                       split16, skip8, device, timings):
    """The tiles of a P frame (one, or a multi-tile frame as the
    reference's _pack_pframe(tile_grid=...) packs it): each tile's
    32-blocks (index set bidx) and its slices of the CDEF and 64x64 maps
    through the C++ packer's write_inter_tile_fast2 in tile-local
    coordinates, the walks of several tiles on up to 8 worker threads
    (each under the caller's frame: trace.carry); then their IRs in one
    ec_pack launch. `timings` gets tile_walk (from the walks' start, the
    writers made, to the last IR's hand-back) and the coding stages."""
    B = mv8.shape[0]
    nbx = w // 32
    if split is None:
        split = np.zeros(B, bool)
        mv16 = np.repeat(mv8[:, None, :], 4, axis=1)
        skip16 = np.repeat(np.asarray(skip).reshape(B, 1), 4, axis=1)
    # 8x8 children inherit the parent 16's MV
    mvq8 = (None if split16 is None else
            np.repeat(np.asarray(mv16)[:, :, None, :], 4, axis=2))

    spans = _tile_spans(ti, h, w)
    writers = [NativeTileWriter(min(r1 * 16, h >> 2) - r0 * 16,
                                min(c1 * 16, w >> 2) - c0 * 16, qindex,
                                inter_frame=True, device=device,
                                ir_only=True)
               for r0, r1, c0, c1 in spans]
    st = trace.stages(device, timings)

    def walk(tw, span):
        r0, r1, c0, c1 = span
        brow = np.arange(r0 * 2, min(r1 * 2, h // 32))
        bcol = np.arange(c0 * 2, min(c1 * 2, w // 32))
        bidx = (brow[:, None] * nbx + bcol[None, :]).reshape(-1)
        whole = len(spans) == 1         # bidx is arange(B), the maps whole

        def sel(a):
            return a if a is None or whole else a[bidx]

        def sb(a):
            return a if a is None or whole else a[r0:r1, c0:c1]

        args = [sel(a) for a in (split, mv8, skip, mv16, skip16, lv_y, lv_u,
                                 lv_v)]
        kw = dict(cdef_idx=sb(cdef_map), cdef_bits=cdef_bits,
                  intra32=sel(intra_map), b64=sb(b64_map),
                  split16=sel(split16), mvq8=sel(mvq8), skip8=sel(skip8))
        return tw.write_inter_tile_fast2(*args, **kw)

    if len(spans) == 1:
        irs = [walk(writers[0], spans[0])]
    else:
        with ThreadPoolExecutor(min(len(spans), 8)) as ex:
            irs = list(ex.map(trace.carry(walk), writers, spans))
    return _code_tiles(irs, device, timings, st)


def _pframe_tile_dicts(w, mv8, skip, lv_y, lv_u, lv_v, split, mv16, skip16,
                       intra_map, b64_map, split16, skip8):
    """The P frame's blocks as TileWriter.write_tile's partitions and
    blocks dicts (the Python writer's walk, use_native=False)."""
    nbx = w // 32
    partitions: dict = {}
    blocks: dict = {}

    def inter_block(mv, sk, yl, ul, vl):
        mv = (int(mv[0]), int(mv[1]))
        d = BlockDecision(y_mode=(PredictionMode.GLOBALMV if mv == (0, 0)
                                  else PredictionMode.NEWMV),
                          uv_mode=PredictionMode.DC_PRED, skip=bool(sk),
                          mv=mv)
        if not d.skip:
            d.coeffs = {0: yl, 1: ul, 2: vl}
        return d

    for b in range(mv8.shape[0]):
        by, bx = (b // nbx) * 32, (b % nbx) * 32
        r, c = by >> 2, bx >> 2
        if b64_map is not None and b64_map[by // 64, bx // 64]:
            if by % 64 or bx % 64:
                continue              # coded by the SB's TL block
            partitions[(r, c, int(BlockSize.B64X64))] = PartitionType.NONE
            lv64 = np.zeros((64, 64), np.int64)
            lv64[:32, :32] = lv_y[b]
            cu = np.zeros((32, 32), np.int64)
            cv = np.zeros((32, 32), np.int64)
            for q, (dr, dc) in enumerate(((0, 0), (0, 16), (16, 0),
                                          (16, 16))):
                child = b + (q >> 1) * nbx + (q & 1)
                cu[dr: dr + 16, dc: dc + 16] = lv_u[child]
                cv[dr: dr + 16, dc: dc + 16] = lv_v[child]
            blocks[(r, c)] = inter_block(mv8[b], skip[b], lv64, cu, cv)
            continue
        partitions[(r, c, int(BlockSize.B64X64))] = PartitionType.SPLIT
        if intra_map is not None and intra_map[b]:
            d = BlockDecision(y_mode=PredictionMode.DC_PRED,
                              uv_mode=PredictionMode.DC_PRED,
                              skip=bool(skip[b]), ref=0)
            if not d.skip:
                d.coeffs = {0: lv_y[b], 1: lv_u[b], 2: lv_v[b]}
            partitions[(r, c, int(BlockSize.B32X32))] = PartitionType.NONE
            blocks[(r, c)] = d
            continue
        if split is not None and split[b]:
            partitions[(r, c, int(BlockSize.B32X32))] = PartitionType.SPLIT
            for q, (dr, dc) in enumerate(((0, 0), (0, 4), (4, 0), (4, 4))):
                py, px, cy, cx = dr * 4, dc * 4, dr * 2, dc * 2
                if split16 is not None and split16[b, q]:
                    # four 8x8 children on the quad's MV
                    partitions[(r + dr, c + dc, int(BlockSize.B16X16))] = \
                        PartitionType.SPLIT
                    for s, (sr, sc) in enumerate(((0, 0), (0, 2), (2, 0),
                                                  (2, 2))):
                        sy, sx = py + sr * 4, px + sc * 4
                        scy, scx = cy + sr * 2, cx + sc * 2
                        partitions[(r + dr + sr, c + dc + sc,
                                    int(BlockSize.B8X8))] = \
                            PartitionType.NONE
                        blocks[(r + dr + sr, c + dc + sc)] = inter_block(
                            mv16[b, q], skip8[b, q, s],
                            lv_y[b][sy: sy + 8, sx: sx + 8],
                            lv_u[b][scy: scy + 4, scx: scx + 4],
                            lv_v[b][scy: scy + 4, scx: scx + 4])
                    continue
                partitions[(r + dr, c + dc, int(BlockSize.B16X16))] = \
                    PartitionType.NONE
                blocks[(r + dr, c + dc)] = inter_block(
                    mv16[b, q], skip16[b, q],
                    lv_y[b][py: py + 16, px: px + 16],
                    lv_u[b][cy: cy + 8, cx: cx + 8],
                    lv_v[b][cy: cy + 8, cx: cx + 8])
            continue
        partitions[(r, c, int(BlockSize.B32X32))] = PartitionType.NONE
        blocks[(r, c)] = inter_block(mv8[b], skip[b], lv_y[b], lv_u[b],
                                     lv_v[b])
    return partitions, blocks


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


def _q_scalars(qindex: int, dev, bit_depth: int = 8):
    return (torch.tensor(dc_q_lut(qindex, 0, bit_depth), dtype=torch.int32,
                         device=dev),
            torch.tensor(ac_q_lut(qindex, 0, bit_depth), dtype=torch.int32,
                         device=dev))


def encode_pframe_tpu(planes, ref_planes, qindex: int = 100,
                      order_hint: int = 1, use_native: bool = True,
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
    of 32, 4:2:0 at 8 or 10 bits (bit_depth; 10-bit planes are uint16 or
    any integer type on the host, int16 on the device). Runs on `cuda`
    unless device="cpu" is passed.

    The defaults are the reference's: split RDO with the per-16 subpel
    refinement (refine16), a 16-px search, subpel. The speed-6 tools are
    use_satd, intra_rdo, b64_rdo (with use_split) and use_split8; the
    speed-7 toolset is refine16=False, search=8; speed 8 adds
    use_split=False, and speeds 9-10 take subpel=False. use_native: the
    C++ packer walks the tile (the reference's default), else the Python
    TileWriter (the same IR and bytes). tile_grid (cols_log2, rows_log2)
    codes a multi-tile frame from the same frame-global decisions (the
    C++ packer a tile, every tile coded in one ec_pack launch; with lr it
    raises NotImplementedError: ROADMAP.md section 3).
    cdef: None (off) or (y_pri, y_sec, uv_pri, uv_sec, damping): each
    64x64 SB picks its ladder entry (damping cdef[4]) and the frame
    signals the entries used.
    ref_dev: device-resident reference planes (y, u, v; _pix_dtype) from
    a prior call with return_device=True, which skips the upload; src_dev:
    the packed source (pack_src) already on the device. `timings`
    receives each stage's wall time. Returns (packet, [y, u, v] recon
    int32) and, with return_device, the device recon too.
    lr: loop restoration after CDEF (pipeline/lr.py: at 8 bits the search
    and apply on the device, above 8 bits on the host at the frame's bit
    depth), the recon returned filtered; it packs with the Python
    TileWriter, as the reference does, and cannot return the device
    recon."""
    if lr and return_device:
        raise ValueError("return_device is incompatible with lr")
    if lr and tile_grid is not None:
        _unreachable("loop restoration in a multi-tile frame")
    _check_bit_depth(bit_depth)
    y, u, v = planes
    h, w = y.shape[0], y.shape[1]
    assert h % 32 == 0 and w % 32 == 0
    dev = resolve_device(device)
    stages = trace.stages(dev, timings)
    step, (nby, nbx), gdense = _core(h, w, cdef is not None,
                                     use_split=use_split, use_satd=use_satd,
                                     refine16=refine16, intra_rdo=intra_rdo,
                                     b64_rdo=b64_rdo, search=search,
                                     subpel=subpel, use_split8=use_split8,
                                     bd=bit_depth, lr=lr)
    if ref_dev is None:
        ref_dev = _upload(ref_planes, dev, bit_depth)
    if src_dev is None:
        src_dev = torch.from_numpy(pack_src(planes, bd=bit_depth)).to(dev)
    cdef_prm = _cdef_prm(cdef)
    rd = build_rd_inter(qindex, bit_depth, device=dev)
    ds = _ds16_quads(dscale, nby, nbx, dev)
    stages.mark("upload")
    outs = step(src_dev, *ref_dev, *_q_scalars(qindex, dev, bit_depth),
                cdef_prm, rd, ds, stages.mark)
    rec_dev = outs[4:7]
    (mv8, skip, lv_y, lv_u, lv_v, split, mv16, skip16, lf_lvl,
     cdef_map, choice, _, b64_map, split16, skip8) = _fetch_packed(
        outs, gdense, nby, nbx)
    rec, lr_ctx = _lr_recon(outs, src_dev, h, w, lr, bit_depth, stages)
    pkt = _pack_pframe(h, w, qindex, order_hint, mv8, skip, lv_y, lv_u,
                       lv_v, use_native=use_native, lr_ctx=lr_ctx,
                       cdef=None if cdef is None else (cdef_prm, cdef_map),
                       film_grain=film_grain,
                       render_size=render_size, lf_level=lf_lvl,
                       **_split_args(use_split, split, mv16, skip16),
                       refresh_flags=refresh_flags, ref_slot=ref_slot,
                       show_frame=show_frame,
                       choice=choice if intra_rdo else None,
                       b64_map=b64_map if b64_rdo else None,
                       split16=split16 if use_split8 else None,
                       skip8=skip8 if use_split8 else None,
                       bit_depth=bit_depth, tile_grid=tile_grid, device=dev,
                       timings=timings)
    if return_device:
        return pkt, rec, rec_dev
    return pkt, rec


def _split_args(use_split: bool, split, mv16, skip16) -> dict:
    """_pack_pframe's split arguments: the fetched maps, or None for a
    step without split RDO (every 32-block whole)."""
    if not use_split:
        return dict(split=None, mv16=None, skip16=None)
    return dict(split=split, mv16=mv16, skip16=skip16)


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
    """KEY + P chain on the device, at speeds 0-10 (speed 6 is the preset
    the reference's bench times; speeds 3-4 add refine16, speeds 0-2
    search 24 px in P frames; like the reference's, the GOP runs no loop
    restoration); 4:2:0 8-bit frames with dims multiples of 32. Runs on
    `cuda` unless device="cpu" is passed. cdef (None, or (y_pri, y_sec,
    uv_pri, uv_sec, damping)) runs the per-SB CDEF search on every
    frame, with damping cdef[4]; each P frame then references the
    CDEF-filtered recon.

    The schedule is the reference's: the main thread runs the keyframe's
    device half (encode_keyframe_tpu(deferred=True)), then uploads and
    dispatches each P step in order, its reference planes staying on the
    device (the keyframe's filtered recon, then each P frame's); a pool
    of four worker threads runs the keyframe's host half, pack_src of
    every P frame and each P frame's fetch + pack, each worker's device
    work on a stream of its own that waits for its frame's step. Returns
    (packets, recons): the keyframe's recon as numpy int32 planes, each
    P frame's as uint8 tensors on the device. `timings`, when given a
    list, receives one dict of stage times per frame, each stage timed
    on the thread that ran it; the first dict also gets gop_wall, the
    whole call's wall time. Frame i's work runs under trace.frame(i,
    "keyframe" or "pframe"), its host half on a worker under the same
    frame (trace.carry)."""
    from rav1e_tpu_torch.api.speed import SpeedSettings
    from rav1e_tpu_torch.pipeline.tpu_intra import (_check_options,
                                                    encode_keyframe_tpu)
    _check_options(cdef, frames[0], None)
    ss = SpeedSettings.from_preset(speed)
    dev = resolve_device(device)

    def frame_times():
        if timings is None:
            return None
        timings.append({})
        return timings[-1]

    kf_times = frame_times()
    gop = trace.stages(dev, kf_times)      # closes gop_wall at the end
    if len(frames) == 1:
        with trace.frame(0, "keyframe"):
            pkt, rec = encode_keyframe_tpu(frames[0], qindex=qindex,
                                           speed=speed, cdef=cdef,
                                           device=dev, timings=kf_times)
        gop.mark("gop_wall")
        return [pkt], [rec]
    with trace.frame(0, "keyframe"):
        kf_finish, ref_dev = encode_keyframe_tpu(
            frames[0], qindex=qindex, speed=speed, cdef=cdef, deferred=True,
            device=dev, timings=kf_times)
        kf_finish = trace.carry(kf_finish)
    h, w = frames[0][0].shape
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
    s8 = ss.partition_split8

    def tail(i, o, after, t_p):
        """Fetch frame i's packed decisions and entropy-pack them (on a
        worker, after frame i's step)."""
        with after:
            stages = trace.stages(dev, t_p)
            (mv8, skip, lv_y, lv_u, lv_v, split, mv16, skip16, lf_lvl,
             cdef_map, choice, _, b64m, split16, skip8) = _fetch_packed(
                o, gdense, nby, nbx)
            stages.mark("fetch_unpack")
            return _pack_pframe(
                h, w, qindex, i, mv8, skip, lv_y, lv_u, lv_v,
                cdef=None if cdef is None else (cdef_prm, cdef_map),
                lf_level=lf_lvl,
                **_split_args(ss.partition_split_rdo, split, mv16, skip16),
                choice=choice if speed <= 6 else None,
                b64_map=b64m if speed <= 6 else None,
                split16=split16 if s8 else None,
                skip8=skip8 if s8 else None, device=dev, timings=t_p)

    with ThreadPoolExecutor(4) as ex:
        kf_fut = ex.submit(kf_finish)
        src_futs = [ex.submit(pack_src, f) for f in frames[1:]]
        outs, pkt_futs = [], []
        for i, sf in enumerate(src_futs, start=1):
            with trace.frame(i, "pframe"):
                t_p = frame_times()
                stages = trace.stages(dev, t_p)
                src = torch.from_numpy(sf.result()).to(dev)
                stages.mark("upload")
                o = step(src, *ref_dev, dcq, acq, cdef_prm, rd, ones,
                         stages.mark)
                ref_dev = o[4:7]
                # the outputs stay referenced in outs until every tail ends
                outs.append(o)
                pkt_futs.append(ex.submit(trace.carry(tail), i, o,
                                          SideStream(dev), t_p))
        kf_pkt, kf_rec = kf_fut.result()
        pkts = [kf_pkt] + [f.result() for f in pkt_futs]
    recs = [kf_rec] + [[o[4], o[5], o[6]] for o in outs]
    gop.mark("gop_wall")
    return pkts, recs


# ---- two references: the B frame and the LAST + GOLDEN P frame ----------------

def _upload(planes, dev, bd: int = 8):
    return tuple(torch.as_tensor(np.asarray(p).astype(_np_pix(bd),
                                                      copy=False),
                                 device=dev)
                 for p in planes)


def _pack_bframe(h, w, qindex, order_hint, mv8, mvb8, choice, skip,
                 lv_y, lv_u, lv_v, cdef=None, film_grain=None,
                 render_size=None, lf_level=0, slot_fwd=0, slot_bwd=1,
                 ref_hints=None, refresh_flags=0, show_frame=True,
                 b64_map=None, lr_ctx=None, bit_depth: int = 8,
                 split=None, mv16=None, skip16=None,
                 tile_grid: tuple | None = None, device=None,
                 timings: dict | None = None):
    """Entropy-pack one B frame from the two-reference step's outputs, as
    the reference does: the Python TileWriter walks the blocks into od_ec
    IR (_python_walk), coded on `device`. choice[b]: 0 single-LAST
    (fwd), 1 single-ALTREF (bwd), 2 COMPOUND_AVERAGE (LAST, ALTREF); mv8 is
    the primary MV (fwd for 0 and 2, bwd for 1), mvb8 the bwd MV of a
    compound block. A split 32-block's four 16x16 children are the
    parent's (ref choice, MV or MV pair) or, where mv16 is zero, single-
    LAST GLOBALMV blocks. `timings` receives tile_walk and the coding
    stages. lr_ctx: (lr_types, lr_data) of the frame's loop restoration,
    coded by the walk. tile_grid (cols_log2, rows_log2): a multi-tile
    frame, as the reference packs it: one Python TileWriter a tile in
    tile-local coordinates, the tiles' IRs coded in one ec_pack launch.
    Merged 64x64 blocks raise NotImplementedError."""
    if tile_grid is not None and lr_ctx is not None:
        _unreachable("loop restoration in a multi-tile frame")
    if b64_map is not None and np.asarray(b64_map).any():
        raise NotImplementedError(
            "merged 64x64 blocks in a B frame: the two-reference 64x64 "
            "merge is not ported (ROADMAP.md section 3)")
    dev = resolve_device(device)
    st = trace.stages(dev, timings)
    seq, fp, cdef_map, cdef_bits = _inter_headers(
        h, w, qindex, cdef, film_grain, render_size, lf_level, bit_depth,
        lr_ctx)
    ti = (TileInfo(seq) if tile_grid is None
          else TileInfo(seq, tile_grid[0], tile_grid[1]))
    nbx = w // 32
    partitions: dict = {}
    blocks: dict = {}

    def block(mv, mv2, ch, sk, yl, ul, vl):
        mv = (int(mv[0]), int(mv[1]))
        if ch == 2:
            mv2 = (int(mv2[0]), int(mv2[1]))
            d = BlockDecision(
                y_mode=(PredictionMode.GLOBAL_GLOBALMV
                        if mv == (0, 0) and mv2 == (0, 0)
                        else PredictionMode.NEW_NEWMV),
                uv_mode=PredictionMode.DC_PRED, skip=bool(sk), mv=mv, ref=1)
            d.ref2 = 7
            d.mv2 = mv2
        else:
            d = BlockDecision(
                y_mode=(PredictionMode.GLOBALMV if mv == (0, 0)
                        else PredictionMode.NEWMV),
                uv_mode=PredictionMode.DC_PRED, skip=bool(sk), mv=mv,
                ref=1 if ch == 0 else 7)
        if not d.skip:
            d.coeffs = {0: yl, 1: ul, 2: vl}
        return d

    for b in range(mv8.shape[0]):
        r, c = (b // nbx) * 8, (b % nbx) * 8
        partitions[(r, c, int(BlockSize.B64X64))] = PartitionType.SPLIT
        ch = int(choice[b])
        if split is not None and split[b]:
            partitions[(r, c, int(BlockSize.B32X32))] = PartitionType.SPLIT
            for q, (dr, dc) in enumerate(((0, 0), (0, 4), (4, 0), (4, 4))):
                py, px, cy, cx = dr * 4, dc * 4, dr * 2, dc * 2
                partitions[(r + dr, c + dc, int(BlockSize.B16X16))] = \
                    PartitionType.NONE
                zero = mv16[b, q, 0] == 0 and mv16[b, q, 1] == 0
                blocks[(r + dr, c + dc)] = block(
                    mv16[b, q], mvb8[b], 0 if zero else ch, skip16[b, q],
                    lv_y[b][py: py + 16, px: px + 16],
                    lv_u[b][cy: cy + 8, cx: cx + 8],
                    lv_v[b][cy: cy + 8, cx: cx + 8])
            continue
        partitions[(r, c, int(BlockSize.B32X32))] = PartitionType.NONE
        blocks[(r, c)] = block(mv8[b], mvb8[b], ch, skip[b], lv_y[b],
                               lv_u[b], lv_v[b])
    tiles = _python_walk(ti, h, w, qindex, partitions, blocks, cdef_map,
                         cdef_bits, dev, timings, st,
                         ref_sign_bias={1: False, 7: True},
                         reference_select=True,
                         lr_data=lr_ctx and lr_ctx[1])
    fp.reference_select = True
    fh, bh2 = ref_hints or (0, order_hint + 1)
    fp.ref_order_hints = [fh] * 6 + [bh2]
    return interframe_packet(seq, fp, ti, tiles, order_hint,
                             refresh_flags=refresh_flags,
                             ref_idx=[slot_fwd] * 6 + [slot_bwd],
                             show_frame=show_frame)


def encode_bframe_tpu(planes, ref_fwd, ref_bwd, qindex: int = 100,
                      order_hint: int = 1,
                      ref_dev_fwd=None, ref_dev_bwd=None,
                      cdef: tuple | None = None, film_grain=None,
                      slot_fwd: int = 0, slot_bwd: int = 1,
                      ref_hints: tuple | None = None,
                      render_size: tuple | None = None,
                      dscale=None, src_dev=None,
                      refresh_flags: int = 0, show_frame: bool = True,
                      b64_rdo: bool = False, lr: bool = False,
                      search: int = SEARCH, subpel: bool = True,
                      bit_depth: int = 8, use_split: bool = False,
                      tile_grid: tuple | None = None, device=None,
                      timings: dict | None = None):
    """Batched B frame on the device: both references searched and
    re-judged, each 32-block taking single-fwd, single-bwd or
    COMPOUND_AVERAGE by RD, with use_split the cheap {parent, zero}
    split; dims multiples of 32, 4:2:0 at 8 or 10 bits (bit_depth, as
    encode_pframe_tpu). Runs on `cuda` unless device="cpu" is passed.
    The reference's call: b64_rdo reaches only
    the deblock (an all-false merge map), its core never merges.

    ref_fwd / ref_bwd: the references' [y, u, v] planes (ref_hints their
    order hints, slot_fwd / slot_bwd their slots), or ref_dev_fwd /
    ref_dev_bwd their planes on the device (_pix_dtype); src_dev: the packed
    source (pack_src) on the device. The packet is the reference's
    Python TileWriter walk with its IR coded on the device. `timings`
    receives each stage's wall time. lr: loop restoration after CDEF, as
    encode_pframe_tpu's. tile_grid (cols_log2, rows_log2) codes a
    multi-tile frame from the same decisions (one Python TileWriter a
    tile, every tile coded in one ec_pack launch; with lr it raises
    NotImplementedError: ROADMAP.md section 3). Returns (packet, [y, u,
    v] recon int32)."""
    if lr and tile_grid is not None:
        _unreachable("loop restoration in a multi-tile frame")
    _check_bit_depth(bit_depth)
    h, w = planes[0].shape[0], planes[0].shape[1]
    assert h % 32 == 0 and w % 32 == 0
    dev = resolve_device(device)
    stages = trace.stages(dev, timings)
    step, (nby, nbx), gdense = _core(h, w, cdef is not None,
                                     use_split=use_split, two_ref=True,
                                     b64_rdo=b64_rdo, search=search,
                                     subpel=subpel, bd=bit_depth, lr=lr)
    if ref_dev_fwd is None:
        ref_dev_fwd = _upload(ref_fwd, dev, bit_depth)
    if ref_dev_bwd is None:
        ref_dev_bwd = _upload(ref_bwd, dev, bit_depth)
    if src_dev is None:
        src_dev = torch.from_numpy(pack_src(planes, bd=bit_depth)).to(dev)
    cdef_prm = _cdef_prm(cdef)
    rd = build_rd_inter(qindex, bit_depth, device=dev)
    ds = _ds16_quads(dscale, nby, nbx, dev)
    stages.mark("upload")
    outs = step(src_dev, *ref_dev_fwd, *ref_dev_bwd,
                *_q_scalars(qindex, dev, bit_depth), cdef_prm, rd, ds,
                stages.mark)
    (mv8, skip, lv_y, lv_u, lv_v, split, mv16, skip16, lf_lvl, cdef_map,
     choice, mvb8, b64m, _, _) = _fetch_packed(outs, gdense, nby, nbx)
    rec, lr_ctx = _lr_recon(outs, src_dev, h, w, lr, bit_depth, stages)
    pkt = _pack_bframe(h, w, qindex, order_hint, mv8, mvb8, choice, skip,
                       lv_y, lv_u, lv_v,
                       cdef=None if cdef is None else (cdef_prm, cdef_map),
                       film_grain=film_grain, render_size=render_size,
                       lf_level=lf_lvl, slot_fwd=slot_fwd,
                       slot_bwd=slot_bwd, ref_hints=ref_hints,
                       refresh_flags=refresh_flags, show_frame=show_frame,
                       b64_map=b64m if b64_rdo else None,
                       split=split if use_split else None, mv16=mv16,
                       skip16=skip16, lr_ctx=lr_ctx, bit_depth=bit_depth,
                       tile_grid=tile_grid, device=dev, timings=timings)
    return pkt, rec


def _lr_recon(outs, src_dev, h: int, w: int, lr: bool, bit_depth: int,
              stages):
    """A step's recon (outs[4:7]) on the host (int32 planes) and, with lr,
    its loop restoration (pipeline/lr.py) on the device recon, before the
    fetch, reading the planes before CDEF (outs[7]) beyond each stripe:
    returns (recon, (lr_types, lr_data) or None). The reference passes
    bit depth 8 to its device steps' LR at any depth; the port passes
    the frame's (ROADMAP.md section 3)."""
    if not lr:
        rec = [r.cpu().numpy().astype(np.int32) for r in outs[4:7]]
        stages.mark("fetch_unpack")
        return rec, None
    from rav1e_tpu_torch.pipeline.lr import search_lr_frame
    stages.mark("fetch_unpack")
    planes = list(outs[4:7])
    lr_ctx = search_lr_frame(planes, list(_unpack_src(src_dev, h, w)),
                             bit_depth, 1, pre=outs[7])
    rec = [to_host(r).astype(np.int32) for r in planes]
    stages.mark("lr")
    return rec, lr_ctx


def _pack_pframe_mref(h, w, qindex, order_hint, mv8, choice, skip,
                      lv_y, lv_u, lv_v, cdef=None, lf_level=0,
                      film_grain=None, render_size=None,
                      slot_last=0, slot_golden=1, golden_hint=0,
                      refresh_flags=0x01, bit_depth: int = 8, device=None,
                      timings: dict | None = None):
    """Entropy-pack a LAST + GOLDEN P frame, as the reference does (the
    Python TileWriter's walk, its IR coded on `device`): choice[b] 0 =
    LAST, 1 = GOLDEN, both forward, single prediction (spec
    read_ref_frames' single path). `timings` receives tile_walk and the
    coding stages. 8-bit only: the reference's encode_pframe2_tpu has no
    bit depth, and its Context takes LAST + GOLDEN only at 8 bits."""
    if bit_depth != 8:
        raise NotImplementedError(
            "LAST + GOLDEN P frames are 8-bit: the reference's "
            "encode_pframe2_tpu has no bit depth")
    dev = resolve_device(device)
    st = trace.stages(dev, timings)
    seq, fp, cdef_map, cdef_bits = _inter_headers(
        h, w, qindex, cdef, film_grain, render_size, lf_level, bit_depth)
    ti = TileInfo(seq)
    nbx = w // 32
    partitions: dict = {}
    blocks: dict = {}
    for b in range(mv8.shape[0]):
        r, c = (b // nbx) * 8, (b % nbx) * 8
        partitions[(r, c, int(BlockSize.B64X64))] = PartitionType.SPLIT
        partitions[(r, c, int(BlockSize.B32X32))] = PartitionType.NONE
        mv = (int(mv8[b, 0]), int(mv8[b, 1]))
        d = BlockDecision(y_mode=(PredictionMode.GLOBALMV if mv == (0, 0)
                                  else PredictionMode.NEWMV),
                          uv_mode=PredictionMode.DC_PRED,
                          skip=bool(skip[b]), mv=mv,
                          ref=1 if int(choice[b]) == 0 else 4)
        if not d.skip:
            d.coeffs = {0: lv_y[b], 1: lv_u[b], 2: lv_v[b]}
        blocks[(r, c)] = d
    tile, = _python_walk(ti, h, w, qindex, partitions, blocks, cdef_map,
                         cdef_bits, dev, timings, st,
                         ref_sign_bias={1: False, 4: False})
    ref_idx = [slot_last] * 7
    ref_idx[3] = slot_golden
    fp.ref_order_hints = [0] * 7
    fp.ref_order_hints[3] = golden_hint
    return interframe_packet(seq, fp, ti, [tile], order_hint,
                             refresh_flags=refresh_flags, ref_idx=ref_idx)


def encode_pframe2_tpu(planes, ref_last, ref_golden, qindex: int = 100,
                       order_hint: int = 1, cdef: tuple | None = None,
                       slot_last: int = 0, slot_golden: int = 1,
                       golden_hint: int = 0, dscale=None,
                       use_satd: bool = False,
                       render_size: tuple | None = None,
                       refresh_flags: int = 0x01, device=None,
                       timings: dict | None = None):
    """LAST + GOLDEN P frame on the device: every 32-block picks LAST or
    GOLDEN by RD (the two-reference step with fwd2; no split); dims
    multiples of 32, 4:2:0 8-bit. Runs on `cuda` unless device="cpu" is
    passed. Packed as the reference packs it (the Python TileWriter, the
    IR coded on the device). `timings` receives each stage's wall time.
    Returns (packet, [y, u, v] recon int32)."""
    h, w = planes[0].shape[0], planes[0].shape[1]
    assert h % 32 == 0 and w % 32 == 0
    dev = resolve_device(device)
    stages = trace.stages(dev, timings)
    step, (nby, nbx), gdense = _core(h, w, cdef is not None,
                                     use_split=False, two_ref=True,
                                     use_satd=use_satd, fwd2=True)
    refs = _upload(ref_last, dev) + _upload(ref_golden, dev)
    src_dev = torch.from_numpy(pack_src(planes)).to(dev)
    cdef_prm = _cdef_prm(cdef)
    rd = build_rd_inter(qindex, device=dev)
    ds = _ds16_quads(dscale, nby, nbx, dev)
    stages.mark("upload")
    outs = step(src_dev, *refs, *_q_scalars(qindex, dev), cdef_prm, rd, ds,
                stages.mark)
    (mv8, skip, lv_y, lv_u, lv_v, _, _, _, lf_lvl, cdef_map, choice, _, _,
     _, _) = _fetch_packed(outs, gdense, nby, nbx)
    rec = [r.cpu().numpy().astype(np.int32) for r in outs[4:7]]
    stages.mark("fetch_unpack")
    pkt = _pack_pframe_mref(
        h, w, qindex, order_hint, mv8, choice, skip, lv_y, lv_u, lv_v,
        cdef=None if cdef is None else (cdef_prm, cdef_map),
        lf_level=lf_lvl, render_size=render_size, slot_last=slot_last,
        slot_golden=slot_golden, golden_hint=golden_hint,
        refresh_flags=refresh_flags, device=dev, timings=timings)
    return pkt, rec
