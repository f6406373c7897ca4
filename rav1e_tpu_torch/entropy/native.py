"""ctypes bridge to the port's C++ tile packer (csrc/packer.cpp).

A copy of the JAX package's entropy/native.py. NativeTileWriter mirrors
TileWriter: the tile syntax, the CDF adaptation and all coefficient
coding run in C++, which records the tile as od_ec symbol IR, the
(fl, fh, cu, cv) rows of entropy/ec_cuda.py's RecordingEncoder, row for
row the IR the Python TileWriter records (tests/test_torch_packer.py).
The IR is handed back in one contiguous int32 [n, 4] host buffer (pinned
when the writer's device is cuda) and range-coded by
ec_cuda.pack_symbols on the writer's `device`: the od_ec kernels on
cuda, pack_ir_plain + finish on the CPU. The write_*_fast methods walk a
whole tile in one C++ call; `write_tile` keeps the per-symbol route
(mode-level symbols cross the FFI one at a time, each transform unit's
coefficients in one call).

CDF state lives in C++; the Python-side TileCDFs lists are kept adapted
in lockstep so derived CDFs (partition split bools) and any Python-side
rate estimation read correct values.

The library builds with g++ at first use into rav1e_tpu_torch/build/
(nvcc.build_host); a missing compiler or a failed build raises. With
RAV1E_TPU_TORCH_PACKER_SAN=1 it builds and loads an ASAN + UBSAN
instrumented packer instead (tests/test_torch_packer_asan.py).
"""

from __future__ import annotations

import ctypes as C
import os

import numpy as np
import torch

from rav1e_tpu_torch import nvcc, trace
from rav1e_tpu_torch.core.constants import BlockSize, PartitionType, TxSize
from rav1e_tpu_torch.device import resolve_device
from rav1e_tpu_torch.entropy import coeffs as coeffmod
from rav1e_tpu_torch.entropy.ec import update_cdf
from rav1e_tpu_torch.entropy.ec_cuda import pack_symbols
from rav1e_tpu_torch.entropy.tile import (
    INTER_TX_SET1,
    INTER_TX_SET2,
    INTER_TX_SET3,
    INTRA_TX_SET1,
    INTRA_TX_SET2,
    TileWriter,
    _sqr_idx,
    _sqr_up_idx,
    intra_tx_set,
)

SRC = nvcc.CSRC / "packer.cpp"
SAN_FLAGS = ["-O1", "-g", "-fsanitize=address,undefined",
             "-fno-sanitize-recover=all", "-shared", "-fPIC", "-std=c++17"]

_I32P = C.POINTER(C.c_int32)
_U8P = C.POINTER(C.c_uint8)
_I16P = C.POINTER(C.c_int16)


def _bind(lib):
    lib.packer_new.restype = C.c_void_p
    lib.packer_free.argtypes = [C.c_void_p]
    lib.packer_add_family.argtypes = [C.c_void_p, _I32P, C.c_int, C.c_int]
    lib.packer_symbol.argtypes = [C.c_void_p, C.c_int, C.c_int, C.c_int]
    lib.packer_symbol_noadapt_raw.argtypes = [
        C.c_void_p, C.c_int, _I32P, C.c_int]
    lib.packer_bool.argtypes = [C.c_void_p, C.c_int, C.c_int]
    lib.packer_literal.argtypes = [C.c_void_p, C.c_int, C.c_int]
    lib.packer_split_bool.argtypes = [C.c_void_p, C.c_int, C.c_int, C.c_int,
                                      _I32P, C.c_int]
    lib.packer_coeffs.restype = C.c_int
    lib.packer_coeffs.argtypes = [C.c_void_p] + [C.c_int] * 23 + [_I32P]
    lib.packer_inter_tile2.restype = C.c_long
    lib.packer_inter_tile2.argtypes = [
        C.c_void_p, C.c_int, C.c_int, _I32P, _U8P, _I32P, _U8P, _I32P, _U8P,
        _I16P, _I16P, _I16P, _U8P, C.c_int, _U8P, _U8P, _U8P, _I32P, _U8P]
    lib.packer_intra_tile.restype = C.c_long
    lib.packer_intra_tile.argtypes = [
        C.c_void_p, C.c_int, C.c_int, _I32P, _U8P, _U8P, _U8P,
        C.POINTER(C.c_int8), _I16P, _I16P, _I16P, _U8P, C.c_int, _U8P, _U8P,
        _U8P, _U8P]
    lib.packer_rows.restype = C.c_long
    lib.packer_rows.argtypes = [C.c_void_p]
    lib.packer_done.restype = C.c_long
    lib.packer_done.argtypes = [C.c_void_p, _I32P, C.c_long]


def _load():
    san = bool(os.environ.get("RAV1E_TPU_TORCH_PACKER_SAN"))
    return nvcc.load(SRC, _bind, SAN_FLAGS if san else nvcc.HOST_FLAGS)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(C.POINTER(ctype))


def _flatten_records(node, out):
    """Yield leaf records (lists ending with counter) in nesting order."""
    if isinstance(node, list) and node and isinstance(node[0], int):
        out.append(node)
    else:
        for sub in node:
            _flatten_records(sub, out)


class _FamilyMap:
    """Registers one TileCDFs table as a native family; maps Python
    record identity -> (family id, record index)."""

    def __init__(self, lib, handle, table, by_id: dict):
        recs: list = []
        _flatten_records(table, recs)
        nsym = len(recs[0]) - 1  # drop counter slot
        flat = np.zeros((len(recs), nsym), np.int32)
        for i, r in enumerate(recs):
            assert len(r) - 1 == nsym
            flat[i] = r[:-1]
        self.fam = lib.packer_add_family(
            handle, flat.ctypes.data_as(C.POINTER(C.c_int32)),
            len(recs), nsym)
        for i, r in enumerate(recs):
            by_id[id(r)] = (self.fam, i)


class _NativeEC:
    """Adapter with the ECEncoder interface, routing into C++."""

    def __init__(self, lib, handle, by_id):
        self._lib = lib
        self._h = handle
        self._by_id = by_id

    def encode_symbol(self, s, icdf, adapt=True):
        key = id(icdf)
        fam = self._by_id.get(key)
        if fam is not None and adapt:
            self._lib.packer_symbol(self._h, fam[0], fam[1], int(s))
            update_cdf(icdf, s)  # keep python mirror in lockstep
        else:
            arr = (C.c_int32 * (len(icdf) - 1))(*icdf[:-1])
            self._lib.packer_symbol_noadapt_raw(
                self._h, int(s), arr, len(icdf) - 1)
            if adapt:
                update_cdf(icdf, s)

    def encode_bool(self, val, f):
        self._lib.packer_bool(self._h, int(val), int(f))

    def encode_literal(self, value, nbits):
        self._lib.packer_literal(self._h, int(value), int(nbits))


class NativeTileWriter(TileWriter):
    """TileWriter with the C++ packer. `device` codes the IR (None:
    cuda, resolved when the tile is coded); `timings`, when given,
    receives tile_walk (the C++ walk and the IR's hand-back; its work
    count the IR rows), ir_upload, ec_kernel (the upload included) and
    finish (trace.stages). With ir_only the write_* methods return the
    tile's IR (int32 [n, 4] on the host, pinned for cuda) uncoded, for
    ec_cuda.pack_tile_irs to code a frame's tiles in one launch; the
    caller, which codes them, times the frame's walk. `ir_cap` sets the
    IR buffer's rows (None: the tile's own count); a buffer too small for
    the tile raises ValueError."""

    ir_cap: int | None = None

    def __init__(self, *a, device=None, timings: dict | None = None,
                 ir_only: bool = False, **k):
        super().__init__(*a, **k)
        self.device = device
        self.timings = timings
        self.ir_only = ir_only
        lib = _load()
        self._lib = lib
        self._h = lib.packer_new()
        by_id: dict = {}
        c = self.cdfs
        self._fam = {}
        for name, table in [
            ("partition_8", c.partition_8), ("partition_mid", c.partition_mid),
            ("partition_128", c.partition_128), ("kf_y_mode", c.kf_y_mode),
            ("y_mode", c.y_mode), ("uv_mode", c.uv_mode),
            ("uv_mode_cfl", c.uv_mode_cfl), ("angle_delta", c.angle_delta),
            ("skip", c.skip), ("cfl_sign", [c.cfl_sign]),
            ("cfl_alpha", c.cfl_alpha), ("seg_tree", c.seg_tree),
            ("tx_size_8", c.tx_size_8), ("tx_size", c.tx_size),
            ("intra_ext_tx1", c.intra_ext_tx1),
            ("intra_ext_tx2", c.intra_ext_tx2),
            ("inter_ext_tx1", c.inter_ext_tx1),
            ("inter_ext_tx2", c.inter_ext_tx2),
            ("inter_ext_tx3", c.inter_ext_tx3),
            ("intra_inter", c.intra_inter), ("newmv", c.newmv),
            ("zeromv", c.zeromv), ("refmv", c.refmv), ("drl", c.drl),
            ("single_ref", c.single_ref),
            ("mv_joint", [c.mv_joint]),
            ("mv0_sign", [c.mv_comp[0]["sign"]]),
            ("mv0_classes", [c.mv_comp[0]["classes"]]),
            ("mv0_class0", [c.mv_comp[0]["class0"]]),
            ("mv0_class0_fr", c.mv_comp[0]["class0_fr"]),
            ("mv0_bits", c.mv_comp[0]["bits"]),
            ("mv0_fr", [c.mv_comp[0]["fr"]]),
            ("mv1_sign", [c.mv_comp[1]["sign"]]),
            ("mv1_classes", [c.mv_comp[1]["classes"]]),
            ("mv1_class0", [c.mv_comp[1]["class0"]]),
            ("mv1_class0_fr", c.mv_comp[1]["class0_fr"]),
            ("mv1_bits", c.mv_comp[1]["bits"]),
            ("mv1_fr", [c.mv_comp[1]["fr"]]),
            ("txb_skip", c.txb_skip),
            ("eob_pt_16", c.eob_pt[16]), ("eob_pt_32", c.eob_pt[32]),
            ("eob_pt_64", c.eob_pt[64]), ("eob_pt_128", c.eob_pt[128]),
            ("eob_pt_256", c.eob_pt[256]), ("eob_pt_512", c.eob_pt[512]),
            ("eob_pt_1024", c.eob_pt[1024]),
            ("eob_hi_bit", c.eob_hi_bit),
            ("coeff_base_eob", c.coeff_base_eob),
            ("coeff_base", c.coeff_base), ("coeff_br", c.coeff_br),
            ("dc_sign", c.dc_sign),
        ]:
            self._fam[name] = _FamilyMap(lib, self._h, table, by_id)
        self._by_id = by_id
        self.ec = _NativeEC(lib, self._h, by_id)

    def _write_tu(self, plane, mi_r, mi_c, tx: TxSize, tx_type, levels,
                  mode, is_inter: bool = False):
        ss = 0 if plane == 0 else 1
        u_c = mi_c >> ss
        u_r = mi_r >> ss
        uw = tx.width >> 2
        uh = tx.height >> 2
        above = self.above_coef[plane]
        left = self.left_coef[plane]
        a_span = above[u_c: u_c + uw]
        l_span = left[u_r: u_r + uh]
        if plane == 0:
            skip_ctx = 0
        else:
            skip_ctx = 7 + int(bool(a_span.any())) + int(bool(l_span.any()))
        dcs = 0
        for b in a_span:
            cat = int(b) >> 6
            dcs += 1 if cat == 2 else (-1 if cat == 1 else 0)
        for b in l_span:
            cat = int(b) >> 6
            dcs += 1 if cat == 2 else (-1 if cat == 1 else 0)
        dc_sign_ctx = 0 if dcs == 0 else (1 if dcs < 0 else 2)

        ptype = 0 if plane == 0 else 1
        tctx = coeffmod.txs_ctx(tx)
        tclass = coeffmod.tx_class(tx_type)
        n_pels = min(tx.width, 32) * min(tx.height, 32)
        eob_key = max(n_pels, 16)
        eob_fam = self._fam[f"eob_pt_{eob_key}"].fam
        # eob record index: [ptype][emctx] or [ptype] for 512/1024
        emctx = 0 if tclass == coeffmod.TX_CLASS_2D else 1
        if eob_key >= 512:
            eob_rec = ptype
        else:
            eob_rec = ptype * 2 + emctx
        txtype_fam = -1
        txtype_rec = 0
        txtype_sym = 0
        if plane == 0 and is_inter:
            # spec get_tx_set (inter) + read_tx_type (see tile.py)
            if self.base_q_idx != 0 and _sqr_up_idx(tx) <= 3:
                if self.reduced_tx_set or _sqr_up_idx(tx) == 3:
                    order, name = INTER_TX_SET3, "inter_ext_tx3"
                elif tx.sqr == TxSize.TX_16X16:
                    order, name = INTER_TX_SET2, "inter_ext_tx2"
                else:
                    order, name = INTER_TX_SET1, "inter_ext_tx1"
                txtype_sym = order.index(tx_type)
                txtype_fam = self._fam[name].fam
                txtype_rec = _sqr_idx(tx)
        elif plane == 0:
            s = intra_tx_set(tx, self.reduced_tx_set)
            if s != 0 and self.base_q_idx != 0:
                order = INTRA_TX_SET1 if s == 1 else INTRA_TX_SET2
                txtype_sym = order.index(tx_type)
                sqr = _sqr_up_idx(tx.sqr)
                name = "intra_ext_tx1" if s == 1 else "intra_ext_tx2"
                txtype_fam = self._fam[name].fam
                txtype_rec = sqr * 13 + int(mode)
        lv = np.ascontiguousarray(levels, np.int32)
        cul = self._lib.packer_coeffs(
            self._h, ptype, tx.width, tx.height, tctx, min(tctx, 3),
            tclass, eob_fam, eob_rec,
            self._fam["eob_hi_bit"].fam, (tctx * 2 + ptype) * 11,
            self._fam["txb_skip"].fam, tctx * 13 + skip_ctx,
            self._fam["coeff_base_eob"].fam, (tctx * 2 + ptype) * 4,
            self._fam["coeff_base"].fam, (tctx * 2 + ptype) * 41,
            self._fam["coeff_br"].fam, (min(tctx, 3) * 2 + ptype) * 21,
            self._fam["dc_sign"].fam, ptype * 3 + dc_sign_ctx,
            txtype_fam, txtype_rec, txtype_sym,
            lv.ctypes.data_as(C.POINTER(C.c_int32)))
        above[u_c: u_c + uw] = cul
        left[u_r: u_r + uh] = cul

    def write_partition(self, r, c, bsize, part):
        has_rows = r + bsize.height_mi // 2 < self.mi_rows
        has_cols = c + bsize.width_mi // 2 < self.mi_cols
        if has_rows and has_cols:
            return super().write_partition(r, c, bsize, part)
        if not has_rows and not has_cols:
            assert part == PartitionType.SPLIT
            return
        ctx = self._part_ctx(r, c, bsize)
        icdf, nsym = self._partition_cdf(ctx, bsize)
        fam, rec = self._by_id[id(icdf)]
        if has_cols:
            ks = [PartitionType.VERT, PartitionType.SPLIT,
                  PartitionType.HORZ_A, PartitionType.VERT_A,
                  PartitionType.VERT_B, PartitionType.VERT_4]
        else:
            ks = [PartitionType.HORZ, PartitionType.SPLIT,
                  PartitionType.HORZ_A, PartitionType.HORZ_B,
                  PartitionType.VERT_A, PartitionType.HORZ_4]
        arr = (C.c_int32 * len(ks))(*[int(k) for k in ks])
        bit = 1 if part == PartitionType.SPLIT else 0
        self._lib.packer_split_bool(self._h, fam, rec, bit, arr, len(ks))

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self._lib.packer_free(self._h)
            self._h = None

    def _finish(self) -> bytes | torch.Tensor:
        """The recorded IR, handed back into one host buffer, then coded
        on the writer's device (returned uncoded with ir_only). Frees the
        C++ state."""
        try:
            ir = self._take_ir()
        finally:
            self._lib.packer_free(self._h)
            self._h = None
        self._stages.mark("tile_walk", int(ir.shape[0]))
        return ir if self.ir_only else self.code(ir)

    def _walk_stages(self):
        """The recorder of a walk that starts now: an IR-only walk is
        its caller's to time."""
        if self.ir_only:
            return trace.OFF
        return trace.stages(resolve_device(self.device), self.timings)

    def _take_ir(self) -> torch.Tensor:
        n = int(self._lib.packer_rows(self._h))
        cap = n if self.ir_cap is None else int(self.ir_cap)
        pin = resolve_device(self.device).type == "cuda"
        ir = torch.empty((cap, 4), dtype=torch.int32, pin_memory=pin)
        got = self._lib.packer_done(
            self._h, C.cast(ir.data_ptr(), _I32P), cap)
        if got < 0:
            raise ValueError(f"the tile's IR has {-got} rows; the buffer "
                             f"holds {cap}")
        return ir[:got]

    def code(self, ir: torch.Tensor) -> bytes:
        """Range-code the tile's IR [n, 4] on the writer's device."""
        return pack_symbols(ir, self.device, self.timings)

    def write_intra_tile_fast(self, split: np.ndarray,
                              ymodes: np.ndarray, uvmodes: np.ndarray,
                              cfl: np.ndarray, lv_y: np.ndarray,
                              lv_u: np.ndarray, lv_v: np.ndarray,
                              cdef_idx: np.ndarray | None = None,
                              cdef_bits: int = 0,
                              ytx: np.ndarray | None = None,
                              split16: np.ndarray | None = None,
                              ym8: np.ndarray | None = None,
                              uvm8: np.ndarray | None = None) -> bytes:
        """One-call C++ walk of a KEY-frame tile from the batched
        keyframe pipeline's outputs (32-blocks, 4x16 splits or 16->8
        sub-splits, kf modes, CfL alphas, quadrant-packed levels).
        Byte-identical to write_tile over the equivalent
        partitions/blocks dicts."""
        self._stages = self._walk_stages()
        fam = self._fam
        order = ["partition_mid", "skip", "kf_y_mode", "angle_delta",
                 "uv_mode_cfl", "cfl_sign", "cfl_alpha",
                 "intra_ext_tx2", "eob_pt_1024", "eob_pt_256",
                 "eob_pt_64", "eob_hi_bit", "txb_skip",
                 "coeff_base_eob", "coeff_base", "coeff_br", "dc_sign",
                 "partition_8", "eob_pt_16"]
        fam_ids = np.asarray([fam[n].fam for n in order], np.int32)
        split = np.ascontiguousarray(split, np.uint8).reshape(-1)
        ymodes = np.ascontiguousarray(ymodes, np.uint8).reshape(-1)
        uvmodes = np.ascontiguousarray(uvmodes, np.uint8).reshape(-1)
        cfl = np.ascontiguousarray(cfl, np.int8).reshape(-1)
        lv_y = np.ascontiguousarray(lv_y, np.int16)
        lv_u = np.ascontiguousarray(lv_u, np.int16)
        lv_v = np.ascontiguousarray(lv_v, np.int16)
        nsb = ((self.mi_rows + 15) // 16) * ((self.mi_cols + 15) // 16)
        cdef_map = np.ascontiguousarray(
            cdef_idx if cdef_idx is not None else np.zeros(nsb),
            np.uint8).reshape(-1)
        ytx_arr = np.ascontiguousarray(
            ytx if ytx is not None
            else np.ones((split.size, 4)), np.uint8).reshape(-1)
        s16_arr = np.ascontiguousarray(
            split16 if split16 is not None
            else np.zeros((split.size, 4)), np.uint8).reshape(-1)
        ym8_arr = np.ascontiguousarray(
            ym8 if ym8 is not None
            else np.zeros((split.size, 16)), np.uint8).reshape(-1)
        uvm8_arr = np.ascontiguousarray(
            uvm8 if uvm8 is not None
            else np.zeros((split.size, 16)), np.uint8).reshape(-1)
        self._lib.packer_intra_tile(
            self._h, self.mi_rows, self.mi_cols, _ptr(fam_ids, C.c_int32),
            _ptr(split, C.c_uint8), _ptr(ymodes, C.c_uint8),
            _ptr(uvmodes, C.c_uint8), _ptr(cfl, C.c_int8),
            _ptr(lv_y, C.c_int16), _ptr(lv_u, C.c_int16),
            _ptr(lv_v, C.c_int16), _ptr(cdef_map, C.c_uint8),
            int(cdef_bits), _ptr(ytx_arr, C.c_uint8),
            _ptr(s16_arr, C.c_uint8), _ptr(ym8_arr, C.c_uint8),
            _ptr(uvm8_arr, C.c_uint8))
        return self._finish()

    def write_inter_tile_fast2(self, split: np.ndarray, mv8: np.ndarray,
                               skip32: np.ndarray, mv16: np.ndarray,
                               skip16: np.ndarray, lv_y: np.ndarray,
                               lv_u: np.ndarray,
                               lv_v: np.ndarray,
                               cdef_idx: np.ndarray | None = None,
                               cdef_bits: int = 0,
                               intra32: np.ndarray | None = None,
                               b64: np.ndarray | None = None,
                               split16: np.ndarray | None = None,
                               mvq8: np.ndarray | None = None,
                               skip8: np.ndarray | None = None
                               ) -> bytes:
        """One-call C++ walk of a mixed 32/16/8-partition P-frame tile
        (PARTITION_SPLIT 32-blocks carry four 16x16 sub-blocks in
        quadrant layout; split16 further splits a 16 into four 8x8
        blocks — mvq8/skip8 are [B, 4, 4(,2)] in (quad, subquad)
        order, levels packed into the same quadrant planes; intra32
        flags 32-blocks coded as DC intra; b64 marks 64x64
        PARTITION_NONE SBs). Byte-identical to write_tile over the
        equivalent partitions/blocks dicts."""
        self._stages = self._walk_stages()
        fam = self._fam
        order = ["partition_mid", "skip", "intra_inter", "single_ref",
                 "newmv", "zeromv", "refmv", "drl", "mv_joint",
                 "mv0_sign", "mv0_classes", "mv0_class0",
                 "mv0_class0_fr", "mv0_bits", "mv0_fr",
                 "mv1_sign", "mv1_classes", "mv1_class0",
                 "mv1_class0_fr", "mv1_bits", "mv1_fr",
                 "inter_ext_tx3", "eob_pt_256", "eob_pt_1024",
                 "eob_hi_bit", "txb_skip", "coeff_base_eob",
                 "coeff_base", "coeff_br", "dc_sign", "eob_pt_64",
                 "y_mode", "uv_mode_cfl"]
        if split16 is not None:
            order += ["eob_pt_16", "partition_8"]
        fam_ids = np.asarray([fam[n].fam for n in order], np.int32)
        split = np.ascontiguousarray(split, np.uint8)
        mv8 = np.ascontiguousarray(mv8, np.int32)
        skip32 = np.ascontiguousarray(skip32, np.uint8)
        mv16 = np.ascontiguousarray(mv16, np.int32)
        skip16 = np.ascontiguousarray(skip16, np.uint8)
        lv_y = np.ascontiguousarray(lv_y, np.int16)
        lv_u = np.ascontiguousarray(lv_u, np.int16)
        lv_v = np.ascontiguousarray(lv_v, np.int16)
        nsb = ((self.mi_rows + 15) // 16) * ((self.mi_cols + 15) // 16)
        cdef_map = np.ascontiguousarray(
            cdef_idx if cdef_idx is not None else np.zeros(nsb),
            np.uint8).reshape(-1)
        intra_arr = np.ascontiguousarray(
            intra32 if intra32 is not None
            else np.zeros(split.size), np.uint8).reshape(-1)
        b64_arr = np.ascontiguousarray(
            b64 if b64 is not None else np.zeros(nsb),
            np.uint8).reshape(-1)
        if split16 is not None:
            s16_arr = np.ascontiguousarray(split16, np.uint8).reshape(-1)
            mvq8_arr = np.ascontiguousarray(mvq8, np.int32).reshape(-1)
            skip8_arr = np.ascontiguousarray(skip8, np.uint8).reshape(-1)
            s16_p = _ptr(s16_arr, C.c_uint8)
            mvq8_p = _ptr(mvq8_arr, C.c_int32)
            skip8_p = _ptr(skip8_arr, C.c_uint8)
        else:
            s16_p = _U8P()
            mvq8_p = _I32P()
            skip8_p = _U8P()
        self._lib.packer_inter_tile2(
            self._h, self.mi_rows, self.mi_cols, _ptr(fam_ids, C.c_int32),
            _ptr(split, C.c_uint8), _ptr(mv8, C.c_int32),
            _ptr(skip32, C.c_uint8), _ptr(mv16, C.c_int32),
            _ptr(skip16, C.c_uint8), _ptr(lv_y, C.c_int16),
            _ptr(lv_u, C.c_int16), _ptr(lv_v, C.c_int16),
            _ptr(cdef_map, C.c_uint8), int(cdef_bits),
            _ptr(intra_arr, C.c_uint8), _ptr(b64_arr, C.c_uint8),
            s16_p, mvq8_p, skip8_p)
        return self._finish()

    def write_tile(self, partitions, blocks) -> bytes:
        """The per-symbol route: the Python walk, each symbol recorded
        in C++."""
        self._stages = self._walk_stages()
        for r in range(0, self.mi_rows, 16):
            self.left_part[:] = 0
            for c in range(0, self.mi_cols, 16):
                self.write_sb_tree(r, c, BlockSize.B64X64,
                                   partitions, blocks)
        return self._finish()
