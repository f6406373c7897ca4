"""The port's C++ tile packer (rav1e_tpu_torch/csrc/packer.cpp, bridged
by entropy/native.py) against the JAX package's packer and the port's
Python TileWriter, on random decision grids made with numpy from seeds.

Each grid goes through three writers: the port's NativeTileWriter (its
IR coded on the CPU, by pack_ir_plain + finish), the reference's
rav1e_tpu.entropy.native.NativeTileWriter (numpy and C++ only, no JAX
compile) and the port's Python TileWriter over the pipelines' own
partitions/blocks dicts (tpu_intra._kf_tile_dicts,
tpu_inter._pframe_tile_dicts) with a RecordingEncoder. The three tiles
must be the same bytes, and the C++ IR must equal the Python writer's
IR row for row. The frames are 96x160 (a partial bottom SB row and a
partial right SB column) unless a case says otherwise.
"""

import numpy as np
import pytest
import torch

from rav1e_tpu_torch.core.constants import PredictionMode
from rav1e_tpu_torch.entropy import ec_cuda
from rav1e_tpu_torch.entropy.native import NativeTileWriter
from rav1e_tpu_torch.entropy.tile import TileWriter
from rav1e_tpu_torch.pipeline import tpu_inter, tpu_intra

BH, BW = 3, 5                     # 32-blocks: 96x160
QUADS = ((0, 0), (0, 1), (1, 0), (1, 1))


class _Capture(NativeTileWriter):
    """The port's packer on the CPU, keeping the IR it codes."""

    def code(self, ir):
        self.ir = ir.clone()
        return super().code(ir)


def _port(mi_rows, mi_cols, q, inter):
    return _Capture(mi_rows, mi_cols, q, inter_frame=inter, device="cpu")


def _reference(mi_rows, mi_cols, q, inter):
    from rav1e_tpu.entropy.native import NativeTileWriter as RefWriter
    return RefWriter(mi_rows, mi_cols, q, inter_frame=inter)


def _python(mi_rows, mi_cols, q, inter, dicts, cdef_map=None, cdef_bits=0):
    """The Python TileWriter's tile and its IR."""
    encs = []

    def encoder():
        encs.append(ec_cuda.RecordingEncoder("cpu"))
        return encs[-1]

    tw = TileWriter(mi_rows, mi_cols, q, inter_frame=inter, encoder=encoder)
    if cdef_bits:
        tw.cdef_bits = cdef_bits
        tw.cdef_idx_map = cdef_map.reshape((mi_rows + 15) // 16,
                                           (mi_cols + 15) // 16)
    tile = tw.write_tile(*dicts)
    return tile, encs[0].ir_tensor()


def _check(mi_rows, mi_cols, q, inter, method, args, kwargs, dicts,
           cdef_map=None, cdef_bits=0):
    port_w = _port(mi_rows, mi_cols, q, inter)
    port = getattr(port_w, method)(*args, **kwargs)
    ref = getattr(_reference(mi_rows, mi_cols, q, inter), method)(
        *args, **kwargs)
    py, py_ir = _python(mi_rows, mi_cols, q, inter, dicts, cdef_map,
                        cdef_bits)
    assert port_w.ir.shape == py_ir.shape, (port_w.ir.shape, py_ir.shape)
    assert torch.equal(port_w.ir, py_ir)
    assert port == py, (len(port), len(py))
    assert port == ref, (len(port), len(ref))
    return port_w.ir.shape[0]


def _levels(rng, shape, lim, density, big=0.0):
    """Sparse levels in [-lim, lim], with a share `big` of large ones (the
    Golomb tail)."""
    lv = np.zeros(shape, np.int16)
    m = rng.random(shape) < density
    lv[m] = rng.integers(-lim, lim + 1, int(m.sum()))
    b = m & (rng.random(shape) < big)
    lv[b] = rng.choice([-1, 1], int(b.sum())) * rng.integers(15, 400,
                                                             int(b.sum()))
    return lv


def _cdef(rng, mi_rows, mi_cols, bits):
    nsb = ((mi_rows + 15) // 16) * ((mi_cols + 15) // 16)
    return rng.integers(0, 1 << bits, nsb).astype(np.uint8)


# ---- the keyframe tile ------------------------------------------------------

def _intra_grid(rng, bh, bw, split8: bool, zero: bool = False):
    """pack_keyframe's grids: splits, the 13 kf modes (directional ones
    with angle delta 0), CfL on unsplit blocks, the quads' TX types
    (INTRA_TX_SET2 indices 1-4) and, with split8, 16->8 quads with their
    8x8 modes; levels sparse, some blocks all zero (skipped)."""
    sp = rng.random((bh, bw)) < 0.5
    my = rng.integers(0, 13, (bh, bw, 5)).astype(np.int32)
    mu = rng.integers(0, 13, (bh, bw, 5)).astype(np.int32)
    cfm = np.zeros((bh, bw, 2), np.int32)
    cfl_on = ~sp & (rng.random((bh, bw)) < 0.5)
    mu[..., 0][cfl_on] = int(PredictionMode.UV_CFL_PRED)
    cfm[cfl_on] = rng.integers(-16, 17, (int(cfl_on.sum()), 2))
    both0 = cfl_on & (cfm[..., 0] == 0) & (cfm[..., 1] == 0)
    cfm[..., 0][both0] = 3
    ytx = rng.integers(1, 5, (bh, bw, 4)).astype(np.int32)
    s16 = (sp[..., None] & (rng.random((bh, bw, 4)) < 0.5)) if split8 \
        else np.zeros((bh, bw, 4), bool)
    ym8 = rng.integers(0, 13, (bh, bw, 4, 4)).astype(np.int32)
    uvm8 = rng.integers(0, 13, (bh, bw, 4, 4)).astype(np.int32)
    ly = _levels(rng, (bh, bw, 32, 32), 6, 0.15, 0.01)
    lu = _levels(rng, (bh, bw, 16, 16), 4, 0.1, 0.01)
    lvv = _levels(rng, (bh, bw, 16, 16), 4, 0.1, 0.01)
    ly[rng.random((bh, bw)) < 0.25] = 0
    # some 8x8 children and some 16x16 quads with no levels at all
    for bi in range(bh):
        for bj in range(bw):
            for q, (qr, qc) in enumerate(QUADS):
                if rng.random() < 0.3:
                    ly[bi, bj, 16 * qr:16 * qr + 16, 16 * qc:16 * qc + 16] = 0
                    lu[bi, bj, 8 * qr:8 * qr + 8, 8 * qc:8 * qc + 8] = 0
                    lvv[bi, bj, 8 * qr:8 * qr + 8, 8 * qc:8 * qc + 8] = 0
    if zero:
        ly[:], lu[:], lvv[:] = 0, 0, 0
    return sp, my, mu, cfm, ytx, s16, ym8, uvm8, ly, lu, lvv


def _check_intra(rng, q, split8, cdef_bits, bh=BH, bw=BW, zero=False):
    mi_rows, mi_cols = bh * 8, bw * 8
    g = _intra_grid(rng, bh, bw, split8, zero)
    sp, my, mu, cfm, ytx, s16, ym8, uvm8, ly, lu, lvv = g
    cmap = _cdef(rng, mi_rows, mi_cols, cdef_bits) if cdef_bits else None
    any8 = bool(s16.any())
    args = (sp.reshape(-1), my.reshape(-1, 5), mu.reshape(-1, 5),
            cfm.reshape(-1, 2), ly.reshape(-1, 32, 32),
            lu.reshape(-1, 16, 16), lvv.reshape(-1, 16, 16))
    kwargs = dict(cdef_idx=cmap, cdef_bits=cdef_bits,
                  ytx=ytx.reshape(-1, 4), split16=s16 if any8 else None,
                  ym8=ym8 if any8 else None, uvm8=uvm8 if any8 else None)
    dicts = tpu_intra._kf_tile_dicts(*g, mi_rows, mi_cols)
    return _check(mi_rows, mi_cols, q, False, "write_intra_tile_fast", args,
                  kwargs, dicts, cmap, cdef_bits), g


@pytest.mark.parametrize("seed,q,split8,cdef_bits", [
    (0, 100, True, 3), (1, 60, True, 2), (2, 160, False, 0)])
def test_intra_tile(seed, q, split8, cdef_bits):
    """A keyframe tile with splits, CfL, directional modes, the quads' TX
    types, the 16->8 split with its 8x8 modes and a CDEF index map."""
    rows, g = _check_intra(np.random.default_rng(seed), q, split8,
                           cdef_bits)
    sp, my, mu, _, ytx, s16 = g[:6]
    assert sp.any() and (mu[..., 0][~sp] == 13).any()
    assert (my >= 3).any() and len(np.unique(ytx[sp])) > 1
    assert s16.any() == split8
    assert rows > 1000


# ---- the P-frame tiles ------------------------------------------------------

def _mvs(rng, shape):
    """Quarter-pel MVs in 1/8 units, some zero (GLOBALMV)."""
    mv = (rng.integers(-48, 49, shape + (2,)) * 2).astype(np.int32)
    mv[rng.random(shape) < 0.3] = 0
    return mv


def _inter_grid(rng, nby, nbx, split=False, split8=False, intra=False,
                merge=False):
    """_fetch_packed's decisions as the P step leaves them: skipped
    blocks, quads and 8x8 children carry no levels; intra blocks and
    the blocks of a merged 64x64 SB do not split; a merged SB's levels
    sit in its TL child (luma) and its four children (chroma)."""
    B = nby * nbx
    mv8, mv16 = _mvs(rng, (B,)), _mvs(rng, (B, 4))
    skip = rng.random(B) < 0.3
    skip16 = rng.random((B, 4)) < 0.3
    skip8 = rng.random((B, 4, 4)) < 0.3
    sp = (rng.random(B) < 0.5) if split else np.zeros(B, bool)
    intra32 = (rng.random(B) < 0.25) if intra else np.zeros(B, bool)
    nr, nc = (nby + 1) // 2, (nbx + 1) // 2
    b64 = np.zeros((nr, nc), bool)
    if merge:
        for r in range(nby // 2):
            for c in range(nbx // 2):
                b64[r, c] = rng.random() < 0.6
    inb64 = np.repeat(np.repeat(b64, 2, 0), 2, 1)[:nby, :nbx].reshape(-1)
    intra32 &= ~inb64
    sp &= ~intra32 & ~inb64
    s16 = (sp[:, None] & (rng.random((B, 4)) < 0.5)) if split8 \
        else np.zeros((B, 4), bool)
    lv_y = _levels(rng, (B, 32, 32), 40, 0.1, 0.01)
    lv_u = _levels(rng, (B, 16, 16), 20, 0.1, 0.01)
    lv_v = _levels(rng, (B, 16, 16), 20, 0.1, 0.01)
    for b in range(B):
        if inb64[b]:
            continue
        if sp[b]:
            for q, (qr, qc) in enumerate(QUADS):
                y0, x0, c0, d0 = 16 * qr, 16 * qc, 8 * qr, 8 * qc
                if s16[b, q]:
                    for s, (sr, sc) in enumerate(QUADS):
                        if skip8[b, q, s]:
                            lv_y[b, y0 + 8 * sr:y0 + 8 * sr + 8,
                                 x0 + 8 * sc:x0 + 8 * sc + 8] = 0
                            for lv in (lv_u, lv_v):
                                lv[b, c0 + 4 * sr:c0 + 4 * sr + 4,
                                   d0 + 4 * sc:d0 + 4 * sc + 4] = 0
                elif skip16[b, q]:
                    lv_y[b, y0:y0 + 16, x0:x0 + 16] = 0
                    lv_u[b, c0:c0 + 8, d0:d0 + 8] = 0
                    lv_v[b, c0:c0 + 8, d0:d0 + 8] = 0
        elif skip[b]:
            lv_y[b], lv_u[b], lv_v[b] = 0, 0, 0
    for r, c in zip(*np.nonzero(b64)):
        tl = 2 * r * nbx + 2 * c
        kids = [tl, tl + 1, tl + nbx, tl + nbx + 1]
        if skip[tl]:
            lv_u[kids], lv_v[kids] = 0, 0
            lv_y[tl] = 0
    mvq8 = np.repeat(mv16[:, :, None, :], 4, axis=2)
    return dict(split=sp, mv8=mv8, skip=skip, mv16=mv16, skip16=skip16,
                lv_y=lv_y, lv_u=lv_u, lv_v=lv_v, intra32=intra32, b64=b64,
                split16=s16, mvq8=mvq8, skip8=skip8)


def _dicts(g, w, uniform=False):
    if uniform:
        return tpu_inter._pframe_tile_dicts(
            w, g["mv8"], g["skip"], g["lv_y"], g["lv_u"], g["lv_v"], None,
            None, None, None, None, None, None)
    return tpu_inter._pframe_tile_dicts(
        w, g["mv8"], g["skip"], g["lv_y"], g["lv_u"], g["lv_v"], g["split"],
        g["mv16"], g["skip16"], g["intra32"] if g["intra32"].any() else None,
        g["b64"] if g["b64"].any() else None,
        g["split16"] if g["split16"].any() else None, g["skip8"])


def _check_fast(rng, q, nby=BH, nbx=BW, all_skip=False):
    g = _inter_grid(rng, nby, nbx)
    if all_skip:
        g["skip"][:] = True
        for k in ("lv_y", "lv_u", "lv_v"):
            g[k][:] = 0
    args = (g["mv8"], g["skip"], g["lv_y"], g["lv_u"], g["lv_v"])
    return _check(nby * 8, nbx * 8, q, True, "write_inter_tile_fast", args,
                  {}, _dicts(g, nbx * 32, uniform=True))


@pytest.mark.parametrize("seed,q", [(10, 100), (11, 30)])
def test_inter_tile_fast(seed, q):
    """write_inter_tile_fast: uniform 32-blocks, NEWMV and GLOBALMV,
    skipped and coded blocks."""
    assert _check_fast(np.random.default_rng(seed), q) > 500


@pytest.mark.parametrize("seed,q,tools,cdef_bits", [
    (20, 100, ("split",), 0),
    (21, 60, ("split", "split8"), 2),
    (22, 100, ("split", "split8", "intra", "merge"), 3),
    (23, 160, ("intra", "merge"), 1),
    (24, 100, ("split", "split8", "intra", "merge"), 3)])
def test_inter_tile_fast2(seed, q, tools, cdef_bits):
    """write_inter_tile_fast2 with the split, 16->8 (mvq8 repeated from
    mv16, per-8 skips), intra-in-inter, the 64x64 merge map and a CDEF
    index map. Seed 24 runs at 128x192, where every SB is whole."""
    rng = np.random.default_rng(seed)
    nby, nbx = (4, 6) if seed == 24 else (BH, BW)
    g = _inter_grid(rng, nby, nbx, split="split" in tools,
                    split8="split8" in tools, intra="intra" in tools,
                    merge="merge" in tools)
    mi_rows, mi_cols = nby * 8, nbx * 8
    cmap = _cdef(rng, mi_rows, mi_cols, cdef_bits) if cdef_bits else None
    s8 = g["split16"].any()
    kwargs = dict(cdef_idx=cmap, cdef_bits=cdef_bits,
                  intra32=g["intra32"] if g["intra32"].any() else None,
                  b64=g["b64"] if g["b64"].any() else None,
                  split16=g["split16"] if s8 else None,
                  mvq8=g["mvq8"] if s8 else None,
                  skip8=g["skip8"] if s8 else None)
    args = tuple(g[k] for k in ("split", "mv8", "skip", "mv16", "skip16",
                                "lv_y", "lv_u", "lv_v"))
    _check(mi_rows, mi_cols, q, True, "write_inter_tile_fast2", args,
           kwargs, _dicts(g, nbx * 32), cmap, cdef_bits)
    for t, k in (("split", "split"), ("split8", "split16"),
                 ("intra", "intra32"), ("merge", "b64")):
        assert g[k].any() == (t in tools), t


@pytest.mark.parametrize("kind", ["inter", "intra"])
def test_all_skip_tile(kind):
    """A tile with no level anywhere: every P block skipped, or every
    keyframe block coded with no coefficients."""
    rng = np.random.default_rng(30)
    if kind == "inter":
        rows = _check_fast(rng, 100, all_skip=True)
    else:
        rows, _ = _check_intra(rng, 100, True, 0, zero=True)
    assert rows > 0


def test_per_symbol_write_tile():
    """NativeTileWriter.write_tile, the per-symbol route (the Python walk,
    each symbol recorded in C++), on a keyframe grid with 16->8 quads."""
    rng = np.random.default_rng(40)
    g = _intra_grid(rng, BH, BW, True)
    mi_rows, mi_cols = BH * 8, BW * 8
    dicts = tpu_intra._kf_tile_dicts(*g, mi_rows, mi_cols)
    w = _port(mi_rows, mi_cols, 100, False)
    tile = w.write_tile(*dicts)
    py, py_ir = _python(mi_rows, mi_cols, 100, False, dicts)
    assert torch.equal(w.ir, py_ir) and tile == py


def test_ir_buffer_too_small_raises():
    """An IR buffer smaller than the tile raises; it never truncates. The
    writer's C++ state is freed either way."""
    rng = np.random.default_rng(50)
    g = _inter_grid(rng, BH, BW)
    args = (g["mv8"], g["skip"], g["lv_y"], g["lv_u"], g["lv_v"])
    w = _port(BH * 8, BW * 8, 100, True)
    w.ir_cap = 16
    with pytest.raises(ValueError, match="IR has .* rows; the buffer "
                                         "holds 16"):
        w.write_inter_tile_fast(*args)
    assert w._h is None
    ok = _port(BH * 8, BW * 8, 100, True)
    ok.write_inter_tile_fast(*args)
    assert ok.ir.shape[0] > 16
