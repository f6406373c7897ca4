"""Tile-parallel P-frame encoding over a list of devices (the port of
rav1e_tpu/parallel/tile_encode.py).

AV1 tiles are the natural shard boundary: per-tile entropy state is
independent by spec. The frame's SB columns shard over the devices as T
tile columns (parallel/tiles.py::ShardGroup, the reference's shard_map
over the mesh's 'tile' axis); each shard runs on its own thread and, on
a CUDA device, its own stream. The reference planes are copied to every
shard's device whole, so the motion search needs no halo (each block
gathers its own search window from them: the tile-sharded branch of
pipeline/tpu_inter.py::_search_fullpel). The in-loop deblock and CDEF
cross tile boundaries as the spec demands: halo columns copied from the
neighbours' devices (the reference's ppermute) and boundary edges
computed by both neighbours (ops/deblock.py::deblock_search_tiled,
ops/cdef.py::cdef_search_persb_tiled), with the searches' sums added over
the shards (psum). The reference's p_frame_body runs its deblock_fn and
cdef_fn hooks inside; the port's p_frame_body has none, so the two run
after it on the shard, as the port's _core runs its filters.

Each shard's decisions come to the host in one packed buffer
(pack_outputs); every tile is walked into od_ec IR by the C++ packer
(NativeTileWriter(ir_only=True)) on up to 8 threads, and all tiles are
coded in ONE ec_pack launch (ec_cuda.pack_tile_irs), then assembled into
one tile group.

Bit-exactness contract: the packet equals the reference's
encode_pframe_tiled on a T-device mesh byte for byte (the same frame-
global decisions, since every tile column computes exactly what the
reference's shard does), and the stream decodes on libdav1d and libaom
to the returned recon. Two shards may share one card (["cuda:0",
"cuda:0"]); the CPU tests use ["cpu", "cpu"].
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from rav1e_tpu_torch import trace
from rav1e_tpu_torch.device import resolve_device, to_host
from rav1e_tpu_torch.entropy.ec_cuda import pack_tile_irs
from rav1e_tpu_torch.entropy.native import NativeTileWriter
from rav1e_tpu_torch.entropy.obu import TileInfo, interframe_packet
from rav1e_tpu_torch.ops.cdef import cdef_search_persb_tiled
from rav1e_tpu_torch.ops.deblock import deblock_search_tiled
from rav1e_tpu_torch.parallel.tiles import ShardGroup
from rav1e_tpu_torch.pipeline.tpu_inter import (
    PAD,
    _edge_pad,
    _fetch_packed,
    _inter_headers,
    _q_scalars,
    _sub_grids,
    build_rd_inter,
    gather_dense,
    p_frame_body,
    pack_outputs,
)


def _shard_step(shard, y, u, v, ref_planes, qindex: int, nby: int,
                nbx_t: int, use_cdef: bool, damping: int):
    """One tile column on its shard: p_frame_body with the tile's block
    origins, then the tiled deblock and CDEF searches. Returns (the
    fetched decisions, the recon planes as host int32)."""
    dev, t = shard.device, shard.index
    tw = nbx_t * 32
    cols = [np.ascontiguousarray(p[:, t * (tw >> s):(t + 1) * (tw >> s)])
            for p, s in zip((y, u, v), (0, 1, 1))]
    ys, us, vs = (torch.as_tensor(c.astype(np.int32), device=dev)
                  for c in cols)
    ryp, rup, rvp = (_edge_pad(torch.as_tensor(
        np.asarray(p, np.int32), device=dev), PAD >> (i > 0))
        for i, p in enumerate(ref_planes))
    by = torch.as_tensor((np.repeat(np.arange(nby), nbx_t) * 32)
                         .astype(np.int32), device=dev)
    bx = torch.as_tensor((np.tile(np.arange(nbx_t), nby) * 32 + t * tw)
                         .astype(np.int32), device=dev)
    rd = build_rd_inter(qindex, device=dev)
    cdef_prm = (0, 0, 0, 0, damping)
    o = list(p_frame_body(ys, us, vs, ryp, rup, rvp,
                          *_q_scalars(qindex, dev), cdef_prm, rd, by, bx,
                          nby, nbx_t, True))
    planes = [o[6].to(torch.int32), o[7].to(torch.int32),
              o[8].to(torch.int32)]
    srcs = [ys, us, vs]
    lf, planes = deblock_search_tiled(planes, srcs, rd["base_lf"],
                                      o[11].reshape(nby, nbx_t), shard)
    if use_cdef:
        _, skip8 = _sub_grids(nby, nbx_t, o[17], o[13], o[18])
        cdef_idx, planes = cdef_search_persb_tiled(
            planes, srcs, skip8, damping, shard, lam=rd["lam"])
    else:
        cdef_idx = torch.zeros(((nby + 1) // 2, (nbx_t + 1) // 2),
                               dtype=torch.int32, device=dev)
    o[9], o[10] = lf, cdef_idx
    fetched = _fetch_packed((pack_outputs(o), o[3], o[4], o[5]),
                            gather_dense, nby, nbx_t)
    return fetched, [to_host(p).astype(np.int32) for p in planes]


def encode_pframe_tiled(planes, ref_planes, qindex: int, devices,
                        order_hint: int = 1,
                        render_size: tuple | None = None,
                        use_cdef: bool = True,
                        timings: dict | None = None):
    """Encode one 8-bit 4:2:0 P frame with T = len(devices) AV1 tile
    columns, one a shard on its device (devices may repeat: two shards
    on one card). planes / ref_planes: [y, u, v] host arrays; the frame
    width a multiple of 64 T. Returns (packet, recon planes int32).

    use_cdef runs the per-SB strength-index RDO with cross-tile halos;
    the frame signals the RD-chosen nb_strengths subset of the ladder
    (cdef_bits) exactly like the single-device path. The range coding
    runs on devices[0]. `timings` receives shards (the sharded device
    work and the decisions' fetch), tile_walk and the coding stages."""
    y, u, v = (np.asarray(p) for p in planes)
    h, w = y.shape
    T = len(devices)
    tw = w // T
    if w % T or tw % 64 or h % 32:
        raise ValueError(f"a {h}x{w} frame does not split into {T} tile "
                         "columns of whole 64-px superblocks")
    nby, nbx_t = h // 32, tw // 32
    damping = 3 + (qindex >= 64) + (qindex >= 160)
    dev0 = resolve_device(devices[0])
    st = trace.stages(dev0, timings)
    outs = ShardGroup(devices).run(
        lambda shard: _shard_step(shard, y, u, v, ref_planes, qindex, nby,
                                  nbx_t, use_cdef, damping))
    st.mark("shards")
    fetched = [f for f, _ in outs]
    lf = fetched[0][8]
    cdef = None
    if use_cdef:
        cdef = ((0, 0, 0, 0, damping),
                np.concatenate([f[9] for f in fetched], axis=1))
    seq, fp, cdef_map, cdef_bits = _inter_headers(
        h, w, qindex, cdef, None, render_size, lf, 8)
    ti = TileInfo(seq, max(0, T - 1).bit_length(), 0)
    if ti.n_cols != T or any(ti.col_starts[t] * 64 != t * tw
                             for t in range(T)):
        raise ValueError(f"AV1's uniform tile spacing does not cut a {w}-px "
                         f"frame into {T} columns of {tw} px")
    nc_t = (nbx_t + 1) // 2

    def walk(t):
        (mv8, skip, lv_y, lv_u, lv_v, split, mv16, skip16) = fetched[t][:8]
        writer = NativeTileWriter(h >> 2, tw >> 2, qindex, inter_frame=True,
                                  device=dev0, ir_only=True)
        cmap = (None if cdef_map is None
                else cdef_map[:, t * nc_t:(t + 1) * nc_t])
        return writer.write_inter_tile_fast2(
            split, mv8, skip, mv16, skip16, lv_y, lv_u, lv_v, cdef_idx=cmap,
            cdef_bits=cdef_bits)

    with ThreadPoolExecutor(min(T, 8)) as ex:
        irs = list(ex.map(walk, range(T)))
    st.mark("tile_walk", sum(int(ir.shape[0]) for ir in irs))
    tiles = pack_tile_irs(irs, dev0, timings)
    pkt = interframe_packet(seq, fp, ti, tiles, order_hint)
    rec = [np.concatenate([r[j] for _, r in outs], axis=1) for j in range(3)]
    return pkt, rec
