"""Tiles in the port against the JAX package, on the CPU.

A tiled frame keeps the frame-global decisions and codes each tile with
its own entropy state in tile-local coordinates: the anchor P frames on
the C++ packer (write_inter_tile_fast2 a tile, on worker threads), the B
frames on the Python TileWriter, and every tile of a frame range-coded in
one pack_ir call (ec_cuda.pack_tile_irs). tests/test_tiled_context.py's
sessions (tiles=4 at 256x128, its content and q, low latency and
reordered, at speed 7 as its test_tiled_vs_untiled_same_decisions, whose
JAX programs the low-latency session shares) give the JAX Context's
packets byte for byte, both decoders decode them alike, and to the
untiled session's frames (the decisions are frame-global); the keyframes
are single-tile, as the reference codes them. On a 2x2 grid a P frame
with the speed-6 tools (the 64x64 merge and the 16->8 split in the C++
walk) and a B frame, each with CDEF indices in its tiles on one of two
contents, each launch the od_ec coder once, each tile's bytes are its IR
coded alone, the recons equal the untiled frames', and both decoders
decode them."""

import ctypes
import gc

import numpy as np
import pytest
import torch

from test_tiled_context import _frames
from rav1e_tpu_torch.conform import aom, dav1d
from rav1e_tpu_torch.entropy import ec_cuda
from rav1e_tpu_torch.pipeline import tpu_inter as tinter


@pytest.fixture(autouse=True, scope="module")
def _light_on_a_shared_worker():
    """Run torch on one thread and hand the worker's freed heap back to
    the system around the module (glibc's malloc_trim)."""
    _trim_heap()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    _trim_heap()


def _trim_heap():
    gc.collect()
    trim = getattr(ctypes.CDLL(None), "malloc_trim", None)
    if trim is not None:
        trim(0)


def _run(ctx, frames):
    for f in frames:
        ctx.send_frame(f)
    ctx.flush()
    rows = []
    while True:
        _, p = ctx.receive_packet()
        if p is None:
            return rows
        rows.append((p.frame_type, p.input_frameno, p.qp, p.data))


def test_tiled_sessions_equal_reference():
    """tiles=4 (a 2x2 grid) on test_tiled_context's frames at speed 7,
    low latency and reordered: packets, frame types and qps equal the JAX
    Context's; libdav1d and libaom decode each stream to the same frames,
    which are the untiled session's."""
    from rav1e_tpu.api import Config as JConfig
    from rav1e_tpu_torch.api import Config
    frames = _frames()
    for ll in (True, False):
        kw = dict(width=256, height=128, quantizer=110, low_latency=ll,
                  speed=7)
        want = _run(JConfig(tiles=4, **kw).new_context(), frames)
        ctx = Config(tiles=4, **kw).new_context(device="cpu")
        assert (ctx._tile_cols_log2, ctx._tile_rows_log2) == (1, 1)
        got = _run(ctx, frames)
        assert [r[:3] for r in got] == [r[:3] for r in want], ll
        for a, b in zip(got, want):
            assert a[3] == b[3], (ll, a[:3])
        untiled = _run(Config(**kw).new_context(device="cpu"), frames)
        assert [r[:3] for r in untiled] == [r[:3] for r in got]
        assert [r[3] for r in untiled] != [r[3] for r in got]
        d = dav1d.decode_all([r[3] for r in got])
        a = aom.decode_all([r[3] for r in got])
        du = dav1d.decode_all([r[3] for r in untiled])
        assert len(d) == len(a) == len(du) == len(frames)
        for i in range(len(frames)):
            for j in range(3):
                np.testing.assert_array_equal(np.asarray(d[i].planes[j]),
                                              np.asarray(a[i][j]))
                np.testing.assert_array_equal(np.asarray(d[i].planes[j]),
                                              np.asarray(du[i].planes[j]))


def _edges_and_noise(w=256, h=128, n=3, seed=5):
    """n frames whose left half is a smooth ramp crossed by bright lines
    and whose right half is moving noise: the SBs pick other CDEF ladder
    entries on the two halves, so a P frame on a 2x2 grid codes a CDEF
    index in its tiles."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 90 + 60 * np.sin(xx / 29)
    base[::16, :] += 60
    noise = rng.normal(0, 40, (h, w))
    out = []
    for t in range(n):
        y = base.copy()
        y[:, w // 2:] += np.roll(noise, 3 * t, axis=1)[:, w // 2:]
        out.append([y.clip(0, 255).astype(np.uint8),
                    np.full((h // 2, w // 2), 120, np.uint8),
                    (128 + 20 * np.cos(yy[::2, ::2] / 13 + t)).clip(
                        0, 255).astype(np.uint8)])
    return out


def test_tiled_frames_code_in_one_launch():
    """A speed-7 KEY, an anchor P (frame 2) with the speed-6 tools but
    intra-in-inter (as a tiled session's anchor) and a B frame (frame 1)
    at 256x128 on a 2x2 tile grid, on two contents: _edges_and_noise at q
    200 (the P frame's tiles code CDEF indices) and _torch_content's
    bgroup at q 110 (the B frame's do). Each inter frame calls pack_ir
    once for its four tiles, each tile's bytes equal pack_symbols on its
    IR alone, the recons equal the untiled frames', and both decoders
    decode the stream to them."""
    from _torch_content import bgroup
    cdef_bits = {"P": [], "B": []}
    for frames, q in ((_edges_and_noise(), 200), (bgroup(256, 128, n=3),
                                                  110)):
        _tiled_vs_untiled(frames, q, cdef_bits)
    assert max(cdef_bits["P"]) > 0 and max(cdef_bits["B"]) > 0, cdef_bits


def _tiled_vs_untiled(frames, q, cdef_bits):
    """test_tiled_frames_code_in_one_launch on one content and q; each
    tiled frame's CDEF index bits appended to cdef_bits["P"] / ["B"]."""
    from rav1e_tpu_torch.entropy.obu import show_existing_packet
    from rav1e_tpu_torch.pipeline.tpu_intra import encode_keyframe_tpu
    kpkt, krec = encode_keyframe_tpu(frames[0], q, speed=7,
                                     cdef=(0, 0, 0, 0, 3), device="cpu")
    kw = dict(cdef=(0, 0, 0, 0, 3), device="cpu")
    pkw = dict(kw, order_hint=2, refresh_flags=0x02, show_frame=False,
               use_satd=True, b64_rdo=True, use_split8=True)
    bkw = dict(kw, order_hint=1, slot_fwd=0, slot_bwd=1, ref_hints=(0, 2),
               use_split=True)
    got, calls = [], []
    saved = (tinter.pack_tile_irs, ec_cuda.pack_ir, tinter._pack_pframe_tiles,
             tinter._python_walk)

    def keeping(irs, *a, **k):
        got.append([ir.clone() for ir in irs])
        return saved[0](irs, *a, **k)

    def counting(ir, offsets=None, **k):
        calls.append(1 if offsets is None else offsets.shape[0] - 1)
        return saved[1](ir, offsets, **k)

    def p_tiles(ti, *a):
        if ti.n_rows * ti.n_cols > 1:
            cdef_bits["P"].append(a[12])
        return saved[2](ti, *a)

    def b_tiles(ti, *a, **k):
        if ti.n_rows * ti.n_cols > 1:
            cdef_bits["B"].append(a[6])
        return saved[3](ti, *a, **k)

    out = {}
    (tinter.pack_tile_irs, ec_cuda.pack_ir, tinter._pack_pframe_tiles,
     tinter._python_walk) = keeping, counting, p_tiles, b_tiles
    try:
        for grid in ((1, 1), None):
            del calls[:]
            apkt, arec = tinter.encode_pframe_tpu(
                frames[2], [np.asarray(r, np.uint8) for r in krec], q,
                tile_grid=grid, **pkw)
            bpkt, brec = tinter.encode_bframe_tpu(
                frames[1], krec, arec, q, tile_grid=grid, **bkw)
            out[grid] = (apkt, arec, bpkt, brec, list(calls))
    finally:
        (tinter.pack_tile_irs, ec_cuda.pack_ir, tinter._pack_pframe_tiles,
         tinter._python_walk) = saved
    apkt, arec, bpkt, brec, launches = out[(1, 1)]
    assert launches == [4, 4]                # one call a frame, 4 tiles
    assert out[None][4] == [1, 1]
    assert [len(irs) for irs in got] == [4, 4, 1, 1]   # untiled: 1 each
    for irs, pkt in zip(got[:2], (apkt, bpkt)):
        tiles = [ec_cuda.pack_symbols(ir, "cpu") for ir in irs]
        assert all(t in pkt for t in tiles)
        assert sum(len(t) for t in tiles) < len(pkt)
    for a, b in zip(arec + brec, out[None][1] + out[None][3]):
        np.testing.assert_array_equal(a, b)
    assert apkt != out[None][0] and bpkt != out[None][2]
    pkts = [kpkt, apkt, bpkt, show_existing_packet(1)]
    for dec in (dav1d.decode_all(pkts), aom.decode_all(pkts)):
        assert len(dec) == 3
        for fr, rec in zip(dec, (krec, brec, arec)):
            planes = fr.planes if hasattr(fr, "planes") else fr
            for j in range(3):
                np.testing.assert_array_equal(np.asarray(planes[j]),
                                              np.asarray(rec[j]))
