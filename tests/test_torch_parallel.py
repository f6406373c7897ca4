"""The port's multi-device layer (rav1e_tpu_torch/parallel) on the CPU,
its shards and workers as CPU devices.

- The 2-shard tiled P frame (encode_pframe_tiled on ["cpu", "cpu"]) is
  the JAX package's encode_pframe_tiled on a 2-device virtual mesh byte
  for byte, on the port's speed-7 keyframe recon as both packages'
  reference, and decodes on libdav1d and libaom to the port's recon (the
  JAX run is made once per test run, through the locked file cache).
- The tiled deblock and CDEF searches (plain versions, T = 2 and 3
  shards) against the unsharded searches on the same frame: the per-SB
  SSE tables, the filtered pixels, the chosen level and indices equal.
- GopScheduler(["cpu", "cpu"]), the mock-cluster DistributedGopScheduler,
  tiles.dryrun and dryrun_multichip against the serial encode_gop_tpu.
"""

import ctypes
import gc

import chip_smoke
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

import jax
from jax.sharding import Mesh

from _torch_content import bgroup
from rav1e_tpu.parallel.tile_encode import encode_pframe_tiled as jax_tiled
from rav1e_tpu_torch.conform import aom, dav1d
from rav1e_tpu_torch.ops import cdef as C
from rav1e_tpu_torch.ops import deblock as D
from rav1e_tpu_torch.parallel import gop_encode as G
from rav1e_tpu_torch.parallel.dryrun import dryrun_multichip
from rav1e_tpu_torch.parallel.tile_encode import encode_pframe_tiled
from rav1e_tpu_torch.parallel.tiles import ShardGroup, dryrun
from rav1e_tpu_torch.pipeline.tpu_inter import encode_gop_tpu
from rav1e_tpu_torch.pipeline.tpu_intra import encode_keyframe_tpu
from test_torch_keyframe import _once, shared_dir  # noqa: F401 (fixture)


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


def _tiled_reference(f1, krec):
    mesh = Mesh(np.array(jax.devices()[:2]), ("tile",))
    pkt, rec = jax_tiled(f1, krec, 100, mesh)
    return pkt, [np.asarray(r) for r in rec]


def test_tiled_pframe_equals_reference_and_decodes(shared_dir):
    """A 128x128 P frame on two CPU shards: the packet equals the JAX
    package's 2-device encode_pframe_tiled (the same speed-7 keyframe
    recon as the reference frame of both), the recon too, and the KEY +
    tiled P stream decodes on libdav1d and libaom to the port's recons;
    the tiles are coded in one pack_tile_irs call."""
    frames = bgroup(128, 128, n=5)
    f0, f1 = frames[0], frames[4]
    kpkt, krec = encode_keyframe_tpu(f0, 100, speed=7, cdef=(2, 1, 1, 0, 4),
                                     device="cpu")
    krec = [np.asarray(r, np.uint8) for r in krec]
    import rav1e_tpu_torch.parallel.tile_encode as te
    coded, orig = [], te.pack_tile_irs
    te.pack_tile_irs = lambda irs, *a, **k: coded.append(len(irs)) or orig(
        irs, *a, **k)
    try:
        pkt, rec = encode_pframe_tiled(f1, krec, 100, ["cpu", "cpu"])
    finally:
        te.pack_tile_irs = orig
    assert coded == [2]
    pkt_j, rec_j = _once(shared_dir, "tiled_pframe_128x128",
                         lambda: _tiled_reference(f1, krec))
    assert pkt == pkt_j
    for a, b in zip(rec, rec_j):
        np.testing.assert_array_equal(a, b)
    d = dav1d.decode_all([kpkt, pkt])
    a = aom.decode_all([kpkt, pkt])
    for want, got_d, got_a in ((krec, d[0].planes, a[0]),
                               (rec, d[1].planes, a[1])):
        for j in range(3):
            np.testing.assert_array_equal(got_d[j], want[j])
            np.testing.assert_array_equal(got_a[j], want[j])


def _filter_content(h, w, seed=8):
    """A deblocked-looking frame and its source: smooth planes with noise
    whose amplitude (none, weak or strong) changes across the superblocks,
    so the SBs pick different CDEF entries; a split map and an 8x8 skip
    map."""
    rng = np.random.default_rng(seed)
    src = [(128 + gaussian_filter(rng.normal(0, 60, (h >> s, w >> s)), 2))
           .clip(0, 255).astype(np.int32) for s in (0, 1, 1)]
    amp = np.kron(rng.choice([0, 0, 3, 24], (h // 64 + 1, w // 64 + 1)),
                  np.ones((64, 64)))
    rec = [np.clip(p + (rng.normal(0, 1, p.shape) * amp[:p.shape[0] << s,
                                                         :p.shape[1] << s]
                        [::1 << s, ::1 << s]).astype(np.int32), 0, 255)
           for p, s in zip(src, (0, 1, 1))]
    split = rng.random((h // 32, w // 32)) < 0.4
    skip8 = rng.random((h // 8, w // 8)) < 0.2
    return ([torch.as_tensor(p) for p in rec], [torch.as_tensor(p)
                                                for p in src],
            torch.as_tensor(split), torch.as_tensor(skip8))


def _cols(planes, t, tw):
    return [p[:, t * tw >> s:(t + 1) * tw >> s]
            for p, s in zip(planes, (0, 1, 1))]


def test_tiled_filter_searches_equal_unsharded():
    """The tiled searches on T = 2 and 3 CPU shards (their plain versions, halos
    through the shard group) against the unsharded ones on the same
    frame: deblock_search_tiled's level and filtered planes equal
    deblock_search's (16 / 8 px edges, the split map) at two base levels;
    each shard's halo SSE table equals the unsharded table's columns,
    and cdef_search_persb_tiled's indices and planes equal the unsharded
    full-branch choice and cdef_apply's, with and without the
    nb_strengths RD (whose subset totals are summed over the shards)."""
    for T in (2, 3):
        _tiled_searches(T)


def _tiled_searches(T):
    h, w = 128, 128 * T
    tw = w // T
    rec, src, split, skip8 = _filter_content(h, w)
    for base in (8, 30):
        lvl, want = D.deblock_search(rec, src, base, block_y=16, block_c=8,
                                     split_map=split)
        outs = ShardGroup(["cpu"] * T).run(
            lambda sh: D.deblock_search_tiled(
                _cols(rec, sh.index, tw), _cols(src, sh.index, tw), base,
                split[:, sh.index * tw // 32:(sh.index + 1) * tw // 32],
                sh))
        assert all(int(o[0]) == int(lvl) for o in outs)
        for j in range(3):
            assert torch.equal(torch.cat([o[1][j] for o in outs], 1),
                               want[j])
    planes, srcs = C._as_pix(want), C._as_pix(src)
    dirs, var = C.cdef_dirs(planes[0])
    table = C.cdef_ladder_sse(planes, srcs, dirs, var, skip8, 4, False)
    for t in range(T):
        own = _cols(planes, t, tw)
        ext = [torch.cat([p[:, max(0, c0 - e):c0] if t else
                          torch.zeros_like(p[:, :e]), q,
                          p[:, c1:c1 + e] if t < T - 1 else
                          torch.zeros_like(p[:, :e])], 1)
               for p, q, e, c0, c1 in zip(
                   planes, own, (8, 4, 4), (t * tw, t * tw // 2,
                                            t * tw // 2),
                   ((t + 1) * tw, (t + 1) * tw // 2, (t + 1) * tw // 2))]
        g = slice(t * tw // 8, (t + 1) * tw // 8)
        got = C.cdef_ladder_sse(ext, _cols(srcs, t, tw), dirs[:, g],
                                var[:, g], skip8[:, g], 4, False, halo=8,
                                outside=(t == 0, t == T - 1))
        assert torch.equal(got, table[..., t * tw // 32:(t + 1) * tw // 32])
    nby, nbx = h // 32, w // 32
    for lam in (None, 60.0):
        idx = C._choose(C._sse_sb(table, False, (nby + 1) // 2,
                                  (nbx + 1) // 2), lam)
        applied = C.cdef_apply(planes, dirs, var, skip8, 4, idx=idx)
        outs = ShardGroup(["cpu"] * T).run(
            lambda sh: C.cdef_search_persb_tiled(
                _cols(want, sh.index, tw), _cols(src, sh.index, tw),
                skip8[:, sh.index * tw // 8:(sh.index + 1) * tw // 8], 4, sh,
                lam=lam))
        assert torch.equal(torch.cat([o[0] for o in outs], 1), idx)
        for j in range(3):
            assert torch.equal(torch.cat([o[1][j] for o in outs], 1),
                               applied[j])
    assert len(set(idx.flatten().tolist())) > 1


def test_gop_schedulers_and_dryruns_match_serial():
    """Three 64x64 GOPs (key interval 2) at speed 10: GopScheduler on two
    CPU workers and the mock two-process DistributedGopScheduler (every
    rank assembles the whole stream) give the serial encode_gop_tpu's
    packets and recons per GOP; tiles.dryrun and dryrun_multichip run
    over 2 and 4 CPU devices (their streams decode to their recons)."""
    frames = chip_smoke.synth(64, 64, n=6)
    serial_p, serial_r = [], []
    for g in range(3):
        p, r = encode_gop_tpu(frames[2 * g:2 * g + 2], qindex=100, speed=10,
                              device="cpu")
        serial_p += p
        serial_r += r
    pkts, recs = G.GopScheduler(["cpu", "cpu"]).encode(
        frames, key_interval=2, qindex=100, speed=10, want_recs=True)
    assert pkts == serial_p
    for a, b in zip(recs, serial_r):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    outs = G.MockCluster(2, devices=["cpu", "cpu"]).run(
        lambda grp: G.DistributedGopScheduler(grp).encode(
            frames, key_interval=2, qindex=100, speed=10))
    assert outs == [serial_p, serial_p]
    assert G.split_gops(frames, 4)[1] == frames[4:]
    assert dryrun(2, ["cpu", "cpu"])[1] > 0
    for n in (2, 4):
        out = dryrun_multichip(n, ["cpu"] * n)
        assert out["decoded"] and out["tile"] == (2 if n == 4 else 1)
