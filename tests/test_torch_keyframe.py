"""The port's speed-10 keyframe slice against the JAX package's, on the
CPU: the packet must be byte-identical to rav1e_tpu's
encode_keyframe_tpu(..., speed=10), the recon identical, and both
decoders (libdav1d, libaom) must decode the port's packet exactly to the
port's recon. Only two frame shapes are compared, because each costs a
JAX compile."""

import ctypes
import gc
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from rav1e_tpu.conform import aom, dav1d
from rav1e_tpu.pipeline import tpu_intra as jti
from rav1e_tpu_torch.pipeline import tpu_intra as tti

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _light_on_a_shared_worker():
    """The test runner's workers share the machine's memory, and each
    keeps the heap its earlier modules freed: hand it back to the system
    before the module (glibc's malloc_trim), and drop the worker's JAX
    compiles after it."""
    _trim_heap()
    yield
    jax.clear_caches()
    _trim_heap()


def _trim_heap():
    gc.collect()
    trim = getattr(ctypes.CDLL(None), "malloc_trim", None)
    if trim is not None:
        trim(0)


def synth(w, h, seed=7):
    """The content of tests/test_tpu_pipeline.py."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = (100 + 50 * np.sin(xx / 17) + 40 * np.cos(yy / 11)
         + rng.normal(0, 6, (h, w))).clip(0, 255).astype(np.uint8)
    u = (128 + 30 * np.sin(xx[::2, ::2] / 23)).clip(0, 255).astype(np.uint8)
    v = (128 - 25 * np.cos(yy[::2, ::2] / 19)).clip(0, 255).astype(np.uint8)
    return [y, u, v]


def _check_decoders(pkt, rec):
    fr = dav1d.decode_all([pkt])
    out = aom.decode_all([pkt])
    for i in range(3):
        assert np.array_equal(fr[0].planes[i], rec[i]), f"dav1d plane {i}"
        assert np.array_equal(out[0][i], rec[i]), f"aom plane {i}"


def _same_as_reference(planes, qindex):
    pkt_j, rec_j = jti.encode_keyframe_tpu(planes, qindex=qindex, speed=10)
    pkt, rec = tti.encode_keyframe_tpu(planes, qindex=qindex, speed=10,
                                       device="cpu")
    assert pkt == pkt_j
    for a, b in zip(rec, rec_j):
        np.testing.assert_array_equal(a, b)
    _check_decoders(pkt, rec)


@pytest.mark.parametrize("w,h", [(64, 64), (128, 96)])
def test_keyframe_packet_identical_and_conformant(w, h):
    """64x64 (bh = bw = 2) and 128x96 (bh = 3, bw = 4): the first and
    last diagonals read rows at the ends of the skewed state."""
    _same_as_reference(synth(w, h), 100)


def test_keyframe_overflow_gather():
    """A noise frame at qindex 30: blocks hold more nonzeros than their
    128 stream slots, so the host takes the overflow gather."""
    rng = np.random.default_rng(3)
    planes = [rng.integers(0, 256, s).astype(np.uint8)
              for s in ((64, 64), (32, 32), (32, 32))]
    kd = tti.analyze_keyframe(planes, 30, device="cpu")
    nnz = ((kd.lvy != 0).sum((1, 2)) + (kd.lvu != 0).sum((1, 2))
           + (kd.lvv != 0).sum((1, 2)))
    assert (nnz > 128).any()
    _same_as_reference(planes, 30)


def test_recon_wavefront_with_reference_tables():
    """rd_from_numpy feeds the JAX package's own build_rd tables to the
    port's mode pass and recon wavefront: decisions, levels and recon
    equal the JAX functions' on the same input."""
    planes = synth(64, 64)
    modes = jti.MODES_FAST
    rd_j = jti.build_rd(100, modes, modes)
    rd_t = tti.rd_from_numpy(jax.tree_util.tree_map(np.asarray, rd_j),
                             "cpu")
    bh = bw = 2
    sy, su, sv = (jti._to_blocks(p, b) for p, b in
                  zip(planes, (32, 16, 16)))
    z = np.zeros
    state0 = (sy, su, sv, z((bh, bw, 32, 32), np.int32),
              z((bh, bw, 16, 16), np.int32), z((bh, bw, 16, 16), np.int32),
              z((bh, bw, 5), np.int32), z((bh, bw, 5), np.int32),
              z((bh, bw), bool), z((bh, bw, 2), np.int32))
    ii = np.repeat(np.arange(bh), bw).astype(np.int32)[None]
    jj = np.tile(np.arange(bw), bh).astype(np.int32)[None]
    dec_j = jti.wavefront_frame(state0, (sy, su, sv), ii, jj,
                                np.ones((1, bh * bw), bool), rd_j, modes,
                                modes, modes, False, approx=True,
                                dense=True)
    src_t = tuple(torch.from_numpy(x) for x in (sy, su, sv))
    dec_t = tti.wavefront_frame(src_t, src_t, rd_t, modes, modes,
                                approx=True)
    for a, b in zip(dec_t, dec_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ii_sk, jj_sk, has_l, valid, _, _ = jti._skew_tables(bh, bw, False)

    def skew(x):
        return np.asarray(x)[ii_sk, jj_sk]

    out_j = jti.recon_wavefront(
        skew(sy), skew(su), skew(sv), skew(dec_j[6]), skew(dec_j[7]),
        skew(dec_j[8]), skew(dec_j[9]), has_l, np.zeros_like(valid), rd_j,
        modes, modes, modes, False, False, False)
    out_t = tti.recon_wavefront(*(torch.from_numpy(skew(x)) for x in
                                  (sy, su, sv, dec_j[6], dec_j[7])),
                                torch.from_numpy(has_l), rd_t, modes,
                                modes)
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_build_rd_and_cdf_tables_match_reference():
    """The port's build_rd(100) equals the JAX package's key by key, and
    the port's CDF table file holds the reference's arrays."""
    modes = jti.MODES_FAST
    rd_j = jax.tree_util.tree_map(np.asarray,
                                  jti.build_rd(100, modes, modes))
    rd_t = tti.build_rd(100, modes, modes, device="cpu")

    def same(a, b):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], dict):
                same(a[k], b[k])
            else:
                np.testing.assert_array_equal(a[k].numpy(), b[k], err_msg=k)
                assert a[k].numpy().dtype == b[k].dtype, k

    same(rd_t, rd_j)
    rel = "entropy/tables/default_cdfs.npz"
    with np.load(ROOT / "rav1e_tpu" / rel) as a, \
            np.load(ROOT / "rav1e_tpu_torch" / rel) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
