"""The port's keyframe slice against the JAX package's, on the CPU: the
packet must be byte-identical to rav1e_tpu's encode_keyframe_tpu at the
same speed (10, and 8 with CDEF), the recon identical, and both decoders
(libdav1d, libaom) must decode the port's packet exactly to the port's
recon. Only two frame shapes are compared, because each costs a JAX
compile per speed; the speed-8 references are computed once per test run
and shared between the runner's workers through a locked file. The
fixed-strength CDEF keyframe is held to the JAX package's filter alone,
without a keyframe compile of its own."""

import ctypes
import fcntl
import gc
import os
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rav1e_tpu.conform import aom, dav1d
from rav1e_tpu.core.constants import TxSize as JTx
from rav1e_tpu.core.constants import TxType as JTt
from rav1e_tpu.ops.tpu import cdef as jc
from rav1e_tpu.ops.tpu import transforms as jT
from rav1e_tpu.pipeline import tpu_intra as jti
from rav1e_tpu_torch.core.constants import TxSize, TxType
from rav1e_tpu_torch.ops import transforms as tT
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


@pytest.fixture(scope="session")
def shared_dir(tmp_path_factory):
    """A directory every worker of this test run sees (the workers'
    common parent under pytest-xdist; the run's own directory without
    it)."""
    base = tmp_path_factory.getbasetemp()
    return base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base


def _once(shared_dir, name, compute):
    """compute() run once per test run, whichever worker asks first; the
    others wait on the lock and read its pickled result."""
    path = shared_dir / f"{name}.pkl"
    with open(shared_dir / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not path.exists():
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                tmp.write_bytes(pickle.dumps(compute()))
                os.replace(tmp, path)
            return pickle.loads(path.read_bytes())
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


CDEF = (0, 0, 0, 0, 3)          # the main path's: damping 3, ladder search
CDEF_FIXED = (3, 1, 2, 0, 4)    # one frame-wide strength (cdef_rdo=False)


def _speed8_reference(w, h):
    """The JAX package's speed-8 CDEF keyframe of synth(w, h) at q 100:
    (packet, recon)."""
    pkt, rec = jti.encode_keyframe_tpu(synth(w, h), 100, speed=8, cdef=CDEF)
    return pkt, [np.asarray(r) for r in rec]


@pytest.mark.parametrize("w,h", [(64, 64), (128, 96)])
def test_speed8_cdef_keyframe_packet_identical_and_conformant(w, h,
                                                              shared_dir):
    """Speed 8 (the 7 luma and 4 chroma modes, chroma coded in each mode's
    TX type) with the per-SB CDEF search, cdef=(0, 0, 0, 0, 3): packet
    and recon equal rav1e_tpu's, and both decoders decode it exactly."""
    pkt_j, rec_j = _once(shared_dir, f"kf_speed8_{w}x{h}",
                         lambda: _speed8_reference(w, h))
    planes = synth(w, h)
    kd = tti.analyze_keyframe(planes, 100, speed=8, cdef=CDEF,
                              device="cpu")
    assert len(set(np.unique(kd.state[6].numpy()))) > 1      # luma modes
    pkt, rec = tti.pack_keyframe(kd, planes, 100, device="cpu")
    assert pkt == pkt_j
    for a, b in zip(rec, rec_j):
        np.testing.assert_array_equal(a, b)
    _check_decoders(pkt, rec)


def test_speed8_fixed_cdef_keyframe_identical_and_conformant():
    """cdef_rdo=False: one frame-wide strength, signalled in the header,
    applied by cdef_filter_frame (a chroma secondary strength of 0). No
    JAX keyframe compile: the recon is the JAX package's
    cdef_filter_frame_jax of the port's CDEF-less speed-8 recon (the same
    levels, deblocked) on the keyframe's skip gate, it differs from that
    recon, and both decoders decode the packet exactly to it
    (tests/test_torch_cdef.py holds cdef_filter_frame to the JAX
    function on its own)."""
    planes = synth(64, 64)
    kd = tti.analyze_keyframe(planes, 100, speed=8, cdef=CDEF_FIXED,
                              cdef_rdo=False, device="cpu")
    pkt, rec = tti.pack_keyframe(kd, planes, 100, device="cpu")
    _, rec0 = tti.encode_keyframe_tpu(planes, 100, speed=8, device="cpu")
    want = jax.jit(jc.cdef_filter_frame_jax)(
        [jnp.asarray(r) for r in rec0],
        jnp.asarray(tti._kf_skip8(kd.state).numpy()), *CDEF_FIXED)
    for a, b in zip(rec, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert any((a != b).any() for a, b in zip(rec, rec0))
    _check_decoders(pkt, rec)


@pytest.mark.parametrize("tt", ["ADST_DCT", "DCT_ADST", "ADST_ADST"])
def test_tx16_adst_types_against_reference(tt):
    """The chroma 16x16 TX types of the speed-8 modes: the integer
    inverse bit-exact; the f32 forward |d| <= 1 and equal on >= 99.99%
    (the rule of DCT_DCT); the float inverse_approx, which only ranks
    modes in phase 1 and is never coded, |d| <= 1 and equal on >= 99.9%
    (one value of these 8,192 rounds the other way: XLA and torch sum
    its f32 products in other orders)."""
    rng = np.random.default_rng(12)
    c = rng.integers(-3000, 3001, (32, 16, 16))
    c = (c * (rng.random(c.shape) < 0.25)).astype(np.int32)
    c[:, :4, :4] = rng.integers(-3000, 3001, (32, 4, 4))
    ref = np.asarray(jT.inverse_transform(jnp.asarray(c), JTx.TX_16X16,
                                          JTt[tt]))
    out = tT.inverse_transform(torch.from_numpy(c), TxSize.TX_16X16,
                               TxType[tt])
    np.testing.assert_array_equal(out.numpy(), ref)
    r = (np.round(rng.normal(0, 20, (256, 16, 16))).clip(-255, 255)
         .astype(np.int32))
    for j_fn, t_fn, x, share in (
            (jT.forward_transform, tT.forward_transform, r, 0.9999),
            (jT.inverse_approx, tT.inverse_approx, c, 0.999)):
        ref = np.asarray(j_fn(jnp.asarray(x), JTx.TX_16X16, JTt[tt]))
        out = t_fn(torch.from_numpy(x), TxSize.TX_16X16, TxType[tt]).numpy()
        d = np.abs(out.astype(np.int64) - ref)
        assert d.max() <= 1
        assert (d == 0).mean() >= share


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
    kd = tti.analyze_keyframe(planes, 30, speed=10, device="cpu")
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
