"""The reference's default P-frame call, encode_pframe_tpu(planes, ref):
split RDO with the per-16 subpel refinement (refine16), a 16-px search
and subpel, in the port against the JAX package, on the CPU. One JAX
P-step compile, shared by both tests of the file; its result is computed
once per test run and shared between the runner's workers through a
locked file."""

import ctypes
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rav1e_tpu.pipeline import tpu_inter as jinter
from rav1e_tpu_torch.pipeline import tpu_inter as tinter
from test_torch_inter import _decode_exactly
from test_torch_keyframe import _once, shared_dir  # noqa: F401 (fixture)
from test_torch_split import H, W, split_frames

# the reference's encode_pframe_tpu defaults, as its _core takes them
DEFAULTS = dict(use_split=True, use_satd=False, refine16=True,
                intra_rdo=False, b64_rdo=False, search=16, subpel=True,
                use_split8=False, bd=8)


@pytest.fixture(autouse=True, scope="module")
def _light_on_a_shared_worker():
    """Run torch on one thread, hand the worker's freed heap back to the
    system around the module (glibc's malloc_trim), and drop its JAX
    compiles after it."""
    _trim_heap()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jinter._core.cache_clear()
    jax.clear_caches()
    _trim_heap()


def _trim_heap():
    gc.collect()
    trim = getattr(ctypes.CDLL(None), "malloc_trim", None)
    if trim is not None:
        trim(0)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _reference():
    """The JAX package's default P frame of split_frames()[1] against
    frame 0: its packet and recon (encode_pframe_tpu, whose _core compile
    the direct step call below reuses), the packed decision buffer and
    the fetched decisions."""
    cur, ref = split_frames()[1], split_frames()[0]
    pkt, rec = jinter.encode_pframe_tpu(cur, ref)
    step, (nby, nbx), gather = jinter._core(H, W, False, **DEFAULTS)
    outs = step(jnp.asarray(jinter.pack_src(cur)),
                *(jnp.asarray(r) for r in ref),
                jnp.int32(jinter.dc_q_lut(100)),
                jnp.int32(jinter.ac_q_lut(100)),
                jnp.asarray([0, 0, 0, 0, 3], jnp.int32),
                jinter.build_rd_inter(100),
                jinter._ds16_quads(None, nby, nbx))
    dec = jinter._fetch_packed(outs, gather, nby, nbx)
    return (pkt, [np.asarray(r) for r in rec], np.asarray(outs[0]),
            [np.asarray(x) if not np.isscalar(x) else x for x in dec])


def test_default_pstep_decisions_match_reference(shared_dir):
    """The port's P step with the reference's defaults: the packed
    decision buffer (MV field, split map, per-16 MVs and skips, levels'
    nonzero stream) byte for byte, and its host unpack (_fetch_packed),
    on a frame whose split map holds both values and whose refined
    per-16 MVs are fractional and differ from their parents'."""
    _, _, buf_j, dec_j = _once(shared_dir, "pframe_default_refine16",
                               _reference)
    frames = split_frames()
    cur, ref = frames[1], frames[0]
    step, (nby, nbx), gather = tinter._core(H, W, False, **DEFAULTS)
    cpu = torch.device("cpu")
    o = step(_t(tinter.pack_src(cur)), *(_t(r) for r in ref),
             *tinter._q_scalars(100, cpu),
             torch.tensor([0, 0, 0, 0, 3], dtype=torch.int32),
             tinter.build_rd_inter(100, device=cpu),
             tinter._ds16_quads(None, nby, nbx, cpu))
    np.testing.assert_array_equal(o[0].numpy(), buf_j)
    dec_t = tinter._fetch_packed(o, gather, nby, nbx)
    for a, b in zip(dec_t, dec_j):
        np.testing.assert_array_equal(a, b)
    mv8, split, mv16 = dec_t[0], dec_t[5], dec_t[6]
    assert split.any() and not split.all()
    assert (mv16[split] % 8 != 0).any()
    assert (mv16[split] != mv8[split][:, None, :]).any()


def test_default_pframe_packet_identical_and_conformant(shared_dir):
    """encode_pframe_tpu(planes, ref, device="cpu") with every other
    argument at its default: the packet and recon equal the JAX
    package's encode_pframe_tpu(planes, ref), and the P frame decodes on
    libdav1d and libaom (after an intra frame of its reference) to the
    port's recon."""
    pkt_j, rec_j, _, _ = _once(shared_dir, "pframe_default_refine16",
                               _reference)
    frames = split_frames()
    pkt, rec = tinter.encode_pframe_tpu(frames[1], frames[0], device="cpu")
    assert pkt == pkt_j
    for a, b in zip(rec, rec_j):
        np.testing.assert_array_equal(a, b)
    # a decodable stream: the port's speed-10 keyframe of the reference
    # frame, then this P frame against that keyframe's recon
    from rav1e_tpu_torch.pipeline import tpu_intra as tti
    kf_pkt, kf_rec = tti.encode_keyframe_tpu(frames[0], 100, speed=10,
                                             device="cpu")
    pkt2, rec2 = tinter.encode_pframe_tpu(
        frames[1], [r.astype(np.uint8) for r in kf_rec], device="cpu")
    _decode_exactly([kf_pkt, pkt2], [kf_rec, rec2])
