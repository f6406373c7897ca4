"""The reference's decoder (`portbench/reference/decode.py`): its symbol
decoder against the port's range coder, and every coded frame of small
sessions of both cells, on the port's CPU route, decoded from its packet
and the kept reconstructions of its references: each equals the
reconstruction the port kept, and libdav1d's picture where this machine
has libdav1d (a second witness)."""

import ctypes.util

import numpy as np
import pytest

import portbench.reference.judge as J
import portbench.run as R
from portbench.reference.av1 import Decoder
from portbench.reference.decode import SymbolReader, decode_frame
from portbench.tests.tiny import tiny_cell


def test_symbols_read_back():
    from rav1e_tpu_torch.entropy.ec import ECEncoder
    rng = np.random.default_rng(5)
    cdfs = []
    for n in (2, 3, 4, 8, 13, 16):
        p = np.sort(rng.integers(1, 32767, n - 1))[::-1]
        cdfs.append([int(v) for v in p] + [0, 0])
    seq = [(int(rng.integers(len(cdfs))), None) for _ in range(4000)]
    seq = [(c, int(rng.integers(len(cdfs[c]) - 1))) for c, _ in seq]
    enc, enc_cdfs = ECEncoder(), [list(c) for c in cdfs]
    for c, s in seq:
        enc.encode_symbol(s, enc_cdfs[c])
        enc.encode_bool(s & 1, 1 << 14)
    r, dec_cdfs = SymbolReader(enc.done(), True), [list(c) for c in cdfs]
    for c, s in seq:
        assert r.symbol(dec_cdfs[c]) == s
        assert r.bool() == s & 1


def _session(name, w, h, seconds):
    got = {}
    orig = J.judge

    def keep(packets, calls, *a, **kw):
        got["packets"], got["calls"] = packets, calls
        return orig(packets, calls, *a, **kw)

    J.judge = keep
    try:
        R.run(tiny_cell(name, w, h), 2**31 + 99, seconds, False,
              device="cpu")
    finally:
        J.judge = orig
    return got["packets"], got["calls"]


@pytest.mark.parametrize("name,w,h", [("s6-1080p.pan", 192, 112),
                                      ("s10-live-1080p.cuts", 160, 96)])
def test_every_coded_frame_decodes_to_its_reconstruction(name, w, h):
    packets, calls = _session(name, w, h, 8.0)
    dec = Decoder()
    slots, ci, shown = [None] * 8, 0, []
    for data, _ in packets:
        fr = dec.unit(data).frame
        if fr.show_existing:
            shown.append(slots[fr.show_idx])
            continue
        rec = [np.asarray(p) for p in calls[ci].rec]
        ci += 1
        out = decode_frame(fr, dec.seq, dict(enumerate(slots)))
        for o, r in zip(out, rec):
            assert o.shape == r.shape and np.array_equal(o, r)
        for i in range(8):
            if fr.refresh >> i & 1:
                slots[i] = rec
        if fr.show_frame:
            shown.append(rec)
    assert ci == len(calls) > 4
    if not ctypes.util.find_library("dav1d"):
        return
    from rav1e_tpu_torch.conform.dav1d import decode_all
    pics = decode_all([d for d, _ in packets])
    assert len(pics) == len(shown)
    for pic, rec in zip(pics, shown):
        for p in range(3):
            a = np.asarray(pic.planes[p])
            assert np.array_equal(a[:rec[p].shape[0], :rec[p].shape[1]],
                                  rec[p])
