"""A run driven with the timed path broken underneath comes out not
correct: each fault a cell can have, planted in the port's pipeline or
session on its CPU route at a small size (the look for a card skipped).
The fidelity limits are the sound run's readings at this size plus a
half (the cells' own limits are for 1080p); the decode check's limit is
0, as in the cells."""

import numpy as np
import pytest

import portbench.run as R
from portbench.tests.tiny import tiny_cell

CELLS = ["s6-1080p.pan", "s10-live-1080p.cuts"]
SEED = 2**31 + 11
FIDELITY = ("mse_y", "mse_uv", "sb_mse_y")
_sound = {}


def _run(name, limits=None):
    cell = tiny_cell(name, limits=limits)
    return R.run(cell, SEED, 8.0, False, device="cpu")


def _limits(name):
    if name not in _sound:
        out = _run(name)
        assert out["checks"]["stream_faults"]["value"] == 0
        _sound[name] = {n: 1.5 * out["checks"][n]["value"] for n in FIDELITY}
        _sound[name]["stream_faults"] = 0
        assert _run(name, _sound[name])["correct"] is True
    return _sound[name]


def _wrap_inter(monkeypatch, change):
    """Replace the P and B steps by ones that return change(data, rec,
    refs)."""
    import rav1e_tpu_torch.pipeline.tpu_inter as ti
    for fn in ("encode_pframe_tpu", "encode_bframe_tpu"):
        orig = getattr(ti, fn)

        def bad(*a, _orig=orig, **kw):
            data, rec = _orig(*a, **kw)
            return change(data, rec, a[1])

        monkeypatch.setattr(ti, fn, bad)


def _state_unchanged(data, rec, ref):
    return data, [np.asarray(r, np.int32).copy() for r in ref]


def _header_byte(data, rec, ref):
    b = bytearray(data)
    b[6] ^= 0xFF                      # inside the uncompressed header
    return bytes(b), rec


def _recon_block(data, rec, ref):
    rec = [np.asarray(r).copy() for r in rec]
    rec[0][8:40, 8:40] = np.clip(rec[0][8:40, 8:40] + 60, 0, 255)
    return data, rec


def _tile_byte(data, rec, ref):
    b = bytearray(data)
    b[-3] ^= 0x55                     # inside the tile data
    return bytes(b), rec


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "header_byte",
                                   "recon_block", "tile_byte"])
def test_a_broken_step_is_not_correct(monkeypatch, name, fault):
    limits = _limits(name)
    _wrap_inter(monkeypatch, {"state_unchanged": _state_unchanged,
                              "header_byte": _header_byte,
                              "recon_block": _recon_block,
                              "tile_byte": _tile_byte}[fault])
    out = _run(name, limits)
    assert out["attempted"] > 0
    assert out["correct"] is False, out["checks"]
    assert out["failed"] > 0
    if fault == "tile_byte":
        assert out["checks"]["decode_mismatch"]["value"] > 0


def skip_filter(monkeypatch, which):
    """The in-loop filter `which` (deblock, cdef) left out of the frames'
    reconstructions while the headers still signal what its search
    chose: the port's search returns its input planes."""
    import rav1e_tpu_torch.ops.cdef as cdef
    import rav1e_tpu_torch.ops.deblock as deblock
    mod, fn = {"deblock": (deblock, "deblock_search"),
               "cdef": (cdef, "cdef_search_persb")}[which]
    orig = getattr(mod, fn)

    def skipped(planes, *a, **kw):
        chosen, _ = orig(planes, *a, **kw)
        return chosen, planes

    monkeypatch.setattr(mod, fn, skipped)


@pytest.mark.parametrize("name,which", [("s6-1080p.pan", "deblock"),
                                        ("s6-1080p.pan", "cdef"),
                                        ("s10-live-1080p.cuts", "deblock")])
def test_a_skipped_loop_filter_is_not_correct(monkeypatch, name, which):
    limits = _limits(name)
    skip_filter(monkeypatch, which)
    out = _run(name, limits)
    assert out["correct"] is False, out["checks"]
    assert out["checks"]["decode_mismatch"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_half_the_packets_left_out_is_not_correct(monkeypatch, name):
    from rav1e_tpu_torch.api import EncoderStatus
    from rav1e_tpu_torch.api.context import Context
    limits = _limits(name)
    orig = Context.receive_packet
    n = [0]

    def half(self):
        while True:
            st, p = orig(self)
            if st != EncoderStatus.SUCCESS:
                return st, p
            n[0] += 1
            if n[0] % 2 or n[0] < 8:      # set-up whole, then every other
                return st, p

    monkeypatch.setattr(Context, "receive_packet", half)
    out = _run(name, limits)
    assert out["correct"] is False
    assert out["checks"]["stream_faults"]["value"] > 0
