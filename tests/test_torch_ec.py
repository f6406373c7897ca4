"""The port's od_ec range coding (rav1e_tpu_torch.entropy.ec_cuda)
against the port's ECEncoder and the JAX package's Pallas kernel
(rav1e_tpu/entropy/ec_pallas.py, interpret mode on the CPU), and the
chunked model of the CUDA kernels' passes (pack_ir_chunked_plain)
against the serial definition (pack_ir_plain + finish).

All comparisons are exact: chunks, coder state and finished bytes. The
JAX package is imported inside the one test that needs it, so the card
tests below also run on a GPU machine without jax
(python -m pytest tests/test_torch_ec.py -m cuda)."""

import numpy as np
import pytest
import torch

from rav1e_tpu_torch.entropy import ec_cuda
from rav1e_tpu_torch.entropy.ec import PROB_TOP, ECEncoder


def _stream(seed: int, iters: int):
    """Adapting-CDF symbols with literals and bools mixed in (as
    tests/test_pallas.py). Returns (IR tensor, ECEncoder bytes)."""
    rng = np.random.default_rng(seed)

    def make_cdf(n):
        cuts = sorted(rng.integers(1, PROB_TOP, n - 1).tolist(),
                      reverse=True)
        return list(cuts) + [0, 0]

    cdfs = [make_cdf(n) for n in (2, 3, 5, 8, 13, 16)]
    cdfs2 = [list(c) for c in cdfs]
    enc, rec = ECEncoder(), ec_cuda.RecordingEncoder("cpu")
    for i in range(iters):
        which = int(rng.integers(0, len(cdfs)))
        s = int(rng.integers(0, len(cdfs[which]) - 2))
        enc.encode_symbol(s, cdfs[which])
        rec.encode_symbol(s, cdfs2[which])
        if i % 7 == 0:
            v = int(rng.integers(0, 256))
            enc.encode_literal(v, 8)
            rec.encode_literal(v, 8)
        if i % 11 == 0:
            b = int(rng.integers(0, 2))
            f = int(rng.integers(64, PROB_TOP - 64))
            enc.encode_bool(b, f)
            rec.encode_bool(b, f)
    return rec.ir_tensor(), enc.done()


@pytest.mark.parametrize("seed", [21, 22])
def test_pack_ir_plain_matches_ecencoder_and_pallas(seed):
    """~2000 IR rows: pack_ir_plain's chunks and state equal the Pallas
    kernel's (interpret mode), and its finished bytes equal ECEncoder's
    and the Pallas path's."""
    ec_pallas = pytest.importorskip("rav1e_tpu.entropy.ec_pallas")
    ir, ref_bytes = _stream(seed, 900)
    assert 1800 < ir.shape[0] < 2400
    chunks, state = ec_cuda.pack_ir_plain(ir)
    low, nbits, flushed, k = state.tolist()
    p_chunks, p_low, p_nbits, p_flushed = ec_pallas.pack_ir(
        ir.numpy(), interpret=True)
    assert (low, nbits, flushed) == (p_low, p_nbits, p_flushed)
    assert k == len(p_chunks)
    np.testing.assert_array_equal(chunks.numpy(), p_chunks)
    out = ec_cuda.finish(chunks.tolist(), low, nbits, flushed)
    assert out == ref_bytes
    assert out == ec_pallas.finish(p_chunks, p_low, p_nbits, p_flushed)


def _carry_stream(steps: int):
    """Bools steered to keep the coder's interval around 1/2, so `low`
    runs to 0x7FFF...; then one bool lifts it above 1/2, and the carry
    runs back through every 0xFF byte (chip_smoke.py's carry_stream).
    Returns (IR tensor, ECEncoder bytes)."""
    enc, rec = ECEncoder(), ec_cuda.RecordingEncoder("cpu")
    low, rng, nbits = 0, PROB_TOP, 15

    def bool_(val, f):
        nonlocal low, rng, nbits
        v = (((rng >> 8) * (f >> 6)) >> 1) + 4
        low, rng = (low + rng - v, v) if val else (low, rng - v)
        d = 16 - rng.bit_length()
        low, rng, nbits = low << d, rng << d, nbits + d
        enc.encode_bool(val, f)
        rec.encode_bool(val, f)

    for _ in range(steps):
        v = (((rng >> 8) * (1 << 8)) >> 1) + 4
        bool_(int(low + rng - v <= 1 << (nbits - 1)), 1 << 14)
    bool_(1, 64)
    return rec.ir_tensor(), enc.done()


def _no_short_rows_stream(n: int):
    """Only false bools: every row has fl = 2^15, so a tile is one chunk."""
    enc, rec = ECEncoder(), ec_cuda.RecordingEncoder("cpu")
    for i in range(n):
        enc.encode_bool(0, 1000 + 37 * i)
        rec.encode_bool(0, 1000 + 37 * i)
    return rec.ir_tensor(), enc.done()


def _plain_bytes(ir) -> bytes:
    chunks, state = ec_cuda.pack_ir_plain(ir)
    return ec_cuda.finish(chunks.tolist(), *state[:3].tolist())


@pytest.mark.parametrize("L", [7, 64, 1024])
@pytest.mark.parametrize("seed", [61, 62])
def test_chunked_model_matches_plain_on_random_streams(seed, L):
    """The kernels' passes, modelled in torch, give pack_ir_plain +
    finish's bytes and ECEncoder's on adapting streams of 2-4k rows."""
    ir, ref = _stream(seed, 1500)
    stats: dict = {}
    got = ec_cuda.pack_ir_chunked_plain(ir, L, stats)
    assert got == _plain_bytes(ir) == ref
    assert stats["chunks"] >= min(3, -(-ir.shape[0] // L))


@pytest.fixture(scope="module")
def keyframe_irs():
    """The IR of the port's CPU keyframe at 128x96, q 100 and q 30 (the
    C++ packer's), and the packets (captured as chip_smoke.py does)."""
    from rav1e_tpu_torch.pipeline import tpu_intra as tti
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:96, 0:128]
    y = (100 + 50 * np.sin(xx / 17) + 40 * np.cos(yy / 11)
         + rng.normal(0, 6, (96, 128))).clip(0, 255).astype(np.uint8)
    u = (128 + 30 * np.sin(xx[::2, ::2] / 23)).clip(0, 255).astype(np.uint8)
    v = (128 - 25 * np.cos(yy[::2, ::2] / 19)).clip(0, 255).astype(np.uint8)
    captured = {}

    class Capture(tti.NativeTileWriter):
        def code(self, ir):
            captured[q] = ir.clone()
            return super().code(ir)

    orig, tti.NativeTileWriter = tti.NativeTileWriter, Capture
    pkts = {}
    try:
        for q in (100, 30):
            pkts[q], _ = tti.encode_keyframe_tpu([y, u, v], q, speed=10,
                                                 device="cpu")
    finally:
        tti.NativeTileWriter = orig
    return {q: (captured[q], pkts[q]) for q in pkts}


@pytest.mark.parametrize("L", [64, 1024])
@pytest.mark.parametrize("q", [100, 30])
def test_chunked_model_matches_plain_on_keyframe_ir(keyframe_irs, q, L):
    """On the port's own keyframe IR the model's bytes are the packet's
    tile and pack_ir_plain + finish's."""
    ir, pkt = keyframe_irs[q]
    got = ec_cuda.pack_ir_chunked_plain(ir, L)
    assert got == _plain_bytes(ir)
    assert got in pkt


def test_chunked_model_without_short_rows_is_one_chunk():
    """No row has fl < 2^15: every slot after the first is empty, the
    tile is one chunk, and the bytes still equal ECEncoder's."""
    ir, ref = _no_short_rows_stream(700)
    assert (ir[:, 0] == PROB_TOP).all()
    stats: dict = {}
    assert ec_cuda.pack_ir_chunked_plain(ir, 16, stats) == ref
    assert stats["chunks"] == 1
    assert (ec_cuda.chunk_starts(ir, 16)[1:] == -1).all()


def test_chunked_model_empty_tile():
    """finish([], 0, 15, 0) is ECEncoder().done(), and so is the model's
    empty tile."""
    ref = ECEncoder().done()
    assert ec_cuda.finish([], 0, 15, 0) == ref
    assert ec_cuda.pack_ir_chunked_plain(
        torch.zeros((0, 4), dtype=torch.int32), 64) == ref


@pytest.mark.parametrize("L", [7, 16, 64])
def test_chunked_model_carry_across_chunk_joins(L):
    """A carry runs out of two chunks' overlap into the earlier chunk's
    bytes, and through whole segments of 0xFF bytes of the carry pass;
    the bytes still equal ECEncoder's."""
    ir, ref = _carry_stream(3000)
    stats: dict = {}
    assert ec_cuda.pack_ir_chunked_plain(ir, L, stats) == ref
    assert stats["joins_carried"] > 0
    assert stats["segments_carried_through"] > 0


def test_chunked_model_carry_across_carry_stages():
    """A carry from the tile's last bits runs back through all of some
    10,000 bytes of 0x7FFF...F, across two stages of the carry pass."""
    ir, ref = _carry_stream(80000)
    assert len(ref) > ec_cuda.CARRY_STAGE
    stats: dict = {}
    assert ec_cuda.pack_ir_chunked_plain(ir, 1024, stats) == ref
    assert stats["segments_carried_through"] > ec_cuda.CARRY_THREADS


def test_pack_ir_batched_layout_on_cpu():
    """The batched layout (tile t's bytes at 2*offsets[t] + 8*t, lengths
    in lens) on a CPU tensor, an empty tile included, gives each tile's
    own bytes, and fetch_tiles copies only those."""
    streams = [_stream(s, n) for s, n in ((31, 400), (32, 0), (33, 250))]
    offs = [0]
    for ir, _ in streams:
        offs.append(offs[-1] + ir.shape[0])
    out, lens = ec_cuda.pack_ir(
        torch.cat([ir for ir, _ in streams]),
        torch.tensor(offs, dtype=torch.int64))
    assert out.shape[0] == 2 * offs[-1] + 8 * 3
    assert out.dtype == torch.uint8 and lens.dtype == torch.int32
    assert lens.tolist() == [len(ref) for _, ref in streams]
    assert ec_cuda.fetch_tiles(out, lens, offs) == [r for _, r in streams]
    assert ec_cuda.pack_symbols(streams[0][0], "cpu") == streams[0][1]


def test_fetch_tiles_raises_on_a_leading_carry():
    with pytest.raises(ValueError, match="leading carry"):
        ec_cuda.fetch_tiles(torch.zeros(8, dtype=torch.uint8),
                            torch.tensor([-1], dtype=torch.int32), [0, 0])


def test_recording_encoder_defaults_to_cuda():
    """Recording needs no card; done() without a device codes on cuda,
    so without CUDA it raises rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    rec = ec_cuda.RecordingEncoder()
    rec.encode_bool(1, 1 << 14)
    assert rec.ir_tensor().shape == (1, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rec.done()


def test_pack_ir_rejects_bad_input():
    with pytest.raises(ValueError):
        ec_cuda.pack_ir(torch.zeros((4, 3), dtype=torch.int32))
    with pytest.raises(ValueError):
        ec_cuda.pack_ir(torch.zeros((4, 4), dtype=torch.int64))


def test_pack_symbols_cuda_without_cuda_raises():
    """Asked for cuda where there is none, the coder raises rather than
    falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    ir, _ = _stream(41, 50)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ec_cuda.pack_symbols(ir, "cuda")


def _pack_ir_kernel_matches_plain_on_cuda(L):
    """The CUDA kernels against the plain version, a 5-tile batch (an
    empty tile and two carry streams, one across carry-pass stages) in
    one call at chunk
    length L: the chunk starts equal chunk_starts and the bytes equal
    pack_ir_plain + finish's; and one tile without offsets. Needs a CUDA card (run there with
    python -m pytest tests/test_torch_ec.py -m cuda)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (runs on the GPU machine)")
    streams = [_stream(s, n) for s, n in ((51, 3000), (52, 0), (53, 700))]
    streams += [_carry_stream(2000), _carry_stream(80000)]
    offs = [0]
    for ir, _ in streams:
        offs.append(offs[-1] + ir.shape[0])
    before = ec_cuda.pack_ir.launches
    work: dict = {}
    out, lens = ec_cuda.pack_ir(
        torch.cat([ir for ir, _ in streams]).cuda(),
        torch.tensor(offs, dtype=torch.int64).cuda(), chunk_rows=L,
        work=work)
    torch.cuda.synchronize()
    assert ec_cuda.pack_ir.launches == before + 1
    assert out.is_cuda and lens.is_cuda
    tiles = ec_cuda.fetch_tiles(out, lens, offs)
    sinfo = work["sinfo"].cpu()
    for t, (ir, ref) in enumerate(streams):
        got = sinfo[sinfo[:, 0] == t, 2]
        want = ec_cuda.chunk_starts(ir, L)
        assert torch.equal(got[got >= 0].long(), want[want >= 0])
        assert tiles[t] == _plain_bytes(ir) == ref
    ir, ref = streams[0]
    out, lens = ec_cuda.pack_ir(ir.cuda(), chunk_rows=L)
    assert ec_cuda.fetch_tiles(out, lens, [0, ir.shape[0]]) == [ref]


def _tiled_1080p_irs():
    """The IRs of a 1920x1088 P frame's four tiles (a 2x2 grid), walked by
    the C++ packer as tpu_inter._pack_pframe(tile_grid=...) walks them, on
    random decisions (tests/test_torch_packer.py's grids: split, 16->8,
    intra and merged blocks), the top-right tile all skipped: a flat tile
    codes almost nothing."""
    from test_torch_packer import _inter_grid
    from rav1e_tpu_torch.entropy.obu import Sequence, TileInfo
    from rav1e_tpu_torch.pipeline import tpu_inter
    nby, nbx = 34, 60
    g = _inter_grid(np.random.default_rng(41), nby, nbx, split=True,
                    split8=True, intra=True, merge=True)
    flat = np.zeros((nby, nbx), bool)
    flat[:18, 30:] = True
    flat = flat.reshape(-1)
    g["skip"][flat], g["split"][flat], g["intra32"][flat] = True, False, False
    for k in ("lv_y", "lv_u", "lv_v"):
        g[k][flat] = 0
    g["b64"][:9, 15:] = False
    ti = TileInfo(Sequence(width=1920, height=1088), 1, 1)
    saved = tpu_inter._code_tiles
    tpu_inter._code_tiles = lambda irs, *a: irs
    try:
        return tpu_inter._pack_pframe_tiles(
            ti, 1088, 1920, 100, g["mv8"], g["skip"], g["lv_y"], g["lv_u"],
            g["lv_v"], g["split"], g["mv16"], g["skip16"], None, 0,
            g["intra32"], g["b64"], g["split16"], g["skip8"], "cpu", None)
    finally:
        tpu_inter._code_tiles = saved


@pytest.mark.cuda
def test_pack_ir_kernel_matches_plain_on_cuda():
    """_pack_ir_kernel_matches_plain_on_cuda at each chunk length; then a
    tiled 1080p P frame's four tile IRs (_tiled_1080p_irs, lengths far
    apart) coded by pack_tile_irs in one pack_ir launch give each tile
    pack_ir_plain + finish's bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for L in (5, 16, 1024):
        _pack_ir_kernel_matches_plain_on_cuda(L)
    irs = _tiled_1080p_irs()
    n = [int(ir.shape[0]) for ir in irs]
    assert len(irs) == 4 and min(n) * 20 < max(n), n
    before = ec_cuda.pack_ir.launches
    tiles = ec_cuda.pack_tile_irs(irs, "cuda")
    assert ec_cuda.pack_ir.launches == before + 1
    for ir, tile in zip(irs, tiles):
        assert tile == _plain_bytes(ir)
