"""The port's session API (api/context.py, the CLI) on the CPU.

At its defaults (speed 6, the reordered depth-2 pyramid, lookahead depth
8) the port's Context gives the JAX package's packets, frame types,
input_framenos and qps byte for byte on 9 frames of 128x96 content with
a static region and a mover (a KEY and two groups of 4), and so do its
low-latency speed-5 and its speed-2 sessions (loop restoration, the
numpy keyframe's HORZ/VERT partitions, the 24-px P search); the JAX
package's run is made once per test run and shared between the runner's
workers through a locked file. The rest mirrors
tests/test_api_pipeline.py's session contracts on the port alone, and
checks that the configurations the JAX package codes on its numpy
pipelines or in tiles build a Context, loop restoration at 12 bits
included."""

import ctypes
import gc

import jax
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from _torch_content import session
from rav1e_tpu.conform import dav1d as jdav1d
from rav1e_tpu_torch.api import Config, EncoderStatus
from rav1e_tpu_torch.conform import dav1d
from rav1e_tpu_torch.pipeline import tpu_inter as tinter
from test_torch_keyframe import _once, shared_dir  # noqa: F401 (fixture)

W, H, N = 128, 96, 9


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
    jax.clear_caches()
    _trim_heap()


def _trim_heap():
    gc.collect()
    trim = getattr(ctypes.CDLL(None), "malloc_trim", None)
    if trim is not None:
        trim(0)


def _run(ctx, frames):
    """Send every frame, flush, drain. Either package's Context: their
    EncoderStatus enums are compared by name."""
    for f in frames:
        assert ctx.send_frame(f).name == "SUCCESS"
    ctx.flush()
    pkts = []
    while True:
        st, p = ctx.receive_packet()
        if p is None:
            assert st.name == "LIMIT_REACHED"
            break
        pkts.append(p)
    return pkts


def _rows(pkts):
    return [(p.frame_type, p.input_frameno, p.qp, p.data) for p in pkts]


def _reference_session(**cfg):
    """The JAX package's Context on session(): its packets as _rows."""
    from rav1e_tpu.api import Config as JConfig
    return _rows(_run(JConfig(width=W, height=H, **cfg).new_context(),
                      session(W, H, N)))


def _port_session(**cfg):
    """The port's Context on session(), with the dscale grid each inter
    frame's pipeline call received (coding order)."""
    seen = []
    names = ("encode_pframe_tpu", "encode_bframe_tpu", "encode_pframe2_tpu")
    saved = {n: getattr(tinter, n) for n in names}

    def recording(fn):
        def call(*a, **k):
            seen.append(k.get("dscale"))
            return fn(*a, **k)
        return call

    for n, fn in saved.items():
        setattr(tinter, n, recording(fn))
    try:
        pkts = _run(Config(width=W, height=H, **cfg).new_context(
            device="cpu"), session(W, H, N))
    finally:
        for n, fn in saved.items():
            setattr(tinter, n, fn)
    return pkts, seen


@pytest.fixture(scope="module")
def port_default():
    return _port_session()


# the sessions held against the JAX package's: the default (speed 6,
# reordered, B frames), low latency at speed 5 (LAST + GOLDEN P frames,
# the standard scene detector) and speed 2 with CDEF off, all with
# lookahead 8
SESSIONS = {"default": ({}, [
    ("KEY", 0), ("INTER", 4), ("INTER", 2), ("INTER", 1),
    ("SHOW_EXISTING", 2), ("INTER", 3), ("SHOW_EXISTING", 4),
    ("INTER", 8), ("INTER", 6), ("INTER", 5), ("SHOW_EXISTING", 6),
    ("INTER", 7), ("SHOW_EXISTING", 8)]),
    "low_latency_speed5": (dict(speed=5, low_latency=True),
                           [("KEY", 0)] + [("INTER", i) for i in
                                           range(1, N)]),
    # speed 2: the numpy keyframe with HORZ/VERT partitions and loop
    # restoration, the 24-px anchor P search, LR on every P and B frame;
    # without CDEF, since with it the JAX package's LR reads the CDEF
    # output beyond each stripe where decoders read the deblocked frame
    # (its streams decode to other pixels; the port's is held to its
    # decode by test_speed2_with_cdef_decodes_to_its_recon)
    "speed2": (dict(speed=2, extra={"cdef": "off"}), [
        ("KEY", 0), ("INTER", 4), ("INTER", 2), ("INTER", 1),
        ("SHOW_EXISTING", 2), ("INTER", 3), ("SHOW_EXISTING", 4),
        ("INTER", 8), ("INTER", 6), ("INTER", 5), ("SHOW_EXISTING", 6),
        ("INTER", 7), ("SHOW_EXISTING", 8)])}


@pytest.mark.parametrize("name", SESSIONS)
def test_session_equals_reference(name, port_default, shared_dir):
    """Every packet, frame type, input frame number and qp is the JAX
    package's; every inter frame's pipeline call but the last frame's
    (which has no future pair) got a lookahead dscale grid that is not
    all ones."""
    cfg, order = SESSIONS[name]
    pkts, seen = _port_session(**cfg) if cfg else port_default
    ref = _once(shared_dir, f"ctx_{name}_{W}x{H}",
                lambda: _reference_session(**cfg))
    got = _rows(pkts)
    assert [r[:3] for r in got] == [r[:3] for r in ref]
    assert [r[3] for r in got] == [r[3] for r in ref]
    assert [(t, n) for t, n, _, _ in got] == order
    if not cfg:
        assert len({q for _, _, q, _ in got}) == 4   # KEY, P, B0, B1 qps
    assert len(seen) == N - 1
    last = [n for t, n in order if t == "INTER"].index(N - 1)
    assert seen.pop(last) is None
    for ds in seen:
        assert ds.shape == (H // 16, W // 16) and np.ptp(ds) > 0.05


def test_speed2_with_cdef_decodes_to_its_recon():
    """The speed-2 session with CDEF on (its default): loop restoration
    reads the deblocked planes before CDEF beyond each stripe, so
    libdav1d decodes every frame to the encoder's recon (each decoded
    frame's PSNR against the source is its enc_stats' PSNR exactly, the
    B frames after the restored references included); the LR searches
    got those planes and filtered some unit."""
    from rav1e_tpu_torch.pipeline import lr as plr
    calls, orig = [], plr.search_lr_frame

    def recording(*a, **k):
        out = orig(*a, **k)
        n = sum(c is not None for g in (out[1] or {}).get("units", {})
                .values() for row in g for c in row)
        calls.append((k.get("pre") is not None, n))
        return out

    frames = session(W, H, N)
    plr.search_lr_frame = recording
    try:
        pkts = _run(Config(width=W, height=H, speed=2,
                           extra={"enc_stats": "1"}).new_context(
                               device="cpu"), frames)
    finally:
        plr.search_lr_frame = orig
    coded = {p.input_frameno: p.enc_stats for p in pkts
             if p.enc_stats is not None}
    dec = dav1d.decode_all([p.data for p in pkts])
    assert len(dec) == N and len(coded) == N
    for i, (d, f) in enumerate(zip(dec, frames)):
        got = []
        for plane, ref in zip(d.planes, f):
            mse = np.mean((plane.astype(np.float64) - ref) ** 2)
            got.append(float(10 * np.log10(255.0 ** 2 / mse))
                       if mse > 0 else 99.0)
        st = coded[i]
        assert got == [st.psnr_y, st.psnr_u, st.psnr_v], i
    assert len(calls) == N and all(pre for pre, _ in calls)
    assert sum(n for _, n in calls) > 0


def test_lookahead_off_changes_packets(port_default):
    """rdo_lookahead_frames=0 codes the same frames without the distortion
    scales: the keyframe is the same, the inter packets are not."""
    pkts, _ = port_default
    off = _run(Config(width=W, height=H,
                      extra={"rdo_lookahead_frames": 0}
                      ).new_context(device="cpu"), session(W, H, N))
    assert [r[:3] for r in _rows(off)] == [r[:3] for r in _rows(pkts)]
    assert off[0].data == pkts[0].data
    assert [p.data for p in off] != [p.data for p in pkts]


def test_cli_equals_context_and_decodes(port_default, tmp_path):
    """y4m in, IVF out with --device cpu: the IVF's packets are the
    Context's, each stamped with its input frame number; the stream
    decodes to 9 frames through the JAX package's dav1d shim and the
    port's copy alike, frame for frame, in display order."""
    from rav1e_tpu_torch.cli import main as cli
    from rav1e_tpu_torch.cli.ivf import read_ivf
    from rav1e_tpu_torch.cli.y4m import write_y4m
    pkts, _ = port_default
    frames = session(W, H, N)
    src, out = tmp_path / "in.y4m", tmp_path / "out.ivf"
    write_y4m(str(src), frames)
    cli.main([str(src), "-o", str(out), "--device", "cpu"])
    assert list(read_ivf(str(out))) == [(p.input_frameno, p.data)
                                        for p in pkts]
    data = [p.data for p in pkts]
    a, b = jdav1d.decode_all(data), dav1d.decode_all(data)
    assert len(a) == len(b) == N
    for i in range(N):
        for j in range(3):
            assert np.array_equal(a[i].planes[j], b[i].planes[j])
        err = np.abs(b[i].planes[0].astype(int)
                     - frames[i][0].astype(int)).mean()
        assert err < 6, (i, err)


def _cut_sequence(w=128, h=96, n=12, cut=6):
    """tests/test_api_pipeline.py's panning texture with a cut, smaller."""
    rng = np.random.default_rng(4)
    tex1 = gaussian_filter(rng.normal(0, 40, (h + 100, w + 100)), 2.5)
    tex2 = gaussian_filter(rng.normal(0, 40, (h + 100, w + 100)), 2.5)
    frames = []
    for t in range(n):
        tex = tex1 if t < cut else tex2
        oy, ox = int(30 + 2 * t), int(30 + t)
        y = (128 + tex[oy:oy + h, ox:ox + w]).clip(0, 255).astype(np.uint8)
        frames.append([y, np.full((h // 2, w // 2), 120, np.uint8),
                       np.full((h // 2, w // 2), 135, np.uint8)])
    return frames


def test_low_latency_scene_cut():
    frames = _cut_sequence()
    ctx = Config(width=W, height=H, min_key_frame_interval=4,
                 low_latency=True).new_context(device="cpu")
    pkts = _run(ctx, frames)
    types = [p.frame_type for p in pkts]
    assert types[0] == "KEY" and types[6] == "KEY", types   # the cut
    assert types.count("KEY") == 2
    assert [p.input_frameno for p in pkts] == list(range(len(frames)))
    assert len(dav1d.decode_all([p.data for p in pkts])) == len(frames)


def test_key_frame_interval():
    frames = _cut_sequence(n=10, cut=99)
    ctx = Config(width=W, height=H, key_frame_interval=4,
                 low_latency=True).new_context(device="cpu")
    types = [p.frame_type for p in _run(ctx, frames)]
    assert [i for i, t in enumerate(types) if t == "KEY"] == [0, 4, 8]


def test_one_pass_bitrate_within_band():
    """1-pass ABR: the stream's rate within 0.6-1.4x the target, the
    quantizer moved, every frame decodes."""
    frames = _cut_sequence(n=15, cut=99)
    target = 60_000
    ctx = Config.parse({"width": W, "height": H, "bitrate": str(target),
                        "framerate": "30"}).new_context(device="cpu")
    pkts = _run(ctx, frames)
    actual = sum(len(p.data) * 8 for p in pkts) / (len(frames) / 30.0)
    assert 0.6 * target < actual < 1.4 * target, actual
    assert len({p.qp for p in pkts}) > 1
    assert len(dav1d.decode_all([p.data for p in pkts])) == len(frames)


def test_two_pass_rate_control():
    """Pass 1 records per-frame stats; pass 2 lands within 0.65-1.35x the
    target and decodes; bad stats fail as rav1e's summary checks do."""
    frames = _cut_sequence(n=12, cut=6)
    target = 60_000

    def run_pass(pass_n, stats=None):
        ctx = Config.parse({"width": W, "height": H,
                            "bitrate": str(target), "framerate": "30",
                            "pass": str(pass_n)}).new_context(device="cpu")
        if stats is not None:
            ctx.twopass_in(stats)
        return ctx, _run(ctx, frames)

    ctx1, _ = run_pass(1)
    stats = ctx1.twopass_out() + ctx1.twopass_summary()
    assert len(stats) > len(frames) * 8
    _, pkts2 = run_pass(2, stats)
    actual = sum(len(p.data) * 8 for p in pkts2) / (len(frames) / 30.0)
    assert 0.65 * target < actual < 1.35 * target, actual
    assert len(dav1d.decode_all([p.data for p in pkts2])) == len(frames)
    with pytest.raises(ValueError, match="Magic"):
        run_pass(2, b"X" * len(stats))
    with pytest.raises(ValueError, match="No TUs"):
        run_pass(2, b"")


def test_enc_stats_psnr_is_the_decoded_frames():
    """Config.extra['enc_stats'] fills each coded packet's stats: its size,
    and the PSNR of the decoded frame against the source."""
    frames = session(W, H, 5)
    ctx = Config.parse({"width": W, "height": H, "low_latency": True,
                        "enc_stats": "1"}).new_context(device="cpu")
    pkts = _run(ctx, frames)
    dec = dav1d.decode_all([p.data for p in pkts])
    assert len(pkts) == len(dec) == 5
    for p, d, f in zip(pkts, dec, frames):
        st = p.enc_stats
        assert st is not None and st.size_bytes == len(p.data)
        assert st.qp == p.qp
        mse = np.mean((d.planes[0].astype(np.float64) - f[0]) ** 2)
        assert st.psnr_y == pytest.approx(10 * np.log10(255 ** 2 / mse))
    off = _run(Config(width=W, height=H, low_latency=True
                      ).new_context(device="cpu"), frames[:2])
    assert all(p.enc_stats is None for p in off)


def _obus(tu: bytes):
    """(obu_type, payload) of each OBU of a temporal unit."""
    out, pos = [], 0
    while pos < len(tu):
        obu_type = (tu[pos] >> 3) & 0xF
        size, nb, p = 0, 0, pos + 1
        while True:
            byte = tu[p + nb]
            size |= (byte & 0x7F) << (7 * nb)
            nb += 1
            if not byte & 0x80:
                break
        out.append((obu_type, tu[p + nb: p + nb + size]))
        pos = p + nb + size
    return out


def test_hdr_metadata_and_color_description():
    """Content-light and mastering-display metadata OBUs ride the keyframe
    temporal unit and the sequence header carries the colour description;
    the stream decodes."""
    rng = np.random.default_rng(9)
    frames = [[rng.integers(0, 255, (64, 96)).astype(np.uint8),
               np.full((32, 48), 120, np.uint8),
               np.full((32, 48), 135, np.uint8)] for _ in range(3)]
    ctx = Config.parse({
        "width": 96, "height": 64, "quantizer": 120,
        "content_light": "1000,400",
        "mastering_display":
            "0.680,0.320,0.265,0.690,0.150,0.060,0.3127,0.3290,"
            "1000.0,0.005",
        "color_description": "9,16,9",
        "color_range": "1"}).new_context(device="cpu")
    pkts = _run(ctx, frames)
    meta = [p for t, p in _obus(pkts[0].data) if t == 5]
    assert sorted(m[0] for m in meta) == [1, 2]
    assert next(m for m in meta if m[0] == 1)[1:5] == bytes(
        [0x03, 0xE8, 0x01, 0x90])
    assert not [t for p in pkts[1:] for t, _ in _obus(p.data) if t == 5]
    assert ctx.sequence().color_description == (9, 16, 9)
    assert len(dav1d.decode_all([p.data for p in pkts])) == 3


def test_odd_sizes_padded_with_render_size():
    """Any input size encodes (50x34, 33x33): padded to the 32-aligned
    coded size (edge replication), the display crop signalled through
    render_size; the decoder's output is the coded size and its crop is
    near the source."""
    rng = np.random.default_rng(7)
    for w, h in ((50, 34), (33, 33)):
        frames = []
        for t in range(4):
            y = (100 + 20 * np.sin((np.arange(w) + 5 * t) / 7)[None, :]
                 + rng.normal(0, 4, (h, w))).clip(0, 255).astype(np.uint8)
            cs = ((h + 1) // 2, (w + 1) // 2)
            frames.append([y, np.full(cs, 128, np.uint8),
                           np.full(cs, 120, np.uint8)])
        ctx = Config(width=w, height=h).new_context(device="cpu")
        assert ctx._render == (w, h)
        pkts = _run(ctx, frames)
        assert pkts[0].frame_type == "KEY"
        assert "INTER" in [p.frame_type for p in pkts]
        dec = dav1d.decode_all([p.data for p in pkts])
        assert len(dec) == len(frames)
        assert dec[0].planes[0].shape == ((h + 31) // 32 * 32,
                                          (w + 31) // 32 * 32)
        for d, f in zip(dec, frames):
            assert np.abs(d.planes[0][:h, :w].astype(int) - f[0]).mean() < 6


def test_send_frame_validates_planes():
    """Mis-sized or mistyped planes fail at the API boundary; a frame after
    the flush is refused."""
    ctx = Config(width=64, height=64).new_context(device="cpu")
    y = np.zeros((64, 64), np.uint8)
    with pytest.raises(ValueError):
        ctx.send_frame([y, np.zeros((64, 64), np.uint8),
                        np.zeros((32, 32), np.uint8)])
    with pytest.raises(ValueError):
        ctx.send_frame([y.astype(np.float32), np.zeros((32, 32), np.uint8),
                        np.zeros((32, 32), np.uint8)])
    with pytest.raises(ValueError):
        ctx.send_frame([np.zeros((32, 64), np.uint8),
                        np.zeros((16, 32), np.uint8),
                        np.zeros((16, 32), np.uint8)])
    ctx.flush()
    assert ctx.send_frame([y, np.zeros((32, 32), np.uint8),
                           np.zeros((32, 32), np.uint8)]
                          ) == EncoderStatus.ENOUGH_DATA


# by ROADMAP item: the configurations it brought to the Context (the JAX
# package codes them on its numpy pipelines or in tiles); none is left
NOT_PORTED = {
    "item 16b": [dict(bit_depth=12), dict(bit_depth=12, speed=4),
                 dict(chroma_sampling="422"), dict(chroma_sampling="444"),
                 dict(extra={"photon_noise": 800}),
                 dict(low_latency=True, extra={"switch_frame_interval": 4}),
                 dict(low_latency=True, extra={"error_resilient": "1"})]
    + [dict(bit_depth=12, speed=s) for s in range(4)],
    "item 17": [dict(width=512, height=128, tiles=2),
                dict(width=256, height=128, tiles=4)],
    "item 14": [dict(extra={"aq": "1"}), dict(speed=10, extra={"aq": "1"})],
}


def test_numpy_pipeline_configurations_raise():
    """Each configuration the JAX package codes on its numpy pipelines or
    in tiles builds a Context now that its ROADMAP item is ported (their
    sessions are held to the JAX package's in test_torch_numpy_inter.py,
    test_torch_aq.py and test_torch_tiles.py; a tiled session gets the
    reference's tile grid). Loop restoration (speeds 0-3) at 12 bits,
    the last to raise, builds one too (its session is held to its
    decodes in test_torch_lrf.py); none raises."""
    for item, cfgs in NOT_PORTED.items():
        for cfg in cfgs:
            kw = dict(width=64, height=64)
            kw.update(cfg)
            ctx = Config(**kw).new_context(device="cpu")
            tiles = cfg.get("tiles", 1)
            assert 1 << (ctx._tile_cols_log2
                         + ctx._tile_rows_log2) == tiles, (item, cfg)


def test_speeds_4_to_10_and_resilience_outside_low_latency():
    """Every speed, 0 to 10, reaches the port's pipelines (no raise) at 8
    and 10 bits, and error_resilient without low_latency stays the
    reference's ValueError."""
    for speed in range(0, 11):
        for bd in (8, 10):
            Config(width=64, height=64, speed=speed,
                   bit_depth=bd).new_context(device="cpu")
    with pytest.raises(ValueError, match="low_latency"):
        Config(width=64, height=64, extra={"error_resilient": "1"}
               ).new_context(device="cpu")

