"""The port's lookahead (analysis/lookahead.py) against the JAX package's,
on the CPU, with the same numpy-made frames.

The pair stats' mv and inter cost are bit-exact: the SSD's three terms
are exact integer sums and its two f32 operations are formed in the
reference's order. The intra cost (the DC residual's f32 sum of squares,
in the reference's fused lane order) is bit-exact too; the
distortion-scale grids it feeds are held to a relative 1e-5 (the
importance walk divides by it and takes powers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rav1e_tpu.analysis import lookahead as jl
from rav1e_tpu.pipeline.tpu_inter import pack_src as jpack_src
from rav1e_tpu_torch.analysis import lookahead as tl
from rav1e_tpu_torch.pipeline.tpu_inter import pack_src

DSCALE_RTOL = 1e-5


def _pair(kind: str, h: int, w: int, seed: int = 5):
    """(cur, prev) luma planes: a textured pan with noise, a smooth
    diagonal drift, or flat content on which many offsets tie (the first
    minimum wins)."""
    rng = np.random.default_rng(seed)
    if kind == "pan":
        prev = rng.integers(0, 256, (h, w))
        cur = np.roll(prev, (3, -5), (0, 1)) + rng.integers(-3, 4, (h, w))
    elif kind == "smooth":
        yy, xx = np.mgrid[0:h, 0:w]
        prev = 128 + 60 * np.sin(xx / 9) + 50 * np.cos(yy / 7)
        cur = 128 + 60 * np.sin((xx + 2) / 9) + 50 * np.cos((yy - 1) / 7)
    else:
        prev = np.full((h, w), 255)
        prev[:, : w // 3] = 7
        cur = np.full((h, w), 255)
        cur[: h // 2] = 0
    return (np.clip(cur, 0, 255).astype(np.uint8),
            np.clip(prev, 0, 255).astype(np.uint8))


def _planes(y):
    h, w = y.shape
    return [y, np.full((h // 2, w // 2), 120, np.uint8),
            np.full((h // 2, w // 2), 133, np.uint8)]


def _same_stats(ref, got):
    (jm, ji, jn), (tm, ti, tn) = ref, got
    np.testing.assert_array_equal(tm, np.asarray(jm))
    np.testing.assert_array_equal(ti, np.asarray(ji))
    assert tm.dtype == np.int32 and ti.dtype == tn.dtype == np.float32
    np.testing.assert_array_equal(tn, np.asarray(jn))


@pytest.mark.parametrize("h,w", [(96, 128), (128, 192)])
def test_pair_stats_match_reference(h, w):
    """On pan, smooth and flat content, _pair_stats_fn on the luma planes
    and _pair_stats_packed_fn on the pack_src buffers give the
    reference's mv, inter cost and intra cost exactly; on flat content
    all 289 offsets of some blocks tie at 0, and both take the first,
    (-8, -8)."""
    for kind in ("pan", "smooth", "flat"):
        cur, prev = _pair(kind, h, w)
        bufs = [pack_src(_planes(cur)), pack_src(_planes(prev))]
        jbufs = [jnp.asarray(jpack_src(_planes(cur))),
                 jnp.asarray(jpack_src(_planes(prev)))]
        for ref, got in (
                (jl._pair_stats_fn(h, w)(cur, prev),
                 tl._pair_stats_fn(h, w)(torch.from_numpy(cur),
                                         torch.from_numpy(prev))),
                (jl._pair_stats_packed_fn(h, w)(*jbufs),
                 tl._pair_stats_packed_fn(h, w)(
                     *map(torch.from_numpy, bufs)))):
            _same_stats(ref, [x.numpy() for x in got])
            if kind == "flat":
                # blocks of 255 whose whole search window is 255
                tie = got[0].numpy()[h // 32:, -(-(w // 3 + 8) // 16):]
                assert tie.size and (tie == -8).all()


def test_packed_pair_stats_crop_to_the_grid():
    """_pair_stats_packed_fn at 200x100 codes the 192x96 luma that fits
    the 16-grid, as the reference does."""
    cur, prev = _pair("pan", 100, 200, seed=9)
    ref = jl._pair_stats_packed_fn(100, 200)(
        jnp.asarray(jpack_src(_planes(cur))),
        jnp.asarray(jpack_src(_planes(prev))))
    got = tl._pair_stats_packed_fn(100, 200)(
        torch.from_numpy(pack_src(_planes(cur))),
        torch.from_numpy(pack_src(_planes(prev))))
    assert got[1].shape == (6, 12)
    _same_stats(ref, [x.numpy() for x in got])


def test_intra_cost_order_and_the_8_bit_gate():
    """On pack_src buffers of pan and smooth content the intra cost
    equals the reference's bit for bit where a plain torch.sum of the
    same squares differs in some blocks (the fused lane order matters
    at 8 bits). The lookahead runs, as the reference's, on 8-bit 4:2:0
    untiled sessions only: a 10-bit, 4:4:4 or tiled Context builds
    none, and the pair stats of 10-bit buffers raise ValueError."""
    from rav1e_tpu_torch.api import Config
    h, w = 96, 128
    for kind in ("pan", "smooth"):
        cur, prev = _pair(kind, h, w)
        ref = jl._pair_stats_packed_fn(h, w)(
            *(jnp.asarray(jpack_src(_planes(p))) for p in (cur, prev)))
        got = tl._pair_stats_packed_fn(h, w)(
            *(torch.from_numpy(pack_src(_planes(p))) for p in (cur, prev)))
        intra = got[2].numpy()
        np.testing.assert_array_equal(intra, np.asarray(ref[2]))
        blks = torch.from_numpy(cur.astype(np.float32)).reshape(
            h // 16, 16, w // 16, 16).permute(0, 2, 1, 3).reshape(-1, 16, 16)
        d = blks - (blks.sum((1, 2)) * (1.0 / 256))[:, None, None]
        assert ((d * d).sum((1, 2)).numpy() != intra.ravel()).any()
        with pytest.raises(ValueError, match="8-bit"):
            tl._pair_stats_packed_fn(h, w)(
                *(torch.from_numpy(pack_src(_planes(p.astype(np.uint16) << 2),
                                            bd=10)) for p in (cur, prev)))
    base = dict(width=128, height=128, speed=6)
    assert Config(**base).new_context(device="cpu")._lookahead is not None
    for kw in (dict(bit_depth=10), dict(chroma_sampling="444"),
               dict(tiles=4)):
        ctx = Config(**base, **kw).new_context(device="cpu")
        assert ctx._lookahead is None, kw


def _window_frames(h=96, w=128, n=10, seed=21):
    """A static smooth background with a flat left band and a textured
    24x24 mover: importance varies by block, so the scales are not all
    ones."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(seed)
    bg = 128 + gaussian_filter(rng.normal(0, 50, (h, w)), 2.0)
    obj = 128 + gaussian_filter(rng.normal(0, 70, (24, 24)), 1.2)
    out = []
    for t in range(n):
        y = bg.copy()
        y[:, : w // 4] = 90
        oy, ox = 20 + 2 * t, 40 + 5 * t
        y[oy:oy + 24, ox:ox + 24] = obj
        out.append(np.clip(y + rng.normal(0, 1.0, (h, w)), 0,
                           255).astype(np.uint8))
    return out


def test_lookahead_window_scales_match_reference():
    """A window of 10 packed pushes (the Context's route), tune psnr and
    psychovisual: scales_at(k) for k = 0..3 within DSCALE_RTOL of the
    reference's, after a pop too; the grid is not all ones."""
    frames = _window_frames()
    h, w = frames[0].shape
    for tune in ("psnr", "psychovisual"):
        ref = jl.Lookahead(depth=8, tune=tune)
        got = tl.Lookahead(depth=8, tune=tune)
        for y in frames:
            ref.push_packed(jnp.asarray(jpack_src(_planes(y))), h, w)
            got.push_packed(torch.from_numpy(pack_src(_planes(y))), h, w)
        assert len(got._pending) == 9 and not got._stats  # fetched lazily
        for pop in (False, True):
            if pop:
                ref.pop()
                got.pop()
            for k in range(4):
                a = ref.scales_at(k, frames[k + pop])
                b = got.scales_at(k, frames[k + pop])
                assert b.dtype == np.float32
                assert b.shape == (h // 16, w // 16)
                np.testing.assert_allclose(b, a, rtol=DSCALE_RTOL, atol=0)
                assert np.ptp(b) > 0.05
