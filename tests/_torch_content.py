"""Content shared by the port's CDEF tests and chip_smoke.py: the bin maps
of cdef_dirs' eight directions and 8x8 blocks at the ends of its range.
Plain numpy; the tests import it as `_torch_content`, and chip_smoke.py
loads it by its path."""

import numpy as np

_II, _JJ = np.mgrid[0:8, 0:8]
# direction d's bin of each pixel (i, j) of an 8x8 block (libaom's
# cdef_find_dir): its bins sum x - 128 along d's lines
DIR_BINS = (_II + _JJ, _II + (_JJ >> 1), _II, 3 + _II - (_JJ >> 1),
            7 + _II - _JJ, 3 - (_II >> 1) + _JJ, _JJ, (_II >> 1) + _JJ)


def dir_extremes(w_blocks: int = 32):
    """8x8 blocks at the ends of cdef_dirs' range, side by side in an
    8 x 8k uint8 plane: all 0 (every direction's cost is 880,803,840, the
    int32 bound: dir 0, var 0), all 255, and for each direction d a ramp
    across d's lines (constant along them) and 0 / 255 stripes along
    them; the rest of the w_blocks blocks random bytes."""
    rng = np.random.default_rng(23)
    blocks = [np.zeros((8, 8)), np.full((8, 8), 255)]
    for b in DIR_BINS:
        blocks.append(255 * b // b.max())
        blocks.append(255 * (b % 2))
    while len(blocks) < w_blocks:
        blocks.append(rng.integers(0, 256, (8, 8)))
    return np.concatenate(blocks, 1).astype(np.uint8)


def bgroup(w: int = 128, h: int = 96, n: int = 3, seed: int = 31):
    """n frames [y, u, v] (uint8, 4:2:0) for the two-reference step: a
    static textured background whose left third fades from a random
    texture to its negative (the middle frames are best predicted by the
    average of the ends: compound), and an occluding textured 24x24 mover
    crossing the middle third (each end uncovers background the other
    hides: single-fwd and single-bwd blocks; its edges split 32-blocks).
    The content of the JAX package's B-frame tests
    (tests/test_inter_conformance.py test_tpu_bframe_compound and
    test_bframe_split_conformance), in one group."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(seed)
    base = gaussian_filter(rng.normal(0, 60, (h, w)), 1.1)
    tex = rng.integers(40, 220, (h, w // 3)).astype(np.float64)
    obj = gaussian_filter(rng.normal(0, 80, (24, 24)), 1.5)
    out = []
    for t in range(n):
        a = t / (n - 1)
        y = 128 + base
        y[:, :w // 3] = ((1 - a) * tex + a * (255 - tex)
                         + rng.normal(0, 2, (h, w // 3)))
        oy = h // 6 + round(a * h // 4)
        ox = 3 * w // 8 + round(a * 11 * w // 32)
        y[oy:oy + 24, ox:ox + 24] = 128 + obj
        out.append([y.clip(0, 255).astype(np.uint8),
                    np.full((h // 2, w // 2), 120, np.uint8),
                    np.full((h // 2, w // 2), 133, np.uint8)])
    return out


def session(w: int = 128, h: int = 96, n: int = 9, seed: int = 12):
    """n frames [y, u, v] (uint8, 4:2:0) for a Context: a static smooth
    textured background, a static flat ramp over its left quarter, and a
    textured 24x24 mover (2 px down, 5 px right a frame), with light
    noise. Importance differs by block, so the lookahead's distortion
    scales are not all ones; the texture is too smooth for the speed-6
    keyframe's 16->8 split gate (_detail_band8 about 11, gate 256)."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(seed)
    bg = 128 + gaussian_filter(rng.normal(0, 50, (h, w)), 2.0)
    obj = 128 + gaussian_filter(rng.normal(0, 70, (24, 24)), 1.2)
    out = []
    for t in range(n):
        y = bg.copy()
        y[:, : w // 4] = 90 + 0.4 * np.arange(w // 4)[None, :]
        oy, ox = 20 + 2 * t, 40 + 5 * t
        y[oy:oy + 24, ox:ox + 24] = obj
        y = y + rng.normal(0, 1.0, (h, w))
        out.append([y.clip(0, 255).astype(np.uint8),
                    np.full((h // 2, w // 2), 120, np.uint8),
                    np.full((h // 2, w // 2), 133, np.uint8)])
    return out
