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
