"""The CDEF kernels of csrc/cdef.cu against their plain torch versions,
on the card (`python -m pytest tests/test_torch_cdef_cuda.py -m cuda`;
they skip on a machine without CUDA), and the wrappers' dtype checks on
both routes. This file imports no jax, so it runs on the card's machine;
tests/test_torch_cdef.py holds the plain versions to the JAX package on
the CPU."""

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from rav1e_tpu_torch.ops import cdef as tc


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def content(w, h, seed=1):
    """(recon planes, source planes, skip8) as int32 / bool numpy: the
    deblocked-recon-like content of tests/test_torch_cdef.py."""
    rng = np.random.default_rng(seed)

    def plane(ph, pw, sigma, sb):
        tex = gaussian_filter(rng.normal(0, 40, (ph, pw)), sigma) * 3 + 128
        edges = ((np.arange(pw)[None] // 13 + np.arange(ph)[:, None] // 9)
                 % 2) * 40
        src = (tex + edges).clip(0, 255)
        amp = np.kron(rng.choice([0.0, 0.7, 1.5, 3.0, 5.0, 8.0],
                                 (-(-ph // sb), -(-pw // sb))),
                      np.ones((sb, sb)))[:ph, :pw]
        rec = (src + rng.normal(0, 1, (ph, pw)) * amp
               + np.kron(rng.normal(0, 3, (ph // 8, pw // 8)),
                         np.ones((8, 8))))
        return src.astype(np.int32), rec.clip(0, 255).astype(np.int32)

    y, u, v = (plane(h, w, 2.0, 64), plane(h // 2, w // 2, 1.5, 32),
               plane(h // 2, w // 2, 1.5, 32))
    skip8 = rng.random((h // 8, w // 8)) < 0.2
    return [y[1], u[1], v[1]], [y[0], u[0], v[0]], skip8


@pytest.mark.cuda
@pytest.mark.parametrize("w,h", [(1920, 1088), (1920, 1056)])
def test_kernels_equal_plain_on_card(w, h):
    """On the card: cdef_dirs, cdef_ladder_sse and cdef_apply (ladder
    winners, every entry, a uniform strength) equal their plain versions
    exactly, on both branches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rec, src, skip8 = content(w, h, seed=4)
    recd = [_t(p.astype(np.uint8)).cuda() for p in rec]
    srcd = [_t(p.astype(np.uint8)).cuda() for p in src]
    sk = _t(skip8).cuda()
    dirs, var = tc.cdef_dirs(recd[0])
    dp, vp = tc.cdef_dirs_plain(recd[0])
    assert torch.equal(dirs, dp) and torch.equal(var, vp)
    sampled = h % 64 == 0
    sses = []
    for i in range(3):
        args = (recd[i], srcd[i], dirs, var, sk, 4, i > 0, sampled)
        got = tc.cdef_ladder_sse(*args)
        assert torch.equal(got, tc.cdef_ladder_sse_plain(*args)), i
        sses.append(got)
    nr, nc = (h // 32 + 1) // 2, (w // 32 + 1) // 2
    idx = tc._choose(tc._sse_sb(sses, sampled, nr, nc), None)
    every = (torch.arange(nr * nc, device="cuda") % 8).reshape(nr, nc)
    for i in range(3):
        args = (recd[i], dirs, var, sk, 4, i > 0)
        for ix in (idx, every):
            got = tc.cdef_apply(*args, idx=ix)
            assert torch.equal(got, tc.cdef_apply_plain(*args, idx=ix)), i
        got = tc.cdef_apply(*args, pri=0 if i else 3, sec=2)
        assert torch.equal(got, tc.cdef_apply_plain(*args, pri=0 if i else 3,
                                                    sec=2)), i


@pytest.mark.parametrize("dev", ["cpu", pytest.param("cuda",
                                                    marks=pytest.mark.cuda)])
@pytest.mark.parametrize("what", ["dirs", "var"])
def test_grids_of_another_dtype_raise(dev, what):
    """The kernels read dirs as int8 and var as int32: a grid of another
    dtype (int32 directions, say) raises on both routes instead of being
    read as the wrong bytes on the card."""
    if dev == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rec, src, skip8 = content(64, 64, seed=2)
    p = _t(rec[0]).to(dev)
    s = _t(src[0]).to(dev)
    sk = _t(skip8).to(dev)
    dirs, var = tc.cdef_dirs(p.to(torch.uint8))
    if what == "dirs":
        dirs = dirs.to(torch.int32)
    else:
        var = var.to(torch.int64)
    with pytest.raises(ValueError, match=f"{what} must be"):
        tc.cdef_ladder_sse(p, s, dirs, var, sk, 4, False, True)
    with pytest.raises(ValueError, match=f"{what} must be"):
        tc.cdef_apply(p, dirs, var, sk, 4, False, idx=torch.zeros(
            (1, 1), dtype=torch.int32, device=dev))
