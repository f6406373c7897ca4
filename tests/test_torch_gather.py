"""The patch gather (rav1e_tpu_torch.ops.gather) against the JAX
package's gathers, on the CPU: the plain version must equal
jax.vmap(jax.lax.dynamic_slice), whose start rule the main path relies
on, and the port's _gather_patch must equal the JAX one. The CUDA kernel
is held to the plain version on the card. The JAX package is imported
inside the tests that need it, so the card tests also run on a GPU
machine without jax (python -m pytest tests/test_torch_gather.py -m
cuda)."""

import numpy as np
import pytest
import torch

from rav1e_tpu_torch.ops import gather as G

PATCH_SIZES = [23, 39, 41, 43]


def _starts(rng, B, H, W, P):
    """Random starts that include ones below 0 and past H-P / W-P."""
    r0 = rng.integers(-P - 5, H + 5, B).astype(np.int32)
    c0 = rng.integers(-P - 5, W + 5, B).astype(np.int32)
    r0[:4] = [-1, -3 * P, H - P + 1, H]
    c0[:4] = [W - P + 2, -7, 0, W]
    return r0, c0


def _jax_gather(plane, r0, c0, P):
    import jax
    import jax.numpy as jnp
    return np.asarray(jax.vmap(
        lambda r, c: jax.lax.dynamic_slice(plane, (r, c), (P, P)))(
            jnp.asarray(r0), jnp.asarray(c0)))


@pytest.mark.parametrize("P", PATCH_SIZES)
def test_plain_gather_equals_clamped_dynamic_slice(P):
    """gather_patches (a CPU tensor takes the plain version) equals
    vmap(dynamic_slice), out-of-range starts included."""
    rng = np.random.default_rng(P)
    H, W = 96, 160
    plane = rng.integers(-300, 300, (H, W)).astype(np.int32)
    r0, c0 = _starts(rng, 64, H, W, P)
    out = G.gather_patches(torch.from_numpy(plane), torch.from_numpy(r0),
                           torch.from_numpy(c0), P)
    assert out.dtype == torch.int32 and out.shape == (64, P, P)
    np.testing.assert_array_equal(out.numpy(),
                                  _jax_gather(plane, r0, c0, P))


@pytest.mark.parametrize("n,ss,M", [(32, 0, 2), (32, 0, 1), (16, 1, 2)])
def test_gather_patch_equals_reference(n, ss, M):
    """The port's _gather_patch (centre-MV patches of n+7+2M) equals the
    JAX _gather_patch, for MVs that push windows off the padded plane."""
    import jax.numpy as jnp

    from rav1e_tpu.pipeline import tpu_inter as jinter
    from rav1e_tpu_torch.pipeline import tpu_inter as tinter
    rng = np.random.default_rng(n + M)
    nby, nbx = 3, 4
    h, w = (32 * nby) >> ss, (32 * nbx) >> ss
    p = jinter.PAD >> ss
    plane = rng.integers(0, 256, (h + 2 * p, w + 2 * p)).astype(np.int32)
    by = (np.repeat(np.arange(nby), nbx) * (32 >> ss)).astype(np.int32)
    bx = (np.tile(np.arange(nbx), nby) * (32 >> ss)).astype(np.int32)
    mv = rng.integers(-400, 400, (nby * nbx, 2)).astype(np.int32)
    pj, rj, cj = jinter._gather_patch(jnp.asarray(plane), jnp.asarray(by),
                                      jnp.asarray(bx), jnp.asarray(mv), n,
                                      ss, M)
    pt, rt, ct = tinter._gather_patch(*(torch.from_numpy(x) for x in
                                        (plane, by, bx, mv)), n, ss, M)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


def test_negative_start_counts_from_the_end():
    """jax.lax.dynamic_slice (allow_negative_indices=True, its default)
    adds the axis length to a negative start before clamping, so start
    -1 reads the LAST window, not the first. The port follows it."""
    plane = np.arange(20 * 30, dtype=np.int32).reshape(20, 30)
    r0 = np.array([-1, -25, 3], np.int32)
    c0 = np.array([-4, 2, -31], np.int32)
    out = G.gather_patches(torch.from_numpy(plane), torch.from_numpy(r0),
                           torch.from_numpy(c0), 8).numpy()
    np.testing.assert_array_equal(out, _jax_gather(plane, r0, c0, 8))
    np.testing.assert_array_equal(out[0], plane[12:20, 22:30])
    np.testing.assert_array_equal(out[1], plane[0:8, 2:10])
    np.testing.assert_array_equal(out[2], plane[3:11, 0:8])


@pytest.mark.parametrize("r", [-9, -6, -1, 0, 3, 5, 8])
def test_keyframe_row_start_rule_matches_dynamic_slice(r):
    """The keyframe wavefront's one-row reads and writes
    (tpu_intra._clamp_row) take the same start rule, for
    dynamic_slice and dynamic_update_slice alike."""
    import jax
    import jax.numpy as jnp

    from rav1e_tpu_torch.pipeline.tpu_intra import _clamp_row
    a = np.arange(6 * 2, dtype=np.int32).reshape(6, 2)
    got = _clamp_row(a, r)
    np.testing.assert_array_equal(
        a[got], np.asarray(jax.lax.dynamic_slice(a, (r, 0), (1, 2)))[0])
    upd = np.asarray(jax.lax.dynamic_update_slice(
        jnp.zeros((6, 2), jnp.int32), jnp.ones((1, 2), jnp.int32), (r, 0)))
    assert upd[got].all() and upd.sum() == 2


def test_wrapper_rejects_bad_inputs():
    plane = torch.zeros((40, 40), dtype=torch.int32)
    s = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        G.gather_patches(plane.to(torch.int64), s, s, 8)
    with pytest.raises(ValueError, match="does not fit"):
        G.gather_patches(plane, s, s, 41)
    with pytest.raises(ValueError, match="starts"):
        G.gather_patches(plane, s.to(torch.int64), s, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [23, 39, 43])
def test_kernel_equals_plain_on_the_card(P):
    """The CUDA kernel against the plain version on the card, on the
    1080p planes' shapes with clamped starts; each launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(P)
    H, W = (1152, 1984) if P != 23 else (576, 992)
    plane = torch.from_numpy(
        rng.integers(0, 256, (H, W)).astype(np.int32)).cuda()
    r0, c0 = (torch.from_numpy(x).cuda() for x in _starts(rng, 2040, H, W,
                                                           P))
    n0 = G.gather_patches.launches
    out = G.gather_patches(plane, r0, c0, P)
    torch.cuda.synchronize()
    assert G.gather_patches.launches == n0 + 1
    assert torch.equal(out, G.gather_patches_plain(plane, r0, c0, P))
