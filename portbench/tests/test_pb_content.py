import numpy as np

from portbench.harness.content import NOISE_CLIP, Content, Traffic

PAN = Traffic(pan=(1, 3), shot_frames=0, textures=1, texture_hw=(160, 224),
              noise_sigma=2.0, noise_bank=4)
CUTS = Traffic(pan=(1, 3), shot_frames=15, textures=3, texture_hw=(160, 224),
               noise_sigma=2.0, noise_bank=4)


def test_same_seed_same_frames():
    a = Content(PAN, 128, 96, 2**33 + 7, "cpu")
    b = Content(PAN, 128, 96, 2**33 + 7, "cpu")
    c = Content(PAN, 128, 96, 2**33 + 8, "cpu")
    for i in (0, 5, 77):
        for p, q in zip(a.frame(i), b.frame(i)):
            assert np.array_equal(p, q)
    assert not np.array_equal(a.frame(3)[0], c.frame(3)[0])


def test_frames_pan_and_noise():
    c = Content(PAN, 128, 96, 11, "cpu")
    y0, y1 = c.clean(0)[0], c.clean(1)[0]
    # the clean texture moves 1 down and 3 right a frame
    assert np.array_equal(y1[:-1, :-3], y0[1:, 3:])
    for i in (0, 1, 400):                       # wraps the period
        f, g = c.frame(i), c.clean(i)
        assert [p.shape for p in f] == [(96, 128), (48, 64), (48, 64)]
        for p, q in zip(f, g):
            d = p.astype(int) - q.astype(int)
            assert np.abs(d).max() <= NOISE_CLIP and d.std() > 1.0
    # fresh noise: frame 1's noise is not frame 0's moved
    n0 = c.frame(0)[0].astype(int) - c.clean(0)[0]
    n1 = c.frame(1)[0].astype(int) - c.clean(1)[0]
    assert abs(np.corrcoef(n0[1:, 3:].ravel(), n1[:-1, :-3].ravel())[0, 1]) \
        < 0.1


def test_cuts_every_15_frames():
    c = Content(CUTS, 128, 96, 5, "cpu")
    assert [c.shot(i) for i in (0, 14, 15, 29, 30)] == [
        (0, 0), (0, 14), (1, 0), (1, 14), (2, 0)]
    # within a shot each frame is the last one moved (1, 3); at a cut not
    cuts = [i for i in range(1, 50)
            if not np.array_equal(c.clean(i)[0][:-1, :-3],
                                  c.clean(i - 1)[0][1:, 3:])]
    assert cuts == [15, 30, 45]
