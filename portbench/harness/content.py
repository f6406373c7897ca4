"""The one generator of video content: every traffic mix is a data file
of its parameters (`portbench/traffic/<mix>.json`) read here.

A stream is a run of shots. Each shot pans a seeded texture, larger than
the frame and periodic, by `pan` = (dy, dx) pixels a frame from a seeded
start; a shot of `shot_frames` frames (0: one shot, no cut) is followed
by a cut to another texture. Each frame adds fresh noise of `noise_sigma`
(rounded, clipped to +-8) from a bank drawn ahead, so the window only
crops and adds. Textures: sinusoids of fixed frequencies and amplitudes
at seeded phases, a seeded smooth field and a seeded static detail field
(the pattern of the repository's `synth_1080p`, made periodic), clipped
to [8, 239] so that the noise never saturates. The same seed gives the
same frames; every seed gives frames of the same statistics, so the work
a frame asks for does not depend on the seed.

Fields are drawn with a `torch.Generator` on the run's device in a few
large calls; shot offsets and phases with numpy's SeedSequence.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

NOISE_CLIP = 8


@dataclass(frozen=True)
class Traffic:
    """A traffic mix's parameters (all from its data file)."""

    pan: tuple            # (dy, dx) luma pixels a frame
    shot_frames: int      # frames a shot; 0 = one shot
    textures: int         # distinct textures, cycled over shots
    texture_hw: tuple     # periodic texture size (luma), > the frame
    noise_sigma: float    # fresh noise a frame
    noise_bank: int       # noise fields drawn ahead

    @classmethod
    def from_dict(cls, d: dict) -> "Traffic":
        return cls(pan=tuple(int(v) for v in d["pan"]),
                   shot_frames=int(d["shot_frames"]),
                   textures=int(d["textures"]),
                   texture_hw=tuple(int(v) for v in d["texture_hw"]),
                   noise_sigma=float(d["noise_sigma"]),
                   noise_bank=int(d["noise_bank"]))


def _rng(seed: int, *key: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, *key]))


def _smooth(gen, h, w, cutoff, std, device):
    """A periodic lowpass field of standard deviation std."""
    f = torch.fft.rfft2(torch.randn((h, w), generator=gen, device=device))
    fy = torch.fft.fftfreq(h, device=device)[:, None]
    fx = torch.fft.rfftfreq(w, device=device)[None, :]
    f *= torch.exp(-(fy * fy + fx * fx) / (2 * cutoff * cutoff))
    x = torch.fft.irfft2(f, s=(h, w))
    return x * (std / x.std().clamp(min=1e-6))


def _texture(seed: int, k: int, hw: tuple, device) -> tuple:
    """Texture k: the luma canvas [2H, 2W] uint8 and the four chroma
    canvases by luma offset parity [(py, px)] -> [H, W] uint8 (H, W the
    chroma size of the period, tiled twice), so that a luma crop at any
    offset has a chroma crop that moves with it."""
    H, W = hw
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([seed, 1, k]).generate_state(
        1, np.uint64)[0]))
    ph = _rng(seed, 2, k).uniform(0, 2 * math.pi, 5)
    yy = torch.arange(H, device=device, dtype=torch.float32)[:, None] / H
    xx = torch.arange(W, device=device, dtype=torch.float32)[None, :] / W
    tau = 2 * math.pi
    y = (100 + 50 * torch.sin(tau * 11 * xx + ph[0])
         + 40 * torch.cos(tau * 11 * yy + ph[1])
         + 20 * torch.sin(tau * 14 * xx + tau * 3 * yy + ph[2])
         + _smooth(gen, H, W, 0.02, 12.0, device)
         + 5 * torch.randn((H, W), generator=gen, device=device))
    c = [(128 + 30 * torch.sin(tau * 7 * xx + ph[3])
          + _smooth(gen, H, W, 0.01, 6.0, device)),
         (128 - 25 * torch.cos(tau * 5 * yy + ph[4])
          + _smooth(gen, H, W, 0.01, 6.0, device))]

    def u8(x):
        return x.round().clamp(8, 239).to(torch.uint8)

    luma = u8(y).repeat(2, 2).cpu().numpy()
    chroma = {}
    for py in (0, 1):
        for px in (0, 1):
            chroma[py, px] = [
                u8(torch.nn.functional.avg_pool2d(
                    torch.roll(p, (-py, -px), (0, 1))[None, None], 2)[0, 0]
                   ).repeat(2, 2).cpu().numpy() for p in c]
    return luma, chroma


class Content:
    """The frames of one run: `frame(i)` -> [y, u, v] uint8 (noisy, as
    sent), `clean(i)` -> the same without the noise, `shot(i)`."""

    def __init__(self, traffic: Traffic, width: int, height: int,
                 seed: int, device):
        if width % 2 or height % 2:
            raise ValueError("4:2:0 content needs even dimensions")
        H, W = traffic.texture_hw
        if H < height or W < width:
            raise ValueError(f"texture {W}x{H} is smaller than the frame "
                             f"{width}x{height}")
        self.t, self.w, self.h, self.seed = traffic, width, height, seed
        self.textures = [_texture(seed, k, (H, W), device)
                         for k in range(traffic.textures)]
        gen = torch.Generator(device=device)
        gen.manual_seed(int(np.random.SeedSequence([seed, 3]).generate_state(
            1, np.uint64)[0]))
        K = traffic.noise_bank
        shapes = [(K, height, width)] + [(K, height // 2, width // 2)] * 2

        def bank(shape):
            n = torch.randn(shape, generator=gen, device=device)
            n = (n * traffic.noise_sigma).round().clamp(-NOISE_CLIP,
                                                        NOISE_CLIP)
            return (n + NOISE_CLIP).to(torch.uint8).cpu().numpy()

        self.noise = [bank(s) for s in shapes]
        self._starts = {}

    def shot(self, i: int) -> tuple:
        """(shot index, frame index within the shot)."""
        L = self.t.shot_frames
        return (i // L, i % L) if L else (0, i)

    def _start(self, s: int) -> tuple:
        if s not in self._starts:
            H, W = self.t.texture_hw
            r = _rng(self.seed, 4, s)
            self._starts[s] = (int(r.integers(0, H)), int(r.integers(0, W)))
        return self._starts[s]

    def _crop(self, i: int):
        s, j = self.shot(i)
        H, W = self.t.texture_hw
        oy, ox = self._start(s)
        y0 = (oy + j * self.t.pan[0]) % H
        x0 = (ox + j * self.t.pan[1]) % W
        luma, chroma = self.textures[s % len(self.textures)]
        h, w = self.h, self.w
        cu, cv = chroma[y0 & 1, x0 & 1]
        cy, cx = y0 >> 1, x0 >> 1
        return [luma[y0:y0 + h, x0:x0 + w],
                cu[cy:cy + h // 2, cx:cx + w // 2],
                cv[cy:cy + h // 2, cx:cx + w // 2]]

    def clean(self, i: int) -> list:
        return [np.array(p) for p in self._crop(i)]

    def frame(self, i: int) -> list:
        k = i % self.t.noise_bank
        out = []
        for p, n in zip(self._crop(i), self.noise):
            f = np.add(p, n[k])
            np.subtract(f, NOISE_CLIP, out=f)
            out.append(f)
        return out
