"""Each coded frame's reconstruction (the frame it leaves as a reference)
against the frame the harness sent: plain numpy, in float64."""

from __future__ import annotations

import numpy as np

SB = 64


def _mse(a, b) -> float:
    d = a.astype(np.float64) - b.astype(np.float64)
    return float(np.mean(d * d))


def _sb_mse_max(a, b) -> float:
    """The largest MSE of any 64x64 block (whole blocks of the frame)."""
    h, w = a.shape[0] // SB * SB, a.shape[1] // SB * SB
    d = a[:h, :w].astype(np.float64) - b[:h, :w].astype(np.float64)
    d = (d * d).reshape(h // SB, SB, w // SB, SB).mean((1, 3))
    return float(d.max())


def frame_numbers(rec, src) -> dict:
    """rec: the recon's [y, u, v] at the coded size (cropped here to the
    frame); src: the frame as sent."""
    h, w = src[0].shape
    r = [np.asarray(rec[0])[:h, :w], np.asarray(rec[1])[:h // 2, :w // 2],
         np.asarray(rec[2])[:h // 2, :w // 2]]
    return {
        "mse_y": _mse(r[0], src[0]),
        "mse_uv": max(_mse(r[1], src[1]), _mse(r[2], src[2])),
        "sb_mse_y": _sb_mse_max(r[0], src[0]),
    }
