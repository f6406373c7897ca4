"""Quality metrics: PSNR / SSIM and Bjontegaard BD-rate.

Reference parity: rav1e's CLI computes PSNR via the av-metrics crate
(SURVEY §5.5 "Metrics"); BD-rate is the standard tool used to compare
encoders at equal quality (BASELINE.md row 2 "BD-rate vs rav1e >= 0").
The port's copy of the JAX package's module (host numpy).
"""

from __future__ import annotations

import numpy as np


def plane_psnr(a: np.ndarray, b: np.ndarray, max_val: int = 255) -> float:
    """PSNR of one plane in dB (inf -> 100 dB cap, av-metrics style)."""
    d = a.astype(np.float64) - b.astype(np.float64)
    mse = float(np.mean(d * d))
    if mse == 0:
        return 100.0
    return min(100.0, 10.0 * np.log10(max_val * max_val / mse))


def frame_psnr(src: list[np.ndarray], rec: list[np.ndarray],
               max_val: int = 255) -> dict:
    """Per-plane + combined PSNR. Combined pools SSE over all samples
    of all planes (PSNR-YUV), matching av-metrics' 'psnr avg'."""
    sse = 0.0
    n = 0
    per = []
    for s, r in zip(src, rec):
        d = s.astype(np.float64) - r.astype(np.float64)
        sse += float(np.sum(d * d))
        n += d.size
        per.append(plane_psnr(s, r, max_val))
    mse = sse / n
    comb = 100.0 if mse == 0 else min(
        100.0, 10.0 * np.log10(max_val * max_val / mse))
    return {"y": per[0], "u": per[1], "v": per[2], "yuv": comb}


def seq_psnr(srcs, recs, max_val: int = 255) -> dict:
    """Sequence PSNR: pooled MSE over all frames (not mean of dB)."""
    sse = np.zeros(4)
    n = np.zeros(4)
    for src, rec in zip(srcs, recs):
        for i, (s, r) in enumerate(zip(src, rec)):
            d = s.astype(np.float64) - r.astype(np.float64)
            sse[i] += float(np.sum(d * d))
            n[i] += d.size
    sse[3] = sse[:3].sum()
    n[3] = n[:3].sum()
    mse = np.where(n > 0, sse / np.maximum(n, 1), 0.0)
    with np.errstate(divide="ignore"):
        db = 10.0 * np.log10(max_val * max_val / np.where(mse > 0, mse, 1))
    db = np.where(mse == 0, 100.0, np.minimum(db, 100.0))
    return {"y": db[0], "u": db[1], "v": db[2], "yuv": db[3]}


def ssim_plane(a: np.ndarray, b: np.ndarray, max_val: int = 255) -> float:
    """Global-window SSIM on 8x8 tiles (fast approximation of the
    standard 11x11-gaussian SSIM; adequate for A/B deltas)."""
    from scipy.ndimage import uniform_filter
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu_a = uniform_filter(a, 8)
    mu_b = uniform_filter(b, 8)
    var_a = uniform_filter(a * a, 8) - mu_a * mu_a
    var_b = uniform_filter(b * b, 8) - mu_b * mu_b
    cov = uniform_filter(a * b, 8) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)
         / ((mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2)))
    return float(np.mean(s))


def bd_rate(rate_ref, psnr_ref, rate_test, psnr_test) -> float:
    """Bjontegaard delta-rate (%): average bitrate change of `test` vs
    `ref` at equal quality. Negative = test needs fewer bits. PCHIP
    integration over the overlapping PSNR interval (the modern
    BD-rate formulation; falls back gracefully on short curves)."""
    from scipy.interpolate import PchipInterpolator
    lr_ref = np.log(np.asarray(rate_ref, np.float64))
    lr_tst = np.log(np.asarray(rate_test, np.float64))
    p_ref = np.asarray(psnr_ref, np.float64)
    p_tst = np.asarray(psnr_test, np.float64)
    # sort by PSNR ascending, require monotonic curves
    o1 = np.argsort(p_ref)
    o2 = np.argsort(p_tst)
    p_ref, lr_ref = p_ref[o1], lr_ref[o1]
    p_tst, lr_tst = p_tst[o2], lr_tst[o2]
    lo = max(p_ref.min(), p_tst.min())
    hi = min(p_ref.max(), p_tst.max())
    if hi <= lo:
        raise ValueError("PSNR ranges do not overlap")
    f_ref = PchipInterpolator(p_ref, lr_ref)
    f_tst = PchipInterpolator(p_tst, lr_tst)
    xs = np.linspace(lo, hi, 256)
    avg_diff = np.trapezoid(f_tst(xs) - f_ref(xs), xs) / (hi - lo)
    return float((np.exp(avg_diff) - 1.0) * 100.0)
