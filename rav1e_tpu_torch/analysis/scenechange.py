"""Scene-change detection.

Reference parity: rav1e src/scenechange/mod.rs
`SceneChangeDetector::analyze_next_frame`. Two modes there: fast
(downscaled inter-frame SAD against an adaptive threshold) and
standard (intra-cost vs inter-cost comparison). Both are implemented
here: fast box-downscales luma so the longer edge is <= 128 px and
thresholds the mean absolute difference like rav1e's FAST_THRESHOLD;
standard compares per-8x8 SATD intra costs against motion-compensated
inter costs on the downscaled luma (rav1e estimate_intra_costs /
estimate_inter_costs) — temporal prediction failing to beat spatial
prediction marks a cut, which catches flashes/fades the fast mode's
absolute threshold misses.

Detection is an encoder-side decision only - no bitstream conformance
surface - so the contract is behavioral: cuts on real discontinuities,
quiet on translating/noisy content (see tests).
"""

from __future__ import annotations

import numpy as np

FAST_THRESHOLD = 18.0  # mean-abs-diff per pixel at 8-bit, like rav1e

_HAD8 = None


def _had8():
    global _HAD8
    if _HAD8 is None:
        h = np.array([[1.0]])
        for _ in range(3):
            h = np.block([[h, h], [h, -h]])
        _HAD8 = h.astype(np.float32)
    return _HAD8


def _satd8(blocks: np.ndarray) -> np.ndarray:
    """Per-block 8x8 Hadamard SATD, SAD-normalized (/8): [N,8,8]->[N]."""
    h = _had8()
    t = np.einsum("ij,njl,ml->nim", h, blocks.astype(np.float32), h)
    return np.abs(t).sum(axis=(1, 2)) * 0.125


def _to_blocks8(y: np.ndarray) -> np.ndarray:
    hh, ww = y.shape[0] // 8 * 8, y.shape[1] // 8 * 8
    return (y[:hh, :ww].reshape(hh // 8, 8, ww // 8, 8)
            .transpose(0, 2, 1, 3).reshape(-1, 8, 8))


def estimate_intra_costs(y: np.ndarray) -> np.ndarray:
    """Per-8x8 SATD of the residual against the block mean (DC intra
    proxy; rav1e src/scenechange::estimate_intra_costs)."""
    b = _to_blocks8(y)
    return _satd8(b - b.mean(axis=(1, 2), keepdims=True))


def estimate_inter_costs(y: np.ndarray, prev: np.ndarray,
                         search: int = 4) -> np.ndarray:
    """Per-8x8 min-SATD over a +/-search full-pel window vs the
    previous (downscaled) frame (rav1e estimate_inter_costs: a cheap
    ME pass on the half-resolution planes)."""
    cur = _to_blocks8(y)
    n = cur.shape[0]
    best = np.full(n, np.inf, np.float32)
    p = np.pad(prev, search, mode="edge")
    h8, w8 = y.shape[0] // 8, y.shape[1] // 8
    for dy in range(-search, search + 1):
        for dx in range(-search, search + 1):
            ref = p[search + dy: search + dy + h8 * 8,
                    search + dx: search + dx + w8 * 8]
            cost = _satd8(cur - _to_blocks8(ref))
            np.minimum(best, cost, out=best)
    return best


class SceneChangeDetector:
    def __init__(self, bit_depth: int = 8,
                 min_kf_interval: int = 12,
                 max_kf_interval: int = 240,
                 mode: str = "fast"):
        assert mode in ("fast", "standard")
        self.bit_depth = bit_depth
        self.min_kf = min_kf_interval
        self.max_kf = max_kf_interval
        self.mode = mode
        self._prev_small: np.ndarray | None = None
        self._since_kf = 0
        self._recent: list[float] = []  # rolling deltas for spikes

    @staticmethod
    def _downscale(y: np.ndarray) -> np.ndarray:
        h, w = y.shape
        factor = 1
        while max(h, w) // (factor * 2) >= 128:
            factor *= 2
        if factor == 1:
            return y.astype(np.float32)
        hh, ww = h - h % factor, w - w % factor
        return (y[:hh, :ww].astype(np.float32)
                .reshape(hh // factor, factor, ww // factor, factor)
                .mean(axis=(1, 3)))

    def frame_delta(self, y: np.ndarray) -> float | None:
        """Mean abs diff vs previous frame on the downscaled luma
        (None for the first frame)."""
        small = self._downscale(np.asarray(y))
        prev = self._prev_small
        self._prev_small = small
        if prev is None or prev.shape != small.shape:
            return None
        return float(np.abs(small - prev).mean())

    def _cost_cut(self, small: np.ndarray,
                  prev: np.ndarray) -> tuple[bool, float]:
        """Standard-mode decision: temporal prediction failing to beat
        spatial prediction marks a cut (rav1e scenechange/standard.rs:
        estimate_inter_costs vs estimate_intra_costs ratio). The
        threshold adapts to the clip's recent ratio level — sharp
        content pans at a higher steady ratio than smooth content, so
        an absolute bar can't separate both; a jump vs the recent
        median can."""
        intra = estimate_intra_costs(small)
        inter = estimate_inter_costs(small, prev)
        # per-block: inter wins comfortably on continuous content
        ic = float(np.mean(np.minimum(inter, intra)))
        ia = float(np.mean(intra)) + 1e-6
        ratio = ic / ia
        if self._recent:
            base = float(np.median(self._recent))
            cut = ratio > max(1.25 * base, 0.4)
        else:
            # no history (first frame after a keyframe): only a
            # near-total temporal-prediction failure is a cut — noisy
            # content pans at ratios up to ~0.8
            cut = ratio > 0.9
        self._recent.append(ratio)
        if len(self._recent) > 8:
            self._recent.pop(0)
        return cut, ratio

    def analyze_next_frame(self, y: np.ndarray) -> bool:
        """True if this frame should start a new GOP (keyframe)."""
        small = self._downscale(np.asarray(y))
        prev = self._prev_small
        self._prev_small = small
        self._since_kf += 1
        if prev is None or prev.shape != small.shape:
            self._since_kf = 0
            return True  # first frame
        if self.mode == "standard":
            cut, delta = self._cost_cut(small, prev)
        else:
            delta = float(np.abs(small - prev).mean())
            scaled_thresh = FAST_THRESHOLD * (1 << (self.bit_depth - 8))
            cut = delta > scaled_thresh
            # relative spike: a delta far above the recent motion
            # level is a cut even when its absolute value is modest
            if not cut and len(self._recent) >= 3:
                base = float(np.median(self._recent))
                cut = delta > max(2.2 * base, 2.0)
            self._recent.append(delta)
            if len(self._recent) > 8:
                self._recent.pop(0)
        if self._since_kf >= self.max_kf or (
                cut and self._since_kf >= self.min_kf):
            self._since_kf = 0
            self._recent.clear()
            return True
        return False
