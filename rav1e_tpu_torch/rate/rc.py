"""Rate control: Q57 log-domain model + two-pass.

Reference parity: rav1e src/rate.rs. Structure mirrored:
- Q57 fixed-point log-domain quantizer scale (`blog64`/`bexp64`
  analogs), per-subtype (KEY / INTER / B0 / B1) scale state with an
  exponential rate model  bits ~ scale * q^(-exp),
- bit reservoir (reservoir_frame_delay window) driving the per-frame
  bias,
- two-pass: pass 1 emits per-frame records + an end summary (magic /
  version / frame counts / scale sums, validated with the same error
  strings rav1e uses); pass 2 allocates the budget proportionally to
  the recorded per-frame scales.

Constant-quality mode (target_bitrate == 0) returns the configured
qindex untouched.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from rav1e_tpu_torch.ops.ref.quant import ac_q

# ---- Q57 helpers (rav1e src/rate.rs blog64/bexp64 analogs) ----------------
# Fixed-point log2 domain with 57 fractional bits, PURE INTEGER: the
# two-pass stats derived from these are deterministic, portable
# artifacts (no libm in the loop).  blog64
# extracts fraction bits by 57 mantissa squarings; bexp64 multiplies
# by a table of 2^(2^-i) constants built once with math.isqrt (exact).

Q57_ONE = 1 << 57


def _exp2_tab():
    from math import isqrt
    tab = []
    v = 2 << 62                      # 2.0 in Q62
    for _ in range(57):
        v = isqrt(v << 62)           # sqrt stays in Q62
        tab.append(v)
    return tab


_EXP2_TAB = _exp2_tab()


def blog64(w: int) -> int:
    """floor-ish log2(w) in Q57 (w > 0); integer-exact and monotone."""
    w = int(w)
    if w <= 0:
        return -(1 << 62)
    ipart = w.bit_length() - 1
    # mantissa in [2^62, 2^63)
    m = w >> (ipart - 62) if ipart > 62 else w << (62 - ipart)
    frac = 0
    for _ in range(57):
        m = (m * m) >> 62            # [2^62, 2^64)
        b = m >> 63
        frac = (frac << 1) | b
        m >>= b
    return (ipart << 57) | frac


def bexp64(x: int) -> int:
    """2^(x/2^57) as a nonnegative integer (clamped to [0, 2^62])."""
    x = int(x)
    ipart = x >> 57                  # floor (arithmetic shift)
    if ipart > 62:
        return 1 << 62
    if ipart < -62:
        return 0
    frac = x - (ipart << 57)
    y = 1 << 62
    for i in range(57):
        if (frac >> (56 - i)) & 1:
            y = (y * _EXP2_TAB[i]) >> 62
    sh = 62 - ipart
    return y >> sh if sh >= 0 else y << (-sh)


# frame subtypes (rav1e FRAME_SUBTYPE_*)
FS_I, FS_P, FS_B0, FS_B1 = 0, 1, 2, 3
_SUBTYPE = {"KEY": FS_I, "INTER": FS_P, "B0": FS_B0, "B1": FS_B1,
            "SHOW_EXISTING": FS_P}

# per-subtype rate-model exponent (Q6; rav1e tunes ~[0.85, 1.2])
_EXP_Q6 = [64, 64, 64, 64]
# per-subtype quantizer modulation: pyramid levels run at higher q,
# keyframes lower (rav1e MQP/DQP analog, applied in the log-q domain)
_LOG_Q_OFFSET = [int(-0.6 * Q57_ONE), 0,
                 int(0.25 * Q57_ONE), int(0.45 * Q57_ONE)]

TWOPASS_MAGIC = b"RTP1"
TWOPASS_VERSION = 1
_REC = struct.Struct("<BxxxqI")          # subtype, log_scale_q57, bits
_SUMMARY = struct.Struct("<4sI4I4qQ")    # magic, ver, counts, sums, bits


@dataclass
class RCConfig:
    target_bitrate: int = 0       # bits/sec; 0 => constant quality
    framerate: float = 30.0
    quantizer: int = 100          # CQ qindex when target_bitrate == 0
    reservoir_frame_delay: int = 25  # rav1e default lookahead-ish window


@dataclass
class _PassData:
    """Decoded pass-1 stream (pass 2 input)."""

    counts: list = field(default_factory=lambda: [0, 0, 0, 0])
    scale_sums: list = field(default_factory=lambda: [0, 0, 0, 0])
    total_bits: int = 0
    records: list = field(default_factory=list)   # (subtype, scale, bits)


class RCState:
    """Per-session rate control (rav1e src/rate.rs::RCState analog).

    pass_ = 0 single-pass, 1 = first pass (records stats),
    2 = second pass (needs twopass_in before encoding)."""

    def __init__(self, cfg: RCConfig, pass_: int = 0):
        self.cfg = cfg
        self.pass_ = pass_
        self.target_per_frame = (cfg.target_bitrate / cfg.framerate
                                 if cfg.target_bitrate else 0.0)
        self.reservoir = 0.0
        self.reservoir_cap = (self.target_per_frame
                              * cfg.reservoir_frame_delay)
        # per-subtype Q57 log-scale state (None until first observation)
        self._log_scale: list = [None, None, None, None]
        self._qi = cfg.quantizer
        # pass-1 output
        self._records: list = []
        self._pending_out = bytearray()
        # pass-2 input
        self._pass_in: _PassData | None = None
        self._pass_pos = 0
        self._remaining_scale = [0, 0, 0, 0]
        self._remaining_bits = 0.0

    # -- helpers ------------------------------------------------------------

    @staticmethod
    def _qi_for_scale(scale: float) -> int:
        """Smallest qindex whose ac quantizer >= scale."""
        lo, hi = 1, 255
        while lo < hi:
            mid = (lo + hi) // 2
            if ac_q(mid) < scale:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def _qi_from_target(self, st: int, target: float) -> int:
        """Invert the rate model: bits = 2^(log_scale - exp*log_q).
        Subtype q offsets apply only when borrowing another subtype's
        scale; the selected q is clamped to a bounded step from the
        previous frame (rav1e's per-frame delta limits analog)."""
        ls = self._log_scale[st]
        off = 0.0
        if ls is None:
            ls = self._log_scale[FS_P]
            if ls is None:
                return self._qi
            off = (_LOG_Q_OFFSET[st] - _LOG_Q_OFFSET[FS_P]) / Q57_ONE
        exp = _EXP_Q6[st] / 64.0
        log_q = (ls - blog64(max(int(target), 1))) / Q57_ONE / exp + off
        qi = self._qi_for_scale(2.0 ** log_q)
        return int(np.clip(qi, self._qi - 30, self._qi + 30))

    # -- single/first pass ---------------------------------------------------

    def select_qi(self, frame_type: str) -> int:
        st = _SUBTYPE.get(frame_type, FS_P)
        if not self.cfg.target_bitrate:
            # constant-quantizer mode still applies the per-subtype
            # modulation (rav1e QuantizerParameters: pyramid levels run
            # at higher q, keyframes LOWER — src/rate.rs select_qi).
            # The keyframe boost matters most: every inter frame in
            # the GOP references the KF recon, so its quality sets the
            # whole group's ceiling.
            if st == FS_P:
                return self.cfg.quantizer
            base = ac_q(self.cfg.quantizer)
            off = (_LOG_Q_OFFSET[st] - _LOG_Q_OFFSET[FS_P]) / Q57_ONE
            qi = self._qi_for_scale(base * 2.0 ** off)
            return int(np.clip(qi, 1, 255))
        if self.pass_ == 2 and self._pass_in is not None:
            return self._select_qi_pass2(st)
        fullness = (self.reservoir / self.reservoir_cap
                    if self.reservoir_cap else 0.0)
        target = max(self.target_per_frame * (1.0 + 0.5 * fullness), 1.0)
        qi = self._qi_from_target(st, target)
        return int(np.clip(qi, 1, 255))

    def update(self, frame_type: str, qi: int, bits: int):
        st = _SUBTYPE.get(frame_type, FS_P)
        exp = _EXP_Q6[st] / 64.0
        log_q = np.log2(float(ac_q(int(np.clip(qi, 1, 255)))))
        # observed scale in Q57: blog(bits) + exp*log_q (model inverse)
        scale = blog64(max(bits, 1)) + int(exp * log_q * Q57_ONE)
        if self.pass_ == 1:
            self._records.append((st, scale, bits))
            self._pending_out += _REC.pack(st, scale, bits)
        if not self.cfg.target_bitrate:
            return
        self.reservoir += self.target_per_frame - bits
        self.reservoir = float(np.clip(
            self.reservoir, -self.reservoir_cap, self.reservoir_cap))
        if self._log_scale[st] is None:
            self._log_scale[st] = scale
        else:
            w = 0.5
            self._log_scale[st] = int(w * self._log_scale[st]
                                      + (1 - w) * scale)
        if self.pass_ == 2 and self._pass_in is not None:
            rec = self._pass_in.records[
                min(self._pass_pos, len(self._pass_in.records) - 1)]
            self._remaining_scale[rec[0]] -= bexp64(rec[1] - (13 << 57))
            self._remaining_bits -= bits
            self._pass_pos += 1
        self._qi = qi

    # -- pass 2 --------------------------------------------------------------

    def _select_qi_pass2(self, st: int) -> int:
        pd = self._pass_in
        if self._pass_pos >= len(pd.records):
            return int(np.clip(self._qi, 1, 255))
        rst, rscale, rbits = pd.records[self._pass_pos]
        # allocate remaining budget proportionally to the recorded
        # frame complexity (its model scale vs all remaining scales);
        # scales are exponentiated relative to 2^13 so small frames
        # keep nonzero integer weight
        my = bexp64(rscale - (13 << 57))
        tot = max(sum(self._remaining_scale), 1)
        target = self._remaining_bits * my / tot
        # reservoir safety: same soft bias as single pass
        fullness = (self.reservoir / self.reservoir_cap
                    if self.reservoir_cap else 0.0)
        target = max(target * (1.0 + 0.25 * fullness), 1.0)
        qi = self._qi_from_target(rst, target)
        return int(np.clip(qi, 1, 255))

    # -- two-pass data plumbing (rav1e rav1e_twopass_out/in analogs) ---------

    def twopass_out(self) -> bytes:
        """Drain pending pass-1 records (call after each packet)."""
        out = bytes(self._pending_out)
        self._pending_out = bytearray()
        return out

    def twopass_summary(self) -> bytes:
        """End-of-pass summary (call after flush)."""
        counts = [0, 0, 0, 0]
        sums = [0, 0, 0, 0]
        total = 0
        for st, scale, bits in self._records:
            counts[st] += 1
            sums[st] += bexp64(scale - (13 << 57))
            total += bits
        return _SUMMARY.pack(TWOPASS_MAGIC, TWOPASS_VERSION, *counts,
                             *sums, total)

    def twopass_bytes_needed(self) -> int:
        """Pass-1 bytes still wanted before pass-2 can encode (rav1e
        rav1e_twopass_bytes_needed; our twopass_in takes the whole
        stream at once, so this is all-or-nothing)."""
        if self.pass_ == 2 and getattr(self, "_pass_in", None) is None:
            return _SUMMARY.size
        return 0

    def twopass_in(self, data: bytes):
        """Load the full pass-1 stream: records then summary."""
        if len(data) < _SUMMARY.size:
            raise ValueError("No TUs found in first pass summary")
        body, tail = data[:-_SUMMARY.size], data[-_SUMMARY.size:]
        parts = _SUMMARY.unpack(tail)
        if parts[0] != TWOPASS_MAGIC:
            raise ValueError("Magic value mismatch")
        if parts[1] != TWOPASS_VERSION:
            raise ValueError("Version number mismatch")
        counts = list(parts[2:6])
        sums = list(parts[6:10])
        total_bits = parts[10]
        if any(s < 0 for s in sums):
            raise ValueError("Got negative scale sum")
        pd = _PassData(counts=counts, scale_sums=sums,
                       total_bits=total_bits)
        n = len(body) // _REC.size
        if n == 0:
            raise ValueError("No TUs found in first pass summary")
        if n > sum(counts):
            raise ValueError("More TUs than frames")
        for i in range(n):
            st, scale, bits = _REC.unpack_from(body, i * _REC.size)
            pd.records.append((st, scale, bits))
        self._pass_in = pd
        self._pass_pos = 0
        self._remaining_scale = list(sums)
        # budget for the whole sequence at the configured bitrate
        self._remaining_bits = (self.target_per_frame
                                * len(pd.records))
        # seed the model from pass-1 averages
        for st in range(4):
            if counts[st]:
                avg = sums[st] // counts[st]
                self._log_scale[st] = blog64(max(avg, 1)) + (13 << 57)
