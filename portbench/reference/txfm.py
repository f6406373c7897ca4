"""The AV1 inverse transforms (specification section 7.13), in plain
numpy: the 1-D butterfly networks below are a frozen copy of the port's
plain reference (`ops/ref/transforms.py`, held there against libdav1d
and libaom), and `inverse_2d` applies them to every row, then every
column, of a block at once, with the specification's rounding and
clamps. Each 1-D transform takes a list of n numpy vectors (frequency
order) and returns n vectors (spatial order)."""

from __future__ import annotations

import math

import numpy as np

COSPI = [round(math.cos(j * math.pi / 128) * 4096) for j in range(65)]
SINPI = [0, 1321, 2482, 3344, 3803]  # iadst4 constants (spec sinpi)
SQRT2 = 5793  # round(sqrt(2) * 4096)
INV_SQRT2 = 2896  # round(4096 / sqrt(2))


def round2(x, n: int):
    """Spec Round2 for ints or numpy arrays (arithmetic shift)."""
    if n == 0:
        return x
    return (x + (1 << (n - 1))) >> n


def _hb(w0, a, w1, b):
    """half_btf: Round2(w0*a + w1*b, 12)."""
    return round2(w0 * a + w1 * b, 12)


C = COSPI


def idct4(x):
    s0, s1, s2, s3 = x[0], x[2], x[1], x[3]
    t0 = _hb(C[32], s0, C[32], s1)
    t1 = _hb(C[32], s0, -C[32], s1)
    t2 = _hb(C[48], s2, -C[16], s3)
    t3 = _hb(C[16], s2, C[48], s3)
    return [t0 + t3, t1 + t2, t1 - t2, t0 - t3]


def idct8(x):
    # stage 1 (bitrev) + stage 2 odd rotations
    e = [x[0], x[4], x[2], x[6]]
    o0, o1, o2, o3 = x[1], x[5], x[3], x[7]
    s4 = _hb(C[56], o0, -C[8], o3)
    s5 = _hb(C[24], o1, -C[40], o2)
    s6 = _hb(C[40], o1, C[24], o2)
    s7 = _hb(C[8], o0, C[56], o3)
    # stage 3: even idct4 core, odd add/sub
    t0 = _hb(C[32], e[0], C[32], e[1])
    t1 = _hb(C[32], e[0], -C[32], e[1])
    t2 = _hb(C[48], e[2], -C[16], e[3])
    t3 = _hb(C[16], e[2], C[48], e[3])
    u4, u5 = s4 + s5, s4 - s5
    u6, u7 = -s6 + s7, s6 + s7
    # stage 4
    v0, v1, v2, v3 = t0 + t3, t1 + t2, t1 - t2, t0 - t3
    v5 = _hb(-C[32], u5, C[32], u6)
    v6 = _hb(C[32], u5, C[32], u6)
    return [v0 + u7, v1 + v6, v2 + v5, v3 + u4,
            v3 - u4, v2 - v5, v1 - v6, v0 - u7]


def idct16(x):
    ev = idct8_mid = None  # readability only
    # odd half
    o = [x[1], x[9], x[5], x[13], x[3], x[11], x[7], x[15]]
    s = [0] * 8
    s[0] = _hb(C[60], o[0], -C[4], o[7])
    s[1] = _hb(C[28], o[1], -C[36], o[6])
    s[2] = _hb(C[44], o[2], -C[20], o[5])
    s[3] = _hb(C[12], o[3], -C[52], o[4])
    s[4] = _hb(C[52], o[3], C[12], o[4])
    s[5] = _hb(C[20], o[2], C[44], o[5])
    s[6] = _hb(C[36], o[1], C[28], o[6])
    s[7] = _hb(C[4], o[0], C[60], o[7])
    # stage 3 odd
    t = [s[0] + s[1], s[0] - s[1], -s[2] + s[3], s[2] + s[3],
         s[4] + s[5], s[4] - s[5], -s[6] + s[7], s[6] + s[7]]
    # stage 4 odd rotations
    u = list(t)
    u[1] = _hb(-C[16], t[1], C[48], t[6])
    u[6] = _hb(C[48], t[1], C[16], t[6])
    u[2] = _hb(-C[48], t[2], -C[16], t[5])
    u[5] = _hb(-C[16], t[2], C[48], t[5])
    # stage 5 odd
    v = [u[0] + u[3], u[1] + u[2], u[1] - u[2], u[0] - u[3],
         -u[4] + u[7], -u[5] + u[6], u[5] + u[6], u[4] + u[7]]
    # stage 6 odd rotations
    w = list(v)
    w[2] = _hb(-C[32], v[2], C[32], v[5])
    w[5] = _hb(C[32], v[2], C[32], v[5])
    w[3] = _hb(-C[32], v[3], C[32], v[4])
    w[4] = _hb(C[32], v[3], C[32], v[4])
    # even half = idct8 of even-indexed inputs
    e = idct8([x[0], x[2], x[4], x[6], x[8], x[10], x[12], x[14]])
    out = [0] * 16
    for i in range(8):
        out[i] = e[i] + w[7 - i]
        out[15 - i] = e[i] - w[7 - i]
    return out


def idct32(x):
    o = [x[1], x[17], x[9], x[25], x[5], x[21], x[13], x[29],
         x[3], x[19], x[11], x[27], x[7], x[23], x[15], x[31]]
    ang = [(62, 2), (30, 34), (46, 18), (14, 50),
           (54, 10), (22, 42), (38, 26), (6, 58)]
    s = [0] * 16
    for i, (a, b) in enumerate(ang):
        s[i] = _hb(C[a], o[i], -C[b], o[15 - i])
        s[15 - i] = _hb(C[b], o[i], C[a], o[15 - i])
    # stage 3: add/sub pairs
    t = [0] * 16
    for i in range(0, 16, 2):
        sgn = 1 if (i % 4) == 0 else -1
        if (i % 4) == 0:
            t[i] = s[i] + s[i + 1]
            t[i + 1] = s[i] - s[i + 1]
        else:
            t[i] = -s[i] + s[i + 1]
            t[i + 1] = s[i] + s[i + 1]
        del sgn
    # stage 4 rotations on odd-index pairs (1,14),(2,13),(5,10),(6,9)
    u = list(t)
    u[1] = _hb(-C[8], t[1], C[56], t[14])
    u[14] = _hb(C[56], t[1], C[8], t[14])
    u[2] = _hb(-C[56], t[2], -C[8], t[13])
    u[13] = _hb(-C[8], t[2], C[56], t[13])
    u[5] = _hb(-C[40], t[5], C[24], t[10])
    u[10] = _hb(C[24], t[5], C[40], t[10])
    u[6] = _hb(-C[24], t[6], -C[40], t[9])
    u[9] = _hb(-C[40], t[6], C[24], t[9])
    # stage 5 add/sub in groups of 4
    v = [0] * 16
    for g in range(0, 16, 4):
        if (g % 8) == 0:
            v[g] = u[g] + u[g + 3]
            v[g + 1] = u[g + 1] + u[g + 2]
            v[g + 2] = u[g + 1] - u[g + 2]
            v[g + 3] = u[g] - u[g + 3]
        else:
            v[g] = -u[g] + u[g + 3]
            v[g + 1] = -u[g + 1] + u[g + 2]
            v[g + 2] = u[g + 1] + u[g + 2]
            v[g + 3] = u[g] + u[g + 3]
    # stage 6 rotations (2,13),(3,12),(4,11),(5,10) with cospi16/48
    w = list(v)
    w[2] = _hb(-C[16], v[2], C[48], v[13])
    w[13] = _hb(C[48], v[2], C[16], v[13])
    w[3] = _hb(-C[16], v[3], C[48], v[12])
    w[12] = _hb(C[48], v[3], C[16], v[12])
    w[4] = _hb(-C[48], v[4], -C[16], v[11])
    w[11] = _hb(-C[16], v[4], C[48], v[11])
    w[5] = _hb(-C[48], v[5], -C[16], v[10])
    w[10] = _hb(-C[16], v[5], C[48], v[10])
    # stage 7 add/sub in groups of 8
    a = [0] * 16
    for i in range(4):
        a[i] = w[i] + w[7 - i]
        a[7 - i] = w[i] - w[7 - i]
        a[8 + i] = -w[8 + i] + w[15 - i]
        a[15 - i] = w[8 + i] + w[15 - i]
    # stage 8 rotations (4..7 with 8..11): cospi32
    b = list(a)
    for i in range(4, 8):
        j = 15 - (i - 4)  # 15,14,13,12 pair with 4,5,6,7? no: pairs (4,11),(5,10),(6,9),(7,8)
    b[4] = _hb(-C[32], a[4], C[32], a[11])
    b[11] = _hb(C[32], a[4], C[32], a[11])
    b[5] = _hb(-C[32], a[5], C[32], a[10])
    b[10] = _hb(C[32], a[5], C[32], a[10])
    b[6] = _hb(-C[32], a[6], C[32], a[9])
    b[9] = _hb(C[32], a[6], C[32], a[9])
    b[7] = _hb(-C[32], a[7], C[32], a[8])
    b[8] = _hb(C[32], a[7], C[32], a[8])
    e = idct16([x[i] for i in range(0, 32, 2)])
    out = [0] * 32
    for i in range(16):
        out[i] = e[i] + b[15 - i]
        out[31 - i] = e[i] - b[15 - i]
    return out


def idct64(x):
    """Spec inverse DCT64 (cos128 butterflies): even half = idct32,
    odd half = one more level of the idct32 ladder. Validated against
    the float cos basis (impulse responses) and the dav1d oracle."""
    # stage 1: interleaved bit-reversed odd inputs (idct32's odd order
    # interleaved with +32)
    o32 = [1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31]
    idx = []
    for k in o32:
        idx.extend((k, k + 32))
    o = [x[k] for k in idx]
    # stage 2: rotations, pairs (i, 31-i), angles (64-k, k) pi/128
    s = [0] * 32
    for i in range(16):
        k = idx[i]
        a, b = 64 - k, k
        s[i] = _hb(C[a], o[i], -C[b], o[31 - i])
        s[31 - i] = _hb(C[b], o[i], C[a], o[31 - i])
    # stage 3: add/sub pairs
    t = [0] * 32
    for i in range(0, 32, 2):
        if (i % 4) == 0:
            t[i] = s[i] + s[i + 1]
            t[i + 1] = s[i] - s[i + 1]
        else:
            t[i] = -s[i] + s[i + 1]
            t[i + 1] = s[i] + s[i + 1]
    # stage 4: rotations, bases (4, 36, 20, 52), full-span mirrors
    u = list(t)
    for g, base in enumerate((4, 36, 20, 52)):
        comp = 64 - base
        p1, q1 = 4 * g + 1, 30 - 4 * g
        p2, q2 = 4 * g + 2, 29 - 4 * g
        u[p1] = _hb(-C[base], t[p1], C[comp], t[q1])
        u[q1] = _hb(C[comp], t[p1], C[base], t[q1])
        u[p2] = _hb(-C[comp], t[p2], -C[base], t[q2])
        u[q2] = _hb(-C[base], t[p2], C[comp], t[q2])
    # stage 5: add/sub groups of 4
    v = [0] * 32
    for g in range(0, 32, 4):
        if (g % 8) == 0:
            v[g] = u[g] + u[g + 3]
            v[g + 1] = u[g + 1] + u[g + 2]
            v[g + 2] = u[g + 1] - u[g + 2]
            v[g + 3] = u[g] - u[g + 3]
        else:
            v[g] = -u[g] + u[g + 3]
            v[g + 1] = -u[g + 1] + u[g + 2]
            v[g + 2] = u[g + 1] + u[g + 2]
            v[g + 3] = u[g] + u[g + 3]
    # stage 6: rotations, bases (8, 40), indices {2,3}/{4,5} mod 8
    w = list(v)
    for g, base in enumerate((8, 40)):
        comp = 64 - base
        off = 8 * g
        for j in (2, 3):
            p_, q_ = off + j, (31 - off) - j
            w[p_] = _hb(-C[base], v[p_], C[comp], v[q_])
            w[q_] = _hb(C[comp], v[p_], C[base], v[q_])
        for j in (4, 5):
            p_, q_ = off + j, (31 - off) - j
            w[p_] = _hb(-C[comp], v[p_], -C[base], v[q_])
            w[q_] = _hb(-C[base], v[p_], C[comp], v[q_])
    # stage 7: add/sub groups of 8
    a8 = [0] * 32
    for g in range(0, 32, 8):
        if (g % 16) == 0:
            for i in range(4):
                a8[g + i] = w[g + i] + w[g + 7 - i]
                a8[g + 7 - i] = w[g + i] - w[g + 7 - i]
        else:
            for i in range(4):
                a8[g + i] = -w[g + i] + w[g + 7 - i]
                a8[g + 7 - i] = w[g + i] + w[g + 7 - i]
    # stage 8: rotations base 16, indices {4..7} (-16, 48) and
    # {8..11} (-48, -16), full-span mirrors
    b8 = list(a8)
    for j in range(4, 8):
        p_, q_ = j, 31 - j
        b8[p_] = _hb(-C[16], a8[p_], C[48], a8[q_])
        b8[q_] = _hb(C[48], a8[p_], C[16], a8[q_])
    for j in range(8, 12):
        p_, q_ = j, 31 - j
        b8[p_] = _hb(-C[48], a8[p_], -C[16], a8[q_])
        b8[q_] = _hb(-C[16], a8[p_], C[48], a8[q_])
    # stage 9: add/sub groups of 16
    c8 = [0] * 32
    for i in range(8):
        c8[i] = b8[i] + b8[15 - i]
        c8[15 - i] = b8[i] - b8[15 - i]
        c8[16 + i] = -b8[16 + i] + b8[31 - i]
        c8[31 - i] = b8[16 + i] + b8[31 - i]
    # stage 10: C32 rotations on the middle half (8..15 vs 23..16)
    d8 = list(c8)
    for i in range(8, 16):
        j = 31 - i
        d8[i] = _hb(-C[32], c8[i], C[32], c8[j])
        d8[j] = _hb(C[32], c8[i], C[32], c8[j])
    # even half + combine
    e = idct32([x[i] for i in range(0, 64, 2)])
    out = [0] * 64
    for i in range(32):
        out[i] = e[i] + d8[31 - i]
        out[63 - i] = e[i] - d8[31 - i]
    return out


def iadst4(x):
    """Spec inverse ADST4 (non-butterfly, sinpi network)."""
    s0 = SINPI[1] * x[0]
    s1 = SINPI[2] * x[0]
    s2 = SINPI[3] * x[1]
    s3 = SINPI[4] * x[2]
    s4 = SINPI[1] * x[2]
    s5 = SINPI[2] * x[3]
    s6 = SINPI[4] * x[3]
    a7 = x[0] - x[2]
    b7 = a7 + x[3]
    s0 = s0 + s3
    s1 = s1 - s4
    s3 = s2
    s2 = SINPI[3] * b7
    s0 = s0 + s5
    s1 = s1 - s6
    x0 = s0 + s3
    x1 = s1 + s3
    x2 = s2
    x3 = s0 + s1
    x3 = x3 - s3
    return [round2(x0, 12), round2(x1, 12), round2(x2, 12), round2(x3, 12)]


def iadst8(x):
    # stage 1: reorder
    s = [x[7], x[0], x[5], x[2], x[3], x[4], x[1], x[6]]
    # stage 2 rotations
    t = [0] * 8
    t[0] = _hb(C[4], s[0], C[60], s[1])
    t[1] = _hb(C[60], s[0], -C[4], s[1])
    t[2] = _hb(C[20], s[2], C[44], s[3])
    t[3] = _hb(C[44], s[2], -C[20], s[3])
    t[4] = _hb(C[36], s[4], C[28], s[5])
    t[5] = _hb(C[28], s[4], -C[36], s[5])
    t[6] = _hb(C[52], s[6], C[12], s[7])
    t[7] = _hb(C[12], s[6], -C[52], s[7])
    # stage 3
    u = [t[0] + t[4], t[1] + t[5], t[2] + t[6], t[3] + t[7],
         t[0] - t[4], t[1] - t[5], t[2] - t[6], t[3] - t[7]]
    # stage 4 rotations on 4..7
    v = list(u)
    v[4] = _hb(C[16], u[4], C[48], u[5])
    v[5] = _hb(C[48], u[4], -C[16], u[5])
    v[6] = _hb(-C[48], u[6], C[16], u[7])
    v[7] = _hb(C[16], u[6], C[48], u[7])
    # stage 5
    w = [v[0] + v[2], v[1] + v[3], v[0] - v[2], v[1] - v[3],
         v[4] + v[6], v[5] + v[7], v[4] - v[6], v[5] - v[7]]
    # stage 6 rotations on 2,3,6,7
    y = list(w)
    y[2] = _hb(C[32], w[2], C[32], w[3])
    y[3] = _hb(C[32], w[2], -C[32], w[3])
    y[6] = _hb(C[32], w[6], C[32], w[7])
    y[7] = _hb(C[32], w[6], -C[32], w[7])
    # stage 7: output with sign pattern
    return [y[0], -y[4], y[6], -y[2], y[3], -y[7], y[5], -y[1]]


def iadst16(x):
    s = [x[15], x[0], x[13], x[2], x[11], x[4], x[9], x[6],
         x[7], x[8], x[5], x[10], x[3], x[12], x[1], x[14]]
    ang = [(2, 62), (10, 54), (18, 46), (26, 38),
           (34, 30), (42, 22), (50, 14), (58, 6)]
    t = [0] * 16
    for i, (a, b) in enumerate(ang):
        t[2 * i] = _hb(C[a], s[2 * i], C[b], s[2 * i + 1])
        t[2 * i + 1] = _hb(C[b], s[2 * i], -C[a], s[2 * i + 1])
    u = [0] * 16
    for i in range(8):
        u[i] = t[i] + t[i + 8]
        u[i + 8] = t[i] - t[i + 8]
    v = list(u)
    v[8] = _hb(C[8], u[8], C[56], u[9])
    v[9] = _hb(C[56], u[8], -C[8], u[9])
    v[10] = _hb(C[40], u[10], C[24], u[11])
    v[11] = _hb(C[24], u[10], -C[40], u[11])
    v[12] = _hb(-C[56], u[12], C[8], u[13])
    v[13] = _hb(C[8], u[12], C[56], u[13])
    v[14] = _hb(-C[24], u[14], C[40], u[15])
    v[15] = _hb(C[40], u[14], C[24], u[15])
    w = [0] * 16
    for i in range(4):
        w[i] = v[i] + v[i + 4]
        w[i + 4] = v[i] - v[i + 4]
        w[i + 8] = v[i + 8] + v[i + 12]
        w[i + 12] = v[i + 8] - v[i + 12]
    y = list(w)
    for base in (4, 12):
        y[base] = _hb(C[16], w[base], C[48], w[base + 1])
        y[base + 1] = _hb(C[48], w[base], -C[16], w[base + 1])
        y[base + 2] = _hb(-C[48], w[base + 2], C[16], w[base + 3])
        y[base + 3] = _hb(C[16], w[base + 2], C[48], w[base + 3])
    z = [0] * 16
    for i in range(2):
        for g in range(0, 16, 4):
            z[g + i] = y[g + i] + y[g + i + 2]
            z[g + i + 2] = y[g + i] - y[g + i + 2]
    q = list(z)
    for i in (2, 6, 10, 14):
        q[i] = _hb(C[32], z[i], C[32], z[i + 1])
        q[i + 1] = _hb(C[32], z[i], -C[32], z[i + 1])
    return [q[0], -q[8], q[12], -q[4], q[6], -q[14], q[10], -q[2],
            q[3], -q[11], q[15], -q[7], q[5], -q[13], q[9], -q[1]]


def identity(x, n: int):
    if n == 4:
        return [round2(v * SQRT2, 12) for v in x]
    if n == 8:
        return [v * 2 for v in x]
    if n == 16:
        return [round2(v * 2 * SQRT2, 12) for v in x]
    if n == 32:
        return [v * 4 for v in x]
    raise ValueError(n)



_IDCT = {4: idct4, 8: idct8, 16: idct16, 32: idct32, 64: idct64}
_IADST = {4: iadst4, 8: iadst8, 16: iadst16}

# TxType (specification order) -> (vertical kind, horizontal kind)
TX_KINDS = [("DCT", "DCT"), ("ADST", "DCT"), ("DCT", "ADST"),
            ("ADST", "ADST"), ("FLIPADST", "DCT"), ("DCT", "FLIPADST"),
            ("FLIPADST", "FLIPADST"), ("ADST", "FLIPADST"),
            ("FLIPADST", "ADST"), ("IDTX", "IDTX"), ("DCT", "IDTX"),
            ("IDTX", "DCT"), ("ADST", "IDTX"), ("IDTX", "ADST"),
            ("FLIPADST", "IDTX"), ("IDTX", "FLIPADST")]


def _inv1d(kind: str, n: int, vecs: list) -> list:
    if kind == "DCT":
        return _IDCT[n](vecs)
    if kind == "ADST":
        return _IADST[n](vecs)
    if kind == "FLIPADST":
        return _IADST[n](vecs)[::-1]
    if kind == "IDTX":
        return identity(vecs, n)
    raise ValueError(kind)


def _row_shift(w: int, h: int) -> int:
    """Transform_Row_Shift of the specification, by size."""
    lw, lh = w.bit_length() - 1, h.bit_length() - 1
    if w == h:
        return {2: 0, 3: 1, 4: 2, 5: 2, 6: 2}[lw]
    if abs(lw - lh) == 1:
        return 0 if min(lw, lh) == 2 else 1
    return {2: 1, 3: 2, 4: 2}[min(lw, lh)]


def inverse_2d(coeffs: np.ndarray, tx_type: int, bd: int = 8) -> np.ndarray:
    """The inverse 2-D transform of an h x w block of dequantized
    coefficients: the residual to add to the prediction."""
    h, w = coeffs.shape
    vkind, hkind = TX_KINDS[tx_type]
    t = coeffs.astype(np.int64)
    if w == 2 * h or h == 2 * w:
        t = round2(t * INV_SQRT2, 12)
    hi = (1 << max(bd + 6, 16) - 1) - 1
    lo = -(1 << max(bd + 6, 16) - 1)
    # row transforms: entry j of every row at once
    rows = _inv1d(hkind, w, [t[:, j] for j in range(w)])
    r = np.stack([np.asarray(v, np.int64) for v in rows], axis=1)
    r = np.clip(round2(r, _row_shift(w, h)), lo, hi)
    cols = _inv1d(vkind, h, [r[i, :] for i in range(h)])
    out = np.stack([np.asarray(v, np.int64) for v in cols], axis=0)
    return round2(out, 4)
