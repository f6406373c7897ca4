"""od_ec range coding of a tile's symbol IR on the card (CUDA kernels).

Port of rav1e_tpu/entropy/ec_pallas.py. The AV1 range coder is serial
per tile, but the context modeling (CDF lookups + adaptation) and the
interval arithmetic split cleanly: RecordingEncoder (a drop-in for
ECEncoder inside TileWriter) resolves every symbol to a tuple
    (fl, fh, cu, cv)
after which coding is a pure scalar recurrence over (low, rng).

Two facts make that recurrence parallel (csrc/ec_pack.cu has the
details):
- a row with fl < 2^15 reads only r8 = rng >> 8 in [128, 255], so a
  chunk of rows that starts at such a row maps each of 128 start states
  to an end state and a total shift, computable before the chunk knows
  where it starts;
- `low` is linear: the tile's bytes are the big-integer sum of every
  row's a_i = rng_i - u_i at bit position 14 + (shift before row i),
  plus the termination term, rounded and padded to a byte.
So the kernels cut each tile into chunks of about `chunk_rows` rows,
speculate every chunk from all 128 start states, resolve the chunks'
exact starts by composing those maps, code the chunks in parallel into
a byte accumulator and propagate the carries. The bytes equal
ECEncoder's, `pack_ir_plain` + `finish`'s and the Pallas kernel's.

`pack_ir` takes a CUDA tensor to the kernels and a CPU tensor to
`pack_ir_plain` + `finish` (the definition). `pack_ir_chunked_plain` is
a torch model of the kernels' six passes for the CPU tests; nothing on
the main path calls it. There is no fallback: a CUDA tensor launches the
kernels or raises. No PyTorch call computes this function.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from rav1e_tpu_torch import nvcc, trace
from rav1e_tpu_torch.device import resolve_device
from rav1e_tpu_torch.entropy.ec import (
    EC_MIN_PROB,
    EC_PROB_SHIFT,
    PROB_TOP,
    update_cdf,
)

SRC = nvcc.CSRC / "ec_pack.cu"

CHUNK_ROWS = 512      # default chunk length L (IR rows); a launch parameter
LANES = 128           # speculated start states r8 in [128, 255]
MIN_GROUP = 64        # chunks per block in the resolve pass, at least
CARRY_THREADS = 1024  # threads of the carry pass, one block per tile
CARRY_SEG = 8         # accumulator slots a carry thread owns per stage
CARRY_STAGE = CARRY_THREADS * CARRY_SEG
PASSES = ("boundaries", "speculate", "compose", "resolve", "code", "carry")
TERM = (1 << 14) - 1  # the termination's rounding term m


class RecordingEncoder:
    """ECEncoder-compatible front half: resolves symbols/bools/literals
    against (adapting) CDFs into the (fl, fh, cu, cv) IR. `done()` codes
    the IR on `device` (None: cuda, resolved there, so recording alone
    needs no card) and returns the tile bytes; `timings`, when given,
    receives the coding stages' wall times."""

    def __init__(self, device: torch.device | str | None = None,
                 timings: dict | None = None):
        self.ir: list[tuple[int, int, int, int]] = []
        self.device = device
        self.timings = timings

    def encode_symbol(self, symbol: int, icdf, adapt: bool = True):
        n = len(icdf) - 1
        N = n - 1
        fl = PROB_TOP if symbol == 0 else icdf[symbol - 1]
        fh = icdf[symbol]
        cu = EC_MIN_PROB * (N - (symbol - 1))
        cv = EC_MIN_PROB * (N - symbol)
        self.ir.append((int(fl), int(fh), int(cu) if fl < PROB_TOP
                        else 0, int(cv)))
        if adapt:
            update_cdf(icdf, symbol)

    def encode_bool(self, val: int, f: int):
        if val:
            self.ir.append((int(f), 0, EC_MIN_PROB, 0))
        else:
            self.ir.append((PROB_TOP, int(f), 0, EC_MIN_PROB))

    def encode_literal(self, value: int, nbits: int):
        for i in range(nbits - 1, -1, -1):
            self.encode_bool((value >> i) & 1, 1 << 14)

    def ir_tensor(self) -> torch.Tensor:
        """The recorded IR as int32 [n, 4] on the CPU."""
        return torch.from_numpy(
            np.asarray(self.ir, np.int32).reshape(-1, 4))

    def done(self) -> bytes:
        return pack_symbols(self.ir_tensor(), self.device, self.timings)


class IRRecorder(RecordingEncoder):
    """RecordingEncoder whose `done()` returns the tile's IR uncoded (int32
    [n, 4] on the CPU), for pack_tile_irs to code a frame's tiles in one
    launch."""

    def done(self) -> torch.Tensor:
        return self.ir_tensor()


# ---- the kernels: load, launch, fetch ---------------------------------------

def _bind(lib):
    # ir, offsets, nrows, ntiles, slots, L, G, nine buffers, stream, pass
    lib.ec_pack_launch.argtypes = (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 10 + [ctypes.c_int])
    lib.ec_pack_launch.restype = ctypes.c_int


def _lib():
    return nvcc.load(SRC, _bind)


def _check_ir(ir: torch.Tensor, offsets: torch.Tensor | None):
    if ir.dtype != torch.int32 or ir.dim() != 2 or ir.shape[1] != 4:
        raise ValueError(f"IR must be int32 [n, 4], got {ir.dtype} "
                         f"{tuple(ir.shape)}")
    if not ir.is_contiguous():
        raise ValueError("IR must be contiguous")
    if offsets is not None:
        if offsets.dtype != torch.int64 or offsets.dim() != 1 \
                or offsets.shape[0] < 1:
            raise ValueError("offsets must be int64 [T + 1]")
        if offsets.device != ir.device or not offsets.is_contiguous():
            raise ValueError("offsets must be contiguous, on the IR's "
                             "device")


def group_size(slots: int) -> int:
    """Chunks per block of the resolve pass: ceil(sqrt(slots)), at least
    MIN_GROUP, so each of its two serial walks is short."""
    return max(MIN_GROUP, math.isqrt(max(slots, 1) - 1) + 1)


def pack_ir(ir: torch.Tensor, offsets: torch.Tensor | None = None,
            chunk_rows: int = CHUNK_ROWS, events: list | None = None,
            work: dict | None = None):
    """Range-code T tiles of IR. ir: int32 [N, 4], the tiles' IR
    concatenated; offsets: int64 [T + 1] row offsets (None: one tile).

    Returns (out uint8 [2N + 8T], lens int32 [T]) on ir's device: tile
    t's finished bytes are out[2*offsets[t] + 8*t:][:lens[t]], and
    lens[t] = -1 marks a leading carry (no valid stream). A CUDA tensor
    runs the kernels on the current stream, cut into chunks of about
    `chunk_rows` rows (one call counts one in pack_ir.launches); `events`,
    len(PASSES) + 1 CUDA events, are recorded around each pass; `work`
    receives the passes' buffers by name (sinfo: per chunk slot (tile,
    k, start row or -1, end row)). A CPU tensor runs pack_ir_plain +
    finish per tile (chunk_rows, events and work do not apply)."""
    _check_ir(ir, offsets)
    n = ir.shape[0]
    T = 1 if offsets is None else offsets.shape[0] - 1
    if ir.device.type == "cpu":
        if offsets is None:
            offsets = torch.tensor([0, n], dtype=torch.int64)
        out = torch.zeros(2 * n + 8 * T, dtype=torch.uint8)
        lens = torch.zeros(T, dtype=torch.int32)
        offs = offsets.tolist()
        for t in range(T):
            c, st = pack_ir_plain(ir[offs[t]:offs[t + 1]])
            try:
                b = finish(c.tolist(), *st[:3].tolist())
            except ValueError:
                lens[t] = -1
                continue
            base = 2 * offs[t] + 8 * t
            out[base: base + len(b)] = torch.frombuffer(bytearray(b),
                                                        dtype=torch.uint8)
            lens[t] = len(b)
        return out, lens
    if ir.device.type != "cuda":
        raise ValueError(f"pack_ir runs on cuda or cpu, not {ir.device}")
    if ir.data_ptr() % 16:
        raise ValueError("IR must be 16-byte aligned")
    if chunk_rows < 1:
        raise ValueError("chunk_rows must be at least 1")
    if events is not None and len(events) != len(PASSES) + 1:
        raise ValueError(f"events: {len(PASSES) + 1} CUDA events expected")
    lib = _lib()
    slots = n // chunk_rows + T
    G = group_size(slots)
    ngroups = -(-slots // G)
    dev = ir.device
    with torch.cuda.device(dev):
        i32 = dict(dtype=torch.int32, device=dev)
        sinfo = torch.empty((slots, 4), **i32)
        maps = torch.empty((slots, LANES, 2), **i32)
        gmaps = torch.empty((ngroups, LANES, 2), **i32)
        gflags = torch.empty(ngroups, **i32)
        cstart = torch.empty((slots, 2), **i32)
        acc = torch.empty(2 * n + 8 * T, **i32)
        nbits = torch.empty(T, **i32)
        out = torch.empty(2 * n + 8 * T, dtype=torch.uint8, device=dev)
        lens = torch.empty(T, **i32)
        bufs = dict(sinfo=sinfo, maps=maps, gmaps=gmaps, gflags=gflags,
                    cstart=cstart, acc=acc, nbits=nbits, out=out, lens=lens)
        if work is not None:
            work.update(bufs)
        stream = torch.cuda.current_stream()
        ptrs = [ctypes.c_void_p(x.data_ptr()) for x in bufs.values()]
        # offsets None: a null pointer, read by the kernels as [0, n]
        head = (ctypes.c_void_p(ir.data_ptr()),
                ctypes.c_void_p(None if offsets is None
                                else offsets.data_ptr()),
                n, T, slots, chunk_rows, G)
        passes = range(len(PASSES)) if events is not None else [-1]
        if events is not None:
            events[0].record(stream)
        for p in passes:
            err = lib.ec_pack_launch(*head, *ptrs,
                                     ctypes.c_void_p(stream.cuda_stream), p)
            if err != 0:
                raise RuntimeError(f"ec_pack kernel launch failed (pass "
                                   f"{'all' if p < 0 else PASSES[p]}): "
                                   f"CUDA error {err}")
            if events is not None:
                events[p + 1].record(stream)
    nvcc.count_launch(pack_ir)
    return out, lens


pack_ir.launches = 0


def fetch_tiles(out: torch.Tensor, lens: torch.Tensor,
                offsets: list[int]) -> list[bytes]:
    """Each tile's finished bytes from pack_ir's outputs, copying only
    those bytes to the host. Raises ValueError on a leading carry, as
    `finish` does."""
    tiles = []
    for t, k in enumerate(lens.tolist()):
        if k < 0:
            raise ValueError(f"tile {t}: leading carry out of the od_ec "
                             "stream")
        base = 2 * offsets[t] + 8 * t
        tiles.append(out[base: base + k].cpu().numpy().tobytes())
    return tiles


def pack_symbols(ir: torch.Tensor, device: torch.device | str | None,
                 timings: dict | None = None) -> bytes:
    """One tile's IR -> its final bytes (pack_tile_irs of one tile)."""
    return pack_tile_irs([ir], device, timings)[0]


def pack_tile_irs(irs: list[torch.Tensor],
                  device: torch.device | str | None,
                  timings: dict | None = None) -> list[bytes]:
    """A frame's T tiles' IRs (each int32 [n_t, 4] on the host) -> each
    tile's final bytes, coded in ONE pack_ir call: each IR uploaded
    (asynchronously from a pinned buffer) into its rows of one device
    buffer, with the tiles' row offsets; coded on `device` (the kernels
    on cuda, on the current stream); then the lengths and the finished
    bytes fetched. `timings` receives ec_kernel (upload, coding and the
    lengths' fetch; work count: the tiles), ir_upload (the upload alone,
    a stage inside ec_kernel) and finish (trace.stages)."""
    dev = resolve_device(device)
    st = trace.stages(dev, timings)
    with st.span("ec_kernel", len(irs)):
        offs = [0]
        for x in irs:
            offs.append(offs[-1] + x.shape[0])
        offsets = None
        if len(irs) == 1:
            ir_d = irs[0].to(dev, non_blocking=True)
        else:
            ir_d = torch.empty((offs[-1], 4), dtype=torch.int32, device=dev)
            for t, x in enumerate(irs):
                ir_d[offs[t]:offs[t + 1]].copy_(x, non_blocking=True)
            offsets = torch.tensor(offs, dtype=torch.int64).to(dev)
        st.mark("ir_upload")
        out, lens = pack_ir(ir_d, offsets)
        lens = lens.cpu()
    tiles = fetch_tiles(out, lens, offs)
    st.mark("finish")
    return tiles


# ---- the definition: the recurrence, serial ---------------------------------

def pack_ir_plain(ir: torch.Tensor):
    """The recurrence as a Python loop over one tile's IR [n, 4], with
    the Pallas kernel's early flush (so the same chunks). Returns (chunks
    int32 [k], state int32 [4] = (low, nbits, flushed, k))."""
    low, rng, nbits, flushed = 0, PROB_TOP, 15, 0
    out: list[int] = []
    sh = 7 - EC_PROB_SHIFT
    for fl, fh, cu, cv in ir.tolist():
        r8 = rng >> 8
        u = ((r8 * (fl >> EC_PROB_SHIFT)) >> sh) + cu if fl < PROB_TOP \
            else rng
        v = ((r8 * (fh >> EC_PROB_SHIFT)) >> sh) + cv
        low += rng - u
        rng = u - v
        d = 16 - rng.bit_length()
        for _ in range(2):
            window = nbits - flushed
            if window + d >= 24:
                keep = window - 8
                out.append(low >> keep)
                low &= (1 << keep) - 1
                flushed += 8
        low <<= d
        rng <<= d
        nbits += d
    return (torch.tensor(out, dtype=torch.int32),
            torch.tensor([low, nbits, flushed, len(out)], dtype=torch.int32))


def finish(chunks, low: int, nbits: int, flushed: int) -> bytes:
    """Host termination: round low up inside the final interval, flush
    the tail, propagate carries backward (ECEncoder.done twin)."""
    m = TERM
    e = ((low + m) & ~m) | (m + 1)
    window = nbits - flushed
    out_chunks = [int(c) for c in chunks]
    while window > 0:
        take = window - 8 if window >= 8 else 0
        out_chunks.append(e >> take)
        e &= (1 << take) - 1
        window = take
    out = bytearray(len(out_chunks))
    carry = 0
    for i in range(len(out_chunks) - 1, -1, -1):
        s = out_chunks[i] + carry
        out[i] = s & 0xFF
        carry = s >> 8
    if carry:
        raise ValueError("leading carry out of the od_ec stream")
    rem = nbits % 8
    if rem:
        out[-1] = (out[-1] << (8 - rem)) & 0xFF
    return bytes(out)


# ---- a torch model of the kernels' six passes ------------------------------

_POW2 = 2 ** torch.arange(1, 16, dtype=torch.int64)


def chunk_starts(ir: torch.Tensor, chunk_rows: int) -> torch.Tensor:
    """The kernels' chunk boundaries of one tile's IR [n, 4]: int64
    [max(1, ceil(n / L))], slot k's start row, or -1 for an empty slot.
    Slot k starts at the first row in [kL, (k+1)L) with fl < 2^15 (slot
    0 at row 0). A chunk runs to the next chunk's start, i.e. to the
    first row at or after (k+1)L with fl < 2^15, or the tile's end."""
    L = chunk_rows
    n = ir.shape[0]
    K = max(1, -(-n // L))
    cand = torch.where(ir[:, 0] < PROB_TOP, torch.arange(n), n)
    cand = torch.cat([cand, torch.full((K * L - n,), n)]).view(K, L)
    start = cand.amin(1)
    start[0] = 0
    start[1:][start[1:] >= n] = -1
    return start


def _step(rng, fl, fh, cu, cv):
    """One row of the recurrence, elementwise: (a = rng - u, the
    renormalised rng, the shift d)."""
    r8 = rng >> 8
    u = torch.where(fl < PROB_TOP, ((r8 * (fl >> EC_PROB_SHIFT)) >> 1) + cu,
                    rng)
    v = ((r8 * (fh >> EC_PROB_SHIFT)) >> 1) + cv
    r = u - v
    d = (r.unsqueeze(-1) < _POW2).sum(-1)     # 16 - bit_length(r)
    return rng - u, r << d, d


def pack_ir_chunked_plain(ir: torch.Tensor, chunk_rows: int = CHUNK_ROWS,
                          stats: dict | None = None) -> bytes:
    """One tile's IR [n, 4] -> its bytes, by the kernels' six passes
    (csrc/ec_pack.cu), vectorised over chunks x 128 lanes. Raises
    ValueError on a leading carry. `stats`, when given, receives the
    chunk count, `joins_carried`: the chunk joins across which a carry
    ran out of the two chunks' overlap into the earlier chunk's bytes,
    and `segments_carried_through`: the carry pass's segments of all
    0xFF bytes that a carry ran through."""
    x = ir.to(torch.int64)
    n = x.shape[0]

    # 0. boundaries
    start = chunk_starts(ir, chunk_rows)
    K = start.shape[0]
    valid = start >= 0
    vs = valid.nonzero().flatten()
    st = start[vs]
    ln = torch.cat([st[1:], torch.tensor([n])]) - st

    # 1. speculate: every chunk from rng = r8 << 8 for all 128 r8
    nc = vs.shape[0]
    rng = ((torch.arange(LANES) + 128) << 8).repeat(nc, 1)
    S = torch.zeros((nc, LANES), dtype=torch.int64)
    for s in range(int(ln.max()) if nc else 0):
        act = (s < ln)[:, None]
        row = x[(st + s).clamp(max=max(n - 1, 0))]
        _, r2, d = _step(rng, *(row[:, i:i + 1] for i in range(4)))
        rng = torch.where(act, r2, rng)
        S = torch.where(act, S + d, S)
    mrng = torch.zeros((K, LANES), dtype=torch.int64)
    mS = torch.zeros((K, LANES), dtype=torch.int64)
    mrng[vs], mS[vs] = rng, S

    # 2. compose: each group of G slots into one map (empty slots are
    # the identity; slot 0 restarts from (2^15, 0), so a group that holds
    # it maps every start to the same state)
    G = group_size(K)
    ng = -(-K // G)
    grng = ((torch.arange(LANES) + 128) << 8).repeat(ng, 1)
    gS = torch.zeros((ng, LANES), dtype=torch.int64)
    slot_ok = torch.cat([valid, torch.zeros(ng * G - K, dtype=torch.bool)])
    for j in range(G):
        slot = torch.arange(ng) * G + j
        ok = slot_ok[slot][:, None]
        sl = slot.clamp(max=K - 1)
        reset = (slot == 0)[:, None]
        r_in = torch.where(reset, PROB_TOP, grng)
        s_in = torch.where(reset, 0, gS)
        idx = (r_in >> 8) - 128
        grng = torch.where(ok, mrng[sl].gather(1, idx), grng)
        gS = torch.where(ok, s_in + mS[sl].gather(1, idx), gS)
    gvalid = slot_ok.view(ng, G).any(1)

    # 3. resolve: each group's start state from the group maps before it,
    # then each chunk's exact start (rng, bit offset B) within the group
    state = (PROB_TOP, 0)
    gstart = []
    for g in range(ng):
        gstart.append(state)
        if gvalid[g]:
            i = (state[0] >> 8) - 128
            base = 0 if g == 0 else state[1]    # group 0 holds the reset
            state = (int(grng[g, i]), base + int(gS[g, i]))
    cst = torch.zeros((K, 2), dtype=torch.int64)
    for g in range(ng):
        r_, b_ = gstart[g]
        for slot in range(g * G, min(K, (g + 1) * G)):
            if not valid[slot]:
                continue
            if slot == 0:
                r_, b_ = PROB_TOP, 0
            cst[slot] = torch.tensor([r_, b_])
            i = (r_ >> 8) - 128
            r_, b_ = int(mrng[slot, i]), b_ + int(mS[slot, i])
    tile_nbits = 15 + b_                  # b_: the last chunk's end

    # 4. code: each chunk from its exact start; flushed bytes and the
    # final window are added into acc (slot = byte index + 1; slot 0
    # takes a leading carry); the last chunk adds the termination term
    nb = ((tile_nbits + 7) >> 3) + 1
    acc = torch.zeros(nb, dtype=torch.int64)
    rng = cst[vs, 0].clone()
    B = cst[vs, 1]
    nbits = 15 + B
    flushed = torch.div(B - 1, 8, rounding_mode="floor") * 8
    low = torch.zeros(nc, dtype=torch.int64)
    for s in range(int(ln.max()) if nc else 0):
        act = s < ln
        row = x[(st + s).clamp(max=max(n - 1, 0))]
        a, r2, d = _step(rng, *row.unbind(1))
        low = torch.where(act, low + a, low)
        for _ in range(2):
            window = nbits - flushed
            fl_ = act & (window + d >= 24)
            keep = window - 8
            acc.index_add_(0, ((flushed >> 3) + 1)[fl_], (low >> keep)[fl_])
            low = torch.where(fl_, low & ((1 << keep) - 1), low)
            flushed = flushed + 8 * fl_
        low = torch.where(act, low << d, low)
        rng = torch.where(act, r2, rng)
        nbits = torch.where(act, nbits + d, nbits)
    if nc:
        low[-1] += TERM
        pad = (-nbits) % 8
        val = low << pad
        nbw = (nbits + pad - flushed) >> 3
        for j in range(int(nbw.max())):
            ok = j < nbw
            sh = 8 * (nbw - 1 - j)
            byte = val >> sh if j == 0 else (val >> sh) & 255
            acc.index_add_(0, ((flushed >> 3) + 1 + j)[ok], byte[ok])
    if stats is not None:
        stats["chunks"] = nc
        stats["joins_carried"] = _joins_carried(acc, B[1:])

    # 5. carries: stages of CARRY_THREADS segments of CARRY_SEG slots,
    # right-aligned, from the tile's end to its start
    v = acc.clone()
    through = 0
    stage_carry = 0
    for hi in range(nb, 0, -CARRY_STAGE):
        lo = max(0, hi - CARRY_STAGE)
        idx = torch.arange(hi - CARRY_STAGE, hi).view(CARRY_THREADS,
                                                      CARRY_SEG)
        real = idx >= lo
        x = torch.where(real, v[idx.clamp(min=0)], 0)

        def ripple(x, c):
            for j in range(CARRY_SEG - 1, -1, -1):
                s_ = x[:, j] + c
                x[:, j] = torch.where(real[:, j], s_ & 255, x[:, j])
                c = torch.where(real[:, j], s_ >> 8, c)
            return c

        cout = ripple(x, torch.zeros(CARRY_THREADS, dtype=torch.int64))
        g = ripple(x, torch.cat([cout[1:], torch.tensor([stage_carry])]))
        p = ((x == 255) | ~real).all(1)
        extra = torch.zeros(CARRY_THREADS + 1, dtype=torch.int64)
        for s in range(CARRY_THREADS - 1, -1, -1):
            extra[s] = g[s] | (p[s] & extra[s + 1])
        through += int((p & (extra[1:] > 0)).sum())
        ripple(x, extra[1:])
        first = int(real.any(1).nonzero()[0])
        stage_carry = int(cout[first] + extra[first])
        v[lo:hi] = x[real]
    if stage_carry or int(v[0]):
        raise ValueError("leading carry out of the od_ec stream")
    if stats is not None:
        stats["segments_carried_through"] = through
    # termination: clear the lowest 14 bits, set the 15th
    for q in range(tile_nbits - 15, tile_nbits):
        i, bit = (q >> 3) + 1, 7 - (q & 7)
        on = q == tile_nbits - 15
        v[i] = (v[i] | (1 << bit)) if on else (v[i] & ~(1 << bit))
    return bytes(v[1:].to(torch.uint8).tolist())


def _joins_carried(acc: torch.Tensor, b_joins: torch.Tensor) -> int:
    """Joins (a later chunk's start at bit offset B) where the serial
    carry out of the byte holding the later chunk's top bit, B - 1, is
    not zero."""
    vals = acc.tolist()
    into = [0] * len(vals)       # into[j]: carry from slot j into j - 1
    c = 0
    for j in range(len(vals) - 1, -1, -1):
        c = (vals[j] + c) >> 8
        into[j] = c
    return sum(1 for b in b_joins.tolist() if into[((b - 1) >> 3) + 1])
