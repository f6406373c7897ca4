"""od_ec range coding of a tile's symbol IR on the card (CUDA kernel).

Port of rav1e_tpu/entropy/ec_pallas.py. The AV1 range coder is serial
per tile, but the context modeling (CDF lookups + adaptation) and the
interval arithmetic split cleanly: RecordingEncoder (a drop-in for
ECEncoder inside TileWriter) resolves every symbol to a tuple
    (fl, fh, cu, cv)
after which coding is a pure scalar recurrence over (low, rng). That
recurrence runs in the hand-written kernel csrc/ec_pack.cu (one thread
per tile, many tiles per launch); `finish` applies the host termination
and backward carry propagation. The chunk stream, and so the bytes,
equal ECEncoder's.

`pack_ir` takes a CUDA tensor to the kernel and a CPU tensor to
`pack_ir_plain`, the same recurrence as a Python loop. There is no
fallback: a CUDA tensor launches the kernel or raises. No PyTorch call
computes this function.
"""

from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from rav1e_tpu_torch import nvcc
from rav1e_tpu_torch.device import resolve_device
from rav1e_tpu_torch.entropy.ec import (
    EC_MIN_PROB,
    EC_PROB_SHIFT,
    PROB_TOP,
    update_cdf,
)

SRC = nvcc.CSRC / "ec_pack.cu"


class RecordingEncoder:
    """ECEncoder-compatible front half: resolves symbols/bools/literals
    against (adapting) CDFs into the (fl, fh, cu, cv) IR. `done()` codes
    the IR on `device` (pack_symbols) and returns the tile bytes;
    `timings`, when given, receives the coding stages' wall times."""

    def __init__(self, device: torch.device | str = "cpu",
                 timings: dict | None = None):
        self.ir: list[tuple[int, int, int, int]] = []
        self.device = torch.device(device)
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


# ---- the kernel: load, launch -----------------------------------------------

def _bind(lib):
    lib.ec_pack_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_void_p]
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


def pack_ir(ir: torch.Tensor, offsets: torch.Tensor | None = None):
    """Range-code T tiles of IR. ir: int32 [N, 4], the tiles' IR
    concatenated; offsets: int64 [T + 1] row offsets (None: one tile).

    Returns (chunks int32 [2N + 64T], state int32 [T, 4]): tile t's
    chunks start at 2*offsets[t] + 64*t, and its state row is
    (low, nbits, flushed, k) with k its chunk count. A CUDA tensor runs
    the kernel on the current stream (counted in pack_ir.launches); a
    CPU tensor runs pack_ir_plain per tile."""
    _check_ir(ir, offsets)
    n = ir.shape[0]
    if offsets is None:
        offsets = torch.tensor([0, n], dtype=torch.int64, device=ir.device)
    T = offsets.shape[0] - 1
    if ir.device.type == "cpu":
        chunks = torch.zeros(2 * n + 64 * T, dtype=torch.int32)
        state = torch.zeros((T, 4), dtype=torch.int32)
        offs = offsets.tolist()
        for t in range(T):
            c, st = pack_ir_plain(ir[offs[t]:offs[t + 1]])
            base = 2 * offs[t] + 64 * t
            chunks[base: base + c.shape[0]] = c
            state[t] = st
        return chunks, state
    if ir.device.type != "cuda":
        raise ValueError(f"pack_ir runs on cuda or cpu, not {ir.device}")
    if ir.data_ptr() % 16:
        raise ValueError("IR must be 16-byte aligned")
    lib = _lib()
    with torch.cuda.device(ir.device):
        chunks = torch.empty(2 * n + 64 * T, dtype=torch.int32,
                             device=ir.device)
        state = torch.empty((T, 4), dtype=torch.int32, device=ir.device)
        err = lib.ec_pack_launch(
            ctypes.c_void_p(ir.data_ptr()),
            ctypes.c_void_p(offsets.data_ptr()), T,
            ctypes.c_void_p(chunks.data_ptr()),
            ctypes.c_void_p(state.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"ec_pack kernel launch failed: CUDA error {err}")
    pack_ir.launches += 1
    return chunks, state


pack_ir.launches = 0


def pack_ir_plain(ir: torch.Tensor):
    """The kernel's recurrence as a Python loop over one tile's IR
    [n, 4] (same early flush, so the same chunks). Returns (chunks int32
    [k], state int32 [4] = (low, nbits, flushed, k))."""
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
    m = (1 << 14) - 1
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


def tile_bytes(chunks: torch.Tensor, state: torch.Tensor, t: int,
               offsets: list[int]) -> bytes:
    """Finished bytes of tile t from pack_ir's host-side outputs."""
    low, nbits, flushed, k = (int(x) for x in state[t])
    base = 2 * offsets[t] + 64 * t
    return finish(chunks[base: base + k].tolist(), low, nbits, flushed)


def pack_symbols(ir: torch.Tensor, device: torch.device | str,
                 timings: dict | None = None) -> bytes:
    """One tile's IR -> its final bytes: upload, code on `device`
    (the kernel on cuda), fetch, finish on the host."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    ir_d = ir.to(dev)
    chunks, state = pack_ir(ir_d)
    chunks, state = chunks.cpu(), state.cpu()
    t1 = time.perf_counter()
    out = tile_bytes(chunks, state, 0, [0, ir.shape[0]])
    if timings is not None:
        timings["ec_kernel"] = t1 - t0
        timings["finish"] = time.perf_counter() - t1
    return out
