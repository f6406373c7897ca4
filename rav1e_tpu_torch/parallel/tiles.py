"""Tile/GOP-sharded work over a grid of torch devices (the port of
rav1e_tpu/parallel/tiles.py).

The reference shards over a jax Mesh with axes ('gop', 'tile'): frames
across the gop axis, tile columns across the tile axis, with shard_map
bodies whose ppermute and psum are the only cross-shard traffic. Here a
device grid, a (gop, tile) numpy array of torch devices, takes the
Mesh's place, and a `ShardGroup` takes shard_map's: it runs one body per
shard on a thread of its own, on the shard's device and, on a CUDA
device, on a stream of its own, and gives each body the collectives the
reference's bodies use (`shift_right` / `shift_left` for the halo
ppermutes, `psum`). Two shards may share one card (["cuda:0",
"cuda:0"]): their bodies then overlap on two streams of it.

A collective is a barrier: every shard's body calls it in the same order.
A shard puts its tensor after its stream has finished it; the receiver
copies it onto its own device and stream and finishes that copy before
the group moves on, so no tensor is read on one stream while another
frees it. A psum adds the shards' tensors in shard order on each shard,
so every shard holds the same f32 total.

`sharded_encode_step` is the reference's transform half of the intra
encoder (a DC-from-128 prediction, the 32x32 DCT, quantize, dequantize,
the exact inverse and the recon) with its rate-control statistics summed
over the grid; `dryrun(n)` runs it on tiny shapes.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from rav1e_tpu_torch.core.constants import TxSize, TxType
from rav1e_tpu_torch.device import resolve_device
from rav1e_tpu_torch.ops import transforms as T

LB = 32


def make_grid(devices=None, gop: int = 2, tile: int | None = None):
    """A (gop, tile) numpy object array of torch devices (the reference's
    make_mesh). devices: default every visible CUDA device."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    n = len(devs)
    if tile is None:
        tile = n // gop
    if gop * tile != n:
        raise ValueError(f"a {gop} x {tile} grid needs {gop * tile} devices, "
                         f"got {n}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return arr.reshape(gop, tile)


def _finish(dev: torch.device):
    """Wait for the work queued on dev's current stream (a no-op on the
    CPU)."""
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


class Shard:
    """One shard's view of its group: its index, device and the
    collectives. Made by ShardGroup.run."""

    def __init__(self, group: "ShardGroup", index: int):
        self.group = group
        self.index = index
        self.T = group.T
        self.device = group.devices[index]

    def _exchange(self, x: torch.Tensor) -> list:
        g = self.group
        _finish(self.device)
        g._box[self.index] = x
        g._barrier.wait()
        return list(g._box)

    def _done(self, y: torch.Tensor) -> torch.Tensor:
        _finish(self.device)
        self.group._barrier.wait()   # nobody refills the box under readers
        return y

    def shift_right(self, x: torch.Tensor) -> torch.Tensor:
        """The left neighbour's x on this shard (zeros on shard 0): the
        reference's ppermute with perm [(i, i + 1)]."""
        box = self._exchange(x)
        y = (torch.zeros_like(x) if self.index == 0
             else box[self.index - 1].to(self.device, copy=True))
        return self._done(y)

    def shift_left(self, x: torch.Tensor) -> torch.Tensor:
        """The right neighbour's x on this shard (zeros on the last):
        ppermute with perm [(i + 1, i)]."""
        box = self._exchange(x)
        y = (torch.zeros_like(x) if self.index == self.T - 1
             else box[self.index + 1].to(self.device, copy=True))
        return self._done(y)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Every shard's x added in shard order, on this shard."""
        box = self._exchange(x)
        acc = box[0].to(self.device, copy=True)
        for t in range(1, self.T):
            acc = acc + box[t].to(self.device)
        return self._done(acc)


class ShardGroup:
    """T shards, one a device of `devices` (repeats allowed): run(fn)
    calls fn(shard) for every shard on a thread of its own, under its
    device and a stream of its own, and returns the results in shard
    order. A body that raises aborts the barrier, so its peers stop at
    their next collective, and the first error is raised."""

    def __init__(self, devices):
        self.devices = [resolve_device(d) for d in devices]
        self.T = len(self.devices)
        self._box: list = [None] * self.T
        self._barrier = threading.Barrier(self.T)

    def run(self, fn):
        outs = [None] * self.T
        errs = [None] * self.T

        def work(t):
            dev = self.devices[t]
            try:
                if dev.type == "cuda":
                    with torch.cuda.device(dev), \
                            torch.cuda.stream(torch.cuda.Stream(dev)):
                        outs[t] = fn(Shard(self, t))
                        _finish(dev)
                else:
                    outs[t] = fn(Shard(self, t))
            except BaseException as e:      # raised below, in shard order
                errs[t] = e
                self._barrier.abort()

        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(self.T)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        self._barrier.reset()
        errs.sort(key=lambda e: isinstance(e, threading.BrokenBarrierError))
        for e in errs:
            if e is not None:
                raise e
        return outs


def _tile_encode_step(frames: torch.Tensor, qdc: int, qac: int):
    """Per-shard body: frames [f_local, H, W_local] int32. Returns (rec,
    levels, sse int64, nonzero count) of the shard."""
    f, hh, ww = frames.shape
    bh, bw = hh // LB, ww // LB
    blocks = (frames.reshape(f, bh, LB, bw, LB).permute(0, 1, 3, 2, 4)
              .reshape(f * bh * bw, LB, LB))
    pred = torch.full_like(blocks, 128)
    resid = blocks - pred
    cf = T.forward_transform(resid, TxSize.TX_32X32, TxType.DCT_DCT)
    lv = T.quantize(cf, TxSize.TX_32X32, qdc, qac)
    dq = T.dequantize(lv, TxSize.TX_32X32, qdc, qac)
    r2 = T.inverse_transform(dq, TxSize.TX_32X32, TxType.DCT_DCT)
    rec = torch.clamp(pred + r2, 0, 255)
    sse = torch.sum((rec - blocks).to(torch.int64) ** 2)
    nz = torch.sum(lv != 0)

    def frame(x):
        return (x.reshape(f, bh, bw, LB, LB).permute(0, 1, 3, 2, 4)
                .reshape(f, hh, ww))

    return frame(rec), frame(lv), sse, nz


def sharded_encode_step(grid, qdc: int = 66, qac: int = 66):
    """The grid-sharded step (the reference's sharded_encode_step):
    step(frames [F, H, W] int32, F a multiple of the grid's gop size and
    W of its tile size) splits the frames over the gop axis and their
    columns over the tile axis, runs _tile_encode_step on each shard's
    device, and returns (rec, levels) reassembled on the grid's first
    device with the SSE and nonzero count summed over every shard
    (psum)."""
    gop, tile = grid.shape
    group = ShardGroup(list(grid.reshape(-1)))

    def step(frames):
        frames = torch.as_tensor(frames, dtype=torch.int32)
        F, H, W = frames.shape
        if F % gop or W % (tile * LB) or H % LB:
            raise ValueError(f"frames {tuple(frames.shape)} do not split over "
                             f"a {gop} x {tile} grid of {LB}-px blocks")
        fl, wl = F // gop, W // tile

        def body(shard):
            g, t = divmod(shard.index, tile)
            x = frames[g * fl:(g + 1) * fl, :, t * wl:(t + 1) * wl]
            rec, lv, sse, nz = _tile_encode_step(x.to(shard.device), qdc, qac)
            return rec, lv, shard.psum(sse), shard.psum(nz)

        outs = group.run(body)
        first = grid.reshape(-1)[0]

        def assemble(j):
            rows = [torch.cat([outs[g * tile + t][j].to(first)
                               for t in range(tile)], dim=2)
                    for g in range(gop)]
            return torch.cat(rows, dim=0)

        return assemble(0), assemble(1), outs[0][2], outs[0][3]

    return step


def dryrun(n_devices: int, devices=None):
    """Run one sharded step on tiny shapes over n devices (the reference's
    multi-chip hook): devices default to the first n CUDA devices. Returns
    (sse, nonzero count)."""
    devices = (devices if devices is not None
               else [f"cuda:{i}" for i in range(n_devices)])[:n_devices]
    grid = make_grid(devices, gop=2 if n_devices % 2 == 0 else 1)
    step = sharded_encode_step(grid)
    gop, tile = grid.shape
    frames = torch.zeros((2 * gop, LB, LB * tile), dtype=torch.int32)
    rec, lv, sse, nz = step(frames)
    if tuple(rec.shape) != tuple(frames.shape):
        raise RuntimeError(f"dryrun: recon {tuple(rec.shape)} for frames "
                           f"{tuple(frames.shape)}")
    return int(sse), int(nz)
