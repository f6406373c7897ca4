"""GOP-parallel encoding across devices and processes (the port of
rav1e_tpu/parallel/gop_encode.py).

AV1 GOPs that begin with a KEY frame share no state (no reference
planes, no entropy context, no rate history cross the boundary), so
GOPs are the natural outer parallel axis.

Two layers, as the reference's:

* ``GopScheduler``: one process, several devices. Each entry of its
  device list gets a worker thread with a CUDA stream of its own (a
  device may be listed twice); the GOPs are dealt to the workers in
  turn, and each worker encodes its GOPs one after another with the
  port's ``encode_gop_tpu(..., device=dev)``. Workers that share a CUDA
  device take turns, a GOP at a time: eager PyTorch releases and retakes
  the interpreter lock around every op, so two GOPs' Python on one card
  interleave op by op, and two 1080p speed-6 GOPs took 258.5 s on two
  workers against 142.1 s one after the other (chip_smoke.py phase 22b,
  NVIDIA H100 80GB HBM3, 700 W). Workers on distinct devices run at
  once. Packets come back in input order.

* ``DistributedGopScheduler``: several processes. Process p encodes
  GOPs p, p+P, ... with its local ``GopScheduler``, then the packet
  bytes reach every process through ONE all-gather of byte strings
  (``ProcessGroup.allgather_bytes``); pixel data never crosses
  processes. The group is injectable: ``TorchProcessGroup`` rides
  torch.distributed (gloo's all_gather_object) where the reference
  rides jax.distributed; ``MockProcessGroup`` runs P simulated
  processes as threads over disjoint slices of a device list, on the
  same scatter/gather code path.

The reference serialises each scheduler's first GOP under a lock that
guards XLA compiles; the port compiles nothing per shape (its kernels'
one-time build is locked in nvcc.load), so every GOP runs at once.

Bit-exactness: scheduling never changes the per-GOP byte stream; the
same frames encode to the same packets at any device count.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from rav1e_tpu_torch.device import resolve_device


def split_gops(frames, key_interval: int, detector=None):
    """Split frames into GOPs: fixed keyframe cadence plus optional
    scene-cut detector (analysis/scenechange.py instance with
    analyze_next_frame). Returns list of frame-lists."""
    gops, cur = [], []
    for f in frames:
        cut = (len(cur) >= key_interval
               or (detector is not None
                   and detector.analyze_next_frame(f[0]) and cur))
        if cur and cut:
            gops.append(cur)
            cur = []
        cur.append(f)
    if cur:
        gops.append(cur)
    return gops


def _cuda_devices():
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]


def _encode_one_gop(frames, qindex: int, speed: int, cdef, device):
    from rav1e_tpu_torch.pipeline.tpu_inter import encode_gop_tpu
    return encode_gop_tpu(frames, qindex=qindex, speed=speed, cdef=cdef,
                          device=device)


def _run_threads(fn, n: int):
    """fn(k) for k < n, each on a thread of its own; raises the first
    error in thread order, one that broke a barrier (a peer's failure)
    only when there is no other."""
    errs = [None] * n

    def work(k):
        try:
            fn(k)
        except BaseException as e:      # raised below, after the join
            errs[k] = e

    threads = [threading.Thread(target=work, args=(k,)) for k in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    errs.sort(key=lambda e: isinstance(e, threading.BrokenBarrierError))
    for e in errs:
        if e is not None:
            raise e


class GopScheduler:
    """Single-process GOP dispatcher over a device list.

    devices: torch devices (default: every visible CUDA device), repeats
    allowed. Worker k owns devices[k] and a stream of its own on it; GOP
    position j of the ones to encode goes to worker j % n. Workers of one
    CUDA device take turns (a lock per device)."""

    def __init__(self, devices=None):
        self.devices = [resolve_device(d) for d in
                        (devices if devices is not None else _cuda_devices())]
        if not self.devices:
            raise ValueError("GopScheduler needs at least one device")
        self._turns = {self._key(d): threading.Lock()
                       for d in self.devices if d.type == "cuda"}

    @staticmethod
    def _key(dev: torch.device) -> int:
        return dev.index if dev.index is not None else \
            torch.cuda.current_device()

    def encode(self, frames, key_interval: int = 16, qindex: int = 100,
               speed: int = 6, cdef=None, detector=None,
               gop_indices=None, want_recs: bool = False):
        """Encode frames as GOP-parallel streams. Returns the ordered
        packet list (and recon list when want_recs).

        gop_indices: encode only these GOP positions (multi-process
        round-robin); the results then come back as a dict keyed by GOP
        index, each (packets, recons)."""
        gops = split_gops(frames, key_interval, detector)
        mine = (list(range(len(gops))) if gop_indices is None
                else list(gop_indices))
        results: dict[int, tuple] = {}
        lock = threading.Lock()
        n = len(self.devices)

        def worker(k):
            dev = self.devices[k]
            for gi in mine[k::n]:
                if dev.type == "cuda":
                    with self._turns[self._key(dev)], \
                            torch.cuda.device(dev), \
                            torch.cuda.stream(torch.cuda.Stream(dev)):
                        out = _encode_one_gop(gops[gi], qindex, speed, cdef,
                                              dev)
                else:
                    out = _encode_one_gop(gops[gi], qindex, speed, cdef, dev)
                with lock:
                    results[gi] = out

        _run_threads(worker, min(n, len(mine)))
        if gop_indices is not None:
            return results
        pkts = [p for gi in sorted(results) for p in results[gi][0]]
        if want_recs:
            recs = [r for gi in sorted(results) for r in results[gi][1]]
            return pkts, recs
        return pkts


# ---- the multi-process layer ---------------------------------------------


class ProcessGroup:
    """Minimal process-collective surface the scheduler needs. Only
    control-plane bytes (packets) ever cross it."""

    @property
    def rank(self) -> int:
        raise NotImplementedError

    @property
    def size(self) -> int:
        raise NotImplementedError

    def local_devices(self):
        raise NotImplementedError

    def allgather_bytes(self, blobs: list[bytes]) -> list[list[bytes]]:
        """Every process contributes a list of byte strings; every
        process receives [size][...] all lists, rank-ordered."""
        raise NotImplementedError


class TorchProcessGroup(ProcessGroup):
    """A torch.distributed group (gloo). Pass init_method (for example
    "tcp://localhost:29500"), world_size and rank to start the group
    here, or start it before constructing. devices: this process's
    devices (default: every visible CUDA device)."""

    def __init__(self, init_method: str | None = None,
                 world_size: int | None = None, rank: int | None = None,
                 devices=None):
        import torch.distributed as dist
        if init_method is not None:
            dist.init_process_group("gloo", init_method=init_method,
                                    world_size=world_size, rank=rank)
        self._dist = dist
        self._devices = devices

    @property
    def rank(self) -> int:
        return self._dist.get_rank()

    @property
    def size(self) -> int:
        return self._dist.get_world_size()

    def local_devices(self):
        return (list(self._devices) if self._devices is not None
                else _cuda_devices())

    def allgather_bytes(self, blobs: list[bytes]) -> list[list[bytes]]:
        # the objects are this program's own packets (pickled by gloo)
        out: list = [None] * self.size
        self._dist.all_gather_object(out, [bytes(b) for b in blobs])
        return out


class MockProcessGroup(ProcessGroup):
    """P simulated processes inside one real process (tests): thread r
    owns devices[r::P] of its cluster and the all-gather is a
    shared-memory barrier. Use via MockCluster.run()."""

    def __init__(self, cluster: "MockCluster", rank: int):
        self._c = cluster
        self._rank = rank

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def size(self) -> int:
        return self._c.size

    def local_devices(self):
        devs = self._c.devices
        return devs[self._rank::self._c.size] or [devs[0]]

    def allgather_bytes(self, blobs: list[bytes]) -> list[list[bytes]]:
        return self._c._exchange(self._rank, blobs)


class MockCluster:
    """In-process stand-in for a multi-process group: run(fn) launches
    fn(group) on `size` threads and returns their results. devices: the
    cluster's device list (default: every visible CUDA device)."""

    def __init__(self, size: int, devices=None):
        self.size = size
        self.devices = list(devices if devices is not None
                            else _cuda_devices())
        self._box: list = [None] * size
        self._barrier = threading.Barrier(size)

    def _exchange(self, rank: int, blobs):
        self._box[rank] = list(blobs)
        self._barrier.wait()
        out = [list(b) for b in self._box]
        self._barrier.wait()      # don't reset _box under readers
        return out

    def run(self, fn):
        outs = [None] * self.size

        def work(r):
            try:
                outs[r] = fn(MockProcessGroup(self, r))
            except BaseException:
                self._barrier.abort()     # free the peers' all-gather
                raise

        _run_threads(work, self.size)
        return outs


@dataclass
class DistributedGopScheduler:
    """Multi-process GOP parallelism: process p encodes GOPs p, p+P, ...
    on its local devices, then every process assembles the full ordered
    stream from one byte all-gather."""

    group: ProcessGroup

    def encode(self, frames, key_interval: int = 16, qindex: int = 100,
               speed: int = 6, cdef=None, detector=None):
        gops = split_gops(frames, key_interval, detector)
        P = self.group.size
        mine = list(range(self.group.rank, len(gops), P))
        local = GopScheduler(self.group.local_devices())
        results = local.encode(frames, key_interval, qindex, speed,
                               cdef, detector, gop_indices=mine)
        # frame [gop_index: u32][n_pkts: u32] + packets per GOP
        blobs = []
        for gi in mine:
            pkts = results[gi][0]
            hdr = np.asarray([gi, len(pkts)], np.uint32).tobytes()
            blobs.append(hdr + b"".join(
                np.asarray([len(p)], np.uint32).tobytes() + bytes(p)
                for p in pkts))
        gathered = self.group.allgather_bytes(blobs)
        by_gop: dict[int, list[bytes]] = {}
        for rank_blobs in gathered:
            for blob in rank_blobs:
                gi, npk = np.frombuffer(blob[:8], np.uint32)
                pos, pkts = 8, []
                for _ in range(npk):
                    ln, = np.frombuffer(blob[pos:pos + 4], np.uint32)
                    pos += 4
                    pkts.append(blob[pos:pos + ln])
                    pos += ln
                by_gop[int(gi)] = pkts
        if sorted(by_gop) != list(range(len(gops))):
            raise RuntimeError(f"the all-gather returned GOPs "
                               f"{sorted(by_gop)} of {len(gops)}")
        return [p for gi in sorted(by_gop) for p in by_gop[gi]]
