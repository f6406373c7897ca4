"""Patch gather: B clamped P x P windows of a plane (CUDA kernel), and
a group of such gathers in one launch.

The P-frame path reads every block's motion-compensation window and
subpel-descent patch through `gather_patches_many`, where the reference
runs `jax.vmap(jax.lax.dynamic_slice)` (rav1e_tpu/pipeline/tpu_inter.py
`_gather_patch`, `_mc_batch`) and benchmarks a Pallas gather
(tools/bench_gather.py). Starts follow dynamic_slice's rule: a
negative start counts from the end of the axis, then the start is
clamped so the window lies inside the plane.

`gather_patches_many(items)` gathers each item (plane, r0, c0, P) of a
group of at most MAX_ITEMS whose items do not depend on each other; on
the card the whole group is one launch of the kernel in
csrc/gather_patches.cu (counted in `gather_patches_many.launches`).
`gather_patches(plane, r0, c0, P)` is a group of one. A CPU tensor
takes `gather_patches_plain` per item. There is no fallback: a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from rav1e_tpu_torch import nvcc

SRC = nvcc.CSRC / "gather_patches.cu"
MAX_ITEMS = 16      # the kernel's descriptors a launch


class _Desc(ctypes.Structure):
    """csrc/gather_patches.cu's GatherDesc."""
    _fields_ = [("plane", ctypes.c_void_p), ("r0", ctypes.c_void_p),
                ("c0", ctypes.c_void_p), ("out", ctypes.c_longlong),
                ("H", ctypes.c_int), ("W", ctypes.c_int),
                ("B", ctypes.c_int), ("P", ctypes.c_int)]


def _bind(lib):
    lib.gather_patches_many_launch.argtypes = [
        ctypes.POINTER(_Desc), ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.gather_patches_many_launch.restype = ctypes.c_int
    lib.empty_launch.argtypes = [ctypes.c_void_p]
    lib.empty_launch.restype = ctypes.c_int


def _check(plane: torch.Tensor, r0: torch.Tensor, c0: torch.Tensor,
           P: int):
    if plane.dtype != torch.int32 or plane.dim() != 2:
        raise ValueError(f"plane must be int32 [H, W], got {plane.dtype} "
                         f"{tuple(plane.shape)}")
    H, W = plane.shape
    if not 0 < P <= min(H, W):
        raise ValueError(f"patch size {P} does not fit the plane "
                         f"{tuple(plane.shape)}")
    for s in (r0, c0):
        if s.dtype != torch.int32 or s.dim() != 1:
            raise ValueError(f"starts must be int32 [B], got {s.dtype} "
                             f"{tuple(s.shape)}")
        if s.device != plane.device:
            raise ValueError("starts must lie on the plane's device")
    if r0.shape != c0.shape:
        raise ValueError("r0 and c0 differ in length")


def gather_patches_plain(plane: torch.Tensor, r0: torch.Tensor,
                         c0: torch.Tensor, P: int) -> torch.Tensor:
    """The kernel's function in torch indexing: [B, P, P] int32."""
    _check(plane, r0, c0, P)
    H, W = plane.shape
    ar = torch.arange(P, device=plane.device)
    rr = _starts(r0, H, P)[:, None] + ar
    cc = _starts(c0, W, P)[:, None] + ar
    return plane[rr[:, :, None], cc[:, None, :]]


def gather_patches_many_plain(items) -> list[torch.Tensor]:
    """gather_patches_plain of each item (plane, r0, c0, P)."""
    return [gather_patches_plain(*it) for it in items]


def _starts(s: torch.Tensor, n: int, P: int) -> torch.Tensor:
    """dynamic_slice's start rule along an axis of length n."""
    return torch.clamp(torch.where(s < 0, s + n, s), 0, n - P).long()


def gather_patches_many(items) -> list[torch.Tensor]:
    """[out_i] for the items (plane_i, r0_i, c0_i, P_i) of a group, with
    out_i[b] = plane_i[r0'[b]:r0'[b]+P_i, c0'[b]:c0'[b]+P_i] and
    r0' = clamp(r0 + H if r0 < 0 else r0, 0, H - P_i), likewise c0'
    (jax.lax.dynamic_slice's rule). Planes int32 [H_i, W_i], starts int32
    [B_i], all on one device; at most MAX_ITEMS items. CUDA: one kernel
    launch for the group on the current stream (none if every B_i is 0),
    counted in gather_patches_many.launches; CPU: gather_patches_plain
    per item."""
    items = list(items)
    if len(items) > MAX_ITEMS:
        raise ValueError(f"a group holds at most {MAX_ITEMS} gathers, got "
                         f"{len(items)}")
    for it in items:
        _check(*it)
    if not items:
        return []
    dev = items[0][0].device
    if any(it[0].device != dev for it in items):
        raise ValueError("a group's planes must lie on one device")
    if dev.type == "cpu":
        return gather_patches_many_plain(items)
    if dev.type != "cuda":
        raise ValueError(f"gather_patches runs on cuda or cpu, not {dev}")
    if not all(t.is_contiguous() for it in items for t in it[:3]):
        raise ValueError("planes and starts must be contiguous")
    lib = nvcc.load(SRC, _bind)
    sizes = [int(r0.shape[0]) * P * P for _, r0, _, P in items]
    descs, off = [], 0
    for (plane, r0, c0, P), n in zip(items, sizes):
        descs.append(_Desc(plane.data_ptr(), r0.data_ptr(), c0.data_ptr(),
                           off, plane.shape[0], plane.shape[1],
                           r0.shape[0], P))
        off += n
    with torch.cuda.device(dev):
        out = torch.empty(off, dtype=torch.int32, device=dev)
        err = lib.gather_patches_many_launch(
            (_Desc * len(descs))(*descs), len(descs),
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"gather_patches kernel launch failed: CUDA "
                           f"error {err}")
    if off > 0:
        nvcc.count_launch(gather_patches_many)
    outs, off = [], 0
    for (_, r0, _, P), n in zip(items, sizes):
        outs.append(out[off:off + n].view(int(r0.shape[0]), P, P))
        off += n
    return outs


gather_patches_many.launches = 0


def gather_patches(plane: torch.Tensor, r0: torch.Tensor, c0: torch.Tensor,
                   P: int) -> torch.Tensor:
    """out[b] = plane[r0'[b]:r0'[b]+P, c0'[b]:c0'[b]+P]: a group of one
    (gather_patches_many). plane int32 [H, W]; r0, c0 int32 [B]."""
    return gather_patches_many([(plane, r0, c0, P)])[0]


def empty_launch() -> None:
    """Launch csrc/gather_patches.cu's empty kernel on the current
    stream: the fixed cost of a launch, for timing beside the bounds."""
    lib = nvcc.load(SRC, _bind)
    err = lib.empty_launch(
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")
