"""Patch gather: B clamped P x P windows of one plane (CUDA kernel).

The P-frame path reads every block's motion-compensation window and
subpel-descent patch with one call, where the reference runs
`jax.vmap(jax.lax.dynamic_slice)` (rav1e_tpu/pipeline/tpu_inter.py
`_gather_patch`, `_mc_batch`) and benchmarks a Pallas gather
(tools/bench_gather.py). Starts follow dynamic_slice's rule: a
negative start counts from the end of the axis, then the start is
clamped so the window lies inside the plane.

`gather_patches` takes a CUDA tensor to the kernel in
csrc/gather_patches.cu and a CPU tensor to `gather_patches_plain`.
There is no fallback: a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from rav1e_tpu_torch import nvcc

SRC = nvcc.CSRC / "gather_patches.cu"


def _bind(lib):
    lib.gather_patches_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.gather_patches_launch.restype = ctypes.c_int


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


def _starts(s: torch.Tensor, n: int, P: int) -> torch.Tensor:
    """dynamic_slice's start rule along an axis of length n."""
    return torch.clamp(torch.where(s < 0, s + n, s), 0, n - P).long()


def gather_patches(plane: torch.Tensor, r0: torch.Tensor, c0: torch.Tensor,
                   P: int) -> torch.Tensor:
    """out[b] = plane[r0'[b]:r0'[b]+P, c0'[b]:c0'[b]+P] with
    r0' = clamp(r0 + H if r0 < 0 else r0, 0, H - P), likewise c0'
    (jax.lax.dynamic_slice's rule).
    plane int32 [H, W]; r0, c0 int32 [B]. A CUDA tensor runs the kernel
    on the current stream (counted in gather_patches.launches); a CPU
    tensor runs gather_patches_plain."""
    _check(plane, r0, c0, P)
    if plane.device.type == "cpu":
        return gather_patches_plain(plane, r0, c0, P)
    if plane.device.type != "cuda":
        raise ValueError(f"gather_patches runs on cuda or cpu, not "
                         f"{plane.device}")
    if not (plane.is_contiguous() and r0.is_contiguous()
            and c0.is_contiguous()):
        raise ValueError("plane and starts must be contiguous")
    lib = nvcc.load(SRC, _bind)
    H, W = plane.shape
    B = r0.shape[0]
    with torch.cuda.device(plane.device):
        out = torch.empty((B, P, P), dtype=torch.int32, device=plane.device)
        err = lib.gather_patches_launch(
            ctypes.c_void_p(plane.data_ptr()), H, W,
            ctypes.c_void_p(r0.data_ptr()), ctypes.c_void_p(c0.data_ptr()),
            B, P, ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"gather_patches kernel launch failed: CUDA "
                           f"error {err}")
    gather_patches.launches += 1
    return out


gather_patches.launches = 0
