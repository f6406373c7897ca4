"""Frame-level loop-restoration decision pass (all planes): the port of
rav1e_tpu/pipeline/lr.py, shared by the keyframe, P and B pipelines.

Each plane's search and apply run on the device (ops/lrf.py, on the
recon's device) at 8 and 10 bits, reading the deblocked planes before
CDEF beyond each stripe, as decoders do. The reference searches 10-bit planes
in numpy on the host (its int32 box sums overflow there); the port's
search takes its box sums in int64 at 10 bits instead. 12-bit planes
take the reference's numpy search on the host (ops/ref/lrf.py), as the
reference routes every plane above 8 bits; it reads `pre` too.
"""

from __future__ import annotations

import numpy as np
import torch

from rav1e_tpu_torch.device import resolve_device
from rav1e_tpu_torch.ops import lrf
from rav1e_tpu_torch.ops.ref import lrf as ref_lrf


def search_lr_frame(frame_rec, srcs, bit_depth: int, ss_y: int,
                    device=None, pre=None):
    """Search and apply restoration per plane on the (post-CDEF) recon.

    frame_rec: the [y, u, v] planes, numpy arrays or tensors; srcs: the
    source planes, likewise; pre: the deblocked planes before CDEF, whose
    rows beyond each stripe the filters read (None where CDEF is off).
    The search runs on `device` (a tensor plane's own device, else cuda
    unless device="cpu"), or on the host at 12 bits. Each plane that
    chose a filter is replaced in frame_rec by its filtered plane: a
    numpy plane in place, a tensor plane by an int32 tensor on its
    device. Returns (the frame's restoration types for fp.lr_types, the
    tile writer's lr_data or None)."""
    types = [0, 0, 0]
    units: dict = {}
    for pi in range(3):
        rec, src = frame_rec[pi], srcs[pi]
        dev = (rec.device if isinstance(rec, torch.Tensor)
               else resolve_device(device))
        geo = dict(bd=bit_depth, ss=0 if pi == 0 else ss_y, chroma=pi > 0)
        if bit_depth == 12:
            grid, filtered, used = ref_lrf.search_lr_plane(
                _host(rec), _host(src).astype(np.int64),
                pre=None if pre is None else _host(pre[pi]), **geo)
        else:
            grid, filtered, used = lrf.search_lr_plane(
                _on(rec, dev), _on(src, dev),
                pre=None if pre is None else _on(pre[pi], dev), **geo)
        if used:
            types[pi] = 1          # RESTORE_SWITCHABLE
            units[pi] = grid
            if isinstance(rec, torch.Tensor):
                frame_rec[pi] = torch.as_tensor(filtered, device=dev)
            else:
                rec[:] = (filtered.cpu().numpy()
                          if isinstance(filtered, torch.Tensor) else filtered)
    lr_data = {"types": types, "units": units} if any(types) else None
    return tuple(types), lr_data


def apply_lr_frame(frame_rec, srcs, tw, bit_depth: int, ss_x: int,
                   ss_y: int, device=None, pre=None):
    """The reference's apply_lr_frame: search_lr_frame, then the unit
    grids attached to the tile writer (tw.lr_data) when any plane uses
    restoration. Returns the frame's restoration types."""
    types, lr_data = search_lr_frame(frame_rec, srcs, bit_depth, ss_y,
                                     device, pre=pre)
    if lr_data is not None:
        tw.lr_data = lr_data
    return types


def _on(p, dev):
    if isinstance(p, torch.Tensor):
        return p.to(device=dev, dtype=torch.int32)
    return torch.as_tensor(np.asarray(p, np.int32), device=dev)


def _host(p):
    if isinstance(p, torch.Tensor):
        return p.cpu().numpy().astype(np.int32)
    return np.asarray(p, np.int32)
