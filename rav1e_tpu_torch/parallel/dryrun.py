"""dryrun_multichip(n): the port's counterpart of the JAX package's
multi-chip hook (__graft_entry__.py::dryrun_multichip).

It runs the multi-device paths over n devices, split as the reference
splits its ('gop', 'tile') mesh:

* the tile axis: one P frame coded as tile columns, one shard a device
  (parallel/tile_encode.py::encode_pframe_tiled), with the cross-tile
  deblock and CDEF halos and every tile coded in one ec_pack launch;
* the gop axis: a GopScheduler over one device a GOP, each encoding a
  KEY + P + P GOP, the streams reassembled in order.

Run it with `python -m rav1e_tpu_torch.parallel.dryrun [n]` (n: default
every visible CUDA device). On CUDA devices each stream must equal the
port's CPU route on the same frames (the tiled frame on as many CPU
shards, each GOP with encode_gop_tpu on the CPU), byte for byte; where
libdav1d loads, every stream must also decode to its recon.
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Run the tile and GOP axes over n devices (default: the first n
    CUDA devices). Returns a summary dict; raises on any mismatch."""
    from rav1e_tpu_torch.parallel.gop_encode import GopScheduler
    from rav1e_tpu_torch.parallel.tile_encode import encode_pframe_tiled
    from rav1e_tpu_torch.pipeline.tpu_inter import encode_gop_tpu
    from rav1e_tpu_torch.pipeline.tpu_intra import encode_keyframe_tpu

    devices = list(devices if devices is not None
                   else [f"cuda:{i}" for i in range(n_devices)])[:n_devices]
    if len(devices) != n_devices or n_devices < 1:
        raise ValueError(f"dryrun_multichip({n_devices}) got {len(devices)} "
                         "devices")
    n_tile = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    n_gop = n_devices // n_tile
    grid = np.asarray(devices, dtype=object).reshape(n_gop, n_tile)
    on_card = torch.device(devices[0]).type == "cuda"

    # ---- tile axis: one P frame sharded as tile columns ----
    rng = np.random.default_rng(7)
    h, w = 64, 64 * n_tile
    base = rng.integers(40, 216, (h + 16, w + 16)).astype(np.uint8)
    f0 = [base[:h, :w], np.full((h // 2, w // 2), 120, np.uint8),
          np.full((h // 2, w // 2), 135, np.uint8)]
    f1 = [base[3:3 + h, 5:5 + w], f0[1], f0[2]]
    pk, rk = encode_keyframe_tpu(f0, qindex=120, speed=9,
                                 cdef=(2, 1, 1, 0, 4), device=devices[0])
    pp, rp = encode_pframe_tiled(f1, rk, 120, list(grid[0]))

    # ---- gop axis: n_gop GOPs of KEY + P + P, one per device ----
    frames = [[base[t % 8:t % 8 + h, t % 8:t % 8 + w], f0[1], f0[2]]
              for t in range(3 * n_gop)]
    sched = GopScheduler(list(grid[:, 0]))
    gpkts, grecs = sched.encode(frames, key_interval=3, qindex=120,
                                speed=8, want_recs=True)
    if on_card:
        pk_c, rk_c = encode_keyframe_tpu(f0, qindex=120, speed=9,
                                         cdef=(2, 1, 1, 0, 4), device="cpu")
        pp_c, _ = encode_pframe_tiled(f1, rk_c, 120, ["cpu"] * n_tile)
        if (pk, pp) != (pk_c, pp_c):
            raise RuntimeError("dryrun_multichip: the tiled P frame differs "
                               "from the CPU route")
        ref = [p for g in range(n_gop) for p in encode_gop_tpu(
            frames[3 * g:3 * g + 3], qindex=120, speed=8, device="cpu")[0]]
        if gpkts != ref:
            raise RuntimeError("dryrun_multichip: the GOP streams differ "
                               "from the CPU route")
    decoded = _decode_check([pk, pp], [rk, rp], gpkts, grecs)
    return {"n_devices": n_devices, "gop": n_gop, "tile": n_tile,
            "tiled_bytes": len(pp), "gop_packets": len(gpkts),
            "cpu_route_equal": on_card, "decoded": decoded}


def _decode_check(tile_pkts, tile_recs, gpkts, grecs) -> bool:
    """Decode both streams on libdav1d and hold them to their recons;
    False where libdav1d does not load (the card's machine has none)."""
    from rav1e_tpu_torch.conform import dav1d
    try:
        dav1d.version()
    except OSError:
        return False
    for pkts, recs in ((tile_pkts, tile_recs), (gpkts, grecs)):
        dec = dav1d.decode_all(pkts)
        for i, r in enumerate(recs):
            for j in range(3):
                if not np.array_equal(dec[i].planes[j], np.asarray(r[j])):
                    raise RuntimeError(f"dryrun_multichip: frame {i} plane "
                                       f"{j} decodes to other pixels")
    return True


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else torch.cuda.device_count()
    print(dryrun_multichip(n))
