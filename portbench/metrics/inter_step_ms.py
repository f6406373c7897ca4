"""The inter pipeline's device step (pipeline/tpu_inter.py): the stages
from `upload` up to the first stage that fetches or packs, summed, in ms
an inter frame, over the P and B frames coded in the timed part of the
window (the calls that filled `timings`)."""

PACKING = {"fetch_unpack", "pack", "lr", "tile_walk", "ir_upload",
           "ec_kernel", "finish"}


def _step(tm):
    s = 0.0
    for stage, sec in tm.items():
        if stage in PACKING:
            break
        s += sec
    return s


def read(run):
    t = [_step(c.timings) for c in run.timed_calls()
         if c.kind in ("pframe", "bframe")]
    return sum(t) / len(t) * 1e3 if t else None
