"""The entropy layer's tile walk (entropy/native.py over csrc/packer.cpp,
or entropy/tile.py's Python TileWriter for B frames): the `tile_walk`
stage in ms a frame, over the frames coded in the timed part of the
window."""


def read(run):
    t = [c.timings["tile_walk"] for c in run.timed_calls()
         if "tile_walk" in c.timings]
    return sum(t) / len(t) * 1e3 if t else None
