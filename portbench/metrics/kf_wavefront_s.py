"""The keyframe pipeline's recon wavefront (pipeline/tpu_intra.py's
`recon_wavefront` stage, a synchronize at each end): seconds a keyframe,
over the keyframes coded in the timed part of the window."""


def read(run):
    t = [c.timings["recon_wavefront"] for c in run.timed_calls()
         if c.kind == "keyframe" and "recon_wavefront" in c.timings]
    return sum(t) / len(t) if t else None
