"""csrc/cdef.cu's ladder SSE kernel's share of its roofline over the
traced window: the least time of each launch (bounds.cdef_ladder_bound
on the launch's own planes, variance and skip grids) summed, over the
kernel's device time by name in the profiler's trace, in %."""

from portbench.harness.bounds import cdef_ladder_bound

CAPTURE = ("rav1e_tpu_torch.ops.cdef", "cdef_ladder_sse")
KERNEL = ("cdef_ladder_sse_kernel",)


def keep(args, kwargs, out):
    names = ("planes", "srcs", "dirs", "var", "skip8", "damping", "sampled")
    a = dict(zip(names, args), **kwargs)
    planes = a["planes"]
    if planes[0].device.type != "cuda" or a.get("halo", 0):
        return None
    return ([tuple(p.shape) for p in planes], planes[0].element_size(),
            a["var"], a["skip8"], bool(a["sampled"]),
            [int(t[0].numel()) for t in out])


def read(run):
    launches = run.launches_of("cdef_ladder_sse_roofline")
    if run.trace is None or not launches:
        return None
    dev, n = run.trace.kernel_seconds(KERNEL)
    if not n or dev <= 0:
        return None
    return 100.0 * sum(cdef_ladder_bound(*x) for x in launches) / dev
