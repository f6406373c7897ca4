"""csrc/gather_patches.cu's share of its roofline over the traced window:
the least time of each launch (bounds.gather_bound on the launch's own
items) summed, over the kernel's device time by name in the profiler's
trace, in %."""

from portbench.harness.bounds import gather_bound

CAPTURE = ("rav1e_tpu_torch.ops.gather", "gather_patches_many")
KERNEL = ("gather_patches_kernel",)


def keep(args, kwargs, out):
    items = list(args[0] if args else kwargs["items"])
    if not items or items[0][0].device.type != "cuda":
        return None
    if all(int(r0.numel()) == 0 for _, r0, _, _ in items):
        return None              # no launch
    return [(tuple(p.shape), (p.data_ptr(), *p.shape), r0, c0, int(P))
            for p, r0, c0, P in items]


def read(run):
    launches = run.launches_of("gather_patches_roofline")
    if run.trace is None or not launches:
        return None
    dev, n = run.trace.kernel_seconds(KERNEL)
    if not n or dev <= 0:
        return None
    return 100.0 * sum(gather_bound(items) for items in launches) / dev
