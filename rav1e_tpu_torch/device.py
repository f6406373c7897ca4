"""Device selection for the port's entry points, host fetches and the
side streams that let worker threads overlap the main thread's work."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None
                   ) -> torch.device:
    """`None` means `cuda`. A CUDA device without CUDA raises: the port
    never falls back to the CPU on its own — pass `device="cpu"`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port "
            "on the CPU")
    return dev


def to_host(t: torch.Tensor):
    """A tensor's values as a numpy array. A CUDA tensor is copied into a
    pinned host buffer on the current stream, which alone is waited
    for."""
    if t.device.type != "cuda":
        return t.numpy()
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return buf.numpy()


class SideStream:
    """Work for another thread to run later, after what is queued now.

    Made on the thread that queued the work it must follow: it records an
    event on `dev`'s current stream. Entered (once, on any thread), it
    runs the body of the `with` on a fresh stream that waits on that
    event, so the body neither waits for nor delays work queued on the
    first stream after the event. The caller keeps every tensor the body
    reads alive until the body has ended; tensors made in the body belong
    to its stream. On the CPU it does nothing."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.event = None
        self._ctx = None
        if dev.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(dev))

    def __enter__(self):
        if self.event is None:
            return None
        stream = torch.cuda.Stream(self.dev)
        stream.wait_event(self.event)
        self._ctx = torch.cuda.stream(stream)
        self._ctx.__enter__()
        return stream

    def __exit__(self, *exc):
        if self._ctx is not None:
            self._ctx.__exit__(*exc)
            self._ctx = None
        return False
