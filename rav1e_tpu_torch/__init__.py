"""rav1e_tpu_torch — the PyTorch/CUDA port of the tav1e AV1 encoder.

A second package beside the JAX package (rav1e_tpu/, the reference,
which it never imports). Device code is PyTorch on an NVIDIA GPU; every
Pallas kernel of the reference on a ported path is a hand-written CUDA
kernel under `csrc/`. Entry points run on `cuda` unless the caller
passes `device="cpu"` (see `device.resolve_device`).

Everything the JAX package does is ported: the device pipelines
(`pipeline.tpu_intra`, `pipeline.tpu_inter`), the numpy pipelines, the
session API and CLI (`api`, `cli`), the C API (`capi`) and the
multi-device layer (`parallel`), with the od_ec range coder
(`csrc/ec_pack.cu`), the patch gather (`csrc/gather_patches.cu`) and
CDEF (`csrc/cdef.cu`) as CUDA kernels.
"""

import torch

from rav1e_tpu_torch.device import resolve_device  # noqa: F401

__version__ = "0.1.0"

# The reference's forward and approximate inverse transforms run f32
# products at full float32 precision (ops/transforms.py); TF32 would
# round their inputs to 10 mantissa bits on the card.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
