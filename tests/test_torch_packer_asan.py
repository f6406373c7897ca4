"""The port's C++ packer under ASAN + UBSAN: tests/test_torch_packer.py
again, against an instrumented build.

The packer is driven through raw ctypes buffers, one out-of-bounds
write away from silent corruption that the equality tests alone would
miss if both sides agreed. This test makes entropy/native.py build
csrc/packer.cpp with -fsanitize=address,undefined
-fno-sanitize-recover=all (RAV1E_TPU_TORCH_PACKER_SAN=1, into
rav1e_tpu_torch/build/) and reruns tests/test_torch_packer.py in a
subprocess with libasan preloaded, so any finding aborts the run. As
tests/test_native_packer_asan.py does for the JAX package's packer.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

_REPO = Path(__file__).resolve().parent.parent


def _libasan() -> str:
    try:
        out = subprocess.run(["g++", "-print-file-name=libasan.so"],
                             capture_output=True, text=True, check=True
                             ).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return ""
    return out if os.path.sep in out and os.path.exists(out) else ""


def test_torch_packer_under_asan():
    asan = _libasan()
    if not asan:
        pytest.skip("libasan not available")
    env = dict(os.environ)
    env.update({
        "RAV1E_TPU_TORCH_PACKER_SAN": "1",
        "LD_PRELOAD": asan,
        # python itself "leaks" interned objects at exit; ODR noise
        # from the preloaded runtime vs libstdc++ is not ours either
        "ASAN_OPTIONS": "detect_leaks=0:detect_odr_violation=0",
        "UBSAN_OPTIONS": "print_stacktrace=1",
    })
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:xdist", str(_REPO / "tests" / "test_torch_packer.py")],
        cwd=_REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, (
        f"sanitized packer run failed\n--- stdout ---\n{r.stdout[-4000:]}"
        f"\n--- stderr ---\n{r.stderr[-4000:]}")
    assert " passed" in r.stdout and "skipped" not in r.stdout, r.stdout
