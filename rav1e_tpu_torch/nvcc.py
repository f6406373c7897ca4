"""Build and load the port's hand-written CUDA kernels.

Each `csrc/*.cu` exposes a plain C interface. `build(src)` compiles it
with nvcc for sm_90a into `build/lib<stem>_<hash>.so` (the hash covers
the source and the flags, so an edited source builds anew), with nvcc's
report (ptxas registers, shared memory, spills) kept beside it as
`.log`. `load(src, bind)` builds once per process, opens the library
with ctypes and lets `bind` set the argument types. Nothing here runs at
import: the CPU tests import every module and have no toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the port's kernels need the "
                           "CUDA toolkit (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def lib_path(src: Path) -> Path:
    tag = hashlib.sha256(src.read_bytes()
                         + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"lib{src.stem}_{tag}.so"


def build(src: Path) -> Path:
    """Compile `src` (once per source version). Raises if nvcc is
    missing or the build fails."""
    out = lib_path(src)
    if not out.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([nvcc(), *FLAGS, "-o", str(tmp), str(src)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src.name}:\n"
                               f"{res.stdout}{res.stderr}")
        out.with_suffix(".log").write_text(res.stdout + res.stderr)
        os.replace(tmp, out)
    return out


def build_all(srcs: list[Path]) -> list[Path]:
    """Build several sources at once, one nvcc process each."""
    with ThreadPoolExecutor(len(srcs)) as ex:
        return list(ex.map(build, srcs))


_LIBS: dict[Path, ctypes.CDLL] = {}


def load(src: Path, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The library built from `src`, loaded once per process; `bind`
    declares its functions' argument and return types."""
    if src not in _LIBS:
        lib = ctypes.CDLL(str(build(src)))
        bind(lib)
        _LIBS[src] = lib
    return _LIBS[src]
