"""Build and load the port's hand-written CUDA kernels and its C++
tile packer.

Each `csrc/*.cu` exposes a plain C interface. `build(src)` compiles it
with nvcc for sm_90a into `build/lib<stem>_<hash>.so` (the hash covers
the source and the flags, so an edited source builds anew), with nvcc's
report (ptxas registers, shared memory, spills) kept beside it as
`.log`. `build_host(src, flags)` compiles host C++ (`csrc/packer.cpp`)
with the system g++ the same way. `load(src, bind)` builds once per
process, opens the library with ctypes and lets `bind` set the argument
types; it and `count_launch` are safe to call from several threads.
Nothing here runs at import: the CPU tests import every module and have
no toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HOST_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the port's kernels need the "
                           "CUDA toolkit (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def lib_path(src: Path, flags: list[str] = FLAGS) -> Path:
    tag = hashlib.sha256(src.read_bytes()
                         + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD / f"lib{src.stem}_{tag}.so"


def _compile(compiler: str, src: Path, flags: list[str]) -> Path:
    out = lib_path(src, flags)
    if not out.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        try:
            res = subprocess.run([compiler, *flags, "-o", str(tmp),
                                  str(src)], capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"{compiler} could not be run to build "
                               f"{src.name}: {e}") from e
        if res.returncode != 0:
            raise RuntimeError(f"{os.path.basename(compiler)} failed to "
                               f"build {src.name}:\n{res.stdout}"
                               f"{res.stderr}")
        out.with_suffix(".log").write_text(res.stdout + res.stderr)
        os.replace(tmp, out)
    return out


def build(src: Path) -> Path:
    """Compile `src` with nvcc (once per source version). Raises if nvcc
    is missing or the build fails."""
    return _compile(nvcc(), src, FLAGS)


def build_host(src: Path, flags: list[str] = HOST_FLAGS) -> Path:
    """Compile host C++ `src` with g++ (once per source and flags).
    Raises if g++ is missing or the build fails."""
    return _compile("g++", src, flags)


def build_all(srcs: list[Path]) -> list[Path]:
    """Build several sources at once, one nvcc process each."""
    with ThreadPoolExecutor(len(srcs)) as ex:
        return list(ex.map(build, srcs))


_LIBS: dict[tuple, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def load(src: Path, bind: Callable[[ctypes.CDLL], None],
         host_flags: list[str] | None = None) -> ctypes.CDLL:
    """The library built from `src` (by nvcc, or by g++ with
    `host_flags`), loaded once per process; `bind` declares its
    functions' argument and return types."""
    key = (src, None if host_flags is None else tuple(host_flags))
    with _LOAD_LOCK:
        if key not in _LIBS:
            path = (build(src) if host_flags is None
                    else build_host(src, host_flags))
            lib = ctypes.CDLL(str(path))
            bind(lib)
            _LIBS[key] = lib
        return _LIBS[key]


def count_launch(fn) -> None:
    """Add one to `fn.launches`, the launch count chip_smoke.py reads;
    worker threads launch kernels too, so the add takes a lock."""
    with _COUNT_LOCK:
        fn.launches += 1
