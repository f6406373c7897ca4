"""Build librav1e_torch.so (the rav1e-compatible C ABI, capi.c).

Compiled at first use with the system g++ against the running Python's
headers and libpython (sysconfig), into rav1e_tpu_torch/build/ (beside
the kernels, which nvcc.py builds there). The library's name carries a
hash of the sources, the flags and the module search path baked into it,
so an edited shim builds anew; it is written to a temporary file and
renamed, so concurrent builds never load a half-written object. Run
`python -m rav1e_tpu_torch.capi.build` to build it and print its path.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import sysconfig
import tempfile
from pathlib import Path

_DIR = Path(__file__).resolve().parent
_PKG = _DIR.parent
_REPO = _PKG.parent
BUILD = _PKG / "build"


def _flags() -> list[str]:
    inc = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR")
    ver = sysconfig.get_config_var("LDVERSION")
    # the running interpreter's module search path, so that a standalone
    # program's embedded interpreter finds torch where this one does
    path = ":".join(p for p in sys.path if p and os.path.isdir(p))
    return ["-O2", "-shared", "-fPIC", f"-I{inc}", f"-I{_DIR}",
            f"-L{libdir}", f"-lpython{ver}", f"-Wl,-rpath,{libdir}",
            f"-DRAV1E_TORCH_ROOT=\"{_REPO}\"",
            f"-DRAV1E_TORCH_PATH=\"{path}\""]


def lib_path() -> Path:
    """Where build() puts the shim for the current sources and flags."""
    h = hashlib.sha256()
    for f in (_DIR / "capi.c", _DIR / "rav1e.h"):
        h.update(f.read_bytes())
    h.update(" ".join(_flags()).encode())
    return BUILD / h.hexdigest()[:16] / "librav1e_torch.so"


def build(force: bool = False) -> Path:
    """Compile the shim (once per source and flags version). Raises if
    Python.h is missing or g++ fails."""
    so = lib_path()
    if so.exists() and not force:
        return so
    inc = Path(sysconfig.get_paths()["include"])
    if not (inc / "Python.h").exists():
        raise RuntimeError(f"Python.h not found under {inc}: the C API shim "
                           "needs the Python development headers")
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    try:
        res = subprocess.run(["g++", "-o", tmp, str(_DIR / "capi.c"),
                              *_flags()], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed to build the C API shim:\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    # the header beside the library, for C programs that link it
    (so.parent / "rav1e.h").write_bytes((_DIR / "rav1e.h").read_bytes())
    return so


if __name__ == "__main__":
    print(build(force=True))
