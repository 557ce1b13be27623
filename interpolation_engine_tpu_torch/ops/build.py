"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, under ``_build/`` (git-ignored),
named by a hash of the sources and flags so an edited source never loads a
stale build. Nothing here includes PyTorch's headers, so a build takes
seconds. The library is loaded once per process.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put it on PATH)")


def library_path() -> Path:
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libie_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless this exact build exists; raise with
    nvcc's stderr when it fails."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, so)
    return so


@functools.cache
def load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.turbo_step_launch.argtypes = [p] * 7 + [i] * 7 + [p]
    lib.turbo_step_launch.restype = i
    lib.turbo_error_string.argtypes = [i]
    lib.turbo_error_string.restype = ctypes.c_char_p
    return lib
