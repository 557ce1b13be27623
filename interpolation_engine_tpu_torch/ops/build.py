"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` (one
``nvcc`` per source, all started together) and the objects link into one
shared library with a plain C interface, under ``_build/`` (git-ignored),
named by a hash of the sources, the headers they share (``csrc/*.cuh``)
and the flags, so an edited source never loads a stale build. Nothing here includes PyTorch's headers, so a build takes
seconds. The library is loaded once per process.

Every entry point that returns a CUDA error code is called through ``call``,
the one place that turns a nonzero code into an error; a kernel ``<name>``
is launched through ``launch`` (its entry point ``<name>_launch``), which
also counts the launch as ``kernel.<name>`` in ``core/events.py``'s
``EVENTS``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ..core.events import EVENTS

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put it on PATH)")


def library_path() -> Path:
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
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
    nvcc = _nvcc()
    tag = f"{so.stem}.{os.getpid()}"
    objects, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        objects.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        for cmd, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                   f"{' '.join(cmd)}\n{err}")
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objects)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, so)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for path in (*objects, tmp):
            path.unlink(missing_ok=True)
    return so


@functools.cache
def load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    ints = ctypes.POINTER(i)
    lib.turbo_step_launch.argtypes = [p] * 7 + [i] * 5 + [ints, i, p]
    lib.turbo_step_launch.restype = i
    lib.regroup_launch.argtypes = [p] + [i] * 4 + [p] * 4
    lib.regroup_launch.restype = i
    lib.turbo_step_attributes.argtypes = [i, ints]
    lib.turbo_step_attributes.restype = i
    lib.turbo_shared_memory.argtypes = [ints]
    lib.turbo_shared_memory.restype = i
    lib.brace_scan_launch.argtypes = [p] * 3 + [i] * 2 + [p]
    lib.brace_scan_launch.restype = i
    lib.brace_scan_plan.argtypes = [i, ints]
    lib.brace_scan_plan.restype = i
    lib.chat_filter_launch.argtypes = [p, p] + [i] * 3 + [p] + [i] * 5 \
        + [p] * 4
    lib.chat_filter_launch.restype = i
    lib.chat_filter_layout.argtypes = [ints]
    lib.chat_filter_layout.restype = i
    lib.chat_filter_attributes.argtypes = [ints]
    lib.chat_filter_attributes.restype = i
    lib.math_eval_launch.argtypes = [p] * 3 + [i] * 2 + [p] * 3
    lib.math_eval_launch.restype = i
    lib.wildcard_match_launch.argtypes = [p, p, i, i, p, p] + [i] * 3 \
        + [p] * 6
    lib.wildcard_match_launch.restype = i
    lib.math_eval_attributes.argtypes = [i, ints]
    lib.math_eval_attributes.restype = i
    lib.wildcard_match_attributes.argtypes = [i] * 4 + [ints]
    lib.wildcard_match_attributes.restype = i
    lib.turbo_error_string.argtypes = [i]
    lib.turbo_error_string.restype = ctypes.c_char_p
    return lib


def call(name: str, *args) -> None:
    """``load().<name>(*args)`` for an entry point that returns a CUDA
    error code; raises ``RuntimeError`` naming it on a nonzero code."""
    lib = load()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc} "
                           f"({lib.turbo_error_string(rc).decode()})")


def launch(kernel: str, *args) -> None:
    """``call("<kernel>_launch", *args)``, a launch of ``kernel``, then
    counted as ``kernel.<kernel>``."""
    call(f"{kernel}_launch", *args)
    EVENTS.count(f"kernel.{kernel}")
