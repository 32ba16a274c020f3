"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` have a plain C interface.  At first use they are
compiled with ``nvcc`` for ``sm_90a`` into one shared library under
``build/torch_kernels/`` at the root of the checkout, and loaded with
``ctypes``.  The library is rebuilt whenever the hash of the sources and the
build command changes.  Nothing is built when this module is imported: the
CPU tests import every module, and a machine without ``nvcc`` never builds.
``chip_smoke.py`` prints the compiler's register, stack-frame and spill
report and the instruction counts of each kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["build", "load"]

_PKG = Path(__file__).resolve().parents[1]
_SOURCES = [_PKG / "csrc" / "updet_rhs.cu"]
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
LIB_PATH = BUILD_DIR / "libude_kernels.so"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, or ``PATH``."""
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found under {cuda_home}/bin or on PATH: the CUDA kernels "
            "are built on a machine with the CUDA toolkit")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _SOURCES:
        h.update(src.read_bytes())
    return h.hexdigest()


def build(force: bool = False) -> dict:
    """Compile the library unless an up-to-date one exists.

    Returns ``{"path", "built", "seconds", "log"}``; ``log`` is the compiler's
    output (``-Xptxas -v``: registers, stack frame and spills per kernel).
    """
    digest = _digest()
    stamp = LIB_PATH.with_name(LIB_PATH.name + ".sha256")
    if (not force and LIB_PATH.exists() and stamp.exists()
            and stamp.read_text().strip() == digest):
        return {"path": str(LIB_PATH), "built": False, "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: concurrent builders never see
    # a half-written library
    tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *_FLAGS, "-o", str(tmp), *map(str, _SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, LIB_PATH)
    stamp_tmp = stamp.with_name(f"{stamp.name}.{os.getpid()}.tmp")
    stamp_tmp.write_text(digest)
    os.replace(stamp_tmp, stamp)
    return {"path": str(LIB_PATH), "built": True, "seconds": seconds, "log": log}


def _bind(lib):
    """Set the C signatures of a loaded library and read what it reports:
    ``lib.limits`` (threads per block of the runtime-width kernel, max layers,
    max width, max staged floats) and ``lib.nets`` (the width tuples compiled
    as specialised kernels, in the library's order)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    pi = ctypes.POINTER(i)
    lib.ude_updet_rhs.argtypes = [i, p, p, p, pi, i, i, i, p]
    lib.ude_updet_rhs.restype = i
    lib.ude_updet_rhs_tangent.argtypes = [i, p, p, p, p, p, pi, i, i, i, i, p]
    lib.ude_updet_rhs_tangent.restype = i
    lib.ude_empty.argtypes = [p]
    lib.ude_empty.restype = i
    lib.ude_error_string.argtypes = [i]
    lib.ude_error_string.restype = ctypes.c_char_p
    lib.ude_limits.argtypes = [pi]
    lib.ude_limits.restype = None
    lib.ude_nets.argtypes = [pi, i]
    lib.ude_nets.restype = i
    limits = (i * 4)()
    lib.ude_limits(limits)
    lib.limits = tuple(limits)
    size = lib.ude_nets(None, 0)
    buf = (i * size)()
    lib.ude_nets(buf, size)
    nets, k = [], 0
    while k < size:
        n_layers = buf[k]
        nets.append(tuple(buf[k + 1:k + 2 + n_layers]))
        k += 2 + n_layers
    lib.nets = tuple(nets)
    return lib


def load():
    """The loaded library, built first if needed, with its C signatures set."""
    global _lib
    if _lib is None:
        build()
        _lib = _bind(ctypes.CDLL(str(LIB_PATH)))
    return _lib
