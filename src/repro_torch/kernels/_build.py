"""Build and bind the port's CUDA kernels (plain ``extern "C"`` launchers).

Each kernel source under ``csrc/`` is compiled with ``nvcc`` for
``sm_90a`` into a shared library at first use, into ``kernels/build/``
(ignored by git), keyed by a hash of the source and the flags, and
loaded with ``ctypes``.  Nothing is compiled when a module is imported,
so the CPU-only tests can import every kernel module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels cannot be built")


def _library_path(source: Path) -> Path:
    """Where the shared library for this source and the flags lives."""
    key = hashlib.sha256(source.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}_{key}.so"


def build(source: Path) -> Path:
    """Compile ``source`` with nvcc unless this version is already built.

    The compiler's resource report (``-Xptxas -v``) is kept beside the
    library as ``<name>.log``.
    """
    so = _library_path(source)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}{proc.stderr}")
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


def load(source: Path, symbol: str, argtypes):
    """Build ``source`` if needed and return its launcher ``symbol``, which
    returns the ``cudaError_t`` of its launch as an int.

    Pointers and the stream must be declared ``ctypes.c_void_p`` in
    ``argtypes``: an undeclared Python int is passed as 32 bits.
    """
    fn = getattr(ctypes.CDLL(str(build(source))), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn
