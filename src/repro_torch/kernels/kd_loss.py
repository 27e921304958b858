"""Fused distillation loss: a hand-written CUDA kernel and its plain version.

Per row, ``alpha*CE(student, label) + (1-alpha)*T^2*KL(teacher_T ||
student_T)``; (N, V), (N, V), (N,) int32 -> (N,) float32.

The kernel (``csrc/kd_loss.cu``) replaces the Pallas TPU kernel
``repro/kernels/kd_loss.py::kd_loss`` (body ``_kd_kernel``).  What bounds
it on the H100 is HBM traffic: it must read both logit matrices and the
labels once and write the losses, ``2*N*V*elt + 8*N`` bytes, and does a
few dozen float32 flops per logit, well under the card's flops-per-byte
balance point.  So its design keeps every intermediate in registers: lanes
stride the vocab with coalesced loads and reduce both softmaxes online
(nine float32 accumulators per lane, merged by shuffle), and neither
softmax nor any (N, V) temporary touches device memory.

:func:`kd_loss` is the wrapper.  A tensor on the CPU takes
:func:`kd_loss_plain`; a CUDA tensor launches the kernel or raises.  The
kernel is compiled with ``nvcc`` at first use from the source in this
package into ``kernels/build/`` (route: plain ``extern "C"`` launcher,
loaded with ``ctypes``), keyed by a hash of the source and flags.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

SOURCE = Path(__file__).with_name("csrc") / "kd_loss.cu"
BUILD_DIR = Path(__file__).with_name("build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches made by kd_loss() on CUDA tensors (never by the plain path)
launches = 0
_lib = None


def kd_loss_plain(student_logits, teacher_logits, labels, *, alpha=0.5,
                  temperature=2.0):
    """The kernel's function in plain PyTorch: the same decomposition
    (log-partition functions and teacher-weighted sums), taken densely."""
    sl = student_logits.float()
    tl = teacher_logits.float()
    inv_t = 1.0 / temperature
    ce = torch.logsumexp(sl, -1) - sl.gather(-1, labels.long()[:, None])[:, 0]
    sl_t, tl_t = sl * inv_t, tl * inv_t
    p = torch.softmax(tl_t, -1)
    kl = ((p * (tl_t - sl_t)).sum(-1) - torch.logsumexp(tl_t, -1)
          + torch.logsumexp(sl_t, -1))
    return alpha * ce + (1.0 - alpha) * (1.0 / (inv_t * inv_t)) * kl


def _check(student_logits, teacher_logits, labels):
    if student_logits.dim() != 2 or teacher_logits.shape != student_logits.shape:
        raise ValueError(
            f"kd_loss wants (N, V) student and teacher logits of one shape, "
            f"got {tuple(student_logits.shape)} and "
            f"{tuple(teacher_logits.shape)}")
    if student_logits.dtype not in _DTYPES or \
            teacher_logits.dtype != student_logits.dtype:
        raise TypeError(
            f"kd_loss takes float32 or bfloat16 logits of one dtype, got "
            f"{student_logits.dtype} and {teacher_logits.dtype}")
    if labels.dtype != torch.int32:
        raise TypeError(f"kd_loss labels must be int32, got {labels.dtype}; "
                        "convert them with .to(torch.int32)")
    if labels.shape != student_logits.shape[:1]:
        raise ValueError(f"labels shape {tuple(labels.shape)} does not match "
                         f"{student_logits.shape[0]} rows")
    devices = {student_logits.device, teacher_logits.device, labels.device}
    if len(devices) != 1:
        raise ValueError(f"kd_loss inputs lie on several devices: {devices}")
    if student_logits.shape[1] == 0:
        raise ValueError("kd_loss needs a vocab of at least one column")


def kd_loss(student_logits, teacher_logits, labels, *, alpha=0.5,
            temperature=2.0):
    """Per-row fused distillation loss. (N,V),(N,V),(N,) int32 -> (N,) f32."""
    global launches
    _check(student_logits, teacher_logits, labels)
    device = student_logits.device
    if device.type == "cpu":
        return kd_loss_plain(student_logits, teacher_logits, labels,
                             alpha=alpha, temperature=temperature)
    if device.type != "cuda":
        raise ValueError(f"kd_loss runs on cpu or cuda, not {device}")
    for name, t in (("student_logits", student_logits),
                    ("teacher_logits", teacher_logits), ("labels", labels)):
        if not t.is_contiguous():
            raise ValueError(f"kd_loss needs contiguous {name}")
    n_rows, vocab = student_logits.shape
    out = torch.empty((n_rows,), dtype=torch.float32, device=device)
    if n_rows == 0:
        return out
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.kd_loss_launch(
            student_logits.data_ptr(), teacher_logits.data_ptr(),
            labels.data_ptr(), out.data_ptr(), n_rows, vocab,
            _DTYPES[student_logits.dtype], float(alpha),
            1.0 / float(temperature), stream)
    if err != 0:
        raise RuntimeError(f"kd_loss kernel launch failed: CUDA error {err}")
    launches += 1
    return out


# -- build and binding ---------------------------------------------------------
def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "kd_loss kernel cannot be built")


def _library_path() -> Path:
    """Where the shared library for the current source and flags lives."""
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libkd_loss_{key}.so"


def build() -> Path:
    """Compile the kernel with nvcc unless this source is already built.

    The compiler's resource report (``-Xptxas -v``) is kept beside the
    library as ``<name>.log``.
    """
    so = _library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}{proc.stderr}")
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.kd_loss_launch
        # pointers and the stream as c_void_p: a plain int would be cut to
        # 32 bits
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_float,
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib
