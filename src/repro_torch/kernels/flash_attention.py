"""Flash attention: a hand-written CUDA kernel and its plain version.

Grouped-query attention with a causal and an optional sliding-window mask:
q (B, H, S, hd), k and v (B, KV, S, hd) -> (B, H, S, hd) in q's dtype,
scale ``1/sqrt(hd)``, query head ``h`` reading KV head ``h // (H // KV)``.
Key ``j`` is visible to query ``i`` when ``j <= i`` (causal) and
``i - j < window``; a row with no visible key is zero.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention`` (body
``_flash_kernel``).  Causal attention needs about ``2*B*H*S^2*hd`` flops
against q, k and v read once and o written once, so long prefills are
bound by arithmetic and the serve path's 32-token ones by bytes.  bfloat16
runs on the tensor cores: a warp-specialised block per 128 query rows, K/V
tiles of 128 rows brought by TMA into a two-stage ring guarded by
mbarriers, both products on ``wgmma`` with float32 accumulators and P
rounded to bfloat16 as the second product's register operand, the heaviest
causal tiles first, and at S <= 64 the query heads of a KV group packed
into one tile.  float32 keeps a CUDA-core kernel for parity checks at
2e-5.  Both skip KV tiles outside the causal / window band and, unlike the
Pallas version, mask ragged S instead of asserting ``S % block == 0``.
head_dim 64, 80 and 128.

:func:`flash_attention` is the wrapper.  A tensor on the CPU takes
:func:`flash_attention_plain`; a CUDA tensor launches the kernel or
raises.  The kernel is compiled with ``nvcc`` at first use from the
source in this package by :mod:`repro_torch.kernels._build`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build, ref

SOURCE = _build.CSRC / "flash_attention.cu"
HEAD_DIMS = (64, 80, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches made by flash_attention() on CUDA tensors (never by the
# plain path)
launches = 0
_lib = None


def flash_attention_plain(q, k, v, *, causal=True, window=None):
    """The kernel's function in plain PyTorch: the dense oracle
    (:func:`repro_torch.kernels.ref.flash_attention_ref`, GQA scores in
    float32, the mask, softmax, cast to q's dtype) with zeros in the rows
    where no key is visible."""
    S = q.shape[2]
    out = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    alive = ref.attention_mask(S, causal, window, q.device).any(-1)
    return out * alive[:, None].to(out.dtype)


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"flash_attention wants q (B,H,S,hd) and k, v (B,KV,S,hd), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, hd = q.shape
    Bk, KV, Sk, hdk = k.shape
    if Bk != B or Sk != S or hdk != hd:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in batch, length or head_dim")
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads do not split over {KV} KV heads")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError("flash_attention inputs lie on several devices: "
                         f"{q.device}, {k.device}, {v.device}")
    if window is not None and window < 0:
        raise ValueError(f"window must be None or >= 0, got {window}")


def flash_attention(q, k, v, *, causal=True, window=None):
    """q (B,H,S,hd), k/v (B,KV,S,hd) -> (B,H,S,hd) in q's dtype."""
    global launches
    _check(q, k, v, window)
    if q.is_cpu:
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if not q.is_cuda:
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention needs a contiguous {name}")
    B, H, S, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"the flash_attention kernel is built for head_dim "
                         f"{HEAD_DIMS}, not {hd}")
    # at a 32-token prefill the host's work per call outlasts the kernel, so
    # the device guard is entered only for tensors off the current device
    # (tests/test_torch_gpu.py drives that branch on a second card), and
    # the stream is read as a raw handle (a Stream object costs ~4 us).
    # torch._C._cuda_getCurrentRawStream is private: it is the call that
    # Inductor's generated code makes for the same handle (get_raw_stream),
    # checked on torch 2.11.0+cu128
    index = q.get_device()
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return flash_attention(q, k, v, causal=causal, window=window)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = _library()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     B, H, k.shape[1], S, hd, _DTYPES[q.dtype], int(causal),
                     -1 if window is None else int(window),
                     torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err}")
    launches += 1
    return out


# -- build and binding ---------------------------------------------------------
def build() -> Path:
    """Compile the kernel with nvcc unless this source is already built."""
    return _build.build(SOURCE)


def _library():
    global _lib
    if _lib is None:
        _lib = _build.load(SOURCE, "flash_attention_launch",
                           [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                           + [ctypes.c_void_p])
    return _lib


def smem_bytes(head_dim: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block of the kernel, in bytes, as the
    source computes it (builds the kernel if needed)."""
    fn = _build.load(SOURCE, "flash_attention_smem_bytes",
                     [ctypes.c_int, ctypes.c_int])
    return fn(head_dim, _DTYPES[dtype])
