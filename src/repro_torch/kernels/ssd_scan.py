"""The Mamba2 SSD chunked scan: a hand-written CUDA kernel and its plain
version.

x (B,S,H,P) float32 or bfloat16, post-softplus dt (B,S,H), negative A (H,)
and B_, C_ (B,S,N), one group shared by every head, all float32 ->
y (B,S,H,P) in x's dtype and the final state (B,H,P,N) in float32, where
``state_i = exp(dt_i A) state_{i-1} + dt_i x_i B_i^T`` and
``y_i = C_i . state_i``, computed in chunks of ``chunk`` rows as
``repro.models.ssm.ssd_chunked`` computes it.

The kernel (``csrc/ssd_scan.cu``) replaces the Pallas TPU kernel
``repro/kernels/ssd_scan.py::ssd_scan`` (body ``_ssd_kernel``).  A long
prefill is bound by arithmetic (the causal half of two Q x Q products per
chunk and head), the serve path's 32-token prefills by bytes.  This first
version computes in float32 on the CUDA cores: one block per (head,
batch) walks the chunks in order with the (P,N) state in shared memory,
in 64-row tiles.  It reads x and writes y in their (B,S,H,P) layout, with
no transposed copy, and masks a short last chunk where the Pallas version
asserts ``S % chunk == 0``.  It takes P and N up to 128 and chunks up to
1024 rows.

:func:`ssd_scan` is the wrapper.  A tensor on the CPU takes
:func:`ssd_scan_plain`; a CUDA tensor launches the kernel or raises.  The
kernel is compiled with ``nvcc`` at first use from the source in this
package by :mod:`repro_torch.kernels._build`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

SOURCE = _build.CSRC / "ssd_scan.cu"
MAX_DIM = 128  # largest P and N the kernel takes
MAX_CHUNK = 1024
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches made by ssd_scan() on CUDA tensors (never by the plain
# path)
launches = 0
_lib = None


def ssd_scan_plain(x, dt, A, B_, C_, *, chunk):
    """The kernel's function in plain PyTorch: the port of ``ssd_chunked``
    with the associative scan over chunks written as a loop, in float32.
    A short last chunk is padded with dt = 0 and x = B = C = 0, which
    leaves the state and every earlier output unchanged."""
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    xf, dtf, bf, cf = (t.float() for t in (x, dt, B_, C_))
    if pad:
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        bf = F.pad(bf, (0, 0, 0, pad))
        cf = F.pad(cf, (0, 0, 0, pad))
    Af = A.float()
    ii = torch.arange(Q, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, :, :, None]  # (1,i,j,1)
    state = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        rows = slice(c * Q, (c + 1) * Q)
        xc, dtc, bc, cc = xf[:, rows], dtf[:, rows], bf[:, rows], cf[:, rows]
        cum = torch.cumsum(dtc * Af, dim=1)  # (B,Q,H) inclusive decay
        # intra-chunk: Y[i] = sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) dt_j x_j;
        # the exponential of the masked (j > i) entries is never formed
        G = torch.einsum("bin,bjn->bij", cc, bc)
        seg = cum[:, :, None, :] - cum[:, None, :, :]  # (B,i,j,H)
        decay = torch.exp(seg.masked_fill(~causal, float("-inf")))
        M = G[..., None] * decay * dtc[:, None, :, :]
        y = torch.einsum("bijh,bjhp->bihp", M, xc)
        # the carried state's term, then the state leaving the chunk
        y = y + torch.einsum("bqh,bqn,bhpn->bqhp", torch.exp(cum), cc, state)
        w = torch.exp(cum[:, -1:, :] - cum) * dtc  # (B,Q,H)
        s_c = torch.einsum("bjh,bjn,bjhp->bhpn", w, bc, xc)
        state = torch.exp(cum[:, -1, :])[..., None, None] * state + s_c
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :S]
    return y.to(x.dtype), state


def _check(x, dt, A, B_, C_, chunk):
    if x.dim() != 4:
        raise ValueError(f"ssd_scan wants x (B,S,H,P), got {tuple(x.shape)}")
    Bsz, S, H, P = x.shape
    if dt.shape != (Bsz, S, H) or A.shape != (H,) or B_.dim() != 3 \
            or B_.shape[:2] != (Bsz, S) or C_.shape != B_.shape:
        raise ValueError(
            f"ssd_scan wants dt (B,S,H), A (H,), B_ and C_ (B,S,N) to match "
            f"x {tuple(x.shape)}, got {tuple(dt.shape)}, {tuple(A.shape)}, "
            f"{tuple(B_.shape)}, {tuple(C_.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"ssd_scan takes float32 or bfloat16 x, not {x.dtype}")
    for name, t in (("dt", dt), ("A", A), ("B_", B_), ("C_", C_)):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan takes float32 {name}, not {t.dtype}")
    if len({t.device for t in (x, dt, A, B_, C_)}) != 1:
        raise ValueError("ssd_scan inputs lie on several devices")
    if S < 1:
        raise ValueError("ssd_scan needs at least one row (S >= 1)")
    if int(chunk) != chunk or chunk < 1:
        raise ValueError(f"chunk must be a positive int, got {chunk}")


def ssd_scan(x, dt, A, B_, C_, *, chunk):
    """x (B,S,H,P), dt (B,S,H), A (H,), B_/C_ (B,S,N) -> y (B,S,H,P) in x's
    dtype and the final state (B,H,P,N) in float32; the chunk is
    ``min(chunk, S)`` rows, as in the reference."""
    global launches
    _check(x, dt, A, B_, C_, chunk)
    device = x.device
    if device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B_, C_, chunk=chunk)
    if device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cpu or cuda, not {device}")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B_", B_), ("C_", C_)):
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan needs a contiguous {name}")
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    if not (1 <= P <= MAX_DIM and 1 <= N <= MAX_DIM):
        raise ValueError(f"the ssd_scan kernel takes P and N in 1..{MAX_DIM}, "
                         f"not P {P}, N {N}")
    Q = min(int(chunk), S)
    if Q > MAX_CHUNK:
        raise ValueError(f"the ssd_scan kernel takes chunks of at most "
                         f"{MAX_CHUNK} rows, not {Q}")
    y = torch.empty_like(x)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=device)
    if x.numel() == 0:
        return y, state
    launch = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                     B_.data_ptr(), C_.data_ptr(), y.data_ptr(),
                     state.data_ptr(), Bsz, S, H, P, N, Q, _DTYPES[x.dtype],
                     stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    launches += 1
    return y, state


# -- build and binding ---------------------------------------------------------
def build() -> Path:
    """Compile the kernel with nvcc unless this source is already built."""
    return _build.build(SOURCE)


def _library():
    global _lib
    if _lib is None:
        _lib = _build.load(SOURCE, "ssd_scan_launch",
                           [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                           + [ctypes.c_void_p])
    return _lib
