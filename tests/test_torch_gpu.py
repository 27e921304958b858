"""The port's CUDA kernels on the card, against their plain versions.

Skips without a CUDA device.  On a machine with one (and ``nvcc``):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_reference
from repro_torch.core import losses
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import kd_loss as kd
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import build_model

pytestmark = pytest.mark.gpu
TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(n, v, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    s = (2 * torch.randn(n, v, generator=g, device=device)).to(dtype)
    t = (2 * torch.randn(n, v, generator=g, device=device)).to(dtype)
    lab = torch.randint(0, v, (n,), generator=g, device=device,
                        dtype=torch.int32)
    return s, t, lab


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,v", [(1, 1), (7, 8), (128, 1000), (33, 4096),
                                 (5, 151936)])
def test_kernel_matches_plain(cuda, n, v, dtype):
    s, t, lab = _inputs(n, v, dtype, cuda)
    before = kd.launches
    out = kd.kd_loss(s, t, lab, alpha=0.3, temperature=2.0)
    assert kd.launches == before + 1
    ref = kd.kd_loss_plain(s, t, lab, alpha=0.3, temperature=2.0)
    torch.testing.assert_close(out, ref, rtol=TOL[dtype], atol=TOL[dtype])


def test_kernel_refuses_what_it_does_not_take(cuda):
    s, t, lab = _inputs(8, 16, torch.float32, cuda)
    with pytest.raises(TypeError):
        kd.kd_loss(s, t, lab.long())
    with pytest.raises(ValueError, match="contiguous"):
        kd.kd_loss(s.t().contiguous().t(), t, lab)


def test_fused_grad_on_the_card_matches_the_host(cuda):
    s, t, lab = _inputs(4 * 32, 8, torch.float32, cuda)
    s, t, lab = s.view(4, 32, 8), t.view(4, 32, 8), lab.view(4, 32)
    grads = []
    for x, y, z in ((s, t, lab), (s.cpu(), t.cpu(), lab.cpu())):
        x = x.clone().requires_grad_(True)
        losses.fused_distillation_loss(x, y, z).sum().backward()
        grads.append(x.grad.cpu())
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=1e-6)


# -- flash_attention ------------------------------------------------------------
FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _qkv(B, H, KV, S, hd, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=device).to(dtype)
            for shape in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,S,hd,causal,window", [
    (8, 12, 2, 32, 128, True, None),     # the serve path's prefill
    (1, 12, 2, 4096, 128, True, None),   # a long prefill
    (1, 12, 2, 4096, 128, True, 1024),   # sliding window
    (2, 4, 4, 256, 128, False, None),    # non-causal
    (2, 12, 2, 1000, 128, True, None),   # ragged S
    (2, 8, 2, 200, 64, True, 48),        # head_dim 64
    (2, 32, 32, 300, 80, True, None),    # head_dim 80 (Zamba2)
    (1, 2, 1, 1, 64, True, None),        # one token
    (1, 2, 1, 64, 64, True, 0),          # no visible key: zero rows
])
def test_flash_kernel_matches_plain(cuda, B, H, KV, S, hd, causal, window,
                                    dtype):
    q, k, v = _qkv(B, H, KV, S, hd, dtype, cuda, seed=S + hd)
    before = fa.launches
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.launches == before + 1
    ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out, ref, rtol=FA_TOL[dtype],
                               atol=FA_TOL[dtype])


@pytest.mark.parametrize("hd", [64, 80, 128])
def test_flash_bf16_single_tile_matches_matmul_attention(cuda, hd):
    """One 128-row tile over one 64-key tile, no mask: the wgmma operand
    layouts (swizzle, descriptors, the transpose bit of V) against
    attention built from torch.matmul in float32."""
    q, k, v = _qkv(1, 4, 2, 64, hd, torch.bfloat16, cuda, seed=hd)
    out = fa.flash_attention(q, k, v, causal=False)
    kk = k.float().repeat_interleave(2, dim=1)
    vv = v.float().repeat_interleave(2, dim=1)
    scores = torch.matmul(q.float(), kk.transpose(-1, -2)) / hd ** 0.5
    ref = torch.matmul(torch.softmax(scores, -1), vv)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref, rtol=FA_TOL[torch.bfloat16],
                               atol=FA_TOL[torch.bfloat16])


@pytest.mark.parametrize("B,H,KV,S,hd,causal,window", [
    (1, 2, 2, 1, 128, True, None),      # one token, group 1
    (2, 12, 2, 63, 128, True, None),    # S 63: heads of a group packed
    (2, 12, 2, 65, 128, True, None),    # S 65: one tile a head, ragged
    (1, 12, 2, 129, 128, True, None),   # S 129: two KV tiles, ragged
    (2, 32, 2, 32, 64, True, None),     # group 16 packed: 4 q tiles
    (1, 32, 2, 300, 64, True, None),    # group 16, one head a tile
    (2, 4, 2, 200, 80, True, 0),        # window 0: every row zero
    (2, 4, 4, 300, 80, True, 40),       # a window inside one tile
    (2, 6, 2, 40, 128, True, 7),        # a window over packed heads
    (2, 4, 1, 190, 64, False, None),    # non-causal, group 4
    (1, 4, 2, 50, 80, False, 20),       # non-causal window, packed
    (8, 32, 32, 32, 80, True, None),    # Zamba2 serve: KV = H
])
def test_flash_bf16_edges_match_plain(cuda, B, H, KV, S, hd, causal, window):
    q, k, v = _qkv(B, H, KV, S, hd, torch.bfloat16, cuda, seed=7 * S + hd)
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    if window == 0:
        assert not out.any()
    torch.testing.assert_close(out.float(), ref.float(),
                               rtol=FA_TOL[torch.bfloat16],
                               atol=FA_TOL[torch.bfloat16])


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv(1, 4, 2, 64, 64, torch.float32, cuda)
    before = fa.launches
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3),
                           k, v)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(*_qkv(1, 4, 2, 64, 96, torch.float32, cuda))
    with pytest.raises(TypeError, match="one dtype"):
        fa.flash_attention(q, k.bfloat16(), v)
    assert fa.launches == before


def test_flash_launches_count_only_on_cuda(cuda):
    q, k, v = _qkv(1, 4, 2, 64, 64, torch.float32, cuda)
    before = fa.launches
    fa.flash_attention(q.cpu(), k.cpu(), v.cpu())
    assert fa.launches == before
    fa.flash_attention(q, k, v)
    assert fa.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_on_a_second_card(cuda, dtype):
    """Tensors off the current device: the wrapper enters their device's
    guard, launches there, and leaves the current device as it was."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    other = torch.device("cuda", 1)
    q, k, v = _qkv(2, 12, 2, 200, 128, dtype, other, seed=5)
    before = fa.launches
    with torch.cuda.device(0):
        out = fa.flash_attention(q, k, v)
        assert torch.cuda.current_device() == 0
    ref = fa.flash_attention_plain(q, k, v)
    torch.cuda.synchronize(other)
    assert out.device == other and fa.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), rtol=FA_TOL[dtype],
                               atol=FA_TOL[dtype])


def test_smoke_model_on_the_card_matches_the_host(cuda):
    """Prefill (through the kernel) and decode, card vs host, f32."""
    cfg = get_smoke_config("qwen2_1_5b").replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (3, 20),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    outs = []
    for dev in ("cpu", cuda):
        p = params_from_reference(params, dev)  # moves a tree of tensors
        before = fa.launches
        logits, _, cache = model.prefill(p, {"tokens": toks.to(dev)},
                                         cache_len=24)
        assert fa.launches - before == (cfg.num_layers if dev != "cpu" else 0)
        nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        dec, _ = model.decode(p, cache, {"token": nxt})
        outs.append((logits.cpu(), dec.cpu()))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)


# -- ssd_scan -------------------------------------------------------------------
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}  # tests/test_kernels.py


def _ssd_inputs(B, S, H, P, N, dtype, device, seed=0, dt_range=None):
    """x, post-softplus dt (or uniform in dt_range), negative A, B_, C_."""
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    x = randn(B, S, H, P).to(dtype)
    if dt_range is None:
        dt = torch.nn.functional.softplus(randn(B, S, H))
    else:
        lo, hi = dt_range
        dt = lo + (hi - lo) * torch.rand((B, S, H), generator=g, device=device)
    A = -torch.exp(0.5 * randn(H))
    return x, dt, A, randn(B, S, N), randn(B, S, N)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,P,N,chunk,dt_range", [
    (8, 32, 80, 64, 64, 32, None),                # the serve path's prefill
    (1, 4096, 80, 64, 64, 256, (0.001, 0.01)),    # a long prefill, 16 chunks
    (1, 1000, 80, 64, 64, 256, (0.001, 0.01)),    # ragged S
    (2, 32, 16, 32, 16, 16, None),                # the smoke config
    (1, 64, 2, 16, 8, 16, None),                  # tests/test_kernels.py
    (2, 128, 4, 32, 16, 32, None),
    (1, 32, 1, 8, 4, 32, None),
    (2, 300, 3, 128, 128, 100, (0.001, 0.01)),    # the widest P and N
])
def test_ssd_kernel_matches_plain(cuda, B, S, H, P, N, chunk, dt_range,
                                  dtype):
    args = _ssd_inputs(B, S, H, P, N, dtype, cuda, seed=S + P,
                       dt_range=dt_range)
    before = ssd.launches
    y, state = ssd.ssd_scan(*args, chunk=chunk)
    assert ssd.launches == before + 1
    ry, rstate = ssd.ssd_scan_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == args[0].shape
    assert state.dtype == torch.float32 and state.shape == (B, H, P, N)
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(y.float(), ry.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(state, rstate, rtol=tol, atol=tol)


def test_ssd_kernel_matches_the_sequential_oracle(cuda):
    args = _ssd_inputs(1, 600, 4, 64, 64, torch.float32, cuda, seed=1,
                       dt_range=(0.001, 0.01))
    y, state = ssd.ssd_scan(*args, chunk=256)
    ry, rstate = ref.ssd_scan_ref(*args)
    torch.testing.assert_close(y, ry, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(state, rstate, rtol=1e-4, atol=1e-4)


def test_ssd_kernel_refuses_what_it_does_not_take(cuda):
    x, dt, A, Bm, Cm = _ssd_inputs(1, 64, 2, 16, 8, torch.float32, cuda)
    before = ssd.launches
    with pytest.raises(ValueError, match="contiguous"):
        ssd.ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A,
                     Bm, Cm, chunk=16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ssd.ssd_scan(x.half(), dt, A, Bm, Cm, chunk=16)
    with pytest.raises(ValueError, match="match"):
        ssd.ssd_scan(x, dt, A, Bm, Cm[:, :, :4], chunk=16)
    with pytest.raises(ValueError, match="P and N"):
        ssd.ssd_scan(*_ssd_inputs(1, 8, 1, 129, 8, torch.float32, cuda),
                     chunk=8)
    with pytest.raises(ValueError, match="at most"):
        ssd.ssd_scan(*_ssd_inputs(1, 2048, 1, 8, 8, torch.float32, cuda),
                     chunk=2048)
    assert ssd.launches == before


def test_ssd_launches_count_only_on_cuda(cuda):
    args = _ssd_inputs(1, 64, 2, 16, 8, torch.float32, cuda)
    before = ssd.launches
    ssd.ssd_scan(*(t.cpu() for t in args), chunk=16)
    assert ssd.launches == before
    ssd.ssd_scan(*args, chunk=16)
    assert ssd.launches == before + 1


def test_zamba2_smoke_model_on_the_card_matches_the_host(cuda):
    """Prefill (through both kernels) and 4 decode steps, card vs host."""
    cfg = get_smoke_config("zamba2_2_7b").replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (3, 32),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    outs = []
    for dev in ("cpu", cuda):
        p = params_from_reference(params, dev)  # moves a tree of tensors
        counts = (ssd.launches, fa.launches)
        logits, _, cache = model.prefill(p, {"tokens": toks.to(dev)},
                                         cache_len=40)
        on_card = dev != "cpu"
        assert ssd.launches - counts[0] == cfg.num_layers * on_card
        assert fa.launches - counts[1] == \
            cfg.num_layers // cfg.attn_every * on_card
        steps = [logits.cpu()]
        nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        for _ in range(4):
            logits, cache = model.decode(p, cache, {"token": nxt})
            steps.append(logits.cpu())
            nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        outs.append(steps)
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)
