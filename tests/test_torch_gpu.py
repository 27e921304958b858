"""The port's CUDA kernels on the card, against their plain versions.

Skips without a CUDA device.  On a machine with one (and ``nvcc``):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from repro_torch.core import losses
from repro_torch.kernels import kd_loss as kd

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
