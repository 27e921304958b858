"""The port stands alone: no JAX, no reference package, GPU by default."""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)


def test_every_port_module_imports_with_jax_and_reference_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert 'repro_torch.runtime.exchange' in mods, mods\n"
        "print(len(mods))\n"
    )
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny_cohort(**kw):
    from repro_torch.models.small import make_lr
    from repro_torch.runtime.population import PartyPopulation

    x = np.zeros((2, 8, 3), np.float32)
    y = np.zeros((2, 8), np.int32)
    return PartyPopulation(make_lr(3, 2), x, y, task="t", **kw)


def test_population_without_device_raises_when_cuda_is_absent(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _tiny_cohort()
    with pytest.raises(RuntimeError):
        _tiny_cohort(device="cuda")
    assert _tiny_cohort(device="cpu").device.type == "cpu"


def test_exchange_entry_points_without_device_raise_when_cuda_is_absent(
        no_cuda):
    from repro_torch.runtime.exchange import make_verifier, run_exchange
    from repro_torch.runtime.population import stack_teachers

    pop = _tiny_cohort(device="cpu")
    ex, ey = np.zeros((4, 3), np.float32), np.zeros(4, np.int32)
    with pytest.raises(RuntimeError):
        run_exchange([pop], ex, ey)
    with pytest.raises(RuntimeError):
        make_verifier({}, ex, ey)
    with pytest.raises(RuntimeError):
        stack_teachers([pop.party_params(0)])


def test_kd_loss_wrapper_refuses_what_the_kernel_does_not_take():
    from repro_torch.kernels import kd_loss as kd

    s = torch.zeros(4, 6)
    lab = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        kd.kd_loss(s, s, lab.long())
    with pytest.raises(ValueError):
        kd.kd_loss(s, torch.zeros(4, 5), lab)
    with pytest.raises(ValueError):
        kd.kd_loss(s, s, lab[:3])
    with pytest.raises(TypeError):
        kd.kd_loss(s.double(), s.double(), lab)
    with pytest.raises(ValueError, match="cpu or cuda"):
        m = torch.zeros(4, 6, device="meta")
        kd.kd_loss(m, m, torch.zeros(4, dtype=torch.int32, device="meta"))


def test_cpu_tensors_take_the_plain_version_without_building():
    from repro_torch.kernels import kd_loss as kd

    before = kd.launches
    s = torch.randn(5, 7, generator=torch.Generator().manual_seed(0))
    lab = torch.arange(5, dtype=torch.int32)
    out = kd.kd_loss(s, s.flip(0), lab)
    ref = kd.kd_loss_plain(s, s.flip(0), lab)
    assert torch.equal(out, ref)
    assert kd.launches == before
    assert kd._lib is None
