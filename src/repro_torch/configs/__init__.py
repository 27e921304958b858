"""Architecture registry of the port.

Each module exposes ``CONFIG`` (the assigned configuration, citing its
source) and ``SMOKE`` (a reduced same-family variant for CPU tests), as in
the reference.  Only the ported architectures are listed; the others wait
for ROADMAP A8.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "qwen2_1_5b",
    "zamba2_2_7b",
]

_ALIAS = {i.replace("_", "-"): i for i in ARCH_IDS}


def _module(arch: str):
    arch = _ALIAS.get(arch, arch)
    if arch not in ARCH_IDS:
        raise KeyError(f"arch {arch!r} is not ported yet (ROADMAP A8); "
                       f"ported: {sorted(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).SMOKE
