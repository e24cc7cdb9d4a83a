"""Architecture registry (counterpart of ``repro.configs``).

Config files are named exactly after the arch ids (``llama3.2-3b.py``:
dots and dashes in the file name, loaded with importlib), each
exposing a ``CONFIG: ModelConfig`` with its public-pool citation in
``CONFIG.source``, copied field for field from ``repro.configs``.
All ten of the reference's archs, in its order; an unknown id raises
``KeyError``.
"""
from __future__ import annotations

import importlib.util
import pathlib

from repro_torch.models.config import ModelConfig

_DIR = pathlib.Path(__file__).parent

ARCH_IDS = [
    "qwen2.5-32b",
    "mamba2-2.7b",
    "qwen2-7b",
    "phi3.5-moe-42b-a6.6b",
    "jamba-v0.1-52b",
    "llama3.2-3b",
    "dbrx-132b",
    "internvl2-1b",
    "musicgen-medium",
    "starcoder2-3b",
]

_CACHE: dict[str, ModelConfig] = {}


def get_config(arch: str) -> ModelConfig:
    if arch in _CACHE:
        return _CACHE[arch]
    path = _DIR / f"{arch}.py"
    if arch not in ARCH_IDS or not path.exists():
        raise KeyError(f"arch {arch!r} is unknown; known: {ARCH_IDS}")
    spec = importlib.util.spec_from_file_location(
        f"repro_torch_config_{arch}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cfg = mod.CONFIG
    if cfg.name != arch:
        raise ValueError(f"{path}: CONFIG.name={cfg.name!r} != {arch!r}")
    _CACHE[arch] = cfg
    return cfg


def list_archs() -> list[str]:
    return list(ARCH_IDS)


def get_smoke_config(arch: str) -> ModelConfig:
    return get_config(arch).reduced()
