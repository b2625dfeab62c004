"""Architecture registry; counterpart of ``repro.configs``.

The reference's ten architectures, all ported: the dense ``qwen3-0.6b``,
``phi4-mini-3.8b`` and ``command-r-plus-104b`` (GQA) and ``minicpm3-4b``
(MLA), the moe ``qwen3-moe-235b-a22b`` and ``llama4-scout-17b-a16e``, the
ssm ``mamba2-130m``, the hybrid ``zamba2-1.2b``, the vlm ``pixtral-12b``
(patch embeddings in, text decoded) and the audio ``hubert-xlarge``
(frame embeddings in, encoder-only). An unknown name raises ``KeyError``.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCHS: List[str] = [
    "mamba2-130m",
    "minicpm3-4b",
    "qwen3-0.6b",
    "command-r-plus-104b",
    "phi4-mini-3.8b",
    "llama4-scout-17b-a16e",
    "qwen3-moe-235b-a22b",
    "pixtral-12b",
    "hubert-xlarge",
    "zamba2-1.2b",
]

PORTED: List[str] = list(ARCHS)

_MODULES: Dict[str, str] = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE_CONFIG
