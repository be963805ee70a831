"""Assigned architecture configs (one module per arch) + accelerator
settings for the paper experiments.

``get_config(arch_id)`` returns the FULL published config;
``get_smoke_config(arch_id)`` returns the reduced same-family config used by
CPU smoke tests (small widths/layers/vocab — structure preserved).
"""
from __future__ import annotations

import importlib
from typing import List

ARCH_IDS: List[str] = [
    "granite-3-2b",
    "h2o-danube-3-4b",
    "stablelm-12b",
    "phi3-medium-14b",
    "seamless-m4t-medium",
    "falcon-mamba-7b",
    "zamba2-1.2b",
    "qwen2-moe-a2.7b",
    "moonshot-v1-16b-a3b",
    "llava-next-mistral-7b",
]


def _module(arch_id: str):
    mod = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch_id: str):
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str):
    return _module(arch_id).SMOKE
