"""Assigned architecture registry: ``--arch <id>`` resolution + shape sets.
Port of ``repro/configs/__init__.py``; each ``<arch>.py`` is its twin's copy.

Every architecture module defines ``ARCH`` (the exact assigned config) and
``SMOKE`` (a reduced same-family config for CPU tests).  Shapes follow the
assignment: train_4k / prefill_32k / decode_32k / long_500k, where decode
shapes lower ``serve_step`` (one token against a seq_len KV cache) and
long_500k only runs for sub-quadratic families (quadratic-attention
families skip it by design — the 500k point exists to show the
sub-quadratic scaling, not to OOM a dense-attention smoke host).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

from repro_torch.models.config import ArchConfig

__all__ = ["ARCH_IDS", "SHAPES", "get_arch", "get_smoke", "cells", "Cell"]

ARCH_IDS = (
    "granite_8b",
    "minitron_4b",
    "gemma2_27b",
    "qwen15_4b",
    "rwkv6_3b",
    "llama4_scout_17b_a16e",
    "deepseek_v3_671b",
    "internvl2_26b",
    "hymba_15b",
    "whisper_tiny",
)

# canonical external ids (dashes) -> module names
_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, Shape] = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class Cell:
    arch_id: str
    shape: Shape
    skip: Optional[str] = None  # reason string when not runnable


def get_arch(arch_id: str) -> ArchConfig:
    mod_name = _ALIASES.get(arch_id, arch_id)
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.ARCH


def get_smoke(arch_id: str) -> ArchConfig:
    mod_name = _ALIASES.get(arch_id, arch_id)
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.SMOKE


def cells() -> Tuple[Cell, ...]:
    """All 40 (arch x shape) cells with skip annotations."""
    out = []
    for aid in ARCH_IDS:
        cfg = get_arch(aid)
        for shape in SHAPES.values():
            skip = None
            if shape.name == "long_500k" and not cfg.supports_long_decode:
                skip = (
                    "quadratic/global attention at 500k context "
                    "(assignment: run long_500k only for SSM/hybrid)"
                )
            out.append(Cell(aid, shape, skip))
    return tuple(out)
