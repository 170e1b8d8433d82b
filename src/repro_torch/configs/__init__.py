"""Architecture registry: ``--arch <id>`` resolves here.

The port's copy of the reference registry, with the same names.  Every
arch of the reference resolves; an arch listed in :data:`UNPORTED` (none
now) would raise ``NotImplementedError`` naming the ROADMAP item that
ports it.
"""
from __future__ import annotations

from typing import Dict

from .base import ArchSpec

_MODULES = {
    "deepseek-moe-16b": "deepseek_moe_16b",
    "dbrx-132b": "dbrx_132b",
    "gemma3-27b": "gemma3_27b",
    "nemotron-4-15b": "nemotron_4_15b",
    "granite-3-8b": "granite_3_8b",
    "gin-tu": "gin_tu",
    "nequip": "nequip",
    "meshgraphnet": "meshgraphnet",
    "egnn": "egnn",
    "dcn-v2": "dcn_v2",
    "ebbkc": "ebbkc",
}

ASSIGNED = [k for k in _MODULES if k != "ebbkc"]

#: archs whose model is not ported yet -> the ROADMAP item that ports it
UNPORTED: Dict[str, str] = {}


def get(name: str) -> ArchSpec:
    import importlib
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    if name in UNPORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to repro_torch yet; ROADMAP item "
            f"{UNPORTED[name]}")
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    return mod.SPEC


def all_specs() -> Dict[str, ArchSpec]:
    """Every arch the port runs (the reference's registry less
    :data:`UNPORTED`)."""
    return {name: get(name) for name in _MODULES if name not in UNPORTED}
