"""Architecture registry: torch port of ``repro.configs.registry``.

Every arch the port has is a selectable config with the reference's
interface, less its dry-run: ``spec.shapes`` (the arch's own four input
shapes) and ``spec.make_smoke_case(device=None)`` (a reduced config and
tiny inputs; returns a function that runs it and returns its outputs).
The reference's ``make_dryrun_case`` lowers a jitted step for XLA's cost
analysis; its port waits for ``launch/dryrun.py`` (ROADMAP A15, A16), so
the port's ``ArchSpec`` has no such field yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

_REGISTRY: dict = {}


@dataclasses.dataclass
class SkipCell:
    name: str
    reason: str


@dataclasses.dataclass
class ArchSpec:
    arch_id: str
    family: str                  # lm | gnn | recsys | solver
    shapes: tuple
    make_smoke_case: Callable    # (device=None) -> () -> dict of outputs
    describe: str = ""


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.arch_id] = spec
    return spec


def get_arch(arch_id: str) -> ArchSpec:
    _ensure_loaded()
    return _REGISTRY[arch_id]


def list_archs() -> list:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    # the arch modules register themselves when imported
    from repro_torch.configs import (arctic_480b, deepfm,  # noqa: F401
                                     egnn, equiformer_v2, laplacian_solver,
                                     meshgraphnet, moonshot_v1_16b_a3b, pna,
                                     qwen2_0p5b, qwen2p5_3b, starcoder2_3b)
