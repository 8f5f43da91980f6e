"""Architecture registry: torch port of ``repro.configs.registry``.

Every arch is a selectable config (``--arch <id>``) with the reference's
interface:

  spec.shapes                          the arch's own input-shape set
  spec.make_dryrun_case(shape, mesh)   -> DryrunCase (a step, its argument
                                          specs and placements) that
                                          ``launch.dryrun`` traces once
  spec.make_smoke_case(device=None)    reduced config + tiny inputs; returns
                                          a function that runs it

Skipped cells (long_500k on the full-attention LMs) return a SkipCell with
the reason: the dry-run reports them rather than dropping them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

_REGISTRY: dict = {}


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """An argument leaf's global shape and dtype (the reference's
    ``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: object


@dataclasses.dataclass
class DryrunCase:
    """One cell's step for the dry-run. ``fn(*args)`` is the step;
    ``build_args()`` gives the argument trees of :class:`TensorSpec` leaves
    (built on first use of ``args``, so a case is as cheap to make as the
    reference's); ``in_placements``/``out_placements`` are trees of
    ``models.sharding.NamedSharding`` leaves shaped like the arguments and
    the result (None: the case places its arguments itself, as the solver
    does). ``make_inputs(device)``, where a case has one, builds the real
    or fake arguments the step runs on (data-dependent index arrays);
    otherwise the dry-run makes them from the specs. ``fake`` is False
    where the step runs on real tensors (the solver's rank program), whose
    collectives ``process_mesh.stats()`` counts."""
    name: str
    fn: Callable
    build_args: Callable
    in_placements: object
    out_placements: object
    model_flops: float           # 6·N·D-style useful-FLOPs estimate
    comment: str = ""
    make_inputs: Optional[Callable] = None
    fake: bool = True
    process_mesh: object = None
    _args: Optional[tuple] = dataclasses.field(default=None, repr=False)

    @property
    def args(self) -> tuple:
        if self._args is None:
            self._args = self.build_args()
        return self._args


@dataclasses.dataclass
class SkipCell:
    name: str
    reason: str


@dataclasses.dataclass
class ArchSpec:
    arch_id: str
    family: str                  # lm | gnn | recsys | solver
    shapes: tuple
    make_dryrun_case: Callable   # (shape_name, mesh) -> DryrunCase | SkipCell
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
