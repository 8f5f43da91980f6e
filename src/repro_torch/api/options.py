"""``SolverOptions``: one knob surface for every backend (torch port of
``repro.api.options``).

Merges the core layer's ``SetupConfig`` (hierarchy construction),
``CycleConfig``/``SmootherConfig`` (preconditioner) and the Krylov stopping
controls into one flat frozen dataclass with the reference's fields and
defaults, plus ``device``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.aggregation import AggregationConfig
from repro_torch.core.cycles import CycleConfig
from repro_torch.core.hierarchy import SetupConfig
from repro_torch.core.smoothers import SmootherConfig


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """All solver knobs, backend-agnostic. Defaults are the paper's choices.

    Stopping: ``tol`` (``||r|| <= tol·||r0||``) and ``max_iters``; the
    eager PCG stops at whichever comes first.

    Setup: ``coarsest_size``, ``max_levels``, ``elim_max_degree``,
    ``strength_metric``, ``random_ordering`` (paper §2.2 relabeling),
    ``seed``; ``setup_mode`` (``"superstep"``, the default, or
    ``"eager"``; equal hierarchies), ``setup_bucket_floor`` and
    ``elim_sizing`` (``repro_torch.core.setup_step``);
    ``setup_ell_sweeps`` (the strength sweeps through the ``spmv_ell``
    kernel on a fixed-width ELL twin, with any ``matvec_backend`` but
    ``"coo"``).

    Solve: ``matvec_backend`` — ``"coo"`` (gather + deterministic segment
    sum), ``"ell"`` (hybrid ELL+COO twin on every level, run by the
    ``spmv_ell`` and ``jacobi`` kernels) or ``"auto"``
    (``repro_torch.sparse.matvec``); ``cycle``, ``smoother``,
    ``pre_sweeps``/``post_sweeps``, ``cheby_degree``, ``precondition``
    (False = plain CG); ``exact_columns`` (blocked solves bitwise equal to
    looped ones; False makes the reductions 2-D).

    Robustness: ``guard`` (the observe-only breakdown guards),
    ``stagnation_window``, ``fallback`` (the facade's degradation ladder:
    rebuild, diagonal-preconditioned CG, then a dense solve for
    ``n <= dense_fallback_max``), ``verify`` (``"off"``; ``"cheap"``: the
    zero-column-sum checksum on every hot-path SpMV and a float64
    certificate on every result; ``"paranoid"``: adds the Rademacher
    witness — clean solves are bitwise the same in all three), ``triage``
    (admission-time conditioning score, ``repro_torch.api.triage``),
    ``checkpoint_every`` (``repro_torch.service``: snapshot completed
    tickets every N at solve-group boundaries; 0 = off).
    ``guard_mode``, ``dist_nnz_threshold`` and ``max_dist_levels`` belong
    to the distributed layer, which is not ported yet (ROADMAP A11): any
    value but the default raises NotImplementedError.

    The port adds one field: ``device``, the torch device the backend
    builds and solves on. ``None`` (default) means the CUDA card and
    raises without one (``repro_torch.device.resolve_device``). It keeps
    backends on the reference's ``(problem, options, mesh)`` signature and
    is part of the hierarchy cache's key.
    """

    # stopping
    tol: float = 1e-8
    max_iters: int = 200
    # setup
    coarsest_size: int = 128
    max_levels: int = 20
    elim_max_degree: int = 4
    strength_metric: str = "algebraic_distance"
    random_ordering: bool = True
    seed: int = 0
    # solve-phase SpMV execution format ("coo" | "ell" | "auto")
    matvec_backend: str = "coo"
    # setup execution mode, super-step bucket floor, elimination sizing,
    # and the setup-time ELL strength sweeps
    setup_mode: str = "superstep"
    setup_bucket_floor: int = 0
    elim_sizing: str = "conservative"
    setup_ell_sweeps: bool = False
    # cycle / smoother
    cycle: str = "V"
    smoother: str = "jacobi"
    pre_sweeps: int = 2
    post_sweeps: int = 2
    cheby_degree: int = 3
    precondition: bool = True
    # multi-RHS
    exact_columns: bool = True
    # robustness: breakdown guards + degradation ladder + triage/checkpoint
    guard: bool = True
    guard_mode: str = "in_scan"
    stagnation_window: int = 50
    fallback: bool = True
    dense_fallback_max: int = 4096
    triage: bool = False
    checkpoint_every: int = 0
    # self-verification: ABFT checksums + residual certificates
    verify: str = "off"
    # distributed
    dist_nnz_threshold: int = 10_000
    max_dist_levels: int = 3
    # where the port runs: None = the CUDA card (``resolve_device``), or a
    # torch device such as "cpu"; part of the hierarchy cache's key
    device: object = None

    def __post_init__(self):
        # Fail in milliseconds, not after a multi-second hierarchy build.
        from repro_torch.sparse.matvec import validate_backend

        validate_backend(self.matvec_backend)
        if self.setup_mode not in ("superstep", "eager"):
            raise ValueError(f"setup_mode must be 'superstep' or 'eager', "
                             f"got {self.setup_mode!r}")
        if self.elim_sizing not in ("conservative", "exact"):
            raise ValueError(f"elim_sizing must be 'conservative' or "
                             f"'exact', got {self.elim_sizing!r}")
        floor = self.setup_bucket_floor
        if floor < 0 or (floor & (floor - 1)):
            raise ValueError(f"setup_bucket_floor must be 0 or a power of "
                             f"two, got {floor!r}")
        if self.stagnation_window < 1:
            raise ValueError(f"stagnation_window must be >= 1, got "
                             f"{self.stagnation_window}")
        if self.dense_fallback_max < 0:
            raise ValueError(f"dense_fallback_max must be >= 0, got "
                             f"{self.dense_fallback_max}")
        if self.guard_mode not in ("in_scan", "postmortem"):
            raise ValueError(f"guard_mode must be 'in_scan' or "
                             f"'postmortem', got {self.guard_mode!r}")
        if self.checkpoint_every < 0:
            raise ValueError(f"checkpoint_every must be >= 0, got "
                             f"{self.checkpoint_every}")
        if self.verify not in ("off", "cheap", "paranoid"):
            raise ValueError(f"verify must be 'off', 'cheap' or 'paranoid', "
                             f"got {self.verify!r}")
        for name, layer in _UNPORTED.items():
            if getattr(self, name) != _DEFAULTS[name]:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r} is not ported yet: it "
                    f"belongs to {layer}")

    def guard_config(self):
        """The Krylov-layer guard policy this maps to (None = guards off)."""
        from repro_torch.core.krylov import GuardConfig

        if not self.guard:
            return None
        return GuardConfig(stagnation_window=self.stagnation_window)

    def verify_config(self):
        """The checksum policy this maps to (None = verification off)."""
        from repro_torch.core.verify import VerifyConfig

        if self.verify == "off":
            return None
        return VerifyConfig(mode=self.verify, seed=self.seed)

    def setup_config(self) -> SetupConfig:
        """The core-layer setup configuration this maps to."""
        return SetupConfig(
            max_levels=self.max_levels,
            coarsest_size=self.coarsest_size,
            elim_max_degree=self.elim_max_degree,
            strength_metric=self.strength_metric,
            aggregation=AggregationConfig(),
            seed=self.seed,
            matvec_backend=self.matvec_backend,
            setup_mode=self.setup_mode,
            setup_bucket_floor=self.setup_bucket_floor,
            elim_sizing=self.elim_sizing,
            setup_ell_sweeps=self.setup_ell_sweeps)

    def cycle_config(self) -> CycleConfig:
        """The core-layer cycle/smoother configuration this maps to."""
        return CycleConfig(
            kind=self.cycle,
            smoother=SmootherConfig(
                kind=self.smoother,
                pre_sweeps=self.pre_sweeps,
                post_sweeps=self.post_sweeps,
                cheby_degree=self.cheby_degree))


# Fields the port keeps for parity with the reference but whose layers it
# does not have yet: only their defaults are accepted.
_UNPORTED = {
    "guard_mode": "the distributed scan solve (ROADMAP A11)",
    "dist_nnz_threshold": "the distributed backend (ROADMAP A11)",
    "max_dist_levels": "the distributed backend (ROADMAP A11)",
}
_DEFAULTS = {f.name: f.default for f in dataclasses.fields(SolverOptions)}
