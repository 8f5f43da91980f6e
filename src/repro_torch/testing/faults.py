"""Deterministic, seeded fault injection at named pipeline sites (torch
port of ``repro.testing.faults``).

Production code calls :func:`site` (corrupt an array) or
:func:`checkpoint` (raise) at named locations, and a test arms a
:class:`FaultPlan` around the code under test::

    from repro_torch.testing import Fault, FaultPlan, inject

    plan = FaultPlan({"solve.spmv": Fault(mode="nan", at_calls=(2,))})
    with inject(plan):
        x, result = solver.solve(b)          # breaks at PCG iteration 2
    assert result.status == "degraded"       # ... and recovers
    assert plan.fired                        # the fault actually fired

With no plan armed (the production default) every hook is a single global
``None`` check: no copy, no device sync.

Corruption is **deterministic**: the corrupted entries are drawn from
``numpy.random.default_rng((plan.seed, hash(name) & 0x7FFFFFFF, call))``
exactly as the reference draws them, so one plan armed on both packages
in one process corrupts the same entries of arrays of the same shape.
An armed site given a tensor copies it to the host, corrupts it there and
copies it back with its dtype and device.

The sites, their modes and ``KILL_EXIT_CODE`` are the reference's. The
traced ``dist.*`` / ``sdc.shard_payload`` sites belong to the distributed
solver, which the port does not have yet (ROADMAP A11): their hooks
(:func:`site_traced`, :meth:`FaultPlan.apply_traced`,
:func:`trace_token`) raise ``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np

TRACED_SITES = (
    "dist.select",
    "dist.vote",
    "dist.spmv",
    "dist.psum",
    "sdc.shard_payload",
)

SITES = (
    "setup.build",
    "setup.coarse_inv",
    "setup.lambda_max",
    "solve.spmv",
    "solve.precond",
    "solve.residual",
    "service.request",
    "service.setup",
    "service.solve",
    "sdc.edge_weights",
) + TRACED_SITES

_MODES = ("nan", "inf", "huge", "zero", "negate", "bitflip", "perturb",
          "raise", "kill")

# exit code of a mode="kill" fault — tests assert on it so an unrelated
# crash can't masquerade as the injected kill
KILL_EXIT_CODE = 43

_NO_DIST = ("traced fault sites belong to the distributed solver, which "
            "the port does not have yet (ROADMAP A11)")


class InjectedFault(RuntimeError):
    """Raised by an armed ``mode="raise"`` fault at a checkpoint site."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One site's corruption policy.

    * ``mode`` — ``"nan"`` / ``"inf"`` / ``"huge"`` (×1e30) / ``"zero"`` /
      ``"negate"`` corrupt array sites; ``"bitflip"`` (seeded ×2**±64)
      and ``"perturb"`` (seeded ×(1 ± 0.5)) are the *silent* SDC modes;
      ``"raise"`` raises :class:`InjectedFault`; ``"kill"`` ends the
      process with :data:`KILL_EXIT_CODE`.
    * ``at_calls`` — per-site call indices (0-based) at which the fault
      fires; ``None`` fires on every call.
    * ``fraction`` — fraction of array entries corrupted (at least one),
      chosen by the seeded RNG.
    """

    mode: str = "nan"
    at_calls: tuple | None = (0,)
    fraction: float = 0.05

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, "
                             f"got {self.mode!r}")
        if not 0.0 < self.fraction <= 1.0:
            raise ValueError(f"fraction must be in (0, 1], "
                             f"got {self.fraction}")


def _to_host(x) -> np.ndarray:
    """A writable host copy of ``x`` (a tensor, array or scalar)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy().copy()
    return np.array(x, copy=True)


def _like(out: np.ndarray, x):
    """``out`` back in ``x``'s container, dtype and device."""
    if hasattr(x, "detach"):
        import torch

        return torch.as_tensor(out, dtype=x.dtype, device=x.device)
    return out.astype(np.asarray(x).dtype, copy=False)


class FaultPlan:
    """A seeded set of site faults plus the record of what fired.

    ``counts`` tracks per-site call counts (every pass through a site,
    fired or not); ``fired`` is the ordered list of ``(site, call_index,
    mode)`` events.
    """

    def __init__(self, faults: dict, seed: int = 0):
        for name, f in faults.items():
            if not isinstance(f, Fault):
                raise TypeError(f"site {name!r}: expected a Fault, "
                                f"got {type(f).__name__}")
        self.faults = dict(faults)
        self.seed = int(seed)
        self.counts: dict = {}
        self.fired: list = []

    def _armed(self, name: str) -> Fault | None:
        idx = self.counts.get(name, 0)
        self.counts[name] = idx + 1
        f = self.faults.get(name)
        if f is None:
            return None
        if f.at_calls is not None and idx not in f.at_calls:
            return None
        self.fired.append((name, idx, f.mode))
        return f

    def apply(self, name: str, x):
        """Corrupt ``x`` if a fault is armed for this call of ``name``."""
        f = self._armed(name)
        if f is None:
            return x
        if f.mode == "raise":
            raise InjectedFault(f"injected failure at site {name!r} "
                                f"(call {self.counts[name] - 1})")
        if f.mode == "kill":                       # pragma: no cover
            os._exit(KILL_EXIT_CODE)
        arr = _to_host(x)
        if arr.dtype.kind not in "fc":
            arr = arr.astype(np.float64)
        flat = arr.reshape(-1)
        rng = np.random.default_rng(
            (self.seed, hash(name) & 0x7FFFFFFF, self.counts[name] - 1))
        m = max(1, int(round(f.fraction * flat.size)))
        idx = rng.choice(flat.size, size=min(m, flat.size), replace=False)
        if f.mode == "nan":
            flat[idx] = np.nan
        elif f.mode == "inf":
            flat[idx] = np.inf
        elif f.mode == "huge":
            flat[idx] = flat[idx] * 1e30 + 1e30
        elif f.mode == "zero":
            flat[idx] = 0.0
        elif f.mode == "negate":
            flat[idx] = -flat[idx]
        elif f.mode == "bitflip":
            flat[idx] = flat[idx] * np.exp2(64.0 * rng.choice(
                (-1.0, 1.0), idx.size))
        elif f.mode == "perturb":
            flat[idx] = flat[idx] * (1.0 + 0.5 * rng.choice(
                (-1.0, 1.0), idx.size))
        return _like(flat.reshape(arr.shape), x)

    def check(self, name: str) -> None:
        """Raise :class:`InjectedFault` if a raising fault is armed."""
        f = self._armed(name)
        if f is not None:
            if f.mode == "kill":                   # pragma: no cover
                os._exit(KILL_EXIT_CODE)
            raise InjectedFault(f"injected failure at site {name!r} "
                                f"(call {self.counts[name] - 1})")

    def apply_traced(self, name: str, x, axis_index=None, n_shards=None):
        """The distributed solver's in-program corruption (ROADMAP A11)."""
        raise NotImplementedError(_NO_DIST)

    def wants_traced(self) -> bool:
        """True if the plan arms any trace-time (``dist.*``) site."""
        return any(name in TRACED_SITES for name in self.faults)


# ----------------------------------------------------------------------
_ACTIVE: FaultPlan | None = None


def active() -> FaultPlan | None:
    """The currently armed plan, or None (production)."""
    return _ACTIVE


@contextlib.contextmanager
def inject(plan: FaultPlan):
    """Arm ``plan`` for the duration of the block (not reentrant)."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a FaultPlan is already armed")
    _ACTIVE = plan
    try:
        yield plan
    finally:
        _ACTIVE = None


def site(name: str, x):
    """Hook: return ``x``, corrupted iff a fault is armed for ``name``."""
    if _ACTIVE is None:
        return x
    return _ACTIVE.apply(name, x)


def checkpoint(name: str) -> None:
    """Hook: raise :class:`InjectedFault` iff a raising fault is armed."""
    if _ACTIVE is not None:
        _ACTIVE.check(name)


def site_traced(name: str, x, axis_index=None, n_shards=None):
    """The distributed solver's traced hook (ROADMAP A11)."""
    raise NotImplementedError(_NO_DIST)


def trace_token():
    """The distributed solver's cache-key token (ROADMAP A11)."""
    raise NotImplementedError(_NO_DIST)
