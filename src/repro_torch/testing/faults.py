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
``numpy.random.default_rng((plan.seed, site_key(name), call))``, where
:func:`site_key` is a stable hash of the site name (CRC-32), so a plan
corrupts the same entries in every process whatever ``PYTHONHASHSEED``
is. The reference draws in the same way from ``hash(name) &
0x7FFFFFFF``, which changes from process to process; a test that arms one
plan on both packages makes the reference draw the same entries by
shadowing its module's ``hash`` with :func:`site_key`.
An armed site given a tensor copies it to the host, corrupts it there and
copies it back with its dtype and device.

The sites, their modes and ``KILL_EXIT_CODE`` are the reference's.

**Traced sites** (``dist.select``, ``dist.vote``, ``dist.spmv``,
``dist.psum``, ``sdc.shard_payload``: the distributed solver,
``repro_torch.dist``). In the reference they run at trace time: a site is
drawn once each time a program is traced, its corruption becomes a
constant of that program, applied on every execution, and
``counts[name]`` advances once per trace. The port runs eagerly, so it
names its programs' *builds* explicitly: a :class:`TracedBuild` is one
program of the distributed solver (a registry entry of the distributed
setup, a new one under each :func:`trace_token`; an init or chunk
program of the blocked solve, a new one for each solve while a token is
armed). A build's body runs as *passes* (:meth:`TracedBuild.run`: one
round of the vote, one selection, the init, one PCG step). The *k*-th time a pass
reaches a site draws that site for the build, on the first pass that gets
there; every later pass replays the same draw. So a site draws once per
build and call site, as in the reference: the blocked solve's matvec and
preconditioner run once a pass on the whole block, as the reference's
vmapped ones do, so a site inside them draws once a pass (on the block's
``[n_pad, k]`` shape). A traced site
reached outside any build draws on every call, like :func:`site`. With
one shard index the corruption hits only the seeded shard
(``axis_index == target``); every rank draws the same target.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import zlib

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


def site_key(name: str) -> int:
    """The stable 31-bit key of a site name in the draws' seed: its
    CRC-32, the same in every process (``hash`` of a ``str`` is not)."""
    return zlib.crc32(name.encode()) & 0x7FFFFFFF


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


@dataclasses.dataclass(frozen=True)
class _TracedDraw:
    """One traced site's drawn corruption: the flat entry indices, the
    bitflip/perturb factors of a float tensor, and the one bad shard."""

    mode: str
    idx: np.ndarray
    factor: np.ndarray | None
    target: int | None


def _apply_draw(d: _TracedDraw | None, x, axis_index):
    """``x`` with the drawn corruption (a new tensor), or ``x`` itself
    where nothing fires or another shard is the target."""
    import torch

    if d is None or (d.target is not None and axis_index != d.target):
        return x
    flat = x.reshape(-1).clone()
    idx = torch.as_tensor(d.idx, device=x.device)
    if x.is_floating_point():
        if d.mode == "nan":
            flat[idx] = float("nan")
        elif d.mode == "inf":
            flat[idx] = float("inf")
        elif d.mode == "huge":
            flat[idx] = flat[idx] * 1e30 + 1e30
        elif d.mode == "zero":
            flat[idx] = 0.0
        elif d.mode in ("bitflip", "perturb"):
            flat[idx] = flat[idx] * torch.as_tensor(
                d.factor, dtype=x.dtype, device=x.device)
        else:                                      # negate
            flat[idx] = -flat[idx]
    else:
        # integer semiring lanes can't hold NaN/Inf: write the dtype's
        # extreme sentinel (a maximally wrong key) instead
        info = torch.iinfo(x.dtype)
        if d.mode in ("nan", "inf", "huge"):
            flat[idx] = info.max
        elif d.mode == "zero":
            flat[idx] = 0
        elif d.mode == "bitflip":
            flat[idx] = flat[idx] ^ (1 << (info.bits - 2))
        elif d.mode == "perturb":
            flat[idx] = flat[idx] + 1
        else:                                      # negate
            flat[idx] = -flat[idx]
    return flat.reshape(x.shape)


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
            (self.seed, site_key(name), self.counts[name] - 1))
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

    def draw_traced(self, name: str, x, n_shards=None):
        """Draw a traced site's corruption for tensor ``x`` (its shape and
        dtype): the reference's draws, in its order. Returns None where
        nothing fires. Advances ``counts[name]`` once."""
        f = self._armed(name)
        if f is None:
            return None
        if f.mode == "raise":
            raise InjectedFault(f"injected failure at traced site {name!r} "
                                f"(trace {self.counts[name] - 1})")
        if f.mode == "kill":                       # pragma: no cover
            os._exit(KILL_EXIT_CODE)
        size = x.numel()
        if size == 0:
            return None
        rng = np.random.default_rng(
            (self.seed, site_key(name), self.counts[name] - 1))
        m = max(1, int(round(f.fraction * size)))
        idx = rng.choice(size, size=min(m, size), replace=False)
        factor = None
        if x.is_floating_point():
            if f.mode == "bitflip":
                factor = np.exp2(64.0 * rng.choice((-1.0, 1.0), idx.size))
            elif f.mode == "perturb":
                factor = 1.0 + 0.5 * rng.choice((-1.0, 1.0), idx.size)
        target = None if n_shards is None else int(rng.integers(int(n_shards)))
        return _TracedDraw(f.mode, idx, factor, target)

    def apply_traced(self, name: str, x, axis_index=None, n_shards=None):
        """Draw and apply a traced site to tensor ``x`` (a build of its
        own). With ``axis_index``/``n_shards`` only the seeded shard's ``x``
        is corrupted."""
        draw = self.draw_traced(name, x,
                                None if axis_index is None else n_shards)
        return _apply_draw(draw, x, axis_index)

    def wants_traced(self) -> bool:
        """True if the plan arms any trace-time (``dist.*``) site."""
        return any(name in TRACED_SITES for name in self.faults)


# ----------------------------------------------------------------------
_ACTIVE: FaultPlan | None = None
_BUILD: "TracedBuild | None" = None       # the build whose pass is running
_TRACE_TOKENS = itertools.count(1)


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
    """Traced hook: corrupt tensor ``x`` iff a fault is armed for ``name``.

    With no plan armed (production) this is the same single global
    ``None`` check as :func:`site` and returns ``x`` untouched. Inside a
    pass of a :class:`TracedBuild` the build's draw for this call site is
    applied; elsewhere the site draws now. ``axis_index`` (this rank's
    linear shard index) and ``n_shards`` restrict the corruption to one
    seeded shard.
    """
    if _ACTIVE is None:
        return x
    if _BUILD is not None:
        return _BUILD.site(_ACTIVE, name, x, axis_index, n_shards)
    return _ACTIVE.apply_traced(name, x, axis_index=axis_index,
                                n_shards=n_shards)


def trace_token():
    """Cache-key token isolating fault-armed builds from clean programs.

    ``None`` when no plan is armed or the armed plan has no traced sites:
    cached clean programs stay valid. While a plan *with* traced sites is
    armed, every call returns a fresh unique token: a key holding it never
    reuses a cached clean program, never poisons the cache, and every such
    program is a new build whose sites draw anew.
    """
    if _ACTIVE is None or not _ACTIVE.wants_traced():
        return None
    return next(_TRACE_TOKENS)


class TracedBuild:
    """One build of a program with traced sites (see the module
    docstring): the draws of its call sites, made on the first pass that
    reaches each and replayed by every later pass."""

    def __init__(self):
        self._draws: dict = {}
        self._pos: dict = {}

    def run(self):
        """Context manager for one pass of the build's body; a no-op with
        no plan armed."""
        if _ACTIVE is None:
            return contextlib.nullcontext()
        return self._pass()

    @contextlib.contextmanager
    def _pass(self):
        global _BUILD
        prev, _BUILD = _BUILD, self
        self._pos = {}
        try:
            yield
        finally:
            _BUILD = prev

    def site(self, plan: FaultPlan, name: str, x, axis_index, n_shards):
        k = self._pos.get(name, 0)
        self._pos[name] = k + 1
        key = (name, k)
        if key not in self._draws:
            self._draws[key] = plan.draw_traced(
                name, x, None if axis_index is None else n_shards)
        return _apply_draw(self._draws[key], x, axis_index)
