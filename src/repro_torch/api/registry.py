"""Backend registry: names -> solver implementations (torch port of
``repro.api.registry``).

Built-in backends (registered by ``repro_torch.api.backends``):

* ``"single"``     — single-device multigrid PCG (``LaplacianSolver``),
* ``"serial_ref"`` — the serial LAMG-style reference setup
  (``repro_torch.core.serial_ref``),
* ``"dist"``       — the 2D-distributed solver on a process mesh
  (``repro_torch.dist``),
* ``"auto"``       — resolves to ``"dist"`` when a mesh is passed or more
  than one CUDA device is visible, else ``"single"``.

A backend is a callable ``(problem, options, mesh) -> handle`` where the
handle implements ``solve_block(B, tol, max_iters) -> (X, norms,
iters_per_rhs[, statuses])`` plus a ``work_per_iteration`` attribute and a
``stats()`` method; third-party backends register with
:func:`register_backend`.
"""

from __future__ import annotations

from typing import Callable

_REGISTRY: dict[str, Callable] = {}


def register_backend(name: str, setup_fn: Callable) -> None:
    """Register ``setup_fn(problem, options, mesh) -> handle`` under ``name``."""
    if name == "auto":
        raise ValueError('"auto" is reserved for backend resolution')
    _REGISTRY[name] = setup_fn


def available_backends() -> tuple[str, ...]:
    """Registered backend names (plus the ``"auto"`` selector)."""
    return tuple(sorted(_REGISTRY)) + ("auto",)


def get_backend(name: str) -> Callable:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown backend {name!r}; available: "
            f"{', '.join(available_backends())}") from None


def resolve_backend(name: str = "auto", mesh=None, options=None) -> str:
    """Resolve ``"auto"`` to a concrete backend name, by the reference's
    rule: ``"dist"`` when ``mesh`` is passed or more than one CUDA device
    is visible, else ``"single"``; ``precondition=False`` (which the dist
    backend lacks) resolves to ``"single"`` unless a mesh forces dist.
    Explicit names pass through after checking they exist."""
    if name != "auto":
        get_backend(name)
        return name
    if mesh is not None:
        return "dist"
    if options is not None and not options.precondition:
        return "single"
    import torch

    return "dist" if torch.cuda.device_count() > 1 else "single"
