"""Launchers of the port (``repro.launch``'s counterpart): the LM training
driver (``python -m repro_torch.launch.train``) and the multi-chip
dry-run (``python -m repro_torch.launch.dryrun``) with its production
meshes (``launch.mesh``) and cost report (``launch.cost``, in place of
the reference's ``hlo_cost`` and ``hlo_analysis``).

The names below load their module on first use, so that ``python -m``
runs a module that this package has not imported yet.
"""

import importlib

_NAMES = {
    "cost": ("CostCounter", "Roofline", "analyse", "count", "fake_mode"),
    "dryrun": ("cell_record", "local_shape", "materialize", "run_cell",
               "trace"),
    "mesh": ("HBM_BW", "LINK_BW", "PEAK_FLOPS_BF16", "fake_world",
             "make_production_mesh", "make_test_mesh", "process_mesh_of",
             "start_fake_world"),
}
_WHERE = {name: mod for mod, names in _NAMES.items() for name in names}

__all__ = sorted(_WHERE)


def __getattr__(name):
    if name not in _WHERE:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_WHERE[name]}"),
                   name)
