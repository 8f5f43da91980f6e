"""``repro_torch.testing`` — deterministic fault injection for robustness
tests. See :mod:`repro_torch.testing.faults`."""

from repro_torch.testing.faults import (Fault, FaultPlan, InjectedFault,
                                        KILL_EXIT_CODE, SITES, TRACED_SITES,
                                        TracedBuild, active, checkpoint,
                                        inject, site, site_traced,
                                        trace_token)

__all__ = [
    "Fault",
    "FaultPlan",
    "InjectedFault",
    "KILL_EXIT_CODE",
    "SITES",
    "TRACED_SITES",
    "TracedBuild",
    "active",
    "checkpoint",
    "inject",
    "site",
    "site_traced",
    "trace_token",
]
