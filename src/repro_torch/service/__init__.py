"""``repro_torch.service`` — solver-as-a-service over the
``repro_torch.api`` facade (torch port of ``repro.service``).

The paper's setup phase is the expensive part of unsmoothed aggregation;
this layer amortizes it across a *stream* of problems the way LAMG
amortizes one hierarchy across many right-hand sides: pending setups are
grouped by capacity-bucket signature into batched super-step setups,
finished hierarchies live in a content-addressed
:class:`~repro_torch.api.cache.HierarchyCache`, and same-hierarchy
requests ride one blocked multi-RHS PCG solve.

    from repro_torch.service import SolverService

    svc = SolverService()                        # runs on the CUDA card
    t1 = svc.submit(problem_a, b1)
    t2 = svc.submit(problem_a, b2, tol=1e-6)     # same hierarchy as t1
    t3 = svc.submit(problem_b, b3)               # same bucket: batched setup
    svc.flush()                                  # deterministic, synchronous
    x1, result1 = t1.result()

``benchmarks/port_service.py`` measures it on the card.
"""

from repro_torch.service.service import ServiceError, SolverService, Ticket

__all__ = ["ServiceError", "SolverService", "Ticket"]
