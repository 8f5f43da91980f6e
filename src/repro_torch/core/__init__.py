"""Multigrid core: levels, setup, smoothers, cycles, PCG and the paper's
baselines (the reference's ``repro.core`` exports, where ported)."""

from repro_torch.core.graph import GraphLevel, graph_from_adjacency, hash32
from repro_torch.core.elimination import (EliminationLevel, select_eliminated,
                                          build_elimination_level,
                                          eliminate_low_degree)
from repro_torch.core.aggregation import (AggregationConfig, aggregate,
                                          renumber_aggregates)
from repro_torch.core.coarsen import AggregationLevel, contract
from repro_torch.core.strength import (algebraic_distance_strength,
                                       affinity_strength, STRENGTH_METRICS)
from repro_torch.core.smoothers import SmootherConfig, jacobi, chebyshev
from repro_torch.core.cycles import CycleConfig
from repro_torch.core.hierarchy import (Hierarchy, SetupConfig,
                                        build_hierarchy, apply_cycle)
from repro_torch.core.krylov import (BlockSolveInfo, pcg, pcg_block,
                                     pcg_scanned, cg, jacobi_pcg)
from repro_torch.core.solver import LaplacianSolver, LaplacianSolveInfo
from repro_torch.core.wda import wda, pcg_iteration_work, cycle_work_units

__all__ = [
    "GraphLevel", "graph_from_adjacency", "hash32",
    "EliminationLevel", "select_eliminated", "build_elimination_level",
    "eliminate_low_degree",
    "AggregationConfig", "aggregate", "renumber_aggregates",
    "AggregationLevel", "contract",
    "algebraic_distance_strength", "affinity_strength", "STRENGTH_METRICS",
    "SmootherConfig", "jacobi", "chebyshev",
    "CycleConfig",
    "Hierarchy", "SetupConfig", "build_hierarchy", "apply_cycle",
    "BlockSolveInfo", "pcg", "pcg_block", "pcg_scanned", "cg", "jacobi_pcg",
    "LaplacianSolver", "LaplacianSolveInfo",
    "wda", "pcg_iteration_work", "cycle_work_units",
]
