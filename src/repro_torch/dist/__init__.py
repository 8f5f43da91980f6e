"""Distributed-memory layer on ``torch.distributed``: the paper's 2D
sparse-matrix distribution (torch port of ``repro.dist``).

* ``repro_torch.dist.mesh``      — process meshes over a process group
  (the counterpart of ``jax.make_mesh``), ``init_world`` (a world of one)
  and ``run_world`` (N spawned ranks on this host).
* ``repro_torch.dist.partition`` — host-side 2D block partition of an
  edge list (paper §2.1–§2.2), with the random-ordering load balancing.
* ``repro_torch.dist.setup``     — Alg 1 selection and Alg 2 voting as
  all-reduced semiring SpMVs that bit-match the single-device versions,
  and the distributed super-step setup
  (``build_hierarchy_superstep_dist``).
* ``repro_torch.dist.solver``    — ``DistLaplacianSolver``: PCG + V-cycle
  with the SpMV of the top hierarchy levels 2D-distributed over the mesh.
"""

from repro_torch.dist.mesh import (ProcessMesh, factor_grid, init_world,
                                   make_mesh, run_world)
from repro_torch.dist.partition import (EllBlocks, Partition2D,
                                        balance_report,
                                        ell_blocks_from_partition,
                                        pad_vector, partition_edges_2d,
                                        unpad_vector)
from repro_torch.dist.setup import (DistSuperstepBuilders,
                                    build_hierarchy_superstep_dist,
                                    distributed_aggregate,
                                    distributed_select_eliminated,
                                    distributed_unweighted_degrees,
                                    distributed_vote_round,
                                    edge_block_counts)
from repro_torch.dist.solver import (DistGraphLevel, DistLaplacianSolver,
                                     DistLevelMeta)

__all__ = [
    "DistGraphLevel",
    "DistLaplacianSolver",
    "DistLevelMeta",
    "DistSuperstepBuilders",
    "EllBlocks",
    "Partition2D",
    "ProcessMesh",
    "balance_report",
    "build_hierarchy_superstep_dist",
    "distributed_aggregate",
    "distributed_select_eliminated",
    "distributed_unweighted_degrees",
    "distributed_vote_round",
    "edge_block_counts",
    "ell_blocks_from_partition",
    "factor_grid",
    "init_world",
    "make_mesh",
    "pad_vector",
    "partition_edges_2d",
    "run_world",
    "unpad_vector",
]
