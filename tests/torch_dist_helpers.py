"""Helpers of the port's distributed tests (``tests/test_torch_dist*.py``):
a world of one in the test process, and the body that every rank of a
spawned 4-rank gloo world runs (``repro_torch.dist.run_world`` imports it
by module path, so it lives here and not in a test file, which would
import JAX in every rank)."""

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.dist import init_world, make_mesh


@contextlib.contextmanager
def world_of_one():
    """A 1×1 gloo mesh on the CPU: the process's default group if one of
    size 1 exists already (left as it is), else a new world of one,
    destroyed on exit."""
    if dist.is_initialized():
        if dist.get_world_size() != 1:
            raise RuntimeError("the test process is in a world of "
                               f"{dist.get_world_size()} ranks")
        yield make_mesh((1, 1), ("data", "model"), device="cpu")
        return
    mesh = init_world("cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def ba(n, m, seed):
    from repro_torch.graphs.generators import barabasi_albert, ensure_connected

    return ensure_connected(*barabasi_albert(n, m=m, seed=seed,
                                             weighted=True))


def mean_free(seed, n, k=None):
    b = np.random.default_rng(seed).normal(size=n if k is None else (n, k))
    return (b - b.mean(axis=0)).astype(np.float32)


# each mesh of the 4-rank world with the execution its solve runs
MESHES = {"2x2": ((2, 2), ("data", "model"), "ell"),
          "pod": ((2, 1, 2), ("pod", "data", "model"), "coo")}
SOLVE_KW = dict(dist_nnz_threshold=200, max_dist_levels=2)


def solver_decisions(solver) -> dict:
    """Every integer decision of a distributed solver's hierarchy, as host
    arrays: level kinds and sizes, elimination masks and coarse ids."""
    from repro_torch.core.elimination import EliminationLevel

    out = dict(kinds=[], sizes=[], ids=[])
    for t in solver.arrays.transfers + solver.coarse_h.transfers:
        elim = isinstance(t, EliminationLevel)
        out["kinds"].append("elim" if elim else "agg")
        out["sizes"].append((t.fine.n, t.coarse.n, t.coarse.adj.nnz))
        out["ids"].append((t.elim_mask if elim else t.coarse_id).numpy())
    return out


def hierarchy_bits(obj, path=""):
    """Every tensor of a hierarchy with its path, floats as their int32
    bits, in a fixed order: equal lists mean bitwise-equal hierarchies."""
    import dataclasses

    if isinstance(obj, torch.Tensor):
        t = obj.view(torch.int32) if obj.dtype == torch.float32 else obj
        yield path, t
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from hierarchy_bits(getattr(obj, f.name),
                                      f"{path}.{f.name}")
    elif isinstance(obj, (tuple, list)):
        for i, x in enumerate(obj):
            yield from hierarchy_bits(x, f"{path}[{i}]")


def solve_ba800(mesh, backend: str) -> dict:
    """BA 800 set up and solved on ``mesh``: the decisions of its
    hierarchy (the distributed super-step's), and the solve."""
    from repro_torch.core.hierarchy import SetupConfig
    from repro_torch.dist import DistLaplacianSolver

    n, r, c, v = ba(800, 3, 2)
    s = DistLaplacianSolver.setup(
        n, r, c, v, mesh, SetupConfig(coarsest_size=32,
                                      matvec_backend=backend), **SOLVE_KW)
    X, norms, iters = s.solve_block(mean_free(3, n)[:, None], n_iters=12,
                                    tol=1e-6)
    return dict(decisions=solver_decisions(s), x=X[:, 0].numpy(),
                norms=norms, iters=iters,
                meta=[m.kind for m in s.level_meta])


def rank_body(rank, world_size):
    """What every rank of the 4-rank world runs, for each mesh of
    ``MESHES`` on the same group: the primitives against the port's serial
    selection and vote, and a distributed setup and solve. Returns host
    values for the parent to compare."""
    from repro_torch.core.aggregation import (SEED, UNDECIDED,
                                              AggregationConfig,
                                              aggregation_round)
    from repro_torch.core.elimination import select_eliminated
    from repro_torch.core.graph import graph_from_adjacency
    from repro_torch.dist import (distributed_aggregate,
                                  distributed_select_eliminated,
                                  distributed_vote_round,
                                  partition_edges_2d)
    from repro_torch.graphs.generators import to_laplacian_coo

    out = {}
    n, r, c, v = ba(600, 2, 5)
    level = graph_from_adjacency(to_laplacian_coo(n, r, c, v, device="cpu"))
    cfg = AggregationConfig()
    for name, (shape, axes, backend) in MESHES.items():
        mesh = make_mesh(shape, axes, device="cpu")
        res = dict(coords=mesh.coords, block=mesh.block)
        part = partition_edges_2d(n, r, c, v, mesh.pr, mesh.pc,
                                  pods=mesh.pods, random_ordering=False)
        res["select"] = bool(torch.equal(
            distributed_select_eliminated(mesh, part, n)[:n],
            select_eliminated(level)))
        sq = np.where(part.row_local < part.nb, 1, 0).astype(np.int32)
        state = torch.full((n,), UNDECIDED, dtype=torch.int32)
        votes = torch.zeros(n, dtype=torch.int32)
        aggs = torch.arange(n, dtype=torch.int32)
        want = aggregation_round(level, torch.ones(level.adj.capacity,
                                                   dtype=torch.int32),
                                 state, votes, aggs, cfg)
        got = distributed_vote_round(mesh, part, n, sq, state, votes, aggs,
                                     cfg)
        res["vote"] = all(torch.equal(g[:n], w) for g, w in zip(got, want))
        a_got, _ = distributed_aggregate(mesh, part, n, sq, cfg)
        ones = torch.ones(level.adj.capacity, dtype=torch.int32)
        s_, v_, a_ = state, votes, aggs
        for _ in range(cfg.n_rounds):
            s_, v_, a_ = aggregation_round(level, ones, s_, v_, a_, cfg)
        a_want = torch.where((s_ == UNDECIDED) | (s_ == SEED),
                             torch.arange(n, dtype=torch.int32), a_)
        res["aggregate"] = bool(torch.equal(a_got[:n], a_want))
        res.update(solve_ba800(mesh, backend), stats=mesh.stats())
        out[name] = res
    return out


def fail_on_rank_one(rank, world_size):
    """Rank 1 raises; rank 0 waits in a barrier that never completes."""
    if rank == 1:
        raise ValueError("rank one fails")
    dist.barrier()
