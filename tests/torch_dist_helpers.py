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


# optim.compress on a 2×2 world: each rank's inputs, from one seed
COMPRESS_SEED = 17


def compress_inputs(seed, world_size):
    """Per rank: x (for compressed_psum), g and residual (for
    ef_compress_grad), float32 numpy."""
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=(6, 5)).astype(np.float32) * (r + 1)
          for r in range(world_size)]
    gs = [rng.normal(size=(6, 5)).astype(np.float32)
          for _ in range(world_size)]
    rs = [rng.normal(size=(6, 5)).astype(np.float32) * 0.01
          for _ in range(world_size)]
    return xs, gs, rs


def compress_body(rank, world_size, seed):
    """``compressed_psum`` and ``ef_compress_grad`` over each axis of a 2×2
    CPU mesh; returns ``{axis: {psum, ef, residual, calls}}``."""
    from repro_torch.optim.compress import compressed_psum, ef_compress_grad

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    xs, gs, rs = compress_inputs(seed, world_size)
    out = {}
    for axis in ("data", "model"):
        mesh.reset_stats()
        psum = compressed_psum(torch.from_numpy(xs[rank]), mesh, axis)
        ef, residual = ef_compress_grad(torch.from_numpy(gs[rank]),
                                        torch.from_numpy(rs[rank]), mesh,
                                        axis)
        out[axis] = dict(psum=psum.numpy(), ef=ef.numpy(),
                         residual=residual.numpy(),
                         calls=mesh.stats()["calls"])
    return out


# ----------------------------------------------------------------------
# The dry-run's 2×2 world (tests/test_torch_dryrun.py)
# ----------------------------------------------------------------------

BA500 = (500, 3, 0)             # n, m, seed: tests/test_configs_smoke.py
SOLVE_ITERS = 6


def lm_smoke_inputs():
    """qwen2-0.5b's SMOKE config, its weights (seed 0) and tokens [4, 17]
    (seed 1): 7 heads, which do not divide a "model" axis of 2."""
    from repro_torch.configs.qwen2_0p5b import SMOKE
    from repro_torch.models.transformer import init_params

    params = init_params(SMOKE, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, SMOKE.vocab, (4, 17),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    return SMOKE, params, toks


def lm_step_loss(mesh):
    """The SMOKE train step's loss: under ``make_lm_plan(mesh)`` with every
    input this rank's shard (a DeviceMesh), or with the null plan (None)."""
    from repro_torch.configs.lm_common import lm_train_step
    from repro_torch.models.sharding import (NamedSharding, distribute,
                                             make_lm_plan, null_plan)
    from repro_torch.models.transformer import param_specs
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.tree import tree_map

    cfg, params, toks = lm_smoke_inputs()
    plan = null_plan() if mesh is None else make_lm_plan(mesh)
    if mesh is not None:
        params = tree_map(lambda t, sp: distribute(t, NamedSharding(mesh, sp)),
                          params, param_specs(cfg, plan))
        toks = distribute(toks, plan.named("tokens"))
    step = lm_train_step(cfg, plan, AdamWConfig())
    _, _, metrics = step(params, adamw_init(params), toks)
    loss = metrics["loss"]
    return float(loss.full_tensor() if mesh is not None else loss)


def solve_case_stats(mesh) -> dict:
    """This rank's collective calls and bytes for ``build_solve_step`` on
    BA 500 over ``mesh`` (a DeviceMesh of the default group)."""
    from repro_torch.configs.laplacian_solver import solve_case
    from repro_torch.core.hierarchy import SetupConfig

    case = solve_case("ba500", ba(*BA500), mesh, SetupConfig(coarsest_size=32),
                      dist_nnz_threshold=64, max_dist_levels=2,
                      n_iters=SOLVE_ITERS)
    args = case.make_inputs(case.args)
    case.process_mesh.reset_stats()
    x, norms = case.fn(*args)
    return case.process_mesh.stats() | dict(norms=len(norms))


def dryrun_rank_body(rank, world_size):
    """A 2×2 gloo world: the SMOKE LM step's loss under the LM plan, and
    the solver's collectives of ``build_solve_step``."""
    from torch.distributed.device_mesh import DeviceMesh

    mesh = DeviceMesh("cpu", torch.arange(world_size).reshape(2, 2),
                      mesh_dim_names=("data", "model"))
    return dict(loss=lm_step_loss(mesh), solve=solve_case_stats(mesh))
