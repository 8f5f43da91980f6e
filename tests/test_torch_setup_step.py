"""The port's super-step setup (``repro_torch.core.setup_step``).

Held against the reference's super-step setup on the graphs of
``tests/test_setup_batch.py`` (a 16x16 grid and Barabási–Albert n = 300,
m = 3, ``coarsest_size=32``), made with numpy from a seed and fed to both
packages: the same levels, bit-exact integer arrays, the same PCG
iteration counts and ``x`` within rtol 1e-5 (the tolerance of
``tests/test_matvec.py``). Float level arrays agree within rtol 1e-6, not
bitwise: inside the reference's scanned strength sweep XLA's CPU division
is not correctly rounded (ROADMAP C1), and its float sums may add in
another order than the port's sorted segment sums. Within the port, the
super-step equals the eager loop (bitwise residual histories) and batched
builds equal looped ones, tensor by tensor. Then the registry and sync
counters, the two ingest paths, ``renumber_device(n_valid=)``, the
configuration checks, and the primitives that no longer make the host wait
(bitwise against the implementations they replaced).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the tensors here are small, and a pool in each
# test process oversubscribes the cores when test files run in parallel
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import aggregation as jagg  # noqa: E402
from repro.core.coarsen import AggregationLevel as JAgg  # noqa: E402
from repro.core.hierarchy import SetupConfig as JConfig  # noqa: E402
from repro.core.solver import LaplacianSolver as JSolver  # noqa: E402
from repro.graphs.generators import (barabasi_albert,  # noqa: E402
                                     ensure_connected, grid_2d)
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import coarsen as tcoarsen  # noqa: E402
from repro_torch.core import elimination as telim  # noqa: E402
from repro_torch.core import setup_step as ss  # noqa: E402
from repro_torch.core import smoothers as tsmooth  # noqa: E402
from repro_torch.core import strength as tstrength  # noqa: E402
from repro_torch.core.coarsen import AggregationLevel  # noqa: E402
from repro_torch.core.graph import (GraphLevel,  # noqa: E402
                                    graph_from_adjacency, pow2_bucket)
from repro_torch.core.hierarchy import (SetupConfig,  # noqa: E402
                                        build_hierarchy,
                                        build_hierarchy_batch,
                                        build_hierarchy_eager,
                                        hierarchy_stats)
from repro_torch.core.prng import normal, uniform  # noqa: E402
from repro_torch.core.solver import LaplacianSolver  # noqa: E402
from repro_torch.graphs.generators import to_laplacian_coo  # noqa: E402
from repro_torch.sparse import ell as tell  # noqa: E402
from repro_torch.sparse.coo import COO, sort_key  # noqa: E402
from repro_torch.sparse.segment import _seg_ids, segment_sum  # noqa: E402

CFG = SetupConfig(coarsest_size=32)
CFG_FLOOR = dataclasses.replace(CFG, setup_bucket_floor=2048)
GRAPHS = ("grid_2d", "barabasi_albert")


def _graph(name, seed=0):
    if name == "grid_2d":
        return ensure_connected(*grid_2d(16, 16, weighted=True, seed=seed))
    return ensure_connected(*barabasi_albert(300, m=3, seed=seed,
                                             weighted=True))


def _adj(name, seed=0):
    n, r, c, v = _graph(name, seed)
    return to_laplacian_coo(n, r, c, v, device="cpu")


def _rhs(n):
    b = np.random.default_rng(7).normal(size=n).astype(np.float32)
    return b - b.mean()


def _sig(h):
    return [(r["kind"], r["n"], r["nnz"])
            for r in hierarchy_stats(h)["levels"]]


def _leaves(obj):
    """Every tensor of a port hierarchy, in a fixed order, with its path."""
    if isinstance(obj, torch.Tensor):
        yield "", obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            for path, t in _leaves(getattr(obj, f.name)):
                yield f".{f.name}{path}", t
    elif isinstance(obj, (tuple, list)):
        for i, x in enumerate(obj):
            for path, t in _leaves(x):
                yield f"[{i}]{path}", t


def _bits(t):
    t = t.reshape(-1)
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_bitwise(ha, hb):
    la, lb = list(_leaves(ha)), list(_leaves(hb))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert torch.equal(_bits(x), _bits(y)), path


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.fixture(scope="module", params=GRAPHS)
def built(request):
    """One reference super-step solver, one port super-step solver and one
    port eager solver per graph, with each one's solve of the same rhs."""
    n, r, c, v = _graph(request.param)
    b = _rhs(n)
    ref = JSolver.setup(n, r, c, v, JConfig(coarsest_size=32))
    port = LaplacianSolver.setup(n, r, c, v, CFG, device="cpu")
    eager = LaplacianSolver.setup(
        n, r, c, v, dataclasses.replace(CFG, setup_mode="eager"),
        device="cpu")
    out = dict(ref=ref, port=port, eager=eager)
    for name, s in list(out.items()):
        x, info = s.solve(b, tol=1e-8)
        out[f"{name}_x"], out[f"{name}_info"] = np.asarray(x), info
    return out


# ----------------------------------------------------------------------------
# Port super-step vs reference super-step, and vs the port's eager loop
# ----------------------------------------------------------------------------

def test_levels_match_reference(built):
    keys = ("kind", "n", "nnz", "capacity")
    assert [{k: r[k] for k in keys} for r in built["port"].stats()["levels"]] \
        == [{k: r[k] for k in keys} for r in built["ref"].stats()["levels"]]


def test_integer_arrays_bit_exact(built):
    pairs = zip(built["port"].hierarchy.transfers,
                built["ref"].hierarchy.transfers)
    for i, (tt, jt) in enumerate(pairs):
        assert isinstance(tt, AggregationLevel) == isinstance(jt, JAgg)
        if isinstance(jt, JAgg):
            names = ("coarse_id",)
        else:
            names = ("elim_mask", "c_index", "f_index", "f_vertices")
            for f in ("row", "col"):
                np.testing.assert_array_equal(
                    _np(getattr(tt.p_f, f)), np.asarray(getattr(jt.p_f, f)))
        for name in names:
            np.testing.assert_array_equal(_np(getattr(tt, name)),
                                          np.asarray(getattr(jt, name)),
                                          f"level {i} {name}")
        for f in ("row", "col"):
            np.testing.assert_array_equal(_np(getattr(tt.coarse.adj, f)),
                                          np.asarray(getattr(jt.coarse.adj,
                                                             f)))


def test_float_arrays_close(built):
    pairs = zip(built["port"].hierarchy.transfers,
                built["ref"].hierarchy.transfers)
    for tt, jt in pairs:
        for got, want in ((tt.coarse.adj.val, jt.coarse.adj.val),
                          (tt.coarse.deg, jt.coarse.deg)):
            np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6)
        if not isinstance(jt, JAgg):
            np.testing.assert_allclose(_np(tt.p_f.val), np.asarray(jt.p_f.val),
                                       rtol=1e-6)
            np.testing.assert_allclose(_np(tt.inv_deg_f),
                                       np.asarray(jt.inv_deg_f), rtol=1e-6)


def test_pcg_matches_reference(built):
    assert built["port_info"].converged
    assert built["port_info"].iters == built["ref_info"].iters
    np.testing.assert_allclose(built["port_x"], built["ref_x"], rtol=1e-5,
                               atol=1e-5)


def test_superstep_matches_port_eager(built):
    assert _sig(built["port"].hierarchy) == _sig(built["eager"].hierarchy)
    assert built["port_info"].iters == built["eager_info"].iters
    assert built["port_info"].residual_norms == \
        built["eager_info"].residual_norms
    np.testing.assert_array_equal(built["port_x"], built["eager_x"])


def test_default_mode_is_superstep(monkeypatch):
    assert SetupConfig().setup_mode == "superstep"
    calls = []
    real = ss.build_hierarchy_superstep
    import repro_torch.core.hierarchy as th

    monkeypatch.setattr(th, "build_hierarchy_superstep",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    th.build_hierarchy(_adj("grid_2d"), CFG)
    assert calls == [1]
    th.build_hierarchy(_adj("grid_2d"), dataclasses.replace(
        CFG, setup_mode="eager"))
    assert calls == [1]


# ----------------------------------------------------------------------------
# Batched vs looped builds, registry reuse and host syncs
# ----------------------------------------------------------------------------

SPECS = [("grid_2d", 0), ("grid_2d", 1), ("barabasi_albert", 0),
         ("barabasi_albert", 1)]


@pytest.fixture(scope="module")
def adjs():
    return [_adj(name, seed) for name, seed in SPECS]


@pytest.fixture(scope="module")
def solo(adjs):
    return [build_hierarchy(a, CFG_FLOOR) for a in adjs]


@pytest.fixture(scope="module")
def batch(adjs):
    return build_hierarchy_batch(adjs, CFG_FLOOR)


def test_batch_bitwise_equals_looped(solo, batch):
    for hs, hb in zip(solo, batch):
        assert _sig(hs) == _sig(hb)
        _assert_bitwise(hs, hb)


def test_batch_of_one_equals_solo(adjs, solo):
    (hb,) = build_hierarchy_batch(adjs[:1], CFG_FLOOR)
    _assert_bitwise(solo[0], hb)


def test_second_batch_adds_no_registry_entries(adjs, batch):
    ss.reset_counters()
    again = build_hierarchy_batch(adjs, CFG_FLOOR)
    steps = ss.counters()["steps"]
    assert any(k.endswith("@batch") for k in steps)
    assert {k: v["compiles"] for k, v in steps.items() if v["compiles"]} \
        == {}
    for hs, hb in zip(batch, again):
        _assert_bitwise(hs, hb)


def test_batch_shares_host_fetches(adjs, batch):
    ss.reset_counters()
    build_hierarchy_batch(adjs, CFG_FLOOR)
    batch_syncs = ss.counters()["host_syncs"]
    ss.reset_counters()
    build_hierarchy(adjs[0], CFG_FLOOR)
    assert batch_syncs <= ss.counters()["host_syncs"] + 4


def test_solver_setup_batch_matches_looped():
    problems = [_graph(name, seed) for name, seed in SPECS[1:3]]
    batched = LaplacianSolver.setup_batch(problems, setup_config=CFG_FLOOR,
                                          device="cpu")
    for (n, r, c, v), sb in zip(problems, batched):
        s = LaplacianSolver.setup(n, r, c, v, CFG_FLOOR, device="cpu")
        assert s.n == sb.n and s.device == sb.device
        np.testing.assert_array_equal(s.perm, sb.perm)
        _assert_bitwise(s.hierarchy, sb.hierarchy)
    assert build_hierarchy_batch([], CFG) == []


def test_eager_batch_loops(adjs):
    cfg = dataclasses.replace(CFG, setup_mode="eager")
    for a, hb in zip(adjs[:2], build_hierarchy_batch(adjs[:2], cfg)):
        _assert_bitwise(build_hierarchy_eager(a, cfg), hb)


def test_second_same_bucket_graph_adds_no_registry_entries():
    ss.clear_cache()
    ss.reset_counters()
    h1 = build_hierarchy(_adj("grid_2d", 0), CFG_FLOOR)
    assert sum(s["compiles"] for s in ss.counters()["steps"].values()) > 0
    ss.reset_counters()
    h2 = build_hierarchy(_adj("grid_2d", 1), CFG_FLOOR)
    steps = ss.counters()["steps"]
    assert all(s["compiles"] == 0 for s in steps.values()), steps
    assert sum(s["calls"] for s in steps.values()) > 0
    assert h1.n_levels > 1 and h2.n_levels > 1


# ----------------------------------------------------------------------------
# setup_ell_sweeps: the strength sweeps on the setup-time ELL twin
# ----------------------------------------------------------------------------

SWEEPS = dataclasses.replace(CFG, matvec_backend="auto", setup_ell_sweeps=True)


@pytest.fixture(scope="module")
def sweeps():
    """``tests/test_setup_superstep.py::TestSetupEllSweeps``'s case (BA
    n = 500, m = 3, seed 1, weighted; ``matvec_backend="auto"``): the
    reference's super-step and the port's super-step and eager setups,
    each with its solve of one right-hand side at tol 1e-8."""
    n, r, c, v = ensure_connected(*barabasi_albert(500, m=3, seed=1,
                                                   weighted=True))
    b = np.random.default_rng(9).normal(size=n).astype(np.float32)
    b -= b.mean()
    jcfg = JConfig(coarsest_size=32, matvec_backend="auto",
                   setup_ell_sweeps=True)
    out = dict(ref=JSolver.setup(n, r, c, v, jcfg),
               port=LaplacianSolver.setup(n, r, c, v, SWEEPS, device="cpu"),
               eager=LaplacianSolver.setup(
                   n, r, c, v, dataclasses.replace(SWEEPS,
                                                   setup_mode="eager"),
                   device="cpu"))
    for name, s in list(out.items()):
        x, info = s.solve(b, tol=1e-8)
        out[f"{name}_x"], out[f"{name}_info"] = np.asarray(x), info
    return out


def test_ell_sweeps_superstep_equals_eager(sweeps):
    """With the switch on, both setup modes still give bitwise the same
    residual history and solution."""
    i_s, i_e = sweeps["port_info"], sweeps["eager_info"]
    assert i_s.converged and i_s.iters == i_e.iters
    assert i_s.residual_norms == i_e.residual_norms
    np.testing.assert_array_equal(sweeps["port_x"], sweeps["eager_x"])
    assert _sig(sweeps["port"].hierarchy) == _sig(sweeps["eager"].hierarchy)


def test_ell_sweeps_match_reference(sweeps):
    i_p, i_r = sweeps["port_info"], sweeps["ref_info"]
    assert _sig(sweeps["port"].hierarchy) == [
        (r["kind"], r["n"], r["nnz"])
        for r in sweeps["ref"].stats()["levels"]]
    assert i_p.converged and i_p.iters == i_r.iters
    np.testing.assert_allclose(sweeps["port_x"], sweeps["ref_x"], rtol=1e-5,
                               atol=1e-5)


def test_ell_sweeps_runs_the_twin(monkeypatch):
    """The strength sweeps' SpMVs go through the ELL wrapper only with the
    switch on and a backend other than ``"coo"``."""
    import repro_torch.kernels.spmv_ell as spmv_pkg

    real, calls = spmv_pkg.spmv_ell, []

    def counted(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(spmv_pkg, "spmv_ell", counted)
    adj = _adj("barabasi_albert", 2)
    seen = {}
    for mode in ("superstep", "eager"):
        for on, backend in ((False, "ell"), (True, "coo"), (True, "ell")):
            calls.clear()
            build_hierarchy(adj, dataclasses.replace(
                CFG, setup_mode=mode, matvec_backend=backend,
                setup_ell_sweeps=on))
            seen[mode, on, backend] = len(calls)
    for mode in ("superstep", "eager"):
        assert seen[mode, False, "ell"] == seen[mode, True, "coo"] == 0
        assert seen[mode, True, "ell"] > 0
    assert seen["superstep", True, "ell"] == seen["eager", True, "ell"]


def test_ell_sweeps_key_the_agg_registry_entry():
    """The agg step's registry key holds the switch: a setup with the other
    setting adds an agg entry instead of reusing one built without (or
    with) the twin."""
    adj = _adj("grid_2d", 0)
    ss.clear_cache()
    ss.reset_counters()
    cfg = dataclasses.replace(CFG_FLOOR, matvec_backend="ell")
    build_hierarchy(adj, cfg)
    ss.reset_counters()
    build_hierarchy(adj, dataclasses.replace(cfg, setup_ell_sweeps=True))
    assert ss.counters()["steps"]["agg"]["compiles"] > 0
    ss.reset_counters()
    build_hierarchy(adj, dataclasses.replace(cfg, setup_ell_sweeps=True))
    assert ss.counters()["steps"]["agg"]["compiles"] == 0


@pytest.mark.parametrize("name", GRAPHS)
def test_one_host_fetch_per_level(name):
    ss.reset_counters()
    h = build_hierarchy(_adj(name, 2), CFG)
    assert ss.counters()["host_syncs"] <= (h.n_levels - 1) + 3


def test_exact_sizing_bit_identical_with_more_fetches():
    adj = _adj("barabasi_albert", 3)
    ss.reset_counters()
    h_x = build_hierarchy(adj, dataclasses.replace(CFG, elim_sizing="exact"))
    syncs_exact = ss.counters()["host_syncs"]
    assert ss.counters()["steps"]["elim_build"]["calls"] > 0
    ss.reset_counters()
    h_c = build_hierarchy(adj, CFG)
    syncs_cons = ss.counters()["host_syncs"]
    _assert_bitwise(h_x, h_c)
    n_elim = sum(1 for k, *_ in _sig(h_c) if k == "elim")
    assert n_elim > 0
    assert syncs_cons <= syncs_exact - n_elim


def test_floor_above_every_level_gives_one_agg_entry():
    ss.clear_cache()
    ss.reset_counters()
    h = build_hierarchy(_adj("grid_2d"),
                        dataclasses.replace(CFG, setup_bucket_floor=4096))
    agg = ss.counters()["steps"]["agg"]
    assert agg["compiles"] == 1 and agg["calls"] >= 1
    assert h.n_levels > 1


def test_ingest_paths():
    adj = _adj("grid_2d", 5)                  # padding-last by layout
    ss.reset_counters()
    h_fast = build_hierarchy(adj, CFG)
    steps = ss.counters()["steps"]
    assert steps.get("ingest_fast", {}).get("calls", 0) == 1
    assert steps.get("ingest", {}).get("calls", 0) == 0

    # padding shuffled into the middle: the probe must reject it
    pad = 37
    row, col, val = (torch.cat([a, torch.full((pad,), fill, dtype=a.dtype)])
                     for a, fill in ((adj.row, adj.n_rows),
                                     (adj.col, adj.n_rows), (adj.val, 0)))
    perm = torch.from_numpy(np.random.default_rng(0).permutation(len(row)))
    shuffled = COO(row[perm], col[perm], val[perm], adj.n_rows, adj.n_cols)
    ss.reset_counters()
    h_part = build_hierarchy(shuffled, CFG)
    steps = ss.counters()["steps"]
    assert steps.get("ingest", {}).get("calls", 0) == 1
    assert steps.get("ingest_fast", {}).get("calls", 0) == 0
    assert _sig(h_fast) == _sig(h_part)


def test_validation():
    adj = _adj("grid_2d")
    for cfg, match in ((dataclasses.replace(CFG, setup_mode="bogus"),
                        "setup_mode"),
                       (dataclasses.replace(CFG, elim_sizing="bogus"),
                        "elim_sizing"),
                       (dataclasses.replace(CFG, setup_bucket_floor=3000),
                        "power of two")):
        with pytest.raises(ValueError, match=match):
            build_hierarchy(adj, cfg)
        with pytest.raises(ValueError, match=match):
            build_hierarchy_batch([adj], cfg)


# ----------------------------------------------------------------------------
# renumber_device(n_valid=) against the reference
# ----------------------------------------------------------------------------

_CAP = 320          # every structure padded to one length: one jit trace


def _root_structures():
    for seed in range(20):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(1, 300))
        n_roots = int(rng.integers(1, n + 1))
        roots = rng.choice(n, size=n_roots, replace=False)
        aggs = roots[rng.integers(0, n_roots, n)]
        aggs[roots] = roots
        yield n, aggs
    yield 17, np.arange(17)                       # every vertex a root
    yield 17, np.zeros(17, np.int64)              # a single root


def test_renumber_device_n_valid_matches_reference():
    import jax

    ref = jax.jit(jagg.renumber_device)
    for n, aggs in _root_structures():
        padded = np.concatenate([aggs, np.arange(n, _CAP)]).astype(
            np.int32)                             # padding self-points
        want = ref(jnp.asarray(padded), n_valid=jnp.int32(n))
        got = tagg.renumber_device(torch.from_numpy(padded),
                                   n_valid=torch.tensor(n, dtype=torch.int32))
        np.testing.assert_array_equal(_np(got[0])[:n],
                                      np.asarray(want[0])[:n])
        assert int(got[1]) == int(want[1])
        assert bool(got[2]) and bool(want[2])
        unpadded = tagg.renumber_device(torch.from_numpy(padded[:n]))
        assert torch.equal(unpadded[0], got[0][:n])
    bad = np.array([0, 2, 0, 3], np.int32)        # 1 -> 2 -> 0, 3 padding
    assert not bool(tagg.renumber_device(torch.from_numpy(bad),
                                         n_valid=3)[2])


# ----------------------------------------------------------------------------
# Primitives that no longer make the host wait, against what they replaced
# ----------------------------------------------------------------------------

def _segment_sum_bincount(data, ids, num_segments):
    seg = _seg_ids(ids, num_segments)
    order = torch.argsort(seg, stable=True)
    lengths = torch.bincount(seg, minlength=num_segments + 1)
    return torch.segment_reduce(data.index_select(0, order), "sum",
                                lengths=lengths, axis=0,
                                unsafe=True)[:num_segments]


@pytest.mark.parametrize("seed", range(4))
def test_segment_sum_bitwise_unchanged(seed):
    rng = np.random.default_rng(seed)
    n_seg = int(rng.integers(1, 60))
    m = int(rng.integers(0, 500) if seed % 2 else rng.integers(2000, 6000))
    # many dropped ids: they are summed in chunks, past several chunks here
    ids = torch.from_numpy(rng.integers(-3, 2 * n_seg, m).astype(np.int32))
    for shape in ((m,), (m, 3)):
        data = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        got = segment_sum(data, ids, n_seg)
        want = _segment_sum_bincount(data, ids, n_seg)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _ranks_masked(r, n_rows):
    counts = torch.bincount(r.long(), minlength=n_rows)
    starts = torch.cumsum(counts, 0) - counts
    return torch.arange(r.shape[0]) - starts[r.long()]


@pytest.mark.parametrize("width", [0, 2, 8])
def test_ell_layout_bitwise_unchanged(width):
    rng = np.random.default_rng(width)
    n, cap, nnz = 50, 340, 300
    row = np.full(cap, n, np.int32)
    col = np.full(cap, n, np.int32)
    row[:nnz], col[:nnz] = rng.integers(0, n, nnz), rng.integers(0, n, nnz)
    perm = rng.permutation(cap)
    row, col = torch.from_numpy(row[perm]), torch.from_numpy(col[perm])
    lay = tell.ell_layout_traced(row, col, n, width)
    # the parent's ranks: histogram of the real entries, mask-indexed
    r = row[torch.argsort(sort_key(row, col), stable=True)]
    real = r < n
    rank = torch.zeros(cap, dtype=torch.int64)
    rank[real] = _ranks_masked(r[real], n)
    ok = real & (rank < width)
    assert torch.equal(lay.in_ell, ok)
    assert torch.equal(lay.kk, torch.where(ok, rank, 0))
    spilled = real & (rank >= width)
    assert torch.equal(lay.spill_row, torch.where(spilled, r, n))


@pytest.fixture(scope="module")
def padded_pair():
    """The BA graph's level and the same level padded to its buckets, as
    the super-step carries it."""
    adj = _adj("barabasi_albert", 4)
    level = graph_from_adjacency(adj)
    n = level.n
    n_cap, e_cap = pow2_bucket(n), pow2_bucket(adj.capacity)
    ok = adj.row < n
    pad = e_cap - adj.capacity
    fill = torch.full((pad,), n_cap, dtype=torch.int32)
    row = torch.cat([torch.where(ok, adj.row, n_cap), fill])
    col = torch.cat([torch.where(ok, adj.col, n_cap), fill])
    val = torch.cat([adj.val, torch.zeros(pad)])
    deg = torch.cat([level.deg, torch.zeros(n_cap - n)])
    plevel = GraphLevel(adj=COO(row, col, val, n_cap, n_cap), deg=deg)
    return level, plevel, torch.tensor(n, dtype=torch.int32)


def test_n_valid_padded_equals_unpadded(padded_pair):
    level, plevel, n_d = padded_pair
    n, m = level.n, level.adj.capacity

    elim = telim.select_eliminated(level)
    assert torch.equal(telim.select_eliminated(plevel, n_valid=n_d)[:n], elim)
    assert int(telim.select_eliminated(plevel, n_valid=n_d)[n:].sum()) == 0

    x = tstrength.relaxed_test_vectors(level)
    assert torch.equal(tstrength.relaxed_test_vectors(plevel,
                                                      n_valid=n_d)[:n], x)
    x0 = uniform(0, (pow2_bucket(n), 8), -0.5, 0.5, "cpu")
    assert torch.equal(tstrength.relaxed_test_vectors(level, x0=x0), x)
    for fn in (tstrength.algebraic_distance_strength,
               tstrength.affinity_strength):
        s = fn(level)
        assert torch.equal(fn(plevel, n_valid=n_d)[:m], s)

    lam = tsmooth.estimate_lambda_max(level)
    assert torch.equal(tsmooth.estimate_lambda_max(plevel, n_valid=n_d), lam)
    v0 = normal(0, (pow2_bucket(n),), "cpu")
    assert torch.equal(tsmooth.estimate_lambda_max(level, v0=v0), lam)

    s = tstrength.algebraic_distance_strength(level)
    aggs, state = tagg.aggregate(level, s)
    s_p = torch.cat([s, torch.zeros(plevel.adj.capacity - m)])
    aggs_p, state_p = tagg.aggregate(plevel, s_p, n_valid=n_d)
    assert torch.equal(aggs_p[:n], aggs) and torch.equal(state_p[:n], state)
    assert (state_p[n:] == tagg.DECIDED).all()


def test_tensor_sizes_equal_int_sizes(padded_pair):
    level, _, n_d = padded_pair
    n = level.n
    elim = telim.select_eliminated(level)
    a = telim.schur_arrays(level.adj, level.deg, elim, n, f_cap=n)
    b = telim.schur_arrays(level.adj, level.deg, elim, n_d, f_cap=n)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert isinstance(a["n_f"], torch.Tensor) and int(a["n_f"]) == \
        int(elim.sum())

    cid = torch.from_numpy(
        np.random.default_rng(0).integers(0, 90, n).astype(np.int32))
    a = tcoarsen.contract_arrays(level.adj, cid, 90)
    b = tcoarsen.contract_arrays(level.adj, cid,
                                 torch.tensor(90, dtype=torch.int32),
                                 sentinel=90)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
