"""The port's solver end to end vs the reference ``LaplacianSolver``.

Both build with ``SetupConfig(coarsest_size=64, matvec_backend="ell",
setup_mode="eager")`` on the graphs of ``tests/test_matvec.py``'s
equivalence case and a 24x24 grid: the level count, kinds and sizes and
the PCG iteration counts must be equal, and ``x`` must agree at rtol 1e-5 /
atol 1e-5 (the tolerance of ``test_matvec.py``). The port's PCG on the
reference hierarchy carried across by ``hierarchy_from_numpy`` must take
the reference's iteration count.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the tensors here are small, and a pool in each
# test process oversubscribes the cores when test files run in parallel
torch.set_num_threads(1)

from repro.core.coarsen import AggregationLevel as JAgg  # noqa: E402
from repro.core.hierarchy import SetupConfig as JConfig  # noqa: E402
from repro.core.solver import LaplacianSolver as JSolver  # noqa: E402
from repro.graphs.generators import (barabasi_albert,  # noqa: E402
                                     ensure_connected, grid_2d)
from repro_torch.convert import hierarchy_from_numpy  # noqa: E402
from repro_torch.core.hierarchy import SetupConfig, apply_cycle  # noqa: E402
from repro_torch.core.krylov import pcg  # noqa: E402
from repro_torch.core.solver import LaplacianSolver  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402

GRAPHS = {
    "ba900": lambda: ensure_connected(*barabasi_albert(900, m=3, seed=5,
                                                       weighted=True)),
    "grid24": lambda: grid_2d(24, 24),
}


def _kw():
    return dict(coarsest_size=64, matvec_backend="ell", setup_mode="eager")


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def pair(request):
    """One reference build and one port build per graph, shared by every
    test of the module."""
    n, r, c, v = GRAPHS[request.param]()
    b = np.random.default_rng(4).normal(size=n).astype(np.float32)
    b -= b.mean()
    ref = JSolver.setup(n, r, c, v, JConfig(**_kw()))
    port = LaplacianSolver.setup(n, r, c, v, SetupConfig(**_kw()),
                                 device="cpu")
    x_ref, info_ref = ref.solve(b)
    return dict(b=b, ref=ref, port=port, x_ref=np.asarray(x_ref),
                info_ref=info_ref)


def test_same_levels(pair):
    want = pair["ref"].stats()["levels"]
    got = pair["port"].stats()["levels"]
    keys = ("kind", "n", "nnz", "ell_width", "ell_spill")
    assert [{k: row[k] for k in keys} for row in got] == \
        [{k: row[k] for k in keys} for row in want]


def test_same_iterations_and_solution(pair):
    x, info = pair["port"].solve(pair["b"])
    assert info.converged and info.status == "converged"
    assert info.iters == pair["info_ref"].iters
    np.testing.assert_allclose(x.numpy(), pair["x_ref"], rtol=1e-5,
                               atol=1e-5)
    assert abs(info.wda - pair["info_ref"].wda) <= 1e-4 * pair["info_ref"].wda
    x2, _ = pair["port"].solve(pair["b"])
    assert torch.equal(x, x2)                       # repeat solves bitwise


def _coo(a):
    return dict(row=np.asarray(a.row), col=np.asarray(a.col),
                val=np.asarray(a.val), n_rows=a.n_rows, n_cols=a.n_cols)


def _level(lv):
    return dict(adj=_coo(lv.adj), deg=np.asarray(lv.deg),
                ell=None if lv.ell is None else dict(
                    col=np.asarray(lv.ell.col), val=np.asarray(lv.ell.val),
                    n_cols=lv.ell.n_cols),
                ell_rem=None if lv.ell_rem is None else _coo(lv.ell_rem))


def _flatten(h):
    """The reference Hierarchy as nested dicts of numpy arrays."""
    transfers = []
    for t in h.transfers:
        d = dict(fine=_level(t.fine), coarse=_level(t.coarse))
        if isinstance(t, JAgg):
            d.update(kind="agg", coarse_id=np.asarray(t.coarse_id))
        else:
            d.update(kind="elim", p_f=_coo(t.p_f),
                     **{k: np.asarray(getattr(t, k)) for k in (
                         "elim_mask", "c_index", "f_index", "f_vertices",
                         "inv_deg_f")})
        transfers.append(d)
    return dict(transfers=transfers,
                lam_maxes=[float(x) for x in h.lam_maxes],
                coarse_inv=np.asarray(h.coarse_inv))


def test_pcg_on_carried_hierarchy(pair):
    ref = pair["ref"]
    h = hierarchy_from_numpy(_flatten(ref.hierarchy), "cpu")
    cyc = pair["port"].cycle_config
    b = torch.from_numpy(pair["b"][ref.inv_perm])      # internal order
    x, info = pcg(h.transfers[0].fine.laplacian_matvec, b,
                  precond=lambda r: apply_cycle(h, r, cyc), tol=1e-8,
                  maxiter=200)
    assert info.converged
    assert info.iters == pair["info_ref"].iters
    np.testing.assert_allclose(x.numpy()[ref.perm], pair["x_ref"],
                               rtol=1e-5, atol=1e-5)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        LaplacianSolver.setup(4, [0, 1, 2], [1, 2, 3], [1.0, 1.0, 1.0])
    assert resolve_device("cpu") == torch.device("cpu")
