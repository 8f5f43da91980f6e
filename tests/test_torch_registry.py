"""The port's arch registry and synthetic data vs the JAX package, on the
CPU.

``repro_torch.configs``: ``list_archs()`` names the port's archs (DeepFM,
the Laplacian solver, the four GNNs, the three dense LMs and the two MoE
LMs: all eleven of the reference's),
each declares the reference's four shapes and family, and each smoke case runs on the CPU with finite outputs; the
Laplacian solver's smoke case takes the reference's iteration count and
its WDA within rtol 1e-2 (WDA
reads the log of the last residual norm, whose float32 reductions sum in
another order in the two packages, ROADMAP C4; 1.2e-3 apart here).
DeepFM's smoke case gives a finite loss, gradients and scores; each GNN's
a finite output, loss and gradients; each LM's a finite loss (one train
step) and finite ``[2, 1, vocab]`` decode logits, and the GNNs' shape table is the
reference's. ``repro_torch.data``:
``lm_batch_stream``, ``recsys_batch_stream``, ``gnn_graph_batch`` and
``neighbor_sampled_batch`` are bit-identical to the reference's.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the tensors here are small, and a pool in each
# test process oversubscribes the cores when test files run in parallel
torch.set_num_threads(1)

import repro.configs as JC  # noqa: E402
import repro.data.synthetic as JS  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
import repro_torch.data.synthetic as TS  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

PORT_ARCHS = ["arctic-480b", "deepfm", "egnn", "equiformer-v2",
              "laplacian-solver", "meshgraphnet", "moonshot-v1-16b-a3b", "pna",
              "qwen2-0.5b", "qwen2.5-3b", "starcoder2-3b"]
LM_ARCHS = {"arctic-480b": "arctic_480b",
            "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
            "qwen2-0.5b": "qwen2_0p5b", "qwen2.5-3b": "qwen2p5_3b",
            "starcoder2-3b": "starcoder2_3b"}
GNN_ARCHS = ["egnn", "equiformer-v2", "meshgraphnet", "pna"]


def test_list_archs_names_the_port_archs():
    assert TC.list_archs() == PORT_ARCHS
    assert PORT_ARCHS == sorted(JC.list_archs())


@pytest.mark.parametrize("arch_id", PORT_ARCHS)
def test_shapes_declared_as_the_reference(arch_id):
    spec, ref = TC.get_arch(arch_id), JC.get_arch(arch_id)
    assert len(spec.shapes) == 4 and spec.shapes == ref.shapes
    assert (spec.arch_id, spec.family) == (ref.arch_id, ref.family)


def test_deepfm_smoke_case_is_finite():
    out = TC.get_arch("deepfm").make_smoke_case(device="cpu")()
    assert out["loss"].shape == () and torch.isfinite(out["loss"])
    assert out["scores"].shape == (100,)
    grads = leaves(out["grads"])
    assert len(grads) == 9 and all(torch.isfinite(g).all() for g in grads)
    assert torch.isfinite(out["scores"]).all()
    assert any(g.abs().sum() > 0 for g in grads)


@pytest.mark.parametrize("arch_id", GNN_ARCHS)
def test_gnn_smoke_case_is_finite(arch_id):
    out = TC.get_arch(arch_id).make_smoke_case(device="cpu")()
    assert out["loss"].shape == () and torch.isfinite(out["loss"])
    assert out["out"].shape[0] == 24 and torch.isfinite(out["out"]).all()
    grads = leaves(out["grads"])
    assert grads and all(torch.isfinite(g).all() for g in grads)
    assert sum(int((g != 0).any()) for g in grads) > len(grads) // 2


@pytest.mark.parametrize("arch_id", sorted(LM_ARCHS))
def test_lm_smoke_case_is_finite(arch_id):
    out = TC.get_arch(arch_id).make_smoke_case(device="cpu")()
    vocab = importlib.import_module(
        f"repro_torch.configs.{LM_ARCHS[arch_id]}").SMOKE.vocab
    assert out["loss"].shape == () and torch.isfinite(out["loss"])
    assert out["logits"].shape == (2, 1, vocab)
    assert torch.isfinite(out["logits"]).all()


def test_gnn_shapes_are_the_reference_shapes():
    from repro.configs import gnn_common as jg
    from repro_torch.configs import gnn_common as tg

    assert tg.GNN_SHAPES == jg.GNN_SHAPES
    assert tg.SHAPE_DIMS == jg.SHAPE_DIMS


def test_laplacian_solver_smoke_case_matches_the_reference():
    from repro.configs import laplacian_solver as jls
    from repro.core.solver import LaplacianSolver
    from repro.graphs.generators import ensure_connected

    out = TC.get_arch("laplacian-solver").make_smoke_case(device="cpu")()
    assert torch.isfinite(out["loss"]) and out["loss"].item() >= 0
    # the reference's smoke case, step by step, for its iteration count
    n, rows, cols, vals = jls._build_graph("rmat_16")
    keep = (rows < 2000) & (cols < 2000)
    n2, r2, c2, v2 = ensure_connected(2000, rows[keep], cols[keep],
                                      vals[keep])
    b = np.random.default_rng(0).normal(size=n2).astype(np.float32)
    b -= b.mean()
    _, info = LaplacianSolver.setup(n2, r2, c2, v2).solve(b, tol=1e-6,
                                                         maxiter=60)
    assert info.converged and out["iters"] == info.iters
    np.testing.assert_allclose(out["wda"], info.wda, rtol=1e-2)


def test_laplacian_solver_graphs_are_the_reference_graphs():
    from repro.configs import laplacian_solver as jls
    from repro_torch.configs import laplacian_solver as tls

    assert tls.SHAPE_GRAPHS == jls.SHAPE_GRAPHS
    for got, want in zip(tls._build_graph("rmat_16", seed=1),
                         jls._build_graph("rmat_16", seed=1)):
        np.testing.assert_array_equal(got, want)


def _equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [dict(vocab=512, batch=4, seq_len=32),
                                dict(vocab=7, batch=6, seq_len=5, seed=3,
                                     start_step=2, host_id=1, num_hosts=2)])
def test_lm_batch_stream_is_bit_identical(kw):
    a, b = TS.lm_batch_stream(**kw), JS.lm_batch_stream(**kw)
    for _ in range(3):
        _equal(next(a), next(b))


def test_recsys_batch_stream_is_bit_identical():
    kw = dict(vocab_per_field=(50, 20, 3), batch=16, multi_hot=2, seed=4,
              start_step=5, host_id=1, num_hosts=2)
    a, b = TS.recsys_batch_stream(**kw), JS.recsys_batch_stream(**kw)
    for _ in range(2):
        _equal(next(a), next(b))


@pytest.mark.parametrize("kw", [dict(n_nodes=40, n_edges=100, d_feat=5),
                                dict(n_nodes=9, n_edges=30, d_feat=3, seed=2,
                                     d_edge=4, with_pos=True, n_classes=3)])
def test_gnn_graph_batch_is_bit_identical(kw):
    _equal(TS.gnn_graph_batch(**kw), JS.gnn_graph_batch(**kw))


@pytest.mark.parametrize("features", [False, True])
def test_neighbor_sampled_batch_is_bit_identical(features):
    rng = np.random.default_rng(0)
    n = 60
    deg = rng.integers(0, 6, n)
    deg[3] = 0                                       # a vertex with no edge
    indptr = np.concatenate([[0], np.cumsum(deg)])
    indices = rng.integers(0, n, indptr[-1])
    feats = rng.normal(size=(n, 4)).astype(np.float32) if features else None
    kw = dict(batch_nodes=8, fanouts=(3, 2), seed=5, d_feat=4,
              features=feats)
    _equal(TS.neighbor_sampled_batch(indptr, indices, **kw),
           JS.neighbor_sampled_batch(indptr, indices, **kw))
