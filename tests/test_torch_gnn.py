"""The port's GNN substrate and the three scalar-payload GNNs vs the JAX
package, on the CPU.

The same seeded numpy inputs, with padding edges (sentinel = N, on the
senders and on the receivers, apart and together), go through
``repro.models.gnn`` and ``repro_torch.models.gnn``; the weights are the
reference's ``init_*`` draws carried across by
``convert.gnn_params_from_numpy``. On the CPU the gathers and scatters
run their kernels' plain versions (``kernels.embedding_bag``).

Tolerances: the message-passing primitives, ``rbf_encode``, the MLP's
LayerNorm tail and the row-wise segment reductions at rtol 1e-6 (atol
1e-6 where a sum may cancel to about 0); each model's forward at rtol /
atol 1e-5 (the float32 products and sums run in another order), its
loss and gradients at rtol 1e-4 (atol 1e-4 of the leaf's largest
gradient, for entries that cancel to about 0). The gather's and the
scatter's gradients and a model's gradients must also repeat bit for
bit: the backward is deterministic.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the tensors here are small, and a pool in each
# test process oversubscribes the cores when test files run in parallel
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs.egnn as j_egnn  # noqa: E402
import repro.configs.meshgraphnet as j_mgn  # noqa: E402
import repro.configs.pna as j_pna  # noqa: E402
import repro.models.gnn.common as JG  # noqa: E402
import repro.sparse.segment as jseg  # noqa: E402
import repro_torch.configs.egnn as t_egnn  # noqa: E402
import repro_torch.configs.meshgraphnet as t_mgn  # noqa: E402
import repro_torch.configs.pna as t_pna  # noqa: E402
import repro_torch.models.gnn.common as TG  # noqa: E402
import repro_torch.sparse.segment as tseg  # noqa: E402
from repro.models.gnn.egnn import EGNNConfig as JEGNN  # noqa: E402
from repro.models.gnn.meshgraphnet import MeshGraphNetConfig as JMGN  # noqa: E402
from repro.models.gnn.pna import PNAConfig as JPNA  # noqa: E402
from repro_torch.convert import gnn_params_from_numpy  # noqa: E402
from repro_torch.kernels.embedding_bag import (BagSum, ScatterSum,  # noqa: E402
                                               bag_grad_plan)
from repro_torch.models.gnn.egnn import EGNNConfig  # noqa: E402
from repro_torch.models.gnn.meshgraphnet import MeshGraphNetConfig  # noqa: E402
from repro_torch.models.gnn.pna import PNAConfig  # noqa: E402
from repro_torch.tree import leaves, value_and_grad  # noqa: E402

TIGHT = dict(rtol=1e-6, atol=1e-6)
FWD = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return t.detach().numpy()


def graph_inputs(seed, n, e, df, d_edge=8):
    """Seeded endpoints with padding edges: every 9th sender, every 11th
    receiver and every 13th edge's both endpoints are the sentinel n."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    s[::9] = n
    r[::11] = n
    s[::13] = r[::13] = n
    return dict(senders=s, receivers=r,
                node_feat=rng.normal(size=(n, df)).astype(np.float32),
                edge_feat=rng.normal(size=(e, d_edge)).astype(np.float32),
                pos=rng.normal(size=(n, 3)).astype(np.float32))


def graphs(inp, plans=True):
    jg = JG.GraphBatch(**{k: jnp.asarray(v) for k, v in inp.items()})
    tg = TG.GraphBatch(**{k: torch.from_numpy(v) for k, v in inp.items()})
    return jg, (tg.with_plans() if plans else tg)


# ----------------------------------------------------------------------------
# message passing and the substrate
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 3, 16])
def test_gather_and_scatter_match_the_reference(d):
    inp = graph_inputs(0, 30, 90, 4)
    jg, tg = graphs(inp)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(30, d)).astype(np.float32)
    m = rng.normal(size=(90, d)).astype(np.float32)
    X, M = torch.from_numpy(x), torch.from_numpy(m)
    for tfn, jfn, arg, jarg in (
            (TG.gather_src, JG.gather_src, X, x),
            (TG.gather_dst, JG.gather_dst, X, x),
            (TG.scatter_sum, JG.scatter_sum, M, m)):
        got = tfn(tg, arg)
        want = np.asarray(jfn(jg, jnp.asarray(jarg)))
        assert got.shape == want.shape
        np.testing.assert_allclose(_np(got), want, **TIGHT)
    # the padding: sentinel senders gather zeros, their messages sum to 0
    assert not TG.gather_src(tg, X)[inp["senders"] == 30].any()
    only_pad = np.zeros((90, d), np.float32)
    only_pad[inp["senders"] == 30] = 1.0
    assert not TG.scatter_sum(tg, torch.from_numpy(only_pad)).any()


def test_segment_mean_max_matches_the_reference():
    inp = graph_inputs(2, 25, 70, 4)
    jg, tg = graphs(inp)
    m = np.random.default_rng(3).normal(size=(70, 6)).astype(np.float32)
    got = TG.segment_mean_max(tg, torch.from_numpy(m))
    want = JG.segment_mean_max(jg, jnp.asarray(m))
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TIGHT)
    assert (_np(got[2])[:, 0] == 0).any()        # some node has no in-edge


def test_rbf_encode_matches_the_reference():
    dist = np.abs(np.random.default_rng(4).normal(size=(5, 7)) * 3)
    dist = dist.astype(np.float32)
    for kw in (dict(), dict(n_basis=8, r_max=2.5)):
        np.testing.assert_allclose(
            _np(TG.rbf_encode(torch.from_numpy(dist), **kw)),
            np.asarray(JG.rbf_encode(jnp.asarray(dist), **kw)), **TIGHT)


@pytest.mark.parametrize("layernorm_out", [False, True])
def test_mlp_matches_the_reference(layernorm_out):
    sizes = [7, 12, 5]
    jp = JG.init_mlp(jax.random.PRNGKey(2), sizes,
                     layernorm_out=layernorm_out)
    tp = gnn_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    if layernorm_out:                      # a scale and bias off 1 and 0
        rng = np.random.default_rng(5)
        for k in ("ln_scale", "ln_bias"):
            jp[k] = jnp.asarray(rng.normal(size=5).astype(np.float32))
            tp[k] = torch.from_numpy(np.asarray(jp[k]))
    x = np.random.default_rng(6).normal(size=(9, 7)).astype(np.float32)
    for final_act in (False, True):
        np.testing.assert_allclose(
            _np(TG.mlp_apply(tp, torch.from_numpy(x), final_act=final_act)),
            np.asarray(JG.mlp_apply(jp, jnp.asarray(x), final_act=final_act)),
            rtol=1e-6, atol=2e-6)
    port = TG.init_mlp(sizes, torch.Generator().manual_seed(0), "cpu",
                       layernorm_out=layernorm_out)
    assert sorted(port) == sorted(jp)
    assert [tuple(w.shape) for w in port["w"]] == [(7, 12), (12, 5)]


def test_init_mlp_draws_are_unchanged_by_the_layernorm_keyword():
    """DeepFM's MLP: the same draws, with or without the keyword."""
    a = TG.init_mlp([6, 4, 1], torch.Generator().manual_seed(3), "cpu")
    b = TG.init_mlp([6, 4, 1], torch.Generator().manual_seed(3), "cpu",
                    layernorm_out=True)
    gen = torch.Generator().manual_seed(3)
    want = [torch.randn((6, 4), generator=gen) / np.sqrt(6),
            torch.randn((4, 1), generator=gen) / np.sqrt(4)]
    for w, v, u in zip(a["w"], b["w"], want):
        assert torch.equal(w, u) and torch.equal(v, u)
    assert "ln_scale" not in a and torch.equal(b["ln_scale"], torch.ones(1))


def _segment_inputs(seed, m, n, d):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, n + 2, m).astype(np.int32)    # some out of range
    ids[ids == 3] = 4                                    # segment 3 empty
    data = rng.normal(size=(m,) + ((d,) if d else ())).astype(np.float32)
    data[::5] = data[1::5][: len(data[::5])]             # some ties
    return data, ids


@pytest.mark.parametrize("d", [0, 1, 6])
@pytest.mark.parametrize("name", ["segment_max", "segment_min",
                                  "segment_mean", "segment_std"])
def test_row_wise_segment_reductions_match_the_reference(name, d):
    data, ids = _segment_inputs(7, 80, 12, d)
    got = getattr(tseg, name)(torch.from_numpy(data), torch.from_numpy(ids),
                              12)
    jfn = getattr(jseg, name)
    if name == "segment_std" and d:
        # the reference's std gathers the means with an axis-less
        # jnp.take, which flattens a 2-D mean (ROADMAP C10): it is
        # row-wise only column by column
        want = np.stack([np.asarray(jfn(jnp.asarray(data[:, j]),
                                        jnp.asarray(ids), 12))
                         for j in range(d)], axis=1)
    else:
        want = np.asarray(jfn(jnp.asarray(data), jnp.asarray(ids), 12))
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), want, **TIGHT)  # ±inf at empties
    if name in ("segment_max", "segment_min"):
        assert np.isinf(want[3]).all()


def test_segment_max_min_gradients_share_ties_as_jax_does():
    """Entries that tie for a segment's max (or min) share its gradient
    evenly in both packages: PNA's max/min gradient is the reference's."""
    data, ids = _segment_inputs(8, 60, 10, 4)
    data[10:14] = data[20]                  # four rows tie everywhere
    ids[10:14] = ids[20] = 5
    w = np.random.default_rng(9).normal(size=(10, 4)).astype(np.float32)
    for name in ("segment_max", "segment_min"):
        jgrad = jax.grad(lambda x: jnp.sum(jnp.where(
            jnp.isfinite(getattr(jseg, name)(x, jnp.asarray(ids), 10)),
            getattr(jseg, name)(x, jnp.asarray(ids), 10), 0) * w))(
                jnp.asarray(data))
        x = torch.from_numpy(data).requires_grad_()
        out = getattr(tseg, name)(x, torch.from_numpy(ids), 10)
        (torch.where(torch.isfinite(out), out, 0)
         * torch.from_numpy(w)).sum().backward()
        np.testing.assert_allclose(_np(x.grad), np.asarray(jgrad), **TIGHT)


def test_gather_and_scatter_gradients_match_jax_and_repeat():
    """``BagSum`` with bags of one id (the gather) and ``ScatterSum``,
    differentiated, against ``jax.grad`` of the reference's composition,
    and bit for bit from one backward to the next."""
    inp = graph_inputs(10, 40, 150, 4)
    s, r, n = inp["senders"], inp["receivers"], 40
    rng = np.random.default_rng(11)
    x = rng.normal(size=(n, 5)).astype(np.float32)
    m = rng.normal(size=(150, 5)).astype(np.float32)
    wg = rng.normal(size=(150, 5)).astype(np.float32)
    ws = rng.normal(size=(n, 5)).astype(np.float32)
    jg = jax.grad(lambda x: jnp.sum(jnp.take(
        x, jnp.asarray(s), axis=0, mode="fill", fill_value=0) * wg))(
            jnp.asarray(x))
    js = jax.grad(lambda m: jnp.sum(jax.ops.segment_sum(
        m, jnp.asarray(r), num_segments=n) * ws))(jnp.asarray(m))
    S, R = torch.from_numpy(s).view(-1, 1), torch.from_numpy(r).view(-1, 1)
    plan_s, plan_r = bag_grad_plan(S, n), bag_grad_plan(R, n)
    grads = []
    for _ in range(2):
        X = torch.from_numpy(x).requires_grad_()
        M = torch.from_numpy(m).requires_grad_()
        (BagSum.apply(X, S, plan_s) * torch.from_numpy(wg)).sum().backward()
        out = ScatterSum.apply(M, R, n, plan_r)
        np.testing.assert_allclose(_np(out), np.asarray(jax.ops.segment_sum(
            jnp.asarray(m), jnp.asarray(r), num_segments=n)), **TIGHT)
        (out * torch.from_numpy(ws)).sum().backward()
        grads.append((X.grad, M.grad))
    np.testing.assert_allclose(_np(grads[0][0]), np.asarray(jg), **TIGHT)
    np.testing.assert_allclose(_np(grads[0][1]), np.asarray(js), **TIGHT)
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])
    # without a plan the backward builds its own: the same bits
    X = torch.from_numpy(x).requires_grad_()
    (BagSum.apply(X, S) * torch.from_numpy(wg)).sum().backward()
    assert torch.equal(X.grad, grads[0][0])


def test_plans_are_built_once_per_graph_and_shared():
    inp = graph_inputs(12, 20, 50, 4)
    before = bag_grad_plan.builds
    _, tg = graphs(inp)
    assert bag_grad_plan.builds == before + 2
    cfg, _, fwd = t_mgn.make_model("smoke", 4)
    params = t_mgn.init_mgn(cfg, torch.Generator().manual_seed(0), "cpu")
    live = [p.requires_grad_() for p in leaves(params)]
    fwd(cfg, params, tg).square().mean().backward()
    assert bag_grad_plan.builds == before + 2
    assert all(p.grad is not None for p in live)


# ----------------------------------------------------------------------------
# the three models against the reference
# ----------------------------------------------------------------------------

# a deeper and wider config of each model, in each package
DEEPER = {
    "meshgraphnet": (JMGN(n_layers=3, d_hidden=32, mlp_layers=2,
                          d_node_in=12, d_edge_in=8, d_out=5),
                     MeshGraphNetConfig(n_layers=3, d_hidden=32,
                                        mlp_layers=2, d_node_in=12,
                                        d_edge_in=8, d_out=5)),
    "pna": (JPNA(n_layers=3, d_hidden=24, d_node_in=12, d_out=3),
            PNAConfig(n_layers=3, d_hidden=24, d_node_in=12, d_out=3)),
    "egnn": (JEGNN(n_layers=3, d_hidden=32, d_node_in=12, d_out=3),
             EGNNConfig(n_layers=3, d_hidden=32, d_node_in=12, d_out=3)),
}
MODS = {"meshgraphnet": (j_mgn, t_mgn), "pna": (j_pna, t_pna),
        "egnn": (j_egnn, t_egnn)}
CASES = [(a, c) for a in MODS for c in ("smoke", "deeper")]
# the precision the gradients are compared in: PNA's in float64, as its
# float32 gradients carry the rounding that its std aggregator's
# 1/(2·sqrt(var + 1e-8)) multiplies by up to 5000 in both packages
# (ROADMAP C9, test_pna_float32_gradients_are_as_accurate_as_the_reference)
GRAD_DTYPE = {"meshgraphnet": np.float32, "egnn": np.float32,
              "pna": np.float64}


def _loss_parts(out):
    """Every output: coordinates too, for EGNN."""
    return out if isinstance(out, tuple) else (out,)


@functools.lru_cache(maxsize=None)
def model_case(arch, case, dtype=np.float32):
    """The reference's weights and outputs, loss ``Σ mean(out²)`` and
    gradients (jitted), and the port's model on the same weights and
    graph, all in ``dtype``: ``(want, (tcfg, tparams, tfwd, tgraph))``
    (made once a case; the callers leave them as they are)."""
    jmod, tmod = MODS[arch]
    jcfg, jinit, jfwd = jmod.make_model("smoke", 12)
    tcfg, _, tfwd = tmod.make_model("smoke", 12)
    if case == "deeper":
        jcfg, tcfg = DEEPER[arch]
    n, e = (24, 60) if case == "smoke" else (40, 160)
    inp = graph_inputs(13, n, e, 12)
    inp = {k: v.astype(dtype) if v.dtype == np.float32 else v
           for k, v in inp.items()}
    with jax.enable_x64(dtype == np.float64):
        jp = jax.jit(lambda k: jinit(k, cfg=jcfg))(jax.random.PRNGKey(1))
        jp = jax.tree.map(lambda a: np.asarray(a).astype(dtype), jp)
        jg, tg = graphs(inp)

        def loss(p):
            outs = _loss_parts(jfwd(jcfg, p, jg))
            return sum(jnp.mean(jnp.square(o)) for o in outs), outs

        (val, outs), grads = jax.jit(jax.value_and_grad(loss,
                                                        has_aux=True))(jp)
        want = dict(outs=[np.asarray(o) for o in outs], loss=float(val),
                    grads=[np.asarray(g)
                           for g in jax.tree_util.tree_leaves(grads)])
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return want, (tcfg, tp, tfwd, tg)


def port_loss_and_grads(tcfg, tp, tfwd, tg):
    loss, grads = value_and_grad(lambda p: sum(
        torch.mean(torch.square(o)) for o in _loss_parts(tfwd(tcfg, p, tg))),
        tp)
    return float(loss), leaves(grads)


def _grad_close(got, want):
    tol = 1e-4 * float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=tol)


@pytest.mark.parametrize("arch,case", CASES)
def test_model_forward_loss_and_gradients_match_the_reference(arch, case):
    want, (tcfg, tp, tfwd, tg) = model_case(arch, case)
    with torch.no_grad():
        outs = _loss_parts(tfwd(tcfg, tp, tg))
    for got, w in zip(outs, want["outs"]):
        assert got.shape == w.shape
        np.testing.assert_allclose(_np(got), w, **FWD)
    loss, grads = port_loss_and_grads(tcfg, tp, tfwd, tg)
    np.testing.assert_allclose(loss, want["loss"], rtol=1e-4)
    if GRAD_DTYPE[arch] != np.float32:
        want, (tcfg, tp, tfwd, tg) = model_case(arch, case,
                                                GRAD_DTYPE[arch])
        loss, grads = port_loss_and_grads(tcfg, tp, tfwd, tg)
        np.testing.assert_allclose(loss, want["loss"], rtol=1e-4)
    assert [tuple(g.shape) for g in grads] == [w.shape
                                                for w in want["grads"]]
    for got, w in zip(grads, want["grads"]):
        assert got.dtype == torch.from_numpy(w).dtype
        _grad_close(_np(got), w)
    # deterministic: the same bits from a second backward
    _, again = port_loss_and_grads(tcfg, tp, tfwd, tg)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.parametrize("case", ["smoke", "deeper"])
def test_pna_float32_gradients_are_as_accurate_as_the_reference(case):
    """ROADMAP C9: PNA's float32 gradients in both packages are off the
    float64 ones by up to about 2e-4 of a leaf's largest entry (the std
    aggregator's 1/(2·sqrt(var + 1e-8)) multiplies each package's own
    rounding), so they part from each other by as much. The port's is
    no farther from float64 than twice the reference's own error."""
    want64, _ = model_case("pna", case, np.float64)
    want32, (tcfg, tp, tfwd, tg) = model_case("pna", case)
    _, got = port_loss_and_grads(tcfg, tp, tfwd, tg)
    own = []
    for g, w32, w64 in zip(got, want32["grads"], want64["grads"]):
        scale = float(np.abs(w64).max())
        err_ref = float(np.abs(w32 - w64).max())
        err_port = float(np.abs(_np(g) - w64).max())
        assert err_port <= 2 * err_ref + 1e-6 * scale
        own.append(err_ref / scale)
    assert max(own) > 1e-5            # the reference's own float32 error


def test_gnn_params_from_numpy_keeps_the_reference_tree():
    jp = j_mgn.make_model("smoke", 12)[1](jax.random.PRNGKey(1),
                                          cfg=j_mgn.make_model("smoke",
                                                               12)[0])
    tp = gnn_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert sorted(tp) == sorted(jp)
    assert sorted(tp["edge_mlps"][0]) == ["b", "ln_bias", "ln_scale", "w"]
    jl = jax.tree_util.tree_leaves(jp)
    tl = leaves(tp)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(a), _np(b))
