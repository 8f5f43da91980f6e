"""The port's GNN training step, its two losses and EGNN's equivariance vs
the JAX package, on the CPU.

``repro_torch.configs.gnn_common.gnn_train_step`` (autograd, then the
port's AdamW) takes three steps from the reference's weights beside
``repro.configs.gnn_common.gnn_train_step`` on the same seeded graph with
padding edges: MeshGraphNet and PNA on ``node_class_loss`` (labels, the
last nodes padding), EGNN on ``graph_reg_loss`` (four graphs, the pooled
sum a scatter-sum over ``graph_id`` with its own plan); PNA in float64
(ROADMAP C9), AdamW in float32 in both packages. Tolerances: the
parameters after each step at rtol 1e-5 (atol 1e-7: a parameter that
starts at 0 moves by lr-sized steps), the losses at rtol 1e-5, and the
two losses and their gradients alone at rtol 1e-6. A second run of the
port's steps gives the same bits, and no step builds a plan: the graph's
are built once. EGNN's E(n) equivariance holds on the port: a seeded
rotation and translation of ``pos`` leaves ``node_out`` within 1e-5 of
its largest entry and moves the coordinates with it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the tensors here are small, and a pool in each
# test process oversubscribes the cores when test files run in parallel
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs.egnn as j_egnn  # noqa: E402
import repro.configs.gnn_common as JC  # noqa: E402
import repro.configs.meshgraphnet as j_mgn  # noqa: E402
import repro.configs.pna as j_pna  # noqa: E402
import repro.models.gnn.common as JG  # noqa: E402
import repro.optim.adamw as JA  # noqa: E402
import repro_torch.configs.egnn as t_egnn  # noqa: E402
import repro_torch.configs.gnn_common as TC  # noqa: E402
import repro_torch.configs.meshgraphnet as t_mgn  # noqa: E402
import repro_torch.configs.pna as t_pna  # noqa: E402
import repro_torch.models.gnn.common as TG  # noqa: E402
import repro_torch.optim.adamw as TA  # noqa: E402
from repro_torch.convert import gnn_params_from_numpy  # noqa: E402
from repro_torch.kernels.embedding_bag import bag_grad_plan  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

N, E, DF, N_GRAPHS, N_REAL = 32, 110, 12, 4, 29
MODS = {"meshgraphnet": (j_mgn, t_mgn), "pna": (j_pna, t_pna),
        "egnn": (j_egnn, t_egnn)}


def batch_inputs(seed=0):
    """A graph of N nodes (the last N - N_REAL padding) and E edges, every
    7th edge padding (sentinel N), endpoints inside each of N_GRAPHS
    graphs of 8 nodes; labels of 4 classes and per-graph targets."""
    rng = np.random.default_rng(seed)
    gid = np.repeat(np.arange(N_GRAPHS), N // N_GRAPHS).astype(np.int32)
    s = rng.integers(0, N, E).astype(np.int32)
    r = (gid[s] * (N // N_GRAPHS)
         + rng.integers(0, N // N_GRAPHS, E)).astype(np.int32)
    s[::7] = N
    r[::7] = N
    return dict(senders=s, receivers=r,
                node_feat=rng.normal(size=(N, DF)).astype(np.float32),
                edge_feat=rng.normal(size=(E, 8)).astype(np.float32),
                pos=rng.normal(size=(N, 3)).astype(np.float32),
                graph_id=gid,
                labels=rng.integers(0, 4, N).astype(np.int32),
                targets=rng.normal(size=N_GRAPHS).astype(np.float32))


GRAPH_KEYS = ("senders", "receivers", "node_feat", "edge_feat", "pos",
              "graph_id")


def reference_loss(arch, cfg, fwd):
    def loss(p, b):
        g = JG.GraphBatch(**{k: b[k] for k in GRAPH_KEYS})
        out = fwd(cfg, p, g)
        if arch == "egnn":
            return JC.graph_reg_loss(out[0], b["graph_id"], b["targets"],
                                     N_GRAPHS)
        return JC.node_class_loss(out, b["labels"], N_REAL)
    return loss


def port_loss(arch, cfg, fwd, plan):
    def loss(p, b):
        out = fwd(cfg, p, b["graph"])
        if arch == "egnn":
            return TC.graph_reg_loss(out[0], b["graph"].graph_id,
                                     b["targets"], N_GRAPHS, plan)
        return TC.node_class_loss(out, b["labels"], N_REAL)
    return loss


# the precision of the model (AdamW runs in float32 in both packages):
# PNA's in float64, as its float32 gradients carry rounding that its std
# aggregator multiplies by up to 5000 in both packages, so a near-zero
# gradient can take a different AdamW step in each (ROADMAP C9)
DTYPE = {"meshgraphnet": np.float32, "egnn": np.float32, "pna": np.float64}


@pytest.mark.parametrize("arch", list(MODS))
def test_train_steps_match_the_reference(arch):
    jmod, tmod = MODS[arch]
    jcfg, jinit, jfwd = jmod.make_model("smoke", DF)
    jcfg = type(jcfg)(**{**jcfg.__dict__, "d_out": 4})
    tcfg, _, tfwd = tmod.make_model("smoke", DF)
    tcfg = type(tcfg)(**{**tcfg.__dict__, "d_out": 4})
    dtype = DTYPE[arch]
    inp = {k: v.astype(dtype) if v.dtype == np.float32 else v
           for k, v in batch_inputs().items()}
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    with jax.enable_x64(dtype == np.float64):
        jb = {k: jnp.asarray(v) for k, v in inp.items()}
        jstep = jax.jit(JC.gnn_train_step(reference_loss(arch, jcfg, jfwd),
                                          JA.AdamWConfig(**opt)))
        jp = jax.jit(lambda k: jinit(k, cfg=jcfg))(jax.random.PRNGKey(3))
        jp = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), dtype), jp)
        jo = JA.adamw_init(jp)
        start = gnn_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        jsteps = []
        for _ in range(3):
            jp, jo, jm = jstep(jp, jo, jb)
            jsteps.append((jax.tree.map(np.asarray, jp), float(jm["loss"])))

    T = {k: torch.from_numpy(v) for k, v in inp.items()}
    g = TG.GraphBatch(**{k: T[k] for k in GRAPH_KEYS}).with_plans()
    plan = bag_grad_plan(T["graph_id"].view(-1, 1), N_GRAPHS)
    tb = dict(graph=g, labels=T["labels"], targets=T["targets"])
    tstep = TC.gnn_train_step(port_loss(arch, tcfg, tfwd, plan),
                              TA.AdamWConfig(**opt))
    if dtype == np.float64:         # the float32 draws, exactly
        start = tree_map(lambda t: t.double(), start)

    builds = bag_grad_plan.builds
    runs = []
    for _ in range(2):
        tp, to = start, TA.adamw_init(start)
        run = []
        for _ in range(3):
            tp, to, m = tstep(tp, to, tb)
            run.append((tp, float(m["loss"])))
        runs.append(run)
    assert bag_grad_plan.builds == builds       # the plans are reused

    for (tp, tloss), (tp2, _), (jp, jloss) in zip(*runs, jsteps):
        np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
        got, want = leaves(tp), jax.tree_util.tree_leaves(jp)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-7)
        assert all(torch.equal(a, b) for a, b in zip(got, leaves(tp2)))
    assert runs[0][-1][1] < runs[0][0][1] or arch == "egnn"


def test_node_class_loss_and_its_gradient_match_the_reference():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(N, 5)).astype(np.float32) * 3
    labels = rng.integers(0, 5, N).astype(np.int32)
    want, jgrad = jax.value_and_grad(JC.node_class_loss)(
        jnp.asarray(logits), jnp.asarray(labels), N_REAL)
    x = torch.from_numpy(logits).requires_grad_()
    got = TC.node_class_loss(x, torch.from_numpy(labels), N_REAL)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=1e-6,
                               atol=1e-8)
    assert not x.grad[N_REAL:].any()            # padding nodes: no gradient


@pytest.mark.parametrize("with_plan", [False, True])
def test_graph_reg_loss_and_its_gradient_match_the_reference(with_plan):
    rng = np.random.default_rng(5)
    out = rng.normal(size=(N, 3)).astype(np.float32)
    gid = np.repeat(np.arange(N_GRAPHS), N // N_GRAPHS).astype(np.int32)
    gid[-3:] = N_GRAPHS                         # padding nodes: dropped
    targets = rng.normal(size=N_GRAPHS).astype(np.float32)
    want, jgrad = jax.value_and_grad(JC.graph_reg_loss)(
        jnp.asarray(out), jnp.asarray(gid), jnp.asarray(targets), N_GRAPHS)
    G = torch.from_numpy(gid)
    plan = bag_grad_plan(G.view(-1, 1), N_GRAPHS) if with_plan else None
    x = torch.from_numpy(out).requires_grad_()
    got = TC.graph_reg_loss(x, G, torch.from_numpy(targets), N_GRAPHS, plan)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=1e-6,
                               atol=1e-8)


def _rotation(seed):
    q, r = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q.astype(np.float32)


@pytest.mark.parametrize("cfg_name", ["smoke", "full"])
def test_egnn_is_e_n_equivariant(cfg_name):
    cfg, init, fwd = t_egnn.make_model(cfg_name, DF)
    params = init(cfg, torch.Generator().manual_seed(7), "cpu")
    inp = batch_inputs(1)
    rot = _rotation(8)
    shift = np.array([0.7, -1.3, 2.1], np.float32)
    T = {k: torch.from_numpy(v) for k, v in inp.items()}
    g = TG.GraphBatch(**{k: T[k] for k in GRAPH_KEYS}).with_plans()
    moved = TG.GraphBatch(**{**{k: T[k] for k in GRAPH_KEYS},
                             "pos": torch.from_numpy(inp["pos"] @ rot.T
                                                     + shift)}).with_plans()
    with torch.no_grad():
        h, x = fwd(cfg, params, g)
        h2, x2 = fwd(cfg, params, moved)
    scale = float(h.abs().max())
    assert float((h2 - h).abs().max()) <= 1e-5 * scale
    want = x.numpy() @ rot.T + shift
    assert np.abs(x2.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert float((x - g.pos).abs().max()) > 0   # the coordinates moved


@pytest.mark.parametrize("arch", list(MODS))
def test_smoke_case_matches_the_reference_inputs(arch):
    """The port's smoke case draws the reference's numpy inputs: the same
    config and graph, so with the reference's weights carried across its
    output is the reference's (at rtol / atol 1e-5)."""
    jmod, tmod = MODS[arch]
    out = TC.make_gnn_smoke_case(tmod.make_model, arch == "egnn",
                                 arch == "meshgraphnet", device="cpu")()
    cfg = tmod.make_model("smoke", 12)[0]
    assert out["out"].shape == (24, cfg.d_out)
    assert torch.isfinite(out["loss"]) and all(
        torch.isfinite(t).all() for t in leaves(out["grads"]))
    # the reference's draws, through the port on the reference's weights
    rng = np.random.default_rng(0)
    s, r = rng.integers(0, 24, 60), rng.integers(0, 24, 60)
    feat = rng.normal(size=(24, 12))
    extra = {}
    if arch == "meshgraphnet":
        extra["edge_feat"] = torch.tensor(rng.normal(size=(60, 8)),
                                          dtype=torch.float32)
    if arch == "egnn":
        extra["pos"] = torch.tensor(rng.normal(size=(24, 3)),
                                    dtype=torch.float32)
    jcfg, jinit, jfwd = jmod.make_model("smoke", 12)
    jp = jax.jit(lambda k: jinit(k, cfg=jcfg))(jax.random.PRNGKey(0))
    jout = jmod.make_model("smoke", 12)[2](jcfg, jp, JG.GraphBatch(
        jnp.asarray(s, jnp.int32), jnp.asarray(r, jnp.int32),
        jnp.asarray(feat, jnp.float32),
        **{k: jnp.asarray(v.numpy()) for k, v in extra.items()}))
    jout = jout[0] if isinstance(jout, tuple) else jout
    g = TG.GraphBatch(torch.tensor(s, dtype=torch.int32),
                      torch.tensor(r, dtype=torch.int32),
                      torch.tensor(feat, dtype=torch.float32), **extra)
    tp = gnn_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    with torch.no_grad():
        got = tmod.make_model("smoke", 12)[2](cfg, tp, g)
    got = got[0] if isinstance(got, tuple) else got
    np.testing.assert_allclose(got.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
