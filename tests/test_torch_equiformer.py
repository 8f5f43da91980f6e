"""Equiformer-v2 and its SO(3) machinery in the port vs the JAX package,
on the CPU.

The same seeded numpy inputs go through ``repro.models.gnn.{so3,
equiformer}`` and ``repro_torch.models.gnn.{so3,equiformer}``; the weights
are the reference's ``init_equiformer`` draws carried across by
``convert.gnn_params_from_numpy``. On the CPU the gathers and scatters
run their kernels' plain versions.

Tolerances: the spherical harmonics, Wigner blocks and rotations at rtol
1e-5 (atol 1e-5, for entries about 0); the sample directions and inverse
blocks bit for bit (the same host numpy); the edge softmax at 1e-6; each
forward at 1e-5 of its output's max |x|; float32 losses at rtol 1e-5;
gradients in float64 at rtol 1e-5 and atol 1e-5 of the leaf's largest
entry (the reference makes its irreps float32 even under 64-bit JAX, so
its embedding is rounded to float32), plus 1e-9 of the largest gradient
of any leaf (the attention's last bias has a gradient of 0 in exact
arithmetic, the softmax being shift-invariant, so both packages leave
rounding there); the chunked path's float32 gradients at rtol and atol
1e-4 of the leaf's largest, plus 1e-6 of the largest of any leaf. The
reference's chunked path runs in float32 only: under 64-bit JAX its
scan carries a float32 sum of float64 messages.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the tensors here are small, and a pool in each
# test process oversubscribes the cores when test files run in parallel
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs.equiformer_v2 as j_eqf  # noqa: E402
import repro.models.gnn.common as JG  # noqa: E402
import repro.models.gnn.equiformer as JE  # noqa: E402
import repro.models.gnn.so3 as J3  # noqa: E402
import repro.sparse.segment as jseg  # noqa: E402
import repro_torch.configs.equiformer_v2 as t_eqf  # noqa: E402
import repro_torch.models.gnn.common as TG  # noqa: E402
import repro_torch.models.gnn.equiformer as TE  # noqa: E402
import repro_torch.models.gnn.so3 as T3  # noqa: E402
import repro_torch.sparse.segment as tseg  # noqa: E402
from repro_torch.convert import gnn_params_from_numpy  # noqa: E402
from repro_torch.kernels.embedding_bag import bag_grad_plan  # noqa: E402
from repro_torch.tree import (flatten_with_paths, leaves,  # noqa: E402
                              value_and_grad)

SO3 = dict(rtol=1e-5, atol=1e-5)
# the reference caches its sample inverses at first use; made inside a
# jit trace they would be tracers (and leak), so make them here
for _l in (1, 2, 6):
    J3._sample_inverses(_l)


def _np(t):
    return t.detach().numpy()


def _dirs(seed, n):
    d = np.random.default_rng(seed).normal(size=(n, 3))
    d[:4] = [[0, 0, 1], [0, 0, -1], [0.01, 0.0, 0.9999], [1, 0, 0]]
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def graph_inputs(seed, n, e, df, pad=True):
    """Seeded endpoints and positions; with ``pad``, every 9th sender and
    every 11th receiver is the sentinel n, and edge 5 is a self-loop."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    if pad:
        s[::9] = n
        r[::11] = n
        r[5] = s[5] = 1
    return dict(senders=s, receivers=r,
                node_feat=rng.normal(size=(n, df)).astype(np.float32),
                pos=rng.normal(size=(n, 3)).astype(np.float32))


def graphs(inp, edge_chunk=None, dtype=np.float32):
    inp = {k: v.astype(dtype) if v.dtype == np.float32 else v
           for k, v in inp.items()}
    jg = JG.GraphBatch(**{k: jnp.asarray(v) for k, v in inp.items()})
    tg = TG.GraphBatch(**{k: torch.from_numpy(v) for k, v in inp.items()})
    return jg, tg.with_plans(edge_chunk=edge_chunk)


@functools.lru_cache(maxsize=None)
def _ref_draws(jcfg, seed):
    return jax.jit(lambda k: JE.init_equiformer(k, jcfg))(
        jax.random.PRNGKey(seed))


def ref_params(jcfg, seed=1, dtype=np.float32):
    """The reference's float32 draws as numpy arrays of ``dtype``, and the
    same as tensors."""
    jp = jax.tree.map(lambda a: np.asarray(a).astype(dtype),
                      _ref_draws(jcfg, seed))
    return jp, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)


def ref_loss_and_grads(jcfg, jp, jg, dtype=np.float32, jit=True):
    with jax.enable_x64(dtype == np.float64):
        def loss(p):
            out = JE.equiformer_forward(jcfg, p, jg)
            return jnp.mean(jnp.square(out)), out

        fn = jax.value_and_grad(loss, has_aux=True)
        (val, out), grads = (jax.jit(fn) if jit else fn)(jp)
        return (float(val), np.asarray(out),
                [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)])


def port_loss_and_grads(tcfg, tp, tg):
    out = []

    def loss(p):
        o = TE.equiformer_forward(tcfg, p, tg)
        out.append(o.detach())
        return torch.mean(torch.square(o))

    val, grads = value_and_grad(loss, tp)
    return val, out[0], leaves(grads)


def _close_to(got, want, rel=1e-5):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


def _grads_close(got, want, rtol, floor):
    """Each leaf at ``rtol``, atol ``rtol`` of its largest entry plus
    ``floor`` of the largest gradient of any leaf."""
    scale = max(float(np.abs(w).max()) for w in want)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(
            _np(g), w, rtol=rtol,
            atol=rtol * float(np.abs(w).max()) + floor * scale)


# ----------------------------------------------------------------------------
# SO(3) machinery
# ----------------------------------------------------------------------------

def test_real_sph_harm_matches_the_reference():
    d = _dirs(0, 64)
    got = T3.real_sph_harm(torch.from_numpy(d), 6)
    want = np.asarray(J3.real_sph_harm(jnp.asarray(d), 6))
    assert got.shape == want.shape == (64, 49)
    np.testing.assert_allclose(_np(got), want, **SO3)
    # the host path is the reference's host path, bit for bit
    np.testing.assert_array_equal(T3.real_sph_harm(d, 6),
                                  J3.real_sph_harm(d, 6, xp=np))


@pytest.mark.parametrize("l_max", [2, 6])
def test_sample_inverses_are_the_reference_bit_for_bit(l_max):
    X, invs = T3._sample_inverses(l_max, "cpu")
    jX, jinvs = J3._sample_inverses(l_max)
    np.testing.assert_array_equal(_np(X), np.asarray(jX))
    assert len(invs) == len(jinvs) == l_max + 1
    for a, b in zip(invs, jinvs):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    assert T3._sample_inverses(l_max, "cpu")[0] is X     # cached


def test_wigner_blocks_and_rotations_match_the_reference():
    d = _dirs(1, 40)
    R = T3.frame_from_direction(torch.from_numpy(d))
    jR, jD = jax.jit(lambda d: (J3.frame_from_direction(d),
                                J3.wigner_from_rotation(
                                    J3.frame_from_direction(d), 6)))(
        jnp.asarray(d))
    np.testing.assert_allclose(_np(R), np.asarray(jR), **SO3)
    # R d = z
    Rd = R @ torch.from_numpy(d)[:, :, None]
    np.testing.assert_allclose(_np(Rd)[..., 0], np.tile([0, 0, 1], (40, 1)),
                               atol=1e-5)
    D = T3.wigner_from_rotation(R, 6)
    for l, (a, b) in enumerate(zip(D, jD)):
        assert a.shape == (40, 2 * l + 1, 2 * l + 1)
        np.testing.assert_allclose(_np(a), np.asarray(b), **SO3)
        eye = np.broadcast_to(np.eye(2 * l + 1), a.shape)
        np.testing.assert_allclose(_np(a @ a.transpose(1, 2)), eye,
                                   atol=1e-4)
    # Y(R x) = D Y(x), degree by degree, on other directions
    x = torch.from_numpy(_dirs(2, 7))
    Rx = torch.einsum("eij,kj->eki", R, x)
    Yx, YRx = T3.real_sph_harm(x, 6), T3.real_sph_harm(Rx, 6)
    for l in range(7):
        lo, hi = l * l, (l + 1) ** 2
        np.testing.assert_allclose(
            _np(torch.einsum("eab,kb->eka", D[l], Yx[:, lo:hi])),
            _np(YRx[..., lo:hi]), atol=1e-4)
    packed = T3.pack_wigner(D)
    assert packed.shape == (40, sum((2 * l + 1) ** 2 for l in range(7)))
    assert all(torch.equal(a, b)
               for a, b in zip(T3.unpack_wigner(packed, 6), D))
    c = np.random.default_rng(3).normal(size=(40, 49, 5)).astype(np.float32)
    for transpose in (False, True):
        np.testing.assert_allclose(
            _np(T3.rotate_coeffs(torch.from_numpy(c), D, 6, transpose)),
            np.asarray(J3.rotate_coeffs(jnp.asarray(c), jD, 6, transpose)),
            **SO3)
    back = T3.rotate_coeffs(T3.rotate_coeffs(torch.from_numpy(c), D, 6), D,
                            6, transpose=True)
    np.testing.assert_allclose(_np(back), c, atol=1e-4)


def test_edge_rotation_is_the_truncated_wigner_product():
    """``edge_rotation``'s rows are D's at the |m| ≤ m_max coefficients:
    applied and transposed, they give the reference's ``rotate_coeffs`` at
    those coefficients, and its inverse of features that are zero
    elsewhere."""
    cfg = TE.EquiformerConfig(l_max=6, m_max=2)
    d = torch.from_numpy(_dirs(4, 30))
    rot = TE.edge_rotation(cfg, d)
    lay = TE._layout(6, 2)
    assert rot.shape == (30, 29, 49) and lay.n_trunc == 29
    coeffs = []                 # m-major: m = 0, then cos and sin rows
    for m in range(3):
        coeffs += [l * l + l + m for l in range(m, 7)]
        coeffs += [l * l + l - m for l in range(m, 7)] if m else []
    D = T3.wigner_from_rotation(T3.frame_from_direction(d), 6)
    c = torch.from_numpy(np.random.default_rng(5).normal(
        size=(30, 49, 4)).astype(np.float32))
    full = T3.rotate_coeffs(c, D, 6)
    np.testing.assert_allclose(_np(rot @ c), _np(full[:, coeffs]), **SO3)
    m = torch.zeros_like(c)
    m[:, coeffs] = c[:, :29]
    np.testing.assert_allclose(
        _np(rot.transpose(1, 2) @ c[:, :29]),
        _np(T3.rotate_coeffs(m, D, 6, transpose=True)), **SO3)


# ----------------------------------------------------------------------------
# the edge softmax
# ----------------------------------------------------------------------------

def _softmax_inputs(seed=6, m=70, n=12, h=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n, m).astype(np.int32)
    ids[ids == 3] = 4                                   # segment 3 empty
    ids[::10] = n                                       # padding ids
    valid = rng.random(m) > 0.2
    valid[ids == 7] = False                             # 7: no valid entry
    logits = (rng.normal(size=(m, h)) * 4).astype(np.float32)
    return logits, ids, valid


def test_segment_softmax_matches_the_reference_column_by_column():
    logits, ids, valid = _softmax_inputs()
    n = 12
    L, I, V = map(torch.from_numpy, (logits, ids, valid))
    plan = bag_grad_plan(I.view(-1, 1), n)
    got = tseg.segment_softmax(L, I, n, valid=V, plan=plan)
    assert got.shape == logits.shape
    for j in range(logits.shape[1]):
        want = np.asarray(jseg.segment_softmax(
            jnp.asarray(logits[:, j]), jnp.asarray(ids), n,
            valid=jnp.asarray(valid)))
        np.testing.assert_allclose(_np(got[:, j]), want, rtol=1e-6,
                                   atol=1e-6)
        # a column alone (the 1-D call) gives the same bits
        assert torch.equal(tseg.segment_softmax(L[:, j], I, n, valid=V),
                           got[:, j])
    ok = valid & (ids < n)
    assert not _np(got)[~ok].any()
    sums = np.zeros((n, logits.shape[1]))
    np.add.at(sums, ids[ok], _np(got)[ok])
    live = np.isin(np.arange(n), ids[ok])
    np.testing.assert_allclose(sums[live], 1.0, rtol=1e-6)
    assert not sums[~live].any() and not live[[3, 7]].any()


def test_segment_softmax_gradient_matches_jax():
    logits, ids, valid = _softmax_inputs(7)
    n = 12
    w = np.random.default_rng(8).normal(size=logits.shape).astype(np.float32)
    jgrad = jax.jit(jax.grad(lambda x: jnp.sum(jax.vmap(
        lambda c: jseg.segment_softmax(c, jnp.asarray(ids), n,
                                       valid=jnp.asarray(valid)),
        in_axes=1, out_axes=1)(x) * w)))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    (tseg.segment_softmax(x, torch.from_numpy(ids), n,
                          valid=torch.from_numpy(valid))
     * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(_np(x.grad), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-6)


# ----------------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------------

def _layer_inputs(tcfg, tp, tg):
    """The port's irreps after each layer, as the forward makes them."""
    edges = TE._edges(tcfg, tg)
    x = TE.mlp_apply(tp["embed"], tg.node_feat)
    outs = []
    for lp in tp["layers"]:
        x = TE._layer(tcfg, lp, x, tg, edges, lambda t: t)
        outs.append(x)
    return outs


def test_full_structure_layers_match_the_reference(monkeypatch):
    """FULL's widths (C 128, l_max 6, m_max 2, 8 heads) on a 6-node,
    10-edge graph, two layers: the second layer's input has every degree,
    so its m = 2 products and rotations run on live coefficients. Each
    layer's [N, 49, 128] output, and the model's, at 1e-5 of max |x|."""
    jcfg = JE.EquiformerConfig(n_layers=2, d_node_in=5, d_out=3)
    tcfg = TE.EquiformerConfig(n_layers=2, d_node_in=5, d_out=3)
    assert (tcfg.channels, tcfg.l_max, tcfg.m_max, tcfg.n_heads) == (
        t_eqf.FULL.channels, t_eqf.FULL.l_max, t_eqf.FULL.m_max,
        t_eqf.FULL.n_heads)
    jg, tg = graphs(graph_inputs(9, 6, 10, 5, pad=False))
    jp, tp = ref_params(jcfg)
    real_norm = JE._degree_norm

    def forward(p):
        seen = []             # the reference's layer inputs, then readout's
        monkeypatch.setattr(JE, "_degree_norm",
                            lambda cfg, x: seen.append(x)
                            or real_norm(cfg, x))
        return JE.equiformer_forward(jcfg, p, jg), seen

    want, seen = jax.jit(forward)(jp)
    want, seen = np.asarray(want), [np.asarray(x) for x in seen]
    got = _layer_inputs(tcfg, tp, tg)
    assert len(seen) == 3 and np.abs(seen[1][:, 1:]).max() > 0
    for x, w in zip(got, seen[1:]):
        assert x.shape == (6, 49, 128)
        _close_to(_np(x), w)
    with torch.no_grad():
        _close_to(_np(TE.equiformer_forward(tcfg, tp, tg)), want)


def test_smoke_forward_loss_and_gradients_match_the_reference():
    """The smoke config (2 layers, C 8, l_max 2, m_max 1, 2 heads) on the
    smoke graph's size with padding and a self-loop: forward and loss in
    float32, gradients in float64."""
    jcfg, _, _ = j_eqf.make_model("smoke", 12)
    tcfg, _, tfwd = t_eqf.make_model("smoke", 12)
    inp = graph_inputs(13, 24, 60, 12)
    jg, tg = graphs(inp)
    jp, tp = ref_params(jcfg)
    out = np.asarray(jax.jit(lambda p: JE.equiformer_forward(jcfg, p, jg))(
        jp))
    with torch.no_grad():
        got = tfwd(tcfg, tp, tg)
    _close_to(_np(got), out)
    val, _, grads = port_loss_and_grads(tcfg, tp, tg)
    np.testing.assert_allclose(float(val), float(jnp.mean(jnp.square(out))),
                               rtol=1e-5)
    jg, tg = graphs(inp, dtype=np.float64)
    jp, tp = ref_params(jcfg, dtype=np.float64)
    loss, _, want = ref_loss_and_grads(jcfg, jp, jg, np.float64)
    val, _, grads = port_loss_and_grads(tcfg, tp, tg)
    np.testing.assert_allclose(float(val), loss, rtol=1e-5)
    assert all(g.dtype == torch.float64 for g in grads)
    _grads_close(grads, want, 1e-5, 1e-9)
    # deterministic: the same bits from a second backward
    _, _, again = port_loss_and_grads(tcfg, tp, tg)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


def _chunked(cfg, remat=True):
    return dataclasses.replace(cfg, edge_chunk_size=16, remat=remat)


def test_chunked_remat_path_matches_the_reference_chunked_path():
    """``edge_chunk_size`` 16 on 60 edges (4 chunks; the reference pads
    the last with 4 sentinel edges) with remat, against the reference's
    chunked, rematerialised path, in float32; a three-layer config, so
    that the m = 1 weights of layer 2 get a gradient."""
    jcfg, _, _ = j_eqf.make_model("smoke", 12)
    tcfg, _, _ = t_eqf.make_model("smoke", 12)
    jcfg = dataclasses.replace(_chunked(jcfg), n_layers=3)
    tcfg = dataclasses.replace(_chunked(tcfg), n_layers=3)
    jg, tg = graphs(graph_inputs(14, 24, 60, 12), edge_chunk=16)
    assert len(tg.chunk_plans) == 4
    jp, tp = ref_params(jcfg)
    loss, out, want = ref_loss_and_grads(jcfg, jp, jg)
    val, got, grads = port_loss_and_grads(tcfg, tp, tg)
    _close_to(_np(got), out)
    np.testing.assert_allclose(float(val), loss, rtol=1e-5)
    paths = [p for p, _ in flatten_with_paths(tp)]
    m1 = paths.index(("layers", "1", "so2", "m1_r"))
    assert np.abs(want[m1]).max() > 0        # layer 2's m = 1 weights
    _grads_close(grads, want, 1e-4, 1e-6)


@pytest.mark.parametrize("chunk", [None, 16])
def test_remat_on_and_off_give_the_same_bits(chunk):
    tcfg, _, _ = t_eqf.make_model("smoke", 12)
    tcfg = dataclasses.replace(tcfg, n_layers=3, edge_chunk_size=chunk)
    _, tg = graphs(graph_inputs(15, 24, 60, 12), edge_chunk=chunk)
    tp = TE.init_equiformer(tcfg, torch.Generator().manual_seed(2), "cpu")
    runs = [port_loss_and_grads(dataclasses.replace(tcfg, remat=r), tp, tg)
            for r in (False, True)]
    (v0, o0, g0), (v1, o1, g1) = runs
    assert torch.equal(v0, v1) and torch.equal(o0, o1)
    assert len(g0) == len(g1) and all(torch.equal(a, b)
                                      for a, b in zip(g0, g1))
    # the per-layer Wigner blocks give the same bits as the shared ones
    noreuse = dataclasses.replace(tcfg, reuse_wigner=False, remat=True)
    v2, _, g2 = port_loss_and_grads(noreuse, tp, tg)
    assert torch.equal(v0, v2) and all(torch.equal(a, b)
                                       for a, b in zip(g0, g2))


def test_chunk_scatters_add_into_the_sum_bitwise_the_add_form(monkeypatch):
    """Each edge chunk's scatter adds into the running sum (the kernel's
    accumulate form, ``ScatterAdd``): the loss, output and every gradient
    bit for bit those of the chunked ``add_`` form (a sum per chunk, then
    ``agg.add_(part)``), at SMOKE on 60 edges in 4 chunks of 16 with
    remat; the form is taken by every chunk but each layer's first."""
    tcfg, _, _ = t_eqf.make_model("smoke", 12)
    tcfg = dataclasses.replace(_chunked(tcfg), n_layers=3)
    _, tg = graphs(graph_inputs(16, 24, 60, 12), edge_chunk=16)
    tp = TE.init_equiformer(tcfg, torch.Generator().manual_seed(4), "cpu")
    calls = []
    real = TE.scatter_rows

    def counted(msgs, idx, n, plan=None, acc=None, reduce=True):
        calls.append(acc is not None)
        return real(msgs, idx, n, plan, acc, reduce)

    def add_form(msgs, idx, n, plan=None, acc=None, reduce=True):
        part = real(msgs, idx, n, plan, reduce=reduce)
        return part if acc is None else acc.add_(part)

    monkeypatch.setattr(TE, "scatter_rows", counted)
    v0, o0, g0 = port_loss_and_grads(tcfg, tp, tg)
    # forward, and the recompute of each layer's forward in the backward
    assert calls == [False, True, True, True] * 3 * 2
    monkeypatch.setattr(TE, "scatter_rows", add_form)
    v1, o1, g1 = port_loss_and_grads(tcfg, tp, tg)
    assert torch.equal(v0, v1) and torch.equal(o0, o1)
    assert len(g0) == len(g1) and all(torch.equal(a, b)
                                      for a, b in zip(g0, g1))
    assert any(bool((g != 0).any()) for g in g0)


def test_rotation_and_translation_invariance_is_the_references():
    """Outputs under a seeded rotation and translation of ``pos``: the
    port's relative change at most twice the reference's."""
    jcfg, _, _ = j_eqf.make_model("smoke", 12)
    tcfg, _, _ = t_eqf.make_model("smoke", 12)
    inp = graph_inputs(16, 24, 60, 12)
    rot, _ = np.linalg.qr(np.random.default_rng(17).normal(size=(3, 3)))
    if np.linalg.det(rot) < 0:
        rot[:, 0] = -rot[:, 0]
    moved = dict(inp, pos=(inp["pos"] @ rot.T + [0.7, -1.3, 2.1]).astype(
        np.float32))
    jp, tp = ref_params(jcfg)
    (jg, tg), (jg2, tg2) = graphs(inp), graphs(moved)
    ref = jax.jit(lambda g: JE.equiformer_forward(jcfg, jp, g))
    with torch.no_grad():
        pairs = [(np.asarray(ref(jg)), np.asarray(ref(jg2))),
                 (_np(TE.equiformer_forward(tcfg, tp, tg)),
                  _np(TE.equiformer_forward(tcfg, tp, tg2)))]
    ref, port = (float(np.abs(a - b).max() / np.abs(a).max())
                 for a, b in pairs)
    assert port <= 2 * max(ref, 1e-7), (port, ref)
    assert port < 1e-5


def test_plans_are_built_once_per_graph_and_chunk():
    """2 plans for the endpoints and 2 for each chunk, all at
    ``with_plans``; a forward and backward builds none."""
    tcfg, _, tfwd = t_eqf.make_model("smoke", 12)
    tcfg = _chunked(tcfg)
    before = bag_grad_plan.builds
    _, tg = graphs(graph_inputs(18, 24, 60, 12), edge_chunk=16)
    assert bag_grad_plan.builds == before + 2 + 2 * 4
    assert TG.edge_chunks(60, 16) == [(0, 16), (16, 32), (32, 48), (48, 60)]
    tp = TE.init_equiformer(tcfg, torch.Generator().manual_seed(0), "cpu")
    port_loss_and_grads(tcfg, tp, tg)
    assert bag_grad_plan.builds == before + 2 + 2 * 4
    # without them, the forward builds each chunk's pair itself
    port_loss_and_grads(tcfg, tp, graphs(graph_inputs(18, 24, 60, 12))[1])
    assert bag_grad_plan.builds == before + 2 + 2 * 4 + 2 + 2 * 4


def test_gnn_params_from_numpy_carries_the_equiformer_tree():
    jcfg = JE.EquiformerConfig(n_layers=2, channels=8, l_max=3, m_max=2,
                               n_heads=2, d_node_in=5, d_out=3)
    jp, _ = ref_params(jcfg)
    tp = gnn_params_from_numpy(jp, "cpu")
    port = TE.init_equiformer(TE.EquiformerConfig(**dataclasses.asdict(jcfg)),
                              torch.Generator().manual_seed(0), "cpu")
    assert sorted(tp) == sorted(port) == ["embed", "layers", "readout"]
    assert sorted(tp["layers"][1]["so2"]) == sorted(
        port["layers"][1]["so2"]) == ["m0_r", "m1_i", "m1_r", "m2_i", "m2_r"]
    jl, tl = jax.tree_util.tree_leaves(jp), leaves(tp)
    assert len(jl) == len(tl) == len(leaves(port))
    for a, b, c in zip(jl, tl, leaves(port)):
        assert b.dtype == torch.float32 and b.shape == c.shape
        np.testing.assert_array_equal(a, _np(b))


def test_flops_are_the_references_and_the_executed_count():
    cfg = j_eqf.make_model("minibatch_lg", 602)[0]
    tcfg = t_eqf.make_model("minibatch_lg", 602)[0]
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    assert (tcfg.edge_chunk_size, tcfg.remat) == (65536, True)
    n, e = 169_984, 168_960
    assert t_eqf.flops(tcfg, n, e) == j_eqf.flops(cfg, n, e)
    # the m > 0 groups' four products at 2·(nl·C)² each, and remat's
    # recomputed forward: 45.6 -> 69.9 -> 93.3 TFLOP
    C = 128
    extra = sum(4 * ((7 - m) * C) ** 2 for m in (1, 2)) * e * 3 * 12
    no_remat = dataclasses.replace(tcfg, remat=False)
    assert t_eqf.flops_executed(no_remat, n, e) == pytest.approx(
        j_eqf.flops(cfg, n, e) + extra)
    assert t_eqf.flops_executed(tcfg, n, e) == pytest.approx(
        t_eqf.flops_executed(no_remat, n, e) * 4 / 3)
    assert round(t_eqf.flops(tcfg, n, e) / 1e12, 1) == 45.6
    assert round(t_eqf.flops_executed(tcfg, n, e) / 1e12, 1) == 93.3


def test_bag_wrappers_refuse_sizes_past_int32():
    """The bag kernels take ``d``, ``hot`` and ``n_vocab`` as C ints (their
    offsets are 64-bit: N·d = 169,984 × 6,272 at FULL is 1.07e9): the
    wrappers raise on a value past 2³¹ − 1 rather than let ``ctypes`` wrap
    it."""
    from repro_torch.kernels.embedding_bag import ops

    ops._c_ints("t", d=2 ** 31 - 1, n_vocab=169_984)
    for bad in (2 ** 31, -1):
        with pytest.raises(ValueError, match="int32"):
            ops._c_ints("t", d=bad)
