"""Port's DeepFM serving path vs the JAX package, on the CPU.

The same numpy inputs go through both packages: the embedding layer
(``embedding_bag`` sum / mean / weighted with the sentinel ids −2, −1, V
and V + 3, ``hashed_lookup``), the MLP, the synthetic batch stream (bit
for bit), and ``deepfm_forward``, ``deepfm_loss`` and
``fm_retrieval_scores`` on ``SMOKE`` and on a narrow 39-field config with
the reference's parameters carried over by ``deepfm_params_from_numpy``.
Tolerances: the bag sums at rtol / atol 1e-6 (the same float32 adds); the
model outputs at rtol / atol 1e-5, as the float32 matrix products sum in
another order. Entry points without a device raise here, where there is
no card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the tensors here are small, and a pool in each
# test process oversubscribes the cores when test files run in parallel
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import deepfm as jcfg  # noqa: E402
from repro.data.synthetic import recsys_batch_stream as j_stream  # noqa: E402
from repro.models.gnn.common import mlp_apply as j_mlp_apply  # noqa: E402
from repro.models.recsys import deepfm as jd  # noqa: E402
from repro.models.recsys import embedding as je  # noqa: E402
from repro_torch.configs import deepfm as tcfg  # noqa: E402
from repro_torch.convert import deepfm_params_from_numpy  # noqa: E402
from repro_torch.data.synthetic import recsys_batch_stream as t_stream  # noqa: E402
from repro_torch.graphs.generators import to_laplacian_coo  # noqa: E402
from repro_torch.kernels.embedding_bag import embedding_bag_kernel  # noqa: E402
from repro_torch.models.gnn.common import init_mlp, mlp_apply  # noqa: E402
from repro_torch.models.recsys import deepfm as td  # noqa: E402
from repro_torch.models.recsys import embedding as te  # noqa: E402
from repro_torch.sparse.coo import coo_from_arrays  # noqa: E402

BAG_TOL = dict(rtol=1e-6, atol=1e-6)
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
_FIELDS = ("name", "n_fields", "embed_dim", "mlp_sizes", "vocab_per_field",
           "multi_hot")
NARROW39 = dict(n_fields=39, embed_dim=10, mlp_sizes=(32, 32),
                vocab_per_field=jd.default_vocabs(39, scale=1e-3),
                multi_hot=2)
CONFIGS = {"smoke": (jcfg.SMOKE, tcfg.SMOKE),
           "narrow39": (jd.DeepFMConfig(**NARROW39),
                        td.DeepFMConfig(**NARROW39))}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bags(rng, shape, n_vocab):
    idx = rng.integers(0, n_vocab, shape).astype(np.int32)
    flat = idx.reshape(-1)
    flat[::5] = np.resize(np.array([-2, -1, n_vocab, n_vocab + 3], np.int32),
                          flat[::5].shape)
    return idx


@pytest.mark.parametrize("mode,weighted", [("sum", False), ("mean", False),
                                           ("sum", True), ("mean", True)])
def test_embedding_bag_matches_reference(mode, weighted):
    rng = np.random.default_rng(3)
    table = rng.normal(size=(90, 7)).astype(np.float32)
    idx = _bags(rng, (17, 5, 3), 90)                 # [..., H] with H = 3
    w = rng.normal(size=idx.shape).astype(np.float32) if weighted else None
    got = te.embedding_bag(_t(table), _t(idx),
                           None if w is None else _t(w), mode=mode)
    want = je.embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                            None if w is None else jnp.asarray(w), mode=mode)
    assert got.shape == (17, 5, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAG_TOL)


def test_embedding_bag_goes_through_the_wrapper():
    table = torch.ones((6, 2))
    idx = torch.tensor([[[0, 5], [-1, 6]]], dtype=torch.int32)
    calls = []
    real = embedding_bag_kernel

    def spy(t, i):
        calls.append(tuple(i.shape))
        return real(t, i)

    import repro_torch.kernels.embedding_bag as pkg
    pkg.embedding_bag_kernel = spy
    try:
        out = te.embedding_bag(table, idx)
    finally:
        pkg.embedding_bag_kernel = real
    assert calls == [(2, 2)]                         # [..., H] -> [n_bags, H]
    np.testing.assert_array_equal(out.numpy(), [[[2, 2], [0, 0]]])
    with pytest.raises(ValueError, match="mode"):
        te.embedding_bag(table, idx, mode="max")


def test_hashed_lookup_matches_reference():
    rng = np.random.default_rng(5)
    table = rng.normal(size=(1000, 4)).astype(np.float32)
    raw = rng.integers(-2**31, 2**31 - 1, (64, 3), dtype=np.int64)
    raw[0, :3] = [0, -1, 2**31 - 1]
    raw = raw.astype(np.int32)
    for n_hashes in (1, 2, 3):
        got = te.hashed_lookup(_t(table), _t(raw), n_hashes=n_hashes)
        want = je.hashed_lookup(jnp.asarray(table), jnp.asarray(raw),
                                n_hashes=n_hashes)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mlp_matches_reference():
    rng = np.random.default_rng(9)
    sizes = [12, 16, 8, 1]
    params = init_mlp(sizes, torch.Generator().manual_seed(0), device="cpu")
    assert [tuple(w.shape) for w in params["w"]] == [(12, 16), (16, 8),
                                                     (8, 1)]
    assert all(not b.any() for b in params["b"])
    for b in params["b"]:
        b.copy_(torch.from_numpy(rng.normal(size=b.shape).astype(np.float32)))
    x = rng.normal(size=(5, 12)).astype(np.float32)
    jp = {k: [jnp.asarray(a.numpy()) for a in v] for k, v in params.items()}
    for final_act in (False, True):
        np.testing.assert_allclose(
            mlp_apply(params, _t(x), final_act=final_act).numpy(),
            np.asarray(j_mlp_apply(jp, jnp.asarray(x), final_act=final_act)),
            **MODEL_TOL)


def test_batch_stream_is_the_reference_stream():
    vocabs = jd.default_vocabs(39, scale=1e-3)
    for seed, start, hosts in ((0, 0, 1), (3, 5, 2)):
        js = j_stream(vocabs, 64, 2, seed=seed, start_step=start,
                      num_hosts=hosts, host_id=hosts - 1)
        ts = t_stream(vocabs, 64, 2, seed=seed, start_step=start,
                      num_hosts=hosts, host_id=hosts - 1)
        for _ in range(3):
            (js_, ji, jl), (ts_, ti, tl) = next(js), next(ts)
            assert js_ == ts_ and ji.dtype == ti.dtype == np.int32
            np.testing.assert_array_equal(ji, ti)
            np.testing.assert_array_equal(jl, tl)


def test_configs_match_reference():
    for name in ("FULL", "SMOKE"):
        j, t = getattr(jcfg, name), getattr(tcfg, name)
        assert {f: getattr(j, f) for f in _FIELDS} == \
            {f: getattr(t, f) for f in _FIELDS}
        assert t.total_vocab == j.total_vocab
        np.testing.assert_array_equal(t.field_offsets(), j.field_offsets())
        for dims in jcfg.SHAPE_DIMS.values():
            assert tcfg._train_flops(t, dims["batch"]) == \
                jcfg._train_flops(j, dims["batch"])
    assert tcfg.SHAPES == jcfg.SHAPES and tcfg.SHAPE_DIMS == jcfg.SHAPE_DIMS
    assert tcfg.FULL.total_vocab == 3_729_000
    assert td.padded_rows(tcfg.FULL) == 3_729_408
    assert tcfg.serve_flops(tcfg.FULL, 3) == \
        tcfg._train_flops(tcfg.FULL, 3) / 3


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def carried(request):
    """(ref cfg, port cfg, ref params, port params, batch) for a config."""
    jc, tc = CONFIGS[request.param]
    jp = jd.init_deepfm(jax.random.PRNGKey(0), jc)
    tp = deepfm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    _, idx, labels = next(j_stream(jc.vocab_per_field, 37, jc.multi_hot,
                                   seed=1))
    idx[0, 1, 1] = idx[3, 0, 0] = -1                 # empty bag slots
    return jc, tc, jp, tp, idx, labels


def test_deepfm_forward_and_loss_match_reference(carried):
    jc, tc, jp, tp, idx, labels = carried
    assert tp["table"].shape == jp["table"].shape
    got = td.deepfm_forward(tc, tp, _t(idx))
    want = jd.deepfm_forward(jc, jp, jnp.asarray(idx))
    assert got.shape == (idx.shape[0],)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    loss = td.deepfm_loss(tc, tp, _t(idx), _t(labels))
    np.testing.assert_allclose(
        loss.item(), float(jd.deepfm_loss(jc, jp, jnp.asarray(idx),
                                          jnp.asarray(labels))), **MODEL_TOL)


@pytest.mark.parametrize("item_field", [0, 2])
def test_fm_retrieval_scores_match_reference(carried, item_field):
    jc, tc, jp, tp, idx, _ = carried
    n = jc.vocab_per_field[item_field]
    n_rows = jp["table"].shape[0]
    off = int(jc.field_offsets()[item_field])
    # candidates whose fused ids are -1, -V, -V - 1 (jnp.take wraps the
    # first two and fills the third), the valid range and past the table
    cand = np.concatenate([np.arange(n), [n + 50, n_rows - off],
                           np.array([-1, -n_rows, -n_rows - 1]) - off])
    cand = cand.astype(np.int32)
    got = td.fm_retrieval_scores(tc, tp, _t(idx[:1]), _t(cand), item_field)
    want = jd.fm_retrieval_scores(jc, jp, jnp.asarray(idx[:1]),
                                  jnp.asarray(cand), item_field)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    assert got[-1].item() == 0.0 and got[-2].item() != 0.0


def test_deepfm_module_is_the_functional_path(carried):
    _, tc, _, tp, idx, _ = carried
    model = td.DeepFM(tc, params=tp, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    np.testing.assert_array_equal(model(_t(idx)).numpy(),
                                  td.deepfm_forward(tc, tp, _t(idx)).numpy())
    cand = torch.arange(tc.vocab_per_field[0], dtype=torch.int32)
    np.testing.assert_array_equal(
        model.retrieval_scores(_t(idx[:1]), cand).numpy(),
        td.fm_retrieval_scores(tc, tp, _t(idx[:1]), cand).numpy())


def test_init_deepfm_is_seeded_and_shaped():
    cfg = tcfg.SMOKE
    a = td.init_deepfm(cfg, torch.Generator().manual_seed(7), "cpu")
    b = td.DeepFM(cfg, torch.Generator().manual_seed(7), device="cpu")
    assert a["table"].shape == (512, cfg.embed_dim)
    assert a["first_order"].shape == (512, 1)
    assert [tuple(w.shape) for w in a["mlp"]["w"]] == [(24, 16), (16, 16),
                                                       (16, 1)]
    np.testing.assert_array_equal(a["table"].numpy(), b.table.numpy())
    assert a["bias"].shape == () and a["bias"].item() == 0.0


def test_entry_points_default_to_the_card():
    cfg = tcfg.SMOKE
    r = np.array([0, 1], np.int32)
    v = np.ones(2, np.float32)
    calls = [lambda: td.DeepFM(cfg, torch.Generator().manual_seed(0)),
             lambda: td.init_deepfm(cfg, torch.Generator().manual_seed(0)),
             lambda: coo_from_arrays(r, r[::-1], v, 2, 2),
             lambda: to_laplacian_coo(2, r, r[::-1], v)]
    if torch.cuda.is_available():
        for call in calls:
            out = call()
            t = out.table if isinstance(out, td.DeepFM) else \
                out["table"] if isinstance(out, dict) else out.row
            assert t.device.type == "cuda"
    else:
        for call in calls:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
    with pytest.raises(ValueError, match="generator or params"):
        td.DeepFM(cfg, device="cpu")
