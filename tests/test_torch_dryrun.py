"""The dry-run's traced path (``repro_torch.launch.dryrun``) at small
sizes on the CPU:

* one traced cell per family on a fake 2×2 world finishes with every
  record field finite: the SMOKE LMs (qwen2-0.5b's 7 heads over a
  ``"model"`` axis of 2: the attention's replicated-heads fallback and an
  uneven vocabulary split; moonshot's MoE), DeepFM's SMOKE config, EGNN's
  ``molecule`` cell and the solver on BA 500;
* the model code on a mesh is the model code: with ``make_lm_plan`` on a
  real 1×1 gloo world the LM loss and gradients are bitwise the null
  plan's (the MoE SMOKE's loss bitwise, its gradients within rtol 1e-5 /
  atol 1e-7: see the test); on a real 2×2 gloo world (four spawned ranks)
  the SMOKE train step's loss matches the null plan's at rtol 1e-5;
* the solver's rank-0 collective calls and bytes for ``build_solve_step``
  on BA 500 are the same on the fake 2×2 world and the real one;
* ``restore_checkpoint(..., shardings=)`` onto a mesh: the reference's
  case (``tests/test_checkpoint_runtime.py``), each leaf this rank's
  shard, the values the reference restores.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402

import torch_dist_helpers as helpers  # noqa: E402
from repro_torch.launch.dryrun import cell_record  # noqa: E402
from repro_torch.launch.mesh import fake_world, make_test_mesh  # noqa: E402
from repro_torch.models.sharding import (NamedSharding, P,  # noqa: E402
                                         distribute, make_lm_plan,
                                         null_plan)
from repro_torch.tree import leaves, tree_map, value_and_grad  # noqa: E402


def _finite(x, path="rec"):
    if isinstance(x, dict):
        for k, v in x.items():
            _finite(v, f"{path}.{k}")
    elif isinstance(x, (int, float)) and not isinstance(x, bool):
        assert math.isfinite(x), path


def _smoke_case(family, mesh):
    import dataclasses

    from repro_torch.configs import deepfm, gnn_common, lm_common
    from repro_torch.configs import egnn, moonshot_v1_16b_a3b, qwen2_0p5b
    from repro_torch.configs.laplacian_solver import solve_case
    from repro_torch.core.hierarchy import SetupConfig

    if family == "lm":
        return lm_common.make_lm_dryrun_case(qwen2_0p5b.SMOKE, "train_4k",
                                             mesh)
    if family == "lm-decode":
        return lm_common.make_lm_dryrun_case(qwen2_0p5b.SMOKE, "decode_32k",
                                             mesh)
    if family == "moe":
        cfg = dataclasses.replace(moonshot_v1_16b_a3b.SMOKE, q_chunk=512)
        return lm_common.make_lm_dryrun_case(cfg, "train_4k", mesh)
    if family == "recsys":
        return deepfm.make_dryrun_case("train_batch", mesh, deepfm.SMOKE)
    if family == "gnn":
        return gnn_common.make_gnn_dryrun_case(
            "egnn", "molecule", mesh, egnn.make_model, egnn.flops,
            needs_pos=True)
    return solve_case("ba500", helpers.ba(*helpers.BA500), mesh,
                      SetupConfig(coarsest_size=32), dist_nnz_threshold=64,
                      max_dist_levels=2, n_iters=helpers.SOLVE_ITERS)


@pytest.fixture
def fake_2x2():
    if dist.is_initialized():
        pytest.fail("a default process group is already running")
    with fake_world(4):
        yield make_test_mesh((2, 2))


@pytest.mark.parametrize("family", ["lm", "lm-decode", "moe", "recsys",
                                    "gnn", "solver"])
def test_traced_cell_on_fake_2x2(fake_2x2, family):
    rec = cell_record(_smoke_case(family, fake_2x2), torch.device("cpu"), 4)
    _finite(rec)
    assert rec["per_rank"]["flops"] > 0 and rec["ops"] > 0
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["roofline"]["n_chips"] == 4
    if family != "recsys":              # the serve-free DeepFM step: its
        assert rec["per_rank"]["coll_bytes"] > 0   # grads reduce too
    if family in ("recsys", "gnn"):
        assert rec["kernels"], "no kernel's shape-only path ran"


def test_solver_collectives_fake_equal_real(fake_2x2, real_2x2):
    fake = helpers.solve_case_stats(fake_2x2)
    real = real_2x2[0]["solve"]
    assert fake["norms"] == real["norms"] == helpers.SOLVE_ITERS + 1
    assert (fake["calls"], fake["bytes"]) == (real["calls"], real["bytes"])
    assert fake["calls"] > 0


@pytest.fixture(scope="module")
def real_2x2():
    from repro_torch.dist import run_world

    return run_world(helpers.dryrun_rank_body, 4, timeout=240, threads=1)


def test_lm_step_2x2_gloo_matches_null_plan(real_2x2):
    want = helpers.lm_step_loss(None)
    for r in real_2x2:
        np.testing.assert_allclose(r["loss"], want, rtol=1e-5)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "moonshot-v1-16b-a3b"])
def test_plan_on_world_of_one_is_bitwise_null_plan(arch):
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import moonshot_v1_16b_a3b
    from repro_torch.models.transformer import (init_params, lm_loss,
                                                param_specs)

    if arch == "qwen2-0.5b":
        cfg, params, toks = helpers.lm_smoke_inputs()
    else:
        cfg = moonshot_v1_16b_a3b.SMOKE
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        toks = torch.randint(0, cfg.vocab, (2, 17),
                             generator=torch.Generator().manual_seed(1),
                             dtype=torch.int32)
    want_loss, want_grads = value_and_grad(
        lambda p: lm_loss(cfg, p, toks, null_plan()), params)
    with helpers.world_of_one():
        mesh = DeviceMesh("cpu", torch.zeros((1, 1), dtype=torch.int64),
                          mesh_dim_names=("data", "model"))
        plan = make_lm_plan(mesh)
        dparams = tree_map(lambda t, sp: distribute(t, NamedSharding(
            mesh, sp)), params, param_specs(cfg, plan))
        loss, grads = value_and_grad(
            lambda p: lm_loss(cfg, p, distribute(toks, plan.named("tokens")),
                              plan), dparams)
        got = [g.to_local() for g in leaves(grads)]
        loss = loss.to_local()
    assert torch.equal(loss, want_loss)
    for g, w in zip(got, leaves(want_grads)):
        if arch == "qwen2-0.5b":
            assert torch.equal(g, w)
        else:
            # the MoE block's input feeds the dispatch inside local_map and
            # the shared experts outside it, so autograd sums that input's
            # three gradient terms in another association: one rounding
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-7)


def test_restore_checkpoint_onto_mesh(tmp_path, fake_2x2):
    """The reference's case: ``w = arange(16.)`` saved and restored with
    shardings; here onto the fake 2×2 mesh (rank 0's shard of each
    placement) and, for the values, by the reference itself."""
    jax = pytest.importorskip("jax")
    from repro.checkpoint.ckpt import restore_checkpoint as ref_restore
    from repro_torch.checkpoint.ckpt import (restore_checkpoint,
                                            save_checkpoint)

    tree = dict(w=torch.arange(16.0), v=torch.arange(12.0).reshape(3, 4),
                u=torch.ones(5))
    save_checkpoint(str(tmp_path), 1, tree)
    sh = dict(w=NamedSharding(fake_2x2, P("data")),
              v=NamedSharding(fake_2x2, P(None, ("data", "model"))),
              u=NamedSharding(fake_2x2, P()))
    got, manifest = restore_checkpoint(str(tmp_path), 1, tree, shardings=sh)
    assert manifest["step"] == 1
    assert torch.equal(got["w"].to_local(), tree["w"][:8])
    assert torch.equal(got["v"].to_local(), tree["v"][:, :1])
    assert torch.equal(got["u"].to_local(), tree["u"])
    assert tuple(got["w"].shape) == (16,)
    ref_tree = {k: jax.numpy.asarray(v.numpy()) for k, v in tree.items()}
    ref_sh = {k: jax.sharding.SingleDeviceSharding(jax.devices()[0])
              for k in tree}
    ref, _ = ref_restore(str(tmp_path), 1, ref_tree, shardings=ref_sh)
    for k in tree:
        shard = got[k].to_local().numpy()
        full = np.asarray(ref[k])
        assert np.array_equal(shard, full[tuple(
            slice(0, n) for n in shard.shape)])
