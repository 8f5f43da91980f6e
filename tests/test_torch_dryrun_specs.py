"""The port's dry-run placements against the reference's, shapes only (no
trace), on both production meshes (16×16 and 2×16×16; the port's a fake
process group, the reference's a device-less ``AbstractMesh``):

* every entry of the three plan tables (``make_lm_plan`` with and without
  ``seq_sharded``, ``make_gnn_plan``, ``make_recsys_plan``) and every
  ``param_specs`` entry of the five FULL LMs equals the reference's
  ``PartitionSpec``;
* every (arch, shape) cell but the solver's: each argument leaf's rank-0
  shape and dtype equal the reference's ``NamedSharding.shard_shape`` of
  it (so the per-rank argument bytes are equal), ``model_flops`` and the
  comment (the microbatch count) are equal, and the same cells are
  ``SkipCell``s with the same reasons.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import repro  # noqa: E402,F401  (JAX compat shims)
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import NamedSharding as RefNamed  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
import repro.models.sharding as ref_sharding  # noqa: E402
import repro.models.transformer as ref_tf  # noqa: E402
import repro_torch.configs as configs  # noqa: E402
import repro_torch.models.sharding as sharding  # noqa: E402
import repro_torch.models.transformer as tf  # noqa: E402
from repro_torch.launch.dryrun import local_shape  # noqa: E402
from repro_torch.launch.mesh import (PRODUCTION_SHAPES,  # noqa: E402
                                     make_production_mesh)
from repro_torch.tree import leaves  # noqa: E402

LMS = ("qwen2-0.5b", "qwen2.5-3b", "starcoder2-3b", "arctic-480b",
       "moonshot-v1-16b-a3b")
LM_MODULES = dict(zip(LMS, ("qwen2_0p5b", "qwen2p5_3b", "starcoder2_3b",
                            "arctic_480b", "moonshot_v1_16b_a3b")))


def _spec(p) -> tuple:
    """A spec (the reference's ``PartitionSpec`` or the port's ``P``) as a
    tuple of entries, a one-axis tuple as its axis (``PartitionSpec``'s
    own form), trailing unsharded dims dropped."""
    entries = [(e[0] if len(e) == 1 else tuple(e))
               if isinstance(e, (tuple, list)) else e for e in p]
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


@pytest.fixture(scope="module", params=[False, True], ids=["16x16",
                                                           "2x16x16"])
def meshes(request):
    """(the port's DeviceMesh over a fake world, the reference's
    AbstractMesh) of one production geometry."""
    import torch.distributed as dist

    shape, axes = PRODUCTION_SHAPES[request.param]
    mesh = make_production_mesh(multi_pod=request.param, device_type="cpu")
    yield mesh, AbstractMesh(shape, axes)
    dist.destroy_process_group()


def test_plan_tables(meshes):
    mesh, ref_mesh = meshes
    pairs = [(sharding.make_lm_plan(mesh, seq_sharded=s),
              ref_sharding.make_lm_plan(ref_mesh, seq_sharded=s))
             for s in (False, True)]
    pairs += [(sharding.make_gnn_plan(mesh),
               ref_sharding.make_gnn_plan(ref_mesh)),
              (sharding.make_recsys_plan(mesh),
               ref_sharding.make_recsys_plan(ref_mesh))]
    for port, ref in pairs:
        assert set(port.specs) == set(ref.specs)
        for name in ref.specs:
            assert _spec(port.spec(name)) == _spec(ref.spec(name)), name
        assert port.moe_token_shards == ref.moe_token_shards


@pytest.mark.parametrize("arch", LMS)
def test_param_specs(meshes, arch):
    import importlib

    mesh, ref_mesh = meshes
    port_cfg = importlib.import_module(
        f"repro_torch.configs.{LM_MODULES[arch]}").FULL
    ref_cfg = importlib.import_module(
        f"repro.configs.{LM_MODULES[arch]}").FULL
    got = tf.param_specs(port_cfg, sharding.make_lm_plan(mesh))
    want = ref_tf.param_specs(ref_cfg, ref_sharding.make_lm_plan(ref_mesh))
    assert set(got) == set(want)
    for k in want:
        assert _spec(got[k]) == _spec(want[k]), k


def _cells():
    return [(a, s) for a in configs.list_archs() if a != "laplacian-solver"
            for s in configs.get_arch(a).shapes]


@pytest.mark.parametrize("arch,shape", _cells())
def test_cell_arguments(meshes, arch, shape):
    mesh, ref_mesh = meshes
    case = configs.get_arch(arch).make_dryrun_case(shape, mesh)
    ref = ref_configs.get_arch(arch).make_dryrun_case(shape, ref_mesh)
    if isinstance(ref, ref_configs.SkipCell):
        assert isinstance(case, configs.SkipCell)
        assert (case.name, case.reason) == (ref.name, ref.reason)
        return
    assert case.name == ref.name
    assert case.model_flops == ref.model_flops
    assert case.comment == ref.comment
    specs, shardings = leaves(case.args), leaves(case.in_placements)
    ref_specs = jax.tree.leaves(ref.args)
    ref_sh = jax.tree.leaves(ref.in_shardings,
                             is_leaf=lambda x: isinstance(x, RefNamed))
    assert len(specs) == len(shardings) == len(ref_specs) == len(ref_sh)
    port_bytes = ref_bytes = 0
    for spec, sh, rspec, rsh in zip(specs, shardings, ref_specs, ref_sh):
        assert tuple(spec.shape) == tuple(rspec.shape)
        assert str(spec.dtype).removeprefix("torch.") == rspec.dtype.name
        got = local_shape(spec, sh)
        assert got == tuple(rsh.shard_shape(rspec.shape)), (spec, sh.spec)
        itemsize = torch.empty((), dtype=spec.dtype).element_size()
        port_bytes += itemsize * int(torch.Size(got).numel())
        ref_bytes += rspec.dtype.itemsize * int(
            torch.Size(rsh.shard_shape(rspec.shape)).numel())
    assert port_bytes == ref_bytes
