"""Production meshes over a fake process group, and the H100 constants of
the roofline (torch port of ``repro.launch.mesh``).

Single pod: 16×16 = 256 ranks, axes ``("data", "model")``: the √P×√P grid
of the paper's 2D layout. Multi-pod: 2×16×16 = 512 ranks with a leading
``"pod"`` axis, which the LM stack folds into data parallelism and the
solver's partition splits edge lists across.

The dry-run traces one rank's program, so its world is a *fake* process
group (``torch.testing._internal.distributed.fake_pg``): every rank count
is accepted, collectives return at once and move nothing, and the program
runs as rank 0. :func:`fake_world` starts one as the default group (there
is one a process) and :func:`make_production_mesh` lays a
``DeviceMesh`` over it; :func:`process_mesh_of` gives the
solver's ``ProcessMesh`` of a mesh's geometry (:func:`process_mesh_of`).
Building a mesh touches no device.

Per-card constants of the roofline, for the card the port runs on
(``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` on it
prints ``NVIDIA H100 80GB HBM3, 700.00 W``), from NVIDIA's H100 SXM5 data
sheet (dense rates, no sparsity, at the full 700 W):

* ``PEAK_FLOPS_BF16``: 989 TFLOP/s of dense bf16 on the tensor cores;
* ``HBM_BW``: 3.35 TB/s of HBM3;
* NVLink: 900 GB/s (18 links) between the 8 cards of a node, which no
  collective of these meshes runs at alone (below);
* ``LINK_BW``: 50 GB/s, one 400 Gb/s NDR InfiniBand port a card (a DGX
  H100 node has one ConnectX-7 port for each of its 8 cards; the data
  sheet names no inter-node link).

A 16×16 mesh spans 32 nodes of 8 cards, so every group of its collectives
(16 ranks along either axis) crosses nodes, and the collective term of the
roofline runs at ``LINK_BW``, the slower link on the way. That is an
assumption: no cluster of this repository has measured it.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist

PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense bf16
HBM_BW = 3.35e12                # bytes/s
LINK_BW = 50e9                  # bytes/s a card between nodes

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def is_fake_world() -> bool:
    return dist.is_initialized() and dist.get_backend() == "fake"


def start_fake_world(size: int) -> None:
    """Make the default group a fake one of ``size`` ranks (this process is
    rank 0). A fake group of another size is destroyed first; any other
    default group raises: destroy it before the dry-run."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if not is_fake_world():
            raise RuntimeError(
                f"a {dist.get_backend()} default group is running; the "
                "dry-run needs a fake one (destroy it first)")
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=size,
                            store=FakeStore())


@contextlib.contextmanager
def fake_world(size: int):
    """A fake default group of ``size`` ranks for the block, destroyed at
    its end."""
    start_fake_world(size)
    try:
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _ensure_world(size: int) -> None:
    """A default group of ``size`` ranks: a real one as it is, else a fake
    one (started, or restarted at this size)."""
    if not dist.is_initialized() or is_fake_world():
        start_fake_world(size)
    elif dist.get_world_size() != size:
        raise ValueError(f"a mesh of {size} ranks needs a world of {size}, "
                         f"the default group has {dist.get_world_size()}")


def _device_mesh(shape, axes, device_type: str):
    from torch.distributed.device_mesh import DeviceMesh

    size = math.prod(shape)
    _ensure_world(size)
    return DeviceMesh(device_type, torch.arange(size).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """The ``DeviceMesh`` of 16×16 ``("data", "model")`` or, with
    ``multi_pod``, 2×16×16 ``("pod", "data", "model")`` ranks, over a fake
    default group of that size (started here if there is none)."""
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    return _device_mesh(shape, axes, device_type)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device_type="cpu"):
    """A small ``DeviceMesh`` over the default group (real or fake; a fake
    one of the right size is started if there is no group)."""
    return _device_mesh(tuple(shape), axes, device_type)


def process_mesh_of(mesh):
    """The solver's ``ProcessMesh`` of ``mesh``'s geometry (shape, axis
    names, device type) over the same default group, whose rank this
    process is (on a fake world: rank 0, whose block is (0, 0, 0); its
    all-reduces are counted and move nothing)."""
    from repro_torch.dist.mesh import make_mesh

    return make_mesh(tuple(mesh.shape), tuple(mesh.mesh_dim_names),
                     device=mesh.device_type)
