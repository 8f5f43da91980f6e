"""One rank's cost of a traced step: FLOPs, bytes, collective traffic and
peak memory, and their roofline terms on the H100. It takes the place of
both ``repro.launch.hlo_cost`` (a trip-count-aware cost model over
compiled HLO text) and ``repro.launch.hlo_analysis`` (collective bytes
and the ``Roofline``): the port has no compiled program to read, so it
counts the ops as the step runs them.

The step runs once, eagerly, under a counting dispatch mode (:func:`count`):

* on fake tensors (``FakeTensorMode``) over a fake process group, for the
  model steps: DTensors whose local shards are fake, so each op the
  counter sees is one rank's op on its local shapes (a DTensor-level op
  is not counted; the ops it runs on the local shards are, and those its
  sharding propagation runs on global fake shapes are not). Nothing is
  allocated and nothing computed;
* on real tensors, for the solver: rank 0's program runs for real over
  the fake group, whose collectives move nothing (its values are garbage
  past the first all-reduce, which a fixed-iteration solve ignores).

What each number is:

* ``flops``: matrix products by ``torch.utils.flop_counter``'s formulas
  (2·M·N·K), an elementwise op one FLOP an output element, a reduction
  one an input element; gathers, copies and views none;
* ``hbm_bytes``: every non-view op's input and output bytes (a broadcast
  input counted at its stored size). Eager torch fuses nothing, so this
  is an upper bound on the traffic of the same step compiled;
* collectives: calls and result bytes by kind (the functional
  collectives that DTensor issues, as the reference counts result
  shapes), and a ``ProcessMesh``'s all-reduces from its ``stats()``;
  ``CommDebugMode``'s own counts ride along for DTensor code;
* ``peak_bytes``: the largest sum of the storages the step made that
  were alive at once, tracked as fake or real tensors come and go; the
  report adds the arguments' local bytes;
* kernels: a port kernel's wrapper, which the counter cannot look into,
  reports its launch and bytes (``repro_torch.kernels.note``), counted
  from its shapes as ``PERF.md`` counts its bound.

Python loops run as loops, so a scanned body's trip count is the number
of times it ran: no multiplier to recover.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# the functional collectives (what DTensor issues) by kind; a call counts
# its result's bytes, as the reference counts result shapes
_FUNCOL = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}
_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "logsumexp", "prod",
    "_softmax", "_log_softmax", "var", "std", "var_mean", "std_mean",
    "linalg_vector_norm", "norm", "cumsum", "cumprod", "argmax", "argmin",
    "_softmax_backward_data", "_log_softmax_backward_data", "any", "all",
    "scatter_add", "scatter_add_", "index_add", "index_add_",
    "scatter_reduce", "scatter_reduce_", "embedding_dense_backward",
}
_NO_TRAFFIC = {"detach", "empty", "empty_strided", "empty_like",
               "new_empty", "new_empty_strided", "lift_fresh",
               "_local_scalar_dense", "device", "set_", "resize_",
               "wait_tensor", "alias", "_to_copy_meta"}


def _tensor_bytes(t: torch.Tensor) -> int:
    """Stored bytes of ``t``: a broadcast (stride-0) dim counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


@dataclasses.dataclass
class CostCounter:
    """The counts of one traced run."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: dict = dataclasses.field(
        default_factory=lambda: {k: 0 for k in COLLECTIVES})
    coll_counts: dict = dataclasses.field(
        default_factory=lambda: {k: 0 for k in COLLECTIVES})
    kernels: dict = dataclasses.field(default_factory=dict)
    ops: int = 0
    live_bytes: int = 0
    peak_bytes: int = 0
    _live: dict = dataclasses.field(default_factory=dict, repr=False)

    # -- memory ---------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = id(st)
        if key in self._live:
            return
        nbytes = st.nbytes()
        try:
            ref = weakref.ref(st, lambda _r, k=key: self._free(k))
        except TypeError:
            return
        self._live[key] = (ref, nbytes)
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, key) -> None:
        entry = self._live.pop(key, None)
        if entry is not None:
            self.live_bytes -= entry[1]

    # -- ops --------------------------------------------------------------
    def add_collective(self, kind: str, nbytes: float, calls: int = 1):
        self.coll_bytes[kind] = self.coll_bytes.get(kind, 0) + nbytes
        self.coll_counts[kind] = self.coll_counts.get(kind, 0) + calls
        self.hbm_bytes += nbytes

    def add_op(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry

        self.ops += 1
        ns = func.namespace
        name = func._opname
        outs = [t for t in tree_leaves(out) if _is_tensor(t)]
        if ns == "_c10d_functional":
            kind = _FUNCOL.get(name)
            if kind is not None:
                self.add_collective(kind, sum(map(_tensor_bytes, outs)))
            for t in outs:
                self._track(t)
            return
        if ns == "c10d":                 # ProcessMesh stats count these
            return
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **(kwargs or {}),
                                                out_val=out)
        elif torch.Tag.pointwise in func.tags:
            self.flops += sum(t.numel() for t in outs)
        elif name in _REDUCTIONS:
            ins = [t for t in tree_leaves((args, kwargs)) if _is_tensor(t)]
            self.flops += max((t.numel() for t in ins), default=0)
        if func.is_view or name in _NO_TRAFFIC:
            if name.startswith("empty") or name.startswith("new_empty"):
                for t in outs:
                    self._track(t)
            return
        ins = {id(t): t for t in tree_leaves((args, kwargs)) if _is_tensor(t)}
        self.hbm_bytes += sum(map(_tensor_bytes, ins.values())) \
            + sum(map(_tensor_bytes, outs))
        for t in outs:
            self._track(t)

    def note_kernel(self, name: str, nbytes: float):
        k = self.kernels.setdefault(name, dict(launches=0, bytes=0))
        k["launches"] += 1
        k["bytes"] += nbytes
        self.hbm_bytes += nbytes

    def add_process_mesh(self, stats: dict) -> None:
        """A ``ProcessMesh``'s ``stats()``: its calls are all-reduces (the
        solver's; ``optim.compress``'s all-gathers go through it too, and
        the solver makes none)."""
        self.add_collective("all-reduce", stats["bytes"], stats["calls"])

    def summary(self) -> dict:
        return dict(flops=self.flops, hbm_bytes=self.hbm_bytes,
                    coll_bytes=dict(self.coll_bytes),
                    coll_counts=dict(self.coll_counts),
                    total_coll_bytes=sum(self.coll_bytes.values()),
                    kernels={k: dict(v) for k, v in self.kernels.items()},
                    ops=self.ops, peak_bytes=self.peak_bytes,
                    live_bytes=self.live_bytes)


def _in_sharding_prop() -> bool:
    """True inside DTensor's sharding propagation, which runs an op on
    fake tensors of the global shapes to learn its output's metadata: not
    an op of the rank."""
    f = sys._getframe(2)
    while f is not None:
        if "sharding_prop" in f.f_code.co_filename:
            return True
        f = f.f_back
    return False


def _has_dtensor(args, kwargs) -> bool:
    from torch.distributed.tensor import DTensor

    return any(isinstance(t, DTensor) for t in tree_leaves((args, kwargs)))


class _RealMode(TorchDispatchMode):
    """Counts every op on real tensors (the solver's rank program)."""

    def __init__(self, counter: CostCounter):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.counter.add_op(func, args, kwargs, out)
        return out


def fake_mode(counter: CostCounter | None = None):
    """A ``FakeTensorMode`` that counts every op it runs on fake tensors
    into ``counter`` (ops on DTensors pass through uncounted: their local
    ops come back here). Real tensors may enter it (index arrays built
    outside)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    class _CountingFakeMode(FakeTensorMode):
        def dispatch(self, func, types, args=(), kwargs=None):
            out = super().dispatch(func, types, args, kwargs)
            if self.counting is not None and out is not NotImplemented \
                    and not (self.dtensors and (_has_dtensor(args, kwargs)
                                                or _in_sharding_prop())):
                self.counting.add_op(func, args, kwargs, out)
            return out

    mode = _CountingFakeMode(allow_non_fake_inputs=True)
    mode.counting = counter
    # False where no DTensor takes part (a mesh of one rank): nothing to
    # tell apart, so each op's check is skipped
    mode.dtensors = True
    return mode


@contextlib.contextmanager
def count(mode=None, real: bool = False):
    """Count the ops of the block into a new :class:`CostCounter` (the
    value of the ``with``): through ``mode`` (a :func:`fake_mode`, entered
    by the caller) for fake tensors, or with ``real`` a dispatch mode for
    real ones. Kernel wrappers report to it too (``kernels.note``)."""
    from repro_torch import kernels

    counter = CostCounter()
    kernels.COUNTERS.append(counter)
    try:
        if real:
            with _RealMode(counter):
                yield counter
        else:
            mode.counting = counter
            try:
                yield counter
            finally:
                mode.counting = None
    finally:
        kernels.COUNTERS.remove(counter)


@dataclasses.dataclass
class Roofline:
    """The reference's roofline record (``repro.launch.hlo_analysis``), with
    its ``to_dict`` keys: totals over ``n_chips`` ranks of one rank's
    counts, and the times of the H100 constants of ``launch.mesh``."""
    n_chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    model_flops: float

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / (self.n_chips * PEAK_FLOPS_BF16)

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / (self.n_chips * HBM_BW)

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / (self.n_chips * LINK_BW)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def bottleneck(self) -> str:
        terms = dict(compute=self.compute_s, memory=self.memory_s,
                     collective=self.collective_s)
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Model-FLOPs time over the bound: how close the step is to the
        card's roof for its useful work."""
        t_useful = self.model_flops / (self.n_chips * PEAK_FLOPS_BF16)
        return t_useful / self.bound_s if self.bound_s else 0.0

    def to_dict(self) -> dict:
        return dict(n_chips=self.n_chips, hlo_flops=self.hlo_flops,
                    hlo_bytes=self.hlo_bytes, coll_bytes=self.coll_bytes,
                    model_flops=self.model_flops, compute_s=self.compute_s,
                    memory_s=self.memory_s, collective_s=self.collective_s,
                    bottleneck=self.bottleneck,
                    useful_flops_ratio=self.useful_flops_ratio,
                    roofline_fraction=self.roofline_fraction)


def analyse(counts: dict, n_chips: int, model_flops: float):
    """``(Roofline, collectives)`` from one rank's :meth:`CostCounter.
    summary`: the reference's ``analyse`` (globals are one rank's counts
    times ``n_chips``; ``collectives`` keeps the per-rank bytes and calls
    by kind, and the total over the mesh)."""
    coll = dict(bytes_by_kind=dict(counts["coll_bytes"]),
                counts=dict(counts["coll_counts"]),
                total_bytes=counts["total_coll_bytes"] * n_chips)
    return Roofline(n_chips=n_chips, hlo_flops=counts["flops"] * n_chips,
                    hlo_bytes=counts["hbm_bytes"] * n_chips,
                    coll_bytes=counts["total_coll_bytes"] * n_chips,
                    model_flops=model_flops), coll
