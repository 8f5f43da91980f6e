"""The port's cost report (``repro_torch.launch.cost``) on hand-countable
programs: ``tests/test_hlo_cost.py``'s programs and expected numbers,
counted as the ops run on fake tensors instead of parsed from compiled
HLO. Python loops run as loops, so a loop of n multiplies its body's
counts by n with nothing to recover. Collectives run on a fake process
group of 4 ranks: 7 all-reduces of f32[128] in a loop and one all-gather
to f32[512], per rank. Also the kernels' shape-only path on fake tensors
(no plain version, no launch; its bytes noted)."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.launch import cost  # noqa: E402
from repro_torch.launch.mesh import fake_world  # noqa: E402


def _count(fn, *shapes):
    """``fn`` run once on fake float32 tensors of ``shapes``; its counts."""
    fm = cost.fake_mode()
    with fm:
        args = [torch.empty(s) for s in shapes]
        with cost.count(fm) as c:
            fn(*args)
    return c.summary()


class TestCost:
    def test_single_matmul_flops(self):
        out = _count(lambda a, b: a @ b, (128, 256), (256, 64))
        assert out["flops"] == 2 * 128 * 256 * 64

    def test_loop_multiplies_trip_count(self):
        def f(w, x):
            for _ in range(24):
                x = x @ w
            return x

        out = _count(f, (64, 64), (32, 64))
        assert out["flops"] == 24 * 2 * 32 * 64 * 64

    def test_nested_loops(self):
        def f(x):
            for _ in range(5):
                for _ in range(3):
                    x = x @ x
            return x

        out = _count(f, (16, 16))
        assert out["flops"] == 15 * 2 * 16 ** 3

    def test_batched_dot(self):
        out = _count(lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                     (8, 32, 48), (8, 48, 16))
        assert out["flops"] == 2 * 8 * 32 * 48 * 16

    def test_elementwise_counted(self):
        out = _count(lambda x: torch.tanh(x) + x * 2, (1000,))
        assert 1000 <= out["flops"] <= 10_000

    def test_bytes_and_peak(self):
        # a [1000, 1000] float32 read and a new one written: the product's
        # input and output bytes; at most two such buffers live at once
        def f(x):
            y = x * 2
            del x
            return y + 1

        out = _count(f, (1000, 1000))
        assert out["hbm_bytes"] == 4 * 4_000_000
        assert out["peak_bytes"] == 2 * 4_000_000
        assert out["live_bytes"] == 0


class TestCollectives:
    def test_loop_collectives_multiplied(self):
        from torch.distributed import _functional_collectives as funcol
        import torch.distributed as dist

        if dist.is_initialized():
            pytest.skip("this process is in another world")
        with fake_world(4):
            group = dist.group.WORLD
            fm = cost.fake_mode()
            with fm:
                x = torch.empty(128)
                with cost.count(fm) as c:
                    for _ in range(7):
                        x = funcol.wait_tensor(funcol.all_reduce(
                            x, "sum", group))
                    g = funcol.wait_tensor(funcol.all_gather_tensor(
                        x, 0, group))
            out = c.summary()
        assert tuple(g.shape) == (512,)
        assert out["coll_bytes"]["all-reduce"] == 7 * 512 == 3584
        assert out["coll_counts"]["all-reduce"] == 7
        assert out["coll_bytes"]["all-gather"] == 2048
        assert out["coll_counts"]["all-gather"] == 1

    def test_roofline_keys_match_reference(self):
        roof, coll = cost.analyse(
            dict(flops=1e12, hbm_bytes=1e9, coll_bytes={"all-reduce": 1e6},
                 coll_counts={"all-reduce": 3}, total_coll_bytes=1e6),
            n_chips=4, model_flops=2e12)
        assert set(roof.to_dict()) == {
            "n_chips", "hlo_flops", "hlo_bytes", "coll_bytes", "model_flops",
            "compute_s", "memory_s", "collective_s", "bottleneck",
            "useful_flops_ratio", "roofline_fraction"}
        assert roof.hlo_flops == 4e12 and coll["total_bytes"] == 4e6
        assert roof.bottleneck == "compute"


@pytest.mark.parametrize("wrapper", ["spmv_ell", "jacobi", "agg_vote",
                                     "embedding_bag", "bag_backward",
                                     "bag_grad_plan"])
def test_kernel_shape_only_path(wrapper):
    """On fake tensors each wrapper returns its result's shapes, counts a
    fake launch (never a launch), runs no op of its plain version, and
    notes its bytes to the running counter."""
    from repro_torch.kernels.agg_vote import vote_reduce
    from repro_torch.kernels.embedding_bag import (bag_grad_plan,
                                                   embedding_bag_backward,
                                                   embedding_bag_kernel)
    from repro_torch.kernels.jacobi import jacobi_step
    from repro_torch.kernels.spmv_ell import spmv_ell

    n, w, V, d = 96, 7, 50, 4
    i32 = torch.int32
    calls = {
        "spmv_ell": (spmv_ell, lambda: spmv_ell(
            torch.empty((n, w), dtype=i32), torch.empty((n, w)),
            torch.empty(n)), (n,), 8 * n * w + 8 * n),
        "jacobi": (jacobi_step, lambda: jacobi_step(
            torch.empty((n, w), dtype=i32), torch.empty((n, w)),
            *(torch.empty(n) for _ in range(3))), (n,), 8 * n * w + 16 * n),
        "agg_vote": (vote_reduce, lambda: vote_reduce(
            torch.empty((n, w), dtype=i32), torch.empty((n, w), dtype=i32),
            torch.empty(n, dtype=i32), levels=3)[0], (n,),
            8 * n * w + 12 * n),
        "embedding_bag": (embedding_bag_kernel, lambda: embedding_bag_kernel(
            torch.empty((V, d)), torch.empty((n, 2), dtype=i32)), (n, d),
            8 * n + 4 * n * d + 4 * d * V),
        "bag_backward": (embedding_bag_backward,
                         lambda: embedding_bag_backward(
                             torch.empty((n, d)),
                             torch.empty((n, 2), dtype=i32), V), (V, d),
                         8 * n + 4 * n * d + 4 * V * d),
        "bag_grad_plan": (bag_grad_plan, lambda: bag_grad_plan(
            torch.empty((n, 2), dtype=i32), V).sorted_ids, (2 * n,), 24 * n),
    }
    fn, call, shape, nbytes = calls[wrapper]
    name = {"bag_backward": "embedding_bag_backward"}.get(wrapper, wrapper)
    want = {name: dict(launches=1, bytes=nbytes)}
    if wrapper == "bag_backward":       # it sorts its ids, as on the card
        want["bag_grad_plan"] = dict(launches=1, bytes=24 * n)
    launches, fakes = fn.launches, fn.fake_launches
    fm = cost.fake_mode()
    with fm, cost.count(fm) as c:
        out = call()
    got = c.summary()
    assert tuple(out.shape) == shape
    assert fn.launches == launches and fn.fake_launches == fakes + 1
    # nothing but empty tensors (no traffic) and the kernels' own bytes:
    # no op of a plain version ran
    assert got["flops"] == 0
    assert got["hbm_bytes"] == sum(k["bytes"] for k in want.values())
    assert got["kernels"] == want


def test_real_counting_mode():
    """On real tensors (the solver's rank program) the dispatch mode counts
    the same product, and a live result's bytes."""
    with cost.count(real=True) as c:
        y = torch.ones(64, 32) @ torch.ones(32, 16)
    out = c.summary()
    assert out["flops"] == 2 * 64 * 32 * 16
    assert out["live_bytes"] == y.numel() * 4
