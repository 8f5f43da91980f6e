"""The port's serving layer (``repro_torch.service``) against the
reference's (``repro.service``), after ``tests/test_service.py``,
``tests/test_admission.py`` and ``tests/test_service_checkpoint.py``.

The same request streams (scenarios below) run through both packages in
one process, with the same ``FaultPlan`` armed on each package's own
``testing`` module; every non-wall-clock ``stats()`` counter and the
cache's counters must be equal, ticket statuses and iteration counts
equal, and ``x`` within rtol 1e-5 / atol 1e-5. Within the port, bitwise:
service results against direct facade solves, batched against looped
setups, the repeat stream, and a resumed flush against an uninterrupted
one. Snapshots resume across the packages both ways, and a port-only
process killed mid-flush is resumed here. Wall-clock fields (deadlines,
``checkpoint_wall``, latencies, seconds) are held as contracts, not
values. Every scenario uses one set of setup options, so the reference
compiles its super-step programs once.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the tensors here are small, and a pool in each
# test process oversubscribes the cores when test files run in parallel
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import repro.api as J  # noqa: E402
import repro.service as JS  # noqa: E402
import repro.testing as JT  # noqa: E402
import repro.testing.faults as JF  # noqa: E402
import repro_torch.api as T  # noqa: E402
import repro_torch.service as TS  # noqa: E402
import repro_torch.testing as TT  # noqa: E402
from repro_torch.testing.faults import site_key  # noqa: E402
from repro_torch.core import cycles, krylov  # noqa: E402
from repro_torch.checkpoint import latest_step  # noqa: E402
from repro_torch.graphs.generators import (barabasi_albert,  # noqa: E402
                                           ensure_connected, grid_2d, star)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(coarsest_size=32, setup_bucket_floor=2048, max_iters=200)
COUNTERS = ("requests", "served", "flushes", "setup_batches",
            "setups_batched", "setups_looped", "solve_blocks", "rhs_columns",
            "failures", "setup_retries", "solve_retries", "retries",
            "fallbacks", "deadline_expired", "triage_routed", "rejected",
            "requeued", "breaker_opened", "checkpoints", "resumed",
            "queue_depth", "batch_occupancy")
CACHE_COUNTERS = ("size", "hits", "misses", "evictions", "invalidations")


@pytest.fixture(scope="module", autouse=True)
def _stable_site_key():
    """The port draws its faults from a stable key of the site name
    (``site_key``); the reference's module ``hash`` is shadowed with the
    same key, so one plan armed on both packages corrupts the same entries
    whatever ``PYTHONHASHSEED`` is."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JF, "hash", site_key, raising=False)
        yield


class Pkg:
    """One package's api, service and fault harness, and its options."""

    def __init__(self, api, service, testing, **opt):
        self.api, self.service, self.testing, self._opt = (api, service,
                                                           testing, opt)

    def opts(self, **kw):
        return self.api.SolverOptions(**{**KW, **self._opt, **kw})

    def problem(self, name):
        return self.api.Problem.from_edges(*GRAPHS[name])

    def svc(self, backend="single", **kw):
        opt = {k: kw.pop(k) for k in list(kw)
               if k in ("triage", "verify", "checkpoint_every")}
        return self.service.SolverService(self.opts(**opt), backend=backend,
                                          **kw)

    def plan(self, site, mode="raise", at_calls=(0,)):
        F = self.testing
        return F.inject(F.FaultPlan({site: F.Fault(mode=mode,
                                                   at_calls=at_calls)}))


PKGS = {"ref": Pkg(J, JS, JT), "port": Pkg(T, TS, TT, device="cpu")}


def _hopeless():
    """``tests/test_service_checkpoint.py``'s hopeless problem: a
    pair-symmetric 1e16 weight scaling, far past float32's reach."""
    n, r, c, v = ensure_connected(*grid_2d(12, 12))
    r, c = np.asarray(r), np.asarray(c)
    v = np.where(np.minimum(r, c) % 2 == 0, np.asarray(v) * 1e16,
                 np.asarray(v, np.float64))
    return n, r, c, v


GRAPHS = {
    "grid0": ensure_connected(*grid_2d(10, 10, weighted=True, seed=0)),
    "grid1": ensure_connected(*grid_2d(10, 10, weighted=True, seed=1)),
    "ba": ensure_connected(*barabasi_albert(120, m=3, seed=1,
                                            weighted=True)),
    "star": star(64),
    "hopeless": _hopeless(),
}


STAR = T.Problem.from_edges(*GRAPHS["star"]).fingerprint()


def rhs(seed, n, k=None):
    b = np.random.default_rng(seed).normal(size=n if k is None else (n, k))
    return (b - b.mean(axis=0)).astype(np.float32)


# ----------------------------------------------------------------------
# request streams; each returns (services, tickets)
# ----------------------------------------------------------------------
def sc_stream(pkg, tmp, max_batch=8):
    """Four same-bucket problems, a merged block with a per-ticket tol, a
    per-ticket max_iters, then the first request again (a cache hit)."""
    pa, pb, pc, pd = map(pkg.problem, ("grid0", "grid1", "ba", "star"))
    svc = pkg.svc(max_batch=max_batch)
    ts = [svc.submit(pa, rhs(1, pa.n)),
          svc.submit(pa, rhs(2, pa.n, 3), tol=1e-6),
          svc.submit(pb, rhs(3, pb.n)),
          svc.submit(pc, rhs(4, pc.n, 2), max_iters=4),
          svc.submit(pd, rhs(5, pd.n))]
    svc.flush()
    ts.append(svc.submit(pa, rhs(1, pa.n)))
    svc.flush()
    return [svc], ts


def sc_faults(pkg, tmp):
    """A raising batched setup (per-ticket retries), a raising merged
    solve (per-ticket retries), and a ticket whose every serve raises."""
    pa, pb = map(pkg.problem, ("grid0", "ba"))
    svc = pkg.svc()
    with pkg.plan("service.setup"):
        ts = [svc.submit(pa, rhs(6, pa.n)), svc.submit(pb, rhs(7, pb.n))]
        svc.flush()
    with pkg.plan("service.solve"):
        ts += [svc.submit(pa, rhs(8, pa.n)), svc.submit(pa, rhs(9, pa.n))]
        svc.flush()
    with pkg.plan("service.solve", at_calls=None):
        ts.append(svc.submit(pb, rhs(10, pb.n)))
        svc.flush()
    return [svc], ts


def sc_fallback(pkg, tmp):
    """A NaN SpMV inside a merged block: the broken ticket walks the
    facade's ladder, its sibling does not."""
    pa, pb = map(pkg.problem, ("grid1", "star"))
    svc = pkg.svc(verify="cheap")
    with pkg.plan("solve.spmv", mode="nan", at_calls=(2,)):
        ts = [svc.submit(pa, rhs(11, pa.n)), svc.submit(pb, rhs(12, pb.n))]
        svc.flush()
    return [svc], ts


def sc_triage(pkg, tmp):
    """Admission triage routes the hopeless problem past setup; the clean
    one keeps the multigrid path, certified."""
    ph, pc = map(pkg.problem, ("hopeless", "ba"))
    svc = pkg.svc(triage=True, verify="cheap")
    ts = [svc.submit(ph, rhs(13, ph.n)), svc.submit(pc, rhs(14, pc.n))]
    svc.flush()
    return [svc], ts


def sc_strict(pkg, tmp):
    """Strict admission: triage rejection, requeue with backoff, requeue
    exhaustion, the breaker opening, then the watermark."""
    ph, pa, pb = map(pkg.problem, ("hopeless", "grid0", "ba"))
    svc = pkg.svc(admission="strict", queue_watermark=2,
                  breaker_threshold=2, requeue_max=1)
    ts = [svc.submit(ph, rhs(15, ph.n))]
    with pkg.plan("service.solve", at_calls=None):
        ts.append(svc.submit(pa, rhs(16, pa.n)))
        svc.flush()                     # fails -> requeued
        svc.flush()                     # backing off
        svc.flush()                     # fails again -> failed for good
    ts.append(svc.submit(pa, rhs(17, pa.n)))      # breaker open
    ts += [svc.submit(pb, rhs(18 + i, pb.n)) for i in range(3)]
    svc.flush()
    return [svc], ts


def sc_deadline(pkg, tmp):
    pa, pb = map(pkg.problem, ("grid0", "grid1"))
    svc = pkg.svc()
    ts = [svc.submit(pa, rhs(21, pa.n)), svc.submit(pb, rhs(22, pb.n))]
    svc.flush(deadline=1e-9)
    return [svc], ts


def ckpt_requests(pkg):
    return [(p, rhs(30 + i, p.n)) for i, p in
            enumerate(map(pkg.problem, ("grid0", "grid1", "ba")))]


def sc_checkpoint(pkg, tmp):
    """Snapshots at every solve group; a fresh service resumes the first
    snapshot and replays the rest."""
    d = str(tmp / "ckpt")
    svc1 = pkg.svc(checkpoint_every=1, checkpoint_dir=d)
    ts = [svc1.submit(p, b) for p, b in ckpt_requests(pkg)]
    svc1.flush()
    svc2 = pkg.svc(checkpoint_every=1, checkpoint_dir=str(tmp / "ckpt2"))
    ts += [svc2.submit(p, b) for p, b in ckpt_requests(pkg)]
    assert svc2.resume(directory=d, step=0) == 1
    svc2.flush()
    return [svc1, svc2], ts


SCENARIOS = {"stream": sc_stream,
             "looped": lambda pkg, tmp: sc_stream(pkg, tmp, max_batch=1),
             "mixed": lambda pkg, tmp: sc_stream(pkg, tmp, max_batch=3),
             "faults": sc_faults, "fallback": sc_fallback,
             "triage": sc_triage, "strict": sc_strict,
             "deadline": sc_deadline, "checkpoint": sc_checkpoint}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for name, fn in SCENARIOS.items():
        for side, pkg in PKGS.items():
            tmp = tmp_path_factory.mktemp(f"{name}-{side}")
            svcs, tickets = fn(pkg, tmp)
            out[name, side] = dict(svcs=svcs, tickets=tickets, tmp=tmp)
    return out


# ----------------------------------------------------------------------
# against the reference
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_counters_equal_reference(runs, name):
    for svc, jsvc in zip(runs[name, "port"]["svcs"],
                         runs[name, "ref"]["svcs"]):
        got, want = svc.stats(), jsvc.stats()
        assert {k: got[k] for k in COUNTERS} == {k: want[k] for k in COUNTERS}
        assert ({k: got["cache"][k] for k in CACHE_COUNTERS}
                == {k: want["cache"][k] for k in CACHE_COUNTERS})


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_results_match_reference(runs, name):
    pairs = list(zip(runs[name, "port"]["tickets"],
                     runs[name, "ref"]["tickets"]))
    assert pairs
    for t, jt in pairs:
        assert (t.status, t.requeues) == (jt.status, jt.requeues)
        assert (t.triage is None) == (jt.triage is None)
        if t.triage is not None:
            assert t.triage.rung == jt.triage.rung
        if t.status in ("failed", "rejected"):
            err = pytest.raises(TS.ServiceError, t.result)
            jerr = pytest.raises(JS.ServiceError, jt.result)
            assert type(t.error).__name__ == type(jt.error).__name__
            assert str(err.value).split(":")[0] == \
                str(jerr.value).split(":")[0]
            continue
        if t.status != "done":
            continue
        (x, res), (jx, jres) = t.result(), jt.result()
        assert isinstance(x, np.ndarray) and x.shape == np.shape(jx)
        assert res.status == jres.status
        assert res.backend == jres.backend and res.n_rhs == jres.n_rhs
        if t.problem.fingerprint() == STAR:
            # ROADMAP C6: one iteration solves the star exactly and leaves
            # float32 rounding noise next to tol 1e-8, whose size follows
            # the order of the float32 sums (test_star_bitwise_with_the_
            # reference_reductions shows it)
            assert np.abs(res.iters_per_rhs - jres.iters_per_rhs).max() <= 1
        else:
            np.testing.assert_array_equal(res.iters_per_rhs,
                                          jres.iters_per_rhs)
        assert np.asarray(res.statuses).tolist() == \
            np.asarray(jres.statuses).tolist()
        assert [d["stage"] for d in res.diagnostics] == \
            [d["stage"] for d in jres.diagnostics]
        assert (res.certificate is None) == (jres.certificate is None)
        if res.certificate is not None:
            assert res.certificate.passed == jres.certificate.passed
        np.testing.assert_allclose(x, np.asarray(jx), rtol=1e-5, atol=1e-5)


class _XlaReductions:
    """The ``torch`` module as the port's Krylov layer sees it, with
    ``dot`` and ``linalg.norm`` taken by XLA on the same float32 values
    (as ``tests/test_torch_serial_ref.py``'s ``xla_reductions``)."""

    class linalg:
        @staticmethod
        def norm(v):
            return torch.from_numpy(np.array(jnp.linalg.norm(v.numpy())))

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def dot(a, b):
        return torch.from_numpy(np.array(jnp.vdot(a.numpy(), b.numpy())))


@pytest.mark.parametrize("random_ordering", [True, False])
def test_star_bitwise_with_the_reference_reductions(monkeypatch,
                                                    random_ordering):
    """ROADMAP C6's witness: on the star ticket's problem and right-hand
    side, both packages build the same relabeling and levels, and with the
    port's float32 reductions (dot products, norms, whole-tensor means and
    the coarse dense product) taken by XLA, and the reference's λmax and
    coarse inverse, the port's history, iteration count and solution are
    bitwise the reference's."""
    b = rhs(5, GRAPHS["star"][0])
    solvers = [pkg.api.setup(pkg.problem("star"), pkg.opts(
        random_ordering=random_ordering), cache=False)._handle._solver
        for pkg in (PKGS["ref"], PKGS["port"])]
    ref, port = solvers
    assert port.stats() == ref.stats()
    if random_ordering:
        np.testing.assert_array_equal(port.perm, np.asarray(ref.perm))
    x_ref, want = ref.solve(b, tol=1e-8, maxiter=200)
    mean = torch.Tensor.mean

    def whole_mean(self, *args, **kw):
        if args or kw:
            return mean(self, *args, **kw)
        return torch.from_numpy(np.array(jnp.mean(self.numpy())))

    def coarse_solve(coarse_inv, rhs_):
        x = jnp.asarray(coarse_inv.numpy()) @ jnp.asarray(rhs_.numpy())
        return torch.from_numpy(np.array(x - jnp.mean(x)))

    monkeypatch.setattr(krylov, "torch", _XlaReductions())
    monkeypatch.setattr(torch.Tensor, "mean", whole_mean)
    monkeypatch.setattr(cycles, "coarse_solve", coarse_solve)
    h = ref.hierarchy
    monkeypatch.setattr(port, "hierarchy", dataclasses.replace(
        port.hierarchy,
        lam_maxes=tuple(torch.tensor(float(x)) for x in h.lam_maxes),
        coarse_inv=torch.from_numpy(np.array(h.coarse_inv))))
    x, got = port.solve(b, tol=1e-8, maxiter=200)
    assert got.iters == want.iters
    assert list(got.residual_norms) == list(want.residual_norms)
    np.testing.assert_array_equal(x.numpy(), np.asarray(x_ref))


def test_scenarios_reach_every_counter(runs):
    """The streams above drive each counter the comparison holds."""
    seen = {k: 0 for k in COUNTERS}
    for (name, side), run in runs.items():
        if side == "port":
            for svc in run["svcs"]:
                for k in COUNTERS:
                    seen[k] = max(seen[k], svc.stats()[k])
    assert all(seen[k] > 0 for k in COUNTERS if k != "queue_depth"), seen


# ----------------------------------------------------------------------
# bitwise contracts within the port
# ----------------------------------------------------------------------
def test_results_equal_direct_solves(runs):
    """Each ticket's slice of a merged block equals the same columns
    solved alone through the facade, bit for bit."""
    tickets = runs["stream", "port"]["tickets"]
    for t in tickets[:5]:
        x, res = t.result()
        solver = T.setup(t.problem, PKGS["port"].opts(), backend="single",
                         cache=False)
        b = t._B[:, 0] if t._single else t._B
        xd, rd = solver.solve(b, tol=t.tol, max_iters=t.max_iters)
        np.testing.assert_array_equal(x, xd)
        np.testing.assert_array_equal(res.iters_per_rhs, rd.iters_per_rhs)


@pytest.mark.parametrize("other", ["looped", "mixed"])
def test_batched_equals_looped(runs, other):
    stats = runs[other, "port"]["svcs"][0].stats()
    assert stats["setups_looped"] > 0
    for t, u in zip(runs["stream", "port"]["tickets"],
                    runs[other, "port"]["tickets"]):
        np.testing.assert_array_equal(t.result()[0], u.result()[0])


def test_repeat_stream_is_a_cache_hit(runs):
    svc = runs["stream", "port"]["svcs"][0]
    tickets = runs["stream", "port"]["tickets"]
    st = svc.stats()
    assert st["cache"]["hits"] == 1 and st["cache"]["misses"] == 4
    assert st["setups_batched"] == 4 and st["setup_batches"] == 1
    np.testing.assert_array_equal(tickets[5].result()[0],
                                  tickets[0].result()[0])
    assert tickets[5].result()[1].setup_seconds == 0.0


def test_resume_is_bitwise(runs):
    tickets = runs["checkpoint", "port"]["tickets"]
    first, resumed = tickets[:3], tickets[3:]
    for t, u in zip(first, resumed):
        (x, res), (y, ures) = t.result(), u.result()
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(res.iters_per_rhs, ures.iters_per_rhs)
        assert res.status == ures.status
        assert list(res.statuses) == list(ures.statuses)
    svc1 = runs["checkpoint", "port"]["svcs"][0]
    assert svc1.stats()["checkpoints"] == 3      # one per solve group


@pytest.mark.parametrize("saved_by,resumed_by", [("ref", "port"),
                                                 ("port", "ref")])
def test_resume_across_packages(runs, saved_by, resumed_by):
    """A snapshot written by one package's service resumes in the other's:
    every ticket pairs (fingerprint + RHS hash + stopping params) and gets
    the saved arrays bit for bit."""
    src = runs["checkpoint", saved_by]
    d = str(src["tmp"] / "ckpt")
    pkg = PKGS[resumed_by]
    svc = pkg.svc(checkpoint_every=1, checkpoint_dir=d)
    tickets = [svc.submit(p, b) for p, b in ckpt_requests(pkg)]
    assert svc.resume() == 3
    assert svc.stats()["resumed"] == 3 and svc.stats()["queue_depth"] == 0
    for t, s in zip(tickets, src["tickets"][:3]):
        (x, res), (sx, sres) = t.result(), s.result()
        np.testing.assert_array_equal(np.asarray(x), np.asarray(sx))
        np.testing.assert_array_equal(res.residual_norms,
                                      np.asarray(sres.residual_norms))
        assert res.status == sres.status and res.iters == sres.iters


# ----------------------------------------------------------------------
# wall-clock fields as contracts
# ----------------------------------------------------------------------
def test_deadline_fails_unserved_tickets(runs):
    svc = runs["deadline", "port"]["svcs"][0]
    for t in runs["deadline", "port"]["tickets"]:
        assert t.status == "failed"
        with pytest.raises(TS.ServiceError, match="flush deadline"):
            t.result()
    assert svc.stats()["deadline_expired"] == 2
    with pytest.raises(ValueError, match="flush_deadline"):
        TS.SolverService(PKGS["port"].opts(), flush_deadline=0)


def test_checkpoint_wall_snapshots_every_group(tmp_path):
    pkg = PKGS["port"]
    svc = TS.SolverService(pkg.opts(), backend="single",
                           checkpoint_dir=str(tmp_path),
                           checkpoint_wall=1e-9)
    for p, b in ckpt_requests(pkg):
        svc.submit(p, b)
    svc.flush()
    assert svc.stats()["checkpoints"] == 3 and latest_step(str(tmp_path)) == 2
    with pytest.raises(ValueError, match="checkpoint_wall"):
        TS.SolverService(pkg.opts(), checkpoint_wall=-1.0)


def test_stats_wall_clock_fields(runs):
    st = runs["stream", "port"]["svcs"][0].stats()
    lat = st["latency_seconds"]
    assert 0 < lat["p50"] <= lat["p90"] <= lat["p99"]
    assert st["setup_seconds"] > 0 and st["solve_seconds"] > 0
    idle = TS.SolverService(PKGS["port"].opts()).stats()["latency_seconds"]
    assert all(np.isnan(idle[k]) for k in ("p50", "p90", "p99", "mean"))


# ----------------------------------------------------------------------
# options, admission and the kill/resume contract
# ----------------------------------------------------------------------
def test_cache_peek_touches_no_counter():
    """The service's second lookup (``peek``) changes neither the
    hit/miss counters nor the LRU order, as the reference's."""
    for api in (J, T):
        c = api.HierarchyCache(capacity=2)
        c.put("a", 1), c.put("b", 2)
        assert c.peek("a") == 1 and c.peek("z") is None
        c.put("c", 3)                   # "a" is still the LRU entry
        st = c.stats()
        assert "a" not in c and (st["hits"], st["misses"]) == (0, 0)


def test_checkpoint_every_is_accepted():
    """The serving layer is ported, so ``checkpoint_every`` is accepted;
    so is the distributed layer's ``guard_mode``, as the reference takes
    it."""
    assert T.SolverOptions(device="cpu", checkpoint_every=3
                           ).checkpoint_every == 3
    assert T.SolverOptions(device="cpu", guard_mode="postmortem"
                           ).guard_mode == J.SolverOptions(
        guard_mode="postmortem").guard_mode == "postmortem"


BAD_SUBMITS = {
    "complex": lambda n: np.zeros(n, np.complex64),
    "strings": lambda n: np.array(["a"] * n),
    "3d": lambda n: np.zeros((n, 2, 2), np.float32),
    "scalar": lambda n: np.float32(1.0),
    "rows": lambda n: np.zeros(n + 3, np.float32),
    "nan": lambda n: np.where(np.arange(n) == 4, np.nan, 0.0),
}


@pytest.mark.parametrize("case", sorted(BAD_SUBMITS))
def test_submit_validation_matches_reference(case):
    errors = []
    for pkg in PKGS.values():
        p = pkg.problem("grid0")
        with pytest.raises((TypeError, ValueError)) as e:
            pkg.svc().submit(p, BAD_SUBMITS[case](p.n))
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1]
    with pytest.raises(TypeError, match="repro_torch.api.Problem"):
        PKGS["port"].svc().submit(np.eye(4), np.zeros(4, np.float32))


KILL_DRIVER = textwrap.dedent("""
    import sys

    import numpy as np
    from repro_torch.api import Problem, SolverOptions
    from repro_torch.graphs.generators import (barabasi_albert,
                                               ensure_connected, grid_2d)
    from repro_torch.service import SolverService
    from repro_torch.testing import Fault, FaultPlan, inject

    graphs = [ensure_connected(*grid_2d(10, 10, weighted=True, seed=0)),
              ensure_connected(*grid_2d(10, 10, weighted=True, seed=1)),
              ensure_connected(*barabasi_albert(120, m=3, seed=1,
                                                weighted=True))]
    svc = SolverService(SolverOptions(device="cpu", checkpoint_every=1,
                                      **%(kw)r),
                        backend="single", checkpoint_dir=%(ckpt)r)
    for i, g in enumerate(graphs):
        b = np.random.default_rng(30 + i).normal(size=g[0])
        svc.submit(Problem.from_edges(*g), (b - b.mean()).astype(np.float32))
    if any(m.split(".")[0] in ("jax", "repro") for m in sys.modules):
        sys.exit(3)
    with inject(FaultPlan({"service.solve": Fault(mode="kill",
                                                  at_calls=(1,))})):
        svc.flush()
    sys.exit("the kill fault did not fire")
""")


def test_kill_mid_flush_then_resume_bitwise(runs, tmp_path):
    """A process that imports only the port is killed in its second solve
    group (``KILL_EXIT_CODE``); a fresh service here resumes its snapshot
    and the flush equals the uninterrupted one bit for bit."""
    ckpt = str(tmp_path / "ckpt")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    killed = subprocess.run(
        [sys.executable, "-c", KILL_DRIVER % dict(ckpt=ckpt, kw=KW)],
        capture_output=True, text=True, env=env, timeout=300)
    assert killed.returncode == TT.KILL_EXIT_CODE, killed.stderr[-4000:]
    assert latest_step(ckpt) == 0
    pkg = PKGS["port"]
    svc = pkg.svc(checkpoint_every=1, checkpoint_dir=ckpt)
    tickets = [svc.submit(p, b) for p, b in ckpt_requests(pkg)]
    assert svc.resume() == 1
    svc.flush()
    for t, u in zip(tickets, runs["checkpoint", "port"]["tickets"][:3]):
        assert t.status == "done"
        np.testing.assert_array_equal(t.result()[0], u.result()[0])
