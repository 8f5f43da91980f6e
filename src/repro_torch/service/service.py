"""``SolverService``: admission, batching, and dispatch for solve requests
(torch port of ``repro.service.service``).

A request is ``(Problem, RHS block)`` plus optional per-request stopping
overrides. The service is a **deterministic synchronous driver** — no
threads, no executors: ``submit()`` only enqueues and returns a
:class:`Ticket`; ``flush()`` does all the work in a fixed order
(setup-by-bucket, then solve-by-fingerprint, both sorted), so a given
request stream always produces the same batches and the same answers.
The backends run on ``SolverOptions.device`` (default: the CUDA card);
requests and results are host numpy arrays.

``flush()`` runs two passes:

1. **Setup pass** — requests whose hierarchy is not in the cache are
   grouped by ``Problem.bucket_signature()``; groups of two or more
   same-bucket problems on the ``single`` super-step backend build through
   ``LaplacianSolver.setup_batch`` (bit-identical to looped setups),
   capped at ``max_batch`` per batch; everything else builds looped. All
   results land in the cache, so a re-submitted problem never sets up
   again.
2. **Solve pass** — requests are grouped by hierarchy (cache key); each
   group's RHS columns concatenate into one ``solve_block`` call with
   per-column tol/max-iters arrays (``pcg_block`` accepts both), and the
   lockstep history is sliced back into per-request
   :class:`~repro_torch.api.result.SolveResult`\\ s. With
   ``exact_columns`` each slice is bitwise the same columns solved alone.

``stats()`` surfaces the serving counters: queue depth, setup batch
occupancy, cache hit rate, and end-to-end request latency percentiles.

Fault isolation: one poisoned request cannot take down a flush. Setup and
solve groups run under per-group exception isolation — a failed batched
group is retried per-ticket (capped at one retry per ticket), and a
ticket that still fails carries the exception on ``Ticket.error`` while
the rest of the flush completes. Per-column Krylov breakdowns route the
affected ticket through the facade's degradation ladder (rebuild →
diag-CG → dense; ``SolverOptions.fallback``), which also evicts the
poisoned hierarchy from the cache. An optional per-flush deadline budget
bounds tail latency: requests not served when the budget runs out fail
with an explicit deadline error instead of holding the flush open.

Hardening of the serving loop:

* **Admission triage** (``SolverOptions(triage=True)``): ``submit()``
  scores each problem's conditioning (``repro_torch.api.triage``) and
  records the report on ``Ticket.triage``. Tickets routed to the
  ``diag_pcg`` / ``dense`` rungs bypass hierarchy setup entirely;
  ``multigrid_strict`` tickets solve in their own groups under the
  tightened guard.
* **Checkpoint/restart**: with ``checkpoint_dir=...`` and
  ``SolverOptions(checkpoint_every=N)`` (or a ``checkpoint_wall`` seconds
  budget), ``flush()`` snapshots completed-ticket results at solve-group
  boundaries through ``repro_torch.checkpoint`` (the reference's on-disk
  layout, so either package resumes the other's snapshot). After a
  crash, re-submit the same requests and call :meth:`SolverService.
  resume` — completed work is installed from the snapshot (matched by
  problem fingerprint + RHS content hash + stopping params) and the next
  ``flush()`` replays only unfinished work, bit-matching an uninterrupted
  flush.
* **Retry accounting**: setup and solve retries are counted separately
  (``stats()["setup_retries"]`` / ``["solve_retries"]``; ``"retries"``
  is their sum), and a retry that succeeds clears any stale
  ``Ticket.error`` left by an earlier failed attempt of the same
  hierarchy.

Strict admission and backpressure (``SolverService(admission="strict")``;
the default ``"route"`` admits every well-formed request):

* **Reject at the door**: a submit is turned away
  (``Ticket.status == "rejected"``, counted in ``stats()["rejected"]``)
  when the problem's per-fingerprint circuit breaker is open, when the
  queue sits at its ``queue_watermark``, or when admission triage routes
  the problem off the multigrid path entirely.
* **Requeue with deterministic backoff**: a ticket whose serve failed is
  re-enqueued instead of failed (up to ``requeue_max`` times), eligible
  again after a flush-count backoff of ``min(2**requeues, 8)`` flushes —
  no wall-clock randomness, so a given request stream still replays
  exactly. Counted in ``stats()["requeued"]``.
* **Circuit breaker**: ``breaker_threshold`` consecutive failed or
  certificate-failing serves of the same problem fingerprint open its
  breaker (strict admission then rejects that problem); one healthy
  serve closes it again.

With ``SolverOptions(verify=...)`` on, every served ticket is also
independently certified (``repro_torch.core.verify.certify``) exactly
like the facade path: a certificate-failing merged-solve slice is
re-routed through the degradation ladder, and ``SolveResult.certificate``
rides every result.
"""

from __future__ import annotations

import hashlib
import json
import time

import numpy as np

from repro_torch.api.backends import _EagerHandle, default_mesh
from repro_torch.api.cache import HierarchyCache
from repro_torch.api.facade import Solver as _FacadeSolver
from repro_torch.api.options import SolverOptions
from repro_torch.api.problem import Problem
from repro_torch.api.registry import get_backend, resolve_backend
from repro_torch.api.result import (SolveResult, has_breakdown,
                                    result_from_history)
from repro_torch.testing import faults

# Backends whose solve_block accepts per-column (k,) tol / max-iters
# arrays; other backends get one solve_block call per request.
_BLOCKABLE = ("single", "serial_ref")

# Triage rungs that never touch the multigrid hierarchy (setup bypassed).
_ROUTED_RUNGS = ("diag_pcg", "dense")


def _routed(t) -> bool:
    return t.triage is not None and t.triage.rung in _ROUTED_RUNGS


def _b_sha(B: np.ndarray) -> str:
    """Content hash of an RHS block (dtype + shape + bytes) — pairs with
    ``Problem.fingerprint()`` to match checkpointed results on resume.
    The reference's hash, so snapshots pair across the two packages."""
    a = np.ascontiguousarray(B)
    h = hashlib.sha256()
    h.update(repr((a.dtype.str, a.shape)).encode())
    h.update(a.tobytes())
    return h.hexdigest()


def _json_safe(obj):
    """Round-trip through JSON (default=str) so diagnostics entries with
    exception reprs or numpy scalars become manifest-storable."""
    return json.loads(json.dumps(obj, default=str))


class ServiceError(RuntimeError):
    """A service request failed, or was used before it was served."""


class Ticket:
    """A submitted request; resolved (or failed) by the next ``flush()``.

    ``status`` is ``"pending"`` → ``"done"`` | ``"failed"``; ``done()``
    says whether the request has been resolved either way. ``result()``
    returns ``(x, SolveResult)`` with ``x`` a host array shaped like the
    submitted ``b`` (a 1-D RHS comes back 1-D) — or raises
    :class:`ServiceError` carrying this ticket's own failure
    (``Ticket.error``) if its serve failed; other tickets in the same
    flush are unaffected.

    Strict admission adds two more states: ``"rejected"`` — the service
    turned the request away at ``submit()`` (``done()`` is True;
    ``result()`` raises with the rejection reason) — and ``"requeued"``
    — the serve failed and the ticket is back in the queue awaiting its
    backoff (``requeues`` counts the attempts so far; ``done()`` stays
    False until a later flush resolves it).

    The RHS is kept as the caller's numpy array, dtype and all: the
    resume hash reads its bytes.
    """

    def __init__(self, seq: int, problem: Problem, B: np.ndarray,
                 single: bool, tol: float, max_iters: int, key: tuple):
        self.seq = seq
        self.problem = problem
        self._B = B
        self._single = single
        self.tol = tol
        self.max_iters = max_iters
        self._key = key
        self._submitted = time.perf_counter()
        self._x: np.ndarray | None = None
        self._result: SolveResult | None = None
        self.error: BaseException | None = None
        # admission-triage report (repro_torch.api.triage.TriageReport)
        # when the service runs with SolverOptions(triage=True) or
        # admission="strict"
        self.triage = None
        # strict-admission state
        self.requeues = 0               # failed serves re-enqueued so far
        self._not_before = 0            # flush number the requeue waits for
        self._rejected: str | None = None   # admission rejection reason

    @property
    def n_rhs(self) -> int:
        return self._B.shape[1]

    @property
    def status(self) -> str:
        if self._rejected is not None:
            return "rejected"
        if self.error is not None:
            return "failed"
        if self._result is not None:
            return "done"
        return "requeued" if self.requeues else "pending"

    def done(self) -> bool:
        return (self._result is not None or self.error is not None
                or self._rejected is not None)

    def result(self) -> tuple[np.ndarray, SolveResult]:
        if self._rejected is not None:
            raise ServiceError(
                f"request {self.seq} rejected at admission: "
                f"{self._rejected}")
        if self.error is not None:
            raise ServiceError(
                f"request {self.seq} failed: {self.error!r}") from self.error
        if self._result is None:
            raise ServiceError(
                "request not served yet — call SolverService.flush() first")
        return self._x, self._result


class SolverService:
    """Admit ``(Problem, RHS)`` requests; batch setups and solves.

    ``options``/``backend``/``mesh`` fix the solver configuration for
    every request (one service = one configuration; run several services
    for several configurations — they can share a ``cache``). ``cache``
    defaults to a private :class:`HierarchyCache`; pass the facade's
    :func:`~repro_torch.api.facade.default_cache` to share hierarchies
    with direct ``repro_torch.api.setup()`` callers. ``max_batch`` caps
    how many same-bucket setups build together in one batch.

    ``admission`` — ``"route"`` (default): every well-formed request is
    admitted and hopeless ones are *routed* to cheaper rungs.
    ``"strict"``: the service may turn requests away — see the module
    docstring. ``queue_watermark`` caps the pending-queue depth under
    strict admission (None = unbounded); ``breaker_threshold``
    consecutive failed/uncertified serves of one problem fingerprint open
    its circuit breaker; a failed ticket is requeued with
    capped-exponential flush-count backoff up to ``requeue_max`` times
    before it fails for good.
    """

    def __init__(self, options: SolverOptions | None = None,
                 backend: str = "auto", mesh=None,
                 cache: HierarchyCache | None = None, max_batch: int = 8,
                 flush_deadline: float | None = None,
                 checkpoint_dir: str | None = None,
                 checkpoint_wall: float | None = None,
                 admission: str = "route",
                 queue_watermark: int | None = None,
                 breaker_threshold: int = 3, requeue_max: int = 2):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if flush_deadline is not None and flush_deadline <= 0:
            raise ValueError(f"flush_deadline must be positive seconds, "
                             f"got {flush_deadline}")
        if checkpoint_wall is not None and checkpoint_wall <= 0:
            raise ValueError(f"checkpoint_wall must be positive seconds, "
                             f"got {checkpoint_wall}")
        if admission not in ("route", "strict"):
            raise ValueError(f"admission must be 'route' or 'strict', "
                             f"got {admission!r}")
        if queue_watermark is not None and queue_watermark < 1:
            raise ValueError(f"queue_watermark must be None or >= 1, "
                             f"got {queue_watermark}")
        if breaker_threshold < 1:
            raise ValueError(f"breaker_threshold must be >= 1, "
                             f"got {breaker_threshold}")
        if requeue_max < 0:
            raise ValueError(f"requeue_max must be >= 0, got {requeue_max}")
        self.options = options or SolverOptions()
        self.admission = admission
        self.queue_watermark = queue_watermark
        self.breaker_threshold = breaker_threshold
        self.requeue_max = requeue_max
        # per-fingerprint consecutive failed/uncertified serve counts; a
        # fingerprint at >= breaker_threshold has its breaker open
        self._breaker: dict[str, int] = {}
        self.backend = resolve_backend(backend, mesh, self.options)
        if self.backend == "dist" and mesh is None:
            # before any cache key is made: the key names the mesh's group
            mesh = default_mesh(self.options.device)
        self.mesh = mesh
        self.cache = cache if cache is not None else HierarchyCache()
        self.max_batch = max_batch
        self.flush_deadline = flush_deadline
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_wall = checkpoint_wall
        self._pending: list[Ticket] = []
        self._seq = 0
        self._latencies: list[float] = []
        self._ckpt_done = 0
        self._ckpt_time = time.perf_counter()
        self._c = dict(requests=0, served=0, flushes=0,
                       setups_batched=0, setups_looped=0,
                       setup_batches=0, solve_blocks=0,
                       rhs_columns=0, solve_seconds=0.0,
                       setup_seconds=0.0,
                       failures=0, setup_retries=0, solve_retries=0,
                       fallbacks=0, deadline_expired=0,
                       triage_routed=0, checkpoints=0, resumed=0,
                       rejected=0, requeued=0, breaker_opened=0)

    # ------------------------------------------------------------------
    def submit(self, problem: Problem, b, *, tol: float | None = None,
               max_iters: int | None = None) -> Ticket:
        """Enqueue L x = b. ``b``: (n,) or (n, k). Returns a Ticket."""
        if not isinstance(problem, Problem):
            raise TypeError(
                f"submit expects a repro_torch.api.Problem, got "
                f"{type(problem).__name__}")
        b = np.asarray(b)
        if not (np.issubdtype(b.dtype, np.floating)
                or np.issubdtype(b.dtype, np.integer)):
            raise TypeError(
                f"b must be a real numeric array (float or int), got dtype "
                f"{b.dtype}: the solver computes in float32")
        if b.ndim not in (1, 2):
            raise ValueError(
                f"b must be 1-D ({problem.n},) — auto-promoted to a "
                f"({problem.n}, 1) block — or 2-D ({problem.n}, k), got a "
                f"{b.ndim}-D array of shape {b.shape}")
        single = b.ndim == 1
        B = b[:, None] if single else b
        if B.shape[0] != problem.n:
            raise ValueError(
                f"b has {B.shape[0]} rows but the Problem has n = "
                f"{problem.n} vertices — the RHS must supply one value per "
                f"vertex (shape ({problem.n},) or ({problem.n}, k))")
        if not np.isfinite(B).all():
            j = int(np.flatnonzero(~np.isfinite(B).all(axis=0))[0])
            raise ValueError(
                f"b contains non-finite values (first bad column: {j}): "
                f"NaN/Inf right-hand sides cannot converge — sanitize the "
                f"request before submitting")
        # Fault site: corruption AFTER admission validation — the harness
        # models an RHS that goes bad in flight (transfer, bitflip),
        # exercising the solve-time guards instead of the admission checks.
        B = faults.site("service.request", B)
        t = Ticket(
            self._seq, problem, B, single,
            self.options.tol if tol is None else float(tol),
            self.options.max_iters if max_iters is None else int(max_iters),
            HierarchyCache.key(problem, self.options, self.backend,
                               self.mesh))
        if self.options.triage or self.admission == "strict":
            # Admission-time conditioning triage: the score is memoized on
            # the Problem, so a re-submitted problem pays only the rung
            # decision. Routed tickets (_ROUTED_RUNGS) never enter the
            # setup pass. Strict admission always triages — the rung
            # decision is its admission test.
            from repro_torch.api.triage import triage_problem

            t.triage = triage_problem(problem, self.options)
        self._seq += 1
        self._c["requests"] += 1
        if self.admission == "strict":
            reason = self._strict_reject_reason(t)
            if reason is not None:
                t._rejected = reason
                self._c["rejected"] += 1
                return t
        self._pending.append(t)
        return t

    def _strict_reject_reason(self, t: Ticket) -> str | None:
        """Why strict admission turns this request away, or None.

        Checked in severity order: an open circuit breaker (this exact
        problem keeps failing), queue backpressure (the watermark is a
        depth the *submitter* sees immediately, not a deadline error
        minutes later), then triage hopelessness (the problem would
        bypass multigrid entirely — strict mode refuses to pretend)."""
        fp = t.problem.fingerprint()
        if self._breaker.get(fp, 0) >= self.breaker_threshold:
            return (f"circuit breaker open for this problem after "
                    f"{self._breaker[fp]} consecutive failed serves")
        if (self.queue_watermark is not None
                and len(self._pending) >= self.queue_watermark):
            return (f"queue watermark reached "
                    f"({len(self._pending)} pending >= "
                    f"{self.queue_watermark})")
        if _routed(t):
            return (f"admission triage routed the problem off the "
                    f"multigrid path (rung={t.triage.rung!r})")
        return None

    # ------------------------------------------------------------------
    def flush(self, deadline: float | None = None) -> list[Ticket]:
        """Serve every pending request; returns the resolved tickets.

        ``deadline`` (seconds; default: the service's ``flush_deadline``)
        bounds this flush's wall clock: when the budget runs out, work
        stops at the next group boundary and every not-yet-served ticket
        fails with an explicit deadline :class:`ServiceError` (counted in
        ``stats()["deadline_expired"]``) instead of holding the flush
        open. Individual setup/solve failures are isolated per ticket —
        see the module docstring.

        Under ``admission="strict"`` a requeued ticket only becomes
        eligible once its flush-count backoff has elapsed (ineligible
        tickets stay queued and are NOT in the returned list), and a
        ticket that fails its serve is requeued instead of resolved,
        up to ``requeue_max`` attempts.
        """
        pending, self._pending = self._pending, []
        if not pending:
            return []
        self._c["flushes"] += 1
        flush_no = self._c["flushes"]
        deferred = [t for t in pending if t._not_before > flush_no]
        if deferred:
            pending = [t for t in pending if t._not_before <= flush_no]
            self._pending.extend(deferred)
            if not pending:
                return []
        budget = self.flush_deadline if deadline is None else deadline
        t_start = time.perf_counter()
        self._ckpt_done = 0
        self._ckpt_time = t_start

        def expired() -> bool:
            return (budget is not None
                    and time.perf_counter() - t_start > budget)

        self._setup_pass(pending, expired)
        self._solve_pass(pending, expired)
        if self._ckpt_enabled():
            # final snapshot: a flush that completes always leaves its
            # full result set restorable, whatever the boundary cadence
            done = sum(1 for t in pending if t._result is not None)
            if done > self._ckpt_done:
                self._write_checkpoint(pending)
        for t in pending:
            if t._result is None and t.error is None:
                t.error = ServiceError(
                    f"flush deadline of {budget}s exceeded before request "
                    f"{t.seq} was served")
                self._c["deadline_expired"] += 1
        for t in pending:
            self._note_outcome(t)
        if self.admission == "strict":
            resolved = []
            for t in pending:
                if t.error is not None and t.requeues < self.requeue_max:
                    # deterministic capped-exponential backoff measured in
                    # FLUSHES, not wall clock — replays stay bit-stable
                    t.requeues += 1
                    t._not_before = flush_no + min(2 ** t.requeues, 8)
                    t.error = None
                    self._c["requeued"] += 1
                    self._pending.append(t)
                else:
                    resolved.append(t)
            pending = resolved
        now = time.perf_counter()
        self._latencies.extend(now - t._submitted for t in pending)
        self._c["served"] += sum(t.status == "done" for t in pending)
        return pending

    def _note_outcome(self, t: Ticket) -> None:
        """Feed one served ticket into its problem's circuit breaker:
        consecutive failed or certificate-failing serves accumulate; a
        healthy serve closes the breaker again."""
        fp = t.problem.fingerprint()
        r = t._result
        bad = (t.error is not None or r is None
               or r.status == "failed"
               or (r.certificate is not None and not r.certificate.passed))
        if bad:
            n = self._breaker.get(fp, 0) + 1
            self._breaker[fp] = n
            if n == self.breaker_threshold:
                self._c["breaker_opened"] += 1
        else:
            self._breaker.pop(fp, None)

    # ------------------------------------------------------------------
    def _setup_pass(self, pending: list[Ticket], expired) -> None:
        """Build every missing hierarchy, batching same-bucket ones.

        A chunk that fails (or a raising ``service.setup`` fault) is
        retried per-ticket once; a ticket whose setup still fails carries
        the exception for every request on that hierarchy — the rest of
        the pass continues.
        """
        by_key: dict[tuple, list[Ticket]] = {}
        for t in pending:
            if _routed(t):
                continue        # triage sent it past the hierarchy rungs
            by_key.setdefault(t._key, []).append(t)
        missing: dict[tuple, Ticket] = {}
        for key, ts in by_key.items():
            # One counted lookup per unique hierarchy per flush: the
            # cache's hit/miss stats then read as admission outcomes.
            if self.cache.get(key) is None:
                missing[key] = ts[0]
        if not missing:
            return
        t0 = time.perf_counter()
        can_batch = (self.backend == "single"
                     and self.options.setup_mode == "superstep")
        buckets: dict[tuple, list[Ticket]] = {}
        for key, t in sorted(missing.items(), key=lambda kv: kv[1].seq):
            sig = t.problem.bucket_signature(self.options.setup_bucket_floor)
            buckets.setdefault(sig, []).append(t)
        for sig in sorted(buckets):
            group = buckets[sig]
            while group:
                if expired():
                    self._c["setup_seconds"] += time.perf_counter() - t0
                    return
                chunk, group = group[:self.max_batch], group[self.max_batch:]
                try:
                    faults.checkpoint("service.setup")
                    if can_batch and len(chunk) > 1:
                        self._setup_batched(chunk)
                    else:
                        for t in chunk:
                            self._setup_one(t)
                except Exception:
                    self._c["failures"] += 1
                    self._retry_setups(chunk, by_key, expired)
        self._c["setup_seconds"] += time.perf_counter() - t0

    def _setup_one(self, t: Ticket) -> None:
        self.cache.put(t._key, get_backend(self.backend)(
            t.problem, self.options, self.mesh))
        self._c["setups_looped"] += 1

    def _retry_setups(self, chunk: list[Ticket], by_key: dict,
                      expired) -> None:
        """Per-ticket isolation after a failed setup chunk: one capped
        retry each; a still-failing setup fails only that hierarchy's
        tickets."""
        for t in chunk:
            if expired() or self.cache.peek(t._key) is not None:
                continue
            self._c["setup_retries"] += 1
            try:
                faults.checkpoint("service.setup")
                self._setup_one(t)
                # a sibling ticket's earlier failed attempt may have
                # marked this hierarchy's tickets failed — the hierarchy
                # exists now, so those errors are stale
                for tk in by_key[t._key]:
                    tk.error = None
            except Exception as e:
                self._c["failures"] += 1
                for tk in by_key[t._key]:
                    tk.error = e

    def _setup_batched(self, chunk: list[Ticket]) -> None:
        """One batched super-step setup (``LaplacianSolver.setup_batch``)
        -> len(chunk) cached handles, in the chunk's order."""
        from repro_torch.core.solver import LaplacianSolver

        solvers = LaplacianSolver.setup_batch(
            [(t.problem.n, t.problem.rows, t.problem.cols,
              t.problem.vals.astype(np.float32)) for t in chunk],
            setup_config=self.options.setup_config(),
            cycle_config=self.options.cycle_config(),
            random_ordering=self.options.random_ordering,
            device=self.options.device)
        for t, solver in zip(chunk, solvers):
            self.cache.put(t._key, _EagerHandle(solver, self.options))
        self._c["setup_batches"] += 1
        self._c["setups_batched"] += len(chunk)

    # ------------------------------------------------------------------
    def _solve_pass(self, pending: list[Ticket], expired) -> None:
        """Group same-hierarchy requests into blocked solves.

        Triage-routed tickets solve first (seq order, no hierarchy);
        ``multigrid_strict`` tickets form their own groups so the whole
        group runs under the tightened guard. Completed-ticket snapshots
        are taken at group boundaries (``_maybe_checkpoint``).
        """
        groups: dict[tuple, list[Ticket]] = {}
        routed: list[Ticket] = []
        for t in pending:
            if t.error is not None or t._result is not None:
                continue
            if _routed(t):
                routed.append(t)
            else:
                strict = (t.triage is not None
                          and t.triage.rung == "multigrid_strict")
                groups.setdefault((t._key, strict), []).append(t)
        for t in sorted(routed, key=lambda t: t.seq):
            if expired():
                return
            self._solve_triaged(t)
            self._maybe_checkpoint(pending)
        for gkey in sorted(groups):
            if expired():
                return
            key, strict = gkey
            tickets = sorted(groups[gkey], key=lambda t: t.seq)
            guard = tickets[0].triage.guard if strict else None
            handle = self.cache.peek(key)
            if handle is None:
                err = ServiceError(
                    "no hierarchy for this request (setup failed or the "
                    "flush deadline expired before it was built)")
                for t in tickets:
                    t.error = err
                continue
            if self.backend in _BLOCKABLE:
                self._solve_group(handle, tickets, expired, guard=guard)
                self._maybe_checkpoint(pending)
            else:
                for t in tickets:
                    if expired():
                        return
                    self._solve_group(handle, [t], expired, guard=guard)
                    self._maybe_checkpoint(pending)

    def _facade_solve(self, t: Ticket, handle) -> None:
        """Serve one ticket through the facade (``handle=None``: the
        triage-routed rungs; a handle: its degradation ladder), sharing
        this service's cache, so a poisoned hierarchy is also invalidated
        for future requests."""
        solver = _FacadeSolver(t.problem, self.options, self.backend,
                               handle, 0.0, mesh=self.mesh, cache=self.cache)
        try:
            x, result = solver.solve(t._B[:, 0] if t._single else t._B,
                                     tol=t.tol, max_iters=t.max_iters)
            t._x, t._result, t.error = x, result, None
        except Exception as e:
            self._c["failures"] += 1
            t.error = e

    def _solve_triaged(self, t: Ticket) -> None:
        """Serve one triage-routed ticket (``diag_pcg`` / ``dense`` rung)
        through the facade's rung routing — no hierarchy is built or
        consulted; the triage report leads the result's diagnostics."""
        self._c["triage_routed"] += 1
        self._facade_solve(t, None)

    def _solve_group(self, handle, tickets: list[Ticket], expired,
                     guard=None) -> None:
        """One merged solve with per-ticket fault isolation: a raising
        group is split and retried ticket by ticket (capped at one retry
        each), so a poisoned request fails alone. Tickets the failed
        group attempt already resolved are not re-solved."""
        try:
            faults.checkpoint("service.solve")
            self._solve_merged(handle, tickets, guard=guard)
        except Exception:
            self._c["failures"] += 1
            for t in tickets:
                if expired():
                    return
                if t._result is not None:
                    continue
                self._c["solve_retries"] += 1
                try:
                    faults.checkpoint("service.solve")
                    self._solve_merged(handle, [t], guard=guard)
                except Exception as e2:
                    self._c["failures"] += 1
                    t.error = e2

    def _solve_merged(self, handle, tickets: list[Ticket],
                      guard=None) -> None:
        B = np.concatenate([t._B for t in tickets], axis=1)
        ks = [t.n_rhs for t in tickets]
        if len(tickets) == 1:
            tol, max_iters = tickets[0].tol, tickets[0].max_iters
        else:
            tol = np.concatenate(
                [np.full(k, t.tol) for t, k in zip(tickets, ks)])
            max_iters = np.concatenate(
                [np.full(k, t.max_iters, np.int64)
                 for t, k in zip(tickets, ks)])
        t0 = time.perf_counter()
        kwargs = {} if guard is None else dict(guard=guard)
        X, norms, iters, statuses = handle.solve_block(B, tol, max_iters,
                                                       **kwargs)
        seconds = time.perf_counter() - t0
        self._c["solve_blocks"] += 1
        self._c["rhs_columns"] += B.shape[1]
        self._c["solve_seconds"] += seconds
        lo = 0
        for t, k in zip(tickets, ks):
            sl = slice(lo, lo + k)
            lo += k
            sts = None if statuses is None else np.asarray(statuses)[sl]
            if (sts is not None and has_breakdown(sts)
                    and self.options.fallback):
                self._fallback_ticket(handle, t)
                continue
            # Per-ticket residual certification of the merged block's
            # slice. A failing certificate routes the ticket through the
            # degradation ladder exactly like a detected breakdown (the
            # facade path re-certifies after its rung); with fallback off
            # the columns are marked "sdc_certificate".
            cert = None
            if self.options.verify != "off":
                cert = self._certify_slice(t, norms[:, sl], X[:, sl])
                if not cert.passed:
                    if self.options.fallback:
                        self._fallback_ticket(handle, t)
                        continue
                    sts = _FacadeSolver._mark_cert_failure(sts, cert)
            # Wall-clock attribution: the block ran once; each request
            # reports its share by column count.
            t._result = result_from_history(
                self.backend, norms[:, sl], iters[sl], t.tol,
                handle.work_per_iteration, 0.0,
                seconds * (k / B.shape[1]), statuses=sts,
                diagnostics=(() if t.triage is None
                             else (t.triage.as_diagnostics(),)),
                certificate=cert)
            X_t = np.asarray(X[:, sl])
            t._x = X_t[:, 0] if t._single else X_t
            t.error = None      # a retried solve must not keep a stale error

    def _certify_slice(self, t: Ticket, norms, X):
        """Independent float64 certificate for one ticket's slice of a
        merged solve, judged on the columns whose residual history
        claimed convergence at this ticket's own tolerance."""
        from repro_torch.core.verify import certify

        norms = np.asarray(norms, np.float64)
        with np.errstate(invalid="ignore"):
            claimed = norms[-1] <= t.tol * norms[0]
        return certify(t.problem, t._B, np.asarray(X), t.tol,
                       claimed=claimed)

    def _fallback_ticket(self, handle, t: Ticket) -> None:
        """Route one broken-down ticket through the facade's degradation
        ladder (retry against a rebuilt hierarchy, then diag-CG, then
        dense)."""
        self._c["fallbacks"] += 1
        self._facade_solve(t, handle)

    # ------------------------------------------------------------------
    def _ckpt_enabled(self) -> bool:
        return (self.checkpoint_dir is not None
                and (self.options.checkpoint_every > 0
                     or self.checkpoint_wall is not None))

    def _maybe_checkpoint(self, pending: list[Ticket]) -> None:
        """Snapshot at a solve-group boundary when a ticket-count or
        wall-clock budget has elapsed since the last snapshot."""
        if not self._ckpt_enabled():
            return
        done = sum(1 for t in pending if t._result is not None)
        every = self.options.checkpoint_every
        due = ((every > 0 and done - self._ckpt_done >= every)
               or (self.checkpoint_wall is not None
                   and time.perf_counter() - self._ckpt_time
                   >= self.checkpoint_wall))
        if due and done > self._ckpt_done:
            self._write_checkpoint(pending)

    def _write_checkpoint(self, pending: list[Ticket]) -> None:
        """Persist every completed ticket of this flush as one atomic
        ``repro_torch.checkpoint`` step: result arrays as leaves,
        JSON-safe result scalars + matching identity (problem fingerprint,
        RHS content hash, stopping params) in the manifest."""
        from repro_torch.checkpoint.ckpt import latest_step, save_checkpoint

        done = [t for t in pending if t._result is not None]
        if not done:
            return
        tree: dict = {}
        metas: dict = {}
        for t in done:
            skey = f"{t.seq:06d}"
            r = t._result
            leaves = dict(x=np.asarray(t._x),
                          iters=np.asarray(r.iters_per_rhs),
                          norms=np.asarray(r.residual_norms))
            if r.statuses is not None:
                leaves["statuses"] = np.asarray(r.statuses)
            tree[skey] = leaves
            metas[skey] = dict(
                fingerprint=t.problem.fingerprint(), b_sha=_b_sha(t._B),
                tol=float(t.tol), max_iters=int(t.max_iters),
                single=bool(t._single), backend=r.backend,
                converged=bool(r.converged), iters=int(r.iters),
                wda=float(r.wda),
                work_per_iteration=float(r.work_per_iteration),
                setup_seconds=float(r.setup_seconds),
                solve_seconds=float(r.solve_seconds), n_rhs=int(r.n_rhs),
                status=str(r.status),
                diagnostics=_json_safe(list(r.diagnostics)))
        prev = latest_step(self.checkpoint_dir)
        step = 0 if prev is None else prev + 1
        save_checkpoint(self.checkpoint_dir, step, tree,
                        extra=dict(kind="service-flush", tickets=metas))
        self._c["checkpoints"] += 1
        self._ckpt_done = len(done)
        self._ckpt_time = time.perf_counter()

    def resume(self, directory: str | None = None,
               step: int | None = None) -> int:
        """Install checkpointed results into matching pending tickets.

        After a crash mid-``flush()``, re-submit the same request stream
        and call ``resume()`` before the next ``flush()``: tickets whose
        (problem fingerprint, RHS content hash, tol, max_iters) match a
        completed ticket in the snapshot get its exact saved arrays (the
        replayed flush is bitwise-identical to an uninterrupted one) and
        leave the queue; ``flush()`` then does only the unfinished work.
        Matching is by submission order, so duplicate requests pair up
        deterministically. Returns the number of tickets restored.
        ``directory``/``step`` default to the service's
        ``checkpoint_dir`` and its latest completed step.
        """
        from repro_torch.checkpoint.ckpt import (latest_step,
                                                 load_checkpoint_flat)

        directory = self.checkpoint_dir if directory is None else directory
        if directory is None:
            raise ServiceError(
                "resume needs a checkpoint directory: pass one or "
                "construct the service with checkpoint_dir=...")
        if step is None:
            step = latest_step(directory)
            if step is None:
                return 0
        flat, manifest = load_checkpoint_flat(directory, step)
        saved = manifest.get("extra", {}).get("tickets", {})
        by_sig: dict[tuple, list[str]] = {}
        for skey in sorted(saved, key=int):
            m = saved[skey]
            by_sig.setdefault(
                (m["fingerprint"], m["b_sha"], m["tol"], m["max_iters"]),
                []).append(skey)
        restored: list[Ticket] = []
        for t in sorted(self._pending, key=lambda t: t.seq):
            sig = (t.problem.fingerprint(), _b_sha(t._B), float(t.tol),
                   int(t.max_iters))
            q = by_sig.get(sig)
            if not q:
                continue
            skey = q.pop(0)
            m = saved[skey]
            t._result = SolveResult(
                backend=m["backend"], converged=m["converged"],
                iters=m["iters"], iters_per_rhs=flat[f"{skey}/iters"],
                residual_norms=flat[f"{skey}/norms"], wda=m["wda"],
                work_per_iteration=m["work_per_iteration"],
                setup_seconds=m["setup_seconds"],
                solve_seconds=m["solve_seconds"], n_rhs=m["n_rhs"],
                status=m["status"], statuses=flat.get(f"{skey}/statuses"),
                diagnostics=tuple(m["diagnostics"]))
            t._x = flat[f"{skey}/x"]
            t.error = None
            restored.append(t)
        for t in restored:
            self._pending.remove(t)
        now = time.perf_counter()
        self._latencies.extend(now - t._submitted for t in restored)
        self._c["resumed"] += len(restored)
        self._c["served"] += len(restored)
        return len(restored)

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """Serving counters: queue/batching/cache/latency."""
        c = dict(self._c)
        c["retries"] = c["setup_retries"] + c["solve_retries"]
        lat = np.asarray(self._latencies, np.float64)
        c.update(
            queue_depth=len(self._pending),
            batch_occupancy=(self._c["setups_batched"]
                             / self._c["setup_batches"]
                             if self._c["setup_batches"] else 0.0),
            cache=self.cache.stats(),
            latency_seconds={
                # NaN, not 0.0: an empty sample has no percentiles, and a
                # dashboard aggregating 0.0s as real latencies would lie
                "p50": float(np.percentile(lat, 50)) if lat.size
                else float("nan"),
                "p90": float(np.percentile(lat, 90)) if lat.size
                else float("nan"),
                "p99": float(np.percentile(lat, 99)) if lat.size
                else float("nan"),
                "mean": float(lat.mean()) if lat.size else float("nan"),
            })
        return c
