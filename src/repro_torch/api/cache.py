"""``HierarchyCache``: content-addressed reuse of multigrid setups (torch
port of ``repro.api.cache``).

The setup phase dominates a single solve. This layer makes hierarchies
reusable across requests: a setup is an immutable artifact addressed by
``(Problem.fingerprint(), bucket signature, options, backend, mesh)``,
and a second ``setup()``/``solve()`` on an equal Problem is a dictionary
lookup with no device work (the facade threads every call through a
default cache; see ``repro_torch.api.facade.setup``). ``options`` carries
the port's ``device``, so the key holds the device too.

The cache stores backend *handles* (the object ``solve_block`` runs
against), so a hit skips hierarchy construction on any backend, and the
LRU bound keeps device memory proportional to the working set, not the
request history.
"""

from __future__ import annotations

from collections import OrderedDict


def _mesh_signature(mesh) -> str | None:
    # the port has no mesh type yet (ROADMAP A11): a mesh keys by its repr
    return None if mesh is None else repr(mesh)


class HierarchyCache:
    """LRU cache of backend handles keyed on problem content + options.

    ``capacity`` bounds the number of retained hierarchies (least
    recently used evicted first). ``stats()`` surfaces hit/miss/eviction
    counters so serving deployments can watch their working set.

    Thread-unaware by design: the facade's default cache is only touched
    from the calling thread.
    """

    def __init__(self, capacity: int = 64):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._entries: OrderedDict = OrderedDict()
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._invalidations = 0

    # ------------------------------------------------------------------
    @staticmethod
    def key(problem, options, backend: str, mesh=None) -> tuple:
        """The cache key: ``(fingerprint, bucket-signature, options,
        backend, mesh-signature)``. ``options`` is a frozen dataclass and
        hashes by value; the bucket signature is technically implied by
        (fingerprint, options) but kept explicit so keys group visibly by
        setup-registry reuse class."""
        return (problem.fingerprint(),
                problem.bucket_signature(options.setup_bucket_floor),
                options, backend, _mesh_signature(mesh))

    def get(self, key):
        """The cached handle for ``key``, or None (counts a hit/miss)."""
        entry = self._entries.get(key)
        if entry is None:
            self._misses += 1
            return None
        self._entries.move_to_end(key)
        self._hits += 1
        return entry

    def peek(self, key):
        """The cached handle for ``key`` or None, WITHOUT touching the
        hit/miss counters or the LRU order (for callers that already
        counted the lookup — e.g. the service's admission probe)."""
        return self._entries.get(key)

    def put(self, key, handle) -> None:
        """Insert (or refresh) ``key``; evicts LRU entries past capacity."""
        if key in self._entries:
            self._entries.move_to_end(key)
        self._entries[key] = handle
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self._evictions += 1

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        return key in self._entries

    def clear(self) -> None:
        """Drop every entry (counters keep accumulating)."""
        self._entries.clear()

    def invalidate(self, fingerprint: str) -> int:
        """Evict every entry for a Problem fingerprint; returns the count.

        The poisoned-hierarchy path: when a cached hierarchy produces a
        Krylov breakdown, the facade's degradation ladder evicts all of
        that problem's entries (every options/backend/mesh variant — the
        setup artifact itself is suspect) before rebuilding, so the bad
        artifact cannot keep serving future requests.
        """
        doomed = [k for k in self._entries if k[0] == fingerprint]
        for k in doomed:
            del self._entries[k]
        self._invalidations += len(doomed)
        return len(doomed)

    def stats(self) -> dict:
        """Size/capacity plus hit/miss/eviction/invalidation counters
        and hit rate."""
        total = self._hits + self._misses
        return dict(size=len(self._entries), capacity=self.capacity,
                    hits=self._hits, misses=self._misses,
                    evictions=self._evictions,
                    invalidations=self._invalidations,
                    hit_rate=(self._hits / total) if total else 0.0)
