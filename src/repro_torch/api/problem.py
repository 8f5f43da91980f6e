"""``Problem``: a validated graph-Laplacian system, backend-agnostic (torch
port of ``repro.api.problem``; the arrays stay host numpy).

The paper's solver acts on L = diag(deg) − A for a weighted undirected
graph. ``Problem`` is the one place that turns user-facing graph inputs
(edge lists, COO triples, adjacency matrices) into the canonical form every
backend consumes — both edge directions present, no self loops, positive
float weights — and rejects the malformed inputs that the lower layers
would otherwise absorb silently (``to_laplacian_coo`` sums duplicate edges
without complaint; a solver fed an asymmetric adjacency quietly solves the
wrong system).
"""

from __future__ import annotations

import dataclasses

import numpy as np

_DTYPES = {"float32": np.float32, "float64": np.float64}


class ProblemValidationError(ValueError):
    """A graph input failed ``Problem`` validation."""


def _as_dtype(dtype) -> np.dtype:
    if isinstance(dtype, str):
        if dtype not in _DTYPES:
            raise ProblemValidationError(
                f"dtype must be one of {sorted(_DTYPES)}, got {dtype!r}")
        return np.dtype(_DTYPES[dtype])
    dt = np.dtype(dtype)
    if dt not in (np.dtype(np.float32), np.dtype(np.float64)):
        raise ProblemValidationError(
            f"dtype must be float32 or float64, got {dt}")
    return dt


@dataclasses.dataclass(frozen=True, eq=False)
class Problem:
    """A graph-Laplacian system L x = b, ready for any backend.

    ``rows``/``cols``/``vals`` hold the adjacency edge list with BOTH
    directions present (2·|E| entries), no self loops, positive weights.
    Construct via :meth:`from_edges` or :meth:`from_adjacency` — the
    constructors validate; the raw dataclass constructor does not.

    ``dtype`` is the storage dtype policy for the weights (float32 or
    float64). Backends currently compute in float32 (the paper's precision);
    float64 inputs are accepted and cast at setup.
    """

    n: int
    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    dtype: np.dtype = np.dtype(np.float32)

    # ------------------------------------------------------------------
    @staticmethod
    def from_edges(n: int, rows, cols, vals=None, *,
                   allow_duplicates: bool = False,
                   symmetrize: bool = False,
                   dtype="float32") -> "Problem":
        """Build a Problem from an edge list / COO triples.

        ``rows``/``cols`` are vertex indices; ``vals`` are positive edge
        weights (default: all ones). The list must contain both directions
        of every undirected edge — pass ``symmetrize=True`` to supply each
        edge once and have the reverse direction added.

        Validation (raises ``ProblemValidationError``):

        * indices in range ``[0, n)``,
        * no self loops (they contribute nothing to a Laplacian; remove
          them from the input),
        * no duplicate (u, v) entries — duplicates are almost always an
          input bug that would silently *sum* into one heavier edge; pass
          ``allow_duplicates=True`` to keep that summing behavior,
        * weights positive and finite,
        * the (possibly symmetrized) list is symmetric: (u, v) and (v, u)
          both present with equal weight.
        """
        dt = _as_dtype(dtype)
        if n < 1:
            raise ProblemValidationError(f"n must be >= 1, got {n}")
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        if rows.ndim != 1 or cols.ndim != 1 or rows.shape != cols.shape:
            raise ProblemValidationError(
                f"rows/cols must be equal-length 1-D arrays, got shapes "
                f"{rows.shape} and {cols.shape}")
        if not (np.issubdtype(rows.dtype, np.integer)
                and np.issubdtype(cols.dtype, np.integer)):
            raise ProblemValidationError(
                f"rows/cols must be integer arrays, got {rows.dtype} and "
                f"{cols.dtype}")
        if vals is None:
            vals = np.ones(len(rows), dt)
        vals = np.asarray(vals)
        if vals.shape != rows.shape:
            raise ProblemValidationError(
                f"vals must match rows/cols length, got {vals.shape} vs "
                f"{rows.shape}")
        rows = rows.astype(np.int64)
        cols = cols.astype(np.int64)
        vals = vals.astype(dt)

        oob = (rows < 0) | (rows >= n) | (cols < 0) | (cols >= n)
        if oob.any():
            i = int(np.flatnonzero(oob)[0])
            raise ProblemValidationError(
                f"edge {i} = ({rows[i]}, {cols[i]}) has a vertex index "
                f"outside [0, {n})")
        loops = rows == cols
        if loops.any():
            i = int(np.flatnonzero(loops)[0])
            raise ProblemValidationError(
                f"self-loop at vertex {rows[i]} (edge {i}): self loops do "
                f"not contribute to a graph Laplacian — remove them from "
                f"the input")
        if not np.isfinite(vals).all():
            i = int(np.flatnonzero(~np.isfinite(vals))[0])
            raise ProblemValidationError(
                f"edge {i} has non-finite weight {vals[i]}")
        if (vals <= 0).any():
            i = int(np.flatnonzero(vals <= 0)[0])
            raise ProblemValidationError(
                f"edge {i} = ({rows[i]}, {cols[i]}) has non-positive weight "
                f"{vals[i]}: the paper's solver assumes positively weighted "
                f"graphs")

        if symmetrize:
            rows, cols = (np.concatenate([rows, cols]),
                          np.concatenate([cols, rows]))
            vals = np.concatenate([vals, vals])

        key = rows * n + cols
        uniq, first_idx, counts = np.unique(key, return_index=True,
                                            return_counts=True)
        if (counts > 1).any():
            if not allow_duplicates:
                i = int(first_idx[np.flatnonzero(counts > 1)[0]])
                raise ProblemValidationError(
                    f"duplicate edge ({rows[i]}, {cols[i]}) appears "
                    f"{int(counts[np.flatnonzero(counts > 1)[0]])} times: "
                    f"duplicates would silently sum into one heavier edge; "
                    f"pass allow_duplicates=True to keep that behavior")
            # keep the summing semantics but collapse here so the symmetry
            # check below sees one entry per direction
            sums = np.zeros(len(uniq), dt)
            np.add.at(sums, np.searchsorted(uniq, key), vals)
            rows = (uniq // n).astype(np.int64)
            cols = (uniq % n).astype(np.int64)
            vals = sums

        # symmetry: the reverse of every edge must be present, equal weight
        rev_key = cols * n + rows
        order = np.argsort(rows * n + cols, kind="stable")
        rev_order = np.argsort(rev_key, kind="stable")
        if not (np.array_equal((rows * n + cols)[order], rev_key[rev_order])
                and np.allclose(vals[order], vals[rev_order], rtol=1e-6)):
            raise ProblemValidationError(
                "edge list is not symmetric: every undirected edge must "
                "appear as both (u, v) and (v, u) with equal weight — pass "
                "symmetrize=True to supply each edge once")

        return Problem(n=int(n), rows=rows.astype(np.int32),
                       cols=cols.astype(np.int32), vals=vals, dtype=dt)

    # ------------------------------------------------------------------
    @staticmethod
    def from_adjacency(a, *, dtype="float32") -> "Problem":
        """Build a Problem from a dense numpy or scipy.sparse adjacency.

        The matrix must be symmetric with non-negative entries; the diagonal
        must be zero (self loops are rejected, as in :meth:`from_edges`).
        Duplicate entries in a scipy COO are summed first — scipy's own
        semantics for them.
        """
        try:
            import scipy.sparse as sp
            is_sparse = sp.issparse(a)
        except ImportError:                           # pragma: no cover
            is_sparse = False
        if is_sparse:
            coo = a.tocoo(copy=True)
            if coo.shape[0] != coo.shape[1]:
                raise ProblemValidationError(
                    f"adjacency must be square, got {coo.shape}")
            coo.sum_duplicates()
            n, r, c, v = coo.shape[0], coo.row, coo.col, coo.data
        else:
            a = np.asarray(a)
            if a.ndim != 2 or a.shape[0] != a.shape[1]:
                raise ProblemValidationError(
                    f"adjacency must be a square matrix, got shape {a.shape}")
            r, c = np.nonzero(a)
            n, v = a.shape[0], a[r, c]
        try:
            return Problem.from_edges(n, r, c, v, dtype=dtype)
        except ProblemValidationError as e:
            if "not symmetric" in str(e):
                raise ProblemValidationError(
                    "adjacency matrix is not symmetric: A[u, v] must equal "
                    "A[v, u] for an undirected graph Laplacian") from None
            raise

    # ------------------------------------------------------------------
    def fingerprint(self) -> str:
        """Stable content digest of the system (hex sha256, memoized).

        Two Problems share a fingerprint iff they describe the same
        Laplacian under the same storage-dtype policy: the digest covers
        ``n``, the dtype name, and the edge list canonicalized by sorting
        on (row, col) — so it is insensitive to the order edges were
        supplied in, and sensitive to any weight change, including the
        rounding a float64 -> float32 drift would introduce (the dtype
        name *and* the weight bytes in storage dtype are both hashed).

        This is the content address the :class:`~repro_torch.api.cache.
        HierarchyCache` keys on; it equals the reference's digest for the
        same inputs.
        """
        cached = self.__dict__.get("_fingerprint")
        if cached is not None:
            return cached
        import hashlib

        rows = np.ascontiguousarray(self.rows, np.int64)
        cols = np.ascontiguousarray(self.cols, np.int64)
        order = np.lexsort((cols, rows))
        h = hashlib.sha256()
        h.update(b"repro.problem/v1\0")
        h.update(int(self.n).to_bytes(8, "little"))
        h.update(np.dtype(self.dtype).name.encode() + b"\0")
        h.update(rows[order].tobytes())
        h.update(cols[order].tobytes())
        h.update(np.ascontiguousarray(
            np.asarray(self.vals, self.dtype)[order]).tobytes())
        digest = h.hexdigest()
        object.__setattr__(self, "_fingerprint", digest)
        return digest

    def components(self) -> tuple[np.ndarray, int]:
        """Connected components: ``(labels, n_components)``, memoized.

        ``labels`` is an int32 (n,) array of 0-based component ids. A
        connected graph returns ``n_components == 1``. The facade's
        fallback solvers and the pathological-input tests use this to
        build per-component nullspace projections
        (``repro_torch.core.components``).
        """
        cached = self.__dict__.get("_components")
        if cached is None:
            from repro_torch.core.components import connected_components

            cached = connected_components(self.n, self.rows, self.cols)
            object.__setattr__(self, "_components", cached)
        return cached

    def bucket_signature(self, floor: int = 0) -> tuple[int, int]:
        """The capacity buckets this problem's setup pads to.

        ``(pow2_bucket(n, floor), pow2_bucket(2|E|, floor))`` — the
        padding shapes that decide compiled super-step program reuse, and
        the grouping key the serving layer batches setups by. ``floor``
        is ``SolverOptions.setup_bucket_floor``.
        """
        from repro_torch.core.graph import pow2_bucket

        return (pow2_bucket(self.n, floor),
                pow2_bucket(len(self.rows), floor))

    # ------------------------------------------------------------------
    @property
    def n_vertices(self) -> int:
        return self.n

    @property
    def n_edges(self) -> int:
        """Undirected edge count (the stored list has both directions)."""
        return len(self.rows) // 2

    def degrees(self) -> np.ndarray:
        """Weighted vertex degrees diag(L)."""
        deg = np.zeros(self.n, self.dtype)
        np.add.at(deg, self.rows, self.vals)
        return deg

    def to_laplacian_coo(self, capacity: int | None = None, device=None):
        """The padded adjacency COO the core hierarchy builders consume, on
        ``device`` (default: the CUDA card)."""
        from repro_torch.graphs.generators import to_laplacian_coo

        return to_laplacian_coo(self.n, self.rows, self.cols,
                                self.vals.astype(np.float32),
                                capacity=capacity, device=device)
