"""``repro_torch.spectral`` — spectral applications of the Laplacian solver
(torch port of ``repro.spectral``).

The paper's §1 motivation made executable: graph drawing (embeddings),
spectral clustering/partitioning, effective resistance, and Laplacian
positional encodings, all riding one cached multigrid hierarchy through
the ``repro_torch.api`` facade::

    from repro_torch.api import Problem
    from repro_torch.spectral import lobpcg, spectral_clustering, fiedler

    p = Problem.from_edges(n, rows, cols, vals)
    eig = lobpcg(p, k=8)                      # k smallest nontrivial pairs
    labels = spectral_clustering(p, k=4).labels
    vec, lam2 = fiedler(p)                    # Fiedler bisection input

Every eigensolver iteration's preconditioner application is a blocked
``solve_block`` against the cached hierarchy on the card (the entry
points take ``device="cpu"`` to run on the host) — the
many-heterogeneous-RHS traffic shape the serving layer was built for. The
Rayleigh–Ritz algebra, the k-means and the cut metrics are host numpy
float64, as in the reference.
"""

from repro_torch.spectral.cluster import (ClusterResult, conductance,
                                         cut_weight, fiedler, fiedler_bisect,
                                         kmeans, normalized_cut,
                                         recursive_bisection,
                                         spectral_clustering, sweep_cut)
from repro_torch.spectral.embed import (EmbeddingResult,
                                        incremental_embedding,
                                        spectral_embedding)
from repro_torch.spectral.lobpcg import EigResult, lobpcg, refine_eigenpairs
from repro_torch.spectral.pe import (canonicalize_signs, graph_batch_with_pe,
                                     laplacian_pe)
from repro_torch.spectral.resistance import (ResistanceSketch,
                                             effective_resistance,
                                             exact_effective_resistance)

__all__ = [
    "ClusterResult",
    "EigResult",
    "EmbeddingResult",
    "ResistanceSketch",
    "canonicalize_signs",
    "conductance",
    "cut_weight",
    "effective_resistance",
    "exact_effective_resistance",
    "fiedler",
    "fiedler_bisect",
    "graph_batch_with_pe",
    "incremental_embedding",
    "kmeans",
    "laplacian_pe",
    "lobpcg",
    "normalized_cut",
    "recursive_bisection",
    "refine_eigenpairs",
    "spectral_clustering",
    "spectral_embedding",
    "sweep_cut",
]
