"""Named synthetic stand-ins for the paper's evaluation graphs (Fig 3-6;
the port's own copy of ``repro.graphs.datasets``).

Each entry matches the class and rough scale of the original SuiteSparse
/ SNAP graph; ``scale`` shrinks it with the reference's rules, so
``paper_graph`` returns the reference's arrays for the same arguments.
"""

from __future__ import annotations

import math

from repro_torch.graphs import generators as G

# name -> (generator kind, default kwargs, description)
PAPER_GRAPHS = {
    # Internet AS topology snapshots: power-law, ~22k nodes.
    "as-22july06": ("ba", dict(n=22963, m=2), "AS internet topology (power-law)"),
    "as-caida": ("ba", dict(n=26475, m=2), "CAIDA AS graph (power-law)"),
    # Collaboration network: power-law with higher density.
    "ca-AstroPh": ("ba", dict(n=18772, m=11), "astro-ph collaboration"),
    # Census-block planar graph.
    "de2010": ("grid", dict(nx=180, ny=180), "Delaware census blocks (planar)"),
    # Delaunay triangulation of 2^13 points (exact construction, not stand-in).
    "delaunay_n13": ("delaunay", dict(n=8192), "delaunay_n13 (exact class)"),
    # Web crawl: power-law, directed origins; symmetrised.
    "web-NotreDame": ("rmat", dict(scale=15, edge_factor=5), "web crawl (rmat)"),
    "coAuthorsCiteseer": ("ba", dict(n=227320 // 8, m=4), "coauthor network"),
    # Strong-scaling graph: dense power-law (hollywood-2009 is 1.1M/113M; the
    # stand-in keeps the density ratio at reduced n).
    "hollywood-2009": ("ba", dict(n=40000, m=50), "actor collaboration (dense power-law)"),
}


def paper_graph(name: str, scale: float = 1.0, seed: int = 0,
                weighted: bool = False):
    """Return (n, rows, cols, vals) for a named stand-in graph. ``scale``
    multiplies n (a grid's sides by ``scale**0.5``; an rmat graph loses
    ``round(-log2(scale))`` of its scale, down to 6)."""
    kind, kwargs, _ = PAPER_GRAPHS[name]
    kwargs = dict(kwargs)
    if kind == "ba":
        kwargs["n"] = max(int(kwargs["n"] * scale), 16)
        g = G.barabasi_albert(seed=seed, weighted=weighted, **kwargs)
    elif kind == "grid":
        kwargs["nx"] = max(int(kwargs["nx"] * scale**0.5), 4)
        kwargs["ny"] = max(int(kwargs["ny"] * scale**0.5), 4)
        g = G.grid_2d(seed=seed, weighted=weighted, **kwargs)
    elif kind == "delaunay":
        kwargs["n"] = max(int(kwargs["n"] * scale), 16)
        g = G.delaunay(seed=seed, weighted=weighted, **kwargs)
    elif kind == "rmat":
        if scale < 1.0:
            kwargs["scale"] = max(
                kwargs["scale"] - max(int(round(-math.log2(scale))), 0), 6)
        g = G.rmat(seed=seed, weighted=weighted, **kwargs)
    else:  # pragma: no cover
        raise ValueError(kind)
    return G.ensure_connected(*g, seed=seed)
