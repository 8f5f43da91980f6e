"""Seeded synthetic graph generators (numpy) and the paper's named
stand-in graphs."""

from repro_torch.graphs.generators import (
    barabasi_albert,
    erdos_renyi,
    grid_2d,
    delaunay,
    watts_strogatz,
    rmat,
    ensure_connected,
    to_laplacian_coo,
)
from repro_torch.graphs.datasets import paper_graph, PAPER_GRAPHS

__all__ = [
    "barabasi_albert",
    "erdos_renyi",
    "grid_2d",
    "delaunay",
    "watts_strogatz",
    "rmat",
    "ensure_connected",
    "to_laplacian_coo",
    "paper_graph",
    "PAPER_GRAPHS",
]
