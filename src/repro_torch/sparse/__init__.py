"""Sparse substrate: padded COO, ELL, segment reductions, matvec dispatch."""
