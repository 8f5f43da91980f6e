"""Multigrid core: levels, setup, smoothers, cycles and PCG."""
