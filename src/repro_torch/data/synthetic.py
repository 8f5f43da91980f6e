"""Seeded synthetic data: the port's own copy of
``repro.data.synthetic.recsys_batch_stream``.

numpy only, so the stream is bit-identical to the reference's for the same
seed, step and host: deterministic per (seed, step, host), so a restarted
job replays the exact stream from its step.
"""

from __future__ import annotations

import numpy as np


def recsys_batch_stream(vocab_per_field, batch: int, multi_hot: int = 1,
                        seed: int = 0, start_step: int = 0,
                        host_id: int = 0, num_hosts: int = 1):
    """Yields (step, indices [B, F, H] int32 field-local, labels [B])."""
    F = len(vocab_per_field)
    sizes = np.asarray(vocab_per_field)
    b_local = batch // num_hosts
    step = start_step
    while True:
        rng = np.random.default_rng(
            np.random.SeedSequence([seed + 1, step, host_id]))
        u = rng.random((b_local, F, multi_hot))
        idx = np.minimum((u ** -1.1), sizes[None, :, None]).astype(np.int64) - 1
        idx = np.clip(idx, 0, sizes[None, :, None] - 1).astype(np.int32)
        # CTR-like labels correlated with a few feature hashes
        sig = (idx[:, 0, 0] % 7 == 0) | (idx[:, 1, 0] % 11 == 0)
        noise = rng.random(b_local) < 0.15
        labels = (sig ^ noise).astype(np.float32)
        yield step, idx, labels
        step += 1
