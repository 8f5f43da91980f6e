"""deepfm [recsys]: n_sparse=39 embed_dim=10 mlp=400-400-400 interaction=fm
[arXiv:1703.04247]; torch port of ``repro.configs.deepfm``.

Shapes: train_batch (B=65536, train step), serve_p99 (B=512, online
inference), serve_bulk (B=262144, offline scoring), retrieval_cand (B=1
against 10⁶ candidates, FM-decomposed). The port serves the last three;
training is not ported yet.
"""

from __future__ import annotations

from repro_torch.models.recsys.deepfm import DeepFMConfig, default_vocabs

FULL = DeepFMConfig(n_fields=39, embed_dim=10, mlp_sizes=(400, 400, 400),
                    vocab_per_field=default_vocabs(39), multi_hot=2)
SMOKE = DeepFMConfig(n_fields=6, embed_dim=4, mlp_sizes=(16, 16),
                     vocab_per_field=(50, 20, 20, 10, 10, 8), multi_hot=2)

SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")
SHAPE_DIMS = dict(
    train_batch=dict(batch=65536, kind="train"),
    serve_p99=dict(batch=512, kind="serve"),
    serve_bulk=dict(batch=262144, kind="serve"),
    retrieval_cand=dict(batch=1, n_candidates=1_000_000, kind="retrieval"),
)


def _train_flops(cfg: DeepFMConfig, B) -> float:
    """Model FLOPs of one training step of batch ``B`` (forward + backward,
    3× the forward)."""
    d, F = cfg.embed_dim, cfg.n_fields
    mlp = 0
    sizes = [F * d, *cfg.mlp_sizes, 1]
    for a, b in zip(sizes[:-1], sizes[1:]):
        mlp += 2 * a * b
    fm = 4 * F * d
    gather = 2 * F * cfg.multi_hot * d
    return 3.0 * B * (mlp + fm + gather)


def serve_flops(cfg: DeepFMConfig, B) -> float:
    """Model FLOPs of one forward of batch ``B``: a third of a train step."""
    return _train_flops(cfg, B) / 3.0
