"""Where the time of DeepFM serving goes on the card.

    python -m repro_torch.trace_deepfm [--trace-dir DIR]

Builds DeepFM at ``configs/deepfm.py::FULL`` (weights from a seeded
generator) and profiles, with ``trace_solve.profile_call``, one warm call
of each serving shape on ids already on the card: a serve_p99 request
(B = 512), a serve_bulk batch (B = 262,144) and a retrieval_cand call
(10^6 candidates of field 0). For each: the untraced wall time, device
time by kernel name, the number of kernel launches and the device's busy
share. ``--trace-dir`` writes one Chrome trace per shape. Prints one JSON
object. It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    import torch

    from repro_torch.configs.deepfm import FULL, SHAPE_DIMS
    from repro_torch.data.synthetic import recsys_batch_stream
    from repro_torch.models.recsys.deepfm import DeepFM
    from repro_torch.trace_solve import profile_call

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace-dir", default=None,
                    help="directory for one Chrome trace per shape")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_deepfm: needs a CUDA device", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False    # full float32 products
    dev = torch.device("cuda")
    cfg = FULL
    model = DeepFM(cfg, torch.Generator(device=dev).manual_seed(0))
    batches = {}
    for shape in ("serve_p99", "serve_bulk"):
        _, idx, _ = next(recsys_batch_stream(
            cfg.vocab_per_field, SHAPE_DIMS[shape]["batch"], cfg.multi_hot,
            seed=0))
        batches[shape] = torch.from_numpy(idx).to(dev)
    cands = torch.arange(SHAPE_DIMS["retrieval_cand"]["n_candidates"],
                         dtype=torch.int32, device=dev)
    user = batches["serve_p99"][:1]
    calls = dict(serve_p99=lambda: model(batches["serve_p99"]),
                 serve_bulk=lambda: model(batches["serve_bulk"]),
                 retrieval_cand=lambda: model.retrieval_scores(user, cands))
    out = dict(device=torch.cuda.get_device_name(0))
    for shape, fn in calls.items():
        path = (f"{args.trace_dir}/deepfm_{shape}.json" if args.trace_dir
                else None)
        out[shape] = profile_call(torch, fn, path)[1]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
