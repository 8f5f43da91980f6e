"""Where the time of DeepFM serving and training goes on the card.

    python -m repro_torch.trace_deepfm [--trace-dir DIR] [--train | --bag-grad]

Builds DeepFM at ``configs/deepfm.py::FULL`` (weights from a seeded
generator) and profiles, with ``trace_solve.profile_call``, one warm call
of each serving shape on ids already on the card, under
``torch.no_grad()``: a serve_p99 request (B = 512), a serve_bulk batch
(B = 262,144) and a retrieval_cand call (10^6 candidates of field 0).
With ``--train``, one warm training step instead (``train_batch``, B =
65,536: ``configs.deepfm.make_train_step`` with AdamW, f32 moments, on
the first batch of ``recsys_batch_stream(seed=0)``), then its parts
alone: the forward (``train_forward``, no graph), the loss and gradients
(``train_grads``) and AdamW (``train_adamw``); each one's device time and
launches are also summed by group: the matrix products, the bag kernels (forward and
backward), the sort of the batch's ids (``bag_grad_plan``, one a step),
and the elementwise and reduction rest (``other``). For each: the untraced wall time, device time by
kernel name, the number of kernel launches and the device's busy share.
With ``--bag-grad``, the bag backward alone at the train batch's ids
(:func:`bag_grad_breakdown`). ``--trace-dir`` writes one Chrome trace per
shape. Prints one JSON object. It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys

# device kernels by group, by a part of the name the profiler reports
# (first match wins; everything else is "other")
TRAIN_GROUPS = (("bag_forward", ("bag_tiles_kernel", "bag_rows_gather")),
                ("bag_backward", ("bag_grad_chunks", "bag_grad_finish",
                                  "bag_rows_sums", "bag_rows_finish")),
                ("sort", ("bag_grad_keys", "RadixSort")),
                ("gemm", ("gemm", "gemv")))


def train_groups(kernels) -> dict:
    """``{group: total}`` of ``(kernel name, ms or launches)`` pairs."""
    out = {}
    for name, x in kernels:
        group = next((g for g, parts in TRAIN_GROUPS
                      if any(p in name for p in parts)), "other")
        out[group] = round(out.get(group, 0) + x, 4)
    return out


def _short(key: str) -> str:
    return key.replace("void ", "").replace("(anonymous namespace)::",
                                            "").split("(")[0][:60]


def bag_grad_breakdown(torch, flat, n_vocab: int, reps: int = 20) -> dict:
    """Device ms a launch of each device kernel of the bag backward
    (``kernels.embedding_bag.embedding_bag_backward``) at the ids ``flat``
    [n_bags, hot], d = 10 and d = 1, over three plans with the batch's
    sorted ids: the batch's own (``batch``), its gathered rows replaced by
    rows in slot order (``rows_in_order``: the gathers stream) and by row 0
    (``one_row``: every gather hits one cached row). The last two compute
    nothing useful; against ``batch`` they show what the random gathers
    cost."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.embedding_bag import (BagGradPlan,
                                                   bag_grad_plan,
                                                   embedding_bag_backward)

    plan = bag_grad_plan(flat, n_vocab)
    in_order = torch.div(torch.arange(plan.rows.numel(), device=flat.device,
                                      dtype=torch.int32),
                         plan.hot, rounding_mode="floor")
    plans = dict(batch=plan,
                 rows_in_order=BagGradPlan(plan.sorted_ids, in_order,
                                           n_vocab, plan.hot),
                 one_row=BagGradPlan(plan.sorted_ids,
                                     torch.zeros_like(in_order), n_vocab,
                                     plan.hot))
    gen = torch.Generator(device=flat.device).manual_seed(1)
    out = {}
    for d in (10, 1):
        g = torch.randn((flat.shape[0], d), generator=gen, device=flat.device)
        for name, p in plans.items():
            def fn(p=p):
                return embedding_bag_backward(g, flat, n_vocab, p)

            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            out[f"d{d}_{name}"] = {
                _short(e.key): round(e.self_device_time_total / e.count
                                     / 1e3, 4)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA}
    return out


def main(argv=None) -> int:
    import torch

    from repro_torch.configs.deepfm import (FULL, SHAPE_DIMS, loss_and_grads,
                                            make_train_step)
    from repro_torch.data.synthetic import recsys_batch_stream
    from repro_torch.models.recsys.deepfm import (DeepFM, _flat_ids,
                                                  deepfm_loss, init_deepfm,
                                                  padded_rows)
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
    from repro_torch.trace_solve import profile_call

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace-dir", default=None,
                    help="directory for one Chrome trace per shape")
    ap.add_argument("--train", action="store_true",
                    help="profile one training step instead of serving")
    ap.add_argument("--bag-grad", action="store_true",
                    help="time the bag backward's kernels at the train "
                         "batch's ids instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_deepfm: needs a CUDA device", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False    # full float32 products
    dev = torch.device("cuda")
    cfg = FULL
    gen = torch.Generator(device=dev).manual_seed(0)
    out = dict(device=torch.cuda.get_device_name(0))

    def trace(shape, fn, top=10):
        path = (f"{args.trace_dir}/deepfm_{shape}.json" if args.trace_dir
                else None)
        return profile_call(torch, fn, path, top=top)[1]

    if args.bag_grad:
        B = SHAPE_DIMS["train_batch"]["batch"]
        _, idx, _ = next(recsys_batch_stream(cfg.vocab_per_field, B,
                                             cfg.multi_hot, seed=0))
        flat = _flat_ids(cfg, torch.from_numpy(idx).to(dev))
        out.update(bag_grad_breakdown(
            torch, flat.reshape(-1, cfg.multi_hot), padded_rows(cfg)))
        print(json.dumps(out))
        return 0

    if args.train:
        B = SHAPE_DIMS["train_batch"]["batch"]
        _, idx, lab = next(recsys_batch_stream(cfg.vocab_per_field, B,
                                               cfg.multi_hot, seed=0))
        batch = (torch.from_numpy(idx).to(dev), torch.from_numpy(lab).to(dev))
        params = init_deepfm(cfg, gen)
        opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=30)
        opt = adamw_init(params, opt_cfg)
        step = make_train_step(cfg, opt_cfg)
        _, grads = loss_and_grads(cfg, params, *batch)

        def forward():
            with torch.no_grad():
                return deepfm_loss(cfg, params, *batch)

        # the same state every call: each traced step starts from it; then
        # its parts alone: the forward, loss and gradients, AdamW
        parts = dict(train_batch=lambda: step(params, opt, *batch),
                     train_forward=forward,
                     train_grads=lambda: loss_and_grads(cfg, params, *batch),
                     train_adamw=lambda: adamw_update(opt_cfg, params, grads,
                                                      opt))
        for shape, fn in parts.items():
            res = trace(shape, fn, top=1000)  # every kernel, for the groups
            res["groups_ms"] = train_groups(
                (k["name"], k["ms"]) for k in res["top_kernels"])
            res["groups_launches"] = train_groups(
                (k["name"], k["count"]) for k in res["top_kernels"])
            out[shape] = res
        print(json.dumps(out))
        return 0

    model = DeepFM(cfg, gen)
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
    with torch.no_grad():               # serving builds no graph
        for shape, fn in calls.items():
            out[shape] = trace(shape, fn)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
