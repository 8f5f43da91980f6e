"""End-to-end training driver (example application + fault-tolerance
demo): torch port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch \
        qwen2-0.5b-smoke --steps 200 --batch 8 --seq 128 [--device cpu]

Runs a real LM training loop (reduced config) on the CUDA card, or where
``--device`` says, with atomic checkpointing every ``--ckpt-every``
steps, deterministic data replay, and optional injected failures to
exercise the recovery path (``--inject-failures 17,53``). The weights come
from a ``torch.Generator`` seeded 0 on the device; the token stream is
the reference's (``data.synthetic.lm_batch_stream``), bit for bit.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs.lm_common import lm_train_step
from repro_torch.data.synthetic import lm_batch_stream
from repro_torch.device import resolve_device
from repro_torch.models.sharding import null_plan
from repro_torch.models.transformer import TransformerConfig, init_params
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.runtime.loop import (FailureInjector, TrainLoopRunner,
                                      tree_devices)

SMOKE_ARCHS = {
    "qwen2-0.5b-smoke": TransformerConfig(
        "qwen2-0.5b-smoke", n_layers=4, d_model=128, n_heads=8, n_kv_heads=2,
        d_ff=256, vocab=512, qkv_bias=True, dtype=torch.float32),
    "tiny-moe-smoke": TransformerConfig(
        "tiny-moe-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab=256, dtype=torch.float32),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b-smoke",
                    choices=sorted(SMOKE_ARCHS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--inject-failures", default="")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = SMOKE_ARCHS[args.arch]
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=20,
                          total_steps=args.steps)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt_state = adamw_init(params, opt_cfg)
    step_fn = lm_train_step(cfg, null_plan(), opt_cfg)

    stream_cache = {}

    def data_fn(step):
        # deterministic per-step regeneration => exact replay after recovery
        if step not in stream_cache:
            gen = lm_batch_stream(cfg.vocab, args.batch, args.seq,
                                  start_step=step)
            stream_cache.clear()
            stream_cache[step] = next(gen)[1]
        return torch.as_tensor(stream_cache[step], device=dev)

    start = 0
    if args.resume:
        from repro_torch.checkpoint.ckpt import latest_step, restore_checkpoint
        s = latest_step(args.ckpt_dir)
        if s is not None:
            state = dict(params=params, opt=opt_state)
            state, _ = restore_checkpoint(args.ckpt_dir, s, state,
                                          shardings=tree_devices(state))
            params, opt_state = state["params"], state["opt"]
            start = s
            print(f"resumed from step {s}")

    inj = None
    if args.inject_failures:
        inj = FailureInjector(tuple(int(x) for x in
                                    args.inject_failures.split(",")))

    runner = TrainLoopRunner(step_fn=step_fn, data_fn=data_fn,
                             ckpt_dir=args.ckpt_dir,
                             ckpt_every=args.ckpt_every,
                             failure_injector=inj, step_deadline_s=30.0)
    params, opt_state, metrics = runner.run(params, opt_state, args.steps,
                                            start_step=start)
    print(f"final loss: {float(metrics['loss']):.4f} "
          f"(grad_norm {float(metrics['grad_norm']):.3f})")
    return float(metrics["loss"])


if __name__ == "__main__":
    main()
