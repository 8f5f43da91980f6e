"""AdamW with a cosine schedule and global-norm clipping: torch port of
``repro.optim.adamw``.

Functional, as the reference is: ``adamw_update(cfg, params, grads,
state)`` returns new parameters and a new state and leaves its arguments
alone. Trees are nested dicts, lists and tuples of tensors
(``repro_torch.tree``), with the reference's layouts: ``state = {"mu":
tree, "nu": tree, "step": int32 scalar}``, each moment leaf a float32 or
bfloat16 tensor shaped like its parameter, or for ``moments_dtype="int8"``
a dict ``{"q": int8 tensor, "scale": float32 scalar}`` (one scale a
tensor; ``torch.round`` rounds half to even, as ``jnp.round`` does). The
arithmetic is the reference's, in float32 where it is: the schedule's
``cos`` and ``beta ** step`` too. Every operation is a plain elementwise
or reduction op on the parameters' device; nothing waits on the host.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.tree import leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    # moment precision: "f32" | "bf16" | "int8" (per-tensor quantised)
    moments_dtype: str = "f32"


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an int32 tensor): linear warm-up,
    then a cosine down to ``min_lr_frac · lr``; float32."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def _q8(x: torch.Tensor) -> dict:
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    return dict(q=torch.clamp(torch.round(x / scale), -127, 127).to(
        torch.int8), scale=scale)


def _dq8(s: dict) -> torch.Tensor:
    return s["q"].float() * s["scale"]


def _moment_zeros(p: torch.Tensor, dtype: str):
    # zeros_like / new_zeros: a DTensor parameter's moments are DTensors
    # placed as it is (its scale replicated)
    if dtype == "int8":
        return dict(q=torch.zeros_like(p, dtype=torch.int8),
                    scale=p.new_zeros((), dtype=torch.float32))
    if dtype not in ("f32", "bf16"):
        raise ValueError(f"unknown moments_dtype {dtype!r}")
    return torch.zeros_like(p, dtype=torch.bfloat16 if dtype == "bf16"
                            else torch.float32)


def _moment_load(m) -> torch.Tensor:
    if isinstance(m, dict):
        return _dq8(m)
    return m.float()


def _moment_store(m: torch.Tensor, like):
    if isinstance(like, dict):
        return _q8(m)
    return m.to(like.dtype)


def adamw_init(params, cfg: AdamWConfig | None = None) -> dict:
    """Zero moments shaped like ``params`` and ``step`` 0 (int32), on the
    parameters' devices."""
    dtype = cfg.moments_dtype if cfg is not None else "f32"
    first = leaves(params)
    step = (first[0].new_zeros((), dtype=torch.int32) if first
            else torch.zeros((), dtype=torch.int32))
    return dict(mu=tree_map(lambda p: _moment_zeros(p, dtype), params),
                nu=tree_map(lambda p: _moment_zeros(p, dtype), params),
                step=step)


def global_norm(tree) -> torch.Tensor:
    """``sqrt(Σ_leaves Σ x²)`` in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def _write(old, new) -> None:
    if isinstance(old, dict):                # an int8 moment {q, scale}
        old["q"].copy_(new["q"])
        old["scale"].copy_(new["scale"])
    else:
        old.copy_(new)


def adamw_update(cfg: AdamWConfig, params, grads, state: dict,
                 donate: bool = False):
    """One AdamW step: returns ``(new_params, new_state, {"grad_norm",
    "lr"})``. Gradients are clipped to ``clip_norm`` by their global norm;
    weight decay applies to every parameter. ``donate`` (the reference
    trainer's ``donate_argnums``): each leaf's new values are written into
    the leaf of ``params`` and ``state`` they replace as soon as they
    exist, and those trees are returned (``step`` a new tensor), so that
    the old and new state never live side by side; the same bits."""
    step = state["step"] + 1
    gn = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1c = 1 - cfg.beta1 ** step.float()
    b2c = 1 - cfg.beta2 ** step.float()

    def upd(p, g, m_store, v_store):
        g = g.float() * scale
        m = cfg.beta1 * _moment_load(m_store) + (1 - cfg.beta1) * g
        v = cfg.beta2 * _moment_load(v_store) + (1 - cfg.beta2) * g * g
        mh = m / b1c
        vh = v / b2c
        new_p = p.float() - lr * (
            mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float())
        new = (new_p.to(p.dtype), _moment_store(m, m_store),
               _moment_store(v, v_store))
        if not donate:
            return new
        for old, x in zip((p, m_store, v_store), new):
            _write(old, x)
        return p, m_store, v_store

    out = []                                 # (p, m, v) a leaf, in order
    with torch.no_grad():
        tree_map(lambda p, g, m, v: out.append(upd(p, g, m, v)), params,
                 grads, state["mu"], state["nu"])
    new_p, new_m, new_v = (unflatten(params, iter([o[i] for o in out]))
                           for i in range(3))
    return new_p, dict(mu=new_m, nu=new_v, step=step), dict(
        grad_norm=gn, lr=lr)
