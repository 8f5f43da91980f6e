"""Carry state built by the JAX reference over to the port.

``hierarchy_from_numpy(tree, device)`` takes the reference ``Hierarchy``
flattened to plain Python: nested dicts of numpy arrays plus the static
fields. It lets the port's solve path be held against the reference on the
very same hierarchy, independently of setup. The layout of ``tree``:

    {"transfers": [transfer, ...], "lam_maxes": [float, ...],
     "coarse_inv": array}
    transfer = {"kind": "agg", "fine": level, "coarse": level,
                "coarse_id": array}
             | {"kind": "elim", "fine": level, "coarse": level,
                "elim_mask", "c_index", "f_index", "f_vertices",
                "inv_deg_f": array, "p_f": coo}
    level    = {"adj": coo, "deg": array,
                "ell": {"col", "val": array, "n_cols": int} | None,
                "ell_rem": coo | None}
    coo      = {"row", "col", "val": array, "n_rows", "n_cols": int}

``deepfm_params_from_numpy(tree, device)`` does the same for the dict that
the reference's ``init_deepfm`` returns, as numpy arrays:
``{"table", "first_order", "bias": array, "mlp": {"w": [...], "b": [...]}}``.

``gnn_params_from_numpy(tree, device)`` does the same for the parameter
dicts of the reference's ``init_mgn``, ``init_pna``, ``init_egnn`` and
``init_equiformer``: dicts and lists of MLP dicts ``{"w": [...], "b":
[...]}``, with ``ln_scale``/``ln_bias`` where the MLP ends in a
LayerNorm, and Equiformer-v2's bare matrices (``out_proj``, the
``so2`` dict of ``m{m}_r``/``m{m}_i``), leaf for leaf.

``lm_params_from_numpy(tree, device)`` does the same for the dict the
reference's ``models.transformer.init_params`` returns (``embed``,
``lm_head``, the stacked ``[L, ...]`` layer weights), bfloat16 leaves
included.

``adamw_state_from_numpy(tree, device)`` takes the reference's
``adamw_init``/``adamw_update`` state as numpy: ``{"mu": tree, "nu": tree,
"step": int32}``, each moment leaf a float32 array, a bfloat16 one (an
``ml_dtypes`` array, or the raw ``|V2`` values ``np.load`` gives for one),
or an int8 moment's ``{"q": int8, "scale": float32}``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.coarsen import AggregationLevel
from repro_torch.core.elimination import EliminationLevel
from repro_torch.core.graph import GraphLevel
from repro_torch.core.hierarchy import Hierarchy
from repro_torch.sparse.coo import COO
from repro_torch.sparse.ell import ELL


def _t(a, device, dtype=None) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def _coo(d: dict, device) -> COO:
    return COO(_t(d["row"], device, torch.int32),
               _t(d["col"], device, torch.int32),
               _t(d["val"], device, torch.float32),
               int(d["n_rows"]), int(d["n_cols"]))


def _level(d: dict, device) -> GraphLevel:
    ell = d.get("ell")
    rem = d.get("ell_rem")
    return GraphLevel(
        adj=_coo(d["adj"], device), deg=_t(d["deg"], device, torch.float32),
        ell=None if ell is None else ELL(_t(ell["col"], device, torch.int32),
                                         _t(ell["val"], device,
                                            torch.float32),
                                         int(ell["n_cols"])),
        ell_rem=None if rem is None else _coo(rem, device))


def hierarchy_from_numpy(tree: dict, device) -> Hierarchy:
    """The port's :class:`Hierarchy` for a flattened reference hierarchy."""
    device = torch.device(device)
    transfers = []
    prev_coarse = None
    for t in tree["transfers"]:
        # one object per level, as the reference's t.coarse is t_next.fine
        fine = prev_coarse if prev_coarse is not None else \
            _level(t["fine"], device)
        coarse = _level(t["coarse"], device)
        if t["kind"] == "agg":
            transfers.append(AggregationLevel(
                fine=fine, coarse=coarse,
                coarse_id=_t(t["coarse_id"], device, torch.int32)))
        elif t["kind"] == "elim":
            transfers.append(EliminationLevel(
                fine=fine, coarse=coarse,
                elim_mask=_t(t["elim_mask"], device, torch.bool),
                c_index=_t(t["c_index"], device, torch.int32),
                f_index=_t(t["f_index"], device, torch.int32),
                f_vertices=_t(t["f_vertices"], device, torch.int32),
                p_f=_coo(t["p_f"], device),
                inv_deg_f=_t(t["inv_deg_f"], device, torch.float32)))
        else:
            raise ValueError(f"unknown transfer kind {t['kind']!r}")
        prev_coarse = coarse
    lam = tuple(torch.tensor(float(v), device=device)
                for v in tree["lam_maxes"])
    return Hierarchy(transfers=tuple(transfers), lam_maxes=lam,
                     coarse_inv=_t(tree["coarse_inv"], device,
                                   torch.float32))


def deepfm_params_from_numpy(tree: dict, device) -> dict:
    """The port's DeepFM parameters (``init_deepfm``'s layout) for a
    reference parameter dict of numpy arrays."""
    device = torch.device(device)
    return dict(table=_t(tree["table"], device, torch.float32),
                first_order=_t(tree["first_order"], device, torch.float32),
                mlp={k: [_t(a, device, torch.float32) for a in tree["mlp"][k]]
                     for k in ("w", "b")},
                bias=_t(tree["bias"], device, torch.float32))


def gnn_params_from_numpy(tree, device):
    """The port's GNN parameters (the ``init_*`` layouts of
    ``repro_torch.models.gnn``) for a reference parameter tree of numpy
    arrays: the same dicts and lists, every leaf a float32 tensor."""
    device = torch.device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [conv(v) for v in t]
        return _t(t, device, torch.float32)

    return conv(tree)


def _float_leaf(a, device) -> torch.Tensor:
    """A bfloat16 leaf (an ``ml_dtypes`` array, or the raw ``|V2`` values
    ``np.load`` gives for one) bit for bit; anything else as float32."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2"):
        bits = torch.from_numpy(np.array(a).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return _t(a, device, torch.float32)


def _moment(a, device):
    if isinstance(a, dict):
        return dict(q=_t(a["q"], device, torch.int8),
                    scale=_t(a["scale"], device, torch.float32))
    return _float_leaf(a, device)


def adamw_state_from_numpy(tree: dict, device) -> dict:
    """The port's AdamW state (``repro_torch.optim.adamw``'s layout) for a
    reference optimizer state of numpy arrays, in any of the three moment
    layouts."""
    device = torch.device(device)

    def moments(t):
        if isinstance(t, dict) and set(t) == {"q", "scale"}:
            return _moment(t, device)
        if isinstance(t, dict):
            return {k: moments(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(moments(v) for v in t)
        return _moment(t, device)

    return dict(mu=moments(tree["mu"]), nu=moments(tree["nu"]),
                step=_t(tree["step"], device, torch.int32))


def lm_params_from_numpy(tree: dict, device) -> dict:
    """The port's LM parameters (``models.transformer.init_params``'s
    layout: the same keys, stacked ``[L, ...]`` layer leaves) for a
    reference parameter dict of numpy arrays; bfloat16 leaves stay
    bfloat16 bit for bit, the rest become float32."""
    device = torch.device(device)
    return {k: _float_leaf(v, device) for k, v in tree.items()}
