"""Parallel low-degree elimination (paper §2.3, Algorithm 1; torch port of
``repro.core.elimination``).

1. *Selection* — every vertex of unweighted degree ≤ 4 is a candidate; a
   candidate is eliminated iff it attains the strict minimum (hash, id)
   over the candidates of its closed neighbourhood. The eliminated set is
   independent, so L_FF is diagonal and elimination is an exact Schur
   complement.
2. *Level construction* — P_F = D_F⁻¹ W and S = L_CC − Wᵀ D_F⁻¹ W, where
   each eliminated vertex's fill is a clique of ≤ 12 directed edges built
   from a fixed [n, 4] neighbour table.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.graph import GraphLevel, graph_from_adjacency, hash32
from repro_torch.sparse.coo import (COO, coalesce_arrays,
                                    coalesce_arrays_groups, spmv, spmv_t)
from repro_torch.sparse.ell import ell_layout_groups, ell_layout_traced
from repro_torch.sparse.segment import (group_ids, per_row,
                                        segment_argmin_lex, segment_sum,
                                        segment_sum_groups, take_fill,
                                        take_groups)

MAX_ELIM_DEGREE = 4  # paper: "like LAMG, we eliminate vertices of degree 4 or less"

_U32_TO_I32 = 1 << 31   # h - 2^31 maps uint32 order onto signed order


def select_eliminated(level: GraphLevel, max_degree: int = MAX_ELIM_DEGREE,
                      n_valid=None) -> torch.Tensor:
    """Boolean [n] mask of the vertices to eliminate (Alg 1's semiring
    SpMV as a lexicographic segment reduction).

    ``n_valid``: the count of real vertices (an int or a 0-d tensor) when
    ``level`` is bucket-padded: padding vertices have degree 0 and would
    all be candidates otherwise."""
    adj = level.adj
    n = level.n
    iota = torch.arange(n, device=adj.device)
    cand = level.unweighted_degrees() <= max_degree
    if n_valid is not None:
        cand = cand & (iota < n_valid)
    h = hash32(iota)
    # ⊗: keep only candidate neighbours and carry their hash; the vertex
    # itself is folded in after the edge reduction.
    col_ok = take_fill(cand, adj.col, False) & adj.valid
    nbr_key = take_fill(h, adj.col, 0xFFFFFFFF) - _U32_TO_I32
    best_key, best_id = segment_argmin_lex(nbr_key, adj.col, adj.row, n,
                                           valid=col_ok)
    self_key = h - _U32_TO_I32
    # STRICT comparison: a tie would let two adjacent candidates with
    # colliding hashes both be eliminated.
    lt = (self_key < best_key) | ((self_key == best_key) & (iota < best_id))
    return cand & lt


def select_eliminated_groups(row: torch.Tensor, col: torch.Tensor, n: int,
                             n_valid: torch.Tensor,
                             max_degree: int = MAX_ELIM_DEGREE
                             ) -> torch.Tensor:
    """:func:`select_eliminated` of every graph of a group of
    bucket-padded levels of ``n`` vertices: ``row``/``col`` ``[G, m]``
    (each graph's own ids, padding ``>= n``), ``n_valid`` ``[G]``.
    Returns the ``[G, n]`` masks."""
    g = row.shape[0]
    valid = row < n
    iota = torch.arange(n, device=row.device)
    cand = segment_sum_groups(valid.to(torch.int32), row, n) <= max_degree
    cand = cand & (iota < n_valid[:, None])
    h = hash32(iota)
    col_ok = take_groups(cand, col, False) & valid
    nbr_key = take_fill(h, col, 0xFFFFFFFF) - _U32_TO_I32
    best_key, best_id = segment_argmin_lex(
        nbr_key.reshape(-1), col.reshape(-1),
        group_ids(row, n).reshape(-1), g * n, valid=col_ok.reshape(-1))
    best_key, best_id = best_key.view(g, n), best_id.view(g, n)
    self_key = h - _U32_TO_I32
    lt = (self_key < best_key) | ((self_key == best_key) & (iota < best_id))
    return cand & lt


@dataclasses.dataclass(frozen=True)
class EliminationLevel:
    """Exact two-level elimination (LAMG-style "ELIM" level).

      restrict:  b_c = b_C + P_Fᵀ b_F
      prolong:   x_F = inv_deg_F ⊙ b_F + P_F x_C
    """

    fine: GraphLevel
    coarse: GraphLevel
    elim_mask: torch.Tensor   # bool [n_fine]
    c_index: torch.Tensor     # int32 [n_fine]: fine -> coarse id (junk on F)
    f_index: torch.Tensor     # int32 [n_fine]: fine -> F-slot id (junk on C)
    f_vertices: torch.Tensor  # int32 [n_f]: F-slot -> fine id
    p_f: COO                  # [n_f, n_coarse] = D_F⁻¹ W
    inv_deg_f: torch.Tensor   # float32 [n_f]

    @property
    def n_fine(self) -> int:
        return self.fine.n

    @property
    def n_coarse(self) -> int:
        return self.coarse.n

    # b, x_c: vectors or [n, k] blocks; the masks and inv_deg_f act on
    # every column
    def restrict(self, b: torch.Tensor) -> torch.Tensor:
        b_f = take_fill(b, self.f_vertices, 0)
        elim = per_row(self.elim_mask, b)
        b_c = segment_sum(torch.where(elim, 0, b),
                          torch.where(self.elim_mask, self.n_coarse,
                                      self.c_index),
                          self.n_coarse)
        return b_c + spmv_t(self.p_f, b_f)

    def prolong(self, x_c: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        b_f = take_fill(b, self.f_vertices, 0)
        x_f = per_row(self.inv_deg_f, b_f) * b_f + spmv(self.p_f, x_c)
        x = take_fill(x_c, self.c_index.clamp(0, self.n_coarse - 1), 0)
        n_slots = self.f_vertices.shape[0]
        x_from_f = take_fill(x_f, self.f_index.clamp(0, max(n_slots - 1, 0)),
                             0)
        return torch.where(per_row(self.elim_mask, x), x_from_f, x)


def schur_arrays(adj: COO, deg: torch.Tensor, elim: torch.Tensor, n, *,
                 f_cap: int, max_degree: int = MAX_ELIM_DEGREE,
                 out_capacity: int | None = None, sentinel=None) -> dict:
    """The Schur-complement formula on the padded arrays of one level.

    ``adj``/``deg`` describe the fine level at capacity ``n_cap =
    adj.n_rows``, of which the first ``n`` vertices are real (an int, or a
    0-d tensor in the bucket-padded setup). ``elim`` is the bool [n_cap]
    elimination mask and ``f_cap`` sizes every F-slot array (>= the
    eliminated count). Returns the P_F triple (sentinel ``f_cap``), the
    F-slot maps, the coalesced coarse adjacency (sentinel ``sentinel``,
    default ``n_cap``, padding last) and the counts ``n_f`` and
    ``co_nnz`` as 0-d tensors: nothing here makes the host wait.
    """
    n_cap = adj.n_rows
    dev = adj.device
    if sentinel is None:
        sentinel = n_cap
    n_f = elim.sum()
    n_c = n - n_f
    iota = torch.arange(n_cap, dtype=torch.int32, device=dev)

    c_index = (torch.cumsum((~elim).to(torch.int32), 0) - 1).to(torch.int32)
    f_index = (torch.cumsum(elim.to(torch.int32), 0) - 1).to(torch.int32)
    f_slot = torch.where(elim, f_index, f_cap).long()
    f_vertices = torch.full((f_cap + 1,), n_cap, dtype=torch.int32,
                            device=dev)
    f_vertices[f_slot] = iota
    f_vertices = f_vertices[:f_cap]

    row_f = take_fill(elim, adj.row, False) & adj.valid
    # clamped reciprocal: an isolated F-vertex must not put Inf into the fill
    inv_deg_f = 1.0 / torch.clamp(take_fill(deg, f_vertices, 1.0), min=1e-30)
    row_c = adj.row.clamp(max=n_cap - 1)
    col_c = adj.col.clamp(max=n_cap - 1)
    p_row = torch.where(row_f, take_fill(f_index, row_c, 0), f_cap)
    p_col = torch.where(row_f, take_fill(c_index, col_c, 0), f_cap)
    p_scale = take_fill(inv_deg_f, p_row.clamp(max=f_cap - 1), 0)
    p_val = torch.where(row_f, adj.val * p_scale, 0)

    # --- coarse adjacency: A_CC + Schur fill cliques --------------------
    cc = (~take_fill(elim, adj.row, True)) & \
        (~take_fill(elim, adj.col, True)) & adj.valid
    cc_row = torch.where(cc, take_fill(c_index, row_c, 0), n_cap)
    cc_col = torch.where(cc, take_fill(c_index, col_c, 0), n_cap)
    cc_val = torch.where(cc, adj.val, 0)

    # fill: for every eliminated f with neighbours u≠v (all in C):
    #   w_uv += w_uf * w_fv / deg_f
    lay = ell_layout_traced(adj.row, adj.col, n_cap, max_degree)
    f_nb_col = take_fill(lay.col_table, f_vertices, n_cap)       # [f_cap, w]
    f_nb_val = take_fill(lay.table(adj.val), f_vertices, 0)
    pair_val = f_nb_val[:, :, None] * f_nb_val[:, None, :] * \
        inv_deg_f[:, None, None]                                  # [f_cap,w,w]
    u = f_nb_col[:, :, None].expand(pair_val.shape)
    v = f_nb_col[:, None, :].expand(pair_val.shape)
    off_diag = (u != v) & (u < n) & (v < n)
    fill_row = torch.where(off_diag, take_fill(c_index, u.clamp(max=n_cap - 1),
                                               0), n_cap).reshape(-1)
    fill_col = torch.where(off_diag, take_fill(c_index, v.clamp(max=n_cap - 1),
                                               0), n_cap).reshape(-1)
    fill_val = torch.where(off_diag, pair_val, 0).reshape(-1)

    all_row = torch.cat([cc_row, fill_row]).to(torch.int32)
    all_col = torch.cat([cc_col, fill_col]).to(torch.int32)
    all_val = torch.cat([cc_val, fill_val])
    co_row, co_col, co_val, co_nnz = coalesce_arrays(
        all_row, all_col, all_val, n_c, out_capacity or all_row.shape[0],
        sentinel=sentinel)
    return dict(c_index=c_index, f_index=f_index, f_vertices=f_vertices,
                inv_deg_f=inv_deg_f, p_row=p_row.to(torch.int32),
                p_col=p_col.to(torch.int32), p_val=p_val, co_row=co_row,
                co_col=co_col, co_val=co_val, co_nnz=co_nnz, n_f=n_f)


def schur_arrays_groups(row, col, val, deg, elim, n, *, f_cap: int,
                        max_degree: int = MAX_ELIM_DEGREE,
                        out_capacity: int | None = None,
                        sentinel=None) -> dict:
    """:func:`schur_arrays` of every graph of a group: ``row``, ``col``,
    ``val`` ``[G, m]`` (each graph's own ids, padding ``>= n_cap``),
    ``deg`` and ``elim`` ``[G, n_cap]``, ``n`` the ``[G]`` real counts.
    Returns the same dict with a leading graph axis on every array and
    count, graph g's bit for bit its own."""
    g, n_cap = deg.shape
    dev = deg.device
    if sentinel is None:
        sentinel = n_cap
    n_f = elim.sum(1)
    n_c = n - n_f
    iota = torch.arange(n_cap, dtype=torch.int32, device=dev)
    valid = row < n_cap

    c_index = (torch.cumsum((~elim).to(torch.int32), 1) - 1).to(torch.int32)
    f_index = (torch.cumsum(elim.to(torch.int32), 1) - 1).to(torch.int32)
    f_slot = torch.where(elim, f_index, f_cap).long()
    f_slot = f_slot + torch.arange(g, device=dev)[:, None] * (f_cap + 1)
    f_vertices = torch.full((g * (f_cap + 1),), n_cap, dtype=torch.int32,
                            device=dev)
    f_vertices[f_slot.reshape(-1)] = iota.expand(g, n_cap).reshape(-1)
    f_vertices = f_vertices.view(g, f_cap + 1)[:, :f_cap]

    row_f = take_groups(elim, row, False) & valid
    inv_deg_f = 1.0 / torch.clamp(take_groups(deg, f_vertices, 1.0),
                                  min=1e-30)
    row_c = row.clamp(max=n_cap - 1)
    col_c = col.clamp(max=n_cap - 1)
    p_row = torch.where(row_f, take_groups(f_index, row_c, 0), f_cap)
    p_col = torch.where(row_f, take_groups(c_index, col_c, 0), f_cap)
    p_scale = take_groups(inv_deg_f, p_row.clamp(max=f_cap - 1), 0)
    p_val = torch.where(row_f, val * p_scale, 0)

    cc = (~take_groups(elim, row, True)) & \
        (~take_groups(elim, col, True)) & valid
    cc_row = torch.where(cc, take_groups(c_index, row_c, 0), n_cap)
    cc_col = torch.where(cc, take_groups(c_index, col_c, 0), n_cap)
    cc_val = torch.where(cc, val, 0)

    lay = ell_layout_groups(row, col, n_cap, max_degree)
    w = max_degree
    f_nb_col = take_groups(lay.col_table.view(g, n_cap, w), f_vertices,
                           n_cap)                               # [G,f_cap,w]
    f_nb_val = take_groups(lay.table(val).view(g, n_cap, w), f_vertices, 0)
    pair_val = f_nb_val[..., :, None] * f_nb_val[..., None, :] * \
        inv_deg_f[..., None, None]                            # [G,f_cap,w,w]
    u = f_nb_col[..., :, None].expand(pair_val.shape)
    v = f_nb_col[..., None, :].expand(pair_val.shape)
    nb = n[:, None, None, None]
    off_diag = (u != v) & (u < nb) & (v < nb)
    fill_row = torch.where(off_diag, take_groups(
        c_index, u.clamp(max=n_cap - 1), 0), n_cap).reshape(g, -1)
    fill_col = torch.where(off_diag, take_groups(
        c_index, v.clamp(max=n_cap - 1), 0), n_cap).reshape(g, -1)
    fill_val = torch.where(off_diag, pair_val, 0).reshape(g, -1)

    all_row = torch.cat([cc_row, fill_row], dim=1).to(torch.int32)
    all_col = torch.cat([cc_col, fill_col], dim=1).to(torch.int32)
    all_val = torch.cat([cc_val, fill_val], dim=1)
    co_row, co_col, co_val, co_nnz = coalesce_arrays_groups(
        all_row, all_col, all_val, n_c, out_capacity or all_row.shape[1],
        sentinel=sentinel)
    return dict(c_index=c_index, f_index=f_index, f_vertices=f_vertices,
                inv_deg_f=inv_deg_f, p_row=p_row.to(torch.int32),
                p_col=p_col.to(torch.int32), p_val=p_val, co_row=co_row,
                co_col=co_col, co_val=co_val, co_nnz=co_nnz, n_f=n_f)


def build_elimination_level(level: GraphLevel, elim: torch.Tensor,
                            coarse_capacity: int | None = None,
                            n_f: int | None = None,
                            max_degree: int = MAX_ELIM_DEGREE
                            ) -> EliminationLevel:
    """Build the elimination level at exact shapes. ``max_degree`` must
    cover the selection rule's degree bound (it sizes the fill table)."""
    n = level.n
    if n_f is None:
        n_f = int(elim.sum())
    n_c = n - n_f
    out = schur_arrays(level.adj, level.deg, elim, n, f_cap=max(n_f, 1),
                       max_degree=max_degree, out_capacity=coarse_capacity)
    p_f = COO(out["p_row"], out["p_col"], out["p_val"], max(n_f, 1),
              max(n_c, 1))
    coarse = graph_from_adjacency(COO(out["co_row"], out["co_col"],
                                      out["co_val"], max(n_c, 1),
                                      max(n_c, 1)))
    return EliminationLevel(
        fine=level, coarse=coarse, elim_mask=elim, c_index=out["c_index"],
        f_index=out["f_index"], f_vertices=out["f_vertices"], p_f=p_f,
        inv_deg_f=out["inv_deg_f"])


def eliminate_low_degree(level: GraphLevel, max_degree: int = MAX_ELIM_DEGREE,
                         coarse_capacity: int | None = None):
    """One full elimination pass: select + build. Returns None if nothing to
    do (no vertex, or every vertex, selected)."""
    elim = select_eliminated(level, max_degree)
    n_elim = int(elim.sum())
    if n_elim == 0 or n_elim == level.n:
        return None
    return build_elimination_level(level, elim, coarse_capacity,
                                   n_f=n_elim, max_degree=max_degree)
