"""The search-based pipeline: ``run_scalar``, and ``run()``'s fallback for
a domain too sparse for the dense cell table.

PyTorch counterpart of ``treensearch_tpu/ops/pipeline.py:64-327``:

1. ``update_grid`` fixes the world box;
2. ``sorted_structure`` quantizes, keys each point by its row-major cell
   (``utils/keys.py``) and sorts stably by the key;
3. the chunk body (``make_chunk_body``) finds, for each query and each of
   the (2W+1)^2 stencil offsets (di, dj), the sorted range of cells
   (i+di, j+dj, k-W .. k+W) by two binary searches, lays the ranges end
   to end into ``cand_cap`` candidate slots, tests d^2 = (dx*dx + dy*dy)
   + dz*dz <= r^2 in float32 (or float64 with ``cfg.scalar_f64``; r_i^2,
   or also r_j^2 under symmetric search, with per-point radii), excludes
   the query itself, and per active pair counts exactly and front-packs
   the set-local indices of the hits in slot order (``compact_rows``);
4. ``postprocess`` returns the rows from sorted order to each set's
   order.

The JAX package maps the chunk body over chunks of ``cfg.chunk`` queries
with ``lax.map``; here a loop runs it over blocks of whole chunks sized so
that a block holds about ``_BLOCK_SLOTS`` candidate slots.  A query's row
depends on nothing else, so the blocking changes no result.  No CUDA
kernel is involved: the JAX pipeline is XLA code, not a Pallas kernel.

Every size is static in ``cfg`` (the block loop in n, ``cand_cap`` slots
per query), the grid dims stay device tensors and the constants come
from the search's ``fastpath.StepConsts``, so the pipeline reads nothing
back to the host and a CUDA graph can capture it, as the JAX pipeline
runs under ``jit``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..config import SearchConfig
from ..utils import keys as K
from ..utils.compact import compact_rows
from .cond import assign_
from .fastpath import StepConsts
from .grid import GridState, update_grid

# candidate slots per block of the chunk loop: its temporaries stay at a
# few hundred MB whatever the point count
_BLOCK_SLOTS = 1 << 23


def _pair_name(si: int, sj: int) -> str:
    return f"{si}-{sj}"


class SortedStructure(NamedTuple):
    """Everything the chunk body reads, after the sort (the JAX
    ``SortedStructure``, plus the key words as one int64)."""
    hi_s: torch.Tensor       # (n,) sorted key words, int32
    lo_s: torch.Tensor
    idx_s: torch.Tensor      # (n,) original index per sorted slot
    pts_s: torch.Tensor      # (n, 3) float32
    set_id_s: torch.Tensor   # (n,) int32
    r_s: Optional[torch.Tensor]  # (n,) float32 in variable mode, else None
    ijk_s: torch.Tensor      # (n, 3) int32 cell coords
    n_cells_xyz: torch.Tensor  # (3,) int32 grid dims
    r2_fixed: torch.Tensor   # () float32 square of the float32 radius
    offsets_arr: torch.Tensor  # (n_sets + 1,) int32 set offsets
    n_cells_stat: torch.Tensor  # () int32 occupied cells
    key_s: torch.Tensor      # (n,) int64 ``keys.key64(hi_s, lo_s)``


def sorted_structure(points: torch.Tensor, radii: Optional[torch.Tensor],
                     state: GridState, cfg: SearchConfig,
                     consts: StepConsts, orig: Optional[torch.Tensor] = None,
                     set_ids: Optional[torch.Tensor] = None,
                     valid: Optional[torch.Tensor] = None
                     ) -> SortedStructure:
    """Quantize, key and sort (``pipeline.py:78-118`` of the JAX
    package).  ``points`` (n, 3) float32 holds the concatenated sets; or,
    with ``orig`` and ``set_ids`` ((n,) int32: each row's concatenated
    index and set), any rows of them, as the sharded search's routed rows
    (``parallel/sharded.py``).  ``valid`` ((n,) bool) parks the rows
    flagged False past every key, where no stencil range reaches them
    (the sharded step's sentinel rows; ``sharded.py:232`` of the JAX
    package).  The radius and the set offsets (and, for the concatenated
    sets, their set ids) come from ``consts``."""
    dev = points.device
    n = points.shape[0]
    inv_cell = 1.0 / state.cell_size
    ijk = K.quantize(points, state.grid_min, inv_cell, state.n_cells)
    hi, lo = K.cell_keys(ijk)
    if valid is not None:
        hi = torch.where(valid, hi, torch.iinfo(torch.int32).max)
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    hi_s, lo_s, perm = K.sort_by_2word_key(hi, lo, iota)
    key_s = K.key64(hi_s, lo_s)
    order = perm.long()
    idx_s = perm if orig is None else orig[order]
    if set_ids is None:
        set_ids = consts.set_ids if consts.set_ids is not None else \
            torch.zeros(n, dtype=torch.int32, device=dev)
    if n > 1:
        n_cells_stat = 1 + (key_s[1:] != key_s[:-1]).sum().to(torch.int32)
    else:
        n_cells_stat = torch.full((), n, dtype=torch.int32, device=dev)
    return SortedStructure(
        hi_s=hi_s, lo_s=lo_s, idx_s=idx_s,
        pts_s=points[order], set_id_s=set_ids[order],
        r_s=radii[order] if cfg.variable else None, ijk_s=ijk[order],
        n_cells_xyz=state.n_cells, r2_fixed=consts.r2,
        offsets_arr=consts.set_off, n_cells_stat=n_cells_stat, key_s=key_s)


def make_chunk_body(s: SortedStructure, cfg: SearchConfig,
                    consts: StepConsts, queries: Optional[dict] = None
                    ) -> Callable[[int, int], dict]:
    """The search of sorted query rows [r0, r1) (``pipeline.py:121-258``
    of the JAX package; the role of the reference's ``_brute_force_simd``,
    ``TreeNSearch.cpp:2400-2569``): ``body(r0, r1)`` returns
    ``{"cand_total": (r1 - r0,) int32 candidates before the cap, "<si>-
    <sj>": {"counts": (r1 - r0,) int32, "nbrs": (r1 - r0, nbr_cap)
    int32}}`` in sorted order.  The stencil offsets (di, dj) are
    ``consts``'; the grid dims stay on the device.

    ``queries`` decouples the queries from the sorted candidates: a dict
    of ``orig`` (m,), ``ijk`` (m, 3), ``pts`` (m, 3), ``set_id`` (m,) and,
    in variable mode, ``r`` (m,), whose rows [r0, r1) the body then
    searches (the sharded search's owned rows, while its halo rows serve
    as candidates only)."""
    n = s.idx_s.shape[0]
    dev = s.idx_s.device
    w = cfg.stencil_w
    cap = cfg.cand_cap
    # each axis's last cell as device scalars, made once per search, not
    # per block
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    i_max, j_max, k_max = (s.n_cells_xyz - 1).unbind()
    di, dj = consts.di, consts.dj
    n_win = di.shape[0]
    slot = torch.arange(cap, dtype=torch.int64, device=dev)
    f64 = cfg.scalar_f64
    dtype = torch.float64 if f64 else torch.float32
    if queries is None:
        queries = {"orig": s.idx_s, "ijk": s.ijk_s, "pts": s.pts_s,
                   "set_id": s.set_id_s, "r": s.r_s}

    def body(r0: int, r1: int) -> dict:
        b = r1 - r0
        my_orig = queries["orig"][r0:r1]
        my_ijk = queries["ijk"][r0:r1]
        my_pos = queries["pts"][r0:r1]
        my_set = queries["set_id"][r0:r1]
        # (2W+1)^2 contiguous candidate ranges per query
        ii = my_ijk[:, 0, None] + di[None, :]
        jj = my_ijk[:, 1, None] + dj[None, :]
        q_valid = (ii >= 0) & (ii <= i_max) & (jj >= 0) & (jj <= j_max)
        q_hi = K.key_hi(torch.clamp(ii, zero, i_max),
                        torch.clamp(jj, zero, j_max))
        k = my_ijk[:, 2, None].expand(b, n_win)
        starts = torch.searchsorted(
            s.key_s, K.key64(q_hi, (k - w).clamp(min=0)), side="left")
        ends = torch.searchsorted(
            s.key_s, K.key64(q_hi, torch.minimum(k + w, k_max)),
            side="right")
        lens = torch.where(q_valid, ends - starts, 0)
        cum = torch.cumsum(lens, dim=1)
        total = cum[:, -1]
        # slot t -> (range, offset inside it): the ranges laid end to end
        seg = torch.searchsorted(cum, slot.expand(b, cap).contiguous(),
                                 right=True).clamp(max=n_win - 1)
        prev_end = torch.where(
            seg > 0, torch.gather(cum, 1, (seg - 1).clamp(min=0)), 0)
        cand = torch.gather(starts, 1, seg) + slot[None, :] - prev_end
        slot_valid = slot[None, :] < torch.clamp(total, max=cap)[:, None]
        cand = cand.clamp(0, n - 1)

        c_pos = s.pts_s[cand].to(dtype)          # (b, cap, 3)
        c_orig = s.idx_s[cand]
        c_set = s.set_id_s[cand]
        d = c_pos - my_pos.to(dtype)[:, None, :]
        dx, dy, dz = d.unbind(-1)
        d2 = (dx * dx + dy * dy) + dz * dz       # fixed add order
        if cfg.variable:
            q_r = queries["r"][r0:r1]
            crit = d2 <= (q_r * q_r).to(dtype)[:, None]
            if cfg.symmetric:
                c_r = s.r_s[cand].to(dtype)
                crit = crit | (d2 <= c_r * c_r)
        else:
            crit = d2 <= s.r2_fixed.to(dtype)
        base = slot_valid & crit & (c_orig != my_orig[:, None])
        loc_j = c_orig - s.offsets_arr[c_set.clamp(min=0).long()]

        out = {"cand_total": total.to(torch.int32)}
        for (si, sj) in cfg.active_pairs:
            pm = base & (my_set == si)[:, None] & (c_set == sj)
            out[_pair_name(si, sj)] = {
                "counts": pm.sum(dim=1, dtype=torch.int32),
                "nbrs": compact_rows(pm, loc_j, cfg.nbr_cap)}
        return out

    return body


def run_chunks(body: Callable[[int, int], dict], n: int,
               cfg: SearchConfig) -> dict:
    """The chunk body over all ``n`` sorted rows, in blocks of whole
    chunks of about ``_BLOCK_SLOTS`` candidate slots (the role of the JAX
    ``lax.map``); returns the body's outputs concatenated in sorted
    order."""
    rows = max(cfg.chunk, _BLOCK_SLOTS // max(cfg.cand_cap, 1)
               // cfg.chunk * cfg.chunk)
    parts = [body(r0, min(r0 + rows, n)) for r0 in range(0, n, rows)]
    out = {"cand_total": torch.cat([p["cand_total"] for p in parts])}
    for (si, sj) in cfg.active_pairs:
        name = _pair_name(si, sj)
        out[name] = {k: torch.cat([p[name][k] for p in parts])
                     for k in ("counts", "nbrs")}
    return out


def postprocess(mapped: dict, s: SortedStructure, state: GridState,
                cfg: SearchConfig) -> dict:
    """Sorted-order outputs back to each set's order
    (``pipeline.py:261-295`` of the JAX package; the reference's set-local
    rebase, ``TreeNSearch.cpp:2011-2017``)."""
    n = s.idx_s.shape[0]
    dev = s.idx_s.device
    inv_perm = torch.empty(n, dtype=torch.int64, device=dev)
    inv_perm[s.idx_s.long()] = torch.arange(n, device=dev)
    offs = cfg.set_offsets
    pairs = {}
    for (si, sj) in cfg.active_pairs:
        name = _pair_name(si, sj)
        n_i = cfg.set_sizes[si]
        rows = inv_perm[offs[si]:offs[si] + n_i]
        counts = mapped[name]["counts"][rows]
        pairs[name] = {
            "counts": counts, "nbrs": mapped[name]["nbrs"][rows],
            "max_count": counts.max() if n_i > 0 else
            torch.zeros((), dtype=torch.int32, device=dev)}
    return {"pairs": pairs, "cand_max": mapped["cand_total"].max(),
            "n_cells": s.n_cells_stat, "error": state.error.clone()}


def _empty_solution(cfg: SearchConfig, state: GridState) -> dict:
    dev = state.error.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    pairs = {}
    for (si, sj) in cfg.active_pairs:
        n_i = cfg.set_sizes[si]
        pairs[_pair_name(si, sj)] = {
            "counts": torch.zeros(n_i, dtype=torch.int32, device=dev),
            "nbrs": torch.full((n_i, cfg.nbr_cap), -1, dtype=torch.int32,
                               device=dev),
            "max_count": zero}
    return {"pairs": pairs, "cand_max": zero, "n_cells": zero,
            "error": state.error.clone()}


def build_and_search(points: torch.Tensor, radii: Optional[torch.Tensor],
                     state: GridState, cfg: SearchConfig, *,
                     consts: StepConsts) -> tuple[dict, GridState]:
    """One full search by the pipeline (``build_and_search``,
    ``pipeline.py:298-327`` of the JAX package).  ``radii`` (n,) float32
    in variable mode, else None; ``consts`` are ``fastpath.
    step_constants(cfg, knobs, cell_size, device, search_radius=...)``
    and give the cell size, the radius and the stencil.  Returns
    ``(solution, state)``: per active pair ``counts`` (n_i,) (exact),
    ``nbrs`` (n_i, nbr_cap) (set-local indices, -1 padded) and
    ``max_count``; ``cand_max``, the most candidates any query had (the
    host regrows ``cand_cap`` past it); ``n_cells`` and ``error``.  The
    new grid is written into ``state``'s tensors, which are returned, and
    the solution shares no tensor with them.  It reads nothing back to
    the host, so a CUDA graph can capture it."""
    assign_(state, update_grid(state, points, consts.cell_size))
    n = cfg.n_points
    if n == 0:
        return _empty_solution(cfg, state), state
    s = sorted_structure(points, radii, state, cfg, consts)
    mapped = run_chunks(make_chunk_body(s, cfg, consts), n, cfg)
    return postprocess(mapped, s, state, cfg), state
