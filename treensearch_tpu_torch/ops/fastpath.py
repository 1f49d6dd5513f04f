"""The fast path: dense cell table, row-aligned query tiles, stencil
windows, and the fused pairs kernels or the tile path.

PyTorch counterpart of the neighbor-list branch of
``treensearch_tpu/ops/fastpath.py`` (``build_and_search_fast``,
``fastpath.py:1690-1711``, rebuilt on every call, and
``build_and_search_fast_carry``, ``fastpath.py:1609-1655``, which skips
step 2 while no point changes cells) for any number of point sets, at a
fixed radius or with per-point radii:

1. ``update_grid`` (``ops/grid.py``) fixes the world box;
2. ``_prep`` (counterpart of ``_pallas_prep``, row layout) sorts points by
   padded linear cell id, builds the dense cell-start table, pads every
   occupied grid row to a multiple of 128 slots so each 128-query tile
   lies in one grid row, and writes one window descriptor per stencil
   offset (di, dj): a contiguous, disjoint k-run of the SORTED points; in
   variable mode a window past the tile's local reach gets length 0;
3. ``_search`` (counterpart of ``_pallas_search``) builds the sorted
   field-major records, lays out the query tiles (kernel K1), runs the
   pairs kernel (K2a for one set at a fixed radius, K2b for several sets,
   K2c for per-point radii) with one output block per distinct candidate
   set, and gathers per-point counts through ``qpos``; split staging runs
   K4 then K5 for the pairs kernel, and in its place ``_search_reduce``
   runs the fused reduce (K3) and ``_search_mask`` the bitmask kernel
   (K4), each with its epilogue;
4. ``materialize_nbrs`` turns a pair's tile-layout rows into (n_i, k8)
   padded-CSR rows on demand, and ``decode_mask`` turns a mask into
   per-query neighbor sets.

Where ``applicable`` refuses the fused kernels (more than 8 candidate
sets, or ``FastKnobs.fused`` off), ``build_and_search_fast`` takes the
tile path instead (``fastpath.py:1712-1886`` of the JAX package): the
same prep with window starts in padded-slot space, the padded records
built by K1r, and ``_tile_search``, which tests each tile's windows with
plain tensor operations and front-packs the hits with ``compact_rows``.

Every structure the JAX prep computes by arithmetic is computed here by
the same integer arithmetic, so it is bit-identical (tests/
test_torch_prep.py).  The JAX package's blocked scans exist only for
XLA-TPU compile times; ``torch.cumsum`` and ``torch.cummax`` replace them,
and one histogram build of the cell table replaces its two bit-identical
builds.  The static caps and overflow flags stay: they fix every shape of
the step, and the host grows a cap and re-runs on overflow.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import SearchConfig, round_up
from ..utils import keys as K
from ..utils.compact import compact_rows
from .cond import assign_, rebuild_if
from .grid import GridState, update_grid
from .pairs import (A_COL, CNT_COL, DESC_W, F_ORIG, F_R, F_SET, F_X, F_Y,
                    F_Z, FAT_COL, LENS_OFF, MAX_BLOCKS, N_FIELDS, TILE,
                    clipped_windows, expand_query_tiles, expand_records,
                    mask_cand_base, pairs_mask, pairs_mask_plain,
                    pairs_nbrs_fixed, pairs_nbrs_fixed_plain,
                    pairs_nbrs_from_bits, pairs_nbrs_from_bits_plain,
                    pairs_nbrs_plain, pairs_nbrs_sets, pairs_nbrs_variable)
from .reduce import ReduceSpec, pairs_reduce

F_P0, F_P1 = 6, 7   # the payload fields of the records
MAX_STENCIL_W = 3   # (2W+1)^2 <= 49 windows fit the descriptor
# (query, candidate) slots per group of tiles of the tile path: its
# temporaries stay near a GB whatever the point count
_TILE_SLOTS = 1 << 25


class FastKnobs(NamedTuple):
    """Static caps of the fast path (the fields of the JAX ``FastKnobs``
    that the GPU path reads; the rest are TPU schedules)."""
    dense_cap: int = 1 << 22   # dense cell-table slots
    tiles_cap: int = 0         # row-aligned 128-slot tiles (0 = from n)
    rows_cap: int = 0          # grid-row array slots (0 = from dense_cap)
    # neighbor lists in two passes: K4's hit bits, then K5 unpacks them
    # into the pairs kernel's blocks (``run_pairs``)
    split_stage: bool = False
    # the fused pairs kernels where ``applicable`` (the JAX use_pallas);
    # off sends every neighbor-list search down the tile path
    fused: bool = True
    # the tile path only: candidate slots per window (a wider window is
    # cut, and ``cand_max`` makes the host regrow it)
    wcap: int = 288


class FastCarry(NamedTuple):
    """Everything derived from the points' cell assignment (counterpart
    of the JAX ``FastCarry`` without the fat-tier routing), carried across
    steps by ``build_and_search_fast_carry``."""
    valid: torch.Tensor        # () bool
    lin_s: torch.Tensor        # (n,) sorted linear cell ids
    lin_chk: torch.Tensor      # (n,) cell ids by original index, from the
    #                            reuse check's own computation
    r_chk: torch.Tensor        # (n,) sorted radii ((0,) at a fixed radius)
    idx_s: torch.Tensor        # (n,) sorted slot -> original index
    inv_perm: torch.Tensor     # (n,) original index -> sorted slot
    pp: torch.Tensor           # (n,) sorted slot -> padded slot
    qpos: torch.Tensor         # (n,) original index -> padded slot
    desc: torch.Tensor         # (nt8, 128) window descriptors
    dense_overflow: torch.Tensor
    tile_overflow: torch.Tensor
    rows_overflow: torch.Tensor
    win_max: torch.Tensor      # () widest window
    n_cells_stat: torch.Tensor  # () occupied cells
    reach_overflow: torch.Tensor  # () 1 when the largest radius needs
    #                               more than the static W ((0,) at a
    #                               fixed radius)


def default_tiles_cap(n: int) -> int:
    """Tile slots: ceil(n/128) plus one partial tile per occupied grid
    row, estimated as a quarter more (at least 256); the host regrows on
    ``tile_overflow``."""
    base = -(-n // TILE)
    return base + max(256, base // 4)


def mask_rows_cap(rows: int) -> int:
    """K4's static row cap for a step: a settled row count plus a quarter
    (at least 256), as ``default_tiles_cap`` pads; past it the step
    reports ``mask_overflow``."""
    return rows + max(256, rows // 4)


class StepConsts(NamedTuple):
    """The constant tensors of a search, made once per (cfg, knobs, cell
    size, search radius, device) by ``step_constants``, so that a step
    copies nothing from the host: a copy from pageable memory drains the
    stream, and stream capture forbids it."""
    cell_size: torch.Tensor   # () float32
    di: torch.Tensor          # (n_win,) int32: each window's row offsets
    dj: torch.Tensor          # (the stencil offsets of every route)
    ring: torch.Tensor        # (n_win,) int32 max(|di|, |dj|): the cells
    #                           a window lies out (the variable prep's)
    r2: torch.Tensor          # () float32 square of the float32 radius
    #                           (the tile path and the pipeline)
    set_off: torch.Tensor     # (n_sets + 1,) int32 first index of each set
    set_ids: torch.Tensor | None   # (n,) int32 set of each point (several
    #                                sets), else None
    allow: torch.Tensor | None     # (n_sets,) int32 active matrix
    #       (``allow_table``) of K3, K4 and split staging on the fused
    #       route (``contracts_applicable``), else None


def step_constants(cfg: SearchConfig, knobs: FastKnobs, cell_size: float,
                   device, *, search_radius: float) -> StepConsts:
    """The ``StepConsts`` of ``cfg`` and ``knobs`` at this cell size and
    search radius (0 in variable mode, where no search reads it).  The
    active matrix only where the fused route runs: off it the candidate
    sets may pass the 32 bits of an ``allow_table`` entry."""
    st = _statics(cfg, knobs)
    offs = torch.tensor(st["offs_2d"], dtype=torch.int32, device=device)
    r = np.float32(search_radius)
    return StepConsts(
        torch.tensor(cell_size, dtype=torch.float32, device=device),
        offs[:, 0].contiguous(), offs[:, 1].contiguous(),
        offs.abs().amax(dim=1),
        torch.tensor(r * r, dtype=torch.float32, device=device),
        torch.tensor(cfg.set_offsets, dtype=torch.int32, device=device),
        set_ids_of(cfg, device) if cfg.n_sets > 1 else None,
        allow_table(cfg, st["cand_sets"], device)
        if contracts_applicable(cfg, knobs) else None)


def _statics(cfg: SearchConfig, knobs: FastKnobs) -> dict:
    """Static sizes shared by prep and search (``_pallas_statics``)."""
    w = cfg.stencil_w
    tiles_cap = knobs.tiles_cap if knobs.tiles_cap > 0 else \
        default_tiles_cap(cfg.n_points)
    wcap = round_up(knobs.wcap, 8)
    return {
        "w": w,
        "tiles_cap": tiles_cap,
        "NPAD": tiles_cap * TILE,
        # the tile path's window cap and the sentinel tail past NPAD that
        # a window load of wcap slots from a start <= NPAD may read
        "wcap": wcap,
        "slack": round_up(wcap, TILE),
        # descriptor rows: one spare past tiles_cap, rounded to 8, so the
        # descriptor array has the JAX prep's shape
        "nt8": -(-(tiles_cap + 1) // 8) * 8,
        "rows_cap": knobs.rows_cap if knobs.rows_cap > 0 else
        max(1 << 14, knobs.dense_cap >> 3),
        "offs_2d": [(di, dj) for di in range(-w, w + 1)
                    for dj in range(-w, w + 1)],
        "cand_sets": tuple(sorted({sj for (_, sj) in cfg.active_pairs})),
    }


def _lin_coords(ijk: torch.Tensor, w: int, dy, dz) -> torch.Tensor:
    """Padded linear cell id; ijk are unpadded int32 coords (N, 3)."""
    return ((ijk[..., 0] + w) * dy + (ijk[..., 1] + w)) * dz + (ijk[..., 2] + w)


def _padded_lin(points: torch.Tensor, state: GridState, cfg: SearchConfig,
                knobs: FastKnobs, lin_base=None):
    """Linear padded cell id per point, plus the padded grid strides.
    ``lin_base`` (a device scalar) rebases the id to a contiguous window
    of the global grid (a rank's slab and halos, ``parallel/sharded.py``);
    quantization keeps the global grid origin, so the cell of every point
    is the one-device cell (``fastpath.py:477-497`` of the JAX
    package)."""
    w = cfg.stencil_w
    dy = state.n_cells[1] + 2 * w
    dz = state.n_cells[2] + 2 * w
    inv_cell = 1.0 / state.cell_size
    ijk = K.quantize(points, state.grid_min, inv_cell, state.n_cells)
    lin = _lin_coords(ijk, w, dy, dz)
    if lin_base is not None:
        lin = lin - lin_base
    lin = torch.clamp(lin, 0, knobs.dense_cap - 1)
    return lin, dy, dz, inv_cell


def _cell_table(lin_s: torch.Tensor, dense_cap: int) -> torch.Tensor:
    """table[q] = number of points with lin < q, q in [0, dense_cap]: the
    sorted start of cell q, empty cells pointing at the next occupied
    cell.  A histogram and one cumsum."""
    hist = torch.zeros(dense_cap + 1, dtype=torch.int32, device=lin_s.device)
    hist.index_add_(0, (lin_s + 1).long(), torch.ones_like(lin_s))
    return torch.cumsum(hist, 0, dtype=torch.int32)


def _i32(x) -> torch.Tensor:
    return x.to(torch.int32)


def _prep(points: torch.Tensor, state: GridState, cfg: SearchConfig,
          knobs: FastKnobs, radii: torch.Tensor | None = None,
          padded: bool = False, valid: torch.Tensor | None = None,
          owned_rng: tuple | None = None, lin_base=None,
          span_i=None, *, consts: StepConsts) -> FastCarry:
    """Sort, dense table, row-aligned layout and window descriptors
    (``_pallas_prep``, row layout, window starts in sorted space: the
    ``win_sorted`` branch that production ``rec_expand`` uses).  With
    ``padded`` (the tile path) the window starts are in padded-slot space
    instead, each shifted by its grid row's padding and clipped to NPAD
    (the JAX prep with ``use_pallas=False, rec_expand=False``): a
    window's k-run lies in one grid row, so it stays contiguous and keeps
    its length.  In variable mode (``cfg.variable``, ``radii`` (n,)
    float32) each window reaches only as far as the larger of the tile's
    and the neighbor row's largest radius, at most the static W cells;
    ``reach_overflow`` is 1 when the largest radius needs more (the
    windows then miss neighbors), by ``api._stencil_w``'s float32 test.
    Requires ``cfg.n_points > 0``.  ``_prep.calls`` counts its calls.
    ``consts`` are the search's ``step_constants``, so the prep copies
    nothing from the host.

    The sharded search's parameters (``fastpath.py:499-515, 699-705,
    733-736`` of the JAX package): ``valid`` ((n,) bool) parks the rows
    flagged False in the last dense-table slot, after every real row;
    ``lin_base`` rebases the cell ids (``_padded_lin``); ``span_i``, the
    padded i-extent of that window, replaces the grid's in the dense and
    row overflow checks; ``owned_rng`` ((lo, hi) in rebased padded row-i
    units, ``trow // dy``) leaves the tiles of grid rows outside [lo, hi)
    no windows and marks them dead (FAT_COL = 2), so only the owned rows
    are queries while every row serves as a candidate."""
    _prep.calls += 1
    st = _statics(cfg, knobs)
    n = cfg.n_points
    dev = points.device
    w = st["w"]
    tiles_cap, NPAD, nt8 = st["tiles_cap"], st["NPAD"], st["nt8"]
    rows_cap = st["rows_cap"]
    dense_cap = knobs.dense_cap

    def arange(m):
        return torch.arange(m, dtype=torch.int32, device=dev)

    dx = state.n_cells[0] + 2 * w if span_i is None else span_i
    lin, dy, dz, inv_cell = _padded_lin(points, state, cfg, knobs, lin_base)
    if valid is not None:
        lin = torch.where(valid, lin, dense_cap - 1)
    # in float, so a huge sparse domain cannot wrap int32
    dense_size_f = (dx.to(torch.float32) * dy.to(torch.float32)
                    * dz.to(torch.float32))
    dense_overflow = _i32(dense_size_f > float(np.float32(dense_cap - 1)))
    iota = arange(n)
    lin_s, order = torch.sort(lin, stable=True)
    idx_s = _i32(order)
    r_s = radii[order] if cfg.variable else \
        torch.zeros(0, dtype=torch.float32, device=dev)
    table = _cell_table(lin_s, dense_cap)

    # ---- row-aligned layout: every occupied grid row padded to 128 ------
    rows_overflow = _i32(dx * dy + 1 > rows_cap)
    r_eff = torch.minimum(arange(rows_cap + 1), dense_cap // dz + 1)
    row_starts = table[torch.clamp(r_eff * dz, max=dense_cap)]
    row_len = row_starts[1:] - row_starts[:-1]
    row_pads = torch.remainder(-row_len, TILE)
    pads_inc = torch.cumsum(row_pads, 0, dtype=torch.int32)
    pads_exc = pads_inc - row_pads
    tile_overflow = _i32(n + pads_inc[-1] > NPAD)
    # per-point padding offset: each row's pad increment at the row's
    # first sorted point, then one cumsum
    pad_step = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    pad_step.index_add_(0, torch.clamp(row_starts[:-1], max=n).long(),
                        torch.cat([row_pads.new_zeros(1), row_pads[:-1]]))
    pp = torch.clamp(iota + torch.cumsum(pad_step[:n], 0, dtype=torch.int32),
                     max=NPAD - 1)

    # ---- per-tile grid row and k-extent ---------------------------------
    # tile -> row = max{r : pstart[r] <= 128 t}: padded row starts are
    # 128-aligned, so row r claims tile pstart[r] // 128 by scatter-max
    # (a spare slot takes the claims past tiles_cap) and a cummax fills
    # the gaps
    pstart = row_starts[:-1] + pads_exc
    claim = torch.clamp(pstart // TILE, max=tiles_cap).long()
    tr0 = torch.zeros(tiles_cap + 1, dtype=torch.int32, device=dev)
    tr0.scatter_reduce_(0, claim, arange(rows_cap), reduce="amax")
    tr = torch.cummax(tr0[:tiles_cap], 0).values
    trl = tr.long()
    off_t = arange(tiles_cap) * TILE - pstart[trl]
    cnt_t = torch.clamp(row_len[trl] - off_t, 0, TILE)
    has = cnt_t > 0
    a_t = torch.clamp(row_starts[:-1][trl] + off_t, 0, n - 1)
    b_t = torch.clamp(a_t + cnt_t - 1, 0, n - 1)
    lmin = torch.where(has, lin_s[a_t.long()], 0)
    lmax = torch.where(has, lin_s[b_t.long()], 0)
    trow = torch.where(has, tr, 0)
    k0 = torch.clamp(lmin - trow * dz, min=0)
    k1 = torch.clamp(lmax - trow * dz, min=0)

    # ---- local stencil reach (variable mode) ----------------------------
    # the static W bounds the (di, dj) offsets; a tile reaches only as far
    # as max(its own largest radius, the neighbor row's largest radius):
    # the reference's per-node ghost width (TreeNSearch.cpp:1457-1466)
    if cfg.variable:
        rid = torch.clamp(lin_s // dz, max=rows_cap - 1).long()
        row_rmax = torch.zeros(rows_cap, dtype=torch.float32, device=dev)
        row_rmax.scatter_reduce_(0, rid, r_s, reduce="amax")
        lane = arange(TILE)
        g_idx = torch.clamp(a_t[:, None] + lane[None, :], max=n - 1).long()
        tile_rmax = torch.where(lane[None, :] < cnt_t[:, None], r_s[g_idx],
                                0.0).amax(dim=1)

    # ---- window descriptors: one sorted k-run per (di, dj) --------------
    # window = [table[row' dz + k0 - w], table[row' dz + k1 + w + 1]) of
    # neighbor row row' = trow + di dy + dj; distinct (di, dj) give
    # disjoint runs
    di, dj = consts.di, consts.dj
    rp = torch.clamp(trow[:, None] + di[None, :] * dy + dj[None, :], min=0)
    rp = torch.minimum(rp, dense_cap // dz)
    base = torch.clamp(rp * dz, max=dense_cap)
    if cfg.variable:
        # smallest whole number of cells that covers the reach, by the
        # same float32 test as the host's stencil width (no epsilon); a
        # reach is >= 0, so the cast floors
        reach = torch.maximum(tile_rmax[:, None],
                              row_rmax[torch.clamp(rp, max=rows_cap - 1)])
        w0 = (reach * inv_cell).to(torch.int32)
        wn = w0 + (w0.to(torch.float32) * state.cell_size < reach)
        wk = torch.clamp(wn, 1, w)
        ok = consts.ring[None, :] <= wk
        # no reach exceeds the largest radius, and the tile holding it
        # reaches by it in its own row (the centre window): the centre
        # column's widest need is the largest radius's
        reach_overflow = torch.gt(
            wn[:, len(st["offs_2d"]) // 2].amax(), w,
            out=torch.empty((), dtype=torch.int32, device=dev))
    else:
        wk, ok = w, True
        reach_overflow = torch.zeros(0, dtype=torch.int32, device=dev)
    s = table[torch.clamp(base + k0[:, None] - wk, 0, dense_cap).long()]
    e = table[torch.clamp(base + k1[:, None] + wk + 1, 0, dense_cap).long()]
    lens = torch.clamp(e - s, min=0) * (has[:, None] & ok)
    if padded:
        starts = torch.clamp(
            s + pads_exc[torch.clamp(rp, max=rows_cap - 1).long()], 0, NPAD)
    else:
        starts = torch.clamp(s, 0, n)
    n_win = len(st["offs_2d"])
    if owned_rng is not None:
        i_pad = trow // dy
        has = has & (i_pad >= owned_rng[0]) & (i_pad < owned_rng[1])
        lens = lens * has[:, None]

    desc = torch.zeros((nt8, DESC_W), dtype=torch.int32, device=dev)
    desc[:tiles_cap, :n_win] = starts
    desc[:tiles_cap, LENS_OFF:LENS_OFF + n_win] = _i32(lens)
    desc[:tiles_cap, A_COL] = a_t
    desc[:tiles_cap, CNT_COL] = cnt_t
    desc[:tiles_cap, FAT_COL] = torch.where(has, 0, 2)

    # ---- carried maps -----------------------------------------------------
    inv_perm = torch.empty_like(iota).scatter_(0, order, iota)
    qpos = torch.empty_like(iota).scatter_(0, order, pp)
    if n > 1:
        n_cells_stat = 1 + _i32((lin_s[1:] != lin_s[:-1]).sum())
    else:
        n_cells_stat = torch.full((), n, dtype=torch.int32, device=dev)
    return FastCarry(
        valid=torch.ones((), dtype=torch.bool, device=dev),
        lin_s=lin_s, lin_chk=lin, r_chk=r_s, idx_s=idx_s, inv_perm=inv_perm,
        pp=pp,
        qpos=qpos, desc=desc, dense_overflow=dense_overflow,
        tile_overflow=tile_overflow, rows_overflow=rows_overflow,
        win_max=_i32(lens.max()), n_cells_stat=n_cells_stat,
        reach_overflow=reach_overflow)


_prep.calls = 0


def mask_rows(points: torch.Tensor, state: GridState, cfg: SearchConfig,
              knobs: FastKnobs, consts: StepConsts,
              radii: torch.Tensor | None = None) -> int:
    """K4's row count on these points and this grid (a prep and one host
    read), for a step's ``mask_rows_cap`` where no settled count exists."""
    st = _statics(cfg, knobs)
    desc = _prep(points, state, cfg, knobs, radii, consts=consts).desc
    return int(mask_cand_base(desc, cfg.n_points, len(st["offs_2d"]),
                              st["tiles_cap"])[-1])


def make_fast_carry0(cfg: SearchConfig, knobs: FastKnobs,
                     device) -> FastCarry:
    """A fresh, invalid carry with the shapes ``_prep`` gives
    (``fastpath.py:452-474`` of the JAX package): the first step of
    ``build_and_search_fast_carry`` rebuilds it."""
    st = _statics(cfg, knobs)
    n = cfg.n_points

    def z(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    return FastCarry(
        valid=torch.zeros((), dtype=torch.bool, device=device),
        lin_s=z(n), lin_chk=z(n),
        r_chk=torch.zeros(n if cfg.variable else 0, dtype=torch.float32,
                          device=device),
        idx_s=z(n), inv_perm=z(n), pp=z(n), qpos=z(n),
        desc=z(st["nt8"], DESC_W), dense_overflow=z(), tile_overflow=z(),
        rows_overflow=z(), win_max=z(), n_cells_stat=z(),
        reach_overflow=z() if cfg.variable else z(0))


def sorted_records(points: torch.Tensor, idx_s: torch.Tensor,
                   radii: torch.Tensor | None = None,
                   set_ids: torch.Tensor | None = None,
                   payload: torch.Tensor | None = None,
                   orig: torch.Tensor | None = None) -> torch.Tensor:
    """Sorted field-major records (8, n) int32: x, y, z and r as float32
    bit patterns (r = 0 without ``radii``), orig (the index into the
    concatenated sets: ``idx_s``, or with ``orig`` (n,) int32 that of
    each row, as the sharded search's routed rows carry it), the set id
    (0 without ``set_ids``), and the reduce contract's payload p0, p1 as
    float32 bit patterns (0 without ``payload`` (n, 2) float32;
    ``fastpath.py:1119-1123, 1178-1198`` of the JAX package)."""
    n = points.shape[0]
    order = idx_s.long()
    recs_t = torch.zeros((N_FIELDS, n), dtype=torch.int32,
                         device=points.device)
    recs_t[F_X:F_Z + 1] = points[order].view(torch.int32).t()
    if radii is not None:
        recs_t[F_R] = radii[order].view(torch.int32)
    recs_t[F_ORIG] = idx_s if orig is None else orig[order]
    if set_ids is not None:
        recs_t[F_SET] = set_ids[order]
    if payload is not None:
        recs_t[F_P0:F_P1 + 1] = payload[order].view(torch.int32).t()
    return recs_t


def set_ids_of(cfg: SearchConfig, device) -> torch.Tensor:
    """(n,) int32 set id of each point of the concatenated sets."""
    return torch.repeat_interleave(
        torch.arange(cfg.n_sets, dtype=torch.int32, device=device),
        torch.tensor(cfg.set_sizes, device=device),
        output_size=cfg.n_points)


class KernelInputs(NamedTuple):
    """The arguments K1 and the pairs kernel take from one prep."""
    desc: torch.Tensor     # (nt8, 128) window descriptors
    recs_t: torch.Tensor   # (8, n) sorted field-major records
    tiles_cap: int
    n_win: int             # (2W+1)^2 stencil windows
    r2: float              # float32 square of the float32 radius (fixed)
    cand_sets: tuple       # distinct candidate sets, one output block each
    cand_offsets: tuple    # each candidate set's first concatenated index
    k8s: tuple             # each block's row width: its cap rounded to 8
    variable: bool         # per-point radii (K2c)
    symmetric: bool        # d^2 <= r_j^2 also counts (K2c)
    multi_set: bool        # more than one point set (K2b filters by set)


def kernel_inputs(points: torch.Tensor, search_radius: float,
                  carry: FastCarry, cfg: SearchConfig, knobs: FastKnobs,
                  radii: torch.Tensor | None = None,
                  payload: torch.Tensor | None = None,
                  orig: torch.Tensor | None = None,
                  set_ids: torch.Tensor | None = None) -> KernelInputs:
    """Record build and the kernels' static arguments (``_pallas_search``,
    ``fastpath.py:1083-1098, 1158-1232``); ``payload`` (n, 2) float32
    rides the records for the fused reduce.  ``orig`` and ``set_ids``
    ((n,) int32) give each row's concatenated index and set when the rows
    are not the sets of ``cfg`` themselves: the sharded search's routed
    rows, whose ``carry`` covers only them (the role of ``_pallas_search
    (orig_ids=, set_ids_data=)``); ``cfg`` then still describes the
    global sets."""
    st = _statics(cfg, knobs)
    multi = cfg.n_sets > 1
    if set_ids is None and multi:
        set_ids = set_ids_of(cfg, points.device)
    recs = sorted_records(
        points, carry.idx_s, radii if cfg.variable else None, set_ids,
        payload, orig)
    r = np.float32(search_radius)
    cand = st["cand_sets"]
    return KernelInputs(
        carry.desc, recs, st["tiles_cap"], len(st["offs_2d"]),
        float(r * r), cand, tuple(cfg.set_offsets[sj] for sj in cand),
        tuple(round_up(cfg.cap_of(sj), 8) for sj in cand),
        cfg.variable, cfg.symmetric, multi)


def allow_table(cfg: SearchConfig, cand_sets: tuple,
                device) -> torch.Tensor:
    """The active matrix as K3 and K4 read it: (n_sets,) int32, bit b of
    entry si set when set si searches candidate set ``cand_sets[b]`` (the
    role of the JAX kernels' per-set OR, ``pallas_pairs.py:736-752``)."""
    bits = [0] * cfg.n_sets
    for si, sj in cfg.active_pairs:
        bits[si] |= 1 << cand_sets.index(sj)
    return torch.tensor(bits, dtype=torch.int32, device=device)


def active_args(a: KernelInputs) -> dict:
    """The radius-mode arguments of K3 and K4 for these inputs."""
    return {"r2": None if a.variable else a.r2, "symmetric": a.symmetric}


def pairs_kernel(a: KernelInputs):
    """The pairs kernel's wrapper for these inputs: K2c for per-point
    radii, K2b for several sets, K2a for one set at a fixed radius."""
    if a.variable:
        return pairs_nbrs_variable
    return pairs_nbrs_sets if a.multi_set else pairs_nbrs_fixed


def split_pairs(a: KernelInputs, q_t: torch.Tensor, allow: torch.Tensor,
                plain: bool = False, rows_cap: int | None = None):
    """Split staging (``fastpath.py:1303-1334`` of the JAX package): K4's
    hit bits under the active matrix ``allow``, then K5 unpacks them into
    the pairs kernel's blocks (each pass's plain version with ``plain``).
    ``rows_cap`` caps K4's rows (``pairs_mask``).  Returns counts
    (n_blocks, tiles_cap * 128), one tile-layout row array per candidate
    set and K4's ``cand_base``."""
    mask, unpack = (pairs_mask_plain, pairs_nbrs_from_bits_plain) \
        if plain else (pairs_mask, pairs_nbrs_from_bits)
    _, bits, cand_base = mask(a.desc, q_t, a.recs_t, a.n_win, a.tiles_cap,
                              a.cand_sets, allow, **active_args(a),
                              rows_cap=rows_cap)
    return (*unpack(a.desc, a.recs_t, bits, cand_base, a.n_win,
                    a.tiles_cap, a.cand_sets, a.cand_offsets, a.k8s),
            cand_base)


def run_pairs(a: KernelInputs, q_t: torch.Tensor, plain: bool = False,
              allow: torch.Tensor | None = None, tested=None):
    """The pairs kernel (or, with ``plain``, its plain version) on these
    inputs: counts (n_blocks, tiles_cap * 128) and one tile-layout row
    array per candidate set; ``tested`` is the K2 wrappers' counter of
    the tests left after their cull (``ops/pairs.py``).

    With ``allow`` (the active matrix, ``allow_table``), split staging in
    its place (``split_pairs``, K4 uncapped).  Only the slots of active
    pairs are the pairs kernel's: a query whose set does not search a
    block's candidate set counts 0 there."""
    if allow is not None:
        return split_pairs(a, q_t, allow, plain)[:2]
    kernel = pairs_kernel(a)
    if kernel is pairs_nbrs_fixed:
        fn = pairs_nbrs_fixed_plain if plain else pairs_nbrs_fixed
        counts, nbrs = fn(a.desc, q_t, a.recs_t, a.r2, a.n_win, a.k8s[0],
                          a.tiles_cap, tested)
        return counts[None], [nbrs]
    blocks = (a.cand_sets, a.cand_offsets, a.k8s)
    if plain:
        return pairs_nbrs_plain(a.desc, q_t, a.recs_t, a.n_win, a.tiles_cap,
                                *blocks, r2=None if a.variable else a.r2,
                                symmetric=a.symmetric, tested=tested)
    if a.variable:
        return kernel(a.desc, q_t, a.recs_t, a.n_win, a.tiles_cap, *blocks,
                      a.symmetric, tested)
    return kernel(a.desc, q_t, a.recs_t, a.r2, a.n_win, a.tiles_cap,
                  *blocks, tested)


_FLAGS = ("n_cells", "error", "dense_overflow", "tile_overflow",
          "rows_overflow", "tiles_used", "win_max")


def _flags(state: GridState, carry: FastCarry, tiles_cap: int) -> dict:
    """The regrow flags and statistics every search returns, copied out of
    the state and carry in one stack (a step rewrites those in place);
    in variable mode ``reach_overflow`` too."""
    # dead tiles (FAT_COL = 2) are a suffix of the layout
    used = _i32((carry.desc[:tiles_cap, FAT_COL] != 2).sum())
    names, values = _FLAGS, [
        carry.n_cells_stat, state.error, carry.dense_overflow,
        carry.tile_overflow, carry.rows_overflow, used, carry.win_max]
    if carry.reach_overflow.dim() == 0:
        names, values = names + ("reach_overflow",), \
            values + [carry.reach_overflow]
    flags = dict(zip(names, torch.stack(values).unbind()))
    # no window is cut on the fused route
    flags["cand_max"] = torch.zeros_like(carry.win_max)
    return flags


def _mask_flags(cand_base: torch.Tensor, rows_cap: int | None) -> dict:
    """K4's row count and, under a row cap, whether it passed the cap."""
    rows = cand_base[-1]
    over = rows > rows_cap if rows_cap is not None else \
        torch.zeros_like(rows, dtype=torch.bool)
    return {"mask_rows": rows, "mask_overflow": _i32(over)}


def _per_set(x: torch.Tensor, cfg: SearchConfig) -> dict:
    """Slices of a (..., n) tensor in concatenated order, one per set."""
    offs = cfg.set_offsets
    return {f"s{si}": x[..., offs[si]:offs[si + 1]]
            for si in range(cfg.n_sets)}


def _search_reduce(points, radii, payload, search_radius, state, carry,
                   cfg, knobs, spec: ReduceSpec, allow,
                   set_ids=None) -> dict:
    """Records (with the payload), K1, K3 and the reduce epilogue
    (``fastpath.py:1350-1407`` without the fat tier to merge): one gather
    of the (n_out, slots) sums through ``qpos``, then per-set slices
    ``{"s<i>": (n_out, n_i)}``."""
    a = kernel_inputs(points, search_radius, carry, cfg, knobs, radii,
                      payload, set_ids=set_ids)
    q_t = expand_query_tiles(a.desc, a.recs_t, a.tiles_cap, cfg.n_points)
    sums = pairs_reduce(a.desc, q_t, a.recs_t, a.n_win, a.tiles_cap, spec,
                        a.cand_sets, allow, **active_args(a))
    return {"reduce": _per_set(sums[:, carry.qpos.long()], cfg),
            "pairs": {}, **_flags(state, carry, a.tiles_cap)}


def _search_mask(points, radii, search_radius, state, carry, cfg, knobs,
                 allow, set_ids=None, rows_cap=None) -> dict:
    """Records, K1, K4 and the mask epilogue (``fastpath.py:1409-1463``,
    ``cand_orig`` at ``:1229-1232``); see ``decode_mask`` for the layout.
    ``rows_cap`` caps K4's rows (``pairs_mask``; ``mask_overflow`` says
    whether they passed it)."""
    a = kernel_inputs(points, search_radius, carry, cfg, knobs, radii,
                      set_ids=set_ids)
    q_t = expand_query_tiles(a.desc, a.recs_t, a.tiles_cap, cfg.n_points)
    counts_flat, bits, cand_base = pairs_mask(
        a.desc, q_t, a.recs_t, a.n_win, a.tiles_cap, a.cand_sets, allow,
        **active_args(a), rows_cap=rows_cap)
    mask = {"bits": bits, "cand_base": cand_base, "desc": a.desc,
            "qpos": carry.qpos, "q_orig": q_t[F_ORIG], "q_set": q_t[F_SET],
            "cand_orig": a.recs_t[F_ORIG],
            "counts": _per_set(counts_flat[carry.qpos.long()], cfg),
            "counts_flat": counts_flat}
    return {"mask": mask, "pairs": {}, **_flags(state, carry, a.tiles_cap),
            **_mask_flags(cand_base, rows_cap)}


def _search(points: torch.Tensor, radii: torch.Tensor | None,
            search_radius: float, state: GridState, carry: FastCarry,
            cfg: SearchConfig, knobs: FastKnobs,
            allow: torch.Tensor | None = None, set_ids=None,
            rows_cap: int | None = None, tested=None) -> dict:
    """Record build, K1, the pairs kernel and the counts epilogue
    (``_pallas_search``, neighbor-list branch, ``fastpath.py:1465-1589``);
    with ``allow`` (split staging), K4 (its rows capped at ``rows_cap``,
    with ``_mask_flags``) and K5 in the pairs kernel's place.  Without
    ``allow``, ``tested`` (a (1,) int64 counter) goes to the pairs
    kernel (``run_pairs``) and into the solution as ``tested``.

    One output block per distinct candidate set: pairs (si, sj) that share
    sj share its tile-layout rows, each through its own slice of ``qpos``
    (the roles of the JAX ``blocks``/``qpos_set`` and ``attach_blocks``).
    A pair whose query set is empty gets empty arrays."""
    a = kernel_inputs(points, search_radius, carry, cfg, knobs, radii,
                      set_ids=set_ids)
    q_t = expand_query_tiles(a.desc, a.recs_t, a.tiles_cap, cfg.n_points)
    extra = {}
    if allow is None:
        counts_t, nbrs_t = run_pairs(a, q_t, tested=tested)
        if tested is not None:
            extra["tested"] = tested
    else:
        counts_t, nbrs_t, cand_base = split_pairs(a, q_t, allow,
                                                  rows_cap=rows_cap)
        extra = _mask_flags(cand_base, rows_cap)
    # every block's counts through one gather
    gathered = counts_t[:, carry.qpos.long()]
    offs = cfg.set_offsets
    zero = torch.zeros((), dtype=torch.int32, device=points.device)
    pairs = {}
    for (si, sj) in cfg.active_pairs:
        b = a.cand_sets.index(sj)
        n_i = cfg.set_sizes[si]
        if n_i == 0:
            pairs[f"{si}-{sj}"] = {
                "counts": gathered.new_zeros(0),
                "nbrs": gathered.new_zeros((0, a.k8s[b])),
                "max_count": zero}
            continue
        counts = gathered[b, offs[si]:offs[si] + n_i]
        pairs[f"{si}-{sj}"] = {"counts": counts, "max_count": counts.max(),
                               "nbrs_tiles": nbrs_t[b],
                               "qpos": carry.qpos[offs[si]:offs[si] + n_i]}
    return {"pairs": pairs, **_flags(state, carry, a.tiles_cap), **extra}


def _empty_solution(cfg: SearchConfig, state: GridState) -> dict:
    dev = state.error.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    pairs = {}
    for (si, sj) in cfg.active_pairs:
        n_i = cfg.set_sizes[si]
        pairs[f"{si}-{sj}"] = {
            "counts": torch.zeros(n_i, dtype=torch.int32, device=dev),
            "nbrs": torch.full((n_i, round_up(cfg.cap_of(sj), 8)), -1,
                               dtype=torch.int32, device=dev),
            "max_count": zero}
    sol = {"pairs": pairs, "n_cells": zero, "error": state.error.clone(),
           "dense_overflow": zero, "tile_overflow": zero,
           "rows_overflow": zero, "tiles_used": zero, "win_max": zero,
           "cand_max": zero}
    if cfg.variable:
        sol["reach_overflow"] = zero
    return sol


def applicable(cfg: SearchConfig, knobs: FastKnobs) -> bool:
    """The gate of the fused pairs kernels (``_pallas_applicable``,
    ``fastpath.py:1592-1606`` of the JAX package): 1 to 8 distinct
    candidate sets, a stencil of at most 3 cells and ``knobs.fused``.
    ``build_and_search_fast`` takes the tile path where it refuses."""
    n_cand = len({sj for (_, sj) in cfg.active_pairs})
    return knobs.fused and 1 <= n_cand <= MAX_BLOCKS \
        and cfg.stencil_w <= MAX_STENCIL_W


def contracts_applicable(cfg: SearchConfig, knobs: FastKnobs) -> bool:
    """The gate of the fused reduce (K3), the mask (K4) and the carry:
    ``applicable``, where no active search at all is also accepted."""
    return applicable(cfg, knobs) or (
        knobs.fused and not cfg.active_pairs
        and cfg.stencil_w <= MAX_STENCIL_W)


def build_and_search_fast(points: torch.Tensor, search_radius: float,
                          state: GridState,
                          cfg: SearchConfig, knobs: FastKnobs,
                          radii: torch.Tensor | None = None,
                          reduce: ReduceSpec | None = None,
                          payload: torch.Tensor | None = None,
                          mask: bool = False, *, consts: StepConsts,
                          rows_cap: int | None = None,
                          snug_tiles: bool = False, tested=None
                          ) -> tuple[dict, GridState]:
    """One full search, rebuilt on every call: grid update, prep,
    records, K1, the pairs kernel, counts; where ``applicable`` refuses,
    the tile path (``_tile_search``) instead.  ``radii`` (n,) float32 in
    variable mode, else None.  With ``reduce`` the fused reduce (K3,
    ``payload`` (n, 2) float32 or None) and with ``mask`` the bitmask
    kernel (K4) take the pairs kernel's place; both need ``cfg.n_points >
    0`` and ``contracts_applicable``.  ``knobs.split_stage`` runs K4 and
    K5 for the pairs kernel.  ``rows_cap`` caps K4's rows (None: exact,
    one host read).  The tile path tests every tile's windows at the
    full window cap (``_xla_tile_search``'s static sizes); with
    ``snug_tiles`` it reads the live tile count and the widest window
    back first (one host read) and tests only as far as they reach,
    with the same result.  ``tested`` as ``_search`` takes it (on the
    fused route's pairs kernel only).

    The new grid is written into ``state``'s tensors, which are returned.
    ``consts`` are ``step_constants(cfg, knobs, cell_size, device,
    search_radius=search_radius)`` and give the cell size; with a
    ``rows_cap`` and without ``snug_tiles`` no route reads anything back
    to the host, so a CUDA graph can capture the search."""
    contract = reduce is not None or mask
    if contract and not contracts_applicable(cfg, knobs):
        raise ValueError("the fused reduce and the mask need the fused "
                         "route (knobs.fused, <= 8 candidate sets, a "
                         "stencil of at most 3 cells)")
    assign_(state, update_grid(state, points, consts.cell_size))
    if not contract and (cfg.n_points == 0 or not cfg.active_pairs):
        return _empty_solution(cfg, state), state
    if contract or applicable(cfg, knobs):
        carry = _prep(points, state, cfg, knobs, radii, consts=consts)
        return _search_any(points, radii, payload, search_radius, state,
                           carry, cfg, knobs, reduce, mask, consts,
                           rows_cap, tested), state
    carry = _prep(points, state, cfg, knobs, radii, padded=True,
                  consts=consts)
    st = _statics(cfg, knobs)
    n_tiles, width = st["tiles_cap"], st["wcap"]
    if snug_tiles:
        # dead tiles (FAT_COL = 2) are a suffix of the layout
        used, win_max = torch.stack([
            (carry.desc[:n_tiles, FAT_COL] != 2).sum(),
            carry.win_max.long()]).tolist()
        n_tiles, width = used, max(1, min(width, win_max))
    return _tile_search(points, radii, state, carry, cfg, knobs, consts,
                        n_tiles, width), state


def _tile_search(points: torch.Tensor, radii: torch.Tensor | None,
                 state: GridState, carry: FastCarry, cfg: SearchConfig,
                 knobs: FastKnobs, consts: StepConsts, n_tiles: int,
                 width: int) -> dict:
    """The tile path on a padded-layout prep (``_xla_tile_search``,
    ``fastpath.py:1730-1886`` of the JAX package; the role of the
    reference's scalar pipeline, ``TreeNSearch.cpp:1873-2160``).

    K1r lays the sorted records out as ``rec_pad``, slot-major with a
    sentinel tail of ``slack`` >= wcap slots, and every query and window
    is read from it: tile t's queries are slots [128 t, 128 t + 128), its
    window w the first ``width`` of the ``wcap`` slots from ``desc[t,
    w]``.  A candidate hits when d^2 = (dx*dx + dy*dy) + dz*dz <= r^2 in
    float32 (variable: <= r_i^2; symmetric: also <= r_j^2), it lies
    inside the window's length and its orig differs from the query's
    (windows are disjoint runs, so one compare is the self-exclusion).
    Per active pair the hits of the query set si in candidate set sj are
    counted exactly and their set-local indices front-packed in window
    order into ``cfg.nbr_cap`` slots, then gathered per point through
    ``qpos``.  A window wider than wcap is cut and ``cand_max`` reports
    its length, so the host regrows wcap and re-runs.

    Tiles [0, ``n_tiles``) go in groups sized so a group holds about
    ``_TILE_SLOTS`` (query, candidate) slots (the role of the JAX
    ``group`` knob and its ``lax.map``).  The slots past a window's
    length are masked and dead tiles have no windows (their rows are
    never gathered), so any ``n_tiles`` from the live tiles to
    ``tiles_cap`` and any ``width`` from the widest window to ``wcap``
    give the same result; ``build_and_search_fast`` picks them.  The
    radius, set offsets and set ids come from ``consts``, so with sizes
    that do not depend on the data nothing is read back to the host."""
    st = _statics(cfg, knobs)
    dev = points.device
    n = cfg.n_points
    tiles_cap, n_win, wcap = st["tiles_cap"], len(st["offs_2d"]), st["wcap"]
    multi = cfg.n_sets > 1
    recs_t = sorted_records(points, carry.idx_s,
                            radii if cfg.variable else None, consts.set_ids)
    _, rec_pad = expand_records(carry.desc, recs_t, tiles_cap, n, st["slack"])
    flags = _flags(state, carry, tiles_cap)
    k = cfg.nbr_cap
    n_slots = tiles_cap * TILE
    names = [f"{si}-{sj}" for (si, sj) in cfg.active_pairs]
    counts = {p: torch.zeros(n_slots, dtype=torch.int32, device=dev)
              for p in names}
    nbrs = {p: torch.full((n_slots, k), -1, dtype=torch.int32, device=dev)
            for p in names}
    fields = rec_pad.view(torch.float32)
    lane = torch.arange(width, dtype=torch.int32, device=dev)
    group = max(1, _TILE_SLOTS // (TILE * n_win * width))
    for t0 in range(0, n_tiles, group):
        t1 = min(t0 + group, n_tiles)
        g = t1 - t0
        q = rec_pad[t0 * TILE:t1 * TILE].view(g, TILE, 1, N_FIELDS)
        qf = fields[t0 * TILE:t1 * TILE].view(g, TILE, 1, N_FIELDS)
        starts = carry.desc[t0:t1, :n_win]
        lens = carry.desc[t0:t1, LENS_OFF:LENS_OFF + n_win]
        idx = (starts[:, :, None] + lane).reshape(g, 1, -1).long()
        in_win = (lane < lens[:, :, None]).reshape(g, 1, -1)
        c = rec_pad[idx]              # (g, 1, n_win * width, 8)
        cf = c.view(torch.float32)
        dx, dy, dz = (cf[..., f] - qf[..., f] for f in (F_X, F_Y, F_Z))
        d2 = (dx * dx + dy * dy) + dz * dz
        del dx, dy, dz
        if cfg.variable:
            q_r = qf[..., F_R]
            crit = d2 <= q_r * q_r
            if cfg.symmetric:
                c_r = cf[..., F_R]
                crit |= d2 <= c_r * c_r
                del c_r
        else:
            crit = d2 <= consts.r2
        del d2
        hit = crit & in_win & (c[..., F_ORIG] != q[..., F_ORIG])
        del crit
        # set-local rebase by the candidate's set (the sentinel's -1 reads
        # set 0)
        c_set, q_set = c[..., F_SET], q[..., F_SET]
        loc = c[..., F_ORIG] - consts.set_off[c_set.clamp(min=0).long()] \
            if multi else c[..., F_ORIG]
        for (si, sj), p in zip(cfg.active_pairs, names):
            pm = hit & (q_set == si)
            if multi:
                pm &= c_set == sj
            counts[p][t0 * TILE:t1 * TILE] = \
                pm.sum(dim=-1, dtype=torch.int32).reshape(-1)
            nbrs[p][t0 * TILE:t1 * TILE] = \
                compact_rows(pm, loc, k).reshape(-1, k)
            del pm
        # freed before the next group allocates, so a capture reuses them
        del idx, in_win, c, cf, hit, c_set, q_set, loc
    pairs = {}
    offs = cfg.set_offsets
    for (si, sj), p in zip(cfg.active_pairs, names):
        n_i = cfg.set_sizes[si]
        slots = carry.qpos[offs[si]:offs[si] + n_i].long()
        c_i = counts[p][slots]
        pairs[p] = {"counts": c_i, "nbrs": nbrs[p][slots],
                    "max_count": c_i.max() if n_i > 0 else
                    torch.zeros((), dtype=torch.int32, device=dev)}
    flags["cand_max"] = torch.where(carry.win_max > wcap, carry.win_max, 0)
    return {"pairs": pairs, **flags}


def build_and_search_fast_carry(points: torch.Tensor, search_radius: float,
                                state: GridState,
                                carry: FastCarry, cfg: SearchConfig,
                                knobs: FastKnobs,
                                radii: torch.Tensor | None = None,
                                reduce: ReduceSpec | None = None,
                                payload: torch.Tensor | None = None,
                                mask: bool = False, *,
                                consts: StepConsts,
                                rows_cap: int | None = None, tested=None
                                ) -> tuple[dict, GridState, FastCarry]:
    """One step of ``build_and_search_fast`` that reuses the carried cell
    structure when no point changed cells (``fastpath.py:1609-1655`` of
    the JAX package; the reference's coherence, ``TreeNSearch.cpp:417-
    424``).  Returns ``(sol, state, carry)``; ``sol["rebuilt"]`` is an
    int32 device tensor, 1 when the carry was rebuilt.

    The carry is reused when it is valid, the updated grid is the previous
    one (box, cells and cell size), every point's padded linear cell id
    equals the one stored at the last rebuild, and in variable mode every
    radius is unchanged.  A stable re-sort of equal keys reproduces the
    carried order, so the table, layout and descriptors are those a
    rebuild would give; the records are built from the new points either
    way, so results are exact.  The new grid and, on a rebuild, the prep's
    structures are written into the tensors of ``state`` and ``carry``,
    which are returned: the prep runs under ``rebuild_if`` (eagerly after
    one host read of the predicate; under CUDA graph capture in a
    conditional node, so a replay runs it only when it must).  The
    solution shares no tensor with them.  ``carry`` must come from
    ``make_fast_carry0`` or an earlier step with the same ``cfg`` and
    ``knobs``; ``consts``, ``rows_cap`` and ``tested`` as in
    ``build_and_search_fast``.  Needs ``cfg.n_points > 0``."""
    if cfg.n_points == 0:
        raise ValueError("the carried step needs at least one point")
    if not contracts_applicable(cfg, knobs):
        raise ValueError("the carried step needs the fused route "
                         "(knobs.fused, <= 8 candidate sets, a stencil of "
                         "at most 3 cells)")
    new = update_grid(state, points, consts.cell_size)
    same_grid = (state.valid & torch.all(new.grid_min == state.grid_min)
                 & torch.all(new.n_cells == state.n_cells)
                 & (new.cell_size == state.cell_size))
    assign_(state, new)
    lin = _padded_lin(points, state, cfg, knobs)[0]
    same = carry.valid & same_grid & torch.all(lin == carry.lin_chk)
    if cfg.variable:
        same = same & torch.all(radii[carry.idx_s.long()] == carry.r_chk)
    rebuild = ~same

    def rebuild_carry():
        assign_(carry, _prep(points, state, cfg, knobs, radii,
                             consts=consts)._replace(lin_chk=lin))

    rebuild_if(rebuild, rebuild_carry)
    # the solution keeps no buffer of the carry (its flags are copies)
    view = carry._replace(qpos=carry.qpos.clone(),
                          desc=carry.desc.clone() if mask else carry.desc)
    if not (reduce is not None or mask) and not cfg.active_pairs:
        sol = _empty_solution(cfg, state)
    else:
        sol = _search_any(points, radii, payload, search_radius, state,
                          view, cfg, knobs, reduce, mask, consts, rows_cap,
                          tested)
    sol["rebuilt"] = rebuild.to(torch.int32)
    return sol, state, carry


def _search_any(points, radii, payload, search_radius, state, carry, cfg,
                knobs, reduce, mask, consts, rows_cap, tested=None) -> dict:
    """The search on a prep's structures: the fused reduce, the mask or
    the neighbor lists (with split staging under ``knobs.split_stage``)."""
    if reduce is not None:
        return _search_reduce(points, radii, payload, search_radius, state,
                              carry, cfg, knobs, reduce, consts.allow,
                              consts.set_ids)
    if mask:
        return _search_mask(points, radii, search_radius, state, carry, cfg,
                            knobs, consts.allow, consts.set_ids, rows_cap)
    return _search(points, radii, search_radius, state, carry, cfg, knobs,
                   consts.allow if knobs.split_stage else None,
                   consts.set_ids, rows_cap, tested)


def materialize_nbrs(pair: dict) -> torch.Tensor:
    """Per-point padded neighbor rows (n_i, k8) of one pair's solution.

    The kernel leaves rows in tile layout plus a per-point slot pointer
    (``qpos``, the reference's ``solution_ptr`` indirection); with one
    tier the per-point view is one gather of slot rows.  The pair then
    drops its reference to the tile-layout rows; pairs that share a
    candidate set share those rows, which are released when the last of
    them has materialised.
    """
    if "nbrs" not in pair:
        q = pair["qpos"].long()
        pair["nbrs"] = pair["nbrs_tiles"][q // TILE, :, q % TILE]
        del pair["nbrs_tiles"]
    return pair["nbrs"]


_DECODE_ROWS = 1 << 18   # mask rows unpacked at a time (128 MB of int32)


def decode_mask(mask: dict, meta: dict, tiles=None):
    """Per-query neighbor sets of a ``run_mask`` result, vectorised on the
    mask's device (counterpart of the JAX package's host reference
    decoder, ``fastpath.py:1895-1946``).

    The port's layout (``meta["layout"]``): candidate k of live tile t,
    counted in window order over the windows of ``desc`` clipped to the
    records, owns row ``cand_base[t] + k`` of ``bits``; bit ``l % 32`` of
    its word ``l // 32`` says that it neighbors query lane l of tile t.
    Its record is ``desc[t, w] + (k - the lengths of t's earlier
    windows)`` of window w, whose original index is ``cand_orig`` there.

    Returns ``(counts, (row_ptr, cols))``, the JAX decoder's two results
    as tensors: per-query counts (n_total,) int64 by concatenated original
    index, and the neighbors of query q, their concatenated original
    indices ascending, ``cols[row_ptr[q]:row_ptr[q + 1]]`` (the union over
    the query set's active candidate sets; ``meta["set_offsets"]`` splits
    them per pair).  ``tiles`` restricts the decode to those tile indices
    (the queries of other tiles then count 0).  Raises ``ValueError`` for
    a step's mask whose rows passed its cap (``mask_overflow``): ``bits``
    then lacks rows that ``cand_base`` counts.
    """
    bits, cand_base, q_orig = mask["bits"], mask["cand_base"], mask["q_orig"]
    if int(cand_base[-1]) > bits.shape[0]:
        raise ValueError(f"the mask has {bits.shape[0]} bit rows of its "
                         f"{int(cand_base[-1])} (mask_overflow): a step's "
                         "row cap dropped the rest; decode run_mask()'s")
    cand_orig = mask["cand_orig"]
    n, n_win = meta["n_total"], meta["n_win"]
    dev = bits.device
    tiles_cap = cand_base.shape[0] - 1
    starts, lens = clipped_windows(mask["desc"], cand_orig.shape[0], n_win,
                                   tiles_cap)
    sel = torch.arange(tiles_cap, device=dev) if tiles is None else \
        torch.as_tensor(tiles, dtype=torch.int64, device=dev)
    # one segment of rows per (tile, window), in row order
    lens = lens[sel].long()
    seg_len = lens.reshape(-1)
    seg_row = (cand_base[sel][:, None] + torch.cumsum(lens, 1) - lens) \
        .reshape(-1)
    seg_slot = starts[sel].reshape(-1).long()
    seg_tile = sel.repeat_interleave(n_win)
    total = int(seg_len.sum())
    seg = torch.repeat_interleave(torch.arange(seg_len.shape[0], device=dev),
                                  seg_len, output_size=total)
    pos = torch.arange(total, device=dev) \
        - (torch.cumsum(seg_len, 0) - seg_len)[seg]
    rows, slots, tile_of = seg_row[seg] + pos, seg_slot[seg] + pos, \
        seg_tile[seg]
    shift = torch.arange(32, dtype=torch.int32, device=dev)
    qs = [torch.zeros(0, dtype=torch.int64, device=dev)]
    cs = [torch.zeros(0, dtype=torch.int64, device=dev)]
    for r0 in range(0, total, _DECODE_ROWS):
        words = bits[rows[r0:r0 + _DECODE_ROWS]]
        lanes = ((words[:, :, None] >> shift) & 1).reshape(-1, TILE) != 0
        ci, lane = torch.nonzero(lanes, as_tuple=True)
        ci = ci + r0
        qs.append(q_orig[tile_of[ci] * TILE + lane].long())
        cs.append(cand_orig[slots[ci]].long())
    q, c = torch.cat(qs), torch.cat(cs)
    keep = q < n
    q, c = q[keep], c[keep]
    order = torch.argsort(q * (n + 1) + c)
    q, c = q[order], c[order]
    counts = torch.bincount(q, minlength=n)
    row_ptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=row_ptr[1:])
    return counts, (row_ptr, c)
