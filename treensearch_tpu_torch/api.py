"""Public API: the ``TreeNSearch`` class, main-path subset.

PyTorch counterpart of ``treensearch_tpu/api.py``: one point set, a fixed
search radius, ``run()`` and the neighbor-list queries.  The surface
mirrors the reference (``TreeNSearch/source/TreeNSearch.h:28-427``);
float64 input is cast to float32 at ingest like the reference's cast-copy
(``TreeNSearch.cpp:270-297``).

Device rule: ``TreeNSearch(device="cuda")`` is the default and raises when
CUDA is absent; the CPU runs only when asked for by name
(``device="cpu"``), and then every kernel takes its plain PyTorch version.

What the JAX package offers beyond this slice raises
``NotImplementedError`` naming its item in ``ROADMAP.md`` Queue 1.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import numpy as np
import torch

from .config import SearchConfig, round_up
from .neighborlist import NeighborList, NeighborSolution
from .ops.fastpath import FastKnobs, build_and_search_fast, default_tiles_cap
from .ops.grid import fresh_state
from .utils.keys import MAX_CELLS_PER_DIM

_DEFAULT_NBR_CAP = 80
_MAX_GROW_ROUNDS = 16
_MAX_DENSE_CAP = 1 << 26   # 256 MB table; sparser domains need item 9
_MAX_STENCIL_W = 3         # (2W+1)^2 <= 49 windows fit the descriptor


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to treensearch_tpu_torch yet "
        f"(ROADMAP.md Queue 1 item {item})")


class _PointSet:
    __slots__ = ("points", "n")

    def __init__(self, points, n):
        self.points = points
        self.n = n


def _as_points(points, n_points: Optional[int]):
    """Accept (n, 3) or flat xyz, numpy or torch, f32/f64."""
    arr = points if isinstance(points, (np.ndarray, torch.Tensor)) \
        else np.asarray(points)
    if arr.ndim == 1:
        if arr.shape[0] % 3 != 0:
            raise ValueError("flat coordinate array length must be 3*n")
        n = arr.shape[0] // 3
    elif arr.ndim == 2 and arr.shape[1] == 3:
        n = arr.shape[0]
    else:
        raise ValueError(
            f"points must be (n, 3) or flat xyzxyz, got {tuple(arr.shape)}")
    if n_points is not None and n_points != n:
        raise ValueError(f"n_points={n_points} does not match array ({n})")
    return arr, n


class TreeNSearch:
    """Fixed-radius neighborhood search over one point set, on a CUDA
    device (default) or, when asked for by name, the CPU."""

    def __init__(self, device="cuda", mesh=None):
        if mesh is not None:
            raise _not_ported("multi-GPU execution (mesh=)", 14)
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TreeNSearch(device='cuda') needs a CUDA device and "
                    "none is available; pass device='cpu' to run the "
                    "plain PyTorch path")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.type != "cpu":
            raise ValueError(f"device must be cuda or cpu, got {dev}")
        self.device = dev
        self._sets: List[_PointSet] = []
        self._active = np.zeros((0, 0), dtype=bool)
        self._symmetric = True     # stored; no effect at a fixed radius
        self._search_radius: Optional[float] = None
        self._cell_size: Optional[float] = None
        self._nbr_cap = _DEFAULT_NBR_CAP
        self._dense_cap: Optional[int] = None   # sized from n on first run
        self._tiles_cap: Optional[int] = None   # sized from n on first run
        self._rows_cap = 0
        self._tiles_auto = False   # tiles_cap was auto-sized (snug ok)
        self._dense_snug = False   # one-shot dense-table shrink to domain
        self._tiles_snug = False   # one-shot tile-slot shrink to layout
        self._grid_state = fresh_state(dev)
        self._solution: Optional[NeighborSolution] = None
        self._last_stats: dict = {}

    # ------------------------------------------------------------------ sets
    def add_point_set(self, points, radii=None, n_points: int = None) -> int:
        """Add the point set; returns its id (0)."""
        if radii is not None:
            raise _not_ported("variable per-point radii", 8)
        if self._sets:
            raise _not_ported("multiple point sets", 7)
        arr, n = _as_points(points, n_points)
        self._sets.append(_PointSet(arr, n))
        # reference default: a new set takes part in no search
        # (TreeNSearch.cpp:357-361)
        self._active = np.zeros((1, 1), dtype=bool)
        self._invalidate()
        return 0

    def resize_point_set(self, set_id: int, points, radii=None,
                         n_points: int = None) -> None:
        """Replace a set's data and size (reference ``resize_point_set``,
        ``TreeNSearch.cpp:67-133``)."""
        self._require_set(set_id)
        if radii is not None:
            raise _not_ported("variable per-point radii", 8)
        arr, n = _as_points(points, n_points)
        cur = self._sets[set_id]
        if arr is cur.points and n == cur.n:
            return   # same buffer and size: the solution stays valid
        self._sets[set_id] = _PointSet(arr, n)
        self._invalidate()

    # ---------------------------------------------------------------- config
    def set_search_radius(self, search_radius: float) -> None:
        self._search_radius = float(search_radius)

    def set_cell_size(self, cell_size: float) -> None:
        if cell_size <= 0:
            raise ValueError("cell_size must be positive")
        self._cell_size = float(cell_size)
        self._grid_state = fresh_state(self.device)  # keys change

    def set_symmetric_search(self, activate: bool) -> None:
        self._symmetric = bool(activate)

    def set_all_searches(self, active: bool = True) -> None:
        self._active[:, :] = bool(active)

    def set_active_search(self, set_i: int, *args, **kwargs) -> None:
        """``set_active_search(i, j, active=True)`` sets one directed
        search; ``set_active_search(i, search_in_all=True,
        be_found_by_all=True)`` writes set i's row and column
        (``TreeNSearch.cpp:219-232``)."""
        self._require_set(set_i)
        if args and isinstance(args[0], (int, np.integer)) \
                and not isinstance(args[0], (bool, np.bool_)):
            set_j = int(args[0])
            active = bool(args[1]) if len(args) > 1 else \
                bool(kwargs.get("active", True))
            self._require_set(set_j)
            self._active[set_i, set_j] = active
        else:
            search_in_all = bool(args[0]) if args else \
                bool(kwargs.get("search_in_all", True))
            be_found_by_all = bool(args[1]) if len(args) > 1 else \
                bool(kwargs.get("be_found_by_all", True))
            self._active[set_i, :] = search_in_all
            self._active[:, set_i] = be_found_by_all
            if not search_in_all:
                self._active[set_i, set_i] = False

    def set_neighbor_cap(self, cap: int, set_j: int = None) -> None:
        """Padded neighbor-list cap; it grows by itself on overflow.  With
        one point set a per-set cap is the global cap."""
        if set_j is not None:
            self._require_set(set_j)
        self._nbr_cap = int(cap)

    # ---------------------------------------------------------------- run
    def run(self) -> None:
        """Search and build all active neighbor lists (reference
        ``run()``, ``TreeNSearch.cpp:138-149``)."""
        self._check()
        points = self._assemble()
        cell = self._effective_cell_size()
        w = self._stencil_w(cell)
        if w > _MAX_STENCIL_W:
            raise _not_ported(
                f"a stencil of {w} cells (search radius > 3 cell sizes, "
                "served by the search-based pipeline)", 9)
        sol = self._execute(points, self._search_radius, cell, w)
        self._solution = NeighborSolution(sol["pairs"])
        self._last_stats.update(cell_size=cell, stencil_w=w)

    def _execute(self, points, sr, cell, w) -> dict:
        """One search with overflow-regrow; returns the settled solution
        (``api._execute``, ``treensearch_tpu/api.py:632-869``, for the
        dense, rows, tile and neighbor caps).  All flags come to the host
        in one read per attempt; ``_last_stats`` keeps the settled run's
        occupied cells and largest count."""
        n = self.get_total_n_points()
        if self._dense_cap is None:
            self._dense_cap = self._default_dense_cap()
        if self._tiles_cap is None:
            self._tiles_cap = default_tiles_cap(max(n, 1))
            self._tiles_auto = True
        for _ in range(_MAX_GROW_ROUNDS):
            sol, state = build_and_search_fast(
                points, sr, cell, self._grid_state, self._make_cfg(w),
                self._knobs())
            flags = torch.stack(
                [sol[k] for k in ("error", "dense_overflow", "rows_overflow",
                                  "tile_overflow", "n_cells")]
                + [p["max_count"] for p in sol["pairs"].values()]).tolist()
            error, dense_of, rows_of, tile_of, n_cells = flags[:5]
            max_count = max(flags[5:], default=0)
            if error:
                self._grid_state = fresh_state(self.device)
                raise RuntimeError(
                    f"the world box exceeds {MAX_CELLS_PER_DIM} cells per "
                    "axis; increase the cell size (reference aborts here, "
                    "TreeNSearch.cpp:510-515)")
            if dense_of:
                if self._dense_cap >= _MAX_DENSE_CAP:
                    raise _not_ported(
                        "a domain too sparse for the dense cell table "
                        "(the search-based fallback)", 9)
                self._dense_cap = min(self._dense_cap * 8, _MAX_DENSE_CAP)
                continue
            if rows_of:
                auto = max(1 << 14, self._dense_cap >> 3)
                self._rows_cap = 2 * (auto if self._rows_cap == 0
                                      else self._rows_cap)
                self._rows_cap = min(self._rows_cap, self._dense_cap + 1)
                continue
            if tile_of:
                self._tiles_cap = int(self._tiles_cap * 1.5) + 64
                continue
            if max_count > self._nbr_cap:
                self._nbr_cap = round_up(int(max_count * 1.25) + 1, 16)
                continue
            self._post_run_tune(sol, state, w)
            self._grid_state = state
            self._last_stats = {"n_cells": n_cells, "max_count": max_count}
            return sol
        raise RuntimeError(
            "padding caps failed to converge "
            f"(nbr_cap={self._nbr_cap}, dense_cap={self._dense_cap}, "
            f"tiles_cap={self._tiles_cap})")

    def _post_run_tune(self, sol: dict, state, w: int) -> None:
        """One-shot shrink of the dense table to the measured domain and of
        the tile slots to the measured layout (the dense and tile "snug"
        parts of ``api._post_run_tune``); both only size the next run."""
        if not self._dense_snug:
            k = state.n_cells.cpu().numpy().astype(np.int64)
            needed = int(np.prod(k + 2 * w))
            snug = 1 << max(16, int(np.ceil(np.log2(max(needed, 1) * 1.35))))
            if snug < self._dense_cap:
                self._dense_cap = snug
            self._dense_snug = True
        if not self._tiles_snug and self._tiles_auto:
            used = int(sol["tiles_used"])
            if used > 0:
                snug = round_up(int(used * 1.04) + 32, 8)
                if snug < self._tiles_cap:
                    self._tiles_cap = snug
            self._tiles_snug = True

    def _default_dense_cap(self) -> int:
        # N/2 table slots: SPH-like data fills ~N/20 cells at the default
        # cell size; the table grows on overflow
        n = max(self.get_total_n_points(), 1)
        cap = 1 << 16
        while cap < n // 2 and cap < _MAX_DENSE_CAP:
            cap <<= 1
        return cap

    # ------------------------------------------------------------- queries
    def get_neighborlist(self, set_i: int, set_j: int,
                         i: int) -> NeighborList:
        self._require_solution()
        return self._solution.get_neighborlist(set_i, set_j, i)

    def for_each_neighbor(self, set_i: int, set_j: int, i: int,
                          f: Callable[[int], None]) -> None:
        for j in self.get_neighborlist(set_i, set_j, i):
            f(j)

    def get_neighbors(self, set_i: int, set_j: int):
        """Device tensors ``(counts (n_i,), nbrs (n_i, cap))``, -1 padded."""
        self._require_solution()
        return self._solution.get_neighbors_device(set_i, set_j)

    def get_counts(self, set_i: int, set_j: int) -> np.ndarray:
        """Neighbor counts without materializing the neighbor rows."""
        self._require_solution()
        return self._solution.get_counts(set_i, set_j)

    def get_total_n_points(self) -> int:
        return sum(s.n for s in self._sets)

    def does_set_exist(self, set_i: int) -> bool:
        return 0 <= set_i < len(self._sets)

    # ------------------------------------------------- not yet ported
    def run_scalar(self) -> None:
        raise _not_ported("run_scalar (the search-based pipeline)", 9)

    def run_reduce(self, fn, n_out: int = 1, payload=None) -> dict:
        raise _not_ported("run_reduce (the fused neighbor-reduce)", 11)

    def run_mask(self):
        raise _not_ported("run_mask (the bitmask contract)", 12)

    def make_step_fn(self, *args, **kwargs):
        raise _not_ported("make_step_fn (the temporal-coherence step)", 6)

    def distribute(self, mesh, axis: str = "d") -> None:
        raise _not_ported("multi-GPU execution (distribute)", 14)

    def prepare_zsort(self) -> None:
        raise _not_ported("z-sort", 10)

    def apply_zsort(self, *args, **kwargs):
        raise _not_ported("z-sort", 10)

    def apply_zsort_batch(self, *args, **kwargs):
        raise _not_ported("z-sort", 10)

    def get_zsort_order(self, *args, **kwargs):
        raise _not_ported("z-sort", 10)

    # -------------------------------------------------------------- helpers
    def _make_cfg(self, w: int) -> SearchConfig:
        pairs = tuple((int(i), int(j))
                      for i, j in zip(*np.nonzero(self._active)))
        return SearchConfig(set_sizes=tuple(s.n for s in self._sets),
                            active_pairs=pairs, stencil_w=w,
                            nbr_cap=self._nbr_cap)

    def _knobs(self) -> FastKnobs:
        """The caps of the next run (settled after one ``run()``)."""
        return FastKnobs(dense_cap=self._dense_cap,
                         tiles_cap=self._tiles_cap, rows_cap=self._rows_cap)

    def _assemble(self) -> torch.Tensor:
        """The set's points as a contiguous (n, 3) float32 tensor on the
        engine's device (no copy for such a tensor already there)."""
        p = self._sets[0].points
        t = torch.as_tensor(p) if isinstance(p, np.ndarray) else p
        return t.to(device=self.device, dtype=torch.float32) \
            .reshape(-1, 3).contiguous()

    def _effective_cell_size(self) -> float:
        if self._cell_size is not None:
            return self._cell_size
        # reference default: 1.5 x the radius (TreeNSearch.cpp:299-316)
        return 1.5 * self._search_radius

    def _stencil_w(self, cell: float) -> int:
        """Smallest w with w * cell >= r, by the same float32 test as the
        JAX package (no epsilon slack)."""
        c = np.float32(cell)
        r = np.float32(self._search_radius)
        w0 = int(np.floor(r * (np.float32(1.0) / c)))
        w = w0 if np.float32(w0) * c >= r else w0 + 1
        return max(1, w)

    def _check(self) -> None:
        # reference _check (TreeNSearch.cpp:366-392)
        if not self._sets:
            raise RuntimeError("no point sets have been added")
        if self._search_radius is None or self._search_radius <= 0 \
                or not math.isfinite(self._search_radius):
            raise RuntimeError(
                "fixed-radius mode requires set_search_radius(r > 0)")

    def _require_set(self, set_i: int) -> None:
        if not self.does_set_exist(set_i):
            raise IndexError(f"point set {set_i} does not exist")

    def _require_solution(self) -> None:
        if self._solution is None:
            raise RuntimeError("run() has not been called")

    def _invalidate(self) -> None:
        self._solution = None
