"""Public API: the ``TreeNSearch`` class.

PyTorch counterpart of ``treensearch_tpu/api.py``: any number of point
sets under a directed active-search matrix, at one fixed search radius or
with per-point radii (symmetric search optional), ``run()`` and the
neighbor-list queries, the device contracts ``run_reduce`` (the fused
neighbor-reduce) and ``run_mask`` (the bitmask), the temporal-coherence
carry they all ride by default, ``make_step_fn`` for a simulation loop,
and ``run_scalar``, the search-based pipeline.  ``run()`` takes the fused
kernels where they apply (1 to 8 candidate sets, a stencil of at most 3
cells, ``set_use_pallas`` on), the tile path elsewhere, and the pipeline
for a domain too sparse for the dense cell table, as the JAX package
routes.  The surface mirrors the reference
(``TreeNSearch/source/TreeNSearch.h:28-427``); float64 input is cast to
float32 at ingest like the reference's cast-copy
(``TreeNSearch.cpp:270-297``).

Device rule: ``TreeNSearch(device="cuda")`` is the default and raises when
CUDA is absent; the CPU runs only when asked for by name
(``device="cpu"``), and then every kernel takes its plain PyTorch version.

Z-sort (``prepare_zsort``, ``apply_zsort[_batch]``, ``get_zsort_order``;
the per-step ``ops.zsort.make_zsort_step``) and the diagnostics
(``print_state``, ``profile_run``) are ported too.  Multi-GPU execution
(``mesh=``, ``distribute``) runs the domain decomposition of
``parallel/sharded.py`` over one dimension of a ``torch.distributed``
``DeviceMesh``, SPMD: every rank builds the same engine and makes the same
calls.
"""

from __future__ import annotations

import math
import os
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .config import SearchConfig, round_up
from .neighborlist import NeighborList, NeighborSolution, ShardedSolution
from .ops.fastpath import (MAX_STENCIL_W, FastKnobs, StepConsts, applicable,
                           build_and_search_fast,
                           build_and_search_fast_carry, contracts_applicable,
                           default_tiles_cap, make_fast_carry0, mask_rows,
                           mask_rows_cap, step_constants)
from .ops.grid import fresh_state, update_grid
from .ops.pairs import LENS_OFF, MAX_BLOCKS
from .ops.pipeline import build_and_search
from .ops.reduce import ReduceSpec
from .ops.zsort import (apply_order, world_box, zsort_orders,
                        zsort_orders_from_cells)
from .parallel.sharded import (MeshAxis, build_and_search_sharded,
                               build_and_search_sharded_fast)
from .utils.keys import MAX_CELLS_PER_DIM

_DEFAULT_NBR_CAP = 80
_DEFAULT_CAND_CAP = 512
_DEFAULT_CHUNK = 1024
_DEFAULT_CHUNK_SCALAR = 128
_MAX_GROW_ROUNDS = 16
_MAX_DENSE_CAP = 1 << 26   # 256 MB table; sparser domains take the pipeline
_FUSED_GATE = (f"the fused kernels: set_use_pallas on, <= {MAX_BLOCKS} "
               f"candidate sets, a stencil of at most {MAX_STENCIL_W} cells")


def _require_descriptor_stencil(w: int) -> None:
    """``run()`` and the fast steps hold (2W+1)^2 <= 49 stencil windows
    per tile; the JAX ``run()`` fails past that with a broadcasting error
    (``LENS_OFF = 64``), the port with this one."""
    if w > MAX_STENCIL_W:
        raise ValueError(
            f"a stencil of {w} cells (the largest radius spans more than "
            f"{MAX_STENCIL_W} cell sizes): run() and make_step_fn(fast="
            f"True) serve at most {MAX_STENCIL_W}; run_scalar() and "
            "make_step_fn(fast=False) serve any stencil")


class _PointSet:
    __slots__ = ("points", "radii", "n")

    def __init__(self, points, radii, n):
        self.points = points
        self.radii = radii
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


def _check_radii(radii, n: int) -> None:
    if len(np.shape(radii)) != 1 or np.shape(radii)[0] != n:
        raise ValueError("radii must be a 1-D array with one radius per "
                         f"point ({n}), got shape {tuple(np.shape(radii))}")


def _as_tensor(x, device, shape) -> torch.Tensor:
    """Contiguous float32 tensor on ``device`` (no copy for such a tensor
    already there)."""
    t = torch.as_tensor(x) if isinstance(x, np.ndarray) else x
    return t.to(device=device, dtype=torch.float32).reshape(shape) \
        .contiguous()


class TreeNSearch:
    """Neighborhood search over point sets at a fixed radius or with
    per-point radii, on a CUDA device (default) or, when asked for by
    name, the CPU.

    Multi-GPU: pass ``mesh=`` (a ``torch.distributed`` ``DeviceMesh`` with
    a dimension named ``mesh_axis``) or call ``distribute(mesh)``, on every
    rank of that dimension, and every later search runs the
    domain-decomposed engines of ``parallel/sharded.py`` with the same
    regrow loop as on one device (``treensearch_tpu/api.py:95-197``)."""

    def __init__(self, device="cuda", mesh=None, mesh_axis: str = "d"):
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
        self._variable: Optional[bool] = None   # fixed by the first set
        self._symmetric = True     # read in variable mode only
        self._search_radius: Optional[float] = None
        self._cell_size: Optional[float] = None
        self._nbr_cap = _DEFAULT_NBR_CAP
        self._nbr_caps: dict = {}   # per candidate set, once one is set
        self._dense_cap: Optional[int] = None   # sized from n on first run
        self._tiles_cap: Optional[int] = None   # sized from n on first run
        self._rows_cap = 0
        self._tiles_auto = False   # tiles_cap was auto-sized (snug ok)
        self._dense_snug = False   # one-shot dense-table shrink to domain
        self._tiles_snug = False   # one-shot tile-slot shrink to layout
        self._split_stage = False  # neighbor lists through K4 then K5
        self._fused = True         # the fused kernels where they apply
        self._wcap = FastKnobs._field_defaults["wcap"]   # the tile path's
        self._cand_cap = _DEFAULT_CAND_CAP   # the pipeline's candidates
        self._chunk = _DEFAULT_CHUNK         # its chunk under run()
        self._scalar_f64 = False   # run_scalar's d^2 in float64
        self._use_carry = True     # temporal-coherence carry in the runs
        self._fast_carry = None    # the carried FastCarry ...
        self._carry_key = None     # ... and the (cfg, knobs) it was built at
        self._consts = None        # the searches' constant tensors ...
        self._consts_key = None    # ... and their (cfg, knobs, cell, radius)
        self._grid_state = fresh_state(dev)
        self._solution: Optional[NeighborSolution] = None
        self._zsort_maps: Optional[List[torch.Tensor]] = None
        self._last_stats: dict = {}
        self._n_threads = 1        # stored for get_n_threads; one device
        self._axis: Optional[MeshAxis] = None   # multi-GPU: mesh dimension
        if mesh is not None:
            self.distribute(mesh, mesh_axis)

    # ------------------------------------------------------------ multi-GPU
    def distribute(self, mesh, axis: str = "d") -> None:
        """Run every later search over dimension ``axis`` of ``mesh``, a
        ``torch.distributed`` ``DeviceMesh`` of this engine's device type
        (``treensearch_tpu/api.py:179-194``).  Call it, and every search
        and getter after it, on every rank of that dimension with the same
        arguments: each rank builds its slab's structures and holds the
        results of its share of the points (``parallel/sharded.py``).
        ``run()`` takes the sharded fast path where the fused gate admits
        the config, else the sharded pipeline, as does ``run_scalar()``;
        ``run_reduce`` runs sharded, ``run_mask`` raises.  Searches under a
        mesh do not ride the carry.  ``mesh=None`` returns the engine to
        one device.  A mesh without the dimension, or of another device
        type, raises ``ValueError``."""
        axis_of = None
        if mesh is not None:
            axis_of = MeshAxis(mesh, axis)
            if mesh.device_type != self.device.type:
                raise ValueError(
                    f"the mesh's device type {mesh.device_type!r} is not "
                    f"the engine's device {self.device}")
        self._axis = axis_of
        # the carry is a single-device structure
        self._fast_carry = None
        self._carry_key = None
        self._solution = None

    def get_mesh(self):
        """The mesh of ``distribute``/``mesh=``, or None on one device."""
        return None if self._axis is None else self._axis.mesh

    # ------------------------------------------------------------------ sets
    def add_point_set(self, points, radii=None, n_points: int = None) -> int:
        """Add a point set; returns its id.  With ``radii`` the engine is
        in variable-radius mode; mixing modes raises (reference
        ``TreeNSearch.h:43`` / ``_check``)."""
        arr, n = _as_points(points, n_points)
        variable = radii is not None
        if self._variable is not None and self._variable != variable:
            raise ValueError(
                "cannot mix fixed-radius and variable-radius point sets")
        if variable:
            _check_radii(radii, n)
        self._variable = variable
        self._sets.append(_PointSet(arr, radii, n))
        s = len(self._sets)
        grown = np.zeros((s, s), dtype=bool)
        grown[:s - 1, :s - 1] = self._active
        # reference default: a new set takes part in no search
        # (TreeNSearch.cpp:357-361)
        self._active = grown
        self._invalidate()
        return s - 1

    def resize_point_set(self, set_id: int, points, radii=None,
                         n_points: int = None) -> None:
        """Replace a set's data and size (reference ``resize_point_set``,
        ``TreeNSearch.cpp:67-133``)."""
        self._require_set(set_id)
        arr, n = _as_points(points, n_points)
        if (radii is not None) != bool(self._variable):
            raise ValueError("resize must match the engine's radius mode")
        if radii is not None:
            _check_radii(radii, n)
        cur = self._sets[set_id]
        if arr is cur.points and radii is cur.radii and n == cur.n:
            return   # same buffers and size: the solution stays valid
        self._sets[set_id] = _PointSet(arr, radii, n)
        self._invalidate()

    # ---------------------------------------------------------------- config
    def set_search_radius(self, search_radius: float) -> None:
        if self._variable:
            raise ValueError(
                "set_search_radius is for fixed-radius mode; this engine has "
                "variable-radius point sets")
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
        ``set_j`` it applies to the lists against that candidate set only,
        so a thin boundary set need not pay a dense fluid's row width."""
        if set_j is None:
            self._nbr_cap = int(cap)
        else:
            self._require_set(set_j)
            self._nbr_caps[set_j] = int(cap)

    def _cap_of(self, set_j: int) -> int:
        return self._nbr_caps.get(set_j, self._nbr_cap)

    def set_split_stage(self, enabled: bool) -> None:
        """Neighbor lists in two passes (``treensearch_tpu/api.py:393-
        403``): K4 writes the hit bits under the active matrix, K5 unpacks
        them into the pairs kernel's blocks.  The lists are those of the
        fused pairs kernel; off by default.  ``run_reduce`` and
        ``run_mask`` do not use it."""
        self._split_stage = bool(enabled)

    def set_coherence(self, enabled: bool) -> None:
        """The temporal-coherence carry (``treensearch_tpu/api.py:346-
        354``), on by default: ``run()``, ``run_reduce`` and ``run_mask``
        reuse the sort, table, layout and descriptors of the last call
        while no point changed cells, at the cost of one cell-id check and
        one host read per call.  Off drops the carry and rebuilds them on
        every call."""
        self._use_carry = bool(enabled)
        if not enabled:
            self._fast_carry = None
            self._carry_key = None

    # The JAX package's setters that have no meaning on the GPU
    # (treensearch_tpu/api.py:287-391): each checks its arguments as the
    # JAX setter does and changes nothing.  The reference's thread and
    # octree knobs have no counterpart; the window cap, record pack,
    # pre-stage caps, tiles per step, brick tiles and lane batching are
    # TPU schedules of the pairs kernel, which here streams every window
    # through shared memory whatever its width.
    def set_n_threads(self, n: int) -> None:
        """Stored for ``get_n_threads``; no meaning on the GPU."""
        self._n_threads = int(n)

    def set_recursion_cap(self, cap: int) -> None:
        """Accepted for compatibility; no meaning on the GPU."""
        int(cap)

    def set_n_points_for_parallel_octree(self, n: int = 200000) -> None:
        """Accepted for compatibility; no meaning on the GPU."""
        int(n)

    def set_window_cap(self, wcap: int) -> None:
        """The tile path's candidate slots per stencil window (at least
        16); a wider window is cut, reported as ``cand_max`` and regrown,
        so this only sizes the first run.  The fused kernels stream every
        window whatever its width and do not read it."""
        if wcap < 16:
            raise ValueError("window cap must be >= 16")
        self._wcap = int(wcap)

    def set_chunk_size(self, chunk: int) -> None:
        """Query rows per chunk of the search-based pipeline when
        ``run()`` falls back to it (``run_scalar`` keeps 128); results do
        not depend on it."""
        if chunk < 8:
            raise ValueError("chunk must be >= 8")
        self._chunk = int(chunk)

    def set_candidate_cap(self, cap: int) -> None:
        """Candidate slots per query of the search-based pipeline; it
        grows by itself when a query has more."""
        self._cand_cap = int(cap)

    def set_use_pallas(self, enabled: bool, interpret: bool = False) -> None:
        """The fused kernels (the JAX package's Pallas kernels; on by
        default).  Off sends ``run()`` down the tile path, and
        ``run_reduce``, ``run_mask`` and the carried steps raise.
        ``interpret`` (the JAX package's Pallas interpreter) is accepted
        and has no meaning here."""
        self._fused = bool(enabled)
        bool(interpret)

    def set_scalar_double_accum(self, enabled: bool) -> None:
        """``run_scalar``'s distance test with d^2 accumulated in float64,
        the reference scalar path's ``double squared_distance``
        (``TreeNSearch.cpp:2080-2086``), as the JAX package computes it
        (``ops/pipeline.py:202-227`` there): the float32 coordinates
        promoted and subtracted in float64, r_i^2 (or r^2) the float32
        square promoted, r_j squared in float64.  ``run()`` keeps the
        float32 rule of the reference's SIMD path."""
        self._scalar_f64 = bool(enabled)

    def set_record_pack(self, pack: int) -> None:
        """Accepted for compatibility (a TPU record pack of 1, 2, 4, 8 or
        16); no meaning on the GPU."""
        if pack not in (1, 2, 4, 8, 16):
            raise ValueError("pack must be one of 1, 2, 4, 8, 16")

    def set_prestage_caps(self, center: int, edge: int = None) -> None:
        """Accepted for compatibility (TPU staging widths); no meaning on
        the GPU."""
        int(center)
        int(edge if edge is not None else center)

    def set_tiles_per_step(self, tps: int) -> None:
        """Accepted for compatibility (TPU tiles per grid step: 1, 2, 4 or
        8); no meaning on the GPU."""
        if tps not in (1, 2, 4, 8):
            raise ValueError("tiles_per_step must be 1, 2, 4 or 8")

    def set_brick(self, dims) -> None:
        """Accepted for compatibility (TPU brick tiles: None, () or three
        positive ints); no meaning on the GPU."""
        dims = tuple(int(d) for d in (dims or ()))
        if dims and (len(dims) != 3 or any(d < 1 for d in dims)):
            raise ValueError("brick dims must be three positive ints")

    def set_lane_batch(self, enabled: bool) -> None:
        """Accepted for compatibility (the TPU lane-batched pipeline); no
        meaning on the GPU."""
        bool(enabled)

    # ---------------------------------------------------------------- run
    def run(self) -> None:
        """Search and build all active neighbor lists (reference
        ``run()``, ``TreeNSearch.cpp:138-149``): the fused kernels where
        they apply, else the tile path; a domain too sparse for the dense
        cell table falls back to the search-based pipeline
        (``_last_stats["path"]`` is then ``"reference"``, else
        ``"fast"``).  A stencil wider than 3 cells raises ``ValueError``:
        ``run_scalar()`` serves it."""
        points, radii, sr, cell, w = self._setup()
        _require_descriptor_stencil(w)
        sol = self._execute(points, radii, sr, cell, w)
        self._solution = self._solution_of(sol)
        self._last_stats["path"] = "fast" if "dense_overflow" in sol \
            else "reference"

    def run_scalar(self) -> None:
        """The same neighbor sets through the search-based pipeline
        (``ops/pipeline.py``; the role of the reference's scalar
        implementation, ``TreeNSearch.cpp:150-160``), at any stencil
        width; ``set_scalar_double_accum`` selects float64 d^2."""
        sol = self._execute(*self._setup(), fast=False)
        self._solution = self._solution_of(sol)
        self._last_stats["path"] = "reference"

    def _solution_of(self, sol: dict) -> NeighborSolution:
        """The getters' view of a search's pairs: under a mesh each rank
        holds its own rows, which the getters gather."""
        if self._axis is None:
            return NeighborSolution(sol["pairs"])
        return ShardedSolution(sol["pairs"], self._axis.gather_rows)

    def run_reduce(self, fn: Callable, n_out: int = 1,
                   payload=None) -> dict:
        """The fused neighbor-reduce, the device-side visitor
        (``treensearch_tpu/api.py:436-488``): ``fn`` is evaluated on every
        neighbor pair that the active searches would emit (self excluded,
        as in ``run()``) and its outputs are summed in float32 per query
        point inside the pairs kernel (K3); no neighbor list exists.

        ``fn(env)`` returns one value or a tuple of ``n_out`` (1 to 8)
        values per pair.  ``env`` holds ``dx, dy, dz`` (candidate minus
        query), ``d2``, ``r2_i`` (the query's radius squared in variable
        mode, 0 at a fixed radius, as in the JAX package), ``orig_i``,
        ``orig_j``, ``set_i``, ``set_j`` (int32; orig is the index into
        the concatenated sets), the payload ``p0_i, p1_i, p0_j, p1_j``, and
        ``r_j`` in variable mode.  Write ``fn`` with PyTorch operations:
        on the CPU it runs eagerly on tensors; for the card it is traced
        once per call into CUDA, and the first call with a new expression
        builds a kernel (``ops/reduce.py`` lists the operations it takes;
        any other raises ``TypeError``).

        ``payload``: per set, None or a (n_i,) or (n_i, <= 2) float array
        (numpy or torch), zero-padded, visible as ``p0``/``p1``.

        Returns ``{set_index: (n_i, n_out) float32 tensor}`` on the
        engine's device.  Caps regrow as in ``run()``; there are no
        neighbor caps, and ``run()``'s result stays as it was.
        """
        spec = ReduceSpec(fn, int(n_out), payload is not None)
        setup = self._setup()
        points = setup[0]
        if points.shape[0] == 0:
            return {si: torch.zeros((s.n, spec.n_out), dtype=torch.float32,
                                    device=self.device)
                    for si, s in enumerate(self._sets)}
        sol = self._execute(*setup, reduce=spec,
                            payload=self._assemble_payload(payload))
        self._last_stats["path"] = "reduce"
        return {si: sol["reduce"][f"s{si}"].t()
                for si in range(len(self._sets))}

    def run_mask(self) -> tuple:
        """The bitmask contract (``treensearch_tpu/api.py:490-553``): the
        search's hit bits, with no compaction and no caps, so nothing can
        truncate.  Returns ``(mask, meta)``.

        ``mask`` (tensors on the engine's device):

        - ``bits`` (rows, 4) int32 and ``cand_base`` (tiles + 1,) int64:
          candidate k of live tile t, in window order, owns row
          ``cand_base[t] + k``; bit ``l % 32`` of word ``l // 32`` says
          that it neighbors query lane l of tile t (self excluded, the
          active matrix applied: exactly the pairs ``run()`` emits);
        - ``desc`` (the window descriptors), ``qpos`` (point -> query
          slot), ``q_orig``/``q_set`` (per query slot), ``cand_orig``
          (sorted record -> concatenated original index);
        - ``counts`` {"s<i>": (n_i,) int32} exact per-query totals, and
          ``counts_flat`` the same per query slot.

        ``meta``: ``n_win``, ``n_total``, ``set_offsets``, ``set_sizes``
        and ``layout``.  The JAX package's ``pack``, ``wcap`` and
        ``fat_wcap`` are gone: this layout has no record packing and no
        fixed window buffer (windows stream through the kernel).
        ``ops.fastpath.decode_mask(mask, meta)`` decodes it.
        """
        setup = self._setup()
        if setup[0].shape[0] == 0:
            raise ValueError("run_mask needs at least one point")
        sol = self._execute(*setup, mask=True)
        w = setup[4]
        cfg = self._make_cfg(w)
        meta = {"n_win": (2 * w + 1) ** 2, "n_total": cfg.n_points,
                "set_offsets": cfg.set_offsets, "set_sizes": cfg.set_sizes,
                "layout": "candidate-rows"}
        self._last_stats["path"] = "mask"
        return sol["mask"], meta

    def _setup(self) -> tuple:
        """The points, radii, search radius, cell size and stencil of a
        search, with the gates every search shares."""
        points, radii = self._assemble()
        bounds = self._radius_bounds(radii)
        self._check(bounds)
        cell = self._effective_cell_size(bounds)
        w = self._stencil_w(cell, bounds)
        sr = 0.0 if self._variable else self._search_radius
        return points, radii, sr, cell, w

    def _execute(self, points, radii, sr, cell, w, fast: bool = True,
                 **mode) -> dict:
        """One search with overflow-regrow; returns the settled solution
        (``api._execute``, ``treensearch_tpu/api.py:632-869``, for the
        dense, rows, tile, window, candidate and neighbor caps).  ``fast``
        routes as ``build_and_search_fast`` does (the fused kernels where
        ``applicable``, else the tile path); without it, or after a dense
        overflow at ``_MAX_DENSE_CAP``, the search-based pipeline runs.
        ``mode`` selects the fused reduce or the mask
        (``build_and_search_fast``'s keywords), which raise
        ``NotImplementedError`` off the fused route.  With coherence on,
        each attempt of the fused route is a step of the carry
        (``api.py:719-731``; the carry is keyed by the attempt's config
        and caps, so a regrow rebuilds it).  All flags come to the host in
        one read per attempt; ``_last_stats`` keeps the settled run's
        occupied cells, largest count (0 without neighbor lists), widest
        cut window or candidate count (``cand_max``), cell size, stencil,
        whether the carry served it (``carried``, whose ``desc``
        ``print_state`` reads), whether the structure was rebuilt and,
        where K4 ran, its row count (``mask_rows``).

        Under a mesh (``treensearch_tpu/api.py:685-718``) the sharded
        engines run in the JAX order: the reduce, then the fast path where
        the fused gate admits the config, else the pipeline; the mask
        raises.  Each attempt's flags are the maxima over the ranks, so
        every rank regrows alike.  A mesh run bypasses the carry and the
        tile-slot snug."""
        n = self.get_total_n_points()
        contract = mode.get("reduce") is not None or mode.get("mask", False)
        if mode.get("mask") and self._axis is not None:
            raise NotImplementedError(
                "run_mask requires the single-chip Pallas fast path "
                f"({_FUSED_GATE}, no mesh)")
        use_fast = fast
        if self._dense_cap is None:
            self._dense_cap = self._default_dense_cap()
        if self._tiles_cap is None:
            self._tiles_cap = default_tiles_cap(max(n, 1))
            self._tiles_auto = True
        for _ in range(_MAX_GROW_ROUNDS):
            cfg = self._make_cfg(w, self._chunk if fast
                                 else _DEFAULT_CHUNK_SCALAR)
            knobs = self._knobs()
            if contract and not (use_fast
                                 and contracts_applicable(cfg, knobs)):
                what = "run_reduce" if mode.get("reduce") is not None \
                    else "run_mask"
                raise NotImplementedError(
                    f"{what} requires the Pallas fast path ({_FUSED_GATE})")
            fused = use_fast and (contract or applicable(cfg, knobs))
            if self._axis is not None and fused:
                sol, state = build_and_search_sharded_fast(
                    points, radii, sr, cell, self._grid_state, cfg, knobs,
                    self._axis.mesh, self._axis.axis,
                    consts=self._step_consts(cfg, knobs, cell, sr), **mode)
            elif self._axis is not None:
                sol, state = build_and_search_sharded(
                    points, radii, sr, cell, self._grid_state, cfg,
                    self._axis.mesh, self._axis.axis,
                    consts=self._step_consts(cfg, knobs, cell, sr))
            elif fused and self._use_carry and n > 0:
                sol, state, self._fast_carry = build_and_search_fast_carry(
                    points, sr, self._grid_state,
                    self._get_carry(cfg, knobs), cfg, knobs, radii=radii,
                    consts=self._step_consts(cfg, knobs, cell, sr), **mode)
            elif use_fast:
                # the tile path sized by its live tiles and widest window:
                # the flags are read after the attempt anyway
                sol, state = build_and_search_fast(
                    points, sr, self._grid_state, cfg, knobs, radii=radii,
                    consts=self._step_consts(cfg, knobs, cell, sr),
                    snug_tiles=True, **mode)
            else:
                sol, state = build_and_search(
                    points, radii, self._grid_state, cfg,
                    consts=self._step_consts(cfg, knobs, cell, sr))
            names = [k for k in ("error", "dense_overflow", "rows_overflow",
                                 "tile_overflow", "n_cells", "cand_max",
                                 "rebuilt", "mask_rows") if k in sol]
            values = torch.stack(
                [sol[k] for k in names]
                + [p["max_count"] for p in sol["pairs"].values()]).tolist()
            flags = dict(zip(names, values))
            max_counts = dict(zip(sol["pairs"], values[len(names):]))
            if flags["error"]:
                self._grid_state = fresh_state(self.device)
                raise RuntimeError(
                    f"the world box exceeds {MAX_CELLS_PER_DIM} cells per "
                    "axis; increase the cell size (reference aborts here, "
                    "TreeNSearch.cpp:510-515)")
            if flags.get("dense_overflow"):
                if self._dense_cap < _MAX_DENSE_CAP:
                    self._dense_cap = min(self._dense_cap * 8, _MAX_DENSE_CAP)
                else:
                    use_fast = False   # too sparse for a dense table
                continue
            if flags.get("rows_overflow"):
                auto = max(1 << 14, self._dense_cap >> 3)
                self._rows_cap = 2 * (auto if self._rows_cap == 0
                                      else self._rows_cap)
                self._rows_cap = min(self._rows_cap, self._dense_cap + 1)
                continue
            if flags.get("tile_overflow"):
                self._tiles_cap = int(self._tiles_cap * 1.5) + 64
                continue
            # the tile path cut a window wider than wcap, or a pipeline
            # query had more candidates than cand_cap: both report the
            # true size (api.py:834-847 of the JAX package)
            grew = False
            cand_max = flags.get("cand_max", 0)
            tile_route = "dense_overflow" in sol
            if cand_max > (self._wcap if tile_route else self._cand_cap):
                grown = round_up(int(cand_max * 1.25) + 1, 64)
                if tile_route:
                    self._wcap = grown
                else:
                    self._cand_cap = grown
                grew = True
            # per candidate set: a pair's lists live in the block of its
            # set_j (api.py:848-858 of the JAX package); the reduce and
            # the mask have no lists and no neighbor caps
            for (si, sj) in cfg.active_pairs:
                mc = max_counts.get(f"{si}-{sj}", 0)
                if mc > self._cap_of(sj):
                    new_cap = round_up(int(mc * 1.25) + 1, 16)
                    if self._nbr_caps:
                        self._nbr_caps[sj] = new_cap
                    else:
                        self._nbr_cap = new_cap
                    grew = True
            if grew:
                continue
            if use_fast and (fused or self._axis is None):
                self._post_run_tune(sol, state, w)   # fused or tile route
            self._grid_state = state
            self._last_stats = {"n_cells": flags["n_cells"],
                                "cand_max": cand_max,
                                "max_count": max(max_counts.values(),
                                                 default=0),
                                "cell_size": cell, "stencil_w": w,
                                "carried": "rebuilt" in sol,
                                "rebuilt": flags.get("rebuilt", 1)}
            if "mask_rows" in flags:   # K4's rows: a step's cap pads them
                self._last_stats["mask_rows"] = flags["mask_rows"]
            if "slab_rows" in sol:   # this rank's owned, left, right rows
                self._last_stats["slab_rows"] = sol["slab_rows"]
            return sol
        raise RuntimeError(
            "padding caps failed to converge "
            f"(nbr_cap={self._nbr_cap}, nbr_caps={self._nbr_caps}, "
            f"wcap={self._wcap}, cand_cap={self._cand_cap}, "
            f"dense_cap={self._dense_cap}, "
            f"tiles_cap={self._tiles_cap})")

    def _step_consts(self, cfg: SearchConfig, knobs: FastKnobs,
                     cell: float, sr: float) -> StepConsts:
        """The searches' constant tensors (``step_constants``), made once
        per (cfg, knobs, cell size, search radius), so a search copies no
        constant from the host."""
        key = (cfg, knobs, cell, sr)
        if self._consts_key != key:
            self._consts = step_constants(cfg, knobs, cell, self.device,
                                          search_radius=sr)
            self._consts_key = key
        return self._consts

    def _step_rows_cap(self, cfg: SearchConfig, knobs: FastKnobs,
                       consts: StepConsts) -> int:
        """K4's static row cap for a step (``mask_rows_cap``): from the
        row count of the last settled ``run_mask()`` or split ``run()`` at
        this config and caps, else counted on the current points."""
        rows = self._last_stats.get("mask_rows")
        key = self._carry_key

        def caps(k):
            return k._replace(split_stage=False)

        if rows is None or key is None or key[0] != cfg \
                or caps(key[1]) != caps(knobs):
            points, radii = self._assemble()
            rows = mask_rows(points, update_grid(
                self._grid_state, points, consts.cell_size), cfg, knobs,
                consts, radii)
        return mask_rows_cap(rows)

    def _get_carry(self, cfg: SearchConfig, knobs: FastKnobs):
        """The carried FastCarry when it was built at exactly this ``cfg``
        and these ``knobs``, else a fresh invalid one
        (``treensearch_tpu/api.py:871-887``).  The key covers every static
        that shapes the carry's content (dense, tile and row caps, the
        stencil, the neighbor caps, split staging), not only its shapes:
        in the JAX package a carry that outlived a cap change lost 12,245
        pairs at 1M.  Every regrow changes a cap and so rebuilds; points
        that move under one key are caught by the step's own check."""
        key = (cfg, knobs)
        if self._carry_key != key or self._fast_carry is None:
            self._fast_carry = make_fast_carry0(cfg, knobs, self.device)
            self._carry_key = key
        return self._fast_carry

    def _post_run_tune(self, sol: dict, state, w: int) -> None:
        """One-shot shrink of the dense table to the measured domain and of
        the tile slots to the measured layout (the dense and tile "snug"
        parts of ``api._post_run_tune``), after a run on the fused route
        or the tile path; both only size the next run.  On the tile path
        the JAX package has no tile count to snug to; here it keeps a
        step, which tests every tile, from paying for the default's
        slack."""
        if not self._dense_snug:
            k = state.n_cells.cpu().numpy().astype(np.int64)
            needed = int(np.prod(k + 2 * w))
            snug = 1 << max(16, int(np.ceil(np.log2(max(needed, 1) * 1.35))))
            if snug < self._dense_cap:
                self._dense_cap = snug
            self._dense_snug = True
        if not self._tiles_snug and self._tiles_auto and self._axis is None:
            # (under a mesh the owned-row filter kills interior tiles, so
            # the used tiles are not a prefix of the layout)
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
    # Under a mesh each rank holds the rows of its own points; the getters
    # gather every rank's rows of the pair at their first call after a
    # search, so they are collective: call them on every rank alike.
    def get_neighborlist(self, set_i: int, set_j: int,
                         i: int) -> NeighborList:
        """Neighbors in set_j of point i of set_i (collective under a
        mesh)."""
        self._require_solution()
        return self._solution.get_neighborlist(set_i, set_j, i)

    def for_each_neighbor(self, set_i: int, set_j: int, i: int,
                          f: Callable[[int], None]) -> None:
        """``f(j)`` for each neighbor j (collective under a mesh)."""
        for j in self.get_neighborlist(set_i, set_j, i):
            f(j)

    def get_neighbors(self, set_i: int, set_j: int):
        """Device tensors ``(counts (n_i,), nbrs (n_i, cap))``, -1 padded
        (collective under a mesh)."""
        self._require_solution()
        return self._solution.get_neighbors_device(set_i, set_j)

    def get_counts(self, set_i: int, set_j: int) -> np.ndarray:
        """Neighbor counts without materializing the neighbor rows
        (collective under a mesh)."""
        self._require_solution()
        return self._solution.get_counts(set_i, set_j)

    def get_neighborlist_n_bytes(self) -> int:
        """Bytes of the per-point neighbor lists of the last run
        (``NeighborSolution.n_bytes``)."""
        self._require_solution()
        return self._solution.n_bytes()

    def get_n_sets(self) -> int:
        return len(self._sets)

    def get_n_threads(self) -> int:
        return self._n_threads

    def get_n_points_in_set(self, set_i: int) -> int:
        self._require_set(set_i)
        return self._sets[set_i].n

    def get_total_n_points(self) -> int:
        return sum(s.n for s in self._sets)

    def is_search_active(self, set_i: int, set_j: int) -> bool:
        self._require_set(set_i)
        self._require_set(set_j)
        return bool(self._active[set_i, set_j])

    def does_set_exist(self, set_i: int) -> bool:
        return 0 <= set_i < len(self._sets)

    # ------------------------------------------------------- the step
    def make_step_fn(self, chunk: Optional[int] = None, fast: bool = True,
                     reuse: bool = False, reduce=None,
                     mask_output: bool = False):
        """Return ``(step, state0)`` for a simulation loop
        (``treensearch_tpu/api.py:1283-1392``):

            step(state, points, radii=None) -> (solution, new_state)

        ``points`` is the concatenation of the sets' points, an (n, 3)
        float32 tensor on the engine's device (another device raises
        ``ValueError``; nothing is copied), ``radii`` the (n,) float32
        radii in variable mode.  The step's config and caps are the
        engine's when the step is made, so call ``run()`` (or
        ``run_reduce``/``run_mask`` for those steps) once first to settle
        them.  The step does not regrow: the overflow flags
        (``dense_overflow``, ``rows_overflow``, ``tile_overflow``,
        ``error``, and in variable mode on the fast routes
        ``reach_overflow``) and each pair's ``max_count`` are in the
        solution for the caller to read.  The stencil width W and the
        cell size are fixed when the step is made; ``reach_overflow`` is
        1 when a step's largest radius needs more than W cells (by
        ``_stencil_w``'s test), and its neighbor sets then lack pairs:
        make the step again after a ``run()`` on the new radii.  A
        variable-radius step that runs K2c (the fused route's neighbor
        lists without split staging) also returns ``solution["tested"]``,
        a (1,) int64 count of the candidates K2c's warps tested after
        their cull (on the CPU, ``ops.pairs.warp_cull``'s).  The pairs'
        solutions feed
        ``ops.fastpath.materialize_nbrs`` and ``NeighborSolution`` as
        ``run()``'s do.

        With ``reuse``, ``reduce`` or ``mask_output`` the state is
        ``(grid_state, carry)`` and each step reuses the carried cell
        structure while no point changed cells (``solution["rebuilt"]``
        says which); results are exact either way.  ``reduce`` is a
        ``ReduceSpec`` or ``(fn, n_out)`` (see ``run_reduce``): the step
        then takes ``payload=None`` or an (n, 2) float32 tensor and
        returns ``solution["reduce"]`` {"s<i>": (n_out, n_i)}.
        ``mask_output`` returns ``solution["mask"]`` (see ``run_mask``).
        Without them the state is the grid state and every step rebuilds:
        with ``fast`` it routes as ``run()`` does (the fused kernels where
        they apply, else the tile path; a stencil wider than 3 cells
        raises ``ValueError``), without it each step runs the search-based
        pipeline of ``run_scalar`` (its solution has ``cand_max``, the
        most candidates of a query, to hold against the candidate cap).
        The carried steps need the fused route and raise ``ValueError``
        elsewhere.  ``chunk`` is the pipeline's chunk size (results do not
        depend on it).

        The step writes the new grid (and carry) into the tensors of the
        state it was given and returns that state: pass a step's state on
        to the next step, and take ``make_step_fn``'s state anew for a new
        sequence.  A solution shares no tensor with the state.  K4's rows
        (``mask_output`` and split staging) are capped at the last settled
        ``run_mask()``'s or split ``run()``'s row count (else the row
        count on the engine's points) plus a quarter;
        ``solution["mask_overflow"]`` (an int32 device flag, with the row
        count in ``solution["mask_rows"]``) says that rows were dropped.
        A mask step's counts stay exact under overflow, its ``bits`` hold
        only the rows below the cap (``decode_mask`` refuses them); a
        split-staging step's counts and neighbor lists come from those
        bits, so under overflow they are short.  Check the flag: after a
        ``run_mask()`` or split ``run()`` on the new points, a new
        ``make_step_fn`` sizes the cap anew.

        **CUDA graphs.**  Every step made here reads nothing back to the
        host, so ``torch.cuda.graph`` captures one step, which a replay
        then runs with no host sync, as the JAX step runs inside a jitted
        ``lax.fori_loop``: the carried steps (``reuse``, ``reduce``,
        ``mask_output``), ``fast`` on the fused route (split staging
        included) and on the tile path (more than 8 candidate sets,
        ``set_use_pallas(False)``), and the ``fast=False`` pipeline.  The
        tile path's step tests every tile at the full window cap, as the
        JAX tile path does (``run()`` tests only the live tiles and the
        widest window, with the same result), and reports a window past
        the cap in ``cand_max``.  In the carried steps the reuse decision is a
        conditional node on the device: a replay runs the prep only when a
        point changed cells, the grid changed or a radius changed
        (``solution["rebuilt"]`` says which).  The state is updated in
        place, so replays carry it with no copy-back; the solution's
        tensors are the graph's static outputs, which every replay
        overwrites: read them before the next replay (give
        ``ops.fastpath.materialize_nbrs`` a copy of a pair's dict, which it
        rewrites).  Warm up eagerly
        first, one rebuilding and one reusing step, so that the kernels are
        built and the sort's workspace exists; ``bench.py``'s loop of 50
        steps with a checksum then reads::

            step, state = eng.make_step_fn(reuse=True)
            static = points.clone()           # the graph's input
            for _ in range(2):                # eager warm-up
                sol, state = step(state, static)
            acc = torch.zeros((), dtype=torch.int32, device="cuda")
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                sol, state = step(state, static)
                acc += sol["pairs"]["0-0"]["counts"][::257].sum(
                    dtype=torch.int32)
            for k in range(50):
                static.copy_(positions[k])    # this step's points
                graph.replay()

        The carried steps' conditional bodies take their temporaries from
        one memory pool per device (``ops/cond.py``), so graphs that hold
        them must not replay concurrently: replay them one after another
        on one stream.  The step over a mesh, ``parallel/sharded.py::
        make_sharded_step``, captures too, over NCCL.
        """
        _, _, sr, cell, w = self._setup()
        cfg = self._make_cfg(w, chunk or self._chunk)
        n = cfg.n_points
        if self._dense_cap is None:
            self._dense_cap = self._default_dense_cap()
        if self._tiles_cap is None:
            self._tiles_cap = default_tiles_cap(max(n, 1))
        knobs = self._knobs()
        dev = self.device
        carried = reuse or reduce is not None or mask_output
        if carried and n == 0:
            raise ValueError("reuse, reduce and mask_output steps need at "
                             "least one point")
        if carried and not (fast and contracts_applicable(cfg, knobs)):
            what = "mask_output steps require" if mask_output else \
                "reduce steps require" if reduce is not None else \
                "reuse=True requires"
            raise ValueError(f"{what} the Pallas fast path ({_FUSED_GATE})")
        if fast and not carried:
            _require_descriptor_stencil(w)
        consts = self._step_consts(cfg, knobs, cell, sr)
        # K2c's post-cull test count, in variable steps that launch it
        count_tests = cfg.variable and fast and reduce is None \
            and not mask_output and not knobs.split_stage \
            and applicable(cfg, knobs)

        def tested():
            return torch.zeros(1, dtype=torch.int64, device=dev) \
                if count_tests else None

        # K4 runs in mask steps and in split staging on the fused route
        rows_cap = self._step_rows_cap(cfg, knobs, consts) if fast and n > 0 \
            and (mask_output or (reduce is None and knobs.split_stage
                                 and contracts_applicable(cfg, knobs))) \
            else None

        def check(points, radii, payload=None):
            args = [("points", points, (n, 3)), ("payload", payload, (n, 2))]
            if cfg.variable:
                if radii is None:
                    raise ValueError("a variable-radius step needs radii")
                args.append(("radii", radii, (n,)))
            elif radii is not None:
                raise ValueError("a fixed-radius step takes no radii")
            for name, t, shape in args:
                if t is None:
                    continue
                if not isinstance(t, torch.Tensor) or t.device != dev:
                    raise ValueError(f"{name} must be a tensor on {dev}, "
                                     f"got {getattr(t, 'device', type(t))}")
                if tuple(t.shape) != shape or t.dtype != torch.float32:
                    raise ValueError(f"{name} must be {shape} float32, got "
                                     f"{tuple(t.shape)} {t.dtype}")

        if reduce is not None:
            spec = reduce if isinstance(reduce, ReduceSpec) \
                else ReduceSpec(reduce[0], int(reduce[1]))

            def step(state, points, radii=None, payload=None):
                check(points, radii, payload)
                grid, carry = state
                sol, grid, carry = build_and_search_fast_carry(
                    points, sr, grid, carry, cfg, knobs, radii=radii,
                    reduce=spec, payload=payload, consts=consts)
                return sol, (grid, carry)
        elif carried:
            def step(state, points, radii=None):
                check(points, radii)
                grid, carry = state
                sol, grid, carry = build_and_search_fast_carry(
                    points, sr, grid, carry, cfg, knobs, radii=radii,
                    mask=mask_output, consts=consts, rows_cap=rows_cap,
                    tested=tested())
                return sol, (grid, carry)
        elif fast:
            def step(state, points, radii=None):
                check(points, radii)
                return build_and_search_fast(points, sr, state, cfg, knobs,
                                             radii=radii, consts=consts,
                                             rows_cap=rows_cap,
                                             tested=tested())

            return step, fresh_state(dev)
        else:
            def step(state, points, radii=None):
                check(points, radii)
                return build_and_search(points, radii, state, cfg,
                                        consts=consts)

            return step, fresh_state(dev)
        return step, (fresh_state(dev), make_fast_carry0(cfg, knobs, dev))

    # ---------------------------------------------------------------- zsort
    def prepare_zsort(self) -> None:
        """Compute the per-set Morton reorder maps (reference
        ``prepare_zsort``, ``TreeNSearch.cpp:2571-2661``;
        ``treensearch_tpu/api.py:996-1043``).

        After a ``run()`` that rode the carry, with the set sizes
        unchanged, the carried cell ids give a cell-granular order
        (points of one cell keep their order; ``ops.zsort.
        zsort_orders_from_cells``), the reference's cells fast path
        (``TreeNSearch.cpp:2598-2657``).  Otherwise (no run yet, carry
        off, sizes changed, or the last call was not ``run()`` on the fast
        route) it computes the exact per-point order at 2^20 cells per
        axis over the world box (``TreeNSearch.cpp:2663-2716``).  Both are
        the JAX package's orders bit for bit."""
        if not self._sets:
            raise RuntimeError("no point sets added")
        carry = self._fast_carry
        sizes_now = tuple(s.n for s in self._sets)
        if (carry is not None and self._carry_key is not None
                and self._carry_key[0].set_sizes == sizes_now
                and self._last_stats.get("path") == "fast"
                and bool(carry.valid)):
            w = int(self._last_stats.get("stencil_w", 1))
            nc = self._grid_state.n_cells
            self._zsort_maps = zsort_orders_from_cells(
                torch.split(carry.lin_chk, list(sizes_now)),
                nc[1] + 2 * w, nc[2] + 2 * w)
            return
        pts = [_as_tensor(s.points, self.device, (-1, 3)) for s in self._sets]
        self._zsort_maps = zsort_orders(pts, *world_box(pts, self.device))

    def _zsort_order_of(self, set_i: int, caller: str) -> torch.Tensor:
        self._require_set(set_i)
        if self._zsort_maps is None:
            raise RuntimeError(
                f"prepare_zsort() must be called before {caller}() "
                "(reference exits here, TreeNSearch.h:446-454)")
        return self._zsort_maps[set_i]

    def apply_zsort(self, set_i: int, data, stride: int = 1):
        """Reorder a user array of set ``set_i`` by the prepared Z-order:
        n rows (n, ...) or, with ``stride``, a flat array of n * stride
        elements (reference ``apply_zsort<T>``, ``TreeNSearch.h:443-
        481``).  A numpy array is reordered in place and returned (the
        reference's pointer semantics); a torch tensor comes back as a new
        reordered tensor on its own device and stays as it was (the JAX
        package's contract for its device arrays).  Exact for every
        dtype."""
        order = self._zsort_order_of(set_i, "apply_zsort")
        return self._reorder(set_i, order, data, stride)

    def apply_zsort_batch(self, set_i: int, arrays: Sequence,
                          strides: Optional[Sequence[int]] = None) -> list:
        """``apply_zsort`` of many arrays of one set (the reference's SPH
        pattern reorders positions, velocities, densities and more,
        ``README.md:95-111``): numpy arrays in place, torch tensors as new
        tensors; returns the reordered arrays in order."""
        order = self._zsort_order_of(set_i, "apply_zsort_batch")
        strides = [1] * len(arrays) if strides is None else list(strides)
        if len(strides) != len(arrays):
            raise ValueError(f"{len(strides)} strides for {len(arrays)} "
                             "arrays")
        host = order.cpu().numpy() if any(
            not isinstance(a, torch.Tensor) for a in arrays) else None
        return [self._reorder(set_i, order, a, st, host)
                for a, st in zip(arrays, strides)]

    @staticmethod
    def _reorder(set_i: int, order: torch.Tensor, data, stride: int,
                 host: Optional[np.ndarray] = None):
        """One array in the order: a tensor by ``index_select`` on its own
        device, anything else as a numpy array, in place, by ``np.take``
        with the order on the host (``host``, else read here)."""
        n = order.shape[0]
        if n == 0:
            return data
        if not isinstance(data, (np.ndarray, torch.Tensor)):
            data = np.asarray(data)
        size = math.prod(data.shape)
        if size % n != 0:
            raise ValueError(
                f"array of {size} elements cannot be reordered for set "
                f"{set_i} with {n} points (need n*stride elements)")
        rows = data.reshape(n, stride) if data.ndim == 1 and stride > 1 \
            else data.reshape(n, -1)
        if isinstance(data, torch.Tensor):
            return apply_order(rows, order).reshape(data.shape)
        if host is None:
            host = order.cpu().numpy()
        np.copyto(data, np.take(rows, host, axis=0).reshape(data.shape))
        return data

    def get_zsort_order(self, set_i: int) -> np.ndarray:
        """Set ``set_i``'s new_to_old permutation as int32 numpy."""
        return self._zsort_order_of(set_i, "get_zsort_order").cpu().numpy()

    # ---------------------------------------------------------- diagnostics
    def print_state(self) -> None:
        """Print the options and the structure and neighborhood statistics
        (reference ``print_state``, ``TreeNSearch.cpp:2718-2873``;
        ``treensearch_tpu/api.py:1181-1262``): options and caps, active
        searches, world box and cells per axis, occupied cells and points
        per occupied cell, the candidate windows of the last ``run()``
        that rode the carry, per-set boxes and radii, per-pair neighbor
        counts and the neighbor-list bytes.  Everything is computed here,
        when called, so the search itself pays nothing for it."""
        print("TreeNSearch (treensearch_tpu_torch) state")
        print(f"  n_sets: {len(self._sets)}  total points: "
              f"{self.get_total_n_points()}")
        mode = "variable" if self._variable else "fixed"
        print(f"  radius mode: {mode}  symmetric: {self._symmetric}")
        if not self._variable:
            print(f"  search radius: {self._search_radius}")
        print(f"  cell size: {self._cell_size or '(default 1.5*r_min)'}")
        print(f"  caps: nbr={self._nbr_cap} window={self._wcap} "
              f"dense={self._dense_cap} tiles={self._tiles_cap} "
              f"chunk={self._chunk}  device: {self.device}")
        print("  active searches: "
              + str([(int(i), int(j))
                     for (i, j) in zip(*np.nonzero(self._active))]))
        npts = self.get_total_n_points()
        gs = self._grid_state
        if bool(gs.valid):
            k = gs.n_cells.cpu().numpy()
            gmin = gs.grid_min.cpu().numpy()
            print(f"  world box: {gmin.round(5)} .. "
                  f"{gs.grid_max.cpu().numpy().round(5)}  cells/axis: {k}")
            nc = self._last_stats.get("n_cells")
            if nc:
                print(f"  occupied cells: {nc}  avg points/cell: "
                      f"{npts / max(nc, 1):.2f}")
            cell = self._last_stats.get("cell_size")
            if cell and npts > 0:
                occ = self._cell_occupancy(gmin, k, cell)
                print(f"  points per occupied cell min/avg/max = "
                      f"{occ.min()}/{occ.mean():.2f}/{occ.max()}")
        carry = self._fast_carry
        if (carry is not None and self._last_stats.get("carried")
                and self._last_stats.get("path") == "fast"):
            w = self._last_stats["stencil_w"]
            lens = carry.desc[:, LENS_OFF:LENS_OFF + (2 * w + 1) ** 2]
            lens = lens[lens > 0].cpu().numpy()
            if lens.size:
                # the JAX carry's win_hist: nonzero lengths in 64 bins of
                # 32 slots (treensearch_tpu/ops/fastpath.py:708-711)
                wh = np.bincount(np.minimum(lens // 32, 63), minlength=64)
                cum = np.cumsum(wh)
                tot = int(cum[-1])
                p50 = (int(np.searchsorted(cum, 0.50 * tot)) + 1) * 32
                p95 = (int(np.searchsorted(cum, 0.95 * tot)) + 1) * 32
                wmax = (int(np.nonzero(wh)[0][-1]) + 1) * 32
                print(f"  candidate windows: {tot} nonzero, length "
                      f"p50/p95/max <= {p50}/{p95}/{wmax} slots; stencil "
                      f"reach: {w} cells (ghost-span analog)")
        if self._last_stats:
            print(f"  last run: {self._last_stats}")
        for k_set, s in enumerate(self._sets):
            if s.n == 0:
                print(f"  set {k_set}: 0 points")
                continue
            p = _as_tensor(s.points, "cpu", (-1, 3)).numpy()
            line = (f"  set {k_set}: {s.n} points  aabb "
                    f"{p.min(axis=0).round(4)} .. {p.max(axis=0).round(4)}")
            if self._variable:
                r = _as_tensor(s.radii, "cpu", (-1,)).numpy()
                line += (f"  radius min/avg/max = {r.min():.4g}/"
                         f"{r.mean():.4g}/{r.max():.4g}")
            print(line)
        if self._solution is not None:
            for (i, j) in zip(*np.nonzero(self._active)):
                c = self._solution.get_counts(int(i), int(j))
                if c.size:
                    print(f"  pair ({i}->{j}): neighbors min/avg/max = "
                          f"{c.min()}/{c.mean():.2f}/{c.max()}")
            print(f"  neighborlist bytes: {self.get_neighborlist_n_bytes()}")

    def _cell_occupancy(self, gmin: np.ndarray, k: np.ndarray,
                        cell: float) -> np.ndarray:
        """Points per occupied cell of the current grid, by the JAX
        package's float32 quantization (``api.py:1214-1226`` there)."""
        p = self._assemble()[0]
        inv = torch.tensor(np.float32(1.0 / cell), device=p.device)
        kk = torch.as_tensor(k.astype(np.int64), device=p.device)
        ijk = torch.floor((p - torch.as_tensor(gmin, device=p.device))
                          * inv).to(torch.int64)
        ijk = torch.minimum(torch.clamp(ijk, min=0), kk - 1)
        lin = (ijk[:, 0] * kk[1] + ijk[:, 1]) * kk[2] + ijk[:, 2]
        return torch.unique(lin, return_counts=True)[1].cpu().numpy()

    def profile_run(self, trace_dir: str, n_steps: int = 3) -> str:
        """Trace ``n_steps`` steady-state search steps with
        ``torch.profiler`` (``treensearch_tpu/api.py:1264-1281`` on
        ``jax.profiler``): one ``run()`` settles the caps if none ran yet
        and one ``make_step_fn()`` step warms up, both outside the trace;
        the trace records the CPU and, on the card, the CUDA activity, and
        is written as a Chrome trace ``treensearch.pt.trace.json`` into
        ``trace_dir`` (made if missing; open it in Perfetto or
        chrome://tracing).  Returns ``trace_dir``."""
        from torch.profiler import ProfilerActivity, profile

        self._check()
        if self._solution is None:
            self.run()
        points, radii = self._assemble()
        step, state = self.make_step_fn()
        sol, state = step(state, points, radii)
        self._sync()
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            for _ in range(n_steps):
                sol, state = step(state, points, radii)
            self._sync()
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(trace_dir, "treensearch.pt.trace.json"))
        return trace_dir

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -------------------------------------------------------------- helpers
    def _make_cfg(self, w: int, chunk: Optional[int] = None) -> SearchConfig:
        pairs = tuple((int(i), int(j))
                      for i, j in zip(*np.nonzero(self._active)))
        caps = tuple(self._cap_of(j) for j in range(len(self._sets)))
        return SearchConfig(set_sizes=tuple(s.n for s in self._sets),
                            active_pairs=pairs, stencil_w=w,
                            nbr_cap=max(caps, default=self._nbr_cap),
                            variable=bool(self._variable),
                            symmetric=bool(self._symmetric and self._variable),
                            nbr_caps=caps if self._nbr_caps else None,
                            chunk=chunk or self._chunk,
                            cand_cap=self._cand_cap,
                            scalar_f64=self._scalar_f64)

    def _knobs(self) -> FastKnobs:
        """The caps of the next run (settled after one ``run()``)."""
        return FastKnobs(dense_cap=self._dense_cap,
                         tiles_cap=self._tiles_cap, rows_cap=self._rows_cap,
                         split_stage=self._split_stage, fused=self._fused,
                         wcap=self._wcap)

    def _assemble(self):
        """The sets' points, concatenated, as a contiguous (n, 3) float32
        tensor on the engine's device, and in variable mode their radii
        as (n,) float32 (else None).  A single set's float32 tensor
        already on the device is used without a copy."""
        dev = self.device
        pts = [_as_tensor(s.points, dev, (-1, 3)) for s in self._sets]
        if not pts:
            return torch.zeros((0, 3), dtype=torch.float32, device=dev), None
        points = pts[0] if len(pts) == 1 else torch.cat(pts)
        if not self._variable:
            return points, None
        rad = [_as_tensor(s.radii, dev, (-1,)) for s in self._sets]
        return points, rad[0] if len(rad) == 1 else torch.cat(rad)

    def _assemble_payload(self, payload) -> Optional[torch.Tensor]:
        """Per-set payload columns as one (n_total, 2) float32 tensor on
        the engine's device, zero-padded, aligned with ``_assemble``'s
        concatenation (``treensearch_tpu/api.py:555-575``)."""
        if payload is None:
            return None
        if len(payload) != len(self._sets):
            raise ValueError("payload must have one entry per point set")
        out = torch.zeros((self.get_total_n_points(), 2), dtype=torch.float32,
                          device=self.device)
        off = 0
        for s, p in zip(self._sets, payload):
            if p is not None:
                shape = tuple(np.shape(p))
                cols = shape[1] if len(shape) == 2 else 1
                if len(shape) not in (1, 2) or shape[0] != s.n \
                        or not 1 <= cols <= 2:
                    raise ValueError(f"payload shape {shape} does not match "
                                     f"set size {s.n} (at most 2 columns)")
                out[off:off + s.n, :cols] = _as_tensor(p, self.device,
                                                       (s.n, cols))
            off += s.n
        return out

    def _radius_bounds(self, radii=None):
        """(r_min, r_max) over all points: the search radius twice in
        fixed mode; one device read in variable mode (0, 0 when no point
        exists)."""
        if not self._variable:
            r = self._search_radius or 0.0
            return r, r
        if radii is None:
            radii = self._assemble()[1]
        if radii.numel() == 0:
            return 0.0, 0.0
        r_min, r_max = torch.stack(torch.aminmax(radii)).tolist()
        return r_min, r_max

    def _effective_cell_size(self, bounds=None) -> float:
        if self._cell_size is not None:
            return self._cell_size
        # reference default: 1.5 x (the radius | the smallest radius)
        # (TreeNSearch.cpp:299-316)
        r_min = (bounds or self._radius_bounds())[0]
        if r_min <= 0:
            raise ValueError("cannot derive a cell size: no positive radius")
        return 1.5 * r_min

    def _stencil_w(self, cell: float, bounds=None) -> int:
        """Smallest w with w * cell >= r_max, by the same float32 test as
        the JAX package (no epsilon slack)."""
        r_max = (bounds or self._radius_bounds())[1]
        if r_max <= 0:
            return 1
        c = np.float32(cell)
        r = np.float32(r_max)
        w0 = int(np.floor(r * (np.float32(1.0) / c)))
        w = w0 if np.float32(w0) * c >= r else w0 + 1
        return max(1, w)

    def _check(self, bounds=None) -> None:
        # reference _check (TreeNSearch.cpp:366-392)
        if not self._sets:
            raise RuntimeError("no point sets have been added")
        if not self._variable:
            if self._search_radius is None or self._search_radius <= 0 \
                    or not math.isfinite(self._search_radius):
                raise RuntimeError(
                    "fixed-radius mode requires set_search_radius(r > 0)")
        elif (bounds or self._radius_bounds())[0] < 0:
            bad = [k for k, s in enumerate(self._sets)
                   if s.n > 0 and float(_as_tensor(s.radii, "cpu", (-1,))
                                        .min()) < 0]
            raise RuntimeError(f"set {bad[0]} has negative radii")

    def _require_set(self, set_i: int) -> None:
        if not self.does_set_exist(set_i):
            raise IndexError(f"point set {set_i} does not exist")

    def _require_solution(self) -> None:
        if self._solution is None:
            raise RuntimeError("run() has not been called")

    def _invalidate(self) -> None:
        self._solution = None
        self._zsort_maps = None
