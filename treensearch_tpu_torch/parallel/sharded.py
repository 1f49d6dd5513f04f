"""Multi-GPU search over one dimension of a ``torch.distributed`` device
mesh.

PyTorch counterpart of ``treensearch_tpu/parallel/sharded.py``: a domain
decomposition with halo exchange, so each rank's memory and work are
O(n / D + halo) for D ranks.  It runs SPMD, as ``shard_map`` runs one
program per device: every rank builds the same engine from the same global
arrays and makes the same calls, and every function here that takes a mesh
is collective over the process group of its dimension.

  stage          mechanism
  -------------  -------------------------------------------------------
  world box      ``update_grid`` on the global points on every rank (the
                 JAX call outside ``shard_map``), bit-identical by
                 construction, written into the caller's grid state
  input          rank r holds rows [r L0, (r + 1) L0) of the concatenated
                 sets, L0 = ceil(n / D): JAX's ``P(axis)`` on the padded
                 input, without the padding rows
  ownership      i-slabs of ``slab_w = max(ceil(kx / D), W)`` cell
                 columns; a point belongs to rank ``min(i // slab_w,
                 D - 1)`` (the floor keeps a query's stencil inside its
                 slab and the two next to it)
  routing        the rows sorted stably by owner, then either at exact
                 sizes (one ``all_to_all_single`` of the D x D matrix of
                 row counts, one host read, the records with those split
                 sizes) or through JAX's fixed (D, S, 8) buckets (each
                 row's position in its owner's segment, the rows past S
                 dropped and ``route_overflow`` raised, one
                 ``all_to_all_single`` of S rows per rank pair)
  halo           one ``all_to_all_single`` whose splits are zero but to
                 ranks r - 1 and r + 1 (JAX's ``ppermute`` without its
                 wraparound).  Local rows: the owned rows in (sender,
                 position) order, then the left and the right neighbors'
                 owned rows
  local search   ``build_and_search_sharded_fast``: the fast path's prep
                 over the local rows (``lin_base`` and ``span_i`` rebase
                 the dense table to the slab window, ``owned_rng`` leaves
                 only the owned rows' tiles live, ``valid`` parks the
                 buckets' sentinel rows), K1, then K2a, K2b or K2c, or
                 the fused reduce K3; ``build_and_search_sharded``: the
                 search-based pipeline with the owned rows as queries
  return         ``all_to_all_single`` with the reversed splits, then the
                 owner sort's inverse (exact) or each row's (owner,
                 position) slot (buckets): each rank holds the results of
                 its own input rows
  flags          one ``all_reduce`` (MAX) of the overflow flags (with
                 ``route_overflow``) and the largest counts, so every
                 rank takes the same regrow decisions

The engine's ``run()``, ``run_reduce`` and ``run_scalar()`` route at exact
sizes (``route_slack=None``): the counts travel first and every buffer
holds exactly its rows, so nothing can overflow, at the cost of that host
read.  ``make_sharded_step`` routes through the buckets, S =
``route_slots(n, D, route_slack)`` = route_slack x (n / D^2 + 64) rounded
up to 8, as the JAX package always does: every size is static, nothing is
read back to the host, and a CUDA graph can capture the step over NCCL.
A bucket's empty slots hold JAX's sentinel row (orig n, set -1), which the
local searches park; the local rows are D S (1 + neighbors), 2.5 (n + 64)
at D = 1.  A row past its bucket is dropped: its counts read 0 and its
row -1, and ``route_overflow`` says to make the step again with more
slack.  An edge rank receives no halo from beyond the edge, where JAX
exchanges a block of sentinels.  One collective, ``all_to_all_single``,
serves the routing, the halo, the return and the getters' gathers; NCCL
and gloo both serve it on CUDA tensors.

Records are int32 rows of 8 fields (the layout of JAX's
``_route_and_halo``): x, y, z and r as float32 bit patterns, the global
orig and set id, and the reduce payload's two columns as bit patterns.
Every cell lies in one slab, so halo rows never share a cell with owned
rows, and the stable cell sort puts each cell's rows in ascending orig as
on one device: counts and neighbor rows equal the one-device run's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ..config import SearchConfig, round_up
from ..ops import cond
from ..ops import fastpath as fp
from ..ops import pipeline as pl
from ..ops.cond import assign_
from ..ops.grid import GridState, update_grid
from ..ops.pairs import F_ORIG, F_R, F_SET, F_X, F_Z, N_FIELDS
from ..ops.reduce import ReduceSpec
from ..utils import keys as K

F_P0, F_P1 = fp.F_P0, fp.F_P1
ROUTE_SLACK = 2.5   # the JAX package's default bucket slack


class MeshAxis:
    """One named dimension of a ``DeviceMesh`` (the counterpart of a JAX
    mesh axis): its process group, this rank's place in it, and the
    collectives of the sharded search.  The group is looked up at its first
    use."""

    def __init__(self, mesh, axis: str = "d"):
        names = tuple(mesh.mesh_dim_names or ())
        if axis not in names:
            raise ValueError(f"mesh has no dimension {axis!r}: {names}")
        self.mesh, self.axis = mesh, axis
        self.size = int(mesh.shape[names.index(axis)])
        self._group = None

    @property
    def group(self):
        if self._group is None:
            self._group = self.mesh.get_group(self.axis)
        return self._group

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)

    def exchange(self, x: torch.Tensor, send, recv) -> torch.Tensor:
        """``all_to_all_single`` of the rows of ``x``: ``send[d]`` rows to
        rank d, in rank order; ``recv[s]`` rows come back from rank s."""
        out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
        dist.all_to_all_single(out, x.contiguous(), list(recv), list(send),
                               group=self.group)
        return out

    def gather_rows(self, x: torch.Tensor, rows) -> torch.Tensor:
        """Every rank's ``x`` (``rows[r]`` rows on rank r), concatenated in
        rank order, on every rank."""
        return self.exchange(x.repeat((self.size,) + (1,) * (x.dim() - 1)),
                             [x.shape[0]] * self.size, rows)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum over the ranks, in place."""
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.group)
        return x


def input_rows(n: int, rank: int, size: int) -> tuple[int, int]:
    """Rank ``rank``'s input rows [lo, hi) of the n concatenated points."""
    l0 = -(-n // size)
    lo = min(rank * l0, n)
    return lo, min(lo + l0, n)


def route_slots(n: int, size: int, route_slack: float) -> int:
    """S, the rows of one (sender, owner) bucket: route_slack x (n / D^2 +
    64), at least 8, rounded up to 8 (``sharded.py:357`` of the JAX
    package)."""
    return round_up(max(8, int(route_slack * (n / (size * size) + 64))), 8)


def slab_width(state: GridState, cfg: SearchConfig,
               size: int) -> torch.Tensor:
    """Cell columns per slab: max(ceil(kx / D), W), a device scalar."""
    return torch.clamp(-(-state.n_cells[0] // size), min=cfg.stencil_w)


def owners(points: torch.Tensor, state: GridState, cfg: SearchConfig,
           size: int) -> torch.Tensor:
    """(m,) int64 rank that owns each point: ``min(i // slab_w, D - 1)``
    of its cell column i under the global grid."""
    ijk = K.quantize(points, state.grid_min, 1.0 / state.cell_size,
                     state.n_cells)
    return torch.clamp(ijk[:, 0] // slab_width(state, cfg, size),
                       max=size - 1).long()


def records(points: torch.Tensor, radii: Optional[torch.Tensor],
            orig: torch.Tensor, set_ids: torch.Tensor,
            payload: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(m, 8) int32 record rows: x, y, z and r (0 without ``radii``) as
    float32 bit patterns, orig, set id, and the payload's two float32
    columns as bit patterns (0 without ``payload``)."""
    rec = torch.zeros((points.shape[0], N_FIELDS), dtype=torch.int32,
                      device=points.device)
    rec[:, F_X:F_Z + 1] = points.view(torch.int32)
    if radii is not None:
        rec[:, F_R] = radii.view(torch.int32)
    rec[:, F_ORIG] = orig
    rec[:, F_SET] = set_ids
    if payload is not None:
        rec[:, F_P0:F_P1 + 1] = payload.view(torch.int32)
    return rec


class Routed(NamedTuple):
    """One rank's rows after routing and the halo exchange."""
    local: torch.Tensor   # (m, 8) int32: owned, from the left, from the right
    n_own: int            # owned rows, local[:n_own], in (sender, position)
    n_left: int           # rows of rank r - 1 that follow them
    n_right: int          # rows of rank r + 1 after those
    perm: torch.Tensor    # (hi - lo,) int64: the input rows in owner order
    send: tuple           # input rows sent to each rank
    recv: tuple           # owned rows received from each rank
    route_overflow: torch.Tensor   # () int32: a row found no bucket slot
    # buckets only, per input row: the row of its results in the returned
    # (D S) rows, owner S + position (0 where dropped), and whether it
    # found a slot
    home: Optional[torch.Tensor] = None
    placed: Optional[torch.Tensor] = None

    @property
    def slab_rows(self) -> tuple:
        """(owned, left, right) local rows."""
        return self.n_own, self.n_left, self.n_right


def route_and_halo(rec_in: torch.Tensor, owner: torch.Tensor,
                   ax: MeshAxis, slots: Optional[int] = None,
                   n: int = 0) -> Routed:
    """Route this rank's input records ``rec_in`` (m, 8) to their
    ``owner`` ranks, then send every owned row to both neighbors
    (``_route_and_halo``, ``sharded.py:87-148`` of the JAX package).
    Collective.

    ``slots=None`` routes at exact sizes, with one host read.  With
    ``slots`` (S) the rows go through fixed (D, S) buckets, filled with
    the sentinel row of ``n`` points (orig n, set -1, the rest 0) where
    no row lands: the owned rows are D S, each neighbor's block as many,
    every size is static and nothing is read back to the host.  A row at
    position S or later in its owner's segment is dropped and sets
    ``route_overflow``."""
    d, r = ax.size, ax.rank
    dev = owner.device
    owner_s, perm = torch.sort(owner, stable=True)
    # segment starts from the sorted owners: ``bincount`` reads its size
    # back on CUDA, and a scatter-add of ones piles every row onto D
    # counters
    starts = torch.searchsorted(owner_s, torch.arange(d + 1, device=dev))
    nb = [o for o in (r - 1, r + 1) if 0 <= o < d]
    if slots is not None:
        big = d * slots
        m0 = owner.shape[0]
        pos = torch.empty_like(perm).scatter_(
            0, perm, torch.arange(m0, device=dev) - starts[owner_s])
        placed = pos < slots
        slot = owner * slots + pos
        send = rec_in.new_zeros((big + 1, N_FIELDS))
        send[:, F_ORIG] = n
        send[:, F_SET] = -1
        # the dropped rows all land in the spare last row
        send.index_copy_(0, torch.where(placed, slot, big), rec_in)
        mine = ax.exchange(send[:big], (slots,) * d, (slots,) * d)
        split = [big if o in nb else 0 for o in range(d)]
        local = torch.cat([mine, ax.exchange(mine.repeat(len(nb), 1), split,
                                             split)]) if nb else mine
        return Routed(local, big, big if r > 0 else 0,
                      big if r + 1 < d else 0, perm, (slots,) * d,
                      (slots,) * d, (~placed).any().to(torch.int32),
                      torch.where(placed, slot, 0), placed)
    table = ax.exchange(torch.diff(starts).repeat(d), [d] * d,
                        [d] * d).view(d, d)
    table = table.tolist()                     # table[s][o]: rows s -> o
    send = tuple(table[r])
    recv = tuple(row[r] for row in table)
    owned = [sum(row[o] for row in table) for o in range(d)]
    mine = ax.exchange(rec_in[perm], send, recv)
    halo = ax.exchange(mine.repeat(len(nb), 1),
                       [owned[r] if o in nb else 0 for o in range(d)],
                       [owned[o] if o in nb else 0 for o in range(d)])
    return Routed(torch.cat([mine, halo]), owned[r],
                  owned[r - 1] if r > 0 else 0,
                  owned[r + 1] if r + 1 < d else 0, perm, send, recv,
                  torch.zeros((), dtype=torch.int32, device=dev))


def send_home(rt: Routed, rows: torch.Tensor, ax: MeshAxis) -> torch.Tensor:
    """The owned rows' results ``rows`` (n_own, ...) back to the ranks
    they came from, in this rank's input order.  Collective.  Under
    buckets a dropped row's results are another row's: mask them with
    ``rt.placed``."""
    back = ax.exchange(rows, rt.recv, rt.send)
    if rt.home is not None:
        return back.index_select(0, rt.home)
    inv = torch.empty_like(rt.perm)
    inv[rt.perm] = torch.arange(rt.perm.shape[0], device=rt.perm.device)
    return back.index_select(0, inv)


def _lists_home(rt: Routed, ax: MeshAxis, counts: torch.Tensor,
                nbrs: list) -> tuple:
    """The owned rows' ``counts`` (n_own, blocks) and neighbor rows
    ``nbrs`` [(n_own, k) per block] home in one exchange (``send_home``);
    a row dropped from its bucket counts 0 and its row is -1."""
    home = send_home(rt, torch.cat([counts] + nbrs, 1), ax)
    counts, *nbrs = torch.split(
        home, [counts.shape[1]] + [nb.shape[1] for nb in nbrs], 1)
    if rt.placed is not None:
        keep = rt.placed[:, None]
        counts = torch.where(keep, counts, 0)
        nbrs = [torch.where(keep, nb, -1) for nb in nbrs]
    return counts, nbrs


def _route(points, radii, payload, state, cfg, ax, consts: fp.StepConsts,
           slots: Optional[int] = None) -> Routed:
    """This rank's input rows as records, routed (through buckets of
    ``slots`` rows, or at exact sizes), with their halo.  The set of
    each row comes from the set offsets of ``consts``, so nothing is
    copied from the host."""
    n = cfg.n_points
    lo, hi = input_rows(n, ax.rank, ax.size)
    orig = torch.arange(lo, hi, dtype=torch.int32, device=points.device)
    set_ids = torch.searchsorted(consts.set_off[1:], orig,
                                 right=True).to(torch.int32)
    pts = points[lo:hi]
    rec = records(pts, radii[lo:hi] if cfg.variable else None, orig,
                  set_ids, None if payload is None else payload[lo:hi])
    return route_and_halo(rec, owners(pts, state, cfg, ax.size), ax, slots,
                          n)


def _fields(local: torch.Tensor, cfg: SearchConfig):
    """Points (m, 3) and, in variable mode, radii (m,) of record rows."""
    pts = local[:, F_X:F_Z + 1].contiguous().view(torch.float32)
    rad = local[:, F_R].contiguous().view(torch.float32) \
        if cfg.variable else None
    return pts, rad


def slab_window(state: GridState, cfg: SearchConfig, rank: int, size: int):
    """``(lin_base, span_i, owned_rng)`` of rank ``rank``'s prep
    (``sharded.py:393-414`` of the JAX package): its dense table spans the
    padded i-columns from the left neighbor's slab to the right
    neighbor's, and its queries are the tiles of its own slab's columns."""
    w = cfg.stencil_w
    kx = state.n_cells[0]
    dy, dz = state.n_cells[1] + 2 * w, state.n_cells[2] + 2 * w
    slab_w = slab_width(state, cfg, size)
    x0 = rank * slab_w
    base_i_pad = torch.clamp(x0 - slab_w + w, min=0)
    span_i = torch.minimum(x0 + 2 * slab_w, kx) + 2 * w - base_i_pad
    hi_cell = kx if rank == size - 1 else x0 + slab_w
    return (base_i_pad * dy * dz, span_i,
            (x0 + w - base_i_pad, hi_cell + w - base_i_pad))


def search_fast_local(local: torch.Tensor, n_own: int, rank: int, size: int,
                      search_radius: float, state: GridState,
                      cfg: SearchConfig, knobs: fp.FastKnobs,
                      reduce: ReduceSpec | None = None, *,
                      consts: fp.StepConsts) -> dict:
    """The fast path over one rank's local rows (``local[:n_own]`` owned),
    for the global sets ``cfg`` and their ``fp.step_constants`` ``consts``:
    the prep with the rank's slab window and the sentinel rows (orig n)
    parked, the records with the rows' global orig and set ids (K1's
    sentinel orig is n), K1 and the pairs kernel, or K3 with ``reduce``
    (the payload rides fields 6 and 7).  Returns per owned row ``counts``
    (n_own, blocks) and ``nbrs`` [(n_own, k8) per candidate set], or
    ``reduce`` (n_own, n_out) float32, a sentinel row's counts and sums 0,
    and the prep's overflow flags.  Needs no collective; a rank with no
    owned rows launches nothing."""
    m = local.shape[0]
    dev = local.device
    cand_sets = fp._statics(cfg, knobs)["cand_sets"]
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    out = {"dense_overflow": zero, "tile_overflow": zero,
           "rows_overflow": zero}
    if n_own == 0:
        if reduce is not None:
            out["reduce"] = torch.zeros((0, reduce.n_out),
                                        dtype=torch.float32, device=dev)
        else:
            out["counts"] = torch.zeros((0, len(cand_sets)),
                                        dtype=torch.int32, device=dev)
            out["nbrs"] = [torch.zeros((0, round_up(cfg.cap_of(sj), 8)),
                                       dtype=torch.int32, device=dev)
                           for sj in cand_sets]
        return out
    if knobs.tiles_cap == 0:
        knobs = knobs._replace(tiles_cap=fp.default_tiles_cap(m))
    pts, rad = _fields(local, cfg)
    local_cfg = SearchConfig(set_sizes=(m,), active_pairs=((0, 0),),
                             stencil_w=cfg.stencil_w, nbr_cap=cfg.nbr_cap,
                             variable=cfg.variable, symmetric=cfg.symmetric)
    lin_base, span_i, owned_rng = slab_window(state, cfg, rank, size)
    valid = local[:, F_ORIG] < cfg.n_points
    own = valid[:n_own, None]
    carry = fp._prep(pts, state, local_cfg, knobs, rad, valid=valid,
                     owned_rng=owned_rng, lin_base=lin_base, span_i=span_i,
                     consts=consts)
    payload = local[:, F_P0:F_P1 + 1].contiguous().view(torch.float32) \
        if reduce is not None else None
    a = fp.kernel_inputs(pts, search_radius, carry, cfg, knobs, rad, payload,
                         orig=local[:, F_ORIG], set_ids=local[:, F_SET])
    q_t = fp.expand_query_tiles(a.desc, a.recs_t, a.tiles_cap,
                                cfg.n_points)
    ppos = carry.qpos[:n_own].long()
    out.update(dense_overflow=carry.dense_overflow,
               tile_overflow=carry.tile_overflow,
               rows_overflow=carry.rows_overflow)
    if reduce is not None:
        sums = fp.pairs_reduce(a.desc, q_t, a.recs_t, a.n_win,
                               a.tiles_cap, reduce, a.cand_sets,
                               consts.allow, **fp.active_args(a))
        out["reduce"] = torch.where(own, sums[:, ppos].t(), 0.0)
        return out
    counts_t, nbrs_t = fp.run_pairs(a, q_t)
    out["counts"] = torch.where(own, counts_t[:, ppos].t(), 0)
    # slot-major first, so each owned row is one contiguous read
    out["nbrs"] = [nb.transpose(1, 2).reshape(-1, nb.shape[1])
                   .index_select(0, ppos) for nb in nbrs_t]
    return out


def search_pipeline_local(local: torch.Tensor, n_own: int,
                          state: GridState, cfg: SearchConfig,
                          consts: fp.StepConsts) -> dict:
    """The search-based pipeline over one rank's local rows: every row but
    the parked sentinel rows (orig n) is a candidate, the owned rows
    ``local[:n_own]`` are the queries (``sharded.py:226-262`` of the JAX
    package), with the global sets' ``consts``.  Returns the chunk body's
    outputs for the owned rows in their order (``cand_total``, 0 for a
    sentinel row, and per active pair ``counts``, ``nbrs``; a sentinel
    row's set, -1, is no pair's).  Needs no collective."""
    dev = local.device
    if n_own == 0:
        out = {"cand_total": torch.zeros(0, dtype=torch.int32, device=dev)}
        for (si, sj) in cfg.active_pairs:
            out[pl._pair_name(si, sj)] = {
                "counts": torch.zeros(0, dtype=torch.int32, device=dev),
                "nbrs": torch.zeros((0, cfg.nbr_cap), dtype=torch.int32,
                                    device=dev)}
        return out
    pts, rad = _fields(local, cfg)
    valid = local[:, F_ORIG] < cfg.n_points
    s = pl.sorted_structure(pts, rad, state, cfg, consts,
                            orig=local[:, F_ORIG], set_ids=local[:, F_SET],
                            valid=valid)
    own = pts[:n_own]
    queries = {"orig": local[:n_own, F_ORIG],
               "ijk": K.quantize(own, state.grid_min, 1.0 / state.cell_size,
                                 state.n_cells),
               "pts": own, "set_id": local[:n_own, F_SET],
               "r": rad[:n_own] if cfg.variable else None}
    out = pl.run_chunks(pl.make_chunk_body(s, cfg, consts, queries), n_own,
                        cfg)
    out["cand_total"] = torch.where(valid[:n_own], out["cand_total"], 0)
    return out


def _max_counts(cfg: SearchConfig, set_own: torch.Tensor,
                counts_of) -> list:
    """Per active pair, the largest count among the owned rows of its
    query set (``counts_of(si, sj)`` the owned rows' counts)."""
    return [torch.where(set_own == si, counts_of(si, sj), 0).amax()
            if set_own.numel() else torch.zeros((), dtype=torch.int32,
                                                 device=set_own.device)
            for (si, sj) in cfg.active_pairs]


def _origin_pairs(cfg: SearchConfig, ax: MeshAxis, counts, nbrs,
                  block_of, max_counts) -> dict:
    """Per active pair, this rank's rows of its query set, cut from its
    input rows' results (``counts`` (hi - lo, blocks), ``nbrs[block]``),
    with every rank's row count (``rows``) for the getters' gather (the
    role of JAX's ``_origin_views``)."""
    n = cfg.n_points
    spans = [input_rows(n, r, ax.size) for r in range(ax.size)]
    lo, hi = spans[ax.rank]
    pairs = {}
    for k, (si, sj) in enumerate(cfg.active_pairs):
        off, end = cfg.set_offsets[si], cfg.set_offsets[si + 1]
        a, e = min(max(off, lo), hi) - lo, min(max(end, lo), hi) - lo
        b = block_of(si, sj)
        pairs[pl._pair_name(si, sj)] = {
            "counts": counts[a:e, b], "nbrs": nbrs[b][a:e],
            "max_count": max_counts[k],
            "rows": tuple(max(0, min(end, h) - max(off, l_))
                          for l_, h in spans)}
    return pairs


def _empty(cfg: SearchConfig, state: GridState, size: int,
           fast: bool) -> dict:
    """The solution of a search with no point or no active search; its
    pairs gather nothing."""
    sol = (fp if fast else pl)._empty_solution(cfg, state)
    for p in sol["pairs"].values():
        p["rows"] = (0,) * size
    sol["slab_rows"] = (0, 0, 0)
    sol["route_overflow"] = torch.zeros_like(sol["cand_max"])
    return sol


def build_and_search_sharded_fast(points: torch.Tensor,
                                  radii: Optional[torch.Tensor],
                                  search_radius: float, cell_size: float,
                                  state: GridState, cfg: SearchConfig,
                                  knobs: fp.FastKnobs, mesh,
                                  axis: str = "d",
                                  reduce: ReduceSpec | None = None,
                                  payload: Optional[torch.Tensor] = None, *,
                                  consts: Optional[fp.StepConsts] = None,
                                  route_slack: Optional[float] = None
                                  ) -> tuple[dict, GridState]:
    """Sharded search through the fast path (``build_and_search_sharded_
    fast``, ``sharded.py:310-528`` of the JAX package), on every rank of
    ``mesh``'s dimension ``axis`` with the same global ``points`` (n, 3)
    (and ``radii`` (n,) in variable mode).  ``knobs`` sizes each rank's
    local structures (``tiles_cap`` 0: from the local rows); split
    staging stays off (JAX's raw mode).  ``consts`` are
    ``fp.step_constants(cfg, knobs, cell_size, device,
    search_radius=search_radius)`` (None: made here).  ``route_slack``
    None routes at exact sizes (one host read); a number routes through
    JAX's buckets of ``route_slots(n, D, route_slack)`` rows, with no
    host read.

    Returns ``(solution, state)``; the new grid is written into
    ``state``'s tensors.  Per active pair the solution holds this rank's
    rows of the query set (``counts``, ``nbrs``; its share of [r L0, (r
    + 1) L0)) and every rank's row count ``rows``, which
    ``NeighborSolution``'s sharded form gathers on demand; the flags
    (``route_overflow`` with them) and each pair's ``max_count`` are the
    maxima over the ranks; ``slab_rows`` is this rank's (owned, left,
    right) local rows.  With ``reduce`` (``payload`` (n, 2) float32 or
    None) the fused reduce K3 runs instead, and ``solution["reduce"]``
    holds every set's sums ``{"s<i>": (n_out, n_i)}`` on every rank."""
    ax = MeshAxis(mesh, axis)
    if consts is None:
        consts = fp.step_constants(cfg, knobs, cell_size, points.device,
                                   search_radius=search_radius)
    assign_(state, update_grid(state, points, consts.cell_size))
    n = cfg.n_points
    if n == 0 or (reduce is None and not cfg.active_pairs):
        return _empty(cfg, state, ax.size, True), state
    dev = points.device
    rt = _route(points, radii, payload, state, cfg, ax, consts,
                None if route_slack is None
                else route_slots(n, ax.size, route_slack))
    res = search_fast_local(rt.local, rt.n_own, ax.rank, ax.size,
                            search_radius, state, cfg, knobs, reduce,
                            consts=consts)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    flags = [state.error, res["dense_overflow"], res["rows_overflow"],
             res["tile_overflow"], rt.route_overflow]
    names = ("error", "dense_overflow", "rows_overflow", "tile_overflow",
             "route_overflow")
    if reduce is not None:
        flags = ax.max(torch.stack(flags))
        sums = send_home(rt, res["reduce"].contiguous().view(torch.int32),
                         ax)
        if rt.placed is not None:
            sums = torch.where(rt.placed[:, None], sums, 0)
        every = ax.gather_rows(sums, [hi - lo for lo, hi in (
            input_rows(n, r, ax.size) for r in range(ax.size))])
        every = every.view(torch.float32)
        red = {f"s{si}": every[cfg.set_offsets[si]:
                               cfg.set_offsets[si + 1]].t()
               for si in range(cfg.n_sets)}
        return {"reduce": red, "pairs": {}, **dict(zip(names, flags)),
                "n_cells": zero, "cand_max": zero,
                "slab_rows": rt.slab_rows}, state
    cand_sets = fp._statics(cfg, knobs)["cand_sets"]
    set_own = rt.local[:rt.n_own, F_SET]
    flags = ax.max(torch.stack(flags + _max_counts(
        cfg, set_own,
        lambda si, sj: res["counts"][:, cand_sets.index(sj)])))
    # popped, so the owned rows are freed once sent
    counts, nbrs = _lists_home(rt, ax, res.pop("counts"), res.pop("nbrs"))
    pairs = _origin_pairs(cfg, ax, counts, nbrs,
                          lambda si, sj: cand_sets.index(sj),
                          flags[len(names):])
    return {"pairs": pairs, **dict(zip(names, flags)), "n_cells": zero,
            "cand_max": zero, "slab_rows": rt.slab_rows}, state


def build_and_search_sharded(points: torch.Tensor,
                             radii: Optional[torch.Tensor],
                             search_radius: float, cell_size: float,
                             state: GridState, cfg: SearchConfig, mesh,
                             axis: str = "d", *,
                             consts: Optional[fp.StepConsts] = None,
                             route_slack: Optional[float] = None
                             ) -> tuple[dict, GridState]:
    """Sharded search through the search-based pipeline
    (``build_and_search_sharded``, ``sharded.py:174-307`` of the JAX
    package): ``run_scalar()``, ``set_use_pallas(False)`` and what the
    fused gate refuses under a mesh, at any stencil.  ``consts`` and
    ``route_slack`` as for ``build_and_search_sharded_fast``.  Returns
    the solution in that function's form, with ``cand_max`` (the most
    candidates of a query, over the ranks) for the host's candidate-cap
    regrow."""
    ax = MeshAxis(mesh, axis)
    if consts is None:
        # the pipeline reads no constant of the fused route
        consts = fp.step_constants(cfg, fp.FastKnobs(fused=False),
                                   cell_size, points.device,
                                   search_radius=search_radius)
    assign_(state, update_grid(state, points, consts.cell_size))
    n = cfg.n_points
    if n == 0 or not cfg.active_pairs:
        return _empty(cfg, state, ax.size, False), state
    dev = points.device
    rt = _route(points, radii, None, state, cfg, ax, consts,
                None if route_slack is None
                else route_slots(n, ax.size, route_slack))
    mapped = search_pipeline_local(rt.local, rt.n_own, state, cfg, consts)
    names = [pl._pair_name(si, sj) for (si, sj) in cfg.active_pairs]
    cand_max = mapped["cand_total"].amax() if rt.n_own \
        else torch.zeros((), dtype=torch.int32, device=dev)
    set_own = rt.local[:rt.n_own, F_SET]
    flags = ax.max(torch.stack([state.error, cand_max, rt.route_overflow]
                               + _max_counts(
        cfg, set_own, lambda si, sj: mapped[pl._pair_name(si, sj)]["counts"])))
    counts, nbrs = _lists_home(
        rt, ax, torch.stack([mapped[p]["counts"] for p in names], 1),
        [mapped[p]["nbrs"] for p in names])
    pairs = _origin_pairs(cfg, ax, counts, nbrs,
                          lambda si, sj: names.index(pl._pair_name(si, sj)),
                          flags[3:])
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return {"pairs": pairs, "cand_max": flags[1], "n_cells": zero,
            "error": flags[0], "route_overflow": flags[2],
            "slab_rows": rt.slab_rows}, state


def make_sharded_step(cfg: SearchConfig, mesh, cell_size: float,
                      search_radius: float = 0.0, axis: str = "d",
                      knobs: Optional[fp.FastKnobs] = None,
                      fast: bool = False,
                      route_slack: float = ROUTE_SLACK):
    """The step over a mesh (``make_sharded_step``, ``sharded.py:574-591``
    of the JAX package): ``step(state, points, radii=None) -> (solution,
    state)`` through the fast path (``fast=True``, with ``knobs``) or the
    pipeline, on this rank's device (the current CUDA device on a CUDA
    mesh).  Collective: every rank calls it with the same arrays.

    It routes through JAX's buckets (``route_slots(n, D, route_slack)``
    rows each, ``build_and_search_sharded_fast``), with the constants made
    here, so a step reads nothing back to the host, copies nothing from
    it, and writes the new grid into ``state``'s tensors: a CUDA graph of
    one step replays with no copy-back, over NCCL.  A gloo group cannot
    be captured: under capture the step raises ``ValueError``.  The step
    does not regrow: ``solution["route_overflow"]`` says that a row found
    no bucket slot (its counts read 0, its rows -1); make the step again
    with more ``route_slack``.  The buckets' sentinel rows take tile
    slots of the prep's layout, so ``knobs.tiles_cap`` must hold D S (1 +
    neighbors) rows and their grid rows' padding (0: an estimate from
    those rows); ``tile_overflow`` says to make it again with more."""
    if fast and knobs is None:
        raise ValueError("a fast sharded step needs knobs")
    ax = MeshAxis(mesh, axis)
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)
    consts = fp.step_constants(cfg, knobs if fast else
                               fp.FastKnobs(fused=False), cell_size, dev,
                               search_radius=search_radius)

    def step(state, points, radii=None):
        if cond.capturing() and dist.get_backend(ax.group) != "nccl":
            raise ValueError(
                f"the sharded step over a {dist.get_backend(ax.group)} "
                "group cannot be captured in a CUDA graph; capture it over "
                "NCCL")
        if points.device != dev:
            raise ValueError(f"points must be on {dev}, got {points.device}")
        if fast:
            return build_and_search_sharded_fast(
                points, radii, search_radius, cell_size, state, cfg, knobs,
                mesh, axis, consts=consts, route_slack=route_slack)
        return build_and_search_sharded(
            points, radii, search_radius, cell_size, state, cfg, mesh, axis,
            consts=consts, route_slack=route_slack)

    return step
