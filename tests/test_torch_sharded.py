"""The port's sharded search (``treensearch_tpu_torch/parallel/sharded.py``)
across real processes over gloo on the CPU, on ``tests/test_sharded.py``'s
shapes, against the port's one-device engine, the JAX one-device engine
(``build_and_search_jit``, ``TreeNSearch``) and the numpy oracle.

Each spawn starts D processes that join one gloo group through a file
under ``tmp_path`` and run a group of cases (the ``_cases_*`` rank bodies
below); every rank saves what it holds, and the tests compare in this
process.  Tolerance: counts bit-equal and neighbor sets equal; the
sharded ``run_reduce`` within rtol 5e-5 of the one-device one (float32
sums); the prep's sharded parameters and the routed local rows bit-equal
to JAX's ``_pallas_prep`` and ``_route_and_halo``.  JAX is imported only
inside the tests that compare with it, so the ranks never load it.
"""

import datetime
import functools
import multiprocessing as mp
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from treensearch_tpu_torch import TreeNSearch
from treensearch_tpu_torch.config import SearchConfig
from treensearch_tpu_torch.ops import fastpath as fp
from treensearch_tpu_torch.ops.grid import fresh_state, update_grid
from treensearch_tpu_torch.ops.pairs import FAT_COL
from treensearch_tpu_torch.ops.pipeline import build_and_search
from treensearch_tpu_torch.parallel import sharded as sh
from treensearch_tpu_torch.utils.keys import quantize
from torch_step_guard import no_host_reads

SPAWN_TIMEOUT = 120   # seconds for one spawn's ranks to finish

# tests/test_sharded.py's shapes
PIPE = dict(sizes=(700, 300), seed=0, r=(0.08, 0.14), cell=0.15)
FAST = dict(sizes=(600, 360), seed=11, r=(0.09, 0.15), cell=0.15)
ENGINE = dict(sizes=(600, 360), seed=21, r=(0.09, 0.15), cell=0.15)
ROUTE = dict(sizes=(701, 300), seed=5, r=(0.09, 0.15), cell=0.15)
PAIRS = ((0, 0), (0, 1), (1, 0))
N_DECOMP, R_DECOMP, CELL_DECOMP = 4096, 0.07, 0.105
N_FALLBACK = 640
N_ORIGIN = 2000


def _cloud(shape, variable):
    """Points (n, 3) and, when ``variable``, radii (n,) of a shape."""
    rng = np.random.default_rng(shape["seed"])
    n = sum(shape["sizes"])
    pts = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    rad = rng.uniform(*shape["r"], n).astype(np.float32) if variable \
        else None
    return pts, rad


def _origin_cloud():
    """One set with points near the origin, where a bucket's sentinel rows
    (orig n, set -1, at (0, 0, 0)) would count as neighbors through K2a,
    which reads no set id, if the step did not park them."""
    rng = np.random.default_rng(9)
    pts = rng.uniform(0, 1, (N_ORIGIN, 3)).astype(np.float32)
    pts[:16] = rng.uniform(0, 0.05, (16, 3))
    return pts


def _cfg(shape, variable, **kw):
    kw = {"stencil_w": 1, "nbr_cap": 96, "chunk": 64, "cand_cap": 512, **kw}
    return SearchConfig(set_sizes=shape["sizes"], active_pairs=PAIRS,
                        variable=variable, symmetric=variable, **kw)


def _t(x):
    return None if x is None else torch.from_numpy(x)


# -------------------------------------------------------------- the spawns
def _rank_entry(body, rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp}/rdv", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=SPAWN_TIMEOUT))
    try:
        from torch.distributed.device_mesh import DeviceMesh
        mesh = DeviceMesh("cpu", list(range(world)), mesh_dim_names=("d",))
        torch.save(body(mesh), os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(body, world: int, tmp) -> list:
    """``body(mesh)`` on each of ``world`` gloo ranks; their results."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry, args=(body, r, world, str(tmp)))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(SPAWN_TIMEOUT)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
    assert [p.exitcode for p in procs] == [0] * world
    # files the ranks above wrote
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _gathered(sol, mesh) -> dict:
    """Every pair's counts and rows of a sharded solution, gathered."""
    ax = sh.MeshAxis(mesh)
    return {name: (ax.gather_rows(p["counts"], p["rows"]),
                   ax.gather_rows(p["nbrs"], p["rows"]))
            for name, p in sol["pairs"].items()}


def _flags(sol) -> dict:
    return {k: int(sol[k]) for k in ("error", "dense_overflow",
                                     "rows_overflow", "tile_overflow",
                                     "route_overflow", "cand_max")
            if k in sol}


def _guarded_step(step, mesh, pts, rad, cell: float) -> tuple:
    """One step under ``no_host_reads`` (every host read and host-to-device
    copy outside the kernel wrappers raises); its lists gathered, its
    flags, its local rows and whether it wrote the grid into the state
    it was given."""
    state, pts, rad = fresh_state(), _t(pts), _t(rad)
    with pytest.MonkeyPatch.context() as patch:
        no_host_reads(patch)
        sol, new = step(state, pts, rad)
    grid = update_grid(fresh_state(), pts, torch.tensor(cell))
    same = new is state and torch.equal(state.grid_min, grid.grid_min) \
        and torch.equal(state.n_cells, grid.n_cells)
    return _gathered(sol, mesh), _flags(sol), sol["slab_rows"], same


def _cases_functions(mesh) -> dict:
    """The module functions on four ranks: the pipeline and the fast path
    on their shapes, exact and through the step's buckets, the
    decomposition, the routing, the tiny and empty clouds."""
    out = {}
    for variable in (False, True):
        pts, rad = _cloud(PIPE, variable)
        sol, _ = sh.build_and_search_sharded(
            _t(pts), _t(rad), 0.1, PIPE["cell"], fresh_state(),
            _cfg(PIPE, variable), mesh)
        out[f"pipe_{variable}"] = (_gathered(sol, mesh), _flags(sol))
        pts, rad = _cloud(FAST, variable)
        knobs = fp.FastKnobs(dense_cap=1 << 13, tiles_cap=96)
        sol, _ = sh.build_and_search_sharded_fast(
            _t(pts), _t(rad), 0.1, FAST["cell"], fresh_state(),
            _cfg(FAST, variable), knobs, mesh)
        out[f"fast_{variable}"] = (_gathered(sol, mesh), _flags(sol))
        # the buckets' sentinel rows fit the exact run's 96 tiles here
        step = sh.make_sharded_step(_cfg(FAST, variable), mesh, FAST["cell"],
                                    0.1, knobs=knobs, fast=True)
        out[f"fast_step_{variable}"] = _guarded_step(step, mesh, pts, rad,
                                                     FAST["cell"])
    pts, rad = _cloud(PIPE, False)
    step = sh.make_sharded_step(_cfg(PIPE, False), mesh, PIPE["cell"], 0.1)
    out["pipe_step"] = _guarded_step(step, mesh, pts, None, PIPE["cell"])
    pts, rad = _cloud(ROUTE, True)
    step = sh.make_sharded_step(_cfg(ROUTE, True), mesh, ROUTE["cell"],
                                knobs=fp.FastKnobs(dense_cap=1 << 13,
                                                   tiles_cap=64),
                                fast=True, route_slack=0.2)
    out["small_slack"] = _guarded_step(step, mesh, pts, rad, ROUTE["cell"])
    pts = _origin_cloud()
    cfg = SearchConfig(set_sizes=(N_ORIGIN,), active_pairs=((0, 0),),
                       stencil_w=1, nbr_cap=64)
    knobs = fp.FastKnobs(dense_cap=1 << 13, tiles_cap=128)
    sol, _ = sh.build_and_search_sharded_fast(
        _t(pts), None, 0.1, 0.15, fresh_state(), cfg, knobs, mesh)
    step = sh.make_sharded_step(cfg, mesh, 0.15, 0.1, knobs=knobs, fast=True)
    out["origin"] = (_gathered(sol, mesh),
                     _guarded_step(step, mesh, pts, None, 0.15))

    pts = np.random.default_rng(3).uniform(0, 1, (N_DECOMP, 3)) \
        .astype(np.float32)
    cfg = SearchConfig(set_sizes=(N_DECOMP,), active_pairs=((0, 0),),
                       stencil_w=1, nbr_cap=64, chunk=128)
    sol, state = sh.build_and_search_sharded(
        _t(pts), None, R_DECOMP, CELL_DECOMP, fresh_state(), cfg, mesh)
    ax = sh.MeshAxis(mesh)
    rt = sh._route(_t(pts), None, None, state, cfg, ax,
                   fp.step_constants(cfg, fp.FastKnobs(), CELL_DECOMP, "cpu",
                                     search_radius=R_DECOMP))
    out["decomp"] = {"rows": sol["pairs"]["0-0"]["counts"].shape[0],
                     "sum": int(sol["pairs"]["0-0"]["counts"].sum()),
                     "slab_rows": sol["slab_rows"], "local": rt.local,
                     "grid": state}

    pts, rad = _cloud(ROUTE, True)
    cfg = _cfg(ROUTE, True)
    state = update_grid(fresh_state(), _t(pts),
                        torch.tensor(ROUTE["cell"], dtype=torch.float32))
    consts = fp.step_constants(cfg, fp.FastKnobs(), ROUTE["cell"], "cpu",
                               search_radius=0.0)
    out["route"] = sh._route(_t(pts), _t(rad), None, state, cfg, ax,
                             consts).local
    rt = sh._route(_t(pts), _t(rad), None, state, cfg, ax, consts,
                   sh.route_slots(cfg.n_points, ax.size, sh.ROUTE_SLACK))
    out["route_buckets"] = (rt.local, rt.slab_rows, int(rt.route_overflow))

    tiny = np.random.default_rng(1).uniform(0, 1, (3, 3)).astype(np.float32)
    cfg = SearchConfig(set_sizes=(3,), active_pairs=((0, 0),), stencil_w=1,
                       nbr_cap=16, chunk=16, cand_cap=64)
    for fast in (False, True):
        if fast:
            sol, _ = sh.build_and_search_sharded_fast(
                _t(tiny), None, 0.5, 0.75, fresh_state(), cfg,
                fp.FastKnobs(dense_cap=1 << 12, tiles_cap=16), mesh)
        else:
            sol, _ = sh.build_and_search_sharded(
                _t(tiny), None, 0.5, 0.75, fresh_state(), cfg, mesh)
        out[f"tiny_{fast}"] = (_gathered(sol, mesh), sol["slab_rows"])
        # the step: ranks with no input row still fill and send buckets
        step = sh.make_sharded_step(
            cfg, mesh, 0.75, 0.5, fast=fast,
            knobs=fp.FastKnobs(dense_cap=1 << 12, tiles_cap=32))
        out[f"tiny_step_{fast}"] = _guarded_step(step, mesh, tiny, None,
                                                 0.75)
    empty = SearchConfig(set_sizes=(0,), active_pairs=((0, 0),),
                         stencil_w=1, nbr_cap=16)
    sol, _ = sh.build_and_search_sharded_fast(
        torch.zeros((0, 3)), None, 0.5, 0.75, fresh_state(), empty,
        fp.FastKnobs(), mesh)
    out["empty"] = _gathered(sol, mesh)
    return out


def _engine(shape, variable, mesh=None):
    pts, rad = _cloud(shape, variable)
    n0 = shape["sizes"][0]
    eng = TreeNSearch(device="cpu", mesh=mesh)
    eng.add_point_set(pts[:n0], None if rad is None else rad[:n0])
    eng.add_point_set(pts[n0:], None if rad is None else rad[n0:])
    for si, sj in PAIRS:
        eng.set_active_search(si, sj, True)
    if not variable:
        eng.set_search_radius(0.1)
    eng.set_cell_size(shape["cell"])
    return eng


def _fallback_engine(mesh=None):
    pts = np.random.default_rng(23).uniform(0, 1, (N_FALLBACK, 3)) \
        .astype(np.float32)
    eng = TreeNSearch(device="cpu", mesh=mesh)
    eng.add_point_set(pts)
    eng.set_search_radius(0.1)
    eng.set_all_searches(True)
    return eng


def _neighbors(eng) -> dict:
    return {f"{si}-{sj}": eng.get_neighbors(si, sj)
            for si, sj in zip(*np.nonzero(eng._active))}


def _reduce_fn(env):
    return env["d2"], env["p0_j"] * env["r_j"]


def _payload():
    return [np.arange(ENGINE["sizes"][0], dtype=np.float32), None]


def _cases_engine(mesh) -> dict:
    """The engine on four ranks: ``run()`` under ``mesh=``, then
    ``distribute(None)``; ``set_use_pallas(False)``; ``run_reduce`` and
    ``run_scalar()`` under ``distribute``; the getters."""
    out = {}
    eng = _engine(ENGINE, True, mesh)
    out["mesh_is_mesh"] = eng.get_mesh() is mesh
    eng.run()
    out["run"] = (_neighbors(eng), eng._last_stats["path"],
                  eng._last_stats["slab_rows"])
    out["getters"] = (eng.get_counts(0, 1),
                      eng.get_neighborlist(1, 0, 7).to_numpy(),
                      eng.get_neighborlist_n_bytes())
    seen = []
    eng.for_each_neighbor(0, 0, 3, seen.append)
    out["for_each"] = seen
    eng.distribute(None)
    eng.run()
    out["one_device"] = (_neighbors(eng), eng.get_mesh())
    eng.distribute(mesh)
    out["reduce"] = eng.run_reduce(_reduce_fn, 2, payload=_payload())
    eng = _fallback_engine(mesh)
    eng.set_use_pallas(False)
    eng.run()
    out["no_pallas"] = (_neighbors(eng), eng._last_stats["path"])
    eng = _fallback_engine(mesh)
    eng.run_scalar()
    out["scalar"] = (_neighbors(eng), eng._last_stats["path"])
    return out


def _cases_world(mesh) -> dict:
    """A fixed-radius two-set engine through ``run()`` and
    ``run_scalar()`` under ``mesh``."""
    eng = _engine(PIPE, False, mesh)
    eng.run()
    out = {"run": _neighbors(eng)}
    eng.run_scalar()
    out["scalar"] = _neighbors(eng)
    return out


@pytest.fixture(scope="module")
def functions(tmp_path_factory):
    return _spawn(_cases_functions, 4, tmp_path_factory.mktemp("fn"))


@pytest.fixture(scope="module")
def engine_runs(tmp_path_factory):
    return _spawn(_cases_engine, 4, tmp_path_factory.mktemp("engine"))


# --------------------------------------------------------- the references
def _oracle(pts, rad, sizes, r=None, pairs=PAIRS) -> dict:
    from treensearch_tpu.oracle import BruteforceNSearch
    orc = BruteforceNSearch(search_radius=r)
    off = np.cumsum((0,) + tuple(sizes))
    for k in range(len(sizes)):
        orc.add_point_set(pts[off[k]:off[k + 1]],
                          None if rad is None else rad[off[k]:off[k + 1]])
    for si, sj in pairs:
        orc.set_active_search(si, sj, True)
    orc.run()
    return {f"{si}-{sj}": orc.neighbors[(si, sj)] for si, sj in pairs}


def _jax_pipeline(pts, rad, cfg, r, cell) -> dict:
    """The JAX one-device pipeline (``build_and_search_jit``)."""
    import jax.numpy as jnp
    from treensearch_tpu.config import SearchConfig as JaxConfig
    from treensearch_tpu.ops.grid import fresh_state as jfresh
    from treensearch_tpu.ops.pipeline import build_and_search_jit
    jcfg = JaxConfig(set_sizes=cfg.set_sizes, active_pairs=cfg.active_pairs,
                     variable=cfg.variable, symmetric=cfg.symmetric,
                     stencil_w=cfg.stencil_w, chunk=cfg.chunk,
                     cand_cap=cfg.cand_cap, nbr_cap=cfg.nbr_cap)
    sol, _ = build_and_search_jit(
        jnp.asarray(pts), None if rad is None else jnp.asarray(rad),
        jnp.float32(r), jnp.float32(cell), jfresh(), jcfg)
    return {k: (np.asarray(v["counts"]), np.asarray(v["nbrs"]))
            for k, v in sol["pairs"].items()}


def _as_np(pairs) -> dict:
    return {k: (np.asarray(c), np.asarray(nb)) for k, (c, nb) in pairs.items()}


def _assert_same(got: dict, want: dict, label: str) -> None:
    """Counts bit-equal, neighbor sets equal, pair by pair; ``want`` holds
    (counts, rows) or the oracle's sorted lists."""
    assert set(got) == set(want), label
    for name, (c, nb) in _as_np(got).items():
        ref = want[name]
        if isinstance(ref, list):
            ref = (np.array([len(x) for x in ref]),
                   [np.asarray(x) for x in ref])
        c_ref, nb_ref = ref
        assert np.array_equal(c, c_ref), (label, name)
        for i in range(c.shape[0]):
            row = nb_ref[i] if isinstance(nb_ref, list) \
                else np.sort(nb_ref[i][:c_ref[i]])
            assert np.array_equal(np.sort(nb[i][:c[i]]), row), \
                (label, name, i)


# ------------------------------------------------------------ the functions
@pytest.mark.parametrize("variable", [False, True])
def test_sharded_pipeline_matches_one_device(functions, variable):
    got, flags = functions[0][f"pipe_{variable}"]
    for rank in functions[1:]:
        _assert_same(rank[f"pipe_{variable}"][0], _as_np(got), "rank view")
    assert flags["error"] == 0 and flags["cand_max"] <= 512
    pts, rad = _cloud(PIPE, variable)
    cfg = _cfg(PIPE, variable)
    one, _ = build_and_search(
        _t(pts), _t(rad), fresh_state(), cfg,
        consts=fp.step_constants(cfg, fp.FastKnobs(), PIPE["cell"], "cpu",
                                 search_radius=0.1))
    _assert_same(got, {k: (v["counts"], v["nbrs"])
                       for k, v in one["pairs"].items()}, "port pipeline")
    _assert_same(got, _jax_pipeline(pts, rad, cfg, 0.1, PIPE["cell"]),
                 "JAX build_and_search_jit")
    _assert_same(got, _oracle(pts, rad, PIPE["sizes"], 0.1), "oracle")
    if not variable:
        _assert_same(functions[0]["pipe_step"][0], _as_np(got),
                     "make_sharded_step")


def test_sharded_memory_is_domain_decomposed(functions):
    """Each rank's results cover at most ceil(n / D) points, its local rows
    are its owned rows and its two neighbors', and no halo row shares a
    cell with an owned row (every cell lies in one slab)."""
    d = len(functions)
    owned = [r["decomp"]["slab_rows"][0] for r in functions]
    assert sum(owned) == N_DECOMP
    assert sum(r["decomp"]["rows"] for r in functions) == N_DECOMP
    assert sum(r["decomp"]["sum"] for r in functions) > 0
    for k, r in enumerate(functions):
        dec = r["decomp"]
        own, left, right = dec["slab_rows"]
        assert dec["rows"] <= -(-N_DECOMP // d)
        assert left == (owned[k - 1] if k > 0 else 0)
        assert right == (owned[k + 1] if k + 1 < d else 0)
        local = dec["local"]
        assert local.shape[0] == own + left + right
        st = dec["grid"]
        ijk = quantize(local[:, :3].view(torch.float32), st.grid_min,
                       1.0 / st.cell_size, st.n_cells).tolist()
        own_cells = {tuple(c) for c in ijk[:own]}
        assert not own_cells & {tuple(c) for c in ijk[own:]}
        # owned rows in (sender, position) order: ascending orig
        orig = local[:own, 4]
        assert torch.equal(orig, torch.sort(orig).values)


@functools.lru_cache(maxsize=None)
def _jax_route_and_halo(d: int, slack: tuple) -> list:
    """JAX's ``_route_and_halo`` under ``shard_map`` on ``d`` of the eight
    virtual CPU devices, on the ROUTE cloud, at the bucket rows of each
    ``slack``, in one program: per slack the local rows (d, 3 d S, 8) and
    each device's ``route_overflow``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from treensearch_tpu.config import SearchConfig as JaxConfig
    from treensearch_tpu.ops import grid as jgrid
    from treensearch_tpu.parallel import sharded as jsh

    mesh = Mesh(np.array(jax.devices()[:d]), ("d",))
    pts, rad = _cloud(ROUTE, True)
    n = pts.shape[0]
    l0 = -(-n // d)
    pad = l0 * d - n
    cfg = JaxConfig(set_sizes=ROUTE["sizes"], active_pairs=PAIRS,
                    variable=True, symmetric=True, stencil_w=1, chunk=64,
                    cand_cap=512, nbr_cap=96)
    st = jgrid.update_grid(jgrid.fresh_state(), jnp.asarray(pts),
                           jnp.float32(ROUTE["cell"]))
    pts_in = jnp.asarray(np.concatenate([pts, np.repeat(pts[:1], pad, 0)]))
    rad_in = jnp.asarray(np.concatenate([rad, np.repeat(rad[:1], pad)]))
    orig_in = jnp.arange(l0 * d, dtype=jnp.int32)
    set_in = jnp.asarray(np.concatenate([
        np.repeat(np.arange(2, dtype=np.int32), ROUTE["sizes"]),
        np.full(pad, -1, np.int32)]))

    def program(p, r, o, s, state):
        out = []
        for x in slack:
            local, *_, flag, _x0, _sw = jsh._route_and_halo(
                p, r, o, s, state, cfg, "d", d, sh.route_slots(n, d, x), n)
            out += [local, flag[None]]
        return tuple(out)

    res = jax.jit(jax.shard_map(
        program, mesh=mesh, in_specs=(P("d"),) * 4 + (P(),),
        out_specs=(P("d"),) * (2 * len(slack)), check_vma=False))(
        pts_in, rad_in, orig_in, set_in, st)
    return [(np.asarray(res[2 * k]).reshape(d, -1, 8),
             np.asarray(res[2 * k + 1])) for k in range(len(slack))]


def test_sharded_routing_matches_jax_route_and_halo(functions):
    """The port's routing against JAX's ``_route_and_halo`` at the step's
    bucket rows S (slack 2.5, where no bucket overflows): the exact-size
    local rows equal JAX's valid rows row for row; the bucketed local
    rows equal JAX's bit for bit, sentinel rows included, block for
    block where JAX has a real block (an edge rank gets no halo from
    beyond the edge, where JAX has a block of sentinels)."""
    d = len(functions)
    (blocks, flag), _ = _jax_route_and_halo(d, (sh.ROUTE_SLACK, 0.2))
    n = sum(ROUTE["sizes"])
    big = d * sh.route_slots(n, d, sh.ROUTE_SLACK)
    assert not flag.any()
    for k in range(d):
        want = blocks[k][blocks[k][:, 4] < n]
        assert np.array_equal(functions[k]["route"].numpy(), want), k
        local, slab, overflow = functions[k]["route_buckets"]
        assert overflow == 0
        assert slab == (big, big if k > 0 else 0, big if k < d - 1 else 0)
        want = np.concatenate(
            [blocks[k][:big]] + ([blocks[k][big:2 * big]] if k > 0 else [])
            + ([blocks[k][2 * big:]] if k < d - 1 else []))
        assert np.array_equal(local.numpy(), want), k


def test_sharded_step_route_overflow_at_small_slack(functions):
    """At ``route_slack=0.2`` the step's buckets are too small for the
    ROUTE cloud on four ranks: ``route_overflow`` is 1 on every rank, as
    the per-device flag of JAX's ``_route_and_halo`` (the JAX sharded
    search's ``route_overflow`` is its maximum over the devices) is on
    the same cloud at the same S; the other flags stay 0."""
    _, (_, flag) = _jax_route_and_halo(len(functions), (sh.ROUTE_SLACK, 0.2))
    assert flag.max() == 1
    for rank in functions:
        flags = rank["small_slack"][1]
        assert flags["route_overflow"] == 1
        assert flags["error"] == flags["dense_overflow"] == 0
        assert flags["rows_overflow"] == flags["tile_overflow"] == 0


def _jax_step(shape, variable: bool, fast: bool) -> dict:
    """JAX's ``make_sharded_step`` (route slack 2.5) on four of the eight
    virtual CPU devices; the fast step runs its Pallas kernels in
    interpret mode.  Returns each pair's (counts, rows)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from treensearch_tpu.config import SearchConfig as JaxConfig
    from treensearch_tpu.ops import fastpath as jfp
    from treensearch_tpu.ops.grid import fresh_state as jfresh
    from treensearch_tpu.parallel.sharded import make_sharded_step

    mesh = Mesh(np.array(jax.devices()[:4]), ("d",))
    cfg = _cfg(shape, variable)
    jcfg = JaxConfig(set_sizes=cfg.set_sizes, active_pairs=cfg.active_pairs,
                     variable=cfg.variable, symmetric=cfg.symmetric,
                     stencil_w=cfg.stencil_w, chunk=cfg.chunk,
                     cand_cap=cfg.cand_cap, nbr_cap=cfg.nbr_cap)
    # the window and fat caps of tests/test_sharded.py's fast cases
    knobs = jfp.FastKnobs(wcap=64, dense_cap=1 << 13, use_pallas=True,
                          pre_cap=48, pre_edge=48, interpret=True, fat_cap=8,
                          tiles_cap=96) if fast else None
    step = make_sharded_step(jcfg, mesh, shape["cell"], 0.1, knobs=knobs,
                             fast=fast)
    pts, rad = _cloud(shape, variable)
    sol, _ = step(jfresh(), jnp.asarray(pts),
                  None if rad is None else jnp.asarray(rad))
    assert int(sol["route_overflow"]) == 0
    return {k: (np.asarray(v["counts"]), np.asarray(v["nbrs"]))
            for k, v in sol["pairs"].items()}


@pytest.mark.parametrize("case", ["fast_step_False", "fast_step_True",
                                  "pipe_step"])
def test_sharded_step_matches_jax_step(functions, case):
    """The port's bucketed step (fixed and variable fast, the fixed
    pipeline) on four gloo ranks: counts bit-equal to, rows equal as sets
    with, JAX's ``make_sharded_step`` on the virtual CPU mesh and the
    oracle, with no flag raised (its match with the exact-size run:
    ``test_sharded_fast_matches_one_device``,
    ``test_sharded_pipeline_matches_one_device``)."""
    fast = case != "pipe_step"
    variable = case == "fast_step_True"
    shape = FAST if fast else PIPE
    got, flags, _, _ = functions[0][case]
    assert flags["route_overflow"] == flags["error"] == 0
    assert flags.get("tile_overflow", 0) == flags.get("dense_overflow", 0) \
        == flags.get("rows_overflow", 0) == 0
    for rank in functions[1:]:
        _assert_same(rank[case][0], _as_np(got), "rank view")
    _assert_same(got, _jax_step(shape, variable, fast),
                 "JAX make_sharded_step")
    pts, rad = _cloud(shape, variable)
    _assert_same(got, _oracle(pts, rad, shape["sizes"], 0.1), "oracle")


def test_sharded_step_parks_its_sentinel_rows(functions):
    """One set at a fixed radius (K2a, which reads no set id) with points
    near the origin, where the buckets' sentinel rows lie: the step's
    counts and rows equal the exact-size run's and the oracle's, so no
    sentinel row was a candidate."""
    exact, (got, flags, _, _) = functions[0]["origin"]
    assert flags["route_overflow"] == flags["tile_overflow"] == 0
    _assert_same(got, _as_np(exact), "exact-size run")
    _assert_same(got, _oracle(_origin_cloud(), None, (N_ORIGIN,), 0.1,
                              ((0, 0),)), "oracle")


def test_sharded_step_makes_no_host_read(functions):
    """Every rank ran the fixed, variable, pipeline and small-slack steps
    with every host read and host-to-device copy outside the kernel
    wrappers made to raise (``torch_step_guard.no_host_reads``, applied
    inside each rank): each wrote the new grid into the state it was
    given, and its local rows are the static D S (1 + neighbors)."""
    d = len(functions)
    for case, shape, slack in (("fast_step_False", FAST, sh.ROUTE_SLACK),
                               ("fast_step_True", FAST, sh.ROUTE_SLACK),
                               ("pipe_step", PIPE, sh.ROUTE_SLACK),
                               ("small_slack", ROUTE, 0.2)):
        big = d * sh.route_slots(sum(shape["sizes"]), d, slack)
        for k, rank in enumerate(functions):
            _, _, slab, in_place = rank[case]
            assert in_place, (case, k)
            assert slab == (big, big if k > 0 else 0,
                            big if k < d - 1 else 0), (case, k)


@pytest.mark.parametrize("variable", [False, True])
def test_sharded_fast_matches_one_device(functions, variable):
    got, flags = functions[0][f"fast_{variable}"]
    assert flags == {"error": 0, "dense_overflow": 0, "rows_overflow": 0,
                     "tile_overflow": 0, "route_overflow": 0, "cand_max": 0}
    pts, rad = _cloud(FAST, variable)
    cfg = _cfg(FAST, variable)
    knobs = fp.FastKnobs(dense_cap=1 << 14, tiles_cap=128)
    one, _ = fp.build_and_search_fast(
        _t(pts), 0.1, fresh_state(), cfg, knobs, radii=_t(rad),
        consts=fp.step_constants(cfg, knobs, FAST["cell"], "cpu",
                                 search_radius=0.1))
    _assert_same(got, {k: (v["counts"], fp.materialize_nbrs(v))
                       for k, v in one["pairs"].items()}, "port fast path")
    _assert_same(got, _jax_pipeline(pts, rad, cfg, 0.1, FAST["cell"]),
                 "JAX build_and_search_jit")
    _assert_same(got, _oracle(pts, rad, FAST["sizes"], 0.1), "oracle")
    _assert_same(functions[0][f"fast_step_{variable}"][0], _as_np(got),
                 "make_sharded_step(fast=True)")


def test_sharded_empty_and_tiny(functions):
    """Three points on four ranks (ranks that own nothing still enter
    every collective), exact and through the step's buckets, and no
    point at all."""
    tiny = np.random.default_rng(1).uniform(0, 1, (3, 3)).astype(np.float32)
    want = _oracle(tiny, None, (3,), 0.5, ((0, 0),))
    for fast in (False, True):
        got, _ = functions[0][f"tiny_{fast}"]
        assert got["0-0"][0].shape == (3,)
        _assert_same(got, want, f"tiny, fast={fast}")
        got, flags, _, _ = functions[0][f"tiny_step_{fast}"]
        assert flags["route_overflow"] == flags.get("tile_overflow", 0) == 0
        _assert_same(got, want, f"tiny step, fast={fast}")
        assert sum(r[f"tiny_{fast}"][1][0] for r in functions) == 3
        assert min(r[f"tiny_{fast}"][1][0] for r in functions) == 0
    assert functions[0]["empty"]["0-0"][0].shape == (0,)


# --------------------------------------------------------------- the engine
def test_engine_distribute_matches_one_device(engine_runs):
    """``TreeNSearch(mesh=)`` runs the sharded fast path (variable radii,
    symmetric, two sets), equal to the port's and JAX's one-device
    engines and the oracle; ``distribute(None)`` returns it to one
    device."""
    out = engine_runs[0]
    assert out["mesh_is_mesh"]
    got, path, slab = out["run"]
    assert path == "fast" and sum(
        r["run"][2][0] for r in engine_runs) == sum(ENGINE["sizes"])
    one = _engine(ENGINE, True)
    one.run()
    want = _neighbors(one)
    _assert_same(got, want, "port engine")
    pts, rad = _cloud(ENGINE, True)
    _assert_same(got, _jax_pipeline(pts, rad, _cfg(ENGINE, True), 0.1,
                                    ENGINE["cell"]), "JAX pipeline")
    _assert_same(got, _oracle(pts, rad, ENGINE["sizes"]), "oracle")
    back, mesh = out["one_device"]
    assert mesh is None
    _assert_same(back, want, "after distribute(None)")


def test_engine_getters_are_collective_and_equal(engine_runs):
    one = _engine(ENGINE, True)
    one.run()
    seen = []
    one.for_each_neighbor(0, 0, 3, seen.append)
    for out in engine_runs:
        counts, row, n_bytes = out["getters"]
        assert np.array_equal(counts, one.get_counts(0, 1))
        assert np.array_equal(np.sort(row),
                              np.sort(one.get_neighborlist(1, 0, 7)
                                      .to_numpy()))
        assert n_bytes == one.get_neighborlist_n_bytes()
        assert sorted(out["for_each"]) == sorted(seen)


def test_engine_without_pallas_takes_the_sharded_pipeline(engine_runs):
    """``set_use_pallas(False)`` under a mesh runs the sharded pipeline
    (``treensearch_tpu/api.py:716-718``), equal to the JAX engine's
    ``run()`` with its Pallas gate closed, the port's and the oracle."""
    from treensearch_tpu import TreeNSearch as JaxTreeNSearch
    got, path = engine_runs[0]["no_pallas"]
    assert path == "reference"
    one = _fallback_engine()
    one.set_use_pallas(False)
    one.run()
    _assert_same(got, _neighbors(one), "port engine")
    pts = one._sets[0].points
    jeng = JaxTreeNSearch()
    jeng.add_point_set(pts)
    jeng.set_search_radius(0.1)
    jeng.set_all_searches(True)
    jeng.set_use_pallas(False)
    jeng.run()
    _assert_same(got, {"0-0": tuple(map(np.asarray,
                                        jeng.get_neighbors(0, 0)))},
                 "JAX TreeNSearch")
    _assert_same(got, _oracle(pts, None, (N_FALLBACK,), 0.1, ((0, 0),)),
                 "oracle")


def test_engine_run_scalar_under_a_mesh(engine_runs):
    got, path = engine_runs[0]["scalar"]
    assert path == "reference"
    one = _fallback_engine()
    one.run_scalar()
    _assert_same(got, _neighbors(one), "port run_scalar")


def test_engine_run_reduce_under_a_mesh(engine_runs):
    """The sharded fused reduce (K3's plain version on each rank's slab,
    the payload riding the routed records) within rtol 5e-5 of the
    one-device ``run_reduce`` on every rank."""
    one = _engine(ENGINE, True)
    want = one.run_reduce(_reduce_fn, 2, payload=_payload())
    for out in engine_runs:
        got = out["reduce"]
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == want[k].shape
            torch.testing.assert_close(got[k], want[k], rtol=5e-5, atol=0)


@pytest.mark.parametrize("world", [1, 3])
def test_engine_at_other_world_sizes(world, tmp_path):
    runs = _spawn(_cases_world, world, tmp_path)
    one = _engine(PIPE, False)
    one.run()
    want = _neighbors(one)
    pts, _ = _cloud(PIPE, False)
    ref = _oracle(pts, None, PIPE["sizes"], 0.1)
    for out in runs:
        _assert_same(out["run"], want, f"run() at D = {world}")
        _assert_same(out["scalar"], ref, f"run_scalar() at D = {world}")


# ------------------------------------------------------------------ the prep
@pytest.mark.parametrize("variable", [False, True])
def test_prep_sharded_parameters_bit_equal_to_jax(variable):
    """``_prep(valid, owned_rng, lin_base, span_i)`` against JAX's
    ``_pallas_prep`` on rank 1 of 4's slab-local rows, with a few rows
    parked invalid: every carried field, the descriptor columns and the
    dead-tile (tier skip) column bit-equal."""
    import jax
    import jax.numpy as jnp
    from treensearch_tpu.config import SearchConfig as JaxConfig
    from treensearch_tpu.ops import fastpath as jfp
    from treensearch_tpu.ops import grid as jgrid
    from treensearch_tpu_torch import interop

    pts, rad = _cloud(FAST, variable)
    cfg_all = _cfg(FAST, variable)
    jst = jgrid.update_grid(jgrid.fresh_state(), jnp.asarray(pts),
                            jnp.float32(FAST["cell"]))
    st = interop.grid_state_from_numpy(
        {k: np.asarray(v) for k, v in jst._asdict().items()})
    owner = sh.owners(_t(pts), st, cfg_all, 4).numpy()
    rows = np.concatenate([np.nonzero(owner == o)[0] for o in (1, 0, 2)])
    local = pts[rows]
    valid = np.ones(rows.shape[0], bool)
    valid[::37] = False
    m = rows.shape[0]
    lin_base, span_i, (lo, hi) = sh.slab_window(st, cfg_all, 1, 4)
    sizes, pairs = (m,), ((0, 0),)
    knobs = fp.FastKnobs(dense_cap=1 << 13, tiles_cap=96)
    cfg = SearchConfig(sizes, pairs, 1, 64, variable, variable)
    tc = fp._prep(torch.from_numpy(local), st, cfg,
                  knobs, _t(rad[rows]) if variable else None,
                  valid=torch.from_numpy(valid), owned_rng=(lo, hi),
                  lin_base=lin_base, span_i=span_i,
                  consts=fp.step_constants(cfg, knobs, FAST["cell"], "cpu",
                                           search_radius=0.1))
    jknobs = jfp.FastKnobs(use_pallas=True, rec_expand=True, pack=8,
                           lane_batch=True, dense_cap=knobs.dense_cap,
                           tiles_cap=knobs.tiles_cap)
    jcfg = JaxConfig(sizes, pairs, variable, variable, 1, 1024, 512, 64)
    i32 = jnp.int32
    jc = jax.jit(jfp._pallas_prep, static_argnames=("cfg", "knobs"))(
        jnp.asarray(local), jnp.asarray(rad[rows]) if variable else None,
        jst, cfg=jcfg, knobs=jknobs, valid=jnp.asarray(valid),
        owned_rng=(i32(int(lo)), i32(int(hi))), lin_base=i32(int(lin_base)),
        span_i=i32(int(span_i)))
    jc = {k: np.asarray(v) for k, v in jc._asdict().items()}
    tc = {k: v.numpy() for k, v in tc._asdict().items()}
    for k in ("lin_s", "lin_chk", "r_chk", "idx_s", "inv_perm", "pp", "qpos",
              "dense_overflow", "tile_overflow", "rows_overflow", "win_max",
              "n_cells_stat"):
        assert np.array_equal(tc[k], jc[k]), k
    jd, td = jc["desc"], tc["desc"]
    assert np.array_equal(td[:, :FAT_COL], jd[:, :FAT_COL])
    assert np.array_equal(td[:, FAT_COL] == 2, jd[:, FAT_COL] == 2)
    # the owned filter kills some tiles that hold points; parked rows sort
    # after every valid row
    live = td[:96, FAT_COL] != 2
    assert (td[:96, 63][~live] > 0).any() and live.any()
    assert (tc["lin_s"][-int((~valid).sum()):] == knobs.dense_cap - 1).all()
