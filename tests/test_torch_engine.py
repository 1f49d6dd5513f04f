"""``TreeNSearch(device="cpu")`` of the port against the numpy oracle
(``BruteforceNSearch``) and against the JAX ``TreeNSearch`` (its XLA tile
path on the CPU), on the single-set rows of ``test_correctness.py`` and
``test_edge_cases.py``.

Tolerance: against the oracle, neighbor sets are exact (both round d^2
the same way in float32).  Against JAX, counts and sets are exact except
for a pair whose float64 d^2 lies within 4 ulp of float32 r^2, because
XLA on the CPU may contract to FMA where eager PyTorch does not; such
pairs are reported, and the lattice data must show none.
"""

import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import grid_for_n
from treensearch_tpu import TreeNSearch as JaxTreeNSearch
from treensearch_tpu.config import SearchConfig as JaxConfig
from treensearch_tpu.ops import fastpath as jfp
from treensearch_tpu.oracle import BruteforceNSearch
from treensearch_tpu_torch import NeighborList, NeighborSolution, TreeNSearch
from treensearch_tpu_torch import api as tapi


def _port(pts, r, cell=None, cap=None, run=True):
    eng = TreeNSearch(device="cpu")
    eng.add_point_set(pts)
    eng.set_search_radius(r)
    if cell is not None:
        eng.set_cell_size(cell)
    if cap is not None:
        eng.set_neighbor_cap(cap)
    eng.set_all_searches(True)
    if run:
        eng.run()
    return eng


def _oracle(pts, r):
    orc = BruteforceNSearch(search_radius=r)
    orc.add_point_set(np.asarray(pts, np.float32))
    orc.set_all_searches(True)
    orc.run()
    return orc


def _port_vs_jax(pts, r):
    """Port and JAX neighbor sets; returns the boundary pairs in which they
    differ (any other difference fails)."""
    eng = _port(pts, r)
    jeng = JaxTreeNSearch()
    jeng.add_point_set(pts)
    jeng.set_search_radius(r)
    jeng.set_all_searches(True)
    jeng.run()
    pc, pn = (t.numpy() for t in eng.get_neighbors(0, 0))
    jc, jn = (np.asarray(a) for a in jeng.get_neighbors(0, 0))
    r2 = np.float32(r) * np.float32(r)
    tol = 4 * float(np.spacing(r2))
    p64 = pts.astype(np.float64)
    boundary = []
    for i in range(pts.shape[0]):
        a, b = set(pn[i, :pc[i]].tolist()), set(jn[i, :jc[i]].tolist())
        for j in sorted(a ^ b):
            d2 = float(np.sum((p64[j] - p64[i]) ** 2))
            assert abs(d2 - float(r2)) <= tol, (i, j, d2, float(r2))
            boundary.append((i, j))
    if boundary:
        warnings.warn(f"{len(boundary)} pairs at the r^2 boundary differ "
                      f"between XLA and PyTorch rounding: {boundary[:8]}")
    return boundary


@pytest.mark.parametrize("n", [1, 100, 4000])
def test_lattice_fixed_radius_vs_oracle(n):
    # reference tests.cpp:91-112 (test_correctness.py one-set suite)
    pts, r = grid_for_n(n)
    _oracle(pts, r).compare(_port(pts, r))


def test_lattice_vs_jax_has_no_boundary_pairs():
    pts, r = grid_for_n(4000)
    assert _port_vs_jax(pts, float(r)) == []


@pytest.mark.parametrize("n", [127, 128, 129])
def test_sizes_around_one_tile(n):
    rng = np.random.default_rng(n)
    pts = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    _oracle(pts, 0.3).compare(_port(pts, 0.3))
    _port_vs_jax(pts, 0.3)


def test_whole_slice_uniform_cloud_vs_jax_and_oracle():
    pts = np.random.default_rng(0).uniform(0, 1, (4000, 3)) \
        .astype(np.float32)
    _port_vs_jax(pts, 0.07)
    _oracle(pts, 0.07).compare(_port(pts, 0.07))


def test_double_input_is_cast_at_ingest():
    pts, r = grid_for_n(1800)
    pts64 = pts.astype(np.float64) + 1e-9
    _oracle(pts64.astype(np.float32), float(r)).compare(
        _port(pts64, float(r)))


def test_single_point():
    eng = _port(np.zeros((1, 3), np.float32), 1.0)
    assert eng.get_neighborlist(0, 0, 0).size() == 0


def test_empty_set_then_resize():
    eng = _port(np.zeros((0, 3), np.float32), 0.3)
    assert eng.get_counts(0, 0).shape == (0,)
    assert eng.get_neighbors(0, 0)[1].shape[0] == 0
    pts = np.random.default_rng(12).uniform(0, 1, (50, 3)).astype(np.float32)
    eng.resize_point_set(0, pts)
    eng.run()
    _oracle(pts, 0.3).compare(eng)


def test_coincident_points_are_mutual_neighbors_but_not_self():
    pts = np.zeros((4, 3), np.float32)
    eng = _port(pts, 0.1)
    _oracle(pts, 0.1).compare(eng)
    assert sorted(eng.get_neighborlist(0, 0, 2)) == [0, 1, 3]


def test_all_points_in_one_cell():
    pts = np.random.default_rng(5).uniform(0, 1e-4, (50, 3)) \
        .astype(np.float32)
    _oracle(pts, 0.5).compare(_port(pts, 0.5))


def test_no_active_searches_is_legal():
    eng = _port(np.random.default_rng(1).uniform(0, 1, (10, 3))
                .astype(np.float32), 0.2, run=False)
    eng.set_all_searches(False)
    eng.run()
    with pytest.raises(KeyError):
        eng.get_neighborlist(0, 0, 0)


def test_domain_overflow_raises():
    eng = _port(np.array([[0, 0, 0], [1e6, 1e6, 1e6]], np.float32), 1.0,
                cell=1.0, run=False)
    with pytest.raises(RuntimeError, match="cells per"):
        eng.run()


def test_moving_points_under_hysteresis():
    rng = np.random.default_rng(2)
    pts = rng.uniform(0, 1, (500, 3)).astype(np.float32)
    eng = _port(pts, 0.12, run=False)
    kept = 0
    prev = None
    for _ in range(4):
        pts = (pts + rng.uniform(-0.005, 0.005, pts.shape)
               .astype(np.float32)).astype(np.float32)
        eng.resize_point_set(0, pts)
        eng.run()
        _oracle(pts, 0.12).compare(eng)
        cur = eng._grid_state.grid_min.clone()
        kept += int(prev is not None and torch.equal(cur, prev))
        prev = cur
    assert kept > 0   # the grid was kept across at least one step


def test_resize_grow_and_shrink():
    # reference tests.cpp:188-237, fixed radius
    pts, r = grid_for_n(1000)
    r = float(r)
    eng = _port(pts, r)
    _oracle(pts, r).compare(eng)
    pts2 = np.concatenate([pts, pts + np.float32(0.05)], axis=0)
    eng.resize_point_set(0, pts2)
    eng.run()
    _oracle(pts2, r).compare(eng)
    k = pts2.shape[0] // 3
    eng.resize_point_set(0, pts2[:k])
    eng.run()
    _oracle(pts2[:k], r).compare(eng)


def test_resize_same_buffer_is_noop():
    pts = np.random.default_rng(3).uniform(0, 1, (64, 3)).astype(np.float32)
    eng = _port(pts, 0.2)
    sol = eng._solution
    eng.resize_point_set(0, pts)
    assert eng._solution is sol
    eng.resize_point_set(0, pts.copy())
    assert eng._solution is None


def test_neighbor_cap_regrow():
    pts = np.random.default_rng(4).uniform(0, 1, (1500, 3)) \
        .astype(np.float32)
    eng = _port(pts, 0.12, cap=8)
    assert eng._nbr_cap > 8
    assert eng._last_stats["max_count"] > 8
    _oracle(pts, 0.12).compare(eng)


def test_tile_and_dense_regrow():
    # a thin slab: ~500 short grid rows, each padded to its own tile,
    # overflow the default tile slots; a fine cell overflows the default
    # dense table
    rng = np.random.default_rng(6)
    pts = np.stack([rng.uniform(0, 1, 2000), rng.uniform(0, 1, 2000),
                    rng.uniform(0, 0.03, 2000)], 1).astype(np.float32)
    eng = _port(pts, 0.05, cell=0.05)
    # grown by 1.5x + 64 on overflow, then snug to the used tiles
    assert eng._tiles_cap > tapi.default_tiles_cap(2000)
    _oracle(pts, 0.05).compare(eng)
    cube = rng.uniform(0, 1, (2000, 3)).astype(np.float32)
    eng2 = _port(cube, 0.02, cell=0.02)
    assert eng2._dense_cap > 1 << 16   # the default for small n
    _oracle(cube, 0.02).compare(eng2)


def test_query_api():
    pts = np.random.default_rng(8).uniform(0, 1, (300, 3)) \
        .astype(np.float32)
    eng = _port(pts, 0.15, run=False)
    with pytest.raises(RuntimeError, match="run"):
        eng.get_counts(0, 0)
    eng.run()
    counts, nbrs = eng.get_neighbors(0, 0)
    assert isinstance(counts, torch.Tensor) and counts.dtype == torch.int32
    assert nbrs.shape[0] == 300 and nbrs.shape[1] % 8 == 0
    assert np.array_equal(eng.get_counts(0, 0), counts.numpy())
    orc = _oracle(pts, 0.15)
    for i in (0, 17, 299):
        nl = eng.get_neighborlist(0, 0, i)
        assert isinstance(nl, NeighborList) and len(nl) == counts[i]
        seen = []
        eng.for_each_neighbor(0, 0, i, seen.append)
        assert sorted(seen) == orc.neighbors[(0, 0)][i].tolist()
        assert np.array_equal(np.sort(nl.to_numpy()),
                              np.sort(nbrs[i, :counts[i]].numpy()))
        assert (nbrs[i, counts[i]:] == -1).all()


def test_active_search_overloads_and_symmetric_flag():
    pts = np.random.default_rng(9).uniform(0, 1, (40, 3)).astype(np.float32)
    eng = _port(pts, 0.3, run=False)
    eng.set_active_search(0, 0, False)
    assert not eng._active[0, 0]
    eng.set_active_search(0, True, True)
    assert eng._active[0, 0]
    eng.set_symmetric_search(False)   # stored; no effect at a fixed radius
    eng.run()
    _oracle(pts, 0.3).compare(eng)


def _variable_wide_stencil(eng):
    # radii spread 1..10: the stencil from r_max at a cell of 1.5 r_min
    # is 7 cells, past the descriptor's 3
    eng = TreeNSearch(device="cpu")
    eng.add_point_set(np.random.default_rng(0).uniform(0, 1, (5, 3)),
                      np.array([0.01, 0.02, 0.05, 0.08, 0.1]))
    eng.set_all_searches(True)
    return eng


def _wide_cell_stencil(eng):
    eng.set_cell_size(0.05)   # r = 0.4 spans 8 cells
    return eng


# the JAX package's Pallas gate, which run_reduce and run_mask keep
# (treensearch_tpu/api.py:667-690)
FUSED_GATE = "requires the Pallas fast path"
NOT_PORTED = {
    # the device contracts need the fused route (here a 9-cell stencil)
    "run_reduce": (lambda e: (e.set_cell_size(0.05),
                              e.run_reduce(lambda env: env["d2"])),
                   FUSED_GATE),
    "run_mask": (lambda e: (e.set_cell_size(0.05), e.run_mask()),
                 FUSED_GATE),
    # as the JAX engine (treensearch_tpu/api.py:664-671), the mask refuses
    # a mesh
    "run_mask_mesh": (lambda e: (e.distribute(_mesh("cpu")), e.run_mask()),
                      "no mesh"),
}


def _mesh(device_type, name="d"):
    """A one-rank ``DeviceMesh`` that needs no process group (the calls
    below raise before any collective)."""
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(device_type, [0], mesh_dim_names=(name,),
                      _init_backend=False, _rank=0)


@pytest.mark.parametrize("what", list(NOT_PORTED))
def test_outside_the_slice_raises_not_implemented(what):
    eng = _port(np.random.default_rng(0).uniform(0, 1, (5, 3))
                .astype(np.float32), 0.4, run=False)
    call, match = NOT_PORTED[what]
    with pytest.raises(NotImplementedError, match=match):
        call(eng)


MESH_MISUSE = {
    # a mesh without the named dimension (treensearch_tpu/api.py:187-188)
    "distribute": (lambda e: e.distribute(_mesh("cpu", "x")), "dimension"),
    # a mesh of another device type than the engine's
    "mesh": (lambda e: TreeNSearch(device="cpu", mesh=_mesh("cuda")),
             "device type"),
}


@pytest.mark.parametrize("what", list(MESH_MISUSE))
def test_mesh_misuse_raises_value_error(what):
    eng = _port(np.random.default_rng(0).uniform(0, 1, (5, 3))
                .astype(np.float32), 0.4, run=False)
    call, match = MESH_MISUSE[what]
    with pytest.raises(ValueError, match=match):
        call(eng)
    assert eng.get_mesh() is None


WIDE_STENCIL = {"variable_radii": _variable_wide_stencil,
                "wide_stencil": _wide_cell_stencil}


@pytest.mark.parametrize("what", list(WIDE_STENCIL))
def test_wide_stencil_run_raises_naming_run_scalar(what):
    eng = WIDE_STENCIL[what](_port(np.random.default_rng(0).uniform(
        0, 1, (5, 3)).astype(np.float32), 0.4, run=False))
    with pytest.raises(ValueError, match=r"run_scalar\(\)"):
        eng.run()
    with pytest.raises(ValueError, match=r"run_scalar\(\)"):
        eng.make_step_fn()
    eng.run_scalar()   # the pipeline serves any stencil
    assert eng._last_stats["path"] == "reference"


def _second_set(rng):
    # two candidate sets under set_use_pallas(False): the tile path
    a = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    b = rng.uniform(0, 1, (200, 3)).astype(np.float32)
    return [a, b], 0.15, lambda e: (e.set_use_pallas(False), e.run())


def _nine_sets(rng):
    # nine candidate sets: more than the fused kernels' 8, the tile path
    return ([rng.uniform(0, 1, (60, 3)).astype(np.float32)
             for _ in range(9)], 0.2, lambda e: e.run())


def _scalar(rng):
    return ([rng.uniform(0, 1, (400, 3)).astype(np.float32)], 0.12,
            lambda e: e.run_scalar())


def _pipeline_step(rng):
    def call(e):
        step, state = e.make_step_fn(fast=False)
        points = torch.from_numpy(np.concatenate(
            [np.asarray(s.points, np.float32) for s in e._sets]))
        sol, _ = step(state, points)
        e._solution = NeighborSolution(sol["pairs"])
    return ([rng.uniform(0, 1, (400, 3)).astype(np.float32)], 0.12, call)


def _sparse_domain(rng):
    # two clusters 100 cells apart on every axis need ~1e6 table slots,
    # past the (here lowered) dense cap: the pipeline serves them
    def call(e):
        e.run()
        assert e._last_stats["path"] == "reference"
    return ([np.concatenate([rng.uniform(0, 1, (150, 3)),
                             rng.uniform(99, 100, (150, 3))])
             .astype(np.float32)], 0.3, call)


FALLBACKS = {"second_set": _second_set, "nine_candidate_sets": _nine_sets,
             "run_scalar": _scalar, "make_step_fn": _pipeline_step,
             "sparse_domain": _sparse_domain}


@pytest.mark.parametrize("what", list(FALLBACKS))
def test_fallbacks_match_the_oracle(what, monkeypatch):
    monkeypatch.setattr(tapi, "_MAX_DENSE_CAP", 1 << 17)
    sets, r, call = FALLBACKS[what](np.random.default_rng(1))
    eng = TreeNSearch(device="cpu")
    orc = BruteforceNSearch(search_radius=r)
    for p in sets:
        eng.add_point_set(p)
        orc.add_point_set(p)
    eng.set_search_radius(r)
    eng.set_cell_size(r)
    eng.set_all_searches(True)
    orc.set_all_searches(True)
    orc.run()
    call(eng)
    orc.compare(eng)


def test_adding_a_variable_set_to_a_fixed_engine_raises():
    eng = _port(np.zeros((3, 3), np.float32), 0.4, run=False)
    with pytest.raises(ValueError, match="mix"):
        eng.add_point_set(np.zeros((3, 3)), np.ones(3))


# the JAX package's setters without a GPU meaning: accepted, checked as
# the JAX setters check them, and without effect
NO_OP_SETTERS = [("set_n_threads", (4,)), ("set_recursion_cap", (1000,)),
                 ("set_n_points_for_parallel_octree", ()),
                 ("set_record_pack", (8,)), ("set_record_pack", (16,)),
                 ("set_prestage_caps", (96, 48)),
                 ("set_tiles_per_step", (2,)), ("set_brick", ((2, 2, 3),)),
                 ("set_brick", (None,)), ("set_lane_batch", (True,))]
BAD_SETTER_ARGS = [("set_n_threads", ("many",)),
                   ("set_recursion_cap", (None,)),
                   ("set_n_points_for_parallel_octree", ("all",)),
                   ("set_window_cap", (8,)), ("set_record_pack", (3,)),
                   ("set_prestage_caps", ("wide",)),
                   ("set_prestage_caps", (96, "wide")),
                   ("set_tiles_per_step", (3,)), ("set_brick", ((2, 2),)),
                   ("set_brick", ((0, 1, 1),)), ("set_chunk_size", (4,))]


@pytest.mark.parametrize("name,args", NO_OP_SETTERS)
def test_tpu_setters_are_accepted_without_effect(name, args):
    pts = np.random.default_rng(0).uniform(0, 1, (200, 3)).astype(np.float32)
    eng = _port(pts, 0.15)
    counts = eng.get_counts(0, 0)
    knobs, cfg = eng._knobs(), eng._make_cfg(1)
    assert getattr(eng, name)(*args) is None
    assert eng._knobs() == knobs and eng._make_cfg(1) == cfg
    eng.run()
    assert np.array_equal(eng.get_counts(0, 0), counts)


@pytest.mark.parametrize("name,args", BAD_SETTER_ARGS)
def test_tpu_setters_check_their_arguments_as_jax_does(name, args):
    with pytest.raises((TypeError, ValueError)) as jax_err:
        getattr(JaxTreeNSearch(), name)(*args)
    with pytest.raises(jax_err.type):
        getattr(_port(np.zeros((3, 3), np.float32), 0.4, run=False),
                name)(*args)


def test_window_cap_sizes_the_tile_path_and_regrows():
    # 16 slots cut most windows: the tile path reports the widest, the
    # host regrows wcap and re-runs; the fused route ignores the cap
    pts = np.random.default_rng(10).uniform(0, 1, (1500, 3)) \
        .astype(np.float32)
    eng = _port(pts, 0.1, run=False)
    eng.set_window_cap(16)
    assert eng._knobs().wcap == 16
    eng.set_use_pallas(False)
    eng.run()
    assert eng._wcap > 16 and eng._last_stats["cand_max"] <= eng._wcap
    _oracle(pts, 0.1).compare(eng)
    fused = _port(pts, 0.1, run=False)
    fused.set_window_cap(16)
    fused.run()
    assert fused._wcap == 16
    _oracle(pts, 0.1).compare(fused)


def test_split_stage_and_coherence_setters():
    eng = _port(np.zeros((3, 3), np.float32), 0.4, run=False)
    assert not eng._knobs().split_stage and eng._use_carry
    eng.set_split_stage(True)
    eng.set_coherence(False)
    assert eng._knobs().split_stage and not eng._use_carry


@pytest.fixture(scope="module")
def engines():
    """The port and the JAX engine after one run() on one numpy-seeded
    cloud of two sets, set 0 searching itself and set 1 searching set 0
    (one JAX compile for the module's getter tests)."""
    rng = np.random.default_rng(21)
    sets = [rng.uniform(0, 1, (m, 3)).astype(np.float32) for m in (600, 250)]
    out = [TreeNSearch(device="cpu"), JaxTreeNSearch()]
    for e in out:
        for p in sets:
            e.add_point_set(p)
        e.set_search_radius(0.1)
        e.set_active_search(0, 0, True)
        e.set_active_search(1, 0, True)
        e.run()
    return out


def test_get_n_threads_keeps_its_value_as_jax(engines):
    for e in engines:
        e.set_n_threads(3)
    assert [e.get_n_threads() for e in engines] == [3, 3]


def test_get_mesh_is_none_as_jax(engines):
    assert [e.get_mesh() for e in engines] == [None, None]


def test_neighborlist_n_bytes_equals_jax(engines):
    eng, jeng = engines
    n_bytes = eng.get_neighborlist_n_bytes()
    assert n_bytes == jeng.get_neighborlist_n_bytes() > 0
    # the view's size, whether or not the rows are materialised
    eng.get_neighbors(0, 0)
    assert eng._solution.n_bytes() == n_bytes


@pytest.mark.parametrize("pair", [(0, 0), (1, 0)])
def test_get_padded_equals_jax(engines, pair):
    eng, jeng = engines
    pad = eng._solution.get_padded(*pair)
    jpad = np.asarray(jeng._solution.get_padded(*pair))
    counts = eng.get_counts(*pair)
    assert pad.shape == jpad.shape and pad.dtype == np.int32
    assert np.array_equal(counts, np.asarray(jeng.get_counts(*pair)))
    for i in range(pad.shape[0]):
        assert sorted(pad[i, :counts[i]]) == sorted(jpad[i, :counts[i]])
        assert (pad[i, counts[i]:] == -1).all()


# the numeric lines of print_state (treensearch_tpu/api.py:1202-1262)
NUMERIC_LINES = ("  world box:", "  occupied cells:",
                 "  points per occupied cell", "  candidate windows:",
                 "  pair (", "  neighborlist bytes:")


def _numeric_lines(eng, capsys):
    eng.print_state()
    out = capsys.readouterr().out
    return [ln for ln in out.splitlines() if ln.startswith(NUMERIC_LINES)]


def test_print_state_numeric_lines_equal_jax(engines, capsys):
    """World box, occupancy, candidate windows, per-pair counts and list
    bytes as the JAX engine prints them.  The JAX engine's run took its
    tile path, which keeps no window histogram; its Pallas route would
    store the carry's ``win_hist`` in ``_last_stats``
    (``treensearch_tpu/api.py:596-597``), so it gets the histogram of the
    JAX prep on the same points, grid and config."""
    eng, jeng = engines
    sizes = tuple(s.n for s in jeng._sets)
    pts = jnp.asarray(np.concatenate([np.asarray(s.points) for s in
                                      jeng._sets]))
    jc = jax.jit(jfp._pallas_prep, static_argnames=("cfg", "knobs"))(
        pts, None, jeng._grid_state,
        cfg=JaxConfig(sizes, ((0, 0), (1, 0)), False, False, 1, 1024, 512,
                      80),
        knobs=jfp.FastKnobs(use_pallas=True, rec_expand=True, pack=8,
                            lane_batch=True, dense_cap=1 << 14,
                            tiles_cap=256))
    jeng._last_stats["win_hist"] = np.asarray(jc.win_hist)
    lines = _numeric_lines(eng, capsys)
    kinds = [next(k for k in NUMERIC_LINES if ln.startswith(k))
             for ln in lines]
    assert kinds == list(NUMERIC_LINES[:5]) + ["  pair ("] \
        + [NUMERIC_LINES[5]]
    assert lines == _numeric_lines(jeng, capsys)


def test_print_state_variable_radius_smoke(capsys):
    # tests/test_step_fn.py::test_print_state_smoke on the port alone
    rng = np.random.default_rng(2)
    eng = TreeNSearch(device="cpu")
    eng.add_point_set(rng.uniform(0, 1, (200, 3)).astype(np.float32),
                      rng.uniform(0.05, 0.2, 200).astype(np.float32))
    eng.add_point_set(rng.uniform(0, 1, (50, 3)).astype(np.float32),
                      rng.uniform(0.05, 0.2, 50).astype(np.float32))
    eng.set_all_searches(True)
    eng.print_state()           # before any run: options and sets only
    assert "world box" not in capsys.readouterr().out
    eng.run()
    eng.print_state()
    out = capsys.readouterr().out
    assert "world box" in out and "pair (0->0)" in out
    assert "radius min/avg/max" in out and "neighborlist bytes" in out
    assert "candidate windows" in out
    eng.run_scalar()            # no carry behind this run: no windows
    eng.print_state()
    out = capsys.readouterr().out
    assert "candidate windows" not in out and "pair (1->1)" in out


def test_profile_run_writes_a_trace_on_the_cpu(tmp_path):
    eng = _port(np.random.default_rng(0).uniform(0, 1, (400, 3))
                .astype(np.float32), 0.1, run=False)
    trace_dir = str(tmp_path / "trace")
    assert eng.profile_run(trace_dir, n_steps=2) == trace_dir
    trace = tmp_path / "trace" / "treensearch.pt.trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("name") == "aten::sort" for e in events)
    assert eng._solution is not None   # the settling run() happened
