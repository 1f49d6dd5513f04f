"""The temporal-coherence carry (``ops/fastpath.py::
build_and_search_fast_carry``) and ``TreeNSearch.make_step_fn`` of the port
against the JAX package and the numpy oracle.

- **Against JAX.** One module-scoped run of the JAX ``make_step_fn(
  reuse=True)`` (its Pallas kernel in interpret mode, one compile) over a
  point sequence: cold, the same points, every point moved by 1e-6,
  moved across cells, the same again.  The port's ``make_step_fn(
  reuse=True)`` on the CPU must report the same ``rebuilt`` step by step
  and the same counts.
- **``tests/test_reuse.py``'s four**, on the port: reuse and rebuild exact
  against the oracle; changed radii rebuild; ``run()`` rides the carry and
  stays exact; a cap change rebuilds (the carry's key).
- **``tests/test_step_fn.py``'s first three**, on the port: a loop of
  steps gives ``run()``'s counts; overflow is visible in the solution; a
  step made after ``run()`` keeps its settled caps.
- The reduce and mask steps equal ``run_reduce`` and ``run_mask``; the
  step's argument checks.

Tolerance: none; ``rebuilt``, counts, sets, sums and bits are exact (the
steps and the engine's calls run the same plain versions on the same
structures).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reduce import (ACTIVE, R, SIZES, _port_engine, _split,
                               fixed_case_data, payload_columns, tfn_fixed)
from treensearch_tpu import TreeNSearch as JaxTreeNSearch
from treensearch_tpu.oracle import BruteforceNSearch
from treensearch_tpu_torch import NeighborSolution, TreeNSearch
from treensearch_tpu_torch.ops import fastpath as tfp
from treensearch_tpu_torch.ops.grid import GridState

N, RADIUS = 300, 0.14


def _sequence():
    """The step sequence: cold, same, moved by 1e-6, moved across cells,
    same again."""
    rng = np.random.default_rng(5)
    pts = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    moved = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    return [pts, pts, (pts + np.float32(1e-6)).astype(np.float32), moved,
            moved]


def _oracle_sets(pts, r=RADIUS, radii=None):
    orc = BruteforceNSearch(search_radius=None if radii is not None else r,
                            symmetric=radii is not None)
    orc.add_point_set(pts, radii)
    orc.set_all_searches(True)
    orc.run()
    return orc.neighbors[(0, 0)]


def _engine(pts, r=RADIUS, radii=None):
    eng = TreeNSearch(device="cpu")
    eng.add_point_set(pts, radii)
    if radii is None:
        eng.set_search_radius(r)
    eng.set_all_searches(True)
    return eng


def _sets(pair):
    counts = pair["counts"].numpy()
    nbrs = tfp.materialize_nbrs(pair).numpy()
    return counts, [np.sort(nbrs[i, :counts[i]]) for i in range(len(counts))]


def _assert_oracle(pair, want):
    counts, sets = _sets(pair)
    for i, s in enumerate(sets):
        assert np.array_equal(s, want[i]), i


@pytest.fixture(scope="module")
def jax_steps():
    """rebuilt and counts of the JAX reuse step over the sequence."""
    seq = _sequence()
    eng = JaxTreeNSearch()
    eng.add_point_set(seq[0])
    eng.set_search_radius(RADIUS)
    eng.set_all_searches(True)
    eng.set_use_pallas(True, interpret=True)
    # the interpreter runs every grid step in Python: small caps
    eng._fat_cap = 16
    eng._tiles_cap = 64
    eng._dense_cap = 1 << 14
    eng.set_window_cap(64)
    step, state = eng.make_step_fn(reuse=True)
    out = []
    for pts in seq:
        sol, state = step(state, jnp.asarray(pts))
        assert int(sol["tile_overflow"]) == 0 and int(sol["cand_max"]) == 0
        out.append((int(sol["rebuilt"]),
                    np.asarray(sol["pairs"]["0-0"]["counts"])))
    return out


def test_reuse_step_matches_jax_step_by_step(jax_steps):
    seq = _sequence()
    step, state = _engine(seq[0]).make_step_fn(reuse=True)
    got = []
    for pts, (j_rebuilt, j_counts) in zip(seq, jax_steps):
        sol, state = step(state, torch.from_numpy(pts))
        got.append(int(sol["rebuilt"]))
        assert sol["rebuilt"].dtype == torch.int32
        assert np.array_equal(sol["pairs"]["0-0"]["counts"].numpy(),
                              j_counts)
    assert got == [r for r, _ in jax_steps]
    assert got[:2] == [1, 0] and got[3:] == [1, 0]


def test_carry_reuse_and_rebuild_exact():
    seq = _sequence()
    step, state = _engine(seq[0]).make_step_fn(reuse=True)
    for k, pts in enumerate(seq):
        calls = tfp._prep.calls
        sol, state = step(state, torch.from_numpy(pts))
        # no prep at all on reuse; the records are the new points'
        assert tfp._prep.calls - calls == int(sol["rebuilt"]), k
        assert int(sol["tile_overflow"]) == 0
        _assert_oracle(sol["pairs"]["0-0"], _oracle_sets(pts))


def test_carry_in_cell_move_reuses_with_new_coordinates():
    pts = _sequence()[0]
    eng = _engine(pts)
    step, state = eng.make_step_fn(reuse=True)
    _, state = step(state, torch.from_numpy(pts))
    # moves that keep every point in its cell: the carry is reused and the
    # result is the moved points' (in-cell moves can change neighbors)
    grid = state[0]
    cell = float(grid.cell_size)
    rel = (pts - grid.grid_min.numpy()) / np.float32(cell)
    shift = np.where((rel % 1) < 0.5, 0.3, -0.3).astype(np.float32) \
        * np.float32(cell)
    moved = (pts + shift).astype(np.float32)
    sol, state = step(state, torch.from_numpy(moved))
    assert int(sol["rebuilt"]) == 0
    _assert_oracle(sol["pairs"]["0-0"], _oracle_sets(moved))
    assert not np.array_equal(_sets(sol["pairs"]["0-0"])[0],
                              [len(s) for s in _oracle_sets(pts)])


def test_carry_variable_radius_change_triggers_rebuild():
    rng = np.random.default_rng(9)
    pts = rng.uniform(0, 1, (250, 3)).astype(np.float32)
    rad = rng.uniform(0.08, 0.16, 250).astype(np.float32)
    step, state = _engine(pts, radii=rad).make_step_fn(reuse=True)
    p, r = torch.from_numpy(pts), torch.from_numpy(rad)
    sol, state = step(state, p, r)
    assert int(sol["rebuilt"]) == 1
    sol, state = step(state, p, r)
    assert int(sol["rebuilt"]) == 0
    # changed radii with unchanged cells rebuild: the windows' reach
    # depends on them
    rad2 = (rad * np.float32(0.9)).astype(np.float32)
    sol, state = step(state, p, torch.from_numpy(rad2))
    assert int(sol["rebuilt"]) == 1
    _assert_oracle(sol["pairs"]["0-0"], _oracle_sets(pts, radii=rad2))


def test_engine_run_uses_carry_and_stays_exact():
    rng = np.random.default_rng(21)
    pts = rng.uniform(0, 1, (400, 3)).astype(np.float32)
    jiggled = (pts + rng.uniform(-0.05, 0.05, pts.shape)).astype(np.float32)
    eng = _engine(pts, r=0.12)
    rebuilt = []
    # the second run rebuilds: the first one's snug resized the caps
    for step_pts in (pts, pts, pts, jiggled):
        eng.resize_point_set(0, step_pts)
        calls = tfp._prep.calls
        eng.run()
        rebuilt.append(eng._last_stats["rebuilt"])
        assert tfp._prep.calls - calls == rebuilt[-1]
        want = _oracle_sets(step_pts, 0.12)
        for i in range(0, 400, 7):
            assert np.array_equal(
                np.sort(eng.get_neighborlist(0, 0, i).to_numpy()), want[i])
    assert rebuilt == [1, 1, 0, 1]


def test_carry_invalidated_by_cap_change():
    pts = _sequence()[0]
    eng = _engine(pts)
    eng.run()
    eng.run()
    eng.run()
    assert eng._last_stats["rebuilt"] == 0
    key = eng._carry_key
    # a cap that shapes the carry (here the tile slots and the neighbor
    # cap) changes: the carry is rebuilt, not reused
    eng._tiles_cap += 64
    eng.run()
    assert eng._last_stats["rebuilt"] == 1 and eng._carry_key != key
    eng.set_neighbor_cap(2)          # and a regrow on top
    eng.run()
    assert eng._last_stats["rebuilt"] == 1 and eng._nbr_cap > 2
    counts = eng.get_counts(0, 0)
    want = _oracle_sets(pts)
    assert np.array_equal(counts, [len(s) for s in want])


def test_coherence_off_drops_the_carry_and_rebuilds():
    pts = _sequence()[0]
    eng = _engine(pts)
    eng.run()
    eng.run()
    assert eng._fast_carry is not None
    eng.set_coherence(False)
    assert eng._fast_carry is None
    for _ in range(2):
        calls = tfp._prep.calls
        eng.run()
        assert tfp._prep.calls == calls + 1
        assert eng._last_stats["rebuilt"] == 1 and eng._fast_carry is None
    eng.set_coherence(True)
    eng.run()
    eng.run()
    assert eng._last_stats["rebuilt"] == 0


# ---------------------------------------------------------- make_step_fn
@pytest.mark.parametrize("reuse", [False, True])
def test_step_fn_loop_matches_run(reuse):
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 1, (600, 3)).astype(np.float32)
    eng = _engine(pts, r=0.09)
    eng.run()
    want_counts, want_nbrs = (t.clone() for t in eng.get_neighbors(0, 0))
    step, state = eng.make_step_fn(reuse=reuse)
    assert isinstance(state, GridState) != reuse
    p = torch.from_numpy(pts)
    for _ in range(3):
        sol, state = step(state, p)
        solution = NeighborSolution(sol["pairs"])
        counts, nbrs = solution.get_neighbors_device(0, 0)
        assert torch.equal(counts, want_counts)
        assert torch.equal(nbrs, want_nbrs)


def test_step_fn_overflow_flags_visible():
    pts = np.random.default_rng(1).uniform(0, 1, (300, 3)) \
        .astype(np.float32)
    eng = _engine(pts, r=0.9)        # nearly all points are neighbors
    eng.set_neighbor_cap(16)         # deliberately too small
    step, state = eng.make_step_fn()
    sol, _ = step(state, torch.from_numpy(pts))
    pair = sol["pairs"]["0-0"]
    assert int(pair["max_count"]) > 16           # the caller can detect it
    assert tfp.materialize_nbrs(pair).shape == (300, 16)   # no regrow


def test_step_fn_carries_settled_caps():
    rng = np.random.default_rng(3)
    cluster = (np.asarray([0.18, 0.18, 0.5])
               + 0.004 * rng.standard_normal((320, 3)))
    sparse = rng.uniform(0, 1, (480, 3))
    sparse[:, :2] *= 0.36
    pts = np.concatenate([cluster, sparse]).astype(np.float32)
    eng = _engine(pts, r=0.06)
    eng.set_neighbor_cap(8)
    eng._tiles_cap = 8               # run() must regrow both
    eng.run()
    assert eng._nbr_cap > 8 and eng._tiles_cap > 8
    want = [np.sort(eng.get_neighborlist(0, 0, i).to_numpy())
            for i in range(pts.shape[0])]
    for reuse in (False, True):
        step, state = eng.make_step_fn(reuse=reuse)
        sol, _ = step(state, torch.from_numpy(pts))
        assert int(sol["tile_overflow"]) == 0
        _, sets = _sets(sol["pairs"]["0-0"])
        for i in range(pts.shape[0]):
            assert np.array_equal(sets[i], want[i]), i


def test_reduce_and_mask_steps_equal_run_reduce_and_run_mask():
    pts, per_set = fixed_case_data()
    eng = _port_engine(_split(pts, SIZES), r=R, active=ACTIVE)
    want = eng.run_reduce(tfn_fixed, 4, payload=per_set)
    mask, _ = eng.run_mask()
    p = torch.from_numpy(pts)
    payload = torch.from_numpy(payload_columns(per_set, SIZES))
    step, state = eng.make_step_fn(reduce=(tfn_fixed, 4))
    for rebuilt in (1, 0):
        sol, state = step(state, p, payload=payload)
        assert int(sol["rebuilt"]) == rebuilt
        for si in range(3):
            assert torch.equal(sol["reduce"][f"s{si}"].t(), want[si])
    step, state = eng.make_step_fn(mask_output=True)
    for rebuilt in (1, 0):
        sol, state = step(state, p)
        assert int(sol["rebuilt"]) == rebuilt
        for k in ("cand_base", "counts_flat", "qpos"):
            assert torch.equal(sol["mask"][k], mask[k]), k
        # the step's bits have its static row cap: the live rows are
        # run_mask's, and none was dropped
        rows = int(mask["cand_base"][-1])
        assert sol["mask"]["bits"].shape[0] >= rows
        assert torch.equal(sol["mask"]["bits"][:rows], mask["bits"])
        assert int(sol["mask_overflow"]) == 0
        assert int(sol["mask_rows"]) == rows


BAD_STEP_ARGS = {
    "numpy_points": lambda p, r: (p.numpy(), None),
    "other_device": lambda p, r: (p.to("meta"), None),
    "wrong_shape": lambda p, r: (p[:-1], None),
    "float64": lambda p, r: (p.double(), None),
    "radii_at_a_fixed_radius": lambda p, r: (p, torch.ones(p.shape[0])),
}


@pytest.mark.parametrize("bad", list(BAD_STEP_ARGS))
@pytest.mark.parametrize("reuse", [False, True])
def test_step_rejects_bad_arguments(bad, reuse):
    pts = _sequence()[0]
    step, state = _engine(pts).make_step_fn(reuse=reuse)
    points, radii = BAD_STEP_ARGS[bad](torch.from_numpy(pts), None)
    with pytest.raises(ValueError):
        step(state, points, radii)


def test_variable_step_needs_radii_and_fast_false_is_not_ported():
    rng = np.random.default_rng(9)
    pts = rng.uniform(0, 1, (50, 3)).astype(np.float32)
    eng = _engine(pts, radii=rng.uniform(0.1, 0.2, 50).astype(np.float32))
    step, state = eng.make_step_fn(reuse=True)
    with pytest.raises(ValueError, match="radii"):
        step(state, torch.from_numpy(pts))
    # make_step_fn(fast=False), once not ported, is the search-based
    # pipeline's step: it needs the radii too, and with them it gives
    # run_scalar's lists
    pstep, pstate = eng.make_step_fn(fast=False)
    with pytest.raises(ValueError, match="radii"):
        pstep(pstate, torch.from_numpy(pts))
    sol, _ = pstep(pstate, torch.from_numpy(pts),
                   torch.from_numpy(np.asarray(eng._sets[0].radii)))
    eng.run_scalar()
    counts, nbrs = eng.get_neighbors(0, 0)
    assert torch.equal(sol["pairs"]["0-0"]["counts"], counts)
    assert torch.equal(sol["pairs"]["0-0"]["nbrs"], nbrs)


def test_carried_step_of_no_points_raises():
    eng = TreeNSearch(device="cpu")
    eng.add_point_set(np.zeros((0, 3), np.float32))
    eng.set_search_radius(0.1)
    eng.set_all_searches(True)
    step, state = eng.make_step_fn()
    sol, _ = step(state, torch.zeros((0, 3)))
    assert sol["pairs"]["0-0"]["counts"].numel() == 0
    with pytest.raises(ValueError, match="at least one point"):
        eng.make_step_fn(reuse=True)
