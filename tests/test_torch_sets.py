"""``TreeNSearch(device="cpu")`` of the port on several point sets and
with per-point radii, against the numpy oracle (``BruteforceNSearch``) and
the JAX ``TreeNSearch`` (its XLA tile path on the CPU), on the multi-set
and variable-radius rows of ``test_correctness.py``, the reference's
fluid + boundary layout and 60 iterations of ``test_edge_cases.py``'s
emitter churn.

Tolerance: against the oracle, neighbor sets are exact (both round d^2
and r^2 the same way in float32).  Against JAX, sets are exact except for
a pair whose float64 d^2 lies within 4 ulp of a float32 bound it is tested
against (r_i^2, or r_j^2 in symmetric mode), because XLA on the CPU may
contract to FMA where eager PyTorch does not; such pairs are reported.
"""

import gc
import warnings
import weakref

import numpy as np
import pytest
import torch

from helpers import grid_for_n
from treensearch_tpu import TreeNSearch as JaxTreeNSearch
from treensearch_tpu.oracle import BruteforceNSearch
from treensearch_tpu_torch import TreeNSearch
from treensearch_tpu_torch.ops import fastpath as tfp


def _setup(eng, sets, r, active, symmetric):
    for pts, rad in sets:
        eng.add_point_set(pts, rad)
    if r is not None:
        eng.set_search_radius(r)
    if not isinstance(eng, BruteforceNSearch):   # the oracle's is fixed
        eng.set_symmetric_search(symmetric)
    if active is None:
        eng.set_all_searches(True)
    else:
        for (i, j, a) in active:
            eng.set_active_search(i, j, a)
    return eng


def _port(sets, r=None, active=None, symmetric=True, run=True):
    eng = _setup(TreeNSearch(device="cpu"), sets, r, active, symmetric)
    if run:
        eng.run()
    return eng


def _oracle(sets, r=None, active=None, symmetric=True):
    orc = _setup(BruteforceNSearch(search_radius=r, symmetric=symmetric),
                 [(np.asarray(p, np.float32), None if q is None
                   else np.asarray(q, np.float32)) for p, q in sets],
                 None, active, symmetric)
    orc.run()
    return orc


def _vs_oracle(sets, r=None, active=None, symmetric=True):
    eng = _port(sets, r, active, symmetric)
    _oracle(sets, r, active, symmetric).compare(eng)
    return eng


def _vs_jax(eng, sets, r=None, active=None, symmetric=True):
    """Port against the JAX engine on every active pair; returns the
    boundary pairs in which they differ (any other difference fails)."""
    jeng = _setup(JaxTreeNSearch(), sets, r, active, symmetric)
    jeng.run()
    pts = [np.asarray(p, np.float64).reshape(-1, 3) for p, _ in sets]
    rad = [np.full(p.shape[0], r, np.float32) if q is None
           else np.asarray(q, np.float32) for p, q in zip(pts, [s[1]
                                                           for s in sets])]
    boundary = []
    for si, sj in zip(*np.nonzero(eng._active)):
        si, sj = int(si), int(sj)
        pc, pn = (t.numpy() for t in eng.get_neighbors(si, sj))
        jc, jn = (np.asarray(a) for a in jeng.get_neighbors(si, sj))
        for i in range(pts[si].shape[0]):
            a = set(pn[i, :pc[i]].tolist())
            b = set(jn[i, :jc[i]].tolist())
            for j in sorted(a ^ b):
                d2 = float(np.sum((pts[sj][j] - pts[si][i]) ** 2))
                bounds = [rad[si][i] * rad[si][i]]
                if symmetric and sets[0][1] is not None:
                    bounds.append(rad[sj][j] * rad[sj][j])
                assert any(abs(d2 - float(b2)) <= 4 * float(np.spacing(b2))
                           for b2 in bounds), (si, sj, i, j, d2, bounds)
                boundary.append((si, sj, i, j))
    if boundary:
        warnings.warn(f"{len(boundary)} pairs at a radius boundary differ "
                      f"between XLA and PyTorch rounding: {boundary[:8]}")
    return boundary


def _two_variable_sets(n):
    # reference tests.cpp:114-145 (test_correctness.py)
    rng = np.random.default_rng(42)
    pts0, r = grid_for_n(n)
    pts1 = pts0 + rng.uniform(-0.02, 0.02, pts0.shape).astype(np.float32)
    rad0 = rng.uniform(0.8 * r, 1.2 * r, pts0.shape[0]).astype(np.float32)
    rad1 = rng.uniform(0.8 * r, 1.2 * r, pts1.shape[0]).astype(np.float32)
    active = [(0, 0, True), (0, 1, True), (1, 0, True), (1, 1, False)]
    return [(pts0, rad0), (pts1, rad1)], active


@pytest.mark.parametrize("n", [1, 100, 4000])
def test_two_dynamic_sets_variable_radius(n):
    sets, active = _two_variable_sets(n)
    eng = _vs_oracle(sets, active=active, symmetric=True)
    assert eng.get_n_sets() == 2 and not eng.is_search_active(1, 1)


def test_two_dynamic_sets_variable_radius_vs_jax():
    sets, active = _two_variable_sets(1000)
    _vs_jax(_port(sets, active=active), sets, active=active)


@pytest.mark.parametrize("n", [1, 100, 4000])
def test_variable_radius_asymmetric_no_symmetric_search(n):
    rng = np.random.default_rng(7)
    pts, r = grid_for_n(n)
    rad = rng.uniform(0.5 * r, 1.5 * r, pts.shape[0]).astype(np.float32)
    eng = _vs_oracle([(pts, rad)], symmetric=False)
    if n > 1:
        # the asymmetric rule really is asymmetric here
        c = eng.get_counts(0, 0)
        sym = _port([(pts, rad)], symmetric=True).get_counts(0, 0)
        assert (sym >= c).all() and (sym > c).any()


@pytest.mark.parametrize("n", [1, 100, 1800])
def test_mixed_float_double_point_sets(n):
    # reference tests.cpp:147-186
    pts, r = grid_for_n(n)
    pts64 = pts.astype(np.float64) + 1e-9
    _vs_oracle([(pts, None), (pts64, None)], r=float(r))


def test_resize_variable_radius():
    # reference tests.cpp:188-237: grow x2 and shrink to a third
    rng = np.random.default_rng(3)
    pts, r = grid_for_n(1000)
    rad = rng.uniform(0.9 * r, 1.1 * r, pts.shape[0]).astype(np.float32)
    eng = _vs_oracle([(pts, rad)])
    pts2 = np.concatenate([pts, pts + np.float32(0.05)], axis=0)
    rad2 = np.concatenate([rad, rad])
    for p, q in ((pts2, rad2), (pts2[:pts2.shape[0] // 3],
                                rad2[:pts2.shape[0] // 3])):
        eng.resize_point_set(0, p, q)
        eng.run()
        _oracle([(p, q)]).compare(eng)
    with pytest.raises(ValueError, match="radius mode"):
        eng.resize_point_set(0, pts)


def _fluid_and_boundary():
    rng = np.random.default_rng(11)
    fluid = rng.uniform(0.02, 0.98, (1500, 3)).astype(np.float32)
    g = np.linspace(0, 1, 24, dtype=np.float32)
    floor = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    wall = np.concatenate([
        np.c_[floor, np.zeros(len(floor), np.float32)],
        np.c_[np.zeros(len(floor), np.float32), floor]]).astype(np.float32)
    # fluid searches fluid and boundary; the boundary searches nothing
    active = [(0, 0, True), (0, 1, True)]
    return [(fluid, None), (wall, None)], active


def test_fluid_and_boundary_asymmetric_matrix():
    sets, active = _fluid_and_boundary()
    eng = _vs_oracle(sets, r=0.1, active=active)
    assert eng.get_counts(0, 1).sum() > 0
    with pytest.raises(KeyError, match="not active"):
        eng.get_neighborlist(1, 0, 0)
    assert _vs_jax(eng, sets, r=0.1, active=active) == []


def test_active_search_overloads_over_three_sets():
    rng = np.random.default_rng(12)
    sets = [(rng.uniform(0, 1, (m, 3)).astype(np.float32), None)
            for m in (300, 200, 100)]
    eng = _port(sets, r=0.15, active=[], run=False)
    jeng = _setup(JaxTreeNSearch(), sets, 0.15, [], True)
    for e in (eng, jeng):
        e.set_active_search(0, True, False)   # set 0 searches all, found by
        e.set_active_search(2, False, True)   # none; set 2 the opposite
        e.set_active_search(1, 1, True)
    assert np.array_equal(eng._active, jeng._active)
    assert eng.is_search_active(0, 2) and not eng.is_search_active(2, 0)
    eng.run()
    orc = _oracle(sets, r=0.15, active=[])
    orc.active = eng._active.copy()
    orc.run()
    orc.compare(eng)


def test_per_set_neighbor_cap_regrows_only_its_own_block():
    sets, active = _fluid_and_boundary()
    eng = _port(sets, r=0.1, active=active, run=False)
    eng.set_neighbor_cap(8, 1)
    eng.run()
    # the boundary block grew on its own; the fluid block kept the cap
    assert eng._nbr_caps[1] > 8 and eng._nbr_cap == 80
    assert eng.get_neighbors(0, 1)[1].shape[1] == eng._nbr_caps[1]
    assert eng.get_neighbors(0, 0)[1].shape[1] == 80
    _oracle(sets, r=0.1, active=active).compare(eng)


def test_a_set_of_size_zero():
    rng = np.random.default_rng(13)
    pts = rng.uniform(0, 1, (400, 3)).astype(np.float32)
    empty = np.zeros((0, 3), np.float32)
    for sets in ([(pts, None), (empty, None)], [(empty, None), (pts, None)]):
        eng = _vs_oracle(sets, r=0.12)
        k = 0 if sets[0][0].shape[0] == 0 else 1
        assert eng.get_counts(k, k).shape == (0,)
        assert eng.get_neighbors(k, 1 - k)[1].shape[0] == 0
        assert (eng.get_counts(1 - k, k) == 0).all()
    rad = rng.uniform(0.05, 0.1, 400).astype(np.float32)
    _vs_oracle([(pts, rad), (empty, np.zeros(0, np.float32))])


def test_pairs_that_share_a_block_materialise_in_either_order():
    # two query sets search one candidate set: one output block, two
    # slices of qpos; the rows stay until the last pair has materialised
    rng = np.random.default_rng(14)
    sets = [(rng.uniform(0, 1, (m, 3)).astype(np.float32), None)
            for m in (500, 300)]
    active = [(0, 1, True), (1, 1, True)]
    orc = _oracle(sets, r=0.12, active=active)
    for order in (((0, 1), (1, 1)), ((1, 1), (0, 1))):
        eng = _port(sets, r=0.12, active=active)
        pairs = eng._solution._dev
        first, second = (pairs[f"{i}-{j}"] for i, j in order)
        assert first["nbrs_tiles"] is second["nbrs_tiles"]
        rows = weakref.ref(first["nbrs_tiles"])
        tfp.materialize_nbrs(first)
        assert rows() is not None and "nbrs_tiles" in second
        tfp.materialize_nbrs(second)
        gc.collect()
        assert rows() is None   # released with the last pair's view
        orc.compare(eng)


def test_variable_mode_errors():
    rng = np.random.default_rng(15)
    pts = rng.uniform(0, 1, (20, 3)).astype(np.float32)
    eng = TreeNSearch(device="cpu")
    eng.add_point_set(pts, np.full(20, 0.1, np.float32))
    with pytest.raises(ValueError, match="fixed-radius"):
        eng.set_search_radius(0.1)
    with pytest.raises(ValueError, match="mix"):
        eng.add_point_set(pts)
    with pytest.raises(ValueError, match="radii"):
        eng.add_point_set(pts, np.ones(19))
    eng.resize_point_set(0, pts, -np.ones(20, np.float32))
    eng.set_all_searches(True)
    with pytest.raises(RuntimeError, match="negative radii"):
        eng.run()


def test_radii_as_torch_tensors():
    rng = np.random.default_rng(16)
    pts = rng.uniform(0, 1, (600, 3)).astype(np.float32)
    rad = rng.uniform(0.05, 0.1, 600).astype(np.float32)
    eng = _port([(torch.from_numpy(pts), torch.from_numpy(rad).double())])
    _oracle([(pts, rad)]).compare(eng)
    assert eng._last_stats["cell_size"] == pytest.approx(1.5 * rad.min())
    assert eng._last_stats["stencil_w"] == 2


def test_dynamic_emitter_churn():
    # tests/test_edge_cases.py::test_dynamic_emitter_churn (reference
    # dynamic_emitter_stress_test, tests.cpp:434-514), 60 of its 200
    # iterations: both sets resized through its size schedule with fresh
    # points every iteration, each run() against the oracle
    rng = np.random.default_rng(11)
    sizes0 = (40, 45, 39, 45, 40, 1, 40, 128)
    sizes1 = (30, 30, 7, 30, 30, 30, 0, 30)
    eng = TreeNSearch(device="cpu")
    eng.add_point_set(np.zeros((sizes0[0], 3), np.float32))
    eng.add_point_set(np.zeros((sizes1[0], 3), np.float32))
    eng.set_search_radius(0.25)
    eng.set_all_searches(True)
    for it in range(60):
        p0 = rng.uniform(0, 1, (sizes0[it % 8], 3)).astype(np.float32)
        p1 = rng.uniform(0, 1, (sizes1[(it // 2) % 8], 3)).astype(
            np.float32)
        eng.resize_point_set(0, p0)
        eng.resize_point_set(1, p1)
        eng.run()
        orc = BruteforceNSearch(search_radius=0.25)
        orc.add_point_set(p0)
        orc.add_point_set(p1)
        orc.set_all_searches(True)
        orc.run()
        orc.compare(eng)
