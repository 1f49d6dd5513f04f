"""The port's search-based pipeline (``run_scalar``, ``make_step_fn(fast=
False)`` and ``run()``'s sparse-domain fallback) held against the JAX
pipeline and the numpy oracle.

- ``cell_keys``, ``key_hi``, ``searchsorted_2word``, ``sort_by_2word_key``
  and ``compact_rows``: bit-equal to the JAX functions.
- ``sorted_structure``: every field bit-equal, from the same grid state
  (the JAX one, carried across with ``interop``).
- ``build_and_search``: counts, rows (slot for slot: both front-pack in
  sorted-slot order), ``max_count``, ``cand_max`` and ``n_cells`` equal to
  the JAX ``build_and_search_jit`` on ``test_correctness.py``'s fixed,
  multi-set, variable and symmetric shapes, a cut candidate cap and a
  stencil of 4 cells.  The data keeps every pair off the radius (a lattice,
  or random radii), so XLA's FMA contraction on the CPU cannot flip one.
- ``run_scalar``: neighbor sets equal to the oracle's, exactly.
- float64 d^2: a pair that float32 and float64 decide differently, found
  with numpy's float32 (eager PyTorch's rounding), decided as a float64
  predicate decides it; float32 mode as float32 does.
- ``make_step_fn(fast=False)``: each step equal to the JAX step's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import grid_for_n
from treensearch_tpu import TreeNSearch as JaxTreeNSearch
from treensearch_tpu.config import SearchConfig as JaxConfig
from treensearch_tpu.ops import grid as jgrid
from treensearch_tpu.ops import pipeline as jpl
from treensearch_tpu.oracle import BruteforceNSearch
from treensearch_tpu.utils import compact as jcompact
from treensearch_tpu.utils import keys as jkeys
from treensearch_tpu_torch import TreeNSearch, interop
from treensearch_tpu_torch.config import SearchConfig
from treensearch_tpu_torch.ops import fastpath as tfp
from treensearch_tpu_torch.ops import pipeline as tpl
from treensearch_tpu_torch.utils import compact as tcompact
from treensearch_tpu_torch.utils import keys as tkeys


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------- keys
def test_cell_keys_and_key_hi_bit_equal():
    ijk = np.random.default_rng(0).integers(0, 1 << 15, (500, 3)) \
        .astype(np.int32)
    jh, jl = jkeys.cell_keys(jnp.asarray(ijk))
    th, tl = tkeys.cell_keys(_t(ijk))
    assert np.array_equal(th.numpy(), np.asarray(jh))
    assert np.array_equal(tl.numpy(), np.asarray(jl))
    assert np.array_equal(tkeys.key_hi(_t(ijk[:, 0]), _t(ijk[:, 1])).numpy(),
                          np.asarray(jkeys.key_hi(ijk[:, 0], ijk[:, 1])))


@pytest.mark.parametrize("m", [0, 1, 1000])
def test_searchsorted_2word_bit_equal(m):
    rng = np.random.default_rng(m)
    # sorted words with runs of equal keys; queries below, inside, between
    # and past them, negative words included
    comb = np.sort(rng.integers(0, 50, m) * 1000 + rng.integers(0, 100, m))
    hi, lo = (comb // 1000).astype(np.int32), (comb % 1000).astype(np.int32)
    q_hi = rng.integers(-5, 55, (30, 7)).astype(np.int32)
    q_lo = rng.integers(-5, 105, (30, 7)).astype(np.int32)
    for side in ("left", "right"):
        want = np.asarray(jkeys.searchsorted_2word(
            jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(q_hi),
            jnp.asarray(q_lo), side))
        got = tkeys.searchsorted_2word(_t(hi), _t(lo), _t(q_hi), _t(q_lo),
                                       side)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(),
                                                           want), side


def test_sort_by_2word_key_is_the_stable_lax_sort():
    rng = np.random.default_rng(3)
    hi = rng.integers(-3, 4, 2000).astype(np.int32)   # many ties
    lo = rng.integers(-2, 3, 2000).astype(np.int32)
    pay = np.arange(2000, dtype=np.int32)
    want = jkeys.sort_by_2word_key(jnp.asarray(hi), jnp.asarray(lo),
                                   jnp.asarray(pay))
    got = tkeys.sort_by_2word_key(_t(hi), _t(lo), _t(pay))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("out_w", [1, 16, 40, 64])
def test_compact_rows_bit_equal(out_w):
    rng = np.random.default_rng(out_w)
    mask = rng.uniform(size=(64, 40)) < 0.3
    mask[3] = True
    mask[4] = False
    vals = rng.integers(-1000, 1000, (64, 40)).astype(np.int32)
    want = np.asarray(jcompact.compact_rows(jnp.asarray(mask),
                                            jnp.asarray(vals), out_w))
    got = tcompact.compact_rows(_t(mask), _t(vals), out_w)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


# ------------------------------------------------------------ the data
def _fixed():
    pts, r = grid_for_n(1000)
    return [(pts, None)], float(r), ((0, 0),), False, float(r)


def _multi_set():
    rng = np.random.default_rng(42)
    pts0, r = grid_for_n(800)
    pts1 = pts0 + rng.uniform(-0.02, 0.02, pts0.shape).astype(np.float32)
    return ([(pts0, None), (pts1, None)], float(r),
            ((0, 0), (0, 1), (1, 0)), False, float(r))


def _variable_symmetric():
    # test_correctness.py test_two_dynamic_sets_variable_radius
    rng = np.random.default_rng(42)
    pts0, r = grid_for_n(800)
    pts1 = pts0 + rng.uniform(-0.02, 0.02, pts0.shape).astype(np.float32)
    rad0 = rng.uniform(0.8 * r, 1.2 * r, pts0.shape[0]).astype(np.float32)
    rad1 = rng.uniform(0.8 * r, 1.2 * r, pts1.shape[0]).astype(np.float32)
    return ([(pts0, rad0), (pts1, rad1)], 0.0,
            ((0, 0), (0, 1), (1, 0)), True, float(1.5 * rad0.min()))


def _variable_asymmetric():
    # test_correctness.py test_variable_radius_asymmetric_no_symmetric_search
    rng = np.random.default_rng(7)
    pts, r = grid_for_n(1000)
    rad = rng.uniform(0.5 * r, 1.5 * r, pts.shape[0]).astype(np.float32)
    return [(pts, rad)], 0.0, ((0, 0),), False, float(1.5 * rad.min())


def _wide_stencil():
    # radii in [0.02, 0.1] at a cell of 0.03: W = 4, 81 ranges per query
    rng = np.random.default_rng(9)
    pts = rng.uniform(0, 1, (2000, 3)).astype(np.float32)
    rad = rng.uniform(0.02, 0.1, 2000).astype(np.float32)
    return [(pts, rad)], 0.0, ((0, 0),), True, 0.03


# name: (data, nbr_cap, cand_cap); data gives (sets, radius, active
# pairs, symmetric, cell)
CASES = {
    "fixed": (_fixed, 64, 512),
    "multi_set": (_multi_set, 64, 512),
    "variable_symmetric": (_variable_symmetric, 48, 512),
    "variable_asymmetric": (_variable_asymmetric, 48, 512),
    "cand_cap_cut": (_fixed, 16, 96),
    "wide_stencil": (_wide_stencil, 48, 512),
}

_bas_jit = jpl.build_and_search_jit
_ss_jit = jax.jit(jpl.sorted_structure, static_argnames=("cfg",))


def _stencil(cell, r_max):
    c, r = np.float32(cell), np.float32(r_max)
    w = int(np.floor(r * (np.float32(1.0) / c)))
    return max(1, w if np.float32(w) * c >= r else w + 1)


@functools.lru_cache(maxsize=None)
def _case(name):
    make, cap, cand_cap = CASES[name]
    sets, sr, pairs, symmetric, cell = make()
    pts = np.concatenate([p for p, _ in sets]).astype(np.float32)
    variable = sets[0][1] is not None
    radii = np.concatenate([r for _, r in sets]) if variable else None
    sizes = tuple(p.shape[0] for p, _ in sets)
    w = _stencil(cell, radii.max() if variable else sr)
    jcfg = JaxConfig(sizes, pairs, variable, symmetric and variable, w, 128,
                     cand_cap, cap)
    tcfg = SearchConfig(sizes, pairs, w, cap, variable,
                        symmetric and variable, chunk=128, cand_cap=cand_cap)
    jstate = jax.jit(jgrid.update_grid)(jgrid.fresh_state(),
                                        jnp.asarray(pts), jnp.float32(cell))
    jr = None if radii is None else jnp.asarray(radii)
    jsol, _ = _bas_jit(jnp.asarray(pts), jr, jnp.float32(sr),
                       jnp.float32(cell), jstate, jcfg)
    jss = _ss_jit(jnp.asarray(pts), jr, jnp.float32(sr), jstate, cfg=jcfg)
    tstate = interop.grid_state_from_numpy(jstate)
    tr = None if radii is None else _t(radii)
    consts = tfp.step_constants(tcfg, tfp.FastKnobs(), cell, "cpu",
                                search_radius=sr)
    tss = tpl.sorted_structure(_t(pts), tr, tstate, tcfg, consts)
    tsol, _ = tpl.build_and_search(_t(pts), tr, tstate, tcfg, consts=consts)
    return (jax.tree_util.tree_map(np.asarray, jsol), tsol,
            {k: None if v is None else np.asarray(v)
             for k, v in jss._asdict().items()}, tss, w)


@pytest.mark.parametrize("case", ["fixed", "variable_symmetric",
                                  "wide_stencil"])
def test_sorted_structure_bit_equal(case):
    _, _, jss, tss, _ = _case(case)
    for k, v in jss.items():
        got = getattr(tss, k)
        if v is None:
            assert got is None, k
            continue
        got = got.numpy()
        assert got.dtype == v.dtype and got.shape == v.shape, k
        assert np.array_equal(got, v), k
    assert interop.sorted_structure_from_numpy(jss).key_s.equal(tss.key_s)


@pytest.mark.parametrize("case", list(CASES))
def test_build_and_search_equals_jax_slot_for_slot(case):
    jsol, tsol, _, _, w = _case(case)
    assert w == (4 if case == "wide_stencil" else w)
    for k in ("cand_max", "n_cells", "error"):
        assert int(tsol[k]) == int(jsol[k]), k
    assert set(tsol["pairs"]) == set(jsol["pairs"])
    for name, jp in jsol["pairs"].items():
        tp = tsol["pairs"][name]
        for k in ("counts", "nbrs", "max_count"):
            got = tp[k].numpy()
            assert got.dtype == jp[k].dtype and got.shape == jp[k].shape, \
                (name, k)
            assert np.array_equal(got, jp[k]), (name, k)
    if case == "cand_cap_cut":
        assert int(tsol["cand_max"]) > CASES[case][2]
    if case == "wide_stencil":
        assert int(tsol["cand_max"]) > 0


# ------------------------------------------------------------ the engine
def _engine_and_oracle(sets, r=None, active=None, symmetric=True):
    eng = TreeNSearch(device="cpu")
    orc = BruteforceNSearch(search_radius=r, symmetric=symmetric)
    for p, rad in sets:
        eng.add_point_set(p, rad)
        orc.add_point_set(p, rad)
    if r is not None:
        eng.set_search_radius(r)
    eng.set_symmetric_search(symmetric)
    for i, j in active or [(i, j) for i in range(len(sets))
                           for j in range(len(sets))]:
        eng.set_active_search(i, j, True)
        orc.set_active_search(i, j, True)
    orc.run()
    return eng, orc


def test_run_scalar_variable_two_sets_matches_oracle():
    # a small candidate cap and neighbor cap: both regrow
    sets, _, _, _, _ = _variable_symmetric()
    eng, orc = _engine_and_oracle(sets, active=[(0, 0), (0, 1), (1, 0)])
    eng.set_candidate_cap(32)
    eng.set_neighbor_cap(8)
    eng.run_scalar()
    assert eng._cand_cap > 32 and eng._nbr_cap > 8
    assert eng._last_stats["path"] == "reference"
    orc.compare(eng)


def test_run_scalar_wide_stencil_matches_oracle():
    sets, _, _, _, _ = _wide_stencil()
    eng, orc = _engine_and_oracle(sets, symmetric=True)
    eng.run_scalar()
    assert eng._last_stats["stencil_w"] >= 4   # cell 1.5 r_min ~ 0.03
    orc.compare(eng)


def test_run_scalar_nine_fixed_sets_matches_oracle():
    rng = np.random.default_rng(11)
    sets = [(rng.uniform(0, 1, (120, 3)).astype(np.float32), None)
            for _ in range(9)]
    eng, orc = _engine_and_oracle(sets, r=0.15,
                                  active=[(0, j) for j in range(9)]
                                  + [(4, 4), (8, 0)])
    eng.set_chunk_size(8)
    eng.run_scalar()
    orc.compare(eng)


def _boundary_pair(r, want_f32):
    """Two points whose float32 d^2 and float64 d^2 sit on opposite sides
    of float32 r^2: p1 - p0 is exact in float32, so both precisions see
    the same offset (``tests/test_scalar_f64.py``'s construction, with
    numpy's float32 as the float32 predicate)."""
    r2 = np.float32(r) * np.float32(r)
    p0 = np.float32(0.25)
    rng = np.random.default_rng(42)
    for _ in range(200):
        d = rng.normal(size=(100_000, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        scale = np.float64(r) * (1 + rng.uniform(-6e-8, 6e-8, (d.shape[0], 1)))
        off = (p0 + (d * scale).astype(np.float32)).astype(np.float32) - p0
        x, y, z = off[:, 0], off[:, 1], off[:, 2]
        in32 = (x * x + y * y) + z * z <= r2
        o = off.astype(np.float64)
        in64 = (o[:, 0] * o[:, 0] + o[:, 1] * o[:, 1]) + o[:, 2] * o[:, 2] \
            <= np.float64(r2)
        pick = np.nonzero((in32 != in64) & (in32 == want_f32))[0]
        if pick.size:
            return off[pick[0]]
    raise AssertionError("no float32/float64 disagreement found")


@pytest.mark.parametrize("in_f32", [True, False])
def test_scalar_double_accum_decides_as_float64(in_f32):
    r = 0.1
    off = _boundary_pair(r, in_f32)
    p0 = np.full(3, 0.25, np.float32)
    backdrop = np.random.default_rng(5).uniform(0.5, 0.9, (30, 3))
    pts = np.concatenate([[p0, p0 + off], backdrop]).astype(np.float32)
    assert np.array_equal(pts[1] - pts[0], off)
    for f64, want in ((False, in_f32), (True, not in_f32)):
        eng = TreeNSearch(device="cpu")
        eng.add_point_set(pts)
        eng.set_search_radius(r)
        eng.set_all_searches(True)
        eng.set_scalar_double_accum(f64)
        eng.run_scalar()
        assert (1 in eng.get_neighborlist(0, 0, 0).to_numpy()) == want, f64
        assert eng._make_cfg(1).scalar_f64 == f64


def test_pipeline_step_equals_the_jax_step():
    rng = np.random.default_rng(13)
    pts = rng.uniform(0, 1, (1500, 3)).astype(np.float32)
    engines = []
    for cls in (JaxTreeNSearch, lambda: TreeNSearch(device="cpu")):
        e = cls()
        e.add_point_set(pts)
        e.set_search_radius(0.08)
        e.set_all_searches(True)
        e.set_neighbor_cap(48)
        engines.append(e)
    (jstep, jstate), (tstep, tstate) = (
        e.make_step_fn(chunk=128, fast=False) for e in engines)
    cur = pts
    for k in range(3):
        jsol, jstate = jstep(jstate, jnp.asarray(cur))
        tsol, tstate = tstep(tstate, _t(cur))
        assert int(tsol["cand_max"]) == int(jsol["cand_max"]), k
        jp, tp = jsol["pairs"]["0-0"], tsol["pairs"]["0-0"]
        for f in ("counts", "nbrs", "max_count"):
            assert np.array_equal(tp[f].numpy(), np.asarray(jp[f])), (k, f)
        assert np.array_equal(tstate.grid_min.numpy(),
                              np.asarray(jstate.grid_min)), k
        cur = (cur + rng.uniform(-0.01, 0.01, cur.shape)).astype(np.float32)
