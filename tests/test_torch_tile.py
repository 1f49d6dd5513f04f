"""The port's tile path (``run()`` with more than 8 candidate sets or
``set_use_pallas(False)``) and its record kernel K1r, held against the
JAX package.

- The padded-layout ``_prep``: every field bit-equal to the JAX
  ``_pallas_prep`` with ``use_pallas=False, pack=1, rec_expand=False``
  (window starts in padded-slot space), from the same grid state; the
  descriptor's FAT_COL is compared for dead tiles only (the port has no
  fat tier).
- ``expand_records_plain`` (K1r's plain version): bit-equal to the Pallas
  ``make_expand_call(build_rec=True)`` in interpret mode at pack 16 (its
  ``rec_pad`` reshaped to (-1, 8)) on every tile the Pallas kernel writes,
  and to the gather build ``_build_records`` through the JAX ``opad`` on
  every padded slot; its ``q_t`` is K1's.
- ``run()`` on the tile path: counts and rows equal to the JAX ``run()``
  on the CPU (which is the JAX tile path) slot for slot, for 9 and 10
  candidate sets and for ``set_use_pallas(False)``; the data is random,
  so no pair sits at the radius where XLA's FMA contraction could flip
  it.
- A dense overflow at ``_MAX_DENSE_CAP`` (monkeypatched small) moves
  ``run()`` to the pipeline, exactly as the oracle.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from treensearch_tpu import TreeNSearch as JaxTreeNSearch
from treensearch_tpu.config import SearchConfig as JaxConfig
from treensearch_tpu.ops import fastpath as jfp
from treensearch_tpu.ops import grid as jgrid
from treensearch_tpu.ops import pallas_pairs as jpp
from treensearch_tpu.oracle import BruteforceNSearch
from treensearch_tpu_torch import TreeNSearch, interop
from treensearch_tpu_torch import api as tapi
from treensearch_tpu_torch.config import SearchConfig
from treensearch_tpu_torch.ops import fastpath as tfp
from treensearch_tpu_torch.ops import pairs as tpp

_prep_jit = jax.jit(jfp._pallas_prep, static_argnames=("cfg", "knobs"))

FIELDS = ("lin_s", "lin_chk", "r_chk", "idx_s", "inv_perm", "pp", "qpos",
          "dense_overflow", "tile_overflow", "rows_overflow", "win_max",
          "n_cells_stat")
PACK = 16


def _uniform():
    # rows of ~200 points: two tiles each, the second partial
    rng = np.random.default_rng(3)
    return [(rng.uniform(0, 1, (2000, 3)), None)], 0.1


def _slab():
    # rows hold a handful of points: every tile is partial
    rng = np.random.default_rng(4)
    pts = np.stack([rng.uniform(0, 1, 800), rng.uniform(0, 1, 800),
                    rng.uniform(0, 0.02, 800)], 1)
    return [(pts, None)], 0.1


def _variable_sets():
    rng = np.random.default_rng(5)
    return [(rng.uniform(0, 1, (1000, 3)),
             rng.uniform(0.05, 0.15, 1000)),
            (rng.uniform(0, 1, (300, 3)),
             rng.uniform(0.05, 0.1, 300))], 0.1


# name: (data, tiles_cap); data gives ([(points, radii or None)], cell)
CASES = {"uniform": (_uniform, 256), "slab": (_slab, 128),
         "variable_sets": (_variable_sets, 160)}


def _stencil(cell, r_max):
    c, r = np.float32(cell), np.float32(r_max)
    w = int(np.floor(r * (np.float32(1.0) / c)))
    return max(1, w if np.float32(w) * c >= r else w + 1)


@functools.lru_cache(maxsize=None)
def _both(case):
    """The JAX padded-layout prep and the port's, from one grid state, and
    the inputs K1r needs."""
    make, tiles_cap = CASES[case]
    sets, cell = make()
    pts = np.concatenate([p for p, _ in sets]).astype(np.float32)
    variable = sets[0][1] is not None
    radii = np.concatenate([r for _, r in sets]).astype(np.float32) \
        if variable else None
    sizes = tuple(p.shape[0] for p, _ in sets)
    w = _stencil(cell, radii.max()) if variable else 1
    pairs = tuple((i, j) for i in range(len(sizes)) for j in range(len(sizes)))
    jstate = jax.jit(jgrid.update_grid)(jgrid.fresh_state(),
                                        jnp.asarray(pts), jnp.float32(cell))
    jknobs = jfp.FastKnobs(use_pallas=False, pack=1, rec_expand=False,
                           dense_cap=1 << 14, tiles_cap=tiles_cap)
    jcfg = JaxConfig(sizes, pairs, variable, variable, w, 1024, 512, 64)
    jc = _prep_jit(jnp.asarray(pts),
                   None if radii is None else jnp.asarray(radii), jstate,
                   cfg=jcfg, knobs=jknobs)
    jc = {k: np.asarray(v) for k, v in jc._asdict().items()}
    cfg = SearchConfig(sizes, pairs, w, 64, variable, variable)
    knobs = tfp.FastKnobs(dense_cap=1 << 14, tiles_cap=tiles_cap)
    tp = torch.from_numpy(pts)
    tr = None if radii is None else torch.from_numpy(radii)
    tc = tfp._prep(tp, interop.grid_state_from_numpy(jstate), cfg, knobs,
                   tr, padded=True, consts=tfp.step_constants(
                       cfg, knobs, float(jstate.cell_size), "cpu",
                       search_radius=0.0))
    recs = tfp.sorted_records(tp, tc.idx_s, tr,
                              tfp.set_ids_of(cfg, "cpu") if len(sizes) > 1
                              else None)
    return (jc, tc, recs, pts, radii, sizes, tiles_cap, cfg, knobs,
            interop.grid_state_from_numpy(jstate))


@pytest.mark.parametrize("case", list(CASES))
def test_padded_prep_bit_equal(case):
    jc, tc, *_ = _both(case)
    tc = {k: v.numpy() for k, v in tc._asdict().items()}
    for k in FIELDS:
        assert tc[k].dtype == jc[k].dtype and tc[k].shape == jc[k].shape, k
        assert np.array_equal(tc[k], jc[k]), k
    jd, td = jc["desc"], tc["desc"]
    assert td.shape == jd.shape
    # padded-slot window starts, lengths, A_COL and CNT_COL
    assert np.array_equal(td[:, :tpp.FAT_COL], jd[:, :tpp.FAT_COL])
    assert np.array_equal(td[:, tpp.FAT_COL] == 2, jd[:, tpp.FAT_COL] == 2)
    # the same windows as the sorted-space prep, shifted by row padding
    _, _, _, pts, radii, sizes, _, cfg, knobs, state = _both(case)
    sc = tfp._prep(torch.from_numpy(pts), state, cfg, knobs,
                   None if radii is None else torch.from_numpy(radii),
                   consts=tfp.step_constants(cfg, knobs,
                                             float(state.cell_size), "cpu",
                                             search_radius=0.0))
    sd = sc.desc.numpy()
    lens = slice(tpp.LENS_OFF, tpp.LENS_OFF + (2 * cfg.stencil_w + 1) ** 2)
    assert np.array_equal(sd[:, lens], td[:, lens])
    assert (td[:, :tpp.LENS_OFF] >= sd[:, :tpp.LENS_OFF]).all()
    assert (td[:, :tpp.LENS_OFF] > sd[:, :tpp.LENS_OFF]).any()


def _jax_k1r(case):
    """K1r in interpret mode on the JAX side at pack 16, from the same
    sorted records (the rec_expand branch of ``_pallas_search``)."""
    jc, tc, recs, *_ = _both(case)
    tiles_cap = CASES[case][1]
    recs_np = recs.numpy()
    n = recs_np.shape[1]
    sent = tpp._sentinel(n, "cpu").numpy()
    rpt = 128 // PACK
    n_rows = -(-n // PACK) + max(rpt, 1024 // PACK) + 4
    packed = np.concatenate(
        [recs_np.T, np.broadcast_to(sent, (n_rows * PACK - n, 8))]
    ).reshape(n_rows, 128)
    recs_t = np.concatenate([recs_np, np.broadcast_to(sent[:, None],
                                                      (8, 384))], axis=1)
    call = jpp.make_expand_call(tiles_cap, tiles_cap, PACK, n,
                                interpret=True, slack_tiles=8,
                                build_rec=True)
    rec_pad, q_t = jax.jit(call)(jnp.asarray(jc["desc"]),
                                 jnp.asarray(packed), jnp.asarray(recs_t))
    return np.asarray(rec_pad).reshape(-1, 8), np.asarray(q_t)


@pytest.mark.parametrize("case", list(CASES))
def test_expand_records_plain_equals_pallas_k1r(case):
    jc, tc, recs, *_ = _both(case)
    tiles_cap = CASES[case][1]
    n = recs.shape[1]
    j_rec, j_q = _jax_k1r(case)
    q_t, rec_pad = tpp.expand_records_plain(tc.desc, recs, tiles_cap, n, 256)
    slots = tiles_cap * 128
    # the Pallas kernel writes the first n_tiles (= tiles_cap) tiles
    assert np.array_equal(rec_pad[:slots].numpy(), j_rec[:slots])
    assert np.array_equal(q_t.numpy(), j_q[:, :slots])
    assert rec_pad.shape == (slots + 256, 8)
    assert (rec_pad[slots:] == tpp._sentinel(n, "cpu")).all()
    live = (tc.desc[:tiles_cap, tpp.FAT_COL] != 2).sum()
    assert 0 < int(live) < tiles_cap   # dead tiles are covered too


@pytest.mark.parametrize("case", list(CASES))
def test_expand_records_plain_equals_the_gather_build(case):
    jc, tc, recs, pts, radii, sizes, tiles_cap, *_ = _both(case)
    n = pts.shape[0]
    set_ids = np.repeat(np.arange(len(sizes), dtype=np.int32), sizes)
    rfield = radii if radii is not None else np.zeros(n, np.float32)
    rec8 = np.stack([pts[:, 0].view(np.int32), pts[:, 1].view(np.int32),
                     pts[:, 2].view(np.int32), rfield.view(np.int32),
                     np.arange(n, dtype=np.int32), set_ids,
                     np.zeros(n, np.int32), np.zeros(n, np.int32)], 1)
    rec8x = np.concatenate([rec8, tpp._sentinel(n, "cpu").numpy()[None]])
    jq, jrec = jfp._build_records(jnp.asarray(rec8x), jnp.asarray(jc["opad"]),
                                  8, False)
    jrec = np.asarray(jrec).reshape(-1, 8)
    q_t, rec_pad = tpp.expand_records(tc.desc, recs, tiles_cap, n, 128)
    m = min(jrec.shape[0], rec_pad.shape[0])
    assert m >= tiles_cap * 128 + 128
    assert np.array_equal(rec_pad[:m].numpy(), jrec[:m])
    assert np.array_equal(q_t.numpy(), np.asarray(jq)[:, :tiles_cap * 128])
    assert torch.equal(q_t, tpp.expand_query_tiles(tc.desc, recs, tiles_cap,
                                                   n))


def test_expand_records_checks_its_arguments():
    desc = torch.zeros((8, tpp.DESC_W), dtype=torch.int32)
    recs = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="slack"):
        tpp.expand_records(desc, recs, 1, 4, -1)
    with pytest.raises(ValueError, match="desc"):
        tpp.expand_records(desc, recs, 9, 4, 0)


# ---------------------------------------------------------- the engines
def _sets_of(k, rng):
    # k small sets in the unit cube plus a fluid: the fluid searches all
    return [rng.uniform(0, 1, (1000, 3)).astype(np.float32)] + [
        rng.uniform(0, 1, (100, 3)).astype(np.float32) for _ in range(k - 1)]


def _run_both(sets, r, active, use_pallas=None, radii=None, symmetric=True,
              cell=None):
    # a window cap of 64 slots (each window lies in one grid row of a few
    # dozen points here) keeps the JAX tile path's compile short
    engines = []
    for eng in (JaxTreeNSearch(), TreeNSearch(device="cpu")):
        for k, p in enumerate(sets):
            eng.add_point_set(p, None if radii is None else radii[k])
        if radii is None:
            eng.set_search_radius(r)
        if cell is not None:
            eng.set_cell_size(cell)
        eng.set_window_cap(64)
        eng.set_symmetric_search(symmetric)
        for i, j in active:
            eng.set_active_search(i, j, True)
        if use_pallas is not None:
            eng.set_use_pallas(use_pallas)
        eng.run()
        engines.append(eng)
    return engines


def _equal_slot_for_slot(jeng, teng, active):
    total = 0
    for i, j in active:
        jc, jn = (np.asarray(a) for a in jeng.get_neighbors(i, j))
        tc, tn = (t.numpy() for t in teng.get_neighbors(i, j))
        assert np.array_equal(tc, jc), (i, j)
        assert tn.shape == jn.shape, (i, j)
        assert np.array_equal(tn, jn), (i, j)
        total += int(tc.sum())
    assert total > 0
    return total


@pytest.mark.parametrize("k", [9, 10])
def test_many_candidate_sets_equal_the_jax_tile_path(k):
    rng = np.random.default_rng(k)
    sets = _sets_of(k, rng)
    active = [(0, j) for j in range(k)] + [(3, 0), (k - 1, k - 1)]
    jeng, teng = _run_both(sets, 0.08, active, cell=0.1)
    assert len({j for _, j in active}) == k > tpp.MAX_BLOCKS
    assert teng._last_stats["path"] == "fast"
    _equal_slot_for_slot(jeng, teng, active)


@pytest.mark.parametrize("variable", [False, True])
def test_use_pallas_off_equals_the_jax_tile_path(variable):
    rng = np.random.default_rng(21)
    sets = [rng.uniform(0, 1, (2000, 3)).astype(np.float32),
            rng.uniform(0, 1, (600, 3)).astype(np.float32)]
    radii = [rng.uniform(0.04, 0.08, s.shape[0]).astype(np.float32)
             for s in sets] if variable else None
    active = [(0, 0), (0, 1), (1, 0)]
    before = tfp._prep.calls
    jeng, teng = _run_both(sets, 0.07, active, use_pallas=False, radii=radii,
                           cell=0.1)
    assert tfp._prep.calls > before
    assert teng._fast_carry is None   # the carry is the fused route's
    _equal_slot_for_slot(jeng, teng, active)
    # the same lists as the fused kernels, as sets
    fused = TreeNSearch(device="cpu")
    for k, p in enumerate(sets):
        fused.add_point_set(p, None if radii is None else radii[k])
    if not variable:
        fused.set_search_radius(0.07)
    fused.set_cell_size(0.1)
    for i, j in active:
        fused.set_active_search(i, j, True)
    fused.run()
    for i, j in active:
        (tc, tn), (fc, fn) = teng.get_neighbors(i, j), fused.get_neighbors(i, j)
        assert torch.equal(tc, fc)
        for q in range(0, tc.shape[0], 37):
            assert sorted(tn[q, :tc[q]].tolist()) == \
                sorted(fn[q, :fc[q]].tolist())


def test_off_the_fused_route_the_contracts_and_carried_steps_raise():
    rng = np.random.default_rng(2)
    eng = TreeNSearch(device="cpu")
    for _ in range(9):
        eng.add_point_set(rng.uniform(0, 1, (40, 3)).astype(np.float32))
    eng.set_search_radius(0.2)
    eng.set_all_searches(True)
    with pytest.raises(NotImplementedError, match="requires the Pallas"):
        eng.run_reduce(lambda env: env["d2"])
    with pytest.raises(NotImplementedError, match="requires the Pallas"):
        eng.run_mask()
    for kw in ({"reuse": True}, {"mask_output": True},
               {"reduce": (lambda env: env["d2"], 1)}):
        with pytest.raises(ValueError, match="require"):
            eng.make_step_fn(**kw)
    # settled caps first, as make_step_fn asks: the tile path's step tests
    # every tile of the cap at the full window cap
    eng.run()
    step, state = eng.make_step_fn()   # the tile path's step
    sol, _ = step(state, torch.from_numpy(np.concatenate(
        [np.asarray(s.points) for s in eng._sets])))
    for key, pair in sol["pairs"].items():
        i, j = map(int, key.split("-"))
        assert torch.equal(pair["counts"], eng.get_neighbors(i, j)[0])


def test_dense_overflow_at_the_cap_takes_the_pipeline(monkeypatch):
    monkeypatch.setattr(tapi, "_MAX_DENSE_CAP", 1 << 17)
    rng = np.random.default_rng(8)
    pts = np.concatenate([rng.uniform(0, 1, (400, 3)),
                          rng.uniform(199, 200, (400, 3))]).astype(np.float32)
    eng = TreeNSearch(device="cpu")
    eng.add_point_set(pts)
    eng.set_search_radius(0.25)
    eng.set_cell_size(0.25)
    eng.set_all_searches(True)
    eng.run()
    assert eng._dense_cap == 1 << 17
    assert eng._last_stats["path"] == "reference"
    orc = BruteforceNSearch(search_radius=0.25)
    orc.add_point_set(pts)
    orc.set_all_searches(True)
    orc.run()
    orc.compare(eng)
    with pytest.raises(NotImplementedError, match="requires the Pallas"):
        eng.run_reduce(lambda env: env["d2"])
