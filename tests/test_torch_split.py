"""Split staging in the port (K4's hit bits, then K5,
``ops/pairs.py::pairs_nbrs_from_bits``, unpacking them into the pairs
kernel's blocks) against the JAX package, the port's fused path and the
numpy oracle.

- **Against JAX.** The port's split path on the CPU (K4's and K5's plain
  versions, through ``build_and_search_fast`` with
  ``FastKnobs(split_stage=True)``) against the JAX split engine
  (``build_and_search_fast_jit`` with ``FastKnobs(split_stage=True,
  lane_batch=True, interpret=True)``), one module-scoped interpret compile
  for each of the three shapes of ``tests/test_split_stage.py``: one set
  at a fixed radius; two sets under an asymmetric matrix with variable
  symmetric radii; two sets through the JAX shared compaction.  Counts
  equal and rows equal as sets, per active pair.
- **Against the fused path.** Split staging gives the fused kernel's rows
  slot for slot on the slots of active pairs (both write in window order);
  a block's slots of a query set that does not search its candidate set
  are 0 under split staging and filled by the fused kernel, so nothing
  else is compared.
- **Engine.** ``TreeNSearch(device="cpu").set_split_stage(True)`` against
  the oracle; the CUDA route raises without nvcc.  The 25 small shapes of
  ``tests/test_edge_cases.py::test_combinatorial_small_sets`` (empty sets,
  the 127/128/129 and 255-257 tile edges) through the fused ``run()`` and
  then split staging, both against the oracle.

Tolerance: none; counts, rows and sets are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reduce import (ACTIVE, R, SIZES, _port_engine, _split,
                               fixed_case_data, oracle_mask,
                               variable_case_data)
from treensearch_tpu.config import SearchConfig as JaxConfig
from treensearch_tpu.ops import fastpath as jfp
from treensearch_tpu.ops.grid import fresh_state as jax_fresh_state
from treensearch_tpu.oracle import BruteforceNSearch
from treensearch_tpu_torch import TreeNSearch
from treensearch_tpu_torch.config import SearchConfig
from treensearch_tpu_torch.ops import fastpath as tfp
from treensearch_tpu_torch.ops import pairs as tpp
from treensearch_tpu_torch.ops.grid import fresh_state, update_grid

CAP = 96
# tests/test_split_stage.py:37-47: (variable, pack, rec_expand, sets,
# shared compaction)
SHAPES = {"one_set_fixed": (False, 8, True, 1, False),
          "two_sets_variable_symmetric": (True, 4, False, 2, False),
          "two_sets_shared_compaction": (False, 8, True, 2, True)}


def _shape_data(variable, nsets):
    """tests/test_split_stage.py's cloud: 900 points in a slab."""
    rng = np.random.default_rng(17)
    n, r = 900, 0.09
    pts = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    pts[:, :2] *= 0.42
    rad = rng.uniform(0.8 * r, 1.2 * r, n).astype(np.float32) \
        if variable else None
    cell = 1.5 * (rad.min() if variable else r)
    if nsets == 2:
        sizes, pairs = (n - 300, 300), ((0, 0), (0, 1), (1, 0))
    else:
        sizes, pairs = (n,), ((0, 0),)
    return pts, rad, r, cell, 2 if variable else 1, sizes, pairs


def _jax_split(pts, rad, r, cell, w, sizes, pairs, pack, rec_expand,
               shared):
    """The JAX split engine's counts and materialised rows per pair."""
    variable = rad is not None
    cfg = JaxConfig(sizes, pairs, variable, variable, w, 1024, 512, CAP)
    knobs = jfp.FastKnobs(
        wcap=160 if variable else 256, dense_cap=1 << 14, use_pallas=True,
        pre_cap=96, pre_edge=96, interpret=True, fat_cap=8, fat_wcap=512,
        tiles_cap=48, pack=pack, lane_batch=True, rec_expand=rec_expand,
        shared_compact=shared, split_stage=True)
    sol, _ = jfp.build_and_search_fast_jit(
        jnp.asarray(pts), None if rad is None else jnp.asarray(rad),
        jnp.float32(0.0 if variable else r), jnp.float32(cell),
        jax_fresh_state(), cfg, knobs)
    assert int(sol["pallas_used"]) == 1 and int(sol["tile_overflow"]) == 0
    jfp.attach_blocks(sol)
    return {k: (np.asarray(p["counts"]), np.asarray(jfp.materialize_nbrs(p)))
            for k, p in sol["pairs"].items()}


def _port_solution(data, split):
    pts, rad, r, cell, w, sizes, pairs = data
    cfg = SearchConfig(sizes, pairs, w, CAP, rad is not None, rad is not None)
    knobs = tfp.FastKnobs(dense_cap=1 << 14, tiles_cap=48, split_stage=split)
    sol, _ = tfp.build_and_search_fast(
        torch.from_numpy(pts), 0.0 if rad is not None else r,
        fresh_state(), cfg, knobs,
        radii=None if rad is None else torch.from_numpy(rad),
        consts=tfp.step_constants(cfg, knobs, cell, "cpu",
                                  search_radius=0.0 if rad is not None
                                  else r))
    assert int(sol["tile_overflow"]) == 0 and int(sol["dense_overflow"]) == 0
    return {k: (p["counts"].numpy(), tfp.materialize_nbrs(p).numpy())
            for k, p in sol["pairs"].items()}


@pytest.fixture(scope="module", params=list(SHAPES))
def shape(request):
    return request.param


@pytest.fixture(scope="module")
def jax_split(shape):
    """One interpret compile of the JAX split engine per shape."""
    variable, pack, rec_expand, nsets, shared = SHAPES[shape]
    return _jax_split(*_shape_data(variable, nsets), pack, rec_expand,
                      shared)


def _data(shape):
    variable, _, _, nsets, _ = SHAPES[shape]
    return _shape_data(variable, nsets)


def _kernel_inputs(data):
    """The port's prep and kernel inputs for the shape's data, the active
    matrix and K1's query tiles."""
    pts, rad, r, cell, w, sizes, pairs = data
    points = torch.from_numpy(pts)
    radii = None if rad is None else torch.from_numpy(rad)
    cfg = SearchConfig(sizes, pairs, w, CAP, rad is not None, rad is not None)
    knobs = tfp.FastKnobs(dense_cap=1 << 14, tiles_cap=48)
    consts = tfp.step_constants(cfg, knobs, cell, "cpu", search_radius=r)
    carry = tfp._prep(points, update_grid(fresh_state(), points,
                                          consts.cell_size), cfg,
                      knobs, radii, consts=consts)
    a = tfp.kernel_inputs(points, r, carry, cfg, knobs, radii)
    q = tpp.expand_query_tiles(a.desc, a.recs_t, a.tiles_cap, cfg.n_points)
    return cfg, carry, a, tfp.allow_table(cfg, a.cand_sets, "cpu"), q


def test_split_plain_matches_the_jax_split_engine(shape, jax_split):
    port = _port_solution(_data(shape), split=True)
    assert set(port) == set(jax_split)
    total = 0
    for key, (counts, nbrs) in port.items():
        j_counts, j_nbrs = jax_split[key]
        assert np.array_equal(counts, j_counts), key
        for i in range(counts.shape[0]):
            assert np.array_equal(np.sort(nbrs[i, :counts[i]]),
                                  np.sort(j_nbrs[i, :j_counts[i]])), (key, i)
        total += int(counts.sum())
    assert total > 0


def test_split_rows_equal_the_fused_rows_per_active_pair(shape):
    split, fused = (_port_solution(_data(shape), s) for s in (True, False))
    for key in fused:
        assert np.array_equal(split[key][0], fused[key][0]), key
        assert np.array_equal(split[key][1], fused[key][1]), key


def test_run_pairs_split_slots_of_active_pairs_only(shape):
    cfg, carry, a, allow, q = _kernel_inputs(_data(shape))
    c_f, nb_f = tfp.run_pairs(a, q)
    c_s, nb_s = tfp.run_pairs(a, q, allow=allow)
    c_sp, nb_sp = tfp.run_pairs(a, q, plain=True, allow=allow)
    assert all(torch.equal(x, y) for x, y in zip([c_s, *nb_s],
                                                 [c_sp, *nb_sp]))
    qpos = carry.qpos.long()
    offs = cfg.set_offsets
    for si in range(cfg.n_sets):
        slots = qpos[offs[si]:offs[si + 1]]
        for b, sj in enumerate(a.cand_sets):
            if (si, sj) in cfg.active_pairs:
                assert torch.equal(c_s[b, slots], c_f[b, slots]), (si, sj)
                assert torch.equal(nb_s[b][slots // 128, :, slots % 128],
                                   nb_f[b][slots // 128, :, slots % 128])
            else:
                # the fused kernel fills the block; the bits hold nothing
                assert not c_s[b, slots].any(), (si, sj)
                assert c_f[b, slots].any(), (si, sj)


def test_k5_counts_sum_to_k4_counts_and_caps_truncate(shape):
    cfg, carry, a, allow, q = _kernel_inputs(_data(shape))
    k4_counts, bits, cand_base = tpp.pairs_mask(
        a.desc, q, a.recs_t, a.n_win, a.tiles_cap, a.cand_sets, allow,
        **tfp.active_args(a))
    before = tpp.pairs_nbrs_from_bits.launches
    args = (a.desc, a.recs_t, bits, cand_base, a.n_win, a.tiles_cap,
            a.cand_sets, a.cand_offsets)
    counts, nbrs = tpp.pairs_nbrs_from_bits(*args, a.k8s)
    assert tpp.pairs_nbrs_from_bits.launches == before   # the plain version
    assert torch.equal(counts.sum(0), k4_counts)
    # a row cap of 8: the counts stay exact, the rows are the first 8
    small, rows8 = tpp.pairs_nbrs_from_bits(*args, (8,) * len(a.k8s))
    assert torch.equal(small, counts) and int(counts.max()) > 8
    for b in range(len(a.k8s)):
        assert torch.equal(rows8[b], nbrs[b][:, :8])


def test_k5_rows_past_the_bits_read_as_zero():
    _, carry, a, allow, q = _kernel_inputs(_shape_data(False, 1))
    _, bits, cand_base = tpp.pairs_mask(
        a.desc, q, a.recs_t, a.n_win, a.tiles_cap, a.cand_sets, allow,
        r2=a.r2)
    args = (a.desc, a.recs_t)
    tail = (cand_base, a.n_win, a.tiles_cap, a.cand_sets, a.cand_offsets,
            a.k8s)
    full, _ = tpp.pairs_nbrs_from_bits(*args, bits, *tail)
    none, rows = tpp.pairs_nbrs_from_bits(*args, bits[:0], *tail)
    assert full.sum() > 0 and not none.any() and (rows[0] == -1).all()
    # half the rows: the tiles whose rows all lie below the cut keep theirs
    live = int((a.desc[:a.tiles_cap, tpp.FAT_COL] != 2).sum())
    cut = int(cand_base[live // 2])
    half, _ = tpp.pairs_nbrs_from_bits(*args, bits[:cut].contiguous(), *tail)
    kept = (cand_base[1:] <= cut).repeat_interleave(128)
    assert torch.equal(half[0][kept], full[0][kept])
    assert half.sum() < full.sum()


@pytest.mark.parametrize("bad", ["bits_shape", "bits_dtype", "base_dtype",
                                 "base_shape", "blocks"])
def test_k5_wrapper_rejects_bad_arguments(bad):
    _, carry, a, allow, q = _kernel_inputs(_shape_data(False, 1))
    _, bits, cand_base = tpp.pairs_mask(
        a.desc, q, a.recs_t, a.n_win, a.tiles_cap, a.cand_sets, allow,
        r2=a.r2)
    kw = dict(bits=bits, cand_base=cand_base, cand_sets=a.cand_sets)
    kw.update({"bits_shape": {"bits": bits[:, :2].contiguous()},
               "bits_dtype": {"bits": bits.long()},
               "base_dtype": {"cand_base": cand_base.int()},
               "base_shape": {"cand_base": cand_base[:-1]},
               "blocks": {"cand_sets": tuple(range(9))}}[bad])
    with pytest.raises((ValueError, TypeError)):
        tpp.pairs_nbrs_from_bits(a.desc, a.recs_t, kw["bits"],
                                 kw["cand_base"], a.n_win, a.tiles_cap,
                                 kw["cand_sets"], a.cand_offsets, a.k8s)


def test_kernel_route_raises_without_nvcc(monkeypatch, tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(tpp, "CUDA_HOME_DEFAULT", str(empty))
    monkeypatch.setattr(tpp, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tpp, "_PAIRS", {})
    tiles_cap = 4
    meta = dict(device="meta", dtype=torch.int32)
    before = tpp.pairs_nbrs_from_bits.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        tpp.pairs_nbrs_from_bits(
            torch.empty((8, tpp.DESC_W), **meta),
            torch.empty((tpp.N_FIELDS, 100), **meta),
            torch.empty((50, tpp.MASK_WORDS), **meta),
            torch.empty(tiles_cap + 1, device="meta", dtype=torch.int64),
            9, tiles_cap, (0,), (0,), (16,))
    assert tpp.pairs_nbrs_from_bits.launches == before


# ------------------------------------------------------------------ engine
def test_engine_split_stage_vs_oracle_three_sets():
    pts, _ = fixed_case_data()
    eng = _port_engine(_split(pts, SIZES), r=R, active=ACTIVE)
    eng.set_split_stage(True)
    eng.run()
    assert eng._knobs().split_stage
    m, _ = oracle_mask(pts, np.repeat(np.arange(3), SIZES), ACTIVE, r=R)
    offs = np.cumsum((0,) + SIZES)
    for i, j in ACTIVE:
        counts, nbrs = eng.get_neighbors(i, j)
        want = m[offs[i]:offs[i + 1], offs[j]:offs[j + 1]]
        assert np.array_equal(counts.numpy(), want.sum(1)), (i, j)
        for k in range(SIZES[i]):
            assert np.array_equal(np.sort(nbrs[k, :counts[k]].numpy()),
                                  np.nonzero(want[k])[0]), (i, j, k)


def test_engine_split_stage_variable_symmetric_vs_oracle():
    pts, rad = variable_case_data()
    eng = _port_engine([pts], radii=[rad], active=((0, 0),))
    eng.set_split_stage(True)
    eng.set_neighbor_cap(8)       # regrows through the split path
    eng.run()
    m, _ = oracle_mask(pts, np.zeros(200, int), ((0, 0),), radii=rad,
                       symmetric=True)
    counts, nbrs = eng.get_neighbors(0, 0)
    assert eng._nbr_cap > 8
    assert np.array_equal(counts.numpy(), m.sum(1))
    for k in range(200):
        assert np.array_equal(np.sort(nbrs[k, :counts[k]].numpy()),
                              np.nonzero(m[k])[0]), k


# tests/test_edge_cases.py:13-22
SMALL_SETS = [(0,), (1,), (2,), (7,), (16,), (17,), (127,), (128,), (129,),
              (255,), (256,), (257,), (128, 128), (0, 0), (0, 5), (5, 0),
              (1, 1), (9, 16), (100, 3), (128, 1), (127, 2), (31, 97),
              (0, 1, 100), (4, 0, 9), (126, 1, 2)]


@pytest.mark.parametrize("counts", SMALL_SETS, ids=str)
def test_small_sets_fused_then_split_vs_oracle(counts):
    # the reference's combinatorial stress test, reduced: every set
    # searches every set at r = 0.3, on the same data as the JAX test
    rng = np.random.default_rng(sum(counts) + len(counts))
    sets = [rng.uniform(0, 1, (c, 3)).astype(np.float32) for c in counts]
    orc = BruteforceNSearch(search_radius=0.3)
    eng = TreeNSearch(device="cpu")
    for pts in sets:
        orc.add_point_set(pts)
        eng.add_point_set(pts)
    orc.set_all_searches(True)
    eng.set_search_radius(0.3)
    eng.set_all_searches(True)
    orc.run()
    eng.run()
    orc.compare(eng)
    eng.set_split_stage(True)
    eng.run()
    assert eng._knobs().split_stage
    orc.compare(eng)
