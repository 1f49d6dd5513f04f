"""Z-sort in the port (``treensearch_tpu_torch/ops/zsort.py`` and the
engine's ``prepare_zsort``, ``apply_zsort[_batch]``, ``get_zsort_order``)
against the JAX package on the CPU.

- **Orders.** The per-point order against ``treensearch_tpu.ops.zsort.
  zsort_orders`` over the same world box, the cell-granular order against
  its ``zsort_orders_from_cells`` fed the port's carried ``lin_chk``
  (bit-equal to the JAX prep's by ``tests/test_torch_prep.py``), the
  Morton words against ``utils/keys.py::morton_keys_2word`` and
  ``make_zsort_step`` against the JAX step under ``jax.jit``.  The JAX
  references come from these direct calls, never from the JAX engine's
  ``run()``, which costs seconds per shape.
- **Engine.** One counterpart of each of ``tests/test_zsort.py``'s eight
  tests; the choice of path after each kind of call, as the JAX engine
  chooses; the error cases; and ``test_combinatorial_small_sets``'s 25
  shapes through ``run()``, the z-sort round trip and ``run()`` again
  against the numpy oracle.

Tolerance: none.  Orders are compared bit for bit, reordered arrays bit
for bit for every dtype, neighbor sets exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_split import SMALL_SETS
from treensearch_tpu.ops import zsort as jz
from treensearch_tpu.oracle import BruteforceNSearch
from treensearch_tpu.utils import keys as jkeys
from treensearch_tpu_torch import TreeNSearch
from treensearch_tpu_torch.ops import zsort as tz
from treensearch_tpu_torch.utils import keys as tkeys


def _cloud(n, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n, 3)) \
        .astype(np.float32)


def _port(sets, r, run=False, radii=None):
    eng = TreeNSearch(device="cpu")
    for k, p in enumerate(sets):
        eng.add_point_set(p, None if radii is None else radii[k])
    if radii is None:
        eng.set_search_radius(r)
    eng.set_all_searches(True)
    if run:
        eng.run()
    return eng


def _orders(eng):
    return [eng.get_zsort_order(k) for k in range(eng.get_n_sets())]


def _jax_point_orders(sets):
    """The JAX per-point orders over the box of every non-empty set
    (``treensearch_tpu/api.py:1029-1043``)."""
    sets = [np.asarray(p, np.float32).reshape(-1, 3) for p in sets]
    live = [p for p in sets if p.shape[0]]
    box_min = np.min([p.min(0) for p in live], 0) if live \
        else np.zeros(3, np.float32)
    box_max = np.max([p.max(0) for p in live], 0) if live \
        else np.ones(3, np.float32)
    return [np.asarray(o) for o in jz.zsort_orders(
        [jnp.asarray(p) for p in sets], jnp.asarray(box_min),
        jnp.asarray(box_max))]


def _jax_cell_orders(eng):
    """The JAX cell-granular orders of the port's carried cell ids."""
    lin = eng._fast_carry.lin_chk.numpy()
    w = int(eng._last_stats["stencil_w"])
    nc = eng._grid_state.n_cells.numpy()
    sizes = [eng.get_n_points_in_set(k) for k in range(eng.get_n_sets())]
    lins = np.split(lin, np.cumsum(sizes)[:-1])
    return [np.asarray(o) for o in jz.zsort_orders_from_cells(
        [jnp.asarray(x) for x in lins], jnp.int32(nc[1] + 2 * w),
        jnp.int32(nc[2] + 2 * w))]


def _assert_orders_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and np.array_equal(g, w)


def _mean_step(p):
    return np.linalg.norm(np.diff(p, axis=0), axis=1).mean()


def _sets_of(eng, si, sj):
    counts, nbrs = (t.numpy() for t in eng.get_neighbors(si, sj))
    return [set(nbrs[i, :counts[i]].tolist()) for i in range(counts.size)]


# ------------------------------------------- tests/test_zsort.py's eight
def test_zsort_is_permutation_and_improves_locality():
    pts = _cloud(2000)
    eng = _port([pts], 0.1)
    eng.prepare_zsort()
    order = eng.get_zsort_order(0)
    _assert_orders_equal([order], _jax_point_orders([pts]))
    assert sorted(order.tolist()) == list(range(2000))
    assert _mean_step(pts[order]) < 0.5 * _mean_step(pts)


def test_apply_zsort_strided_and_inplace():
    n = 500
    pts = _cloud(n, 1)
    eng = _port([pts], 0.1)
    eng.prepare_zsort()
    order = eng.get_zsort_order(0)

    p = np.array(pts)
    out = eng.apply_zsort(0, p)
    assert out is p and np.array_equal(p, pts[order])   # in place
    flat = np.array(pts).ravel()
    eng.apply_zsort(0, flat, stride=3)
    assert np.array_equal(flat.reshape(n, 3), pts[order])
    dens = np.arange(n, dtype=np.float64)
    eng.apply_zsort(0, dens)
    assert np.array_equal(dens, np.arange(n)[order].astype(np.float64))

    # a tensor comes back reordered as a new tensor; it stays as it was
    t = torch.from_numpy(pts.copy())
    out = eng.apply_zsort(0, t)
    assert out is not t and torch.equal(t, torch.from_numpy(pts))
    assert out.device == t.device and np.array_equal(out.numpy(), pts[order])
    tflat = torch.from_numpy(pts.ravel().copy())
    out = eng.apply_zsort(0, tflat, stride=3)
    assert out.shape == (3 * n,)
    assert np.array_equal(out.numpy().reshape(n, 3), pts[order])


def test_apply_zsort_wide_dtypes_bit_exact():
    # values an f32/i32 round trip would corrupt: int64 >= 2^31 and f64
    # with more than 24 mantissa bits
    n = 400
    pts = _cloud(n, 4)
    eng = _port([pts], 0.1)
    eng.prepare_zsort()
    order = eng.get_zsort_order(0)

    big_i64 = (np.arange(n, dtype=np.int64) + 1) * (1 << 33) + 7
    ref_i64 = big_i64[order].copy()
    out = eng.apply_zsort(0, big_i64)
    assert out is big_i64 and out.dtype == np.int64
    assert np.array_equal(big_i64, ref_i64)
    f64 = np.arange(n, dtype=np.float64) + 1.0 + 2.0 ** -40
    assert not np.array_equal(f64.astype(np.float32).astype(np.float64), f64)
    ref_f64 = f64[order].copy()
    eng.apply_zsort(0, f64)
    assert f64.dtype == np.float64 and np.array_equal(f64, ref_f64)
    flat = np.arange(3 * n, dtype=np.float64) + 2.0 ** -40
    ref_flat = flat.reshape(n, 3)[order].ravel().copy()
    eng.apply_zsort(0, flat, stride=3)
    assert np.array_equal(flat, ref_flat)

    # uint64 numpy and a float32 tensor through the batch
    u64 = (np.arange(n, dtype=np.uint64) + 1) * np.uint64(1 << 40)
    f32 = torch.arange(n, dtype=torch.float32)
    ref_u64 = u64[order].copy()
    out = eng.apply_zsort_batch(0, [u64, f32])
    assert out[0] is u64 and u64.dtype == np.uint64
    assert np.array_equal(u64, ref_u64)
    assert np.array_equal(out[1].numpy(), np.arange(n, dtype=np.float32)
                          [order])

    # the torch gather is exact too: float64 and int64 tensors
    t64 = torch.from_numpy((np.arange(n, dtype=np.float64) + 2.0 ** -40))
    ti64 = torch.from_numpy((np.arange(n, dtype=np.int64) << 33) + 5)
    o64, oi64 = eng.apply_zsort_batch(0, [t64, ti64])
    assert o64.dtype == torch.float64 and oi64.dtype == torch.int64
    assert np.array_equal(o64.numpy(), t64.numpy()[order])
    assert np.array_equal(oi64.numpy(), ti64.numpy()[order])


def test_zsort_then_run_parity():
    # the reference's flow: run, prepare, reorder the user arrays, rerun
    pts = _cloud(1500, 2)
    eng = _port([pts], 0.09, run=True)
    before = _sets_of(eng, 0, 0)
    eng.prepare_zsort()
    order = eng.get_zsort_order(0)
    _assert_orders_equal([order], _jax_cell_orders(eng))
    p = np.array(pts)
    eng.apply_zsort(0, p)
    eng.resize_point_set(0, p)
    eng.run()
    orc = BruteforceNSearch(search_radius=0.09)
    orc.add_point_set(p)
    orc.set_all_searches(True)
    orc.run()
    orc.compare(eng)
    after = _sets_of(eng, 0, 0)
    assert [{int(order[j]) for j in after[i]} for i in range(1500)] \
        == [before[order[i]] for i in range(1500)]


def test_apply_without_prepare_raises():
    eng = _port([_cloud(10)], 0.1)
    for call in (lambda: eng.apply_zsort(0, np.zeros((10, 3), np.float32)),
                 lambda: eng.apply_zsort_batch(0, [np.zeros(10)]),
                 lambda: eng.get_zsort_order(0)):
        with pytest.raises(RuntimeError, match="prepare_zsort"):
            call()


def test_zsort_invalidated_by_resize():
    eng = _port([_cloud(10)], 0.1)
    eng.prepare_zsort()
    eng.resize_point_set(0, _cloud(12))
    with pytest.raises(RuntimeError):
        eng.apply_zsort(0, np.zeros((12, 3), np.float32))


def test_zsort_cell_granular_fast_path_after_run():
    """After a ``run()`` on the fused route, ``prepare_zsort`` orders by
    the carried cell ids: cells in Morton order, each cell's points in
    their original order; recomputed here by a pure-python interleave and
    by the JAX ``zsort_orders_from_cells``."""
    n = 1200
    pts = _cloud(n, 5)
    eng = _port([pts], 0.1, run=True)
    assert eng._last_stats["path"] == "fast"
    assert eng._fast_carry is not None and bool(eng._fast_carry.valid)
    eng.prepare_zsort()
    order = eng.get_zsort_order(0)
    assert sorted(order.tolist()) == list(range(n))
    _assert_orders_equal([order], _jax_cell_orders(eng))

    lin = eng._fast_carry.lin_chk.numpy()
    w = int(eng._last_stats["stencil_w"])
    nc = eng._grid_state.n_cells.numpy()
    dy, dz = int(nc[1]) + 2 * w, int(nc[2]) + 2 * w
    k, j, i = lin % dz, (lin // dz) % dy, lin // (dz * dy)

    def interleave3(a, b, c):
        out = 0
        for bit in range(17):
            out |= (((int(a) >> bit) & 1) << (3 * bit + 2)
                    | ((int(b) >> bit) & 1) << (3 * bit + 1)
                    | ((int(c) >> bit) & 1) << (3 * bit))
        return out

    keys = np.array([interleave3(k[p], j[p], i[p]) for p in range(n)],
                    dtype=np.int64)
    assert np.array_equal(order, np.argsort(keys, kind="stable"))
    lin_sorted = lin[order]
    same_cell = lin_sorted[1:] == lin_sorted[:-1]
    assert np.all(order[1:][same_cell] > order[:-1][same_cell])
    assert _mean_step(pts[order]) < 0.5 * _mean_step(pts)


def test_zsort_cell_path_matches_apply_roundtrip():
    n = 400
    pts = _cloud(n, 6)
    eng = _port([pts], 0.12, run=True)
    eng.prepare_zsort()
    order = eng.get_zsort_order(0)
    p = pts.copy()
    eng.apply_zsort(0, p)
    assert np.array_equal(p, pts[order])


# ------------------------------------------------ orders against JAX
def _variable_two_sets():
    # radii 0.04-0.12 at the default cell 1.5 r_min: a stencil of 2 cells
    rng = np.random.default_rng(12)
    sets = [rng.uniform(0, 1, (m, 3)).astype(np.float32) for m in (700, 300)]
    radii = [rng.uniform(0.04, 0.12, s.shape[0]).astype(np.float32)
             for s in sets]
    return sets, None, radii


# name: () -> (sets, radius, radii or None)
CELL_CASES = {
    "one_set": lambda: ([_cloud(900, 7)], 0.08, None),
    "three_sets_one_empty": lambda: ([_cloud(500, 8), _cloud(0),
                                      _cloud(129, 9)], 0.1, None),
    "variable_two_sets_stencil_2": _variable_two_sets,
}


@pytest.mark.parametrize("case", list(CELL_CASES))
def test_cell_orders_equal_jax(case):
    sets, r, radii = CELL_CASES[case]()
    eng = _port(sets, r, run=True, radii=radii)
    assert eng._last_stats["carried"]
    eng.prepare_zsort()
    got = _orders(eng)
    _assert_orders_equal(got, _jax_cell_orders(eng))
    for o, p in zip(got, sets):
        assert sorted(o.tolist()) == list(range(p.shape[0]))


def _degenerate():
    return [np.full((50, 3), 0.25, np.float32)]   # extent 0 -> 1e-30


def _offset():
    # far from the origin: the float32 quantization must match exactly
    return [_cloud(800, 10) * np.float32(3.7) + np.float32(1234.5)]


def _flat_and_wide():
    # a flat slab (one axis of extent ~0) next to a long thin rod
    rng = np.random.default_rng(11)
    slab = np.stack([rng.uniform(0, 1, 400), rng.uniform(0, 1, 400),
                     np.full(400, 0.5)], 1).astype(np.float32)
    rod = np.stack([rng.uniform(-3, 3, 300), np.zeros(300),
                    np.zeros(300)], 1).astype(np.float32)
    return [slab, rod]


POINT_CASES = {
    "two_sets_one_empty": lambda: [_cloud(700, 12), _cloud(0)],
    "all_sets_empty": lambda: [_cloud(0), _cloud(0)],
    "float64_input": lambda: [np.random.default_rng(13)
                              .uniform(-1, 1, (600, 3))],
    "coincident_points": _degenerate,
    "offset_cloud": _offset,
    "slab_and_rod": _flat_and_wide,
}


@pytest.mark.parametrize("case", list(POINT_CASES))
def test_point_orders_equal_jax(case):
    sets = POINT_CASES[case]()
    eng = _port(sets, 0.1)
    eng.prepare_zsort()
    _assert_orders_equal(_orders(eng), _jax_point_orders(sets))


@pytest.mark.parametrize("bits", [20, 16])
def test_morton_words_equal_jax(bits):
    rng = np.random.default_rng(bits)
    top = (1 << bits) - 1
    ijk = np.concatenate([rng.integers(0, top + 1, (3000, 3)),
                          [[0, 0, 0], [top, top, top], [top, 0, 0],
                           [0, top, 0], [0, 0, top], [1023, 1024, 1025]]]
                         ).astype(np.int32)
    hi, lo = tkeys.morton_keys_2word(torch.from_numpy(ijk), bits=bits)
    jhi, jlo = jkeys.morton_keys_2word(jnp.asarray(ijk), bits=bits)
    assert hi.dtype == lo.dtype == torch.int32
    assert np.array_equal(hi.numpy(), np.asarray(jhi))
    assert np.array_equal(lo.numpy(), np.asarray(jlo))


# name: what to call after run(); the path prepare_zsort must take then,
# by the JAX engine's condition (treensearch_tpu/api.py:1011-1016)
PATH_CASES = {
    "nothing_run": (None, "point"),
    "run": (lambda e: e.run(), "cell"),
    "run_scalar": (lambda e: e.run_scalar(), "point"),
    "run_reduce": (lambda e: e.run_reduce(lambda env: env["d2"]), "point"),
    "run_mask": (lambda e: e.run_mask(), "point"),
    "coherence_off": (lambda e: (e.set_coherence(False), e.run()), "point"),
    "tile_path": (lambda e: (e.set_use_pallas(False), e.run()), "point"),
}


@pytest.mark.parametrize("case", list(PATH_CASES))
def test_prepare_zsort_takes_the_jax_path(case):
    sets = [_cloud(300, 14), _cloud(200, 15)]
    eng = _port(sets, 0.1)
    call, path = PATH_CASES[case]
    if call is not None:
        call(eng)
    eng.prepare_zsort()
    want = _jax_cell_orders(eng) if path == "cell" \
        else _jax_point_orders(sets)
    _assert_orders_equal(_orders(eng), want)


# --------------------------------------------------------- the step
def test_make_zsort_step_three_sets_one_empty_equals_jax():
    rng = np.random.default_rng(16)
    sets = [rng.uniform(0, 1, (m, 3)).astype(np.float32)
            for m in (400, 0, 150)]
    arrays = [[rng.normal(size=(p.shape[0], 3)).astype(np.float32),
               np.arange(p.shape[0], dtype=np.int32) * 7]
              for p in sets]
    orders, pts, arrs = tz.make_zsort_step(3)(
        [torch.from_numpy(p) for p in sets],
        [[torch.from_numpy(a) for a in aa] for aa in arrays])
    jorders, jpts, jarrs = jax.jit(jz.make_zsort_step(3))(
        [jnp.asarray(p) for p in sets],
        [[jnp.asarray(a) for a in aa] for aa in arrays])
    _assert_orders_equal([o.numpy() for o in orders],
                         [np.asarray(o) for o in jorders])
    for got, want in zip(pts, jpts):
        assert np.array_equal(got.numpy(), np.asarray(want))
    for got_set, want_set in zip(arrs, jarrs):
        for got, want in zip(got_set, want_set):
            want = np.asarray(want)
            assert got.numpy().dtype == want.dtype
            assert np.array_equal(got.numpy(), want)
    # the engine's per-point orders are the step's
    eng = _port(sets, 0.1)
    eng.prepare_zsort()
    _assert_orders_equal(_orders(eng), [o.numpy() for o in orders])
    with pytest.raises(ValueError, match="3 sets"):
        tz.make_zsort_step(3)([torch.from_numpy(sets[0])])


def test_make_zsort_step_reads_nothing_back(monkeypatch):
    """The step reads no value back to the host (the JAX step's "zero
    host sync"): every tensor method that would is made to raise."""
    step = tz.make_zsort_step(2)
    pts = [torch.from_numpy(_cloud(300, 17)), torch.from_numpy(_cloud(90))]
    arrays = [[torch.arange(300)], [torch.ones(90, 2, dtype=torch.float64)]]
    want = step(pts, arrays)

    def host_read(*args, **kwargs):
        raise AssertionError("the step read a value back to the host")

    for name in ("item", "tolist", "numpy", "cpu", "__bool__", "__int__",
                 "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, host_read)
    got = step(pts, arrays)
    monkeypatch.undo()
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(g, w)


# ---------------------------------------------------------- errors
def test_apply_zsort_errors_follow_jax():
    eng = _port([_cloud(10), _cloud(4, 1)], 0.1)
    eng.prepare_zsort()
    with pytest.raises(ValueError, match="cannot be reordered"):
        eng.apply_zsort(0, np.zeros(11, np.float32))
    with pytest.raises(ValueError, match="cannot be reordered"):
        eng.apply_zsort_batch(1, [np.zeros(4), torch.zeros(6)])
    with pytest.raises(IndexError):
        eng.apply_zsort(2, np.zeros(10))
    with pytest.raises(IndexError):
        eng.get_zsort_order(-1)
    with pytest.raises(ValueError, match="strides"):
        eng.apply_zsort_batch(0, [np.zeros(10), np.zeros(30)], strides=[1])
    with pytest.raises(RuntimeError, match="no point sets"):
        TreeNSearch(device="cpu").prepare_zsort()


def test_empty_set_returns_its_array_untouched():
    eng = _port([_cloud(0), _cloud(5)], 0.1)
    eng.prepare_zsort()
    a = np.arange(6.0)
    assert eng.apply_zsort(0, a) is a and np.array_equal(a, np.arange(6.0))
    assert eng.get_zsort_order(0).shape == (0,)
    assert eng.apply_zsort_batch(0, []) == []


# -------------------------------------- the small sets, round trip
@pytest.mark.parametrize("counts", SMALL_SETS, ids=str)
def test_small_sets_zsort_round_trip_vs_oracle(counts):
    """``test_combinatorial_small_sets``' shapes (empty sets, the
    127/128/129 and 255-257 tile edges): ``run()``, the z-sort round trip
    of every set, ``run()`` again; the second run equals the oracle on the
    reordered points, and its sets mapped through the orders equal the
    first run's."""
    rng = np.random.default_rng(sum(counts) + len(counts))
    sets = [rng.uniform(0, 1, (c, 3)).astype(np.float32) for c in counts]
    eng = _port(sets, 0.3, run=True)
    pairs = [(i, j) for i in range(len(sets)) for j in range(len(sets))]
    before = {p: _sets_of(eng, *p) for p in pairs}
    eng.prepare_zsort()
    orders = _orders(eng)
    reordered = [eng.apply_zsort(k, np.array(p)) for k, p in enumerate(sets)]
    for k, p in enumerate(reordered):
        assert np.array_equal(p, sets[k][orders[k]])
        eng.resize_point_set(k, p)
    eng.run()
    orc = BruteforceNSearch(search_radius=0.3)
    for p in reordered:
        orc.add_point_set(p)
    orc.set_all_searches(True)
    orc.run()
    orc.compare(eng)
    for (i, j) in pairs:
        after = _sets_of(eng, i, j)
        assert [{int(orders[j][c]) for c in after[q]}
                for q in range(counts[i])] \
            == [before[(i, j)][orders[i][q]] for q in range(counts[i])]
