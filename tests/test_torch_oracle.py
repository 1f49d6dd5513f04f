"""The port's oracles (``treensearch_tpu_torch.oracle`` and
``treensearch_tpu_torch.native_oracle``) against the JAX package's, and
BASELINE config 5's shape at 1/500 of its size through the port's
``run()`` on the CPU against the port's native oracle on all nine pairs,
the JAX engine's ``run_scalar()`` (its search-based pipeline, documented
to give ``run()``'s lists) on all nine, and the JAX engine's ``run()`` on
the fluid's queries against the emitter (``RUN_PAIR``: on the CPU
``run()`` costs about 3 s per active pair, ``run_scalar()`` about 6 s for
all nine).

Tolerance: the oracles are exact, so their lists are equal.  Against the
JAX engine, sets are exact except for a pair whose float64 d^2 lies
within 4 ulp of r^2, because XLA on the CPU may contract to FMA where
eager PyTorch does not (``test_torch_sets.py``); such pairs are reported.
No JAX fused step is compiled here.
"""

import warnings

import numpy as np
import pytest

from treensearch_tpu import TreeNSearch as JaxTreeNSearch
from treensearch_tpu import native_oracle as jax_native
from treensearch_tpu.oracle import BruteforceNSearch as JaxBruteforce
from treensearch_tpu_torch import TreeNSearch
from treensearch_tpu_torch import native_oracle as no
from treensearch_tpu_torch.oracle import BruteforceNSearch

needs_gxx = pytest.mark.skipif(not no.available(), reason="no g++")


def _cloud(case):
    """(sets [(points, radii or None)], radius or None, active pairs or
    None for all, symmetric) of one seeded cloud."""
    rng = np.random.default_rng(11)

    def pts(n):
        return rng.uniform(0, 1, (n, 3)).astype(np.float32)

    def rad(n, lo, hi):
        return rng.uniform(lo, hi, n).astype(np.float32)

    if case == "fixed":
        return [(pts(700), None)], 0.09, None, True
    if case in ("variable_symmetric", "variable_asymmetric"):
        sets = [(pts(400), rad(400, 0.05, 0.15)),
                (pts(300), rad(300, 0.05, 0.15))]
        return sets, None, None, case == "variable_symmetric"
    if case == "three_sets":
        active = [(0, 0), (0, 2), (1, 0), (2, 1)]
        return [(pts(500), None), (pts(300), None), (pts(200), None)], \
            0.1, active, True
    if case == "empty_set":
        return [(pts(400), None), (pts(0), None), (pts(150), None)], \
            0.1, None, True
    raise ValueError(case)


CASES = ["fixed", "variable_symmetric", "variable_asymmetric",
         "three_sets", "empty_set"]


def _oracle(cls, case):
    sets, r, active, symmetric = _cloud(case)
    orc = cls(search_radius=r, symmetric=symmetric)
    for p, q in sets:
        orc.add_point_set(p, q)
    if active is None:
        orc.set_all_searches(True)
    else:
        for i, j in active:
            orc.set_active_search(i, j, True)
    orc.run()
    return orc


@pytest.mark.parametrize("case", CASES)
def test_bruteforce_equals_jax_oracle(case):
    port, ref = _oracle(BruteforceNSearch, case), _oracle(JaxBruteforce, case)
    assert port.neighbors.keys() == ref.neighbors.keys()
    assert np.array_equal(port.active, ref.active)
    for key, lists in ref.neighbors.items():
        assert len(port.neighbors[key]) == len(lists)
        for got, want in zip(port.neighbors[key], lists):
            assert got.dtype == want.dtype and np.array_equal(got, want), key
    assert port.check_for_symmetry() == ref.check_for_symmetry()
    if case == "variable_asymmetric":   # the rule really is asymmetric
        assert not port.check_for_symmetry()


def _engine(case, radius_scale=1.0):
    sets, r, active, symmetric = _cloud(case)
    eng = TreeNSearch(device="cpu")
    for p, q in sets:
        eng.add_point_set(p, None if q is None else q * radius_scale)
    if r is not None:
        eng.set_search_radius(r * radius_scale)
    eng.set_symmetric_search(symmetric)
    if active is None:
        eng.set_all_searches(True)
    else:
        for i, j in active:
            eng.set_active_search(i, j, True)
    eng.run()
    return eng


@pytest.mark.parametrize("case", ["three_sets", "variable_symmetric"])
def test_compare_reads_the_port_engine(case):
    orc = _oracle(BruteforceNSearch, case)
    assert orc.compare(_engine(case))
    # a larger radius finds more neighbors: compare reports, or raises
    wider = _engine(case, radius_scale=1.2)
    assert not orc.compare(wider, crash=False)
    with pytest.raises(AssertionError, match="neighbor mismatch"):
        orc.compare(wider)


def _pair_args(case):
    """Each active pair's ``grid_search_pair`` arguments."""
    sets, r, active, symmetric = _cloud(case)
    n = len(sets)
    pairs = active or [(i, j) for i in range(n) for j in range(n)]
    out = []
    for i, j in pairs:
        (pi, ri), (pj, rj) = sets[i], sets[j]
        kw = {"same_set": i == j}
        if ri is None:
            kw["radius"] = r
        else:
            kw.update(radii_i=ri, radii_j=rj, symmetric=symmetric)
        out.append(((i, j), pi, pj, kw))
    return out


@needs_gxx
@pytest.mark.parametrize("case", CASES)
def test_grid_search_pair_equals_jax_native(case):
    orc = _oracle(BruteforceNSearch, case)
    for key, pi, pj, kw in _pair_args(case):
        counts, offs, nbrs = no.grid_search_pair(pi, pj, **kw)
        rc, ro, rn = jax_native.grid_search_pair(pi, pj, **kw)
        assert counts.dtype == np.int32 and offs.dtype == np.int64
        assert np.array_equal(counts, rc) and np.array_equal(offs, ro)
        assert nbrs.shape == rn.shape
        for i in range(pi.shape[0]):
            got = np.sort(nbrs[offs[i]:offs[i + 1]])
            assert np.array_equal(got, np.sort(rn[ro[i]:ro[i + 1]])), key
            assert np.array_equal(got, orc.neighbors[key][i]), key


@needs_gxx
def test_native_build_is_named_by_source_and_raises_on_failure(
        monkeypatch, tmp_path):
    built = no.build(tmp_path / "a")
    assert built.name.startswith("nsgrid_") and built.suffix == ".so"
    assert no.build(tmp_path / "a") == built   # cached by its hash
    assert [p.name for p in (tmp_path / "a").iterdir()] == [built.name]
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(no, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        no.build(tmp_path / "b")
    # no partial library is left behind
    assert list((tmp_path / "b").iterdir()) == []


def test_native_oracle_needs_gxx(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    assert not no.available()
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        no.build(tmp_path / "build")


def test_native_oracle_does_not_use_the_jax_build():
    src = open(no.__file__).read()
    assert "native.build" not in src and "libnsgrid" not in src


# ---------------------------------------------------- config 5 at 1/500
SCALE = 500
N5 = (16_000, 3_000, 1_000)     # 8M, 1.5M, 0.5M over 500
R5 = float(np.float32(0.009 * SCALE ** (1 / 3)))
CAPS5 = (64, 16, 8)


def _config5_sets():
    rng = np.random.default_rng(0)
    return [rng.uniform(0, 1, (n, 3)).astype(np.float32) for n in N5]


def _config5(eng, sets):
    """``benchmarks/bench_10m_cfg5.py:36-82``'s settings at this scale."""
    for p in sets:
        eng.add_point_set(p)
    eng.set_search_radius(R5)
    eng.set_all_searches(True)
    eng.set_cell_size(1.1 * R5)
    eng.set_neighbor_cap(CAPS5[0])
    eng.set_neighbor_cap(CAPS5[1], set_j=1)
    eng.set_neighbor_cap(CAPS5[2], set_j=2)
    eng.set_coherence(False)
    return eng


def _keys(counts, rows, n_j):
    """Sorted int64 keys ``i * n_j + j`` of a pair's neighbor lists, from
    padded rows (n_i, cap) masked by ``counts``, or from CSR (``rows`` 1-D
    in the order of ``counts``)."""
    counts = np.asarray(counts)
    q = np.repeat(np.arange(counts.size, dtype=np.int64), counts)
    rows = np.asarray(rows)
    if rows.ndim == 2:
        rows = rows[np.arange(rows.shape[1])[None, :] < counts[:, None]]
    return np.sort(q * n_j + rows.astype(np.int64))


RUN_PAIR = (0, 2)   # 16k queries, cross-set, the narrowest cap


@needs_gxx
def test_config5_at_1_500_vs_native_oracle_and_jax():
    sets = _config5_sets()
    eng = _config5(TreeNSearch(device="cpu"), sets)
    eng.run()
    assert eng._last_stats["path"] == "fast"
    jscalar = _config5(JaxTreeNSearch(), sets)
    jscalar.run_scalar()
    jrun = _config5(JaxTreeNSearch(), sets)
    jrun.set_all_searches(False)
    jrun.set_active_search(*RUN_PAIR, True)
    jrun.run()
    r2 = float(np.float32(R5) * np.float32(R5))
    want, boundary = {}, []
    for i in range(3):
        for j in range(3):
            counts, _, nbrs = no.grid_search_pair(sets[i], sets[j],
                                                  radius=R5, same_set=i == j)
            want[i, j] = counts, _keys(counts, nbrs, N5[j])
            pc, pn = (t.numpy() for t in eng.get_neighbors(i, j))
            assert pn.shape[1] == CAPS5[j] and pc.max() <= CAPS5[j]
            assert np.array_equal(pc, counts), (i, j)
            got = _keys(pc, pn, N5[j])
            assert np.array_equal(got, want[i, j][1]), (i, j)
            jax_engines = [jscalar] + [jrun] * ((i, j) == RUN_PAIR)
            for jeng in jax_engines:
                jc, jn = (np.asarray(a) for a in jeng.get_neighbors(i, j))
                for key in np.setxor1d(_keys(jc, jn, N5[j]), got):
                    k, m = divmod(int(key), N5[j])
                    d2 = float(np.sum((sets[j][m].astype(np.float64)
                                       - sets[i][k]) ** 2))
                    assert abs(d2 - r2) <= \
                        4 * float(np.spacing(np.float32(r2))), \
                        (i, j, k, m, d2)
                    boundary.append((i, j, k, m))
    if boundary:
        warnings.warn(f"{len(boundary)} pairs at the radius differ between "
                      f"XLA and PyTorch rounding: {boundary[:8]}")

    # the fluid's cap at 4 overflows and regrows to the same lists
    eng.set_neighbor_cap(4, set_j=0)
    eng.run()
    assert eng._cap_of(0) > 4 and eng._cap_of(1) == CAPS5[1]
    for i in range(3):
        for j in range(3):
            pc, pn = (t.numpy() for t in eng.get_neighbors(i, j))
            assert np.array_equal(pc, want[i, j][0]), (i, j)
            assert np.array_equal(_keys(pc, pn, N5[j]), want[i, j][1]), \
                (i, j)
