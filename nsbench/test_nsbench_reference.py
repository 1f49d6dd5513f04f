"""The benchmark's reference and least-time counter on small clouds, on
the CPU: held against brute force.

    python -m pytest nsbench -q -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from nsbench import reference as ref
from nsbench import roofline


def cloud(seed: int, n: int, lo: float = 0.0, hi: float = 1.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, (n, 3)).astype(np.float32)


def at(radius: float, *sets) -> tuple:
    """Each numpy set's points at one radius, for the brute force."""
    return tuple(np.full(len(p), radius, dtype=np.float32) for p in sets)


def uniform(radius: float, *sets) -> tuple:
    """``reference.uniform`` of numpy sets."""
    return ref.uniform(radius, *(torch.from_numpy(p) for p in sets))


@pytest.mark.parametrize("n,radius,block", [(1500, 0.08, 1 << 25),
                                            (1500, 0.08, 500),
                                            (800, 0.3, 1 << 25),
                                            (2, 0.5, 1 << 25)])
def test_one_set_against_brute_force(n, radius, block):
    p = cloud(n, n)
    counts, keys = ref.neighbor_keys(torch.from_numpy(p),
                                     torch.from_numpy(p),
                                     uniform(radius, p, p), True,
                                     max_candidates=block)
    c_bf, k_bf = ref.brute_force_keys(p, p, at(radius, p, p), True)
    assert np.array_equal(counts.numpy(), c_bf)
    assert np.array_equal(keys.numpy(), k_bf)
    assert keys.shape[0] > 0 or n == 2


def test_three_sets_all_pairs_against_brute_force():
    sets = [cloud(1, 1200), cloud(2, 300, 0.1, 0.9), cloud(3, 100, -0.2, 1.2)]
    radius = 0.09
    for i, q in enumerate(sets):
        for j, c in enumerate(sets):
            counts, keys = ref.neighbor_keys(torch.from_numpy(q),
                                             torch.from_numpy(c),
                                             uniform(radius, q, c), i == j,
                                             max_candidates=700)
            c_bf, k_bf = ref.brute_force_keys(q, c, at(radius, q, c),
                                              i == j)
            assert np.array_equal(counts.numpy(), c_bf), (i, j)
            assert np.array_equal(keys.numpy(), k_bf), (i, j)


def test_boundary_pairs_follow_the_float32_rule():
    """Pairs at exactly the radius along an axis, and one float32 step
    beyond it."""
    r = np.float32(0.25)
    x = np.float32(0.5)
    q = np.array([[x, x, x]], dtype=np.float32)
    c = np.array([[x + r, x, x], [np.nextafter(x + r, np.float32(2)), x, x],
                  [x, x - r, x]], dtype=np.float32)
    counts, keys = ref.neighbor_keys(torch.from_numpy(q),
                                     torch.from_numpy(c),
                                     uniform(float(r), q, c), False)
    c_bf, k_bf = ref.brute_force_keys(q, c, at(float(r), q, c), False)
    assert np.array_equal(counts.numpy(), c_bf)
    assert np.array_equal(keys.numpy(), k_bf)


def test_density_sums_against_float64_brute_force():
    q, c = cloud(4, 700), cloud(5, 900)
    radius = 0.12
    h2 = np.float32(radius * radius)
    mass_q = np.random.default_rng(6).uniform(0.5, 1.5, (700, 2))
    mass_c = np.random.default_rng(7).uniform(0.5, 1.5, (900, 2))

    def fn(env):
        w = h2 - env["d2"]
        return env["p0_j"] * (w * w * w), env["p1_i"] * env["dx"]

    sums, mags, pairs = ref.pair_sums(
        fn, 2, torch.from_numpy(q), torch.from_numpy(c),
        uniform(radius, q, c), False,
        torch.from_numpy(mass_q).float(), torch.from_numpy(mass_c).float(),
        max_candidates=1000)
    d = c[None].astype(np.float64) - q[:, None].astype(np.float64)
    d32 = c[None] - q[:, None]
    d2_32 = (d32[..., 0] * d32[..., 0] + d32[..., 1] * d32[..., 1]) \
        + d32[..., 2] * d32[..., 2]
    hit = d2_32 <= np.float32(radius) * np.float32(radius)
    d2 = (d[..., 0] ** 2 + d[..., 1] ** 2) + d[..., 2] ** 2
    m_c = mass_c[:, 0].astype(np.float32).astype(np.float64)
    m_q = mass_q[:, 1].astype(np.float32).astype(np.float64)
    want0 = np.where(hit, m_c[None] * (np.float64(h2) - d2) ** 3, 0).sum(1)
    want1 = np.where(hit, m_q[:, None] * d[..., 0], 0).sum(1)
    assert pairs == int(hit.sum()) > 0
    np.testing.assert_allclose(sums[0].numpy(), want0, rtol=1e-12,
                               atol=1e-18)
    np.testing.assert_allclose(sums[1].numpy(), want1, rtol=1e-9,
                               atol=1e-15)
    assert (mags[0].numpy() >= np.abs(sums[0].numpy())).all()


def morton_by_hand(ijk) -> int:
    key = 0
    for b in range(20):
        for axis in range(3):
            key |= ((int(ijk[axis]) >> b) & 1) << (3 * b + axis)
    return key


def test_morton_keys_by_hand():
    p = cloud(8, 200, -1.0, 3.0)
    lo, hi = p.min(0), p.max(0)
    keys = ref.morton_keys(torch.from_numpy(p), torch.from_numpy(lo),
                           torch.from_numpy(hi)).numpy()
    extent = np.float32(max(hi - lo))
    scale = np.float32(1 << 20) / extent
    ijk = np.clip((p - lo) * scale, 0, (1 << 20) - 1).astype(np.int64)
    assert [morton_by_hand(r) for r in ijk] == keys.tolist()


def test_advance_stays_in_the_periodic_box():
    x = torch.tensor([[0.99995, 0.00001, 0.5]])
    v = torch.tensor([[1e-4, -1e-4, 0.0]])
    y = ref.advance(x, v, 3)
    assert ((y >= 0) & (y <= 1)).all()
    assert torch.equal(y, ref.advance(ref.advance(x, v, 1), v, 2))


def brute_force_stencil_tests(sets, active, cell) -> int:
    allp = np.concatenate([s for s in sets if len(s)]).astype(np.float64)
    lo = allp.min(0)
    cells = [np.floor((s.astype(np.float64) - lo) / cell).astype(np.int64)
             for s in sets]
    tests = 0
    for i, j in active:
        near = (np.abs(cells[i][:, None, :] - cells[j][None, :, :]) <= 1) \
            .all(2)
        tests += int(near.sum()) - (len(sets[i]) if i == j else 0)
    return tests


@pytest.mark.parametrize("active", [[(0, 0)], [(0, 0), (0, 1), (1, 2)],
                                    [(i, j) for i in range(3)
                                     for j in range(3)]])
def test_stencil_tests_against_brute_force(active):
    sets = [cloud(9, 900), cloud(10, 300, 0.2, 1.1), cloud(11, 50, -0.3, 0.4)]
    cell = 0.07
    got = roofline.stencil_tests([torch.from_numpy(s) for s in sets],
                                 active, cell, list(uniform(0.06, *sets)))
    assert got == brute_force_stencil_tests(sets, active, cell) > 0


def test_least_time_counts_bytes_and_operations():
    lt = roofline.least_time(tests=1000, hits=100, n_points=50, n_queries=50)
    assert lt["ops"] == 9000 and lt["bytes"] == 12 * 50 + 4 * 50 + 4 * 100
    assert lt["bound_by"] == "bytes"
    red = roofline.least_time(10 ** 9, 10 ** 8, 10, 10, ops_per_hit=5,
                              payload_columns=1, n_out=1)
    assert red["ops"] == 9 * 10 ** 9 + 5 * 10 ** 8
    assert red["bound_by"] == "operations"
    assert red["least_ms"] == pytest.approx(red["ops"] / 67e12 * 1e3)


def radii_of(seed: int, n: int, low: float = 0.8, high: float = 1.25,
             scale: float = 0.07) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.uniform(low, high, n) * scale).astype(np.float32)


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("same_set,block", [(True, 1 << 25), (True, 3000),
                                            (False, 1 << 25)])
def test_variable_rule_against_brute_force(symmetric, same_set, block):
    q, rq = cloud(12, 2500), radii_of(13, 2500)
    c, rc = (q, rq) if same_set else (cloud(14, 1800, 0.1, 1.1),
                                      radii_of(15, 1800, 0.5, 1.6))
    counts, keys = ref.neighbor_keys(
        torch.from_numpy(q), torch.from_numpy(c),
        (torch.from_numpy(rq), torch.from_numpy(rc)), same_set,
        max_candidates=block,
        symmetric=symmetric)
    c_bf, k_bf = ref.brute_force_keys(q, c, (rq, rc), same_set, symmetric)
    assert np.array_equal(counts.numpy(), c_bf)
    assert np.array_equal(keys.numpy(), k_bf)
    one_sided = ref.brute_force_keys(q, c, (rq, rc), same_set, False)
    assert k_bf.shape[0] > one_sided[1].shape[0] if symmetric \
        else np.array_equal(k_bf, one_sided[1])


def brute_force_reach_tests(sets, radii, active, cell, symmetric) -> int:
    """Each query against the points of set j whose cells lie within its
    reach's ``ceil(reach / cell)`` (at least 1) cells along every axis."""
    allp = np.concatenate([s for s in sets if len(s)]).astype(np.float64)
    lo = allp.min(0)
    cells = [np.floor((s.astype(np.float64) - lo) / cell).astype(np.int64)
             for s in sets]
    tests = 0
    for i, j in active:
        reach = radii[i].astype(np.float64)
        if symmetric:
            reach = np.maximum(reach, np.float64(radii[j].max()))
        w = np.maximum(np.ceil(reach / cell), 1).astype(np.int64)
        near = (np.abs(cells[i][:, None, :] - cells[j][None, :, :])
                <= w[:, None, None]).all(2)
        tests += int(near.sum()) - (len(sets[i]) if i == j else 0)
    return tests


@pytest.mark.parametrize("symmetric", [False, True])
def test_variable_stencil_tests_against_brute_force(symmetric):
    sets = [cloud(16, 900), cloud(17, 300, 0.2, 1.1)]
    radii = [radii_of(18, 900, scale=0.06), radii_of(19, 300, 0.5, 2.0, 0.06)]
    active = [(0, 0), (0, 1), (1, 0)]
    cell = 0.05
    got = roofline.stencil_tests([torch.from_numpy(s) for s in sets], active,
                                 cell, [torch.from_numpy(r) for r in radii],
                                 symmetric)
    want = brute_force_reach_tests(sets, radii, active, cell, symmetric)
    assert got == want > brute_force_stencil_tests(sets, active, cell)


@pytest.mark.parametrize("active", [[(0, 0)], [(0, 0), (0, 1), (1, 2)]])
def test_equal_radii_count_as_one_radius(active):
    """At one radius no wider than the cell, a query counts the 27 cells
    around its own, symmetric or not."""
    sets = [cloud(9, 900), cloud(10, 300, 0.2, 1.1), cloud(11, 50, -0.3, 0.4)]
    cell = 0.07
    pts = [torch.from_numpy(s) for s in sets]
    fixed = brute_force_stencil_tests(sets, active, cell)
    for radius in (0.06, cell):
        radii = list(uniform(radius, *sets))
        for symmetric in (False, True):
            assert roofline.stencil_tests(pts, active, cell, radii,
                                          symmetric) == fixed


def test_least_time_counts_the_symmetric_compare():
    one = roofline.least_time(10 ** 9, 100, 50, 50)
    both = roofline.least_time(10 ** 9, 100, 50, 50, symmetric=True)
    assert (one["ops"], both["ops"]) == (9 * 10 ** 9, 10 * 10 ** 9)
