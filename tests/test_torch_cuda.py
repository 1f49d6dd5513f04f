"""The CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: every test skips without a CUDA device.  The file imports
nothing of JAX, so on a machine with the card and no JAX it runs without
the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: query tiles bit-equal; counts equal; rows equal slot for slot
(both versions keep the first k8 survivors in window order, so rows agree
exactly, truncated ones included), per candidate-set block for K2b and
K2c; dead tiles count 0.  K4: bits equal word for word.  K5: counts equal
on every slot, rows slot for slot on live tiles, and per active pair the
fused kernel's.  K3: integer-valued
legs equal, the others within 3e-5 of the sum of the terms' magnitudes
(only the order of the float32 sum differs).  K1r: query tiles and
padded records bit-equal.  The tile path and the search-based pipeline
on the card: neighbor sets equal to brute force, and to the CPU engine's
rows slot for slot.  Z-sort on the card: the per-point and
cell-granular orders equal the CPU engine's bit for bit.  The sharded
search's local fast path, rank by rank: counts equal and neighbor sets
equal to the one-device ``run()``.  K4 under a static row cap: counts
exact, the rows below the cap word for word.  The captured step: every
replay's ``rebuilt``, counts and rows equal to an eager step's, and a
conditional node's body runs only on a true predicate; the tile-path and
pipeline steps captured too, every replay's counts, ``max_count``, rows
and flags equal to an eager step's; the sharded step's buckets captured
over NCCL at world size 1 the same way, the eager step's counts equal to
the one-device ``run()``'s and its rows as sets.
"""

import ctypes

import numpy as np
import pytest
import torch

from treensearch_tpu_torch import TreeNSearch
from treensearch_tpu_torch.config import SearchConfig, round_up
from treensearch_tpu_torch.ops import fastpath as fp
from treensearch_tpu_torch.ops import pairs
from treensearch_tpu_torch.ops import reduce as red
from treensearch_tpu_torch.ops.grid import fresh_state, update_grid

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _column(n, rng):
    # a thin column: windows far wider than one 256-candidate chunk and
    # counts far past a small cap
    return np.stack([rng.uniform(0.5, 0.52, n), rng.uniform(0.5, 0.52, n),
                     rng.uniform(0, 1, n)], 1)


# name: (points, radius, cell, nbr_cap)
CASES = {
    "one_point": (lambda rng: np.zeros((1, 3)), 0.1, 0.1, 8),
    "tile_edge_129": (lambda rng: rng.uniform(0, 1, (129, 3)), 0.3, 0.33, 16),
    "wide_windows_truncated": (lambda rng: _column(3000, rng), 0.02, 0.023,
                               8),
    "uniform_20k": (lambda rng: rng.uniform(0, 1, (20_000, 3)), 0.03,
                    0.0345, 64),
}


@pytest.mark.parametrize("case", list(CASES))
def test_kernels_match_plain_on_card(dev, case):
    make, r, cell, cap = CASES[case]
    pts = torch.from_numpy(make(np.random.default_rng(0))
                           .astype(np.float32)).to(dev)
    n = pts.shape[0]
    # the engine's caps after one run(), then its prep at the case's cap
    eng = TreeNSearch(device=dev)
    eng.add_point_set(pts)
    eng.set_search_radius(r)
    eng.set_cell_size(cell)
    eng.set_all_searches(True)
    eng.run()
    cfg = SearchConfig((n,), ((0, 0),), 1, cap)
    knobs = eng._knobs()
    carry = fp._prep(pts, eng._grid_state, cfg, knobs,
                     consts=fp.step_constants(cfg, knobs, cell, dev,
                                              search_radius=r))
    assert int(carry.dense_overflow) == 0 and int(carry.rows_overflow) == 0
    assert int(carry.tile_overflow) == 0
    a = fp.kernel_inputs(pts, r, carry, cfg, knobs)
    recs, tiles_cap, n_win, r2 = a.recs_t, a.tiles_cap, a.n_win, a.r2
    k8 = a.k8s[0]
    assert (n_win, k8) == (9, round_up(cap, 8))
    assert fp.pairs_kernel(a) is pairs.pairs_nbrs_fixed
    before = (pairs.expand_query_tiles.launches,
              pairs.pairs_nbrs_fixed.launches)
    q = pairs.expand_query_tiles(carry.desc, recs, tiles_cap, n)
    assert torch.equal(q, pairs.expand_query_tiles_plain(carry.desc, recs,
                                                         tiles_cap, n))
    c_k, nb_k = pairs.pairs_nbrs_fixed(carry.desc, q, recs, r2, n_win, k8,
                                       tiles_cap)
    c_p, nb_p = pairs.pairs_nbrs_fixed_plain(carry.desc, q, recs, r2, n_win,
                                             k8, tiles_cap)
    torch.cuda.synchronize()
    assert (pairs.expand_query_tiles.launches,
            pairs.pairs_nbrs_fixed.launches) == (before[0] + 1, before[1] + 1)
    live = carry.desc[:tiles_cap, pairs.FAT_COL] != 2
    assert torch.equal(c_k.view(tiles_cap, 128)[live],
                       c_p.view(tiles_cap, 128)[live])
    assert torch.equal(nb_k[live], nb_p[live])
    if case == "wide_windows_truncated":
        assert int(carry.win_max) > 256 and int(c_k.max()) > k8


def test_clipped_ranges_match_plain_on_card(dev):
    # descriptors whose ranges run past the records: the kernels clip them
    # exactly as the plain versions do (and read nothing outside)
    pts = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (3000, 3))
                           .astype(np.float32)).to(dev)
    n = pts.shape[0]
    cfg = SearchConfig((n,), ((0, 0),), 1, 32)
    knobs = fp.FastKnobs(dense_cap=1 << 18, tiles_cap=1200)
    consts = fp.step_constants(cfg, knobs, 0.08, dev, search_radius=0.0)
    carry = fp._prep(pts, update_grid(fresh_state(dev), pts,
                                      consts.cell_size), cfg, knobs,
                     consts=consts)
    assert int(carry.tile_overflow) == 0
    recs = fp.sorted_records(pts, carry.idx_s)
    desc = carry.desc.clone()
    live = torch.nonzero(desc[:, pairs.FAT_COL] == 0).flatten().tolist()
    desc[live[0], 0], desc[live[0], pairs.LENS_OFF] = n - 5, 1 << 20
    desc[live[1], 1] = -7
    desc[live[2], pairs.A_COL], desc[live[2], pairs.CNT_COL] = n - 3, 128
    q = pairs.expand_query_tiles(desc, recs, knobs.tiles_cap, n)
    assert torch.equal(q, pairs.expand_query_tiles_plain(
        desc, recs, knobs.tiles_cap, n))
    r2 = float(np.float32(0.07) * np.float32(0.07))
    c_k, nb_k = pairs.pairs_nbrs_fixed(desc, q, recs, r2, 9, 32,
                                       knobs.tiles_cap)
    c_p, nb_p = pairs.pairs_nbrs_fixed_plain(desc, q, recs, r2, 9, 32,
                                             knobs.tiles_cap)
    torch.cuda.synchronize()
    live = desc[:knobs.tiles_cap, pairs.FAT_COL] != 2
    assert torch.equal(c_k.view(-1, 128)[live], c_p.view(-1, 128)[live])
    assert torch.equal(nb_k[live], nb_p[live])


def test_engine_on_card_matches_brute_force(dev):
    pts = np.random.default_rng(1).uniform(0, 1, (2000, 3)).astype(np.float32)
    r = 0.08
    eng = TreeNSearch(device="cuda")
    eng.add_point_set(torch.from_numpy(pts).to(dev))
    eng.set_search_radius(r)
    eng.set_all_searches(True)
    eng.run()
    counts, nbrs = (t.cpu().numpy() for t in eng.get_neighbors(0, 0))
    d = pts[None, :, :] - pts[:, None, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    m = d2 <= np.float32(r) * np.float32(r)
    np.fill_diagonal(m, False)
    assert np.array_equal(counts, m.sum(1))
    for i in range(pts.shape[0]):
        assert np.array_equal(np.sort(nbrs[i, :counts[i]]),
                              np.nonzero(m[i])[0])


# ------------------------------------------------------------ K2b / K2c
def _settled(eng, caps=None):
    """A settled engine's prep and kernel inputs, optionally at other
    per-set row caps."""
    eng.run()
    points, radii = eng._assemble()
    bounds = eng._radius_bounds(radii)
    cfg = eng._make_cfg(eng._stencil_w(eng._effective_cell_size(bounds),
                                       bounds))
    if caps is not None:
        cfg = cfg._replace(nbr_caps=caps, nbr_cap=max(caps))
    knobs = eng._knobs()
    carry = fp._prep(points, eng._grid_state, cfg, knobs, radii,
                     consts=fp.step_constants(
                         cfg, knobs, float(eng._grid_state.cell_size),
                         points.device,
                         search_radius=eng._search_radius or 0.0))
    assert int(carry.tile_overflow) == 0 and int(carry.dense_overflow) == 0
    return carry, fp.kernel_inputs(points, eng._search_radius or 0.0, carry,
                                   cfg, knobs, radii)


def _sets_engine(dev, sets, r=None, symmetric=True, active=None):
    eng = TreeNSearch(device=dev)
    for pts, rad in sets:
        eng.add_point_set(torch.from_numpy(pts).to(dev),
                          None if rad is None else
                          torch.from_numpy(rad).to(dev))
    if r is not None:
        eng.set_search_radius(r)
    eng.set_symmetric_search(symmetric)
    if active is None:
        eng.set_all_searches(True)
    else:
        for i, j in active:
            eng.set_active_search(i, j, True)
    return eng


def _kernel_vs_plain(a, n, wrapper):
    before = wrapper.launches
    q = pairs.expand_query_tiles(a.desc, a.recs_t, a.tiles_cap, n)
    (c_k, nb_k), (c_p, nb_p) = fp.run_pairs(a, q), fp.run_pairs(a, q, True)
    torch.cuda.synchronize()
    assert fp.pairs_kernel(a) is wrapper and wrapper.launches == before + 1
    live = a.desc[:a.tiles_cap, pairs.FAT_COL] != 2
    dead = ~live
    assert dead.any()   # the layout's slack tiles
    assert int(c_k.view(len(a.k8s), a.tiles_cap, 128)[:, dead].abs().sum()) \
        == 0
    for b in range(len(a.k8s)):
        assert torch.equal(c_k[b].view(a.tiles_cap, 128)[live],
                           c_p[b].view(a.tiles_cap, 128)[live]), b
        assert torch.equal(nb_k[b][live], nb_p[b][live]), b
    return c_k


def test_k2b_eight_candidate_blocks(dev):
    rng = np.random.default_rng(5)
    sets = [(rng.uniform(0, 1, (400 + 50 * k, 3)).astype(np.float32), None)
            for k in range(8)]
    eng = _sets_engine(dev, sets, r=0.12)
    _, a = _settled(eng)
    assert a.cand_sets == tuple(range(8)) and a.multi_set
    c = _kernel_vs_plain(a, eng.get_total_n_points(), pairs.pairs_nbrs_sets)
    assert (c.amax(dim=1) > 0).all()


def test_k2b_block_cap_8_truncates(dev):
    rng = np.random.default_rng(6)
    fluid = rng.uniform(0, 1, (3000, 3)).astype(np.float32)
    wall = np.c_[rng.uniform(0, 1, (2000, 2)), np.zeros(2000)] \
        .astype(np.float32)
    eng = _sets_engine(dev, [(fluid, None), (wall, None)], r=0.06,
                       active=[(0, 0), (0, 1)])
    _, a = _settled(eng, caps=(80, 8))
    assert a.k8s == (80, 8)
    c = _kernel_vs_plain(a, 5000, pairs.pairs_nbrs_sets)
    assert int(c[1].max()) > 8


@pytest.mark.parametrize("symmetric", [True, False])
def test_k2c_variable_multi_set(dev, symmetric):
    rng = np.random.default_rng(7)
    sets = [(rng.uniform(0, 1, (m, 3)).astype(np.float32),
             rng.uniform(0.03, 0.07, m).astype(np.float32))
            for m in (2500, 1500)]
    eng = _sets_engine(dev, sets, symmetric=symmetric,
                       active=[(0, 0), (0, 1), (1, 0)])
    _, a = _settled(eng)
    assert a.variable and a.symmetric == symmetric and len(a.k8s) == 2
    assert a.n_win == 25
    _kernel_vs_plain(a, 4000, pairs.pairs_nbrs_variable)
    # and the engine's lists against numpy brute force
    for i, j in ((0, 0), (0, 1), (1, 0)):
        (pi, ri), (pj, rj) = sets[i], sets[j]
        d = pj[None, :, :] - pi[:, None, :]
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
            + d[..., 2] * d[..., 2]
        m = d2 <= (ri * ri)[:, None]
        if symmetric:
            m |= d2 <= (rj * rj)[None, :]
        if i == j:
            np.fill_diagonal(m, False)
        counts, nbrs = (t.cpu().numpy() for t in eng.get_neighbors(i, j))
        assert np.array_equal(counts, m.sum(1))
        for k in range(0, pi.shape[0], 5):
            assert np.array_equal(np.sort(nbrs[k, :counts[k]]),
                                  np.nonzero(m[k])[0])


def test_k2c_one_set_truncated_rows(dev):
    rng = np.random.default_rng(8)
    pts = _column(3000, rng).astype(np.float32)
    rad = rng.uniform(0.01, 0.03, 3000).astype(np.float32)
    eng = _sets_engine(dev, [(pts, rad)])
    _, a = _settled(eng, caps=(8,))
    c = _kernel_vs_plain(a, 3000, pairs.pairs_nbrs_variable)
    assert int(c.max()) > 8


# ------------------------------------------------------------ K3 / K4
def fn8(e):
    """Eight outputs over every env field kind (n_out = 8)."""
    return (torch.ones_like(e["d2"]), e["d2"], e["dx"] * e["p0_j"],
            e["orig_j"].float(), e["set_j"] * e["p1_i"] + e["set_i"],
            torch.exp(-e["d2"] * 50.0), e["r2_i"],
            torch.where(e["dz"] > 0, e["p1_j"], 0.0))


def fn_var(e):
    return (torch.ones_like(e["d2"]), e["d2"] * e["r_j"], e["r2_i"])


def fn_density(e):
    w = np.float32(0.02 * 0.02) - e["d2"]
    return e["p0_j"] * (w * w * w)


def _active_inputs(eng, payload=None):
    """A settled engine's K3/K4 inputs: kernel inputs with the payload,
    the allow table and the query tiles (and the prep's ``qpos``)."""
    eng.run()
    points, radii = eng._assemble()
    bounds = eng._radius_bounds(radii)
    cfg = eng._make_cfg(eng._stencil_w(eng._effective_cell_size(bounds),
                                       bounds))
    knobs = eng._knobs()
    carry = fp._prep(points, eng._grid_state, cfg, knobs, radii,
                     consts=fp.step_constants(
                         cfg, knobs, float(eng._grid_state.cell_size),
                         points.device,
                         search_radius=eng._search_radius or 0.0))
    assert int(carry.tile_overflow) == 0 and int(carry.dense_overflow) == 0
    a = fp.kernel_inputs(points, eng._search_radius or 0.0, carry, cfg,
                         knobs, radii, payload)
    allow = fp.allow_table(cfg, a.cand_sets, points.device)
    q = pairs.expand_query_tiles(a.desc, a.recs_t, a.tiles_cap,
                                 cfg.n_points)
    return a, allow, q, carry.qpos.long()


def _k3_vs_plain(a, allow, q, fn, n_out, exact):
    spec = red.ReduceSpec(fn, n_out, True)
    args = (a.desc, q, a.recs_t, a.n_win, a.tiles_cap)
    kw = fp.active_args(a)
    before = red.pairs_reduce.launches
    k = red.pairs_reduce(*args, spec, a.cand_sets, allow, **kw)
    p = red.pairs_reduce_plain(*args, spec, a.cand_sets, allow, **kw)

    def magnitudes(e):
        outs = fn(e)
        return tuple(torch.as_tensor(o).float().abs()
                     for o in (outs if isinstance(outs, tuple) else (outs,)))

    scale = red.pairs_reduce_plain(*args, red.ReduceSpec(magnitudes, n_out),
                                   a.cand_sets, allow, **kw)
    torch.cuda.synchronize()
    assert red.pairs_reduce.launches == before + 1
    live = (a.desc[:a.tiles_cap, pairs.FAT_COL] != 2).repeat_interleave(128)
    assert not k[:, ~live].any()
    for j in range(n_out):
        if j in exact:
            assert torch.equal(k[j], p[j]), j
        else:
            assert ((k[j] - p[j]).abs() <= 3e-5 * scale[j] + 1e-30).all(), j
    return k


def _k4_vs_plain(a, allow, q):
    args = (a.desc, q, a.recs_t, a.n_win, a.tiles_cap, a.cand_sets, allow)
    kw = fp.active_args(a)
    before = pairs.pairs_mask.launches
    c_k, b_k, base_k = pairs.pairs_mask(*args, **kw)
    c_p, b_p, base_p = pairs.pairs_mask_plain(*args, **kw)
    torch.cuda.synchronize()
    assert pairs.pairs_mask.launches == before + 1
    assert torch.equal(base_k, base_p)
    assert torch.equal(c_k, c_p) and torch.equal(b_k, b_p)
    return c_k


def test_k3_k4_eight_candidate_sets_and_a_set_that_searches_nothing(dev):
    rng = np.random.default_rng(9)
    sizes = [300 + 40 * k for k in range(9)]
    eng = _sets_engine(
        dev, [(rng.uniform(0, 1, (m, 3)).astype(np.float32), None)
              for m in sizes], r=0.12,
        active=[(i, (3 * i + 1) % 8) for i in range(8)]
        + [(i, i) for i in range(0, 8, 2)])   # set 8 searches nothing
    n = sum(sizes)
    payload = torch.from_numpy(rng.uniform(0.5, 1.5, (n, 2))
                               .astype(np.float32)).to(dev)
    a, allow, q, qpos = _active_inputs(eng, payload)
    assert a.cand_sets == tuple(range(8))
    k = _k3_vs_plain(a, allow, q, fn8, 8, exact=(0, 3, 6))
    c = _k4_vs_plain(a, allow, q)
    assert torch.equal(k[0], c.float())
    set8 = sum(sizes[:8])
    assert not c[qpos[set8:]].any()     # set 8 searches nothing
    assert c[qpos[:set8]].sum() > 0 and not k[6].any()   # r2_i = 0


def test_k3_k4_windows_wider_than_a_chunk_and_partial_tiles(dev):
    rng = np.random.default_rng(10)
    pts = _column(3000, rng).astype(np.float32)
    eng = _sets_engine(dev, [(pts, None)], r=0.02)
    eng.set_cell_size(0.023)
    payload = torch.from_numpy(rng.uniform(0.5, 1.5, (3000, 2))
                               .astype(np.float32)).to(dev)
    a, allow, q, _ = _active_inputs(eng, payload)
    assert int((a.desc[:a.tiles_cap, pairs.LENS_OFF:pairs.LENS_OFF + 9])
               .max()) > 256
    cnt = a.desc[:a.tiles_cap, pairs.CNT_COL]
    live = a.desc[:a.tiles_cap, pairs.FAT_COL] != 2
    assert ((cnt < 128) & live).any() and (~live).any()
    _k3_vs_plain(a, allow, q, fn_density, 1, exact=())
    _k4_vs_plain(a, allow, q)


@pytest.mark.parametrize("symmetric", [True, False])
def test_k3_k4_variable_multi_set(dev, symmetric):
    rng = np.random.default_rng(11)
    sets = [(rng.uniform(0, 1, (m, 3)).astype(np.float32),
             rng.uniform(0.03, 0.07, m).astype(np.float32))
            for m in (2500, 1500)]
    eng = _sets_engine(dev, sets, symmetric=symmetric,
                       active=[(0, 0), (0, 1), (1, 0)])
    a, allow, q, _ = _active_inputs(eng)
    assert a.variable and a.n_win == 25
    k = _k3_vs_plain(a, allow, q, fn_var, 3, exact=(0,))
    c = _k4_vs_plain(a, allow, q)
    assert torch.equal(k[0], c.float())


def test_engine_contracts_on_card_match_brute_force(dev):
    rng = np.random.default_rng(12)
    sets = [rng.uniform(0, 1, (m, 3)).astype(np.float32)
            for m in (1200, 800, 600)]
    active = [(0, 0), (0, 2), (1, 0)]
    eng = _sets_engine(dev, [(s, None) for s in sets], r=0.08,
                       active=active)
    allp = np.concatenate(sets)
    sid = np.repeat(np.arange(3), [len(s) for s in sets])
    d = allp[None, :, :] - allp[:, None, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    m = d2 <= np.float32(0.08) * np.float32(0.08)
    am = np.zeros((3, 3), bool)
    for i, j in active:
        am[i, j] = True
    m &= am[sid[:, None], sid[None, :]]
    np.fill_diagonal(m, False)
    got = torch.cat([eng.run_reduce(
        lambda e: (torch.ones_like(e["d2"]), e["orig_j"].float()), 2)[i]
        for i in range(3)]).cpu().numpy()
    assert np.array_equal(got[:, 0], m.sum(1))
    assert np.array_equal(got[:, 1], np.where(m, np.arange(2600), 0).sum(1))
    mask, meta = eng.run_mask()
    counts, (row_ptr, cols) = fp.decode_mask(mask, meta)
    assert np.array_equal(counts.cpu().numpy(), m.sum(1))
    row_ptr, cols = row_ptr.cpu().numpy(), cols.cpu().numpy()
    for i in range(0, 2600, 7):
        assert np.array_equal(cols[row_ptr[i]:row_ptr[i + 1]],
                              np.nonzero(m[i])[0])


def test_unsupported_callback_raises_on_card(dev):
    eng = _sets_engine(dev, [(np.random.default_rng(13).uniform(
        0, 1, (500, 3)).astype(np.float32), None)], r=0.1)
    before = red.pairs_reduce.launches
    with pytest.raises(TypeError, match="sin"):
        eng.run_reduce(lambda e: torch.sin(e["d2"]))
    with pytest.raises(TypeError, match="outputs"):
        eng.run_reduce(lambda e: (e["d2"], e["d2"]), 1)
    assert red.pairs_reduce.launches == before


# ------------------------------------------------------------------ K5
def _k5_vs_plain(a, bits, cand_base, k8s=None):
    """K5 on ``bits`` against its plain version: counts equal on every
    slot (dead tiles 0), rows equal slot for slot on live tiles."""
    args = (a.desc, a.recs_t, bits, cand_base, a.n_win, a.tiles_cap,
            a.cand_sets, a.cand_offsets, k8s or a.k8s)
    before = pairs.pairs_nbrs_from_bits.launches
    c_k, nb_k = pairs.pairs_nbrs_from_bits(*args)
    c_p, nb_p = pairs.pairs_nbrs_from_bits_plain(*args)
    torch.cuda.synchronize()
    assert pairs.pairs_nbrs_from_bits.launches == before + 1
    live = a.desc[:a.tiles_cap, pairs.FAT_COL] != 2
    assert (~live).any()   # the layout's slack tiles
    assert torch.equal(c_k, c_p)
    assert not c_k.view(len(c_k), a.tiles_cap, 128)[:, ~live].any()
    for b in range(len(c_k)):
        assert torch.equal(nb_k[b][live], nb_p[b][live]), b
    return c_k


def test_k5_eight_blocks_equals_plain_and_the_fused_kernel(dev):
    rng = np.random.default_rng(14)
    sizes = [300 + 40 * k for k in range(9)]
    eng = _sets_engine(
        dev, [(rng.uniform(0, 1, (m, 3)).astype(np.float32), None)
              for m in sizes], r=0.12,
        active=[(i, (3 * i + 1) % 8) for i in range(8)]
        + [(i, i) for i in range(0, 8, 2)])   # set 8 searches nothing
    a, allow, q, qpos = _active_inputs(eng)
    assert a.cand_sets == tuple(range(8))
    counts, bits, base = pairs.pairs_mask(a.desc, q, a.recs_t, a.n_win,
                                          a.tiles_cap, a.cand_sets, allow,
                                          r2=a.r2)
    c = _k5_vs_plain(a, bits, base)
    assert torch.equal(c.sum(0), counts) and (c.amax(dim=1) > 0).all()
    # per active pair, split staging's slots are the fused kernel's
    c_s, nb_s = fp.run_pairs(a, q, allow=allow)
    c_f, nb_f = fp.run_pairs(a, q)
    offs = np.cumsum([0] + sizes)
    for si, sj in eng._make_cfg(1).active_pairs:
        slots = qpos[offs[si]:offs[si + 1]]
        assert torch.equal(c_s[sj, slots], c_f[sj, slots])
        assert torch.equal(nb_s[sj][slots // 128, :, slots % 128],
                           nb_f[sj][slots // 128, :, slots % 128])


@pytest.mark.parametrize("word", [0, -1])
def test_k5_all_zero_and_all_one_words(dev, word):
    # synthetic bits over windows wider than a 256-row chunk: all zero
    # (nothing hits) or all one (every lane hits every candidate, past a
    # cap of 8)
    rng = np.random.default_rng(15)
    eng = _sets_engine(dev, [(_column(3000, rng).astype(np.float32), None)],
                       r=0.02)
    eng.set_cell_size(0.023)
    a, _, _, _ = _active_inputs(eng)
    base = pairs.mask_cand_base(a.desc, a.recs_t.shape[1], a.n_win,
                                a.tiles_cap)
    assert int(a.desc[:a.tiles_cap,
                      pairs.LENS_OFF:pairs.LENS_OFF + 9].max()) > 256
    bits = torch.full((int(base[-1]), pairs.MASK_WORDS), word,
                      dtype=torch.int32, device=dev)
    c = _k5_vs_plain(a, bits, base, k8s=(8,))
    if word == 0:
        assert not c.any()
    else:
        live = a.desc[:a.tiles_cap, pairs.FAT_COL] != 2
        per_tile = (base[1:] - base[:-1])[live]
        assert torch.equal(c[0].view(a.tiles_cap, 128)[live],
                           per_tile[:, None].int().expand(-1, 128))
        assert int(c.max()) > 8


def test_k5_truncated_rows_wide_windows_and_short_bits(dev):
    rng = np.random.default_rng(16)
    eng = _sets_engine(dev, [(_column(3000, rng).astype(np.float32), None)],
                       r=0.02)
    eng.set_cell_size(0.023)
    a, allow, q, _ = _active_inputs(eng)
    _, bits, base = pairs.pairs_mask(a.desc, q, a.recs_t, a.n_win,
                                     a.tiles_cap, a.cand_sets, allow,
                                     r2=a.r2)
    c = _k5_vs_plain(a, bits, base, k8s=(8,))
    assert int(c.max()) > 8
    # rows past the bits read as zero on the card as in the plain version
    _k5_vs_plain(a, bits[:bits.shape[0] // 3].contiguous(), base, k8s=(8,))


# ------------------------------------ the candidate streams of K2b/K2c/K4
def _window_desc(a, rng):
    """``a.desc`` with the windows of four live tiles rewritten (the other
    tiles keep theirs): lengths 0, 1, 255, 256 and 257 in one tile; 25
    short windows whose concatenation crosses several 256-candidate chunk
    boundaries, on a partial tile; every window empty; one window of 257
    in the last place.  Starts are random records."""
    desc = a.desc.clone()
    n_rec = a.recs_t.shape[1]
    tiles = desc[:a.tiles_cap]
    live = tiles[:, pairs.FAT_COL] != 2
    partial = torch.nonzero(live & (tiles[:, pairs.CNT_COL] < 128)) \
        .flatten().tolist()
    others = [t for t in torch.nonzero(live).flatten().tolist()
              if t != partial[0]]
    assert a.n_win == 25 and len(others) >= 3
    short = rng.integers(20, 70, 25).tolist()
    assert sum(short) > 3 * 256
    patterns = {others[0]: [0, 1, 255, 256, 257] + [0] * 20,
                partial[0]: short,
                others[len(others) // 2]: [0] * 25,
                others[-1]: [0] * 24 + [257]}
    for t, lens in patterns.items():
        for w, ln in enumerate(lens):
            desc[t, w] = int(rng.integers(0, n_rec - ln + 1))
            desc[t, pairs.LENS_OFF + w] = ln
    return desc


@pytest.mark.parametrize("mode", ["fixed", "variable", "symmetric"])
def test_k2_k4_streams_across_window_and_chunk_edges(dev, mode):
    # K2b (fixed) or K2c (variable, either symmetric setting) slot for
    # slot and K4's instance of the mode word for word, on windows that
    # start and end on and off the chunk edges, under an active matrix
    # with an inactive pair
    rng = np.random.default_rng(17)
    sets = [(rng.uniform(0, 1, (m, 3)).astype(np.float32),
             None if mode == "fixed" else
             rng.uniform(0.03, 0.07, m).astype(np.float32))
            for m in (2500, 1500)]
    eng = _sets_engine(dev, sets, r=0.1 if mode == "fixed" else None,
                       symmetric=mode == "symmetric",
                       active=[(0, 0), (0, 1), (1, 0)])
    if mode == "fixed":
        eng.set_cell_size(0.05)   # a 25-window stencil
    a, allow, _, _ = _active_inputs(eng)
    a = a._replace(desc=_window_desc(a, rng))
    wrapper = pairs.pairs_nbrs_sets if mode == "fixed" \
        else pairs.pairs_nbrs_variable
    c2 = _kernel_vs_plain(a, 4000, wrapper)
    q = pairs.expand_query_tiles(a.desc, a.recs_t, a.tiles_cap, 4000)
    c4 = _k4_vs_plain(a, allow, q)
    # K4's counts are K2's over the blocks each query's set searches
    q_set = q[pairs.F_SET].long()
    allowed = torch.where(q_set >= 0, allow[q_set.clamp(min=0)], 0)
    want = sum(((allowed >> b) & 1) * c2[b] for b in range(len(a.k8s)))
    assert torch.equal(c4, want.int())
    assert int(c4.sum()) > 0


@pytest.mark.parametrize("mode", ["fixed", "variable", "symmetric"])
def test_k2_k4_equal_plain_with_query_lanes_reversed(dev, mode):
    # the kernels exclude a query's own record by orig, as the plain
    # versions do, wherever the query sits in its tile: K1's tiles with
    # their lanes reversed (sentinel lanes first on partial tiles)
    rng = np.random.default_rng(19)
    sets = [(rng.uniform(0, 1, (m, 3)).astype(np.float32),
             None if mode == "fixed" else
             rng.uniform(0.03, 0.07, m).astype(np.float32))
            for m in (2500, 1500)]
    eng = _sets_engine(dev, sets, r=0.1 if mode == "fixed" else None,
                       symmetric=mode == "symmetric",
                       active=[(0, 0), (0, 1), (1, 0)])
    a, allow, q, _ = _active_inputs(eng)
    q = q.view(q.shape[0], a.tiles_cap, 128).flip(-1).reshape(q.shape) \
        .contiguous()
    (c_k, nb_k), (c_p, nb_p) = fp.run_pairs(a, q), fp.run_pairs(a, q, True)
    live = a.desc[:a.tiles_cap, pairs.FAT_COL] != 2
    for b in range(len(a.k8s)):
        assert torch.equal(c_k[b].view(a.tiles_cap, 128)[live],
                           c_p[b].view(a.tiles_cap, 128)[live]), b
        assert torch.equal(nb_k[b][live], nb_p[b][live]), b
    c4 = _k4_vs_plain(a, allow, q)
    assert int(c4.sum()) > 0


def test_k2b_k4_k5_eight_blocks_one_at_cap_8_under_an_active_matrix(dev):
    # eight candidate blocks, the densest at a cap of 8 (its rows
    # truncate), a third of the pairs inactive: K2b slot for slot, K4 word
    # for word, K5 on the new K4's bits against its plain version and,
    # per active pair, against the fused K2b
    rng = np.random.default_rng(18)
    sizes = [300 + 40 * k for k in range(7)] + [2500]
    sets = [(rng.uniform(0, 1, (m, 3)).astype(np.float32), None)
            for m in sizes]
    active = [(i, j) for i in range(8) for j in range(8) if (i + 2 * j) % 3]
    eng = _sets_engine(dev, sets, r=0.1, active=active)
    carry, a = _settled(eng, caps=(80,) * 7 + (8,))
    assert a.cand_sets == tuple(range(8)) and a.k8s[7] == 8
    n = sum(sizes)
    c2 = _kernel_vs_plain(a, n, pairs.pairs_nbrs_sets)
    assert int(c2[7].max()) > 8 and (c2.amax(dim=1) > 0).all()
    allow = fp.allow_table(eng._make_cfg(1), a.cand_sets, dev)
    q = pairs.expand_query_tiles(a.desc, a.recs_t, a.tiles_cap, n)
    c4 = _k4_vs_plain(a, allow, q)
    _, bits, base = pairs.pairs_mask(a.desc, q, a.recs_t, a.n_win,
                                     a.tiles_cap, a.cand_sets, allow,
                                     r2=a.r2)
    c5 = _k5_vs_plain(a, bits, base)
    assert torch.equal(c5.sum(0), c4)
    (c_s, nb_s), (c_f, nb_f) = fp.run_pairs(a, q, allow=allow), \
        fp.run_pairs(a, q)
    qpos = carry.qpos.long()
    offs = np.cumsum([0] + sizes)
    for si, sj in active:
        slots = qpos[offs[si]:offs[si + 1]]
        assert torch.equal(c_s[sj, slots], c_f[sj, slots])
        assert torch.equal(nb_s[sj][slots // 128, :, slots % 128],
                           nb_f[sj][slots // 128, :, slots % 128])


# ---------------------------------------------- the candidate stream of K5
def _stream_inputs(dev, rng, mode):
    """Kernel inputs on which to hold K5 against its plain version: two sets
    under an active matrix with an inactive pair (``fixed``, ``variable``
    or ``symmetric``, as the K2b/K2c/K4 stream tests), or one set at a fixed
    radius (``one_set``, K5's one-block instance); 25 windows each.
    Returns (inputs, allow table); 4000 points either way."""
    if mode == "one_set":
        eng, _ = _one_set_engine(dev, rng, "fixed")
    else:
        sets = [(rng.uniform(0, 1, (m, 3)).astype(np.float32),
                 None if mode == "fixed" else
                 rng.uniform(0.03, 0.07, m).astype(np.float32))
                for m in (2500, 1500)]
        eng = _sets_engine(dev, sets, r=0.1 if mode == "fixed" else None,
                           symmetric=mode == "symmetric",
                           active=[(0, 0), (0, 1), (1, 0)])
        if mode == "fixed":
            eng.set_cell_size(0.05)   # a 25-window stencil
    a, allow, _, _ = _active_inputs(eng)
    return a, allow


def _k5_on_k4(a, allow, q):
    """K4's bits of these inputs, then K5 on them against its plain version
    and, per block, summed against K4's counts; and split staging against
    the fused kernel on every slot whose query searches the block."""
    c4, bits, base = pairs.pairs_mask(a.desc, q, a.recs_t, a.n_win,
                                      a.tiles_cap, a.cand_sets, allow,
                                      **fp.active_args(a))
    c5 = _k5_vs_plain(a, bits, base)
    assert torch.equal(c5.sum(0), c4) and int(c4.sum()) > 0
    (c_s, nb_s), (c_f, nb_f) = fp.run_pairs(a, q, allow=allow), \
        fp.run_pairs(a, q)
    live = (a.desc[:a.tiles_cap, pairs.FAT_COL] != 2).repeat_interleave(128)
    q_set = q[pairs.F_SET].long()
    allowed = torch.where(q_set >= 0, allow[q_set.clamp(min=0)], 0)
    for b in range(len(a.k8s)):
        on = live & ((allowed >> b) & 1).bool()
        assert on.any()
        slots = torch.nonzero(on).flatten()
        assert torch.equal(c_s[b, slots], c_f[b, slots]), b
        assert torch.equal(nb_s[b][slots // 128, :, slots % 128],
                           nb_f[b][slots // 128, :, slots % 128]), b
    return c5


@pytest.mark.parametrize("mode", ["fixed", "variable", "symmetric",
                                  "one_set"])
def test_k5_streams_across_window_and_chunk_edges(dev, mode):
    # K5 on K4's bits over test_k2_k4_streams_across_window_and_chunk_edges'
    # windows (lengths 0, 1, 255, 256, 257; 25 short windows on a partial
    # tile; all empty; 257 in the last place): rows slot for slot against
    # the plain version and, per searched block, the fused kernel's
    rng = np.random.default_rng(17)
    a, allow = _stream_inputs(dev, rng, mode)
    a = a._replace(desc=_window_desc(a, rng))
    q = pairs.expand_query_tiles(a.desc, a.recs_t, a.tiles_cap, 4000)
    _k5_on_k4(a, allow, q)


@pytest.mark.parametrize("mode", ["fixed", "variable", "symmetric",
                                  "one_set"])
def test_k5_equals_plain_with_query_lanes_reversed(dev, mode):
    # K4's bits of K1's tiles with their lanes reversed (sentinel lanes
    # first on partial tiles), then K5 on them
    rng = np.random.default_rng(19)
    a, allow = _stream_inputs(dev, rng, mode)
    q = pairs.expand_query_tiles(a.desc, a.recs_t, a.tiles_cap, 4000)
    q = q.view(q.shape[0], a.tiles_cap, 128).flip(-1).reshape(q.shape) \
        .contiguous()
    _k5_on_k4(a, allow, q)


@pytest.mark.parametrize("lane", [37, 127])
def test_k5_one_lane_hits_a_whole_chunk_across_a_window_edge(dev, lane):
    # synthetic bits: one query lane hits every row of one 256-row chunk of
    # a tile's stream in whose middle one window ends and the next begins
    # (all-one words for that lane, zero elsewhere), so the drain's groups
    # cross the window edge with every bit of the lane's word set; the
    # stream-edge windows of _window_desc, one set
    rng = np.random.default_rng(27)
    a, _ = _stream_inputs(dev, rng, "one_set")
    a = a._replace(desc=_window_desc(a, rng))
    n_rec = a.recs_t.shape[1]
    base = pairs.mask_cand_base(a.desc, n_rec, a.n_win, a.tiles_cap)
    _, lens = pairs.clipped_windows(a.desc, n_rec, a.n_win, a.tiles_cap)
    ends = torch.cumsum(lens, 1).cpu()
    total = ends[:, -1]
    pick = None
    for t in range(a.tiles_cap):
        for e in ends[t, :-1].tolist():
            c = e // 256
            if e % 256 > 16 and (c + 1) * 256 <= int(total[t]):
                pick = (t, c)
                break
        if pick:
            break
    assert pick is not None
    t, c = pick
    bits = torch.zeros((int(base[-1]), pairs.MASK_WORDS), dtype=torch.int32,
                       device=dev)
    rows = int(base[t]) + 256 * c + torch.arange(256, device=dev)
    bits[rows, lane // 32] = int(np.uint32(1 << (lane % 32)).view(np.int32))
    # caps below, at and past the 32 entries a thread stages in shared
    # memory (past them the entries go straight to the row)
    for k8s in ((8,), (32,), (80,), (264,)):
        counts = _k5_vs_plain(a, bits, base, k8s=k8s)[0].view(-1, 128)
        assert int(counts[t, lane]) == 256 and int(counts.sum()) == 256


# ------------------------------------------ the candidate streams of K2a/K3
def fn_count_density(e):
    """The neighbor count and a poly6 density at h = 0.1 (n_out = 2)."""
    w = np.float32(0.1 * 0.1) - e["d2"]
    return torch.ones_like(e["d2"]), e["p0_j"] * (w * w * w)


def _one_set_engine(dev, rng, mode, n=4000):
    """One set of ``n`` uniform points with a payload: at r = 0.1 on a
    25-window stencil (``fixed``, K2a's inputs), or with radii in [0.03,
    0.07] and symmetric search (25 windows too)."""
    pts = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    rad = None if mode == "fixed" else \
        rng.uniform(0.03, 0.07, n).astype(np.float32)
    eng = _sets_engine(dev, [(pts, rad)], r=0.1 if mode == "fixed" else None,
                       symmetric=mode == "symmetric")
    if mode == "fixed":
        eng.set_cell_size(0.05)
    payload = torch.from_numpy(rng.uniform(0.5, 1.5, (n, 2))
                               .astype(np.float32)).to(dev)
    return eng, payload


@pytest.mark.parametrize("mode", ["fixed", "symmetric"])
def test_k2a_k3_streams_across_window_and_chunk_edges(dev, mode):
    # K2a (one set, fixed radius) slot for slot and K3 (the count equal,
    # the density within 3e-5 of the magnitudes) on windows that start and
    # end on and off the chunk edges; K3 also in symmetric mode
    rng = np.random.default_rng(21)
    eng, payload = _one_set_engine(dev, rng, mode)
    a, allow, _, _ = _active_inputs(eng, payload)
    a = a._replace(desc=_window_desc(a, rng))
    q = pairs.expand_query_tiles(a.desc, a.recs_t, a.tiles_cap, 4000)
    if mode == "fixed":
        c2 = _kernel_vs_plain(a, 4000, pairs.pairs_nbrs_fixed)
    k = _k3_vs_plain(a, allow, q, fn_count_density, 2, exact=(0,))
    if mode == "fixed":
        assert torch.equal(k[0], c2[0].float())
    assert int(k[0].sum()) > 0


@pytest.mark.parametrize("mode", ["fixed", "symmetric"])
def test_k2a_k3_equal_plain_with_query_lanes_reversed(dev, mode):
    # K2a and K3 exclude a query's own record by orig wherever the query
    # sits in its tile: K1's tiles with their lanes reversed
    rng = np.random.default_rng(23)
    eng, payload = _one_set_engine(dev, rng, mode)
    a, allow, q, _ = _active_inputs(eng, payload)
    q = q.view(q.shape[0], a.tiles_cap, 128).flip(-1).reshape(q.shape) \
        .contiguous()
    live = a.desc[:a.tiles_cap, pairs.FAT_COL] != 2
    if mode == "fixed":
        assert fp.pairs_kernel(a) is pairs.pairs_nbrs_fixed
        (c_k, nb_k), (c_p, nb_p) = fp.run_pairs(a, q), \
            fp.run_pairs(a, q, True)
        assert torch.equal(c_k[0].view(a.tiles_cap, 128)[live],
                           c_p[0].view(a.tiles_cap, 128)[live])
        assert torch.equal(nb_k[0][live], nb_p[0][live])
    k = _k3_vs_plain(a, allow, q, fn_count_density, 2, exact=(0,))
    assert int(k[0].sum()) > 0


def fn4_payload(e):
    """Four outputs of the payload, r_j and the displacement (n_out = 4,
    symmetric mode)."""
    return (torch.ones_like(e["d2"]), e["p0_j"] * e["d2"],
            e["r_j"] * e["p1_j"], e["p1_i"] * e["dx"])


def test_k2a_k3_one_lane_hits_a_whole_chunk(dev):
    # a dense cluster of 800 points, contiguous in sorted order, so the
    # stream of its tile holds at least one whole 256-candidate chunk of
    # it; in that tile, lane 5 sits at the cluster's centre as its first
    # point and every other lane far outside the cloud, so lane 5 hits
    # every candidate of that chunk and its neighbours none: K2a with its
    # rows truncated at k8 = 8 slot for slot, and K3 with n_out = 4 and a
    # payload callback in symmetric mode
    rng = np.random.default_rng(25)
    centre = np.float32([0.5, 0.5, 0.5])
    cluster = centre + rng.uniform(-2e-4, 2e-4, (800, 3)).astype(np.float32)
    pts = np.concatenate([cluster, rng.uniform(0, 1, (3000, 3))
                          .astype(np.float32)])
    rad = rng.uniform(0.04, 0.06, pts.shape[0]).astype(np.float32)
    n = pts.shape[0]
    payload = torch.from_numpy(rng.uniform(0.5, 1.5, (n, 2))
                               .astype(np.float32)).to(dev)
    for mode in ("fixed", "symmetric"):
        eng = _sets_engine(dev, [(pts, None if mode == "fixed" else rad)],
                           r=0.05 if mode == "fixed" else None,
                           symmetric=mode == "symmetric")
        a, allow, q, qpos = _active_inputs(eng, payload)
        in_cluster = torch.nonzero(a.recs_t[pairs.F_ORIG] < 800).flatten()
        assert int(in_cluster[-1] - in_cluster[0]) == 799
        t = int(qpos[0]) // 128
        tile = q.view(q.shape[0], a.tiles_cap, 128)[:, t]
        tile[pairs.F_X:pairs.F_Z + 1] = int(np.float32(5.0).view(np.int32))
        tile[pairs.F_X:pairs.F_Z + 1, 5] = torch.from_numpy(
            centre.view(np.int32)).to(dev)
        tile[pairs.F_R, 5] = int(np.float32(0.05).view(np.int32))
        tile[pairs.F_ORIG, 5] = 0   # the cluster's first point
        tile[pairs.F_SET, 5] = 0
        if mode == "fixed":
            args = (a.desc, q, a.recs_t, a.r2, a.n_win, 8, a.tiles_cap)
            c_k, nb_k = pairs.pairs_nbrs_fixed(*args)
            c_p, nb_p = pairs.pairs_nbrs_fixed_plain(*args)
            live = a.desc[:a.tiles_cap, pairs.FAT_COL] != 2
            assert torch.equal(c_k.view(a.tiles_cap, 128)[live],
                               c_p.view(a.tiles_cap, 128)[live])
            assert torch.equal(nb_k[live], nb_p[live])
            counts = c_k.view(a.tiles_cap, 128)[t]
        else:
            counts = _k3_vs_plain(a, allow, q, fn4_payload, 4,
                                  exact=(0,))[0].view(a.tiles_cap, 128)[t]
        assert int(counts[5]) >= 799
        assert int(counts.sum()) == int(counts[5])


def _k5_launch(lib, p, n_win, bits):
    """K5's launcher on dummy buffers (one block, k8 = 8): its error."""
    return lib.tns_pairs_nbrs_from_bits(
        p, p, 1, 1, n_win, bits, 1, p, 1, pairs.set_ids_arg((0,)),
        pairs.set_ids_arg((0,)), pairs.set_ids_arg((8,)),
        (ctypes.c_void_p * 1)(p), p, None)


def test_k2a_k3_launchers_refuse_window_counts_outside_1_to_49(dev):
    # the stream's tables hold 64 windows: a window count outside [1, 49]
    # is refused (cudaErrorInvalidValue) before any launch, by K2a, K3 and
    # K5
    lib = pairs.load_library().lib
    k3 = red.reduce_library(red.ReduceSpec(fn_count_density, 2), False).lib
    p = torch.zeros(8, dtype=torch.int32, device=dev).data_ptr()
    for n_win in (0, 50):
        assert lib.tns_pairs_nbrs_fixed(p, p, p, 1, 1, n_win, 8, 0.01, p, p,
                                        None) == 1
        assert k3.tns_pairs_reduce(p, p, p, 1, 1, n_win, 0.01, 0, 1,
                                   pairs.set_ids_arg((0,)), p, 1, p,
                                   None) == 1
        assert _k5_launch(lib, p, n_win, p) == 1


def test_k5_refuses_bits_off_a_16_byte_boundary(dev):
    # K5 copies its bit rows 16 bytes at a time: bits that do not start on
    # a 16-byte boundary are refused by the wrapper and by the launcher
    lib = pairs.load_library().lib
    buf = torch.zeros(64, dtype=torch.int32, device=dev)
    p = buf.data_ptr()
    assert _k5_launch(lib, p, 9, p + 4) == 1
    torch.cuda.synchronize()
    rng = np.random.default_rng(29)
    eng = _sets_engine(dev, [(rng.uniform(0, 1, (500, 3))
                              .astype(np.float32), None)], r=0.1)
    a, _, _, _ = _active_inputs(eng)
    base = pairs.mask_cand_base(a.desc, a.recs_t.shape[1], a.n_win,
                                a.tiles_cap)
    flat = torch.zeros(int(base[-1]) * 4 + 1, dtype=torch.int32, device=dev)
    before = pairs.pairs_nbrs_from_bits.launches
    with pytest.raises(ValueError, match="16-byte"):
        pairs.pairs_nbrs_from_bits(a.desc, a.recs_t, flat[1:].view(-1, 4),
                                   base, a.n_win, a.tiles_cap, a.cand_sets,
                                   a.cand_offsets, a.k8s)
    assert pairs.pairs_nbrs_from_bits.launches == before


# ------------------------------------------------------- K1r, fallbacks
def test_k1r_partial_dead_and_late_tiles_match_plain_on_card(dev):
    # tile 0 full, 1 partial, 2 ends exactly at n, 3 starts near n and
    # runs past it (clipped), 4 dead, 5 a negative start; records of
    # random words, so every field is checked bit for bit
    n = 300
    recs = torch.from_numpy(np.random.default_rng(3).integers(
        -2**31, 2**31 - 1, (pairs.N_FIELDS, n)).astype(np.int32)).to(dev)
    desc = torch.zeros((8, pairs.DESC_W), dtype=torch.int32)
    for t, (a, cnt, dead) in enumerate([(0, 128, 0), (128, 5, 0),
                                        (n - 3, 3, 0), (n - 2, 128, 0),
                                        (0, 0, 2), (-1, 4, 0)]):
        desc[t, pairs.A_COL], desc[t, pairs.CNT_COL] = a, cnt
        desc[t, pairs.FAT_COL] = dead
    desc = desc.to(dev)
    for slack in (0, 131):
        before = pairs.expand_records.launches
        q_k, rec_k = pairs.expand_records(desc, recs, 6, n, slack)
        q_p, rec_p = pairs.expand_records_plain(desc, recs, 6, n, slack)
        torch.cuda.synchronize()
        assert pairs.expand_records.launches == before + 1
        assert rec_k.shape == (6 * 128 + slack, pairs.N_FIELDS)
        assert torch.equal(q_k, q_p) and torch.equal(rec_k, rec_p)
        assert torch.equal(q_k, pairs.expand_query_tiles(desc, recs, 6, n))


def _brute(pts, r):
    d = pts[None, :, :] - pts[:, None, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    m = d2 <= np.float32(r) * np.float32(r)
    np.fill_diagonal(m, False)
    return m


@pytest.mark.parametrize("path", ["tile", "scalar"])
def test_fallback_paths_on_card_match_brute_force(dev, path):
    # the tile path (K1r and no pairs kernel) and the search-based
    # pipeline on the card
    pts = np.random.default_rng(6).uniform(0, 1, (2500, 3)).astype(np.float32)
    r = 0.08
    eng = TreeNSearch(device="cuda")
    eng.add_point_set(torch.from_numpy(pts).to(dev))
    eng.set_search_radius(r)
    eng.set_all_searches(True)
    kernels = (pairs.expand_records, pairs.expand_query_tiles,
               pairs.pairs_nbrs_fixed)
    before = [k.launches for k in kernels]
    if path == "tile":
        eng.set_use_pallas(False)
        eng.run()
    else:
        eng.run_scalar()
    grew = [k.launches - b for k, b in zip(kernels, before)]
    assert grew == ([1, 0, 0] if path == "tile" else [0, 0, 0])
    counts, nbrs = (t.cpu().numpy() for t in eng.get_neighbors(0, 0))
    m = _brute(pts, r)
    assert np.array_equal(counts, m.sum(1))
    for i in range(pts.shape[0]):
        assert np.array_equal(np.sort(nbrs[i, :counts[i]]),
                              np.nonzero(m[i])[0])


def test_ten_candidate_sets_on_card_equal_the_cpu(dev):
    rng = np.random.default_rng(7)
    sets = [rng.uniform(0, 1, (2000, 3)).astype(np.float32)] + [
        rng.uniform(0, 1, (200, 3)).astype(np.float32) for _ in range(9)]
    engines = []
    for d in (dev, torch.device("cpu")):
        eng = TreeNSearch(device=d)
        for p in sets:
            eng.add_point_set(torch.from_numpy(p).to(d))
        eng.set_search_radius(0.07)
        for j in range(10):
            eng.set_active_search(0, j, True)
        eng.run()
        engines.append(eng)
    for j in range(10):
        (c_g, n_g), (c_c, n_c) = (e.get_neighbors(0, j) for e in engines)
        assert torch.equal(c_g.cpu(), c_c) and torch.equal(n_g.cpu(), n_c)


def test_zsort_orders_on_card_equal_the_cpu(dev):
    # the per-point order (float32 quantization on the card) and the
    # cell-granular order of a run() that rode the carry, for sets of a
    # few thousand points and around one tile
    rng = np.random.default_rng(9)
    sets = [rng.uniform(0, 1, (m, 3)).astype(np.float32)
            for m in (3000, 127, 128, 129)]
    sets.append(rng.uniform(0.5, 1.5, (2000, 3)).astype(np.float32))
    orders = []
    for d in (dev, torch.device("cpu")):
        eng = TreeNSearch(device=d)
        for p in sets:
            eng.add_point_set(torch.from_numpy(p).to(d))
        eng.set_search_radius(0.05)
        eng.set_all_searches(True)
        eng.prepare_zsort()
        point = [eng.get_zsort_order(k) for k in range(len(sets))]
        eng.run()
        assert eng._last_stats["carried"]
        eng.prepare_zsort()
        cell = [eng.get_zsort_order(k) for k in range(len(sets))]
        orders.append(point + cell)
        t = torch.from_numpy(sets[0]).to(d).double()
        out = eng.apply_zsort(0, t)
        assert out.device == t.device
        assert np.array_equal(out.cpu().numpy(),
                              sets[0].astype(np.float64)[cell[0]])
    for g, c in zip(*orders):
        assert g.dtype == np.int32 and np.array_equal(g, c)


# ---------------------------------------------------------- sharded search
def _slab_union(d, variable):
    """The fast path's local search (``parallel/sharded.py``) of each of 4
    ranks, built in one process: every rank's local rows as the routing
    leaves them (its owned rows ascending, then rank r - 1's, then rank
    r + 1's) and its slab window (``owned_rng``, ``lin_base``); the owned
    rows' results put back by orig.  Returns the union, the one-device
    ``run()``'s counts and rows, and the launches of K1 and the pairs
    kernel."""
    from treensearch_tpu_torch.parallel import sharded as sh
    rng = np.random.default_rng(12)
    n0, n1 = 6000, 2000
    pts = torch.from_numpy(rng.uniform(0, 1, (n0 + n1, 3))
                           .astype(np.float32)).to(d)
    rad = torch.from_numpy(rng.uniform(0.02, 0.03, n0 + n1)
                           .astype(np.float32)).to(d) if variable else None
    eng = TreeNSearch(device=d)
    eng.add_point_set(pts[:n0], None if rad is None else rad[:n0])
    eng.add_point_set(pts[n0:], None if rad is None else rad[n0:])
    eng.set_active_search(0, 0, True)
    eng.set_active_search(0, 1, True)
    if not variable:
        eng.set_search_radius(0.025)
    eng.run()
    cfg = eng._make_cfg(eng._last_stats["stencil_w"])
    knobs, state = eng._knobs(), eng._grid_state
    sr = eng._search_radius or 0.0
    consts = fp.step_constants(cfg, knobs, float(state.cell_size), d,
                               search_radius=sr)
    owner = sh.owners(pts, state, cfg, 4)
    orig = torch.arange(n0 + n1, dtype=torch.int32, device=d)
    set_ids = fp.set_ids_of(cfg, d)
    blocks = len({sj for _, sj in cfg.active_pairs})
    counts = torch.zeros((n0 + n1, blocks), dtype=torch.int32, device=d)
    nbrs = [None] * blocks
    kernel = pairs.pairs_nbrs_variable if variable else pairs.pairs_nbrs_sets
    before = (pairs.expand_query_tiles.launches, kernel.launches)
    for r in range(4):
        rows = torch.cat([torch.nonzero(owner == o)[:, 0]
                          for o in (r, r - 1, r + 1) if 0 <= o < 4])
        n_own = int((owner == r).sum())
        local = sh.records(pts[rows], None if rad is None else rad[rows],
                           orig[rows], set_ids[rows])
        res = sh.search_fast_local(local, n_own, r, 4, sr, state, cfg, knobs,
                                   consts=consts)
        mine = rows[:n_own]
        counts[mine] = res["counts"]
        for b, nb in enumerate(res["nbrs"]):
            if nbrs[b] is None:
                nbrs[b] = torch.full((n0 + n1, nb.shape[1]), -1,
                                     dtype=torch.int32, device=d)
            nbrs[b][mine] = nb
    launches = (pairs.expand_query_tiles.launches - before[0],
                kernel.launches - before[1])
    return counts, nbrs, eng, launches


@pytest.mark.parametrize("variable", [False, True])
def test_sharded_local_search_on_card_equals_one_device(dev, variable):
    # no collective: the four ranks' local searches run one after another
    # on the card, K1 and K2b/K2c launched for each
    counts, nbrs, eng, launches = _slab_union(dev, variable)
    assert launches == (4, 4)
    n0 = eng.get_n_points_in_set(0)
    for b, sj in enumerate((0, 1)):
        c1, nb1 = eng.get_neighbors(0, sj)
        assert torch.equal(counts[:n0, b], c1) and int(c1.sum()) > 0
        for i in range(n0):
            assert torch.equal(torch.sort(nbrs[b][i, :c1[i]]).values,
                               torch.sort(nb1[i, :c1[i]]).values), (sj, i)


# ------------------------------------------------------------ step graphs
@pytest.mark.parametrize("mode", ["fixed", "variable", "symmetric"])
def test_k4_row_cap_equals_plain_across_window_and_chunk_edges(dev, mode):
    # K4 with a static row cap below, at and above the row count, on the
    # chunk- and window-edge descriptors: counts exact, rows below the
    # cap word for word those of plain (which drops the same rows) and
    # of the uncapped kernel
    rng = np.random.default_rng(23)
    sets = [(rng.uniform(0, 1, (m, 3)).astype(np.float32),
             None if mode == "fixed" else
             rng.uniform(0.03, 0.07, m).astype(np.float32))
            for m in (2500, 1500)]
    eng = _sets_engine(dev, sets, r=0.1 if mode == "fixed" else None,
                       symmetric=mode == "symmetric",
                       active=[(0, 0), (0, 1), (1, 0)])
    if mode == "fixed":
        eng.set_cell_size(0.05)   # a 25-window stencil
    a, allow, _, _ = _active_inputs(eng)
    a = a._replace(desc=_window_desc(a, rng))
    q = pairs.expand_query_tiles(a.desc, a.recs_t, a.tiles_cap, 4000)
    args = (a.desc, q, a.recs_t, a.n_win, a.tiles_cap, a.cand_sets, allow)
    kw = fp.active_args(a)
    c_full, b_full, base = pairs.pairs_mask(*args, **kw)
    rows = int(base[-1])
    # a cap inside the tile with the 257-candidate window, one at a
    # 256-row chunk edge, the count and past it
    for cap in (rows // 3, 256 * (rows // 512), rows, rows + 300):
        c_k, b_k, base_k = pairs.pairs_mask(*args, **kw, rows_cap=cap)
        c_p, b_p, _ = pairs.pairs_mask_plain(*args, **kw, rows_cap=cap)
        torch.cuda.synchronize()
        live = min(cap, rows)
        assert b_k.shape == (cap, pairs.MASK_WORDS)
        assert torch.equal(base_k, base) and torch.equal(c_k, c_full)
        assert torch.equal(c_k, c_p), cap
        assert torch.equal(b_k[:live], b_p[:live]), cap
        assert torch.equal(b_k[:live], b_full[:live]), cap
        assert int(fp._mask_flags(base_k, cap)["mask_overflow"]) \
            == int(cap < rows)


def test_conditional_body_launches_k1_and_k2a(dev):
    # K1 and K2a recorded inside an IF node (rebuild_if under capture):
    # a replay with the predicate true runs them and writes their results
    # into buffers made before the capture; with it false the buffers
    # keep what they held, though the inputs changed
    from treensearch_tpu_torch.ops.cond import rebuild_if
    pts = torch.from_numpy(np.random.default_rng(29).uniform(
        0, 1, (20_000, 3)).astype(np.float32)).to(dev)
    eng = TreeNSearch(device=dev)
    eng.add_point_set(pts)
    eng.set_search_radius(0.03)
    eng.set_all_searches(True)
    eng.run()
    cfg = eng._make_cfg(1)
    knobs = eng._knobs()
    carry = fp._prep(pts, eng._grid_state, cfg, knobs,
                     consts=fp.step_constants(
                         cfg, knobs, float(eng._grid_state.cell_size), dev,
                         search_radius=0.03))
    a = fp.kernel_inputs(pts, 0.03, carry, cfg, knobs)
    recs = a.recs_t.clone()
    q_out = torch.zeros((8, a.tiles_cap * 128), dtype=torch.int32,
                        device=dev)
    c_out = torch.zeros(a.tiles_cap * 128, dtype=torch.int32, device=dev)
    pred = torch.ones((), dtype=torch.bool, device=dev)

    def body():
        q = pairs.expand_query_tiles(a.desc, recs, a.tiles_cap, 20_000)
        c, _ = pairs.pairs_nbrs_fixed(a.desc, q, recs, a.r2, a.n_win,
                                      a.k8s[0], a.tiles_cap)
        q_out.copy_(q)
        c_out.copy_(c)

    body()   # eager warm-up
    torch.cuda.synchronize()
    want_q, want_c = q_out.clone(), c_out.clone()
    q_out.zero_()
    c_out.zero_()
    launches = (pairs.expand_query_tiles.launches,
                pairs.pairs_nbrs_fixed.launches)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        rebuild_if(pred, body)
    assert (pairs.expand_query_tiles.launches,
            pairs.pairs_nbrs_fixed.launches) == (launches[0] + 1,
                                                 launches[1] + 1)
    torch.cuda.synchronize()
    assert not q_out.any() and not c_out.any()   # capture ran nothing
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(q_out, want_q) and torch.equal(c_out, want_c)
    recs[pairs.F_X].view(torch.float32).add_(0.5)   # other inputs
    pred.fill_(False)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(q_out, want_q) and torch.equal(c_out, want_c)
    pred.fill_(True)
    graph.replay()
    torch.cuda.synchronize()
    assert not torch.equal(q_out, want_q)


def test_reuse_step_graph_equals_eager_static_in_cell_jittered(dev):
    # make_step_fn(reuse=True) captured once; replays at static positions,
    # in-cell moves and jitter equal an eager step on the same positions,
    # rebuilt, counts and rows slot for slot, step by step
    from treensearch_tpu_torch.utils.keys import quantize
    rng = np.random.default_rng(31)
    pts = torch.from_numpy(rng.uniform(0, 1, (30_000, 3))
                           .astype(np.float32)).to(dev)
    eng = TreeNSearch(device=dev)
    eng.add_point_set(pts)
    eng.set_search_radius(0.03)
    eng.set_all_searches(True)
    eng.run()
    eng.run()
    static = pts.clone()
    step, state = eng.make_step_fn(reuse=True)
    estep, estate = eng.make_step_fn(reuse=True)
    for _ in range(2):
        sol, state = step(state, static)
        want, estate = estep(estate, static)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        sol, state = step(state, static)
    grid = state[0]
    inv = 1.0 / grid.cell_size
    cells = quantize(pts, grid.grid_min, inv, grid.n_cells)
    gen = torch.Generator(device=dev).manual_seed(1)
    seq, cur = [pts] * 2, pts
    for amp, in_cell in ((1e-6, True),) * 3 + ((2e-3, False),) * 3:
        nxt = cur + (torch.rand(cur.shape, generator=gen, device=dev)
                     * 2 - 1) * amp
        if in_cell:
            keep = (quantize(nxt, grid.grid_min, inv, grid.n_cells)
                    == cells).all(dim=1)
            nxt = torch.where(keep[:, None], nxt, cur)
        seq.append(nxt)
        cur = nxt
    rebuilt = []
    for p in seq:
        static.copy_(p)
        graph.replay()
        want, estate = estep(estate, p)
        rebuilt.append(int(sol["rebuilt"]))
        assert rebuilt[-1] == int(want["rebuilt"])
        got_p, want_p = dict(sol["pairs"]["0-0"]), want["pairs"]["0-0"]
        assert torch.equal(got_p["counts"], want_p["counts"])
        assert torch.equal(fp.materialize_nbrs(got_p),
                           fp.materialize_nbrs(want_p))
    assert rebuilt[:5] == [0] * 5 and rebuilt[5:] == [1] * 3


def _fallback_engine(dev, kind):
    """A small engine whose step leaves the fused route, settled by the
    call a user makes first, and whether its step is ``fast``."""
    rng = np.random.default_rng(37)
    pts = rng.uniform(0, 1, (6000, 3)).astype(np.float32)
    if kind == "tile_ten_sets":
        # a fluid and nine bodies: past the fused kernels' 8 candidate sets
        bodies = [(rng.uniform(0, 0.3, (300, 3)) + rng.uniform(0, 0.7, 3))
                  .astype(np.float32) for _ in range(9)]
        eng = _sets_engine(dev, [(pts, None)] + [(b, None) for b in bodies],
                           r=0.05, active=[(0, j) for j in range(10)]
                           + [(3, 0)])
    elif kind == "pipeline_variable_symmetric":
        eng = _sets_engine(dev, [(pts, rng.uniform(0.03, 0.06, 6000)
                                  .astype(np.float32))])
    else:
        eng = _sets_engine(dev, [(pts, None)], r=0.05)
    if kind == "tile_use_pallas_off":
        eng.set_use_pallas(False)
    fast = kind.startswith("tile")
    for _ in range(2):
        eng.run() if fast else eng.run_scalar()
    return eng, fast


@pytest.mark.parametrize("kind", ["tile_ten_sets", "tile_use_pallas_off",
                                  "pipeline_fixed",
                                  "pipeline_variable_symmetric"])
def test_fallback_step_graph_equals_eager(dev, kind):
    # the tile-path and pipeline steps captured once; replays at static
    # and jittered positions equal an eager step on the same positions:
    # every pair's counts, max_count and rows slot for slot, every flag
    eng, fast = _fallback_engine(dev, kind)
    points, radii = eng._assemble()
    args = (points.clone(),) + (() if radii is None else (radii,))
    step, state = eng.make_step_fn(fast=fast)
    estep, estate = eng.make_step_fn(fast=fast)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            sol, state = step(state, *args)
            want, estate = estep(estate, *args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    launches = pairs.expand_records.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        sol, state = step(state, *args)
    assert pairs.expand_records.launches == launches + fast
    gen = torch.Generator(device=dev).manual_seed(2)
    for k in range(3):
        if k:
            args[0].add_((torch.rand(args[0].shape, generator=gen,
                                     device=dev) * 2 - 1) * 2e-3)
        graph.replay()
        want, estate = estep(estate, *args)
        assert set(sol) == set(want)
        for key, v in want.items():
            if key != "pairs":
                assert torch.equal(sol[key], v), (k, key)
        for name, w in want["pairs"].items():
            g = sol["pairs"][name]
            for f in ("counts", "max_count", "nbrs"):
                assert torch.equal(g[f], w[f]), (k, name, f)
        assert int(want["cand_max"]) == 0 or not fast
    assert int(sum(p["counts"].sum() for p in want["pairs"].values())) > 0


def test_sharded_step_graph_over_nccl_equals_eager(dev, tmp_path):
    # the bucketed fast step at world size 1 over NCCL captured once (NCCL
    # makes its communicator at the first collective, so the eager
    # warm-up comes first); replays at static and jittered positions
    # equal an eager step on the same positions: counts, max_count and
    # rows slot for slot, every flag, route_overflow 0; the eager step
    # equals the one-device run()
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from treensearch_tpu_torch.parallel import sharded as sh
    rng = np.random.default_rng(41)
    eng = _sets_engine(dev, [(rng.uniform(0, 1, (20_000, 3))
                              .astype(np.float32), None)], r=0.03)
    eng.run()
    points, _ = eng._assemble()
    _, _, sr, cell, w = eng._setup()
    cfg = eng._make_cfg(w)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        mesh = DeviceMesh("cuda", [0], mesh_dim_names=("d",))
        knobs = eng._knobs()._replace(tiles_cap=0)

        def make():
            return sh.make_sharded_step(cfg, mesh, cell, sr, knobs=knobs,
                                        fast=True)

        # a step does not regrow: the sentinel rows take tile slots, so
        # grow tiles_cap as the engine would until no step overflows
        while int((sol := make()(fresh_state(dev), points)[0])
                  ["tile_overflow"]):
            knobs = knobs._replace(tiles_cap=int(1.5 * (
                knobs.tiles_cap or fp.default_tiles_cap(
                    sum(sol["slab_rows"])))) + 64)
        step, estep = make(), make()
        state, estate = fresh_state(dev), fresh_state(dev)
        static = points.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                sol, state = step(state, static)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        launches = pairs.expand_query_tiles.launches
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            sol, state = step(state, static)
        assert pairs.expand_query_tiles.launches == launches + 1
        gen = torch.Generator(device=dev).manual_seed(3)
        for k in range(3):
            if k:
                static.add_((torch.rand(static.shape, generator=gen,
                                        device=dev) * 2 - 1) * 2e-3)
            graph.replay()
            want, estate = estep(estate, static.clone())
            assert int(want["route_overflow"]) == 0
            for key, v in want.items():
                if isinstance(v, torch.Tensor):
                    assert torch.equal(sol[key], v), (k, key)
            g, w_ = sol["pairs"]["0-0"], want["pairs"]["0-0"]
            for f in ("counts", "max_count", "nbrs"):
                assert torch.equal(g[f], w_[f]), (k, f)
            if k == 0:
                c1, nb1 = eng.get_neighbors(0, 0)
                assert torch.equal(w_["counts"], c1) and int(c1.sum()) > 0
                for i in range(0, c1.shape[0], 97):
                    assert torch.equal(
                        torch.sort(w_["nbrs"][i, :c1[i]]).values,
                        torch.sort(nb1[i, :c1[i]]).values), i
    finally:
        # the graph holds NCCL work: free it before the communicator
        graph = sol = None
        torch.cuda.synchronize()
        dist.destroy_process_group()
