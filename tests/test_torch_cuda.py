"""The CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: every test skips without a CUDA device.  The file imports
nothing of JAX, so on a machine with the card and no JAX it runs without
the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: query tiles bit-equal; counts equal; rows equal slot for slot
(both versions keep the first k8 survivors in window order, so rows agree
exactly, truncated ones included).
"""

import numpy as np
import pytest
import torch

from treensearch_tpu_torch import TreeNSearch
from treensearch_tpu_torch.config import SearchConfig, round_up
from treensearch_tpu_torch.ops import fastpath as fp
from treensearch_tpu_torch.ops import pairs
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
    carry = fp._prep(pts, eng._grid_state, cfg, knobs)
    assert int(carry.dense_overflow) == 0 and int(carry.rows_overflow) == 0
    assert int(carry.tile_overflow) == 0
    _, recs, tiles_cap, n_win, k8, r2 = fp.kernel_inputs(pts, r, carry, cfg,
                                                         knobs)
    assert (n_win, k8) == (9, round_up(cap, 8))
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
    carry = fp._prep(pts, update_grid(fresh_state(dev), pts, 0.08), cfg,
                     knobs)
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
