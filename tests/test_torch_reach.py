"""The variable-radius step's reach guard and K2c's test counter, on the
CPU.

``make_step_fn`` fixes the stencil width W and the cell size when it
makes the step, and the prep clamps each tile's reach to W cells.  A step
whose radii grow past that reach drops neighbors; ``reach_overflow`` says
so.  These tests hold a carried variable step at BASELINE config 4's
shape (``nsbench/configs/cfg4_variable_symmetric.json`` at its CPU test
size) to ``nsbench/reference.py`` over moving steps, a small cloud whose
radii shrink or grow past the reach to a brute force, the step's
``tested`` to the plain model of K2c's warp cull, and the fixed-radius
steps to the keys they returned before the guard.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from nsbench import reference as ref
from treensearch_tpu_torch import TreeNSearch
from treensearch_tpu_torch.ops import fastpath as fp
from treensearch_tpu_torch.ops import pairs as tpp

ROOT = Path(__file__).resolve().parent.parent
CFG4 = json.loads((ROOT / "nsbench" / "configs"
                   / "cfg4_variable_symmetric.json").read_text())
MOVES = 5
MOVE = 1e-3
# a fixed-radius step's keys before the reach guard and the counter
FIXED_KEYS = {"pairs", "n_cells", "error", "dense_overflow",
              "tile_overflow", "rows_overflow", "tiles_used", "win_max",
              "cand_max"}


def _cfg4_inputs(seed: int = 20):
    """Config 4 at its ``cpu_test`` size: points uniform in the unit cube,
    radii uniform in [low, high) scaled so that the smallest is the test
    radius (their ratio kept, so W stays 2), velocities in +-MOVE."""
    small = CFG4["cpu_test"]
    n, r_min = small["sizes"][0], float(small["radius"])
    low, high = float(CFG4["radii"]["low"]), float(CFG4["radii"]["high"])
    gen = torch.Generator().manual_seed(seed)
    pts = torch.rand((n, 3), generator=gen)
    vel = (torch.rand((n, 3), generator=gen) * 2 - 1) * MOVE
    radii = (torch.rand(n, generator=gen) * (high - low) + low) \
        * np.float32(r_min / low)
    return pts, vel, radii, CFG4["cell_factor"] * r_min


def _engine(pts, radii, cell=None, cap=None):
    eng = TreeNSearch(device="cpu")
    eng.add_point_set(pts, radii)
    eng.set_all_searches(True)
    eng.set_symmetric_search(True)
    if cell is not None:
        eng.set_cell_size(cell)
    if cap is not None:
        eng.set_neighbor_cap(cap)
    eng.run()
    eng.run()
    return eng


def _step_keys(sol) -> tuple:
    """The step's pair 0-0 as the reference's (counts, sorted keys)."""
    pair = sol["pairs"]["0-0"]
    counts = pair["counts"].long()
    rows = fp.materialize_nbrs(dict(pair))
    live = torch.arange(rows.shape[1])[None, :] < counts[:, None]
    q = torch.arange(rows.shape[0])[:, None].expand_as(rows)
    return counts, torch.sort((q[live] << 32) | rows[live].long()).values


def test_config4_step_matches_the_reference_over_moves():
    pts, vel, radii, cell = _cfg4_inputs()
    eng = _engine(pts, radii, cell)
    assert eng._last_stats["stencil_w"] == 2
    step, state = eng.make_step_fn(reuse=True)
    x = pts.clone()
    for _ in range(MOVES):
        x = torch.remainder(x + vel, 1.0)
        sol, state = step(state, x, radii=radii)
        assert int(sol["rebuilt"]) == 1
        assert int(sol["reach_overflow"]) == 0
        counts, keys = ref.neighbor_keys(x, x, (radii, radii), True,
                                         symmetric=True)
        got = _step_keys(sol)
        assert torch.equal(got[0], counts)
        assert torch.equal(got[1], keys)


def _probe():
    """400 points, radii uniform in [0.08, 0.10] (seed 9): cell 1.5 r_min,
    so W = 1 and the step reaches 0.12."""
    rng = np.random.default_rng(9)
    pts = torch.from_numpy(rng.uniform(0, 1, (400, 3)).astype(np.float32))
    rad = torch.from_numpy(rng.uniform(0.08, 0.10, 400).astype(np.float32))
    return pts, rad


def _brute(pts, radii) -> tuple:
    p, r = pts.numpy(), radii.numpy()
    counts, keys = ref.brute_force_keys(p, p, (r, r), True, True)
    return torch.from_numpy(counts), torch.from_numpy(keys)


def _probe_step(route: str):
    pts, rad = _probe()
    eng = _engine(pts, rad, cap=80)
    if route == "split":
        eng.set_split_stage(True)
        eng.run()
    elif route == "tile":
        eng.set_use_pallas(False)
        eng.run()
    assert eng._last_stats["stencil_w"] == 1
    step, state = eng.make_step_fn(reuse=route != "tile")
    return eng, step, state, pts, rad


# radii x 2.0 and x 2.5 need 2 and 3 cells: the step returns 3,393 of
# 3,642 and 5,473 of 6,852 pairs; x 1.15 still fits in one
@pytest.mark.parametrize("route,scale,over", [
    ("fused", 0.5, 0), ("fused", 1.15, 0), ("fused", 2.0, 1),
    ("fused", 2.5, 1), ("split", 1.15, 0), ("split", 2.0, 1),
    ("tile", 1.15, 0), ("tile", 2.0, 1)])
def test_reach_overflow_flags_radii_past_the_stencil(route, scale, over):
    eng, step, state, pts, rad = _probe_step(route)
    radii = rad * np.float32(scale)
    sol, state = step(state, pts, radii=radii)
    assert int(sol["reach_overflow"]) == over
    assert int(sol["dense_overflow"]) == int(sol["rows_overflow"]) \
        == int(sol["tile_overflow"]) == 0
    counts, keys = _brute(pts, radii)
    got = _step_keys(sol)
    if over:
        assert int(got[0].sum()) < int(counts.sum())
        # run() works the cell and W out again from the radii it is given
        eng.resize_point_set(0, pts, radii)
        eng.run()
        c, rows = eng.get_neighbors(0, 0)
        live = torch.arange(rows.shape[1])[None, :] < c[:, None].long()
        q = torch.arange(rows.shape[0])[:, None].expand_as(rows)
        got = (c.long(), torch.sort((q[live] << 32)
                                    | rows[live].long()).values)
    assert torch.equal(got[0], counts)
    assert torch.equal(got[1], keys)


def _culled_tests(eng, state, pts, radii) -> int:
    """The candidates K2c's warps test after their cull
    (``tpp.warp_cull``) on the step's carried structure."""
    _, carry = state
    cfg = eng._make_cfg(eng._last_stats["stencil_w"])
    a = fp.kernel_inputs(pts, 0.0, carry, cfg, eng._knobs(), radii)
    q = tpp.expand_query_tiles(a.desc, a.recs_t, a.tiles_cap, pts.shape[0])
    kept = 0
    for ch in tpp._plain_chunks(a.desc, q, a.recs_t, a.n_win, a.tiles_cap,
                                None, True):
        kept += int((tpp.warp_cull(ch, q, a.recs_t, None, True)
                     & ch.ok[:, None, :]).sum())
    return kept


def test_tested_is_each_steps_warp_cull_count():
    eng, step, state, pts, rad = _probe_step("fused")
    counts = []
    for x in (pts, torch.remainder(pts + 0.01, 1.0)):
        sol, state = step(state, x, radii=rad)
        assert sol["tested"].dtype == torch.int64
        assert tuple(sol["tested"].shape) == (1,)
        counts.append(int(sol["tested"]))
        assert counts[-1] == _culled_tests(eng, state, x, rad)
    assert all(c > 0 for c in counts)


def _fixed_engine():
    rng = np.random.default_rng(5)
    eng = TreeNSearch(device="cpu")
    eng.add_point_set(torch.from_numpy(
        rng.uniform(0, 1, (1500, 3)).astype(np.float32)))
    eng.set_search_radius(0.08)
    eng.set_all_searches(True)
    eng.run()
    return eng


@pytest.mark.parametrize("kind", ["reuse", "fast", "tile", "mask"])
def test_fixed_radius_steps_keep_their_keys(kind):
    eng = _fixed_engine()
    if kind == "tile":
        eng.set_use_pallas(False)
        eng.run()
    if kind == "mask":
        eng.run_mask()
    step, state = eng.make_step_fn(reuse=kind == "reuse",
                                   mask_output=kind == "mask")
    pts = eng._assemble()[0]
    sol, state = step(state, pts)
    want = FIXED_KEYS | ({"rebuilt"} if kind in ("reuse", "mask") else set())
    if kind == "mask":
        want |= {"mask", "mask_rows", "mask_overflow"}
    assert set(sol) == want
    carry = state[1] if kind in ("reuse", "mask") else None
    if carry is not None:
        assert tuple(carry.reach_overflow.shape) == (0,)
