"""The K2 kernels' per-warp cull, on the CPU.

``csrc/pairs.cu::pairs_nbrs_kernel`` skips a candidate for a whole warp
when its box gap ``gd2`` (``ops/pairs.py::box_gap_d2``, the kernel's
``box_d2_rn``) exceeds the warp's threshold.  The kernel's rows stay
exact only if no lane whose query lies in the warp's box can hit such a
candidate, with no margin: that rests on round-to-nearest float32
subtraction, products of non-negatives and sums of non-negatives being
monotone.  These tests hold that rule in float32 torch on random, lattice
and ulp-perturbed inputs, and hold the plain model of the cull
(``warp_cull``, the count the wrappers add to ``tested``) to keeping every
hit of the plain K2a, K2b and K2c.  The kernel against both runs on the
card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from treensearch_tpu_torch import TreeNSearch
from treensearch_tpu_torch.ops import fastpath as fp
from treensearch_tpu_torch.ops import pairs as tpp

NAN = np.float32(np.nan)


def _ulp_jitter(x, rng):
    """Each value moved by -1, 0 or +1 ulp in float32."""
    step = rng.integers(-1, 2, x.shape)
    up = np.nextafter(x, np.float32(np.inf))
    down = np.nextafter(x, np.float32(-np.inf))
    return np.where(step > 0, up, np.where(step < 0, down, x)) \
        .astype(np.float32)


def _warps(kind, rng):
    """(queries (W, 32, 3), candidates (M, 3)) float32: W warps of 32
    queries, some lanes NaN as K1's sentinel lanes are."""
    if kind == "random":
        centre = rng.uniform(0, 1, (64, 1, 3))
        q = centre + rng.uniform(-0.05, 0.05, (64, 32, 3))
        c = rng.uniform(-0.1, 1.1, (4000, 3))
    else:
        s = np.float32(1 / 32)   # a lattice at the radius, exact in float32
        q = rng.integers(0, 24, (64, 1, 3)) + rng.integers(0, 4, (64, 32, 3))
        c = np.stack(np.meshgrid(*[np.arange(-2, 30)] * 3), -1).reshape(-1, 3)
        q, c = q * s, c * s
    q, c = q.astype(np.float32), c.astype(np.float32)
    if kind == "ulp":
        q, c = _ulp_jitter(q, rng), _ulp_jitter(c, rng)
    q[rng.uniform(size=q.shape[:2]) < 0.2] = NAN
    q[5] = NAN   # an all-sentinel warp
    c[:7] = NAN  # the chunk's padding
    return torch.from_numpy(q), torch.from_numpy(c)


@pytest.mark.parametrize("kind", ["random", "lattice", "ulp"])
def test_box_gap_bounds_every_query_in_the_box(kind):
    q, c = _warps(kind, np.random.default_rng(3))
    nan = q.isnan()
    lo = torch.where(nan, np.inf, q).amin(1)[:, None, :]     # (W, 1, 3)
    hi = torch.where(nan, -np.inf, q).amax(1)[:, None, :]
    gd2 = tpp.box_gap_d2(lo, hi, c[None])                    # (W, M)
    d = c[None, None, :, :] - q[:, :, None, :]               # (W, 32, M, 3)
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    live = ~nan.any(-1)                                      # (W, 32)
    # no live query's computed d^2 is below its warp's gd2
    assert not bool((d2 < gd2[:, None, :])[live].any())
    # so a culled candidate fails the exact test in every lane, at r^2
    r2 = np.float32(1 / 32) * np.float32(1 / 32)
    culled = ~(gd2 <= r2)
    assert not bool(((d2 <= r2) & culled[:, None, :])[live].any())
    # NaN candidates and the all-sentinel warp are culled whole
    assert bool(culled[:, :7].all()) and bool(culled[5].all())
    if kind == "lattice":
        # the bound is tight: hits at exactly r^2 sit on the box's faces
        tight = (d2 == gd2[:, None, :]) & (d2 == r2) & live[:, :, None]
        assert bool(tight.any())


def _engine(mode, rng):
    """A small CPU engine for K2a (``fixed``), K2b (``sets``) or K2c
    (``variable``, ``symmetric``; radii 0.035 and, on one point in 20,
    0.07, so a large r_j
    reaches queries whose warp's radii do not)."""
    eng = TreeNSearch(device="cpu")
    sizes = (1500, 700) if mode == "sets" else (2000,)
    for n in sizes:
        pts = torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(np.float32))
        rad = None
        if mode in ("variable", "symmetric"):
            rad = torch.from_numpy(np.where(rng.uniform(size=n) < 0.05, 0.07,
                                            0.035).astype(np.float32))
        eng.add_point_set(pts, rad)
    if mode in ("fixed", "sets"):
        eng.set_search_radius(0.05)
    eng.set_symmetric_search(mode == "symmetric")
    eng.set_all_searches(True)
    eng.run()
    return eng


def _kernel_inputs(eng):
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
    return fp.kernel_inputs(points, eng._search_radius or 0.0, carry, cfg,
                            knobs, radii)


@pytest.mark.parametrize("mode", ["fixed", "sets", "variable", "symmetric"])
def test_plain_cull_keeps_every_hit(mode):
    eng = _engine(mode, np.random.default_rng(11))
    a = _kernel_inputs(eng)
    assert (a.multi_set, a.variable, a.symmetric) == (
        mode == "sets", mode in ("variable", "symmetric"), mode == "symmetric")
    q = tpp.expand_query_tiles(a.desc, a.recs_t, a.tiles_cap,
                               eng.get_total_n_points())
    r2 = None if a.variable else a.r2
    kept, by_r_j = 0, 0
    for ch in tpp._plain_chunks(a.desc, q, a.recs_t, a.n_win, a.tiles_cap,
                                r2, a.symmetric):
        keep = tpp.warp_cull(ch, q, a.recs_t, r2, a.symmetric) \
            & ch.ok[:, None, :]
        hit = ch.hit.view(ch.t1 - ch.t0, 4, 32, -1).any(2)
        assert not bool((hit & ~keep).any())
        kept += int(keep.sum())
        if a.symmetric:   # hits that only the candidate's own r_j keeps
            own = tpp.warp_cull(ch, q, a.recs_t, r2, False)
            by_r_j += int((hit & ~own).sum())
    assert by_r_j > 0 if a.symmetric else by_r_j == 0
    # the wrappers' counter is the model's count; the cull drops most
    # window tests here and keeps some
    tested = torch.zeros(1, dtype=torch.int64)
    fp.run_pairs(a, q, tested=tested)
    assert int(tested) == kept
    _, lens = tpp.clipped_windows(a.desc, a.recs_t.shape[1], a.n_win,
                                  a.tiles_cap)
    assert 0 < 32 * kept < 128 * int(lens.sum()) // 2


def test_tested_must_be_one_int64_on_the_device():
    eng = _engine("fixed", np.random.default_rng(12))
    a = _kernel_inputs(eng)
    q = tpp.expand_query_tiles(a.desc, a.recs_t, a.tiles_cap,
                               eng.get_total_n_points())
    for bad in (torch.zeros(1, dtype=torch.int32),
                torch.zeros(2, dtype=torch.int64)):
        with pytest.raises(ValueError, match="tested"):
            fp.run_pairs(a, q, tested=bad)
