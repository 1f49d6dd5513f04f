"""The port's prep (sort, dense table, row-aligned layout, window
descriptors, carried maps, overflow flags) held bit for bit against the
JAX ``_pallas_prep`` with ``use_pallas=True, rec_expand=True``, whose
window starts are in sorted space (the production ``win_sorted`` branch).

Both preps get the same grid state (the JAX one, carried across with
``interop``).  Every field is bit-equal, the sorted radii ``r_chk`` of
variable mode included; the descriptor's FAT_COL is compared for dead
tiles only, because the port has no fat tier.  The variable-radius cases
exercise the local stencil reach (windows past a tile's reach get length
0); the two-set case concatenates its sets as the engine does.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import grid_for_n
from treensearch_tpu.config import SearchConfig as JaxConfig
from treensearch_tpu.ops import fastpath as jfp
from treensearch_tpu.ops import grid as jgrid
from treensearch_tpu_torch import interop
from treensearch_tpu_torch.config import SearchConfig
from treensearch_tpu_torch.ops import fastpath as tfp
from treensearch_tpu_torch.ops.pairs import FAT_COL, LENS_OFF

_prep_jit = jax.jit(jfp._pallas_prep, static_argnames=("cfg", "knobs"))

FIELDS = ("lin_s", "lin_chk", "r_chk", "idx_s", "inv_perm", "pp", "qpos",
          "dense_overflow", "tile_overflow", "rows_overflow", "win_max",
          "n_cells_stat")


def _lattice(n):
    pts, r = grid_for_n(n)
    return pts, float(1.15 * r)


def _uniform():
    return (np.random.default_rng(3).uniform(0, 1, (4000, 3))
            .astype(np.float32), 0.05)


def _slab():
    # rows (fixed i, j) hold a handful of points: every tile is partial
    rng = np.random.default_rng(4)
    pts = np.stack([rng.uniform(0, 1, 3000), rng.uniform(0, 1, 3000),
                    rng.uniform(0, 0.02, 3000)], 1).astype(np.float32)
    return pts, 0.05


def _variable():
    # radii spread 0.5x..2x of the cell's reach: W = 2 with tiles whose
    # local reach is 1 cell next to tiles that need 2
    rng = np.random.default_rng(5)
    pts = rng.uniform(0, 1, (3000, 3)).astype(np.float32)
    r = rng.uniform(0.03, 0.09, 3000).astype(np.float32)
    r[pts[:, 0] > 0.5] *= np.float32(0.5)
    return pts, 0.06, r, (3000,)


def _variable_lattice():
    pts, r = grid_for_n(1000)
    rad = np.random.default_rng(6).uniform(0.5 * r, 1.5 * r, pts.shape[0]) \
        .astype(np.float32)
    return pts, float(1.5 * rad.min()), rad, (pts.shape[0],)


def _two_sets():
    rng = np.random.default_rng(8)
    fluid = rng.uniform(0, 1, (2500, 3))
    wall = np.stack([rng.uniform(0, 1, 700), rng.uniform(0, 1, 700),
                     np.zeros(700)], 1)
    return np.concatenate([fluid, wall]).astype(np.float32), 0.05, None, \
        (2500, 700)


# name: (data, dense_cap, tiles_cap, rows_cap, expected overflow field);
# data gives (points, cell) or (points, cell, radii or None, set sizes)
CASES = {
    "lattice_1": (lambda: _lattice(1), 1 << 14, 200, 0, None),
    "lattice_100": (lambda: _lattice(100), 1 << 14, 200, 0, None),
    "lattice_4000": (lambda: _lattice(4000), 1 << 14, 200, 0, None),
    "uniform_4000": (_uniform, 1 << 14, 700, 0, None),
    "thin_slab": (_slab, 1 << 14, 600, 0, None),
    "tile_overflow": (_uniform, 1 << 14, 40, 0, "tile_overflow"),
    "rows_overflow": (_uniform, 1 << 14, 700, 100, "rows_overflow"),
    "dense_overflow": (_uniform, 1000, 700, 0, "dense_overflow"),
    "variable_uniform": (_variable, 1 << 14, 700, 0, None),
    "variable_lattice": (_variable_lattice, 1 << 14, 200, 0, None),
    "two_sets": (_two_sets, 1 << 14, 700, 0, None),
}


@functools.lru_cache(maxsize=None)
def _both(case):
    make, dense_cap, tiles_cap, rows_cap, _ = CASES[case]
    pts, cell, radii, sizes = (make() + (None, None))[:4]
    n = pts.shape[0]
    sizes = sizes or (n,)
    variable = radii is not None
    w = 1
    if variable:
        # the host's stencil width: smallest w with w * cell >= r_max
        c, rmax = np.float32(cell), np.float32(radii.max())
        w = int(np.ceil(rmax / c))
        w = w if np.float32(w) * c >= rmax else w + 1
    pairs = tuple((i, j) for i in range(len(sizes))
                  for j in range(len(sizes)))
    jstate = jax.jit(jgrid.update_grid)(jgrid.fresh_state(),
                                        jnp.asarray(pts), jnp.float32(cell))
    jknobs = jfp.FastKnobs(use_pallas=True, rec_expand=True, pack=8,
                           lane_batch=True, dense_cap=dense_cap,
                           tiles_cap=tiles_cap, rows_cap=rows_cap)
    jcfg = JaxConfig(sizes, pairs, variable, variable, w, 1024, 512, 64)
    jc = _prep_jit(jnp.asarray(pts),
                   None if radii is None else jnp.asarray(radii), jstate,
                   cfg=jcfg, knobs=jknobs)
    jc = {k: np.asarray(v) for k, v in jc._asdict().items()}
    tstate = interop.grid_state_from_numpy(jstate)
    cfg = SearchConfig(sizes, pairs, w, 64, variable, variable)
    knobs = tfp.FastKnobs(dense_cap=dense_cap, tiles_cap=tiles_cap,
                          rows_cap=rows_cap)
    tc = tfp._prep(torch.from_numpy(pts), tstate, cfg, knobs,
                   None if radii is None else torch.from_numpy(radii),
                   consts=tfp.step_constants(cfg, knobs, cell, "cpu",
                                             search_radius=0.0))
    return jc, {k: v.numpy() for k, v in tc._asdict().items()}


@pytest.mark.parametrize("case", list(CASES))
def test_prep_fields_bit_equal(case):
    jc, tc = _both(case)
    for k in FIELDS:
        assert tc[k].dtype == jc[k].dtype, k
        assert tc[k].shape == jc[k].shape, k
        assert np.array_equal(tc[k], jc[k]), k
    flag = CASES[case][4]
    for k in ("dense_overflow", "tile_overflow", "rows_overflow"):
        assert int(tc[k]) == int(k == flag), k


@pytest.mark.parametrize("case", list(CASES))
def test_prep_descriptors_bit_equal(case):
    jc, tc = _both(case)
    jd, td = jc["desc"], tc["desc"]
    assert td.shape == jd.shape and td.dtype == jd.dtype
    # window starts (sorted space), lengths at 64 + w, A_COL 62, CNT_COL 63
    # and every other column but FAT_COL
    assert np.array_equal(td[:, :FAT_COL], jd[:, :FAT_COL])
    assert np.array_equal(td[:, FAT_COL] == 2, jd[:, FAT_COL] == 2)
    assert set(np.unique(td[:, FAT_COL])) <= {0, 2}


def test_variable_reach_shortens_windows():
    # the variable cases run with W = 2, and some tile's windows at
    # |di| or |dj| = 2 are cut to length 0 by its local reach while other
    # tiles keep them
    for case in ("variable_uniform", "variable_lattice"):
        jc, tc = _both(case)
        d = tc["desc"]
        live = d[:, FAT_COL] == 0
        # W = 2: 25 windows, the last one in use
        assert (d[:, LENS_OFF + 25:LENS_OFF + 49] == 0).all(), case
        assert (d[live][:, LENS_OFF + 24] > 0).any(), case
        outer = [k for k in range(25) if max(abs(k // 5 - 2),
                                             abs(k % 5 - 2)) == 2]
        lens = d[live][:, [LENS_OFF + k for k in outer]]
        assert (lens.sum(axis=1) == 0).any(), case
        assert (lens.sum(axis=1) > 0).any(), case
        assert tc["r_chk"].dtype == np.float32 and tc["r_chk"].shape[0] > 0
