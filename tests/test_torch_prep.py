"""The port's prep (sort, dense table, row-aligned layout, window
descriptors, carried maps, overflow flags) held bit for bit against the
JAX ``_pallas_prep`` with ``use_pallas=True, rec_expand=True``, whose
window starts are in sorted space (the production ``win_sorted`` branch).

Both preps get the same grid state (the JAX one, carried across with
``interop``).  Every field is bit-equal; the descriptor's FAT_COL is
compared for dead tiles only, because the port has no fat tier.
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
from treensearch_tpu_torch.ops.pairs import FAT_COL

_prep_jit = jax.jit(jfp._pallas_prep, static_argnames=("cfg", "knobs"))

FIELDS = ("lin_s", "lin_chk", "idx_s", "inv_perm", "pp", "qpos",
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


# name: (data, dense_cap, tiles_cap, rows_cap, expected overflow field)
CASES = {
    "lattice_1": (lambda: _lattice(1), 1 << 14, 200, 0, None),
    "lattice_100": (lambda: _lattice(100), 1 << 14, 200, 0, None),
    "lattice_4000": (lambda: _lattice(4000), 1 << 14, 200, 0, None),
    "uniform_4000": (_uniform, 1 << 14, 700, 0, None),
    "thin_slab": (_slab, 1 << 14, 600, 0, None),
    "tile_overflow": (_uniform, 1 << 14, 40, 0, "tile_overflow"),
    "rows_overflow": (_uniform, 1 << 14, 700, 100, "rows_overflow"),
    "dense_overflow": (_uniform, 1000, 700, 0, "dense_overflow"),
}


@functools.lru_cache(maxsize=None)
def _both(case):
    make, dense_cap, tiles_cap, rows_cap, _ = CASES[case]
    pts, cell = make()
    n = pts.shape[0]
    jstate = jax.jit(jgrid.update_grid)(jgrid.fresh_state(),
                                        jnp.asarray(pts), jnp.float32(cell))
    jknobs = jfp.FastKnobs(use_pallas=True, rec_expand=True, pack=8,
                           lane_batch=True, dense_cap=dense_cap,
                           tiles_cap=tiles_cap, rows_cap=rows_cap)
    jcfg = JaxConfig((n,), ((0, 0),), False, False, 1, 1024, 512, 64)
    jc = _prep_jit(jnp.asarray(pts), None, jstate, cfg=jcfg, knobs=jknobs)
    jc = {k: np.asarray(v) for k, v in jc._asdict().items()}
    tstate = interop.grid_state_from_numpy(jstate)
    tc = tfp._prep(torch.from_numpy(pts), tstate,
                   SearchConfig((n,), ((0, 0),), 1, 64),
                   tfp.FastKnobs(dense_cap=dense_cap, tiles_cap=tiles_cap,
                                 rows_cap=rows_cap))
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
