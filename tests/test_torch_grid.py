"""Grid update, quantization and padded cell ids of the PyTorch port,
held bit for bit against the JAX package on the same numpy inputs.

Tolerance: ``grid_min``, ``n_cells``, ``cell_size``, ``error`` and every
cell id are bit-equal; ``grid_max`` may differ by one ulp, because
``grid.py:97`` is a mul+add that XLA may contract to an FMA where eager
PyTorch rounds twice.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import grid_for_n
from treensearch_tpu.config import SearchConfig as JaxConfig
from treensearch_tpu.ops import fastpath as jfp
from treensearch_tpu.ops import grid as jgrid
from treensearch_tpu.utils import keys as jkeys
from treensearch_tpu_torch import interop
from treensearch_tpu_torch.config import SearchConfig
from treensearch_tpu_torch.ops import fastpath as tfp
from treensearch_tpu_torch.ops import grid as tgrid
from treensearch_tpu_torch.utils import keys as tkeys

_update = jax.jit(jgrid.update_grid)


def _jnp(state):
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def _assert_state(jstate, tstate):
    j = _jnp(jstate)
    t = {k: v.numpy() for k, v in tstate._asdict().items()}
    for k in ("valid", "grid_min", "n_cells", "cell_size", "error"):
        assert j[k].dtype == t[k].dtype and np.array_equal(j[k], t[k]), k
    ulps = np.abs(j["grid_max"].view(np.int32).astype(np.int64)
                  - t["grid_max"].view(np.int32).astype(np.int64))
    assert ulps.max() <= 1, (j["grid_max"], t["grid_max"])


def _step(jprev, pts, cell):
    """One update from the same prior state in both packages."""
    jnew = _update(jprev, jnp.asarray(pts), jnp.float32(cell))
    tprev = interop.grid_state_from_numpy(_jnp(jprev))
    tnew = tgrid.update_grid(tprev, torch.from_numpy(pts),
                             torch.tensor(cell, dtype=torch.float32))
    _assert_state(jnew, tnew)
    return jnew, tnew


def test_update_grid_fresh_keep_grow_and_cell_change():
    rng = np.random.default_rng(0)
    pts = rng.uniform(0.2, 0.8, (500, 3)).astype(np.float32)
    s1, _ = _step(jgrid.fresh_state(), pts, 0.05)
    # hysteresis keep: small motion stays inside the enlarged box
    moved = (pts + rng.uniform(-0.01, 0.01, pts.shape)).astype(np.float32)
    s2, t2 = _step(s1, moved, 0.05)
    assert np.array_equal(np.asarray(s2.grid_min), np.asarray(s1.grid_min))
    assert np.array_equal(t2.n_cells.numpy(), np.asarray(s1.n_cells))
    # grow: points leave the box
    grown = (moved * np.float32(1.6)).astype(np.float32)
    s3, _ = _step(s2, grown, 0.05)
    assert np.any(np.asarray(s3.n_cells) > np.asarray(s2.n_cells))
    # a new cell size discards the kept grid
    s4, _ = _step(s3, grown, 0.07)
    assert not np.array_equal(np.asarray(s4.n_cells), np.asarray(s3.n_cells))


def test_update_grid_own_chain_matches_jax():
    # the port's state carried by itself (not re-fed from JAX) follows the
    # same keep/grow decisions over a jiggling sequence
    rng = np.random.default_rng(1)
    pts = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    js, ts = jgrid.fresh_state(), tgrid.fresh_state()
    for step in range(6):
        pts = (pts + rng.uniform(-0.03, 0.03, pts.shape)).astype(np.float32)
        js = _update(js, jnp.asarray(pts), jnp.float32(0.04))
        ts = tgrid.update_grid(ts, torch.from_numpy(pts),
                               torch.tensor(0.04, dtype=torch.float32))
        _assert_state(js, ts)


def test_update_grid_domain_error_and_empty():
    pts = np.array([[0, 0, 0], [1e6, 1e6, 1e6]], np.float32)
    js, ts = _step(jgrid.fresh_state(), pts, 1.0)
    assert int(ts.error) == 1 and int(js.error) == 1
    empty = np.zeros((0, 3), np.float32)
    _step(jgrid.fresh_state(), empty, 0.3)


CASES = {
    # lattice points sit exactly on cell faces when cell = spacing
    "lattice_on_faces": (grid_for_n(4000)[0], 0.1, 1 << 14),
    "lattice_w_cell": (grid_for_n(4000)[0], 1.15 * 0.199, 1 << 14),
    "uniform": (np.random.default_rng(2).uniform(-1, 3, (2000, 3))
                .astype(np.float32), 0.05, 1 << 22),
    # a dense cap far below the grid clamps the ids
    "clamped": (np.random.default_rng(3).uniform(0, 1, (2000, 3))
                .astype(np.float32), 0.02, 5000),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_quantize_and_padded_lin_bit_equal(case):
    pts, cell, dense_cap = CASES[case]
    js = _update(jgrid.fresh_state(), jnp.asarray(pts), jnp.float32(cell))
    ts = interop.grid_state_from_numpy(_jnp(js))
    p = torch.from_numpy(pts)
    inv_j = 1.0 / js.cell_size
    inv_t = 1.0 / ts.cell_size
    assert np.float32(inv_j) == inv_t.item()
    ijk_j = np.asarray(jkeys.quantize(jnp.asarray(pts), js.grid_min, inv_j,
                                      js.n_cells))
    ijk_t = tkeys.quantize(p, ts.grid_min, inv_t, ts.n_cells).numpy()
    assert ijk_t.dtype == np.int32 and np.array_equal(ijk_j, ijk_t)
    n = pts.shape[0]
    jcfg = JaxConfig((n,), ((0, 0),), False, False, 1, 1024, 512, 64)
    lin_j, dy_j, dz_j, _ = jfp._padded_lin(
        jnp.asarray(pts), js, jcfg, jfp.FastKnobs(dense_cap=dense_cap))
    lin_t, dy_t, dz_t, _ = tfp._padded_lin(
        p, ts, SearchConfig((n,), ((0, 0),), 1, 64),
        tfp.FastKnobs(dense_cap=dense_cap))
    assert int(dy_j) == int(dy_t) and int(dz_j) == int(dz_t)
    assert lin_t.dtype == torch.int32
    assert np.array_equal(np.asarray(lin_j), lin_t.numpy())
    if case == "clamped":
        assert int(lin_t.max()) == dense_cap - 1
