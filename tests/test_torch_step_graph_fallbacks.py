"""The steps off the fused route on the CPU: ``make_step_fn()`` on the tile
path (more than 8 candidate sets, or ``set_use_pallas(False)``),
``make_step_fn(fast=False)`` (the search-based pipeline) and
``ops.zsort.make_zsort_step``, checked for what a CUDA graph capture of
them needs, without a card.

- **No host read.**  With the capture check patched to say yes and
  every host-reading tensor method and ``torch.tensor`` made to raise
  outside the kernel wrappers (``torch_step_guard.py``), the tile-path
  step (one set after ``set_use_pallas(False)``, ten candidate sets,
  variable symmetric), the pipeline step (fixed, variable symmetric, two
  sets) and the z-sort step over 3 sets run, and equal the unguarded
  eager step bit for bit.  The sharded step captures over NCCL
  (``test_torch_sharded.py``, ``test_torch_cuda.py``).
- **Static sizes.**  The tile path sized from its caps (every tile, each
  window ``wcap`` wide: the step's) equals the tile path sized by the
  live tiles and the widest window (``run()``'s), the whole solution bit
  for bit, a window cut by a small ``wcap`` included.
- **Against JAX.**  A replay-style loop (the positions copied into one
  static tensor, the step's state passed on) over static, in-cell and
  jittered positions equals the JAX ``make_step_fn()`` on the tile path
  and ``make_step_fn(fast=False)`` inside a jitted ``lax.fori_loop``:
  the counts checksum, each step's lists as sets and its ``cand_max``,
  ``tile_overflow``, ``dense_overflow``, ``n_cells`` and ``error`` (those
  the JAX solution has).

Tolerance: none, everything is compared exactly.  The data is random, so
no pair sits at the radius, where XLA's FMA contraction on the CPU could
decide it otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_step_guard import assert_same, no_host_reads
from treensearch_tpu import TreeNSearch as JaxTreeNSearch
from treensearch_tpu_torch import TreeNSearch
from treensearch_tpu_torch.ops import cond as tcond
from treensearch_tpu_torch.ops import fastpath as tfp
from treensearch_tpu_torch.ops.grid import fresh_state
from treensearch_tpu_torch.ops.zsort import make_zsort_step
from treensearch_tpu_torch.utils.keys import quantize

R = 0.12
CAPS = {"tiles": 40, "dense": 1 << 14, "wcap": 64, "nbr": 64}


def _case(kind):
    """(sets, radii per set or None, active pairs, use_pallas): at most
    200 points per set, in a box of half the unit cube (about a dozen
    neighbors per point)."""
    rng = np.random.default_rng(sum(map(ord, kind)))

    def cloud(n):
        return rng.uniform(0, 0.5, (n, 3)).astype(np.float32)

    if kind == "ten_sets":
        # a fluid and nine rigid bodies; the fluid searches every set
        sets = [cloud(200)] + [cloud(24) * 0.6 + rng.uniform(0, 0.2, 3)
                               .astype(np.float32) for _ in range(9)]
        return sets, None, [(0, j) for j in range(10)] + [(4, 0)], True
    if kind == "variable_symmetric":
        return [cloud(200)], [rng.uniform(0.06, 0.12, 200)
                              .astype(np.float32)], [(0, 0)], False
    if kind == "two_sets":
        wall = cloud(120)
        wall[:, 2] = 0
        return [cloud(200), wall], None, [(0, 0), (0, 1), (1, 0)], False
    if kind == "column":
        # one or two grid rows of 200 points: windows far past 16 slots
        pts = cloud(200) * np.float32([0.2, 0.2, 2.0])
        return [pts.astype(np.float32)], None, [(0, 0)], False
    return [cloud(200)], None, [(0, 0)], False       # one set


def _engine(cls, kind):
    sets, radii, active, use_pallas = _case(kind)
    eng = cls()
    for k, pts in enumerate(sets):
        eng.add_point_set(pts, None if radii is None else radii[k])
    if radii is None:
        eng.set_search_radius(R)
    else:
        eng.set_symmetric_search(True)
    eng.set_cell_size(R)
    for i, j in active:
        eng.set_active_search(i, j, True)
    eng.set_use_pallas(use_pallas)
    eng.set_window_cap(CAPS["wcap"])
    eng.set_neighbor_cap(CAPS["nbr"])
    eng._tiles_cap = CAPS["tiles"]
    eng._dense_cap = CAPS["dense"]
    return eng


def _inputs(kind):
    sets, radii, _, _ = _case(kind)
    pts = torch.from_numpy(np.concatenate(sets))
    return (pts,) if radii is None else (pts, torch.from_numpy(
        np.concatenate(radii)))


def _port_step(kind, fast):
    return _engine(lambda: TreeNSearch(device="cpu"), kind) \
        .make_step_fn(fast=fast)


# ----------------------------------------------------------- no host read
GUARD_CASES = [("tile", k) for k in ("one_set", "ten_sets",
                                     "variable_symmetric")] \
    + [("pipeline", k) for k in ("one_set", "variable_symmetric",
                                 "two_sets")]


@pytest.mark.parametrize("route,kind", GUARD_CASES)
def test_step_reads_nothing_back_and_accepts_capture(monkeypatch, route,
                                                     kind):
    step, state = _port_step(kind, route == "tile")
    args = _inputs(kind)
    _, state = step(state, *args)
    want, state = step(state, *args)
    # the route taken: the tile path's rows are per point, the pipeline
    # has no dense table
    assert ("dense_overflow" in want) == (route == "tile")
    assert all("nbrs" in p for p in want["pairs"].values())
    assert not int(want["cand_max"]) or route == "pipeline"
    monkeypatch.setattr(tcond, "capturing", lambda: True)
    no_host_reads(monkeypatch)
    got, state = step(state, *args)
    monkeypatch.undo()
    assert_same(got, want)


def test_zsort_step_reads_nothing_back(monkeypatch):
    rng = np.random.default_rng(3)
    sets = [torch.from_numpy(rng.uniform(-1, 2, (m, 3)).astype(np.float32))
            for m in (200, 120, 60)]
    arrays = [[p[:, 0].clone(), torch.arange(p.shape[0], dtype=torch.int64)]
              for p in sets]
    step = make_zsort_step(3)
    want = step(sets, arrays)
    monkeypatch.setattr(tcond, "capturing", lambda: True)
    no_host_reads(monkeypatch)
    got = step(sets, arrays)
    monkeypatch.undo()
    assert_same(got, want)


# ---------------------------------------------------------- static sizes
@pytest.mark.parametrize("kind", ["one_set", "ten_sets",
                                  "variable_symmetric", "cut_window"])
def test_static_sized_tile_path_equals_the_snug_one(kind):
    eng = _engine(lambda: TreeNSearch(device="cpu"),
                  "column" if kind == "cut_window" else kind)
    eng.run()
    points, radii, sr, cell, w = eng._setup()
    cfg = eng._make_cfg(w)
    knobs = eng._knobs()._replace(fused=False)
    if kind == "cut_window":
        knobs = knobs._replace(wcap=16)
    consts = tfp.step_constants(cfg, knobs, cell, "cpu", search_radius=sr)
    sols = [tfp.build_and_search_fast(
        points, sr, fresh_state(), cfg, knobs, radii=radii, consts=consts,
        snug_tiles=snug)[0] for snug in (False, True)]
    assert_same(*sols)
    cut = int(sols[0]["cand_max"])
    assert (cut > 16) == (kind == "cut_window")
    # dead tiles past the live ones are tested too
    assert int(sols[0]["tiles_used"]) < knobs.tiles_cap


# ---------------------------------------------------------- against JAX
S_EACH = 2   # steps per regime: static, in-cell, jittered


def _positions(kind, step, state, points):
    """(3 S_EACH, n, 3) float32: static, then moves below 1e-6 that keep
    every point in its cell (against the step's grid), then jitter of
    2e-3 that moves points across cells."""
    rng = np.random.default_rng(11)
    _, state = step(state, *(points,) + _inputs(kind)[1:])
    inv = 1.0 / state.cell_size
    pts = points.numpy()

    def cells(p):
        return quantize(torch.from_numpy(p), state.grid_min, inv,
                        state.n_cells).numpy()

    seq, cur = [pts] * S_EACH, pts
    for _ in range(S_EACH):
        moved = (cur + rng.uniform(-1e-6, 1e-6, cur.shape)).astype(np.float32)
        keep = (cells(moved) == cells(cur)).all(axis=1)
        cur = np.where(keep[:, None], moved, cur).astype(np.float32)
        seq.append(cur)
    for _ in range(S_EACH):
        cur = (cur + rng.uniform(-2e-3, 2e-3, cur.shape)).astype(np.float32)
        seq.append(cur)
    return np.stack(seq)


FLAGS = ("cand_max", "tile_overflow", "dense_overflow", "n_cells", "error")


def _jax_loop(kind, fast, seq, radii):
    """Per step of the JAX step inside one jitted ``lax.fori_loop``: the
    counts checksum, each pair's counts and rows sorted per row (the
    lists as sets) and the flags its solution has."""
    step, state0 = _engine(JaxTreeNSearch, kind).make_step_fn(fast=fast)
    jr = None if radii is None else jnp.asarray(radii.numpy())
    probe, _ = jax.eval_shape(lambda p, s: step(s, p, jr),
                              jnp.asarray(seq[0]), state0)
    flags = [f for f in FLAGS if f in probe]
    steps = seq.shape[0]

    @jax.jit
    def loop(seq, state):
        out0 = {p: (jnp.zeros((steps,) + v["counts"].shape, jnp.int32),
                    jnp.zeros((steps,) + v["nbrs"].shape, jnp.int32))
                for p, v in probe["pairs"].items()}

        def body(i, carry):
            state, acc, out, fl = carry
            sol, state = step(state, jax.lax.dynamic_index_in_dim(
                seq, i, keepdims=False), jr)
            out = {p: (c.at[i].set(sol["pairs"][p]["counts"]),
                       r.at[i].set(jnp.sort(sol["pairs"][p]["nbrs"], 1)))
                   for p, (c, r) in out.items()}
            acc = acc + sum(jnp.sum(v["counts"][::7], dtype=jnp.int32)
                            for v in sol["pairs"].values())
            fl = fl.at[i].set(jnp.stack([sol[f].astype(jnp.int32)
                                         for f in flags]))
            return state, acc, out, fl

        return jax.lax.fori_loop(0, steps, body, (
            state, jnp.int32(0), out0,
            jnp.zeros((steps, len(flags)), jnp.int32)))[1:]

    acc, out, fl = loop(jnp.asarray(seq), state0)
    return int(acc), {p: (np.asarray(c), np.asarray(r))
                      for p, (c, r) in out.items()}, flags, np.asarray(fl)


@pytest.mark.parametrize("route,kind", [("tile", "one_set"),
                                        ("tile", "ten_sets"),
                                        ("pipeline", "one_set"),
                                        ("pipeline", "variable_symmetric")])
def test_replay_loop_equals_jax_fori_loop(route, kind):
    fast = route == "tile"
    step, state = _port_step(kind, fast)
    args = _inputs(kind)
    seq = _positions(kind, *_port_step(kind, fast), args[0])
    jacc, jout, flags, jfl = _jax_loop(kind, fast, seq,
                                       args[1] if len(args) > 1 else None)
    static = args[0].clone()
    acc = 0
    for k in range(seq.shape[0]):
        static.copy_(torch.from_numpy(seq[k]))
        sol, state = step(state, static, *args[1:])
        assert ("dense_overflow" in sol) == fast
        assert all("nbrs" in p for p in sol["pairs"].values())
        acc += sum(int(v["counts"][::7].sum(dtype=torch.int32))
                   for v in sol["pairs"].values())
        assert set(sol["pairs"]) == set(jout)
        for p, (jc, jr) in jout.items():
            got = sol["pairs"][p]
            assert np.array_equal(got["counts"].numpy(), jc[k]), (k, p)
            assert np.array_equal(torch.sort(got["nbrs"], 1).values.numpy(),
                                  jr[k]), (k, p)
        assert [int(sol[f]) for f in flags] == jfl[k].tolist(), k
    assert acc == jacc > 0
    assert "cand_max" in flags and "n_cells" in flags
    assert fast == ("tile_overflow" in flags)
