"""The port's zero-host-sync step (``make_step_fn``) on the CPU: what a CUDA
graph capture of it needs, checked without a card.

- **No host read.**  With ``rebuild_if`` patched to take a given branch,
  and every tensor method that reads a value back to the host
  (``item``, ``tolist``, ``numpy``, ``cpu``, ``__bool__``, ``__int__``,
  ``__float__``, ``__index__``) and ``torch.tensor`` made to raise outside
  the kernel wrappers (on the card each of those is one launch; on the CPU
  it runs its plain version), the reuse, density, capped mask, split,
  fused non-carried, variable symmetric and two-set steps run and equal
  the unpatched eager step, on both branches.  Eagerly the carried step
  reads its predicate exactly once.
- **State and checksum against JAX.**  A replay-style loop (the step's
  state passed on as the step leaves it, the positions copied into one
  static tensor) over static, in-cell and jittered positions equals the
  JAX ``make_step_fn(reuse=True)`` inside a jitted ``lax.fori_loop`` as
  ``bench.py`` builds it (its Pallas kernel in interpret mode): the
  counts checksum, the rebuild count, the final carry's fields (through
  ``interop.py``) and grid.
- **K4's row cap.**  The plain K4 below, at and above the row count:
  counts exact, the live rows those of the uncapped call; the mask step
  with a cap below its rows flags ``mask_overflow`` with exact counts.
- **Capture refusals.**  With the capturing check patched to say yes, the
  sharded step over a gloo group raises ``ValueError`` naming NCCL (gloo
  cannot be captured; the step over NCCL captures:
  ``test_torch_sharded.py``, ``test_torch_cuda.py``), and ``rebuild_if``
  raises for a host predicate and where PyTorch has no memory pool for a
  conditional node's body.  (The tile-path and pipeline steps capture:
  ``test_torch_step_graph_fallbacks.py``.)

Tolerance: none, everything is compared bit for bit, except the JAX
grid's ``grid_max``, a mul+add that XLA may contract to an FMA: within
one float32 ulp (``ops/grid.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_step_guard import assert_same, no_host_reads
from treensearch_tpu import TreeNSearch as JaxTreeNSearch
from treensearch_tpu.oracle import BruteforceNSearch
from treensearch_tpu_torch import TreeNSearch, interop
from treensearch_tpu_torch import api as tapi
from treensearch_tpu_torch.config import SearchConfig
from treensearch_tpu_torch.ops import cond as tcond
from treensearch_tpu_torch.ops import fastpath as tfp
from treensearch_tpu_torch.ops import pairs as tpp
from treensearch_tpu_torch.ops.grid import fresh_state
from treensearch_tpu_torch.parallel.sharded import make_sharded_step
from treensearch_tpu_torch.utils.keys import quantize

N, R = 160, 0.25


def _cloud(n=N, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n, 3)) \
        .astype(np.float32)


def _engine(sets, r=R, radii=None):
    eng = TreeNSearch(device="cpu")
    for k, pts in enumerate(sets):
        eng.add_point_set(pts, None if radii is None else radii[k])
    if radii is None:
        eng.set_search_radius(r)
    eng.set_all_searches(True)
    return eng


def _density(env):
    return env["p0_j"] * (R * R - env["d2"]) ** 3


def _step_case(kind):
    """(step, state, args, kwargs) of one kind of step on a small cloud,
    with the engine settled as a user would settle it."""
    pts = _cloud()
    kw = {}
    if kind == "variable_symmetric":
        rad = np.random.default_rng(1).uniform(0.06, 0.12, N) \
            .astype(np.float32)
        eng = _engine([pts], radii=[rad])
        args = (torch.from_numpy(pts), torch.from_numpy(rad))
    elif kind == "two_sets":
        wall = _cloud(120, 2)
        wall[:, 2] = 0
        eng = _engine([pts, wall])
        args = (torch.from_numpy(np.concatenate([pts, wall])),)
    else:
        eng = _engine([pts])
        args = (torch.from_numpy(pts),)
    if kind == "split":
        eng.set_split_stage(True)
    eng.run()
    if kind == "density":
        mass = np.random.default_rng(3).uniform(0.5, 1.5, N) \
            .astype(np.float32)
        step, state = eng.make_step_fn(reduce=(_density, 1))
        kw["payload"] = torch.from_numpy(
            np.stack([mass, np.zeros_like(mass)], 1))
    elif kind == "mask":
        eng.run_mask()
        step, state = eng.make_step_fn(mask_output=True)
    elif kind == "fused":
        step, state = eng.make_step_fn()
    else:
        step, state = eng.make_step_fn(reuse=True)
    return step, state, args, kw


STEP_KINDS = ("reuse", "density", "mask", "split", "fused",
              "variable_symmetric", "two_sets")
GUARD_CASES = [(k, b) for k in STEP_KINDS
               for b in (("none",) if k == "fused" else ("rebuild", "reuse"))]


@pytest.mark.parametrize("kind,branch", GUARD_CASES)
def test_step_reads_nothing_back(monkeypatch, kind, branch):
    step, state, args, kw = _step_case(kind)
    _, state = step(state, *args, **kw)      # rebuilds: a valid carry
    want, state = step(state, *args, **kw)   # the same points
    if branch != "none":
        assert int(want["rebuilt"]) == 0
        monkeypatch.setattr(tfp, "rebuild_if",
                            lambda pred, fn: fn() if branch == "rebuild"
                            else None)
    calls = tfp._prep.calls
    no_host_reads(monkeypatch)
    got, state = step(state, *args, **kw)
    monkeypatch.undo()
    assert tfp._prep.calls - calls == int(branch != "reuse")
    assert_same(got, want)


def test_eager_carried_step_reads_its_predicate_once(monkeypatch):
    step, state, args, _ = _step_case("reuse")
    reads = []
    orig = torch.Tensor.__bool__

    def count(t):
        reads.append(t.shape)
        return orig(t)

    for expect in (1, 0):
        monkeypatch.setattr(torch.Tensor, "__bool__", count)
        reads.clear()
        sol, state = step(state, *args)
        monkeypatch.undo()
        assert reads == [torch.Size([])]
        assert int(sol["rebuilt"]) == expect


# ----------------------------------------------- state and checksum vs JAX
N_JAX, S_EACH = 160, 2    # points; steps per workload (static, in-cell,
#                           jittered)


def _positions():
    """(3 S_EACH, n, 3) float32: static, then moves below 1e-6 that keep
    every point in its cell (against the grid of the static cloud), then
    jitter of 2e-3 that moves points across cells."""
    rng = np.random.default_rng(11)
    pts = rng.uniform(0, 1, (N_JAX, 3)).astype(np.float32)
    eng = _engine([pts])
    step, state = eng.make_step_fn(reuse=True)
    _, state = step(state, torch.from_numpy(pts))
    grid = state[0]
    inv = 1.0 / grid.cell_size

    def cells(p):
        return quantize(torch.from_numpy(p), grid.grid_min, inv,
                        grid.n_cells).numpy()

    seq, cur = [pts] * S_EACH, pts
    for _ in range(S_EACH):
        moved = (cur + rng.uniform(-1e-6, 1e-6, cur.shape)) \
            .astype(np.float32)
        keep = (cells(moved) == cells(cur)).all(axis=1)
        cur = np.where(keep[:, None], moved, cur).astype(np.float32)
        seq.append(cur)
    for _ in range(S_EACH):
        cur = (cur + rng.uniform(-2e-3, 2e-3, cur.shape)).astype(np.float32)
        seq.append(cur)
    return np.stack(seq)


def _jax_engine(pts):
    eng = JaxTreeNSearch()
    eng.add_point_set(pts)
    eng.set_search_radius(R)
    eng.set_all_searches(True)
    eng.set_use_pallas(True, interpret=True)
    # the interpreter runs every grid step in Python: small caps
    eng._fat_cap = 16
    eng._tiles_cap = 64
    eng._dense_cap = 1 << 14
    eng.set_window_cap(64)
    return eng


def test_replay_loop_state_and_checksum_equal_jax_fori_loop():
    seq = _positions()
    step, state0 = _jax_engine(seq[0]).make_step_fn(reuse=True)

    @jax.jit
    def loop(seq, state):
        def body(i, carry):
            state, acc, rebuilt = carry
            sol, state = step(state, jax.lax.dynamic_index_in_dim(
                seq, i, keepdims=False))
            acc = acc + jnp.sum(sol["pairs"]["0-0"]["counts"][::257],
                                dtype=jnp.int32)
            return state, acc, rebuilt + sol["rebuilt"]
        return jax.lax.fori_loop(0, seq.shape[0], body,
                                 (state, jnp.int32(0), jnp.int32(0)))

    (jgrid, jcarry), jacc, jrebuilt = loop(jnp.asarray(seq), state0)

    eng = _engine([seq[0]])
    eng._tiles_cap = 64
    eng._dense_cap = 1 << 14
    step, state = eng.make_step_fn(reuse=True)
    static = torch.from_numpy(seq[0]).clone()
    acc = torch.zeros((), dtype=torch.int32)
    rebuilt = torch.zeros((), dtype=torch.int32)
    for k in range(seq.shape[0]):
        static.copy_(torch.from_numpy(seq[k]))
        sol, state = step(state, static)
        acc += sol["pairs"]["0-0"]["counts"][::257].sum(dtype=torch.int32)
        rebuilt += sol["rebuilt"]
    assert int(acc) == int(jacc)
    assert int(rebuilt) == int(jrebuilt)
    assert 1 < int(rebuilt) < seq.shape[0]
    grid, carry = state
    want = interop.carry_from_numpy(
        {k: np.asarray(v) for k, v in jcarry._asdict().items()})
    for k in ("valid", "lin_s", "lin_chk", "r_chk", "idx_s", "inv_perm",
              "pp", "qpos", "dense_overflow", "tile_overflow",
              "rows_overflow", "win_max", "n_cells_stat"):
        assert torch.equal(getattr(carry, k), getattr(want, k)), k
    # the JAX engine's carry keeps window starts in padded-slot space
    # (pack 1); the lengths, tile extents and dead tiles are the same
    d, wd = carry.desc, want.desc
    assert torch.equal(d[:, tpp.A_COL:], wd[:, tpp.A_COL:])
    wgrid = interop.grid_state_from_numpy(
        {k: np.asarray(v) for k, v in jgrid._asdict().items()})
    for k in ("valid", "grid_min", "n_cells", "cell_size", "error"):
        assert torch.equal(getattr(grid, k), getattr(wgrid, k)), k
    ulp = np.spacing(wgrid.grid_max.numpy())
    assert (np.abs(grid.grid_max.numpy() - wgrid.grid_max.numpy())
            <= ulp).all()


# --------------------------------------------------------- K4's row cap
def _k4_inputs():
    pts = torch.from_numpy(_cloud())
    eng = _engine([pts.numpy()])
    eng.run()
    cfg = eng._make_cfg(1)
    knobs = eng._knobs()
    carry = tfp._prep(pts, eng._grid_state, cfg, knobs,
                      consts=tfp.step_constants(
                          cfg, knobs, float(eng._grid_state.cell_size),
                          "cpu", search_radius=R))
    a = tfp.kernel_inputs(pts, R, carry, cfg, knobs)
    q = tpp.expand_query_tiles(a.desc, a.recs_t, a.tiles_cap, N)
    allow = tfp.allow_table(cfg, a.cand_sets, "cpu")
    return (a.desc, q, a.recs_t, a.n_win, a.tiles_cap, a.cand_sets, allow), \
        tfp.active_args(a)


@pytest.mark.parametrize("where", ["below", "at", "above"])
def test_plain_k4_row_cap(where):
    args, kw = _k4_inputs()
    counts, bits, base = tpp.pairs_mask_plain(*args, **kw)
    rows = int(base[-1])
    cap = {"below": rows // 3, "at": rows, "above": rows + 77}[where]
    c_cap, b_cap, base_cap = tpp.pairs_mask(*args, **kw, rows_cap=cap)
    assert torch.equal(c_cap, counts) and torch.equal(base_cap, base)
    assert tuple(b_cap.shape) == (cap, tpp.MASK_WORDS)
    live = min(cap, rows)
    assert torch.equal(b_cap[:live], bits[:live])
    assert not b_cap[live:].any()
    assert int(tfp._mask_flags(base_cap, cap)["mask_overflow"]) \
        == int(where == "below")


def test_mask_step_with_a_cap_below_its_rows_flags_overflow(monkeypatch):
    eng = _engine([_cloud()])
    eng.run_mask()
    mask, meta = eng.run_mask()   # at the caps the first call's snug set
    rows = int(mask["cand_base"][-1])
    assert eng._last_stats["mask_rows"] == rows
    monkeypatch.setattr(tapi, "mask_rows_cap", lambda r: r // 2)
    step, state = eng.make_step_fn(mask_output=True)
    p = torch.from_numpy(_cloud())
    for rebuilt in (1, 0):
        sol, state = step(state, p)
        assert int(sol["rebuilt"]) == rebuilt
        assert int(sol["mask_overflow"]) == 1 and int(sol["mask_rows"]) == rows
        assert sol["mask"]["bits"].shape[0] == rows // 2
        assert torch.equal(sol["mask"]["counts_flat"], mask["counts_flat"])
        assert torch.equal(sol["mask"]["bits"], mask["bits"][:rows // 2])
        # the dropped rows cannot be decoded
        with pytest.raises(ValueError, match="mask_overflow"):
            tfp.decode_mask(sol["mask"], meta)


def test_split_step_cap_from_the_settled_split_run():
    eng = _engine([_cloud()])
    eng.set_split_stage(True)
    eng.run()
    rows = eng._last_stats["mask_rows"]
    want = eng.get_counts(0, 0)
    step, state = eng.make_step_fn(reuse=True)
    sol, _ = step(state, torch.from_numpy(_cloud()))
    assert int(sol["mask_rows"]) == rows and int(sol["mask_overflow"]) == 0
    assert np.array_equal(sol["pairs"]["0-0"]["counts"].numpy(), want)


def test_split_step_with_a_cap_below_its_rows_is_short(monkeypatch):
    # K5 reads only K4's rows below the cap: under overflow the split
    # step's counts and rows are those of the kept rows, a subset of the
    # exact ones, and mask_overflow says so
    eng = _engine([_cloud()])
    eng.set_split_stage(True)
    eng.run()
    rows = eng._last_stats["mask_rows"]
    want_c, want_n = (t.numpy() for t in eng.get_neighbors(0, 0))
    monkeypatch.setattr(tapi, "mask_rows_cap", lambda r: r // 2)
    step, state = eng.make_step_fn(reuse=True)
    p = torch.from_numpy(_cloud())
    for rebuilt in (1, 0):
        sol, state = step(state, p)
        assert int(sol["rebuilt"]) == rebuilt
        assert int(sol["mask_overflow"]) == 1 and int(sol["mask_rows"]) == rows
        pair = sol["pairs"]["0-0"]
        got_c = pair["counts"].numpy()
        got_n = tfp.materialize_nbrs(dict(pair)).numpy()
        assert (got_c <= want_c).all() and got_c.sum() < want_c.sum()
        for i in range(N):
            assert set(got_n[i, :got_c[i]]) <= set(want_n[i, :want_c[i]])


def test_tile_path_run_and_step_with_33_candidate_sets():
    # more candidate sets than an allow-table entry has bits: the tile
    # path makes no active matrix, so run() and a step work (vs oracle)
    rng = np.random.default_rng(5)
    sets = [rng.uniform(0, 1, (6, 3)).astype(np.float32) for _ in range(33)]
    eng, orc = TreeNSearch(device="cpu"), BruteforceNSearch(search_radius=R)
    for e in (eng, orc):
        for pts in sets:
            e.add_point_set(pts)
        for k in range(len(sets)):
            e.set_active_search(k, k, True)
    eng.set_search_radius(R)
    eng.run()
    orc.run()
    orc.compare(eng)
    step, state = eng.make_step_fn()
    sol, _ = step(state, torch.from_numpy(np.concatenate(sets)))
    for k in range(len(sets)):
        assert np.array_equal(sol["pairs"][f"{k}-{k}"]["counts"].numpy(),
                              eng.get_counts(k, k))


# ------------------------------------------------------- capture refusals
@pytest.fixture
def capturing(monkeypatch):
    monkeypatch.setattr(tcond, "capturing", lambda: True)


def test_sharded_step_over_gloo_refuses_capture(capturing, tmp_path):
    # a gloo group cannot be captured: the step raises before it runs
    # anything, naming NCCL, and never falls back to an eager step
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        mesh = DeviceMesh("cpu", [0], mesh_dim_names=("d",))
        step = make_sharded_step(SearchConfig((N,), ((0, 0),), 1, 64), mesh,
                                 0.16, R)
        state = fresh_state()
        with pytest.raises(ValueError, match="over NCCL"):
            step(state, torch.from_numpy(_cloud()))
        assert_same(state, fresh_state())
    finally:
        dist.destroy_process_group()


def test_rebuild_if_refuses_what_a_conditional_node_cannot_take(
        capturing, monkeypatch):
    # a host predicate, or a PyTorch without memory pools for the body:
    # an error, never a host read
    ran = []
    with pytest.raises(ValueError, match="CUDA bool predicate"):
        tcond.rebuild_if(torch.ones((), dtype=torch.bool),
                         lambda: ran.append(1))
    monkeypatch.delattr(torch.cuda, "MemPool", raising=False)
    with pytest.raises(RuntimeError, match="MemPool"):
        tcond.rebuild_if(torch.ones((), dtype=torch.bool),
                         lambda: ran.append(1))
    assert not ran
