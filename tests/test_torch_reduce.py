"""The fused neighbor-reduce of the port (K3, ``ops/reduce.py``) against
the JAX package and the numpy oracle.

- **Kernel.** K3's plain version (the one the wrapper takes for CPU
  tensors) against the JAX Pallas kernel ``make_pairs_call(reduce_fn=...)``
  in interpret mode, on the JAX prep, records and query tiles carried into
  the port with ``interop``: three fixed-radius sets under an asymmetric
  active matrix (set 2 searches nothing) with a payload, and one set with
  per-point radii and symmetric search.  One module-scoped JAX reference
  per case; every window fits the narrow tier (asserted).
- **Engine.** ``TreeNSearch(device="cpu").run_reduce`` against the numpy
  O(n^2) oracle and the JAX ``run_reduce`` (one module-scoped call), with
  the same callback written in ``jnp`` and in ``torch``.
- **Tracer.** Each supported operation gives the same tensor through the
  traced expression (``reduce.evaluate``, operation by operation as the
  generated CUDA) as eagerly; anything else raises ``TypeError``.

Tolerance: counts (the ``ones_like`` leg) and integer-valued legs equal;
the other legs within rtol 3e-5 (atol 1e-6), as ``tests/test_reduce.py``:
only the order of the float32 sum differs, and every leg here is a sum of
non-negative terms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from treensearch_tpu import TreeNSearch as JaxTreeNSearch
from treensearch_tpu.config import SearchConfig as JaxConfig
from treensearch_tpu.ops import fastpath as jfp
from treensearch_tpu.ops import grid as jgrid
from treensearch_tpu.ops import pallas_pairs as jpp
from treensearch_tpu_torch import TreeNSearch, interop
from treensearch_tpu_torch.config import SearchConfig
from treensearch_tpu_torch.ops import fastpath as tfp
from treensearch_tpu_torch.ops import pairs as tpp
from treensearch_tpu_torch.ops import reduce as trd

PACK = 8
KNOBS = jfp.FastKnobs(use_pallas=True, interpret=True, wcap=64,
                      fat_wcap=128, fat_cap=16, dense_cap=1 << 14,
                      rows_cap=1 << 10, pack=PACK, lane_batch=True,
                      rec_expand=True)
SIZES = (120, 80, 60)
ACTIVE = ((0, 0), (0, 2), (1, 0))   # set 2 searches nothing
R = 0.15
RTOL, ATOL = 3e-5, 1e-6


def _bits(x):
    return jax.lax.bitcast_convert_type(x, jnp.int32)


def _jax_side(points, radii, set_ids, payload, r, cell, *, cfg, kernel):
    """JAX prep, sorted records (payload in fields 6 and 7), query tiles
    and the narrow tier of one reduce- or mask-mode pairs kernel, as
    ``fastpath._pallas_search`` builds them (rec_expand)."""
    n = cfg.n_points
    st = jfp._pallas_statics(cfg, KNOBS)
    state = jgrid.update_grid(jgrid.fresh_state(), points, cell)
    carry = jfp._pallas_prep(points, radii, state, cfg, KNOBS)
    rf = radii if cfg.variable else jnp.zeros((n,), jnp.float32)
    fields = list(jax.lax.sort(
        (carry.lin_chk, _bits(points[:, 0]), _bits(points[:, 1]),
         _bits(points[:, 2]), _bits(rf), jnp.arange(n, dtype=jnp.int32),
         set_ids, _bits(payload[:, 0]), _bits(payload[:, 1])),
        num_keys=1, is_stable=True)[1:])
    sent = jnp.zeros((8,), jnp.int32).at[0:3].set(
        _bits(jnp.float32(jpp.SENTINEL))).at[4].set(n).at[5].set(-1)
    lpp = 128 // PACK
    cols = jnp.pad(jnp.stack(fields, axis=1), ((0, 0), (0, lpp - 8)))
    n_rows = -(-n // PACK) + max(lpp, st["fat_wcap"] // PACK) + 4
    recs = jnp.concatenate(
        [cols, jnp.broadcast_to(jnp.pad(sent, (0, lpp - 8))[None],
                                (n_rows * PACK - n, lpp))]
    ).reshape(n_rows, 128)
    recs_t = jnp.concatenate(
        [jnp.stack(fields), jnp.broadcast_to(sent[:, None], (8, 384))],
        axis=1)
    tiles_cap = st["tiles_cap"]
    q_t = jpp.make_expand_call(
        tiles_cap, tiles_cap, PACK, n, interpret=True,
        slack_tiles=st["slack"] // 128, build_rec=False)(carry.desc, recs_t)
    params = jnp.zeros((8, 128), jnp.float32).at[0, 0].set(r * r)
    cand = st["cand_sets"]
    n_win = len(st["offs_2d"])
    outs = jpp.make_pairs_call(
        st["wcap"], (8,) * n_win, (), n_win, variable=cfg.variable,
        symmetric=cfg.symmetric, cand_sets=cand,
        cand_offsets=tuple(cfg.set_offsets[j] for j in cand),
        multi_set=cfg.n_sets > 1, center_wins=st["center_wins"],
        interpret=True, pack=PACK, lane_batch=True,
        n_sets_total=cfg.n_sets, reduce_active=tuple(cfg.active_pairs),
        fat_tier=False, tiles_per_step=KNOBS.tps, **dict(kernel))(
        tiles_cap, carry.desc, params, q_t, recs)
    return carry, recs_t, q_t, outs


def jax_kernel_reference(points, radii, sizes, active, payload, r, cell,
                         kernel: dict) -> dict:
    """One interpret-mode compile of ``_jax_side`` with ``kernel`` (the
    reduce or mask keywords of ``make_pairs_call``), and the port's view
    of the same structures."""
    n = sum(sizes)
    variable = radii is not None
    cfg = JaxConfig(sizes, tuple(active), variable, variable, 1, 128, 256,
                    64)
    set_ids = np.repeat(np.arange(len(sizes), dtype=np.int32), sizes)
    carry, recs_t, q_t, outs = jax.jit(
        _jax_side, static_argnames=("cfg", "kernel"))(
        jnp.asarray(points), None if radii is None else jnp.asarray(radii),
        jnp.asarray(set_ids), jnp.asarray(payload), jnp.float32(r),
        jnp.float32(cell), cfg=cfg, kernel=tuple(kernel.items()))
    st = jfp._pallas_statics(cfg, KNOBS)
    c = {k: np.asarray(v) for k, v in carry._asdict().items()}
    tiles_cap = st["tiles_cap"]
    port_cfg = SearchConfig(sizes, tuple(active), 1, 64, variable, variable)
    desc = interop.carry_from_numpy(c).desc
    lane = np.arange(128)
    live = (lane[None, :] < c["desc"][:tiles_cap, tpp.CNT_COL, None]) \
        & (c["desc"][:tiles_cap, tpp.FAT_COL, None] != 2)
    return {
        "cfg": cfg, "port_cfg": port_cfg, "carry": c, "st": st,
        "tiles_cap": tiles_cap, "n_win": len(st["offs_2d"]),
        "cand_sets": st["cand_sets"], "outs": [np.asarray(o) for o in outs],
        "q_t_np": np.asarray(q_t), "recs_t_np": np.asarray(recs_t),
        "live": np.nonzero(live.reshape(-1))[0],
        # the port's kernel arguments on the JAX structures
        "args": (desc,
                 torch.from_numpy(np.array(q_t)[:, :tiles_cap * 128])
                 .contiguous(),
                 torch.from_numpy(np.array(recs_t)[:, :n]).contiguous(),
                 len(st["offs_2d"]), tiles_cap),
        "allow": tfp.allow_table(port_cfg, st["cand_sets"], "cpu"),
        "active_kw": {"r2": None if variable
                      else float(np.float32(r) * np.float32(r)),
                      "symmetric": variable},
    }


def fixed_case_data():
    """Three fixed-radius sets in [0, 0.5]^3 and their payload: two
    columns for set 0, one for set 1, none for set 2."""
    rng = np.random.default_rng(31)
    pts = rng.uniform(0, 0.5, (sum(SIZES), 3)).astype(np.float32)
    per_set = [rng.uniform(0.5, 1.5, (SIZES[0], 2)).astype(np.float32),
               rng.uniform(0.5, 1.5, SIZES[1]).astype(np.float32), None]
    return pts, per_set


def variable_case_data():
    rng = np.random.default_rng(32)
    pts = rng.uniform(0, 0.5, (200, 3)).astype(np.float32)
    rad = rng.uniform(0.08, 0.16, 200).astype(np.float32)
    return pts, rad


def payload_columns(per_set, sizes):
    """The engine's zero-padded (n, 2) payload of per-set columns."""
    out = np.zeros((sum(sizes), 2), np.float32)
    off = 0
    for p, m in zip(per_set, sizes):
        if p is not None:
            p = p.reshape(m, -1)
            out[off:off + m, :p.shape[1]] = p
        off += m
    return out


def oracle_mask(pts, sid, active, r=None, radii=None, symmetric=False):
    """The numpy O(n^2) rule: d^2 in float32 against r^2 (or r_i^2, or
    also r_j^2), the active matrix, self excluded.  Returns (mask, d2)."""
    d = pts[None, :, :] - pts[:, None, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    if radii is None:
        m = d2 <= np.float32(r) * np.float32(r)
    else:
        m = d2 <= (radii * radii)[:, None]
        if symmetric:
            m |= d2 <= (radii * radii)[None, :]
    am = np.zeros((sid.max() + 1,) * 2, bool)
    for i, j in active:
        am[i, j] = True
    m &= am[sid[:, None], sid[None, :]]
    np.fill_diagonal(m, False)
    return m, d2


# the callbacks, in jnp for the JAX package and in torch for the port
def jfn_fixed(e):
    return (jnp.ones_like(e["d2"]), e["d2"] * e["p0_j"] + e["p1_i"],
            (e["orig_j"] + e["set_j"]).astype(jnp.float32), e["r2_i"])


def tfn_fixed(e):
    return (torch.ones_like(e["d2"]), e["d2"] * e["p0_j"] + e["p1_i"],
            (e["orig_j"] + e["set_j"]).float(), e["r2_i"])


def jfn_variable(e):
    return (jnp.ones_like(e["d2"]), e["d2"] * e["r_j"], e["r2_i"])


def tfn_variable(e):
    return (torch.ones_like(e["d2"]), e["d2"] * e["r_j"], e["r2_i"])


def _check_legs(got, want, exact=(0,)):
    for k in range(want.shape[0]):
        if k in exact:
            assert np.array_equal(got[k], want[k]), k
        else:
            assert np.allclose(got[k], want[k], rtol=RTOL, atol=ATOL), k


# ------------------------------------------------------------------ kernel
@pytest.fixture(scope="module")
def fixed_ref():
    pts, per_set = fixed_case_data()
    pl = payload_columns(per_set, SIZES)
    ref = jax_kernel_reference(pts, None, SIZES, ACTIVE, pl, R, R * 1.1,
                               {"reduce_fn": jfn_fixed, "reduce_n_out": 4})
    ref.update(pts=pts, payload=pl, tfn=tfn_fixed, n_out=4, exact=(0, 2))
    return ref


@pytest.fixture(scope="module")
def variable_ref():
    pts, rad = variable_case_data()
    ref = jax_kernel_reference(pts, rad, (200,), ((0, 0),),
                               np.zeros((200, 2), np.float32), 0.0, 0.16,
                               {"reduce_fn": jfn_variable,
                                "reduce_n_out": 3})
    ref.update(pts=pts, rad=rad, tfn=tfn_variable, n_out=3, exact=(0,))
    return ref


REFS = ["fixed_ref", "variable_ref"]


def _port_sums(ref, spec=None):
    spec = spec or trd.ReduceSpec(ref["tfn"], ref["n_out"], True)
    return trd.pairs_reduce(*ref["args"], spec, ref["cand_sets"],
                            ref["allow"], **ref["active_kw"]).numpy()


def _jax_sums(ref):
    out = ref["outs"][0]
    return np.stack([out[k::8].reshape(-1) for k in range(ref["n_out"])])


@pytest.mark.parametrize("name", REFS)
def test_jax_reference_is_narrow(name, request):
    ref = request.getfixturevalue(name)
    assert (ref["carry"]["fat_slot"] == -1).all()
    assert ref["live"].size == ref["cfg"].n_points


@pytest.mark.parametrize("name", REFS)
def test_plain_k3_matches_jax_kernel(name, request):
    ref = request.getfixturevalue(name)
    got, want = _port_sums(ref), _jax_sums(ref)
    live = ref["live"]
    assert want[0, live].sum() > 0
    _check_legs(got[:, live], want[:, live], ref["exact"])


def test_k3_r2_i_is_zero_at_a_fixed_radius(fixed_ref, variable_ref):
    # JAX's r2_i is the query's F_R squared: 0 at a fixed radius
    assert not _port_sums(fixed_ref)[3].any()
    assert not _jax_sums(fixed_ref)[3].any()
    v = _port_sums(variable_ref)
    live = variable_ref["live"]
    assert np.array_equal(v[2, live] > 0, v[0, live] > 0)


def test_k3_dead_tiles_and_sentinel_lanes_are_zero(fixed_ref):
    got = _port_sums(fixed_ref)
    dead = np.setdiff1d(np.arange(got.shape[1]), fixed_ref["live"])
    assert dead.size > 0 and not got[:, dead].any()


def test_k3_active_matrix_per_query_set(fixed_ref):
    # set 2 searches nothing; set 1 sums over set 0 only
    got = _port_sums(fixed_ref)
    qpos = fixed_ref["carry"]["qpos"]
    offs = fixed_ref["port_cfg"].set_offsets
    assert not got[:, qpos[offs[2]:]].any()
    orig_plus_set = got[2, qpos[offs[1]:offs[2]]]
    count = got[0, qpos[offs[1]:offs[2]]]
    assert count.sum() > 0
    # set 0's orig_j are below 120 and its set_j is 0
    assert (orig_plus_set <= count * (SIZES[0] - 1)).all()


def test_k3_plain_counts_no_launch(fixed_ref):
    before = trd.pairs_reduce.launches
    _port_sums(fixed_ref)
    assert trd.pairs_reduce.launches == before


# ------------------------------------------------------------------ engine
def _port_engine(sets, radii=None, r=None, active=None, symmetric=True):
    eng = TreeNSearch(device="cpu")
    for k, pts in enumerate(sets):
        eng.add_point_set(pts, None if radii is None else radii[k])
    if r is not None:
        eng.set_search_radius(r)
    eng.set_symmetric_search(symmetric)
    for i, j in active:
        eng.set_active_search(i, j, True)
    return eng


def _split(pts, sizes):
    return np.split(pts, np.cumsum(sizes)[:-1])


@pytest.fixture(scope="module")
def jax_engine_fixed():
    pts, per_set = fixed_case_data()
    eng = JaxTreeNSearch()
    for x in _split(pts, SIZES):
        eng.add_point_set(x)
    eng.set_search_radius(R)
    for i, j in ACTIVE:
        eng.set_active_search(i, j, True)
    eng.set_use_pallas(True, interpret=True)
    return eng.run_reduce(jfn_fixed, 4, payload=per_set)


def test_engine_run_reduce_vs_oracle_and_jax(jax_engine_fixed):
    pts, per_set = fixed_case_data()
    eng = _port_engine(_split(pts, SIZES), r=R, active=ACTIVE)
    got = eng.run_reduce(tfn_fixed, 4, payload=per_set)
    assert eng._last_stats["path"] == "reduce"
    sid = np.repeat(np.arange(3), SIZES)
    m, d2 = oracle_mask(pts, sid, ACTIVE, r=R)
    pl = payload_columns(per_set, SIZES)
    n = pts.shape[0]
    want = np.stack([
        m.sum(1),
        np.where(m, d2 * pl[None, :, 0] + pl[:, None, 1], 0)
        .sum(1, dtype=np.float64),
        np.where(m, np.arange(n)[None, :] + sid[None, :], 0).sum(1),
        np.zeros(n)])
    offs = np.cumsum((0,) + SIZES)
    for si in range(3):
        g = got[si]
        assert isinstance(g, torch.Tensor) and g.dtype == torch.float32
        assert tuple(g.shape) == (SIZES[si], 4)
        sl = slice(offs[si], offs[si + 1])
        _check_legs(g.numpy().T, want[:, sl], exact=(0, 2, 3))
        _check_legs(g.numpy().T, np.asarray(jax_engine_fixed[si]).T,
                    exact=(0, 2, 3))
    assert got[0][:, 0].sum() > 0 and got[1][:, 0].sum() > 0
    assert not got[2].any()


def test_engine_run_reduce_variable_symmetric_vs_oracle():
    pts, rad = variable_case_data()
    eng = _port_engine([pts], radii=[rad], active=((0, 0),))
    got = eng.run_reduce(tfn_variable, 3)[0].numpy().T
    m, d2 = oracle_mask(pts, np.zeros(200, int), ((0, 0),), radii=rad,
                        symmetric=True)
    want = np.stack([m.sum(1),
                     np.where(m, d2 * rad[None, :], 0).sum(1, dtype=np.float64),
                     m.sum(1) * rad.astype(np.float64) ** 2])
    _check_legs(got, want)


def test_run_lists_unchanged_after_run_reduce():
    pts, per_set = fixed_case_data()
    eng = _port_engine(_split(pts, SIZES), r=R, active=ACTIVE)
    eng.run()
    sol = eng._solution
    counts, nbrs = (t.clone() for t in eng.get_neighbors(0, 0))
    red = eng.run_reduce(lambda e: torch.ones_like(e["d2"]), 1)
    assert eng._solution is sol
    c2, n2 = eng.get_neighbors(0, 0)
    assert torch.equal(c2, counts) and torch.equal(n2, nbrs)
    # set 0 searches sets 0 and 2
    both = counts + eng.get_neighbors(0, 2)[0]
    assert torch.equal(red[0][:, 0], both.float())


def test_run_reduce_single_output_and_payload_shapes():
    pts, per_set = fixed_case_data()
    eng = _port_engine(_split(pts, SIZES), r=R, active=ACTIVE)
    one = eng.run_reduce(lambda e: e["p0_j"], payload=per_set)
    assert tuple(one[0].shape) == (SIZES[0], 1)
    with pytest.raises(ValueError, match="payload"):
        eng.run_reduce(lambda e: e["p0_j"], payload=per_set[:2])
    with pytest.raises(ValueError, match="payload"):
        eng.run_reduce(lambda e: e["p0_j"],
                       payload=[np.zeros((SIZES[0], 3)), None, None])


def test_run_reduce_wrong_arity_raises():
    pts, _ = fixed_case_data()
    eng = _port_engine(_split(pts, SIZES), r=R, active=ACTIVE)
    with pytest.raises(TypeError, match="outputs"):
        eng.run_reduce(lambda e: (e["d2"], e["d2"]), 1)


# ------------------------------------------------------------------ tracer
def _env(n=64, variable=True):
    rng = np.random.default_rng(5)
    env = {k: torch.from_numpy(rng.uniform(-2, 2, n).astype(np.float32))
           for k in trd.FLOAT_ENV}
    env["d2"] = env["d2"].abs() + 0.25
    env.update({k: torch.from_numpy(rng.integers(-50, 50, n)
                                    .astype(np.int32))
                for k in trd.INT_ENV})
    if variable:
        env["r_j"] = torch.from_numpy(rng.uniform(0.5, 1, n)
                                      .astype(np.float32))
    return env


OPS = {
    "add": lambda e: e["dx"] + e["dy"],
    "sub": lambda e: e["dx"] - 0.25,
    "rsub": lambda e: np.float32(4e-4) - e["d2"],
    "mul": lambda e: 3 * e["dx"] * e["p0_j"],
    "div": lambda e: e["dx"] / e["d2"],
    "rdiv": lambda e: 1.5 / e["d2"],
    "neg": lambda e: -e["dz"],
    "pow0": lambda e: e["dx"] ** 0,
    "pow1": lambda e: e["dx"] ** 1,
    "pow2": lambda e: e["dx"] ** 2,
    "pow3": lambda e: (0.3 - e["d2"]) ** 3,
    "cube_product": lambda e: (0.3 - e["d2"]) * (0.3 - e["d2"])
    * (0.3 - e["d2"]),
    "pow_neg1": lambda e: e["d2"] ** -1,
    "pow_neg2": lambda e: e["d2"] ** -2,
    "pow_half": lambda e: e["d2"] ** 0.5,
    "int_pow2": lambda e: e["orig_j"] ** 2,
    "int_pow_float": lambda e: e["orig_j"] ** 2.0,
    "compare": lambda e: ((e["dx"] < e["dy"]).float(), e["d2"] >= 1,
                          e["orig_i"] == e["orig_j"], e["dz"] != 0.5,
                          e["dx"] <= 0, e["set_j"] > 3),
    "logic": lambda e: ((e["dx"] > 0) & (e["dy"] > 0)) | ~(e["dz"] > 0),
    "where": lambda e: torch.where(e["dx"] > 0, e["dx"], 0.0),
    "where_int": lambda e: torch.where(e["orig_j"] > 0, e["orig_j"], 7),
    "sqrt": lambda e: torch.sqrt(e["d2"]),
    "rsqrt": lambda e: torch.rsqrt(e["d2"]),
    "exp": lambda e: torch.exp(-e["d2"]),
    "abs": lambda e: (torch.abs(e["dx"]), e["orig_j"].abs()),
    "minmax": lambda e: (torch.minimum(e["dx"], e["dy"]),
                         torch.maximum(e["orig_i"], e["orig_j"])),
    "clamp": lambda e: (torch.clamp(e["dx"], -0.5, 0.5),
                        e["dy"].clamp(min=0.0),
                        torch.clamp(e["orig_j"], max=3)),
    "likes": lambda e: (torch.ones_like(e["d2"]), torch.zeros_like(e["d2"]),
                        torch.full_like(e["d2"], 2.5),
                        torch.full_like(e["orig_j"], 2.7),
                        torch.ones_like(e["orig_j"], dtype=torch.float32)),
    "methods": lambda e: (e["d2"].sqrt(), e["d2"].rsqrt(), (-e["d2"]).exp(),
                          e["orig_j"].float()),
    "int_float_mix": lambda e: (e["orig_j"] * 0.5, e["orig_j"] / 3,
                                e["set_j"] + e["dx"], e["orig_i"] - 1),
    "numpy_scalars": lambda e: (np.float64(0.1) * e["dx"],
                                e["orig_j"] + np.int32(2),
                                np.float32(2.0) - e["r_j"]),
    "bool_arith": lambda e: (e["dx"] > 0) * e["dy"],
    "scalar_output": lambda e: 1.0,
}


@pytest.mark.parametrize("op", list(OPS))
def test_tracer_matches_eager_torch(op):
    fn = OPS[op]
    env = _env()
    eager = fn(env)
    eager = eager if isinstance(eager, tuple) else (eager,)
    outs = trd.trace(trd.ReduceSpec(fn, len(eager)), variable=True)
    got = trd.evaluate(outs, env)
    for g, e in zip(got, eager):
        assert g.dtype == torch.float32
        g, want = torch.broadcast_tensors(g, torch.as_tensor(e).float())
        torch.testing.assert_close(g, want, rtol=0, atol=0)


def test_tracer_writes_exact_constants_and_rn_intrinsics():
    src, n_ops = trd.kernel_source(trd.ReduceSpec(
        lambda e: e["p0_j"] * ((np.float32(4e-4) - e["d2"]) ** 3), 1), False)
    gen = src.split("// ---- generated section (ops/reduce.py) ----\n")[1] \
        .split("// ---- end of generated section ----\n")[0]
    bits = int(np.array(np.float32(4e-4)).view(np.uint32))
    assert f"__int_as_float(0x{bits:08x})" in gen
    assert gen.count("__fmul_rn") == 3 and gen.count("__fsub_rn") == 1
    assert "constexpr bool USE_P0_J = true;" in gen
    assert "constexpr bool USE_R_J = false;" in gen
    assert "constexpr int N_OUT = 1;" in gen and n_ops == 4
    # the template's kernel and launcher follow the generated section
    assert "pairs_reduce_kernel" in src.split(gen)[1]


def test_kernel_source_is_content_keyed():
    a, _ = trd.kernel_source(trd.ReduceSpec(lambda e: e["d2"] * 2, 1), False)
    b, _ = trd.kernel_source(trd.ReduceSpec(lambda e: e["d2"] * 2, 1), False)
    c, _ = trd.kernel_source(trd.ReduceSpec(lambda e: e["d2"] * 3, 1), False)
    assert a == b and a != c


UNSUPPORTED = {
    "sin": lambda e: torch.sin(e["d2"]),
    "pow4": lambda e: e["d2"] ** 4,
    "pow_traced": lambda e: e["d2"] ** e["dx"],
    "python_if": lambda e: e["d2"] if e["d2"] > 0 else e["dx"],
    "method_sum": lambda e: e["d2"].sum(),
    "floordiv": lambda e: e["orig_j"] // 2,
    "real_tensor": lambda e: e["d2"] * torch.ones(3),
    "int_negative_power": lambda e: e["orig_j"] ** -1,
    "minimum_scalar": lambda e: torch.minimum(e["d2"], 1.0),
    "float_of_traced": lambda e: float(e["d2"]),
}


@pytest.mark.parametrize("op", list(UNSUPPORTED))
def test_tracer_rejects_unsupported_operations(op):
    with pytest.raises(TypeError):
        trd.trace(trd.ReduceSpec(UNSUPPORTED[op], 1), variable=False)


def test_r_j_is_absent_at_a_fixed_radius():
    with pytest.raises(KeyError):
        trd.trace(trd.ReduceSpec(lambda e: e["r_j"], 1), variable=False)


def test_kernel_route_traces_then_raises_without_nvcc(monkeypatch, tmp_path,
                                                      fixed_ref):
    # a tensor that is not on the CPU takes the kernel route: the callback
    # is traced first (an unsupported operation raises TypeError), then
    # the build raises without a toolchain; the plain version never runs
    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(tpp, "CUDA_HOME_DEFAULT", str(empty))
    monkeypatch.setattr(tpp, "BUILD_DIR", tmp_path / "build")
    desc, q_t, recs_t, n_win, tiles_cap = fixed_ref["args"]
    meta = [t.to("meta") for t in (desc, q_t, recs_t)]
    allow = fixed_ref["allow"].to("meta")
    before = trd.pairs_reduce.launches
    bad = trd.ReduceSpec(lambda e: torch.sin(e["d2"]), 1)
    with pytest.raises(TypeError, match="sin"):
        trd.pairs_reduce(*meta, n_win, tiles_cap, bad,
                         fixed_ref["cand_sets"], allow,
                         **fixed_ref["active_kw"])
    good = trd.ReduceSpec(tfn_fixed, 4)
    with pytest.raises(RuntimeError, match="nvcc"):
        trd.pairs_reduce(*meta, n_win, tiles_cap, good,
                         fixed_ref["cand_sets"], allow,
                         **fixed_ref["active_kw"])
    assert trd.pairs_reduce.launches == before
