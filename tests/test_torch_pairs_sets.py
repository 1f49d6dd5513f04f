"""K2b and K2c of the port (their plain versions, which the wrappers take
for CPU tensors) held against the JAX Pallas pairs kernel in interpret
mode.

Two module-scoped JAX references, one interpret-mode compile each, built
like ``test_torch_pairs.py::jax_ref`` (n about 200, pack 8, lane_batch,
rec_expand records):

- ``multi_ref``: two sets of 100 points, fixed radius,
  ``make_pairs_call(multi_set=True, cand_sets=(0, 1), cand_offsets=(0,
  100), nbr_caps=(48, 40))``: one output block per candidate set;
- ``variable_ref``: one set of 200 points with radii spread 2x,
  ``make_pairs_call(variable=True, symmetric=True)`` at stencil W = 1 (the
  local reach at W = 2 is held bit for bit in ``test_torch_prep.py``; an
  interpret compile of 25 windows takes about four times one of 9).

The prep, sorted records and query tiles come from the JAX side and are
carried into the port with ``interop``.  Every window fits the narrow
tier (asserted), so each tile's rows come from the narrow output.

Tolerance: counts equal per block on live lanes; rows equal as sets (list
order is unspecified); a row truncated at 8 is the first 8 of the port's
full row and a subset of the JAX row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from treensearch_tpu.config import SearchConfig as JaxConfig
from treensearch_tpu.ops import fastpath as jfp
from treensearch_tpu.ops import grid as jgrid
from treensearch_tpu.ops import pallas_pairs as jpp
from treensearch_tpu_torch import interop
from treensearch_tpu_torch.config import SearchConfig
from treensearch_tpu_torch.ops import fastpath as tfp
from treensearch_tpu_torch.ops import pairs as tpp

PACK = 8
KNOBS = jfp.FastKnobs(use_pallas=True, interpret=True, wcap=64,
                      fat_wcap=128, fat_cap=16, dense_cap=1 << 14,
                      rows_cap=1 << 10, pack=PACK, lane_batch=True,
                      rec_expand=True)
SIZES = (100, 100)
CAPS = (48, 40)
R = 0.18


def _bits(x):
    return jax.lax.bitcast_convert_type(x, jnp.int32)


def _jax_side(points, radii, set_ids, cfg, r, cell):
    """JAX prep, sorted records (r and set fields filled), query tiles and
    the narrow tier of the pairs kernel, as ``fastpath._pallas_search``
    builds them (rec_expand)."""
    n = cfg.n_points
    st = jfp._pallas_statics(cfg, KNOBS)
    state = jgrid.update_grid(jgrid.fresh_state(), points, cell)
    carry = jfp._pallas_prep(points, radii, state, cfg, KNOBS)
    rf = radii if cfg.variable else jnp.zeros((n,), jnp.float32)
    xs, ys, zs, rs, os_, ss = jax.lax.sort(
        (carry.lin_chk, _bits(points[:, 0]), _bits(points[:, 1]),
         _bits(points[:, 2]), _bits(rf), jnp.arange(n, dtype=jnp.int32),
         set_ids), num_keys=1, is_stable=True)[1:]
    z = jnp.zeros((n,), jnp.int32)
    sent = jnp.zeros((8,), jnp.int32).at[0:3].set(
        _bits(jnp.float32(jpp.SENTINEL))).at[4].set(n).at[5].set(-1)
    lpp = 128 // PACK
    fields = [xs, ys, zs, rs, os_, ss, z, z]
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
    k8s = tuple(-(-cfg.nbr_caps[j] // 8) * 8 for j in cand)
    n_win = len(st["offs_2d"])
    outs = jpp.make_pairs_call(
        st["wcap"], (max(k8s),) * n_win, k8s, n_win,
        variable=cfg.variable, symmetric=cfg.symmetric, cand_sets=cand,
        cand_offsets=tuple(cfg.set_offsets[j] for j in cand),
        multi_set=cfg.n_sets > 1, center_wins=st["center_wins"],
        interpret=True, pack=PACK, val_bound=max(cfg.set_sizes),
        lane_batch=True, phase_prefix=True,
        orig_bits=int(n + 1).bit_length(), n_sets_total=cfg.n_sets,
        fat_tier=False, tiles_per_step=KNOBS.tps)(
        tiles_cap, carry.desc, params, q_t, recs)
    return carry, recs_t, q_t, outs


def _reference(points, radii, sizes, caps, variable, stencil_w, r, cell):
    n = sum(sizes)
    pairs = tuple((i, j) for i in range(len(sizes))
                  for j in range(len(sizes)))
    cfg = JaxConfig(sizes, pairs, variable, variable, stencil_w, 128, 256,
                    max(caps), nbr_caps=caps)
    set_ids = jnp.asarray(np.repeat(np.arange(len(sizes), dtype=np.int32),
                                    sizes))
    carry, recs_t, q_t, outs = jax.jit(
        _jax_side, static_argnames=("cfg",))(
        jnp.asarray(points), None if radii is None else jnp.asarray(radii),
        set_ids, cfg=cfg, r=jnp.float32(r), cell=jnp.float32(cell))
    st = jfp._pallas_statics(cfg, KNOBS)
    tiles_cap = st["tiles_cap"]
    cand = st["cand_sets"]
    k8s = tuple(-(-caps[j] // 8) * 8 for j in cand)
    nb = len(cand)
    n_cnt = (nb + 2 + 7) // 8
    c = {k: np.asarray(v) for k, v in carry._asdict().items()}
    counts = np.stack([np.asarray(outs[b // 8])[b % 8::8].reshape(-1)
                       for b in range(nb)])
    nbrs = [np.asarray(outs[n_cnt + b]).reshape(tiles_cap, k8s[b], 128)
            for b in range(nb)]
    pre_surv = [int(np.asarray(outs[k // 8])[k % 8::8].max())
                for k in (nb, nb + 1)]
    port_cfg = SearchConfig(sizes, pairs, stencil_w, max(caps), variable,
                            variable, caps)
    return {"pts": points, "radii": radii, "carry": c, "cfg": port_cfg,
            "tiles_cap": tiles_cap, "n_win": len(st["offs_2d"]),
            "cand": cand, "offsets": tuple(cfg.set_offsets[j] for j in cand),
            "k8s": k8s, "r2": float(np.float32(r) * np.float32(r)),
            "recs_t": np.array(recs_t), "q_t": np.array(q_t),
            "counts": counts, "nbrs": nbrs, "pre_surv": pre_surv,
            "pre_cap": max(k8s), "port_carry": interop.carry_from_numpy(c)}


@pytest.fixture(scope="module")
def multi_ref():
    rng = np.random.default_rng(21)
    pts = rng.uniform(0, 0.5, (sum(SIZES), 3)).astype(np.float32)
    return _reference(pts, None, SIZES, CAPS, False, 1, R, R * 1.1)


@pytest.fixture(scope="module")
def variable_ref():
    rng = np.random.default_rng(22)
    pts = rng.uniform(0, 0.5, (200, 3)).astype(np.float32)
    rad = rng.uniform(0.08, 0.16, 200).astype(np.float32)
    # cell 0.16 = r_max: W = 1
    return _reference(pts, rad, (200,), (64,), True, 1, 0.0, 0.16)


def _live_slots(ref):
    desc = ref["carry"]["desc"]
    lane = np.arange(128)
    live = (lane[None, :] < desc[:ref["tiles_cap"], tpp.CNT_COL, None]) \
        & (desc[:ref["tiles_cap"], tpp.FAT_COL, None] != 2)
    return np.nonzero(live.reshape(-1))[0]


def _port(ref, k8s=None, sym=True):
    tiles_cap = ref["tiles_cap"]
    args = (ref["port_carry"].desc,
            torch.from_numpy(ref["q_t"][:, :tiles_cap * 128]).contiguous(),
            torch.from_numpy(ref["recs_t"]).contiguous())
    k8s = k8s or ref["k8s"]
    if ref["cfg"].variable:
        out = tpp.pairs_nbrs_variable(*args, ref["n_win"], tiles_cap,
                                      ref["cand"], ref["offsets"], k8s, sym)
    else:
        out = tpp.pairs_nbrs_sets(*args, ref["r2"], ref["n_win"], tiles_cap,
                                  ref["cand"], ref["offsets"], k8s)
    return out[0].numpy(), [a.numpy() for a in out[1]]


def _row(nbrs, slot, count):
    return nbrs[slot // 128, :min(count, nbrs.shape[1]), slot % 128]


REFS = ["multi_ref", "variable_ref"]


@pytest.mark.parametrize("name", REFS)
def test_jax_reference_is_exact_and_narrow(name, request):
    ref = request.getfixturevalue(name)
    # no fat tile, and the staging never truncated: the JAX rows are full
    assert (ref["carry"]["fat_slot"] == -1).all()
    assert max(ref["pre_surv"]) <= ref["pre_cap"]
    assert ref["counts"].max() <= min(ref["k8s"])


@pytest.mark.parametrize("name", REFS)
def test_sorted_records_match_jax(name, request):
    ref = request.getfixturevalue(name)
    cfg = ref["cfg"]
    recs = tfp.sorted_records(
        torch.from_numpy(ref["pts"]), ref["port_carry"].idx_s,
        None if ref["radii"] is None else torch.from_numpy(ref["radii"]),
        tfp.set_ids_of(cfg, "cpu") if cfg.n_sets > 1 else None)
    assert np.array_equal(recs.numpy(), ref["recs_t"][:, :cfg.n_points])


@pytest.mark.parametrize("name", REFS)
def test_plain_matches_jax_per_block(name, request):
    ref = request.getfixturevalue(name)
    counts, nbrs = _port(ref)
    slots = _live_slots(ref)
    assert slots.size == ref["cfg"].n_points
    for b in range(len(ref["cand"])):
        assert np.array_equal(counts[b, slots], ref["counts"][b, slots]), b
        assert counts[b, slots].sum() > 0
        for s in slots:
            c = counts[b, s]
            assert np.array_equal(np.sort(_row(nbrs[b], s, c)),
                                  np.sort(_row(ref["nbrs"][b], s, c))), (b, s)


def test_multi_set_blocks_hold_set_local_indices(multi_ref):
    counts, nbrs = _port(multi_ref)
    slots = _live_slots(multi_ref)
    for b, n_b in enumerate(SIZES):
        rows = np.concatenate([_row(nbrs[b], s, counts[b, s])
                               for s in slots])
        assert rows.min() >= 0 and rows.max() < n_b
        assert nbrs[b].shape[1] == multi_ref["k8s"][b]


@pytest.mark.parametrize("name", REFS)
def test_truncated_rows_are_prefixes(name, request):
    # at k8 = 8 every block keeps exact counts and the first 8 survivors
    ref = request.getfixturevalue(name)
    full_c, full = _port(ref)
    nb = len(ref["cand"])
    cut_c, cut = _port(ref, k8s=(8,) * nb)
    assert np.array_equal(full_c, cut_c)
    slots = _live_slots(ref)
    for b in range(nb):
        assert cut_c[b, slots].max() > 8, b
        for s in slots:
            row = _row(cut[b], s, cut_c[b, s])
            assert np.array_equal(row, _row(full[b], s, min(cut_c[b, s], 8)))
            assert set(row.tolist()) <= set(
                _row(ref["nbrs"][b], s, ref["counts"][b, s]).tolist())


def test_symmetric_search_is_a_superset(variable_ref):
    sym_c, _ = _port(variable_ref, sym=True)
    asym_c, asym = _port(variable_ref, sym=False)
    slots = _live_slots(variable_ref)
    assert (sym_c[0, slots] >= asym_c[0, slots]).all()
    assert (sym_c[0, slots] > asym_c[0, slots]).any()
    # the asymmetric rule against a direct float32 evaluation
    pts, rad = variable_ref["pts"], variable_ref["radii"]
    d = pts[None, :, :] - pts[:, None, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    m = d2 <= (rad * rad)[:, None]
    np.fill_diagonal(m, False)
    qpos = variable_ref["carry"]["qpos"]
    assert np.array_equal(asym_c[0, qpos], m.sum(1))
    for i in range(0, pts.shape[0], 7):
        assert np.array_equal(np.sort(_row(asym[0], qpos[i],
                                           asym_c[0, qpos[i]])),
                              np.nonzero(m[i])[0])


def test_wrappers_count_no_launch_on_the_cpu(multi_ref, variable_ref):
    before = (tpp.pairs_nbrs_sets.launches, tpp.pairs_nbrs_variable.launches)
    _port(multi_ref)
    _port(variable_ref)
    assert (tpp.pairs_nbrs_sets.launches,
            tpp.pairs_nbrs_variable.launches) == before


@pytest.mark.parametrize("bad", ["nine_blocks", "lengths", "k8", "repeat"])
def test_block_arguments_are_checked(multi_ref, bad):
    ref = multi_ref
    cand, offs, k8s = ref["cand"], ref["offsets"], ref["k8s"]
    if bad == "nine_blocks":
        cand, offs, k8s = tuple(range(9)), (0,) * 9, (8,) * 9
    elif bad == "lengths":
        offs = offs[:1]
    elif bad == "k8":
        k8s = (12, 8)
    else:
        cand = (0, 0)
    tiles_cap = ref["tiles_cap"]
    with pytest.raises(ValueError):
        tpp.pairs_nbrs_sets(
            ref["port_carry"].desc,
            torch.from_numpy(ref["q_t"][:, :tiles_cap * 128]).contiguous(),
            torch.from_numpy(ref["recs_t"]).contiguous(), ref["r2"],
            ref["n_win"], tiles_cap, cand, offs, k8s)
