"""K1 and K2a of the port (their plain versions, which the wrappers take
for CPU tensors) held against the JAX Pallas kernels in interpret mode.

The JAX side runs at the smoke-tier configuration (``test_smoke.py``
``test_run_tiny_interpret_end_to_end``: n = 208, pack 8, lane_batch,
rec_expand, small caps) with a window cap small enough that tiles whose
widest window is wider go to the fat tier.  Its prep, sorted records,
query tiles and both tiers' outputs come from ONE interpret-mode compile;
the structures are carried into the port with ``interop``.

Tolerance: query tiles bit-equal on live tiles; counts equal; rows equal
as sets (list order is unspecified).  Rows are compared only where they
are defined: live query lanes, with the tier chosen through ``fat_slot``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from treensearch_tpu.config import SearchConfig as JaxConfig, round_up
from treensearch_tpu.ops import fastpath as jfp
from treensearch_tpu.ops import pallas_pairs as jpp
from treensearch_tpu.ops import grid as jgrid
from treensearch_tpu_torch import interop
from treensearch_tpu_torch.ops import fastpath as tfp
from treensearch_tpu_torch.ops import pairs as tpp

N = 208
PACK = 8
K8 = 64
N_WIN = 9
R = 0.18
CFG = JaxConfig(set_sizes=(N,), active_pairs=((0, 0),), variable=False,
                symmetric=False, stencil_w=1, chunk=128, cand_cap=256,
                nbr_cap=K8)
# wcap 64 leaves an effective window of 57 slots at pack 8, so the dense
# column below routes some tiles to the fat tier; pre-caps = K8 keep the
# staging exact
KNOBS = jfp.FastKnobs(use_pallas=True, interpret=True, wcap=64, fat_wcap=256,
                      fat_cap=16, dense_cap=1 << 14, rows_cap=1 << 10,
                      pre_cap=K8, pre_edge=K8, pack=PACK, lane_batch=True,
                      rec_expand=True)


def _points():
    rng = np.random.default_rng(7)
    cloud = rng.uniform(0, 1, (150, 3))
    column = np.stack([rng.uniform(0.4, 0.45, 58), rng.uniform(0.4, 0.45, 58),
                       rng.uniform(0, 1, 58)], 1)
    return np.concatenate([cloud, column]).astype(np.float32)


def _jax_side(points, r, cell):
    """JAX prep, sorted records and both kernel tiers, as in
    ``fastpath._pallas_search`` (rec_expand, single set, fixed radius)."""
    st = jfp._pallas_statics(CFG, KNOBS)
    state = jgrid.update_grid(jgrid.fresh_state(), points, cell)
    carry = jfp._pallas_prep(points, None, state, CFG, KNOBS)

    def bits(x):
        return jax.lax.bitcast_convert_type(x, jnp.int32)

    xs, ys, zs, os_ = jax.lax.sort(
        (carry.lin_chk, bits(points[:, 0]), bits(points[:, 1]),
         bits(points[:, 2]), jnp.arange(N, dtype=jnp.int32)),
        num_keys=1, is_stable=True)[1:]
    z = jnp.zeros((N,), jnp.int32)
    sent = jnp.zeros((8,), jnp.int32).at[0:3].set(
        bits(jnp.float32(jpp.SENTINEL))).at[4].set(N).at[5].set(-1)
    lpp = 128 // PACK
    cols = jnp.pad(jnp.stack([xs, ys, zs, z, os_, z, z, z], axis=1),
                   ((0, 0), (0, lpp - 8)))
    n_rows = -(-N // PACK) + max(lpp, st["fat_wcap"] // PACK) + 4
    recs = jnp.concatenate(
        [cols, jnp.broadcast_to(jnp.pad(sent, (0, lpp - 8))[None],
                                (n_rows * PACK - N, lpp))]
    ).reshape(n_rows, 128)
    recs_t = jnp.concatenate(
        [jnp.stack([xs, ys, zs, z, os_, z, z, z]),
         jnp.broadcast_to(sent[:, None], (8, 384))], axis=1)
    tiles_cap = st["tiles_cap"]
    q_t = jpp.make_expand_call(
        tiles_cap, tiles_cap, PACK, N, interpret=True,
        slack_tiles=st["slack"] // 128, build_rec=False)(carry.desc, recs_t)
    params = jnp.zeros((8, 128), jnp.float32).at[0, 0].set(r * r)
    kargs = dict(variable=False, symmetric=False, cand_sets=(0,),
                 cand_offsets=(0,), multi_set=False, center_wins=(4,),
                 interpret=True, pack=PACK, val_bound=N, lane_batch=True,
                 phase_prefix=True, orig_bits=int(N + 1).bit_length())
    pre = (K8,) * N_WIN
    outs_n = jpp.make_pairs_call(
        st["wcap"], pre, (K8,), N_WIN, fat_tier=False,
        tiles_per_step=KNOBS.tps, **kargs)(tiles_cap, carry.desc, params,
                                           q_t, recs)
    outs_f = jpp.make_pairs_call(
        st["fat_wcap"], pre, (K8,), N_WIN, fat_tier=True, **kargs)(
        st["fat_cap"], carry.desc, params, q_t, recs, ids=carry.fat_ids)
    return carry, recs_t, q_t, outs_n, outs_f


@pytest.fixture(scope="module")
def jax_ref():
    pts = _points()
    carry, recs_t, q_t, outs_n, outs_f = jax.jit(_jax_side)(
        jnp.asarray(pts), jnp.float32(R), jnp.float32(R * 1.1))
    st = jfp._pallas_statics(CFG, KNOBS)
    tiles_cap, fat_cap = st["tiles_cap"], st["fat_cap"]
    c = {k: np.asarray(v) for k, v in carry._asdict().items()}
    # tier merge through fat_slot: row 0 of each tile's 8-row counts group
    cnt = np.asarray(outs_n[0])[0::8].copy()
    nb = np.asarray(outs_n[1]).reshape(tiles_cap, K8, 128).copy()
    cnt_f = np.asarray(outs_f[0])[0::8]
    nb_f = np.asarray(outs_f[1]).reshape(fat_cap, K8, 128)
    fat = np.nonzero(c["fat_slot"] >= 0)[0]
    cnt[fat] = cnt_f[c["fat_slot"][fat]]
    nb[fat] = nb_f[c["fat_slot"][fat]]
    return {"pts": pts, "carry": c, "tiles_cap": tiles_cap,
            "recs_t": np.array(recs_t), "q_t": np.array(q_t),
            "counts": cnt.reshape(-1), "nbrs": nb,
            "port_carry": interop.carry_from_numpy(c)}


def _live_lanes(desc, tiles_cap):
    lane = np.arange(128)
    live = (lane[None, :] < desc[:tiles_cap, tpp.CNT_COL, None]) \
        & (desc[:tiles_cap, tpp.FAT_COL, None] != 2)
    return live.reshape(-1)


def _sets(counts, nbrs, slots):
    t, lanes = slots // 128, slots % 128
    return [np.sort(nbrs[a, :c, b]) for a, b, c in
            zip(t, lanes, np.minimum(counts[slots], nbrs.shape[1]))]


def test_jax_reference_has_both_tiers(jax_ref):
    fat_col = jax_ref["carry"]["desc"][:jax_ref["tiles_cap"], tpp.FAT_COL]
    assert (fat_col == 1).sum() > 0 and (fat_col == 0).sum() > 0
    assert int(jax_ref["carry"]["fat_overflow"]) == 0


def test_sorted_records_match_jax(jax_ref):
    c = jax_ref["port_carry"]
    recs = tfp.sorted_records(torch.from_numpy(jax_ref["pts"]), c.idx_s)
    assert np.array_equal(recs.numpy(), jax_ref["recs_t"][:, :N])


def test_k1_plain_matches_jax_expand(jax_ref):
    tiles_cap = jax_ref["tiles_cap"]
    recs_t = torch.from_numpy(jax_ref["recs_t"]).contiguous()
    q = tpp.expand_query_tiles(jax_ref["port_carry"].desc, recs_t,
                               tiles_cap, N).numpy()
    qj = jax_ref["q_t"][:, :tiles_cap * 128]
    live_tiles = np.repeat(
        jax_ref["carry"]["desc"][:tiles_cap, tpp.FAT_COL] != 2, 128)
    assert np.array_equal(q[:, live_tiles], qj[:, live_tiles])
    # padding lanes carry the sentinel: NaN xyz, r 0, orig n, set -1
    pad = ~_live_lanes(jax_ref["carry"]["desc"], tiles_cap) & live_tiles
    assert pad.any()
    assert np.array_equal(np.unique(q[:3, pad]), [tpp.SENTINEL_BITS])
    assert np.array_equal(q[3:, pad][:, 0], [0, N, -1, 0, 0])


def test_k2a_plain_matches_jax_narrow_and_fat(jax_ref):
    tiles_cap = jax_ref["tiles_cap"]
    c = jax_ref["port_carry"]
    r2 = float(np.float32(R) * np.float32(R))
    counts, nbrs = tpp.pairs_nbrs_fixed(
        c.desc, torch.from_numpy(jax_ref["q_t"][:, :tiles_cap * 128])
        .contiguous(), torch.from_numpy(jax_ref["recs_t"]).contiguous(),
        r2, N_WIN, K8, tiles_cap)
    counts, nbrs = counts.numpy(), nbrs.numpy()
    slots = np.nonzero(_live_lanes(jax_ref["carry"]["desc"], tiles_cap))[0]
    assert slots.size == N
    assert np.array_equal(counts[slots], jax_ref["counts"][slots])
    assert counts[slots].max() <= K8
    for a, b in zip(_sets(counts, nbrs, slots),
                    _sets(jax_ref["counts"], jax_ref["nbrs"], slots)):
        assert np.array_equal(a, b)


def test_k2a_truncated_rows_are_prefixes(jax_ref):
    # past the cap the counts stay exact and rows keep the first k8
    # survivors in window order
    tiles_cap = jax_ref["tiles_cap"]
    c = jax_ref["port_carry"]
    q = torch.from_numpy(jax_ref["q_t"][:, :tiles_cap * 128]).contiguous()
    recs = torch.from_numpy(jax_ref["recs_t"]).contiguous()
    r2 = float(np.float32(R) * np.float32(R))
    full_c, full = tpp.pairs_nbrs_fixed(c.desc, q, recs, r2, N_WIN, K8,
                                        tiles_cap)
    cut_c, cut = tpp.pairs_nbrs_fixed(c.desc, q, recs, r2, N_WIN, 8,
                                      tiles_cap)
    assert torch.equal(full_c, cut_c) and int(cut_c.max()) > 8
    slots = torch.from_numpy(
        np.nonzero(_live_lanes(jax_ref["carry"]["desc"], tiles_cap))[0])
    t, lane = slots // 128, slots % 128
    assert torch.equal(cut[t, :, lane], full[t, :8, lane])


def test_cpu_wrappers_take_plain_versions_without_launching(jax_ref):
    before = (tpp.expand_query_tiles.launches, tpp.pairs_nbrs_fixed.launches)
    tiles_cap = jax_ref["tiles_cap"]
    desc = jax_ref["port_carry"].desc
    recs_t = torch.from_numpy(jax_ref["recs_t"]).contiguous()
    q = tpp.expand_query_tiles(desc, recs_t, tiles_cap, N)
    assert torch.equal(q, tpp.expand_query_tiles_plain(desc, recs_t,
                                                       tiles_cap, N))
    tpp.pairs_nbrs_fixed(desc, q, recs_t, 0.01, N_WIN, K8, tiles_cap)
    assert (tpp.expand_query_tiles.launches,
            tpp.pairs_nbrs_fixed.launches) == before


def corrupt_descriptors(desc, n_rec):
    """(corrupted, clipped): descriptors whose ranges run past the records
    or start before them, and the same ranges clipped by hand."""
    live = torch.nonzero(desc[:, tpp.FAT_COL] == 0).flatten().tolist()
    t1, t2, t3 = live[0], live[1], live[2]
    bad, clip = desc.clone(), desc.clone()
    bad[t1, 0], bad[t1, tpp.LENS_OFF] = n_rec - 5, 1 << 20
    clip[t1, 0], clip[t1, tpp.LENS_OFF] = n_rec - 5, 5
    bad[t2, 1] = clip[t2, 1] = -7
    clip[t2, tpp.LENS_OFF + 1] = 0
    bad[t3, tpp.A_COL], bad[t3, tpp.CNT_COL] = n_rec - 3, 128
    clip[t3, tpp.A_COL], clip[t3, tpp.CNT_COL] = n_rec - 3, 3
    return bad, clip


def test_ranges_past_the_records_are_clipped(jax_ref):
    # the kernels clip every record range, so no descriptor reads outside
    # the records; the plain versions clip the same way
    tiles_cap = jax_ref["tiles_cap"]
    recs = torch.from_numpy(jax_ref["recs_t"][:, :N]).contiguous()
    bad, clip = corrupt_descriptors(jax_ref["port_carry"].desc, N)
    q_bad = tpp.expand_query_tiles(bad, recs, tiles_cap, N)
    assert torch.equal(q_bad, tpp.expand_query_tiles(clip, recs, tiles_cap,
                                                     N))
    out_bad = tpp.pairs_nbrs_fixed(bad, q_bad, recs, 0.05, N_WIN, K8,
                                   tiles_cap)
    out_clip = tpp.pairs_nbrs_fixed(clip, q_bad, recs, 0.05, N_WIN, K8,
                                    tiles_cap)
    assert all(torch.equal(a, b) for a, b in zip(out_bad, out_clip))


@pytest.mark.parametrize("bad", ["dtype", "shape", "k8", "n_win"])
def test_wrappers_reject_bad_inputs(jax_ref, bad):
    tiles_cap = jax_ref["tiles_cap"]
    desc = jax_ref["port_carry"].desc
    recs_t = torch.from_numpy(jax_ref["recs_t"]).contiguous()
    q = tpp.expand_query_tiles(desc, recs_t, tiles_cap, N)
    args = dict(desc=desc, q_t=q, recs_t=recs_t, r2=0.01, n_win=N_WIN,
                k8=K8, tiles_cap=tiles_cap)
    if bad == "dtype":
        args["recs_t"] = recs_t.float()
    elif bad == "shape":
        args["q_t"] = q[:, :-128].contiguous()
    elif bad == "k8":
        args["k8"] = 12
    else:
        args["n_win"] = tpp.MAX_WIN + 1
    with pytest.raises((TypeError, ValueError)):
        tpp.pairs_nbrs_fixed(**args)
