"""The bitmask contract of the port (K4, ``ops/pairs.py::pairs_mask``, and
``ops/fastpath.py::decode_mask``) against the JAX package and the numpy
oracle.

- **Kernel.** K4's plain version (the one the wrapper takes for CPU
  tensors), decoded with the port's ``decode_mask``, against the JAX Pallas
  kernel ``make_pairs_call(mask_mode=True)`` in interpret mode decoded
  with the JAX ``decode_mask``, on the JAX structures carried into the
  port (``test_torch_reduce.jax_kernel_reference``): three fixed-radius
  sets under an asymmetric active matrix (set 2 searches nothing), and one
  set with per-point radii and symmetric search.  The two layouts differ
  (the port's is candidate rows of 4 ballot words, the JAX one packed
  tile rows); the decoded sets and the counts must not.
- **Engine.** ``TreeNSearch(device="cpu").run_mask`` against the numpy
  O(n^2) oracle and the JAX ``run_mask`` (one module-scoped call).

Tolerance: none; counts and neighbor sets are exact.
"""

import numpy as np
import pytest
import torch

from test_torch_reduce import (ACTIVE, R, SIZES, _port_engine, _split,
                               fixed_case_data, jax_kernel_reference,
                               oracle_mask, variable_case_data)
from treensearch_tpu import TreeNSearch as JaxTreeNSearch
from treensearch_tpu.ops import fastpath as jfp
from treensearch_tpu_torch.ops import fastpath as tfp
from treensearch_tpu_torch.ops import pairs as tpp

MASK = {"mask_mode": True}


@pytest.fixture(scope="module")
def fixed_ref():
    pts, per_set = fixed_case_data()
    ref = jax_kernel_reference(pts, None, SIZES, ACTIVE,
                               np.zeros((pts.shape[0], 2), np.float32), R,
                               R * 1.1, MASK)
    ref.update(pts=pts, sid=np.repeat(np.arange(3), SIZES),
               oracle=oracle_mask(pts, np.repeat(np.arange(3), SIZES),
                                  ACTIVE, r=R)[0])
    return ref


@pytest.fixture(scope="module")
def variable_ref():
    pts, rad = variable_case_data()
    ref = jax_kernel_reference(pts, rad, (200,), ((0, 0),),
                               np.zeros((200, 2), np.float32), 0.0, 0.16,
                               MASK)
    ref.update(pts=pts, oracle=oracle_mask(
        pts, np.zeros(200, int), ((0, 0),), radii=rad, symmetric=True)[0])
    return ref


REFS = ["fixed_ref", "variable_ref"]


def _port_mask(ref):
    """K4's plain version on the JAX structures, as a ``run_mask`` mask."""
    desc, q_t, recs_t, n_win, tiles_cap = ref["args"]
    counts, bits, cand_base = tpp.pairs_mask(
        *ref["args"], ref["cand_sets"], ref["allow"], **ref["active_kw"])
    mask = {"bits": bits, "cand_base": cand_base, "desc": desc,
            "q_orig": q_t[tpp.F_ORIG], "cand_orig": recs_t[tpp.F_ORIG]}
    meta = {"n_win": n_win, "n_total": ref["cfg"].n_points}
    return counts, mask, meta


def _jax_decoded(ref):
    """The JAX kernel's outputs through the JAX ``decode_mask``."""
    st, c = ref["st"], ref["carry"]
    n, tiles_cap = ref["cfg"].n_points, ref["tiles_cap"]
    rows_all = ref["n_win"] * st["wcap"] // st["pack"]
    mask = {"desc": c["desc"],
            "bits_tiles": ref["outs"][1].reshape(tiles_cap, rows_all, 128),
            "bits_fat": np.zeros((0, rows_all, 128), np.int32),
            "fat_slot": c["fat_slot"],
            "q_orig": ref["q_t_np"][tpp.F_ORIG],
            "cand_orig": np.concatenate(
                [ref["recs_t_np"][tpp.F_ORIG, :n],
                 np.full(st["pack"] * 4096, n, np.int32)])}
    meta = {"pack": st["pack"], "n_win": ref["n_win"], "n_total": n}
    return jfp.decode_mask(mask, meta)


def _sets(row_ptr, cols, q):
    return cols[row_ptr[q]:row_ptr[q + 1]].numpy()


@pytest.mark.parametrize("name", REFS)
def test_plain_k4_decodes_to_the_jax_kernel_sets(name, request):
    ref = request.getfixturevalue(name)
    assert (ref["carry"]["fat_slot"] == -1).all()
    counts, mask, meta = _port_mask(ref)
    dec_counts, (row_ptr, cols) = tfp.decode_mask(mask, meta)
    jax_counts, jax_nbrs = _jax_decoded(ref)
    n = meta["n_total"]
    assert int(dec_counts.sum()) == sum(jax_counts.values()) > 0
    for q in range(n):
        want = jax_nbrs.get(q, np.zeros(0, np.int64))
        assert np.array_equal(_sets(row_ptr, cols, q), want), q
        assert np.array_equal(want, np.nonzero(ref["oracle"][q])[0]), q


@pytest.mark.parametrize("name", REFS)
def test_plain_k4_counts_match_the_jax_kernel(name, request):
    ref = request.getfixturevalue(name)
    counts, _, _ = _port_mask(ref)
    jax_counts = ref["outs"][0][0::8].reshape(-1)
    live = ref["live"]
    assert np.array_equal(counts.numpy()[live], jax_counts[live])
    dead = np.setdiff1d(np.arange(counts.shape[0]), live)
    assert not counts.numpy()[dead].any()


def test_k4_layout(fixed_ref):
    counts, mask, meta = _port_mask(fixed_ref)
    bits, base = mask["bits"], mask["cand_base"]
    desc, _, recs_t, n_win, tiles_cap = fixed_ref["args"]
    _, lens = tpp.clipped_windows(desc, recs_t.shape[1], n_win, tiles_cap)
    assert base.dtype == torch.int64 and base.shape == (tiles_cap + 1,)
    assert torch.equal(base[1:] - base[:-1], lens.sum(1).long())
    assert bits.shape == (int(base[-1]), tpp.MASK_WORDS)
    # the bits of a tile's rows sum, lane by lane, to its counts
    for t in range(tiles_cap):
        words = bits[base[t]:base[t + 1]]
        lanes = ((words[:, :, None] >> torch.arange(32, dtype=torch.int32))
                 & 1).reshape(-1, 128)
        assert torch.equal(lanes.sum(0).int(), counts[t * 128:(t + 1) * 128])


def _lanes(bits):
    """K4's rows as (rows, 128) bits, lane l at column l."""
    return ((bits[:, :, None] >> torch.arange(32, dtype=torch.int32)) & 1) \
        .reshape(bits.shape[0], 128)


@pytest.mark.parametrize("name", REFS)
def test_plain_k4_excludes_self_by_orig_in_any_lane_order(name, request):
    # the contract the kernel is held to excludes a query's own record by
    # orig: the tiles' query lanes reversed give the same bits and counts,
    # lane for lane reversed
    ref = request.getfixturevalue(name)
    desc, q_t, recs_t, n_win, tiles_cap = ref["args"]
    rev = q_t.view(q_t.shape[0], tiles_cap, 128).flip(-1).reshape(q_t.shape)
    rest = (n_win, tiles_cap, ref["cand_sets"], ref["allow"])
    c, bits, base = tpp.pairs_mask(desc, q_t, recs_t, *rest,
                                   **ref["active_kw"])
    c_r, bits_r, base_r = tpp.pairs_mask(desc, rev, recs_t, *rest,
                                         **ref["active_kw"])
    assert torch.equal(base_r, base)
    assert torch.equal(c_r.view(tiles_cap, 128).flip(-1),
                       c.view(tiles_cap, 128))
    lanes = _lanes(bits)
    assert int(lanes.sum()) > 0
    assert torch.equal(_lanes(bits_r).flip(-1), lanes)


def test_decode_mask_of_some_tiles(fixed_ref):
    _, mask, meta = _port_mask(fixed_ref)
    full_counts, (rp, cols) = tfp.decode_mask(mask, meta)
    tiles = [0, 2]
    part_counts, (prp, pcols) = tfp.decode_mask(mask, meta, tiles=tiles)
    q_orig = mask["q_orig"].view(-1, 128)[tiles].reshape(-1)
    q_orig = q_orig[q_orig < meta["n_total"]].long()
    assert torch.equal(part_counts[q_orig], full_counts[q_orig])
    assert int(part_counts.sum()) == int(full_counts[q_orig].sum()) > 0
    for q in q_orig.tolist():
        assert np.array_equal(_sets(prp, pcols, q), _sets(rp, cols, q))


def test_k4_plain_counts_no_launch(fixed_ref):
    before = tpp.pairs_mask.launches
    _port_mask(fixed_ref)
    assert tpp.pairs_mask.launches == before


def test_kernel_route_raises_without_nvcc(monkeypatch, tmp_path, fixed_ref):
    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(tpp, "CUDA_HOME_DEFAULT", str(empty))
    monkeypatch.setattr(tpp, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tpp, "_PAIRS", {})
    desc, q_t, recs_t, n_win, tiles_cap = fixed_ref["args"]
    meta = [t.to("meta") for t in (desc, q_t, recs_t)]
    before = tpp.pairs_mask.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        tpp.pairs_mask(*meta, n_win, tiles_cap, fixed_ref["cand_sets"],
                       fixed_ref["allow"].to("meta"),
                       **fixed_ref["active_kw"])
    assert tpp.pairs_mask.launches == before


# ------------------------------------------------------------------ engine
@pytest.fixture(scope="module")
def jax_engine_fixed():
    pts, _ = fixed_case_data()
    eng = JaxTreeNSearch()
    for x in _split(pts, SIZES):
        eng.add_point_set(x)
    eng.set_search_radius(R)
    for i, j in ACTIVE:
        eng.set_active_search(i, j, True)
    eng.set_use_pallas(True, interpret=True)
    mask, meta = eng.run_mask()
    return {k: np.asarray(v) for k, v in mask["counts"].items()}, \
        jfp.decode_mask(mask, meta)[1]


def test_engine_run_mask_vs_oracle_and_jax(jax_engine_fixed):
    jax_counts, jax_nbrs = jax_engine_fixed
    pts, _ = fixed_case_data()
    eng = _port_engine(_split(pts, SIZES), r=R, active=ACTIVE)
    mask, meta = eng.run_mask()
    assert eng._last_stats["path"] == "mask"
    assert meta["layout"] == "candidate-rows" and "pack" not in meta
    assert meta["set_offsets"] == (0, 120, 200, 260)
    m, _ = oracle_mask(pts, np.repeat(np.arange(3), SIZES), ACTIVE, r=R)
    counts, (row_ptr, cols) = tfp.decode_mask(mask, meta)
    assert np.array_equal(counts.numpy(), m.sum(1))
    for q in range(pts.shape[0]):
        want = np.nonzero(m[q])[0]
        assert np.array_equal(_sets(row_ptr, cols, q), want), q
        assert np.array_equal(jax_nbrs.get(q, np.zeros(0, np.int64)), want)
    offs = meta["set_offsets"]
    for si in range(3):
        got = mask["counts"][f"s{si}"]
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), m.sum(1)[offs[si]:offs[si + 1]])
        assert np.array_equal(got.numpy(), jax_counts[f"s{si}"])
    assert torch.equal(mask["counts_flat"][mask["qpos"].long()].long(),
                       counts)


def test_engine_run_mask_variable_symmetric_vs_oracle():
    pts, rad = variable_case_data()
    eng = _port_engine([pts], radii=[rad], active=((0, 0),))
    mask, meta = eng.run_mask()
    m, _ = oracle_mask(pts, np.zeros(200, int), ((0, 0),), radii=rad,
                       symmetric=True)
    counts, (row_ptr, cols) = tfp.decode_mask(mask, meta)
    assert np.array_equal(counts.numpy(), m.sum(1))
    assert np.array_equal(mask["counts"]["s0"].numpy(), m.sum(1))
    for q in range(200):
        assert np.array_equal(_sets(row_ptr, cols, q), np.nonzero(m[q])[0])


def test_run_mask_agrees_with_run_and_leaves_its_lists():
    pts, _ = fixed_case_data()
    eng = _port_engine(_split(pts, SIZES), r=R, active=ACTIVE)
    eng.run()
    sol = eng._solution
    mask, meta = eng.run_mask()
    assert eng._solution is sol
    _, (row_ptr, cols) = tfp.decode_mask(mask, meta)
    offs = meta["set_offsets"]
    for i, j in ACTIVE:
        c, nb = eng.get_neighbors(i, j)
        for k in range(SIZES[i]):
            q = offs[i] + k
            got = _sets(row_ptr, cols, q)
            got = got[(got >= offs[j]) & (got < offs[j + 1])] - offs[j]
            assert np.array_equal(got, np.sort(nb[k, :c[k]].numpy()))


def test_run_mask_without_active_searches_is_empty():
    pts, _ = fixed_case_data()
    eng = _port_engine(_split(pts, SIZES), r=R, active=())
    mask, meta = eng.run_mask()
    assert not mask["bits"].any() and not mask["counts_flat"].any()
    counts, (_, cols) = tfp.decode_mask(mask, meta)
    assert not counts.any() and cols.numel() == 0
