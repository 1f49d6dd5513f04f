#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``treensearch_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. device: the card's name and power limit from nvidia-smi; CUDA required;
2. build: ``csrc/pairs.cu`` compiled by nvcc for sm_90a, with its time;
3. kernels against their plain PyTorch versions on the card, at the
   structures of the main path (1M points): the query tiles bit-equal,
   the pairs kernel's counts equal and its rows equal as sets, with
   median times from CUDA events;
4. main path: ``TreeNSearch(device="cuda").run()`` on BASELINE config 1
   (1,000,000 uniform points from ``default_rng(0)``, r = 0.02, cell =
   1.15 r), once to settle the caps and then 5 times with the points
   jittered by at most 1e-4 before each run, as an SPH step moves them.
   Both kernels must launch in every run; a small cloud must match numpy
   brute force exactly, and 20k sampled points of the 1M run must match
   scipy's cKDTree under the same float32 rule.

The last two lines are a JSON object with each kernel's launches, error
and times, then ``{"ok": true, "device": {...}}``.  The script imports
nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

N = 1_000_000
RADIUS = 0.02
CELL_F = 1.15
N_RUNS = 5
JITTER = 1e-4
N_SAMPLE = 20_000
N_SMALL = 3000
TPU_PAIRS_SEED0 = 32_759_462   # the JAX package's count (BENCH_r05.json)
REPS = 7
HERE = os.path.dirname(os.path.abspath(__file__))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = REPS) -> float:
    """Median over ``reps`` runs of ``fn``, timed by CUDA events, after
    one warm-up run."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def sorted_rows(counts, nbrs, live):
    """Tile-layout rows as (slots, k8) with entries past each count set to
    a large value and sorted, restricted to live slots."""
    import torch
    k8 = nbrs.shape[1]
    rows = nbrs.transpose(1, 2).reshape(-1, k8)
    j = torch.arange(k8, device=rows.device)[None, :]
    rows = torch.where(j < counts[:, None], rows, torch.iinfo(torch.int32).max)
    return torch.sort(rows, dim=1).values[live]


def make_engine(pts_t, radius):
    """``TreeNSearch`` on ``pts_t``'s device, set up as BASELINE config 1."""
    from treensearch_tpu_torch import TreeNSearch
    eng = TreeNSearch(device=pts_t.device)
    eng.add_point_set(pts_t)
    eng.set_search_radius(radius)
    eng.set_cell_size(CELL_F * radius)
    eng.set_all_searches(True)
    return eng


def main_path_structures(pts_t, radius):
    """The kernels' inputs at the main path's settled caps: one ``run()``
    of the engine settles them, then its prep is rebuilt at those caps.
    Returns (carry, ``fastpath.KernelInputs``)."""
    from treensearch_tpu_torch.ops import fastpath as fp
    eng = make_engine(pts_t, radius)
    eng.run()
    cfg = eng._make_cfg(eng._stencil_w(eng._effective_cell_size()))
    knobs = eng._knobs()
    carry = fp._prep(pts_t, eng._grid_state, cfg, knobs)
    flags = [int(carry.dense_overflow), int(carry.rows_overflow),
             int(carry.tile_overflow)]
    if any(flags):
        raise RuntimeError(f"main-path prep overflowed at settled caps "
                           f"{knobs}: {flags}")
    return carry, fp.kernel_inputs(pts_t, radius, carry, cfg, knobs)


def check_kernels(pts_t, radius) -> list:
    """Phase 3: each kernel against its plain version on the same inputs."""
    import torch
    from treensearch_tpu_torch.ops import pairs
    from treensearch_tpu_torch.ops.pairs import CNT_COL, FAT_COL, TILE
    carry, (desc, recs_t, tiles_cap, n_win, k8, r2) = main_path_structures(
        pts_t, radius)
    n = pts_t.shape[0]

    def k1():
        return pairs.expand_query_tiles(desc, recs_t, tiles_cap, n)

    def k1_plain():
        return pairs.expand_query_tiles_plain(desc, recs_t, tiles_cap, n)

    q_k, q_p = k1(), k1_plain()
    if not torch.equal(q_k, q_p):
        diff = int((q_k != q_p).sum())
        raise AssertionError(f"expand_query_tiles: {diff} words differ")
    k1_err = int((q_k.long() - q_p.long()).abs().max())

    def k2():
        return pairs.pairs_nbrs_fixed(desc, q_k, recs_t, r2, n_win, k8,
                                      tiles_cap)

    def k2_plain():
        return pairs.pairs_nbrs_fixed_plain(desc, q_k, recs_t, r2, n_win,
                                            k8, tiles_cap)

    (c_k, nb_k), (c_p, nb_p) = k2(), k2_plain()
    lane = torch.arange(TILE, device=desc.device)
    live = ((lane[None, :] < desc[:tiles_cap, CNT_COL, None])
            & (desc[:tiles_cap, FAT_COL, None] != 2)).reshape(-1)
    k2_err = int((c_k[live].long() - c_p[live].long()).abs().max())
    if k2_err:
        raise AssertionError(f"pairs_nbrs_fixed counts differ by {k2_err}")
    if not torch.equal(sorted_rows(c_k, nb_k, live),
                       sorted_rows(c_p, nb_p, live)):
        raise AssertionError("pairs_nbrs_fixed rows differ as sets")
    print(f"kernels: q_t bit-equal over {tiles_cap} tiles; counts equal "
          f"and rows equal as sets over {int(live.sum())} live slots "
          f"(max count {int(c_k[live].max())}, k8 {k8}, "
          f"widest window {int(carry.win_max)})", flush=True)
    out = [{"name": "expand_query_tiles", "max_abs_err": k1_err},
           {"name": "pairs_nbrs_fixed", "max_abs_err": k2_err}]
    # turns: plain, kernel, kernel, plain
    for rec, fk, fp_ in ((out[0], k1, k1_plain), (out[1], k2, k2_plain)):
        p1, t1, t2, p2 = (median_ms(fp_), median_ms(fk), median_ms(fk),
                          median_ms(fp_))
        rec["ms"] = min(t1, t2)
        rec["plain_ms"] = min(p1, p2)
        print(f"{rec['name']}: kernel {t1:.4f} / {t2:.4f} ms, plain "
              f"{p1:.4f} / {p2:.4f} ms (median of {REPS} each)", flush=True)
    return out


def brute_force_sets(pts: np.ndarray, radius: float) -> list:
    d = pts[None, :, :] - pts[:, None, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    m = d2 <= np.float32(radius) * np.float32(radius)
    np.fill_diagonal(m, False)
    return [np.nonzero(row)[0] for row in m]


def check_small(device, radius: float) -> None:
    """The engine on a small cloud against numpy brute force."""
    from treensearch_tpu_torch import TreeNSearch
    pts = np.random.default_rng(1).uniform(0, 1, (N_SMALL, 3)) \
        .astype(np.float32)
    r = 0.07
    eng = TreeNSearch(device=device)
    eng.add_point_set(pts)
    eng.set_search_radius(r)
    eng.set_all_searches(True)
    eng.run()
    counts, nbrs = (t.cpu().numpy() for t in eng.get_neighbors(0, 0))
    for i, want in enumerate(brute_force_sets(pts, r)):
        got = np.sort(nbrs[i, :counts[i]])
        if counts[i] != want.size or not np.array_equal(got, want):
            raise AssertionError(f"small cloud: point {i} differs")
    print(f"small cloud: {N_SMALL} points match brute force "
          f"({int(counts.sum())} pairs)", flush=True)


def check_sample(pts: np.ndarray, counts, nbrs, radius: float) -> None:
    """Sampled neighbor sets against cKDTree candidates at r (1 + 1e-5),
    filtered by the engine's float32 rule."""
    import torch
    from scipy.spatial import cKDTree
    rng = np.random.default_rng(2)
    sample = np.sort(rng.choice(pts.shape[0], N_SAMPLE, replace=False))
    tree = cKDTree(pts.astype(np.float64))
    cand = tree.query_ball_point(pts[sample].astype(np.float64),
                                 radius * (1 + 1e-5), workers=-1)
    idx = torch.as_tensor(sample, dtype=torch.long, device=counts.device)
    c_s = counts[idx].cpu().numpy()
    nb_s = nbrs[idx].cpu().numpy()
    r2 = np.float32(radius) * np.float32(radius)
    for k, i in enumerate(sample):
        c = np.asarray(cand[k], dtype=np.int64)
        c = c[c != i]
        d = pts[c] - pts[i]
        d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
        want = np.sort(c[d2 <= r2])
        got = np.sort(nb_s[k, :c_s[k]])
        if c_s[k] != want.size or not np.array_equal(got, want):
            raise AssertionError(f"sampled point {i}: engine {got.tolist()}"
                                 f" vs cKDTree {want.tolist()}")
    print(f"cKDTree: {N_SAMPLE} sampled neighbor sets exact", flush=True)


def run_main_path(pts_t, radius: float, card: str) -> dict:
    """Phase 4: the user's entry points, with launch counts per run."""
    import torch
    from treensearch_tpu_torch.ops import pairs
    kernels = (pairs.expand_query_tiles, pairs.pairs_nbrs_fixed)
    dev = pts_t.device
    n = pts_t.shape[0]
    eng = make_engine(pts_t, radius)

    def timed_run():
        before = [k.launches for k in kernels]
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        grew = [k.launches - b for k, b in zip(kernels, before)]
        if dev.type == "cuda" and min(grew) < 1:
            raise AssertionError(f"a kernel did not launch in run(): {grew}")
        return ms

    for k in kernels:
        k.launches = 0
    settle_ms = timed_run()
    pairs0 = int(eng.get_counts(0, 0).sum(dtype=np.int64))
    print(f"settling run: {settle_ms:.1f} ms, {pairs0} pairs (TPU count "
          f"{TPU_PAIRS_SEED0}, difference {pairs0 - TPU_PAIRS_SEED0}); "
          f"caps: nbr {eng._nbr_cap} tiles {eng._tiles_cap} dense "
          f"{eng._dense_cap}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(3)
    times, pair_counts = [], []
    for _ in range(N_RUNS):
        jit = (torch.rand((n, 3), generator=gen, device=dev) * 2 - 1) * JITTER
        pts_t = pts_t + jit.to(torch.float32)
        eng.resize_point_set(0, pts_t)
        times.append(timed_run())
        pair_counts.append(int(eng.get_counts(0, 0).sum(dtype=np.int64)))
    launches = [k.launches for k in kernels]
    ms = statistics.median(times)
    pairs_n = statistics.median(pair_counts)
    print(f"run() ms: {' '.join(f'{t:.3f}' for t in times)}", flush=True)
    print(f"main path: {n} points, median {ms:.3f} ms/run, "
          f"{pairs_n / (ms / 1e3):.4g} pairs/s ({card})", flush=True)
    counts, nbrs = eng.get_neighbors(0, 0)
    if tuple(counts.shape) != (n,) or nbrs.shape[0] != n \
            or int(nbrs.min()) < -1 or int(nbrs.max()) >= n:
        raise AssertionError("solution has the wrong shape or range")
    check_sample(pts_t.cpu().numpy(), counts, nbrs, radius)
    return {"launches": launches, "ms": ms}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from treensearch_tpu_torch.ops import pairs

    card = card_line()                                      # phase 1
    print(f"card: {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}",
          flush=True)

    t0 = time.perf_counter()                                # phase 2
    lib = pairs.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s ({lib.seconds:.2f} s "
          f"nvcc) from {os.path.relpath(pairs.SOURCE, HERE)} -> "
          f"{os.path.relpath(lib.path, HERE)}", flush=True)
    print("nvcc: " + " ".join(lib.command), flush=True)
    print(lib.log.strip(), flush=True)

    dev = torch.device("cuda", 0)
    pts = np.random.default_rng(0).uniform(0, 1, (N, 3)).astype(np.float32)
    pts_t = torch.from_numpy(pts).to(dev)
    kernels = check_kernels(pts_t, RADIUS)                # phase 3
    check_small(dev, RADIUS)                                # phase 4
    main = run_main_path(pts_t, RADIUS, card)
    src = os.path.relpath(pairs.SOURCE, HERE)
    for rec, launches, line in zip(kernels, main["launches"], (276, 445)):
        rec.update(route="cuda", source=src,
                   replaces=f"treensearch_tpu/ops/pallas_pairs.py:{line}",
                   launches=launches)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
