#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``treensearch_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. device: the card's name and power limit from nvidia-smi; CUDA required;
2. build: ``csrc/pairs.cu``, ``csrc/cond.cu`` (the step graphs'
   conditional node) and the fused reduce's kernel for each of the
   five callbacks below (``csrc/reduce.cu`` with the traced callback),
   compiled by nvcc for sm_90a, one nvcc each, all started together, with
   their times and each kernel's registers, shared memory and spills
   (named K1 to K5 as in PERF.md);
3. BASELINE config 1 (1,000,000 uniform points from ``default_rng(0)``,
   r = 0.02, cell = 1.15 r): K1 and K2a against their plain PyTorch
   versions on a settled engine's structures (query tiles bit-equal,
   counts equal, rows equal slot for slot, median times from CUDA events); a
   small cloud against the port's brute-force oracle
   (``BruteforceNSearch.compare``); ``TreeNSearch(device="cuda")
   .run()`` once to settle the caps and then 5 times with the points
   jittered by at most 1e-4, as an SPH step moves them; 20k sampled
   points against scipy's cKDTree under the same float32 rule, and every
   point's count and neighbor set against the port's native oracle
   (``benchmarks/validate_1m.py``'s check, compared on the card);
4. BASELINE config 3 (``benchmarks/bench_configs.py:109-141``): 400,000
   fluid and 100,000 boundary points, r = 0.0254, fluid searches fluid
   and boundary: K2b against its plain version on every candidate-set
   block, 6 runs, cKDTree samples of both active pairs;
5. BASELINE config 4 (``bench_configs.py:143-152``): 250,000 points with
   radii uniform in [0.8, 1.25] x 0.032, all searches, symmetric: K2c
   and K4's ``<true, true>`` instance against their plain versions, with
   their times and bounds, K2c over the same grid with every tile dead,
   6 runs, a cKDTree sample;
6. two small sets with variable radii, symmetric search off, against
   the port's brute-force oracle (K2c with two candidate-set blocks);
7. ``run_reduce`` at config 1 (``benchmarks/bench_reduce_1m.py``'s
   workload without its z-sort): masses uniform in [0.5, 1.5) from the
   points' generator; K3 against its plain version on a settled engine's
   structures for the neighbor count (equal), the poly6 density
   ``m_j (h^2 - d^2)^3`` (n_out = 1) and ``density4_fn`` (n_out = 4),
   within 3e-5 of the sum of the terms' magnitudes, the two densities
   timed in turns with their plain versions, with their bounds (n_out = 4
   on a line of its own before the kernels line); the density of all 1M
   points against a float64 sum over ``run()``'s neighbor rows (rtol 5e-5,
   the benchmark's) and the count leg equal to ``run()``'s counts; a
   settling call and 5 jittered calls for each of n_out = 1 and 4;
8. ``run_mask`` at config 1: K4 against its plain version (bits word for
   word, counts equal); the mask's counts equal to ``run()``'s over all
   1M queries and ``decode_mask`` of every tile equal to ``run()``'s rows
   as sets, 32,759,462 pairs at seed 0; a settling call and 5 jittered
   calls;
9. small clouds against numpy brute force: three sets under an
   asymmetric active matrix with a payload (set 2 searches nothing), and
   one set with per-point radii and symmetric search, each through
   ``run_reduce`` (with an int env term) and ``run_mask``;
10. split staging at config 1: K5 against its plain version on K4's bits
   of a settled engine's structures (counts equal, rows equal slot for
   slot), and K4 then K5 against the fused K2a (every query's count and
   row equal), then the same at configs 3 (two blocks; the boundary
   searches nothing) and 4 (K4 ``<true, true>``, 25 windows), each timed
   with its bound; ``run()`` with ``set_split_stage(True)``, a settling call
   and 5 jittered calls (K1, K4 and K5 once each in every jittered call,
   no K2), 32,759,462 pairs at seed 0 and the cKDTree sample; configs 3
   and 4 with split staging equal to their fused ``run()`` per active
   pair (config 3's boundary searches nothing);
11. the temporal-coherence carry at config 1 through
   ``make_step_fn(reuse=True)``: 6 steps at the same positions (steps
   2-6 reuse the carry and run no prep; counts and rows equal ``run()``'s),
   5 steps of moves below 1e-6 that leave every point in its cell (the
   carry reused, the result a fresh engine's ``run()``), 5 steps jittered
   by 1e-4 (the rebuilds counted, the last step against a fresh engine's
   ``run()`` and the cKDTree sample); then the density step
   (``make_step_fn(reduce=...)``) and the mask step on static positions,
   equal to ``run_reduce`` and ``run_mask``.  Host ms per step, medians;
12. the tile path at config 1 (``set_use_pallas(False)``): K1r against
   its plain version bit for bit on a settled tile-path engine's
   padded-layout structures, its query tiles equal to K1's, with its time,
   the plain time, one ``index_select`` of the same records and its bound;
   a settling ``run()`` and 5 jittered ones (K1r once in each, no pairs
   kernel), 32,759,462 pairs at seed 0, and every point's count and row
   equal to the fused ``run()``'s on the last positions;
13. ten candidate sets (config 3's data with its boundary split by index
   into 9 sets, one per rigid body; the fluid searches itself and all 9):
   the tile path, a settling and 3 jittered ``run()``s, the fluid->fluid
   rows equal to config 3's fused rows and the union of the 9
   fluid->body rows, rebased, equal to config 3's fluid->boundary rows,
   as sets, for every fluid point, and cKDTree samples of both;
14. the search-based pipeline: ``run_scalar()`` at config 1 (a settling
   and 3 jittered calls, 32,759,462 pairs, every point equal to the
   fused ``run()``) and at config 4 (equal to its fused ``run()``); a
   variable cloud at a stencil of 4 cells (``run()`` raises, ``run_scalar``
   holds a cKDTree sample; ``make_step_fn(fast=False)`` equals it); a
   sparse cloud whose dense table overflows at its cap and takes the
   pipeline (a cKDTree sample); ``set_scalar_double_accum`` on a small
   cloud against float64 and float32 numpy predicates.  No kernel
   launches on the pipeline.
15. z-sort and the diagnostics at config 1: ``run()``, ``prepare_zsort``
   (the cell path, asserted), ``apply_zsort_batch`` of 8 arrays of 1M
   rows (the positions, a float32 velocity, density and mass, a float64
   and an int64 array, an int32 id, a flat float32 array of stride 3),
   each bit-exact against a host ``np.take``, and ``run()`` on the
   reordered positions (K1 and K2a in each run): 32,759,462 pairs, and a
   20k sample's neighbor sets mapped through the order equal to the
   unsorted run's; the per-point order on the card equal to the CPU's;
   ``make_zsort_step`` over config 3's two sets and a third (2 arrays
   each) equal to ``prepare_zsort``'s per-point orders; ``print_state``
   and ``profile_run`` (its trace names K1 and K2a); ``prepare_zsort``
   on both paths, the batch, the step and ``run()`` before and after the
   reorder (carried and rebuilt), timed, medians of 5, printed only.
16. the sharded search (``parallel/sharded.py``): world size 1 over NCCL
   in this process, a one-rank ``DeviceMesh`` named "d": config 1's
   ``run()`` (32,759,462 pairs), config 4's, ``run_reduce`` of the density
   at config 1 and config 1's ``run_scalar()``, each a settling and 5 (3
   for ``run_scalar``) jittered calls under ``distribute`` beside the same
   calls on one device, every query's count and row set equal at the last
   positions (the density within 5e-5, bit-equality printed), with the
   ms/call of both, the launches and the peak device memory; then four
   gloo ranks spawned on the one card, exchanging CUDA tensors, at configs
   1 (K2a) and 3 (K2b): every query equal to one device's on rank 0, each
   rank's owned, halo and local rows, peak memory, launches and its times
   on the shared card (printed, not judged), and each rank's eager
   ``make_sharded_step`` through JAX's (D, S, 8) buckets equal to the
   ranks' exact-size ``run()``, ``route_overflow`` 0.  Then the sharded
   step at world size 1 over NCCL, through the buckets (S = 2.5 (n + 64)
   at D = 1): config 1's fast step (K1, K2a), config 3's (K1, K2b),
   config 4's (K1, K2c) and config 1's pipeline step, each eager step
   equal to the one-device ``run()`` (every pair's counts and row sets;
   32,759,462 pairs at config 1), captured as one CUDA graph after an
   eager warm-up (the NCCL communicator exists before the capture),
   replayed at static and 2 jittered positions against eager steps
   (counts, ``max_count``, rows slot for slot, every flag,
   ``route_overflow`` 0), timed and profiled: ms per replay beside the
   eager ms/step and the eager mesh call's ms, device work, events and
   idle share per replay, peak memory, S and the local rows; config 1's
   eager step at ``route_slack`` 0.2 must flag ``route_overflow``.  A
   line of the sharded launches by kernel id precedes the kernels
   line.
17. step graphs (``torch.cuda.graph`` of ``make_step_fn`` steps, each
   after an eager warm-up of a rebuilding and a reusing step; each graph
   launches every kernel of its path once, counted at capture): config
   1's ``reuse=True`` step replayed 50 times at static positions with
   ``bench.py``'s checksum of ``counts[::257]`` (32,759,462 pairs), then at
   in-cell moves and at 1e-4 jitter, the next positions copied into the
   graph's input before each replay, every replay's ``rebuilt``, counts
   and rows equal to an eager step's on the same positions; torch.profiler
   over replays shows K1 once per replay and sort kernels (the prep's)
   only on rebuilding ones; ms per replay beside phase 11's eager ms/step.
   Then the density step (K3) against ``run_reduce``, the mask step (K4
   with its static row cap) against ``run_mask`` on the live rows, a mask
   step capped below its rows flagging ``mask_overflow`` with exact
   counts, the split step (K4 then K5), config 3's two-set step (K2b) and
   config 4's variable symmetric step (K2c; a radius change at static
   positions rebuilds), each replayed against eager steps, bit for bit.
   Then the steps off the fused route, each captured once and replayed at
   static and 2 jittered positions against eager steps (every pair's
   counts, ``max_count`` and rows slot for slot, every flag), 3 replays
   timed and profiled (ms per replay beside the eager ms/step, device
   work, events and idle share, peak memory): config 1's tile-path step
   (``set_use_pallas(False)``; K1r once per replay, the settled
   ``tiles_cap`` and ``wcap`` beside ``tiles_used`` and ``win_max``),
   phase 13's ten-set step, the pipeline step (``make_step_fn(fast=
   False)``) at config 1, its lists equal to ``run_scalar()``'s as sets,
   and at config 4; and ``make_zsort_step`` on phase 15's inputs, its
   orders and gathers equal to the eager step's bit for bit, ms per
   replay beside phase 15's eager ms.
18. BASELINE config 5 (``benchmarks/bench_10m_cfg5.py:36-82``): 8,000,000
   fluid, 1,500,000 boundary and 500,000 emitter points from
   ``default_rng(0)``, r = 0.009, cell 1.1 r, all 9 searches, caps 64 /
   16 / 8 by candidate set, coherence off (K1, and K2b with three
   blocks): a settling ``run()`` and 3 jittered ones (K1 and K2b once in
   each), one profiled; all 9 pairs against the native oracle, every
   point's count and neighbor set (sorted int64 keys on the card); K2b
   against its plain version on the settled structures (the plain
   version run once); ``bench_10m_cfg5.py:131-175``'s loop of 6 steps of
   ``make_step_fn()`` with ``make_zsort_step(n_sets=3)`` of the
   positions and 3 user arrays per set before every third step, eagerly
   and as two CUDA graphs replayed at that cadence from the host (the
   checksum of pair 0-0's ``counts[::1025]``, the positions and every
   pair's counts and rows equal; the last step equal to a fresh
   ``run()``), timed and profiled; and the fluid's cap set to 32, a
   ``run()`` that regrows to the settled pair 0-0 total.

Each path resets every kernel's launch count just before it and reads the
counts just after: each of its kernels must launch in every call (K1 and
K3 or K4 exactly once in each jittered ``run_reduce``/``run_mask``), and
no other pairs kernel may.  The last lines are the card, a JSON object
with each kernel's launches, error, times and bound (K2b's with its
config 5 record under ``"config 5"``), then ``{"ok": true,
"device": {...}}``.  The script imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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
KERNEL_BATCH = 10   # back-to-back kernel calls per timed run
# BASELINE config 3 and 4 (benchmarks/bench_configs.py:109-152)
N_FLUID, N_BOUNDARY, R3 = 400_000, 100_000, 0.0254
N4, R4 = 250_000, 0.032
N_SMALL_SET = 1500
# published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s and
# float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float32 operations per distance test: 3 sub, 3 mul, 2 add, 1 compare;
# symmetric search adds the compare against r_j^2
OPS_PER_TEST = 9
SOURCE_LINES = {"expand_query_tiles": 276, "expand_records": 276,
                "pairs_nbrs_fixed": 445,
                "pairs_nbrs_sets": 445, "pairs_nbrs_variable": 445,
                "pairs_reduce": 671, "pairs_mask": 779,
                "pairs_nbrs_from_bits": 500}
N_STEPS = 6             # phase 11: steps per workload (the first rebuilds)
IN_CELL = 1e-6          # phase 11: the largest in-cell move
HERE = os.path.dirname(os.path.abspath(__file__))
# the fused reduce (benchmarks/bench_reduce_1m.py): smoothing length h = r
H2 = np.float32(RADIUS * RADIUS)
REDUCE_RTOL = 3e-5      # kernel vs plain: float32 sums in another order
DENSITY_RTOL = 5e-5     # vs a float64 sum over run()'s lists (the bench's)
N_SMALL_SETS = (1500, 1000, 800)
N_SLOW_RUNS = 3         # phases 13, 14: jittered calls of the slower paths
N_BODIES = 9            # phase 13: boundary sets, one per rigid body
N_WIDE = 50_000         # phase 14: radii uniform in R_WIDE, cell 1.5 r_min
R_WIDE = (0.02, 0.1)
N_CLUSTER = 50_000      # phase 14: points per cluster of the sparse cloud
BOX_CELLS = 1000        # ... at opposite corners of a box this many cells
N_ZSORT_EXTRA = 50_000  # phase 15: the third set beside config 3's two
ZSORT_STEP_TIMING = "make_zsort_step (3 sets, 2 arrays each)"
# BASELINE config 5 (benchmarks/bench_10m_cfg5.py:36-82): fluid, boundary
# and emitter, all nine searches, a neighbor cap per candidate set
N5 = (8_000_000, 1_500_000, 500_000)
R5, CELL_F5 = 0.009, 1.1
CAPS5 = (64, 16, 8)
N5_RUNS = 3             # phase 18: jittered calls after the settling one
N5_ITERS = 6            # phase 18: iterations of the steady-state loop,
ZSORT_EVERY = 3         # ... a z-sort before every third step
CHECKSUM_STRIDE = 1025  # ... summing counts[::1025] of pair 0-0
REGROW_CAP = 32         # phase 18: the fluid's cap that forces a regrow


# ------------------------------------------------ the reduce callbacks
def count_fn(env):
    import torch
    return torch.ones_like(env["d2"])


def density_fn(env):
    """``bench_reduce_1m.py::density_fn``: poly6 density m_j (h^2 - d^2)^3
    (up to the normalisation)."""
    w = H2 - env["d2"]
    return env["p0_j"] * (w * w * w)


def density4_fn(env):
    """``bench_reduce_1m.py::density4_fn``: the density and three
    gradient-like sums."""
    w = H2 - env["d2"]
    k = env["p0_j"] * (w * w)
    return (k * w, k * env["dx"], k * env["dy"], k * env["dz"])


def small_fn(env):
    """The small multi-set cloud: counts, an int env term, payload terms."""
    import torch
    return (torch.ones_like(env["d2"]), env["orig_j"] + env["set_j"],
            env["d2"] * env["p0_j"], env["p1_i"] * env["p0_j"])


def variable_fn(env):
    import torch
    return (torch.ones_like(env["d2"]), env["d2"] * env["r_j"])


# (callback, n_out, variable): each builds one kernel
CALLBACKS = ((count_fn, 1, False), (density_fn, 1, False),
             (density4_fn, 4, False), (small_fn, 4, False),
             (variable_fn, 2, True))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def median_ms(fn, dev, reps: int = REPS, per: int = 1) -> float:
    """Median over ``reps`` of the time of ``per`` back-to-back calls of
    ``fn`` over ``per``, after one warm-up call: CUDA events on the card,
    the host clock on the CPU (a rehearsal only)."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(per):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / per)
        else:
            t0 = time.perf_counter()
            for _ in range(per):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / per)
    return statistics.median(times)


def timed_turns(rec: dict, kernel, plain, dev, label: str = "") -> None:
    """Kernel and plain times in turns (plain, kernel, kernel, plain); the
    lower of each pair goes into ``rec``.  The kernel is timed over
    KERNEL_BATCH back-to-back calls, so its wrapper's host work overlaps
    the previous launch and the time is the device's.  ``label`` names
    the line (by default the kernel's name)."""
    p1, t1, t2, p2 = (median_ms(plain, dev),
                      median_ms(kernel, dev, per=KERNEL_BATCH),
                      median_ms(kernel, dev, per=KERNEL_BATCH),
                      median_ms(plain, dev))
    rec["ms"] = min(t1, t2)
    rec["plain_ms"] = min(p1, p2)
    print(f"{label or rec['name']}: kernel {t1:.4f} / {t2:.4f} ms (median "
          f"of {REPS} runs of {KERNEL_BATCH} calls), plain {p1:.4f} / "
          f"{p2:.4f} ms (median of {REPS})", flush=True)


def live_slots(desc, tiles_cap):
    import torch
    lane = torch.arange(128, device=desc.device)
    return ((lane[None, :] < desc[:tiles_cap, 63, None])
            & (desc[:tiles_cap, 127, None] != 2)).reshape(-1)


# ------------------------------------------------------------- engines
def make_engine(pts_t, radius):
    """``TreeNSearch`` on ``pts_t``'s device, set up as BASELINE config 1."""
    from treensearch_tpu_torch import TreeNSearch
    eng = TreeNSearch(device=pts_t.device)
    eng.add_point_set(pts_t)
    eng.set_search_radius(radius)
    eng.set_cell_size(CELL_F * radius)
    eng.set_all_searches(True)
    return eng


def config3_data(dev, n_fluid=N_FLUID, n_boundary=N_BOUNDARY):
    """Fluid and boundary points, uniform in the unit cube, float32, from
    one ``default_rng(0)`` (fluid drawn first)."""
    import torch
    rng = np.random.default_rng(0)
    fluid = rng.uniform(0, 1, (n_fluid, 3)).astype(np.float32)
    boundary = rng.uniform(0, 1, (n_boundary, 3)).astype(np.float32)
    return (torch.from_numpy(fluid).to(dev),
            torch.from_numpy(boundary).to(dev))


def config3_engine(fluid_t, boundary_t, radius=R3):
    """BASELINE config 3: fluid searches fluid and boundary, the boundary
    searches nothing; default cell size (1.5 r)."""
    from treensearch_tpu_torch import TreeNSearch
    eng = TreeNSearch(device=fluid_t.device)
    f = eng.add_point_set(fluid_t)
    b = eng.add_point_set(boundary_t)
    eng.set_search_radius(radius)
    eng.set_active_search(f, f, True)
    eng.set_active_search(f, b, True)
    return eng


def config4_data(dev, n=N4):
    """Uniform points and radii uniform in [0.8, 1.25] x 0.032, float32,
    from one ``default_rng(0)`` (points drawn first)."""
    import torch
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    rad = rng.uniform(0.8, 1.25, n).astype(np.float32) * np.float32(R4)
    return torch.from_numpy(pts).to(dev), torch.from_numpy(rad).to(dev)


def config4_engine(pts_t, radii_t):
    """BASELINE config 4: per-point radii, all searches, symmetric search;
    default cell size (1.5 r_min, so W = 2 and 25 windows)."""
    from treensearch_tpu_torch import TreeNSearch
    eng = TreeNSearch(device=pts_t.device)
    eng.add_point_set(pts_t, radii_t)
    eng.set_all_searches(True)
    eng.set_symmetric_search(True)
    return eng


def settled_inputs(eng, payload=None, padded: bool = False):
    """The kernels' inputs at a settled engine's caps: one ``run()``
    settles them, then its prep is rebuilt at those caps (``payload``
    (n, 2) rides the records; ``padded``: the tile path's layout).
    Returns (carry, ``fastpath.KernelInputs``)."""
    from treensearch_tpu_torch.ops import fastpath as fp
    eng.run()
    points, radii = eng._assemble()
    bounds = eng._radius_bounds(radii)
    cell = eng._effective_cell_size(bounds)
    cfg = eng._make_cfg(eng._stencil_w(cell, bounds))
    knobs = eng._knobs()
    carry = fp._prep(points, eng._grid_state, cfg, knobs, radii, padded,
                     consts=fp.step_constants(
                         cfg, knobs, cell, points.device,
                         search_radius=eng._search_radius or 0.0))
    flags = [int(carry.dense_overflow), int(carry.rows_overflow),
             int(carry.tile_overflow)]
    if any(flags):
        raise RuntimeError(f"prep overflowed at settled caps {knobs}: "
                           f"{flags}")
    return carry, fp.kernel_inputs(points, eng._search_radius or 0.0, carry,
                                   cfg, knobs, radii, payload)


def active_inputs(eng, payload=None):
    """K3's and K4's arguments on a settled engine's structures: the
    carry (for ``stencil_tests``), the kernel inputs, the allow table and
    the query tiles (built by K1)."""
    from treensearch_tpu_torch.ops import fastpath as fp
    from treensearch_tpu_torch.ops import pairs
    carry, a = settled_inputs(eng, payload)
    allow = fp.allow_table(eng._make_cfg(1), a.cand_sets, a.desc.device)
    q = pairs.expand_query_tiles(a.desc, a.recs_t, a.tiles_cap,
                                 eng.get_total_n_points())
    return carry, a, allow, q


# ------------------------------------------------------- kernel bounds
def window_tests(a) -> int:
    """Distance tests the pairs kernels make on these inputs: 128 lanes
    times each live tile's windowed candidates (windows clipped to the
    records), dead lanes and tile-mates' candidates included."""
    import torch
    from treensearch_tpu_torch.ops.pairs import clipped_windows
    _, lens = clipped_windows(a.desc, a.recs_t.shape[1], a.n_win,
                              a.tiles_cap)
    return 128 * int(lens.sum(dtype=torch.int64))


def stencil_tests(eng, carry, a) -> int:
    """Distance tests the search needs on these inputs, the bounds' count:
    each query of a set that searches against the candidates, of the sets
    it searches, in its own stencil of the engine's grid, itself left out.
    The stencil is the prep's windows cut to one query: (2W+1)^2 runs of
    2W+1 cells along k around its cell, in variable mode each run only as
    wide as the query's reach covers (r_i; with ``symmetric`` the larger
    of r_i and the run's grid row's largest r_j), by the prep's float32
    test.  ``window_tests`` adds to it the tiles' dead lanes and the
    candidates of the other queries' stencils in a tile."""
    import torch
    from treensearch_tpu_torch.ops import fastpath as fp
    dev = a.desc.device
    state, cap = eng._grid_state, eng._knobs().dense_cap
    w = (math.isqrt(a.n_win) - 1) // 2
    dy, dz = (c + 2 * w for c in state.n_cells[1:].tolist())
    lin = carry.lin_s.long()
    sets = a.recs_t[fp.F_SET].long()
    allow = fp.allow_table(eng._make_cfg(1), a.cand_sets, dev)[sets]
    n_rows = cap // dz + 1
    if a.variable:
        row_rmax = torch.zeros(n_rows, dtype=torch.float32, device=dev)
        row_rmax.scatter_reduce_(0, torch.clamp(lin // dz, max=n_rows - 1),
                                 carry.r_chk, reduce="amax")
    tests = 0
    for b, cs in enumerate(a.cand_sets):
        hist = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
        hist.index_add_(0, lin + 1, (sets == cs).long())
        table = torch.cumsum(hist, 0)
        searches = (allow >> b) & 1 == 1
        for di in range(-w, w + 1):
            for dj in range(-w, w + 1):
                wk, ok = w, searches
                if a.variable:
                    reach = carry.r_chk
                    if a.symmetric:
                        rp = torch.clamp(lin // dz + di * dy + dj, 0,
                                         n_rows - 1)
                        reach = torch.maximum(reach, row_rmax[rp])
                    w0 = torch.floor(reach * (1.0 / state.cell_size)).long()
                    wk = torch.clamp(torch.where(
                        w0.to(torch.float32) * state.cell_size >= reach,
                        w0, w0 + 1), 1, w)
                    ok = ok & (max(abs(di), abs(dj)) <= wk)
                base = lin + (di * dy + dj) * dz
                e = table[torch.clamp(base + wk + 1, 0, cap)]
                s = table[torch.clamp(base - wk, 0, cap)]
                tests += int(((e - s) * ok).sum())
        tests -= int((searches & (sets == cs)).sum())
    return tests


def _bound(rec: dict, ops: int, moved: int) -> dict:
    """``bound_ms`` and ``bound_by`` of ``ops`` float32 operations and
    ``moved`` bytes, into ``rec``."""
    t_ops = ops / FP32_OPS_PER_S * 1e3
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    rec.update(ops=ops, bytes=moved, bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    return rec


def k3_bound(a, n_out: int, traced_ops: int, hits: int, tests: int) -> dict:
    """K3's bound on these inputs: 9 operations per distance test the
    search needs (``tests``, from ``stencil_tests``), and per
    hit the traced callback's operations and n_out adds; the bytes are the
    candidate fields it stages (x y z orig set p0 p1) read once, the query
    tiles (8 fields), the windows' descriptor words and n_out floats per
    slot written."""
    slots = 128 * a.tiles_cap
    moved = (4 * 7 * a.recs_t.shape[1] + 4 * 8 * slots
             + 4 * (2 * a.n_win + 1) * a.tiles_cap + 4 * n_out * slots)
    return _bound({"tests": tests, "tile_tests": window_tests(a),
                   "hits": hits},
                  tests * OPS_PER_TEST + hits * (traced_ops + n_out), moved)


def k4_bound(a, n_rows: int, tests: int) -> dict:
    """K4's bound on these inputs: 9 operations per distance test the
    search needs (``tests``, from ``stencil_tests``); the
    bytes are the candidate fields it stages (x y z orig set) read once,
    the query fields (x y z orig set), the descriptor words and row bases,
    the counts and 16 B per candidate row of bits written."""
    slots = 128 * a.tiles_cap
    moved = (4 * 5 * a.recs_t.shape[1] + 4 * 5 * slots
             + 4 * (2 * a.n_win + 1) * a.tiles_cap + 8 * (a.tiles_cap + 1)
             + 4 * slots + 16 * n_rows)
    return _bound({"tests": tests, "tile_tests": window_tests(a),
                   "rows": n_rows},
                  tests * (OPS_PER_TEST + int(a.symmetric)), moved)


def k5_bound(a, n_rows: int) -> dict:
    """K5's bound on these inputs: one 32-bit AND per query lane and
    candidate row (counted at the float32 rate, the guide's table having
    no int32 one); the bytes are the 16 B of bits per candidate row and
    the row bases, each candidate's orig and set (8 B per record), the
    descriptor words, and the counts and every block's rows written."""
    slots = 128 * a.tiles_cap
    moved = (16 * n_rows + 8 * (a.tiles_cap + 1) + 8 * a.recs_t.shape[1]
             + 4 * (2 * a.n_win + 1) * a.tiles_cap
             + 4 * slots * len(a.k8s) + 4 * slots * sum(a.k8s))
    return _bound({"rows": n_rows}, 128 * n_rows, moved)


def k1_bound(a) -> tuple:
    """(bytes, ms): each live slot's record read once (32 B), every
    slot's query record written once (32 B), two descriptor words per
    tile read; HBM-bound."""
    live = int(live_slots(a.desc, a.tiles_cap).sum())
    moved = 32 * live + 32 * 128 * a.tiles_cap + 8 * a.tiles_cap
    return moved, moved / HBM_BYTES_PER_S * 1e3


def k2_bound(a, tests: int) -> dict:
    """Bound of the pairs kernel on these inputs: the larger of the
    float32 operations of the distance tests the search needs (``tests``,
    from ``stencil_tests``) over the card's float32 rate and the bytes
    over HBM (records and query fields it reads once, the descriptor's
    windows, the counts and every block's rows written)."""
    fields = 4 + int(a.multi_set) + int(a.variable)   # x y z orig set r
    n_rec = a.recs_t.shape[1]
    slots = 128 * a.tiles_cap
    moved = (4 * fields * (n_rec + slots)
             + 4 * (2 * a.n_win + 1) * a.tiles_cap
             + 4 * slots * len(a.k8s) + 4 * slots * sum(a.k8s))
    return _bound({"tests": tests, "tile_tests": window_tests(a)},
                  tests * (OPS_PER_TEST + int(a.symmetric)), moved)


# ------------------------------------------------- kernels vs plain
def check_k1(a, n, dev, timed: bool) -> dict:
    """K1 against its plain version, bit for bit; with ``timed``, its time,
    the plain time and one ``index_select`` of the same records."""
    import torch
    from treensearch_tpu_torch.ops import pairs
    desc, recs_t, tiles_cap = a.desc, a.recs_t, a.tiles_cap

    def k1():
        return pairs.expand_query_tiles(desc, recs_t, tiles_cap, n)

    def k1_plain():
        return pairs.expand_query_tiles_plain(desc, recs_t, tiles_cap, n)

    q_k, q_p = k1(), k1_plain()
    if not torch.equal(q_k, q_p):
        raise AssertionError(f"expand_query_tiles: {int((q_k != q_p).sum())}"
                             " words differ")
    rec = {"name": "expand_query_tiles",
           "max_abs_err": int((q_k.long() - q_p.long()).abs().max())}
    if timed:
        timed_turns(rec, k1, k1_plain, dev)
        # the yardstick: one gather of the same records into the same
        # layout, its index (and a sentinel column) made beforehand
        lane = torch.arange(128, device=dev)
        src = desc[:tiles_cap, 62, None].long() + lane[None, :]
        src = torch.where(live_slots(desc, tiles_cap).view(tiles_cap, 128),
                          src, recs_t.shape[1]).reshape(-1)
        sent = torch.tensor([pairs.SENTINEL_BITS] * 3 + [0, n, -1, 0, 0],
                            dtype=torch.int32, device=dev)
        ext = torch.cat([recs_t, sent[:, None]], dim=1)
        rec["library_ms"] = median_ms(
            lambda: torch.index_select(ext, 1, src), dev)
        moved, rec["bound_ms"] = k1_bound(a)
        rec["bound_by"] = "bytes"
        print(f"expand_query_tiles: index_select {rec['library_ms']:.4f} "
              f"ms; bound {rec['bound_ms']:.4f} ms ({moved} B over HBM)",
              flush=True)
    return rec


def check_pairs(eng, carry, a, time_plain: bool = True) -> dict:
    """The pairs kernel of these inputs against its plain version: counts
    equal and rows equal slot for slot over live slots, for every block;
    its time in turns with the plain version (without ``time_plain``: the
    kernel's median alone, and the one plain call's time beside it), and
    its bound."""
    import torch
    from treensearch_tpu_torch.ops import fastpath as fp
    from treensearch_tpu_torch.ops import pairs
    dev, n = a.desc.device, eng.get_total_n_points()
    kernel = fp.pairs_kernel(a)
    q = pairs.expand_query_tiles(a.desc, a.recs_t, a.tiles_cap, n)
    c_k, nb_k = fp.run_pairs(a, q)
    sync(dev)
    t0 = time.perf_counter()
    c_p, nb_p = fp.run_pairs(a, q, True)
    sync(dev)
    plain_ms = (time.perf_counter() - t0) * 1e3
    live = live_slots(a.desc, a.tiles_cap)
    err = int((c_k[:, live].long() - c_p[:, live].long()).abs().max())
    if err:
        raise AssertionError(f"{kernel.__name__}: counts differ by {err}")
    for b in range(len(a.k8s)):
        if not torch.equal(_rows_of(nb_k[b], live), _rows_of(nb_p[b], live)):
            raise AssertionError(f"{kernel.__name__}: block {b} rows differ "
                                 "from plain")
    rec = {"name": kernel.__name__, "max_abs_err": err}
    rec.update(k2_bound(a, stencil_tests(eng, carry, a)))
    print(f"{kernel.__name__}: counts equal and rows equal slot for slot over "
          f"{int(live.sum())} live slots in {len(a.k8s)} block(s) "
          f"(candidate sets {a.cand_sets}, k8 {a.k8s}, max counts "
          f"{c_k[:, live].amax(dim=1).tolist()}, widest window "
          f"{int(carry.win_max)}, {a.n_win} windows); {rec['tests']} "
          f"distance tests in the queries' own stencils ({rec['tile_tests']}"
          f" in the tiles' windows), bound {rec['bound_ms']:.4f} ms by "
          f"{rec['bound_by']}", flush=True)
    if time_plain:
        timed_turns(rec, lambda: fp.run_pairs(a, q),
                    lambda: fp.run_pairs(a, q, True), dev)
    else:
        del c_p, nb_p
        rec["plain_ms"] = plain_ms
        rec["ms"] = median_ms(lambda: fp.run_pairs(a, q), dev,
                              per=KERNEL_BATCH)
        print(f"{kernel.__name__}: kernel {rec['ms']:.4f} ms (median of "
              f"{REPS} runs of {KERNEL_BATCH} calls), plain {plain_ms:.1f} "
              "ms (one call, untimed otherwise)", flush=True)
    rec["library_ms"] = None   # no single PyTorch call computes it
    return rec


def check_kernels(pts_t, radius) -> list:
    """Config 1: K1 and K2a against their plain versions on a settled
    engine's structures."""
    eng = make_engine(pts_t, radius)
    carry, a = settled_inputs(eng)
    k1 = check_k1(a, pts_t.shape[0], pts_t.device, timed=True)
    print(f"kernels: q_t bit-equal over {a.tiles_cap} tiles", flush=True)
    return [k1, check_pairs(eng, carry, a)]


def check_path_kernel(eng, time_plain: bool = True) -> dict:
    """Config 3, 4 or 5: K1 (bit-equal, untimed) and the path's pairs
    kernel against their plain versions on the settled engine's
    structures (``check_pairs``)."""
    carry, a = settled_inputs(eng)
    check_k1(a, eng.get_total_n_points(), a.desc.device, timed=False)
    return check_pairs(eng, carry, a, time_plain)


def _outputs(outs) -> tuple:
    return outs if isinstance(outs, tuple) else (outs,)


def check_k3(a, allow, q, fn, n_out: int, exact=(), hits: int = 0,
             tests: int = 0):
    """K3 against its plain version on these inputs: the outputs in
    ``exact`` equal, the others within REDUCE_RTOL of the sum of the
    terms' magnitudes (the plain version of ``|fn|``).  With ``hits`` (the
    neighbor pairs of these inputs) and ``tests`` (``stencil_tests``), its
    time in turns with the plain version and its bound.  Returns (record,
    the kernel's sums)."""
    import torch
    from treensearch_tpu_torch.ops import fastpath as fp
    from treensearch_tpu_torch.ops import reduce as red
    dev = a.desc.device
    spec = red.ReduceSpec(fn, n_out, True)
    args = (a.desc, q, a.recs_t, a.n_win, a.tiles_cap)
    kw = fp.active_args(a)

    def kernel():
        return red.pairs_reduce(*args, spec, a.cand_sets, allow, **kw)

    def plain(s=spec):
        return red.pairs_reduce_plain(*args, s, a.cand_sets, allow, **kw)

    def magnitudes(env):
        return tuple(torch.as_tensor(o).float().abs()
                     for o in _outputs(fn(env)))

    k, p = kernel(), plain()
    scale = plain(red.ReduceSpec(magnitudes, n_out, True))
    err = (k - p).abs()
    for j in range(n_out):
        ok = torch.equal(k[j], p[j]) if j in exact else \
            bool((err[j] <= REDUCE_RTOL * scale[j]).all())
        if not ok:
            raise AssertionError(f"pairs_reduce ({fn.__name__}): output {j} "
                                 f"differs from plain by up to "
                                 f"{float(err[j].max())}")
    rel = float((err / scale.clamp(min=torch.finfo(torch.float32).tiny))
                .max())
    rec = {"name": "pairs_reduce", "max_abs_err": float(err.max())}
    print(f"pairs_reduce ({fn.__name__}, n_out {n_out}): outputs {list(exact)}"
          f" equal to plain, the others within {REDUCE_RTOL} of the "
          f"magnitude sums (max abs err {rec['max_abs_err']:.3e}, max err / "
          f"magnitude sum {rel:.3e})", flush=True)
    if hits:
        ops = red.kernel_source(spec, a.variable)[1]
        rec.update(k3_bound(a, n_out, ops, hits, tests))
        print(f"pairs_reduce ({fn.__name__}): {rec['tests']} distance tests "
              f"in the queries' own stencils ({rec['tile_tests']} in the "
              "tiles' windows), "
              f"{hits} hits x ({ops} traced + {n_out} adds) operations, "
              f"{rec['bytes']} B; bound {rec['bound_ms']:.4f} ms by "
              f"{rec['bound_by']}", flush=True)
        timed_turns(rec, kernel, plain, dev, f"pairs_reduce ({fn.__name__})")
        rec["library_ms"] = None   # no single PyTorch call computes it
    return rec, k


def check_k4(a, allow, q, tests: int, name: str = "pairs_mask") -> dict:
    """K4 against its plain version on these inputs: row bases, bits word
    for word and counts equal, uncapped and with a static row cap below
    and above the row count (the live rows below the cap); its time in
    turns with the plain version and its bound (``name`` labels the
    lines)."""
    import torch
    from treensearch_tpu_torch.ops import fastpath as fp
    from treensearch_tpu_torch.ops import pairs
    args = (a.desc, q, a.recs_t, a.n_win, a.tiles_cap, a.cand_sets, allow)
    kw = fp.active_args(a)

    def kernel():
        return pairs.pairs_mask(*args, **kw)

    def plain():
        return pairs.pairs_mask_plain(*args, **kw)

    (c_k, b_k, base_k), (c_p, b_p, base_p) = kernel(), plain()
    if not torch.equal(base_k, base_p):
        raise AssertionError(f"{name}: row bases differ")
    words = int((b_k != b_p).sum())
    err = int((c_k.long() - c_p.long()).abs().max())
    if words or err:
        raise AssertionError(f"{name}: {words} bit words differ, counts "
                             f"by up to {err}")
    rows = b_k.shape[0]
    for cap in (rows // 2, rows + 1000):
        (c_k, b_kc, _), (c_p, b_pc, _) = (
            f(*args, **kw, rows_cap=cap)
            for f in (pairs.pairs_mask, pairs.pairs_mask_plain))
        live = min(cap, rows)
        if not (b_kc.shape[0] == cap and torch.equal(c_k, c_p)
                and torch.equal(b_kc[:live], b_pc[:live])
                and torch.equal(b_kc[:live], b_k[:live])):
            raise AssertionError(f"{name}: with a {cap}-row cap the kernel "
                                 "differs from plain")
        print(f"{name}: with a {cap}-row cap, counts and the {live} live "
              "rows equal to plain and to the uncapped bits", flush=True)
    del b_kc, b_pc
    rec = {"name": name, "max_abs_err": err}
    rec.update(k4_bound(a, b_k.shape[0], tests))
    print(f"{name}: bits equal word for word over {b_k.shape[0]} "
          f"candidate rows ({b_k.numel() * 4} B), counts equal "
          f"({int(c_k.sum(dtype=torch.int64))} pairs); {rec['tests']} "
          f"distance tests in the queries' own stencils "
          f"({rec['tile_tests']} in the tiles' windows), bound "
          f"{rec['bound_ms']:.4f} ms by {rec['bound_by']}", flush=True)
    timed_turns(rec, kernel, plain, a.desc.device)
    rec["library_ms"] = None   # no single PyTorch call computes it
    return rec


def _rows_of(nbrs, live):
    """Tile-layout rows (tiles, k8, 128) as (live slots, k8)."""
    return nbrs.transpose(1, 2).reshape(-1, nbrs.shape[1])[live]


def check_k5(a, allow, q, label: str = "pairs_nbrs_from_bits") -> dict:
    """K5 against its plain version on K4's bits of these inputs (counts
    equal on every slot, rows equal slot for slot on live slots), then K4
    and K5 through ``run_pairs`` against the fused pairs kernel (counts and
    rows equal, per block, on every live slot whose query's set searches
    the block's set); K5's time in turns with its plain version, and its
    bound (``label`` names the lines)."""
    import torch
    from treensearch_tpu_torch.ops import fastpath as fp
    from treensearch_tpu_torch.ops import pairs
    _, bits, base = pairs.pairs_mask(a.desc, q, a.recs_t, a.n_win,
                                     a.tiles_cap, a.cand_sets, allow,
                                     **fp.active_args(a))
    args = (a.desc, a.recs_t, bits, base, a.n_win, a.tiles_cap, a.cand_sets,
            a.cand_offsets, a.k8s)

    def kernel():
        return pairs.pairs_nbrs_from_bits(*args)

    def plain():
        return pairs.pairs_nbrs_from_bits_plain(*args)

    (c_k, nb_k), (c_p, nb_p) = kernel(), plain()
    live = live_slots(a.desc, a.tiles_cap)
    err = int((c_k.long() - c_p.long()).abs().max())
    rows = sum(int((_rows_of(k, live) != _rows_of(p, live)).sum())
               for k, p in zip(nb_k, nb_p))
    if err or rows:
        raise AssertionError(f"{label}: counts differ from plain by up to "
                             f"{err}, {rows} row entries")
    (c_s, nb_s), (c_f, nb_f) = fp.run_pairs(a, q, allow=allow), \
        fp.run_pairs(a, q)
    q_set = q[pairs.F_SET].long()
    allowed = torch.where(q_set >= 0, allow[q_set.clamp(min=0)], 0)
    searched = 0
    for b in range(len(a.k8s)):
        on = live & ((allowed >> b) & 1).bool()
        searched += int(on.sum())
        if not (torch.equal(c_s[b, on], c_f[b, on]) and torch.equal(
                _rows_of(nb_s[b], on), _rows_of(nb_f[b], on))):
            raise AssertionError(f"{label}: split staging differs from the "
                                 f"fused {fp.pairs_kernel(a).__name__} in "
                                 f"block {b}")
    rec = {"name": "pairs_nbrs_from_bits", "max_abs_err": err}
    rec.update(k5_bound(a, bits.shape[0]))
    print(f"{label}: counts and rows equal to plain over {int(live.sum())} "
          f"live slots ({bits.shape[0]} candidate rows, "
          f"{int(c_k.sum(dtype=torch.int64))} pairs, max count "
          f"{int(c_k.max())}, {len(a.k8s)} block(s), k8 {a.k8s}, "
          f"{a.n_win} windows); K4 then K5 equal to the fused "
          f"{fp.pairs_kernel(a).__name__} on {searched} (slot, block) "
          f"searches; {rec['bytes']} B, bound {rec['bound_ms']:.4f} ms by "
          f"{rec['bound_by']}", flush=True)
    timed_turns(rec, kernel, plain, a.desc.device, label)
    rec["library_ms"] = None   # no single PyTorch call computes it
    return rec


# ------------------------------------------------------- brute force
def _d2(q, c):
    d = c[None, :, :] - q[:, None, :]
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def check_small(device) -> None:
    """The engine on a small cloud against the port's brute-force oracle
    (``BruteforceNSearch.compare``: every point's neighbor set)."""
    from treensearch_tpu_torch import TreeNSearch
    from treensearch_tpu_torch.oracle import BruteforceNSearch
    pts = np.random.default_rng(1).uniform(0, 1, (N_SMALL, 3)) \
        .astype(np.float32)
    r = 0.07
    eng = TreeNSearch(device=device)
    eng.add_point_set(pts)
    eng.set_search_radius(r)
    eng.set_all_searches(True)
    eng.run()
    orc = BruteforceNSearch(search_radius=r)
    orc.add_point_set(pts)
    orc.set_all_searches(True)
    orc.run()
    orc.compare(eng)
    print(f"small cloud: {N_SMALL} points match brute force "
          f"({int(eng.get_counts(0, 0).sum())} pairs)", flush=True)


def check_small_variable(device) -> None:
    """Two sets with per-point radii, symmetric search off, all searches
    but set 1 in itself, against the port's brute-force oracle
    (``BruteforceNSearch.compare``: d^2 <= r_i^2 in float32, self
    excluded within a set).  Runs K2c with two candidate-set blocks."""
    from treensearch_tpu_torch import TreeNSearch
    from treensearch_tpu_torch.ops import pairs
    from treensearch_tpu_torch.oracle import BruteforceNSearch
    rng = np.random.default_rng(4)
    sets = [(rng.uniform(0, 1, (N_SMALL_SET, 3)).astype(np.float32),
             rng.uniform(0.05, 0.09, N_SMALL_SET).astype(np.float32))
            for _ in range(2)]
    active = [(0, 0), (0, 1), (1, 0)]
    eng = TreeNSearch(device=device)
    orc = BruteforceNSearch(symmetric=False)
    for p, r in sets:
        eng.add_point_set(p, r)
        orc.add_point_set(p, r)
    eng.set_symmetric_search(False)
    for i, j in active:
        eng.set_active_search(i, j, True)
        orc.set_active_search(i, j, True)
    before = pairs.pairs_nbrs_variable.launches
    eng.run()
    if device.type == "cuda" and pairs.pairs_nbrs_variable.launches == before:
        raise AssertionError("small variable sets: K2c did not launch")
    orc.run()
    orc.compare(eng)
    total = sum(int(eng.get_counts(i, j).sum()) for i, j in active)
    print(f"small variable sets: 2 x {N_SMALL_SET} points, symmetric off, "
          f"pairs {active} match brute force ({total} pairs)", flush=True)


def _check_contracts(eng, m, fn, n_out, want, exact, label,
                     payload=None) -> None:
    """``eng.run_reduce(fn, n_out, payload)`` against the brute-force sums
    ``want`` (n_out, n) (the outputs in ``exact`` equal, the others within
    REDUCE_RTOL), then ``eng.run_mask()`` decoded against the brute-force
    neighbor matrix ``m``, exactly; on the card K3 and K4 must launch."""
    from treensearch_tpu_torch.ops import fastpath as fp
    from treensearch_tpu_torch.ops import pairs
    from treensearch_tpu_torch.ops import reduce as red
    before = (red.pairs_reduce.launches, pairs.pairs_mask.launches)
    got = np.concatenate([t.cpu().numpy() for t in
                          eng.run_reduce(fn, n_out, payload).values()]).T
    for j in range(n_out):
        ok = np.array_equal(got[j], want[j]) if j in exact else \
            np.allclose(got[j], want[j], rtol=REDUCE_RTOL, atol=1e-6)
        if not ok:
            raise AssertionError(f"{label}: run_reduce output {j} differs "
                                 "from brute force")
    mask, meta = eng.run_mask()
    counts, (row_ptr, cols) = fp.decode_mask(mask, meta)
    counts, row_ptr, cols = (t.cpu().numpy() for t in (counts, row_ptr, cols))
    if not np.array_equal(counts, m.sum(1)):
        raise AssertionError(f"{label}: run_mask counts differ")
    for i, row in enumerate(m):
        if not np.array_equal(cols[row_ptr[i]:row_ptr[i + 1]],
                              np.nonzero(row)[0]):
            raise AssertionError(f"{label}: run_mask query {i} differs")
    if eng.device.type == "cuda" and min(
            red.pairs_reduce.launches - before[0],
            pairs.pairs_mask.launches - before[1]) < 1:
        raise AssertionError(f"{label}: K3 or K4 did not launch")
    print(f"{label}: run_reduce ({n_out} outputs) and run_mask match brute "
          f"force ({int(m.sum())} pairs)", flush=True)


def check_small_contracts(device) -> None:
    """Phase 9: three sets under an asymmetric active matrix (set 2
    searches nothing) with a payload, and one set with per-point radii and
    symmetric search, through ``run_reduce`` and ``run_mask`` against
    numpy brute force."""
    from treensearch_tpu_torch import TreeNSearch
    rng = np.random.default_rng(5)
    sets = [rng.uniform(0, 1, (k, 3)).astype(np.float32)
            for k in N_SMALL_SETS]
    n0, n1, _ = N_SMALL_SETS
    pay = [rng.uniform(0.5, 1.5, (n0, 2)).astype(np.float32),
           rng.uniform(0.5, 1.5, n1).astype(np.float32), None]
    active = [(0, 0), (0, 2), (1, 0)]
    r = 0.07
    eng = TreeNSearch(device=device)
    for s in sets:
        eng.add_point_set(s)
    eng.set_search_radius(r)
    for i, j in active:
        eng.set_active_search(i, j, True)
    pts = np.concatenate(sets)
    n = pts.shape[0]
    sid = np.repeat(np.arange(3), N_SMALL_SETS)
    d2 = _d2(pts, pts)
    am = np.zeros((3, 3), bool)
    am[tuple(zip(*active))] = True
    m = (d2 <= np.float32(r) * np.float32(r)) & am[sid[:, None], sid[None, :]]
    np.fill_diagonal(m, False)
    pl = np.zeros((n, 2), np.float32)
    pl[:n0] = pay[0]
    pl[n0:n0 + n1, 0] = pay[1]
    want = np.stack([
        m.sum(1), np.where(m, np.arange(n)[None, :] + sid[None, :], 0).sum(1),
        np.where(m, d2 * pl[None, :, 0], 0).sum(1, dtype=np.float64),
        np.where(m, pl[:, None, 1] * pl[None, :, 0], 0)
        .sum(1, dtype=np.float64)])
    _check_contracts(eng, m, small_fn, 4, want, (0, 1),
                     f"small sets {N_SMALL_SETS}, active {active}", pay)

    pts = rng.uniform(0, 1, (N_SMALL, 3)).astype(np.float32)
    rad = rng.uniform(0.03, 0.06, N_SMALL).astype(np.float32)
    eng = TreeNSearch(device=device)
    eng.add_point_set(pts, rad)
    eng.set_all_searches(True)
    eng.set_symmetric_search(True)
    d2 = _d2(pts, pts)
    m = (d2 <= (rad * rad)[:, None]) | (d2 <= (rad * rad)[None, :])
    np.fill_diagonal(m, False)
    want = np.stack([m.sum(1), np.where(m, d2 * rad[None, :], 0)
                     .sum(1, dtype=np.float64)])
    _check_contracts(eng, m, variable_fn, 2, want, (0,),
                     f"small variable set of {N_SMALL}, symmetric")


def check_sample(q_pts: np.ndarray, c_pts: np.ndarray, counts, nbrs,
                 r_query: float, keep, same_set: bool, label: str) -> None:
    """Sampled neighbor sets against cKDTree candidates at r_query (1 +
    1e-5), filtered by ``keep(i, c, d2)`` (the engine's float32 rule for
    query i and candidates c); ``same_set`` excludes the query itself."""
    import torch
    from scipy.spatial import cKDTree
    rng = np.random.default_rng(2)
    sample = np.sort(rng.choice(q_pts.shape[0], min(N_SAMPLE, q_pts.shape[0]),
                                replace=False))
    tree = cKDTree(c_pts.astype(np.float64))
    cand = tree.query_ball_point(q_pts[sample].astype(np.float64),
                                 r_query * (1 + 1e-5), workers=-1)
    idx = torch.as_tensor(sample, dtype=torch.long, device=counts.device)
    c_s = counts[idx].cpu().numpy()
    nb_s = nbrs[idx].cpu().numpy()
    for k, i in enumerate(sample):
        c = np.asarray(cand[k], dtype=np.int64)
        if same_set:
            c = c[c != i]
        d = c_pts[c] - q_pts[i]
        d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
        want = np.sort(c[keep(i, c, d2)])
        got = np.sort(nb_s[k, :c_s[k]])
        if c_s[k] != want.size or not np.array_equal(got, want):
            raise AssertionError(f"{label}: sampled point {i}: engine "
                                 f"{got.tolist()} vs cKDTree {want.tolist()}")
    print(f"cKDTree {label}: {sample.size} sampled neighbor sets exact",
          flush=True)


def pair_keys(counts, rows):
    """int64 keys ``i << 32 | j`` of one pair's neighbor lists (query i,
    neighbor j) on the card: from ``rows`` (n_i, cap), padded rows masked
    by ``counts``, or from the oracle's CSR columns (1-D, the rows in the
    order of ``counts``)."""
    import torch
    dev = counts.device
    n_i = counts.shape[0]
    counts = counts.long()
    if rows.dim() == 2:
        live = torch.arange(rows.shape[1], device=dev)[None, :] \
            < counts[:, None]
        cols = rows[live]
        del live
    else:
        cols = rows
    q = torch.repeat_interleave(torch.arange(n_i, device=dev), counts,
                                output_size=cols.shape[0])
    return (q << 32) | cols.long()


def exact_vs_native(counts, rows, q_pts: np.ndarray, c_pts: np.ndarray,
                    radius: float, same_set: bool, label: str) -> tuple:
    """Every query's count and neighbor set against the port's native
    oracle (``native_oracle.grid_search_pair``, threaded C++ on the host)
    at a fixed radius, compared on the card: the counts equal, and the
    sorted keys of (query, neighbor) of the engine's rows and of the
    oracle's CSR equal (``benchmarks/validate_1m.py``'s check, on every
    point).  Returns (pairs, the oracle's seconds)."""
    import torch
    from treensearch_tpu_torch import native_oracle as no
    t0 = time.perf_counter()
    c_ref, _, nb_ref = no.grid_search_pair(q_pts, c_pts, radius=radius,
                                           same_set=same_set)
    seconds = time.perf_counter() - t0
    dev = counts.device
    c_ref = torch.from_numpy(c_ref).to(dev)
    if not torch.equal(counts.to(torch.int32), c_ref):
        raise AssertionError(f"{label}: counts differ from the native "
                             f"oracle at {int((counts != c_ref).sum())} "
                             "points")
    want = torch.sort(pair_keys(c_ref, torch.from_numpy(nb_ref).to(dev)))[0]
    del nb_ref
    got = torch.sort(pair_keys(counts, rows))[0]
    if not torch.equal(got, want):
        raise AssertionError(f"{label}: neighbor sets differ from the "
                             "native oracle")
    pairs = int(want.shape[0])
    print(f"native oracle {label}: counts and neighbor sets equal for "
          f"every one of {counts.shape[0]} points ({pairs} pairs; oracle "
          f"{seconds:.2f} s on the host)", flush=True)
    return pairs, seconds


def fixed_rule(radius):
    r2 = np.float32(radius) * np.float32(radius)
    return lambda i, c, d2: d2 <= r2


# ------------------------------------------------------------ the paths
def pairs_kernels():
    from treensearch_tpu_torch.ops import pairs
    from treensearch_tpu_torch.ops import reduce as red
    return (pairs.expand_query_tiles, pairs.pairs_nbrs_fixed,
            pairs.pairs_nbrs_sets, pairs.pairs_nbrs_variable,
            red.pairs_reduce, pairs.pairs_mask, pairs.pairs_nbrs_from_bits,
            pairs.expand_records)


def drive(eng, label: str, path: tuple, jitter_step, card: str, call=None,
          pairs_of=None, once: bool = False, runs: int = N_RUNS) -> dict:
    """One settling call and ``runs`` jittered calls of a user's entry
    point (``call``, by default ``eng.run``), with every kernel's count
    set to 0 just before and read just after; on the card each kernel of
    ``path`` must launch in every call (exactly once in each jittered call
    with ``once``) and no other kernel at all (an empty ``path``: no
    kernel).  ``pairs_of(result)`` is a call's pair total (by default from
    ``run()``'s counts)."""
    import torch
    kernels = pairs_kernels()
    dev = eng.device
    active = [(int(i), int(j)) for i, j in zip(*np.nonzero(eng._active))]
    call = call or eng.run

    def total_pairs(_):
        return sum(int(eng.get_counts(i, j).sum(dtype=np.int64))
                   for i, j in active)

    pairs_of = pairs_of or total_pairs

    def timed_run(jittered: bool):
        before = [k.launches for k in kernels]
        sync(dev)
        t0 = time.perf_counter()
        out = call()
        sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        grew = {k.__name__: k.launches - b for k, b in zip(kernels, before)}
        on_path = [grew[k.__name__] for k in path] or [1]
        if dev.type == "cuda" and (min(on_path) < 1 or (
                once and jittered and max(on_path) != 1)):
            raise AssertionError(f"{label}: a kernel did not launch (once) "
                                 f"in the call: {grew}")
        return ms, pairs_of(out)

    for k in kernels:
        k.launches = 0
    settle_ms, pairs0 = timed_run(False)
    gen = torch.Generator(device=dev).manual_seed(3)
    times, pair_counts = [], []
    for _ in range(runs):
        jitter_step(lambda shape: ((torch.rand(shape, generator=gen,
                                               device=dev) * 2 - 1)
                                   * JITTER).to(torch.float32))
        ms, n_pairs = timed_run(True)
        times.append(ms)
        pair_counts.append(n_pairs)
    launches = {k.__name__: k.launches for k in kernels}
    if dev.type == "cuda" and any(
            n for k, n in launches.items()
            if k not in {p.__name__ for p in path}):
        raise AssertionError(f"{label}: a kernel outside the path "
                             f"launched: {launches}")
    ms = statistics.median(times)
    pairs_n = statistics.median(pair_counts)
    print(f"{label}: settling run {settle_ms:.1f} ms, {pairs0} pairs; "
          f"caps: nbr {eng._nbr_cap} {eng._nbr_caps} tiles {eng._tiles_cap} "
          f"dense {eng._dense_cap}; launches {launches}", flush=True)
    print(f"{label} ms per call: {' '.join(f'{t:.3f}' for t in times)}",
          flush=True)
    print(f"{label}: {eng.get_total_n_points()} points, median {ms:.3f} "
          f"ms/call, {pairs_n / (ms / 1e3):.4g} pairs/s ({card})", flush=True)
    return {"launches": launches, "ms": ms, "pairs0": pairs0}


def run_main_path(pts_t, radius: float, card: str) -> dict:
    """Config 1 through the user's entry points."""
    from treensearch_tpu_torch.ops import pairs
    n = pts_t.shape[0]
    eng = make_engine(pts_t, radius)
    state = {"pts": pts_t}

    def jitter(noise):
        state["pts"] = state["pts"] + noise((n, 3))
        eng.resize_point_set(0, state["pts"])

    out = drive(eng, "config 1", (pairs.expand_query_tiles,
                                  pairs.pairs_nbrs_fixed), jitter, card)
    if n == N:
        print(f"config 1 before jitter: {out['pairs0']} pairs (TPU count "
              f"{TPU_PAIRS_SEED0}, difference {out['pairs0'] - TPU_PAIRS_SEED0}"
              ")", flush=True)
        if out["pairs0"] != TPU_PAIRS_SEED0:
            raise AssertionError("config 1 pair count differs from the TPU's")
    counts, nbrs = eng.get_neighbors(0, 0)
    if tuple(counts.shape) != (n,) or nbrs.shape[0] != n \
            or int(nbrs.min()) < -1 or int(nbrs.max()) >= n:
        raise AssertionError("solution has the wrong shape or range")
    p = state["pts"].cpu().numpy()
    check_sample(p, p, counts, nbrs, radius, fixed_rule(radius), True,
                 "config 1")
    exact_vs_native(counts, nbrs, p, p, radius, True, "config 1")
    return out


def run_config3(fluid_t, boundary_t, card: str) -> tuple:
    """Config 3: K2b against its plain version, then the timed runs and
    the cKDTree samples of fluid->fluid and fluid->boundary."""
    from treensearch_tpu_torch.ops import pairs
    rec = check_path_kernel(config3_engine(fluid_t, boundary_t))
    eng = config3_engine(fluid_t, boundary_t)
    state = {"f": fluid_t, "b": boundary_t}

    def jitter(noise):
        state["f"] = state["f"] + noise(tuple(state["f"].shape))
        state["b"] = state["b"] + noise(tuple(state["b"].shape))
        eng.resize_point_set(0, state["f"])
        eng.resize_point_set(1, state["b"])

    out = drive(eng, "config 3", (pairs.expand_query_tiles,
                                  pairs.pairs_nbrs_sets), jitter, card)
    f, b = state["f"].cpu().numpy(), state["b"].cpu().numpy()
    for j, c_pts in ((0, f), (1, b)):
        counts, nbrs = eng.get_neighbors(0, j)
        check_sample(f, c_pts, counts, nbrs, R3, fixed_rule(R3), j == 0,
                     f"config 3 fluid->{('fluid', 'boundary')[j]}")
    return rec, out


def check_config4_kernels(eng, card: str) -> dict:
    """Config 4: K2c against its plain version (``check_path_kernel``);
    K4's ``<true, true>`` instance on the same structures against its
    plain version, with its time beside K2c's and its bound; and K2c's
    launch over the same grid with every tile dead (what the grid's dead
    tiles can cost).  Returns K2c's record."""
    from treensearch_tpu_torch.ops import fastpath as fp
    rec = check_path_kernel(eng)
    carry, a, allow, q = active_inputs(eng)
    k4 = check_k4(a, allow, q, stencil_tests(eng, carry, a),
                  "pairs_mask<true, true> (config 4)")
    dead = a.desc.clone()
    dead[:, 127] = 2
    a_dead = a._replace(desc=dead)
    ms_dead = median_ms(lambda: fp.run_pairs(a_dead, q), a.desc.device,
                        per=KERNEL_BATCH)
    live = int((a.desc[:a.tiles_cap, 127] != 2).sum())
    print(f"config 4: pairs_mask<true, true> {k4['ms']:.4f} ms (plain "
          f"{k4['plain_ms']:.4f}, bound {k4['bound_ms']:.4f} by "
          f"{k4['bound_by']}) beside pairs_nbrs_variable {rec['ms']:.4f} ms "
          f"(bound {rec['bound_ms']:.4f}); pairs_nbrs_variable over the "
          f"{a.tiles_cap} tiles with every tile dead {ms_dead:.4f} ms "
          f"({live} live in the run) ({card})", flush=True)
    return rec


def run_config4(pts_t, radii_t, card: str) -> tuple:
    """Config 4: K2c and K4 against their plain versions, then the timed
    runs and a cKDTree sample under the symmetric rule."""
    from treensearch_tpu_torch.ops import pairs
    rec = check_config4_kernels(config4_engine(pts_t, radii_t), card)
    eng = config4_engine(pts_t, radii_t)
    state = {"p": pts_t}

    def jitter(noise):
        state["p"] = state["p"] + noise(tuple(state["p"].shape))
        eng.resize_point_set(0, state["p"], radii_t)

    out = drive(eng, "config 4", (pairs.expand_query_tiles,
                                  pairs.pairs_nbrs_variable), jitter, card)
    p, r = state["p"].cpu().numpy(), radii_t.cpu().numpy()
    r2 = r * r

    def keep(i, c, d2):   # d^2 <= r_i^2 or d^2 <= r_j^2, float32
        return (d2 <= r2[i]) | (d2 <= r2[c])

    counts, nbrs = eng.get_neighbors(0, 0)
    check_sample(p, p, counts, nbrs, float(r.max()), keep, True,
                 "config 4 symmetric")
    return rec, out


def density_f64(pts, mass, counts, nbrs):
    """rho_i = sum over ``run()``'s neighbor rows of m_j (h^2 - d^2)^3:
    each term formed in float32 as the kernel forms it, summed in
    float64."""
    import torch
    n, k8 = nbrs.shape
    out = torch.empty(n, dtype=torch.float64, device=pts.device)
    lane = torch.arange(k8, device=pts.device)
    step = 1 << 17
    for r0 in range(0, n, step):
        valid = lane[None, :] < counts[r0:r0 + step, None]
        j = torch.where(valid, nbrs[r0:r0 + step], 0).long()
        d = pts[j] - pts[r0:r0 + step, None, :]
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
            + d[..., 2] * d[..., 2]
        w = H2 - d2
        term = mass[j] * (w * w * w)
        out[r0:r0 + step] = torch.where(valid, term.double(), 0.0).sum(dim=1)
    return out


def _jitter_one_set(eng, pts_t):
    state = {"pts": pts_t}

    def jitter(noise):
        state["pts"] = state["pts"] + noise(tuple(state["pts"].shape))
        eng.resize_point_set(0, state["pts"])

    return jitter


def run_reduce_path(pts_t, mass_t, card: str) -> tuple:
    """Phase 7: K3 against its plain version, the density against a
    float64 sum over ``run()``'s lists and the count leg against
    ``run()``'s counts, then the n_out = 1 and 4 paths."""
    import torch
    from treensearch_tpu_torch.ops import pairs
    from treensearch_tpu_torch.ops import reduce as red
    n = pts_t.shape[0]
    payload = torch.stack([mass_t, torch.zeros_like(mass_t)], dim=1)
    eng = make_engine(pts_t, RADIUS)
    carry, a, allow, q = active_inputs(eng, payload)
    tests = stencil_tests(eng, carry, a)
    _, ones = check_k3(a, allow, q, count_fn, 1, exact=(0,))
    hits = int(ones.sum(dtype=torch.float64))
    rec, _ = check_k3(a, allow, q, density_fn, 1, hits=hits, tests=tests)
    rec4, _ = check_k3(a, allow, q, density4_fn, 4, hits=hits, tests=tests)
    del carry, a, allow, q, ones

    rho = eng.run_reduce(density_fn, 1, payload=[mass_t])[0][:, 0]
    count = eng.run_reduce(count_fn)[0][:, 0]
    eng.run()
    counts, nbrs = eng.get_neighbors(0, 0)
    total = int(counts.sum(dtype=torch.int64))
    if not torch.equal(count, counts.float()):
        raise AssertionError("run_reduce counts differ from run()'s")
    ref = density_f64(pts_t, mass_t, counts, nbrs)
    rel = (rho.double() - ref).abs() / ref.abs().clamp(min=1e-300)
    if not torch.allclose(rho.double(), ref, rtol=DENSITY_RTOL, atol=1e-18):
        raise AssertionError(f"run_reduce density: worst relative error "
                             f"{float(rel.max())} against the float64 sum")
    print(f"run_reduce: count leg equal to run()'s counts ({total} pairs); "
          f"density of all {n} points within {DENSITY_RTOL} of a float64 sum"
          f" over run()'s rows (worst relative error {float(rel.max()):.3e},"
          f" mean density {float(ref.mean()):.6e})", flush=True)
    del counts, nbrs, ref, rel

    path = (pairs.expand_query_tiles, red.pairs_reduce)
    out1 = drive(eng, "run_reduce n_out=1 (density)", path,
                 _jitter_one_set(eng, pts_t), card,
                 call=lambda: eng.run_reduce(density_fn, 1,
                                             payload=[mass_t]),
                 pairs_of=lambda _: total, once=True)
    out4 = drive(eng, "run_reduce n_out=4 (density4_fn)", path,
                 _jitter_one_set(eng, pts_t), card,
                 call=lambda: eng.run_reduce(density4_fn, 4,
                                             payload=[mass_t]),
                 pairs_of=lambda _: total, once=True)
    rec4["launches"] = out4["launches"]["pairs_reduce"]
    return rec, rec4, out1, out4


def run_mask_path(pts_t, card: str) -> tuple:
    """Phase 8: K4 against its plain version, the mask's counts and
    decoded sets against ``run()``'s for every query, then the path."""
    import torch
    from treensearch_tpu_torch.ops import fastpath as fp
    from treensearch_tpu_torch.ops import pairs
    n = pts_t.shape[0]
    eng = make_engine(pts_t, RADIUS)
    carry, a, allow, q = active_inputs(eng)
    rec = check_k4(a, allow, q, stencil_tests(eng, carry, a))
    del carry, a, allow, q

    mask, meta = eng.run_mask()
    eng.run()
    counts, nbrs = eng.get_neighbors(0, 0)
    if not torch.equal(mask["counts"]["s0"], counts):
        raise AssertionError("run_mask counts differ from run()'s")
    dec_counts, (_, cols) = fp.decode_mask(mask, meta)
    valid = torch.arange(nbrs.shape[1], device=nbrs.device)[None, :] \
        < counts[:, None]
    rows = torch.sort(torch.where(valid, nbrs, torch.iinfo(torch.int32).max),
                      dim=1).values
    if not (torch.equal(dec_counts, counts.long())
            and torch.equal(cols, rows[valid].long())):
        raise AssertionError("decode_mask differs from run()'s rows")
    total = cols.numel()
    print(f"run_mask: counts of all {n} queries equal to run()'s; "
          f"decode_mask of every tile equal to run()'s rows as sets "
          f"({total} pairs, {meta['layout']} layout, "
          f"{mask['bits'].shape[0]} rows)", flush=True)
    if n == N and total != TPU_PAIRS_SEED0:
        raise AssertionError(f"run_mask: {total} pairs, not "
                             f"{TPU_PAIRS_SEED0}")
    del mask, counts, nbrs, dec_counts, cols, valid, rows

    out = drive(eng, "run_mask", (pairs.expand_query_tiles,
                                  pairs.pairs_mask),
                _jitter_one_set(eng, pts_t), card, call=eng.run_mask,
                pairs_of=lambda res: int(res[0]["counts_flat"]
                                         .sum(dtype=torch.int64)),
                once=True)
    return rec, out


def _path_launches(call, label: str, path: tuple) -> dict:
    """One ``call()`` with every kernel's count set to 0 just before and
    read just after; on the card each kernel of ``path`` must launch and
    no other."""
    import torch
    kernels = pairs_kernels()
    for k in kernels:
        k.launches = 0
    call()
    launches = {k.__name__: k.launches for k in kernels}
    names = {k.__name__ for k in path}
    if torch.cuda.is_available() and (
            min(launches[k] for k in names) < 1
            or any(v for k, v in launches.items() if k not in names)):
        raise AssertionError(f"{label}: launches off the path: {launches}")
    return launches


def check_split_config(make, label: str) -> None:
    """Phase 10, configs 3 and 4: one ``run()`` with split staging (K1,
    K4 and K5, no pairs kernel) against one fused ``run()``, counts and
    rows equal per active pair."""
    import torch
    from treensearch_tpu_torch.ops import pairs
    fused = make()
    fused.run()
    split = make()
    split.set_split_stage(True)
    launches = _path_launches(split.run, label, (
        pairs.expand_query_tiles, pairs.pairs_mask,
        pairs.pairs_nbrs_from_bits))
    active = [(int(i), int(j)) for i, j in zip(*np.nonzero(split._active))]
    total = 0
    for i, j in active:
        (c_s, nb_s), (c_f, nb_f) = split.get_neighbors(i, j), \
            fused.get_neighbors(i, j)
        if not (torch.equal(c_s, c_f) and torch.equal(nb_s, nb_f)):
            raise AssertionError(f"{label}: pair ({i}, {j}) differs from "
                                 "the fused run()")
        total += int(c_s.sum(dtype=torch.int64))
    print(f"{label}: split staging equal to the fused run() on active "
          f"pairs {active} ({total} pairs); launches {launches}", flush=True)


def run_split_path(pts_t, card: str, data3: tuple, data4: tuple) -> tuple:
    """Phase 10: K5 against its plain version and K4 then K5 against the
    fused pairs kernel at configs 1, 3 and 4 (config 1's record is
    returned), the split ``run()`` path at config 1, then configs 3 and 4
    (``data3``, ``data4``: ``config3_data``'s and ``config4_data``'s
    tensors) with split staging against their fused ``run()``."""
    from treensearch_tpu_torch.ops import pairs
    n = pts_t.shape[0]
    rec = check_k5(*active_inputs(make_engine(pts_t, RADIUS))[1:])
    for label, eng in (("config 3", config3_engine(*data3)),
                       ("config 4", config4_engine(*data4))):
        check_k5(*active_inputs(eng)[1:], f"pairs_nbrs_from_bits ({label})")
    eng = make_engine(pts_t, RADIUS)
    eng.set_split_stage(True)
    out = drive(eng, "config 1 split staging",
                (pairs.expand_query_tiles, pairs.pairs_mask,
                 pairs.pairs_nbrs_from_bits),
                _jitter_one_set(eng, pts_t), card, once=True)
    if n == N and out["pairs0"] != TPU_PAIRS_SEED0:
        raise AssertionError(f"config 1 split staging: {out['pairs0']} "
                             f"pairs, not {TPU_PAIRS_SEED0}")
    counts, nbrs = eng.get_neighbors(0, 0)
    p = eng._sets[0].points.cpu().numpy()
    check_sample(p, p, counts, nbrs, RADIUS, fixed_rule(RADIUS), True,
                 "config 1 split staging")
    del eng, counts, nbrs
    check_split_config(lambda: config3_engine(*data3),
                       "config 3 split staging")
    check_split_config(lambda: config4_engine(*data4),
                       "config 4 split staging")
    return rec, out


def run_steps(step, state, points_of, label: str, card: str, path: tuple,
              **kw) -> tuple:
    """N_STEPS calls of ``step(state, points_of(k), **kw)``, each timed on
    the host clock between synchronisations, with every kernel's count and
    the prep's call count set to 0 just before; on the card each kernel of
    ``path`` must launch exactly once per step and no other.  Returns
    (the last solution, the state, {rebuilt, preps, ms, launches})."""
    import torch
    from treensearch_tpu_torch.ops import fastpath as fp
    kernels = pairs_kernels()
    for k in kernels:
        k.launches = 0
    fp._prep.calls = 0
    dev = state[0].valid.device
    rebuilt, preps, times, sol = [], [], [], None
    for k in range(N_STEPS):
        pts = points_of(k)
        sol = None   # release the last step's rows first
        calls = fp._prep.calls
        sync(dev)
        t0 = time.perf_counter()
        sol, state = step(state, pts, **kw)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        rebuilt.append(int(sol["rebuilt"]))
        preps.append(fp._prep.calls - calls)
    launches = {k.__name__: k.launches for k in kernels}
    names = {k.__name__ for k in path}
    if dev.type == "cuda" and any(
            v != (N_STEPS if k in names else 0) for k, v in launches.items()):
        raise AssertionError(f"{label}: launches off the path: {launches}")
    ms = statistics.median(times[1:])
    print(f"{label}: rebuilt {rebuilt}, preps {preps}, launches {launches}",
          flush=True)
    print(f"{label}: ms per step {' '.join(f'{t:.3f}' for t in times)}; "
          f"median of steps 2-{N_STEPS} {ms:.3f} ms/step ({card})",
          flush=True)
    return sol, state, {"rebuilt": rebuilt, "preps": preps, "ms": ms,
                        "launches": launches}


def same_lists(pair, eng, label: str) -> int:
    """A step's pair 0-0 against ``eng``'s ``run()`` lists: counts equal
    and rows equal as sets.  Returns the pair count."""
    from treensearch_tpu_torch.ops import fastpath as fp
    return equal_as_sets((pair["counts"], fp.materialize_nbrs(pair)),
                         eng.get_neighbors(0, 0), f"{label} vs run()")


def equal_as_sets(a, b, label: str) -> int:
    """Two ``(counts, rows)`` of the same queries: counts equal and rows
    equal as sets for every query.  Returns the pair count."""
    import torch
    (c_a, n_a), (c_b, n_b) = a, b
    if not torch.equal(c_a, c_b):
        raise AssertionError(f"{label}: counts differ")
    big = torch.iinfo(torch.int32).max
    width = max(n_a.shape[1], n_b.shape[1])

    def as_sets(c, r):
        j = torch.arange(r.shape[1], device=r.device)[None, :]
        r = torch.sort(torch.where(j < c[:, None], r, big), dim=1).values
        return torch.nn.functional.pad(r, (0, width - r.shape[1]), value=big)

    if not torch.equal(as_sets(c_a, n_a), as_sets(c_b, n_b)):
        raise AssertionError(f"{label}: rows differ as sets")
    return int(c_a.sum(dtype=torch.int64))


def run_carry_path(pts_t, mass_t, card: str) -> dict:
    """Phase 11: config 1 through ``make_step_fn(reuse=True)`` on static,
    in-cell and jiggled positions, then the density and mask steps on
    static positions against ``run_reduce`` and ``run_mask``."""
    import torch
    from treensearch_tpu_torch.ops import pairs
    from treensearch_tpu_torch.ops import reduce as red
    from treensearch_tpu_torch.utils.keys import quantize
    dev = pts_t.device
    n = pts_t.shape[0]
    eng = make_engine(pts_t, RADIUS)
    eng.run()
    eng.run()   # the first run's snug resizes the caps: settle at them
    path = (pairs.expand_query_tiles, pairs.pairs_nbrs_fixed)
    step, state = eng.make_step_fn(reuse=True)
    out = {}

    sol, state, out["static"] = run_steps(
        step, state, lambda k: pts_t, "carry static", card, path)
    if out["static"]["rebuilt"] != [1] + [0] * (N_STEPS - 1) \
            or out["static"]["preps"] != out["static"]["rebuilt"]:
        raise AssertionError("carry static: steps 2-6 did not reuse")
    pairs0 = same_lists(sol["pairs"]["0-0"], eng, "carry static")
    if n == N and pairs0 != TPU_PAIRS_SEED0:
        raise AssertionError(f"carry static: {pairs0} pairs")

    # moves below IN_CELL, zeroed where a point would change cells
    grid = state[0]
    inv_cell = 1.0 / grid.cell_size
    cells = quantize(pts_t, grid.grid_min, inv_cell, grid.n_cells)
    gen = torch.Generator(device=dev).manual_seed(4)
    cur = {"pts": pts_t}

    def in_cell(k):
        step_pts = cur["pts"] + (torch.rand((n, 3), generator=gen, device=dev)
                                 * 2 - 1) * IN_CELL
        keep = (quantize(step_pts, grid.grid_min, inv_cell, grid.n_cells)
                == cells).all(dim=1)
        cur["pts"] = torch.where(keep[:, None], step_pts, cur["pts"])
        return cur["pts"]

    sol, state, out["in_cell"] = run_steps(
        step, state, in_cell, "carry in-cell", card, path)
    moved = int((cur["pts"] != pts_t).any(dim=1).sum())
    if any(out["in_cell"]["rebuilt"]) or any(out["in_cell"]["preps"]) \
            or not moved:
        raise AssertionError("carry in-cell: a step rebuilt or nothing "
                             "moved")
    fresh = make_engine(cur["pts"].clone(), RADIUS)
    fresh.run()
    total = same_lists(sol["pairs"]["0-0"], fresh, "carry in-cell")
    print(f"carry in-cell: {moved} points moved, the carry reused in every "
          f"step, equal to a fresh engine's run() ({total} pairs)",
          flush=True)
    del fresh

    def jiggle(k):
        cur["pts"] = cur["pts"] + (torch.rand(
            (n, 3), generator=gen, device=dev) * 2 - 1) * JITTER
        return cur["pts"]

    sol, state, out["jiggle"] = run_steps(
        step, state, jiggle, "carry jiggle", card, path)
    fresh = make_engine(cur["pts"].clone(), RADIUS)
    fresh.run()
    total = same_lists(sol["pairs"]["0-0"], fresh, "carry jiggle")
    counts, nbrs = fresh.get_neighbors(0, 0)
    p = cur["pts"].cpu().numpy()
    check_sample(p, p, counts, nbrs, RADIUS, fixed_rule(RADIUS), True,
                 "carry jiggle")
    print(f"carry jiggle: {sum(out['jiggle']['rebuilt'])} of {N_STEPS} "
          f"steps rebuilt, the last equal to a fresh engine's run() "
          f"({total} pairs)", flush=True)
    del fresh, counts, nbrs, sol, state, step

    payload = torch.stack([mass_t, torch.zeros_like(mass_t)], dim=1)
    rho = eng.run_reduce(density_fn, 1, payload=[mass_t])[0][:, 0]
    step, state = eng.make_step_fn(reduce=(density_fn, 1))
    sol, _, out["reduce"] = run_steps(
        step, state, lambda k: pts_t, "carry density step", card,
        (pairs.expand_query_tiles, red.pairs_reduce), payload=payload)
    if out["reduce"]["rebuilt"] != [1] + [0] * (N_STEPS - 1) \
            or not torch.equal(sol["reduce"]["s0"][0], rho):
        raise AssertionError("carry density step differs from run_reduce")
    del sol, step, state
    mask, _ = eng.run_mask()
    step, state = eng.make_step_fn(mask_output=True)
    sol, _, out["mask"] = run_steps(
        step, state, lambda k: pts_t, "carry mask step", card,
        (pairs.expand_query_tiles, pairs.pairs_mask))
    rows = int(mask["cand_base"][-1])   # the step's bits have a row cap
    if out["mask"]["rebuilt"] != [1] + [0] * (N_STEPS - 1) or not all(
            torch.equal(sol["mask"][k], mask[k])
            for k in ("cand_base", "counts_flat", "qpos")) \
            or not torch.equal(sol["mask"]["bits"][:rows], mask["bits"]) \
            or int(sol["mask_overflow"]):
        raise AssertionError("carry mask step differs from run_mask")
    print("carry: the density step equal to run_reduce and the mask step "
          "to run_mask bit for bit, steps 2-6 reusing the carry",
          flush=True)
    return out


# ------------------------------------------------ phase 17: step graphs
N_REPLAYS = 50          # phase 17: bench.py's loop of steps
N_PROFILED_REPLAYS = 5  # phase 17: replays under torch.profiler


def capture_step(step, state, args: tuple, kw: dict, extra=None):
    """A ``make_step_fn`` step captured as one CUDA graph, after an eager
    warm-up of two steps on ``args`` (a carried step's first rebuilds,
    its second reuses: every kernel is built and every workspace made) on
    a side stream.  ``extra(sol)`` is recorded after the step (bench.py's
    checksum).  Every kernel's count is set to 0 just before the capture;
    the counts after it are the graph's launches per replay.  Returns
    (graph, the static solution, state, launches, memory): ``memory``
    holds the peak device bytes allocated during the capture, the part of
    it above what was allocated before the capture (the step's working
    memory, taken from the graph's pool and reused by every replay), the
    bytes its outputs and state still hold after it, and the peak before
    the capture (``warm``: since the caller's last reset of the peak, the
    warm-up steps included)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            sol, state = step(state, *args, **kw)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    del sol
    kernels = pairs_kernels()
    for k in kernels:
        k.launches = 0
    held = torch.cuda.memory_allocated()
    warm = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        sol, state = step(state, *args, **kw)
        if extra is not None:
            extra(sol)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    memory = {"peak": peak, "work": peak - held,
              "held": torch.cuda.memory_allocated() - held, "warm": warm}
    return graph, sol, state, {k.__name__: k.launches for k in kernels}, \
        memory


def _check_graph_launches(launches: dict, label: str, path: tuple) -> None:
    names = {k.__name__ for k in path}
    if any(v != (1 if k in names else 0) for k, v in launches.items()):
        raise AssertionError(f"{label}: the captured step does not launch "
                             f"each kernel of its path once: {launches}")


def _pair_rows(pair):
    """A pair's counts and materialized rows, read from a copy of its dict
    (``materialize_nbrs`` rewrites the dict, a graph's static output)."""
    from treensearch_tpu_torch.ops import fastpath as fp
    return pair["counts"].clone(), fp.materialize_nbrs(dict(pair))


def _same_pairs(got: dict, want: dict, label: str) -> None:
    """Every pair's counts equal and rows equal slot for slot."""
    import torch
    for name in want:
        (c_g, r_g), (c_w, r_w) = _pair_rows(got[name]), _pair_rows(want[name])
        if not (torch.equal(c_g, c_w) and torch.equal(r_g, r_w)):
            raise AssertionError(f"{label}: pair {name} differs from the "
                                 "eager step")


def _same_mask(got: dict, want: dict, label: str) -> int:
    """Two mask solutions: row bases, per-slot counts and query slots
    equal, the live rows word for word.  Returns the live rows."""
    import torch
    g, w = got["mask"], want["mask"]
    rows = int(w["cand_base"][-1])
    if not (all(torch.equal(g[k], w[k]) for k in ("cand_base",
                                                  "counts_flat", "qpos"))
            and torch.equal(g["bits"][:rows], w["bits"][:rows])):
        raise AssertionError(f"{label}: the mask differs on its live rows")
    return rows


def replay_profile(replay, label: str, card: str,
                   replays: int = N_PROFILED_REPLAYS, top: int = 0) -> dict:
    """``replays`` calls of ``replay`` under torch.profiler: device events
    per replay, device work per replay, idle share, and the launches of
    K1, K1r and sort kernels in all; with ``top``, the device ms per
    replay of the ``top`` costliest kernel names."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_profile import busy_ms
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(replays):
            replay()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        raise AssertionError(f"{label}: the profiler saw no device event")
    names = collections.Counter(e.name for e in events)
    busy, window = busy_ms(events)
    out = {"events": len(events) / replays, "device_ms": busy / replays,
           "idle": 1 - busy / window,
           "k1": sum(v for k, v in names.items()
                     if "expand_query_tiles_kernel" in k),
           "k1r": sum(v for k, v in names.items()
                      if "expand_records_kernel" in k),
           "sort": sum(v for k, v in names.items() if "sort" in k.lower())}
    print(f"{label}: {replays} replays profiled, "
          f"{out['events']:.1f} device events and {out['device_ms']:.4f} "
          f"ms of device work per replay, idle share {out['idle']:.3f}, "
          f"K1 {out['k1']} launches, K1r {out['k1r']}, sort kernels "
          f"{out['sort']} ({card})", flush=True)
    if top:
        per = collections.Counter()
        for e in events:
            per[e.name] += (e.time_range.end - e.time_range.start) / 1e3
        out["top"] = [(k, v / replays) for k, v in per.most_common(top)]
        print(f"{label}: device ms per replay by kernel: " + "; ".join(
            f"{k[:70]} {v:.4f}" for k, v in out["top"]), flush=True)
    return out


def _timed_replays(replay, count: int) -> float:
    """Host ms per ``replay()`` over ``count`` calls, synchronised before
    and after the loop (bench.py's measure)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(count):
        replay()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / count


def moves(pts_t, state, count: int, amp: float, in_cell: bool,
          seed: int) -> list:
    """``count`` position sets, each moved from the last by up to ``amp``
    per coordinate; with ``in_cell`` a move that would change a point's
    cell under the grid of ``state`` is dropped."""
    import torch
    from treensearch_tpu_torch.utils.keys import quantize
    grid = state[0]
    inv_cell = 1.0 / grid.cell_size
    gen = torch.Generator(device=pts_t.device).manual_seed(seed)
    cur, out = pts_t, []
    cells = quantize(pts_t, grid.grid_min, inv_cell, grid.n_cells)
    for _ in range(count):
        nxt = cur + (torch.rand(cur.shape, generator=gen,
                                device=cur.device) * 2 - 1) * amp
        if in_cell:
            keep = (quantize(nxt, grid.grid_min, inv_cell, grid.n_cells)
                    == cells).all(dim=1)
            nxt = torch.where(keep[:, None], nxt, cur)
        out.append(nxt)
        cur = nxt
    return out


def run_reuse_graph(pts_t, card: str, eager: dict) -> dict:
    """Phase 17 at config 1: ``make_step_fn(reuse=True)`` captured once and
    replayed 50 times at static positions with bench.py's checksum, then
    at in-cell moves and at 1e-4 jitter (the next positions copied into
    the graph's input before each replay), each replay against an eager
    step on the same positions (``rebuilt``, counts, rows slot for slot);
    torch.profiler shows the prep's kernels only on rebuilding replays.
    ``eager``: phase 11's ms/step by workload."""
    import torch
    from treensearch_tpu_torch.ops import pairs
    n = pts_t.shape[0]
    eng = make_engine(pts_t, RADIUS)
    eng.run()
    eng.run()   # the first run's snug resizes the caps: settle at them
    path = (pairs.expand_query_tiles, pairs.pairs_nbrs_fixed)
    static = pts_t.clone()
    acc = torch.zeros((), dtype=torch.int32, device=pts_t.device)

    def checksum(sol):
        acc.add_(sol["pairs"]["0-0"]["counts"][::257].sum(dtype=torch.int32))

    step, state = eng.make_step_fn(reuse=True)
    graph, sol, state, launches, _ = capture_step(step, state, (static,),
                                                  {}, checksum)
    _check_graph_launches(launches, "step graph", path)
    estep, estate = eng.make_step_fn(reuse=True)
    for _ in range(2):
        want, estate = estep(estate, static)
    out = {}
    acc.zero_()
    ms = _timed_replays(graph.replay, N_REPLAYS)
    pairs0 = int(sol["pairs"]["0-0"]["counts"].sum(dtype=torch.int64))
    want_sum = int(want["pairs"]["0-0"]["counts"][::257]
                   .sum(dtype=torch.int64))
    if int(acc) != N_REPLAYS * want_sum or int(sol["rebuilt"]) != 0:
        raise AssertionError(f"step graph static: checksum {int(acc)}, "
                             f"expected {N_REPLAYS} x {want_sum}")
    if n == N and pairs0 != TPU_PAIRS_SEED0:
        raise AssertionError(f"step graph static: {pairs0} pairs")
    _same_pairs(sol["pairs"], want["pairs"], "step graph static")
    out["static"] = {"ms": ms, "eager_ms": eager["static"]["ms"]}
    print(f"step graph static: {N_REPLAYS} replays, checksum {int(acc)} = "
          f"{N_REPLAYS} x {want_sum}, {pairs0} pairs, rows equal to the "
          f"eager step; {ms:.4f} ms per replay, eager {eager['static']['ms']:.3f}"
          f" ms/step ({card})", flush=True)
    out["static"]["profile"] = replay_profile(graph.replay,
                                              "step graph static", card)
    if out["static"]["profile"]["sort"] or \
            out["static"]["profile"]["k1"] != N_PROFILED_REPLAYS:
        raise AssertionError("step graph static: a replay ran the prep or "
                             "not K1 once")

    cur = {"k": 0}
    for label, amp, in_cell, seed in (("in-cell", IN_CELL, True, 4),
                                      ("jitter", JITTER, False, 5)):
        seq = moves(static.clone(), state, N_STEPS, amp, in_cell, seed)
        rebuilt = []
        for p in seq:
            static.copy_(p)
            graph.replay()
            want, estate = estep(estate, p)
            rebuilt.append(int(sol["rebuilt"]))
            if rebuilt[-1] != int(want["rebuilt"]):
                raise AssertionError(f"step graph {label}: rebuilt differs")
            _same_pairs(sol["pairs"], want["pairs"], f"step graph {label}")
        if (label == "in-cell") == any(rebuilt):
            raise AssertionError(f"step graph {label}: rebuilt {rebuilt}")

        def replay_next():
            static.copy_(seq[cur["k"] % len(seq)])
            cur["k"] += 1
            graph.replay()

        ms = _timed_replays(replay_next, 5 * N_STEPS)
        out[label] = {"ms": ms, "eager_ms": eager[
            "in_cell" if in_cell else "jiggle"]["ms"], "rebuilt": rebuilt}
        print(f"step graph {label}: rebuilt {rebuilt}, counts and rows "
              f"equal to the eager step in every replay; {ms:.4f} ms per "
              f"replay (positions copied in), eager "
              f"{out[label]['eager_ms']:.3f} ms/step ({card})", flush=True)
        out[label]["profile"] = replay_profile(
            replay_next, f"step graph {label}", card)
    if out["in-cell"]["profile"]["sort"]:
        raise AssertionError("step graph in-cell: a replay ran the prep")
    prof = out["jitter"]["profile"]
    if prof["sort"] < N_PROFILED_REPLAYS or \
            prof["k1"] != N_PROFILED_REPLAYS:
        raise AssertionError("step graph jitter: a rebuilding replay ran no "
                             "prep, or not K1 once")
    del graph, sol, state
    torch.cuda.empty_cache()
    return out


def graph_vs_eager(label: str, make, args: tuple, kw: dict, path: tuple,
                   moved: list, same, always_rebuilds: bool = False,
                   replays: int = 10) -> dict:
    """One captured step (``make()`` returns ``(step, state)``) against
    eager steps on the same inputs: the graph and an eager state warmed
    alike on ``args``, then each entry of ``moved`` (a tuple of new values
    for ``args``) copied in and replayed beside an eager step, ``same(got,
    want, label)`` comparing their solutions; a carried step's replays
    must also rebuild as the eager ones do, and not at static inputs
    (``always_rebuilds``: a step that rebuilds every time and reports no
    ``rebuilt``).  Returns the graph, its static solution, its launches
    and memory (``capture_step``), host ms per replay over ``replays``
    replays at the last inputs, the median host ms of the eager steps
    beside the replays, and each moved replay's ``rebuilt``."""
    import torch
    step, state = make()
    graph, sol, state, launches, memory = capture_step(step, state, args,
                                                       kw)
    _check_graph_launches(launches, label, path)
    estep, estate = make()
    for _ in range(2):
        want, estate = estep(estate, *args, **kw)
    eager_ms = []

    def eager_step():
        nonlocal estate
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, estate = estep(estate, *args, **kw)
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t0) * 1e3)
        return got

    graph.replay()
    same(sol, eager_step(), f"{label} static")
    if not always_rebuilds and int(sol["rebuilt"]):
        raise AssertionError(f"{label}: a static replay rebuilt")
    rebuilt = []
    for values in moved:
        for t, v in zip(args, values):
            t.copy_(v)
        graph.replay()
        want = eager_step()
        if not always_rebuilds:
            rebuilt.append(int(sol["rebuilt"]))
            if rebuilt[-1] != int(want["rebuilt"]):
                raise AssertionError(f"{label}: rebuilt differs")
        same(sol, want, f"{label} moved")
    ms = _timed_replays(graph.replay, replays)
    print(f"{label}: captured once, launches {launches}; static and "
          f"{len(moved)} moved replays equal to the eager step"
          + ("" if always_rebuilds else f" (rebuilt {rebuilt})")
          + f"; {ms:.4f} ms per replay at the last inputs ({replays} "
          f"replays), eager {statistics.median(eager_ms):.3f} ms/step; "
          f"peak device memory at capture {memory['peak'] / 1e9:.3f} GB, "
          f"{memory['work'] / 1e9:.3f} GB of it the step's working memory, "
          f"{memory['held'] / 1e9:.3f} GB still held by its outputs",
          flush=True)
    return {"graph": graph, "sol": sol, "launches": launches,
            "memory": memory, "ms": ms,
            "eager_ms": statistics.median(eager_ms), "rebuilt": rebuilt}


def run_step_graphs(pts_t, mass_t, card: str, data3: tuple, data4: tuple,
                    eager: dict, zsort_ms: float) -> dict:
    """Phase 17: the reuse step (``run_reuse_graph``), then the density
    step (K3) against ``run_reduce``, the mask step (K4 capped) against
    ``run_mask`` on the live rows, a mask step capped below its rows
    flagging ``mask_overflow`` with exact counts, the split step (K4 then
    K5), config 3's two-set step (K2b) and config 4's variable symmetric
    step (K2c, a radius change rebuilding), each captured and replayed
    against eager steps; then the steps off the fused route
    (``run_fallback_graphs``; ``zsort_ms``: phase 15's eager ms per
    ``make_zsort_step`` call)."""
    import torch
    from treensearch_tpu_torch.ops import pairs
    from treensearch_tpu_torch.ops import reduce as red
    t0 = time.perf_counter()
    out = run_reuse_graph(pts_t, card, eager)
    k1 = pairs.expand_query_tiles

    def jittered(base: tuple, count: int = 2) -> list:
        gen = torch.Generator(device=base[0].device).manual_seed(6)
        return [(base[0] + (torch.rand(base[0].shape, generator=gen,
                                       device=base[0].device) * 2 - 1)
                 * JITTER, *base[1:]) for _ in range(count)]

    def same_lists(got, want, label):
        _same_pairs(got["pairs"], want["pairs"], label)

    eng = make_engine(pts_t, RADIUS)
    payload = torch.stack([mass_t, torch.zeros_like(mass_t)], dim=1)
    rho = eng.run_reduce(density_fn, 1, payload=[mass_t])[0][:, 0]
    rho = eng.run_reduce(density_fn, 1, payload=[mass_t])[0][:, 0]
    static = pts_t.clone()

    def same_sums(got, want, label):
        if not torch.equal(got["reduce"]["s0"], want["reduce"]["s0"]):
            raise AssertionError(f"{label}: the density differs")

    g = graph_vs_eager(
        "density step graph", lambda: eng.make_step_fn(reduce=(density_fn,
                                                               1)),
        (static,), {"payload": payload}, (k1, red.pairs_reduce),
        jittered((pts_t,)), same_sums)
    graph, sol, ms = g["graph"], g["sol"], g["ms"]
    static.copy_(pts_t)
    graph.replay()
    if not torch.equal(sol["reduce"]["s0"][0], rho):
        raise AssertionError("density step graph differs from run_reduce")
    out["density"] = {"ms": ms, "eager_ms": eager["reduce"]["ms"]}
    del g, graph, sol

    eng.run_mask()
    mask, _ = eng.run_mask()

    def same_masks(got, want, label):
        _same_mask(got, want, label)
        if int(got["mask_overflow"]):
            raise AssertionError(f"{label}: mask_overflow")

    static.copy_(pts_t)
    g = graph_vs_eager(
        "mask step graph", lambda: eng.make_step_fn(mask_output=True),
        (static,), {}, (k1, pairs.pairs_mask), jittered((pts_t,)),
        same_masks)
    graph, sol, ms = g["graph"], g["sol"], g["ms"]
    static.copy_(pts_t)
    graph.replay()
    rows = _same_mask(sol, {"mask": mask}, "mask step graph vs run_mask")
    out["mask"] = {"ms": ms, "eager_ms": eager["mask"]["ms"], "rows": rows,
                   "cap": sol["mask"]["bits"].shape[0]}
    print(f"mask step graph: {rows} live rows of a {out['mask']['cap']}-row "
          "cap equal to run_mask's word for word", flush=True)
    del g, graph, sol

    # a cap below the rows: the flag, the counts still exact
    eng._last_stats["mask_rows"] = rows // 2
    step, state = eng.make_step_fn(mask_output=True)
    static.copy_(pts_t)
    graph, sol, state, _, _ = capture_step(step, state, (static,), {})
    graph.replay()
    cap = sol["mask"]["bits"].shape[0]
    if not (cap < rows and int(sol["mask_overflow"]) == 1
            and int(sol["mask_rows"]) == rows
            and torch.equal(sol["mask"]["counts_flat"], mask["counts_flat"])
            and torch.equal(sol["mask"]["bits"][:cap], mask["bits"][:cap])):
        raise AssertionError("capped mask step graph: no overflow flag or "
                             "inexact counts")
    print(f"capped mask step graph: {rows} rows past a {cap}-row cap, "
          "mask_overflow = 1, counts equal to run_mask's, the first "
          f"{cap} rows too", flush=True)
    del graph, sol, state, eng, mask

    eng = make_engine(pts_t, RADIUS)
    eng.set_split_stage(True)
    eng.run()
    eng.run()
    static.copy_(pts_t)

    def same_split(got, want, label):
        same_lists(got, want, label)
        if int(got["mask_overflow"]):
            raise AssertionError(f"{label}: mask_overflow")

    g = graph_vs_eager(
        "split step graph", lambda: eng.make_step_fn(reuse=True), (static,),
        {}, (k1, pairs.pairs_mask, pairs.pairs_nbrs_from_bits),
        jittered((pts_t,)), same_split)
    out["split"] = {"ms": g["ms"]}
    del g, eng

    fluid, boundary = data3
    eng = config3_engine(fluid, boundary)
    eng.run()
    eng.run()
    both = torch.cat([fluid, boundary])
    static3 = both.clone()
    g = graph_vs_eager(
        "config 3 step graph", lambda: eng.make_step_fn(reuse=True),
        (static3,), {}, (k1, pairs.pairs_nbrs_sets), jittered((both,)),
        same_lists)
    out["config 3"] = {"ms": g["ms"]}
    del g, eng, static3

    pts4, rad4 = data4
    eng = config4_engine(pts4, rad4)
    eng.run()
    eng.run()
    static4, radii4 = pts4.clone(), rad4.clone()
    g = graph_vs_eager(
        "config 4 step graph", lambda: eng.make_step_fn(reuse=True),
        (static4, radii4), {}, (k1, pairs.pairs_nbrs_variable),
        [(pts4, rad4 * np.float32(0.999))] + jittered((pts4, rad4), 1),
        same_lists)
    if g["rebuilt"][0] != 1:
        raise AssertionError("config 4 step graph: a radius change at "
                             "static positions did not rebuild (r_chk)")
    out["config 4"] = {"ms": g["ms"]}
    del g, eng
    torch.cuda.empty_cache()
    out.update(run_fallback_graphs(pts_t, card, data3, data4, zsort_ms))
    print(f"phase 17: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


N_SLOW_REPLAYS = 3     # phase 17: timed and profiled replays of the
#                        device-bound steps off the fused route


def _same_solution(got: dict, want: dict, label: str) -> None:
    """Two solutions of a step that rebuilds every time: every pair's
    counts, ``max_count`` and rows (slot for slot) equal, and every flag."""
    import torch
    _same_pairs(got["pairs"], want["pairs"], label)
    for name, w in want["pairs"].items():
        if not torch.equal(got["pairs"][name]["max_count"], w["max_count"]):
            raise AssertionError(f"{label}: pair {name}'s max_count differs")
    for k, v in want.items():
        if k != "pairs" and not torch.equal(got[k], v):
            raise AssertionError(f"{label}: flag {k} differs")


def _fallback_graph(label: str, make, args: tuple, path: tuple, card: str,
                    after=None) -> dict:
    """One step off the fused route captured and replayed against eager
    steps at static and 2 jittered positions (``graph_vs_eager``,
    ``_same_solution``), 3 replays timed and profiled, the tile path's
    caps printed; ``after(graph, sol)`` checks more before the graph is
    freed and returns numbers to add, or None.  Returns its numbers."""
    import torch
    gen = torch.Generator(device=args[0].device).manual_seed(7)
    moved = [(args[0] + (torch.rand(args[0].shape, generator=gen,
                                    device=args[0].device) * 2 - 1)
              * JITTER, *args[1:]) for _ in range(2)]
    g = graph_vs_eager(label, make, args, {}, path, moved, _same_solution,
                       always_rebuilds=True, replays=N_SLOW_REPLAYS)
    prof = replay_profile(g["graph"].replay, label, card, N_SLOW_REPLAYS)
    if prof["k1r"] != N_SLOW_REPLAYS * len(path) or prof["k1"]:
        raise AssertionError(f"{label}: K1r not once per replay, or K1 ran")
    sol = g["sol"]
    rec = {"ms": g["ms"], "eager_ms": g["eager_ms"],
           "device_ms": prof["device_ms"], "events": prof["events"],
           "idle": prof["idle"], "peak_gb": g["memory"]["peak"] / 1e9,
           "work_gb": g["memory"]["work"] / 1e9}
    if after is not None:
        rec.update(after(g["graph"], sol) or {})
    print(f"{label}: {rec['ms']:.4f} ms per replay beside {rec['eager_ms']:.3f}"
          f" ms/eager step; {rec['device_ms']:.4f} ms of device work in "
          f"{rec['events']:.1f} events per replay, idle share "
          f"{rec['idle']:.3f}; peak device memory {rec['peak_gb']:.3f} GB, "
          f"{rec['work_gb']:.3f} GB of it the step's ({card})", flush=True)
    del g, sol
    torch.cuda.empty_cache()
    return rec


def run_fallback_graphs(pts_t, card: str, data3: tuple, data4: tuple,
                        zsort_ms: float) -> dict:
    """Phase 17 off the fused route: the tile-path step at config 1
    (``set_use_pallas(False)``, K1r once per replay) and with ten
    candidate sets (phase 13's), the pipeline step
    (``make_step_fn(fast=False)``) at config 1, its lists equal to
    ``run_scalar()``'s as sets, and at config 4; each captured, replayed
    against eager steps (counts, ``max_count``, the flags and the rows
    slot for slot) and timed, with its device work, idle share, peak
    memory and, on the tile path, the settled ``tiles_cap`` and ``wcap``
    beside the live tiles and the widest window.  Then
    ``make_zsort_step`` on phase 15's inputs, its orders and gathers
    equal to the eager step's bit for bit."""
    import torch
    from treensearch_tpu_torch.ops import pairs
    out = {}

    def tile_caps(label, eng):
        def after(graph, sol):
            k = eng._knobs()
            caps = {"tiles_cap": k.tiles_cap, "tiles_used":
                    int(sol["tiles_used"]), "wcap": k.wcap,
                    "win_max": int(sol["win_max"])}
            print(f"{label}: " + ", ".join(f"{a} {b}"
                                           for a, b in caps.items()),
                  flush=True)
            return caps
        return after

    label = "config 1 tile-path step graph"
    eng = make_engine(pts_t, RADIUS)
    eng.set_use_pallas(False)
    eng.run()
    eng.run()
    out[label] = _fallback_graph(
        label, eng.make_step_fn, (pts_t.clone(),), (pairs.expand_records,),
        card, tile_caps(label, eng))
    del eng

    label = f"{N_BODIES + 1} candidate sets step graph"
    fluid, boundary = data3
    bodies = list(torch.tensor_split(boundary, N_BODIES))
    eng = bodies_engine(fluid, bodies)
    eng.run()
    eng.run()
    out[label] = _fallback_graph(
        label, eng.make_step_fn, (torch.cat([fluid] + bodies),),
        (pairs.expand_records,), card, tile_caps(label, eng))
    del eng, bodies

    label = "config 1 pipeline step graph"
    eng = make_engine(pts_t, RADIUS)
    eng.run_scalar()
    eng.run_scalar()
    static = pts_t.clone()

    def vs_run_scalar(graph, sol):
        static.copy_(pts_t)
        graph.replay()
        total = equal_as_sets(_pair_rows(sol["pairs"]["0-0"]),
                              eng.get_neighbors(0, 0), label)
        print(f"{label}: the replay's lists equal run_scalar()'s as sets "
              f"({total} pairs; candidate cap {eng._cand_cap}, cand_max "
              f"{int(sol['cand_max'])})", flush=True)

    out[label] = _fallback_graph(
        label, lambda: eng.make_step_fn(fast=False), (static,), (), card,
        vs_run_scalar)
    del eng, static

    label = "config 4 pipeline step graph"
    p4, r4 = data4
    eng = config4_engine(p4, r4)
    eng.run_scalar()
    eng.run_scalar()

    def cand(graph, sol):
        print(f"{label}: candidate cap {eng._cand_cap}, cand_max "
              f"{int(sol['cand_max'])}", flush=True)

    out[label] = _fallback_graph(
        label, lambda: eng.make_step_fn(fast=False), (p4.clone(),
                                                      r4.clone()),
        (), card, cand)
    del eng
    out["make_zsort_step graph"] = run_zsort_graph(pts_t, data3, card,
                                                   zsort_ms)
    return out


def run_zsort_graph(pts_t, data3: tuple, card: str, eager_ms: float) -> dict:
    """``make_zsort_step`` over config 3's two sets and a third (phase 15's
    inputs, 2 arrays each) captured once, replayed at the static points
    and at 2 jittered ones (copied into the graph's inputs) against the
    eager step, orders, points and arrays bit for bit; 10 replays
    timed beside phase 15's eager ms per step."""
    import torch
    from treensearch_tpu_torch.ops import zsort as zs
    dev = pts_t.device
    extra = torch.rand((N_ZSORT_EXTRA, 3), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(5))
    sets3 = [p.clone() for p in data3] + [extra]
    per_set = [[torch.ones_like(p), p[:, 0].clone()] for p in sets3]
    step = zs.make_zsort_step(len(sets3))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            step(sets3, per_set)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = step(sets3, per_set)

    def flat(out):
        orders, pts, arrs = out
        return list(orders) + list(pts) + [a for per in arrs for a in per]

    gen = torch.Generator(device=dev).manual_seed(8)
    for k in range(3):
        if k:
            for p in sets3:
                p.add_((torch.rand(p.shape, generator=gen, device=dev) * 2
                        - 1) * JITTER)
        graph.replay()
        want = step(sets3, per_set)
        if not all(torch.equal(a, b) for a, b in zip(flat(got),
                                                       flat(want))):
            raise AssertionError(f"make_zsort_step graph: replay {k} "
                                 "differs from the eager step")
    ms = _timed_replays(graph.replay, 10)
    print(f"make_zsort_step graph: {len(sets3)} sets "
          f"({', '.join(str(p.shape[0]) for p in sets3)} points, 2 arrays "
          "each) captured once; static and 2 jittered replays equal to the "
          f"eager step bit for bit; {ms:.4f} ms per replay (10 replays) "
          f"beside phase 15's eager {eager_ms:.4f} ms/step ({card})",
          flush=True)
    del graph, got
    return {"ms": ms, "eager_ms": eager_ms}


# ---------------------------------------------- phases 12-14: fallbacks
def k1r_bound(desc, tiles_cap: int, slack: int) -> tuple:
    """(bytes, ms): each live slot's record read once (32 B), every
    slot's query record and padded record written (64 B), the slack's
    padded records (32 B each) and two descriptor words per tile; HBM."""
    live = int(live_slots(desc, tiles_cap).sum())
    moved = 32 * live + 64 * 128 * tiles_cap + 32 * slack + 8 * tiles_cap
    return moved, moved / HBM_BYTES_PER_S * 1e3


def check_k1r(eng, dev) -> dict:
    """Phase 12: K1r against its plain version, bit for bit, on a settled
    tile-path engine's padded-layout structures; its query tiles against
    K1's; its time, the plain time, one ``index_select`` of the same
    records into the padded layout and its bound."""
    import torch
    from treensearch_tpu_torch.ops import fastpath as fp
    from treensearch_tpu_torch.ops import pairs
    _, a = settled_inputs(eng, padded=True)
    n = eng.get_total_n_points()
    desc, recs, tiles_cap = a.desc, a.recs_t, a.tiles_cap
    slack = fp._statics(eng._make_cfg(1), eng._knobs())["slack"]

    def k1r():
        return pairs.expand_records(desc, recs, tiles_cap, n, slack)

    def k1r_plain():
        return pairs.expand_records_plain(desc, recs, tiles_cap, n, slack)

    (q_k, r_k), (q_p, r_p) = k1r(), k1r_plain()
    if not (torch.equal(q_k, q_p) and torch.equal(r_k, r_p)):
        raise AssertionError(
            f"expand_records: {int((q_k != q_p).sum())} query words and "
            f"{int((r_k != r_p).sum())} record words differ")
    if not torch.equal(q_k, pairs.expand_query_tiles(desc, recs, tiles_cap,
                                                      n)):
        raise AssertionError("expand_records: query tiles differ from K1's")
    err = max(int((q_k.long() - q_p.long()).abs().max()),
              int((r_k.long() - r_p.long()).abs().max()))
    rec = {"name": "expand_records", "max_abs_err": err}
    print(f"expand_records: q_t and rec_pad bit-equal to the plain version "
          f"and q_t to K1's over {tiles_cap} tiles ({int(live_slots(desc, tiles_cap).sum())} "
          f"live slots, slack {slack})", flush=True)
    timed_turns(rec, k1r, k1r_plain, dev)
    # the yardstick: one gather of the slot-major records (and a sentinel
    # row) into the padded layout, its index made beforehand
    lane = torch.arange(128, device=dev)
    src = desc[:tiles_cap, 62, None].long() + lane[None, :]
    src = torch.where(live_slots(desc, tiles_cap).view(tiles_cap, 128), src,
                      n).reshape(-1)
    src = torch.cat([src, src.new_full((slack,), n)])
    rows = torch.cat([recs, pairs._sentinel(n, dev)[:, None]], 1).t() \
        .contiguous()
    if not torch.equal(torch.index_select(rows, 0, src), r_k):
        raise AssertionError("expand_records: index_select yardstick "
                             "differs")
    rec["library_ms"] = median_ms(lambda: torch.index_select(rows, 0, src),
                                  dev)
    moved, rec["bound_ms"] = k1r_bound(desc, tiles_cap, slack)
    rec["bound_by"] = "bytes"
    print(f"expand_records: index_select {rec['library_ms']:.4f} ms; bound "
          f"{rec['bound_ms']:.4f} ms ({moved} B over HBM)", flush=True)
    return rec


def run_tile_path(pts_t, card: str) -> tuple:
    """Phase 12: K1r, then config 1's ``run()`` on the tile path against
    the fused ``run()``."""
    from treensearch_tpu_torch.ops import pairs
    n = pts_t.shape[0]
    eng = make_engine(pts_t, RADIUS)
    eng.set_use_pallas(False)
    rec = check_k1r(eng, pts_t.device)
    eng = make_engine(pts_t, RADIUS)
    eng.set_use_pallas(False)
    out = drive(eng, "config 1 tile path", (pairs.expand_records,),
                _jitter_one_set(eng, pts_t), card, once=True)
    if n == N and out["pairs0"] != TPU_PAIRS_SEED0:
        raise AssertionError(f"config 1 tile path: {out['pairs0']} pairs, "
                             f"not {TPU_PAIRS_SEED0}")
    fused = make_engine(eng._sets[0].points, RADIUS)
    fused.run()
    total = equal_as_sets(eng.get_neighbors(0, 0), fused.get_neighbors(0, 0),
                          "config 1 tile path")
    print(f"config 1 tile path: every point's count and row equal to the "
          f"fused run()'s on the last positions ({total} pairs; window cap "
          f"{eng._wcap}, tiles {eng._tiles_cap})", flush=True)
    return rec, out


def bodies_engine(fluid_t, bodies):
    """Phase 13: the fluid and one boundary set per rigid body; the fluid
    searches itself and every body, the bodies search nothing."""
    from treensearch_tpu_torch import TreeNSearch
    eng = TreeNSearch(device=fluid_t.device)
    eng.add_point_set(fluid_t)
    for b in bodies:
        eng.add_point_set(b)
    eng.set_search_radius(R3)
    for j in range(len(bodies) + 1):
        eng.set_active_search(0, j, True)
    return eng


def run_bodies(fluid_t, boundary_t, card: str) -> dict:
    """Phase 13: ten candidate sets on the tile path against config 3's
    fused ``run()``, per point, and cKDTree samples."""
    import torch
    from treensearch_tpu_torch.ops import pairs
    state = {"f": fluid_t,
             "b": list(torch.tensor_split(boundary_t, N_BODIES))}
    eng = bodies_engine(state["f"], state["b"])

    def jitter(noise):
        state["f"] = state["f"] + noise(tuple(state["f"].shape))
        state["b"] = [b + noise(tuple(b.shape)) for b in state["b"]]
        eng.resize_point_set(0, state["f"])
        for k, b in enumerate(state["b"]):
            eng.resize_point_set(k + 1, b)

    out = drive(eng, f"{N_BODIES + 1} candidate sets", (pairs.expand_records,),
                jitter, card, once=True, runs=N_SLOW_RUNS)
    boundary = torch.cat(state["b"])
    ref = config3_engine(state["f"], boundary)
    ref.run()
    n_ff = equal_as_sets(eng.get_neighbors(0, 0), ref.get_neighbors(0, 0),
                         "bodies fluid->fluid")
    # the union of the fluid->body rows, rebased to the whole boundary
    counts, rows, off = 0, [], 0
    for k, b in enumerate(state["b"]):
        c, r = eng.get_neighbors(0, k + 1)
        j = torch.arange(r.shape[1], device=r.device)[None, :]
        rows.append(torch.where(j < c[:, None], r + off, -1))
        counts = counts + c
        off += b.shape[0]
    rows = torch.sort(torch.cat(rows, dim=1), dim=1, descending=True).values
    union = (counts, rows)
    n_fb = equal_as_sets(union, ref.get_neighbors(0, 1),
                         "bodies fluid->boundary")
    f, bd = state["f"].cpu().numpy(), boundary.cpu().numpy()
    check_sample(f, f, *eng.get_neighbors(0, 0), R3, fixed_rule(R3), True,
                 "bodies fluid->fluid")
    check_sample(f, bd, *union, R3, fixed_rule(R3), False,
                 "bodies fluid->boundary (union of 9)")
    print(f"{N_BODIES + 1} candidate sets: fluid->fluid ({n_ff} pairs) and "
          f"the union of the {N_BODIES} fluid->body pairs ({n_fb} pairs) "
          f"equal to config 3's fused run() for all {f.shape[0]} fluid "
          "points", flush=True)
    return out


def check_double_accum(device) -> None:
    """Phase 14: ``run_scalar`` with and without float64 d^2 on a small
    cloud holding a pair that the two precisions decide differently,
    against the numpy predicates of each."""
    from treensearch_tpu_torch import TreeNSearch
    r = 0.1
    r2 = np.float32(r) * np.float32(r)
    p0 = np.float32(0.25)
    rng = np.random.default_rng(42)
    off = None
    while off is None:
        d = rng.normal(size=(100_000, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        scale = np.float64(r) * (1 + rng.uniform(-6e-8, 6e-8, (d.shape[0], 1)))
        o = (p0 + (d * scale).astype(np.float32)).astype(np.float32) - p0
        in32 = (o[:, 0] * o[:, 0] + o[:, 1] * o[:, 1]) + o[:, 2] * o[:, 2] \
            <= r2
        o64 = o.astype(np.float64)
        in64 = (o64[:, 0] * o64[:, 0] + o64[:, 1] * o64[:, 1]) \
            + o64[:, 2] * o64[:, 2] <= np.float64(r2)
        flip = np.nonzero(in32 != in64)[0]
        off = o[flip[0]] if flip.size else None
    pts = np.concatenate([[np.full(3, p0, np.float32),
                           np.full(3, p0, np.float32) + off],
                          rng.uniform(0, 1, (N_SMALL, 3))]).astype(np.float32)
    flips = 0
    for f64 in (False, True):
        eng = TreeNSearch(device=device)
        eng.add_point_set(pts)
        eng.set_search_radius(r)
        eng.set_all_searches(True)
        eng.set_scalar_double_accum(f64)
        eng.run_scalar()
        counts, nbrs = (t.cpu().numpy() for t in eng.get_neighbors(0, 0))
        # float64: the coordinates promoted, r^2 the float32 square
        # promoted, as the pipeline computes it
        p = pts.astype(np.float64) if f64 else pts
        m = _d2(p, p) <= (np.float64(r2) if f64 else r2)
        np.fill_diagonal(m, False)
        for i, row in enumerate(m):
            if counts[i] != row.sum() or not np.array_equal(
                    np.sort(nbrs[i, :counts[i]]), np.nonzero(row)[0]):
                raise AssertionError(f"double accum {f64}: point {i} differs "
                                     "from its numpy predicate")
        flips += int(1 in nbrs[0, :counts[0]])
    if flips != 1:
        raise AssertionError("double accum: the boundary pair was not "
                             "decided differently by the two modes")
    print(f"set_scalar_double_accum: {N_SMALL + 2} points equal to the "
          "float32 and float64 numpy predicates, the boundary pair "
          "decided differently", flush=True)


def run_pipeline_path(pts_t, card: str, data4: tuple) -> dict:
    """Phase 14: ``run_scalar`` at configs 1 and 4 against the fused
    ``run()``, the wide-stencil and sparse clouds against cKDTree, the
    pipeline's step and the float64 mode."""
    import torch
    from treensearch_tpu_torch import TreeNSearch
    from treensearch_tpu_torch.ops import fastpath as fp
    dev = pts_t.device
    n = pts_t.shape[0]
    out = {}
    eng = make_engine(pts_t, RADIUS)
    out["config 1"] = drive(eng, "config 1 run_scalar", (),
                            _jitter_one_set(eng, pts_t), card,
                            call=eng.run_scalar, runs=N_SLOW_RUNS)
    if n == N and out["config 1"]["pairs0"] != TPU_PAIRS_SEED0:
        raise AssertionError("config 1 run_scalar: pair count "
                             f"{out['config 1']['pairs0']}")
    fused = make_engine(eng._sets[0].points, RADIUS)
    fused.run()
    total = equal_as_sets(eng.get_neighbors(0, 0), fused.get_neighbors(0, 0),
                          "config 1 run_scalar")
    print(f"config 1 run_scalar: every point equal to the fused run() on the "
          f"last positions ({total} pairs; candidate cap {eng._cand_cap}, "
          f"path {eng._last_stats['path']})", flush=True)
    del eng, fused

    p4, r4 = data4
    eng = config4_engine(p4, r4)
    state = {"p": p4}

    def jitter4(noise):
        state["p"] = state["p"] + noise(tuple(state["p"].shape))
        eng.resize_point_set(0, state["p"], r4)

    out["config 4"] = drive(eng, "config 4 run_scalar", (), jitter4, card,
                            call=eng.run_scalar, runs=N_SLOW_RUNS)
    fused = config4_engine(state["p"], r4)
    fused.run()
    total = equal_as_sets(eng.get_neighbors(0, 0), fused.get_neighbors(0, 0),
                          "config 4 run_scalar")
    print(f"config 4 run_scalar: every point equal to the fused run() "
          f"({total} pairs)", flush=True)
    del eng, fused

    rng = np.random.default_rng(6)
    pts = rng.uniform(0, 1, (N_WIDE, 3)).astype(np.float32)
    rad = rng.uniform(*R_WIDE, N_WIDE).astype(np.float32)
    eng = TreeNSearch(device=dev)
    eng.add_point_set(torch.from_numpy(pts).to(dev),
                      torch.from_numpy(rad).to(dev))
    eng.set_all_searches(True)
    try:
        eng.run()
    except ValueError as e:
        if "run_scalar()" not in str(e):
            raise
        print(f"wide stencil: run() raises: {e}", flush=True)
    else:
        raise AssertionError("wide stencil: run() did not raise")
    eng.run_scalar()
    w = eng._last_stats["stencil_w"]
    if w < 4:
        raise AssertionError(f"wide stencil: W = {w}")
    counts, nbrs = eng.get_neighbors(0, 0)
    r2 = rad * rad
    check_sample(pts, pts, counts, nbrs, float(rad.max()),
                 lambda i, c, d2: (d2 <= r2[i]) | (d2 <= r2[c]), True,
                 f"wide stencil (W = {w}) run_scalar")
    step, sstate = eng.make_step_fn(fast=False)
    sol, _ = step(sstate, eng._assemble()[0], eng._assemble()[1])
    fp_pair = sol["pairs"]["0-0"]
    if not (torch.equal(fp_pair["counts"], counts)
            and torch.equal(fp_pair["nbrs"], nbrs)):
        raise AssertionError("make_step_fn(fast=False) differs from "
                             "run_scalar()")
    print("make_step_fn(fast=False): counts and rows equal to run_scalar()'s "
          "slot for slot", flush=True)
    del eng, step, sol

    cell = 1.5 * RADIUS
    side = BOX_CELLS * cell
    lo = rng.uniform(0, 10 * cell, (N_CLUSTER, 3))
    pts = np.concatenate([lo, side - lo]).astype(np.float32)
    eng = make_engine(torch.from_numpy(pts).to(dev), RADIUS)
    eng.set_cell_size(cell)
    before = fp._prep.calls
    eng.run()
    if eng._last_stats["path"] != "reference":
        raise AssertionError(f"sparse cloud: path {eng._last_stats}")
    counts, nbrs = eng.get_neighbors(0, 0)
    check_sample(pts, pts, counts, nbrs, RADIUS, fixed_rule(RADIUS), True,
                 "sparse cloud (pipeline after the dense cap)")
    print(f"sparse cloud: {pts.shape[0]} points in a box {BOX_CELLS} cells "
          f"wide, dense table at its cap {eng._dense_cap} after "
          f"{fp._prep.calls - before} preps, then the pipeline "
          f"({int(counts.sum(dtype=torch.int64))} pairs)", flush=True)
    del eng
    check_double_accum(dev)
    return out


def zsort_arrays(pts_t) -> tuple:
    """Phase 15's eight per-point arrays of one set of n points (BASELINE
    config 5's "zsort of 8 user arrays"): the positions, a float32
    velocity (n, 3), float32 density and mass, a float64 and an int64
    array whose values a 32-bit gather would corrupt, an int32 id and a
    flat float32 (3n,) array of stride 3, made on the card from
    ``default_rng(4)``'s seed; and their strides."""
    import torch
    dev = pts_t.device
    n = pts_t.shape[0]
    gen = torch.Generator(device=dev).manual_seed(4)

    def rand(*shape, dtype=torch.float32):
        return torch.rand(shape, generator=gen, device=dev, dtype=dtype)

    ids = torch.arange(n, device=dev, dtype=torch.int64)
    arrays = [pts_t, rand(n, 3), rand(n), rand(n) + 0.5,
              rand(n, dtype=torch.float64) + 2.0 ** -40,
              (ids << 33) + 7, ids.to(torch.int32), rand(3 * n)]
    return arrays, [1] * 7 + [3]


def run_zsort_path(pts_t, card: str, data3: tuple) -> dict:
    """Phase 15: z-sort and the diagnostics at config 1.  ``run()``, then
    ``prepare_zsort`` on the cell path, the eight arrays reordered by
    ``apply_zsort_batch`` and ``run()`` on the reordered positions, with
    every kernel's count set to 0 just before and read just after (K1
    and K2a in each run, no other); the arrays bit-exact against a host
    ``np.take``, the pair total and a sample's neighbor sets mapped
    through the order equal to the unsorted run's; the per-point order on
    the card equal to the CPU's; ``make_zsort_step`` over config 3's sets
    and one more (``data3``) equal to ``prepare_zsort``'s per-point
    orders; ``print_state`` and ``profile_run`` (the trace names K1 and
    K2a); the timings."""
    import tempfile

    import torch
    from treensearch_tpu_torch import TreeNSearch
    from treensearch_tpu_torch.ops import pairs
    from treensearch_tpu_torch.ops import zsort as zs
    dev = pts_t.device
    n = pts_t.shape[0]
    arrays, strides = zsort_arrays(pts_t)
    eng = make_engine(pts_t, RADIUS)
    got = {}

    def zsort_path():
        eng.run()
        got["before"] = eng.get_neighbors(0, 0)
        carry = eng._fast_carry
        eng.prepare_zsort()
        w = eng._last_stats["stencil_w"]
        nc = eng._grid_state.n_cells
        got["cell"] = zs.zsort_orders_from_cells(
            [carry.lin_chk], nc[1] + 2 * w, nc[2] + 2 * w)[0]
        got["order"] = eng._zsort_maps[0]
        got["sorted"] = eng.apply_zsort_batch(0, arrays, strides)
        eng.resize_point_set(0, got["sorted"][0])
        eng.run()

    launches = _path_launches(zsort_path, "z-sort", (
        pairs.expand_query_tiles, pairs.pairs_nbrs_fixed))
    order = got["order"]
    if not torch.equal(order, got["cell"]):
        raise AssertionError("z-sort: prepare_zsort did not take the cell "
                             "path after run()")
    order_h = order.cpu().numpy()
    for k, (a, st, b) in enumerate(zip(arrays, strides, got["sorted"])):
        rows = a.cpu().numpy().reshape(n, -1 if st == 1 else st)
        want = np.take(rows, order_h, axis=0).reshape(tuple(a.shape))
        if b.dtype != a.dtype or b.device != a.device \
                or not np.array_equal(b.cpu().numpy(), want):
            raise AssertionError(f"z-sort: array {k} ({a.dtype}) differs "
                                 "from a host np.take")
    print(f"z-sort: cell path; {len(arrays)} arrays "
          f"({', '.join(str(a.dtype).replace('torch.', '') for a in arrays)}"
          f") bit-exact against a host np.take; launches {launches}",
          flush=True)

    counts, nbrs = eng.get_neighbors(0, 0)
    total = int(counts.sum(dtype=torch.int64))
    if n == N and total != TPU_PAIRS_SEED0:
        raise AssertionError(f"z-sort: {total} pairs after the reorder")
    q = torch.as_tensor(np.sort(np.random.default_rng(2).choice(
        n, min(N_SAMPLE, n), replace=False)), device=dev)
    old = order[q].long()
    rows = nbrs[q]
    mapped = torch.where(rows >= 0, order[rows.clamp(min=0).long()], -1)
    c_b, nb_b = got["before"]
    equal_as_sets((counts[q], mapped), (c_b[old], nb_b[old]),
                  "z-sort sample")
    print(f"z-sort: run() on the reordered points {total} pairs; "
          f"{q.numel()} sampled neighbor sets, mapped through the order, "
          "equal to the unsorted run's", flush=True)

    point = TreeNSearch(device=dev)
    point.add_point_set(pts_t)
    host = TreeNSearch(device="cpu")
    host.add_point_set(pts_t.cpu())
    for e in (point, host):
        e.prepare_zsort()
    if not np.array_equal(point.get_zsort_order(0), host.get_zsort_order(0)):
        raise AssertionError("z-sort: the per-point order on the card "
                             "differs from the CPU's")
    print("z-sort: per-point order on the card equal to the CPU's", flush=True)

    extra = torch.rand((N_ZSORT_EXTRA, 3), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(5))
    sets3 = list(data3) + [extra]
    step = zs.make_zsort_step(len(sets3))
    per_set = [[torch.ones_like(p), p[:, 0].clone()] for p in sets3]
    s_orders, s_pts, s_arrs = step(sets3, per_set)
    e3 = TreeNSearch(device=dev)
    for p in sets3:
        e3.add_point_set(p)
    e3.prepare_zsort()
    for k, (o, p, a) in enumerate(zip(s_orders, s_pts, s_arrs)):
        if not (torch.equal(o, e3._zsort_maps[k])
                and torch.equal(p, sets3[k][o.long()])
                and torch.equal(a[1], sets3[k][o.long(), 0])):
            raise AssertionError(f"make_zsort_step: set {k} differs from "
                                 "prepare_zsort's per-point order")
    print(f"make_zsort_step: {len(sets3)} sets "
          f"({', '.join(str(p.shape[0]) for p in sets3)} points, 2 arrays "
          "each) equal to prepare_zsort's per-point orders", flush=True)

    eng.print_state()
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(eng.profile_run(tmp),
                             "treensearch.pt.trace.json")
        with open(trace) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    found = {k: sorted(x for x in names if k in x)[:1]
             for k in ("expand_query_tiles_kernel", "pairs_nbrs_kernel")}
    print(f"profile_run: {found}", flush=True)
    if dev.type == "cuda" and not all(found.values()):
        raise AssertionError("profile_run: the trace names no K1 or K2a")

    def prepare_point():
        point.prepare_zsort()
        sync(dev)

    def prepare_cell():
        eng.prepare_zsort()
        sync(dev)

    times = {
        "prepare_zsort cell path": median_ms(prepare_cell, dev, reps=5),
        "prepare_zsort per-point path": median_ms(prepare_point, dev, reps=5),
        f"apply_zsort_batch ({len(arrays)} arrays)": median_ms(
            lambda: eng.apply_zsort_batch(0, arrays, strides), dev, reps=5),
        ZSORT_STEP_TIMING: median_ms(lambda: step(sets3, per_set), dev,
                                     reps=5)}
    unsorted = make_engine(pts_t, RADIUS)
    for label, e in (("before the reorder", unsorted),
                     ("after the reorder", eng)):
        e.run()
        times[f"run() carried, {label}"] = median_ms(e.run, dev, reps=5)
        e.set_coherence(False)
        times[f"run() rebuilt, {label}"] = median_ms(e.run, dev, reps=5)
    for label, ms in times.items():
        print(f"z-sort timing: {label}: {ms:.4f} ms (median of 5, "
              f"synchronised; {card})", flush=True)
    return {"launches": launches, "ms": times}


# ------------------------------------------------- phase 16: sharded
def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def one_dim_mesh(dev_type: str, ranks: int):
    """A ``DeviceMesh`` of ``ranks`` ranks with one dimension, "d"."""
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(dev_type, list(range(ranks)), mesh_dim_names=("d",))


def _pairs_equal(one, many, label: str) -> int:
    """Every active pair of the mesh engine ``many`` against the one-device
    engine ``one``: counts equal for every query, rows equal as sets.
    Returns the pair total (collective on ``many``)."""
    total = 0
    for i, j in zip(*np.nonzero(one._active)):
        total += equal_as_sets(one.get_neighbors(int(i), int(j)),
                               many.get_neighbors(int(i), int(j)),
                               f"{label} pair {i}->{j}")
    return total


def _sharded_pair(make, jitter_of, label: str, path: tuple, card: str,
                  mesh, call=None, runs: int = N_RUNS,
                  pairs_of=None) -> dict:
    """One path of phase 16 at world size 1: ``drive`` on a one-device
    engine and on the same engine under ``mesh`` (same points, same
    jitter), then every query of the last positions compared.  Returns
    both drives, the pair total and the mesh run's peak memory."""
    import torch
    one, many = make(), make()
    many.distribute(mesh)
    r1 = drive(one, f"{label} one device", path, jitter_of(one), card,
               call=call and call(one), runs=runs, pairs_of=pairs_of)
    dev = many.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rm = drive(many, f"{label} mesh", path, jitter_of(many), card,
               call=call and call(many), runs=runs, pairs_of=pairs_of)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 \
        if dev.type == "cuda" else float("nan")
    return {"one": r1, "mesh": rm, "one_eng": one, "mesh_eng": many,
            "peak_gb": peak}


def _jitter_state(radii=None):
    """A jitter for ``drive`` that moves every set of an engine by the
    same noise on each call, so two engines stay at the same points."""
    def of(eng):
        state = [s.points for s in eng._sets]

        def jitter(noise):
            for k, p in enumerate(state):
                state[k] = p + noise(tuple(p.shape))
                eng.resize_point_set(k, state[k],
                                     None if radii is None else radii[k])
        return jitter
    return of


def run_sharded_path(pts_t, mass_t, card: str, data3: tuple,
                     data4: tuple) -> dict:
    """Phase 16: the sharded search (``parallel/sharded.py``).  World size
    1 over NCCL (gloo on the CPU) in this process: the engine's exact-size
    calls (``run_sharded_exact``), then on the card the bucketed step
    captured over NCCL (``run_sharded_steps``).  Then four gloo ranks on
    the one card (``run_gloo_ranks``) at configs 1 and 3."""
    import torch
    import torch.distributed as dist
    t0 = time.perf_counter()
    dev = pts_t.device
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = one_dim_mesh(dev.type, 1)
        out = run_sharded_exact(pts_t, mass_t, card, data4, mesh)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            out["steps"] = run_sharded_steps(pts_t, card, data3, data4, mesh)
    finally:
        dist.destroy_process_group()
    out["gloo"] = run_gloo_ranks(dev, pts_t.shape[0], data3[0].shape[0],
                                 data3[1].shape[0], card)
    print(f"phase 16: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def run_sharded_exact(pts_t, mass_t, card: str, data4: tuple, mesh) -> dict:
    """Phase 16's exact-size calls under the one-rank ``mesh``: config 1's
    ``run()``, config 4's, ``run_reduce`` of the density at config 1 and
    config 1's ``run_scalar()``, each a settling and jittered calls under
    the mesh beside the same calls on one device, every query's counts
    and rows equal at the last positions (the density within 5e-5),
    32,759,462 pairs at seed 0.  Returns each call's drives."""
    import torch
    import torch.distributed as dist
    from treensearch_tpu_torch.ops import pairs
    from treensearch_tpu_torch.ops import reduce as red
    n = pts_t.shape[0]
    out = {}
    k1, k2a = pairs.expand_query_tiles, pairs.pairs_nbrs_fixed
    c1 = _sharded_pair(lambda: make_engine(pts_t, RADIUS), _jitter_state(),
                       "sharded config 1", (k1, k2a), card, mesh)
    total = _pairs_equal(c1["one_eng"], c1["mesh_eng"], "sharded config 1")
    if n == N and c1["mesh"]["pairs0"] != TPU_PAIRS_SEED0:
        raise AssertionError(f"sharded config 1: {c1['mesh']['pairs0']} "
                             "pairs before the jitter")
    out["config 1"] = c1
    print(f"sharded config 1: {c1['mesh']['pairs0']} pairs before the "
          f"jitter, every query's count and row set equal to one "
          f"device's on the last positions ({total} pairs)", flush=True)

    p4, r4 = data4
    c4 = _sharded_pair(lambda: config4_engine(p4, r4), _jitter_state([r4]),
                       "sharded config 4", (k1, pairs.pairs_nbrs_variable),
                       card, mesh)
    total = _pairs_equal(c4["one_eng"], c4["mesh_eng"], "sharded config 4")
    out["config 4"] = c4
    print(f"sharded config 4: every query's count and row set equal "
          f"to one device's ({total} pairs)", flush=True)

    def density(eng):
        return lambda: eng.run_reduce(density_fn, 1, payload=[mass_t])

    cr = _sharded_pair(lambda: make_engine(pts_t, RADIUS), _jitter_state(),
                       "sharded run_reduce", (k1, red.pairs_reduce), card,
                       mesh, call=density,
                       pairs_of=lambda _: c1["mesh"]["pairs0"])
    a = density(cr["one_eng"])()[0]
    b = density(cr["mesh_eng"])()[0]
    if not torch.allclose(a, b, rtol=DENSITY_RTOL, atol=0):
        raise AssertionError("sharded run_reduce: density differs")
    worst = float(((a - b).abs() / a.abs().clamp(min=1e-30)).max())
    print(f"sharded run_reduce: the density of all {n} points within "
          f"{DENSITY_RTOL} of one device's (worst relative difference "
          f"{worst:.3e}; bit-equal: {bool(torch.equal(a, b))})", flush=True)
    out["run_reduce"] = cr

    cs = _sharded_pair(lambda: make_engine(pts_t, RADIUS), _jitter_state(),
                       "sharded run_scalar", (), card, mesh,
                       call=lambda e: e.run_scalar, runs=N_SLOW_RUNS)
    total = _pairs_equal(cs["one_eng"], cs["mesh_eng"], "sharded run_scalar")
    if cs["mesh_eng"]._last_stats["path"] != "reference":
        raise AssertionError("sharded run_scalar: not the pipeline")
    out["run_scalar"] = cs
    print(f"sharded run_scalar: every query equal to one device's "
          f"({total} pairs)", flush=True)
    backend = dist.get_backend(mesh.get_group("d"))
    for label, r in out.items():
        print(f"sharded {label} (world size 1, {backend}): mesh "
              f"{r['mesh']['ms']:.3f} ms/call beside one device "
              f"{r['one']['ms']:.3f} ms/call; launches "
              f"{ {k: v for k, v in r['mesh']['launches'].items() if v} }; "
              f"peak device memory {r['peak_gb']:.3f} GB ({card})",
              flush=True)
        del r["one_eng"], r["mesh_eng"]
    return out


SMALL_SLACK = 0.2      # phase 16: a route slack whose buckets overflow


def sharded_step_of(eng, mesh, fast: bool = True, route_slack=None):
    """``make_sharded_step`` on a settled engine's sets, stencil, radius,
    cell size and caps, at JAX's default route slack unless
    ``route_slack`` is given, and the step's first solution, eager on the
    engine's points.  The buckets' sentinel rows take tile slots that the
    engine's exact-size ``tiles_cap`` does not hold, so the step is made
    again with more tiles (the engine's regrow, ``int(1.5 t) + 64``, from
    the default for the local rows) until a step reports no
    ``tile_overflow``: a step does not regrow.  Collective.  Returns
    ``make()``, a maker of that step, the solution and the settled
    ``tiles_cap`` (0: the default for the local rows)."""
    from treensearch_tpu_torch.ops import fastpath as fp
    from treensearch_tpu_torch.ops.grid import fresh_state
    from treensearch_tpu_torch.parallel import sharded as sh
    _, _, sr, cell, w = eng._setup()
    cfg, knobs = eng._make_cfg(w), eng._knobs()._replace(tiles_cap=0)
    slack = sh.ROUTE_SLACK if route_slack is None else route_slack
    while True:
        def make(knobs=knobs):
            return sh.make_sharded_step(cfg, mesh, cell, sr, knobs=knobs,
                                        fast=fast, route_slack=slack)
        sol, _ = make()(fresh_state(eng.device), *_step_inputs(eng))
        if not (fast and int(sol["tile_overflow"])):
            return make, sol, knobs.tiles_cap
        tiles = knobs.tiles_cap or fp.default_tiles_cap(sum(sol["slab_rows"]))
        knobs = knobs._replace(tiles_cap=int(tiles * 1.5) + 64)


def _step_inputs(eng) -> tuple:
    """An engine's concatenated points, and radii in variable mode."""
    points, radii = eng._assemble()
    return (points,) if radii is None else (points, radii)


def _step_vs_engine(sol, eng, label: str, gather=None) -> int:
    """A sharded step's every active pair against ``eng``'s lists (the
    pair's rows gathered by ``gather(x, rows)`` across ranks, else this
    rank's = every row): counts equal, rows equal as sets, and no
    ``route_overflow``.  Returns the pair total (collective with
    ``gather``)."""
    if int(sol["route_overflow"]):
        raise AssertionError(f"{label}: route_overflow")
    total = 0
    for i, j in zip(*np.nonzero(eng._active)):
        pair = sol["pairs"][f"{i}-{j}"]
        got = (pair["counts"], pair["nbrs"]) if gather is None else (
            gather(pair["counts"], pair["rows"]),
            gather(pair["nbrs"], pair["rows"]))
        total += equal_as_sets(got, eng.get_neighbors(int(i), int(j)),
                               f"{label} pair {i}->{j}")
    return total


def _same_sharded(got: dict, want: dict, label: str) -> None:
    """Two sharded step solutions: every pair's counts, ``max_count`` and
    rows slot for slot, every flag, and no ``route_overflow``."""
    import torch
    _same_pairs(got["pairs"], want["pairs"], label)
    for name, w in want["pairs"].items():
        if not torch.equal(got["pairs"][name]["max_count"], w["max_count"]):
            raise AssertionError(f"{label}: pair {name}'s max_count differs")
    for k, v in want.items():
        if isinstance(v, torch.Tensor) and not torch.equal(got[k], v):
            raise AssertionError(f"{label}: flag {k} differs")
    if int(got["route_overflow"]):
        raise AssertionError(f"{label}: route_overflow")


def run_sharded_steps(pts_t, card: str, data3: tuple, data4: tuple,
                      mesh) -> dict:
    """Phase 16's step: ``make_sharded_step`` at world size 1 over NCCL,
    through JAX's buckets, at configs 1, 3 and 4 (fast) and config 1
    (pipeline).  Each: the one-device engine settled, the mesh engine's
    eager call timed, the eager step against the one-device lists, then
    the step captured and replayed against eager steps at static and 2
    jittered positions (``graph_vs_eager``), replays timed and profiled.
    Then config 1's eager step at ``SMALL_SLACK`` must flag
    ``route_overflow``.  Returns each case's numbers."""
    import torch
    from treensearch_tpu_torch.ops import pairs
    from treensearch_tpu_torch.ops.grid import fresh_state
    from treensearch_tpu_torch.parallel import sharded as sh
    t0 = time.perf_counter()
    dev = pts_t.device
    k1 = pairs.expand_query_tiles
    (fluid, boundary), (p4, r4) = data3, data4
    cases = (("config 1", lambda: make_engine(pts_t, RADIUS), True,
              (k1, pairs.pairs_nbrs_fixed)),
             ("config 3", lambda: config3_engine(fluid, boundary), True,
              (k1, pairs.pairs_nbrs_sets)),
             ("config 4", lambda: config4_engine(p4, r4), True,
              (k1, pairs.pairs_nbrs_variable)),
             ("config 1 pipeline", lambda: make_engine(pts_t, RADIUS), False,
              ()))
    out = {}
    for label, make, fast, path in cases:
        name = f"sharded {label} step graph"
        eng = make()
        call = eng.run if fast else eng.run_scalar
        call()
        call()
        many = make()
        many.distribute(mesh)
        mesh_ms = []
        for _ in range(1 + N_SLOW_RUNS):
            sync(dev)
            t = time.perf_counter()
            many.run() if fast else many.run_scalar()
            sync(dev)
            mesh_ms.append((time.perf_counter() - t) * 1e3)
        del many
        inputs = _step_inputs(eng)
        make_step, sol, tiles = sharded_step_of(eng, mesh, fast)
        total = _step_vs_engine(sol, eng, f"{name}, eager")
        if label == "config 1" and pts_t.shape[0] == N \
                and total != TPU_PAIRS_SEED0:
            raise AssertionError(f"{name}: {total} pairs")
        rows = sol["slab_rows"]
        del sol
        gen = torch.Generator(device=dev).manual_seed(8)
        moved = [(inputs[0] + (torch.rand(inputs[0].shape, generator=gen,
                                          device=dev) * 2 - 1) * JITTER,
                  *inputs[1:]) for _ in range(2)]
        replays = N_SLOW_REPLAYS if not fast else 10
        g = graph_vs_eager(
            name, lambda: (make_step(), fresh_state(dev)),
            tuple(t.clone() for t in inputs), {}, path, moved, _same_sharded,
            always_rebuilds=True, replays=replays)
        prof = replay_profile(g["graph"].replay, name, card,
                              N_SLOW_REPLAYS if not fast
                              else N_PROFILED_REPLAYS, top=8)
        if prof["k1"] != (N_SLOW_REPLAYS if not fast
                          else N_PROFILED_REPLAYS) * (k1 in path):
            raise AssertionError(f"{name}: K1 not once per replay")
        rec = {"ms": g["ms"], "eager_ms": g["eager_ms"],
               "mesh_ms": statistics.median(mesh_ms[1:]),
               "device_ms": prof["device_ms"], "events": prof["events"],
               "idle": prof["idle"], "peak_gb": g["memory"]["peak"] / 1e9,
               "work_gb": g["memory"]["work"] / 1e9,
               "slots": sh.route_slots(eng.get_total_n_points(), 1,
                                       sh.ROUTE_SLACK),
               "local_rows": sum(rows), "pairs": total,
               "tiles_cap": tiles, "launches": g["launches"]}
        print(f"{name} (world size 1, nccl): {rec['ms']:.4f} ms per replay "
              f"beside {rec['eager_ms']:.3f} ms/eager step and "
              f"{rec['mesh_ms']:.3f} ms/eager mesh "
              f"{'run()' if fast else 'run_scalar()'}; "
              f"{rec['device_ms']:.4f} ms of device work in "
              f"{rec['events']:.1f} events per replay, idle share "
              f"{rec['idle']:.3f}; peak device memory {rec['peak_gb']:.3f} "
              f"GB, {rec['work_gb']:.3f} GB of it the step's; S "
              f"{rec['slots']}, tiles_cap {tiles or 'default'}, "
              f"{rec['local_rows']} local rows for "
              f"{eng.get_total_n_points()} points; {total} pairs equal to "
              f"one device's ({card})", flush=True)
        out[label] = rec
        del g, eng
        torch.cuda.empty_cache()
    eng = make_engine(pts_t, RADIUS)
    eng.run()
    _, sol, _ = sharded_step_of(eng, mesh, True, SMALL_SLACK)
    if int(sol["route_overflow"]) != 1:
        raise AssertionError(f"sharded step at route_slack {SMALL_SLACK}: "
                             "no route_overflow")
    slots = sh.route_slots(pts_t.shape[0], 1, SMALL_SLACK)
    print(f"sharded config 1 step at route_slack {SMALL_SLACK}: "
          f"route_overflow 1 (S {slots} for {pts_t.shape[0]} points); "
          "phase 16's steps: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out


N_RANKS = 4            # phase 16: gloo ranks sharing the one card
RANK_TIMEOUT = 300     # seconds a gloo rank may wait in a collective


def _rank_main(rank: int, rdv: str, dev_type: str, sizes: tuple,
               queue) -> None:
    """One of the four gloo ranks of phase 16: configs 1 and 3 through
    the mesh engine (K1 with K2a, then with K2b), rank 0 also on one
    device to compare, then the bucketed step once, eagerly, against the
    mesh engine's lists; puts its figures on ``queue``."""
    import datetime

    import torch
    import torch.distributed as dist
    from treensearch_tpu_torch.ops import pairs
    from treensearch_tpu_torch.ops.grid import fresh_state
    from treensearch_tpu_torch.parallel.sharded import MeshAxis
    torch.set_num_threads(2)
    if dev_type == "cuda":
        torch.cuda.set_device(0)
    dev = torch.device(dev_type, 0) if dev_type == "cuda" \
        else torch.device("cpu")
    dist.init_process_group(
        "gloo", init_method=f"file://{rdv}", rank=rank, world_size=N_RANKS,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT))
    out = {"rank": rank}
    try:
        mesh = one_dim_mesh(dev_type, N_RANKS)
        n1, n_fluid, n_boundary = sizes
        pts = torch.from_numpy(np.random.default_rng(0).uniform(
            0, 1, (n1, 3)).astype(np.float32)).to(dev)
        fluid, boundary = config3_data(dev, n_fluid, n_boundary)
        kernels = pairs_kernels()
        for label, make, kernel in (
                ("config 1", lambda: make_engine(pts, RADIUS),
                 pairs.pairs_nbrs_fixed),
                ("config 3", lambda: config3_engine(fluid, boundary),
                 pairs.pairs_nbrs_sets)):
            eng = make()
            eng.distribute(mesh)
            for k in kernels:
                k.launches = 0
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            times = []
            for _ in range(1 + N_SLOW_RUNS):
                sync(dev)
                t = time.perf_counter()
                eng.run()
                sync(dev)
                times.append((time.perf_counter() - t) * 1e3)
            launches = {k.__name__: k.launches for k in kernels
                        if k.launches}
            if dev.type == "cuda" and min(
                    launches.get(k.__name__, 0)
                    for k in (pairs.expand_query_tiles, kernel)) < 1 + \
                    N_SLOW_RUNS:
                raise AssertionError(f"rank {rank} {label}: launches "
                                     f"{launches}")
            rec = {"launches": launches, "ms": times,
                   "rows": eng._last_stats["slab_rows"],
                   "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9
                   if dev.type == "cuda" else float("nan")}
            if rank == 0:
                one = make()
                one.run()
                rec["pairs"] = _pairs_equal(one, eng, f"gloo {label}")
                del one
            else:
                for i, j in zip(*np.nonzero(eng._active)):
                    eng.get_neighbors(int(i), int(j))
            make_step, _, rec["step_tiles"] = sharded_step_of(eng, mesh)
            step = make_step()
            sync(dev)
            t = time.perf_counter()
            sol, _ = step(fresh_state(dev), *_step_inputs(eng))
            sync(dev)
            rec["step_ms"] = (time.perf_counter() - t) * 1e3
            rec["step_rows"] = sol["slab_rows"]
            rec["step_pairs"] = _step_vs_engine(
                sol, eng, f"gloo {label} rank {rank} bucketed step",
                MeshAxis(mesh).gather_rows)
            out[label] = rec
            del eng, sol
    finally:
        dist.destroy_process_group()
    queue.put(out)


def run_gloo_ranks(dev, n1: int, n_fluid: int, n_boundary: int,
                   card: str) -> list:
    """Phase 16, second half: four gloo ranks spawned on the one card (on
    the CPU in a rehearsal) exchange their tensors where they lie; each
    runs the port's kernels on its slab.  Their times share the card and
    are printed, not judged.  Every process is joined; one that fails or
    hangs fails the phase."""
    import multiprocessing as mp
    import shutil
    import tempfile
    import queue as queue_mod
    build = os.path.join(HERE, "build")
    os.makedirs(build, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="rdv_", dir=build)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, os.path.join(tmp, "rdv"), dev.type,
                               (n1, n_fluid, n_boundary), q))
             for r in range(N_RANKS)]
    results = []
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + RANK_TIMEOUT
        while len(results) < N_RANKS:
            try:
                results.append(q.get(timeout=5))
            except queue_mod.Empty:
                if any(p.exitcode not in (None, 0) for p in procs) \
                        or time.monotonic() > deadline:
                    raise AssertionError(
                        "gloo ranks: a rank failed or hung (exit codes "
                        f"{[p.exitcode for p in procs]})")
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"gloo ranks: exit codes "
                             f"{[p.exitcode for p in procs]}")
    results.sort(key=lambda r: r["rank"])
    for label in ("config 1", "config 3"):
        print(f"gloo {N_RANKS} ranks on one card, {label}: "
              f"{results[0][label]['pairs']} pairs, every query's count "
              "and row set equal to one device's", flush=True)
        for r in results:
            rec = r[label]
            own, left, right = rec["rows"]
            print(f"  rank {r['rank']}: {own} owned + {left + right} halo "
                  f"= {own + left + right} local rows; peak device memory "
                  f"{rec['peak_gb']:.3f} GB; launches {rec['launches']}; "
                  "ms/call on the shared card (not judged): "
                  + " ".join(f"{t:.1f}" for t in rec["ms"]) + f" ({card})",
                  flush=True)
            print(f"  rank {r['rank']} bucketed step: {rec['step_pairs']} "
                  "pairs, every query's count and row set equal to the "
                  "exact-size run()'s, route_overflow 0; local rows "
                  f"{sum(rec['step_rows'])} {rec['step_rows']}, tiles_cap "
                  f"{rec['step_tiles'] or 'default'}; "
                  f"{rec['step_ms']:.1f} ms eager on the shared card (not "
                  f"judged) ({card})", flush=True)
    return results


# ------------------------------------------------ phase 18: config 5
def config5_data(dev) -> list:
    """Fluid, boundary and emitter points, uniform in the unit cube,
    float32, from one ``default_rng(0)`` (drawn in that order)."""
    import torch
    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(np.float32))
            .to(dev) for n in N5]


def config5_engine(sets):
    """BASELINE config 5 as ``bench_10m_cfg5.py`` sets it up: all nine
    searches, cell 1.1 r, neighbor cap 64 (16 against the boundary, 8
    against the emitter), no carry.  The script's ``_tiles_cap`` and
    ``_fat_cap`` are TPU memory settings and are not carried over."""
    from treensearch_tpu_torch import TreeNSearch
    eng = TreeNSearch(device=sets[0].device)
    for p in sets:
        eng.add_point_set(p)
    eng.set_search_radius(R5)
    eng.set_all_searches(True)
    eng.set_cell_size(CELL_F5 * R5)
    eng.set_neighbor_cap(CAPS5[0])
    for j in (1, 2):
        eng.set_neighbor_cap(CAPS5[j], set_j=j)
    eng.set_coherence(False)
    return eng


def _step_ok(sol, eng, label: str) -> None:
    """A step's overflow flags clear and every pair within its cap (a
    step does not regrow)."""
    bad = [k for k in ("error", "dense_overflow", "rows_overflow",
                       "tile_overflow") if int(sol[k])]
    bad += [k for k, p in sol["pairs"].items()
            if int(p["max_count"]) > eng._cap_of(int(k.split("-")[1]))]
    if bad:
        raise AssertionError(f"{label}: the step overflowed: {bad}")


def run_config5_loop(eng, sets, card: str, path: tuple) -> dict:
    """``bench_10m_cfg5.py:131-175``'s loop: ``N5_ITERS`` steps of
    ``make_step_fn()`` with ``make_zsort_step(n_sets=3)`` of the
    positions and three user arrays per set ((n, 3), (n,), (n,) float32
    zeros) before every ``ZSORT_EVERY``-th step, and the checksum of pair
    0-0's ``counts[::1025]``.  Run eagerly, then as two CUDA graphs (the
    z-sort, written back into the positions it read, and the step, each
    from its own pool), replayed at the same cadence from the host: JAX's
    ``lax.cond`` on the iteration needs no host read either way.  The
    replayed loop must equal the eager one (checksum, positions, every
    pair's counts and rows of the last step), and its last step a fresh
    engine's ``run()`` on the final positions."""
    import torch
    from treensearch_tpu_torch.ops.zsort import make_zsort_step
    dev = sets[0].device
    sizes = [int(p.shape[0]) for p in sets]
    offs = np.cumsum([0] + sizes)
    zstep = make_zsort_step(n_sets=len(sets))

    def loop_state():
        points = torch.cat(sets)   # the sets are views into it
        views = [points[offs[i]:offs[i + 1]] for i in range(len(sets))]
        user = [[torch.zeros((n, 3), device=dev), torch.zeros(n, device=dev),
                 torch.zeros(n, device=dev)] for n in sizes]
        return points, views, user

    def zsort_in_place(views, user):
        _, pts2, user2 = zstep(views, user)
        for v, p in zip(views, pts2):
            v.copy_(p)
        for arrs, arrs2 in zip(user, user2):
            for a, b in zip(arrs, arrs2):
                a.copy_(b)

    def checksum(sol, acc):
        acc += sol["pairs"]["0-0"]["counts"][::CHECKSUM_STRIDE].sum(
            dtype=torch.int32)

    def zsort_due(it: int) -> bool:
        return it % ZSORT_EVERY == ZSORT_EVERY - 1

    step, state = eng.make_step_fn()
    points_e, views_e, user_e = loop_state()
    acc_e = torch.zeros((), dtype=torch.int32, device=dev)
    sync(dev)
    t0 = time.perf_counter()
    for it in range(N5_ITERS):
        if zsort_due(it):
            zsort_in_place(views_e, user_e)
        sol_e, state = step(state, points_e)
        checksum(sol_e, acc_e)
    sync(dev)
    eager_ms = (time.perf_counter() - t0) * 1e3 / N5_ITERS
    _step_ok(sol_e, eng, "config 5 eager loop")

    torch.cuda.reset_peak_memory_stats(dev)
    step_g, state_g = eng.make_step_fn()
    points_g, views_g, user_g = loop_state()
    acc_g = torch.zeros((), dtype=torch.int32, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # the z-sort's warm-up, on copies
        zsort_in_place(*loop_state()[1:])
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g_zsort = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g_zsort):
        zsort_in_place(views_g, user_g)
    g_step, sol_g, state_g, launches, memory = capture_step(
        step_g, state_g, (points_g,), {},
        extra=lambda sol: checksum(sol, acc_g))
    _check_graph_launches(launches, "config 5 step graph", path)

    def replay_loop():
        for it in range(N5_ITERS):
            if zsort_due(it):
                g_zsort.replay()
            g_step.replay()

    first_ms = _timed_replays(replay_loop, 1) / N5_ITERS
    # from the graphs' warm-ups on: capture_step resets the peak after the
    # step's warm-up, so its reading before that reset is taken too
    peak = max(memory["warm"], torch.cuda.max_memory_allocated(dev)) / 1e9
    if int(acc_g) != int(acc_e) or not torch.equal(points_g, points_e) \
            or not all(torch.equal(a, b) for us_g, us_e in zip(user_g, user_e)
                       for a, b in zip(us_g, us_e)):
        raise AssertionError(f"config 5 loop: the replayed loop's checksum "
                             f"{int(acc_g)} or positions differ from the "
                             f"eager loop's ({int(acc_e)})")
    _step_ok(sol_g, eng, "config 5 replayed loop")
    _same_pairs(sol_g["pairs"], sol_e["pairs"], "config 5 replayed loop")
    last = {k: p["counts"].clone() for k, p in sol_g["pairs"].items()}
    step_pairs = sum(int(c.sum(dtype=torch.int64)) for c in last.values())
    del sol_e, points_e, views_e, user_e

    fresh = config5_engine([v.clone() for v in views_g])
    fresh.run()
    for k, c in last.items():
        i, j = (int(x) for x in k.split("-"))
        if not np.array_equal(fresh.get_counts(i, j), c.cpu().numpy()):
            raise AssertionError(f"config 5 loop: pair {k}'s counts of the "
                                 "last replay differ from a fresh run()")
    del fresh
    print(f"config 5 loop: {N5_ITERS} replays of the step graph (K1 and "
          f"K2b once each), the z-sort graph before steps "
          f"{[it + 1 for it in range(N5_ITERS) if zsort_due(it)]}, equal to "
          f"the eager loop (checksum {int(acc_g)}, "
          f"positions, every pair's counts and rows); the last step's "
          f"{step_pairs} pairs over 9 pairs equal a fresh run() on the "
          "final positions", flush=True)

    loops = [_timed_replays(replay_loop, 1) / N5_ITERS for _ in range(3)]
    ms = statistics.median(loops)
    zsort_ms = median_ms(g_zsort.replay, dev, reps=5)
    prof = replay_profile(g_step.replay, "config 5 step graph", card,
                          replays=3, top=6)
    print(f"config 5 loop: {ms:.3f} ms/step replayed (loops of "
          f"{N5_ITERS}: {', '.join(f'{t:.3f}' for t in loops)}; the first "
          f"{first_ms:.3f}), eager {eager_ms:.3f} ms/step, "
          f"{step_pairs / (ms / 1e3):.4g} pairs/s over 9 pairs; z-sort "
          f"replay (3 sets, positions and 3 arrays each) {zsort_ms:.3f} ms; "
          f"peak {peak:.3f} GB from the warm-ups on (before the step's "
          f"capture {memory['warm'] / 1e9:.3f} GB, during it "
          f"{memory['peak'] / 1e9:.3f} GB, its pool "
          f"{memory['work'] / 1e9:.3f} GB) ({card})",
          flush=True)
    return {"ms": ms, "eager_ms": eager_ms, "zsort_ms": zsort_ms,
            "pairs": step_pairs, "peak_gb": peak, "profile": prof,
            "launches": launches}


def run_config5(sets, card: str) -> dict:
    """Phase 18, BASELINE config 5 at full size: (a) a settling ``run()``
    and ``N5_RUNS`` jittered ones (K1 and K2b once in each), profiled;
    (b) all nine pairs against the native oracle, every point's count and
    neighbor set; (c) K2b against its plain version on the settled
    structures (the plain version run once); (d) the steady-state loop
    (``run_config5_loop``); (e) the fluid's cap set to 32, a ``run()``
    that regrows to pair 0-0's total."""
    import torch
    from treensearch_tpu_torch.ops import pairs
    t_phase = time.perf_counter()
    dev = sets[0].device
    path = (pairs.expand_query_tiles, pairs.pairs_nbrs_sets)
    eng = config5_engine(sets)
    state = list(sets)

    def jitter(noise):
        for i, p in enumerate(state):
            state[i] = p + noise(tuple(p.shape))
            eng.resize_point_set(i, state[i])

    torch.cuda.reset_peak_memory_stats(dev)
    out = drive(eng, "config 5", path, jitter, card, once=True,
                runs=N5_RUNS)
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["profile"] = replay_profile(eng.run, "config 5 run()", card,
                                    replays=1, top=6)
    print(f"config 5 run(): {out['ms']:.3f} ms/call, peak {out['peak_gb']:.3f}"
          f" GB; settled caps {[eng._cap_of(j) for j in range(3)]}, tiles "
          f"{eng._tiles_cap}, dense {eng._dense_cap} ({card})", flush=True)

    pts = [p.cpu().numpy() for p in state]
    totals, oracle_s = {}, {}
    for i in range(3):
        for j in range(3):
            counts, rows = eng.get_neighbors(i, j)
            totals[f"{i}-{j}"], oracle_s[f"{i}-{j}"] = exact_vs_native(
                counts, rows, pts[i], pts[j], R5, i == j,
                f"config 5 pair {i}-{j}")
            del counts, rows
    print(f"config 5: {sum(totals.values())} pairs over 9 pairs, equal to "
          f"the native oracle for every point ({totals}); oracle "
          f"{sum(oracle_s.values()):.1f} s on the host "
          f"({', '.join(f'{k} {v:.1f}' for k, v in oracle_s.items())})",
          flush=True)
    eng._solution = None

    k2b = check_path_kernel(eng, time_plain=False)
    eng._solution = None
    out["k2b"] = k2b
    out["loop"] = run_config5_loop(eng, state, card, path)

    eng.set_neighbor_cap(REGROW_CAP, set_j=0)
    before = pairs.pairs_nbrs_sets.launches
    sync(dev)
    t0 = time.perf_counter()
    eng.run()
    sync(dev)
    seconds = time.perf_counter() - t0
    attempts = pairs.pairs_nbrs_sets.launches - before
    got = int(eng.get_counts(0, 0).sum(dtype=np.int64))
    if got != totals["0-0"] or eng._cap_of(0) <= REGROW_CAP or attempts < 2:
        raise AssertionError(f"config 5 regrow: {attempts} attempts, cap "
                             f"{eng._cap_of(0)}, pair 0-0 {got} pairs "
                             f"against {totals['0-0']}")
    print(f"config 5 regrow: the fluid's cap at {REGROW_CAP} grew to "
          f"{eng._cap_of(0)} in {attempts} attempts, {seconds:.2f} s; pair "
          f"0-0 {got} pairs, as settled", flush=True)
    print(f"phase 18: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


def sharded_launches(sharded: dict) -> dict:
    """Phase 16's launches by kernel id: the world-size-1 paths' and every
    gloo rank's."""
    ids = {"expand_query_tiles": "K1", "pairs_nbrs_fixed": "K2a",
           "pairs_nbrs_sets": "K2b", "pairs_nbrs_variable": "K2c",
           "pairs_reduce": "K3"}
    out = {k: 0 for k in ids.values()}
    runs = [r["mesh"]["launches"] for k, r in sharded.items()
            if k not in ("gloo", "steps")]
    runs += [r[c]["launches"] for r in sharded["gloo"]
             for c in ("config 1", "config 3")]
    for launches in runs:
        for name, count in launches.items():
            if name in ids:
                out[ids[name]] += count
    return out


def build_all() -> None:
    """Phase 2: ``csrc/pairs.cu``, ``csrc/cond.cu`` and K3 for each of
    CALLBACKS, one nvcc each, all started together."""
    from functools import partial

    from treensearch_tpu_torch.ops import cond, pairs
    from treensearch_tpu_torch.ops import reduce as red
    jobs = [("pairs.cu", pairs.load_library),
            ("cond.cu", cond.cond_library)] + [
        (f"reduce.cu + {fn.__name__}",
         partial(red.reduce_library, red.ReduceSpec(fn, n_out), variable))
        for fn, n_out, variable in CALLBACKS]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as ex:
        futures = [(name, ex.submit(job)) for name, job in jobs]
        libs = [(name, f.result()) for name, f in futures]
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(libs)} "
          f"libraries", flush=True)
    print("nvcc: " + " ".join(libs[0][1].command), flush=True)
    for name, lib in libs:
        print(f"  {name}: {lib.seconds:.2f} s nvcc -> "
              f"{os.path.relpath(lib.path, HERE)}", flush=True)
        for kernel, regs, smem, stores, loads in kernel_resources(lib.log):
            name = f"{KERNEL_IDS[kernel]} {kernel}" \
                if kernel in KERNEL_IDS else kernel
            print(f"    {name}: {regs} registers, {smem} B static shared "
                  f"memory, spills {stores} B stored / {loads} B loaded",
                  flush=True)


# PERF.md's names of the kernels as kernel_resources names them
KERNEL_IDS = {"expand_query_tiles_kernel": "K1",
              "expand_records_kernel": "K1r",
              "pairs_nbrs_kernel<false, false, true>": "K2a",
              "pairs_nbrs_kernel<false, false, false>": "K2b",
              "pairs_nbrs_kernel<true, false, false>": "K2c",
              "pairs_nbrs_kernel<true, true, false>": "K2c",
              "pairs_reduce_kernel<false>": "K3",
              "pairs_reduce_kernel<true>": "K3",
              "pairs_mask_kernel<false, false>": "K4",
              "pairs_mask_kernel<true, false>": "K4",
              "pairs_mask_kernel<true, true>": "K4",
              "pairs_nbrs_from_bits_kernel<true>": "K5",
              "pairs_nbrs_from_bits_kernel<false>": "K5"}


def kernel_resources(log: str) -> list:
    """(kernel, registers, static shared bytes, spill stores, spill loads)
    of each entry function in an ``nvcc -Xptxas -v`` log, the kernel named
    from its mangled name (template flags as true/false)."""
    out, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            mangled = m.group(1)
            base = re.search(r"\d+([a-z_]+_kernel)", mangled)
            flags = re.findall(r"Lb([01])E", mangled)
            name = (base.group(1) if base else mangled) + (
                "<" + ", ".join("true" if f == "1" else "false"
                                for f in flags) + ">" if flags else "")
            spills = (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append((name, int(m.group(1)),
                        int(smem.group(1)) if smem else 0, *spills))
            name = None
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from treensearch_tpu_torch.ops import pairs
    from treensearch_tpu_torch.ops import reduce as red

    card = card_line()                                      # phase 1
    print(f"card: {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}",
          flush=True)
    build_all()                                             # phase 2

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, N).astype(np.float32)
    pts_t = torch.from_numpy(pts).to(dev)
    kernels = check_kernels(pts_t, RADIUS)                  # phase 3
    check_small(dev)
    main1 = run_main_path(pts_t, RADIUS, card)
    k2b, main3 = run_config3(*config3_data(dev), card)      # phase 4
    k2c, main4 = run_config4(*config4_data(dev), card)      # phase 5
    check_small_variable(dev)                               # phase 6
    k3, k3_4, main7, main7b = run_reduce_path(              # phase 7
        pts_t, torch.from_numpy(mass).to(dev), card)
    k4, main8 = run_mask_path(pts_t, card)                  # phase 8
    check_small_contracts(dev)                              # phase 9
    k5, main10 = run_split_path(pts_t, card, config3_data(dev),  # 10
                                config4_data(dev))
    steps = run_carry_path(pts_t, torch.from_numpy(mass).to(dev),  # 11
                           card)
    k1r, main12 = run_tile_path(pts_t, card)                # phase 12
    main13 = run_bodies(*config3_data(dev), card)           # phase 13
    main14 = run_pipeline_path(pts_t, card, config4_data(dev))  # 14
    zsort = run_zsort_path(pts_t, card, config3_data(dev))  # phase 15
    sharded = run_sharded_path(pts_t, torch.from_numpy(mass).to(dev),  # 16
                               card, config3_data(dev), config4_data(dev))
    graphs = run_step_graphs(pts_t, torch.from_numpy(mass).to(dev),  # 17
                             card, config3_data(dev), config4_data(dev),
                             steps, zsort["ms"][ZSORT_STEP_TIMING])
    main18 = run_config5(config5_data(dev), card)           # phase 18
    kernels += [k2b, k2c, k3, k4, k5, k1r]
    launches = {"expand_query_tiles": main1, "pairs_nbrs_fixed": main1,
                "pairs_nbrs_sets": main3, "pairs_nbrs_variable": main4,
                "pairs_reduce": main7, "pairs_mask": main8,
                "pairs_nbrs_from_bits": main10, "expand_records": main12}
    print(f"launches on the reduce paths: n_out=1 {main7['launches']}, "
          f"n_out=4 {main7b['launches']}", flush=True)
    print(f"config 1 run(): split staging {main10['ms']:.3f} ms/call, fused "
          f"{main1['ms']:.3f} ms/call; make_step_fn(reuse=True) ms/step: "
          + ", ".join(f"{k} {v['ms']:.3f}" for k, v in steps.items())
          + f" ({card})", flush=True)
    print(f"fallbacks ms/call: config 1 tile path {main12['ms']:.3f}, "
          f"{N_BODIES + 1} candidate sets {main13['ms']:.3f}, run_scalar "
          f"config 1 {main14['config 1']['ms']:.3f}, run_scalar config 4 "
          f"{main14['config 4']['ms']:.3f} ({card})", flush=True)
    print("sharded launches: " + json.dumps(sharded_launches(sharded)),
          flush=True)
    print("config 1 step graph ms per replay: " + ", ".join(
        f"{k} {v['ms']:.4f} (eager {v['eager_ms']:.3f} ms/step)"
        for k, v in graphs.items() if "eager_ms" in v)
        + "; " + ", ".join(f"{k} {v['ms']:.4f}" for k, v in graphs.items()
                           if "eager_ms" not in v) + f" ({card})", flush=True)
    print(json.dumps({"pairs_reduce (density4_fn, n_out 4)": {
        k: k3_4[k] for k in ("launches", "max_abs_err", "ms", "plain_ms",
                             "bound_ms", "bound_by", "library_ms")}}))
    sources = {"pairs_reduce": red.TEMPLATE}
    out = []
    for rec in kernels:
        name = rec["name"]
        out.append({
            "name": name, "route": "cuda",
            "source": os.path.relpath(sources.get(name, pairs.SOURCE), HERE),
            "replaces": "treensearch_tpu/ops/pallas_pairs.py:"
                        f"{SOURCE_LINES[name]}",
            "launches": launches[name]["launches"][name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
    k2b5 = main18["k2b"]   # K2b again at config 5, three blocks
    next(r for r in out if r["name"] == "pairs_nbrs_sets")["config 5"] = {
        "launches": main18["launches"]["pairs_nbrs_sets"],
        **{k: k2b5[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "tests", "tile_tests")}}
    print(f"config 5: run() {main18['ms']:.3f} ms/call; replayed loop "
          f"{main18['loop']['ms']:.3f} ms/step (eager "
          f"{main18['loop']['eager_ms']:.3f}), z-sort replay "
          f"{main18['loop']['zsort_ms']:.3f} ms; pairs_nbrs_sets "
          f"{k2b5['ms']:.4f} ms, bound {k2b5['bound_ms']:.4f} ms ({card})",
          flush=True)
    print(card)
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
