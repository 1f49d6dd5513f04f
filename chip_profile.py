#!/usr/bin/env python3
"""Where the time of ``TreeNSearch.run()`` goes on the card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_profile.py

For each configuration of ``chip_smoke.py`` (config 1: 1M uniform, r =
0.02, cell 1.15 r; config 3: fluid + boundary; config 4: variable radii,
symmetric), for ``run_reduce`` (the poly6 density, n_out = 1, with
masses as payload), ``run_mask`` and ``run()`` with split staging (K4
then K5) at config 1, each call with every set's points moved by up to
1e-4 from where they started (``chip_smoke.py``'s jitter, made
beforehand), so the temporal-coherence carry rebuilds in every call as
in ``chip_smoke.py``'s paths; and for config 1's ``run()`` and
``make_step_fn(reuse=True)`` step at static positions (the carry reused,
no prep), and for that step captured as one CUDA graph
(``chip_smoke.py``'s ``capture_step``) and replayed at static positions
and with positions moved by up to 1e-4 copied into its input before each
replay (every replay rebuilds); and for the fallbacks, config 1's ``run()`` on the tile path
(``set_use_pallas(False)``), ten candidate sets (config 3's boundary as
9 rigid bodies) and config 1's ``run_scalar()``, each moving; and for
z-sort at config 1, ``prepare_zsort`` on the cell path (after a
``run()``) and on the per-point path (no run) and ``apply_zsort_batch``
of ``chip_smoke.py``'s eight arrays; and for config 1's ``run()`` under
a one-rank mesh over NCCL (the sharded search of ``parallel/sharded.py``
at world size 1), moving; after two settling calls, it prints:

- the call's host time, synchronised, median over 10 calls;
- ``torch.profiler``'s device time over 5 calls, by kernel name and per
  call, the device's busy time in that window and its idle share;
- the pairs kernel's work (the tile path's too): live tiles and distance
  tests (128 lanes times the windowed candidates of each live tile),
  from the path's descriptors; none for the pipeline;
- the peak device memory.

Every time is the engine's own entry point; nothing re-sequences its
steps.
It exits non-zero without CUDA.
"""

from __future__ import annotations

import collections
import os
import statistics
import sys
import time

import numpy as np

N = 1_000_000
RADIUS = 0.02
N_TIMED = 10
N_PROFILED = 5
TOP = 15
K2A = "pairs_nbrs_kernel<false, false, true>"   # its name in the trace
JITTER = 1e-4


def busy_ms(events) -> tuple[float, float]:
    """(busy ms, window ms) of the union of device event intervals."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, (cs, ce) = 0.0, iv[0]
    for s, e in iv[1:]:
        if s > ce:
            busy += ce - cs
            cs, ce = s, e
        else:
            ce = max(ce, e)
    busy += ce - cs
    return busy / 1e3, (iv[-1][1] - iv[0][0]) / 1e3


def moved_sets(eng, count: int):
    """``count`` copies of every set's points, each moved by up to JITTER
    from the start, made on the card beforehand; returns a function that
    hands the next copy to the engine (no device work)."""
    import torch
    sets = [(s.points, s.radii) for s in eng._sets]
    gen = torch.Generator(device=sets[0][0].device).manual_seed(3)
    pool = iter([[p + (torch.rand(p.shape, generator=gen, device=p.device)
                       * 2 - 1) * JITTER for p, _ in sets]
                 for _ in range(count)])

    def move():
        for i, (p, (_, r)) in enumerate(zip(next(pool), sets)):
            eng.resize_point_set(i, p, r)

    return move


def profile(eng, label: str, card: str, call=None,
            kernel: str | None = None, moving: bool = True) -> None:
    """Host time, device time by kernel, idle share and peak memory of
    the engine's own ``call`` (``run()`` by default), after two settling
    calls; with ``moving`` each call first moves the points
    (``moved_sets``).  ``kernel`` names the pairs kernel of the path (by
    default the one ``run()`` takes; an empty name: no window work)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from chip_smoke import settled_inputs, window_tests
    from treensearch_tpu_torch.ops import fastpath as fp
    from treensearch_tpu_torch.ops.pairs import FAT_COL, TILE

    entry = call or eng.run
    if moving:
        move = moved_sets(eng, 2 + N_TIMED + N_PROFILED)

        def call():
            move()
            return entry()
    else:
        call = entry
    call()
    call()
    print(f"== {label}: {eng.get_total_n_points()} points; caps: "
          f"{eng._knobs()}, nbr_cap {eng._nbr_cap} {eng._nbr_caps}",
          flush=True)
    times = []
    for _ in range(N_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"host ms per call, median of {N_TIMED}: "
          f"{statistics.median(times):.4f}"
          f" (min {min(times):.4f}) ({card})", flush=True)

    torch.cuda.reset_peak_memory_stats()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(N_PROFILED):
            call()
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in dev_events:
        by_name[e.name][0] += (e.time_range.end - e.time_range.start) / 1e3
        by_name[e.name][1] += 1
    busy, window = busy_ms(dev_events)
    print(f"device ms per run by kernel (top {TOP} of {len(by_name)}):")
    for name, (ms, k) in sorted(by_name.items(), key=lambda kv: -kv[1][0]
                                )[:TOP]:
        print(f"  {ms / N_PROFILED:9.4f} ms  {k // N_PROFILED:4d}x  "
              f"{name[:90]}")
    # K2a is pairs_nbrs_kernel's one-set instance, K2b/K2c the others
    ours = {k: sum(ms for name, (ms, _) in by_name.items()
                   if k in name and (k != "pairs_nbrs_kernel<"
                                     or K2A not in name))
            / N_PROFILED
            for k in ("expand_query_tiles_kernel", K2A,
                      "pairs_nbrs_kernel<", "pairs_reduce_kernel",
                      "pairs_mask_kernel", "pairs_nbrs_from_bits_kernel",
                      "expand_records_kernel")}
    print(f"per call: K1 {ours['expand_query_tiles_kernel']:.4f} ms, K1r "
          f"{ours['expand_records_kernel']:.4f} ms, K2a "
          f"{ours[K2A]:.4f} ms, K2b/K2c "
          f"{ours['pairs_nbrs_kernel<']:.4f} ms, K3 "
          f"{ours['pairs_reduce_kernel']:.4f} ms, K4 "
          f"{ours['pairs_mask_kernel']:.4f} ms, K5 "
          f"{ours['pairs_nbrs_from_bits_kernel']:.4f} ms, all device work "
          f"{busy / N_PROFILED:.4f} ms, {len(dev_events) / N_PROFILED:.0f} "
          f"device events")
    print(f"{N_PROFILED} runs: device busy {busy:.3f} ms in a {window:.3f} "
          f"ms window, idle share {1 - busy / window:.3f} ({card})")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f}"
          f" GB")

    if kernel == "":
        return
    _, a = settled_inputs(eng)
    live = int((a.desc[:a.tiles_cap, FAT_COL] != 2).sum())
    tests = window_tests(a)
    print(f"{kernel or fp.pairs_kernel(a).__name__} work: {live} live "
          f"tiles of "
          f"{a.tiles_cap}, {tests / TILE / max(live, 1):.1f} candidates per "
          f"tile, {tests} distance tests per run", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.distributed as dist

    from chip_smoke import (N_BODIES, bodies_engine, card_line,
                            config3_data, config3_engine, config4_data,
                            config4_engine, density_fn, free_port,
                            make_engine, one_dim_mesh, zsort_arrays)

    card = card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)   # chip_smoke.py's points and masses
    pts = torch.from_numpy(rng.uniform(0, 1, (N, 3))
                           .astype(np.float32)).to(dev)
    mass = torch.from_numpy(rng.uniform(0.5, 1.5, N)
                            .astype(np.float32)).to(dev)
    profile(make_engine(pts, RADIUS), "config 1", card)
    profile(config3_engine(*config3_data(dev)), "config 3", card)
    profile(config4_engine(*config4_data(dev)), "config 4", card)
    profile(make_engine(pts, RADIUS), "config 1 run(), static positions",
            card, moving=False)
    red = make_engine(pts, RADIUS)
    profile(red, "config 1 run_reduce (density, n_out 1)", card,
            call=lambda: red.run_reduce(density_fn, 1, payload=[mass]),
            kernel="pairs_reduce")
    msk = make_engine(pts, RADIUS)
    profile(msk, "config 1 run_mask", card, call=msk.run_mask,
            kernel="pairs_mask")
    split = make_engine(pts, RADIUS)
    split.set_split_stage(True)
    profile(split, "config 1 run() split staging", card,
            kernel="pairs_mask + pairs_nbrs_from_bits")
    eng = make_engine(pts, RADIUS)
    eng.run()
    eng.run()   # settle the caps the step keeps
    step, state = eng.make_step_fn(reuse=True)
    carried = {"state": state}

    def static_step():
        sol, carried["state"] = step(carried["state"], pts)
        return sol

    profile(eng, "config 1 make_step_fn(reuse=True), static positions",
            card, call=static_step, moving=False)
    del eng, step, state, carried
    # the same step captured as one CUDA graph (chip_smoke.py phase 17),
    # replayed at static positions, then with jittered positions copied
    # into its input before each replay (every replay rebuilds)
    from chip_smoke import capture_step
    eng = make_engine(pts, RADIUS)
    eng.run()
    eng.run()
    step, state = eng.make_step_fn(reuse=True)
    static = pts.clone()
    graph, _, state, _ = capture_step(step, state, (static,), {})
    profile(eng, "config 1 step graph replay, static positions", card,
            call=graph.replay, kernel="", moving=False)
    gen = torch.Generator(device=dev).manual_seed(3)
    pool = iter([pts + (torch.rand(pts.shape, generator=gen, device=dev)
                        * 2 - 1) * JITTER
                 for _ in range(2 + N_TIMED + N_PROFILED)])

    def jittered_replay():
        static.copy_(next(pool))
        graph.replay()

    profile(eng, "config 1 step graph replay, jittered", card,
            call=jittered_replay, kernel="", moving=False)
    del eng, step, state, graph, pool, static
    tile = make_engine(pts, RADIUS)
    tile.set_use_pallas(False)
    profile(tile, "config 1 run(), tile path", card, kernel="tile search")
    del tile
    fluid, boundary = config3_data(dev)
    profile(bodies_engine(fluid, torch.tensor_split(boundary, N_BODIES)),
            f"{N_BODIES + 1} candidate sets, tile path", card,
            kernel="tile search")
    scalar = make_engine(pts, RADIUS)
    profile(scalar, "config 1 run_scalar()", card, call=scalar.run_scalar,
            kernel="")
    del scalar
    cell = make_engine(pts, RADIUS)
    cell.run()
    profile(cell, "config 1 prepare_zsort(), cell path", card,
            call=cell.prepare_zsort, kernel="", moving=False)
    point = make_engine(pts, RADIUS)
    profile(point, "config 1 prepare_zsort(), per-point path", card,
            call=point.prepare_zsort, kernel="", moving=False)
    arrays, strides = zsort_arrays(pts)
    profile(cell, f"config 1 apply_zsort_batch ({len(arrays)} arrays)", card,
            call=lambda: cell.apply_zsort_batch(0, arrays, strides),
            kernel="", moving=False)
    del cell, point, arrays
    dist.init_process_group("nccl",
                            init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    try:
        sharded = make_engine(pts, RADIUS)
        sharded.distribute(one_dim_mesh("cuda", 1))
        profile(sharded, "config 1 run() under a one-rank mesh (NCCL)", card,
                kernel="")
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
