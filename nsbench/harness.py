"""One run of one cell: set-up, the measured window or the traced
stretch, the check against the reference, and the result line.

A step of the simulation loop is, in order:

1. ``move``: the benchmark's stand-in for the solver's advection,
   ``x <- (x + v) mod 1`` with each point's own velocity, when the mix
   moves points;
2. ``zsort``: the program's ``make_zsort_step`` over every set's
   positions and user arrays, written back in place, when due;
3. ``step``: one replay of the program's captured ``make_step_fn`` step
   on the positions;
4. ``tally``: the benchmark's counters, summed on the device: steps whose
   overflow flags are set or whose pairs passed their row width, and
   steps that rebuilt the carry.

On the card each is one CUDA graph, replayed with no host read; the
host runs at most ``AHEAD`` steps ahead of the device.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import tempfile
import time

import torch

from . import judge, trace
from .capture import Captured
from .cells import active_pairs
from .generate import Inputs

AHEAD = 3            # steps the host may enqueue ahead of the device
SETTLE_RUNS = 2      # run() calls that settle the caps before the step
FLAGS = ("error", "dense_overflow", "rows_overflow", "tile_overflow",
         "mask_overflow", "cand_max")
PORT_KERNELS = ("expand_query_tiles_kernel", "expand_records_kernel",
                "pairs_nbrs_kernel", "pairs_mask_kernel",
                "pairs_nbrs_from_bits_kernel", "pairs_reduce_kernel",
                "set_if_kernel")
PAIRS_KERNELS = ("pairs_nbrs_kernel", "pairs_mask_kernel",
                 "pairs_nbrs_from_bits_kernel", "pairs_reduce_kernel")
BASELINE_PAIRS_PER_S = 1.03e8   # the C++ reference, one AVX2 core, 1M
FORBIDDEN = {"jax", "jaxlib", "flax", "treensearch_tpu"}


def make_engine(config: dict, sets: list):
    """``TreeNSearch`` on the sets' device, set up as the configuration
    states."""
    from treensearch_tpu_torch import TreeNSearch
    eng = TreeNSearch(device=sets[0].device)
    for p in sets:
        eng.add_point_set(p)
    eng.set_search_radius(config["radius"])
    eng.set_cell_size(config["cell_factor"] * config["radius"])
    for i, j in active_pairs(config):
        eng.set_active_search(i, j, True)
    caps = config.get("neighbor_caps") or []
    if caps:
        eng.set_neighbor_cap(caps[0])
    for j, cap in enumerate(caps[1:], 1):
        eng.set_neighbor_cap(cap, set_j=j)
    eng.set_coherence(bool(config["coherence"]))
    return eng


class Loop:
    """The captured pieces of one simulation step and their counters."""

    def __init__(self, cell, inputs: Inputs, device):
        from treensearch_tpu_torch.ops.zsort import make_zsort_step
        self.device = device
        self.inputs = inputs
        traffic = cell.traffic
        self.every = int(traffic["zsort"]["every"]) if traffic.get("zsort") \
            else 0
        self.k = 0              # steps run, warm-ups included
        self.moves = 0          # moves run
        self.zsort_moves = None  # moves before the last z-sort
        self.zsorts = 0
        sets = inputs.set_views(inputs.points)
        eng = make_engine(cell.config, sets)
        reduce = traffic.get("reduce")
        kwargs = dict(traffic.get("step", {}))
        if reduce:
            payload = inputs.set_views(inputs.payload)
            for _ in range(SETTLE_RUNS):
                eng.run_reduce(cell.callback, reduce["n_out"],
                               payload=payload)
            kwargs["reduce"] = (cell.callback, reduce["n_out"])
        else:
            for _ in range(SETTLE_RUNS):
                eng.run()
        step, state = eng.make_step_fn(**kwargs)
        self.engine = eng
        pts, pay = inputs.points, inputs.payload

        def search():
            if pay is None:
                return step(state, pts)[0]
            return step(state, pts, payload=pay)[0]

        self.search = Captured(search, device)
        if self.search.out is None:      # eager: one call gives the shape
            self.search.replay()
        sol = self.search.out
        self.flag_keys = [k for k in FLAGS if k in sol]
        self.widths = {p: int(v["nbrs_tiles"].shape[1])
                       for p, v in sol.get("pairs", {}).items()
                       if "nbrs_tiles" in v}
        self.rebuilds = "rebuilt" in sol
        self.failed = torch.zeros((), dtype=torch.int64, device=device)
        self.rebuilt = torch.zeros((), dtype=torch.int64, device=device)
        limits = torch.tensor([0] * len(self.flag_keys)
                              + list(self.widths.values()),
                              dtype=torch.int64, device=device)

        def tally():
            s = self.search.out
            vals = [s[k] for k in self.flag_keys] + \
                [s["pairs"][p]["max_count"] for p in self.widths]
            bad = (torch.stack(vals).to(torch.int64) > limits).any()
            self.failed.add_(bad.to(torch.int64))
            if self.rebuilds:
                self.rebuilt.add_(s["rebuilt"].to(torch.int64))

        self.tally = Captured(tally, device, warm_calls=1)
        self.reset_counters()

        self.move = None
        if inputs.velocity is not None:
            vel = inputs.velocity

            def move(p=pts, v=vel):
                torch.remainder(p + v, 1.0, out=p)

            self.move = Captured(move, device, warm=lambda: move(
                pts.clone(), vel.clone()), warm_calls=1)
        self.zsort = None
        if self.every:
            zstep = make_zsort_step(n_sets=len(inputs.sizes))

            def zsort(flat_pts=pts, flat_user=inputs.user):
                views = inputs.set_views(flat_pts)
                user = [[inputs.of_set(u, i) for u in flat_user]
                        for i in range(len(inputs.sizes))]
                _, pts2, user2 = zstep(views, user)
                for v, p in zip(views, pts2):
                    v.copy_(p)
                for arrs, arrs2 in zip(user, user2):
                    for a, b in zip(arrs, arrs2):
                        a.copy_(b)

            self.zsort = Captured(zsort, device, warm=lambda: zsort(
                pts.clone(), [u.clone() for u in inputs.user]),
                warm_calls=1)

    def reset_counters(self) -> None:
        self.failed.zero_()
        self.rebuilt.zero_()

    def zsort_due(self) -> bool:
        return bool(self.every) and self.k % self.every == self.every - 1

    def run_step(self, spans: bool = False) -> None:
        span = torch.profiler.record_function if spans else \
            (lambda name: contextlib.nullcontext())
        if self.move is not None:
            with span("move"):
                self.move.replay()
            self.moves += 1
        if self.zsort_due():
            with span("zsort"):
                self.zsort.replay()
            self.zsort_moves = self.moves
            self.zsorts += 1
        with span("step"):
            self.search.replay()
        with span("tally"):
            self.tally.replay()
        self.k += 1

    def free(self) -> None:
        del self.search, self.tally, self.move, self.zsort, self.engine
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def window(loop: Loop, seconds: float) -> dict:
    """Steps for ``seconds``, and at least one whole cycle of the mix (a
    z-sort's cadence): the steps run, the wall time
    with the device synchronised at both ends, and each step's time from
    events recorded on the stream after it."""
    cuda = loop.device.type == "cuda"
    intervals = []
    if cuda:
        ring = [torch.cuda.Event(enable_timing=True)
                for _ in range(AHEAD + 2)]
        torch.cuda.synchronize()
        ring[-1].record()
    t0 = last = time.perf_counter()
    steps, host = 0, 0.0
    while True:
        if cuda and steps >= AHEAD:
            done = ring[(steps - AHEAD) % (AHEAD + 1)]
            done.synchronize()
            before = ring[-1] if steps == AHEAD else \
                ring[(steps - AHEAD - 1) % (AHEAD + 1)]
            intervals.append(before.elapsed_time(done))
        t_host = time.perf_counter()
        loop.run_step()
        host += time.perf_counter() - t_host
        if cuda:
            ring[steps % (AHEAD + 1)].record()
        else:
            now = time.perf_counter()
            intervals.append((now - last) * 1e3)
            last = now
        steps += 1
        if steps >= max(loop.every, 1) and \
                time.perf_counter() - t0 >= seconds:
            break
    if cuda:
        torch.cuda.synchronize()
        for k in range(max(steps - AHEAD, 0), steps):
            before = ring[-1] if k == 0 else ring[(k - 1) % (AHEAD + 1)]
            intervals.append(before.elapsed_time(ring[k % (AHEAD + 1)]))
    wall = time.perf_counter() - t0
    return {"steps": steps, "seconds": wall, "intervals": intervals,
            "host_ms": host * 1e3 / steps}


def p95(values: list) -> float:
    """The 95th percentile by the nearest rank."""
    ordered = sorted(values)
    return ordered[max(math.ceil(0.95 * len(ordered)) - 1, 0)]


def traced(loop: Loop, steps: int) -> dict:
    """``steps`` steps under ``torch.profiler``, reduced to the record the
    readers take."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    loop.reset_counters()
    zsorts = loop.zsorts
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            loop.run_step(spans=True)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            record = trace.reduce_profile(json.load(f))
    record.update(steps=steps, zsorts=loop.zsorts - zsorts,
                  port_kernels=PORT_KERNELS, pairs_kernels=PAIRS_KERNELS)
    return record


def card_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"
    return out[0] if out else "nvidia-smi printed nothing"


def run_cell(cell, seed: int, seconds: float, trace_on: bool, device,
             t0: float, log=print) -> dict:
    """One run; returns the result line's object."""
    inputs = Inputs(cell.config, cell.traffic, seed, device)
    start = inputs.snapshot()
    loop = Loop(cell, inputs, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    program_s = time.perf_counter() - t0
    # a process's first seconds of steps run up to 5% slower on the card
    # (PERF.md section 5), so the loop runs that long before it is measured
    window(loop, float(cell.traffic.get("warm_seconds", 0)))
    if device.type == "cuda":
        torch.cuda.synchronize()
    loop.reset_counters()
    setup_s = time.perf_counter() - t0
    log(f"set-up: {program_s:.6f} s to the captured loop (imports, CUDA, "
        f"inputs, engine, settling runs, captures), then "
        f"{setup_s - program_s:.6f} s of warm-up steps")

    if trace_on:
        record = traced(loop, int(cell.traffic["trace_steps"]))
        steps = record["steps"]
    else:
        win = window(loop, seconds)
        steps = win["steps"]
    failed = int(loop.failed)
    rebuilt = int(loop.rebuilt) if loop.rebuilds else None
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    outputs = judge.program_outputs(loop)
    moves, zsort_moves = loop.moves, loop.zsort_moves
    loop.free()
    del loop

    verdict = judge.judge(cell, inputs, start, outputs, moves, zsort_moves)
    limit = card_limit() if device.type == "cuda" else "cpu"
    pairs = verdict["ref_pairs"]
    result = {"correct": verdict["correct"], "attempted": steps,
              "failed": failed}
    if trace_on:
        record.update(counters={"rebuilt": rebuilt, "failed": failed},
                      least=judge.least_time(cell, verdict),
                      program_setup_s=program_s)
        least = record["least"]
        log(f"least time per step: {least['tests']} distance tests, "
            f"{least['hits']} neighbor pairs, {least['ops']} operations, "
            f"{least['bytes']} bytes, {least['least_ms']:.6f} ms, bound by "
            f"{least['bound_by']} (peaks of the H100 SXM at 700 W; this "
            f"card: {limit})")
        log(f"traced {steps} steps ({record['zsorts']} z-sorts): device ms "
            f"by span {record['span_ms']}, {record['unlinked']} device "
            "operations charged to no span")
        metrics = {}
        for m in cell.per_layer():
            value = cell.reader(m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
    else:
        step_ms = win["seconds"] * 1e3 / steps
        ordered = sorted(win["intervals"])
        log(f"window: step intervals median {ordered[len(ordered) // 2]:.6f}"
            f" ms, 5th percentile {ordered[len(ordered) // 20]:.6f} ms, "
            f"max {ordered[-1]:.6f} ms; the host's launches "
            f"{win['host_ms']:.6f} ms per step")
        log(f"window: {steps} steps in {win['seconds']:.4f} s, "
            f"{pairs} neighbor pairs per step, "
            f"{pairs / step_ms * 1e3:.6g} pairs/s, vs_baseline "
            f"{pairs / step_ms * 1e3 / BASELINE_PAIRS_PER_S:.4g} (card: "
            f"{limit})")
        values = {"step_ms": step_ms, "step_ms_p95": p95(win["intervals"]),
                  "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end()}
    result["device"] = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device)
        if device.type == "cuda" else "cpu",
        "count": 1, "memory_peak_bytes": peak}
    if trace_on:
        result["device"].update(busy_s=record["busy_ms"] / 1e3,
                                window_s=record["window_ms"] / 1e3)
        result["breakdown"] = {"device_ops": record["device_ops"],
                               "idle_gaps": record["idle_gaps"]}
    result["checks"] = verdict["checks"]
    return result
