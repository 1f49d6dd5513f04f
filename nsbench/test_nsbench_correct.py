"""``correct`` on the CPU at sizes a test run holds: every cell's program
comes out correct, and its control (the reference in bfloat16 in the
program's place) and each fault planted under the timed path come out not
correct.  The harness's look for a card is skipped: the cells run through
``harness.run_cell`` on the CPU, where each captured piece is called
eagerly.  On the card the control runs at the cells' own sizes through
``nsbench/control.py``.

    python -m pytest nsbench -q -p no:cacheprovider
"""

import json
from pathlib import Path

import pytest
import torch

from nsbench import cells, harness, judge
from nsbench.generate import Inputs

HERE = Path(__file__).resolve().parent
CELLS = [w["name"] for w in json.loads(
    (HERE.parent / "BENCHMARK.json").read_text())["workloads"]]
SMALL = {"cfg1_1m_uniform": ([3000], 0.1),
         "cfg5_10m_3sets": ([3000, 600, 200], 0.12)}
SEED = 2 ** 31 + 4099
CPU = torch.device("cpu")


def small_cell(name: str):
    """The cell with its sets and radius cut to a CPU test's size."""
    cell = cells.Cell(name)
    sizes, radius = SMALL[cell.entry["config"]]
    for s, n in zip(cell.config["sets"], sizes):
        s["n"] = n
    cell.config["radius"] = radius
    cell.traffic["warm_seconds"] = 0
    if cell.callback is not None:
        cell.callback = cells.load_module(
            HERE / "traffic" / f"{cell.entry['traffic']}.py",
            "small_callback").callback(radius)
    return cell


def run(cell) -> dict:
    return harness.run_cell(cell, SEED, 0.0, False, CPU, 0.0,
                            log=lambda s: None)


@pytest.mark.parametrize("name", CELLS)
def test_program_is_correct(name):
    result = run(small_cell(name))
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = small_cell(name)
    inputs = Inputs(cell.config, cell.traffic, SEED, CPU)
    start = inputs.snapshot()
    loop = harness.Loop(cell, inputs, CPU)
    for _ in range(4):
        loop.run_step()
    verdict = judge.judge(cell, inputs, start,
                          judge.control_outputs(cell, inputs, start,
                                                loop.moves, loop.zsort_moves),
                          loop.moves, loop.zsort_moves)
    assert not verdict["correct"], verdict["checks"]


def stale(sols: list, sol: dict) -> dict:
    """A step that returns its first solution, its state unchanged."""
    sols.append(sol)
    return sols[0]


def half(sols: list, sol: dict) -> dict:
    """Half of the queries left out of every pair, or out of the sums."""
    for pair in sol.get("pairs", {}).values():
        n = pair["counts"].shape[0]
        pair["counts"][n // 2:] = 0
    for sums in sol.get("reduce", {}).values():
        sums[:, sums.shape[1] // 2:] = 0
    return sol


def altered(sols: list, sol: dict) -> dict:
    """One answer altered where it is produced: a neighbor of one query,
    or one query's sum."""
    for pair in sol.get("pairs", {}).values():
        q = int(torch.nonzero(pair["counts"])[0])
        slot = int(pair["qpos"][q])
        rows = pair["nbrs_tiles"]
        rows[slot // 128, 0, slot % 128] += 1
        break
    for sums in sol.get("reduce", {}).values():
        q = int(torch.nonzero(sums[0])[0])
        sums[0, q] *= 1.01
        break
    return sol


FAULTS = {"stale": stale, "half": half, "altered": altered}


def faulty_steps(monkeypatch, fault):
    from treensearch_tpu_torch import TreeNSearch
    make = TreeNSearch.make_step_fn

    def make_step_fn(self, **kwargs):
        step, state = make(self, **kwargs)
        sols = []

        def broken(state, *args, **kw):
            sol, state = step(state, *args, **kw)
            return fault(sols, sol), state

        return broken, state

    monkeypatch.setattr(TreeNSearch, "make_step_fn", make_step_fn)


def moving(name: str) -> bool:
    """Whether the positions change between steps: moved or z-sorted."""
    traffic = cells.Cell(name).traffic
    return bool(traffic.get("move") or traffic.get("zsort"))


# at unchanged positions a step's state does not change: no stale fault
@pytest.mark.parametrize("name,fault", [
    (name, fault) for name in CELLS for fault in sorted(FAULTS)
    if fault != "stale" or moving(name)])
def test_fault_in_the_step_is_not_correct(monkeypatch, name, fault):
    cell = small_cell(name)
    faulty_steps(monkeypatch, FAULTS[fault])
    result = run(cell)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "arrays_left_out",
                                   "altered"])
def test_fault_in_the_zsort_is_not_correct(monkeypatch, fault):
    from treensearch_tpu_torch.ops import zsort
    make = zsort.make_zsort_step

    def make_zsort_step(n_sets=1):
        real = make(n_sets)

        def step(points, arrays=None):
            orders, pts, arrs = real(points, arrays)
            if fault == "unchanged":
                return orders, list(points), [list(a) for a in arrays]
            if fault == "arrays_left_out":
                return orders, pts, [list(a) for a in arrays]
            arrs[0][1] = arrs[0][1].clone()
            arrs[0][1][0] += 1
            return orders, pts, arrs

        return step

    monkeypatch.setattr(zsort, "make_zsort_step", make_zsort_step)
    result = run(small_cell("cfg5_10m_3sets.sph_zsort_loop"))
    assert not result["correct"], result["checks"]
