"""``correct`` on the CPU at sizes a test run holds: every cell's program
comes out correct, and its control (the reference in bfloat16 in the
program's place) and each fault planted under the timed path come out not
correct.  The harness's look for a card is skipped: the cells run through
``harness.run_cell`` on the CPU, where each captured piece is called
eagerly.  On the card the control runs at the cells' own sizes through
``nsbench/control.py``.

Each configuration states its CPU test size under ``cpu_test``: the sets'
sizes and the radius (with per-point radii, the smallest), which the
harness, judge and generator never read.

    python -m pytest nsbench -q -p no:cacheprovider
"""

import hashlib
import json
import shutil
from pathlib import Path

import pytest
import torch

from nsbench import cells, harness, judge
from nsbench.generate import Inputs

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFIGS = {c["name"]: json.loads((ROOT / c["file"]).read_text())
           for c in BENCH["configs"]}
# a cell whose configuration states no CPU test size fails
# test_every_configuration_states_its_cpu_test_size, and only that test
CELLS = [w["name"] for w in BENCH["workloads"]
         if "cpu_test" in CONFIGS[w["config"]]]
SEED = 2 ** 31 + 4099
CPU = torch.device("cpu")


def small_cell(name: str, root: Path = ROOT):
    """The cell with its sets and radius cut to its configuration's
    ``cpu_test`` size; per-point radii keep their ratio to the smallest."""
    cell = cells.Cell(name, root)
    small = cell.config["cpu_test"]
    for s, n in zip(cell.config["sets"], small["sizes"]):
        s["n"] = n
    radius = float(small["radius"])
    if cell.config.get("radii"):
        cell.config["radii"]["scale"] = radius / cell.config["radii"]["low"]
    else:
        cell.config["radius"] = radius
    cell.traffic["warm_seconds"] = 0
    cell.traffic.pop("warm_drop", None)
    if cell.callback is not None:
        cell.callback = cells.load_module(
            cell.root / "nsbench" / "traffic"
            / f"{cell.entry['traffic']}.py",
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


def test_every_configuration_states_its_cpu_test_size():
    missing = sorted(name for name, c in CONFIGS.items()
                     if "cpu_test" not in c)
    assert not missing, (
        f"{missing}: add \"cpu_test\": {{\"sizes\": [one size per set], "
        "\"radius\": r}} to each configuration file, a size and radius "
        "at which nsbench's CPU tests run it")


def control_verdict(cell) -> dict:
    """The judge's verdict on the control after four steps of the loop."""
    inputs = Inputs(cell.config, cell.traffic, SEED, CPU)
    start = inputs.snapshot()
    loop = harness.Loop(cell, inputs, CPU)
    for _ in range(4):
        loop.run_step()
    return judge.judge(cell, inputs, start,
                       judge.control_outputs(cell, inputs, start,
                                             loop.moves, loop.zsort_moves),
                       loop.moves, loop.zsort_moves)


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    verdict = control_verdict(small_cell(name))
    assert not verdict["correct"], verdict["checks"]


def digest(inputs) -> str:
    """A checksum of the generated points, velocity, payload and user
    arrays, in that order."""
    h = hashlib.sha256()
    for t in [inputs.points, inputs.velocity, inputs.payload, *inputs.user]:
        if t is not None:
            h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


# the inputs of the first four cells at their CPU sizes, as the generator
# made them before it drew per-point radii
PINNED = {
    ("cfg1_1m_uniform.moving_step", SEED): "6b4578597eedbcbc",
    ("cfg1_1m_uniform.moving_step", 7): "3772a392a954a5b7",
    ("cfg5_10m_3sets.sph_zsort_loop", SEED): "50b32631c76c10c6",
    ("cfg5_10m_3sets.sph_zsort_loop", 7): "b3c24902c2cdc8fb",
    ("cfg1_1m_uniform.static_step", SEED): "6b3921969af389fb",
    ("cfg1_1m_uniform.static_step", 7): "9ff3155a3bfe04d5",
    ("cfg1_1m_uniform.density_step", SEED): "ec96f22791758032",
    ("cfg1_1m_uniform.density_step", 7): "0a3aeaa7669e0883"}


@pytest.mark.parametrize("name,seed", sorted(PINNED))
def test_inputs_of_the_first_cells_are_pinned(name, seed):
    cell = small_cell(name)
    inputs = Inputs(cell.config, cell.traffic, seed, CPU)
    assert inputs.radii is None
    assert digest(inputs) == PINNED[name, seed]


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


# configurations that no cell of BENCHMARK.json runs, each added to a copy
# of the tree as a file and two entries, with no other file changed: a
# second fixed-radius deployment, and one shaped as BASELINE config 4
# (per-point radii, symmetric search, cell 1.5 r_min, so W = 2)
ADDED = {
    "two_sets": {"sets": [{"name": "fluid", "n": 40000},
                          {"name": "wall", "n": 10000}],
                 "radius": 0.05, "cell_factor": 1.2,
                 "active": [[0, 0], [0, 1], [1, 0]],
                 "cpu_test": {"sizes": [2000, 500], "radius": 0.11}},
    "cfg4_variable_symmetric": {
        "sets": [{"name": "fluid", "n": 250000}],
        "radii": {"low": 0.8, "high": 1.25, "scale": 0.032},
        "symmetric": True, "cell_factor": 1.5, "active": "all",
        "cpu_test": {"sizes": [3000], "radius": 0.08}}}


def added_cell(root: Path, name: str):
    """``name.moving_step`` in a copy of the tree under ``root`` that adds
    the configuration file and its ``configs`` and ``workloads`` entries."""
    shutil.copytree(HERE, root / "nsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    config = dict(ADDED[name], name=name, source="a test", reduced=[],
                  neighbor_caps=[], coherence=True)
    (root / "nsbench" / "configs" / f"{name}.json").write_text(
        json.dumps(config))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": name, "source": "a test",
                             "file": f"nsbench/configs/{name}.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": f"{name}.moving_step", "config": name,
                               "traffic": "moving_step", "chips": 1,
                               "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return small_cell(f"{name}.moving_step", root)


def no_symmetric(monkeypatch):
    """The program searching one-sided: the symmetric half of the rule
    dropped."""
    from treensearch_tpu_torch import TreeNSearch
    set_symmetric = TreeNSearch.set_symmetric_search
    monkeypatch.setattr(TreeNSearch, "set_symmetric_search",
                        lambda self, activate: set_symmetric(self, False))


@pytest.mark.parametrize("name,side", [
    ("two_sets", "program"), ("two_sets", "control"),
    ("cfg4_variable_symmetric", "program"),
    ("cfg4_variable_symmetric", "control"),
    ("cfg4_variable_symmetric", "no_symmetric")])
def test_an_added_configuration_is_checked_without_an_edit(
        tmp_path, monkeypatch, name, side):
    cell = added_cell(tmp_path, name)
    if side == "control":
        verdict = control_verdict(cell)
        assert not verdict["correct"], verdict["checks"]
        return
    if side == "no_symmetric":
        no_symmetric(monkeypatch)
    result = run(cell)
    assert result["correct"] == (side == "program"), result["checks"]
    assert result["failed"] == 0 and result["checks"]["ref_pairs"]["value"] > 0
