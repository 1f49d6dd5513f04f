"""The harness finds every piece by name, and the names keep to the
benchmark's rules, on the CPU.

    python -m pytest nsbench -q -p no:cacheprovider
"""

import json
import re
import shutil
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from nsbench import cells, harness, trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_every_cell_resolves_to_its_config_and_traffic():
    for w in BENCH["workloads"]:
        cell = cells.Cell(w["name"], ROOT)
        assert cell.config["name"] == w["config"]
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert cell.end_to_end() and cell.per_layer()
        assert (cell.callback is not None) == bool(cell.traffic.get("reduce"))


def test_every_per_layer_metric_has_a_reader():
    for m in BENCH["per_layer"]:
        reader = cells.Cell(m["workloads"][0], ROOT).reader(m["name"])
        assert callable(reader.read)


def test_names_units_and_lines_keep_to_the_rules():
    names = [c["name"] for c in BENCH["configs"]] \
        + [w["name"] for w in BENCH["workloads"]] \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for name in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for entry in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(1 <= len(x) <= 200 for x in layers)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    assert all(m["moves"] in e2e for m in BENCH["per_layer"])
    for c in BENCH["configs"]:
        assert c["file"].startswith("nsbench/") and (ROOT / c["file"]).is_file()
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_new_config_mix_and_metric_are_found_without_an_edit(tmp_path):
    """Added files and entries in a copy run on the CPU as they are."""
    shutil.copytree(HERE, tmp_path / "nsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    config = json.loads((HERE / "configs" / "cfg1_1m_uniform.json")
                        .read_text())
    config.update(name="tiny", sets=[{"name": "a", "n": 600},
                                     {"name": "b", "n": 200}],
                  radius=0.15, active=[[0, 0], [0, 1]])
    (tmp_path / "nsbench" / "configs" / "tiny.json").write_text(
        json.dumps(config))
    (tmp_path / "nsbench" / "traffic" / "still.json").write_text(
        json.dumps({"step": {}, "move": 0, "trace_steps": 2}))
    (tmp_path / "nsbench" / "metrics" / "steps_seen.py").write_text(
        "def read(record):\n    return record['steps']\n")
    bench["configs"].append(dict(bench["configs"][0], name="tiny",
                                 file="nsbench/configs/tiny.json"))
    bench["workloads"].append({"name": "tiny.still", "config": "tiny",
                               "traffic": "still", "chips": 1, "why": "t"})
    bench["per_layer"].append({"name": "steps_seen", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "step_ms",
                               "workloads": ["tiny.still"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cells.Cell("tiny.still", tmp_path)
    assert [m["name"] for m in cell.per_layer()] == ["steps_seen"]
    assert cell.reader("steps_seen").read({"steps": 7}) == 7
    result = harness.run_cell(cell, 2 ** 31 + 77, 0.0, False,
                              torch.device("cpu"), 0.0, log=lambda s: None)
    assert result["correct"] and result["checks"]["ref_pairs"]["value"] > 0
    assert set(result["metrics"]) == {"step_ms", "step_ms_p95", "setup_s"}


def record(**kw) -> dict:
    rec = {"kernel_ms": {"step": {
        "void pairs_nbrs_kernel<false, false, true>(int)": 0.8,
        "void expand_query_tiles_kernel(int)": 0.05,
        "void at::native::radix_sort(int)": 0.3,
        "Memcpy DtoD (Device -> Device)": 0.1}, "zsort": {"gather": 1.5}},
        "span_ms": {"step": 1.25, "zsort": 1.5}, "busy_ms": 3.0,
        "window_ms": 4.0, "steps": 1, "zsorts": 1,
        "counters": {"rebuilt": 1, "failed": 0},
        "least": {"least_ms": 0.04},
        "port_kernels": harness.PORT_KERNELS,
        "pairs_kernels": harness.PAIRS_KERNELS}
    rec.update(kw)
    return rec


@pytest.mark.parametrize("metric,want,empty", [
    ("pairs_kernel_roofline", 5.0, {"kernel_ms": {}}),
    ("torch_ops_ms", 0.4, {"kernel_ms": {}}),
    ("rebuilt_share", 100.0, {"counters": {"rebuilt": None}}),
    ("zsort_ms", 1.5, {"span_ms": {"step": 1.0}, "zsorts": 0}),
    ("device_idle", 25.0, {"window_ms": 0})])
def test_readers(metric, want, empty):
    reader = cells.load_module(HERE / "metrics" / f"{metric}.py", metric)
    assert reader.read(record()) == pytest.approx(want)
    assert reader.read(record(**empty)) is None


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def test_trace_charges_device_work_to_spans():
    events = [ev("user_annotation", "zsort", 0, 50),
              ev("user_annotation", "step", 50, 50),
              ev("cuda_runtime", "cudaGraphLaunch", 5, 5, corr=11),
              ev("cuda_runtime", "cudaGraphLaunch", 55, 5, corr=12),
              ev("cpu_op", "aten::add", 70, 5, tid=2),
              ev("kernel", "sort", 10, 30, tid=7, corr=11),
              ev("kernel", "pairs_nbrs_kernel<false>", 60, 20, tid=7,
                 corr=12),
              ev("gpu_memcpy", "Memcpy DtoD", 90, 10, tid=7, corr=12),
              ev("kernel", "lost", 120, 5, tid=7, corr=99),
              ev("gpu_user_annotation", "step", 60, 40, tid=7)]
    rec = trace.reduce_profile({"traceEvents": events})
    assert rec["kernel_ms"]["zsort"] == {"sort": 0.03}
    assert rec["kernel_ms"]["step"] == {"pairs_nbrs_kernel<false>": 0.02,
                                        "Memcpy DtoD": 0.01}
    assert rec["unlinked"] == 1
    assert rec["busy_ms"] == pytest.approx(0.065)
    assert rec["window_ms"] == pytest.approx(0.115)
    assert dict(rec["idle_gaps"]) == pytest.approx(
        {"zsort": 20e-6, "step": 10e-6, "none": 20e-6})


@pytest.mark.parametrize("keys", [
    {"radius": 0.02, "radii": {"low": 0.8, "high": 1.25, "scale": 0.025}},
    {"radius": 0.02, "symmetric": True}])
def test_contradicting_radius_keys_are_refused(keys):
    """With per-point radii the radius is their smallest, so a
    configuration may not state it too, nor search symmetrically without
    them."""
    config = dict(json.loads((HERE / "configs" / "cfg1_1m_uniform.json")
                             .read_text()), **keys)
    if "radii" in keys:
        assert cells.radius({"radii": keys["radii"]}) == 0.8 * 0.025
    with pytest.raises(ValueError):
        cells.check_config(config)


def paced_loop(slow_s: float):
    """A stand-in for ``harness.Loop`` on the CPU whose steps take 2 ms
    for their first ``slow_s`` seconds and 1 ms after."""
    t0 = []

    def run_step():
        import time
        if not t0:
            t0.append(time.perf_counter())
        time.sleep(0.002 if time.perf_counter() - t0[0] < slow_s else 0.001)

    return SimpleNamespace(device=torch.device("cpu"), every=0,
                           run_step=run_step)


@pytest.mark.parametrize("slow_s,least,most", [(0.5, 3.0, 4.5),
                                               (4.2, 5.0, 6.5),
                                               (60.0, 6.0, 7.5)])
def test_the_warm_up_goes_on_until_the_steps_have_sped_up(slow_s, least,
                                                          most):
    """At least ``warm_seconds``, then until a 1 s stretch is ``warm_drop``
    faster than the slowest before it, never past twice
    ``warm_seconds``."""
    import time
    traffic = {"warm_seconds": 3, "warm_drop": 0.2}
    t0 = time.perf_counter()
    said = harness.warm_up(paced_loop(slow_s), traffic)
    took = time.perf_counter() - t0
    assert least <= took <= most, (took, said)
    assert ("no time" in said) == (slow_s > 6)
