"""Guards of the benchmark, on the CPU: what it imports, and that it gives
no result without a card.

    python -m pytest nsbench -q -p no:cacheprovider
"""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
JAX = {"jax", "jaxlib", "flax", "treensearch_tpu"}


def imported_top_names(path: Path) -> set:
    """Top-level names of every module that ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_under_nsbench_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        found = imported_top_names(path) & JAX
        assert not found, f"{path.relative_to(ROOT)} imports {found}"


def test_whole_name_comparison_tells_the_port_from_the_jax_package():
    names = {"treensearch_tpu_torch"} | {"treensearch_tpu_torch_x"}
    assert not names & JAX
    assert {"treensearch_tpu"} & JAX


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "roofline.py"):
        found = imported_top_names(HERE / name)
        assert found <= {"__future__", "numpy", "torch"}, (name, found)


def _run(cwd: Path) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "nsbench/run.py", "--workload",
         "cfg1_1m_uniform.moving_step", "--seed", "2147483659",
         "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def _has_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if isinstance(json.loads(line), dict):
                return True
        except ValueError:
            pass
    return False


def test_run_exits_nonzero_without_a_card_and_prints_no_result():
    proc = _run(ROOT)
    assert proc.returncode != 0
    assert not _has_result(proc.stdout)
    assert "CUDA device" in proc.stderr


def test_run_without_the_program_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "nsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert not _has_result(proc.stdout)
    assert "treensearch_tpu_torch" in proc.stderr
