"""Guards of the port's boundaries: no JAX in the package, no CPU carry-on
when CUDA is asked for, and no plain-version substitute when the kernels
cannot be built."""

import multiprocessing
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from treensearch_tpu_torch import TreeNSearch
from treensearch_tpu_torch.ops import pairs

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "treensearch_tpu_torch"


def test_import_leaves_jax_out():
    code = ("import sys, treensearch_tpu_torch, treensearch_tpu_torch.interop,"
            " treensearch_tpu_torch.oracle,"
            " treensearch_tpu_torch.native_oracle,"
            " treensearch_tpu_torch.ops.fastpath,"
            " treensearch_tpu_torch.ops.pipeline,"
            " treensearch_tpu_torch.ops.reduce,"
            " treensearch_tpu_torch.parallel.sharded,"
            " treensearch_tpu_torch.utils.compact,"
            " treensearch_tpu_torch.utils.keys; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "'jax.') or m == 'treensearch_tpu' or m.startswith("
            "'treensearch_tpu.')]; print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_package_source_never_imports_jax():
    pattern = re.compile(r"import jax|from jax|treensearch_tpu(?!_torch)\b"
                         r"(?=\s+import|\.)")
    hits = []
    for path in sorted(PKG.rglob("*")):
        if path.suffix in (".py", ".cu", ".cuh"):
            for k, line in enumerate(path.read_text().splitlines(), 1):
                if re.search(r"import jax", line) or (
                        re.match(r"\s*(from|import)\s", line)
                        and pattern.search(line)):
                    hits.append(f"{path.relative_to(ROOT)}:{k}: {line}")
    assert hits == []


@pytest.mark.parametrize("kwargs", [{}, {"device": "cuda"}])
def test_cuda_engine_raises_without_cuda(kwargs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TreeNSearch(**kwargs)


def _no_nvcc(monkeypatch, tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(pairs, "CUDA_HOME_DEFAULT", str(empty))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    _no_nvcc(monkeypatch, tmp_path)
    build = tmp_path / "build"
    with pytest.raises(RuntimeError, match="nvcc not found"):
        pairs.load_library(build)
    assert not build.exists() or not any(build.iterdir())


def test_cached_build_keeps_its_nvcc_log(monkeypatch, tmp_path):
    # a stand-in nvcc that prints a resource line and copies a shared
    # library: a second process (a fresh _LOADED) reuses the build and
    # still reads what nvcc printed
    lib = Path(torch.__file__).parent / "lib" / "libc10.so"
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    f'cp {lib} "$2"\necho "ptxas info : Used 7 registers"\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(pairs, "_LOADED", {})
    first = pairs.build_library("probe", b"// probe", tmp_path / "build")
    monkeypatch.setattr(pairs, "_LOADED", {})
    again = pairs.build_library("probe", b"// probe", tmp_path / "build")
    assert first.command and not again.command
    assert "Used 7 registers" in first.log
    assert again.log == first.log


def _build_probe(build_dir: str) -> None:
    pairs.build_library("probe", b"// probe", Path(build_dir))


def test_ranks_that_build_together_run_one_nvcc(monkeypatch, tmp_path):
    # four processes started together (the ranks of a mesh) build the same
    # source: the build lock lets one stand-in nvcc run, slowly, and the
    # other three load its library
    lib = Path(torch.__file__).parent / "lib" / "libc10.so"
    runs = tmp_path / "runs"
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(f'#!/bin/sh\necho run >> {runs}\nsleep 1\n'
                    'while [ "$1" != "-o" ]; do shift; done\n'
                    f'cp {lib} "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_build_probe, args=(str(tmp_path / "b"),))
             for _ in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
    assert [p.exitcode for p in procs] == [0] * 4
    assert runs.read_text().splitlines() == ["run"]


def test_kernel_route_does_not_fall_back(monkeypatch, tmp_path):
    # a tensor that is not on the CPU takes the kernel route; with no
    # toolchain that raises instead of running the plain version
    _no_nvcc(monkeypatch, tmp_path)
    monkeypatch.setattr(pairs, "BUILD_DIR", tmp_path / "build")
    desc = torch.zeros((8, pairs.DESC_W), dtype=torch.int32, device="meta")
    recs = torch.zeros((pairs.N_FIELDS, 4), dtype=torch.int32,
                       device="meta")
    before = pairs.expand_query_tiles.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        pairs.expand_query_tiles(desc, recs, 1, 4)
    q = torch.zeros((pairs.N_FIELDS, 128), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="nvcc"):
        pairs.pairs_nbrs_fixed(desc, q, recs, 0.01, 9, 8, 1)
    assert pairs.expand_query_tiles.launches == before


def test_k1r_route_does_not_fall_back(monkeypatch, tmp_path):
    # K1r, the tile path's record kernel, on a tensor off the CPU: with no
    # toolchain it raises instead of running expand_records_plain
    _no_nvcc(monkeypatch, tmp_path)
    monkeypatch.setattr(pairs, "BUILD_DIR", tmp_path / "build")
    desc = torch.zeros((8, pairs.DESC_W), dtype=torch.int32, device="meta")
    recs = torch.zeros((pairs.N_FIELDS, 4), dtype=torch.int32,
                       device="meta")
    before = pairs.expand_records.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        pairs.expand_records(desc, recs, 1, 4, 128)
    assert pairs.expand_records.launches == before


@pytest.mark.parametrize("kernel", ["sets", "variable", "mask"])
def test_redesigned_pairs_kernels_do_not_fall_back(kernel, monkeypatch,
                                                   tmp_path):
    # K2b, K2c and K4 on tensors off the CPU: with no toolchain they raise
    # instead of running their plain versions, and count no launch
    _no_nvcc(monkeypatch, tmp_path)
    monkeypatch.setattr(pairs, "BUILD_DIR", tmp_path / "build")
    meta = {"dtype": torch.int32, "device": "meta"}
    desc = torch.zeros((8, pairs.DESC_W), **meta)
    recs = torch.zeros((pairs.N_FIELDS, 4), **meta)
    q = torch.zeros((pairs.N_FIELDS, 128), **meta)
    wrapper, call = {
        "sets": (pairs.pairs_nbrs_sets, lambda: pairs.pairs_nbrs_sets(
            desc, q, recs, 0.01, 9, 1, (0, 1), (0, 2), (8, 8))),
        "variable": (pairs.pairs_nbrs_variable,
                     lambda: pairs.pairs_nbrs_variable(
                         desc, q, recs, 25, 1, (0,), (0,), (8,), True)),
        "mask": (pairs.pairs_mask, lambda: pairs.pairs_mask(
            desc, q, recs, 9, 1, (0,), torch.ones(1, **meta))),
    }[kernel]
    before = wrapper.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        call()
    assert wrapper.launches == before


CHIP_SCRIPTS = ["chip_smoke.py", "chip_profile.py", "chip_variants.py"]


@pytest.mark.parametrize("script", CHIP_SCRIPTS)
def test_chip_scripts_never_import_jax(script):
    hits = [line for line in (ROOT / script).read_text().splitlines()
            if re.match(r"\s*(from|import)\s+(jax|treensearch_tpu)\b", line)]
    assert hits == []


@pytest.mark.parametrize("script", CHIP_SCRIPTS)
def test_chip_script_needs_a_card(script):
    # no card: a non-zero exit and no result on standard output
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, str(ROOT / script)],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert proc.stdout == ""
