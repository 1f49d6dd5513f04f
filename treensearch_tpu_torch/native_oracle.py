"""ctypes bindings of the native CPU grid search (``native/nsgrid.cpp``):
the port's large-N oracle.

The port's own copy of ``treensearch_tpu/native_oracle.py``.
``grid_search_pair`` is an exact, threaded CPU neighbor search for sizes
where the O(n^2) oracle (``oracle.py``) is out of reach, such as the 1M-
and 10M-point BASELINE configurations.  It is an oracle only: no path of
the engine calls it.

The library is compiled from ``native/nsgrid.cpp`` with the flags of
``native/build.py`` (``-ffp-contract=off`` keeps d^2 in the engine's
float32 rounding) into the repository's ``build/`` directory, named by a
hash of the source, the flags and the target that ``-march=native``
selects, so a build made on one machine is never loaded on another CPU.
The build writes a temporary file and renames it into place, so processes
that build together each load a whole library.  A failed build raises;
``available()`` is False only when there is no ``g++``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "native" / "nsgrid.cpp"
BUILD_DIR = ROOT / "build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-std=c++17",
             "-shared", "-fPIC", "-pthread")

_LIB = None   # the loaded library, for the process


def available() -> bool:
    """Whether the oracle can be built here: a ``g++`` on PATH."""
    return shutil.which(CXX) is not None


def _target_macros(cxx: str) -> bytes:
    """The macros ``-march=native`` predefines on this machine (its
    instruction-set extensions), part of the library's name."""
    proc = subprocess.run([cxx, "-march=native", "-dM", "-E", "-x", "c++",
                           os.devnull], capture_output=True, check=True)
    return proc.stdout


def build(build_dir: Optional[Path] = None) -> Path:
    """Compile ``native/nsgrid.cpp`` into ``build_dir/nsgrid_<hash>.so``
    (once per hash) and return its path.  Raises ``RuntimeError`` when
    ``g++`` is missing or the build fails."""
    build_dir = Path(build_dir) if build_dir is not None else BUILD_DIR
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError("cannot build the native oracle: g++ not found")
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()
                            + _target_macros(cxx)).hexdigest()
    out = build_dir / f"nsgrid_{digest[:16]}.so"
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) on "
                               f"{SOURCE}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
    lib.nsgrid_search.restype = ctypes.c_int64
    lib.nsgrid_search.argtypes = [
        fp, ctypes.c_int64, fp, ctypes.c_int64, fp, fp,
        ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ip, ctypes.POINTER(ip)]
    lib.nsgrid_free.restype = None
    lib.nsgrid_free.argtypes = [ip]
    _LIB = lib
    return lib


def grid_search_pair(pts_i: np.ndarray, pts_j: np.ndarray,
                     radius: float = 0.0,
                     radii_i: Optional[np.ndarray] = None,
                     radii_j: Optional[np.ndarray] = None,
                     symmetric: bool = False,
                     same_set: bool = False,
                     cell: Optional[float] = None):
    """Exact neighbor lists of one (i -> j) pair under the oracle's rules
    (``oracle.py``): d^2 <= r_i^2 in float32 (``radius`` without radii),
    or also d^2 <= r_j^2 when ``symmetric``; ``same_set`` excludes each
    point from its own list.  ``cell`` is the grid's cell size (default
    1.5 times the radius, or the smallest r_i); results do not depend on
    it.

    Returns (counts (n_i,) int32, offsets (n_i + 1,) int64, nbrs (total,)
    int32): CSR with set_j-local indices, unsorted within a row.
    """
    lib = _load()
    pi = np.ascontiguousarray(pts_i, np.float32).reshape(-1, 3)
    pj = np.ascontiguousarray(pts_j, np.float32).reshape(-1, 3)
    n_i, n_j = pi.shape[0], pj.shape[0]
    counts = np.zeros(n_i, np.int32)
    if n_i == 0 or n_j == 0:
        return counts, np.zeros(n_i + 1, np.int64), np.zeros(0, np.int32)

    variable = radii_i is not None
    ri = np.ascontiguousarray(radii_i, np.float32) if variable else None
    rj = np.ascontiguousarray(radii_j, np.float32) \
        if radii_j is not None else None
    reach_extra = float(rj.max()) if (variable and symmetric
                                      and rj is not None) else 0.0
    if cell is None:
        base = float(ri.min()) if variable else float(radius)
        cell = 1.5 * base if base > 0 else 1.0

    fp = ctypes.POINTER(ctypes.c_float)
    out = ctypes.POINTER(ctypes.c_int32)()
    total = lib.nsgrid_search(
        pi.ctypes.data_as(fp), n_i, pj.ctypes.data_as(fp), n_j,
        ri.ctypes.data_as(fp) if variable else None,
        rj.ctypes.data_as(fp) if rj is not None else None,
        ctypes.c_float(radius), ctypes.c_float(reach_extra),
        ctypes.c_float(cell),
        int(bool(symmetric)), int(bool(same_set)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.byref(out))
    if total < 0:
        raise RuntimeError("nsgrid_search failed")
    nbrs = np.ctypeslib.as_array(out, shape=(max(total, 1),))[:total].copy()
    lib.nsgrid_free(out)
    offsets = np.zeros(n_i + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    return counts, offsets, nbrs
