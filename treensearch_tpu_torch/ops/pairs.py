"""The kernels of the neighbor-list path, with their plain PyTorch
versions and their CUDA build.

PyTorch counterpart of ``treensearch_tpu/ops/pallas_pairs.py``:

- ``expand_query_tiles`` (K1) replaces ``make_expand_call(build_rec=False)``
  (``pallas_pairs.py:276``): it lays the sorted records out as 128-slot
  query tiles, sentinel-padded.
- ``pairs_nbrs_fixed`` (K2a) replaces ``make_pairs_call`` in neighbor-list
  mode, fixed radius, one candidate set (``pallas_pairs.py:445``), both its
  narrow and its fat tier: it streams every stencil window through shared
  memory in fixed chunks, so no window is too wide and there is no tier
  split.
- ``pairs_nbrs_sets`` (K2b) replaces ``make_pairs_call(multi_set=True)``
  at a fixed radius: one output block per distinct candidate set, with
  set-local indices and a row cap per block.
- ``pairs_nbrs_variable`` (K2c) replaces ``make_pairs_call(variable=True,
  symmetric=...)``: per-point radii, d^2 <= r_i^2, or also d^2 <= r_j^2
  when symmetric, with K2b's output blocks (one block for one set).

The kernels live in ``csrc/pairs.cu`` behind a plain C interface.  They
are compiled by ``nvcc`` for ``sm_90a`` at first use into ``build/`` at
the repository root, cached by a hash of the source and flags, and loaded
with ``ctypes``.  Each wrapper dispatches on the device of its tensors:
CPU tensors take the plain version, CUDA tensors launch the kernel or
raise.  There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

# record fields (rows of the field-major record arrays)
F_X, F_Y, F_Z, F_R, F_ORIG, F_SET = 0, 1, 2, 3, 4, 5
N_FIELDS = 8
TILE = 128        # queries per tile
DESC_W = 128      # descriptor row width
LENS_OFF = 64     # descriptor column of window lengths (<= 49 windows)
A_COL = 62        # descriptor column: tile's first sorted point index
CNT_COL = 63      # descriptor column: tile's real point count (<= 128)
FAT_COL = 127     # descriptor column: 2 = dead tile (no real queries)
MAX_WIN = 49      # (2W+1)^2 windows for stencil W <= 3
MAX_BLOCKS = 8    # candidate-set output blocks of K2b/K2c
# the plain K2a's chunk of tiles, in (query, candidate) slots: its
# temporaries stay at a few hundred MB whatever the point count
_PLAIN_CHUNK_ELEMS = 1 << 23
# query padding: NaN coordinates fail every d^2 <= r^2 compare
SENTINEL_BITS = 0x7FC00000

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "pairs.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# nvcc's location when neither CUDA_HOME nor PATH names one (the CUDA
# toolkit's standard install prefix)
CUDA_HOME_DEFAULT = "/usr/local/cuda"


class _Library:
    """The loaded kernel library and what its build printed."""

    def __init__(self, lib: ctypes.CDLL, path: Path, command: list,
                 log: str, seconds: float):
        self.lib = lib
        self.path = path
        self.command = command
        self.log = log
        self.seconds = seconds


_LOADED: dict = {}   # loaded library per build directory, for the process


def _find_nvcc() -> str | None:
    home = os.environ.get("CUDA_HOME")
    if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(CUDA_HOME_DEFAULT, "bin", "nvcc")
    return default if os.path.isfile(default) else None


def load_library(build_dir: Path | None = None) -> _Library:
    """Build ``csrc/pairs.cu`` (once per source hash) and load it.

    Raises ``RuntimeError`` when ``nvcc`` is missing or the build fails.
    """
    build_dir = Path(build_dir) if build_dir is not None else BUILD_DIR
    if str(build_dir) in _LOADED:
        return _LOADED[str(build_dir)]
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = build_dir / f"pairs_{digest[:16]}.so"
    command, log, seconds = [], "(cached build)", 0.0
    if not out.exists():
        nvcc = _find_nvcc()
        if nvcc is None:
            raise RuntimeError(
                "cannot build the CUDA kernels: nvcc not found (set "
                "CUDA_HOME or put nvcc on PATH)")
        build_dir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
        os.close(fd)
        command = [nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
        t0 = time.perf_counter()
        proc = subprocess.run(command, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tns_expand_query_tiles.argtypes = [vp, vp, ci, ci, ci, vp, vp]
    lib.tns_expand_query_tiles.restype = ci
    lib.tns_pairs_nbrs_fixed.argtypes = [vp, vp, vp, ci, ci, ci, ci, cf,
                                         vp, vp, vp]
    lib.tns_pairs_nbrs_fixed.restype = ci
    pi, pv = ctypes.POINTER(ci), ctypes.POINTER(vp)
    lib.tns_pairs_nbrs.argtypes = [vp, vp, vp, ci, ci, ci, cf, ci, ci, ci,
                                   pi, pi, pi, pv, vp, vp]
    lib.tns_pairs_nbrs.restype = ci
    loaded = _Library(lib, out, command, log, seconds)
    _LOADED[str(build_dir)] = loaded
    return loaded


def _cuda_lib(t: torch.Tensor) -> ctypes.CDLL:
    """The kernel route: build/load first (so a missing toolchain raises
    whatever the tensor), then require a CUDA tensor."""
    lib = load_library().lib
    if t.device.type != "cuda":
        raise ValueError(f"kernels take cpu or cuda tensors, got {t.device}")
    return lib


def _require(t: torch.Tensor, name: str, shape: tuple, device) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def _check_desc(desc: torch.Tensor, tiles_cap: int) -> None:
    if desc.dim() != 2 or desc.shape[1] != DESC_W \
            or desc.shape[0] < tiles_cap:
        raise ValueError(f"desc must be (>= {tiles_cap}, {DESC_W}), got "
                         f"{tuple(desc.shape)}")
    _require(desc, "desc", tuple(desc.shape), desc.device)


def _check_recs(recs_t: torch.Tensor, device) -> int:
    if recs_t.dim() != 2 or recs_t.shape[0] != N_FIELDS \
            or recs_t.shape[1] < 1:
        raise ValueError(f"recs_t must be ({N_FIELDS}, n >= 1), got "
                         f"{tuple(recs_t.shape)}")
    _require(recs_t, "recs_t", tuple(recs_t.shape), device)
    return int(recs_t.shape[1])


# ---------------------------------------------------------------- K1
def expand_query_tiles_plain(desc: torch.Tensor, recs_t: torch.Tensor,
                             tiles_cap: int,
                             sentinel_orig: int) -> torch.Tensor:
    """Plain version of K1: ``q_t[f, 128 t + l] = recs_t[f, a_t + l]`` for
    ``l < cnt_t`` (and ``a_t + l`` inside the records), the sentinel record
    otherwise."""
    n_rec = recs_t.shape[1]
    a = desc[:tiles_cap, A_COL].long()
    cnt = desc[:tiles_cap, CNT_COL]
    lane = torch.arange(TILE, dtype=torch.int32, device=desc.device)
    src = a[:, None] + lane[None, :]
    ok = (lane[None, :] < cnt[:, None]) & (a[:, None] >= 0) & (src < n_rec)
    src = torch.where(ok, src, 0)
    vals = recs_t[:, src.reshape(-1)].view(N_FIELDS, tiles_cap, TILE)
    sent = torch.tensor([SENTINEL_BITS] * 3 + [0, sentinel_orig, -1, 0, 0],
                        dtype=torch.int32, device=desc.device)
    out = torch.where(ok[None], vals, sent[:, None, None])
    return out.reshape(N_FIELDS, tiles_cap * TILE).contiguous()


def expand_query_tiles(desc: torch.Tensor, recs_t: torch.Tensor,
                       tiles_cap: int, sentinel_orig: int) -> torch.Tensor:
    """K1: query tiles ``q_t`` (8, tiles_cap * 128) int32, field-major,
    from the descriptor's A_COL/CNT_COL and the sorted field-major records
    ``recs_t`` (8, n) int32 (float fields as bit patterns)."""
    _check_desc(desc, tiles_cap)
    n_rec = _check_recs(recs_t, desc.device)
    if desc.device.type == "cpu":
        return expand_query_tiles_plain(desc, recs_t, tiles_cap,
                                        sentinel_orig)
    lib = _cuda_lib(desc)
    q_t = torch.empty((N_FIELDS, tiles_cap * TILE), dtype=torch.int32,
                      device=desc.device)
    stream = torch.cuda.current_stream(desc.device).cuda_stream
    err = lib.tns_expand_query_tiles(
        desc.data_ptr(), recs_t.data_ptr(), n_rec, tiles_cap,
        int(sentinel_orig), q_t.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"expand_query_tiles launch failed: CUDA error "
                           f"{err}")
    expand_query_tiles.launches += 1
    return q_t


expand_query_tiles.launches = 0


# ---------------------------------------------------------------- K2
def pairs_nbrs_plain(desc: torch.Tensor, q_t: torch.Tensor,
                     recs_t: torch.Tensor, n_win: int, tiles_cap: int,
                     cand_sets, cand_offsets, k8s, r2: float | None = None,
                     symmetric: bool = False):
    """Plain version of the pairs kernels (K2b with ``r2`` given, K2c with
    ``r2=None``, K2a through ``pairs_nbrs_fixed_plain``), chunked over
    tiles to bound memory.

    For query lane l of tile t, the candidates are the window slots
    ``desc[t, w] + o`` with ``o < desc[t, 64 + w]``, in window order; a
    candidate survives when ``d2 = (dx*dx + dy*dy) + dz*dz`` in float32 is
    ``<= r2`` (fixed radius) or ``<= r_i * r_i`` (``r2=None``: the query's
    F_R), or also ``<= r_j * r_j`` when ``symmetric``, and its orig
    differs from the query's.  Block b keeps the survivors whose F_SET is
    ``cand_sets[b]`` (all of them for ``None``), front-packs ``orig -
    cand_offsets[b]`` into rows of ``k8s[b]`` with -1 fill, and counts
    exactly past the cap.  Dead tiles
    (``FAT_COL == 2``) count 0, and a window is clipped to the records.
    Returns counts (n_blocks, tiles_cap * 128) and one (tiles_cap, k8,
    128) array per block.
    """
    dev = desc.device
    n_rec = recs_t.shape[1]
    blocks = list(zip(cand_sets, cand_offsets, k8s))
    counts = torch.zeros((len(blocks), tiles_cap * TILE), dtype=torch.int32,
                         device=dev)
    nbrs = [torch.full((tiles_cap, k8, TILE), -1, dtype=torch.int32,
                       device=dev) for k8 in k8s]
    live = (desc[:tiles_cap, FAT_COL] != 2)[:, None]
    starts = desc[:tiles_cap, :n_win]
    lens = torch.minimum(desc[:tiles_cap, LENS_OFF:LENS_OFF + n_win],
                         n_rec - starts)
    lens = torch.where(live & (starts >= 0) & (starts <= n_rec), lens, 0)
    lmax = int(lens.max()) if tiles_cap > 0 else 0
    if lmax == 0:
        return counts, nbrs

    def f32(a, f):
        return a[f].view(torch.float32)

    cx, cy, cz, cr = (f32(recs_t, f) for f in (F_X, F_Y, F_Z, F_R))
    co, cs = recs_t[F_ORIG], recs_t[F_SET]
    qx, qy, qz, qr = (f32(q_t, f) for f in (F_X, F_Y, F_Z, F_R))
    qo = q_t[F_ORIG]
    width = n_win * lmax
    per = max(1, _PLAIN_CHUNK_ELEMS // (TILE * width))
    off = torch.arange(lmax, dtype=torch.int32, device=dev)
    if r2 is not None:
        r2_t = torch.tensor(r2, dtype=torch.float32, device=dev)
    for t0 in range(0, tiles_cap, per):
        t1 = min(t0 + per, tiles_cap)
        nt = t1 - t0
        ok = (off[None, None, :] < lens[t0:t1, :, None]).reshape(nt, width)
        idx = (starts[t0:t1, :, None] + off[None, None, :]).reshape(nt, width)
        idx = torch.where(ok, idx, 0).long()
        sl = slice(t0 * TILE, t1 * TILE)

        def query(q):
            return q[sl].view(nt, TILE)[:, :, None]

        def diff(c, q):
            return c[idx][:, None, :] - query(q)

        dx, dy, dz = diff(cx, qx), diff(cy, qy), diff(cz, qz)
        d2 = (dx * dx + dy * dy) + dz * dz
        if r2 is None:
            qri = query(qr)
            hit = d2 <= qri * qri
            if symmetric:
                crj = cr[idx][:, None, :]
                hit = hit | (d2 <= crj * crj)
        else:
            hit = d2 <= r2_t
        cand = co[idx]
        m = hit & ok[:, None, :] & (cand[:, None, :] != query(qo))
        for b, (set_id, offset, k8) in enumerate(blocks):
            mb = m if set_id is None else m & (cs[idx] == set_id)[:, None, :]
            counts[b, sl] = mb.sum(dim=2, dtype=torch.int32).reshape(-1)
            pos = torch.cumsum(mb, dim=2, dtype=torch.int32) - 1
            keep = mb & (pos < k8)
            rows = torch.full((nt, TILE, k8 + 1), -1, dtype=torch.int32,
                              device=dev)
            rows.scatter_(2, torch.where(keep, pos, k8).long(),
                          torch.where(keep, cand[:, None, :] - offset, -1))
            nbrs[b][t0:t1] = rows[:, :, :k8].transpose(1, 2)
    return counts, nbrs


def pairs_nbrs_fixed_plain(desc: torch.Tensor, q_t: torch.Tensor,
                           recs_t: torch.Tensor, r2: float, n_win: int,
                           k8: int, tiles_cap: int):
    """Plain version of K2a: ``pairs_nbrs_plain`` at a fixed radius with
    one block that keeps every survivor as its orig."""
    counts, nbrs = pairs_nbrs_plain(desc, q_t, recs_t, n_win, tiles_cap,
                                    (None,), (0,), (k8,), r2=r2)
    return counts[0], nbrs[0]


def pairs_nbrs_fixed(desc: torch.Tensor, q_t: torch.Tensor,
                     recs_t: torch.Tensor, r2: float, n_win: int, k8: int,
                     tiles_cap: int):
    """K2a: exact per-query counts (tiles_cap * 128,) int32 and padded
    neighbor rows (tiles_cap, k8, 128) int32 in tile layout.

    Rows of dead tiles are undefined on the card (the kernel returns at
    once); consumers gather live slots only, through ``qpos``.
    """
    _check_desc(desc, tiles_cap)
    n_rec = _check_recs(recs_t, desc.device)
    _require(q_t, "q_t", (N_FIELDS, tiles_cap * TILE), desc.device)
    _check_n_win(n_win)
    _check_k8(k8)
    if desc.device.type == "cpu":
        return pairs_nbrs_fixed_plain(desc, q_t, recs_t, r2, n_win, k8,
                                      tiles_cap)
    lib = _cuda_lib(desc)
    counts = torch.empty(tiles_cap * TILE, dtype=torch.int32,
                         device=desc.device)
    nbrs = torch.empty((tiles_cap, k8, TILE), dtype=torch.int32,
                       device=desc.device)
    stream = torch.cuda.current_stream(desc.device).cuda_stream
    err = lib.tns_pairs_nbrs_fixed(
        desc.data_ptr(), q_t.data_ptr(), recs_t.data_ptr(), n_rec,
        tiles_cap, n_win, k8, float(r2), counts.data_ptr(),
        nbrs.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"pairs_nbrs_fixed launch failed: CUDA error "
                           f"{err}")
    pairs_nbrs_fixed.launches += 1
    return counts, nbrs


pairs_nbrs_fixed.launches = 0


def _check_n_win(n_win: int) -> None:
    if not 1 <= n_win <= MAX_WIN:
        raise ValueError(f"n_win must be in [1, {MAX_WIN}], got {n_win}")


def _check_k8(k8: int) -> None:
    if k8 <= 0 or k8 % 8:
        raise ValueError(f"k8 must be a positive multiple of 8, got {k8}")


def _pairs_nbrs(wrapper, desc, q_t, recs_t, n_win, tiles_cap, cand_sets,
                cand_offsets, k8s, r2, symmetric):
    """The K2b/K2c route: checks, then the plain version for CPU tensors
    or one launch of ``pairs_nbrs_kernel`` for CUDA tensors."""
    _check_desc(desc, tiles_cap)
    n_rec = _check_recs(recs_t, desc.device)
    _require(q_t, "q_t", (N_FIELDS, tiles_cap * TILE), desc.device)
    _check_n_win(n_win)
    cand_sets, cand_offsets, k8s = (tuple(int(v) for v in a)
                                    for a in (cand_sets, cand_offsets, k8s))
    nb = len(cand_sets)
    if not 1 <= nb <= MAX_BLOCKS or len(cand_offsets) != nb \
            or len(k8s) != nb or len(set(cand_sets)) != nb:
        raise ValueError(
            f"1 to {MAX_BLOCKS} distinct candidate sets with one offset and "
            f"one k8 each, got {cand_sets}, {cand_offsets}, {k8s}")
    for k8 in k8s:
        _check_k8(k8)
    if desc.device.type == "cpu":
        return pairs_nbrs_plain(desc, q_t, recs_t, n_win, tiles_cap,
                                cand_sets, cand_offsets, k8s, r2=r2,
                                symmetric=symmetric)
    lib = _cuda_lib(desc)
    dev = desc.device
    counts = torch.empty((nb, tiles_cap * TILE), dtype=torch.int32,
                         device=dev)
    nbrs = [torch.empty((tiles_cap, k8, TILE), dtype=torch.int32, device=dev)
            for k8 in k8s]

    def ints(vals):
        return (ctypes.c_int * nb)(*vals)

    ptrs = (ctypes.c_void_p * nb)(*[t.data_ptr() for t in nbrs])
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.tns_pairs_nbrs(
        desc.data_ptr(), q_t.data_ptr(), recs_t.data_ptr(), n_rec, tiles_cap,
        n_win, float(r2 if r2 is not None else 0.0), int(r2 is None),
        int(symmetric), nb, ints(cand_sets), ints(cand_offsets), ints(k8s),
        ptrs, counts.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__} launch failed: CUDA error "
                           f"{err}")
    wrapper.launches += 1
    return counts, nbrs


def pairs_nbrs_sets(desc: torch.Tensor, q_t: torch.Tensor,
                    recs_t: torch.Tensor, r2: float, n_win: int,
                    tiles_cap: int, cand_sets, cand_offsets, k8s):
    """K2b: fixed radius, one output block per candidate set.  Returns
    counts (n_blocks, tiles_cap * 128) int32 and, per block b, rows
    (tiles_cap, k8s[b], 128) int32 of set-local indices ``orig -
    cand_offsets[b]`` of the survivors in set ``cand_sets[b]``.  Rows of
    dead tiles are undefined on the card, as with K2a."""
    return _pairs_nbrs(pairs_nbrs_sets, desc, q_t, recs_t, n_win, tiles_cap,
                       cand_sets, cand_offsets, k8s, r2, False)


pairs_nbrs_sets.launches = 0


def pairs_nbrs_variable(desc: torch.Tensor, q_t: torch.Tensor,
                        recs_t: torch.Tensor, n_win: int, tiles_cap: int,
                        cand_sets, cand_offsets, k8s, symmetric: bool):
    """K2c: per-point radii from the records' F_R field (d^2 <= r_i^2, or
    also d^2 <= r_j^2 when ``symmetric``), with K2b's output blocks."""
    return _pairs_nbrs(pairs_nbrs_variable, desc, q_t, recs_t, n_win,
                       tiles_cap, cand_sets, cand_offsets, k8s, None,
                       bool(symmetric))


pairs_nbrs_variable.launches = 0
