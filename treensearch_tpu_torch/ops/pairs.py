"""The kernels of the neighbor-list path, with their plain PyTorch
versions and their CUDA build.

PyTorch counterpart of ``treensearch_tpu/ops/pallas_pairs.py``:

- ``expand_query_tiles`` (K1) replaces ``make_expand_call(build_rec=False)``
  (``pallas_pairs.py:276``): it lays the sorted records out as 128-slot
  query tiles, sentinel-padded.
- ``expand_records`` (K1r) replaces ``make_expand_call(build_rec=True)``
  (``pallas_pairs.py:276-442``): K1's query tiles and, slot-major, the
  padded record array that the tile path reads queries and windows from.
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
- ``pairs_mask`` (K4) replaces ``make_pairs_call(mask_mode=True)``
  (``pallas_pairs.py:779-859``): per-pair hit bits plus exact counts, the
  active matrix applied, in the port's own layout (``mask_cand_base``).
- ``pairs_nbrs_from_bits`` (K5) replaces
  ``make_pairs_call(stage_from_bits=True)`` (``pallas_pairs.py:500``), the
  second pass of split staging: K4's bits into K2b's output blocks.

The fused reduce (K3) is in ``reduce.py``; it shares this module's window
clipping, candidate loop and build.  The kernels live in ``csrc/`` behind
a plain C interface.  They are compiled by ``nvcc`` for ``sm_90a`` at
first use into ``build/`` at the repository root, cached by a hash of the
source and flags, and loaded with ``ctypes``.  Each wrapper dispatches on
the device of its tensors: CPU tensors take the plain version, CUDA
tensors launch the kernel or raise.  There is no fallback from one to the
other.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import torch

from .cond import refuse_capture

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
MAX_BLOCKS = 8    # candidate-set output blocks of K2b/K2c, candidate sets
MASK_WORDS = TILE // 32   # K4: int32 words per candidate row, bit = lane
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
        self.command = command    # empty when the file was already built
        self.log = log
        self.seconds = seconds
        self.configured = False   # its ctypes signatures are set


_LOADED: dict = {}   # loaded library per built file, for the process
_PAIRS: dict = {}    # csrc/pairs.cu's library per build directory


def _find_nvcc() -> str | None:
    home = os.environ.get("CUDA_HOME")
    if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(CUDA_HOME_DEFAULT, "bin", "nvcc")
    return default if os.path.isfile(default) else None


def _replace_atomically(data: bytes, out: Path, suffix: str) -> None:
    fd, tmp = tempfile.mkstemp(suffix=suffix, dir=out.parent)
    with os.fdopen(fd, "wb") as f:
        f.write(data)
    os.replace(tmp, out)


def build_library(name: str, text: bytes, build_dir: Path | None = None,
                  source: Path | None = None) -> _Library:
    """Build the CUDA source ``text`` into ``build_dir/<name>_<hash>.so``
    and load it, once per hash of the text and the flags, in and across
    processes: a build holds an exclusive lock on ``<name>_<hash>.lock``,
    so processes that start together (the ranks of a mesh) run one
    ``nvcc`` and the others load its library.  ``source`` is the file the
    text was read from; without one the text is first written to
    ``<name>_<hash>.cu`` beside the library (a generated source).

    Raises ``RuntimeError`` when ``nvcc`` is missing or the build fails.
    """
    build_dir = Path(build_dir) if build_dir is not None else BUILD_DIR
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = build_dir / f"{name}_{digest[:16]}.so"
    if str(out) in _LOADED:
        return _LOADED[str(out)]
    command, log, seconds = [], "(cached build)", 0.0
    log_file = out.with_suffix(".log")   # nvcc's output, kept for reuse
    if not out.exists():
        nvcc = _find_nvcc()
        if nvcc is None:
            raise RuntimeError(
                "cannot build the CUDA kernels: nvcc not found (set "
                "CUDA_HOME or put nvcc on PATH)")
        build_dir.mkdir(parents=True, exist_ok=True)
        with open(out.with_suffix(".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)   # released when closed
            if not out.exists():
                command, log, seconds = _nvcc(nvcc, text, out, source)
    if not command and log_file.exists():
        log = log_file.read_text()
    loaded = _Library(ctypes.CDLL(str(out)), out, command, log, seconds)
    _LOADED[str(out)] = loaded
    return loaded


def _nvcc(nvcc: str, text: bytes, out: Path, source: Path | None):
    """One nvcc build of ``text`` into ``out`` and its log beside it;
    returns the command, nvcc's output and its seconds."""
    if source is None:
        source = out.with_suffix(".cu")
        _replace_atomically(text, source, ".cu")
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    command = [nvcc, *NVCC_FLAGS, "-o", tmp, str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(command, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    _replace_atomically(log.encode(), out.with_suffix(".log"), ".log")
    os.replace(tmp, out)
    return command, log, seconds


def load_library(build_dir: Path | None = None) -> _Library:
    """Build ``csrc/pairs.cu`` (once per source hash) and load it.

    Raises ``RuntimeError`` when ``nvcc`` is missing or the build fails.
    """
    build_dir = Path(build_dir) if build_dir is not None else BUILD_DIR
    if str(build_dir) in _PAIRS:
        return _PAIRS[str(build_dir)]
    loaded = build_library("pairs", SOURCE.read_bytes(), build_dir, SOURCE)
    lib = loaded.lib
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tns_expand_query_tiles.argtypes = [vp, vp, ci, ci, ci, vp, vp]
    lib.tns_expand_query_tiles.restype = ci
    lib.tns_expand_records.argtypes = [vp, vp, ci, ci, ci, ci, vp, vp, vp]
    lib.tns_expand_records.restype = ci
    lib.tns_pairs_nbrs_fixed.argtypes = [vp, vp, vp, ci, ci, ci, ci, cf,
                                         vp, vp, vp]
    lib.tns_pairs_nbrs_fixed.restype = ci
    pi, pv = ctypes.POINTER(ci), ctypes.POINTER(vp)
    lib.tns_pairs_nbrs.argtypes = [vp, vp, vp, ci, ci, ci, cf, ci, ci, ci,
                                   pi, pi, pi, pv, vp, vp]
    lib.tns_pairs_nbrs.restype = ci
    lib.tns_pairs_mask.argtypes = [vp, vp, vp, ci, ci, ci, cf, ci, ci, ci,
                                   pi, vp, ci, vp, ctypes.c_longlong, vp,
                                   vp, vp]
    lib.tns_pairs_mask.restype = ci
    lib.tns_pairs_nbrs_from_bits.argtypes = [vp, vp, ci, ci, ci, vp,
                                             ctypes.c_longlong, vp, ci, pi,
                                             pi, pi, pv, vp, vp]
    lib.tns_pairs_nbrs_from_bits.restype = ci
    loaded.configured = True
    _PAIRS[str(build_dir)] = loaded
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
def _sentinel(sentinel_orig: int, device) -> torch.Tensor:
    """The padding record: NaN x y z, r 0, orig ``sentinel_orig``, set -1,
    payload 0."""
    return torch.tensor([SENTINEL_BITS] * 3 + [0, sentinel_orig, -1, 0, 0],
                        dtype=torch.int32, device=device)


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
    sent = _sentinel(sentinel_orig, desc.device)
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


# ---------------------------------------------------------------- K1r
def expand_records_plain(desc: torch.Tensor, recs_t: torch.Tensor,
                         tiles_cap: int, sentinel_orig: int, slack: int):
    """Plain version of K1r: ``(q_t, rec_pad)``.  ``q_t`` is K1's query
    tiles (``expand_query_tiles_plain``); ``rec_pad[128 t + l]`` is the
    same slot's record, slot-major, and the ``slack`` rows past the tiles
    hold the sentinel."""
    q_t = expand_query_tiles_plain(desc, recs_t, tiles_cap, sentinel_orig)
    tail = _sentinel(sentinel_orig, desc.device)[None, :].expand(slack, -1)
    return q_t, torch.cat([q_t.t(), tail]).contiguous()


def expand_records(desc: torch.Tensor, recs_t: torch.Tensor, tiles_cap: int,
                   sentinel_orig: int, slack: int):
    """K1r: the query tiles ``q_t`` (8, tiles_cap * 128) int32, field-major
    (K1's), and the padded records ``rec_pad`` (tiles_cap * 128 + slack,
    8) int32, slot-major: slot 128 t + l holds sorted record a_t + l for
    l < cnt_t (``desc`` A_COL/CNT_COL), every other slot and the
    ``slack`` tail the sentinel (NaN x y z, r 0, orig ``sentinel_orig``,
    set -1).  It is the JAX array at pack 16 reshaped to (-1, 8), written
    past the live tiles too."""
    _check_desc(desc, tiles_cap)
    n_rec = _check_recs(recs_t, desc.device)
    if slack < 0:
        raise ValueError(f"slack must be >= 0, got {slack}")
    if desc.device.type == "cpu":
        return expand_records_plain(desc, recs_t, tiles_cap, sentinel_orig,
                                    slack)
    lib = _cuda_lib(desc)
    n_slots = tiles_cap * TILE
    q_t = torch.empty((N_FIELDS, n_slots), dtype=torch.int32,
                      device=desc.device)
    rec_pad = torch.empty((n_slots + slack, N_FIELDS), dtype=torch.int32,
                          device=desc.device)
    stream = torch.cuda.current_stream(desc.device).cuda_stream
    err = lib.tns_expand_records(
        desc.data_ptr(), recs_t.data_ptr(), n_rec, tiles_cap, int(slack),
        int(sentinel_orig), q_t.data_ptr(), rec_pad.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"expand_records launch failed: CUDA error {err}")
    expand_records.launches += 1
    return q_t, rec_pad


expand_records.launches = 0


# ------------------------------------------ the candidates of every pairs kernel
def clipped_windows(desc: torch.Tensor, n_rec: int, n_win: int,
                    tiles_cap: int):
    """Each tile's window starts and lengths (tiles_cap, n_win) int32, the
    lengths clipped as every pairs kernel clips them: to the records, to
    0 for a start outside [0, n_rec] and for a dead tile."""
    live = (desc[:tiles_cap, FAT_COL] != 2)[:, None]
    starts = desc[:tiles_cap, :n_win]
    lens = torch.minimum(desc[:tiles_cap, LENS_OFF:LENS_OFF + n_win],
                         n_rec - starts).clamp(min=0)
    lens = torch.where(live & (starts >= 0) & (starts <= n_rec), lens, 0)
    return starts, lens


class _Chunk(NamedTuple):
    """A chunk of tiles [t0, t1) of the plain versions' candidate loop:
    candidate record index ``idx`` and ``ok`` (nt, width) over each tile's
    windows (window-major, padded to the widest), the displacement
    candidate minus query and d^2 (nt, 128, width) float32, and ``hit``:
    the radius criterion, in-window and not the query itself."""
    t0: int
    t1: int
    idx: torch.Tensor
    ok: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    d2: torch.Tensor
    hit: torch.Tensor

    def query(self, q: torch.Tensor) -> torch.Tensor:
        """One field of the query tiles as (nt, 128, 1)."""
        return _query_rows(q, self.t0, self.t1)

    def cand(self, c: torch.Tensor) -> torch.Tensor:
        """One field of the sorted records as (nt, 1, width)."""
        return c[self.idx][:, None, :]


def _query_rows(q: torch.Tensor, t0: int, t1: int) -> torch.Tensor:
    return q[t0 * TILE:t1 * TILE].view(-1, TILE)[:, :, None]


def f32_field(a: torch.Tensor, f: int) -> torch.Tensor:
    """Field ``f`` of field-major int32 records as float32."""
    return a[f].view(torch.float32)


def _chunk_slots(starts: torch.Tensor, lens: torch.Tensor, t0: int, t1: int,
                 off: torch.Tensor):
    """The candidate slots of tiles [t0, t1) in window order, each window
    padded to ``off``'s length: the record index (0 where padded) and
    ``ok`` (nt, n_win * len(off))."""
    ok = off[None, None, :] < lens[t0:t1, :, None]
    idx = torch.where(ok, starts[t0:t1, :, None] + off[None, None, :], 0)
    return idx.reshape(t1 - t0, -1).long(), ok.reshape(t1 - t0, -1)


def _plain_chunks(desc: torch.Tensor, q_t: torch.Tensor,
                  recs_t: torch.Tensor, n_win: int, tiles_cap: int,
                  r2: float | None, symmetric: bool):
    """The candidate loop of every plain version, chunked over tiles to
    bound memory (``_Chunk``s).

    For query lane l of tile t, the candidates are the window slots
    ``desc[t, w] + o`` with ``o`` below the clipped length, in window
    order; a candidate hits when ``d2 = (dx*dx + dy*dy) + dz*dz`` in
    float32 is ``<= r2`` (fixed radius) or ``<= r_i * r_i`` (``r2=None``:
    the query's F_R), or also ``<= r_j * r_j`` when ``symmetric``, and its
    orig differs from the query's."""
    dev = desc.device
    starts, lens = clipped_windows(desc, recs_t.shape[1], n_win, tiles_cap)
    lmax = int(lens.max()) if tiles_cap > 0 else 0
    if lmax == 0:
        return
    cx, cy, cz, cr = (f32_field(recs_t, f) for f in (F_X, F_Y, F_Z, F_R))
    qx, qy, qz, qr = (f32_field(q_t, f) for f in (F_X, F_Y, F_Z, F_R))
    width = n_win * lmax
    per = max(1, _PLAIN_CHUNK_ELEMS // (TILE * width))
    off = torch.arange(lmax, dtype=torch.int32, device=dev)
    if r2 is not None:
        r2_t = torch.tensor(r2, dtype=torch.float32, device=dev)
    for t0 in range(0, tiles_cap, per):
        t1 = min(t0 + per, tiles_cap)
        idx, ok = _chunk_slots(starts, lens, t0, t1, off)

        def query(q):
            return _query_rows(q, t0, t1)

        def cand(c):
            return c[idx][:, None, :]

        dx, dy, dz = (cand(c) - query(q)
                      for c, q in ((cx, qx), (cy, qy), (cz, qz)))
        d2 = (dx * dx + dy * dy) + dz * dz
        if r2 is None:
            qri = query(qr)
            hit = d2 <= qri * qri
            if symmetric:
                crj = cand(cr)
                hit = hit | (d2 <= crj * crj)
        else:
            hit = d2 <= r2_t
        hit = hit & ok[:, None, :] \
            & (cand(recs_t[F_ORIG]) != query(q_t[F_ORIG]))
        yield _Chunk(t0, t1, idx, ok, dx, dy, dz, d2, hit)


def allow_bits(ch: _Chunk, q_t: torch.Tensor, recs_t: torch.Tensor,
               cand_sets, allow: torch.Tensor) -> torch.Tensor:
    """The active matrix on a chunk's pairs (nt, 128, width) bool: the
    candidate's set is candidate set b and bit b of ``allow[query set]``
    is set; the sentinel query (set -1) searches nothing."""
    c_set = ch.cand(recs_t[F_SET])
    bit = torch.zeros_like(c_set)
    for b, s in enumerate(cand_sets):
        bit = bit | torch.where(c_set == s, 1 << b, 0)
    q_set = ch.query(q_t[F_SET])
    n_allow = allow.shape[0]
    inside = (q_set >= 0) & (q_set < n_allow)
    a_q = torch.where(inside, allow[q_set.clamp(0, n_allow - 1)], 0)
    return (a_q & bit) != 0


# ---------------------------------------------------------------- K2
def pairs_nbrs_plain(desc: torch.Tensor, q_t: torch.Tensor,
                     recs_t: torch.Tensor, n_win: int, tiles_cap: int,
                     cand_sets, cand_offsets, k8s, r2: float | None = None,
                     symmetric: bool = False):
    """Plain version of the pairs kernels (K2b with ``r2`` given, K2c with
    ``r2=None``, K2a through ``pairs_nbrs_fixed_plain``) over the
    candidates of ``_plain_chunks``.

    The hits go to ``_front_pack_blocks``.  Returns counts (n_blocks,
    tiles_cap * 128) and one (tiles_cap, k8, 128) array per block.
    """
    co, cs = recs_t[F_ORIG], recs_t[F_SET]
    chunks = ((ch.t0, ch.t1, ch.hit, ch.cand(co), ch.cand(cs))
              for ch in _plain_chunks(desc, q_t, recs_t, n_win, tiles_cap,
                                      r2, symmetric))
    return _front_pack_blocks(chunks, tiles_cap, cand_sets, cand_offsets,
                              k8s, desc.device)


def _front_pack_blocks(chunks, tiles_cap: int, cand_sets, cand_offsets, k8s,
                       dev):
    """The output blocks of K2 and K5 from their hits, chunk by chunk:
    ``chunks`` yields (t0, t1, hit, orig, set), the hits (nt, 128, width)
    bool of tiles [t0, t1) and the candidates' orig and F_SET (nt, 1,
    width), width in window order.  Block b keeps the hits whose F_SET is
    ``cand_sets[b]`` (all of them for ``None``), front-packs ``orig -
    cand_offsets[b]`` into rows of ``k8s[b]`` with -1 fill, and counts
    exactly past the cap; tiles no chunk covers (the dead ones) count 0.
    Returns counts (n_blocks, tiles_cap * 128) and one (tiles_cap, k8,
    128) array per block."""
    blocks = list(zip(cand_sets, cand_offsets, k8s))
    counts = torch.zeros((len(blocks), tiles_cap * TILE), dtype=torch.int32,
                         device=dev)
    nbrs = [torch.full((tiles_cap, k8, TILE), -1, dtype=torch.int32,
                       device=dev) for k8 in k8s]
    for t0, t1, hit, orig, c_set in chunks:
        for b, (set_id, offset, k8) in enumerate(blocks):
            mb = hit if set_id is None else hit & (c_set == set_id)
            counts[b, t0 * TILE:t1 * TILE] = \
                mb.sum(dim=2, dtype=torch.int32).reshape(-1)
            pos = torch.cumsum(mb, dim=2, dtype=torch.int32) - 1
            keep = mb & (pos < k8)
            rows = torch.full((t1 - t0, TILE, k8 + 1), -1, dtype=torch.int32,
                              device=dev)
            rows.scatter_(2, torch.where(keep, pos, k8).long(),
                          torch.where(keep, orig - offset, -1))
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
    blocks = _check_blocks(cand_sets, cand_offsets, k8s)
    if desc.device.type == "cpu":
        return pairs_nbrs_plain(desc, q_t, recs_t, n_win, tiles_cap, *blocks,
                                r2=r2, symmetric=symmetric)
    lib = _cuda_lib(desc)
    counts, nbrs, args = _block_outputs(blocks, tiles_cap, desc.device)
    stream = torch.cuda.current_stream(desc.device).cuda_stream
    err = lib.tns_pairs_nbrs(
        desc.data_ptr(), q_t.data_ptr(), recs_t.data_ptr(), n_rec, tiles_cap,
        n_win, float(r2 if r2 is not None else 0.0), int(r2 is None),
        int(symmetric), *args, stream)
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__} launch failed: CUDA error "
                           f"{err}")
    wrapper.launches += 1
    return counts, nbrs


def _check_blocks(cand_sets, cand_offsets, k8s) -> tuple:
    """The output blocks of K2b, K2c and K5 as three tuples of ints: 1 to
    8 distinct candidate sets, each with an offset and a k8."""
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
    return cand_sets, cand_offsets, k8s


def _block_outputs(blocks: tuple, tiles_cap: int, dev) -> tuple:
    """The outputs of a block kernel on the card and the launcher's block
    arguments: counts (n_blocks, tiles_cap * 128), one row array per
    block, and (n_blocks, set ids, offsets, k8s, row pointers, counts
    pointer) as C values."""
    cand_sets, cand_offsets, k8s = blocks
    nb = len(cand_sets)
    counts = torch.empty((nb, tiles_cap * TILE), dtype=torch.int32,
                         device=dev)
    nbrs = [torch.empty((tiles_cap, k8, TILE), dtype=torch.int32, device=dev)
            for k8 in k8s]

    def ints(vals):
        return (ctypes.c_int * nb)(*vals)

    ptrs = (ctypes.c_void_p * nb)(*[t.data_ptr() for t in nbrs])
    return counts, nbrs, (nb, ints(cand_sets), ints(cand_offsets), ints(k8s),
                          ptrs, counts.data_ptr())


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


# ------------------------------------------------------- K3 and K4 arguments
def check_active_args(desc, q_t, recs_t, n_win, tiles_cap, cand_sets,
                      allow, r2, symmetric) -> tuple:
    """Checks shared by K3 and K4, which apply the active matrix instead of
    writing blocks: ``cand_sets`` (0 to 8 distinct set ids, bit b of a
    query set's ``allow`` entry standing for ``cand_sets[b]``) and
    ``allow`` (n_sets,) int32.  Returns ``cand_sets`` as a tuple."""
    _check_desc(desc, tiles_cap)
    _check_recs(recs_t, desc.device)
    _require(q_t, "q_t", (N_FIELDS, tiles_cap * TILE), desc.device)
    _check_n_win(n_win)
    cand_sets = tuple(int(s) for s in cand_sets)
    if len(cand_sets) > MAX_BLOCKS or len(set(cand_sets)) != len(cand_sets):
        raise ValueError(f"0 to {MAX_BLOCKS} distinct candidate sets, got "
                         f"{cand_sets}")
    if allow.dim() != 1 or allow.shape[0] < 1:
        raise ValueError("allow must be (n_sets >= 1,), got "
                         f"{tuple(allow.shape)}")
    _require(allow, "allow", tuple(allow.shape), desc.device)
    if symmetric and r2 is not None:
        raise ValueError("symmetric search needs per-point radii (r2=None)")
    return cand_sets


def set_ids_arg(cand_sets) -> ctypes.Array:
    """The candidate sets as a C int array (at least one entry)."""
    return (ctypes.c_int * max(len(cand_sets), 1))(*cand_sets)


# ---------------------------------------------------------------- K4
def mask_cand_base(desc: torch.Tensor, n_rec: int, n_win: int,
                   tiles_cap: int) -> torch.Tensor:
    """Where each tile's rows start in K4's ``bits``: (tiles_cap + 1,)
    int64, the exclusive cumulative sum of each tile's clipped window
    lengths (0 for a dead tile); the last entry is the number of rows."""
    _, lens = clipped_windows(desc, n_rec, n_win, tiles_cap)
    base = torch.zeros(tiles_cap + 1, dtype=torch.int64, device=desc.device)
    torch.cumsum(lens.sum(dim=1, dtype=torch.int64), 0, out=base[1:])
    return base


def pairs_mask_plain(desc: torch.Tensor, q_t: torch.Tensor,
                     recs_t: torch.Tensor, n_win: int, tiles_cap: int,
                     cand_sets, allow: torch.Tensor, r2: float | None = None,
                     symmetric: bool = False, rows_cap: int | None = None):
    """Plain version of K4 over the candidates of ``_plain_chunks``, the
    active matrix applied (``allow_bits``).  Returns counts (tiles_cap *
    128,) int32, bits (rows, 4) int32 and ``cand_base``: candidate k of
    live tile t, in window order, owns row ``cand_base[t] + k``, and bit
    ``l % 32`` of its word ``l // 32`` says that query lane l hits it.
    With ``rows_cap`` bits has ``rows_cap`` rows: the rows at or past it
    are dropped, those past ``cand_base[-1]`` are 0; counts stay exact."""
    dev = desc.device
    cand_base = mask_cand_base(desc, recs_t.shape[1], n_win, tiles_cap)
    base = cand_base.tolist()
    n_rows = base[-1] if rows_cap is None else _check_rows_cap(rows_cap)
    counts = torch.zeros(tiles_cap * TILE, dtype=torch.int32, device=dev)
    bits = torch.zeros((n_rows, MASK_WORDS), dtype=torch.int32, device=dev)
    weight = torch.ones(32, dtype=torch.int64, device=dev) \
        << torch.arange(32, device=dev)
    for ch in _plain_chunks(desc, q_t, recs_t, n_win, tiles_cap, r2,
                            symmetric):
        m = ch.hit & allow_bits(ch, q_t, recs_t, cand_sets, allow)
        counts[ch.t0 * TILE:ch.t1 * TILE] = \
            m.sum(dim=2, dtype=torch.int32).reshape(-1)
        nt, width = ch.ok.shape
        words = (m.transpose(1, 2).reshape(nt, width, MASK_WORDS, 32)
                 .to(torch.int64) * weight).sum(dim=3)
        words = torch.where(words >= 1 << 31, words - (1 << 32), words)
        lo, hi = base[ch.t0], min(base[ch.t1], n_rows)
        if hi > lo:
            bits[lo:hi] = words[ch.ok][:hi - lo].to(torch.int32)
    return counts, bits, cand_base


def _check_rows_cap(rows_cap) -> int:
    rows_cap = int(rows_cap)
    if rows_cap < 0:
        raise ValueError(f"rows_cap must be >= 0, got {rows_cap}")
    return rows_cap


def pairs_mask(desc: torch.Tensor, q_t: torch.Tensor, recs_t: torch.Tensor,
               n_win: int, tiles_cap: int, cand_sets, allow: torch.Tensor,
               r2: float | None = None, symmetric: bool = False,
               rows_cap: int | None = None):
    """K4: exact per-query counts (tiles_cap * 128,) int32 and the hit
    bits (rows, 4) int32 of every candidate row, with ``cand_base``
    (``pairs_mask_plain`` has the layout).  ``r2=None`` takes the radii
    from the records' F_R field (K2c's criteria).  Without ``rows_cap``
    nothing is capped, so nothing can truncate, and sizing ``bits`` is one
    host read (refused under CUDA graph capture).  With it ``bits`` is
    (rows_cap, 4): the kernel writes no row at or past the cap (the rows
    past ``cand_base[-1]`` are undefined on the card), the counts stay
    exact, and ``cand_base[-1] > rows_cap`` says that rows were dropped."""
    cand_sets = check_active_args(desc, q_t, recs_t, n_win, tiles_cap,
                                  cand_sets, allow, r2, symmetric)
    if desc.device.type == "cpu":
        return pairs_mask_plain(desc, q_t, recs_t, n_win, tiles_cap,
                                cand_sets, allow, r2, symmetric, rows_cap)
    lib = _cuda_lib(desc)
    n_rec = recs_t.shape[1]
    cand_base = mask_cand_base(desc, n_rec, n_win, tiles_cap)
    if rows_cap is None:
        refuse_capture("pairs_mask without rows_cap (it sizes its bits "
                       "by the row count)", "pass a static rows_cap")
        n_rows = int(cand_base[-1])
    else:
        n_rows = _check_rows_cap(rows_cap)
    counts = torch.empty(tiles_cap * TILE, dtype=torch.int32,
                         device=desc.device)
    bits = torch.empty((n_rows, MASK_WORDS), dtype=torch.int32,
                       device=desc.device)
    stream = torch.cuda.current_stream(desc.device).cuda_stream
    err = lib.tns_pairs_mask(
        desc.data_ptr(), q_t.data_ptr(), recs_t.data_ptr(), n_rec, tiles_cap,
        n_win, float(r2 if r2 is not None else 0.0), int(r2 is None),
        int(symmetric), len(cand_sets), set_ids_arg(cand_sets),
        allow.data_ptr(), allow.shape[0], cand_base.data_ptr(), n_rows,
        counts.data_ptr(), bits.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"pairs_mask launch failed: CUDA error {err}")
    pairs_mask.launches += 1
    return counts, bits, cand_base


pairs_mask.launches = 0


# ---------------------------------------------------------------- K5
def pairs_nbrs_from_bits_plain(desc: torch.Tensor, recs_t: torch.Tensor,
                               bits: torch.Tensor, cand_base: torch.Tensor,
                               n_win: int, tiles_cap: int, cand_sets,
                               cand_offsets, k8s):
    """Plain version of K5: K4's hit bits (``pairs_mask_plain`` has the
    layout) unpacked into K2b's output blocks.  Candidate k of live tile
    t, in window order over the clipped windows, is record ``desc[t, w] +
    o`` and owns row ``cand_base[t] + k``; query lane l hits it when bit
    ``l % 32`` of the row's word ``l // 32`` is set (rows past ``bits``
    read as zero).  The hits go to ``_front_pack_blocks``: block b keeps
    those whose F_SET is ``cand_sets[b]``, front-packs ``orig -
    cand_offsets[b]`` in window order with -1 fill and counts exactly
    past the cap; dead tiles count 0."""
    dev = desc.device
    n_rows = bits.shape[0]
    starts, lens = clipped_windows(desc, recs_t.shape[1], n_win, tiles_cap)
    lmax = int(lens.max()) if tiles_cap > 0 else 0
    # a zero row past the last, read by padding and by rows past ``bits``
    words = torch.cat([bits, bits.new_zeros((1, MASK_WORDS))])
    win_base = cand_base[:tiles_cap, None] \
        + (torch.cumsum(lens, 1, dtype=torch.int64) - lens)
    off = torch.arange(lmax, dtype=torch.int32, device=dev)
    shift = torch.arange(32, dtype=torch.int32, device=dev)
    co, cs = recs_t[F_ORIG], recs_t[F_SET]
    per = max(1, _PLAIN_CHUNK_ELEMS // (TILE * n_win * max(lmax, 1)))

    def chunks():
        for t0 in range(0, tiles_cap if lmax else 0, per):
            t1 = min(t0 + per, tiles_cap)
            idx, ok = _chunk_slots(starts, lens, t0, t1, off)
            row = (win_base[t0:t1, :, None] + off[None, None, :]) \
                .reshape(t1 - t0, -1)
            row = torch.where(ok & (row < n_rows), row, n_rows)
            lanes = (words[row][..., None] >> shift) & 1
            hit = (lanes.reshape(*row.shape, TILE) != 0).transpose(1, 2) \
                & ok[:, None, :]
            yield t0, t1, hit, co[idx][:, None, :], cs[idx][:, None, :]

    return _front_pack_blocks(chunks(), tiles_cap, cand_sets, cand_offsets,
                              k8s, dev)


def pairs_nbrs_from_bits(desc: torch.Tensor, recs_t: torch.Tensor,
                         bits: torch.Tensor, cand_base: torch.Tensor,
                         n_win: int, tiles_cap: int, cand_sets, cand_offsets,
                         k8s):
    """K5, the second pass of split staging: K4's ``bits`` and
    ``cand_base`` (from ``pairs_mask`` on the same descriptors and
    records) into K2b's contract, counts (n_blocks, tiles_cap * 128) int32
    and per block rows (tiles_cap, k8s[b], 128) int32 of set-local
    indices.  The rows of an active pair equal the fused kernel's slot for
    slot; a query whose set does not search ``cand_sets[b]`` has no bits,
    so it counts 0 there where K2b would fill its block.  Rows of dead
    tiles are undefined on the card, as with K2."""
    _check_desc(desc, tiles_cap)
    n_rec = _check_recs(recs_t, desc.device)
    _check_n_win(n_win)
    if bits.dim() != 2 or bits.shape[1] != MASK_WORDS:
        raise ValueError(f"bits must be (rows, {MASK_WORDS}), got "
                         f"{tuple(bits.shape)}")
    _require(bits, "bits", tuple(bits.shape), desc.device)
    if cand_base.dtype != torch.int64 \
            or tuple(cand_base.shape) != (tiles_cap + 1,) \
            or not cand_base.is_contiguous() \
            or cand_base.device != desc.device:
        raise ValueError(f"cand_base must be a contiguous int64 "
                         f"({tiles_cap + 1},) tensor on {desc.device}")
    blocks = _check_blocks(cand_sets, cand_offsets, k8s)
    if desc.device.type == "cpu":
        return pairs_nbrs_from_bits_plain(desc, recs_t, bits, cand_base,
                                          n_win, tiles_cap, *blocks)
    lib = _cuda_lib(desc)
    if bits.data_ptr() % (4 * MASK_WORDS):
        raise ValueError("bits must start on a 16-byte boundary (the "
                         "kernel copies its rows whole)")
    counts, nbrs, args = _block_outputs(blocks, tiles_cap, desc.device)
    stream = torch.cuda.current_stream(desc.device).cuda_stream
    err = lib.tns_pairs_nbrs_from_bits(
        desc.data_ptr(), recs_t.data_ptr(), n_rec, tiles_cap, n_win,
        bits.data_ptr(), bits.shape[0], cand_base.data_ptr(), *args, stream)
    if err != 0:
        raise RuntimeError(f"pairs_nbrs_from_bits launch failed: CUDA error "
                           f"{err}")
    pairs_nbrs_from_bits.launches += 1
    return counts, nbrs


pairs_nbrs_from_bits.launches = 0
