"""The carried step's branch on a device predicate, eager or captured.

The JAX carried step picks between reusing the cell structure and
rebuilding it with ``jax.lax.cond`` on a device predicate
(``treensearch_tpu/ops/fastpath.py:1646-1650``): only the chosen branch
runs and the host never learns which.  ``rebuild_if`` is the port's
counterpart and the one place that chooses the branch:

- eagerly it reads the predicate once (``bool(pred)``) and runs the
  branch or not: PyTorch has no other way to skip work eagerly;
- under CUDA graph capture (``torch.cuda.graph``) it records the branch
  inside an IF conditional node on the predicate, so on every replay the
  device decides and the host reads nothing.  PyTorch 2.11 does not bind
  conditional nodes, so ``csrc/cond.cu`` makes them from the CUDA runtime
  (built by nvcc at first use, as the kernels are): the branch is captured
  on a stream of its own into the node's body graph, its temporaries come
  from a memory pool kept for the process (``torch.cuda.MemPool``), and
  CUDA graphs have IF/ELSE nodes only from 12.8, so the JAX two-branch
  cond is one IF on "rebuild", the reuse branch being empty.  The
  library, the stream and the pool are made at the first capture, so an
  eager search never depends on them.  Graphs whose bodies share that
  pool must not replay concurrently: replay them one after another on
  one stream.

A branch recorded in a conditional node must write its results into
tensors that exist before it (``assign_``): a tensor first allocated in
the body holds nothing on a replay that skipped it.

``capturing`` is the check every uncapturable path makes, and
``refuse_capture`` the error it raises: a path that reads the host under
capture raises ``ValueError`` naming what to use instead, never falls
back to a host read.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Callable, Sequence

import torch

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "cond.cu"
_BODY: dict = {}   # per device: the body's capture stream and memory pool
_LIB: list = []    # the loaded conditional library, once loaded


def capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph (False
    wherever PyTorch has no CUDA)."""
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def refuse_capture(what: str, instead: str) -> None:
    """Raise ``ValueError`` when called under CUDA graph capture: ``what``
    reads the host on every call, ``instead`` names what to capture."""
    if capturing():
        raise ValueError(f"{what} reads values back to the host and cannot "
                         f"be captured in a CUDA graph; {instead}")


def cond_library():
    """``csrc/cond.cu`` built (once per source hash) and loaded, with its
    build record (``pairs.build_library``'s)."""
    if not _LIB:
        from .pairs import build_library
        loaded = build_library("cond", SOURCE.read_bytes(), source=SOURCE)
        vp = ctypes.c_void_p
        loaded.lib.tns_cond_begin.argtypes = [vp, vp, vp]
        loaded.lib.tns_cond_begin.restype = ctypes.c_int
        loaded.lib.tns_cond_end.argtypes = [vp]
        loaded.lib.tns_cond_end.restype = ctypes.c_int
        _LIB.append(loaded)
    return _LIB[0]


def _body(device: torch.device) -> tuple:
    """The stream that captures a branch's body on ``device`` and the pool
    its temporaries come from, made once per process: the pool stays, so
    the addresses a graph recorded stay valid."""
    if device not in _BODY:
        with torch.cuda.device(device):
            _BODY[device] = (torch.cuda.Stream(device),
                             torch.cuda.MemPool())
    return _BODY[device]


def rebuild_if(pred: torch.Tensor, fn: Callable[[], None]) -> None:
    """Run ``fn()`` where the () bool tensor ``pred`` is true.  Eagerly
    one host read of ``pred``; under capture an IF node on the CUDA
    ``pred``, with ``fn``'s launches recorded into its body (inside ``fn``
    the current stream is the body's; the conditional library, the body's
    stream and its pool are made at the first capture).  ``fn`` returns
    nothing and writes its results into tensors made before the call.
    The bodies of every captured graph take their temporaries from one
    pool per device, so such graphs must not replay concurrently.
    Raises ``RuntimeError`` where PyTorch lacks what the node needs."""
    if not capturing():
        if bool(pred):
            fn()
        return
    if not (hasattr(torch.cuda, "MemPool")
            and hasattr(torch.cuda, "use_mem_pool")):
        raise RuntimeError(
            f"torch {torch.__version__} has no torch.cuda.MemPool for a "
            "conditional node's body; the carried step cannot be captured")
    if pred.device.type != "cuda" or pred.dtype != torch.bool \
            or pred.numel() != 1:
        raise ValueError("a captured branch needs a one-element CUDA bool "
                         f"predicate, got {pred.dtype} {tuple(pred.shape)} "
                         f"on {pred.device}")
    lib = cond_library().lib
    body, pool = _body(pred.device)
    outer = torch.cuda.current_stream(pred.device)
    err = lib.tns_cond_begin(outer.cuda_stream, pred.data_ptr(),
                             body.cuda_stream)
    if err != 0:
        raise RuntimeError(f"conditional node: CUDA error {err}")
    try:
        with torch.cuda.stream(body), \
                torch.cuda.use_mem_pool(pool, pred.device):
            fn()
    finally:
        err = lib.tns_cond_end(body.cuda_stream)
    if err != 0:
        raise RuntimeError(f"conditional node's body: CUDA error {err}")


def assign_(dst: Sequence[torch.Tensor], src: Sequence[torch.Tensor]) -> None:
    """Copy each tensor of ``src`` into its counterpart in ``dst`` (the
    fields of two NamedTuples of one type): the state update in place,
    one multi-tensor copy per dtype."""
    groups: dict = {}
    for d, s in zip(dst, src, strict=True):
        group = groups.setdefault(d.dtype, ([], []))
        group[0].append(d)
        group[1].append(s)
    for d, s in groups.values():
        torch._foreach_copy_(d, s)
