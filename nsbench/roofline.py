"""The least time the card could take for a search step's pairs kernel,
worked out from the benchmark's inputs alone.

Operations: the distance tests the inputs need, 9 float32 operations each
(three differences, three products, two sums, one compare): each query
against the candidates of the sets it searches in the 27 cells around its
own cell, on a grid of the configuration's cell size whose origin is the
smallest coordinate of all points, itself left out; a reduce step adds
the traffic's operations per neighbor pair found.

Bytes: every point's coordinates read once; a list step writes each
active pair's counts (4 B per query) and 4 B per neighbor pair found; a
reduce step reads its payload and writes ``n_out`` float32 sums per
query.  Padding and re-reads are not counted, so the count stays the same
whatever implements the search.

Peaks: the NVIDIA H100 SXM's published float32 rate outside the tensor
cores and its HBM3 bandwidth, at the full 700 W power limit.
"""

from __future__ import annotations

import torch

PEAK_FLOPS = 67e12        # float32, non-tensor-core, H100 SXM
PEAK_BYTES_PER_S = 3.35e12
OPS_PER_TEST = 9


def _histogram(p: torch.Tensor, lo: torch.Tensor, cell: float,
               dims: torch.Tensor) -> torch.Tensor:
    ijk = torch.floor((p.double() - lo) / cell).long()
    ijk = torch.minimum(torch.clamp(ijk, min=0), dims - 1)
    lin = (ijk[:, 0] * dims[1] + ijk[:, 1]) * dims[2] + ijk[:, 2]
    return torch.bincount(lin, minlength=int(dims.prod())).reshape(
        *dims.tolist())


def _box27(h: torch.Tensor) -> torch.Tensor:
    """Each cell's sum over the 27 cells around it (outside counts 0)."""
    a, b, c = h.shape
    pad = torch.zeros((a + 2, b + 2, c + 2), dtype=h.dtype, device=h.device)
    pad[1:-1, 1:-1, 1:-1] = h
    out = torch.zeros_like(h)
    for i in range(3):
        for j in range(3):
            for k in range(3):
                out += pad[i:i + a, j:j + b, k:k + c]
    return out


def stencil_tests(sets: list, active: list, cell: float) -> int:
    """Distance tests of the active ``(i, j)`` pairs of point sets
    ``sets``: each point of set i against the points of set j in the 27
    cells around its own, itself left out."""
    live = [p for p in sets if p.shape[0]]
    if not live:
        return 0
    lo = torch.stack([p.double().amin(dim=0) for p in live]).amin(dim=0)
    hi = torch.stack([p.double().amax(dim=0) for p in live]).amax(dim=0)
    dims = torch.floor((hi - lo) / cell).long() + 1
    hist = [_histogram(p, lo, cell, dims) for p in sets]
    boxed = {}
    tests = 0
    for i, j in active:
        if j not in boxed:
            boxed[j] = _box27(hist[j])
        tests += int((hist[i] * boxed[j]).sum())
        if i == j:
            tests -= sets[i].shape[0]
    return tests


def least_time(tests: int, hits: int, n_points: int, n_queries: int,
               ops_per_hit: int = 0, payload_columns: int = 0,
               n_out: int = 0) -> dict:
    """The bound of one step: ``tests`` distance tests and ``hits``
    neighbor pairs found over all active pairs, ``n_points`` points read
    and ``n_queries`` query rows written (one per query and active pair);
    ``n_out`` > 0 makes it a reduce step, which reads ``payload_columns``
    float32 values per point and writes ``n_out`` sums per query row."""
    ops = tests * OPS_PER_TEST + hits * ops_per_hit
    moved = 12 * n_points
    if n_out:
        moved += 4 * payload_columns * n_points + 4 * n_out * n_queries
    else:
        moved += 4 * n_queries + 4 * hits
    t_ops, t_bytes = ops / PEAK_FLOPS, moved / PEAK_BYTES_PER_S
    return {"tests": tests, "hits": hits, "ops": ops, "bytes": moved,
            "least_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
