"""The least time the card could take for a search step's pairs kernel,
worked out from the benchmark's inputs alone.

Operations: the distance tests the inputs need, 9 float32 operations each
(three differences, three products, two sums, one compare; symmetric
search compares against ``r_j*r_j`` too, 10): each query against the
candidates of the sets it searches in the box of cells its reach covers
around its own cell (its radius, with symmetric search the larger of it
and the candidate set's largest radius; 27 cells where the cell is at
least that), on a grid of the configuration's cell size whose origin is
the smallest coordinate of all points, itself left out; a reduce step
adds the traffic's operations per neighbor pair found.  The count
follows the configuration's cell size: a cell wider than the radius
counts candidates that no radius reaches, so where the operations bound
the least time, the kernel's share of it reads higher than the tests the
rule needs would make it.

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


def _box(h: torch.Tensor, w: int) -> torch.Tensor:
    """Each cell's sum over the cells within ``w`` of it along every axis
    (outside counts 0)."""
    out = h
    for axis in range(3):
        n = out.shape[axis]
        shape = list(out.shape)
        shape[axis] = 1
        ends = torch.cat([torch.zeros(shape, dtype=h.dtype, device=h.device),
                          torch.cumsum(out, axis)], axis)
        at = torch.arange(n, device=h.device)
        out = ends.index_select(axis, torch.clamp(at + w + 1, max=n)) \
            - ends.index_select(axis, torch.clamp(at - w, min=0))
    return out


def _reach_cells(reach: torch.Tensor, cell: float) -> torch.Tensor:
    """The least ``w >= 1`` with ``w * cell >= reach``, per point."""
    return torch.clamp(torch.ceil(reach.double() / cell), min=1).long()


def stencil_tests(sets: list, active: list, cell: float, radii: list,
                  symmetric: bool = False) -> int:
    """Distance tests of the active ``(i, j)`` pairs of point sets
    ``sets`` with per-point ``radii``: each point of set i against the
    points of set j in the box of ``_reach_cells`` cells around its own,
    its reach ``r_i`` or, with ``symmetric``, the larger of ``r_i`` and
    set j's largest radius; itself left out."""
    live = [p for p in sets if p.shape[0]]
    if not live:
        return 0
    lo = torch.stack([p.double().amin(dim=0) for p in live]).amin(dim=0)
    hi = torch.stack([p.double().amax(dim=0) for p in live]).amax(dim=0)
    dims = torch.floor((hi - lo) / cell).long() + 1
    hist = [_histogram(p, lo, cell, dims) for p in sets]
    tests = 0
    for i, j in active:
        reach = radii[i]
        if symmetric and radii[j].numel():
            reach = torch.clamp(reach, min=float(radii[j].max()))
        w = _reach_cells(reach, cell)
        for wk in torch.unique(w).tolist():
            h = _histogram(sets[i][w == wk], lo, cell, dims)
            tests += int((h * _box(hist[j], wk)).sum())
        if i == j:
            tests -= sets[i].shape[0]
    return tests


def least_time(tests: int, hits: int, n_points: int, n_queries: int,
               ops_per_hit: int = 0, payload_columns: int = 0,
               n_out: int = 0, symmetric: bool = False) -> dict:
    """The bound of one step: ``tests`` distance tests and ``hits``
    neighbor pairs found over all active pairs, ``n_points`` points read
    and ``n_queries`` query rows written (one per query and active pair);
    ``n_out`` > 0 makes it a reduce step, which reads ``payload_columns``
    float32 values per point and writes ``n_out`` sums per query row;
    ``symmetric`` adds the second compare to each test."""
    ops = tests * (OPS_PER_TEST + symmetric) + hits * ops_per_hit
    moved = 12 * n_points
    if n_out:
        moved += 4 * payload_columns * n_points + 4 * n_out * n_queries
    else:
        moved += 4 * n_queries + 4 * hits
    t_ops, t_bytes = ops / PEAK_FLOPS, moved / PEAK_BYTES_PER_S
    return {"tests": tests, "hits": hits, "ops": ops, "bytes": moved,
            "least_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
