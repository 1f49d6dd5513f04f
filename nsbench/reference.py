"""Plain PyTorch reference of what the benchmark judges.

- ``neighbor_keys``: the exact fixed-radius neighbor sets, by a cell-list
  grid search over the 27 cells around each query, in blocks of
  candidates, under the float32 rule ``(dx*dx + dy*dy) + dz*dz <= r*r``
  (each product and sum rounded on its own, ``r*r`` the float32 square of
  the float32 radius), self excluded within one set;
- ``pair_sums``: a per-query sum of a callback over those pairs, in
  float64;
- ``morton_keys``: the Morton (Z-curve) key of each point at 2**20 cells
  per axis over a box, the i axis in the lowest bit of each triple;
- ``advance``: the benchmark's advection, ``x <- (x + v) mod 1``.

It imports torch and numpy only: nothing of the program under test.  The
same functions, given ``dtype=torch.bfloat16``, are the control that has
to come out as not correct.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_CANDIDATES = 1 << 25   # candidate pairs tested at a time
STENCIL = torch.tensor([(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
                        for c in (-1, 0, 1)], dtype=torch.int64)
MORTON_BITS = 20


def r2_of(radius: float, dtype=torch.float32) -> torch.Tensor:
    """The square of the radius, rounded to ``dtype`` after each step."""
    r = torch.tensor(radius, dtype=torch.float64).to(dtype)
    return r * r


def advance(x: torch.Tensor, v: torch.Tensor, steps: int) -> torch.Tensor:
    """``steps`` moves of ``x`` by ``v`` on the periodic unit box."""
    for _ in range(steps):
        x = torch.remainder(x + v, 1.0)
    return x


class _Grid:
    """Candidates sorted by cell on a grid of cells of at least the
    radius, with each cell's start and count."""

    def __init__(self, c: torch.Tensor, lo: torch.Tensor, cell: float,
                 dims: torch.Tensor):
        self.lo, self.cell, self.dims = lo, cell, dims
        lin = self.linear(self.cells(c))
        self.order = torch.sort(lin, stable=True).indices
        self.count = torch.bincount(lin, minlength=int(dims.prod()))
        self.start = torch.cumsum(self.count, 0) - self.count

    def cells(self, p: torch.Tensor) -> torch.Tensor:
        ijk = torch.floor((p.double() - self.lo) / self.cell).long()
        return torch.minimum(torch.clamp(ijk, min=0), self.dims - 1)

    def linear(self, ijk: torch.Tensor) -> torch.Tensor:
        return (ijk[..., 0] * self.dims[1] + ijk[..., 1]) * self.dims[2] \
            + ijk[..., 2]

    def stencil(self, ijk: torch.Tensor) -> tuple:
        """(start, count) of the 27 cells around each cell (m, 27); cells
        outside the grid count 0."""
        nb = ijk[:, None, :] + STENCIL.to(ijk.device)[None, :, :]
        inside = ((nb >= 0) & (nb < self.dims)).all(dim=2)
        lin = self.linear(torch.minimum(torch.clamp(nb, min=0),
                                        self.dims - 1))
        return self.start[lin], self.count[lin] * inside


def _grid_of(q: torch.Tensor, c: torch.Tensor, radius: float) -> _Grid:
    both = torch.cat([q, c]).double()
    lo, hi = both.amin(dim=0), both.amax(dim=0)
    cell = 1.01 * radius   # at least r with room for rounding
    dims = torch.floor((hi - lo) / cell).long() + 1
    return _Grid(c, lo, cell, dims)


def candidate_blocks(q: torch.Tensor, c: torch.Tensor, radius: float,
                     max_candidates: int = MAX_CANDIDATES):
    """Yields ``(qi, cj)`` int64 index blocks of every query paired with
    every candidate in the 27 cells around its own, queries ascending
    from block to block."""
    if q.shape[0] == 0 or c.shape[0] == 0:
        return
    grid = _grid_of(q, c, radius)
    q_cells = grid.cells(q)
    per_query = torch.cat([grid.stencil(q_cells[s:s + (1 << 20)])[1].sum(1)
                           for s in range(0, q.shape[0], 1 << 20)])
    ends = torch.cumsum(per_query, 0)
    first = 0
    while first < q.shape[0]:
        base = int(ends[first - 1]) if first else 0
        last = int(torch.searchsorted(ends, base + max_candidates,
                                      right=True))
        last = min(max(last, first + 1), q.shape[0])
        start, count = grid.stencil(q_cells[first:last])
        count = count.reshape(-1)
        total = int(count.sum())
        row = torch.repeat_interleave(
            torch.arange(count.shape[0], device=q.device), count,
            output_size=total)
        offset = torch.cumsum(count, 0) - count
        pos = torch.arange(total, device=q.device) - offset[row]
        cj = grid.order[start.reshape(-1)[row] + pos]
        yield first + row // 27, cj
        first = last


def _d2(q: torch.Tensor, c: torch.Tensor, qi, cj, dtype) -> torch.Tensor:
    qd, cd = q.to(dtype), c.to(dtype)
    dx = cd[cj, 0] - qd[qi, 0]
    dy = cd[cj, 1] - qd[qi, 1]
    dz = cd[cj, 2] - qd[qi, 2]
    return (dx * dx + dy * dy) + dz * dz


def hit_blocks(q: torch.Tensor, c: torch.Tensor, radius: float,
               same_set: bool, dtype=torch.float32,
               max_candidates: int = MAX_CANDIDATES):
    """Yields ``(qi, cj)`` blocks of the pairs within the radius under the
    rule in ``dtype``; with ``same_set`` a point is not its own
    neighbor."""
    r2 = r2_of(radius, dtype).to(q.device)
    for qi, cj in candidate_blocks(q, c, radius, max_candidates):
        hit = _d2(q, c, qi, cj, dtype) <= r2
        if same_set:
            hit &= qi != cj
        yield qi[hit], cj[hit]


def neighbor_keys(q: torch.Tensor, c: torch.Tensor, radius: float,
                  same_set: bool, dtype=torch.float32,
                  max_candidates: int = MAX_CANDIDATES) -> tuple:
    """``(counts, keys)``: the number of neighbors of each query (int64)
    and the sorted int64 keys ``query << 32 | neighbor`` of every pair."""
    counts = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    keys = []
    for qi, cj in hit_blocks(q, c, radius, same_set, dtype, max_candidates):
        counts += torch.bincount(qi, minlength=q.shape[0])
        keys.append(torch.sort((qi << 32) | cj).values)
    keys = torch.cat(keys) if keys else \
        torch.zeros(0, dtype=torch.int64, device=q.device)
    return counts, keys


def pair_sums(fn, n_out: int, q: torch.Tensor, c: torch.Tensor,
              radius: float, same_set: bool, payload_q: torch.Tensor,
              payload_c: torch.Tensor, dtype=torch.float64,
              rule_dtype=torch.float32,
              max_candidates: int = MAX_CANDIDATES) -> tuple:
    """``(sums, magnitudes, pairs)``: ``fn(env)`` summed over each query's
    neighbors in ``dtype`` and the sum of the terms' absolute values, each
    (n_out, n_q), and the number of neighbor pairs.  The neighbors are
    decided under the rule in ``rule_dtype``; ``env`` holds ``dx dy dz`` (candidate minus query), ``d2`` and the
    payloads ``p0_i p1_i p0_j p1_j`` in ``dtype``."""
    sums = torch.zeros((n_out, q.shape[0]), dtype=dtype, device=q.device)
    mags = torch.zeros_like(sums)
    qd, cd = q.to(dtype), c.to(dtype)
    pq, pc = payload_q.to(dtype), payload_c.to(dtype)
    pairs = 0
    for qi, cj in hit_blocks(q, c, radius, same_set, rule_dtype,
                             max_candidates):
        dx = cd[cj, 0] - qd[qi, 0]
        dy = cd[cj, 1] - qd[qi, 1]
        dz = cd[cj, 2] - qd[qi, 2]
        env = {"dx": dx, "dy": dy, "dz": dz,
               "d2": (dx * dx + dy * dy) + dz * dz,
               "p0_i": pq[qi, 0], "p1_i": pq[qi, 1],
               "p0_j": pc[cj, 0], "p1_j": pc[cj, 1]}
        pairs += int(qi.shape[0])
        out = fn(env)
        out = out if isinstance(out, tuple) else (out,)
        if len(out) != n_out:
            raise ValueError(f"the callback returned {len(out)} values, "
                             f"expected {n_out}")
        for k, term in enumerate(out):
            term = term.to(dtype)
            sums[k].index_add_(0, qi, term)
            mags[k].index_add_(0, qi, term.abs())
    return sums, mags, pairs


def morton_keys(p: torch.Tensor, box_min: torch.Tensor,
                box_max: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """int64 Morton key of each point (n, 3) at 2**20 cells per axis over
    the box: ``trunc(clip((p - min) * (2**20 / extent), 0, 2**20 - 1))``
    per axis, the extent the box's widest side, then bit b of axes i, j, k
    at positions 3b, 3b + 1, 3b + 2."""
    p, box_min, box_max = p.to(dtype), box_min.to(dtype), box_max.to(dtype)
    extent = torch.clamp(torch.max(box_max - box_min), min=1e-30)
    scale = torch.full_like(extent, float(1 << MORTON_BITS)) / extent
    ijk = torch.clamp((p - box_min[None, :]) * scale, 0,
                      (1 << MORTON_BITS) - 1).to(torch.int64)
    key = torch.zeros(p.shape[0], dtype=torch.int64, device=p.device)
    for b in range(MORTON_BITS):
        for axis in range(3):
            key |= ((ijk[:, axis] >> b) & 1) << (3 * b + axis)
    return key


def box_of(sets: list) -> tuple:
    """The smallest box around every point of the non-empty sets."""
    live = [p for p in sets if p.shape[0]]
    lo = torch.stack([p.amin(dim=0) for p in live]).amin(dim=0)
    hi = torch.stack([p.amax(dim=0) for p in live]).amax(dim=0)
    return lo, hi


def brute_force_keys(q: np.ndarray, c: np.ndarray, radius: float,
                     same_set: bool) -> tuple:
    """``neighbor_keys`` by testing every pair, in numpy, for tests on
    small clouds."""
    q, c = q.astype(np.float32), c.astype(np.float32)
    d = c[None, :, :] - q[:, None, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    r = np.float32(radius)
    hit = d2 <= r * r
    if same_set:
        np.fill_diagonal(hit, False)
    qi, cj = np.nonzero(hit)
    keys = np.sort((qi.astype(np.int64) << 32) | cj.astype(np.int64))
    return hit.sum(1).astype(np.int64), keys
