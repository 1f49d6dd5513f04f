"""Brute-force O(n^2) oracle: the correctness anchor of the port's tests
and of ``chip_smoke.py``'s small clouds.

The port's own copy of ``treensearch_tpu/oracle.py`` (the port imports
nothing of the JAX package), which re-implements the reference test
oracle (``tests/BruteforceNSearch.h:17-51``,
``tests/BruteforceNSearch.cpp:66-207``) in vectorized numpy:

  - self-exclusion by point identity (``BruteforceNSearch.cpp:86``): a
    point is never its own neighbor, but coincident points are neighbors,
  - inclusive ``d^2 <= r^2`` (``.cpp:97``) in float32 with the same
    evaluation order as the engine (``(dx*dx + dy*dy) + dz*dz``),
  - variable radius: ``d <= r_i``; symmetric mode ORs ``d <= r_j``
    (``.cpp:90-95``),
  - per-pair directed active-search matrix,
  - ``compare``: exact neighbor-SET equality per point (lists sorted
    before comparison, ``.cpp:117-165``) against an engine's
    ``get_neighborlist``,
  - ``check_for_symmetry`` (``.cpp:180-207``).

It imports numpy only.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


class BruteforceNSearch:
    """O(n^2) all-pairs neighbor search with reference oracle semantics."""

    def __init__(self, search_radius: Optional[float] = None,
                 symmetric: bool = True):
        self.search_radius = search_radius
        self.symmetric = symmetric
        self.sets: List[Tuple[np.ndarray, Optional[np.ndarray]]] = []
        self.active: np.ndarray = np.zeros((0, 0), dtype=bool)
        # neighbors[(si, sj)][i] -> sorted np.ndarray of set_j-local indices
        self.neighbors: Dict[Tuple[int, int], List[np.ndarray]] = {}

    def add_point_set(self, points, radii=None) -> int:
        pts = np.asarray(points, dtype=np.float32).reshape(-1, 3)
        rad = None if radii is None else \
            np.asarray(radii, dtype=np.float32).reshape(-1)
        self.sets.append((pts, rad))
        s = len(self.sets)
        grown = np.zeros((s, s), dtype=bool)
        grown[: s - 1, : s - 1] = self.active
        self.active = grown
        return s - 1

    def set_active_search(self, si: int, sj: int, active: bool = True):
        self.active[si, sj] = active

    def set_all_searches(self, active: bool = True):
        self.active[:, :] = active

    def run(self) -> None:
        self.neighbors = {}
        variable = any(r is not None for _, r in self.sets)
        for si, (pi, ri) in enumerate(self.sets):
            for sj, (pj, rj) in enumerate(self.sets):
                if not self.active[si, sj]:
                    continue
                lists: List[np.ndarray] = []
                if pi.shape[0] == 0 or pj.shape[0] == 0:
                    lists = [np.zeros((0,), np.int32)] * pi.shape[0]
                    self.neighbors[(si, sj)] = lists
                    continue
                # chunk rows to bound memory at larger n
                chunk = max(1, min(pi.shape[0],
                                   2_000_000 // max(pj.shape[0], 1) + 1))
                for a in range(0, pi.shape[0], chunk):
                    b = min(a + chunk, pi.shape[0])
                    dx = pj[None, :, 0] - pi[a:b, None, 0]
                    dy = pj[None, :, 1] - pi[a:b, None, 1]
                    dz = pj[None, :, 2] - pi[a:b, None, 2]
                    d2 = (dx * dx + dy * dy) + dz * dz  # f32, engine order
                    if variable:
                        mask = d2 <= (ri[a:b, None] ** 2)
                        if self.symmetric:
                            mask |= d2 <= (rj[None, :] ** 2)
                    else:
                        r2 = np.float32(self.search_radius) ** 2
                        mask = d2 <= r2
                    if si == sj:
                        for row in range(b - a):
                            mask[row, a + row] = False
                    for row in range(b - a):
                        lists.append(np.sort(np.nonzero(mask[row])[0])
                                     .astype(np.int32))
                self.neighbors[(si, sj)] = lists

    # ------------------------------------------------------------- checks
    def compare(self, engine, crash: bool = True) -> bool:
        """Exact neighbor-set parity vs a ``TreeNSearch`` engine, read
        through ``get_neighborlist(si, sj, i).to_numpy()`` (reference
        ``BruteforceNSearch::compare``, ``.cpp:117-165``)."""
        ok = True
        for (si, sj), lists in self.neighbors.items():
            for i, expected in enumerate(lists):
                got = np.sort(engine.get_neighborlist(si, sj, i).to_numpy())
                if got.shape != expected.shape or \
                        not np.array_equal(got, expected):
                    ok = False
                    if crash:
                        raise AssertionError(
                            f"neighbor mismatch pair ({si}->{sj}) point {i}: "
                            f"expected {expected.tolist()}, got "
                            f"{got.tolist()}")
        return ok

    def check_for_symmetry(self) -> bool:
        """Reciprocity check (reference ``.cpp:180-207``)."""
        for (si, sj), lists in self.neighbors.items():
            if (sj, si) not in self.neighbors:
                continue
            back = self.neighbors[(sj, si)]
            for i, nbrs in enumerate(lists):
                for j in nbrs:
                    if i not in back[j]:
                        return False
        return True
