"""Neighbor-list views over the padded-CSR solution.

PyTorch counterpart of ``treensearch_tpu/neighborlist.py``: per active
pair (set_i, set_j) the solution holds ``counts`` (n_i,) and tile-layout
neighbor rows that ``materialize_nbrs`` turns into (n_i, cap) rows with -1
padding.  ``NeighborList`` handles mirror the reference's
``NeighborList.h:8-39``; ``get_neighbors_device`` keeps everything on the
device as torch tensors.  ``ShardedSolution`` is a mesh run's form, which
gathers each rank's rows on demand.
"""

from __future__ import annotations

import numpy as np

from .ops.fastpath import materialize_nbrs


class NeighborList:
    """Neighbors in set_j of one point of set_i (indices local to set_j,
    unsorted, like the reference's SIMD output)."""

    __slots__ = ("_ids",)

    def __init__(self, ids: np.ndarray):
        self._ids = ids

    def size(self) -> int:
        return int(self._ids.shape[0])

    def __len__(self) -> int:
        return self.size()

    def __getitem__(self, k: int) -> int:
        return int(self._ids[k])

    def __iter__(self):
        return iter(self._ids.tolist())

    def to_numpy(self) -> np.ndarray:
        return self._ids

    def __repr__(self):
        return f"NeighborList(n={self.size()})"


def _inactive(si: int, sj: int) -> KeyError:
    return KeyError(f"search ({si} -> {sj}) is not active; activate it with "
                    "set_active_search before run()")


class NeighborSolution:
    """One run's results for all active pairs; each pair's arrays are
    copied to the host at most once."""

    def __init__(self, pairs_device: dict):
        self._dev = pairs_device
        self._np_cache: dict = {}

    def _pair(self, si: int, sj: int) -> dict:
        key = f"{si}-{sj}"
        if key not in self._dev:
            raise _inactive(si, sj)
        return self._dev[key]

    def _fetch(self, si: int, sj: int):
        key = f"{si}-{sj}"
        if key not in self._np_cache:
            p = self._pair(si, sj)
            self._np_cache[key] = (p["counts"].cpu().numpy(),
                                   materialize_nbrs(p).cpu().numpy())
        return self._np_cache[key]

    def get_neighborlist(self, si: int, sj: int, i: int) -> NeighborList:
        counts, nbrs = self._fetch(si, sj)
        return NeighborList(nbrs[i, : counts[i]])

    def get_padded(self, si: int, sj: int) -> np.ndarray:
        """The pair's padded rows (n_i, cap) on the host, -1 past each
        count."""
        return self._fetch(si, sj)[1]

    def get_counts(self, si: int, sj: int) -> np.ndarray:
        """Counts without materializing the neighbor rows."""
        return self._pair(si, sj)["counts"].cpu().numpy()

    def get_neighbors_device(self, si: int, sj: int):
        """Device tensors ``(counts (n_i,), nbrs (n_i, cap))``."""
        p = self._pair(si, sj)
        return p["counts"], materialize_nbrs(p)

    def n_bytes(self) -> int:
        """Bytes of the per-point neighbor lists (reference
        ``get_neighborlist_n_bytes``, ``TreeNSearch.cpp:254-261``): per
        active pair the counts and n_i x cap rows, 4 bytes each, whether
        the rows are materialised or still in tile layout (the view's
        size, not the shared tile storage)."""
        total = 0
        for p in self._dev.values():
            n = p["counts"].numel()
            cap = p["nbrs"].shape[1] if "nbrs" in p \
                else p["nbrs_tiles"].shape[1]
            total += 4 * n * (1 + cap)
        return total


class ShardedSolution(NeighborSolution):
    """A mesh run's results (``parallel/sharded.py``): on each rank every
    pair holds the counts and rows of the rank's own points of its query
    set, and ``rows``, the number each rank holds.  A pair's first getter
    call gathers every rank's rows (``gather(tensor, rows)``), so the
    getters are collective: every rank calls them alike, as it calls the
    search."""

    def __init__(self, pairs_local: dict, gather):
        super().__init__({})
        self._local = pairs_local
        self._gather = gather

    def _pair(self, si: int, sj: int) -> dict:
        key = f"{si}-{sj}"
        if key not in self._local:
            raise _inactive(si, sj)
        if key not in self._dev:
            p = self._local[key]
            self._dev[key] = {"counts": self._gather(p["counts"], p["rows"]),
                              "nbrs": self._gather(p["nbrs"], p["rows"])}
        return self._dev[key]

    def n_bytes(self) -> int:
        """``NeighborSolution.n_bytes`` over every rank's rows; no
        collective."""
        return sum(4 * sum(p["rows"]) * (1 + p["nbrs"].shape[1])
                   for p in self._local.values())
