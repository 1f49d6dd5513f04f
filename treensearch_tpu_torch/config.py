"""Static configuration of one search: set sizes, active pairs, radius
mode, stencil width, the neighbor caps and the search-based pipeline's
chunk, candidate cap and float64 switch.

PyTorch counterpart of ``treensearch_tpu/config.py``.  PyTorch runs
eagerly, so nothing here keys a compile cache; the fields still fix every
shape of a step (the caps size the padded-CSR rows), which keeps the
prep's shapes identical to the JAX prep and the step capturable as a CUDA
graph.  The host grows a cap when a run reports an overflow and re-runs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple


class SearchConfig(NamedTuple):
    """Static sizes of one search program."""

    set_sizes: Tuple[int, ...]           # points per set
    active_pairs: Tuple[Tuple[int, int], ...]  # ordered (set_i, set_j)
    stencil_w: int                       # stencil half-width in cells
    nbr_cap: int                         # max neighbors per (point, set_j)
    variable: bool = False               # per-point radii vs one radius
    symmetric: bool = False              # OR d^2 <= r_j^2 (variable only)
    # per-candidate-set caps (len n_sets); None = nbr_cap for every set
    nbr_caps: Optional[Tuple[int, ...]] = None
    # the search-based pipeline (ops/pipeline.py): query rows per chunk
    # (results do not depend on it), candidates kept per query (the host
    # regrows it from ``cand_max``), and d^2 in float64 (``run_scalar``
    # after ``set_scalar_double_accum(True)``); the defaults are the JAX
    # package's run_scalar values (treensearch_tpu/api.py:60-62)
    chunk: int = 128
    cand_cap: int = 512
    scalar_f64: bool = False

    @property
    def n_sets(self) -> int:
        return len(self.set_sizes)

    @property
    def n_points(self) -> int:
        return sum(self.set_sizes)

    @property
    def set_offsets(self) -> Tuple[int, ...]:
        off = [0]
        for s in self.set_sizes:
            off.append(off[-1] + s)
        return tuple(off)

    def cap_of(self, set_j: int) -> int:
        return self.nbr_caps[set_j] if self.nbr_caps is not None \
            else self.nbr_cap


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
