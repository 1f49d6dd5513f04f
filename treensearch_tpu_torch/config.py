"""Static configuration of one search: set sizes, active pairs, stencil
width and the neighbor cap.

PyTorch counterpart of ``treensearch_tpu/config.py``.  PyTorch runs
eagerly, so nothing here keys a compile cache; the fields still fix every
shape of a step (``nbr_cap`` sizes the padded-CSR rows), which keeps the
prep's shapes identical to the JAX prep and the step capturable as a CUDA
graph.  The host grows a cap when a run reports an overflow and re-runs.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple


class SearchConfig(NamedTuple):
    """Static sizes of one search program."""

    set_sizes: Tuple[int, ...]           # points per set
    active_pairs: Tuple[Tuple[int, int], ...]  # ordered (set_i, set_j)
    stencil_w: int                       # stencil half-width in cells
    nbr_cap: int                         # max neighbors per (point, set_j)

    @property
    def n_points(self) -> int:
        return sum(self.set_sizes)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
