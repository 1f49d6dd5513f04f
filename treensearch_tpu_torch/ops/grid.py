"""World-box tracking with hysteresis.

PyTorch counterpart of ``treensearch_tpu/ops/grid.py:32-106`` (the
reference's ``_update_world_AABB``, ``TreeNSearch.cpp:415-645``): a
min/max reduce over all points; the previous grid is kept when the new
tight box still fits inside it (``TreeNSearch.cpp:474-487``); otherwise
the box grows by ``DOMAIN_ENLARGEMENT`` about its centre, with at least
one cell of slack.  More than 2**15 cells per axis sets the error flag,
which the host API raises on.  Every field stays a device tensor, so the
update needs no host sync.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.keys import MAX_CELLS_PER_DIM

DOMAIN_ENLARGEMENT = 1.1  # reference default (TreeNSearch.h:401)


class GridState(NamedTuple):
    """Grid state carried between runs (device scalars / small tensors)."""
    valid: torch.Tensor      # () bool: grid_min/n_cells hold a usable grid
    grid_min: torch.Tensor   # (3,) f32: origin of cell (0, 0, 0)
    grid_max: torch.Tensor   # (3,) f32: end of the gridded region
    n_cells: torch.Tensor    # (3,) i32: cells per axis
    cell_size: torch.Tensor  # () f32
    error: torch.Tensor      # () i32: 1 = domain exceeds MAX_CELLS_PER_DIM


def fresh_state(device="cpu") -> GridState:
    return GridState(
        valid=torch.zeros((), dtype=torch.bool, device=device),
        grid_min=torch.zeros(3, dtype=torch.float32, device=device),
        grid_max=torch.zeros(3, dtype=torch.float32, device=device),
        n_cells=torch.ones(3, dtype=torch.int32, device=device),
        cell_size=torch.ones((), dtype=torch.float32, device=device),
        error=torch.zeros((), dtype=torch.int32, device=device),
    )


def update_grid(state: GridState, points: torch.Tensor,
                cell_size: torch.Tensor) -> GridState:
    """New grid state from points (N, 3) f32 and the cell size, a ()
    float32 tensor on the points' device (a search's constant, so the
    update copies nothing from the host; the new state's ``cell_size`` is
    that tensor).

    Same float32 operations in the same order as the JAX function, so
    ``grid_min``, ``n_cells`` and ``error`` are bit-identical; ``grid_max``
    (a mul+add that XLA may contract to an FMA) may differ by one ulp.
    """
    dev = points.device
    cs = cell_size
    if points.shape[0] == 0:
        # degenerate: a one-cell grid at the origin; nothing is searched
        return GridState(
            valid=torch.ones((), dtype=torch.bool, device=dev),
            grid_min=torch.zeros(3, dtype=torch.float32, device=dev),
            grid_max=cs.expand(3).clone(),
            n_cells=torch.ones(3, dtype=torch.int32, device=dev),
            cell_size=cs,
            error=torch.zeros((), dtype=torch.int32, device=dev),
        )

    tight_min = points.amin(dim=0)
    tight_max = points.amax(dim=0)
    keep = (state.valid
            & (state.cell_size == cs)
            & torch.all(tight_min >= state.grid_min)
            & torch.all(tight_max <= state.grid_max))

    center = 0.5 * (tight_min + tight_max)
    half = 0.5 * DOMAIN_ENLARGEMENT * (tight_max - tight_min)
    half = torch.maximum(half, 0.5 * cs)
    new_min = center - half
    new_n_cells_f = torch.ceil((2.0 * half) / cs)
    overflow = torch.any(new_n_cells_f > MAX_CELLS_PER_DIM) & ~keep
    new_n_cells = torch.clamp(new_n_cells_f, 1.0,
                              float(MAX_CELLS_PER_DIM)).to(torch.int32)
    new_max = new_min + new_n_cells.to(torch.float32) * cs

    return GridState(
        valid=torch.ones((), dtype=torch.bool, device=dev),
        grid_min=torch.where(keep, state.grid_min, new_min),
        grid_max=torch.where(keep, state.grid_max, new_max),
        n_cells=torch.where(keep, state.n_cells, new_n_cells),
        cell_size=cs,
        error=torch.maximum(state.error, overflow.to(torch.int32)),
    )
