"""Point quantization onto the uniform cell grid.

PyTorch counterpart of ``treensearch_tpu/utils/keys.py:32-46``.  Points
are quantized to at most 2**15 cells per axis, the reference's domain
limit (``TreeNSearch.cpp:510-515``).  Morton keys and the two-word search
belong to the z-sort and scalar slices.
"""

from __future__ import annotations

import torch

MAX_CELLS_PER_DIM = 1 << 15


def quantize(points: torch.Tensor, grid_min: torch.Tensor,
             inv_cell: torch.Tensor, n_cells: torch.Tensor) -> torch.Tensor:
    """Quantize float32 points (N, 3) to int32 cell coords (N, 3).

    ``floor((p - min) * inv_cell)``, clamped to ``[0, n_cells - 1]``: the
    subtraction and the multiplication round separately (no contraction
    is possible), so cell ids are bit-identical to the JAX package on any
    device.  The clamp runs before the int32 conversion, so a coordinate
    far outside the grid cannot wrap.
    """
    f = torch.floor((points - grid_min[None, :]) * inv_cell)
    hi = (n_cells - 1).to(torch.float32)
    return torch.minimum(torch.clamp(f, min=0.0), hi[None, :]).to(torch.int32)
