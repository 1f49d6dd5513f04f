"""Z-curve (Morton) reordering of user arrays: the z-sort subsystem.

PyTorch counterpart of ``treensearch_tpu/ops/zsort.py`` (reference
``prepare_zsort`` / ``apply_zsort`` / ``get_zsort_order``,
``TreeNSearch.cpp:2571-2716``, ``TreeNSearch.h:443-481``).  Plain tensor
functions on the device of their inputs; the JAX package has no Pallas
kernel here either (``lax.sort`` and ``jnp.take``), so the sort is a
stable ``torch.sort`` of the two Morton words folded into one int64
(``utils/keys.py``) and the gathers are ``index_select``.

Two orders, each bit-identical to the JAX package's:

- per point (``zsort_order(s)``): the exact Morton order at 2**20 cells
  per axis over the world box, the reference's refined no-tree path
  (``TreeNSearch.cpp:2663-2716``).  The quantization is
  ``trunc(clip((p - box_min) * scale, 0, 2**20 - 1))`` with ``scale`` one
  float32 division of 2**20 by the float32 extent; the subtraction and
  the multiplication are separate eager operations, so no FMA can
  contract them on any device;
- per cell (``zsort_orders_from_cells``): the carried padded cell ids of
  the last search, decoded and sorted at cell granularity, the
  reference's cells fast path (``TreeNSearch.cpp:2598-2657``).

None of these functions reads a value back to the host.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..utils import keys as K

_ZSORT_BITS = 20


def _stable_order(ijk: torch.Tensor, bits: int) -> torch.Tensor:
    """int32 new_to_old permutation: the stable sort of the Morton keys
    of int32 coords (n, 3)."""
    hi, lo = K.morton_keys_2word(ijk, bits=bits)
    order = torch.sort(K.key64(hi, lo), stable=True).indices
    return order.to(torch.int32)


def _empty_order(device) -> torch.Tensor:
    return torch.zeros(0, dtype=torch.int32, device=device)


def zsort_order(points: torch.Tensor, box_min: torch.Tensor,
                box_max: torch.Tensor) -> torch.Tensor:
    """new_to_old permutation (int32) of one float32 point set (n, 3)
    over the world box ``[box_min, box_max]`` (two float32 (3,))."""
    if points.shape[0] == 0:
        return _empty_order(points.device)
    extent = torch.clamp(torch.max(box_max - box_min), min=1e-30)
    scale = torch.full_like(extent, float(1 << _ZSORT_BITS)) / extent
    q = torch.clamp((points - box_min[None, :]) * scale, 0,
                    (1 << _ZSORT_BITS) - 1).to(torch.int32)
    return _stable_order(q, _ZSORT_BITS)


def zsort_orders(points_list: Sequence[torch.Tensor], box_min: torch.Tensor,
                 box_max: torch.Tensor) -> List[torch.Tensor]:
    """Per-set new_to_old permutations over one world box."""
    return [zsort_order(p, box_min, box_max) for p in points_list]


def world_box(points_list: Sequence[torch.Tensor], device):
    """The min and max over every non-empty set, ``[0, 1]`` on each axis
    when all are empty (``treensearch_tpu/api.py:1029-1043``)."""
    live = [p for p in points_list if p.shape[0]]
    if not live:
        return (torch.zeros(3, dtype=torch.float32, device=device),
                torch.ones(3, dtype=torch.float32, device=device))
    mins = torch.stack([p.amin(dim=0) for p in live]).amin(dim=0)
    maxs = torch.stack([p.amax(dim=0) for p in live]).amax(dim=0)
    return mins, maxs


def zsort_orders_from_cells(lin_list: Sequence[torch.Tensor], dy, dz
                            ) -> List[torch.Tensor]:
    """Cell-granular per-set Z-orders from the last search's padded
    linear cell ids ``lin = ((i + w) dy + (j + w)) dz + (k + w)``
    (``FastCarry.lin_chk``, sliced per set).

    The ids decode to padded cell coords; the pad shift is a constant
    translation of the lattice, so their Morton order is a Z-curve order
    of the same cells.  Points of one cell share a key and the sort is
    stable, so they keep their order.  Grid axes hold at most 2**15
    cells, so the padded coords fit ``bits=16``."""
    outs = []
    for lin in lin_list:
        if lin.shape[0] == 0:
            outs.append(_empty_order(lin.device))
            continue
        k_p = lin % dz
        j_p = (lin // dz) % dy
        i_p = lin // (dz * dy)
        outs.append(_stable_order(torch.stack([i_p, j_p, k_p], dim=1), 16))
    return outs


def apply_order(data: torch.Tensor, new_to_old: torch.Tensor
                ) -> torch.Tensor:
    """Rows of ``data`` (n, ...) in the new order, exact for every
    dtype."""
    return data.index_select(0, new_to_old.to(data.device))


def apply_order_batch(arrays: Sequence[torch.Tensor],
                      new_to_old: torch.Tensor) -> List[torch.Tensor]:
    """``apply_order`` of each array (the reference's many-array zsort,
    ``README.md:100-111``)."""
    return [apply_order(a, new_to_old) for a in arrays]


def make_zsort_step(n_sets: int = 1):
    """``step(points_list, arrays_per_set=None) -> (orders, sorted_points,
    sorted_arrays)`` for a simulation loop: the world box, every set's
    per-point order and every gather, with no read back to the host, so a
    loop can call it at its own cadence and a CUDA graph can capture it
    (``treensearch_tpu/ops/zsort.py:117-142``).  ``points_list`` holds
    ``n_sets`` float32 (n_i, 3) tensors on one device;
    ``arrays_per_set[i]`` lists set i's arrays, each with n_i rows."""

    def step(points_list: Sequence[torch.Tensor],
             arrays_per_set: Optional[Sequence[Sequence[torch.Tensor]]]
             = None):
        if len(points_list) != n_sets:
            raise ValueError(f"the step was made for {n_sets} sets, got "
                             f"{len(points_list)}")
        box_min, box_max = world_box(points_list, points_list[0].device)
        orders = zsort_orders(points_list, box_min, box_max)
        pts_sorted = [apply_order(p, o) for p, o in zip(points_list, orders)]
        arrs_sorted = None
        if arrays_per_set is not None:
            arrs_sorted = [apply_order_batch(arrs, o)
                           for arrs, o in zip(arrays_per_set, orders)]
        return orders, pts_sorted, arrs_sorted

    return step
