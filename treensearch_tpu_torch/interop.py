"""State carried across from the JAX package.

The JAX ``GridState`` and ``FastCarry`` fields, as numpy arrays, become
the port's tensors, so tests can feed structures the JAX prep built
straight into the port's kernels: the search engine's counterpart of
carrying weights across.  Multi-set and variable-radius structures carry
over the same way: the sorted radii ride ``r_chk``, and the records are
rebuilt from the points, radii and set sizes.  The tile path's
padded-layout carry (the JAX prep with ``use_pallas=False``) converts
with the same ``carry_from_numpy``: its window starts are padded-slot
indices, which the port's padded prep computes too, and its ``opad`` map
is dropped (K1r builds the padded records from the descriptors).  The
search-based pipeline's ``SortedStructure`` converts with
``sorted_structure_from_numpy``.  This module imports neither JAX nor the
JAX package; pass ``{k: np.asarray(v) for k, v in
state._asdict().items()}``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .ops.fastpath import FastCarry
from .ops.grid import GridState
from .ops.pairs import FAT_COL
from .ops.pipeline import SortedStructure
from .utils.keys import key64


def _fields(d) -> Mapping:
    return d._asdict() if hasattr(d, "_asdict") else d


def _t(x, dtype, device) -> torch.Tensor:
    # a copy: arrays read back from JAX are not writable
    return torch.from_numpy(np.array(x)).to(device=device,
                                            dtype=dtype).contiguous()


def grid_state_from_numpy(d, device="cpu") -> GridState:
    """JAX ``GridState`` fields -> the port's ``GridState``."""
    d = _fields(d)
    return GridState(
        valid=_t(d["valid"], torch.bool, device),
        grid_min=_t(d["grid_min"], torch.float32, device),
        grid_max=_t(d["grid_max"], torch.float32, device),
        n_cells=_t(d["n_cells"], torch.int32, device),
        cell_size=_t(d["cell_size"], torch.float32, device),
        error=_t(d["error"], torch.int32, device),
    )


def carry_from_numpy(d, device="cpu") -> FastCarry:
    """JAX ``FastCarry`` fields -> the port's ``FastCarry``.

    The port has one tier, so fat-tier routing is dropped: a fat tile
    (FAT_COL = 1) becomes a live tile (0); dead tiles (2) stay dead.
    """
    d = _fields(d)

    def i32(k):
        return _t(d[k], torch.int32, device)

    desc = i32("desc")
    desc[:, FAT_COL] = torch.where(desc[:, FAT_COL] == 2, 2, 0)
    return FastCarry(
        valid=_t(d["valid"], torch.bool, device),
        lin_s=i32("lin_s"), lin_chk=i32("lin_chk"),
        r_chk=_t(d["r_chk"], torch.float32, device), idx_s=i32("idx_s"),
        inv_perm=i32("inv_perm"), pp=i32("pp"), qpos=i32("qpos"),
        desc=desc, dense_overflow=i32("dense_overflow"),
        tile_overflow=i32("tile_overflow"),
        rows_overflow=i32("rows_overflow"), win_max=i32("win_max"),
        n_cells_stat=i32("n_cells_stat"))


def sorted_structure_from_numpy(d, device="cpu") -> SortedStructure:
    """JAX pipeline ``SortedStructure`` fields -> the port's (its int64
    key is made from the two words; ``r_s`` may be None)."""
    d = _fields(d)

    def i32(k):
        return _t(d[k], torch.int32, device)

    hi_s, lo_s = i32("hi_s"), i32("lo_s")
    r_s = d.get("r_s")
    return SortedStructure(
        hi_s=hi_s, lo_s=lo_s, idx_s=i32("idx_s"),
        pts_s=_t(d["pts_s"], torch.float32, device), set_id_s=i32("set_id_s"),
        r_s=None if r_s is None else _t(r_s, torch.float32, device),
        ijk_s=i32("ijk_s"), n_cells_xyz=i32("n_cells_xyz"),
        r2_fixed=_t(d["r2_fixed"], torch.float32, device),
        offsets_arr=i32("offsets_arr"), n_cells_stat=i32("n_cells_stat"),
        key_s=key64(hi_s, lo_s))
