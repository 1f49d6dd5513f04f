"""treensearch_tpu_torch: the neighborhood-search engine in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of ``treensearch_tpu`` (which stays the JAX reference).  It
covers ``TreeNSearch.run()`` on any number of point sets at a fixed
radius or with per-point radii, ``run_scalar()``, and the device
contracts ``run_reduce`` and ``run_mask``: grid update, sort and
row-aligned tile layout in PyTorch, the query-tile, padded-record, pairs
and mask kernels in ``csrc/pairs.cu``, the fused reduce in
``csrc/reduce.cu``, and the tile path and the search-based pipeline
(``ops/pipeline.py``) in PyTorch, and the multi-GPU domain
decomposition (``parallel/sharded.py``) on ``torch.distributed``.  The
package imports torch and numpy, never jax.
"""

from .api import TreeNSearch
from .config import SearchConfig
from .neighborlist import NeighborList, NeighborSolution

__version__ = "0.1.0"

__all__ = [
    "TreeNSearch",
    "NeighborList",
    "NeighborSolution",
    "SearchConfig",
]
