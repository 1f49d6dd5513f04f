"""treensearch_tpu_torch: the neighborhood-search engine in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of ``treensearch_tpu`` (which stays the JAX reference).  This
slice covers ``TreeNSearch.run()`` on one point set at a fixed radius:
grid update, sort and row-aligned tile layout in PyTorch, and the
query-tile and pairs kernels in ``csrc/pairs.cu``.  The package imports
torch and numpy, never jax.
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
