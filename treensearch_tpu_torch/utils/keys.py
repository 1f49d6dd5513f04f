"""Point quantization onto the uniform cell grid, the two-word cell keys
of the search-based pipeline and z-sort's two-word Morton keys.

PyTorch counterpart of ``treensearch_tpu/utils/keys.py:32-139``.
Points are quantized to at most 2**15 cells per axis, the reference's
domain limit (``TreeNSearch.cpp:510-515``).  The row-major key is two
int32 words, ``hi = i << 15 | j`` and ``lo = k``; sorting by (hi, lo)
makes the k-run of every (i + di, j + dj) one contiguous range.  The JAX
package sorts and searches the two words as such (a two-key sort and a
fixed-trip binary search); here both words go into one int64,
``key64(hi, lo)``, whose order is their lexicographic order, so
``torch.sort(stable=True)`` and ``torch.searchsorted`` give the same
permutation and the same indices, and sorting ``morton_keys_2word``'s
words that way gives the JAX z-sort's order.
"""

from __future__ import annotations

import torch

MAX_CELLS_PER_DIM = 1 << 15
_KEY_SHIFT = 15


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


def cell_keys(ijk: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-major two-word key of int32 cell coords (N, 3): hi = i << 15 |
    j, lo = k."""
    return key_hi(ijk[:, 0], ijk[:, 1]), ijk[:, 2]


def key_hi(i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    return (i << _KEY_SHIFT) | j


def key64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The words as one int64 in the same order: ``hi * 2**32 + (lo +
    2**31)``, exact and order-preserving for any two int32 words."""
    return hi.to(torch.int64) * (1 << 32) + (lo.to(torch.int64) + (1 << 31))


def searchsorted_2word(hi: torch.Tensor, lo: torch.Tensor,
                       q_hi: torch.Tensor, q_lo: torch.Tensor,
                       side: str) -> torch.Tensor:
    """numpy ``searchsorted`` over the lexicographically sorted words
    ``hi``/``lo`` (M,) for the query words (any equal shapes): int32
    insertion indices, equal to the JAX binary search's."""
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    return torch.searchsorted(key64(hi, lo), key64(q_hi, q_lo), side=side,
                              out_int32=True)


def morton_keys_2word(ijk: torch.Tensor,
                      bits: int = 20) -> tuple[torch.Tensor, torch.Tensor]:
    """3D Morton (Z-curve) code of int32 coords (N, 3) with up to ``bits``
    <= 20 bits per axis, as two int32 words: ``lo`` interleaves the low 10
    bits of each axis, ``hi`` the bits above, the i axis in the lowest
    bit.  Lexicographic (hi, lo) order is the full 3 * bits Morton
    order."""
    assert bits <= 20
    low10 = (1 << 10) - 1

    def spread10(v):
        # b9..b0 -> bits 27, 24, ..., 0 (every third position)
        v = v & low10
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        return (v | (v << 2)) & 0x09249249

    i, j, k = ijk[:, 0], ijk[:, 1], ijk[:, 2]
    lo = (spread10(k) << 2) | (spread10(j) << 1) | spread10(i)
    hi = (spread10(k >> 10) << 2) | (spread10(j >> 10) << 1) \
        | spread10(i >> 10)
    return hi, lo


def sort_by_2word_key(hi: torch.Tensor, lo: torch.Tensor,
                      *payload: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Stable sort by lexicographic (hi, lo); the payload arrays ride
    along.  Returns (hi_s, lo_s, *payload_s)."""
    order = torch.sort(key64(hi, lo), stable=True).indices
    return tuple(a[order] for a in (hi, lo) + payload)
