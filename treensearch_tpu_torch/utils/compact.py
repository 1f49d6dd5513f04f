"""Row compaction: the masked values of each row, front-packed in order.

PyTorch counterpart of ``treensearch_tpu/utils/compact.py:20-56``.  The
JAX package moves values by a log-shift network because that keeps XLA's
compile time flat; here an inclusive cumsum gives each kept value its
rank and one scatter places it.
"""

from __future__ import annotations

import torch


def compact_rows(mask: torch.Tensor, values: torch.Tensor, out_w: int,
                 fill: int = -1) -> torch.Tensor:
    """(..., M) bool ``mask`` and ``values`` (int32, broadcastable to the
    mask) -> (..., out_w) int32: the masked values front-packed in lane
    order, ``fill``-padded.  Values ranked past ``out_w`` are dropped (the
    callers count exactly and regrow)."""
    rank = torch.cumsum(mask, dim=-1, dtype=torch.int32)
    keep = mask & (rank <= out_w)
    out = torch.full((*mask.shape[:-1], out_w + 1), fill, dtype=torch.int32,
                     device=mask.device)
    # every dropped value lands in the spare last column
    out.scatter_(-1, torch.where(keep, rank - 1, out_w).long(),
                 torch.where(keep, values, fill).to(torch.int32))
    return out[..., :out_w]
