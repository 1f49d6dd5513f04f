"""A piece of the loop captured as one CUDA graph, replayed with no host
read.

The pattern is a frozen copy of ``chip_smoke.py::capture_step``
(``chip_smoke.py:1692-1731`` at the commit that added this benchmark):
an eager warm-up on a side stream (a carried step's first call rebuilds,
its second reuses, so every kernel is built and every workspace made),
then one capture.  On a device without CUDA graphs (the CPU, in the
benchmark's own tests) ``replay`` calls the function eagerly.
"""

from __future__ import annotations

import torch


class Captured:
    """``fn()`` captured after ``warm()`` ran ``warm_calls`` times;
    ``out`` is what the last call returned (a graph's static outputs,
    which every replay overwrites)."""

    def __init__(self, fn, device, warm=None, warm_calls: int = 2):
        self.fn = fn
        self.graph = None
        if device.type != "cuda":
            self.out = None
            return
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(warm_calls):
                (warm or fn)()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = fn()
        torch.cuda.synchronize()

    def replay(self) -> None:
        if self.graph is not None:
            self.graph.replay()
        else:
            self.out = self.fn()
