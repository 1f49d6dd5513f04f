"""What the CPU tests of a captured step share: a guard that makes every
read back to the host raise, and a bit-for-bit comparison of two
solutions.

``no_host_reads(monkeypatch)`` makes every tensor method that reads a
value back to the host (``item``, ``tolist``, ``numpy``, ``cpu``,
``__bool__``, ``__int__``, ``__float__``, ``__index__``) and
``torch.tensor`` raise, except inside a kernel wrapper that
``ops/fastpath.py`` calls: on the card each wrapper is one launch, on the
CPU it runs its plain version, which may read the host.  A step that runs
under the guard makes no host read and no host-to-device copy, as CUDA
graph capture requires.
"""

import torch

from treensearch_tpu_torch.ops import fastpath as tfp

KERNELS = ("expand_query_tiles", "expand_records", "pairs_nbrs_fixed",
           "pairs_nbrs_sets", "pairs_nbrs_variable", "pairs_mask",
           "pairs_nbrs_from_bits", "pairs_reduce")
HOST_READS = ("item", "tolist", "numpy", "cpu", "__bool__", "__int__",
              "__float__", "__index__")


def assert_same(got, want, path="sol"):
    """Two solutions (nested dicts, lists and tensors) equal key for key,
    each tensor's dtype and values bit for bit."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for k, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{k}]")
    elif want is None:
        assert got is None, path
    else:
        assert got.dtype == want.dtype and torch.equal(got, want), path


def no_host_reads(monkeypatch):
    """Tensor reads back to the host and ``torch.tensor`` raise, except
    inside a kernel wrapper of ``ops/fastpath.py``."""
    inside = [0]

    def kernel(orig):
        def call(*args, **kwargs):
            inside[0] += 1
            try:
                return orig(*args, **kwargs)
            finally:
                inside[0] -= 1
        return call

    def guarded(orig, name):
        def call(*args, **kwargs):
            if not inside[0]:
                raise AssertionError(f"the step called {name}")
            return orig(*args, **kwargs)
        return call

    for name in KERNELS:
        monkeypatch.setattr(tfp, name, kernel(getattr(tfp, name)))
    for name in HOST_READS:
        monkeypatch.setattr(torch.Tensor, name,
                            guarded(getattr(torch.Tensor, name), name))
    monkeypatch.setattr(torch, "tensor", guarded(torch.tensor,
                                                 "torch.tensor"))
