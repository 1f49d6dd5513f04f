"""The callback of the ``density_step`` mix: the poly6 density
``m_j (h^2 - d^2)^3`` up to its normalisation, as
``benchmarks/bench_reduce_1m.py::density_fn`` writes it.  Four operations
per neighbor pair (a difference and three products), plus the sum: the
mix's ``ops_per_hit`` of 5."""

import numpy as np


def callback(radius: float):
    h2 = np.float32(radius * radius)

    def density_fn(env):
        w = h2 - env["d2"]
        return env["p0_j"] * (w * w * w)

    return density_fn
