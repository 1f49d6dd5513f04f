"""The inputs of one run, made on the device from ``--seed``.

One general generator for every configuration and traffic mix: the sets'
points uniform in the unit cube (one draw for all sets), and, as the mix
asks, each point's velocity (uniform in ``[-move, move]`` per coordinate,
the distance it travels per step, 0 in a set that states ``static``;
uniform in [0, 1) where a z-sort carries it and the points stay still),
its mass (uniform in [0.5, 1.5), the payload of a reduce step) and the
user arrays the z-sort carries (an id,
then one array per entry of ``extra_arrays``).  A configuration with
``radii`` gives each point its own radius, uniform in ``[low, high)`` times
``scale`` in float32, drawn after every other input, so that the inputs of
a configuration without radii do not depend on it.  The same seed gives
the same inputs; every seed gives the same sizes.
"""

from __future__ import annotations

import torch


class Inputs:
    """Flat tensors over all sets, with a view of each set's rows."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        sizes = [int(s["n"]) for s in config["sets"]]
        self.sizes = sizes
        self.offsets = [sum(sizes[:i]) for i in range(len(sizes) + 1)]
        n = self.offsets[-1]
        gen = torch.Generator(device=device).manual_seed(int(seed))
        self.points = torch.rand((n, 3), generator=gen, device=device)
        move = float(traffic.get("move", 0.0))
        self.velocity = (torch.rand((n, 3), generator=gen, device=device)
                         * 2 - 1) * move if move else None
        for i, s in enumerate(config["sets"]):
            if s.get("static") and self.velocity is not None:
                self.of_set(self.velocity, i).zero_()
        self.payload = None
        if traffic.get("reduce"):
            cols = int(traffic["reduce"]["payload_columns"])
            self.payload = torch.zeros((n, 2), device=device)
            self.payload[:, :cols] = torch.rand(
                (n, cols), generator=gen, device=device) + 0.5
        self.user = []   # per z-sort array, flat over all sets
        zsort = traffic.get("zsort")
        if zsort:
            # the solver's velocities ride the z-sort, also where the mix
            # holds the points still
            velocity = self.velocity if self.velocity is not None else \
                torch.rand((n, 3), generator=gen, device=device)
            self.user = [velocity, torch.cat(
                [torch.arange(m, device=device, dtype=torch.float32)
                 for m in sizes])]
            for width in zsort["extra_arrays"]:
                shape = (n,) if width == 1 else (n, width)
                self.user.append(torch.rand(shape, generator=gen,
                                            device=device))
        self.radii = None
        radii = config.get("radii")
        if radii:
            if zsort:
                raise ValueError("per-point radii under a z-sorting mix: the "
                                 "radii would have to ride the z-sort")
            low, high = float(radii["low"]), float(radii["high"])
            self.radii = (torch.rand(n, generator=gen, device=device)
                          * (high - low) + low) * float(radii["scale"])

    def of_set(self, flat: torch.Tensor, i: int) -> torch.Tensor:
        return flat[self.offsets[i]:self.offsets[i + 1]]

    def set_views(self, flat: torch.Tensor) -> list:
        return [self.of_set(flat, i) for i in range(len(self.sizes))]

    def snapshot(self) -> dict:
        """Copies of what the program may rewrite, for the reference."""
        return {"points": self.points.clone(),
                "velocity": None if self.velocity is None
                else self.velocity.clone(),
                "radii": None if self.radii is None else self.radii.clone(),
                "user": [u.clone() for u in self.user]}
