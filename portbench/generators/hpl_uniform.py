"""HPL's kind of system: A and B with entries uniform in [-0.5, 0.5],
made on the device by a ``torch.Generator`` seeded for this system. HPL
draws them from its own linear congruential generator; the distribution
is the same, the numbers are not. A Gaussian-like random matrix of this
kind has a condition number of order n, so partial pivoting and the
backward error both do real work."""

import torch

from portbench.generators.seeds import system_seed


def make(seed: int, index: int, config, traffic, device):
    """System `index` of the pool: ``{"a": n x n, "b": n x nrhs}``, n from
    the configuration, nrhs from the traffic."""
    n, nrhs = config["n"], traffic["nrhs"]
    g = torch.Generator(device=device)
    g.manual_seed(system_seed(seed, index))
    a = torch.rand((n, n), generator=g, device=device).sub_(0.5)
    b = torch.rand((n, nrhs), generator=g, device=device).sub_(0.5)
    return {"a": a, "b": b}
