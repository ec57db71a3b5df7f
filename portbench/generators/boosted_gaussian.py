"""HPL-MxP's kind of system: a diagonally dominant matrix, here a Gaussian
G + 2 sqrt(n) I with its rows in a random order so that partial pivoting
still swaps, and a Gaussian right-hand side. A copy of the torch branch
of ``slate_tpu_torch.testing.permuted_boosted_system``, seeded for this
system. The condition number is O(1), as a low-precision factor with
refinement needs."""

import math

import torch

from portbench.generators.seeds import system_seed


def make(seed: int, index: int, config, traffic, device):
    """System `index` of the pool: ``{"a": n x n, "b": n x nrhs}``, n from
    the configuration, nrhs from the traffic."""
    n, nrhs = config["n"], traffic["nrhs"]
    g = torch.Generator(device=device)
    g.manual_seed(system_seed(seed, index))
    a = torch.randn((n, n), generator=g, device=device)
    a.diagonal().add_(2.0 * math.sqrt(n))
    a = a[torch.randperm(n, generator=g, device=device)]
    b = torch.randn((n, nrhs), generator=g, device=device)
    return {"a": a, "b": b}
