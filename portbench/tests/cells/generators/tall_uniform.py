"""Test only: a tall system, A m x n and B m x nrhs uniform in
[-0.5, 0.5], from a generator seeded for pool member `index`."""

import torch

from portbench.generators.seeds import system_seed


def make(seed, index, config, traffic, device):
    g = torch.Generator(device=device)
    g.manual_seed(system_seed(seed, index))
    m, n, nrhs = config["m"], config["n"], traffic["nrhs"]
    return {"a": torch.rand((m, n), generator=g, device=device).sub_(0.5),
            "b": torch.rand((m, nrhs), generator=g, device=device).sub_(0.5)}
