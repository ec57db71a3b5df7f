"""A test-only launcher: the job on the CPU, in this process."""

import torch


class NoCard(RuntimeError):
    pass


def run(job, chips):
    return job(torch.device("cpu"))
