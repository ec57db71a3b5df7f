"""One process on one card: card 0 of the machine. A run on a machine
without the cards a cell asks for stops here; it never falls back to the
CPU."""

import torch


class NoCard(RuntimeError):
    pass


def run(job, chips):
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is False")
    if torch.cuda.device_count() < chips:
        raise NoCard("the cell asks for %d cards, torch.cuda.device_count() "
                     "is %d" % (chips, torch.cuda.device_count()))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    return job(device)
