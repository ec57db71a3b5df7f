"""Device selection (counterpart of ``slate_tpu/utils/backend.py``).

The JAX package probes its ambient backend; the port instead takes an
explicit ``device`` at every entry point that creates data. The
default is the CUDA card. The CPU is used only when the caller asks
for it (``device="cpu"``, as the tests do): a missing card is an
error, never a silent fall back to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point puts its data on: ``cuda`` unless the
    caller names another. Raises when CUDA is asked for (explicitly or
    by default) and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "slate_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run on the CPU explicitly")
    return dev
