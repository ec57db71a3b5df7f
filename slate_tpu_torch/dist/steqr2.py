"""Row-local distributed tridiagonal QR iteration (counterpart of
``slate_tpu/dist/steqr2.py``): the reference's modified Fortran steqr2
(src/dsteqr2.f driven by src/steqr2.cc). Every rank runs the cheap
scalar d / e recurrence redundantly while updating ONLY its own rows of
the eigenvector matrix Z, so per-rank memory and work on Z are n x n/P
with no communication in the accumulation.

Here every rank runs the port's sweep loop (``linalg.eig.steqr2_qr``:
the passes in ``steqr_sweeps`` launches on the card) on (d, e) and
applies each pass's chain to its own row block of Z (by
``givens_chain_apply`` when the tune cache routes the chain to it). A
rotation chain acts on each row alone, so each rank's rows are bitwise
the one-device result's. No collective is scheduled: the driver records
``comms:steqr2_dist`` with ``ppermutes=0``. Z comes back as this rank's
row block of the padded rows (``tree.row_block``); eig.steqr2 gathers
the blocks.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.tiles import round_up
from ..obs.events import instrument_driver
from ..parallel.mesh import WHOLE, ProcessGrid
from . import tree


@instrument_driver("steqr2_dist")
def steqr2_qr_dist(grid: ProcessGrid, d: torch.Tensor, e: torch.Tensor,
                   z0: Optional[torch.Tensor] = None,
                   maxit_factor: int = 30, axis=WHOLE
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """steqr2_qr with the transform accumulation split over row blocks
    (module doc). z0: the optional initial transform (rows, n) the
    rotations accumulate onto (default the identity). Returns (w
    ascending, this rank's row block of Z, info)."""
    from ..linalg.eig import steqr2_qr
    from ..obs import events as obs_events
    n = d.shape[0]
    if obs_events.enabled():
        # zero scheduled collectives is this driver's contract
        obs_events.instant("comms:steqr2_dist", cat="comms", ppermutes=0,
                           n=int(n))
    z = torch.eye(n, dtype=d.dtype, device=d.device) if z0 is None else z0
    size = tree.axis_size(grid, axis)
    rp = round_up(max(z.shape[0], 1), size)
    zl = tree.pad_rows(z, rp)[tree.row_block(grid, rp, axis)]
    return steqr2_qr(d, e, z0=zl, maxit_factor=maxit_factor)
