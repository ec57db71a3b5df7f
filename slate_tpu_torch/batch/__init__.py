"""slate_tpu_torch.batch — the batched many-matrix layer (counterpart
of ``slate_tpu/batch/``): N independent problems in O(1) dispatches.

  * drivers.py — batched potrf/getrf/geqrf/posv/gesv/potrs/getrs/gels/
    heev cores over a leading batch dimension, and the ragged dispatch
    through the ragged kernels;
  * bucket.py — geometric shape buckets, validity-masked padding, the
    ragged ceiling and the waste reports;
  * queue.py — the request-coalescing micro-batch queue (max-batch /
    max-wait tunables, bucket and ragged strategies), host in and host
    out.

Quick use::

    from slate_tpu_torch import batch
    with batch.CoalescingQueue() as q:
        tickets = [q.submit("potrf", a) for a in spd_matrices]
        ls = [t.result() for t in tickets]
    # or one-shot over a heterogeneous list:
    xs = batch.run("gesv", mats, rhs=rhss)
"""

from . import bucket, drivers, queue                      # noqa: F401
from .bucket import (bucket_for, bucket_ladder,           # noqa: F401
                     padding_waste, ragged_ceiling, ragged_report,
                     stack_report)
from .drivers import (RAGGED_OPS, gels_batched,           # noqa: F401
                      geqrf_batched, gesv_batched, getrf_batched,
                      getrs_batched, heev_batched, posv_batched,
                      potrf_batched, potrs_batched, ragged_dispatch)
from .queue import CoalescingQueue, Ticket, run           # noqa: F401
