"""The serving daemon (counterpart of ``slate_tpu/serve/``).

A persistent multi-tenant serving tier over the batch layer:

  * :class:`Server`: the process-level submit API over the
    :class:`~slate_tpu_torch.batch.queue.CoalescingQueue`
    (serve/server.py);
  * :class:`~slate_tpu_torch.serve.rpc.RpcServer` /
    :class:`~slate_tpu_torch.serve.rpc.RpcClient`: length-prefixed
    socket framing for out-of-process clients, no copy on ingestion;
  * :class:`AdmissionController` + :class:`TenantConfig`: per-tenant
    quotas and priority classes, decisions driven by the obs layer
    (queue stats, ledger dispatch records, the watchdog's ETA gauge),
    every non-admit funneled through the resil guard;
  * :class:`FactorCache`: a fingerprint-keyed LRU of potrf / getrf
    factors, so repeated solves against the same operator skip the
    O(n^3) refactorization and ride the solve-only ragged stream.

Cold route (tuned ``serve/cache_mb`` 0, the FROZEN default): bitwise
that of direct queue use; the daemon adds policy, not a second numerics
path. Requests are numpy arrays or CPU tensors; results are CPU
tensors. Nothing here is left out of the reference's surface.
"""

from .admission import (ADMIT, DEGRADE, PRIORITIES, REJECT, SHED,
                        AdmissionController, TenantConfig)
from .cache import FactorCache
from .rpc import RpcClient, RpcServer
from .server import CACHED_OPS, ServeRejected, Server, ServeTicket

__all__ = [
    "ADMIT", "DEGRADE", "PRIORITIES", "REJECT", "SHED",
    "AdmissionController", "TenantConfig", "FactorCache",
    "RpcClient", "RpcServer", "CACHED_OPS", "ServeRejected",
    "Server", "ServeTicket",
]
