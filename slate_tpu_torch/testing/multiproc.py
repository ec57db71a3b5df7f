"""Multi-process launcher for the grid (counterpart of
``slate_tpu/testing/multiproc.py``): one startup path for every
multi-rank run, tests and ``chip_smoke.py`` alike.

  * the PARENT calls :func:`launch`: it spawns ``python <worker>
    <process_id> <rendezvous dir> <num_processes> [args...]`` per rank
    (a ``.py`` path, or a dotted module run with ``-m``) with the pinned
    environment of :func:`worker_env` (one OpenMP thread, the repo on
    ``PYTHONPATH``), polls them, reaps on failure or timeout, and
    returns (procs, outs). The workers run the port only, never JAX:
    nothing they import may need it;
  * the WORKER calls :func:`init` (or :func:`startup`) first: it joins
    the process group through a ``FileStore`` in the launch's own
    temporary directory (``file://``), so parallel test workers never
    race for a port, with a bounded ``timeout``; it pins one torch
    thread;
  * results cross the process boundary as one-line JSON records
    (:func:`emit` / :func:`results`); tensors go to ``.npy`` files in
    the launch's output directory, whose paths the records carry.

Reap with diagnostics (resil/): when one worker dies while its siblings
still run, the survivors get `death_grace` seconds to exit on their own
(a dead peer wedges them in their next collective), then everything is
killed and reaped and :class:`~slate_tpu_torch.resil.guard.WorkerLost`
carries the dead worker's id, exit code and output tail. The overall
deadline raises the same error naming the first worker still running.
Workers that ALL exit (even nonzero) return normally:
:func:`assert_success` reports those with their tails.

The ``worker`` fault site fires in :func:`init` before the rendezvous:
a ``kill`` rule scoped ``{"match": {"process": 1}}`` reproduces a
worker that dies during launch. ``share_tuning`` in :func:`startup`
runs dist/tuneshare: rank 0's measured tuning entries, best-entry
merged into every rank's cache before the first driver call.
"""

from __future__ import annotations

import datetime
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

#: worker handshake line prefix (parents parse with :func:`results`)
_TAG = "MP_RESULT "

#: seconds a surviving worker gets to exit on its own after a sibling
#: died, before launch() reaps the grid
DEATH_GRACE_S = 20.0

#: seconds a collective may wait on a peer before the process group
#: gives up (torch.distributed's own default is ten minutes)
PG_TIMEOUT_S = 120.0

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def worker_env() -> Dict[str, str]:
    """Environment pins for a worker: one OpenMP / BLAS thread, the
    repository on PYTHONPATH (for ``-m`` module workers)."""
    path = os.environ.get("PYTHONPATH", "")
    return {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
            "OPENBLAS_NUM_THREADS": "1",
            "PYTHONPATH": _ROOT + (os.pathsep + path if path else "")}


def _command(worker: str) -> List[str]:
    if worker.endswith(".py"):
        return [sys.executable, str(worker)]
    return [sys.executable, "-m", worker]


def _spawn(worker: str, num_processes: int, rdzv: str,
           extra_args: Sequence[str], env: Optional[Dict[str, str]]):
    """Spawn the workers with stdout and stderr in per-worker FILES
    (never pipes: a chatty worker cannot block the reap path)."""
    child_env = dict(os.environ)
    child_env.update(worker_env())
    if env:
        child_env.update(env)
    procs, logs = [], []
    for pid in range(num_processes):
        log = open(os.path.join(rdzv, "worker%d.out" % pid), "w+")
        procs.append(subprocess.Popen(
            _command(worker) + [str(pid), rdzv, str(num_processes),
                                *map(str, extra_args)],
            stdout=log, stderr=subprocess.STDOUT, text=True,
            env=child_env))
        logs.append(log)
    return procs, logs


def _read_logs(logs) -> List[str]:
    outs = []
    for f in logs:
        try:
            f.flush()
            f.seek(0)
            outs.append(f.read())
        finally:
            f.close()
    return outs


def launch(worker: str, num_processes: int = 2,
           extra_args: Sequence[str] = (),
           env: Optional[Dict[str, str]] = None, timeout: float = 420,
           death_grace: float = DEATH_GRACE_S,
           outdir: Optional[str] = None, lost_on_failure: bool = False
           ) -> Tuple[List[subprocess.Popen], List[str]]:
    """Run `worker` as `num_processes` ranks of one process group and
    collect their outputs, bounded by `timeout` (module doc). Workers
    write their files into `outdir` (passed as ``SLATE_MP_OUTDIR``;
    default: the launch's temporary directory, removed on return).
    ``lost_on_failure``: a worker that exits nonzero raises WorkerLost
    naming the first to fail, even when its siblings exit too (a peer
    that sees the closed connection fails its collective and exits)."""
    from ..resil.guard import WorkerLost
    rdzv = tempfile.mkdtemp(prefix="slate_torch_mp_")
    env = dict(env or {})
    env["SLATE_MP_OUTDIR"] = outdir or rdzv
    try:
        procs, logs = _spawn(worker, num_processes, rdzv, extra_args, env)
        failed: Optional[Tuple[int, int]] = None
        fail_at = 0.0
        lost = None
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes):
                break
            now = time.monotonic()
            if failed is None:
                for pid, c in enumerate(codes):
                    if c is not None and c != 0:
                        failed, fail_at = (pid, c), now
                        break
            if now >= deadline or (failed is not None
                                   and now - fail_at >= death_grace):
                alive = [i for i, c in enumerate(codes) if c is None]
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                for p in procs:
                    p.wait()
                lost = failed if failed is not None \
                    else (alive[0] if alive else 0, None)
                break
            time.sleep(0.05)
        outs = _read_logs(logs)
    finally:
        shutil.rmtree(rdzv, ignore_errors=True)
    if lost is None and lost_on_failure:
        codes = [p.returncode for p in procs]
        bad = [(pid, c) for pid, c in enumerate(codes) if c]
        # several may have exited between two polls: the one that did
        # not die of an uncaught exception (exit code 1) failed first
        lost = failed or next((b for b in bad if b[1] != 1),
                              bad[0] if bad else None)
    if lost is not None:
        pid, rc = lost
        raise WorkerLost(pid, rc, tail=outs[pid], outs=outs)
    return procs, outs


def assert_success(procs: Sequence[subprocess.Popen],
                   outs: Sequence[str]) -> None:
    """Every worker exited 0; failures carry the worker's tail."""
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (
            "worker %d rc=%s\n%s" % (pid, p.returncode, out[-3000:]))


# -- worker side ----------------------------------------------------------

def outdir() -> str:
    """The directory this worker writes its files into (launch's
    `outdir`)."""
    return os.environ.get("SLATE_MP_OUTDIR") or tempfile.gettempdir()


def init(process_id: int, rdzv: str, num_processes: int = 2, *,
         backend: Optional[str] = None, device: Optional[str] = None,
         timeout: float = PG_TIMEOUT_S) -> str:
    """Join the process group; call FIRST in a worker. The backend is
    NCCL for a CUDA `device` (the default: the card), gloo for the CPU,
    unless `backend` names one; a failed rendezvous raises. A fault plan
    from ``SLATE_RESIL_FAULTS`` is installed, and the ``worker`` site
    fires before the rendezvous. Returns the backend."""
    from ..resil import faults as _faults
    _faults.install_from_env()
    _faults.check("worker", process=int(process_id))
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    if backend is None:
        backend = "gloo" if device is not None \
            and torch.device(device).type == "cpu" else "nccl"
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(rdzv, "store"),
        rank=int(process_id), world_size=int(num_processes),
        timeout=datetime.timedelta(seconds=timeout))
    assert dist.get_world_size() == int(num_processes)
    return backend


def startup(process_id: int, rdzv: str, num_processes: int = 2,
            p: Optional[int] = None, q: Optional[int] = None, *,
            backend: Optional[str] = None, device: Optional[str] = None,
            share_tuning: bool = False):
    """init() and the grid over every rank (near-square unless p / q
    are given), optionally running the dist/tuneshare broadcast first.
    Returns (grid, adopted_entry_count)."""
    init(process_id, rdzv, num_processes, backend=backend, device=device)
    from ..parallel.mesh import make_grid
    grid = make_grid(p, q, device=device)
    adopted = 0
    if share_tuning:
        from ..dist.tuneshare import share_tuning_table
        adopted = share_tuning_table(grid)
    return grid, adopted


def emit(tag: str, **fields) -> None:
    """One structured handshake line on stdout (flushed: a killed
    worker still leaves everything emitted so far)."""
    print(_TAG + json.dumps({"tag": tag, **fields}, sort_keys=True),
          flush=True)


def results(out: str) -> Dict[str, dict]:
    """Parse a worker's stdout into {tag: record}."""
    recs: Dict[str, dict] = {}
    for line in out.splitlines():
        if line.startswith(_TAG):
            rec = json.loads(line[len(_TAG):])
            recs[rec.pop("tag")] = rec
    return recs

