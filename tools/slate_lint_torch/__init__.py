"""slate_lint_torch: the contract-checking static analysis of the
PyTorch / CUDA package ``slate_tpu_torch/``.

The package's load-bearing invariants live in CROSS-FILE agreements
— a FROZEN tune row in tune/cache.py and its reader in a driver, an
obs counter literal and the code that reads it back, a fault site
name in a plan and the ``check()`` call that makes it fire, a lock in
``__init__`` and the mutations it is supposed to guard. No single
call site can see a breach; this package checks the agreements
whole-tree, AST-only (it imports neither torch nor the package it
checks, so it stays tier-1 fast), with per-finding codes, file:line
anchors, in-source exemption comments
(``# slate-lint: exempt[SLxxx] <why>``) and a JSON baseline
mechanism (core.py). It is a copy of ``tools/slate_lint`` (which
checks ``slate_tpu/``) whose analyzers check the port's form of each
contract; the package root is ``core.PKG``.

CLI::

    python -m tools.slate_lint_torch [--only CODE|NAME]
        [--baseline PATH] [--write-baseline PATH] [--list]
        [--timings] [--obs-doc [PATH|-]] [--repo PATH]

Codes, by analyzer:

    SL101/SL102  instrumented      drivers keep @instrument_driver
    SL103        kernel-registry   every kernel entry is registered
    SL104        resil-contract    the escalation ladder
    SL105        shard-lookahead   the sharded stream's lookahead
    SL106        precision         the mixed-precision drivers
    SL201-SL203  tune-keys         tune keys, FROZEN rows, families
                                   (:mod:`.tune_keys`)
    SL301        lock-discipline   (:mod:`.locks`)
    SL401/SL402  obs-literals      near-miss series names and
                                   docs/OBS_REFERENCE_TORCH.md
                                   (:mod:`.obs_literals`)
    SL501-SL503  fault-sites       (:mod:`.fault_sites`)
    SL601-SL603  flight-recorder   heartbeats, ledger phases, rows
                                   (:mod:`.flight`)
    SL701-SL703  sched-graph       task-graph kind tables
                                   (:mod:`.sched_graph`)
    SL801-SL803  reqtrace-ctx      trace context in the serving tier
                                   (:mod:`.reqtrace_ctx`)
    SL901-SL903  elastic-mesh      the ownership table
                                   (:mod:`.elastic_mesh`)
    SL1001-SL1003 visit-fuse       the fused visit sweep
                                   (:mod:`.visit_fuse`)

SL101-SL106 are in :mod:`.legacy`.

Where the port's form of a contract differs from the reference's,
the analyzer checks the port's: kernel entries dispatch ``_*_launch``
wrappers (SL103), a shard driver may hand ``precision`` to a
resolving helper of its module (SL106), fault plans live in the
port's tests, ``chip_smoke.py`` and ``examples/torch/`` (SL503), and
each fused visit has one body for both precisions that takes ``lo``
(SL1003).

Extending: add a module with a ``@core.register(name, codes, doc)``
function ``analyze(repo) -> [core.Finding]``, import it below, and
give it one clean + one violating fixture case in
tests/test_torch_lint.py.
"""

from __future__ import annotations

from .core import (Finding, REGISTRY, RunResult, register, run)  # noqa: F401

# importing the analyzer modules populates the registry (order here
# == report order)
from . import legacy          # noqa: F401,E402
from . import tune_keys       # noqa: F401,E402
from . import locks           # noqa: F401,E402
from . import obs_literals    # noqa: F401,E402
from . import fault_sites     # noqa: F401,E402
from . import flight          # noqa: F401,E402
from . import sched_graph     # noqa: F401,E402
from . import reqtrace_ctx    # noqa: F401,E402
from . import elastic_mesh    # noqa: F401,E402
from . import visit_fuse      # noqa: F401,E402

from .obs_literals import generate_reference  # noqa: F401,E402
