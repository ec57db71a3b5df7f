"""Observability (counterpart of ``slate_tpu/obs/``): one event bus for
every record in the process (events.py), the metrics registry
(metrics.py), the flight recorder (ledger.py), request traces
(reqtrace.py) and their SLO series (series.py), the stall watchdog
(health.py), per-call cost attribution (xprof.py), the Perfetto JSON
export (export.py) and the per-run report (report.py).

Quick use::

    from slate_tpu_torch import obs
    obs.enable()
    ...                                   # run drivers
    obs.analyze("gesv", st.gesv, A, B)    # FLOPs / memory / wall
    print(obs.report())
    obs.write_trace("run.trace.json")
"""

from . import (events, export, health, ledger,    # noqa: F401
               metrics, reqtrace, series, xprof)
from .events import (clear, counter, disable, driver, enable,  # noqa: F401
                     enabled, instant, publish, span)
from .events import events as bus_events          # noqa: F401
from .export import chrome_trace, write_trace     # noqa: F401
from .xprof import (COLLECTIVE_KINDS, analyze,    # noqa: F401
                    collective_counts)
from .report import report, snapshot              # noqa: F401
