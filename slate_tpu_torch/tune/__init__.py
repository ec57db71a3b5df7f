"""Autotuning (counterpart of ``slate_tpu/tune/``): measured
performance models and a persistent tuning cache for block sizes and
method routing.

Four parts: tune/probe.py (the microbenchmark driver: ``autotune``
measures each candidate route against the driver's own default on the
device and persists a winner only when it wins by more than
``probe.WIN_MARGIN``), tune/cache.py (versioned JSON cache keyed by
op/backend/device/dtype/size-bucket, with the FROZEN table of shipped
defaults), tune/select.py (the single decision path the drivers
consult: explicit option > measured cache > frozen default) and
tune/stats.py (decision, cache and probe-time counters).

Env switches the port reads: ``SLATE_TPU_TORCH_TUNE=0`` disables
lookups (frozen defaults only: the cold routes);
``SLATE_TPU_TORCH_TUNE_CACHE`` relocates the cache directory (default
``~/.cache/slate_tpu_torch``). Populate it with :func:`autotune`, e.g.
``autotune(ops=("lu_panel",), n=h, dtype=torch.float32)`` for each
panel-height bucket h, which writes the entries that route the LU
panels to the hand kernels where they win on this card.
"""

from . import cache, probe, select, stats          # noqa: F401
from .cache import TuneCache, get_cache, reset_cache  # noqa: F401
from .probe import autotune                        # noqa: F401
from .select import resolve, tuned_int, tuned_method  # noqa: F401
