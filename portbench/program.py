"""What the harness asks of the port beyond its drivers: the tune state a
configuration deploys with, the port's own driver spans (switched on in
traced runs only), and profiler ranges around the port's functions that
an entry names as layers.

The tune state is data in the configuration (``"tune"``): a list of
``{"op", "dtypes", "buckets": [low, high], "values"}``. It is written
into a fresh cache under the run's temporary directory, at a fixed path,
before the port is imported.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import os
import shutil
import tempfile
from typing import Any, Dict, List, Tuple


def write_tune_state(config: Dict[str, Any], config_name: str) -> str:
    """Point the port's tune cache at a new directory holding exactly
    the configuration's entries."""
    d = os.path.join(tempfile.gettempdir(), "portbench", "tune", config_name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    os.environ["SLATE_TPU_TORCH_TUNE_CACHE"] = d
    os.environ.pop("SLATE_TPU_TORCH_TUNE", None)
    import torch
    from slate_tpu_torch.tune import cache as tcache
    tcache.reset_cache()
    cache = tcache.get_cache()
    for item in config.get("tune", ()):
        low, high = item["buckets"]
        for dtype in item["dtypes"]:
            n = low
            while n <= high:
                cache.put(item["op"], getattr(torch, dtype), n,
                          dict(item["values"]))
                n *= 2
    cache.save()
    return d


def enable_spans() -> None:
    from slate_tpu_torch.obs import events
    events.clear()
    events.enable()


def driver_spans() -> List[Tuple[str, float, float]]:
    """The port's driver spans since enable_spans(): (name, t0, t1) on
    the host's perf_counter clock. They end when the driver returns,
    before the device finishes, so they label host time only."""
    from slate_tpu_torch.obs import events
    out = [(e.name, e.t0, e.t1) for e in events.events(cat="driver")
           if e.ph == events.PH_SPAN]
    events.disable()
    return out


@contextlib.contextmanager
def layer_ranges(spans: Dict[str, Tuple[str, str]]):
    """Wrap each (module, function) of `spans` in a profiler range
    ``portbench::<layer>`` for the duration, then restore it."""
    import torch
    saved = []
    for layer, (modname, fname) in spans.items():
        mod = importlib.import_module(modname)
        fn = getattr(mod, fname)

        def wrapped(*args, __fn=fn, __name="portbench::" + layer,
                    **kwargs):
            with torch.profiler.record_function(__name):
                return __fn(*args, **kwargs)

        functools.update_wrapper(wrapped, fn)
        setattr(mod, fname, wrapped)
        saved.append((mod, fname, fn))
    try:
        yield
    finally:
        for mod, fname, fn in saved:
            setattr(mod, fname, fn)
