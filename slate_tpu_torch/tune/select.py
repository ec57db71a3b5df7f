"""Selection layer (counterpart of ``slate_tpu/tune/select.py``): the
single decision path every driver consults for a tunable knob.

Resolution precedence, strictly:

  1. an EXPLICIT user option always wins;
  2. a MEASURED cache entry for (op, backend, device, dtype, bucket),
     when tuning is enabled (``SLATE_TPU_TORCH_TUNE`` != 0 and the
     per-call ``Option.Tune`` is not False);
  3. the caller's ``fallback`` or the FROZEN shipped default.
"""

from __future__ import annotations

import contextlib
from typing import Any, Optional

from . import cache as _cache
from . import stats

_UNSET = object()

#: process-wide bypass of cached entries (the frozen-defaults switch)
_disabled_depth = 0


@contextlib.contextmanager
def disabled():
    """Temporarily bypass cached entries (explicit options and frozen
    defaults still apply)."""
    global _disabled_depth
    _disabled_depth += 1
    try:
        yield
    finally:
        _disabled_depth -= 1


def _tuning_active(opts) -> bool:
    if _disabled_depth > 0 or not _cache.enabled():
        return False
    from ..core.options import Option, get_option
    return bool(get_option(opts, Option.Tune, True))


def resolve(op: str, param: str, *, opts=None, option=None,
            n: Optional[int] = None, dtype=None,
            fallback: Any = _UNSET) -> Any:
    """Resolve one tunable knob (module doc precedence)."""
    from ..core.options import get_option, has_option
    if option is not None and has_option(opts, option):
        v = get_option(opts, option)
        stats.record_decision(op, param, "explicit", v)
        return v
    if _tuning_active(opts):
        v = _cache.get_cache().get_param(op, param, dtype, n)
        if v is not None:
            stats.record_decision(op, param, "cached", v)
            return v
    v = fallback if fallback is not _UNSET \
        else _cache.frozen_default(op, param)
    stats.record_decision(op, param, "frozen", v)
    return v


def tuned_int(op: str, param: str, fallback: int, *, opts=None,
              option=None, n=None, dtype=None) -> int:
    """resolve() for integer knobs."""
    return int(resolve(op, param, opts=opts, option=option, n=n,
                       dtype=dtype, fallback=fallback))


def tuned_method(op: str, family: str, *, opts=None, option=None,
                 n=None, dtype=None):
    """Method-routing knob: a methods.py enum member, or None when
    nothing is cached (the caller keeps its frozen route). An unknown
    cached string is ignored rather than fatal."""
    from ..core.options import has_option
    if option is not None and has_option(opts, option):
        return None
    if not _tuning_active(opts):
        return None
    v = _cache.get_cache().get_param(op, "method_" + family, dtype, n)
    if v is None:
        return None
    from ..core.methods import str2method
    try:
        m = str2method(family, str(v))
    except KeyError:
        return None
    stats.record_decision(op, "method_" + family, "cached", v)
    return m
