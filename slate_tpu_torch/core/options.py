"""Options handling (counterpart of ``slate_tpu/core/options.py``).

Options are a plain dict keyed by :class:`Option` (or str aliases),
read through :func:`get_option` with typed defaults.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Union

from .enums import Option, Target

OptionsLike = Optional[Mapping[Union[Option, str], Any]]

# String aliases so pythonic call sites can write opts={"nb": 512}.
_STR_ALIASES = {
    "lookahead": Option.Lookahead,
    "block_size": Option.BlockSize,
    "nb": Option.BlockSize,
    "inner_blocking": Option.InnerBlocking,
    "ib": Option.InnerBlocking,
    "max_panel_threads": Option.MaxPanelThreads,
    "tolerance": Option.Tolerance,
    "tol": Option.Tolerance,
    "max_iterations": Option.MaxIterations,
    "itermax": Option.MaxIterations,
    "use_fallback_solver": Option.UseFallbackSolver,
    "pivot_threshold": Option.PivotThreshold,
    "target": Option.Target,
    "depth": Option.Depth,
    "method_lu": Option.MethodLU,
    "method_gels": Option.MethodGels,
    "method_gemm": Option.MethodGemm,
    "method_hemm": Option.MethodHemm,
    "method_trsm": Option.MethodTrsm,
    "method_cholqr": Option.MethodCholQR,
    "method_eig": Option.MethodEig,
    "method_svd": Option.MethodSVD,
    "tune": Option.Tune,
}

_DEFAULTS = {
    Option.Lookahead: 1,
    Option.BlockSize: 256,
    Option.InnerBlocking: 128,
    Option.MaxPanelThreads: 1,
    Option.Tolerance: None,       # routine-specific
    Option.MaxIterations: 30,
    Option.UseFallbackSolver: True,
    Option.PivotThreshold: 1.0,
    Option.Target: Target.Devices,
    Option.Depth: 2,
    Option.Tune: True,
}


def normalize_options(opts: OptionsLike) -> dict:
    """Resolve string aliases to Option keys; validate keys."""
    out: dict = {}
    if not opts:
        return out
    for k, v in opts.items():
        if isinstance(k, str):
            kk = _STR_ALIASES.get(k.lower())
            if kk is None:
                raise KeyError(f"unknown option {k!r}")
            out[kk] = v
        elif isinstance(k, Option):
            out[k] = v
        else:
            raise KeyError(f"unknown option key type {type(k)}")
    return out


def get_option(opts: OptionsLike, key: Option, default: Any = None) -> Any:
    """Reference get_option<T> (types.hh): the requested key or one of
    its string aliases, else `default`, else the registry default."""
    if opts:
        if key in opts:
            return opts[key]
        for s, k in _STR_ALIASES.items():
            if k is key and s in opts:
                return opts[s]
    if default is not None:
        return default
    return _DEFAULTS.get(key)


#: options whose value the tune cache may supply (tune param name)
_TUNE_PARAM = {
    Option.BlockSize: "nb",
    Option.InnerBlocking: "ib",
    Option.Lookahead: "lookahead",
}


def get_option_tuned(opts: OptionsLike, key: Option, op: str,
                     n: Optional[int] = None, dtype: Any = None,
                     fallback: Any = None) -> Any:
    """get_option with the tune cache between explicit options and
    defaults (reference get_option_tuned): an explicit `opts` value,
    then a measured entry for (op, dtype, size bucket), then
    `fallback`, then the FROZEN table (whose "*" rows equal _DEFAULTS
    for these keys). Keys outside _TUNE_PARAM degrade to get_option."""
    param = _TUNE_PARAM.get(key)
    if param is None:
        return get_option(opts, key, fallback)
    from ..tune.select import resolve
    if fallback is None:
        return resolve(op, param, opts=opts, option=key, n=n, dtype=dtype)
    return resolve(op, param, opts=opts, option=key, n=n, dtype=dtype,
                   fallback=fallback)


def has_option(opts: OptionsLike, key: Option) -> bool:
    """True iff the caller EXPLICITLY passed `key` (directly or via a
    string alias): tuning never overrides a user choice."""
    if not opts:
        return False
    if key in opts:
        return True
    return any(k is key and s in opts for s, k in _STR_ALIASES.items())
