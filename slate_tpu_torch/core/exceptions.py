"""Exceptions (counterpart of ``slate_tpu/core/exceptions.py``)."""

from __future__ import annotations


class SlateError(Exception):
    """Base error for slate_tpu_torch (reference slate::Exception)."""


class DimensionError(SlateError):
    """Shape / conformability violation."""


class OptionError(SlateError):
    """Bad option key or value."""


def slate_assert(cond: bool, msg: str = "") -> None:
    """Reference slate_assert macro (Exception.hh)."""
    if not cond:
        raise SlateError(msg or "assertion failed")


def slate_error_if(cond: bool, msg: str = "") -> None:
    """Reference slate_error_if macro (Exception.hh)."""
    if cond:
        raise SlateError(msg or "error condition")
