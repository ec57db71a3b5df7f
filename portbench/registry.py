"""Finds the parts of a cell by name.

A cell of ``BENCHMARK.json`` names a configuration (its ``file``) and a
traffic mix; the configuration names its driver entry, input generator,
check, roofline count and launcher, the traffic its loop; metrics are
named in ``BENCHMARK.json``. Each part is a file of its own under a root
directory::

    <root>/traffic/<traffic>.json      the mix's parameters
    <root>/loops/<loop>.py             how the window issues the calls
    <root>/entries/<entry>.py          how to call the driver
    <root>/generators/<generator>.py   the inputs, made from the seed
    <root>/checks/<check>.py           how the outputs are judged
    <root>/roofline/<roofline>.py      operation and byte counts
    <root>/launch/<launch>.py          where and how the cell runs
    <root>/metrics/<metric>.py         one reader a metric
    <root>/limits/<cell>.json          the limits of the compared numbers

What each file holds:

- generator: ``make(seed, index, config, traffic, device)``, the inputs
  of pool member `index` as a dict of tensors, the same for the same
  seed; any shapes the configuration and traffic call for.
- entry: ``prepare(config, traffic, inputs, device)``, a handle made at
  set-up; ``call(handle)``, one call of the system under test, returning
  a dict whose ``info`` (if any) reports a failure when non-zero and whose
  other keys the check and the metrics read; ``SPANS``, the port's
  functions a traced run wraps in profiler ranges.
- check: ``judge(cell, outputs, remake, device)`` (see
  ``checks/solve_backward_error.py``).
- loop: ``run(entry, pool, traffic, seconds, device, window, tracer)``,
  which records every call in ``window`` (``harness.Window``) and wraps
  each in ``tracer`` (``harness.Tracer``); see ``loops/closed.py``.
- launcher: ``run(job, chips)`` calling ``job(device)``, and the
  exception ``NoCard`` it raises where the cards are missing.
- metric: ``read(ctx)`` (``harness.Context``), a number or None.

Roots are searched in order, so a test can put a cell made of its own
files in front of this package's.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from typing import Any, Dict, List, Optional, Sequence

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


class LookupFailed(KeyError):
    """A name that no file answers to."""


@dataclasses.dataclass
class Cell:
    name: str
    workload: Dict[str, Any]
    config: Dict[str, Any]          # the configuration file's contents
    config_entry: Dict[str, Any]    # the configuration's BENCHMARK.json entry
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    limits: Dict[str, float]

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Registry:
    def __init__(self, spec_path: Optional[str] = None,
                 roots: Sequence[str] = (HERE,)) -> None:
        self.spec_path = spec_path or os.path.join(REPO, "BENCHMARK.json")
        self.base = os.path.dirname(os.path.abspath(self.spec_path))
        self.roots = tuple(roots)
        with open(self.spec_path) as f:
            self.spec = json.load(f)
        self._modules: Dict[str, Any] = {}

    def path(self, kind: str, name: str, ext: str) -> str:
        for root in self.roots:
            p = os.path.join(root, kind, name + ext)
            if os.path.isfile(p):
                return p
        raise LookupFailed("no %s named %r (%s) under %s"
                           % (kind, name, ext, ", ".join(self.roots)))

    def data(self, kind: str, name: str) -> Dict[str, Any]:
        with open(self.path(kind, name, ".json")) as f:
            return json.load(f)

    def module(self, kind: str, name: str):
        """The file ``<kind>/<name>.py`` as a module (names may hold
        dots, so it is loaded by path, once a process)."""
        p = self.path(kind, name, ".py")
        mod = self._modules.get(p)
        if mod is None:
            key = "portbench_%s_%s" % (kind, "".join(
                c if c.isalnum() else "_" for c in name))
            spec = importlib.util.spec_from_file_location(key, p)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[key] = mod
            spec.loader.exec_module(mod)
            self._modules[p] = mod
        return mod

    def cell(self, name: str) -> Cell:
        wl = [w for w in self.spec["workloads"] if w["name"] == name]
        if not wl:
            raise LookupFailed("no workload named %r in %s"
                               % (name, self.spec_path))
        w = wl[0]
        cfg_entry = [c for c in self.spec["configs"]
                     if c["name"] == w["config"]][0]
        with open(os.path.join(self.base, cfg_entry["file"])) as f:
            config = json.load(f)
        return Cell(
            name=name, workload=w, config=config, config_entry=cfg_entry,
            traffic=self.data("traffic", w["traffic"]),
            end_to_end=[m for m in self.spec["end_to_end"]
                        if _applies(m, name)],
            per_layer=[m for m in self.spec["per_layer"]
                       if _applies(m, name)],
            limits=self.data("limits", name))
