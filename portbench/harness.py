"""One run of one cell, on a device the launcher gives.

Set-up: the configuration's tune state, a pool of distinct inputs made
by its generator from the seed on the device, and the traffic's warm-up
calls. The window: the traffic's loop (``loops/<loop>.py``) drives the
entry until ``seconds`` have passed and records every call. A traced run
(``--trace 1``) profiles ``trace_calls`` calls of its window from its
second call on, with the port's driver spans and the entry's layer
ranges on. After the window the program's state is freed and a sample
of the calls' outputs, drawn from the seed, is judged by the
configuration's check (``checks/<check>.py``) against inputs made anew
from the seed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import sys
import time
from typing import Any, Dict, List, Optional

import torch

from portbench import program
from portbench import trace as trace_mod


@dataclasses.dataclass
class CallRecord:
    index: int
    system: int
    t0: float
    t1: float
    extras: Dict[str, Any]


@dataclasses.dataclass
class Context:
    """What a metric's reader reads."""
    cell: Any
    roofline: Any
    device: torch.device
    calls: List[CallRecord]
    setup_s: float
    trace: Optional[trace_mod.Trace]

    @property
    def config(self) -> Dict[str, Any]:
        return self.cell.config

    @property
    def traffic(self) -> Dict[str, Any]:
        return self.cell.traffic

    @property
    def window_s(self) -> float:
        return self.calls[-1].t1 - self.calls[0].t0

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Sample:
    """A reservoir of k calls' outputs, drawn uniformly from all calls by
    a generator seeded from the run's seed."""

    def __init__(self, k: int, seed: int) -> None:
        self.k, self.rng, self.seen = k, random.Random(seed), 0
        self.kept: List[tuple] = []

    def offer(self, item: tuple) -> None:
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.kept[j] = item


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def _stderr(text: str) -> None:
    print("portbench: " + text, file=sys.stderr)


class Tracer:
    """In a traced run, the profiler over ``count`` calls of the window
    from its second on, each inside a ``portbench::call`` range; a no-op
    otherwise. A loop wraps call i in ``begin(i)`` and calls ``end()``
    once the call is recorded."""

    def __init__(self, acts, count: int) -> None:
        self.acts, self.count = acts, count if acts else 0
        self.prof = None
        self.stopped = False
        self.call_t0: List[float] = []

    def begin(self, i: int):
        if self.count and i >= 1 and self.prof is None:
            self.prof = torch.profiler.profile(activities=self.acts)
            self.prof.start()
        if self.prof is None or len(self.call_t0) >= self.count:
            return contextlib.nullcontext()
        return self._range()

    @contextlib.contextmanager
    def _range(self):
        self.call_t0.append(time.perf_counter())
        with torch.profiler.record_function(trace_mod.CALL_RANGE):
            yield

    def end(self) -> None:
        if self.prof is not None and len(self.call_t0) == self.count \
                and not self.stopped:
            self.prof.stop()
            self.stopped = True

    def close(self) -> None:
        if self.prof is not None and not self.stopped:
            self.prof.stop()
            self.stopped = True


@dataclasses.dataclass
class Window:
    """What a loop hands back: every call of the window, the calls that
    raised, the entries' failure reports, and a sample of the outputs."""
    calls: List[CallRecord]
    sample: Sample
    raised: int = 0
    reported: int = 0

    def record(self, i: int, system: int, t0: float, t1: float,
               out: Dict[str, Any]) -> None:
        """Call i on pool system `system` answered `out` (``x`` and
        ``info`` are the judged output and a failure report, LAPACK's
        ``info``; anything else is kept for the metrics)."""
        extras = {k: v for k, v in out.items() if k not in ("x", "info")}
        self.calls.append(CallRecord(i, system, t0, t1, extras))
        if out.get("info") is not None and int(out["info"]) != 0:
            self.reported += 1
        self.sample.offer((i, system, out))

    def summary(self) -> None:
        if len(self.calls) < 5:
            return
        each = [(c.t1 - c.t0) * 1e3 for c in self.calls]
        ms = sorted(each)
        q = len(each) // 5
        fifths = [sum(each[k * q:(k + 1) * q]) / q for k in range(5)]
        _stderr("%d calls, ms min %.2f median %.2f max %.2f; mean of each "
                "fifth %s" % (len(ms), ms[0], ms[len(ms) // 2], ms[-1],
                              " ".join("%.2f" % f for f in fifths)))


def _setup(ent, gen, cell, seed, device, t_process0):
    """The tune state, the pool of systems and the warm-up calls."""
    cfg, tr = cell.config, cell.traffic
    marks = [("start", time.perf_counter())]
    program.write_tune_state(cfg, cell.config_entry["name"])
    marks.append(("port", time.perf_counter()))
    pool = []
    for i in range(tr["pool"]):
        inputs = gen.make(seed, i, cfg, tr, device)
        pool.append(ent.prepare(cfg, tr, inputs, device))
        del inputs
    sync(device)
    marks.append(("pool", time.perf_counter()))
    for i in range(tr["warmup_calls"]):
        ent.call(pool[i % len(pool)])
        sync(device)
        marks.append(("warmup%d" % i, time.perf_counter()))
    _stderr("set-up " + " ".join("%s %.3f" % (name, t - t_process0)
                                 for name, t in marks))
    return pool


def _judge(w: Window, check, gen, cell, seed, device):
    """The sampled calls' outputs, judged by the configuration's check
    against inputs made anew from the seed, and the calls that raised or
    reported a failure: (checks, correct, calls judged wrong)."""
    cfg, tr = cell.config, cell.traffic
    kept = sorted(w.sample.kept, key=lambda t: t[0])
    w.sample.kept.clear()
    checks, ok, wrong = check.judge(
        cell, [(s, out) for _, s, out in kept],
        lambda s: gen.make(seed, s, cfg, tr, device), device)
    failed = w.raised + w.reported
    checks["calls_failed"] = {"value": failed, "limit": 0}
    correct = bool(w.calls) and failed == 0 and bool(ok)
    return checks, correct, failed + wrong


def measure(reg, cell, seed: int, seconds: float, traced: bool,
            device: torch.device, t_process0: float,
            entry: Optional[str] = None, chips: int = 1) -> Dict[str, Any]:
    """Run the cell once; the result line's object (``checks`` last)."""
    cfg, tr = cell.config, cell.traffic
    ent = reg.module("entries", entry or cfg["entry"])
    gen = reg.module("generators", cfg["generator"])
    loop = reg.module("loops", tr["loop"])
    check = reg.module("checks", cfg["check"])
    pool = _setup(ent, gen, cell, seed, device, t_process0)
    acts = None
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts):
            torch.ones(8, device=device).sum()
            sync(device)
        program.enable_spans()
    ranges = program.layer_ranges(ent.SPANS) if traced \
        else contextlib.nullcontext()
    tracer = Tracer(acts, tr.get("trace_calls", 0))
    w = Window([], Sample(tr["check_calls"], seed))
    setup_s = time.perf_counter() - t_process0
    with ranges:
        loop.run(ent, pool, tr, seconds, device, w, tracer)
    tracer.close()
    sync(device)
    w.summary()
    # the allocator's peak since the process began: set-up and window
    memory_peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0

    tr_obj = None
    if traced:
        spans = program.driver_spans()
        if tracer.prof is not None:
            tr_obj = trace_mod.read(tracer.prof, spans, tracer.call_t0)
        if tr_obj is not None:
            tied = sum(o.corr in tr_obj.launch_ts for o in tr_obj.device)
            _stderr("traced %d calls, %d device ops, %d tied to their "
                    "launch, %d ranges" % (len(tr_obj.calls),
                                           len(tr_obj.device), tied,
                                           len(tr_obj.ranges)))
    # the program's state goes before the reference runs
    del pool
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks, correct, failed = _judge(w, check, gen, cell, seed, device)

    ctx = Context(cell=cell, roofline=reg.module("roofline", cfg["roofline"]),
                  device=device, calls=w.calls, setup_s=setup_s, trace=tr_obj)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = reg.module("metrics", m["name"]).read(ctx) if w.calls else None
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": _device_name(device), "count": chips,
           "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": len(w.calls) + w.raised,
              "failed": failed, "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = tr_obj.busy_s() if tr_obj else 0.0
        dev["window_s"] = tr_obj.window_s if tr_obj else 0.0
        if tr_obj:
            result["breakdown"] = {"device_ops": tr_obj.top_ops(),
                                   "idle_gaps": tr_obj.idle_gaps()}
    result["checks"] = checks
    return result
