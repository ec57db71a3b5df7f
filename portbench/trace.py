"""Reading a ``torch.profiler`` trace of the traced calls.

The profiler's Chrome trace is written under the run's temporary
directory, read back and deleted. Times are microseconds on the trace's
clock. Device work is every kernel, copy and memset; a device operation
is tied to the host call that launched it by the profiler's correlation
id, so the harness's ``portbench::<layer>`` ranges claim the device time
of what was launched inside them, whatever runs it.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import statistics
import tempfile
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
RANGE_CATS = ("user_annotation", "cpu_op")
CALL_RANGE = "portbench::call"

Span = Tuple[float, float, str]


@dataclasses.dataclass
class DeviceOp:
    ts: float
    te: float
    name: str
    corr: Optional[int]


@dataclasses.dataclass
class Trace:
    device: List[DeviceOp]
    launch_ts: Dict[int, float]
    ranges: List[Span]          # portbench::* and the port's driver spans
    cpu_ops: List[Span]         # the calling thread's operators
    runtime: List[Span]         # the calling thread's CUDA API calls
    calls: List[Tuple[float, float]]

    @property
    def window(self) -> Tuple[float, float]:
        return self.calls[0][0], self.calls[-1][1]

    @property
    def window_s(self) -> float:
        t0, t1 = self.window
        return (t1 - t0) / 1e6

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the device intervals inside the window."""
        t0, t1 = self.window
        out: List[Tuple[float, float]] = []
        for op in sorted(self.device, key=lambda o: o.ts):
            a, b = max(op.ts, t0), min(op.te, t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) / 1e6

    def launched_in(self, range_name: str) -> List[DeviceOp]:
        """Device operations launched while a range named `range_name`
        was open on the calling thread."""
        spans = sorted((s for s in self.ranges if s[2] == range_name))
        starts = [s[0] for s in spans]
        out = []
        for op in self.device:
            t = self.launch_ts.get(op.corr) if op.corr is not None else None
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                out.append(op)
        return out

    def top_ops(self, k: int = 10) -> List[List]:
        tot: Dict[str, float] = collections.defaultdict(float)
        for op in self.device:
            tot[op.name] += (op.te - op.ts) / 1e6
        best = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
        return [[name[:160], s] for name, s in best]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """Idle time of the device inside the window, summed by what the
        calling thread was doing at each gap's midpoint: the innermost
        range (the harness's or the port's driver span) and the innermost
        operator or CUDA call. The k largest sums, in seconds."""
        t0, t1 = self.window
        edges = [t0]
        for a, b in self.busy():
            edges += [a, b]
        edges.append(t1)
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        mids = [(a + b) / 2 for a, b in gaps]
        rng = innermost(self.ranges, mids)
        ops = innermost(self.cpu_ops, mids)
        rt = innermost(self.runtime, mids)
        tot: Dict[str, float] = collections.defaultdict(float)
        cnt: Dict[str, int] = collections.defaultdict(int)
        for (a, b), r, o, c in zip(gaps, rng, ops, rt):
            label = "%s / %s" % (r or "-", o or c or "python")
            tot[label] += (b - a) / 1e6
            cnt[label] += 1
        best = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
        return [["%s (x%d)" % (name[:150], cnt[name]), s]
                for name, s in best]


def innermost(spans: Iterable[Span], queries: Sequence[float]
              ) -> List[Optional[str]]:
    """For each query time, the name of the shortest-lived open span
    that holds it (spans of one thread nest), or None."""
    order = sorted(spans, key=lambda s: (s[0], -s[1]))
    qi = sorted(range(len(queries)), key=lambda i: queries[i])
    out: List[Optional[str]] = [None] * len(queries)
    stack: List[Span] = []
    j = 0
    for i in qi:
        q = queries[i]
        while j < len(order) and order[j][0] <= q:
            while stack and stack[-1][1] <= order[j][0]:
                stack.pop()
            stack.append(order[j])
            j += 1
        while stack and stack[-1][1] < q:
            stack.pop()
        out[i] = stack[-1][2] if stack else None
    return out


def read(prof, host_spans: Sequence[Tuple[str, float, float]] = (),
         host_call_t0: Sequence[float] = ()) -> Optional[Trace]:
    """The trace of a stopped profiler, or None when it holds no traced
    call. `host_spans` ((name, t0, t1) in perf_counter seconds) join the
    ranges, moved onto the trace's clock by the median offset between
    the calls' ranges and `host_call_t0`, their perf_counter starts."""
    d = os.path.join(tempfile.gettempdir(), "portbench")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "trace.json")
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        if os.path.exists(path):
            os.remove(path)
    calls = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                    e.get("tid")) for e in events
                   if e.get("ph") == "X" and e.get("name") == CALL_RANGE
                   and e.get("cat") in RANGE_CATS)
    if not calls:
        return None
    tid = calls[0][2]
    device, launch_ts, ranges, cpu_ops, runtime = [], {}, [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts = e.get("cat"), float(e["ts"])
        te = ts + float(e.get("dur", 0))
        args = e.get("args") or {}
        if cat in DEVICE_CATS:
            device.append(DeviceOp(ts, te, e["name"], args.get("correlation")))
        elif cat in LAUNCH_CATS:
            if args.get("correlation") is not None:
                launch_ts[args["correlation"]] = ts
            if e.get("tid") == tid:
                runtime.append((ts, te, e["name"]))
        elif cat in RANGE_CATS and e.get("tid") == tid:
            if e["name"].startswith("portbench::"):
                if e["name"] != CALL_RANGE:
                    ranges.append((ts, te, e["name"]))
            elif cat == "cpu_op":
                cpu_ops.append((ts, te, e["name"]))
    if host_spans and host_call_t0:
        offset = statistics.median(
            c[0] - t * 1e6 for c, t in zip(calls, host_call_t0))
        ranges += [(t0 * 1e6 + offset, t1 * 1e6 + offset, name)
                   for name, t0, t1 in host_spans]
    return Trace(device=device, launch_ts=launch_ts, ranges=ranges,
                 cpu_ops=cpu_ops, runtime=runtime,
                 calls=[(a, b) for a, b, _ in calls])
