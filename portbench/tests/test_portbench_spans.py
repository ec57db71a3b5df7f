"""The port's own ``lu::panel`` spans against the harness's
``portbench::panel`` range, on the card (``-m card``): in a traced call
of ``lu_f32.rhs64`` every harness range holds exactly one port range,
the device time of the kernels tied to each by correlation id is the
same, and each span's CUDA-event device time is at least the busy time
of those kernels. Prints one JSON line of what it read."""

import json
import os

import pytest
import torch

from portbench import program
from portbench import trace as trace_mod
from portbench.registry import Registry

CELL = "lu_f32.rhs64"
#: CUDA events and the profiler's kernel clock each resolve about half
#: a microsecond
CLOCK_SLACK_US = 2.0


def _tied_us(rng, device, launch_ts):
    """The kernels launched inside `rng` (tied by correlation id): their
    summed and their merged (busy) device time, in us."""
    t0, t1 = rng
    ops = sorted((o for o in device
                  if t0 <= launch_ts.get(o.corr, -1.0) <= t1),
                 key=lambda o: o.ts)
    busy, end = 0.0, None
    for o in ops:
        a = o.ts if end is None else max(o.ts, end)
        if o.te > a:
            busy += o.te - a
        end = o.te if end is None else max(end, o.te)
    return sum(o.te - o.ts for o in ops), busy, len(ops)


@pytest.mark.card
def test_port_panel_spans_match_the_harness_ranges(tmp_tmpdir):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from slate_tpu_torch.obs import events, metrics
    reg = Registry()
    cell = reg.cell(CELL)
    cfg, tr = cell.config, cell.traffic
    device = torch.device("cuda", 0)
    program.write_tune_state(cfg, cell.config_entry["name"])
    ent = reg.module("entries", cfg["entry"])
    gen = reg.module("generators", cfg["generator"])
    handle = ent.prepare(cfg, tr, gen.make(2 ** 31 + 24, 0, cfg, tr, device),
                         device)
    ent.call(handle)
    torch.cuda.synchronize(device)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    events.clear()
    metrics.reset()
    events.enable()
    try:
        with program.layer_ranges(ent.SPANS):
            with torch.profiler.profile(activities=acts) as prof:
                ent.call(handle)
                torch.cuda.synchronize(device)
        spans = sorted((e for e in events.events(cat="layer")
                        if e.name == "lu::panel"), key=lambda e: e.t0)
        totals = events.device_seconds()
    finally:
        events.disable()
    path = os.path.join(str(tmp_tmpdir), "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        raw = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    device_ops = [trace_mod.DeviceOp(float(e["ts"]),
                                     float(e["ts"]) + float(e["dur"]),
                                     e["name"],
                                     (e.get("args") or {}).get("correlation"))
                  for e in raw if e.get("cat") in trace_mod.DEVICE_CATS]
    launch_ts = {e["args"]["correlation"]: float(e["ts"]) for e in raw
                 if e.get("cat") in trace_mod.LAUNCH_CATS
                 and (e.get("args") or {}).get("correlation") is not None}
    assert device_ops and launch_ts
    ranges = {}
    for name in ("portbench::panel", "lu::panel"):
        ranges[name] = sorted((float(e["ts"]),
                               float(e["ts"]) + float(e.get("dur", 0)))
                              for e in raw if e["name"] == name
                              and e.get("cat") == "user_annotation")
    outer, inner = ranges["portbench::panel"], ranges["lu::panel"]
    assert outer and len(outer) == len(inner) == len(spans)
    rows = []
    for (o0, o1), (i0, i1), sp in zip(outer, inner, spans):
        held = [r for r in inner if o0 <= r[0] and r[1] <= o1]
        assert held == [(i0, i1)]
        o_sum, _, o_n = _tied_us((o0, o1), device_ops, launch_ts)
        i_sum, i_busy, i_n = _tied_us((i0, i1), device_ops, launch_ts)
        assert (o_n, o_sum) == (i_n, i_sum) and i_n > 0
        ev_us = sp.device.seconds * 1e6
        assert ev_us >= i_busy - CLOCK_SLACK_US, (ev_us, i_busy)
        rows.append([round(ev_us, 3), round(i_busy, 3), i_n])
    ev_total = sum(r[0] for r in rows)
    assert totals["lu::panel"][0] == len(rows)
    assert abs(totals["lu::panel"][1] * 1e6 - ev_total) < 1e-3 * ev_total
    print(json.dumps({"card_check": CELL,
                      "device": torch.cuda.get_device_name(device),
                      "panels": len(rows),
                      "event_ms": round(ev_total / 1e3, 3),
                      "tied_busy_ms": round(sum(r[1] for r in rows) / 1e3,
                                            3),
                      "per_panel_us_event_busy_kernels": rows}))
