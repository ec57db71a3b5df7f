"""A closed loop with one caller, as an application's solver loop runs:
each call is issued when the last has returned and the device has
finished it, on the pool's systems in turn, until ``seconds`` have
passed; every call counts. A call's time runs from its issue to the
``synchronize()`` after it. A call that raises ends the window."""

import time
import traceback

from portbench import harness


def run(ent, pool, traffic, seconds, device, w, tracer):
    t_start = time.perf_counter()
    i = 0
    while True:
        s = i % len(pool)
        traced = tracer.begin(i)
        t0 = time.perf_counter()
        try:
            with traced:
                out = ent.call(pool[s])
                harness.sync(device)
        except Exception:                    # the call never answers
            traceback.print_exc()
            w.raised += 1
            return
        t1 = time.perf_counter()
        w.record(i, s, t0, t1, out)
        del out
        tracer.end()
        i += 1
        if t1 - t_start >= seconds:
            return
