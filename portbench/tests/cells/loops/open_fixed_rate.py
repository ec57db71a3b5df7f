"""Test only: an open loop. Calls arrive every ``interval_s`` seconds,
whatever the system does; one caller issues each at its arrival, or as
soon as the last has finished where the system is behind. A call's time
runs from its arrival, so the time it waited in the queue counts."""

import time

from portbench import harness


def run(ent, pool, traffic, seconds, device, w, tracer):
    step = traffic["interval_s"]
    t_start = time.perf_counter()
    i = 0
    while True:
        arrival = t_start + i * step
        now = time.perf_counter()
        if now < arrival:
            time.sleep(arrival - now)
        s = i % len(pool)
        traced = tracer.begin(i)
        with traced:
            out = ent.call(pool[s])
            harness.sync(device)
        t1 = time.perf_counter()
        w.record(i, s, arrival, t1, out)
        tracer.end()
        i += 1
        if t1 - t_start >= seconds:
            return
