"""Readers of the port's own device-timed spans and counters.

The port's obs bus (``slate_tpu_torch.obs``) sums the device seconds of
its spans per name, from CUDA events around each span
(``events.device_seconds()``), and counts the driver calls made while it
was on (``driver.<op>.calls``). A traced run turns obs on for its whole
window, so a reader here averages every call of that window. A port
without the store (or a run off the card) gives None, and the harness
leaves the metric out.
"""

from typing import Optional, Sequence


def _calls(snap, op: str) -> Optional[float]:
    return snap["counters"].get("driver.%s.calls" % op) or None


def per_call_ms(names: Sequence[str], op: str) -> Optional[float]:
    """The device seconds of the spans `names`, summed, over the calls
    of the driver `op`, in ms."""
    try:
        from slate_tpu_torch.obs import events, metrics
    except ImportError:
        return None
    read = getattr(events, "device_seconds", None)
    if read is None:
        return None
    totals = read()
    hit = [totals[n][1] for n in names if n in totals]
    calls = _calls(metrics.snapshot(), op)
    if not hit or calls is None:
        return None
    return sum(hit) / calls * 1e3


def per_call_count(hist: str, op: str) -> Optional[float]:
    """The total of the histogram `hist` over the calls of the driver
    `op`."""
    try:
        from slate_tpu_torch.obs import metrics
    except ImportError:
        return None
    snap = metrics.snapshot()
    h = snap["histograms"].get(hist)
    calls = _calls(snap, op)
    if h is None or calls is None:
        return None
    return h["total"] / calls
