"""The arithmetic of the metrics, one function a quantity; each file
``metrics/<name>.py`` names the one it reads. A reader returns None
where it finds nothing to read, and the harness leaves the metric out.

``ctx`` is ``harness.Context``: the window's calls (host-clock start
and end, what the entry returned beyond its output), the set-up time,
the configuration, the traffic, its roofline count and, in a traced
run, the profiler's trace of the traced calls.
"""

import functools
import glob
import importlib.util
import os
import re
import statistics
from typing import FrozenSet, Tuple

PANEL_RANGE = "portbench::panel"

#: parts of the kernel names of cuBLAS / cuSOLVER routines (case aside),
#: matched in the kernel's own identifier
LIBRARY_NAME_PARTS = (
    "gemm", "gemv", "trsm", "trsv", "getrf", "getf2", "laswp", "xmma",
    "splitkreduce", "iamax", "nrm2", "dot_kernel", "scal_kernel",
    "axpy_kernel", "swap_kernel", "ger_kernel", "trmm")
#: the libraries' own names, matched anywhere in a kernel's name (its
#: template arguments too)
LIBRARY_NAMES = ("cublas", "cusolver", "cutlass", "magma")
#: namespaces of PyTorch's and the port's own kernels: never library
OWN_NAMESPACES = ("at::", "c10::", "slate_torch::")
#: the port's CUDA sources: every ``__global__`` function there is a hand
#: kernel, whatever its name holds
PORT_PACKAGE, PORT_KERNEL_SOURCES = "slate_tpu_torch", ("ops", "csrc")


@functools.lru_cache(maxsize=None)
def hand_kernels() -> FrozenSet[str]:
    """The identifiers of the ``__global__`` functions of the port's
    CUDA sources, read from the files (the package is not imported)."""
    spec = importlib.util.find_spec(PORT_PACKAGE)
    if spec is None or not spec.submodule_search_locations:
        return frozenset()
    root = os.path.join(list(spec.submodule_search_locations)[0],
                        *PORT_KERNEL_SOURCES)
    names = set()
    for path in sorted(glob.glob(os.path.join(root, "**", "*.cu*"),
                                 recursive=True)):
        with open(path, errors="replace") as f:
            text = _LAUNCH_BOUNDS.sub(" ", f.read())
        names.update(_GLOBAL.findall(text))
    return frozenset(names)


_LAUNCH_BOUNDS = re.compile(r"__launch_bounds__\s*\([^)]*\)")
_GLOBAL = re.compile(r"__global__[^(;{]*?(\w+)\s*\(")


def kernel_identifier(name: str) -> Tuple[str, str]:
    """A device kernel's name as the profiler shows it, demangled
    (``void ns::kernel<T, 4>(T*, int)``) or not, split into its qualified
    name without template arguments or parameters and its last part."""
    n = name.strip().replace("(anonymous namespace)", "{anonymous}")
    if n.startswith("void "):
        n = n[5:]
    out, depth = [], 0
    for ch in n:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(depth - 1, 0)
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            out.append(ch)
    qual = "".join(out).strip()
    return qual, qual.split("::")[-1]


def is_library(name: str) -> bool:
    """Whether a device kernel is cuBLAS's or cuSOLVER's: not one of the
    port's hand kernels nor in PyTorch's or the port's namespaces, and
    named as the libraries name theirs."""
    qual, ident = kernel_identifier(name)
    if ident in hand_kernels() or qual.startswith(OWN_NAMESPACES):
        return False
    low = name.lower()
    return any(p in ident.lower() for p in LIBRARY_NAME_PARTS) or \
        any(p in low for p in LIBRARY_NAMES)


def gflops(ctx):
    """Classical operations of every call completed in the window over
    the whole window's host-clock time, first start to last end."""
    flops = ctx.roofline.call_flops(ctx.config, ctx.traffic)
    return flops * len(ctx.calls) / ctx.window_s / 1e9


def solve_p90_ms(ctx):
    """The 90th percentile of every call's host-clock time, start to the
    synchronize after it."""
    ms = [(c.t1 - c.t0) * 1e3 for c in ctx.calls]
    if len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=10, method="inclusive")[8]


def setup_s(ctx):
    return ctx.setup_s


def device_idle_share(ctx):
    """One minus the union of the device intervals over the traced
    calls' wall."""
    if ctx.trace is None or not ctx.trace.device:
        return None
    return 1.0 - ctx.trace.busy_s() / ctx.trace.window_s


def device_ops_per_call(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return len(ctx.trace.device) / len(ctx.trace.calls)


def _panel_device_s(ctx):
    if ctx.trace is None:
        return None
    ops = ctx.trace.launched_in(PANEL_RANGE)
    if not ops:
        return None
    return sum(o.te - o.ts for o in ops) / 1e6 / len(ctx.trace.calls)


def panel_ms(ctx):
    """Device time a traced call of what was launched inside the LU
    panel's range, tied by correlation id, not by kernel name."""
    s = _panel_device_s(ctx)
    return None if s is None else s * 1e3


def panel_roofline(ctx):
    """The panels' least time (the configuration's schedule, each panel
    the larger of operations over the factor type's peak and bytes over
    the memory rate) over their device time, in %."""
    s = _panel_device_s(ctx) if ctx.on_card else None
    if not s:
        return None
    return 100.0 * ctx.roofline.panel_bound_s(ctx.config) / s


def library_ms(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    ops = [o for o in ctx.trace.device if is_library(o.name)]
    return sum(o.te - o.ts for o in ops) / 1e3 / len(ctx.trace.calls)


def refine_iters(ctx):
    """The refinement's iterations a call as the driver returns them (a
    fallback's negative count read as the sweeps it made)."""
    its = [c.extras["iters"] for c in ctx.calls if "iters" in c.extras]
    if not its:
        return None
    return sum(i if i >= 0 else -i - 1 for i in its) / len(its)
