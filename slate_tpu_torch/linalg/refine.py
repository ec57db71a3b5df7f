"""Mixed-precision iterative refinement (counterpart of
``slate_tpu/linalg/refine.py``): ``lo_dtype``,
``iterative_refinement``, ``fgmres_ir``, ``lo_rhs_solver``, and
``host_ir``, the out-of-core solves' loop over host-resident operands.

The pattern (reference src/gesv_mixed.cc, gesv_mixed_gmres.cc): factor
in lo precision (f32 -> bf16, f64 -> f32), refine the hi-precision
residual with lo-precision solves, and fall back to a full-precision
solve on non-convergence (Option::UseFallbackSolver). FGMRES-IR
right-preconditions restarted GMRES with the lo solve.

The reference's ``while_loop``/``cond`` are Python loops here. The
convergence test is the only host read of a device value: one per
sweep (IR) or per restart cycle (FGMRES). With obs on, each call counts
``refine.<kind>.calls``, observes ``refine.<kind>.iters`` and publishes
one instant; a fallback also counts ``refine.<kind>.fallback`` and
steps down the resil ladder's ``mixed_to_full`` rung.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ..core.options import Option, OptionsLike, get_option
from ..core.tiles import TiledMatrix


def lo_dtype(dtype):
    """Precision pairs: the reference's (d -> s, z -> c), plus
    f32 -> bf16."""
    if dtype == torch.float64:
        return torch.float32
    if dtype == torch.complex128:
        return torch.complex64
    if dtype == torch.float32:
        return torch.bfloat16
    return dtype


def _record_refine(kind: str, iters: int) -> None:
    """Observability of one refinement call: the call count, the sweep
    count and the fallback flag (iters < 0 per the reference's info
    convention, decoded before it is observed), one obs instant, and a
    fallback through the resil escalation funnel (``mixed_to_full``).
    No-op with obs off; `iters` is already a host value."""
    from ..obs import events as obs
    from ..obs import metrics as obs_metrics
    if not obs.enabled():
        return
    sweeps = iters if iters >= 0 else -iters - 1
    obs_metrics.inc("refine.%s.calls" % kind)
    obs_metrics.observe("refine.%s.iters" % kind, sweeps)
    obs.instant("refine.%s" % kind, cat="refine", iters=iters,
                sweeps=sweeps, fallback=iters < 0)
    if iters < 0:
        obs_metrics.inc("refine.%s.fallback" % kind)
        from ..resil.guard import record_escalation
        record_escalation("mixed_to_full", kind=kind, sweeps=int(sweeps))


def iterative_refinement(A: TiledMatrix, B: TiledMatrix,
                         solve_lo: Callable, full_solve: Callable,
                         opts: OptionsLike = None):
    """The IR loop (reference gesv_mixed.cc:24-40 control flow).
    solve_lo: hi-dtype dense rhs -> hi-dtype dense solution using the lo
    factors. full_solve: () -> dense solution at full precision.
    Returns (x_dense, iters) with iters < 0 on fallback."""
    itermax = get_option(opts, Option.MaxIterations, 30)
    use_fallback = get_option(opts, Option.UseFallbackSolver, True)
    a_hi = A.to_dense()
    b_hi = B.to_dense()
    n = a_hi.shape[0]
    eps = torch.finfo(a_hi.dtype).eps
    anorm = a_hi.abs().sum(dim=1).max()
    cte = anorm * eps * math.sqrt(n)

    def resid(x):
        return b_hi - a_hi @ x

    def converged(x, r_):
        # the one host read of a sweep
        return bool(r_.abs().max() <= x.abs().max() * cte)

    x = solve_lo(b_hi)
    r_ = resid(x)
    iters = 0
    done = converged(x, r_)
    while not done and iters < itermax:
        x = x + solve_lo(r_)
        r_ = resid(x)
        iters += 1
        done = converged(x, r_)
    if itermax > 0 and done:
        # one polish step past the normwise criterion (only when it was
        # met, so MaxIterations stays an upper bound on lo solves for a
        # system that does not converge): it buys the contraction factor
        # once more, for elementwise accuracy of small entries; not
        # counted in iters
        x = x + solve_lo(r_)
    if use_fallback and not done:
        x = full_solve()
        iters = -iters - 1
    _record_refine("ir", iters)
    return x, iters


def _lstsq_svd(H: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """min ||H y - rhs|| by the SVD, on H's device, with the cutoff of
    ``jnp.linalg.lstsq``: singular values below eps * max(m, n) times
    the largest count as zero. (``torch.linalg.lstsq`` on CUDA has only
    ``gels``, which assumes full rank, and H loses rank at a lucky
    breakdown.)"""
    U, s, Vh = torch.linalg.svd(H, full_matrices=False)
    rcond = torch.finfo(H.dtype).eps * max(H.shape)
    keep = s >= rcond * s[0]
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    return Vh.mH @ (s_inv.to(H.dtype) * (U.mH @ rhs))


def fgmres_ir(A: TiledMatrix, B: TiledMatrix, solve_lo: Callable,
              full_solve: Callable, restart_cap: int,
              opts: OptionsLike = None):
    """Restarted FGMRES right-preconditioned by the lo-precision solve
    (reference gesv_mixed_gmres.cc: restart = min(30, itermax, mb-1)).
    One right-hand side. Returns (x_dense (n, 1), iters), iters < 0 on
    fallback."""
    itermax = get_option(opts, Option.MaxIterations, 30)
    use_fallback = get_option(opts, Option.UseFallbackSolver, True)
    a_hi = A.to_dense()
    b_hi = B.to_dense()
    hi = a_hi.dtype
    n = a_hi.shape[0]
    b = b_hi.reshape(n)
    restart = int(max(1, min(30, itermax, restart_cap)))

    def precond(v):
        return solve_lo(v[:, None])[:, 0]

    def matvec(v):
        return a_hi @ v

    eps = torch.finfo(hi).eps
    anorm = a_hi.abs().sum(dim=1).max()
    tol = eps * math.sqrt(n) * anorm

    def cycle(x):
        r_ = b - matvec(x)
        beta = torch.linalg.vector_norm(r_)
        V = torch.zeros((restart + 1, n), dtype=hi, device=b.device)
        V[0] = r_ / torch.where(beta == 0, torch.ones_like(beta), beta)
        Z = torch.zeros((restart, n), dtype=hi, device=b.device)
        H = torch.zeros((restart + 1, restart), dtype=hi, device=b.device)
        for j in range(restart):
            z = precond(V[j])
            w = matvec(z)
            for i in range(j + 1):         # modified Gram-Schmidt
                hij = torch.vdot(V[i], w)
                H[i, j] = hij
                w = w - hij * V[i]
            hnext = torch.linalg.vector_norm(w)
            H[j + 1, j] = hnext
            V[j + 1] = w / torch.where(hnext == 0, torch.ones_like(hnext),
                                       hnext)
            Z[j] = z
        e1 = torch.zeros(restart + 1, dtype=hi, device=b.device)
        e1[0] = beta
        return x + Z.T @ _lstsq_svd(H, e1)

    def converged(x):
        # the one host read of a cycle
        return bool(torch.linalg.vector_norm(b - matvec(x))
                    <= tol * torch.linalg.vector_norm(x))

    ncycles = max(1, -(-itermax // restart))
    x = precond(b)
    cycles = 0
    done = converged(x)
    while not done and cycles < ncycles:
        x = cycle(x)
        cycles += 1
        done = converged(x)
    iters = cycles * restart
    if use_fallback and not done:
        x = full_solve()[:, 0]
        iters = -iters - 1
    _record_refine("fgmres", iters)
    return x[:, None], iters


def host_ir(op: str, a, b, x, solve_lo: Callable,
            full_solve: Callable, opts: OptionsLike = None):
    """Host-loop iterative refinement of the out-of-core mixed solves
    (posv_ooc / gesv_ooc under ``precision="bf16"``): the factor was
    computed with lo-precision trailing updates and the solve sweeps
    stage lo panels, so the first solution `x` is lo-grade; each sweep
    computes the FULL-precision residual ``b - a @ x`` on the host (the
    matrix is host-resident at that scale: one host product a sweep, no
    extra streaming; torch's threaded CPU product) and corrects it with
    one more lo solve. The stopping rule is iterative_refinement's
    normwise bound (max|r| <= max|x| * anorm * eps * sqrt(n) at the
    input dtype's eps), and, as there, one polish sweep follows once it
    holds (not counted in iters, skipped when MaxIterations is 0): the
    reference's host loop stops at the bound, which at the out-of-core
    sizes leaves backward errors near 1e-5 in f32 (ROADMAP queue 3).

    Non-convergence within ``Option.MaxIterations`` is the residual
    sentinel: the ``mixed_to_full`` rung is recorded through the resil
    guard funnel (counted with obs off too), BEFORE ``full_solve()``
    supplies the full-precision answer. Returns (x, iters), iters < 0 on
    fallback. Numpy in and out. With obs on the loop runs under an
    ``ooc::refine`` span and publishes ``refine.ooc.calls`` /
    ``refine.ooc.iters`` (and ``refine.ooc.fallback``)."""
    import numpy as np
    from ..obs import events as obs_events
    from ..obs import metrics as obs_metrics
    from .stream import _host_tensor
    itermax = int(get_option(opts, Option.MaxIterations, 30))
    use_fallback = get_option(opts, Option.UseFallbackSolver, True)
    at = _host_tensor(np.asarray(a))
    bt = _host_tensor(np.asarray(b))
    hi = np.asarray(a).dtype
    n = at.shape[0]
    eps = np.finfo(hi).eps
    anorm = float(at.abs().sum(dim=1).max())
    cte = anorm * eps * math.sqrt(n)

    def resid(x):
        return (bt - at @ torch.from_numpy(x)).numpy()

    def converged(x, r):
        return bool(np.abs(r).max() <= np.abs(x).max() * cte)

    def correct(x, r):
        return x + np.asarray(solve_lo(r), dtype=hi)

    with obs_events.span("ooc::refine", cat="refine", op=op):
        x = np.asarray(x, dtype=hi)
        r = resid(x)
        it = 0
        done = converged(x, r)
        while not done and it < itermax:
            x = correct(x, r)
            r = resid(x)
            it += 1
            done = converged(x, r)
        iters = it
        if itermax > 0 and done:
            x = correct(x, r)               # the polish sweep
        if not done and use_fallback:
            iters = -it - 1
            # the sentinel goes through the resil funnel BEFORE the
            # fallback work: a fallback that fails still left it on
            # record
            from ..resil.guard import record_escalation
            record_escalation("mixed_to_full", kind="ooc", op=op,
                              sweeps=int(it))
            x = np.asarray(full_solve(), dtype=hi)
    if obs_events.enabled():
        obs_metrics.inc("refine.ooc.calls")
        obs_metrics.observe("refine.ooc.iters",
                            iters if iters >= 0 else -iters - 1)
        if iters < 0:
            obs_metrics.inc("refine.ooc.fallback")
    return x, iters


def lo_rhs_solver(B: TiledMatrix, lo, solver) -> Callable:
    """Build solve_lo: hi dense rhs -> hi dense solution, where `solver`
    maps a lo TiledMatrix rhs to a TiledMatrix solution."""
    rb = B.resolve()

    def solve_lo(rhs_hi):
        data = torch.nn.functional.pad(
            rhs_hi.to(lo), (0, rb.data.shape[1] - rhs_hi.shape[1],
                            0, rb.data.shape[0] - rhs_hi.shape[0]))
        Rhs = dataclasses.replace(rb, data=data)
        return solver(Rhs).to_dense().to(rhs_hi.dtype)

    return solve_lo
