"""Multi-phase fast solver: fine BDF steps through the stiff excitation
transient, then progressively coarser BDF phases with cubic dense output
of log-PL at every fine observation time.

The PL transient is stiff only for the first few ns after excitation;
beyond that the solution decays on ns-to-us scales, and a fixed dt = 25 ps
oversamples it by a factor that grows with delay time, which the geometric
stride ladder (16 -> 32 -> 64) exploits.  Each coarse phase restarts BDF
(order ramp) at step S*dt and reconstructs log10-PL at the S fine times of
each coarse interval by Lagrange interpolation in log space; the fused
likelihood consumes every one of the T+1 fine observation points.

State carries over unchanged between phases: only the rate columns of the
parameter matrix rescale with dt (rescale_dt).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .solver import (BdfStepper, FusedObs, HISTORY, SolveResult, SolverConfig,
                     _log_pl, _scalar, init_history, pl_observable, solve)
from .step_graph import StepRunner
from .trpl import MatParams

# Columns of the nondimensionalized parameter matrix that scale with dt
# (physics.nondim_scales): diffusivities, B, surface S, Auger ~ dt;
# lifetimes ~ 1/dt.
_DT_SCALING = np.array([0, 0, 1, 1, 1, 1, 1, 1, 1, -1, -1, 0])

# (stride, num_fine_steps) pairs; stride 1 first (the fine phase).
Schedule = Tuple[Tuple[int, int], ...]


def rescale_dt(mat_nd: torch.Tensor, factor: float) -> torch.Tensor:
    """Rescale nondimensional parameters from step dt to step factor*dt."""
    scale = torch.as_tensor(float(factor) ** _DT_SCALING, dtype=mat_nd.dtype,
                            device=mat_nd.device)
    return mat_nd * scale[None, :]


def _lagrange_weight_table(S: int) -> np.ndarray:
    """(3, S, 4) interpolation weights for the S fine offsets of one coarse
    interval, over the trailing window of coarse log-PL nodes.

    Row r = min(c, 2) selects the order used at coarse step c:
      r=0: linear on nodes {c, c+1}            (window cols 2, 3)
      r=1: quadratic on nodes {c-1, c, c+1}    (window cols 1, 2, 3)
      r=2: cubic on nodes {c-2 .. c+1}         (window cols 0..3)
    Offsets j=1..S evaluate at the fine times inside (c, c+1]; j=S lands on
    the node and every row reduces to the exact value.
    """
    tab = np.zeros((3, S, 4))
    for r, nodes in enumerate(([2.0, 3.0], [1.0, 2.0, 3.0], [0.0, 1.0, 2.0, 3.0])):
        cols = list(range(4 - len(nodes), 4))
        for j in range(1, S + 1):
            x = 2.0 + j / S
            for a, xa in enumerate(nodes):
                w = 1.0
                for b, xb in enumerate(nodes):
                    if a != b:
                        w *= (x - xb) / (xa - xb)
                tab[r, j - 1, cols[a]] = w
    return tab


def geometric_schedule(T: int, fine_steps: int = 2048, base_stride: int = 8,
                       growth: int = 2, coarse_steps_per_phase: int = 1024,
                       max_stride: int = 64) -> Schedule:
    """Build a fine-then-geometric phase schedule covering T fine steps.

    Phase 1 covers ``fine_steps`` at stride 1; later phases run
    ``coarse_steps_per_phase`` coarse steps at strides base_stride,
    base_stride*growth, ... capped at ``max_stride``; the final phase
    absorbs the remainder.  Any sub-stride leftover is folded into the fine
    phase, so the schedule sums exactly to T.
    """
    if fine_steps >= T:
        return ((1, T),)
    rem = T - fine_steps
    parts = []
    s = base_stride
    while rem >= s:
        if s >= max_stride or coarse_steps_per_phase * s >= rem:
            take = (rem // s) * s             # final phase absorbs the rest
        else:
            take = coarse_steps_per_phase * s
        parts.append((s, take))
        rem -= take
        s = min(s * growth, max_stride)
    return ((1, fine_steps + rem),) + tuple(parts)


def _validate_schedule(schedule: Schedule, T: int) -> None:
    if not schedule or schedule[0][0] != 1:
        raise ValueError("schedule must start with a stride-1 fine phase")
    total = 0
    for s, n in schedule:
        if n % s:
            raise ValueError(f"phase length {n} not divisible by stride {s}")
        total += n
    if total != T:
        raise ValueError(f"schedule covers {total} steps, expected {T}")


def _coarse_phase(mat_nd, n0, p0, e0, cfg: SolverConfig, obs: FusedObs,
                  pl0, acc, t_off: int, n_fine: int, S: int):
    """Run one coarse phase of n_fine//S coupled-Newton steps at stride S
    from state (n0, p0, e0), accumulating the fused likelihood over the
    fine observation points in (t_off, t_off + n_fine].

    ``acc`` = (converged, max_iters, sample_iters, sse, err_sum) carried
    across phases; ``pl0`` is the t=0 fine-dt PL (for self-normalization).
    Returns (n, p, e, acc).
    """
    C = n_fine // S
    mp = MatParams.from_array(rescale_dt(mat_nd, S))
    # Nondimensional PL scales with dt: shift the log offset (and pl0) to
    # coarse units, in the compute dtype.
    obs_c = FusedObs(values=obs.values,
                     log_scale=_scalar(obs.log_scale, n0) - _scalar(np.log10(S), n0),
                     min_val=obs.min_val, normalize=obs.normalize)
    pl0_c = pl0 * S
    tol = _scalar(cfg.tol, n0)
    step_tol = _scalar(0.0 if cfg.step_tol is None else cfg.step_tol, n0)

    nh, ph, eh = init_history(n0, p0, e0)
    # The trailing window of coarse log-PL nodes, oldest first.
    lp_win = torch.zeros((4,) + pl0.shape, dtype=n0.dtype, device=n0.device)
    lp_win[3] = _log_pl(pl_observable(n0, p0, mp), obs_c, pl0_c)
    wtab = torch.as_tensor(_lagrange_weight_table(S), dtype=n0.dtype,
                           device=n0.device)
    num_exp = obs.values.shape[0]
    vals = obs.values[:, t_off + 1:t_off + n_fine + 1].reshape(num_exp, C, S)
    mask = (None if obs.mask is None else
            obs.mask[:, t_off + 1:t_off + n_fine + 1].reshape(num_exp, C, S))

    conv, max_it, samp_it, sse, esum = (x.clone() for x in acc)
    col = torch.zeros(1, dtype=torch.long, device=n0.device)   # the coarse step

    def update(c, Nn, Pn, En, iters, ok):
        new = _log_pl(pl_observable(Nn, Pn, mp), obs_c, pl0_c)
        lp_win.copy_(torch.cat([lp_win[1:], new[None]]))
        W = wtab[min(c, 2)]                                     # (S, 4)
        lp_fine = sum(W[None, :, a] * lp_win[a][:, None] for a in range(4))
        e = lp_fine[None] - vals.index_select(1, col)           # (num_exp, batch, S)
        if mask is not None:
            m = mask.index_select(1, col)
            # Padding-only coarse steps carry no likelihood weight.
            ok = ok | (m.sum() == 0)
            sse.add_((m * e * e).sum(-1))
            esum.add_((m * e).sum(-1))
        else:
            sse.add_((e * e).sum(-1))
            esum.add_(e.sum(-1))
        conv.logical_and_(ok)
        torch.maximum(max_it, iters.max(), out=max_it)
        samp_it.add_(iters)
        col.add_(1)

    stepper = BdfStepper(nh, ph, eh, mp, cfg, tol, step_tol, StepRunner(n0.device))
    for c in range(C):
        stepper.step(c, lambda *out, c=c: update(c, *out))
    k_final = C % HISTORY
    return nh[k_final], ph[k_final], eh[k_final], (conv, max_it, samp_it, sse, esum)


def solve_multiphase(mat_nd, n_init, p_init, e_init, cfg: SolverConfig,
                     obs: FusedObs, schedule: Schedule,
                     kernel=None) -> SolveResult:
    """Fused-likelihood solve of cfg.num_steps fine-dt steps via the given
    fine/coarse phase schedule.

    With ``method="fused_horizon_chord"`` (chord Newton, under the strict
    chord profile) or ``"fused_horizon"`` (full Newton) each phase is one
    launch of the horizon kernel (stride 1 for the fine phase, stride S for
    each rung); every other method steps through :func:`_coarse_phase`
    (``coupled_newton_pallas``: one launch of the per-step Newton kernel
    per step).  ``kernel`` replaces the horizon kernel's entry
    (ops.horizon_kernel.horizon_chord); tests pass its plain version.
    """
    if cfg.pl_stride != 1:
        raise ValueError("multi-phase solver requires pl_stride == 1")
    # The fast path's accuracy budget requires the STRICT chord profile
    # (ops/horizon_kernel._chord_knobs); full Newton has no chord knobs.
    if cfg.method == "fused_horizon_chord" and not cfg.chord_strict:
        cfg = cfg._replace(chord_strict=True)
    fused = cfg.method in ("fused_horizon", "fused_horizon_chord")
    schedule = tuple((int(s), int(n)) for s, n in schedule)
    _validate_schedule(schedule, cfg.num_steps)
    mp_fine = MatParams.from_array(mat_nd)

    T1 = schedule[0][1]
    obs1 = obs._replace(values=obs.values[:, :T1 + 1],
                        mask=None if obs.mask is None else obs.mask[:, :T1 + 1])
    r1 = solve(mat_nd, n_init, p_init, e_init, cfg._replace(num_steps=T1),
               obs=obs1, record_pl=False, kernel=kernel)
    pl0 = pl_observable(n_init, p_init, mp_fine)

    n, p, e = r1.n, r1.p, r1.e
    acc = (r1.converged, r1.max_newton_iters, r1.sample_iters,
           r1.sse, r1.err_sum)
    t_off = T1
    for S, n_fine in schedule[1:]:
        if fused:
            from ..ops.horizon_kernel import solve_coarse_phase_fused
            r = solve_coarse_phase_fused(mat_nd, n, p, e, cfg, obs, pl0,
                                         t_off, n_fine, S, kernel=kernel)
            n, p, e = r.n, r.p, r.e
            conv, max_it, samp_it, sse, esum = acc
            acc = (conv & r.converged,
                   torch.maximum(max_it, r.max_newton_iters),
                   samp_it + r.sample_iters, sse + r.sse, esum + r.err_sum)
        else:
            n, p, e, acc = _coarse_phase(mat_nd, n, p, e, cfg, obs, pl0,
                                         acc, t_off, n_fine, S)
        t_off += n_fine
    conv, max_it, samp_it, sse, esum = acc
    return SolveResult(pl=None, n=n, p=p, e=e, converged=conv,
                       max_newton_iters=max_it, sse=sse, err_sum=esum,
                       sample_iters=samp_it)
