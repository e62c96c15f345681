"""Fused likelihood for OFF-GRID observation times.

Measured TRPL data is log-spaced in delay time, so observation times do
not sit on the uniform simulation step grid.  This module scores them
inside the multi-phase solve: the dense-output window of
models/twophase.py (cubic Lagrange in log space over the trailing 4
coarse log-PL nodes; linear/quadratic during the startup ramp) is
evaluated not at the S uniform fine times of a coarse interval but at the
observation times that fall in it, precomputed on the host as padded
per-step slot tables:

    weights: (C, num_exp, K, 4)   Lagrange weights at each obs offset
    values:  (C, num_exp, K)      log10 observed PL
    mask:    (C, num_exp, K)      point weight (0 = padding)

A single ((1, T),) phase gives exact fixed-dt stepping with in-loop cubic
interpolation.  With ``method="fused_horizon_chord"`` (chord Newton) or
``"fused_horizon"`` (full Newton) every phase, the fine one included, is
one launch of the horizon kernel's off-grid mode
(ops/horizon_kernel.solve_phase_offgrid_fused); otherwise a Python step
loop over coupled Newton (:func:`_phase_offgrid`) runs it, with one launch
of the per-step Newton kernel per step for ``coupled_newton_pallas``.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .solver import (HISTORY, BdfStepper, FusedObs, SolveResult, SolverConfig,
                     _log_pl, _scalar, bdf_step, init_history, pl_observable)
from .step_graph import StepRunner
from .trpl import MatParams
from .twophase import Schedule, _validate_schedule, rescale_dt

# Lagrange node sets per ramp row r = min(c, 2) (twophase._lagrange_weight_table).
_ROW_NODES = ([2.0, 3.0], [1.0, 2.0, 3.0], [0.0, 1.0, 2.0, 3.0])


class OffGridTables(NamedTuple):
    """Host-built per-phase slot tables and the t=0 term.

    phases[p] = (weights (C_p, E, K_p, 4), values (C_p, E, K_p),
                 mask (C_p, E, K_p)); v0/m0: (E,) t=0 observation term;
    n_obs: (E,) count (or weight sum) of real observation points, t=0
    included when m0 > 0.  Numpy from :func:`build_offgrid_tables`; the
    runner moves them to the device.
    """
    phases: Tuple[tuple, ...]
    v0: np.ndarray
    m0: np.ndarray
    n_obs: np.ndarray


def _lagrange_at(x: float, r: int) -> np.ndarray:
    """(4,) weights over window cols 0..3 evaluating at window position x
    using the row-r node set (cols 4-len(nodes)..3)."""
    nodes = _ROW_NODES[r]
    cols = list(range(4 - len(nodes), 4))
    out = np.zeros(4)
    for a, xa in enumerate(nodes):
        w = 1.0
        for b, xb in enumerate(nodes):
            if a != b:
                w *= (x - xb) / (xa - xb)
        out[cols[a]] = w
    return out


def build_offgrid_tables(times: Sequence[np.ndarray],
                         values: Sequence[np.ndarray],
                         schedule: Schedule, dt: float,
                         rtol: float = 1e-9,
                         weights: Sequence[np.ndarray] | None = None
                         ) -> OffGridTables:
    """Map each experiment's (time, log-PL) points onto phase/step/offset
    slot tables for :func:`solve_offgrid`.

    Args:
      times/values: per-experiment arrays; times in the same units as dt,
        each >= 0 and <= sum-of-schedule * dt (validated).
      schedule: ((stride, num_fine_steps), ...) fine-first phase plan.
      dt: fine step size.
      weights: optional per-experiment per-point weights (1/sigma^2 for
        the sigma-weighted SSE, sim_flags.use_uncertainty); the mask slot
        then carries the weight instead of 1.0 and ``n_obs`` is the
        weight sum.  The sums are weight-linear (FusedObs.mask), so 0/1
        weights give the unweighted sums bit for bit.
    """
    E = len(times)
    T = sum(n for _, n in schedule)
    v0 = np.zeros(E)
    m0 = np.zeros(E)
    seen0 = np.zeros(E, dtype=bool)
    n_obs = np.zeros(E)
    # buckets[p][c] = list of (e, frac, value, weight)
    buckets = [[[] for _ in range(n // s)] for s, n in schedule]
    bounds = np.cumsum([0] + [n for _, n in schedule])
    for e in range(E):
        t = np.asarray(times[e], dtype=float)
        v = np.asarray(values[e], dtype=float)
        w = (np.ones_like(v) if weights is None
             else np.asarray(weights[e], dtype=float))
        if t.ndim != 1 or t.shape != v.shape or w.shape != v.shape:
            raise ValueError("times/values/weights must be matching 1-D arrays")
        f = t / dt
        if np.any(f < -rtol * T) or np.any(f > T * (1 + rtol)):
            raise ValueError(
                f"observation time outside simulated horizon "
                f"[0, {T * dt}] (experiment {e})")
        f = np.clip(f, 0.0, T)
        n_obs[e] = w.sum()
        for fj, vj, wj in zip(f, v, w):
            if fj <= rtol * max(T, 1):
                if seen0[e]:
                    # The CSV format splits curves at t == 0, so at most one
                    # t=0 point exists per curve.
                    raise ValueError(f"duplicate t=0 observation (exp {e})")
                v0[e] = vj
                m0[e] = wj
                seen0[e] = True
                continue
            p = int(np.searchsorted(bounds[1:], fj, side="left"))
            S = schedule[p][0]
            local = fj - bounds[p]
            c = int(np.ceil(local / S - rtol)) - 1
            c = min(max(c, 0), len(buckets[p]) - 1)
            frac = local / S - c
            buckets[p][c].append((e, frac, vj, wj))

    phases = []
    for p, (S, n) in enumerate(schedule):
        C = n // S
        K = max(1, max((sum(1 for (e, *_rest) in bk if e == ei)
                        for bk in buckets[p] for ei in range(E)), default=1))
        W = np.zeros((C, E, K, 4))
        V = np.zeros((C, E, K))
        M = np.zeros((C, E, K))
        fill = np.zeros((C, E), dtype=int)
        for c, bk in enumerate(buckets[p]):
            r = min(c, 2)
            for (e, frac, vj, wj) in bk:
                k = fill[c, e]
                W[c, e, k] = _lagrange_at(2.0 + frac, r)
                V[c, e, k] = vj
                M[c, e, k] = wj
                fill[c, e] = k + 1
        phases.append((W, V, M))
    return OffGridTables(phases=tuple(phases), v0=v0, m0=m0, n_obs=n_obs)


def _phase_offgrid(mat_nd, n0, p0, e0, cfg: SolverConfig, obs_meta: FusedObs,
                   tbl, pl0, acc, S: int, live):
    """One phase at stride S, scoring the slot-table observation points
    with coupled Newton, step by step.

    ``obs_meta`` carries only the scalars (log_scale, min_val, normalize);
    ``tbl`` = (W, V, M) tensors of this phase; ``acc`` = (converged,
    max_iters, sample_iters, sse, err_sum) carried across phases; ``live``
    (C,) bool marks the steps at or before the run's last observation.  A
    Newton failure after it carries no likelihood weight and is forgiven;
    one on an interior unobserved step corrupts the trajectory that later
    points are scored from, so it fails the sample.
    Returns (n, p, e, acc).
    """
    W_all, V_all, M_all = tbl
    C = W_all.shape[0]
    mp = MatParams.from_array(rescale_dt(mat_nd, S) if S != 1 else mat_nd)
    # The log offset in the compute dtype (see twophase._coarse_phase).
    obs_c = FusedObs(values=obs_meta.values,
                     log_scale=(_scalar(obs_meta.log_scale, n0)
                                - _scalar(np.log10(S), n0)),
                     min_val=obs_meta.min_val, normalize=obs_meta.normalize)
    pl0_c = pl0 * S
    tol = _scalar(cfg.tol, n0)
    step_tol = _scalar(0.0 if cfg.step_tol is None else cfg.step_tol, n0)

    nh, ph, eh = init_history(n0, p0, e0)
    lp_win = torch.zeros((4,) + pl0.shape, dtype=n0.dtype, device=n0.device)
    lp_win[3] = _log_pl(pl_observable(n0, p0, mp), obs_c, pl0_c)

    conv, max_it, samp_it, sse, esum = (x.clone() for x in acc)
    col = torch.zeros(1, dtype=torch.long, device=n0.device)   # the step

    def update(Nn, Pn, En, iters, ok):
        lp_new = _log_pl(pl_observable(Nn, Pn, mp), obs_c, pl0_c)
        lp_win.copy_(torch.cat([lp_win[1:], lp_new[None]], 0))
        # Broadcast multiply-sum over the window (the JAX package's
        # summation, not a matmul).
        W = W_all.index_select(0, col)[0]
        lp_at = (W[:, :, :, None] * lp_win[None, None]).sum(2)    # (E, K, batch)
        err = lp_at - V_all.index_select(0, col)[0][:, :, None]
        m = M_all.index_select(0, col)[0][:, :, None]
        sse.add_((m * err * err).sum(1))
        esum.add_((m * err).sum(1))
        conv.logical_and_(ok | ~live.index_select(0, col))
        torch.maximum(max_it, iters.max(), out=max_it)
        samp_it.add_(iters)
        col.add_(1)

    stepper = BdfStepper(nh, ph, eh, mp, cfg, tol, step_tol, StepRunner(n0.device),
                         eager_step=bdf_step)
    for c in range(C):
        stepper.step(c, update)
    k_final = C % HISTORY
    return nh[k_final], ph[k_final], eh[k_final], (conv, max_it, samp_it, sse, esum)


def liveness(tables: OffGridTables, schedule: Schedule):
    """Per-phase (C_p,) bool rows: a step is live while any real
    observation (of any experiment) remains at or after it."""
    has_obs = torch.cat([(torch.as_tensor(M) != 0).flatten(1).any(1)
                         for (_, _, M) in tables.phases])
    live = has_obs.flip(0).to(torch.int32).cumsum(0).flip(0) > 0
    out, off = [], 0
    for S, n in schedule:
        out.append(live[off:off + n // S])
        off += n // S
    return out


def solve_offgrid(mat_nd, n_init, p_init, e_init, cfg: SolverConfig,
                  tables: OffGridTables, schedule: Schedule,
                  log_scale, min_val: float, normalize: bool = False,
                  kernel=None) -> SolveResult:
    """Fused-likelihood solve with off-grid observation times.

    cfg.num_steps must equal the schedule's fine-step total.  The phase
    tables are tensors on the state's device (numpy is moved there).
    ``kernel`` replaces the horizon kernel's entry
    (ops.horizon_kernel.horizon_chord); tests pass its plain version.
    """
    if cfg.pl_stride != 1:
        raise ValueError("off-grid solver requires pl_stride == 1")
    schedule = tuple((int(s), int(n)) for s, n in schedule)
    _validate_schedule(schedule, cfg.num_steps)
    if len(tables.phases) != len(schedule):
        raise ValueError("tables/schedule phase count mismatch")
    dt, dev = n_init.dtype, n_init.device
    batch = n_init.shape[0]
    E = len(tables.v0)

    def t(a):
        return torch.as_tensor(a, dtype=dt, device=dev)

    obs_meta = FusedObs(values=torch.zeros((E, 1), dtype=dt, device=dev),
                        log_scale=log_scale, min_val=float(min_val),
                        normalize=normalize)
    n, p, e = n_init, p_init, e_init
    pl0 = pl_observable(n, p, MatParams.from_array(mat_nd))

    # t=0 term.
    e0 = _log_pl(pl0, obs_meta, pl0)[None, :] - t(tables.v0)[:, None]
    m0 = t(tables.m0)[:, None]
    acc = (torch.ones(batch, dtype=torch.bool, device=dev),
           torch.zeros((), dtype=torch.int32, device=dev),
           torch.zeros(batch, dtype=torch.int32, device=dev),
           m0 * e0 ** 2, m0 * e0)
    lives = [lv.to(dev) for lv in liveness(tables, schedule)]

    # The fused methods run every phase (the fine one too: off-grid
    # scoring needs the window even at stride 1) as one kernel launch; a
    # multi-phase chord run is the fast-path ladder and takes the strict
    # chord profile, as twophase.solve_multiphase does.
    fused = cfg.method in ("fused_horizon", "fused_horizon_chord")
    if (cfg.method == "fused_horizon_chord" and len(schedule) > 1
            and not cfg.chord_strict):
        cfg = cfg._replace(chord_strict=True)
    for (S, _), tbl, live in zip(schedule, tables.phases, lives):
        tbl = tuple(t(a) for a in tbl)
        if fused:
            from ..ops.horizon_kernel import solve_phase_offgrid_fused
            r = solve_phase_offgrid_fused(mat_nd, n, p, e, cfg, obs_meta, tbl,
                                          pl0, S, live, kernel=kernel)
            n, p, e = r.n, r.p, r.e
            conv, max_it, samp_it, sse, esum = acc
            acc = (conv & r.converged,
                   torch.maximum(max_it, r.max_newton_iters),
                   samp_it + r.sample_iters, sse + r.sse, esum + r.err_sum)
        else:
            n, p, e, acc = _phase_offgrid(mat_nd, n, p, e, cfg, obs_meta,
                                          tbl, pl0, acc, S, live)
    conv, max_it, samp_it, sse, esum = acc
    return SolveResult(pl=None, n=n, p=p, e=e, converged=conv,
                       max_newton_iters=max_it, sse=sse, err_sum=esum,
                       sample_iters=samp_it)
