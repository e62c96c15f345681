"""The fused-horizon kernel: a whole fixed-dt BDF phase in one launch.

Replaces ``horizon_kernel._kernel`` of the JAX package
(bayesian_inference_trpl_tpu/ops/pallas/horizon_kernel.py:447-746, launched
by ``_call`` at :761-902) in its three modes, each with either Newton body
(``HorizonParams.chord``): chord Newton (``_newton_solve_chord``, method
``fused_horizon_chord``) or full Newton (``_newton_solve``, method
``fused_horizon``):

* stride 1 (``solve_horizon_fused``): the fine phase;
* stride S (``solve_coarse_phase_fused``): one coarse rung of the ladder,
  adding cubic log-space dense output at the S fine observation points of
  each coarse step;
* off-grid, ``offgrid_k = K`` (``solve_phase_offgrid_fused``): one phase
  of the off-grid path, scoring K observation slots per step from
  per-slot Lagrange weights over the same 4-node log-PL window, with a
  liveness row in place of the pad-only rule.

Full Newton at stride 1 also records the PL trace every ``pl_stride``
steps (``solve_horizon_record``): the JAX package's ``solve(record_pl=True)``,
which runs both fused methods as its coupled_newton XLA scan
(models/solver.py:304-317 there), over the whole horizon of the
interpolation fallback; with it, on request, the state N/P/E at every
recorded point whose step is a multiple of ``state_stride`` and the largest
Newton iteration count of each recorded point's steps (that scan's
``record_state_stride`` and ``record_iters``, the forward model's
standalone mode, models/driver.pvsim).

Per step, for every sample: rolling 6-slot N/P/E histories with the BDF1->5
ramp, the extrapolated predictor with positivity fallback, Newton (chord:
a cheap residual check, then either a skip, chord iterations on a cached
PCR factorization, or a full Jacobian refresh; full: the check, then a
Jacobian and a PCR solve on every iteration), the E update, and the fused
likelihood.

Four pieces live here:

* :func:`horizon_chord` -- the wrapper.  On a CUDA tensor it launches the
  hand-written kernel (csrc/horizon_kernel.cu, built by ops/kernel_lib.py
  into a plain-C shared library and called through ctypes) or raises; on a
  CPU tensor it runs the plain version.  :func:`launch_layout` reports how
  a launch sits on the card.
* :func:`horizon_chord_plain` -- the plain PyTorch version of the same
  function: a Python step loop over models/newton.py and
  ops/block_tridiag.py (on the card, CUDA graph replays of its steps and
  iterations, models/step_graph.py).  Its ``group`` argument sets how many samples share
  the three decisions of chord Newton (skip the step, leave the iteration
  loop, refresh the Jacobian).  The CUDA kernel runs one sample per warp
  and takes them per sample, so it is held to ``group=1``; the JAX kernel takes them
  over its whole sample tile, so it is held to ``group`` = the tile.  Full
  Newton's tile-wide decisions change no sample's result, so it has no
  group: its steps are models/solver.bdf_step with coupled Newton, the
  step of the step loops (solve, twophase._coarse_phase,
  offgrid._phase_offgrid), and the Newton trajectory equals theirs bit for
  bit.
* :func:`from_jax_inputs` and :func:`offgrid_tables_from_jax` -- turn the
  JAX package's inputs (as numpy) into this port's tensors and configs, so
  that tests feed both the same thing.
"""
from __future__ import annotations

import ctypes
import math
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.newton import residuals_and_errors, residuals_and_jacobian
from ..models.solver import (BdfStepper, FusedObs, SolveResult, SolverConfig,
                             _log_pl, _scalar, init_history, log_floor,
                             pl_observable)
from ..models.step_graph import StepRunner, step_class
from ..models.trpl import (BDF_TABLE, HISTORY, MatParams, SKIP_ACCEPT_FACTOR,
                           STEP_TOL_RESIDUAL_GUARD, onehot_rows, update_e)
from . import kernel_lib
from .kernel_lib import check_tensor as _check
from .block_tridiag import block_pcr_apply, block_pcr_reduce

# Chord refresh policy, read from the same environment variables and with
# the same defaults as the JAX package (horizon_kernel.py:45-92).  Every
# knob is a runtime argument of the kernel.
CHORD_BUDGET = int(os.environ.get("TRPL_CHORD_BUDGET", "3"))
CHORD_STALL = float(os.environ.get("TRPL_CHORD_STALL", "0.7"))
CHORD_STALL_STRICT = float(os.environ.get("TRPL_CHORD_STALL_STRICT", "0.5"))
CHORD_SKIP_TIGHTEN = float(os.environ.get("TRPL_CHORD_SKIP_TIGHTEN", "1.0"))
CHORD_SETTLE_GUARD = float(os.environ.get("TRPL_CHORD_SETTLE_GUARD", "10.0"))
STRICT_SETTLE_GUARD = 0.0
STRICT_SKIP_TIGHTEN = 0.1

PRED_ORDER = {"previous": 0, "linear": 1, "quadratic": 2, "geometric": 3}
_PREDICTOR = {v: k for k, v in PRED_ORDER.items()}

# Launches of the CUDA kernel per mode and Newton body, counted by
# horizon_chord where it launches; chip_smoke.py zeroes them around each
# main path.
launches = {"stride_1": 0, "stride_s": 0, "offgrid": 0,
            "stride_1_full": 0, "stride_s_full": 0, "offgrid_full": 0,
            "stride_1_record": 0, "stride_1_record_states": 0}


def _chord_knobs(cfg: SolverConfig):
    """(settle_guard, skip_tighten, stall) for a SolverConfig's profile."""
    if cfg.chord_strict:
        return STRICT_SETTLE_GUARD, STRICT_SKIP_TIGHTEN, CHORD_STALL_STRICT
    return CHORD_SETTLE_GUARD, CHORD_SKIP_TIGHTEN, CHORD_STALL


class HorizonParams(NamedTuple):
    """Scalar arguments of one horizon launch."""
    stride: int               # 1: fine or off-grid phase; S > 1: coarse rung
    tol: float
    step_tol: float
    log_scale: float          # ignored when normalize
    min_val: float
    max_iters: int
    normalize: bool
    pred_order: int           # PRED_ORDER
    settle_guard: float
    skip_tighten: float
    stall: float
    chord_budget: int = CHORD_BUDGET
    skip_accept_factor: float = SKIP_ACCEPT_FACTOR
    step_tol_guard: float = STEP_TOL_RESIDUAL_GUARD
    approx_inv: bool = False  # fast reciprocal + one Newton refinement
    offgrid_k: int = 0        # K > 0: off-grid mode with K slots per step
    chord: bool = True        # chord Newton; False: full Newton (the chord
    #                           knobs above are then unused)
    pl_stride: int = 0        # P > 0: record the PL trace every P steps (full
    #                           Newton at stride 1 only)
    state_stride: int = 0     # R > 0: with the PL trace, also record N/P/E
    #                           every lcm(P, R) steps
    record_iters: bool = False  # with the PL trace, also record each point's
    #                           largest per-step iteration count


class HorizonOut(NamedTuple):
    sse: torch.Tensor         # (num_exp, batch)
    esum: torch.Tensor        # (num_exp, batch)
    conv: torch.Tensor        # (batch,) bool
    its: torch.Tensor         # (batch,) int32 Newton updates
    maxit: torch.Tensor       # (batch,) int32 worst per-step updates
    n: torch.Tensor           # (batch, L) final state
    p: torch.Tensor
    e: torch.Tensor
    fulls: torch.Tensor       # (batch,) int32 Jacobian refreshes of the group
    execs: torch.Tensor       # (batch,) int32 executed iterations of the group
    #                           (full Newton: both equal its)
    pl: Optional[torch.Tensor] = None   # (batch, T // pl_stride + 1)
    #                           nondimensional PL, if recorded
    states: Optional[torch.Tensor] = None  # (T // state_every(prm), 3, batch, L)
    #                           N/P/E after every state_every-th step
    iters: Optional[torch.Tensor] = None   # (batch, T // pl_stride) int32: the
    #                           largest iteration count of each point's steps


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def _select(sel, new, old):
    """Leafwise torch.where over the nested cache tuples; sel is (batch,)."""
    if isinstance(new, tuple):
        return tuple(_select(sel, a, b) for a, b in zip(new, old))
    return torch.where(sel[:, None], new, old)


def _assign(dst, src):
    """Leafwise in-place copy over the nested cache tuples."""
    if isinstance(dst, tuple):
        for a, b in zip(dst, src):
            _assign(a, b)
    else:
        dst.copy_(src)


class _Chord:
    """Chord Newton with a PCR factorization cached across time steps: the
    state of one launch (cache, cache-valid flags, telemetry per group) and
    of its current step, in buffers updated in place, so that
    models/step_graph.py can run the iteration loop (:meth:`iterate`,
    ``limit``, ``variant``, ``all_done``) on any route.  A step is
    :meth:`start`, the loop, :meth:`finish`."""

    def __init__(self, like, group, prm: HorizonParams, tol, mp, step_tol):
        batch = like.shape[0]
        if batch % group:
            raise ValueError(f"batch {batch} not divisible by group {group}")
        device = like.device
        self.group = group
        self.G = batch // group
        self.prm = prm
        self.limit = prm.max_iters
        self.tol, self.mp, self.step_tol = tol, mp, step_tol
        self.skip_tol = tol * prm.skip_accept_factor * prm.skip_tighten
        self.guard_full = tol * prm.step_tol_guard
        self.guard_chord = tol * prm.settle_guard
        # The cache starts as the factorization of the identity; the first
        # refresh replaces it on every row (cache_set), as it did no row's
        # before.
        z, o = torch.zeros_like(like), torch.ones_like(like)
        self.cache = block_pcr_reduce((z,) * 4, (o, z, z, o), (z,) * 4)
        self.cache_set = torch.zeros((), dtype=torch.bool, device=device)
        self.cval = torch.zeros(self.G, dtype=torch.bool, device=device)
        self.fulls = torch.zeros(self.G, dtype=torch.int32, device=device)
        self.execs = torch.zeros(self.G, dtype=torch.int32, device=device)
        self.recip = None
        if prm.approx_inv:
            def recip(x):
                r = 1.0 / x
                return r * (2.0 - x * r)
            self.recip = recip
        # The current step: its inputs, iterate, residuals and flags.
        self.a0 = torch.zeros((), dtype=like.dtype, device=device)
        self.bN, self.bP, self.bE, self.Nk, self.Pk, self.F_N, self.F_P = (
            torch.empty_like(like) for _ in range(7))
        self.err_n, self.err_p = (torch.empty(batch, dtype=like.dtype, device=device)
                                  for _ in range(2))
        self.done = torch.zeros(batch, dtype=torch.bool, device=device)
        self.its = torch.zeros(batch, dtype=torch.int32, device=device)
        self.active = torch.zeros(self.G, dtype=torch.bool, device=device)
        self.ffull = torch.zeros(self.G, dtype=torch.bool, device=device)

    def _rows(self, g):
        return g.repeat_interleave(self.group)

    def _groups(self, x):
        return x.view(self.G, self.group)

    def _residuals(self):
        return residuals_and_errors(self.Nk, self.Pk, self.bN, self.bP, self.bE,
                                    self.mp, self.a0)

    def start(self, a0, bN, bP, bE, Nk, Pk):
        """The step's inputs, then the cheap residual check: a group whose
        samples all pass the tightened skip tolerance skips the step."""
        for buf, x in ((self.a0, a0), (self.bN, bN), (self.bP, bP), (self.bE, bE),
                       (self.Nk, Nk), (self.Pk, Pk)):
            buf.copy_(x)
        (F_N, F_P), (err_n, err_p) = self._residuals()
        for buf, x in ((self.F_N, F_N), (self.F_P, F_P), (self.err_n, err_n),
                       (self.err_p, err_p)):
            buf.copy_(x)
        ok0 = (err_n < self.skip_tol) & (err_p < self.skip_tol)
        active = ~self._groups(ok0).all(1)   # groups that enter the loop
        self.active.copy_(active)
        self.done.copy_(ok0 | ~self._rows(active))   # a skipping group is all done
        self.its.zero_()
        self.ffull.copy_(~self.cval)

    # The refresh is chosen on the host before each iteration
    # (models/step_graph.StepRunner.loop): no iteration is lagged.
    synced = True

    def variant(self, i: int):
        """(whether iteration i spends the chord budget, so that a refresh
        follows; whether some active group asks for a Jacobian refresh
        now), read from the device; None once no group is active."""
        any_active, refresh = torch.stack(
            (self.active.any(), (self.ffull & self.active).any())).tolist()
        if not any_active:
            return None
        return i + 1 >= self.prm.chord_budget, refresh

    def all_done(self) -> torch.Tensor:
        return ~self.active.any()

    def iterate(self, v, masked: bool = False):
        """One iteration for the active groups, ``v`` its :meth:`variant`:
        the Jacobian is refreshed only when some group asks, and taken by
        the rows that asked (``masked`` changes nothing here).  An
        iteration with no group active changes nothing."""
        past_budget, refresh = v
        prm, Nk, Pk, active = self.prm, self.Nk, self.Pk, self.active
        act = self._rows(active)
        self.execs += active.to(torch.int32)
        do_full = self.ffull & active
        if refresh:
            _, (A, B, C) = residuals_and_jacobian(Nk, Pk, self.bN, self.bP, self.bE,
                                                  self.mp, self.a0)
            new = block_pcr_reduce(A, B, C, recip=self.recip)
            any_full = do_full.any()
            _assign(self.cache, _select(self._rows(do_full) | (~self.cache_set & any_full),
                                        new, self.cache))
            self.cache_set.logical_or_(any_full)
            self.cval.logical_or_(do_full)
            self.fulls += do_full.to(torch.int32)
        dN, dP = block_pcr_apply(self.cache, (-self.F_N, -self.F_P))
        done = self.done
        upd = (~done).to(Nk.dtype)[:, None]
        Nn = Nk + upd * (torch.maximum(Nk + dN, 0.05 * Nk) - Nk)
        Pn = Pk + upd * (torch.maximum(Pk + dP, 0.05 * Pk) - Pk)
        Nk.copy_(torch.where(act[:, None], Nn, Nk))
        Pk.copy_(torch.where(act[:, None], Pn, Pk))
        self.its.add_((act & ~done).to(torch.int32))
        # State-settled acceptance: a full step gets the loose guard; a
        # chord step the settle guard (0 in the strict profile).
        guard = torch.where(self._rows(do_full), self.guard_full, self.guard_chord)
        ok_step = ((dN.abs().amax(-1) <= self.step_tol * Nk.abs().amax(-1))
                   & (dP.abs().amax(-1) <= self.step_tol * Pk.abs().amax(-1))
                   & (self.err_n < guard) & (self.err_p < guard))
        (F_N, F_P), (err_n2, err_p2) = self._residuals()
        ok_skip = (err_n2 < self.skip_tol) & (err_p2 < self.skip_tol)
        done = done | (act & (ok_step | ok_skip))
        # Stall: an active sample whose residual failed to contract by
        # `stall` under this step -> full refresh next iteration.
        bad = self._groups(~done & ((err_n2 > prm.stall * self.err_n)
                                    | (err_p2 > prm.stall * self.err_p))).any(1)
        self.ffull.copy_(torch.where(active, bad | past_budget, self.ffull))
        for buf, x in ((self.F_N, F_N), (self.F_P, F_P), (self.err_n, err_n2),
                       (self.err_p, err_p2), (self.done, done)):
            buf.copy_(x)
        self.active.copy_(active & ~self._groups(done).all(1))

    def finish(self):
        """(N, P, E, iters, converged) of the step."""
        done = self.done | ((self.err_n < self.tol) & (self.err_p < self.tol))
        Ek = update_e(self.Nk, self.Pk, self.bE, self.mp, self.a0)
        return self.Nk, self.Pk, Ek, self.its, done


class _ChordSteps:
    """The chord body's BDF steps on the rolling histories, through a
    models/step_graph.StepRunner, with the interface of
    models/solver.BdfStepper (which runs the full body's)."""

    def __init__(self, nh, ph, eh, mp, prm: HorizonParams, tol, step_tol, group,
                 runner):
        self.nh, self.ph, self.eh, self.prm, self.runner = nh, ph, eh, prm, runner
        self.bdf = torch.as_tensor(BDF_TABLE, dtype=nh.dtype, device=nh.device)
        onehot_rows(nh[0])
        self.chord = _Chord(nh[0], group, prm, tol, mp, step_tol)

    def step(self, t: int, update, key=()):
        c, run, chord = step_class(t), self.runner.run, self.chord

        def start():
            chord.start(*_step_inputs(t, self.nh, self.ph, self.eh, self.bdf,
                                      self.prm.pred_order))

        def end():
            Nn, Pn, En, iters, done = chord.finish()
            new = (t + 1) % HISTORY
            self.nh[new], self.ph[new], self.eh[new] = Nn, Pn, En
            update(Nn, Pn, En, iters, done)
        run(("start", c), start)
        self.runner.loop("chord", chord)
        run(("end", c) + tuple(key), end)


def _step_inputs(t, nh, ph, eh, bdf, pred_order):
    """(a0, bN, bP, bE, Nk, Pk) of step t in the chord body's order: the
    BDF history sums newest first, as the JAX kernel sums them, and the
    extrapolated initial iterate with a positivity fallback
    (horizon_kernel.py:568-592 of the JAX package).  The full body sums in
    models/solver.bdf_step's order instead (csrc/horizon_kernel.cu)."""
    row = min(t, 4)
    a0 = bdf[row, 0]
    hist = [(t - m) % HISTORY for m in range(5)]
    bN, bP, bE = (bdf[row, 1] * h[hist[0]] for h in (nh, ph, eh))
    for m in range(1, 5):
        w = bdf[row, m + 1]
        bN = bN + w * nh[hist[m]]
        bP = bP + w * ph[hist[m]]
        bE = bE + w * eh[hist[m]]
    Nk, Pk = nh[hist[0]], ph[hist[0]]
    if pred_order:
        ramp = float(t > 0)
        d1n = Nk - nh[hist[1]]
        d1p = Pk - ph[hist[1]]
        Nx = Nk + ramp * d1n
        Px = Pk + ramp * d1p
        if pred_order == 2:
            ramp2 = float(t > 1)
            Nx = Nx + ramp2 * (d1n - (nh[hist[1]] - nh[hist[2]]))
            Px = Px + ramp2 * (d1p - (ph[hist[1]] - ph[hist[2]]))
        if pred_order == 3:
            Nm, Pm = nh[hist[1]], ph[hist[1]]
            Nx = torch.where(Nm > 0, Nk * (Nk / torch.where(Nm > 0, Nm, 1.0)), Nx)
            Px = torch.where(Pm > 0, Pk * (Pk / torch.where(Pm > 0, Pm, 1.0)), Px)
        Nk = torch.where(Nx > 0, Nx, Nk)
        Pk = torch.where(Px > 0, Px, Pk)
    return a0, bN, bP, bE, Nk, Pk


def horizon_chord_plain(mat, n0, p0, e0, obs, msk, vmask, pl0, wtab,
                        prm: HorizonParams, group: int = 1) -> HorizonOut:
    """Plain PyTorch version of :func:`horizon_chord`.

    Args:
      mat: (batch, 12) nondimensional parameters (already on the phase's dt).
      n0/p0/e0: (batch, L) phase-start state.
      obs: stride 1: (num_exp, T), column j the observation at step j+1;
        stride S: (num_exp, C, S), the S fine points of each coarse step;
        off-grid: (num_exp, C, K) slot values.
      msk: optional per-step weights (num_exp, T | C); for stride S the
        step's weight is the max over its fine points.  Off-grid: the
        (C,) liveness row (only steps after the last observation, 0 here,
        are forgiven a Newton failure).
      vmask: stride S with msk: per-fine-point weights (num_exp, C, S);
        off-grid: per-slot weights (num_exp, C, K).
      pl0: optional (batch,) external normalization anchor.
      wtab: stride S: (3, S, 4) Lagrange table (models/twophase.py);
        off-grid: per-slot Lagrange weights (num_exp, C, 4K), laid out
        [a*K + k] (models/offgrid.build_offgrid_tables).
      group: samples per shared chord decision (see module docstring);
        full Newton (``prm.chord`` False) takes its decisions per sample.

    With ``prm.pl_stride`` P > 0 the PL (the value the likelihood logs)
    is recorded at t = 0 and after every P-th step; with it, on request,
    N/P/E after every ``state_every(prm)``-th step and the largest
    iteration count of each P steps.
    """
    batch, L = n0.shape
    S = prm.stride
    K = prm.offgrid_k
    P = prm.pl_stride
    num_exp, T = obs.shape[0], obs.shape[1]
    _check_record(prm, T)
    mp = MatParams.from_array(mat)
    dev, dtype = n0.device, n0.dtype
    tol = _scalar(prm.tol, n0)
    step_tol = _scalar(prm.step_tol, n0)
    log_scale = _scalar(prm.log_scale, n0)
    mv = log_floor(prm.min_val, dtype)
    nh, ph, eh = init_history(n0, p0, e0)
    runner = StepRunner(dev)
    if prm.chord:
        steps = _ChordSteps(nh, ph, eh, mp, prm, tol, step_tol, group, runner)
    else:
        step_cfg = SolverConfig(num_steps=T, max_iters=prm.max_iters,
                                predictor=_PREDICTOR[prm.pred_order],
                                method="coupled_newton")
        steps = BdfStepper(nh, ph, eh, mp, step_cfg, tol, step_tol, runner)

    n0p0 = mp.n0 * mp.p0
    pl00 = mp.rate * ((n0 * p0).sum(-1) - L * n0p0)
    pl0_s = pl00 if pl0 is None else pl0

    def logpl(x):
        if prm.normalize:
            return torch.log10(torch.clamp_min(x / pl0_s, mv))
        return torch.log10(torch.clamp_min(x, mv)) + log_scale

    # Per-fine-point (stride S) or per-slot (off-grid) sums, reduced at the
    # end as the kernel does.
    acc_shape = (num_exp, batch, K or S) if K or S > 1 else (num_exp, batch)
    sse = torch.zeros(acc_shape, dtype=dtype, device=dev)
    esum = torch.zeros_like(sse)
    conv = torch.ones(batch, dtype=torch.bool, device=dev)
    its = torch.zeros(batch, dtype=torch.int32, device=dev)
    maxit = torch.zeros_like(its)
    if S > 1 or K:
        # The trailing window of log-PL nodes, oldest first.
        lpw = torch.zeros((4, batch), dtype=dtype, device=dev)
        lpw[3] = logpl(pl00)
    # The traces, written as the kernel writes them; the step, the recorded
    # point and the frame as counters on the device.
    pls = None
    if P:
        pls = torch.empty((batch, T // P + 1), dtype=dtype, device=dev)
        pls[:, 0] = pl00
    every = state_every(prm)
    frames = (torch.empty((T // every, 3, batch, L), dtype=dtype, device=dev)
              if every else None)
    rec_its = (torch.empty((batch, T // P), dtype=torch.int32, device=dev)
               if prm.record_iters else None)
    rec_it = torch.zeros_like(its)    # the largest count since the last point
    tcol, rcol, fcol = (torch.zeros(1, dtype=torch.long, device=dev) for _ in range(3))

    def update(t, record, frame, Nn, Pn, En, iters, done):
        its.add_(iters)
        maxit.copy_(torch.maximum(maxit, iters))
        pl_t = mp.rate * ((Nn * Pn).sum(-1) - L * n0p0)
        if record:
            pls.index_copy_(1, rcol + 1, pl_t[:, None])
        if rec_its is not None:
            rec_it.copy_(torch.maximum(rec_it, iters))
            if record:
                rec_its.index_copy_(1, rcol, rec_it[:, None])
                rec_it.zero_()
        if frame:
            frames.index_copy_(0, fcol, torch.stack((Nn, Pn, En))[None])
            fcol.add_(1)
        lp = logpl(pl_t)
        w_any = None
        obs_t = obs.index_select(1, tcol)
        if K:
            # Off-grid slots: the 4-node window at K offsets per experiment,
            # summed per slot (over K only at the end, as the kernel does).
            lpw.copy_(torch.cat([lpw[1:], lp[None]]))
            wtab_t = wtab.index_select(1, tcol)
            vmask_t = vmask.index_select(1, tcol)
            for e in range(num_exp):
                wk = wtab_t[e, 0]                                  # (4K,)
                lp_at = (lpw[0][:, None] * wk[None, 0:K]
                         + lpw[1][:, None] * wk[None, K:2 * K]
                         + lpw[2][:, None] * wk[None, 2 * K:3 * K]
                         + lpw[3][:, None] * wk[None, 3 * K:4 * K])  # (batch, K)
                err = lp_at - obs_t[e]
                wg = vmask_t[e]
                sse[e] = sse[e] + wg * err * err
                esum[e] = esum[e] + wg * err
            # Liveness: only steps past the last observation are forgiven.
            done = done | ~(msk.index_select(0, tcol) > 0)
        elif S == 1:
            msk_t = None if msk is None else msk.index_select(1, tcol)
            for e in range(num_exp):
                err = lp - obs_t[e]
                if msk is not None:
                    m = msk_t[e]
                    w_any = m if w_any is None else torch.maximum(w_any, m)
                    sse[e] = sse[e] + m * err * err
                    esum[e] = esum[e] + m * err
                else:
                    sse[e] = sse[e] + err * err
                    esum[e] = esum[e] + err
        else:
            lpw.copy_(torch.cat([lpw[1:], lp[None]]))
            Wr = wtab[min(t, 2)]                                   # (S, 4)
            lp_fine = (lpw[0][:, None] * Wr[None, :, 0]
                       + lpw[1][:, None] * Wr[None, :, 1]
                       + lpw[2][:, None] * Wr[None, :, 2]
                       + lpw[3][:, None] * Wr[None, :, 3])          # (batch, S)
            if msk is not None:
                msk_t, vmask_t = msk.index_select(1, tcol), vmask.index_select(1, tcol)
            for e in range(num_exp):
                err = lp_fine - obs_t[e]
                if msk is not None:
                    vm = vmask_t[e]
                    m = msk_t[e]
                    w_any = m if w_any is None else torch.maximum(w_any, m)
                    sse[e] = sse[e] + vm * err * err
                    esum[e] = esum[e] + vm * err
                else:
                    sse[e] = sse[e] + err * err
                    esum[e] = esum[e] + err
        if w_any is not None:
            # Padding-only steps (zero weight in every experiment) cannot
            # fail a sample.
            done = done | ~(w_any > 0)
        conv.logical_and_(done)
        if record:
            rcol.add_(1)
        tcol.add_(1)

    for t in range(T):
        record = bool(P) and (t + 1) % P == 0
        frame = bool(every) and (t + 1) % every == 0
        steps.step(t, lambda *out, t=t, r=record, f=frame: update(t, r, f, *out),
                   (record, frame))

    if sse.dim() == 3:
        sse, esum = sse.sum(-1), esum.sum(-1)
    k = T % HISTORY
    if prm.chord:
        chord = steps.chord
        fulls, execs = chord._rows(chord.fulls), chord._rows(chord.execs)
    else:
        fulls, execs = its, its
    return HorizonOut(sse, esum, conv, its, maxit, nh[k], ph[k], eh[k], fulls, execs,
                      pls, frames, rec_its)


def state_every(prm: HorizonParams) -> int:
    """Steps between two frames of the state trace (0: none): the recorded
    points (every pl_stride steps) whose step is a multiple of state_stride,
    as the JAX scan's ``(j + 1) * pl_stride % record_state_stride == 0``."""
    return math.lcm(prm.pl_stride, prm.state_stride) if prm.state_stride else 0


def _check_record(prm: HorizonParams, T: int):
    """Raise unless the traces asked for are ones the kernel records: the
    PL trace by full Newton at stride 1, every pl_stride steps of T, and
    the state and iteration traces only beside it."""
    if prm.pl_stride and (prm.chord or prm.stride != 1 or prm.offgrid_k
                          or prm.pl_stride < 0 or T % prm.pl_stride):
        raise ValueError(f"horizon_chord: the PL trace is recorded by full Newton "
                         f"at stride 1 every pl_stride steps of T; got chord "
                         f"{prm.chord}, stride {prm.stride}, K {prm.offgrid_k}, "
                         f"pl_stride {prm.pl_stride}, T {T}")
    if (prm.state_stride or prm.record_iters) and (prm.pl_stride <= 0
                                                   or prm.state_stride < 0):
        raise ValueError(f"horizon_chord: the state and iteration traces are recorded "
                         f"with the PL trace; got pl_stride {prm.pl_stride}, "
                         f"state_stride {prm.state_stride}, record_iters "
                         f"{prm.record_iters}")


# ---------------------------------------------------------------------------
# CUDA kernel: launch (ops/kernel_lib.py builds and loads the library)
# ---------------------------------------------------------------------------

_VP, _CI, _CD = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_ARGTYPES = [_VP] * 23 + [_CI] * 15 + [_CD] * 9 + [_VP]


def _ptr(x: Optional[torch.Tensor]) -> Optional[int]:
    return None if x is None else x.data_ptr()



def horizon_chord(mat, n0, p0, e0, obs, msk, vmask, pl0, wtab,
                  prm: HorizonParams) -> HorizonOut:
    """One fixed-dt phase of chord or full Newton (``prm.chord``) with the
    fused likelihood.

    Arguments as :func:`horizon_chord_plain`.  On CUDA tensors this launches
    the hand-written kernel (one warp per sample, so the Newton decisions
    are per sample); on CPU tensors it runs the plain version
    with ``group=1``, the same function.
    """
    if n0.device.type == "cpu":
        return horizon_chord_plain(mat, n0, p0, e0, obs, msk, vmask, pl0, wtab,
                                   prm, group=1)
    if n0.device.type != "cuda":
        raise ValueError(f"horizon_chord: unsupported device {n0.device}")
    dtype, dev = n0.dtype, n0.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"horizon_chord: unsupported dtype {dtype}")
    batch, L = n0.shape
    if L & (L - 1) or not 32 <= L <= 1024:
        raise ValueError(f"horizon_chord: L must be a power of two in "
                         f"[32, 1024], got {L}")
    S, K = prm.stride, prm.offgrid_k
    num_exp, T = obs.shape[0], obs.shape[1]
    _check_record(prm, T)
    _check("mat", mat, dtype, (batch, 12), dev)
    for name, x in (("n0", n0), ("p0", p0), ("e0", e0)):
        _check(name, x, dtype, (batch, L), dev)
    if K:
        if S != 1:
            raise ValueError(f"horizon_chord: off-grid mode takes stride 1, got {S}")
        _check("obs", obs, dtype, (num_exp, T, K), dev)
        _check("msk", msk, dtype, (T,), dev)
        _check("vmask", vmask, dtype, (num_exp, T, K), dev)
        _check("wtab", wtab, dtype, (num_exp, T, 4 * K), dev)
    else:
        _check("obs", obs, dtype, (num_exp, T) if S == 1 else (num_exp, T, S), dev)
        if msk is not None:
            _check("msk", msk, dtype, (num_exp, T), dev)
    if S > 1:
        _check("wtab", wtab, dtype, (3, S, 4), dev)
        if msk is not None:
            _check("vmask", vmask, dtype, (num_exp, T, S), dev)
    if pl0 is not None:
        _check("pl0", pl0, dtype, (batch,), dev)
    bdf = torch.as_tensor(BDF_TABLE, dtype=dtype, device=dev)

    sse = torch.empty((num_exp, batch), dtype=dtype, device=dev)
    esum = torch.empty_like(sse)
    ints = [torch.empty(batch, dtype=torch.int32, device=dev) for _ in range(5)]
    conv, its, maxit, fulls, execs = ints
    n, p, e = (torch.empty_like(n0) for _ in range(3))
    # Each trace is allocated once per launch; one that does not fit on the
    # card raises (torch.OutOfMemoryError) and the batch is not cut here.
    pl = (torch.empty((batch, T // prm.pl_stride + 1), dtype=dtype, device=dev)
          if prm.pl_stride else None)
    every = state_every(prm)
    st = (torch.empty((T // every, 3, batch, L), dtype=dtype, device=dev)
          if every else None)
    it = (torch.empty((batch, T // prm.pl_stride), dtype=torch.int32, device=dev)
          if prm.record_iters else None)
    mode, sym = (("offgrid", "offgrid") if K else ("stride_1", "stride1") if S == 1
                 else ("stride_s", "strides"))
    fn = kernel_lib.function("trpl_horizon_{}_{}_{}".format(
        "chord" if prm.chord else "full", sym,
        "f32" if dtype == torch.float32 else "f64"), _ARGTYPES)
    # The C entry sets the kernel's attributes and launches on the current
    # CUDA device, not on the inputs' device: with more than one card, a
    # launch for cuda:1 made while cuda:0 is current would fail or land on
    # the wrong card.
    with torch.cuda.device(dev):
        rc = fn(_ptr(mat), _ptr(n0), _ptr(p0), _ptr(e0), _ptr(obs), _ptr(msk),
                _ptr(vmask), _ptr(pl0), _ptr(wtab), _ptr(bdf),
                _ptr(sse), _ptr(esum), _ptr(conv), _ptr(its), _ptr(maxit),
                _ptr(n), _ptr(p), _ptr(e), _ptr(fulls), _ptr(execs), _ptr(pl),
                _ptr(st) if st is not None and st.numel() else None,
                _ptr(it) if it is not None and it.numel() else None,
                batch, L, T, S, K, num_exp, int(msk is not None and not K),
                int(prm.normalize), int(pl0 is not None), int(prm.pred_order),
                int(prm.max_iters), int(prm.chord_budget), int(prm.approx_inv),
                int(prm.pl_stride), every, float(prm.tol), float(prm.step_tol),
                float(prm.log_scale), float(prm.min_val), float(prm.settle_guard),
                float(prm.skip_accept_factor), float(prm.skip_tighten),
                float(prm.stall), float(prm.step_tol_guard),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(_launch_error(rc, dtype, L, num_exp, K or S))
    launches[mode if prm.chord else
             "stride_1_record_states" if st is not None or it is not None else
             "stride_1_record" if pl is not None else mode + "_full"] += 1
    return HorizonOut(sse, esum, conv.bool(), its, maxit, n, p, e, fulls, execs, pl,
                      st, it)


def shared_memory(L: int, num_exp: int, slots: int, dtype=torch.float32) -> dict:
    """Shared memory a launch asks for on the current card: bytes per
    sample (chord cache, E history and 2 x num_exp x slots accumulators),
    samples per block, bytes per block, and the opt-in bytes a block may
    take.  ``slots``: 1 at stride 1, S at stride S, K off-grid."""
    fn = kernel_lib.function("trpl_horizon_smem_{}".format(
        "f32" if dtype == torch.float32 else "f64"), [_CI] * 3 + [_VP])
    out = (ctypes.c_longlong * 4)()
    kernel_lib.check(fn(L, num_exp, slots, ctypes.addressof(out)), "horizon smem")
    return dict(zip(("sample_bytes", "samples_per_block", "block_bytes",
                     "optin_bytes"), out))


def _launch_error(rc: int, dtype, L: int, num_exp: int, slots: int) -> str:
    """The message of a failed launch, with the shared memory it asked for
    (a sample's accumulators grow with num_exp x slots)."""
    sm = shared_memory(L, num_exp, slots, dtype)
    msg = (f"horizon kernel launch failed: CUDA error {rc} "
           f"({kernel_lib.error_string(rc)}); it asks {sm['block_bytes']} B "
           f"of shared memory per block ({sm['samples_per_block']} samples of "
           f"{sm['sample_bytes']} B at L = {L}, {num_exp} experiments x "
           f"{slots} slots), a block may take {sm['optin_bytes']} B")
    if sm["sample_bytes"] > sm["optin_bytes"]:
        msg += ": one sample does not fit; score fewer experiments per launch"
    return msg


def launch_layout(batch: int, L: int, num_exp: int, stride: int = 1,
                  offgrid_k: int = 0, chord: bool = True,
                  dtype=torch.float32) -> dict:
    """How one launch of the CUDA kernel sits on the current card: samples
    and threads per block, shared memory per block, resident blocks and
    samples per SM, registers and local memory per thread, and waves per
    launch at ``batch`` samples (ops/kernel_lib.layout)."""
    entry = "trpl_horizon_{}_{}_{}".format(
        "chord" if chord else "full",
        "offgrid" if offgrid_k else "stride1" if stride == 1 else "strides",
        "f32" if dtype == torch.float32 else "f64")
    return kernel_lib.layout(entry, batch, L, num_exp, stride, offgrid_k)


# ---------------------------------------------------------------------------
# Phase-level entries (the JAX package's solve_horizon_fused,
# solve_coarse_phase_fused and solve_phase_offgrid_fused)
# ---------------------------------------------------------------------------

def _params(cfg: SolverConfig, obs: FusedObs, stride: int, log_scale: float):
    """The launch's scalars; ``fused_horizon`` takes full Newton, every
    other method chord Newton under cfg's chord profile."""
    chord = cfg.method != "fused_horizon"
    settle_guard, skip_tighten, stall = (_chord_knobs(cfg) if chord
                                         else (0.0, 1.0, 0.0))
    return HorizonParams(
        stride=stride, tol=cfg.tol,
        step_tol=0.0 if cfg.step_tol is None else float(cfg.step_tol),
        log_scale=0.0 if obs.normalize else log_scale,
        min_val=obs.min_val, max_iters=int(cfg.max_iters),
        normalize=bool(obs.normalize), pred_order=PRED_ORDER[cfg.predictor],
        settle_guard=settle_guard, skip_tighten=skip_tighten, stall=stall,
        chord=chord)


def _result(out: HorizonOut, sse, esum) -> SolveResult:
    return SolveResult(
        pl=None, n=out.n, p=out.p, e=out.e, converged=out.conv,
        max_newton_iters=out.maxit.max(), sse=sse, err_sum=esum,
        sample_iters=out.its, full_solves=out.fulls, tile_body_iters=out.execs)


def solve_horizon_fused(mat_nd, n_init, p_init, cfg: SolverConfig,
                        obs: FusedObs, e_init=None, kernel=None) -> SolveResult:
    """Fused full-horizon solve (chord, or full Newton for method
    ``fused_horizon``) + likelihood over cfg.num_steps fine steps;
    obs.values is (num_exp, T+1).  The kernel owns steps 1..T and
    this function adds the t=0 observation term."""
    kernel = horizon_chord if kernel is None else kernel
    T = cfg.num_steps
    values = obs.values
    mask = obs.mask
    obs_sc = values[:, 1:T + 1].contiguous()
    msk = None if mask is None else mask[:, 1:T + 1].contiguous()
    e0 = torch.zeros_like(n_init) if e_init is None else e_init
    prm = _params(cfg, obs, 1, float(_scalar(obs.log_scale, n_init)))
    out = kernel(mat_nd, n_init, p_init, e0, obs_sc, msk, None, None, None, prm)

    mp = MatParams.from_array(mat_nd)
    pl0 = pl_observable(n_init, p_init, mp)
    e0t = _log_pl(pl0, obs, pl0) - values[:, 0:1]
    if mask is not None:
        m0 = mask[:, 0:1]
        return _result(out, out.sse + m0 * e0t ** 2, out.esum + m0 * e0t)
    return _result(out, out.sse + e0t ** 2, out.esum + e0t)


def solve_horizon_record(mat_nd, n_init, p_init, cfg: SolverConfig, e_init=None,
                         kernel=None) -> SolveResult:
    """The whole horizon of cfg.num_steps fine steps in one launch of full
    Newton at stride 1, recording the PL trace every cfg.pl_stride steps
    and scoring no observations: the JAX package's ``solve(record_pl=True)``
    of a fused method, which it runs as coupled_newton.  Full Newton here
    is coupled_newton's step (models/solver.bdf_step) whatever cfg.method
    names; every step's Newton failure fails its sample.

    ``cfg.record_state_stride`` and ``cfg.record_iters`` add the JAX
    layouts: ``states`` a tuple (N, P, E) of (T // pl_stride, batch, L),
    NaN at the points whose step is not a multiple of record_state_stride,
    and ``iters`` the (T // pl_stride,) batch-wide largest iteration count
    of each point's steps."""
    kernel = horizon_chord if kernel is None else kernel
    e0 = torch.zeros_like(n_init) if e_init is None else e_init
    prm = HorizonParams(
        stride=1, tol=cfg.tol,
        step_tol=0.0 if cfg.step_tol is None else float(cfg.step_tol),
        log_scale=0.0, min_val=0.0, max_iters=int(cfg.max_iters), normalize=False,
        pred_order=PRED_ORDER[cfg.predictor], settle_guard=0.0, skip_tighten=1.0,
        stall=0.0, chord=False, pl_stride=int(cfg.pl_stride),
        state_stride=int(cfg.record_state_stride or 0),
        record_iters=bool(cfg.record_iters))
    no_obs = n_init.new_empty((0, cfg.num_steps))
    out = kernel(mat_nd, n_init, p_init, e0, no_obs, None, None, None, None, prm)
    return _result(out, None, None)._replace(
        pl=out.pl,
        states=None if out.states is None else _expand_states(
            out.states, cfg.num_steps // prm.pl_stride, state_every(prm) // prm.pl_stride),
        iters=None if out.iters is None else out.iters.amax(0))


def _expand_states(frames, n_outer: int, step: int):
    """The state trace's frames (F, 3, batch, L), one every ``step``
    recorded points, as the JAX package's (N, P, E) of (n_outer, batch, L)
    with NaN at the other points; views of the frames when every point
    has one."""
    if step == 1:
        return tuple(frames.unbind(1))
    full = frames.new_full((3, n_outer) + tuple(frames.shape[2:]), float("nan"))
    full[:, step - 1::step] = frames.transpose(0, 1)
    return tuple(full.unbind(0))


def solve_coarse_phase_fused(mat_nd, n_init, p_init, e_init, cfg: SolverConfig,
                             obs: FusedObs, pl0, t_off: int, n_fine: int,
                             S: int, kernel=None) -> SolveResult:
    """One coarse rung of the stride ladder in a single launch: BDF restarted
    at step S*dt from the phase-start state, likelihood over the fine
    observation points (t_off, t_off + n_fine] by cubic dense output.

    ``mat_nd`` is on the FINE dt (rescaled here); ``pl0`` is the run-t=0
    fine-dt PL (normalization anchor).  Returns this phase's terms only."""
    from ..models.twophase import _lagrange_weight_table, rescale_dt

    kernel = horizon_chord if kernel is None else kernel
    if n_fine % S:
        raise ValueError(f"phase length {n_fine} not divisible by S={S}")
    C = n_fine // S
    num_exp = obs.values.shape[0]
    sl = slice(t_off + 1, t_off + n_fine + 1)
    obs_sc = obs.values[:, sl].reshape(num_exp, C, S).contiguous()
    vmask = msk = None
    if obs.mask is not None:
        vmask = obs.mask[:, sl].reshape(num_exp, C, S).contiguous()
        msk = vmask.amax(-1).contiguous()
    # Nondimensional PL scales with dt: the log offset and the anchor shift
    # to coarse units, in the compute dtype.
    log_scale = float(_scalar(obs.log_scale, n_init) - _scalar(np.log10(S), n_init))
    pl0_in = (pl0 * S).contiguous() if obs.normalize else None
    wtab = torch.as_tensor(_lagrange_weight_table(S), dtype=n_init.dtype,
                           device=n_init.device)
    out = kernel(rescale_dt(mat_nd, S).contiguous(), n_init, p_init, e_init,
                 obs_sc, msk, vmask, pl0_in, wtab, _params(cfg, obs, S, log_scale))
    return _result(out, out.sse, out.esum)


def solve_phase_offgrid_fused(mat_nd, n_init, p_init, e_init, cfg: SolverConfig,
                              obs_meta: FusedObs, tbl, pl0, S: int, live,
                              kernel=None) -> SolveResult:
    """One off-grid phase in a single launch; the counterpart of
    models/offgrid._phase_offgrid (same dt rescaling, BDF order-ramp
    restart, per-slot Lagrange dense output, weight-linear sums and
    liveness-gated convergence).

    Args:
      mat_nd: (batch, 12) FINE-dt parameters (rescaled here to S dt).
      obs_meta: FusedObs carrying only the scalars (log_scale, min_val,
        normalize); the values live in the slot tables.
      tbl: (W (C, E, K, 4), V (C, E, K), M (C, E, K)) tensors of this phase
        (models/offgrid.build_offgrid_tables; M holds the point weights).
      pl0: (batch,) run-t=0 fine-dt PL (the normalization anchor).
      S: this phase's stride (1 for the fine phase).
      live: (C,) liveness flags; steps after the last observation of the
        run are forgiven a Newton failure.

    Returns this phase's terms only; the kernel runs at stride 1 on the
    rescaled parameters.
    """
    from ..models.twophase import rescale_dt

    kernel = horizon_chord if kernel is None else kernel
    W_all, V_all, M_all = tbl
    C, num_exp, K = V_all.shape
    # Kernel layout: values and weights (E, C, K); Lagrange weights
    # (E, C, 4K) with the [a*K + k] layout.
    V = V_all.permute(1, 0, 2).contiguous()
    Mw = M_all.permute(1, 0, 2).contiguous()
    Wt = W_all.permute(1, 0, 3, 2).reshape(num_exp, C, 4 * K).contiguous()
    live_row = torch.as_tensor(live, device=n_init.device).to(n_init.dtype).contiguous()
    mat_c = rescale_dt(mat_nd, S) if S != 1 else mat_nd
    # Nondimensional PL scales with dt: the log offset and the anchor shift
    # to this phase's units, in the compute dtype.
    log_scale = 0.0 if obs_meta.normalize else float(
        _scalar(obs_meta.log_scale, n_init) - _scalar(np.log10(S), n_init))
    pl0_in = (pl0 * S).contiguous() if obs_meta.normalize else None
    prm = _params(cfg, obs_meta, 1, log_scale)._replace(offgrid_k=int(K))
    out = kernel(mat_c.contiguous(), n_init, p_init, e_init, V, live_row, Mw,
                 pl0_in, Wt, prm)
    return _result(out, out.sse, out.esum)


def offgrid_tables_from_jax(tbl, live, dtype=torch.float64, device="cpu"):
    """One phase's JAX slot tables (W, V, M) and liveness row, as numpy or
    anything ``np.asarray`` takes, as this port's tensors."""
    def t(a):
        return torch.tensor(np.array(a), dtype=dtype, device=device)
    return tuple(t(a) for a in tbl), torch.tensor(np.array(live), dtype=torch.bool,
                                                   device=device)


def from_jax_inputs(mat_nd, n0, p0, e0, obs_values, log_scale, min_val,
                    normalize=False, mask=None, cfg=None, schedule=None,
                    dtype=torch.float64, device="cpu"):
    """Carry the JAX package's inputs, given as numpy (or anything
    ``np.asarray`` takes), over to this port.

    ``cfg`` is the JAX ``SolverConfig`` (or a dict of its fields); ``schedule``
    the ladder ((stride, num_fine_steps), ...).  Returns
    ``(mat_nd, n0, p0, e0, obs, cfg, schedule)`` as this port's tensors,
    ``FusedObs`` and ``SolverConfig``.
    """
    def t(a):
        return torch.tensor(np.array(a), dtype=dtype, device=device)

    obs = FusedObs(values=t(obs_values), log_scale=float(np.asarray(log_scale)),
                   min_val=float(min_val), normalize=bool(normalize),
                   mask=None if mask is None else t(mask))
    port_cfg = None
    if cfg is not None:
        fields = cfg._asdict() if hasattr(cfg, "_asdict") else dict(cfg)
        port_cfg = SolverConfig(**{k: fields[k] for k in SolverConfig._fields
                                   if k in fields})
    if schedule is not None:
        schedule = tuple((int(s), int(n)) for s, n in schedule)
    return t(mat_nd), t(n0), t(p0), t(e0), obs, port_cfg, schedule
