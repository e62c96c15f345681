"""BDF time evolution of the TRPL model with the fused log-likelihood.

``solve`` advances a batch of simulations over a fixed-dt horizon.  With
``method="fused_horizon_chord"`` (chord Newton) or ``"fused_horizon"``
(full Newton) and fused observations the whole horizon is one launch of
the horizon kernel (ops/horizon_kernel.py); asked only for the PL trace
(and perhaps the state and iteration traces), either fused method is one
launch of the kernel's full Newton recording it (the JAX package runs them
as coupled_newton there).  Otherwise, and for every segmented call
(``start_step``, ``init_hist``, ``acc0``, ``return_hist``, ``pl0``), a
Python step loop runs coupled Newton step by step:
models/newton.coupled_newton_step, or for ``method="coupled_newton_pallas"``
one launch of the per-step Newton kernel per step (ops/newton_kernel.py).
``method="gauss_seidel"`` (the default, as in the JAX package) is the
reference's scheme, plain PyTorch in the same step loop:
models/trpl.implicit_step, N then P by tridiagonal PCR and E explicit.
On CUDA tensors the step loop runs as CUDA graphs, its Newton loops'
exit tests lagged one iteration (:class:`BdfStepper`,
models/step_graph.py), as the JAX package runs it as one XLA scan.

The likelihood is fused into the time loop: the loop carries running sums
of the log-residual and its square, and the sampled ``mag_offset`` enters
in closed form afterwards: sum((e + m)^2) = sum(e^2) + 2 m sum(e) + n m^2.
Non-convergence is a per-sample flag.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.newton_kernel import newton_step, step_launcher
from .newton import CoupledNewtonLoop, coupled_newton_step
from .step_graph import StepRunner, step_class
from .trpl import (BDF_TABLE, HISTORY, GaussSeidelLoop, MatParams, implicit_step,
                   onehot_rows, update_e)


class SolverConfig(NamedTuple):
    """Static solve configuration (nondimensional grid: dt == 1)."""
    num_steps: int                 # T: number of BDF steps
    pl_stride: int = 1             # record PL every pl_stride steps
    tol: float = 1e-7              # Newton convergence tolerance
    max_iters: int = 10000         # Newton iteration cap per step
    step_tol: Optional[float] = None  # also accept max|dX| <= step_tol*max|X|
    record_state_stride: Optional[int] = None
    record_iters: bool = False
    predictor: str = "previous"    # previous | linear | quadratic | geometric
    method: str = "gauss_seidel"   # gauss_seidel (reference scheme) |
    #                                coupled_newton | coupled_newton_pallas |
    #                                fused_horizon | fused_horizon_chord
    chord_strict: bool = False     # chord acceptance profile; solve_multiphase
    #                                forces True (ops/horizon_kernel._chord_knobs)


class FusedObs(NamedTuple):
    """Observations for in-loop likelihood accumulation.

    ``values``: (num_exp, T // pl_stride + 1) log10 PL observations on the
    simulation grid.  ``log_scale``: log10 of the PL redimensionalization
    factor 1/(dx^2 dt).  ``min_val``: clamp floor applied to PL before
    log10.  ``mask``: optional (num_exp, n_pl) nonnegative per-point
    weights w_i; the sums are sse = sum w_i e_i^2 and esum = sum w_i e_i
    (weight 0 = padding, 1/sigma^2 = the sigma-weighted likelihood).
    """
    values: torch.Tensor
    log_scale: float
    min_val: float
    normalize: bool = False
    mask: Optional[torch.Tensor] = None


class SolveResult(NamedTuple):
    pl: Optional[torch.Tensor]        # (batch, T // pl_stride + 1) nondim PL,
    #                                   if recorded
    n: torch.Tensor                   # final N (batch, L)
    p: torch.Tensor
    e: torch.Tensor
    converged: torch.Tensor           # (batch,) bool
    max_newton_iters: torch.Tensor    # scalar: worst per-step iterations
    sse: Optional[torch.Tensor]       # (num_exp, batch) running sum of w e^2
    err_sum: Optional[torch.Tensor]   # (num_exp, batch) running sum of w e
    states: Optional[tuple] = None    # (N, P, E), each (T // pl_stride, batch, L):
    #                                   the state at recorded point j + 1, NaN
    #                                   unless (j + 1) pl_stride is a multiple
    #                                   of record_state_stride
    iters: Optional[torch.Tensor] = None  # (T // pl_stride,) int32: the largest
    #                                   iteration count of each point's steps
    hist: Optional[tuple] = None      # final (nh, ph, eh) rolling histories
    sample_iters: Optional[torch.Tensor] = None   # (batch,) Newton updates
    full_solves: Optional[torch.Tensor] = None    # (batch,) Jacobian refreshes
    #                                               (chord kernel telemetry)
    tile_body_iters: Optional[torch.Tensor] = None  # (batch,) executed Newton
    #                                               iterations (chord + full)


def pl_observable(N, P, mp: MatParams):
    """Nondimensional PL: rate * sum_n(N P - n0 p0) (reference: pvSimPCR.py:276-281)."""
    L = N.shape[-1]
    return mp.rate * ((N * P).sum(-1) - L * mp.n0 * mp.p0)


def log_floor(min_val: float, dtype: torch.dtype) -> float:
    """The PL clamp floor, strictly positive in the compute dtype:
    min_val = sys.float_info.min rounds to 0.0 in float32, and log10(0) =
    -inf would poison the coarse-phase dense output (mixed-sign weights ->
    inf - inf = NaN)."""
    return max(float(torch.tensor(min_val, dtype=dtype)),
               torch.finfo(dtype).tiny)


def _log_pl(pl, obs: FusedObs, pl0):
    val = pl / pl0 if obs.normalize else pl
    out = torch.log10(torch.clamp_min(val, log_floor(obs.min_val, val.dtype)))
    return out if obs.normalize else out + _scalar(obs.log_scale, out)


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim tensor in ``like``'s dtype and device, so that arithmetic on
    it rounds in the compute dtype as the JAX package's does."""
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def bdf_table(dtype, device) -> torch.Tensor:
    """The BDF coefficients of every step, in the compute dtype: row
    ``step_class(t)`` (t during the startup ramp, then 4 + t % 6) holds
    step t -> t+1's a0, then the weight of each rolling history slot 0..5
    (0 for the slot the step does not read).  Built once per solve."""
    tab = np.zeros((4 + HISTORY, 1 + HISTORY))
    for c in range(4 + HISTORY):
        t = c if c < 4 else c + 2          # a step of class c
        a = BDF_TABLE[min(t, 4)]
        tab[c, 0] = a[0]
        for m in range(5):
            tab[c, 1 + (t - m) % HISTORY] = a[m + 1]
    return torch.as_tensor(tab, dtype=dtype, device=device)


def _bdf_coeffs(t: int, like: torch.Tensor):
    """(a0, {slot: weight}) for step t -> t+1 with the rolling slot layout."""
    row = bdf_table(like.dtype, like.device)[step_class(t)]
    return row[0], {s: float(row[1 + s]) for s in range(HISTORY)}


def _hist_sum(row, h, out=None):
    """The sum over slots s = 0..5 of ``row[1 + s] * h[s]``: every slot's
    product in one multiply, then the adds in slot order from 0, as
    Python's ``sum`` adds them (so bitwise its result).  ``out``: the
    buffer to write it into."""
    prod = row[1:, None, None] * h
    acc = torch.add(prod[0], 0, out=out)
    for s in range(1, HISTORY):
        acc.add_(prod[s])
    return acc


def _step_inputs(t: int, nh, ph, eh, cfg: SolverConfig, row, out=(None, None, None)):
    """(a0, bN, bP, bE, Nk, Pk, Ek) of step t: the history sums over slots
    0..5 in order (the zero-weight slot included) with ``row`` the step's
    row of :func:`bdf_table`, written into ``out``'s buffers where given,
    and the extrapolated initial iterate with a positivity fallback (Ek
    only for ``gauss_seidel``, None otherwise)."""
    bn, bp, be = (_hist_sum(row, h, o) for h, o in zip((nh, ph, eh), out))
    k = t % HISTORY
    Nk, Pk = nh[k], ph[k]
    if cfg.predictor in ("linear", "quadratic", "geometric"):
        # Extrapolated initial iterate with a positivity fallback (the same
        # fixed point; fewer Newton solves on smooth stretches).
        ko = (t - 1) % HISTORY
        ramp = float(min(t, 1))
        d1n = Nk - nh[ko]
        d1p = Pk - ph[ko]
        Nx = Nk + ramp * d1n
        Px = Pk + ramp * d1p
        if cfg.predictor == "quadratic":
            ko2 = (t - 2) % HISTORY
            ramp2 = float(t >= 2)
            Nx = Nx + ramp2 * (d1n - (nh[ko] - nh[ko2]))
            Px = Px + ramp2 * (d1p - (ph[ko] - ph[ko2]))
        if cfg.predictor == "geometric":
            Nm, Pm = nh[ko], ph[ko]
            Nx = torch.where(Nm > 0, Nk * (Nk / torch.where(Nm > 0, Nm, 1.0)), Nx)
            Px = torch.where(Pm > 0, Pk * (Pk / torch.where(Pm > 0, Pm, 1.0)), Px)
        Nk = torch.where(Nx > 0, Nx, Nk)
        Pk = torch.where(Px > 0, Px, Pk)
    Ek = None
    if cfg.method == "gauss_seidel":
        Ek = eh[k]
        if cfg.predictor in ("linear", "quadratic", "geometric"):
            Ek = Ek + float(min(t, 1)) * (Ek - eh[(t - 1) % HISTORY])
    return row[0], bn, bp, be, Nk, Pk, Ek


def bdf_step(t: int, nh, ph, eh, mp: MatParams, cfg: SolverConfig, tol, step_tol,
             table: Optional[torch.Tensor] = None):
    """One BDF step on the rolling histories (6, batch, L), its Newton loop
    tested on the host (models/step_graph.py's eager route; the others go
    through :class:`BdfStepper`); shared by ``solve``, the coarse phases of
    models/twophase.py, the off-grid phases of models/offgrid.py and the
    plain full-Newton chain of ops/horizon_kernel.py.  ``table``: the
    solve's :func:`bdf_table` (built here if not given).
    ``gauss_seidel`` steps with models/trpl.implicit_step, the only scheme
    that reads the iterate's E; ``coupled_newton_pallas`` with the per-step
    Newton kernel (ops/newton_kernel.newton_step, the JAX package's
    pallas_newton_step), every other method with
    models/newton.coupled_newton_step, which eliminates E.  (The JAX package
    also sends the fused-horizon methods' per-step dispatch to the Pallas
    step on the TPU; its solve() never reaches that branch, so it is not
    ported.)  Updates the histories in place and returns (N, P, E, iters,
    ok)."""
    table = bdf_table(nh.dtype, nh.device) if table is None else table
    a0, bn, bp, be, Nk, Pk, Ek = _step_inputs(t, nh, ph, eh, cfg, table[step_class(t)])
    if cfg.method == "gauss_seidel":
        Nn, Pn, En, iters, ok = implicit_step(
            Nk, Pk, Ek, bn, bp, be, mp, a0, tol, cfg.max_iters, step_tol=step_tol)
    else:
        step = newton_step if cfg.method == "coupled_newton_pallas" else coupled_newton_step
        Nn, Pn, En, iters, ok = step(
            Nk, Pk, bn, bp, be, mp, a0, tol, cfg.max_iters, step_tol=step_tol)
    kp = (t + 1) % HISTORY
    nh[kp] = Nn
    ph[kp] = Pn
    eh[kp] = En
    return Nn, Pn, En, iters, ok


class BdfStepper:
    """The BDF steps of one step loop on its rolling histories (6, batch,
    L), through a models/step_graph.StepRunner.

    :meth:`step` runs step t and then ``update(N, P, E, iters, ok)``, the
    caller's own work of the step, which must change nothing but buffers
    allocated before the loop (in place) and branch in Python only on what
    its ``key`` names.  On the eager route that is :func:`bdf_step`.  On the
    others the step's inputs go into buffers of their own, and the step is
    a set-up piece, the Newton loop (models/newton.CoupledNewtonLoop or
    models/trpl.GaussSeidelLoop, its exit lagged) and an end piece; with
    ``coupled_newton_pallas`` one piece holds all of it, the per-step
    kernel bound once (ops/newton_kernel.step_launcher).  On the graph
    route each piece is a CUDA graph per step class and key.  The values
    handed to ``update`` live in those buffers until the next step.
    ``eager_step``: the eager route's step (a caller's own name for
    :func:`bdf_step`)."""

    def __init__(self, nh, ph, eh, mp: MatParams, cfg: SolverConfig, tol, step_tol,
                 runner, eager_step=None):
        self.nh, self.ph, self.eh, self.mp, self.cfg = nh, ph, eh, mp, cfg
        self.tol, self.step_tol, self.runner = tol, step_tol, runner
        self.eager_step = bdf_step if eager_step is None else eager_step
        self.table = bdf_table(nh.dtype, nh.device)
        if runner.route == "eager":
            return
        like = nh[0]
        onehot_rows(like)
        self.a0 = torch.zeros((), dtype=like.dtype, device=like.device)
        self.bn, self.bp, self.be, self.Nk, self.Pk, self.Ek = (
            torch.empty_like(like) for _ in range(6))
        args = (self.bn, self.bp, self.be, mp, self.a0, tol, cfg.max_iters, step_tol)
        self.loop = None
        if cfg.method == "gauss_seidel":
            self.loop = GaussSeidelLoop(self.Nk, self.Pk, self.Ek, *args)
        elif cfg.method != "coupled_newton_pallas":
            self.loop = CoupledNewtonLoop(self.Nk, self.Pk, *args)
        elif like.is_cuda:
            self.launch, self.out = step_launcher(self.Nk, self.Pk, *args,
                                                  stream=runner.launch_stream)
        else:
            self.out = (*(torch.empty_like(like) for _ in range(3)),
                        torch.empty(like.shape[0], dtype=torch.int32),
                        torch.empty(like.shape[0], dtype=torch.int32))

    def step(self, t: int, update, key=()):
        if self.runner.route == "eager":
            update(*self.eager_step(t, self.nh, self.ph, self.eh, self.mp, self.cfg,
                                    self.tol, self.step_tol, self.table))
            return
        c, run = step_class(t), self.runner.run
        if self.loop is None:
            run(("step", c) + tuple(key),
                lambda: (self._start(t), self._kernel(), self._end(t, update)))
            return
        run(("start", c), lambda: (self._start(t), self.runner.mark(self.loop)))
        self.runner.loop("newton", self.loop)
        run(("end", c) + tuple(key), lambda: self._end(t, update))

    def _start(self, t: int):
        a0, _, _, _, Nk, Pk, Ek = _step_inputs(t, self.nh, self.ph, self.eh, self.cfg,
                                               self.table[step_class(t)],
                                               (self.bn, self.bp, self.be))
        for buf, x in ((self.a0, a0), (self.Nk, Nk), (self.Pk, Pk)):
            buf.copy_(x)
        if Ek is not None:
            self.Ek.copy_(Ek)
        if self.loop is not None:
            self.loop.reset()

    def _kernel(self):
        if self.Nk.is_cuda:
            self.launch()
            return
        out = newton_step(self.Nk, self.Pk, self.bn, self.bp, self.be, self.mp, self.a0,
                          self.tol, self.cfg.max_iters, step_tol=self.step_tol)
        for buf, x in zip(self.out, out):
            buf.copy_(x)

    def _end(self, t: int, update):
        if self.loop is None:
            Nn, Pn, En, iters, ok = self.out
            ok = ok.bool()
        else:
            Nn, Pn, iters, ok = self.Nk, self.Pk, self.loop.its, self.loop.done
            En = (self.Ek if self.cfg.method == "gauss_seidel" else
                  update_e(Nn, Pn, self.be, self.mp, self.a0))
        kp = (t + 1) % HISTORY
        self.nh[kp] = Nn
        self.ph[kp] = Pn
        self.eh[kp] = En
        update(Nn, Pn, En, iters, ok)


def init_history(n_init, p_init, e_init):
    batch, L = n_init.shape
    hs = []
    for x in (n_init, p_init, e_init):
        h = torch.zeros((HISTORY, batch, L), dtype=x.dtype, device=x.device)
        h[0] = x
        hs.append(h)
    return tuple(hs)


def _check_supported(cfg: SolverConfig):
    if cfg.record_state_stride is not None and cfg.record_state_stride < 1:
        raise ValueError(f"record_state_stride={cfg.record_state_stride} < 1")
    if cfg.num_steps % cfg.pl_stride:
        raise ValueError(f"num_steps={cfg.num_steps} not divisible by "
                         f"pl_stride={cfg.pl_stride}")
    from ..utils.validate import SOLVER_METHODS, validate_solver
    if cfg.method not in SOLVER_METHODS:
        validate_solver(cfg.method, cfg.predictor)


def solve(mat_nd, n_init, p_init, e_init, cfg: SolverConfig,
          obs: Optional[FusedObs] = None, record_pl: bool = True,
          kernel=None, start_step: int = 0, init_hist: Optional[tuple] = None,
          acc0: Optional[tuple] = None, return_hist: bool = False,
          pl0: Optional[torch.Tensor] = None) -> SolveResult:
    """Evolve a batch of TRPL simulations for cfg.num_steps BDF steps.

    Args:
      mat_nd: (batch, 12) nondimensionalized material parameters.
      n_init/p_init/e_init: (batch, L) initial state (E on edges 0..L-1).
      obs: optional fused observations (enables in-loop likelihood), one
        column per recorded point: (num_exp, T // pl_stride + 1).
      record_pl: emit the PL trace, at t = 0 and after every cfg.pl_stride
        steps; the Newton failures of every step count.
      kernel: the horizon kernel's entry for fused solves (default
        ops.horizon_kernel.horizon_chord); tests pass its plain version.
      start_step/init_hist/acc0/return_hist: segmentation, as the JAX
        package's solve: ``return_hist=True`` returns the rolling histories
        in ``hist``; the next segment passes them as ``init_hist`` with
        ``start_step`` = the steps already taken (a multiple of
        cfg.pl_stride), ``acc0`` = (sse, err_sum) so far and the obs columns
        from the segment boundary.  The BDF order ramp, the slot layout and
        the sums continue where the last segment stopped.
      pl0: the normalization anchor (the run's t = 0 PL, (batch,)); a
        continued segment with ``obs.normalize`` must pass it.
    """
    _check_supported(cfg)
    segmented = (start_step != 0 or init_hist is not None or acc0 is not None
                 or return_hist or pl0 is not None)
    if cfg.method in ("fused_horizon", "fused_horizon_chord") and not segmented:
        if (obs is not None and not record_pl and cfg.pl_stride == 1
                and cfg.record_state_stride is None and not cfg.record_iters):
            from ..ops.horizon_kernel import solve_horizon_fused
            return solve_horizon_fused(mat_nd, n_init, p_init, cfg, obs,
                                       e_init=e_init, kernel=kernel)
        if obs is None and record_pl:
            from ..ops.horizon_kernel import solve_horizon_record
            return solve_horizon_record(mat_nd, n_init, p_init, cfg,
                                        e_init=e_init, kernel=kernel)

    stride = cfg.pl_stride
    if start_step % stride:
        raise ValueError(f"start_step={start_step} not divisible by pl_stride={stride}")
    mp = MatParams.from_array(mat_nd)
    batch, L = n_init.shape
    dev = n_init.device
    tol = _scalar(cfg.tol, n_init)
    step_tol = _scalar(0.0 if cfg.step_tol is None else cfg.step_tol, n_init)
    if obs is not None:
        # The log offset as a tensor once, so that no step makes one.
        obs = obs._replace(log_scale=_scalar(obs.log_scale, n_init))
    if init_hist is not None:
        # The steps write the histories in place: the caller's stay as given.
        nh, ph, eh = (h.clone() for h in init_hist)
        k0 = start_step % HISTORY
        n_cur, p_cur = nh[k0], ph[k0]
        if obs is not None and obs.normalize and pl0 is None:
            raise ValueError(
                "continued segment with obs.normalize=True requires the run-t=0 "
                "PL anchor: pass pl0= from the first segment "
                "(pl_observable(n0, p0, mp))")
    else:
        nh, ph, eh = init_history(n_init, p_init, e_init)
        n_cur, p_cur = n_init, p_init
    pl0 = (pl_observable(n_cur, p_cur, mp) if pl0 is None
           else torch.as_tensor(pl0, dtype=n_init.dtype, device=dev))
    sse = esum = None
    if acc0 is not None:
        sse, esum = (x.clone() for x in acc0)
    elif obs is not None:
        e0 = _log_pl(pl0, obs, pl0) - obs.values[:, 0:1]      # (num_exp, batch)
        if obs.mask is not None:
            m0 = obs.mask[:, 0:1]
            sse, esum = m0 * e0 ** 2, m0 * e0
        else:
            sse, esum = e0 ** 2, e0
    n_outer = cfg.num_steps // stride
    rss = cfg.record_state_stride
    states = (torch.full((3, n_outer, batch, L), float("nan"), dtype=n_init.dtype,
                         device=dev) if rss is not None else None)
    iters_trace = (torch.zeros(n_outer, dtype=torch.int32, device=dev)
                   if cfg.record_iters else None)
    # The PL trace, written column by column as the record launch does.
    trace = None
    if record_pl:
        trace = torch.empty((batch, n_outer + 1), dtype=n_init.dtype, device=dev)
        trace[:, 0] = pl0
    conv = torch.ones(batch, dtype=torch.bool, device=dev)
    samp_it = torch.zeros(batch, dtype=torch.int32, device=dev)
    max_it = torch.zeros((), dtype=torch.int32, device=dev)
    # Since the last recorded point: every step converged, the largest
    # per-step iteration count; and the recorded points so far (on the
    # device, so that a step's work names its columns without the host).
    ok = torch.ones(batch, dtype=torch.bool, device=dev)
    outer_it = torch.zeros((), dtype=torch.int32, device=dev)
    col = torch.zeros(1, dtype=torch.long, device=dev)

    def update(Nn, Pn, En, iters, ok_t, record, frame):
        samp_it.add_(iters)
        step_max = iters.max()
        torch.maximum(max_it, step_max, out=max_it)
        ok.logical_and_(ok_t)
        torch.maximum(outer_it, step_max, out=outer_it)
        if not record:
            return
        # Recorded point j + 1 = col + 1, after pl_stride steps (JAX
        # solver.py:367-416).
        pl = pl_observable(Nn, Pn, mp)
        if trace is not None:
            trace.index_copy_(1, col + 1, pl[:, None])
        if obs is not None:
            e = _log_pl(pl, obs, pl0) - obs.values.index_select(1, col + 1)
            if obs.mask is not None:
                # A step whose observation points are all mask padding
                # carries no likelihood weight and cannot fail a sample.
                mcol = obs.mask.index_select(1, col + 1)
                ok.logical_or_(mcol.sum() == 0)
                sse.add_(mcol * e ** 2)
                esum.add_(mcol * e)
            else:
                sse.add_(e ** 2)
                esum.add_(e)
        conv.logical_and_(ok)
        if frame:
            states.index_copy_(1, col, torch.stack((Nn, Pn, En))[:, None])
        if iters_trace is not None:
            iters_trace.index_copy_(0, col, outer_it[None])
        ok.fill_(True)
        outer_it.zero_()
        col.add_(1)

    stepper = BdfStepper(nh, ph, eh, mp, cfg, tol, step_tol, StepRunner(dev))
    for t in range(start_step, start_step + cfg.num_steps):
        record = (t + 1) % stride == 0
        frame = (states is not None and record
                 and (t + 1 - start_step) % rss == 0)
        stepper.step(t, lambda *out, r=record, f=frame: update(*out, r, f),
                     (record, frame))
    k_final = (start_step + cfg.num_steps) % HISTORY
    return SolveResult(
        pl=trace, n=nh[k_final], p=ph[k_final], e=eh[k_final], converged=conv,
        max_newton_iters=max_it,
        sse=sse if obs is not None else None,
        err_sum=esum if obs is not None else None,
        states=None if states is None else tuple(states.unbind(0)),
        iters=iters_trace,
        hist=(nh, ph, eh) if return_hist else None,
        sample_iters=samp_it)
