"""Host-level solver driver: grid configuration, unit handling,
initialization modes and re-dimensionalization around models/solver.py.

Mirrors the role of the reference's ``pvSim`` host function
(reference: pvSimPCR.py:309-401): :func:`pvsim` runs one batch of
simulations from (V, nm, ns)-unit parameters and returns its PL trace in
physical units and, on request, its state every few steps.  It runs on
``cuda`` unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import physics
from .solver import FusedObs, SolveResult, SolverConfig, solve


@dataclass(frozen=True)
class SimParams:
    """Space/time grid configuration (reference simPar contract,
    parallel_bayes_gpu.py:72-81)."""
    length: float          # film thickness [nm]
    time: float            # final delay time [ns]
    L: int = 128           # spatial points
    T: int = 80000         # time steps
    pl_stride: int = 1     # PL recording interval
    tol_exp: float = 7.0   # convergence tolerance exponent (TOL = 10^-tol_exp)
    max_iters: int = 10000
    method: str = "coupled_newton"
    predictor: str = "previous"
    step_tol: float = 0.0         # state-settled acceptance (f32 floor); 0 = off
    fast_fine_steps: Optional[int] = None   # fast-solver switch point
    fast_coarse_stride: int = 16            # base stride of the ladder
    fast_max_stride: int = 64               # stride cap
    fast_steps_per_phase: int = 512         # coarse steps per ladder rung

    @property
    def dx(self) -> float:
        return self.length / self.L

    @property
    def dt(self) -> float:
        return self.time / self.T

    @property
    def num_pl(self) -> int:
        return self.T // self.pl_stride + 1

    @property
    def pl_times(self) -> np.ndarray:
        return np.linspace(0.0, self.time, self.num_pl)

    def solver_config(self, record_state_stride=None) -> SolverConfig:
        return SolverConfig(
            num_steps=self.T, pl_stride=self.pl_stride,
            tol=10.0 ** (-self.tol_exp), max_iters=self.max_iters,
            record_state_stride=record_state_stride, method=self.method,
            predictor=self.predictor,
            step_tol=self.step_tol if self.step_tol > 0 else None)

    @property
    def fast_phases(self):
        """Phase schedule ((stride, num_fine_steps), ...) for the
        multi-phase fast solver (models/twophase.py), or None when the
        horizon is too short to coarsen."""
        if self.fast_fine_steps is None:
            return None
        from .twophase import geometric_schedule
        sched = geometric_schedule(
            self.T, int(self.fast_fine_steps),
            base_stride=int(self.fast_coarse_stride),
            coarse_steps_per_phase=int(self.fast_steps_per_phase),
            max_stride=int(self.fast_max_stride))
        return sched if len(sched) > 1 else None


def initial_excess_density(sim: SimParams, ini_par, init_mode: str,
                           dtype=torch.float64, device="cuda") -> torch.Tensor:
    """Nondimensional initial excess carrier density dN (L,) per cell.

    init_mode (reference: pvSimPCR.py:347-358):
      * "exp":    ini_par = (a, l); dN(x) = a exp(-x / l), nodes at (i+1/2) dx.
      * "points": ini_par = per-node densities [nm^-3], length L.
    (For full-state restarts use ``init_mode="continue"`` on :func:`pvsim`,
    which takes (N, P, E) instead of an excess density.)
    """
    dx = sim.dx
    if init_mode == "exp":
        a, l = ini_par
        x = (np.arange(sim.L) + 0.5) * dx
        dn = a * np.exp(-x / l) * dx ** 3
    elif init_mode == "points":
        dn = np.asarray(ini_par, dtype=float)
        if dn.shape[-1] != sim.L:
            raise ValueError(f"init profile length {dn.shape[-1]} != L={sim.L}")
        dn = dn * dx ** 3
    else:
        raise ValueError(f"unknown init_mode {init_mode!r}")
    return torch.as_tensor(dn, dtype=dtype, device=device)


def pl_log_scale(sim: SimParams) -> float:
    """log10 factor converting nondimensional PL to physical units."""
    return float(-np.log10(sim.dx ** 2 * sim.dt))


def nondim_state(n, p, e, sim: SimParams):
    """Inverse of :func:`redim_state`: physical (N [nm^-3], P [nm^-3],
    E [V/nm]) -> nondimensional solver state."""
    dx = sim.dx
    return n * dx ** 3, p * dx ** 3, e * dx / physics.KB_T


def redim_state(res: SolveResult, sim: SimParams):
    """The final state in physical units: N, P [nm^-3], E [V/nm].

    The solver's nondimensional field is E' = q E dx / kB T, so the physical
    field is E' kB T / dx (the reference's own test pipeline divides by dx
    only, keeping the kB T factor implicit on both sides; Testing/PV_tester2.py:131).
    """
    dx = sim.dx
    return res.n / dx ** 3, res.p / dx ** 3, res.e * physics.KB_T / dx


def pvsim(mat_par, sim: SimParams, ini_par, init_mode: str = "points",
          dtype=torch.float32, obs: Optional[FusedObs] = None,
          record_pl: bool = True, record_state_stride=None,
          device="cuda") -> SolveResult:
    """Run a batch of TRPL simulations from (V, nm, ns)-unit parameters.

    Args:
      mat_par: (batch, 12) parameters [n0..lambda] in (V, nm, ns) units
        (mag_offset column excluded, as in the GPU path: bayeslib.py:144).
      ini_par: initial condition per ``init_mode`` ("points", "exp", see
        :func:`initial_excess_density`).  For ``init_mode="continue"``
        (full-state restart; the mode the reference declares but leaves
        unimplemented, pvSimPCR.py:357) a tuple (N, P, E) of per-sample
        (batch, L) arrays in physical units, as :func:`redim_state`
        returns them; the BDF order ramp restarts there.
      obs: optional fused observations; ``obs.values`` in log10 of physical
        PL units on the simulation PL time grid.
      record_state_stride: record N/P/E every this many steps (the
        SolveResult's ``states``, nondimensional).

    Returns a SolveResult whose ``pl`` is re-dimensionalized to
    [photons nm^-2 ns^-1] (reference: pvSimPCR.py:393 divides by dx^2 dt).
    A fused method with no ``obs`` runs as one launch of the horizon
    kernel recording every trace (ops/horizon_kernel.solve_horizon_record).
    """
    mat_nd = torch.as_tensor(
        physics.nondimensionalize(np.asarray(mat_par), sim.dx, sim.dt),
        dtype=dtype, device=device)
    cfg = sim.solver_config(record_state_stride)
    if init_mode == "continue":
        n0, p0, e0 = nondim_state(*(torch.as_tensor(a, dtype=dtype, device=device)
                                    for a in ini_par), sim)
    else:
        dn = initial_excess_density(sim, ini_par, init_mode, dtype=dtype, device=device)
        n0 = mat_nd[:, 0:1] + dn[None, :]
        p0 = mat_nd[:, 1:2] + dn[None, :]
        e0 = torch.zeros_like(n0)
    res = solve(mat_nd, n0.contiguous(), p0.contiguous(), e0.contiguous(), cfg,
                obs=obs, record_pl=record_pl)
    if res.pl is not None:
        res = res._replace(pl=res.pl / (sim.dx ** 2 * sim.dt))
    return res
