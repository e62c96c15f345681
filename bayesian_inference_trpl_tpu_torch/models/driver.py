"""Grid configuration and initial conditions around models/solver.py.

Mirrors the role of the reference's ``pvSim`` host function
(reference: pvSimPCR.py:309-401): unit handling and initialization modes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .solver import SolverConfig


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

    def solver_config(self) -> SolverConfig:
        return SolverConfig(
            num_steps=self.T, pl_stride=self.pl_stride,
            tol=10.0 ** (-self.tol_exp), max_iters=self.max_iters,
            method=self.method, predictor=self.predictor,
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
