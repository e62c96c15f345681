"""Core numerics of the 1-D electron/hole drift-diffusion-decay TRPL model.

Everything here operates on nondimensionalized, batched tensors of shape
(batch, L) with the spatial axis last.  The BDF1->5 coefficient ramp and
the explicit E update follow the reference kernel (pvSimPCR.py:93-306).

State layout:
  N, P: (batch, L) carrier densities at cell centers [carriers/cell].
  E:    (batch, L) field at cell edges 0..L-1; edge 0 is identically zero
        and edge L (also zero) is implicit.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..ops.tridiag import shift_right

# BDF startup ramp: row t (0..3) is the order-(t+1) method used at step t;
# row 4 is BDF5, used for all later steps (reference: pvSimPCR.py:241-250).
# Columns: a0 (new state), a1..a5 (history, newest first).
BDF_TABLE = np.array([
    [1.0,      -1.0, 0.0,  0.0,     0.0,  0.0],
    [1.5,      -2.0, 0.5,  0.0,     0.0,  0.0],
    [11.0 / 6, -3.0, 1.5, -1.0 / 3, 0.0,  0.0],
    [25.0 / 12, -4.0, 3.0, -4.0 / 3, 0.25, 0.0],
    [137.0 / 60, -5.0, 5.0, -10.0 / 3, 1.25, -0.2],
])
HISTORY = 6  # rolling history slots: new state + 5 back (reference: pvSimPCR.py:339)

# State-settled (step_tol) acceptance additionally requires the residual to
# be within this factor of tol: a stalled Newton (tiny steps, large
# residual) must surface as non-convergence.
STEP_TOL_RESIDUAL_GUARD = 1e3

# Check-then-solve Newton: an iterate may be accepted WITHOUT a Newton
# update only when its residual is this factor BELOW tol; an iterate that
# merely passes tol gets one final "polish" update before it is frozen.
SKIP_ACCEPT_FACTOR = float(os.environ.get("TRPL_SKIP_ACCEPT_FACTOR", "3e-2"))


class MatParams(NamedTuple):
    """Nondimensionalized per-sample material parameters, each (batch,)."""
    n0: torch.Tensor
    p0: torch.Tensor
    dn: torch.Tensor      # electron diffusivity
    dp: torch.Tensor      # hole diffusivity
    rate: torch.Tensor    # radiative B
    sr0: torch.Tensor     # front-surface recombination velocity (Sf)
    srL: torch.Tensor     # back-surface recombination velocity (Sb)
    cn: torch.Tensor      # electron Auger
    cp: torch.Tensor      # hole Auger
    tau_n: torch.Tensor
    tau_p: torch.Tensor
    lam: torch.Tensor     # relative dielectric coupling Lambda

    @classmethod
    def from_array(cls, mat_nd: torch.Tensor) -> "MatParams":
        """Split a (batch, 12) nondimensionalized parameter matrix."""
        return cls(*(mat_nd[:, i] for i in range(12)))


def _col(v: torch.Tensor) -> torch.Tensor:
    """(batch,) -> (batch, 1) for broadcasting against (batch, L)."""
    return v[:, None]


def _onehot(x: torch.Tensor, idx: int) -> torch.Tensor:
    """One-hot (1, L) row in x's dtype and device.  Column updates are
    multiply-adds with it, as in the JAX package, so that non-finite
    values propagate the same way."""
    h = torch.zeros((1, x.shape[-1]), dtype=x.dtype, device=x.device)
    h[0, idx] = 1.0
    return h


def _zero_col0(x: torch.Tensor) -> torch.Tensor:
    return x * (1.0 - _onehot(x, 0))


def _add_col(x: torch.Tensor, idx: int, v: torch.Tensor) -> torch.Tensor:
    """x[..., idx] += v[..., 0]; v is (batch, 1)."""
    return x + v * _onehot(x, idx)


def recombination(Nk, Pk, mp: MatParams):
    """Total bulk recombination R(N, P): radiative + SRH + Auger."""
    np_ = Nk * Pk - _col(mp.n0 * mp.p0)
    tp = Nk * _col(mp.tau_p) + Pk * _col(mp.tau_n)
    return (_col(mp.cn) * Nk + _col(mp.cp) * Pk + _col(mp.rate) + 1.0 / tp) * np_


def update_e(Nk, Pk, bE, mp: MatParams, a0):
    """Explicit (diagonal) BDF update of the edge field E
    (reference: pvSimPCR.py:205-209).  Edge 0 stays zero."""
    dn, dp, lam = _col(mp.dn), _col(mp.dp), _col(mp.lam)
    Nm = shift_right(Nk, 1)
    Pm = shift_right(Pk, 1)
    denom = lam * (dp * (Pk + Pm) + dn * (Nk + Nm)) / 2.0 + a0
    num = lam * (dp * (Pk - Pm) - dn * (Nk - Nm)) - bE
    return _zero_col0(num / denom)
