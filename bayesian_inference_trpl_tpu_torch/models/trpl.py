"""Core numerics of the 1-D electron/hole drift-diffusion-decay TRPL model.

Everything here operates on nondimensionalized, batched tensors of shape
(batch, L) with the spatial axis last.  The BDF1->5 coefficient ramp, the
Gauss-Seidel N-then-P Newton linearization with surface-recombination
boundary rows and the explicit E update follow the reference kernel
(pvSimPCR.py:93-306); each expression keeps the operation order of the
JAX package's models/trpl.py, so float64 results agree to rounding.

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

from ..ops.tridiag import pcr_solve, residual_l1, shift_left, shift_right
from .step_graph import eager_loop

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


# One-hot rows, built once per (L, idx, dtype, device): a step loop
# captured as a CUDA graph cannot write a host value into a row.
_ONEHOT = {}


def _onehot(x: torch.Tensor, idx: int) -> torch.Tensor:
    """One-hot (1, L) row in x's dtype and device (exact 0/1), cached.
    Column updates are multiply-adds with it, as in the JAX package, so
    that non-finite values propagate the same way.  A row first asked for
    while a CUDA graph is being captured raises (the capture would record
    its construction, not run it): warm it with :func:`onehot_rows`."""
    key = (x.shape[-1], idx, x.dtype, x.device)
    h = _ONEHOT.get(key)
    if h is None:
        if x.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"one-hot row {key} first asked for inside a CUDA "
                               f"graph capture")
        h = _ONEHOT[key] = (torch.arange(x.shape[-1], device=x.device)
                            == idx).to(x.dtype)[None]
    return h


def onehot_rows(x: torch.Tensor) -> None:
    """Build the rows of x's width that the model reads (columns 0 and
    L - 1), before a step loop is captured."""
    for idx in (0, x.shape[-1] - 1):
        _onehot(x, idx)


def _zero_col(x: torch.Tensor, idx: int = 0) -> torch.Tensor:
    return x * (1.0 - _onehot(x, idx))


def _zero_col0(x: torch.Tensor) -> torch.Tensor:
    return _zero_col(x, 0)


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


def assemble_n(Nk, Pk, Ek, bN, mp: MatParams, a0):
    """Tridiagonal Newton system for N (reference: pvSimPCR.py:148-170).

    Returns (ld, d, ud, rhs) with ld[..., 0] == ud[..., -1] == 0.
    """
    dn = _col(mp.dn)
    L = Nk.shape[-1]
    n0p0 = _col(mp.n0 * mp.p0)
    Er = shift_left(Ek, 1)                      # Er[n] = E[n+1]
    # Flux coupling coefficients from the edge field E[n].
    ud = _zero_col(dn * (-Er / 2.0 - 1.0), L - 1)
    ld = _zero_col(dn * (Ek / 2.0 - 1.0), 0)
    # Source-term Jacobian dR/dN at the current iterate.
    np_ = Nk * Pk - n0p0
    tp = Nk * _col(mp.tau_p) + Pk * _col(mp.tau_n)
    ds = (-_col(mp.rate) * Pk
          - (Pk * tp - _col(mp.tau_p) * np_) / tp ** 2
          - (_col(mp.cn) * Nk * Pk + _col(mp.cp) * Pk ** 2 + _col(mp.cn) * np_))
    # Diagonal: a0 minus the two flux terms that exist for this row.
    left = _zero_col(dn * (-Ek / 2.0 - 1.0), 0)      # row 0 has no left edge
    right = _zero_col(dn * (Er / 2.0 - 1.0), L - 1)  # row L-1 has no right edge
    d = a0 - left - right - ds
    rhs = -recombination(Nk, Pk, mp) - ds * Nk - bN
    # Surface recombination rows (reference: pvSimPCR.py:164-170).
    s_num0 = _col(mp.sr0) * (Nk[..., 0] * Pk[..., 0] - n0p0[..., 0])[:, None]
    s_numL = _col(mp.srL) * (Nk[..., -1] * Pk[..., -1] - n0p0[..., 0])[:, None]
    denom0 = (Nk[..., 0] + Pk[..., 0])[:, None]
    denomL = (Nk[..., -1] + Pk[..., -1])[:, None]
    ds0 = -_col(mp.sr0) * (Pk[..., 0:1] ** 2 + n0p0) / denom0 ** 2
    dsL = -_col(mp.srL) * (Pk[..., -1:] ** 2 + n0p0) / denomL ** 2
    d = _add_col(d, 0, -ds0)
    d = _add_col(d, L - 1, -dsL)
    rhs = _add_col(rhs, 0, -(s_num0 / denom0 + ds0 * Nk[..., 0:1]))
    rhs = _add_col(rhs, L - 1, -(s_numL / denomL + dsL * Nk[..., -1:]))
    return ld, d, ud, rhs


def assemble_p(Nk, Pk, Ek, bP, mp: MatParams, a0):
    """Tridiagonal Newton system for P (reference: pvSimPCR.py:178-198)."""
    dp = _col(mp.dp)
    L = Nk.shape[-1]
    n0p0 = _col(mp.n0 * mp.p0)
    Er = shift_left(Ek, 1)
    ud = _zero_col(dp * (Er / 2.0 - 1.0), L - 1)
    ld = _zero_col(dp * (-Ek / 2.0 - 1.0), 0)
    np_ = Nk * Pk - n0p0
    tp = Nk * _col(mp.tau_p) + Pk * _col(mp.tau_n)
    ds = (-_col(mp.rate) * Nk
          - (Nk * tp - _col(mp.tau_n) * np_) / tp ** 2
          - (_col(mp.cp) * Nk * Pk + _col(mp.cn) * Nk ** 2 + _col(mp.cp) * np_))
    left = _zero_col(dp * (Ek / 2.0 - 1.0), 0)
    right = _zero_col(dp * (-Er / 2.0 - 1.0), L - 1)
    d = a0 - left - right - ds
    rhs = -recombination(Nk, Pk, mp) - ds * Pk - bP
    s_num0 = _col(mp.sr0) * (Nk[..., 0] * Pk[..., 0] - n0p0[..., 0])[:, None]
    s_numL = _col(mp.srL) * (Nk[..., -1] * Pk[..., -1] - n0p0[..., 0])[:, None]
    denom0 = (Nk[..., 0] + Pk[..., 0])[:, None]
    denomL = (Nk[..., -1] + Pk[..., -1])[:, None]
    ds0 = -_col(mp.sr0) * (Nk[..., 0:1] ** 2 + n0p0) / denom0 ** 2
    dsL = -_col(mp.srL) * (Nk[..., -1:] ** 2 + n0p0) / denomL ** 2
    d = _add_col(d, 0, -ds0)
    d = _add_col(d, L - 1, -dsL)
    rhs = _add_col(rhs, 0, -(s_num0 / denom0 + ds0 * Pk[..., 0:1]))
    rhs = _add_col(rhs, L - 1, -(s_numL / denomL + dsL * Pk[..., -1:]))
    return ld, d, ud, rhs


def newton_iteration(Nk, Pk, Ek, bN, bP, bE, mp: MatParams, a0):
    """One Gauss-Seidel Newton sweep: solve N, then P with the new N, then
    update E explicitly.  Returns the new iterate and the *pre-solve*
    relative residuals, the reference's convergence metric (norm2 is
    evaluated on the current iterate before pcreduce; reference:
    pvSimPCR.py:172-175, 200-202)."""
    ld, d, ud, rhs = assemble_n(Nk, Pk, Ek, bN, mp, a0)
    err_n = residual_l1(ld, d, ud, Nk, rhs)
    Nk1 = pcr_solve(ld, d, ud, rhs)
    ld, d, ud, rhs = assemble_p(Nk1, Pk, Ek, bP, mp, a0)
    err_p = residual_l1(ld, d, ud, Pk, rhs)
    Pk1 = pcr_solve(ld, d, ud, rhs)
    Ek1 = update_e(Nk1, Pk1, bE, mp, a0)
    return Nk1, Pk1, Ek1, err_n, err_p


class GaussSeidelLoop:
    """The Gauss-Seidel fixed-point loop of one BDF step, in place on
    buffers that live across steps (so that models/step_graph.py can
    replay its iterations): ``Nk``/``Pk``/``Ek`` hold the iterate, and the
    caller writes the step's predicted iterate into them and calls
    :meth:`reset` before the first iteration.  The history sums and a0 are
    read from the tensors given here, which the caller also rewrites in
    place every step."""

    def __init__(self, Nk, Pk, Ek, bN, bP, bE, mp: MatParams, a0, tol,
                 max_iters: int, step_tol=0.0):
        self.Nk, self.Pk, self.Ek = Nk, Pk, Ek
        self.bN, self.bP, self.bE, self.mp, self.a0 = bN, bP, bE, mp, a0
        self.tol, self.step_tol = tol, step_tol
        self.limit = max_iters
        batch = Nk.shape[0]
        self.done = torch.zeros(batch, dtype=torch.bool, device=Nk.device)
        self.its = torch.zeros(batch, dtype=torch.int32, device=Nk.device)

    def reset(self):
        self.done.zero_()
        self.its.zero_()

    @staticmethod
    def variant(i: int):
        return None

    def all_done(self) -> torch.Tensor:
        return self.done.all()

    def iterate(self, variant=None, masked: bool = False):
        """One sweep over the whole batch; only the samples not yet done
        take the update, so a sweep after every sample is done changes
        nothing."""
        Nk, Pk, Ek, tol, step_tol = self.Nk, self.Pk, self.Ek, self.tol, self.step_tol
        Nk1, Pk1, Ek1, err_n, err_p = newton_iteration(
            Nk, Pk, Ek, self.bN, self.bP, self.bE, self.mp, self.a0)
        ok_step = (((Nk1 - Nk).abs().amax(-1) <= step_tol * Nk1.abs().amax(-1))
                   & ((Pk1 - Pk).abs().amax(-1) <= step_tol * Pk1.abs().amax(-1))
                   & (err_n < tol * STEP_TOL_RESIDUAL_GUARD)
                   & (err_p < tol * STEP_TOL_RESIDUAL_GUARD))
        upd = (~self.done)[:, None]
        Nk.copy_(torch.where(upd, Nk1, Nk))
        Pk.copy_(torch.where(upd, Pk1, Pk))
        Ek.copy_(torch.where(upd, Ek1, Ek))
        self.its.add_(upd[:, 0].to(torch.int32))
        self.done.copy_(self.done | ((err_n < tol) & (err_p < tol)) | ok_step)


def implicit_step(Nk0, Pk0, Ek0, bN, bP, bE, mp: MatParams, a0, tol,
                  max_iters: int, step_tol=0.0):
    """Advance one BDF step by the Gauss-Seidel fixed-point loop, each
    sample frozen on its own (the JAX package's implicit_step).

    A sample is done once its pre-solve residuals both pass ``tol``, or
    once its iterate has settled (max|dX| <= step_tol * max|X| for N and
    P, with both residuals within STEP_TOL_RESIDUAL_GUARD x tol; step_tol
    0 turns that off, the reference's semantics).  Every iteration sweeps
    the whole batch; only the samples not yet done take the update.  The
    loop ends at ``max_iters`` or when every sample is done, tested on the
    host before each iteration (models/step_graph.py's eager route; its
    other routes run :class:`GaussSeidelLoop` with the test lagged).

    Returns (N, P, E, iters, converged), iters the (batch,) count of
    updates applied.
    """
    loop = GaussSeidelLoop(Nk0.clone(), Pk0.clone(), Ek0.clone(), bN, bP, bE, mp, a0,
                           tol, max_iters, step_tol)
    eager_loop(loop)
    return loop.Nk, loop.Pk, loop.Ek, loop.its, loop.done
