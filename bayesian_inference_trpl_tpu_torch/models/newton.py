"""Fully-coupled Newton solver for the implicit BDF step.

Exact Newton on the coupled (N, P) system with the field E eliminated
analytically: the BDF relation for E is diagonal given (N, P),

    E[e] = (Lam (DP dP - DN dN) - bE) / (a0 + Lam (DN Nbar + DP Pbar)),

so substituting it into the fluxes keeps nearest-neighbour coupling and
the exact Jacobian is 2x2-block tridiagonal over nodes
(ops/block_tridiag.py).  The convergence metric is the reference's norm2
criterion (||F|| / ||bb||, pvSimPCR.py:161-198).

Every expression keeps the operation order of the JAX package's
models/newton.py, so float64 results agree to rounding.
"""
from __future__ import annotations

import torch

from ..ops.block_tridiag import block_pcr_solve
from ..ops.tridiag import shift_left, shift_right
from .step_graph import eager_loop
from .trpl import (MatParams, SKIP_ACCEPT_FACTOR, STEP_TOL_RESIDUAL_GUARD,
                   _add_col, _col, _onehot, _zero_col0, update_e)


def _edge_quantities(Nk, Pk, bE, mp: MatParams, a0, derivs: bool = True):
    """Per-edge field g, fluxes, and (with ``derivs``) their N/P derivatives.

    Edge arrays are length L with column 0 unused (zero); edge e couples
    nodes e-1 and e.  Returns a dict of (batch, L) tensors.
    """
    dn, dp, lam = _col(mp.dn), _col(mp.dp), _col(mp.lam)
    Nm = shift_right(Nk, 1)
    Pm = shift_right(Pk, 1)
    nbar = 0.5 * (Nk + Nm)
    pbar = 0.5 * (Pk + Pm)
    dN = Nk - Nm
    dP = Pk - Pm
    v = a0 + lam * (dn * nbar + dp * pbar)
    g = (lam * (dp * dP - dn * dN) - bE) / v
    jn = dn * (g * nbar + dN)
    jp = dp * (g * pbar - dP)
    d = dict(g=g, jn=jn, jp=jp)
    if derivs:
        inv_v = 1.0 / v
        gNm = lam * dn * (1.0 - 0.5 * g) * inv_v
        gNp = -lam * dn * (1.0 + 0.5 * g) * inv_v
        gPm = -lam * dp * (1.0 + 0.5 * g) * inv_v
        gPp = lam * dp * (1.0 - 0.5 * g) * inv_v
        d.update(
            jn_Nm=dn * (gNm * nbar + 0.5 * g - 1.0),
            jn_Np=dn * (gNp * nbar + 0.5 * g + 1.0),
            jn_Pm=dn * gPm * nbar,
            jn_Pp=dn * gPp * nbar,
            jp_Pm=dp * (gPm * pbar + 0.5 * g + 1.0),
            jp_Pp=dp * (gPp * pbar + 0.5 * g - 1.0),
            jp_Nm=dp * gNm * pbar,
            jp_Np=dp * gNp * pbar,
        )
    return {k: _zero_col0(x) for k, x in d.items()}


def _recomb_terms(Nk, Pk, mp: MatParams):
    """R and its exact partials dR/dN, dR/dP at each node."""
    n0p0 = _col(mp.n0 * mp.p0)
    np_ = Nk * Pk - n0p0
    tp = Nk * _col(mp.tau_p) + Pk * _col(mp.tau_n)
    tp2 = tp * tp
    R = (_col(mp.cn) * Nk + _col(mp.cp) * Pk + _col(mp.rate) + 1.0 / tp) * np_
    dR_dN = (_col(mp.rate) * Pk
             + (Pk * tp - _col(mp.tau_p) * np_) / tp2
             + (_col(mp.cn) * Nk * Pk + _col(mp.cp) * (Pk * Pk) + _col(mp.cn) * np_))
    dR_dP = (_col(mp.rate) * Nk
             + (Nk * tp - _col(mp.tau_n) * np_) / tp2
             + (_col(mp.cp) * Nk * Pk + _col(mp.cn) * (Nk * Nk) + _col(mp.cp) * np_))
    return R, dR_dN, dR_dP


def _surface_terms(Nk, Pk, mp: MatParams):
    """Boundary recombination Sft/Sbt and their partials, as (batch, 1)."""
    n0p0 = _col(mp.n0 * mp.p0)
    sr0, srL = _col(mp.sr0), _col(mp.srL)
    N0, P0 = Nk[..., :1], Pk[..., :1]
    NL, PL_ = Nk[..., -1:], Pk[..., -1:]
    d0 = N0 + P0
    dL = NL + PL_
    s0 = sr0 * (N0 * P0 - n0p0) / d0
    sL = srL * (NL * PL_ - n0p0) / dL
    s0_N = sr0 * (P0 * P0 + n0p0) / (d0 * d0)
    s0_P = sr0 * (N0 * N0 + n0p0) / (d0 * d0)
    sL_N = srL * (PL_ * PL_ + n0p0) / (dL * dL)
    sL_P = srL * (NL * NL + n0p0) / (dL * dL)
    return s0, sL, s0_N, s0_P, sL_N, sL_P


def _assemble_F(Nk, Pk, bN, bP, e, R, s0, sL, a0):
    """Nonlinear residuals; flux divergence with virtual boundary edges
    jn[0] := Sft, jn[L] := -Sbt."""
    L = Nk.shape[-1]
    jn_r = _add_col(shift_left(e["jn"], 1), L - 1, -sL)   # jn[n+1]
    jn_l = _add_col(e["jn"], 0, s0)                       # jn[n]; edge 0 = Sft
    jp_r = _add_col(shift_left(e["jp"], 1), L - 1, sL)
    jp_l = _add_col(e["jp"], 0, -s0)
    F_N = a0 * Nk + bN - (jn_r - jn_l) + R
    F_P = a0 * Pk + bP + (jp_r - jp_l) + R
    return F_N, F_P


def _reference_denominators(Nk, Pk, bN, bP, aux):
    """||bb||_1 denominators of the reference's norm2 metric
    (pvSimPCR.py:161,169-170,190,197-198)."""
    R, dR_dN, dR_dP, s0, sL, s0_N, s0_P, sL_N, sL_P = aux
    L = Nk.shape[-1]
    bbN = -R + dR_dN * Nk - bN
    bbN = _add_col(bbN, 0, -(s0 - s0_N * Nk[..., :1]))
    bbN = _add_col(bbN, L - 1, -(sL - sL_N * Nk[..., -1:]))
    bbP = -R + dR_dP * Pk - bP
    bbP = _add_col(bbP, 0, -(s0 - s0_P * Pk[..., :1]))
    bbP = _add_col(bbP, L - 1, -(sL - sL_P * Pk[..., -1:]))
    return bbN.abs().sum(-1), bbP.abs().sum(-1)


def residuals_and_errors(Nk, Pk, bN, bP, bE, mp: MatParams, a0):
    """The CHEAP residual pass: (F_N, F_P) plus the reference-metric
    relative errors (err_n, err_p), each (batch,), with no Jacobian."""
    e = _edge_quantities(Nk, Pk, bE, mp, a0, derivs=False)
    R, dR_dN, dR_dP = _recomb_terms(Nk, Pk, mp)
    s = _surface_terms(Nk, Pk, mp)
    F_N, F_P = _assemble_F(Nk, Pk, bN, bP, e, R, s[0], s[1], a0)
    den_n, den_p = _reference_denominators(Nk, Pk, bN, bP, (R, dR_dN, dR_dP) + s)
    err_n = F_N.abs().sum(-1) / den_n
    err_p = F_P.abs().sum(-1) / den_p
    return (F_N, F_P), (err_n, err_p)


def residuals_and_jacobian(Nk, Pk, bN, bP, bE, mp: MatParams, a0):
    """Nonlinear residuals (F_N, F_P) and the exact 2x2-block tridiagonal
    Jacobian (A, B, C) of the E-eliminated coupled system."""
    e = _edge_quantities(Nk, Pk, bE, mp, a0)
    R, dR_dN, dR_dP = _recomb_terms(Nk, Pk, mp)
    s0, sL, s0_N, s0_P, sL_N, sL_P = _surface_terms(Nk, Pk, mp)
    F_N, F_P = _assemble_F(Nk, Pk, bN, bP, e, R, s0, sL, a0)
    L = Nk.shape[-1]

    # Diagonal block B_n (rows: N, P; cols: N, P).
    B_NN = a0 - shift_left(e["jn_Nm"], 1) + e["jn_Np"] + dR_dN
    B_NP = -shift_left(e["jn_Pm"], 1) + e["jn_Pp"] + dR_dP
    B_PP = a0 + shift_left(e["jp_Pm"], 1) - e["jp_Pp"] + dR_dP
    B_PN = shift_left(e["jp_Nm"], 1) - e["jp_Np"] + dR_dN
    # Surface contributions on rows 0 and L-1.
    h0 = _onehot(Nk, 0)
    hL = _onehot(Nk, L - 1)
    sN_term = s0_N * h0 + sL_N * hL
    sP_term = s0_P * h0 + sL_P * hL
    B_NN = B_NN + sN_term
    B_NP = B_NP + sP_term
    B_PN = B_PN + sN_term
    B_PP = B_PP + sP_term
    # Super-diagonal block C_n (node n+1 through edge n+1).
    C_NN = -shift_left(e["jn_Np"], 1)
    C_NP = -shift_left(e["jn_Pp"], 1)
    C_PP = shift_left(e["jp_Pp"], 1)
    C_PN = shift_left(e["jp_Np"], 1)
    # Sub-diagonal block A_n (node n-1 through edge n).
    A_NN = e["jn_Nm"]
    A_NP = e["jn_Pm"]
    A_PP = -e["jp_Pm"]
    A_PN = -e["jp_Nm"]

    A = (A_NN, A_NP, A_PN, A_PP)
    B = (B_NN, B_NP, B_PN, B_PP)
    C = (C_NN, C_NP, C_PN, C_PP)
    return (F_N, F_P), (A, B, C)


class CoupledNewtonLoop:
    """Check-then-solve exact Newton of one BDF step, in place on buffers
    that live across steps (so that models/step_graph.py can replay its
    iterations): ``Nk``/``Pk`` hold the iterate, and the caller writes the
    step's predicted iterate into them and calls :meth:`reset` before the
    first iteration.  The history sums and a0 are read from the tensors
    given here, which the caller also rewrites in place every step.

    Iteration i < max_iters first evaluates the cheap residual.  A sample
    is frozen without an update when its residual is SKIP_ACCEPT_FACTOR
    below tol; one that merely passes tol gets a final polish update
    first.  The exact Jacobian is assembled and solved for the batch, and
    only the samples not done take the update.  ``step_tol`` adds
    state-settled acceptance (max|dX| <= step_tol*max|X| with the residual
    within STEP_TOL_RESIDUAL_GUARD x tol); 0 disables.  Iteration
    max_iters is the final acceptance check, with no solve.
    """

    def __init__(self, Nk, Pk, bN, bP, bE, mp: MatParams, a0, tol, max_iters: int,
                 step_tol=0.0):
        self.Nk, self.Pk = Nk, Pk
        self.bN, self.bP, self.bE, self.mp, self.a0 = bN, bP, bE, mp, a0
        self.tol, self.step_tol = tol, step_tol
        self.max_iters = max_iters
        self.limit = max_iters + 1       # max_iters solves + the final check
        batch = Nk.shape[0]
        self.done = torch.zeros(batch, dtype=torch.bool, device=Nk.device)
        self.its = torch.zeros(batch, dtype=torch.int32, device=Nk.device)

    def reset(self):
        self.done.zero_()
        self.its.zero_()

    def variant(self, i: int) -> bool:
        """Whether iteration i is the final check."""
        return i >= self.max_iters

    def all_done(self) -> torch.Tensor:
        return self.done.all()

    def iterate(self, final: bool, masked: bool = False):
        """One iteration.  Unmasked, it skips the Jacobian once every
        sample is done (a host read); masked, it solves regardless, which
        changes nothing then."""
        Nk, Pk, bN, bP, bE, mp, a0 = (self.Nk, self.Pk, self.bN, self.bP, self.bE,
                                      self.mp, self.a0)
        tol, step_tol = self.tol, self.step_tol
        (F_N, F_P), (err_n, err_p) = residuals_and_errors(Nk, Pk, bN, bP, bE, mp, a0)
        ok_res = (err_n < tol) & (err_p < tol)
        skip = (err_n < tol * SKIP_ACCEPT_FACTOR) & \
               (err_p < tol * SKIP_ACCEPT_FACTOR)
        done = self.done | skip | (ok_res & final)
        polish = ok_res & ~done
        if not (final or (not masked and bool(done.all()))):
            _, (A, B, C) = residuals_and_jacobian(Nk, Pk, bN, bP, bE, mp, a0)
            dN, dP = block_pcr_solve(A, B, C, (-F_N, -F_P))
            # Positivity projection: an update that would wipe out > 95% of
            # a cell's density (or turn it negative) is clamped.
            upd = (~done)[:, None]
            Nk.copy_(torch.where(upd, torch.maximum(Nk + dN, 0.05 * Nk), Nk))
            Pk.copy_(torch.where(upd, torch.maximum(Pk + dP, 0.05 * Pk), Pk))
            self.its.add_(upd[:, 0].to(torch.int32))
            ok_step = ((dN.abs().amax(-1) <= step_tol * Nk.abs().amax(-1))
                       & (dP.abs().amax(-1) <= step_tol * Pk.abs().amax(-1))
                       & (err_n < tol * STEP_TOL_RESIDUAL_GUARD)
                       & (err_p < tol * STEP_TOL_RESIDUAL_GUARD))
            done = done | polish | ok_step
        self.done.copy_(done)


def coupled_newton_step(Nk0, Pk0, bN, bP, bE, mp: MatParams, a0, tol,
                        max_iters: int, step_tol=0.0):
    """Advance one BDF step by check-then-solve exact Newton
    (:class:`CoupledNewtonLoop`), its exit tested on the host before each
    iteration (models/step_graph.py's eager route).

    Returns (N, P, E, iters, converged), iters the (batch,) count of Newton
    updates applied.
    """
    loop = CoupledNewtonLoop(Nk0.clone(), Pk0.clone(), bN, bP, bE, mp, a0, tol,
                             max_iters, step_tol)
    eager_loop(loop)
    Ek = update_e(loop.Nk, loop.Pk, bE, mp, a0)
    return loop.Nk, loop.Pk, Ek, loop.its, loop.done
