"""Independent CPU oracle: method-of-lines integration of the *dimensional*
drift-diffusion-decay equations with scipy ``solve_ivp`` (BDF).

This is the framework's accuracy gate, mirroring the role of the reference's
CPU fallback and scipy test oracle (pvSim_fallback.py:18-117,
Testing/PV_tester2.py:13-47): a formulation that shares no discretization
code with the BDF solver (models/solver.py) — dimensional units, explicit
flux assembly, adaptive implicit integration — so agreement is meaningful.
numpy and scipy only, as the JAX package's models/oracle.py.
"""
from __future__ import annotations

import numpy as np
from scipy.integrate import solve_ivp

from .. import physics


def dydt(t, y, L, dx, n0, p0, DN, DP, B, Sf, Sb, CN, CP, tauN, tauP, lam_nm):
    """RHS of the dimensional carrier system; y = [N(L), P(L), E(L+1)].

    Units: N, P [nm^-3]; E [V/nm]; fluxes [nm^-2 ns^-1].
    DN = mu_n kB T (diffusivity, nm^2/ns); drift mobility recovered via
    mu = D / kB T.  dE/dt couples through lambda = lambda0 / eps [nm]:
    q_C / (eps eps0) = kB T lambda (both sides of the parity test use this
    identity; cf pvSim_fallback.py:58 and pvSimPCR.py's Lambda scaling).
    """
    N = y[:L]
    P = y[L:2 * L]
    E = y[2 * L:]

    NP = N * P - n0 * p0
    Sft = Sf * NP[0] / (N[0] + P[0])
    Sbt = Sb * NP[-1] / (N[-1] + P[-1])

    Jn = np.empty(L + 1)
    Jp = np.empty(L + 1)
    Jn[0], Jn[L] = Sft, -Sbt
    Jp[0], Jp[L] = -Sft, Sbt

    N_edge = 0.5 * (N[:-1] + N[1:])
    P_edge = 0.5 * (P[:-1] + P[1:])
    # J_n = mu_n N q E + D_n dN/dx ;  J_p = mu_p P q E - D_p dP/dx
    Jn[1:-1] = DN * (N_edge * E[1:-1] / physics.KB_T + (N[1:] - N[:-1]) / dx)
    Jp[1:-1] = DP * (P_edge * E[1:-1] / physics.KB_T - (P[1:] - P[:-1]) / dx)

    recomb = (B + 1.0 / (tauN * P + tauP * N) + (CN * N + CP * P)) * NP

    dN = (Jn[1:] - Jn[:-1]) / dx - recomb
    dP = -(Jp[1:] - Jp[:-1]) / dx - recomb
    # dE/dt = -(Jn + Jp) q_C / (eps eps0) = -(Jn + Jp) kB T lambda  [V nm^-1 ns^-1]
    dE = -(Jn + Jp) * physics.KB_T * lam_nm
    return np.concatenate([dN, dP, dE])


def solve_oracle(mat_par, length, time, L, num_pl, init_dn,
                 rtol=1e-8, atol=1e-12, max_step=1.0, retries=6):
    """Integrate one parameter set; returns times, N(t), P(t), E(t), PL(t).

    Args:
      mat_par: 12 (V, nm, ns)-unit parameters [n0..lambda] (lambda in nm).
      init_dn: (L,) initial excess density [nm^-3].
      num_pl: number of PL samples (including t=0) on a uniform grid.
      max_step: solve_ivp hmax; None picks it from the low-injection
        effective lifetime — fast-decaying samples (tau_eff < time/100)
        start at hmax 0.025 ns, others at 1.0 ns, the reference CPU
        fallback's heuristic (pvSim_fallback.py:94-98).  Opt-in (the
        default stays 1.0): on long horizons the 0.025 ns cap makes BDF
        ~40x slower, and the negative-density retry below already
        recovers the corners the heuristic was protecting.
      retries: a result with negative densities (or a failed integration
        at an extreme corner) is re-integrated with hmax halved, up to
        this many times — the reference test harness's recovery loop
        (Testing/PV_tester2.py:104-118).

    PL uses the rectangle rule B * sum(NP - n0 p0) * dx, matching the
    production solver's observable (pvSimPCR.py:276-281, :393); the
    reference's CPU fallback uses Simpson instead (pvSim_fallback.py:112) —
    an O(dx^2) difference far below the parity tolerance.
    """
    n0, p0, DN, DP, B, Sf, Sb, CN, CP, tauN, tauP, lam_nm = [float(v) for v in mat_par]
    dx = length / L
    if max_step is None:
        # LI_tau_eff expects the reference's user units (cm-based rates,
        # cm^2/Vs mobility, nm thickness) — convert back from the solver
        # units this oracle runs in.  np.float64 + errstate: zero-valued
        # B/CP corners divide to inf lifetimes (no contribution) instead
        # of raising.
        uc = physics.UNIT_CONVERSIONS
        with np.errstate(divide="ignore"):
            teff = float(physics.LI_tau_eff(
                np.float64(B / uc[4]), np.float64(p0 / uc[1]),
                np.float64(tauN), np.float64(Sf / uc[5]),
                np.float64(Sb / uc[6]), np.float64(CP / uc[8]),
                np.float64(length), np.float64(DN / uc[2])))
        max_step = 0.025 if (np.isfinite(teff)
                             and teff < time / 100.0) else 1.0
    y0 = np.concatenate([init_dn + n0, init_dn + p0, np.zeros(L + 1)])
    t_eval = np.linspace(0.0, time, num_pl)
    h = float(max_step)
    last_msg = ""
    for attempt in range(retries + 1):
        sol = solve_ivp(
            dydt, (0.0, time), y0, t_eval=t_eval, method="BDF",
            args=(L, dx, n0, p0, DN, DP, B, Sf, Sb, CN, CP, tauN, tauP,
                  lam_nm),
            rtol=rtol, atol=atol, max_step=h)
        if sol.success:
            N = sol.y[:L]
            P = sol.y[L:2 * L]
            if not ((N < 0).any() or (P < 0).any()):
                break
            last_msg = f"negative densities at hmax={h}"
        else:
            last_msg = sol.message
        h /= 2.0
    else:
        raise RuntimeError(
            f"oracle integration failed after {retries} hmax halvings "
            f"(final hmax {h}): {last_msg}")
    N = sol.y[:L]
    P = sol.y[L:2 * L]
    E = sol.y[2 * L:]
    pl = B * np.sum(N * P - n0 * p0, axis=0) * dx
    return sol.t, N, P, E, pl


def solve_oracle_batch(mat_par, length, time, L, num_pl, init_dn, **kw):
    """Loop `solve_oracle` over a (batch, 12) parameter matrix; returns PL (batch, num_pl)."""
    mat_par = np.atleast_2d(np.asarray(mat_par))
    out = np.empty((len(mat_par), num_pl))
    for i, mp in enumerate(mat_par):
        out[i] = solve_oracle(mp, length, time, L, num_pl, init_dn, **kw)[4]
    return out
