"""Physical constants, unit conversions, and nondimensionalization for the
1-D coupled electron/hole drift-diffusion-decay carrier model.

The 13-dimensional material-parameter vector follows the reference column
contract (reference: parallel_bayes_gpu.py:24,83-84):

    [n0, p0, mun, mup, B, Sf, Sb, CN, CP, taun, taup, lambda, mag_offset]

User-facing units are cm-based; the solver works in (V, nm, ns) after the
``UNIT_CONVERSIONS`` vector (reference: parallel_bayes_gpu.py:27-33) and is
then nondimensionalized onto the (dx, dt) grid (reference: pvSimPCR.py:330).
"""
from __future__ import annotations

import numpy as np
import torch

# --- Constants -------------------------------------------------------------
KB_T = 0.02569257          # k_B * T at 25 C [eV]
EPS0 = 8.854e-12 * 1e-9    # vacuum permittivity [C / (V nm)]
Q_C = 1.602e-19            # elementary charge [C]
LAMBDA0 = 704.3            # q^2 / (eps0 * kB T) [nm] (parallel_bayes_gpu.py:23)

PARAM_NAMES = (
    "n0", "p0", "mun", "mup", "B", "Sf", "Sb",
    "CN", "CP", "taun", "taup", "lambda", "mag_offset",
)
NUM_PARAMS = len(PARAM_NAMES)

# cm-based user units -> (V, nm, ns).  Mobilities [cm^2/Vs] convert directly
# to diffusivities [nm^2/ns] via the kB*T factor (Einstein relation), so the
# solver's columns 2,3 are D_n, D_p (reference: parallel_bayes_gpu.py:27-33).
UNIT_CONVERSIONS = np.array([
    (1e7) ** -3, (1e7) ** -3,                                  # n0, p0 [cm^-3 -> nm^-3]
    (1e7) ** 2 / 1e9 * KB_T, (1e7) ** 2 / 1e9 * KB_T,          # mun, mup [cm^2/Vs -> nm^2/ns]
    (1e7) ** 3 / 1e9,                                          # B [cm^3/s -> nm^3/ns]
    1e7 / 1e9, 1e7 / 1e9,                                      # Sf, Sb [cm/s -> nm/ns]
    (1e7) ** 6 / 1e9, (1e7) ** 6 / 1e9,                        # CN, CP [cm^6/s -> nm^6/ns]
    1.0, 1.0,                                                  # taun, taup [ns]
    LAMBDA0,                                                   # lambda [rel -> nm]
    1.0,                                                       # mag_offset [decades]
])


def nondim_scales(dx: float, dt: float) -> np.ndarray:
    """Per-column nondimensionalization scales for the 12 solver parameters
    (mag_offset excluded; reference: pvSimPCR.py:327-330).

    After scaling: densities are carriers/cell, diffusivities are per-step
    cell^2 rates, and time is measured in steps (dt == 1).
    """
    dx3 = dx ** 3
    dtdx = dt / dx
    dtdx2 = dtdx / dx
    dtdx6 = dt / dx ** 6
    return np.array([
        dx3, dx3,                 # n0, p0
        dtdx2, dtdx2,             # DN, DP
        dtdx2 / dx,               # B
        dtdx, dtdx,               # Sf, Sb
        dtdx6, dtdx6,             # CN, CP
        1.0 / dt, 1.0 / dt,       # taun, taup
        1.0 / dx,                 # lambda
    ])


def nondimensionalize(mat_par, dx: float, dt: float):
    """Scale a (batch, 12) matrix of (V, nm, ns)-unit parameters onto the grid."""
    mat_par = np.asarray(mat_par)
    if mat_par.shape[-1] != 12:
        raise ValueError(f"expected 12 solver params, got {mat_par.shape[-1]}")
    return mat_par * nondim_scales(dx, dt)


# --- Secondary (derived) physics parameters --------------------------------
# cm-based formulas used by posterior post-processing
# (reference: secondary_parameters.py:9-57).  Each takes numbers, numpy
# arrays or float64 tensors (on any device; posterior/data.py passes them).

def _float(x):
    """``x`` as float: a tensor as it is, anything else as a numpy array."""
    return x if isinstance(x, torch.Tensor) else np.asarray(x, dtype=float)


def t_rad(B, p0):
    """Radiative lifetime [ns]; B [cm^3/s], p0 [cm^-3]."""
    return 1.0 / (B * p0) * 1e9


def t_auger(CP, p0):
    """Auger lifetime [ns]; CP [cm^6/s], p0 [cm^-3]."""
    return 1.0 / (CP * p0 ** 2) * 1e9


def _diffusivity_nm2_ns(mu):
    # [cm^2/Vs] * [eV] -> [cm^2/s] -> [nm^2/ns]
    return mu * 0.0257 * 1e14 / 1e9


def LI_tau_eff(B, p0, tau_n, Sf, Sb, CP, thickness, mu):
    """Low-injection effective lifetime [ns] (reference: secondary_parameters.py:17-30)."""
    D = _diffusivity_nm2_ns(mu)
    tau_surf = thickness / ((Sf + Sb) * 0.01) + thickness ** 2 / (np.pi ** 2 * D)
    return (t_rad(B, p0) ** -1 + t_auger(CP, p0) ** -1
            + tau_surf ** -1 + _float(tau_n) ** -1) ** -1


def LI_tau_srh(tau_n, Sf, Sb, thickness, mu):
    """Low-injection SRH+surface lifetime [ns]."""
    D = _diffusivity_nm2_ns(mu)
    tau_surf = thickness / ((Sf + Sb) * 0.01) + thickness ** 2 / (np.pi ** 2 * D)
    return (tau_surf ** -1 + _float(tau_n) ** -1) ** -1


def HI_tau_srh(tau_n, tau_p, Sf, Sb, thickness, mu):
    """High-injection SRH+surface lifetime [ns]."""
    D = _diffusivity_nm2_ns(mu)
    tau_surf = 2 * (thickness / ((Sf + Sb) * 0.01)) + thickness ** 2 / (np.pi ** 2 * D)
    return (tau_surf ** -1 + (_float(tau_n) + tau_p) ** -1) ** -1


def s_eff(sf, sb):
    return sf + sb


def mu_eff(mu_n, mu_p):
    return 2.0 / (_float(mu_n) ** -1 + _float(mu_p) ** -1)


def epsilon(lamb):
    return _float(lamb) ** -1
