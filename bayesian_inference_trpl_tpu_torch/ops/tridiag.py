"""Batched tridiagonal solvers along the spatial (last) axis, and the lane
shifts they and the nearest-neighbour coupling in models/newton.py are
built from.

The system is

    ld[i] * x[i-1] + d[i] * x[i] + ud[i] * x[i+1] = b[i],  i = 0..L-1

with ld[..., 0] == 0 and ud[..., -1] == 0.  ``pcr_solve`` (parallel cyclic
reduction, L a power of two) is the Gauss-Seidel scheme's solver
(models/trpl.newton_iteration); ``thomas_solve`` is the sequential
algorithm for any L.  Each expression keeps the operation order of the JAX
package's ops/tridiag.py, so the two agree to rounding.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def shift_right(x: torch.Tensor, k: int, fill: float = 0.0) -> torch.Tensor:
    """y[..., i] = x[..., i-k] for i >= k else fill (k > 0)."""
    return F.pad(x[..., :-k], (k, 0), value=fill)


def shift_left(x: torch.Tensor, k: int, fill: float = 0.0) -> torch.Tensor:
    """y[..., i] = x[..., i+k] for i < L-k else fill (k > 0)."""
    return F.pad(x[..., k:], (0, k), value=fill)


def pcr_solve(ld, d, ud, b):
    """Parallel cyclic reduction solve; L must be a power of two.

    Each sweep halves the coupling stride; after log2(L) - 1 sweeps the
    system decouples into L/2 independent 2x2 systems (reference:
    pvSimPCR.py:42-81).  Rows i < rf have ld == 0 and rows i >= L - rf
    have ud == 0 by induction, so the update is written unconditionally
    (shifted denominators fill with 1 to stay finite).
    """
    L = ld.shape[-1]
    if L & (L - 1):
        raise ValueError(f"pcr_solve requires power-of-two L, got {L}")
    rf = 1
    while L > 2 * rf:
        k1 = ld / shift_right(d, rf, 1.0)
        k2 = ud / shift_left(d, rf, 1.0)
        d = d - shift_right(ud, rf) * k1 - shift_left(ld, rf) * k2
        b = b - shift_right(b, rf) * k1 - shift_left(b, rf) * k2
        ld, ud = -shift_right(ld, rf) * k1, -shift_left(ud, rf) * k2
        rf *= 2
    # 2x2 solve between rows i and i + rf (reference: pvSimPCR.py:74-79).
    d_lo, d_hi = d[..., :rf], d[..., rf:]
    b_lo, b_hi = b[..., :rf], b[..., rf:]
    ld_hi = ld[..., rf:]
    k = ud[..., :rf] / d_hi
    x_lo = (b_lo - b_hi * k) / (d_lo - ld_hi * k)
    x_hi = (b_hi - ld_hi * x_lo) / d_hi
    return torch.cat([x_lo, x_hi], dim=-1)


def thomas_solve(ld, d, ud, b):
    """Sequential Thomas algorithm along the last axis (any L): a Python
    loop over L with the batch vectorised."""
    L = d.shape[-1]
    cp_prev = dp_prev = torch.zeros_like(d[..., 0])
    cps, dps = [], []
    for i in range(L):
        denom = d[..., i] - ld[..., i] * cp_prev
        cp_prev = ud[..., i] / denom
        dp_prev = (b[..., i] - ld[..., i] * dp_prev) / denom
        cps.append(cp_prev)
        dps.append(dp_prev)
    x = [None] * L
    x_next = torch.zeros_like(d[..., 0])
    for i in reversed(range(L)):
        x_next = dps[i] - cps[i] * x_next
        x[i] = x_next
    return torch.stack(x, dim=-1)


def tridiag_matvec(ld, d, ud, x):
    return ld * shift_right(x, 1) + d * x + ud * shift_left(x, 1)


def residual_l1(ld, d, ud, x, b):
    """Relative L1 residual ||A x - b||_1 / ||b||_1 along the last axis: the
    convergence metric of the reference's ``norm2`` kernel (reference:
    pvSimPCR.py:14-40)."""
    ax = tridiag_matvec(ld, d, ud, x)
    return (ax - b).abs().sum(-1) / b.abs().sum(-1)
