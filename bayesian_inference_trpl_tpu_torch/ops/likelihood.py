"""Log-likelihood from the fused running sums.

The reference splits this across three GPU round trips (probs.py:20-85,
bayeslib.py:157-201).  Here the solver accumulates sse = sum w e^2 and
esum = sum w e inside its time loop, and the per-sample magnitude offset m
enters in closed form:

    sum_i w_i (e_i + m)^2 = sse + 2 m esum + n m^2,   n = sum_i w_i
"""
from __future__ import annotations

import sys

import numpy as np
import torch

FLOAT_MIN = sys.float_info.min


def fastlog(pl: torch.Tensor, min_val: float = FLOAT_MIN) -> torch.Tensor:
    """Clamp-to-min then log10 (reference: probs.py:64-85); the floor stays
    strictly positive in the input's dtype."""
    floor = max(float(torch.tensor(min_val, dtype=pl.dtype)),
                torch.finfo(pl.dtype).tiny)
    return torch.log10(torch.clamp_min(pl, floor))


def interp_pl(sim_times: torch.Tensor, pl: torch.Tensor,
              obs_times: torch.Tensor) -> torch.Tensor:
    """Linear time interpolation of simulated PL (batch, n) at the nodes
    ``sim_times`` (n,) onto ``obs_times`` (M,), batched: (batch, M).
    Times before the first node or after the last give NaN, as scipy
    ``griddata`` does (reference: bayeslib.py:182-191).  The arithmetic is
    ``jnp.interp``'s, which the JAX package calls: i = clip(searchsorted(
    right), 1, n - 1), f = fp[i-1] + (x - xp[i-1]) / dx * df, and fp[i-1]
    where dx is within spacing(eps) of 0."""
    n = sim_times.shape[0]
    i = torch.searchsorted(sim_times, obs_times, right=True).clamp(1, n - 1)
    x0 = sim_times[i - 1]
    dx = sim_times[i] - x0
    delta = obs_times - x0
    f0 = pl[:, i - 1]
    df = pl[:, i] - f0
    eps = np.spacing(torch.finfo(sim_times.dtype).eps)
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, f0, f0 + (delta / torch.where(dx0, 1.0, dx)) * df)
    out = (obs_times < sim_times[0]) | (obs_times > sim_times[-1])
    return torch.where(out, torch.nan, f)


def sse_terms(pl_log: torch.Tensor, values: torch.Tensor):
    """(sse, esum): (batch,) sums of e^2 and e with e = pl_log - values."""
    e = pl_log - values[None, :]
    return (e * e).sum(-1), e.sum(-1)


def log_likelihood_from_terms(sse, esum, n_obs, mag_offset):
    """-(sum (e + m)^2) given running sums (exact closed form in m)."""
    return -(sse + 2.0 * mag_offset * esum + n_obs * mag_offset ** 2)


def log_likelihood(pl_log, values, mag_offset):
    """Direct SSE likelihood: P[j] = -sum_i (pl_log[j,i] + m[j] - values[i])^2
    (reference: probs.py:20-47)."""
    sse, esum = sse_terms(pl_log, values)
    return log_likelihood_from_terms(sse, esum, pl_log.shape[-1], mag_offset)
