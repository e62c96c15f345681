"""Parameter-space samplers.

A copy of the JAX package's host samplers ``random_grid`` /
``apply_overrides`` / ``make_grid`` (reference: bayeslib.py:18-76):
per-dimension sequential draws from one RNG stream, pinned dimensions
(min == max), log10-uniform dimensions, and the equality overrides mu_n =
mu_p, S_b = S_f, C_p = C_n; and of its legacy coarse-grid sampler
(``index_grid`` / ``param_grid`` / ``refine_grid``), which ``make_grid``
takes with ``random_sample = false``.  At the same inputs the sample
matrix is bitwise equal to the JAX package's.

``random_grid_device`` is the device sampler (the JAX package's
``jax.random`` one): the same box semantics, drawn on the device of a
``torch.Generator``.  Its streams are torch's, so it equals the JAX
sampler in distribution, not draw for draw.
"""
from __future__ import annotations

import numpy as np
import torch

# Parameter-column contract (physics.PARAM_NAMES): equality overrides by index.
IDX_MUN, IDX_MUP = 2, 3
IDX_SF, IDX_SB = 5, 6
IDX_CN, IDX_CP = 7, 8


def random_grid(min_x, max_x, do_log, num_points: int, rng=None) -> np.ndarray:
    """Draw num_points samples from the box [min_x, max_x] on the host."""
    if rng is None:
        rng = np.random.RandomState(42)  # reference stream (parallel_bayes_gpu.py:35)
    min_x, max_x = np.asarray(min_x, float), np.asarray(max_x, float)
    grid = np.empty((num_points, len(min_x)))
    for i in range(len(min_x)):
        if min_x[i] == max_x[i]:
            grid[:, i] = min_x[i]
        elif do_log[i]:
            grid[:, i] = 10 ** rng.uniform(np.log10(min_x[i]), np.log10(max_x[i]),
                                           num_points)
        else:
            grid[:, i] = rng.uniform(min_x[i], max_x[i], num_points)
    return grid


def random_grid_device(generator: torch.Generator, min_x, max_x, do_log,
                       num_points: int, dtype=torch.float64) -> torch.Tensor:
    """Draw num_points samples from the box [min_x, max_x] on the
    generator's device: one uniform draw per sample and dimension,
    log10-uniform on ``do_log`` dimensions (a zero bound there is taken as
    1 in the logarithm, as the JAX sampler's guard does), linear
    elsewhere, and pinned dimensions (min == max) exactly their bound."""
    dev = generator.device
    min_x = torch.as_tensor(np.asarray(min_x, float), dtype=dtype, device=dev)
    max_x = torch.as_tensor(np.asarray(max_x, float), dtype=dtype, device=dev)
    do_log = torch.as_tensor(np.asarray(do_log, bool), device=dev)
    u = torch.rand((num_points, min_x.shape[0]), generator=generator, dtype=dtype,
                   device=dev)
    lo = torch.where(min_x > 0, min_x, 1.0).log10()
    hi = torch.where(max_x > 0, max_x, 1.0).log10()
    log_draw = 10.0 ** (lo + u * (hi - lo))
    lin_draw = min_x + u * (max_x - min_x)
    draw = torch.where(do_log, log_draw, lin_draw)
    return torch.where(min_x == max_x, min_x, draw)


def apply_overrides(X: np.ndarray, sim_flags: dict) -> np.ndarray:
    """Equality-constraint overrides (reference: bayeslib.py:68-75), in place."""
    if sim_flags.get("override_equal_mu"):
        X[:, IDX_MUN] = X[:, IDX_MUP]
    if sim_flags.get("override_equal_s"):
        X[:, IDX_SB] = X[:, IDX_SF]
    if sim_flags.get("override_equal_auger"):
        X[:, IDX_CP] = X[:, IDX_CN]
    return X


def make_grid(num_exp: int, min_x, max_x, do_log, sim_flags: dict, rng=None):
    """Build the sampling grid and empty likelihood table
    (reference: bayeslib.py:34-76).  ``random_sample = false`` takes the
    legacy coarse grid: ``num_points`` cells along every free dimension
    and one along each pinned one, at the cell centres.

    Returns (N, P, X): sample indices, (num_exp, n) zero likelihoods, and
    the (n, 13) sample matrix.
    """
    if sim_flags.get("random_sample", True):
        n = int(sim_flags["num_points"])
        X = random_grid(min_x, max_x, do_log, n, rng=rng)
    else:
        refs = [np.array([sim_flags["num_points"] if min_x[i] != max_x[i] else 1
                          for i in range(len(min_x))])]
        N0 = refine_grid(np.array([0]), refs[0])
        ind = index_grid(N0, refs)
        X = param_grid(ind, refs, np.asarray(min_x, float),
                       np.asarray(max_x, float), np.asarray(do_log))
        n = len(X)
    X = apply_overrides(X, sim_flags)
    P = np.zeros((num_exp, n))
    return np.arange(n), P, X


# --- Legacy coarse-grid sampler (reference: Legacy/legacy.py:11-37) ---------

def index_grid(N, refs):
    """Flat cell ids -> per-dimension grid coordinates.

    ``refine_grid`` encodes a cell id as a mixed-radix number whose digits
    are, from least significant, the per-dimension sub-indices of each
    refinement level (latest level in the low digits, dimensions minor
    within a level).  The coordinate of a cell along dimension m is the
    level digits for m weighted by the resolution of all finer levels
    along m.
    """
    N = np.asarray(N)
    refs = np.asarray(refs, dtype=int)            # (K levels, M dims)
    K, M = refs.shape
    radices = refs[::-1].reshape(-1)              # innermost level first
    place = np.concatenate(([1], np.cumprod(radices[:-1])))
    digits = (N[:, None] // place[None, :]) % radices[None, :]
    digits = digits.reshape(len(N), K, M)         # (n, level, dim)
    # Weight of level k's digit along dim m = prod of finer levels' radix.
    weight = np.concatenate(
        [np.ones((1, M), dtype=int), np.cumprod(refs[::-1], axis=0)[:-1]])
    return np.einsum("nkm,km->nm", digits, weight)


def param_grid(ind, refs, min_x, max_x, do_log):
    """Grid coordinates -> cell-centre parameter values; log-spaced
    dimensions interpolate geometrically (a log dimension with a zero
    lower bound collapses to 0, as the reference's nan_to_num did)."""
    frac = (ind + 0.5) / np.prod(refs, axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        x_log = np.nan_to_num(min_x * (max_x / min_x) ** frac)
    x_lin = min_x + (max_x - min_x) * frac
    return np.where(do_log, x_log, x_lin)


def refine_grid(N, ref):
    """Split each cell id into ``prod(ref)`` consecutive subcell ids: cell
    n maps to n*siz .. n*siz+siz-1, ordered cell-major."""
    siz = int(np.prod(ref))
    return (np.asarray(N)[:, None] * siz + np.arange(siz)[None, :]).ravel()
