"""Host-side parameter-space sampler (numpy).

A copy of the JAX package's ``random_grid`` / ``apply_overrides`` /
``make_grid`` (reference: bayeslib.py:18-76): per-dimension sequential
draws from one RNG stream, pinned dimensions (min == max), log10-uniform
dimensions, and the equality overrides mu_n = mu_p, S_b = S_f, C_p = C_n.
At the same seed the sample matrix is bitwise equal to the JAX package's.
"""
from __future__ import annotations

import numpy as np

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
    (reference: bayeslib.py:34-76).

    Returns (N, P, X): sample indices, (num_exp, n) zero likelihoods, and
    the (n, 13) sample matrix.
    """
    if not sim_flags.get("random_sample", True):
        raise NotImplementedError(
            "random_sample = false (the legacy coarse-grid sampler) is not "
            "ported yet: ROADMAP A13")
    n = int(sim_flags["num_points"])
    X = random_grid(min_x, max_x, do_log, n, rng=rng)
    X = apply_overrides(X, sim_flags)
    P = np.zeros((num_exp, n))
    return np.arange(n), P, X
