"""The horizon kernel's plain PyTorch version against the JAX Pallas
kernel (Mosaic interpret mode, as tests/test_horizon.py and
tests/test_twophase.py run it), on the same float64 inputs.

The JAX kernel takes its three chord decisions (skip, loop exit, Jacobian
refresh) over its whole sample tile, which at these sizes is the batch, so
the plain version runs with ``group`` = batch.  Agreement is to rounding:
sse and err_sum within 1e-9 relative, convergence flags, Newton iteration
counts and Jacobian refreshes equal.

Both tests share one fine-phase program (same shapes and static
arguments), and the two coarse rungs share another, to bound the interpret
mode's compile time.
"""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import sample_mat_par
from bayesian_inference_trpl_tpu import physics
from bayesian_inference_trpl_tpu.models.driver import (
    SimParams, initial_excess_density, pl_log_scale)
from bayesian_inference_trpl_tpu.models.solver import FusedObs, SolverConfig
from bayesian_inference_trpl_tpu.models.twophase import solve_multiphase
from bayesian_inference_trpl_tpu.ops.pallas import horizon_kernel as jhk
from bayesian_inference_trpl_tpu_torch.models import twophase as ttwo
from bayesian_inference_trpl_tpu_torch.ops import horizon_kernel as thk

torch.set_num_threads(1)

B, T1 = 4, 36
SCHEDULE = ((1, T1), (8, 64), (8, 64))
T = sum(n for _, n in SCHEDULE)
RTOL = 1e-9


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(3)
    sim = SimParams(length=311.0, time=2000.0 * T / 80000, L=128, T=T)
    mat = np.asarray(physics.nondimensionalize(sample_mat_par(rng, B), sim.dx, sim.dt))
    dn = np.asarray(initial_excess_density(sim, (1e18 / 1e7 ** 3, 100.0), "exp"))
    n0 = mat[:, 0:1] + dn[None]
    p0 = mat[:, 1:2] + dn[None]
    vals = rng.uniform(-4.0, -2.0, (2, T + 1))
    # Bucket-style padding: the second curve ends early, and the last 10
    # fine points carry no weight at all (padding-only steps).
    mask = np.ones((2, T + 1))
    mask[1, T - 40:] = 0.0
    mask[:, T - 9:] = 0.0
    cfg = SolverConfig(num_steps=T, tol=1e-8, max_iters=8, step_tol=1e-6,
                       method="fused_horizon_chord", predictor="quadratic",
                       chord_strict=True)
    return mat, n0, p0, vals, mask, pl_log_scale(sim), cfg


def _jax_obs(vals, mask, log_scale):
    return FusedObs(values=jnp.asarray(vals), log_scale=jnp.asarray(log_scale),
                    min_val=1e-300, mask=jnp.asarray(mask))


def _check(rt, rj, state=True):
    np.testing.assert_allclose(rt.sse.numpy(), np.asarray(rj.sse), rtol=RTOL)
    np.testing.assert_allclose(rt.err_sum.numpy(), np.asarray(rj.err_sum),
                               rtol=RTOL, atol=1e-12)
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    np.testing.assert_array_equal(rt.sample_iters.numpy(),
                                  np.asarray(rj.sample_iters))
    if state:
        for a, b in ((rt.n, rj.n), (rt.p, rj.p), (rt.e, rj.e)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                       atol=1e-12)


def test_stride1_plain_matches_pallas(problem, monkeypatch):
    """Fine phase: solve_horizon_fused(chord=True), tb=12, T=36, batch 4."""
    monkeypatch.setattr(jhk, "TIME_BLOCK", 12)
    mat, n0, p0, vals, mask, log_scale, cfg = problem
    cfg1 = cfg._replace(num_steps=T1)
    obs1 = _jax_obs(vals[:, :T1 + 1], mask[:, :T1 + 1], log_scale)
    e0 = np.zeros_like(n0)
    rj = jhk.solve_horizon_fused(jnp.asarray(mat), jnp.asarray(n0), jnp.asarray(p0),
                                 cfg1, obs1, tb=12, chord=True, interpret=True,
                                 e_init=jnp.asarray(e0))
    mt, n0t, p0t, e0t, obs_t, cfg_t, _ = thk.from_jax_inputs(
        mat, n0, p0, e0, obs1.values, log_scale, 1e-300, mask=obs1.mask, cfg=cfg1)
    rt = thk.solve_horizon_fused(
        mt, n0t, p0t, cfg_t, obs_t, e_init=e0t,
        kernel=functools.partial(thk.horizon_chord_plain, group=B))
    _check(rt, rj)
    np.testing.assert_array_equal(rt.full_solves.numpy(), np.asarray(rj.full_solves))
    np.testing.assert_array_equal(rt.tile_body_iters.numpy(),
                                  np.asarray(rj.tile_body_iters))
    assert int(rt.full_solves[0]) >= 1


def test_multiphase_plain_matches_pallas(problem, monkeypatch):
    """solve_multiphase(method="fused_horizon_chord"): the fine phase and
    two stride-8 rungs, masked, each phase one kernel call."""
    monkeypatch.setattr(jhk, "TIME_BLOCK", 12)
    mat, n0, p0, vals, mask, log_scale, cfg = problem
    e0 = np.zeros_like(n0)
    rj = solve_multiphase(jnp.asarray(mat), jnp.asarray(n0), jnp.asarray(p0),
                          jnp.asarray(e0), cfg, _jax_obs(vals, mask, log_scale),
                          SCHEDULE)
    mt, n0t, p0t, e0t, obs_t, cfg_t, sched = thk.from_jax_inputs(
        mat, n0, p0, e0, vals, log_scale, 1e-300, mask=mask, cfg=cfg,
        schedule=SCHEDULE)
    rt = ttwo.solve_multiphase(
        mt, n0t, p0t, e0t, cfg_t, obs_t, sched,
        kernel=functools.partial(thk.horizon_chord_plain, group=B))
    _check(rt, rj)
    assert rt.converged.all()
