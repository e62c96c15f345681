"""The horizon kernel's plain PyTorch version against the JAX Pallas kernel
(Mosaic interpret mode) under the throughput chord profile
(``chord_strict=False``, the exact fixed-dt mode's profile) with the
geometric predictor, on the same float64 inputs.

The fast path's ladder always runs the strict profile, so this is the only
test of the throughput profile's chord decisions (settle acceptance,
CHORD_SKIP_TIGHTEN, CHORD_STALL) and of the geometric predictor against the
JAX kernel.  One single-phase launch, T = 108 fine steps (a multiple of the
12-step time block, so no step is padded) and batch 8: the JAX kernel's
tile is then the batch, so the plain version runs with ``group`` = 8.
Agreement is to rounding: sse and err_sum within 1e-9 relative; convergence
flags, Newton updates, Jacobian refreshes and executed iterations equal.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import sample_mat_par
from bayesian_inference_trpl_tpu import physics
from bayesian_inference_trpl_tpu.models.driver import (
    SimParams, initial_excess_density, pl_log_scale)
from bayesian_inference_trpl_tpu.models.solver import FusedObs, SolverConfig
from bayesian_inference_trpl_tpu.ops.pallas import horizon_kernel as jhk
from bayesian_inference_trpl_tpu_torch.ops import horizon_kernel as thk

torch.set_num_threads(1)

B, T = 8, 108
RTOL = 1e-9


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(11)
    sim = SimParams(length=311.0, time=2000.0 * T / 80000, L=128, T=T)
    mat = np.asarray(physics.nondimensionalize(sample_mat_par(rng, B), sim.dx, sim.dt))
    dn = np.asarray(initial_excess_density(sim, (1e18 / 1e7 ** 3, 100.0), "exp"))
    n0 = mat[:, 0:1] + dn[None]
    p0 = mat[:, 1:2] + dn[None]
    vals = rng.uniform(-4.0, -2.0, (2, T + 1))
    cfg = SolverConfig(num_steps=T, tol=1e-8, max_iters=8, step_tol=1e-6,
                       method="fused_horizon_chord", predictor="geometric",
                       chord_strict=False)
    return mat, n0, p0, vals, pl_log_scale(sim), cfg


def test_throughput_geometric_plain_matches_pallas(problem, monkeypatch):
    """solve_horizon_fused(chord=True) under the throughput profile with the
    geometric predictor: the plain version at group = the JAX tile (8)
    against the Pallas kernel; and the profile really differs from the
    strict one on these inputs."""
    monkeypatch.setattr(jhk, "TIME_BLOCK", 12)
    mat, n0, p0, vals, log_scale, cfg = problem
    e0 = np.zeros_like(n0)
    obs = FusedObs(values=jnp.asarray(vals), log_scale=jnp.asarray(log_scale),
                   min_val=1e-300)
    rj = jhk.solve_horizon_fused(jnp.asarray(mat), jnp.asarray(n0), jnp.asarray(p0),
                                 cfg, obs, tb=12, chord=True, interpret=True,
                                 e_init=jnp.asarray(e0))
    mt, n0t, p0t, e0t, obs_t, cfg_t, _ = thk.from_jax_inputs(
        mat, n0, p0, e0, vals, log_scale, 1e-300, cfg=cfg)
    prm = thk._params(cfg_t, obs_t, 1, log_scale)
    assert (prm.pred_order, prm.settle_guard, prm.skip_tighten, prm.stall) == (
        thk.PRED_ORDER["geometric"], thk.CHORD_SETTLE_GUARD, thk.CHORD_SKIP_TIGHTEN,
        thk.CHORD_STALL)
    plain = functools.partial(thk.horizon_chord_plain, group=B)
    rt = thk.solve_horizon_fused(mt, n0t, p0t, cfg_t, obs_t, e_init=e0t, kernel=plain)

    np.testing.assert_allclose(rt.sse.numpy(), np.asarray(rj.sse), rtol=RTOL)
    np.testing.assert_allclose(rt.err_sum.numpy(), np.asarray(rj.err_sum),
                               rtol=RTOL, atol=1e-12)
    for a, b in ((rt.converged, rj.converged), (rt.sample_iters, rj.sample_iters),
                 (rt.full_solves, rj.full_solves),
                 (rt.tile_body_iters, rj.tile_body_iters)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in ((rt.n, rj.n), (rt.p, rj.p), (rt.e, rj.e)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9, atol=1e-12)
    assert rt.converged.all()

    strict = thk.solve_horizon_fused(mt, n0t, p0t, cfg_t._replace(chord_strict=True),
                                     obs_t, e_init=e0t, kernel=plain)
    assert not torch.equal(strict.sample_iters, rt.sample_iters)
