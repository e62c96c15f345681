"""One coarse rung of the stride ladder: the horizon kernel's plain PyTorch
version against the JAX Pallas kernel (interpret mode) in the
self-normalized, masked configuration (the external run-t=0 PL anchor
scaled to the coarse dt), stride 16, float64, group = batch (the JAX tile).
Also the CPU dispatch of the kernel wrapper and its approx_inv flag."""
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
from bayesian_inference_trpl_tpu.ops.pallas import horizon_kernel as jhk
from bayesian_inference_trpl_tpu_torch.models.solver import pl_observable
from bayesian_inference_trpl_tpu_torch.models.trpl import MatParams
from bayesian_inference_trpl_tpu_torch.ops import horizon_kernel as thk

torch.set_num_threads(1)

B, T1, S, C = 4, 24, 16, 24
T = T1 + S * C


@pytest.fixture(scope="module")
def phase_start():
    """Inputs of a stride-16 rung that starts after a 24-step fine phase
    (run here with the port's plain version; both sides get its state).
    C = 24 coarse steps is one whole JAX time block, so the JAX kernel runs
    no padding steps and its refresh count is comparable."""
    rng = np.random.default_rng(11)
    sim = SimParams(length=311.0, time=2000.0 * T / 80000, L=128, T=T)
    mat = np.asarray(physics.nondimensionalize(sample_mat_par(rng, B), sim.dx, sim.dt))
    dn = np.asarray(initial_excess_density(sim, (1e18 / 1e7 ** 3, 100.0), "exp"))
    n0 = mat[:, 0:1] + dn[None]
    p0 = mat[:, 1:2] + dn[None]
    vals = rng.uniform(-4.0, -2.0, (2, T + 1))
    vals = vals - vals[:, :1]
    mask = np.ones((2, T + 1))
    mask[:, -40:] = 0.0
    cfg = SolverConfig(num_steps=T, tol=1e-8, max_iters=8, step_tol=1e-6,
                       method="fused_horizon_chord", predictor="quadratic",
                       chord_strict=True)
    mt, n0t, p0t, e0t, obs_t, cfg_t, _ = thk.from_jax_inputs(
        mat, n0, p0, np.zeros_like(n0), vals, pl_log_scale(sim), 1e-12,
        normalize=True, mask=mask, cfg=cfg)
    r1 = thk.solve_horizon_fused(
        mt, n0t, p0t, cfg_t._replace(num_steps=T1),
        obs_t._replace(values=obs_t.values[:, :T1 + 1], mask=obs_t.mask[:, :T1 + 1]),
        e_init=e0t, kernel=functools.partial(thk.horizon_chord_plain, group=B))
    pl0 = pl_observable(n0t, p0t, MatParams.from_array(mt))
    return (mat, vals, mask, pl_log_scale(sim), cfg, cfg_t, obs_t, mt,
            r1.n.numpy(), r1.p.numpy(), r1.e.numpy(), pl0.numpy())


def test_coarse_normalized_masked_matches_pallas(phase_start):
    (mat, vals, mask, log_scale, cfg, cfg_t, obs_t, mt, n, p, e,
     pl0) = phase_start
    obs_j = FusedObs(values=jnp.asarray(vals), log_scale=jnp.asarray(log_scale),
                     min_val=1e-12, normalize=True, mask=jnp.asarray(mask))
    rj = jhk.solve_coarse_phase_fused(
        jnp.asarray(mat), jnp.asarray(n), jnp.asarray(p), jnp.asarray(e), cfg,
        obs_j, jnp.asarray(pl0), T1, S * C, S, chord=True, interpret=True)
    rt = thk.solve_coarse_phase_fused(
        mt, torch.as_tensor(n), torch.as_tensor(p), torch.as_tensor(e), cfg_t,
        obs_t, torch.as_tensor(pl0), T1, S * C, S,
        kernel=functools.partial(thk.horizon_chord_plain, group=B))
    np.testing.assert_allclose(rt.sse.numpy(), np.asarray(rj.sse), rtol=1e-9)
    np.testing.assert_allclose(rt.err_sum.numpy(), np.asarray(rj.err_sum),
                               rtol=1e-9, atol=1e-12)
    for name in ("converged", "sample_iters", "full_solves", "tile_body_iters"):
        np.testing.assert_array_equal(getattr(rt, name).numpy(),
                                      np.asarray(getattr(rj, name)), err_msg=name)
    np.testing.assert_allclose(rt.n.numpy(), np.asarray(rj.n), rtol=1e-9)


def test_wrapper_runs_plain_group1_on_cpu(phase_start):
    """On CPU tensors the wrapper is the plain version with group=1 (the
    CUDA kernel's per-sample decisions) and launches nothing; approx_inv
    (fast reciprocal + one Newton refinement) stays within rounding of
    exact division in float64."""
    (_, _, _, _, _, cfg_t, obs_t, mt, n, p, e, pl0) = phase_start
    args = [mt, torch.as_tensor(n), torch.as_tensor(p), torch.as_tensor(e),
            cfg_t, obs_t, torch.as_tensor(pl0), T1, S * C, S]
    before = dict(thk.launches)
    r = thk.solve_coarse_phase_fused(*args)
    assert thk.launches == before
    r1 = thk.solve_coarse_phase_fused(
        *args, kernel=functools.partial(thk.horizon_chord_plain, group=1))
    for name in ("sse", "err_sum", "n", "full_solves", "sample_iters"):
        np.testing.assert_array_equal(getattr(r, name).numpy(),
                                      getattr(r1, name).numpy())
    ra = thk.solve_coarse_phase_fused(
        *args, kernel=lambda *a: thk.horizon_chord_plain(
            *a[:-1], a[-1]._replace(approx_inv=True), group=1))
    np.testing.assert_allclose(ra.sse.numpy(), r.sse.numpy(), rtol=1e-11)
    np.testing.assert_array_equal(ra.full_solves.numpy(), r.full_solves.numpy())
