"""Core numerics of the PyTorch port against the JAX package, on the same
inputs made with numpy: TRPL terms, lane shifts, the block PCR solver,
coupled Newton, and the coupled-Newton ``solve`` with the fused likelihood.

Tolerances: float64 agrees to ~1e-12 relative (the same expression order;
only reduction order differs).  float32 solves agree to 2e-5 relative on
the likelihood sums: every rounding difference (XLA's vs PyTorch's
reductions) is carried through a 100-step trajectory accepted at tol 1e-4.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import sample_mat_par
from bayesian_inference_trpl_tpu import physics
from bayesian_inference_trpl_tpu.models import newton as jn
from bayesian_inference_trpl_tpu.models import solver as jsol
from bayesian_inference_trpl_tpu.models import trpl as jt
from bayesian_inference_trpl_tpu.models.driver import (
    SimParams, initial_excess_density, pl_log_scale)
from bayesian_inference_trpl_tpu.ops import block_tridiag as jbt
from bayesian_inference_trpl_tpu.ops import tridiag as jtri
from bayesian_inference_trpl_tpu_torch.models import newton as tn
from bayesian_inference_trpl_tpu_torch.models import solver as tsol
from bayesian_inference_trpl_tpu_torch.models import trpl as tt
from bayesian_inference_trpl_tpu_torch.ops import block_tridiag as tbt
from bayesian_inference_trpl_tpu_torch.ops import horizon_kernel as thk
from bayesian_inference_trpl_tpu_torch.ops import tridiag as ttri

torch.set_num_threads(1)
RTOL = 1e-12


@pytest.fixture(scope="module")
def state():
    """(8, 128) nondimensional states one BDF1 step into a transient."""
    rng = np.random.default_rng(7)
    B, T = 8, 80
    sim = SimParams(length=311.0, time=2000.0 * T / 80000, L=128, T=T)
    mat = physics.nondimensionalize(sample_mat_par(rng, B), sim.dx, sim.dt)
    dn = np.asarray(initial_excess_density(sim, (1e18 / 1e7 ** 3, 100.0), "exp"))
    N = mat[:, :1] + dn[None] * rng.uniform(0.9, 1.1, (B, 128))
    P = mat[:, 1:2] + dn[None] * rng.uniform(0.9, 1.1, (B, 128))
    bN = -(mat[:, :1] + dn[None])
    bP = -(mat[:, 1:2] + dn[None])
    bE = rng.uniform(-1e-3, 1e-3, (B, 128))
    return mat, N, P, bN, bP, bE


def _both(mat, *xs):
    mpj = jt.MatParams.from_array(jnp.asarray(mat))
    mpt = tt.MatParams.from_array(torch.as_tensor(mat))
    return (mpj, *(jnp.asarray(x) for x in xs)), (mpt, *(torch.as_tensor(x) for x in xs))


def _close(t, j, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(t.numpy() if isinstance(t, torch.Tensor) else t,
                               np.asarray(j), rtol=rtol, atol=atol)


def test_shifts_match_jax(state):
    x = state[1]
    for k in (1, 3, 64):
        for fill in (0.0, 1.0):
            _close(ttri.shift_left(torch.as_tensor(x), k, fill),
                   jtri.shift_left(jnp.asarray(x), k, fill), rtol=0)
            _close(ttri.shift_right(torch.as_tensor(x), k, fill),
                   jtri.shift_right(jnp.asarray(x), k, fill), rtol=0)


def test_trpl_terms_match_jax(state):
    mat, N, P, bN, bP, bE = state
    (mpj, Nj, Pj, bEj), (mpt, Nt, Pt, bEt) = _both(mat, N, P, bE)
    _close(tt.recombination(Nt, Pt, mpt), jt.recombination(Nj, Pj, mpj))
    _close(tt.update_e(Nt, Pt, bEt, mpt, 1.5), jt.update_e(Nj, Pj, bEj, mpj, 1.5),
           atol=1e-300)


def test_residuals_and_jacobian_match_jax(state):
    mat, N, P, bN, bP, bE = state
    (mpj, *aj), (mpt, *at) = _both(mat, N, P, bN, bP, bE)
    (Fj, errj) = jn.residuals_and_errors(*aj, mpj, 1.0)
    (Ft, errt) = tn.residuals_and_errors(*at, mpt, 1.0)
    for a, b in zip(Ft + errt, Fj + errj):
        _close(a, b, atol=1e-14 * float(np.abs(np.asarray(b)).max()))
    (Fj2, ABCj, _) = jn.residuals_and_jacobian(*aj, mpj, 1.0)
    (Ft2, ABCt) = tn.residuals_and_jacobian(*at, mpt, 1.0)
    for blk_t, blk_j in zip(ABCt, ABCj):
        for a, b in zip(blk_t, blk_j):
            _close(a, b, atol=1e-14 * float(np.abs(np.asarray(b)).max()))


def test_block_pcr_matches_jax(state):
    """Reduce (the chord cache) and apply against JAX, and the solve
    against a dense solve of the same block system."""
    mat, N, P, bN, bP, bE = state
    (mpj, *aj), (mpt, *at) = _both(mat, N, P, bN, bP, bE)
    _, (Aj, Bj, Cj), _ = jn.residuals_and_jacobian(*aj, mpj, 1.0)
    _, (At, Bt, Ct) = tn.residuals_and_jacobian(*at, mpt, 1.0)
    rng = np.random.default_rng(1)
    r = rng.standard_normal((2, 8, 128))
    cache_j = jbt.block_pcr_reduce(Aj, Bj, Cj)
    cache_t = tbt.block_pcr_reduce(At, Bt, Ct)
    for leaf_t, leaf_j in zip(_leaves(cache_t), _leaves(cache_j)):
        _close(leaf_t, leaf_j, atol=1e-12 * float(np.abs(np.asarray(leaf_j)).max()))
    xt = tbt.block_pcr_apply(cache_t, (torch.as_tensor(r[0]), torch.as_tensor(r[1])))
    xj = jbt.block_pcr_apply(cache_j, (jnp.asarray(r[0]), jnp.asarray(r[1])))
    for a, b in zip(xt, xj):
        _close(a, b, rtol=1e-10, atol=1e-12 * float(np.abs(np.asarray(b)).max()))
    y = tbt.block_matvec(At, Bt, Ct, xt)
    np.testing.assert_allclose(y[0].numpy(), r[0], atol=1e-9)
    np.testing.assert_allclose(y[1].numpy(), r[1], atol=1e-9)


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [leaf for item in x for leaf in _leaves(item)]
    return [x]


def test_coupled_newton_step_matches_jax(state):
    max_iters = 8
    mat, N, P, bN, bP, bE = state
    (mpj, *aj), (mpt, *at) = _both(mat, N, P, bN, bP, bE)
    Nj, Pj, Ej, itj, okj = jn.coupled_newton_step(
        aj[0], aj[1], jnp.zeros_like(aj[0]), *aj[2:], mpj, 1.0, 1e-8,
        max_iters, step_tol=1e-9)
    Nt, Pt, Et, itt, okt = tn.coupled_newton_step(
        *at, mpt, torch.tensor(1.0, dtype=torch.float64),
        torch.tensor(1e-8, dtype=torch.float64), max_iters,
        step_tol=torch.tensor(1e-9, dtype=torch.float64))
    np.testing.assert_array_equal(itt.numpy(), np.asarray(itj))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    _close(Nt, Nj, rtol=1e-10)
    _close(Pt, Pj, rtol=1e-10)
    _close(Et, Ej, rtol=1e-8, atol=1e-10 * float(np.abs(np.asarray(Ej)).max()))


def _solve_problem(T, batch, seed=3):
    rng = np.random.default_rng(seed)
    sim = SimParams(length=311.0, time=2000.0 * T / 80000, L=128, T=T)
    mat = physics.nondimensionalize(sample_mat_par(rng, batch), sim.dx, sim.dt)
    dn = np.asarray(initial_excess_density(sim, (1e18 / 1e7 ** 3, 100.0), "exp"))
    n0 = mat[:, 0:1] + dn[None]
    p0 = mat[:, 1:2] + dn[None]
    vals = rng.uniform(-4.0, -2.0, (2, T + 1))
    mask = np.ones((2, T + 1))
    mask[1, T - 11:] = 0.0
    return mat, n0, p0, vals, mask, pl_log_scale(sim)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_solve_coupled_newton_matches_jax(dtype):
    """solve(method="coupled_newton") with the fused, masked likelihood."""
    T, B = 100, 4
    mat, n0, p0, vals, mask, log_scale = _solve_problem(T, B)
    tol = 1e-8 if dtype == "float64" else 1e-4
    cfg = jsol.SolverConfig(num_steps=T, tol=tol, max_iters=20, step_tol=1e-6,
                            method="coupled_newton", predictor="quadratic")
    jd = jnp.dtype(dtype)
    obs_j = jsol.FusedObs(values=jnp.asarray(vals, jd),
                          log_scale=jnp.asarray(log_scale, jd),
                          min_val=1e-300, mask=jnp.asarray(mask, jd))
    rj = jsol.solve(jnp.asarray(mat, jd), jnp.asarray(n0, jd), jnp.asarray(p0, jd),
                    jnp.zeros((B, 128), jd), cfg, obs=obs_j, record_pl=False)
    mt, n0t, p0t, e0t, obs_t, cfg_t, _ = thk.from_jax_inputs(
        mat, n0, p0, np.zeros_like(n0), vals, log_scale, 1e-300, mask=mask,
        cfg=cfg, dtype=getattr(torch, dtype))
    rt = tsol.solve(mt, n0t, p0t, e0t, cfg_t, obs=obs_t, record_pl=False)
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    rtol = 1e-10 if dtype == "float64" else 2e-5
    _close(rt.sse, rj.sse, rtol=rtol)
    _close(rt.err_sum, rj.err_sum, rtol=rtol, atol=rtol)
    if dtype == "float64":
        np.testing.assert_array_equal(rt.sample_iters.numpy(),
                                      np.asarray(rj.sample_iters))
        _close(rt.n, rj.n, rtol=1e-10)
