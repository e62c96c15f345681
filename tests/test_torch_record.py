"""The record route: ``solve(record_pl=True)`` of a fused method, which the
port runs as one launch of its horizon kernel's full-Newton stride-1 body
recording the PL trace (ops/horizon_kernel.solve_horizon_record; on the
CPU the kernel's plain version), against the JAX package's
``solve(record_pl=True, method="fused_horizon_chord")``, which rewrites it
to the coupled_newton XLA scan.

float64, 1e-12 relative: the trace and the final N/P/E (E with a 1e-12
absolute floor), conv and the iteration counts equal, at pl_stride 1 and
4 under the quadratic and the geometric predictor.  The plain version
against the port's own step loop (``coupled_newton``, which carries
pl_stride > 1 and the fused likelihood at the recorded points as JAX's
inner loop does): the Newton trajectory bit for bit.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import sample_mat_par
from bayesian_inference_trpl_tpu import physics
from bayesian_inference_trpl_tpu.models import solver as jsolver
from bayesian_inference_trpl_tpu.models.driver import SimParams, initial_excess_density
from bayesian_inference_trpl_tpu_torch.models import solver as tsolver
from bayesian_inference_trpl_tpu_torch.ops import horizon_kernel as thk

torch.set_num_threads(1)

B, T, L = 6, 48, 32


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(17)
    sim = SimParams(length=311.0, time=2000.0 * T / 80000, L=L, T=T)
    mat = np.asarray(physics.nondimensionalize(sample_mat_par(rng, B), sim.dx, sim.dt))
    dn = np.asarray(initial_excess_density(sim, (1e18 / 1e7 ** 3, 100.0), "exp"))
    return mat, mat[:, 0:1] + dn[None], mat[:, 1:2] + dn[None]


def _cfg(mod, stride, predictor, method):
    return mod.SolverConfig(num_steps=T, pl_stride=stride, tol=1e-8, max_iters=8,
                            step_tol=1e-6, method=method, predictor=predictor)


def _port(problem, stride, predictor, method="fused_horizon_chord", **kw):
    mat, n0, p0 = (torch.as_tensor(a) for a in problem)
    return tsolver.solve(mat, n0, p0, torch.zeros_like(n0),
                         _cfg(tsolver, stride, predictor, method), **kw)


@pytest.mark.parametrize("predictor", ["quadratic", "geometric"])
@pytest.mark.parametrize("stride", [1, 4])
def test_record_matches_jax_scan(problem, stride, predictor):
    calls = []
    orig = thk.horizon_chord_plain

    def spy(*args, **kw):
        calls.append(args[-1])
        return orig(*args, **kw)
    thk.horizon_chord_plain = spy
    try:
        rt = _port(problem, stride, predictor)
    finally:
        thk.horizon_chord_plain = orig
    assert [(p.chord, p.stride, p.pl_stride) for p in calls] == [(False, 1, stride)]
    mat, n0, p0 = (jnp.asarray(a) for a in problem)
    rj = jsolver.solve(mat, n0, p0, jnp.zeros_like(n0),
                       _cfg(jsolver, stride, predictor, "fused_horizon_chord"),
                       record_pl=True)
    assert rt.pl.shape == (B, T // stride + 1) == rj.pl.shape
    np.testing.assert_allclose(rt.pl.numpy(), np.asarray(rj.pl), rtol=1e-12, atol=0)
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    np.testing.assert_array_equal(rt.sample_iters.numpy(), np.asarray(rj.sample_iters))
    assert int(rt.max_newton_iters) == int(rj.max_newton_iters)
    # E = num/denom with num a difference of near-equal fluxes: its small
    # entries carry the rounding of N and P, hence the absolute floor (as
    # tests/test_torch_full_newton.py).
    for name in ("n", "p", "e"):
        np.testing.assert_allclose(getattr(rt, name).numpy(), np.asarray(getattr(rj, name)),
                                   rtol=1e-12, atol=1e-12, err_msg=name)
    assert rt.sse is None and bool(rt.converged.all())


@pytest.mark.parametrize("stride", [1, 4])
def test_record_equals_step_loop(problem, stride):
    """The plain record body is coupled_newton's step loop bit for bit, and
    coupled_newton_pallas's on the CPU."""
    rec = _port(problem, stride, "quadratic")
    for method in ("coupled_newton", "coupled_newton_pallas"):
        loop = _port(problem, stride, "quadratic", method=method)
        for name in ("pl", "n", "p", "e", "converged", "sample_iters",
                     "max_newton_iters"):
            assert torch.equal(getattr(rec, name), getattr(loop, name)), (method, name)


def test_failed_step_fails_sample_without_observations(problem):
    """With no observations nothing is forgiven: a Newton failure at any
    step (here max_iters 1 at a tight tol) fails the sample, in the record
    body as in the step loop."""
    mat, n0, p0 = (torch.as_tensor(a) for a in problem)
    cfg = tsolver.SolverConfig(num_steps=T, pl_stride=4, tol=1e-14, max_iters=1,
                               method="fused_horizon_chord")
    rec = tsolver.solve(mat, n0, p0, torch.zeros_like(n0), cfg)
    loop = tsolver.solve(mat, n0, p0, torch.zeros_like(n0),
                         cfg._replace(method="coupled_newton"))
    assert not bool(rec.converged.any())
    assert torch.equal(rec.converged, loop.converged)
    assert torch.equal(rec.pl, loop.pl)


def test_record_refuses_what_the_kernel_does_not_record(problem):
    mat, n0, p0 = (torch.as_tensor(a) for a in problem)
    prm = thk.HorizonParams(stride=1, tol=1e-8, step_tol=0.0, log_scale=0.0,
                            min_val=0.0, max_iters=8, normalize=False, pred_order=2,
                            settle_guard=0.0, skip_tighten=1.0, stall=0.0,
                            chord=False, pl_stride=5)
    no_obs = torch.zeros((0, T), dtype=torch.float64)
    with pytest.raises(ValueError, match="pl_stride"):      # 48 % 5
        thk.horizon_chord(mat, n0, p0, torch.zeros_like(n0), no_obs, None, None,
                          None, None, prm)
    with pytest.raises(ValueError, match="chord True"):
        thk.horizon_chord(mat, n0, p0, torch.zeros_like(n0), no_obs, None, None,
                          None, None, prm._replace(chord=True, pl_stride=4))
    with pytest.raises(ValueError, match="not divisible"):
        _port(problem, 5, "quadratic")


def test_step_loop_stride_with_observations_matches_jax(problem):
    """The step loop's pl_stride > 1 with the fused, masked likelihood at the
    recorded points (JAX solver.py:376-407: conv the AND over the inner
    steps, a padding-only point forgives its steps)."""
    stride = 4
    n_pl = T // stride + 1
    rng = np.random.default_rng(3)
    vals = rng.uniform(-4.0, -2.0, (2, n_pl))
    mask = np.ones((2, n_pl))
    mask[1, -3:] = 0.0
    mat, n0, p0 = problem
    jobs = jsolver.FusedObs(values=jnp.asarray(vals), log_scale=jnp.asarray(20.0),
                            min_val=1e-300, mask=jnp.asarray(mask))
    tobs = tsolver.FusedObs(values=torch.as_tensor(vals), log_scale=20.0,
                            min_val=1e-300, mask=torch.as_tensor(mask))
    rj = jsolver.solve(jnp.asarray(mat), jnp.asarray(n0), jnp.asarray(p0),
                       jnp.zeros_like(jnp.asarray(n0)),
                       _cfg(jsolver, stride, "quadratic", "coupled_newton"),
                       obs=jobs, record_pl=True)
    rt = _port(problem, stride, "quadratic", method="coupled_newton", obs=tobs)
    np.testing.assert_allclose(rt.pl.numpy(), np.asarray(rj.pl), rtol=1e-12, atol=0)
    np.testing.assert_allclose(rt.sse.numpy(), np.asarray(rj.sse), rtol=1e-12)
    np.testing.assert_allclose(rt.err_sum.numpy(), np.asarray(rj.err_sum), rtol=1e-12)
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    np.testing.assert_array_equal(rt.sample_iters.numpy(), np.asarray(rj.sample_iters))
