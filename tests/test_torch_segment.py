"""Recording and segmentation of the port's ``solve`` and the forward
model's standalone mode (models/driver.pvsim), against the JAX package.

One JAX ``solve`` (float64, coupled_newton, L 32, T 40, batch 3, fused
observations, the PL trace every 2 steps, the state every 4, the iteration
trace) against the port's step loop and against its record route (a
fused method without observations: the horizon kernel's record launch,
its plain version on the CPU): PL, states with the same NaN frames, sse
and err_sum within 1e-12 relative (E with a 1e-12 absolute floor, as
tests/test_torch_record.py), iters and conv equal; the two port routes
bitwise equal to each other on the state and iteration traces.  The rest
is held within the port: a segmented run bitwise the unsegmented one,
pvsim's "continue" mode, the state round trip (pvsim against the JAX
package's is tests/test_torch_sweep.py's run_solver parity).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import sample_mat_par
from bayesian_inference_trpl_tpu import physics
from bayesian_inference_trpl_tpu.models import solver as jsolver
from bayesian_inference_trpl_tpu_torch.models import driver as tdriver
from bayesian_inference_trpl_tpu_torch.models import solver as tsolver
from bayesian_inference_trpl_tpu_torch.models.trpl import MatParams

torch.set_num_threads(1)

B, T, L, STRIDE, RSS = 3, 40, 32, 2, 4


def _sim(T_=T, L_=L):
    return tdriver.SimParams(length=311.0, time=2000.0 * T_ / 80000, L=L_, T=T_)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(5)
    sim = _sim()
    mat = np.asarray(physics.nondimensionalize(sample_mat_par(rng, B), sim.dx, sim.dt))
    dn = tdriver.initial_excess_density(sim, (1e18 / 1e7 ** 3, 100.0), "exp",
                                        device="cpu").numpy()
    obs = rng.uniform(-4.0, -2.0, (1, T // STRIDE + 1))
    return mat, mat[:, 0:1] + dn[None], mat[:, 1:2] + dn[None], obs, tdriver.pl_log_scale(sim)


def _cfg(mod, method="coupled_newton", **kw):
    return mod.SolverConfig(num_steps=T, pl_stride=STRIDE, tol=1e-9, max_iters=100,
                            method=method, record_state_stride=RSS, record_iters=True,
                            **kw)


def _tobs(problem, lo=0, hi=None, normalize=False):
    vals = torch.as_tensor(problem[3][:, lo:hi])
    return tsolver.FusedObs(values=vals, log_scale=problem[4], min_val=1e-300,
                            normalize=normalize)


def _port(problem, cfg=None, obs=True, **kw):
    mat, n0, p0 = (torch.as_tensor(a) for a in problem[:3])
    return tsolver.solve(mat, n0, p0, torch.zeros_like(n0), cfg or _cfg(tsolver),
                         obs=_tobs(problem) if obs is True else obs, **kw)


@pytest.fixture(scope="module")
def jax_result(problem):
    mat, n0, p0, obs, log_scale = problem
    n0j = jnp.asarray(n0)
    return jsolver.solve(
        jnp.asarray(mat), n0j, jnp.asarray(p0), jnp.zeros_like(n0j), _cfg(jsolver),
        obs=jsolver.FusedObs(values=jnp.asarray(obs), log_scale=jnp.asarray(log_scale),
                             min_val=1e-300),
        record_pl=True)


def _close(a, b, atol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12, atol=atol)


@pytest.mark.parametrize("route", ["step_loop", "record"])
def test_recording_matches_jax(problem, jax_result, route):
    """Both routes against the one JAX solve: the trace of each recorded
    quantity in JAX's layout.  The record route scores no observations."""
    rj = jax_result
    if route == "step_loop":
        rt = _port(problem)
        _close(rt.sse, rj.sse)
        _close(rt.err_sum, rj.err_sum)
    else:
        rt = _port(problem, _cfg(tsolver, "fused_horizon"), obs=None)
        assert rt.sse is None and rt.hist is None
    assert rt.pl.shape == (B, T // STRIDE + 1)
    _close(rt.pl, rj.pl)
    assert len(rt.states) == 3
    for got, want, atol in zip(rt.states, rj.states, (0.0, 0.0, 1e-12)):
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape == (T // STRIDE, B, L)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert np.isnan(got[0::2]).all() and not np.isnan(got[1::2]).any()
        _close(got[1::2], want[1::2], atol)
    np.testing.assert_array_equal(rt.iters.numpy(), np.asarray(rj.iters))
    assert rt.iters.dtype == torch.int32
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    assert int(rt.max_newton_iters) == int(rj.max_newton_iters)


def test_record_route_bitwise_step_loop(problem):
    """The record route's plain version and the step loop run the same
    Newton steps: state and iteration traces, conv and the final state
    bit for bit."""
    loop = _port(problem, obs=None)
    rec = _port(problem, _cfg(tsolver, "fused_horizon"), obs=None)
    for a, b in zip(loop.states, rec.states):
        assert torch.equal(torch.nan_to_num(a, nan=7.0), torch.nan_to_num(b, nan=7.0))
    for name in ("iters", "converged", "n", "p", "e", "sample_iters"):
        assert torch.equal(getattr(loop, name), getattr(rec, name)), name
    torch.testing.assert_close(loop.pl, rec.pl, rtol=1e-15, atol=0.0)


def test_segmented_run_bitwise(problem):
    """T/2 + T/2 with return_hist / init_hist / acc0 is the unsegmented run
    bit for bit: final state, PL, states, iterations and the sums."""
    full = _port(problem)
    T1 = T // 2
    n1 = T1 // STRIDE
    r1 = _port(problem, _cfg(tsolver)._replace(num_steps=T1), obs=_tobs(problem, 0, n1 + 1),
               return_hist=True)
    assert r1.hist is not None and r1.hist[0].shape == (6, B, L)
    hist_before = [h.clone() for h in r1.hist]
    r2 = _port(problem, _cfg(tsolver)._replace(num_steps=T - T1), obs=_tobs(problem, n1),
               start_step=T1, init_hist=r1.hist, acc0=(r1.sse, r1.err_sum))
    assert all(torch.equal(a, b) for a, b in zip(hist_before, r1.hist))
    for name in ("n", "p", "e", "sse", "err_sum"):
        assert torch.equal(getattr(r2, name), getattr(full, name)), name
    assert torch.equal(torch.cat([r1.pl, r2.pl[:, 1:]], 1), full.pl)
    for a, b, c in zip(r1.states, r2.states, full.states):
        assert torch.equal(torch.nan_to_num(torch.cat([a, b])), torch.nan_to_num(c))
    assert torch.equal(torch.cat([r1.iters, r2.iters]), full.iters)
    assert torch.equal(r1.converged & r2.converged, full.converged)
    with pytest.raises(ValueError, match="start_step"):
        _port(problem, start_step=3, init_hist=r1.hist)


def test_segmented_normalized_anchor(problem):
    """obs.normalize: a continued segment takes the run's t = 0 anchor as
    pl0 and then equals the unsegmented sums bit for bit; without pl0 it
    refuses."""
    mat, n0, p0 = (torch.as_tensor(a) for a in problem[:3])
    full = _port(problem, obs=_tobs(problem, normalize=True), record_pl=False)
    T1 = T // 2
    n1 = T1 // STRIDE
    r1 = _port(problem, _cfg(tsolver)._replace(num_steps=T1),
               obs=_tobs(problem, 0, n1 + 1, normalize=True), record_pl=False,
               return_hist=True)
    pl0 = tsolver.pl_observable(n0, p0, MatParams.from_array(mat))
    seg = dict(start_step=T1, init_hist=r1.hist, acc0=(r1.sse, r1.err_sum),
               record_pl=False)
    r2 = _port(problem, _cfg(tsolver)._replace(num_steps=T - T1),
               obs=_tobs(problem, n1, normalize=True), pl0=pl0, **seg)
    assert torch.equal(r2.sse, full.sse) and torch.equal(r2.err_sum, full.err_sum)
    with pytest.raises(ValueError, match="pl0"):
        _port(problem, _cfg(tsolver)._replace(num_steps=T - T1),
              obs=_tobs(problem, n1, normalize=True), **seg)


def test_pvsim_continue_mode():
    """Physical-unit restart: half a run, redim_state, then "continue" from
    that state; the BDF order ramp restarts at the boundary, so the log10 PL
    agrees to solver accuracy (2e-3) and the boundary point to the unit
    round trip (1e-12)."""
    T_, T1 = 60, 30
    sim = _sim(T_)
    mat = sample_mat_par(np.random.default_rng(7), 2)
    ini = (1e18 / 1e7 ** 3, 100.0)
    kw = dict(dtype=torch.float64, device="cpu")
    r_full = tdriver.pvsim(mat, sim, ini, init_mode="exp", **kw)
    sim1 = tdriver.SimParams(length=sim.length, time=sim.time * T1 / T_, L=sim.L, T=T1)
    r1 = tdriver.pvsim(mat, sim1, ini, init_mode="exp", **kw)
    r2 = tdriver.pvsim(mat, sim1, tdriver.redim_state(r1, sim1), init_mode="continue",
                       **kw)
    pl_full = r_full.pl.numpy()[:, T1:]
    dev = np.abs(np.log10(r2.pl.numpy()) - np.log10(pl_full))
    assert dev.max() < 2e-3, dev.max()
    np.testing.assert_allclose(r2.pl.numpy()[:, 0], r_full.pl.numpy()[:, T1], rtol=1e-12)


def test_nondim_state_round_trip():
    """nondim_state(redim_state(r)) == r's state within 1e-14."""
    T_ = 8
    sim = _sim(T_)
    mat = sample_mat_par(np.random.default_rng(3), 2)
    r = tdriver.pvsim(mat, sim, (1e18 / 1e7 ** 3, 100.0), init_mode="exp",
                      dtype=torch.float64, device="cpu")
    back = tdriver.nondim_state(*tdriver.redim_state(r, sim), sim)
    for got, want in zip(back, (r.n, r.p, r.e)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-14)
