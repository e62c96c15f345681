"""The Gauss-Seidel reference scheme of the port (ops/tridiag,
models/trpl.assemble_n/assemble_p/newton_iteration/implicit_step, the
gauss_seidel dispatch of models/solver.bdf_step) against the JAX package
on the same numpy inputs, float64 under the conftest's x64:

* the tridiagonal solvers, residual and product within 1e-12 relative
  (to the largest entry); a non-power-of-two L raises in both;
* the step's pieces on production-box states within 1e-12, and
  implicit_step's iteration counts and flags equal;
* ``solve`` at L 32 and 128 with the previous and the quadratic predictor
  (the second reads the extrapolated E iterate), its PL within 1e-10 and
  its state within 1e-12, the iteration traces equal; the stride ladder
  and the off-grid solver within 1e-10 on sse;
* on the port alone, Gauss-Seidel against coupled Newton, as
  tests/test_coupled_newton.py:115-135 holds the JAX package;
* ``SolverConfig``'s defaults and ``SOLVER_METHODS`` equal the JAX
  package's.

Gauss-Seidel reaches no Pallas kernel in the JAX package, so it is plain
PyTorch in the port and runs the same on the card.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import sample_mat_par
from bayesian_inference_trpl_tpu import physics
from bayesian_inference_trpl_tpu.models import offgrid as jog
from bayesian_inference_trpl_tpu.models import solver as jsolver
from bayesian_inference_trpl_tpu.models import trpl as jtrpl
from bayesian_inference_trpl_tpu.models import twophase as jtwo
from bayesian_inference_trpl_tpu.ops import tridiag as jtri
from bayesian_inference_trpl_tpu.utils import validate as jvalidate
from bayesian_inference_trpl_tpu_torch.models import driver as tdriver
from bayesian_inference_trpl_tpu_torch.models import offgrid as tog
from bayesian_inference_trpl_tpu_torch.models import solver as tsolver
from bayesian_inference_trpl_tpu_torch.models import trpl as ttrpl
from bayesian_inference_trpl_tpu_torch.models import twophase as ttwo
from bayesian_inference_trpl_tpu_torch.ops import tridiag as ttri
from bayesian_inference_trpl_tpu_torch.tools.accuracy_gate import sample_production_box
from bayesian_inference_trpl_tpu_torch.utils import validate as tvalidate

torch.set_num_threads(1)

FLOAT_MIN = 2.2250738585072014e-308


def _close(a, b, rtol):
    """Within rtol of the largest entry of b (entries near zero do not
    blow the relative error up)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.max(np.abs(b)))


def _close_state(got, want, rtol=1e-12, e_atol=1e-12):
    """N, P within rtol of their largest entry; E, a difference of
    neighbouring densities that amplifies their rounding, within rtol
    relative with an absolute floor e_atol (1e-12: as
    tests/test_torch_record.py)."""
    for name, g, w in zip("NPE", got, want):
        g, w = np.asarray(g), np.asarray(w)
        if name == "E":
            np.testing.assert_allclose(g, w, rtol=rtol, atol=e_atol, err_msg=name)
        else:
            _close(g, w, rtol)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _system(L, batch=3):
    rng = np.random.default_rng(L)
    ld = rng.uniform(-1, 1, (batch, L))
    ud = rng.uniform(-1, 1, (batch, L))
    ld[:, 0] = 0.0
    ud[:, -1] = 0.0
    d = 2.5 + np.abs(ld) + np.abs(ud) + rng.uniform(0, 1, (batch, L))
    b = rng.uniform(-1, 1, (batch, L))
    return ld, d, ud, b


# ---------------------------------------------------------------------------
# ops/tridiag
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L", [2, 4, 8, 16, 32, 64, 128, 256])
def test_pcr_solve_matches_jax(L):
    s = _system(L)
    x = ttri.pcr_solve(*map(_t, s)).numpy()
    _close(x, jtri.pcr_solve(*map(jnp.asarray, s)), 1e-12)
    # and it solves the system
    _close(ttri.tridiag_matvec(*map(_t, s[:3]), _t(x)).numpy(), s[3], 1e-12)


@pytest.mark.parametrize("L", [5, 37, 128])
def test_thomas_solve_matches_jax(L):
    s = _system(L)
    _close(ttri.thomas_solve(*map(_t, s)).numpy(),
           jtri.thomas_solve(*map(jnp.asarray, s)), 1e-12)


@pytest.mark.parametrize("L", [6, 37])
def test_pcr_solve_refuses_non_power_of_two(L):
    s = _system(L)
    for solve, conv in ((ttri.pcr_solve, _t), (jtri.pcr_solve, jnp.asarray)):
        with pytest.raises(ValueError, match="power-of-two"):
            solve(*map(conv, s))


@pytest.mark.parametrize("L", [37, 128])
def test_residual_and_matvec_match_jax(L):
    ld, d, ud, b = _system(L)
    x = np.random.default_rng(1).uniform(-1, 1, b.shape)
    _close(ttri.residual_l1(*map(_t, (ld, d, ud, x, b))).numpy(),
           jtri.residual_l1(*map(jnp.asarray, (ld, d, ud, x, b))), 1e-12)
    _close(ttri.tridiag_matvec(*map(_t, (ld, d, ud, x))).numpy(),
           jtri.tridiag_matvec(*map(jnp.asarray, (ld, d, ud, x))), 1e-12)


def test_residual_sum_order_can_flip_acceptance():
    """Kept divergence: residual_l1's L1 sums run in another order in
    torch than in XLA, so the relative residuals differ in the last bits
    (on most of 32 random systems) and a sample whose residual lands
    between the two within rounding of tol takes one Gauss-Seidel
    iteration more or fewer in one package than in the other.  The solve
    tests below hold the counts equal on their inputs."""
    rng = np.random.default_rng(0)
    s = [rng.uniform(-1, 1, (32, 128)) for _ in range(5)]
    et = ttri.residual_l1(*map(_t, s)).numpy()
    ej = np.asarray(jtri.residual_l1(*map(jnp.asarray, s)))
    _close(et, ej, 1e-14)
    differ = np.flatnonzero(et != ej)
    assert differ.size > 16
    i = differ[0]
    tol = max(et[i], ej[i])        # accepted (err < tol) by one side only
    assert (et[i] < tol) != (ej[i] < tol)


# ---------------------------------------------------------------------------
# models/trpl: the Gauss-Seidel step's pieces on production-box states
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def step_inputs():
    """The inputs of BDF step t = 2 (BDF3) of six production-box samples
    (accuracy_gate.sample_production_box, nondimensionalised at dt = 25
    ps): the state after two Gauss-Seidel steps of the port, with its
    extrapolated E iterate and the BDF history sums."""
    sim = tdriver.SimParams(length=311.0, time=0.075, L=128, T=3)
    mat = np.asarray(physics.nondimensionalize(sample_production_box(6, seed=3),
                                               sim.dx, sim.dt))
    dn = tdriver.initial_excess_density(sim, (1e18 / 1e7 ** 3, 100.0), "exp",
                                        device="cpu").numpy()
    n0, p0 = mat[:, 0:1] + dn[None], mat[:, 1:2] + dn[None]
    cfg = tsolver.SolverConfig(num_steps=2, tol=1e-9, max_iters=1000)
    r = tsolver.solve(_t(mat), _t(n0), _t(p0), torch.zeros(n0.shape, dtype=torch.float64),
                      cfg, return_hist=True)
    nh, ph, eh = r.hist
    a0, w = tsolver._bdf_coeffs(2, nh)
    b = [sum(w.get(s, 0.0) * h[s] for s in range(6)).numpy() for h in (nh, ph, eh)]
    Ek = (eh[2] + (eh[2] - eh[1])).numpy()
    return mat, nh[2].numpy(), ph[2].numpy(), Ek, b, float(a0)


def _mp(mod, mat, conv):
    return mod.MatParams.from_array(conv(mat))


def test_assemble_and_update_e_match_jax(step_inputs):
    mat, N, P, E, (bN, bP, bE), a0 = step_inputs
    mt, mj = _mp(ttrpl, mat, _t), _mp(jtrpl, mat, jnp.asarray)
    for name in ("assemble_n", "assemble_p"):
        bx = bN if name == "assemble_n" else bP
        got = getattr(ttrpl, name)(_t(N), _t(P), _t(E), _t(bx), mt, a0)
        want = getattr(jtrpl, name)(*map(jnp.asarray, (N, P, E, bx)), mj, a0)
        for g, w in zip(got, want):
            _close(g.numpy(), w, 1e-12)
    _close(ttrpl.update_e(_t(N), _t(P), _t(bE), mt, a0).numpy(),
           jtrpl.update_e(*map(jnp.asarray, (N, P, bE)), mj, a0), 1e-12)


def test_newton_iteration_matches_jax(step_inputs):
    mat, N, P, E, (bN, bP, bE), a0 = step_inputs
    got = ttrpl.newton_iteration(*map(_t, (N, P, E, bN, bP, bE)), _mp(ttrpl, mat, _t), a0)
    want = jtrpl.newton_iteration(*map(jnp.asarray, (N, P, E, bN, bP, bE)),
                                  _mp(jtrpl, mat, jnp.asarray), a0)
    for g, w in zip(got, want):
        _close(g.numpy(), w, 1e-12)


@pytest.mark.parametrize("step_tol", [0.0, 1e-6])
def test_implicit_step_matches_jax(step_inputs, step_tol):
    """Each sample freezes on its own: counts and flags equal, the state
    within 1e-12 (max_iters 6 leaves every sample not done)."""
    mat, N, P, E, (bN, bP, bE), a0 = step_inputs
    for max_iters in (6, 500):
        got = ttrpl.implicit_step(*map(_t, (N, P, E, bN, bP, bE)), _mp(ttrpl, mat, _t),
                                  a0, torch.tensor(1e-9, dtype=torch.float64), max_iters,
                                  step_tol=torch.tensor(step_tol, dtype=torch.float64))
        want = jtrpl.implicit_step(*map(jnp.asarray, (N, P, E, bN, bP, bE)),
                                   _mp(jtrpl, mat, jnp.asarray), a0, jnp.asarray(1e-9),
                                   max_iters, step_tol=jnp.asarray(step_tol))
        _close_state([g.numpy() for g in got[:3]], want[:3])
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
        assert bool(got[4].all()) == (max_iters == 500)


# ---------------------------------------------------------------------------
# models/solver: the step loop with gauss_seidel
# ---------------------------------------------------------------------------

def _problem(L, T, batch=2, seed=5):
    """sample_mat_par's box with the production field coupling (lambda
    0.1, as tests/test_coupled_newton.py: at 10 the reference scheme
    stalls); the exp initial condition."""
    rng = np.random.default_rng(seed)
    mat = sample_mat_par(rng, batch)
    mat[:, 11] = 0.1 * physics.UNIT_CONVERSIONS[11]
    sim = tdriver.SimParams(length=311.0, time=2000.0 * T / 80000, L=L, T=T)
    mat_nd = np.asarray(physics.nondimensionalize(mat, sim.dx, sim.dt))
    dn = tdriver.initial_excess_density(sim, (1e18 / 1e7 ** 3, 100.0), "exp",
                                        device="cpu").numpy()
    return sim, mat_nd, mat_nd[:, 0:1] + dn[None], mat_nd[:, 1:2] + dn[None]


def _both(mat, n0, p0, cfg_kw, **kw):
    rj = jsolver.solve(*map(jnp.asarray, (mat, n0, p0, np.zeros_like(n0))),
                       jsolver.SolverConfig(**cfg_kw), **kw)
    rt = tsolver.solve(*map(_t, (mat, n0, p0, np.zeros_like(n0))),
                       tsolver.SolverConfig(**cfg_kw), **kw)
    return rj, rt


@pytest.mark.parametrize("L, T", [(32, 80), (128, 16)])
@pytest.mark.parametrize("predictor", ["previous", "quadratic"])
def test_solve_matches_jax(L, T, predictor):
    """PL every 2 steps and the state every 4: PL within 1e-10, N and P
    within 1e-10 of their largest entry (NaN frames equal), iteration
    traces and counts equal.  E within 1e-9 of its largest entry: over the
    steps its rounding grows ~300x that of N and P, whose neighbour
    differences it is (L 128, quadratic, T 40: N 4.2e-13, E 1.3e-10)."""
    _, mat, n0, p0 = _problem(L, T)
    cfg = dict(num_steps=T, pl_stride=2, tol=1e-9, max_iters=1000, predictor=predictor,
               method="gauss_seidel", record_state_stride=4, record_iters=True)
    rj, rt = _both(mat, n0, p0, cfg)
    _close(rt.pl.numpy(), rj.pl, 1e-10)
    got, want = [a.numpy() for a in rt.states], [np.asarray(b) for b in rj.states]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    want = [np.nan_to_num(b) for b in want]
    _close_state([np.nan_to_num(a) for a in got], want, 1e-10, 1e-9 * np.abs(want[2]).max())
    for name in ("iters", "sample_iters", "converged", "max_newton_iters"):
        np.testing.assert_array_equal(getattr(rt, name).numpy(),
                                      np.asarray(getattr(rj, name)), err_msg=name)
    assert rt.converged.all()


def test_two_segments_equal_one_run():
    """A run split at step 8 (histories and sums carried) is bitwise the
    unsplit run, with the quadratic predictor's extrapolated E."""
    sim, mat, n0, p0 = _problem(32, 16, batch=2)
    obs = np.random.default_rng(2).uniform(-4.0, -2.0, (1, 17))
    args = list(map(_t, (mat, n0, p0, np.zeros_like(n0))))
    cfg = tsolver.SolverConfig(num_steps=16, tol=1e-9, max_iters=1000,
                               predictor="quadratic", method="gauss_seidel")

    def tobs(lo, hi=None):
        return tsolver.FusedObs(values=_t(obs[:, lo:hi]),
                                log_scale=tdriver.pl_log_scale(sim), min_val=1e-300)
    one = tsolver.solve(*args, cfg, obs=tobs(0))
    a = tsolver.solve(*args, cfg._replace(num_steps=8), obs=tobs(0, 9), return_hist=True)
    b = tsolver.solve(*args, cfg._replace(num_steps=8), obs=tobs(8), start_step=8,
                      init_hist=a.hist, acc0=(a.sse, a.err_sum))
    for name in ("pl", "n", "p", "e", "sse", "err_sum"):
        x, y = getattr(one, name), getattr(b, name)
        if name == "pl":
            x, y = x[:, 9:], y[:, 1:]
        assert x.numpy().tobytes() == y.numpy().tobytes(), name
    np.testing.assert_array_equal((a.sample_iters + b.sample_iters).numpy(),
                                  one.sample_iters.numpy())


def test_ladder_and_offgrid_match_jax():
    """solve_multiphase on a short ladder (the coarse rungs step through
    bdf_step) and the off-grid solver, gauss_seidel: sse within 1e-10."""
    schedule = ((1, 8), (2, 16))
    T = 24
    sim, mat, n0, p0 = _problem(32, T, batch=2)
    cfg = dict(num_steps=T, tol=1e-9, max_iters=1000, method="gauss_seidel",
               predictor="quadratic")
    vals = np.random.default_rng(4).uniform(-4.0, -2.0, (2, T + 1))
    args_j = list(map(jnp.asarray, (mat, n0, p0, np.zeros_like(n0))))
    args_t = list(map(_t, (mat, n0, p0, np.zeros_like(n0))))
    rj = jtwo.solve_multiphase(*args_j, jsolver.SolverConfig(**cfg),
                               jsolver.FusedObs(jnp.asarray(vals),
                                                jnp.asarray(tdriver.pl_log_scale(sim)),
                                                FLOAT_MIN), schedule)
    rt = ttwo.solve_multiphase(*args_t, tsolver.SolverConfig(**cfg),
                               tsolver.FusedObs(_t(vals), tdriver.pl_log_scale(sim),
                                                FLOAT_MIN), schedule)
    _close(rt.sse.numpy(), rj.sse, 1e-10)
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))

    times = [np.array([0.0, 0.7, 3.5, 7.4, 9.6, 17.7, 23.1]) * sim.dt]
    values = [np.log10(1e-3 * np.exp(-t / 0.2)) for t in times]
    tables = tog.build_offgrid_tables(times, values, schedule, sim.dt)
    rj = jog.solve_offgrid(*args_j, jsolver.SolverConfig(**cfg), tables, schedule,
                           tdriver.pl_log_scale(sim), FLOAT_MIN)
    rt = tog.solve_offgrid(*args_t, tsolver.SolverConfig(**cfg), tables, schedule,
                           tdriver.pl_log_scale(sim), FLOAT_MIN)
    _close(rt.sse.numpy(), rj.sse, 1e-10)
    np.testing.assert_array_equal(rt.sample_iters.numpy(), np.asarray(rj.sample_iters))


# ---------------------------------------------------------------------------
# the port alone: Gauss-Seidel against coupled Newton
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def both_methods():
    """tests/test_coupled_newton.py's problem (3 samples, L 128, T 60, tol
    1e-7, lambda 0.1) on the port."""
    rng = np.random.default_rng(3)
    B, T = 3, 60
    mat = sample_mat_par(rng, B)
    mat[:, 11] = 0.1 * physics.UNIT_CONVERSIONS[11]
    sim = tdriver.SimParams(length=311.0, time=2000.0 * T / 80000, L=128, T=T)
    mat_nd = _t(physics.nondimensionalize(mat, sim.dx, sim.dt))
    dn = tdriver.initial_excess_density(sim, (1e18 / 1e7 ** 3, 100.0), "exp",
                                        device="cpu")
    n0 = mat_nd[:, 0:1] + dn[None]
    p0 = mat_nd[:, 1:2] + dn[None]
    return {m: tsolver.solve(mat_nd, n0, p0, torch.zeros_like(n0), tsolver.SolverConfig(
        num_steps=T, tol=1e-7, max_iters=2000, record_iters=True, method=m))
        for m in ("gauss_seidel", "coupled_newton")}


def test_newton_matches_gauss_seidel_on_port(both_methods):
    pl_gs = both_methods["gauss_seidel"].pl.numpy()
    pl_nw = both_methods["coupled_newton"].pl.numpy()
    assert (np.abs(pl_nw - pl_gs) / np.abs(pl_gs)).max() < 2e-6
    assert both_methods["coupled_newton"].converged.all()
    assert both_methods["gauss_seidel"].converged.all()
    it_nw = both_methods["coupled_newton"].iters.numpy()
    it_gs = both_methods["gauss_seidel"].iters.numpy()
    assert it_nw.max() <= 6
    assert it_nw.sum() < 0.25 * it_gs.sum()


# ---------------------------------------------------------------------------
# C8: the configuration's defaults
# ---------------------------------------------------------------------------

def test_solver_config_defaults_equal_jax():
    assert tsolver.SolverConfig._fields == jsolver.SolverConfig._fields
    assert tsolver.SolverConfig._field_defaults == jsolver.SolverConfig._field_defaults
    assert tsolver.SolverConfig(num_steps=8) == jsolver.SolverConfig(num_steps=8)
    assert tsolver.SolverConfig(num_steps=8).method == "gauss_seidel"
    assert tvalidate.SOLVER_METHODS == jvalidate.SOLVER_METHODS
    tvalidate.validate_solver("gauss_seidel", "previous")
    with pytest.raises(ValueError, match="unknown solver method"):
        tvalidate.validate_solver("jacobi", "previous")
