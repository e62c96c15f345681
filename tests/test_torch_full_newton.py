"""Full Newton in the port: the horizon kernel's full-Newton body (method
fused_horizon) and the per-step Newton kernel (coupled_newton_pallas),
through their plain PyTorch versions, against the JAX package on the same
float64 inputs.

* the plain full-Newton fine phase against the JAX Pallas horizon kernel
  with ``chord=False`` in interpret mode (the file's one interpret compile
  of that kernel): sse/err_sum within 1e-9 relative, conv and Newton
  updates equal, state within 1e-9;
* a plain full-Newton stride-S rung and off-grid phase, through
  ``solve_coarse_phase_fused`` and ``solve_phase_offgrid_fused``, against
  the JAX package's XLA twins with coupled_newton
  (``twophase._coarse_phase``, ``offgrid._phase_offgrid``; its own tests
  tie them to the Pallas kernel) from the same state: 1e-12 relative;
* the plain full-Newton phases against the port's own step loops
  (``solve``/``bdf_step``, ``twophase._coarse_phase``,
  ``offgrid._phase_offgrid`` with coupled_newton): the Newton trajectory
  (final N/P/E, conv, updates, worst step) bit for bit; sse/err_sum within
  1e-12, because the kernel sums each fine point or slot over the steps
  and adds the t=0 term last while the step loops sum each step's points
  first;
* ``newton_step`` on the CPU against JAX ``pallas_newton_step`` in
  interpret mode and JAX ``coupled_newton_step``, on recorded BDF steps,
  batch 8 and 12 (12 exercises the JAX kernel's tile padding).

Full Newton takes its skip and loop exit per sample in the port and per
tile in the JAX kernel; a sample that is done gets no update and keeps its
flags, so the two agree without a ``group`` argument.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import sample_mat_par
from bayesian_inference_trpl_tpu import physics
from bayesian_inference_trpl_tpu.models import newton as jnewton
from bayesian_inference_trpl_tpu.models import offgrid as jog
from bayesian_inference_trpl_tpu.models.driver import (
    SimParams, initial_excess_density, pl_log_scale)
from bayesian_inference_trpl_tpu.models.solver import FusedObs, SolverConfig
from bayesian_inference_trpl_tpu.models.trpl import MatParams as JMatParams
from bayesian_inference_trpl_tpu.models import twophase as jtwo
from bayesian_inference_trpl_tpu.ops.likelihood import FLOAT_MIN
from bayesian_inference_trpl_tpu.ops.pallas import horizon_kernel as jhk
from bayesian_inference_trpl_tpu.ops.pallas.newton_kernel import pallas_newton_step
from bayesian_inference_trpl_tpu_torch.models import offgrid as tog
from bayesian_inference_trpl_tpu_torch.models import solver as tsolver
from bayesian_inference_trpl_tpu_torch.models import twophase as ttwo
from bayesian_inference_trpl_tpu_torch.models.solver import FusedObs as TFusedObs
from bayesian_inference_trpl_tpu_torch.ops import horizon_kernel as thk
from bayesian_inference_trpl_tpu_torch.ops import newton_kernel as tnk

torch.set_num_threads(1)

# The JAX package's XLA Newton step, compiled once per batch shape.
_jax_newton_step = jax.jit(jnewton.coupled_newton_step, static_argnames=("max_iters",))

B, T1 = 6, 36
SCHEDULE = ((1, T1), (8, 32), (16, 32))
T = sum(n for _, n in SCHEDULE)
# Off-grid observation times in fine steps: two experiments, log-spaced,
# none on the grid.
T_OBS = ([0.0, 0.7, 1.2, 3.5, 6.9, 11.4, 19.3, 27.7, 33.1, 41.5, 57.2, 80.4, 97.0],
         [0.0, 0.45, 2.3, 5.1, 9.6, 17.5, 25.1, 46.3, 71.9])


@pytest.fixture(scope="module")
def problem():
    """A masked float64 problem on the ladder: the second curve ends early
    (fine step 24) and the last 9 fine points carry no weight at all."""
    rng = np.random.default_rng(7)
    sim = SimParams(length=311.0, time=2000.0 * T / 80000, L=128, T=T)
    mat = np.asarray(physics.nondimensionalize(sample_mat_par(rng, B), sim.dx, sim.dt))
    dn = np.asarray(initial_excess_density(sim, (1e18 / 1e7 ** 3, 100.0), "exp"))
    n0 = mat[:, 0:1] + dn[None]
    p0 = mat[:, 1:2] + dn[None]
    vals = rng.uniform(-4.0, -2.0, (2, T + 1))
    mask = np.ones((2, T + 1))
    mask[1, 24:] = 0.0
    mask[:, T - 9:] = 0.0
    cfg = dict(num_steps=T, tol=1e-8, max_iters=8, step_tol=1e-6,
               method="fused_horizon", predictor="quadratic")
    return sim, mat, n0, p0, vals, mask, cfg


def _jax_obs(vals, mask, log_scale):
    return FusedObs(values=jnp.asarray(vals), log_scale=jnp.asarray(log_scale),
                    min_val=1e-300, mask=jnp.asarray(mask))


def _port(problem, T_cfg=None, **cfg_changes):
    """The problem as the port's tensors, FusedObs and SolverConfig."""
    sim, mat, n0, p0, vals, mask, cfg = problem
    cfg = dict(cfg, **cfg_changes)
    if T_cfg is not None:
        cfg["num_steps"] = T_cfg
        vals, mask = vals[:, :T_cfg + 1], mask[:, :T_cfg + 1]
    return thk.from_jax_inputs(mat, n0, p0, np.zeros_like(n0), vals, pl_log_scale(sim),
                               1e-300, mask=mask, cfg=cfg)[:6]


def _close(rt, rj, rtol, state_rtol):
    np.testing.assert_allclose(rt.sse.numpy(), np.asarray(rj.sse), rtol=rtol)
    np.testing.assert_allclose(rt.err_sum.numpy(), np.asarray(rj.err_sum),
                               rtol=rtol, atol=1e-12)
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    np.testing.assert_array_equal(rt.sample_iters.numpy(), np.asarray(rj.sample_iters))
    for a, b in ((rt.n, rj.n), (rt.p, rj.p), (rt.e, rj.e)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=state_rtol,
                                   atol=1e-12)


# ---------------------------------------------------------------------------
# (a) the fine phase against the Pallas kernel's full Newton
# ---------------------------------------------------------------------------

def test_stride1_full_plain_matches_pallas(problem, monkeypatch):
    """solve_horizon_fused(chord=False), tb=12, T=36, batch 6, masked."""
    monkeypatch.setattr(jhk, "TIME_BLOCK", 12)
    sim, mat, n0, p0, vals, mask, cfg = problem
    obs1 = _jax_obs(vals[:, :T1 + 1], mask[:, :T1 + 1], pl_log_scale(sim))
    rj = jhk.solve_horizon_fused(jnp.asarray(mat), jnp.asarray(n0), jnp.asarray(p0),
                                 SolverConfig(**dict(cfg, num_steps=T1)), obs1, tb=12,
                                 chord=False, interpret=True,
                                 e_init=jnp.zeros_like(jnp.asarray(n0)))
    mt, n0t, p0t, e0t, obs_t, cfg_t = _port(problem, T_cfg=T1)
    calls = []

    def plain(*args):
        calls.append(args[-1])
        return thk.horizon_chord_plain(*args)
    rt = thk.solve_horizon_fused(mt, n0t, p0t, cfg_t, obs_t, e_init=e0t, kernel=plain)
    assert [c.chord for c in calls] == [False]
    _close(rt, rj, 1e-9, 1e-9)
    assert rt.converged.all() and int(rt.max_newton_iters) >= 2
    # Full Newton refreshes on every iteration: the telemetry says so.
    assert torch.equal(rt.full_solves, rt.sample_iters)
    assert torch.equal(rt.tile_body_iters, rt.sample_iters)


# ---------------------------------------------------------------------------
# (b) rungs and off-grid phases against the JAX package's XLA twins
# ---------------------------------------------------------------------------

def _fine_state(problem):
    """The port's state after the fine phase (coupled_newton step loop),
    the start of the rung that (b) compares, with the run-t=0 PL."""
    mt, n0t, p0t, e0t, obs_t, cfg_t = _port(problem, T_cfg=T1, method="coupled_newton")
    r = tsolver.solve(mt, n0t, p0t, e0t, cfg_t, obs=obs_t, record_pl=False)
    return r.n, r.p, r.e, tsolver.pl_observable(n0t, p0t, thk.MatParams.from_array(mt))


def _jax_acc(batch, num_exp=2):
    z = jnp.zeros((num_exp, batch))
    return (jnp.ones((batch,), bool), jnp.int32(0), jnp.zeros((batch,), jnp.int32), z, z)


def _close_phase(rt, acc_j, state_j):
    """A port phase result against the JAX phase's (acc, state) from zero
    accumulators: 1e-12 relative."""
    conv, _, its, sse, esum = acc_j
    np.testing.assert_allclose(rt.sse.numpy(), np.asarray(sse), rtol=1e-12)
    np.testing.assert_allclose(rt.err_sum.numpy(), np.asarray(esum), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(conv))
    np.testing.assert_array_equal(rt.sample_iters.numpy(), np.asarray(its))
    # E = num/denom with num a difference of near-equal fluxes: its small
    # entries carry the rounding of N and P, hence the absolute floor.
    for a, b in zip((rt.n, rt.p, rt.e), state_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)


def test_rung_full_plain_matches_jax_scan(problem):
    """The stride-8 rung (64 fine steps after the fine phase, masked, with
    padding-only steps), one plain full-Newton call, against JAX
    twophase._coarse_phase with coupled_newton, from the same state."""
    sim, mat, n0, p0, vals, mask, cfg = problem
    n, p, e, pl0 = _fine_state(problem)
    *state_j, acc_j = jtwo._coarse_phase(
        jnp.asarray(mat), *(jnp.asarray(x.numpy()) for x in (n, p, e)),
        SolverConfig(**dict(cfg, method="coupled_newton")),
        _jax_obs(vals, mask, pl_log_scale(sim)), jnp.asarray(pl0.numpy()),
        _jax_acc(B), T1, 64, 8)
    mt, _, _, _, obs_t, cfg_t = _port(problem)
    prms = []

    def plain(*args):
        prms.append(args[-1])
        return thk.horizon_chord_plain(*args)
    rt = thk.solve_coarse_phase_fused(mt, n, p, e, cfg_t, obs_t, pl0, T1, 64, 8,
                                      kernel=plain)
    assert [(q.stride, q.chord) for q in prms] == [(8, False)]
    _close_phase(rt, acc_j, state_j)
    assert rt.converged.all()


def _offgrid_tables(sim, seed=4):
    rng = np.random.default_rng(seed)
    times = [np.asarray(t) * sim.dt for t in T_OBS]
    values = [np.log10(1e-3 * np.exp(-t / 0.2)) + 0.01 * rng.standard_normal(len(t))
              for t in times]
    weights = [rng.uniform(0.5, 2.0, len(t)) for t in times]
    return times, values, weights


def test_offgrid_full_plain_matches_jax_scan(problem):
    """The stride-8 off-grid phase, sigma-weighted and normalized, one
    plain full-Newton call (off-grid mode), against JAX
    offgrid._phase_offgrid with coupled_newton, from the same state."""
    sim, mat, n0, p0, _, _, cfg = problem
    times, values, weights = _offgrid_tables(sim)
    values = [v - v[0] for v in values]
    sched = ((1, T1), (8, T - T1))
    tables = tog.build_offgrid_tables(times, values, sched, sim.dt, weights=weights)
    live = tog.liveness(tables, sched)[1]
    tbl = tables.phases[1]
    n, p, e, pl0 = _fine_state(problem)
    meta_j = FusedObs(values=jnp.zeros((2, 1)), log_scale=jnp.asarray(pl_log_scale(sim)),
                      min_val=FLOAT_MIN, normalize=True)
    *state_j, acc_j = jog._phase_offgrid(
        jnp.asarray(mat), *(jnp.asarray(x.numpy()) for x in (n, p, e)),
        SolverConfig(**dict(cfg, method="coupled_newton")), meta_j,
        tuple(jnp.asarray(a) for a in tbl), jnp.asarray(pl0.numpy()), _jax_acc(B), 8,
        jnp.asarray(live.numpy()))
    mt, _, _, _, _, cfg_t = _port(problem)
    meta_t = TFusedObs(values=torch.zeros((2, 1), dtype=torch.float64),
                       log_scale=pl_log_scale(sim), min_val=FLOAT_MIN, normalize=True)
    tbl_t, live_t = thk.offgrid_tables_from_jax(tbl, live.numpy())
    prms = []

    def plain(*args):
        prms.append(args[-1])
        return thk.horizon_chord_plain(*args)
    rt = thk.solve_phase_offgrid_fused(mt, n, p, e, cfg_t, meta_t, tbl_t, pl0, 8, live_t,
                                       kernel=plain)
    assert [(q.offgrid_k > 0, q.chord) for q in prms] == [(True, False)]
    _close_phase(rt, acc_j, state_j)
    assert rt.converged.all()


# ---------------------------------------------------------------------------
# (c) against the port's own step loops, bit for bit
# ---------------------------------------------------------------------------

def _same_trajectory(a, b):
    for name in ("n", "p", "e", "converged", "sample_iters", "max_newton_iters"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    torch.testing.assert_close(a.sse, b.sse, rtol=1e-12, atol=0.0)
    torch.testing.assert_close(a.err_sum, b.err_sum, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("mode", ["stride_1", "stride_s", "offgrid"])
def test_full_plain_equals_step_loops(problem, mode):
    """Each mode's plain full Newton (method fused_horizon) against the same
    call with coupled_newton, which takes the step loop (solve/bdf_step,
    twophase._coarse_phase, offgrid._phase_offgrid); coupled_newton_pallas
    on CPU tensors takes the step loop through newton_step's plain version
    and equals coupled_newton in everything."""
    sim, mat, n0, p0, _, _, _ = problem
    mt, n0t, p0t, e0t, obs_t, cfg_t = _port(problem)
    if mode == "stride_1":
        def run(method):
            return tsolver.solve(mt, n0t, p0t, e0t, cfg_t._replace(method=method),
                                 obs=obs_t, record_pl=False)
    elif mode == "stride_s":
        def run(method):
            return ttwo.solve_multiphase(mt, n0t, p0t, e0t, cfg_t._replace(method=method),
                                         obs_t, SCHEDULE)
    else:
        times, values, weights = _offgrid_tables(sim)
        tables = tog.build_offgrid_tables(times, values, SCHEDULE, sim.dt, weights=weights)

        def run(method):
            return tog.solve_offgrid(mt, n0t, p0t, e0t, cfg_t._replace(method=method),
                                     tables, SCHEDULE, pl_log_scale(sim), FLOAT_MIN)
    ref = run("coupled_newton")
    _same_trajectory(run("fused_horizon"), ref)
    pallas = run("coupled_newton_pallas")
    for name in ("n", "p", "e", "converged", "sample_iters", "sse", "err_sum"):
        assert torch.equal(getattr(pallas, name), getattr(ref, name)), name
    assert ref.converged.all()


# ---------------------------------------------------------------------------
# (d) the per-step Newton kernel's wrapper on the CPU
# ---------------------------------------------------------------------------

def _recorded_steps(problem, batch):
    """The inputs of steps 0 and 3 of the port's coupled_newton_pallas
    fine phase (predictor quadratic), for the first ``batch`` samples
    (tiled when batch > B)."""
    idx = np.arange(batch) % B
    sim, mat, n0, p0, vals, mask, cfg = problem
    mt, n0t, p0t, e0t, obs_t, cfg_t = thk.from_jax_inputs(
        mat[idx], n0[idx], p0[idx], np.zeros_like(n0[idx]), vals[:, :5],
        pl_log_scale(sim), 1e-300, mask=mask[:, :5],
        cfg=dict(cfg, num_steps=4, method="coupled_newton_pallas"))[:6]
    steps = []
    orig = tsolver.newton_step

    def rec(*args, **kw):
        steps.append((args, kw))
        return orig(*args, **kw)
    tsolver.newton_step = rec
    try:
        tsolver.solve(mt, n0t, p0t, e0t, cfg_t, obs=obs_t, record_pl=False)
    finally:
        tsolver.newton_step = orig
    return mt, [steps[0], steps[3]]


@pytest.mark.parametrize("batch", [8, 12])
def test_newton_step_matches_pallas(problem, batch):
    """newton_step (CPU: coupled_newton_step) against JAX
    pallas_newton_step in interpret mode and JAX coupled_newton_step: N/P
    within 1e-12 relative, E within 1e-12 of its largest magnitude
    (E = num/denom with num a difference of near-equal fluxes, so its small
    entries carry the rounding of the large ones), conv and updates equal."""
    mt, steps = _recorded_steps(problem, batch)
    for (Nk, Pk, bN, bP, bE, mp, a0, tol, max_iters), kw in steps:
        rt = tnk.newton_step(Nk, Pk, bN, bP, bE, mp, a0, tol, max_iters, **kw)
        jmp = JMatParams(*(jnp.asarray(c.numpy()) for c in mp))
        args = [jnp.asarray(x.numpy()) for x in (Nk, Pk, torch.zeros_like(Nk), bN, bP, bE)]
        scal = dict(a0=float(a0), tol=float(tol), max_iters=int(max_iters),
                    step_tol=jnp.asarray(float(kw["step_tol"])))
        for name, rj in (
                ("pallas", pallas_newton_step(*args, jmp, interpret=True, **scal)),
                ("xla", _jax_newton_step(*args, jmp, **scal))):
            np.testing.assert_array_equal(rt[3].numpy(), np.asarray(rj[3]), err_msg=name)
            np.testing.assert_array_equal(rt[4].numpy(), np.asarray(rj[4]), err_msg=name)
            for a, b in zip(rt[:2], rj[:2]):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                           err_msg=name)
            e_scale = float(rt[2].abs().max())
            np.testing.assert_allclose(rt[2].numpy(), np.asarray(rj[2]), rtol=0,
                                       atol=1e-12 * e_scale, err_msg=name)
        assert bool(rt[4].all()) and int(rt[3].min()) >= 1
    # The port's layout helper: the JAX kernel's (12, batch) stack.
    mat_cols = np.stack([c.numpy() for c in steps[0][0][5]])
    conv = tnk.step_inputs_from_jax(mat_cols, *(x.numpy() for x in steps[0][0][:5]),
                                    1.0, 1e-8, 0.0)
    assert torch.equal(torch.stack(tuple(conv[5]), 1), mt)
