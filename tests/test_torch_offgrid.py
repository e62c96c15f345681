"""The off-grid path (log-spaced observation times): the port against the
JAX package on the same inputs.

* slot tables: ``build_offgrid_tables`` bitwise equal to the JAX function;
* the coupled-Newton step loop (``solve_offgrid``, method coupled_newton)
  against JAX ``solve_offgrid``, float64, 1e-12 relative;
* the horizon kernel's off-grid mode: the plain version at group = the
  JAX tile, through ``solve_phase_offgrid_fused``, against the JAX Pallas
  kernel in interpret mode, float64, sigma-weighted, 1e-9 relative with
  conv, iterations and Jacobian refreshes equal.  Both phases have C = 12
  steps and the same K, so the JAX side compiles one program;
* ``bayes`` end to end on synthetic log-spaced data against JAX ``bayes``
  (its XLA scan reference with full Newton, as in test_torch_pipeline.py):
  P within 1e-6 relative, the off-grid route taken on both sides;
* single-phase off-grid (no ladder) through the port's ``bayes``.
"""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import sample_mat_par
from bayesian_inference_trpl_tpu import config as jcfg
from bayesian_inference_trpl_tpu import physics
from bayesian_inference_trpl_tpu.models import offgrid as jog
from bayesian_inference_trpl_tpu.models.driver import (
    SimParams, initial_excess_density, pl_log_scale)
from bayesian_inference_trpl_tpu.models.solver import FusedObs, SolverConfig
from bayesian_inference_trpl_tpu.ops.likelihood import FLOAT_MIN
from bayesian_inference_trpl_tpu.ops.pallas import horizon_kernel as jhk
from bayesian_inference_trpl_tpu.parallel import runner as jrunner
from bayesian_inference_trpl_tpu.pipeline import bayes as jbayes
from bayesian_inference_trpl_tpu_torch import config as tcfg
from bayesian_inference_trpl_tpu_torch.models import offgrid as tog
from bayesian_inference_trpl_tpu_torch.models.solver import (
    FusedObs as TFusedObs, SolverConfig as TSolverConfig, pl_observable)
from bayesian_inference_trpl_tpu_torch.models.trpl import MatParams
from bayesian_inference_trpl_tpu_torch.ops import horizon_kernel as thk
from bayesian_inference_trpl_tpu_torch.parallel import runner as trunner
from bayesian_inference_trpl_tpu_torch.pipeline import bayes as tbayes

torch.set_num_threads(1)

SCHEDULE = ((1, 12), (2, 24))           # C = 12 steps in both phases
T = sum(n for _, n in SCHEDULE)
# Observation times in fine steps: two experiments, log-spaced, none on
# the grid; K = 2 slots in both phases; no point after coarse step 10 of
# phase 2, so its last step is the forgiven tail.
T_OBS = ([0.0, 0.7, 1.2, 1.7, 3.5, 6.9, 11.4, 12.9, 13.6, 19.3, 27.7, 33.1],
         [0.0, 0.45, 2.3, 5.1, 9.6, 12.2, 17.5, 25.1])


def _problem(batch, seed=11, T=T):
    rng = np.random.default_rng(seed)
    sim = SimParams(length=311.0, time=2000.0 * T / 80000, L=128, T=T,
                    pl_stride=1)
    mat_nd = np.asarray(physics.nondimensionalize(sample_mat_par(rng, batch),
                                                  sim.dx, sim.dt))
    dn = np.asarray(initial_excess_density(sim, (1e18 / 1e7 ** 3, 100.0), "exp"))
    n0 = mat_nd[:, 0:1] + dn[None, :]
    p0 = mat_nd[:, 1:2] + dn[None, :]
    return sim, mat_nd, n0, p0


def _obs(sim, weighted, seed=4):
    rng = np.random.default_rng(seed)
    times = [np.asarray(t) * sim.dt for t in T_OBS]
    values = [np.log10(1e-3 * np.exp(-t / 0.2)) + 0.01 * rng.standard_normal(len(t))
              for t in times]
    weights = ([rng.uniform(0.5, 2.0, len(t)) for t in times] if weighted
               else None)
    return times, values, weights


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# (a) slot tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_tables_match_jax(weighted):
    sim = _problem(1)[0]
    times, values, weights = _obs(sim, weighted)
    a = tog.build_offgrid_tables(times, values, SCHEDULE, sim.dt, weights=weights)
    b = jog.build_offgrid_tables(times, values, SCHEDULE, sim.dt, weights=weights)
    for x, y in zip((a.v0, a.m0, a.n_obs), (b.v0, b.m0, b.n_obs)):
        assert x.tobytes() == np.asarray(y).tobytes()
    for pa, pb in zip(a.phases, b.phases):
        for x, y in zip(pa, pb):
            assert x.shape == y.shape and x.tobytes() == np.asarray(y).tobytes()
    assert [p[1].shape[2] for p in a.phases] == [2, 2]      # K per phase


@pytest.mark.parametrize("times, match", [
    ([np.array([0.0, 0.0, 1.5])], "duplicate t=0"),
    ([np.array([0.0, 1.5, T + 0.5])], "outside simulated horizon"),
])
def test_tables_refuse_like_jax(times, match):
    values = [np.zeros(3)]
    for mod in (tog, jog):
        with pytest.raises(ValueError, match=match):
            mod.build_offgrid_tables(times, values, SCHEDULE, 1.0)


# ---------------------------------------------------------------------------
# (b) the coupled-Newton step loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("normalize", [False, True])
def test_scan_twin_matches_jax(normalize):
    sim, mat_nd, n0, p0 = _problem(3)
    times, values, weights = _obs(sim, True)
    if normalize:
        values = [v - v[0] for v in values]
    tables = tog.build_offgrid_tables(times, values, SCHEDULE, sim.dt, weights=weights)
    cfg = dict(num_steps=T, tol=1e-9, max_iters=100, method="coupled_newton")
    rj = jog.solve_offgrid(jnp.asarray(mat_nd), jnp.asarray(n0), jnp.asarray(p0),
                           jnp.zeros_like(jnp.asarray(n0)), SolverConfig(**cfg),
                           tables, SCHEDULE, pl_log_scale(sim), FLOAT_MIN,
                           normalize=normalize)
    rt = tog.solve_offgrid(_t(mat_nd), _t(n0), _t(p0),
                           torch.zeros(n0.shape, dtype=torch.float64),
                           TSolverConfig(**cfg), tables, SCHEDULE, pl_log_scale(sim),
                           FLOAT_MIN, normalize=normalize)
    np.testing.assert_allclose(rt.sse.numpy(), np.asarray(rj.sse), rtol=1e-12)
    np.testing.assert_allclose(rt.err_sum.numpy(), np.asarray(rj.err_sum),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    np.testing.assert_array_equal(rt.sample_iters.numpy(), np.asarray(rj.sample_iters))
    np.testing.assert_allclose(rt.n.numpy(), np.asarray(rj.n), rtol=1e-12)


def test_interior_nonconvergence_not_forgiven(monkeypatch):
    """As tests/test_offgrid.py: a Newton failure at an interior unobserved
    step fails the sample; one past the last observation is forgiven."""
    T16 = 16
    sim, mat_nd, n0, p0 = _problem(2, T=T16)
    t_obs = np.array([0.0, 2.0 * sim.dt, 6.0 * sim.dt])
    tables = tog.build_offgrid_tables([t_obs], [np.array([-3.0, -3.1, -3.2])],
                                      ((1, T16),), sim.dt)
    cfg = TSolverConfig(num_steps=T16, tol=1e-9, max_iters=100, method="coupled_newton")
    orig = tog.bdf_step

    def run(fail_at):
        def failing(t, *a, **k):
            *rest, ok = orig(t, *a, **k)
            return (*rest, ok & (t != fail_at))
        monkeypatch.setattr(tog, "bdf_step", failing)
        return tog.solve_offgrid(_t(mat_nd), _t(n0), _t(p0),
                                 torch.zeros(n0.shape, dtype=torch.float64), cfg,
                                 tables, ((1, T16),), pl_log_scale(sim), FLOAT_MIN)

    assert not run(4).converged.any()     # step 4 precedes the last point
    assert run(10).converged.all()        # step 10 lies past every point


# ---------------------------------------------------------------------------
# (c) the kernel's off-grid mode (plain version) against the Pallas kernel
# ---------------------------------------------------------------------------

def _padded_plain_fulls(args, steps, group):
    """The plain version over the JAX kernel's zero-padded time block
    (``steps`` columns), for its refresh and iteration-body counts, which
    keep counting over the padded steps."""
    mat, n, p, e, V, live, M, pl0, W, prm = args
    pad = steps - V.shape[1]

    def z(x):
        return torch.nn.functional.pad(x, (0, 0, 0, pad)) if x.dim() == 3 else \
            torch.nn.functional.pad(x, (0, pad))
    return thk.horizon_chord_plain(mat, n, p, e, z(V), z(live), z(M), pl0, z(W),
                                   prm, group=group)


def test_kernel_phase_matches_pallas():
    B = 8
    sim, mat_nd, n0, p0 = _problem(B)
    times, values, weights = _obs(sim, True)
    tables = tog.build_offgrid_tables(times, values, SCHEDULE, sim.dt, weights=weights)
    lives = tog.liveness(tables, SCHEDULE)
    assert not bool(lives[1][-1]) and bool(lives[1][-2])
    cfg = SolverConfig(num_steps=T, tol=1e-8, max_iters=8, step_tol=1e-6,
                       method="fused_horizon_chord", predictor="quadratic",
                       chord_strict=True)
    meta_j = FusedObs(values=jnp.zeros((2, 1)), log_scale=jnp.asarray(pl_log_scale(sim)),
                      min_val=FLOAT_MIN)
    meta_t = TFusedObs(values=torch.zeros((2, 1), dtype=torch.float64),
                       log_scale=pl_log_scale(sim), min_val=FLOAT_MIN)
    mt, n, p, e, _, cfg_t, _ = thk.from_jax_inputs(
        mat_nd, n0, p0, np.zeros_like(n0), np.zeros((2, 1)), pl_log_scale(sim),
        FLOAT_MIN, cfg=cfg)
    pl0 = pl_observable(n, p, MatParams.from_array(mt))
    calls = []

    def plain(*args):
        calls.append(args)
        return thk.horizon_chord_plain(*args, group=B)

    for (S, _), tbl, live in zip(SCHEDULE, tables.phases, lives):
        rj = jhk.solve_phase_offgrid_fused(
            jnp.asarray(mat_nd), jnp.asarray(n.numpy()), jnp.asarray(p.numpy()),
            jnp.asarray(e.numpy()), cfg, meta_j, tbl, jnp.asarray(pl0.numpy()), S,
            jnp.asarray(live.numpy()), chord=True, interpret=True)
        tbl_t, live_t = thk.offgrid_tables_from_jax(tbl, live.numpy())
        rt = thk.solve_phase_offgrid_fused(mt, n, p, e, cfg_t, meta_t, tbl_t, pl0,
                                           S, live_t, kernel=plain)
        np.testing.assert_allclose(rt.sse.numpy(), np.asarray(rj.sse), rtol=1e-9)
        np.testing.assert_allclose(rt.err_sum.numpy(), np.asarray(rj.err_sum),
                                   rtol=1e-9, atol=1e-12)
        for name in ("converged", "sample_iters"):
            np.testing.assert_array_equal(getattr(rt, name).numpy(),
                                          np.asarray(getattr(rj, name)), err_msg=name)
        np.testing.assert_allclose(rt.n.numpy(), np.asarray(rj.n), rtol=1e-9)
        # JAX runs C rounded up to its 24-step time block.
        padded = _padded_plain_fulls(calls[-1], 24, B)
        np.testing.assert_array_equal(padded.fulls.numpy(), np.asarray(rj.full_solves))
        np.testing.assert_array_equal(padded.execs.numpy(),
                                      np.asarray(rj.tile_body_iters))
        # Both continue from the JAX state.
        n, p, e = (torch.as_tensor(np.array(x)) for x in (rj.n, rj.p, rj.e))
    assert [c[-1].offgrid_k for c in calls] == [2, 2]
    assert [c[-1].stride for c in calls] == [1, 1]


# ---------------------------------------------------------------------------
# (d), (e) bayes end to end
# ---------------------------------------------------------------------------

L, TB, TIME = 128, 64, 1.6
LADDER = dict(fast_fine_steps=16, fast_coarse_stride=4, fast_max_stride=8,
              fast_steps_per_phase=4)


def _write_offgrid(tmp_path, num_curves=2):
    """Excitations as test_torch_pipeline.py writes them; per curve t = 0
    plus 30 log-spaced times from 0.7 dt to 0.95 of the horizon."""
    dx = 311.0 / L
    xg = (np.arange(L) + 0.5) * dx
    exc = tmp_path / "exc.csv"
    obs = tmp_path / "obs.csv"
    with open(exc, "w") as f:
        for c in range(num_curves):
            dn = (0.5 + c) * 1e18 / 1e7 ** 3 * np.exp(-xg / 100.0)
            f.write(",".join(f"{v / 1e-21:.8e}" for v in dn) + "\n")
    rng = np.random.default_rng(5)
    dt = TIME / TB
    t = np.concatenate([[0.0], np.geomspace(0.7 * dt, 0.95 * TIME, 30)])
    with open(obs, "w") as f:
        for c in range(num_curves):
            pl = 2e-3 * (1 + c) * np.exp(-t / (3.0 + c)) * (1 + 0.01 * rng.standard_normal(t.size))
            for ti, pi in zip(t, pl):
                f.write(f"{ti:.6f},{pi / 1e-23:.10e},1e13\n")
        f.write("END,,\n")
    return str(obs), str(exc)


def _config(mod, tmp_path, obs, exc, out, ladder=LADDER):
    return mod.InferenceConfig(
        grid=mod.GridConfig(thickness=311.0, time=TIME, num_nodes=L, num_steps=TB,
                            tol_exp=7, max_iters=8, method="fused_horizon_chord",
                            predictor="quadratic", step_tol=1e-9, **ladder),
        params=mod.ParamSpace(
            min_x=[1e8, 1e14, 1.0, 1.0, 1e-11, 1.0, 1.0, 1e-30, 1e-30, 20.0, 20.0, 0.1, -0.5],
            max_x=[1e8, 1e16, 50.0, 50.0, 1e-9, 100.0, 100.0, 1e-28, 1e-28, 1000.0, 2000.0, 0.1, 0.5]),
        ic_flags=mod.IcFlags(time_cutoff=None),
        sim_flags=mod.SimFlags(num_points=8, seed=42),
        device=mod.DeviceConfig(chunk_per_device=8, n_devices=1, dtype="float64"),
        paths=mod.Paths(init_file=exc, observation_files=[obs],
                        out_dirs=[str(tmp_path / out)]),
        checkpoint=False)


def _spy(monkeypatch, cls, log):
    orig = cls.run_curve_offgrid

    @functools.wraps(orig)
    def wrapped(self, X, sim, ini_par, tables, schedule, *a, **k):
        log.append(tuple(schedule))
        return orig(self, X, sim, ini_par, tables, schedule, *a, **k)
    monkeypatch.setattr(cls, "run_curve_offgrid", wrapped)


def test_bayes_offgrid_matches_jax(tmp_path, monkeypatch):
    obs, exc = _write_offgrid(tmp_path)
    routes_t, routes_j = [], []
    _spy(monkeypatch, trunner.Runner, routes_t)
    _spy(monkeypatch, jrunner.ShardedRunner, routes_j)
    P_t, X_t, _ = tbayes(_config(tcfg, tmp_path, obs, exc, "TORCH"), device="cpu")
    monkeypatch.delenv("TRPL_HORIZON_INTERPRET", raising=False)
    P_j, X_j, _ = jbayes(_config(jcfg, tmp_path, obs, exc, "JAX"))
    assert len(routes_t) == len(routes_j) == 2 and routes_t == routes_j
    assert all(len(s) == 3 for s in routes_t)          # the ladder ran
    assert X_t.tobytes() == np.asarray(X_j).tobytes()
    assert P_t.shape == (1, 8) and np.isfinite(P_t).all()
    np.testing.assert_allclose(P_t, P_j, rtol=1e-6)


def test_single_phase_offgrid_runs(tmp_path, monkeypatch):
    obs, exc = _write_offgrid(tmp_path, num_curves=1)
    routes = []
    _spy(monkeypatch, trunner.Runner, routes)
    cfg = _config(tcfg, tmp_path, obs, exc, "SINGLE", ladder={})
    P, X, _ = tbayes(cfg, device="cpu")
    assert routes == [((1, 61),)]
    assert P.shape == (1, 8) and np.isfinite(P).all()
