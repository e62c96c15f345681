"""The interpolation fallback end to end: the port's ``bayes`` against JAX
``bayes`` on the same synthetic files, float64, for every way a curve
reaches it (mirroring tests/test_pipeline.py:111, tests/test_uncertainty.py:124
and tests/test_sharding.py:191/:210).

The port records the PL trace with its horizon kernel's full-Newton
stride-1 body (the plain version on the CPU); the JAX package runs its
coupled_newton XLA scan, which that body equals step for step.  P agrees
within 1e-6 relative with the same NaN pattern, X is bitwise identical,
and both take the interpolation route for every curve.  The cases share
one JAX chunk program (two experiments of 16 points, pl_stride 1, log_pl
true); tests/test_torch_interp_bayes_statics.py has the two that change
its static arguments.
"""
import functools

import numpy as np
import torch

from bayesian_inference_trpl_tpu import config as jcfg
from bayesian_inference_trpl_tpu.parallel import runner as jrunner
from bayesian_inference_trpl_tpu.pipeline import bayes as jbayes
from bayesian_inference_trpl_tpu_torch import config as tcfg
from bayesian_inference_trpl_tpu_torch.parallel import runner as trunner
from bayesian_inference_trpl_tpu_torch.pipeline import bayes as tbayes

torch.set_num_threads(1)

L, T, TIME = 32, 64, 1.6
NPTS = 16                       # points per curve (t = 0 first)
LOG_TIMES = np.concatenate([[0.0], np.geomspace(0.7 * TIME / T, 0.95 * TIME, NPTS - 1)])


def write_inputs(tmp_path, times, num_curves=2, sigma=None, seed=5):
    """Excitations for ``num_curves`` curves and one observation file per
    entry of ``times`` (each the same times for every curve); ``sigma``
    per file an array of point uncertainties (default 1e13, unused unless
    sim_flags.use_uncertainty).  Returns (obs files, excitation file)."""
    dx = 311.0 / L
    xg = (np.arange(L) + 0.5) * dx
    exc = tmp_path / "exc.csv"
    with open(exc, "w") as f:
        for c in range(num_curves):
            dn = (0.5 + c) * 1e18 / 1e7 ** 3 * np.exp(-xg / 100.0)
            f.write(",".join(f"{v / 1e-21:.8e}" for v in dn) + "\n")
    rng = np.random.default_rng(seed)
    files = []
    for k, t in enumerate(times):
        path = tmp_path / f"obs{k}.csv"
        sig = ["1e13"] * len(t) if sigma is None else [f"{s:.6e}" for s in sigma[k]]
        with open(path, "w") as f:
            for c in range(num_curves):
                pl = (2e-3 * (1 + c + k) * np.exp(-t / (3.0 + c))
                      * (1 + 0.01 * rng.standard_normal(t.size)))
                for ti, pi, si in zip(t, pl, sig):
                    f.write(f"{float(ti)!r},{pi / 1e-23:.10e},{si}\n")
            f.write("END,,\n")
        files.append(str(path))
    return files, str(exc)


def make_config(mod, tmp_path, obs, exc, out, grid=None, sim_flags=None,
                checkpoint=False):
    g = dict(thickness=311.0, time=TIME, num_nodes=L, num_steps=T, tol_exp=7,
             max_iters=8, method="fused_horizon_chord", predictor="quadratic",
             step_tol=1e-9, fast_fine_steps=16, fast_coarse_stride=4,
             fast_max_stride=8, fast_steps_per_phase=4)
    g.update(grid or {})
    sf = dict(num_points=8, seed=42)
    sf.update(sim_flags or {})
    return mod.InferenceConfig(
        grid=mod.GridConfig(**g),
        params=mod.ParamSpace(
            min_x=[1e8, 1e14, 1.0, 1.0, 1e-11, 1.0, 1.0, 1e-30, 1e-30, 20.0, 20.0, 0.1, -0.5],
            max_x=[1e8, 1e16, 50.0, 50.0, 1e-9, 100.0, 100.0, 1e-28, 1e-28, 1000.0, 2000.0, 0.1, 0.5]),
        ic_flags=mod.IcFlags(time_cutoff=None),
        sim_flags=mod.SimFlags(**sf),
        device=mod.DeviceConfig(chunk_per_device=4, n_devices=1, dtype="float64"),
        paths=mod.Paths(init_file=exc, observation_files=obs,
                        out_dirs=[str(tmp_path / out)]),
        checkpoint=checkpoint)


def sample_matrix(cfg):
    """X as the port's bayes draws it for ``cfg`` (tau_n in ns)."""
    from bayesian_inference_trpl_tpu_torch.utils import sampling
    min_x, max_x = cfg.params.bounds_converted()
    return sampling.make_grid(1, min_x, max_x, cfg.params.do_log, cfg.sim_flags.as_dict(),
                              rng=np.random.RandomState(cfg.sim_flags.seed))[2]


def spy_interp(monkeypatch, cls, log):
    orig = cls.run_curve_interp

    @functools.wraps(orig)
    def wrapped(self, X, sim, *a, **k):
        log.append((sim.T, sim.pl_stride))
        return orig(self, X, sim, *a, **k)
    monkeypatch.setattr(cls, "run_curve_interp", wrapped)


def compare_with_jax(tmp_path, monkeypatch, obs, exc, num_curves=2, **kw):
    """Run both packages' bayes; assert the interpolation route for every
    curve, X bitwise, P within 1e-6 with the same NaN pattern.  Returns
    the port's P."""
    routes_t, routes_j = [], []
    spy_interp(monkeypatch, trunner.Runner, routes_t)
    spy_interp(monkeypatch, jrunner.ShardedRunner, routes_j)
    P_t, X_t, _ = tbayes(make_config(tcfg, tmp_path, obs, exc, "TORCH", **kw),
                         device="cpu")
    monkeypatch.delenv("TRPL_HORIZON_INTERPRET", raising=False)
    P_j, X_j, _ = jbayes(make_config(jcfg, tmp_path, obs, exc, "JAX", **kw))
    assert len(routes_t) == num_curves and routes_t == routes_j
    assert X_t.tobytes() == np.asarray(X_j).tobytes()
    np.testing.assert_array_equal(np.isnan(P_t), np.isnan(P_j))
    np.testing.assert_allclose(P_t, P_j, rtol=1e-6)
    return P_t


def test_offgrid_fused_false(tmp_path, monkeypatch):
    obs, exc = write_inputs(tmp_path, [LOG_TIMES, LOG_TIMES])
    P = compare_with_jax(tmp_path, monkeypatch, obs, exc,
                         grid=dict(offgrid_fused=False))
    assert np.isfinite(P).all()


def test_use_uncertainty(tmp_path, monkeypatch):
    """sigma weights 1/sigma^2 ride the interpolation mask (a 0 and a NaN
    sigma get weight 1)."""
    rng = np.random.default_rng(3)
    sigma = [rng.uniform(0.5, 2.0, NPTS) * 1e-3 for _ in range(2)]
    sigma[0][3], sigma[1][5] = 0.0, np.nan
    obs, exc = write_inputs(tmp_path, [LOG_TIMES, LOG_TIMES], sigma=sigma)
    P = compare_with_jax(tmp_path, monkeypatch, obs, exc,
                         grid=dict(offgrid_fused=False),
                         sim_flags=dict(use_uncertainty=True))
    assert np.isfinite(P).all()


def test_time_beyond_horizon_poisons_its_row(tmp_path, monkeypatch):
    """An observation time past the simulated horizon interpolates to NaN
    (the reference's griddata semantics): that experiment's row is NaN,
    the other's finite.  The slot tables refuse such a curve, so it falls
    back with offgrid_fused left on."""
    late = LOG_TIMES.copy()
    late[-1] = 1.25 * TIME
    obs, exc = write_inputs(tmp_path, [LOG_TIMES, late])
    P = compare_with_jax(tmp_path, monkeypatch, obs, exc)
    assert np.isfinite(P[0]).all() and np.isnan(P[1]).all()


def test_duplicate_t0_falls_back(tmp_path, monkeypatch):
    """A second point within rounding of t = 0 makes the slot tables
    refuse the curve (duplicate t=0); it falls back to interpolation."""
    dup = LOG_TIMES.copy()
    dup[1] = 1e-12
    obs, exc = write_inputs(tmp_path, [dup, LOG_TIMES])
    P = compare_with_jax(tmp_path, monkeypatch, obs, exc)
    assert np.isfinite(P).all()
