"""A thickness per curve (the reference's two-thickness scan, BASELINE.json
config #5) in the port, on tests/test_twothick.py's synthetic two-curve
problem (L 128, T 20, curves at 311 and 622 nm, observations made by the
solver at the TRUE parameters).

The port's ``bayes`` against JAX ``bayes`` on the same files, float64:
X bitwise, P within 1e-6 relative, on the route that problem takes (its
observation times on the simulation grid: the fused likelihood of the
default coupled_newton step loop) and on the interpolation route (the
same curves at log-spaced times with ``offgrid_fused = false``).  Then
that file's truth-recovery and wrong-uniform-thickness assertions on the
port alone.
"""
import numpy as np
import pytest
import torch

import test_twothick as jtt
from test_torch_interp_bayes import spy_interp
from bayesian_inference_trpl_tpu import config as jcfg
from bayesian_inference_trpl_tpu.parallel import runner as jrunner
from bayesian_inference_trpl_tpu.pipeline import bayes as jbayes
from bayesian_inference_trpl_tpu_torch import config as tcfg
from bayesian_inference_trpl_tpu_torch import physics
from bayesian_inference_trpl_tpu_torch.models.driver import SimParams, pvsim
from bayesian_inference_trpl_tpu_torch.parallel import runner as trunner
from bayesian_inference_trpl_tpu_torch.pipeline import bayes as tbayes

torch.set_num_threads(1)

TRUE_X = [jtt.TRUE[k] for k in ("n0", "p0", "mun", "mup", "B", "Sf", "Sb", "CN", "CP",
                                "taun", "taup", "lam")] + [0.0]
# The interpolation route's observation times: t = 0 and 15 log-spaced
# times, none on the dt grid.
LOG_TIMES = np.concatenate([[0.0], np.geomspace(0.7 * jtt.TIME / jtt.T, 0.95 * jtt.TIME, 15)])


def _cfg(mod, tmp_path, obs, exc, thickness, out, n_points=16, grid=None):
    """tests/test_twothick.py's configuration, float64 in both packages."""
    cfg = jtt._cfg(tmp_path, obs, exc, thickness, n_points)
    g = dict(thickness=thickness, time=jtt.TIME, num_nodes=jtt.L, num_steps=jtt.T,
             pl_stride=1, tol_exp=7, max_iters=2000)
    g.update(grid or {})
    return mod.InferenceConfig(
        grid=mod.GridConfig(**g),
        params=mod.ParamSpace(min_x=list(cfg.params.min_x), max_x=list(cfg.params.max_x),
                              do_log=list(cfg.params.do_log)),
        ic_flags=mod.IcFlags(time_cutoff=None),
        sim_flags=mod.SimFlags(num_points=n_points, seed=42),
        device=mod.DeviceConfig(chunk_per_device=4, n_devices=2, dtype="float64"),
        paths=mod.Paths(init_file=exc, observation_files=[obs],
                        out_dirs=[str(tmp_path / out)]),
        checkpoint=False)


def _write_offgrid(tmp_path, exc):
    """The same two curves (the port's pvsim at TRUE, each at its own
    thickness), linearly interpolated at LOG_TIMES."""
    profiles = np.loadtxt(exc, delimiter=",", ndmin=2) * 1e-21
    mat = np.asarray(TRUE_X[:12])[None] * physics.UNIT_CONVERSIONS[:12]
    path = tmp_path / "obs_offgrid.csv"
    with open(path, "w") as f:
        for dn, thick in zip(profiles, jtt.THICKS):
            sim = SimParams(length=thick, time=jtt.TIME, L=jtt.L, T=jtt.T, pl_stride=1,
                            tol_exp=7, max_iters=2000)
            pl = pvsim(mat, sim, dn, dtype=torch.float64, device="cpu").pl[0].numpy()
            for ti, pi in zip(LOG_TIMES, np.interp(LOG_TIMES, sim.pl_times, pl)):
                f.write(f"{float(ti)!r},{pi / 1e-23:.10e},1e13\n")
        f.write("END,,\n")
    return str(path)


@pytest.fixture(scope="module")
def twothick(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("twothick")
    obs, exc = jtt._write_twothick(tmp_path)
    return tmp_path, obs, exc


@pytest.mark.parametrize("route", ["on_grid", "interp"])
def test_twothick_matches_jax(twothick, monkeypatch, route):
    tmp_path, obs, exc = twothick
    grid = None
    routes_t, routes_j = [], []
    if route == "interp":
        obs = _write_offgrid(tmp_path, exc)
        grid = dict(offgrid_fused=False)
        spy_interp(monkeypatch, trunner.Runner, routes_t)
        spy_interp(monkeypatch, jrunner.ShardedRunner, routes_j)
    P_t, X_t, _ = tbayes(_cfg(tcfg, tmp_path, obs, exc, list(jtt.THICKS), "T_" + route,
                              grid=grid), device="cpu")
    P_j, X_j, _ = jbayes(_cfg(jcfg, tmp_path, obs, exc, list(jtt.THICKS), "J_" + route,
                              grid=grid))
    assert routes_t == routes_j == ([(jtt.T, 1)] * 2 if route == "interp" else [])
    assert X_t.tobytes() == np.asarray(X_j).tobytes()
    assert P_t.shape == (1, 16) and np.isfinite(P_t).all()
    np.testing.assert_allclose(P_t, P_j, rtol=1e-6)
    if route == "on_grid":
        # tests/test_twothick.py's posterior peak, on the port alone.
        d_true = (np.log10(X_t[:, 1] / jtt.TRUE["p0"]) ** 2
                  + np.log10(X_t[:, 4] / jtt.TRUE["B"]) ** 2)
        assert P_t[0, d_true.argmin()] >= np.sort(P_t[0])[-3]


def test_twothick_true_params_recovered(twothick):
    """At the generating parameters both curves' likelihoods are ~0 when
    each curve is simulated at its own thickness."""
    tmp_path, obs, exc = twothick
    cfg = _cfg(tcfg, tmp_path, obs, exc, list(jtt.THICKS), "T_true", n_points=2)
    cfg.params.min_x = cfg.params.max_x = list(TRUE_X)
    P, _, _ = tbayes(cfg, device="cpu")
    assert np.all(P > -1e-8), P


def test_twothick_wrong_thickness_scores_worse(twothick):
    """A uniform thickness (wrong for curve 2) scores the true parameters
    clearly worse."""
    tmp_path, obs, exc = twothick
    cfg = _cfg(tcfg, tmp_path, obs, exc, jtt.THICKS[0], "T_wrong", n_points=2)
    cfg.params.min_x = cfg.params.max_x = list(TRUE_X)
    P_wrong, _, _ = tbayes(cfg, device="cpu")
    assert np.all(P_wrong < -1.0), P_wrong
