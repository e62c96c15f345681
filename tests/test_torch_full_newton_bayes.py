"""bayes end to end with the full-Newton methods, on the CPU: the port's
``fused_horizon`` (the horizon kernel's full-Newton body, through its
plain version) and ``coupled_newton_pallas`` (the per-step Newton kernel,
through its plain version), on-grid and off-grid, on the synthetic files
that tests/test_torch_pipeline.py and tests/test_torch_offgrid.py write,
against JAX ``bayes`` with coupled_newton (its XLA scan, full Newton):
P within 1e-6 relative, X bitwise, the route taken named in the run log
and shown by the calls each path made.
"""
import logging

import numpy as np
import pytest
import torch

import test_torch_offgrid as off_grid
import test_torch_pipeline as on_grid
from bayesian_inference_trpl_tpu import config as jcfg
from bayesian_inference_trpl_tpu.pipeline import bayes as jbayes
from bayesian_inference_trpl_tpu_torch import config as tcfg
from bayesian_inference_trpl_tpu_torch.models import solver as tsolver
from bayesian_inference_trpl_tpu_torch.ops import horizon_kernel as thk
from bayesian_inference_trpl_tpu_torch.pipeline import SOLVER_ROUTES, bayes as tbayes

torch.set_num_threads(1)

# kind: (file writer, config builder, samples, the run log's observation
# route, phases per chunk-curve, BDF steps per chunk-curve, chunk-curves).
# On-grid: T = 64 on the ladder ((1, 16), (4, 16), (8, 32)); off-grid: the
# horizon cut to the last observation, 61 steps, ((1, 21), (4, 16), (8, 24)).
KINDS = {
    "on_grid": (on_grid._write_synthetic, on_grid._config, 16,
                "Observation times on simulation grid", 3, 16 + 4 + 4, 2 * 2),
    "off_grid": (off_grid._write_offgrid, off_grid._config, 8,
                 "Observation times off-grid", 3, 21 + 4 + 3, 1 * 2),
}


@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    """JAX bayes with coupled_newton per kind, run once for both methods."""
    cache = {}

    def get(kind):
        if kind not in cache:
            tmp = tmp_path_factory.mktemp(kind)
            write, config = KINDS[kind][:2]
            obs, exc = write(tmp)
            cfg = config(jcfg, tmp, obs, exc, "JAX")
            cfg.grid.method = "coupled_newton"
            P, X, _ = jbayes(cfg)
            cache[kind] = (tmp, obs, exc, np.asarray(P), np.asarray(X))
        return cache[kind]
    return get


@pytest.mark.parametrize("kind", ["on_grid", "off_grid"])
@pytest.mark.parametrize("method", ["fused_horizon", "coupled_newton_pallas"])
def test_bayes_full_newton_matches_jax(jax_reference, kind, method, caplog,
                                       monkeypatch):
    tmp, obs, exc, P_j, X_j = jax_reference(kind)
    _, config, n, obs_route, phases, steps, chunk_curves = KINDS[kind]
    horizon_calls, step_calls = [], []
    orig_horizon, orig_step = thk.horizon_chord, tsolver.newton_step

    def horizon(*args):
        horizon_calls.append(args[-1])
        return orig_horizon(*args)

    def step(*args, **kw):
        step_calls.append(args[0].shape)
        return orig_step(*args, **kw)
    monkeypatch.setattr(thk, "horizon_chord", horizon)
    monkeypatch.setattr(tsolver, "newton_step", step)

    cfg = config(tcfg, tmp, obs, exc, f"TORCH_{method}")
    cfg.grid.method = method
    logger = logging.getLogger("test_torch_full_newton_bayes")
    with caplog.at_level(logging.INFO, logger=logger.name):
        P_t, X_t, info = tbayes(cfg, logger=logger, device="cpu")
    assert info["device"] == "cpu"
    assert X_t.tobytes() == X_j.tobytes()
    assert P_t.shape == (1, n) and np.isfinite(P_t).all()
    np.testing.assert_allclose(P_t, P_j, rtol=1e-6)

    assert f"Solver method {method}: {SOLVER_ROUTES[method]}" in caplog.text
    assert obs_route in caplog.text
    if method == "fused_horizon":
        assert len(horizon_calls) == phases * chunk_curves and not step_calls
        assert not any(prm.chord for prm in horizon_calls)
        assert all(bool(prm.offgrid_k) == (kind == "off_grid") for prm in horizon_calls)
    else:
        assert len(step_calls) == steps * chunk_curves and not horizon_calls
