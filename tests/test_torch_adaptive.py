"""Adaptive tau routing (grid.adaptive_fine_tau) in the port: samples with
tau_n below the threshold run a finer ladder, the rest the configured one,
in two passes over one curve (mirroring tests/test_adaptive.py).

* ``_adaptive_split`` gives the JAX package's indices and SimParams;
* routed ``bayes`` equals the per-bucket runs bit for bit (per-sample
  Newton decisions: a sample's result does not depend on its chunk-mates);
* routed ``bayes`` with coupled_newton against JAX routed ``bayes`` on
  two-phase ladders: P within 1e-6 relative.
"""
import dataclasses

import numpy as np
import pytest
import torch

from bayesian_inference_trpl_tpu import config as jcfg
from bayesian_inference_trpl_tpu import pipeline as jpipe
from bayesian_inference_trpl_tpu.models.driver import SimParams as JSimParams
from bayesian_inference_trpl_tpu_torch import config as tcfg
from bayesian_inference_trpl_tpu_torch import pipeline as tpipe
from bayesian_inference_trpl_tpu_torch.models.driver import SimParams as TSimParams

from test_torch_interp_bayes import T, TIME, make_config, sample_matrix, write_inputs

torch.set_num_threads(1)

ON_GRID = np.arange(T + 1) * (TIME / T)
# Two-phase ladders: the bulk's ((1, 16), (4, 48)), the fine bucket's
# ((1, 32), (2, 32)).
LADDER = dict(fast_fine_steps=16, fast_coarse_stride=4, fast_max_stride=4,
              fast_steps_per_phase=4, adaptive_fine_steps=40, adaptive_max_stride=2)
FINE_LADDER = dict(LADDER, fast_fine_steps=32, fast_max_stride=2)


@pytest.mark.parametrize("case", ["routed", "off", "no_ladder", "empty_bucket"])
def test_adaptive_split_matches_jax(tmp_path, case):
    obs, exc = write_inputs(tmp_path, [ON_GRID], num_curves=1)
    kw = dict(length=311.0, time=TIME, L=128, T=T, tol_exp=7.0, max_iters=8,
              method="fused_horizon_chord", predictor="quadratic", step_tol=1e-9,
              fast_fine_steps=16, fast_coarse_stride=4, fast_max_stride=8,
              fast_steps_per_phase=4)
    if case == "no_ladder":
        kw["fast_fine_steps"] = None
    X = sample_matrix(make_config(tcfg, tmp_path, obs, exc, "X",
                                   sim_flags=dict(num_points=32)))
    tau = {"routed": float(np.median(X[:, 9])), "off": None, "no_ladder": 100.0,
           "empty_bucket": float(X[:, 9].min())}[case]
    got, want = (
        mod._adaptive_split(make_config(cmod, tmp_path, obs, exc, "X",
                                        grid=dict(adaptive_fine_tau=tau,
                                                  adaptive_fine_steps=24,
                                                  adaptive_max_stride=4)),
                            sp(**kw), X)
        for mod, cmod, sp in ((tpipe, tcfg, TSimParams), (jpipe, jcfg, JSimParams)))
    if case != "routed":
        assert got is None and want is None
        return
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert len(got[1]) == 16
    assert dataclasses.asdict(got[2]) == dataclasses.asdict(want[2])
    assert (got[2].fast_fine_steps, got[2].fast_max_stride) == (24, 4)


def test_routed_bayes_equals_per_bucket_runs(tmp_path):
    obs, exc = write_inputs(tmp_path, [ON_GRID])
    sf = dict(num_points=16)

    def run(out, grid):
        return tpipe.bayes(make_config(tcfg, tmp_path, obs, exc, out, grid=grid,
                                       sim_flags=sf), device="cpu")
    P_bulk, X, _ = run("B", LADDER)
    P_fine, X2, _ = run("F", FINE_LADDER)
    tau = float(np.median(X[:, 9]))
    P_ad, X3, _ = run("A", dict(LADDER, adaptive_fine_tau=tau))
    assert X.tobytes() == X2.tobytes() == X3.tobytes()
    fine = X[:, 9] < tau
    assert 0 < fine.sum() < len(X)
    assert P_ad[:, ~fine].tobytes() == P_bulk[:, ~fine].tobytes()
    assert P_ad[:, fine].tobytes() == P_fine[:, fine].tobytes()
    assert not np.allclose(P_bulk[:, fine], P_fine[:, fine], rtol=1e-9, atol=0)


def test_routed_bayes_matches_jax(tmp_path, monkeypatch):
    obs, exc = write_inputs(tmp_path, [ON_GRID])
    sf = dict(num_points=12)
    X = sample_matrix(make_config(tcfg, tmp_path, obs, exc, "X", sim_flags=sf))
    grid = dict(LADDER, method="coupled_newton", adaptive_fine_tau=float(np.median(X[:, 9])))
    P_t, X_t, _ = tpipe.bayes(make_config(tcfg, tmp_path, obs, exc, "T", grid=grid,
                                          sim_flags=sf), device="cpu")
    monkeypatch.delenv("TRPL_HORIZON_INTERPRET", raising=False)
    P_j, X_j, _ = jpipe.bayes(make_config(jcfg, tmp_path, obs, exc, "J", grid=grid,
                                          sim_flags=sf))
    assert X_t.tobytes() == np.asarray(X_j).tobytes()
    assert np.isfinite(P_t).all()
    np.testing.assert_allclose(P_t, P_j, rtol=1e-6)
