"""Posterior equivalence and the exact fixed-dt route of the port, on the
CPU, against the JAX package:

* ``compare_posteriors`` field for field equal to JAX's;
* ``bayes`` with no stride ladder and ``fused_horizon_chord`` (the horizon
  kernel's plain version in one stride-1 phase under the throughput chord
  profile, geometric predictor, float64) against JAX ``bayes`` with
  coupled_newton (its XLA scan; its Pallas kernel in interpret mode inside
  the chunk program would take minutes to compile): P within 1e-6
  relative, as tests/test_torch_pipeline.py holds the ladder;
* the port's ``posterior_equivalence.main`` on a tiny TOML.
"""
import json
import logging

import numpy as np
import pytest
import torch

import test_torch_pipeline as on_grid
from bayesian_inference_trpl_tpu import config as jcfg
from bayesian_inference_trpl_tpu.pipeline import bayes as jbayes
from bayesian_inference_trpl_tpu.tools import posterior_equivalence as jpe
from bayesian_inference_trpl_tpu_torch import config as tcfg
from bayesian_inference_trpl_tpu_torch.ops import horizon_kernel as thk
from bayesian_inference_trpl_tpu_torch.pipeline import bayes as tbayes
from bayesian_inference_trpl_tpu_torch.tools import posterior_equivalence as tpe

torch.set_num_threads(1)


def _posteriors(seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(3, 400))
    b = a + 0.05 * rng.normal(size=a.shape)
    a[0, ::37] = np.nan
    b[1, 5::41] = -np.inf
    a[2, :50] = np.round(a[2, :50], 1)       # ties
    b[2, :50] = np.round(b[2, :50], 1)
    b[2, 100:110] = a[2, 100:110]
    return a, b


@pytest.mark.parametrize("seed, top_frac", [(0, 0.01), (1, 0.05), (2, 0.2)])
def test_compare_posteriors_equals_jax(seed, top_frac):
    a, b = _posteriors(seed)
    rt = tpe.compare_posteriors(a, b, top_frac=top_frac)
    rj = jpe.compare_posteriors(a, b, top_frac=top_frac)
    assert rt == rj
    assert [r["finite_mismatch"] for r in rt][:2] != [0, 0]


def _exact_config(mod, tmp_path, obs, exc, out):
    """tests/test_torch_pipeline.py's configuration with no ladder and the
    exact mode's geometric predictor."""
    cfg = on_grid._config(mod, tmp_path, obs, exc, out)
    cfg.grid.fast_fine_steps = None
    cfg.grid.predictor = "geometric"
    return cfg


def test_exact_route_bayes_matches_jax(tmp_path, monkeypatch, caplog):
    obs, exc = on_grid._write_synthetic(tmp_path)
    calls = []
    orig = thk.horizon_chord

    def horizon(*args):
        calls.append(args[-1])
        return orig(*args)
    monkeypatch.setattr(thk, "horizon_chord", horizon)
    logger = logging.getLogger("test_torch_posterior")
    with caplog.at_level(logging.INFO, logger=logger.name):
        P_t, X_t, _ = tbayes(_exact_config(tcfg, tmp_path, obs, exc, "TORCH"),
                             logger=logger, device="cpu")
    assert (f"exact fixed-dt: one phase of {on_grid.T} steps, throughput chord "
            "profile") in caplog.text
    # One stride-1 launch per chunk and curve (16 samples in chunks of 8,
    # 2 curves), under the throughput chord knobs.
    assert len(calls) == 2 * 2
    for prm in calls:
        assert (prm.stride, prm.offgrid_k, prm.chord, prm.pred_order) == (1, 0, True, 3)
        assert (prm.settle_guard, prm.skip_tighten, prm.stall) == (
            thk.CHORD_SETTLE_GUARD, thk.CHORD_SKIP_TIGHTEN, thk.CHORD_STALL)

    monkeypatch.delenv("TRPL_HORIZON_INTERPRET", raising=False)
    cfg_j = _exact_config(jcfg, tmp_path, obs, exc, "JAX")
    cfg_j.grid.method = "coupled_newton"
    P_j, X_j, _ = jbayes(cfg_j)
    assert X_t.tobytes() == np.asarray(X_j).tobytes()
    assert P_t.shape == (1, 16) and np.isfinite(P_t).all()
    np.testing.assert_allclose(P_t, P_j, rtol=1e-6)


def test_posterior_equivalence_main_on_cpu(tmp_path, capsys):
    obs, exc = on_grid._write_synthetic(tmp_path)
    cfg = on_grid._config(tcfg, tmp_path, obs, exc, "PE")
    path = tmp_path / "pe.toml"
    tcfg.save_config(cfg, str(path))
    rc = tpe.main(["--config", str(path), "--num-samples", "16", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    rep = json.loads(out[-2])
    assert rc == 0 and rep["ok"] is True and out[-1].startswith("PASS")
    assert rep["device"] == "cpu" and rep["exact_method"] == "fused_horizon_chord"
    (row,) = rep["experiments"]
    assert row["n"] == 16 and row["finite_mismatch"] == 0
    assert row["spearman_rho"] >= 0.999
