"""The port's posterior CLI and explorer (bayesian_inference_trpl_tpu_torch/
posterior/cli.py, explorer.py) against the JAX package's, on the CPU, on
the same BAYRAN pair: the stats JSON within the tolerances of
tests/test_torch_posterior_stats.py (1e-12 relative; the fmin temperature
within 1e-6, and the statistics after it within 1e-6 too, since they are
taken at that temperature), both PNGs written, the headless
``ExplorerSession`` against JAX's, and the widget shell on Agg."""
import json
import os

import numpy as np
import pytest
import torch

from bayesian_inference_trpl_tpu.posterior import cli as jcli
from bayesian_inference_trpl_tpu.posterior import explorer as jexp
from bayesian_inference_trpl_tpu.utils.io import export
from bayesian_inference_trpl_tpu_torch.posterior import cli as tcli
from bayesian_inference_trpl_tpu_torch.posterior import explorer as texp
from bayesian_inference_trpl_tpu_torch.posterior.vizconfig import VizConfig, save_vizconfig

from test_torch_posterior_stats import RTOL, TF_RTOL, close, make_problem

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    """A BAYRAN pair of tests/test_torch_posterior_stats.py's problem."""
    d = tmp_path_factory.mktemp("bayran")
    LL, X = make_problem()
    export(str(d / "run"), LL, X)
    return str(d / "run")


def check_summary(port, ref, rtol):
    assert port.keys() == ref.keys()
    assert port["num_samples"] == ref["num_samples"] == 1997
    for k in ("temperature", "temperature_max_uncertainty"):
        if ref[k] is None:
            assert port[k] is None
        else:
            close(port[k], ref[k], rtol=TF_RTOL)
    close(port["ess"], ref["ess"], rtol=max(rtol, 0.01 / ref["ess"]))  # rounded to 0.01
    assert port["stats"].keys() == ref["stats"].keys()
    for p, s in ref["stats"].items():
        close(port["stats"][p]["mean"], s["mean"], rtol=rtol)
        close(port["stats"][p]["std"], s["std"], rtol=rtol)
        close(port["credible_95"][p], ref["credible_95"][p], rtol=rtol)


@pytest.mark.parametrize("t_factor,rtol", [("auto", TF_RTOL), ("points", RTOL),
                                           ("40", RTOL)])
def test_cli_matches_jax(result, tmp_path, capsys, t_factor, rtol):
    pytest.importorskip("matplotlib")
    outs = {}
    for name, main, extra in (("jax", jcli.main, []),
                              ("port", tcli.main, ["--device", "cpu"])):
        prefix = str(tmp_path / name / "post")
        assert main([result, "--out-prefix", prefix, "--bins", "24",
                     "--t-factor", t_factor, *extra]) == 0
        for suffix in ("_corner.png", "_cov.png"):
            assert os.path.getsize(prefix + suffix) > 10_000
        with open(prefix + "_stats.json") as f:
            outs[name] = json.load(f)
        printed = capsys.readouterr().out
        assert json.loads(printed[printed.index("{"):]) == outs[name]
    check_summary(outs["port"], outs["jax"], rtol)
    assert list(outs["port"]["stats"]) == ["p0", "B", "Sf", "Sb", "tau_n", "tau_p"]


def test_cli_with_viz_config_matches_jax(result, tmp_path):
    """A reference config.txt: its ranges cut samples, its enabled set
    picks the parameters, its thickness and observation count apply."""
    pytest.importorskip("matplotlib")
    cfg = VizConfig(do_log={"p0": True, "B": True}, ranges={"tau_n": (200.0, 800.0)},
                    enabled={"p0": True, "B": True, "tau_n": True, "tau_eff": True,
                             "mu_eff": True},
                    marks={"tau_n": 500.0}, thickness=400.0, num_observations=2)
    path = str(tmp_path / "config.txt")
    save_vizconfig(cfg, path)
    outs = {}
    for name, main, extra in (("jax", jcli.main, []),
                              ("port", tcli.main, ["--device", "cpu"])):
        prefix = str(tmp_path / name / "post")
        main([result, "--config", path, "--out-prefix", prefix, "--bins", "16",
              "--scatter-top-n", "20", "--t-factor", "points", *extra])
        with open(prefix + "_stats.json") as f:
            outs[name] = json.load(f)
    assert outs["port"]["num_samples"] == outs["jax"]["num_samples"] < 1997
    assert sorted(outs["port"]["stats"]) == sorted(cfg.enabled)
    check_summary(dict(outs["port"], num_samples=1997),
                  dict(outs["jax"], num_samples=1997), RTOL)


def test_report_is_headless_and_refuses_absent_cuda(result, monkeypatch):
    """report() needs no matplotlib; main refuses --device cuda without a
    card."""
    rep = tcli.report(result, t_factor="points", device="cpu")
    assert rep.params == ["p0", "B", "Sf", "Sb", "tau_n", "tau_p"]
    assert rep.data.P.device.type == "cpu" and rep.summary["temperature"] is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA requested"):
        tcli.main([result])


def sessions(result):
    from bayesian_inference_trpl_tpu.utils.io import load_bayran
    LL, X = load_bayran(result)
    return (texp.ExplorerSession(LL, X, num_observations=3, device="cpu"),
            jexp.ExplorerSession(LL, X, num_observations=3))


def test_explorer_session_matches_jax(result, tmp_path):
    t, j = sessions(result)
    assert vars(t.viz) == vars(j.viz)            # enabled, do_log, marks defaults
    for s in (t, j):
        s.set_enabled("mu_n", True)
        s.set_scale("tau_p", True)
        s.set_mark("tau_n", 500.0)
        s.set_range("tau_n", 300.0, 700.0)
        s.set_t_factor(2.0)
    assert t.enabled_params() == j.enabled_params()
    assert len(t.data.LL) == len(j.data.LL) < 1997
    close(t.data.P, j.data.P)
    assert t.stats_text("tau_n") == j.stats_text("tau_n")
    close(t.max_uncertainty("tau_n"), j.max_uncertainty("tau_n"), rtol=TF_RTOL)
    for s in (t, j):
        with pytest.raises(ValueError, match="exclude every sample"):
            s.set_range("tau_n", 5000.0, 6000.0)
        s.set_range("tau_n", np.nan, np.nan)     # cleared: every sample back
    assert len(t.data.LL) == len(j.data.LL) == 1997
    t.save_config(str(tmp_path / "t.txt"))
    j.save_config(str(tmp_path / "j.txt"))
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()


def test_explorer_widget_shell(result, tmp_path):
    """tests/test_explorer.py's walk through the widget callbacks, on Agg."""
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    session, _ = sessions(result)
    ex = texp.PosteriorExplorer(session, config_path=str(tmp_path / "cfg.txt"), bins=24)
    k0 = len(session.enabled_params())
    assert len(ex.plot_axes) == k0 * k0
    on_param = session.enabled_params()[0]
    ex._on_toggle(on_param)
    assert on_param not in ex.replot() and len(ex.plot_axes) == (k0 - 1) ** 2
    ex._on_select("tau_n")
    for w, v in ((ex.w_lo, "400"), (ex.w_hi, "600")):
        w.eventson = False
        w.set_val(v)
        w.eventson = True
    n_before = len(session.data.LL)
    ex._on_entries("600")
    assert len(session.data.LL) < n_before
    assert session.viz.ranges["tau_n"] == (400.0, 600.0)
    ex._on_select("Sf")
    ex._on_select("tau_n")
    assert session.viz.ranges["tau_n"] == (400.0, 600.0)
    pmax = float(session.data.P.max())
    ex._on_tfactor("80")
    assert float(session.data.P.max()) != pmax
    ex._update_stats()
    assert "tau_n" in ex._stats_artist.get_text()
    ex._on_cov(None)
    assert ex.mode == "cov" and len(ex.plot_axes) == 1
    ex._on_cov(None)
    assert ex.mode == "corner"
    ex._on_save(None)
    assert "400.0\t600.0" in (tmp_path / "cfg.txt").read_text()
    plt.close(ex.fig)
