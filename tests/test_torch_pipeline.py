"""bayes end to end: the port against the JAX package on the same
synthetic files (written as tests/test_pipeline.py writes them), with the
main path's solver settings at test size: fused_horizon_chord, quadratic
predictor, a stride ladder, bucketed (masked) curves, float64.

The port runs its chord kernel's plain version (per-sample decisions, the
CUDA kernel's semantics); the JAX package runs its XLA scan reference
(full Newton per step, models/twophase._coarse_phase), because its Pallas
kernel in interpret mode inside the chunk program would take minutes to
compile.  Chord and full Newton accept iterates at the same residual
gates, so P agrees to the acceptance level: 1e-6 relative.  X is bitwise
identical and the port's BAYRAN pair loads with the JAX package's loader.
"""
import numpy as np
import torch

from bayesian_inference_trpl_tpu import config as jcfg
from bayesian_inference_trpl_tpu.pipeline import bayes as jbayes
from bayesian_inference_trpl_tpu.utils import io as jio
from bayesian_inference_trpl_tpu_torch import config as tcfg
from bayesian_inference_trpl_tpu_torch.pipeline import bayes as tbayes

torch.set_num_threads(1)

L, T, TIME = 128, 64, 1.6
LADDER = dict(fast_fine_steps=16, fast_coarse_stride=4, fast_max_stride=8,
              fast_steps_per_phase=4)          # ((1, 16), (4, 16), (8, 32))


def _write_synthetic(tmp_path, num_curves=2):
    dx = 311.0 / L
    xg = (np.arange(L) + 0.5) * dx
    exc = tmp_path / "exc.csv"
    obs = tmp_path / "obs.csv"
    with open(exc, "w") as f:
        for c in range(num_curves):
            dn = (0.5 + c) * 1e18 / 1e7 ** 3 * np.exp(-xg / 100.0)
            f.write(",".join(f"{v / 1e-21:.8e}" for v in dn) + "\n")
    rng = np.random.default_rng(5)
    t = np.arange(T + 1) * (TIME / T)
    with open(obs, "w") as f:
        for c in range(num_curves):
            pl = 2e-3 * (1 + c) * np.exp(-t / (3.0 + c)) * (1 + 0.01 * rng.standard_normal(T + 1))
            for ti, pi in zip(t, pl):
                f.write(f"{ti:.6f},{pi / 1e-23:.10e},1e13\n")
        f.write("END,,\n")
    return str(obs), str(exc)


def _config(mod, tmp_path, obs, exc, out):
    return mod.InferenceConfig(
        grid=mod.GridConfig(thickness=311.0, time=TIME, num_nodes=L, num_steps=T,
                            tol_exp=7, max_iters=8, method="fused_horizon_chord",
                            predictor="quadratic", step_tol=1e-9, **LADDER),
        params=mod.ParamSpace(
            min_x=[1e8, 1e14, 1.0, 1.0, 1e-11, 1.0, 1.0, 1e-30, 1e-30, 20.0, 20.0, 0.1, -0.5],
            max_x=[1e8, 1e16, 50.0, 50.0, 1e-9, 100.0, 100.0, 1e-28, 1e-28, 1000.0, 2000.0, 0.1, 0.5]),
        ic_flags=mod.IcFlags(time_cutoff=None),
        sim_flags=mod.SimFlags(num_points=16, seed=42),
        device=mod.DeviceConfig(chunk_per_device=8, n_devices=1, dtype="float64"),
        paths=mod.Paths(init_file=exc, observation_files=[obs],
                        out_dirs=[str(tmp_path / out)]),
        checkpoint=True)


def test_bayes_matches_jax(tmp_path, monkeypatch):
    obs, exc = _write_synthetic(tmp_path)
    P_t, X_t, info = tbayes(_config(tcfg, tmp_path, obs, exc, "TORCH"), device="cpu")
    assert info["device"] == "cpu"
    # The JAX package's XLA reference path (see module docstring).
    monkeypatch.delenv("TRPL_HORIZON_INTERPRET", raising=False)
    P_j, X_j, _ = jbayes(_config(jcfg, tmp_path, obs, exc, "JAX"))
    assert X_t.tobytes() == np.asarray(X_j).tobytes()
    assert P_t.shape == (1, 16) and np.isfinite(P_t).all()
    np.testing.assert_allclose(P_t, P_j, rtol=1e-6)
    P2, X2 = jio.load_bayran(str(tmp_path / "TORCH"))
    np.testing.assert_array_equal(P2, P_t[0])
    np.testing.assert_array_equal(X2, X_t)


def test_unported_branches_raise(tmp_path, monkeypatch):
    """The branches that raised NotImplementedError naming ROADMAP A13
    until the Gauss-Seidel scheme and the legacy grid sampler were ported
    now run on the CPU and match the JAX package: method gauss_seidel
    (max_iters 300: the reference scheme needs hundreds of sweeps on the
    first steps) within 1e-9, and random_sample = false (the legacy grid
    over three free dimensions) within this file's 1e-6; X bitwise."""
    obs, exc = _write_synthetic(tmp_path, num_curves=1)
    monkeypatch.delenv("TRPL_HORIZON_INTERPRET", raising=False)
    cases = [
        (dict(grid=dict(method="gauss_seidel", max_iters=300),
              sim_flags=dict(num_points=4)), 4, 1e-9),
        (dict(sim_flags=dict(random_sample=False, num_points=2)), 8, 1e-6),
    ]
    for i, (change, n, rtol) in enumerate(cases):
        out = []
        for mod, run in ((tcfg, lambda c: tbayes(c, device="cpu")), (jcfg, jbayes)):
            cfg = _config(mod, tmp_path, obs, exc, f"{mod.__name__}{i}")
            for k, v in change.items():
                for kk, vv in v.items():
                    setattr(getattr(cfg, k), kk, vv)
            if not cfg.sim_flags.random_sample:
                free = (2, 5, 9)
                cfg.params.max_x = [b if j in free else a for j, (a, b) in
                                    enumerate(zip(cfg.params.min_x, cfg.params.max_x))]
            out.append(run(cfg))
        (P_t, X_t, _), (P_j, X_j, _) = out
        assert X_t.tobytes() == np.asarray(X_j).tobytes()
        assert P_t.shape == (1, n) and np.isfinite(P_t).all()
        np.testing.assert_allclose(P_t, P_j, rtol=rtol)


def test_cli_runs_on_cpu(tmp_path):
    """python -m bayesian_inference_trpl_tpu_torch.run with --device cpu."""
    from bayesian_inference_trpl_tpu_torch import run
    obs, exc = _write_synthetic(tmp_path)
    cfg = _config(tcfg, tmp_path, obs, exc, "CLI")
    cfg.sim_flags.num_points = 4
    path = tmp_path / "cfg.toml"
    tcfg.save_config(cfg, str(path))
    assert run.main([str(path), "--device", "cpu", "--log-dir",
                     str(tmp_path / "Logs")]) == 0
    P, X = jio.load_bayran(str(tmp_path / "CLI"))
    assert P.shape == (4,) and X.shape == (4, 13) and np.isfinite(P).all()
