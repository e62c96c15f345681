"""The legacy coarse-grid sampler (utils/sampling.index_grid, param_grid,
refine_grid and make_grid's random_sample = false branch) bitwise against
the JAX package, ``bayes`` end to end with it and the Gauss-Seidel scheme
against JAX ``bayes``, and the bound on Gauss-Seidel against full Newton
that chip_smoke.py's main_gauss_seidel holds the port to on the card.
"""
import numpy as np
import pytest
import torch

from bayesian_inference_trpl_tpu import config as jcfg
from bayesian_inference_trpl_tpu.pipeline import bayes as jbayes
from bayesian_inference_trpl_tpu.utils import sampling as jsamp
from bayesian_inference_trpl_tpu_torch import config as tcfg
from bayesian_inference_trpl_tpu_torch import physics
from bayesian_inference_trpl_tpu_torch.pipeline import bayes as tbayes
from bayesian_inference_trpl_tpu_torch.utils import sampling as tsamp

torch.set_num_threads(1)

# chip_smoke.py's sample box (MIN_X / MAX_X / DO_LOG): 10 free dimensions.
MIN_X = [1e8, 1e14, 0.0, 0.0, 1e-11, 0.1, 0.1, 1e-30, 1e-30, 1.0, 1.0, 0.1, 0.0]
MAX_X = [1e8, 1e16, 50.0, 50.0, 1e-9, 100.0, 100.0, 1e-28, 1e-28, 1000.0, 2000.0, 0.1, 0.0]
DO_LOG = [1, 1, 0, 0, 1, 1, 1, 1, 1, 0, 0, 1, 0]

# The relative P difference between Gauss-Seidel and full Newton that
# main_gauss_seidel allows (chip_smoke.GS_P_RTOL): ten times the JAX
# package's largest difference between gauss_seidel and coupled_newton at
# main_gauss_seidel's settings on a 16-sample sub-box of its grid, rounded
# up to a power of ten (test_gauss_seidel_p_bound_from_jax).
GS_P_RTOL = 1e-5
GS_T = 640                       # main_gauss_seidel's horizon (chip_smoke.GS_T)


def _bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("refs", [
    [[3, 3, 1]],
    [[2, 2], [3, 1]],
    [[2, 3, 2], [2, 1, 2], [1, 2, 2]],
])
def test_legacy_grid_functions_bitwise(refs):
    """refine_grid, index_grid and param_grid over one to three levels of
    refinement, equal to the JAX package's bit for bit."""
    refs = [np.array(r) for r in refs]
    N = np.array([0])
    for level, ref in enumerate(refs):
        Nt, Nj = tsamp.refine_grid(N, ref), jsamp.refine_grid(N, ref)
        _bitwise(Nt, Nj)
        N = Nt[::2] if level < len(refs) - 1 else Nt
    ind = tsamp.index_grid(N, refs)
    _bitwise(ind, jsamp.index_grid(N, refs))
    M = len(refs[0])
    min_x = np.array([1.0, 10.0, 0.0, 5.0][:M])
    max_x = np.array([2.0, 1000.0, 50.0, 5.0][:M])
    for do_log in (np.zeros(M, int), np.array([0, 1, 1, 0][:M])):
        _bitwise(tsamp.param_grid(ind, refs, min_x, max_x, do_log),
                 jsamp.param_grid(ind, refs, min_x, max_x, do_log))


@pytest.mark.parametrize("case", ["3x3x1", "chip_box", "chip_box_overrides"])
def test_make_grid_legacy_bitwise(case):
    """tests/test_sampling.py:75's 3 x 3 x 1 grid, and chip_smoke.py's box
    at num_points = 2 (the 1,024 samples of main_gauss_seidel)."""
    if case == "3x3x1":
        args = (np.array([1.0, 10.0, 5.0]), np.array([2.0, 1000.0, 5.0]),
                np.array([0, 1, 0]))
        flags, n = dict(random_sample=False, num_points=3), 9
    else:
        uc = physics.UNIT_CONVERSIONS
        args = (np.asarray(MIN_X) * uc, np.asarray(MAX_X) * uc, DO_LOG)
        flags, n = dict(random_sample=False, num_points=2), 1024
        if case == "chip_box_overrides":
            flags.update(override_equal_mu=True, override_equal_s=True,
                         override_equal_auger=True)
    Nt, Pt, Xt = tsamp.make_grid(2, *args, flags)
    Nj, Pj, Xj = jsamp.make_grid(2, *args, flags)
    assert Xt.shape == (n, len(args[0])) and Pt.shape == (2, n)
    _bitwise(Xt, Xj)
    _bitwise(Nt, Nj)
    _bitwise(Pt, Pj)


# ---------------------------------------------------------------------------
# bayes end to end
# ---------------------------------------------------------------------------

def _write_inputs(tmp_path, L, T, time_ns):
    """One exp-shaped excitation curve and one bi-exponential decay on the
    dt grid, written as chip_smoke.py writes them."""
    xg = (np.arange(L) + 0.5) * (311.0 / L)
    exc = tmp_path / "exc.csv"
    obs = tmp_path / "obs.csv"
    exc.write_text(",".join(f"{v / 1e-21:.8e}" for v in
                            0.5e18 / 1e7 ** 3 * np.exp(-xg / 100.0)) + "\n")
    t = np.arange(T + 1) * (time_ns / T)
    rng = np.random.default_rng(43)
    pl = 1e-4 * (0.6 * np.exp(-t / 15.0) + 0.4 * np.exp(-t / 400.0))
    pl = pl * (1.0 + 0.02 * rng.standard_normal(t.size))
    obs.write_text("".join(f"{a:.6f},{b / 1e-23:.10e},1e13\n" for a, b in zip(t, pl))
                   + "END,,\n")
    return str(obs), str(exc)


def _config(mod, tmp_path, out, obs, exc, L, T, time_ns, method, free, ladder=None):
    """main_gauss_seidel's settings (float64, tol 1e-7, the previous-state
    predictor, max_iters 256, step_tol off) on the legacy grid at
    num_points = 2 over the ``free`` dimensions of chip_smoke.py's box;
    every other dimension pinned at its lower cell centre of that grid."""
    lo, hi = [], []
    for i, (a, b, lg) in enumerate(zip(MIN_X, MAX_X, DO_LOG)):
        if i in free or a == b:
            lo.append(a)
            hi.append(b)
        else:
            c = a * (b / a) ** 0.25 if lg and a > 0 else a + 0.25 * (b - a)
            lo.append(c)
            hi.append(c)
    return mod.InferenceConfig(
        grid=mod.GridConfig(thickness=311.0, time=time_ns, num_nodes=L, num_steps=T,
                            tol_exp=7, max_iters=256, method=method, predictor="previous",
                            **(ladder or {})),
        params=mod.ParamSpace(min_x=lo, max_x=hi, do_log=DO_LOG),
        ic_flags=mod.IcFlags(time_cutoff=2000.0),
        sim_flags=mod.SimFlags(random_sample=False, num_points=2, seed=42),
        device=mod.DeviceConfig(chunk_per_device=2 ** len(free), n_devices=1,
                                dtype="float64"),
        paths=mod.Paths(init_file=exc, observation_files=[obs],
                        out_dirs=[str(tmp_path / out)]),
        checkpoint=False)


def test_bayes_gauss_seidel_legacy_grid_matches_jax(tmp_path, monkeypatch):
    """gauss_seidel and random_sample = false through bayes on a short
    ladder (L 32, 24 steps, 8 samples): X bitwise, P within 1e-9."""
    L, T, time_ns = 32, 24, 0.6
    obs, exc = _write_inputs(tmp_path, L, T, time_ns)
    ladder = dict(fast_fine_steps=8, fast_coarse_stride=2, fast_max_stride=4,
                  fast_steps_per_phase=4)
    kw = dict(L=L, T=T, time_ns=time_ns, method="gauss_seidel", free=(2, 5, 9),
              ladder=ladder)
    P_t, X_t, info = tbayes(_config(tcfg, tmp_path, "T", obs, exc, **kw), device="cpu")
    monkeypatch.delenv("TRPL_HORIZON_INTERPRET", raising=False)
    P_j, X_j, _ = jbayes(_config(jcfg, tmp_path, "J", obs, exc, **kw))
    _bitwise(X_t, X_j)
    assert P_t.shape == (1, 8) and np.isfinite(P_t).all()
    np.testing.assert_allclose(P_t, np.asarray(P_j), rtol=1e-9, atol=0)
    assert info["launches"] == {}


def test_gauss_seidel_p_bound_from_jax(tmp_path, monkeypatch):
    """The JAX package's gauss_seidel against its coupled_newton (the full
    Newton step of fused_horizon, which the port's kernel follows within
    1e-12, C7) at main_gauss_seidel's settings: L 128, dt 25 ps, GS_T
    steps, on 16 samples of its grid (mu_n, mu_p, tau_n, tau_p free).  The
    largest relative P difference, times ten and rounded up to a power of
    ten, is GS_P_RTOL."""
    L, time_ns = 128, 0.025 * GS_T
    obs, exc = _write_inputs(tmp_path, L, GS_T, time_ns)
    monkeypatch.delenv("TRPL_HORIZON_INTERPRET", raising=False)
    P = {}
    for method in ("gauss_seidel", "coupled_newton"):
        P[method], _, _ = jbayes(_config(jcfg, tmp_path, method, obs, exc, L=L, T=GS_T,
                                         time_ns=time_ns, method=method,
                                         free=(2, 3, 9, 10)))
    a, b = np.asarray(P["gauss_seidel"]), np.asarray(P["coupled_newton"])
    assert np.isfinite(a).all() and np.isfinite(b).all()
    rel = float(np.max(np.abs(a - b) / np.abs(b)))
    assert 0.0 < rel
    assert GS_P_RTOL == 10.0 ** np.ceil(np.log10(10.0 * rel)), rel
