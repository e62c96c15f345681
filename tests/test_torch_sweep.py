"""The port's verification tools (tools/sweep, run_sweep, compare, overlay,
corner_cache, nonconverged) against the JAX package's.

numpy parts bitwise: the sweep matrix and file, the oracle's result (the
same scipy integration of a copied right-hand side), the comparator's
errors, the corner cache's names and the non-converged report.  The solver
backend (models/driver.pvsim through the record route, its plain version on
the CPU) within 1e-12 of the JAX package's on the 2-sample, T = 200 sweep of
tests/test_tools.py, in every npz field but the ambipolar E (noise, held
absolutely).
"""
import os

import numpy as np
import pytest
import torch

from bayesian_inference_trpl_tpu.config import ParamSpace
from bayesian_inference_trpl_tpu.tools import compare as jcompare
from bayesian_inference_trpl_tpu.tools import corner_cache as jcorner
from bayesian_inference_trpl_tpu.tools import nonconverged as jnc
from bayesian_inference_trpl_tpu.tools import run_sweep as jrun
from bayesian_inference_trpl_tpu.tools import sweep as jsweep
from bayesian_inference_trpl_tpu_torch.tools import compare as tcompare
from bayesian_inference_trpl_tpu_torch.tools import corner_cache as tcorner
from bayesian_inference_trpl_tpu_torch.tools import nonconverged as tnc
from bayesian_inference_trpl_tpu_torch.tools import overlay as toverlay
from bayesian_inference_trpl_tpu_torch.tools import run_sweep as trun
from bayesian_inference_trpl_tpu_torch.tools import sweep as tsweep

torch.set_num_threads(1)

# tests/test_tools.py:15-20
SWEEP_ARGS = ["--mun", "3.89", "--mup", "3.89", "--B", "1e-10,1e-11", "--Sf", "1e3",
              "--Sb", "1e3", "--taun", "50", "--taup", "50", "--T", "200", "--time", "5",
              "--max-iters", "500", "--tol-exp", "7"]


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    d = tmp_path_factory.mktemp("sweep")
    files = {}
    for name, mod in (("jax", jsweep), ("port", tsweep)):
        files[name] = str(d / f"{name}.npz")
        mod.main([files[name], *SWEEP_ARGS])
    return {k: dict(np.load(f)) for k, f in files.items()}


def test_sweep_bitwise(sweeps):
    vals = [[1.0], [2.0, 3.0], [4.0, 5.0]] + [[0.0, 0.5]] * 9
    assert tsweep.make_sweep(vals).tobytes() == jsweep.make_sweep(vals).tobytes()
    j, t = sweeps["jax"], sweeps["port"]
    assert j.keys() == t.keys() and t["mat_par"].shape == (2, 12)
    for k in j:
        assert np.asarray(j[k]).tobytes() == np.asarray(t[k]).tobytes(), k


@pytest.fixture(scope="module")
def solver_results(sweeps):
    sw = sweeps["port"]
    return (jrun.run_solver(sw, "fused_horizon", "float64"),
            trun.run_solver(sw, "fused_horizon", "float64", device="cpu"))


def test_run_solver_matches_jax(solver_results):
    """mu_n == mu_p in this sweep: the transport is ambipolar, the true E is
    0 and both solvers' E is rounding noise (~1e-17 V/nm), held absolutely;
    tests/test_torch_segment.py holds a real field within 1e-12."""
    rj, rt = solver_results
    assert rj.keys() == rt.keys()
    assert rt["N"].shape == (2, 6, 128) and rt["pl"].shape == (2, 101)
    for k in rj:
        a, b = np.asarray(rt[k]), np.asarray(rj[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b)
        elif k == "E":
            # Noise against noise: absolute, 6 orders below the corner
            # gate's own ambipolar bound of 1e-9 V/nm.
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-15)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=0.0, err_msg=k)
    assert rt["converged"].all()


def test_run_sweep_cli_and_refusals(sweeps, tmp_path):
    """The CLI writes the npz keys of the JAX tool, with fused_horizon and
    with gauss_seidel (which raised naming ROADMAP A13 until it was
    ported; its values within 1e-10 of the JAX tool's, the ambipolar E
    held absolutely as above); without a card the default device raises
    (no fallback)."""
    sw = str(tmp_path / "sweep.npz")
    np.savez(sw, **dict(sweeps["port"], T=np.asarray(20)))
    out = str(tmp_path / "solver.npz")
    trun.main([sw, out, "--method", "fused_horizon", "--device", "cpu"])
    res = dict(np.load(out))
    assert set(res) == {"times", "N", "P", "E", "pl", "pl_times", "converged",
                        "mat_par", "length", "time", "L", "T"}
    # T 20: snapshots at steps 0, 2, 6 and 20 (1% and 3% round to 0).
    assert res["N"].shape == (2, 4, 128) and np.isfinite(res["pl"]).all()
    trun.main([sw, out, "--method", "gauss_seidel", "--device", "cpu"])
    gs = dict(np.load(out))
    ref = jrun.run_solver(dict(np.load(sw)), "gauss_seidel", "float64")
    assert set(gs) == set(res) and set(ref) <= set(gs)
    assert gs["converged"].all()
    for k in ref:
        a, b = np.asarray(gs[k]), np.asarray(ref[k])
        assert a.shape == b.shape, k
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-15 if k == "E" else 0.0,
                                       err_msg=k)
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            trun.main([sw, out, "--method", "fused_horizon"])


def test_run_oracle_bitwise(sweeps):
    one = dict(sweeps["port"], mat_par=sweeps["port"]["mat_par"][:1])
    rj = jrun.run_oracle(one, rtol=1e-4, atol=1e-8)
    rt = trun.run_oracle(one, rtol=1e-4, atol=1e-8)
    assert rj.keys() == rt.keys()
    for k in rj:
        assert np.asarray(rj[k]).tobytes() == np.asarray(rt[k]).tobytes(), k
    assert rt["E"].shape == (1, 6, 129)


def test_compare_and_overlay(solver_results, tmp_path):
    rj, rt = solver_results
    ref = dict(rj, N=rj["N"] * 1.01, E=np.concatenate([rj["E"], rj["E"][..., -1:]], -1),
               pl=rj["pl"][:, ::2], pl_times=rj["pl_times"][::2])
    for reduce in ("mean", "max", "none"):
        a, b = tcompare.field_errors(rt, ref, reduce), jcompare.field_errors(rt, ref, reduce)
        assert a.keys() == b.keys()
        for k in a:
            assert np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes(), (reduce, k)
    pytest.importorskip("matplotlib")
    png = str(tmp_path / "ov.png")
    toverlay.overlay_sample(rt, ref, 1, png)
    assert os.path.getsize(png) > 0


def test_corner_cache_names_and_shipped_files():
    for mat in ("corner_matrix", "e_corner_matrix"):
        m_t, m_j = getattr(tcorner, mat)(), getattr(jcorner, mat)()
        assert m_t.tobytes() == m_j.tobytes()
        sw_t, sw_j = tcorner.corner_sweep(m_t, tcorner.T0 * 4), jcorner.corner_sweep(m_j, 800)
        assert os.path.realpath(tcorner.cache_path(sw_t)) == \
            os.path.realpath(jcorner.cache_path(sw_j))
        data = tcorner.load_oracle(sw_t)
        assert data["N"].shape == (len(m_t), 6, 128) and data["pl"].shape == (len(m_t), 801)
    with pytest.raises(FileNotFoundError, match="corner_cache"):
        tcorner.load_oracle(tcorner.corner_sweep(tcorner.corner_matrix(), 123))


def test_nonconverged_bitwise_planted_corner():
    """tests/test_nonconverged.py:33's planted corner, through both tools."""
    rng = np.random.default_rng(1234)
    ps = ParamSpace()
    lo, hi = np.asarray(ps.min_x), np.asarray(ps.max_x)
    do_log = np.asarray(ps.do_log, bool)
    u = rng.uniform(size=(4096, 13))
    with np.errstate(divide="ignore"):
        la = np.log10(np.where(lo > 0, lo, 1.0))
        ha = np.log10(np.where(hi > 0, hi, 1.0))
    X = np.where(do_log, 10 ** (la + u * (ha - la)), lo + u * (hi - lo))
    bad = (u[:, 5] > 0.75) & (u[:, 9] < 0.2)
    P = np.zeros((3, len(X)))
    P[:, bad] = np.nan
    assert (tnc.axis_positions(X, ps.min_x, ps.max_x, ps.do_log).tobytes()
            == jnc.axis_positions(X, ps.min_x, ps.max_x, ps.do_log).tobytes())
    rep_t = tnc.characterize(X, P, ps.min_x, ps.max_x, ps.do_log, z_threshold=5.0)
    assert rep_t == jnc.characterize(X, P, ps.min_x, ps.max_x, ps.do_log, z_threshold=5.0)
    assert "Sf:top" in rep_t["signature"] and "tau_n:bottom" in rep_t["signature"]
