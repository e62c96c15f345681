"""Corner-sweep parity gate on the card: the port's solver against the
independent scipy-BDF oracle (models/oracle.py) over the Cartesian corners
of the production parameter box, with the E-field gates derived from
dt-refinement.  tests/test_corner_gate.py's two tests, bounds as there,
through the port's tools/run_sweep.run_solver on ``cuda`` with the method
``fused_horizon``: one record launch of the horizon kernel per refinement
level, recording the PL trace and the state snapshots.

The oracle results ship with the repo (tools/corner_cache.load_oracle
reads them from the JAX package's tools/exact_cache/ as data files).
Needs an NVIDIA GPU and skips without one; imports neither JAX nor the JAX
package:

    python -m pytest --noconftest -m cuda tests/test_torch_corner_gate.py
"""
import numpy as np
import pytest
import torch

from bayesian_inference_trpl_tpu_torch.tools import compare, run_sweep
from bayesian_inference_trpl_tpu_torch.tools.corner_cache import (
    T0, corner_matrix as _corner_matrix, corner_sweep as _sweep,
    e_corner_matrix as _e_corner_matrix, load_oracle)

pytestmark = pytest.mark.cuda
METHOD = "fused_horizon"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the corner gate runs the record launch "
                    "on the card")
    return "cuda"


def test_corner_sweep_parity_with_dt_refined_e_gate(cuda_device):
    mat = _corner_matrix()
    oracle = load_oracle(_sweep(mat, T0 * 4), rtol=1e-8, atol=1e-12)

    errs_by_T = {}
    sols_by_T = {}
    for T in (T0, T0 * 2, T0 * 4):
        sol = run_sweep.run_solver(_sweep(mat, T), METHOD, "float64", device=cuda_device)
        assert sol["converged"].all(), \
            f"non-converged corners at T={T}: {np.where(~sol['converged'])}"
        errs_by_T[T] = compare.field_errors(sol, oracle, reduce="none")
        sols_by_T[T] = sol

    # N/P/PL gates at the production dt, worst corner (not mean).
    e0 = errs_by_T[T0]
    assert np.nanmax(e0["N"]) < 3e-2, e0["N"]
    assert np.nanmax(e0["P"]) < 3e-2, e0["P"]
    assert np.nanmax(e0["PL"]) < 4e-2, e0["PL"]
    # N must contract under dt refinement like a discretization error.
    rN = np.nanmax(np.asarray(errs_by_T[T0 * 2]["N"])) / np.nanmax(e0["N"])
    assert rN < 0.5, f"N error not shrinking under refinement (ratio {rN:.3f})"

    # E gate: bounded and dt-stable (E sits at its fixed-dx spatial error
    # floor on these ambipolar corners; see tests/test_corner_gate.py).
    E0 = np.asarray(errs_by_T[T0]["E"])
    E1 = np.asarray(errs_by_T[T0 * 2]["E"])
    E2 = np.asarray(errs_by_T[T0 * 4]["E"])
    sig = E0 > 1e-12
    assert sig.sum() >= 16, f"too few meaningful-E corners: {sig.sum()}"
    r1 = E1[sig] / E0[sig]
    r2 = E2[sig] / E1[sig]
    med_ratio = float(np.median(np.concatenate([r1, r2])))
    print(f"E stability: median refinement ratio {med_ratio:.4f}, worst "
          f"base {np.nanmax(E0):.3e}, worst refined {np.nanmax(E2):.3e}")
    assert med_ratio < 1.05, (
        f"E error GROWS under dt refinement (median ratio {med_ratio:.3f})"
        " — time-integration defect; investigate")
    # The matrix is ambipolar by construction (mu_n == mu_p), so the true
    # E is identically zero: the solver must reproduce the cancellation to
    # numerical noise.
    absE = float(np.nanmax(np.abs(np.asarray(sols_by_T[T0]["E"]))))
    assert absE < 1e-9, (
        f"ambipolar corners must give E == 0 to noise; got "
        f"max |E| = {absE:.3e} V/nm — a carrier-flux sign/scale "
        f"defect breaks the mu_n==mu_p cancellation")


def test_e_corner_gate_mu_asymmetric(cuda_device):
    """16 mu-asymmetric corners where space charge develops (max |E| ~
    2-4e-4 V/nm).  The JAX package's records (float64 coupled_newton
    against the oracle at rtol 1e-8), which the bounds bracket:

        T         N max      P max      E max      PL max
        T0        2.15e-2    2.15e-2    5.20e-2    1.31e-2
        T0*2      4.39e-3    4.38e-3    1.30e-2    3.32e-3
        T0*4      1.31e-3    1.30e-3    1.79e-3    8.95e-4
    """
    mat = _e_corner_matrix()
    oracle = load_oracle(_sweep(mat, T0 * 4), rtol=1e-8, atol=1e-12)

    errs_by_T = {}
    for T in (T0, T0 * 2, T0 * 4):
        sol = run_sweep.run_solver(_sweep(mat, T), METHOD, "float64", device=cuda_device)
        assert sol["converged"].all(), \
            f"non-converged E-corners at T={T}: {np.where(~sol['converged'])}"
        errs_by_T[T] = compare.field_errors(sol, oracle, reduce="none")

    e0 = {f: np.asarray(errs_by_T[T0][f]) for f in ("N", "P", "E", "PL")}
    e2 = {f: np.asarray(errs_by_T[T0 * 4][f]) for f in ("N", "P", "E", "PL")}
    # Production-dt magnitude bounds, worst corner.
    assert np.nanmax(e0["N"]) < 4e-2, e0["N"]
    assert np.nanmax(e0["P"]) < 4e-2, e0["P"]
    assert np.nanmax(e0["E"]) < 1e-1, e0["E"]
    assert np.nanmax(e0["PL"]) < 3e-2, e0["PL"]
    # Refined-dt bounds: at T0*4 the solver must track the oracle's E to
    # sub-percent.
    assert np.nanmax(e2["E"]) < 5e-3, e2["E"]
    assert np.nanmax(e2["N"]) < 4e-3, e2["N"]
    # E must contract under dt refinement like the discretization error it
    # is (median per-halving ratio measured 0.14-0.25).
    E0 = np.asarray(errs_by_T[T0]["E"])
    E1 = np.asarray(errs_by_T[T0 * 2]["E"])
    E2 = np.asarray(errs_by_T[T0 * 4]["E"])
    ratios = np.concatenate([E1 / E0, E2 / E1])
    med = float(np.median(ratios))
    print(f"E-corner gate: worst E {np.nanmax(E0):.3e} -> "
          f"{np.nanmax(E2):.3e}, median refinement ratio {med:.3f}")
    assert med < 0.5, (
        f"E error not contracting under dt refinement (median ratio "
        f"{med:.3f}) — field assembly or time-integration defect")
