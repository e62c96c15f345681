"""The port's tools/timeshift_demo against the JAX package's, both on the
CPU (the coupled_newton step loop / XLA scan), at T = 1,024 with 5 samples
and 5 shift points: both are fed the same float64 "exact" curves through
``accuracy_gate.load_exact`` (the JAX tool imports it inside ``main``, so
patching the module reaches it).

Two cases.  On the port's float64 exact curves themselves, the rms values
are the float32 ladder's own error (1.4e-4 to 6.1e-4 decades here) and the
two float32 solvers round differently (the port's step loop and the JAX
XLA scan sum in different orders): every reported rms agrees within 2e-6
decades absolutely, tests/test_torch_gate_raw.py's tolerance for the same
solvers (measured here: at most 9.5e-7, on a 2.6e-4 rms), and every best
shift is equal.  On those curves plus a fixed pattern of 0.5 decades (as
tests/test_torch_gate.py adds 1e-2), the rms is set by the pattern, and the
printed JSON agrees within 1e-6 relative.  Each case compiles the JAX
tool once: the batch and the shift grid have one shape.
"""
import contextlib
import io
import json

import numpy as np
import pytest
import torch

from bayesian_inference_trpl_tpu.tools import accuracy_gate as jgate
from bayesian_inference_trpl_tpu.tools import timeshift_demo as jts
from bayesian_inference_trpl_tpu_torch.tools import accuracy_gate as tgate
from bayesian_inference_trpl_tpu_torch.tools import timeshift_demo as tts

torch.set_num_threads(1)

T, BATCH, SHIFTS = 1024, 5, 5
ARGV = ["--T", str(T), "--batch", str(BATCH), "--seed", "0", "--profile", "synthetic",
        "--shift-points", str(SHIFTS), "--top", "1"]


def test_shifted_curves_equal_jax():
    lp = np.cumsum(np.random.default_rng(0).normal(size=300))
    deltas = np.linspace(-2.0, 2.0, 9)
    assert tts.shifted_curves(lp, deltas).tobytes() == jts.shifted_curves(lp, deltas).tobytes()
    np.testing.assert_array_equal(tts.shifted_curves(lp, [0.0])[0], lp)


def run_both(monkeypatch, lp, top=1):
    """Both tools on the curves ``lp``: (JAX's JSON, the port's JSON, the
    port's return, the printed lines, the cache paths each opened)."""
    seen = []

    def load_exact(path, batch, T_, seed=None, profile=None):
        seen.append((str(path), batch, T_, seed, profile))
        return lp.copy()
    monkeypatch.setattr(jgate, "load_exact", load_exact)
    monkeypatch.setattr(tgate, "load_exact", load_exact)

    argv = ARGV[:-1] + [str(top)]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jts.main(argv)
        port = tts.main(argv + ["--device", "cpu"])
    lines = out.getvalue().strip().splitlines()
    jrep = json.loads(lines[1 + top])
    trep = json.loads(lines[-1])
    return jrep, trep, port, lines, seen


def test_timeshift_demo_matches_jax_on_exact_curves(monkeypatch):
    lp = tgate.exact_curves(BATCH, T, seed=0, device="cpu")
    jrep, trep, port, _, _ = run_both(monkeypatch, lp, top=3)
    assert port["non_converged"] == 0
    assert [w["sample"] for w in trep["worst"]] == [w["sample"] for w in jrep["worst"]]
    for w, wj in zip(trep["worst"], jrep["worst"]):
        assert w["best_shift_steps"] == wj["best_shift_steps"]
        for k in ("raw_rms", "aligned_rms"):
            np.testing.assert_allclose(w[k], wj[k], rtol=0, atol=2e-6, err_msg=k)
        rms = port["rms_by_shift"][w["sample"]]
        assert rms[SHIFTS // 2] == pytest.approx(w["raw_rms"], rel=1e-6)


def test_timeshift_demo_matches_jax(monkeypatch):
    lp = tgate.exact_curves(BATCH, T, seed=0, device="cpu")
    lp = lp + 0.5 * np.cos(0.05 * np.arange(T + 1)[None, :] + np.arange(BATCH)[:, None])
    jrep, trep, port, lines, seen = run_both(monkeypatch, lp)
    # The port opens the cache the gate names (no _synthetic suffix).
    assert seen[1][0].endswith(f"exact_T{T}_b{BATCH}_s0.npz")
    assert seen[0][0].endswith(f"exact_T{T}_b{BATCH}_s0_synthetic.npz")
    assert trep == {k: port[k] for k in ("batch", "T", "profile", "worst")}
    assert (trep["batch"], trep["T"], trep["profile"]) == (BATCH, T, "synthetic")
    assert port["non_converged"] == 0 and "non-converged 0" in lines[3]
    (w,) = trep["worst"]
    (wj,) = jrep["worst"]
    for k in ("sample", "best_shift_steps", "best_shift_ps"):
        assert w[k] == wj[k], k
    for k in ("raw_rms", "aligned_rms", "collapse_factor"):
        np.testing.assert_allclose(w[k], wj[k], rtol=1e-6, err_msg=k)
    # The shift grid holds 0, and its entry is the raw rms.
    rms = port["rms_by_shift"][w["sample"]]
    assert port["deltas"][SHIFTS // 2] == 0.0 and len(rms) == SHIFTS
    assert rms[SHIFTS // 2] == pytest.approx(w["raw_rms"], rel=1e-6)
    assert min(rms) == w["aligned_rms"]
