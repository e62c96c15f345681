"""The port's accuracy gate (bayesian_inference_trpl_tpu_torch/tools/
accuracy_gate.py) against the JAX package's, on the CPU: the numpy parts
bitwise, the float64 exact curves within 1e-10 decades at a small T, and
``run_gate`` on a short ladder fed the JAX exact curves (both sides take
their CPU default, the coupled_newton step loop / XLA scan).  With a
fixed 1e-2-decade offset pattern added to the exact curves, every rms is
set by the offsets and agrees within 1e-4 relative; the unperturbed case
is in tests/test_torch_gate_raw.py (a second JAX compile, so a second
file that xdist can place on another worker).
"""
import json

import numpy as np
import pytest
import torch

from bayesian_inference_trpl_tpu.models.driver import SimParams as JSimParams
from bayesian_inference_trpl_tpu.tools import accuracy_gate as jgate
from bayesian_inference_trpl_tpu_torch.models.driver import SimParams as TSimParams
from bayesian_inference_trpl_tpu_torch.tools import accuracy_gate as tgate

torch.set_num_threads(1)

# A short ladder geometric_schedule accepts: ((1, 64), (4, 64), (8, 128)).
GATE = dict(batch=4, T=256, fine_steps=64, base_stride=4, max_stride=8,
            steps_per_phase=16)
RMS_KEYS = ("rms_log10_pl_max_meas", "rms_log10_pl_max", "rms_log10_pl_mean",
            "rms_log10_pl_max_full")
EQUAL_KEYS = ("win_points_min", "non_converged", "schedule", "batch", "T",
              "meas_decades", "meas_depth_decades")


@pytest.fixture(scope="module")
def jax_lp64():
    """JAX exact curves, float64, at the gate's small size."""
    return jgate.exact_curves(GATE["batch"], GATE["T"], seed=0)


def offsets(batch, T):
    """A fixed per-sample pattern of ~1e-2 decades along the curve."""
    t = np.arange(T + 1)
    return 1e-2 * np.cos(0.05 * t[None, :] + np.arange(batch)[:, None])


def gate_reports(lp64):
    """(port report, JAX report) of run_gate on ``lp64`` on the CPU."""
    rt = tgate.run_gate(lp64, device="cpu", verbose=False, **GATE)
    rj = jgate.run_gate(lp64, verbose=False, **GATE)
    assert rt["method"] == rj["method"] == "coupled_newton"
    for k in EQUAL_KEYS:
        assert rt[k] == rj[k], k
    return rt, rj


def test_numpy_parts_bitwise_equal_to_jax():
    for n, seed in ((8, 0), (8, 1), (33, 5)):
        assert (tgate.sample_production_box(n, seed).tobytes()
                == jgate.sample_production_box(n, seed).tobytes())
    assert tgate.MEAS_DEPTH_DECADES == jgate.MEAS_DEPTH_DECADES
    assert tgate.power_scan_excitations() == jgate.POWER_SCAN_EXC


def test_synthetic_excitation_profiles_match_jax():
    kw = dict(length=311.0, time=2000.0 * 640 / 80000, L=128, T=640)
    pt = tgate.excitation_profiles("synthetic", 5, TSimParams(**kw), torch.float64,
                                   device="cpu")
    pj = np.asarray(jgate.excitation_profiles("synthetic", 5, JSimParams(**kw),
                                              np.float64))
    assert pt.shape == (5, 128)
    np.testing.assert_allclose(pt.numpy(), pj, rtol=1e-12, atol=0)
    with pytest.raises(ValueError, match="unknown profile"):
        tgate.excitation_profiles("flat", 5, TSimParams(**kw), torch.float64,
                                  device="cpu")


def test_exact_curves_match_jax(jax_lp64):
    lp = tgate.exact_curves(GATE["batch"], GATE["T"], seed=0, device="cpu")
    assert lp.shape == jax_lp64.shape == (GATE["batch"], GATE["T"] + 1)
    np.testing.assert_allclose(lp, jax_lp64, rtol=0, atol=1e-10)
    # A row slice is the same rows of the full batch.
    part = tgate.exact_curves(GATE["batch"], 32, seed=0, rows=(1, 3), device="cpu")
    full = tgate.exact_curves(GATE["batch"], 32, seed=0, device="cpu")
    np.testing.assert_array_equal(part, full[1:3])


def test_run_gate_matches_jax_offset_curves(jax_lp64):
    """Offsets of ~1e-2 decades set the rms values (not float32
    rounding): every rms within 1e-4 relative of JAX's."""
    lp = jax_lp64 + offsets(GATE["batch"], GATE["T"])
    rt, rj = gate_reports(lp)
    for k in RMS_KEYS:
        assert rj[k] > 3e-3, (k, rj[k])
        np.testing.assert_allclose(rt[k], rj[k], rtol=1e-4, err_msg=k)


def test_load_exact_validates_shape_rows_and_metadata(tmp_path):
    """Mirrors tests/test_tools.py: shards, truncated assemblies and
    wrong-profile files are refused."""
    load_exact = tgate.load_exact
    lp = np.random.default_rng(0).normal(size=(8, 101))
    full = str(tmp_path / "full.npy")
    np.save(full, lp)
    assert load_exact(full, 8, 100).shape == (8, 101)
    with pytest.raises(SystemExit):
        load_exact(full, 16, 100)          # wrong batch
    with pytest.raises(SystemExit):
        load_exact(full, 8, 200)           # wrong T

    shard = str(tmp_path / "shard.npz")
    np.savez(shard, lp64=lp[2:6], rows=np.array([2, 6]), batch=8, T=100,
             seed=0, profile="power_scan")
    with pytest.raises(SystemExit):
        load_exact(shard, 8, 100)          # partial rows must fail

    ok = str(tmp_path / "ok.npz")
    np.savez(ok, lp64=lp, rows=np.array([0, 8]), batch=8, T=100,
             seed=0, profile="power_scan")
    assert load_exact(ok, 8, 100, seed=0, profile="power_scan").shape == (8, 101)
    with pytest.raises(SystemExit):
        load_exact(ok, 8, 100, seed=1)     # wrong seed
    with pytest.raises(SystemExit):
        load_exact(ok, 8, 100, profile="synthetic")


def test_main_reads_bundled_synthetic_cache(monkeypatch, capsys):
    """main finds the bundled batch-8 seed-0 synthetic cache and hands it
    to run_gate (stubbed: 80,000 steps do not run on the CPU)."""
    seen = {}

    def fake_gate(lp64, **kw):
        seen.update(kw, lp64=lp64)
        return dict(rms_log10_pl_max_meas=1e-4, rms_log10_pl_max=2e-4,
                    non_converged=0)
    monkeypatch.setattr(tgate, "run_gate", fake_gate)
    bundled = tgate.bundled_cache(80000, 8, 0, "synthetic")
    assert bundled == (tgate.EXACT_CACHE_DIR / "exact_T80000_b8_s0.npz")
    tgate.main(["--profile", "synthetic", "--batch", "8", "--seed", "0",
                "--device", "cpu", "--method", "fused_horizon_chord"])
    assert "PASS" in capsys.readouterr().out
    np.testing.assert_array_equal(seen["lp64"], np.load(bundled)["lp64"])
    assert seen["lp64"].shape == (8, 80001)
    assert (seen["batch"], seen["T"], seen["seed"], seen["device"],
            seen["method"], seen["t_exact"]) == (8, 80000, 0, "cpu",
                                                 "fused_horizon_chord", None)

    def failing_gate(lp64, **kw):
        return dict(rms_log10_pl_max_meas=6e-4, rms_log10_pl_max=2e-4,
                    non_converged=0)
    monkeypatch.setattr(tgate, "run_gate", failing_gate)
    with pytest.raises(SystemExit) as exc:
        tgate.main(["--profile", "synthetic", "--batch", "8", "--seed", "1",
                    "--device", "cpu"])
    assert exc.value.code == 1
    assert "FAIL" in capsys.readouterr().out


def test_adaptive_fine_tau_raises_naming_a9(jax_lp64):
    """Adaptive tau routing (A9, ported; the name is the test's from before
    the port): with the threshold between the batch's tau_n values, the
    fine bucket's rms rows come from the finer ladder, as in JAX
    ``run_gate``; offsets as above, every rms within 1e-4 relative."""
    tau = float(np.median(tgate.sample_production_box(GATE["batch"], 0)[:, 9]))
    lp = jax_lp64 + offsets(GATE["batch"], GATE["T"])
    rt = tgate.run_gate(lp, device="cpu", verbose=False, adaptive_fine_tau=tau, **GATE)
    rj = jgate.run_gate(lp, verbose=False, adaptive_fine_tau=tau, **GATE)
    assert rt["adaptive_fine_bucket"] == rj["adaptive_fine_bucket"] == GATE["batch"] // 2
    assert rt["adaptive_fine_tau"] == rj["adaptive_fine_tau"] == tau
    for k in EQUAL_KEYS:
        assert rt[k] == rj[k], k
    for k in RMS_KEYS:
        np.testing.assert_allclose(rt[k], rj[k], rtol=1e-4, err_msg=k)


def test_report_is_json(jax_lp64, capsys):
    """The report line is one JSON object naming the device."""
    tgate.run_gate(jax_lp64[:2, :65], batch=2, T=64, fine_steps=16,
                   base_stride=4, max_stride=4, steps_per_phase=4, device="cpu")
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["backend"] == "cpu" and rep["device_name"] == "cpu"
    assert rep["schedule"] == [[1, 16], [4, 48]]
