"""The runner without a retry pass.

Every path of the port takes chord Newton's decisions per sample (the
CUDA kernel runs one sample per thread block; on the CPU the wrapper runs
the plain version with group=1), so a sample's result does not depend on
its batch-mates: re-running the failed samples alone, padded as the runner
pads a chunk, repeats their results bit for bit.  The JAX package's retry
pass (failure-only batches) therefore recovers nothing here, and the
runner dispatches each chunk once.
"""
import numpy as np
import torch

from conftest import sample_mat_par
from bayesian_inference_trpl_tpu_torch import physics
from bayesian_inference_trpl_tpu_torch.models.driver import (
    SimParams, initial_excess_density, pl_log_scale)
from bayesian_inference_trpl_tpu_torch.models.solver import FusedObs
from bayesian_inference_trpl_tpu_torch.ops import horizon_kernel as hk
from bayesian_inference_trpl_tpu_torch.parallel import runner as rn

torch.set_num_threads(1)

B, T = 8, 24
EXC = (1e18 / 1e7 ** 3, 100.0)     # exp profile: density [nm^-3], depth [nm]


def _sim():
    return SimParams(length=311.0, time=2000.0 * T / 80000, L=128, T=T,
                     tol_exp=7, max_iters=4, method="fused_horizon_chord",
                     predictor="quadratic", step_tol=1e-9)


def _states(mat_nd, sim):
    mat = torch.as_tensor(mat_nd, dtype=torch.float64)
    dn = initial_excess_density(sim, EXC, "exp", device="cpu")
    n0 = mat[:, 0:1] + dn[None]
    p0 = mat[:, 1:2] + dn[None]
    return mat, n0, p0, torch.zeros_like(n0)


def test_failed_samples_repeat_alone_bitwise():
    """horizon_chord_plain(group=1), with max_iters cut so that some of a
    batch of 8 fail: the failing samples, run alone and padded to the chunk
    as Runner._pad pads, give bitwise the same sse, esum, conv, iterations
    and final state."""
    rng = np.random.default_rng(2)
    sim = _sim()
    X = sample_mat_par(rng, B)
    mat_nd = physics.nondimensionalize(X, sim.dx, sim.dt)
    mag = np.zeros(B)
    obs = FusedObs(values=torch.as_tensor(rng.uniform(-4, -2, (2, T + 1))),
                   log_scale=pl_log_scale(sim), min_val=1e-300)
    cfg = sim.solver_config()
    prm = hk._params(cfg, obs, 1, obs.log_scale)
    vals = obs.values[:, 1:].contiguous()

    def run(mat_np):
        mat, n0, p0, e0 = _states(mat_np, sim)
        return hk.horizon_chord_plain(mat, n0, p0, e0, vals, None, None, None,
                                      None, prm, group=1)

    full = run(mat_nd)
    failed = np.where(~full.conv.numpy())[0]
    assert 0 < failed.size < B, full.conv    # the batch mixes both outcomes
    mat_f, _ = rn.Runner(chunk=B, device="cpu")._pad(mat_nd[failed], mag[failed])
    alone = run(mat_f)
    k = failed.size
    for name in ("sse", "esum"):
        assert torch.equal(getattr(alone, name)[:, :k], getattr(full, name)[:, failed]), name
    for name in ("conv", "its", "maxit", "n", "p", "e", "fulls", "execs"):
        assert torch.equal(getattr(alone, name)[:k], getattr(full, name)[failed]), name


def test_runner_dispatches_each_chunk_once(monkeypatch):
    """Non-converged samples stay NaN; no second dispatch repairs them."""
    rng = np.random.default_rng(2)
    sim = _sim()
    X = np.concatenate([sample_mat_par(rng, B), np.zeros((B, 1))], 1)
    calls = []
    orig = rn._chunk_likelihood

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(rn, "_chunk_likelihood", spy)
    runner = rn.Runner(chunk=4, device="cpu")
    obs = np.random.default_rng(0).uniform(-4, -2, (2, T + 1))
    profile = EXC[0] * np.exp(-(np.arange(sim.L) + 0.5) * sim.dx / EXC[1])
    out, conv = runner.run_curve(X, sim, profile, obs, dtype=torch.float64)
    assert len(calls) == 2
    assert not conv.all()
    assert np.isnan(out[:, ~conv]).all() and np.isfinite(out[:, conv]).all()
    assert not hasattr(runner, "retries")
