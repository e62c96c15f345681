"""The CUDA kernels against their plain PyTorch versions on the card: the
horizon kernel (chord and full Newton, every mode), the per-step Newton
kernel and the weighted histograms (with the posterior on the card against
the CPU); the step loops' graph route (models/step_graph.py) against their
eager route.

Needs an NVIDIA GPU and skips without one.  The file imports neither JAX
nor the JAX package, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import functools

import numpy as np
import pytest
import torch

from bayesian_inference_trpl_tpu_torch import physics
from bayesian_inference_trpl_tpu_torch.models import offgrid
from bayesian_inference_trpl_tpu_torch.models.driver import (
    SimParams, initial_excess_density, pl_log_scale)
from bayesian_inference_trpl_tpu_torch.models import solver, step_graph
from bayesian_inference_trpl_tpu_torch.models.newton import coupled_newton_step
from bayesian_inference_trpl_tpu_torch.models.solver import FusedObs, SolverConfig
from bayesian_inference_trpl_tpu_torch.models.twophase import solve_multiphase
from bayesian_inference_trpl_tpu_torch.ops import horizon_kernel as hk
from bayesian_inference_trpl_tpu_torch.ops import newton_kernel as nk

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the horizon kernel runs only on the card")
    return torch.device("cuda")


def _problem(device, dtype, B=8, T=36 + 2 * 64, seed=0, method="fused_horizon_chord",
             normalize=False, L=128, predictor="quadratic", chord_strict=False):
    rng = np.random.default_rng(seed)
    lo = np.array([1e8, 1e14, 1.0, 1.0, 1e-11, 1e0, 1e0, 1e-30, 1e-30, 20.0, 20.0, 1e-1])
    hi = np.array([1e8, 1e16, 50.0, 50.0, 1e-9, 1e2, 1e2, 1e-28, 1e-28, 1000.0, 2000.0, 1e1])
    log = np.array([0, 1, 0, 0, 1, 1, 1, 1, 1, 0, 0, 1], dtype=bool)
    u = rng.uniform(size=(B, 12))
    x = np.where(log, 10 ** (np.log10(lo) + u * (np.log10(hi) - np.log10(lo))),
                 lo + u * (hi - lo)) * physics.UNIT_CONVERSIONS[:12]
    sim = SimParams(length=311.0, time=2000.0 * T / 80000, L=L, T=T)
    mat = torch.as_tensor(physics.nondimensionalize(x, sim.dx, sim.dt),
                          dtype=dtype, device=device)
    dn = initial_excess_density(sim, (1e18 / 1e7 ** 3, 100.0), "exp",
                                dtype=dtype, device=device)
    n0 = (mat[:, 0:1] + dn[None]).contiguous()
    p0 = (mat[:, 1:2] + dn[None]).contiguous()
    mask = torch.ones((2, T + 1), dtype=dtype, device=device)
    mask[1, -20:] = 0.0
    obs = FusedObs(values=torch.as_tensor(rng.uniform(-4, -2, (2, T + 1)),
                                          dtype=dtype, device=device),
                   log_scale=pl_log_scale(sim), min_val=1e-300, mask=mask,
                   normalize=normalize)
    cfg = SolverConfig(num_steps=T, tol=1e-8 if dtype == torch.float64 else 1e-4,
                       max_iters=8, step_tol=1e-6, method=method,
                       predictor=predictor, chord_strict=chord_strict)
    return mat, n0, p0, torch.zeros_like(n0), obs, cfg


def test_kernel_matches_plain_both_modes(cuda_device):
    """Each phase of a masked ladder (stride 1, 8, 16), float64: conv, its,
    fulls and execs equal; sse and esum within 1e-9 relative."""
    mat, n0, p0, e0, obs, cfg = _problem(cuda_device, torch.float64)
    calls = []

    def rec(*args):
        calls.append((args, hk.horizon_chord_plain(*args, group=1)))
        return calls[-1][1]
    solve_multiphase(mat, n0, p0, e0, cfg, obs, ((1, 36), (8, 64), (16, 64)),
                     kernel=rec)
    before = dict(hk.launches)
    for args, ref in calls:
        out = hk.horizon_chord(*args)
        torch.cuda.synchronize()
        for name in ("conv", "its", "maxit", "fulls", "execs"):
            assert torch.equal(getattr(out, name), getattr(ref, name)), name
        torch.testing.assert_close(out.sse, ref.sse, rtol=1e-9, atol=0.0)
        torch.testing.assert_close(out.esum, ref.esum, rtol=1e-9, atol=1e-12)
        torch.testing.assert_close(out.n, ref.n, rtol=1e-9, atol=0.0)
    assert hk.launches["stride_1"] - before["stride_1"] == 1
    assert hk.launches["stride_s"] - before["stride_s"] == 2


def _check_phase(out, ref):
    for name in ("conv", "its", "maxit", "fulls", "execs"):
        assert torch.equal(getattr(out, name), getattr(ref, name)), name
    torch.testing.assert_close(out.sse, ref.sse, rtol=1e-9, atol=0.0)
    torch.testing.assert_close(out.esum, ref.esum, rtol=1e-9, atol=1e-12)
    torch.testing.assert_close(out.n, ref.n, rtol=1e-9, atol=0.0)


@pytest.mark.parametrize("normalize", [False, True])
def test_full_kernel_matches_plain(cuda_device, normalize):
    """Full Newton (method fused_horizon) on a masked ladder (stride 1, 8,
    16), float64: conv, its, fulls and execs equal; sse and esum within
    1e-9 relative; one stride-1 and two stride-S full launches."""
    mat, n0, p0, e0, obs, cfg = _problem(cuda_device, torch.float64,
                                         method="fused_horizon", normalize=normalize)
    calls = []

    def rec(*args):
        calls.append((args, hk.horizon_chord_plain(*args)))
        return calls[-1][1]
    solve_multiphase(mat, n0, p0, e0, cfg, obs, ((1, 36), (8, 64), (16, 64)),
                     kernel=rec)
    before = dict(hk.launches)
    for args, ref in calls:
        assert not args[-1].chord
        out = hk.horizon_chord(*args)
        torch.cuda.synchronize()
        _check_phase(out, ref)
    assert ref.conv.any()
    assert hk.launches["stride_1_full"] - before["stride_1_full"] == 1
    assert hk.launches["stride_s_full"] - before["stride_s_full"] == 2
    assert hk.launches["stride_1"] == before["stride_1"]


@pytest.mark.parametrize("method", ["fused_horizon_chord", "fused_horizon"])
@pytest.mark.parametrize("normalize", [False, True])
def test_offgrid_kernel_matches_plain(cuda_device, normalize, method):
    """The off-grid mode, chord and full Newton, on a sigma-weighted
    log-spaced ladder (stride 1, 8, 16), float64: conv, its, fulls and
    execs equal; sse and esum within 1e-9 relative; one launch per phase."""
    mat, n0, p0, e0, _, cfg = _problem(cuda_device, torch.float64, method=method)
    sched = ((1, 36), (8, 64), (16, 64))
    sim = SimParams(length=311.0, time=2000.0 * cfg.num_steps / 80000, L=128,
                    T=cfg.num_steps)
    rng = np.random.default_rng(1)
    times = [np.concatenate([[0.0], np.geomspace(0.7, 0.9 * sim.T, n)]) * sim.dt
             for n in (40, 25)]
    values = [-3.0 - t / 2.0 + 0.01 * rng.standard_normal(t.size) for t in times]
    if normalize:
        values = [v - v[0] for v in values]
    tables = offgrid.build_offgrid_tables(
        times, values, sched, sim.dt,
        weights=[rng.uniform(0.5, 2.0, t.size) for t in times])
    calls = []

    def rec(*args):
        calls.append((args, hk.horizon_chord_plain(*args, group=1)))
        return calls[-1][1]
    offgrid.solve_offgrid(mat, n0, p0, e0, cfg, tables, sched, pl_log_scale(sim),
                          1e-300, normalize=normalize, kernel=rec)
    key = "offgrid" if method == "fused_horizon_chord" else "offgrid_full"
    before = hk.launches[key]
    for args, ref in calls:
        out = hk.horizon_chord(*args)
        torch.cuda.synchronize()
        _check_phase(out, ref)
    assert hk.launches[key] - before == 3


def test_newton_step_kernel_matches_plain(cuda_device, monkeypatch):
    """The per-step kernel on the recorded inputs of every step of a
    masked float64 ladder run with method coupled_newton_pallas, against
    coupled_newton_step: conv and its equal, N/P/E within 1e-9."""
    mat, n0, p0, e0, obs, cfg = _problem(cuda_device, torch.float64, B=6,
                                         T=36 + 2 * 16, method="coupled_newton_pallas")
    steps = []

    def rec(*args, **kw):
        steps.append((args, kw))
        return nk.newton_step(*args, **kw)
    monkeypatch.setattr(solver, "newton_step", rec)
    before = nk.launches
    with step_graph.route("eager"):
        res = solve_multiphase(mat, n0, p0, e0, cfg, obs, ((1, 36), (8, 16), (16, 16)))
    assert nk.launches - before == len(steps) == 36 + 2 + 1
    assert res.converged.any()
    for args, kw in steps:
        out = nk.newton_step(*args, **kw)
        ref = coupled_newton_step(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out[3], ref[3]) and torch.equal(out[4], ref[4])
        for a, b in zip(out[:3], ref[:3]):
            torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12)


def test_wrapper_rejects_bad_inputs(cuda_device):
    mat, n0, p0, e0, obs, cfg = _problem(cuda_device, torch.float64, B=2, T=8)
    prm = hk._params(cfg, obs, 1, obs.log_scale)
    vals = obs.values[:, 1:].contiguous()
    with pytest.raises(ValueError, match="mat"):
        hk.horizon_chord(mat.float(), n0, p0, e0, vals, None, None, None, None, prm)
    with pytest.raises(ValueError, match="contiguous"):
        hk.horizon_chord(mat, n0.t().contiguous().t(), p0, e0, vals, None, None,
                         None, None, prm)
    with pytest.raises(ValueError, match="obs"):
        hk.horizon_chord(mat, n0, p0, e0, vals[:, :-1].contiguous().t(), None,
                         None, None, None, prm)


def test_newton_step_rejects_bad_inputs(cuda_device):
    mat, n0, p0, e0, _, _ = _problem(cuda_device, torch.float64, B=2, T=8)
    mp = hk.MatParams.from_array(mat)
    one = torch.ones((), dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match="bN"):
        nk.newton_step(n0, p0, n0.float(), p0, e0, mp, one, one, 4)
    with pytest.raises(ValueError, match="contiguous"):
        nk.newton_step(n0, p0, n0.t().contiguous().t(), p0, e0, mp, one, one, 4)
    with pytest.raises(ValueError, match="mp"):
        nk.newton_step(n0, p0, n0, p0, e0, hk.MatParams.from_array(mat[:1]), one, one, 4)
    with pytest.raises(ValueError, match="power of two"):
        nk.newton_step(n0[:, :96].contiguous(), p0[:, :96].contiguous(),
                       n0[:, :96].contiguous(), p0[:, :96].contiguous(),
                       e0[:, :96].contiguous(), mp, one, one, 4)


# Variants of the launch the main path does not take: every predictor
# branch, the throughput chord profile, the widths of the run-time
# instantiation and a batch that is not a multiple of the 4 samples per
# block.  Each: (method, problem arguments, single phase).
VARIANTS = {
    "previous": ("fused_horizon_chord", dict(predictor="previous"), False),
    "linear": ("fused_horizon_chord", dict(predictor="linear"), False),
    "geometric": ("fused_horizon_chord", dict(predictor="geometric"), False),
    "full_previous": ("fused_horizon", dict(predictor="previous"), False),
    "full_geometric": ("fused_horizon", dict(predictor="geometric"), False),
    "throughput": ("fused_horizon_chord", dict(predictor="geometric"), True),
    "L32": ("fused_horizon_chord", dict(L=32), False),
    "L64": ("fused_horizon_chord", dict(L=64), False),
    "L256": ("fused_horizon_chord", dict(L=256), False),
    "full_L64": ("fused_horizon", dict(L=64), False),
    "tail_1001": ("fused_horizon_chord", dict(B=1001), False),
    "full_tail_1001": ("fused_horizon", dict(B=1001), False),
}


def _variant_calls(device, dtype, name):
    method, kw, single = VARIANTS[name]
    kw = dict(kw)
    B = kw.pop("B", 8 if dtype == torch.float64 else 64)
    mat, n0, p0, e0, obs, cfg = _problem(device, dtype, B=B, T=36 + 2 * 32,
                                         method=method, **kw)
    calls = []

    def rec(*args):
        calls.append((args, hk.horizon_chord_plain(*args, group=1)))
        return calls[-1][1]
    if single:
        hk.solve_horizon_fused(mat, n0, p0, cfg, obs, e_init=e0, kernel=rec)
        assert calls[0][0][-1].settle_guard == hk.CHORD_SETTLE_GUARD
    else:
        solve_multiphase(mat, n0, p0, e0, cfg, obs, ((1, 36), (8, 32), (16, 32)),
                         kernel=rec)
    return calls


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_kernel_variants_match_plain_f64(cuda_device, name):
    """float64, group = 1: final N/P/E bitwise; conv, its, maxit, fulls and
    execs equal; sse and esum within 1e-9 relative."""
    for args, ref in _variant_calls(cuda_device, torch.float64, name):
        out = hk.horizon_chord(*args)
        torch.cuda.synchronize()
        _check_phase(out, ref)
        for k in ("n", "p", "e"):
            assert torch.equal(getattr(out, k), getattr(ref, k)), k


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_kernel_variants_match_plain_f32(cuda_device, name):
    """float32: conv equal on >= 99% of the samples, and sse within 1e-3
    relative on >= 99% of those converged in both (chip_smoke.py's
    thresholds)."""
    for args, ref in _variant_calls(cuda_device, torch.float32, name):
        out = hk.horizon_chord(*args)
        torch.cuda.synchronize()
        assert float((out.conv == ref.conv).float().mean()) >= 0.99
        both = out.conv & ref.conv
        rel = ((out.sse - ref.sse).abs() / ref.sse.abs().clamp_min(1e-30)).amax(0)[both]
        assert float((rel <= 1e-3).float().mean()) >= 0.99


@pytest.mark.parametrize("L, B", [(128, 1001), (64, 7)])
def test_newton_step_tail_matches_plain(cuda_device, monkeypatch, L, B):
    """The per-step kernel at a batch that is not a multiple of the samples
    per block (and at the run-time width 64): its/conv equal, N/P/E
    bitwise against coupled_newton_step in float64."""
    mat, n0, p0, e0, obs, cfg = _problem(cuda_device, torch.float64, B=B, L=L,
                                         T=36 + 8 + 16, method="coupled_newton_pallas")
    steps = []

    def rec(*args, **kw):
        steps.append((args, kw))
        return nk.newton_step(*args, **kw)
    monkeypatch.setattr(solver, "newton_step", rec)
    with step_graph.route("eager"):
        solve_multiphase(mat, n0, p0, e0, cfg, obs, ((1, 36), (8, 8), (16, 16)))
    for args, kw in steps[::4]:
        out = nk.newton_step(*args, **kw)
        ref = coupled_newton_step(*args, **kw)
        torch.cuda.synchronize()
        for a, b in zip(out, ref):
            assert torch.equal(a, b)


def test_launch_layout_one_wave(cuda_device):
    """At L = 128 in float32 a block holds 4 samples and an SM 8, so the
    1,024-sample chunk is resident in one wave on 128 SMs or more."""
    lay = hk.launch_layout(1024, 128, 1)
    assert lay["samples_per_block"] == 4 and lay["threads_per_block"] == 128
    assert lay["samples_per_sm"] >= 8
    assert lay["sms"] < 128 or lay["waves"] <= 1.0
    step = nk.launch_layout(1024, 128)
    assert step["samples_per_block"] == 4 and step["samples_per_sm"] >= 8


def test_exact_mode_kernel_matches_plain(cuda_device):
    """Exact fixed-dt mode (no ladder): solve takes one stride-1 launch
    under the throughput chord profile; with the geometric predictor, on
    a shortened horizon, float64, group = 1: conv, its, maxit, fulls and
    execs equal, final N/P/E bitwise."""
    mat, n0, p0, e0, obs, cfg = _problem(cuda_device, torch.float64, T=256,
                                         predictor="geometric")
    calls = []

    def rec(*args):
        calls.append((args, hk.horizon_chord_plain(*args, group=1)))
        return calls[-1][1]
    solver.solve(mat, n0, p0, e0, cfg, obs=obs, record_pl=False, kernel=rec)
    (args, ref), = calls
    prm = args[-1]
    assert (prm.stride, prm.offgrid_k, prm.chord, prm.pred_order) == (1, 0, True, 3)
    assert (prm.settle_guard, prm.skip_tighten, prm.stall) == (
        hk.CHORD_SETTLE_GUARD, hk.CHORD_SKIP_TIGHTEN, hk.CHORD_STALL)
    out = hk.horizon_chord(*args)
    torch.cuda.synchronize()
    _check_phase(out, ref)
    for k in ("n", "p", "e"):
        assert torch.equal(getattr(out, k), getattr(ref, k)), k


def test_launch_refuses_too_much_shared_memory(cuda_device):
    """A sample keeps 2 x num_exp x slots likelihood accumulators in shared
    memory.  A launch whose one sample does not fit a block raises with
    the bytes it asks for and the bytes a block may take; the accuracy
    gate's shapes (num_exp = batch = 8, stride <= 64) fit."""
    S, num_exp = 64, 512
    mat, n0, p0, e0, _, cfg = _problem(cuda_device, torch.float32, B=4, T=8)
    sm = hk.shared_memory(128, num_exp, S)
    assert sm["sample_bytes"] > sm["optin_bytes"]
    obs = torch.zeros((num_exp, 2, S), dtype=torch.float32, device=cuda_device)
    wtab = torch.zeros((3, S, 4), dtype=torch.float32, device=cuda_device)
    prm = hk._params(cfg, FusedObs(values=obs, log_scale=0.0, min_val=1e-30), S, 0.0)
    with pytest.raises(RuntimeError, match=(
            rf"asks {sm['block_bytes']} B .* a block may take {sm['optin_bytes']} B"
            r": one sample does not fit")):
        hk.horizon_chord(mat, n0, p0, e0, obs, None, None, None, wtab, prm)
    for stride in (1, 16, 32, 64):
        fit = hk.shared_memory(128, 8, stride)
        assert fit["samples_per_block"] == 4
        assert fit["block_bytes"] <= fit["optin_bytes"]


def _record_calls(device, dtype, B, T, pl_stride, **cfg_kw):
    """The record launch of solve(record_pl=True) for a fused method (full
    Newton at stride 1 over the whole horizon, no observations), with its
    plain version's result (group = 1); ``cfg_kw`` adds SolverConfig fields
    (record_state_stride, record_iters)."""
    mat, n0, p0, e0, _, cfg = _problem(device, dtype, B=B, T=T)
    calls = []

    def rec(*args):
        calls.append((args, hk.horizon_chord_plain(*args, group=1)))
        return calls[-1][1]
    res = solver.solve(mat, n0, p0, e0, cfg._replace(pl_stride=pl_stride, **cfg_kw),
                       kernel=rec)
    (args, ref), = calls
    prm = args[-1]
    assert (prm.stride, prm.offgrid_k, prm.chord, prm.pl_stride) == (1, 0, False, pl_stride)
    assert args[4].shape == (0, T) and torch.equal(res.pl, ref.pl)
    return args, ref


@pytest.mark.parametrize("pl_stride", [1, 4])
def test_record_kernel_matches_plain_f64(cuda_device, pl_stride):
    """The PL trace of the full-Newton stride-1 body on a 256-step phase,
    float64: trace within 1e-12 relative, conv, its and maxit equal,
    final N/P/E bitwise; one record launch."""
    args, ref = _record_calls(cuda_device, torch.float64, 8, 256, pl_stride)
    before = dict(hk.launches)
    out = hk.horizon_chord(*args)
    torch.cuda.synchronize()
    assert out.pl.shape == (8, 256 // pl_stride + 1)
    torch.testing.assert_close(out.pl, ref.pl, rtol=1e-12, atol=0.0)
    for name in ("conv", "its", "maxit", "fulls", "execs"):
        assert torch.equal(getattr(out, name), getattr(ref, name)), name
    for name in ("n", "p", "e"):
        assert torch.equal(getattr(out, name), getattr(ref, name)), name
    assert bool(ref.conv.all())
    assert hk.launches["stride_1_record"] - before["stride_1_record"] == 1
    assert hk.launches["stride_1_full"] == before["stride_1_full"]


def test_record_kernel_matches_plain_f32(cuda_device):
    """float32, 256 samples: the kernel and the plain version sum in other
    orders, so a Newton decision may flip at a threshold.  Required: conv
    equal on >= 99% of the samples and the trace within 1e-3 relative at
    every point on >= 99% of the samples converged in both."""
    args, ref = _record_calls(cuda_device, torch.float32, 256, 256, 4)
    out = hk.horizon_chord(*args)
    torch.cuda.synchronize()
    assert float((out.conv == ref.conv).float().mean()) >= 0.99
    both = out.conv & ref.conv
    rel = ((out.pl - ref.pl).abs() / ref.pl.abs().clamp_min(1e-30)).amax(1)[both]
    assert rel.numel() and float((rel <= 1e-3).float().mean()) >= 0.99


def test_record_kernel_tail_1001(cuda_device):
    """A batch of 1001 (not a multiple of the samples per block), float64:
    trace within 1e-12, state bitwise."""
    args, ref = _record_calls(cuda_device, torch.float64, 1001, 64, 2)
    out = hk.horizon_chord(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.pl, ref.pl, rtol=1e-12, atol=0.0)
    for name in ("conv", "its", "n", "p", "e"):
        assert torch.equal(getattr(out, name), getattr(ref, name)), name


def test_record_trace_that_does_not_fit_raises(cuda_device):
    """A trace larger than the card (1001 samples x 20,000,001 float64
    points, 160 GB) raises torch.OutOfMemoryError before any launch; the
    batch is not cut to fit."""
    mat, n0, p0, e0, _, cfg = _problem(cuda_device, torch.float64, B=1001, T=8)
    before = dict(hk.launches)
    with pytest.raises(torch.OutOfMemoryError):
        solver.solve(mat, n0, p0, e0, cfg._replace(num_steps=20_000_000))
    assert hk.launches == before


@pytest.mark.parametrize("rss", [1, 4])
def test_record_states_match_plain_f64(cuda_device, rss):
    """The state and iteration traces of the record launch (PL every 2
    steps, the state every lcm(2, rss) steps), float64: iteration traces
    and counts equal, frames and final N/P/E bitwise; one launch, counted
    as a record launch with states."""
    args, ref = _record_calls(cuda_device, torch.float64, 8, 256, 2,
                              record_state_stride=rss, record_iters=True)
    every = 2 if rss == 1 else 4
    assert ref.states.shape == (256 // every, 3, 8, 128) and ref.iters.shape == (8, 128)
    before = dict(hk.launches)
    out = hk.horizon_chord(*args)
    torch.cuda.synchronize()
    assert torch.equal(out.states, ref.states) and torch.equal(out.iters, ref.iters)
    for name in ("conv", "its", "maxit", "n", "p", "e"):
        assert torch.equal(getattr(out, name), getattr(ref, name)), name
    torch.testing.assert_close(out.pl, ref.pl, rtol=1e-12, atol=0.0)
    assert torch.equal(out.states[-1], torch.stack((out.n, out.p, out.e)))
    assert hk.launches["stride_1_record_states"] - before["stride_1_record_states"] == 1
    assert hk.launches["stride_1_record"] == before["stride_1_record"]


def test_record_states_match_plain_f32(cuda_device):
    """float32, 256 samples: a Newton decision may flip at a threshold (the
    two sum residual norms in other orders).  Required: per-sample iteration
    traces equal on >= 99% of the samples, and on those the frames within
    1e-6 relative (E of its sample's scale)."""
    args, ref = _record_calls(cuda_device, torch.float32, 256, 256, 4,
                              record_state_stride=8, record_iters=True)
    out = hk.horizon_chord(*args)
    torch.cuda.synchronize()
    same = (out.iters == ref.iters).all(1)
    assert float(same.float().mean()) >= 0.99
    scale = ref.states.abs()
    scale[:, 2] = scale[:, 2].amax(-1, keepdim=True).expand(-1, -1, scale.shape[-1])
    rel = ((out.states - ref.states).abs() / scale.clamp_min(1e-30))[:, :, same]
    assert float(rel.max()) <= 1e-6


def test_record_states_tail_1001(cuda_device):
    """A batch of 1001, float64: the traces and the final state bitwise,
    and solve's JAX layout (NaN where no frame falls) from the launch."""
    args, ref = _record_calls(cuda_device, torch.float64, 1001, 64, 2,
                              record_state_stride=8, record_iters=True)
    out = hk.horizon_chord(*args)
    torch.cuda.synchronize()
    for name in ("states", "iters", "conv", "n", "p", "e"):
        assert torch.equal(getattr(out, name), getattr(ref, name)), name
    mat, n0, p0, e0, _, cfg = _problem(cuda_device, torch.float64, B=1001, T=64)
    res = solver.solve(mat, n0, p0, e0, cfg._replace(pl_stride=2, record_state_stride=8,
                                                     record_iters=True))
    n_tr = res.states[0]
    assert n_tr.shape == (32, 1001, 128) and res.iters.shape == (32,)
    assert torch.isnan(n_tr[0::4]).all() and torch.equal(n_tr[3::4], out.states[:, 0])
    assert torch.equal(res.iters, out.iters.amax(0))


def test_record_state_trace_that_does_not_fit_raises(cuda_device):
    """A state trace larger than the card (40,000 float64 frames of 1001
    samples x 3 x 128 cells, 123 GB, beside a 320 MB PL trace) raises
    torch.OutOfMemoryError before any launch."""
    mat, n0, p0, e0, _, cfg = _problem(cuda_device, torch.float64, B=1001, T=8)
    before = dict(hk.launches)
    with pytest.raises(torch.OutOfMemoryError):
        solver.solve(mat, n0, p0, e0, cfg._replace(num_steps=400_000, pl_stride=10,
                                                   record_state_stride=10))
    assert hk.launches == before


def _first_calls(device):
    """One horizon-kernel launch's arguments (the fine phase of a masked
    float64 ladder) and one per-step kernel call's, on ``device``."""
    mat, n0, p0, e0, obs, cfg = _problem(device, torch.float64, B=6, T=36 + 16)
    calls = []
    solve_multiphase(mat, n0, p0, e0, cfg, obs, ((1, 36), (8, 16)),
                     kernel=lambda *a: calls.append(a) or hk.horizon_chord_plain(*a, group=1))
    mat, n0, p0, e0, obs, cfg = _problem(device, torch.float64, B=6, T=4,
                                         method="coupled_newton_pallas")
    steps = []
    orig = solver.newton_step
    solver.newton_step = lambda *a, **kw: steps.append((a, kw)) or orig(*a, **kw)
    try:
        with step_graph.route("eager"):
            solve_multiphase(mat, n0, p0, e0, cfg, obs, ((1, 4),))
    finally:
        solver.newton_step = orig
    return calls[0], steps[0]


def test_wrappers_launch_on_their_inputs_device(cuda_device, monkeypatch):
    """The C entries launch on the current CUDA device, so each wrapper
    makes its inputs' device current.  With two cards: inputs on cuda:1
    while cuda:0 is current give bitwise what they give with cuda:1
    current.  With one card: each wrapper entered its inputs' device."""
    if torch.cuda.device_count() > 1:
        target = torch.device("cuda", 1)
        (h_args, (s_args, s_kw)) = _first_calls(target)
        with torch.cuda.device(target):
            ref_h, ref_s = hk.horizon_chord(*h_args), nk.newton_step(*s_args, **s_kw)
        with torch.cuda.device(0):
            out_h, out_s = hk.horizon_chord(*h_args), nk.newton_step(*s_args, **s_kw)
        torch.cuda.synchronize(target)
        for a, b in zip(out_h, ref_h):
            assert a is None or torch.equal(a, b)
        for a, b in zip(out_s, ref_s):
            assert torch.equal(a, b)
        return
    target = torch.device("cuda", 0)
    h_args, (s_args, s_kw) = _first_calls(target)
    entered = []
    orig = torch.cuda.device

    class Recorded(orig):
        def __init__(self, d):
            entered.append(torch.device(d))
            super().__init__(d)
    monkeypatch.setattr(torch.cuda, "device", Recorded)
    hk.horizon_chord(*h_args)
    assert entered == [target]
    nk.newton_step(*s_args, **s_kw)
    assert entered == [target, target]


@pytest.mark.parametrize("route", ["ongrid", "interp"])
def test_runner_two_entry_mesh_on_one_card(cuda_device, route):
    """A mesh that names the card twice against the card once, at the same
    global chunk: the likelihoods bitwise equal, each chunk launched once
    per mesh entry."""
    from bayesian_inference_trpl_tpu_torch.parallel.mesh import make_mesh
    from bayesian_inference_trpl_tpu_torch.tools import dryrun_multichip as dry
    prob = dry.problem(T=48, num=64, interp_num=64)
    mode = "stride_1" if route == "ongrid" else "stride_1_record"
    res = []
    for mesh, cpd in ((["cuda:0"] * 2, 16), (["cuda:0"], 32)):
        before = hk.launches[mode]
        res.append(dry.run_route(route, make_mesh(mesh), cpd, prob))
        assert hk.launches[mode] - before == 2 * len(mesh)        # 2 chunks of 32
    assert dry.check_route(route, res[0], res[1], 2)


def test_legacy_forward_rows_independent_of_batch(cuda_device):
    """utils/legacy_pipeline.make_trpl_forward on a fused method is one
    record launch per call, and a sample's PL does not depend on its
    batch-mates (the kernel decides per sample, C4): a level's blocks may
    share a launch in grid_refine_bayes without changing its result."""
    from bayesian_inference_trpl_tpu_torch.utils import legacy_pipeline as lp
    rng = np.random.default_rng(3)
    lo = np.array([1e8, 1e14, 1.0, 1.0, 1e-11, 1e0, 1e0, 1e-30, 1e-30, 20.0, 20.0, 1e-1])
    hi = np.array([1e8, 1e16, 50.0, 50.0, 1e-9, 1e2, 1e2, 1e-28, 1e-28, 1000.0, 2000.0, 1e1])
    u = rng.uniform(size=(64, 12))
    X = np.concatenate([(lo + u * (hi - lo)) * physics.UNIT_CONVERSIONS[:12],
                        np.zeros((64, 1))], 1)
    sim = SimParams(length=311.0, time=2000.0 * 256 / 80000, L=128, T=256, pl_stride=4,
                    tol_exp=4.0, max_iters=8, method="fused_horizon")
    forward = lp.make_trpl_forward(sim, (1e18 / 1e7 ** 3, 100.0), "exp")
    before = hk.launches["stride_1_record"]
    whole = forward(X)
    parts = torch.cat([forward(X[k:k + 16]) for k in range(0, 64, 16)])
    torch.cuda.synchronize()
    assert whole.shape == (64, sim.num_pl) and whole.device.type == "cuda"
    assert hk.launches["stride_1_record"] - before == 5
    assert torch.equal(whole, parts)


def _hist_samples(n, lo, hi, seed):
    """float64 samples with NaN, +-inf, both edges and values just outside."""
    g = torch.Generator().manual_seed(seed)
    x = lo - 0.5 * (hi - lo) + 2.0 * (hi - lo) * torch.rand(n, generator=g, dtype=torch.float64)
    x[::50] = float("nan")
    x[1::70] = float("inf")
    x[2::90] = -float("inf")
    x[3::30] = lo
    x[4::40] = hi
    x[5::60] = np.nextafter(hi, np.inf)
    x[6::80] = np.nextafter(lo, -np.inf)
    return x


def _hist_close(a, b):
    """Sums of positive weights: within 1e-12 relative (the kernel's atomics
    add in another order)."""
    assert a.shape == b.shape and a.dtype == b.dtype == torch.float64
    assert bool(((a - b).abs() <= 1e-12 * b.abs()).all())


@pytest.mark.parametrize("n,bins", [(1_000_003, 96), (4097, 1), (50_000, 20_000)])
def test_hist1d_kernel_matches_plain(cuda_device, n, bins):
    """Counts equal and sums within 1e-12 of the plain version; 20,000 bins
    (320 KB) take the global-memory path."""
    from bayesian_inference_trpl_tpu_torch.ops import histogram
    x = _hist_samples(n, -1.0, 3.0, bins).to(cuda_device)
    w = torch.rand(n, dtype=torch.float64, device=cuda_device)
    before = histogram.launches["hist1d_weighted"]
    kw, kc = histogram.hist1d_weighted(x, w, -1.0, 3.0, bins)
    pw, pc = histogram.hist1d_weighted_plain(x, w, -1.0, 3.0, bins)
    torch.cuda.synchronize()
    assert histogram.launches["hist1d_weighted"] - before == 1
    assert torch.equal(kc, pc) and int(kc.sum()) == int(((x >= -1) & (x <= 3)).sum())
    _hist_close(kw, pw)
    plan = histogram.launch_plan(1, n, bins)
    assert plan["path"] == ("global" if bins * 16 > plan["smem_optin"] else "shared")


@pytest.mark.parametrize("bx,by", [(96, 96), (200, 200), (1, 7)])
def test_hist2d_kernel_matches_plain(cuda_device, bx, by):
    """96 x 96 (72 KB) on the shared path, 200 x 200 (313 KB) on the
    global one; with unit weights the sums are counts, equal exactly."""
    from bayesian_inference_trpl_tpu_torch.ops import histogram
    n = 1_000_000
    x = _hist_samples(n, 0.0, 1.0, bx).to(cuda_device)
    y = _hist_samples(n, -1e-9, 1e-9, by + 1).to(cuda_device)
    w = torch.rand(n, dtype=torch.float64, device=cuda_device)
    args = (0.0, 1.0, bx, -1e-9, 1e-9, by)
    k = histogram.hist2d_weighted(x, y, w, *args)
    _hist_close(k, histogram.hist2d_weighted_plain(x, y, w, *args))
    ones = torch.ones_like(w)
    assert torch.equal(histogram.hist2d_weighted(x, y, ones, *args),
                       histogram.hist2d_weighted_plain(x, y, ones, *args))
    plan = histogram.launch_plan(2, n, bx * by)
    assert plan["path"] == ("shared" if bx * by <= 96 * 96 else "global")


def test_hist_kernel_refuses_bad_inputs(cuda_device):
    from bayesian_inference_trpl_tpu_torch.ops import histogram
    x = torch.zeros(8, dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match="float64"):
        histogram.hist1d_weighted(x.float(), x, 0.0, 1.0, 4)
    with pytest.raises(ValueError, match="expected float64"):
        histogram.hist2d_weighted(x, x[:4], x, 0.0, 1.0, 4, 0.0, 1.0, 4)
    out_w, out_c = histogram.hist1d_weighted(x[:0], x[:0], 0.0, 1.0, 4)
    assert int(out_c.sum()) == 0 and float(out_w.sum()) == 0.0


def test_posterior_on_card_matches_cpu(cuda_device, tmp_path):
    """PosteriorData and the CLI's report on cuda against cpu: the
    statistics within 1e-12 relative (1e-6 after fmin's temperature), the
    marginals within 1e-12, each marginal one kernel launch."""
    from bayesian_inference_trpl_tpu_torch.ops import histogram
    from bayesian_inference_trpl_tpu_torch.posterior import PosteriorData, cli
    from bayesian_inference_trpl_tpu_torch.utils.io import export
    rng = np.random.default_rng(7)
    n = 4000
    lo = np.array([1e8, 1e14, 0.0, 0.0, 1e-11, 0.1, 0.1, 1e-29, 1e-29, 1.0, 1.0, 0.1, 0.0])
    hi = np.array([1e8, 1e16, 50.0, 50.0, 1e-9, 100.0, 100.0, 1e-29, 1e-29, 1000.0, 2000.0,
                   0.1, 0.0])
    X = lo + rng.uniform(size=(n, 13)) * (hi - lo)
    LL = -((X[:, 9] - 500.0) / 50.0) ** 2
    LL[:3] = np.nan
    export(str(tmp_path / "run"), LL, X)
    reps = {d: cli.report(str(tmp_path / "run"), device=d) for d in ("cuda", "cpu")}
    a, b = reps["cuda"].summary, reps["cpu"].summary
    assert a["num_samples"] == b["num_samples"] == n - 3
    np.testing.assert_allclose(a["temperature"], b["temperature"], rtol=1e-6)
    for p in b["stats"]:
        np.testing.assert_allclose(list(a["stats"][p].values()),
                                   list(b["stats"][p].values()), rtol=1e-6)
    d = {dev: PosteriorData.from_arrays(LL, X, device=dev).compute_secondary()
         .normalize_temperature(b["temperature"]) for dev in ("cuda", "cpu")}
    before = dict(histogram.launches)
    for p, log in (("p0", True), ("tau_n", False), ("tau_eff", True)):
        for u, v in zip(d["cuda"].marginal_1d(p, log=log), d["cpu"].marginal_1d(p, log=log)):
            np.testing.assert_allclose(u.cpu().numpy(), v.numpy(), rtol=1e-12, atol=0)
    for u, v in zip(d["cuda"].marginal_2d("p0", "B", log_x=True, log_y=True),
                    d["cpu"].marginal_2d("p0", "B", log_x=True, log_y=True)):
        np.testing.assert_allclose(u.cpu().numpy(), v.numpy(), rtol=1e-12, atol=0)
    assert histogram.launches["hist1d_weighted"] - before["hist1d_weighted"] == 3
    assert histogram.launches["hist2d_weighted"] - before["hist2d_weighted"] == 1
    st, sc = d["cuda"].stats_summary(), d["cpu"].stats_summary()
    for p in ("p0", "B", "tau_n", "tau_eff"):
        np.testing.assert_allclose(st[p], sc[p], rtol=1e-12)


def test_pinned_marginals_on_card_match_cpu(cuda_device):
    """A pinned parameter (n0 constant, so its range is empty) and a NaN
    bound: the marginals stay on the card, launch no histogram kernel,
    and equal the CPU's, inf and NaN in the same bins."""
    from bayesian_inference_trpl_tpu_torch.ops import histogram
    from bayesian_inference_trpl_tpu_torch.posterior import PosteriorData, plotting
    rng = np.random.default_rng(3)
    n = 20_000
    X = rng.uniform(1.0, 2.0, size=(n, 13))
    X[:, 0] = 1e8
    LL = -((X[:, 9] - 1.5) / 0.1) ** 2
    d = {dev: PosteriorData.from_arrays(LL, X, device=dev).normalize()
         for dev in ("cuda", "cpu")}

    def same(u, v):
        assert u.device.type == "cuda" and u.shape == v.shape
        u = u.cpu()
        assert torch.equal(torch.isnan(u), torch.isnan(v))
        assert torch.equal(u[torch.isinf(v)], v[torch.isinf(v)])
        fin = torch.isfinite(v)
        assert bool(((u[fin] - v[fin]).abs() <= 1e-12 * v[fin].abs()).all())

    before = dict(histogram.launches)
    outs = {dev: [d[dev].marginal_1d("n0", bins=96),
                  d[dev].marginal_1d("n0", bins=96, bounds=(1e8, 1e8)),
                  d[dev].marginal_1d("p0", bins=96, bounds=(1.5, 1.5)),
                  d[dev].marginal_1d("p0", bins=96, bounds=(float("nan"), 2.0)),
                  d[dev].marginal_2d("n0", "tau_n", bins=96),
                  d[dev].marginal_2d("tau_n", "n0", bins=96)] for dev in ("cuda", "cpu")}
    assert histogram.launches == before
    assert bool(torch.isinf(outs["cuda"][0][0]).any())
    for a, b in zip(outs["cuda"], outs["cpu"]):
        for u, v in zip(a, b):
            same(u, v)
    params = ["n0", "p0", "tau_n"]
    tc, dc, pc = plotting.corner_marginals(d["cuda"], params, bins=64)
    _, dh, ph = plotting.corner_marginals(d["cpu"], params, bins=64)
    assert histogram.launches["hist1d_weighted"] - before["hist1d_weighted"] == 2
    assert histogram.launches["hist2d_weighted"] - before["hist2d_weighted"] == 1
    for p in params:
        for u, v in zip(dc[p], dh[p]):
            same(u, v)
    for k in ph:
        for u, v in zip(pc[k], ph[k]):
            same(u, v)


# ---------------------------------------------------------------------------
# The step loops' graph route (models/step_graph.py) against the eager route
# ---------------------------------------------------------------------------

def _bitwise(a, b):
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, tuple):
        return all(_bitwise(x, y) for x, y in zip(a, b))
    return (a.shape == b.shape and torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))


def _routes(fn):
    """fn() on the eager route, then on the graph route (the default);
    returns both, and the graph route's launches and replays."""
    with step_graph.route("eager"):
        ref = fn()
    launches, replays = nk.launches, dict(step_graph.replays)
    got = fn()
    torch.cuda.synchronize()
    return ref, got, nk.launches - launches, {k: v - replays[k] for k, v
                                              in step_graph.replays.items()}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("method", ["coupled_newton", "coupled_newton_pallas",
                                    "gauss_seidel"])
def test_graph_route_matches_eager(cuda_device, method, dtype):
    """A batch of 1001 over a masked ladder (8 fine steps, two rungs) and a
    solve recording PL every 2 steps with the state and iteration traces:
    every output bitwise the eager route's.  The per-step kernel launches
    once per replay of its step's graph, one graph per step."""
    mat, n0, p0, e0, obs, cfg = _problem(cuda_device, dtype, B=1001, T=40, method=method)
    sched = ((1, 8), (4, 16), (8, 16))
    rec = cfg._replace(num_steps=16, pl_stride=2, record_state_stride=4, record_iters=True)

    def run():
        return (tuple(solve_multiphase(mat, n0, p0, e0, cfg, obs, sched))
                + tuple(solver.solve(mat, n0, p0, e0, rec)))
    ref, got, launches, replays = _routes(run)
    assert _bitwise(ref, got)
    steps = 8 + 4 + 2 + 16
    if method == "coupled_newton_pallas":
        assert launches == replays["step"] == steps and replays["iteration"] == 0
    else:
        assert launches == 0 and replays["step"] == 2 * steps
        assert replays["iteration"] >= steps


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("method", ["fused_horizon_chord", "fused_horizon"])
@pytest.mark.parametrize("where", ["ladder", "offgrid"])
def test_graph_route_plain_chains_match_eager(cuda_device, method, dtype, where):
    """The plain chains (chord, group 1, and full Newton) at stride 1 and
    stride S, and off-grid, batch 1001: bitwise the eager route's."""
    mat, n0, p0, e0, obs, cfg = _problem(cuda_device, dtype, B=1001, T=40, method=method)
    sched = ((1, 8), (4, 16), (8, 16))
    plain = functools.partial(hk.horizon_chord_plain, group=1)
    if where == "ladder":
        def run():
            return tuple(solve_multiphase(mat, n0, p0, e0, cfg, obs, sched, kernel=plain))
    else:
        sim = SimParams(length=311.0, time=2000.0 * 40 / 80000, L=128, T=40)
        t = np.concatenate([[0.0], np.geomspace(0.7 * sim.dt, 38.6 * sim.dt, 30)])
        tables = offgrid.build_offgrid_tables([t], [np.linspace(-2.0, -4.0, t.size)],
                                              sched, sim.dt)

        def run():
            return tuple(offgrid.solve_offgrid(mat, n0, p0, e0, cfg, tables, sched,
                                               pl_log_scale(sim), 1e-300, kernel=plain))
    ref, got, _, replays = _routes(run)
    assert _bitwise(ref, got) and replays["iteration"] > 0


def test_traced_process_refuses_simulate(cuda_device, monkeypatch, tmp_path):
    """A process that traced the card (pipeline.profile_trace, as
    [device] profile_dir traces simulate) refuses a later simulate on the
    card, before any work: it would launch more slowly."""
    from bayesian_inference_trpl_tpu_torch import pipeline
    from bayesian_inference_trpl_tpu_torch.config import InferenceConfig
    from bayesian_inference_trpl_tpu_torch.parallel.runner import Runner
    monkeypatch.setattr(pipeline, "_traced_card", False)
    x = torch.zeros(8, device=cuda_device)
    with pipeline.profile_trace(str(tmp_path), [torch.device(cuda_device)]):
        for _ in range(10):
            x.add_(1.0)
    assert (tmp_path / "trace_rank0.json").exists() and pipeline._traced_card
    launches = dict(hk.launches, newton_step=nk.launches)
    with pytest.raises(RuntimeError, match="traced the card"):
        pipeline.simulate(InferenceConfig(), [], [], np.zeros((4, 13)), np.zeros((1, 4)),
                          Runner(chunk=4, device=cuda_device))
    assert dict(hk.launches, newton_step=nk.launches) == launches


def test_failed_capture_raises_without_fallback(cuda_device, monkeypatch):
    """A piece that waits on the host inside its capture (forced here: the
    PL read back in the step's end) fails the capture, and the solve
    raises; the eager step never runs.  Last in the file: the failed
    capture leaves its stream's memory pool behind."""
    mat, n0, p0, e0, obs, cfg = _problem(cuda_device, torch.float64, B=8, T=8,
                                         method="coupled_newton_pallas")
    pl_observable = solver.pl_observable

    def reads_back(N, P, mp):
        out = pl_observable(N, P, mp)
        float(out.sum())
        return out

    def eager(*a, **kw):
        raise AssertionError("the eager step ran")
    monkeypatch.setattr(solver, "pl_observable", reads_back)
    monkeypatch.setattr(solver, "bdf_step", eager)
    before = nk.launches
    with pytest.raises(RuntimeError):
        solver.solve(mat, n0, p0, e0, cfg, obs=obs)
    assert nk.launches == before
