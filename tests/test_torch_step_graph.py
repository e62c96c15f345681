"""The step loops as device programs (models/step_graph.py) on the CPU.

The eager loops are held to the JAX package by the other port tests; these
hold the new code to the eager loops, bitwise:

* the BDF coefficient table the steps gather from, against the per-step
  host scalars it replaces (a NaN in a zero-weight slot included);
* the cached one-hot rows, against a row built per call;
* the restructured schedule (in-place step bodies, Newton and
  Gauss-Seidel loops whose exit test lags one iteration, the chord loop
  with its exit and Jacobian refresh chosen on the host before each
  iteration), forced on the CPU with route "masked", and the same under a
  runner that replays
  each piece as the closure of its key's first call, as a CUDA graph
  replays what it captured ("replay");
* for each solver method, a coarse rung and an off-grid phase, and the
  plain chains (chord and full Newton) at stride 1, stride S and
  off-grid; with one sample that never converges (a NaN in its state), and
  with every sample done well before max_iters.

JAX-free.  The card's graph route against the eager one is in
tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

from bayesian_inference_trpl_tpu_torch import physics
from bayesian_inference_trpl_tpu_torch.models import offgrid, solver, step_graph, trpl, twophase
from bayesian_inference_trpl_tpu_torch.models.driver import (
    SimParams, initial_excess_density, pl_log_scale)
from bayesian_inference_trpl_tpu_torch.models.solver import FusedObs, SolverConfig
from bayesian_inference_trpl_tpu_torch.ops import horizon_kernel as hk

torch.set_num_threads(1)

SCHED = ((1, 8), (4, 16), (8, 16))          # 8 fine steps, then 4 + 2 coarse


class ReplayRunner(step_graph.StepRunner):
    """The graph route's semantics on the CPU: every piece runs as the
    closure of its key's first call (with that call's Python values), as a
    CUDA graph replays the kernels it captured."""

    def run(self, key, fn, kind="step"):
        self.graphs.setdefault(key, fn)()


@pytest.fixture(params=["masked", "replay"])
def route(request, monkeypatch):
    if request.param == "replay":
        for mod in (solver, twophase, offgrid, hk):
            monkeypatch.setattr(mod, "StepRunner", ReplayRunner)
    return "masked"


def _problem(dtype, B=4, T=40, L=32, nan_sample=True, method="coupled_newton",
             seed=0, **cfg_kw):
    rng = np.random.default_rng(seed)
    lo = np.array([1e8, 1e14, 1.0, 1.0, 1e-11, 1e0, 1e0, 1e-30, 1e-30, 20.0, 20.0, 1e-1])
    hi = np.array([1e8, 1e16, 50.0, 50.0, 1e-9, 1e2, 1e2, 1e-28, 1e-28, 1000.0, 2000.0, 1e1])
    log = np.array([0, 1, 0, 0, 1, 1, 1, 1, 1, 0, 0, 1], dtype=bool)
    u = rng.uniform(size=(B, 12))
    x = np.where(log, 10 ** (np.log10(lo) + u * (np.log10(hi) - np.log10(lo))),
                 lo + u * (hi - lo)) * physics.UNIT_CONVERSIONS[:12]
    sim = SimParams(length=311.0, time=2000.0 * T / 80000, L=L, T=T)
    mat = torch.as_tensor(physics.nondimensionalize(x, sim.dx, sim.dt), dtype=dtype)
    dn = initial_excess_density(sim, (1e18 / 1e7 ** 3, 100.0), "exp", dtype=dtype,
                                device="cpu")
    n0 = (mat[:, 0:1] + dn[None]).contiguous()
    p0 = (mat[:, 1:2] + dn[None]).contiguous()
    if nan_sample:
        n0[1, 5] = float("nan")           # sample 1 never converges
    mask = torch.ones((2, T + 1), dtype=dtype)
    mask[1, -7:] = 0.0
    obs = FusedObs(values=torch.as_tensor(rng.uniform(-4, -2, (2, T + 1)), dtype=dtype),
                   log_scale=pl_log_scale(sim), min_val=1e-300, mask=mask)
    # max_iters 4: past the chord budget of 3, and the NaN sample runs every
    # loop to its limit (a Gauss-Seidel iteration is ~650 operations).
    kw = dict(num_steps=T, tol=1e-8 if dtype == torch.float64 else 1e-4, max_iters=4,
              step_tol=1e-6, method=method, predictor="quadratic")
    kw.update(cfg_kw)
    return mat, n0, p0, torch.zeros_like(n0), obs, SolverConfig(**kw), sim


def _same(a, b):
    """Bitwise equal, NaN where NaN; recursing into tuples."""
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))


def _hold(route, fn):
    ref = fn()
    with step_graph.route(route):
        got = fn()
    assert _same(tuple(ref), tuple(got))
    return ref


DTYPES = [torch.float64, torch.float32]
METHODS = ["coupled_newton", "coupled_newton_pallas", "gauss_seidel"]


# ---------------------------------------------------------------------------
# The BDF table and the one-hot rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_bdf_table_sums_match_per_step_scalars(dtype):
    """For every t < 12, the history sums and a0 from the table equal the
    sums over per-step 0-dim host scalars (the weights of slots 0..5 in
    order, Python's sum from 0), bitwise; a NaN in the slot the step does
    not read propagates as it did."""
    rng = np.random.default_rng(1)
    for t in range(12):
        h = torch.as_tensor(rng.standard_normal((6, 3, 8)), dtype=dtype)
        h[(t + 1) % 6, 1, 2] = float("nan")
        a = trpl.BDF_TABLE[min(t, 4)]
        w = {(t - m) % 6: float(a[m + 1]) for m in range(5)}
        want = sum(torch.as_tensor(w.get(s, 0.0), dtype=dtype) * h[s] for s in range(6))
        cfg = SolverConfig(num_steps=1, predictor="previous")
        row = solver.bdf_table(dtype, "cpu")[step_graph.step_class(t)]
        a0, bn, *_ = solver._step_inputs(t, h, h, h, cfg, row)
        assert _same(bn, want) and bool(torch.isnan(bn[1, 2]))
        assert _same(a0, torch.as_tensor(a[0], dtype=dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L", [32, 128])
def test_cached_onehot_rows_match(dtype, L):
    x = torch.zeros((3, L), dtype=dtype)
    for idx in (0, L - 1):
        old = torch.zeros((1, L), dtype=dtype)
        old[0, idx] = 1.0
        row = trpl._onehot(x, idx)
        assert _same(row, old) and trpl._onehot(x, idx) is row


# ---------------------------------------------------------------------------
# The runner
# ---------------------------------------------------------------------------

class _CountLoop:
    """A loop whose samples are all done after ``k`` iterations."""

    def __init__(self, k, limit):
        self.k, self.limit, self.n = k, limit, 0

    def variant(self, i):
        return None

    def all_done(self):
        return torch.tensor(self.n >= self.k)

    def iterate(self, v, masked):
        self.n += 1


@pytest.mark.parametrize("k, limit", [(0, 5), (2, 5), (4, 5), (5, 5), (9, 5)])
def test_lagged_exit_runs_one_more_never_past_limit(k, limit):
    eager = step_graph.StepRunner("cpu")
    assert eager.loop("l", _CountLoop(k, limit)) == min(k, limit)
    with step_graph.route("masked"):
        masked = step_graph.StepRunner("cpu")
    loop = _CountLoop(k, limit)
    masked.mark(loop)
    assert masked.loop("l", loop) == min(k + 1, limit) == loop.n


def test_routes():
    assert step_graph.route_for("cpu") == "eager"
    assert step_graph.route_for("cuda") == "graph"
    with step_graph.route("masked"):
        assert step_graph.route_for("cpu") == step_graph.route_for("cuda") == "masked"
    with pytest.raises(ValueError, match="graph route needs CUDA"):
        with step_graph.route("graph"):
            step_graph.StepRunner("cpu")
    with pytest.raises(ValueError, match="not one of"):
        with step_graph.route("fast"):
            pass
    with pytest.raises(RuntimeError, match="outside a step graph"):
        step_graph.on_replay(lambda: None)


# ---------------------------------------------------------------------------
# The restructured schedules against the eager loops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("method", METHODS)
def test_solve_matches_eager(route, dtype, method):
    """Fused likelihood with a padded mask and the PL trace."""
    mat, n0, p0, e0, obs, cfg, _ = _problem(dtype, method=method, T=16)
    res = _hold(route, lambda: solver.solve(mat, n0, p0, e0, cfg, obs=obs))
    assert not bool(res.converged[1])
    assert method == "gauss_seidel" or bool(res.converged[0])


@pytest.mark.parametrize("method", METHODS)
def test_solve_traces_and_segments_match_eager(route, method):
    """PL every 4 steps with the state and iteration traces; then the same
    horizon as two segments."""
    mat, n0, p0, e0, obs, cfg, _ = _problem(torch.float64, method=method, T=16)
    cfg4 = cfg._replace(pl_stride=4, record_state_stride=8, record_iters=True)
    _hold(route, lambda: solver.solve(mat, n0, p0, e0, cfg4))

    def segments():
        first = solver.solve(mat, n0, p0, e0, cfg._replace(num_steps=8),
                             obs=obs._replace(values=obs.values[:, :9],
                                              mask=obs.mask[:, :9]),
                             return_hist=True)
        second = solver.solve(mat, n0, p0, e0, cfg._replace(num_steps=8),
                              obs=obs._replace(values=obs.values[:, 8:],
                                               mask=obs.mask[:, 8:]),
                              start_step=8, init_hist=first.hist,
                              acc0=(first.sse, first.err_sum), return_hist=True)
        return tuple(first) + tuple(second)
    _hold(route, segments)


@pytest.mark.parametrize("method, step_tol", [("gauss_seidel", None),
                                              ("gauss_seidel", 1e-6),
                                              ("coupled_newton", 1e-6)])
def test_all_done_before_max_iters(route, method, step_tol):
    """No sample stuck: every step's loop exits well before max_iters (the
    lagged exit's one extra iteration changes nothing)."""
    mat, n0, p0, e0, obs, cfg, _ = _problem(torch.float64, method=method, nan_sample=False,
                                            max_iters=200, step_tol=step_tol, tol=1e-5,
                                            predictor="previous", T=6)
    res = _hold(route, lambda: solver.solve(mat, n0, p0, e0, cfg, obs=obs))
    assert bool(res.converged.all()) and int(res.max_newton_iters) < 200


@pytest.mark.parametrize("method", METHODS)
def test_coarse_rung_matches_eager(route, method):
    mat, n0, p0, e0, obs, cfg, _ = _problem(torch.float64, method=method)
    _hold(route, lambda: twophase.solve_multiphase(mat, n0, p0, e0, cfg, obs, SCHED))


def _offgrid(dtype, method, nan_sample=True):
    mat, n0, p0, e0, _, cfg, sim = _problem(dtype, method=method, nan_sample=nan_sample)
    t = np.concatenate([[0.0], np.geomspace(0.7 * sim.dt, 38.6 * sim.dt, 30)])
    tables = offgrid.build_offgrid_tables([t], [np.linspace(-2.0, -4.0, t.size)], SCHED,
                                          sim.dt)
    return lambda **kw: offgrid.solve_offgrid(mat, n0, p0, e0, cfg, tables, SCHED,
                                              pl_log_scale(sim), 1e-300, **kw)


@pytest.mark.parametrize("method", METHODS)
def test_offgrid_phase_matches_eager(route, method):
    _hold(route, _offgrid(torch.float64, method))


def _plain(*args):
    return hk.horizon_chord_plain(*args, group=1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("method", ["fused_horizon_chord", "fused_horizon"])
def test_plain_chain_stride_1_and_s_match_eager(route, dtype, method):
    """The fine phase (stride 1) and two coarse rungs (stride 4 and 8)."""
    mat, n0, p0, e0, obs, cfg, _ = _problem(dtype, method=method)
    _hold(route, lambda: twophase.solve_multiphase(mat, n0, p0, e0, cfg, obs, SCHED,
                                                   kernel=_plain))


@pytest.mark.parametrize("method", ["fused_horizon_chord", "fused_horizon"])
def test_plain_chain_offgrid_matches_eager(route, method):
    _hold(route, lambda: _offgrid(torch.float64, method)(kernel=_plain))


@pytest.mark.parametrize("states", [False, True])
def test_plain_record_chain_matches_eager(route, states):
    """The record launch's plain version: the PL trace every 2 steps, with
    the state (every 4) and iteration traces."""
    mat, n0, p0, e0, _, cfg, _ = _problem(torch.float64, method="fused_horizon", T=16)
    cfg = cfg._replace(pl_stride=2, record_state_stride=4 if states else None,
                       record_iters=states)
    _hold(route, lambda: hk.solve_horizon_record(mat, n0, p0, cfg, e_init=e0,
                                                 kernel=_plain))
