"""The grid-refinement (legacy) pipeline, the device sampler and the warmup
tool of the port against the JAX package on the CPU.

* ``model_err`` is bitwise the JAX package's; ``forward_lnp`` sums the time
  points in torch's order where the JAX package subtracts them one by one,
  so it is held within LNP_RTOL of each row's sum of its terms' magnitudes
  (float64: a reordered sum of n terms is within n x 1.1e-16 of that sum;
  1e-12 leaves room for 401 observation times and a last-bit log).  With
  a float32 PL the JAX loop squares the model error as a np.float32 scalar
  (``sig.max() ** 2``), a power that numpy does not always round
  correctly: one float32 ulp off torch's square at some values
  (test_float32_square_rounding), which moves a term by up to 2^-23 of
  itself, so LNP_RTOL_F32 is two float32 ulps;
  ``marginal_p`` is numpy in both and bitwise.
* ``grid_refine_bayes``: N identical and P within P_RTOL; the port's
  per-level batching bitwise equal to one forward call per block.
* End to end with ``make_trpl_forward(device="cpu", dtype=torch.float64)``
  at tests/test_legacy_pipeline.py's setup (its JAX run is the reference,
  computed once), through the step loop and through the record route that
  the card runs (the horizon kernel's plain version here).
* ``random_grid_device`` against the JAX sampler's semantics (torch's
  streams are not jax.random's).
* ``tools/warmup.main --device cpu``: one chunk per curve, nothing left.
"""
import os

import numpy as np
import pytest
import torch

import jax
from bayesian_inference_trpl_tpu import physics as jphysics
from bayesian_inference_trpl_tpu.models.driver import SimParams as JSimParams
from bayesian_inference_trpl_tpu.utils import legacy_pipeline as jlp
from bayesian_inference_trpl_tpu.utils import sampling as jsamp
from bayesian_inference_trpl_tpu_torch import config as tcfg
from bayesian_inference_trpl_tpu_torch import pipeline as tpipe
from bayesian_inference_trpl_tpu_torch.models.driver import SimParams
from bayesian_inference_trpl_tpu_torch.parallel import runner as trunner
from bayesian_inference_trpl_tpu_torch.tools import warmup
from bayesian_inference_trpl_tpu_torch.utils import legacy_pipeline as tlp
from bayesian_inference_trpl_tpu_torch.utils import sampling as tsamp

torch.set_num_threads(1)

LNP_RTOL = 1e-12
LNP_RTOL_F32 = 2.4e-7
P_RTOL = 1e-9
REFS = [[4], [2, 2], [3, 2, 1], [1, 4, 1, 4], [2] * 10,
        [1, 1, 1, 1, 2, 2, 1, 1, 1, 2, 2, 1, 1]]


def _terms_scale(F, values, std, ref):
    """Each row's sum of the magnitudes of the JAX loop's terms."""
    F = np.asarray(F)
    scale = np.zeros(len(F))
    for n in range(F.shape[1]):
        sg2 = 2.0 * (jlp.model_err(F[:, n], ref).max() ** 2 + std[n] ** 2)
        scale += (F[:, n] - values[n]) ** 2 / sg2 + abs(np.log(np.pi * sg2) / 2.0)
    return scale


def _close_lnp(a, b, scale, rtol=LNP_RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype == np.float64
    assert np.all(np.abs(a - b) <= rtol * scale)


# ---------------------------------------------------------------------------
# The three helpers
# ---------------------------------------------------------------------------

def test_model_err_reference_cases():
    """tests/test_legacy_pipeline.py's 1-D and 2 x 2 cases on the port."""
    err = tlp.model_err(torch.tensor([1.0, 2.0, 4.0, 8.0], dtype=torch.float64), [4])
    assert err.shape == (1,) and err[0] == 4.0
    err = tlp.model_err(torch.tensor([0.0, 1.0, 10.0, 11.0], dtype=torch.float64), [2, 2])
    np.testing.assert_array_equal(err.numpy(), [1.0, 10.0])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("ref", REFS, ids=lambda r: "x".join(map(str, r)))
def test_model_err_and_forward_lnp_match_jax(ref, dtype):
    """One block's model error bitwise, with NaN where a row has one; its
    likelihood (and that of three blocks in one call, each against the
    JAX package's per-block result) within LNP_RTOL."""
    rng = np.random.default_rng(len(ref) * 7 + (dtype == np.float32))
    n = int(np.prod(ref))
    F = rng.random((3 * n, 37)).astype(dtype) * 10
    values, std = rng.random(37) * 10, rng.random(37) * 0.1
    for f in (F[:n, 0], F[:n, 5:9].T):
        a = np.stack([jlp.model_err(row, ref) for row in np.atleast_2d(f)])
        b = tlp.model_err(torch.as_tensor(np.atleast_2d(f)), ref).numpy()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    nan = F[:n, 0].copy()
    nan[n // 2] = np.nan
    np.testing.assert_array_equal(jlp.model_err(nan, ref),
                                  tlp.model_err(torch.as_tensor(nan), ref).numpy())
    b = tlp.forward_lnp(torch.as_tensor(F), values, std, ref).numpy()
    blocks = range(0, 3 * n, n)
    a = np.concatenate([jlp.forward_lnp(F[k:k + n], values, std, ref) for k in blocks])
    _close_lnp(a, b, np.concatenate([_terms_scale(F[k:k + n], values, std, ref)
                                     for k in blocks]),
               LNP_RTOL if dtype == np.float64 else LNP_RTOL_F32)


def test_forward_lnp_prefers_match_and_whole_blocks():
    values, std = np.array([1.0, 0.5]), np.array([0.01, 0.01])
    F = torch.tensor([[1.0, 0.5], [1.3, 0.8]], dtype=torch.float64)
    lnp = tlp.forward_lnp(F, values, std, [2])
    assert lnp[0] > lnp[1]
    _close_lnp(jlp.forward_lnp(F.numpy(), values, std, [2]), lnp.numpy(),
               _terms_scale(F.numpy(), values, std, [2]))
    with pytest.raises(ValueError, match="whole blocks"):
        tlp.forward_lnp(F[:1], values, std, [2])


def test_float32_square_rounding():
    """A model error from a card run of the legacy pipeline (float32 PL):
    numpy's np.float32 power rounds its square one ulp above the correctly
    rounded square that torch computes (x * x), which put that run's block
    6.6e-12 of its terms' magnitude off the JAX loop's likelihood; here a
    two-cell block with that model error: outside LNP_RTOL, within
    LNP_RTOL_F32."""
    x = np.float32(1.4811359e-05)
    exact = np.float32(float(x) * float(x))
    assert (torch.tensor([x]) ** 2).numpy()[0] == exact == x * x
    assert x ** 2 == np.nextafter(exact, np.float32(1))
    F = np.zeros((2, 1), np.float32)
    F[1, 0] = x
    values, std = np.zeros(1), np.full(1, 1e-7)
    a = jlp.forward_lnp(F, values, std, [2])
    b = tlp.forward_lnp(torch.as_tensor(F), values, std, [2]).numpy()
    scale = _terms_scale(F, values, std, [2])
    assert not np.all(np.abs(a - b) <= LNP_RTOL * scale)
    _close_lnp(a, b, scale, LNP_RTOL_F32)


@pytest.mark.parametrize("refs", [[[4, 4, 1, 2]], [[4, 4, 1, 2], [2, 2, 1, 2]],
                                  [[2, 3], [3, 1], [1, 2]]])
def test_marginal_p_matches_jax(refs):
    rng = np.random.default_rng(3)
    N = np.array([0])
    for ref in refs:
        N = tsamp.refine_grid(N[rng.random(len(N)) < 0.7] if len(N) > 1 else N, ref)
    P = rng.random(len(N))
    P /= P.sum()
    for a, b in zip(jlp.marginal_p(N, P, refs), tlp.marginal_p(N, P, refs)):
        assert a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# grid_refine_bayes with a closed-form, row-wise forward
# ---------------------------------------------------------------------------

TIMES = np.linspace(0.0, 1.0, 21)
BOX = dict(min_x=[0.1, 0.0, 5.0, 1.0], max_x=[10.0, 2.0, 5.0, 100.0], do_log=[1, 0, 0, 1])
BOX_REFS = [[4, 4, 1, 2], [2, 2, 1, 2], [2, 1, 1, 2]]
BOX_MIN_P = [0.0, 1e-4, 1e-3]


def closed_form(X):
    """PL-like curves a exp(-b t) + 1e-3 d t of each row of X."""
    X = np.asarray(X)
    return X[:, :1] * np.exp(-TIMES * X[:, 1:2]) + 1e-3 * X[:, 3:4] * TIMES


def box_data():
    rng = np.random.default_rng(11)
    values = closed_form(np.array([[1.3, 0.7, 5.0, 20.0]]))[0]
    values = values * (1 + 0.01 * rng.standard_normal(TIMES.size))
    return TIMES, values, np.full(TIMES.size, 0.01)


class Counting:
    def __init__(self, fn):
        self.fn, self.rows = fn, []

    def __call__(self, X):
        self.rows.append(len(X))
        return self.fn(X)


def test_grid_refine_closed_form_matches_jax():
    N_j, P_j = jlp.grid_refine_bayes(closed_form, BOX_REFS, min_p=BOX_MIN_P,
                                     data=box_data(), **BOX)
    fwd = Counting(closed_form)
    N_t, P_t = tlp.grid_refine_bayes(fwd, BOX_REFS, min_p=BOX_MIN_P, data=box_data(), **BOX)
    assert N_t.tobytes() == N_j.tobytes()
    np.testing.assert_allclose(P_t, P_j, rtol=P_RTOL, atol=0)
    assert abs(P_t.sum() - 1.0) < 1e-12
    # One call per level: every level holds fewer than MAX_BATCH cells.
    assert len(fwd.rows) == len(BOX_REFS) and sum(fwd.rows) > len(N_t)


@pytest.mark.parametrize("forward", ["closed_form", "record_route"])
def test_batching_bitwise_per_block(forward):
    """Per-level slices of whole blocks (the default, a ragged slice of
    two blocks, one block per call) give bitwise the same N and P.  The
    record route's plain version takes each decision per sample, as the
    kernel does (C4), so a row does not depend on its batch-mates."""
    if forward == "closed_form":
        fn, refs, box, min_p, data = closed_form, BOX_REFS, BOX, BOX_MIN_P, box_data()
    else:
        fn, data = _trpl_forward("fused_horizon")
        refs, box, min_p = E2E_REFS, E2E_BOX, E2E_MIN_P
    runs = []
    for max_batch in (tlp.MAX_BATCH, 2 * int(np.prod(refs[-1])) + 1, 1):
        fwd = Counting(fn)
        runs.append((tlp.grid_refine_bayes(fwd, refs, min_p=min_p, data=data,
                                           max_batch=max_batch, **box), fwd.rows))
    (N0, P0), rows0 = runs[0]
    for (N, P), rows in runs[1:]:
        assert N.tobytes() == N0.tobytes() and P.tobytes() == P0.tobytes()
        assert sum(rows) == sum(rows0) and len(rows) > len(rows0)
    per_block = runs[-1][1]
    assert set(per_block) <= {int(np.prod(r)) for r in refs}


# ---------------------------------------------------------------------------
# End to end with the TRPL forward (tests/test_legacy_pipeline.py's setup)
# ---------------------------------------------------------------------------

TRUE_P0, TRUE_B = 1e15, 5e-10
E2E_BOX = dict(
    min_x=np.array([1e8, 1e14, 20.0, 20.0, 1e-11, 10.0, 10.0, 1e-29, 1e-29, 500.0,
                    800.0, 0.1, 0.0]),
    max_x=np.array([1e8, 1e16, 20.0, 20.0, 1e-9, 10.0, 10.0, 1e-29, 1e-29, 500.0,
                    800.0, 0.1, 0.0]),
    do_log=np.array([0, 1, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0]))
E2E_REFS = [np.array([1, 4, 1, 1, 4, 1, 1, 1, 1, 1, 1, 1, 1]),
            np.array([1, 2, 1, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1])]
E2E_MIN_P = [0.0, 1e-3]
E2E_SIM = dict(length=311.0, time=0.5, L=128, T=10, pl_stride=1, tol_exp=7, max_iters=1000)
INI = (1e18 / 1e7 ** 3, 100.0)
CONV = np.concatenate([jphysics.UNIT_CONVERSIONS[:12], [1.0]])


def _truth():
    x = E2E_BOX["min_x"].copy()
    x[1], x[4] = TRUE_P0, TRUE_B
    return x


def _trpl_forward(method):
    """The port's forward in user units and the observations it makes at
    the truth (std 1e-8), as tests/test_legacy_pipeline.py builds them."""
    user = tlp.make_trpl_forward(SimParams(method=method, **E2E_SIM), INI, "exp",
                                 dtype=torch.float64, device="cpu")

    def forward(X):
        return user(np.asarray(X) * CONV)
    values = forward(_truth()[None])[0].numpy()
    return forward, (SimParams(**E2E_SIM).pl_times, values, np.full(values.size, 1e-8))


@pytest.fixture(scope="module")
def jax_e2e():
    """The JAX package's run of tests/test_legacy_pipeline.py's setup."""
    user = jlp.make_trpl_forward(JSimParams(**E2E_SIM), INI, "exp")

    def forward(X):
        return user(np.asarray(X) * CONV)
    values = forward(_truth()[None])[0]
    data = (JSimParams(**E2E_SIM).pl_times, values, np.full(values.size, 1e-8))
    out = jlp.grid_refine_bayes(forward, E2E_REFS, min_p=E2E_MIN_P, data=data, **E2E_BOX)
    jax.clear_caches()
    return out, values


@pytest.mark.parametrize("method", ["coupled_newton", "fused_horizon"])
def test_grid_refine_trpl_matches_jax_and_recovers_truth(jax_e2e, method):
    """coupled_newton is the JAX package's step loop; fused_horizon takes
    the record route (one launch per level on the card), whose full-Newton
    body equals that loop within 1e-12 (C7)."""
    (N_j, P_j), values_j = jax_e2e
    forward, data = _trpl_forward(method)
    np.testing.assert_allclose(data[1], values_j, rtol=1e-10)
    fwd = Counting(forward)
    N, P = tlp.grid_refine_bayes(fwd, E2E_REFS, min_p=E2E_MIN_P, data=data, **E2E_BOX)
    assert len(fwd.rows) == len(E2E_REFS)
    assert N.tobytes() == N_j.tobytes()
    np.testing.assert_allclose(P, P_j, rtol=P_RTOL, atol=0)
    # tests/test_legacy_pipeline.py's assertions, on the port alone.
    assert np.isclose(P.sum(), 1.0)
    best = np.argmax(P)
    ind = tsamp.index_grid(N[best:best + 1], E2E_REFS)
    X = tsamp.param_grid(ind, E2E_REFS, E2E_BOX["min_x"], E2E_BOX["max_x"],
                         E2E_BOX["do_log"])[0]
    assert abs(np.log10(X[4] / TRUE_B)) < 0.5
    marg = tlp.marginal_p(N, P, E2E_REFS)
    b_centers = 10 ** (-11 + 2 * (np.arange(8) + 0.5) / 8)
    near = np.abs(np.log10(b_centers / TRUE_B)) < 0.5
    assert marg[4][near].sum() > 0.8, marg[4]


def test_make_trpl_forward_log_pl_and_cuda_refusal(monkeypatch):
    sim = SimParams(method="fused_horizon", **E2E_SIM)
    X = _truth()[None] * CONV
    pl = tlp.make_trpl_forward(sim, INI, dtype=torch.float64, device="cpu")(X)
    lg = tlp.make_trpl_forward(sim, INI, dtype=torch.float64, log_pl=True, device="cpu")(X)
    assert pl.shape == (1, sim.num_pl) and pl.dtype == torch.float64
    torch.testing.assert_close(lg, torch.log10(pl), rtol=0, atol=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA requested"):
        tlp.make_trpl_forward(sim, INI)


# ---------------------------------------------------------------------------
# random_grid_device (tests/test_sampling.py::test_device_sampler_bounds)
# ---------------------------------------------------------------------------

MIN_X = [1e8, 1e14, 0.0, 0.0, 1e-11, 0.0, 0.0, 1e-30, 1e-30, 1.0, 1.0, 0.1, 0.0]
MAX_X = [1e8, 1e16, 50.0, 50.0, 1e-9, 100.0, 0.0, 1e-28, 1e-28, 1000.0, 2000.0, 0.1, 0.0]
DO_LOG = [1, 1, 0, 0, 1, 1, 1, 1, 1, 0, 0, 1, 0]


def _moments(X):
    """Per free dimension: the mean and variance of log10(x) on log axes
    (a zero lower bound counts as 1, the guard) and of x on linear ones."""
    X = np.asarray(X, float)
    free = np.array(MIN_X) != np.array(MAX_X)
    Y = np.where(np.array(DO_LOG, bool), np.log10(np.where(X > 0, X, 1.0)), X)[:, free]
    return Y.mean(0), Y.var(0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_random_grid_device_semantics(dtype):
    n = 100_000
    X = tsamp.random_grid_device(torch.Generator().manual_seed(7), MIN_X, MAX_X, DO_LOG, n,
                                 dtype=dtype)
    assert X.shape == (n, 13) and X.dtype == dtype and X.device.type == "cpu"
    lo = torch.tensor(MIN_X, dtype=dtype)
    hi = torch.tensor(MAX_X, dtype=dtype)
    pinned = lo == hi
    assert torch.equal(X[:, pinned], lo[pinned].expand(n, -1))       # incl. 0 on a log axis
    assert bool(((X >= lo) & (X <= hi)).all())
    # The guard: a log axis from 0 draws log-uniform from 1 (log10 0) up.
    assert float(X[:, 5].min()) >= 1.0
    med = float(X[:, 1].median())
    assert 3e14 < med < 3.3e15
    # Uniform in log10 (log axes) or in x (linear): mean and variance
    # within 6 standard errors of the uniform law's.
    a = np.where(DO_LOG, np.log10(np.where(np.array(MIN_X) > 0, MIN_X, 1.0)), MIN_X)
    b = np.where(DO_LOG, np.log10(np.where(np.array(MAX_X) > 0, MAX_X, 1.0)), MAX_X)
    free = np.array(MIN_X) != np.array(MAX_X)
    w = (b - a)[free]
    mean, var = _moments(X.numpy())
    assert np.all(np.abs(mean - (a[free] + b[free]) / 2) <= 6 * w / np.sqrt(12 * n))
    # The variance of a uniform is w^2/12; that of the sample variance is
    # (mu_4 - sigma^4) / n with mu_4 = w^4/80.
    assert np.all(np.abs(var - w ** 2 / 12) <= 6 * w ** 2 * np.sqrt((1 / 80 - 1 / 144) / n))
    # The JAX sampler on the same box: the same moments within 6 standard
    # errors of a difference of two such means.
    Xj = np.asarray(jsamp.random_grid_device(jax.random.key(7), MIN_X, MAX_X, DO_LOG, n))
    mean_j, _ = _moments(Xj)
    assert np.all(np.abs(mean - mean_j) <= 6 * w * np.sqrt(2 / (12 * n)))


def test_random_grid_device_determinism():
    def draw(seed):
        return tsamp.random_grid_device(torch.Generator().manual_seed(seed), MIN_X, MAX_X,
                                        DO_LOG, 1000)
    assert torch.equal(draw(3), draw(3))
    assert not torch.equal(draw(3), draw(4))


# ---------------------------------------------------------------------------
# tools/warmup
# ---------------------------------------------------------------------------

def test_warmup_one_chunk_per_curve(tmp_path, monkeypatch, capsys):
    """A legacy-grid config (random_sample = false, whose num_points would
    count cells per free dimension) warms up on one random chunk per
    curve; checkpointing off; nothing left in its out_dirs or the
    temporary directory."""
    L, T, chunk, curves = 32, 8, 4, 2
    xg = (np.arange(L) + 0.5) * (311.0 / L)
    exc, obs = tmp_path / "exc.csv", tmp_path / "obs.csv"
    exc.write_text("".join(",".join(f"{v / 1e-21:.8e}" for v in
                                    (0.5 + c) * 1e-3 * np.exp(-xg / 100.0)) + "\n"
                           for c in range(curves)))
    t = np.arange(T + 1) * (0.2 / T)
    obs.write_text("".join(f"{a:.6f},{2e-3 * np.exp(-a / 3.0) / 1e-23:.10e},1e13\n"
                           for _ in range(curves) for a in t) + "END,,\n")
    out = tmp_path / "OUT"
    cfg = tcfg.InferenceConfig(
        grid=tcfg.GridConfig(thickness=311.0, time=0.2, num_nodes=L, num_steps=T,
                             tol_exp=7, max_iters=8, method="fused_horizon_chord",
                             predictor="quadratic", step_tol=1e-9),
        params=tcfg.ParamSpace(
            min_x=[1e8, 1e14, 1.0, 1.0, 1e-11, 1.0, 1.0, 1e-30, 1e-30, 20.0, 20.0, 0.1, 0.0],
            max_x=[1e8, 1e16, 50.0, 50.0, 1e-9, 100.0, 100.0, 1e-28, 1e-28, 1000.0, 2000.0,
                   0.1, 0.0]),
        ic_flags=tcfg.IcFlags(time_cutoff=None),
        sim_flags=tcfg.SimFlags(random_sample=False, num_points=2, seed=42),
        device=tcfg.DeviceConfig(chunk_per_device=chunk, n_devices=1, dtype="float64"),
        paths=tcfg.Paths(init_file=str(exc), observation_files=[str(obs)],
                         out_dirs=[str(out)]),
        checkpoint=True)
    toml = tmp_path / "tiny.toml"
    toml.write_text(tcfg.dump_config(cfg))

    seen, curves_run = [], []
    real_bayes, real_run = tpipe.bayes, trunner.Runner.run_curve

    def spy_bayes(c, *a, **k):
        seen.append((c.sim_flags.random_sample, c.sim_flags.num_points, c.checkpoint,
                     c.paths.out_dirs[0], k.get("device")))
        P, X, info = real_bayes(c, *a, **k)
        seen.append(P.shape)
        return P, X, info

    def spy_run(self, X, *a, **k):
        curves_run.append(len(X))
        return real_run(self, X, *a, **k)
    monkeypatch.setattr(tpipe, "bayes", spy_bayes)
    monkeypatch.setattr(trunner.Runner, "run_curve", spy_run)
    assert warmup.main([str(toml), "--device", "cpu"]) == 0
    (rs, n, ckpt, td, dev), shape = seen
    assert (rs, n, ckpt, dev) == (True, chunk, False, "cpu") and shape == (1, chunk)
    assert curves_run == [chunk] * curves
    assert not out.exists() and not os.path.exists(td)
    assert "warmup: one chunk per curve" in capsys.readouterr().out
