"""The port's posterior statistics (bayesian_inference_trpl_tpu_torch/
posterior: stats, PosteriorData, vizconfig) and its histograms
(ops/histogram, the plain versions on the CPU) against the JAX package's
posterior on the CPU, on a seeded 2,000-sample problem built as
tests/test_explorer.py builds one, with NaN likelihoods and columns that
hold NaN and +-inf.

Tolerances: 1e-12 relative.  The port's sums and numpy's run in different
orders, so a quantity whose summed terms cancel (a centred moment, the
variance of a constant column, a skew near 0) is held to 1e-12 of the
terms' size instead (``scale`` below).  Histogram counts are equal.  The
temperatures that scipy's fmin finds are held within 1e-6 relative:
Nelder-Mead compares objective values, and where two objectives differ
in their last bits it may take another path (constant columns, whose
sample uncertainty is rounding noise, are left out for that reason).
"""
import numpy as np
import pytest
import torch

from bayesian_inference_trpl_tpu import native as jnative
from bayesian_inference_trpl_tpu.posterior import PosteriorData as JData
from bayesian_inference_trpl_tpu.posterior import stats as jstats
from bayesian_inference_trpl_tpu.posterior import vizconfig as jviz
from bayesian_inference_trpl_tpu.utils.io import export
from bayesian_inference_trpl_tpu_torch.ops import histogram
from bayesian_inference_trpl_tpu_torch.posterior import PosteriorData as TData
from bayesian_inference_trpl_tpu_torch.posterior import stats as tstats
from bayesian_inference_trpl_tpu_torch.posterior import vizconfig as tviz

torch.set_num_threads(1)

RTOL = 1e-12
TF_RTOL = 1e-6
# Columns that vary (fmin's temperatures are compared on these).
VARYING = ("p0", "mu_n", "B", "Sf", "tau_n", "tau_p", "mu_eff", "tau_eff", "Sf+Sb")


def make_problem(n=2000, seed=7):
    """tests/test_explorer.py's problem; the likelihood peaks at tau_n =
    500, three likelihoods are NaN, the magnitude column m holds NaN and
    Cn holds +-inf at a few rows."""
    rng = np.random.default_rng(seed)
    X = np.zeros((n, 13))
    X[:, 0] = 1e8
    X[:, 1] = 10 ** rng.uniform(14, 16, n)
    X[:, 2] = rng.uniform(0, 50, n)
    X[:, 3] = rng.uniform(0, 50, n)
    X[:, 4] = 10 ** rng.uniform(-11, -9, n)
    X[:, 5] = 10 ** rng.uniform(-1, 2, n)
    X[:, 6] = 10 ** rng.uniform(-1, 2, n)
    X[:, 7] = 1e-29
    X[:, 8] = 1e-29
    X[:, 9] = rng.uniform(1, 1000, n)
    X[:, 10] = rng.uniform(1, 2000, n)
    X[:, 11] = 0.1
    X[:, 12] = 0.0
    X[5::101, 12] = np.nan
    X[7::211, 7] = np.inf
    X[9::307, 7] = -np.inf
    LL = -((X[:, 9] - 500.0) / 50.0) ** 2
    LL[:3] = np.nan
    return LL, X


@pytest.fixture(scope="module")
def problem():
    return make_problem()


def pair(problem, num_observations=3):
    LL, X = problem
    j = JData.from_arrays(LL, X, num_observations=num_observations).compute_secondary()
    t = TData.from_arrays(LL, X, num_observations=num_observations,
                          device="cpu").compute_secondary()
    return t, j


def host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, dtype=float)


def close(port, ref, scale=0.0, rtol=RTOL):
    """|port - ref| <= rtol (|ref| + scale) elementwise; NaN and inf in the
    same places."""
    a, b = host(port), np.asarray(ref, dtype=float)
    assert a.shape == b.shape
    fin = np.isfinite(b)
    assert np.array_equal(np.isnan(a), np.isnan(b)), (a, b)
    assert np.array_equal(a[np.isinf(b)], b[np.isinf(b)]), (a, b)
    tol = (rtol * (np.abs(b) + np.broadcast_to(scale, b.shape)))[fin]
    err = np.abs(a - b)[fin]
    assert (err <= tol).all(), f"max err/tol {np.max(err / np.maximum(tol, 1e-300)):.3g}"


def scale(v, w, k=1):
    """The size of the terms of a k-th weighted moment of ``v``."""
    m = np.isfinite(v)
    return float(np.average(np.abs(v[m]), weights=w[m]) ** k) if m.any() else 0.0


@pytest.fixture(scope="module")
def normalized(problem):
    t, j = pair(problem)
    tau = j.temperature_for_ess(100.0)
    return t.normalize_temperature(tau), j.normalize_temperature(tau)


def test_from_arrays_load_and_secondary_match_jax(problem, tmp_path):
    LL, X = problem
    export(str(tmp_path / "run"), LL, X)
    t = TData.load(str(tmp_path / "run"), thickness=500.0, num_observations=2,
                   device="cpu").compute_secondary()
    j = JData.load(str(tmp_path / "run"), thickness=500.0,
                   num_observations=2).compute_secondary()
    assert list(t.X) == list(j.X) and len(t.X) == 19
    assert t.LL.dtype == torch.float64 and t.LL.device.type == "cpu"
    assert t.LL.numpy().tobytes() == j.LL.tobytes()         # the NaN filter
    for p in j.X:
        close(t.X[p], j.X[p])
    with pytest.raises(ValueError, match="no finite log-likelihoods"):
        TData.from_arrays(np.full(4, np.nan), X[:4], device="cpu")


def test_exclude_limits_matches_jax(problem):
    t, j = pair(problem)
    limits = {"tau_n": (100.0, 900.0), "Sf": (0.5, 50.0), "nope": (0, 1)}
    j.normalize()
    t.normalize()
    assert t.exclude_limits(limits) == j.exclude_limits(limits) < 2000
    assert t.LL.numpy().tobytes() == j.LL.tobytes()
    close(t.P, j.P)
    for p in j.X:
        close(t.X[p], j.X[p])


@pytest.mark.parametrize("t_factor", [None, 0.25, 0.0])
def test_normalize_and_ess_match_jax(problem, t_factor):
    t, j = pair(problem)
    t.normalize(t_factor)
    j.normalize(t_factor)
    close(t.P, j.P)
    close(t.ess(), j.ess())
    t.normalize_temperature(40.0)
    j.normalize_temperature(40.0)
    close(t.P, j.P)
    close(t.ess(), j.ess())


def test_temperatures_match_jax(problem):
    t, j = pair(problem)
    close(t.temperature_for_ess(100.0), j.temperature_for_ess(100.0))
    close(t.temperature_for_ess(1e9), j.temperature_for_ess(1e9))
    close(t.auto_temperature(list(VARYING)), j.auto_temperature(list(VARYING)),
          rtol=TF_RTOL)
    mt, mj = t.max_uncertainty(), j.max_uncertainty()
    assert list(mt) == list(mj)
    for p in VARYING:
        close(mt[p], mj[p], rtol=TF_RTOL)


@pytest.mark.parametrize("param", ["p0", "tau_n", "Sf+Sb"])
def test_find_best_tf_bracketed_matches_jax(problem, param):
    t, j = pair(problem)
    close(tstats.find_best_tf_bracketed(t.X[param], t.LL),
          jstats.find_best_tf_bracketed(j.X[param], j.LL), rtol=TF_RTOL)


def test_summaries_match_jax(normalized):
    t, j = normalized
    st, sj = t.stats_summary(), j.stats_summary()
    assert list(st) == list(sj)
    w = j.P
    for p in sj:
        v = j.X[p]
        close(st[p][0], sj[p][0], scale(v, w))
        close(st[p][1], sj[p][1], np.sqrt(sj[p][2]) * scale(v, w))
        close(st[p][2], sj[p][2])
    ct, cj = t.credible_intervals(), j.credible_intervals()
    for p in cj:
        close(ct[p], cj[p])
    ct, cj = t.credible_intervals(0.1, 0.6), j.credible_intervals(0.1, 0.6)
    for p in cj:
        close(ct[p], cj[p])
    params = ["p0", "B", "tau_n", "mu_eff", "n0", "m"]
    sc = np.array([scale(j.X[p], w) for p in params])
    close(t.covariance(params), j.covariance(params), np.outer(sc, sc))


def test_stats_functions_match_jax(normalized):
    t, j = normalized
    w, tw = j.P, t.P
    close(tstats.normalize(t.LL), jstats.normalize(j.LL))
    lnp = np.array([-1e6, -1e6 + 3.0, -2e6, np.nan])
    close(tstats.normalize(lnp), jstats.normalize(lnp))
    for p in ("p0", "tau_n", "mu_n", "m", "Cn"):
        v, tv = j.X[p], t.X[p]
        close(tstats.w_mean(tv, tw), jstats.w_mean(v, w), scale(v, w))
        close(tstats.w_variance(tv, tw), jstats.w_variance(v, w), scale(v, w, 2))
        ws = np.sum(w ** 2)
        close(tstats.w_sample_var(tv, tw, torch.tensor(ws)), jstats.w_sample_var(v, w, ws),
              np.sqrt(ws) * scale(v, w))
        if p in VARYING:
            var = jstats.w_variance(v, w)
            close(tstats.w_skew(tv, tw), jstats.w_skew(v, w), scale(v, w, 3) / var ** 1.5)
            close(tstats.w_kurtosis(tv, tw), jstats.w_kurtosis(v, w), scale(v, w, 4) / var ** 2)
        close(tstats.credible_interval(tv, tw), jstats.credible_interval(v, w))
        close(tstats.covariance(tv, t.X["tau_n"], tw), jstats.covariance(v, j.X["tau_n"], w),
              scale(v, w) * scale(j.X["tau_n"], w))


@pytest.mark.parametrize("param,log", [("p0", True), ("tau_n", False), ("mu_n", False),
                                       ("tau_eff", True), ("Sf+Sb", False),
                                       ("Cn", False), ("n0", False)])
def test_marginal_1d_matches_jax(normalized, param, log):
    """Default bounds, and fixed ones that cut samples; mu and secondary
    columns take the density correction; n0 is constant (the empty range
    JAX hands to numpy's histogram); Cn holds +-inf (so its default bounds
    do too)."""
    t, j = normalized
    for bounds in (None, (0.1, 0.7) if param != "p0" else (14.5, 15.5)):
        if bounds is not None and not log:
            v = j.X[param][np.isfinite(j.X[param])]
            bounds = tuple(np.quantile(v, bounds)) if np.ptp(v) else None
        with np.errstate(all="ignore"):
            mj = j.marginal_1d(param, bounds=bounds, bins=48, log=log)
        mt = t.marginal_1d(param, bounds=bounds, bins=48, log=log)
        for a, b in zip(mt, mj):
            close(a, b)


@pytest.mark.parametrize("px,py,lx,ly", [("p0", "tau_n", True, False),
                                         ("B", "Sf", True, True),
                                         ("tau_eff", "mu_eff", False, False),
                                         ("n0", "tau_n", False, False)])
def test_marginal_2d_matches_jax(normalized, px, py, lx, ly):
    t, j = normalized
    with np.errstate(all="ignore"):
        mj = j.marginal_2d(px, py, bins=32, log_x=lx, log_y=ly)
    mt = t.marginal_2d(px, py, bins=32, log_x=lx, log_y=ly)
    for a, b in zip(mt, mj):
        assert tuple(a.shape) == b.shape
        close(a, b)


def pinned_samples(n=3000, seed=11):
    """Samples on a grid of 16 values with NaN and +-inf, and weights >= 0
    with zeros: a pinned range at a grid value has samples below, at and
    above it."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 16, n) / 4.0
    x[::97] = np.nan
    x[1::131] = np.inf
    x[2::173] = -np.inf
    w = rng.uniform(size=n)
    w[::7] = 0.0
    return x, w


@pytest.mark.parametrize("bounds", [(1.25, 1.25), (-3.0, -3.0), (0.0, 0.0),
                                    (np.nan, 2.0), (1.0, np.nan)])
@pytest.mark.parametrize("correct", [False, True])
def test_degenerate_marginal_1d_matches_jax(bounds, correct):
    """An empty range (a pinned parameter) or a NaN bound: JAX runs numpy's
    histogram there, the port the same rule in torch ops on the tensors'
    device; the edges, the density (inf and NaN in the same bins) and the
    density-corrected one agree."""
    x, w = pinned_samples()
    with np.errstate(all="ignore"):
        mj = jstats.marginalize_1d(w, bounds, 12, x, density_correct=correct)
    mt = tstats.marginalize_1d(torch.tensor(w), bounds, 12, torch.tensor(x),
                               density_correct=correct)
    for a, b in zip(mt, mj):
        close(a, b)


@pytest.mark.parametrize("bx,by", [((1.25, 1.25), (0.0, 3.75)), ((0.0, 3.75), (2.5, 2.5)),
                                   ((0.5, 0.5), (0.5, 0.5)), ((np.nan, 1.0), (0.0, 3.75)),
                                   ((9.0, 9.0), (0.0, 3.75))])
def test_degenerate_marginal_2d_matches_jax(bx, by):
    """numpy's histogram2d where either range is empty or NaN: its binning
    (searchsorted, the last edge in the last bin), then inf, -inf or NaN in
    each cell by the sign of its sum."""
    x, w = pinned_samples()
    y = pinned_samples(seed=12)[0]
    with np.errstate(all="ignore"):
        mj = jstats.marginalize_2d(w, bx, by, 10, x, y)
    mt = tstats.marginalize_2d(torch.tensor(w), bx, by, 10, torch.tensor(x), torch.tensor(y))
    for a, b in zip(mt, mj):
        assert tuple(a.shape) == b.shape
        close(a, b)


def test_decreasing_marginal_range_raises_as_numpy():
    x, w = (torch.tensor(v) for v in pinned_samples())
    with pytest.raises(ValueError, match="monotonically"):
        np.histogram(x.numpy(), weights=w.numpy(), bins=np.linspace(2.0, 1.0, 5))
    with pytest.raises(ValueError, match="must increase monotonically"):
        tstats.marginalize_1d(w, (2.0, 1.0), 4, x)
    with pytest.raises(ValueError, match=r"bins\[1\]"):
        tstats.marginalize_2d(w, (1.0, 1.0), (2.0, 1.0), 4, x, x)


def edge_samples(rng, n=5000, lo=-1.0, hi=3.0):
    """Samples with NaN, +-inf, values on both edges and just outside."""
    x = rng.uniform(lo - 0.5, hi + 0.5, n)
    x[::50] = np.nan
    x[1::70] = np.inf
    x[2::90] = -np.inf
    x[3::30] = lo
    x[4::40] = hi
    x[5::60] = np.nextafter(hi, np.inf)
    x[6::80] = np.nextafter(lo, -np.inf)
    return x


@pytest.mark.parametrize("bins", [1, 7, 96])
def test_hist_counts_equal_jax_native(bins):
    """The plain histograms (what the CPU runs) against JAX's native ones:
    counts equal, sums within 1e-12; NaN and +-inf dropped, x == hi in the
    last bin."""
    rng = np.random.default_rng(bins)
    x, y = edge_samples(rng), edge_samples(rng, lo=0.0, hi=1e-9)
    w = rng.uniform(size=x.size)
    tw, tc = histogram.hist1d_weighted(torch.tensor(x), torch.tensor(w), -1.0, 3.0, bins)
    jw, jc = jnative.hist1d_weighted(x, w, -1.0, 3.0, bins)
    assert tc.dtype == torch.int64 and tc.numpy().tolist() == jc.tolist()
    close(tw, jw)
    assert int(tc.sum()) == int(np.sum((x >= -1.0) & (x <= 3.0)))
    h = histogram.hist2d_weighted(torch.tensor(x), torch.tensor(y), torch.tensor(w),
                                  -1.0, 3.0, bins, 0.0, 1e-9, bins + 1)
    assert tuple(h.shape) == (bins, bins + 1)
    close(h, jnative.hist2d_weighted(x, y, w, -1.0, 3.0, bins, 0.0, 1e-9, bins + 1))
    ones = np.ones_like(w)
    h1 = histogram.hist2d_weighted(torch.tensor(x), torch.tensor(y), torch.tensor(ones),
                                   -1.0, 3.0, bins, 0.0, 1e-9, bins + 1)
    assert h1.numpy().tolist() == jnative.hist2d_weighted(
        x, y, ones, -1.0, 3.0, bins, 0.0, 1e-9, bins + 1).tolist()


def test_hist_rejects_bad_inputs():
    x = torch.zeros(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="bins must be positive"):
        histogram.hist1d_weighted(x, x, 0.0, 1.0, 0)
    with pytest.raises(ValueError, match="unsupported device"):
        histogram.hist1d_weighted(x.to("meta"), x.to("meta"), 0.0, 1.0, 4)


def test_vizconfig_writes_jax_bytes(tmp_path):
    cfgs = []
    for mod in (tviz, jviz):
        cfg = mod.VizConfig(do_log={"p0": True, "tau_n": False, "tau_eff": True},
                            ranges={"p0": (1e14, 1e16), "Sf+Sb": (0.2, 150.0)},
                            enabled={"p0": True, "B": False, "mu_eff": True},
                            marks={"p0": 3e15, "B": None}, thickness=500.0,
                            num_observations=4)
        path = tmp_path / f"{mod.__name__.split('.')[0]}.txt"
        mod.save_vizconfig(cfg, str(path))
        cfgs.append(path.read_bytes())
        back = mod.load_vizconfig(str(path))
        assert back == cfg
    assert cfgs[0] == cfgs[1]
    assert vars(tviz.load_vizconfig(str(path))) == vars(jviz.load_vizconfig(str(path)))
