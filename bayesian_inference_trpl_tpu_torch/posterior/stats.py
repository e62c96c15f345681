"""Weighted posterior statistics on float64 tensors, on the tensors' device.

The JAX package's posterior/stats.py (the reference's post-processing math,
Visualization/utils.py:157-284): underflow-safe normalization of
log-likelihoods, weighted moments, covariance, credible intervals,
marginal histograms with the nonuniform-sampling correction, and the
max-uncertainty temperature search.  The temperature search keeps scipy's
``fmin`` on the host around an objective computed on the device; the
marginals bin through ops/histogram (the CUDA kernels on the card).  Host
numpy runs only where the JAX package's does on scalars.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from scipy.optimize import fmin

from ..ops import histogram

_LN2_1000 = 1000 * np.log(2)


def _t(x) -> torch.Tensor:
    """``x`` as a float64 tensor (kept on its device if it is a tensor)."""
    if isinstance(x, torch.Tensor):
        return x if x.dtype == torch.float64 else x.to(torch.float64)
    return torch.as_tensor(np.asarray(x, dtype=float))


def nanmax(x: torch.Tensor) -> torch.Tensor:
    """np.nanmax: the largest non-NaN value (NaN if every value is)."""
    m = torch.where(torch.isnan(x), torch.full_like(x, -math.inf), x).max()
    return torch.where(torch.isnan(x).all(), torch.full_like(m, math.nan), m)


def nanmedian(x: torch.Tensor) -> float:
    """np.nanmedian: the mean of the two middle non-NaN values of an even
    count (torch.nanmedian takes the lower one)."""
    v = torch.sort(x[~torch.isnan(x)]).values
    n = v.numel()
    if n == 0:
        return math.nan
    if n % 2:
        return float(v[n // 2])
    return float(np.mean(v[n // 2 - 1:n // 2 + 1].cpu().numpy()))


def normalize(lnP):
    """exp-normalize log-likelihoods without mass underflow
    (reference: Visualization/utils.py:157-166): shift so the max is at a
    large-but-safe exponent, then normalize by the sum."""
    lnP = _t(lnP)
    out = torch.exp(lnP - nanmax(lnP) + _LN2_1000 - np.log(lnP.numel()))
    return out / torch.nansum(out)


def _average(val, wts):
    """np.average(val, weights=wts), as a 0-dim tensor."""
    return (val * wts).sum() / wts.sum()


def w_mean(val, wts):
    return _average(_t(val), _t(wts))


def w_variance(val, wts):
    val, wts = _t(val), _t(wts)
    return _average((val - _average(val, wts)) ** 2, wts)


def w_skew(val, wts):
    val, wts = _t(val), _t(wts)
    return _average((val - _average(val, wts)) ** 3, wts) / w_variance(val, wts) ** 1.5


def w_kurtosis(val, wts):
    val, wts = _t(val), _t(wts)
    return _average((val - _average(val, wts)) ** 4, wts) / w_variance(val, wts) ** 2


def w_sample_var(val, wts, ws):
    """sqrt(sum(w^2) * weighted variance) (reference: utils.py:168-170)."""
    return torch.sqrt(ws * w_variance(val, wts))


def covariance(X, Y, weights):
    X, Y, weights = _t(X), _t(Y), _t(weights)
    ax = _average(X, weights)
    ay = _average(Y, weights)
    return _average((X - ax) * (Y - ay), weights)


def covariance_matrix(columns, weights):
    """Symmetric covariance (n, n) over a list of parameter columns."""
    cols = list(columns)
    n = len(cols)
    dev = _t(weights).device
    cov = torch.zeros((n, n), dtype=torch.float64, device=dev)
    for i in range(n):
        for j in range(i, n):
            cov[i, j] = cov[j, i] = covariance(cols[i], cols[j], weights)
    return cov


def credible_interval(X, P, lo: float = 0.025, hi: float = 0.975):
    """Equal-tail credible interval (floats) from normalized weights
    (reference: utils.py:185-197)."""
    X, P = _t(X), _t(P)
    X_s, order = torch.sort(X, stable=True)
    s = torch.cumsum(P[order], 0)
    below = torch.nonzero(s < lo).flatten()
    above = torch.nonzero(s > hi).flatten()
    i_lo = int(below[-1]) if below.numel() else 0
    i_hi = int(above[0]) if above.numel() else X_s.numel() - 1
    return float(X_s[i_lo]), float(X_s[i_hi])


def _tf_driver(tf, xi, P):
    """Minus the sample uncertainty of ``xi`` at log-temperature ``tf``, a
    host float (the objective fmin minimises)."""
    Pt = normalize(P / float(np.exp(np.asarray(tf, dtype=float)).reshape(-1)[0]))
    ws = torch.sum(Pt ** 2)
    return -float(w_sample_var(xi, Pt, ws))


def find_best_tf(xi, P, u0):
    """Max-uncertainty search over the likelihood temperature factor
    (reference: utils.py:172-183), scipy's fmin on the host.  Starts the
    simplex at the caller's ``u0`` exactly like the reference."""
    xi, P = _t(xi), _t(P)
    opt = fmin(_tf_driver, np.log(u0), args=(xi, P), full_output=True, disp=False)
    return float(np.exp(opt[0][0])), float(-opt[1])


def find_best_tf_bracketed(xi, P):
    """Robust max-uncertainty temperature: bracket on a log grid spanning
    the likelihood spread, then polish with the reference's fmin (the JAX
    package's posterior/stats.py says why the raw fmin stalls)."""
    xi, P = _t(xi), _t(P)
    spread = float(nanmax(P)) - nanmedian(P)
    if not np.isfinite(spread) or spread <= 0:
        return 1.0, 0.0
    taus = spread * np.logspace(-6.0, 1.0, 36)
    vals = [-_tf_driver(np.log(t), xi, P) for t in taus]
    t0 = taus[int(np.argmax(vals))]
    return find_best_tf(xi, P, t0)


def _edges(lo, hi, bin_count, device):
    k = torch.arange(bin_count + 1, dtype=torch.float64, device=device)
    return lo + (hi - lo) * k / bin_count


def _check_increasing(edges: torch.Tensor, what: str):
    """numpy's refusal of decreasing bin edges (NaN edges pass, as there)."""
    if bool((edges[:-1] > edges[1:]).any()):
        raise ValueError(f"`{what}` must increase monotonically, when an array")


def _degenerate_1d(P, X, edges):
    """np.histogram(X, weights=P, bins=edges, density=True) and the
    unweighted counts, on the device, for edges that are all equal (lo ==
    hi) or NaN: the ranges that do not go through ops/histogram.

    numpy's bin sums are differences of a cumulative sum of the weights
    sorted by X: with every edge at lo, each bin but the last gets a - a and
    the last (a + b) - a, where a sums the weights below lo and b those at
    lo (with NaN edges nothing is at or below).  Each is then divided by its
    zero (or NaN) width and by the total, so a bin comes out inf, -inf or
    NaN by the sign of its sum, and these are numpy's values whatever order
    the sums run in.  The one exception needs a != 0 (samples below a
    pinned range) and a b below a's last bit, where (a + b) - a may round
    to 0 on one side only."""
    _check_increasing(edges, "bins")
    zero = torch.zeros((), dtype=P.dtype, device=P.device)
    at, below = X == edges[-1], X < edges[0]
    a = torch.where(below, P, zero).sum()
    b = torch.where(at, P, zero).sum()
    n = torch.cat([(a - a).expand(edges.numel() - 2), ((a + b) - a).reshape(1)])
    counts = torch.zeros(edges.numel() - 1, dtype=torch.int64, device=X.device)
    counts[-1] = at.sum()
    return n / torch.diff(edges) / n.sum(), counts


def _np_bins(v, edges):
    """numpy histogramdd's bin of each value (searchsorted on the edges,
    the last edge into the last bin) and whether it lies inside."""
    idx = torch.searchsorted(edges, v, right=True) - (v == edges[-1]).to(torch.int64)
    return idx - 1, (idx >= 1) & (idx <= edges.numel() - 1)


def _degenerate_2d(P, X, Y, bx, by):
    """np.histogram2d(X, Y, bins=[bx, by], weights=P, density=True) on the
    device, for edges of which one axis's are all equal or NaN: numpy's
    binning, then its division of each cell by both widths and by the
    total.  A width is 0 or NaN on that axis, so each cell comes out inf,
    -inf or NaN by the sign of its sum, which does not depend on the order
    the sums run in for weights >= 0."""
    _check_increasing(bx, "bins[0]")
    _check_increasing(by, "bins[1]")
    ix, inx = _np_bins(X, bx)
    iy, iny = _np_bins(Y, by)
    keep = inx & iny
    nx, ny = bx.numel() - 1, by.numel() - 1
    flat = torch.where(keep, ix * ny + iy, torch.zeros_like(ix))
    h = torch.zeros(nx * ny, dtype=P.dtype, device=P.device)
    h.index_add_(0, flat, torch.where(keep, P, torch.zeros_like(P)))
    h = h.reshape(nx, ny)
    s = h.sum()
    h = h / torch.diff(bx).reshape(nx, 1)
    h = h / torch.diff(by).reshape(1, ny)
    return h / s


def marginalize_1d(P, bounds, bin_count, X, density_correct: bool = False):
    """Weighted 1-D histogram marginal (reference: utils.py:239-262):
    (density (bins,), edges (bins + 1,)) on the tensors' device.

    density_correct divides by the raw sampling histogram to undo a
    nonuniform sampling density (used for secondary/derived parameters).
    An increasing range bins through ops/histogram; an empty range (a
    pinned parameter: lo == hi) or a NaN bound follows numpy's histogram,
    which the JAX package runs there (see _degenerate_1d)."""
    P, X = _t(P), _t(X)
    lo, hi = float(bounds[0]), float(bounds[1])
    bins = _edges(lo, hi, bin_count, X.device)
    if hi > lo:
        w_sum, counts = histogram.hist1d_weighted(X, P, lo, hi, bin_count)
        width = (hi - lo) / bin_count
        total = w_sum.sum()
        marP = torch.where(total != 0, w_sum / (total * width), w_sum)
        marH = counts
    else:
        marP, marH = _degenerate_1d(P, X, bins)
    if density_correct:
        nz = marH != 0
        corr = torch.where(nz, marP / torch.where(nz, marH, 1), torch.zeros_like(marP))
        area = torch.sum(torch.diff(bins) * corr)
        marP = torch.where(area != 0, corr / area, corr)
    return marP, bins


def marginalize_2d(P, bounds_x, bounds_y, bin_count, X, Y):
    """Weighted 2-D histogram marginal (reference: utils.py:264-284):
    (density (bins, bins), Xg, Yg (bins + 1, bins + 1)) on the tensors'
    device; an increasing range on both axes bins through ops/histogram,
    an empty range or a NaN bound on either follows numpy's histogram2d
    (see _degenerate_2d)."""
    P, X, Y = _t(P), _t(X), _t(Y)
    lox, hix = float(bounds_x[0]), float(bounds_x[1])
    loy, hiy = float(bounds_y[0]), float(bounds_y[1])
    bx, by = _edges(lox, hix, bin_count, X.device), _edges(loy, hiy, bin_count, X.device)
    if hix > lox and hiy > loy:
        h = histogram.hist2d_weighted(X, Y, P, lox, hix, bin_count, loy, hiy, bin_count)
        total = h.sum()
        dx = (hix - lox) / bin_count
        dy = (hiy - loy) / bin_count
        h = torch.where(total != 0, h / (total * dx * dy), h)
    else:
        h = _degenerate_2d(P, X, Y, bx, by)
    Yg, Xg = torch.meshgrid(bx, by, indexing="xy")
    return h, Xg, Yg
