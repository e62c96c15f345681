"""Posterior plots: corner plots and covariance heatmaps.

The JAX package's posterior/plotting.py (matplotlib, Agg, in place of the
reference's Tk GUI plotting, Visualization/plotutils.py:14-192 and
marginalization_visual.py:500-636).  The marginals are computed on the
data's device by :func:`corner_marginals`, which needs no matplotlib; the
drawing functions move them to the host and import matplotlib inside, so
the module imports where matplotlib is absent.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .data import PosteriorData


def make_logticks(lo: float, hi: float):
    """Integer-decade tick positions covering [lo, hi] (reference:
    plotutils.py make_logticks)."""
    start = int(np.ceil(lo))
    stop = int(np.floor(hi))
    ticks = list(range(start, stop + 1))
    return ticks, [f"$10^{{{t}}}$" for t in ticks]


def corner_marginals(data: PosteriorData, params: List[str],
                     do_log: Optional[Dict[str, bool]] = None,
                     bounds: Optional[Dict[str, Tuple[float, float]]] = None,
                     bins: int = 64):
    """The corner plot's axes and marginals on the data's device: per
    parameter (values on its axis, (lo, hi)) -- log10 where do_log, the
    bounds given (log10 of them where do_log) or the values' range --, then
    {p: (density, edges)} for the diagonal and {(px, py): (density, Xg,
    Yg)} for each pair below it: k 1-D and k(k-1)/2 2-D histograms."""
    do_log, bounds = do_log or {}, bounds or {}
    tr = {}
    for p in params:
        v = torch.log10(data.X[p]) if do_log.get(p) else data.X[p]
        b = bounds.get(p)
        if b is None:
            b = (float(torch.min(v)), float(torch.max(v)))
        elif do_log.get(p):
            b = (np.log10(b[0]), np.log10(b[1]))
        tr[p] = (v, b)
    diag, pairs = {}, {}
    for i, py in enumerate(params):
        for j, px in enumerate(params[:i + 1]):
            if i == j:
                diag[px] = data.marginal_1d(px, bounds=tr[px][1], bins=bins,
                                            log=do_log.get(px, False))
            else:
                pairs[px, py] = data.marginal_2d(
                    px, py, bounds_x=tr[px][1], bounds_y=tr[py][1], bins=bins,
                    log_x=do_log.get(px, False), log_y=do_log.get(py, False))
    return tr, diag, pairs


def draw_corner(axes, data: PosteriorData, params: List[str],
                do_log: Optional[Dict[str, bool]] = None,
                bounds: Optional[Dict[str, Tuple[float, float]]] = None,
                marks: Optional[Dict[str, float]] = None,
                bins: int = 64, top_n_scatter: int = 0):
    """Fill a k x k axes grid with the corner plot (1-D marginals on the
    diagonal, 2-D marginals below).  Shared by the one-shot
    :func:`corner_plot` and the explorer's replot (explorer.py)."""
    do_log = do_log or {}
    marks = marks or {}
    k = len(params)
    tr, diag, pairs = corner_marginals(data, params, do_log, bounds, bins)

    def host(*ts):
        return [t.cpu().numpy() for t in ts]

    for i, py in enumerate(params):
        for j, px in enumerate(params):
            ax = axes[i][j]
            if i < j:
                ax.axis("off")
                continue
            vx, bx = tr[px]
            if i == j:
                h, edges = host(*diag[px])
                ax.bar(edges[:-1], h, width=np.diff(edges), align="edge",
                       color="#3b6ea5")
                if px in marks and marks[px] is not None:
                    mv = np.log10(marks[px]) if do_log.get(px) else marks[px]
                    ax.axvline(mv, color="crimson", lw=1)
                ax.set_yticks([])
            else:
                vy, by = tr[py]
                h, Xg, Yg = host(*pairs[px, py])
                ax.pcolormesh(Xg, Yg, h, cmap="viridis", shading="auto")
                if top_n_scatter:
                    idx = np.argsort(data.P.cpu().numpy())[-top_n_scatter:]
                    ax.scatter(vx.cpu().numpy()[idx], vy.cpu().numpy()[idx], s=2,
                               c="white", alpha=0.6)
                if px in marks and marks[px] is not None:
                    mv = np.log10(marks[px]) if do_log.get(px) else marks[px]
                    ax.axvline(mv, color="crimson", lw=0.8)
                if py in marks and marks[py] is not None:
                    mv = np.log10(marks[py]) if do_log.get(py) else marks[py]
                    ax.axhline(mv, color="crimson", lw=0.8)
            if do_log.get(px):
                ticks, labels = make_logticks(*bx)
                ax.set_xticks(ticks)
                ax.set_xticklabels(labels, fontsize=6)
            if i == k - 1:
                ax.set_xlabel(px, fontsize=8)
            if j == 0 and i != j:
                ax.set_ylabel(py, fontsize=8)


def corner_plot(data: PosteriorData, params: List[str],
                do_log: Optional[Dict[str, bool]] = None,
                bounds: Optional[Dict[str, Tuple[float, float]]] = None,
                marks: Optional[Dict[str, float]] = None,
                bins: int = 64, top_n_scatter: int = 0, out_file=None):
    """Corner plot: 1-D marginals on the diagonal, 2-D marginals below.
    Returns the matplotlib Figure (Agg)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    k = len(params)
    fig, axes = plt.subplots(k, k, figsize=(2.2 * k, 2.2 * k), squeeze=False,
                             dpi=120)
    draw_corner(axes, data, params, do_log=do_log, bounds=bounds,
                marks=marks, bins=bins, top_n_scatter=top_n_scatter)
    fig.tight_layout()
    if out_file:
        fig.savefig(out_file)
    return fig


def covariance_heatmap(data: PosteriorData, params: List[str], out_file=None):
    """Covariance heatmap (reference: marginalization_visual.py:613-636)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cov = data.covariance(params).cpu().numpy()
    fig, ax = plt.subplots(figsize=(1.0 + 0.6 * len(params),) * 2, dpi=120)
    im = ax.imshow(cov, cmap="coolwarm")
    ax.set_xticks(range(len(params)))
    ax.set_xticklabels(params, rotation=90, fontsize=7)
    ax.set_yticks(range(len(params)))
    ax.set_yticklabels(params, fontsize=7)
    for i in range(len(params)):
        for j in range(len(params)):
            ax.text(j, i, f"{cov[i, j]:.2g}", ha="center", va="center", fontsize=5)
    fig.colorbar(im, ax=ax, shrink=0.8)
    fig.tight_layout()
    if out_file:
        fig.savefig(out_file)
    return fig
